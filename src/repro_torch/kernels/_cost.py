"""The work of a kernel call, as a cost model reads it.

Each kernel module gives its custom op a counting function: the op's
arguments (tensors, or fake tensors of the same shapes and dtypes) in,
``(flops, bytes)`` out, from shapes alone.  :func:`register_cost` hands
the FLOPs to ``torch.utils.flop_counter`` (so ``FlopCounterMode`` counts
a kernel by its formula, on the card and on fake tensors alike) and keeps
the bytes in :data:`BYTES` for ``repro_torch.launch.op_cost``.  The same
counting functions give ``chip_smoke.py``'s bound for each kernel.
"""
from __future__ import annotations

from typing import Callable

from torch.utils.flop_counter import register_flop_formula

__all__ = ["BYTES", "register_cost"]

#: op overload packet → bytes of a call, from the op's arguments
BYTES: dict = {}


def register_cost(op, counts: Callable) -> None:
    """``counts(*args, **kwargs) -> (flops, bytes)`` of a call of the
    custom op ``op`` (an ``OpOverloadPacket``)."""
    register_flop_formula(op, get_raw=True)(
        lambda *args, out_val=None, **kwargs: counts(*args, **kwargs)[0])
    BYTES[op] = lambda *args, **kwargs: counts(*args, **kwargs)[1]
