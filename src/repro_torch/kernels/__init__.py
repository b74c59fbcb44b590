"""Hand-written CUDA kernels for NVIDIA Hopper: one per TPU kernel of the
serving path, the backwards of flash attention and the RG-LRU scan that
training needs (the reference differentiates those in plain JAX), and
AdamW's update of a leaf in one pass (the reference's is an XLA fusion).

Each subpackage's ``ops.py`` holds the wrapper, the plain PyTorch
version of the same function (taken for a CPU tensor, and the yardstick
a kernel is held against on the card), the launch function that runs
the kernel from ``csrc/`` on a CUDA tensor (counts the launch, raises on
what the kernel does not take) and the kernel's custom op
(``torch.ops.repro_torch.*``), which a traced call goes through
(``_dtensor.route``): its CUDA implementation is the launch, its fake
implementation gives the outputs' shapes for a fake tensor
(``launch/dryrun.py``), its cost formula (``*_cost``, registered by
``_cost``) counts the call's FLOPs and bytes, and its sharding rule
(``_dtensor``) runs it per rank on DTensors.  ``adamw`` has no sharding
rule: its wrapper hands the op each rank's block (the update is
elementwise), and a counted call on CPU tensors takes the op as well.
``_build`` compiles the sources with ``nvcc`` for ``sm_90a`` at first
use.

A wrapper counts a launch when its Python code runs, which a CUDA
graph's replay does not do (the flash wrappers count their f32 route's
launches apart as well, as ``flash_attention_f32`` and
``flash_attention_bwd_f32``): :class:`GraphLaunches` takes back what a
capture counted (a capture launches nothing) and adds it again at every
replay.  Every capture of the port runs inside its ``capture()``, which
also keeps Python's cyclic garbage collector out of the capture.
"""
import contextlib
import gc

from .flash_attention.ops import (flash_attention, flash_attention_bwd,
                                  flash_attention_bwd_plain,
                                  flash_attention_plain)
from .decode_attention.ops import decode_attention, decode_attention_plain
from .rglru_scan.ops import (rglru_scan, rglru_scan_bwd, rglru_scan_bwd_plain,
                             rglru_scan_plain)
from .moe_gating.ops import moe_gating, moe_gating_plain
from .adamw.ops import adamw, adamw_plain

__all__ = ["COUNTED", "F32_ROUTES", "GraphLaunches", "launch_counts",
           "flash_attention",
           "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "decode_attention",
           "decode_attention_plain", "rglru_scan", "rglru_scan_plain",
           "rglru_scan_bwd", "rglru_scan_bwd_plain", "moe_gating",
           "moe_gating_plain", "adamw", "adamw_plain"]

#: the wrappers that count their kernels' launches (``<wrapper>.launches``)
COUNTED = ("flash_attention", "decode_attention", "rglru_scan", "moe_gating",
           "flash_attention_bwd", "rglru_scan_bwd", "adamw")
#: the flash kernels' f32 routes, counted apart as well
#: (``<wrapper>.f32_launches``, under the wrapper's name and ``_f32``)
F32_ROUTES = ("flash_attention_f32", "flash_attention_bwd_f32")


def _counter(name: str) -> tuple[object, str]:
    """The wrapper and the attribute that count ``name``'s launches."""
    if name in F32_ROUTES:
        return globals()[name.removesuffix("_f32")], "f32_launches"
    return globals()[name], "launches"


def launch_counts(names=COUNTED) -> dict[str, int]:
    """Each named wrapper's (or f32 route's) launch counter."""
    return {name: getattr(*_counter(name)) for name in names}


class GraphLaunches:
    """The kernel launches a captured CUDA graph holds, by wrapper.

    ``with counts.capture(): <capture>`` records what the wrappers counted
    while the graph was captured into ``per_replay`` (and what the f32
    routes of the watched flash wrappers counted into
    ``f32_per_replay``) and takes it back from the counters;
    ``counts.replay(graph)`` replays the graph and adds both to them.

    ``capture()`` also turns the cyclic garbage collector off for its
    span.  ``torch.cuda.graph`` no longer collects before a capture, so a
    dead reference cycle holding an earlier graph (an engine and its
    executor's closures) could be collected by an automatic collection
    inside the capture; the graph's ``reset`` then runs in the capture,
    which CUDA refuses, and the capture is invalidated (cuBLAS or a
    kernel launch reports it later in the capture)."""

    def __init__(self, names=COUNTED):
        self.names = tuple(names)
        self.routes = tuple(r for r in F32_ROUTES
                            if r.removesuffix("_f32") in self.names)
        self.per_replay = dict.fromkeys(self.names, 0)
        self.f32_per_replay = dict.fromkeys(self.routes, 0)

    @contextlib.contextmanager
    def capture(self):
        watched = self.names + self.routes
        before = launch_counts(watched)
        collecting = gc.isenabled()
        gc.disable()
        try:
            yield self
        finally:
            if collecting:
                gc.enable()
            after = launch_counts(watched)
            held = {n: after[n] - before[n] for n in watched}
            self.per_replay = {n: held[n] for n in self.names}
            self.f32_per_replay = {n: held[n] for n in self.routes}
            self._add(-1)

    def replay(self, graph) -> None:
        graph.replay()
        self._add(1)

    def _add(self, sign: int) -> None:
        for name, n in (self.per_replay | self.f32_per_replay).items():
            wrapper, attr = _counter(name)
            setattr(wrapper, attr, getattr(wrapper, attr) + sign * n)
