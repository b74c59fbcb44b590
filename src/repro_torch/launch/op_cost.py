"""Per-device cost of one traced step: FLOPs, bytes and collectives.

The counterpart of ``repro.launch.hlo_cost``, which reads XLA's
post-SPMD HLO text.  Here a :class:`OpCost` dispatch mode sees every
operation one rank runs while a step function is called on fake tensors
(the dry-run) or real ones, and keeps the reference's result fields
(:class:`HloCost`, ``hlo_cost.py:85``):

* **flops** — each operation's count from ``torch.utils.flop_counter``'s
  formulas (2·M·N·K for a product; the hand-written kernels' custom ops
  by their own formulas, ``repro_torch.kernels._cost``), taken as
  ``FlopCounterMode`` takes them (an operation without a formula is
  decomposed first), so a real step under ``FlopCounterMode`` counts the
  same.  Under DTensor the mode steps aside for the DTensor level and
  counts the local operations each rank runs on its block (a
  ``FlopCounterMode`` around DTensor code counts the global shapes).  A
  remat recompute is counted, as XLA's HLO holds it.
* **bytes** — the operands read and the outputs written by every
  operation that moves data: views, allocations and metadata move
  nothing; a gather (an embedding lookup) moves the rows it takes, a
  scatter into a tensor (a cache row written in place) the rows it
  writes; a broadcast operand counts its distinct elements; a kernel's
  custom op counts its byte formula.  This is the eager program's
  traffic, each operation to and from device memory.  XLA's count
  (``hlo_cost.py:14-17``) is taken after fusion, where a fused chain of
  elementwise operations moves its inputs and outputs once; the eager
  count is larger by the intermediates such a chain would have kept on
  chip, and smaller where the card's 50 MB L2 serves a read.
* **collectives** — each ``_c10d_functional`` operation DTensor's
  redistribution issues, and each ``torch.distributed`` call the model
  makes itself (flash-decode's combine, the expert all-to-all), by kind,
  with its group's size and link from the group it names, through the
  ring model of ``launch/roofline.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import sys

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels._cost import BYTES
from .roofline import CollectiveStats, link_bw

__all__ = ["HloCost", "OpCost", "RankMemTracker", "in_sharding_propagation"]

aten = torch.ops.aten

#: operations that read or write no element data
_NO_TRAFFIC = {
    aten.detach, aten.alias, aten.lift_fresh, aten.empty, aten.empty_like,
    aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten._local_scalar_dense, aten.set_, aten.resize_,
}
#: operations that write their output without reading it
_WRITE_ONLY = {aten.fill_, aten.zero_, aten.zeros, aten.ones, aten.full,
               aten.zeros_like, aten.ones_like, aten.full_like, aten.arange,
               aten.new_zeros, aten.new_ones, aten.new_full}
#: gathers: the output's rows are read from the table, plus the index
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather}
#: scatters into their first operand: the rows written, plus the index
_SCATTERS = {aten.index_copy_, aten.index_put_, aten.index_add_,
             aten.scatter_, aten.scatter_add_, aten.index_fill_}
#: the metadata queries ``FlopCounterMode`` leaves alone
_META = {aten.is_contiguous, aten.is_strides_like_format,
         aten.is_non_overlapping_and_dense, aten.size, aten.sym_size,
         aten.stride, aten.sym_stride, aten.storage_offset,
         aten.sym_storage_offset, aten.numel, aten.sym_numel, aten.dim,
         torch.ops.prim.layout, torch.ops.prim.device}

#: the collectives by operation: (kind, whether the ring model reads the
#: output's bytes rather than the input's)
_COLL = {
    "all_gather_into_tensor": ("all-gather", True),
    "reduce_scatter_tensor": ("reduce-scatter", False),
    "all_reduce": ("all-reduce", False),
    "all_to_all_single": ("all-to-all", False),
    "allreduce_": ("all-reduce", False),
    "allgather_": ("all-gather", True),
    "_allgather_base_": ("all-gather", True),
    "allgather_into_tensor_coalesced_": ("all-gather", True),
    "reduce_scatter_": ("reduce-scatter", False),
    "_reduce_scatter_base_": ("reduce-scatter", False),
    "alltoall_base_": ("all-to-all", False),
    "alltoall_": ("all-to-all", False),
    "broadcast_": ("collective-permute", False),
    "send": ("collective-permute", False),
}


@dataclass
class HloCost:
    """The reference's result fields (``repro.launch.hlo_cost.HloCost``),
    per device; ``coll_s`` is the collective term over each group's
    link."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_ring_bytes: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    coll_raw_bytes: dict = field(default_factory=dict)
    coll_s: float = 0.0
    flops_by_op: dict = field(default_factory=dict)   # op name → flops


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """The distinct elements of ``t`` (a broadcast dim of stride 0 counts
    once), in bytes."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _group(args) -> tuple[int, float]:
    """(size, link bandwidth) of the process group a collective names: a
    group name (``_c10d_functional``) or a ``ProcessGroup`` (``c10d``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    pg = None
    for a in reversed(args):
        if isinstance(a, str):
            pg = _resolve_process_group(a)
        elif isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:        # the reduce op's object
                continue
        if pg is not None:
            break
    else:
        raise ValueError("a collective without a process group")
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), link_bw(ranks)


def in_sharding_propagation(depth: int = 16) -> bool:
    """Whether the operation being dispatched is one DTensor's sharding
    propagation runs on global-shaped fake tensors to learn an output's
    metadata (``_sharding_prop.py``, ``_propagate_tensor_meta*``): it
    reuses the caller's fake mode, so only the call stack tells it from
    the rank's own operations."""
    frame = sys._getframe(1)
    for _ in range(depth):
        if frame is None:
            return False
        code = frame.f_code
        if code.co_name.startswith("_propagate_tensor_meta") \
                and code.co_filename.endswith("_sharding_prop.py"):
            return True
        frame = frame.f_back
    return False


class RankMemTracker(MemTracker):
    """``torch.distributed._tools.mem_tracker.MemTracker`` that leaves
    DTensor's sharding propagation out: its global-shaped outputs live
    for one call and belong to no rank."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if in_sharding_propagation():
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class OpCost(TorchDispatchMode):
    """Counts, into ``self.cost`` (:class:`HloCost`), what each operation
    this rank runs reads, writes and computes, and the collectives it
    issues.  Enter it inside the fake mode of a trace (or around a real
    step)."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = HloCost()
        self._stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented       # count the local operations
        packet = func._overloadpacket
        if packet in _META:
            return NotImplemented
        if packet is not torch.ops.prim.device:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if packet is torch.ops._c10d_functional.wait_tensor:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not in_sharding_propagation():
            self._count(func, packet, args, kwargs, out)
        return out

    def _count(self, func, packet, args, kwargs, out) -> None:
        cost = self.cost
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            cost.flops += flops
            name = str(packet)
            cost.flops_by_op[name] = cost.flops_by_op.get(name, 0) + flops
        if func.namespace in ("_c10d_functional", "c10d"):
            kind, by_out = _COLL.get(packet.__name__, (None, False))
            if kind is not None:
                n, bw = _group(args)
                side = _tensors(out) if by_out else _tensors(args)
                nbytes = sum(_nbytes(t) for t in side)
                self._stats.add(kind, nbytes, n, bw)
                cost.coll_counts = dict(self._stats.counts)
                cost.coll_raw_bytes = dict(self._stats.raw_bytes)
                cost.coll_ring_bytes = self._stats.ring_bytes
                cost.coll_s = self._stats.ring_s
            return
        if packet in BYTES:
            cost.bytes += BYTES[packet](*args, **kwargs)
            return
        if func.is_view or packet in _NO_TRAFFIC:
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if packet in _WRITE_ONLY:
            cost.bytes += sum(_nbytes(t) for t in outs)
        elif packet in _GATHERS:
            index = sum(_nbytes(t) for t in ins[1:] if not
                        t.is_floating_point())
            cost.bytes += 2 * sum(_nbytes(t) for t in outs) + index
        elif packet in _SCATTERS:
            cost.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
        else:
            cost.bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
