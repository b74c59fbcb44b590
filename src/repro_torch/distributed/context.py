"""Activation-sharding context.

Model code calls :func:`constrain` at key boundaries (residual stream,
attention heads, FFN hidden, MoE dispatch buffers).  Outside a
distributed launch the calls are no-ops, so runs on one device take the
identical code path; the launchers enter :func:`use_sharding_rules` to
activate the constraints for the current mesh.  The port of
``repro.distributed.context``: the rules and the dispatch conditions are
the reference's line for line; a constraint acts on a ``DTensor`` only
(it redistributes it to the named placements, as the reference's
``with_sharding_constraint`` reshards a global array), and a plain
tensor — one rank's whole value — passes through unchanged.

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` or any object
with the reference's ``axis_names`` and ``devices.shape`` (a shape-only
stand-in: the dispatch conditions read sizes only).
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading

import torch

from .sharding import P, axis_sizes, placements

_state = threading.local()


def _active() -> dict | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_sharding_rules(*, batch_axes=("pod", "data"), model_axis="model",
                       mesh=None, seq_shard: bool = True,
                       decode_tp: bool = False):
    """Enable the activation constraints inside model code.

    ``seq_shard``: shard the sequence dim of the residual stream over the
    model axis between blocks (Megatron-SP); projections then gather seq
    and emit head-/ffn-sharded tensors, enforced by the ``heads`` /
    ``ffn_hidden`` constraints below.
    """
    sizes = axis_sizes(mesh) if mesh is not None else {}
    names = set(sizes) if mesh is not None else None
    baxes = tuple(a for a in batch_axes if names is None or a in names)
    prev = _active()
    _state.rules = {
        "batch": baxes if len(baxes) != 1 else baxes[0],
        "model": model_axis if (names is None or model_axis in names) else None,
        "seq_shard": seq_shard,
        "sizes": sizes,
        "mesh": mesh,
        "decode_tp": decode_tp,
    }
    try:
        yield
    finally:
        _state.rules = prev


def carry_rules(fn):
    """``fn`` to be run under the rules in force where this is called (and
    DTensor's implicit replication, if it is on here), in whichever thread
    runs it.  Both are per thread, and a block that checkpointing
    recomputes in the backward runs on the autograd engine's thread for
    its device (CUDA's), which has neither."""
    rules, manual = _active(), getattr(_state, "manual", False)
    implicit = _implicit_replication()

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prev = _active(), getattr(_state, "manual", False)
        _state.rules, _state.manual = rules, manual
        try:
            if implicit and not _implicit_replication():
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                with implicit_replication():
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        finally:
            _state.rules, _state.manual = prev
    return run


def _implicit_replication() -> bool:
    """Whether DTensor treats plain tensors as replicated in this thread
    (False where ``torch.distributed.tensor`` is not imported)."""
    tensor = sys.modules.get("torch.distributed.tensor")
    return bool(tensor is not None
                and tensor.DTensor._op_dispatcher._allow_implicit_replication)


@contextlib.contextmanager
def manual_mode():
    """Suspend activation constraints inside a per-rank body (the
    reference's shard_map body: manual axes take no constraint)."""
    prev = getattr(_state, "manual", False)
    _state.manual = True
    try:
        yield
    finally:
        _state.manual = prev


def _fits(rules, dim_size: int, entry) -> bool:
    """Divisibility guard for activation constraints."""
    if entry is None:
        return True
    sizes = rules.get("sizes", {})
    names = entry if isinstance(entry, tuple) else (entry,)
    total = 1
    for n in names:
        total *= sizes.get(n, 1)
    return total > 0 and dim_size % total == 0 and dim_size >= total


def _all_axes(rules) -> tuple:
    b = rules["batch"]
    names = list(b) if isinstance(b, tuple) else [b] if b else []
    if rules["model"]:
        names.append(rules["model"])
    return tuple(names)


def moe_shard_info(n_tokens: int):
    """(mesh, batch_axes, model_axis) for the expert-parallel MoE path, or
    None when not applicable (no mesh context / one device / token count
    not divisible by the device count)."""
    rules = _active()
    if rules is None or rules.get("mesh") is None or rules["model"] is None:
        return None
    sizes = rules.get("sizes", {})
    total = 1
    for n in _all_axes(rules):
        total *= sizes.get(n, 1)
    if total <= 1 or n_tokens % total != 0:
        return None
    b = rules["batch"]
    baxes = tuple(b) if isinstance(b, tuple) else ((b,) if b else ())
    return rules["mesh"], baxes, rules["model"]


def decode_shard_info(batch: int, s_cache: int):
    """(mesh, batch_axes, model_axis) for flash-decode over a
    sequence-sharded KV cache, or None when not applicable (no mesh
    context, a model axis of 1, a cache not divisible by it).

    ``REPRO_NO_FLASH_DECODE=1`` disables the path (the reference's A/B
    switch)."""
    rules = _active()
    if rules is None or getattr(_state, "manual", False) \
            or rules.get("mesh") is None or rules["model"] is None \
            or os.environ.get("REPRO_NO_FLASH_DECODE"):
        return None
    sizes = rules.get("sizes", {})
    M = sizes.get(rules["model"], 1)
    if M <= 1 or s_cache % M != 0:
        return None
    b = rules["batch"]
    baxes = tuple(b) if isinstance(b, tuple) else ((b,) if b else ())
    btotal = 1
    for n in baxes:
        btotal *= sizes.get(n, 1)
    if baxes and batch % btotal != 0:
        baxes = ()
    return rules["mesh"], baxes, rules["model"]


def dispatch_groups(n_tokens: int) -> int:
    """MoE dispatch group count: one group per device when it divides the
    token count; outside a distributed launch: 1."""
    rules = _active()
    if rules is None:
        return 1
    sizes = rules.get("sizes", {})
    total = 1
    for n in _all_axes(rules):
        total *= sizes.get(n, 1)
    return total if total and n_tokens % total == 0 else 1


def decode_tp_active() -> bool:
    """Weight-stationary 2D-TP decode: activations cycle between
    feature-sharded layouts so 2D-sharded weights never move."""
    rules = _active()
    return bool(rules and rules.get("decode_tp")
                and not getattr(_state, "manual", False))


def constraint_spec(x_shape: tuple, kind: str) -> P | None:
    """The spec :func:`constrain` gives a value of ``x_shape`` under the
    active rules, or None where it leaves the value as it is (no rules,
    manual mode, or a kind that does not constrain this shape).

    kinds: ``residual`` (B,S,d) · ``heads`` (B,S,H,hd) · ``ffn_hidden``
    (B,S,f) · ``moe_buffers`` (E,C,d) · ``moe_groups`` (G,E,C,d) ·
    ``group_tokens`` (G,…) · ``logits`` (B,S,V) · ``dtp_features``
    (B,S,d: d→data, B replicated) · ``dtp_hidden`` (B,S,f: f→model, B
    replicated) · ``batch_only`` (B,…: B→batch) · ``replicated`` ·
    ``scan_xs_batch`` (n,B,…) · ``flash_blocks`` (B,n,blk,K,G,D)."""
    rules = _active()
    if rules is None or getattr(_state, "manual", False):
        return None
    ndim = len(x_shape)
    b, m = rules["batch"], rules["model"]
    if kind != "moe_buffers" and b is not None \
            and not _fits(rules, x_shape[0], b):
        b = None
    if kind == "residual":
        seq = m if (rules["seq_shard"] and ndim >= 2
                    and _fits(rules, x_shape[1], m)) else None
        return P(b, seq, None)
    if kind == "heads":
        if not _fits(rules, x_shape[2], m):
            return P(b, *([None] * (ndim - 1)))
        return P(b, None, m, None)
    if kind == "ffn_hidden":
        if not _fits(rules, x_shape[-1], m):
            return None
        return P(b, *([None] * (ndim - 2)), m)
    if kind == "moe_buffers":
        e_ok = _fits(rules, x_shape[0], m)
        d_ok = _fits(rules, x_shape[2], b)
        return P(m if e_ok else None, None, b if d_ok else None)
    if kind == "moe_groups":
        g_ok = _fits(rules, x_shape[0], b)
        e_ok = _fits(rules, x_shape[1], m)
        return P(b if g_ok else None, m if e_ok else None, None, None)
    if kind == "group_tokens":
        axes = _all_axes(rules)
        g_ok = axes and _fits(rules, x_shape[0], axes)
        return P(axes if g_ok else None, *([None] * (ndim - 1)))
    if kind == "logits":
        if not _fits(rules, x_shape[-1], m):
            return None
        return P(b, None, m)
    if kind == "dtp_features":
        d_axis = "data" if rules.get("sizes", {}).get("data") else None
        if d_axis is None or not _fits(rules, x_shape[-1], d_axis):
            return None
        return P(*([None] * (ndim - 1)), d_axis)
    if kind == "dtp_hidden":
        if not _fits(rules, x_shape[-1], m):
            return None
        return P(*([None] * (ndim - 1)), m)
    if kind == "batch_only":
        return P(b, *([None] * (ndim - 1)))
    if kind == "replicated":
        return P(*([None] * ndim))
    if kind == "scan_xs_batch":
        if ndim < 2 or not _fits(rules, x_shape[1], b):
            return None
        return P(None, b, *([None] * (ndim - 2)))
    if kind == "flash_blocks":
        spec = [None] * ndim
        if _fits(rules, x_shape[0], b):
            spec[0] = b
        if ndim >= 4 and _fits(rules, x_shape[3], m):
            spec[3] = m
        return P(*spec)
    return None


def split_heads(x, H: int, hd: int):
    """``x`` (..., H·hd) as (..., H, hd).  A DTensor sharded along its
    last dim over a mesh dim whose ranks do not divide H is gathered on
    that mesh dim first: DTensor cannot cut a shard inside a head, where
    XLA reshards on its own.  A plain reshape on a plain tensor."""
    from ..core.streams import is_dtensor
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        places = list(x.placements)
        uneven = [m for m, p in enumerate(places)
                  if p.is_shard(last) and H % x.device_mesh.size(m)]
        if uneven:
            for m in uneven:
                places[m] = Replicate()
            x = x.redistribute(x.device_mesh, places)
    return x.reshape(*x.shape[:-1], H, hd)


def write_row(cache, row, value) -> None:
    """``cache[:, row] = value`` in place: ``cache`` (B, S, ...), ``row``
    a one-element int64 tensor on its device, ``value`` (B, 1, ...).  A
    DTensor cache sharded along its rows (a long cache's rows over the
    model axis) is written by the rank that holds the row, at its local
    index, as flash-decode writes: DTensor cannot index into a sharded
    dim in place.  Elsewhere ``index_copy_``, which also takes a chunk's
    S rows (``row`` (S,), ``value`` (B, S, ...): a ladder prefill's chunk
    on a plain cache)."""
    from ..core.streams import is_dtensor
    if not is_dtensor(cache):
        cache.index_copy_(1, row, value.to(cache.dtype))
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh = cache.device_mesh
    places = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    if not is_dtensor(value):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    val = value.to(cache.dtype).redistribute(mesh, places).to_local()
    local = cache.to_local()
    n, offset = local.shape[1], 0
    for m, p in enumerate(cache.placements):   # mesh dims in shard order
        if p.is_shard(1):
            offset = offset * mesh.size(m) + mesh.get_local_rank(m)
    slot = row - offset * n
    in_range = (slot >= 0) & (slot < n)
    slot = slot.clamp(0, n - 1)
    local.index_copy_(1, slot, torch.where(in_range, val,
                                           local.index_select(1, slot)))


def merge_heads(x):
    """``x`` (..., H, hd) as (..., H·hd).  A DTensor has any shards of
    its hd dim gathered, then goes through :class:`_MergeHeads`, whose
    backward splits the gradient with :func:`split_heads` (the reverse
    view of a gradient sharded along H·hd over ranks that do not divide
    H would cut a shard inside a head).  A plain reshape on a plain
    tensor."""
    from ..core.streams import is_dtensor
    if is_dtensor(x):
        last = x.ndim - 1      # a shard inside each head: gathered first
        places = list(x.placements)
        if any(p.is_shard(last) for p in places):
            from torch.distributed.tensor import Replicate
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard(last) else p for p in places])
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.heads = tuple(x.shape[-2:])
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        return split_heads(grad, *ctx.heads)


def constrain(x, kind: str):
    """Apply a named constraint if a rule context is active: a ``DTensor``
    is redistributed over the rules' mesh to the placements of
    :func:`constraint_spec`; a plain tensor, or any value outside rules,
    is returned as it is."""
    rules = _active()
    if rules is None or getattr(_state, "manual", False):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = constraint_spec(tuple(x.shape), kind)
    if spec is None:
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(mesh, spec, x.ndim))
