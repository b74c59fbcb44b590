"""Fused MoE gating: the CUDA kernel's wrappers and their plain PyTorch
versions.

``moe_gating`` computes :func:`moe_gating_plain` for a CPU tensor and
launches ``csrc/moe_gating.cu`` for a CUDA tensor; a call something
traces goes through the custom op ``repro_torch::moe_gating`` (the same
launch, the outputs' shapes for a fake tensor, counted by
:func:`moe_gating_cost`).  Its capacity slots are handed out first come,
first served across all the tokens of the call, so no dim is
independent: its sharding rule takes the logits whole (a token-sharded
call is gathered first, never run one shard as the whole).

``moe_gating_dropless`` (:func:`moe_gating_dropless_plain`, the op
``repro_torch::moe_gating_dropless``) is the same kernel's dropless mode:
every entry's row in expert-sorted order and each expert's end row, for
a grouped product over the experts a device holds.  Both take the
published DeepSeek-V2 routing options: groups of experts of which a
token may use the best few, and gates scaled instead of renormalised.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import function
from .._cost import register_cost
from .._dtensor import local_operands, route, sharding_rule

__all__ = ["gating_launch_shape", "max_cluster_blocks", "moe_gating",
           "moe_gating_cost", "moe_gating_dropless",
           "moe_gating_dropless_plain", "moe_gating_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: logits, eids, gates, slots, keep, ends; T, E, k, C, n_groups,
#: topk_groups, renorm; scale; held, nb, threads; the stream
_ARGTYPES = [_P] * 6 + [_I] * 7 + [ctypes.c_float] + [_I] * 3 + [_P]
#: what the kernel takes: experts (one warp's 8 registers per lane) and k
MAX_EXPERTS, MAX_TOP_K = 256, 8
#: the most groups of experts (a lane holds a group's score)
MAX_GROUPS = 32
#: warps per block
MAX_WARPS = 32


def gating_launch_shape(T: int, max_blocks: int) -> tuple[int, int]:
    """(blocks of the cluster, threads per block) for ``T`` tokens, on a
    card that places clusters of up to ``max_blocks`` blocks.

    Up to 32 tokens: one block with a warp per token and no cluster.
    Beyond: a block per 32 tokens, at most ``max_blocks``; each block owns
    an even, contiguous share of the tokens and has a warp per token of
    it, at most 32 (past max_blocks·32 tokens a warp routes several)."""
    if T <= MAX_WARPS:
        return 1, 32 * T
    nb = min(max_blocks, -(-T // MAX_WARPS))
    return nb, 32 * min(MAX_WARPS, -(-T // nb))


@functools.lru_cache(maxsize=None)
def max_cluster_blocks() -> int:
    """The most blocks the kernel's cluster may have on the current card:
    16 where it can place a non-portable cluster of 16, else 8."""
    return function("moe_gating", "moe_gating_max_blocks", [])()


def _route_plain(logits, top_k: int, n_groups: int, topk_groups: int,
                 renormalize: bool, scale: float):
    """(eids (T, k) int64, gates (T, k) f32) of the routing: the softmax;
    with ``n_groups`` > 1 each group's score the largest prob of its
    E / n_groups experts (in index order) and the ``topk_groups`` best
    groups kept, the lower first on ties; the top k of the kept experts'
    probs by a stable descending sort, the lower expert first on ties
    (``lax.top_k``'s order, which ``torch.topk`` does not promise); the
    gates renormalised, or the probs times ``scale``."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    kept = probs
    if n_groups > 1:
        gs = E // n_groups
        scores = probs.reshape(T, n_groups, gs).amax(-1)
        order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
        groups = torch.zeros_like(scores, dtype=torch.bool).scatter_(
            1, order[:, :topk_groups], True)
        kept = torch.where(groups.repeat_interleave(gs, dim=1), probs, -1.0)
    top, order = torch.sort(kept, dim=-1, descending=True, stable=True)
    gates, eids = top[:, :top_k], order[:, :top_k]
    if renormalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        gates = gates * scale
    return eids, gates


def _ranks(flat, E: int):
    """Each entry's position among the earlier entries of its expert, in
    flattened (token, k) order, and each expert's entries."""
    # one-hot by comparison: F.one_hot reads a CPU tensor's indices back
    # to check them (a host sync inside the train step)
    hot = (flat[:, None] == torch.arange(E, device=flat.device)).long()
    return (hot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0], hot.sum(0)


def moe_gating_plain(logits: torch.Tensor, *, top_k: int, capacity: int,
                     n_groups: int = 1, topk_groups: int = 1,
                     renormalize: bool = True, scale: float = 1.0):
    """Router softmax → top-k → first-come-first-served capacity slots.

    The routing is :func:`_route_plain`'s (by default: softmax, top k,
    renormalised gates).  Positions count the earlier entries of the
    same expert in flattened (token, k) order.

    logits: (T, E).  Returns (eids (T, k) int32, gates (T, k) f32, slots
    (T, k) int32 = expert·C + position, keep (T, k) bool = position < C);
    a dropped entry's slot is expert·C."""
    T, E = logits.shape
    eids, gates = _route_plain(logits, top_k, n_groups, topk_groups,
                               renormalize, scale)
    flat = eids.reshape(-1)
    rank, _ = _ranks(flat, E)
    keep = rank < capacity
    slots = flat * capacity + torch.where(keep, rank, 0)
    return (eids.to(torch.int32), gates,
            slots.reshape(T, top_k).to(torch.int32), keep.reshape(T, top_k))


def moe_gating_dropless_plain(logits: torch.Tensor, *, top_k: int, held: int,
                              n_groups: int = 1, topk_groups: int = 1,
                              renormalize: bool = True, scale: float = 1.0):
    """The routing of :func:`moe_gating_plain`, every entry kept: its row
    in expert-sorted order (experts ascending, flattened (token, k) order
    within one).

    logits: (T, E).  Returns (eids (T, k) int32, gates (T, k) f32, rows
    (T, k) int32, keep (T, k) bool = expert < ``held`` (the experts this
    device holds, 0..held-1, whose rows come first), ends (E,) int32 =
    the end of each expert's rows)."""
    T, E = logits.shape
    eids, gates = _route_plain(logits, top_k, n_groups, topk_groups,
                               renormalize, scale)
    flat = eids.reshape(-1)
    rank, counts = _ranks(flat, E)
    ends = counts.cumsum(0)
    rows = (ends - counts).gather(0, flat) + rank
    return (eids.to(torch.int32), gates,
            rows.reshape(T, top_k).to(torch.int32),
            (eids < held).reshape(T, top_k), ends.to(torch.int32))


def moe_gating_cost(logits, top_k: int, capacity: int = 0,
                    n_groups: int = 1, topk_groups: int = 1,
                    renormalize: bool = True, scale: float = 1.0, *,
                    dropless: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of a call: per token and expert the softmax's 4
    operations (max, exp, sum, scale) and one comparison per top-k pick,
    with groups (``n_groups`` > 1) one more per expert (its group's max)
    and one per group and kept group; the logits read once and the four
    (T, k) outputs (eids, gates, slots int32/f32, keep bool) written once,
    and in the ``dropless`` mode the (E,) int32 ends."""
    T, E = logits.shape
    flops = T * E * (4 + top_k)
    if n_groups > 1:
        flops += T * (E + n_groups * topk_groups)
    nbytes = logits.element_size() * T * E + T * top_k * (4 + 4 + 4 + 1)
    return flops, nbytes + (4 * E if dropless else 0)


def _dropless_cost(logits, top_k: int, held: int, n_groups: int = 1,
                   topk_groups: int = 1, renormalize: bool = True,
                   scale: float = 1.0) -> tuple[int, int]:
    return moe_gating_cost(logits, top_k, 0, n_groups, topk_groups,
                           dropless=True)


def _checked(logits, top_k: int, n_groups: int, topk_groups: int):
    """The logits as the wrappers take them (``local_operands``), after
    checking the routing's arguments."""
    (logits,) = local_operands("moe_gating", logits)
    if logits.dim() != 2:
        raise ValueError(f"moe_gating: logits {tuple(logits.shape)} are not "
                         f"(tokens, experts)")
    T, E = logits.shape
    if not 1 <= top_k <= E or T < 1:
        raise ValueError(f"moe_gating: top_k {top_k} of {E} experts, {T} "
                         f"tokens")
    if (not 1 <= topk_groups <= n_groups or E % n_groups
            or top_k > topk_groups * (E // n_groups)):
        raise ValueError(f"moe_gating: {E} experts in {n_groups} groups, "
                         f"{topk_groups} kept, top_k {top_k}")
    return logits


def moe_gating(logits: torch.Tensor, *, top_k: int, capacity: int,
               n_groups: int = 1, topk_groups: int = 1,
               renormalize: bool = True, scale: float = 1.0):
    """logits: (T, E) f32 router scores → (eids, gates, slots, keep), as
    :func:`moe_gating_plain`.

    On a CPU tensor: :func:`moe_gating_plain`.  On a CUDA tensor:
    launches the kernel on the current stream and counts the launch in
    ``moe_gating.launches``; raises on what the kernel does not take.  A
    traced call goes through the custom op: a fake tensor gets the
    outputs' shapes; a DTensor on a mesh of more than one rank is taken
    whole.
    """
    logits = _checked(logits, top_k, n_groups, topk_groups)
    if capacity < 1:
        raise ValueError(f"moe_gating: capacity {capacity}")
    opts = (n_groups, topk_groups, renormalize, scale)
    how = route(logits)
    if how == "plain":
        return moe_gating_plain(logits, top_k=top_k, capacity=capacity,
                                n_groups=n_groups, topk_groups=topk_groups,
                                renormalize=renormalize, scale=scale)
    if how == "launch":
        return _gating_launch(logits, top_k, capacity, *opts)
    return tuple(torch.ops.repro_torch.moe_gating(logits, top_k, capacity,
                                                  *opts))


def moe_gating_dropless(logits: torch.Tensor, *, top_k: int, held: int,
                        n_groups: int = 1, topk_groups: int = 1,
                        renormalize: bool = True, scale: float = 1.0):
    """logits: (T, E) f32 router scores → (eids, gates, rows, keep, ends),
    as :func:`moe_gating_dropless_plain`: the kernel's dropless mode on a
    CUDA tensor (counted in ``moe_gating.launches``), the plain version on
    a CPU tensor, the custom op for a traced call."""
    logits = _checked(logits, top_k, n_groups, topk_groups)
    if not 0 <= held <= logits.shape[1]:
        raise ValueError(f"moe_gating: {held} of {logits.shape[1]} experts "
                         f"held")
    opts = (n_groups, topk_groups, renormalize, scale)
    how = route(logits)
    if how == "plain":
        return moe_gating_dropless_plain(
            logits, top_k=top_k, held=held, n_groups=n_groups,
            topk_groups=topk_groups, renormalize=renormalize, scale=scale)
    if how == "launch":
        return _dropless_launch(logits, top_k, held, *opts)
    return tuple(torch.ops.repro_torch.moe_gating_dropless(logits, top_k,
                                                           held, *opts))


def _launch(logits: torch.Tensor, top_k: int, capacity: int, held: int,
            n_groups: int, topk_groups: int, renormalize: bool,
            scale: float):
    """The kernel's launch on a CUDA tensor (``capacity`` 0: the dropless
    mode, with the (E,) ends)."""
    T, E = logits.shape
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating: logits on {logits.device}; the kernel "
                         f"needs a CUDA device")
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError(f"moe_gating: the kernel takes contiguous float32 "
                         f"logits, not {logits.dtype}")
    if E > MAX_EXPERTS or top_k > MAX_TOP_K or n_groups > MAX_GROUPS:
        raise ValueError(f"moe_gating: {E} experts (at most {MAX_EXPERTS}), "
                         f"top_k {top_k} (at most {MAX_TOP_K}) or {n_groups} "
                         f"groups (at most {MAX_GROUPS}) not supported by "
                         f"the kernel")
    kw = dict(device=logits.device)
    eids = torch.empty((T, top_k), dtype=torch.int32, **kw)
    gates = torch.empty((T, top_k), dtype=torch.float32, **kw)
    slots = torch.empty((T, top_k), dtype=torch.int32, **kw)
    keep = torch.empty((T, top_k), dtype=torch.bool, **kw)
    ends = torch.empty((E,), dtype=torch.int32, **kw) if capacity == 0 \
        else None
    nb, threads = gating_launch_shape(T, max_cluster_blocks())
    fn = function("moe_gating", "moe_gating_fwd", _ARGTYPES)
    err = fn(logits.data_ptr(), eids.data_ptr(), gates.data_ptr(),
             slots.data_ptr(), keep.data_ptr(),
             None if ends is None else ends.data_ptr(), T, E, top_k,
             capacity, n_groups, topk_groups, int(renormalize), scale, held,
             nb, threads, torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_gating kernel launch failed: error {err}")
    moe_gating.launches += 1
    return eids, gates, slots, keep, ends


def _gating_launch(logits: torch.Tensor, top_k: int, capacity: int,
                   n_groups: int = 1, topk_groups: int = 1,
                   renormalize: bool = True, scale: float = 1.0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The kernel's launch on a CUDA tensor, capacity slots."""
    return _launch(logits, top_k, capacity, 0, n_groups, topk_groups,
                   renormalize, scale)[:4]


def _dropless_launch(logits: torch.Tensor, top_k: int, held: int,
                     n_groups: int = 1, topk_groups: int = 1,
                     renormalize: bool = True, scale: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """The kernel's launch on a CUDA tensor, its dropless mode."""
    return _launch(logits, top_k, 0, held, n_groups, topk_groups,
                   renormalize, scale)


_gating_op = torch.library.custom_op(
    "repro_torch::moe_gating", _gating_launch, mutates_args=(), device_types="cuda")


@_gating_op.register_kernel("cpu")
def _gating_cpu(logits, top_k, capacity, n_groups=1, topk_groups=1,
                renormalize=True, scale=1.0):
    return moe_gating_plain(logits, top_k=top_k, capacity=capacity,
                            n_groups=n_groups, topk_groups=topk_groups,
                            renormalize=renormalize, scale=scale)


@_gating_op.register_fake
def _gating_fake(logits, top_k, capacity, n_groups=1, topk_groups=1,
                 renormalize=True, scale=1.0):
    shape = (logits.shape[0], top_k)
    return (logits.new_empty(shape, dtype=torch.int32),
            logits.new_empty(shape, dtype=torch.float32),
            logits.new_empty(shape, dtype=torch.int32),
            logits.new_empty(shape, dtype=torch.bool))


@sharding_rule(torch.ops.repro_torch.moe_gating.default)
def _gating_rule(logits, top_k, capacity, n_groups=1, topk_groups=1,
                 renormalize=True, scale=1.0):
    """The capacity slots run across every token: the logits whole."""
    from torch.distributed.tensor import Replicate
    R = Replicate()
    return [([R, R, R, R], [R] + [None] * 6)]


register_cost(torch.ops.repro_torch.moe_gating, moe_gating_cost)

_dropless_op = torch.library.custom_op(
    "repro_torch::moe_gating_dropless", _dropless_launch, mutates_args=(),
    device_types="cuda")


@_dropless_op.register_kernel("cpu")
def _dropless_cpu(logits, top_k, held, n_groups=1, topk_groups=1,
                  renormalize=True, scale=1.0):
    return moe_gating_dropless_plain(
        logits, top_k=top_k, held=held, n_groups=n_groups,
        topk_groups=topk_groups, renormalize=renormalize, scale=scale)


@_dropless_op.register_fake
def _dropless_fake(logits, top_k, held, n_groups=1, topk_groups=1,
                   renormalize=True, scale=1.0):
    out = _gating_fake(logits, top_k, 1)
    return (*out, logits.new_empty((logits.shape[1],), dtype=torch.int32))


@sharding_rule(torch.ops.repro_torch.moe_gating_dropless.default)
def _dropless_rule(logits, top_k, held, n_groups=1, topk_groups=1,
                   renormalize=True, scale=1.0):
    """The rows run across every token: the logits whole."""
    from torch.distributed.tensor import Replicate
    R = Replicate()
    return [([R] * 5, [R] + [None] * 6)]


register_cost(torch.ops.repro_torch.moe_gating_dropless, _dropless_cost)

#: launches of the CUDA kernel, in either mode (never of the plain version)
moe_gating.launches = 0
