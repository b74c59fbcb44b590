"""Fused MoE gating: the CUDA kernel's wrapper and its plain PyTorch
version.

``moe_gating`` computes :func:`moe_gating_plain` for a CPU tensor and
launches ``csrc/moe_gating.cu`` for a CUDA tensor; a call something
traces goes through the custom op ``repro_torch::moe_gating`` (the same
launch, the outputs' shapes for a fake tensor, counted by
:func:`moe_gating_cost`).  Its capacity slots are handed out first come,
first served across all the tokens of the call, so no dim is
independent: its sharding rule takes the logits whole (a token-sharded
call is gathered first, never run one shard as the whole).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import function
from .._cost import register_cost
from .._dtensor import local_operands, route, sharding_rule

__all__ = ["gating_launch_shape", "max_cluster_blocks", "moe_gating",
           "moe_gating_cost", "moe_gating_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 6 + [_P]
#: what the kernel takes: experts (one warp's 8 registers per lane) and k
MAX_EXPERTS, MAX_TOP_K = 256, 8
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


def moe_gating_plain(logits: torch.Tensor, *, top_k: int, capacity: int):
    """Router softmax → top-k → first-come-first-served capacity slots.

    The top k are the first k of a stable descending sort, so the lower
    expert index comes first on ties (``lax.top_k``'s order, which
    ``torch.topk`` does not promise).  Positions count the earlier
    entries of the same expert in flattened (token, k) order.

    logits: (T, E).  Returns (eids (T, k) int32, gates (T, k) f32, slots
    (T, k) int32 = expert·C + position, keep (T, k) bool = position < C);
    a dropped entry's slot is expert·C."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = top[:, :top_k], order[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = eids.reshape(-1)
    # one-hot by comparison: F.one_hot reads a CPU tensor's indices back
    # to check them (a host sync inside the train step)
    hot = (flat[:, None] == torch.arange(E, device=flat.device)).long()
    rank = (hot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    keep = rank < capacity
    slots = flat * capacity + torch.where(keep, rank, 0)
    return (eids.to(torch.int32), gates,
            slots.reshape(T, top_k).to(torch.int32), keep.reshape(T, top_k))


def moe_gating_cost(logits, top_k: int, capacity: int = 0
                    ) -> tuple[int, int]:
    """(FLOPs, bytes) of a call: per token and expert the softmax's 4
    operations (max, exp, sum, scale) and one comparison per top-k pick;
    the logits read once and the four (T, k) outputs (eids, gates, slots
    int32/f32, keep bool) written once."""
    T, E = logits.shape
    return T * E * (4 + top_k), \
        logits.element_size() * T * E + T * top_k * (4 + 4 + 4 + 1)


def moe_gating(logits: torch.Tensor, *, top_k: int, capacity: int):
    """logits: (T, E) f32 router scores → (eids, gates, slots, keep), as
    :func:`moe_gating_plain`.

    On a CPU tensor: :func:`moe_gating_plain`.  On a CUDA tensor:
    launches the kernel on the current stream and counts the launch in
    ``moe_gating.launches``; raises on what the kernel does not take.  A
    traced call goes through the custom op: a fake tensor gets the
    outputs' shapes; a DTensor on a mesh of more than one rank is taken
    whole.
    """
    (logits,) = local_operands("moe_gating", logits)
    if logits.dim() != 2:
        raise ValueError(f"moe_gating: logits {tuple(logits.shape)} are not "
                         f"(tokens, experts)")
    T, E = logits.shape
    if not 1 <= top_k <= E or capacity < 1 or T < 1:
        raise ValueError(f"moe_gating: top_k {top_k} of {E} experts, "
                         f"capacity {capacity}, {T} tokens")
    how = route(logits)
    if how == "plain":
        return moe_gating_plain(logits, top_k=top_k, capacity=capacity)
    if how == "launch":
        return _gating_launch(logits, top_k, capacity)
    return tuple(torch.ops.repro_torch.moe_gating(logits, top_k, capacity))


def _gating_launch(logits: torch.Tensor, top_k: int, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The kernel's launch on a CUDA tensor."""
    T, E = logits.shape
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating: logits on {logits.device}; the kernel "
                         f"needs a CUDA device")
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError(f"moe_gating: the kernel takes contiguous float32 "
                         f"logits, not {logits.dtype}")
    if E > MAX_EXPERTS or top_k > MAX_TOP_K:
        raise ValueError(f"moe_gating: {E} experts (at most {MAX_EXPERTS}) "
                         f"or top_k {top_k} (at most {MAX_TOP_K}) not "
                         f"supported by the kernel")
    kw = dict(device=logits.device)
    eids = torch.empty((T, top_k), dtype=torch.int32, **kw)
    gates = torch.empty((T, top_k), dtype=torch.float32, **kw)
    slots = torch.empty((T, top_k), dtype=torch.int32, **kw)
    keep = torch.empty((T, top_k), dtype=torch.bool, **kw)
    nb, threads = gating_launch_shape(T, max_cluster_blocks())
    fn = function("moe_gating", "moe_gating_fwd", _ARGTYPES)
    err = fn(logits.data_ptr(), eids.data_ptr(), gates.data_ptr(),
             slots.data_ptr(), keep.data_ptr(), T, E, top_k, capacity, nb,
             threads, torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_gating kernel launch failed: error {err}")
    moe_gating.launches += 1
    return eids, gates, slots, keep


_gating_op = torch.library.custom_op(
    "repro_torch::moe_gating", _gating_launch, mutates_args=(), device_types="cuda")


@_gating_op.register_kernel("cpu")
def _gating_cpu(logits, top_k, capacity):
    return moe_gating_plain(logits, top_k=top_k, capacity=capacity)


@_gating_op.register_fake
def _gating_fake(logits, top_k, capacity):
    shape = (logits.shape[0], top_k)
    return (logits.new_empty(shape, dtype=torch.int32),
            logits.new_empty(shape, dtype=torch.float32),
            logits.new_empty(shape, dtype=torch.int32),
            logits.new_empty(shape, dtype=torch.bool))


@sharding_rule(torch.ops.repro_torch.moe_gating.default)
def _gating_rule(logits, top_k, capacity):
    """The capacity slots run across every token: the logits whole."""
    from torch.distributed.tensor import Replicate
    R = Replicate()
    return [([R, R, R, R], [R, None, None])]


register_cost(torch.ops.repro_torch.moe_gating, moe_gating_cost)

#: launches of the CUDA kernel (never of the plain version)
moe_gating.launches = 0
