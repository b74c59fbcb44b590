"""Fused MoE gating: the CUDA kernel's wrapper and its plain PyTorch
version.

``moe_gating`` launches ``csrc/moe_gating.cu`` for a CUDA tensor and
computes :func:`moe_gating_plain` for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .._build import function
from .._dtensor import local_operands

__all__ = ["gating_launch_shape", "max_cluster_blocks", "moe_gating",
           "moe_gating_plain"]

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
    rank = (F.one_hot(flat, E).cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    keep = rank < capacity
    slots = flat * capacity + torch.where(keep, rank, 0)
    return (eids.to(torch.int32), gates,
            slots.reshape(T, top_k).to(torch.int32), keep.reshape(T, top_k))


def moe_gating(logits: torch.Tensor, *, top_k: int, capacity: int):
    """logits: (T, E) f32 router scores → (eids, gates, slots, keep), as
    :func:`moe_gating_plain`.

    On a CUDA tensor: launches the kernel on the current stream and
    counts the launch in ``moe_gating.launches``; raises on what the
    kernel does not take.  On a CPU tensor: :func:`moe_gating_plain`.
    """
    (logits,) = local_operands("moe_gating", logits)
    if logits.dim() != 2:
        raise ValueError(f"moe_gating: logits {tuple(logits.shape)} are not "
                         f"(tokens, experts)")
    T, E = logits.shape
    if not 1 <= top_k <= E or capacity < 1 or T < 1:
        raise ValueError(f"moe_gating: top_k {top_k} of {E} experts, "
                         f"capacity {capacity}, {T} tokens")
    if logits.device.type == "cpu":
        return moe_gating_plain(logits, top_k=top_k, capacity=capacity)
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


#: launches of the CUDA kernel (never of the plain version)
moe_gating.launches = 0
