"""Flash attention: the CUDA kernels' wrappers (forward and backward) and
their plain PyTorch versions, joined for autograd.

Model code keeps the (B, S, H, D) layout; the forward kernel reads it in
place through strides (no transpose), so a slice of a KV cache goes in
as it is.  ``flash_attention`` computes :func:`flash_attention_plain`
for a CPU tensor and launches ``csrc/flash_attention.cu`` for a CUDA
tensor; a call something traces goes through the custom op
``repro_torch::flash_attention`` (the same launch, the outputs' shapes
for a fake tensor, counted by :func:`flash_attention_cost`, split over a
mesh by its sharding rule: batch and heads).  When
an input requires a gradient it goes through :class:`FlashAttention`
(the reference's ``custom_vjp``, ``repro.models.layers._make_flash``):
the forward also writes the rows' log-sum-exp, and the backward
(``csrc/flash_attention_bwd.cu`` through the custom op
``repro_torch::flash_attention_bwd``, or :func:`flash_attention_bwd_plain`
on the CPU) recomputes the probabilities from it, so nothing of size
S x S is kept.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .._build import function
from .._cost import register_cost
from .._dtensor import kv_for_q_heads, local_operands, route, sharding_rule

__all__ = ["BwdPass", "BwdShape", "FlashAttention", "bwd_launch_shape",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_cost", "flash_attention_bwd_plain",
           "flash_attention_cost", "flash_attention_plain", "seen_pairs"]

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 5 + [_I] * 8 + [_L] * 9
             + [_I, _I, _I, _P, ctypes.c_float, _P])
_BWD_ARGTYPES = [_P] * 12 + [_I] * 10 + [ctypes.c_float, _P]
#: the (q/k, v) counts of 64-column boxes the bf16 kernel is built for
#: (``csrc/flash_attention.cu``, ``tc::run``): D 8-64, 65-128 and 129-256
#: with Dv = D, and MLA's D 192 with Dv 128
_TC_BOXES = {(1, 1), (2, 2), (4, 4), (3, 2)}


#: the backward's bf16 kernels: rows of a warpgroup and of a streamed
#: tile, and the dynamic shared memory a block may have
_BWD_TILE, _SMEM_MAX = 64, 227 * 1024


def _two_fit(smem: int) -> bool:
    """Whether two blocks of ``smem`` bytes share an SM (228 KB, 1 KB a
    block reserved)."""
    return 2 * (smem + 1024) <= 228 * 1024


def _tile_ld(w: int) -> int:
    """Floats a row of an f32 kernel's shared tile takes (``tile_ld`` in
    ``csrc/hopper.cuh``): w rounded up to 32, plus 4."""
    return -(-w // 32) * 32 + 4


class BwdPass(NamedTuple):
    """How one pass of ``csrc/flash_attention_bwd.cu`` is launched."""
    rows: int         # rows a block owns: kv rows (dK/dV), q rows (dQ)
    tile: int         # rows of each tile streamed past them
    stages: int       # tiles in the block's ring
    smem: int         # dynamic shared memory of a block, bytes
    warpgroups: int   # of 128 threads, the producer's included


class BwdShape(NamedTuple):
    """The launch shape of the flash backward for one (D, Dv, dtype)."""
    route: str                # "tc": bf16 on wgmma; "tf32x3": f32 on mma.sync
    boxes: tuple[int, int]    # 64-column boxes of D and Dv ("tc")
    dkdv: BwdPass
    dq: BwdPass


def bwd_launch_shape(D: int, Dv: int, dtype: torch.dtype) -> BwdShape:
    """The backward's launch shape, as ``csrc/flash_attention_bwd.cu``
    computes it (``tc::KvLayout``, ``tc::QLayout``; ``tf32::kv_smem``,
    ``tf32::dq_smem`` and ``tf32::run_n`` for f32).

    bf16: the forward's box pairs only (``_TC_BOXES``); any other raises.
    dK/dV: one 64-row kv tile per block of a producer and two consumer
    warpgroups, Q, dO and row-stat stages of 64 q rows, as many as fit
    (at most 4) beside K, V and the 16 KB Pᵀ hand-over.  dQ: 64 q rows
    per consumer warpgroup, two where their Q and dO tiles and two K, V
    stages fit, else one.

    f32 (route "tf32x3", any D and Dv that are multiples of 8 up to 256):
    no producer, rows ``_tile_ld`` floats apart, two stages.  dK/dV: 8 kv
    rows a warp, four warps, or eight where two blocks of four do not
    share an SM but one of eight fits; stages of 32 q rows (Q, dO and the
    rows' two stats) and the Pᵀ hand-over (kv rows x 32 floats).  dQ: 16
    q rows a warp and stages of kv rows (K, V): four warps and 64 rows,
    else 32, where two such blocks share an SM, else the first of (8, 32),
    (8, 24), (8, 16), (4, 32), (4, 16) that fits."""
    if dtype == torch.float32:
        w = _tile_ld(D) + _tile_ld(Dv)

        def kv_smem(warps):
            return 4 * (8 * warps * w + 2 * (32 * w + 64) + 8 * warps * 32)

        def dq_smem(warps, rows):
            return 4 * (16 * warps + 2 * rows) * w

        kvw = 8 if (not _two_fit(kv_smem(4))
                    and kv_smem(8) <= _SMEM_MAX) else 4
        dqw, bk = next(iter(
            [(4, k) for k in (64, 32) if _two_fit(dq_smem(4, k))]
            + [(wr, k) for wr, k in ((8, 32), (8, 24), (8, 16), (4, 32),
                                     (4, 16)) if dq_smem(wr, k) <= _SMEM_MAX]))
        return BwdShape("tf32x3", (0, 0),
                        BwdPass(8 * kvw, 32, 2, kv_smem(kvw), kvw // 4),
                        BwdPass(16 * dqw, bk, 2, dq_smem(dqw, bk), dqw // 4))
    boxes = (-(-D // 64), -(-Dv // 64))
    if dtype != torch.bfloat16 or boxes not in _TC_BOXES:
        raise ValueError(f"flash_attention_bwd: the bf16 kernels are not "
                         f"built for head dims D {D}, Dv {Dv} ({dtype})")
    box = _BWD_TILE * 128                 # bytes of a 64-row box
    nc, ncv = boxes
    # alignment slack and barriers, K, V, the hand-over; a stage: Q, dO, stats
    fixed = 2048 + (nc + ncv) * box + _BWD_TILE * _BWD_TILE * 4
    stage = (nc + ncv) * box + _BWD_TILE * 8
    st = min(4, (_SMEM_MAX - fixed) // stage)
    dkdv = BwdPass(_BWD_TILE, _BWD_TILE, st, fixed + st * stage, 3)
    cons = 2 if 2048 + 4 * (nc + ncv) * box <= _SMEM_MAX else 1
    fixed = 2048 + cons * (nc + ncv) * box
    st = min(4, (_SMEM_MAX - fixed) // ((nc + ncv) * box))
    dq = BwdPass(cons * _BWD_TILE, _BWD_TILE, st,
                 fixed + st * (nc + ncv) * box, cons + 1)
    return BwdShape("tc", boxes, dkdv, dq)


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA steps in multiples of 16 bytes from a 16-byte aligned base (a
    dimension of extent 1 is never stepped)."""
    return t.data_ptr() % 16 == 0 and all(
        st > 0 and st % 8 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _plain_scores(q, k, causal, window, scale, q_offset=0):
    """The masked f32 scores (B, K, G, Sq, Sk) of the plain version: an
    additive -1e30 for keys hidden by the causal mask or the window, with
    query row i at position ``q_offset + i`` (an int, or a (1,) int64
    tensor on q's device)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qh = q.float().reshape(B, Sq, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    bias = torch.zeros((Sq, Sk), device=q.device)
    if causal:
        bias = bias + NEG * (q_pos < k_pos)
    if window is not None:
        bias = bias + NEG * (q_pos - k_pos >= window)
    return s + bias


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None,
                          with_lse: bool = False,
                          q_offset: int | torch.Tensor = 0):
    """Dense f32 attention with the kernel's masking: an additive -1e30
    for keys hidden by the causal mask (query row i, at position
    ``q_offset + i``, sees keys j <= q_offset + i) or the window (and
    q_offset + i - j < window).  ``q_offset``: an int, or a (1,) int64
    tensor on q's device (read there, never on the host).

    q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv), H a multiple
    of K; Sk may exceed Sq (a prompt at a cache offset attends to the
    cache's earlier rows).  Returns (B, Sq, H, Dv) in q.dtype, and with
    ``with_lse`` also each row's f32 log-sum-exp over its scaled, masked
    scores, (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Dv = v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = _plain_scores(q, k, causal, window, scale, q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = o.reshape(B, Sq, H, Dv).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return out


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                              window: int | None = None,
                              scale: float | None = None):
    """The gradients (dq, dk, dv) of :func:`flash_attention_plain` at
    ``dout``, dense in f32: P recomputed from ``lse`` (B, H, Sq),
    D_i = rowsum(dout ⊙ out), dS = P ⊙ (dout·Vᵀ − D)·scale, dk and dv
    summed over each kv head's group.  In the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    p = torch.exp(_plain_scores(q, k, causal, window, scale)
                  - lse.float().reshape(B, K, G, Sq, 1))
    do = dout.float().reshape(B, Sq, K, G, Dv)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", do,
                         out.float().reshape(B, Sq, K, G, Dv))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, K, G, D))
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def seen_pairs(Sq: int, Sk: int, *, causal: bool = True,
               window: int | None = None, q_offset: int = 0) -> int:
    """The (query, key) pairs a call computes: query row i, at position
    p = q_offset + i, sees keys j <= p (causal; else every key) and
    p - j < window (a window): the causal half and the window's band, not
    the masked parts of the tiles at their edges."""
    p = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    hi = np.minimum(p + 1, Sk) if causal else np.full_like(p, Sk)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros_like(p)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention_cost(q, k, v, window: int = 0, q_offset: int = 0,
                         causal: bool = True, with_lse: bool = False,
                         scale: float = 0.0) -> tuple[int, int]:
    """(FLOPs, bytes) of a forward call, the custom op's arguments in
    (``window`` 0: none): the products S = q·Kᵀ over D and P·V over Dv
    for every pair :func:`seen_pairs` counts, per query head; q, k and v
    read once, the output (and the f32 log-sum-exp) written once."""
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    seen = seen_pairs(Sq, Sk, causal=causal, window=window or None,
                      q_offset=q_offset)
    nbytes = q.element_size() * B * (Sq * H * (D + Dv)
                                     + Sk * K * (D + Dv))
    return 2 * B * H * (D + Dv) * seen, nbytes + (4 * B * H * Sq
                                                  if with_lse else 0)


def flash_attention_bwd_cost(q, k, v, out, dout, lse, window: int = 0,
                             causal: bool = True,
                             scale: float = 0.0) -> tuple[int, int]:
    """(FLOPs, bytes) of a backward call: the five products a flash
    backward needs for every seen pair (S again and dK, dQ over D; dP
    and dV over Dv), not the kernels' recomputations or bf16 hi/lo
    splits; q, k, v, out, dout and the log-sum-exp read once, dq, dk and
    dv written once."""
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    seen = seen_pairs(Sq, Sk, causal=causal, window=window or None)
    nbytes = q.element_size() * B * (Sq * H * 2 * (D + Dv)
                                     + Sk * K * 2 * (D + Dv))
    return 2 * B * H * (3 * D + 2 * Dv) * seen, nbytes + 4 * B * H * Sq


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, with_lse: bool = False,
                    q_offset: int | torch.Tensor = 0):
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv) — model
    layout.  The value head dim Dv may differ from D (MLA).  ``q_offset``
    is the position of q's first row among the keys (a prompt at a cache
    offset: its length), so the causal mask is q_offset + i >= j: an int,
    or a (1,) int64 tensor on q's device, which the kernel reads there (a
    chunk of a captured prefill, whose one graph serves every offset; k
    and v are then the cache's whole rows, and the caller checks that
    the chunk fits them).  A device offset launches directly on a CUDA
    tensor; the custom op takes an int.

    When an input requires a gradient (and grad mode is on), the call
    goes through :class:`FlashAttention`, whose backward is
    :func:`flash_attention_bwd`.  Otherwise, on a CPU tensor:
    :func:`flash_attention_plain`; on a CUDA tensor: launches the kernel
    on the current stream (the executor's compute stream) and counts the
    launch in ``flash_attention.launches`` (an f32 launch also in
    ``flash_attention.f32_launches``), raising on what the kernel does not
    take.  A traced call goes through the custom op: a fake
    tensor gets the outputs' shapes; DTensors on a mesh of more than one
    rank run per rank under the op's sharding rule.
    ``with_lse`` also returns the rows' f32 log-sum-exp (B, H, Sq)
    (no autograd).  A gradient is taken at ``q_offset`` 0 only, as the
    reference differentiates only that path (its ``custom_vjp``); at an
    offset under autograd the call raises.
    """
    q, k, v = local_operands("flash_attention", q, k, v)
    scale = _check(q, k, v, window, scale)
    at_device = isinstance(q_offset, torch.Tensor)
    if at_device:
        if (tuple(q_offset.shape) != (1,) or q_offset.dtype != torch.long
                or q_offset.device != q.device):
            raise ValueError(f"flash_attention: a device q_offset is a (1,) "
                             f"int64 tensor on q's device, got "
                             f"{tuple(q_offset.shape)} {q_offset.dtype} on "
                             f"{q_offset.device}")
    elif q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    q, k, v = kv_for_q_heads(q, k, v, 2, 2)
    if not with_lse and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        if at_device or q_offset:
            raise NotImplementedError(
                "flash_attention: no backward at a q offset (a prompt at a "
                "cache offset); the reference differentiates q_offset 0 "
                "only")
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, with_lse, q_offset)


def _check(q, k, v, window, scale) -> float:
    """Shapes and window of a call; returns the scale (default 1/√D)."""
    B, Sq, H, D = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D
            or H % k.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    return scale if scale is not None else 1.0 / math.sqrt(D)


def _check_cuda(name, tensors) -> None:
    """One CUDA device and one dtype the kernels take, for all of
    ``tensors``."""
    t0 = tensors[0]
    if t0.device.type != "cuda" or any(t.device != t0.device
                                       for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{', '.join(str(t.device) for t in tensors)}; the "
                         f"kernel needs one CUDA device")
    if t0.dtype not in _DTYPES or any(t.dtype != t0.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes "
                         f"{', '.join(str(t.dtype) for t in tensors)}; the "
                         f"kernel takes one of float32, bfloat16 for all")


def _forward(q, k, v, causal, window, scale, with_lse, q_offset=0):
    how = route(q)
    if how == "plain":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, with_lse=with_lse,
                                     q_offset=q_offset)
    if isinstance(q_offset, torch.Tensor):
        if how != "launch":
            raise NotImplementedError(
                "flash_attention: a device q_offset launches directly; the "
                "custom op (a traced call) takes an int offset")
        out, lse = _launch(q, k, v, window or 0, 0, q_offset, causal,
                           with_lse, scale)
        return (out, lse) if with_lse else out
    args = (q, k, v, window or 0, q_offset, causal, with_lse, scale)
    out, lse = (_fwd_launch(*args) if how == "launch"
                else torch.ops.repro_torch.flash_attention(*args))
    return (out, lse) if with_lse else out


def _fwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, q_offset: int, causal: bool, with_lse: bool,
                scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch on a CUDA tensor: (out, lse), lse
    empty without ``with_lse`` (the kernel then writes none)."""
    return _launch(q, k, v, window, q_offset, None, causal, with_lse, scale)


def _launch(q, k, v, window: int, q_offset: int, q_offset_dev, causal: bool,
            with_lse: bool, scale: float):
    """:func:`_fwd_launch`, with the q offset from the host int
    ``q_offset`` or, where ``q_offset_dev`` is a (1,) int64 tensor, read
    by the kernel from the device."""
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    _check_cuda("flash_attention", (q, k, v))
    if D % 8 or D > 256 or Dv % 8 or Dv > 256:
        raise ValueError(f"flash_attention: head dims {D}, {Dv} are not "
                         f"multiples of 8 up to 256")
    if min(q.stride(3), k.stride(3), v.stride(3)) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16 and not all(map(_tma_ready, (q, k, v))):
        raise ValueError("flash_attention: bf16 tensors are read with TMA: "
                         "strides in multiples of 8 elements and a 16-byte "
                         "aligned base")
    if q.dtype == torch.bfloat16 and (-(-D // 64), -(-Dv // 64)) \
            not in _TC_BOXES:
        raise ValueError(f"flash_attention: the bf16 kernel is not built "
                         f"for head dims D {D}, Dv {Dv}")
    out, lse = _fwd_fake(q, k, v, window, q_offset, causal, with_lse, scale)
    fn = function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None,
             _DTYPES[q.dtype], B, H, K, Sq, Sk, D, Dv,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             int(causal), window or 0, q_offset,
             None if q_offset_dev is None else q_offset_dev.data_ptr(),
             scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: error {err}")
    flash_attention.launches += 1
    flash_attention.f32_launches += int(q.dtype == torch.float32)
    return out, lse


_fwd_op = torch.library.custom_op(
    "repro_torch::flash_attention", _fwd_launch, mutates_args=(), device_types="cuda")


@_fwd_op.register_kernel("cpu")
def _fwd_cpu(q, k, v, window, q_offset, causal, with_lse, scale):
    out = flash_attention_plain(q, k, v, causal=causal, window=window or None,
                                scale=scale, with_lse=with_lse,
                                q_offset=q_offset)
    return out if with_lse else (out, _no_lse(q))


def _no_lse(q):
    return q.new_empty((0,), dtype=torch.float32)


@_fwd_op.register_fake
def _fwd_fake(q, k, v, window, q_offset, causal, with_lse, scale):
    B, Sq, H, _ = q.shape
    out = q.new_empty((B, Sq, H, v.shape[3]))
    return out, (q.new_empty((B, H, Sq), dtype=torch.float32)
                 if with_lse else _no_lse(q))


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None):
    """The gradients (dq, dk, dv) of ``out = flash_attention(q, k, v)`` at
    ``dout``, given the forward's ``lse`` (B, H, Sq) f32.  Shapes as the
    forward's, out and dout (B, Sq, H, Dv); dq, dk, dv in the inputs'
    dtype.

    On a CPU tensor: :func:`flash_attention_bwd_plain`.  On a CUDA
    tensor: launches ``csrc/flash_attention_bwd.cu`` (its three passes,
    and the GQA reduction, on the current stream; both dtypes on the
    tensor cores, f32 as three TF32 products per product, see
    :func:`bwd_launch_shape`) and counts the call in
    ``flash_attention_bwd.launches`` (an f32 call also in
    ``flash_attention_bwd.f32_launches``), raising on what the kernel
    does not take.  A traced call goes through the custom op:
    a fake tensor gets the outputs' shapes, the kernel's scratch (D_i,
    the GQA partials) among them; DTensors on a mesh of more than one
    rank run per rank under the op's sharding rule.
    """
    q, k, v, out, dout, lse = local_operands("flash_attention_bwd", q, k, v,
                                             out, dout, lse)
    scale = _check(q, k, v, window, scale)
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    if tuple(out.shape) != (B, Sq, H, Dv) or out.shape != dout.shape \
            or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"do not fit q {tuple(q.shape)}, v {tuple(v.shape)}")
    how = route(q)
    if how == "plain":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         scale=scale)
    args = (q, k, v, out, dout, lse, window or 0, causal, scale)
    return tuple((_bwd_launch(*args) if how == "launch"
                  else torch.ops.repro_torch.flash_attention_bwd(*args))[:3])


def _bwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                window: int, causal: bool, scale: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's launch on a CUDA tensor: (dq, dk, dv) and
    its scratch, D_i (B, H, Sq) and, under GQA, the per-q-head f32 dK
    and dV partials (empty at H == K)."""
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    _check_cuda("flash_attention_bwd", (q, k, v, out, dout))
    if lse.device != q.device or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: lse must be f32 on q's device")
    if D % 8 or D > 256 or Dv % 8 or Dv > 256:
        raise ValueError(f"flash_attention_bwd: head dims {D}, {Dv} are not "
                         f"multiples of 8 up to 256")
    if q.dtype == torch.bfloat16:
        bwd_launch_shape(D, Dv, q.dtype)     # raises on a pair not built
    q, k, v, out, dout, lse = (t.contiguous()
                               for t in (q, k, v, out, dout, lse))
    if q.dtype == torch.bfloat16 and not all(map(_tma_ready,
                                                 (q, k, v, out, dout))):
        raise ValueError("flash_attention_bwd: bf16 tensors are read in "
                         "16-byte pieces: a 16-byte aligned base")
    if q.dtype == torch.float32:        # read 16 bytes a copy, as bf16 is
        q, k, v, out, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (q, k, v, out, dout))
    dev = q.device
    dq, dk, dv, delta, dk_ws, dv_ws = _bwd_fake(q, k, v, out, dout, lse,
                                                window, causal, scale)
    fn = function("flash_attention_bwd", "flash_attention_bwd",
                  _BWD_ARGTYPES)
    err = fn(*(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq,
                                      dk, dv)),
             dk_ws.data_ptr() if H > K else None,
             dv_ws.data_ptr() if H > K else None,
             _DTYPES[q.dtype], B, H, K, Sq, Sk, D, Dv, int(causal),
             window or 0, scale, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.f32_launches += int(q.dtype == torch.float32)
    return dq, dk, dv, delta, dk_ws, dv_ws


_bwd_op = torch.library.custom_op(
    "repro_torch::flash_attention_bwd", _bwd_launch, mutates_args=(), device_types="cuda")


@_bwd_op.register_kernel("cpu")
def _bwd_cpu(q, k, v, out, dout, lse, window, causal, scale):
    grads = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=causal,
                                      window=window or None, scale=scale)
    return (*grads, *(_no_lse(q) for _ in range(3)))


@_bwd_op.register_fake
def _bwd_fake(q, k, v, out, dout, lse, window, causal, scale):
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    f32 = dict(dtype=torch.float32)
    ws = ((q.new_empty((B, Sk, H, D), **f32),
           q.new_empty((B, Sk, H, Dv), **f32)) if H > K
          else (_no_lse(q), _no_lse(q)))
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            q.new_empty((B, H, Sq), **f32), *ws)


@sharding_rule(torch.ops.repro_torch.flash_attention.default)
def _fwd_rule(q, k, v, window, q_offset, causal, with_lse, scale):
    """Independent over the batch (dim 0) and the heads (dim 2 of q, k,
    v and out, dim 1 of the log-sum-exp); kv_for_q_heads lays out GQA."""
    from torch.distributed.tensor import Replicate, Shard
    R, B, Hd = Replicate(), Shard(0), Shard(2)
    rest = [None] * 5
    return [([R, R], [R, R, R, *rest]),
            ([B, B if with_lse else R], [B, B, B, *rest]),
            ([Hd, Shard(1) if with_lse else R], [Hd, Hd, Hd, *rest])]


@sharding_rule(torch.ops.repro_torch.flash_attention_bwd.default)
def _bwd_rule(q, k, v, out, dout, lse, window, causal, scale):
    """As the forward's: batch, or heads (D_i and the log-sum-exp on
    dim 1, the GQA partials on dim 2)."""
    from torch.distributed.tensor import Replicate, Shard
    R, B, Hd = Replicate(), Shard(0), Shard(2)
    gqa = q.shape[2] > k.shape[2]
    rest = [None] * 3
    return [([R] * 6, [R] * 6 + rest),
            ([B, B, B, B, *([B if gqa else R] * 2)], [B] * 6 + rest),
            ([Hd, Hd, Hd, Shard(1), *([Hd if gqa else R] * 2)],
             [Hd] * 5 + [Shard(1)] + rest)]


register_cost(torch.ops.repro_torch.flash_attention, flash_attention_cost)
register_cost(torch.ops.repro_torch.flash_attention_bwd,
              flash_attention_bwd_cost)


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: the forward keeps q, k, v, out
    and the rows' log-sum-exp (linear in S), the backward recomputes the
    probabilities from them.  Kernels on CUDA tensors, plain versions on
    CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _forward(q, k, v, causal, window, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None


#: launches of the CUDA kernels (never of the plain versions), and of
#: their f32 route alone
flash_attention.launches = flash_attention.f32_launches = 0
flash_attention_bwd.launches = flash_attention_bwd.f32_launches = 0
