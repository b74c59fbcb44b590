"""Flash attention: the CUDA kernels' wrappers (forward and backward) and
their plain PyTorch versions, joined for autograd.

Model code keeps the (B, S, H, D) layout; the forward kernel reads it in
place through strides (no transpose), so a slice of a KV cache goes in
as it is.  ``flash_attention`` launches ``csrc/flash_attention.cu`` for a
CUDA tensor and computes :func:`flash_attention_plain` for a CPU tensor.
When an input requires a gradient it goes through :class:`FlashAttention`
(the reference's ``custom_vjp``, ``repro.models.layers._make_flash``):
the forward also writes the rows' log-sum-exp, and the backward
(``csrc/flash_attention_bwd.cu``, or :func:`flash_attention_bwd_plain` on
the CPU) recomputes the probabilities from it, so nothing of size S x S
is kept.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .._build import function
from .._dtensor import local_operands

__all__ = ["BwdPass", "BwdShape", "FlashAttention", "bwd_launch_shape",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain"]

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 5 + [_I] * 8 + [_L] * 9
             + [_I, _I, _I, ctypes.c_float, _P])
_BWD_ARGTYPES = [_P] * 12 + [_I] * 10 + [ctypes.c_float, _P]
#: the (q/k, v) counts of 64-column boxes the bf16 kernel is built for
#: (``csrc/flash_attention.cu``, ``tc::run``): D 8-64, 65-128 and 129-256
#: with Dv = D, and MLA's D 192 with Dv 128
_TC_BOXES = {(1, 1), (2, 2), (4, 4), (3, 2)}


#: the backward's tensor-core kernels: rows of a warpgroup and of a
#: streamed tile, and the dynamic shared memory a block may have
_BWD_TILE, _SMEM_MAX = 64, 227 * 1024


class BwdPass(NamedTuple):
    """How one pass of ``csrc/flash_attention_bwd.cu`` is launched."""
    rows: int         # rows a block owns: kv rows (dK/dV), q rows (dQ)
    tile: int         # rows of each tile streamed past them
    stages: int       # tiles in the block's ring
    smem: int         # dynamic shared memory of a block, bytes
    warpgroups: int   # of 128 threads, the producer's included


class BwdShape(NamedTuple):
    """The launch shape of the flash backward for one (D, Dv, dtype)."""
    route: str                # "tc": bf16 on wgmma; "simt": f32 FMAs
    boxes: tuple[int, int]    # 64-column boxes of D and Dv ("tc")
    dkdv: BwdPass
    dq: BwdPass


def bwd_launch_shape(D: int, Dv: int, dtype: torch.dtype) -> BwdShape:
    """The backward's launch shape, as ``csrc/flash_attention_bwd.cu``
    computes it (``tc::KvLayout``, ``tc::QLayout``; ``run`` for f32).

    bf16: the forward's box pairs only (``_TC_BOXES``); any other raises.
    dK/dV: one 64-row kv tile per block of a producer and two consumer
    warpgroups, Q, dO and row-stat stages of 64 q rows, as many as fit
    (at most 4) beside K, V and the 16 KB Pᵀ hand-over.  dQ: 64 q rows
    per consumer warpgroup, two where their Q and dO tiles and two K, V
    stages fit, else one.  f32: the CUDA-core tiles (BQ, BK) by the widest
    head dim, 256 threads, one tile at a time."""
    if dtype == torch.float32:
        w = max(D, Dv)
        bq, bk = (64, 64) if w <= 64 else (32, 64) if w <= 128 else (64, 32)
        smem = 4 * (bk * (D + 1) + bk * (Dv + 1) + bq * (D + 1)
                    + bq * (Dv + 1) + 2 * bq * (bk + 1) + 2 * bq)
        return BwdShape("simt", (0, 0), BwdPass(bk, bq, 1, smem, 2),
                        BwdPass(bq, bk, 1, smem, 2))
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
    query row i at position ``q_offset + i``."""
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
                          with_lse: bool = False, q_offset: int = 0):
    """Dense f32 attention with the kernel's masking: an additive -1e30
    for keys hidden by the causal mask (query row i, at position
    ``q_offset + i``, sees keys j <= q_offset + i) or the window (and
    q_offset + i - j < window).

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, with_lse: bool = False,
                    q_offset: int = 0):
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv) — model
    layout.  The value head dim Dv may differ from D (MLA).  ``q_offset``
    is the position of q's first row among the keys (a prompt at a cache
    offset: its length), so the causal mask is q_offset + i >= j.

    When an input requires a gradient (and grad mode is on), the call
    goes through :class:`FlashAttention`, whose backward is
    :func:`flash_attention_bwd`.  Otherwise, on a CUDA tensor: launches
    the kernel on the current stream (the executor's compute stream) and
    counts the launch in ``flash_attention.launches``; raises on what the
    kernel does not take.  On a CPU tensor: :func:`flash_attention_plain`.
    ``with_lse`` also returns the rows' f32 log-sum-exp (B, H, Sq)
    (no autograd).  A gradient is taken at ``q_offset`` 0 only, as the
    reference differentiates only that path (its ``custom_vjp``); at an
    offset under autograd the call raises.
    """
    q, k, v = local_operands("flash_attention", q, k, v)
    scale = _check(q, k, v, window, scale)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    if not with_lse and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        if q_offset:
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
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, with_lse=with_lse,
                                     q_offset=q_offset)
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
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             _DTYPES[q.dtype], B, H, K, Sq, Sk, D, Dv,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             int(causal), window or 0, q_offset, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: error {err}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None):
    """The gradients (dq, dk, dv) of ``out = flash_attention(q, k, v)`` at
    ``dout``, given the forward's ``lse`` (B, H, Sq) f32.  Shapes as the
    forward's, out and dout (B, Sq, H, Dv); dq, dk, dv in the inputs'
    dtype.

    On a CUDA tensor: launches ``csrc/flash_attention_bwd.cu`` (its three
    passes, and the GQA reduction, on the current stream; bf16 on the
    tensor cores, f32 on the CUDA cores, see :func:`bwd_launch_shape`) and
    counts the call in ``flash_attention_bwd.launches``; raises on what
    the kernel does not take.  On a CPU tensor:
    :func:`flash_attention_bwd_plain`.
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
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         scale=scale)
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
    dev = q.device
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    dk_ws = dv_ws = None
    if H > K:        # per-head partials, summed over each group in order
        dk_ws = torch.empty((B, Sk, H, D), dtype=torch.float32, device=dev)
        dv_ws = torch.empty((B, Sk, H, Dv), dtype=torch.float32, device=dev)
    fn = function("flash_attention_bwd", "flash_attention_bwd",
                  _BWD_ARGTYPES)
    err = fn(*(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq,
                                      dk, dv)),
             None if dk_ws is None else dk_ws.data_ptr(),
             None if dv_ws is None else dv_ws.data_ptr(),
             _DTYPES[q.dtype], B, H, K, Sq, Sk, D, Dv, int(causal),
             window or 0, scale, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


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


#: launches of the CUDA kernels (never of the plain versions)
flash_attention.launches = 0
flash_attention_bwd.launches = 0
