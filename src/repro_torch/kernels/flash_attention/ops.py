"""Flash attention (forward): the CUDA kernel's wrapper and its plain
PyTorch version.

Model code keeps the (B, S, H, D) layout; the kernel reads it in place
through strides (no transpose), so a slice of a KV cache goes in as it
is.  ``flash_attention`` launches ``csrc/flash_attention.cu`` for a CUDA
tensor and computes :func:`flash_attention_plain` for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._build import function

__all__ = ["flash_attention", "flash_attention_plain"]

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 4 + [_I] * 8 + [_L] * 9
             + [_I, _I, ctypes.c_float, _P])
#: the (q/k, v) counts of 64-column boxes the bf16 kernel is built for
#: (``csrc/flash_attention.cu``, ``tc::run``): D 8-64, 65-128 and 129-256
#: with Dv = D, and MLA's D 192 with Dv 128
_TC_BOXES = {(1, 1), (2, 2), (4, 4), (3, 2)}


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA steps in multiples of 16 bytes from a 16-byte aligned base (a
    dimension of extent 1 is never stepped)."""
    return t.data_ptr() % 16 == 0 and all(
        st > 0 and st % 8 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Dense f32 attention with the kernel's masking: an additive -1e30
    for keys hidden by the top-left causal mask or the window.

    q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv), H a multiple
    of K.  Returns (B, Sq, H, Dv) in q.dtype."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.float().reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    bias = torch.zeros((Sq, Sk), device=q.device)
    if causal:
        bias = bias + NEG * (q_pos < k_pos)
    if window is not None:
        bias = bias + NEG * (q_pos - k_pos >= window)
    p = torch.softmax(s + bias, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv) — model
    layout.  The value head dim Dv may differ from D (MLA).

    On a CUDA tensor: launches the kernel on the current stream (the
    executor's compute stream) and counts the launch in
    ``flash_attention.launches``; raises on what the kernel does not take.
    On a CPU tensor: :func:`flash_attention_plain`.
    """
    B, Sq, H, D = q.shape
    _, Sk, K, Dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D
            or H % K):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}; the kernel needs one "
                         f"CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of float32, "
                         f"bfloat16 for all three")
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
    fn = function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], B, H, K, Sq, Sk, D, Dv,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             int(causal), window or 0, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: error {err}")
    flash_attention.launches += 1
    return out


#: launches of the CUDA kernel (never of the plain version)
flash_attention.launches = 0
