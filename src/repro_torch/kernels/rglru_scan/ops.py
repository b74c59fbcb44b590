"""RG-LRU scan: the CUDA kernel's wrapper and its plain PyTorch version.

``rglru_scan`` launches ``csrc/rglru_scan.cu`` for a CUDA tensor and
computes :func:`rglru_scan_plain` for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import function

__all__ = ["rglru_scan", "rglru_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 4 + [_P]


def rglru_scan_plain(x: torch.Tensor, a: torch.Tensor,
                     h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + x_t step by step in f32, seeded by ``h0``.

    x, a: (B, S, dr); h0: (B, dr).  Returns (B, S, dr) in x.dtype.  Each
    step rounds the product and the sum apart, as the kernel does."""
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    h = h0.float()
    for t in range(x.shape[1]):
        h = a[:, t].float() * h + x[:, t].float()
        out[:, t] = h
    return out.to(x.dtype)


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """x, a: (B, S, dr) of one type; h0: (B, dr) f32 carry.

    On a CUDA tensor: launches the kernel on the current stream and
    counts the launch in ``rglru_scan.launches``; raises on what the
    kernel does not take.  On a CPU tensor: :func:`rglru_scan_plain`.
    """
    B, S, dr = x.shape
    if a.shape != x.shape or tuple(h0.shape) != (B, dr):
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, h0 {tuple(h0.shape)} do not fit")
    if x.device.type == "cpu":
        return rglru_scan_plain(x, a, h0)
    if x.device.type != "cuda" or a.device != x.device \
            or h0.device != x.device:
        raise ValueError("rglru_scan: the kernel needs x, a and h0 on one "
                         "CUDA device")
    if x.dtype not in _DTYPES or a.dtype != x.dtype \
            or h0.dtype != torch.float32:
        raise ValueError(f"rglru_scan: dtypes {x.dtype}, {a.dtype}, "
                         f"{h0.dtype}; the kernel takes x and a of one of "
                         f"float32, bfloat16 and an f32 h0")
    if not (x.is_contiguous() and a.is_contiguous() and h0.is_contiguous()):
        raise ValueError("rglru_scan: x, a and h0 must be contiguous")
    out = torch.empty_like(x)
    fn = function("rglru_scan", "rglru_scan_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), a.data_ptr(), h0.data_ptr(), out.data_ptr(),
             _DTYPES[x.dtype], B, S, dr,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: error {err}")
    rglru_scan.launches += 1
    return out


#: launches of the CUDA kernel (never of the plain version)
rglru_scan.launches = 0
