"""RG-LRU scan: the CUDA kernel's wrapper and its plain PyTorch version.

``rglru_scan`` launches ``csrc/rglru_scan.cu`` for a CUDA tensor and
computes :func:`rglru_scan_plain` for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .._build import function

__all__ = ["ScanShape", "rglru_scan", "rglru_scan_plain", "scan_launch_shape"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P]

#: time steps a tile holds (the most; fewer where blocks share an SM),
#: tiles of x and a in a block's ring, and the out tiles beside them
TILE_ROWS, STAGES, _OUT_SLOTS = 128, 3, 2
#: shared memory of one SM, and what the kernel adds to its ring per block
#: (alignment slack, barriers, and the runtime's own 1 KB)
_SM_SMEM, _BLOCK_EXTRA = 228 * 1024, 128 + 256 + 1024
#: threads per block of the thread-per-channel kernel (``simt``)
_SIMT_THREADS = 64


class ScanShape(NamedTuple):
    """How ``csrc/rglru_scan.cu`` is launched for one call."""
    route: str    # "tma": time tiles in shared memory; or "simt"
    cb: int       # channels a block owns (0 for "simt")
    rows: int     # time steps a tile holds
    stages: int   # tiles in a block's ring
    blocks: int


def scan_launch_shape(B: int, S: int, dr: int, itemsize: int,
                      sm_count: int, *, aligned: bool = True) -> ScanShape:
    """The launch shape for x, a of (B, S, dr) with ``itemsize``-byte
    elements on a card of ``sm_count`` SMs.

    TMA reads rows whose stride is a multiple of 16 bytes from 16-byte
    aligned bases; anything else (``aligned`` False, or dr·itemsize not a
    multiple of 16) takes the thread-per-channel kernel.  Otherwise a
    block owns the most channels (32, 16 or 8) that keep at least half
    the SMs busy: each chain runs its steps one after another whatever
    the block count, and wider blocks read longer rows.  The ring has 3
    stages (fewer if S has fewer tiles) of the longest tiles (128 steps,
    or 64, 32, 16, never more than S) that let every block be resident at
    once."""
    if not aligned or (dr * itemsize) % 16:
        return ScanShape("simt", 0, 0, 0, B * -(-dr // _SIMT_THREADS))
    for cb in (32, 16, 8):
        blocks = B * -(-dr // cb)
        if 2 * blocks >= sm_count:
            break
    per_sm = -(-blocks // sm_count)
    for rows in (TILE_ROWS, 64, 32, 16):
        slot = -(-rows * cb * itemsize // 128) * 128
        if per_sm * ((2 * STAGES + _OUT_SLOTS) * slot + _BLOCK_EXTRA) \
                <= _SM_SMEM:
            break
    rows = min(rows, S)
    return ScanShape("tma", cb, rows, min(STAGES, -(-S // rows)), blocks)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    shape = scan_launch_shape(
        B, S, dr, x.element_size(), _sm_count(x.device.index),
        aligned=x.data_ptr() % 16 == 0 and a.data_ptr() % 16 == 0)
    fn = function("rglru_scan", "rglru_scan_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), a.data_ptr(), h0.data_ptr(), out.data_ptr(),
             _DTYPES[x.dtype], B, S, dr, shape.cb, shape.rows, shape.stages,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: error {err}")
    rglru_scan.launches += 1
    return out


#: launches of the CUDA kernel (never of the plain version)
rglru_scan.launches = 0
