"""RG-LRU scan: the CUDA kernels' wrappers (forward and backward) and
their plain PyTorch versions, joined for autograd.

``rglru_scan`` computes :func:`rglru_scan_plain` for a CPU tensor and
launches ``csrc/rglru_scan.cu`` for a CUDA tensor; a call something
traces goes through the custom op ``repro_torch::rglru_scan`` (the same
launch, the output's shape for a fake tensor, counted by
:func:`rglru_scan_cost`, split over a mesh by its sharding rule: batch
and channels).  When an input requires a gradient the call goes
through :class:`RGLRUScan`, whose backward is the reverse-time chain of
``csrc/rglru_scan_bwd.cu`` (:func:`rglru_scan_bwd_plain` on the CPU),
the custom op ``repro_torch::rglru_scan_bwd``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .._build import function
from .._cost import register_cost
from .._dtensor import local_operands, route, sharding_rule

__all__ = ["RGLRUScan", "ScanShape", "rglru_scan", "rglru_scan_bwd",
           "rglru_scan_bwd_cost", "rglru_scan_bwd_plain", "rglru_scan_cost",
           "rglru_scan_plain", "scan_launch_shape"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P]
_BWD_ARGTYPES = [_P] * 7 + [_I] * 7 + [_P]

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
                      sm_count: int, *, aligned: bool = True,
                      inputs: int = 2, outputs: int = 1) -> ScanShape:
    """The launch shape for x, a of (B, S, dr) with ``itemsize``-byte
    elements on a card of ``sm_count`` SMs: the forward's, which streams
    ``inputs`` = 2 tiles (x, a) per stage and writes ``outputs`` = 1
    (out) per out slot, or the backward's (3: dy, a, h; 2: dx, da).

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
        if per_sm * ((inputs * STAGES + outputs * _OUT_SLOTS) * slot
                     + _BLOCK_EXTRA) <= _SM_SMEM:
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


def rglru_scan_bwd_plain(dy: torch.Tensor, a: torch.Tensor, h: torch.Tensor,
                         h0: torch.Tensor):
    """The gradients (dx, da, dh0) of ``h = rglru_scan_plain(x, a, h0)``
    at ``dy``, by the reverse loop dh_t = dy_t + a_{t+1}·dh_{t+1}:
    dx_t = dh_t, da_t = dh_t·h_{t−1} (h_{−1} = h0), dh0 = a_0·dh_0 — h0
    enters as the reference's virtual first step.  f32, each step
    rounding apart as the kernel does; dx and da in dy's dtype, dh0 f32."""
    S = dy.shape[1]
    dx = torch.empty(dy.shape, dtype=torch.float32, device=dy.device)
    da = torch.empty_like(dx)
    g = torch.zeros_like(h0, dtype=torch.float32)
    for t in range(S - 1, -1, -1):
        dh = dy[:, t].float() + g
        dx[:, t] = dh
        da[:, t] = dh * (h[:, t - 1].float() if t else h0.float())
        g = a[:, t].float() * dh
    return dx.to(dy.dtype), da.to(dy.dtype), g


def rglru_scan_cost(x, a, h0) -> tuple[int, int]:
    """(FLOPs, bytes) of a call: a multiply and an add per step and
    channel (f32); x and a read once, the output written once, h0 read."""
    B, S, dr = x.shape
    return 2 * B * S * dr, \
        3 * B * S * dr * x.element_size() + h0.element_size() * B * dr


def rglru_scan_bwd_cost(dy, a, h, h0) -> tuple[int, int]:
    """(FLOPs, bytes) of a backward call: per step and channel the carry's
    multiply-add and dh·h_{t−1} (f32); dy, a and h read once, dx and da
    written once, h0 read and dh0 written."""
    B, S, dr = dy.shape
    return 3 * B * S * dr, \
        5 * B * S * dr * dy.element_size() + 2 * h0.element_size() * B * dr


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """x, a: (B, S, dr) of one type; h0: (B, dr) f32 carry.

    When an input requires a gradient (and grad mode is on), the call
    goes through :class:`RGLRUScan`.  Otherwise, on a CPU tensor:
    :func:`rglru_scan_plain`; on a CUDA tensor: launches the kernel on
    the current stream and counts the launch in ``rglru_scan.launches``,
    raising on what the kernel does not take.  A traced call goes through
    the custom op: a fake tensor gets the output's shape; DTensors on a
    mesh of more than one rank run per rank under the op's sharding
    rule.
    """
    x, a, h0 = local_operands("rglru_scan", x, a, h0)
    if torch.is_grad_enabled() and (
            x.requires_grad or a.requires_grad or h0.requires_grad):
        return RGLRUScan.apply(x, a, h0)
    return _forward(x, a, h0)


def _check_cuda(name: str, tensors, h0) -> None:
    t0 = tensors[0]
    if t0.device.type != "cuda" or any(t.device != t0.device
                                       for t in (*tensors, h0)):
        raise ValueError(f"{name}: the kernel needs every tensor on one "
                         f"CUDA device")
    if t0.dtype not in _DTYPES or any(t.dtype != t0.dtype for t in tensors) \
            or h0.dtype != torch.float32:
        raise ValueError(f"{name}: dtypes "
                         f"{', '.join(str(t.dtype) for t in tensors)}, "
                         f"{h0.dtype}; the kernel takes one of float32, "
                         f"bfloat16 for all but an f32 h0")
    if not all(t.is_contiguous() for t in (*tensors, h0)):
        raise ValueError(f"{name}: every tensor must be contiguous")


def _forward(x, a, h0):
    B, S, dr = x.shape
    if a.shape != x.shape or tuple(h0.shape) != (B, dr):
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, h0 {tuple(h0.shape)} do not fit")
    how = route(x)
    if how == "plain":
        return rglru_scan_plain(x, a, h0)
    if how == "launch":
        return _scan_launch(x, a, h0)
    return torch.ops.repro_torch.rglru_scan(x, a, h0)


def _scan_launch(x: torch.Tensor, a: torch.Tensor,
                 h0: torch.Tensor) -> torch.Tensor:
    """The forward kernel's launch on a CUDA tensor."""
    B, S, dr = x.shape
    _check_cuda("rglru_scan", (x, a), h0)
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


_scan_op = torch.library.custom_op(
    "repro_torch::rglru_scan", _scan_launch, mutates_args=(), device_types="cuda")


@_scan_op.register_kernel("cpu")
def _scan_cpu(x, a, h0):
    return rglru_scan_plain(x, a, h0)


@_scan_op.register_fake
def _scan_fake(x, a, h0):
    return torch.empty_like(x)


def rglru_scan_bwd(dy: torch.Tensor, a: torch.Tensor, h: torch.Tensor,
                   h0: torch.Tensor):
    """The gradients (dx, da, dh0) of ``h = rglru_scan(x, a, h0)`` at
    ``dy``: dy, a, h (B, S, dr) of one type, h0 (B, dr) f32.  dx and da
    in that type, dh0 f32.

    On a CPU tensor: :func:`rglru_scan_bwd_plain`.  On a CUDA tensor:
    launches ``csrc/rglru_scan_bwd.cu`` on the current stream and counts
    the launch in ``rglru_scan_bwd.launches``, raising on what the kernel
    does not take.  A traced call goes through the custom op: a fake
    tensor gets the outputs' shapes; DTensors on a mesh of more than one
    rank run per rank under the op's sharding rule."""
    dy, a, h, h0 = local_operands("rglru_scan_bwd", dy, a, h, h0)
    B, S, dr = dy.shape
    if a.shape != dy.shape or h.shape != dy.shape \
            or tuple(h0.shape) != (B, dr):
        raise ValueError(f"rglru_scan_bwd: dy {tuple(dy.shape)}, a "
                         f"{tuple(a.shape)}, h {tuple(h.shape)}, h0 "
                         f"{tuple(h0.shape)} do not fit")
    how = route(dy)
    if how == "plain":
        return rglru_scan_bwd_plain(dy, a, h, h0)
    if how == "launch":
        return _scan_bwd_launch(dy, a, h, h0)
    return tuple(torch.ops.repro_torch.rglru_scan_bwd(dy, a, h, h0))


def _scan_bwd_launch(dy: torch.Tensor, a: torch.Tensor, h: torch.Tensor,
                     h0: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's launch on a CUDA tensor."""
    B, S, dr = dy.shape
    _check_cuda("rglru_scan_bwd", (dy, a, h), h0)
    dx, da = torch.empty_like(dy), torch.empty_like(dy)
    dh0 = torch.empty_like(h0)
    aligned = all(t.data_ptr() % 16 == 0 for t in (dy, a, h, dx, da))
    shape = scan_launch_shape(B, S, dr, dy.element_size(),
                              _sm_count(dy.device.index), aligned=aligned,
                              inputs=3, outputs=2)
    fn = function("rglru_scan_bwd", "rglru_scan_bwd", _BWD_ARGTYPES)
    err = fn(dy.data_ptr(), a.data_ptr(), h.data_ptr(), h0.data_ptr(),
             dx.data_ptr(), da.data_ptr(), dh0.data_ptr(), _DTYPES[dy.dtype],
             B, S, dr, shape.cb, shape.rows, shape.stages,
             torch.cuda.current_stream(dy.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed: error "
                           f"{err}")
    rglru_scan_bwd.launches += 1
    return dx, da, dh0


_scan_bwd_op = torch.library.custom_op(
    "repro_torch::rglru_scan_bwd", _scan_bwd_launch, mutates_args=(), device_types="cuda")


@_scan_bwd_op.register_kernel("cpu")
def _scan_bwd_cpu(dy, a, h, h0):
    return rglru_scan_bwd_plain(dy, a, h, h0)


@_scan_bwd_op.register_fake
def _scan_bwd_fake(dy, a, h, h0):
    return torch.empty_like(dy), torch.empty_like(dy), torch.empty_like(h0)


@sharding_rule(torch.ops.repro_torch.rglru_scan.default)
def _scan_rule(x, a, h0):
    """Independent over the batch (dim 0) and the channels (x's dim 2,
    h0's dim 1); the time dim is the chain."""
    from torch.distributed.tensor import Replicate, Shard
    R, B, C = Replicate(), Shard(0), Shard(2)
    return [([R], [R, R, R]), ([B], [B, B, B]), ([C], [C, C, Shard(1)])]


@sharding_rule(torch.ops.repro_torch.rglru_scan_bwd.default)
def _scan_bwd_rule(dy, a, h, h0):
    """As the forward's: batch, or channels."""
    from torch.distributed.tensor import Replicate, Shard
    R, B, C, C0 = Replicate(), Shard(0), Shard(2), Shard(1)
    return [([R, R, R], [R, R, R, R]), ([B, B, B], [B, B, B, B]),
            ([C, C, C0], [C, C, C, C0])]


register_cost(torch.ops.repro_torch.rglru_scan, rglru_scan_cost)
register_cost(torch.ops.repro_torch.rglru_scan_bwd, rglru_scan_bwd_cost)


class RGLRUScan(torch.autograd.Function):
    """The scan with its reverse-time backward: the forward keeps a, h0
    and its own output h.  Kernels on CUDA tensors, plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, x, a, h0):
        h = _forward(x, a, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dy):
        a, h, h0 = ctx.saved_tensors
        return rglru_scan_bwd(dy.contiguous(), a, h, h0)


#: launches of the CUDA kernels (never of the plain versions)
rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
