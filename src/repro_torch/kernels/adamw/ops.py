"""AdamW's update of one leaf in one pass: the CUDA kernel's wrapper and
its plain PyTorch version.

``adamw`` runs :func:`adamw_plain` for a CPU tensor and launches
``csrc/adamw.cu`` for a CUDA tensor; a call something traces or counts
goes through the custom op ``repro_torch::adamw`` (the same launch on a
CUDA tensor, the plain version on a CPU one, nothing for a fake tensor,
counted by :func:`adamw_cost`), so the dry-run and ``FlopCounterMode``
see the update the card runs.  No TPU kernel stands behind it: the
reference's update is one XLA fusion, which the plain version's thirteen
full-size passes (~124 bytes a parameter) did not match; the kernel
reads the gradient, the parameter, m and v once and writes the
parameter, m and v once (28 bytes a parameter).

A DTensor on a mesh of more ranks is updated block by block (m and v
are sharded exactly like their parameter, and the update is
elementwise): the gradient is redistributed to the parameter's layout
first (a ``Partial`` gradient is reduced there), and m and v must share
it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import function
from .._cost import register_cost
from .._dtensor import counting_mode, local_operands, route
from ...core.streams import is_dtensor

__all__ = ["adamw", "adamw_blocks", "adamw_cost", "adamw_plain"]

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_ARGTYPES = [_P] * 4 + [ctypes.c_longlong] + [_P] * 4 + [_F] * 6 + [_I] * 2 \
    + [_P]
#: threads a block (the kernel's THREADS), and blocks an SM: a launch's
#: grid is at most BLOCKS_PER_SM times the SMs, all the card holds at once
THREADS, BLOCKS_PER_SM = 256, 8
#: bytes a parameter the kernel moves: g, p, m, v read; p, m, v written
BYTES_PER_PARAM = 28


def adamw_plain(g, p, m, v, scale, lr, bc1, bc2, *, b1: float, b2: float,
                eps: float, weight_decay: float) -> None:
    """One leaf's AdamW step, IN PLACE on ``p``, ``m`` and ``v``; ``g`` is
    read.  Thirteen elementwise passes over the leaf, its temporaries one
    leaf deep.  ``scale`` (the clip factor),
    ``lr`` and the bias corrections ``bc1`` and ``bc2`` are device
    scalars; the decoupled weight decay applies where ``p`` has two or
    more dims."""
    g = g.float() * scale
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
    pf = p if p.dtype == torch.float32 else p.float()
    if p.ndim >= 2:   # decoupled weight decay on matrices only
        delta.add_(pf, alpha=weight_decay)
    pf.sub_(delta.mul_(lr))
    if pf is not p:
        p.copy_(pf)


def adamw_cost(g, p, *args, **kwargs) -> tuple[int, int]:
    """(FLOPs, bytes) of one leaf's update by the kernel, from the op's
    arguments.  No FLOPs: the cost model counts products (as the
    reference's HLO count and ``FlopCounterMode`` do), and the plain
    version's elementwise passes counted none either."""
    return 0, p.numel() * BYTES_PER_PARAM


def adamw_blocks(n: int, sms: int) -> int:
    """Blocks of a launch over ``n`` elements: one a ``THREADS`` vectors
    of four, at most ``BLOCKS_PER_SM`` on each of ``sms``; the
    grid-stride loop takes the rest."""
    return max(1, min(-(-(n // 4) // THREADS), sms * BLOCKS_PER_SM))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def adamw(g, p, m, v, scale, lr, bc1, bc2, *, b1: float, b2: float,
          eps: float, weight_decay: float) -> None:
    """One leaf's AdamW step, as :func:`adamw_plain`: ``g`` the gradient
    and ``p`` the master, of one shape and dtype; ``m`` and ``v`` f32 of
    that shape; ``scale``, ``lr``, ``bc1``, ``bc2`` 0-d tensors; all on
    one device.  Raises on operands that break this.

    On a CPU tensor: :func:`adamw_plain`.  On a CUDA tensor: launches the
    kernel on the current stream, which reads the four scalars on the
    device, and counts the launch in ``adamw.launches``; it takes f32
    masters, contiguous and on 16 bytes, and raises on anything else.  A
    call something traces or counts (a fake or meta tensor, a DTensor on
    a mesh of more ranks, a Python dispatch mode on any device) goes
    through the custom op on each rank's block."""
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    scalars = (scale, lr, bc1, bc2)
    _check(g, p, m, v, scalars)
    blocks = local_operands("adamw", g, p, m, v)
    if any(map(is_dtensor, blocks)):
        g, p = blocks[:2]
        if is_dtensor(g) and is_dtensor(p):   # a pending sum: reduced here
            blocks[0] = g.redistribute(p.device_mesh, p.placements)
        layouts = {(t.device_mesh, tuple(t.placements)) if is_dtensor(t)
                   else None for t in blocks}
        if len(layouts) != 1:
            raise ValueError(f"adamw: g, p, m and v are laid out apart "
                             f"({layouts}); the update runs block by block")
        blocks = [t.to_local() for t in blocks]
    scalars = [s.full_tensor() if is_dtensor(s) else s for s in scalars]
    how = route(blocks[1])
    if how == "plain" and counting_mode():
        how = "op"
    if how == "plain":
        adamw_plain(*blocks, *scalars, **hyper)
    elif how == "launch":
        _adamw_launch(*blocks, *scalars, **hyper)
    else:
        torch.ops.repro_torch.adamw(*blocks, *scalars, **hyper)


def _check(g, p, m, v, scalars) -> None:
    """Raise unless the operands are a leaf's: g and p of one shape and
    dtype, m and v f32 of that shape, every scalar a one-element tensor,
    all on one device."""
    if g.shape != p.shape or g.dtype != p.dtype:
        raise ValueError(f"adamw: gradient {tuple(g.shape)} {g.dtype} and "
                         f"parameter {tuple(p.shape)} {p.dtype} differ")
    for name, t in (("m", m), ("v", v)):
        if t.shape != p.shape or t.dtype != torch.float32:
            raise ValueError(f"adamw: {name} {tuple(t.shape)} {t.dtype} is "
                             f"not float32 of the parameter's shape "
                             f"{tuple(p.shape)}")
    for name, s in zip(("scale", "lr", "bc1", "bc2"), scalars):
        if not isinstance(s, torch.Tensor) or s.numel() != 1:
            raise ValueError(f"adamw: {name} is not a one-element tensor")
    devices = {t.device for t in (g, p, m, v, *scalars)}
    if len(devices) != 1:
        raise ValueError(f"adamw: operands on several devices: {devices}")


def _adamw_launch(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, scale: torch.Tensor, lr: torch.Tensor,
                  bc1: torch.Tensor, bc2: torch.Tensor, *, b1: float,
                  b2: float, eps: float, weight_decay: float) -> None:
    """The kernel's launch on CUDA tensors."""
    if p.dtype != torch.float32:
        raise ValueError(f"adamw: the kernel takes float32 masters, not "
                         f"{p.dtype}")
    if not all(t.is_contiguous() for t in (g, p, m, v)):
        raise ValueError("adamw: the kernel takes contiguous g, p, m and v")
    if any(s.dtype != torch.float32 for s in (scale, lr, bc1, bc2)):
        raise ValueError("adamw: the kernel reads float32 scale, lr, bc1 "
                         "and bc2")
    if any(t.data_ptr() % 16 for t in (g, p, m, v)):
        raise ValueError("adamw: the kernel takes g, p, m and v on 16 bytes")
    fn = function("adamw", "adamw_update", _ARGTYPES)
    err = fn(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
             p.numel(), scale.data_ptr(), lr.data_ptr(), bc1.data_ptr(),
             bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
             int(p.dim() >= 2), adamw_blocks(p.numel(), _sms(p.device.index)),
             torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError(f"adamw kernel launch failed: error {err}")
    adamw.launches += 1


_adamw_op = torch.library.custom_op(
    "repro_torch::adamw", _adamw_launch, mutates_args=("p", "m", "v"),
    device_types="cuda")


@_adamw_op.register_kernel("cpu")
def _adamw_cpu(g, p, m, v, scale, lr, bc1, bc2, *, b1, b2, eps,
               weight_decay):
    adamw_plain(g, p, m, v, scale, lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay)


@_adamw_op.register_fake
def _adamw_fake(g, p, m, v, scale, lr, bc1, bc2, *, b1, b2, eps,
                weight_decay):
    return None


register_cost(torch.ops.repro_torch.adamw, adamw_cost)

#: launches of the CUDA kernel (never of the plain version)
adamw.launches = 0
