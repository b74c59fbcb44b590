"""Decode attention: the CUDA kernel's wrapper and its plain PyTorch
version.

``decode_attention`` computes :func:`decode_attention_plain` for a CPU
tensor and launches ``csrc/decode_attention.cu`` for a CUDA tensor.  A
call something traces (a fake tensor in the dry-run, a DTensor, a
dispatch mode such as ``FlopCounterMode``) goes through the custom op
``repro_torch::decode_attention``: the same launch on a CUDA tensor, the
output's shape for a fake one (``register_fake``), counted by
:func:`decode_attention_cost`, split over a mesh by its sharding rule
(batch and heads).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._build import function
from .._cost import register_cost
from .._dtensor import kv_for_q_heads, local_operands, route, sharding_rule

__all__ = ["decode_attention", "decode_attention_cost",
           "decode_attention_plain"]

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 5 + [_I] * 7 + [_L] * 6 + [ctypes.c_float, _P]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """Dense f32 decode attention with the kernel's masking: cache rows at
    or past ``valid_len`` get an additive -1e30, so a row with
    ``valid_len == 0`` averages V over the whole cache.

    q: (B, H, D); k: (B, S, K, D); v: (B, S, K, Dv); valid_len: (B,).
    Returns (B, H, Dv) in q.dtype."""
    B, H, D = q.shape
    S, K, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.float().reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qh, k.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < valid_len.to(q.device)[:, None])              # (B, S)
    s = s + NEG * (~valid)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, Dv).to(q.dtype)


def decode_attention_cost(q, k, v, valid_len, scale=None, *,
                          rows: int | None = None) -> tuple[int, int]:
    """(FLOPs, bytes) of a call: the products q·Kᵀ over D and p·V over Dv
    for each query head and each cache row the call reads, the rows read
    once, q read and the output written.  ``rows`` is the sum over the
    batch of min(valid_len, S), which only the data gives (the kernel
    stops at ``valid_len``); without it every row counts, as a shape-only
    trace (the dry-run, ``FlopCounterMode``) must."""
    B, H, D = q.shape
    _, S, K, Dv = v.shape
    rows = B * S if rows is None else rows
    flops = 2 * rows * H * (D + Dv)
    nbytes = q.element_size() * (rows * K * (D + Dv) + B * H * (D + Dv)) \
        + valid_len.element_size() * B
    return flops, nbytes


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, H, D) one token per sequence; k: (B, S, K, D) and v: (B,
    S, K, Dv) cache, Dv possibly not D (MLA); valid_len: (B,) int32 rows
    of the cache each sequence attends to.

    On a CPU tensor: :func:`decode_attention_plain`.  On a CUDA tensor:
    launches the kernel on the current stream (the executor's compute
    stream) and counts the launch in ``decode_attention.launches``;
    raises on what the kernel does not take.  A traced call goes through
    the custom op (``_dtensor.route``): a fake tensor gets the output's
    shape; DTensors on a mesh of more than one rank run per rank under
    the op's sharding rule.
    """
    q, k, v, valid_len = local_operands("decode_attention", q, k, v,
                                        valid_len)
    B, H, D = q.shape
    _, S, K, Dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D
            or H % K or tuple(valid_len.shape) != (B,)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, valid_len "
                         f"{tuple(valid_len.shape)} do not fit")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    how = route(q)
    if how == "plain":
        return decode_attention_plain(q, k, v, valid_len, scale=scale)
    if how == "launch":
        return _decode_launch(q, k, v, valid_len, scale)
    q, k, v = kv_for_q_heads(q, k, v, 1, 2)
    return torch.ops.repro_torch.decode_attention(q, k, v, valid_len, scale)


def _decode_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid_len: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's launch on a CUDA tensor."""
    B, H, D = q.shape
    _, S, K, Dv = v.shape
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, valid_len)):
        raise ValueError("decode_attention: the kernel needs q, k, v and "
                         "valid_len on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of float32, "
                         f"bfloat16 for all three")
    if valid_len.dtype != torch.int32:
        raise ValueError("decode_attention: valid_len must be int32")
    if D % 8 or D > 256 or Dv % 8 or Dv > 256:
        raise ValueError(f"decode_attention: head dims {D}, {Dv} are not "
                         f"multiples of 8 up to 256")
    if not (q.is_contiguous() and valid_len.is_contiguous()):
        raise ValueError("decode_attention: q and valid_len must be "
                         "contiguous")
    for t in (k, v):
        if (t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError("decode_attention: the cache needs a contiguous "
                             "head dim, strides in multiples of 8 elements "
                             "and a 16-byte aligned base")
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    fn = function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
             out.data_ptr(), _DTYPES[q.dtype], B, H, K, S, D, Dv,
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"error {err}")
    decode_attention.launches += 1
    return out


_decode_op = torch.library.custom_op(
    "repro_torch::decode_attention", _decode_launch, mutates_args=(), device_types="cuda")


@_decode_op.register_kernel("cpu")
def _decode_cpu(q, k, v, valid_len, scale):
    return decode_attention_plain(q, k, v, valid_len, scale=scale)


@_decode_op.register_fake
def _decode_fake(q, k, v, valid_len, scale):
    return q.new_empty((q.shape[0], q.shape[1], v.shape[3]))


@sharding_rule(torch.ops.repro_torch.decode_attention.default)
def _decode_rule(q, k, v, valid_len, scale):
    """Independent over the batch (every operand's dim 0) and the heads
    (q's dim 1, the cache's dim 2; kv_for_q_heads lays out GQA)."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    return [([R], [R, R, R, R, None]),
            ([Shard(0)], [Shard(0)] * 4 + [None]),
            ([Shard(1)], [Shard(1), Shard(2), Shard(2), R, None])]


register_cost(torch.ops.repro_torch.decode_attention, decode_attention_cost)

#: launches of the CUDA kernel (never of the plain version)
decode_attention.launches = 0
