"""Shared model layers: norms, RoPE, GQA attention (global, and local
over a ring-buffer cache), SwiGLU.

Attention calls the hand-written kernels (``repro_torch.kernels``):
flash attention for a prompt, decode attention for one token against a
cache.  On a CPU tensor those wrappers compute their plain PyTorch
versions.  Weights are ``(in, out)`` and applied as ``x @ W``, as in the
JAX reference (``repro.models.layers``); the reference's sharding hints
have no meaning on one device and are dropped.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import decode_attention, flash_attention

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# initializers / norms
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float | None = None,
               count: int | None = None) -> torch.Tensor:
    """Normal weights of the per-layer ``shape``, drawn as ``(count,
    *shape)`` when ``count`` stacks them over layers.  Scaled by
    ``scale``, default 1/sqrt(``shape[0]``): the reference's rule
    (``repro.models.layers.dense_init``), the fan-in of a 2-d weight and
    the leading expert or block count of a 3-d one."""
    s = scale if scale is not None else 1.0 / math.sqrt(
        shape[0] if len(shape) >= 2 else 1)
    full = tuple(shape) if count is None else (count, *shape)
    w = torch.randn(full, generator=gen, device=device, dtype=torch.float32)
    return (w * s).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               m_rope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, D) by ``positions`` (B, S): split-half
    rotation (the two halves of the head dim pair up), not interleaved.
    M-RoPE (Qwen2-VL) waits for the slice that ports its family."""
    if m_rope_sections:
        raise NotImplementedError(
            "M-RoPE is not ported yet (vision-language slice)")
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                     # (D/2,)
    angles = positions[..., None].float() * freqs               # (B,S,D/2)
    cos = torch.cos(angles)[..., None, :]                       # (B,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None,
              valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention.  q: (B, Sq, H, D); k, v: (B, Sk, K, D).

    One query token (decode) goes to the decode-attention kernel: rows
    below ``valid_len`` are attended (default 1: a lone token without a
    cache sees itself).  A prompt goes to the flash-attention kernel
    (top-left causal, optional ``window``).  Windowed decode on a cache
    that is not a ring is not ported yet; a prompt at a cache offset
    (chunked prefill) raises in :func:`attn_forward`.
    """
    B, Sq, H, D = q.shape
    if Sq == 1:
        if window is not None:
            raise NotImplementedError(
                "windowed decode on a non-ring cache is not ported yet; "
                "local attention decodes over a ring cache (valid_len)")
        if valid_len is None:
            valid_len = torch.ones((B,), dtype=torch.int32, device=q.device)
        out = decode_attention(q[:, 0], k, v, valid_len, scale=scale)
        return out[:, None]
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale)


def init_attn(cfg, gen: torch.Generator, device, count: int = 1,
              local: bool = False) -> Params:
    """Attention weights stacked over ``count`` layers: (count, in, out).
    Local attention has the same weights: ``local`` changes nothing and
    is kept only to match the reference's signature."""
    d, hd = cfg.d_model, cfg.head_dim_
    H, K = cfg.n_heads, cfg.n_kv_heads
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wq": dense_init(gen, (d, H * hd), dt, device, count=count),
        "wk": dense_init(gen, (d, K * hd), dt, device, count=count),
        "wv": dense_init(gen, (d, K * hd), dt, device, count=count),
        "wo": dense_init(gen, (H * hd, d), dt, device, count=count),
    }


def attn_forward(cfg, p: Params, x, positions, cache=None, *,
                 local: bool = False, step=None):
    """x: (B, S, d).  cache: dict(k, v, length) of one layer, or None.

    Returns (out, new_cache).  KV cache layout: (B, S_max, K, hd); the
    new k/v rows are written into the cache tensors IN PLACE (no copy of
    the cache per token), and ``length`` is a host int counting every
    token seen.  A decode step (S = 1 with a cache) takes ``step``, its
    cache row and ``valid_len`` as device tensors made once per step
    (``transformer._decode_steps``), so it reads no host scalar.
    ``local``: sliding-window attention over ``cfg.rec.local_window``;
    its cache of W <= window rows is a ring holding the last W tokens
    (post-RoPE keys, so the rotation survives the wrap), as the
    reference's (``layers.py`` ring branch).
    """
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    cdt = getattr(torch, cfg.compute_dtype)
    q = (x @ p["wq"].to(cdt)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(cdt)).reshape(B, S, K, hd)
    v = (x @ p["wv"].to(cdt)).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.m_rope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.m_rope_sections)
    window = cfg.rec.local_window if local else None
    new_cache = None
    if cache is None:
        out = attention(q, k, v, causal=True, window=window)
    else:
        length = cache["length"]
        k_cache, v_cache = cache["k"], cache["v"]
        if local and k_cache.shape[1] > window:
            raise NotImplementedError(
                "a local-attention cache longer than its window is not "
                "ported; init_cache builds W = min(max_len, local_window)")
        if S == 1:
            # decode: write row pos % W, attend to the valid rows, read
            # from the cache as the reference reads it (in the compute
            # dtype); a ring holds exactly the past window, so validity
            # is the whole mask
            row, valid_len = step
            k_cache.index_copy_(1, row, k.to(k_cache.dtype))
            v_cache.index_copy_(1, row, v.to(v_cache.dtype))
            out = attention(q, k_cache.to(cdt), v_cache.to(cdt),
                            valid_len=valid_len)
        elif length != 0:
            raise NotImplementedError(
                "chunked prefill (a prompt at cache offset > 0) is not "
                "ported yet; see ROADMAP.md")
        elif local:
            out = attention(q, k, v, causal=True, window=window)
            _ring_fill(k_cache, v_cache, k, v)
        else:
            k_cache[:, :S] = k.to(k_cache.dtype)
            v_cache[:, :S] = v.to(v_cache.dtype)
            # a fresh prefill attends to its own rows of the cache, as
            # the reference reads them back
            out = attention(q, k_cache[:, :S].to(cdt),
                            v_cache[:, :S].to(cdt))
        new_cache = {"k": k_cache, "v": v_cache, "length": length + S}
    out = out.reshape(B, S, H * hd) @ p["wo"].to(cdt)
    return out, new_cache


def _ring_fill(k_cache, v_cache, k, v) -> None:
    """A fresh prefill's last min(S, W) k/v rows into a ring of W rows, at
    their slots ``(S - tail .. S - 1) % W``: a rotation done as two
    slices."""
    S, W = k.shape[1], k_cache.shape[1]
    tail = min(S, W)
    start = (S - tail) % W
    first = min(tail, W - start)
    for cache_t, new in ((k_cache, k), (v_cache, v)):
        new = new[:, S - tail:].to(cache_t.dtype)
        cache_t[:, start:start + first] = new[:, :first]
        cache_t[:, :tail - first] = new[:, first:]


def init_attn_cache(cfg, batch: int, max_len: int, dtype, device,
                    count: int = 1) -> Params:
    K, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((count, batch, max_len, K, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((count, batch, max_len, K, hd), dtype=dtype,
                         device=device),
        "length": 0,
    }


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------
def init_ffn(cfg, gen: torch.Generator, device, count: int = 1,
             d_ff: int | None = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    return {
        "w_gate": dense_init(gen, (d, f), dt, device, count=count),
        "w_up": dense_init(gen, (d, f), dt, device, count=count),
        "w_down": dense_init(gen, (f, d), dt, device, count=count),
    }


def ffn_forward(cfg, p: Params, x):
    cdt = getattr(torch, cfg.compute_dtype)
    g = F.silu(x @ p["w_gate"].to(cdt))
    u = x @ p["w_up"].to(cdt)
    return (g * u) @ p["w_down"].to(cdt)
