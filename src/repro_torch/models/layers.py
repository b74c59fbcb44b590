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
               scale: float | None = None) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(fan_in); a leading stack axis
    (``(count, in, out)``) keeps the per-layer fan-in."""
    fan_in = shape[-2] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
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
def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              window: int | None = None, scale: float | None = None,
              valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention.  q: (B, Sq, H, D); k, v: (B, Sk, K, D).

    One query token (decode) goes to the decode-attention kernel: rows
    below ``valid_len`` (default ``q_offset + 1`` — the reference's
    ``kpos <= q_offset`` mask) are attended.  A prompt at ``q_offset``
    0 goes to the flash-attention kernel (top-left causal, optional
    ``window``).  A prompt at a later offset (chunked prefill) and
    windowed decode on a cache that is not a ring are not ported yet.
    """
    B, Sq, H, D = q.shape
    if Sq == 1:
        if window is not None:
            raise NotImplementedError(
                "windowed decode on a non-ring cache is not ported yet; "
                "local attention decodes over a ring cache (valid_len)")
        if valid_len is None:
            valid_len = torch.full((B,), q_offset + 1, dtype=torch.int32,
                                   device=q.device)
        out = decode_attention(q[:, 0], k, v, valid_len, scale=scale)
        return out[:, None]
    if q_offset != 0:
        raise NotImplementedError(
            "chunked prefill (a prompt at cache offset > 0) is not ported "
            "yet; see ROADMAP.md")
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
        "wq": dense_init(gen, (count, d, H * hd), dt, device),
        "wk": dense_init(gen, (count, d, K * hd), dt, device),
        "wv": dense_init(gen, (count, d, K * hd), dt, device),
        "wo": dense_init(gen, (count, H * hd, d), dt, device),
    }


def attn_forward(cfg, p: Params, x, positions, cache=None, *,
                 local: bool = False, valid_len=None):
    """x: (B, S, d).  cache: dict(k, v, length) of one layer, or None.

    Returns (out, new_cache).  KV cache layout: (B, S_max, K, hd); the
    new k/v rows are written into the cache tensors IN PLACE (no copy of
    the cache per token), and ``length`` is a host int counting every
    token seen.  ``valid_len`` may carry the decode mask's device tensor,
    made once per step.  ``local``: sliding-window attention over
    ``cfg.rec.local_window``; its cache of W <= window rows is a ring
    holding the last W tokens (post-RoPE keys, so the rotation survives
    the wrap), as the reference's (``layers.py`` ring branch).
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
    if cache is not None and local:
        out, new_cache = _ring_attention(q, k, v, cache, window, valid_len,
                                         cdt)
    elif cache is not None:
        length = cache["length"]
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, length:length + S] = k.to(k_cache.dtype)
        v_cache[:, length:length + S] = v.to(v_cache.dtype)
        if S == 1:
            # decode: rows 0..length, read from the cache as the
            # reference reads it (cast to the compute dtype)
            out = attention(q, k_cache.to(cdt), v_cache.to(cdt),
                            q_offset=length, valid_len=valid_len)
        else:
            # a fresh prefill attends to its own rows of the cache: with
            # offset 0 the causal mask hides every row >= S
            out = attention(q, k_cache[:, :S].to(cdt),
                            v_cache[:, :S].to(cdt), q_offset=length)
        new_cache = {"k": k_cache, "v": v_cache, "length": length + S}
    else:
        out = attention(q, k, v, causal=True, window=window)
        new_cache = None
    out = out.reshape(B, S, H * hd) @ p["wo"].to(cdt)
    return out, new_cache


def _ring_attention(q, k, v, cache, window: int, valid_len, cdt):
    """Local attention against a ring cache of W rows (W <= window).

    Decode writes row ``length % W`` and attends to the ``min(length + 1,
    W)`` valid rows: the ring holds exactly the past window, so validity
    is the whole mask.  A fresh prefill attends to its own k/v with the
    window and then writes its last ``min(S, W)`` rows at their ring
    slots ``(S - tail .. S - 1) % W``, a rotation done as two slices."""
    B, S = q.shape[:2]
    length = cache["length"]
    k_cache, v_cache = cache["k"], cache["v"]
    W = k_cache.shape[1]
    if W > window:
        raise NotImplementedError(
            "a local-attention cache longer than its window is not ported; "
            "init_cache builds W = min(max_len, local_window)")
    if S == 1:
        slot = length % W
        k_cache[:, slot:slot + 1] = k.to(k_cache.dtype)
        v_cache[:, slot:slot + 1] = v.to(v_cache.dtype)
        if valid_len is None:
            valid_len = torch.full((B,), min(length + 1, W),
                                   dtype=torch.int32, device=q.device)
        out = attention(q, k_cache.to(cdt), v_cache.to(cdt),
                        valid_len=valid_len)
    else:
        if length != 0:
            raise NotImplementedError(
                "chunked prefill (a prompt at cache offset > 0) is not "
                "ported yet; see ROADMAP.md")
        out = attention(q, k, v, causal=True, window=window)
        tail = min(S, W)
        start = (S - tail) % W
        first = min(tail, W - start)
        for cache_t, new in ((k_cache, k), (v_cache, v)):
            new = new[:, S - tail:].to(cache_t.dtype)
            cache_t[:, start:start + first] = new[:, :first]
            cache_t[:, :tail - first] = new[:, first:]
    return out, {"k": k_cache, "v": v_cache, "length": length + S}


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
        "w_gate": dense_init(gen, (count, d, f), dt, device),
        "w_up": dense_init(gen, (count, d, f), dt, device),
        "w_down": dense_init(gen, (count, f, d), dt, device),
    }


def ffn_forward(cfg, p: Params, x):
    cdt = getattr(torch, cfg.compute_dtype)
    g = F.silu(x @ p["w_gate"].to(cdt))
    u = x @ p["w_up"].to(cdt)
    return (g * u) @ p["w_down"].to(cdt)
