"""Shared model layers: norms, RoPE / M-RoPE, GQA attention (global, and
local over a ring-buffer cache), MLA (multi-head latent attention),
SwiGLU.

Attention calls the hand-written kernels (``repro_torch.kernels``):
flash attention for a prompt, decode attention for one token against a
cache.  On a CPU tensor those wrappers compute their plain PyTorch
versions.  Weights are ``(in, out)`` and applied as ``x @ W``, as in the
JAX reference (``repro.models.layers``).  The reference's sharding hints
stand at its sites (``distributed.context.constrain``: the identity on
a plain tensor and outside a rule context), and a decode step against a
cache sharded over a model axis of more than one rank goes through
``distributed.flash_decode`` under the reference's condition
(``decode_shard_info``); on one rank neither changes what runs.  The
reference's ``flash_blocks`` hints constrain its chunked attention's
block reshapes, which the kernels here do internally.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import as_mla
from ..distributed.context import (constrain, decode_shard_info,
                                   decode_tp_active, merge_heads,
                                   split_heads, write_row)
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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scaling of a context extended by ``factor``:
    0.1·mscale·ln(factor) + 1, and 1 where ``factor`` <= 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(dim: int, theta: float, beta_fast: float,
                          beta_slow: float, original_max: int
                          ) -> tuple[int, int]:
    """(low, high): the frequency pairs between which YaRN blends from
    extrapolation to interpolation, where a pair turns ``beta_fast`` and
    ``beta_slow`` times over ``original_max`` positions (floor and ceil,
    clamped to [0, dim - 1]; DeepSeek-V2's ``yarn_find_correction_range``)."""
    def pair(rotations: float) -> float:
        return (dim * math.log(original_max / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(pair(beta_fast)), 0),
            min(math.ceil(pair(beta_slow)), dim - 1))


def yarn_freqs(m, dim: int, theta: float, device=None) -> torch.Tensor:
    """The (dim/2,) inverse frequencies of YaRN for MLA config ``m``:
    f_interp·(1 − mask) + f_extra·mask, f_extra the plain RoPE frequencies,
    f_interp = f_extra / factor, mask = 1 − clamp((i − low) / (high − low),
    0, 1) over the correction range."""
    low, high = yarn_correction_range(dim, theta, m.yarn_beta_fast,
                                      m.yarn_beta_slow, m.yarn_original_max)
    if low == high:
        high += 0.001                 # the published guard
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    interp = 1.0 / (m.yarn_factor * theta ** exps)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return interp * (1.0 - mask) + extra * mask


def _rotate(x: torch.Tensor, angles: torch.Tensor,
            mscale: float = 1.0) -> torch.Tensor:
    """``x`` (B, S, H, D) turned by ``angles`` (B, S, D/2), split halves;
    cos and sin scaled by ``mscale`` where it is not 1."""
    cos = torch.cos(angles)[..., None, :]                       # (B,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               m_rope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, D) by ``positions``: split-half rotation
    (the two halves of the head dim pair up), not interleaved.

    ``positions``: (B, S) for RoPE, or (3, B, S) for M-RoPE (Qwen2-VL),
    where the D/2 frequency pairs fall into ``m_rope_sections`` (t, h, w)
    and each section turns by its own coordinate.  (3, B, S) positions on
    the 1-D path take the first coordinate, as the reference's."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                     # (D/2,)
    if m_rope_sections:
        if positions.dim() != 3 or sum(m_rope_sections) != D // 2:
            raise ValueError(f"M-RoPE needs (3, B, S) positions and "
                             f"sections summing to {D // 2}; got "
                             f"{tuple(positions.shape)}, {m_rope_sections}")
        # each section's pairs by its coordinate: slices, no index tensor,
        # so a captured decode step copies nothing from the host
        parts, off = [], 0
        for coord, n in enumerate(m_rope_sections):
            parts.append(positions[coord][..., None].float()
                         * freqs[off:off + n])
            off += n
        angles = torch.cat(parts, dim=-1)                       # (B,S,D/2)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        angles = positions[..., None].float() * freqs           # (B,S,D/2)
    return _rotate(x, angles)


def mla_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """MLA's rope part ``x`` (B, S, H, D) turned by ``positions`` (B, S):
    :func:`apply_rope`, or YaRN where ``cfg.mla.yarn_factor`` > 1 (split
    halves either way)."""
    m = as_mla(cfg.mla)
    if m.yarn_factor <= 1:
        return apply_rope(x, positions, cfg.rope_theta)
    if positions.dim() == 3:
        positions = positions[0]
    freqs = yarn_freqs(m, x.shape[-1], cfg.rope_theta, x.device)
    mscale = (yarn_mscale(m.yarn_factor, m.yarn_mscale)
              / yarn_mscale(m.yarn_factor, m.yarn_mscale_all_dim))
    return _rotate(x, positions[..., None].float() * freqs, mscale)


def mla_softmax_scale(m) -> float:
    """MLA's softmax scale: 1/sqrt(nope + rope), times
    mscale(factor, ``yarn_mscale_all_dim``)² under YaRN where that is
    set (DeepSeek-V2's)."""
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    if m.yarn_factor > 1 and m.yarn_mscale_all_dim:
        scale *= yarn_mscale(m.yarn_factor, m.yarn_mscale_all_dim) ** 2
    return scale


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attention(q, k, v, *, causal: bool = True,
              q_offset: int | torch.Tensor = 0,
              window: int | None = None, scale: float | None = None,
              valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention.  q: (B, Sq, H, D); k: (B, Sk, K, D); v:
    (B, Sk, K, Dv).  ``q_offset``: the position of q's first row among
    the keys (a prompt that continues a cache: its length), an int or a
    (1,) int64 device tensor.

    One query token (decode) goes to the decode-attention kernel: rows
    below ``valid_len`` are attended (default 1: a lone token without a
    cache sees itself).  A prompt goes to the flash-attention kernel
    (causal q_offset + i >= j, optional ``window``); under autograd, at
    q_offset 0 only, through its Function, whose backward is the flash
    backward kernel (the reference's custom VJP).  Windowed decode on a
    cache that is not a ring is not ported yet.
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
                           scale=scale, q_offset=q_offset)


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
                 local: bool = False, step=None, valid=None):
    """x: (B, S, d).  cache: dict(k, v, length) of one layer, or None.

    Returns (out, new_cache).  KV cache layout: (B, S_max, K, hd); the
    new k/v rows are written into the cache tensors IN PLACE (no copy of
    the cache per token), and ``length`` is a host int counting every
    token seen.  A decode step (S = 1 with a cache) takes ``step``, its
    cache row, ``valid_len`` and position as device tensors made once per
    step (``transformer._decode_steps``), so it reads no host scalar.  A
    prompt writes rows [length, length + S) and attends to the cache's
    rows [0, length + S) in place at q offset ``length`` (at length > 0,
    chunked prefill: the reference's ``dynamic_update_slice`` and
    ``attention(q_offset=length)``).  A prompt given ``step`` (a chunk of
    the ladder prefill, ``transformer._prompt_steps``: its rows and first
    position as device tensors) writes those rows with ``index_copy_`` and
    attends to the cache's whole rows at the device q offset, so it reads
    no host scalar either: the causal mask hides the rows past the chunk.
    ``local``: sliding-window attention over ``cfg.rec.local_window``;
    its cache of W <= window rows is a ring holding the last W tokens
    (post-RoPE keys, so the rotation survives the wrap), as the
    reference's (``layers.py`` ring branch).  A ring takes a prompt at
    length 0 only: the reference's ring prefill assumes it ("length
    assumed 0") and would drop the tokens already in the ring.
    ``valid``: a prompt at length 0 padded at its tail, its true length
    as a (1,) int64 device tensor: the causal mask keeps every real row
    exact, the pad rows land past the real ones, and a ring takes the
    last real rows (:func:`_ring_fill`).
    """
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    cdt = getattr(torch, cfg.compute_dtype)
    dtp = decode_tp_active() and S == 1
    if dtp:
        # weight-stationary 2D-TP decode: d contracted over the data
        # axis, q/k/v brought to batch-sharded full heads
        x = constrain(x, "dtp_features")
        kind = "batch_only"
    else:
        kind = "heads"                 # projections emit head-sharded
    q = constrain(split_heads(x @ p["wq"].to(cdt), H, hd), kind)
    k = constrain(split_heads(x @ p["wk"].to(cdt), K, hd), kind)
    v = constrain(split_heads(x @ p["wv"].to(cdt), K, hd), kind)
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
        info = decode_shard_info(B, k_cache.shape[1]) \
            if S == 1 and not local else None
        if info is not None:
            # flash-decode over the sequence-sharded cache: a local
            # one-row update at the position and a partial-softmax
            # combine (KB-scale collectives)
            from ..distributed.flash_decode import flash_decode_update
            mesh, baxes, maxis = info
            out, _, _ = flash_decode_update(
                q, k, v, k_cache, v_cache, step[2], mesh=mesh, baxes=baxes,
                maxis=maxis)
        elif S == 1:
            # decode: write row pos % W, attend to the valid rows, read
            # from the cache as the reference reads it (in the compute
            # dtype); a ring holds exactly the past window, so validity
            # is the whole mask
            row, valid_len = step[:2]
            write_row(k_cache, row, k)
            write_row(v_cache, row, v)
            out = attention(q, k_cache.to(cdt), v_cache.to(cdt),
                            valid_len=valid_len)
        elif step is not None:
            # a chunk at a device offset: rows start .. start + S - 1,
            # which the ladder's plan checked fit the cache
            rows, _, start = step
            write_row(k_cache, rows, k)
            write_row(v_cache, rows, v)
            out = attention(q, k_cache.to(cdt), v_cache.to(cdt),
                            q_offset=start)
        elif local:
            if length != 0:
                raise NotImplementedError(
                    "a prompt at a cache offset on a local-attention ring: "
                    "the reference's ring prefill assumes length 0 and "
                    "drops the ring's earlier tokens; see ROADMAP.md")
            out = attention(q, k, v, causal=True, window=window)
            _ring_fill(k_cache, v_cache, k, v, valid)
        else:
            end = _prompt_rows(k_cache, length, S)
            k_cache[:, length:end] = k.to(k_cache.dtype)
            v_cache[:, length:end] = v.to(v_cache.dtype)
            # the prompt attends to the cache's rows up to its own last,
            # read back as the reference reads them, in place (a view
            # whose batch stride is the cache's)
            out = attention(q, k_cache[:, :end].to(cdt),
                            v_cache[:, :end].to(cdt), q_offset=length)
        new_cache = {"k": k_cache, "v": v_cache, "length": length + S}
    # H·hd contracts over the model axis: wo stays put
    out = constrain(out.reshape(B, S, H, hd), "heads")
    out = merge_heads(out) @ p["wo"].to(cdt)
    if dtp:
        out = constrain(out, "dtp_features")
    return out, new_cache


def _prompt_rows(cache_t, length: int, S: int) -> int:
    """The end row of a prompt of ``S`` tokens written at ``length`` into
    a cache of ``cache_t.shape[1]`` rows; raises if it does not fit (the
    reference's ``dynamic_update_slice`` would clamp the start)."""
    end = length + S
    if end > cache_t.shape[1]:
        raise ValueError(f"a prompt of {S} tokens at cache length {length} "
                         f"does not fit a cache of {cache_t.shape[1]} rows")
    return end


def _ring_fill(k_cache, v_cache, k, v, valid=None) -> None:
    """A fresh prefill's last min(S, W) k/v rows into a ring of W rows, at
    their slots ``(S - tail .. S - 1) % W``: a rotation done as two
    slices.

    ``valid``: the rows are padded past their first ``valid`` (a (1,)
    int64 device tensor).  Where S <= W the rotation above is right: the
    pad rows land past the real ones, where decode masks them and then
    writes over them.  Where S > W, slot s takes the last real row p <
    valid with p = s (mod W), one gather of W rows (a slot no real row
    reaches, s >= valid, takes its own row s, masked as above)."""
    S, W = k.shape[1], k_cache.shape[1]
    if valid is not None and S > W:
        s = torch.arange(W, device=k.device)
        rows = valid - 1 - torch.remainder(valid - 1 - s, W)
        rows = torch.where(rows < 0, s, rows)
        for cache_t, new in ((k_cache, k), (v_cache, v)):
            cache_t.copy_(new.index_select(1, rows))
        return
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
# MLA: multi-head latent attention (DeepSeek-V2 §2.1)
# ---------------------------------------------------------------------------
def init_mla(cfg, gen: torch.Generator, device, count: int = 1) -> Params:
    """MLA weights stacked over ``count`` layers, with the reference's
    keys: the kv down-projection ``w_dkv`` and shared rope key
    ``w_krope``, the up-projections ``w_uk``/``w_uv``, ``wo``, and q
    through ``w_dq``/``w_uq`` (q_lora_rank > 0) or ``wq``; with
    ``latent_norms`` the latents' RMSNorm scales ``kv_norm`` and (with a
    q latent) ``q_norm``, zeros as every norm's."""
    m = as_mla(cfg.mla)
    d, H = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    dt = getattr(torch, cfg.param_dtype)

    def w(shape):
        return dense_init(gen, shape, dt, device, count=count)

    p = {
        "w_dkv": w((d, m.kv_lora_rank)),
        "w_krope": w((d, m.qk_rope_dim)),
        "w_uk": w((m.kv_lora_rank, H * m.qk_nope_dim)),
        "w_uv": w((m.kv_lora_rank, H * m.v_head_dim)),
        "wo": w((H * m.v_head_dim, d)),
    }
    if m.q_lora_rank:
        p["w_dq"] = w((d, m.q_lora_rank))
        p["w_uq"] = w((m.q_lora_rank, H * qd))
    else:
        p["wq"] = w((d, H * qd))
    if m.latent_norms:
        p["kv_norm"] = torch.zeros((count, m.kv_lora_rank), dtype=dt,
                                   device=device)
        if m.q_lora_rank:
            p["q_norm"] = torch.zeros((count, m.q_lora_rank), dtype=dt,
                                      device=device)
    return p


def mla_forward(cfg, p: Params, x, positions, cache=None, *, step=None):
    """Latent-KV attention.  x: (B, S, d).  cache: dict(c_kv, k_rope,
    length) of one layer, or None.  Returns (out, new_cache).

    The cache holds the latent ``c_kv`` (rank per token) and the shared
    rope key ``k_rope``, written IN PLACE as in :func:`attn_forward`.
    Keys and values are up-projected from the latent rows on every call,
    as the reference does: a prompt at cache length L reads back rows
    [0, L + S) (in the cache dtype) and attends at q offset L (L > 0:
    chunked prefill), and a decode step (which takes ``step``, its cache row
    and ``valid_len`` as device tensors) writes row ``pos`` and
    up-projects all max_len rows, so its shapes are static and the
    kernel masks the rows past ``valid_len``.  q/k heads are nope + rope
    wide (192 on deepseek-v2) and v heads ``v_head_dim`` (128): the
    kernels take Dv != D.  With ``latent_norms`` the q latent and the kv
    latent pass through their RMSNorms (the cache holds the normed kv
    latent; the rope key is not normed); the rope part turns by
    :func:`mla_rope` and the softmax takes :func:`mla_softmax_scale`."""
    m = as_mla(cfg.mla)
    B, S, _ = x.shape
    H = cfg.n_heads
    cdt = getattr(torch, cfg.compute_dtype)
    if m.q_lora_rank:
        q = x @ p["w_dq"].to(cdt)
        if m.latent_norms:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        q = q @ p["w_uq"].to(cdt)
    else:
        q = x @ p["wq"].to(cdt)
    q = split_heads(q, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = mla_rope(cfg, q_rope, positions)
    c_kv = x @ p["w_dkv"].to(cdt)                                # (B,S,rank)
    if m.latent_norms:
        c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = mla_rope(cfg, (x @ p["w_krope"].to(cdt))[:, :, None, :],
                      positions)[:, :, 0]                       # (B,S,rope)
    valid_len = new_cache = None
    q_offset = 0
    if cache is None:
        c_all, kr_all = c_kv, k_rope
    else:
        length = cache["length"]
        c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
        if S == 1:
            row, valid_len = step[:2]
            write_row(c_cache, row, c_kv)
            write_row(kr_cache, row, k_rope)
            c_all, kr_all = c_cache.to(cdt), kr_cache.to(cdt)
        else:
            end = _prompt_rows(c_cache, length, S)
            c_cache[:, length:end] = c_kv.to(c_cache.dtype)
            kr_cache[:, length:end] = k_rope.to(kr_cache.dtype)
            c_all = c_cache[:, :end].to(cdt)
            kr_all = kr_cache[:, :end].to(cdt)
            q_offset = length
        new_cache = {"c_kv": c_cache, "k_rope": kr_cache, "length": length + S}
    # a cache is sharded over its rows: its products take them gathered
    c_all, kr_all = constrain(c_all, "batch_only"), constrain(kr_all,
                                                               "batch_only")
    L = c_all.shape[1]
    k_nope = constrain(split_heads(c_all @ p["w_uk"].to(cdt), H,
                                   m.qk_nope_dim), "heads")
    v = constrain(split_heads(c_all @ p["w_uv"].to(cdt), H, m.v_head_dim),
                  "heads")
    k = torch.cat([k_nope, kr_all[:, :, None, :].expand(
        B, L, H, kr_all.shape[-1])], dim=-1)
    k = constrain(k, "heads")
    q = constrain(torch.cat([q_nope, q_rope], dim=-1), "heads")
    out = attention(q, k, v, causal=True, q_offset=q_offset,
                    scale=mla_softmax_scale(m), valid_len=valid_len)
    out = constrain(out, "heads")
    out = merge_heads(out) @ p["wo"].to(cdt)
    return out, new_cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device,
                   count: int = 1) -> Params:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((count, batch, max_len, m.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros((count, batch, max_len, m.qk_rope_dim),
                              dtype=dtype, device=device),
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
    if decode_tp_active() and x.shape[-2] == 1:
        # weight-stationary 2D-TP decode: d over the data axis, f over
        # the model axis, so the 2D-sharded weights never move
        x = constrain(x, "dtp_features")
        g = F.silu(constrain(x @ p["w_gate"].to(cdt), "dtp_hidden"))
        u = constrain(x @ p["w_up"].to(cdt), "dtp_hidden")
        return constrain((g * u) @ p["w_down"].to(cdt), "dtp_features")
    g = F.silu(constrain(x @ p["w_gate"].to(cdt), "ffn_hidden"))
    u = constrain(x @ p["w_up"].to(cdt), "ffn_hidden")
    return (g * u) @ p["w_down"].to(cdt)
