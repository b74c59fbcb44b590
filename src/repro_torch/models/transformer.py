"""Unified decoder: config-driven block stacks.

A :class:`~repro_torch.configs.base.LayerGroup` describes a super-block
pattern (e.g. recurrentgemma's (rglru, rglru, attn_local)) and how many
times it repeats.  Parameters keep the JAX reference's pytree layout
(``repro.models.transformer``): every weight of a group is stacked over
its ``count`` axis, and the reference's ``lax.scan`` over that axis
becomes a Python loop over the super-blocks, each running its pattern's
sub-layers in order.  Ported mixers: ``attn``, ``attn_local`` (ring
cache) and ``rglru``; FFNs: ``dense``, ``moe`` and ``none``.  MLA, the
xLSTM cells, the stub frontends and M-RoPE raise
``NotImplementedError`` naming the slice that ports them.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import LayerGroup, ModelConfig
from . import layers as L
from . import moe as M
from . import recurrent as R

Params = dict[str, Any]

#: weights the reference casts to the compute dtype at their use
#: (``x @ W.astype(cdt)``; the conv taps and bias likewise) and the
#: embedding table: the leaves :func:`cast_params` casts.  The RG-LRU
#: gates ``w_a``/``w_i``, ``lam`` and the MoE ``router`` stay as they are:
#: the reference reads them in f32
_MATMUL_LEAVES = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo",
                            "w_gate", "w_up", "w_down", "w_x", "w_out",
                            "conv_w", "conv_b"})

_MIXERS = ("attn", "attn_local", "rglru")
_FFNS = ("dense", "moe", "none")
_LATER = {
    "mla": "the MLA slice, with deepseek-v2",
    "mlstm": "the xLSTM slice",
    "slstm": "the xLSTM slice",
}


def _check_ported(cfg: ModelConfig) -> None:
    for g in cfg.groups:
        for i, mixer in enumerate(g.pattern):
            for part, ported in ((mixer, _MIXERS), (g.ffn_of(i), _FFNS)):
                if part not in ported:
                    raise NotImplementedError(
                        f"{cfg.arch_id}: {part!r} blocks are not ported yet "
                        f"({_LATER.get(part, 'a later slice')})")
    if cfg.frontend != "none" or cfg.m_rope_sections:
        raise NotImplementedError(
            f"{cfg.arch_id}: stub frontends and M-RoPE are not ported yet")


def _device(device) -> torch.device:
    """An explicit device, or CUDA; never a silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=torch.device('cpu') "
                           "to run on the CPU")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_mixer(cfg, mixer: str, gen, device, count: int) -> Params:
    if mixer in ("attn", "attn_local"):
        return L.init_attn(cfg, gen, device, count,
                           local=(mixer == "attn_local"))
    if mixer == "rglru":
        return R.init_rglru_block(cfg, gen, device, count)
    raise ValueError(mixer)


def _init_ffn(cfg, ffn: str, gen, device, count: int) -> Params:
    if ffn == "dense":
        return L.init_ffn(cfg, gen, device, count)
    if ffn == "moe":
        return M.init_moe(cfg, gen, device, count)
    return {}


def init_params(cfg: ModelConfig, gen: torch.Generator | None = None,
                device=None) -> Params:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (default:
    CUDA), drawn from ``gen`` (a ``torch.Generator`` on that device;
    default: one seeded with 0).  Same layout as the reference (``norm2``
    and ``ffn`` only where the sub-layer has an FFN); the numbers differ
    from ``jax.random``'s — carry the reference's over with
    :func:`repro_torch.models.convert.params_from_numpy`."""
    _check_ported(cfg)
    device = _device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    params: Params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, d), dt, device,
                              scale=0.02),
        "final_norm": torch.zeros((d,), dtype=dt, device=device),
        "groups": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), dt, device)
    for g in cfg.groups:
        stacked = {}
        for i, mixer in enumerate(g.pattern):
            sub = {
                "norm1": torch.zeros((g.count, d), dtype=dt, device=device),
                "mixer": _init_mixer(cfg, mixer, gen, device, g.count),
            }
            if g.ffn_of(i) != "none":
                sub["norm2"] = torch.zeros((g.count, d), dtype=dt,
                                           device=device)
                sub["ffn"] = _init_ffn(cfg, g.ffn_of(i), gen, device,
                                       g.count)
            stacked[f"sub{i}"] = sub
        params["groups"].append(stacked)
    return params


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """The parameters with every matmul weight and the embedding table
    cast once to ``cfg.compute_dtype``; norm scales keep their dtype.

    The reference casts each weight at its use (``x @ w.astype(cdt)``);
    the cast is deterministic, so casting once here gives the same
    numbers without re-reading the f32 weights every step."""
    cdt = getattr(torch, cfg.compute_dtype)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return tree.to(cdt) if key in _MATMUL_LEAVES else tree

    return walk(params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def _init_block_cache(cfg, mixer: str, batch: int, max_len: int, dtype,
                      device, count: int) -> Params:
    if mixer == "attn":
        return L.init_attn_cache(cfg, batch, max_len, dtype, device, count)
    if mixer == "attn_local":
        w = min(max_len, cfg.rec.local_window)
        return L.init_attn_cache(cfg, batch, w, dtype, device, count)
    if mixer == "rglru":
        return R.init_rglru_state(cfg, batch, dtype, device, count)
    raise ValueError(mixer)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> list:
    """Decode caches mirroring the group structure, stacked over each
    group's ``count``: per attention sub-layer ``k``/``v`` and a host-int
    ``length`` (a local-attention layer holds a ring of min(max_len,
    local_window) rows), per RG-LRU sub-layer its ``conv`` tail and f32
    carry ``h``."""
    _check_ported(cfg)
    device = _device(device)
    return [{f"sub{i}": _init_block_cache(cfg, mixer, batch, max_len, dtype,
                                          device, g.count)
             for i, mixer in enumerate(g.pattern)}
            for g in cfg.groups]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _layer(tree, layer: int):
    """One layer's slice of a tree stacked over ``count`` (views; a host
    int such as a cache's ``length`` is shared by every layer)."""
    if isinstance(tree, dict):
        return {k: _layer(v, layer) for k, v in tree.items()}
    return tree[layer] if isinstance(tree, torch.Tensor) else tree


def _block_forward(cfg, mixer: str, ffn: str, p: Params, x, positions,
                   cache, valid_lens):
    """Pre-norm residual block: x + mixer(norm(x)); x + ffn(norm(x)).
    ``cache`` holds one layer's views of the stacked cache: attention
    writes its k/v rows into them, and the RG-LRU state is copied back."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer == "rglru":
        h, state = R.rglru_forward(cfg, p["mixer"], h, cache)
        if cache is not None:
            cache["conv"].copy_(state["conv"])
            cache["h"].copy_(state["h"])
    else:
        vl = None if cache is None else valid_lens.get(cache["k"].shape[1])
        h, _ = L.attn_forward(cfg, p["mixer"], h, positions, cache,
                              local=(mixer == "attn_local"), valid_len=vl)
    x = x + h
    if ffn == "dense":
        x = x + L.ffn_forward(cfg, p["ffn"],
                              L.rms_norm(x, p["norm2"], cfg.norm_eps))
    elif ffn == "moe":
        h, _ = M.moe_forward(cfg, p["ffn"],
                             L.rms_norm(x, p["norm2"], cfg.norm_eps))
        x = x + h
    return x


def _run_group(cfg, g: LayerGroup, gp: Params, x, positions, gcache,
               valid_lens):
    """Loop over the group's super-blocks, each running the pattern's
    sub-layers in order (the reference's scan body).  gcache: the group's
    cache dict or None; returns (x, new_gcache)."""
    for layer in range(g.count):
        for i, mixer in enumerate(g.pattern):
            key = f"sub{i}"
            c = None if gcache is None else _layer(gcache[key], layer)
            x = _block_forward(cfg, mixer, g.ffn_of(i), _layer(gp[key], layer),
                               x, positions, c, valid_lens)
    if gcache is None:
        return x, None
    new_cache = {}
    for key, c in gcache.items():
        new_cache[key] = dict(c)
        if "length" in c:
            new_cache[key]["length"] = c["length"] + x.shape[1]
    return x, new_cache


def _decode_masks(caches, offset: int, batch: int, device) -> dict:
    """The decode step's ``valid_len`` per attention cache size W, made
    once per step: ``min(offset + 1, W)`` (a global cache has W = max_len
    > offset; a ring holds at most its W rows)."""
    masks = {}
    for gc in caches:
        for sub in gc.values():
            if "k" in sub:
                W = sub["k"].shape[2]
                if W not in masks:
                    masks[W] = torch.full((batch,), min(offset + 1, W),
                                          dtype=torch.int32, device=device)
    return masks


def forward(cfg: ModelConfig, params: Params, tokens, *, caches=None,
            logits_slice: bool = False):
    """Run the decoder.

    tokens: (B, S) int ids.  caches: from :func:`init_cache` (inference;
    updated in place) or None.  logits_slice: return logits for the LAST
    position only (decode).

    Returns (logits, new_caches).
    """
    _check_ported(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt)
    B, S, _ = x.shape
    offset = _cache_length(caches) if caches is not None else 0
    positions = (offset + torch.arange(S, device=x.device))[None].expand(B, S)
    valid_lens = (_decode_masks(caches, offset, B, x.device)
                  if caches is not None and S == 1 else {})
    new_caches = [] if caches is not None else None
    for gi, g in enumerate(cfg.groups):
        gcache = caches[gi] if caches is not None else None
        x, nc = _run_group(cfg, g, params["groups"][gi], x, positions,
                           gcache, valid_lens)
        if caches is not None:
            new_caches.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_slice:
        x = x[:, -1:]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(cdt)).float()
    return logits, new_caches


def _cache_length(caches) -> int:
    """The host-int cache length: every attention sub-cache carries the
    same; RG-LRU states carry none (a stack without attention counts 0,
    as the reference's)."""
    for gc in caches:
        for sub in gc.values():
            if "length" in sub:
                return sub["length"]
    return 0


def prefill(cfg: ModelConfig, params: Params, tokens, caches):
    """Prefill: run the prompt through, filling caches; returns last-token
    logits + updated caches."""
    logits, new_caches = forward(cfg, params, tokens, caches=caches,
                                 logits_slice=True)
    return logits[:, 0], new_caches


def decode_step(cfg: ModelConfig, params: Params, token, caches):
    """One decode step.  token: (B,) int → logits (B, V), new caches."""
    logits, new_caches = forward(cfg, params, token[:, None], caches=caches,
                                 logits_slice=True)
    return logits[:, 0], new_caches
