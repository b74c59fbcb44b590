"""Unified decoder: config-driven block stacks.

A :class:`~repro_torch.configs.base.LayerGroup` describes a super-block
pattern and how many times it repeats.  Parameters keep the JAX
reference's pytree layout (``repro.models.transformer``): every weight of
a group is stacked over its ``count`` axis, and the reference's
``lax.scan`` over that axis becomes a Python loop.  This slice ports
groups of mixer ``attn`` with a ``dense`` FFN (phi3-mini, mistral-large,
deepseek-coder, minicpm); the other mixers, FFNs and frontends
raise ``NotImplementedError`` naming the slice that ports them.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import LayerGroup, ModelConfig
from . import layers as L

Params = dict[str, Any]

#: weights applied as ``x @ W`` (and the embedding table): the leaves
#: :func:`cast_params` casts to the compute dtype
_MATMUL_LEAVES = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo",
                            "w_gate", "w_up", "w_down"})

_LATER = {
    "attn_local": "recurrent-family slice",
    "rglru": "recurrent-family slice",
    "mla": "MoE-family slice",
    "mlstm": "recurrent-family slice",
    "slstm": "recurrent-family slice",
    "moe": "MoE-family slice",
}


def _check_ported(cfg: ModelConfig) -> None:
    for g in cfg.groups:
        for i, mixer in enumerate(g.pattern):
            for part, ported in ((mixer, "attn"), (g.ffn_of(i), "dense")):
                if part != ported:
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
def init_params(cfg: ModelConfig, gen: torch.Generator | None = None,
                device=None) -> Params:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (default:
    CUDA), drawn from ``gen`` (a ``torch.Generator`` on that device;
    default: one seeded with 0).  Same layout as the reference; the
    numbers differ from ``jax.random``'s — carry the reference's over
    with :func:`repro_torch.models.convert.params_from_numpy`."""
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
        for i in range(len(g.pattern)):
            stacked[f"sub{i}"] = {
                "norm1": torch.zeros((g.count, d), dtype=dt, device=device),
                "mixer": L.init_attn(cfg, gen, device, g.count),
                "norm2": torch.zeros((g.count, d), dtype=dt, device=device),
                "ffn": L.init_ffn(cfg, gen, device, g.count),
            }
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
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> list:
    """Decode caches mirroring the group structure: per sub-layer a dict
    of ``k``/``v`` stacked over the group's ``count`` and a host-int
    ``length``."""
    _check_ported(cfg)
    device = _device(device)
    return [{f"sub{i}": L.init_attn_cache(cfg, batch, max_len, dtype, device,
                                          g.count)
             for i in range(len(g.pattern))}
            for g in cfg.groups]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _run_group(cfg, g: LayerGroup, gp: Params, x, positions, gcache,
               valid_len):
    """Loop over the group's stacked layers.  gcache: the group's cache
    dict or None; returns (x, new_gcache)."""
    new_cache = None if gcache is None else {}
    for i in range(len(g.pattern)):
        key = f"sub{i}"
        lp = gp[key]
        c = gcache[key] if gcache is not None else None
        for layer in range(g.count):
            lc = (None if c is None else
                  {"k": c["k"][layer], "v": c["v"][layer],
                   "length": c["length"]})
            h, _ = L.attn_forward(
                cfg, {n: w[layer] for n, w in lp["mixer"].items()},
                L.rms_norm(x, lp["norm1"][layer], cfg.norm_eps),
                positions, lc, valid_len=valid_len)
            x = x + h
            h = L.ffn_forward(
                cfg, {n: w[layer] for n, w in lp["ffn"].items()},
                L.rms_norm(x, lp["norm2"][layer], cfg.norm_eps))
            x = x + h
        if c is not None:
            new_cache[key] = {"k": c["k"], "v": c["v"],
                              "length": c["length"] + x.shape[1]}
    return x, new_cache


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
    # the decode mask (rows 0..offset), made once for every layer
    valid_len = (torch.full((B,), offset + 1, dtype=torch.int32,
                            device=x.device)
                 if caches is not None and S == 1 else None)
    new_caches = [] if caches is not None else None
    for gi, g in enumerate(cfg.groups):
        gcache = caches[gi] if caches is not None else None
        x, nc = _run_group(cfg, g, params["groups"][gi], x, positions,
                           gcache, valid_len)
        if caches is not None:
            new_caches.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_slice:
        x = x[:, -1:]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(cdt)).float()
    return logits, new_caches


def _cache_length(caches) -> int:
    """The host-int cache length (every sub-cache carries the same)."""
    for gc in caches:
        for sub in gc.values():
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
