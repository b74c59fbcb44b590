"""Unified decoder: config-driven block stacks.

A :class:`~repro_torch.configs.base.LayerGroup` describes a super-block
pattern (e.g. recurrentgemma's (rglru, rglru, attn_local)) and how many
times it repeats.  Parameters keep the JAX reference's pytree layout
(``repro.models.transformer``): every weight of a group is stacked over
its ``count`` axis, and the reference's ``lax.scan`` over that axis
becomes a Python loop over the super-blocks, each running its pattern's
sub-layers in order.  Mixers: ``attn`` (with M-RoPE where the config
names sections), ``attn_local`` (ring cache), ``mla`` (latent cache),
``rglru``, ``mlstm`` and ``slstm``; FFNs: ``dense``, ``moe`` and
``none``.  A stub frontend's embeddings (``models.frontends``) go in as
``forward(extra_embeds=...)``.

Training runs :func:`forward` without caches, for every mixer and FFN,
under a rematerialisation policy (the reference's ``jax.checkpoint``
around its scan body):
``"full"`` recomputes each super-block in the backward
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the
outputs of the plain matrix products (``aten.mm``; no batched ones, as
the reference's ``checkpoint_dots_with_no_batch_dims``) and recomputes
the rest, ``"none"`` keeps everything.  A recomputed block launches its
forward kernels again.  :func:`loss_fn` is the reference's next-token
cross entropy plus the MoE aux.

A prompt given caches at length L > 0 continues them (chunked prefill):
its positions start at L, attention writes rows [L, L + S) and attends
at q offset L, recurrent states carry on.  A decode step takes its
cache position as a device tensor (``pos``):
every cache row it writes, its attention mask and its RoPE positions
are computed from it on the device, so the step holds no host scalar
and can be captured in a CUDA graph and replayed
(``repro_torch.serving.graphs``).  So does a prompt chunk given ``pos``
(its first cache position), in the families :func:`takes_ladder` names:
the ladder prefill's chunks, one graph per chunk size serving every
offset.  In the families :func:`takes_buckets` names, a prompt on fresh
caches padded at its tail runs in one pass given its true length as a
device tensor (``valid``) and, with MoE, that length's capacity: the
bucketed prefill, one graph per padded length.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import LayerGroup, ModelConfig
from ..distributed.context import constrain, decode_tp_active
from . import layers as L
from . import moe as M
from . import recurrent as R
from . import xlstm as X

Params = dict[str, Any]

#: weights the reference casts to the compute dtype at their use
#: (``x @ W.astype(cdt)``; the conv taps and bias likewise; MLA's down-
#: and up-projections) and the embedding table: the leaves
#: :func:`cast_params` casts.  The RG-LRU gates ``w_a``/``w_i``, ``lam``,
#: the MoE ``router``, the mLSTM gates ``w_i``/``w_f``, the sLSTM
#: recurrence ``r`` and the f32 biases stay as they are: the reference
#: reads them in f32
_MATMUL_LEAVES = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo",
                            "w_gate", "w_up", "w_down", "w_x", "w_out",
                            "conv_w", "conv_b", "w_q", "w_k", "w_v",
                            "w_in", "w_dq", "w_uq", "w_dkv", "w_krope",
                            "w_uk", "w_uv"})

#: the recurrent mixers: forward(cfg, p, x, state) -> (out, new state)
_RECURRENT = {"rglru": R.rglru_forward, "mlstm": X.mlstm_forward,
              "slstm": X.slstm_forward}
#: what :func:`init_cache` fills a state with where it is not zero
_STATE_FILLS = {"mlstm": {"m": float("-inf")}, "slstm": {"n": 1.0}}


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
    if mixer == "mla":
        return L.init_mla(cfg, gen, device, count)
    if mixer == "rglru":
        return R.init_rglru_block(cfg, gen, device, count)
    if mixer == "mlstm":
        return X.init_mlstm_block(cfg, gen, device, count)
    if mixer == "slstm":
        return X.init_slstm_block(cfg, gen, device, count)
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
    :func:`repro_torch.models.convert.params_from_numpy`.  On the
    ``meta`` device nothing is drawn or allocated: shapes and dtypes
    only (:func:`param_specs`)."""
    device = _device(device)
    if gen is None and device.type != "meta":
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


def param_specs(cfg: ModelConfig) -> Params:
    """Shape/dtype skeleton of the params: meta tensors, nothing drawn or
    allocated (the reference's ``jax.eval_shape`` of its init; the
    dry-run's and the sharding rules' input)."""
    return init_params(cfg, device="meta")


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
    if mixer == "mla":
        return L.init_mla_cache(cfg, batch, max_len, dtype, device, count)
    if mixer == "rglru":
        return R.init_rglru_state(cfg, batch, dtype, device, count)
    if mixer == "mlstm":
        return X.init_mlstm_state(cfg, batch, device, count)
    if mixer == "slstm":
        return X.init_slstm_state(cfg, batch, device, count)
    raise ValueError(mixer)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> list:
    """Decode caches mirroring the group structure, stacked over each
    group's ``count``: per attention sub-layer ``k``/``v`` and a host-int
    ``length`` (a local-attention layer holds a ring of min(max_len,
    local_window) rows), per MLA sub-layer the latent ``c_kv``, the rope
    key ``k_rope`` and ``length``, per RG-LRU sub-layer its ``conv`` tail
    and f32 carry ``h``, per mLSTM its f32 ``C``/``n``/``m`` and per sLSTM
    its f32 ``h``/``c``/``n``/``m`` (no ``length``, as the reference's)."""
    device = _device(device)
    return [{f"sub{i}": _init_block_cache(cfg, mixer, batch, max_len, dtype,
                                          device, g.count)
             for i, mixer in enumerate(g.pattern)}
            for g in cfg.groups]


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> list:
    """Shape/dtype skeleton of :func:`init_cache`: meta tensors, nothing
    allocated.  Each sub-cache's ``length`` — a host int in a live cache
    — stands as the reference's stacked counter, an int32 meta tensor of
    shape (count,), so the skeleton (and the specs and bytes of it) is
    the reference's ``cache_specs`` leaf for leaf."""
    caches = init_cache(cfg, batch, max_len, dtype, device="meta")
    for g, gc in zip(cfg.groups, caches):
        for sub in gc.values():
            if "length" in sub:
                sub["length"] = torch.empty((g.count,), dtype=torch.int32,
                                            device="meta")
    return caches


def set_length(caches: list, length: int) -> list:
    """Set every sub-cache's host ``length`` to ``length``, IN PLACE (after
    a prompt whose true length the device held: a captured prefill, a
    padded one).  Returns them."""
    for gc in caches:
        for sub in gc.values():
            if "length" in sub:
                sub["length"] = length
    return caches


def reset_cache(cfg: ModelConfig, caches: list) -> list:
    """Set ``caches`` (from :func:`init_cache`) back to what
    :func:`init_cache` gives, IN PLACE: every tensor keeps its address,
    which a captured decode step reads.  Returns them, length 0."""
    for g, gc in zip(cfg.groups, caches):
        for i, mixer in enumerate(g.pattern):
            sub = gc[f"sub{i}"]
            fills = _STATE_FILLS.get(mixer, {})
            for key, t in sub.items():
                if key == "length":
                    sub[key] = 0
                else:
                    t.fill_(fills.get(key, 0.0))
    return caches


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _unstack(tree, count: int) -> list:
    """The ``count`` per-layer trees of a tree stacked over ``count``:
    views made by one ``unbind`` per leaf.  Under autograd its backward is
    one stack per leaf; indexing layer by layer instead would build a
    full-size gradient of the stacked leaf for every layer and add them
    up, count times the traffic."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(count)]
    return list(tree.unbind(0))


def _layer(tree, layer: int):
    """One layer's slice of a tree stacked over ``count`` (views; a host
    int such as a cache's ``length`` is shared by every layer)."""
    if isinstance(tree, dict):
        return {k: _layer(v, layer) for k, v in tree.items()}
    return tree[layer] if isinstance(tree, torch.Tensor) else tree


def _block_forward(cfg, mixer: str, ffn: str, p: Params, x, positions,
                   cache, steps, want_aux: bool, padded=None):
    """Pre-norm residual block: x + mixer(norm(x)); x + ffn(norm(x)).
    ``cache`` holds one layer's views of the stacked cache: attention
    writes its k/v rows into them, and a recurrent state is copied back.
    ``padded``: (valid, capacity) of a prompt padded at its tail
    (:func:`forward`), or None.  Returns x and the MoE load-balance aux
    (None unless ``want_aux``)."""
    valid = None if padded is None else padded[0]
    h = _projection_input(L.rms_norm(x, p["norm1"], cfg.norm_eps))
    if mixer in _RECURRENT:
        kw = {} if valid is None else {"valid": valid}
        h, state = _RECURRENT[mixer](cfg, p["mixer"], h, cache, **kw)
        if cache is not None:
            for key, t in state.items():
                cache[key].copy_(t)
    elif mixer == "mla":
        step = None if cache is None else steps.get(cache["c_kv"].shape[1])
        h, _ = L.mla_forward(cfg, p["mixer"], h, positions, cache, step=step)
    else:
        step = None if cache is None else steps.get(cache["k"].shape[1])
        h, _ = L.attn_forward(cfg, p["mixer"], h, positions, cache,
                              local=(mixer == "attn_local"), step=step,
                              valid=valid)
    # branch outputs re-enter the residual layout
    x = x + _residual(h)
    aux = None
    if ffn == "dense":
        h = L.ffn_forward(cfg, p["ffn"], _projection_input(
            L.rms_norm(x, p["norm2"], cfg.norm_eps)))
        x = x + _residual(h)
    elif ffn == "moe":
        h, aux = M.moe_forward(cfg, p["ffn"], _projection_input(
            L.rms_norm(x, p["norm2"], cfg.norm_eps)), aux=want_aux,
            valid=padded)
        x = x + _residual(h)
    return x, aux


#: the products "dots" keeps: plain 2-d matrix products (``x @ W`` folds
#: its leading dims into one ``mm``); batched ones are recomputed
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
REMAT_POLICIES = ("full", "dots", "none")


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _super_block(cfg, g: LayerGroup, lp: Params, x, positions,
                 want_aux: bool):
    """One pass of the group's pattern without caches (training): the
    reference's scan body.  Returns x and the summed MoE aux (None when
    not asked for or without MoE)."""
    total = None
    for i, mixer in enumerate(g.pattern):
        x, aux = _block_forward(cfg, mixer, g.ffn_of(i), lp[f"sub{i}"], x,
                                positions, None, {}, want_aux)
        x = _residual(x)
        if aux is not None:
            total = aux if total is None else total + aux
    return x, total


def _run_group(cfg, g: LayerGroup, gp: Params, x, positions, gcache,
               steps, auxes: list | None, remat_policy: str = "none",
               padded=None):
    """Loop over the group's super-blocks, each running the pattern's
    sub-layers in order (the reference's scan body), under
    ``remat_policy`` when there are no caches.  gcache: the group's cache
    dict or None; returns (x, new_gcache).  Each MoE aux is appended to
    ``auxes`` when it is a list.  ``padded``: as :func:`_block_forward`
    takes it."""
    layers = _unstack(gp, g.count)
    if gcache is None and remat_policy != "none":
        context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                        _keep_dots)
                      if remat_policy == "dots" else None)
        kw = {"context_fn": context_fn} if context_fn else {}
        for lp in layers:
            # the step draws no random number: no RNG state to keep, and
            # none is read inside a CUDA-graph capture
            x, aux = checkpoint(_super_block, cfg, g, lp, x,
                                positions, auxes is not None,
                                use_reentrant=False, preserve_rng_state=False,
                                **kw)
            if aux is not None:
                auxes.append(aux)
        return x, None
    for layer in range(g.count):
        for i, mixer in enumerate(g.pattern):
            key = f"sub{i}"
            c = None if gcache is None else _layer(gcache[key], layer)
            x, aux = _block_forward(cfg, mixer, g.ffn_of(i),
                                    layers[layer][key], x, positions, c,
                                    steps, auxes is not None, padded)
            x = _residual(x)
            if aux is not None:
                auxes.append(aux)
    if gcache is None:
        return x, None
    new_cache = {}
    for key, c in gcache.items():
        new_cache[key] = dict(c)
        if "length" in c:
            new_cache[key]["length"] = c["length"] + x.shape[1]
    return x, new_cache


def _residual(x):
    """``x`` (B, S, d) in the residual stream's layout: under rules, the
    batch over (pod, data) and the sequence over the model axis
    (Megatron-SP); a decode step in 2D-TP keeps it feature-sharded
    instead.  The identity outside rules and on a plain tensor."""
    if decode_tp_active() and x.shape[1] == 1:
        return constrain(x, "dtp_features")
    return constrain(x, "residual")


def _projection_input(h):
    """``h`` (B, S, d) as a block's projections take it: under rules, the
    sequence gathered (Megatron-SP's all-gather before the column-parallel
    products: DTensor cannot multiply an activation sharded over both
    batch and sequence); the identity outside rules, on a plain tensor
    and in a 2D-TP decode step."""
    if decode_tp_active() and h.shape[1] == 1:
        return h
    return constrain(h, "batch_only")


#: the mixers and FFNs whose prompt runs at a device offset (``pos``):
#: global attention writes a chunk's rows anywhere in its cache and the
#: recurrent xLSTM states carry on; a local-attention ring takes a prompt
#: at length 0 only, MLA's prompt branch reads the host length, and a
#: MoE FFN's capacity follows the tokens of a call, so a chunk would
#: route and drop otherwise than the whole prompt
_LADDER_MIXERS = frozenset({"attn", "mlstm", "slstm"})
_LADDER_FFNS = frozenset({"dense", "none"})


def takes_ladder(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s prompt can run as chunks at a device offset
    (``forward(..., pos=)`` with S > 1): every sub-layer's mixer is global
    attention, mLSTM or sLSTM and its FFN dense or none."""
    return all(m in _LADDER_MIXERS and g.ffn_of(i) in _LADDER_FFNS
               for g in cfg.groups for i, m in enumerate(g.pattern))


#: the mixers whose prompt runs padded at its tail, at offset 0, given
#: its true length on the device (``forward(..., valid=)``): attention
#: and MLA keep every real row exact under the causal mask (the pads come
#: after them), a ring keeps the last real rows and RG-LRU its state at
#: the last real row; an xLSTM state would carry on through the pads
_BUCKET_MIXERS = frozenset({"attn", "attn_local", "mla", "rglru"})


def takes_buckets(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s prompt can run padded at its tail to a fixed
    length (``forward(..., valid=)``): every sub-layer's mixer is
    attention (global or a ring), MLA or RG-LRU; any FFN (a MoE one keeps
    the true length's capacity)."""
    return all(m in _BUCKET_MIXERS for g in cfg.groups for m in g.pattern)


def _prompt_steps(caches, rows, pos) -> dict:
    """A prompt chunk's cache rows per attention cache size W, for
    ``attn_forward``: (rows, None, pos), ``rows`` = pos + arange(S) on the
    device."""
    return {sub["k"].shape[2]: (rows, None, pos)
            for gc in caches for sub in gc.values() if "k" in sub}


def _decode_steps(caches, pos, batch: int) -> dict:
    """The decode step's cache row and mask per attention cache size W
    (a k/v or an MLA latent cache), computed on the device from ``pos``
    (the cache position, (1,) int64): row ``pos % W`` (a global cache has
    W = max_len > pos; a ring writes over its oldest row),
    ``valid_len`` = min(pos + 1, W) per sequence, int32, and ``pos``
    itself (flash-decode writes at the position into a cache sharded
    along its rows)."""
    steps = {}
    for gc in caches:
        for sub in gc.values():
            rows = sub.get("k", sub.get("c_kv"))
            if rows is not None:
                W = rows.shape[2]
                if W not in steps:
                    valid = torch.clamp(pos + 1, max=W).to(torch.int32)
                    steps[W] = (pos % W, valid.repeat(batch), pos)
    return steps


def forward(cfg: ModelConfig, params: Params, tokens=None, *,
            extra_embeds=None, caches=None, positions=None,
            logits_slice: bool = False, pos=None, valid=None,
            capacity=None, aux: bool = False, remat_policy: str = "none"):
    """Run the decoder.

    tokens: (B, S) int ids, or None for embeddings alone.  extra_embeds:
    (B, P, d) stub-frontend embeddings prepended to the token embeddings
    (cast to the compute dtype).  caches: from :func:`init_cache`
    (inference; updated in place) or None.  positions: explicit RoPE
    positions, (B, S) or (3, B, S) under M-RoPE (default: the cache
    offset plus arange, broadcast to the three M-RoPE coordinates).
    logits_slice: return logits for the LAST position only (decode).
    pos: with caches, the cache position of the first token as a (1,)
    int64 device tensor; the default positions come from it.  For one
    token it defaults to the caches' host length.  For a prompt (S > 1)
    it makes the chunk run at that device offset (:func:`takes_ladder`
    families only; the caller checks that pos + S fits the caches), reading
    no host length; without it a prompt starts at the host length.
    valid: with fresh caches (length 0), batch 1 and S >= 2, the number
    of real tokens as a (1,) int64 device tensor: the tokens are a prompt
    of ``valid`` tokens padded at its tail (:func:`takes_buckets`
    families only).  Every real row, the logits of the last real token
    (``logits_slice``) and every cache row and state decode reads are
    those of the prompt alone; the caches' host length becomes S, which
    the caller sets to the true length (:func:`set_length`).  capacity:
    then, with MoE, ``moe.capacity`` of the true length as a (1,) int64
    device tensor.  aux: also return the MoE
    load-balance loss summed over layers, as the reference's third
    result.  remat_policy: ``"full"``, ``"dots"`` or ``"none"`` (module
    docstring); it acts only without caches.

    Returns (logits, new_caches), and the aux when asked for.
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}: one of "
                         f"{REMAT_POLICIES}")
    cdt = getattr(torch, cfg.compute_dtype)
    parts = []
    if extra_embeds is not None:
        parts.append(extra_embeds.to(cdt))
    if tokens is not None:
        parts.append(params["embed"][tokens].to(cdt))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    # the embedding output enters the residual layout at once
    x = constrain(x, "residual")
    B, S, _ = x.shape
    steps = {}
    padded = None
    if caches is not None and valid is not None:
        if not takes_buckets(cfg):
            raise NotImplementedError(
                f"{cfg.arch_id}: a padded prompt needs attention, MLA or "
                f"RG-LRU mixers (an xLSTM state carries on through pads)")
        if B != 1 or S < 2 or _cache_length(caches) != 0 or pos is not None:
            raise ValueError(f"a padded prompt runs at batch 1, S >= 2, on "
                             f"fresh caches, at no device offset; got B {B}, "
                             f"S {S}, cache length {_cache_length(caches)}")
        if capacity is None and any(g.ffn_of(i) == "moe" for g in cfg.groups
                                    for i in range(len(g.pattern))):
            raise ValueError("a padded prompt through MoE needs the true "
                             "length's capacity")
        padded = (valid, capacity)
        pos1d = torch.arange(S, device=x.device)[None]
    elif caches is not None and S == 1:
        if pos is None:
            pos = torch.full((1,), _cache_length(caches), dtype=torch.long,
                             device=x.device)
        pos1d = pos.expand(B, 1)
        steps = _decode_steps(caches, pos, B)
    elif caches is not None and pos is not None:
        if not takes_ladder(cfg):
            raise NotImplementedError(
                f"{cfg.arch_id}: a prompt at a device offset needs global "
                f"attention, mLSTM or sLSTM mixers and dense FFNs (a ring, "
                f"MLA or MoE sub-layer prefills from the host length)")
        rows = pos + torch.arange(S, device=x.device)
        pos1d = rows[None].expand(B, S)
        steps = _prompt_steps(caches, rows, pos)
    else:
        offset = _cache_length(caches) if caches is not None else 0
        pos1d = (offset + torch.arange(S, device=x.device))[None]
        pos1d = pos1d.expand(B, S)
    if positions is None:
        positions = (pos1d.expand(3, B, S) if cfg.m_rope_sections
                     else pos1d)
    auxes = [] if aux else None
    new_caches = [] if caches is not None else None
    for gi, g in enumerate(cfg.groups):
        gcache = caches[gi] if caches is not None else None
        x, nc = _run_group(cfg, g, params["groups"][gi], x, positions,
                           gcache, steps, auxes, remat_policy, padded)
        if caches is not None:
            new_caches.append(nc)
    x = _projection_input(L.rms_norm(x, params["final_norm"], cfg.norm_eps))
    if logits_slice:
        x = x[:, -1:] if valid is None else x.index_select(1, valid - 1)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(cdt)).float()
    if aux:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, new_caches, sum(auxes, total)
    return logits, new_caches


def pipeline_stages(cfg: ModelConfig, params: Params, n_stages: int) -> list:
    """The decoder cut into ``n_stages`` pipeline stages of consecutive
    layers, as ``distributed.pipeline.Stage``s for
    ``build_pipeline_graph``: stage 0 also embeds the tokens, the last
    also runs the final norm and the head (logits f32, as
    :func:`forward`'s).  A stage's params are a tree of views of
    ``params`` (each group's stacked leaves sliced to its layers); its fn
    ``(params, x) -> y`` runs them as :func:`forward` does without caches,
    at positions 0..S-1, so the stages in turn give :func:`forward`'s
    logits.  A stage's cost is its layer count, plus one for the
    embedding and one for the head."""
    import dataclasses

    from ..distributed.pipeline import Stage

    layers = [(gi, i) for gi, g in enumerate(cfg.groups)
              for i in range(g.count)]
    if not 1 <= n_stages <= len(layers):
        raise ValueError(f"{n_stages} stages for {len(layers)} layers")
    bounds = [len(layers) * s // n_stages for s in range(n_stages + 1)]
    head = "embed" if cfg.tie_embeddings else "lm_head"
    stages = []
    for s in range(n_stages):
        span = layers[bounds[s]:bounds[s + 1]]
        first, last = s == 0, s == n_stages - 1
        groups, trees = [], []
        for gi in sorted({gi for gi, _ in span}):
            idx = [i for g2, i in span if g2 == gi]
            a, b = idx[0], idx[-1] + 1
            groups.append(dataclasses.replace(cfg.groups[gi], count=b - a))
            trees.append(_slice_layers(params["groups"][gi], a, b))
        p: Params = {"groups": trees}
        if first:
            p["embed"] = params["embed"]
        if last:
            p["final_norm"] = params["final_norm"]
            p[head] = params[head]
        stages.append(Stage(fn=functools.partial(_stage_forward, cfg,
                                                 tuple(groups), first, last),
                            params=p, cost=float(len(span) + first + last)))
    return stages


def _slice_layers(tree, a: int, b: int):
    if isinstance(tree, dict):
        return {k: _slice_layers(v, a, b) for k, v in tree.items()}
    return tree[a:b]


def _stage_forward(cfg: ModelConfig, groups: tuple, first: bool, last: bool,
                   p: Params, x):
    """One pipeline stage (:func:`pipeline_stages`): tokens or the
    residual stream in, the residual stream or logits out."""
    cdt = getattr(torch, cfg.compute_dtype)
    if first:
        x = constrain(p["embed"][x].to(cdt), "residual")
    B, S = x.shape[0], x.shape[1]
    pos1d = torch.arange(S, device=x.device)[None].expand(B, S)
    positions = pos1d.expand(3, B, S) if cfg.m_rope_sections else pos1d
    for g, gp in zip(groups, p["groups"]):
        x, _ = _run_group(cfg, g, gp, x, positions, None, {}, None)
    if not last:
        return x
    x = _projection_input(L.rms_norm(x, p["final_norm"], cfg.norm_eps))
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return (x @ head.to(cdt)).float()


def _cache_length(caches) -> int:
    """The host-int cache length: every attention sub-cache carries the
    same; recurrent states carry none (a stack without attention counts
    0, as the reference's)."""
    for gc in caches:
        for sub in gc.values():
            if "length" in sub:
                return sub["length"]
    return 0


def loss_fn(cfg: ModelConfig, params: Params, batch: dict,
            remat_policy: str = "full"):
    """Next-token cross entropy (+ MoE aux), as the reference's
    ``loss_fn``.  batch: tokens (B, S), labels (B, S) with negative =
    masked (-100), optional extra_embeds (B, P, d) whose P positions are
    sliced off the logits.  Returns (loss + aux, {"loss", "aux_loss",
    "tokens"})."""
    extra = batch.get("extra_embeds")
    logits, _, aux = forward(cfg, params, batch["tokens"],
                             extra_embeds=extra, remat_policy=remat_policy,
                             aux=True)
    labels = batch["labels"]
    if extra is not None:
        logits = logits[:, extra.shape[1]:]
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    logp = F.log_softmax(logits, dim=-1)
    # -logp at each label, as the reference's take_along_axis; nll_loss's
    # backward writes each row's one entry (gather's would allocate the
    # whole logits' shape on every rank under DTensor)
    nll = F.nll_loss(logp.flatten(0, 1), safe.flatten(),
                     reduction="none").reshape(safe.shape)
    nll = torch.where(mask, nll, 0.0)
    denom = mask.sum().clamp(min=1)
    loss = nll.sum() / denom
    return loss + aux, {"loss": loss, "aux_loss": aux,
                        "tokens": mask.sum().float()}


def prefill(cfg: ModelConfig, params: Params, tokens, caches, *,
            extra_embeds=None, positions=None, pos=None, valid=None,
            capacity=None):
    """Prefill: run the prompt (after ``extra_embeds``, if given) through,
    filling caches; returns last-token logits + updated caches.  ``pos``:
    the first token's cache position as a (1,) int64 device tensor (a
    chunk of the ladder prefill, :func:`forward`); the eager twin of a
    captured chunk (``serving.graphs.PrefillGraphs``).  ``valid`` and
    ``capacity``: a prompt padded at its tail (:func:`forward`); the
    eager twin of a captured bucket
    (``serving.graphs.BucketPrefillGraphs``)."""
    logits, new_caches = forward(cfg, params, tokens, caches=caches,
                                 extra_embeds=extra_embeds,
                                 positions=positions, logits_slice=True,
                                 pos=pos, valid=valid, capacity=capacity)
    return logits[:, 0], new_caches


def decode_step(cfg: ModelConfig, params: Params, token, caches, pos=None):
    """One decode step.  token: (B,) int → logits (B, V), new caches.
    ``pos``: the cache position as a (1,) int64 device tensor, which a
    captured step takes from its static buffer (default: the caches'
    host length)."""
    logits, new_caches = forward(cfg, params, token[:, None], caches=caches,
                                 logits_slice=True, pos=pos)
    return logits[:, 0], new_caches
