"""The plain reference of DeepSeek-V2 as a chip of an expert-parallel
deployment holds it (deepseek-v2-236b): plain PyTorch in float32 with
TF32 off, no kernel, no cache, no batching; and the benchmark's draw of
its weights.

The weights are the benchmark's, drawn here from the seed and handed to
the program and to this reference alike, in the port's tree: ``embed``
(V, d), ``final_norm`` (d,), ``lm_head`` (d, V), and ``groups[g]["sub0"]``
for each layer group of the file (the dense layer, then the MoE layers),
every leaf stacked along a leading axis of the group's layers: ``norm1``,
``norm2`` (L, d); ``mixer`` ``w_dq`` (L, d, r_q), ``q_norm`` (L, r_q),
``w_uq`` (L, r_q, H·(n + r)), ``w_dkv`` (L, d, r_kv), ``kv_norm`` (L,
r_kv), ``w_krope`` (L, d, r), ``w_uk`` (L, r_kv, H·n), ``w_uv`` (L, r_kv,
H·v), ``wo`` (L, H·v, d); a dense ``ffn`` ``w_gate``, ``w_up`` (L, d, f),
``w_down`` (L, f, d); a MoE ``ffn`` ``router`` (L, d, E), ``experts``
``w_gate``, ``w_up`` (L, E_held, d, f_e), ``w_down`` (L, E_held, f_e, d)
and ``shared`` (a SwiGLU of n_shared · f_e).  A weight is applied as
``x @ W``; a norm's weight is stored as its offset from one (w = 1 + s,
drawn as s = 0).  The draw is DeepSeek-V2's own initialisation: every
learnable parameter N(0, :data:`INIT_STD`²), the router and the
embedding too (arXiv:2405.04434 §3.1.2; ``initializer_range`` of its
config.json).  A file narrower than the published widths (its ``tiny``)
draws each matrix at INIT_STD · sqrt(F / fan_in), F the matrix's fan-in
at the published widths (the file's ``source_keys``), so that every
product has the magnitude it has at full width.  Each leaf comes from
its own stream, a layer (or a layer's experts) at a time: a stacked
expert leaf of the file is 4.56 G parameters, too many to draw in f32 at
once.

The layer, as DeepSeek-V2 states it (arXiv:2405.04434 §2.1-2.2, its
``config.json``; n, r, v the nope, rope and value head widths):

    c_q = RMSNorm_q(W_dq n)         q = W_uq c_q = [q_nope | q_rope]
    c_kv = RMSNorm_kv(W_dkv n)      k_nope = W_uk c_kv, v = W_uv c_kv
    k_rope = W_krope n (one head, shared by all)
    q_rope, k_rope turned by YaRN (split halves; cos, sin times
        mscale(s, mscale) / mscale(s, mscale_all_dim))
    h = x + W_o Attn([q_nope | q_rope], [k_nope | k_rope], v)
        causal, scale (1/sqrt(n + r)) · mscale(s, mscale_all_dim)²
    y = h + FFN(RMSNorm(h))         n = RMSNorm(x) above

YaRN at factor s over L_o original positions: inverse frequencies
f_interp·(1 − m) + f_extra·m, f_extra = θ^(−2i/r), f_interp = f_extra /
s, m = 1 − clamp((i − low) / (high − low), 0, 1), low and high the floor
and ceil of r·ln(L_o / (β·2π)) / (2 ln θ) at β = beta_fast and
beta_slow; mscale(s, a) = 0.1·a·ln(s) + 1.

The MoE layer (``group_limited_greedy``): p = softmax(router n) over all
E experts; each of the n_groups groups of E / n_groups experts (in index
order) scores the largest p of its experts, the topk_groups best groups
are kept, and the top_k experts are the largest p among the kept
groups' (the lower index first on ties, groups and experts alike); the
gate of each is p · routed_scale (not renormalised).  FFN = Σ over the
chosen experts held here (0..experts_held-1) of gate · SwiGLU_e(n), plus
the shared SwiGLU: exact and dropless, as the published inference.

``mode="fp8"`` is the control: every product takes its operands rounded
to float8 e4m3 and sums in f32 (the dense reference's rule,
:mod:`perfbench.reference.dense_decoder`), the router's too.  It is
never the program's path: the comparison that decides ``correct`` must
find it wrong.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .dense_decoder import (_mm, _ste_fp8, _put, f32_matmuls, get, rms_norm,
                            sub_seed)

__all__ = ["draw_params", "get", "leaf_specs", "logits"]

#: query rows a block of attention takes at once: the scores of 128
#: heads over 7168 keys are 0.94 GB in f32 at 256 rows
QUERY_BLOCK = 256
#: DeepSeek-V2's initialisation: "All learnable parameters are randomly
#: initialized with a standard deviation of 0.006" (arXiv:2405.04434
#: §3.1.2), its config.json's ``initializer_range``
INIT_STD = 0.006


def _groups(c: dict) -> list[tuple[int, str]]:
    """(layers, feed-forward) of each of the file's layer groups."""
    return [(g["count"], g["ffn"]) for g in c["layers"]]


def published_fan_ins(c: dict) -> dict:
    """The fan-in of each kind of matrix at the published widths: ``d``
    (hidden), ``q`` and ``kv`` (the latents), ``o`` (H · v), ``ff`` (the
    dense layer), ``fe`` (an expert), ``fs`` (the shared experts)."""
    s = c["source_keys"]
    return {"d": s["hidden_size"], "q": s["q_lora_rank"],
            "kv": s["kv_lora_rank"],
            "o": s["num_attention_heads"] * s["v_head_dim"],
            "ff": s["intermediate_size"], "fe": s["moe_intermediate_size"],
            "fs": s["moe_intermediate_size"] * s["n_shared_experts"]}


def leaf_specs(c: dict) -> list[tuple[tuple, tuple, float | None]]:
    """(path, shape, scale) of every weight, in drawing order: a scale
    draws normal weights times it; None makes zeros (a norm's offset).
    Every weight N(0, INIT_STD²) at the published widths (module
    docstring)."""
    d, V, H = c["d_model"], c["vocab_size"], c["n_heads"]
    m, e = c["mla"], c["moe"]
    qk = m["qk_nope_dim"] + m["qk_rope_dim"]
    pub = published_fan_ins(c)

    def mat(shape, kind):
        return shape, INIT_STD * math.sqrt(pub[kind] / shape[-2])

    specs = [(("embed",), (V, d), INIT_STD), (("final_norm",), (d,), None),
             (("lm_head",), *mat((d, V), "d"))]
    for gi, (L, ffn) in enumerate(_groups(c)):
        g = ("groups", gi, "sub0")
        mixer = [("w_dq", mat((d, m["q_lora_rank"]), "d")),
                 ("q_norm", ((m["q_lora_rank"],), None)),
                 ("w_uq", mat((m["q_lora_rank"], H * qk), "q")),
                 ("w_dkv", mat((d, m["kv_lora_rank"]), "d")),
                 ("kv_norm", ((m["kv_lora_rank"],), None)),
                 ("w_krope", mat((d, m["qk_rope_dim"]), "d")),
                 ("w_uk", mat((m["kv_lora_rank"], H * m["qk_nope_dim"]),
                              "kv")),
                 ("w_uv", mat((m["kv_lora_rank"], H * m["v_head_dim"]),
                              "kv")),
                 ("wo", mat((H * m["v_head_dim"], d), "o"))]
        specs.append((g + ("norm1",), (L, d), None))
        specs += [(g + ("mixer", k), (L, *shape), s)
                  for k, (shape, s) in mixer]
        specs.append((g + ("norm2",), (L, d), None))
        if ffn == "dense":
            f = c["d_ff"]
            specs += [(g + ("ffn", k), (L, *shape), s) for k, (shape, s) in
                      (("w_gate", mat((d, f), "d")), ("w_up", mat((d, f), "d")),
                       ("w_down", mat((f, d), "ff")))]
            continue
        fe, held = e["d_ff_expert"], e["experts_held"]
        fs = fe * e["n_shared"]
        router_shape, router_scale = mat((d, e["n_experts"]), "d")
        specs.append((g + ("ffn", "router"), (L, *router_shape),
                      router_scale))
        specs += [(g + ("ffn", "experts", k), (L, held, *shape), s)
                  for k, (shape, s) in (("w_gate", mat((d, fe), "d")),
                                        ("w_up", mat((d, fe), "d")),
                                        ("w_down", mat((fe, d), "fe")))]
        specs += [(g + ("ffn", "shared", k), (L, *shape), s)
                  for k, (shape, s) in (("w_gate", mat((d, fs), "d")),
                                        ("w_up", mat((d, fs), "d")),
                                        ("w_down", mat((fs, d), "fs")))]
    return specs


def draw_leaf(shape, scale, stream_seed: int, device, dtype) -> torch.Tensor:
    """One weight from its own generator on ``device``: normal draws in
    f32, one leading index (a layer, or a layer's experts) at a time,
    scaled, cast to ``dtype``; zeros where ``scale`` is None."""
    out = torch.zeros(shape, dtype=dtype, device=device)
    if scale is None:
        return out
    gen = torch.Generator(device=device).manual_seed(stream_seed)
    for i in range(shape[0] if len(shape) > 2 else 1):
        part = out[i] if len(shape) > 2 else out
        w = torch.randn(part.shape, generator=gen, device=device,
                        dtype=torch.float32)
        part.copy_(w.mul_(scale))
        del w
    return out


def draw_params(c: dict, seed: int, device, *, matmul_dtype,
                norm_dtype=torch.float32) -> dict:
    """The benchmark's weights for run seed ``seed``: each leaf from its
    own stream, matmul weights in ``matmul_dtype``, norm offsets in
    ``norm_dtype``."""
    tree: dict = {}
    for i, (path, shape, scale) in enumerate(leaf_specs(c)):
        dt = norm_dtype if scale is None else matmul_dtype
        _put(tree, path, draw_leaf(shape, scale, sub_seed(seed, i), device,
                                   dt))
    return tree


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------
def _mscale(factor: float, a: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * a * math.log(factor) + 1.0


def yarn_inv_freq(m: dict, dim: int, theta: float, device) -> torch.Tensor:
    """YaRN's (dim/2,) inverse frequencies (module docstring)."""
    def pair(beta):
        return (dim * math.log(m["yarn_original_max"] / (beta * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(pair(m["yarn_beta_fast"])), 0)
    high = min(math.ceil(pair(m["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    extra = 1.0 / theta ** (2 * i / dim)
    interp = 1.0 / (m["yarn_factor"] * theta ** (2 * i / dim))
    mask = 1.0 - torch.clamp((i - low) / (high - low), 0, 1)
    return interp * (1 - mask) + extra * mask


def yarn(x, positions, m: dict, theta: float):
    """x (S, ..., D) turned by YaRN at the S positions, split halves."""
    D = x.shape[-1]
    ang = positions.float()[:, None] * yarn_inv_freq(m, D, theta, x.device)
    scale = _mscale(m["yarn_factor"], m["yarn_mscale"]) / _mscale(
        m["yarn_factor"], m["yarn_mscale_all_dim"])
    shape = (ang.shape[0],) + (1,) * (x.dim() - 2) + (D // 2,)
    cos = (torch.cos(ang) * scale).reshape(shape)
    sin = (torch.sin(ang) * scale).reshape(shape)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def softmax_scale(m: dict) -> float:
    s = 1.0 / math.sqrt(m["qk_nope_dim"] + m["qk_rope_dim"])
    if m["yarn_factor"] > 1 and m["yarn_mscale_all_dim"]:
        s *= _mscale(m["yarn_factor"], m["yarn_mscale_all_dim"]) ** 2
    return s


def _attention(q, k, v, scale: float, mode: str):
    """Causal softmax attention of one sequence, q, k (S, H, Dqk), v (S,
    H, Dv), in blocks of query rows; fp8 operands as the dense
    reference's (q and k per row, the probabilities per row, v per
    column)."""
    S = q.shape[0]
    kt = _ste_fp8(k, -1, mode).permute(1, 2, 0)              # (H, D, S)
    vh = _ste_fp8(v, 0, mode).transpose(0, 1)                # (H, S, Dv)
    keys = torch.arange(S, device=q.device)
    outs = []
    for r0 in range(0, S, QUERY_BLOCK):
        qs = _ste_fp8(q[r0:r0 + QUERY_BLOCK], -1, mode).transpose(0, 1)
        s = (qs @ kt) * scale                                # (H, b, S)
        rows = torch.arange(r0, r0 + qs.shape[1], device=q.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        p = _ste_fp8(torch.softmax(s, dim=-1), -1, mode)
        outs.append((p @ vh).transpose(0, 1))
        del s, p
    return torch.cat(outs, dim=0)


def mla(c: dict, lw: dict, n, positions, mode: str):
    """One MLA sub-layer's output for the normed input n (S, d)."""
    m, H, eps = c["mla"], c["n_heads"], c["norm_eps"]
    S = n.shape[0]
    nope, rope, dv = m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"]
    cq = rms_norm(_mm(n, lw["w_dq"], mode), lw["q_norm"], eps)
    q = _mm(cq, lw["w_uq"], mode).reshape(S, H, nope + rope)
    ckv = rms_norm(_mm(n, lw["w_dkv"], mode), lw["kv_norm"], eps)
    k_nope = _mm(ckv, lw["w_uk"], mode).reshape(S, H, nope)
    v = _mm(ckv, lw["w_uv"], mode).reshape(S, H, dv)
    k_rope = yarn(_mm(n, lw["w_krope"], mode), positions, m, c["rope_theta"])
    q = torch.cat([q[..., :nope], yarn(q[..., nope:], positions, m,
                                       c["rope_theta"])], dim=-1)
    k = torch.cat([k_nope, k_rope[:, None].expand(S, H, rope)], dim=-1)
    a = _attention(q, k, v, softmax_scale(m), mode).reshape(S, H * dv)
    return _mm(a, lw["wo"], mode)


def swiglu(w: dict, n, mode: str):
    return _mm(F.silu(_mm(n, w["w_gate"], mode)) * _mm(n, w["w_up"], mode),
               w["w_down"], mode)


def route(e: dict, router_logits):
    """(experts (S, k), gates (S, k)) of the group-limited routing
    (module docstring), ties to the lower index by stable sorts."""
    S, E = router_logits.shape
    p = torch.softmax(router_logits, dim=-1)
    G, gs = e["n_groups"], E // e["n_groups"]
    best = torch.sort(p.reshape(S, G, gs).amax(-1), dim=-1, descending=True,
                      stable=True)[1][:, :e["topk_groups"]]
    kept = torch.zeros((S, G), dtype=torch.bool, device=p.device)
    kept[torch.arange(S, device=p.device)[:, None], best] = True
    masked = torch.where(kept.repeat_interleave(gs, dim=1), p, -1.0)
    experts = torch.sort(masked, dim=-1, descending=True,
                         stable=True)[1][:, :e["top_k"]]
    return experts, p.gather(1, experts) * e["routed_scale"]


def moe(c: dict, lw: dict, n, mode: str):
    """The MoE sub-layer's output on this chip for the normed input n (S,
    d): the held experts' gated outputs, dropless, plus the shared."""
    e = c["moe"]
    experts, gates = route(e, _mm(n, lw["router"], mode))
    out = swiglu(lw["shared"], n, mode)
    for j in range(e["experts_held"]):
        tok, slot = (experts == j).nonzero(as_tuple=True)
        if tok.numel():
            w = {k: lw["experts"][k][j] for k in lw["experts"]}
            out = out.index_add(0, tok, swiglu(w, n[tok], mode)
                                * gates[tok, slot][:, None])
    return out


def layers(c: dict, params: dict):
    """(feed-forward, weights) of each layer in order: views of one
    layer's slice of every stacked leaf."""
    for gi, (L, ffn) in enumerate(_groups(c)):
        sub = params["groups"][gi]["sub0"]
        for i in range(L):
            yield ffn, _slice(sub, i)


def _slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


@torch.no_grad()
def logits(c: dict, params: dict, tokens, *, mode: str = "f32"):
    """(S, V) f32 logits of one sequence ``tokens`` (S,)."""
    with f32_matmuls():
        eps = c["norm_eps"]
        x = params["embed"][tokens].float()
        positions = torch.arange(tokens.shape[0], device=tokens.device)
        for ffn, lw in layers(c, params):
            x = x + mla(c, lw["mixer"], rms_norm(x, lw["norm1"], eps),
                        positions, mode)
            n = rms_norm(x, lw["norm2"], eps)
            x = x + (swiglu(lw["ffn"], n, mode) if ffn == "dense"
                     else moe(c, lw["ffn"], n, mode))
        x = rms_norm(x, params["final_norm"], eps)
        return _mm(x, params["lm_head"], mode)
