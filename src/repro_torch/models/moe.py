"""Mixture-of-Experts layer (DeepSeek-V2 / Llama-4 style), one device.

Routing runs through the hand-written MoE-gating kernel
(``repro_torch.kernels.moe_gating``; its plain version on a CPU tensor):
softmax, top-k, renormalised gates and first-come-first-served capacity
slots in one launch, in place of the reference's stable argsort
(``repro.models.moe._group_dispatch``).  The semantics are the
reference's: positions in flattened (token, k) order, ``slot = e·C +
pos``, and a dropped entry adds zeros at its expert's row 0.  The expert
products over the (E, C, d) buffer are plain batched matmuls, as the
reference leaves them to XLA.  Shared experts run densely for every
token.  The reference's expert-parallel shard_map path waits for the
distributed slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import moe_gating
from .layers import dense_init, ffn_forward, init_ffn

Params = dict

#: experts drawn per f32 draw in :func:`init_moe`: a whole expert tensor
#: of a full-width config is ~21 GB in f32
_EXPERTS_PER_DRAW = 8


def _init_experts(gen, count: int, E: int, d_in: int, d_out: int, dtype,
                  device) -> torch.Tensor:
    """(count, E, d_in, d_out) expert weights in ``dtype``, drawn a few
    experts at a time, each draw scaled as the whole (E, d_in, d_out)
    weight: by 1/sqrt(E), the reference's rule for its first axis."""
    w = torch.empty((count, E, d_in, d_out), dtype=dtype, device=device)
    for e0 in range(0, E, _EXPERTS_PER_DRAW):
        e1 = min(E, e0 + _EXPERTS_PER_DRAW)
        w[:, e0:e1] = dense_init(gen, (e1 - e0, d_in, d_out), dtype, device,
                                 scale=1.0 / math.sqrt(E), count=count)
    return w


def init_moe(cfg, gen: torch.Generator, device, count: int = 1) -> Params:
    """Router, routed experts and shared experts stacked over ``count``."""
    m = cfg.moe
    d = cfg.d_model
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "router": dense_init(gen, (d, m.n_experts), dt, device,
                             scale=0.02, count=count),
        "experts": {
            name: _init_experts(gen, count, m.n_experts, a, b, dt, device)
            for name, a, b in (("w_gate", d, m.d_ff_expert),
                               ("w_up", d, m.d_ff_expert),
                               ("w_down", m.d_ff_expert, d))},
    }
    if m.n_shared:
        p["shared"] = init_ffn(cfg, gen, device, count,
                               d_ff=m.d_ff_expert * m.n_shared)
    return p


def _capacity(cfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8, as the reference


def _group_dispatch(cfg, router_w, xg, cdt, aux: bool = False):
    """Route one token group.  xg: (Tg, d); router_w: f32 (d, E).

    Returns (buf (E, C, d), slot, keep, gate, aux), the entries in
    flattened (token, k) order; the load-balance ``aux`` is None unless
    asked for."""
    m = cfg.moe
    Tg, d = xg.shape
    C = _capacity(cfg, Tg)
    logits = xg.float() @ router_w
    eids, gates, slots, keep = moe_gating(logits, top_k=m.top_k, capacity=C)

    aux = _load_balance_aux(cfg, logits, eids) if aux else None
    slot = slots.reshape(-1).long()
    keep = keep.reshape(-1)
    src = torch.arange(Tg, device=xg.device).repeat_interleave(m.top_k)
    src = torch.where(keep, src, 0)
    gathered = torch.where(keep[:, None], xg[src].to(cdt), 0)
    buf = torch.zeros((m.n_experts * C, d), dtype=cdt, device=xg.device)
    buf.index_add_(0, slot, gathered)
    return (buf.reshape(m.n_experts, C, d), slot, keep,
            gates.reshape(-1).to(cdt), aux)


def _load_balance_aux(cfg, logits, eids):
    """The load-balance auxiliary loss (Switch eq. 4), from the router's
    logits and first choices.  Serving never reads it: under ``jax.jit``
    the reference's unused aux is dropped by XLA, so the port computes it
    only when asked (training)."""
    m = cfg.moe
    probs = torch.softmax(logits, dim=-1)
    density = F.one_hot(eids[:, 0].long(), m.n_experts).float().mean(0)
    return m.aux_loss_coef * m.n_experts * torch.sum(density * probs.mean(0))


def _group_combine(ex_out_g, slot, keep, gate, Tg, k, d):
    """ex_out_g: (E·C, d) → (Tg, d): each token's k gated expert rows
    summed (a dropped entry adds zero)."""
    contrib = torch.where(keep[:, None], ex_out_g[slot] * gate[:, None], 0)
    return contrib.reshape(Tg, k, d).sum(1)


def _moe_local(cfg, p: Params, x, cdt, aux: bool = False):
    """Single-device path.  x: (B, S, d) → (B, S, d), aux (None unless
    asked for)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    buf, slot, keep, gate, aux = _group_dispatch(
        cfg, p["router"].float(), xt, cdt, aux)
    w = p["experts"]
    gg = F.silu(torch.bmm(buf, w["w_gate"].to(cdt)))
    uu = torch.bmm(buf, w["w_up"].to(cdt))
    ex_out = torch.bmm(gg * uu, w["w_down"].to(cdt))
    out = _group_combine(ex_out.reshape(-1, d), slot, keep, gate, T,
                         m.top_k, d)
    return out.reshape(B, S, d), aux


def moe_forward(cfg, p: Params, x, *, aux: bool = False):
    """x: (B, S, d) → (B, S, d), aux_loss: the load-balance loss when
    ``aux``, else None (nothing on the serving path reads it)."""
    cdt = getattr(torch, cfg.compute_dtype)
    out, aux = _moe_local(cfg, p, x, cdt, aux)
    if "shared" in p:
        out = out + ffn_forward(cfg, p["shared"], x.to(cdt))
    return out, aux
