"""Mixture-of-Experts layer (DeepSeek-V2 / Llama-4 style).

Routing runs through the hand-written MoE-gating kernel
(``repro_torch.kernels.moe_gating``; its plain version on a CPU tensor):
softmax, top-k, renormalised gates and first-come-first-served capacity
slots in one launch, in place of the reference's stable argsort
(``repro.models.moe._group_dispatch``).  The semantics are the
reference's: positions in flattened (token, k) order, ``slot = e·C +
pos``, and a dropped entry adds zeros at its expert's row 0.  Under
autograd the gates are recomputed from the logits (softmax, gathered at
the kernel's experts, renormalised, as the reference's ``softmax →
top_k``), so the router gets its gradient; experts, slots and keep stay
the kernel's integers.  The expert
products over the (E, C, d) buffer are plain batched matmuls, as the
reference leaves them to XLA.  Shared experts run densely for every
token.

Under a rule context whose mesh has more than one rank
(``distributed.context.moe_shard_info``, the reference's condition) the
layer takes the expert-parallel path, :func:`_moe_shard_map`: each rank
routes its own tokens as one group, tokens travel to their experts' rank
with ``all_to_all_single`` over the model axis and back, expert weights
are all-gathered over the batch axes.  On one rank it is never taken.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.streams import is_dtensor
from ..distributed.context import constrain, manual_mode, moe_shard_info
from ..distributed.sharding import P, as_like, axis_sizes, local_block
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


def capacity(cfg, n_tokens: int) -> int:
    """C: the slots each expert holds for a group of ``n_tokens`` tokens,
    as the reference sizes them."""
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8, as the reference


def _group_dispatch(cfg, router_w, xg, cdt, aux: bool = False,
                    valid=None):
    """Route one token group.  xg: (Tg, d) in the compute dtype;
    router_w: f32 (d, E) (the reference's ``router.astype(f32)``, so the
    logits are the f32 product of the two, as its promoted
    ``(xg @ router_w).astype(f32)``).

    ``valid``: a group padded at its tail, as (n, C(n)), (1,) int64
    device tensors: its first n tokens are the real ones and C(n) their
    capacity.  The slots are handed out first come, first served, so the
    real entries' positions are those of the n tokens alone; the buffer
    keeps the padded group's C, and an entry is kept only from a real
    token at a position below C(n), as the n tokens alone would keep it.

    Returns (buf (E, C, d), slot, keep, gate, aux), the entries in
    flattened (token, k) order; the load-balance ``aux`` is None unless
    asked for."""
    m = cfg.moe
    Tg, d = xg.shape
    C = capacity(cfg, Tg)
    if is_dtensor(xg):
        # sharded tokens (a mesh of more ranks): the capacity slots run
        # across every token of the group, so each rank routes it whole
        xg = xg.full_tensor()
        if is_dtensor(router_w):
            router_w = router_w.full_tensor()
    logits = xg.float() @ router_w
    eids, gates, slots, keep = moe_gating(logits.detach(), top_k=m.top_k,
                                          capacity=C)
    if logits.requires_grad:
        # the kernel's gates again, with the router's gradient
        g = torch.softmax(logits, dim=-1).gather(1, eids.long())
        gates = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)

    aux = _load_balance_aux(cfg, logits, eids) if aux else None
    slot = slots.reshape(-1).long()
    keep = keep.reshape(-1)
    src = torch.arange(Tg, device=xg.device).repeat_interleave(m.top_k)
    if valid is not None:
        n, cap = valid
        at = slot - eids.reshape(-1).long() * C
        keep = keep & (at < cap) & (src < n)
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
    # one-hot by comparison: F.one_hot reads a CPU tensor's indices back
    # to check them (a host sync inside the train step)
    experts = torch.arange(m.n_experts, device=eids.device)
    density = (eids[:, :1].long() == experts).float().mean(0)
    return m.aux_loss_coef * m.n_experts * torch.sum(density * probs.mean(0))


def _group_combine(ex_out_g, slot, keep, gate, Tg, k, d):
    """ex_out_g: (E·C, d) → (Tg, d): each token's k gated expert rows
    summed (a dropped entry adds zero)."""
    contrib = torch.where(keep[:, None], ex_out_g[slot] * gate[:, None], 0)
    return contrib.reshape(Tg, k, d).sum(1)


def _moe_local(cfg, p: Params, x, cdt, aux: bool = False, valid=None):
    """Single-device path.  x: (B, S, d) → (B, S, d), aux (None unless
    asked for); ``valid`` as :func:`_group_dispatch` takes it."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    buf, slot, keep, gate, aux = _group_dispatch(
        cfg, p["router"].float(), xt, cdt, aux, valid)
    w = p["experts"]
    gg = F.silu(torch.bmm(buf, w["w_gate"].to(cdt)))
    uu = torch.bmm(buf, w["w_up"].to(cdt))
    ex_out = torch.bmm(gg * uu, w["w_down"].to(cdt))
    out = _group_combine(ex_out.reshape(-1, d), slot, keep, gate, T,
                         m.top_k, d)
    return out.reshape(B, S, d), aux


def _all_gather(t, mesh, axes, dim: int):
    """``t`` gathered tiled along ``dim`` over mesh ``axes`` (the innermost
    axis first, so blocks land in the axes' row-major order, as the
    reference's ``all_gather(..., axes, tiled=True)``), differentiable
    as the reference's (its gradient a reduce-scatter).  An axis of one
    rank gathers ``t`` itself, with no copy (XLA elides it too; a copy
    of deepseek-v2's 7.5 GB of bf16 experts cost 15 ms a call)."""
    from torch.distributed.nn.functional import all_gather
    for ax in reversed(axes):
        if axis_sizes(mesh)[ax] == 1:
            continue
        parts = all_gather(t.contiguous(), group=mesh.get_group(ax))
        t = torch.cat(parts, dim=dim)
    return t


def _all_to_all(t, mesh, axis, split: int, concat: int):
    """The reference's tiled ``all_to_all(t, axis, split, concat)`` for a
    3-d ``t`` and split/concat over dims 0 and 1: ``t`` cut into M blocks
    along ``split``, block i sent to rank i of ``axis``, the blocks
    received put side by side along ``concat`` in rank order;
    differentiable (its gradient the reverse exchange)."""
    from torch.distributed.nn.functional import all_to_all_single
    M = axis_sizes(mesh)[axis]
    a, b, d = t.shape
    if split == 0:                       # (E, C, d) → (E/M, M·C, d)
        send = t.reshape(M, a // M, b, d)
    else:                                # (E/M, M·C, d) → (E, C, d)
        send = t.reshape(a, M, b // M, d).transpose(0, 1)
    send = send.contiguous()
    recv = all_to_all_single(torch.empty_like(send), send,
                             group=mesh.get_group(axis))
    if split == 0:
        return recv.transpose(0, 1).reshape(a // M, M * b, d)
    return recv.reshape(M * a, b // M, d)


def _moe_shard_map(cfg, p: Params, x, cdt, mesh, baxes, maxis,
                   aux: bool = False):
    """Explicit expert-parallel MoE: per-rank dispatch + all_to_all.

    Every rank owns T/n_dev tokens (the residual layout: batch over the
    batch axes, sequence over the model axis) and routes them as ONE
    group through :func:`_group_dispatch` (the gating kernel on the
    card), so its capacity and drops are those of :func:`_moe_local` on
    its own tokens.  Tokens travel to their expert's model rank via one
    ``all_to_all_single`` over the model axis (experts replicate across
    the batch axes) and back; FSDP'd expert weights are all-gathered over
    the batch axes.  ``aux`` (when asked for) is averaged over every axis;
    shared experts stay dense.

    ``x``, the router and the expert weights are global DTensors (taken
    to this rank's blocks, as the reference's shard_map in_specs: x
    (batch, model, ·), experts (model, batch, ·) / (model, ·, batch)) or
    this rank's blocks already (plain tensors).  Returns (out, aux), both
    of ``x``'s kind; the exchanges are differentiable, as the reference's
    collectives are."""
    from torch.distributed.nn.functional import all_reduce

    m = cfg.moe
    E = m.n_experts
    all_axes = (*baxes, maxis)
    bspec = baxes if baxes else None
    x_spec = P(bspec, maxis, None)
    w = p["experts"]
    x_blk = local_block(x, mesh, x_spec)
    router_w = local_block(p["router"], mesh, P(None, None))
    w_gate = local_block(w["w_gate"], mesh, P(maxis, bspec, None))
    w_up = local_block(w["w_up"], mesh, P(maxis, bspec, None))
    w_down = local_block(w["w_down"], mesh, P(maxis, None, bspec))
    with manual_mode():
        xt = x_blk.reshape(-1, x_blk.shape[-1])
        T, d = xt.shape
        if baxes:
            w_gate = _all_gather(w_gate, mesh, baxes, 1)
            w_up = _all_gather(w_up, mesh, baxes, 1)
            w_down = _all_gather(w_down, mesh, baxes, 2)
        buf, slot, keep, gate, aux_v = _group_dispatch(
            cfg, router_w.float(), xt, cdt, aux)
        # dispatch: (E, C, d) → (E/M, M·C, d) within the model row
        buf = _all_to_all(buf, mesh, maxis, 0, 1)
        gg = F.silu(torch.bmm(buf, w_gate.to(cdt)))
        uu = torch.bmm(buf, w_up.to(cdt))
        eo = torch.bmm(gg * uu, w_down.to(cdt))
        # combine: back to (E, C, d) on the owning rank
        eo = _all_to_all(eo, mesh, maxis, 1, 0)
        out = _group_combine(eo.reshape(E * eo.shape[1], d), slot, keep,
                             gate, T, m.top_k, d).reshape(x_blk.shape)
        if aux_v is not None:
            for ax in all_axes:
                aux_v = all_reduce(aux_v, group=mesh.get_group(ax))
            n = 1
            for ax in all_axes:
                n *= axis_sizes(mesh)[ax]
            aux_v = as_like(aux_v / n, x, mesh, P())
    out = as_like(out, x, mesh, x_spec)
    if "shared" in p:
        # in the shared experts' layout, so their gradients come back in
        # it (a product over tokens sharded on batch and sequence is one
        # DTensor cannot take); the identity outside rules
        out = constrain(out, "batch_only") + ffn_forward(cfg, p["shared"],
                                                         x.to(cdt))
    return out, aux_v


def moe_forward(cfg, p: Params, x, *, aux: bool = False, valid=None):
    """x: (B, S, d) → (B, S, d), aux_loss: the load-balance loss when
    ``aux``, else None (nothing on the serving path reads it).  Takes
    :func:`_moe_shard_map` under the reference's conditions.  ``valid``:
    (n, C(n)) for tokens padded at their tail (:func:`_group_dispatch`;
    the single-device path only)."""
    cdt = getattr(torch, cfg.compute_dtype)
    B, S = x.shape[0], x.shape[1]
    info = moe_shard_info(B * S)
    if info is not None and valid is not None:
        raise NotImplementedError("a padded prompt through the "
                                  "expert-parallel MoE")
    if info is not None:
        mesh, baxes, maxis = info
        sizes = axis_sizes(mesh)
        M = sizes[maxis]
        btot = 1
        for a in baxes:
            btot *= sizes[a]
        if cfg.moe.n_experts % M == 0 and B % btot == 0 and S % M == 0:
            return _moe_shard_map(cfg, p, x, cdt, *info, aux=aux)
    out, aux = _moe_local(cfg, p, x, cdt, aux, valid)
    if "shared" in p:
        out = out + ffn_forward(cfg, p["shared"], x.to(cdt))
    return out, aux
