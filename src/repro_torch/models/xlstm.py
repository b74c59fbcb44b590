"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM + sLSTM.

mLSTM (matrix memory, §2.3): per head,
    C_t = f_t C_{t−1} + i_t v_t k_tᵀ       (d_h × d_h matrix memory)
    n_t = f_t n_{t−1} + i_t k_t
    h_t = o_t ⊙ (C_t q_t) / max(|n_tᵀ q_t|, 1)
with exponential input gate i and stabilizer m (log-space max gate).

A prompt runs the chunkwise-parallel form (intra-chunk attention-like
contraction, inter-chunk recurrent state) and one decode token the O(1)
step form, as the reference (``repro.models.xlstm``).  sLSTM keeps the
recurrent hidden-to-hidden matrix R, so it is a loop over time of the
reference's scan step.  The reference has no Pallas kernel here: plain
PyTorch is the port.  Its sharding constraints have no meaning on one
device and are dropped.  Weights stack over a leading ``count`` axis as
everywhere in the port; the functions take one layer's slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.streams import is_dtensor
from ..distributed.context import merge_heads, split_heads
from .layers import dense_init

Params = dict
f32 = torch.float32


def _log_sigmoid(x):
    """log σ(x); on a DTensor as −softplus(−x), the same function: DTensor
    has no sharding rule for ``log_sigmoid_forward``."""
    return -F.softplus(-x) if is_dtensor(x) else F.logsigmoid(x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg) -> tuple[int, int, int]:
    """(inner width di, heads H, head width dh)."""
    di = int(cfg.d_model * cfg.rec.mlstm_proj_factor)
    return di, cfg.n_heads, di // cfg.n_heads


def init_mlstm_block(cfg, gen: torch.Generator, device,
                     count: int = 1) -> Params:
    """mLSTM block weights stacked over ``count`` layers."""
    d = cfg.d_model
    di, H, _ = _mlstm_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    # q/k/v are block-diagonal with 4 blocks (official xLSTM
    # qkv_proj_blocksize=4)
    nb = 4 if di % 4 == 0 else 1
    dq = di // nb
    return {
        "w_up": dense_init(gen, (d, 2 * di), dt, device, count=count),
        "w_q": dense_init(gen, (nb, dq, dq), dt, device, count=count),
        "w_k": dense_init(gen, (nb, dq, dq), dt, device, count=count),
        "w_v": dense_init(gen, (nb, dq, dq), dt, device, count=count),
        "w_i": dense_init(gen, (di, H), dt, device, scale=0.02, count=count),
        "w_f": dense_init(gen, (di, H), dt, device, scale=0.02, count=count),
        "b_i": torch.zeros((count, H), dtype=f32, device=device),
        "b_f": torch.full((count, H), 3.0, dtype=f32, device=device),
        "w_down": dense_init(gen, (di, d), dt, device, count=count),
    }


def _mlstm_chunk(q, k, v, log_i, log_f, C0, n0, m0):
    """One chunk of the chunkwise-parallel mLSTM.

    q,k,v: (B, H, L, dh); log_i/log_f: (B, H, L).
    C0: (B, H, dh, dh), n0: (B, H, dh), m0: (B, H).
    Returns h (B,H,L,dh) and final (C, n, m).
    """
    L, dh = q.shape[2], q.shape[3]
    lf_cum = torch.cumsum(log_f, dim=-1)                   # (B,H,L)
    log_g = lf_cum + m0[..., None]                 # decay from chunk start
    log_a = log_i + lf_cum[..., -1:] - lf_cum              # decay to chunk end
    # exact stabilizer (xLSTM App. D.2):
    #   m_t = max(lf_cum_t + m0, max_{s<=t}(lf_cum_t − lf_cum_s + log_i_s))
    D = lf_cum[..., :, None] - lf_cum[..., None, :] + log_i[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    D = torch.where(mask, D, -math.inf)
    m_t = torch.maximum(log_g, D.amax(dim=-1))             # (B,H,L)

    scale = 1.0 / math.sqrt(dh)
    # inter-chunk contribution: C0 q_t, decayed from chunk start.  C0 is
    # Σ v kᵀ (the step form's layout), so its rows are read against q;
    # the reference contracts q with C0's first axis instead, q_t·C0 =
    # (q·v) k, which is wrong whenever C0 != 0: a prompt that continues a
    # state (chunked prefill) or passes one chunk (ROADMAP.md, Queue 3)
    decay = torch.exp(log_g - m_t)
    inter = torch.einsum("bhle,bhde->bhld", q, C0) * scale * decay[..., None]
    n_inter = torch.einsum("bhld,bhd->bhl", q, n0) * scale * decay

    # intra-chunk attention-like contribution
    S = torch.einsum("bhld,bhsd->bhls", q, k) * scale
    W = torch.where(mask, torch.exp(D - m_t[..., None]), 0.0)
    intra = torch.einsum("bhls,bhsd->bhld", S * W, v)
    n_intra = (S * W).sum(-1)

    num = inter + intra
    den = n_inter + n_intra
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

    # chunk-final state
    m_end = torch.maximum(lf_cum[..., -1] + m0, log_a.amax(dim=-1))
    decay_all = torch.exp(lf_cum[..., -1] + m0 - m_end)    # (B,H)
    w_s = torch.exp(log_a - m_end[..., None])              # (B,H,L)
    C = (C0 * decay_all[..., None, None]
         + torch.einsum("bhl,bhld,bhle->bhde", w_s, v, k))
    n = n0 * decay_all[..., None] + torch.einsum("bhl,bhld->bhd", w_s, k)
    return h, (C, n, m_end)


def mlstm_forward(cfg, p: Params, x, state=None, chunk: int = 1024):
    """x: (B, S, d) → (B, S, d), new state.  state: dict(C, n, m) of one
    layer, or None.  A prompt runs chunks of min(``chunk``, S) tokens (S
    must be a multiple of it, as the reference asserts); one token runs
    the step form."""
    cdt = getattr(torch, cfg.compute_dtype)
    B, S, d = x.shape
    _, H, dh = _mlstm_dims(cfg)
    up = x @ p["w_up"].to(cdt)
    xb, og = torch.chunk(up, 2, dim=-1)
    o = torch.sigmoid(og.to(f32))

    def heads(w):
        """Block-diagonal projection of xb, split into (B, H, S, dh)."""
        nb, dq, _ = w.shape
        y = torch.einsum("bsnd,nde->bsne", split_heads(xb, nb, dq),
                         w.to(cdt))
        return split_heads(merge_heads(y), H, dh).transpose(1, 2)

    q, k, v = heads(p["w_q"]), heads(p["w_k"]), heads(p["w_v"])
    xf = xb.to(f32)
    log_i = (xf @ p["w_i"].to(f32) + p["b_i"]).transpose(1, 2)   # (B,H,S)
    log_f = _log_sigmoid(xf @ p["w_f"].to(f32) + p["b_f"]).transpose(1, 2)

    if state is None:
        C0 = torch.zeros((B, H, dh, dh), dtype=f32, device=x.device)
        n0 = torch.zeros((B, H, dh), dtype=f32, device=x.device)
        m0 = torch.full((B, H), -math.inf, dtype=f32, device=x.device)
    else:
        C0, n0, m0 = state["C"], state["n"], state["m"]

    if S == 1:
        # decode: O(1) recurrent update
        lf, li = log_f[..., 0], log_i[..., 0]
        m_new = torch.maximum(lf + m0, li)
        f_ = torch.exp(lf + m0 - m_new)
        i_ = torch.exp(li - m_new)
        k0, v0 = k[:, :, 0].to(f32), v[:, :, 0].to(f32)
        C = C0 * f_[..., None, None] + i_[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", v0, k0)
        n = n0 * f_[..., None] + i_[..., None] * k0
        qd = q[:, :, 0].to(f32) / math.sqrt(dh)
        num = torch.einsum("bhde,bhe->bhd", C, qd)
        den = torch.abs(torch.einsum("bhd,bhd->bh", n, qd))
        h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        h = h[:, :, None]                                   # (B,H,1,dh)
        new_state = {"C": C, "n": n, "m": m_new}
    else:
        L = min(chunk, S)
        if S % L:
            raise ValueError(f"mlstm_forward: seq {S} is not a multiple of "
                             f"the chunk {L}")
        hs = []
        C, n, m = C0, n0, m0
        for c0 in range(0, S, L):
            sl = slice(c0, c0 + L)
            h, (C, n, m) = _mlstm_chunk(q[:, :, sl], k[:, :, sl],
                                        v[:, :, sl], log_i[..., sl],
                                        log_f[..., sl], C, n, m)
            hs.append(h)
        h = torch.cat(hs, dim=2)
        new_state = {"C": C, "n": n, "m": m}

    h = merge_heads(h.transpose(1, 2)) * o
    out = h.to(cdt) @ p["w_down"].to(cdt)
    return out, (new_state if state is not None else None)


def init_mlstm_state(cfg, batch: int, device, count: int = 1) -> Params:
    """f32 matrix memory C, normaliser n and stabilizer m = −inf, stacked
    over ``count`` layers."""
    _, H, dh = _mlstm_dims(cfg)
    return {
        "C": torch.zeros((count, batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((count, batch, H, dh), dtype=f32, device=device),
        "m": torch.full((count, batch, H), -math.inf, dtype=f32,
                        device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm_block(cfg, gen: torch.Generator, device,
                     count: int = 1) -> Params:
    """sLSTM block weights stacked over ``count`` layers."""
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    f = int(d * cfg.rec.slstm_proj_factor)
    dt = getattr(torch, cfg.param_dtype)
    b = torch.cat([torch.zeros(3 * d), torch.ones(d)]).to(device)
    return {
        "w_in": dense_init(gen, (d, 4 * d), dt, device, count=count),
        "r": dense_init(gen, (H, dh, 4 * dh), dt, device,
                        scale=1.0 / math.sqrt(dh), count=count),
        "b": b.expand(count, 4 * d).clone(),
        "w_up": dense_init(gen, (d, 2 * f), dt, device, count=count),
        "w_down": dense_init(gen, (f, d), dt, device, count=count),
    }


def slstm_forward(cfg, p: Params, x, state=None):
    """sLSTM with exponential gating and stabilizer, sequential over time,
    then the block's gated FFN tail.

    x: (B, S, d); state: dict(h, c, n, m), each (B, d) f32, or None."""
    cdt = getattr(torch, cfg.compute_dtype)
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    pre = (x @ p["w_in"].to(cdt)).to(f32)                  # (B,S,4d)
    if state is None:
        h = torch.zeros((B, d), dtype=f32, device=x.device)
        c = torch.zeros((B, d), dtype=f32, device=x.device)
        n = torch.ones((B, d), dtype=f32, device=x.device)
        m = torch.zeros((B, d), dtype=f32, device=x.device)
    else:
        h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    r = p["r"].to(f32)
    b = p["b"]
    hs = []
    for t in range(S):
        rec = merge_heads(torch.einsum("bhd,hde->bhe",
                                       split_heads(h, H, dh), r))
        z, i, f, o = torch.chunk(pre[:, t] + rec + b, 4, dim=-1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        log_f = _log_sigmoid(f)
        m_new = torch.maximum(log_f + m, i)
        i_ = torch.exp(i - m_new)
        f_ = torch.exp(log_f + m - m_new)
        c = f_ * c + i_ * z
        n = f_ * n + i_
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(cdt)                      # (B,S,d)
    # gated FFN tail (xLSTM block post-projection)
    a, g = torch.chunk(y @ p["w_up"].to(cdt), 2, dim=-1)
    y = (a * F.gelu(g, approximate="tanh")) @ p["w_down"].to(cdt)
    new_state = None
    if state is not None:
        new_state = {"h": h, "c": c, "n": n, "m": m}
    return y, new_state


def init_slstm_state(cfg, batch: int, device, count: int = 1) -> Params:
    """f32 h, c, m zero and n one, stacked over ``count`` layers."""
    d = cfg.d_model
    shape = (count, batch, d)
    return {
        "h": torch.zeros(shape, dtype=f32, device=device),
        "c": torch.zeros(shape, dtype=f32, device=device),
        "n": torch.ones(shape, dtype=f32, device=device),
        "m": torch.zeros(shape, dtype=f32, device=device),
    }
