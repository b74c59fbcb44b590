"""Griffin/RecurrentGemma recurrent block: temporal conv + RG-LRU.

RG-LRU (De et al., arXiv:2402.19427 eq. 5–7):

    r_t = σ(W_a x_t)                      recurrence gate
    i_t = σ(W_x x_t)                      input gate
    a_t = exp(−c · softplus(Λ) ⊙ r_t)     (c = 8)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

A prompt runs the recurrence through the hand-written RG-LRU scan
kernel (``repro_torch.kernels.rglru_scan``; its plain version on a CPU
tensor) in place of the reference's associative scan
(``repro.models.recurrent``), and under autograd through its Function,
whose backward is the reverse-time scan kernel; one decode token is the
O(1) elementwise step.  The state (conv tail, h) is updated in place by the caller.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import rglru_scan
from .layers import dense_init

Params = dict
_C = 8.0  # RG-LRU sharpness constant


def init_rglru_block(cfg, gen: torch.Generator, device,
                     count: int = 1) -> Params:
    """RG-LRU block weights stacked over ``count`` layers."""
    d = cfg.d_model
    dr = cfg.rec.d_rnn or d
    w = cfg.rec.conv_width
    dt = getattr(torch, cfg.param_dtype)
    # Λ so that a ∈ [0.9, 0.999] at r = 0.5 (paper App. A)
    lam = 0.9 + 0.099 * torch.rand((count, dr), generator=gen, device=device)
    lam = torch.log(torch.expm1(-torch.log(lam) / (_C * 0.5)))
    # gates are block-diagonal with n_heads blocks (official recurrentgemma
    # BlockDiagonalLinear)
    nb = cfg.n_heads if dr % cfg.n_heads == 0 else 1
    dh = dr // nb
    return {
        "w_x": dense_init(gen, (d, dr), dt, device, count=count),
        "w_gate": dense_init(gen, (d, dr), dt, device, count=count),
        "conv_w": dense_init(gen, (w, dr), dt, device,
                             scale=1.0 / math.sqrt(w), count=count),
        "conv_b": torch.zeros((count, dr), dtype=dt, device=device),
        "w_a": dense_init(gen, (nb, dh, dh), dt, device, count=count),
        "w_i": dense_init(gen, (nb, dh, dh), dt, device, count=count),
        "lam": lam,
        "w_out": dense_init(gen, (dr, d), dt, device, count=count),
    }


def _block_diag(x, w):
    """x: (B, S, dr); w: (nb, dh, dh) block-diagonal — batched matmul."""
    B, S, dr = x.shape
    nb, dh, _ = w.shape
    xb = x.reshape(B, S, nb, dh)
    return torch.einsum("bsnd,nde->bsne", xb, w).reshape(B, S, dr)


def _causal_conv(x, w, b, state=None):
    """x: (B, S, dr); w: (W, dr) depthwise.  state: (B, W-1, dr) tail of
    previous tokens.  The W terms are summed in order, then ``b`` added,
    as the reference sums them (bf16 rounds each partial sum)."""
    W = w.shape[0]
    if state is not None:
        x_ext = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, W - 1, 0))
    S = x.shape[1]
    out = x_ext[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + x_ext[:, i:i + S] * w[i]
    out = out + b
    new_state = x_ext[:, -(W - 1):] if W > 1 else None
    return out, new_state


def rglru_forward(cfg, p: Params, x, state=None):
    """Full Griffin recurrent block.  x: (B, S, d).

    state: dict(conv, h) of one layer, or None.  Returns (out (B, S, d),
    new_state) with new_state's conv in the state's dtype and h in f32."""
    cdt = getattr(torch, cfg.compute_dtype)
    f32 = torch.float32
    gate = F.gelu(x @ p["w_gate"].to(cdt), approximate="tanh")
    xr = x @ p["w_x"].to(cdt)
    conv_state = state["conv"] if state is not None else None
    xr, new_conv = _causal_conv(xr, p["conv_w"].to(cdt),
                                p["conv_b"].to(cdt), conv_state)

    r = torch.sigmoid(_block_diag(xr.to(f32), p["w_a"].to(f32)))
    i = torch.sigmoid(_block_diag(xr.to(f32), p["w_i"].to(f32)))
    log_a = -_C * F.softplus(p["lam"]) * r                # (B,S,dr) f32
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * xr.to(f32))

    if state is not None and x.shape[1] == 1:
        h = a[:, 0] * state["h"] + gated_x[:, 0]
        out_h = h[:, None]
        new_h = h
    else:
        h0 = (state["h"] if state is not None else
              torch.zeros(gated_x.shape[0], gated_x.shape[2], dtype=f32,
                          device=x.device))
        out_h = rglru_scan(gated_x, a, h0)
        new_h = out_h[:, -1]

    out = (out_h.to(cdt) * gate) @ p["w_out"].to(cdt)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv.to(state["conv"].dtype), "h": new_h}
    return out, new_state


def init_rglru_state(cfg, batch: int, dtype, device,
                     count: int = 1) -> Params:
    """Decode state stacked over ``count`` layers: the conv tail in
    ``dtype`` and the f32 carry ``h``."""
    dr = cfg.rec.d_rnn or cfg.d_model
    return {
        "conv": torch.zeros((count, batch, cfg.rec.conv_width - 1, dr),
                            dtype=dtype, device=device),
        "h": torch.zeros((count, batch, dr), dtype=torch.float32,
                         device=device),
    }
