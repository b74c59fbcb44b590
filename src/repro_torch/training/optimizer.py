"""AdamW + schedules, as the reference's (``repro.training.optimizer``).

Includes the **WSD (warmup-stable-decay)** schedule from MiniCPM
(arXiv:2404.06395 §4): linear warmup → constant plateau → short sharp
decay; the schedule minicpm-2b is assigned with.

Not ``torch.optim``: the reference clips by the global norm of all
gradients and decays every leaf of two or more dims (the stacked
``(count, d)`` norm scales too), which this copies leaf for leaf.  The
step, the learning rate and the metrics stay tensors on the device (no
``.item()``), and the update runs IN PLACE on the parameters, ``m`` and
``v``, one leaf at a time through ``kernels.adamw``: on the card one
fused pass a leaf; on the CPU the plain version's elementwise passes,
whose temporaries are one leaf deep.  The gradients are read, never
written.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..kernels.adamw.ops import adamw

Params = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["AdamWConfig", "adamw_update", "cosine_schedule", "global_norm",
           "init_opt_state", "leaves", "step_scalars", "wsd_schedule"]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Schedule:
    def fn(step):
        step = step.float()
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(step < warmup, warm, cos)
    return fn


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.01) -> Schedule:
    """MiniCPM WSD: warmup → stable plateau → exponential-ish decay.

    lr(s) = peak·s/W                                (s < W)
          = peak                                    (W ≤ s < W+S)
          = peak·floor^((s−W−S)/D)                  (W+S ≤ s < W+S+D)
    """
    def fn(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup - stable) / max(decay, 1), 0, 1)
        decayed = peak_lr * torch.pow(floor, frac)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, peak_lr),
                                       decayed))
    return fn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AdamWConfig:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def leaves(tree) -> list:
    """The tensors of a params-shaped tree in the reference's leaf order
    (``jax.tree.leaves``: dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def init_opt_state(params: Params) -> dict:
    """m and v as f32 zeros shaped like each leaf, and an int32 step 0,
    on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = leaves(params)[0].device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32, over a list (or
    tree) of tensors."""
    ts = leaves(tensors) if isinstance(tensors, dict) else list(tensors)
    norms = torch._foreach_norm([t.float() for t in ts])
    return torch.linalg.vector_norm(torch.stack(norms))


def step_scalars(cfg: AdamWConfig, gnorm: torch.Tensor,
                 step: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The device scalars of the step after ``step``'s increment: the clip
    factor, the learning rate and the two bias corrections."""
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    return (scale, cfg.schedule(step), 1 - torch.pow(cfg.b1, stepf),
            1 - torch.pow(cfg.b2, stepf))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, params, opt_state):
    """One AdamW step with global-norm clipping, IN PLACE on ``params`` and
    the state's ``m``, ``v`` and ``step``; ``grads`` are read, not
    written.  ``grads`` and ``params`` are trees of one structure, or
    lists in :func:`leaves` order.  Returns (params, opt_state, metrics)
    with ``grad_norm`` and ``lr`` as device scalars."""
    flat_g = leaves(grads) if isinstance(grads, dict) else list(grads)
    flat_p = leaves(params) if isinstance(params, dict) else list(params)
    flat_m, flat_v = leaves(opt_state["m"]), leaves(opt_state["v"])
    step = opt_state["step"]
    step.add_(1)
    gnorm = global_norm(flat_g)
    scale, lr, bc1, bc2 = step_scalars(cfg, gnorm, step)
    for g, p, m, v in zip(flat_g, flat_p, flat_m, flat_v):
        adamw(g, p, m, v, scale, lr, bc1, bc2, b1=cfg.b1, b2=cfg.b2,
              eps=cfg.eps, weight_decay=cfg.weight_decay)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
