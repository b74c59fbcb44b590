"""The train step: loss + grad + AdamW, microbatch accumulation, remat.

The port of ``repro.training.trainer``.  ``make_train_step(cfg, opt)``
returns ``step(state, batch) -> (state, metrics)`` that runs eagerly (no
CUDA graph, no ``torch.compile``) and updates ``state`` IN PLACE: the
f32 master parameters and the optimizer state are the same tensors after
the step.  As the reference does, the step casts the whole float tree to
``cfg.compute_dtype`` before the forward; the gradients come back to the
f32 masters through the casts and are accumulated over ``accum``
microbatches in f32 (``.grad``), then averaged.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer
from . import optimizer as opt_lib

__all__ = ["init_train_state", "make_train_step"]

#: mixers whose training the port does not hold against the reference yet
_UNTRAINED = {"mla": "MLA", "mlstm": "xLSTM (mLSTM)", "slstm": "xLSTM (sLSTM)"}


def init_train_state(cfg: ModelConfig, gen: torch.Generator | None = None,
                     device=None) -> dict:
    """Random parameters (``transformer.init_params``) and a fresh AdamW
    state: ``{"params", "opt": {"m", "v", "step"}}``."""
    params = transformer.init_params(cfg, gen, device)
    return {"params": params, "opt": opt_lib.init_opt_state(params)}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _check_trainable(cfg: ModelConfig) -> None:
    for g in cfg.groups:
        for mixer in g.pattern:
            if mixer in _UNTRAINED:
                raise NotImplementedError(
                    f"training {_UNTRAINED[mixer]} blocks is not ported yet "
                    f"(ROADMAP.md Queue 1, item 3: training parity for MLA, "
                    f"xLSTM and the frontends)")


def make_train_step(cfg: ModelConfig, opt: opt_lib.AdamWConfig, *,
                    remat_policy: str = "full", accum: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``; ``batch`` holds
    ``tokens`` and ``labels`` (B, S) on the parameters' device.

    ``accum > 1``: the batch is split into ``accum`` microbatches run one
    after another, their gradients summed into the f32 ``.grad`` of each
    master and divided by ``accum`` (activation memory /= accum).  The
    metrics are device scalars: ``loss``, ``aux_loss``, ``tokens``,
    ``grad_norm``, ``lr`` and ``total_loss``."""
    _check_trainable(cfg)
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    cdt = getattr(torch, cfg.compute_dtype)

    def loss_of(params, batch):
        return transformer.loss_fn(cfg, _cast(params, cdt), batch,
                                   remat_policy=remat_policy)

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        if batch.get("extra_embeds") is not None:
            raise NotImplementedError(
                "training on extra_embeds (stub frontends) is not ported "
                "yet (ROADMAP.md Queue 1, item 3: training parity for MLA, "
                "xLSTM and the frontends)")
        params = state["params"]
        masters = opt_lib.leaves(params)
        for p in masters:
            p.requires_grad_(True)
            p.grad = None
        tokens, labels = batch["tokens"], batch["labels"]
        if accum == 1:
            loss, metrics = loss_of(params, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            B = tokens.shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into {accum} "
                                 f"microbatches")
            mb = B // accum
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(accum):
                part = {"tokens": tokens[i * mb:(i + 1) * mb],
                        "labels": labels[i * mb:(i + 1) * mb]}
                lmb, _ = loss_of(params, part)
                lmb.backward()
                loss = loss + lmb.detach()
            loss = loss / accum
            for p in masters:
                p.grad.div_(accum)
            metrics = {"loss": loss,
                       "aux_loss": torch.zeros_like(loss),
                       "tokens": torch.tensor(float(tokens.numel()),
                                              device=loss.device)}
        grads = [p.grad for p in masters]
        _, _, opt_metrics = opt_lib.adamw_update(opt, grads, masters,
                                                 state["opt"])
        for p in masters:
            p.grad = None
        return state, dict(metrics, **opt_metrics, total_loss=loss)

    return step

