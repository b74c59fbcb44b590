"""The train step: loss + grad + AdamW, microbatch accumulation, remat.

The port of ``repro.training.trainer``.  ``make_train_step(cfg, opt)``
returns ``step(state, batch) -> (state, metrics)`` that runs eagerly (no
CUDA graph, no ``torch.compile``) and updates ``state`` IN PLACE: the
f32 master parameters and the optimizer state are the same tensors after
the step.  As the reference does, the step casts the whole float tree to
``cfg.compute_dtype`` before the forward; the gradients come back to the
f32 masters through the casts and are accumulated over ``accum``
microbatches in f32 (``.grad``), then averaged.  Every family the
reference trains is trained: attention (GQA, MLA), RG-LRU, mLSTM and
sLSTM mixers, dense and MoE FFNs, and batches that carry a stub
frontend's ``extra_embeds``.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer
from . import optimizer as opt_lib

__all__ = ["init_train_state", "train_state_specs", "make_train_step"]


def init_train_state(cfg: ModelConfig, gen: torch.Generator | None = None,
                     device=None) -> dict:
    """Random parameters (``transformer.init_params``) and a fresh AdamW
    state: ``{"params", "opt": {"m", "v", "step"}}``."""
    params = transformer.init_params(cfg, gen, device)
    return {"params": params, "opt": opt_lib.init_opt_state(params)}


def train_state_specs(cfg: ModelConfig) -> dict:
    """Shape/dtype skeleton of the train state: meta tensors, nothing
    drawn or allocated (the reference's ``jax.eval_shape``)."""
    return init_train_state(cfg, device="meta")


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def make_train_step(cfg: ModelConfig, opt: opt_lib.AdamWConfig, *,
                    remat_policy: str = "full", accum: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``; ``batch`` holds
    ``tokens`` and ``labels`` (B, S) on the parameters' device, and
    optionally ``extra_embeds`` (B, P, d), whose P positions the loss
    skips.

    ``accum > 1``: the batch is split along B into ``accum`` microbatches
    (every entry, ``extra_embeds`` too) run one after another, their
    gradients summed into the f32 ``.grad`` of each master and divided by
    ``accum`` (activation memory /= accum).  The
    metrics are device scalars: ``loss``, ``aux_loss``, ``tokens``,
    ``grad_norm``, ``lr`` and ``total_loss``."""
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    cdt = getattr(torch, cfg.compute_dtype)

    def loss_of(params, batch):
        return transformer.loss_fn(cfg, _cast(params, cdt), batch,
                                   remat_policy=remat_policy)

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        masters = opt_lib.leaves(params)
        for p in masters:
            p.requires_grad_(True)
            p.grad = None
        tokens = batch["tokens"]
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
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()
                        if v is not None}
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

