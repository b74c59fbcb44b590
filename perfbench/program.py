"""The system under test, as the benchmark builds and drives it: the
PyTorch and CUDA port ``repro_torch``.  The only module of the benchmark
that imports it; the reference and the yardstick never do.

A configuration file's numbers become the port's ``ModelConfig``, so
the file is the configuration as run: its widths, its layer stack (the
``layers`` groups of mixers and feed-forwards; one dense attention group
where it has none) and its ``moe``, ``mla`` and ``rec`` settings, each
laid over the port's own (``perfbench/README.md`` lists the keys).
Serving is built as ``repro_torch.launch.serve.serve`` builds it (an
``Executor`` of two workers over the device, a ``ServingEngine`` on it);
a train step as ``repro_torch.launch.train.train`` builds it
(``make_train_step`` with AdamW, wrapped in a ``TrainStepGraph`` on the
card).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import LayerGroup
from repro_torch.core import Executor, Heteroflow
from repro_torch.data import Pipeline, PipelineConfig
from repro_torch.kernels import _build
from repro_torch.serving import ServingEngine
from repro_torch.training import (AdamWConfig, TrainStepGraph,
                                  make_train_step, wsd_schedule)
from repro_torch.training.optimizer import init_opt_state

from . import costs

__all__ = ["Executor", "Heteroflow", "Pipeline", "PipelineConfig",
           "build_kernels", "engine", "model_config", "opt_state",
           "train_step"]


def model_config(c: dict):
    """The port's ``ModelConfig`` of configuration file ``c``: the port's
    config of ``c["arch"]`` with the file's widths, its layer groups and
    its ``moe``, ``mla`` and ``rec`` dicts laid over the port's (a key the
    port lacks raises its ``TypeError``).  Raises, naming the group, for
    a stack the yardstick cannot count (``costs.check``), and where
    ``n_layers`` is not the groups' layers."""
    held = costs.check(c)
    if held != c["n_layers"]:
        raise ValueError(f"{c['arch']}: n_layers {c['n_layers']}, but its "
                         f"layer groups hold {held}")
    groups = tuple(
        LayerGroup(**dict(g, pattern=tuple(g["pattern"]),
                          ffn=(g["ffn"] if isinstance(g["ffn"], str)
                               else tuple(g["ffn"]))))
        for g in costs.layers(c))
    base = get_config(c["arch"])
    nested = {k: dataclasses.replace(getattr(base, k), **c[k])
              for k in ("moe", "mla", "rec") if k in c}
    return dataclasses.replace(
        base, d_model=c["d_model"], n_heads=c["n_heads"],
        n_kv_heads=c["n_kv_heads"], d_ff=c["d_ff"],
        vocab_size=c["vocab_size"], head_dim=c["head_dim"],
        rope_theta=c["rope_theta"], norm_eps=c["norm_eps"],
        tie_embeddings=c["tie_embeddings"],
        compute_dtype=c["compute_dtype"], param_dtype=c["param_dtype"],
        groups=groups, **nested)


def build_kernels(names, device) -> dict:
    """Compile (or find built) the kernel sources ``names`` together;
    nothing on the CPU, where the wrappers take their plain versions."""
    if device.type != "cuda":
        return {}
    return _build.build(names)


def engine(c: dict, cfg, params, executor, device) -> ServingEngine:
    """A serving engine of configuration file ``c``'s deployment: its
    slots, each with a cache of ``max_seq`` rows (graphs captured here on
    the card)."""
    s = c["serve"]
    return ServingEngine(cfg, params, max_slots=s["slots"],
                         max_seq=s["max_seq"], executor=executor,
                         device=device)


def opt_state(params) -> dict:
    """A fresh AdamW state for ``params``."""
    return init_opt_state(params)


def train_step(c: dict, cfg, state: dict, device):
    """The train step of configuration file ``c``: AdamW under its WSD
    schedule, its remat policy; a ``TrainStepGraph`` on the card."""
    t = c["train"]
    o = t["optimizer"]
    opt = AdamWConfig(
        schedule=wsd_schedule(o["peak_lr"], o["warmup"], o["stable"],
                              o["decay"], o["floor"]),
        b1=o["b1"], b2=o["b2"], eps=o["eps"],
        weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])
    step = make_train_step(cfg, opt, remat_policy=t["remat"])
    return TrainStepGraph(step, state) if device.type == "cuda" else step
