"""Weights across: the JAX reference's parameters into the port's.

The reference keeps its parameters as a pytree of arrays with the same
layout the port uses (``{"embed", "final_norm", "lm_head", "groups":
[{"sub0": {"norm1", "mixer": {...}, "norm2", "ffn": {...}}}]}``, weights
``(in, out)`` stacked over each group's ``count``).  The caller turns it
into numpy arrays (``jax.tree.map(np.asarray, params)``); this module
needs neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy", "train_state_from_numpy"]


def params_from_numpy(tree: Any, device, dtype: torch.dtype | None = None):
    """The same tree with every array a tensor on ``device``; floating
    leaves cast to ``dtype`` when given.  Layouts are kept as they are:
    the port applies weights as ``x @ W`` like the reference."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    t = torch.from_numpy(np.array(tree, copy=True)).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def train_state_from_numpy(tree: Any, device) -> dict:
    """A train state ``{"params", "opt": {"m", "v", "step"}}`` (the
    reference's ``init_train_state`` layout, as numpy arrays) as tensors
    on ``device``: the params keep their dtypes, m and v are f32 and the
    step an int32 scalar, as ``repro_torch.training`` keeps them."""
    opt = tree["opt"]
    return {"params": params_from_numpy(tree["params"], device),
            "opt": {"m": params_from_numpy(opt["m"], device, torch.float32),
                    "v": params_from_numpy(opt["v"], device, torch.float32),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=device)}}
