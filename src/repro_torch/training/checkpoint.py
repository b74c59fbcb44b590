"""Checkpointing, in the reference's on-disk format
(``repro.training.checkpoint``), so a checkpoint written by either
package restores in the other.

* **Format**: ``<dir>/step_<N:08d>/`` holding ``manifest.json``
  (``{"step": N, "arrays": {key: file}}``) and one ``arr_<i:05d>.npy``
  per leaf, files numbered in sorted key order; a key is the leaf's path
  (dict keys, list indices) joined by ``\\x1f``.  bf16 leaves are stored
  as f32 (numpy has no bf16) and cast back at restore.
* **Atomic**: written to ``step_<N>.tmp/`` then ``os.replace``d to
  ``step_<N>/``; a crash mid-save never leaves a partial checkpoint.
* **Async through the task graph**: :func:`async_save` snapshots the
  state into pinned host buffers with copies enqueued on the current
  stream (the train step's, so the next step, enqueued after them,
  cannot change the state before they are done), records an event, and
  returns the future of a ``Heteroflow`` whose host task waits on the
  event and writes the files while training goes on.  The reference's
  state is immutable and needs no snapshot; the port's step updates the
  state in place, so the snapshot is taken before ``async_save`` returns.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

PyTree = Any
_SEP = "\x1f"  # key-path separator in flat file names

__all__ = ["async_save", "latest_step", "restore", "save"]


def _flatten(tree: PyTree, prefix: tuple = ()) -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {_SEP.join(prefix): tree}


def _unflatten(like: PyTree, flat: dict, prefix: tuple = ()) -> PyTree:
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, flat, prefix + (str(i),))
                          for i, v in enumerate(like))
    return flat[_SEP.join(prefix)]


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _write(directory: str, step: int, flat: dict, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), _host_array(leaf))
        manifest[key] = fname
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "arrays": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep)
    return final


def save(directory: str, step: int, state: PyTree, *, keep: int = 3) -> str:
    """Synchronous atomic checkpoint of ``state`` (a tree of tensors or
    arrays).  Returns the final path."""
    return _write(directory, step, _flatten(state), keep)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str, like: PyTree, step: int | None = None,
            device=None) -> tuple[PyTree, int]:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf takes its ``like`` leaf's dtype and device (or ``device`` when
    given).  Returns (state, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["arrays"]
    flat_like = _flatten(like)
    missing = set(flat_like) - set(manifest)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    flat = {}
    for key, ref in flat_like.items():
        t = torch.from_numpy(np.load(os.path.join(path, manifest[key])))
        flat[key] = t.to(device=device if device is not None else ref.device,
                         dtype=ref.dtype)
    return _unflatten(like, flat), step


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


# ---------------------------------------------------------------------------
# async checkpoint through the task graph
# ---------------------------------------------------------------------------
def _snapshot(state: PyTree):
    """Host copies of every leaf: for a CUDA tensor a pinned buffer filled
    by a copy enqueued on the current stream, for a CPU tensor a clone.
    Returns (flat copies, event recorded after the copies, or None)."""
    flat, cuda = {}, False
    for key, leaf in _flatten(state).items():
        t = leaf.detach()
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            cuda = True
        else:
            buf = t.clone()
        flat[key] = buf
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record()
    return flat, event


def async_save(executor, directory: str, step: int, state: PyTree,
               *, keep: int = 3):
    """Non-blocking checkpoint through a ``Heteroflow``: the snapshot
    (:func:`_snapshot`) is taken before this returns, and a host task on
    ``executor`` waits for its copies and writes the files.  Returns the
    graph's future."""
    from ..core import Heteroflow

    flat, event = _snapshot(state)

    def write():
        if event is not None:
            event.synchronize()
        return _write(directory, step, flat, keep)

    g = Heteroflow(f"ckpt_step{step}")
    g.host(write, name=f"ckpt_write_{step}")
    return executor.run(g)
