"""Sharding rules: param/batch/cache specs per (config × mesh).

The port of ``repro.distributed.sharding``; the rules are the
reference's, MaxText-style fsdp+tensor:

* batch dims            → ``("pod", "data")`` (pure DP across pods)
* attention heads, d_ff, experts, vocab → ``"model"`` (TP / EP)
* the *other* big dim of each weight    → ``"data"``  (FSDP / ZeRO-3)
* KV heads with n_kv < |model|          → replicated (Megatron practice)

Every rule passes a divisibility guard: an axis that does not divide the
dim is dropped (replicated).  Optimizer state inherits the param spec;
scalars replicate.

A spec is a :class:`P`, a tuple with one entry per leading tensor dim:
a mesh axis name, a tuple of names, or None (the reference's
``PartitionSpec``).  The rules read a mesh's axis names and sizes only,
through :func:`axis_sizes`, so they run on a ``DeviceMesh`` or on a
shape-only stand-in with the reference's ``axis_names`` and
``devices.shape``.  :func:`named` maps specs to DTensor ``Shard`` /
``Replicate`` placements on a live mesh.  Trees are the port's nested
dicts and lists; a leaf is anything with a ``shape`` (a tensor, a meta
tensor from ``transformer.param_specs``); a host int (a cache's
``length``) is a scalar and replicates.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig

__all__ = ["P", "BATCH_AXES", "axis_sizes", "param_pspecs", "state_pspecs",
           "batch_pspecs", "cache_pspecs", "named", "placements",
           "tree_paths", "local_block", "as_like"]

BATCH_AXES = ("pod", "data")   # present axes are used; missing are skipped


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def axis_sizes(mesh: Any) -> dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` or of a stand-in with
    ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _batch_axes(mesh: Any) -> tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in BATCH_AXES if a in names)


def _guard(spec: P, shape: tuple[int, ...], mesh: Any) -> P:
    """Drop mesh axes that don't divide their dim."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        total = int(np.prod([sizes[n] for n in names]))
        if i < len(shape) and shape[i] % total == 0:
            out.append(entry)
        else:
            out.append(None)
    return P(*out)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def tree_paths(tree: Any, prefix: tuple[str, ...] = ()) -> list:
    """``(path, leaf)`` of every leaf of a nested dict/list tree, paths
    as the reference names them (dict keys, list indices as strings)."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in tree_paths(v, (*prefix, str(k)))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, (*prefix, str(i)))]
    return [(prefix, tree)]


def _map_paths(fn: Callable, tree: Any, prefix: tuple[str, ...] = ()) -> Any:
    """The tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, (*prefix, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_paths(fn, v, (*prefix, str(i)))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
def _param_rule(cfg: ModelConfig, path: tuple[str, ...],
                shape: tuple[int, ...], mesh: Any) -> P:
    name = path[-1]
    in_groups = path and path[0] == "groups"
    ndim = len(shape)
    lead = ndim - (3 if _is_expert(path) else 2)  # scan/stack dims
    sizes = axis_sizes(mesh)

    def with_lead(*spec_tail):
        return P(*([None] * max(lead, 0)), *spec_tail)

    kv_shardable = (cfg.n_kv_heads * cfg.head_dim_) % sizes.get(
        "model", 1) == 0 and cfg.n_kv_heads >= sizes.get("model", 1)

    if name == "embed":
        return P("model", "data")
    if name == "lm_head":
        return P("data", "model")
    if _is_expert(path):
        # experts (E, d, f) / (E, f, d): EP over model, FSDP over the
        # d_model dim
        if name in ("w_gate", "w_up"):
            return with_lead("model", "data", None)
        if name == "w_down":
            return with_lead("model", None, "data")
    if name == "router":
        return with_lead("data", None)
    if name in ("w_gate", "w_up"):            # dense SwiGLU
        return with_lead("data", "model")
    if name == "w_down":
        return with_lead("model", "data")
    if name == "wq":
        return with_lead("data", "model")
    if name in ("wk", "wv"):
        return with_lead("data", "model" if kv_shardable else None)
    if name == "wo":
        return with_lead("model", "data")
    # MLA
    if name in ("w_dkv", "w_krope", "w_dq"):
        return with_lead("data", None)
    if name in ("w_uk", "w_uv", "w_uq"):
        return with_lead(None, "model")
    # recurrent / xlstm
    if name in ("w_x",):
        return with_lead("data", "model")
    if name == "w_out":
        return with_lead("model", "data")
    if name == "w_in":
        return with_lead("data", "model")
    if name == "w_up" and in_groups:
        return with_lead("data", "model")
    # generic fallback: FSDP the largest dim
    if ndim >= 2:
        body = [None] * ndim
        big = int(np.argmax(shape[max(lead, 0):])) + max(lead, 0)
        body[big] = "data"
        return _guard(P(*body), shape, mesh)
    return P(*([None] * ndim))


def _is_expert(path: tuple[str, ...]) -> bool:
    return "experts" in path


def param_pspecs(cfg: ModelConfig, params_like: Any, mesh: Any) -> Any:
    """Spec tree matching ``params_like`` (tensors or meta tensors)."""
    def rule(path, leaf):
        shape = _shape(leaf)
        return _guard(_param_rule(cfg, path, shape, mesh), shape, mesh)

    return _map_paths(rule, params_like)


def state_pspecs(cfg: ModelConfig, state_like: Any, mesh: Any) -> Any:
    """Train-state specs: params + opt {m, v} share the param layout
    (ZeRO: optimizer state sharded exactly like its param); step scalar
    replicates."""
    pspec = param_pspecs(cfg, state_like["params"], mesh)
    return {
        "params": pspec,
        "opt": {
            "m": param_pspecs(cfg, state_like["opt"]["m"], mesh),
            "v": param_pspecs(cfg, state_like["opt"]["v"], mesh),
            "step": P(),
        },
    }


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------
def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                 batch_like: Any) -> Any:
    """Shard batch dims over (pod, data) when divisible; replicate
    otherwise (long_500k's global_batch=1)."""
    baxes = _batch_axes(mesh)

    def rule(path, leaf):
        leaf_shape = _shape(leaf)
        spec = [None] * len(leaf_shape)
        if len(leaf_shape) >= 1:
            spec[0] = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)
        return _guard(P(*spec), leaf_shape, mesh)

    return _map_paths(rule, batch_like)


def cache_pspecs(cfg: ModelConfig, cache_like: Any, mesh: Any) -> Any:
    """Decode-cache specs.  Dim 0 is the layer stack; dim 1 the request
    batch (→ pod/data when divisible).  When batch replicates
    (long_500k), shard the largest remaining divisible dim over
    ``model`` — e.g. mLSTM's (…, dh, dh) matrix memory."""
    baxes = _batch_axes(mesh)
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)

    def rule(path, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd <= 1:
            return P(*([None] * nd))
        spec = [None] * nd
        bdim = 1 if nd >= 2 else 0
        btotal = int(np.prod([sizes[a] for a in baxes])) if baxes else 1
        if baxes and shape[bdim] % btotal == 0:
            spec[bdim] = baxes if len(baxes) > 1 else baxes[0]
        # shard one more big dim over model for memory (KV heads·hd or dh)
        rest = [(i, s) for i, s in enumerate(shape)
                if i > bdim and spec[i] is None]
        rest.sort(key=lambda t: -t[1])
        for i, s in rest:
            if s % model == 0 and s >= model:
                spec[i] = "model"
                break
        return _guard(P(*spec), shape, mesh)

    return _map_paths(rule, cache_like)


# ---------------------------------------------------------------------------
# specs on a live mesh
# ---------------------------------------------------------------------------
def placements(mesh: Any, spec: P, ndim: int | None = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``), one
    per mesh dim: ``Shard(i)`` on every mesh axis that tensor dim ``i``'s
    entry names, ``Replicate()`` on the others.  Raises when an axis is
    named twice, the mesh lacks it, or the spec is longer than ``ndim``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    seen: set = set()
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec!r} is longer than the tensor's "
                         f"{ndim} dims")
    for dim, entry in enumerate(spec):
        for axis in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            if axis not in names:
                raise ValueError(f"spec {spec!r} names axis {axis!r}; the "
                                 f"mesh has {names}")
            if axis in seen:
                raise ValueError(f"spec {spec!r} names axis {axis!r} twice")
            seen.add(axis)
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def named(mesh: Any, spec_tree: Any) -> Any:
    """The spec tree with each :class:`P` replaced by its DTensor
    placements on ``mesh`` (``distribute_tensor(t, mesh, placements)``)."""
    if isinstance(spec_tree, P):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    raise TypeError(f"not a spec: {spec_tree!r}")


def local_block(x: Any, mesh: Any, spec: P) -> Any:
    """This rank's block of ``x`` laid out as ``spec`` on ``mesh`` — the
    view a per-rank body (the reference's shard_map) reads.  A DTensor is
    redistributed to ``spec``'s placements and its local tensor returned
    (the same storage: writes to it are writes to the DTensor); a plain
    tensor is taken as this rank's block already."""
    from ..core.streams import is_dtensor
    if is_dtensor(x):
        return x.redistribute(mesh, placements(mesh, spec, x.ndim)).to_local()
    return x


def as_like(block: Any, like: Any, mesh: Any, spec: P) -> Any:
    """A per-rank body's output ``block`` in the kind of input ``like``: a
    DTensor of ``spec``'s placements on ``mesh`` when ``like`` is one,
    else the plain block."""
    from ..core.streams import is_dtensor
    if not is_dtensor(like):
        return block
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block, mesh, placements(mesh, spec, block.ndim),
                              run_check=False)
