"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake H100s.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell for 512 fake XLA devices, this traces one step of it
as one rank of a fake process group of 256 (or 512) ranks: the
parameters, train state, caches and batch are fake CUDA tensors
(``FakeTensorMode``: shapes and dtypes, no memory), distributed as
DTensors over the production mesh by the sharding rules
(``distributed/sharding.py``), and the step runs under the activation
rules.  Nothing is computed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch phi3-mini-3.8b --shape train_4k [--multi-pod] [--out results/]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/

Per cell this produces: the memory one card holds through the step
(``MemTracker`` over the rank's tensors: arguments, outputs, the peak of
temporaries; ``fits`` against the card's 80 GB), the per-device FLOPs,
bytes and collectives (``launch/op_cost.py``) and the three roofline
terms (``launch/roofline.py``) — persisted as JSON, one file per cell
(``summarize`` makes the tables).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs import LONG_CONTEXT_ARCHS, SHAPES, get_config, list_archs
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed import (batch_pspecs, cache_pspecs, param_pspecs,
                           state_pspecs, use_sharding_rules)
from ..distributed.sharding import P, axis_sizes, placements
from ..models import transformer
from ..training import AdamWConfig, cosine_schedule, trainer
from .op_cost import OpCost, RankMemTracker
from .roofline import Roofline, model_flops

__all__ = ["TRAIN_OVERRIDES", "SERVE_DTYPE", "HBM_BYTES", "Lowered",
           "block_shape", "fake_world", "input_specs", "lower_cell",
           "record_line",
           "run_cell", "serve_caches", "step_fn", "main"]

# per-arch training numerics of the reference's 256-chip cells (its
# DESIGN.md §6): the largest models keep bf16 params (and bf16 moments
# for llama4) to fit p+m+v; recorded per cell in the JSON
TRAIN_OVERRIDES: dict[str, dict] = {
    "deepseek-v2-236b": {"param_dtype": "bfloat16", "accum": 8},
    "llama4-maverick-400b-a17b": {"param_dtype": "bfloat16",
                                  "opt_dtype": "bfloat16", "accum": 8},
    "mistral-large-123b": {"accum": 4},
    "xlstm-1.3b": {"accum": 4},
    "minicpm-2b": {"accum": 2},
    "recurrentgemma-2b": {"accum": 2},
}
SERVE_DTYPE = torch.bfloat16   # inference weights are bf16 (standard)
#: the memory of one H100 SXM, as the data sheet gives it
HBM_BYTES = 80 * 10**9


def _apply_overrides(cfg: ModelConfig, kind: str) -> tuple[ModelConfig, dict]:
    ov = dict(TRAIN_OVERRIDES.get(cfg.arch_id, {})) if kind == "train" else {}
    if "param_dtype" in ov:
        cfg = dataclasses.replace(cfg, param_dtype=ov["param_dtype"])
    return cfg, ov


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs for one cell, as meta tensors."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    n_vis = cfg.n_visual_tokens if cfg.frontend == "vision_stub" else 0
    if shape.kind == "train":
        toks = S - n_vis
        batch = {"tokens": meta((B, toks), torch.int32),
                 "labels": meta((B, toks), torch.int32)}
        if n_vis:
            batch["extra_embeds"] = meta((B, n_vis, cfg.d_model),
                                         torch.bfloat16)
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": meta((B, S - n_vis), torch.int32)}
        if n_vis:
            batch["extra_embeds"] = meta((B, n_vis, cfg.d_model),
                                         torch.bfloat16)
        return batch
    # decode: one new token against a cache of S tokens
    return {"token": meta((B,), torch.int32)}


def _serve_param_specs(cfg: ModelConfig):
    return _map(lambda t: torch.empty(
        t.shape, device="meta",
        dtype=SERVE_DTYPE if t.is_floating_point() else t.dtype),
        transformer.param_specs(cfg))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _train_state(cfg, opt_dtype):
    state = trainer.train_state_specs(cfg)
    if opt_dtype != torch.float32:
        for key in ("m", "v"):
            state["opt"][key] = _map(
                lambda t: torch.empty(t.shape, dtype=opt_dtype,
                                      device="meta"), state["opt"][key])
    return state


def serve_caches(cfg, shape, device="meta"):
    """A serve cell's caches as the port runs them (on the meta device:
    shapes only), each attention sub-cache's ``length`` a host int — 0
    for a prefill, S − 1 for a decode step (its token is the cache's last
    row, and the decode kernel reads every row)."""
    caches = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    device=device)
    length = shape.seq_len - 1 if shape.kind == "decode" else 0
    for gc in caches:
        for sub in gc.values():
            if "length" in sub:
                sub["length"] = length
    return caches


# ---------------------------------------------------------------------------
# fake world and fake tensors
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0: every
    collective returns at once with its outputs' shapes.  A group already
    up is taken down first (the process has one default group); the fake
    one is taken down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the fake group's CUDA ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def block_device() -> str:
    """Where the fake blocks lie: CUDA where this build has it, else the
    meta device (a build without CUDA cannot index a fake CUDA tensor:
    its device guard needs the CUDA runtime).  Neither holds memory, and
    the kernels' custom ops take both."""
    return "cuda" if torch.cuda.is_available() else "meta"


def _distribute(mesh, like, spec: P):
    """A DTensor of ``like``'s global shape and dtype laid out as ``spec``
    on ``mesh``, over a fake tensor of this rank's block (its own
    storage: a view of a global tensor would be counted whole).  On a
    mesh of one rank the fake tensor itself, whole: a DTensor there holds
    the whole value, the kernels unwrap it and the rules act on none, so
    the step traced is the one a plain run makes.  A host int stays as
    it is."""
    if not isinstance(like, torch.Tensor):
        return like
    if mesh.size() == 1:
        return torch.empty(like.shape, dtype=like.dtype,
                           device=block_device())
    from torch.distributed.tensor import DTensor

    places = placements(mesh, spec, like.ndim)
    block = torch.empty(block_shape(like.shape, spec, axis_sizes(mesh)),
                        dtype=like.dtype, device=block_device())
    return DTensor.from_local(block, mesh, places, run_check=False,
                              shape=like.shape,
                              stride=torch.empty(like.shape,
                                                 device="meta").stride())


def block_shape(shape, spec: P, sizes: dict) -> tuple[int, ...]:
    """One rank's block of a tensor of ``shape`` laid out as ``spec`` over
    a mesh of axis ``sizes``: each dim divided by the ranks of the axes
    its entry names (the rules keep only axes that divide it)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for axis in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            out[dim] = -(-out[dim] // sizes[axis])
    return tuple(out)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (local blocks)."""
    seen, total = set(), 0
    for t in tensors:
        st = _local(t).untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


# ---------------------------------------------------------------------------
# per-cell trace
# ---------------------------------------------------------------------------
def step_fn(cfg: ModelConfig, shape: ShapeConfig, *, remat_policy: str =
            "full", accum: int = 1) -> Callable:
    """The function a cell runs once: ``step(state, batch)`` for train
    (``trainer.make_train_step``), ``step(params, batch, caches)`` for a
    prefill or a decode step."""
    if shape.kind == "train":
        opt = AdamWConfig(schedule=cosine_schedule(3e-4, 2000, 100_000))
        return trainer.make_train_step(cfg, opt, remat_policy=remat_policy,
                                       accum=accum)
    if shape.kind == "prefill":
        def prefill_step(params, batch, caches):
            return transformer.prefill(cfg, params, batch["tokens"], caches,
                                       extra_embeds=batch.get("extra_embeds"))
        return prefill_step

    def serve_step(params, batch, caches):
        return transformer.decode_step(cfg, params, batch["token"], caches)
    return serve_step


@dataclass
class Lowered:
    """One cell ready to trace: ``fn(*args)`` on fake DTensors over
    ``mesh``, under the activation rules ``rules``."""
    fn: Callable
    args: tuple
    mesh: Any
    rules: dict
    fake_mode: Any
    meta: dict

    def trace(self) -> tuple[Any, dict, Any]:
        """Run the step once under the trackers: (per-device cost, memory
        record, the step's outputs)."""
        from torch.distributed.tensor.experimental import \
            implicit_replication

        args = _leaves(self.args)
        arg_bytes = _storage_bytes(args)
        mem = RankMemTracker()
        mem.track_external(*(_local(t) for t in args))
        with self.fake_mode, use_sharding_rules(mesh=self.mesh,
                                                **self.rules), \
                implicit_replication(), mem, OpCost() as counter:
            out = self.fn(*self.args)
        peak = max(snap["Total"]
                   for snap in mem.get_tracker_snapshot("peak").values())
        outs = _leaves(out)
        out_bytes = _storage_bytes(outs)
        arg_ids = {_local(t).untyped_storage()._cdata for t in args}
        alias = _storage_bytes(t for t in outs if _local(t).untyped_storage()
                               ._cdata in arg_ids)
        memory = {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": peak - (arg_bytes + out_bytes - alias),
            "alias_bytes": alias,
            "per_device_total": peak,
        }
        return counter.cost, memory, out


def lower_cell(arch: str | ModelConfig, shape: str | ShapeConfig, mesh, *,
               remat_policy: str = "full", seq_shard: bool = True,
               extra_overrides: dict | None = None) -> tuple[Lowered, dict]:
    """Build fn + fake inputs + layouts for one cell on ``mesh`` (a
    ``DeviceMesh`` over the fake group).  ``arch`` is a name or a
    ``ModelConfig`` (a reduced one); ``shape`` a name of ``SHAPES`` or a
    ``ShapeConfig`` (a cell cut to fit one card).

    Returns (lowered, meta); tracing it is the caller's second step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg, ov = _apply_overrides(cfg, shape.kind)
    if extra_overrides:
        ov = dict(ov, **extra_overrides)
    accum = int(ov.get("accum", 1))
    opt_dtype = getattr(torch, ov.get("opt_dtype", "float32"))
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    meta = {
        "arch": cfg.arch_id, "shape": shape.name, "kind": shape.kind,
        "overrides": {k: str(v) for k, v in ov.items()},
        "mesh": sizes,
        "chips": int(mesh.size()),
        "seq_shard": seq_shard,
    }
    rules = {"seq_shard": seq_shard,
             "decode_tp": (shape.kind == "decode"
                           and not ov.get("no_decode_tp"))}
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    batch_like = input_specs(cfg, shape)
    with fake_mode:
        bspec = batch_pspecs(cfg, shape, mesh, batch_like)
        batch = _map2(lambda t, s: _distribute(mesh, t, s), batch_like,
                      bspec)
        if shape.kind == "train":
            state_like = _train_state(cfg, opt_dtype)
            sspec = state_pspecs(cfg, state_like, mesh)
            state = _map2(lambda t, s: _distribute(mesh, t, s), state_like,
                          sspec)
            args = (state, batch)
        else:
            params_like = _serve_param_specs(cfg)
            pspec = param_pspecs(cfg, params_like, mesh)
            params = _map2(lambda t, s: _distribute(mesh, t, s),
                           params_like, pspec)
            cache_like = serve_caches(cfg, shape)
            cspec = cache_pspecs(cfg, cache_like, mesh)
            caches = _map2(lambda t, s: _distribute(mesh, t, s), cache_like,
                           cspec)
            args = (params, batch, caches)
    fn = step_fn(cfg, shape, remat_policy=remat_policy, accum=accum)
    return Lowered(fn, args, mesh, rules, fake_mode, meta), meta


def run_cell(arch: str | ModelConfig, shape: str | ShapeConfig, *,
             multi_pod: bool =
             False, remat_policy: str = "full", seq_shard: bool = True,
             extra_overrides: dict | None = None,
             mesh_shape: tuple[int, ...] | None = None) -> dict:
    """Trace one cell; return the full result record.  The mesh is the
    production one (16×16, or 2×16×16 ``multi_pod``) over a fake group of
    as many ranks, or ``mesh_shape`` ((data, model) or (pod, data,
    model)) for a smaller one."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    chips = 1
    for n in mesh_shape:
        chips *= n
    with fake_world(chips):
        t0 = time.time()
        mesh = fake_mesh(mesh_shape, axes)
        lowered, meta = lower_cell(arch, shape, mesh,
                                   remat_policy=remat_policy,
                                   seq_shard=seq_shard,
                                   extra_overrides=extra_overrides)
        t1 = time.time()
        cost, memory, _ = lowered.trace()
        t2 = time.time()

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape_cfg = SHAPES[shape] if isinstance(shape, str) else shape
    mf = model_flops(cfg, shape_cfg)
    roof = Roofline(
        flops=cost.flops,
        hbm_bytes=cost.bytes,
        coll_bytes=cost.coll_ring_bytes,
        chips=chips,
        model_flops_per_chip=mf / chips,
        coll_s=cost.coll_s,
    )
    return {
        **meta,
        "multi_pod": multi_pod,
        "remat_policy": remat_policy,
        "lower_s": round(t1 - t0, 2),
        "trace_s": round(t2 - t1, 2),
        "memory": memory,
        "fits": memory["per_device_total"] <= HBM_BYTES,
        "collectives": {
            "counts": {k: round(v) for k, v in cost.coll_counts.items()},
            "raw_bytes": cost.coll_raw_bytes,
            "ring_bytes_per_dev": cost.coll_ring_bytes,
        },
        "eager_op_cost": {   # the un-fused count, as it stands
            "flops": cost.flops,
            "bytes_accessed": cost.bytes,
        },
        "roofline": roof.to_dict(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=list_archs())
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true",
                   help="run single-pod AND multi-pod for each cell")
    p.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    p.add_argument("--out", default="results")
    args = p.parse_args(argv)

    cells_: list[tuple[str, str]] = []
    if args.all:
        from ..configs import cells
        cells_ = cells()
    else:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required unless --all")
        if (args.shape == "long_500k"
                and args.arch not in LONG_CONTEXT_ARCHS):
            print(f"SKIP {args.arch}×long_500k: full-attention arch "
                  f"(DESIGN.md §5)")
            return 0
        cells_ = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, shape in cells_:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
            out_path = os.path.join(args.out, tag + ".json")
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               remat_policy=args.remat)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(record_line(tag, rec), flush=True)
            except Exception as e:  # noqa: BLE001
                failures += 1
                with open(out_path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
    return 1 if failures else 0


def record_line(tag: str, rec: dict) -> str:
    """The one-line summary ``main`` prints for a traced cell."""
    r = rec["roofline"]
    return (f"OK   {tag}: trace={rec['trace_s']}s "
            f"mem/dev={rec['memory']['per_device_total']/2**30:.2f}GiB "
            f"bound={r['bottleneck']} "
            f"t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
            f"{r['t_collective_s']:.2e})s")


if __name__ == "__main__":
    sys.exit(main())
