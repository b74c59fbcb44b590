"""Training launcher for ``--arch <id>`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 5 --reduced --device cpu

Runs on CUDA by default (``--device cpu`` for the CPU).  The loop is the
reference's task graph (``repro.launch.train``): host(data read) →
pull(tokens, labels) → kernel(train step) → host(metrics), iterated by
an :class:`Executor` over the device with ``run_until``; checkpoints are
written through :func:`checkpoint.async_save`.  Weights are random, drawn
from a seeded ``torch.Generator``; batches come from ``SyntheticSource``.
WSD for minicpm-2b, cosine otherwise.  As the reference's launcher,
:func:`main` runs under the sharding rules over the 1×1 smoke mesh on the
device (a one-rank process group: NCCL on the card, gloo on the CPU);
on one rank every rule is the identity, so the steps are those of
:func:`train` alone.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, list_archs, reduced as reduce_cfg
from ..core import Executor, Heteroflow
from ..data import Pipeline, PipelineConfig, SyntheticSource
from ..distributed import use_sharding_rules
from ..distributed.sharding import axis_sizes
from ..models.transformer import REMAT_POLICIES
from ..training import (AdamWConfig, checkpoint, cosine_schedule,
                        init_train_state, make_train_step, wsd_schedule)
from .mesh import make_smoke_mesh

__all__ = ["main", "train"]


def train(cfg, *, steps: int, batch: int, seq: int, device: torch.device,
          remat: str = "full", ckpt_dir: str | None = None,
          ckpt_every: int = 100, resume: bool = False,
          seed: int = 0) -> dict:
    """Train ``cfg`` for ``steps`` steps on ``device`` through the task
    graph.  Returns ``{"losses", "grad_norms", "step_seconds", "seconds",
    "state"}``: per-step total loss and gradient norm (floats),
    each step's wall time from the kernel task's start to its loss on the
    host, the whole run's seconds and the final state."""
    sched = (wsd_schedule(3e-4, 100, max(steps - 200, 100), 100)
             if cfg.arch_id == "minicpm-2b"
             else cosine_schedule(3e-4, 100, max(steps, 1000)))
    opt = AdamWConfig(schedule=sched)
    state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    step_fn = make_train_step(cfg, opt, remat_policy=remat)
    start = 0
    if resume and ckpt_dir and checkpoint.latest_step(ckpt_dir) is not None:
        state, start = checkpoint.restore(ckpt_dir, state)
        print(f"resumed from step {start}", flush=True)

    pipe = Pipeline(SyntheticSource(cfg.vocab_size, seed=seed),
                    PipelineConfig(batch=batch, seq=seq))
    buffer: dict = {}
    losses: list[float] = []
    grad_norms: list[float] = []
    step_seconds: list[float] = []
    box = {"state": state, "t0": 0.0}
    futs = []

    hf = Heteroflow("train")
    _, pull_t, pull_l = pipe.host_task_graph(hf, buffer)

    def do_step(tokens, labels):
        box["t0"] = time.perf_counter()
        box["state"], metrics = step_fn(
            box["state"], {"tokens": tokens, "labels": labels})
        n = start + len(losses) + 1
        if ckpt_dir and n % ckpt_every == 0:
            # on this (the step's) stream: the snapshot's copies run
            # before the next step changes the state
            futs.append(checkpoint.async_save(ex, ckpt_dir, n, box["state"]))
        return torch.stack([metrics["total_loss"], metrics["grad_norm"]])

    def metrics_sink():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        loss, gnorm = kernel.result().tolist()
        step_seconds.append(time.perf_counter() - box["t0"])
        losses.append(loss)
        grad_norms.append(gnorm)
        print(f"step {start + len(losses)}: loss={loss:.4f} "
              f"grad_norm={gnorm:.4f} ({step_seconds[-1]:.3f} s)", flush=True)

    kernel = hf.kernel(do_step, pull_t, pull_l, name="train_step")
    sink = hf.host(metrics_sink, name="metrics")
    kernel.succeed(pull_t, pull_l).precede(sink)

    t0 = time.perf_counter()
    with Executor(num_workers=2, devices=[device]) as ex:
        ex.run_until(hf, lambda: len(losses) >= steps).result()
        for f in futs:
            f.result(timeout=600)
    seconds = time.perf_counter() - t0
    return {"losses": losses, "grad_norms": grad_norms,
            "step_seconds": step_seconds, "seconds": seconds,
            "state": box["state"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=list_archs(), required=True)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--reduced", action="store_true",
                   help="smoke-size config")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--remat", choices=REMAT_POLICIES, default=None,
                   help="default: none with --reduced, else full")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    remat = args.remat or ("none" if args.reduced else "full")
    device = torch.device(args.device)
    print(f"device={device} arch={cfg.arch_id} remat={remat}", flush=True)
    mesh = make_smoke_mesh(device)
    print(f"devices={mesh.size()} mesh={axis_sizes(mesh)}", flush=True)
    with use_sharding_rules(mesh=mesh):
        out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                    device=device, remat=remat, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, resume=args.resume)
    losses, dt = out["losses"], out["seconds"]
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:,.0f} tok/s); "
          f"loss {losses[0]:.3f} → {losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
