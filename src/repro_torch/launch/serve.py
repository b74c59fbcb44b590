"""Serving launcher: continuous batching engine for ``--arch <id>``.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3-mini-3.8b --requests 8

Runs on CUDA by default (``--device cpu`` for the CPU); the engine's
ticks run as task-graph iterations of an :class:`Executor` over the
device.  Weights are random, drawn from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np
import torch

from ..configs import ModelConfig, get_config, list_archs, reduced as reduce_cfg
from ..core import Executor
from ..models import init_params
from ..serving import ServingEngine
from ..serving.graphs import BucketPrefillGraphs

__all__ = ["graph_report", "serve", "main"]


def serve(cfg: ModelConfig, params, prompts: Sequence[np.ndarray], *,
          device: torch.device, slots: int = 4, max_seq: int = 128,
          max_new: int = 8) -> tuple[ServingEngine, list, float]:
    """Serve ``prompts`` to completion through an :class:`Executor` over
    ``device``; returns the engine, its completed requests and the
    seconds the run took.  The clock starts once the executor and the
    engine are built (weights cast, caches allocated, the device idle)
    and stops after the device finished."""
    with Executor(num_workers=2, devices=[device]) as ex:
        eng = ServingEngine(cfg, params, max_slots=slots, max_seq=max_seq,
                            executor=ex, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for prompt in prompts:
            eng.submit(np.asarray(prompt, np.int32), max_new_tokens=max_new)
        done = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    return eng, done, seconds


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=list_archs(), required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=4 + i % 9)
               for i in range(args.requests)]
    eng, done, dt = serve(cfg, params, prompts, device=device,
                          slots=args.slots, max_seq=args.max_seq,
                          max_new=args.max_new)
    toks = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests / {toks} tokens in {dt:.2f}s; "
          f"stats={eng.stats()}")
    print(graph_report(eng))
    return 0


def graph_report(eng: ServingEngine) -> str:
    """One line on the engine's CUDA graphs: the decode graphs' and the
    prefill graphs' (a ladder or buckets) capture seconds and replays, or
    that both are eager (on the CPU)."""
    dec, pre = eng.decode_graphs, eng.prefill_graphs
    if dec is None:
        return "graphs: none (eager prefill and decode)"
    line = (f"decode graphs: {len(dec.slots)} captured in "
            f"{dec.capture_seconds:.3f}s, {dec.replays} replays; ")
    if pre is None:
        return line + "prefill eager"
    if isinstance(pre, BucketPrefillGraphs):
        return line + (f"prefill graphs: buckets {pre.sizes[0]}-"
                       f"{pre.sizes[-1]} x {len(pre.slots)} slots captured "
                       f"in {pre.capture_seconds:.3f}s, {pre.prefills} "
                       f"prefills in {pre.bucket_tokens} bucket rows")
    return line + (f"prefill graphs: rungs 2-{pre.top} x {len(pre.slots)} "
                   f"slots captured in {pre.capture_seconds:.3f}s, "
                   f"{pre.prefills} prefills in {pre.replays} chunk "
                   f"replays + {pre.decode_chunks} one-token chunks")


if __name__ == "__main__":
    raise SystemExit(main())
