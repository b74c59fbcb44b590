"""End-to-end training driver on the PyTorch port: a ~100M-param LM
trained through the hetflow task graph (host data → pull → train kernel
→ metric sink), with periodic async checkpoints overlapping compute, on
a CUDA card by default.

Defaults are a ~20M model and 50 steps; ``--full`` runs the ~100M /
300-step configuration (same code path, more FLOPs).

    PYTHONPATH=src python examples_torch/train_lm.py [--full] [--steps N]
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 5

The step is the port's eager ``make_train_step(..., remat_policy="none")``
(f32 master weights, bf16 compute, the hand-written flash kernels
forward and backward on the card); it is not compiled.  Each
checkpoint's snapshot is taken inside the step's kernel task, on the
step's stream, so its copies are queued before the next step updates
the state in place; the files are written by a host task on the same
executor while the next steps run.  The metric sink reads the loss with
``KernelTask.host_result()``, which waits for the step's ready event
(the executor's streams do not wait on the default stream).

:func:`main` returns the per-step losses, the run's seconds, the latest
checkpoint step and the final state.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LayerGroup  # noqa: E402
from repro_torch.core import Executor, Heteroflow  # noqa: E402
from repro_torch.data import Pipeline, PipelineConfig, SyntheticSource  # noqa: E402
from repro_torch.training import (AdamWConfig, checkpoint, init_train_state,  # noqa: E402
                                  make_train_step, wsd_schedule)


def small_lm(d_model: int, n_layers: int, vocab: int = 8192):
    """A llama-style config scaled to the requested size."""
    base = get_config("phi3-mini-3.8b")
    return dataclasses.replace(
        base, arch_id=f"lm-{d_model}x{n_layers}",
        d_model=d_model, n_heads=max(4, d_model // 64),
        n_kv_heads=max(4, d_model // 64), d_ff=d_model * 4,
        vocab_size=vocab, head_dim=64,
        groups=(LayerGroup(pattern=("attn",), count=n_layers,
                           ffn="dense"),))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true",
                   help="~100M params / 300 steps (the deliverable config)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "hetflow_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--device", default="cuda",
                   help="the device the model trains on (cuda or cpu)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    if args.full:
        cfg = small_lm(768, 12)          # ≈100M params
        steps = args.steps or 300
    else:
        cfg = small_lm(320, 6)           # ≈20M params
        steps = args.steps or 50
    n_params = cfg.param_count()
    print(f"model {cfg.arch_id}: {n_params / 1e6:.1f}M params, "
          f"{steps} steps, batch {args.batch}×{args.seq}")

    state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    opt = AdamWConfig(schedule=wsd_schedule(3e-4, 20, steps - 40, 20))
    step_fn = make_train_step(cfg, opt, remat_policy="none")

    pipe = Pipeline(SyntheticSource(cfg.vocab_size),
                    PipelineConfig(batch=args.batch, seq=args.seq))
    buffer: dict = {}
    losses: list[float] = []
    box = {"state": state}
    ckpt_futs = []
    t0 = time.time()

    # the paper's decomposition: host(read) → pull(batch) → kernel(step)
    #                                              ↘ push(metrics)/ckpt
    hf = Heteroflow("train")
    host, pull_t, pull_l = pipe.host_task_graph(hf, buffer)

    def do_step(tokens, labels):
        box["state"], metrics = step_fn(box["state"],
                                        {"tokens": tokens, "labels": labels})
        n = len(losses) + 1
        if n % args.ckpt_every == 0:
            # async checkpoint via a host task on the executor — overlaps
            # the next train steps (paper §III-A.3)
            ckpt_futs.append(checkpoint.async_save(
                ex, args.ckpt_dir, n, box["state"]))
        return metrics["total_loss"]

    kernel = hf.kernel(do_step, pull_t, pull_l, name="train_step")

    def collect():
        losses.append(float(kernel.host_result()))
        n = len(losses)
        if n % 10 == 0:
            tok_s = n * args.batch * args.seq / (time.time() - t0)
            print(f"step {n:4d}  loss {losses[-1]:.4f}  {tok_s:,.0f} tok/s",
                  flush=True)

    sink = hf.host(collect, name="metrics")
    kernel.succeed(pull_t, pull_l).precede(sink)

    with Executor(num_workers=2, devices=[device]) as ex:
        ex.run_until(hf, lambda: len(losses) >= steps).result()
        for f in ckpt_futs:
            f.result(timeout=600)

    dt = time.time() - t0
    latest = checkpoint.latest_step(args.ckpt_dir)
    print(f"done: {steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} → {losses[-1]:.3f}; "
          f"checkpoints at {args.ckpt_dir} (latest step {latest})")
    assert losses[-1] < losses[0], "loss should decrease"
    return {"losses": losses, "seconds": dt, "latest_step": latest,
            "steps": steps, "cfg": cfg, "state": box["state"]}


if __name__ == "__main__":
    main()
