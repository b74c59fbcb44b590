"""A training cell: the train step driven as ``repro_torch.launch.train``
drives it.

Set-up draws the f32 master weights on the device from the seed, builds
the AdamW state and the step (a ``TrainStepGraph`` on the card: step 1
eager, then one captured graph), and runs the task graph of
``launch.train.train`` over an ``Executor``: host(data read) → pull
(tokens, labels) → kernel(train step) → host(metrics: a synchronise and
the loss on the host).  Steps 1-3 run through that same graph and feed
before the window; the program's readings for the comparison are taken
between them (the first clipped gradient from AdamW's ``m`` after step 1,
each leaf's change after step 3, against the weights drawn again from
the seed).  The window then runs whole steps of the same graph until
``seconds`` have passed: the rate is B·S × steps over the window, from
its start to the end of its last step.

After the window the program's state is freed and the plain reference
runs the first three steps from the same weights on the same batches
(:mod:`perfbench.check`); under the control, its fp8 twin stands in
the program's place.
"""
from __future__ import annotations

import gc
import time

import torch

from . import check, program
from .trace import Profiler, Spans
from .traffic import Batches

KERNELS = ("flash_attention", "flash_attention_bwd")
#: steps run before the window; the comparison reads the first three
FIRST_STEPS = 3


@torch.no_grad()
def _leaf_norms(ref, c: dict, tree: dict, scale: float = 1.0) -> list:
    return [float(torch.linalg.vector_norm(ref.get(tree, p).float()))
            * scale for p in ref.leaf_paths(c)]


@torch.no_grad()
def _delta_norms(ref, c: dict, params: dict, seed: int, dev) -> list:
    out = []
    for i, p in enumerate(ref.leaf_paths(c)):
        p0 = ref.redraw(c, seed, i, dev)
        out.append(float(torch.linalg.vector_norm(ref.get(params, p).float()
                                                  - p0)))
        del p0
    return out


class Loop:
    """launch.train's task graph over an executor, with the step counts
    the harness waits on."""

    def __init__(self, ex, step_fn, state: dict, pipe, spans, device):
        self.ex, self.state, self.spans = ex, state, spans
        self.losses: list[float] = []
        buffer: dict = {}
        hf = program.Heteroflow("train")
        _, pull_t, pull_l = pipe.host_task_graph(hf, buffer)

        def do_step(tokens, labels):
            with spans.span("train_step"):
                _, metrics = step_fn(self.state, {"tokens": tokens,
                                                  "labels": labels})
                return torch.stack([metrics["total_loss"],
                                    metrics["grad_norm"]])

        def metrics_sink():
            with spans.span("metrics"):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                loss, _ = kernel.result().tolist()
                self.losses.append(loss)

        kernel = hf.kernel(do_step, pull_t, pull_l, name="train_step")
        sink = hf.host(metrics_sink, name="metrics")
        kernel.succeed(pull_t, pull_l).precede(sink)
        self.graph = hf

    def run_until(self, predicate) -> None:
        self.ex.run_until(self.graph, predicate).result()


def run(ctx) -> dict:
    """Set up, measure and check one run of a training cell."""
    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    c, job = cell.config, cell.traffic
    ref = cell.reference()
    o = c["train"]["optimizer"]
    marks = [("start", ctx.t_proc), ("imports", time.monotonic())]
    program.build_kernels(KERNELS, dev)
    marks.append(("kernels", time.monotonic()))
    params = ref.draw_params(c, seed, dev, matmul_dtype=torch.float32)
    state = {"params": params, "opt": program.opt_state(params)}
    _sync(dev)
    marks.append(("weights and state", time.monotonic()))
    cfg = program.model_config(c)
    step_fn = program.train_step(c, cfg, state, dev)
    batches = Batches(job, seed, c["vocab_size"], fault=ctx.fault)
    spans = Spans(ctx.trace)
    batches.batch = spans.wrap("data_read", batches.batch)
    pipe = program.Pipeline(batches, program.PipelineConfig(
        batch=job["batch"], seq=job["seq"]))
    prof = Profiler(torch, dev, spans) if ctx.trace else None
    readings: dict = {}
    with program.Executor(num_workers=2, devices=[dev]) as ex:
        loop = Loop(ex, step_fn, state, pipe, spans, dev)
        loop.run_until(lambda: len(loop.losses) >= 1)
        marks.append(("step 1 and capture", time.monotonic()))
        readings["grad_norms"] = _leaf_norms(ref, c, state["opt"]["m"],
                                             1.0 / (1.0 - o["b1"]))
        loop.run_until(lambda: len(loop.losses) >= FIRST_STEPS)
        readings["delta_norms"] = _delta_norms(ref, c, state["params"], seed,
                                               dev)
        readings["losses"] = loop.losses[:FIRST_STEPS]
        _sync(dev)
        t0 = time.monotonic()
        marks.append((f"steps 2-{FIRST_STEPS} and readings", t0))
        ctx.log("set-up s: " + ", ".join(
            f"{n} {b - a:.4f}" for (_, a), (n, b) in zip(marks, marks[1:])))
        if prof is not None:
            prof.start()
        window = {"t1": None}

        def predicate() -> bool:
            # ends the window, or the traced part of it: the loop pauses
            # for the profiler to stop on this thread
            with spans.span("client"):
                n = len(loop.losses) - FIRST_STEPS
                now = time.monotonic()
                if now - t0 >= ctx.seconds:
                    window["t1"] = now
                    return True
                return (prof is not None and prof.running
                        and n >= job["trace_steps"])

        rest = (t0, FIRST_STEPS)        # the untraced part of the window
        while window["t1"] is None:
            loop.run_until(predicate)
            if prof is not None and prof.running:
                prof.stop()
                rest = (time.monotonic(), len(loop.losses))
        steps = len(loop.losses) - FIRST_STEPS
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = prof.read() if prof is not None else None
    seconds = window["t1"] - t0
    tokens = steps * job["batch"] * job["seq"]
    ctx.log(f"train steps in the window {steps} in {seconds} s; losses of "
            f"steps 1-{FIRST_STEPS} {readings['losses']}; last loss "
            f"{loop.losses[-1]}")
    out = {"e2e": {"setup_s": t0 - ctx.t_proc,
                   "train_tokens_per_s": tokens / seconds},
           "attempted": steps, "failed": 0, "memory_peak": peak,
           "trace": trace,
           "counters": {"window_s": seconds, "steps": steps,
                        "untraced_s": window["t1"] - rest[0],
                        "untraced_steps": len(loop.losses) - rest[1]}}
    del loop, step_fn, state, params, ex
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"], out["readings"] = _compare(ref, c, job, seed, dev,
                                              readings, cell.limits,
                                              ctx.control)
    return out


def _reference_run(ref, c, job, seed, dev, mode: str) -> dict:
    params = ref.draw_params(c, seed, dev, matmul_dtype=torch.float32)
    src = Batches(job, seed, c["vocab_size"])
    batches = []
    for k in range(FIRST_STEPS):
        b = src.batch_at(k)
        batches.append({n: torch.as_tensor(v, dtype=torch.long, device=dev)
                        for n, v in b.items()})
    out = ref.train_steps(c, c["train"]["optimizer"], params, batches,
                          mode=mode)
    out["delta_norms"] = _delta_norms(ref, c, params, seed, dev)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _compare(ref, c, job, seed, dev, prog, limits, control):
    """(checks, readings): the program's three steps against the
    reference's; with ``control`` the fp8 reference's in the program's
    place, the program's kept as a reading."""
    refr = _reference_run(ref, c, job, seed, dev, "f32")
    readings = {"program": prog, "reference": refr}
    if control:
        readings["program_numbers"] = check.trained(prog, refr)
        prog = readings["control"] = _reference_run(ref, c, job, seed, dev,
                                                    "fp8")
    return check.hold(check.trained(prog, refr), limits), readings


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
