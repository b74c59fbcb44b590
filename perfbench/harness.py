"""One run of one cell: set up, measure, check, print.

:func:`run_cell` runs a cell on a device and returns the result's
fields; :func:`main` is the command's body on the card: it prints the
card's name, power limit and clocks first, and the result's JSON object
as the last line of standard output, each number compared beside its
limit as the last lines of standard error.  No result is printed, and
the exit code is not 0, if the run fails, or if JAX or the JAX package
was loaded in this process by the time the window closed.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from dataclasses import dataclass, field

import torch

from . import check, spec

#: modules no run may load, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def eprint(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Ctx:
    """What a cell's runner is given."""
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_proc: float
    control: bool = False
    fault: str | None = None
    rate: float | None = None
    log: object = eprint


@dataclass
class Run:
    """What a per-layer metric's reader reads."""
    workload: str
    config: dict
    traffic: dict
    trace: object
    counters: dict = field(default_factory=dict)


def forbidden_modules(names=None) -> list[str]:
    """Of ``names`` (default: the loaded modules), the forbidden top-level
    names, compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules if names is None
                                              else names)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(ctx: Ctx) -> dict:
    """The result's fields of one run (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, optionally ``breakdown``, and
    ``check`` last), plus ``readings`` for the log."""
    kind = ctx.cell.traffic["kind"]
    if kind == "train":
        from . import train as runner
    elif kind in ("closed_loop", "open_loop"):
        from . import serve as runner
    else:
        raise ValueError(f"traffic kind {kind!r}")
    out = runner.run(ctx)
    trace = out["trace"]
    if ctx.trace:
        run = Run(ctx.cell.name, ctx.cell.config, ctx.cell.traffic, trace,
                  out["counters"])
        metrics = {}
        for m in ctx.cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in ctx.cell.end_to_end}
    device = {"platform": "gpu" if ctx.device.type == "cuda"
              else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": ctx.cell.chips,
              "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": check.within(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in out["checks"].items()}
    result["readings"] = out["readings"]
    return result


def card_report(device) -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads
    them."""
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        smi = q.stdout.strip() or q.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi not read: {e}"
    return (f"card {torch.cuda.get_device_name(device)}; nvidia-smi name, "
            f"power limit, SM clock, max SM clock, memory clock, "
            f"temperature: {smi}")


def _json_number(v):
    return v if not isinstance(v, float) or math.isfinite(v) else str(v)


def main(args, t_proc: float) -> int:
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        eprint(f"{cell.name} needs {cell.chips} CUDA device(s); found "
               f"{found}: no measurement without the card")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    eprint(card_report(device))
    eprint(f"cell {cell.name}: config {cell.config_name}, traffic "
           f"{cell.traffic_name}, seed {args.seed}, {args.seconds} s, "
           f"trace {args.trace}")
    ctx = Ctx(cell, args.seed, float(args.seconds), bool(args.trace), device,
              t_proc, control=bool(args.control), fault=args.fault,
              rate=args.rate)
    result = run_cell(ctx)
    bad = forbidden_modules()
    if bad:
        eprint(f"forbidden modules loaded in this process: {bad}")
        return 3
    readings = result.pop("readings")
    eprint("readings: " + json.dumps(readings, default=_json_number))
    eprint(card_report(device))
    for k, c in result["check"].items():
        eprint(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    result["check"] = {k: {kk: _json_number(vv) for kk, vv in c.items()}
                       for k, c in result["check"].items()}
    print(json.dumps(result), flush=True)
    return 0
