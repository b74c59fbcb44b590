"""Where the executor's host time per task goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.probe_executor \
        [--live 0,20000,100000,200000] [--calls 5000] \
        [--dag-cells 5000] [--dag-workers 1,4] [--gc-cells 100000]

Three probes, each skipped when its count is empty or 0.

Live state.  A propagation DAG keeps, until its run ends, a recorded event, a small
device tensor and a few Python objects for every task (the lanes'
in-flight records, the pull buffers, the arrivals, the nodes' state).
For each count N of ``--live`` this keeps N recorded events, N 0-d f64
tensors on the card and N small Python dicts alive, then times, on one
thread, ``--calls`` rounds of the calls a DAG cell makes: the device
scope on a lane's copy stream, a pinned 256-byte host-to-device copy
(the executor's ``_pinned`` and ``to``), ``Event()`` and ``record``, and
on the compute stream ``torch.maximum`` and ``torch.add`` of 0-d
tensors.  It prints host µs per call and the seconds one full
``gc.collect()`` takes with that much alive.  At 0 live, these are the
calls alone, the yardstick for the next probe.

Calls inside a run.  The propagation DAG of ``--dag-cells`` cells, as
the timing-analysis twin (``examples_torch/timing_analysis.py`` of the
checkout beside ``src/``) builds and runs it: once untimed at 1 worker
(the process's first run, its wall µs per task printed), then at each
worker count of ``--dag-workers`` with every torch call a cell makes
timed from inside the run (a wrapper around each, removed after the
run): host µs per call, calls, and thread-seconds per second of the
run.  Then the same
DAG at 1 worker under ``torch.profiler``: the device's busy time over
the run's wall (the profiler slows the host, so the idle share is an
upper bound).

Memory and the collector.  One untimed DAG of ``--gc-cells`` cells at 1
worker: wall µs per task, the host's resident set before the graph is
built and after the run, the collections the cyclic garbage collector
made and their seconds, ``max_memory_allocated`` and the caching
pinned-host allocator's counts after it.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..core.executor import _pinned
from ..core.streams import ScopedDeviceContext

__all__ = ["main"]


def _rounds(dev, calls: int) -> dict[str, float]:
    """Host µs per call of a DAG cell's calls, ``calls`` rounds."""
    copy, compute = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    a = torch.ones((), dtype=torch.float64, device=dev)
    host = np.ones(32, np.float64)
    acc = dict.fromkeys(("scope enter+exit", "_pinned + to", "Event+record",
                         "torch.maximum", "torch.add"), 0)
    keep = []                     # as a DAG run keeps its buffers and events
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        with ScopedDeviceContext(dev, copy):
            t1 = time.perf_counter_ns()
            buf = _pinned(host).to(dev, non_blocking=True)
            t2 = time.perf_counter_ns()
            ev = torch.cuda.Event()
            ev.record(copy)
            t3 = time.perf_counter_ns()
        t4 = time.perf_counter_ns()
        with ScopedDeviceContext(dev, compute):
            compute.wait_event(ev)
            t5 = time.perf_counter_ns()
            m = torch.maximum(a, a)
            t6 = time.perf_counter_ns()
            out = torch.add(m, buf[0], alpha=2.5)
            t7 = time.perf_counter_ns()
        keep.append((buf, ev, out))
        acc["scope enter+exit"] += (t1 - t0) + (t4 - t3)
        acc["_pinned + to"] += t2 - t1
        acc["Event+record"] += t3 - t2
        acc["torch.maximum"] += t6 - t5
        acc["torch.add"] += t7 - t6
    torch.cuda.synchronize(dev)
    return {k: v / calls / 1e3 for k, v in acc.items()}


def _timing_analysis():
    """The timing-analysis twin of the checkout this package lies in."""
    root = str(Path(__file__).resolve().parents[3])
    if root not in sys.path:
        sys.path.insert(0, root)
    import examples_torch.timing_analysis as ta
    return ta


def _dag(ta, cells: int, workers: int, per_view: int = 100) -> dict:
    """One run of the propagation DAG of ``cells`` cells on ``cuda``."""
    return ta.main(["--views", str(cells // per_view), "--cells-per-view",
                    str(per_view), "--workers", str(workers)])[0]


def _timed(owner, name: str, label: str, acc: dict):
    """Replace ``owner.name`` by a wrapper adding each call's host ns and
    count to ``acc[label]``; returns what :func:`_untimed` restores."""
    orig = getattr(owner, name)
    own = owner.__dict__.get(name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter_ns()
        try:
            return orig(*args, **kwargs)
        finally:
            entry = acc.setdefault(label, [0, 0])
            entry[0] += time.perf_counter_ns() - t0
            entry[1] += 1
    setattr(owner, name, timed)
    return owner, name, own


def _untimed(owner, name: str, own) -> None:
    """Undo :func:`_timed`: put back the attribute ``owner`` had, or
    remove the wrapper where the attribute was inherited."""
    if own is None:
        delattr(owner, name)
    else:
        setattr(owner, name, own)


def _calls_in_run(card: str, ta, cells: int, workers: list[int]) -> None:
    """Each torch call of a DAG cell (its pull's pinned staging, copy and
    event; its kernel's event waits, stream marks, arithmetic and event;
    the device scopes), timed from inside runs at ``workers``."""
    from ..core import executor

    acc: dict = {}
    wrapped = [(torch, "maximum", "torch.maximum"),
               (torch, "add", "torch.add"),
               (torch.Tensor, "to", "Tensor.to (the pull's copy)"),
               (torch.Tensor, "record_stream", "Tensor.record_stream"),
               (torch.cuda.Event, "record", "Event.record"),
               (torch.cuda.Stream, "wait_event", "Stream.wait_event"),
               (executor, "_pinned", "_pinned (staging)"),
               (ScopedDeviceContext, "__enter__", "device scope enter"),
               (ScopedDeviceContext, "__exit__", "device scope exit"),
               (executor.Executor, "_invoke", "Executor._invoke (a task)")]
    for w in workers:
        acc.clear()
        undo = [_timed(owner, name, label, acc)
                for owner, name, label in wrapped]
        try:
            run = _dag(ta, cells, w)
        finally:
            for args in undo:
                _untimed(*args)
        wall = run["run_seconds"]
        print(f"[{card}] propagation DAG of {cells} cells, workers {w}, each "
              f"torch call timed: {wall / len(run['graph']) * 1e6} wall µs "
              f"per task; per call (µs), calls, thread-seconds per second of "
              f"the run: " + "; ".join(
                  f"{k} {ns / n / 1e3} x {n} = {ns / 1e9 / wall}"
                  for k, (ns, n) in sorted(acc.items(),
                                           key=lambda kv: -kv[1][0])))


def _idle_share(card: str, ta, cells: int) -> None:
    """The device's busy and idle shares of a DAG run at 1 worker under
    ``torch.profiler``: its kernels' and copies' device time over the
    run's wall."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run = _dag(ta, cells, 1)
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    wall = run["run_seconds"]
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:4]
    print(f"[{card}] propagation DAG of {cells} cells at 1 worker under "
          f"torch.profiler: device busy {busy} s of a {wall} s run, idle "
          f"share {1 - busy / wall}; device µs per cell {busy / cells * 1e6}"
          f"; wall µs per task {wall / len(run['graph']) * 1e6}; most device "
          f"time: " + "; ".join(f"{e.key[:60]} {e.count} x "
                               f"{e.self_device_time_total / e.count} µs"
                               for e in top))


def _rss_bytes() -> int:
    """This process's resident set now (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def _memory_and_gc(card: str, ta, dev, cells: int) -> None:
    """One untimed DAG run at 1 worker: the host's resident set around
    it, the cyclic collector's collections and seconds during it, the
    device's peak and the pinned-host allocator after it."""
    clock = {"collections": 0, "seconds": 0.0, "t0": 0.0}

    def tick(phase: str, info: dict) -> None:
        if phase == "start":
            clock["t0"] = time.perf_counter()
        else:
            clock["collections"] += 1
            clock["seconds"] += time.perf_counter() - clock["t0"]

    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    rss = _rss_bytes()
    gc.callbacks.append(tick)
    try:
        run = _dag(ta, cells, 1)
    finally:
        gc.callbacks.remove(tick)
    wall = run["run_seconds"]
    host = torch.cuda.host_memory_stats()
    print(f"[{card}] propagation DAG of {cells} cells at 1 worker: {wall} s, "
          f"{wall / len(run['graph']) * 1e6} wall µs per task; host RSS "
          f"{rss} B before the graph was built, {_rss_bytes()} B after the "
          f"run; the garbage collector ran {clock['collections']} times for "
          f"{clock['seconds']} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev)} B; the caching pinned-host"
          f" allocator: " + ", ".join(
              f"{k} {host[k]}" for k in ("allocations.current",
                                          "allocations.peak",
                                          "allocated_bytes.current",
                                          "allocated_bytes.peak")
              if k in host))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--live", default="0,20000,100000,200000",
                   help="counts of live events, tensors and dicts")
    p.add_argument("--calls", type=int, default=5000)
    p.add_argument("--dag-cells", type=int, default=5000,
                   help="cells of the DAG whose calls are timed in a run")
    p.add_argument("--dag-workers", default="1,4")
    p.add_argument("--gc-cells", type=int, default=100_000,
                   help="cells of the DAG whose memory and GC are read")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_executor needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    side = torch.cuda.Stream(dev)
    _rounds(dev, 200)                                # warm-up
    for n in (int(x) for x in args.live.split(",") if x):
        events, tensors, dicts = [], [], []
        for i in range(n):
            ev = torch.cuda.Event()
            ev.record(side)
            events.append(ev)
            tensors.append(torch.zeros((), dtype=torch.float64, device=dev))
            dicts.append({"id": i, "state": {}})
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        gc.collect()
        gc_s = time.perf_counter() - t0
        per_call = _rounds(dev, args.calls)
        print(f"[{card}] live {n} events, 0-d tensors and dicts: host µs per "
              f"call " + "; ".join(f"{k} {v}" for k, v in per_call.items())
              + f"; gc.collect() {gc_s} s")
        del events, tensors, dicts
        gc.collect()
        torch.cuda.empty_cache()
    if args.dag_cells or args.gc_cells:
        ta = _timing_analysis()
    if args.dag_cells:
        first = _dag(ta, args.dag_cells, 1)
        print(f"[{card}] propagation DAG of {args.dag_cells} cells, workers "
              f"1, untimed (the process's first run): "
              f"{first['run_seconds'] / len(first['graph']) * 1e6} wall µs "
              f"per task")
        del first
        _calls_in_run(card, ta, args.dag_cells,
                      [int(w) for w in args.dag_workers.split(",") if w])
        _idle_share(card, ta, args.dag_cells)
    if args.gc_cells:
        _memory_and_gc(card, ta, dev, args.gc_cells)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
