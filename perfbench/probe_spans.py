"""One run of a serving cell with the program's own span recorder.

    python3 perfbench/probe_spans.py --workload phi3.serve.decode \\
        --seed 17 --seconds 40 --trace 0 --obs 1

Runs the cell as ``perfbench/run.py`` does (the same options and the
same result line), with ``--obs 1`` passing a ``SpanRecorder`` sized to
hold the run as ``obs=`` to the ``Executor`` and the ``ServingEngine``;
``--obs 0`` builds exactly what the benchmark builds.  With the
recorder, it then prints on standard error, over the settled untraced
part of the window (:mod:`perfbench.program_spans`): the device's idle
share from the engine's CUDA-event intervals, the host's work per tick,
the p90 of the queue wait, the executor's gap per tick, the idle gaps by
the program span open, and the engine's device counters; under
``--trace 1`` also the intervals against the profiler's busy time over
the traced part, the device operations the intervals miss, and the
kernels of the harness's ``decode`` and ``prefill`` spans against the
program's ``engine.decode`` and ``engine.prefill``.  Its last line on
standard output is a JSON object of those readings.

A measuring tool beside the benchmark: the benchmark's command never
runs it.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import harness, program, program_spans, serve  # noqa: E402
from perfbench import run as bench  # noqa: E402

#: the recorder's ring: room for every entry of a 40 s run of either
#: serving cell many times over (a decode tick of 8 slots adds ~50)
CAPACITY = 1 << 20


class Probe:
    """The patches that attach the recorder, and what they caught."""

    def __init__(self, obs: bool):
        self.rec = None
        self.metrics = self.clients = self.prof = None
        #: the recorder's clock less ``time.perf_counter_ns()``
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        if obs:
            from repro_torch.obs import SpanRecorder
            self.rec = SpanRecorder(CAPACITY)
            self.offset_ns = self.rec.offset_ns

    def install(self, monkey) -> None:
        """Wrap the constructors ``perfbench.serve`` calls: ``monkey(module,
        name, value)`` sets one (``setattr``, or pytest's
        ``monkeypatch.setattr``)."""
        probe = self

        class Clients(serve.Clients):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                probe.clients = self

        class Profiler(serve.Profiler):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                probe.prof = self

        monkey(serve, "Clients", Clients)
        monkey(serve, "Profiler", Profiler)
        if self.rec is None:
            return
        monkey(program, "Executor",
               functools.partial(program.Executor, obs=self.rec))
        real = program.ServingEngine

        def engine(*a, **kw):
            eng = real(*a, obs=probe.rec, **kw)
            probe.metrics = eng.metrics
            return eng
        monkey(program, "ServingEngine", engine)

    def recorded(self) -> program_spans.Recorded:
        """The run's spans over the settled untraced part of its window."""
        c, rec = self.clients, self.rec
        spans = program_spans.pair(rec.entries())
        t0, t1 = self._ns(c.t0), self._ns(c.t1)
        #: where the profiler's stop returned (the window's start, where
        #: nothing was traced)
        self.stop_ns = t0 if c.t_rest is None else self._ns(c.t_rest)
        start, end = program_spans.settled_part(spans, self.stop_ns, t1,
                                                c.closed)
        return program_spans.Recorded(spans, rec.dropped, start, end)

    def _ns(self, t: float) -> int:
        """A ``time.monotonic`` reading of the clients on the recorder's
        clock: ``perf_counter`` (both ``CLOCK_MONOTONIC``) plus its
        offset."""
        return int(t * 1e9) + self.offset_ns

    def stop_s(self) -> float | None:
        """How long the profiler's stop took (None untraced)."""
        c = self.clients
        if self.prof is None or c is None or c.t_rest is None:
            return None
        return (self._ns(c.t_rest) - self.prof.t1_ns) / 1e9

    def readings(self, log) -> dict:
        r = self.recorded()
        out = {
            "dropped": r.dropped, "entries": len(r.spans),
            "part_s": r.seconds, "skipped_s": (r.start - self.stop_ns) / 1e9,
            "outside_parent_ms": program_spans.outside_parent_ms(r.spans),
            "device_idle_events": program_spans.device_idle_pct(r),
            "host_self_ms_per_tick": program_spans.host_self_ms_per_tick(r),
            "queue_wait_p90_s": program_spans.queue_wait_p90_s(r),
            "executor_gap_ms_per_tick":
                program_spans.executor_gap_ms_per_tick(r),
            "idle_gaps": program_spans.idle_gaps(r),
            "counters": {k: v for k, v in
                         self.metrics.snapshot().items()
                         if k in ("device_busy_s", "host_sync_s")},
            "ticks_in_part": len(r.named("engine.tick")),
        }
        dev = [s for s in r.spans if s["name"].startswith("device.")]
        out["device_intervals"] = len(dev)
        out["device_intervals_s"] = sum(s["end_ts"] - s["ts"]
                                        for s in dev) / 1e9
        trace = self.prof.trace if self.prof is not None else None
        if trace is not None:
            out["stop_s"] = self.stop_s()
            base = self.prof.t0_ns - round(trace.start * 1e3)
            out["traced"] = program_spans.device_vs_trace(trace, r.spans,
                                                          base)
            trace.spans += [(n, (a - base) / 1e3, (b - base) / 1e3, m)
                            for n, a, b, m in
                            program_spans.as_trace_spans(r.spans)]
            out["kernels"] = {h: _same_kernels(trace, h, p) for h, p in
                              (("decode", "engine.decode"),
                               ("prefill", "engine.prefill"))}
        log("program spans: " + json.dumps(out))
        return out


def _same_kernels(trace, harness_name: str, program_name: str) -> dict:
    """The kernels of each harness span against those of the program span
    around it: the spans matched, and the kernels the program's adds
    (the greedy token's argmax), by name."""
    prog = trace.span_kernels(program_name)
    extra: dict[str, int] = {}
    matched = missing = 0
    for h in trace.span_kernels(harness_name):
        k = set(zip(h.names, h.starts))
        owner = next((p for p in prog if k <= set(zip(p.names, p.starts))),
                     None)
        if owner is None:
            missing += 1
            continue
        matched += 1
        for n, s in set(zip(owner.names, owner.starts)) - k:
            extra[n[:160]] = extra.get(n[:160], 0) + 1
    return {"matched": matched, "missing": missing, "extra": extra}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obs", type=int, choices=(0, 1), default=1)
    args, rest = p.parse_known_args(argv)
    bargs = bench.parse(rest)
    probe = Probe(bool(args.obs))
    probe.install(setattr)
    rc = bench.main(rest)
    if rc == 0 and probe.rec is not None:
        print(json.dumps({"probe": probe.readings(harness.eprint)}),
              flush=True)
    harness.eprint(f"probe: obs {args.obs}, workload {bargs.workload}, "
                   f"seed {bargs.seed}, trace {bargs.trace}, profiler "
                   f"stop {probe.stop_s()} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
