"""The traced run: the harness's own spans and the device's trace.

Spans are recorded by the benchmark around its calls into the program
(an engine tick, a prefill, a decode step, a train step, the client's
work between ticks), on the wall clock (``time.time_ns``), whatever
thread makes the call: the profiler records CPU ops only on the thread
that started it, so the benchmark keeps its spans itself.  The device's
trace is ``torch.profiler``'s (CUPTI): every kernel, copy and fill,
each with the correlation id of the runtime call that launched it (a
kernel of a CUDA graph carries its ``cudaGraphLaunch``'s).  The chrome
trace's timestamps are the same wall clock in microseconds less
``baseTimeNanoseconds``, so a kernel belongs to the span that was open
when its launching call ran.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

#: device activity in a chrome trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime",)


class Spans:
    """The harness's spans: (name, start ns, end ns, meta), kept in
    memory; recording is off unless ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list[tuple[str, int, int, dict]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append((name, t0, t1, meta))

    def wrap(self, name: str, fn, meta=None):
        """``fn`` with each call in a span ``name``; ``meta(*args)`` gives
        the span's meta."""
        if not self.on:
            return fn

        def wrapped(*args, **kwargs):
            with self.span(name, **(meta(*args) if meta else {})):
                return fn(*args, **kwargs)
        return wrapped


@dataclass
class SpanKernels:
    """The device work one span launched: its meta, and each kernel's
    name, start and end (µs)."""
    meta: dict
    names: list = field(default_factory=list)
    starts: list = field(default_factory=list)
    ends: list = field(default_factory=list)

    def busy_us(self) -> float:
        return union_us(np.array(self.starts), np.array(self.ends))

    def total_us(self, match) -> float:
        return float(sum(e - s for n, s, e in zip(self.names, self.starts,
                                                   self.ends) if match(n)))


def union_us(starts: np.ndarray, ends: np.ndarray) -> float:
    """Length of the union of the intervals [starts, ends)."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    gaps = np.clip(s[1:] - reach[:-1], 0, None)
    return float(reach[-1] - s[0] - gaps.sum())


class Trace:
    """A parsed device trace over the window [start, stop] (µs on the
    trace's clock), with the harness's spans on that clock."""

    def __init__(self, doc: dict, t0_ns: int, t1_ns: int, spans):
        base = doc.get("baseTimeNanoseconds", 0)
        self.start = (t0_ns - base) / 1e3
        self.stop = (t1_ns - base) / 1e3
        names, dev, launch = [], [], {}
        for ev in doc.get("traceEvents", ()):
            cat = ev.get("cat")
            if cat in _DEVICE_CATS and "dur" in ev:
                dev.append((ev["ts"], ev["ts"] + ev["dur"],
                            ev.get("args", {}).get("correlation", -1),
                            cat == "kernel"))
                names.append(ev.get("name", ""))
            elif cat in _LAUNCH_CATS:
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = ev["ts"]
        self.names = names
        arr = np.array(dev, dtype=np.float64).reshape(-1, 4)
        self.dev_start, self.dev_end = arr[:, 0], arr[:, 1]
        self.is_kernel = arr[:, 3] > 0
        self.launch_ts = np.array([launch.get(int(c), np.nan)
                                   for c in arr[:, 2]])
        self.spans = [(n, (a - base) / 1e3, (b - base) / 1e3, m)
                      for n, a, b, m in spans]

    @property
    def window_s(self) -> float:
        return (self.stop - self.start) / 1e6

    def _inside(self) -> np.ndarray:
        return (self.dev_end > self.start) & (self.dev_start < self.stop)

    def busy_s(self) -> float:
        """Seconds of the window in which any device operation ran."""
        m = self._inside()
        return union_us(np.clip(self.dev_start[m], self.start, self.stop),
                        np.clip(self.dev_end[m], self.start,
                                self.stop)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """The ``top`` operations by total device seconds in the window:
        [name, seconds]."""
        totals: dict[str, float] = {}
        m = self._inside()
        for i in np.nonzero(m)[0]:
            n = self.names[i][:160]
            totals[n] = totals.get(n, 0.0) + (self.dev_end[i]
                                              - self.dev_start[i]) / 1e6
        return sorted(([k, v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The window's idle device time by the innermost harness span
        open at each gap's middle ("no span" where none was): [name,
        seconds], the largest first."""
        m = self._inside()
        s = np.clip(self.dev_start[m], self.start, self.stop)
        e = np.clip(self.dev_end[m], self.start, self.stop)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        edges_s = np.concatenate([[self.start], np.maximum.accumulate(e)])
        edges_e = np.concatenate([s, [self.stop]])
        keep = edges_e > edges_s
        a, b = edges_s[keep], edges_e[keep]
        mid = (a + b) / 2
        # per gap, the innermost (shortest) span open at its middle
        best_len = np.full(mid.shape, np.inf)
        best = np.full(mid.shape, -1)
        names = sorted({n for n, _, _, _ in self.spans})
        for k, name in enumerate(names):
            iv = sorted((sa, sb) for n, sa, sb, _ in self.spans if n == name)
            starts = np.array([x for x, _ in iv])
            ends = np.array([y for _, y in iv])
            j = np.searchsorted(starts, mid, side="right") - 1
            ok = j >= 0
            length = np.full(mid.shape, np.inf)
            length[ok] = np.where(mid[ok] <= ends[j[ok]],
                                  ends[j[ok]] - starts[j[ok]], np.inf)
            better = length < best_len
            best_len[better], best[better] = length[better], k
        totals: dict[str, float] = {}
        for k, name in [(-1, "no span")] + list(enumerate(names)):
            sel = best == k
            if sel.any():
                totals[name] = float((b[sel] - a[sel]).sum()) / 1e6
        return sorted(([k, v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:top]

    def span_kernels(self, name: str) -> list[SpanKernels]:
        """Every span ``name`` that lies whole in the window, with the
        kernels whose launching call ran inside it."""
        spans = sorted(((a, b, m) for n, a, b, m in self.spans
                        if n == name and a >= self.start and b <= self.stop),
                       key=lambda t: t[0])
        out = [SpanKernels(m) for _, _, m in spans]
        if not spans:
            return out
        starts = np.array([a for a, _, _ in spans])
        ends = np.array([b for _, b, _ in spans])
        idx = np.searchsorted(starts, self.launch_ts, side="right") - 1
        for i in np.nonzero(self.is_kernel & (idx >= 0))[0]:
            j = idx[i]
            if self.launch_ts[i] <= ends[j]:
                sk = out[j]
                sk.names.append(self.names[i])
                sk.starts.append(self.dev_start[i])
                sk.ends.append(self.dev_end[i])
        return out


class Profiler:
    """``torch.profiler`` over part of the window: :meth:`start` and
    :meth:`stop` (which synchronises the device first) on the thread that
    runs the loop (Kineto registers its client with the first thread that
    starts it), :meth:`mark_start` where the traced window begins if that
    is later, then :meth:`read`."""

    def __init__(self, torch, device, spans: Spans):
        self.torch, self.device, self.spans = torch, device, spans
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.trace: Trace | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0_ns = time.time_ns()

    def mark_start(self) -> None:
        self.t0_ns = time.time_ns()

    @property
    def running(self) -> bool:
        return self.prof is not None and not self.t1_ns

    def stop(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        self.t1_ns = time.time_ns()
        self.prof.stop()

    def read(self) -> Trace:
        """Export and parse the trace (after the window), in the run's
        temporary directory, which is removed."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        self.prof = None
        self.trace = Trace(doc, self.t0_ns, self.t1_ns, self.spans.items)
        return self.trace
