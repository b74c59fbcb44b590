"""The program's own spans, as the benchmark reads them.

The port records spans, device intervals and counters itself when it is
given a ``SpanRecorder`` (``repro_torch.obs``; the names are listed in
``serving/engine.py`` and ``core/executor.py``), on the clock of
``time.time_ns()``: the clock of the harness's spans and, less
``baseTimeNanoseconds``, of the device trace.  This module reads them:
plain functions of the recorder's ring entries, which it pairs itself,
so what a reading is computed from lies here with the rest of the
yardstick.

Every reading is taken over the **settled untraced part** of a run's
window (:func:`settled_part`): the profiler's per-node tracing of a graph
launch slows the host while it runs, and Kineto's stop pauses the loop.

- a closed loop's part runs from the profiler's stop to the window's end;
- an open loop's starts at the first end of an ``engine.tick`` at which
  no ``request.queue`` span is open, after the first
  ``executor.predicate`` that ends after the stop: the arrivals due
  during the pause form a backlog, which that predicate sends, and the
  part starts once the engine has seated it.

A reader returns None where the ring dropped entries, where the part is
empty, or where the part holds nothing to read.  Device readings read
``device.*`` intervals, which the engine records only on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import stats
from .trace import union_us

#: the executor's span of one engine tick task (its graph node's name)
TASK = "engine_tick"


def pair(entries) -> list[dict]:
    """The spans of a recorder's ring ``entries``: each begin (``B``)
    with ``end_ts`` from its end (None while open), each interval (``X``)
    as it is; instants are left out."""
    out, begun = [], {}
    for e in entries:
        ph = e["ph"]
        if ph == "B":
            s = begun[e["span"]] = dict(e, end_ts=None)
            out.append(s)
        elif ph == "E":
            s = begun.pop(e["span"], None)
            if s is not None:
                s["end_ts"] = e["ts"]
        elif ph == "X":
            out.append(dict(e))
    return out


@dataclass
class Recorded:
    """What the readers read: the paired spans, the entries the ring
    dropped by the window's end, and the settled untraced part
    [start, end] (ns on the recorder's clock)."""
    spans: list
    dropped: int
    start: int
    end: int

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def named(self, name: str) -> list[dict]:
        """The completed spans ``name`` that lie whole in the part."""
        return [s for s in self.spans if s["name"] == name
                and s["end_ts"] is not None and s["ts"] >= self.start
                and s["end_ts"] <= self.end]


def settled_part(spans: list, stop: int, end: int,
                 closed: bool) -> tuple[int, int]:
    """The settled untraced part [start, end] of a window ending at
    ``end`` whose traced part stopped at ``stop`` (module docstring);
    start > end where an open loop's queue never empties before the
    window's end."""
    if closed:
        return stop, end
    # the clients send what fell due during the pause at their first
    # predicate after it
    sent = min((s["end_ts"] for s in spans
                if s["name"] == "executor.predicate"
                and s["end_ts"] is not None and s["end_ts"] >= stop),
               default=stop)
    ticks = np.sort(np.array([s["end_ts"] for s in spans
                              if s["name"] == "engine.tick"
                              and s["end_ts"] is not None
                              and sent <= s["end_ts"] <= end],
                             dtype=np.int64))
    q = [s for s in spans if s["name"] == "request.queue"]
    begins = np.sort(np.array([s["ts"] for s in q], dtype=np.int64))
    ends = np.sort(np.array([s["end_ts"] for s in q
                             if s["end_ts"] is not None], dtype=np.int64))
    # open at t: begun at or before t and not ended by then
    waiting = (np.searchsorted(begins, ticks, side="right")
               - np.searchsorted(ends, ticks, side="right"))
    empty = np.nonzero(waiting == 0)[0]
    return (int(ticks[empty[0]]), end) if len(empty) else (end + 1, end)


def _usable(rec: Recorded | None) -> bool:
    return rec is not None and rec.dropped == 0 and rec.end > rec.start


def _device(rec: Recorded) -> tuple[np.ndarray, np.ndarray]:
    """The ``device.*`` intervals clipped to the part, by start."""
    iv = sorted((max(s["ts"], rec.start), min(s["end_ts"], rec.end))
                for s in rec.spans if s["name"].startswith("device.")
                and s["end_ts"] > rec.start and s["ts"] < rec.end)
    return (np.array([a for a, _ in iv], dtype=np.float64),
            np.array([b for _, b in iv], dtype=np.float64))


def device_idle_pct(rec: Recorded | None) -> float | None:
    """100 × (1 − the union of the part's ``device.*`` intervals over its
    length)."""
    if not _usable(rec):
        return None
    s, e = _device(rec)
    if not len(s):
        return None
    return 100.0 * (1.0 - union_us(s, e) / (rec.end - rec.start))


def host_self_ms_per_tick(rec: Recorded | None) -> float | None:
    """The mean, over the part's ``engine.tick`` spans, of each one's
    length less the ``engine.sync`` spans under it: the host's work in a
    tick, which the device waits on (ms)."""
    if not _usable(rec):
        return None
    ticks = {s["span"]: s for s in rec.named("engine.tick")}
    if not ticks:
        return None
    by_id = {s["span"]: s for s in rec.spans if "span" in s}
    synced = dict.fromkeys(ticks, 0)
    for s in rec.spans:
        if s["name"] != "engine.sync" or s["end_ts"] is None:
            continue
        p = s.get("parent")
        while p is not None and p not in ticks:
            p = by_id.get(p, {}).get("parent")
        if p is not None:
            synced[p] += s["end_ts"] - s["ts"]
    return float(np.mean([t["end_ts"] - t["ts"] - synced[k]
                          for k, t in ticks.items()])) / 1e6


def queue_wait_p90_s(rec: Recorded | None) -> float | None:
    """The nearest-rank p90 of the ``request.queue`` spans that end in the
    part (s)."""
    if not _usable(rec):
        return None
    waits = [(s["end_ts"] - s["ts"]) / 1e9 for s in rec.spans
             if s["name"] == "request.queue" and s["end_ts"] is not None
             and rec.start < s["end_ts"] <= rec.end]
    return stats.percentile(waits, 90) if waits else None


def executor_gap_ms_per_tick(rec: Recorded | None) -> float | None:
    """The mean, over consecutive engine tick tasks of the part (the
    executor's spans ``engine_tick``), of the next one's begin less this
    one's end less the ``executor.predicate`` span between them (ms)."""
    if not _usable(rec):
        return None
    tasks = sorted((s for s in rec.named(TASK) if "node" in s),
                   key=lambda s: s["ts"])
    preds = sorted((s["ts"], s["end_ts"])
                   for s in rec.named("executor.predicate"))
    starts = np.array([a for a, _ in preds], dtype=np.int64)
    lengths = np.array([b - a for a, b in preds], dtype=np.int64)
    gaps = []
    for a, b in zip(tasks, tasks[1:]):
        lo, hi = a["end_ts"], b["ts"]
        i, j = np.searchsorted(starts, [lo, hi], side="left")
        inside = [k for k in range(i, j) if preds[k][1] <= hi]
        gaps.append(hi - lo - int(lengths[inside].sum()))
    return float(np.mean(gaps)) / 1e6 if gaps else None


def idle_gaps(rec: Recorded | None, top: int = 10) -> list | None:
    """The part's idle device time (the gaps between ``device.*``
    intervals, and before the first and after the last) by the innermost
    host span of the program open at each gap's middle ("no span" where
    none was): [name, seconds], the largest first."""
    if not _usable(rec):
        return None
    s, e = _device(rec)
    if not len(s):
        return None
    edges_s = np.concatenate([[rec.start], np.maximum.accumulate(e)])
    edges_e = np.concatenate([s, [rec.end]])
    keep = edges_e > edges_s
    a, b = edges_s[keep], edges_e[keep]
    mid = (a + b) / 2
    host = [x for x in rec.spans if x["end_ts"] is not None
            and not x["name"].startswith(("device.", "request."))]
    names = sorted({x["name"] for x in host})
    best_len = np.full(mid.shape, np.inf)
    best = np.full(mid.shape, -1)
    for k, name in enumerate(names):
        iv = sorted((x["ts"], x["end_ts"]) for x in host if x["name"] == name)
        starts = np.array([x for x, _ in iv], dtype=np.float64)
        ends = np.array([y for _, y in iv], dtype=np.float64)
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
            totals[name] = float((b[sel] - a[sel]).sum()) / 1e9
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:top]


def outside_parent_ms(spans: list) -> float | None:
    """The farthest any ``device.*`` interval reaches outside the host
    span it was recorded in (its parent: the ``engine.prefill`` or
    ``engine.decode`` that launched it), in ms; None without one."""
    by_id = {s["span"]: s for s in spans}
    out = None
    for s in spans:
        p = by_id.get(s.get("parent"))
        if not s["name"].startswith("device.") or p is None \
                or p["end_ts"] is None:
            continue
        d = max(p["ts"] - s["ts"], s["end_ts"] - p["end_ts"], 0) / 1e6
        out = d if out is None else max(out, d)
    return out


def as_trace_spans(spans: list) -> list[tuple]:
    """The completed spans in ``perfbench.trace.Trace``'s shape: (name,
    start ns, end ns, attributes)."""
    skip = ("ph", "span", "name", "ts", "end_ts")
    return [(s["name"], s["ts"], s["end_ts"],
             {k: v for k, v in s.items() if k not in skip})
            for s in spans if s["end_ts"] is not None]


def device_vs_trace(trace, spans: list, base_ns: int,
                    top: int = 10) -> dict:
    """The ``device.*`` intervals against a device trace over its window:
    the seconds of their union and of the trace's busy time, and the
    trace's device operations that overlap no interval (the enqueues the
    event brackets miss; an operation at a bracket's edge overlaps it,
    whatever microseconds the two clocks differ by) by name: [name,
    seconds]."""
    lo, hi = trace.start * 1e3 + base_ns, trace.stop * 1e3 + base_ns
    iv = sorted((max(s["ts"], lo), min(s["end_ts"], hi)) for s in spans
                if s["name"].startswith("device.") and s["end_ts"] > lo
                and s["ts"] < hi)
    starts = np.array([a for a, _ in iv], dtype=np.float64)
    ends = np.array([b for _, b in iv], dtype=np.float64)
    missed: dict[str, float] = {}
    inside = (trace.dev_end > trace.start) & (trace.dev_start < trace.stop)
    for i in np.nonzero(inside)[0]:
        a = trace.dev_start[i] * 1e3 + base_ns
        b = trace.dev_end[i] * 1e3 + base_ns
        # the last interval starting before the operation ends
        j = np.searchsorted(starts, b, side="left") - 1
        if j < 0 or ends[j] <= a:
            n = trace.names[i][:160]
            missed[n] = missed.get(n, 0.0) + (trace.dev_end[i]
                                              - trace.dev_start[i]) / 1e6
    return {"intervals_s": union_us(starts, ends) / 1e9,
            "busy_s": trace.busy_s(),
            "missed": sorted(([k, v] for k, v in missed.items()),
                             key=lambda kv: -kv[1])[:top]}
