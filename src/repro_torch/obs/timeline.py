"""Chrome-trace / Perfetto JSON export of per-bin lane timelines.

All three telemetry sources render into the same shape — one Chrome
trace *process* per device bin, one *thread* per lane (copy ∥ compute
∥ host, plus ``arena`` for spill/refill activity and ``events`` for
instants) — so a measured run, its simulated schedule, and a flight
recorder dump line up row-for-row when opened at
https://ui.perfetto.dev (or ``chrome://tracing``):

* :func:`timeline_from_trace` — a :class:`~repro_torch.sched.TaskProfiler`
  trace of a live executor run (records + v6 spill/refill events);
* :func:`timeline_from_schedule` — a :class:`~repro_torch.sched.SimReport`
  (or raw ``(node, lane, bin, start, end)`` interval list) from the
  simulator;
* :func:`timeline_from_recorder` — a :class:`~repro_torch.obs.SpanRecorder`
  ring (completed spans become ``X`` slices, instants stay instants).

:func:`diff_timelines` aligns a measured timeline against its
replay-simulated twin and quantifies per-bin/per-lane divergence —
the feedback signal for CostModel calibration.

Times: all exporters emit ``ts``/``dur`` in microseconds as the
Chrome trace format requires; :func:`diff_timelines` reports seconds.
"""
from __future__ import annotations

import json
from typing import Any, Iterable, Mapping

from repro_torch.core.streams import (
    COMPUTE_LANE,
    COPY_LANE,
    HOST_LANE,
    bin_labels,
    lane_kind,
)

#: Synthetic lanes beyond the simulator's copy/compute/host classes:
#: ``arena`` carries spill/refill slices, ``events`` carries instants.
ARENA_LANE = "arena"
EVENT_LANE = "events"

_TID = {COPY_LANE: 1, COMPUTE_LANE: 2, HOST_LANE: 3,
        ARENA_LANE: 4, EVENT_LANE: 5}

#: Process name used when a record carries no bin (host-side work).
_HOST_PROC = "host"


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


class _Builder:
    """Accumulates events; assigns stable pids and metadata rows."""

    def __init__(self) -> None:
        self._events: list[dict[str, Any]] = []
        self._pids: dict[str, int] = {}
        self._threads: set[tuple[int, str]] = set()

    def pid(self, proc: str) -> int:
        p = self._pids.get(proc)
        if p is None:
            p = self._pids[proc] = len(self._pids) + 1
        return p

    def _tid(self, pid: int, lane: str) -> int:
        self._threads.add((pid, lane))
        return _TID.get(lane, len(_TID) + 1)

    def slice(self, name: str, cat: str, proc: str, lane: str,
              start_s: float, end_s: float,
              args: Mapping[str, Any]) -> None:
        pid = self.pid(proc)
        self._events.append({
            "ph": "X", "name": name, "cat": cat,
            "ts": _us(start_s), "dur": _us(max(0.0, end_s - start_s)),
            "pid": pid, "tid": self._tid(pid, lane),
            "args": {k: v for k, v in args.items() if v is not None},
        })

    def instant(self, name: str, proc: str, lane: str, ts_s: float,
                args: Mapping[str, Any]) -> None:
        pid = self.pid(proc)
        self._events.append({
            "ph": "i", "s": "t", "name": name, "cat": "event",
            "ts": _us(ts_s), "pid": pid, "tid": self._tid(pid, lane),
            "args": {k: v for k, v in args.items() if v is not None},
        })

    def build(self) -> dict[str, Any]:
        meta: list[dict[str, Any]] = []
        for proc, pid in sorted(self._pids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "process_name", "ts": 0,
                         "pid": pid, "tid": 0, "args": {"name": proc}})
        for pid, lane in sorted(self._threads,
                                key=lambda t: (t[0], _TID.get(t[1], 99))):
            meta.append({"ph": "M", "name": "thread_name", "ts": 0,
                         "pid": pid, "tid": _TID.get(lane, len(_TID) + 1),
                         "args": {"name": lane}})
        return {"traceEvents": meta + self._events,
                "displayTimeUnit": "ms"}


def timeline_from_trace(trace: Any) -> dict[str, Any]:
    """Render a profiler trace (dict or live ``TaskProfiler``) as a
    Chrome trace: one process per bin label, task records on their
    copy/compute/host lane, spill/refill events on the ``arena`` lane
    (with the v6 ``node``/``span`` correlation ids in ``args``)."""
    if hasattr(trace, "trace"):
        trace = trace.trace()
    b = _Builder()
    for label in trace.get("meta", {}).get("bins", []):
        b.pid(label)                       # stable pid order = bin order
    for rec in trace.get("records", []):
        proc = rec.get("bin") or _HOST_PROC
        b.slice(rec.get("name") or str(rec.get("node")),
                rec.get("type", "task"), proc, lane_kind(rec.get("type")),
                rec["start"], rec["end"],
                {"node": rec.get("node"), "worker": rec.get("worker"),
                 "iteration": rec.get("iteration"), "cost": rec.get("cost"),
                 "bytes": rec.get("bytes") or None,
                 "xfer_bytes": rec.get("xfer_bytes") or None,
                 "stage": rec.get("stage")})
    for ev in trace.get("events", []):
        proc = ev.get("bin") or _HOST_PROC
        b.slice(ev.get("type", "event"), ARENA_LANE, proc, ARENA_LANE,
                ev["start"], ev["end"],
                {"bytes": ev.get("bytes"), "node": ev.get("node"),
                 "span": ev.get("span")})
    return b.build()


def timeline_from_schedule(report: Any, bins: Iterable[Any] | None = None,
                           *, graph: Any = None) -> dict[str, Any]:
    """Render a simulated schedule — a ``SimReport`` or raw interval
    list of ``(node_id, lane, bin_index, start, end)`` — as a Chrome
    trace.  ``bins`` (when given) names processes with the same stable
    labels a live run uses, so :func:`diff_timelines` can align the
    two; ``graph`` (when given) maps node ids back to task names."""
    schedule = getattr(report, "schedule", report)
    labels = bin_labels(list(bins)) if bins is not None else None
    names = ({n.id: n.name for n in graph.nodes}
             if graph is not None else {})
    b = _Builder()
    if labels:
        for label in labels:
            b.pid(label)
    for node_id, lane, bin_index, start, end in schedule:
        if bin_index < 0:
            proc = _HOST_PROC
        elif labels is not None and bin_index < len(labels):
            proc = labels[bin_index]
        else:
            proc = f"bin{bin_index}"
        b.slice(names.get(node_id, str(node_id)), lane, proc, lane,
                start, end, {"node": node_id, "sim": True})
    return b.build()


def timeline_from_recorder(recorder: Any) -> dict[str, Any]:
    """Render a flight-recorder ring: completed spans become ``X``
    slices on their bin/lane row, instants become ``i`` marks.  Spans
    whose begin or end fell off the bounded ring are dropped."""
    entries = recorder.entries() if hasattr(recorder, "entries") \
        else list(recorder)
    t0 = min((e["ts"] for e in entries), default=0.0)
    b = _Builder()
    spans = (recorder.spans() if hasattr(recorder, "spans")
             else _pair_spans(entries))
    for s in spans:
        proc = str(s.get("bin") or _HOST_PROC)
        lane = s.get("lane") or HOST_LANE
        args = {k: v for k, v in s.items()
                if k not in ("ph", "span", "name", "ts", "end_ts",
                             "bin", "lane")}
        b.slice(s["name"], "span", proc, lane,
                s["ts"] - t0, s["end_ts"] - t0, args)
    for e in entries:
        if e.get("ph") != "i":
            continue
        proc = str(e.get("bin") or _HOST_PROC)
        lane = e.get("lane") or EVENT_LANE
        args = {k: v for k, v in e.items()
                if k not in ("ph", "name", "ts", "bin", "lane")}
        b.instant(e["name"], proc, lane, e["ts"] - t0, args)
    return b.build()


def _pair_spans(entries: Iterable[Mapping[str, Any]]) -> list[dict]:
    open_: dict[int, dict] = {}
    done: list[dict] = []
    for e in entries:
        if e.get("ph") == "B":
            open_[e["span"]] = dict(e)
        elif e.get("ph") == "E":
            begun = open_.pop(e["span"], None)
            if begun is not None:
                done.append({**begun, "end_ts": e["ts"]})
    return done


def merge_timelines(*timelines: Mapping[str, Any]) -> dict[str, Any]:
    """Concatenate timelines into one trace, shifting pids so process
    groups from different sources stay distinct (e.g. a measured run
    next to its simulated twin in one Perfetto view)."""
    events: list[dict[str, Any]] = []
    base = 0
    for tl in timelines:
        evs = tl.get("traceEvents", [])
        for e in evs:
            shifted = dict(e)
            shifted["pid"] = e.get("pid", 0) + base
            events.append(shifted)
        base += max((e.get("pid", 0) for e in evs), default=0)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def save_timeline(timeline: Mapping[str, Any], path: str) -> None:
    """Write a timeline as deterministic JSON (sorted keys, indent 1)
    — load it at https://ui.perfetto.dev or ``chrome://tracing``."""
    with open(path, "w") as fh:
        json.dump(timeline, fh, indent=1, sort_keys=True)
        fh.write("\n")


def validate_timeline(timeline: Mapping[str, Any]) -> list[str]:
    """Schema check: every event needs ``ph``/``ts``/``pid``/``tid``,
    slices need ``dur``, named phases need ``name``.  Returns a list
    of problems (empty = valid)."""
    problems: list[str] = []
    evs = timeline.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph is None:
            problems.append(f"event {i}: missing ph")
            continue
        for field in ("ts", "pid", "tid"):
            if field not in e:
                problems.append(f"event {i} (ph={ph}): missing {field}")
        if ph == "X" and "dur" not in e:
            problems.append(f"event {i}: X slice missing dur")
        if ph in ("X", "B", "i", "M") and "name" not in e:
            problems.append(f"event {i} (ph={ph}): missing name")
    return problems


def _lane_busy(tl: Mapping[str, Any]) -> tuple[dict, float]:
    """Busy seconds per (process name, lane name) + trace makespan."""
    pname: dict[int, str] = {}
    tname: dict[tuple[int, int], str] = {}
    for e in tl.get("traceEvents", []):
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            pname[e["pid"]] = e["args"]["name"]
        elif e.get("name") == "thread_name":
            tname[(e["pid"], e["tid"])] = e["args"]["name"]
    busy: dict[tuple[str, str], float] = {}
    end = 0.0
    for e in tl.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        key = (pname.get(e["pid"], str(e["pid"])),
               tname.get((e["pid"], e["tid"]), str(e["tid"])))
        busy[key] = busy.get(key, 0.0) + e["dur"] / 1e6
        end = max(end, (e["ts"] + e["dur"]) / 1e6)
    return busy, end


def diff_timelines(measured: Mapping[str, Any],
                   simulated: Mapping[str, Any]) -> dict[str, Any]:
    """Align a measured timeline against its (replay-)simulated twin.

    Returns per-(bin, lane) and per-bin busy-time divergence plus the
    makespan gap — ``divergence`` is ``|m - s| / max(m, s)`` in
    ``[0, 1]``, 0 meaning the simulation reproduced the measurement
    exactly.  Lanes present on only one side (e.g. ``arena`` spill
    slices never simulated) diverge at 1.0; large values point at the
    CostModel parameters to recalibrate (docs/observability.md).
    """
    mb, m_mk = _lane_busy(measured)
    sb, s_mk = _lane_busy(simulated)

    def _rel(m: float, s: float) -> float:
        d = max(m, s)
        return abs(m - s) / d if d > 0 else 0.0

    lanes = [{"bin": bin_, "lane": lane,
              "measured_busy_s": mb.get((bin_, lane), 0.0),
              "simulated_busy_s": sb.get((bin_, lane), 0.0),
              "divergence": _rel(mb.get((bin_, lane), 0.0),
                                 sb.get((bin_, lane), 0.0))}
             for bin_, lane in sorted(set(mb) | set(sb))]
    per_bin: dict[str, dict[str, float]] = {}
    for row in lanes:
        agg = per_bin.setdefault(row["bin"],
                                 {"measured_busy_s": 0.0,
                                  "simulated_busy_s": 0.0})
        agg["measured_busy_s"] += row["measured_busy_s"]
        agg["simulated_busy_s"] += row["simulated_busy_s"]
    bins = [{"bin": k, **v,
             "divergence": _rel(v["measured_busy_s"],
                                v["simulated_busy_s"])}
            for k, v in sorted(per_bin.items())]
    return {
        "makespan": {"measured_s": m_mk, "simulated_s": s_mk,
                     "divergence": _rel(m_mk, s_mk)},
        "bins": bins,
        "lanes": lanes,
        "max_divergence": max((r["divergence"] for r in lanes),
                              default=0.0),
    }
