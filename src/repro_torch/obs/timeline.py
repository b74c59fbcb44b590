"""Chrome-trace / Perfetto JSON export of a flight recorder's ring.

:func:`timeline_from_recorder` renders a
:class:`~repro_torch.obs.SpanRecorder` ring in the shape of a per-bin
lane timeline — one Chrome trace *process* per device bin, one *thread*
per lane (copy ∥ compute ∥ host, plus ``arena`` for spill/refill
activity and ``events`` for instants): completed spans and intervals
become ``X`` slices, instants stay instants.  Open the file
:func:`save_timeline` writes at https://ui.perfetto.dev (or
``chrome://tracing``); :meth:`SpanRecorder.dump
<repro_torch.obs.SpanRecorder.dump>` writes one on fault.

Times: ``ts``/``dur`` in microseconds as the Chrome trace format
requires, from the ring's first entry.
"""
from __future__ import annotations

import json
from typing import Any, Mapping

from repro_torch.core.streams import COMPUTE_LANE, COPY_LANE, HOST_LANE

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


def timeline_from_recorder(recorder: Any) -> dict[str, Any]:
    """Render a flight recorder's ring: completed spans and intervals
    become ``X`` slices on their bin/lane row, instants become ``i``
    marks.  Spans whose begin or end fell off the bounded ring are
    dropped."""
    entries = recorder.entries()
    t0 = min((e["ts"] for e in entries), default=0)
    b = _Builder()
    for s in recorder.spans():
        proc = str(s.get("bin") or _HOST_PROC)
        lane = s.get("lane") or HOST_LANE
        args = {k: v for k, v in s.items()
                if k not in ("ph", "span", "name", "ts", "end_ts",
                             "bin", "lane")}
        b.slice(s["name"], "span", proc, lane,
                (s["ts"] - t0) / 1e9, (s["end_ts"] - t0) / 1e9, args)
    for e in entries:
        if e.get("ph") != "i":
            continue
        proc = str(e.get("bin") or _HOST_PROC)
        lane = e.get("lane") or EVENT_LANE
        args = {k: v for k, v in e.items()
                if k not in ("ph", "name", "ts", "bin", "lane")}
        b.instant(e["name"], proc, lane, (e["ts"] - t0) / 1e9, args)
    return b.build()


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
