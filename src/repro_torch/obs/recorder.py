"""Lock-cheap structured span/event recorder (flight recorder).

The hot path takes no lock: every :meth:`~SpanRecorder.begin` /
:meth:`~SpanRecorder.end` / :meth:`~SpanRecorder.event` call appends
one small dict to a bounded ``collections.deque`` — atomic under
CPython — and span ids come from ``itertools.count`` (also atomic).
When the ring fills, the oldest entries fall off: the recorder is a
flight recorder, keeping the most recent window of activity so a
fault dump shows what led up to the crash, not the start of the run.

Entry shape (Chrome-trace phases, so export is a straight rendering):

* ``{"ph": "B", "span": id, "name": ..., "ts": ..., <attrs>}`` —
  span begin.  Attribution attrs (``bin``, ``lane``, ``node``,
  ``stage``, ``worker``, ...) are stored only when non-``None``.
* ``{"ph": "E", "span": id, "ts": ...}`` — span end.
* ``{"ph": "i", "name": ..., "ts": ..., <attrs>}`` — instant event.

Timestamps are ``time.perf_counter()`` seconds (same clock as
:class:`~repro_torch.sched.TaskProfiler`); the timeline exporter rebases
them to zero and converts to microseconds.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Iterator
from contextlib import contextmanager

DEFAULT_CAPACITY = 65536


class SpanRecorder:
    """Bounded ring of spans + instant events; dumps on fault.

    ``capacity`` bounds the ring (oldest entries evicted first).
    ``dump_path``, when set, is where :meth:`on_fault` writes a
    Perfetto-loadable Chrome-trace JSON of the ring's contents.
    ``sample_every=N`` keeps only every Nth span (see :meth:`begin`);
    the default of 1 records everything and is byte-identical to the
    pre-knob recorder.
    """

    clock = staticmethod(time.perf_counter)

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 dump_path: str | None = None,
                 sample_every: int = 1) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}")
        self.capacity = capacity
        self.dump_path = dump_path
        self.sample_every = sample_every
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._tick = itertools.count(1)

    # -- recording (lock-free) -----------------------------------------
    def begin(self, name: str, *, bin: Any = None, lane: str | None = None,
              node: Any = None, stage: Any = None, **attrs: Any) -> int:
        """Open a span; returns the span id to pass to :meth:`end`.

        With ``sample_every=N`` (N > 1), only every Nth begin records a
        span; the rest return ``0``, which :meth:`end` ignores — one
        atomic counter bump per skipped span, the knob for 10^5+-task
        runs where even ring appends show up.  Instant events are never
        sampled (spills, steals, faults are rare and must survive).
        """
        if self.sample_every > 1 and next(self._tick) % self.sample_every:
            return 0
        sid = next(self._ids)
        e: dict[str, Any] = {"ph": "B", "span": sid, "name": name,
                             "ts": self.clock()}
        _put(e, bin=bin, lane=lane, node=node, stage=stage, **attrs)
        self._ring.append(e)
        return sid

    def end(self, span: int, **attrs: Any) -> None:
        if span <= 0:     # unsampled begin (sample_every > 1)
            return
        e: dict[str, Any] = {"ph": "E", "span": span, "ts": self.clock()}
        _put(e, **attrs)
        self._ring.append(e)

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[int]:
        sid = self.begin(name, **attrs)
        try:
            yield sid
        finally:
            self.end(sid)

    def event(self, name: str, *, bin: Any = None, lane: str | None = None,
              node: Any = None, span: int | None = None,
              **attrs: Any) -> None:
        """Record an instant event (spill, steal, preemption, ...)."""
        e: dict[str, Any] = {"ph": "i", "name": name, "ts": self.clock()}
        _put(e, bin=bin, lane=lane, node=node, span=span, **attrs)
        self._ring.append(e)

    # -- inspection / draining -----------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def entries(self) -> list[dict[str, Any]]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    def events(self, name: str | None = None) -> list[dict[str, Any]]:
        """Instant events only, optionally filtered by name."""
        return [e for e in self._ring
                if e["ph"] == "i" and (name is None or e["name"] == name)]

    def spans(self) -> list[dict[str, Any]]:
        """Completed spans, paired from B/E entries still in the ring.

        Each returned dict is the begin entry plus ``end_ts``; spans
        whose begin fell off the ring, or that are still open, are
        dropped (the flight recorder keeps a window, not the world).
        """
        open_: dict[int, dict[str, Any]] = {}
        done: list[dict[str, Any]] = []
        for e in list(self._ring):
            if e["ph"] == "B":
                open_[e["span"]] = e
            elif e["ph"] == "E":
                b = open_.pop(e["span"], None)
                if b is not None:
                    done.append({**b, "end_ts": e["ts"]})
        return done

    def clear(self) -> None:
        self._ring.clear()

    # -- fault handling ------------------------------------------------
    def dump(self, path: str | None = None) -> str | None:
        """Write the ring as Chrome-trace JSON; returns the path."""
        path = path or self.dump_path
        if path is None:
            return None
        from .timeline import save_timeline, timeline_from_recorder
        save_timeline(timeline_from_recorder(self), path)
        return path

    def on_fault(self, reason: Any = None, **attrs: Any) -> str | None:
        """Record a ``fault`` instant and dump the ring to ``dump_path``.

        Called by the executor when a topology fails; safe to call with
        no ``dump_path`` (records the event, skips the dump).  Dump
        errors are swallowed — the flight recorder must never turn a
        task fault into a crash.
        """
        self.event("fault", reason=None if reason is None else str(reason),
                   **attrs)
        try:
            return self.dump()
        except OSError:
            return None


def _put(e: dict[str, Any], **attrs: Any) -> None:
    for k, v in attrs.items():
        if v is not None:
            e[k] = v
