"""Lock-cheap structured span/event recorder (flight recorder).

The hot path takes no lock: every :meth:`~SpanRecorder.begin` /
:meth:`~SpanRecorder.end` / :meth:`~SpanRecorder.complete` /
:meth:`~SpanRecorder.event` call appends one small dict to a bounded
``collections.deque`` — atomic under CPython — and span ids come from
``itertools.count`` (also atomic).  When the ring fills, the oldest
entries fall off and :attr:`~SpanRecorder.dropped` counts them: the
recorder is a flight recorder, keeping the most recent window of
activity so a fault dump shows what led up to the crash, not the start
of the run.  A recorder meant to hold a whole run is sized to it, and
its reader checks that nothing was dropped.

Entry shape (Chrome-trace phases, so export is a straight rendering):

* ``{"ph": "B", "span": id, "name": ..., "ts": ..., "parent": id,
  <attrs>}`` — span begin.  Attribution attrs (``bin``, ``lane``,
  ``node``, ``stage``, ``worker``, ``request``, ...) are stored only
  when non-``None``.
* ``{"ph": "E", "span": id, "ts": ...}`` — span end.
* ``{"ph": "X", "span": id, "name": ..., "ts": ..., "end_ts": ...,
  "parent": id, <attrs>}`` — an interval known only after the fact
  (:meth:`~SpanRecorder.complete`), such as the device's time between
  two CUDA events.
* ``{"ph": "i", "name": ..., "ts": ..., <attrs>}`` — instant event.

``parent`` is the span that was open, innermost, on the calling thread
when the span began (none at top level): each thread keeps a stack of
its open spans.  A span begun with ``detached=True`` — one that ends on
another thread, such as a request's wait in a queue — takes no parent
and is not pushed; it carries the id of what it times instead (a
``request=`` attr).  Ending a span also pops any span begun after it on
that thread and left open (a raise skipped its end), which then never
shows as completed.

Clock: integer nanoseconds on the clock of ``time.time_ns()`` — the
wall clock that ``torch.profiler``'s Chrome trace stamps on, less its
``baseTimeNanoseconds`` — so the program's spans lie beside a device
trace and beside spans a caller stamps with ``time.time_ns()``.  Each
stamp is ``time.perf_counter_ns()`` plus one offset taken at
construction (:attr:`SpanRecorder.offset_ns`): monotonic within the
run, on the wall clock as it stood at construction.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Iterator
from contextlib import contextmanager

DEFAULT_CAPACITY = 65536


def _wall_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the wall clock read on
    both sides of the monotonic one."""
    a = time.time_ns()
    p = time.perf_counter_ns()
    b = time.time_ns()
    return (a + b) // 2 - p


class _Thread:
    """One thread's open spans and its count of appended entries."""
    __slots__ = ("stack", "appended")

    def __init__(self) -> None:
        self.stack: list[int] = []
        self.appended = 0


class SpanRecorder:
    """Bounded ring of spans, intervals and instant events; dumps on
    fault.

    ``capacity`` bounds the ring (oldest entries evicted first, counted
    in :attr:`dropped`).  ``dump_path``, when set, is where
    :meth:`on_fault` writes a Perfetto-loadable Chrome-trace JSON of the
    ring's contents.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 dump_path: str | None = None) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.dump_path = dump_path
        #: what :meth:`clock` adds to ``time.perf_counter_ns()``
        self.offset_ns = _wall_offset_ns()
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._threads: list[_Thread] = []
        self._cleared = 0

    def clock(self) -> int:
        """Now, in nanoseconds on the ``time.time_ns()`` clock."""
        return time.perf_counter_ns() + self.offset_ns

    def _thread(self) -> _Thread:
        try:
            return self._local.t
        except AttributeError:
            t = self._local.t = _Thread()
            self._threads.append(t)
            return t

    def _append(self, t: _Thread, e: dict[str, Any]) -> None:
        t.appended += 1
        self._ring.append(e)

    # -- recording (lock-free) -----------------------------------------
    def begin(self, name: str, *, bin: Any = None, lane: str | None = None,
              node: Any = None, stage: Any = None, detached: bool = False,
              **attrs: Any) -> int:
        """Open a span; returns the span id to pass to :meth:`end`.  The
        calling thread's innermost open span is its ``parent``, unless
        ``detached`` (module docstring)."""
        t = self._thread()
        sid = next(self._ids)
        e: dict[str, Any] = {"ph": "B", "span": sid, "name": name,
                             "ts": self.clock()}
        if not detached:
            if t.stack:
                e["parent"] = t.stack[-1]
            t.stack.append(sid)
        _put(e, bin=bin, lane=lane, node=node, stage=stage, **attrs)
        self._append(t, e)
        return sid

    def end(self, span: int, **attrs: Any) -> None:
        t = self._thread()
        e: dict[str, Any] = {"ph": "E", "span": span, "ts": self.clock()}
        _put(e, **attrs)
        self._append(t, e)
        stack = t.stack
        if span in stack:
            del stack[stack.index(span):]

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[int]:
        sid = self.begin(name, **attrs)
        try:
            yield sid
        finally:
            self.end(sid)

    def complete(self, name: str, start: int, end: int,
                 **attrs: Any) -> int:
        """Record an interval ``[start, end]`` (nanoseconds on
        :meth:`clock`'s clock) known after the fact; its parent is the
        calling thread's innermost open span.  Returns its id."""
        t = self._thread()
        sid = next(self._ids)
        e: dict[str, Any] = {"ph": "X", "span": sid, "name": name,
                             "ts": start, "end_ts": end}
        if t.stack:
            e["parent"] = t.stack[-1]
        _put(e, **attrs)
        self._append(t, e)
        return sid

    def event(self, name: str, *, bin: Any = None, lane: str | None = None,
              node: Any = None, span: int | None = None,
              **attrs: Any) -> None:
        """Record an instant event (spill, steal, preemption, ...)."""
        e: dict[str, Any] = {"ph": "i", "name": name, "ts": self.clock()}
        _put(e, bin=bin, lane=lane, node=node, span=span, **attrs)
        self._append(self._thread(), e)

    # -- inspection / draining -----------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        """Entries that fell off the ring since construction (or the last
        :meth:`clear`); exact once no thread is recording."""
        total = sum(t.appended for t in list(self._threads))
        return max(0, total - self._cleared - len(self._ring))

    def entries(self) -> list[dict[str, Any]]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    def events(self, name: str | None = None) -> list[dict[str, Any]]:
        """Instant events only, optionally filtered by name."""
        return [e for e in self._ring
                if e["ph"] == "i" and (name is None or e["name"] == name)]

    def spans(self) -> list[dict[str, Any]]:
        """Completed spans and intervals still in the ring, in the order
        they ended.

        A span is its begin entry plus ``end_ts``; an interval is its
        entry.  Spans whose begin fell off the ring, or that are still
        open, are left out (the flight recorder keeps a window, not the
        world).
        """
        open_: dict[int, dict[str, Any]] = {}
        done: list[dict[str, Any]] = []
        for e in list(self._ring):
            ph = e["ph"]
            if ph == "B":
                open_[e["span"]] = e
            elif ph == "E":
                b = open_.pop(e["span"], None)
                if b is not None:
                    done.append({**b, "end_ts": e["ts"]})
            elif ph == "X":
                done.append(dict(e))
        return done

    def clear(self) -> None:
        self._ring.clear()
        self._cleared = sum(t.appended for t in list(self._threads))

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
