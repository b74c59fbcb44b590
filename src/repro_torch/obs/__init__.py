"""repro_torch.obs — observability: spans, metrics, a timeline export.

Three cooperating pieces, each usable alone:

* :class:`SpanRecorder` — a lock-cheap structured span/event recorder
  on the clock of ``time.time_ns()`` (the clock of a ``torch.profiler``
  trace).  Begin/end spans carry their parent span and bin/lane/node/
  stage or request attribution; ``complete`` intervals carry device
  time read from CUDA events; instant events mark spills, refills,
  steals, preemptions, straggler demotions, bin join/retire/fail, and
  chaos triggers.  Entries land in a bounded flight-recorder ring
  buffer (``dropped`` counts what fell off) that can :meth:`dump
  <SpanRecorder.dump>` a Perfetto-loadable trace on fault.
* :class:`MetricsRegistry` — named counters, gauges, and histograms
  (nearest-rank p50/p99).  The executor, serving engine, and
  simulator publish into one; their ``stats()`` dicts are back-compat
  views over it.
* :func:`timeline_from_recorder` — a recorder's ring as Chrome-trace
  JSON (:func:`save_timeline`, checked by :func:`validate_timeline`),
  openable at https://ui.perfetto.dev.

Everything is off by default: components that accept an ``obs=``
recorder treat ``None`` as "no instrumentation".  The spans the
executor and the serving engine record are listed where they are made
(``core/executor.py``, ``serving/engine.py``).
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .recorder import SpanRecorder
from .timeline import save_timeline, timeline_from_recorder, validate_timeline

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanRecorder",
    "save_timeline",
    "timeline_from_recorder",
    "validate_timeline",
]
