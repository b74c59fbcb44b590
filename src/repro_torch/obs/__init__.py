"""repro_torch.obs — unified observability: spans, metrics, timelines.

Three cooperating pieces, each usable alone:

* :class:`SpanRecorder` — a lock-cheap structured span/event recorder.
  Begin/end spans carry bin/lane/node/stage attribution; instant
  events mark spills, refills, steals, preemptions, straggler
  demotions, bin join/retire/fail, and chaos triggers.  Entries land
  in a bounded flight-recorder ring buffer that can :meth:`dump
  <SpanRecorder.dump>` a Perfetto-loadable trace on fault.
* :class:`MetricsRegistry` — named counters, gauges, and histograms
  (nearest-rank p50/p99).  The executor, serving engine, and
  simulator publish into one; their ``stats()`` dicts are back-compat
  views over it.
* the timeline exporters — :func:`timeline_from_trace` (a live
  :class:`~repro_torch.sched.TaskProfiler` run), :func:`timeline_from_schedule`
  (a simulated :class:`~repro_torch.sched.SimReport`), and
  :func:`timeline_from_recorder` (a flight-recorder ring) all render
  per-bin copy∥compute lane timelines as Chrome-trace JSON, openable
  at https://ui.perfetto.dev.  :func:`diff_timelines` aligns a
  measured run against its replayed simulation and quantifies
  per-bin/per-lane divergence.

Everything is off by default: components that accept an ``obs=``
recorder treat ``None`` as "no instrumentation, zero overhead".
See docs/observability.md for the span model and workflow.
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .recorder import SpanRecorder
from .timeline import (
    diff_timelines,
    merge_timelines,
    save_timeline,
    timeline_from_recorder,
    timeline_from_schedule,
    timeline_from_trace,
    validate_timeline,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanRecorder",
    "diff_timelines",
    "merge_timelines",
    "save_timeline",
    "timeline_from_recorder",
    "timeline_from_schedule",
    "timeline_from_trace",
    "validate_timeline",
]
