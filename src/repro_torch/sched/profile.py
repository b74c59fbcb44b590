"""Executor telemetry → JSON traces → cost-model calibration inputs.

The StarPU lesson (Courtès 2013): a heterogeneous scheduler is only as
good as its cost model, and the only trustworthy cost model is one fitted
from *measured* runs.  :class:`TaskProfiler` closes that loop for the
heteroflow executor:

* the executor's invoke path reports every node it runs — wall-clock
  start/end, the node's abstract cost, bytes moved, the worker that ran
  it, and the run-stable bin label (``node.bin_key``) placement assigned;
* dispatch-lane counters/timestamps (``core.streams.DispatchLane``) are
  snapshotted at trace finalization, giving per-physical-device residency
  alongside the per-node records;
* the result serializes to a versioned JSON trace that
  :meth:`repro_torch.sched.CostModel.fit` consumes to calibrate
  ``compute_rate`` / bandwidths / ``device_speed`` — after which the
  simulator *predicts* measured makespans instead of merely ranking
  policies.

Trace format (``version`` 3)::

    {
      "version": 3,
      "meta": {"bins": ["cpu:0#0", "mesh:2x2[0]"], "workers": 4,
               "policy": "heft",
               "bin_descriptors": [
                 {"kind": "device", "label": "cpu:0#0",
                  "capabilities": ["cpu", "device"], "device_count": 1},
                 {"kind": "mesh", "label": "mesh:2x2[0]",
                  "capabilities": ["cpu", "mesh"], "device_count": 4,
                  "axis_shape": {"data": 2, "model": 2}}]},
      "records": [
        {"node": 17, "name": "k3", "type": "kernel", "bin": "cpu:0#0",
         "worker": 2, "iteration": 0, "start": 0.0012, "end": 0.0034,
         "cost": 250.0, "bytes": 0, "xfer_bytes": 4096},
        ...
      ],
      "lanes": {"cpu:0": {"dispatched": 96, "retired": 96, "depth": 0,
                          "max_depth": 3, "first_dispatch_ts": ...,
                          "last_retire_ts": ...}}
    }

``start``/``end`` are seconds on a shared monotonic clock, rebased so the
first record starts at 0 when the trace is exported (raw perf-counter
values are meaningless across processes).

Version 2 added ``xfer_bytes`` per kernel record — the bytes of operands
resident on a *different* bin than the kernel's own at invoke time
(cross-bin device-to-device traffic), which ``CostModel.fit`` uses to
calibrate ``d2d_bandwidth`` — and the lanes' ``max_depth`` in-flight
high-watermark.  Version 3 adds ``meta.bin_descriptors`` — one
serialized ``repro_torch.sched.bins`` descriptor per bin slot (kind / label /
capabilities / device_count, plus ``axis_shape`` for mesh slices), so a
trace recorded over mesh bins replays with the right lane widths
(``sched.bins.bins_from_trace`` reconstructs them) — and a ``requires``
tag list on records whose node carried capability tags, which
``CostModel.fit`` uses to normalize the slice speedup out of
mesh-sharded kernel durations.  Version 4 adds the pipeline-stage
dimension: a ``stage`` id on records whose node carried one
(``Heteroflow.kernel(..., stage=s)``), and stage-bin descriptors
(``kind: "stage"``) embedding the wrapped ``member`` descriptor plus
the inter-stage **link** figures (``link_bandwidth`` /
``link_latency_s``) — enough for ``bins_from_trace`` to rebuild the
stage pool and for ``CostModel.fit`` to calibrate
``stage_link_bandwidth`` from the excess duration of kernels that ran
on stage bins with cross-bin operands.  Version 5 adds the memory
dimension: an optional ``memory_bytes`` budget on bin descriptors
(``bins_from_trace`` restores it), and a top-level ``events`` list of
executor arena **spill/refill** records —
``{"type": "spill"|"refill", "bin": label, "bytes": n,
"start": t0, "end": t1}`` — which ``CostModel.fit`` uses to calibrate
``spill_bandwidth``.  Version 6 adds correlation ids to those events:
``"node"`` — the node id whose arena block was spilled/refilled — and
``"span"`` — the node id of the task *being invoked* when the arena
round trip fired (the kernel whose allocation forced the eviction, or
whose operand conversion pulled the block back), both omitted when
unknown, so the ``repro_torch.obs`` timeline can join arena activity to the
task that triggered it.  Version-1…-5 traces still load; readers
treat the missing fields as 0 / plain device bins / no tags / no
stages / no budgets / no events / no correlation ids.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any

from repro_torch.core.graph import Node, TaskType
from repro_torch.core.placement import _nbytes

__all__ = ["TaskRecord", "TaskProfiler", "node_bytes", "producer_bytes",
           "cross_bin_bytes", "load_trace"]

TRACE_VERSION = 6
#: versions load_trace accepts (v1 lacks xfer_bytes — readers default it
#: 0; v1/v2 lack meta.bin_descriptors — readers assume plain device
#: bins; v1-v3 lack per-record stage ids — readers assume no stages;
#: v1-v4 lack bin memory budgets and spill/refill events — readers
#: assume unlimited memory and no spills; v5 events lack node/span
#: correlation ids — readers treat arena events as uncorrelated)
SUPPORTED_TRACE_VERSIONS = (1, 2, 3, 4, 5, 6)


def node_bytes(node: Node) -> int:
    """Bytes a node moves across the host-device boundary.

    Pulls transfer their host span H2D; pushes transfer their source
    pull's span D2H; kernels and host tasks move nothing directly (their
    operands are already resident — cross-bin kernel edges are charged by
    the simulator, not recorded here).
    """
    if node.type == TaskType.PULL:
        return _nbytes(node.state.get("source"), node.state.get("size"))
    if node.type == TaskType.PUSH:
        src = node.state.get("src")
        if src is not None:
            return _nbytes(src.state.get("source"), src.state.get("size"))
    return 0


def producer_bytes(node: Node) -> int:
    """Bytes a downstream consumer on *another bin* would have to move.

    Pulls produce their host span; kernels forward the largest of their
    source pulls' spans (the span-size estimate Algorithm 1's default
    cost metric uses — shared with ``CostModel.out_bytes``)."""
    if node.type == TaskType.PULL:
        return _nbytes(node.state.get("source"), node.state.get("size"))
    if node.type == TaskType.KERNEL:
        srcs = node.state.get("sources", ())
        return max((producer_bytes(s) for s in srcs), default=0)
    return 0


def cross_bin_bytes(node: Node) -> int:
    """Bytes of ``node``'s predecessors resident on a different bin.

    Only kernels can see cross-bin operands (affinity grouping co-places
    a kernel with its own pulls, so cross-bin edges are kernel→kernel
    dependencies between groups).  Recorded per kernel in version-2
    traces as ``xfer_bytes`` — the observable ``d2d_bandwidth``
    calibration signal."""
    if node.type != TaskType.KERNEL or node.bin_key is None:
        return 0
    return sum(producer_bytes(d) for d in node.dependents
               if d.bin_key is not None and d.bin_key != node.bin_key)


@dataclass(frozen=True)
class TaskRecord:
    """One executed node: what ran, where, and for how long."""

    node_id: int
    name: str
    type: str                  # TaskType.value
    bin: str | None            # stable bin label; None for host-pool tasks
    worker: int
    iteration: int
    start: float               # seconds, shared monotonic clock
    end: float
    cost: float                # abstract cost (executor's cost_fn)
    bytes: int
    xfer_bytes: int = 0        # cross-bin operand bytes (kernels, v2)
    #: capability tags the node carried (kernels, v3) — fit() needs them
    #: to undo the slice speedup baked into mesh-sharded durations
    requires: tuple = ()
    #: pipeline-stage id the node carried (v4); None outside pipelines
    stage: int | None = None

    @property
    def duration(self) -> float:
        return self.end - self.start


class TaskProfiler:
    """Collects :class:`TaskRecord`s from a live executor run.

    Thread-safe: every worker thread reports through :meth:`record`.
    Pass one to ``Executor(profiler=...)``; the executor calls
    :meth:`record` per executed node and :meth:`finalize` is invoked by
    the user (or implicitly by :meth:`trace`) to snapshot lane state.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: list[TaskRecord] = []
        self._lanes: dict[str, dict[str, Any]] = {}
        self._meta: dict[str, Any] = {}
        self._events: list[dict[str, Any]] = []

    # -- collection (executor side) ------------------------------------
    def record(self, node: Node, *, worker: int, iteration: int,
               start: float, end: float, cost: float) -> None:
        rec = TaskRecord(
            node_id=node.id,
            name=node.name,
            type=node.type.value,
            bin=node.bin_key,
            worker=worker,
            iteration=iteration,
            start=start,
            end=end,
            cost=cost,
            bytes=node_bytes(node),
            xfer_bytes=cross_bin_bytes(node),
            requires=tuple(sorted(node.state.get("requires", ()))),
            stage=node.state.get("stage"),
        )
        with self._lock:
            self._records.append(rec)

    def record_event(self, type: str, *, bin: str | None, bytes: int,
                     start: float, end: float, node: int | None = None,
                     span: int | None = None) -> None:
        """Record a non-node runtime event (v5): arena ``spill`` /
        ``refill`` round trips the executor's memory-pressure path
        performs.  Shares the records' monotonic clock and is rebased
        with them at export.

        ``node`` (v6) is the node id whose arena block moved; ``span``
        is the node id of the task being invoked when the round trip
        fired — together they join an arena event to the kernel that
        triggered it.  Both optional: omitted keys keep the event
        readable by v5 consumers.
        """
        ev = {"type": str(type), "bin": bin, "bytes": int(bytes),
              "start": float(start), "end": float(end)}
        if node is not None:
            ev["node"] = node
        if span is not None:
            ev["span"] = span
        with self._lock:
            self._events.append(ev)

    def finalize(self, executor: Any) -> None:
        """Snapshot executor metadata + per-device lane counters.

        Lane keys use the executor's ``_lane_views`` labeling (shared
        with ``stats()["lane_depths"]``): lanes backing this executor's
        bins carry the bins-order ``meta.bins`` label, so the same
        string denotes the same bin slot in ``records[*].bin``,
        ``meta.bins``, and ``lanes`` — stable across runs.
        """
        from .bins import describe_bin  # local: bins imports core only

        lanes = {key: lane.snapshot()
                 for key, lane in executor._lane_views()}
        labels = list(executor.device_labels)
        descriptors = []
        for b, label in zip(executor.devices, labels):
            d = describe_bin(b)
            d["label"] = label          # bins-order slot label, deduped
            descriptors.append(d)
        meta = {
            "bins": labels,
            "workers": executor.num_workers,
            "policy": executor.scheduler.name,
            "bin_descriptors": descriptors,
        }
        with self._lock:
            self._lanes = lanes
            self._meta = meta

    # -- introspection --------------------------------------------------
    @property
    def records(self) -> list[TaskRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._events.clear()
            self._lanes = {}

    def makespan(self) -> float:
        """Measured makespan: last record end − first record start."""
        recs = self.records
        if not recs:
            return 0.0
        return max(r.end for r in recs) - min(r.start for r in recs)

    def bin_busy(self) -> dict[str, float]:
        """Busy seconds per bin label (device tasks only)."""
        busy: dict[str, float] = {}
        for r in self.records:
            if r.bin is not None:
                busy[r.bin] = busy.get(r.bin, 0.0) + r.duration
        return busy

    # -- export ---------------------------------------------------------
    def trace(self) -> dict[str, Any]:
        """The versioned JSON-serializable trace dict."""
        recs = self.records
        with self._lock:
            lanes = {k: dict(v) for k, v in self._lanes.items()}
            meta = dict(self._meta)
            events = [dict(e) for e in self._events]
        t0 = min((r.start for r in recs),
                 default=min((e["start"] for e in events), default=0.0))
        for e in events:
            e["start"] -= t0
            e["end"] -= t0
        # lane timestamps share the records' perf_counter clock; rebase
        # them onto the same t=0 origin as the records
        for snap in lanes.values():
            for field in ("first_dispatch_ts", "last_dispatch_ts",
                          "last_retire_ts"):
                if snap.get(field) is not None:
                    snap[field] -= t0
        return {
            "version": TRACE_VERSION,
            "meta": meta,
            "records": [
                {
                    "node": r.node_id, "name": r.name, "type": r.type,
                    "bin": r.bin, "worker": r.worker,
                    "iteration": r.iteration,
                    "start": r.start - t0, "end": r.end - t0,
                    "cost": r.cost, "bytes": r.bytes,
                    "xfer_bytes": r.xfer_bytes,
                    # tags/stages only when present (readers default
                    # to none)
                    **({"requires": list(r.requires)} if r.requires
                       else {}),
                    **({"stage": r.stage} if r.stage is not None
                       else {}),
                }
                for r in recs
            ],
            "lanes": lanes,
            # v5: arena spill/refill events (empty list when the run
            # never hit memory pressure)
            "events": events,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.trace(), f, indent=1)

    # The executor stamps timestamps itself (one clock for all workers);
    # exposed so tests and external callers agree on the clock used.
    clock = staticmethod(time.perf_counter)


def load_trace(path: str) -> dict[str, Any]:
    """Load a saved trace, validating the format version.

    Version 1 (no per-kernel ``xfer_bytes``) still loads — consumers
    default the field to 0, so d2d calibration is simply skipped."""
    with open(path) as f:
        trace = json.load(f)
    v = trace.get("version")
    if v not in SUPPORTED_TRACE_VERSIONS:
        raise ValueError(f"unsupported trace version {v!r} in {path} "
                         f"(expected one of {SUPPORTED_TRACE_VERSIONS})")
    return trace
