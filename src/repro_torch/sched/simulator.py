"""Discrete-event simulator for heteroflow graphs (estee-style).

Scores a placement *offline*: no devices, no threads, no wall-clock —
just resource clocks advanced by a :class:`CostModel`.  This is the tool
the scheduler study needs (estee, "Analysis of workflow schedulers in
simulated distributed environments"): policies are compared on simulated
makespan / utilization over synthetic graphs before any hardware run.

Model
-----
* Every device bin multiplexes **two lanes**, mirroring the paper's
  per-device streams (``core.streams``): a **copy lane** serializing
  memory ops (H2D pulls, D2H pushes) and a **compute lane** serializing
  kernels.  With ``CostModel.lane_depth >= 2`` (the default,
  ``core.streams.DEFAULT_LANE_DEPTH``) the two lanes run concurrently,
  so transfers overlap compute — the overlap the paper's speedups come
  from (Heteroflow §IV).  ``lane_depth=1`` collapses both lanes into one
  serialized queue per bin (the pre-lane conservative model).
* Every task — device or host — additionally occupies one slot of a
  bounded **worker pool** (``host_workers``) for its duration, matching
  the executor's work-stealing threads: a one-worker executor serializes
  everything regardless of lanes, and the simulator reproduces that.
* **host/placeholder** nodes use a worker slot only.
* A dependency crossing two different bins charges a transfer:
  ``latency + bytes / d2d_bandwidth``, with bytes estimated from the
  producer's ``_nbytes`` (the same span-size estimate Algorithm 1's
  default cost metric uses).  ``d2d_bandwidth`` is calibrated by
  :meth:`CostModel.fit` from the cross-bin byte counts version-2 traces
  record per kernel.
* Ready tasks are dispatched FIFO per resource with deterministic
  ``(arrival, node.id)`` tie-breaking — two runs over the same graph and
  placement are bit-identical.

Trace replay
------------
``simulate(..., replay=trace)`` reconstructs a recorded executor run:
node durations (and bin assignments, when resolvable) come from the
trace's measured records instead of the cost model, the worker-pool size
comes from ``meta.workers``, and cross-bin transfer charges are skipped
(measured kernel durations already embed them).  The returned report
carries the trace's measured makespan so callers can assert the
simulator's prediction lands within tolerance of reality
(``SimReport.divergence`` — the replay-validation workflow,
docs/scheduling.md).
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.graph import Heteroflow, Node, TaskType
from repro_torch.core.placement import _nbytes, estimate_node_cost
from repro_torch.core.streams import (COMPUTE_LANE, COPY_LANE, DEFAULT_LANE_DEPTH,
                                HOST_LANE, lane_kind)

from .base import (SchedulerState, SchedulerUpdate, bin_index, build_groups,
                   get_scheduler, node_footprint)
from .bins import (bin_compute_scale, bin_lane_width, bin_memory_bytes,
                   mesh_wide, stage_link)
from .profile import producer_bytes

__all__ = ["ArrivalProcess", "CostModel", "FaultEvent", "FaultSchedule",
           "SimReport", "poisson", "simulate", "weak_components"]


@dataclass(frozen=True)
class ArrivalProcess:
    """Deterministic arrival-time generator for online simulation.

    ``times(n)`` returns ``n`` monotonically increasing arrival seconds;
    the same (rate, seed) always yields the same sequence, so simulated
    latency studies are reproducible bit-for-bit.
    """

    rate: float
    seed: int = 0

    def times(self, n: int) -> list[float]:
        rng = random.Random(self.seed)
        t, out = 0.0, []
        for _ in range(n):
            t += rng.expovariate(self.rate)
            out.append(t)
        return out


_FAULT_ACTIONS = ("kill", "slow", "join")


@dataclass(frozen=True)
class FaultEvent:
    """One churn event at a simulated time.

    ``action`` is ``"kill"`` (the bin dies: in-flight work on it is
    rescinded, its unconsumed results are invalidated and the lost
    frontier re-executes on the survivors), ``"slow"`` (future work on
    the bin runs ``factor``× slower — a straggler), or ``"join"``
    (``bin`` is a new bin OBJECT appended to the pool).  For kill/slow
    ``bin`` is a bin index or an existing bin object/label.
    """

    time: float
    action: str
    bin: Any = None
    factor: float = 2.0

    def __post_init__(self) -> None:
        if self.action not in _FAULT_ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; "
                f"expected one of {_FAULT_ACTIONS}")
        if self.time < 0:
            raise ValueError(f"fault time must be >= 0, got {self.time!r}")
        if self.action == "slow" and self.factor <= 0:
            raise ValueError(
                f"slowdown factor must be > 0, got {self.factor!r}")


@dataclass(frozen=True)
class FaultSchedule:
    """A deterministic churn scenario for :func:`simulate`: kill / join /
    slowdown events at simulated times, applied in ``(time, order)``
    order.  Ties against task events resolve in the task's favor — a
    task finishing at exactly the fault time counts as done, so
    ``FaultSchedule`` boundaries are reproducible bit-for-bit.
    """

    events: tuple[FaultEvent, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.events)

    def ordered(self) -> list[FaultEvent]:
        return [e for _, _, e in sorted(
            (e.time, i, e) for i, e in enumerate(self.events))]

    @classmethod
    def kill(cls, time: float, bin: Any) -> "FaultSchedule":
        return cls((FaultEvent(time, "kill", bin),))

    @classmethod
    def slow(cls, time: float, bin: Any, factor: float) -> "FaultSchedule":
        return cls((FaultEvent(time, "slow", bin, factor),))

    @classmethod
    def join(cls, time: float, bin: Any) -> "FaultSchedule":
        return cls((FaultEvent(time, "join", bin),))

    def __add__(self, other: "FaultSchedule") -> "FaultSchedule":
        return FaultSchedule(self.events + other.events)


def poisson(rate: float, seed: int = 0) -> ArrivalProcess:
    """Poisson arrivals at ``rate`` requests/second (exponential
    inter-arrival gaps) — ``simulate(..., arrivals=poisson(8))``."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate!r}")
    return ArrivalProcess(rate=rate, seed=seed)


def weak_components(graph: Heteroflow) -> tuple[dict[int, int], int]:
    """Weakly-connected components of the task graph — one *request* in
    a serving trace, where each request contributes an independent
    prefill→decode chain.  Returns ``({node.id: component}, count)``
    with components numbered by their smallest node id, i.e. request
    submission order (node ids are globally monotonic)."""
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for n in graph.nodes:
        parent.setdefault(n.id, n.id)
    for n in graph.nodes:
        for s in n.successors:
            if s.id in parent:
                ra, rb = find(n.id), find(s.id)
                if ra != rb:
                    parent[rb] = ra
    rep_min: dict[int, int] = {}
    for nid in parent:
        r = find(nid)
        rep_min[r] = min(rep_min.get(r, nid), nid)
    order = {r: i for i, (r, _) in enumerate(
        sorted(rep_min.items(), key=lambda kv: kv[1]))}
    return {nid: order[find(nid)] for nid in parent}, len(order)


@dataclass(frozen=True)
class CostModel:
    """Maps abstract node costs to simulated seconds.

    ``device_speed`` expresses heterogeneity as relative rates per bin
    index (empty = all 1.0); HEFT consumes the same model, so its
    decisions optimize exactly what :func:`simulate` measures.
    ``lane_depth`` selects the per-bin dispatch model: ``>= 2`` lets the
    copy lane overlap the compute lane (paper streams), ``1`` serializes
    each bin.  The defaults are deliberately round numbers that *rank*
    policies; to *predict* wall-clock, calibrate from a recorded
    executor run with :meth:`fit` (profile-guided loop,
    docs/scheduling.md).
    """

    compute_rate: float = 1e6        # kernel cost units / second at speed 1
    h2d_bandwidth: float = 8e9       # bytes / second (pull, push)
    d2d_bandwidth: float = 16e9      # bytes / second (cross-bin edges)
    latency_s: float = 5e-6          # per-transfer fixed cost
    host_time_s: float = 1e-5        # host / placeholder task duration
    device_speed: tuple[float, ...] = ()
    lane_depth: int = DEFAULT_LANE_DEPTH
    #: bytes/s over inter-STAGE links (``StageBin``): the default for
    #: stage bins that declare no explicit ``link_bandwidth``, fitted by
    #: :meth:`fit` from a recorded pipeline run (v4 traces).  0 = unset
    #: → stage transfers fall back to ``d2d_bandwidth``.
    stage_link_bandwidth: float = 0.0
    #: non-ideal sharded scaling (ring-collective α-β model): a
    #: mesh-wide task on an n-device slice pays
    #: ``α·(n−1) + bytes·(n−1)/(n·β)`` on top of its ``compute/n``
    #: share — the latency term per ring hop plus the bandwidth term of
    #: a ring all-reduce.  Both default 0 = overhead off, so the ideal
    #: linear model (and every pre-existing baseline) reproduces
    #: bit-for-bit.
    collective_alpha: float = 0.0    # seconds per ring hop
    collective_beta: float = 0.0     # bytes/s per link; 0 = off
    #: per-kernel-NAME calibration (StarPU keeps one history per
    #: codelet): ``(name, rate, latency_s)`` triples fitted by
    #: :meth:`fit`; kernels with an entry run at
    #: ``latency + cost / (rate * speed)``, unseen names fall back to
    #: the aggregate ``compute_rate``.
    kernel_rates: tuple[tuple[str, float, float], ...] = ()
    #: bytes/s of the spill path (device→host eviction + later host→
    #: device refill).  Calibrated by :meth:`fit` from the spill/refill
    #: events version-5 traces record; 0 = unset → fall back to
    #: ``h2d_bandwidth`` (the spill path rides the same PCIe link).
    spill_bandwidth: float = 0.0
    #: fixed seconds of dispatch overhead charged per dispatch UNIT —
    #: the deque round trip / span / device-scope entry the executor
    #: pays per task.  With ``simulate(..., fuse_batch=N)`` a run of
    #: consecutive same-lane same-bin dispatches shares ONE charge per
    #: batch of ≤ N (mirroring ``Executor(fuse_batch=N)``); unfused,
    #: every task pays it.  Default 0 = off → bit-identical to every
    #: pre-existing baseline.
    dispatch_overhead_s: float = 0.0
    cost_fn: Callable[[Node], float] = estimate_node_cost

    def __post_init__(self) -> None:
        # a negative α/β would silently SHRINK sharded durations below
        # the ideal model — reject it, like StageBin rejects
        # non-positive link figures
        if self.collective_alpha < 0 or self.collective_beta < 0:
            raise ValueError(
                f"collective_alpha/collective_beta must be >= 0 "
                f"(0 = overhead off), got {self.collective_alpha!r}/"
                f"{self.collective_beta!r}")

    def speed(self, bin_index: int) -> float:
        if bin_index < len(self.device_speed):
            return self.device_speed[bin_index]
        return 1.0

    def kernel_rate(self, name: str) -> tuple[float, float]:
        """(rate, fixed latency) for a kernel name — the per-codelet
        history when fitted, the aggregate rate otherwise."""
        cache = getattr(self, "_rate_cache", None)
        if cache is None:
            cache = {n: (r, lat) for n, r, lat in self.kernel_rates}
            object.__setattr__(self, "_rate_cache", cache)
        return cache.get(name, (self.compute_rate, 0.0))

    def out_bytes(self, node: Node) -> int:
        """Bytes a downstream consumer on another bin would transfer."""
        return producer_bytes(node)

    def transfer_time(self, nbytes: int, src_bin: Any = None,
                      dst_bin: Any = None) -> float:
        """Seconds to move ``nbytes`` between two bins.

        When either endpoint is a :class:`~repro_torch.sched.bins.StageBin`
        the transfer crosses that stage's *link* (the destination's
        input link wins): the bin's explicit ``link_bandwidth`` /
        ``link_latency_s``, else the fitted ``stage_link_bandwidth``,
        else generic d2d.  Without stage endpoints the charge is the
        legacy ``latency_s + bytes / d2d_bandwidth`` — bit-identical.
        """
        bw, lat = self.d2d_bandwidth, self.latency_s
        link = (stage_link(src_bin, dst_bin)
                if src_bin is not None or dst_bin is not None else None)
        if link is not None:
            bw = link[0] or self.stage_link_bandwidth or self.d2d_bandwidth
            lat = link[1] if link[1] is not None else self.latency_s
        if nbytes <= 0:
            return lat
        return lat + nbytes / bw

    def spill_time(self, nbytes: int) -> float:
        """Seconds a forced eviction of ``nbytes`` costs: a D2H write now
        plus the H2D refill the victim pays when next consumed — the
        round trip StarPU's memory nodes charge for an eviction."""
        if nbytes <= 0:
            return 0.0
        bw = self.spill_bandwidth or self.h2d_bandwidth
        return 2.0 * (self.latency_s + nbytes / bw)

    def collective_overhead(self, n_devices: int, nbytes: int) -> float:
        """Extra seconds a sharded (mesh-wide) task pays to synchronize
        its n-device slice: the α-β ring model (α per hop latency, β
        per-link bandwidth — ring all-reduce moves ``bytes·(n−1)/n``
        over each link).  Zero when both knobs are 0 (default) or the
        slice has one device, so ideal linear scaling is untouched."""
        n = int(n_devices)
        if n <= 1 or (self.collective_alpha == 0
                      and self.collective_beta == 0):
            return 0.0
        t = self.collective_alpha * (n - 1)
        if self.collective_beta > 0 and nbytes > 0:
            t += nbytes * (n - 1) / (n * self.collective_beta)
        return t

    def node_time(self, node: Node, *, speed: float = 1.0) -> float:
        """Execution time of one node on a resource of relative ``speed``."""
        if node.type == TaskType.KERNEL:
            rate, lat = self.kernel_rate(node.name)
            return lat + self.cost_fn(node) / (rate * (speed or 1.0))
        if node.type == TaskType.PULL:
            nbytes = _nbytes(node.state.get("source"), node.state.get("size"))
            return self.latency_s + nbytes / self.h2d_bandwidth
        if node.type == TaskType.PUSH:
            src = node.state.get("src")
            nbytes = (_nbytes(src.state.get("source"), src.state.get("size"))
                      if src is not None else 0)
            return self.latency_s + nbytes / self.h2d_bandwidth
        return self.host_time_s

    # ------------------------------------------------------------------
    # calibration from recorded runs (StarPU-style history-based model)
    # ------------------------------------------------------------------
    @classmethod
    def fit(cls, trace: Any, *, base: "CostModel | None" = None,
            ) -> "CostModel":
        """Calibrate a model from a recorded executor trace.

        ``trace`` is a :class:`~repro_torch.sched.profile.TaskProfiler`, or the
        dict its ``trace()`` method / ``profile.load_trace`` produce.
        Returns a copy of ``base`` (default: a fresh :class:`CostModel`)
        with the parameters the trace can pin down replaced:

        * ``compute_rate`` — total kernel cost units / total kernel
          seconds (aggregate, so simulated totals reproduce measured
          totals even when per-node cost attributions are noisy);
        * ``device_speed`` — per-bin kernel rate relative to the global
          rate, in trace ``meta.bins`` order (bins without kernel
          records keep speed 1.0);
        * ``h2d_bandwidth`` / ``latency_s`` — from pull/push records:
          latency is the cheapest observed transfer, bandwidth makes the
          remaining time account for the bytes moved;
        * ``d2d_bandwidth`` — from kernels with cross-bin inputs
          (version-2 traces record ``xfer_bytes`` per kernel): the
          duration in excess of the fitted compute time is attributed to
          moving those bytes between bins.  Traces without cross-bin
          kernel records (single-bin runs, version-1 traces) keep the
          ``base`` value;
        * ``host_time_s`` — mean host-task duration.

        The compute-rate fit deliberately excludes cross-bin kernels
        (their durations embed transfer time, which would bias the rate
        low and then double-count against ``d2d_bandwidth``), unless the
        trace has *only* cross-bin kernels.
        """
        if hasattr(trace, "trace"):
            trace = trace.trace()
        base = base or cls()
        meta = trace.get("meta", {})
        records = trace.get("records", ())
        updates: dict[str, Any] = {}

        # mesh-sharded kernels ran device_count× faster than their rate
        # implies (the slice speedup simulate()/HEFT re-apply at predict
        # time) — undo it here so fitted rates are slice-independent and
        # the speedup is not double-counted in the fit→predict loop.
        # v3 traces carry the tags + bin descriptors this needs; older
        # traces scale by 1.
        descs = {d.get("label"): d for d in meta.get("bin_descriptors", ())}

        def rec_scale(r: Mapping[str, Any]) -> float:
            # a stage bin wrapping a mesh slice inherits the slice's
            # device_count, so the same normalization applies
            if "mesh" in r.get("requires", ()):
                d = descs.get(r.get("bin"))
                if d is not None and d.get("kind") in ("mesh", "stage"):
                    return float(d.get("device_count", 1)) or 1.0
            return 1.0

        kernels = [r for r in records if r["type"] == "kernel"]
        local = [r for r in kernels if not r.get("xfer_bytes", 0)]
        rate_pool = local or kernels
        k_cost = sum(r["cost"] for r in rate_pool)
        k_secs = sum((r["end"] - r["start"]) * rec_scale(r)
                     for r in rate_pool)
        rate = None
        speeds: list[float] = []
        bins = list(meta.get("bins", ()))
        if k_cost > 0 and k_secs > 0:
            rate = k_cost / k_secs
            updates["compute_rate"] = rate
            if bins:
                for label in bins:
                    bc = sum(r["cost"] for r in rate_pool
                             if r["bin"] == label)
                    bs = sum((r["end"] - r["start"]) * rec_scale(r)
                             for r in rate_pool if r["bin"] == label)
                    speeds.append((bc / bs) / rate if bc > 0 and bs > 0
                                  else 1.0)
                updates["device_speed"] = tuple(speeds)

        def speed_of(label: Any) -> float:
            if label in bins and len(speeds) == len(bins):
                return speeds[bins.index(label)] or 1.0
            return 1.0

        # per-codelet history (StarPU): one (rate, latency) per kernel
        # NAME.  Durations are normalized by the bin speed fitted above,
        # so the history composes with device_speed at prediction time;
        # a least-squares (latency, 1/rate) line is fitted when the name
        # was observed at two or more distinct costs, otherwise the
        # latency stays 0 and the rate is the name's cost/seconds.
        if rate:
            by_name: dict[str, list] = {}
            for r in rate_pool:
                if r.get("name"):
                    by_name.setdefault(r["name"], []).append(r)
            named: list[tuple[str, float, float]] = []
            for name, rs in sorted(by_name.items()):
                pts = [(r["cost"],
                        max(r["end"] - r["start"], 1e-12)
                        * speed_of(r.get("bin")) * rec_scale(r))
                       for r in rs]
                cost = sum(c for c, _ in pts)
                secs = sum(d for _, d in pts)
                if cost <= 0 or secs <= 0:
                    continue
                n_rate, n_lat = cost / secs, 0.0
                if len({c for c, _ in pts}) >= 2:
                    mc = cost / len(pts)
                    md = secs / len(pts)
                    var = sum((c - mc) ** 2 for c, _ in pts)
                    cov = sum((c - mc) * (d - md) for c, d in pts)
                    slope = cov / var if var > 0 else 0.0
                    lat = md - slope * mc
                    if slope > 0 and lat >= 0:
                        n_rate, n_lat = 1.0 / slope, lat
                named.append((name, n_rate, n_lat))
            if named:
                updates["kernel_rates"] = tuple(named)

        xfers = [r for r in records if r["type"] in ("pull", "push")]
        latency = base.latency_s
        if xfers:
            durations = [max(r["end"] - r["start"], 1e-9) for r in xfers]
            latency = min(durations)
            updates["latency_s"] = latency
            total_bytes = sum(r["bytes"] for r in xfers)
            if total_bytes > 0:
                beyond = max(sum(durations) - latency * len(durations), 1e-9)
                updates["h2d_bandwidth"] = total_bytes / beyond

        # d2d: excess kernel time over the fitted compute time, attributed
        # to the cross-bin bytes those kernels pulled from other bins.
        # Kernels that ran ON a stage bin crossed a stage *link* (v4
        # traces carry the bin descriptors saying so), so their excess
        # calibrates stage_link_bandwidth instead of the generic d2d —
        # the knob a recorded pipeline run can actually pin down.
        cross = [r for r in kernels if r.get("xfer_bytes", 0) > 0]
        def _on_stage(r: Mapping[str, Any]) -> bool:
            return descs.get(r.get("bin"), {}).get("kind") == "stage"

        staged = [r for r in cross if _on_stage(r)]
        generic = [r for r in cross if not _on_stage(r)]

        def _xfer_bw(pool: list) -> float | None:
            excess = sum(
                max((r["end"] - r["start"])
                    - r["cost"] / (rate * speed_of(r["bin"])
                                   * rec_scale(r)), 0.0)
                for r in pool)
            nbytes = sum(r["xfer_bytes"] for r in pool)
            beyond = excess - latency * len(pool)
            if nbytes > 0 and beyond > 0:
                return nbytes / beyond
            return None

        if rate:
            if generic:
                bw = _xfer_bw(generic)
                if bw is not None:
                    updates["d2d_bandwidth"] = bw
            if staged:
                bw = _xfer_bw(staged)
                if bw is not None:
                    updates["stage_link_bandwidth"] = bw

        hosts = [r for r in records
                 if r["type"] in ("host", "placeholder")]
        if hosts:
            updates["host_time_s"] = (
                sum(r["end"] - r["start"] for r in hosts) / len(hosts))

        # spill path: v5 traces record executor arena evictions/refills
        # as events with bytes + timestamps — the observed round-trip
        # rate calibrates spill_bandwidth (older traces have no events
        # list and keep the base value)
        spills = [e for e in trace.get("events", ())
                  if e.get("type") in ("spill", "refill")
                  and e.get("bytes", 0) > 0]
        if spills:
            sp_bytes = sum(e["bytes"] for e in spills)
            sp_secs = sum(max(e.get("end", 0.0) - e.get("start", 0.0), 1e-9)
                          for e in spills)
            if sp_bytes > 0 and sp_secs > 0:
                updates["spill_bandwidth"] = sp_bytes / sp_secs

        return dataclasses.replace(base, **updates)


@dataclass
class SimReport:
    """Outcome of one simulated run."""

    makespan: float
    #: bin index -> busy SERVER-seconds summed over BOTH lanes (work
    #: conserved across lane modes; a mesh-wide task is charged once per
    #: occupied member lane; may exceed makespan when copy overlaps
    #: compute or a multi-lane bin runs tasks concurrently)
    busy: dict[int, float]
    #: bin index -> busy / (makespan * lane width): 1.0 = every member
    #: lane pair full; can exceed 1.0 when copies hide behind compute
    utilization: dict[int, float]
    host_busy: float
    n_transfers: int
    transfer_seconds: float
    lane_busy: dict[int, dict[str, float]] = field(repr=False,
                                                   default_factory=dict)
    finish_times: dict[int, float] = field(repr=False, default_factory=dict)
    #: (node_id, lane_kind, bin_index, start, end) per executed node;
    #: lane_kind is "copy"/"compute"/"host" (bin_index -1 for host).
    #: Property tests verify feasibility + lane capacity from this.
    schedule: list = field(repr=False, default_factory=list)
    #: measured wall-clock makespan of the replayed trace (replay mode
    #: only) — compare against ``makespan`` via :attr:`divergence`.
    measured_makespan: float | None = None
    #: bin index -> high-water resident bytes (pull spans + kernel
    #: activation bytes charged at dispatch).  Pure integer bookkeeping:
    #: tracked whether or not budgets are set, and never exceeds a bin's
    #: ``memory_bytes`` when one is — overflow is converted into forced
    #: spill events instead.
    peak_bytes: dict[int, int] = field(repr=False, default_factory=dict)
    #: forced evictions the simulated run needed to stay under budget
    n_spills: int = 0
    #: seconds charged to those evictions (D2H + refill round trips)
    spill_seconds: float = 0.0
    #: per-request latency rows (``simulate(..., arrivals=...)`` only;
    #: one per weakly-connected component, in arrival order):
    #: ``{"arrival": s, "ttft": s, "complete": s}`` where *ttft* is the
    #: first kernel finish minus arrival (time-to-first-token on a
    #: prefill→decode chain) and *complete* is the last finish minus
    #: arrival (total request latency).
    request_latency: list = field(repr=False, default_factory=list)
    #: tasks a :class:`FaultSchedule` kill forced to run again: results
    #: produced on the dead bin but still needed downstream, plus
    #: in-flight tasks that had already started when the bin died
    n_reexecuted: int = 0
    #: seconds of work those kills threw away (full durations of
    #: invalidated results + the started-but-aborted fractions) — the
    #: honest re-execution charge the makespan already embeds
    recovery_seconds: float = 0.0

    @property
    def divergence(self) -> float | None:
        """Relative error of the simulated vs. the replayed measured
        makespan; None outside replay mode."""
        if self.measured_makespan is None or self.measured_makespan <= 0:
            return None
        return (self.makespan - self.measured_makespan) / self.measured_makespan

    def summary(self) -> str:
        util = "/".join(f"{u:.2f}" for _, u in sorted(self.utilization.items()))
        out = (f"makespan={self.makespan * 1e3:.3f}ms util={util} "
               f"transfers={self.n_transfers}")
        if self.divergence is not None:
            out += (f" measured={self.measured_makespan * 1e3:.3f}ms "
                    f"divergence={self.divergence:+.1%}")
        return out


_HOST = -1  # bin index for the worker-pool-only resource
_HOST_LANE = HOST_LANE

#: node type -> lane class on its bin (the shared streams.lane_kind
#: rule, so simulated schedules and obs timelines agree on lane names)
_LANE_OF = {t: lane_kind(t) for t in
            (TaskType.PULL, TaskType.PUSH, TaskType.KERNEL)}


class _Replay:
    """Measured durations / bins / concurrency from a recorded trace."""

    def __init__(self, trace: Any, bins: Sequence[Any]):
        if hasattr(trace, "trace"):
            trace = trace.trace()
        self.meta = trace.get("meta", {})
        labels = list(self.meta.get("bins", ()))
        records = trace.get("records", ())
        sums: dict[str, float] = {}
        counts: dict[str, int] = {}
        self.bin_of: dict[str, int] = {}
        spans: dict[Any, tuple[float, float]] = {}   # iteration -> (t0, t1)
        node_of: dict[str, Any] = {}
        for r in records:
            name = r["name"]
            # replay matches by name (ids differ across graph rebuilds);
            # user-supplied duplicate names would silently merge nodes
            if node_of.setdefault(name, r.get("node")) != r.get("node"):
                raise ValueError(
                    f"trace replay needs unique node names, but "
                    f"{name!r} covers two distinct nodes")
            sums[name] = sums.get(name, 0.0) + (r["end"] - r["start"])
            counts[name] = counts.get(name, 0) + 1
            if r.get("bin") in labels:
                idx = labels.index(r["bin"])
                if idx < len(bins):
                    self.bin_of[name] = idx
            it = r.get("iteration", 0)
            t0, t1 = spans.get(it, (r["start"], r["end"]))
            spans[it] = (min(t0, r["start"]), max(t1, r["end"]))
        self.duration = {n: sums[n] / counts[n] for n in sums}
        # durations are averaged per node across iterations, so the
        # simulation predicts ONE graph pass — compare it against the
        # mean per-iteration measured span, not the whole-trace span
        # (a trace covering N runs would otherwise read as ~-(1-1/N)
        # divergence regardless of model quality)
        self.measured_makespan = (
            sum(t1 - t0 for t0, t1 in spans.values()) / len(spans)
            if spans else 0.0)
        self.workers = self.meta.get("workers")


def simulate(
    graph: Heteroflow,
    placement: Mapping[int, Any],
    bins: Sequence[Any],
    *,
    cost_model: CostModel | None = None,
    host_workers: int = 4,
    replay: Any = None,
    arrivals: "ArrivalProcess | Sequence[float] | None" = None,
    faults: "FaultSchedule | None" = None,
    fault_policy: Any = "balanced",
    metrics: Any = None,
    fuse_batch: int = 0,
) -> SimReport:
    """Simulate ``graph`` under a ``{node.id: bin}`` placement.

    ``placement`` is exactly what ``Scheduler.schedule`` (or the legacy
    ``core.placement.place``) returns; nodes absent from it (host)
    run on the worker pool only.  Pushes ride the copy lane of their
    source pull's bin (D2H).  ``replay`` reconstructs a recorded run
    instead of consulting the cost model — see the module docstring.

    ``arrivals`` switches the simulator from batch to **online** mode:
    each weakly-connected component of the graph is one *request*
    (see :func:`weak_components`) released at the corresponding arrival
    time — an :func:`poisson` process or an explicit time list, in
    component (= submission) order.  Source tasks then dispatch at
    their request's arrival instead of t=0, and the report gains
    :attr:`SimReport.request_latency` (TTFT + completion per request).
    ``arrivals=None`` is the unchanged batch path, bit-for-bit.

    ``faults`` injects bin churn (:class:`FaultSchedule`): at each
    event's simulated time the pool mutates — a *join* appends a bin, a
    *slow* multiplies the bin's future task durations, a *kill* marks
    the bin dead, rescinds its in-flight work, invalidates results
    produced there but not yet consumed, re-places the displaced groups
    through ``fault_policy``'s :meth:`Scheduler.update`
    (``retired_bins=...``) and re-dispatches the lost frontier on the
    survivors.  Re-execution is charged honestly
    (:attr:`SimReport.n_reexecuted` / :attr:`SimReport.recovery_seconds`).
    Killing the last live bin raises :class:`ValueError`.
    ``faults=None`` leaves every code path bit-identical.

    ``metrics`` — an optional ``repro_torch.obs.MetricsRegistry`` — receives
    the report's headline figures via :func:`publish_report` after the
    simulation completes; the simulated numbers themselves are
    untouched (instrumentation never perturbs the model).

    ``fuse_batch`` mirrors ``Executor(fuse_batch=N)`` for the
    ``CostModel.dispatch_overhead_s`` charge: unfused (``0``), every
    task pays the overhead; fused (``>= 2``), a run of consecutive
    same-lane same-bin dispatches shares one charge per batch of ≤ N.
    With ``dispatch_overhead_s`` at its 0 default the knob is inert and
    every duration is bit-identical to pre-existing baselines.
    """
    model = cost_model or CostModel()
    if faults is not None and replay is not None:
        raise ValueError("faults= and replay= are mutually exclusive "
                         "(replayed durations embed the real pool)")
    if fuse_batch < 0:
        raise ValueError("fuse_batch must be >= 0")
    overlap = model.lane_depth >= 2
    order = graph.topological_order()
    if order is None:
        raise ValueError(f"graph '{graph.name}' contains a cycle")
    if graph.empty():
        return SimReport(0.0, {}, {}, 0.0, 0, 0.0)
    rp = _Replay(replay, bins) if replay is not None else None
    if rp is not None and rp.workers:
        host_workers = rp.workers

    bins = list(bins)            # join events append to the pool
    idx_of_bin: dict[int, int] = {id(b): i for i, b in enumerate(bins)}

    def placed_index(n: Node) -> int:
        b = placement.get(n.id)
        if b is None:
            raise ValueError(f"device task '{n.name}' missing from placement")
        i = idx_of_bin.get(id(b))
        if i is None:  # equality fallback (string/sharding bins)
            i = next((j for j, bb in enumerate(bins) if bb == b), None)
            if i is None:
                raise ValueError(f"'{n.name}' placed on unknown bin {b!r}")
        return i

    def resource(n: Node) -> tuple[str, int]:
        """(lane kind, bin index) a node occupies beside its worker."""
        if rp is not None and n.name in rp.bin_of \
                and n.type in (TaskType.KERNEL, TaskType.PULL):
            return _LANE_OF[n.type], rp.bin_of[n.name]
        if n.type in (TaskType.KERNEL, TaskType.PULL):
            return _LANE_OF[n.type], placed_index(n)
        if n.type == TaskType.PUSH:
            src = n.state.get("src")
            if src is not None:
                if rp is not None and src.name in rp.bin_of:
                    return COPY_LANE, rp.bin_of[src.name]
                if placement.get(src.id) is not None:
                    return COPY_LANE, placed_index(src)
            return _HOST_LANE, _HOST
        return _HOST_LANE, _HOST

    res_of = {n.id: resource(n) for n in graph.nodes}

    # -- fault machinery (all no-ops when faults is None) --------------
    fault_events = faults.ordered() if faults is not None else []
    f_at = 0
    n_reexecuted = 0
    recovery_seconds = 0.0
    slow_scale = [1.0] * len(bins)
    dead: set[int] = set()
    fsched = fgroups = fstate = None
    if fault_events:
        fsched = get_scheduler(fault_policy)
        fgroups = build_groups(graph, model.cost_fn)
        # seed the scheduler state with the placement under test so the
        # retire path displaces exactly the dead bin's unfinished groups
        fstate = SchedulerState(list(bins))
        for g in fgroups:
            fstate.add_group(g)
            fstate.record(g, res_of[g.nodes[0].id][1])

    def duration(n: Node, bin_index: int) -> float:
        if rp is not None and n.name in rp.duration:
            return rp.duration[n.name]
        speed = model.speed(bin_index) if bin_index != _HOST else 1.0
        dur = model.node_time(n, speed=speed)
        # a mesh-sharded task spans every member device of its slice:
        # ideal linear scaling (compute split N ways, transfers striped
        # over N copy engines) — the same rule HEFT's EFT charges —
        # plus the α-β collective-sync overhead when the non-ideal
        # scaling model is enabled (CostModel.collective_overhead)
        if bin_index != _HOST and mesh_wide(n, bins[bin_index]):
            scale = bin_compute_scale(bins[bin_index])
            dur /= scale
            # the collective sync is a COMPUTE cost: kernels only, the
            # same rule HEFT's EFT charges (pulls are striped, not
            # all-reduced — they keep the ideal split above)
            if n.type == TaskType.KERNEL:
                ov = model.collective_overhead(int(scale),
                                               model.out_bytes(n))
                if ov:
                    dur += ov
        # straggler injection: slow events scale FUTURE dispatches on
        # the bin; work already in flight keeps its committed finish
        if bin_index != _HOST and slow_scale[bin_index] != 1.0:
            dur *= slow_scale[bin_index]
        return dur

    # -- event loop ----------------------------------------------------
    pending = {n.id: len(n.dependents) for n in graph.nodes}
    arrival: dict[int, float] = {}
    finish: dict[int, float] = {}
    start_t: dict[int, float] = {}
    popped: set[int] = set()
    # per-bin lane clocks: one copy+compute lane PAIR per member device
    # (a DeviceBin owns one pair — the unchanged overlap model; a
    # MeshBin owns one per chip in the slice, so independent tasks can
    # run on different members concurrently while a mesh-sharded task
    # occupies every server at once).  With lane_depth < 2 both names
    # alias ONE server list per bin, so copies and kernels serialize
    # against each other (legacy model).
    widths = [bin_lane_width(b) for b in bins]
    copy_free = [[0.0] * w for w in widths]
    compute_free = (copy_free if not overlap
                    else [[0.0] * w for w in widths])
    lane_clock = {COPY_LANE: copy_free, COMPUTE_LANE: compute_free}
    workers = [0.0] * max(1, host_workers)
    heapq.heapify(workers)
    busy = {i: 0.0 for i in range(len(bins))}
    # memory accounting: resident bytes per bin (pull spans + kernel
    # activation bytes, charged at dispatch and held for the pass — the
    # same footprint the policies pack).  Budgeted bins convert overflow
    # into forced spill charges, so peak_bytes never exceeds any bin's
    # memory_bytes; unbudgeted bins just record the high-water mark.
    # Integer-only bookkeeping: with budgets unset no duration changes,
    # so pre-existing baselines reproduce bit-for-bit.
    budgets = [bin_memory_bytes(b) for b in bins]
    resident = {i: 0 for i in range(len(bins))}
    peak_bytes = {i: 0 for i in range(len(bins))}
    n_spills = 0
    spill_seconds = 0.0
    lane_busy = {i: {COPY_LANE: 0.0, COMPUTE_LANE: 0.0}
                 for i in range(len(bins))}
    host_busy = 0.0
    n_transfers = 0
    transfer_seconds = 0.0
    schedule: list[tuple[int, str, int, float, float]] = []
    events: list[tuple[float, int]] = []          # (finish_time, node.id)
    node_by_id = {n.id: n for n in graph.nodes}

    # dispatch-overhead charging (inert at the 0.0 default): _fuse_run
    # tracks the (lane, bin) and length of the current coalescible run —
    # the simulator's stand-in for the executor's _coalesce() batches
    ov_s = model.dispatch_overhead_s
    _fuse_run: list = [None, 0]           # [(kind, bin), members so far]

    def dispatch(n: Node, ready_t: float) -> None:
        nonlocal host_busy, n_spills, spill_seconds
        kind, b = res_of[n.id]
        dur = duration(n, b)
        if ov_s > 0.0:
            if fuse_batch >= 2:
                fusable = kind != _HOST_LANE
                if (fusable and _fuse_run[0] == (kind, b)
                        and _fuse_run[1] < fuse_batch):
                    _fuse_run[1] += 1     # rides the open batch: no charge
                else:                     # new batch (host breaks the run)
                    _fuse_run[0] = (kind, b) if fusable else None
                    _fuse_run[1] = 1
                    dur += ov_s
            else:
                dur += ov_s               # per-task overhead, unfused
        if kind != _HOST_LANE:
            fp = node_footprint(n)
            if fp > 0:
                cap = budgets[b]
                if cap is not None and resident[b] + fp > cap:
                    # forced spill: evict enough of the coldest resident
                    # bytes to fit; a node whose own footprint exceeds
                    # the budget streams its excess through (charged as
                    # spilled bytes, peak clamped at the budget)
                    evict = min(resident[b] + fp - cap, resident[b])
                    stream = max(fp - cap, 0)
                    n_spills += 1
                    if rp is None:  # replay durations embed spill time
                        st = model.spill_time(evict + stream)
                        spill_seconds += st
                        dur += st
                    resident[b] = min(resident[b] - evict + fp, cap)
                else:
                    resident[b] += fp
                if resident[b] > peak_bytes[b]:
                    peak_bytes[b] = resident[b]
        wfree = heapq.heappop(workers)
        if kind == _HOST_LANE:
            start = max(ready_t, wfree)
            host_busy += dur
        else:
            servers = lane_clock[kind][b]
            if mesh_wide(n, bins[b]):
                # sharded task: waits for, then occupies, EVERY server —
                # and is charged server-seconds for all of them, so
                # utilization (normalized by lane width below) stays
                # honest on multi-lane bins
                start = max(ready_t, wfree, max(servers))
                servers[:] = [start + dur] * len(servers)
                occupied = len(servers)
            else:
                j = min(range(len(servers)), key=servers.__getitem__)
                start = max(ready_t, wfree, servers[j])
                servers[j] = start + dur
                occupied = 1
            busy[b] += dur * occupied
            lane_busy[b][kind] += dur * occupied
        heapq.heappush(workers, start + dur)
        start_t[n.id] = start
        finish[n.id] = start + dur
        schedule.append((n.id, kind, b, start, start + dur))
        heapq.heappush(events, (start + dur, n.id))

    # online mode: map every node to its request component's release time
    release: dict[int, float] = {}
    comp_of: dict[int, int] = {}
    arrive_at: list[float] = []
    if arrivals is not None:
        comp_of, n_comp = weak_components(graph)
        arrive_at = (arrivals.times(n_comp)
                     if hasattr(arrivals, "times") else list(arrivals))
        if len(arrive_at) < n_comp:
            raise ValueError(
                f"{n_comp} request components but only "
                f"{len(arrive_at)} arrival times")
        release = {nid: arrive_at[c] for nid, c in comp_of.items()}

    # batch mode: sources dispatch at t=0 in node-id order
    # (deterministic, unchanged).  Online mode: sources are RELEASED
    # chronologically inside the event loop — dispatching a future
    # request's pulls eagerly would reserve workers/lanes ahead of work
    # that is actually ready now (dispatch reserves in call order).
    sources = [n for n in sorted(graph.nodes, key=lambda n: n.id)
               if pending[n.id] == 0]
    if arrivals is None:
        for n in sources:
            arrival[n.id] = 0.0
            dispatch(n, 0.0)
        releases: list[tuple[float, int]] = []
    else:
        releases = sorted(((release.get(n.id, 0.0), n.id) for n in sources))
    r_at = 0

    def pump(now: float) -> int:
        """Dispatch every not-yet-released source due at or before ``now``."""
        nonlocal r_at
        n_released = 0
        while r_at < len(releases) and releases[r_at][0] <= now:
            t0, nid = releases[r_at]
            r_at += 1
            arrival[nid] = t0
            dispatch(node_by_id[nid], t0)
            n_released += 1
        return n_released

    def process_fault() -> None:
        """Apply the next :class:`FaultSchedule` event to the pool."""
        nonlocal f_at, events, workers, schedule, n_reexecuted, \
            recovery_seconds, n_transfers, transfer_seconds
        ev = fault_events[f_at]
        f_at += 1
        now = ev.time
        if ev.action == "join":
            nb = ev.bin
            i = len(bins)
            bins.append(nb)
            idx_of_bin[id(nb)] = i
            w = bin_lane_width(nb)
            widths.append(w)
            copy_free.append([now] * w)   # servers free from join time on
            if overlap:
                compute_free.append([now] * w)
            budgets.append(bin_memory_bytes(nb))
            resident[i] = 0
            peak_bytes[i] = 0
            busy[i] = 0.0
            lane_busy[i] = {COPY_LANE: 0.0, COMPUTE_LANE: 0.0}
            slow_scale.append(1.0)
            fsched.update(fstate, SchedulerUpdate(new_bins=(nb,)),
                          graph=graph)
            return
        b = ev.bin if isinstance(ev.bin, int) else bin_index(bins, ev.bin)
        if b is None or not 0 <= b < len(bins) or b in dead:
            raise ValueError(
                f"fault targets unknown or dead bin {ev.bin!r}")
        if ev.action == "slow":
            slow_scale[b] *= ev.factor
            return
        # -- kill: rescind in-flight work on the dying bin -------------
        rescinded = [(t, nid) for t, nid in events if res_of[nid][1] == b]
        if rescinded:
            events = [e for e in events if res_of[e[1]][1] != b]
            heapq.heapify(events)
            pool = sorted(workers)
            for t, nid in rescinded:
                # the abort frees the task's worker slot now — unless a
                # later dispatch already chained onto that slot (popped
                # its finish value), in which case the slot is spoken for
                if t in pool:
                    pool.remove(t)
                    pool.append(now)
                if start_t[nid] < now:    # had started: work thrown away
                    n_reexecuted += 1
                    recovery_seconds += now - start_t[nid]
                del finish[nid]
            workers = pool
            heapq.heapify(workers)
        resc_ids = {nid for _, nid in rescinded}
        schedule = [row for row in schedule
                    if row[0] not in resc_ids or row[4] <= now]
        # -- lost frontier: dead-bin results a live consumer still needs
        needs = {n.id for n in graph.nodes
                 if n.id not in popped and n.id not in finish}
        dead_done = [nid for nid in popped if res_of[nid][1] == b]
        invalid: set[int] = set()
        changed = True
        while changed:
            changed = False
            for nid in dead_done:
                if nid in invalid:
                    continue
                if any(s.id in needs
                       for s in node_by_id[nid].successors):
                    invalid.add(nid)
                    needs.add(nid)
                    changed = True
        for nid in sorted(invalid):
            n_reexecuted += 1
            recovery_seconds += finish[nid] - start_t[nid]
            popped.discard(nid)
            del finish[nid]
        # -- route the re-placement through Scheduler.update -----------
        for g in fgroups:
            if fstate.assignment.get(g.root) == b \
                    and g.root not in fstate.finished \
                    and all(nd.id in popped for nd in g.nodes):
                fstate.mark_finished(g)   # fully consumed: nothing moves
        try:
            delta = fsched.update(
                fstate, SchedulerUpdate(retired_bins=(b,)), graph=graph)
        except ValueError as exc:
            raise ValueError(
                f"FaultSchedule kills bin {b} at t={now:g}: {exc}") from exc
        dead.add(b)
        moved: dict[int, int] = {}
        for root, i in delta.items():
            for nd in fstate.groups[root].nodes:
                moved[nd.id] = i
                res_of[nd.id] = (_LANE_OF[nd.type], i)
        for n in graph.nodes:        # pushes ride their source pull's bin
            if n.type == TaskType.PUSH:
                src = n.state.get("src")
                if src is not None and src.id in moved:
                    res_of[n.id] = (COPY_LANE, moved[src.id])
        # -- recount deps for everything not (re)done, then re-dispatch
        for n in graph.nodes:
            if n.id not in popped and n.id not in finish:
                pending[n.id] = sum(
                    1 for p in n.dependents if p.id not in popped)
        for nid in sorted(resc_ids | invalid):
            if pending[nid] > 0:     # waits on an upstream re-execution
                continue
            n = node_by_id[nid]
            at = now
            bn = res_of[nid][1]
            for p in n.dependents:   # re-fetch operands from survivors
                bp = res_of[p.id][1]
                if bp != _HOST and bn != _HOST and bp != bn:
                    n_transfers += 1
                    comm = model.transfer_time(model.out_bytes(p),
                                               bins[bp], bins[bn])
                    transfer_seconds += comm
                    at = max(at, now + comm)
            arrival[nid] = at
            dispatch(n, at)

    total = len(graph.nodes)
    while events or r_at < len(releases):
        next_ev = events[0][0] if events else None
        next_rel = releases[r_at][0] if r_at < len(releases) else None
        upcoming = min(x for x in (next_ev, next_rel) if x is not None)
        # faults fire strictly before later task events: a task finishing
        # at exactly the fault time counts as done (deterministic ties)
        if f_at < len(fault_events) and fault_events[f_at].time < upcoming:
            process_fault()
            continue
        if next_ev is None or (next_rel is not None and next_rel <= next_ev):
            pump(next_rel)
            continue
        t, nid = heapq.heappop(events)
        popped.add(nid)
        n = node_by_id[nid]
        # successors in id order so equal-time readiness ties are stable
        for s in sorted(n.successors, key=lambda s: s.id):
            if pending[s.id] <= 0:
                continue   # already dispatched (fault re-execution pop)
            comm = 0.0
            (kn, bn), (ks, bs) = res_of[nid], res_of[s.id]
            if bn != _HOST and bs != _HOST and bn != bs:
                n_transfers += 1
                if rp is None:  # replayed durations already embed transfers
                    # stage endpoints charge their inter-stage link
                    # instead of generic d2d (CostModel.transfer_time)
                    comm = model.transfer_time(model.out_bytes(n),
                                               bins[bn], bins[bs])
                    transfer_seconds += comm
            arrival[s.id] = max(arrival.get(s.id, 0.0), t + comm)
            pending[s.id] -= 1
            if pending[s.id] == 0:
                dispatch(s, arrival[s.id])
    if len(popped) != total:  # pragma: no cover - guarded by acyclicity
        raise RuntimeError(
            f"simulation stalled: {len(popped)}/{total} tasks ran")

    makespan = max(finish.values())
    # utilization normalizes by lane width so a multi-lane mesh bin is
    # full at 1.0 per member device; copy∥compute overlap can still push
    # it past 1.0 (busy sums both lane classes), as for device bins
    util = {i: (busy[i] / (makespan * widths[i]) if makespan > 0 else 0.0)
            for i in busy}
    request_latency: list[dict[str, float]] = []
    if arrivals is not None:
        first_kernel: dict[int, float] = {}
        first_any: dict[int, float] = {}
        last: dict[int, float] = {}
        for nid, c in comp_of.items():
            f = finish[nid]
            if node_by_id[nid].type == TaskType.KERNEL:
                first_kernel[c] = min(first_kernel.get(c, f), f)
            first_any[c] = min(first_any.get(c, f), f)
            last[c] = max(last.get(c, f), f)
        for c in sorted(last):
            arr = arrive_at[c]
            ttft = first_kernel.get(c, first_any[c]) - arr
            request_latency.append({"arrival": arr, "ttft": ttft,
                                    "complete": last[c] - arr})
    report = SimReport(
        makespan=makespan,
        busy=busy,
        utilization=util,
        host_busy=host_busy,
        n_transfers=n_transfers,
        transfer_seconds=transfer_seconds,
        lane_busy=lane_busy,
        finish_times=finish,
        schedule=schedule,
        measured_makespan=rp.measured_makespan if rp is not None else None,
        peak_bytes=peak_bytes,
        n_spills=n_spills,
        spill_seconds=spill_seconds,
        request_latency=request_latency,
        n_reexecuted=n_reexecuted,
        recovery_seconds=recovery_seconds,
    )
    if metrics is not None:
        publish_report(metrics, report)
    return report


def publish_report(metrics: Any, report: SimReport) -> None:
    """Publish a :class:`SimReport` into a ``repro_torch.obs.MetricsRegistry``
    — the simulator's half of the shared observability surface.  Gauges
    carry the latest run's figures, counters accumulate across runs, and
    the ``sim_task_seconds`` histogram collects per-interval durations
    from the schedule (p50/p99 via the registry)."""
    metrics.counter("sim_runs").inc()
    metrics.gauge("sim_makespan_s").set(report.makespan)
    metrics.gauge("sim_host_busy_s").set(report.host_busy)
    metrics.counter("sim_transfers").inc(report.n_transfers)
    metrics.counter("sim_transfer_seconds").inc(report.transfer_seconds)
    metrics.counter("sim_spills").inc(report.n_spills)
    metrics.counter("sim_reexecuted").inc(report.n_reexecuted)
    metrics.histogram("sim_task_seconds").extend(
        end - start for _, _, _, start, end in report.schedule)
    if report.divergence is not None:
        metrics.gauge("sim_divergence").set(report.divergence)
