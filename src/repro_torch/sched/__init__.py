"""repro_torch.sched — pluggable scheduling subsystem.

Splits paper Algorithm 1 into an affinity phase (kernel∪pull union-find,
``base.build_groups``) and a pluggable placement policy (``Scheduler``),
and adds a discrete-event simulator so policies can be scored on
synthetic graphs without devices (estee-style scheduler study).

Quick use::

    from repro_torch.sched import get_scheduler, simulate
    pl = get_scheduler("heft").schedule(graph, bins)
    print(simulate(graph, pl, bins).summary())

Policies: ``balanced`` (seed Algorithm 1), ``heft``, ``round_robin``,
``random``.  ``Executor(scheduler="heft")`` selects one at runtime;
``configs.SchedConfig`` is the config-file knob.  See docs/scheduling.md.

The simulator models each bin as a copy lane ∥ compute lane pair
(``CostModel.lane_depth``, mirroring ``core.streams``), so H2D/D2H
transfers overlap kernels the way the paper's per-worker streams do;
``simulate(..., replay=trace)`` reconstructs a recorded executor run and
reports the prediction's divergence from the measured makespan.

Profile-guided loop (``sched.profile``): run with
``Executor(profiler=TaskProfiler())``, fit a calibrated model via
``CostModel.fit(profiler)`` (aggregate + per-kernel-name rates), and
feed it back through ``Heft.from_trace`` /
``Executor(replace_every=N, migrate_top_k=k)``.

Execution bins (``sched.bins``): bins are first-class — ``DeviceBin``
(legacy single device), ``HostBin``, ``MeshBin`` (a named sub-mesh
slice with per-member lane pairs and linear sharded-compute scaling),
and ``StageBin`` (a pipeline-stage slot wrapping any member bin and
carrying inter-stage link bandwidth/latency; ``distributed.pipeline``
emits ``stage=s``-tagged cells that form one placement group per
stage).  ``Heteroflow.kernel(..., requires={"mesh"})`` restricts a
kernel's group to bins offering those capabilities, StarPU-style; v3+
traces serialize bin descriptors so mesh/stage runs replay faithfully
(v4 adds per-record stage ids and link descriptors, letting
``CostModel.fit`` calibrate ``stage_link_bandwidth`` from a recorded
pipeline run).  Non-ideal sharded scaling:
``CostModel(collective_alpha=..., collective_beta=...)`` charges an
α-β ring-collective overhead on mesh-wide compute (default off).

Online scheduling: schedulers are long-lived.  Feed
:class:`SchedulerUpdate` events (new tasks / finishes / bin churn)
through :meth:`Scheduler.update` against a persistent
:class:`SchedulerState`; only new or displaced groups are (re)placed —
deltas, never full repacks.  ``schedule()`` is now a thin one-update
wrapper, so one-shot callers are unchanged.  ``simulate(...,
arrivals=poisson(rate))`` releases each request's sources at its
arrival time and reports per-request TTFT/completion
(``SimReport.request_latency``); ``sched.online`` replays arrival
traces through the update loop (``online_report``) and scores them
against the ``static_batching_latency`` strawman.  The old
``reschedule()`` / ``migrate_top_k=`` entry points were removed in
a two-cycle deprecation — drive ``update()`` with
``SchedulerState.measured_load`` instead (migration guide in
docs/scheduling.md "Online scheduling").

Million-task scale (``sched.coarsen``): :func:`coarsen` contracts
affinity groups into super-groups along heavy edges (acyclic interval
quotient, cost-spread capped) whose ``agg`` digests let HEFT price a
candidate in O(1); :func:`windowed_place` feeds any policy topological
windows of K groups against one persistent state (lane clocks frozen
between windows); :func:`hierarchical_schedule` chains grouping →
coarsening → windowed placement → expansion and collapses to the plain
``schedule()`` path when both knobs are off (bit-identical).  See
docs/scheduling.md "Million-task scale".

Failure tolerance: ``simulate(..., faults=FaultSchedule.kill(t,
bin))`` injects kill/slow/join events at simulated times with honest
re-execution charging (``SimReport.n_reexecuted`` /
``recovery_seconds``); ``sched.chaos`` adds the deterministic
:class:`ChaosPlan` harness (task-count triggers shared by
``Executor(chaos=...)`` and the simulator) and the
:class:`StragglerDetector` EWMA → :func:`demoted_model` loop.  See
docs/scheduling.md "Failure tolerance and chaos testing".
"""
from .base import (
    Scheduler,
    SchedulerState,
    SchedulerUpdate,
    TaskGroup,
    apply_assignment,
    available_policies,
    build_groups,
    get_scheduler,
    group_candidates,
    node_footprint,
    register,
)
from .bins import (
    DeviceBin,
    ExecutionBin,
    HostBin,
    MeshBin,
    StageBin,
    bin_capabilities,
    bin_memory_bytes,
    bins_from_trace,
    describe_bin,
    eligible_bins,
    execution_target,
    stage_bins,
    stage_link,
)
from .online import (
    online_placement,
    online_report,
    percentile,
    static_batching_latency,
)
from .chaos import (
    ChaosEvent,
    ChaosPlan,
    ChaosRunner,
    StragglerDetector,
    demoted_model,
    parse_chaos,
)
from .coarsen import (
    CoarsenPlan,
    coarsen,
    group_edges,
    hierarchical_schedule,
    toposort_groups,
    windowed_place,
)
from .policies import BalancedBins, Heft, RandomPolicy, RoundRobin
from .profile import (
    TaskProfiler,
    TaskRecord,
    cross_bin_bytes,
    load_trace,
    node_bytes,
    producer_bytes,
)
from .simulator import (
    ArrivalProcess,
    CostModel,
    FaultEvent,
    FaultSchedule,
    SimReport,
    poisson,
    simulate,
    weak_components,
)

__all__ = [
    "Scheduler", "SchedulerState", "SchedulerUpdate", "TaskGroup",
    "build_groups", "apply_assignment",
    "register", "get_scheduler", "available_policies", "group_candidates",
    "node_footprint",
    "ExecutionBin", "DeviceBin", "HostBin", "MeshBin", "StageBin",
    "stage_bins", "stage_link", "execution_target",
    "bin_capabilities", "bin_memory_bytes", "eligible_bins", "describe_bin",
    "bins_from_trace",
    "BalancedBins", "Heft", "RoundRobin", "RandomPolicy",
    "CoarsenPlan", "coarsen", "group_edges", "toposort_groups",
    "windowed_place", "hierarchical_schedule",
    "CostModel", "SimReport", "simulate",
    "ArrivalProcess", "poisson", "weak_components",
    "FaultEvent", "FaultSchedule",
    "ChaosEvent", "ChaosPlan", "ChaosRunner",
    "StragglerDetector", "demoted_model", "parse_chaos",
    "online_placement", "online_report", "percentile",
    "static_batching_latency",
    "TaskProfiler", "TaskRecord", "load_trace", "node_bytes",
    "producer_bytes", "cross_bin_bytes",
]
