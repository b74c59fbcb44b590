"""Scheduler interface — the pluggable half of paper Algorithm 1.

The paper factors device placement into (a) an *affinity* phase that
unions every kernel with its source pull tasks (data locality is not
negotiable) and (b) a *policy* phase that maps the resulting groups onto
device bins.  The seed hard-wired phase (b) to balanced bin packing; this
module makes it a :class:`Scheduler` strategy so alternative policies
(HEFT list scheduling, round-robin, random baselines — see
``sched.policies``) can be swapped in and scored offline by
``sched.simulator`` before they ever touch hardware, the estee-style
workflow ("Analysis of workflow schedulers in simulated distributed
environments").

Every policy receives the same pre-digested :class:`TaskGroup` list, so
the paper's invariants hold for all of them:

* kernels are always co-placed with their source pulls (one group);
* explicit ``sharding`` pins override the policy for the whole group;
* placement never changes *semantics*, only locality/latency — the
  executor will faithfully run any placement.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Mapping, Sequence

from repro_torch.core.graph import Heteroflow, Node, TaskType
from repro_torch.core.placement import UnionFind, _nbytes, estimate_node_cost
from repro_torch.core.streams import bin_labels

from .bins import bin_compute_scale, eligible_bins

__all__ = [
    "TaskGroup",
    "Scheduler",
    "SchedulerUpdate",
    "SchedulerState",
    "build_groups",
    "apply_assignment",
    "bin_index",
    "bin_load",
    "group_candidates",
    "node_footprint",
    "register",
    "get_scheduler",
    "available_policies",
]

CostFn = Callable[[Node], float]


@dataclass
class TaskGroup:
    """One placement unit: a kernel∪pull affinity group (Algorithm 1 l.1-7).

    ``order`` is the first-seen position over the graph's device tasks —
    policies that need a deterministic arrival order (round-robin, stable
    tie-breaks) use it instead of re-deriving node order.
    """

    root: Hashable
    order: int
    nodes: list[Node] = field(default_factory=list)
    cost: float = 0.0
    pin: Any | None = None
    #: union of member kernels' capability tags (``requires=`` on
    #: ``Heteroflow.kernel``): the whole group is only eligible on bins
    #: whose capabilities superset this (StarPU codelet eligibility).
    requires: frozenset = frozenset()
    #: pipeline-stage identity (``Heteroflow.kernel(..., stage=s)``):
    #: every node tagged with the same stage id is unioned into ONE
    #: group, so placement moves whole stages atomically.  ``None`` for
    #: untagged groups.  Advisory, not a pin — policies use it for
    #: stage-affinity packing (adjacent stages prefer cheap links).
    stage_id: int | None = None
    #: estimated resident footprint in bytes (pull operand spans plus
    #: kernel ``activation_bytes``) — the unit memory-budgeted policies
    #: and the simulator charge against ``bin_memory_bytes``.  Zero when
    #: no member declares a span (budget checks then never bind).
    bytes: int = 0
    #: coarsening aggregates (``repro_torch.sched.coarsen``): super-groups
    #: carry pre-digested totals (pull count/bytes, kernel cost/count,
    #: inter-super-group edge bytes) so HEFT's EFT loop is O(1) per
    #: candidate instead of O(member nodes).  ``None`` (default) for
    #: ordinary fine groups — every legacy code path is untouched.
    agg: Any | None = None


def node_footprint(t: Node) -> int:
    """Resident bytes a scheduled node contributes to its bin.

    PULL tasks contribute their operand span (``_nbytes`` over the
    declared source/size — same estimate ``estimate_node_cost`` charges
    for the copy); KERNEL tasks contribute their declared
    ``activation_bytes`` working set.  Everything else is free: host
    tasks run out-of-arena and push tasks stream.
    """
    if t.type == TaskType.PULL:
        return int(_nbytes(t.state.get("source"), t.state.get("size")))
    if t.type == TaskType.KERNEL:
        return int(t.state.get("activation_bytes", 0))
    return 0


def build_groups(graph: Heteroflow, cost_fn: CostFn = estimate_node_cost,
                 ) -> list[TaskGroup]:
    """Affinity phase of Algorithm 1: union kernels with their source
    pulls, accumulate per-group cost and pins.

    Returns groups in first-seen order over ``graph.nodes`` (the order the
    seed implementation inserted them into its cost dict — preserved so
    :class:`~repro_torch.sched.policies.BalancedBins` reproduces the seed
    placement byte-for-byte).
    """
    uf = UnionFind()
    nodes = graph.nodes
    for t in nodes:
        if t.type == TaskType.KERNEL:
            for p in t.state.get("sources", ()):
                uf.union(t.id, p.id)
    # stage phase: nodes tagged stage=s (distributed.pipeline cells and
    # their weight pulls) union into one group per stage id — the
    # structural guarantee that placement moves stages atomically,
    # replacing the old trick of anchoring every cell on a shared
    # weight-pull argument just so the union-find would co-place them
    anchor: dict[int, Hashable] = {}
    for t in nodes:
        if t.type not in (TaskType.KERNEL, TaskType.PULL):
            continue
        sid = t.state.get("stage")
        if sid is not None:
            a = anchor.setdefault(sid, t.id)
            if a != t.id:
                uf.union(a, t.id)

    groups: dict[Hashable, TaskGroup] = {}
    # hot loop at netlist scale (10^5+ nodes, sched.coarsen): operand
    # spans are memoized per (source, size) — propagation graphs share
    # operand arrays across cells, so the np.asarray round-trip in
    # ``_nbytes`` collapses to one call per distinct span — and the
    # default cost metric is inlined because it re-derives the very span
    # the footprint just produced.  Same values as the naive loop,
    # byte for byte; custom ``cost_fn``s take the general path.
    default_cost = cost_fn is estimate_node_cost
    span_memo: dict[tuple[int, Any], int] = {}
    for t in nodes:
        tt = t.type
        if tt is not TaskType.KERNEL and tt is not TaskType.PULL:
            continue
        st = t.state
        r = uf.find(t.id)
        g = groups.get(r)
        if g is None:
            g = groups[r] = TaskGroup(root=r, order=len(groups))
        g.nodes.append(t)
        if tt is TaskType.PULL:
            key = (id(st.get("source")), st.get("size"))
            nb = span_memo.get(key)
            if nb is None:
                nb = span_memo[key] = int(
                    _nbytes(st.get("source"), st.get("size")))
            g.bytes += nb
            g.cost += (float(nb) or 1.0) if default_cost else cost_fn(t)
        else:
            g.bytes += int(st.get("activation_bytes", 0))
            g.cost += (float(st.get("cost", 1.0)) if default_cost
                       else cost_fn(t))
        req = st.get("requires")
        if req:
            g.requires = g.requires | req
        sid = st.get("stage")
        if sid is not None:
            if g.stage_id is not None and g.stage_id != sid:
                raise ValueError(
                    f"'{t.name}' (stage {sid}) shares an affinity group "
                    f"with stage {g.stage_id} — a pull feeding two "
                    f"stages breaks stage atomicity; duplicate it or "
                    f"drop the stage tags")
            g.stage_id = sid
        pin = st.get("sharding")
        if pin is not None:
            if g.pin is not None and g.pin is not pin:
                raise ValueError(
                    f"group containing '{t.name}' pinned to two shardings")
            g.pin = pin
    return list(groups.values())


@dataclass(frozen=True)
class SchedulerUpdate:
    """One batch of scheduler events — the estee ``Update`` signature.

    Online callers (the serving engine, ``sched.online``) hand the
    scheduler the *change* since the last call instead of the whole
    world: request task-groups that just arrived (``new_tasks``), groups
    whose inputs became available (``new_ready_tasks``, advisory),
    groups that completed (``new_finished_tasks`` — releases their
    *active* load accounting), and bins that joined or left the pool
    (``new_bins`` / ``retired_bins`` — estee's ``new_workers``, both
    directions).  An empty update with
    :attr:`SchedulerState.measured_load` set is a rebalance request —
    the event-loop spelling of the removed ``Scheduler.reschedule()``.
    """

    new_tasks: tuple = ()
    new_ready_tasks: tuple = ()
    new_finished_tasks: tuple = ()
    new_bins: tuple = ()
    retired_bins: tuple = ()

    def __bool__(self) -> bool:
        return bool(self.new_tasks or self.new_ready_tasks
                    or self.new_finished_tasks or self.new_bins
                    or self.retired_bins)


class SchedulerState:
    """Long-lived placement state threaded through :meth:`Scheduler.update`.

    Where ``assign()`` is a pure function of one group list, online
    scheduling needs memory: which groups exist, where they sit, how
    much cumulative cost/bytes each bin has absorbed, which pipeline
    stages landed where, and any policy-private bookkeeping (HEFT lane
    clocks, round-robin cursors) in :attr:`scratch`.  Bin slots are
    **stable**: retiring a bin tombstones its index (removed from
    :attr:`live`) instead of renumbering, so assignments recorded in
    earlier events stay valid forever.

    Placement load (:attr:`load`) is *cumulative over placed work* and
    is deliberately NOT decremented on finish — that makes any chunking
    of the same arrivals into ``update()`` events land exactly where the
    one-shot ``schedule()`` would (the interleaving-parity property the
    test suite checks).  :attr:`active_load` tracks the in-flight subset
    for metrics and rebalance decisions.
    """

    def __init__(self, bins: Sequence[Any], *,
                 initial_load: Mapping[Any, float] | None = None,
                 migrate_top_k: int = 0):
        if not bins:
            raise ValueError("no device bins to place onto")
        self.bins: list[Any] = list(bins)
        self.live: set[int] = set(range(len(self.bins)))
        self.initial_load = initial_load
        self.load: dict[int, float] = {
            i: bin_load(initial_load, self.bins, i)
            for i in range(len(self.bins))}
        self.active_load: dict[int, float] = {
            i: 0.0 for i in range(len(self.bins))}
        self.packed: dict[int, int] = {i: 0 for i in range(len(self.bins))}
        self.groups: dict[Hashable, TaskGroup] = {}
        self.assignment: dict[Hashable, int] = {}
        self.finished: set[Hashable] = set()
        self.ready: set[Hashable] = set()
        self.placed_stage: dict[int, int] = {}
        #: measured busy-seconds per bin since the last (re)placement —
        #: set it and send an empty update to request a rebalance.
        self.measured_load: Mapping[Any, float] | None = None
        self.migrate_top_k = migrate_top_k
        #: policy-private persistent state (HEFT lane clocks, cursors).
        self.scratch: dict[str, Any] = {}
        self._placed_any = False

    # -- group / bin bookkeeping --------------------------------------
    def add_group(self, g: TaskGroup) -> None:
        self.groups[g.root] = g

    def add_bin(self, b: Any) -> int:
        """Append a bin slot and return its (stable) index."""
        i = len(self.bins)
        self.bins.append(b)
        self.live.add(i)
        self.load[i] = 0.0
        self.active_load[i] = 0.0
        self.packed[i] = 0
        return i

    def retire_bin(self, b: Any) -> list[TaskGroup]:
        """Tombstone a bin slot; return its displaced (unfinished)
        groups in arrival order so the caller can re-place them."""
        idx = b if isinstance(b, int) else bin_index(self.bins, b)
        if idx is None or idx not in self.live:
            raise ValueError(f"cannot retire unknown/already-retired bin {b!r}")
        self.live.discard(idx)
        if not self.live:
            raise ValueError("retiring the last live bin")
        displaced = [g for r, g in self.groups.items()
                     if self.assignment.get(r) == idx
                     and r not in self.finished]
        for g in displaced:
            del self.assignment[g.root]
            # the displaced work leaves the slot with the bin: release
            # its live-load and packed-bytes books here, so re-placement
            # (record on the new bin) doesn't double-count it.  The
            # cumulative ``load`` book intentionally keeps history —
            # chunked-update parity depends on it never decrementing.
            scale = _group_scale(g, self.bins[idx])
            self.active_load[idx] = max(
                0.0, self.active_load[idx] - g.cost / scale)
            self.packed[idx] = max(0, self.packed[idx] - g.bytes)
        return displaced

    def mark_finished(self, g: "TaskGroup | Hashable") -> None:
        root = g.root if isinstance(g, TaskGroup) else g
        if root in self.finished:
            return
        self.finished.add(root)
        grp = self.groups.get(root)
        i = self.assignment.get(root)
        if grp is not None and i is not None:
            scale = _group_scale(grp, self.bins[i])
            self.active_load[i] = max(
                0.0, self.active_load[i] - grp.cost / scale)

    def mark_ready(self, g: "TaskGroup | Hashable") -> None:
        self.ready.add(g.root if isinstance(g, TaskGroup) else g)

    # -- placement recording ------------------------------------------
    def record(self, g: TaskGroup, idx: int) -> None:
        """Commit ``g -> bin idx``: assignment + load/bytes/stage books."""
        self.assignment[g.root] = idx
        scale = _group_scale(g, self.bins[idx])
        self.load[idx] += g.cost / scale
        if g.root not in self.finished:
            self.active_load[idx] += g.cost / scale
        self.packed[idx] += g.bytes
        if g.stage_id is not None:
            self.placed_stage[g.stage_id] = idx
        self._placed_any = True

    def wipe_placement(self) -> None:
        """Drop every placement (rebalance repack): loads reset to the
        initial seeding, books cleared; groups/finished sets survive."""
        self.assignment.clear()
        self.placed_stage.clear()
        for i in range(len(self.bins)):
            self.load[i] = bin_load(self.initial_load, self.bins, i)
            self.active_load[i] = 0.0
            self.packed[i] = 0
        self._placed_any = False

    # -- views ---------------------------------------------------------
    def candidates(self, g: TaskGroup) -> list[int]:
        """Live bin indices ``g`` may be placed on (capability-checked)."""
        live = sorted(self.live)
        idx = eligible_bins(g.requires, [self.bins[i] for i in live])
        out = [live[j] for j in idx]
        if not out:
            names = ", ".join(sorted(n.name for n in g.nodes))
            raise ValueError(
                f"group [{names}] requires capabilities "
                f"{sorted(g.requires)} but no live bin offers them")
        return out

    @property
    def virgin(self) -> bool:
        """True until the first placement is recorded — a virgin state
        with all bins live is exactly the one-shot ``assign`` setting."""
        return not self._placed_any


def _group_scale(g: TaskGroup, b: Any) -> float:
    """Compute speedup of group ``g`` on bin ``b`` (mesh-sharded groups
    scale linearly over the slice; same rule as ``policies._mesh_scale``)."""
    return bin_compute_scale(b) if "mesh" in g.requires else 1.0


def bin_index(bins: Sequence[Any], target: Any) -> int | None:
    """Locate ``target`` among ``bins`` by identity then equality (device
    objects may not define ``__eq__``; strings/shardings do)."""
    for i, b in enumerate(bins):
        if b is target or b == target:
            return i
    return None


def bin_load(initial_load: Mapping[Any, float] | None, bins: Sequence[Any],
             i: int) -> float:
    """Pre-existing load of bin slot ``i``.

    ``initial_load`` is keyed by bin object (the seed ``place()``
    contract: arena bytes per device) or by bin *index* (the executor's
    dynamic re-placement — duplicate/equal bin objects would collapse an
    object-keyed mapping and erase exactly the imbalance it measures).
    Index keys win when both are present.
    """
    if not initial_load:
        return 0.0
    if i in initial_load:
        return float(initial_load[i])
    try:
        return float(initial_load.get(bins[i], 0.0))
    except TypeError:          # unhashable bin object
        return 0.0


def group_candidates(g: TaskGroup, bins: Sequence[Any]) -> list[int]:
    """Bin indices ``g`` may be placed on, honoring capability tags.

    Raises when a tagged group has no satisfying bin — a mis-specified
    bin list is a configuration error, not a silent misplacement (the
    StarPU rule: a codelet with no eligible worker fails to submit).
    """
    idx = eligible_bins(g.requires, bins)
    if not idx:
        names = ", ".join(sorted(n.name for n in g.nodes))
        raise ValueError(
            f"group [{names}] requires capabilities "
            f"{sorted(g.requires)} but no bin in {len(bins)} offers them "
            f"(add a MeshBin/HostBin or drop the tag)")
    return idx


def apply_assignment(
    graph: Heteroflow,
    groups: Sequence[TaskGroup],
    bins: Sequence[Any],
    assignment: Mapping[Hashable, int],
) -> dict[int, Any]:
    """Write a ``{group.root: bin_index}`` decision back onto the graph
    (``node.device`` / ``node.group`` / ``node.bin_key``) and return the
    paper-shaped ``{node.id: bin}`` placement map.

    ``bin_key`` is the run-stable bin-slot label (``core.streams.bin_labels``)
    consumed by the profiler's traces and the executor's locality-aware
    stealing — both need bin identities that survive across runs, which
    enumeration indices and ``id()`` keys do not.
    """
    labels = bin_labels(bins)
    placement: dict[int, Any] = {}
    for g in groups:
        idx = assignment[g.root]
        b = bins[idx]
        for t in g.nodes:
            placement[t.id] = b
            t.device = b
            t.group = g.root
            t.bin_key = labels[idx]
    return placement


class Scheduler(abc.ABC):
    """Placement policy: ``schedule(graph, bins) -> {node.id: bin}``.

    Subclasses implement :meth:`assign` over pre-built affinity groups;
    pin handling and graph write-back are shared.  ``initial_load`` lets
    the executor bias placement by bytes already resident per bin (arena
    occupancy), mirroring the seed ``place()`` contract.

    Units: ``initial_load`` values share ``cost_fn``'s units — the seed
    contract packs resident arena *bytes* against group costs, which is
    commensurate under the default cost metric (pull cost = span bytes).
    Callers using a custom cost scale should rescale their loads the way
    the measured-load rebalance rescales measured seconds
    (:meth:`_rebalance`).
    """

    #: registry key; subclasses must override.
    name: str = ""

    def schedule(
        self,
        graph: Heteroflow,
        bins: Sequence[Any],
        cost_fn: CostFn = estimate_node_cost,
        *,
        initial_load: Mapping[Any, float] | None = None,
    ) -> dict[int, Any]:
        """One-shot offline placement: a single :meth:`update` carrying
        the whole graph as ``new_tasks`` against a fresh state."""
        if not bins:
            raise ValueError("no device bins to place onto")
        groups = build_groups(graph, cost_fn)
        state = SchedulerState(bins, initial_load=initial_load)
        self.update(state, SchedulerUpdate(new_tasks=tuple(groups)),
                    graph=graph)
        return apply_assignment(graph, groups, bins, state.assignment)

    def update(
        self,
        state: SchedulerState,
        event: SchedulerUpdate,
        *,
        graph: Heteroflow | None = None,
    ) -> dict[Hashable, int]:
        """Consume one event batch; return the **placement delta** —
        only the groups (re)placed by this call, as ``{root: bin_index}``
        into ``state.bins``.  Existing assignments are never touched
        except for groups displaced by a retired bin.

        Event processing order: bins join → finishes/readies are
        booked → bins retire (their unfinished groups are displaced) →
        new + displaced groups are placed incrementally via
        :meth:`place_update`.  An *empty* event with
        ``state.measured_load`` set triggers a rebalance instead:
        hot-group migration when ``state.migrate_top_k > 0``, else a
        full repack seeded with the rescaled measured load (this
        event-loop form replaced the removed ``reschedule()`` method —
        migration guide in docs/scheduling.md).

        ``graph`` is optional context: offline callers pass the full
        graph (exact upward ranks for HEFT); online callers usually
        cannot — policies then rank within the event.
        """
        for b in event.new_bins:
            state.add_bin(b)
        for g in event.new_finished_tasks:
            state.mark_finished(g)
        for g in event.new_ready_tasks:
            state.mark_ready(g)
        displaced: list[TaskGroup] = []
        for b in event.retired_bins:
            displaced.extend(state.retire_bin(b))
        new = list(event.new_tasks)
        for g in new:
            state.add_group(g)
        seen = {g.root for g in new}
        to_place = new + [g for g in displaced if g.root not in seen]
        if to_place:
            return self.place_update(state, to_place, graph=graph)
        if state.measured_load is not None and state.groups:
            return self._rebalance(state, graph=graph)
        return {}

    def place_update(
        self,
        state: SchedulerState,
        groups: Sequence[TaskGroup],
        *,
        graph: Heteroflow | None = None,
    ) -> dict[Hashable, int]:
        """Incrementally place ``groups`` against accumulated state.

        Base implementation delegates to :meth:`assign` over the live
        bins with the accumulated per-slot load as ``initial_load`` —
        policies whose decisions are a pure function of (groups, loads)
        (balanced packing and any third-party ``assign``-only subclass)
        are incremental for free.  Stateful policies (HEFT lane clocks,
        cursors) override this and keep their books in
        ``state.scratch``.
        """
        live = sorted(state.live)
        if state.virgin and len(live) == len(state.bins):
            # fresh state, full bin list: exactly the one-shot assign
            # call (object-keyed initial_load passes through verbatim)
            a = self.assign(graph, groups, state.bins,
                            initial_load=state.initial_load)
            delta: dict[Hashable, int] = {}
            for g in groups:
                state.record(g, a[g.root])
                delta[g.root] = a[g.root]
            return delta
        sub = [state.bins[i] for i in live]
        load = {j: state.load[live[j]] for j in range(len(live))}
        a = self.assign(graph, groups, sub, initial_load=load)
        delta = {}
        for g in groups:
            idx = live[a[g.root]]
            state.record(g, idx)
            delta[g.root] = idx
        return delta

    def _rebalance(
        self,
        state: SchedulerState,
        *,
        graph: Heteroflow | None = None,
    ) -> dict[Hashable, int]:
        """Empty-event + measured-load path: migrate or repack.

        Consumes ``state.measured_load`` (reset to ``None``).  Returns
        only the entries that actually moved.
        """
        measured = state.measured_load
        state.measured_load = None
        groups = [g for r, g in state.groups.items()
                  if r not in state.finished]
        if not groups:
            return {}
        live = sorted(state.live)
        full = len(live) == len(state.bins)
        bins = state.bins if full else [state.bins[i] for i in live]
        meas = (measured if full else
                {j: bin_load(measured, state.bins, live[j])
                 for j in range(len(live))})
        prev = dict(state.assignment)
        if state.migrate_top_k > 0:
            current: dict[Hashable, int] | None = None
            if all(g.root in prev for g in groups):
                pos = {i: j for j, i in enumerate(live)}
                cur = {g.root: pos.get(prev[g.root]) for g in groups}
                if None not in cur.values():
                    current = cur
            a = self._migrate(groups, bins, measured_load=meas,
                              top_k=state.migrate_top_k, current=current)
            if a is not None:
                return self._commit(state, groups, live, a, prev)
        total_cost = sum(g.cost for g in groups)
        total_meas = sum(meas.values())
        if total_meas > 0 and total_cost > 0:
            scale = total_cost / total_meas
            load = {b: v * scale for b, v in meas.items()}
        else:
            load = dict(meas)
        a = self.assign(graph, groups, bins, initial_load=load or None)
        state.scratch.clear()     # stateful books are stale after a repack
        return self._commit(state, groups, live, a, prev)

    def _commit(self, state: SchedulerState, groups: Sequence[TaskGroup],
                live: list[int], a: Mapping[Hashable, int],
                prev: Mapping[Hashable, int]) -> dict[Hashable, int]:
        """Re-record a rebalanced placement; return the moved entries."""
        state.wipe_placement()
        delta: dict[Hashable, int] = {}
        for g in groups:
            idx = live[a[g.root]]
            state.record(g, idx)
            if prev.get(g.root) != idx:
                delta[g.root] = idx
        return delta

    #: relative spread (max-min over mean measured load) below which
    #: migration considers bins balanced and keeps the placement as-is
    MIGRATE_BALANCE_RTOL = 0.25

    def _migrate(self, groups: Sequence[TaskGroup], bins: Sequence[Any],
                 *, measured_load: Mapping[Any, float], top_k: int,
                 current: Mapping[Hashable, int] | None = None,
                 ) -> dict[Hashable, int] | None:
        """Move ≤ ``top_k`` hottest groups off the most-loaded bins.

        ``current`` is the prior placement; when ``None`` it is derived
        from the graph write-back (``node.bin_key`` / ``node.device``).
        Returns ``None`` when any group lacks a prior placement (caller
        falls back to a full repack).  Load is tracked in measured
        seconds; a group's share of its bin's seconds is estimated by
        its cost fraction on that bin.  A move only happens when it
        shrinks the src/dst gap — near-equal loads yield zero moves.
        """
        if current is not None:
            current = dict(current)
        else:
            labels = bin_labels(bins)
            slot = {label: i for i, label in enumerate(labels)}
            current = {}
            for g in groups:
                idx = None
                for t in g.nodes:
                    if t.bin_key in slot:
                        idx = slot[t.bin_key]
                        break
                    if t.device is not None:
                        idx = bin_index(bins, t.device)
                        if idx is not None:
                            break
                if idx is None:
                    return None                 # unplaced → full repack
                current[g.root] = idx
        load = {i: bin_load(measured_load, bins, i)
                for i in range(len(bins))}
        mean = sum(load.values()) / len(load) if load else 0.0
        if mean <= 0:
            return current                      # nothing measured: no churn
        if (max(load.values()) - min(load.values())) <= \
                self.MIGRATE_BALANCE_RTOL * mean:
            return current                      # near-equal: keep placement
        cost_on = {i: 0.0 for i in range(len(bins))}
        for g in groups:
            cost_on[current[g.root]] += g.cost
        movable = sorted(
            (g for g in groups if g.pin is None),
            key=lambda g: (-g.cost, g.order))
        moved = 0
        for g in movable:
            if moved >= top_k:
                break
            src = current[g.root]
            cand = [i for i in group_candidates(g, bins) if i != src]
            if not cand:
                continue
            dst = min(cand, key=lambda i: (load[i], i))
            if load[src] <= load[dst]:
                continue                        # g sits on a cool bin
            # seconds g is responsible for on src, by cost share
            share = (g.cost / cost_on[src] * load[src]
                     if cost_on[src] > 0 else 0.0)
            if share <= 0 or load[src] - load[dst] <= share:
                continue                        # move would overshoot
            current[g.root] = dst
            load[src] -= share
            load[dst] += share
            cost_on[src] -= g.cost
            cost_on[dst] += g.cost
            moved += 1
        return current

    @abc.abstractmethod
    def assign(
        self,
        graph: Heteroflow,
        groups: Sequence[TaskGroup],
        bins: Sequence[Any],
        *,
        initial_load: Mapping[Any, float] | None = None,
    ) -> dict[Hashable, int]:
        """Map each group root to a bin index.  Must honor ``group.pin``
        when the pinned bin is present in ``bins``.  ``initial_load``
        may be keyed by bin object or bin index (use
        :func:`bin_load` to read it either way)."""

    def _pinned_index(self, g: TaskGroup, bins: Sequence[Any]) -> int | None:
        if g.pin is None:
            return None
        return bin_index(bins, g.pin)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} policy={self.name!r}>"


# ----------------------------------------------------------------------
# policy registry — the config knob (configs.SchedConfig.policy) resolves
# through here, as does Executor(scheduler="heft").
# ----------------------------------------------------------------------
_REGISTRY: dict[str, type[Scheduler]] = {}


def register(cls: type[Scheduler]) -> type[Scheduler]:
    """Class decorator: add a policy to the registry under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} has no policy name")
    _REGISTRY[cls.name] = cls
    return cls


def get_scheduler(policy: "Scheduler | str", **kwargs: Any) -> Scheduler:
    """Resolve a policy name (or pass through an instance)."""
    if isinstance(policy, Scheduler):
        return policy
    try:
        cls = _REGISTRY[policy]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {policy!r}; "
            f"available: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


def available_policies() -> list[str]:
    return sorted(_REGISTRY)
