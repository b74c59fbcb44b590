"""Placement policies over Algorithm-1 affinity groups.

Four strategies, spanning the design space the paper's evaluation sweeps
implicitly (balanced packing) and the classic alternatives from the
list-scheduling literature (HEFT upward-rank), plus the two baselines any
scheduler study needs (round-robin, random — estee ships the same pair):

* :class:`BalancedBins` — the seed Algorithm 1 policy, bit-identical.
* :class:`Heft`         — upward-rank critical-path list scheduling with
  earliest-finish-time bin selection; heterogeneity-aware via
  :class:`~repro_torch.sched.simulator.CostModel` device speeds.
* :class:`RoundRobin`   — groups to bins cyclically in arrival order.
* :class:`RandomPolicy` — seeded uniform assignment.

All policies honor ``sharding`` pins and keep each kernel∪pull group
atomic, so swapping policies can change *when/where* but never *what*
(the executor stress tests assert identical results across policies).
"""
from __future__ import annotations

import random
from typing import Any, Hashable, Mapping, Sequence

from repro_torch.core.graph import Heteroflow, Node, TaskType

from .base import (Scheduler, SchedulerState, TaskGroup, bin_load,
                   group_candidates, register)
from .bins import (bin_compute_scale, bin_lane_width, bin_memory_bytes,
                   stage_link)
from .simulator import CostModel

__all__ = ["BalancedBins", "Heft", "RoundRobin", "RandomPolicy"]


def _event_order(nodes: Sequence[Node]) -> list[Node]:
    """Deterministic topological order over an event-local node set
    (Kahn by ascending node id).  Used when ``update()`` is called
    without the full graph: HEFT then ranks within the event, ignoring
    edges to groups it has not seen yet — exactly the information an
    online scheduler has."""
    import heapq

    ids = {t.id for t in nodes}
    byid = {t.id: t for t in nodes}
    indeg = {t.id: sum(1 for d in t.dependents if d.id in ids)
             for t in nodes}
    ready = [i for i, d in indeg.items() if d == 0]
    heapq.heapify(ready)
    out: list[Node] = []
    while ready:
        i = heapq.heappop(ready)
        n = byid[i]
        out.append(n)
        for s in n.successors:
            if s.id in indeg:
                indeg[s.id] -= 1
                if indeg[s.id] == 0:
                    heapq.heappush(ready, s.id)
    if len(out) != len(nodes):
        raise ValueError("event task set contains a cycle")
    return out


def _over_budget(g: TaskGroup, cap: int | None, packed: int) -> int:
    """1 when packing ``g``'s footprint onto a bin that already holds
    ``packed`` bytes would bust its ``memory_bytes`` budget, else 0.
    Always 0 for unbudgeted bins (cap None) or zero-footprint groups, so
    memory-blind orderings are untouched when budgets are off."""
    if cap is None or g.bytes <= 0:
        return 0
    return 1 if packed + g.bytes > cap else 0


def _mesh_scale(g: TaskGroup, b: object) -> float:
    """Compute speedup group ``g`` gets on bin ``b``: a mesh-tagged
    (sharded) group spans every member device of a mesh slice — ideal
    linear scaling — while everything else runs at single-device speed
    (``repro_torch.sched.bins``; the simulator charges the same rule)."""
    return bin_compute_scale(b) if "mesh" in g.requires else 1.0


def _stage_affinity_penalty(g: TaskGroup, i: int, bins, placed_stage):
    """Stage-affinity tie-break for load-based packing: among equally
    loaded candidate bins, prefer the one minimizing link cost to the
    group's already-placed *adjacent* stages (s−1 feeds it, s+1 drains
    it).  Co-location costs 0; a non-colocated neighbor costs 1 plus
    the normalized inverse bandwidth of the stage link crossed, so
    fatter declared links beat thinner ones and any link beats two.
    Exactly 0.0 for untagged groups — the legacy orderings (and the
    seed-identical balanced placement) are untouched."""
    sid = g.stage_id
    if sid is None or not placed_stage:
        return 0.0
    pen = 0.0
    for adj in (sid - 1, sid + 1):
        j = placed_stage.get(adj)
        if j is None or j == i:
            continue
        # data flows downstream: the link into the later stage governs
        link = (stage_link(bins[j], bins[i]) if adj < sid
                else stage_link(bins[i], bins[j]))
        bw = link[0] if link is not None else None
        # normalize by the cost model's default d2d bandwidth (the
        # dataclass default): undeclared links rank exactly d2d-fast
        pen += 1.0 + CostModel.d2d_bandwidth / (bw or CostModel.d2d_bandwidth)
    return pen


@register
class BalancedBins(Scheduler):
    """Paper Algorithm 1 lines 8-14: largest-group-first (LPT) onto the
    least-loaded bin.

    Exactly reproduces the seed ``core.placement.place()`` decisions:
    groups are sorted by descending cost with a stable sort (ties keep
    first-seen order), and load ties resolve to the lowest bin index.
    Capability-tagged groups only consider their eligible bins, and a
    mesh-sharded group adds ``cost / slice_device_count`` to a mesh
    bin's load (it occupies the slice for that much less time).
    Stage-tagged groups (pipeline cells) gain an affinity tie-break:
    among equally loaded bins, the one with the cheapest link to the
    group's already-placed adjacent stages wins — untagged graphs keep
    the seed-identical ``(load, index)`` ordering bit-for-bit.
    Budgeted bins (``memory_bytes``) pack group *bytes* alongside cost:
    a bin the group's footprint would bust ranks behind every bin with
    room (the leading key term), so packing spreads by memory pressure
    before load; with budgets off the flag is constantly 0 and the seed
    ordering is bit-identical.
    """

    name = "balanced"

    def assign(self, graph: Heteroflow, groups: Sequence[TaskGroup],
               bins: Sequence[Any], *,
               initial_load: Mapping[Any, float] | None = None,
               ) -> dict[Hashable, int]:
        load: dict[int, float] = {i: bin_load(initial_load, bins, i)
                                  for i in range(len(bins))}
        caps = [bin_memory_bytes(b) for b in bins]
        packed = [0] * len(bins)
        assignment: dict[Hashable, int] = {}
        placed_stage: dict[int, int] = {}
        for g in sorted(groups, key=lambda g: -g.cost):
            idx = self._pinned_index(g, bins)
            if idx is None:
                idx = min(group_candidates(g, bins),
                          key=lambda i: (_over_budget(g, caps[i], packed[i]),
                                         load[i],
                                         _stage_affinity_penalty(
                                             g, i, bins, placed_stage),
                                         i))
            assignment[g.root] = idx
            if g.stage_id is not None:
                placed_stage[g.stage_id] = idx
            load[idx] += g.cost / _mesh_scale(g, bins[idx])
            packed[idx] += g.bytes
        return assignment


@register
class RoundRobin(Scheduler):
    """Groups to bins cyclically in first-seen order; pins don't advance
    the cursor (a pinned group was never the policy's choice).

    Deliberately load-blind: ``initial_load`` is ignored (this is the
    locality-blind baseline), so dynamic re-placement recomputes the
    same cyclic assignment every window."""

    name = "round_robin"

    def assign(self, graph: Heteroflow, groups: Sequence[TaskGroup],
               bins: Sequence[Any], *,
               initial_load: Mapping[Any, float] | None = None,
               ) -> dict[Hashable, int]:
        state = SchedulerState(bins, initial_load=initial_load)
        for g in groups:
            state.add_group(g)
        return self.place_update(state, list(groups), graph=graph)

    def place_update(self, state: SchedulerState,
                     groups: Sequence[TaskGroup], *,
                     graph: Heteroflow | None = None,
                     ) -> dict[Hashable, int]:
        # the cursor survives across events (state.scratch), so online
        # arrivals keep cycling instead of restarting at bin 0 per event
        cursor = state.scratch.get("rr_cursor", 0)
        delta: dict[Hashable, int] = {}
        for g in sorted(groups, key=lambda g: g.order):
            idx = self._pinned_index(g, state.bins)
            if idx is None or idx not in state.live:
                cand = state.candidates(g)
                idx = cand[cursor % len(cand)]
                cursor += 1
            state.record(g, idx)
            delta[g.root] = idx
        state.scratch["rr_cursor"] = cursor
        return delta


@register
class RandomPolicy(Scheduler):
    """Seeded uniform assignment — the floor any real policy must beat.
    Load-blind by design: ``initial_load`` is ignored."""

    name = "random"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def assign(self, graph: Heteroflow, groups: Sequence[TaskGroup],
               bins: Sequence[Any], *,
               initial_load: Mapping[Any, float] | None = None,
               ) -> dict[Hashable, int]:
        state = SchedulerState(bins, initial_load=initial_load)
        for g in groups:
            state.add_group(g)
        return self.place_update(state, list(groups), graph=graph)

    def place_update(self, state: SchedulerState,
                     groups: Sequence[TaskGroup], *,
                     graph: Heteroflow | None = None,
                     ) -> dict[Hashable, int]:
        # one rng per state: the draw sequence continues across events,
        # so an online run stays a single seeded sample, not a restart
        rng = state.scratch.get("random_rng")
        if rng is None:
            rng = state.scratch["random_rng"] = random.Random(self.seed)
        delta: dict[Hashable, int] = {}
        for g in sorted(groups, key=lambda g: g.order):
            idx = self._pinned_index(g, state.bins)
            if idx is None or idx not in state.live:
                cand = state.candidates(g)
                idx = cand[rng.randrange(len(cand))]
            state.record(g, idx)
            delta[g.root] = idx
        state.scratch["random_rng"] = rng
        return delta


@register
class Heft(Scheduler):
    """Heterogeneous-Earliest-Finish-Time list scheduling at group
    granularity (Topcuoglu et al., the policy the Taskflow line of work
    benchmarks against).

    1. *Upward rank* per node: mean execution time plus the maximum over
       successors of (cross-group transfer time + successor rank) — the
       critical-path-to-exit estimate.
    2. Groups are processed in decreasing rank (rank of a group = max
       rank of its member nodes; ties break on arrival order).
    3. Each group goes to the bin minimizing its earliest finish time,
       accounting for per-bin speed, bin availability, and transfer cost
       from already-placed cross-group predecessors.

    The same :class:`CostModel` drives the simulator, so HEFT optimizes
    the metric ``sched.simulator.simulate`` measures — including the
    lane model: with ``lane_depth >= 2`` each bin's availability is
    tracked per lane (copy vs. compute), so EFT sees a group's H2D pulls
    overlapping another group's kernel exactly the way the overlapped
    simulator charges them.

    Pipeline-stage groups (``TaskGroup.stage_id``) get a *pipelined*
    EFT: when an adjacent upstream stage feeds this group cell-by-cell
    (distinct upstream producers ≥ upstream cells — a lone producer,
    e.g. a reduction between stages or a last-cell fan-out, still
    waits for the group finish), its data is ready after that stage's
    FIRST cell (fill), not its whole-group finish — group-granularity EFT would otherwise model
    stages as contiguous blocks, conclude that spreading them only adds
    transfer cost, and serialize the entire pipeline onto one bin.
    Transfers between stage bins are charged over their inter-stage
    links (``CostModel.transfer_time``), so adjacent stages land on
    cheap links: exactly the trade-off the simulator scores.

    Budgeted bins (``memory_bytes``) are memory-aware: a candidate whose
    remaining budget the group's footprint would bust has the eviction
    round trip of the overflow (``CostModel.spill_time``) added to its
    EFT — the same charge the simulator levies for a forced spill — so
    a bin with room wins unless it is slower by more than the spill
    costs.  With budgets off no penalty is ever added and EFT decisions
    are bit-identical to the memory-blind model.
    """

    name = "heft"

    def __init__(self, cost_model: CostModel | None = None):
        self.cost_model = cost_model or CostModel()

    @classmethod
    def from_trace(cls, trace: Any, *, base: CostModel | None = None) -> "Heft":
        """HEFT driven by a :meth:`CostModel.fit`-calibrated model — rank
        and EFT decisions then optimize *measured* seconds, not the
        round-number defaults (profile-guided scheduling loop; see
        docs/scheduling.md)."""
        return cls(CostModel.fit(trace, base=base))

    def assign(self, graph: Heteroflow, groups: Sequence[TaskGroup],
               bins: Sequence[Any], *,
               initial_load: Mapping[Any, float] | None = None,
               ) -> dict[Hashable, int]:
        state = SchedulerState(bins, initial_load=initial_load)
        for g in groups:
            state.add_group(g)
        return self.place_update(state, list(groups), graph=graph)

    def place_update(self, state: SchedulerState,
                     groups: Sequence[TaskGroup], *,
                     graph: Heteroflow | None = None,
                     ) -> dict[Hashable, int]:
        """Incremental EFT: place only ``groups``, against lane clocks
        and group finish times persisted in ``state.scratch`` — earlier
        events' placements are facts, never revisited.  A decode group
        whose prefill predecessor was placed two events ago still sees
        its finish time and pays :meth:`CostModel.transfer_time` if it
        lands on a different bin, which is exactly the KV-locality
        pull the serving engine relies on.  With a fresh state and the
        full graph this is bit-identical to classic one-shot HEFT.
        """
        if not groups:
            return {}
        if all(g.agg is not None for g in groups):
            # coarsened super-groups (repro_torch.sched.coarsen): price EFT
            # from the pre-digested aggregates in O(bins) per group
            # instead of O(member nodes × bins) — the windowed coarse
            # path never pays per-node work here
            return self._place_aggregate(state, groups)
        model = self.cost_model
        bins = state.bins
        live = sorted(state.live)
        mean_speed = (sum(model.speed(i) for i in live) / len(live)) or 1.0

        sc = state.scratch.setdefault("heft", {})
        group_of: dict[int, Hashable] = sc.setdefault("group_of", {})
        for g in groups:
            for t in g.nodes:
                group_of[t.id] = g.root

        # -- upward ranks: over the full node graph when offline callers
        # provide it (host tasks included: they sit on critical paths
        # between kernels), else over the event's own nodes — edges to
        # not-yet-seen groups are simply unknown futures ----------------
        if graph is not None:
            order = graph.topological_order()
            if order is None:
                raise ValueError(f"graph '{graph.name}' contains a cycle")
        else:
            order = _event_order([t for g in groups for t in g.nodes])
        rank: dict[int, float] = {}
        for n in reversed(order):
            w = model.node_time(n, speed=mean_speed)
            best = 0.0
            for s in n.successors:
                if s.id not in rank:
                    continue       # successor outside this event's horizon
                comm = 0.0
                gn, gs = group_of.get(n.id), group_of.get(s.id)
                if gn is not None and gs is not None and gn != gs:
                    comm = model.transfer_time(model.out_bytes(n))
                best = max(best, comm + rank[s.id])
            rank[n.id] = w + best

        group_rank = {g.root: max(rank[t.id] for t in g.nodes)
                      for g in groups}
        stage_of: dict[Hashable, int | None] = sc.setdefault("stage_of", {})
        n_cells: dict[Hashable, int] = sc.setdefault("n_cells", {})
        for g in groups:
            stage_of[g.root] = g.stage_id
            n_cells[g.root] = sum(1 for t in g.nodes
                                  if t.type == TaskType.KERNEL)
        # cross-group predecessor map (for EFT data-ready times), plus
        # the DISTINCT upstream producers per group pair: adjacent
        # pipeline stages are only *pipelined* (cell-by-cell) when
        # essentially every upstream cell feeds this group — a single
        # producer (e.g. a reduction between stages, or a last-cell
        # fan-out) means the consumer really waits for the group finish
        preds: dict[Hashable, set[tuple[Hashable, int]]] = {g.root: set()
                                                            for g in groups}
        edge_src: dict[tuple[Hashable, Hashable], set[int]] = {}
        for g in groups:
            for t in g.nodes:
                for d in t.dependents:
                    gd = group_of.get(d.id)
                    if gd is not None and gd != g.root:
                        preds[g.root].add((gd, model.out_bytes(d)))
                        edge_src.setdefault((g.root, gd), set()).add(d.id)

        # pre-existing load delays a bin's availability, converted from
        # cost units to seconds by the same rule EFT charges for kernels.
        # Per the Scheduler contract, initial_load shares cost_fn's units
        # (arena bytes under the default byte-based cost metric; rescaled
        # cost units from the measured-load rebalance path).  Availability
        # is tracked per LANE when the model overlaps (lane_depth >= 2):
        # a group's pulls queue on the copy lane, its kernels on the
        # compute lane — the same two clocks the simulator advances.
        # Each bin owns one lane *pair per member device* (mesh slices
        # have several), so availability is a per-server list: a
        # mesh-sharded group occupies every server of its slice, any
        # other task takes the earliest-free one — mirroring the
        # simulator's multi-server lane model exactly.  The clocks live
        # in scratch and keep ticking across events; bins added since
        # the last event start with idle (zero) lanes.
        overlap = model.lane_depth >= 2
        caps = [bin_memory_bytes(b) for b in bins]
        copy_free, compute_free = self._lane_clocks(state, sc, overlap)
        finish: dict[Hashable, float] = sc.setdefault("finish", {})
        start_c: dict[Hashable, float] = sc.setdefault("start_c", {})
        cell_t: dict[Hashable, float] = sc.setdefault("cell_t", {})
        placed = state.assignment                   # prior events included
        delta: dict[Hashable, int] = {}
        for g in sorted(groups, key=lambda g: (-group_rank[g.root], g.order)):
            pinned = self._pinned_index(g, bins)
            if pinned is not None and pinned not in state.live:
                pinned = None                       # pinned bin retired
            wide = "mesh" in g.requires
            best: tuple[int, float, float, float] | None = None
            candidates = (state.candidates(g) if pinned is None
                          else (pinned,))
            # pull time is bandwidth-bound — identical on every candidate
            # (a sharded group splits it across the slice's copy lanes)
            pull_t = sum(model.node_time(t) for t in g.nodes
                         if t.type == TaskType.PULL)
            for i in candidates:
                data_ready = 0.0
                for (pg, nbytes) in preds[g.root]:
                    if pg not in placed:
                        continue  # predecessor group not yet ranked-ahead
                    sid, psid = stage_of[g.root], stage_of.get(pg)
                    if (sid is not None and psid is not None
                            and abs(sid - psid) == 1
                            and len(edge_src.get((g.root, pg), ()))
                            >= n_cells[pg] > 0):
                        # adjacent pipeline stages coupled cell-by-cell:
                        # the first activation is ready one cell into
                        # the upstream stage, not at its group finish
                        t_avail = start_c[pg] + cell_t[pg]
                    else:
                        t_avail = finish[pg]
                    if placed[pg] != i:
                        # stage endpoints charge their inter-stage link
                        # (EFT prefers adjacent stages on cheap links)
                        t_avail += model.transfer_time(
                            nbytes, bins[placed[pg]], bins[i])
                    data_ready = max(data_ready, t_avail)
                scale = _mesh_scale(g, bins[i])
                # a wide group waits for ALL servers; a narrow one for
                # the earliest-free server of each lane class
                avail = max if wide else min
                copy_avail = avail(copy_free[i])
                compute_avail = avail(compute_free[i])
                # node_time scales only kernels by speed — the same rule
                # the simulator charges, so EFT optimizes what it measures
                kern_t = sum(model.node_time(t, speed=model.speed(i))
                             for t in g.nodes
                             if t.type != TaskType.PULL) / scale
                if wide and scale > 1:
                    # non-ideal sharded scaling: each sharded kernel
                    # pays the α-β collective sync the simulator charges
                    kern_t += sum(
                        model.collective_overhead(int(scale),
                                                  model.out_bytes(t))
                        for t in g.nodes if t.type == TaskType.KERNEL)
                g_pull_t = pull_t / scale
                copy_done = (max(data_ready, copy_avail) + g_pull_t
                             if g_pull_t > 0 else data_ready)
                eft = (max(copy_done, compute_avail) + kern_t
                       if kern_t > 0 else max(copy_done, copy_avail))
                if caps[i] is not None and g.bytes > 0:
                    over = state.packed[i] + g.bytes - caps[i]
                    if over > 0:   # eviction penalty: the spill round
                        eft += model.spill_time(over)  # trip sim charges
                if best is None or eft < best[1]:
                    best = (i, eft, copy_done, kern_t)
            idx, eft, copy_done, kern_t = best

            def _occupy(servers: list[float], until: float) -> None:
                if wide:
                    servers[:] = [until] * len(servers)
                else:
                    servers[min(range(len(servers)),
                                key=servers.__getitem__)] = until

            state.record(g, idx)          # assignment + load/bytes books
            delta[g.root] = idx
            finish[g.root] = eft
            start_c[g.root] = eft - kern_t
            cell_t[g.root] = kern_t / max(n_cells[g.root], 1)
            if pull_t > 0:
                _occupy(copy_free[idx], copy_done)
            if kern_t > 0 or not overlap:
                _occupy(compute_free[idx], eft)
        return delta

    def _lane_clocks(self, state: SchedulerState, sc: dict,
                     overlap: bool) -> tuple[list, list]:
        """Per-bin per-server lane availability, persisted in scratch
        (shared by the exact and aggregate EFT paths — see the long
        comment at the exact path's call site for the model)."""
        model = self.cost_model
        bins = state.bins
        copy_free: list[list[float]] = sc.get("copy_free")
        if copy_free is None:
            init_s = [bin_load(state.initial_load, bins, i)
                      / (model.compute_rate * (model.speed(i) or 1.0))
                      for i in range(len(bins))]
            copy_free = [[init_s[i]] * bin_lane_width(bins[i])
                         for i in range(len(bins))]
            compute_free = ([list(s) for s in copy_free] if overlap
                            else copy_free)
            sc["copy_free"], sc["compute_free"] = copy_free, compute_free
        else:
            compute_free = sc["compute_free"]
            while len(copy_free) < len(bins):      # bins added by events
                lanes = [0.0] * bin_lane_width(bins[len(copy_free)])
                copy_free.append(lanes)
                if overlap:
                    compute_free.append(list(lanes))
        return copy_free, compute_free

    def _place_aggregate(self, state: SchedulerState,
                         groups: Sequence[TaskGroup],
                         ) -> dict[Hashable, int]:
        """EFT over coarsened super-groups from their ``agg`` digests.

        Same clocks, same scratch, same spill penalty and pin handling
        as the exact path — but pull time is
        ``n_pulls·latency + pull_bytes/h2d`` and kernel time is
        ``kern_cost/(compute_rate·speed)``, both O(1) per candidate.
        Exact when the model has no per-codelet ``kernel_rates`` (every
        kernel then runs at the aggregate rate with zero fixed latency);
        with fitted histories, or α-β collective sync on sharded
        groups, the digest is an approximation — acceptable for a
        coarse pass whose decisions only steer locality, never
        correctness.  Ranks are computed at group granularity from the
        super-DAG edges, within the window (successors in later windows
        are unknown futures, the same horizon the exact event-local
        ranking has).
        """
        model = self.cost_model
        bins = state.bins
        live = sorted(state.live)
        mean_speed = (sum(model.speed(i) for i in live) / len(live)) or 1.0
        sc = state.scratch.setdefault("heft", {})
        # in-edges accumulate across windows: the linearization order is
        # the window order, so a predecessor registers its out-edges
        # before any window containing a consumer runs
        in_edges: dict[Hashable, list] = sc.setdefault("agg_in", {})
        for g in groups:
            for s, nb in g.agg["out_edges"].items():
                in_edges.setdefault(s, []).append((g.root, nb))

        def agg_w(g: TaskGroup, speed: float) -> float:
            a = g.agg
            pull = (a["n_pulls"] * model.latency_s
                    + a["pull_bytes"] / model.h2d_bandwidth)
            kern = a["kern_cost"] / (model.compute_rate * (speed or 1.0))
            return pull + kern

        rank: dict[Hashable, float] = {}
        for g in sorted(groups, key=lambda g: -g.order):
            best = 0.0
            for s, nb in g.agg["out_edges"].items():
                r = rank.get(s)
                if r is not None:
                    best = max(best, model.transfer_time(nb) + r)
            rank[g.root] = agg_w(g, mean_speed) + best

        overlap = model.lane_depth >= 2
        caps = [bin_memory_bytes(b) for b in bins]
        copy_free, compute_free = self._lane_clocks(state, sc, overlap)
        finish: dict[Hashable, float] = sc.setdefault("finish", {})
        start_c: dict[Hashable, float] = sc.setdefault("start_c", {})
        cell_t: dict[Hashable, float] = sc.setdefault("cell_t", {})
        placed = state.assignment
        delta: dict[Hashable, int] = {}
        for g in sorted(groups, key=lambda g: (-rank[g.root], g.order)):
            a = g.agg
            pinned = self._pinned_index(g, bins)
            if pinned is not None and pinned not in state.live:
                pinned = None
            wide = "mesh" in g.requires
            candidates = (state.candidates(g) if pinned is None
                          else (pinned,))
            pull_t = (a["n_pulls"] * model.latency_s
                      + a["pull_bytes"] / model.h2d_bandwidth)
            pred_list = in_edges.get(g.root, ())
            best: tuple[int, float, float, float] | None = None
            for i in candidates:
                data_ready = 0.0
                for (pg, nbytes) in pred_list:
                    if pg not in placed:
                        continue
                    t_avail = finish.get(pg, 0.0)
                    if placed[pg] != i:
                        t_avail += model.transfer_time(
                            nbytes, bins[placed[pg]], bins[i])
                    data_ready = max(data_ready, t_avail)
                scale = _mesh_scale(g, bins[i])
                avail = max if wide else min
                copy_avail = avail(copy_free[i])
                compute_avail = avail(compute_free[i])
                kern_t = (a["kern_cost"]
                          / (model.compute_rate * (model.speed(i) or 1.0))
                          / scale)
                g_pull_t = pull_t / scale
                copy_done = (max(data_ready, copy_avail) + g_pull_t
                             if g_pull_t > 0 else data_ready)
                eft = (max(copy_done, compute_avail) + kern_t
                       if kern_t > 0 else max(copy_done, copy_avail))
                if caps[i] is not None and g.bytes > 0:
                    over = state.packed[i] + g.bytes - caps[i]
                    if over > 0:
                        eft += model.spill_time(over)
                if best is None or eft < best[1]:
                    best = (i, eft, copy_done, kern_t)
            idx, eft, copy_done, kern_t = best
            state.record(g, idx)
            delta[g.root] = idx
            finish[g.root] = eft
            start_c[g.root] = eft - kern_t
            cell_t[g.root] = kern_t / max(a["n_kernels"], 1)
            if wide:
                if pull_t > 0:
                    copy_free[idx][:] = [copy_done] * len(copy_free[idx])
                if kern_t > 0 or not overlap:
                    compute_free[idx][:] = [eft] * len(compute_free[idx])
            else:
                if pull_t > 0:
                    lanes = copy_free[idx]
                    lanes[min(range(len(lanes)),
                              key=lanes.__getitem__)] = copy_done
                if kern_t > 0 or not overlap:
                    lanes = compute_free[idx]
                    lanes[min(range(len(lanes)),
                              key=lanes.__getitem__)] = eft
        return delta


def gather_sources(node: Node) -> list[Node]:
    """Source pull tasks of a kernel (paper Listing 8 line 3) — exposed
    for tests and external policies."""
    if node.type != TaskType.KERNEL:
        return []
    return list(node.state.get("sources", ()))
