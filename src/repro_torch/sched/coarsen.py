"""Hierarchical (coarsened) scheduling — million-task scale.

The paper's headline workload is million-scale VLSI timing propagation;
at that size whole-graph list scheduling is the bottleneck, not the
hardware.  Taskflow attacks the problem with hierarchical composition
(subflows placed as units); the classic scheduling literature calls the
same move *graph coarsening*: cluster the fine placement units into
super-groups, place groups-of-groups, then expand the coarse decision
back to the members.

This module implements that pipeline over Algorithm-1 affinity groups:

* :func:`coarsen` — contract contiguous intervals of a heavy-edge-greedy
  topological linearization of the projected group DAG into super
  :class:`~repro_torch.sched.base.TaskGroup`\\ s (acyclic quotient by
  construction), with cost-budget / stage / capability / pin cut rules.
* :func:`windowed_place` — feed groups through ``place_update`` in
  topological windows of K against one persistent
  :class:`~repro_torch.sched.base.SchedulerState`, so HEFT's lane clocks
  freeze between windows (the PR-7 ``update()`` machinery) instead of
  re-ranking the whole graph.
* :func:`hierarchical_schedule` — grouping → optional coarsening →
  windowed placement → expansion, collapsing to the ordinary
  ``Scheduler.schedule`` path when both knobs are off (bit-identical
  placements — the same default-off discipline as
  ``budgets_off_bit_identical``).

Coarsening trades placement *quality* only, never correctness: node
level dependencies stay on the graph and the executor enforces them
regardless of where groups land, and every member of a super-group
inherits its capability tags / stage id / pin because intervals only
merge groups agreeing on all three.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Callable, Hashable, Mapping, Sequence

from repro_torch.core.graph import Heteroflow, Node, TaskType
from repro_torch.core.placement import estimate_node_cost

from .base import (Scheduler, SchedulerState, TaskGroup, apply_assignment,
                   build_groups, get_scheduler, node_footprint)
from .profile import producer_bytes

__all__ = [
    "CoarsenPlan",
    "coarsen",
    "group_edges",
    "toposort_groups",
    "windowed_place",
    "hierarchical_schedule",
]

CostFn = Callable[[Node], float]


def group_edges(groups: Sequence[TaskGroup],
                ) -> dict[Hashable, dict[Hashable, int]]:
    """Project node-level dependencies onto the group DAG.

    Returns ``{src_root: {dst_root: bytes}}`` where ``bytes`` sums the
    producer spans (:func:`~repro_torch.sched.profile.producer_bytes`, the
    same estimate HEFT's EFT charges per cross-group edge) over every
    node edge crossing the pair.  Producer bytes are cached per node id
    — the estimate recurses through kernel sources, and a node with many
    consumers would otherwise pay it per edge.

    Super-groups short-circuit to their pre-digested ``agg`` edges, so
    re-deriving the coarse DAG never touches member nodes.
    """
    if groups and all(g.agg is not None for g in groups):
        return {g.root: dict(g.agg["out_edges"]) for g in groups}
    group_of: dict[int, Hashable] = {}
    for g in groups:
        r = g.root
        for t in g.nodes:
            group_of[t.id] = r

    # memoized mirror of producer_bytes (keep in sync with
    # sched.profile): netlist-scale graphs share operand arrays across
    # cells, so the span estimate is cached per (source, size) instead
    # of paying an np.asarray round-trip per edge —
    # tests/test_coarsen.py pins weight equality against the original
    spans: dict[tuple[int, Any], int] = {}

    def _pbytes(t: Node) -> int:
        tt = t.type
        if tt is TaskType.PULL:
            st = t.state
            key = (id(st.get("source")), st.get("size"))
            v = spans.get(key)
            if v is None:
                v = spans[key] = producer_bytes(t)
            return v
        if tt is TaskType.KERNEL:
            return max((_pbytes(s) for s in t.state.get("sources", ())),
                       default=0)
        return 0

    out: dict[Hashable, dict[Hashable, int]] = {}
    gget = group_of.get
    for g in groups:
        r = g.root
        d = out[r] = {}
        for t in g.nodes:
            b = -1                     # producer span, computed lazily
            for s in t.successors:
                gs = gget(s.id)
                if gs is None or gs == r:
                    continue
                if b < 0:
                    b = _pbytes(t)
                d[gs] = d.get(gs, 0) + b
    return out


def _linearize(groups: Sequence[TaskGroup],
               edges: Mapping[Hashable, Mapping[Hashable, int]],
               *, heavy: bool) -> list[TaskGroup]:
    """Topological linearization of the projected group DAG.

    ``heavy=True`` picks, among ready groups, the one whose in-edges
    from already-linearized predecessors carry the most bytes (ties fall
    back to first-seen order) — consecutive positions then share heavy
    edges, which is what makes interval contraction "merge along heavy
    edges".  ``heavy=False`` is plain Kahn by first-seen order.

    The *projection* of an acyclic node graph can be cyclic (multi-node
    groups — pipeline stages — may interleave); when the ready set runs
    dry with groups remaining, the unplaced group with the smallest
    order is released and its unsatisfied in-edges become back-edges.
    Callers drop back-edges from the quotient, so the coarse DAG stays
    acyclic.
    """
    n = len(groups)
    idx_of = {g.root: i for i, g in enumerate(groups)}
    succ: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for r, d in edges.items():
        i = idx_of.get(r)
        if i is None:
            continue
        si = succ[i]
        for s, nb in d.items():
            j = idx_of.get(s)
            if j is not None:
                si.append((j, nb))
    return _kahn(groups, succ, heavy=heavy)


def _kahn(groups: Sequence[TaskGroup],
          succ: Sequence[Sequence[tuple[int, int]]],
          *, heavy: bool) -> list[TaskGroup]:
    """Index-based core of :func:`_linearize`: ``succ[i]`` lists
    ``(position, bytes)`` out-edges of ``groups[i]``.  Dense lists, not
    dicts — at 10^5+ groups the dict-of-dict chasing of the obvious
    implementation dominates coarsening time; flat positional arrays
    don't."""
    n = len(groups)
    orders = [g.order for g in groups]
    indeg = [0] * n
    for si in succ:
        for j, _ in si:
            indeg[j] += 1
    weight_in = [0] * n
    # heap entries are (-in_bytes, order, idx): orders are unique, so
    # the index never gets compared.  A group enters the heap only when
    # its last in-edge is satisfied, at which point its in-weight is
    # final — no stale entries.
    ready = [(0, orders[i], i) for i in range(n) if indeg[i] == 0]
    heapq.heapify(ready)
    by_order = sorted(range(n), key=orders.__getitem__)  # cycle-break scan
    pi = 0
    placed = [False] * n
    out: list[TaskGroup] = []
    while len(out) < n:
        gi = -1
        while ready:
            _, _, i = heapq.heappop(ready)
            if not placed[i]:
                gi = i
                break
        if gi < 0:
            while placed[by_order[pi]]:
                pi += 1
            gi = by_order[pi]                  # projected cycle: break it
        placed[gi] = True
        out.append(groups[gi])
        for j, nb in succ[gi]:
            if placed[j]:
                continue
            indeg[j] -= 1
            if heavy:
                weight_in[j] += nb
            if indeg[j] == 0:
                heapq.heappush(
                    ready, (-weight_in[j] if heavy else 0, orders[j], j))
    return out


def toposort_groups(groups: Sequence[TaskGroup]) -> list[TaskGroup]:
    """Topological order over the projected group DAG (plain Kahn,
    first-seen-order tie-break; projected cycles broken deterministically
    — see :func:`_linearize`)."""
    groups = list(groups)
    return _linearize(groups, group_edges(groups), heavy=False)


@dataclass
class CoarsenPlan:
    """Result of :func:`coarsen`: the super-groups plus the member map.

    ``super_groups`` are ordinary :class:`~repro_torch.sched.base.TaskGroup`\\ s
    (policies need no new API) whose ``agg`` field carries the
    pre-digested totals HEFT's aggregate fast path consumes;
    ``members[super_root]`` lists the fine groups each contracted
    interval absorbed, in linearization order.
    """

    super_groups: list[TaskGroup]
    members: dict[Hashable, list[TaskGroup]]

    def expand(self, assignment: Mapping[Hashable, int],
               ) -> dict[Hashable, int]:
        """Refine a coarse placement back to the fine groups: every
        member lands on its super-group's bin.  The refinement is legal
        by construction — a super-group's ``requires``/``pin`` equal
        every member's, so any bin eligible for the super-group is
        eligible for each member."""
        out: dict[Hashable, int] = {}
        for sr, mem in self.members.items():
            idx = assignment[sr]
            for g in mem:
                out[g.root] = idx
        return out


def coarsen(groups: Sequence[TaskGroup], target: int, *,
            max_spread: float = 4.0,
            cost_fn: CostFn = estimate_node_cost) -> CoarsenPlan:
    """Cluster affinity groups into roughly ``target`` super-groups.

    Contracts contiguous intervals of a heavy-edge-greedy topological
    linearization of the projected group DAG — an interval quotient of a
    topological order is acyclic by construction, so the super-DAG needs
    no cycle check.  An interval is closed when:

    * its accumulated cost reaches ``total_cost / target`` (the budget),
      or adding the next group would exceed ``max_spread ×`` the budget
      (the cost-spread cap: one huge super-group cannot starve the
      policy of choices);
    * the pipeline ``stage_id`` or capability ``requires`` set changes
      (members must agree, so super-group tags stay exact);
    * a ``pin`` is involved (pinned groups stay singletons — the pin
      override remains exact).

    Each super-group's ``agg`` dict carries ``n_pulls`` / ``pull_bytes``
    / ``kern_cost`` / ``n_kernels`` and the forward inter-super-group
    ``out_edges`` byte map, which is what lets HEFT's aggregate path
    price a candidate bin in O(1) instead of O(member nodes).
    ``kern_cost`` uses ``cost_fn`` — pass the same metric the cost model
    charges or the digest drifts from the exact EFT.

    When the groups' first-seen order is already topological over the
    projected DAG (the common case — graphs built source-to-sink, like
    a netlist in propagation order), the heavy-edge Kahn pass is
    skipped and that order is contracted directly: creation order *is*
    the locality order there, so order-contiguous intervals merge
    exactly the heavy local edges the Kahn pass would have chased,
    without its 10^5-entry heap.  Interleaved or shuffled graphs take
    the general heavy-edge path.
    """
    groups = list(groups)
    if target <= 0:
        raise ValueError("coarsen target must be positive")
    n = len(groups)
    idx_of = {g.root: i for i, g in enumerate(groups)}
    group_pos: dict[int, int] = {}
    for i, g in enumerate(groups):
        for t in g.nodes:
            group_pos[t.id] = i

    # ONE fused pass over member nodes produces everything the later
    # stages need — the projected edges, the per-group digest columns,
    # and whether first-seen order is already topological — because at
    # 10^5 groups every extra sweep over nodes costs more than all the
    # non-node work combined.  Same span memo + default-metric inlining
    # as build_groups' hot loop.
    spans: dict[tuple[int, Any], int] = {}

    def _pbytes(t: Node) -> int:
        # memoized mirror of producer_bytes (keep in sync with
        # sched.profile; tests/test_coarsen.py pins weight equality)
        tt = t.type
        if tt is TaskType.PULL:
            st = t.state
            key = (id(st.get("source")), st.get("size"))
            v = spans.get(key)
            if v is None:
                v = spans[key] = producer_bytes(t)
            return v
        if tt is TaskType.KERNEL:
            best = 0
            for s in t.state.get("sources", ()):
                if s.type is TaskType.PULL:      # inlined common case
                    st = s.state
                    key = (id(st.get("source")), st.get("size"))
                    v = spans.get(key)
                    if v is None:
                        v = spans[key] = producer_bytes(s)
                else:
                    v = _pbytes(s)
                if v > best:
                    best = v
            return best
        return 0

    default_cost = cost_fn is estimate_node_cost
    n_pulls = [0] * n
    pull_bytes = [0] * n
    n_kernels = [0] * n
    kern_cost = [0.0] * n
    edges: list[dict[int, int]] = [{} for _ in range(n)]
    forward = True
    gp_get = group_pos.get
    for i, g in enumerate(groups):
        d = edges[i]
        a = g.agg
        if a is not None:            # re-coarsening already-coarse input
            n_pulls[i] = a["n_pulls"]
            pull_bytes[i] = a["pull_bytes"]
            n_kernels[i] = a["n_kernels"]
            kern_cost[i] = a["kern_cost"]
            for dst, nb in a["out_edges"].items():
                j = idx_of.get(dst)
                if j is None or j == i:
                    continue
                d[j] = d.get(j, 0) + nb
                if j < i:
                    forward = False
            continue
        for t in g.nodes:
            tt = t.type
            st = t.state
            if tt is TaskType.PULL:
                key = (id(st.get("source")), st.get("size"))
                nb = spans.get(key)
                if nb is None:
                    nb = spans[key] = node_footprint(t)
                n_pulls[i] += 1
                pull_bytes[i] += nb
            elif tt is TaskType.KERNEL:
                n_kernels[i] += 1
                kern_cost[i] += (float(st.get("cost", 1.0))
                                 if default_cost else cost_fn(t))
            b = -1                   # producer span, computed lazily
            for s in t.successors:
                j = gp_get(s.id)
                if j is None or j == i:
                    continue
                if b < 0:
                    b = _pbytes(t)
                d[j] = d.get(j, 0) + b
                if j < i:
                    forward = False

    if forward:
        lin_pos = range(n)           # contract first-seen order directly
    else:
        linear = _kahn(groups, [list(d.items()) for d in edges],
                       heavy=True)
        lin_pos = [idx_of[g.root] for g in linear]

    costs = [g.cost for g in groups]
    total = sum(costs)
    budget = total / float(target)
    # all-zero costs (degenerate custom metric): fall back to a member
    # count budget so coarsening still reduces the group count
    count_budget = (max(1, -(-n // int(target)))
                    if budget <= 0 else None)

    runs: list[list[int]] = []       # original positions, linear order
    cur: list[int] = []
    cur_cost = 0.0
    head: TaskGroup | None = None
    for p in lin_pos:
        g = groups[p]
        if cur and (g.pin is not None or head.pin is not None
                    or g.requires != head.requires
                    or g.stage_id != head.stage_id
                    or (count_budget is not None
                        and len(cur) >= count_budget)
                    or (budget > 0 and cur_cost >= budget)
                    or (budget > 0
                        and cur_cost + costs[p] > max_spread * budget)):
            runs.append(cur)
            cur, cur_cost = [], 0.0
        if not cur:
            head = g
        cur.append(p)
        cur_cost += costs[p]
    if cur:
        runs.append(cur)

    supers: list[TaskGroup] = []
    members: dict[Hashable, list[TaskGroup]] = {}
    sup_of = [0] * n                 # original position → super index
    for i, run in enumerate(runs):
        root = ("super", i)
        head = groups[run[0]]
        sg = TaskGroup(root=root, order=i, requires=head.requires,
                       stage_id=head.stage_id, pin=head.pin)
        a_pulls = a_pbytes = a_nk = 0
        a_kcost = 0.0
        mem: list[TaskGroup] = []
        for p in run:
            g = groups[p]
            sup_of[p] = i
            mem.append(g)
            sg.nodes.extend(g.nodes)
            sg.cost += g.cost
            sg.bytes += g.bytes
            a_pulls += n_pulls[p]
            a_pbytes += pull_bytes[p]
            a_nk += n_kernels[p]
            a_kcost += kern_cost[p]
        sg.agg = {"n_pulls": a_pulls, "pull_bytes": a_pbytes,
                  "kern_cost": a_kcost, "n_kernels": a_nk,
                  "out_edges": {}}
        supers.append(sg)
        members[root] = mem

    for p in range(n):
        si = sup_of[p]
        oe = supers[si].agg["out_edges"]
        for j, nb in edges[p].items():
            sj = sup_of[j]
            if sj <= si:
                continue         # internal edge, or cycle-broken back-edge
            dr = supers[sj].root
            oe[dr] = oe.get(dr, 0) + nb
    return CoarsenPlan(super_groups=supers, members=members)


def windowed_place(scheduler: Scheduler, state: SchedulerState,
                   groups: Sequence[TaskGroup], *, window: int = 0,
                   graph: Heteroflow | None = None) -> dict[Hashable, int]:
    """Place ``groups`` through ``scheduler.place_update`` in topological
    windows of ``window`` groups against ONE persistent state.

    Policy-private books (HEFT lane clocks and group finish times,
    round-robin cursors) live in ``state.scratch`` and freeze between
    windows — window *k+1* sees window *k*'s placements as facts, pays
    transfer time from them, but never re-ranks them: exactly the PR-7
    ``update()`` contract, applied as a throughput device.  Ranking cost
    drops from whole-graph to per-window; the price is rank myopia
    (a window cannot see successors in later windows — the same horizon
    an online scheduler has).

    ``window <= 0`` or ``window >= len(groups)`` degenerates to a single
    whole-set call with ``graph`` passed through, which is bit-identical
    to the one-shot ``schedule()`` path (the windowing-off discipline
    the test suite pins).
    """
    groups = list(groups)
    for g in groups:
        state.add_group(g)
    if window <= 0 or window >= len(groups):
        return scheduler.place_update(state, groups, graph=graph)
    order = toposort_groups(groups)
    delta: dict[Hashable, int] = {}
    for i in range(0, len(order), window):
        delta.update(scheduler.place_update(
            state, order[i:i + window], graph=None))
    return delta


def hierarchical_schedule(
    graph: Heteroflow,
    bins: Sequence[Any],
    *,
    policy: "Scheduler | str" = "heft",
    target: int = 0,
    window: int = 0,
    max_spread: float = 4.0,
    cost_fn: CostFn = estimate_node_cost,
    initial_load: Mapping[Any, float] | None = None,
    **policy_kwargs: Any,
) -> dict[int, Any]:
    """Million-task placement: grouping → optional :func:`coarsen` →
    :func:`windowed_place` → :meth:`CoarsenPlan.expand` → write-back.

    ``target`` is the approximate super-group count (``0`` = no
    coarsening); ``window`` is the placement window in groups (``0`` =
    whole set at once).  With both knobs off this *is*
    ``get_scheduler(policy).schedule(...)`` — the same code path, so
    placements are bit-identical to the non-hierarchical scheduler (the
    ``coarse_off_bit_identical`` gate).  Returns the paper-shaped
    ``{node.id: bin}`` placement map either way.
    """
    sched = get_scheduler(policy, **policy_kwargs)
    if target <= 0 and window <= 0:
        return sched.schedule(graph, bins, cost_fn,
                              initial_load=initial_load)
    groups = build_groups(graph, cost_fn)
    state = SchedulerState(bins, initial_load=initial_load)
    if target > 0 and len(groups) > 1:
        plan = coarsen(groups, target, max_spread=max_spread,
                       cost_fn=cost_fn)
        windowed_place(sched, state, plan.super_groups, window=window)
        assignment = plan.expand(state.assignment)
    else:
        windowed_place(sched, state, groups, window=window, graph=graph)
        assignment = dict(state.assignment)
    return apply_assignment(graph, groups, bins, assignment)
