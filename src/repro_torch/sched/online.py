"""Online scheduling drivers: event replay + latency baselines.

Glue between the event-driven scheduler API (:class:`SchedulerUpdate` /
:meth:`Scheduler.update`) and the simulator's arrival mode
(``simulate(..., arrivals=...)``): replay a request trace one arrival
event at a time, score the resulting placement on per-request latency
(TTFT p50/p99), and compare against the static-batching strawman every
serving study needs to beat.

The replay is *honest* online scheduling: each :class:`SchedulerUpdate`
carries only the groups of the request that just arrived, and the
policy never sees the full graph (``graph=None``), so HEFT ranks within
the event and relies on its persistent lane clocks / finish times for
cross-request decisions — exactly the information a live serving engine
has at admission time.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence

from repro_torch.core.graph import Heteroflow
from repro_torch.core.placement import estimate_node_cost

from .base import (Scheduler, SchedulerState, SchedulerUpdate, TaskGroup,
                   apply_assignment, build_groups, get_scheduler)
from .simulator import CostModel, SimReport, simulate, weak_components

__all__ = ["online_placement", "online_report", "percentile",
           "static_batching_latency"]


def percentile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]) — no interpolation, so
    p50/p99 over small deterministic samples are reproducible."""
    if not xs:
        raise ValueError("percentile of empty sequence")
    s = sorted(xs)
    k = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
    return s[k]


def online_placement(
    graph: Heteroflow,
    bins: Sequence[Any],
    policy: "Scheduler | str",
    *,
    cost_fn: Callable = estimate_node_cost,
) -> tuple[dict[int, Any], SchedulerState]:
    """Place ``graph`` by replaying one :class:`SchedulerUpdate` per
    request component through :meth:`Scheduler.update`, in arrival
    (= submission) order.

    Each weakly-connected component of the graph is one request (see
    :func:`~repro_torch.sched.simulator.weak_components`); its affinity groups
    arrive together as one event.  Returns the paper-shaped
    ``{node.id: bin}`` placement plus the final scheduler state (so
    callers can keep feeding events — bins retiring, rebalances).
    """
    sched = get_scheduler(policy)
    groups = build_groups(graph, cost_fn)
    comp_of, n_comp = weak_components(graph)
    by_comp: dict[int, list[TaskGroup]] = {}
    for g in groups:
        by_comp.setdefault(comp_of[g.nodes[0].id], []).append(g)
    state = SchedulerState(bins)
    for c in range(n_comp):
        batch = by_comp.get(c)
        if not batch:
            continue           # component with host tasks only
        sched.update(state, SchedulerUpdate(new_tasks=tuple(batch)))
    return apply_assignment(graph, groups, bins, state.assignment), state


def online_report(
    graph: Heteroflow,
    bins: Sequence[Any],
    policy: "Scheduler | str",
    arrivals: Any,
    *,
    cost_model: CostModel | None = None,
    host_workers: int = 4,
) -> SimReport:
    """Event-driven placement + arrival-mode simulation in one call:
    the latency report (:attr:`SimReport.request_latency`) of ``policy``
    scheduling ``graph``'s requests as they arrive."""
    placement, _ = online_placement(graph, bins, policy)
    return simulate(graph, placement, bins, cost_model=cost_model,
                    host_workers=host_workers, arrivals=arrivals)


def static_batching_latency(
    specs: Sequence[Any],
    arrive_at: Sequence[float],
    builder: Callable[[Sequence[Any]], Heteroflow],
    bins_factory: Callable[[], Sequence[Any]],
    policy: "Scheduler | str",
    *,
    batch_size: int = 8,
    cost_model: CostModel | None = None,
    host_workers: int = 4,
) -> list[dict[str, float]]:
    """Static-batching baseline: requests are collected into fixed
    batches of ``batch_size`` and each batch runs to **completion**
    before the next is admitted (the pre-continuous-batching serving
    model).  Returns per-request latency rows shaped like
    :attr:`SimReport.request_latency`.

    ``builder`` builds a fresh graph for a batch's request specs (each
    spec must form its own weakly-connected component, in spec order);
    ``bins_factory`` yields a fresh bin list per batch so placements
    don't leak across batches.  A batch starts at
    ``max(previous batch finish, last arrival in the batch)`` — the
    head-of-line blocking that static batching pays and continuous
    batching does not.
    """
    sched = get_scheduler(policy)
    rows: list[dict[str, float]] = []
    prev_finish = 0.0
    for at in range(0, len(specs), batch_size):
        batch = specs[at:at + batch_size]
        arrivals = list(arrive_at[at:at + batch_size])
        start = max(prev_finish, max(arrivals))
        graph = builder(batch)
        bins = list(bins_factory())
        placement = sched.schedule(graph, bins)
        rep = simulate(graph, placement, bins, cost_model=cost_model,
                       host_workers=host_workers,
                       arrivals=[0.0] * len(batch))
        if len(rep.request_latency) != len(batch):
            raise ValueError(
                f"batch builder produced {len(rep.request_latency)} "
                f"components for {len(batch)} specs — specs must be "
                f"independent requests")
        for arr, rl in zip(arrivals, rep.request_latency):
            rows.append({
                "arrival": arr,
                "ttft": start + rl["ttft"] - arr,
                "complete": start + rl["complete"] - arr,
            })
        prev_finish = start + rep.makespan
    return rows
