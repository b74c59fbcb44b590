"""Pipeline parallelism as a *scheduled* hetflow workload.

The paper's taxonomy gives pipeline parallelism for free: each
(stage, microbatch) cell is a *kernel* task, inter-stage activation
transfers are dependency edges, and the executor's work-stealing
schedule produces the 1F1B-ish interleaving — no bespoke pipeline
scheduler.  Historically this module went one step further and *owned*
placement: stage weights were routed into every cell as pull-task
arguments purely so Algorithm 1's union-find would anchor each stage to
one bin — a hand-pinning trick that bypassed the ``repro_torch.sched``
subsystem entirely (none of HEFT, the calibrated CostModel, execution
bins, or replay validation applied to pipelines).

Now the pipeline **emits** a scheduled workload instead (the Pipeflow
lesson — pipeline scheduling belongs *inside* the task-graph runtime):

* every cell kernel and stage-weight pull carries ``stage=s`` — the
  affinity phase (``sched.base.build_groups``) unions a stage into ONE
  placement group, so any policy moves stages atomically;
* cells are tagged ``requires={"stage"}`` (default), restricting them
  to :class:`~repro_torch.sched.bins.StageBin` slots — bins wrapping a
  device / host / mesh-slice member and carrying the inter-stage
  *link* bandwidth/latency the simulator and HEFT charge activation
  transfers over (StarPU-style explicit transfer costing, instead of
  assuming pinned adjacency);
* there is **no placement logic here**: balanced/HEFT place whole
  stages with stage-affinity packing, and ``benchmarks/sched_bench.py``
  gates that the scheduled placement never loses to the historical
  hand-pinning (:func:`pinned_placement`, kept only as that baseline).

This runs on CPU bins (tests), on CUDA device bins and on live mesh
slices (``MeshBin.from_mesh``) wrapped in stage bins; a stage's weights
may be a tree (a block's dict of leaves), pulled leaf by leaf.  The
port of ``repro.distributed.pipeline``: the graph, the tags and the
bound are the reference's; the collect sinks copy each result to the
host once the device work that made it has finished.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

from ..core import Heteroflow

__all__ = ["Stage", "build_pipeline_graph", "pinned_placement",
           "pipeline_schedule_length"]


@dataclass
class Stage:
    """One pipeline stage: a callable ``(params, x) -> y``, its params,
    and the relative compute cost of one (stage, microbatch) cell —
    the per-stage asymmetry the scheduler packs against (an embedding
    stage is not a decoder-block stage)."""
    fn: Callable[[Any, Any], Any]
    params: Any
    cost: float = 1.0


def build_pipeline_graph(stages: Sequence[Stage], microbatches: Sequence[Any],
                         collect: list | None = None, *,
                         require_stage_bins: bool = True) -> Heteroflow:
    """Build the (n_stages × n_microbatches) task grid, stage-tagged.

    Dependencies: cell (s, m) needs (s−1, m) [dataflow] and (s, m−1)
    [stage occupancy — one in-flight microbatch per stage, GPipe rule].
    ``collect`` (optional list) receives the last stage's outputs in
    microbatch order.

    Every cell kernel and weight pull carries ``stage=s`` (one
    placement group per stage) and — unless ``require_stage_bins`` is
    False — ``requires={"stage"}``, so placement demands a
    :class:`~repro_torch.sched.bins.StageBin` pool (wrap any device list via
    :func:`repro_torch.sched.bins.stage_bins`).  Pass
    ``require_stage_bins=False`` to schedule onto plain device bins
    (simulator studies over string bins; stage groups stay atomic
    either way).  Placement itself is entirely the scheduler's: no pins.
    """
    G = Heteroflow("pipeline")
    n_stages = len(stages)
    requires = ("stage",) if require_stage_bins else ()

    weight_pulls = [G.pull(stage.params, name=f"weights[{s}]", stage=s)
                    for s, stage in enumerate(stages)]

    grid: list[list] = [[None] * len(microbatches) for _ in range(n_stages)]
    prev_sink = None
    for m, mb in enumerate(microbatches):
        prev_out = G.pull(mb, name=f"mb[{m}]")
        for s, stage in enumerate(stages):
            k = G.kernel(stage.fn, weight_pulls[s], prev_out,
                         cost=stage.cost, stage=s, requires=requires,
                         name=f"f[{s},{m}]")
            k.succeed(weight_pulls[s])
            if s == 0:
                k.succeed(prev_out)          # mb pull → (0, m)
            else:
                prev_out.precede(k)          # dataflow (s−1, m) → (s, m)
            if m > 0:
                grid[s][m - 1].precede(k)    # occupancy (s, m−1) → (s, m)
            grid[s][m] = k
            prev_out = k
        if collect is not None:
            sink = G.host(
                lambda k=grid[n_stages - 1][m]: collect.append(
                    k.host_result()),
                name=f"collect[{m}]")
            grid[n_stages - 1][m].precede(sink)
            # chain the sinks: collect order is *microbatch* order, not
            # work-stealing completion order
            if prev_sink is not None:
                prev_sink.precede(sink)
            prev_sink = sink
    return G


def pinned_placement(graph: Heteroflow, bins: Sequence[Any],
                     ) -> dict[int, Any]:
    """The historical hand-pinned layout: stage ``s`` → ``bins[s % n]``.

    Kept ONLY as the parity baseline the scheduled path is gated
    against (``sched_bench`` asserts HEFT over stage bins never loses
    to this); nothing in the runtime uses it.  Untagged pulls (the
    microbatch feeds) follow the first stage they feed.
    """
    if not bins:
        raise ValueError("no bins to pin stages onto")
    pl: dict[int, Any] = {}
    for n in graph.nodes:
        sid = n.state.get("stage")
        if sid is None:
            succ = [s.state.get("stage") for s in n.successors
                    if s.state.get("stage") is not None]
            if not succ:
                continue                    # host/collect tasks: unplaced
            sid = min(succ)
        pl[n.id] = bins[sid % len(bins)]
    return pl


def pipeline_schedule_length(n_stages: int, n_microbatches: int,
                             stage_costs: Sequence[float] | Mapping[int, float]
                             | None = None) -> float:
    """Lower bound on pipeline makespan in cell-cost units.

    With per-stage cell costs ``c_s`` and the one-microbatch-per-stage
    occupancy rule, the first microbatch must traverse every stage
    (``Σ c_s`` — fill/drain) and the *bottleneck* stage must process
    the remaining ``M − 1`` microbatches serially, so::

        makespan ≥ Σ_s c_s + (M − 1) · max_s c_s

    Unit costs recover the classic GPipe count ``(S − 1) + M``.  The
    simulator can never beat this bound (asserted in
    ``tests/test_pipeline.py``) — transfers and latencies only add.
    """
    if n_stages <= 0 or n_microbatches <= 0:
        return 0.0
    if stage_costs is None:
        costs = [1.0] * n_stages
    elif isinstance(stage_costs, Mapping):
        costs = [float(stage_costs.get(s, 1.0)) for s in range(n_stages)]
    else:
        costs = [float(c) for c in stage_costs]
        if len(costs) != n_stages:
            raise ValueError(
                f"{len(costs)} stage costs for {n_stages} stages")
    return sum(costs) + (n_microbatches - 1) * max(costs)
