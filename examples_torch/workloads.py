"""The paper's two applications as task graphs of the PyTorch port.

* :func:`build_timing_analysis` — paper §IV-A / Fig. 5: N independent
  *view* pipelines, each ``host(extract) → pull(features) →
  kernel(logistic-regression GD) → push(model)``.  Embarrassingly
  parallel across views; stresses placement balance + copy/compute
  overlap.
* :func:`build_detailed_placement` — paper §IV-B / Fig. 8: a flattened
  iterative graph; every iteration chains ``kernel(MIS) →
  host(partition) → kernel(bipartite matching)`` with a dependency into
  the next iteration — irregular and dependent, the workload where the
  paper observes saturation.
* :func:`build_timing_graph` — the paper's *propagation DAG* proper: one
  arrival-time kernel per cell with bounded fan-in from nearby upstream
  cells (netlist locality).  Scales to 10⁵–10⁶ nodes.

Copies of the JAX package's builders (its ``benchmarks/workloads.py``)
over the port's ``Heteroflow``: the same names, signatures, seeds and
draws in the same order, so node names, edges, ``cost`` and ``writes``
are identical.  The kernels are torch functions on the tensors the pulls
put on the device; none of them reads a value back to the host, so a
kernel's work stays on its bin's compute stream, and the collect sinks
read results through ``KernelTask.host_result()``, which waits for the
kernel's ready event.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import Heteroflow

__all__ = ["build_timing_analysis", "build_detailed_placement",
           "build_timing_graph"]


def _logreg_step(x, y, w):
    """One gradient-descent step of logistic regression (view kernel)."""
    p = torch.sigmoid(x @ w)
    grad = x.T @ (p - y) / x.shape[0]
    return w - 0.5 * grad


def build_timing_analysis(n_views: int, n_samples: int = 512,
                          n_features: int = 64, gd_steps: int = 4):
    """Returns (graph, outputs) — one pipeline per timing view."""
    G = Heteroflow("timing_analysis")
    outputs = []
    rng = np.random.default_rng(0)
    for v in range(n_views):
        x = rng.normal(size=(n_samples, n_features)).astype(np.float32)
        y = (rng.random(n_samples) > 0.5).astype(np.float32)
        w_out = np.zeros(n_features, np.float32)

        feats = {"x": None, "y": None}

        def extract(x=x, y=y, feats=feats):
            feats["x"] = x - x.mean(0)          # host-side feature prep
            feats["y"] = y

        h = G.host(extract, name=f"extract{v}")
        px = G.pull(lambda feats=feats: feats["x"], name=f"pull_x{v}")
        py = G.pull(lambda feats=feats: feats["y"], name=f"pull_y{v}")
        pw = G.pull(np.zeros(n_features, np.float32), name=f"pull_w{v}")

        def regress(x, y, w, steps=gd_steps):
            for _ in range(steps):
                w = _logreg_step(x, y, w)
            return w

        k = G.kernel(regress, px, py, pw, writes=(pw,), cost=float(n_samples),
                     name=f"regress{v}")
        out = G.push(pw, w_out, name=f"push{v}")
        h.precede(px, py)
        k.succeed(px, py, pw).precede(out)
        outputs.append(w_out)
    return G, outputs


def _mis_kernel(adj, scores):
    """One Blelloch-style MIS round: keep local maxima."""
    neigh_max = (adj * scores[None, :]).amax(dim=1)
    return (scores > neigh_max).to(torch.float32)


def _matching_kernel(weights, mask):
    """Greedy row-max bipartite matching score (placement objective)."""
    masked = weights * mask[:, None]
    return masked.amax(dim=1).sum()


def build_detailed_placement(n_iters: int, n_cells: int = 256):
    """Flattened iterative placement graph (paper Fig. 8)."""
    G = Heteroflow("detailed_placement")
    rng = np.random.default_rng(1)
    adj = (rng.random((n_cells, n_cells)) < 0.05).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    weights = rng.random((n_cells, n_cells)).astype(np.float32)
    objective = []

    p_adj = G.pull(adj, name="pull_adj")
    p_w = G.pull(weights, name="pull_w")
    prev_tail = None
    for it in range(n_iters):
        scores = rng.random(n_cells).astype(np.float32)
        p_scores = G.pull(scores, name=f"pull_scores[{it}]")
        mis = G.kernel(_mis_kernel, p_adj, p_scores,
                       cost=float(n_cells), name=f"mis[{it}]")
        part = G.host(lambda: None, name=f"partition[{it}]")  # sequential
        match = G.kernel(_matching_kernel, p_w, mis,
                         cost=float(n_cells), name=f"match[{it}]")
        sink = G.host(
            lambda m=match: objective.append(float(m.host_result())),
            name=f"collect[{it}]")
        mis.succeed(p_adj, p_scores).precede(part)
        part.precede(match)
        match.succeed(p_w).precede(sink)
        if prev_tail is not None:
            prev_tail.precede(mis)        # iteration dependency
        prev_tail = sink
    return G, objective


def build_timing_graph(n_cells: int, fanout: int = 4, *,
                       nbytes: int = 256, window: int | None = None,
                       seed: int = 0):
    """Static-timing propagation DAG (paper §IV-A at netlist scale).

    One *cell* = one pull (its delay table) + one arrival-time kernel;
    cell ``i`` consumes the arrival times of up to ``fanout`` upstream
    cells drawn from a locality ``window`` of recent indices — the
    bounded-fan-in, mostly-local wiring of a real netlist.  Each kernel
    returns ``max(upstream arrivals) + own delay`` as an f64 scalar on
    the device: the max of the upstream tensors plus ``delay * own[0]``
    (``own`` is all ones, so the product is the delay itself and every
    arrival equals the plain longest path bit for bit).  No arrival is
    read back inside the graph.

    All randomness is drawn vectorized up front from one seeded
    generator, so two calls with equal arguments yield identical graphs.
    Every kernel reads the *same* operand array, so graph memory stays
    O(1) in ``n_cells`` while each cell still owns a distinct pull node
    (one affinity group per cell, Algorithm 1).

    Returns the graph alone — sinks are the last-layer kernels; callers
    that execute it read results off the kernel tasks.
    """
    if n_cells < 1:
        raise ValueError("n_cells must be >= 1")
    if fanout < 0:
        raise ValueError("fanout must be >= 0")
    W = max(1, 16 * max(fanout, 1)) if window is None else max(1, window)
    rng = np.random.default_rng(seed)
    # vectorized draws: per-cell delay, per-cell fan-in count, and the
    # back-offsets into the locality window
    delays = (1.0 + 4.0 * rng.random(n_cells)).astype(np.float64)
    n_in = rng.integers(1, fanout + 1, size=n_cells) if fanout else None
    offs = ((rng.random((n_cells, max(fanout, 1))) * W).astype(np.int64) + 1
            if fanout else None)
    operand = np.full(max(1, nbytes // 8), 1.0, np.float64)

    G = Heteroflow("timing_graph")
    kernels: list = []
    for i in range(n_cells):
        p = G.pull(operand, name=f"pin{i}")
        deps = []
        if fanout and i > 0:
            seen = set()
            for j in range(n_in[i]):
                s = i - int(offs[i, j])
                if s >= 0 and s not in seen:
                    seen.add(s)
                    deps.append(kernels[s])

        def arrival(own, *ups, d=float(delays[i])):
            if not ups:
                return own[0] * d
            base = ups[0]
            for u in ups[1:]:
                base = torch.maximum(base, u)
            return torch.add(base, own[0], alpha=d)

        k = G.kernel(arrival, p, *deps, cost=float(delays[i]),
                     name=f"cell{i}")
        k.succeed(p, *deps)
        kernels.append(k)
    return G
