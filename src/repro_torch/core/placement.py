"""Device placement — paper Algorithm 1 (union-find + balanced bin packing).

Each kernel task is unioned with its source pull tasks (implicit data
affinity harvested by ``Heteroflow.kernel``); every resulting group is then
packed onto the device bin with minimal load.  The default cost minimizes
load per bin ("balanced load ... for maximal concurrency"); the cost metric
is pluggable exactly as the paper proposes — and since the ``repro_torch.sched``
subsystem landed, the *policy* is pluggable too: ``place()`` below is a
thin wrapper fixing the policy to the paper's balanced bin packing
(``repro_torch.sched.BalancedBins``); alternative strategies (HEFT, round-robin,
random) and a discrete-event simulator to score them live in
``repro_torch.sched`` (see docs/scheduling.md).

The bins are devices; sub-mesh bins exist for the simulator only until
the distributed slice (DESIGN.md §2, scale adaptation).
"""
from __future__ import annotations

from typing import Any, Callable, Hashable, Mapping, Sequence

import numpy as np

from .graph import Heteroflow, Node, TaskType, _span_view, span_nbytes

__all__ = ["UnionFind", "estimate_node_cost", "place"]


class UnionFind:
    """Union-find over arbitrary hashable keys: iterative find with path
    halving, union by size.

    Both operations are fully iterative and amortize to near-constant
    time, so million-id grouping (``build_groups`` at 10⁶ nodes) stays
    near-linear: union-by-size keeps trees logarithmic even before path
    halving flattens them, and nothing recurses — a 10⁶-deep chain of
    unions cannot blow the interpreter stack.
    """

    def __init__(self):
        self._parent: dict[Hashable, Hashable] = {}
        self._size: dict[Hashable, int] = {}

    def find(self, x: Hashable) -> Hashable:
        parent = self._parent
        p = parent.setdefault(x, x)
        if p == x:
            self._size.setdefault(x, 1)
            return x
        # path halving: every visited node re-points to its grandparent
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(self, a: Hashable, b: Hashable) -> Hashable:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self._size[ra] < self._size[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        self._size[ra] += self._size[rb]
        return ra

    def same(self, a: Hashable, b: Hashable) -> bool:
        return self.find(a) == self.find(b)


def _nbytes(source, size=None) -> int:
    try:
        if callable(source):
            return 0  # late-bound; unknown until runtime
        if isinstance(source, dict):
            return span_nbytes(_span_view(source))   # a tree's leaves
        arr = np.asarray(source)
        n = arr.size if size is None else min(arr.size, size)
        return int(n * arr.dtype.itemsize)
    except Exception:
        return 0


def estimate_node_cost(node: Node) -> float:
    """Default cost: resident bytes for pulls, flop estimate for kernels.

    Kernel authors may attach ``node.state['cost']``; otherwise kernels
    count 1.0 (unit load — the paper's balanced-load default degenerates
    to round-robin over group counts, which is what its evaluation uses).
    """
    if node.type == TaskType.PULL:
        return float(_nbytes(node.state.get("source"), node.state.get("size"))) or 1.0
    if node.type == TaskType.KERNEL:
        return float(node.state.get("cost", 1.0))
    return 0.0


def place(
    graph: Heteroflow,
    bins: Sequence[Any],
    cost_fn: Callable[[Node], float] = estimate_node_cost,
    *,
    initial_load: Mapping[Any, float] | None = None,
) -> dict[int, Any]:
    """Paper Algorithm 1: returns ``{node.id: bin}`` for device tasks.

    Back-compat wrapper over the pluggable scheduling subsystem: the
    union-find affinity phase lives in ``repro_torch.sched.base.build_groups``
    and the balanced-load bin packing in
    :class:`repro_torch.sched.policies.BalancedBins` (bit-identical decisions —
    same LPT order, same lowest-index tie-breaking, same pin handling).
    Prefer ``repro_torch.sched.get_scheduler(policy).schedule(...)`` in new
    code; this entry point pins the policy to the paper's.
    """
    from ..sched import BalancedBins  # lazy: sched imports this module

    return BalancedBins().schedule(
        graph, bins, cost_fn, initial_load=initial_load)
