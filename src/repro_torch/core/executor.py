"""Work-stealing executor for heterogeneous task graphs (paper §III-B/C).

Mirrors the paper's design decisions:

* **No dedicated worker per device** — all task types are uniform
  callables, any worker may invoke any task (paper §III-C ¶1).
* **Topology** per submitted graph marshals execution parameters, repeat
  predicate, and a promise/future pair (paper §III-C ¶2).
* **Device placement first** — Algorithm 1 (``core.placement``) maps each
  kernel∪pull group onto a device bin before execution starts.
* **Work-stealing loop** — each worker drains its local deque then turns
  *thief*, stealing from a random victim; an **adaptive strategy keeps one
  thief alive while any worker is active** (paper §III-C last ¶), putting
  the rest to sleep to avoid burning host cycles.
* **Per-device lanes + arenas** — the per-worker CUDA stream and buddy
  memory pool of the paper map to ``core.streams`` lanes (a copy stream
  and a compute stream per CUDA bin) and ``core.memory`` arenas
  (DESIGN.md §2).  A pull copies through a pinned host tensor on its
  bin's copy stream and records an event; the kernels that read it wait
  on that event on their compute stream (``cudaStreamWaitEvent``); a
  push or a spill copies back after the producer's event.

Functional adaptation of in-place GPU writes: a kernel task declares
``writes=(pull_a, ...)``; its return value rebinds those pull tasks'
device buffers, so a downstream ``push`` observes the update — the
paper's mutate-through-pointer semantics, made explicit.

Stream ordering at the boundary: at submission (``run_until``) the live
bins' streams wait on the submitting thread's current stream, so
weights and caches made before the run are ready for its first task;
when a topology retires, each CUDA device's default stream waits on the
lanes, so the caller reads finished results after ``future.result()``.
"""
from __future__ import annotations

import itertools
import random
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .graph import (Heteroflow, KernelTask, Node, PullTask, TaskType,
                    _span_view, map_tree, span_nbytes)
from .memory import DeviceArena, OutOfMemory
from .placement import estimate_node_cost
from .streams import (LaneRegistry, ScopedDeviceContext, bin_labels,
                      dedup_labels, execution_target, is_dtensor, lane_kind,
                      live_mesh, torch_device)

__all__ = ["Executor", "Topology"]


class Topology:
    """Runtime state for one submitted graph (paper §III-C)."""

    _ids = itertools.count()

    def __init__(self, graph: Heteroflow, predicate: Callable[[], bool]):
        self.id = next(Topology._ids)
        self.graph = graph
        # predicate returns True when the graph should STOP repeating
        self.predicate = predicate
        self.future: Future = Future()
        self.iteration = 0
        self._remaining = 0
        self._lock = threading.Lock()
        # node ids whose _invoke completed this iteration — the ground
        # truth bin-failure recovery computes the lost frontier from
        self._executed: set[int] = set()
        self.failed: BaseException | None = None

    def _arm(self) -> list[Node]:
        """Reset join counters; return the source nodes of this iteration."""
        sources = []
        for n in self.graph.nodes:
            n.join_counter = n.num_dependents
            n.topology = self
            if n.num_dependents == 0:
                sources.append(n)
        with self._lock:
            self._remaining = len(self.graph.nodes)
            self._executed.clear()
        return sources

    def _node_done(self) -> bool:
        """Returns True when the iteration completed."""
        with self._lock:
            self._remaining -= 1
            return self._remaining == 0


class _Worker:
    __slots__ = ("id", "deque", "lock", "rng", "thread", "steals", "executed",
                 "last_beat", "last_bin", "steal_local", "steal_cross",
                 "bin_busy")

    def __init__(self, wid: int):
        self.id = wid
        self.deque: deque[Node] = deque()
        self.lock = threading.Lock()
        self.rng = random.Random(0xC0FFEE ^ wid)
        self.thread: threading.Thread | None = None
        self.steals = 0
        self.executed = 0
        self.last_beat = time.monotonic()
        self.last_bin: str | None = None   # bin label of last device task run
        self.steal_local = 0               # stolen device task on last_bin
        self.steal_cross = 0               # stolen device task on another bin
        # cumulative busy seconds per bin label; the Executor pre-creates
        # every label key so the key set never changes — this worker's
        # thread updates values lock-free, readers iterate safely
        self.bin_busy: dict[str, float] = {}


#: task types fused batch dispatch may coalesce — device-bin work whose
#: per-task dispatch overhead (deque round trip, span, device scope)
#: dominates at tiny task sizes.  Host tasks stay unfused: they have no
#: bin identity and their callbacks routinely block.
_FUSABLE = frozenset((TaskType.KERNEL, TaskType.PULL, TaskType.PUSH))


class _FusedBatch:
    """A run of simultaneously-ready same-bin same-type tasks dispatched
    as ONE unit (``Executor(fuse_batch=N)``).

    Ducks the ``Node`` surface the dispatch path touches (``type`` /
    ``bin_key`` / ``device`` / ``topology`` / ``id`` / ``name`` /
    ``state``), so deques, stealing, and locality heuristics handle it
    unchanged.  Members were all ready when the batch formed — mutually
    independent by definition — so running them back-to-back inside one
    device scope cannot change any result, only shave per-task overhead.
    """

    __slots__ = ("nodes", "type", "bin_key", "device", "topology", "id",
                 "name", "state")

    def __init__(self, nodes: Sequence[Node]):
        head = nodes[0]
        self.nodes = list(nodes)
        self.type = head.type
        self.bin_key = head.bin_key
        self.device = head.device
        self.topology = head.topology
        self.id = head.id
        self.name = f"fused[{len(self.nodes)}]:{head.name}"
        self.state = {"stage": head.state.get("stage")}


def _tensor_leaves(value: Any) -> list:
    """Tensors in a kernel result or pull buffer, walking tuples, lists
    and dicts (a DTensor: its local tensor)."""
    if is_dtensor(value):
        return [value.to_local()]
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensor_leaves(v)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _tensor_leaves(v)]
    return []


def _head_bin(v: _Worker) -> str | None:
    """Bin label of the node a thief would steal from ``v`` (deque head).

    Lock-free peek: a stale or torn read only degrades the locality
    *heuristic* — the actual steal below re-checks under the lock.
    """
    try:
        return v.deque[0].bin_key
    except IndexError:
        return None


def _host_tensor(x: Any) -> torch.Tensor:
    """A host leaf (array or CPU tensor) as a CPU tensor, no copy."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _pinned(x: Any) -> torch.Tensor:
    """A pinned host copy of a host leaf, the source of a non-blocking
    H2D copy."""
    if isinstance(x, torch.Tensor):
        pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        pinned.copy_(x)
        return pinned
    src = np.ascontiguousarray(x)
    dtype = torch.from_numpy(np.empty(0, src.dtype)).dtype
    pinned = torch.empty(src.shape, dtype=dtype, pin_memory=True)
    np.copyto(pinned.numpy(), src)
    return pinned


def _numpy_or_tensor(t: torch.Tensor) -> Any:
    """A host copy as numpy, or as a CPU tensor where numpy has no such
    dtype (bf16)."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _local_block(x: Any, mesh: Any, places: tuple) -> torch.Tensor:
    """This rank's block of host leaf ``x`` under DTensor ``places`` on
    ``mesh``: ``torch.chunk`` of each sharded dim (DTensor's ``Shard``
    split) at this rank's coordinate, the whole dim elsewhere."""
    t = _host_tensor(x)
    for mdim, p in enumerate(places):
        if p.is_shard():
            parts = torch.chunk(t, mesh.size(mdim), dim=p.dim)
            c = mesh.get_local_rank(mdim)
            t = parts[c] if c < len(parts) else t.narrow(p.dim, 0, 0)
    return t


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _zip_tree(a: Any, b: Any) -> Any:
    """Two trees of one structure as one tree of ``(a_leaf, b_leaf)``."""
    if isinstance(a, dict):
        return {k: _zip_tree(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_zip_tree(x, y) for x, y in zip(a, b)]
    return (a, b)


def _onto_bin(value: Any, device: Any) -> Any:
    """``value`` (a kernel result, or tuples/lists/dicts of them) as a
    kernel on bin ``device`` reads it: on a live mesh slice every tensor
    is a DTensor of that mesh (a plain tensor, whole on this rank,
    becomes a replicated one on the slice's device), elsewhere a DTensor
    is gathered whole."""
    if isinstance(value, (tuple, list)):
        return type(value)(_onto_bin(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _onto_bin(v, device) for k, v in value.items()}
    if not isinstance(value, torch.Tensor):
        return value
    mesh = live_mesh(device)
    if is_dtensor(value):
        if mesh is not None and value.device_mesh is mesh:
            return value
        value = value.full_tensor()
    if mesh is None:
        return value
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(value.to(torch_device(device)), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


class Executor:
    """``hf::Executor`` — manages N CPU workers and M device bins.

    Parameters
    ----------
    num_workers: CPU worker threads (default: cpu count).
    devices: execution bins for Algorithm-1 placement — ``torch.device``s
        or ``repro_torch.sched.bins`` execution bins (``DeviceBin`` /
        ``HostBin`` / synthetic ``MeshBin`` slices / ``StageBin``
        pipeline-stage slots, which dispatch onto their member bin;
        default: every CUDA device — with no CUDA device the caller must
        pass its bins, e.g. ``[torch.device("cpu")]``).  Capability-tagged
        kernels (``requires={"mesh"}``) are only placed on bins whose
        capabilities satisfy the tags.  Stage-tagged kernels
        (``stage=s``) form one placement group per stage, so
        re-placement windows (``replace_every`` / ``migrate_top_k``)
        move whole stages atomically — never individual cells.
    arena_bytes: if set, a buddy :class:`DeviceArena` of this capacity is
        created per device bin (paper's per-GPU memory pool).
    scheduler: placement policy — a ``repro_torch.sched.Scheduler`` instance or
        a registry name (``"balanced"`` — the paper's Algorithm 1 and the
        default — ``"heft"``, ``"round_robin"``, ``"random"``).  Policies
        decide locality only; graph semantics are identical under any.
    profiler: optional ``repro_torch.sched.TaskProfiler``; every executed node
        is reported with wall-clock timestamps, bin label, and bytes
        moved, building the JSON trace ``CostModel.fit`` calibrates from.
    obs: optional ``repro_torch.obs.SpanRecorder`` flight recorder.  When set,
        every executed node opens a span with bin/lane/node/stage
        attribution, and the runtime's notable transitions — steals,
        arena spills/refills, bin join/retire/fail/slowdown, straggler
        demotions, re-placement windows, chaos triggers — land as
        instant events in the recorder's bounded ring.  When a topology
        fails, the ring is dumped to the recorder's ``dump_path`` (when
        one is configured) as a Perfetto-loadable trace.  ``None``
        (default) records nothing and adds no overhead.  Independent of
        the recorder, scalar runtime counters live in :attr:`metrics`
        (a ``repro_torch.obs.MetricsRegistry``); :meth:`stats` is a
        back-compat view over it.
    steal_locality: when True (default), thieves try victims whose deque
        head is placed on the same bin as the thief's last-executed
        device task before falling back to random victims — stolen work
        stays near warm device state, cutting the cross-bin traffic the
        simulator charges for.  Steal hit/miss counters are surfaced via
        :meth:`stats` under either setting.
    replace_every: if > 0, ``run_until``/``run_n`` re-invoke the
        scheduler every N completed iterations, feeding measured per-bin
        busy seconds back through the policy's ``initial_load`` hook
        (dynamic re-placement — the profile-guided loop, online).
    migrate_top_k: if > 0, re-placement windows migrate at most this
        many hottest task groups off overloaded bins instead of fully
        repacking — near-equal loads then keep the placement untouched
        (no churn), trading global optimality for warm device state.
    chaos: optional ``repro_torch.sched.ChaosPlan``; its task-count triggers
        fire :meth:`fail_bin` / :meth:`slow_bin` as tasks complete —
        deterministic fault injection for the chaos test net.
    straggler_threshold: if > 0, online straggler detection is on: a
        per-bin EWMA of observed-vs-predicted kernel duration
        (``repro_torch.sched.StragglerDetector``) flags bins slower than
        ``threshold``× the healthiest; at the next iteration boundary
        the live ``CostModel`` of a model-carrying policy (HEFT) is
        demoted to the observed speed and a re-placement window runs
        (the ``migrate_top_k`` path when configured).
    straggler_alpha: EWMA smoothing factor for the detector.
    fuse_batch: if >= 2, fused batch dispatch is on: when a finished
        task readies a run of same-bin, same-type, same-stage successors,
        up to this many of them are coalesced into ONE dispatch unit —
        a single deque round trip, one observability span, one device
        scope entry, one profiler record (first member's identity,
        summed cost) — and their results fan back out individually.
        Members of a batch are simultaneously ready, hence mutually
        independent: outputs are bit-identical to unfused execution.
        This kills the per-task Python/lock/span overhead that dominates
        at million-task scale (the paper's tiny VLSI timing tasks).  The
        default ``0`` leaves every dispatch path byte-for-byte untouched.
        Caveats in docs/scheduling.md "Million-task scale".
    """

    def __init__(
        self,
        num_workers: int | None = None,
        devices: Sequence[Any] | None = None,
        *,
        arena_bytes: int | None = None,
        cost_fn: Callable[[Node], float] = estimate_node_cost,
        scheduler: Any = "balanced",
        profiler: Any = None,
        obs: Any = None,
        steal_locality: bool = True,
        replace_every: int = 0,
        migrate_top_k: int = 0,
        chaos: Any = None,
        straggler_threshold: float = 0.0,
        straggler_alpha: float = 0.4,
        fuse_batch: int = 0,
    ):
        from ..sched import get_scheduler  # lazy: sched imports core
        if num_workers is None:
            import os
            num_workers = os.cpu_count() or 1
        if num_workers < 1:
            raise ValueError("need at least one worker")
        if replace_every < 0:
            raise ValueError("replace_every must be >= 0")
        if migrate_top_k < 0:
            raise ValueError("migrate_top_k must be >= 0")
        if fuse_batch < 0:
            raise ValueError("fuse_batch must be >= 0")
        self._fuse_batch = fuse_batch
        self._migrate_top_k = migrate_top_k
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if not devices:
                raise ValueError(
                    "no CUDA device found; pass the bins explicitly, "
                    "e.g. devices=[torch.device('cpu')]")
        self.devices = list(devices)
        if not self.devices:
            raise ValueError("need at least one device bin")
        self.device_labels = bin_labels(self.devices)
        from ..obs import MetricsRegistry  # lazy: obs imports core
        self._cost_fn = cost_fn
        self.scheduler = get_scheduler(scheduler)
        self._profiler = profiler
        self._obs = obs
        #: scalar runtime counters publish here; stats() is a view over
        #: it and external scrapers can read metrics.snapshot() directly
        self.metrics = MetricsRegistry()
        self._steal_locality = steal_locality
        self._replace_every = replace_every
        self._replacements = self.metrics.counter("replacements")
        # re-placement measures load per window as a delta against this
        # snapshot of the workers' cumulative per-bin busy counters
        self._busy_snapshot: dict[str, float] = {}
        self._busy_lock = threading.Lock()
        self.lanes = LaneRegistry()
        # per-bin buddy arenas: a bin with a memory_bytes budget gets an
        # arena capped at the largest power of two NOT exceeding the
        # budget (buddy capacity must be pow2; rounding up would bust
        # the budget), even without a global arena_bytes.  Unbudgeted
        # bins keep the legacy arena_bytes-or-nothing rule.
        self.arenas = {}
        self._arena_bytes = arena_bytes   # reused when bins join later
        for d in self.devices:
            cap = self._arena_capacity(d, arena_bytes)
            if cap:
                self.arenas[id(d)] = DeviceArena(
                    d, cap, min_block=min(4096, cap))
        # spill-to-host state: per-arena LRU of resident pull nodes
        # (insertion/touch order = coldest first), spill/refill counters
        self._resident: dict[int, OrderedDict[int, Node]] = {}
        self._mem_lock = threading.Lock()
        self._spills = self.metrics.counter("spills")
        self._refills = self.metrics.counter("refills")
        self._spilled_bytes = self.metrics.counter("spilled_bytes")
        self._refilled_bytes = self.metrics.counter("refilled_bytes")

        # bin-event stream state (fail / retire / slowdown / join):
        # dead slots stay in self.devices so indices and labels remain
        # stable, but every placement path skips them
        self._dead_bins: set[int] = set()
        self._recovery_lock = threading.RLock()
        self._slowdown: dict[str, float] = {}
        self._bin_failures = self.metrics.counter("bin_failures")
        self._bin_retirements = self.metrics.counter("bin_retirements")
        self._reexecuted = self.metrics.counter("reexecuted")
        self._straggler_demotions = self.metrics.counter(
            "straggler_demotions")
        # chaos fault injection (sched.chaos.ChaosPlan): one runner per
        # executor — its task-count triggers fire exactly once, as
        # ``chaos_trigger`` instants in the flight recorder when one is
        # attached
        self._chaos = chaos
        self._chaos_runner = (chaos.runner(obs=obs)
                              if chaos is not None else None)
        self._chaos_counter = itertools.count(1)
        # online straggler detection: EWMA of observed-vs-predicted
        # kernel duration per bin (sched.chaos.StragglerDetector);
        # 0 = off.  Predictions use a reference CostModel at uniform
        # speed — the detector judges bins relatively, so a uniform
        # scale error cancels out.
        self._straggler = None
        self._straggler_model = None
        if straggler_threshold:
            from ..sched.chaos import StragglerDetector
            from ..sched.simulator import CostModel
            self._straggler = StragglerDetector(
                alpha=straggler_alpha, threshold=straggler_threshold)
            self._straggler_model = CostModel(cost_fn=cost_fn)

        self._workers = [_Worker(i) for i in range(num_workers)]
        for w in self._workers:
            # fixed key set (placement only ever yields these labels):
            # lock-free value updates stay safe to iterate concurrently
            w.bin_busy = {label: 0.0 for label in self.device_labels}
        self._submit_q: deque[Node] = deque()
        self._submit_lock = threading.Lock()

        # notifier state (adaptive thief strategy)
        self._cv = threading.Condition()
        self._actives = 0
        self._thieves = 0
        self._stop = False

        self._topologies: dict[int, Topology] = {}
        self._topo_cv = threading.Condition()

        self._local = threading.local()
        for w in self._workers:
            t = threading.Thread(target=self._worker_loop, args=(w,),
                                 name=f"hetflow-worker-{w.id}", daemon=True)
            w.thread = t
            t.start()

    @staticmethod
    def _arena_capacity(d: Any, arena_bytes: int | None) -> int | None:
        """Arena capacity for bin ``d``: its ``memory_bytes`` budget
        floored to a power of two (so ``bytes_in_use`` can never exceed
        the budget), further capped by ``arena_bytes`` when both are
        given; plain ``arena_bytes`` when the bin is unbudgeted."""
        budget = getattr(d, "memory_bytes", None)
        if budget is None:
            return arena_bytes
        cap = 1 << (int(budget).bit_length() - 1)
        if arena_bytes:
            cap = min(cap, arena_bytes)
        return cap

    # ------------------------------------------------------------------
    # public API (paper §III-B)
    # ------------------------------------------------------------------
    @property
    def num_workers(self) -> int:
        return len(self._workers)

    def run(self, graph: Heteroflow) -> Future:
        """Run the graph once; non-blocking, returns a future."""
        return self.run_n(graph, 1)

    def run_n(self, graph: Heteroflow, n: int) -> Future:
        """Run the graph ``n`` times (sequentially, stateful between runs)."""
        if n <= 0:
            f: Future = Future()
            f.set_result(0)
            return f
        counter = itertools.count(1)
        return self.run_until(graph, lambda: next(counter) >= n)

    def run_until(self, graph: Heteroflow, predicate: Callable[[], bool]) -> Future:
        """Repeat the graph until ``predicate()`` is True (checked after
        every full iteration).  Thread-safe; non-blocking."""
        order = graph.topological_order()
        if order is None:
            raise ValueError(f"graph '{graph.name}' contains a cycle")
        topo = Topology(graph, predicate)
        if graph.empty():
            topo.future.set_result(0)
            return topo.future
        # device placement before execution (Algorithm 1 by default; any
        # repro_torch.sched policy via the ``scheduler`` constructor knob) —
        # over the LIVE bins only: failed/retired slots take no new work
        live = self._live_devices()
        if not live:
            raise ValueError("no live device bins left to place onto")
        initial = {d: a.bytes_in_use for d, a in
                   ((dd, self.arenas.get(id(dd))) for dd in live) if a}
        self.scheduler.schedule(graph, live, self._cost_fn,
                                initial_load=initial or None)
        for d in live:
            dev = torch_device(d)
            if dev is not None and dev.type == "cuda":
                self.lanes.lane(d).wait_for(torch.cuda.current_stream(dev))
        if self._replace_every:
            # re-placement windows start NOW — don't let a previous run's
            # busy history leak into this topology's first window
            with self._busy_lock:
                self._busy_snapshot = self._merged_bin_busy()
        with self._topo_cv:
            self._topologies[topo.id] = topo
        sources = topo._arm()
        self._bulk_enqueue(sources)
        return topo.future

    def wait_for_all(self) -> None:
        """Block until all running graphs finish (paper §III-B)."""
        with self._topo_cv:
            self._topo_cv.wait_for(lambda: not self._topologies)

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for w in self._workers:
            if w.thread is not None:
                w.thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- introspection ---------------------------------------------------
    def _merged_bin_busy(self) -> dict[str, float]:
        """Cumulative busy seconds per bin label, summed over workers.
        Safe without locks: every worker dict holds the same fixed key
        set (created up front), so concurrent value updates never change
        the dict size mid-iteration."""
        busy: dict[str, float] = {label: 0.0 for label in self.device_labels}
        for w in self._workers:
            for label, secs in w.bin_busy.items():
                busy[label] += secs
        return busy

    def _lane_views(self) -> list[tuple[str, Any]]:
        """(stable key, lane) pairs.

        Lanes created for this executor's bins are labeled with the
        bins-order ``device_labels`` slot — NOT lane-creation order,
        which is thread-timing-dependent — so the same string denotes
        the same bin slot in ``stats()``, in trace ``meta.bins``, and
        across runs.  Distinct bin objects sharing a physical device key
        thus get distinct ``#slot`` suffixes instead of collapsing into
        one dict entry; any lane for a device outside the bin list falls
        back to its raw device key (deduped positionally).
        """
        label_of: dict[int, str] = {}
        for d, label in zip(self.devices, self.device_labels):
            label_of.setdefault(id(d), label)  # first slot claims dup objects
        views: list[tuple[str, Any]] = []
        foreign = []
        for lane in self.lanes.lanes():
            label = label_of.get(id(lane.device))
            if label is not None:
                views.append((label, lane))
            else:
                foreign.append(lane)
        views.sort(key=lambda kv: kv[0])       # bins order, not creation order
        keys = dedup_labels([lane.key for lane in foreign])
        views.extend(zip(keys, foreign))
        return views

    def stats(self) -> dict[str, Any]:
        """Back-compat view over :attr:`metrics`.

        Scalar counts read registry counters; the per-worker
        steal/executed tallies (kept lock-free on the workers) are
        published into registry gauges here, so an external scraper
        reading ``executor.metrics.snapshot()`` sees the same numbers
        this dict reports.  Dict-valued entries (``bin_busy_s``,
        ``arena_peak_bytes``, ``lane_depths``) stay computed views.
        """
        m = self.metrics
        m.gauge("workers").set(self.num_workers)
        m.gauge("devices").set(len(self.devices))
        m.gauge("steals").set(sum(w.steals for w in self._workers))
        m.gauge("steal_local").set(
            sum(w.steal_local for w in self._workers))
        m.gauge("steal_cross").set(
            sum(w.steal_cross for w in self._workers))
        m.gauge("executed").set(sum(w.executed for w in self._workers))
        return {
            "workers": m.gauge("workers").value,
            "devices": m.gauge("devices").value,
            "policy": self.scheduler.name,
            "steals": m.gauge("steals").value,
            "steal_local": m.gauge("steal_local").value,
            "steal_cross": m.gauge("steal_cross").value,
            "steal_locality": self._steal_locality,
            "executed": m.gauge("executed").value,
            "replacements": self._replacements.value,
            # bin-event stream (fail / retire / slowdown / straggler)
            "bin_failures": self._bin_failures.value,
            "bin_retirements": self._bin_retirements.value,
            "reexecuted": self._reexecuted.value,
            "straggler_demotions": self._straggler_demotions.value,
            "dead_bins": sorted(self.device_labels[i]
                                for i in self._dead_bins),
            "bin_busy_s": self._merged_bin_busy(),
            # arena memory pressure (spill-to-host path): eviction /
            # refill round trips and per-bin high-water bytes — peaks
            # can never exceed a budgeted bin's memory_bytes (the arena
            # is capacity-capped below the budget)
            "spills": self._spills.value,
            "refills": self._refills.value,
            "spilled_bytes": self._spilled_bytes.value,
            "refilled_bytes": self._refilled_bytes.value,
            "arena_peak_bytes": {
                label: self.arenas[id(d)].peak_bytes
                for d, label in zip(self.devices, self.device_labels)
                if id(d) in self.arenas},
            # keyed by the run-stable bin label, not enumeration order —
            # profiler traces correlate lane state across runs by this id
            "lane_depths": {key: lane.depth()
                            for key, lane in self._lane_views()},
        }

    def stragglers(self, threshold_s: float = 5.0) -> list[int]:
        """Workers that have not heartbeat within ``threshold_s`` while the
        executor has pending work — straggler-mitigation signal consumed by
        the training launcher (DESIGN.md §6)."""
        now = time.monotonic()
        with self._cv:
            busy = self._actives > 0
        if not busy:
            return []
        return [w.id for w in self._workers if now - w.last_beat > threshold_s]

    # ------------------------------------------------------------------
    # bin-event stream: join / retire / fail / slowdown
    # ------------------------------------------------------------------
    def _live_devices(self) -> list[Any]:
        return [d for i, d in enumerate(self.devices)
                if i not in self._dead_bins]

    def _bin_slot(self, b: Any) -> int:
        """Resolve a bin reference — slot index, device object (by
        identity), or ``device_labels`` entry — to its slot index."""
        if isinstance(b, int):
            if not 0 <= b < len(self.devices):
                raise ValueError(
                    f"bin index {b} out of range 0..{len(self.devices) - 1}")
            return b
        for i, d in enumerate(self.devices):
            if d is b:
                return i
        if b in self.device_labels:
            return self.device_labels.index(b)
        for i, d in enumerate(self.devices):
            if d == b:
                return i
        raise ValueError(f"unknown bin {b!r}")

    def _check_not_last(self, idx: int, verb: str) -> str:
        label = self.device_labels[idx]
        if idx in self._dead_bins:
            raise ValueError(f"bin {label!r} is already dead/retired")
        if len(self.devices) - len(self._dead_bins) <= 1:
            raise ValueError(
                f"cannot {verb} bin {label!r}: it is the last live bin — "
                f"no survivor to take its work")
        return label

    def join_bin(self, b: Any) -> int:
        """Append a new execution bin to the pool; returns its slot.

        Takes effect at the next placement decision — a new run, a
        re-placement window, or the displaced-group re-placement of a
        later fail/retire.  Work already placed does not move eagerly.
        """
        with self._recovery_lock:
            self.devices.append(b)
            self.device_labels = bin_labels(self.devices)
            cap = self._arena_capacity(b, self._arena_bytes)
            if cap:
                self.arenas[id(b)] = DeviceArena(
                    b, cap, min_block=min(4096, cap))
            for w in self._workers:
                # atomic dict swap: _merged_bin_busy iterates concurrently
                w.bin_busy = {label: w.bin_busy.get(label, 0.0)
                              for label in self.device_labels}
            if self._obs is not None:
                self._obs.event("join_bin", bin=self.device_labels[-1])
            return len(self.devices) - 1

    def slow_bin(self, b: Any, factor: float) -> None:
        """Inject a slowdown: future tasks on bin ``b`` take ``factor``×
        as long (sleep padding in ``_invoke``; compounds on repeat).
        The straggler detector observes the padded durations, so the
        EWMA-demotion loop is exercisable deterministically."""
        if factor <= 0:
            raise ValueError(f"slowdown factor must be > 0, got {factor!r}")
        with self._recovery_lock:
            idx = self._bin_slot(b)
            label = self.device_labels[idx]
            if idx in self._dead_bins:
                raise ValueError(f"bin {label!r} is dead/retired")
            self._slowdown[label] = self._slowdown.get(label, 1.0) * factor
            if self._obs is not None:
                self._obs.event("slow_bin", bin=label, factor=factor)

    def retire_bin(self, b: Any) -> None:
        """Gracefully retire bin ``b``: drain and migrate.

        Unfinished groups placed there are re-placed through
        ``Scheduler.update(retired_bins=...)``; already-produced pull
        buffers resident on the bin are demoted to a host copy and
        marked spilled, so the next consumer refills them onto the new
        bin — the spill-to-host machinery doubles as the migration
        path.  Results stay readable throughout (a graceful retire
        loses no data).  Retiring the last live bin raises ValueError.
        """
        with self._recovery_lock:
            idx = self._bin_slot(b)
            label = self._check_not_last(idx, "retire")
            with self._topo_cv:
                topos = list(self._topologies.values())
            for topo in topos:
                old_device = self._retire_placement(topo, idx)
                with topo._lock:
                    executed = set(topo._executed)
                for n in topo.graph.nodes:
                    if (n.id not in executed or n.type != TaskType.PULL
                            or n.device is old_device[n.id]):
                        continue
                    buf = n.state.get("device_data")
                    if buf is None:
                        continue
                    if not isinstance(buf, np.ndarray):
                        n.state["device_data"] = self._to_host(n, buf)
                    n.state["spilled"] = True
            self._dead_bins.add(idx)
            self._slowdown.pop(label, None)
            self._bin_retirements.inc()
            if self._obs is not None:
                self._obs.event("retire_bin", bin=label)

    def fail_bin(self, b: Any) -> None:
        """Simulate the abrupt death of bin ``b`` and recover.

        The bin is marked dead, results produced there that an
        unexecuted task still needs are invalidated (the *lost
        frontier*, closed upward over dead-bin producer chains), and the
        lost tasks are re-enqueued after re-placement through
        ``Scheduler.update(retired_bins=...)``.

        Recovery keeps stale outputs while the frontier re-executes:
        tasks are pure, so a consumer racing ahead on the stale value
        reads bits identical to the re-executed one.  Unlike the
        simulator's true-abort model, in-flight tasks on the dead bin
        finish anyway (a thread cannot be aborted) and count as
        survivors.  Killing the last live bin raises ValueError here,
        before any policy runs.
        """
        with self._recovery_lock:
            idx = self._bin_slot(b)
            label = self._check_not_last(idx, "fail")
            with self._topo_cv:
                topos = list(self._topologies.values())
            for topo in topos:
                self._recover(topo, idx)
            self._dead_bins.add(idx)
            self._slowdown.pop(label, None)
            self._bin_failures.inc()
            if self._obs is not None:
                self._obs.event("fail_bin", bin=label)

    def _retire_placement(self, topo: Topology, idx: int) -> dict[int, Any]:
        """Re-place every group resident on bin ``idx`` through the
        event-driven ``Scheduler.update(retired_bins=...)`` path;
        returns the pre-move ``{node.id: device}`` map.

        Every dead-bin group is displaced — including fully-executed
        ones whose results are fully consumed — so repeating topologies
        never re-arm onto a dead bin."""
        from repro_torch.sched.base import (SchedulerState, SchedulerUpdate,
                                      apply_assignment, build_groups)
        graph = topo.graph
        groups = build_groups(graph, self._cost_fn)
        slot = {id(d): i for i, d in enumerate(self.devices)}
        state = SchedulerState(self.devices)
        for i in self._dead_bins:
            state.live.discard(i)
        for g in groups:
            state.add_group(g)
            gi = slot.get(id(g.nodes[0].device))
            state.record(g, gi if gi is not None else idx)
        old_device = {n.id: n.device for n in graph.nodes}
        self.scheduler.update(state, SchedulerUpdate(retired_bins=(idx,)),
                              graph=graph)
        apply_assignment(graph, groups, self.devices, state.assignment)
        self._free_moved_blocks(graph, old_device)
        return old_device

    def _recover(self, topo: Topology, idx: int) -> None:
        """Lost-frontier recovery for one topology after bin ``idx``
        fails: find executed dead-bin kernels/pulls whose result an
        unexecuted task still needs (fixpoint — a lost result makes its
        dead-bin producers lost too), re-place, then re-enqueue."""
        graph = topo.graph
        slot = {id(d): i for i, d in enumerate(self.devices)}
        with topo._lock:
            executed = set(topo._executed)
        # only IDEMPOTENT tasks may re-execute: a kernel with declared
        # ``writes`` has already rebound its pulls (re-running it would
        # read its own output), and re-pulling a written pull would
        # clobber the write with the raw source.  In the simulated-kill
        # model their buffers survive physically, so keeping the stale
        # (bit-correct) values IS the recovery for those nodes.
        written = set()
        for n in graph.nodes:
            if (n.type == TaskType.KERNEL and n.id in executed
                    and n.state.get("writes")):
                for pt in n.state["writes"]:
                    written.add(pt._node.id)

        def reexecutable(n: Node) -> bool:
            if n.type == TaskType.KERNEL:
                return not n.state.get("writes")
            return n.type == TaskType.PULL and n.id not in written

        needs = {n.id for n in graph.nodes if n.id not in executed}
        lost: list[Node] = []
        lost_ids: set[int] = set()
        changed = True
        while changed:
            changed = False
            for n in graph.nodes:
                if (n.id in executed and n.id not in lost_ids
                        and slot.get(id(n.device)) == idx
                        and reexecutable(n)
                        and any(s.id in needs for s in n.successors)):
                    lost.append(n)
                    lost_ids.add(n.id)
                    needs.add(n.id)
                    changed = True
        lost.sort(key=lambda n: n.id)
        self._retire_placement(topo, idx)
        if not lost:
            return
        # counter surgery under the topology lock: each lost node is
        # live again (one more _finish_node to come), and successors
        # still waiting owe one more join count.  Successors already at
        # zero (enqueued or running) are left alone — they read the
        # stale value, bit-identical for pure tasks.
        with topo._lock:
            if topo._remaining <= 0:
                return             # iteration drained concurrently
            topo._remaining += len(lost)
            for n in lost:
                topo._executed.discard(n.id)
                for s in n.successors:
                    if s.join_counter > 0:
                        s.join_counter += 1
        self._reexecuted.inc(len(lost))
        self._bulk_enqueue(lost)

    def _demote_stragglers(self, topo: Topology) -> None:
        """Fold detected slowdowns into the live ``CostModel`` (for
        policies that carry one — HEFT) and trigger a re-placement
        window so hot work migrates off the straggler (the
        ``migrate_top_k`` path when configured).  Runs quiesced at the
        iteration boundary, same safety argument as ``_replace``."""
        from ..sched.chaos import StragglerDetector, demoted_model
        if self._obs is not None:
            self._obs.event("straggler_demotion",
                            stragglers=sorted(self._straggler.stragglers()))
        model = getattr(self.scheduler, "cost_model", None)
        if model is not None:
            self.scheduler.cost_model = demoted_model(
                model, self.devices, self._straggler)
        self._straggler_demotions.inc()
        # fresh observation window: a demotion acts on the evidence,
        # stale ratios must not re-trigger forever
        det = self._straggler
        self._straggler = StragglerDetector(
            alpha=det.alpha, threshold=det.threshold,
            min_samples=det.min_samples)
        self._replace(topo)

    def _poll_chaos(self) -> None:
        """Worker-loop hook: fire any chaos triggers reached by the
        executor-wide completed-task count.  A fault injected by a bad
        plan (e.g. killing the last bin) routes into the running
        topologies' futures instead of killing the worker thread."""
        n_done = next(self._chaos_counter)
        with self._recovery_lock:
            fired = self._chaos_runner.due(n_done)
            if not fired:
                return
            try:
                for ev in fired:
                    if ev.action == "kill":
                        self.fail_bin(ev.bin)
                    else:
                        self.slow_bin(ev.bin, ev.factor)
            except BaseException as e:  # noqa: BLE001
                with self._topo_cv:
                    topos = list(self._topologies.values())
                for topo in topos:
                    if topo.failed is None:
                        topo.failed = e

    # ------------------------------------------------------------------
    # scheduling internals
    # ------------------------------------------------------------------
    def _bulk_enqueue(self, nodes: Sequence[Node]) -> None:
        if self._fuse_batch >= 2 and len(nodes) > 1:
            nodes = self._coalesce(nodes)
        w = getattr(self._local, "worker", None)
        if w is not None:
            with w.lock:
                w.deque.extend(nodes)
        else:
            with self._submit_lock:
                self._submit_q.extend(nodes)
        with self._cv:
            self._cv.notify(len(nodes))

    def _coalesce(self, nodes: Sequence[Node]) -> list:
        """Fold runs of fusable ready nodes into :class:`_FusedBatch`
        units of at most ``fuse_batch`` members.

        A run extends while type, bin, topology, and pipeline stage all
        match — the same keys the scheduler placed on, so a batch never
        straddles a placement boundary.  Unfusable nodes (host tasks,
        unplaced nodes) pass through in order.
        """
        cap = self._fuse_batch
        out: list = []
        run: list[Node] = []

        def flush() -> None:
            if len(run) >= 2:
                out.append(_FusedBatch(run))
            else:
                out.extend(run)
            run.clear()

        for n in nodes:
            if n.type not in _FUSABLE or n.bin_key is None:
                flush()
                out.append(n)
                continue
            if run and (len(run) >= cap
                        or run[0].type is not n.type
                        or run[0].bin_key != n.bin_key
                        or run[0].topology is not n.topology
                        or run[0].state.get("stage") != n.state.get("stage")):
                flush()
            run.append(n)
        flush()
        return out

    def _pop_local(self, w: _Worker) -> Node | None:
        with w.lock:
            return w.deque.pop() if w.deque else None

    def _steal(self, w: _Worker) -> Node | None:
        """One steal round: victims in random order — same-bin victims
        first when locality-aware — then the submit queue.

        Placement is known at steal time (the scheduler runs before any
        node is enqueued), so a thief that just ran a task on bin B
        prefers victims whose stealable head is also placed on B; random
        order is the tie-break within each class and the fallback when
        nothing matches (or ``steal_locality=False``).
        """
        victims = [v for v in self._workers if v is not w]
        w.rng.shuffle(victims)
        if self._steal_locality and w.last_bin is not None:
            # stable sort: matching-bin victims first, shuffled order kept
            victims.sort(key=lambda v: _head_bin(v) != w.last_bin)
        for v in victims:
            with v.lock:
                if v.deque:
                    node = v.deque.popleft()
                    w.steals += 1
                    self._note_steal(w, node)
                    if self._obs is not None:
                        self._obs.event("steal", bin=node.bin_key,
                                        node=node.id, thief=w.id,
                                        victim=v.id)
                    return node
        with self._submit_lock:
            if self._submit_q:
                return self._submit_q.popleft()
        return None

    def _note_steal(self, w: _Worker, node: Node) -> None:
        """Locality hit/miss accounting — only meaningful for device
        tasks stolen by a thief with a known last bin."""
        if node.bin_key is None or w.last_bin is None:
            return
        if node.bin_key == w.last_bin:
            w.steal_local += 1
        else:
            w.steal_cross += 1

    def _worker_loop(self, w: _Worker) -> None:
        self._local.worker = w
        while True:
            node = self._pop_local(w)
            if node is None:
                node = self._wait_for_task(w)
                if node is None:
                    return  # stop
            with self._cv:
                self._actives += 1
            try:
                self._invoke(w, node)
            finally:
                with self._cv:
                    self._actives -= 1
            w.executed += 1
            w.last_beat = time.monotonic()
            if self._chaos_runner:
                self._poll_chaos()

    def _wait_for_task(self, w: _Worker) -> Node | None:
        """Adaptive thief loop (paper §III-C): steal; if the queue world is
        empty, sleep — unless we are the *last thief* and a worker is still
        active (it may spawn successors any moment)."""
        with self._cv:
            self._thieves += 1
        try:
            while True:
                node = self._steal(w)
                if node is not None:
                    return node
                with self._cv:
                    if self._stop:
                        return None
                    # last-thief rule: stay awake while someone is active
                    # — polling each millisecond, not spinning: every
                    # tensor op releases and re-takes the GIL, and a
                    # spinning thief made the worker wait for it at each
                    # op (new work still wakes it at once via notify)
                    if self._thieves == 1 and self._actives > 0:
                        self._cv.wait(timeout=1e-3)
                    else:
                        self._cv.wait(timeout=0.01)
        finally:
            with self._cv:
                self._thieves -= 1

    # ------------------------------------------------------------------
    # task invocation — visitor pattern (paper §III-C)
    # ------------------------------------------------------------------
    def _invoke(self, w: _Worker, node: Node) -> None:
        if type(node) is _FusedBatch:
            return self._invoke_batch(w, node)
        topo: Topology = node.topology
        if topo.failed is None:
            # correlation id for arena events fired while this node runs
            # (profiler v6 spill/refill ``span`` field): thread-local, so
            # _spill/_refill deep in the call chain can read it
            self._local.current_node = node.id
            sid = (self._obs.begin(node.name, bin=node.bin_key,
                                   lane=lane_kind(node.type), node=node.id,
                                   stage=node.state.get("stage"),
                                   worker=w.id, iteration=topo.iteration)
                   if self._obs is not None else 0)
            start = time.perf_counter()
            try:
                handler = self._VISITOR[node.type]
                handler(self, w, node)
            except BaseException as e:  # noqa: BLE001 — propagate via future
                topo.failed = e
            # injected straggling (slow_bin / chaos slow events): stretch
            # the task by the bin's slowdown factor so telemetry — and
            # the straggler detector reading it — sees a genuinely slow
            # bin, closing the loop the demotion tests exercise
            if self._slowdown and node.bin_key is not None:
                sl = self._slowdown.get(node.bin_key)
                if sl is not None and sl > 1.0:
                    time.sleep((sl - 1.0) * (time.perf_counter() - start))
            end = time.perf_counter()
            if self._obs is not None:
                self._obs.end(sid, ok=topo.failed is None)
            # telemetry must not kill the worker: a raising cost_fn or
            # profiler routes into topo.failed like any task exception,
            # so the topology future still resolves
            try:
                if node.bin_key is not None:
                    w.last_bin = node.bin_key
                    if node.bin_key in w.bin_busy:  # fixed key set
                        w.bin_busy[node.bin_key] += end - start
                if (self._straggler is not None and topo.failed is None
                        and node.type == TaskType.KERNEL
                        and node.bin_key is not None):
                    self._straggler.observe(
                        node.bin_key,
                        self._straggler_model.node_time(node),
                        end - start)
                if self._profiler is not None:
                    self._profiler.record(node, worker=w.id,
                                          iteration=topo.iteration,
                                          start=start, end=end,
                                          cost=self._cost_fn(node))
            except BaseException as e:  # noqa: BLE001 — propagate via future
                if topo.failed is None:
                    topo.failed = e
        self._finish_node(node)

    def _invoke_batch(self, w: _Worker, batch: _FusedBatch) -> None:
        """Run a fused batch: one span, one device scope, one profiler
        record (first member's identity, summed cost — the trace shows
        the batch as a single task; docs note the granularity caveat),
        then fan completions back out per member.

        Member handlers run in ready order on this worker.  Their inner
        ``ScopedDeviceContext`` entries are same-target, same-stream
        re-entries under the outer scope — no-ops (``core.streams``).
        Per-member straggler observation is skipped: the EWMA compares per-task
        predictions against spans, and a batch span has no single
        prediction (batched runs still feed per-BIN busy seconds).
        """
        topo: Topology = batch.topology
        if topo.failed is None:
            sid = (self._obs.begin(batch.name, bin=batch.bin_key,
                                   lane=lane_kind(batch.type),
                                   node=batch.id,
                                   stage=batch.state.get("stage"),
                                   worker=w.id, iteration=topo.iteration,
                                   fused=len(batch.nodes))
                   if self._obs is not None else 0)
            start = time.perf_counter()
            try:
                handler = self._VISITOR[batch.type]
                with self._scope(batch.device, batch.type):
                    for n in batch.nodes:
                        self._local.current_node = n.id
                        handler(self, w, n)
            except BaseException as e:  # noqa: BLE001 — propagate via future
                topo.failed = e
            if self._slowdown and batch.bin_key is not None:
                sl = self._slowdown.get(batch.bin_key)
                if sl is not None and sl > 1.0:
                    time.sleep((sl - 1.0) * (time.perf_counter() - start))
            end = time.perf_counter()
            if self._obs is not None:
                self._obs.end(sid, ok=topo.failed is None)
            try:
                if batch.bin_key is not None:
                    w.last_bin = batch.bin_key
                    if batch.bin_key in w.bin_busy:   # fixed key set
                        w.bin_busy[batch.bin_key] += end - start
                if self._profiler is not None:
                    self._profiler.record(
                        batch.nodes[0], worker=w.id,
                        iteration=topo.iteration, start=start, end=end,
                        cost=sum(self._cost_fn(n) for n in batch.nodes))
            except BaseException as e:  # noqa: BLE001 — propagate via future
                if topo.failed is None:
                    topo.failed = e
        for n in batch.nodes:
            self._finish_node(n)

    def _invoke_host(self, w: _Worker, node: Node) -> None:
        if node.work is not None:
            node.state["result"] = node.work()

    def _invoke_pull(self, w: _Worker, node: Node) -> None:
        """H2D: materialize host span, transfer onto the assigned bin.

        Execution bins (``repro_torch.sched.bins``, duck-typed via
        ``kind``) refine the target: a device bin unwraps to its
        ``torch.device``, a host bin keeps the span host-resident — no
        transfer at all — and a *stage* bin delegates to whichever member
        bin backs the stage slot (stage-scope dispatch: the stage is a
        scheduling identity, its member is the execution resource).  An
        explicit ``sharding=`` pin (a ``torch.device`` here) still
        overrides everything.
        """
        host = _span_view(node.state["source"], node.state.get("size"))
        lane = self.lanes.lane(node.device)
        arena = self.arenas.get(id(node.device))
        buf = self._device_put(node, host)
        if buf is host:                     # host bin: span stays put
            node.state["device_data"] = host
            lane.record(host)
            return
        node.state.pop("spilled", None)     # fresh pull supersedes a spill
        if arena is not None and "arena_off" not in node.state:
            node.state["arena_off"] = self._arena_allocate(
                node.device, arena, node, max(span_nbytes(host), 1))
        node.state["device_data"] = buf
        lane.record(buf, event=node.state.get("ready"))

    def _device_put(self, node: Node, host: Any) -> Any:
        """Transfer ``host`` onto ``node``'s assigned bin (shared by the
        pull path and the spill-refill path).  Returns ``host`` itself
        for host bins — the no-transfer case.

        ``host`` is an array, a CPU tensor, or a tree of them (a dict
        pull; the result is the same tree).  On a CUDA bin each leaf is
        staged in a pinned host tensor and copied with
        ``non_blocking=True`` on the bin's copy stream; ONE event recorded
        after the last copy lands in ``node.state["ready"]`` for the
        consumers to wait on.  On the CPU each leaf is copied (a pull
        snapshots its source, as a device copy would).  On a live mesh
        slice (``put_target`` gives its mesh and placements) each leaf
        becomes a ``DTensor`` of those placements: this rank copies its
        own block of the host leaf onto its device of the slice (the
        reference's ``device_put`` onto a ``NamedSharding``)."""
        sharding = node.state.get("sharding")
        eff = execution_target(node.device)  # stage slots → member bin
        kind = getattr(eff, "kind", None)
        if kind == "host" and sharding is None:
            return host
        if sharding is not None:
            target = sharding
        elif kind is not None:
            target = eff.put_target()
        else:
            target = eff
        mesh = places = None
        if isinstance(target, tuple):       # a live slice: (mesh, placements)
            mesh, places = target
            target = torch_device(node.device)
        if not isinstance(target, torch.device):
            raise ValueError(
                f"pull '{node.name}': bin {node.device!r} has no "
                f"torch.device to copy onto")
        leaves = host if mesh is None else map_tree(
            lambda x: _local_block(x, mesh, places), host)
        if target.type != "cuda":
            node.state["ready"] = None
            bufs = map_tree(lambda x: _host_tensor(x).clone().to(target),
                            leaves)
        else:
            lane = self.lanes.lane(node.device)
            with ScopedDeviceContext(node.device, lane.copy_stream):
                bufs = map_tree(lambda x: _pinned(x).to(
                    target, non_blocking=True), leaves)
                ready = torch.cuda.Event()
                ready.record(lane.copy_stream)
            node.state["ready"] = ready
        if mesh is None:
            return bufs
        from torch.distributed.tensor import DTensor
        return map_tree(lambda pair: DTensor.from_local(
            pair[1], mesh, places, run_check=False,
            shape=pair[0].shape, stride=_contiguous_stride(pair[0].shape)),
            _zip_tree(host, bufs))

    def _to_host(self, node: Node, buf: Any) -> Any:
        """D2H of ``node``'s device value ``buf`` after its producer's
        event (a pull's copy or the kernel that last wrote it): on a CUDA
        bin the bin's copy stream waits on that event and the blocking
        copy runs there.  Non-tensor values are converted in place; a
        tree leaf by leaf; a DTensor is gathered whole first; a bf16 copy
        stays a CPU tensor (numpy has no bf16)."""
        if isinstance(buf, dict):
            return map_tree(lambda t: self._to_host(node, t), buf)
        if not isinstance(buf, torch.Tensor):
            return np.asarray(buf)
        if is_dtensor(buf):
            buf = buf.full_tensor()
        if buf.device.type != "cuda":
            return _numpy_or_tensor(buf.detach().clone())
        lane = self.lanes.lane(node.device)
        with ScopedDeviceContext(node.device, lane.copy_stream):
            ready = node.state.get("ready")
            if ready is not None:
                lane.copy_stream.wait_event(ready)
            return _numpy_or_tensor(buf.cpu())

    def _scope(self, device: Any, task_type: TaskType) -> ScopedDeviceContext:
        """The device scope a task of ``task_type`` runs in on ``device``:
        its bin's copy stream for pulls/pushes, compute stream for
        kernels (no stream off CUDA)."""
        return ScopedDeviceContext(
            device, self.lanes.lane(device).stream_for(task_type))

    # ------------------------------------------------------------------
    # arena memory pressure: spill-to-host + refill-on-demand
    # ------------------------------------------------------------------
    def _arena_allocate(self, device: Any, arena: DeviceArena, node: Node,
                        nbytes: int) -> int:
        """Allocate ``nbytes`` for ``node``, evicting the coldest other
        resident pull buffers to host on :class:`OutOfMemory` (StarPU
        eviction: budgets are honored by spilling, not by crashing).
        Re-raises only when the arena cannot fit the request even empty.
        """
        while True:
            try:
                off = arena.allocate(nbytes)
            except OutOfMemory:
                victim = None
                with self._mem_lock:
                    residents = self._resident.setdefault(
                        id(device), OrderedDict())
                    for nid in residents:            # insertion order: coldest
                        if nid != node.id:
                            victim = residents[nid]
                            break
                if victim is None:
                    raise
                self._spill(device, arena, victim)
                continue
            with self._mem_lock:
                residents = self._resident.setdefault(id(device),
                                                      OrderedDict())
                residents[node.id] = node
                residents.move_to_end(node.id)
            return off

    def _spill(self, device: Any, arena: DeviceArena, victim: Node) -> None:
        """Evict one resident pull: free its arena block and demote its
        device buffer to a host copy (D2H).  Consumers still work — a
        kernel touching the host copy triggers a refill (H2D) in
        ``_convert``; a push reads the host copy directly."""
        t0 = time.perf_counter()
        with self._mem_lock:
            off = victim.state.pop("arena_off", None)
            if off is None:                  # lost the race: already gone
                return
            self._resident.get(id(device), OrderedDict()).pop(
                victim.id, None)
            buf = victim.state.get("device_data")
            nbytes = 0
            if buf is not None and not isinstance(buf, np.ndarray):
                host = self._to_host(victim, buf)
                victim.state["device_data"] = host
                nbytes = span_nbytes(host)
            victim.state["spilled"] = True
            self._spills.inc()
            self._spilled_bytes.inc(nbytes)
        arena.free(off)
        # v6 correlation: ``node`` is the spilled pull, ``span`` the node
        # being invoked on this thread (whose allocation forced eviction)
        trigger = getattr(self._local, "current_node", None)
        if self._profiler is not None and hasattr(self._profiler,
                                                  "record_event"):
            self._profiler.record_event(
                "spill", bin=victim.bin_key, bytes=nbytes,
                start=t0, end=time.perf_counter(),
                node=victim.id, span=trigger)
        if self._obs is not None:
            self._obs.event("spill", bin=victim.bin_key, node=victim.id,
                            lane="arena", bytes=nbytes, trigger=trigger)

    def _refill(self, node: Node) -> Any:
        """Re-pull a spilled buffer onto its bin (H2D), re-charging the
        arena — the on-demand half of the spill round trip."""
        t0 = time.perf_counter()
        with self._mem_lock:
            if not node.state.get("spilled"):    # raced with another refill
                return node.state.get("device_data")
            host = node.state["device_data"]
            del node.state["spilled"]
        buf = self._device_put(node, host)
        arena = self.arenas.get(id(node.device))
        nbytes = span_nbytes(host)
        if arena is not None and buf is not host:
            node.state["arena_off"] = self._arena_allocate(
                node.device, arena, node, max(nbytes, 1))
        with self._mem_lock:
            node.state["device_data"] = buf
            self._refills.inc()
            self._refilled_bytes.inc(nbytes)
        trigger = getattr(self._local, "current_node", None)
        if self._profiler is not None and hasattr(self._profiler,
                                                  "record_event"):
            self._profiler.record_event(
                "refill", bin=node.bin_key, bytes=nbytes,
                start=t0, end=time.perf_counter(),
                node=node.id, span=trigger)
        if self._obs is not None:
            self._obs.event("refill", bin=node.bin_key, node=node.id,
                            lane="arena", bytes=nbytes, trigger=trigger)
        return buf

    def _invoke_push(self, w: _Worker, node: Node) -> None:
        """D2H: copy the *source pull task's* device buffer to the host
        target (paper Listing 6)."""
        src: Node = node.state["src"]
        buf = src.state.get("device_data")
        if buf is None:
            raise RuntimeError(
                f"push '{node.name}': source pull '{src.name}' has no device data"
            )
        host = self._to_host(src, buf)
        target = node.state["target"]
        size = node.state.get("size")
        if callable(target):
            target(host)
        else:
            out = np.asarray(target)
            flat = host.reshape(-1)[: size if size is not None else None]
            out.reshape(-1)[: flat.size] = flat
        node.state["result"] = host

    def _invoke_kernel(self, w: _Worker, node: Node) -> None:
        """Device compute: substitute pull/kernel handles in the argument
        list with their device tensors (paper Listing 8/9), run on the
        bin's compute stream after the events of the task's pulls and
        producer kernels (the paper's ``cudaStreamWaitEvent``), rebind
        declared writes."""
        fn = node.state["fn"]
        handles = node.state["args"]
        args = [self._convert(a) for a in handles]
        lane = self.lanes.lane(node.device)
        with self._scope(node.device, TaskType.KERNEL):
            if lane.compute_stream is not None:
                self._await_inputs(node, lane.compute_stream)
            # a value another kernel made moves onto this bin's kind:
            # onto a live slice as a replicated DTensor, off one whole
            args = [_onto_bin(v, node.device) if isinstance(h, KernelTask)
                    else v for h, v in zip(handles, args)]
            result = fn(*args)
            ready = lane.record(result)
        node.state["result"] = result
        node.state["ready"] = ready
        writes = node.state.get("writes", ())
        if writes:
            outs = result if isinstance(result, (tuple, list)) else (result,)
            if len(outs) < len(writes):
                raise ValueError(
                    f"kernel '{node.name}' declared {len(writes)} writes but "
                    f"returned {len(outs)} outputs")
            for pt, out in zip(writes, outs):
                pt._node.state["device_data"] = out
                pt._node.state["ready"] = ready

    @staticmethod
    def _await_inputs(node: Node, stream: Any) -> None:
        """Make ``stream`` wait on the ready event of every pull/kernel
        handle among ``node``'s arguments, and mark their tensors as used
        on ``stream`` — a buffer allocated on a copy stream (or another
        bin's compute stream) must not return to its allocator pool while
        this stream may still read it."""
        for a in node.state["args"]:
            if not isinstance(a, (PullTask, KernelTask)):
                continue
            st = a._node.state
            ready = st.get("ready")
            if ready is not None:
                stream.wait_event(ready)
            value = st.get("device_data" if isinstance(a, PullTask)
                           else "result")
            for t in _tensor_leaves(value):
                if t.is_cuda:
                    t.record_stream(stream)

    def _convert(self, arg: Any) -> Any:
        """Paper's ``convert``/PointerCaster: task handle → device datum."""
        if isinstance(arg, PullTask):
            node = arg._node
            if node.state.get("spilled"):
                return self._refill(node)
            if self.arenas and "arena_off" in node.state:
                # LRU touch: a consumed resident is the warmest
                with self._mem_lock:
                    residents = self._resident.get(id(node.device))
                    if residents is not None and node.id in residents:
                        residents.move_to_end(node.id)
            return arg.device_data()
        if isinstance(arg, KernelTask):
            res = arg._node.state.get("result")
            if res is None:
                raise RuntimeError(
                    f"kernel '{arg._node.name}' used as argument before it ran")
            return res
        return arg

    _VISITOR = {
        TaskType.HOST: _invoke_host,
        TaskType.PLACEHOLDER: _invoke_host,
        TaskType.PULL: _invoke_pull,
        TaskType.PUSH: _invoke_push,
        TaskType.KERNEL: _invoke_kernel,
    }

    # ------------------------------------------------------------------
    # completion / repeat logic
    # ------------------------------------------------------------------
    def _finish_node(self, node: Node) -> None:
        topo: Topology = node.topology
        with topo._lock:
            topo._executed.add(node.id)
        # successors are enqueued even after a failure: _invoke skips
        # their handlers (topo.failed guard) but they must still drain the
        # remaining-counter or the topology future never resolves
        ready = []
        for s in node.successors:
            with topo._lock:
                s.join_counter -= 1
                if s.join_counter == 0:
                    ready.append(s)
        if ready:
            self._bulk_enqueue(ready)
        if topo._node_done():
            self._finish_iteration(topo)

    def _finish_iteration(self, topo: Topology) -> None:
        topo.iteration += 1
        if topo.failed is None:
            try:
                stop = topo.predicate()
            except BaseException as e:  # noqa: BLE001
                topo.failed = e
                stop = True
        else:
            stop = True
        if not stop and self._straggler is not None:
            try:
                if self._straggler.stragglers():
                    self._demote_stragglers(topo)
            except BaseException as e:  # noqa: BLE001 — propagate via future
                topo.failed = e
                stop = True
        if (not stop and self._replace_every
                and topo.iteration % self._replace_every == 0):
            try:
                self._replace(topo)
            except BaseException as e:  # noqa: BLE001 — propagate via future
                topo.failed = e
                stop = True
        if not stop:
            sources = topo._arm()
            self._bulk_enqueue(sources)
            return
        # retire topology: results become visible to the caller's
        # default stream before the future resolves
        for lane in self.lanes.lanes():
            if lane.compute_stream is not None:
                lane.join_into(torch.cuda.default_stream(lane.torch_device))
        if self._profiler is not None:
            try:
                self._profiler.finalize(self)
            except BaseException as e:  # noqa: BLE001 — same rule as record()
                if topo.failed is None:
                    topo.failed = e
        with self._topo_cv:
            self._topologies.pop(topo.id, None)
            self._topo_cv.notify_all()
        if topo.failed is not None and self._obs is not None:
            # flight-recorder dump: the ring's recent window, written as
            # a Perfetto trace next to the failure (never raises into
            # the worker — a fault dump must not mask the fault)
            try:
                self._obs.on_fault(topo.failed, topology=topo.id)
            except BaseException:  # noqa: BLE001
                pass
        if topo.failed is not None:
            topo.future.set_exception(topo.failed)
        else:
            topo.future.set_result(topo.iteration)

    def _replace(self, topo: Topology) -> None:
        """Dynamic re-placement (profile-guided loop, online half).

        Safe here: the iteration fully drained (``_remaining == 0``), no
        node of this topology is in flight, and sources are re-enqueued
        only after the new placement is written back.  Measured busy
        seconds are consumed *per re-placement window*: the delta since
        the previous snapshot (reset at ``run_until`` submission), so
        the bias reflects the recent imbalance, not all history.  The
        snapshot is executor-wide: with several concurrently repeating
        topologies the windows interleave and each re-placement sees the
        combined recent load — coarser, but the aggregate bias is still
        the load the devices actually carried.
        """
        with self._busy_lock:
            current = self._merged_bin_busy()
            window = {label: current.get(label, 0.0)
                      - self._busy_snapshot.get(label, 0.0)
                      for label in set(current) | set(self._busy_snapshot)}
            self._busy_snapshot = current
        # keyed by bin INDEX (sched.base.bin_load reads either keying):
        # duplicate/equal bin objects would collapse an object-keyed dict
        # and erase exactly the per-slot imbalance this measures
        measured = {i: window.get(label, 0.0)
                    for i, label in enumerate(self.device_labels)}
        old_device = {n.id: n.device for n in topo.graph.nodes}
        # a reschedule is an update with measured-load state and no new
        # tasks (sched.base.Scheduler.update): migrate when configured,
        # full repack otherwise, then write the placement back
        from repro_torch.sched.base import (SchedulerState, SchedulerUpdate,
                                      apply_assignment, build_groups)
        groups = build_groups(topo.graph, self._cost_fn)
        sched_state = SchedulerState(self.devices,
                                     migrate_top_k=self._migrate_top_k)
        for i in self._dead_bins:       # failed/retired slots take no work
            sched_state.live.discard(i)
        for g in groups:
            sched_state.add_group(g)
        sched_state.measured_load = measured
        delta = self.scheduler.update(sched_state, SchedulerUpdate(),
                                      graph=topo.graph)
        apply_assignment(topo.graph, groups, self.devices,
                         sched_state.assignment)
        self._free_moved_blocks(topo.graph, old_device)
        self._replacements.inc()
        if self._obs is not None:
            self._obs.event("replacement", moved=len(delta),
                            iteration=topo.iteration)

    def _free_moved_blocks(self, graph: Heteroflow,
                           old_device: dict[int, Any]) -> None:
        """A moved pull's arena block belongs to the *old* device; free
        it so occupancy stays honest and the next pull on the new bin
        re-allocates there (the "arena_off" guard in ``_invoke_pull``
        only allocates when the key is absent)."""
        if not self.arenas:
            return
        for n in graph.nodes:
            off = n.state.get("arena_off")
            if off is None or n.device is old_device[n.id]:
                continue
            arena = self.arenas.get(id(old_device[n.id]))
            if arena is not None:
                arena.free(off)
            del n.state["arena_off"]
            with self._mem_lock:
                residents = self._resident.get(id(old_device[n.id]))
                if residents is not None:
                    residents.pop(n.id, None)
