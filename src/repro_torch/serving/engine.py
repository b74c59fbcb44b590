"""Continuous-batching serving engine driven by hetflow graphs.

Each engine *tick* is one iteration of a repeated task graph
(``run_until`` — paper §III-B):

    host(admit+schedule) → pull(new prompts) → kernel(prefill)
                                             → kernel(decode)  → push(tokens)

**Online scheduling**: the engine holds a long-lived scheduling
policy (``scheduler=``, default HEFT) and a persistent
:class:`~repro_torch.sched.SchedulerState` over its KV bins.  Admission turns
every request into a two-group mini-trace — ``pull(prompt KV) →
kernel(prefill{id}) → kernel(decode{id})`` appended to one engine-lifetime
accounting graph — and feeds it through :meth:`Scheduler.update` as a
:class:`~repro_torch.sched.SchedulerUpdate` event (estee-style delta, never a
full repack).  The prefill placement decides which bin's
:class:`~repro_torch.serving.kv_cache.PagedKVArena` hosts the request's pages;
if the scheduler lands the decode group elsewhere, the engine migrates
the pages and charges ``CostModel.transfer_time`` over the KV span
(``kv_moves`` / ``kv_move_seconds`` stats) — the KV-locality rule.
Retirement feeds ``new_finished_tasks`` back; :meth:`add_bin` /
:meth:`retire_bin` join/drain replicas through ``new_bins`` /
``retired_bins`` at the next tick, migrating or preempting the drained
bin's residents.

**Request lifecycle**: :class:`Request` is a frozen public record moving
``queued → prefill → decoding → done`` (``preempted`` on eviction, back
to the queue head).  :meth:`submit` / :meth:`poll` / :meth:`step` are
the public surface; per-request TTFT and inter-token latency feed the
p50/p99 columns of :meth:`stats` (injectable ``clock=`` for tests).

**Observability**: engine tallies live in a
:class:`~repro_torch.obs.MetricsRegistry` (``engine.metrics``) — counters for
ticks/preemptions/kv_moves, histograms for TTFT and inter-token
latency — and :meth:`stats` is a back-compat view over it.  Pass
``obs=`` a :class:`~repro_torch.obs.SpanRecorder` to get instant events for
preemptions, KV migrations, and bin join/retire/fail on the same
timeline as the executor's spans, and the engine's own spans, each of
one request carrying ``request=<id>``:

* ``engine.tick`` — the whole tick (its parent: the executor's task
  span when a tick is a graph iteration);
* ``engine.admit`` — the admission phase: the queue scan, the
  scheduler's placement (``_place``), the arena, and the prefills of
  the requests it seats;
* ``request.queue`` — a request's wait in the queue, from
  :meth:`submit` (or a preemption's re-queue, ``preempted=True``) to the
  tick that seats it; detached: it begins and ends on different threads;
* ``engine.prefill`` (``slot``, ``length``, ``rows``: the rows its
  passes run, the prompt's bucket where it is padded to one) — one per
  seated request: the cache reset, the prefill, the greedy token;
* ``engine.decode`` (``slot``, ``pos``) — one per slot step;
* ``engine.sync`` — the ``.item()`` of the greedy token, inside its
  ``engine.prefill`` or ``engine.decode``.

On the card the recorder also gets the device's time for each prefill
and decode step (``serving.graphs.DeviceIntervals``): an event before
its first enqueue (the cache reset, the token copy, the replays) and one
after the argmax, read after the ``.item()`` the tick waits on anyway,
as ``device.prefill`` / ``device.decode`` intervals on the recorder's
clock.  ``engine.metrics`` then counts their seconds (``device_busy_s``)
and the seconds blocked in ``.item()`` (``host_sync_s``).  The CPU has
no device intervals and no device counters.  Without a recorder each
site costs one ``is not None`` test.

**On the card**: prefill and decode run the port's decoder
(``repro_torch.models.transformer``) with the hand-written kernels;
under an executor each tick runs on its bin's compute stream.  Each
slot's decode step is a CUDA graph captured when the engine is built
(:mod:`repro_torch.serving.graphs`, the counterpart of the reference's
``jax.jit``) and replayed on the current stream.  So is prefill
(``prefill_graphs``): as a ladder of graphed chunks at a device offset
for every family whose prompt can run so (``transformer.takes_ladder``),
and for the others (a local-attention ring, MLA or MoE) as one graphed
pass at offset 0 padded to a bucket (``transformer.takes_buckets``).  A
failed capture raises: on the card nothing prefills eagerly.  On the
CPU both stay eager.  The greedy token is read back with ``.item()``
— one host sync per generated token.

**MoE counts**: a MoE model's layers add their counts (the dropless
path's entries on the experts held here by decode and prefill, the most
rows of one held expert in a prefill; the capacity path's drops) to
``device_counters`` (``obs.device_counters``), on the device, inside the
graphs and the eager steps alike; :meth:`stats` reads them (one host
sync), never a tick.  They start at 0 when the engine is built (the
captures' warm-up passes are not counted).

KV capacity is governed per bin by the :class:`PagedKVArena` buddy pool —
a request is admitted only when its bin's arena can host its page run
(otherwise it queues), the vLLM admission rule built on the paper's
allocator.

**Grow/preempt rule**: a page-run grow (``PagedKVArena.extend``) frees
the old run before allocating the doubled one, so coalescing can satisfy
it in a near-full arena.  When even that fails, the engine does not
crash the tick: it preempts the youngest *other* request on the same
arena — releasing its pages and re-queueing it at the queue head with
its generated tokens reset (greedy decoding recomputes them
identically) — and retries the grow.  Only when no other victim exists
does the grower give up its own seat (self-preemption used to be
preferred whenever the grower was youngest, which livelocked: the
request re-seated, re-grew, and re-evicted itself forever while an
older request's pages sat untouched).  Admission reserves ``prompt +
max_new_tokens`` up front, so grows only bind when requests were seated
with smaller reservations.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import Executor, Heteroflow
from ..core.memory import OutOfMemory
from ..models import transformer
from ..models.moe import COUNTERS as MOE_COUNTERS
from ..obs import MetricsRegistry
from ..obs.device_counters import DeviceCounters, counting
from ..sched import (
    CostModel,
    Scheduler,
    SchedulerState,
    SchedulerUpdate,
    TaskGroup,
    build_groups,
    get_scheduler,
)
from .graphs import (BucketPrefillGraphs, DecodeGraphs, DeviceIntervals,
                     PrefillGraphs)
from .kv_cache import PagedKVArena

#: request lifecycle states (``Request.state``)
QUEUED, PREFILL, DECODING, DONE, PREEMPTED = (
    "queued", "prefill", "decoding", "done", "preempted")
LIFECYCLE = (QUEUED, PREFILL, DECODING, DONE, PREEMPTED)

#: abstract cost units per token, mirroring the serving-trace workload
#: (``benchmarks.workloads.build_serving_trace``) so the simulator study
#: and the live engine feed the scheduler the same shape
_PREFILL_COST_PER_TOKEN = 2.0
_DECODE_COST_PER_TOKEN = 6.0


@dataclass(frozen=True, eq=False)
class Request:
    """Public, immutable view of one serving request.

    The identity fields are frozen; the engine advances the mutable
    lifecycle bookkeeping (``state``, timing marks, the ``generated``
    token list) internally — user code reads, never writes.  ``state``
    moves ``queued → prefill → decoding → done``; a preempted request
    shows ``preempted`` until it is re-seated.
    """

    id: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    generated: list[int] = field(default_factory=list)
    arrival_s: float = 0.0
    state: str = QUEUED
    first_token_s: float | None = None
    finished_s: float | None = None

    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + len(self.generated)

    def _advance(self, **fields: Any) -> None:
        """Engine-internal lifecycle mutation on the frozen record."""
        for k, v in fields.items():
            object.__setattr__(self, k, v)


class ServingEngine:
    """Slot-based continuous batching over one or more model replicas.

    ``max_slots`` concurrent requests share a stacked KV cache of
    ``max_seq`` tokens per slot; each bin's paged arena does admission
    control and utilization accounting, and the ``scheduler`` policy
    places request groups onto bins through the event-driven
    ``update()`` loop.  Greedy sampling (argmax) — sampling strategies
    are orthogonal to the scheduling contribution.

    ``params`` are cast once to the config's compute dtype
    (``transformer.cast_params``).  ``device`` is where the model runs
    (default: the device of the embedding table).  Each slot's cache is
    allocated here and reset in place at admission; on CUDA each slot's
    decode step is captured here too (``decode_graphs``), and its prefill
    (``prefill_graphs``): a ladder where the family takes one, else its
    buckets.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_seq: int = 256, page_tokens: int = 16,
                 executor: Executor | None = None,
                 bins: "Sequence[Any] | int | None" = None,
                 scheduler: "Scheduler | str" = "heft",
                 cost_model: CostModel | None = None,
                 clock: Callable[[], float] | None = None,
                 obs: Any = None, device: Any = None):
        self.cfg = cfg
        self.params = transformer.cast_params(cfg, params)
        self.device = torch.device(device) if device is not None \
            else self.params["embed"].device
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        self.kv_bytes_per_token = self._kv_bytes_per_token(cfg)
        self.cost_model = cost_model or CostModel()
        self.executor = executor
        self._clock = clock or time.monotonic

        if bins is None:
            bins = ["kv0"]
        elif isinstance(bins, int):
            bins = [f"kv{i}" for i in range(max(1, bins))]
        if isinstance(scheduler, str):
            kwargs = ({"cost_model": self.cost_model}
                      if scheduler == "heft" else {})
            scheduler = get_scheduler(scheduler, **kwargs)
        self.scheduler = scheduler
        self._sched_state = SchedulerState(list(bins))
        #: engine-lifetime accounting graph: every admission appends its
        #: request's mini-trace here so group roots (node ids) stay
        #: unique across requests — never executed, only group-built
        self._trace = Heteroflow("serving_admissions")
        self._req_groups: dict[int, tuple[TaskGroup, ...]] = {}
        self._placed: dict[int, tuple[tuple[TaskGroup, ...], int, int]] = {}
        self._home: dict[int, int] = {}        # request id -> bin index
        self._pending_new_bins: list[Any] = []
        self._pending_retire_bins: list[Any] = []
        self._pending_fail_bins: list[Any] = []

        n_pages = max_slots * -(-max_seq // page_tokens)
        self._arenas: dict[int, PagedKVArena] = {
            i: self._new_arena(n_pages) for i in self._sched_state.live}
        self._queue: deque[Request] = deque()
        self._slots: list[Request | None] = [None] * max_slots
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self.completed: list[Request] = []

        # per-slot caches (each slot = batch-1 cache ⇒ independent
        # prefill) at fixed addresses, which the decode graphs read
        self._caches = [transformer.init_cache(cfg, 1, max_seq,
                                               device=self.device)
                        for _ in range(max_slots)]
        #: a MoE model's counts on the device (module docstring); None
        #: without MoE
        self.device_counters = (
            DeviceCounters(MOE_COUNTERS, self.device)
            if any(g.ffn_of(i) == "moe" for g in cfg.groups
                   for i in range(len(g.pattern))) else None)
        with counting(self.device_counters):
            #: the per-slot decode graphs on CUDA; None on the CPU (eager)
            self.decode_graphs = (
                DecodeGraphs(cfg, self.params, self._caches, self.device)
                if self.device.type == "cuda" else None)
            #: the per-slot prefill graphs on CUDA: the ladder for a family
            #: that takes one, else the buckets; None on the CPU (eager)
            self.prefill_graphs = None
            if self.decode_graphs is not None:
                kind = (PrefillGraphs if transformer.takes_ladder(cfg)
                        else BucketPrefillGraphs)
                self.prefill_graphs = kind(cfg, self.params, self._caches,
                                           self.decode_graphs, max_seq,
                                           self.device)
        if self.device_counters is not None:
            self.device_counters.reset()
        self._obs = obs
        #: request id -> its open ``request.queue`` span (with a recorder)
        self._queue_spans: dict[int, int] = {}
        #: public registry — counters/histograms the engine publishes
        #: into; :meth:`stats` is a back-compat view over it
        self.metrics = MetricsRegistry()
        #: the device intervals, on the card with a recorder
        self._intervals = None
        if obs is not None and self.device.type == "cuda":
            self._intervals = DeviceIntervals(obs.clock, self.device)
            self._device_busy = self.metrics.counter("device_busy_s")
            self._host_sync = self.metrics.counter("host_sync_s")
        self._ticks = self.metrics.counter("ticks")
        self._preemptions = self.metrics.counter("preemptions")
        self._kv_moves = self.metrics.counter("kv_moves")
        self._kv_move_seconds = self.metrics.counter("kv_move_seconds")
        self._ttft = self.metrics.histogram("ttft_s")
        self._itl = self.metrics.histogram("itl_s")
        self._last_token_s: dict[int, float] = {}

    def _new_arena(self, n_pages: int) -> PagedKVArena:
        return PagedKVArena(n_pages=n_pages, page_tokens=self.page_tokens,
                            kv_bytes_per_token=self.kv_bytes_per_token)

    @staticmethod
    def _kv_bytes_per_token(cfg: ModelConfig) -> int:
        per_layer = 2 * cfg.n_kv_heads * cfg.head_dim_ * 2  # k+v bf16
        return max(1, per_layer * cfg.n_layers)

    # registry-backed tallies, kept as public attributes for back-compat
    @property
    def ticks(self) -> int:
        return self._ticks.value

    @property
    def preemptions(self) -> int:
        return self._preemptions.value

    @property
    def kv_moves(self) -> int:
        return self._kv_moves.value

    @property
    def kv_move_seconds(self) -> float:
        return self._kv_move_seconds.value

    @property
    def arena(self) -> PagedKVArena:
        """The first live bin's arena (single-replica back-compat)."""
        return self._arenas[min(self._sched_state.live)]

    @property
    def bins(self) -> list:
        """Live KV bins, in slot order."""
        s = self._sched_state
        return [s.bins[i] for i in sorted(s.live)]

    def _arena_of(self, req: Request) -> PagedKVArena:
        return self._arenas[self._home.get(req.id,
                                           min(self._sched_state.live))]

    # -- public API -------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        """Enqueue a request; returns its id (poll it with :meth:`poll`)."""
        req = Request(next(self._ids), np.asarray(prompt, np.int32),
                      max_new_tokens, arrival_s=self._clock())
        with self._lock:
            if self._obs is not None:
                self._queue_spans[req.id] = self._obs.begin(
                    "request.queue", detached=True, request=req.id)
            self._queue.append(req)
        return req.id

    def poll(self, request_id: int) -> Request | None:
        """Non-blocking status lookup: the :class:`Request` record
        (live view — its ``state``/``generated`` advance with the
        engine) or ``None`` for an unknown id."""
        with self._lock:
            for r in itertools.chain(self.completed,
                                     (s for s in self._slots if s),
                                     self._queue):
                if r.id == request_id:
                    return r
        return None

    def step(self) -> bool:
        """Advance the engine by one tick (admit → prefill → decode);
        returns True while there is still work in flight."""
        return self._tick()

    def run(self) -> list[Request]:
        """Run ticks until queue + slots drain.  If constructed with an
        executor, each tick is a hetflow graph iteration; otherwise the
        loop runs inline (tests)."""
        if self.executor is None:
            while self._tick():
                pass
        else:
            g = Heteroflow("serve_tick")
            g.kernel(lambda: self._tick(), name="engine_tick")
            self.executor.run_until(g, lambda: not self._has_work()).result()
        return self.completed

    def add_bin(self, bin_: Any) -> None:
        """Join a KV replica bin at the next tick
        (``SchedulerUpdate(new_bins=...)``)."""
        with self._lock:
            self._pending_new_bins.append(bin_)

    def retire_bin(self, bin_: Any) -> None:
        """Drain a KV replica bin at the next tick
        (``SchedulerUpdate(retired_bins=...)``): residents migrate to
        the re-placement the scheduler picks, or are preempted when the
        destination arena cannot host their pages."""
        with self._lock:
            self._pending_retire_bins.append(bin_)

    def fail_bin(self, bin_: Any) -> None:
        """Kill a KV replica bin at the next tick — the dead-arena case.

        Same ``SchedulerUpdate(retired_bins=...)`` path as
        :meth:`retire_bin`, but residents are never migrated: their KV
        pages lived on the dead arena, so the lost frontier is the
        requests themselves.  Each is preempted — pages released,
        generated tokens dropped, re-queued at the head — and greedy
        decode recomputes the identical tokens on a surviving replica.
        """
        with self._lock:
            self._pending_fail_bins.append(bin_)

    def _has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(s is not None for s in self._slots)

    # -- scheduling core ---------------------------------------------------
    def _apply_bin_events(self) -> None:
        """Feed queued bin joins/drains through one SchedulerUpdate and
        reconcile arenas + residents with the placement delta."""
        with self._lock:
            new = tuple(self._pending_new_bins)
            drained = tuple(self._pending_retire_bins)
            failed = tuple(self._pending_fail_bins)
            self._pending_new_bins.clear()
            self._pending_retire_bins.clear()
            self._pending_fail_bins.clear()
        gone = drained + failed
        if not (new or gone):
            return
        if self._obs is not None:
            for b in new:
                self._obs.event("join_bin", bin=b)
            for b in drained:
                self._obs.event("retire_bin", bin=b)
            for b in failed:
                self._obs.event("fail_bin", bin=b)
        state = self._sched_state
        gone_idx = {i for i in state.live
                    if state.bins[i] in gone or i in gone}
        dead_idx = {i for i in state.live
                    if state.bins[i] in failed or i in failed}
        n_pages = self.max_slots * -(-self.max_seq // self.page_tokens)
        delta = self.scheduler.update(
            state, SchedulerUpdate(new_bins=new, retired_bins=gone))
        for i in state.live:
            if i not in self._arenas:
                self._arenas[i] = self._new_arena(n_pages)
        moved_reqs = [r for r in self._slots
                      if r is not None and self._home.get(r.id) in gone_idx]
        for req in moved_reqs:
            if self._home.get(req.id) in dead_idx:
                # dead arena: the pages are gone, there is nothing to
                # migrate — the request IS the lost frontier
                self._preempt(req)
                continue
            groups = self._req_groups.get(req.id, ())
            dest = next((delta[g.root] for g in groups if g.root in delta),
                        None)
            if dest is None or not self._migrate_kv(req, dest):
                self._preempt(req)
        for i in gone_idx:
            arena = self._arenas.pop(i, None)
            # whatever still sits there (direct-seated test requests)
            # is preempted with the bin
            if arena is not None:
                for rid in list(arena.tables):
                    req = next((r for r in self._slots
                                if r is not None and r.id == rid), None)
                    if req is not None:
                        self._preempt(req)

    def _migrate_kv(self, req: Request, dest: int) -> bool:
        """Move ``req``'s pages to bin ``dest``, charging the KV span's
        transfer time; False when the destination cannot host them."""
        src = self._home.get(req.id, min(self._sched_state.live))
        if dest == src or dest not in self._arenas:
            return dest == src
        need = req.total_tokens + max(
            0, req.max_new_tokens - len(req.generated))
        if not self._arenas[dest].can_admit(max(1, need)):
            return False
        self._arenas[src].release(req.id)
        self._arenas[dest].admit(
            req.id, req.total_tokens,
            reserve_tokens=max(0, req.max_new_tokens - len(req.generated)))
        state = self._sched_state
        moved_bytes = req.total_tokens * self.kv_bytes_per_token
        self._kv_moves.inc()
        self._kv_move_seconds.inc(self.cost_model.transfer_time(
            moved_bytes, state.bins[src], state.bins[dest]))
        self._home[req.id] = dest
        if self._obs is not None:
            self._obs.event("kv_move", bin=dest, lane="arena",
                            bytes=moved_bytes, request=req.id, src=src)
        return True

    def _request_groups(self, req: Request) -> tuple[TaskGroup, TaskGroup]:
        """Append ``req``'s mini-trace (pull→prefill→decode, own pulls ⇒
        two affinity groups) to the engine graph and return the
        (prefill, decode) groups."""
        G = self._trace
        mark = len(G.nodes)
        kv_span = max(1, len(req.prompt)) * self.kv_bytes_per_token
        p = G.pull(np.zeros(1, np.float32), size=kv_span,
                   name=f"pull_prefill{req.id}")
        k = G.kernel(lambda *a: 0.0, p,
                     cost=_PREFILL_COST_PER_TOKEN * max(1, len(req.prompt)),
                     name=f"prefill{req.id}")
        k.succeed(p)
        p2 = G.pull(np.zeros(1, np.float32), size=1024,
                    name=f"pull_decode{req.id}")
        k2 = G.kernel(lambda *a: 0.0, p2, k,
                      cost=_DECODE_COST_PER_TOKEN * max(1, req.max_new_tokens),
                      name=f"decode{req.id}")
        k2.succeed(p2, k)
        new = [g for g in build_groups(G)
               if min(n.id for n in g.nodes) >= mark]
        pre = next(g for g in new
                   if any(n.name == f"prefill{req.id}" for n in g.nodes))
        dec = next(g for g in new
                   if any(n.name == f"decode{req.id}" for n in g.nodes))
        return pre, dec

    def _place(self, req: Request) -> tuple[tuple[TaskGroup, ...], int, int]:
        """One SchedulerUpdate per admission: place the request's
        prefill + decode groups, cached so a stalled admission does not
        re-place (and double-account) on retry."""
        if req.id in self._placed:
            return self._placed[req.id]
        pre, dec = self._request_groups(req)
        delta = self.scheduler.update(
            self._sched_state, SchedulerUpdate(new_tasks=(pre, dec)))
        live = sorted(self._sched_state.live)
        home = delta.get(pre.root, live[0])
        dbin = delta.get(dec.root, home)
        self._placed[req.id] = ((pre, dec), home, dbin)
        return self._placed[req.id]

    def _tick(self) -> bool:
        """One engine iteration: admit → prefill news → decode actives."""
        obs = self._obs
        with counting(self.device_counters):
            if obs is None:
                return self._tick_body(None)
            sid = obs.begin("engine.tick")
            try:
                return self._tick_body(obs)
            finally:
                obs.end(sid)

    def _tick_body(self, obs) -> bool:
        self._ticks.inc()
        self._apply_bin_events()
        # 1. admission (scheduler-placed, arena-gated)
        with self._lock:
            if obs is not None:
                admit = obs.begin("engine.admit")
            stalled = False
            for i in range(self.max_slots):
                if stalled:
                    break
                # re-try slot i after an oversize rejection: the next
                # queued request may well fit (the old `continue` left
                # the slot empty for the whole tick)
                while self._slots[i] is None and self._queue:
                    nxt = self._queue[0]
                    need = len(nxt.prompt) + nxt.max_new_tokens
                    if need > self.max_seq:
                        nxt._advance(state=DONE, finished_s=self._clock())
                        self._queue.popleft()     # reject oversize
                        if obs is not None:
                            obs.end(self._queue_spans.pop(nxt.id),
                                    rejected=True)
                        self.completed.append(nxt)
                        continue
                    groups, home, dbin = self._place(nxt)
                    if not self._arenas[home].can_admit(need):
                        # KV-locality override: seat on any bin with
                        # room rather than head-of-line block the queue
                        fit = [b for b in sorted(self._sched_state.live)
                               if self._arenas[b].can_admit(need)]
                        if not fit:
                            stalled = True        # wait for pages to free
                            break
                        home = fit[0]
                        self._placed[nxt.id] = (groups, home, dbin)
                    req = self._queue.popleft()
                    self._arenas[home].admit(req.id, len(req.prompt),
                                             reserve_tokens=req.max_new_tokens)
                    self._home[req.id] = home
                    self._slots[i] = req
                    self._req_groups[req.id] = groups
                    del self._placed[req.id]
                    req._advance(state=PREFILL)
                    if obs is not None:
                        obs.end(self._queue_spans.pop(req.id))
                        L = len(req.prompt)
                        rows = (L if self.prefill_graphs is None else
                                sum(self.prefill_graphs.plan(L)))
                        sid = obs.begin("engine.prefill", request=req.id,
                                        slot=i, length=L, rows=rows)
                        if self._intervals is not None:
                            self._intervals.open()
                    # prefill this slot, from the state init_cache gives:
                    # the last occupant's recurrent state must not leak,
                    # and a chunk's last key tile reads rows past it
                    transformer.reset_cache(self.cfg, self._caches[i])
                    if self.prefill_graphs is not None:
                        logits = self.prefill_graphs.prefill(i, req.prompt)
                    else:
                        tokens = torch.as_tensor(
                            req.prompt[None, :],
                            dtype=torch.long).to(self.device)
                        logits, self._caches[i] = transformer.prefill(
                            self.cfg, self.params, tokens, self._caches[i])
                    top = logits[0].argmax()
                    req.generated.append(
                        int(top.item()) if obs is None else
                        self._read_token(obs, top, "device.prefill", req.id))
                    now = self._clock()
                    if req.first_token_s is None:
                        self._ttft.observe(now - req.arrival_s)
                        req._advance(first_token_s=now)
                    self._last_token_s[req.id] = now
                    req._advance(state=DECODING)
                    if obs is not None:
                        obs.end(sid)
                    self._arenas[home].extend(req.id)
                    # decode placed off the KV home: migrate the pages
                    # (charged) so decode runs where its cache lives
                    if dbin != home:
                        self._migrate_kv(req, dbin)
            if obs is not None:
                obs.end(admit)

        # 2. decode step for all active slots
        active = [(i, r) for i, r in enumerate(self._slots) if r is not None]
        for i, req in active:
            if self._slots[i] is not req:
                continue                          # preempted mid-tick
            if len(req.generated) >= req.max_new_tokens:
                self._retire(i)
                continue
            if obs is not None:
                sid = obs.begin("engine.decode", request=req.id, slot=i,
                                pos=req.total_tokens - 1)
                if self._intervals is not None:
                    self._intervals.open()
            if self.decode_graphs is not None:
                # the cache holds the prompt and every generated token
                # but the last, which this step feeds
                logits = self.decode_graphs.step(i, req.generated[-1],
                                                 req.total_tokens - 1)
            else:
                tok = torch.tensor([req.generated[-1]], dtype=torch.long,
                                   device=self.device)
                logits, self._caches[i] = transformer.decode_step(
                    self.cfg, self.params, tok, self._caches[i])
            top = logits[0].argmax()
            req.generated.append(
                int(top.item()) if obs is None else
                self._read_token(obs, top, "device.decode", req.id))
            now = self._clock()
            last = self._last_token_s.get(req.id)
            if last is not None:
                self._itl.observe(now - last)
            self._last_token_s[req.id] = now
            if obs is not None:
                obs.end(sid)
            if not self._grow(req):
                continue                          # req went back to queue
            if len(req.generated) >= req.max_new_tokens:
                self._retire(i)
        return self._has_work()

    def _read_token(self, obs, top: torch.Tensor, interval: str,
                    rid: int) -> int:
        """The greedy token ``top`` read back under a recorder: its
        ``.item()`` in an ``engine.sync`` span; on the card the device
        interval closed before it and read after it, and both counters
        advanced (module docstring)."""
        dev = self._intervals
        if dev is not None:
            dev.close()
        sid = obs.begin("engine.sync", request=rid)
        t0 = time.perf_counter()
        tok = int(top.item())
        blocked = time.perf_counter() - t0
        obs.end(sid)
        if dev is not None:
            start, end = dev.read()
            obs.complete(interval, start, end, request=rid)
            self._device_busy.inc((end - start) / 1e9)
            self._host_sync.inc(blocked)
        return tok

    def _grow(self, req: Request) -> bool:
        """Extend ``req``'s page run, preempting the youngest *other*
        request on the same arena on grow-OOM (module docstring:
        grow/preempt rule).  Only when no other victim exists does the
        grower give up its own seat — preferring self-preemption
        whenever the grower happened to be youngest livelocked the
        engine (evict self → re-seat → re-grow → evict self …).
        Returns False when ``req`` itself had to be preempted."""
        while True:
            try:
                self._arena_of(req).extend(req.id)
                return True
            except OutOfMemory:
                victim = self._preempt_youngest(
                    exclude=req, bin_idx=self._home.get(req.id))
                if victim is None:
                    self._preempt(req)            # last resort: own seat
                    return False

    def _preempt_youngest(self, exclude: Request | None = None,
                          bin_idx: int | None = None) -> Request | None:
        """Kick the youngest (highest id) active request back to the
        queue head — ``exclude`` is never chosen, and ``bin_idx``
        restricts victims to one arena (evicting pages elsewhere cannot
        unblock a grow on this one)."""
        with self._lock:
            default = min(self._sched_state.live)
            seated = [
                (r.id, i) for i, r in enumerate(self._slots)
                if r is not None and r is not exclude
                and (bin_idx is None
                     or self._home.get(r.id, default) == bin_idx)]
            if not seated:
                return None
            _, slot = max(seated)
        victim = self._slots[slot]
        self._preempt(victim)
        return victim

    def _preempt(self, victim: Request) -> None:
        """Release ``victim``'s pages and reset its generated tokens —
        greedy decoding recomputes them identically on re-admission."""
        if self._obs is not None:
            self._obs.event("preempt", bin=self._home.get(victim.id),
                            request=victim.id,
                            generated=len(victim.generated))
        with self._lock:
            arena = self._arena_of(victim)
            if victim.id in arena.tables:
                arena.release(victim.id)
            self._home.pop(victim.id, None)
            self._last_token_s.pop(victim.id, None)
            victim.generated.clear()
            victim._advance(state=PREEMPTED)
            for i, r in enumerate(self._slots):
                if r is victim:
                    self._slots[i] = None
            self._finish_groups(victim)
            if self._obs is not None:
                self._queue_spans[victim.id] = self._obs.begin(
                    "request.queue", detached=True, request=victim.id,
                    preempted=True)
            self._queue.appendleft(victim)
            self._preemptions.inc()

    def _finish_groups(self, req: Request) -> None:
        """Release the request's groups from the scheduler's active-load
        books (``new_finished_tasks``); re-admission files fresh ones."""
        groups = self._req_groups.pop(req.id, ())
        if groups:
            self.scheduler.update(
                self._sched_state,
                SchedulerUpdate(new_finished_tasks=tuple(groups)))

    def _retire(self, slot: int) -> None:
        with self._lock:
            req = self._slots[slot]
            req._advance(state=DONE, finished_s=self._clock())
            self._arena_of(req).release(req.id)
            self._home.pop(req.id, None)
            self._last_token_s.pop(req.id, None)
            self._finish_groups(req)
            self.completed.append(req)
            self._slots[slot] = None

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """Back-compat metrics view (same keys/values as pre-registry).

        Derived occupancy numbers are published into the registry as
        gauges on the way out, so ``engine.metrics.snapshot()`` carries
        the full picture a scrape needs; the TTFT/ITL percentiles come
        from the registry histograms (same nearest-rank rule as the old
        list-based implementation, so the values are bit-identical).
        """
        live = sorted(self._sched_state.live)
        utils = [self._arenas[i].utilization for i in live
                 if i in self._arenas]
        frags = [self._arenas[i].fragmentation() for i in live
                 if i in self._arenas]
        m = self.metrics
        m.gauge("queue").set(len(self._queue))
        m.gauge("active").set(sum(s is not None for s in self._slots))
        m.gauge("completed").set(len(self.completed))
        m.gauge("bins").set(len(live))
        m.gauge("kv_utilization").set(
            sum(utils) / len(utils) if utils else 0.0)
        m.gauge("kv_fragmentation").set(
            sum(frags) / len(frags) if frags else 0.0)
        m.gauge("page_grows").set(sum(self._arenas[i].grows for i in live
                                      if i in self._arenas))
        return {
            "ticks": self._ticks.value,
            "queue": m.gauge("queue").value,
            "active": m.gauge("active").value,
            "completed": m.gauge("completed").value,
            "bins": m.gauge("bins").value,
            "kv_utilization": m.gauge("kv_utilization").value,
            "kv_fragmentation": m.gauge("kv_fragmentation").value,
            "page_grows": m.gauge("page_grows").value,
            "preemptions": self._preemptions.value,
            "kv_moves": self._kv_moves.value,
            "kv_move_seconds": self._kv_move_seconds.value,
            "ttft_p50_s": self._ttft.percentile(50),
            "ttft_p99_s": self._ttft.percentile(99),
            "itl_p50_s": self._itl.percentile(50),
            "itl_p99_s": self._itl.percentile(99),
            **(self.device_counters.read()
               if self.device_counters is not None else {}),
        }
