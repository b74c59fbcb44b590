"""The engine's decode step and prefill captured in CUDA graphs: the
port's counterparts of the reference's ``jax.jit`` over ``decode_step``
and ``prefill`` (``repro.serving.engine``).

Each slot's batch-1 decode step is captured once, over that slot's
caches (allocated once, reset in place at admission), and replayed for
every token: one launch of a graph in place of the thousands of eager
launches a step makes from Python.  The step reads no host scalar
(``transformer.decode_step``'s ``pos``): its inputs are a static token
buffer and a static position buffer, written on the device before each
replay, and its output is a static logits buffer.  All slots' graphs
share one memory pool; they are replayed one at a time.

A kernel wrapper counts a launch when its Python code runs, which a
replay does not do: at capture each graph records how many launches of
each kernel it holds (``kernels.GraphLaunches``: what the capture
counted is taken back, since a capture launches nothing), and every
replay adds them.

The reference retraces prefill for each prompt length.  A graph per
exact length would be captured on nearly every request of mixed
traffic, at about the cost of the eager prefill it replaces, so prefill
runs as a *ladder* instead (:class:`PrefillGraphs`): each slot captures
one graph per rung, a chunk of r = 2, 4, ..., R tokens (R the largest
power of two <= min(512, max_seq)) at a start position read from a
device buffer, and a prompt of L tokens runs as :func:`plan` gives it:
L // R chunks of R, then the binary digits of L mod R, largest first.  A
chunk of one token is the slot's decode graph (``forward`` takes the
same one-token branch).  The chunks give what the eager
``transformer.prefill(..., pos=)`` of the same plan gives, bit for bit;
the one-shot prefill, within the f32 tolerance chunked prefill is held
to.

Families whose prompt cannot run at a device offset
(``transformer.takes_ladder``: a local-attention ring, MLA or MoE) run
each prompt in one pass at offset 0 instead, padded at its tail to a
*bucket* (:class:`BucketPrefillGraphs`): each slot captures one graph per
bucket, the powers of two from :data:`MIN_BUCKET` up to max_seq (and
max_seq itself), over a static token buffer and the true length (and,
with MoE, its capacity) in static device buffers.  The causal mask keeps
every real row exact, a ring keeps the last real rows, RG-LRU its state
at the last real row and MoE the slots and drops of the real tokens
alone, so a replay gives the eager one-shot prefill of the real tokens
(``transformer.prefill(..., valid=)``, the reference's semantics: its
jit traces the one-shot prefill at offset 0 for each prompt length)
within the f32 tolerance, and the eager padded prefill of the same
bucket bit for bit.  A bucket costs up to twice the prompt's tokens of
work, and reads every weight once.

Nothing here falls back to eager code: a capture or replay error
raises.
"""
from __future__ import annotations

import time

import torch

from .. import kernels
from ..models import moe, transformer

__all__ = ["BucketGraph", "BucketPrefillGraphs", "DecodeGraph",
           "DecodeGraphs", "PrefillGraph", "PrefillGraphs", "buckets",
           "eager_bucket", "eager_ladder", "plan", "top_rung"]

#: the longest chunk of the ladder
MAX_RUNG = 512
#: the smallest bucket of the bucketed prefill
MIN_BUCKET = 16
#: the token id a bucket's pad rows carry
PAD_ID = 0

#: the kernel wrappers a decode step can launch: the launch counters a
#: replay advances
COUNTED = ("flash_attention", "decode_attention", "rglru_scan", "moe_gating")


def _capture(fn, pool):
    """``fn()`` captured in a CUDA graph in ``pool``: (the graph, the
    launches it holds (``kernels.GraphLaunches``), ``fn``'s result).
    Thread-local: the executor's workers query events while this thread
    captures."""
    graph = torch.cuda.CUDAGraph()
    counts = kernels.GraphLaunches(COUNTED)
    with counts.capture(), torch.cuda.graph(
            graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    return graph, counts, out


def _warm_up(device, fn) -> None:
    """``fn()`` run eagerly on a side stream and synchronised, before a
    capture: what happens at a kernel's first use (a library loaded, a
    shared-memory attribute set, an occupancy query) happens outside
    it."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


class DecodeGraph:
    """One slot's decode step over ``caches``, captured in a CUDA graph."""

    def __init__(self, cfg, params, caches, *, pool, device):
        self.token = torch.zeros((1,), dtype=torch.long, device=device)
        self.pos = torch.zeros((1,), dtype=torch.long, device=device)
        self.graph, self.counts, (self.logits, _) = _capture(
            lambda: transformer.decode_step(cfg, params, self.token, caches,
                                            pos=self.pos), pool)
        #: launches of each kernel per replay
        self.launches = self.counts.per_replay

    def __call__(self, token, pos: int) -> torch.Tensor:
        """Replay on the current stream for ``token`` (an int, or a
        one-element device tensor) at cache position ``pos``; returns the
        static (1, V) logits buffer."""
        if isinstance(token, torch.Tensor):
            self.token.copy_(token.reshape(1))
        else:
            self.token.fill_(token)
        self.pos.fill_(pos)
        self.counts.replay(self.graph)
        return self.logits


class DecodeGraphs:
    """A :class:`DecodeGraph` per slot, captured after one warm-up step.

    The warm-up runs one eager step on the first slot's caches (which
    admission resets anyway) on a side stream, so that what happens once
    per process (library loads, the gating kernel's occupancy query,
    cuBLAS's handle) happens outside a capture.  ``capture_seconds``
    covers warm-up and captures; ``replays`` counts steps replayed."""

    #: eager steps run before capture (their launches count as launches)
    warmup_steps = 1

    def __init__(self, cfg, params, slot_caches, device):
        t0 = time.perf_counter()
        zero = torch.zeros((1,), dtype=torch.long, device=device)
        _warm_up(device, lambda: transformer.decode_step(
            cfg, params, zero, slot_caches[0], pos=zero))
        #: the memory pool every graph of the engine shares
        self.pool = pool = torch.cuda.graph_pool_handle()
        self.slots = [DecodeGraph(cfg, params, c, pool=pool, device=device)
                      for c in slot_caches]
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0
        self.replays = 0

    def step(self, slot: int, token: int, pos: int) -> torch.Tensor:
        """Slot ``slot``'s decode step for ``token`` at cache position
        ``pos``: (1, V) logits, valid until that slot's next replay."""
        self.replays += 1
        return self.slots[slot](token, pos)


def top_rung(max_seq: int) -> int:
    """R: the largest power of two <= min(MAX_RUNG, max_seq)."""
    return 1 << (min(MAX_RUNG, max_seq).bit_length() - 1)


def plan(L: int, R: int) -> list[int]:
    """The chunk sizes a prompt of ``L`` tokens runs as on a ladder whose
    top rung is ``R`` (a power of two): L // R chunks of R, then the
    binary digits of L mod R, largest first."""
    if L < 1 or R < 1 or R & (R - 1):
        raise ValueError(f"plan: {L} tokens on a top rung of {R}")
    chunks = [R] * (L // R)
    bit = R >> 1
    while bit:
        if L & bit:
            chunks.append(bit)
        bit >>= 1
    return chunks


def eager_ladder(cfg, params, tokens, caches, R: int):
    """The eager twin of :meth:`PrefillGraphs.prefill`: ``tokens`` (1, L)
    run chunk by chunk in :func:`plan`'s order through
    ``transformer.prefill(..., pos=)``.  Returns the last chunk's logits
    and the caches."""
    start = 0
    for r in plan(tokens.shape[1], R):
        pos = torch.full((1,), start, dtype=torch.long, device=tokens.device)
        logits, caches = transformer.prefill(
            cfg, params, tokens[:, start:start + r], caches, pos=pos)
        start += r
    return logits, caches


class PrefillGraph:
    """One slot's prompt chunk of ``rung`` tokens over ``caches``,
    captured in a CUDA graph at a start position read from a static
    device buffer."""

    def __init__(self, cfg, params, caches, rung: int, *, pool, device):
        self.tokens = torch.zeros((1, rung), dtype=torch.long, device=device)
        self.start = torch.zeros((1,), dtype=torch.long, device=device)
        self.graph, self.counts, (self.logits, _) = _capture(
            lambda: transformer.prefill(cfg, params, self.tokens, caches,
                                        pos=self.start), pool)
        #: launches of each kernel per replay
        self.launches = self.counts.per_replay

    def __call__(self, tokens: torch.Tensor, start: int) -> torch.Tensor:
        """Replay on the current stream for ``tokens`` (1, rung) on the
        device at cache position ``start``; returns the static (1, V)
        logits buffer."""
        self.tokens.copy_(tokens)
        self.start.fill_(start)
        self.counts.replay(self.graph)
        return self.logits


class PrefillGraphs:
    """The ladder prefill (module docstring): per slot, a
    :class:`PrefillGraph` for each rung 2, 4, ..., :func:`top_rung`, in
    the decode graphs' pool, with the slot's decode graph as the rung of
    one token.  Captured after one eager warm-up chunk of every rung (on
    the first slot's caches, which admission resets anyway, at position
    0): what happens at a kernel's first use (the flash kernel's library
    and its shared-memory attribute, a library kernel that a rung's
    shapes pick loaded into the process) happens outside a capture.
    ``capture_seconds`` covers the warm-up and the captures; ``prefills``
    counts prompts, ``replays`` the chunks of two tokens or more and
    ``decode_chunks`` the chunks of one; ``warmup_chunks`` the eager
    chunks (their launches count as launches).  Raises on a CPU device
    and for a family ``transformer.takes_ladder`` refuses."""

    def __init__(self, cfg, params, slot_caches, decode_graphs: DecodeGraphs,
                 max_seq: int, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"PrefillGraphs: CUDA graphs need a CUDA device, "
                             f"got {device}")
        if not transformer.takes_ladder(cfg):
            raise ValueError(f"PrefillGraphs: {cfg.arch_id} prefills "
                             f"eagerly (transformer.takes_ladder)")
        t0 = time.perf_counter()
        self.caches, self.device = slot_caches, device
        self.decode, self.max_seq = decode_graphs, max_seq
        self.top = top_rung(max_seq)
        self.rungs = [1 << i for i in range(1, self.top.bit_length())]
        for r in self.rungs:
            zero = torch.zeros((1, r), dtype=torch.long, device=device)
            _warm_up(device, lambda: transformer.prefill(
                cfg, params, zero, slot_caches[0], pos=zero[0, :1]))
        self.warmup_chunks = len(self.rungs)
        #: per slot, the rung r's graph
        self.slots = [{r: PrefillGraph(cfg, params, c, r,
                                       pool=decode_graphs.pool,
                                       device=device)
                       for r in self.rungs} for c in slot_caches]
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0
        self.prefills = self.replays = self.decode_chunks = 0

    def plan(self, L: int) -> list[int]:
        """The chunks a prompt of ``L`` tokens runs as."""
        return plan(L, self.top)

    def prefill(self, slot: int, prompt) -> torch.Tensor:
        """Prefill slot ``slot``'s caches (reset by the caller) with
        ``prompt`` ((L,) or (1, L) token ids: numpy, or a tensor on the
        card), chunk by chunk on the current stream; sets every attention
        sub-cache's host ``length`` to L.  Returns the last chunk's (1, V)
        logits, valid until the next replay of the engine's graphs."""
        tokens = torch.as_tensor(prompt).reshape(1, -1).to(
            self.device, torch.long)
        L = tokens.shape[1]
        if not 1 <= L <= self.max_seq:
            raise ValueError(f"PrefillGraphs: a prompt of {L} tokens for "
                             f"caches of {self.max_seq} rows")
        start = 0
        for r in self.plan(L):
            chunk = tokens[:, start:start + r]
            if r == 1:
                logits = self.decode.slots[slot](chunk, start)
                self.decode_chunks += 1
            else:
                logits = self.slots[slot][r](chunk, start)
                self.replays += 1
            start += r
        transformer.set_length(self.caches[slot], L)
        self.prefills += 1
        return logits


def buckets(max_seq: int) -> list[int]:
    """The padded lengths of the bucketed prefill: the powers of two from
    :data:`MIN_BUCKET` below ``max_seq``, then ``max_seq`` itself."""
    if max_seq < 2:
        raise ValueError(f"buckets: caches of {max_seq} rows (a padded "
                         f"prompt takes two or more)")
    sizes, b = [], MIN_BUCKET
    while b < max_seq:
        sizes.append(b)
        b <<= 1
    return sizes + [max_seq]


def _bucket_of(sizes: list[int], L: int) -> int:
    """The smallest of ``sizes`` (ascending) that holds ``L`` tokens."""
    for b in sizes:
        if b >= L:
            return b
    raise ValueError(f"a prompt of {L} tokens for caches of {sizes[-1]} "
                     f"rows")


def _moe_capacity(cfg, L: int) -> int:
    """The capacity of a one-shot prefill of ``L`` tokens (0 without
    MoE)."""
    return moe.capacity(cfg, L) if cfg.moe.n_experts else 0


def eager_bucket(cfg, params, tokens, caches, bucket: int):
    """The eager twin of :meth:`BucketPrefillGraphs.prefill`: ``tokens``
    (1, L) padded with :data:`PAD_ID` to ``bucket`` rows and run through
    ``transformer.prefill(..., valid=, capacity=)`` on fresh ``caches``,
    whose host length is then set to L.  Returns the logits of the last
    real token and the caches."""
    L = tokens.shape[1]
    if not 1 <= L <= bucket:
        raise ValueError(f"a prompt of {L} tokens in a bucket of {bucket}")
    dev = tokens.device
    padded = torch.full((1, bucket), PAD_ID, dtype=torch.long, device=dev)
    padded[:, :L] = tokens
    valid = torch.full((1,), L, dtype=torch.long, device=dev)
    cap = torch.full((1,), _moe_capacity(cfg, L), dtype=torch.long,
                     device=dev)
    logits, caches = transformer.prefill(cfg, params, padded, caches,
                                         valid=valid, capacity=cap)
    return logits, transformer.set_length(caches, L)


class BucketGraph:
    """One slot's one-shot prefill of a prompt padded to ``size`` tokens
    over ``caches`` (at length 0), captured in a CUDA graph, the prompt's
    true length and its MoE capacity read from static device buffers."""

    def __init__(self, cfg, params, caches, size: int, *, pool, device):
        self.tokens = torch.full((1, size), PAD_ID, dtype=torch.long,
                                 device=device)
        self.valid = torch.full((1,), size, dtype=torch.long, device=device)
        self.capacity = torch.zeros((1,), dtype=torch.long, device=device)
        self.graph, self.counts, (self.logits, _) = _capture(
            lambda: transformer.prefill(cfg, params, self.tokens, caches,
                                        valid=self.valid,
                                        capacity=self.capacity), pool)
        #: launches of each kernel per replay
        self.launches = self.counts.per_replay

    def __call__(self, tokens: torch.Tensor, capacity: int) -> torch.Tensor:
        """Replay on the current stream for ``tokens`` (1, L <= size) on
        the device, of MoE capacity ``capacity``; returns the static (1,
        V) logits buffer of the last real token."""
        L = tokens.shape[1]
        self.tokens[:, :L].copy_(tokens)
        self.tokens[:, L:].fill_(PAD_ID)
        self.valid.fill_(L)
        self.capacity.fill_(capacity)
        self.counts.replay(self.graph)
        return self.logits


class BucketPrefillGraphs:
    """The bucketed prefill (module docstring): per slot, a
    :class:`BucketGraph` for each of :func:`buckets` (max_seq), in the
    decode graphs' pool.  Captured after one eager warm-up pass of every
    bucket (on the first slot's caches, which admission resets anyway):
    what happens at a kernel's first use at a shape happens outside a
    capture.  Every slot's caches are reset first: a bucket runs at
    length 0, and leaves them reset.  ``capture_seconds`` covers the
    warm-up and the captures;
    ``prefills`` counts prompts, ``bucket_tokens`` the rows their buckets
    ran (real and pad) and ``warmups`` the eager passes (their launches
    count as launches).  Raises on a CPU device and for a family
    ``transformer.takes_buckets`` refuses.  The interface is
    :class:`PrefillGraphs`'s."""

    def __init__(self, cfg, params, slot_caches, decode_graphs: DecodeGraphs,
                 max_seq: int, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"BucketPrefillGraphs: CUDA graphs need a CUDA "
                             f"device, got {device}")
        if not transformer.takes_buckets(cfg):
            raise ValueError(f"BucketPrefillGraphs: {cfg.arch_id}'s prompt "
                             f"cannot run padded (transformer.takes_buckets)")
        t0 = time.perf_counter()
        self.cfg, self.caches, self.device = cfg, slot_caches, device
        self.max_seq = max_seq
        self.sizes = buckets(max_seq)
        for c in slot_caches:
            transformer.reset_cache(cfg, c)
        for b in self.sizes:
            zero = torch.zeros((1, b), dtype=torch.long, device=device)
            _warm_up(device, lambda: eager_bucket(cfg, params, zero,
                                                  slot_caches[0], b))
        transformer.reset_cache(cfg, slot_caches[0])
        self.warmups = len(self.sizes)
        #: per slot, the bucket b's graph
        self.slots = [{b: BucketGraph(cfg, params, c, b,
                                      pool=decode_graphs.pool,
                                      device=device)
                       for b in self.sizes} for c in slot_caches]
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0
        self.prefills = self.bucket_tokens = 0

    def bucket(self, L: int) -> int:
        """The bucket a prompt of ``L`` tokens runs in."""
        return _bucket_of(self.sizes, L)

    def prefill(self, slot: int, prompt) -> torch.Tensor:
        """Prefill slot ``slot``'s caches (reset by the caller) with
        ``prompt`` ((L,) or (1, L) token ids: numpy, or a tensor on the
        card) in one replay of its bucket's graph on the current stream;
        sets every sub-cache's host ``length`` to L.  Returns the (1, V)
        logits of the last real token, valid until the next replay of the
        engine's graphs."""
        tokens = torch.as_tensor(prompt).reshape(1, -1).to(
            self.device, torch.long)
        L = tokens.shape[1]
        if not 1 <= L <= self.max_seq:
            raise ValueError(f"BucketPrefillGraphs: a prompt of {L} tokens "
                             f"for caches of {self.max_seq} rows")
        b = self.bucket(L)
        logits = self.slots[slot][b](tokens, _moe_capacity(self.cfg, L))
        transformer.set_length(self.caches[slot], L)
        self.prefills += 1
        self.bucket_tokens += b
        return logits
