"""The engine's decode step captured in CUDA graphs: the port's
counterpart of the reference's ``jax.jit`` over ``decode_step``
(``repro.serving.engine``).

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

Nothing here falls back to the eager step: a capture or replay error
raises.
"""
from __future__ import annotations

import time

import torch

from .. import kernels
from ..models import transformer

__all__ = ["DecodeGraph", "DecodeGraphs"]

#: the kernel wrappers a decode step can launch: the launch counters a
#: replay advances
COUNTED = ("flash_attention", "decode_attention", "rglru_scan", "moe_gating")


class DecodeGraph:
    """One slot's decode step over ``caches``, captured in a CUDA graph."""

    def __init__(self, cfg, params, caches, *, pool, device):
        self.token = torch.zeros((1,), dtype=torch.long, device=device)
        self.pos = torch.zeros((1,), dtype=torch.long, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.counts = kernels.GraphLaunches(COUNTED)
        # thread-local: the executor's workers query events while this
        # thread captures
        with self.counts.capture(), torch.cuda.graph(
                self.graph, pool=pool, capture_error_mode="thread_local"):
            self.logits, _ = transformer.decode_step(
                cfg, params, self.token, caches, pos=self.pos)
        #: launches of each kernel per replay
        self.launches = self.counts.per_replay

    def __call__(self, token: int, pos: int) -> torch.Tensor:
        """Replay on the current stream for ``token`` at cache position
        ``pos``; returns the static (1, V) logits buffer."""
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
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            zero = torch.zeros((1,), dtype=torch.long, device=device)
            transformer.decode_step(cfg, params, zero, slot_caches[0],
                                    pos=zero)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        pool = torch.cuda.graph_pool_handle()
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
