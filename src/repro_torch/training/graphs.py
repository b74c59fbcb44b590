"""The train step captured in one CUDA graph: the port's counterpart of
the reference's ``jax.jit(step_fn)`` (``repro.launch.train``).

:class:`TrainStepGraph` wraps the eager step of
:func:`~.trainer.make_train_step`.  Its first call runs that step eagerly:
it is the run's first step, and it does what happens once per process
(library loads, cuBLAS's handles, the gating kernel's occupancy query)
outside a capture.  Then it empties the allocator's cache, so that the
graph's private memory pool does not sit beside the eager step's cached
blocks, and captures one step over static batch buffers and the state's
own tensors: the forward at the compute dtype, the remat recompute, the
backward kernels, the global-norm clip and AdamW, every update in place.
A capture runs no kernel, so it leaves the state as it was.  Every later
call copies its batch into the static buffers and replays the graph on
the current stream (the executor's compute stream): one graph launch in
place of the thousands of launches an eager step makes from Python.

The gradients are allocated by ``backward`` inside the capture, in the
graph's pool, and set to None at the step's end (a whole-network
capture).  The graph reads the state's tensors at the addresses they had
at capture, so a call must pass the state the graph was built on, and
it returns that same object; its metrics are static buffers, which the
next replay overwrites.

Nothing falls back to the eager step: a capture or replay error raises,
and so does a batch of other keys, shapes or dtypes (the reference would
retrace; here a run keeps its shapes).  On the CPU the step stays eager:
the caller picks this class by device, as the engine picks its decode
graphs.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from .. import kernels

__all__ = ["TrainStepGraph"]


class TrainStepGraph:
    """``step(state, batch)`` captured once and replayed.

    ``step`` is a train step of :func:`~.trainer.make_train_step`,
    ``state`` the train state it updates in place (on a CUDA device).
    The static batch buffers take the shapes and dtypes of the first
    call's batch.  ``capture_seconds`` is the capture's wall time (graph
    instantiation included), ``replays`` counts the steps replayed, and
    ``counts.per_replay`` the kernel launches each replay adds to the
    wrappers' counters."""

    def __init__(self, step: Callable, state: dict):
        self.step = step
        self.state = state
        self.graph: torch.cuda.CUDAGraph | None = None
        self.batch: dict | None = None
        self.metrics: dict | None = None
        self.counts = kernels.GraphLaunches()
        self.capture_seconds: float | None = None
        self.replays = 0

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        if state is not self.state:
            raise ValueError("TrainStepGraph: called with another state than "
                             "the one it was built on; the graph reads that "
                             "state's tensors")
        batch = {k: v for k, v in batch.items() if v is not None}
        if self.graph is None:
            _, metrics = self.step(self.state, batch)
            self._capture(batch)
            return self.state, metrics
        self._load(batch)
        self.counts.replay(self.graph)
        self.replays += 1
        return self.state, self.metrics

    def _capture(self, batch: dict) -> None:
        t0 = time.perf_counter()
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        # thread-local: the executor's other workers pull and query events
        # while this thread captures
        with self.counts.capture(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            _, self.metrics = self.step(self.state, self.batch)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def _load(self, batch: dict) -> None:
        """Copy ``batch`` into the static buffers on the current stream;
        raises on other keys, shapes, dtypes or devices."""
        if batch.keys() != self.batch.keys() or any(
                (v.shape, v.dtype, v.device) != (s.shape, s.dtype, s.device)
                for v, s in ((batch[k], self.batch[k]) for k in batch)):
            def spec(b):
                return {k: (tuple(v.shape), str(v.dtype), str(v.device))
                        for k, v in b.items()}
            raise ValueError(f"TrainStepGraph: batch {spec(batch)} is not "
                             f"the captured {spec(self.batch)}")
        for k, v in batch.items():
            self.batch[k].copy_(v)
