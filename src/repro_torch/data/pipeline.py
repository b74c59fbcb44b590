"""Data pipeline built on the paper's host tasks.

Two sources:
* :class:`SyntheticSource` — deterministic pseudo-random token stream
  (seeded per shard; reproducible across restarts given the step index);
* :class:`MemmapSource` — a binary token file read through ``np.memmap``
  (the production path: tokenize offline, stream epochs without RAM).

:class:`Pipeline` drives either through a double-buffered hetflow graph:
``host(read+pack) → pull(batch)``; the executor overlaps batch k+1's
read/transfer with step k's compute — the paper's H2D/compute overlap
applied to input pipelines (DESIGN.md §4.1).

A copy of ``repro.data.pipeline`` (numpy only) over the port's
``Heteroflow``: the pull tasks move a batch to their bin's device on the
bin's copy stream (``repro_torch.core.executor``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


class SyntheticSource:
    """Deterministic synthetic token stream."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        tokens = rng.integers(0, self.vocab_size, (batch, seq + 1),
                              dtype=np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class MemmapSource:
    """Token stream over a flat binary file of int32 ids."""

    def __init__(self, path: str, vocab_size: int):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab_size = vocab_size

    def batch(self, step: int, batch: int, seq: int) -> dict[str, np.ndarray]:
        n = self.data.shape[0]
        span = seq + 1
        starts = (np.arange(batch) * span
                  + step * batch * span) % max(n - span, 1)
        tokens = np.stack([self.data[s:s + span] for s in starts]).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


@dataclass
class PipelineConfig:
    batch: int
    seq: int
    prefetch: int = 2


class Pipeline:
    """Double-buffered batch iterator.

    Plain-iterator mode (``__iter__``) for tests; graph mode
    (:meth:`host_task_graph`) for the hetflow training loop.
    """

    def __init__(self, source, cfg: PipelineConfig):
        self.source = source
        self.cfg = cfg
        self._step = 0
        self._lock = threading.Lock()

    def next_host_batch(self) -> dict[str, np.ndarray]:
        with self._lock:
            step = self._step
            self._step += 1
        return self.source.batch(step, self.cfg.batch, self.cfg.seq)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next_host_batch()

    # -- hetflow integration -------------------------------------------
    def host_task_graph(self, hf, buffer: dict, *, sharding=None):
        """Append (host: read/pack → pull: H2D) tasks to graph ``hf``.

        ``buffer`` is a mutable dict the host task fills; the pull task
        transfers ``buffer['tokens']``/``buffer['labels']`` — stateful
        capture exactly like the paper's Listing 4.  ``sharding`` pins the
        pulls to a ``torch.device``.  Returns
        (host_task, pull_tokens, pull_labels).
        """
        def fill():
            buffer.update(self.next_host_batch())

        host = hf.host(fill, name="data_read")
        pull_tok = hf.pull(lambda: buffer["tokens"], sharding=sharding,
                           name="pull_tokens")
        pull_lab = hf.pull(lambda: buffer["labels"], sharding=sharding,
                           name="pull_labels")
        host.precede(pull_tok, pull_lab)
        return host, pull_tok, pull_lab
