"""The one general traffic generator: a mix file's parameters and a seed
in, requests out.

A serving mix is one schedule, drawn once, i.i.d., from its parameters
with its own ``trace_seed``, which every run replays whole: the run's
seed gives the prompts' token ids (and the weights), never the amount,
the order or the timing of the work.  The schedule:

- request k's prompt length and answer length, independent draws of
  their distributions: ``{"dist": "lognormal", "median", "sigma", "min",
  "max"}`` (``median · exp(sigma · N(0, 1))``, rounded and clipped) or
  ``{"dist": "uniform", "min", "max"}`` (whole numbers, both ends in);
- an open loop's arrivals: a Poisson process at ``rate_per_s`` (unit
  exponential gaps over the rate), every arrival before the window's end;
- a closed loop's clients each send their next request from one shared
  pool of ``pool`` requests the moment their last one finished.

Each part comes from a stream of its own, so the first k requests and
arrivals are the same for any window and the arrivals at one rate are
those at another, scaled.

A training job's batches are uniform random token ids, each step's rows
drawn from its own stream of the seed, with the labels the next tokens.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .reference.dense_decoder import sub_seed

#: stream ids of the run seed's sub-streams
_TOKENS, _BATCHES, _CHECK = 1002, 1003, 1004
#: stream ids of the schedule's, under the mix's ``trace_seed``
_PROMPTS, _OUTPUTS, _GAPS = 1, 2, 3


@dataclass
class Request:
    """One request: its prompt ids, how many tokens it asks for, and its
    due time in seconds from the start of traffic (None: a closed loop's,
    due when its client sends it)."""
    prompt: np.ndarray
    max_new: int
    due: float | None = None


def draw_lengths(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` independent lengths of the distribution ``dist``."""
    if dist["dist"] == "lognormal":
        x = dist["median"] * np.exp(dist["sigma"] * rng.standard_normal(n))
    elif dist["dist"] == "uniform":
        x = rng.integers(dist["min"], dist["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


def _schedule_rng(mix: dict, stream: int) -> np.random.Generator:
    return np.random.default_rng([mix["trace_seed"], stream])


def requests(mix: dict, n: int, seed: int, vocab: int) -> list[Request]:
    """The schedule's first ``n`` requests; prompt ids uniform over the
    vocabulary, from the run seed."""
    prompts = draw_lengths(mix["prompt"], n, _schedule_rng(mix, _PROMPTS))
    outputs = draw_lengths(mix["output"], n, _schedule_rng(mix, _OUTPUTS))
    ids = _rng(seed, _TOKENS)
    return [Request(ids.integers(0, vocab, int(p), dtype=np.int32), int(o))
            for p, o in zip(prompts, outputs)]


def arrivals(mix: dict, seconds: float) -> np.ndarray:
    """The schedule's arrival times before ``seconds``."""
    rate, n = mix["rate_per_s"], int(mix["rate_per_s"] * seconds) + 16
    while True:
        t = np.cumsum(_schedule_rng(mix, _GAPS).exponential(1.0, n)) / rate
        if t[-1] >= seconds:
            return t[t < seconds]
        n *= 2


def open_loop(mix: dict, seconds: float, seed: int,
              vocab: int) -> list[Request]:
    """An open loop's requests over a window of ``seconds``, each with its
    due time (module docstring)."""
    due = arrivals(mix, seconds)
    reqs = requests(mix, len(due), seed, vocab)
    for r, t in zip(reqs, due):
        r.due = float(t)
    return reqs


def closed_pool(mix: dict, seed: int, vocab: int) -> list[Request]:
    """A closed loop's shared pool, sent in order, cycling if spent."""
    return requests(mix, mix["pool"], seed, vocab)


class Batches:
    """A training job's batches for run seed ``seed``: step k's tokens
    (B, S) and labels from stream (seed, k).  ``fault="half_batch"``
    masks the labels of the second half of every batch's tokens (taken
    in row-major order), so that the loss is the mean over the rest: a
    fault the comparison must catch, never the job's own data."""

    def __init__(self, job: dict, seed: int, vocab: int, *,
                 fault: str | None = None):
        self.rows, self.seq = job["batch"], job["seq"]
        self.seed, self.vocab, self.fault = seed, vocab, fault

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = _rng(self.seed, _BATCHES + 7919 * step)
        t = rng.integers(0, self.vocab, (self.rows, self.seq + 1),
                         dtype=np.int32)
        tokens, labels = t[:, :-1].copy(), t[:, 1:].copy()
        if self.fault == "half_batch":
            flat = labels.reshape(-1)
            flat[flat.size // 2:] = -100
        return {"tokens": tokens, "labels": labels}

    # the interface of the program's data sources (``Pipeline`` reads it)
    def batch(self, step: int, batch: int, seq: int) -> dict:
        if (batch, seq) != (self.rows, self.seq):
            raise ValueError(f"job of B {self.rows} x S {self.seq} asked "
                             f"for B {batch} x S {seq}")
        return self.batch_at(step)


def check_sample(pool: list, seed: int, *, max_requests: int,
                 min_tokens: int) -> list:
    """Which served requests the comparison reads: the one with the most
    served tokens, then others in an order drawn from the seed, until
    ``min_tokens`` served tokens or ``max_requests`` requests.  ``pool``
    holds (id, prompt length, served tokens) triples."""
    if not pool:
        return []
    pool = sorted(pool)
    first = max(pool, key=lambda r: (r[2], r[1]))
    rest = [r for r in pool if r is not first]
    rest = [rest[i] for i in _rng(seed, _CHECK).permutation(len(rest))]
    out, tokens = [first], first[2]
    for r in rest:
        if tokens >= min_tokens or len(out) >= max_requests:
            break
        out.append(r)
        tokens += r[2]
    return out
