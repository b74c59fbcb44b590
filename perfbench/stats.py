"""Percentiles and rates, always over every sample and the whole window.

``percentile`` is the nearest-rank percentile (the smallest sample with
at least p% of the samples at or below it): a tail read from the
samples themselves, never interpolated past the largest.
"""
from __future__ import annotations

import math
from typing import Sequence


def percentile(samples: Sequence[float], p: float) -> float:
    """Nearest-rank ``p``-th percentile of ``samples`` (inf counts as the
    largest); raises on no samples."""
    if not samples:
        raise ValueError("percentile of no samples")
    s = sorted(samples)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return s[rank - 1]


def rate(count: float, seconds: float) -> float:
    """``count`` over ``seconds``, the whole window's."""
    if seconds <= 0:
        raise ValueError(f"a rate over {seconds} s")
    return count / seconds


def lateness_p95(due: Sequence[float], sent: Sequence[float]) -> float:
    """95th percentile of each request's send time minus its due time."""
    return percentile([s - d for d, s in zip(due, sent)], 95)
