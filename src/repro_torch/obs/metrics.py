"""Metrics registry: named counters, gauges, histograms (p50/p99).

The executor, serving engine, and simulator publish into a
:class:`MetricsRegistry`; their public ``stats()`` dicts are views
over it, so a dashboard can scrape one registry instead of N ad-hoc
dicts.  Instruments are get-or-create by name — publishing the same
name twice returns the same instrument.

Histograms keep raw samples and use the same nearest-rank percentile
rule as :func:`repro_torch.sched.online.percentile` (reimplemented here so
``repro_torch.obs`` stays import-cycle-free below ``repro_torch.sched``), so
registry-backed p50/p99 values are bit-identical to the pre-registry
``stats()`` numbers.

Mutation takes a per-instrument lock; instrument creation takes a
registry lock.  Hot per-task counters (the executor's per-worker
executed/steal tallies) stay lock-free per-worker and are published
as gauges at ``stats()`` time.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Iterable, Sequence


def percentile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank percentile — the ``repro_torch.sched.online`` rule."""
    if not xs:
        raise ValueError("percentile of empty sequence")
    s = sorted(xs)
    k = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
    return s[k]


class Counter:
    """Monotonic counter (int or float increments)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._value: float = 0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: negative inc {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._value: Any = 0

    def set(self, v: Any) -> None:
        self._value = v

    @property
    def value(self) -> Any:
        return self._value


class Histogram:
    """Sample-keeping histogram with nearest-rank percentiles."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._samples: list[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._samples.append(v)

    def extend(self, vs: Iterable[float]) -> None:
        with self._lock:
            self._samples.extend(vs)

    @property
    def count(self) -> int:
        return len(self._samples)

    @property
    def sum(self) -> float:
        return sum(self._samples)

    @property
    def samples(self) -> list[float]:
        return list(self._samples)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile; 0.0 on an empty histogram."""
        s = self._samples
        return percentile(s, p) if s else 0.0

    def summary(self) -> dict[str, float]:
        return {"count": self.count, "sum": self.sum,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create registry of named instruments."""

    def __init__(self) -> None:
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls: type) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif type(inst) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def snapshot(self) -> dict[str, Any]:
        """Flat dict view: counters/gauges → value, histograms →
        ``{count, sum, p50, p99}``."""
        out: dict[str, Any] = {}
        for name in self.names():
            inst = self._instruments[name]
            out[name] = (inst.summary() if isinstance(inst, Histogram)
                         else inst.value)
        return out
