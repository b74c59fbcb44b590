"""Fault injection + straggler detection for elastic execution.

Two halves, shared by the tests and ``sched_bench --chaos``:

* :class:`ChaosPlan` — a deterministic, seeded churn scenario pinned to
  **task-count triggers** ("after the Nth task completes, kill bin 2").
  Task counts, unlike wall-clock times, mean the same thing to the
  threaded executor and to the discrete-event simulator, so one plan
  drives both: the executor polls :meth:`ChaosPlan.runner` after every
  completed task, and :meth:`ChaosPlan.fault_schedule` converts the
  triggers into simulated times (the finish time of the Nth task in a
  no-fault reference run) for ``simulate(..., faults=...)``.
* :class:`StragglerDetector` — per-bin EWMA of observed-vs-predicted
  kernel duration (fed from the profiler records).  A bin whose
  smoothed slowdown exceeds ``threshold``× the healthiest bin's is a
  straggler; :func:`demoted_model` folds the detected slowdowns into a
  live :class:`~repro_torch.sched.simulator.CostModel` so the next
  re-placement (``migrate_top_k``) routes work away from it.

Specx's restartable tasks and StarPU's runtime-managed residency (see
PAPERS.md) motivate the split: the *runtime* owns recovery, and the only
way to trust it is to make the faults reproducible.
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from repro_torch.core.streams import bin_labels

from .simulator import CostModel, FaultEvent, FaultSchedule, simulate

__all__ = ["ChaosEvent", "ChaosPlan", "ChaosRunner", "StragglerDetector",
           "demoted_model", "parse_chaos"]

_ACTIONS = ("kill", "slow")


@dataclass(frozen=True)
class ChaosEvent:
    """One planned fault: once ``after_tasks`` tasks have completed,
    ``kill`` bin ``bin`` (an index into the run's bin list) or ``slow``
    it by ``factor``."""

    after_tasks: int
    action: str
    bin: int
    factor: float = 2.0

    def __post_init__(self) -> None:
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r}; "
                             f"expected one of {_ACTIONS}")
        if self.after_tasks < 1:
            raise ValueError(
                f"after_tasks must be >= 1, got {self.after_tasks!r}")
        if self.action == "slow" and self.factor <= 0:
            raise ValueError(
                f"slowdown factor must be > 0, got {self.factor!r}")


@dataclass(frozen=True)
class ChaosPlan:
    """A deterministic churn scenario at task-count triggers."""

    events: tuple[ChaosEvent, ...] = ()
    seed: int = 0

    def __bool__(self) -> bool:
        return bool(self.events)

    def ordered(self) -> list[ChaosEvent]:
        return [e for _, _, e in sorted(
            (e.after_tasks, i, e) for i, e in enumerate(self.events))]

    # ------------------------------------------------------------------
    @classmethod
    def plan(cls, spec: str, *, n_tasks: int, n_bins: int,
             seed: int = 0) -> "ChaosPlan":
        """Build a concrete plan from a CLI spec (:func:`parse_chaos`).

        ``kill:N`` kills ``N`` seeded-random distinct bins at triggers
        evenly spaced through the run (the i-th kill after
        ``(i+1)·n_tasks/(N+1)`` completions — "mid-run", never at the
        very start or end).  ``slow:BIN:FACTOR`` slows the named bin
        index at the one-third mark.  The same (spec, n_tasks, n_bins,
        seed) always yields the same plan.
        """
        kind, arg = parse_chaos(spec)
        events: list[ChaosEvent] = []
        if kind == "kill":
            n = int(arg)
            if not 1 <= n < n_bins:
                raise ValueError(
                    f"kill:{n} needs 1 <= N < n_bins ({n_bins}) so at "
                    f"least one bin survives")
            rng = random.Random(seed)
            victims = rng.sample(range(n_bins), n)
            for i, b in enumerate(victims):
                at = max(1, (i + 1) * n_tasks // (n + 1))
                events.append(ChaosEvent(at, "kill", b))
        else:
            b, factor = arg
            if not 0 <= b < n_bins:
                raise ValueError(f"slow: bin {b} out of range 0..{n_bins-1}")
            events.append(ChaosEvent(max(1, n_tasks // 3), "slow", b,
                                     factor))
        return cls(tuple(events), seed=seed)

    # ------------------------------------------------------------------
    def runner(self, *, obs: Any = None) -> "ChaosRunner":
        """Fresh mutable trigger-poller for one executor run.

        ``obs`` — an optional ``repro_torch.obs.SpanRecorder`` — receives a
        ``chaos_trigger`` instant event per fired trigger, so injected
        faults show up on the run's timeline next to the recovery work
        they caused."""
        return ChaosRunner(self.ordered(), obs=obs)

    def fault_schedule(
        self,
        graph: Any,
        placement: Mapping[int, Any],
        bins: Sequence[Any],
        *,
        cost_model: CostModel | None = None,
        host_workers: int = 4,
    ) -> FaultSchedule:
        """Convert task-count triggers to simulated times.

        Runs a no-fault reference simulation of ``(graph, placement)``
        and pins each event to the finish time of its ``after_tasks``-th
        task — deterministic, and consistent with the simulator's tie
        rule (tasks finishing at exactly the fault time count as done,
        so exactly ``after_tasks`` tasks have completed when the fault
        fires).
        """
        ref = simulate(graph, placement, bins, cost_model=cost_model,
                       host_workers=host_workers)
        order = sorted(ref.finish_times.values())
        out = []
        for e in self.ordered():
            k = min(e.after_tasks, len(order)) - 1
            out.append(FaultEvent(order[k], e.action, e.bin, e.factor))
        return FaultSchedule(tuple(out))


class ChaosRunner:
    """Mutable poller over a plan's ordered events — the executor hook.

    ``due(n_done)`` pops and returns every event whose trigger count has
    been reached; the caller applies them (``Executor.fail_bin`` /
    ``Executor.slow_bin``).  One runner per run: triggers fire once.
    Each fired trigger is also recorded as a ``chaos_trigger`` instant
    on the attached flight recorder (when one was passed to
    :meth:`ChaosPlan.runner`).
    """

    def __init__(self, events: Sequence[ChaosEvent], *, obs: Any = None):
        self._events = list(events)
        self._obs = obs

    def __bool__(self) -> bool:
        return bool(self._events)

    def due(self, n_done: int) -> list[ChaosEvent]:
        fired = []
        while self._events and self._events[0].after_tasks <= n_done:
            fired.append(self._events.pop(0))
        if fired and self._obs is not None:
            for ev in fired:
                self._obs.event("chaos_trigger", bin=ev.bin,
                                action=ev.action, factor=ev.factor,
                                after_tasks=ev.after_tasks)
        return fired


def parse_chaos(spec: str) -> tuple[str, Any]:
    """Parse a ``--chaos`` CLI spec.

    ``kill:N`` → ``("kill", N)``; ``slow:BIN:FACTOR`` →
    ``("slow", (bin_index, factor))``.
    """
    parts = str(spec).split(":")
    if parts[0] == "kill" and len(parts) == 2:
        try:
            return "kill", int(parts[1])
        except ValueError:
            pass
    elif parts[0] == "slow" and len(parts) == 3:
        try:
            return "slow", (int(parts[1]), float(parts[2]))
        except ValueError:
            pass
    raise ValueError(
        f"bad chaos spec {spec!r}: expected kill:N or slow:BIN:FACTOR")


# ----------------------------------------------------------------------
# online straggler detection
# ----------------------------------------------------------------------
class StragglerDetector:
    """Per-bin EWMA of observed-vs-predicted kernel duration.

    ``observe(label, predicted_s, observed_s)`` folds one kernel record
    into the bin's exponentially-weighted slowdown ratio.  The absolute
    ratio is model-calibration-dependent (an uncalibrated model is off
    by the same constant on every bin), so straggling is judged
    *relatively*: a bin is a straggler when its smoothed ratio exceeds
    ``threshold``× the healthiest observed bin's.
    """

    def __init__(self, alpha: float = 0.4, threshold: float = 2.0,
                 min_samples: int = 2):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha!r}")
        if threshold <= 1:
            raise ValueError(f"threshold must be > 1, got {threshold!r}")
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self._ewma: dict[Any, float] = {}
        self._count: dict[Any, int] = {}

    def observe(self, label: Any, predicted_s: float,
                observed_s: float) -> None:
        if predicted_s <= 0 or observed_s <= 0:
            return
        ratio = observed_s / predicted_s
        prev = self._ewma.get(label)
        self._ewma[label] = (ratio if prev is None
                             else (1 - self.alpha) * prev
                             + self.alpha * ratio)
        self._count[label] = self._count.get(label, 0) + 1

    def slowdown(self, label: Any) -> float:
        """Smoothed slowdown of ``label`` relative to the healthiest
        observed bin (1.0 = keeping pace, 2.0 = half speed)."""
        r = self._ewma.get(label)
        if r is None or not self._ewma:
            return 1.0
        return r / min(self._ewma.values())

    def stragglers(self) -> list[Any]:
        """Labels whose relative slowdown crosses the threshold (with at
        least ``min_samples`` observations — one noisy kernel is not a
        verdict)."""
        return sorted(
            (lb for lb in self._ewma
             if self._count.get(lb, 0) >= self.min_samples
             and self.slowdown(lb) > self.threshold),
            key=lambda lb: -self.slowdown(lb))


def demoted_model(model: CostModel, bins: Sequence[Any],
                  detector: StragglerDetector) -> CostModel:
    """Fold detected straggler slowdowns into ``model.device_speed`` so
    the next re-placement sees the bin at its *observed* speed.  Bins
    below threshold keep their modelled speed; the returned model is a
    new frozen instance (``dataclasses.replace``)."""
    straggling = set(detector.stragglers())
    if not straggling:
        return model
    labels = bin_labels(bins)
    speeds = [model.speed(i) for i in range(len(bins))]
    for i, lb in enumerate(labels):
        if lb in straggling:
            speeds[i] = speeds[i] / detector.slowdown(lb)
    return dataclasses.replace(model, device_speed=tuple(speeds))
