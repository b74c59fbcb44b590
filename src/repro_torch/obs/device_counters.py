"""Counters kept on the device, for work whose counts live there.

A count that a CUDA graph computes (how many routed entries landed on
this device's experts, say) cannot be read per step without a host sync
that the graphed step exists to avoid.  :class:`DeviceCounters` keeps
such counts in one int64 tensor on the device: model code adds to them
with device ops, so a graph captured while they are active adds to them
on every replay, and :meth:`DeviceCounters.read` brings them to the host
with one sync, only when asked (``ServingEngine.stats``).

Model code finds the counters in force with :func:`active`; a caller
puts them in force around the calls (and captures) it owns with
``with counting(counters):``.  The context is per thread, as the
sharding rules' (``distributed.context``): nothing outside it counts.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["DeviceCounters", "active", "counting"]

_state = threading.local()


class DeviceCounters:
    """Named int64 counters on ``device``, starting at 0."""

    def __init__(self, names, device):
        self.names = tuple(names)
        self._index = {n: i for i, n in enumerate(self.names)}
        self._values = torch.zeros(len(self.names), dtype=torch.int64,
                                   device=device)

    def add(self, name: str, value) -> None:
        """Counter ``name`` += ``value`` (an int, or a 0-d integer tensor on
        the device), on the device."""
        self._values[self._index[name]].add_(value)

    def maximum(self, name: str, value) -> None:
        """Counter ``name`` = max(itself, ``value``) (a 0-d integer tensor
        on the device), on the device."""
        v = self._values[self._index[name]]
        v.copy_(torch.maximum(v, value))

    def reset(self) -> None:
        self._values.zero_()

    def read(self) -> dict[str, int]:
        """Every counter's value (one host sync)."""
        return dict(zip(self.names, self._values.tolist()))


def active() -> DeviceCounters | None:
    """The counters in force on this thread, or None."""
    return getattr(_state, "counters", None)


@contextlib.contextmanager
def counting(counters: DeviceCounters | None):
    """Put ``counters`` in force on this thread for the block (None: no
    counting)."""
    prev = active()
    _state.counters = counters
    try:
        yield counters
    finally:
        _state.counters = prev
