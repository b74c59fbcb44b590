"""Serving substrate: paged KV arena + continuous-batching engine.

Public surface: :class:`ServingEngine` with
``submit()/poll()/step()``, the frozen :class:`Request` lifecycle record
(``queued → prefill → decoding → done | preempted`` — the ``LIFECYCLE``
states), and the per-bin :class:`PagedKVArena`.  The engine drives the
event-driven scheduler loop (``repro_torch.sched`` ``SchedulerUpdate`` /
``Scheduler.update``) for admission placement, KV-locality-aware decode
placement, and replica join/drain; see docs/scheduling.md "Online
scheduling".
"""
from .engine import (
    DECODING,
    DONE,
    LIFECYCLE,
    PREEMPTED,
    PREFILL,
    QUEUED,
    Request,
    ServingEngine,
)
from .kv_cache import PagedKVArena, PageTable

__all__ = [
    "Request", "ServingEngine", "PagedKVArena", "PageTable",
    "LIFECYCLE", "QUEUED", "PREFILL", "DECODING", "DONE", "PREEMPTED",
]
