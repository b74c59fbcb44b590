"""Paged KV-cache management on the buddy arena (paper §III-C memory pool).

The paper pools GPU memory with a buddy allocator to amortize allocation
cost of pull tasks.  The serving analogue (DESIGN.md §2): a
page-granular KV arena.  Physical storage is a preallocated stacked cache;
the buddy allocator hands out *page runs* (power-of-two page counts) per
request, giving vLLM-style utilization with O(log) alloc/free and natural
coalescing when requests retire.

Accounting is in pages (min_block = 1 page); ``page_bytes`` converts to
real HBM bytes for capacity planning against the per-device budget.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.memory import BuddyAllocator, OutOfMemory


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length() if x > 1 else 1


@dataclass
class PageTable:
    request_id: int
    offset: int          # first page index in the arena
    n_pages: int         # power-of-two run length
    used_tokens: int = 0


class PagedKVArena:
    """Page-run allocator for request KV caches.

    ``n_pages`` total pages of ``page_tokens`` tokens each.  A request
    asks for enough pages to hold its max sequence; growth re-allocates
    the next power-of-two run (amortized O(1) moves, like vector
    doubling — on the card this is a device-to-device copy the scheduler
    overlaps with decode).
    """

    def __init__(self, n_pages: int, page_tokens: int, kv_bytes_per_token: int):
        self.n_pages = _pow2_ceil(n_pages)
        self.page_tokens = page_tokens
        self.kv_bytes_per_token = kv_bytes_per_token
        self._buddy = BuddyAllocator(self.n_pages, min_block=1)
        self.tables: dict[int, PageTable] = {}
        self.grows = 0

    @property
    def page_bytes(self) -> int:
        return self.page_tokens * self.kv_bytes_per_token

    def pages_for(self, tokens: int) -> int:
        return _pow2_ceil(-(-tokens // self.page_tokens))

    def admit(self, request_id: int, prompt_tokens: int,
              reserve_tokens: int = 0) -> PageTable:
        """Allocate a page run for a new request; raises OutOfMemory when
        the arena cannot host it (the engine queues the request)."""
        n = self.pages_for(max(1, prompt_tokens + reserve_tokens))
        off = self._buddy.allocate(n)
        pt = PageTable(request_id, off, n, used_tokens=prompt_tokens)
        self.tables[request_id] = pt
        return pt

    def extend(self, request_id: int, new_tokens: int = 1) -> PageTable:
        """Account token growth; doubles the page run when it overflows.

        The grow is **free-then-allocate**: the arena is accounting-only
        (physical KV storage is the engine's stacked cache — there is no
        data in the pages to preserve), so the old run is released first
        and its pages coalesce with their buddies before the doubled run
        is requested.  A near-full arena that can only fit the new run
        *after* coalescing therefore succeeds instead of raising a
        spurious :class:`OutOfMemory`.  When even the coalesced arena
        cannot host the doubled run, the original run is re-taken (its
        pages are still free — the re-allocation cannot fail) and
        ``OutOfMemory`` propagates with the table intact, so the engine
        can preempt a request rather than crash mid-tick.
        """
        pt = self.tables[request_id]
        pt.used_tokens += new_tokens
        if pt.used_tokens > pt.n_pages * self.page_tokens:
            new_n = _pow2_ceil(self.pages_for(pt.used_tokens))
            self._buddy.free(pt.offset)
            try:
                new_off = self._buddy.allocate(new_n)
            except OutOfMemory:
                # roll back: a run of the old size still fits (we just
                # freed one), so the accounting stays consistent and the
                # caller decides who to preempt
                pt.offset = self._buddy.allocate(pt.n_pages)
                pt.used_tokens -= new_tokens
                raise
            pt.offset, pt.n_pages = new_off, new_n
            self.grows += 1
        return pt

    def release(self, request_id: int) -> None:
        pt = self.tables.pop(request_id)
        self._buddy.free(pt.offset)

    def bytes_for(self, request_id: int) -> int:
        """HBM bytes the request's page run pins (allocated, not just
        used — the span a KV migration between bins must move)."""
        pt = self.tables[request_id]
        return pt.n_pages * self.page_bytes

    # -- capacity stats ---------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self._buddy.bytes_in_use

    @property
    def utilization(self) -> float:
        used_tok = sum(t.used_tokens for t in self.tables.values())
        alloc_tok = self.pages_in_use * self.page_tokens
        return used_tok / alloc_tok if alloc_tok else 0.0

    def fragmentation(self) -> float:
        return self._buddy.fragmentation()

    def can_admit(self, tokens: int) -> bool:
        return self._buddy.largest_free_block() >= self.pages_for(tokens)
