"""Buddy-allocator memory pool (paper §III-C, Knowlton 1965).

The paper keeps a buddy-allocator pool per GPU to amortize ``cudaMalloc``
cost for pull tasks.  PyTorch's caching allocator owns device memory, so the two places a
user-level allocator genuinely earns its keep are (DESIGN.md §2):

* **KV-cache paging** for serving — `serving/kv_cache.py` carves page
  blocks for requests out of a pre-allocated arena, vLLM-style; and
* **HBM budget planning** for the dry-run — modelling whether a cell's
  live set fits per-device HBM before compile.

The allocator is the classic power-of-two buddy system: blocks split
recursively on allocate, buddies coalesce on free.  O(log levels) per op.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

__all__ = ["BuddyAllocator", "DeviceArena", "OutOfMemory"]


class OutOfMemory(Exception):
    pass


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 0 else 1


class BuddyAllocator:
    """Classic buddy allocator over a byte range ``[0, capacity)``.

    ``capacity`` and ``min_block`` must be powers of two.  ``allocate``
    returns a byte offset; ``free`` takes that offset.  Thread-safe.
    """

    def __init__(self, capacity: int, min_block: int = 256):
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        if min_block & (min_block - 1):
            raise ValueError("min_block must be a power of two")
        if min_block > capacity:
            raise ValueError("min_block may not exceed capacity")
        self.capacity = capacity
        self.min_block = min_block
        self._levels = (capacity // min_block).bit_length()  # #distinct sizes
        # free lists per level: level 0 = whole arena, level L = min blocks
        self._free: list[set[int]] = [set() for _ in range(self._levels)]
        self._free[0].add(0)
        self._alloc: dict[int, int] = {}  # offset -> level
        self._lock = threading.Lock()
        self._in_use = 0
        self.peak_in_use = 0   # high-water bytes_in_use over the lifetime
        self.n_allocs = 0
        self.n_splits = 0
        self.n_merges = 0

    # -- helpers --------------------------------------------------------
    def _level_size(self, level: int) -> int:
        return self.capacity >> level

    def _level_for(self, size: int) -> int:
        size = max(_next_pow2(size), self.min_block)
        if size > self.capacity:
            raise OutOfMemory(f"request {size} exceeds capacity {self.capacity}")
        return (self.capacity // size).bit_length() - 1

    # -- API -------------------------------------------------------------
    def allocate(self, size: int) -> int:
        """Return the byte offset of a block of at least ``size`` bytes."""
        if size <= 0:
            raise ValueError("size must be positive")
        want = self._level_for(size)
        with self._lock:
            lvl = want
            while lvl >= 0 and not self._free[lvl]:
                lvl -= 1
            if lvl < 0:
                raise OutOfMemory(
                    f"no block for {size} B (in use {self._in_use}/{self.capacity})")
            off = self._free[lvl].pop()
            # split down to the wanted level
            while lvl < want:
                lvl += 1
                buddy = off + self._level_size(lvl)
                self._free[lvl].add(buddy)
                self.n_splits += 1
            self._alloc[off] = want
            self._in_use += self._level_size(want)
            if self._in_use > self.peak_in_use:
                self.peak_in_use = self._in_use
            self.n_allocs += 1
            return off

    def free(self, offset: int) -> None:
        with self._lock:
            try:
                lvl = self._alloc.pop(offset)
            except KeyError:
                raise ValueError(f"free of unallocated offset {offset}") from None
            self._in_use -= self._level_size(lvl)
            # coalesce with buddy while possible
            while lvl > 0:
                size = self._level_size(lvl)
                buddy = offset ^ size
                if buddy in self._free[lvl]:
                    self._free[lvl].remove(buddy)
                    offset = min(offset, buddy)
                    lvl -= 1
                    self.n_merges += 1
                else:
                    break
            self._free[lvl].add(offset)

    # -- stats -------------------------------------------------------------
    @property
    def bytes_in_use(self) -> int:
        return self._in_use

    @property
    def bytes_free(self) -> int:
        return self.capacity - self._in_use

    def largest_free_block(self) -> int:
        with self._lock:
            for lvl in range(self._levels):
                if self._free[lvl]:
                    return self._level_size(lvl)
        return 0

    def fragmentation(self) -> float:
        """1 - largest_free/total_free (0 = unfragmented)."""
        free = self.bytes_free
        if free == 0:
            return 0.0
        return 1.0 - self.largest_free_block() / free

    def check_invariants(self) -> None:
        """Debug/property-test hook: free+used partitions the arena and no
        free block overlaps another."""
        with self._lock:
            spans = []
            for lvl, offs in enumerate(self._free):
                size = self._level_size(lvl)
                spans += [(o, o + size) for o in offs]
            for off, lvl in self._alloc.items():
                spans.append((off, off + self._level_size(lvl)))
            spans.sort()
            cursor = 0
            for a, b in spans:
                assert a == cursor, f"gap/overlap at {a} (expected {cursor})"
                cursor = b
            assert cursor == self.capacity, "arena not fully covered"


@dataclass
class DeviceArena:
    """A per-device buddy arena (paper: "memory pool for each GPU").

    Used by the executor to model per-device residency (placement load
    metric) and by serving for KV-cache page management.
    """

    device: object
    capacity: int
    min_block: int = 4096
    allocator: BuddyAllocator = field(init=False)

    def __post_init__(self):
        self.allocator = BuddyAllocator(self.capacity, self.min_block)

    def allocate(self, size: int) -> int:
        return self.allocator.allocate(size)

    def free(self, offset: int) -> None:
        self.allocator.free(offset)

    @property
    def bytes_in_use(self) -> int:
        return self.allocator.bytes_in_use

    @property
    def peak_bytes(self) -> int:
        """High-water ``bytes_in_use`` — never exceeds ``capacity`` (the
        allocator raises :class:`OutOfMemory` instead), which is how the
        executor proves it honored a bin's ``memory_bytes`` budget."""
        return self.allocator.peak_in_use
