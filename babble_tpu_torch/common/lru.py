"""Fixed-size LRU cache.

Same contract as the reference's hashicorp-derived LRU
(reference common/lru.go:11-156): non-thread-safe, `add` returns True when
an eviction occurred, optional eviction callback. Backed by an
OrderedDict instead of a linked list — idiomatic Python, identical
observable behavior.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Optional


class LRU:
    def __init__(self, size: int, on_evict: Optional[Callable[[Any, Any], None]] = None):
        self.size = size
        self.on_evict = on_evict
        self._items: OrderedDict = OrderedDict()
        # Cache-efficiency accounting (docs/observability.md
        # "Capacity"): plain unguarded ints — GIL-atomic increments,
        # read at scrape time only, so churn vs growth is attributable
        # without a lock on the hot path.
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def add(self, key, value) -> bool:
        """Insert/update; most-recently-used at the end. True if evicted."""
        if key in self._items:
            self._items.move_to_end(key)
            self._items[key] = value
            return False
        self._items[key] = value
        if len(self._items) > self.size:
            old_key, old_val = self._items.popitem(last=False)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old_key, old_val)
            return True
        return False

    def get(self, key):
        """Returns (value, True) and refreshes recency, or (None, False)."""
        if key in self._items:
            self.hits += 1
            self._items.move_to_end(key)
            return self._items[key], True
        self.misses += 1
        return None, False

    def contains(self, key) -> bool:
        return key in self._items

    def peek(self, key):
        if key in self._items:
            return self._items[key], True
        return None, False

    def remove(self, key) -> bool:
        if key in self._items:
            del self._items[key]
            return True
        return False

    def keys(self):
        """Oldest to newest."""
        return list(self._items.keys())

    def purge(self):
        if self.on_evict is not None:
            for k, v in list(self._items.items()):
                self.on_evict(k, v)
        self._items.clear()

    def __len__(self) -> int:
        return len(self._items)


class Memo:
    """Bounded memo table for pure, recomputable functions (ancestry,
    strongly-see, rounds). Implements only the get/add/contains subset
    of LRU's surface (no eviction signal, no on_evict), as a flat dict
    with clear-on-overflow: memo hits sat on the host consensus hot
    path (1.8M lookups per RunConsensus at n=16), where LRU's per-hit
    move_to_end cost bought nothing — evicting everything and
    recomputing on demand is cheaper than tracking recency."""

    __slots__ = ("size", "_items")

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("memo: must provide a positive size")
        self.size = size
        self._items: dict = {}

    def add(self, key, value) -> bool:
        if len(self._items) >= self.size and key not in self._items:
            self._items.clear()
        self._items[key] = value
        return False

    def get(self, key):
        v = self._items.get(key, _MISS)
        if v is _MISS:
            return None, False
        return v, True

    def contains(self, key) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)


_MISS = object()
