"""Sliding window of items keyed by a monotone integer index.

Same contract as the reference RollingIndex
(reference common/rolling_index.go:3-77): capacity 2*size; when full it
rolls by dropping the oldest `size` items; `get(skip)` returns items with
index > skip or raises TooLate once the window has rolled past;
`add` enforces contiguous, strictly increasing indexes (PassedIndex /
SkippedIndex errors).
"""

from __future__ import annotations

from typing import Any, List, Tuple

from .errors import StoreError, StoreErrType


class RollingIndex:
    def __init__(self, size: int):
        self.size = size
        self.last_index = -1
        self.items: List[Any] = []
        # Items aged out by rolls — the participant-window eviction
        # signal the capacity plane exports (docs/observability.md
        # "Capacity"): a window that rolls faster than peers pull is
        # the TooLate churn source.
        self.evicted = 0

    def get_last_window(self) -> Tuple[List[Any], int]:
        return self.items, self.last_index

    def get(self, skip_index: int) -> List[Any]:
        """Items with index > skip_index; TooLate if they have aged out."""
        if skip_index > self.last_index:
            return []
        cached = len(self.items)
        oldest_cached = self.last_index - cached + 1
        if skip_index + 1 < oldest_cached:
            raise StoreError(StoreErrType.TOO_LATE, str(skip_index))
        start = skip_index - oldest_cached + 1
        return list(self.items[start:])

    def get_item(self, index: int) -> Any:
        n = len(self.items)
        oldest_cached = self.last_index - n + 1
        if index < oldest_cached:
            raise StoreError(StoreErrType.TOO_LATE, str(index))
        found = index - oldest_cached
        if found >= n:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, str(index))
        return self.items[found]

    def add(self, item: Any, index: int) -> None:
        if index <= self.last_index:
            raise StoreError(StoreErrType.PASSED_INDEX, str(index))
        if self.last_index >= 0 and index > self.last_index + 1:
            raise StoreError(StoreErrType.SKIPPED_INDEX, str(index))
        if len(self.items) >= 2 * self.size:
            self._roll()
        self.items.append(item)
        self.last_index = index

    def _roll(self) -> None:
        self.evicted += min(self.size, len(self.items))
        self.items = self.items[self.size:]
