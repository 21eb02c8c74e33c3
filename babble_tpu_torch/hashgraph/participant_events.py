"""Per-participant rolling windows of event hashes.

Reference: hashgraph/caches.go:30-131 (ParticipantEventsCache) — a
RollingIndex per participant keyed by creator-sequence index; `known()`
reports the last index per participant id.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..common import RollingIndex, StoreError, StoreErrType


class ParticipantEventsCache:
    def __init__(self, size: int, participants: Dict[str, int]):
        self.size = size
        self.participants = participants
        self.participant_events: Dict[str, RollingIndex] = {
            pk: RollingIndex(size) for pk in participants
        }

    def get(self, participant: str, skip_index: int) -> List[str]:
        pe = self.participant_events.get(participant)
        if pe is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, participant)
        return pe.get(skip_index)

    def get_item(self, participant: str, index: int) -> str:
        pe = self.participant_events.get(participant)
        if pe is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, participant)
        return pe.get_item(index)

    def window(self, participant: str) -> Tuple[List[str], int]:
        """The live (items, last_index) rolling window — one snapshot
        per creator lets a batch resolve from it positionally instead
        of paying a get_item round trip per wire coordinate."""
        pe = self.participant_events.get(participant)
        if pe is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, participant)
        return pe.get_last_window()

    def get_last(self, participant: str) -> str:
        pe = self.participant_events.get(participant)
        if pe is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, participant)
        window, _ = pe.get_last_window()
        if not window:
            return ""
        return window[-1]

    def add(self, participant: str, hash_: str, index: int) -> None:
        pe = self.participant_events.get(participant)
        if pe is None:
            pe = RollingIndex(self.size)
            self.participant_events[participant] = pe
        pe.add(hash_, index)

    def known(self) -> Dict[int, int]:
        return {
            self.participants[p]: evs.get_last_window()[1]
            for p, evs in self.participant_events.items()
        }

    def reset(self) -> None:
        self.participant_events = {pk: RollingIndex(self.size) for pk in self.participants}
