"""The 20-method store plugin boundary.

Reference: hashgraph/store.go:3-25. This seam is where alternative
backends slot in: `InmemStore` (volatile, LRU-backed), `FileStore`
(persistent write-through, the BadgerStore analog), and the TPU-side
mirrored store used by the batched engine.

Error convention: methods raise StoreError (common/errors.py) rather
than returning Go-style (value, error) pairs.

Atomicity seam (docs/robustness.md "Crash recovery"): writers group
related mutations — one sync batch's event inserts, one consensus
pass's round/block writes — between `begin_batch()` and
`commit_batch()`. A durable store makes the group one transaction
(all-or-nothing under kill -9); volatile stores treat the calls as
no-ops. `last_committed_block` is the durable delivered-block anchor:
the node advances it after a block reaches the application, and
`Hashgraph.bootstrap` suppresses redelivery at or below it.
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Tuple

from .block import Block
from .event import Event
from .root import Root
from .round_info import RoundInfo


class Store(Protocol):
    def cache_size(self) -> int: ...

    def participants(self) -> Dict[str, int]: ...

    def get_event(self, key: str) -> Event: ...

    def has_event(self, key: str) -> bool: ...

    def set_event(self, event: Event) -> None: ...

    def participant_events(self, participant: str, skip: int) -> List[str]: ...

    def participant_event(self, participant: str, index: int) -> str: ...

    def participant_window(self, participant: str) -> Tuple[List[str], int]:
        """Snapshot of the participant's rolling hash window as
        (items, last_index) — one probe resolves a whole batch of wire
        coordinates positionally (Hashgraph.read_wire_batch)."""
        ...

    def participant_event_objects(self, participant: str, skip: int) -> List[Event]:
        """Events with index > skip, topologically ordered — the O(Δ)
        suffix feed for Core.diff's merge."""
        ...

    def last_from(self, participant: str) -> Tuple[str, bool]:
        """Returns (last event hash or root.X, is_root)."""
        ...

    def known(self) -> Dict[int, int]: ...

    def consensus_events(self) -> List[str]: ...

    def consensus_events_count(self) -> int: ...

    def add_consensus_event(self, key: str) -> None: ...

    def get_round(self, r: int) -> RoundInfo: ...

    def set_round(self, r: int, round_info: RoundInfo) -> None: ...

    def last_round(self) -> int: ...

    def round_witnesses(self, r: int) -> List[str]: ...

    def round_events(self, r: int) -> int: ...

    def get_root(self, participant: str) -> Root: ...

    def get_block(self, rr: int) -> Block: ...

    def set_block(self, block: Block) -> None: ...

    def reset(self, roots: Dict[str, Root]) -> None: ...

    def begin_batch(self) -> None:
        """Open (or nest into) an atomic write batch; writes until the
        matching commit_batch become durable together. No-op for
        volatile stores."""
        ...

    def commit_batch(self) -> None: ...

    def rollback_batch(self) -> None:
        """Discard the open batch's durable writes (crash-equivalent).
        The volatile hot layer is NOT rewound — callers abandon it
        (restart, engine rebuild) after a rollback."""
        ...

    def last_committed_block(self) -> int:
        """Round of the last block known delivered to the application
        (-1 when none) — the exactly-once redelivery anchor."""
        ...

    def set_last_committed_block(self, rr: int) -> None: ...

    def add_fork_evidence(self, record: dict) -> bool:
        """Persist one equivocation evidence record (two signed events
        by one creator at one index — hashgraph/health.py). Deduped on
        (creator, index, forged-hash); returns True when the record is
        new. Durable stores keep evidence across restarts and resets —
        it is forensic state, not consensus state."""
        ...

    def fork_evidence(self) -> List[dict]: ...

    def close(self) -> None: ...
