"""Volatile LRU-backed store.

Reference: hashgraph/inmem_store.go. Event/round/block caches are LRUs of
the configured size (small caches can evict live state — callers size
them above the working set, as the reference tests do); per-participant
indexes are rolling windows yielding TooLate when aged out.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..common import LRU, RollingIndex, StoreError, StoreErrType, is_store_err
from .block import Block
from .event import Event
from .participant_events import ParticipantEventsCache
from .root import Root, new_base_root
from .round_info import RoundInfo


class InmemStore:
    def __init__(self, participants: Dict[str, int], cache_size: int):
        self._cache_size = cache_size
        self._participants = participants
        self.event_cache = LRU(cache_size)
        self.round_cache = LRU(cache_size)
        self.block_cache = LRU(cache_size)
        self.consensus_cache = RollingIndex(cache_size)
        self.tot_consensus_events = 0
        self.participant_events_cache = ParticipantEventsCache(cache_size, participants)
        # Topologically-ordered per-participant Event-object windows
        # (same rolling cadence as the hash windows above): a creator's
        # events are inserted in self-parent-chain order, so each
        # window is sorted by topological index and `Core.diff` can
        # answer a gossip pull as an O(Δ) merge over delta suffixes
        # instead of a get_event per hash plus a global re-sort.
        self._event_obj_windows: Dict[str, RollingIndex] = {
            pk: RollingIndex(cache_size) for pk in participants
        }
        self.roots: Dict[str, Root] = {pk: new_base_root() for pk in participants}
        self._last_round = -1
        self._last_committed_block = -1
        # Equivocation evidence (hashgraph/health.py): forensic
        # records, deduped, deliberately NOT cleared by reset() — a
        # fork proof must survive a fast-forward.
        self._fork_evidence: List[dict] = []
        self._fork_keys: set = set()

    def cache_size(self) -> int:
        return self._cache_size

    def participants(self) -> Dict[str, int]:
        return self._participants

    def get_event(self, key: str) -> Event:
        res, ok = self.event_cache.get(key)
        if not ok:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, key)
        return res

    def has_event(self, key: str) -> bool:
        # get (not contains): a membership hit must refresh LRU
        # recency exactly like the get_event probe it replaces, or
        # hot ancestors checked as duplicates age out early.
        _, ok = self.event_cache.get(key)
        return ok

    def set_event(self, event: Event) -> None:
        key = event.hex()
        win = self._event_obj_windows.get(event.creator())
        if win is None:
            win = RollingIndex(self._cache_size)
            self._event_obj_windows[event.creator()] = win
        if event.index() > win.last_index:
            # Genuinely new for this creator: advances both windows
            # (still raises SkippedIndex on a gap, like the reference).
            self.participant_events_cache.add(event.creator(), key, event.index())
            win.add(event, event.index())
        else:
            # Re-store of an index the windows already passed:
            # coordinate back-propagation and round-received marking
            # re-call set_event on old events, and once the LRU event
            # cache has evicted one, keying this branch off LRU
            # membership (the previous behavior) mis-reads the re-store
            # as new and dies on PassedIndex — which aborts an insert
            # HALFWAY (event in the window, caller's head/seq never
            # updated) and wedges the node. The windows are the source
            # of truth for per-creator indexes: an identical hash at
            # the index is an idempotent refresh, a different one is a
            # genuine fork and still raises.
            try:
                existing = self.participant_events_cache.get_item(
                    event.creator(), event.index())
            except StoreError as err:
                if not is_store_err(err, StoreErrType.TOO_LATE):
                    raise
                # Aged out of the rolling window: the window can no
                # longer vouch for which hash lived at this index, so
                # only a hash we have already stored is an idempotent
                # refresh — an unknown hash at a passed index is
                # indistinguishable from a fork and must not be
                # silently absorbed (FileStore falls back to its db
                # for the authoritative answer).
                _, known = self.event_cache.get(key)
                if not known:
                    raise StoreError(
                        StoreErrType.PASSED_INDEX, key) from err
                existing = key
            if existing != key:
                raise StoreError(StoreErrType.PASSED_INDEX, key)
        self.event_cache.add(key, event)

    def participant_events(self, participant: str, skip: int) -> List[str]:
        return self.participant_events_cache.get(participant, skip)

    def participant_event(self, participant: str, index: int) -> str:
        return self.participant_events_cache.get_item(participant, index)

    def participant_window(self, participant: str):
        return self.participant_events_cache.window(participant)

    def participant_event_objects(self, participant: str, skip: int) -> List[Event]:
        win = self._event_obj_windows.get(participant)
        if win is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, participant)
        return win.get(skip)

    def last_from(self, participant: str) -> Tuple[str, bool]:
        last = self.participant_events_cache.get_last(participant)
        is_root = False
        if last == "":
            root = self.roots.get(participant)
            if root is not None:
                last = root.x
                is_root = True
            else:
                raise StoreError(StoreErrType.NO_ROOT, participant)
        return last, is_root

    def known(self) -> Dict[int, int]:
        return self.participant_events_cache.known()

    def consensus_events(self) -> List[str]:
        window, _ = self.consensus_cache.get_last_window()
        return list(window)

    def consensus_events_count(self) -> int:
        return self.tot_consensus_events

    def add_consensus_event(self, key: str) -> None:
        self.consensus_cache.add(key, self.tot_consensus_events)
        self.tot_consensus_events += 1

    def get_round(self, r: int) -> RoundInfo:
        res, ok = self.round_cache.get(r)
        if not ok:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, str(r))
        return res

    def set_round(self, r: int, round_info: RoundInfo) -> None:
        self.round_cache.add(r, round_info)
        if r > self._last_round:
            self._last_round = r

    def last_round(self) -> int:
        return self._last_round

    def round_witnesses(self, r: int) -> List[str]:
        try:
            round_info = self.get_round(r)
        except StoreError:
            return []
        return round_info.witnesses()

    def round_events(self, r: int) -> int:
        try:
            round_info = self.get_round(r)
        except StoreError:
            return 0
        return len(round_info.events)

    def get_root(self, participant: str) -> Root:
        root = self.roots.get(participant)
        if root is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, participant)
        return root

    def get_block(self, rr: int) -> Block:
        res, ok = self.block_cache.get(rr)
        if not ok:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, str(rr))
        return res

    def set_block(self, block: Block) -> None:
        self.block_cache.add(block.round_received, block)

    def reset(self, roots: Dict[str, Root]) -> None:
        self.roots = roots
        self.event_cache = LRU(self._cache_size)
        self.round_cache = LRU(self._cache_size)
        self.consensus_cache = RollingIndex(self._cache_size)
        self.participant_events_cache.reset()
        self._event_obj_windows = {
            pk: RollingIndex(self._cache_size) for pk in self._participants
        }
        self._last_round = -1

    # Atomicity seam (store.py): nothing here outlives the process, so
    # batches are free — there is no durable state to tear.

    def begin_batch(self) -> None:
        pass

    def commit_batch(self) -> None:
        pass

    def rollback_batch(self) -> None:
        pass

    def last_committed_block(self) -> int:
        return self._last_committed_block

    def set_last_committed_block(self, rr: int) -> None:
        if rr > self._last_committed_block:
            self._last_committed_block = rr

    def capacity_stats(self) -> dict:
        """Capacity-plane sizing (docs/observability.md "Capacity"):
        row counts + retained-byte estimates per component, and the
        cache hit/miss/eviction counters. Byte estimates sample a
        bounded number of entries (telemetry/capacity.sampled_bytes)
        so a 100k-event cache costs O(256) per scrape. Event objects
        in the per-creator windows are the SAME objects as the event
        LRU's values, so the windows bill only pointer slots — RSS is
        the ground truth, the split is attribution."""
        from ..telemetry.capacity import (
            DICT_ENTRY_BYTES, event_bytes, sampled_bytes, str_bytes)

        ev_rows = len(self.event_cache)
        comps = {
            "store_event_log": {
                "rows": ev_rows,
                "bytes": sampled_bytes(
                    self.event_cache._items.values(), ev_rows,
                    event_bytes) + ev_rows * DICT_ENTRY_BYTES,
            },
            "store_rounds": {
                "rows": len(self.round_cache),
                "bytes": sampled_bytes(
                    self.round_cache._items.values(),
                    len(self.round_cache),
                    lambda ri: 200 + 180 * len(
                        getattr(ri, "events", ()) or ())),
            },
            "store_blocks": {
                "rows": len(self.block_cache),
                "bytes": sampled_bytes(
                    self.block_cache._items.values(),
                    len(self.block_cache),
                    lambda b: 400 + sum(
                        len(t) + 60
                        for t in (getattr(b, "transactions", None)
                                  or []))),
            },
        }
        # Hash windows: 66-char hex strings per row; object windows
        # and the consensus ring share objects already billed above,
        # so they carry pointer-slot costs only.
        hash_rows = hash_bytes = 0
        win_evicted = 0
        for pe in self.participant_events_cache.participant_events.values():
            hash_rows += len(pe.items)
            win_evicted += pe.evicted
        hash_bytes = hash_rows * (str_bytes("0x" + "0" * 64) + 8)
        obj_rows = 0
        for win in self._event_obj_windows.values():
            obj_rows += len(win.items)
            win_evicted += win.evicted
        comps["store_participant_windows"] = {
            "rows": hash_rows + obj_rows,
            "bytes": hash_bytes + obj_rows * 8,
        }
        comps["store_consensus_window"] = {
            "rows": len(self.consensus_cache.items),
            "bytes": len(self.consensus_cache.items)
            * (str_bytes("0x" + "0" * 64) + 8),
        }
        if self._fork_evidence:
            comps["store_fork_evidence"] = {
                "rows": len(self._fork_evidence),
                "bytes": len(self._fork_evidence) * 512,
            }
        return {
            "components": comps,
            "caches": {
                "store_events": {
                    "hits": self.event_cache.hits,
                    "misses": self.event_cache.misses,
                    "evictions": self.event_cache.evictions,
                },
                "participant_windows": {"evictions": win_evicted},
            },
        }

    def add_fork_evidence(self, record: dict) -> bool:
        from .health import fork_evidence_key

        key = fork_evidence_key(record)
        if key in self._fork_keys:
            return False
        self._fork_keys.add(key)
        self._fork_evidence.append(record)
        return True

    def fork_evidence(self) -> List[dict]:
        return list(self._fork_evidence)

    def close(self) -> None:
        pass
