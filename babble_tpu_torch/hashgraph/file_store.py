"""Persistent write-through store: the BadgerStore analog on sqlite3.

Reference hashgraph/badger_store.go:28-386. Layering matches the
reference: an InmemStore is the hot cache; every write also lands in
the database; reads fall back to the database when the cache misses
(LRU eviction / fresh restart). The topologically-keyed event log
(`topo_%09d` keys there, an autoincrement rowid-ordered table here)
feeds `Hashgraph.bootstrap()` replay.

sqlite3 is the idiomatic stand-in for the embedded Badger KV store: in
the standard library, single-file, crash-safe.

Crash consistency (docs/robustness.md "Crash recovery"): the database
runs in WAL mode and writes are grouped into explicit transactions via
the Store batch seam (`begin_batch`/`commit_batch`/`rollback_batch`).
One sync batch's event inserts, and one consensus pass's round/witness/
block writes, each land atomically — a process killed at any
instruction leaves either all of a batch or none of it visible after
reload. A `meta` table carries the schema version, the durable
delivered-block anchor (`last_committed_block`, exactly-once app
delivery across restarts) and the consensus anchor (the highest round
written by a COMPLETE consensus pass; rounds above it found at load
time are a torn tail from a pre-transactional writer and are
discarded)."""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..common import StoreError, StoreErrType, is_store_err
from ..gojson import Timestamp, ZERO_TIME
from .block import Block
from .event import Event, EventCoordinates, event_from_json_obj
from .inmem_store import InmemStore
from .root import Root, new_base_root
from .round_info import RoundInfo, RoundEvent, Trilean

SCHEMA_VERSION = 2

# store_sync policy -> sqlite synchronous level. In WAL mode:
#   always: fsync the WAL on every commit (survives power loss);
#   batch:  fsync only at WAL checkpoints (survives process kill —
#           commits are atomic either way, WAL frames are checksummed);
#   off:    no fsyncs at all (fastest; still atomic under kill -9
#           because the OS page cache survives the process).
_SYNC_PRAGMA = {"always": "FULL", "batch": "NORMAL", "off": "OFF"}


def _annotations_to_json(ev: Event) -> str:
    """Runtime annotations that are NOT part of the canonical Go-JSON
    event bytes (unexported in the reference): wire coordinates, the
    per-participant ancestry vectors, and consensus marks. Without
    them an event served from the sqlite fallback after LRU eviction
    is unusable as a parent (empty last_ancestors crashes coordinate
    init) and silently breaks strongly_see (zip over an empty vector
    counts zero)."""
    return json.dumps({
        "w": [ev.body.self_parent_index, ev.body.other_parent_creator_id,
              ev.body.other_parent_index, ev.body.creator_id],
        "la": [[c.index, c.hash] for c in ev.last_ancestors],
        "fd": [[c.index, c.hash] for c in ev.first_descendants],
        "rr": ev.round_received,
        "cts": ev.consensus_timestamp.ns,
    })


def _annotations_from_json(ev: Event, data: Optional[str]) -> Event:
    if not data:
        return ev  # legacy row (pre-annotation schema)
    obj = json.loads(data)
    w = obj.get("w")
    if w:
        ev.set_wire_info(w[0], w[1], w[2], w[3])
    ev.last_ancestors = [
        EventCoordinates(hash=h, index=i) for i, h in obj.get("la", [])]
    ev.first_descendants = [
        EventCoordinates(hash=h, index=i) for i, h in obj.get("fd", [])]
    ev.round_received = obj.get("rr")
    cts = obj.get("cts")
    if cts is not None and cts != ZERO_TIME.ns:
        ev.consensus_timestamp = Timestamp(cts)
    return ev


def _round_to_json(info: RoundInfo) -> str:
    return json.dumps(
        {
            "Events": {
                x: {"Witness": e.witness, "Famous": int(e.famous)}
                for x, e in info.events.items()
            }
        }
    )


def _round_from_json(data: str) -> RoundInfo:
    obj = json.loads(data)
    info = RoundInfo()
    for x, e in (obj.get("Events") or {}).items():
        info.events[x] = RoundEvent(
            witness=e["Witness"], famous=Trilean(e["Famous"])
        )
    return info


class FileStore:
    """20-method Store (hashgraph/store.go:3-25) with durability."""

    def __init__(
        self,
        participants: Dict[str, int],
        cache_size: int,
        path: str,
        create: bool = True,
        sync: str = "batch",
    ):
        if sync not in _SYNC_PRAGMA:
            raise ValueError(f"unknown store_sync policy {sync!r}")
        self.path = path
        self.sync = sync
        self._lock = threading.RLock()
        self._closed = False
        # Batch protocol state: while depth > 0 per-statement commits
        # are suppressed and every write joins one sqlite transaction,
        # committed (or rolled back) at the outermost commit_batch.
        self._batch_depth = 0
        self._rounds_dirty = False
        # Durable-commit observability (fsync proxy: wall time of the
        # sqlite COMMIT, which is where the WAL write+fsync happens).
        self.fsync_count = 0
        self.fsync_total_ns = 0
        self.fsync_last_ns = 0
        from ..telemetry import get_registry

        _reg = get_registry()
        self._m_fsync = _reg.histogram(
            "babble_store_fsync_seconds",
            "Store batch-commit wall seconds (WAL write + fsync)",
            sync=sync)
        self._m_fsyncs = _reg.counter(
            "babble_store_fsyncs_total",
            "Store batch commits (WAL write + fsync)", sync=sync)
        exists = os.path.exists(path)
        if not exists and not create:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, path)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(f"PRAGMA synchronous={_SYNC_PRAGMA[sync]}")
        legacy = exists and not self._has_meta_table()
        self._init_schema()

        if exists and create:
            # A populated database must be reopened with load(): the
            # create path would overwrite persisted roots with fresh
            # base roots while leaving the events table — an empty
            # cache over a non-empty log whose last_from/known disagree
            # with disk until a bootstrap replay.
            row = self._db.execute("SELECT COUNT(*) FROM events").fetchone()
            if row and row[0]:
                self._db.close()
                raise ValueError(
                    f"{path} already contains events; use FileStore.load()"
                )
        if exists and not create:
            participants = self._db_participants()
            self._recover(legacy)
        elif participants:
            self._db_set_participants(participants)
        self.inmem = InmemStore(participants, cache_size)
        self.inmem.set_last_committed_block(
            self._get_meta_int("last_committed_block", -1))
        self._participants = participants

    @classmethod
    def load(cls, cache_size: int, path: str, sync: str = "batch") -> "FileStore":
        """Reopen an existing store, reading participants from disk —
        reference LoadBadgerStore (badger_store.go:54-83)."""
        return cls({}, cache_size, path, create=False, sync=sync)

    def _has_meta_table(self) -> bool:
        row = self._db.execute(
            "SELECT 1 FROM sqlite_master WHERE type='table' AND name='meta'"
        ).fetchone()
        return row is not None

    def _init_schema(self) -> None:
        with self._lock:
            self._db.executescript(
                """
                CREATE TABLE IF NOT EXISTS events (
                    seq INTEGER PRIMARY KEY AUTOINCREMENT,
                    hex TEXT UNIQUE NOT NULL,
                    creator TEXT NOT NULL,
                    idx INTEGER NOT NULL,
                    topo INTEGER NOT NULL,
                    data TEXT NOT NULL,
                    annotations TEXT
                );
                CREATE INDEX IF NOT EXISTS events_by_participant
                    ON events (creator, idx);
                CREATE TABLE IF NOT EXISTS rounds (
                    idx INTEGER PRIMARY KEY, data TEXT NOT NULL);
                CREATE TABLE IF NOT EXISTS blocks (
                    rr INTEGER PRIMARY KEY, data TEXT NOT NULL);
                CREATE TABLE IF NOT EXISTS participants (
                    pubkey TEXT PRIMARY KEY, id INTEGER NOT NULL);
                CREATE TABLE IF NOT EXISTS roots (
                    pubkey TEXT PRIMARY KEY, data TEXT NOT NULL);
                CREATE TABLE IF NOT EXISTS meta (
                    key TEXT PRIMARY KEY, value TEXT NOT NULL);
                CREATE TABLE IF NOT EXISTS forks (
                    creator TEXT NOT NULL,
                    idx INTEGER NOT NULL,
                    forged TEXT NOT NULL,
                    data TEXT NOT NULL,
                    PRIMARY KEY (creator, idx, forged));
                """
            )
            # Schema-v1 migration: the events table predates the
            # annotations column (CREATE IF NOT EXISTS won't add it).
            cols = [r[1] for r in self._db.execute(
                "PRAGMA table_info(events)").fetchall()]
            if "annotations" not in cols:
                self._db.execute(
                    "ALTER TABLE events ADD COLUMN annotations TEXT")
            self._db.execute(
                "INSERT OR IGNORE INTO meta VALUES ('schema_version', ?)",
                (str(SCHEMA_VERSION),),
            )
            self._db.commit()

    # -- meta / anchors ----------------------------------------------------

    def _get_meta_int(self, key: str, default: int) -> int:
        with self._lock:
            row = self._db.execute(
                "SELECT value FROM meta WHERE key = ?", (key,)
            ).fetchone()
        return int(row[0]) if row is not None else default

    def _set_meta(self, key: str, value: str) -> None:
        # Joins the open transaction when a batch is in flight.
        self._db.execute(
            "INSERT OR REPLACE INTO meta VALUES (?, ?)", (key, value))

    def schema_version(self) -> int:
        return self._get_meta_int("schema_version", 1)

    def _recover(self, legacy: bool) -> None:
        """Load-time torn-tail repair. Rounds (and blocks) above the
        consensus anchor were written by an interrupted, pre-
        transactional consensus pass — a complete pass commits its
        writes and the advanced anchor atomically, so anything beyond
        the anchor is by definition partial and is discarded; the
        events feeding it survive (their sync batches committed) and
        bootstrap's replay recomputes the decisions from scratch."""
        with self._lock:
            if legacy:
                # Database written before the meta table existed: trust
                # its rounds/blocks wholesale (they were written by a
                # graceful-shutdown-only workflow) and seed the anchors
                # from what is present.
                row = self._db.execute(
                    "SELECT COALESCE(MAX(idx), -1) FROM rounds").fetchone()
                self._set_meta("consensus_anchor", str(row[0]))
                row = self._db.execute(
                    "SELECT COALESCE(MAX(rr), -1) FROM blocks").fetchone()
                self._set_meta("last_committed_block", str(row[0]))
                self._db.commit()
                return
            anchor = self._get_meta_int("consensus_anchor", -1)
            cur = self._db.execute(
                "DELETE FROM rounds WHERE idx > ?", (anchor,))
            dropped = cur.rowcount
            dropped += self._db.execute(
                "DELETE FROM blocks WHERE rr > ?", (anchor,)).rowcount
            if dropped:
                self._db.commit()

    def consensus_anchor(self) -> int:
        return self._get_meta_int("consensus_anchor", -1)

    def last_committed_block(self) -> int:
        return self.inmem.last_committed_block()

    def set_last_committed_block(self, rr: int) -> None:
        """Durable delivered-block anchor: advanced by the node AFTER a
        block reached the app, so bootstrap can suppress redelivery of
        everything at or below it (exactly-once across restarts). If a
        batch is open the write rides in it — deferred durability is
        safe because the journal-keeping proxy dedupes redelivery of
        the (small) unmarked window."""
        if rr <= self.inmem.last_committed_block():
            return
        self.inmem.set_last_committed_block(rr)
        with self._lock:
            if self._closed:
                return
            self._set_meta("last_committed_block", str(rr))
            self._commit()

    # -- consensus health (docs/observability.md "Consensus health") ------

    def add_fork_evidence(self, record: dict) -> bool:
        """Equivocation proof, deduped on (creator, idx, forged hash).
        Joins an open batch (the insert that detected the fork runs
        inside a sync batch, whose commit makes the evidence durable
        even though the forged event itself is rejected). Survives
        reset() — evidence is forensic, not consensus state."""
        with self._lock:
            if self._closed:
                return False
            cur = self._db.execute(
                "INSERT OR IGNORE INTO forks VALUES (?, ?, ?, ?)",
                (record["creator"], record["index"], record["forged"],
                 json.dumps(record)),
            )
            fresh = cur.rowcount > 0
            if fresh:
                self._commit()
        return fresh

    def fork_evidence(self) -> List[dict]:
        with self._lock:
            rows = self._db.execute(
                "SELECT data FROM forks ORDER BY creator, idx").fetchall()
        return [json.loads(r[0]) for r in rows]

    def chain_state(self) -> Optional[dict]:
        """Persisted divergence-sentinel chain state (node/health.py),
        or None when never written. Stored next to the delivered-block
        anchor so the two advance atomically: a restarted node resumes
        its chain segment exactly where redelivery resumes blocks."""
        with self._lock:
            row = self._db.execute(
                "SELECT value FROM meta WHERE key = 'chain_state'"
            ).fetchone()
        return json.loads(row[0]) if row is not None else None

    def set_chain_state(self, state: dict) -> None:
        """Meta write WITHOUT a forced commit: the caller pairs this
        with set_last_committed_block (which commits), so the chain
        link and the anchor it corresponds to are durable together."""
        with self._lock:
            if self._closed:
                return
            self._set_meta("chain_state", json.dumps(state))

    # -- batch / transaction protocol --------------------------------------

    def begin_batch(self) -> None:
        """Open (or nest into) an atomic write batch. All writes until
        the matching commit_batch land in one sqlite transaction."""
        with self._lock:
            self._batch_depth += 1

    def commit_batch(self) -> None:
        with self._lock:
            if self._batch_depth == 0:
                return
            self._batch_depth -= 1
            if self._batch_depth == 0:
                self._commit(force=True)

    def rollback_batch(self) -> None:
        """Discard the open batch (all nesting levels): the in-flight
        transaction is rolled back, so a failed sync batch or consensus
        pass leaves no partial writes on disk. The inmem layer is NOT
        rewound — callers abandon it wholesale (restart / engine
        rebuild) after a rollback."""
        with self._lock:
            if self._batch_depth == 0:
                return
            self._batch_depth = 0
            self._rounds_dirty = False
            if not self._closed:
                self._db.rollback()

    def _commit(self, force: bool = False) -> None:
        """Commit the connection's open transaction unless a batch is
        in flight (then the outermost commit_batch commits). A pass
        that wrote rounds advances the consensus anchor inside the same
        transaction — the anchor and the rounds it covers are durable
        or absent together."""
        if self._batch_depth > 0 and not force:
            return
        if self._rounds_dirty:
            self._db.execute(
                "INSERT OR REPLACE INTO meta VALUES ('consensus_anchor', "
                "(SELECT COALESCE(MAX(idx), -1) FROM rounds))")
            self._rounds_dirty = False
        t0 = time.perf_counter_ns()
        self._db.commit()
        dt = time.perf_counter_ns() - t0
        self.fsync_count += 1
        self.fsync_total_ns += dt
        self.fsync_last_ns = dt
        # Registry mirror (docs/observability.md): the batch-commit
        # wall (WAL write + fsync) as a latency distribution, and the
        # commit count, labeled by the fsync policy.
        self._m_fsync.observe(dt / 1e9)
        self._m_fsyncs.inc()

    def wal_bytes(self) -> int:
        try:
            return os.path.getsize(self.path + "-wal")
        except OSError:
            return 0

    def db_bytes(self) -> int:
        """Main database file size (the durable event log + rounds +
        blocks; the WAL is separate — wal_bytes)."""
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def capacity_stats(self) -> dict:
        """Capacity plane (docs/observability.md "Capacity"): the hot
        cache's sizing plus the durable files. The sqlite files are
        the store's true retained footprint; the inmem components are
        the heap working set in front of it."""
        stats = self.inmem.capacity_stats()
        stats["files"] = {
            "db": self.db_bytes(),
            "wal": self.wal_bytes(),
        }
        return stats

    def durability_stats(self) -> Dict[str, object]:
        """Observability payload for /Stats, /debug/phases and bench:
        the durable anchors, the sync policy, and the commit (WAL
        write + fsync) count/latency."""
        with self._lock:
            return {
                "store_sync": self.sync,
                "last_committed_block": self.last_committed_block(),
                "consensus_anchor": self.consensus_anchor(),
                "fsync_count": self.fsync_count,
                "fsync_total_ns": self.fsync_total_ns,
                "fsync_last_ns": self.fsync_last_ns,
                "wal_bytes": self.wal_bytes(),
            }

    # -- participants / roots ---------------------------------------------

    def _db_set_participants(self, participants: Dict[str, int]) -> None:
        with self._lock:
            self._db.executemany(
                "INSERT OR REPLACE INTO participants VALUES (?, ?)",
                list(participants.items()),
            )
            self._db.executemany(
                "INSERT OR REPLACE INTO roots VALUES (?, ?)",
                [
                    (pk, json.dumps(new_base_root().to_dict()))
                    for pk in participants
                ],
            )
            self._commit()

    def _db_participants(self) -> Dict[str, int]:
        with self._lock:
            rows = self._db.execute("SELECT pubkey, id FROM participants").fetchall()
        return {pk: pid for pk, pid in rows}

    # -- Store interface ---------------------------------------------------

    def cache_size(self) -> int:
        return self.inmem.cache_size()

    def participants(self) -> Dict[str, int]:
        return self._participants

    def get_event(self, key: str) -> Event:
        try:
            return self.inmem.get_event(key)
        except StoreError:
            pass
        with self._lock:
            row = self._db.execute(
                "SELECT data, topo, annotations FROM events WHERE hex = ?",
                (key,)
            ).fetchone()
        if row is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, key)
        ev = event_from_json_obj(json.loads(row[0]))
        ev.topological_index = row[1]
        return _annotations_from_json(ev, row[2])

    def has_event(self, key: str) -> bool:
        if self.inmem.has_event(key):
            return True
        with self._lock:
            row = self._db.execute(
                "SELECT 1 FROM events WHERE hex = ?", (key,)
            ).fetchone()
        return row is not None

    def set_event(self, event: Event) -> None:
        try:
            self.inmem.set_event(event)
        except StoreError as err:
            if not is_store_err(err, StoreErrType.PASSED_INDEX):
                raise
            # The rolling window aged past this index and the hot LRU
            # no longer holds the hash, so the cache cannot tell an
            # idempotent refresh from a fork — but the db can: an
            # identical hash at (creator, idx) is a refresh and falls
            # through to the upsert below; anything else is a genuine
            # fork.
            with self._lock:
                row = self._db.execute(
                    "SELECT hex FROM events WHERE creator = ? AND idx = ?",
                    (event.creator(), event.index()),
                ).fetchone()
            if row is None or row[0] != event.hex():
                raise
        obj = json.loads(event.marshal())
        with self._lock:
            # Replay order is the autoincrement seq (stable across
            # Reset, which restarts topological_index at 0); the topo
            # column preserves the engine-assigned index for reload.
            # Coordinate back-propagation and round-received marking
            # re-call set_event on old events whose marshaled bytes
            # never change, so conflicts refresh only topo and the
            # runtime annotations (wire/ancestry coordinates, consensus
            # marks) — the db fallback must serve events as usable as
            # the hot cache's.
            self._db.execute(
                "INSERT INTO events (hex, creator, idx, topo, data, "
                "annotations) VALUES (?, ?, ?, ?, ?, ?) "
                "ON CONFLICT(hex) DO UPDATE SET topo = excluded.topo, "
                "annotations = excluded.annotations",
                (
                    event.hex(),
                    event.creator(),
                    event.index(),
                    event.topological_index,
                    json.dumps(obj),
                    _annotations_to_json(event),
                ),
            )
            self._commit()

    def participant_events(self, participant: str, skip: int) -> List[str]:
        try:
            res = self.inmem.participant_events(participant, skip)
            # A freshly loaded store's rolling window is empty and
            # returns [] without error; distinguish "synced empty"
            # (participant known in the window) from "window knows
            # nothing" (is_root) and serve the latter from the db.
            if res:
                return res
            _, is_root = self.inmem.last_from(participant)
            if not is_root:
                return res
        except StoreError:
            pass
        with self._lock:
            rows = self._db.execute(
                "SELECT hex FROM events WHERE creator = ? AND idx > ? "
                "ORDER BY idx",
                (participant, skip),
            ).fetchall()
        return [r[0] for r in rows]

    def participant_window(self, participant: str):
        # Live hot-cache window; coordinates that aged out of it fall
        # back to the per-event probe below, which serves from sqlite.
        return self.inmem.participant_window(participant)

    def participant_event_objects(self, participant: str, skip: int) -> List[Event]:
        try:
            res = self.inmem.participant_event_objects(participant, skip)
            # Same freshly-loaded disambiguation as participant_events:
            # an empty window is only authoritative when the participant
            # has genuinely no events past `skip`.
            if res:
                return res
            _, is_root = self.inmem.last_from(participant)
            if not is_root:
                return res
        except StoreError:
            pass
        with self._lock:
            rows = self._db.execute(
                "SELECT data, topo, annotations FROM events "
                "WHERE creator = ? AND idx > ? ORDER BY idx",
                (participant, skip),
            ).fetchall()
        out = []
        for data, topo, ann in rows:
            ev = event_from_json_obj(json.loads(data))
            ev.topological_index = topo
            out.append(_annotations_from_json(ev, ann))
        return out

    def participant_event(self, participant: str, index: int) -> str:
        try:
            return self.inmem.participant_event(participant, index)
        except StoreError:
            with self._lock:
                row = self._db.execute(
                    "SELECT hex FROM events WHERE creator = ? AND idx = ?",
                    (participant, index),
                ).fetchone()
            if row is None:
                raise StoreError(StoreErrType.KEY_NOT_FOUND, participant)
            return row[0]

    def last_from(self, participant: str) -> Tuple[str, bool]:
        return self.inmem.last_from(participant)

    def known(self) -> Dict[int, int]:
        return self.inmem.known()

    def consensus_events(self) -> List[str]:
        return self.inmem.consensus_events()

    def consensus_events_count(self) -> int:
        return self.inmem.consensus_events_count()

    def add_consensus_event(self, key: str) -> None:
        self.inmem.add_consensus_event(key)

    def get_round(self, r: int) -> RoundInfo:
        try:
            return self.inmem.get_round(r)
        except StoreError:
            pass
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM rounds WHERE idx = ?", (r,)
            ).fetchone()
        if row is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, str(r))
        return _round_from_json(row[0])

    def set_round(self, r: int, round_info: RoundInfo) -> None:
        self.inmem.set_round(r, round_info)
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO rounds VALUES (?, ?)",
                (r, _round_to_json(round_info)),
            )
            self._rounds_dirty = True
            self._commit()

    def last_round(self) -> int:
        lr = self.inmem.last_round()
        if lr >= 0:
            return lr
        with self._lock:
            row = self._db.execute("SELECT MAX(idx) FROM rounds").fetchone()
        return row[0] if row and row[0] is not None else -1

    def round_witnesses(self, r: int) -> List[str]:
        try:
            return self.get_round(r).witnesses()
        except StoreError:
            return []

    def round_events(self, r: int) -> int:
        try:
            return len(self.get_round(r).events)
        except StoreError:
            return 0

    def get_root(self, participant: str) -> Root:
        try:
            return self.inmem.get_root(participant)
        except StoreError:
            pass
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM roots WHERE pubkey = ?", (participant,)
            ).fetchone()
        if row is None:
            raise StoreError(StoreErrType.NO_ROOT, participant)
        return Root.from_dict(json.loads(row[0]))

    def get_block(self, rr: int) -> Block:
        try:
            return self.inmem.get_block(rr)
        except StoreError:
            pass
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM blocks WHERE rr = ?", (rr,)
            ).fetchone()
        if row is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, str(rr))
        return Block.from_json_obj(json.loads(row[0]))

    def set_block(self, block: Block) -> None:
        self.inmem.set_block(block)
        data = json.dumps(block.to_json_obj())
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO blocks VALUES (?, ?)",
                (block.round_received, data),
            )
            self._commit()

    def reset(self, roots: Dict[str, Root]) -> None:
        """Frame reset: the database drops pre-reset history along with
        the hot cache. Keeping the old event log would poison the next
        restart — bootstrap replays the log against the NEW roots, and
        pre-reset events fail their parent checks there (and the db
        fallback reads would serve stale pre-reset history meanwhile).
        A reset store serves only post-reset state, exactly like
        InmemStore. One transaction: a kill mid-reset leaves the old
        store intact."""
        self.inmem.reset(roots)
        with self._lock:
            self.begin_batch()
            try:
                self._db.execute("DELETE FROM events")
                self._db.execute("DELETE FROM rounds")
                self._db.execute("DELETE FROM blocks")
                self._set_meta("consensus_anchor", "-1")
                self._db.executemany(
                    "INSERT OR REPLACE INTO roots VALUES (?, ?)",
                    [(pk, json.dumps(r.to_dict())) for pk, r in roots.items()],
                )
                self.commit_batch()
            except BaseException:
                self.rollback_batch()
                raise

    def close(self) -> None:
        """Idempotent, exception-safe close: an interrupted batch is
        rolled back (half a protocol batch on disk would violate the
        atomicity contract), otherwise any open transaction is
        committed; double close is a no-op and nothing here raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                if self._batch_depth > 0:
                    self._batch_depth = 0
                    self._rounds_dirty = False
                    self._db.rollback()
                else:
                    self._commit()
            except Exception:  # noqa: BLE001 - close must never raise
                try:
                    self._db.rollback()
                except Exception:  # noqa: BLE001
                    pass
            finally:
                try:
                    self._db.close()
                except Exception:  # noqa: BLE001
                    pass

    # -- bootstrap feed ----------------------------------------------------

    def db_topological_events(self) -> Iterator[Event]:
        """Replay the event log in insertion order — reference
        dbTopologicalEvents (badger_store.go:345-386). Consumed by
        Hashgraph.bootstrap()."""
        with self._lock:
            rows = self._db.execute(
                "SELECT data, topo, annotations FROM events ORDER BY seq"
            ).fetchall()
        for data, topo, ann in rows:
            ev = event_from_json_obj(json.loads(data))
            ev.topological_index = topo
            # Wire info rides along so the replay can re-serve diffs;
            # ancestry coordinates are rebuilt by insert_event anyway.
            yield _annotations_from_json(ev, ann)
