"""The hashgraph consensus engine (incremental host implementation).

Behavioral mirror of the reference engine (hashgraph/hashgraph.go), kept
exactly semantics-equivalent so it can serve as (a) the per-node engine
in the live gossip runtime, and (b) the parity oracle for the batched
device engine (hashgraph/torch_graph.py over ops/incremental.py).

Key semantics preserved (with reference anchors):
- ancestor(x,y) via per-participant coordinate vectors (hashgraph.go:82-101)
- stronglySee = lane-wise compare-and-count >= 2n/3+1 (hashgraph.go:179-198)
- parentRound/Root fallbacks incl. Others shortcut (hashgraph.go:211-262)
- witness / roundInc / round (hashgraph.go:265-339)
- insert pipeline: verify, parent checks, topo index, wire info,
  coordinate init, first-descendant back-propagation (hashgraph.go:356-530)
- DivideRounds / DecideFame (incl. coin rounds) / DecideRoundReceived /
  FindOrder with the ConsensusSorter quirk: the sorter's round map is
  never populated, so the PRN is always 0 and the final tiebreak is a raw
  big-int compare of S (hashgraph.go:616-858, consensus_sorter.go:21-52)
- GetFrame / Reset / Bootstrap (hashgraph.go:879-1037)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..common import LRU, Memo, StoreError, StoreErrType, is_store_err
from ..gojson import Timestamp, ZERO_TIME
from .block import Block
from .event import Event, EventBody, EventCoordinates, WireEvent
from .frame import Frame
from .root import Root
from .round_info import RoundInfo
from .store import Store
from .wire_native import WireReader

MAX_INT32 = 2**31 - 1


class InsertError(Exception):
    pass


class ForkError(InsertError):
    """Equivocation: a SIGNED event by a creator at an index where a
    different signed event already exists. Unlike a generic
    InsertError (stale parent, unknown coordinates), this is proof of
    Byzantine behavior — the evidence is recorded in the store before
    the raise (docs/observability.md "Consensus health")."""


class ParentRoundInfo:
    __slots__ = ("round", "is_root")

    def __init__(self, round: int = -1, is_root: bool = False):
        self.round = round
        self.is_root = is_root


def middle_bit(ehex: str) -> bool:
    """Coin-flip bit: middle byte of the event hash — hashgraph.go:1039-1048."""
    data = bytes.fromhex(ehex[2:])
    if len(data) > 0 and data[len(data) // 2] == 0:
        return False
    return True


class Hashgraph:
    def __init__(
        self,
        participants: Dict[str, int],
        store: Store,
        commit_callback: Optional[Callable[[Block], None]] = None,
    ):
        self.participants = participants
        self.reverse_participants = {pid: pk for pk, pid in participants.items()}
        self.wire_reader = WireReader(self.reverse_participants)
        self.store = store
        self.commit_callback = commit_callback

        self.undetermined_events: List[str] = []
        self.undecided_rounds: List[int] = [0]
        # Fork observer (node/core.py wires the babble_forks_total
        # counter here): called with each NEW equivocation evidence
        # record the insert path detects and persists.
        self.fork_observer: Optional[Callable[[dict], None]] = None
        self.last_consensus_round: Optional[int] = None
        self.last_commited_round_events = 0
        self.consensus_transactions = 0
        self.pending_loaded_events = 0
        self.topological_index = 0
        self.super_majority = 2 * len(participants) // 3 + 1

        self._init_memo_caches()

    def _init_memo_caches(self) -> None:
        # Memo (not LRU): these cache PURE functions of the DAG, so
        # eviction policy affects only speed — see common/lru.py.
        cache_size = self.store.cache_size()
        self._ancestor_cache = Memo(cache_size)
        self._self_ancestor_cache = Memo(cache_size)
        self._oldest_self_ancestor_cache = Memo(cache_size)
        self._strongly_see_cache = Memo(cache_size)
        self._parent_round_cache = Memo(cache_size)
        self._round_cache = Memo(cache_size)
        self._witness_cache = Memo(cache_size)
        # Events already recorded into their RoundInfo by a previous
        # divide_rounds pass: round(x)/witness(x) are pure functions of
        # the DAG and RoundInfo.add_event is idempotent, so re-walking
        # them every pass (the reference rescans ALL undetermined
        # events, hashgraph.go:616-646) only re-derives identical
        # state. The set tracks what is already divided so each pass
        # costs O(new events), not O(undetermined backlog).
        self._divided: set = set()

    # -- reachability ------------------------------------------------------

    def ancestor(self, x: str, y: str) -> bool:
        """True if y is an ancestor of x."""
        c, ok = self._ancestor_cache.get((x, y))
        if ok:
            return c
        a = self._ancestor(x, y)
        self._ancestor_cache.add((x, y), a)
        return a

    def _ancestor(self, x: str, y: str) -> bool:
        if x == y:
            return True
        try:
            ex = self.store.get_event(x)
            ey = self.store.get_event(y)
        except StoreError:
            return False
        ey_creator = self.participants[ey.creator()]
        return ex.last_ancestors[ey_creator].index >= ey.index()

    def self_ancestor(self, x: str, y: str) -> bool:
        c, ok = self._self_ancestor_cache.get((x, y))
        if ok:
            return c
        a = self._self_ancestor(x, y)
        self._self_ancestor_cache.add((x, y), a)
        return a

    def _self_ancestor(self, x: str, y: str) -> bool:
        if x == y:
            return True
        try:
            ex = self.store.get_event(x)
            ey = self.store.get_event(y)
        except StoreError:
            return False
        return (
            self.participants[ex.creator()] == self.participants[ey.creator()]
            and ex.index() >= ey.index()
        )

    def see(self, x: str, y: str) -> bool:
        # Fork detection is unnecessary: InsertEvent forbids two events by
        # the same creator at the same height (hashgraph.go:133-138).
        return self.ancestor(x, y)

    def oldest_self_ancestor_to_see(self, x: str, y: str) -> str:
        c, ok = self._oldest_self_ancestor_cache.get((x, y))
        if ok:
            return c
        res = self._oldest_self_ancestor_to_see(x, y)
        self._oldest_self_ancestor_cache.add((x, y), res)
        return res

    def _oldest_self_ancestor_to_see(self, x: str, y: str) -> str:
        try:
            ex = self.store.get_event(x)
            ey = self.store.get_event(y)
        except StoreError:
            return ""
        a = ey.first_descendants[self.participants[ex.creator()]]
        if a.index <= ex.index():
            return a.hash
        return ""

    def strongly_see(self, x: str, y: str) -> bool:
        c, ok = self._strongly_see_cache.get((x, y))
        if ok:
            return c
        ss = self._strongly_see(x, y)
        self._strongly_see_cache.add((x, y), ss)
        return ss

    def _strongly_see(self, x: str, y: str) -> bool:
        try:
            ex = self.store.get_event(x)
            ey = self.store.get_event(y)
        except StoreError:
            return False
        c = sum(
            1
            for exl, eyf in zip(ex.last_ancestors, ey.first_descendants)
            if exl.index >= eyf.index
        )
        return c >= self.super_majority

    # -- rounds ------------------------------------------------------------

    def parent_round(self, x: str) -> ParentRoundInfo:
        c, ok = self._parent_round_cache.get(x)
        if ok:
            return c
        pr = self._parent_round(x)
        self._parent_round_cache.add(x, pr)
        return pr

    def _parent_round(self, x: str) -> ParentRoundInfo:
        res = ParentRoundInfo()
        try:
            ex = self.store.get_event(x)
            root = self.store.get_root(ex.creator())
        except StoreError:
            return res

        # Self-parent round: from the Root if x is the creator's first event.
        if ex.self_parent() == root.x:
            sp_round, sp_root = root.round, True
        else:
            sp_round, sp_root = self.round(ex.self_parent()), False

        op_round, op_root = -1, False
        other_parent = ex.other_parent()
        op_known = True
        try:
            self.store.get_event(other_parent)
        except StoreError:
            op_known = False
        if op_known:
            op_round = self.round(other_parent)
        elif other_parent == root.y:
            op_round, op_root = root.round, True
        elif root.others.get(x) == other_parent:
            # Other-parent referenced in Root.Others: use the Root's round
            # (an upper bound is acceptable for the max — hashgraph.go:245-253).
            op_round = root.round

        res.round, res.is_root = sp_round, sp_root
        if sp_round < op_round:
            res.round, res.is_root = op_round, op_root
        return res

    def witness(self, x: str) -> bool:
        c, ok = self._witness_cache.get(x)
        if ok:
            return c
        w = self._witness(x)
        self._witness_cache.add(x, w)
        return w

    def _witness(self, x: str) -> bool:
        try:
            ex = self.store.get_event(x)
            root = self.store.get_root(ex.creator())
        except StoreError:
            return False
        if ex.self_parent() == root.x and ex.other_parent() == root.y:
            return True
        return self.round(x) > self.round(ex.self_parent())

    def round_inc(self, x: str) -> bool:
        parent_round = self.parent_round(x)
        if parent_round.is_root:
            # x sits right on top of a Root.
            return True
        c = sum(
            1
            for w in self.store.round_witnesses(parent_round.round)
            if self.strongly_see(x, w)
        )
        return c >= self.super_majority

    def round_received(self, x: str) -> int:
        try:
            ex = self.store.get_event(x)
        except StoreError:
            return -1
        return ex.round_received if ex.round_received is not None else -1

    def round(self, x: str) -> int:
        c, ok = self._round_cache.get(x)
        if ok:
            return c
        r = self._round(x)
        self._round_cache.add(x, r)
        return r

    def _round(self, x: str) -> int:
        round_ = self.parent_round(x).round
        if self.round_inc(x):
            round_ += 1
        return round_

    def round_diff(self, x: str, y: str) -> int:
        x_round = self.round(x)
        if x_round < 0:
            raise ValueError(f"event {x} has negative round")
        y_round = self.round(y)
        if y_round < 0:
            raise ValueError(f"event {y} has negative round")
        return x_round - y_round

    # -- insertion ---------------------------------------------------------

    def insert_event(self, event: Event, set_wire_info: bool) -> None:
        if not event.verify():
            raise InsertError("Invalid signature")

        try:
            self._check_self_parent(event)
        except ForkError:
            raise
        except Exception as e:
            raise InsertError(f"CheckSelfParent: {e}") from e
        try:
            self._check_other_parent(event)
        except Exception as e:
            raise InsertError(f"CheckOtherParent: {e}") from e

        event.topological_index = self.topological_index
        self.topological_index += 1

        if set_wire_info:
            self._set_wire_info(event)

        self._init_event_coordinates(event)
        self.store.set_event(event)
        self._update_ancestor_first_descendant(event)

        self.undetermined_events.append(event.hex())
        if event.is_loaded():
            self.pending_loaded_events += 1

    def _check_self_parent(self, event: Event) -> None:
        """Self-parent must be the creator's last known event — forbids forks
        at insert time (hashgraph.go:404-420). Before rejecting, probe
        whether the rejection IS a fork: a different signed event by
        the same creator at the same index is equivocation, and the
        proof (both events) is persisted as fork evidence rather than
        discarded with a generic error."""
        creator_last_known, _ = self.store.last_from(event.creator())
        if event.self_parent() != creator_last_known:
            self._maybe_record_fork(event)
            raise InsertError(
                "Self-parent not last known event by creator "
                f"(creator={event.creator()[:12]} idx={event.index()} "
                f"self_parent={event.self_parent()[:12]} "
                f"last_known={creator_last_known[:12]})")

    def _maybe_record_fork(self, event: Event) -> None:
        """Detect equivocation on the insert reject path: if the store
        already holds a DIFFERENT event by this creator at this index
        and the new event's signature verifies, that pair is
        cryptographic proof of a fork. Evidence is deduped and
        persisted by the store (surviving restarts on FileStore) and
        surfaced through the fork observer as
        `babble_forks_total{creator}`. Raises ForkError; returns
        silently when the rejection is benign (stale parent, index
        outside the window, unverifiable signature)."""
        from .health import fork_evidence_record

        try:
            existing = self.store.participant_event(
                event.creator(), event.index())
        except StoreError:
            return  # index unknown or aged out: not provably a fork
        if existing == event.hex():
            return  # idempotent duplicate, not a fork
        if not event.verify():
            return  # unsigned garbage proves nothing about the creator
        record = fork_evidence_record(existing, event)
        fresh = self.store.add_fork_evidence(record)
        if fresh and self.fork_observer is not None:
            self.fork_observer(record)
        raise ForkError(
            f"equivocation by {event.creator()[:12]} at index "
            f"{event.index()}: {existing[:12]} vs {event.hex()[:12]} "
            "(evidence recorded)")

    def _check_other_parent(self, event: Event) -> None:
        other_parent = event.other_parent()
        if other_parent == "":
            return
        try:
            self.store.get_event(other_parent)
            return
        except StoreError:
            pass
        # Might still be referenced in the creator's Root.
        root = self.store.get_root(event.creator())
        if root.x == event.self_parent() and root.y == other_parent:
            return
        if root.others.get(event.hex()) == other_parent:
            return
        raise InsertError("Other-parent not known")

    def _init_event_coordinates(self, event: Event) -> None:
        members = len(self.participants)
        event.first_descendants = [
            EventCoordinates(index=MAX_INT32) for _ in range(members)
        ]

        sp, op = None, None
        try:
            sp = self.store.get_event(event.self_parent())
        except StoreError:
            pass
        try:
            op = self.store.get_event(event.other_parent())
        except StoreError:
            pass

        if sp is None and op is None:
            event.last_ancestors = [EventCoordinates(index=-1) for _ in range(members)]
        elif sp is None:
            event.last_ancestors = [c.copy() for c in op.last_ancestors]
        elif op is None:
            event.last_ancestors = [c.copy() for c in sp.last_ancestors]
        else:
            event.last_ancestors = [c.copy() for c in sp.last_ancestors]
            for i in range(members):
                if event.last_ancestors[i].index < op.last_ancestors[i].index:
                    event.last_ancestors[i].index = op.last_ancestors[i].index
                    event.last_ancestors[i].hash = op.last_ancestors[i].hash

        index = event.index()
        creator_id = self.participants.get(event.creator())
        if creator_id is None:
            raise InsertError("Could not find fake creator id")
        ehex = event.hex()
        event.first_descendants[creator_id] = EventCoordinates(index=index, hash=ehex)
        event.last_ancestors[creator_id] = EventCoordinates(index=index, hash=ehex)

    def _update_ancestor_first_descendant(self, event: Event) -> None:
        """Back-propagate: each last-ancestor chain gets its first descendant
        by this creator set to the new event (hashgraph.go:502-530)."""
        creator_id = self.participants.get(event.creator())
        if creator_id is None:
            raise InsertError(f"Could not find creator fake id ({event.creator()})")
        index = event.index()
        ehex = event.hex()
        for coord in event.last_ancestors:
            ah = coord.hash
            while ah != "":
                try:
                    a = self.store.get_event(ah)
                except StoreError:
                    break
                if not a.first_descendants:
                    # Legacy persistent row without annotation sidecar
                    # (pre-v2 FileStore): its coordinates are gone;
                    # treat like a missing ancestor and stop the walk.
                    break
                if a.first_descendants[creator_id].index == MAX_INT32:
                    a.first_descendants[creator_id] = EventCoordinates(
                        index=index, hash=ehex
                    )
                    self.store.set_event(a)
                    ah = a.self_parent()
                else:
                    break

    def _set_wire_info(self, event: Event) -> None:
        self_parent_index = -1
        other_parent_creator_id = -1
        other_parent_index = -1

        lf, is_root = self.store.last_from(event.creator())
        if is_root and lf == event.self_parent():
            root = self.store.get_root(event.creator())
            self_parent_index = root.index
        else:
            self_parent = self.store.get_event(event.self_parent())
            self_parent_index = self_parent.index()

        if event.other_parent() != "":
            other_parent = self.store.get_event(event.other_parent())
            other_parent_creator_id = self.participants[other_parent.creator()]
            other_parent_index = other_parent.index()

        event.set_wire_info(
            self_parent_index,
            other_parent_creator_id,
            other_parent_index,
            self.participants[event.creator()],
        )

    def read_wire_info(self, wevent: WireEvent) -> Event:
        """Resolve a compact wire event's int coordinates back to parent
        hashes via the store (hashgraph.go:569-614)."""
        self_parent = ""
        other_parent = ""
        creator = self.reverse_participants[wevent.body.creator_id]
        creator_bytes = bytes.fromhex(creator[2:])

        if wevent.body.self_parent_index >= 0:
            self_parent = self.store.participant_event(
                creator, wevent.body.self_parent_index
            )
        if wevent.body.other_parent_index >= 0:
            other_parent_creator = self.reverse_participants[
                wevent.body.other_parent_creator_id
            ]
            other_parent = self.store.participant_event(
                other_parent_creator, wevent.body.other_parent_index
            )

        body = EventBody(
            transactions=wevent.body.transactions,
            parents=[self_parent, other_parent],
            creator=creator_bytes,
            timestamp=wevent.body.timestamp,
            index=wevent.body.index,
        )
        body.self_parent_index = wevent.body.self_parent_index
        body.other_parent_creator_id = wevent.body.other_parent_creator_id
        body.other_parent_index = wevent.body.other_parent_index
        body.creator_id = wevent.body.creator_id

        ev = Event(body, r=wevent.r, s=wevent.s)
        ev.trace_id = wevent.trace_id
        ev.create_ns = wevent.create_ns
        return ev

    def _batch_resolver(self):
        """(local, resolve) pair shared by the legacy and columnar
        batch read paths: `local` maps (creator_id, index) -> hex for
        events materialized earlier in the same batch; `resolve` falls
        through to ONE per-creator window snapshot, then the per-event
        store probe (which raises the same StoreError the serial path
        raised). Caller holds the core lock: the window snapshots are
        live store state and must not race inserts."""
        local: Dict[tuple, str] = {}
        windows: Dict[int, tuple] = {}

        def resolve(creator_id: int, index: int) -> str:
            h = local.get((creator_id, index))
            if h is not None:
                return h
            win = windows.get(creator_id)
            if win is None:
                creator = self.reverse_participants[creator_id]
                win = self.store.participant_window(creator)
                windows[creator_id] = win
            items, last_index = win
            pos = index - (last_index - len(items) + 1)
            if 0 <= pos < len(items):
                return items[pos]
            # Aged out of the rolling window (or unknown): fall back to
            # the per-event store probe.
            creator = self.reverse_participants[creator_id]
            return self.store.participant_event(creator, index)

        return local, resolve

    def read_wire_batch(self, wire_events) -> List[Event]:
        """Materialize a whole sync batch of wire events at once.

        Accepts either the legacy `List[WireEvent]` or a packed
        `ColumnarEvents` batch (net/columnar.py) — the two wire forms
        of the same payload, so mixed-format clusters converge on the
        same DAG bytes.

        Equivalent to calling read_wire_info per event interleaved with
        inserts, but with two batch-level shortcuts:

        - later batch events routinely name earlier ones as parents;
          those coordinates resolve against a local (creator_id, index)
          map of the batch itself instead of requiring the parent to be
          store-inserted first — which is what lets `Core.sync` split
          materialize / verify / insert into separate phases;
        - store coordinates resolve through ONE per-creator window
          snapshot (`participant_window`) instead of two store probes
          per event (for a FileStore whose window aged out, that was
          two sqlite round trips per event).

        Caller holds the core lock.
        """
        if not isinstance(wire_events, list):
            return self._read_columnar_batch(wire_events)
        local, resolve = self._batch_resolver()
        out: List[Event] = []
        for wevent in wire_events:
            wb = wevent.body
            self_parent = ""
            other_parent = ""
            if wb.self_parent_index >= 0:
                self_parent = resolve(wb.creator_id, wb.self_parent_index)
            if wb.other_parent_index >= 0:
                other_parent = resolve(
                    wb.other_parent_creator_id, wb.other_parent_index)

            creator = self.reverse_participants[wb.creator_id]
            body = EventBody(
                transactions=wb.transactions,
                parents=[self_parent, other_parent],
                creator=bytes.fromhex(creator[2:]),
                timestamp=wb.timestamp,
                index=wb.index,
            )
            body.self_parent_index = wb.self_parent_index
            body.other_parent_creator_id = wb.other_parent_creator_id
            body.other_parent_index = wb.other_parent_index
            body.creator_id = wb.creator_id
            ev = Event(body, r=wevent.r, s=wevent.s)
            # Sidecar annotations survive the hop, so this node's own
            # diffs relay the trace id and creation stamp onward
            # (multi-hop flows / propagation latency).
            ev.trace_id = wevent.trace_id
            ev.create_ns = wevent.create_ns
            local[(wb.creator_id, wb.index)] = ev.hex()
            out.append(ev)
        return out

    def _read_columnar_batch(self, cols) -> List[Event]:
        """Columnar materialization (docs/ingest.md "Wire layout"):
        walk the packed columns once, resolve parents through the same
        batch-local map + window snapshots as the legacy path, and
        build each Event via `materialize_wire_event` — the Go-JSON
        body/event encodings are seeded directly from the columns, so
        downstream hashing, signature verification (over the derived
        signed-body blob column), and relay marshal are all memo hits.
        No per-event wire dict is ever built. The native reader
        (wire_native.py) takes the batch when its library is built; this
        loop is its fallback."""
        from .event import materialize_wire_event

        local, resolve = self._batch_resolver()
        out = self.wire_reader.read(cols, resolve)
        if out is not None:
            return out
        cid = cols.cid.tolist()
        idx = cols.idx.tolist()
        sp_idx = cols.sp_idx.tolist()
        op_cid = cols.op_cid.tolist()
        op_idx = cols.op_idx.tolist()
        ts_ns = cols.ts_ns.tolist()
        trace = (cols.trace_ids.tolist()
                 if cols.trace_ids is not None else None)
        created = (cols.create_ns.tolist()
                   if cols.create_ns is not None else None)
        tx_starts, tx_off = cols.tx_layout()
        creator_bytes: Dict[int, bytes] = {}

        out: List[Event] = []
        for k in range(len(cid)):
            c = cid[k]
            cb = creator_bytes.get(c)
            if cb is None:
                cb = creator_bytes[c] = bytes.fromhex(
                    self.reverse_participants[c][2:])
            self_parent = resolve(c, sp_idx[k]) if sp_idx[k] >= 0 else ""
            other_parent = (resolve(op_cid[k], op_idx[k])
                            if op_idx[k] >= 0 else "")
            r, s = cols.signature(k)
            ev = materialize_wire_event(
                cb, self_parent, other_parent, idx[k], ts_ns[k],
                cols.transactions_of(tx_starts, tx_off, k), r, s,
                sp_idx[k], op_cid[k], op_idx[k], c,
                trace_id=trace[k] if trace is not None else 0,
                create_ns=created[k] if created is not None else 0,
            )
            local[(c, idx[k])] = ev.hex()
            out.append(ev)
        return out

    # -- consensus pipeline ------------------------------------------------

    def divide_rounds(self) -> None:
        divided = self._divided
        for ehex in self.undetermined_events:
            if ehex in divided:
                # Already recorded by a previous pass: its round and
                # witness flag are memo-stable and its RoundInfo row
                # already holds it — rescanning is a provable no-op
                # (the reference's rescan re-derives identical state).
                continue
            round_number = self.round(ehex)
            witness = self.witness(ehex)
            try:
                round_info = self.store.get_round(round_number)
            except StoreError as err:
                if not is_store_err(err, StoreErrType.KEY_NOT_FOUND):
                    raise
                round_info = RoundInfo()
            if not round_info.queued:
                self.undecided_rounds.append(round_number)
                round_info.queued = True
            round_info.add_event(ehex, witness)
            self.store.set_round(round_number, round_info)
            divided.add(ehex)

    def decide_fame(self) -> None:
        votes: Dict[str, Dict[str, bool]] = {}

        def set_vote(y: str, x: str, v: bool) -> None:
            votes.setdefault(y, {})[x] = v

        decided_rounds: Dict[int, int] = {}
        try:
            for pos, i in enumerate(self.undecided_rounds):
                round_info = self.store.get_round(i)
                for x in round_info.witnesses():
                    if round_info.is_decided(x):
                        continue
                    decided_x = False
                    for j in range(i + 1, self.store.last_round() + 1):
                        if decided_x:
                            break
                        for y in self.store.round_witnesses(j):
                            diff = j - i
                            if diff == 1:
                                set_vote(y, x, self.see(y, x))
                            else:
                                ss_witnesses = [
                                    w
                                    for w in self.store.round_witnesses(j - 1)
                                    if self.strongly_see(y, w)
                                ]
                                yays = sum(
                                    1 for w in ss_witnesses if votes.get(w, {}).get(x, False)
                                )
                                nays = len(ss_witnesses) - yays
                                v, t = (True, yays) if yays >= nays else (False, nays)

                                if diff % len(self.participants) > 0:
                                    # normal round
                                    if t >= self.super_majority:
                                        round_info.set_fame(x, v)
                                        set_vote(y, x, v)
                                        decided_x = True
                                        break  # out of y loop; j loop breaks above
                                    set_vote(y, x, v)
                                else:
                                    # coin round
                                    if t >= self.super_majority:
                                        set_vote(y, x, v)
                                    else:
                                        set_vote(y, x, middle_bit(y))

                if round_info.witnesses_decided():
                    decided_rounds[i] = pos
                    if (
                        self.last_consensus_round is None
                        or i > self.last_consensus_round
                    ):
                        self._set_last_consensus_round(i)

                self.store.set_round(i, round_info)
        finally:
            self._update_undecided_rounds(decided_rounds)

    def _update_undecided_rounds(self, decided_rounds: Dict[int, int]) -> None:
        self.undecided_rounds = [
            ur for ur in self.undecided_rounds if ur not in decided_rounds
        ]

    def _set_last_consensus_round(self, i: int) -> None:
        self.last_consensus_round = i
        self.last_commited_round_events = self.store.round_events(i - 1)

    def decide_round_received(self) -> None:
        # The gate below (all rounds <= i decided) fails for every i at
        # or past the first undecided round, so that is the hard upper
        # bound of the scan — computed once per pass, and events whose
        # round leaves no candidate i skip the loop (and its get_round
        # probe) entirely.
        first_undecided = (self.undecided_rounds[0]
                           if self.undecided_rounds
                           else MAX_INT32)
        last = min(self.store.last_round(), first_undecided - 1)
        for x in self.undetermined_events:
            r = self.round(x)
            for i in range(r + 1, last + 1):
                try:
                    tr = self.store.get_round(i)
                except StoreError as err:
                    if not is_store_err(err, StoreErrType.KEY_NOT_FOUND):
                        raise
                    tr = RoundInfo()

                # Skip until the round is fully decided and all earlier
                # rounds are too (hashgraph.go:762-764); i stops before
                # the first undecided round (the gate is monotone in i,
                # the reference continues to the same outcome at
                # O(last_round) per event).
                if not tr.witnesses_decided():
                    continue

                fws = tr.famous_witnesses()
                s = [w for w in fws if self.see(w, x)]
                if len(s) > len(fws) // 2:
                    ex = self.store.get_event(x)
                    ex.set_round_received(i)
                    t = [self.oldest_self_ancestor_to_see(a, x) for a in s]
                    ex.consensus_timestamp = self.median_timestamp(t)
                    self.store.set_event(ex)
                    break

    def find_order(self) -> None:
        self.decide_round_received()

        new_consensus_events: List[Event] = []
        new_undetermined: List[str] = []
        for x in self.undetermined_events:
            ex = self.store.get_event(x)
            if ex.round_received is not None:
                new_consensus_events.append(ex)
            else:
                new_undetermined.append(x)
        self.undetermined_events = new_undetermined
        # Events leaving the undetermined set leave the divided set
        # too (divide_rounds only consults it for undetermined ones).
        self._divided.difference_update(
            e.hex() for e in new_consensus_events)

        # ConsensusSorter quirk (consensus_sorter.go:44-52): its round map is
        # never populated, so PseudoRandomNumber is always 0 and the final
        # tiebreak is a raw big-int compare of S.
        new_consensus_events.sort(
            key=lambda e: (
                e.round_received if e.round_received is not None else -1,
                e.consensus_timestamp.ns,
                int(e.s),
            )
        )

        block_map: Dict[int, Block] = {}
        block_order: List[int] = []
        for e in new_consensus_events:
            self.store.add_consensus_event(e.hex())
            self.consensus_transactions += len(e.transactions() or [])
            if e.is_loaded():
                self.pending_loaded_events -= 1

            b = block_map.get(e.round_received)
            etxs = e.transactions()
            if b is None:
                # Preserve nil-vs-empty: Go NewBlock keeps a nil slice nil,
                # which marshals as null and affects the block hash
                # (block.go:19-33).
                b = Block(e.round_received, None if etxs is None else list(etxs))
                block_order.append(e.round_received)
                block_map[e.round_received] = b
            elif etxs:
                # Go append(nil, elems...) allocates; append(x) with no
                # elems leaves nil untouched.
                if b.transactions is None:
                    b.transactions = list(etxs)
                else:
                    b.transactions.extend(etxs)

        for rr in block_order:
            block = block_map[rr]
            self.store.set_block(block)
            if self.commit_callback is not None and block.transactions:
                self.commit_callback(block)

    def median_timestamp(self, event_hashes: List[str]) -> Timestamp:
        timestamps = []
        for x in event_hashes:
            try:
                ex = self.store.get_event(x)
                timestamps.append(ex.body.timestamp)
            except StoreError:
                # Go ignores the error and appends a zero event
                # (hashgraph.go:860-868).
                timestamps.append(ZERO_TIME)
        timestamps.sort(key=lambda t: t.ns)
        return timestamps[len(timestamps) // 2]

    def run_consensus(self, unlocked=None) -> None:
        # `unlocked` is the device engine's lock-release seam
        # (tpu_graph.py); the host pipeline has no blocking device wait
        # to release around.
        #
        # The pass's store writes (round rows, fame updates, received
        # events, blocks) form one atomic batch: a process killed
        # mid-pass leaves no partial consensus pass on disk (the
        # durable store's consensus anchor advances in the same
        # transaction). On a mid-pass software error the finally
        # commits the prefix — identical durability to the historical
        # per-statement commits, and required because the write-through
        # hot cache has already seen those writes.
        self.store.begin_batch()
        try:
            self.divide_rounds()
            self.decide_fame()
            self.find_order()
        finally:
            self.store.commit_batch()

    # -- queries -----------------------------------------------------------

    def consensus_events(self) -> List[str]:
        return self.store.consensus_events()

    def known(self) -> Dict[int, int]:
        return self.store.known()

    # -- consensus health queries (docs/observability.md) ------------------
    #
    # Read-only views over store state (round rows, events) that the
    # scrape/debug paths call WITHOUT the core lock — everything below
    # snapshots dicts with list() and tolerates missing rows, exactly
    # like get_stats' phase reads. Both engines serve these: the device
    # engine mirrors its round rows and fame updates into the Store.

    def undecided_witness_count(self) -> int:
        """Witnesses across the pending rounds whose fame is still
        undefined — the live size of the virtual-voting frontier."""
        from .round_info import Trilean

        n = 0
        for r in list(self.undecided_rounds):
            try:
                ri = self.store.get_round(r)
            except StoreError:
                continue
            n += sum(1 for e in list(ri.events.values())
                     if e.witness and e.famous == Trilean.UNDEFINED)
        return n

    def last_decided_fame_round(self) -> int:
        """Highest round with at least one fame-decided witness (-1
        when none): tracks partial progress ABOVE last_consensus_round,
        which only advances when a round decides completely."""
        from .round_info import Trilean

        floor = (self.last_consensus_round
                 if self.last_consensus_round is not None else -1)
        for r in range(self.store.last_round(), floor, -1):
            try:
                ri = self.store.get_round(r)
            except StoreError:
                continue
            if any(e.witness and e.famous != Trilean.UNDEFINED
                   for e in list(ri.events.values())):
                return r
        return floor

    def dag_window(self, from_round: Optional[int] = None,
                   max_rounds: int = 8,
                   max_events: int = 4096) -> Dict:
        """Bounded JSON export of the event DAG for /debug/hashgraph
        and the dagdump renderer: events of rounds [from_round,
        last_round] (default: the trailing `max_rounds`) plus any
        still-undivided undetermined events, each with its parent
        edges and round/witness/fame/received annotations."""
        from .round_info import Trilean

        last = self.store.last_round()
        if from_round is None:
            lo = max(0, last - max_rounds + 1)
        else:
            lo = max(0, int(from_round))
        fame_name = {Trilean.UNDEFINED: None, Trilean.TRUE: True,
                     Trilean.FALSE: False}
        rows: Dict[str, Dict] = {}
        truncated = False
        for r in range(lo, last + 1):
            try:
                ri = self.store.get_round(r)
            except StoreError:
                continue
            for x, re_ in list(ri.events.items()):
                if len(rows) >= max_events:
                    truncated = True
                    break
                rows[x] = {"round": r, "witness": re_.witness,
                           "famous": fame_name.get(re_.famous)}
        for x in list(self.undetermined_events):
            if x in rows:
                continue
            if len(rows) >= max_events:
                truncated = True
                break
            # Not yet divided into a round row: annotations unknown
            # without forcing a consensus computation on this thread.
            rows[x] = {"round": None, "witness": False, "famous": None}
        events = []
        for x, ann in rows.items():
            try:
                ev = self.store.get_event(x)
            except StoreError:
                continue  # aged out of the LRU window
            events.append({
                "hash": x,
                "creator_id": self.participants.get(ev.creator(), -1),
                "creator": ev.creator()[:18],
                "index": ev.index(),
                "self_parent": ev.self_parent(),
                "other_parent": ev.other_parent(),
                "round": ann["round"],
                "witness": ann["witness"],
                "famous": ann["famous"],
                "round_received": ev.round_received,
                "txs": len(ev.transactions() or []),
                "topo": ev.topological_index,
            })
        events.sort(key=lambda e: e["topo"])
        return {
            "from_round": lo,
            "to_round": last,
            "last_consensus_round": self.last_consensus_round,
            "participants": {pk: pid
                             for pk, pid in self.participants.items()},
            "events": events,
            "truncated": truncated,
        }

    # -- checkpoint / recovery --------------------------------------------

    def reset(self, roots: Dict[str, Root]) -> None:
        self.store.reset(roots)
        self.undetermined_events = []
        self.undecided_rounds = []
        self.pending_loaded_events = 0
        self.topological_index = 0

        self._init_memo_caches()

    def get_frame(self) -> Frame:
        last_consensus_round_index = (
            self.last_consensus_round if self.last_consensus_round is not None else 0
        )
        last_consensus_round = self.store.get_round(last_consensus_round_index)
        witness_hashes = last_consensus_round.witnesses()

        # Per-creator floor of UNDETERMINED events: an event not yet in
        # any block whose index sits below the witness cut would be
        # silently dropped from the frame — the fast-syncing peer could
        # then never recover its transactions, and its re-decided
        # boundary blocks would miss them (observed by the kill -9
        # harness as a block diverging from the survivors'). Pull each
        # creator's cut back to cover them.
        oldest_undetermined: Dict[str, int] = {}
        for x in self.undetermined_events:
            try:
                ex = self.store.get_event(x)
            except StoreError:
                continue
            c = ex.creator()
            if ex.index() < oldest_undetermined.get(c, MAX_INT32):
                oldest_undetermined[c] = ex.index()

        def cut_to(first: Event):
            """Root before `first` + every event of its creator from
            `first` on, honoring the undetermined floor."""
            c = first.creator()
            floor = min(first.index(), oldest_undetermined.get(c, MAX_INT32))
            if floor < first.index():
                first = self.store.get_event(
                    self.store.participant_event(c, floor))
            root = Root(
                x=first.self_parent(),
                y=first.other_parent(),
                index=first.index() - 1,
                round=self.round(first.self_parent()),
                others={},
            )
            evs = [first] + [
                self.store.get_event(e)
                for e in self.store.participant_events(c, first.index())
            ]
            return root, evs

        events: List[Event] = []
        roots: Dict[str, Root] = {}
        for wh in witness_hashes:
            w = self.store.get_event(wh)
            root, evs = cut_to(w)
            roots[w.creator()] = root
            events.extend(evs)

        # Participants without a witness in the last consensus round use
        # their last known event (hashgraph.go:942-973).
        for p in self.participants:
            if p not in roots:
                last, is_root = self.store.last_from(p)
                if is_root:
                    root = self.store.get_root(p)
                else:
                    ev = self.store.get_event(last)
                    root, evs = cut_to(ev)
                    events.extend(evs)
                roots[p] = root

        events.sort(key=lambda e: e.topological_index)

        # Events whose other-parents fall outside the Frame get them
        # recorded in the creator's Root.Others (hashgraph.go:977-994).
        treated: Dict[str, bool] = {}
        for ev in events:
            treated[ev.hex()] = True
            other_parent = ev.other_parent()
            if other_parent != "" and not treated.get(other_parent, False):
                if ev.self_parent() != roots[ev.creator()].x:
                    roots[ev.creator()].others[ev.hex()] = other_parent

        return Frame(roots=roots, events=events)

    def bootstrap(self) -> None:
        """Replay a persistent store's topological event log and recompute
        consensus to the tip (hashgraph.go:1008-1037).

        Exactly-once redelivery across restarts: commits for rounds at
        or below the store's durable delivered-block anchor
        (`last_committed_block`, advanced by the node after each block
        reaches the application) are suppressed — that history was
        already applied, and re-emitting it would double-apply app
        state (and, with a bounded commit queue and no consumer running
        yet, risk deadlocking startup). Anything the replay decides
        ABOVE the anchor was committed by consensus but never durably
        delivered — the torn tail of a crash between consensus and app
        delivery — and is re-emitted so the interrupted delivery
        completes.

        The whole replay (event re-inserts + the recompute's round and
        block writes) runs as one store batch: a restart killed during
        bootstrap leaves the database exactly as the previous crash
        left it."""
        db_events = getattr(self.store, "db_topological_events", None)
        if db_events is None:
            return
        saved_cb = self.commit_callback
        anchor = self.store.last_committed_block()

        def gated(block: Block) -> None:
            if block.round_received <= anchor:
                return
            saved_cb(block)

        self.commit_callback = gated if saved_cb is not None else None
        self.store.begin_batch()
        try:
            for e in db_events():
                # Strip persisted consensus marks (cf. failover replay):
                # the recompute below re-derives them; letting stale
                # ones leak into find_order before the replay decides
                # the round would bypass the recompute.
                e.round_received = None
                e.consensus_timestamp = ZERO_TIME
                try:
                    self.insert_event(e, True)
                except StoreError:
                    # Same fallback as fast_forward replay: an event
                    # whose other-parent predates the store's roots
                    # (a post-fast-forward log, Root.others) cannot
                    # carry wire info.
                    self.insert_event(e, False)
            self.divide_rounds()
            self.decide_fame()
            self.find_order()
        finally:
            self.store.commit_batch()
            self.commit_callback = saved_cb
