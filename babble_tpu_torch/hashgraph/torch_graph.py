"""Device-backed hashgraph engine behind the same Store/engine seam
(counterpart of babble_tpu/hashgraph/tpu_graph.py).

TorchHashgraph presents the exact Hashgraph surface Core drives
(insert_event / run_consensus / known / read_wire_info / get_frame,
reference node/core.go:277-296) but delegates the whole consensus
pipeline — DivideRounds, DecideFame, FindOrder (reference
hashgraph.go:616-858) — to the port's incremental engine
(ops/incremental.py), on the CUDA device unless the caller names
another. The host keeps what a host should: crypto verification,
wire-format resolution, the Store mirror for sync diffs, and block
assembly; per-participant ancestry coordinates and virtual voting live
in device memory.

Inserts are O(1) host work, so insert cost is dominated by the ECDSA
verify, and run_consensus cost is amortized over the undecided tip
instead of the whole DAG. Bookkeeping side effects (RoundInfo rows,
consensus list, blocks, counters) are mirrored into the Store from the
engine's RunDelta so /Stats, frames, and persistence behave identically
to the host engine. An engine failure propagates to the caller: this
class never finishes a pass through the host engine it inherits from.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..common import StoreError, StoreErrType, is_store_err
from ..gojson import Timestamp, ZERO_TIME
from ..ops.incremental import IncrementalEngine, RunDelta, ZERO_TIME_NS
from ..telemetry.trace import SpanRing
from .block import Block
from .event import Event
from .graph import ForkError, Hashgraph, InsertError, middle_bit
from .root import Root
from .round_info import RoundInfo
from .store import Store


class TorchHashgraph(Hashgraph):
    def __init__(
        self,
        participants: Dict[str, int],
        store: Store,
        commit_callback: Optional[Callable[[Block], None]] = None,
        *,
        capacity: int = 256,
        block: int = 256,
        k_capacity: int = 64,
        mesh=None,
        prewarm: bool = False,
        device=None,
        trace: Optional[SpanRing] = None,
    ):
        super().__init__(participants, store, commit_callback)
        self._capacity = capacity
        self._block = block
        self._k_capacity = k_capacity
        self._mesh = mesh
        # The owner's span ring, which every engine of this graph
        # records its pass spans on (a no-op ring when none is given).
        self._trace = trace
        self.engine = IncrementalEngine(
            len(participants), capacity=capacity, block=block,
            k_capacity=k_capacity, mesh=mesh, device=device, trace=trace)
        self.device = self.engine.device
        if prewarm:
            # Build the kernel and make the first allocations now, so
            # the first live syncs do not pay them.
            self.engine.prewarm()
        self._eid_of: Dict[str, int] = {}
        # eid -> hex only; Event objects stay in the Store so its cache
        # bound (not this map) governs host memory.
        self._hex_by_id: List[str] = []
        # Mirror the host engine's initial queue (graph.py / reference
        # hashgraph.go: UndecidedRounds starts [0]).
        self.undecided_rounds = list(self.engine.undecided_rounds)

    def close(self) -> None:
        """Stop the engine's staging worker (a later pass restarts it)."""
        self.engine.close()

    # -- insertion: host checks + device append -----------------------------

    def _check_event(self, event: Event) -> None:
        """The insert pipeline's checks: signature, then self-parent
        (a ForkError passes through as is), then other-parent."""
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

    def _register(self, event: Event, eid: int) -> None:
        ehex = event.hex()
        self._eid_of[ehex] = eid
        self._hex_by_id.append(ehex)
        self.store.set_event(event)
        self.undetermined_events.append(ehex)
        if event.is_loaded():
            self.pending_loaded_events += 1

    def insert_event(self, event: Event, set_wire_info: bool) -> None:
        self._check_event(event)
        event.topological_index = self.topological_index
        self.topological_index += 1
        if set_wire_info:
            self._set_wire_info(event)

        eid = self.engine.append(
            self._eid_of.get(event.self_parent(), -1),
            self._eid_of.get(event.other_parent(), -1),
            self.participants[event.creator()], event.index(),
            middle_bit(event.hex()), event.body.timestamp.ns,
        )
        self._register(event, eid)

    def insert_wire_batch(self, events: List[Event]) -> None:
        """Device-direct batch insert: the host-side checks (signature
        memo, parent checks, topo index, Store mirror) run per event
        exactly as insert_event does, but the engine append is DEFERRED
        into numpy staging columns and landed with ONE vectorized
        `append_batch`.

        Failure semantics match the serial loop: a bad event aborts at
        its batch position with the validated prefix inserted (the
        finally flushes the staged prefix so `_eid_of` never points at
        ids the engine does not have)."""
        if not events:
            return
        engine = self.engine
        e0 = engine.e
        cols: List[tuple] = []
        try:
            for ev in events:
                self._check_event(ev)
                ev.topological_index = self.topological_index
                self.topological_index += 1
                ehex = ev.hex()
                cols.append((
                    self._eid_of.get(ev.self_parent(), -1),
                    self._eid_of.get(ev.other_parent(), -1),
                    self.participants[ev.creator()], ev.index(),
                    middle_bit(ehex), ev.body.timestamp.ns))
                self._register(ev, e0 + len(cols) - 1)
        finally:
            if cols:
                sp, op, cr, idx, coin, ts = zip(*cols)
                got = engine.append_batch(
                    np.asarray(sp, np.int32), np.asarray(op, np.int32),
                    np.asarray(cr, np.int32), np.asarray(idx, np.int32),
                    np.asarray(coin, np.bool_), np.asarray(ts, np.int64))
                if got != e0:
                    raise RuntimeError(
                        f"engine appended the batch at {got}, expected {e0}")

    # -- consensus: one device pass + Store mirroring -----------------------

    def run_consensus(self, unlocked=None) -> None:
        delta = self.engine.run(unlocked=unlocked)
        self._apply_delta_atomically(delta)

    # Async pipeline seam (the node's consensus loop with pipeline
    # depth > 0): dispatch enqueues the whole device pass and returns
    # immediately; collect blocks only on the packed commit-delta pull
    # and mirrors it into the Store. Between the two calls gossip keeps
    # inserting — ingest of pass k+1 overlaps device compute of pass k.

    def dispatch_consensus(self, unlocked=None):
        return self.engine.dispatch(unlocked=unlocked)

    def collect_consensus(self, pending, unlocked=None) -> None:
        delta = self.engine.collect(pending, unlocked=unlocked)
        self._apply_delta_atomically(delta)

    def abandon_consensus(self, pending) -> None:
        self.engine.abandon(pending)

    def _apply_delta_atomically(self, delta: RunDelta) -> None:
        """Mirror one device pass into the Store as one atomic batch.
        The batch opens AFTER the device wait (engine.run/collect do no
        store writes), so it never spans the unlocked seam."""
        self.store.begin_batch()
        try:
            self._apply_delta(delta)
        finally:
            self.store.commit_batch()

    def divide_rounds(self) -> None:  # test-surface compatibility
        self.run_consensus()

    def decide_fame(self) -> None:
        pass

    def find_order(self) -> None:
        pass

    def _get_or_new_round(self, r: int) -> RoundInfo:
        try:
            return self.store.get_round(r)
        except StoreError as err:
            if not is_store_err(err, StoreErrType.KEY_NOT_FOUND):
                raise
            return RoundInfo()

    def _apply_delta(self, delta: RunDelta) -> None:
        # DivideRounds mirror (hashgraph.go:616-646).
        touched: Dict[int, RoundInfo] = {}
        for eid, rnd, wit in delta.new_rounds:
            ri = touched.get(rnd)
            if ri is None:
                ri = touched[rnd] = self._get_or_new_round(rnd)
            ri.queued = True
            ri.add_event(self._hex_by_id[eid], wit)
        # DecideFame mirror (hashgraph.go:649-730).
        for rnd, eid, famous in delta.fame_updates:
            ri = touched.get(rnd)
            if ri is None:
                ri = touched[rnd] = self._get_or_new_round(rnd)
            ri.set_fame(self._hex_by_id[eid], famous)
        for rnd, ri in sorted(touched.items()):
            self.store.set_round(rnd, ri)
        self.undecided_rounds = list(self.engine.undecided_rounds)
        if delta.last_consensus_round is not None and (
            self.last_consensus_round is None
            or delta.last_consensus_round > self.last_consensus_round
        ):
            self.last_consensus_round = delta.last_consensus_round
            self.last_commited_round_events = delta.last_commited_round_events

        # FindOrder mirror (hashgraph.go:801-858): sort this call's batch
        # by (roundReceived, consensusTimestamp, raw big-int S) — the
        # ConsensusSorter with its never-populated-PRN quirk
        # (consensus_sorter.go:21-52) — then assemble per-call blocks.
        if not delta.new_received:
            return
        batch = []
        for eid, rr, cts_ns in delta.new_received:
            ev = self.store.get_event(self._hex_by_id[eid])
            ev.set_round_received(rr)
            ev.consensus_timestamp = (
                ZERO_TIME if cts_ns == ZERO_TIME_NS else Timestamp(cts_ns))
            self.store.set_event(ev)
            batch.append(ev)
        batch.sort(
            key=lambda e: (e.round_received, e.consensus_timestamp.ns, int(e.s))
        )
        received = {e.hex() for e in batch}
        self.undetermined_events = [
            x for x in self.undetermined_events if x not in received
        ]

        block_map: Dict[int, Block] = {}
        block_order: List[int] = []
        for e in batch:
            self.store.add_consensus_event(e.hex())
            self.consensus_transactions += len(e.transactions() or [])
            if e.is_loaded():
                self.pending_loaded_events -= 1
            b = block_map.get(e.round_received)
            etxs = e.transactions()
            if b is None:
                b = Block(e.round_received, None if etxs is None else list(etxs))
                block_order.append(e.round_received)
                block_map[e.round_received] = b
            elif etxs:
                if b.transactions is None:
                    b.transactions = list(etxs)
                else:
                    b.transactions.extend(etxs)
        for rr in block_order:
            block = block_map[rr]
            self.store.set_block(block)
            if self.commit_callback is not None and block.transactions:
                self.commit_callback(block)

    # -- queries served from device results ---------------------------------

    def round(self, x: str) -> int:
        eid = self._eid_of.get(x)
        if eid is None:
            return -1
        return self.engine.round_of(eid)

    def witness(self, x: str) -> bool:
        eid = self._eid_of.get(x)
        if eid is None:
            return False
        return bool(self.engine.witness[eid])

    def round_received(self, x: str) -> int:
        eid = self._eid_of.get(x)
        if eid is None:
            return -1
        r = int(self.engine.rr[eid])
        return r if r >= 0 else -1

    # -- checkpoint / recovery ----------------------------------------------

    def reset(self, roots: Dict[str, Root]) -> None:
        """Frame reset (reference hashgraph.go:879-898): clear the
        Store down to the given Roots and rebuild the device engine
        with offset chain bases — each Root contributes its round as
        the creator's root_round (propagated by the closure as rbase)
        and index+1 as the creator's chain-position offset. Replayed
        frame events then append at position 0 exactly as a fresh
        graph's do."""
        super().reset(roots)
        self.engine.close()  # stop the old engine's staging worker
        n = len(self.participants)
        root_round = np.full(n, -1, np.int32)
        index_base = np.zeros(n, np.int32)
        for pk, pid in self.participants.items():
            r = roots.get(pk)
            if r is not None:
                root_round[pid] = r.round
                index_base[pid] = r.index + 1
        self.engine = IncrementalEngine(
            n, root_round, capacity=self._capacity, block=self._block,
            k_capacity=self._k_capacity, index_base=index_base,
            from_reset=True, mesh=self._mesh, device=self.device,
            trace=self._trace)
        self._eid_of = {}
        self._hex_by_id = []
        self.undecided_rounds = list(self.engine.undecided_rounds)
