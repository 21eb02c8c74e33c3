"""Per-node consensus facade: owns the key and the hashgraph engine,
tracks the head/sequence, computes sync diffs, and drives the consensus
pipeline.

Reference node/core.go:15-369. Per-phase wall-clock (ns) around
diff/sync/run_consensus mirrors the reference's phase logging
(node/node.go:238-240,397-402; node/core.go:277-296) and is surfaced in
node stats / the HTTP service."""

from __future__ import annotations

import heapq
import logging
import time
from typing import Callable, Dict, List, Optional

from .. import crypto
from ..common import StoreError
from ..hashgraph.block import Block
from ..hashgraph.event import Event, WireEvent
from ..hashgraph.graph import Hashgraph
from ..hashgraph.store import Store
from ..telemetry import Registry, SpanRing, get_registry
from ..devices import resolve_device
from .ingest import active_backend, resolve_verify_workers, verify_events


class Core:
    def __init__(
        self,
        id: int,
        key,
        participants: Dict[str, int],
        store: Store,
        commit_callback: Optional[Callable[[Block], None]] = None,
        engine: str = "torch",
        engine_mesh: int = 0,
        engine_prewarm: bool = False,
        engine_opts: Optional[Dict] = None,
        verify_workers: int = -1,
        device_verify: bool = False,
        runtime: str = "threads",
        trace: Optional[SpanRing] = None,
        registry: Optional[Registry] = None,
        compile_cache_dir: str = "",
        clock=None,
        gossip_observatory: bool = True,
    ):
        self.id = id
        self.key = key
        self._pub_key: Optional[bytes] = None
        self._hex_id: str = ""
        self._commit_callback = commit_callback
        # Device-side verify (ROADMAP crypto-plane lever 2,
        # docs/ingest.md "Crypto plane") runs on the engine's device
        # (engine_opts["device"], CUDA unless another is named), with
        # the host engine too; resolved here, so a node that asks for
        # it with no GPU refuses to start.
        self._verify_device = (
            resolve_device((engine_opts or {}).get("device"))
            if device_verify else None)
        # The span ring (see self.trace below), shared with the engine.
        ring = trace if trace is not None else SpanRing(0)
        # "host" | "device" | "failed_over" (device engine replaced by
        # the host engine after repeated device-pass failures).
        self.engine_state = "device" if engine == "torch" else "host"
        self.engine_failovers = 0
        if engine == "torch":
            # Device-backed consensus behind the same seam: the port's
            # TorchHashgraph over its incremental engine, on CUDA unless
            # engine_opts["device"] names another device (the CPU tests
            # pass "cpu"). The kernel library builds into build/kernels/
            # at first use; there is no compile cache to point anywhere.
            from ..hashgraph.torch_graph import TorchHashgraph
            from ..ops.mesh import engine_mesh_devices

            # The participant columns shard over the mesh, so d shrinks
            # to the largest divisor of the validator count (with a
            # warning) rather than refusing to boot; shard p goes on
            # cuda:(p mod the card count), so shards may share a card.
            opts = engine_opts or {}
            mesh = engine_mesh_devices(engine_mesh, len(participants),
                                       opts.get("device"))
            # Pre-size the engine so steady operation never crosses a
            # growth threshold: every capacity/chain-bucket doubling
            # reallocates and copies the engine's tables while the
            # dispatch holds the core lock (gossip included). 64k
            # events and a ~256MB chain-table budget push both
            # boundaries past any realistic session at small n; chain
            # buckets scale down with n^2 so large-validator nodes keep
            # the same budget.
            n_p = len(participants)
            cap = opts.get("capacity", 65536)
            k_cap = opts.get(
                "k_capacity",
                max(64, min(cap, (1 << 28) // (4 * n_p * n_p))))
            self.hg: Hashgraph = TorchHashgraph(
                participants, store, commit_callback,
                capacity=cap, block=opts.get("block", 512),
                k_capacity=k_cap, mesh=mesh, prewarm=engine_prewarm,
                device=opts.get("device"), trace=ring)
        elif engine == "host":
            self.hg = Hashgraph(participants, store, commit_callback)
        elif engine == "tpu":
            raise ValueError(
                "engine 'tpu' is the JAX package's device engine; the "
                "port's device engine is 'torch'")
        else:
            raise ValueError(f"unknown consensus engine {engine!r}")
        self.participants = participants
        self.reverse_participants = {pid: pk for pk, pid in participants.items()}
        self.verify_workers = resolve_verify_workers(verify_workers)
        # Device-side verify: route sync-batch ECDSA to the port's
        # P-256 kernel (ops/p256.py, csrc/p256.cu) on _verify_device
        # instead of the host pool. Off by default — the flag is the
        # kill switch — and a kernel failure raises out of the sync: no
        # host fallback.
        self.device_verify = bool(device_verify)
        if self.device_verify:
            # Every event comes from a participant: pin their window
            # tables (ops/p256.py `window_tables`), so no sync rebuilds
            # one that an LRU of 256 evicted.
            from ..ops import p256

            p256.window_tables.register(
                bytes.fromhex(pk[2:]) for pk in participants)
        # Execution runtime for the verify plane (docs/runtime.md):
        # per-CORE, not process-global, so one test process can run a
        # mixed threads/procs cluster and pin byte-identical consensus
        # across the two.
        from .runtime import resolve_runtime
        self.runtime = resolve_runtime(runtime)
        self.head = ""
        self.seq = -1
        self.transaction_pool: List[bytes] = []
        # Trace ids of SAMPLED pool transactions (docs/observability.md
        # "Transaction tracing"): empty unless the owner stamps one, so
        # the untraced hot path pays a single falsy check. The id is
        # copied onto the self-event that wraps the tx and rides its
        # wire form across gossip hops.
        self._pool_trace_ids: Dict[bytes, int] = {}
        # phase -> (last ns, total ns, calls); written only under the
        # node's core lock, like every other Core mutation.
        self.phase_ns: Dict[str, List[int]] = {}
        # Telemetry (docs/observability.md): per-phase wall-clock
        # DISTRIBUTIONS (phase_ns keeps only last/total/calls) and the
        # full consensus-pass wall — for the pipelined device engine
        # that is dispatch -> collect across worker wakes, stamped on
        # the PendingPass itself. The span ring records sync /
        # consensus-pass / failover spans for /debug/trace; a no-op
        # ring when the owner (tests constructing Core bare) passes
        # none.
        self.trace = ring
        # The owning Node shares its per-node registry; a Core built
        # bare (tests, tools) records into the process-global one.
        self._registry = registry if registry is not None else get_registry()
        self._node_label = str(id)
        self._phase_hist: Dict[str, object] = {}
        self._m_pass = self._registry.histogram(
            "babble_engine_pass_seconds",
            "Consensus pass wall seconds (device: dispatch->collect)",
            node=self._node_label)
        self._m_failovers = self._registry.counter(
            "babble_engine_failovers_total",
            "Device->host engine failovers", node=self._node_label)
        # Fork/equivocation detection (docs/observability.md
        # "Consensus health"): the insert path's evidence records feed
        # a per-creator counter. The aggregate child is created eagerly
        # so the family is scrapeable (at 0) before any fork exists.
        self._m_forks = self._registry.counter(
            "babble_forks_total",
            "Equivocations detected (two signed events by one creator "
            "at one index)", node=self._node_label)
        self._fork_counters: Dict[str, object] = {}
        self.hg.fork_observer = self._on_fork_evidence
        # Gossip efficiency observatory (docs/observability.md "Gossip
        # efficiency"): the owning Node passes its ClusterClock so
        # self-events get a cluster-epoch creation stamp (the
        # `_CreateNs` wire sidecar) and remote inserts observe
        # create->insert latency. A bare Core (tests, tools) has no
        # clock: nothing is stamped and the wire forms stay
        # byte-identical to the pre-observatory encoding.
        self.clock = clock
        self._observatory = bool(gossip_observatory)
        # Epidemic broadcast hook (node/plumtree.py, docs/gossip.md):
        # called (under the owner's core lock) with every list of
        # freshly-INSERTED events — first-seen remote inserts and this
        # node's own self-events, in insertion order — so the owning
        # node can eager-push them along its tree edges. None (bare
        # Core, plumtree off) costs one falsy check per batch.
        self.fresh_observer = None
        # Wrap pacing (docs/gossip.md, plumtree legs only): minimum
        # seconds between this node's wrap self-events. 0 = wrap per
        # sync (reference behavior). The owning node raises it with
        # measured congestion (pull RTT), so a saturated cluster
        # batches many syncs/txs into ONE wrap instead of minting an
        # event per sync — at n=32 on one core, per-sync wraps alone
        # produce more ECDSA work than the machine has (every node
        # verifies every event), and consensus never catches up.
        self.wrap_min_interval = 0.0
        self._last_wrap_ts = 0.0
        # Dedup-before-verify (ROADMAP crypto-plane lever 1): hashes of
        # events currently in another batch's unlocked verify window.
        # A concurrent batch offering the same event skips its ECDSA
        # check — the insert loop's has_event/memo re-check keeps
        # correctness — so a duplicate costs a set lookup, not ~98 us
        # of libcrypto. Mutated only under the owner's core lock.
        self._verify_inflight: set = set()
        # Events actually submitted to ECDSA verification (the number
        # the dedup-before-verify satellite drives DOWN; duplicates
        # never reach it). Exposed as a counter so the duplicate-
        # injection test can assert verify work ~= new events.
        self._m_verified = self._registry.counter(
            "babble_verify_events_total",
            "Events submitted to ECDSA signature verification "
            "(duplicates are deduped before verify)",
            node=self._node_label)
        self._m_propagation = (
            self._registry.histogram(
                "babble_propagation_latency_seconds",
                "Event creation (creator's cluster-epoch stamp) -> "
                "local insert latency", node=self._node_label)
            if gossip_observatory else None)

    def _on_fork_evidence(self, record: Dict) -> None:
        """New equivocation evidence from the insert path: count it
        (aggregate + per-creator) and log the alarm. The record itself
        is already persisted by the store."""
        creator = record["creator"]
        self._m_forks.inc()
        child = self._fork_counters.get(creator)
        if child is None:
            child = self._registry.counter(
                "babble_forks_total",
                "Equivocations detected (two signed events by one "
                "creator at one index)",
                node=self._node_label, creator=creator[:18])
            self._fork_counters[creator] = child
        child.inc()
        logging.getLogger("babble_tpu_torch").error(
            "FORK DETECTED: creator %s equivocated at index %d "
            "(%s vs %s) — evidence recorded",
            creator[:18], record["index"],
            record["existing"][:12], record["forged"][:12])

    def forks_detected(self) -> int:
        return int(self._m_forks.value)

    def _timed(self, phase: str, t0: int) -> int:
        """Stamp the phase from `t0` to now; returns now."""
        t1 = time.perf_counter_ns()
        self.count_phase(phase, t1 - t0)
        return t1

    def count_phase(self, phase: str, dt: int, calls: int = 1) -> None:
        """Add one interval of `dt` ns to a phase, counting `calls`:
        1 for a timer, the work items done for a phase that counts
        them (window tables built, signatures verified). Caller holds
        the owner's core lock."""
        ent = self.phase_ns.setdefault(phase, [0, 0, 0])
        ent[0] = dt
        ent[1] += dt
        ent[2] += calls
        hist = self._phase_hist.get(phase)
        if hist is None:
            hist = self._registry.histogram(
                "babble_phase_seconds", "Per-phase wall seconds",
                node=self._node_label, phase=phase)
            self._phase_hist[phase] = hist
        hist.observe(dt / 1e9)

    def pub_key(self) -> bytes:
        if self._pub_key is None:
            self._pub_key = crypto.pub_key_bytes(self.key)
        return self._pub_key

    def hex_id(self) -> str:
        if not self._hex_id:
            self._hex_id = "0x" + self.pub_key().hex().upper()
        return self._hex_id

    def init(self) -> None:
        """Create and insert the signed index-0 event — reference
        node/core.go:80-86. Note the reference passes c.Seq (still 0)
        and a nil payload."""
        initial = Event.new(None, ["", ""], self.pub_key(), self.seq + 1)
        self.sign_and_insert_self_event(initial)

    def bootstrap(self) -> None:
        """Replay a persistent store and recover head/seq — reference
        node/core.go:88-120."""
        self.hg.bootstrap()
        self._recover_head_and_seq()

    def _recover_head_and_seq(self) -> None:
        last, is_root = self.hg.store.last_from(self.hex_id())
        if is_root:
            root = self.hg.store.get_root(self.hex_id())
            self.head = root.x
            self.seq = root.index
        else:
            last_event = self.hg.store.get_event(last)
            self.head = last
            self.seq = last_event.index()

    def fast_forward(self, roots, events: List[Event]) -> None:
        """Fast-sync: reset to a peer's Frame and replay its events,
        then recover our head/seq from the reset store. Completes the
        flow the reference leaves as a stub (node/node.go:432-441) on
        top of GetFrame/Reset (hashgraph.go:879-1002); signatures are
        re-verified by insert_event, so a malicious frame cannot forge
        events. Both engines support Reset (the device engine rebuilds
        with offset chain bases, tpu_graph.reset).

        One store batch spans reset + frame replay: a process killed
        mid-fast-forward leaves the previous durable state intact (the
        restart simply fast-forwards again) instead of a roots-only
        store holding half a frame."""
        store = self.hg.store
        store.begin_batch()
        try:
            self._fast_forward_replay(roots, events)
        finally:
            store.commit_batch()

    def _fast_forward_replay(self, roots, events: List[Event]) -> None:
        self.hg.reset(roots)
        try:
            for ev in events:
                # Recompute wire coordinates against the reset store
                # (they are not part of the Go-JSON body the frame
                # ships) so this node's diffs serve resolvable wire
                # events — best-effort: an event whose other-parent
                # lies OUTSIDE the frame (Root.others) cannot be
                # expressed in the reference's wire format at all (its
                # own SetWireInfo errors there, hashgraph.go:532-567).
                # Such events are pre-frame history: any peer missing
                # them is itself past SyncLimit and will fast-sync
                # rather than pull them from us.
                try:
                    self.insert_event(ev, True)
                except StoreError:
                    self.insert_event(ev, False)
        finally:
            # Even if a (malicious/corrupt) frame event aborts the
            # replay, head/seq must track the RESET store — stale ones
            # would wedge every later self-event and sync.
            self.transaction_pool = []
            self._pool_trace_ids = {}
            self._recover_head_and_seq()

    def sign_and_insert_self_event(self, event: Event) -> None:
        # Creation stamp BEFORE the wire form is ever memoized: the
        # sidecar rides every later relay of this event, so peers can
        # observe create->insert propagation latency against their own
        # cluster epoch (docs/observability.md "Gossip efficiency").
        if self._observatory and self.clock is not None:
            event.create_ns = self.clock.cluster_epoch_ns(
                time.perf_counter_ns())
        event.sign(self.key)
        self.insert_event(event, True)
        self._last_wrap_ts = time.monotonic()
        if self.fresh_observer is not None:
            self.fresh_observer([event])

    def insert_event(self, event: Event, set_wire_info: bool) -> None:
        self.hg.insert_event(event, set_wire_info)
        if event.creator() == self.hex_id():
            self.head = event.hex()
            self.seq = event.index()

    def known(self) -> Dict[int, int]:
        """Known map (participant id -> last index). Timed as the
        `known` phase: the walk is O(n) in cluster size and runs
        several times per gossip round (pull request, serve, push
        gate), so it is the suspected bookkeeping term behind the
        node16 < node3 inversion — /debug/phases and the soak ledger
        chart its share directly (docs/observability.md "Gossip
        efficiency")."""
        if not self._observatory:
            return self.hg.known()
        t0 = time.perf_counter_ns()
        out = self.hg.known()
        self._timed("known", t0)
        return out

    def over_sync_limit(self, known: Dict[int, int], sync_limit: int) -> bool:
        tot_unknown = 0
        my_known = self.known()
        for i, li in my_known.items():
            if li > known.get(i, -1):
                tot_unknown += li - known.get(i, -1)
        return tot_unknown > sync_limit

    def get_frame(self):
        return self.hg.get_frame()

    def diff(self, known: Dict[int, int]) -> List[Event]:
        """Events we know that `known` doesn't, in topological order —
        reference node/core.go:166-188.

        O(Δ) path: each participant's rolling window is already sorted
        by topological index (a creator's events insert in self-parent
        chain order), so the answer is a merge over just the delta
        suffixes (`participant_event_objects`) instead of a get_event
        per hash plus a global re-sort. Topological indexes are unique
        per engine, so the merge is byte-identical to the old sort."""
        t0 = time.perf_counter_ns()
        chunks: List[List[Event]] = []
        for pid, ct in known.items():
            pk = self.reverse_participants[pid]
            chunk = self.hg.store.participant_event_objects(pk, ct)
            if chunk:
                chunks.append(chunk)
        if not chunks:
            unknown: List[Event] = []
        elif len(chunks) == 1:
            unknown = chunks[0]
        else:
            unknown = list(
                heapq.merge(*chunks, key=lambda e: e.topological_index))
        self._timed("diff", t0)
        return unknown

    def sync(self, unknown: List[WireEvent],
             unlocked=None, wrap_fresh_only: bool = False) -> Dict[str, int]:
        """Insert synced events, then wrap the tx pool and the other
        party's head in a new self-event — reference node/core.go:190-230.

        Batched ingest pipeline (docs/ingest.md): the batch is
        processed as a batch, not event-by-event —

          1. from_wire: materialize every wire event, resolving parent
             coordinates against the batch itself plus one window
             snapshot per creator (read_wire_batch) — under the lock;
          2. verify: ECDSA-check every event that is not already in
             the store on the shared worker pool, with the core lock
             RELEASED via the `unlocked` seam (signature validity is a
             pure function of the event bytes) — results are memoized
             on the events;
          3. insert: re-acquire the lock and run the exact serial
             insert loop; its insert-time verify() is a memo hit, and
             a bad signature raises at the same batch position the
             serial path raised at.

        Events already in the store are SKIPPED rather than failing the
        batch: this node answers pulls and accepts pushes concurrently
        (the core lock is released during the pull round trip — and now
        during verify), so a response computed against a slightly stale
        known-map routinely overlaps a concurrent push. Events are
        content-addressed, so a duplicate is byte-identical and
        skipping is consensus-neutral — whereas aborting the whole
        batch (the reference's behavior under its fully-serialized
        gossip) wedges a node permanently once every peer's syncs
        overlap. Duplicates are excluded from verification too (the
        serial path never verified them either); events that become
        duplicates DURING the unlocked verify window are caught by the
        insert loop's has_event re-check.

        Returns the batch's redundancy classification
        (docs/observability.md "Gossip efficiency") — offered events
        split into new (inserted), duplicate (byte-present already)
        and stale-window (at or below our known tip yet absent: an
        aged-out re-offer or a fork probe) — which the owning Node
        attributes to the peer and leg that delivered the batch."""
        t_sync = time.perf_counter_ns()

        with self.trace.span("sync", cat="sync", batch=len(unknown)):
            stats = self._sync_batch(unknown, unlocked, wrap_fresh_only)
        self._merge_store_phases()
        self._timed("sync", t_sync)
        return stats

    def _sync_batch(self, unknown, unlocked=None,
                    wrap_fresh_only: bool = False) -> Dict[str, int]:
        t0 = time.perf_counter_ns()
        reader = self.hg.wire_reader
        reader.last = None
        events = self.hg.read_wire_batch(unknown)
        t1 = self._timed("from_wire", t0)
        span = self.trace.record("sync.from_wire", t0, t1, cat="sync")
        # Rows materialized, and those the native reader built (its
        # call's wall, with the interpreter lock free).
        self.count_phase("from_wire_rows", t1 - t0, len(events))
        if reader.last is not None:
            rows, n0, n1 = reader.last
            self.count_phase("from_wire_native", n1 - n0, rows)
            self.trace.record("sync.from_wire.native", n0, n1, cat="sync", parent=span,
                              rows=rows)

        # Dedup-before-verify (ROADMAP crypto-plane lever 1): an event
        # already in the store OR currently in another batch's unlocked
        # verify window costs a hash lookup here instead of ~98 us of
        # ECDSA. The rare loser of the in-flight race inserts with a
        # cold memo and verifies inline at insert — correctness is the
        # insert loop's re-check either way.
        t0 = time.perf_counter_ns()
        has_event = self.hg.store.has_event
        inflight = self._verify_inflight
        to_verify = [ev for ev in events
                     if not has_event(ev.hex())
                     and ev.hex() not in inflight]
        verifying = {ev.hex() for ev in to_verify}
        inflight.update(verifying)
        try:
            if to_verify:
                self._m_verified.inc(len(to_verify))
                parts = {} if self.device_verify else None
                if unlocked is not None:
                    with unlocked():
                        t_v = self._verify(to_verify, parts)
                    # the wait to take the core lock back
                    t_l = time.perf_counter_ns()
                    self.count_phase("sync_lock_wait", t_l - t_v)
                    self.trace.record("sync.lock_wait", t_v, t_l, cat="sync")
                else:
                    t_v = self._verify(to_verify, parts)
                if parts:
                    self._count_verify_parts(parts, t_v)
                # Per-backend sub-split of the verify wall
                # (docs/observability.md "Crypto plane"): same interval
                # stamped under `verify_<backend>` so /debug/phases
                # attributes the cost to the backend that paid it.
                self._timed(
                    "verify_" + active_backend(self.device_verify), t0)
            self._timed("verify", t0)
            return self._insert_batch(unknown, events, has_event,
                                      wrap_fresh_only)
        finally:
            inflight.difference_update(verifying)

    def _verify(self, events, parts: Optional[dict]) -> int:
        """verify_events in a `sync.verify` span, with the kernel call's
        parts as its children; returns the end stamp. Touches no Core
        state but the (thread-safe) ring: the core lock may be out."""
        with self.trace.span("sync.verify", cat="sync",
                             events=len(events)) as rec:
            verify_events(events, self.verify_workers, self.device_verify,
                          runtime=self.runtime, device=self._verify_device,
                          parts=parts)
        t1 = time.perf_counter_ns()
        if parts and self.trace.capacity:
            sid, t = rec["span_id"], parts["start_ns"]
            t_p = t + round(parts["prelude"] * 1e9)
            self.trace.record("verify.prelude", t, t_p, cat="verify",
                              parent=sid, signatures=parts["signatures"],
                              tables=parts["tables"],
                              table_hits=parts["table_hits"])
            if "epilogue" in parts:
                t_l = t_p + round((parts["upload"] + parts["kernel"]) * 1e9)
                t_w = t_l + round(parts["download"] * 1e9)
                self.trace.record("verify.launch", t_p, t_l, cat="verify",
                                  parent=sid)
                self.trace.record("verify.wait", t_l, t_w, cat="verify",
                                  parent=sid)
                self.trace.record("verify.epilogue", t_w,
                                  t_w + round(parts["epilogue"] * 1e9),
                                  cat="verify", parent=sid)
        return t1

    def _count_verify_parts(self, parts: dict, t_end: int) -> None:
        """The kernel call's counters as phases: `verify_prelude` (host
        prelude wall), `verify_window_tables` (the wall of the window
        table lookups; calls = tables built), `verify_window_hits` (no
        wall; calls = lookups served without a build) and
        `verify_signatures` (the call's wall to `t_end`; calls =
        signatures)."""
        self.count_phase("verify_prelude", round(parts["prelude"] * 1e9))
        self.count_phase("verify_window_tables", round(parts["tables_s"] * 1e9),
                         parts["tables"])
        self.count_phase("verify_window_hits", 0, parts["table_hits"])
        self.count_phase("verify_signatures", t_end - parts["start_ns"],
                         parts["signatures"])

    def _insert_batch(self, unknown, events, has_event,
                      wrap_fresh_only: bool = False) -> Dict[str, int]:

        # One sync batch = one durable transaction (store.py atomicity
        # seam): the inserted events AND the self-event wrapping them
        # become visible-after-crash together or not at all. On a
        # mid-loop software error the finally commits the inserted
        # prefix — the write-through hot cache already holds those
        # events, and rolling the database back under it would let
        # later has_event hits mask never-persisted events.
        # Redundancy classification inputs (docs/observability.md
        # "Gossip efficiency"): one known-map snapshot per batch tells
        # a stale-window re-offer (index at or below our tip, hash
        # absent) apart from a genuinely new event. The snapshot is an
        # O(n) walk — deliberately charged to the same `known` phase
        # the accounting exists to measure.
        columnar = not isinstance(unknown, list)
        tips = (self.known()
                if (self._observatory and events) else None)
        n_new = n_stale = 0
        prop: List[Event] = []  # fresh remote events carrying a stamp
        fresh_events: List[Event] = []  # first-seen inserts, topo order
        my_hex = self.hex_id()

        t0 = time.perf_counter_ns()
        other_head = ""
        traced: List[int] = []
        store = self.hg.store
        store.begin_batch()
        try:
            batch_insert = getattr(self.hg, "insert_wire_batch", None)
            if batch_insert is not None and columnar:
                # Device-direct seam: hand the whole fresh batch to the
                # engine's vectorized append staging in one call. Head
                # selection below matches the serial loop: the peer's
                # head is the LAST event of its diff even when that
                # event was skipped as a duplicate.
                fresh = [ev for ev in events if not has_event(ev.hex())]
                batch_insert(fresh)
                fresh_events.extend(fresh)
                for ev in fresh:
                    if (tips is not None and ev.index()
                            <= tips.get(ev.body.creator_id, -1)):
                        n_stale += 1
                    else:
                        n_new += 1
                    if ev.trace_id:
                        traced.append(ev.trace_id)
                    if ev.creator() == my_hex:
                        self.head = ev.hex()
                        self.seq = ev.index()
                    elif ev.create_ns:
                        prop.append(ev)
                if events:
                    other_head = events[-1].hex()
            else:
                for k, ev in enumerate(events):
                    if not has_event(ev.hex()):
                        if (tips is not None and ev.index()
                                <= tips.get(ev.body.creator_id, -1)):
                            n_stale += 1
                        else:
                            n_new += 1
                        self.insert_event(ev, False)
                        fresh_events.append(ev)
                        if ev.trace_id:
                            traced.append(ev.trace_id)
                        if ev.create_ns and ev.creator() != my_hex:
                            prop.append(ev)
                    if k == len(events) - 1:
                        # Head selection: the peer's head is the LAST
                        # event of its diff even when that event was
                        # skipped as a duplicate (its stored copy may
                        # differ in wire indexes, but the hash covers
                        # only {Body, R, S}, so the hex names the
                        # stored copy identically).
                        other_head = ev.hex()
            self.trace.record("sync.insert", t0, self._timed("insert", t0),
                              cat="sync")

            # Epidemic broadcast (docs/gossip.md): hand the fresh
            # inserts to the owner BEFORE wrapping them, so the relay
            # buffers stay in topological order (the wrap self-event —
            # whose other-parent is in this batch — notifies from
            # sign_and_insert_self_event right after).
            if self.fresh_observer is not None and fresh_events:
                self.fresh_observer(fresh_events)

            # wrap_fresh_only (plumtree ingest legs, docs/gossip.md):
            # wrap only when the batch delivered something fresh AND
            # consensus still has undecided payload (pending_loaded) to
            # make progress on. A fully-duplicate push must not spawn a
            # wrap self-event — the wrap would itself be relayed,
            # amplifying exactly the redundancy PRUNE is busy
            # converging away — and once every payload event is
            # ordered, the tree quiesces like the reference's
            # need_gossip-gated loop instead of relaying empty wraps
            # forever.
            if wrap_fresh_only:
                wrap = bool(fresh_events) and \
                    self.hg.pending_loaded_events > 0
                # Wrap pacing: under congestion, batch several syncs
                # (and their pooled txs) into one wrap event.
                if (wrap or self.transaction_pool) \
                        and self.wrap_min_interval > 0.0 \
                        and (time.monotonic() - self._last_wrap_ts
                             < self.wrap_min_interval):
                    wrap = False
                    pool_gate = False
                else:
                    pool_gate = True
            else:
                wrap = len(unknown) > 0
                pool_gate = True
            if wrap or (pool_gate and len(self.transaction_pool) > 0):
                new_head = Event.new(
                    list(self.transaction_pool),
                    [self.head, other_head],
                    self.pub_key(),
                    self.seq + 1,
                )
                new_head.trace_id = self._pool_trace_id()
                self.sign_and_insert_self_event(new_head)
                self.transaction_pool = []
        finally:
            store.commit_batch()
        # Flow breadcrumbs for sampled transactions that just landed
        # from a gossip hop — emitted inside the enclosing sync span so
        # the arrows bind to it (bounded: a flood of traced events must
        # not turn the ring into flow spam).
        for tid in traced[:16]:
            self.trace.flow("t", tid, cat="sync", hop="recv")
        # Propagation latency: creator's cluster-epoch stamp -> this
        # insert, observed per fresh REMOTE stamped event against our
        # own cluster epoch (both sides rebase onto the shared epoch,
        # telemetry/clock.py, so cross-node skew cancels to within the
        # handshake's offset error). Clamped at 0: a residual skew
        # must not poison the histogram with negative time.
        if prop and self._m_propagation is not None \
                and self.clock is not None:
            now_ns = self.clock.cluster_epoch_ns(time.perf_counter_ns())
            for ev in prop:
                self._m_propagation.observe(
                    max(0, now_ns - ev.create_ns) / 1e9)
        offered = len(events)
        return {"offered": offered, "new": n_new,
                "duplicate": offered - n_new - n_stale, "stale": n_stale}

    def add_self_event(self) -> None:
        """Wrap a non-empty tx pool in a new self-event — reference
        node/core.go:232-255."""
        if not self.transaction_pool:
            return
        new_head = Event.new(
            list(self.transaction_pool),
            [self.head, ""],
            self.pub_key(),
            self.seq + 1,
        )
        new_head.trace_id = self._pool_trace_id()
        self.sign_and_insert_self_event(new_head)
        self.transaction_pool = []

    def from_wire(self, wire_events: List[WireEvent]) -> List[Event]:
        return [self.hg.read_wire_info(w) for w in wire_events]

    def to_wire(self, events: List[Event]) -> List[WireEvent]:
        return [e.to_wire() for e in events]

    def to_wire_batch(self, events: List[Event], wire_format: str):
        """Pack a diff for the wire in the requested format —
        `ColumnarEvents` ("columnar") or the legacy `List[WireEvent]`
        ("gojson") — stamped as the wire_pack phase. Event.to_wire is
        memoized, so the legacy spelling and the column walk both read
        cached wire forms in steady state."""
        t0 = time.perf_counter_ns()
        if wire_format == "columnar":
            from ..net.columnar import ColumnarEvents

            out = ColumnarEvents.from_events(events)
        else:
            out = [e.to_wire() for e in events]
        self._timed("wire_pack", t0)
        return out

    def run_consensus(self, unlocked=None) -> None:
        t0 = time.perf_counter_ns()
        with self.trace.span("consensus_pass", cat="consensus",
                             engine=self.engine_state):
            self.hg.run_consensus(unlocked=unlocked)
        self._timed("run_consensus", t0)
        self._m_pass.observe((time.perf_counter_ns() - t0) / 1e9)
        self._merge_engine_phases()
        self._merge_store_phases()

    # -- async consensus pipeline (device engine only) ----------------------

    def supports_pipeline(self) -> bool:
        """True when the hashgraph engine exposes the dispatch/collect
        split (the batched device engine); the host engine runs
        consensus inline with each sync."""
        return hasattr(self.hg, "dispatch_consensus")

    def dispatch_consensus(self, unlocked=None):
        """Enqueue one full consensus pass on device and return its
        PendingPass immediately (None when there is nothing to do) —
        no device round trip happens here."""
        t0 = time.perf_counter_ns()
        with self.trace.span("consensus_dispatch", cat="consensus") as rec:
            pending = self.hg.dispatch_consensus(unlocked=unlocked)
            if pending is not None:
                rec["pass_id"] = getattr(pending, "pass_id", 0)
        self._timed("consensus_dispatch", t0)
        if pending is not None:
            # Stamp so collect_consensus can observe the TRUE pass
            # wall — dispatch to collect across worker wakes, which no
            # single phase timer sees in pipelined mode.
            try:
                pending._dispatch_ns = t0
            except AttributeError:
                pass  # slotted PendingPass: skip the wall metric
        return pending

    def collect_consensus(self, pending, unlocked=None) -> None:
        """Block on the pass's commit-delta pull and mirror the result
        into the Store. The only blocking device wait of the pass."""
        if pending is None:
            return
        t0 = time.perf_counter_ns()
        ordered = self.get_consensus_events_count()
        with self.trace.span("consensus_collect", cat="consensus",
                             engine=self.engine_state,
                             pass_id=getattr(pending, "pass_id", 0)):
            self.hg.collect_consensus(pending, unlocked=unlocked)
        end = self._timed("consensus_collect", t0)
        if self.get_consensus_events_count() == ordered:
            # a pass that ordered no new event (calls count them)
            self.count_phase("consensus_empty", end - t0)
        self._m_pass.observe(
            (end - getattr(pending, "_dispatch_ns", t0)) / 1e9)
        self._merge_engine_phases()
        self._merge_store_phases()

    def abandon_consensus(self, pending) -> None:
        if pending is not None and hasattr(self.hg, "abandon_consensus"):
            self.hg.abandon_consensus(pending)

    # -- engine failover (device -> host) -----------------------------------

    def failover_to_host(self) -> None:
        """Rebuild consensus state on the HOST engine from the Store and
        swap it in, abandoning a wedged device engine (caller holds the
        core lock; triggered by the node's watchdog after N consecutive
        device-pass failures).

        Safety: both engines compute byte-identical consensus from the
        same DAG (PR 1 parity tests), so replaying the store's event log
        into a fresh host engine reproduces exactly the prefix the
        device engine already committed — commits for rounds at or
        below the device's last consensus round are suppressed during
        replay (they were already delivered to the app), while anything
        the replay decides BEYOND that round is emitted normally, so no
        committed block is lost or double-applied.

        The rebuilt store is in-memory: failover trades persistence for
        availability (a file-store node that fails over must fast-sync
        after its next restart). Replay re-checks every signature via
        Event.verify(); events verified at original ingest carry their
        memoized verdict (the memo lives in host memory, the same trust
        domain as the store being replayed), so the rebuild is bounded
        by insert/coordinate work rather than O(E) ECDSA."""
        old = self.hg
        if not hasattr(old, "dispatch_consensus"):
            return  # already on the host engine
        with self.trace.span("failover", cat="consensus"):
            self._failover_to_host()
        self._m_failovers.inc()

    def _failover_to_host(self) -> None:
        old = self.hg
        old_store = old.store
        old_lcr = old.last_consensus_round

        # The full surviving event log, oldest first. Event objects are
        # shared with the old store; insert_event below recomputes the
        # host-side coordinates the device engine never populated.
        events: List[Event] = []
        for pk in self.participants:
            for ehex in old_store.participant_events(pk, -1):
                events.append(old_store.get_event(ehex))
        events.sort(key=lambda e: e.topological_index)

        # Carry the roots (non-trivial after a fast-forward reset) into
        # a fresh store: replaying into the OLD store is impossible —
        # its per-participant tips would fail every CheckSelfParent.
        from ..hashgraph.inmem_store import InmemStore

        roots = {pk: old_store.get_root(pk) for pk in self.participants}
        new_store = InmemStore(self.participants, old_store.cache_size())
        new_store.reset(roots)

        cb = self._commit_callback

        def gated_commit(block: Block) -> None:
            # Rounds the device engine already decided were committed
            # before the failure; re-emitting them would double-apply
            # app state (cf. Hashgraph.bootstrap's replay suppression).
            if old_lcr is not None and block.round_received <= old_lcr:
                return
            if cb is not None:
                cb(block)

        new_hg = Hashgraph(self.participants, new_store, gated_commit)
        new_hg.fork_observer = old.fork_observer
        # Fork evidence is forensic state: carry it into the rebuilt
        # store so /debug/consensus keeps showing it after failover.
        for rec in old_store.fork_evidence():
            new_store.add_fork_evidence(rec)
        for ev in events:
            # Strip device-era consensus annotations so the replay
            # recomputes them from scratch (they would otherwise leak
            # into find_order before the host decides the round).
            ev.round_received = None
            try:
                new_hg.insert_event(ev, True)
            except StoreError:
                # Same fallback as fast_forward replay: an other-parent
                # outside the frame cannot carry wire info.
                new_hg.insert_event(ev, False)
        new_hg.run_consensus()
        new_hg.commit_callback = cb

        if hasattr(old, "engine"):
            try:
                old.engine.close()  # stop the device staging worker
            except Exception:  # noqa: BLE001 - the engine is already sick
                pass
        self.hg = new_hg
        self._recover_head_and_seq()
        self.engine_state = "failed_over"
        self.engine_failovers += 1

    def _merge_engine_phases(self) -> None:
        # Device-engine sub-phases (coords/fd/fused dispatch/pull/
        # apply) when the batched pipeline is active.
        engine = getattr(self.hg, "engine", None)
        if engine is None:
            return
        if getattr(engine, "phase_ns", None):
            for ph, ns in engine.phase_ns.items():
                ent = self.phase_ns.setdefault(f"engine_{ph}", [0, 0, 0])
                ent[0] = ns
                ent[1] += ns
                ent[2] += 1
        # The engine's work items (passes, fame steps, undecided rounds,
        # frontier rounds, redos): counts in the calls column, no time.
        take = getattr(engine, "take_pass_counts", None)
        for name, items in (take() if take else {}).items():
            self.phase_ns.setdefault(f"engine_{name}", [0, 0, 0])[2] += items

    def _merge_store_phases(self) -> None:
        # Durable-commit wall (FileStore WAL write + fsync) as a phase:
        # the store's lifetime counters map 1:1 onto a phase_ns triple,
        # so /debug/phases and bench's store_commit_share get the
        # durable-path overhead without a timer on every store call.
        count = getattr(self.hg.store, "fsync_count", 0)
        if count:
            store = self.hg.store
            self.phase_ns["store_commit"] = [
                store.fsync_last_ns, store.fsync_total_ns, count]

    def add_transactions(self, txs: List[bytes],
                         trace_ids: Optional[Dict[bytes, int]] = None
                         ) -> None:
        self.transaction_pool.extend(txs)
        if trace_ids:
            self._pool_trace_ids.update(trace_ids)

    def _pool_trace_id(self) -> int:
        """Trace id for the self-event about to wrap the pool: the
        first sampled tx's id (one id per event — sampling is sparse
        enough that two sampled txs in one pool are noise). Clears the
        stamp map alongside the pool flush the callers do."""
        if not self._pool_trace_ids:
            return 0
        ids = self._pool_trace_ids
        self._pool_trace_ids = {}
        for tx in self.transaction_pool:
            tid = ids.get(tx)
            if tid:
                return tid
        return 0

    def get_head(self) -> Event:
        return self.hg.store.get_event(self.head)

    def get_event(self, hash_: str) -> Event:
        return self.hg.store.get_event(hash_)

    def get_consensus_events(self) -> List[str]:
        return self.hg.consensus_events()

    def get_consensus_events_count(self) -> int:
        return self.hg.store.consensus_events_count()

    def get_undetermined_events(self) -> List[str]:
        return self.hg.undetermined_events

    def get_pending_loaded_events(self) -> int:
        return self.hg.pending_loaded_events

    def get_consensus_transactions(self) -> List[bytes]:
        txs: List[bytes] = []
        for e in self.get_consensus_events():
            txs.extend(self.get_event(e).transactions() or [])
        return txs

    def get_last_consensus_round_index(self) -> Optional[int]:
        return self.hg.last_consensus_round

    def get_consensus_transactions_count(self) -> int:
        return self.hg.consensus_transactions

    def get_last_commited_round_events_count(self) -> int:
        return self.hg.last_commited_round_events

    # -- consensus health passthroughs (docs/observability.md) -------------

    def undecided_witness_count(self) -> int:
        return self.hg.undecided_witness_count()

    def last_decided_fame_round(self) -> int:
        return self.hg.last_decided_fame_round()

    def dag_window(self, from_round=None, max_rounds: int = 8,
                   max_events: int = 4096) -> Dict:
        return self.hg.dag_window(from_round=from_round,
                                  max_rounds=max_rounds,
                                  max_events=max_events)

    def fork_evidence(self) -> List[Dict]:
        return self.hg.store.fork_evidence()

    def engine_cost_report(self, wait_s: float = 0.0):
        """Per-pass compiled-cost attribution for the device engine
        (docs/observability.md "Device profiling"): arms the engine's
        one-shot cost capture if no report exists, optionally waits for
        the next pass to produce it, and mirrors FLOPs/bytes into
        gauges. None on the host engine."""
        engine = getattr(self.hg, "engine", None)
        if engine is None or not hasattr(engine, "request_cost_report"):
            return None
        report = engine.cost_report
        if report is None:
            engine.request_cost_report()
            deadline = time.monotonic() + max(0.0, wait_s)
            while (engine.cost_report is None
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            report = engine.cost_report
        if report:
            for kernel, d in report.items():
                if not isinstance(d, dict):
                    continue
                if "flops" in d:
                    self._registry.gauge(
                        "babble_engine_pass_flops",
                        "Compiled FLOPs of one consensus pass kernel",
                        node=self._node_label, kernel=kernel,
                    ).set(d["flops"])
                if "bytes_accessed" in d:
                    self._registry.gauge(
                        "babble_engine_pass_bytes",
                        "Compiled bytes accessed of one consensus pass "
                        "kernel", node=self._node_label, kernel=kernel,
                    ).set(d["bytes_accessed"])
        # {} = capture armed but no pass ran yet (idle node): callers
        # distinguish "pending" from "not a device engine" (None).
        return report if report is not None else {}

    def capacity_stats(self) -> dict:
        """Capacity plane (docs/observability.md "Capacity"): this
        core's retained state — the store's sizing, the host engine's
        memo tables, the transaction pool, and (device engine) the
        resident HBM carries. Every piece is getattr-guarded: the
        device wrapper has no memo tables, InmemAppProxy has no
        journal, and a scrape must never raise."""
        from ..telemetry.capacity import sampled_bytes

        out: dict = {"components": {}, "caches": {}}
        store = self.hg.store
        scs = getattr(store, "capacity_stats", None)
        if scs is not None:
            s = scs()
            out["components"].update(s.get("components", {}))
            out["caches"].update(s.get("caches", {}))
            if "files" in s:
                out["files"] = s["files"]
        # Host consensus memo tables (hashgraph/graph.py): pure-DAG
        # memos — keys are hash tuples whose strings are shared with
        # the events already billed, so each entry carries tuple +
        # dict-slot overhead.
        memo_rows = 0
        for name in ("_ancestor_cache", "_self_ancestor_cache",
                     "_oldest_self_ancestor_cache",
                     "_strongly_see_cache", "_parent_round_cache",
                     "_round_cache", "_witness_cache"):
            m = getattr(self.hg, name, None)
            if m is not None:
                memo_rows += len(m)
        divided = getattr(self.hg, "_divided", None)
        if divided is not None:
            memo_rows += len(divided)
        if memo_rows:
            out["components"]["consensus_memos"] = {
                "rows": memo_rows, "bytes": memo_rows * 200}
        pool = self.transaction_pool
        out["components"]["transaction_pool"] = {
            "rows": len(pool),
            "bytes": sampled_bytes(pool, len(pool),
                                   lambda t: len(t) + 60),
        }
        engine = getattr(self.hg, "engine", None)
        dms = getattr(engine, "device_memory_stats", None)
        if dms is not None:
            out["engine"] = dms()
        return out

    def engine_backlog(self) -> int:
        """Events appended but not yet folded by a consensus pass —
        0 for the host engine (consensus runs inline with each sync)."""
        engine = getattr(self.hg, "engine", None)
        if engine is None:
            return 0
        return engine.backlog()

    def need_gossip(self) -> bool:
        return self.hg.pending_loaded_events > 0 or len(self.transaction_pool) > 0
