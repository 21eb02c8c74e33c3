"""Epidemic broadcast tree — Plumtree-style two-tier dissemination.

The reference's gossip is a random-peer pull loop: every event is
re-offered until every peer has pulled it, which the PR 10 soak ledger
convicted at n=32 (redundancy ratio 0.77-0.98 — about one duplicate
delivered, and ECDSA-verified, per new event — and propagation p99 of
29.3 s). This module replaces dissemination with the two-tier scheme of
Leitao et al.'s "Epidemic Broadcast Trees" (Plumtree), adapted to a
hashgraph where payloads are DAG events with parent dependencies:

- **Eager push**: fresh events (own self-events and first-seen remote
  inserts) are pushed immediately along this node's *eager* peer set —
  the edges of a lazily-repaired spanning tree — riding the existing
  EagerSync RPC (columnar on the TCP wire) with a `Plum` marker.
  Pushes to one peer coalesce under a pacing interval and flow through
  a bounded per-peer window, so a cascade relays batches, not events.
- **Lazy repair**: the remaining (*lazy*) peers receive compact IHAVE
  digests (event hash + creator/index). A digest for an event still
  missing after `graft_timeout` triggers GRAFT — a known-map pull from
  the announcer that also promotes that edge to eager — so a broken
  tree heals within one timer. A fully-duplicate eager delivery
  answers PRUNE, demoting the redundant edge to lazy; together GRAFT
  and PRUNE converge the eager graph toward one delivery per event.
- **Peer scoring + flow control**: eager-set choices feed on the PR 10
  per-peer new/duplicate accounting and the PR 5 RTT histograms
  (Node.peer_score): promotions prefer peers whose deliveries are
  mostly new and fast. A peer whose push window stays full sheds to
  lazy instead of queueing, and a peer whose circuit breaker trips
  (PR 2) is demoted immediately — partitions and crashes repair
  through the lazy plane when the breaker closes again.

Events are not independent messages: an eager batch is insertable only
if the receiver holds its parents. Batches relay in insertion order so
gaps only open at tree churn; a gapped batch answers success=False and
the receiver repairs by GRAFTing the sender (an exact known-map diff),
which is why GRAFT carries a known map instead of a single hash.

The periodic pull `SyncRequest` loop stays on as a low-frequency
anti-entropy backstop (`Config.anti_entropy_interval`), and
`Config.plumtree=False` (`--no_plumtree`) restores the pull-only
reference behavior byte-for-byte. See docs/gossip.md.
"""

from __future__ import annotations

import math
import queue
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..net.transport import (
    GraftRequest,
    IHaveRequest,
    PruneRequest,
    EagerSyncRequest,
    TransportError,
)
from ..telemetry import InstrumentedQueue, QueueInstrument

# Digest entry: (creator_id, index, event_hex).
Digest = Tuple[int, int, str]

# Per-digest wire cost used for max_msg_bytes chunking: 40 bytes packed
# (net/columnar.py ColumnarDigests row) but ~90 on the legacy JSON
# framing — chunk by the conservative figure so either wire fits.
_DIGEST_WIRE_BYTES = 96
# Events per eager push batch, a hard sanity cap under the pacing
# coalescing (a batch beyond this rides the next window).
_MAX_PUSH_BATCH = 512
# Consecutive window overflows before a slow peer sheds to lazy.
_SHED_OVERFLOWS = 3
# Windowed PRUNE trigger: once an inbound eager edge has delivered at
# least _PRUNE_WINDOW events, a duplicate share above _PRUNE_SHARE
# marks it redundant (everything it carries arrived first on a faster
# edge). Coalesced batches are rarely 100% duplicate, so the classic
# per-message Plumtree rule alone never fires — the window is what
# makes the tree converge under batching.
_PRUNE_WINDOW = 24
_PRUNE_SHARE = 0.6
# GRAFT retry attempts per missing digest before the anti-entropy
# backstop is left to pick it up.
_MAX_GRAFT_ATTEMPTS = 3


class _PeerPush:
    """Per-peer eager push state: the bounded buffer (the in-flight
    window), its sender thread, and pacing/overflow bookkeeping.
    Buffer entries are (enqueue_ts, Event) — the timestamp drives the
    freshness TTL at send time."""

    __slots__ = ("addr", "buffer", "cond", "last_send", "overflows",
                 "thread", "active", "rtt")

    def __init__(self, addr: str):
        self.addr = addr
        self.buffer: List = []          # (ts, Event) pending, topo order
        self.cond = threading.Condition()
        self.last_send = 0.0
        self.overflows = 0              # consecutive window overflows
        self.thread: Optional[threading.Thread] = None
        self.active = False             # peer currently in the eager set
        self.rtt = 0.0                  # last push round trip (seconds)


class Plumtree:
    def __init__(self, node, peer_addrs: List[str]):
        self.node = node
        conf = node.conf
        self._addrs = list(peer_addrs)
        n = len(peer_addrs) + 1
        fanout = int(getattr(conf, "eager_fanout", 0))
        if fanout <= 0:
            # ~log2(n) capped: a tree of that degree keeps depth
            # O(log n) and the union of n random fanout-sets connected
            # w.h.p., while bounding pre-prune redundancy.
            fanout = max(1, min(4, round(math.log2(max(n, 2)))))
        self.fanout = min(fanout, len(peer_addrs))
        interval = float(getattr(conf, "eager_push_interval", 0.0))
        if interval <= 0:
            interval = min(conf.heartbeat_timeout, 0.025)
        self.push_interval = interval
        self.window = max(64, int(getattr(conf, "plumtree_inflight", 2))
                          * _MAX_PUSH_BATCH)
        self.ihave_interval = float(getattr(conf, "ihave_interval", 0.25))
        self.graft_timeout = float(getattr(conf, "graft_timeout", 0.35))
        # Adaptive graft deadline: the configured timeout is a FLOOR.
        # The effective timer tracks 2x the node's measured propagation
        # p99 (the PR 10 histogram), so the lazy plane never races an
        # eager plane that is merely slow (a CPU-starved or WAN-lagged
        # net) — grafting events that were already in flight re-promotes
        # edges, makes their deliveries duplicate, PRUNEs them, and
        # thrashes the tree into a graft storm.
        self._eff_graft_timeout = self.graft_timeout
        self._eff_refreshed = 0.0
        self.max_msg_bytes = int(getattr(conf, "max_msg_bytes", 32 << 20))
        self.logger = node.logger

        self._lock = threading.Lock()
        rng = random.Random(f"plumtree|{node.id}|{n}")
        eager = rng.sample(self._addrs, self.fanout) \
            if self._addrs else []
        self._eager = set(eager)
        self._push: Dict[str, _PeerPush] = {
            a: _PeerPush(a) for a in self._addrs}
        for a in self._eager:
            self._push[a].active = True
        # IHAVE plane: a bounded ring of recent fresh digests plus a
        # per-peer cursor, so one announcement RPC carries everything
        # since the peer's last one. Peers that fall off the ring's
        # tail are caught by anti-entropy.
        self._digests: List[Digest] = []
        self._digest_base = 0           # seq of self._digests[0]
        self._digest_cap = 8192
        self._peer_seq: Dict[str, int] = {a: 0 for a in self._addrs}
        # Missing tracker: event hex -> (coords, announcers, deadline,
        # attempts). Entries are born by IHAVE digests this node cannot
        # resolve and die on arrival, graft success, or attempt cap.
        self._missing: Dict[str, dict] = {}
        # Inbound-edge duplicate windows: addr -> [new, dup] since the
        # last prune decision (see _PRUNE_WINDOW/_PRUNE_SHARE).
        self._dup_window: Dict[str, List[int]] = {}
        # Addrs with a graft (gap repair or missing-digest pull)
        # currently in flight: one at a time per peer — a graft is a
        # full known-map pull, and a burst of gapped batches must
        # coalesce into ONE repair, not a graft storm.
        self._repairing: set = set()
        # creator participant-id -> gossip addr: relays never push an
        # event back at its own creator (the sender-only exclusion
        # would still echo every event to its origin one hop later).
        self._addr_by_id: Dict[int, str] = dict(
            getattr(node, "_addr_by_id", {}) or {})
        self._threads: List[threading.Thread] = []
        self._started = False
        self._shutdown = threading.Event()

        # -- telemetry (docs/gossip.md / docs/observability.md) --------
        reg = node.registry
        _nl = str(node.id)
        self._m_graft = {
            d: reg.counter("babble_plumtree_graft_total",
                           "GRAFT messages (tree-edge promotions)",
                           node=_nl, dir=d) for d in ("tx", "rx")}
        self._m_prune = {
            d: reg.counter("babble_plumtree_prune_total",
                           "PRUNE messages (tree-edge demotions)",
                           node=_nl, dir=d) for d in ("tx", "rx")}
        self._m_ihave = {
            d: reg.counter("babble_plumtree_ihave_digests_total",
                           "IHAVE digests announced to lazy peers",
                           node=_nl, dir=d) for d in ("tx", "rx")}
        self._m_shed = reg.counter(
            "babble_plumtree_shed_events_total",
            "Fresh events dropped from a full per-peer push window "
            "(the peer repairs through the lazy plane)", node=_nl)
        # Saturation accounting (docs/observability.md "Saturation"):
        # each per-edge push window reports depth/capacity/wait/drops
        # through a QueueInstrument (created lazily per peer); sheds
        # double as queue drops on the same labels. Control jobs
        # (ihave / graft / prune sends) run on a tiny pool so a slow
        # lazy peer cannot stall the timer loop — that queue is
        # instrumented the same way.
        self._reg = reg
        self._nl = _nl
        self._q_inst: Dict[str, QueueInstrument] = {}
        self._control: "queue.Queue[tuple]" = InstrumentedQueue(
            256, QueueInstrument(reg, "plumtree_ctl", 256, node=_nl))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Start the timer + control threads; sender threads spawn per
        eager peer. Before start, enqueue_fresh is a no-op (Node.init's
        index-0 event must not race a transport that is not serving)."""
        with self._lock:
            if self._started or not self._addrs:
                return
            self._started = True
        t = threading.Thread(target=self._timer_loop, daemon=True,
                             name=f"plumtree-timer-{self.node.id}")
        t.start()
        self._threads.append(t)
        for _ in range(2):
            t = threading.Thread(target=self._control_loop, daemon=True,
                                 name=f"plumtree-ctl-{self.node.id}")
            t.start()
            self._threads.append(t)
        with self._lock:
            for addr in list(self._eager):
                self._ensure_sender(addr)

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._lock:
            pushes = list(self._push.values())
        for st in pushes:
            with st.cond:
                st.cond.notify_all()
        for t in self._threads:
            t.join(timeout=1.0)

    # -- views -------------------------------------------------------------

    def eager_peers(self) -> List[str]:
        with self._lock:
            return sorted(self._eager)

    def lazy_peers(self) -> List[str]:
        with self._lock:
            return sorted(set(self._addrs) - self._eager)

    def snapshot(self) -> dict:
        with self._lock:
            eager = sorted(self._eager)
            lazy = sorted(set(self._addrs) - self._eager)
            pending = {a: len(st.buffer)
                       for a, st in self._push.items() if st.buffer}
            missing = len(self._missing)
        return {
            "fanout": self.fanout,
            "eager": eager,
            "lazy": lazy,
            "grafts_tx": int(self._m_graft["tx"].value),
            "grafts_rx": int(self._m_graft["rx"].value),
            "prunes_tx": int(self._m_prune["tx"].value),
            "prunes_rx": int(self._m_prune["rx"].value),
            "ihave_digests_tx": int(self._m_ihave["tx"].value),
            "shed_events": int(self._m_shed.value),
            "missing_tracked": missing,
            "push_backlog": pending,
        }

    def capacity_stats(self) -> dict:
        """Capacity plane (docs/observability.md "Capacity"): retained
        bytes of the tree's bounded state — per-peer push buffers
        (events shared with the store bill pointer+timestamp slots
        plus a sampled payload estimate), the IHAVE digest ring, and
        the missing tracker."""
        from ..telemetry.capacity import event_bytes, sampled_bytes

        with self._lock:
            buffered = [(ts, ev) for st in self._push.values()
                        for (ts, ev) in st.buffer]
            digests = len(self._digests)
            missing = len(self._missing)
        push_rows = len(buffered)
        push_bytes = push_rows * 80 + sampled_bytes(
            (ev for _ts, ev in buffered), push_rows, event_bytes,
            sample=64)
        return {
            "components": {
                "plumtree_push_windows": {
                    "rows": push_rows, "bytes": push_bytes},
                "plumtree_digests": {
                    "rows": digests, "bytes": digests * 200},
                "plumtree_missing": {
                    "rows": missing, "bytes": missing * 400},
            },
        }

    # -- saturation accounting ---------------------------------------------

    def _window_inst(self, addr: str) -> QueueInstrument:
        """Get-or-create the push window's QueueInstrument for a peer
        (depth reads the live buffer at scrape time)."""
        inst = self._q_inst.get(addr)
        if inst is None:
            inst = QueueInstrument(
                self._reg, "plumtree_push", self.window,
                node=self._nl, peer=addr)
            st = self._push.get(addr)
            if st is not None:
                inst.set_depth_fn(lambda st=st: len(st.buffer))
            self._q_inst[addr] = inst
        return inst

    def push_window_stats(self) -> Dict[str, dict]:
        """Per-peer send-window occupancy + wait snapshots for the
        /debug planes — the same instruments /metrics exports."""
        with self._lock:
            rows = [(a, len(st.buffer), st.active)
                    for a, st in self._push.items()]
        out: Dict[str, dict] = {}
        for addr, depth, active in rows:
            snap = self._window_inst(addr).snapshot()
            snap["depth"] = depth
            snap["occupancy"] = round(depth / max(1, self.window), 4)
            snap["eager"] = active
            out[addr] = snap
        return out

    # -- fresh-event intake (called under the node's core lock) ------------

    def enqueue_fresh(self, events: List, exclude_addr: str = "") -> None:
        """Queue fresh events for eager push + IHAVE announcement.
        `exclude_addr` names the peer that delivered them (never push
        an event back up the edge it arrived on). Cheap: list appends
        under the plumtree lock; all sends happen on worker threads."""
        if not self._started or self._shutdown.is_set():
            return
        digests = [(ev.body.creator_id, ev.index(), ev.hex())
                   for ev in events]
        now = time.monotonic()
        notify: List[_PeerPush] = []
        with self._lock:
            self._digests.extend(digests)
            if len(self._digests) > self._digest_cap:
                drop = len(self._digests) - self._digest_cap
                self._digests = self._digests[drop:]
                self._digest_base += drop
            # Arrivals also settle the missing tracker.
            if self._missing:
                for _, _, h in digests:
                    self._missing.pop(h, None)
            by_id = self._addr_by_id
            creators = [by_id.get(ev.body.creator_id) for ev in events]
            for addr in self._eager:
                st = self._push[addr]
                if exclude_addr == addr:
                    continue
                batch = [(now, ev) for ev, cr in zip(events, creators)
                         if cr != addr]
                if not batch:
                    continue
                if len(st.buffer) + len(batch) > self.window:
                    # Window full: shed the overflow (the peer repairs
                    # through IHAVE/anti-entropy) and remember — a peer
                    # that keeps overflowing is slow, not unlucky.
                    overflow = len(st.buffer) + len(batch) - self.window
                    self._m_shed.inc(overflow)
                    self._window_inst(addr).record_drop(overflow)
                    st.overflows += 1
                    batch = batch[:max(0, self.window - len(st.buffer))]
                    if st.overflows >= _SHED_OVERFLOWS:
                        self._demote_locked(addr)
                        continue
                st.buffer.extend(batch)
                notify.append(st)
        for st in notify:
            with st.cond:
                st.cond.notify()

    # -- eager senders -----------------------------------------------------

    def _ensure_sender(self, addr: str) -> None:
        # caller holds self._lock
        st = self._push[addr]
        st.active = True
        if st.thread is None or not st.thread.is_alive():
            st.thread = threading.Thread(
                target=self._sender_loop, args=(st,), daemon=True,
                name=f"plumtree-push-{self.node.id}")
            st.thread.start()

    def _sender_loop(self, st: _PeerPush) -> None:
        """One long-lived sender per eager peer: drain the window into
        paced, coalesced push batches. The RPC blocks HERE — a slow
        peer backs up its own window only, and sheds to lazy when it
        stays full."""
        while not self._shutdown.is_set():
            with st.cond:
                # Parks while demoted (active=False) or idle; the 0.5 s
                # poll catches a re-promotion that raced the notify.
                while (not st.buffer or not st.active) \
                        and not self._shutdown.is_set():
                    st.cond.wait(0.5)
                if self._shutdown.is_set():
                    return
            wait = st.last_send + self.push_interval - time.monotonic()
            if wait > 0:
                if self._shutdown.wait(wait):
                    return
            now = time.monotonic()
            # Freshness TTL: an entry that sat in the window past ~2
            # anti-entropy intervals has already reached the peer on
            # the pull plane — pushing it now would be a guaranteed
            # duplicate (the stale-on-arrival waste measured at n=16).
            ttl = max(0.5, 2.0 * getattr(self.node.conf,
                                         "anti_entropy_interval", 0.25))
            with self._lock:
                if not st.active:
                    # Demoted while pacing: drop the buffer — the lazy
                    # plane owns this edge now.
                    st.buffer = []
                    continue
                if st.rtt > ttl:
                    # Edge-quality gate: a push round trip beyond the
                    # freshness budget means every batch is stale on
                    # arrival (receiver-queue latency) — the edge
                    # cannot function as a tree edge right now. Shed
                    # it to lazy; exact-diff pulls are strictly more
                    # efficient under that kind of saturation, and a
                    # GRAFT re-grows the edge when the peer actually
                    # misses something.
                    self._m_shed.inc(len(st.buffer))
                    self._window_inst(st.addr).record_drop(
                        len(st.buffer))
                    self._demote_locked(st.addr)
                    continue
                expired = 0
                while st.buffer and now - st.buffer[0][0] > ttl:
                    st.buffer.pop(0)
                    expired += 1
                if expired:
                    self._m_shed.inc(expired)
                    self._window_inst(st.addr).record_drop(expired)
                oldest = st.buffer[0][0] if st.buffer else 0.0
                batch = [ev for _, ev in st.buffer[:_MAX_PUSH_BATCH]]
                st.buffer = st.buffer[_MAX_PUSH_BATCH:]
            if not batch:
                continue
            # Window wait of the batch's oldest entry — the per-edge
            # saturation signal (enqueue -> drain into a push RPC).
            self._window_inst(st.addr).observe_wait(
                time.monotonic() - oldest)
            st.last_send = time.monotonic()
            self._send_push(st, batch)

    def _send_push(self, st: _PeerPush, events: List) -> None:
        node = self.node
        addr = st.addr
        try:
            payload = node.core.to_wire_batch(events, node._wire_format)
            req = EagerSyncRequest(node.id, payload, plum=True)
            t0 = time.monotonic()
            resp = node.trans.eager_sync(addr, req)
            st.rtt = time.monotonic() - t0
            node._rtt_hist(addr, "eager").observe(st.rtt)
            node._flow_gossip_hop(payload, "eager", addr)
            st.overflows = 0
            node._peer_ok(addr)
            if not resp.success:
                # Protocol-level gap (receiver lacked a parent): the
                # receiver repairs by GRAFTing us; nothing to do here
                # and NOT a transport failure.
                self.logger.debug(
                    "eager push to %s reported a gap", addr)
        except TransportError as exc:
            self.logger.debug("eager push to %s failed: %s", addr, exc)
            self._requeue(st, events)
            node._peer_failed(addr)
        except Exception as exc:  # noqa: BLE001 - keep the sender alive
            self.logger.error("eager push to %s failed: %s", addr, exc)
            self._requeue(st, events)
            node._peer_failed(addr)

    def _requeue(self, st: _PeerPush, events: List) -> None:
        """Put a failed batch BACK at the window's front: a transient
        failure (busy consumer queue, breaker probe window) must delay
        the edge, not gap it — a dropped batch turns into a permanent
        per-creator gap that only a full-pull graft can close. The
        window bound still applies; what cannot be requeued sheds (the
        lazy plane repairs it), and a demoted edge drops the batch."""
        with self._lock:
            if not st.active:
                return
            room = self.window - len(st.buffer)
            if room < len(events):
                self._m_shed.inc(len(events) - max(0, room))
                self._window_inst(st.addr).record_drop(
                    len(events) - max(0, room))
                st.overflows += 1
                events = events[:max(0, room)]
                if st.overflows >= _SHED_OVERFLOWS:
                    self._demote_locked(st.addr)
                    return
            # Re-stamped at the attempt time, so the freshness TTL
            # keeps counting from roughly when they first went stale.
            st.buffer[:0] = [(st.last_send, ev) for ev in events]

    # -- timer plane: IHAVE announcements + graft deadlines ----------------

    def _timer_loop(self) -> None:
        next_ihave = time.monotonic() + self.ihave_interval
        while not self._shutdown.wait(
                min(self.ihave_interval, self.graft_timeout) / 4.0):
            now = time.monotonic()
            try:
                if now >= next_ihave:
                    next_ihave = now + self.ihave_interval
                    self._announce()
                self._check_missing(now)
            except Exception as exc:  # noqa: BLE001 - keep the timer alive
                self.logger.debug("plumtree timer: %s", exc)

    def _announce(self) -> None:
        """Queue one IHAVE per lazy peer carrying the digests appended
        since that peer's cursor, chunked under max_msg_bytes."""
        jobs: List[tuple] = []
        with self._lock:
            if not self._digests:
                return
            top = self._digest_base + len(self._digests)
            for addr in set(self._addrs) - self._eager:
                since = max(self._peer_seq.get(addr, 0), self._digest_base)
                if since >= top:
                    continue
                digests = self._digests[since - self._digest_base:]
                self._peer_seq[addr] = top
                jobs.append((addr, digests))
        chunk = max(1, (self.max_msg_bytes - 64) // _DIGEST_WIRE_BYTES)
        for addr, digests in jobs:
            for i in range(0, len(digests), chunk):
                self._submit_control(
                    ("ihave", addr, digests[i:i + chunk]))

    def _effective_graft_timeout(self, now: float) -> float:
        """max(configured floor, 2x measured propagation p99), capped —
        refreshed at most once a second (a histogram snapshot per call
        would be timer-loop hot)."""
        if now - self._eff_refreshed >= 1.0:
            self._eff_refreshed = now
            eff = self.graft_timeout
            prop = getattr(self.node.core, "_m_propagation", None)
            if prop is not None and prop.count >= 64:
                p99 = prop.snapshot().quantile(0.99)
                eff = max(eff, min(2.0 * p99, 30.0))
            self._eff_graft_timeout = eff
        return self._eff_graft_timeout

    def _check_missing(self, now: float) -> None:
        has_event = self.node.core.hg.store.has_event
        eff = self._effective_graft_timeout(now)
        due: List[tuple] = []
        with self._lock:
            for h, ent in list(self._missing.items()):
                if now < ent["deadline"] or now - ent["born"] < eff:
                    continue
                if has_event(h):
                    del self._missing[h]
                    continue
                if ent["attempts"] >= _MAX_GRAFT_ATTEMPTS:
                    # Give up: the anti-entropy pull owns it now.
                    del self._missing[h]
                    continue
                ent["attempts"] += 1
                ent["deadline"] = now + 2.0 * eff
                announcers = ent["announcers"]
                # Rotate announcers across attempts; scoring picks the
                # best candidate on the first try.
                pick = self._best_announcer(announcers, ent["attempts"])
                if pick is not None:
                    due.append((pick, h))
        for addr, h in due:
            self._submit_graft(addr, h)

    def _submit_graft(self, addr: str, reason_hex: str = "") -> None:
        """One graft per peer at a time: a second request while one is
        in flight would pull the same diff again (the leading cause of
        graft-leg duplicates under load)."""
        with self._lock:
            if addr in self._repairing:
                return
            self._repairing.add(addr)
        if not self._submit_control(("graft", addr, reason_hex)):
            with self._lock:
                self._repairing.discard(addr)

    def _best_announcer(self, announcers: List[str],
                        attempt: int) -> Optional[str]:
        if not announcers:
            return None
        healthy = [a for a in announcers if self.node.peer_healthy(a)]
        pool = healthy or announcers
        if attempt <= 1:
            return max(pool, key=self.node.peer_score)
        return pool[(attempt - 1) % len(pool)]

    # -- control sends -----------------------------------------------------

    def _submit_control(self, job: tuple) -> bool:
        if self._control.put_drop(job):
            return True
        self.logger.debug("plumtree control queue full: %s dropped",
                          job[0])
        return False

    def _control_loop(self) -> None:
        node = self.node
        while not self._shutdown.is_set():
            try:
                job = self._control.get(timeout=0.1)
            except queue.Empty:
                continue
            kind, addr = job[0], job[1]
            try:
                if kind == "ihave":
                    digests = job[2]
                    node.trans.ihave(addr, IHaveRequest(node.id, digests))
                    self._m_ihave["tx"].inc(len(digests))
                elif kind == "graft":
                    self._do_graft(addr, job[2])
                elif kind == "prune":
                    node.trans.prune(addr, PruneRequest(node.id))
                    self._m_prune["tx"].inc()
            except TransportError as exc:
                self.logger.debug("plumtree %s to %s failed: %s",
                                  kind, addr, exc)
                if kind == "graft":
                    node._peer_failed(addr)
            except Exception as exc:  # noqa: BLE001 - keep the loop alive
                self.logger.debug("plumtree %s to %s failed: %s",
                                  kind, addr, exc)

    def _do_graft(self, addr: str, reason_hex: str = "") -> None:
        """GRAFT = known-map pull + eager promotion of the edge: fetch
        the gap (the missing event and any unseen ancestors) and start
        treating `addr` as a tree neighbor. At most one graft per peer
        is in flight (see schedule_repair)."""
        node = self.node
        try:
            self.promote(addr, reason="graft")
            self._m_graft["tx"].inc()
            with node.core_lock:
                known = node.core.known()
            t0 = time.monotonic()
            resp = node.trans.graft(addr, GraftRequest(node.id, known))
            node._rtt_hist(addr, "graft").observe(time.monotonic() - t0)
            node._peer_ok(addr)
            if resp.sync_limit:
                from .state import NodeState

                node.state.set_state(NodeState.CATCHING_UP)
                return
            if len(resp.events):
                node._throttle_ingest()
                with node.core_lock:
                    node._sync(resp.events, addr, "graft",
                               wrap_fresh_only=True)
        finally:
            with self._lock:
                self._repairing.discard(addr)

    # -- tree mutations ----------------------------------------------------

    def promote(self, addr: str, reason: str = "") -> None:
        """Move a peer into the eager set (GRAFT sent or received,
        repair promotion). Enforces the fan-out cap by demoting the
        lowest-scoring OTHER eager peer."""
        demote: Optional[str] = None
        with self._lock:
            if addr not in self._push or addr in self._eager:
                return
            self._eager.add(addr)
            self._push[addr].overflows = 0
            # A re-grown edge inherits the node's CURRENT congestion
            # estimate (the last anti-entropy pull's round trip), not
            # a clean slate: under saturation a promoted edge would
            # otherwise ship one guaranteed-stale batch before its own
            # first RTT sample demotes it again — the promote/prune
            # churn that kept the n=16 eager plane a duplicate
            # factory. When the cluster is actually fast, the
            # inherited estimate is small and the edge goes live
            # immediately.
            self._push[addr].rtt = getattr(
                self.node, "_last_pull_rtt", 0.0)
            self._dup_window[addr] = [0, 0]
            self._ensure_sender(addr)
            if len(self._eager) > max(self.fanout, 1):
                others = [a for a in self._eager if a != addr]
                demote = min(others, key=self.node.peer_score)
                self._demote_locked(demote)
        if demote is not None:
            self.logger.debug(
                "plumtree: promoted %s (%s), demoted %s (fan-out cap)",
                addr, reason, demote)

    def _demote_locked(self, addr: str) -> None:
        # caller holds self._lock
        self._eager.discard(addr)
        st = self._push.get(addr)
        if st is not None:
            st.active = False
            st.buffer = []
            st.overflows = 0
        # A freshly-demoted lazy peer starts announcing from now, not
        # from the ring tail (it already had everything pushed).
        self._peer_seq[addr] = self._digest_base + len(self._digests)

    def demote(self, addr: str) -> None:
        with self._lock:
            self._demote_locked(addr)

    # -- protocol reactions (called from the node's RPC/breaker paths) -----

    def on_ihave(self, addr: str, digests: List[Digest]) -> None:
        """Record digests this node cannot resolve; the graft timer
        fires only for events the eager plane never delivers."""
        self._m_ihave["rx"].inc(len(digests))
        has_event = self.node.core.hg.store.has_event
        now = time.monotonic()
        with self._lock:
            for cid, idx, h in digests:
                if has_event(h):
                    continue
                ent = self._missing.get(h)
                if ent is None:
                    if len(self._missing) >= 16384:
                        # Bounded tracker: under a digest flood the
                        # anti-entropy pull owns the overflow.
                        continue
                    self._missing[h] = {
                        "coords": (cid, idx),
                        "announcers": [addr],
                        "born": now,
                        "deadline": now + self.graft_timeout,
                        "attempts": 0,
                    }
                elif addr not in ent["announcers"]:
                    ent["announcers"].append(addr)

    def on_graft(self, addr: str) -> None:
        """Inbound GRAFT: the peer wants our pushes — promote the edge
        (the caller serves the diff)."""
        self._m_graft["rx"].inc()
        self.promote(addr, reason="graft_rx")

    def on_prune(self, addr: str) -> None:
        """Inbound PRUNE: our pushes are redundant for this peer."""
        self._m_prune["rx"].inc()
        self.demote(addr)

    def note_push_stats(self, addr: str, new: int, dup: int) -> None:
        """Feed one inbound eager batch's classification into the
        edge's duplicate window — the batched form of Plumtree's
        duplicate-triggered PRUNE. An edge whose recent deliveries are
        mostly duplicates (everything arrived first on a faster edge)
        is demoted both ways: PRUNE tells the sender to stop, and we
        stop pushing them too (unless they are our last eager peer).
        A mostly-new edge resets its window."""
        prune = False
        with self._lock:
            win = self._dup_window.setdefault(addr, [0, 0])
            win[0] += new
            win[1] += dup
            total = win[0] + win[1]
            if total >= _PRUNE_WINDOW:
                if win[1] > total * _PRUNE_SHARE:
                    prune = True
                self._dup_window[addr] = [0, 0]
            if prune and addr in self._eager and len(self._eager) > 1:
                self._demote_locked(addr)
        if prune:
            self._submit_control(("prune", addr))

    def note_duplicate_push(self, addr: str) -> None:
        """Back-compat spelling of a fully-duplicate delivery: feed a
        window-tripping sample (the guard still never strips the last
        eager edge)."""
        self.note_push_stats(addr, 0, _PRUNE_WINDOW)

    def schedule_repair(self, addr: str) -> None:
        """An eager batch from `addr` had a parent gap: pull the exact
        difference from them (runs on the control pool — never on the
        RPC worker). A burst of gapped batches coalesces into one
        repair."""
        self._submit_graft(addr)

    def on_peer_suspended(self, addr: str) -> None:
        """Breaker feedback (PR 2): a tripped peer leaves the eager set
        at once. No eager replacement is promoted here — under global
        saturation every peer trips sporadically, and promoting a
        fresh edge per trip churns the tree into a duplicate storm
        (each new edge delivers stale batches until PRUNEd). The lazy
        plane re-grows edges where they are actually needed: a peer
        missing our events IHAVE-grafts us within a graft timeout."""
        with self._lock:
            if addr in self._eager:
                self._demote_locked(addr)
