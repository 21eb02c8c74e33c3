"""The consensus health plane's node-side logic
(docs/observability.md "Consensus health").

`DivergenceSentinel` compares this node's committed-block hash chain
(hashgraph/health.py) against the claims peers piggyback on gossip
sync RPCs, firing `babble_divergence_total{peer}` plus a structured
report naming the fork point the moment two nodes' block streams stop
being byte-identical — the live form of the invariant every test
harness audits after the fact.

`StallWatchdog` turns "the network stopped deciding rounds" from a
timeout in somebody's test into a first-class diagnosis: when payload
events are pending but no round has decided for `stall_timeout`
seconds, it walks the pending rounds and reports WHICH round is stuck,
WHICH witnesses are undecided, and WHICH creators have gone silent
(no new events observed) — the creators to cross-check against the
breaker view in /debug/peers. The diagnosis clears itself the moment
a round decides.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..hashgraph.health import SHORT_HEX, BlockHashChain


class DivergenceSentinel:
    """Chain-claim comparison and per-peer progress tracking. One
    sentinel per node; `observe()` runs on gossip threads, `claim()`
    on the pull path, reads on the scrape path — all guarded by one
    small lock (the chain has its own)."""

    MAX_REPORTS = 64

    def __init__(self, registry, node_label: str, logger,
                 history: int = 512):
        self.chain = BlockHashChain(history)
        self._logger = logger
        self._lock = threading.Lock()
        # peer addr -> {"last_agreed": int, "index": int, "round": int,
        #               "c_round": int, "at": monotonic}
        self._peers: Dict[str, Dict] = {}
        self.reports: List[Dict] = []
        self._reported: Dict[str, int] = {}  # peer -> fork index reported
        self._m_total = registry.counter(
            "babble_divergence_total",
            "Committed-block chain-hash mismatches observed against any "
            "peer", node=node_label)
        self._registry = registry
        self._node_label = node_label
        self._peer_counters: Dict[str, object] = {}

    # -- outbound ------------------------------------------------------

    def claim(self, last_consensus_round=None) -> Dict:
        return self.chain.claim(last_consensus_round=last_consensus_round)

    # -- inbound -------------------------------------------------------

    def observe(self, peer_addr: str, claim: Optional[Dict]) -> None:
        """Check one piggybacked peer claim against our own chain.
        Mismatch at a common index means the two block streams diverged
        somewhere at or before it; the short-hash window narrows the
        fork point to an exact index when it is recent enough (always,
        when detection happens within one gossip round).

        Claims arrive from UNTRUSTED peers: anything malformed is
        dropped here rather than thrown into the gossip path."""
        if not isinstance(claim, dict):
            return
        try:
            self._observe(peer_addr, claim)
        except (KeyError, TypeError, ValueError):
            return  # malformed claim: ignore, never break gossip

    def _observe(self, peer_addr: str, claim: Dict) -> None:
        now = time.monotonic()
        with self._lock:
            ent = self._peers.setdefault(
                peer_addr, {"last_agreed": -1, "index": -1, "round": -1,
                            "c_round": -1, "at": now})
            ent["at"] = now
            ent["c_round"] = claim.get("CRound", -1)
        if "Index" not in claim:
            return  # peer has not committed a block yet
        with self._lock:
            ent["index"] = claim["Index"]
            ent["round"] = claim.get("Round", -1)
        chain = self.chain
        if claim.get("Base", -1) != chain.base_round or chain.index < 0:
            return  # different segment (fast-forwarded peer): no basis
        window = {i: h for i, h in claim.get("Window", [])}
        # Compare at the highest common index: our full-hash history
        # when the peer's tip is at or behind ours, the peer's window
        # short-hash when it is ahead.
        mismatch = False
        common = min(claim["Index"], chain.index)
        ours = chain.lookup(common)
        if ours is None:
            return  # aged out of our history window
        if common == claim["Index"]:
            mismatch = ours[2] != claim["Hash"]
        elif common in window:
            mismatch = ours[2][:SHORT_HEX] != window[common]
        else:
            return
        if not mismatch:
            with self._lock:
                if common > ent["last_agreed"]:
                    ent["last_agreed"] = common
            return
        # Diverged. Locate the fork: the smallest window index where
        # the short hashes differ, with the entry below it agreeing.
        fork_at = common
        last_agreed = ent["last_agreed"]
        for i in sorted(window):
            mine = chain.lookup(i)
            if mine is None or i > common:
                continue
            if mine[2][:SHORT_HEX] != window[i]:
                fork_at = i
                break
            last_agreed = max(last_agreed, i)
        self._record(peer_addr, fork_at, last_agreed, common,
                     claim, ours)

    def _record(self, peer_addr: str, fork_at: int, last_agreed: int,
                common: int, claim: Dict, ours: tuple) -> None:
        self._m_total.inc()
        with self._lock:
            c = self._peer_counters.get(peer_addr)
            if c is None:
                c = self._registry.counter(
                    "babble_divergence_total",
                    "Committed-block chain-hash mismatches observed "
                    "against any peer",
                    node=self._node_label, peer=peer_addr)
                self._peer_counters[peer_addr] = c
            already = self._reported.get(peer_addr)
            fresh = already is None or fork_at < already
            if fresh:
                self._reported[peer_addr] = fork_at
        c.inc()
        if not fresh:
            return
        fork_link = self.chain.lookup(fork_at)
        report = {
            "peer": peer_addr,
            "fork_index": fork_at,
            "fork_round": fork_link[1] if fork_link else None,
            "last_agreed_index": last_agreed,
            "compared_index": common,
            "our_hash": ours[2],
            "peer_hash": claim.get("Hash", ""),
            "peer_tip_index": claim.get("Index", -1),
            "detected_unix": time.time(),
        }
        with self._lock:
            self.reports.append(report)
            del self.reports[:-self.MAX_REPORTS]
        self._logger.error(
            "CONSENSUS DIVERGENCE vs %s: block streams fork at index %d "
            "(round %s, last agreed %d) — our %s.. vs peer %s..",
            peer_addr, fork_at, report["fork_round"], last_agreed,
            ours[2][:12], report["peer_hash"][:12],
            extra={"peer": peer_addr})

    # -- views ---------------------------------------------------------

    def divergence_count(self) -> int:
        return int(self._m_total.value)

    def peer_progress(self) -> Dict[str, Dict]:
        """Per-peer snapshot for /debug/peers and the round-lag gauge:
        last piggybacked consensus round + chain tip + agreement."""
        now = time.monotonic()
        with self._lock:
            return {
                addr: {
                    "last_known_round": ent["c_round"],
                    "chain_index": ent["index"],
                    "last_agreed_index": ent["last_agreed"],
                    "age_s": round(now - ent["at"], 3),
                }
                for addr, ent in self._peers.items()
            }

    def best_peer_round(self) -> int:
        with self._lock:
            rounds = [ent["c_round"] for ent in self._peers.values()]
        return max(rounds) if rounds else -1

    def describe(self) -> Dict:
        return {
            "chain": self.chain.state(),
            "divergences": self.divergence_count(),
            "reports": list(self.reports),
            "peers": self.peer_progress(),
        }

    def rebase(self) -> None:
        """Fast-forward reset: fresh chain segment, stale agreement
        bookkeeping dropped (indexes are per-segment)."""
        self.chain.rebase()
        with self._lock:
            for ent in self._peers.values():
                ent["last_agreed"] = -1


class StallWatchdog:
    """Round-progress watchdog. `poll()` is driven by the node's
    watchdog loop every `timeout / 4` seconds; everything it reads
    (last consensus round, known map, round rows) is lock-free
    snapshot reading, same as the scrape path."""

    def __init__(self, node, timeout: float):
        self.node = node
        self.timeout = timeout
        self.diagnosis: Optional[Dict] = None
        self._progress_round = -1
        self._progress_at = time.monotonic()
        # creator pid -> (last seen index, last advance monotonic)
        self._creator_seen: Dict[int, tuple] = {}
        self._episodes = 0

    def poll(self) -> None:
        core = self.node.core
        now = time.monotonic()
        lcr = core.get_last_consensus_round_index()
        lcr = -1 if lcr is None else lcr
        if lcr > self._progress_round:
            self._progress_round = lcr
            self._progress_at = now
            if self.diagnosis is not None:
                self.diagnosis = None
                self.node.logger.warning(
                    "consensus stall cleared: round %d decided", lcr)
        # Track per-creator visibility so a stall can name the silent
        # creators (the ones whose events stopped arriving — partition,
        # crash, or an equivocator every peer rejects).
        try:
            known = core.known()
        except Exception:  # noqa: BLE001 - mid-reset store
            return
        for pid, idx in known.items():
            prev = self._creator_seen.get(pid)
            if prev is None or idx > prev[0]:
                self._creator_seen[pid] = (idx, now)
        stalled_for = now - self._progress_at
        if stalled_for < self.timeout:
            return
        # Only a node with payload events pending is stalled; a
        # quiescent idle network legitimately decides nothing.
        hg = core.hg
        if hg.pending_loaded_events <= 0 and not core.transaction_pool:
            self._progress_at = now  # idle: restart the clock
            return
        fresh = self.diagnosis is None
        self.diagnosis = self._diagnose(core, lcr, stalled_for, now)
        if fresh:
            self._episodes += 1
            d = self.diagnosis
            self.node.logger.warning(
                "consensus STALLED for %.1fs at round %d: undecided "
                "rounds %s, silent creators %s",
                stalled_for, lcr,
                [r["round"] for r in d["undecided_rounds"]],
                [c["creator"] for c in d["silent_creators"]])

    def _diagnose(self, core, lcr: int, stalled_for: float,
                  now: float) -> Dict:
        hg = core.hg
        rounds = []
        for r in sorted(set(hg.undecided_rounds))[:8]:
            try:
                ri = hg.store.get_round(r)
            except Exception:  # noqa: BLE001 - row may not exist yet
                continue
            undecided = [x for x in ri.witnesses()
                         if not ri.is_decided(x)]
            rounds.append({
                "round": r,
                "witnesses": len(ri.witnesses()),
                "undecided_witnesses": len(undecided),
                "undecided": [x[:18] for x in undecided[:8]],
            })
        silent = []
        rev = core.reverse_participants
        for pid, (idx, seen_at) in sorted(self._creator_seen.items()):
            if now - seen_at >= self.timeout:
                silent.append({
                    "creator_id": pid,
                    "creator": rev.get(pid, "")[:18],
                    "last_index": idx,
                    "silent_for_s": round(now - seen_at, 1),
                })
        return {
            "stalled": True,
            "since_s": round(stalled_for, 1),
            "last_consensus_round": lcr,
            "undecided_rounds": rounds,
            "undecided_witnesses": core.undecided_witness_count(),
            "silent_creators": silent,
            "pending_loaded_events": hg.pending_loaded_events,
            "transaction_pool": len(core.transaction_pool),
            "episodes": self._episodes + (1 if self.diagnosis is None
                                          else 0),
        }

    def describe(self) -> Dict:
        d = self.diagnosis
        if d is None:
            return {"stalled": False,
                    "last_consensus_round": self._progress_round,
                    "since_progress_s": round(
                        time.monotonic() - self._progress_at, 1),
                    "episodes": self._episodes}
        return d
