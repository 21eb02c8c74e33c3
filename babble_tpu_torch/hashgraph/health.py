"""Consensus-health primitives: the committed-block hash chain and the
fork-evidence record (docs/observability.md "Consensus health").

The whole point of virtual voting is that every honest node emits a
byte-identical block stream — PAPER.md's "same transactions, same
order, on every node". Until now that invariant was only ever audited
after the fact by test harnesses (check_gossip, the kill -9 harness);
`BlockHashChain` turns it into something a live node can assert every
gossip round: a rolling chained hash over the delivered block stream,

    H_i = sha256(H_{i-1} || block_i_bytes)

so one 32-byte comparison at a common index covers the entire history
up to it. The chain keeps a bounded history window of recent links so
a mismatch can be *located* (the fork index), not just detected — see
node/health.py for the peer-comparison protocol.

Segments and rebasing: a node that fast-syncs (Frame reset) skips part
of the block stream, so its chain can no longer be compared against a
full-history peer. Rather than alarm on that, each chain segment is
identified by the round of its FIRST hashed block (`base_round`);
claims are only compared between equal bases. Nodes that grew from
genesis share a base naturally (the first committed block is the same
everywhere); a fast-forwarded node starts a fresh segment and simply
drops out of the sentinel mesh until its peers rebase too. A durable
store persists the chain state next to the delivered-block anchor
(FileStore meta), so a restarted node resumes its segment instead of
resetting it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from .. import crypto
from .block import Block

# Truncated-hash length (hex chars) used in the piggybacked window:
# 64 bits is plenty to LOCATE a fork (the full tip hash is what
# *detects* it) while keeping the per-gossip-round sidecar small.
SHORT_HEX = 16


class BlockHashChain:
    """Rolling chained hash over the blocks this node delivered to its
    application, with a bounded (index -> link) history window.

    Thread-safety: the owner (Node._commit) advances from one thread at
    a time, but claims/lookups are read from gossip and scrape threads,
    so every mutation and snapshot takes the small internal lock."""

    GENESIS = b"\x00" * 32

    def __init__(self, history: int = 512):
        self._lock = threading.Lock()
        self._history: "deque" = deque(maxlen=max(16, history))
        self.hash = self.GENESIS
        self.index = -1  # position in this segment's block stream
        self.round = -1  # round_received of the latest hashed block
        self.base_round = -1  # round of the segment's first block
        # Test hook (the "deliberately corrupted block stream" of the
        # acceptance harness): when armed, the next block is hashed
        # with perturbed bytes — every later link inherits the damage,
        # exactly like a diverged consensus order would.
        self._corrupt_next = False

    def advance(self, block: Block) -> None:
        data = block.marshal()
        with self._lock:
            if self._corrupt_next:
                self._corrupt_next = False
                data = data + b"\x00corrupted"
            self.hash = crypto.sha256(self.hash + data)
            self.index += 1
            self.round = block.round_received
            if self.base_round < 0:
                self.base_round = block.round_received
            self._history.append(
                (self.index, self.round, self.hash.hex()))

    def corrupt_next(self) -> int:
        """Arm the corruption hook; returns the chain index the next
        advance will write (= the fork index a peer should name),
        atomically with respect to concurrent advances."""
        with self._lock:
            self._corrupt_next = True
            return self.index + 1

    def rebase(self) -> None:
        """Start a fresh chain segment (after a fast-forward reset):
        the skipped history can never be re-hashed, so comparisons
        against full-history peers would be meaningless."""
        with self._lock:
            self.hash = self.GENESIS
            self.index = -1
            self.round = -1
            self.base_round = -1
            self._history.clear()

    def lookup(self, index: int) -> Optional[tuple]:
        """(index, round, hash_hex) at `index`, or None when outside
        the history window."""
        with self._lock:
            if not self._history:
                return None
            first = self._history[0][0]
            pos = index - first
            if 0 <= pos < len(self._history):
                return self._history[pos]
            return None

    def claim(self, window: int = 8, last_consensus_round=None) -> Dict:
        """The sidecar dict piggybacked on gossip sync RPCs: segment
        base, tip (index, round, full hash), a short-hash window of the
        last few links (to locate a fork within one gossip round), and
        the node's last consensus round for peer progress tracking.
        Wire-stable JSON-friendly keys; absent entirely when the
        sentinel is disabled, so the legacy wire form is unchanged."""
        with self._lock:
            c: Dict = {"CRound": (-1 if last_consensus_round is None
                                  else int(last_consensus_round))}
            if self.index < 0:
                return c
            c.update({
                "Base": self.base_round,
                "Index": self.index,
                "Round": self.round,
                "Hash": self.hash.hex(),
                "Window": [[i, h[:SHORT_HEX]]
                           for i, _r, h in list(self._history)[-window:]],
            })
            return c

    # -- durable round trip (FileStore meta) ----------------------------

    def state(self) -> Dict:
        with self._lock:
            return {
                "index": self.index,
                "round": self.round,
                "base_round": self.base_round,
                "hash": self.hash.hex(),
            }

    def restore(self, state: Optional[Dict]) -> None:
        """Resume a persisted segment (restart of a durable node). The
        history window is not persisted — fork *location* against this
        node resumes with its next committed block; detection (tip
        compare) works immediately."""
        if not state:
            return
        with self._lock:
            self.index = int(state["index"])
            self.round = int(state["round"])
            self.base_round = int(state["base_round"])
            self.hash = bytes.fromhex(state["hash"])
            self._history.clear()
            if self.index >= 0:
                self._history.append(
                    (self.index, self.round, self.hash.hex()))


def fork_evidence_record(existing_hex: str, event) -> Dict:
    """The persisted proof of equivocation: two signed events by one
    creator at the same index. `event` is the newly observed (rejected)
    copy; its full Go-JSON encoding rides along so the signature can be
    re-verified by anyone auditing the store."""
    import time

    return {
        "creator": event.creator(),
        "index": event.index(),
        "existing": existing_hex,
        "forged": event.hex(),
        "event_json": event.marshal().decode("utf-8").rstrip("\n"),
        "observed_unix": time.time(),
    }


def fork_evidence_key(record: Dict) -> tuple:
    return (record["creator"], record["index"], record["forged"])
