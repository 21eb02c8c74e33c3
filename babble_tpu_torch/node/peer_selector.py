"""Gossip partner selection — reference node/peer_selector.go:9-46.

The pluggable seam for alternative topologies (the batched simulation's
schedule tensor plays this role on device).

Two implementations:

- RandomPeerSelector: the reference's uniform random choice, excluding
  self and the last-gossiped peer. No failure awareness — a dead peer
  keeps being re-selected and each pick burns a full transport timeout.
- HealthTrackingPeerSelector: the production selector. Wraps the same
  random choice with a per-peer circuit breaker fed by sync outcomes
  from Node._gossip: K consecutive failures trip the breaker, the peer
  is suspended for a jittered exponential backoff, then probed once
  (half-open) before full reinstatement. With one dead peer in the net
  gossip throughput stays near the all-healthy baseline instead of
  stalling a gossip slot on every unlucky pick.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Protocol

from ..net.peer import Peer, exclude_peer

# Breaker states (per peer).
CLOSED = "closed"        # healthy: normal selection
OPEN = "open"            # suspended: excluded until retry_at
HALF_OPEN = "half_open"  # probe dispatched; next outcome decides


class PeerSelector(Protocol):
    def peers(self) -> List[Peer]: ...

    def update_last(self, peer_addr: str) -> None: ...

    def next(self) -> Peer: ...


class RandomPeerSelector:
    """Uniform random over peers, excluding self and the last-gossiped
    peer when there is a choice."""

    def __init__(self, participants: List[Peer], local_addr: str):
        _, self._peers = exclude_peer(participants, local_addr)
        self._last = ""

    def peers(self) -> List[Peer]:
        return self._peers

    def update_last(self, peer_addr: str) -> None:
        self._last = peer_addr

    def next(self) -> Peer | None:
        selectable = self._peers
        if not selectable:
            return None  # single-node net: nobody to gossip with
        if len(selectable) > 1:
            _, selectable = exclude_peer(selectable, self._last)
        return random.choice(selectable)


@dataclass
class PeerHealth:
    """Per-peer breaker record (internal to the selector)."""

    state: str = CLOSED
    consecutive_failures: int = 0
    failures: int = 0
    successes: int = 0
    trips: int = 0           # how many times the breaker opened
    backoff: float = 0.0     # current suspension length (pre-jitter)
    retry_at: float = 0.0    # monotonic deadline for the next probe


class HealthTrackingPeerSelector:
    """Random selection gated by a per-peer circuit breaker.

    State machine per peer:

      CLOSED --K consecutive failures--> OPEN (backoff doubles per
      trip, jittered, capped) --deadline passes--> HALF_OPEN (one
      probe) --success--> CLOSED / --failure--> OPEN again.

    A half-open probe that never reports back (gossip thread died
    before reaching the peer) re-arms after a probe window, so a lost
    outcome cannot wedge a peer in HALF_OPEN forever.

    Not thread-safe by itself: the node serializes access through its
    selector lock, like it does for RandomPeerSelector.
    """

    def __init__(
        self,
        participants: List[Peer],
        local_addr: str,
        *,
        threshold: int = 3,
        base_backoff: float = 0.5,
        max_backoff: float = 30.0,
        jitter: float = 0.2,
        rng: Optional[random.Random] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        _, self._peers = exclude_peer(participants, local_addr)
        self._last = ""
        self._threshold = max(1, threshold)
        self._base = base_backoff
        self._max = max_backoff
        self._jitter = jitter
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        self._health: Dict[str, PeerHealth] = {
            p.net_addr: PeerHealth() for p in self._peers
        }

    # -- PeerSelector surface ---------------------------------------------

    def peers(self) -> List[Peer]:
        return self._peers

    def update_last(self, peer_addr: str) -> None:
        self._last = peer_addr

    def next(self) -> Peer | None:
        if not self._peers:
            return None
        now = self._clock()
        healthy: List[Peer] = []
        for p in self._peers:
            h = self._health[p.net_addr]
            if h.state == CLOSED:
                healthy.append(p)
            elif now >= h.retry_at:
                # OPEN past its deadline (or a HALF_OPEN probe whose
                # outcome was lost past the probe window): dispatch ONE
                # probe now. Probes take priority over healthy picks —
                # at most one per expired peer per window, so they
                # cannot starve normal gossip.
                h.state = HALF_OPEN
                h.retry_at = now + max(self._base, h.backoff)
                return p
        if not healthy:
            return None  # everything suspended: skip this tick
        if len(healthy) > 1:
            _, choice = exclude_peer(healthy, self._last)
        else:
            choice = healthy
        return self._rng.choice(choice)

    # -- outcome feedback (Node._gossip / Node._fast_forward) -------------

    def record_success(self, peer_addr: str) -> bool:
        """Returns True when this outcome reinstated a suspended peer."""
        h = self._health.get(peer_addr)
        if h is None:
            return False
        reinstated = h.state != CLOSED
        h.state = CLOSED
        h.consecutive_failures = 0
        h.backoff = 0.0
        h.successes += 1
        return reinstated

    def record_failure(self, peer_addr: str) -> bool:
        """Returns True when this outcome tripped (or re-tripped) the
        breaker."""
        h = self._health.get(peer_addr)
        if h is None:
            return False
        h.failures += 1
        h.consecutive_failures += 1
        failed_probe = h.state == HALF_OPEN
        if not failed_probe and h.consecutive_failures < self._threshold:
            return False
        # Trip: exponential backoff with jitter. A failed probe doubles
        # the previous suspension instead of restarting the ladder.
        h.backoff = min(self._max, (h.backoff * 2.0) or self._base)
        spread = 1.0 + self._jitter * self._rng.uniform(-1.0, 1.0)
        h.retry_at = self._clock() + h.backoff * spread
        h.state = OPEN
        h.trips += 1
        return True

    # -- observability (/debug/peers) -------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        now = self._clock()
        out: Dict[str, dict] = {}
        for addr, h in self._health.items():
            out[addr] = {
                "state": h.state,
                "consecutive_failures": h.consecutive_failures,
                "failures": h.failures,
                "successes": h.successes,
                "trips": h.trips,
                "backoff": round(h.backoff, 4),
                "retry_in": round(max(0.0, h.retry_at - now), 4)
                if h.state != CLOSED else 0.0,
            }
        return out
