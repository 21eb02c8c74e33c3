"""Shared-epoch cluster clock (docs/observability.md "One timeline
across the cluster").

Every SpanRing records `time.perf_counter_ns()` timestamps: monotonic
and cheap, but each process gets its own arbitrary zero, so traces
from different nodes cannot be laid on one timeline as-is. The
ClusterClock closes that gap in two steps:

1. **Wall rebase.** At construction the clock samples the mapping
   `wall_offset = time_ns() - perf_counter_ns()` (best of a few
   tries — the smallest interval between the two reads is the least
   preempted sample). `to_epoch(perf_ns)` then lands every span on
   this machine's Unix-epoch wall clock without giving up perf_counter
   monotonicity inside a span.

2. **Peer offset handshake.** Machine wall clocks themselves drift
   (and un-NTP'd lab boxes disagree by seconds), so every gossip pull
   carries the four NTP timestamps: the requester stamps t0 at send,
   the responder reports its receive stamp t1 (taken when the RPC
   object was constructed — before any queue wait inflates it) and
   reply stamp t2, the requester stamps t3 at response. Standard NTP
   estimates per sample

       offset = ((t1 - t0) + (t2 - t3)) / 2     (peer − us)
       rtt    = (t3 - t0) − (t2 - t1)

   and the error of `offset` is bounded by the path ASYMMETRY, which
   shrinks with rtt — so the clock keeps a bounded window of samples
   per peer and trusts the offset of the minimum-rtt sample (the
   classic clock-filter shortcut). Exposed per peer as the
   `babble_clock_offset_ns` gauge.

The **cluster epoch** is then defined as the average of all
participants' rebased clocks: each node adjusts its own timeline by
`mean(filtered peer offsets ∪ {0})`. Pairwise, two nodes' adjustments
differ by exactly their measured offset (when the offset graph is
consistent), so N independently-adjusted dumps merge into one aligned
timeline — no coordinator, no extra RPCs, just arithmetic over state
each node already has. `tracemerge` consumes this via the clock block
each `/debug/trace` dump embeds.

`skew_ns` shifts this node's *local* epoch — a test hook that lets an
in-process multi-node harness simulate machines whose wall clocks
disagree by a known amount and assert the handshake recovers it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = ["ClusterClock", "wall_offset_ns"]

_SAMPLE_TRIES = 5


def wall_offset_ns() -> int:
    """Best-effort `time_ns() − perf_counter_ns()` mapping: the sample
    with the tightest bracketing interval is the least preempted."""
    best = None
    best_width = None
    for _ in range(_SAMPLE_TRIES):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        width = b - a
        if best_width is None or width < best_width:
            best_width = width
            best = w - (a + width // 2)
    return int(best)


class ClusterClock:
    """Per-node clock state: wall rebase + per-peer NTP offsets.

    Thread-safe: `observe` is called from gossip threads, the gauges
    and `/debug/trace` read from the HTTP service thread.
    """

    def __init__(self, skew_ns: int = 0, window: int = 16,
                 max_age_s: float = 300.0):
        self._wall0 = wall_offset_ns()
        self._skew = int(skew_ns)
        self._window = max(1, window)
        self._max_age_ns = int(max_age_s * 1e9)
        # peer -> deque[(rtt_ns, offset_ns, mono_ns)]
        self._samples: Dict[str, deque] = {}
        self._lock = threading.Lock()

    # -- local epoch ----------------------------------------------------

    def to_epoch(self, perf_ns: int) -> int:
        """Rebase a perf_counter_ns stamp onto this node's wall epoch
        (Unix ns). Applies the injected test skew, making the skew
        visible to peers through the handshake like a real clock
        error would be."""
        return perf_ns + self._wall0 + self._skew

    def epoch_ns(self) -> int:
        return self.to_epoch(time.perf_counter_ns())

    # -- handshake ------------------------------------------------------

    def observe(self, peer: str, t0: int, t1: int, t2: int, t3: int) -> None:
        """Fold one NTP four-tuple for `peer` (all epoch-domain ns:
        t0/t3 ours, t1/t2 the peer's). Nonsense samples (negative rtt
        from a re-used stamp) are dropped."""
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0:
            return
        offset = ((t1 - t0) + (t2 - t3)) // 2
        now = time.monotonic_ns()
        with self._lock:
            dq = self._samples.get(peer)
            if dq is None:
                dq = self._samples[peer] = deque(maxlen=self._window)
            dq.append((rtt, offset, now))

    def offset_ns(self, peer: str) -> Optional[int]:
        """Filtered offset estimate for one peer (peer − us), or None
        before the first sample: the offset of the minimum-rtt sample
        in the window (NTP clock-filter shortcut — asymmetry error is
        bounded by rtt)."""
        with self._lock:
            dq = self._samples.get(peer)
            if not dq:
                return None
            now = time.monotonic_ns()
            fresh = [s for s in dq if now - s[2] <= self._max_age_ns]
            if not fresh:
                return None
            return min(fresh)[1]

    def offsets(self) -> Dict[str, int]:
        with self._lock:
            peers = list(self._samples)
        out = {}
        for p in peers:
            off = self.offset_ns(p)
            if off is not None:
                out[p] = off
        return out

    def rtt_ns(self, peer: str) -> Optional[int]:
        with self._lock:
            dq = self._samples.get(peer)
            if not dq:
                return None
            return min(dq)[0]

    # -- cluster epoch --------------------------------------------------

    def cluster_adjust_ns(self) -> int:
        """This node's adjustment onto the cluster-average epoch:
        mean of the filtered peer offsets, with self counted at 0.
        Two nodes' adjustments differ by their pairwise offset, so
        independently-adjusted dumps align."""
        offs = list(self.offsets().values())
        if not offs:
            return 0
        return int(sum(offs) / (len(offs) + 1))

    def cluster_epoch_ns(self, perf_ns: int) -> int:
        return self.to_epoch(perf_ns) + self.cluster_adjust_ns()

    def describe(self) -> dict:
        """The clock block `/debug/trace` embeds (tracemerge consumes
        it to rebase raw monotonic dumps)."""
        return {
            "wall_offset_ns": self._wall0 + self._skew,
            "cluster_adjust_ns": self.cluster_adjust_ns(),
            "peer_offsets_ns": self.offsets(),
        }
