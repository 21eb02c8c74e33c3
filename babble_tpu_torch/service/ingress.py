"""Ingress armor (docs/ingress.md): the admission plane between the
HTTP service and the node's transaction pipeline.

Three cooperating pieces, all owned by one `Ingress` object the node
constructs when `Config.admission` is on:

- **Per-client quotas** — a token bucket per client id (the
  `X-Babble-Client` header, falling back to the remote address), in a
  bounded table with least-recently-seen eviction. A rejected tx is a
  *quota* rejection (the client exceeded its contract), distinct from
  a *shed* (the node is protecting itself).

- **Adaptive load shedding** — a CoDel-style controller over the
  pipeline's measured sojourn time (the oldest entry's age across the
  intake / `work` / `commit_ch` queues, read straight from the PR 15
  instruments). Delay above the target for a full interval starts
  shedding; each subsequent shed comes at `interval / sqrt(count)` —
  the classic square-root ramp — until the delay sinks back under
  target. A hard guard sheds immediately when `work` or `commit_ch`
  sit at >= 90% capacity ("downstream") or the intake queue itself
  overflows ("intake_full"): the whole point is to refuse work at the
  front door *before* the commit path starts dropping.

- **Commit subscriptions** — "tell me when my tx lands": a bounded
  waiter registry keyed by sha256(tx) plus a bounded
  recently-committed ring, resolved from `Node._commit` (and, after a
  restart, from the store's block history), serving both long-poll
  and SSE forms of `GET /subscribe`.

Everything here is accounted: `babble_ingress_admitted_total`,
`babble_ingress_shed_total{reason}`,
`babble_ingress_quota_rejected_total`, and the intake queue's
depth/capacity/wait/drops under the standard `babble_queue_*`
families (queue="intake")."""

from __future__ import annotations

import hashlib
import math
import struct
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..telemetry.queues import InstrumentedQueue, QueueInstrument

# Binary batch-submit frame, following the columnar framing
# conventions (net/columnar.py BBC1/BBD1): magic, little-endian u32
# count, u32 length per tx, then the concatenated raw tx blobs.
TX_BATCH_MAGIC = b"BBB1"

# Shed reasons (the {reason} label on babble_ingress_shed_total).
SHED_OVERLOAD = "overload"        # CoDel: sojourn above target
SHED_DOWNSTREAM = "downstream"    # work/commit_ch near capacity
SHED_INTAKE_FULL = "intake_full"  # intake queue overflow
SHED_SUBSCRIBERS = "subscribers"  # subscriber registry at capacity
SHED_REASONS = (SHED_OVERLOAD, SHED_DOWNSTREAM, SHED_INTAKE_FULL,
                SHED_SUBSCRIBERS)


def tx_digest(tx: bytes) -> str:
    """The subscription key for a transaction: sha256 over the raw
    bytes, hex — what /submit* returns and /subscribe accepts."""
    return hashlib.sha256(tx).hexdigest()


def encode_tx_batch(txs: List[bytes]) -> bytes:
    """Length-prefixed binary batch frame for POST /submit/batch."""
    head = TX_BATCH_MAGIC + struct.pack("<I", len(txs))
    lens = struct.pack(f"<{len(txs)}I", *[len(t) for t in txs])
    return head + lens + b"".join(txs)


def decode_tx_batch(data: bytes, max_tx_bytes: int,
                    max_txs: int = 65536) -> List[bytes]:
    """Decode a TX_BATCH_MAGIC frame; raises ValueError on any
    malformed, oversized, or truncated input (the caller answers
    400/413 — never an exception page)."""
    if len(data) < 8 or data[:4] != TX_BATCH_MAGIC:
        raise ValueError("bad batch magic")
    (count,) = struct.unpack_from("<I", data, 4)
    if count == 0:
        raise ValueError("empty batch")
    if count > max_txs:
        raise ValueError(f"batch of {count} txs exceeds {max_txs}")
    off = 8
    if len(data) < off + 4 * count:
        raise ValueError("truncated batch length table")
    lens = struct.unpack_from(f"<{count}I", data, off)
    off += 4 * count
    txs: List[bytes] = []
    for ln in lens:
        if ln == 0:
            raise ValueError("empty transaction in batch")
        if ln > max_tx_bytes:
            raise ValueError(
                f"transaction of {ln} bytes exceeds {max_tx_bytes}")
        if off + ln > len(data):
            raise ValueError("truncated batch payload")
        txs.append(data[off:off + ln])
        off += ln
    if off != len(data):
        raise ValueError("trailing bytes after batch payload")
    return txs


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill, `burst` cap.
    Not self-locking — the owning table serializes access."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = now

    def grant(self, n: int, now: float) -> int:
        """Take up to n tokens; returns how many were granted."""
        if now > self.last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
            self.last = now
        take = min(n, int(self.tokens))
        self.tokens -= take
        return take

    def retry_after(self) -> float:
        """Seconds until one whole token is available."""
        missing = 1.0 - self.tokens
        if missing <= 0.0 or self.rate <= 0.0:
            return 0.0
        return missing / self.rate


class ClientQuotas:
    """Bounded table of per-client token buckets (least-recently-seen
    eviction keeps a client-id churn attack from growing the table)."""

    def __init__(self, rate: float, burst: float = 0.0,
                 max_clients: int = 4096):
        self.rate = float(rate)
        # burst 0 = auto: a couple of seconds of rate, floor 64, so
        # bursty-but-in-contract clients aren't rejected on arrival
        # phase alone.
        self.burst = float(burst) if burst > 0 else max(2.0 * rate, 64.0)
        self.max_clients = max_clients
        self._lock = threading.Lock()
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._rejected: Dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.rate > 0.0

    def grant(self, client: str, n: int,
              now: float) -> Tuple[int, float]:
        """Grant up to n submission tokens to `client`; returns
        (granted, retry_after_seconds_for_the_rest)."""
        if not self.enabled:
            return n, 0.0
        with self._lock:
            bucket = self._buckets.get(client)
            if bucket is None:
                while len(self._buckets) >= self.max_clients:
                    self._buckets.popitem(last=False)
                bucket = TokenBucket(self.rate, self.burst, now)
                self._buckets[client] = bucket
            else:
                self._buckets.move_to_end(client)
            granted = bucket.grant(n, now)
            if granted < n:
                self._rejected[client] = (
                    self._rejected.get(client, 0) + (n - granted))
            return granted, bucket.retry_after()

    def table(self, top: int = 16) -> List[Dict[str, object]]:
        """Most-recently-seen clients for /debug/ingress."""
        with self._lock:
            rows = [
                {"client": c, "tokens": round(b.tokens, 1),
                 "rejected": self._rejected.get(c, 0)}
                for c, b in list(self._buckets.items())[-top:]
            ]
        rows.reverse()
        return rows


class AdmissionController:
    """CoDel-style target-delay shedding (docs/ingress.md).

    The signal is the pipeline sojourn time the caller measures (the
    oldest queued item's age) — not queue depth, so capacity changes
    and burst absorption need no retuning. Standing delay above
    `target` for one full `interval` enters the shedding state; while
    shedding, rejections come at interval/sqrt(count) spacing (the
    CoDel ramp), and the first sample back under target exits."""

    def __init__(self, target: float = 0.2, interval: float = 0.5):
        self.target = float(target)
        self.interval = float(interval)
        self._lock = threading.Lock()
        self._first_above = 0.0   # when delay first exceeded target
        self._shedding = False
        self._shed_count = 0      # sheds in the current episode
        self._next_shed = 0.0
        self.episodes = 0         # completed shedding episodes

    def admit(self, delay: float, now: float) -> bool:
        with self._lock:
            if delay < self.target:
                if self._shedding:
                    self.episodes += 1
                self._shedding = False
                self._first_above = 0.0
                return True
            if not self._shedding:
                if self._first_above == 0.0:
                    # First sample above target: arm the interval.
                    self._first_above = now + self.interval
                    return True
                if now < self._first_above:
                    return True
                # Above target for a full interval: start shedding.
                self._shedding = True
                self._shed_count = 1
                self._next_shed = now + self.interval
                return False
            if now >= self._next_shed:
                self._shed_count += 1
                self._next_shed = now + (
                    self.interval / math.sqrt(self._shed_count))
                return False
            return True

    def state(self) -> Dict[str, object]:
        with self._lock:
            return {
                "target_ms": round(self.target * 1000.0, 1),
                "interval_ms": round(self.interval * 1000.0, 1),
                "shedding": self._shedding,
                "episode_sheds": self._shed_count if self._shedding else 0,
                "episodes": self.episodes,
            }


class _Waiter:
    __slots__ = ("event", "result")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[Dict[str, object]] = None


class CommitSubscriptions:
    """Bounded digest -> commit-notification registry.

    `resolve` (called from the commit path) records the commit in a
    bounded recently-committed ring and wakes any registered waiters;
    `register`/`wait` is the long-poll/SSE side. The waiter cap bounds
    how many handler threads can park here — beyond it the subscribe
    endpoint sheds (reason "subscribers") instead of accumulating
    blocked threads."""

    def __init__(self, max_waiters: int = 256, recent_cap: int = 4096):
        self.max_waiters = max_waiters
        self.recent_cap = recent_cap
        self._lock = threading.Lock()
        self._waiters: Dict[str, List[_Waiter]] = {}
        self._count = 0
        self._recent: "OrderedDict[str, Dict[str, object]]" = OrderedDict()

    def resolve(self, digest: str, info: Dict[str, object]) -> None:
        with self._lock:
            if digest not in self._recent:
                while len(self._recent) >= self.recent_cap:
                    self._recent.popitem(last=False)
                self._recent[digest] = info
            waiters = self._waiters.pop(digest, None)
            if waiters:
                self._count -= len(waiters)
        for w in waiters or ():
            w.result = info
            w.event.set()

    def lookup(self, digest: str) -> Optional[Dict[str, object]]:
        with self._lock:
            return self._recent.get(digest)

    def register(self, digest: str) -> Optional[_Waiter]:
        """Returns a waiter already resolved (result set), a parked
        waiter to wait on, or None when the registry is full."""
        with self._lock:
            info = self._recent.get(digest)
            if info is not None:
                w = _Waiter()
                w.result = info
                w.event.set()
                return w
            if self._count >= self.max_waiters:
                return None
            w = _Waiter()
            self._waiters.setdefault(digest, []).append(w)
            self._count += 1
            return w

    def unregister(self, digest: str, waiter: _Waiter) -> None:
        with self._lock:
            lst = self._waiters.get(digest)
            if lst and waiter in lst:
                lst.remove(waiter)
                self._count -= 1
                if not lst:
                    del self._waiters[digest]

    def waiter_count(self) -> int:
        with self._lock:
            return self._count


class Ingress:
    """The node's admission plane: quota -> controller -> intake queue,
    plus the commit-subscription registry. Constructed by Node when
    `Config.admission` is on; `--no_admission` leaves it None and the
    service falls back to the bare pre-ingress intake path."""

    # Max txs the intake forwarder coalesces into one work item (one
    # core_lock acquisition, one journal fsync window downstream).
    FORWARD_BATCH = 256

    def __init__(self, node, conf):
        self.node = node
        reg = node.registry
        nl = node._node_label
        cap = int(getattr(conf, "intake_queue", 8192))
        self.intake: InstrumentedQueue = InstrumentedQueue(
            cap, QueueInstrument(reg, "intake", cap, node=nl))
        self.controller = AdmissionController(
            target=float(getattr(conf, "ingress_target_delay", 0.2)),
            interval=float(getattr(conf, "ingress_interval", 0.5)))
        self.quotas = ClientQuotas(
            rate=float(getattr(conf, "quota_rate", 0.0)),
            burst=float(getattr(conf, "quota_burst", 0.0)))
        self.subscriptions = CommitSubscriptions(
            max_waiters=int(getattr(conf, "subscribe_cap", 256)))
        self._m_admitted = reg.counter(
            "babble_ingress_admitted_total",
            "Transactions admitted into the intake queue", node=nl)
        self._m_quota = reg.counter(
            "babble_ingress_quota_rejected_total",
            "Transactions rejected by per-client token-bucket quotas",
            node=nl)
        # Eager children per reason so every family (and the headline
        # reasons) scrape at zero from boot.
        self._m_shed = {
            reason: reg.counter(
                "babble_ingress_shed_total",
                "Transactions shed by the admission controller",
                node=nl, reason=reason)
            for reason in SHED_REASONS
        }

    def capacity_stats(self) -> dict:
        """Capacity plane (docs/observability.md "Capacity"): retained
        bytes of the admission tables — the per-client token-bucket
        map, the parked-subscriber registry, and the recent-commit
        lookup ring. The intake queue itself reports through the
        standard queue families."""
        with self.quotas._lock:
            buckets = len(self.quotas._buckets)
        subs = self.subscriptions
        with subs._lock:
            waiters = subs._count
            recent = len(subs._recent)
        return {
            "components": {
                "ingress_quota_table": {
                    "rows": buckets, "bytes": buckets * 260},
                "ingress_subscriptions": {
                    "rows": waiters + recent,
                    # A parked waiter is an Event + dict entry; a
                    # recent-commit row is a digest -> small-dict map
                    # entry.
                    "bytes": waiters * 400 + recent * 360},
            },
        }

    # -- admission ----------------------------------------------------

    def delay(self) -> float:
        """The controller's signal: the worst sojourn across the
        pipeline's queues (oldest queued item's age)."""
        node = self.node
        return max(self.intake.oldest_age(),
                   node._work.oldest_age(),
                   node.commit_ch.oldest_age())

    def _downstream_saturated(self) -> bool:
        """Hard guard: shed at the front door while the work/commit
        queues still have headroom to drain, never after they drop."""
        node = self.node
        work_cap = node._work.maxsize
        commit_cap = node.commit_ch.maxsize
        return ((work_cap > 0
                 and node._work.qsize() >= 0.9 * work_cap)
                or (commit_cap > 0
                    and node.commit_ch.qsize() >= 0.9 * commit_cap))

    def submit(self, client: str, txs: List[bytes]) -> Dict[str, object]:
        """Run a batch through quota -> controller -> intake. Returns
        per-tx statuses + digests and the aggregate counts the HTTP
        layer turns into a response."""
        now = time.monotonic()
        delay = self.delay()
        saturated = self._downstream_saturated()
        granted, quota_retry = self.quotas.grant(client, len(txs), now)
        statuses: List[str] = []
        digests: List[str] = []
        accepted = shed = 0
        node = self.node
        for i, tx in enumerate(txs):
            digests.append(tx_digest(tx))
            if i >= granted:
                self._m_quota.inc()
                statuses.append("quota_rejected")
                continue
            if saturated:
                self._m_shed[SHED_DOWNSTREAM].inc()
                statuses.append("shed")
                shed += 1
                continue
            if not self.controller.admit(delay, now):
                self._m_shed[SHED_OVERLOAD].inc()
                statuses.append("shed")
                shed += 1
                continue
            node._stamp_tx(tx)
            if self.intake.put_drop(tx):
                self._m_admitted.inc()
                statuses.append("accepted")
                accepted += 1
            else:
                self._m_shed[SHED_INTAKE_FULL].inc()
                statuses.append("shed")
                shed += 1
        quota_rejected = len(txs) - granted
        retry = 0.0
        if shed:
            # Back off proportionally to the measured delay: by the
            # time the client retries, the standing queue should have
            # drained past the target.
            retry = max(1.0, math.ceil(2.0 * max(delay, 0.5)))
        if quota_rejected:
            retry = max(retry, math.ceil(max(quota_retry, 1.0)))
        return {
            "accepted": accepted,
            "shed": shed,
            "quota_rejected": quota_rejected,
            "digests": digests,
            "statuses": statuses,
            "retry_after": int(retry),
        }

    def shed_subscriber(self) -> None:
        self._m_shed[SHED_SUBSCRIBERS].inc()

    # -- commit resolution --------------------------------------------

    def resolve_block(self, block) -> None:
        """Called from Node._commit after app delivery: record every
        committed tx's digest and wake its subscribers."""
        txs = block.transactions or []
        if not txs:
            return
        rr = block.round_received
        for tx in txs:
            self.subscriptions.resolve(
                tx_digest(tx), {"round": rr, "node": self.node.id})

    def wait_commit(self, digest: str,
                    timeout: float) -> Optional[Dict[str, object]]:
        """Long-poll body: resolved info, or None on timeout. Raises
        BlockingIOError when the waiter registry is full (the HTTP
        layer turns that into a 429)."""
        w = self.lookup_or_register(digest)
        if w is None:
            raise BlockingIOError("subscriber registry full")
        if w.event.wait(timeout):
            return w.result
        self.subscriptions.unregister(digest, w)
        return None

    def lookup_or_register(self, digest: str) -> Optional[_Waiter]:
        """Shared by the long-poll and SSE paths: check the recent
        ring, then the store's block history (covers a restarted node
        whose ring is empty — bootstrap replay plus this scan make
        /subscribe restart-proof), then park a waiter."""
        hit = self.subscriptions.lookup(digest)
        if hit is None:
            hit = self._scan_store(digest)
        if hit is not None:
            w = _Waiter()
            w.result = hit
            w.event.set()
            return w
        return self.subscriptions.register(digest)

    def _scan_store(self, digest: str,
                    max_blocks: int = 128) -> Optional[Dict[str, object]]:
        store = self.node.core.hg.store
        try:
            last = int(store.last_committed_block())
        except Exception:  # noqa: BLE001 - store without an anchor
            return None
        for rr in range(last, max(-1, last - max_blocks), -1):
            try:
                block = store.get_block(rr)
            except Exception:  # noqa: BLE001 - pruned/missing round
                continue
            for tx in block.transactions or []:
                if tx_digest(tx) == digest:
                    info = {"round": rr, "node": self.node.id}
                    # Cache in the ring so the next poll is O(1).
                    self.subscriptions.resolve(digest, info)
                    return info
        return None

    # -- observability ------------------------------------------------

    def debug_table(self) -> Dict[str, object]:
        shed = {r: int(c.value) for r, c in self._m_shed.items()}
        return {
            "admitted": int(self._m_admitted.value),
            "shed": shed,
            "quota_rejected": int(self._m_quota.value),
            "controller": self.controller.state(),
            "delay_ms": round(self.delay() * 1000.0, 3),
            "intake": self.intake.instrument.snapshot(),
            "quota": {
                "rate": self.quotas.rate,
                "burst": self.quotas.burst,
                "enabled": self.quotas.enabled,
                "clients": self.quotas.table(),
            },
            "subscribers": self.subscriptions.waiter_count(),
        }
