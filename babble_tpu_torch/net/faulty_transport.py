"""Chaos-injection transport decorator.

FaultyTransport wraps any Transport with a SEEDED, per-peer-pair fault
plan — drop, jittered delay, duplicate, asymmetric partition, and
crash — so multi-node convergence can be soak-tested reproducibly
(same seed => same fault decisions at the same call indices). Babble's
value proposition is BFT ordering under partial failure; this is the
harness that injects those failures deterministically in CI
(tests/test_chaos.py, docs/robustness.md).

Fault model:

- drop: an outbound RPC raises TransportError before touching the wire
  (a lost request — the caller sees the same failure as a timeout,
  minus the wait).
- delay: an outbound RPC sleeps uniform(delay_min, delay_max) first
  (network jitter; keep max below the inner transport's timeout unless
  timeouts themselves are under test).
- duplicate: an eager-sync push is delivered twice (exactly the
  at-least-once delivery the hash-deduped insert path must absorb).
  Pulls are not duplicated — a duplicate request only costs the peer a
  wasted diff, it cannot corrupt anything.
- partition(target): outbound RPCs to `target` fail immediately.
  Asymmetric by construction: it only affects THIS side's outbound leg;
  the reverse direction flows until the other side partitions too.
- crash(): every outbound RPC fails AND every inbound RPC is answered
  with a transport error (the node process stays alive but is
  unreachable both ways — network-equivalent of a crashed box).
  restore() heals it; the node then catches up through normal gossip
  or fast-sync.

All faults are applied on the OUTBOUND leg (plus the inbound crash
gate), so a single wrapped node in an otherwise healthy net models an
unreliable last hop, and wrapping every node models a lossy fabric.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from .transport import (
    EagerSyncRequest,
    EagerSyncResponse,
    FastForwardRequest,
    FastForwardResponse,
    GraftRequest,
    GraftResponse,
    IHaveRequest,
    IHaveResponse,
    PruneRequest,
    PruneResponse,
    SyncRequest,
    SyncResponse,
    TransportError,
)


@dataclass
class FaultSpec:
    """Per-target fault probabilities/parameters."""

    drop: float = 0.0
    delay_min: float = 0.0
    delay_max: float = 0.0
    duplicate: float = 0.0


class FaultyTransport:
    """Transport decorator injecting seeded faults (see module doc)."""

    def __init__(
        self,
        inner,
        seed: int = 0,
        *,
        drop: float = 0.0,
        delay_min: float = 0.0,
        delay_max: float = 0.0,
        duplicate: float = 0.0,
    ):
        self._inner = inner
        self._seed = seed
        self._default = FaultSpec(drop, delay_min, delay_max, duplicate)
        self._per_target: Dict[str, FaultSpec] = {}
        self._blocked: set[str] = set()
        self._crashed = threading.Event()
        self._closed = threading.Event()
        self._rngs: Dict[str, random.Random] = {}
        self._lock = threading.Lock()
        # Injection counters — test/observability surface. Mirrored
        # into the process-global telemetry registry so a /metrics
        # scrape of a chaos-wrapped node shows what the fault plan
        # actually injected (docs/observability.md).
        self.injected = {"drop": 0, "delay": 0, "duplicate": 0,
                         "partitioned": 0, "crashed": 0,
                         "inbound_crashed": 0, "equivocate": 0}
        # Byzantine equivocation injector (docs/observability.md
        # "Consensus health"): queued forged wire events delivered as
        # an extra eager-sync push, proving fork detection fires
        # within one gossip round. Tests build the conflicting signed
        # events (they hold the keys); the transport only delivers.
        self._equivocations: list = []
        from ..telemetry import get_registry

        _reg = get_registry()
        addr = inner.local_addr()
        self._m_injected = {
            kind: _reg.counter(
                "babble_transport_faults_total",
                "Chaos-transport injected faults", addr=addr, kind=kind)
            for kind in self.injected
        }
        # Own consumer queue fed by a pump thread: the crash gate must
        # intercept INBOUND RPCs too (peers enqueue straight onto the
        # inner transport), answering them with an error so callers
        # fail fast instead of waiting out their timeout.
        self._consumer: "queue.Queue" = queue.Queue()
        self._pump = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump.start()

    # -- fault plan management --------------------------------------------

    def set_faults(self, target: str, **kw) -> None:
        """Override the fault spec for one peer-pair (kwargs as in the
        constructor; unspecified fields inherit the defaults)."""
        with self._lock:
            base = self._per_target.get(target, self._default)
            self._per_target[target] = FaultSpec(
                kw.get("drop", base.drop),
                kw.get("delay_min", base.delay_min),
                kw.get("delay_max", base.delay_max),
                kw.get("duplicate", base.duplicate),
            )

    def partition(self, *targets: str) -> None:
        """Block the outbound leg to the given peers (asymmetric)."""
        with self._lock:
            self._blocked.update(targets)

    def heal(self, *targets: str) -> None:
        """Heal given partitions, or all of them when called bare."""
        with self._lock:
            if targets:
                self._blocked.difference_update(targets)
            else:
                self._blocked.clear()

    def crash(self) -> None:
        self._crashed.set()

    def restore(self) -> None:
        self._crashed.clear()

    def inject_equivocation(self, wire_events, target: str = "") -> None:
        """Queue one forged push: `wire_events` (signed, conflicting
        WireEvents built by the test) are delivered as an extra
        EagerSyncRequest to `target` — or to whichever peer the next
        outbound push goes to, when no target is given. The genuine
        payload is delivered unmodified first, so the honest DAG is
        unaffected; the receiver's insert path must reject the forged
        copy and record fork evidence."""
        with self._lock:
            self._equivocations.append((target, list(wire_events)))

    # -- fault application --------------------------------------------------

    def _inject(self, kind: str) -> None:
        self.injected[kind] += 1
        self._m_injected[kind].inc()

    def _spec_rng(self, target: str):
        with self._lock:
            spec = self._per_target.get(target, self._default)
            rng = self._rngs.get(target)
            if rng is None:
                # Deterministic per-(seed, src, dst) stream: the same
                # seed replays the same drop/delay/duplicate decisions
                # at the same call indices for this pair.
                rng = random.Random(
                    f"{self._seed}|{self._inner.local_addr()}|{target}")
                self._rngs[target] = rng
            return spec, rng

    def _apply(self, target: str) -> tuple:
        if self._crashed.is_set():
            self._inject("crashed")
            raise TransportError("crashed (injected)")
        with self._lock:
            blocked = target in self._blocked
        if blocked:
            self._inject("partitioned")
            raise TransportError(f"partitioned from {target} (injected)")
        spec, rng = self._spec_rng(target)
        if spec.drop > 0.0 and rng.random() < spec.drop:
            self._inject("drop")
            raise TransportError(f"dropped rpc to {target} (injected)")
        if spec.delay_max > 0.0:
            self._inject("delay")
            time.sleep(rng.uniform(spec.delay_min, spec.delay_max))
        return spec, rng

    # -- Transport surface --------------------------------------------------

    def consumer(self) -> "queue.Queue":
        return self._consumer

    def local_addr(self) -> str:
        return self._inner.local_addr()

    def sync(self, target: str, args: SyncRequest) -> SyncResponse:
        self._apply(target)
        return self._inner.sync(target, args)

    def eager_sync(self, target: str,
                   args: EagerSyncRequest) -> EagerSyncResponse:
        spec, rng = self._apply(target)
        resp = self._inner.eager_sync(target, args)
        if spec.duplicate > 0.0 and rng.random() < spec.duplicate:
            # At-least-once delivery: the duplicate's outcome is
            # irrelevant (the first one already succeeded).
            self._inject("duplicate")
            try:
                self._inner.eager_sync(target, args)
            except TransportError:
                pass
        self._maybe_equivocate(target, args.from_id)
        return resp

    def _maybe_equivocate(self, target: str, from_id: int) -> None:
        """Deliver any queued forged payload destined for `target` as
        its own push. The receiver is expected to REJECT it (fork
        evidence + error response), so the error is swallowed — a
        Byzantine sender would not care either."""
        with self._lock:
            picked = None
            for i, (tgt, events) in enumerate(self._equivocations):
                if not tgt or tgt == target:
                    picked = self._equivocations.pop(i)[1]
                    break
        if picked is None:
            return
        self._inject("equivocate")
        try:
            self._inner.eager_sync(
                target, EagerSyncRequest(from_id, picked))
        except TransportError:
            pass

    def ihave(self, target: str, args: IHaveRequest) -> IHaveResponse:
        # The lazy-repair announcements ride the same fault plan as the
        # data legs: dropped IHAVEs are exactly the loss mode the
        # anti-entropy backstop must absorb (docs/gossip.md).
        spec, rng = self._apply(target)
        resp = self._inner.ihave(target, args)
        if spec.duplicate > 0.0 and rng.random() < spec.duplicate:
            self._inject("duplicate")
            try:
                self._inner.ihave(target, args)
            except TransportError:
                pass
        return resp

    def graft(self, target: str, args: GraftRequest) -> GraftResponse:
        self._apply(target)
        return self._inner.graft(target, args)

    def prune(self, target: str, args: PruneRequest) -> PruneResponse:
        self._apply(target)
        return self._inner.prune(target, args)

    def fast_forward(self, target: str,
                     args: FastForwardRequest) -> FastForwardResponse:
        self._apply(target)
        return self._inner.fast_forward(target, args)

    def close(self) -> None:
        self._closed.set()
        self._inner.close()
        self._pump.join(timeout=1.0)

    # -- inbound pump -------------------------------------------------------

    def _pump_loop(self) -> None:
        src = self._inner.consumer()
        while not self._closed.is_set():
            try:
                rpc = src.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._crashed.is_set():
                self._inject("inbound_crashed")
                rpc.respond(None, TransportError("peer crashed (injected)"))
                continue
            self._consumer.put(rpc)
