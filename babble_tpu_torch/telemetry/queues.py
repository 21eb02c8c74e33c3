"""Queue/backpressure accounting (docs/observability.md "Saturation").

Every bounded buffer in the pipeline — the node's commit channel and
consensus work queue, the verify pool's pending batches, the per-edge
Plumtree push windows, the TCP consumer queue — reports through one
`QueueInstrument` bundle:

- `babble_queue_depth{queue}` / `babble_queue_capacity{queue}` gauges
  (depth is a scrape-time callback, so nothing polls; capacity 0 means
  unbounded),
- `babble_queue_wait_seconds{queue}` — the enqueue→dequeue wait-time
  histogram, the USE-method saturation signal ("how long does work sit
  before it runs"),
- `babble_queue_dropped_total{queue}` — overflow/shed counter.

`InstrumentedQueue` is the drop-in `queue.Queue` form: entries are
timestamped in `_put` and unwrapped in `_get`, both of which run under
the stdlib queue mutex, so `put`/`get`/`put_nowait`/`get_nowait`/
`qsize` keep their exact semantics and every dequeue path (including
shutdown drains) feeds the wait histogram for free. Buffers that are
not literal Queues (Plumtree's per-peer push lists, the verify pool's
futures) stamp their own enqueue times and call `observe_wait` at the
dequeue point instead — same family, same labels, no second
bookkeeping path."""

from __future__ import annotations

import queue
import time
from typing import Callable, Dict, Optional

from .registry import Registry

_D_HELP = "Current depth of a bounded pipeline buffer"
_C_HELP = "Capacity of a bounded pipeline buffer (0 = unbounded)"
_W_HELP = "Enqueue-to-dequeue wait of items in a pipeline buffer"
_X_HELP = "Items dropped or shed on buffer overflow"


class QueueInstrument:
    """The metric bundle for one named buffer (one label set across
    the four `babble_queue_*` families)."""

    __slots__ = ("name", "capacity", "_depth", "_wait", "_dropped")

    def __init__(self, registry: Registry, name: str, capacity: int,
                 depth_fn: Optional[Callable[[], float]] = None,
                 **labels):
        lb = dict(labels)
        lb["queue"] = name
        self.name = name
        self.capacity = int(capacity)
        self._depth = registry.gauge("babble_queue_depth", _D_HELP, **lb)
        if depth_fn is not None:
            self._depth.set_fn(depth_fn)
        registry.gauge(
            "babble_queue_capacity", _C_HELP, **lb).set(self.capacity)
        self._wait = registry.histogram(
            "babble_queue_wait_seconds", _W_HELP, **lb)
        self._dropped = registry.counter(
            "babble_queue_dropped_total", _X_HELP, **lb)

    def set_depth_fn(self, fn: Callable[[], float]) -> None:
        self._depth.set_fn(fn)

    def observe_wait(self, seconds: float) -> None:
        self._wait.observe(seconds if seconds > 0.0 else 0.0)

    def record_drop(self, n: int = 1) -> None:
        self._dropped.inc(n)

    def snapshot(self) -> Dict[str, object]:
        """Depth/capacity/wait-quantile summary for the /debug planes
        (sourced from the same instruments the scrape exports)."""
        snap = self._wait.snapshot()
        return {
            "depth": int(self._depth.value),
            "capacity": self.capacity,
            "waits": snap.count,
            "wait_p50_ms": round(snap.quantile(0.5) * 1000.0, 3),
            "wait_p99_ms": round(snap.quantile(0.99) * 1000.0, 3),
            "dropped": int(self._dropped.value),
        }


class InstrumentedQueue(queue.Queue):
    """`queue.Queue` that feeds a QueueInstrument transparently.

    `_put`/`_get` are the stdlib's internal hooks (every public
    entry point — blocking or nowait — routes through them while
    holding the queue mutex), so wrapping there keeps external
    behavior byte-identical: callers still get raw items, `Full` /
    `Empty` still raise, `qsize()` still counts items."""

    def __init__(self, maxsize: int, instrument: QueueInstrument):
        super().__init__(maxsize)
        self.instrument = instrument
        if instrument is not None:
            instrument.set_depth_fn(self.qsize)

    def _put(self, item) -> None:
        self.queue.append((time.monotonic(), item))

    def _get(self):
        ts, item = self.queue.popleft()
        inst = self.instrument
        if inst is not None:
            inst.observe_wait(time.monotonic() - ts)
        return item

    def oldest_age(self) -> float:
        """Age of the oldest queued entry (0.0 when empty) — the
        sojourn-time signal the ingress admission controller runs its
        CoDel law on: unlike depth, it reads as seconds of standing
        delay regardless of capacity."""
        with self.mutex:
            if not self.queue:
                return 0.0
            return time.monotonic() - self.queue[0][0]

    def put_drop(self, item) -> bool:
        """`put_nowait` that records an overflow drop instead of
        raising — the shed idiom for fire-and-forget producers."""
        try:
            self.put_nowait(item)
            return True
        except queue.Full:
            if self.instrument is not None:
                self.instrument.record_drop()
            return False
