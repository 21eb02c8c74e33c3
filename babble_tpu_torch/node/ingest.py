"""Host ingest helpers: the batch-first signature-verify plane.

A sync batch's ECDSA checks are the dominant host cost of the gossip
ingest path (BENCH_r05: the device engine sustains ~28k ev/s while the
live node path delivers ~500), and none of them needs the core lock —
signature validity is a pure function of the event bytes. `Core.sync`
therefore materializes the whole batch first, then calls
`verify_events` with the lock RELEASED (node's `_core_unlocked` seam),
and only re-acquires it for the insert phase.

Batch-first (docs/ingest.md "Crypto plane"): each pool chunk makes ONE
`crypto.verify_batch` call instead of per-event `verify()` calls, so
the backend can share per-creator EC_KEY precompute across the chunk
and — on the pure fallback — fuse every signature's modular inversion
into a single Montgomery batched-inversion pass. With
`device_verify=True` the whole batch bypasses the pool and runs on the
`ops/p256.py` CUDA kernel (csrc/p256.cu) instead, on its own stream of
the device the consensus engine already owns; a kernel failure raises,
and nothing falls back to the host pool behind the flag.

Worker pool: one process-global ThreadPoolExecutor shared by every
in-process node (a 16-node localhost testnet must not spawn 16 pools).
With the `cryptography` backend (OpenSSL) each verify releases the GIL,
so chunks run genuinely in parallel; the pure-Python fallback is
GIL-bound but still gets the chunked path — the win there is that
verification happens outside the core lock, so the node keeps serving
syncs and accepting pushes while a batch grinds.

Verification results are memoized on the Event (`Event._sig_ok`), so
the engine's own insert-time `verify()` re-check is a cache hit. A
malformed creator point yields a `None` verdict from `verify_batch`;
the memo is left unset, and the insert loop's own `verify()` then
raises the identical exception at the same batch position the serial
path would have.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Callable, List, Optional

from .. import crypto
from ..devices import resolve_device
from ..telemetry import get_registry
from ..telemetry.queues import QueueInstrument

_MAX_WORKERS = 8
# Below this batch size the pool's submit/wake overhead beats any
# parallelism — verify inline on the calling thread.
_MIN_POOL_BATCH = 8

_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0
_pool_lock = threading.Lock()
# Saturation accounting for the shared pool (docs/observability.md
# "Saturation"): chunk submissions stamp an enqueue time; the worker
# observes submit->start wait. The pool is process-global, so the
# instrument lives in the process-global registry (no node label);
# depth reads the executor's pending work queue at scrape time.
_q_inst: Optional[QueueInstrument] = None

# Crypto-plane telemetry (docs/observability.md "Crypto plane"):
# `babble_verify_backend{backend}` is an info gauge — value 1, the
# label names the backend actually verifying — and
# `babble_verify_batch_size` records the size of every batch handed to
# a backend `verify_batch` call (the number whose distribution tells
# whether batching amortizes: all-1s means the plane degraded to
# serial). Process-global like the pool they instrument.
_batch_hist = None
_backend_gauges: set = set()
_metrics_lock = threading.Lock()


def _observe_batch(size: int, backend: str) -> None:
    global _batch_hist
    with _metrics_lock:
        if _batch_hist is None:
            _batch_hist = get_registry().histogram(
                "babble_verify_batch_size",
                "Events per backend verify_batch call")
        if backend not in _backend_gauges:
            get_registry().gauge(
                "babble_verify_backend",
                "Active signature-verify backend (info gauge: value 1, "
                "label names the backend)", backend=backend).set(1)
            _backend_gauges.add(backend)
    _batch_hist.observe(size)


def _device_backend(device=None, parts=None) -> Callable:
    """The port's device P-256 verify_batch, bound to `device` (CUDA
    unless the caller names another; raises when there is none), filling
    `parts` with its counters when given a dict."""
    from ..ops import p256

    kw = {} if parts is None else {"parts": parts}
    return functools.partial(p256.verify_batch, device=resolve_device(device), **kw)


def active_backend(device_verify: bool = False) -> str:
    """Name of the backend `verify_events` would use — the label on
    the `babble_verify_backend` gauge and the `/debug/phases`
    `verify_<backend>` sub-split."""
    if device_verify:
        return "device-p256"
    return crypto.BACKEND


def default_verify_workers() -> int:
    """Auto pool size: one worker per core, capped — verification is
    CPU-bound, and past the cap coordination overhead wins."""
    return max(1, min(_MAX_WORKERS, os.cpu_count() or 1))


def resolve_verify_workers(verify_workers: int) -> int:
    """Config knob semantics: < 0 = auto (core-count), 0/1 = inline
    serial, n > 1 = a pool of n."""
    if verify_workers < 0:
        return default_verify_workers()
    return min(verify_workers, _MAX_WORKERS) or 1


def _get_pool(workers: int) -> ThreadPoolExecutor:
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None or _pool_size < workers:
            old = _pool
            _pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="babble-verify")
            _pool_size = workers
            if old is not None:
                old.shutdown(wait=False)
        return _pool


def verify_batch_events(events, backend: Optional[Callable] = None,
                        backend_name: str = "") -> None:
    """Populate `_sig_ok` memos for `events` with ONE backend
    `verify_batch` call. Verdict contract (docs/ingest.md "Crypto
    plane"): True/False memoize; None (malformed creator point) leaves
    the memo unset so the insert loop's `verify()` re-raises the
    identical exception at the serial path's batch position."""
    todo = [ev for ev in events if ev._sig_ok is None]
    if not todo:
        return
    fn = backend if backend is not None else crypto.verify_batch
    _observe_batch(len(todo), backend_name or crypto.BACKEND)
    verdicts = fn(
        [ev.body.creator for ev in todo],
        [ev.body.hash() for ev in todo],
        [(int(ev.r), int(ev.s)) for ev in todo])
    for ev, ok in zip(todo, verdicts):
        if ok is not None:
            ev._sig_ok = bool(ok)


def _verify_chunk(events, enq_ts: float = 0.0,
                  inst: Optional[QueueInstrument] = None) -> None:
    # Submit->start wait: how long the chunk sat behind other batches
    # in the shared pool before a worker picked it up. Observed FIRST
    # so a raising backend still leaves the wait accounted.
    if inst is not None:
        inst.observe_wait(time.monotonic() - enq_ts)
    try:
        verify_batch_events(events)
    except Exception:  # noqa: BLE001
        # Leave the memos unset: the insert loop's own verify() will
        # re-raise the identical exception at the serial path's
        # position instead of this worker's.
        pass


def _procs_depth() -> int:
    """Chunks in flight on the process pool — the procs runtime's
    contribution to the shared verify_pool depth gauge."""
    try:
        from . import runtime as _rt
        pool = _rt.active_pool()
        return pool.pending() if pool is not None else 0
    except Exception:  # noqa: BLE001 - depth is best-effort scrape state
        return 0


def _pool_instrument() -> QueueInstrument:
    global _q_inst
    if _q_inst is None:
        _q_inst = QueueInstrument(
            get_registry(), "verify_pool", 0,
            depth_fn=lambda: (_pool._work_queue.qsize()
                              if _pool is not None else 0) + _procs_depth())
    return _q_inst


def verify_events(events: List, workers: int,
                  device_verify: bool = False,
                  runtime: str = "threads", device=None,
                  parts: Optional[dict] = None) -> None:
    """Populate every event's signature memo. Returns nothing:
    outcomes (ok / bad / raising) are delivered through `Event.verify`
    exactly as the serial path delivers them.

    Host path: the batch is chunked across the shared pool, one
    `crypto.verify_batch` call per chunk. Device path
    (`device_verify=True`): the WHOLE batch goes to the `ops/p256.py`
    kernel on `device` in one call — the kernel is internally
    batch-parallel, so farming chunks to threads would only contend the
    single device; a kernel failure raises, with no memo written.
    `parts`, a dict, receives the kernel call's counters (ops/p256.py
    `verify_batch`); it stays empty when nothing reached the kernel."""
    n = len(events)
    if n == 0:
        return
    if device_verify:
        verify_batch_events(events, _device_backend(device, parts), "device-p256")
        return
    if runtime == "procs" and workers > 1 and n >= _MIN_POOL_BATCH:
        # Off-GIL plane (docs/runtime.md): columns cross to spawned
        # worker processes over shared memory, verdict bytes come
        # back the same way. False = pool unavailable on this
        # platform -> the thread path below, identical memo contract.
        from . import runtime as _rt
        if _rt.verify_events_procs(events, workers):
            return
    if workers <= 1 or n < _MIN_POOL_BATCH:
        _verify_chunk(events)
        return
    pool = _get_pool(workers)
    inst = _pool_instrument()
    chunk = -(-n // workers)  # ceil
    t0 = time.monotonic()
    chunks = [events[i:i + chunk] for i in range(0, n, chunk)]
    futures = [pool.submit(_verify_chunk, c, t0, inst) for c in chunks]
    for f, c in zip(futures, chunks):
        try:
            f.result()
        except CancelledError:
            # The shared pool was replaced/shut down between submit and
            # pickup (`_get_pool` growth does `shutdown(wait=False)`):
            # the chunk never ran, so nothing observed its wait. Keep
            # the accounting honest — observe the queued time and count
            # the shed — then verify inline with identical semantics.
            inst.observe_wait(time.monotonic() - t0)
            inst.record_drop()
            _verify_chunk(c)
