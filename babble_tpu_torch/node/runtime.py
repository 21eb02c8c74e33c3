"""Off-GIL process runtime: the verify/decode planes on worker
processes (docs/runtime.md).

PR 15's thread-CPU attribution proved the node's roles starve each
other on one core, and PR 16's batched crypto left both multicore
gates deferred for one reason: Python threads cannot use a second core
even when it exists. `Config.runtime = "procs"` (`--runtime procs`)
moves the two heavy, lock-free planes of gossip ingest off the GIL:

- **Verify plane.** `verify_events_procs` ships a sync batch's
  pubs/digests/sigs to a process pool as one shared-memory columnar
  frame — the same column layout the PR 7 wire codec uses (sigs are
  r||s 32+32 BE, exactly `ColumnarEvents.sigs`), so the hand-off is a
  straight memcpy into the segment and NO pickling: workers slice the
  columns in place, call `crypto.verify_batch`, and write a one-byte
  verdict per row back into the same segment. The serial-identical
  failure-position contract from the batched-verify PR is preserved
  byte-for-byte: verdict 2 (malformed creator point) leaves the
  `Event._sig_ok` memo unset, so the insert loop's own `verify()`
  raises at the identical batch position the serial path would have.
- **Decode plane.** `decode_columnar` routes large inbound TCP
  columnar frames through the same pool: the frame bytes cross via
  shared memory, the worker runs the full `ColumnarEvents.decode`
  integrity validation (length/count/blob-sum checks — the part a
  malicious frame makes expensive) off-process, and the parent then
  re-views the validated frame with the checks skipped.

Supervision (mirrors the cancelled-chunk contract of the thread
pool): a worker that dies mid-chunk is detected at reply time — the
chunk observes its queued wait, counts a drop on the shared
`verify_pool` instrument, and is re-verified inline with identical
memo semantics; the dead worker is respawned on next use and
`babble_worker_restarts_total` counts the supervision event.

Telemetry crosses the boundary the other way: each worker keeps its
own process-global `Registry` (verify batch-size histogram, backend
info gauge, chunk/event counters) and answers a `scrape` message with
a plain-data snapshot plus its process CPU clock. `scrape_children`
(called from the node's /metrics gauge refresh) mirrors those
registries into the parent's process-global one with a
`process=verify-N` label — `telemetry.registry.absorb_state` — so the
saturation plane still names the bottleneck when the bottleneck is in
a child. Like any real per-process collector, a worker restart resets
its mirrored series.

The pool is process-global and shared by every procs-mode node in the
process (the same sharing discipline as the thread pool in ingest.py);
routing is PER CALL, so one test process can run a mixed
threads/procs cluster. Workers are spawned (never forked — the node
is heavily threaded) and daemonic: they die with the parent.
"""

from __future__ import annotations

import atexit
import os
import struct
import threading
import time
from typing import List, Optional, Tuple

RUNTIME_THREADS = "threads"
RUNTIME_PROCS = "procs"
RUNTIMES = (RUNTIME_THREADS, RUNTIME_PROCS)

# Shared-memory verify frame: magic + u32 n, then the columns —
# pubs (65B X9.62 points), digests (32B sha256), sigs (r||s 32+32 BE,
# the ColumnarEvents.sigs layout), verdicts (1B/row, worker-written:
# 0=False 1=True 2=None/unset).
VERIFY_MAGIC = b"BBV1"
_HDR = 8
_PUB, _DIG, _SIG = 65, 32, 64
_ROW = _PUB + _DIG + _SIG + 1

# Frames below this skip the decode offload: the SHM round trip costs
# more than validating a small frame inline.
_MIN_DECODE_BYTES = 16384

_pool = None
_pool_lock = threading.Lock()

# Capacity plane (docs/observability.md "Capacity"): live + peak bytes
# of the verify/decode shared-memory segments. Segments are born and
# unlinked within one batch, so `live` is usually 0 at scrape — the
# peak is the number that sizes /dev/shm headroom.
_shm_lock = threading.Lock()
_shm_live_bytes = 0
_shm_peak_bytes = 0


def _shm_track(nbytes: int) -> None:
    global _shm_live_bytes, _shm_peak_bytes
    with _shm_lock:
        _shm_live_bytes += nbytes
        if _shm_live_bytes > _shm_peak_bytes:
            _shm_peak_bytes = _shm_live_bytes


def _shm_untrack(nbytes: int) -> None:
    global _shm_live_bytes
    with _shm_lock:
        _shm_live_bytes = max(0, _shm_live_bytes - nbytes)


def shm_stats() -> dict:
    with _shm_lock:
        return {"live_bytes": _shm_live_bytes,
                "peak_bytes": _shm_peak_bytes}
_last_scrape = 0.0
_SCRAPE_MIN_INTERVAL = 0.2


def resolve_runtime(runtime: Optional[str]) -> str:
    """Config knob semantics: None/"" = threads (the default)."""
    rt = runtime or RUNTIME_THREADS
    if rt not in RUNTIMES:
        raise ValueError(
            f"unknown runtime {runtime!r} (expected one of {RUNTIMES})")
    return rt


def _offsets(n: int) -> Tuple[int, int, int, int]:
    po = _HDR
    do = po + _PUB * n
    so = do + _DIG * n
    vo = so + _SIG * n
    return po, do, so, vo


def _attach_shm(name: str):
    """Attach an existing segment in a worker. Pre-3.13 CPython
    registers an attach with the resource tracker too (there is no
    track=False yet), but spawned workers inherit the PARENT'S tracker
    process, so the re-register is an idempotent set-add and the
    parent's unlink is the single clean unregister — no extra
    bookkeeping needed here."""
    from multiprocessing import shared_memory

    return shared_memory.SharedMemory(name=name)


# ---------------------------------------------------------------- worker


def _worker_main(conn, wname: str) -> None:
    """Worker loop (spawned child): verify / decode / scrape messages
    over one duplex pipe, columns over shared memory. Runs with its
    own GIL and its own process-global registry."""
    from .. import crypto
    from ..telemetry import get_registry
    from ..telemetry.registry import export_state

    reg = get_registry()
    m_chunks = reg.counter(
        "babble_worker_chunks_total",
        "Verify/decode chunks processed by this worker process")
    m_events = reg.counter(
        "babble_worker_events_total",
        "Events signature-verified by this worker process")
    batch_hist = reg.histogram(
        "babble_verify_batch_size",
        "Events per backend verify_batch call")
    reg.gauge(
        "babble_verify_backend",
        "Active signature-verify backend (info gauge: value 1, "
        "label names the backend)", backend=crypto.BACKEND).set(1)

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        kind = msg[0]
        if kind == "verify":
            _, shm_name, n, start, stop = msg
            t_start = time.monotonic()
            try:
                shm = _attach_shm(shm_name)
                try:
                    _verify_rows(shm.buf, n, start, stop)
                finally:
                    shm.close()
                m_chunks.inc()
                m_events.inc(stop - start)
                batch_hist.observe(stop - start)
                reply = ("ok", start, stop, t_start)
            except Exception as exc:  # noqa: BLE001
                reply = ("err", start, stop, repr(exc))
            try:
                conn.send(reply)
            except (BrokenPipeError, OSError):
                return
        elif kind == "decode":
            _, shm_name, nbytes = msg
            try:
                from ..net.columnar import ColumnarEvents

                shm = _attach_shm(shm_name)
                try:
                    ColumnarEvents.decode(bytes(shm.buf[:nbytes]))
                finally:
                    shm.close()
                m_chunks.inc()
                reply = ("ok",)
            except Exception as exc:  # noqa: BLE001
                reply = ("err", str(exc))
            try:
                conn.send(reply)
            except (BrokenPipeError, OSError):
                return
        elif kind == "scrape":
            t = os.times()
            try:
                conn.send(("scrape", export_state(reg), t.user + t.system))
            except (BrokenPipeError, OSError):
                return
        elif kind == "exit":
            return


def _verify_rows(buf, n: int, start: int, stop: int) -> None:
    """ECDSA-verify rows [start, stop) of a shared verify frame in
    place: slice the columns, one `crypto.verify_batch` call, verdict
    bytes back into the frame. A raising backend writes verdict 2
    (= memo left unset) for the whole chunk, so the insert loop
    re-raises at the serial path's position — the thread pool's
    exception-swallowing contract."""
    from .. import crypto

    po, do, so, vo = _offsets(n)
    try:
        pubs = [bytes(buf[po + _PUB * k:po + _PUB * (k + 1)])
                for k in range(start, stop)]
        digests = [bytes(buf[do + _DIG * k:do + _DIG * (k + 1)])
                   for k in range(start, stop)]
        sigs = []
        for k in range(start, stop):
            off = so + _SIG * k
            sigs.append((int.from_bytes(buf[off:off + 32], "big"),
                         int.from_bytes(buf[off + 32:off + 64], "big")))
        verdicts = crypto.verify_batch(pubs, digests, sigs)
        for k, v in zip(range(start, stop), verdicts):
            buf[vo + k] = 2 if v is None else (1 if v else 0)
    except Exception:  # noqa: BLE001
        for k in range(start, stop):
            buf[vo + k] = 2


# ------------------------------------------------------------ parent pool


class _Worker:
    __slots__ = ("name", "proc", "conn")

    def __init__(self, name, proc, conn):
        self.name = name
        self.proc = proc
        self.conn = conn


class VerifyProcPool:
    """N spawned verify workers, one duplex pipe each, supervised:
    a dead worker is respawned on next use; the chunk that observed
    the death is the caller's to re-verify inline (the drop
    contract lives in `verify_events_procs`)."""

    def __init__(self, workers: int):
        import multiprocessing as mp

        from ..telemetry import get_registry

        self._ctx = mp.get_context("spawn")
        self.size = max(1, int(workers))
        self._workers: List[Optional[_Worker]] = [None] * self.size
        # One I/O lock: a batch dispatch owns every pipe from first
        # send to last reply, so replies can never misattribute across
        # concurrent batches (the wait other batches spend here is the
        # queued wait the verify_pool instrument observes).
        self._io_lock = threading.Lock()
        self._spawn_lock = threading.Lock()
        self._pending = 0
        self._m_restarts = get_registry().counter(
            "babble_worker_restarts_total",
            "Verify worker processes respawned by the supervisor "
            "after a crash")

    # -- supervision ---------------------------------------------------

    def _spawn(self, i: int) -> _Worker:
        parent_conn, child_conn = self._ctx.Pipe()
        name = f"verify-{i}"
        proc = self._ctx.Process(
            target=_worker_main, args=(child_conn, name),
            name=f"babble-{name}", daemon=True)
        proc.start()
        child_conn.close()
        return _Worker(name, proc, parent_conn)

    def _ensure(self, i: int, count_restart: bool = True) -> _Worker:
        with self._spawn_lock:
            w = self._workers[i]
            if w is None:
                self._workers[i] = w = self._spawn(i)
            elif not w.proc.is_alive():
                try:
                    w.conn.close()
                except OSError:
                    pass
                if count_restart:
                    self._m_restarts.inc()
                self._workers[i] = w = self._spawn(i)
            return w

    def workers(self) -> List[_Worker]:
        return [self._ensure(i) for i in range(self.size)]

    def pending(self) -> int:
        return self._pending

    # -- round trips ---------------------------------------------------

    def _recv(self, w: _Worker, timeout: float = 0.1):
        """One reply, or None when the worker died before answering
        (poll + liveness check: a SIGKILLed child leaves the pipe open
        until the OS reaps it, so EOFError alone is not enough)."""
        while True:
            try:
                if w.conn.poll(timeout):
                    return w.conn.recv()
            except (EOFError, OSError):
                return None
            if not w.proc.is_alive():
                # One last drain: the reply may have been buffered
                # before death.
                try:
                    if w.conn.poll(0):
                        return w.conn.recv()
                except (EOFError, OSError):
                    pass
                return None

    def run_verify(self, shm_name: str, n: int,
                   chunks: List[Tuple[int, int]]):
        """Dispatch chunk (start, stop) ranges across the workers and
        collect per-chunk outcomes: (True, t_start) for a verified
        chunk, (False, None) for one lost to a dead worker."""
        with self._io_lock:
            self._pending = len(chunks)
            try:
                live: List[Optional[_Worker]] = []
                for i, (start, stop) in enumerate(chunks):
                    w = self._ensure(i % self.size)
                    try:
                        w.conn.send(("verify", shm_name, n, start, stop))
                        live.append(w)
                    except (BrokenPipeError, OSError):
                        live.append(None)
                outcomes = []
                for w, (start, stop) in zip(live, chunks):
                    if w is None:
                        outcomes.append((False, None))
                        continue
                    reply = self._recv(w)
                    if reply is None or reply[0] != "ok":
                        # "err" replies (a raising backend) still wrote
                        # verdict 2s — treat as delivered; only a DEAD
                        # worker loses the chunk.
                        if reply is not None:
                            outcomes.append((True, time.monotonic()))
                        else:
                            outcomes.append((False, None))
                        continue
                    outcomes.append((True, reply[3]))
                return outcomes
            finally:
                self._pending = 0

    def run_decode(self, shm_name: str, nbytes: int):
        """Validate one columnar frame on worker 0. Returns None on a
        clean validation, an error string for a malformed frame, and
        raises _WorkerDied when the worker was lost."""
        with self._io_lock:
            w = self._ensure(0)
            try:
                w.conn.send(("decode", shm_name, nbytes))
            except (BrokenPipeError, OSError):
                raise _WorkerDied(w.name)
            reply = self._recv(w)
            if reply is None:
                raise _WorkerDied(w.name)
            return None if reply[0] == "ok" else reply[1]

    def scrape(self, parent_registry) -> int:
        """Mirror every live worker's registry into `parent_registry`
        with a process label; returns how many workers answered. Never
        blocks a /metrics scrape behind a grinding batch — skips when
        the pipes are busy."""
        from ..telemetry.registry import absorb_state

        if not self._io_lock.acquire(timeout=0.5):
            return 0
        try:
            answered = 0
            for i in range(self.size):
                w = self._workers[i]
                if w is None or not w.proc.is_alive():
                    continue
                try:
                    w.conn.send(("scrape",))
                except (BrokenPipeError, OSError):
                    continue
                reply = self._recv(w, timeout=0.2)
                if reply is None or reply[0] != "scrape":
                    continue
                _, state, cpu_s = reply
                absorb_state(parent_registry, state, process=w.name)
                c = parent_registry.counter(
                    "babble_process_cpu_seconds_total",
                    "CPU seconds consumed by a runtime worker process",
                    process=w.name)
                with c._lock:
                    c._value = float(cpu_s)
                answered += 1
            return answered
        finally:
            self._io_lock.release()

    def shutdown(self) -> None:
        with self._spawn_lock:
            for w in self._workers:
                if w is None:
                    continue
                try:
                    w.conn.send(("exit",))
                except (BrokenPipeError, OSError):
                    pass
                try:
                    w.conn.close()
                except OSError:
                    pass
                w.proc.join(timeout=1.0)
                if w.proc.is_alive():
                    w.proc.terminate()
            self._workers = [None] * self.size


class _WorkerDied(RuntimeError):
    pass


def get_pool(workers: int) -> Optional[VerifyProcPool]:
    """The process-global pool, grown to at least `workers` (the
    thread-pool sharing discipline: a 16-node procs testnet shares one
    pool). None when this platform cannot spawn processes."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool.size < workers:
            old = _pool
            try:
                _pool = VerifyProcPool(workers)
            except Exception:  # noqa: BLE001 - no spawn -> thread fallback
                return _pool
            if old is not None:
                old.shutdown()
        return _pool


def active_pool() -> Optional[VerifyProcPool]:
    return _pool


@atexit.register
def _shutdown_pool() -> None:
    pool = _pool
    if pool is not None:
        pool.shutdown()


def reset_for_tests() -> None:
    """Tear the shared pool down so a test can assert cold-start
    behavior (mirrors threadcpu.reset_for_tests)."""
    global _pool, _last_scrape
    with _pool_lock:
        if _pool is not None:
            _pool.shutdown()
        _pool = None
    _last_scrape = 0.0


# ------------------------------------------------------- verify plane


def verify_events_procs(events: List, workers: int) -> bool:
    """The procs-runtime verify plane: populate `_sig_ok` memos for
    `events` via the shared-memory process pool. Returns False when
    the pool is unavailable (caller falls back to the thread path);
    True when the memos were delivered under the exact thread-path
    contract — including drops + inline re-verify for chunks lost to
    a dead worker."""
    from multiprocessing import shared_memory

    from . import ingest

    pool = get_pool(workers)
    if pool is None:
        return False
    todo = [ev for ev in events if ev._sig_ok is None]
    if not todo:
        return True

    # Rows that cannot cross as fixed columns keep thread-path
    # semantics without a worker round trip: a creator that is not a
    # 65-byte point gets verdict None (memo unset -> insert raises at
    # the serial position); an r/s outside 32 bytes is an invalid
    # signature (False) exactly as `crypto.verify` reports it.
    rows: List = []
    packed: List[Tuple[bytes, bytes, bytes, bytes]] = []
    for ev in todo:
        creator = ev.body.creator
        if not isinstance(creator, (bytes, bytearray)) \
                or len(creator) != _PUB:
            continue  # memo stays unset: the None-verdict contract
        try:
            r = int(ev.r).to_bytes(32, "big")
            s = int(ev.s).to_bytes(32, "big")
        except (OverflowError, ValueError):
            ev._sig_ok = False
            continue
        rows.append(ev)
        packed.append((bytes(creator), ev.body.hash(), r, s))

    n = len(rows)
    if n == 0:
        return True

    inst = ingest._pool_instrument()
    po, do, so, vo = _offsets(n)
    try:
        shm = shared_memory.SharedMemory(
            create=True, size=vo + n)
    except Exception:  # noqa: BLE001 - no /dev/shm -> thread fallback
        return False
    _shm_track(vo + n)
    try:
        buf = shm.buf
        buf[0:4] = VERIFY_MAGIC
        struct.pack_into("<I", buf, 4, n)
        for k, (pub, dig, r, s) in enumerate(packed):
            buf[po + _PUB * k:po + _PUB * (k + 1)] = pub
            buf[do + _DIG * k:do + _DIG * (k + 1)] = dig
            off = so + _SIG * k
            buf[off:off + 32] = r
            buf[off + 32:off + 64] = s
            buf[vo + k] = 2

        k_chunks = min(pool.size, max(1, n // max(1, _min_chunk(n))))
        chunk = -(-n // k_chunks)  # ceil
        chunks = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
        t0 = time.monotonic()
        outcomes = pool.run_verify(shm.name, n, chunks)
        for (start, stop), (ok, t_start) in zip(chunks, outcomes):
            if ok:
                inst.observe_wait(max(0.0, (t_start or t0) - t0))
                for k in range(start, stop):
                    v = buf[vo + k]
                    if v == 0:
                        rows[k]._sig_ok = False
                    elif v == 1:
                        rows[k]._sig_ok = True
                    # 2 -> memo stays unset (None-verdict contract)
            else:
                # Worker died mid-chunk: the cancelled-chunk contract —
                # observe the queued wait, count the shed, verify
                # inline with identical memo semantics.
                inst.observe_wait(time.monotonic() - t0)
                inst.record_drop()
                ingest._verify_chunk(rows[start:stop])
    finally:
        buf = None
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        _shm_untrack(vo + n)
    return True


def _min_chunk(n: int) -> int:
    # Don't shard a small batch across every worker: below ~8 rows a
    # chunk's IPC round trip costs more than the ECDSA it parallelizes
    # (same constant as ingest._MIN_POOL_BATCH).
    return 8


# -------------------------------------------------------- decode plane


def decode_columnar(buf):
    """Columnar-frame decode for the procs runtime: large frames are
    validated on a worker (the frame crosses via shared memory, the
    integrity sweep runs off the parent's GIL) and re-viewed here with
    validation skipped; small frames and every fallback path decode
    inline. Raises WireFormatError exactly as the inline decode
    would."""
    from ..net.columnar import ColumnarEvents, WireFormatError

    pool = active_pool()
    if pool is None or len(buf) < _MIN_DECODE_BYTES:
        return ColumnarEvents.decode(buf)
    from multiprocessing import shared_memory

    try:
        shm = shared_memory.SharedMemory(create=True, size=len(buf))
    except Exception:  # noqa: BLE001
        return ColumnarEvents.decode(buf)
    _shm_track(len(buf))
    try:
        shm.buf[:len(buf)] = buf
        try:
            err = pool.run_decode(shm.name, len(buf))
        except _WorkerDied:
            return ColumnarEvents.decode(buf)
        if err is not None:
            raise WireFormatError(err)
        validated = bytes(shm.buf[:len(buf)])
    finally:
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        _shm_untrack(len(buf))
    return ColumnarEvents.decode(validated, validate=False)


# ------------------------------------------------------ telemetry scrape


def scrape_children(parent_registry) -> int:
    """Mirror worker registries into `parent_registry` (the /metrics
    refresh hook). Throttled like threadcpu.sample so several nodes
    refreshing at one scrape pay one pipe round per worker."""
    global _last_scrape
    pool = _pool
    if pool is None:
        return 0
    now = time.monotonic()
    if now - _last_scrape < _SCRAPE_MIN_INTERVAL:
        return 0
    _last_scrape = now
    return pool.scrape(parent_registry)
