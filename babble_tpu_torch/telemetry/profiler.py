"""In-process sampling profiler (docs/observability.md "Saturation").

A wall-clock stack sampler over `sys._current_frames()`: every tick it
snapshots the Python stack of every live thread and folds each into a
`thread;file:func;file:func` line (root first, leaf last — the folded
format speedscope and flamegraph.pl load directly). Samples land in a
bounded ring; `GET /debug/flame?seconds=N` renders the last N seconds
as `<folded stack> <count>` text.

Off by default (`Config.profile_hz = 0`): nothing is started, nothing
is sampled, the hot path is untouched — a strict no-op. When on, one
*process-global* sampler serves every node in the process (refcounted
acquire/release), so an in-process testnet pays for one sampler, not
n. The sampler never suspends threads and holds no foreign locks —
`sys._current_frames()` is a point-in-time read under the GIL — so
the only cost is the sampler thread's own work, measured under the
standing 5% bar by `bench.py --profile-overhead`.

With no sampler running, the endpoint falls back to an on-demand
burst (`burst_folded`): sample inline for the requested window and
return the aggregate — flame-on-demand without paying a standing
sampling cost."""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

_MAX_DEPTH = 64  # frames kept per stack (deeper stacks truncate at root)

# Sampling runs at up to ~100 Hz on the same cores it observes, so the
# hot path memoizes what repeats across ticks: per-code labels (code
# objects are stable for the process lifetime) and whole folded lines
# keyed by (thread name, stack shape) — blocked threads resample the
# identical stack for seconds at a time. The tid→name map is rebuilt
# per tick: idents are reused by the OS, so caching it misnames new
# threads.
_code_label: Dict[object, str] = {}
_line_cache: Dict[tuple, str] = {}


def _fold_current(skip: Iterable[int] = ()) -> Tuple[str, ...]:
    """One sample: every live thread's stack as a folded line."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in frames.items():
        if tid in skip:
            continue
        codes = []
        f = frame
        while f is not None and len(codes) < _MAX_DEPTH:
            codes.append(f.f_code)
            f = f.f_back
        name = names.get(tid) or f"tid-{tid}"
        key = (name, tuple(codes))
        line = _line_cache.get(key)
        if line is None:
            parts = []
            for code in reversed(codes):
                lbl = _code_label.get(code)
                if lbl is None:
                    lbl = (os.path.basename(code.co_filename)
                           + ":" + code.co_name)
                    _code_label[code] = lbl
                parts.append(lbl)
            line = name + ";" + ";".join(parts)
            if len(_line_cache) > 8192:
                _line_cache.clear()
            _line_cache[key] = line
        out.append(line)
    return tuple(out)


def render_folded(samples: Iterable[Tuple[str, ...]]) -> str:
    """Aggregate per-tick samples into `<stack> <count>` lines."""
    counts: "collections.Counter[str]" = collections.Counter()
    for sample in samples:
        counts.update(sample)
    return "".join(
        f"{stack} {n}\n" for stack, n in sorted(counts.items()))


def burst_folded(seconds: float, hz: float = 99.0) -> str:
    """Sample inline (on the calling thread) for `seconds` and return
    the folded aggregate — the no-standing-sampler fallback behind
    /debug/flame."""
    interval = 1.0 / max(1.0, hz)
    deadline = time.monotonic() + max(0.0, seconds)
    me = threading.get_ident()
    samples = []
    while True:
        samples.append(_fold_current(skip=(me,)))
        now = time.monotonic()
        if now >= deadline:
            break
        time.sleep(min(interval, deadline - now))
    return render_folded(samples)


class StackSampler:
    """Background sampler at a fixed rate into a bounded ring of
    (monotonic_ts, folded-stack tuple) samples."""

    def __init__(self, hz: float, ring: int = 8192):
        self.hz = max(1.0, float(hz))
        self._interval = 1.0 / self.hz
        self._ring: "collections.deque" = collections.deque(maxlen=ring)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="babble-profiler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=2.0)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self._interval):
            self._ring.append((time.monotonic(), _fold_current(skip=(me,))))

    def folded(self, seconds: float) -> str:
        """The last `seconds` of the ring as folded-stack text."""
        cutoff = time.monotonic() - max(0.0, seconds)
        samples = [s for ts, s in list(self._ring) if ts >= cutoff]
        return render_folded(samples)


# -- process-global refcounted sampler (one per process, any nodes) ----

_lock = threading.Lock()
_sampler: Optional[StackSampler] = None
_refs = 0


def acquire(hz: float) -> StackSampler:
    """Start (or share) the process sampler. The first acquire fixes
    the rate; later acquires at a different hz share the running
    sampler rather than perturbing it."""
    global _sampler, _refs
    with _lock:
        if _sampler is None:
            _sampler = StackSampler(hz)
            _sampler.start()
        _refs += 1
        return _sampler


def release() -> None:
    """Drop one reference; the sampler stops at zero."""
    global _sampler, _refs
    with _lock:
        if _refs <= 0:
            return
        _refs -= 1
        if _refs == 0 and _sampler is not None:
            _sampler.stop()
            _sampler = None


def active() -> Optional[StackSampler]:
    """The running process sampler, if any."""
    with _lock:
        return _sampler
