"""Per-thread CPU attribution (docs/observability.md "Saturation").

`sample(registry)` refreshes, at scrape time:

- `babble_thread_cpu_seconds_total{thread}` — cumulative CPU seconds
  per *named* thread, read cross-thread via
  `time.pthread_getcpuclockid(ident)` + `time.clock_gettime` (the
  POSIX per-thread CPU clock; no per-sample cost on the measured
  threads, no signal handlers). Counters advance by the delta since
  the previous sample, so threads that share a name (a worker pool)
  sum into one series and a thread's total survives its exit.
- `babble_cpu_utilization_cores` — process CPU seconds per wall
  second over the sampling window (how many cores the process is
  actually burning), via the portable `time.process_time()`.
- `babble_cpu_saturation_ratio` — utilization / `os.cpu_count()`:
  ≥ 1.0 means the process wants more cores than the host has, the
  measured form of "CPU-oversubscribed".

Sampling is process-global and throttled (several nodes in one test
process refresh at the same scrape; only the first caller inside the
window pays), and degrades gracefully where the POSIX clocks are
missing: the process gauges stay, the per-thread family is absent.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

from .registry import Registry

_T_HELP = "Cumulative CPU seconds consumed per named thread"
_U_HELP = "Process CPU cores in use over the last sampling window"
_S_HELP = "Process CPU utilization as a share of available cores"

# POSIX per-thread CPU clocks (Linux/glibc CPython; absent on some
# platforms — hasattr-gated, never assumed).
_HAVE_THREAD_CLOCKS = (
    hasattr(time, "pthread_getcpuclockid")
    and hasattr(time, "clock_gettime"))

_MIN_INTERVAL_S = 0.2

_lock = threading.Lock()
_last_cpu_by_tid: Dict[int, float] = {}
_last_wall = 0.0
_last_proc_cpu = 0.0
_have_window = False


def supported() -> bool:
    """True when per-thread CPU clocks are available on this host."""
    return _HAVE_THREAD_CLOCKS


def _thread_cpu(ident: int) -> float:
    clk = time.pthread_getcpuclockid(ident)
    return time.clock_gettime(clk)


def sample(registry: Registry) -> None:
    """Refresh the thread-CPU counters and process utilization gauges
    in `registry` (call at scrape; throttled internally)."""
    global _last_wall, _last_proc_cpu, _have_window
    with _lock:
        now = time.monotonic()
        if _have_window and (now - _last_wall) < _MIN_INTERVAL_S:
            return
        proc_cpu = time.process_time()
        if _have_window:
            dwall = now - _last_wall
            dcpu = proc_cpu - _last_proc_cpu
            util = max(0.0, dcpu / dwall) if dwall > 0 else 0.0
            registry.gauge(
                "babble_cpu_utilization_cores", _U_HELP).set(util)
            registry.gauge(
                "babble_cpu_saturation_ratio", _S_HELP).set(
                    util / max(1, os.cpu_count() or 1))
        else:
            # First sample: no window yet — create the gauges at 0 so
            # the families exist in the very first scrape.
            registry.gauge("babble_cpu_utilization_cores", _U_HELP)
            registry.gauge("babble_cpu_saturation_ratio", _S_HELP)
        _last_wall = now
        _last_proc_cpu = proc_cpu
        _have_window = True

        if not _HAVE_THREAD_CLOCKS:
            return
        live: Dict[int, float] = {}
        for t in threading.enumerate():
            ident = t.ident
            if ident is None:
                continue
            try:
                cpu = _thread_cpu(ident)
            except (OSError, ValueError, OverflowError):
                continue  # thread exited between enumerate and read
            live[ident] = cpu
            prev = _last_cpu_by_tid.get(ident)
            # An ident can be recycled by the OS; a shrinking clock
            # means a new thread — attribute its full total.
            delta = cpu - prev if prev is not None and cpu >= prev \
                else cpu
            if delta > 0:
                registry.counter(
                    "babble_thread_cpu_seconds_total", _T_HELP,
                    thread=t.name).inc(delta)
        # Forget exited threads so a recycled ident starts fresh.
        _last_cpu_by_tid.clear()
        _last_cpu_by_tid.update(live)


def reset_for_tests() -> None:
    """Drop the sampling window (tests that swap registries)."""
    global _have_window
    with _lock:
        _last_cpu_by_tid.clear()
        _have_window = False
