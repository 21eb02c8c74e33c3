"""Capacity observatory (docs/observability.md "Capacity").

The measurement plane for the ROADMAP state-lifecycle item ("the event
log and WAL grow without bound") and the sharded-device northstar:
what grows, how fast, and how long until a budget is hit — before the
checkpoint/compaction PR spends anything on folding history.

Three layers, all scrape-time (nothing here polls in the background):

1. **Process view**: RSS / peak RSS parsed from ``/proc/self/status``
   (``resource.getrusage`` fallback off-Linux) and a GC snapshot —
   the ground truth every per-subsystem estimate is reconciled
   against.
2. **Sizers**: cheap retained-byte estimates for the containers that
   actually grow (event caches, memo tables, rolling windows, push
   buffers). Estimates sample a bounded number of entries
   (``sampled_bytes``) so a 100k-event cache costs O(256) per scrape,
   not O(cache).
3. **Growth model**: ``GrowthTracker`` keeps a bounded window of
   (committed-block, bytes) samples per series and fits a linear
   slope — bytes per committed block — plus a time-to-budget
   projection. Samples are appended by the scrape itself, so the
   model runs exactly as often as someone is looking.

Everything is behind ``Config.capacity`` (``--no_capacity``); the
bench A/B (``bench.py --capacity-overhead``) pins the on/off delta
under the repo's standard 5% bar.
"""

from __future__ import annotations

import gc
import os
from collections import deque
from itertools import islice
from typing import Dict, Iterable, Optional

# ---------------------------------------------------------------- process

_PAGE = 4096


def process_memory() -> Dict[str, int]:
    """RSS and peak RSS in bytes. Linux reads /proc/self/status
    (VmRSS/VmHWM, kB); elsewhere falls back to getrusage (ru_maxrss,
    which only gives the peak — rss then mirrors it)."""
    out = {"rss_bytes": 0, "rss_peak_bytes": 0}
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    out["rss_bytes"] = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    out["rss_peak_bytes"] = int(line.split()[1]) * 1024
        return out
    except OSError:
        pass
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports kB, macOS bytes; off-Linux we only hit this
        # path on macOS/BSD where it is bytes.
        out["rss_bytes"] = out["rss_peak_bytes"] = int(peak)
    except Exception:  # noqa: BLE001 - capacity must never raise
        pass
    return out


def gc_snapshot() -> Dict[str, object]:
    """Collector pressure: tracked objects, per-generation counts and
    cumulative collections/collected — a leak of *objects* (vs bytes)
    shows here first."""
    counts = gc.get_count()
    stats = gc.get_stats()
    return {
        # Deliberately NOT len(gc.get_objects()): that materializes a
        # list of every tracked object — O(heap) per scrape. The
        # per-generation allocation counters are the cheap signal.
        "gen_counts": list(counts),
        "collections": [s.get("collections", 0) for s in stats],
        "collected": [s.get("collected", 0) for s in stats],
        "uncollectable": [s.get("uncollectable", 0) for s in stats],
    }


def gc_collections_total() -> int:
    return sum(s.get("collections", 0) for s in gc.get_stats())


def mem_budget_bytes() -> int:
    """The default RSS budget for time-to-budget projections: cgroup
    v2 memory.max when bounded, else MemTotal. 0 when neither is
    readable (projection then disabled)."""
    try:
        with open("/sys/fs/cgroup/memory.max") as fh:
            raw = fh.read().strip()
        if raw != "max":
            return int(raw)
    except (OSError, ValueError):
        pass
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError):
        pass
    return 0


# ----------------------------------------------------------------- sizers

# CPython fixed-cost guesses for container bookkeeping: close enough
# for attribution and trend fitting (the plane ranks growers and fits
# slopes; it does not bill by the byte — RSS is the ground truth).
DICT_ENTRY_BYTES = 104   # key ptr + value ptr + hash + dict slack
OBJ_BASE_BYTES = 56      # PyObject header + dict ptr
EVENT_BASE_BYTES = 640   # Event + EventBody objects, wire ints, coords


def str_bytes(s: Optional[str]) -> int:
    return 49 + len(s) if s else 0


def bytes_bytes(b: Optional[bytes]) -> int:
    return 33 + len(b) if b else 0


def event_bytes(ev) -> int:
    """Retained-byte estimate of one Event: object overhead, payload
    transactions, memoized encodings/digests, ancestry vectors. Never
    raises (sizers run inside a /metrics scrape)."""
    try:
        total = EVENT_BASE_BYTES
        body = getattr(ev, "body", None)
        if body is not None:
            for tx in getattr(body, "transactions", None) or ():
                total += bytes_bytes(tx) + 8
            total += str_bytes(getattr(body, "_marshal_str", None))
            total += bytes_bytes(getattr(body, "_marshal", None))
            total += bytes_bytes(getattr(body, "_hash", None))
        total += str_bytes(getattr(ev, "_marshal_str", None))
        total += bytes_bytes(getattr(ev, "_marshal", None))
        total += bytes_bytes(getattr(ev, "_hash", None))
        total += str_bytes(getattr(ev, "_hex", None))
        la = getattr(ev, "last_ancestors", None)
        if la:
            # EventCoordinates: slotted (hash str + int) per participant.
            total += len(la) * 120
        fw = getattr(ev, "first_descendants", None)
        if fw:
            total += len(fw) * 120
        wire = getattr(ev, "_wire", None)
        if wire is not None:
            total += 256
        return total
    except Exception:  # noqa: BLE001
        return EVENT_BASE_BYTES


def sampled_bytes(values: Iterable, count: int, sizer,
                  sample: int = 256) -> int:
    """Estimate total retained bytes of `count` entries by sizing at
    most `sample` of them and scaling: keeps a 100k-entry cache's
    scrape cost O(sample). Exact when count <= sample."""
    if count <= 0:
        return 0
    seen = 0
    acc = 0
    # Copy the entries out in one call before sizing any: the caches
    # are written by other threads while a scrape runs, and an iterator
    # held across the sizer's Python code raises "OrderedDict mutated
    # during iteration" (one list() of a dict view runs without a
    # thread switch; islice() then list() could switch in between).
    for v in islice(list(values), sample):
        acc += sizer(v)
        seen += 1
    if seen == 0:
        return 0
    if seen >= count:
        return acc
    return int(acc / seen * count)


# ----------------------------------------------------------- growth model


class GrowthTracker:
    """Windowed linear growth fit per series: observe (x, y) samples —
    x is the commit clock (committed blocks) or wall seconds, y is a
    byte count — and answer `slope` (bytes per x-unit, least squares
    over the window) and `to_budget` (x-units until y reaches a
    budget at the current slope). Bounded: at most `window` samples
    per series, at most `max_series` series (a label leak in a caller
    cannot grow the tracker itself without bound)."""

    def __init__(self, window: int = 64, max_series: int = 32):
        self.window = max(2, window)
        self.max_series = max_series
        self._series: Dict[str, deque] = {}

    def observe(self, series: str, x: float, y: float) -> None:
        pts = self._series.get(series)
        if pts is None:
            if len(self._series) >= self.max_series:
                return
            pts = self._series[series] = deque(maxlen=self.window)
        if pts and pts[-1][0] == x:
            # Same commit tick (scrape faster than blocks decide):
            # keep the freshest reading for that x.
            pts[-1] = (x, y)
            return
        pts.append((float(x), float(y)))

    def slope(self, series: str) -> Optional[float]:
        """Least-squares dy/dx over the window; None until two
        distinct x samples exist."""
        pts = self._series.get(series)
        if not pts or len(pts) < 2:
            return None
        n = len(pts)
        sx = sum(p[0] for p in pts)
        sy = sum(p[1] for p in pts)
        sxx = sum(p[0] * p[0] for p in pts)
        sxy = sum(p[0] * p[1] for p in pts)
        denom = n * sxx - sx * sx
        if denom == 0:
            return None
        return (n * sxy - sx * sy) / denom

    def last(self, series: str) -> Optional[float]:
        pts = self._series.get(series)
        return pts[-1][1] if pts else None

    def slopes(self) -> Dict[str, Optional[float]]:
        return {s: self.slope(s) for s in self._series}

    def to_budget(self, series: str, budget: float) -> Optional[float]:
        """x-units (blocks) until this series reaches `budget` at the
        current slope; None when not growing or already unknown."""
        sl = self.slope(series)
        cur = self.last(series)
        if sl is None or cur is None or sl <= 0:
            return None
        if budget <= cur:
            return 0.0
        return (budget - cur) / sl

    def series(self):
        return list(self._series)


# ------------------------------------------------------ cardinality audit


def series_counts(*registries) -> Dict[str, int]:
    """Series-per-family across the given registries — the
    label-cardinality self-audit behind babble_telemetry_series and
    `promtext --max-series`. One registry child = one exposition
    series for counters/gauges; a histogram child expands to
    buckets+2 rows on the wire, but the leak the audit exists to
    catch is *children* (label sets), so children are what it
    counts."""
    out: Dict[str, int] = {}
    for reg in registries:
        for name, children in reg.collect().items():
            out[name] = out.get(name, 0) + len(children)
    return out
