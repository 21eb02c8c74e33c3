"""Process-global metrics registry: counters, gauges, and fixed-bucket
log-scale histograms behind one `registry.counter/gauge/histogram(name,
**labels)` API.

Design (docs/observability.md):

- One instrument per (name, label-set). `Registry.counter(...)` is
  get-or-create, so call sites never coordinate — the node, the store,
  the transports, and the engine all grab their children independently
  and the scrape sees one coherent family per name.
- Lock-cheap: the registry lock is held only at child creation and
  scrape; the hot path (inc/observe) takes one tiny per-instrument
  lock. Plain `+=` under the GIL is NOT atomic across the
  read-modify-write, and gossip + RPC + consensus threads hit the same
  counters concurrently (test_telemetry.py pins the no-lost-updates
  guarantee).
- Histograms use fixed log-scale buckets (1-2.5-5 per decade), so two
  histograms of the same family merge by adding bucket counts —
  bench.py computes cross-node p50/p99 commit latency exactly that
  way, and /metrics renders the standard cumulative `_bucket{le=...}`
  exposition.
- Gauges can be computed: `gauge.set_fn(...)` makes the value a
  callback read at scrape time (breaker states, WAL size, backlog),
  so no background thread polls state that only scrapes need.

Ownership: components with no owning node (FileStore, the chaos
transport) record into the module-level process-global registry; each
Node owns a private Registry for its gossip/consensus/breaker series,
so a fresh node starts its counters at zero even in a long-lived test
process. `/metrics` serves `render_merged(global, node)` — one valid
exposition, no duplicate families."""

from __future__ import annotations

import threading
from bisect import bisect_left
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# Fixed log-scale latency ladder (seconds): 1-2.5-5 per decade from
# 100 us to 2 min. Decimal-exact bounds render cleanly in the text
# exposition and merge across any two histograms of a family.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005,
    0.01, 0.025, 0.05,
    0.1, 0.25, 0.5,
    1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0,
)


class Counter:
    """Monotonic counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Settable value, or a callback evaluated at scrape time."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Make the gauge computed: `fn` is called at every scrape.
        A raising callback reads as 0 rather than failing the scrape."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 - scrape must not die on state
            return 0.0


@dataclass(frozen=True)
class HistogramSnapshot:
    """Immutable histogram state: per-bucket (non-cumulative) counts
    with a final overflow bucket, plus sum/count. Snapshots subtract
    (delta over a measurement window) and merge (across nodes), which
    is how bench.py derives windowed cross-node quantiles from the
    process-global registry."""

    buckets: Tuple[float, ...]
    counts: Tuple[int, ...]  # len(buckets) + 1, the last is +Inf
    sum: float
    count: int

    def __sub__(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        if self.buckets != other.buckets:
            raise ValueError("bucket mismatch")
        return HistogramSnapshot(
            self.buckets,
            tuple(a - b for a, b in zip(self.counts, other.counts)),
            self.sum - other.sum,
            self.count - other.count,
        )

    def merge(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        if self.buckets != other.buckets:
            raise ValueError("bucket mismatch")
        return HistogramSnapshot(
            self.buckets,
            tuple(a + b for a, b in zip(self.counts, other.counts)),
            self.sum + other.sum,
            self.count + other.count,
        )

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile in [0, 1]. Values in the
        overflow bucket report the last finite bound (the histogram
        cannot see past it). Returns 0.0 on an empty snapshot."""
        if self.count <= 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c <= 0:
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * max(0.0, rank - cum) / c
            cum += c
        return self.buckets[-1]


class Histogram:
    """Fixed-bucket histogram (upper-bound buckets + overflow)."""

    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self._lock = threading.Lock()
        self._buckets = b
        self._counts = [0] * (len(b) + 1)
        self._sum = 0.0
        self._count = 0

    @property
    def buckets(self) -> Tuple[float, ...]:
        return self._buckets

    def observe(self, value: float) -> None:
        i = bisect_left(self._buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return HistogramSnapshot(
                self._buckets, tuple(self._counts), self._sum, self._count)

    def quantile(self, q: float) -> float:
        return self.snapshot().quantile(q)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

LabelKey = Tuple[Tuple[str, str], ...]


class _Family:
    __slots__ = ("name", "type", "help", "buckets", "children")

    def __init__(self, name: str, type_: str, help_: str,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.type = type_
        self.help = help_
        self.buckets = buckets
        self.children: Dict[LabelKey, object] = {}


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    # Integers render bare (Prometheus style); floats use repr, which
    # round-trips.
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Registry:
    """Name -> typed family -> per-label-set child instruments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- instrument access (get-or-create) -----------------------------

    def _child(self, name: str, type_: str, help_: str,
               labels: Dict[str, object],
               buckets: Optional[Iterable[float]] = None):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(
                    name, type_, help_,
                    tuple(buckets) if buckets is not None else None)
                self._families[name] = fam
            elif fam.type != type_:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.type}")
            child = fam.children.get(key)
            if child is None:
                if type_ == "histogram":
                    child = Histogram(fam.buckets or DEFAULT_BUCKETS)
                else:
                    child = _TYPES[type_]()
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._child(name, "histogram", help, labels, buckets)

    # -- programmatic reads --------------------------------------------

    def collect(self) -> Dict[str, List[Tuple[Dict[str, str], object]]]:
        """name -> [(labels, Counter|Gauge|Histogram child)] snapshot."""
        with self._lock:
            return {
                name: [(dict(key), child)
                       for key, child in fam.children.items()]
                for name, fam in self._families.items()
            }

    def merged_histogram(self, name: str) -> Optional[HistogramSnapshot]:
        """All of a histogram family's children merged into one
        snapshot (None when the family has no observations yet)."""
        with self._lock:
            fam = self._families.get(name)
            children = list(fam.children.values()) if fam else []
        snap: Optional[HistogramSnapshot] = None
        for child in children:
            s = child.snapshot()
            snap = s if snap is None else snap.merge(s)
        return snap

    # -- Prometheus text exposition ------------------------------------

    def _snapshot_families(self):
        with self._lock:
            return {
                name: (fam.type, fam.help, list(fam.children.items()))
                for name, fam in self._families.items()
            }

    def render(self) -> str:
        """Text exposition format 0.0.4 (the format every Prometheus
        scraper and `promtool check metrics` understands)."""
        return render_merged(self)


def _sample(name: str, key, value: float) -> str:
    if key:
        labels = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
        return f"{name}{{{labels}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def _render_histogram(out: List[str], name: str, key: LabelKey,
                      snap: HistogramSnapshot) -> None:
    cum = 0
    for bound, c in zip(snap.buckets, snap.counts):
        cum += c
        out.append(_sample(f"{name}_bucket",
                           key + (("le", _fmt(bound)),), cum))
    out.append(_sample(f"{name}_bucket",
                       key + (("le", "+Inf"),), snap.count))
    out.append(_sample(f"{name}_sum", key, snap.sum))
    out.append(_sample(f"{name}_count", key, snap.count))


def render_merged(*registries: Registry) -> str:
    """One valid exposition from several registries: a family present
    in more than one (same name => same type required) renders ONCE,
    with the later registry winning on identical label sets. The
    service merges the process-global registry (store, transports)
    with the scraped node's own (gossip, consensus, breaker) this
    way — a duplicate `# TYPE` line would be an invalid scrape."""
    merged: Dict[str, Tuple[str, str, Dict[LabelKey, object]]] = {}
    for reg in registries:
        for name, (type_, help_, children) in \
                reg._snapshot_families().items():
            if name in merged:
                prev_type, prev_help, prev_children = merged[name]
                if prev_type != type_:
                    raise ValueError(
                        f"metric {name!r} is {prev_type} in one registry"
                        f" and {type_} in another")
                prev_children.update(children)
                merged[name] = (prev_type, prev_help or help_,
                                prev_children)
            else:
                merged[name] = (type_, help_, dict(children))
    out: List[str] = []
    for name in sorted(merged):
        type_, help_, children = merged[name]
        if help_:
            out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {type_}")
        for key in sorted(children):
            child = children[key]
            if type_ == "histogram":
                _render_histogram(out, name, key, child.snapshot())
            else:
                out.append(_sample(name, key, child.value))
    return "\n".join(out) + "\n" if out else ""


def export_state(registry: Registry) -> List[tuple]:
    """Plain-data snapshot of a registry, picklable across a process
    boundary: [(name, type, help, label_key, payload)] where payload is
    a float (counter/gauge — computed gauges are evaluated here, in
    the owning process) or (buckets, counts, sum, count) for a
    histogram. The procs runtime's workers answer telemetry scrapes
    with this (docs/runtime.md "Cross-process scrape")."""
    out: List[tuple] = []
    for name, (type_, help_, children) in \
            registry._snapshot_families().items():
        for key, child in children:
            if type_ == "histogram":
                s = child.snapshot()
                payload = (s.buckets, s.counts, s.sum, s.count)
            else:
                payload = float(child.value)
            out.append((name, type_, help_, key, payload))
    return out


def absorb_state(dst: Registry, state: List[tuple],
                 **extra_labels) -> None:
    """Mirror an `export_state` snapshot into `dst`, adding
    `extra_labels` (e.g. process="verify-0") to every child so the
    mirrored series never collide with the destination's own. Mirrors
    REPLACE: each scrape overwrites the child with the worker's current
    state, so re-scraping is idempotent — and a restarted worker's
    series reset to zero, exactly like any real per-process
    collector's."""
    for name, type_, help_, key, payload in state:
        labels = dict(key)
        labels.update(extra_labels)
        if type_ == "counter":
            c = dst.counter(name, help_, **labels)
            with c._lock:
                c._value = float(payload)
        elif type_ == "gauge":
            dst.gauge(name, help_, **labels).set(float(payload))
        elif type_ == "histogram":
            buckets, counts, sum_, count = payload
            h = dst.histogram(name, help_, buckets=buckets, **labels)
            with h._lock:
                h._counts = list(counts)
                h._sum = float(sum_)
                h._count = int(count)


_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-global default registry (what /metrics serves)."""
    return _REGISTRY
