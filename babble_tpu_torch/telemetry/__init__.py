"""Unified telemetry (docs/observability.md): a process-global metrics
registry (counters / gauges / log-scale histograms) serving `GET
/metrics` in Prometheus text format, a bounded span ring exported at
`/debug/trace` as Perfetto-loadable Chrome trace JSON, a scrape
parser/checker, structured JSON logging, and the saturation plane —
instrumented queues, per-thread CPU attribution, and the sampling
flame profiler behind `/debug/flame`."""

from .clock import ClusterClock
from .jsonlog import JsonLogFormatter, use_json_logging
from .profiler import StackSampler
from .queues import InstrumentedQueue, QueueInstrument
from .registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    HistogramSnapshot,
    Registry,
    get_registry,
    render_merged,
)
from .trace import SpanRing

__all__ = [
    "ClusterClock",
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "InstrumentedQueue",
    "JsonLogFormatter",
    "QueueInstrument",
    "Registry",
    "SpanRing",
    "StackSampler",
    "get_registry",
    "render_merged",
    "use_json_logging",
]
