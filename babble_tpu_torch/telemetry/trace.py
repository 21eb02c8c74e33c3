"""Bounded span ring buffer + Chrome trace-event export.

A SpanRing records the last N spans (monotonic start/end ns, a
category lane, and small key/value args: peer, batch size, outcome)
with one lock-protected deque append per span — cheap enough to leave
on in production. `/debug/trace` serves the ring as Chrome trace-event
JSON, which loads directly in Perfetto (ui.perfetto.dev) or
chrome://tracing: each node is a process row, each span category a
thread lane, so a sync arriving mid device-pass is visibly overlapped
— the timeline view the aggregate `phase_ns` totals cannot show
(docs/observability.md).

Beyond duration spans the ring also records **flow events** — the
sampled-transaction breadcrumbs (`ph` "s"/"t"/"f" in the Chrome
format) that link a tx's submit span to its gossip hops on other
nodes and finally its CommitBlock. Flow events are matched by `id`
across processes, so once N nodes' dumps are merged onto one epoch
(`telemetry.tracemerge`), Perfetto draws one arrow chain per sampled
transaction across the node rows.

Entries carry a monotonically increasing completion sequence (`seq`),
the cursor behind `/debug/trace?since=` — scrapers re-fetch only what
completed since their last poll instead of re-downloading the whole
ring.

Each span also carries its parent's id (`parent`, 0 for a root) and
the native id of the thread that ran it (`tid`), so a reader can take
a layer's self time: its duration less what its children cover. The
parent defaults to the innermost span open on the calling thread; work
done on another thread for the same caller (the engine's staging
thread for a dispatched pass) names its parent explicitly."""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional


class SpanRing:
    """Fixed-capacity ring of completed spans. capacity <= 0 disables
    recording entirely (span() still yields an attrs dict, so call
    sites never branch)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(0, capacity)
        self._spans: Optional[deque] = (
            deque(maxlen=self.capacity) if self.capacity else None)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        # Completion-order cursor (distinct from span ids, which are
        # assigned at span START: a long span started early can finish
        # after later-started ones, so an id-based cursor would skip
        # it; seq is assigned at record time and strictly orders the
        # ring).
        self._seq = itertools.count(1)
        self._last_seq = 0
        # Entries the bounded deque evicted to make room — the ring
        # used to lose spans silently; scrapers now see the loss as
        # babble_trace_dropped_total and in the dump's babble block.
        self._dropped = 0
        # Per thread, the ids of its open spans, innermost last.
        self._open = threading.local()

    def current(self) -> int:
        """Id of the innermost span open on the calling thread; 0 when
        none is open or the ring is disabled."""
        stack = getattr(self._open, "ids", None)
        return stack[-1] if stack else 0

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "node",
             parent: Optional[int] = None, **args):
        """Record one span around the body. Yields the args dict, so
        the body can attach outcome fields (`rec["outcome"] = ...`)
        that are only known at the end; the span's id is pre-assigned
        in `rec["span_id"]` so log lines emitted inside the span can
        carry it (`extra={"span_id": rec["span_id"]}` — the JSON log
        formatter lifts it). The parent is the innermost span open on
        this thread unless `parent` names one. Exceptions propagate;
        the span is recorded either way with outcome=error unless the
        body set its own."""
        rec = dict(args)
        if self._spans is None:
            yield rec
            return
        rec["span_id"] = span_id = next(self._ids)
        if parent is None:
            parent = self.current()
        stack = self._open.__dict__.setdefault("ids", [])
        stack.append(span_id)
        t0 = time.perf_counter_ns()
        try:
            yield rec
        except BaseException:
            rec.setdefault("outcome", "error")
            raise
        finally:
            stack.remove(span_id)
            self.record(name, t0, time.perf_counter_ns(), cat=cat,
                        parent=parent, **rec)

    def record(self, name: str, start_ns: int, end_ns: int,
               cat: str = "node", parent: Optional[int] = None,
               **args) -> int:
        """Append one completed span; returns its span id (0 when the
        ring is disabled) for log correlation. A pre-assigned
        `span_id` in args (the span() context manager's) is honored.
        `parent` defaults to the innermost span open on this thread."""
        if self._spans is None:
            return 0
        span_id = args.pop("span_id", None) or next(self._ids)
        entry = {
            "id": span_id,
            "name": name,
            "cat": cat,
            "t0": start_ns,
            "t1": end_ns,
            "parent": self.current() if parent is None else parent,
            "tid": threading.get_native_id(),
            "args": args,
        }
        with self._lock:
            if len(self._spans) == self.capacity:
                self._dropped += 1
            entry["seq"] = self._last_seq = next(self._seq)
            self._spans.append(entry)
        return span_id

    def flow(self, phase: str, flow_id: int, cat: str = "tx",
             name: str = "tx", **args) -> None:
        """Record one flow-event breadcrumb: phase "s" (start at the
        sampled tx's submit), "t" (step: a gossip hop, an engine
        pass), "f" (finish at CommitBlock). Emit from INSIDE the span
        the breadcrumb belongs to, so its timestamp falls within that
        slice and the renderer binds the arrow to it. Matched across
        node pids by `flow_id` after a tracemerge. No-op when the
        ring is disabled."""
        if self._spans is None:
            return
        entry = {
            "flow": phase,
            "fid": flow_id,
            "name": name,
            "cat": cat,
            "t0": time.perf_counter_ns(),
            "args": args,
        }
        with self._lock:
            if len(self._spans) == self.capacity:
                self._dropped += 1
            entry["seq"] = self._last_seq = next(self._seq)
            self._spans.append(entry)

    @property
    def dropped(self) -> int:
        """Entries evicted from the full ring before any scraper could
        fetch them (cumulative)."""
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans) if self._spans is not None else 0

    def snapshot(self, since_seq: int = 0) -> List[dict]:
        """Entries with seq > since_seq, oldest first (all of them at
        the default cursor 0)."""
        with self._lock:
            if self._spans is None:
                return []
            if since_seq <= 0:
                return list(self._spans)
            return [sp for sp in self._spans if sp["seq"] > since_seq]

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._last_seq

    def to_chrome_trace(self, pid: int = 0,
                        process_name: str = "babble-node",
                        rebase: Optional[Callable[[int], int]] = None,
                        since_seq: int = 0,
                        meta: Optional[Dict] = None) -> dict:
        """Chrome trace-event JSON object format: complete ("X")
        events in microseconds, one tid lane per span category, with
        process/thread name metadata so Perfetto labels the rows.

        `rebase` maps raw perf_counter ns onto an epoch (the node's
        ClusterClock for `?epoch=cluster`, or a profiler trace's
        timeline from `devclock.trace_rebase`); default is the raw
        monotonic domain. Flow entries render as ph "s"/"t"/"f" events
        on their category's lane. Extra context for tooling (the clock
        block tracemerge reads, the `next_since` cursor) rides in a
        top-level "babble" object — renderers ignore unknown keys."""
        spans = self.snapshot(since_seq)
        ts = (lambda t: rebase(t) / 1000.0) if rebase is not None \
            else (lambda t: t / 1000.0)
        lanes: Dict[str, int] = {}
        events: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"{process_name} {pid}"},
        }]

        def lane_of(cat: str) -> int:
            lane = lanes.get(cat)
            if lane is None:
                lane = len(lanes) + 1
                lanes[cat] = lane
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": lane, "args": {"name": cat},
                })
            return lane

        last = since_seq
        for sp in spans:
            last = max(last, sp["seq"])
            lane = lane_of(sp["cat"])
            if "flow" in sp:
                events.append({
                    "ph": sp["flow"],
                    "id": sp["fid"],
                    "name": sp["name"],
                    "cat": "tx",
                    "pid": pid,
                    "tid": lane,
                    "ts": ts(sp["t0"]),
                    "args": dict(sp["args"]),
                })
                continue
            events.append({
                "ph": "X",
                "name": sp["name"],
                "cat": sp["cat"],
                "pid": pid,
                "tid": lane,
                "ts": ts(sp["t0"]),
                "dur": (sp["t1"] - sp["t0"]) / 1000.0,
                "args": dict(sp["args"], span_id=sp["id"],
                             parent=sp["parent"], thread=sp["tid"]),
            })
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        babble = {"pid": pid, "next_since": last,
                  "dropped": self.dropped}
        if meta:
            babble.update(meta)
        out["babble"] = babble
        return out
