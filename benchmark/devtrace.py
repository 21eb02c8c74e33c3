"""The device trace of a traced run: torch.profiler over CUDA activity
only, kept in memory, reduced to busy time, device time by kernel and
the idle gaps named by the host span open at the time.

Host spans are (name, start_ns, end_ns) on `time.time_ns()`. The trace's
clock is tied to it by a marker: a spin kernel launched right after a
synchronise at a known host time.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

MARK_CYCLES = 20_000


class HostSpans:
    """Spans the benchmark records around its calls into the program.
    Nested spans are fine: a gap is named by the innermost span."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []
        self.on = False

    def wrap(self, name: str, fn):
        def inner(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((name, t0, time.time_ns()))
        return inner


class DeviceTrace:
    """torch.profiler over the device's activity; on the CPU (the tests)
    it traces host activity and finds no device activity."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.t0_ns = 0
        self.t1_ns = 0
        self.mark_ns = 0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[
            ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
        self.prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
            self.mark_ns = time.time_ns()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        self.t0_ns = time.time_ns()

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)

    def kernels(self) -> List[Tuple[str, int, int]]:
        """(name, start_ns, end_ns) of every device activity, on the
        host's clock."""
        raw = []
        try:
            evs = self.prof.profiler.kineto_results.events()
            for ev in evs:
                if ev.device_type().name != "CUDA":
                    continue
                s = ev.start_ns()
                raw.append((ev.name(), s, s + ev.duration_ns()))
        except AttributeError:
            from torch.autograd import DeviceType

            for ev in self.prof.events():
                if ev.device_type == DeviceType.CUDA:
                    raw.append((ev.name, int(ev.time_range.start * 1000),
                                int(ev.time_range.end * 1000)))
        marks = [k for k in raw if "spin" in k[0] or "sleep" in k[0]]
        offset = (min(k[1] for k in marks) - self.mark_ns) if marks else 0
        return [(name, s - offset, e - offset) for name, s, e in raw
                if not ("spin" in name or "sleep" in name)]


def _union(intervals):
    """Merged, sorted busy intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(trace: DeviceTrace, spans: List[Tuple[str, int, int]]) -> Dict:
    """busy_s, window_s, device time by kernel name, and the idle time of
    the window by the innermost host span open at each gap's middle."""
    t0, t1 = trace.t0_ns, trace.t1_ns
    kern = [(n, max(s, t0), min(e, t1)) for n, s, e in trace.kernels()
            if e > t0 and s < t1]
    busy = _union((s, e) for _, s, e in kern)
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, List[float]] = {}
    for name, s, e in kern:
        ent = by_name.setdefault(name, [0.0, 0])
        ent[0] += (e - s) * 1e-9
        ent[1] += 1
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    spans = sorted(spans, key=lambda x: x[1])
    starts = [sp[1] for sp in spans]
    idle: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        inner: Optional[Tuple[str, int, int]] = None
        # the latest-started span still open at mid is the innermost
        for k in range(bisect.bisect_right(starts, mid) - 1,
                       max(bisect.bisect_right(starts, mid) - 256, 0) - 1, -1):
            if spans[k][2] >= mid:
                inner = spans[k]
                break
        key = "host:" + (inner[0] if inner else "other")
        idle[key] = idle.get(key, 0.0) + (ge - gs) * 1e-9
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": (t1 - t0) * 1e-9,
        "by_name": by_name,
        "device_ops": [[n[:120], v[0]] for n, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]],
        "idle_gaps": [[k, v] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def kernel_time_s(summary: Dict, needle: str) -> float:
    return sum(v[0] for k, v in summary["by_name"].items() if needle in k)
