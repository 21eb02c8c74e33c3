"""The device's clock: span stamps on a torch.profiler trace's timeline
(babble_tpu_torch/TRACING.md "Spans on the device's timeline").

A SpanRing stamps with `time.perf_counter_ns()`; torch.profiler stamps
host and device activity on its own clock (Unix-epoch ns in
`kineto_results`, microseconds after the export's `baseTimeNanoseconds`
in the exported Chrome trace). The two are tied by a marker, as the
benchmark's device trace ties them: a synchronise, a host stamp, a
marker kernel (`torch.cuda._sleep`), a synchronise and a second host
stamp. The marker ran inside the host interval, so the interval's
midpoint pairs with the marker's own midpoint on the trace; the error
is half the difference between the launch latency and the return of
the synchronise, a few microseconds.

    device_mark()                  # once before profiling: loads the kernel
    with torch.profiler.profile(activities=[...CUDA]) as prof:
        device_mark()              # the profile's first launch: slow, unused
        host = [device_mark()]
        ...                        # the traced work; spans on the ring
        host.append(device_mark())
    to_trace = trace_rebase(anchors(host, profiler_marks(prof)[1:]))
    ring.to_chrome_trace(rebase=to_trace)   # or to_trace(span["t0"])
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

__all__ = ["MARK_CYCLES", "anchors", "device_mark", "is_marker",
           "profiler_marks", "trace_rebase"]

# Spin cycles of one marker kernel: a few microseconds on an H100, long
# enough to show on the trace, short against the work it brackets.
MARK_CYCLES = 20_000


def is_marker(name: str) -> bool:
    """True for the kernel `torch.cuda._sleep` launches."""
    return "spin" in name or "sleep" in name


def device_mark(device=None) -> Tuple[int, int]:
    """Enqueue one marker kernel between two synchronises of `device`;
    return the perf_counter_ns stamps (before, after) that bracket it.
    The first call of a process loads the kernel, and the first launch
    inside a profile waits for the profiler (0.2-1.4 ms on an H100), so
    make one mark before the profile and one inside it that no anchor
    uses: a slow launch makes its anchor loose."""
    import torch

    torch.cuda.synchronize(device)
    before = time.perf_counter_ns()
    torch.cuda._sleep(MARK_CYCLES)
    torch.cuda.synchronize(device)
    return before, time.perf_counter_ns()


def profiler_marks(prof) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of every marker kernel of a finished
    torch.profiler profile, on the profiler's clock, oldest first."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name == "CUDA" and is_marker(ev.name()):
            s = ev.start_ns()
            out.append((s, s + ev.duration_ns()))
    return sorted(out)


def anchors(host: Sequence[Tuple[int, int]],
            trace: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Anchor pairs (host_ns, trace_ns) from device_mark() intervals and
    the markers found on the trace, matched in order: the midpoint of
    each host interval with the midpoint of its marker."""
    if len(host) != len(trace):
        raise ValueError(f"{len(host)} host marks but {len(trace)} on the trace")
    return [((h0 + h1) // 2, (s + e) // 2)
            for (h0, h1), (s, e) in zip(host, trace)]


def trace_rebase(pairs: Sequence[Tuple[int, int]],
                 base_ns: int = 0) -> Callable[[int], int]:
    """The map from perf_counter_ns onto a profiler trace's clock, less
    `base_ns` (an exported trace's `baseTimeNanoseconds`), from anchor
    pairs (host_ns, trace_ns). One pair gives an offset; more give the
    line through the first and the last, which takes out the drift
    between the two clocks over the window they span."""
    if not pairs:
        raise ValueError("no anchor pairs")
    (h0, d0), (h1, d1) = pairs[0], pairs[-1]
    if h1 == h0:
        off = d0 - h0 - base_ns
        return lambda t: t + off
    slope = (d1 - d0) / (h1 - h0)
    return lambda t: d0 - base_ns + round((t - h0) * slope)
