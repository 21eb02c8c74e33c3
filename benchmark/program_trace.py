"""A traced run of one cell read through the program's own spans.

    python3 benchmark/program_trace.py --workload <name> --seed <n> --seconds <s>

Runs the cell as `run.py --trace 1` does, with every span ring of the
program (each Core's, each Node's) made large enough that nothing of
the traced window is dropped, and two device markers that map the
rings' perf_counter stamps onto the device trace's clock
(babble_tpu_torch/telemetry/devclock.py). Prints one JSON line: the
cell's per-layer metrics and end-to-end metrics read from the same
record, `idle_by_program_span` (the window's idle time named by the
innermost program span open on each thread at each gap's middle), the
share of idle time in no program span, the rings' dropped count, and
readings taken from the spans of the window (verify's prelude per
signature, window tables per verify call, the staging thread's pass).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from devtrace import _union

HERE = Path(__file__).resolve().parent
RING = 1 << 21  # spans a ring keeps: far above a traced window's


def _innermost(spans: Sequence[Tuple[str, int, int]], mids: Sequence[int]) -> List:
    """For each of the ascending `mids`, the name of the innermost of one
    thread's spans (name, start, end) open there, or None."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, i = [], [], 0
    for m in mids:
        while i < len(spans) and spans[i][1] <= m:
            sp = spans[i]
            i += 1
            while stack and stack[-1][2] < sp[1]:
                stack.pop()
            stack.append(sp)
        while stack and stack[-1][2] < m:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def idle_by_program_span(kernels: Sequence[Tuple[str, int, int]], t0: int, t1: int,
                         spans: Sequence[Tuple[str, int, int, int]],
                         top: int = 12) -> Dict:
    """The idle time of the window [t0, t1] (no kernel of `kernels`,
    (name, start, end), running) by program span: each gap is named by
    the innermost span open at its middle on each thread, the names
    joined by " + " ("none" where no thread has one open). `spans` are
    (name, thread id, start, end), on the kernels' clock. Returns the
    largest `top` names with their seconds (the rest summed under
    "rest", so the list sums to the idle time), the idle seconds and
    the seconds in no span."""
    busy = _union((max(s, t0), min(e, t1)) for _, s, e in kernels if e > t0 and s < t1)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    mids = [(s + e) // 2 for s, e in gaps]
    by_thread: Dict[int, list] = {}
    for name, tid, s, e in spans:
        by_thread.setdefault(tid, []).append((name, s, e))
    names = [set() for _ in gaps]
    for sp in by_thread.values():
        for k, name in enumerate(_innermost(sp, mids)):
            if name is not None:
                names[k].add(name)
    idle: Dict[str, float] = {}
    for (s, e), ns in zip(gaps, names):
        key = " + ".join(sorted(ns)) or "none"
        idle[key] = idle.get(key, 0.0) + (e - s) * 1e-9
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    rows = [[k, v] for k, v in ranked[:top]]
    if len(ranked) > top:
        rows.append(["rest", sum(v for _, v in ranked[top:])])
    return {"idle_by_program_span": rows, "idle_s": sum(idle.values()),
            "no_span_s": idle.get("none", 0.0)}


def _median_ms(spans, name):
    d = [e - s for n, _, s, e in spans if n == name]
    return statistics.median(d) / 1e6 if d else None


def span_readings(spans, args_of) -> Dict:
    """Readings of the window's spans: verify's prelude per signature
    (us), window tables built per verify call, the median staging
    pass (`engine.stage`, ms), consensus sleep (ms) and its count."""
    pre = [(e - s, args_of[i]) for i, (n, _, s, e) in enumerate(spans)
           if n == "verify.prelude"]
    sigs = sum(a["signatures"] for _, a in pre)
    out = {"verify.prelude_us_per_event": sum(d for d, _ in pre) / sigs / 1e3
           if sigs else None,
           "verify.window_tables_per_sync": sum(a["tables"] for _, a in pre) / len(pre)
           if pre else None,
           "verify_calls": len(pre),
           "engine.stage_ms": _median_ms(spans, "engine.stage"),
           "engine.stages": sum(1 for n, *_ in spans if n == "engine.stage"),
           "consensus.sleep_ms_median": _median_ms(spans, "consensus.sleep")}
    return out


def trace_cell(bench, cell, seed, seconds, device, cfg=None, traffic=None) -> Dict:
    """One traced run of `cell` with the program's rings enlarged: the
    run's line (run.run_cell's) plus its end-to-end metrics and the
    program-span readings."""
    import devtrace
    import run
    from babble_tpu_torch.node.core import Core
    from babble_tpu_torch.node.node import Node
    from babble_tpu_torch.telemetry import clock, devclock
    from babble_tpu_torch.telemetry.trace import SpanRing

    cuda = device == "cuda"
    rings: Dict[int, SpanRing] = {}
    traces, host_marks = [], []
    core_init, node_init = Core.__init__, Node.__init__
    start, stop = devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop

    def core_init_big(self, *a, trace=None, **kw):
        if trace is None:
            trace = SpanRing(RING)
        rings[id(trace)] = trace
        core_init(self, *a, trace=trace, **kw)

    def node_init_big(self, conf, *a, **kw):
        conf.trace_ring = RING
        node_init(self, conf, *a, **kw)

    def start_marked(self):
        start(self)
        traces.append(self)
        if cuda:
            host_marks.append(devclock.device_mark())

    def stop_marked(self):
        if cuda:
            host_marks.append(devclock.device_mark())
        stop(self)

    Core.__init__, Node.__init__ = core_init_big, node_init_big
    devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop = start_marked, stop_marked
    rec: Dict = {}
    try:
        out = run.run_cell(bench, cell, seed, seconds, True, device, time.perf_counter(),
                           cfg=cfg, traffic=traffic, record=rec)
    finally:
        Core.__init__, Node.__init__ = core_init, node_init
        devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop = start, stop
    out["end_to_end"] = {}
    for m in run.metrics_of(bench, cell, "end_to_end"):
        reader = run.load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            out["end_to_end"][m["name"]] = float(value)
    prof = traces[0]
    if cuda:
        # devtrace's kernels() sit on time_ns through its own (first)
        # marker; the two markers here tie the rings' clock to the same.
        marks = devclock.profiler_marks(prof.prof)
        to_raw = devclock.trace_rebase(devclock.anchors(host_marks, marks[1:3]))
        shift = marks[0][0] - prof.mark_ns

        def to_trace(t):
            return to_raw(t) - shift
    else:
        wall = clock.wall_offset_ns()

        def to_trace(t):
            return t + wall
    spans, args_of, dropped = [], [], 0
    for ring in rings.values():
        dropped += ring.dropped
        for sp in ring.snapshot():
            if "flow" in sp:
                continue
            s, e = to_trace(sp["t0"]), to_trace(sp["t1"])
            if e > prof.t0_ns and s < prof.t1_ns:
                spans.append((sp["name"], sp["tid"], s, e))
                args_of.append(sp["args"])
    attr = idle_by_program_span(prof.kernels(), prof.t0_ns, prof.t1_ns, spans)
    out["program"] = dict(attr, rings=len(rings), spans=len(spans), dropped=dropped,
                          no_span_share=attr["no_span_s"] / attr["idle_s"]
                          if attr["idle_s"] else None,
                          **span_readings(spans, args_of))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import run

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = run.find_cell(bench, args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(run.ROOT / "build" / sub)
    sys.path.insert(0, str(run.ROOT))
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    out = trace_cell(bench, cell, args.seed, args.seconds, "cuda")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
