"""Closed loop over the node's state machine, `Core`, as the consensus
worker drives it with no cadence: jobs back to back, each a fresh Core
(a node that joins) built as `cli.py run` builds it, taking the whole
stream one sync of `sync_limit` events after another. Each sync is held
as the columnar frame the TCP transport carries and decoded anew; after
each sync the pass in flight is collected and the next dispatched.

Metrics of the record (benchmark/metrics/*.py read them):
- ordered_in_window: events given a place in the consensus order by the
  collects that returned inside the window, over all jobs;
- job_bytes: [(peak device bytes allocated during a join, events its
  engine held when the peak was reached, events it took)] of the joins
  of the window;
- phase_ns: every phase the window's Cores counted, summed as
  [ns, calls]; syncs, events synced, passes;
- traced run: host spans, the device trace, B1 and B9 launches with
  their bounds, torch calls a pass (counted in the warm job), and
  program_spans: each window Core keeps a span ring, and each span name
  that closed inside the traced window gets its count, total and median
  ns (program_spans_dropped: what the rings evicted).
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import bounds
import compare
import devtrace
import reference
import stream

RING = 1 << 16  # spans a traced Core keeps: far above a join's (~20 a sync)


def log(msg: str) -> None:
    print(f"[core_loop] {msg}", file=sys.stderr, flush=True)


class Calls:
    """Counts torch calls (attribute reads excluded) while active."""

    def __init__(self):
        from torch.overrides import TorchFunctionMode

        outer = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if getattr(func, "__name__", "") != "__get__":
                    outer.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self.mode = Mode


def program_spans(rings, t0, t1):
    """Count, total and median ns of each span name of the rings that
    closed inside [t0, t1] (perf_counter seconds)."""
    lo, hi = round(t0 * 1e9), round(t1 * 1e9)
    durs = {}
    for ring in rings:
        for sp in ring.snapshot():
            if "flow" not in sp and lo <= sp["t1"] <= hi:
                durs.setdefault(sp["name"], []).append(sp["t1"] - sp["t0"])
    return {name: {"count": len(d), "total_ns": sum(d),
                   "median_ns": statistics.median(d)}
            for name, d in sorted(durs.items())}


def run(cfg, traffic, seed, seconds, trace, device, t_start):
    import torch

    from babble_tpu_torch import crypto
    from babble_tpu_torch.hashgraph import InmemStore
    from babble_tpu_torch.net.columnar import ColumnarEvents
    from babble_tpu_torch.node import core as core_mod
    from babble_tpu_torch.node.core import Core
    from babble_tpu_torch.ops import hopper_kernels
    from babble_tpu_torch.telemetry import Registry, SpanRing

    node = cfg["node"]
    cuda = device == "cuda"
    t0 = time.perf_counter()
    events = int(traffic["events"])
    st = stream.generate(cfg, events + int(traffic["tail_events"]), seed,
                         topology_seed=traffic.get("topology_seed"))
    log(f"stream: {st.e} events in {time.perf_counter() - t0:.2f} s")
    # The harness's own objects (the stream) leave the collector's
    # generations, so the program's collections cost what they would
    # in a node.
    gc.collect()
    gc.freeze()
    limit = int(node["sync_limit"])
    frames = [st.frame(lo, min(lo + limit, events))
              for lo in range(0, events, limit)]
    key = crypto.key_from_seed(st.node_key - 1)
    index = {h: i for i, h in enumerate(st.hexes)}
    spans = devtrace.HostSpans()
    b1_rec, p256_rec = [], []
    calls = {"main": None, "stage": 0, "passes": 0}

    decode = spans.wrap("decode", ColumnarEvents.decode)
    if trace:
        verify_events = core_mod.verify_events
        core_mod.verify_events = spans.wrap("verify", verify_events)
        ssg = hopper_kernels.strongly_see_gathered
        p256_launch = hopper_kernels.launch_p256_dual_window

        def ssg_traced(x_tab, xs, f_tab, w_tab, wrow, sm, mode):
            out = ssg(x_tab, xs, f_tab, w_tab, wrow, sm, mode)
            if spans.on and xs.numel() and w_tab.shape[1]:
                pairs = (w_tab >= 0).sum(1, dtype=torch.int64)[wrow.long()].sum()
                b1_rec.append((pairs, x_tab.shape[1], xs.shape[0], mode))
            return out

        def p256_traced(n1, n2, qwin, gwin, X, Y, Z, b):
            p256_launch(n1, n2, qwin, gwin, X, Y, Z, b)
            if spans.on:
                p256_rec.append(((n1 != 0).sum() + (n2 != 0).sum(), b))

        ssg_traced.launches = ssg.launches  # the wrapper counts into it
        hopper_kernels.strongly_see_gathered = ssg_traced
        hopper_kernels.launch_p256_dual_window = p256_traced

    def new_core(blocks, ring):
        core = Core(st.silent, key, st.participants,
                    InmemStore(st.participants, int(node["cache_size"])),
                    commit_callback=blocks.append, engine=node["engine"],
                    engine_prewarm=True, engine_opts={"device": device},
                    device_verify=bool(node["device_verify"]),
                    trace=ring, registry=Registry())
        core.init()
        hg = core.hg
        hg.read_wire_batch = spans.wrap("from_wire", hg.read_wire_batch)
        hg.insert_wire_batch = spans.wrap("insert", hg.insert_wire_batch)
        return core

    def count_calls(core):
        eng = core.hg.engine
        stage = eng._stage_pass
        counter = Calls()

        def counted(pp):
            with counter.mode():
                stage(pp)
            calls["stage"] += counter.n
            counter.n = 0

        eng._stage_pass = counted
        main = Calls()
        calls["main"] = main
        for name in ("dispatch_consensus", "collect_consensus"):
            fn = getattr(core, name)

            def inner(*a, _fn=fn, **kw):
                with main.mode():
                    return _fn(*a, **kw)
            setattr(core, name, inner)

    def job(window_end=None, on_step=None, counting=False, n_frames=None, ring=None):
        """One join: the node takes the stream's frames (the first
        `n_frames`, or until `window_end`), then passes run until
        nothing new is ordered. `ring` is the Core's span ring (None:
        none, as a node without tracing). Returns a dict: capture,
        events fed, events ordered by window_end, peak bytes, events
        held, phase sums, pass walls, error."""
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        blocks = []
        core = spans.wrap("new_core", new_core)(blocks, ring)
        if counting:
            count_calls(core)
        sync = spans.wrap("sync", core.sync)
        dispatch = spans.wrap("dispatch", core.dispatch_consensus)
        collect = spans.wrap("collect", core.collect_consensus)
        out = {"ordered": 0, "walls": [], "err": None, "fed": 0, "fed_by_end": 0,
               "cap": None, "peak": 0, "held": 0}
        pending, t_disp = None, 0.0

        def note_peak():
            # the events the engine holds when the peak is reached
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            if peak > out["peak"]:
                out["peak"], out["held"] = peak, core.hg.engine.e

        def step():
            nonlocal pending, t_disp
            if pending is not None:
                collect(pending)
                now = time.perf_counter()
                out["walls"].append(now - t_disp)
                if window_end is None or now <= window_end:
                    out["ordered"] = core.get_consensus_events_count()
            t_disp = time.perf_counter()
            pending = dispatch()

        try:
            for fr in frames[:n_frames]:
                if window_end is not None and time.perf_counter() >= window_end:
                    break
                sync(decode(fr))
                out["fed"] = min(out["fed"] + limit, events)
                step()
                note_peak()
                if window_end is None or time.perf_counter() <= window_end:
                    out["fed_by_end"] = out["fed"]
                if on_step is not None:
                    on_step()
            for _ in range(8):  # drain: passes until nothing new is ordered
                if pending is None:
                    break
                step()
        except Exception as exc:  # noqa: BLE001 - a failed job is recorded
            out["err"] = f"{type(exc).__name__}: {exc}"
        if cuda:
            torch.cuda.synchronize()
        note_peak()
        out["phases"] = {k: list(v) for k, v in core.phase_ns.items()}
        if out["err"] is None:
            out["cap"] = spans.wrap("capture", compare.capture)(
                core, st.hexes,
                [reference.block_bytes(b.round_received, b.transactions) for b in blocks])
        core.hg.close()
        del core
        gc.collect()
        return out

    # Set-up: a warm join over the first `warm_syncs` syncs builds the
    # kernel libraries and runs every kind of pass once; in a traced run
    # it also counts torch calls.
    t0 = time.perf_counter()
    warm = job(counting=trace, n_frames=int(traffic["warm_syncs"]))
    log(f"warm job: {time.perf_counter() - t0:.2f} s, {len(warm['walls'])} passes, "
        f"{warm['ordered']} ordered, error {warm['err']}")
    if trace:
        calls["passes"] = len(warm["walls"])
    peak_all = warm["peak"]
    jobs = [warm]

    prof = devtrace.DeviceTrace(cuda) if trace else None
    trace_s = min(float(traffic.get("trace_s", seconds)), seconds)

    def on_step():
        nonlocal trace_end
        if spans.on and time.perf_counter() >= t_w0 + trace_s:
            spans.on = False
            trace_end = time.perf_counter()
            prof.stop()

    if prof is not None:
        prof.start()  # the profiler's own start-up stays out of the window
    setup_s = time.perf_counter() - t_start
    t_w0 = time.perf_counter()
    t_w1 = t_w0 + seconds
    if prof is not None:
        prof.t0_ns = time.time_ns()
        spans.on = True
    ordered, job_bytes, phase_sum, n_jobs, walls, fed, fed_in = 0, [], {}, 0, [], 0, 0
    rings, trace_end = [], t_w1
    while time.perf_counter() < t_w1:
        if trace:
            rings.append(SpanRing(RING))
        out = job(t_w1, on_step, ring=rings[-1] if trace else None)
        jobs.append(out)
        n_jobs += 1
        ordered += out["ordered"]
        walls += out["walls"]
        fed += out["fed"]
        fed_in += out["fed_by_end"]
        job_bytes.append((out["peak"], out["held"], out["fed"]))
        peak_all = max(peak_all, out["peak"])
        for k, (_, ns, n_calls) in out["phases"].items():
            ent = phase_sum.setdefault(k, [0, 0])
            ent[0] += ns
            ent[1] += n_calls
    if prof is not None and spans.on:
        spans.on = False
        trace_end = time.perf_counter()
        prof.stop()
    errors = [j["err"] for j in jobs if j["err"]]

    rec = {"ordered_in_window": ordered, "ingested_in_window": fed_in, "window_s": seconds, "setup_s": setup_s,
           "job_bytes": job_bytes, "jobs": n_jobs, "phase_ns": phase_sum,
           "events_synced": fed, "events_verified": fed,
           "syncs_per_job": len(frames), "pass_walls_s": walls,
           "memory_peak_bytes": peak_all, "attempted": -(-fed // limit),
           "failed": len(errors),
           "device_kind": torch.cuda.get_device_name(0) if cuda else device}
    if trace:
        summ = devtrace.summarize(prof, spans.spans)
        b1_s = sum(bounds.strongly_see_bound_s(int(p), n, m, mode)
                   for p, n, m, mode in b1_rec)
        p_s = sum(bounds.p256_bound_s(b, int(nz)) for nz, b in p256_rec)
        summ["b1"] = {"bound_s": b1_s, "launches": len(b1_rec),
                      "device_s": devtrace.kernel_time_s(summ, "strongly_see_kernel")}
        summ["p256"] = {"bound_s": p_s, "launches": len(p256_rec),
                        "device_s": devtrace.kernel_time_s(summ, "p256_dual_window_kernel")}
        rec["trace"] = summ
        rec["torch_calls"] = calls["stage"] + (calls["main"].n if calls["main"] else 0)
        rec["program_spans"] = program_spans(rings, t_w0, trace_end)
        rec["program_spans_dropped"] = sum(r.dropped for r in rings)
        rec["torch_call_passes"] = calls["passes"]
        hopper_kernels.strongly_see_gathered = ssg
        hopper_kernels.launch_p256_dual_window = p256_launch
        core_mod.verify_events = verify_events

    log(f"window: {n_jobs} jobs, {fed_in} events ingested ({fed} fed), {ordered} "
        f"ordered, errors {errors[:1]}; phases (s, calls) "
        + str({k: (round(v[0] / 1e9, 2), v[1]) for k, v in phase_sum.items()})
        + f"; pass wall median {sorted(walls)[len(walls) // 2] if walls else 0:.3f} s")
    # The check: every join's outputs against the reference's consensus
    # of the same stream prefix, run once the window has closed and the
    # program's state is freed.
    del frames
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference.consensus(st, device=device)
    counts = {}  # events the reference decides on each prefix a join took
    diffs = []
    for j in jobs:
        if j["cap"] is None:
            continue
        p = j["fed"]
        if p not in counts:
            counts[p] = len(reference.consensus(stream.prefix(st, p), device=device).order) \
                if p else 0
        diffs.append(compare.compare(j["cap"], ref, st.hexes, index, p, counts[p]))
    log(f"reference: {len(ref.order)} of {st.e} ordered; on prefixes "
        f"{sorted(counts.items())}; {time.perf_counter() - t0:.2f} s")
    worst = compare.worst(diffs)
    rec["checks"] = [(k, worst[k], 0) for k in compare.NUMBERS]
    rec["checks"].append(("jobs_failed", len(errors), 0))
    rec["ok"] = bool(diffs)
    return rec
