#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (babble_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero and the final `{"ok": true, ...}`
line is not printed):

1. device   — the card's name, and its name and power limit as
              nvidia-smi reports them;
2. build    — compile the CUDA kernel library from the repository's
              sources (nvcc, sm_90a) and print the build time;
3. kernel   — both entry points of the strongly-see kernel against
              their plain PyTorch versions on the card, exact integer
              equality: strongly_see_counts at (M, W, n) = (5,7,4),
              (64,64,64), (130,200,100) and (1024,1024,1024) with 20%
              INT32_MAX lanes; strongly_see_gathered in both modes at
              the main path's shapes (GATHERED_SHAPES: fame's batch,
              the frontier probe, a north-star level with mixed witness
              rows, a ragged case); kernel and plain times and bounds;
4. small    — a small DAG through both engines on the card and on the
              CPU (plain versions): all six outputs identical;
5. headline — synthetic_dag(64, 50_000, seed=1) through run_pipeline
              with both engines: outputs identical between engines,
              47,659 decided events, a sha256 over the six outputs
              equal to the digest of the JAX reference package on the
              same DAG, and the gathered kernel launched as each site
              should (fame once, one probe launch per frontier probe
              and one skip correction per round, or compute_rounds once
              per level); median of 3 timed runs (pipeline + host
              order);
6. main_path — the default engine's headline run with every launch
              count set to 0 just before and read just after, by mode
              and by site;
7. profile  — one headline run of the main path under torch.profiler:
              the card's busy share of the wall time, device time by
              kernel;
8. northstar — synthetic_dag(1024, 100_000, seed=2) once with the
              default engine: time, decided count (44,770), launches
              by site.

Lines before the last: a {"kernels": [...]} line (launches on the main
path, max error, times and bound), a {"results": ...} line, and the
nvidia-smi line. The last line is {"ok": true, "device": {...}}.

Exits nonzero without a result when no CUDA device is available, and
when run outside the repository (the port is not importable there).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import platform
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Golden digests of the JAX reference package (babble_tpu, run_pipeline,
# both engines agree) on synthetic_dag(64, 50_000, seed=1), computed on
# the CPU with `digest` below. INPUT covers the DAG arrays and s_rank,
# OUTPUT the six pipeline outputs; a mismatch in INPUT means the DAG
# generator differs, in OUTPUT alone that the pipeline does.
GOLDEN_INPUT = "f7dfc621276b26d93676d524f724a8ef2aa9e63fb9647e2e6c763d010a6d36a0"
GOLDEN_OUTPUT = "3f2191acd555ba55642448106e70046bcd742e0ae60e24a8854455b7ab044ec4"
HEADLINE = (64, 50_000, 1)
HEADLINE_DECIDED = 47_659
NORTHSTAR = (1024, 100_000, 2)
NORTHSTAR_DECIDED = 44_770
KERNEL_SHAPES = [(5, 7, 4), (64, 64, 64), (130, 200, 100), (1024, 1024, 1024)]
# The gathered entry at the main path's shapes: (name, M rows, W witness
# slots, n, R witness rows, how rows name witness rows).
# - fame_batch: decide_fame at the headline, r_small - 1 = 127 voting
#   rounds x 64 witnesses, every 64-row tile naming one round;
# - frontier_probe: one probe (or skip correction) at the headline;
# - northstar_level: compute_rounds on a 1024-wide level at n = 1024,
#   rows naming two adjacent parent rounds at random, as a level's do;
# - ragged: nothing a multiple of the tile, five witness rows mixed.
GATHERED_SHAPES = [
    ("fame_batch", 127 * 64, 64, 64, 127, "tiles"),
    ("frontier_probe", 64, 64, 64, 1, "one"),
    ("northstar_level", 1024, 1024, 1024, 7, "two"),
    ("ragged", 130, 200, 100, 5, "mixed"),
]
# The pipeline functions that call strongly_see_gathered, by site.
SITES = {"decide_fame": "fame", "sees_sm": "frontier_probe",
         "step": "skip_correction", "compute_rounds": "compute_rounds"}

# The least time the H100 SXM needs for the compare-count. Operations:
# one compare and one add per (x, w, i), two int32 operations, at 64
# int32 lanes per SM per clock (half the 128 fp32 lanes behind the
# 67 TFLOP/s fp32 peak) x 132 SMs x 1.98 GHz. Bytes: both inputs read
# once, the output written once, at 3.35 TB/s.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
INT32_MAX = 2**31 - 1


def digest(arrays) -> str:
    """sha256 over each array's shape and its values as int64."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a).astype(np.int64))
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(a.tobytes())
    return h.hexdigest()


def dag_digest(dag, s_rank) -> str:
    return digest([dag.self_parent, dag.other_parent, dag.creator, dag.index,
                   dag.coin, dag.ts_rank, dag.levels, dag.chain, dag.chain_len,
                   dag.chain_rank, dag.root_round, s_rank])


def ss_bound_ms(m: int, w: int, n: int):
    ops_s = 2.0 * m * w * n / INT32_OPS_PER_S
    bytes_s = 4.0 * (m * n + w * n + m * w) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def gathered_bound_ms(x_tab, xs, f_tab, w_tab, wrow, mode):
    """Least time for one gathered call on these inputs: 2 int32
    operations per (row, valid witness, lane), against the distinct x
    and witness rows read once, the index arrays and the output."""
    import torch

    n, m, w = x_tab.shape[1], xs.shape[0], w_tab.shape[1]
    ids = w_tab[wrow.long()]
    valid = ids >= 0
    ops_s = 2.0 * int(valid.sum()) * n / INT32_OPS_PER_S
    rows = torch.unique(xs).numel() + torch.unique(ids[valid]).numel()
    index_bytes = 4 * (2 * m + torch.unique(wrow).numel() * w)
    out_bytes = m * w if mode == "matrix" else 4 * m
    bytes_s = (4.0 * n * rows + index_bytes + out_bytes) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def gathered_inputs(m, w, n, r, wrow_kind, seed=3):
    """numpy operands of strongly_see_gathered: tables of 2M+1 rows,
    x values shifted per row so the counts spread across sm = 2n/3+1,
    20% INT32_MAX fd lanes and 20% empty (-1) witness slots."""
    rng = np.random.default_rng(seed)
    ex = ef = 2 * m + 1
    x_tab = (rng.integers(0, 100, (ex, n)) + rng.integers(-50, 100, (ex, 1))).astype(np.int32)
    f_tab = rng.integers(0, 100, (ef, n)).astype(np.int32)
    f_tab[rng.random((ef, n)) < 0.2] = INT32_MAX
    w_tab = rng.integers(0, ef, (r, w)).astype(np.int32)
    w_tab[rng.random((r, w)) < 0.2] = -1
    xs = rng.integers(0, ex, m).astype(np.int32)
    wrow = {"tiles": np.repeat(np.arange(r), m // r),
            "one": np.zeros(m),
            "two": r - 2 + rng.integers(0, 2, m),
            "mixed": rng.integers(0, r, m)}[wrow_kind].astype(np.int32)
    return x_tab, xs, f_tab, w_tab, wrow, 2 * n // 3 + 1


def reset_launches():
    from babble_tpu_torch.ops import hopper_kernels as hk

    hk.strongly_see_counts.launches = 0
    for mode in hk.strongly_see_gathered.launches:
        hk.strongly_see_gathered.launches[mode] = 0


def read_launches() -> dict:
    from babble_tpu_torch.ops import hopper_kernels as hk

    return {"counts": hk.strongly_see_counts.launches, **hk.strongly_see_gathered.launches}


@contextlib.contextmanager
def launches_by_site():
    """Attribute each launch of the gathered wrapper to the pipeline
    function that asked for it (SITES), through a spy around the
    wrapper; the wrapper's own counts go on as before."""
    from babble_tpu_torch.ops import hopper_kernels as hk

    real = hk.strongly_see_gathered
    sites = {}

    def spy(*args):
        before = sum(real.launches.values())
        out = real(*args)
        caller = sys._getframe(1).f_code.co_name
        site = SITES.get(caller, caller)
        sites[site] = sites.get(site, 0) + sum(real.launches.values()) - before
        return out

    spy.launches = real.launches
    hk.strongly_see_gathered = spy
    try:
        yield sites
    finally:
        hk.strongly_see_gathered = real


def check_sites(dag, engine, launches, sites, r_small) -> None:
    """The launches a run must make: none of the counts entry; fame one
    matrix launch per chunk of voting rounds (one at these sizes); the
    closure engine one probe launch per frontier probe and one skip
    correction per swept round; the wavefront one compute_rounds launch
    per DAG level."""
    from babble_tpu_torch.ops.kernels import chunk_width

    n = dag.n
    fame = -(-(r_small - 1) // chunk_width(r_small - 1, n * n))
    probes = max(int(np.ceil(np.log2(max(dag.chain.shape[1], 2)))), 1) + 1
    if engine == "wavefront":
        tally = {"compute_rounds": dag.levels.shape[0]}
    else:
        rounds = sites.get("skip_correction", 0)
        tally = {"frontier_probe": probes * rounds, "skip_correction": rounds}
        if rounds == 0 or rounds % 64:
            raise AssertionError(f"{engine}: {rounds} frontier rounds, not chunks of 64")
    want_sites = {"fame": fame, **tally}
    want = {"counts": 0, "matrix": fame, "tally": sum(tally.values())}
    if sites != want_sites or launches != want:
        raise AssertionError(f"{engine}: launches {launches} by site {sites}, "
                             f"expected {want} by site {want_sites}")


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host(out):
    return [o.cpu().numpy() for o in out]


def host_name() -> str:
    """The host's CPU model (lscpu's "Model name", else /proc/cpuinfo's
    "model name", else the machine type) and the cores this process may
    use: the pipeline's eager loops are bound by the host's launch cost,
    so its times move with the host as much as with the card."""
    model = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                      if line.startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    if not model:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((line.split(":", 1)[1].strip() for line in f
                              if line.startswith("model name")), "")
        except OSError:
            pass
    return f"{model or platform.machine()}, {len(os.sched_getaffinity(0))} cores"


def phase_build(rec):
    from babble_tpu_torch.ops import hopper_kernels

    t0 = time.perf_counter()
    info = hopper_kernels.build()
    rec["build"] = {"seconds": time.perf_counter() - t0, "library": str(info["path"]),
                    "nvcc_seconds": info["seconds"], "ptxas": info["log"]}
    print(f"build: {rec['build']['seconds']:.2f} s -> {info['path']}")
    print(info["log"])


def phase_kernel(rec, device="cuda"):
    """Both entry points vs their plain versions, exact equality:
    strongly_see_counts at KERNEL_SHAPES, strongly_see_gathered in both
    modes at GATHERED_SHAPES."""
    import torch

    from babble_tpu_torch.ops.hopper_kernels import (
        strongly_see_counts, strongly_see_counts_ref, strongly_see_gathered,
        strongly_see_gathered_ref)

    rows = []
    for m, w, n in KERNEL_SHAPES:
        rng = np.random.default_rng(3)
        la = rng.integers(-1, 50, (m, n)).astype(np.int32)
        fd = rng.integers(0, 50, (w, n)).astype(np.int32)
        fd[rng.random((w, n)) < 0.2] = INT32_MAX  # unreached
        la_t = torch.from_numpy(la).to(device)
        fd_t = torch.from_numpy(fd).to(device)
        got = strongly_see_counts(la_t, fd_t)
        want = strongly_see_counts_ref(la_t, fd_t)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        iters = 20 if n >= 1024 else 200
        ms = cuda_ms(lambda: strongly_see_counts(la_t, fd_t), iters)
        plain_ms = cuda_ms(lambda: strongly_see_counts_ref(la_t, fd_t), iters)
        bound, by = ss_bound_ms(m, w, n)
        rows.append({"shape": [m, w, n], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by})
        print(f"kernel {m}x{w}x{n}: max_abs_err={err} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound:.5f} ms ({by})")
        if err != 0:
            raise AssertionError(f"kernel != plain version at {(m, w, n)}")
    rec["kernel_shapes"] = rows

    rows = []
    for name, m, w, n, r, kind in GATHERED_SHAPES:
        *tabs, sm = gathered_inputs(m, w, n, r, kind)
        args = [torch.from_numpy(a).to(device) for a in tabs]
        for mode in ("matrix", "tally"):
            got = strongly_see_gathered(*args, sm, mode)
            want = strongly_see_gathered_ref(*args, sm, mode)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            iters = 20 if n >= 1024 else 200
            ms = cuda_ms(lambda: strongly_see_gathered(*args, sm, mode), iters)
            plain_ms = cuda_ms(lambda: strongly_see_gathered_ref(*args, sm, mode), iters)
            bound, by = gathered_bound_ms(*args, mode)
            hits = float(want.float().mean() / (1 if mode == "matrix" else w))
            rows.append({"name": name, "mode": mode, "shape": [m, w, n, r],
                         "wrow": kind, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                         "hit_share": hits})
            print(f"gathered {name} {mode} M={m} W={w} n={n} R={r} ({kind}): "
                  f"max_abs_err={err} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"bound {bound:.5f} ms ({by}) hits {hits:.3f}")
            if err != 0:
                raise AssertionError(f"gathered kernel != plain version at {name} {mode}")
    rec["gathered_shapes"] = rows


def phase_small(rec, device="cuda"):
    """A small DAG: both engines on the card equal the CPU run."""
    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.pipeline import run_pipeline

    dag, _ = synthetic_dag(8, 400, seed=7)
    ref = host(run_pipeline(dag, engine="wavefront", device="cpu"))
    for engine in ("closure", "wavefront"):
        got = host(run_pipeline(dag, engine=engine, device=device))
        for name, a, b in zip(OUTPUT_NAMES, got, ref):
            if a.shape != b.shape or not (a == b).all():
                raise AssertionError(f"small DAG, {engine}: {name} differs from CPU")
    rec["small"] = {"n": 8, "e": 400, "seed": 7, "equal_to_cpu": True}
    print("small: n=8 e=400 both engines on the card == CPU")


OUTPUT_NAMES = ("rounds", "witness", "wt", "famous", "rr", "cts")


def _timed_run(dag, s_rank, engine, device):
    """One pipeline run plus the host finish, synchronised; returns
    (seconds, outputs on the host, order)."""
    import torch

    from babble_tpu_torch.ops.engine import consensus_order
    from babble_tpu_torch.ops.pipeline import run_pipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_pipeline(dag, engine=engine, device=device)
    order = consensus_order(out[4], out[5], s_rank)
    outs = host(out)
    return time.perf_counter() - t0, outs, order


def _r_small(dag, rounds) -> int:
    from babble_tpu_torch.ops.pipeline import _round_bucket

    max_round = int(rounds.max())
    return _round_bucket(max_round, max(dag.max_rounds, max_round + 1))


def stage_times(dag, engine, device):
    """Per-stage seconds of one run, each stage synchronised: where the
    pipeline's time goes (the device idles between launches, so these
    are launch-bound wall times)."""
    import torch

    from babble_tpu_torch.ops import closure, frontier, kernels, pipeline

    dev = torch.device(device)
    times = {}
    n, sm, e = dag.n, dag.super_majority, dag.e

    def tick(name, t0):
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = pipeline._to_device(dag, dev)
    t0 = tick("to_device", t0)
    if engine == "wavefront":
        la = kernels.compute_last_ancestors(
            t["self_parent"], t["other_parent"], t["creator"], t["index"],
            t["levels"], n=n)
        t0 = tick("last_ancestors", t0)
        fd = kernels.compute_first_descendants(
            la, t["creator"], t["index"], t["chain"], t["chain_len"], n=n)
        t0 = tick("first_descendants", t0)
        rounds, _, wt = kernels.compute_rounds(
            t["self_parent"], t["other_parent"], t["creator"], t["index"], la,
            fd, t["levels"], t["root_round"], n=n, sm=sm, r=dag.max_rounds)
        r_small = pipeline.tight_round_bucket(rounds, dag.max_rounds)
        wt = wt[:r_small].contiguous()
        t0 = tick("rounds", t0)
    else:
        la, rbase = closure.coordinates(dag, block=512, device=dev)
        t0 = tick("closure_coordinates", t0)
        fd = kernels.compute_first_descendants(
            la, t["creator"], t["index"], t["chain"], t["chain_len"], n=n)
        t0 = tick("first_descendants", t0)
        wt_abs, fr_rel, rho_min = frontier.compute_frontier(
            la, rbase, fd, t["chain"], t["chain_len"], dag.root_round, n=n, sm=sm)
        rounds, _ = frontier.rounds_from_frontier(
            fr_rel, t["creator"][:e], t["index"][:e], t["self_parent"][:e],
            rho_min, n=n)
        max_round = wt_abs.shape[0] - 1
        r_small = pipeline._round_bucket(max_round, max(dag.max_rounds, max_round + 1))
        wt = torch.full((r_small, n), -1, dtype=torch.int32, device=dev)
        wt[: min(r_small, wt_abs.shape[0])] = wt_abs[:r_small]
        t0 = tick("frontier_rounds", t0)
    famous = kernels.decide_fame(wt, la, fd, t["index"], t["coin"], n=n, sm=sm,
                                 r=r_small)
    t0 = tick("fame", t0)
    kernels.decide_round_received(rounds, wt, famous, la, fd, t["creator"],
                                  t["index"], t["chain_rank"], n=n, r=r_small)
    tick("round_received", t0)
    return times


def phase_headline(rec, device="cuda"):
    from babble_tpu_torch.ops.dag import synthetic_dag

    n, e, seed = HEADLINE
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    in_digest = dag_digest(dag, s_rank)
    print(f"headline: n={n} e={e} seed={seed} levels={dag.levels.shape} "
          f"input digest {'ok' if in_digest == GOLDEN_INPUT else 'MISMATCH'}")
    if in_digest != GOLDEN_INPUT:
        raise AssertionError(f"headline input digest {in_digest} != {GOLDEN_INPUT}")
    res = {"n": n, "e": e, "seed": seed, "engines": {}}
    outs = {}
    for engine in ("closure", "wavefront"):
        # warm-up (allocator, library), counted by mode and by site
        reset_launches()
        with launches_by_site() as sites:
            _timed_run(dag, s_rank, engine, device)
        launches = read_launches()
        times = []
        for _ in range(3):
            sec, out, order = _timed_run(dag, s_rank, engine, device)
            times.append(sec)
        decided = int((out[4] >= 0).sum())
        med = statistics.median(times)
        out_digest = digest(out)
        res["engines"][engine] = {
            "launches": launches, "launches_by_site": sites,
            "decided": decided, "max_round": int(out[0].max()),
            "seconds": times, "median_s": med, "events_per_s": decided / med,
            "output_digest": out_digest,
            "stages_s": stage_times(dag, engine, device)}
        outs[engine] = out
        print(f"headline[{engine}]: decided={decided} max_round={int(out[0].max())} "
              f"launches={launches} by site {sites} median {med * 1e3:.1f} ms "
              f"-> {decided / med:,.0f} events/s; runs "
              f"{[round(t * 1e3, 1) for t in times]} ms; digest "
              f"{'ok' if out_digest == GOLDEN_OUTPUT else 'MISMATCH'}")
        print(f"headline[{engine}] stages (s): "
              + json.dumps({k: round(v, 4) for k, v in
                            res["engines"][engine]["stages_s"].items()}))
        if decided != HEADLINE_DECIDED:
            raise AssertionError(f"{engine}: {decided} decided != {HEADLINE_DECIDED}")
        if out_digest != GOLDEN_OUTPUT:
            raise AssertionError(f"{engine}: output digest {out_digest} != golden")
        check_sites(dag, engine, launches, sites, _r_small(dag, out[0]))
    for name, a, b in zip(OUTPUT_NAMES, outs["closure"], outs["wavefront"]):
        if a.shape != b.shape or not (a == b).all():
            raise AssertionError(f"headline engines differ in {name}")
    rec["headline"] = res


def phase_main_path_counts(rec, device="cuda"):
    """The main path as a user calls it — run_pipeline with the default
    engine, then the host order — with every launch count set to 0
    just before and read just after, by mode and by site."""
    import torch

    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.pipeline import _default_engine

    n, e, seed = HEADLINE
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    reset_launches()
    with launches_by_site() as sites:
        _, out, order = _timed_run(dag, s_rank, "auto", device)
    launches = read_launches()
    if launches["matrix"] == 0 or launches["tally"] == 0:
        raise AssertionError(f"main path launches {launches}: a kernel was never launched")
    engine = _default_engine(n, torch.device(device))
    check_sites(dag, engine, launches, sites, _r_small(dag, out[0]))
    rec["main_path_launches"] = {"engine": engine, "by_mode": launches,
                                 "by_site": sites, "decided": int(len(order))}
    print(f"main path (engine=auto -> {engine}): launches by mode {launches}, "
          f"by site {sites}")


def phase_profile(rec, device="cuda"):
    """One headline run of the main path under torch.profiler: the
    share of the wall time the card is busy (union of kernel
    intervals), device time by kernel, and B1's device time per launch.
    Where the profiler records no device activity, the numbers are
    written as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from babble_tpu_torch.ops.dag import synthetic_dag

    n, e, seed = HEADLINE
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    _timed_run(dag, s_rank, "auto", device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s, _, _ = _timed_run(dag, s_rank, "auto", device)
    kern = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    if not kern:
        rec["profile"] = {"wall_s": wall_s, "device_busy_share": "not measured"}
        print("profile: the profiler recorded no device activity: not measured")
        return
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in kern)
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, t in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy_us += cur_e - cur_s
    by_name = {}
    for ev in kern:
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + ev.time_range.end - ev.time_range.start, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    ss = {k: {"us_per_launch": v[0] / v[1], "count": v[1]}
          for k, v in by_name.items() if "strongly_see_kernel" in k}
    rec["profile"] = {
        "engine": "auto", "wall_s": wall_s, "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall_s, "kernel_launches": len(kern),
        "strongly_see": ss,
        "top_kernels_us": [{"name": k[:120], "us": v[0], "count": v[1]} for k, v in top]}
    p = rec["profile"]
    print(f"profile (headline, engine=auto, profiled run {wall_s:.3f} s): "
          f"{len(kern)} kernels, device busy {p['device_busy_s']:.3f} s "
          f"= {p['device_busy_share']:.1%} of wall; strongly_see {ss}")
    for row in p["top_kernels_us"]:
        print(f"  {row['us'] / 1e3:9.2f} ms  x{row['count']:6d}  {row['name']}")


def phase_northstar(rec, device="cuda"):
    import torch

    from babble_tpu_torch.ops.dag import synthetic_dag

    n, e, seed = NORTHSTAR
    t0 = time.perf_counter()
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with launches_by_site() as sites:
        sec, out, order = _timed_run(dag, s_rank, "auto", device)
    launches = read_launches()
    decided = int((out[4] >= 0).sum())
    rounds, rr, cts = out[0], out[4], out[5]
    max_round = int(rounds.max())
    if rounds.shape != (e,) or rr.shape != (e,) or cts.shape != (e,):
        raise AssertionError("northstar output shapes")
    if decided != NORTHSTAR_DECIDED or rr.max() > max_round:
        raise AssertionError(f"northstar: decided={decided} != {NORTHSTAR_DECIDED}")
    check_sites(dag, "wavefront", launches, sites, _r_small(dag, rounds))
    rec["northstar"] = {
        "n": n, "e": e, "seed": seed, "engine": "wavefront", "dag_gen_s": gen_s,
        "levels": list(dag.levels.shape), "seconds": sec, "decided": decided,
        "events_per_s": decided / sec, "max_round": max_round, "launches": launches,
        "launches_by_site": sites,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "stages_s": stage_times(dag, "wavefront", device)}
    print(f"northstar: n={n} e={e} levels={dag.levels.shape} {sec:.2f} s -> "
          f"{decided} decided ({decided / sec:,.0f} events/s), max_round={max_round}, "
          f"launches={launches} by site {sites}, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("northstar stages (s): " + json.dumps(
        {k: round(v, 4) for k, v in rec["northstar"]["stages_s"].items()}))


def kernels_line(rec) -> dict:
    """One entry per entry point of the strongly-see kernel, timed at
    the shape the main path launches most (64^3; for the gathered entry
    the frontier probe's TALLY); `by_shape` holds every shape."""
    main_path = rec.get("main_path_launches", {})
    by_mode = main_path.get("by_mode", {})
    counts = {tuple(r["shape"]): r for r in rec.get("kernel_shapes", [])}
    gathered = rec.get("gathered_shapes", [])
    entries = []
    for name, rows, main, launches, extra in (
            ("strongly_see_counts", list(counts.values()), counts.get((64, 64, 64), {}),
             by_mode.get("counts", 0), {"shape": [64, 64, 64]}),
            ("strongly_see_gathered", gathered,
             next((r for r in gathered if r["name"] == "frontier_probe"
                   and r["mode"] == "tally"), {}),
             by_mode.get("matrix", 0) + by_mode.get("tally", 0),
             {"shape": "frontier_probe tally [64, 64, 64, 1]",
              "launches_by_mode": {k: by_mode.get(k, 0) for k in ("matrix", "tally")},
              "launches_by_site": main_path.get("by_site", {}),
              "northstar_launches_by_site":
                  (rec.get("northstar") or {}).get("launches_by_site", {})})):
        err = max((r["max_abs_err"] for r in rows), default=None)
        entries.append({
            "name": name, "route": "cuda",
            "source": "babble_tpu_torch/csrc/strongly_see.cu",
            "replaces": "babble_tpu/ops/pallas_kernels.py:62",
            "launches": launches, "max_abs_err": err, "max_abs_diff": err,
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by"),
            "library_ms": None, **extra, "by_shape": rows})
    return {"kernels": entries}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import babble_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    host = host_name()
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"count {torch.cuda.device_count()}; host: {host}")
    rec = {"device": kind, "nvidia_smi": smi_line, "host": host,
           "torch": torch.__version__, "cuda": torch.version.cuda, "failed": []}

    phases = [("build", phase_build), ("kernel", phase_kernel),
              ("small", phase_small), ("headline", phase_headline),
              ("main_path", phase_main_path_counts), ("profile", phase_profile),
              ("northstar", phase_northstar)]
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(rec)
        except Exception:  # noqa: BLE001 - every phase is reported, then the run fails
            traceback.print_exc()
            rec["failed"].append(name)
            print(f"phase {name}: FAILED", flush=True)
            if name == "build":
                break
        rec.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        sys.stdout.flush()
    rec["total_s"] = time.perf_counter() - t_all

    if not smi_line:
        rec["failed"].append("nvidia-smi")
    print(json.dumps(kernels_line(rec)))
    print(json.dumps({"results": {k: rec.get(k) for k in
                                  ("host", "build", "headline", "main_path_launches",
                                   "profile", "northstar", "phase_s", "total_s")}},
                     default=str))
    print(smi_line)
    if rec["failed"]:
        print(f"chip_smoke: failed phases: {rec['failed']}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
