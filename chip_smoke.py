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
              by site;
9. sustained — the live node's incremental engine (IncrementalEngine,
              n = 64, capacity 65,536, block 512, k_capacity 1,024) fed
              synthetic_dag(64, 50_000, seed=3) in batches of 4,096
              with pipelined append / collect / dispatch, as bench.py's
              sustained stage drives it: events/s total and steady,
              phase shares, launches by site, host reads and redos per
              pass; its final state equal to the one-shot run_pipeline
              on the card and to the JAX reference package's digest
              (GOLDEN_SUSTAINED_*);
10. sustained_profile — the same engine with run() per batch: phase
              shares of passes 3-6 with synchronised timers; pass 7
              under torch.cuda.set_sync_debug_mode("warn"), which must
              flag exactly one host read per frontier round; pass 8 (a
              steady pass) under torch.profiler: the card's busy share,
              device time by kernel, host waits;
11. northstar_incremental — the engine at n = 1024 (capacity 131,072,
              block 512, k_capacity 512), run() per batch of 4,096 over
              the north-star DAG: time, peak memory, launches by site,
              44,770 decided and the state equal to the one-shot run.

Each path that launches the kernel (the one-shot main path, sustained,
northstar_incremental) runs with every launch count set to 0 just
before it and read just after, and fails when the kernel was not
launched. Lines before the last: a {"kernels": [...]} line (launches on
the engine's path and on each path, max error, times and bound), a
{"results": ...} line, and the nvidia-smi line. The last line is
{"ok": true, "device": {...}}.

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
# The JAX reference package's IncrementalEngine driven by the sustained
# loop (phase_sustained) on synthetic_dag(64, 50_000, seed=3), on the
# CPU. INPUT is dag_digest of the DAG, OUTPUT the digest of the final
# engine state (engine_state); the JAX package's one-shot run_pipeline
# gives the same state on that DAG.
GOLDEN_SUSTAINED_INPUT = "cf72c67e8f934420b8c4c573d9f504a2aab7a0fb8b62eb56b57d882ecb5b00b9"
GOLDEN_SUSTAINED_OUTPUT = "7ab267e5879b54e80675a08a12d074bf8000d8d2f79d1a530641c2d41cc41b48"
SUSTAINED = (64, 50_000, 3)
SUSTAINED_DECIDED = 47_935
SUSTAINED_ENGINE = dict(capacity=65536, block=512, k_capacity=1024)
NORTHSTAR_ENGINE = dict(capacity=131072, block=512, k_capacity=512)
ENGINE_BATCH = 4096
PROFILED_BATCH = 8  # the steady pass sustained_profile traces
KERNEL_SHAPES = [(5, 7, 4), (64, 64, 64), (130, 200, 100), (1024, 1024, 1024)]
# The gathered entry at the main path's shapes: (name, M rows, W witness
# slots, n, R witness rows, how rows name witness rows).
# - fame_batch: decide_fame at the headline, r_small - 1 = 127 voting
#   rounds x 64 witnesses, every 64-row tile naming one round;
# - frontier_probe: one probe (or skip correction) at the headline;
# - northstar_level: compute_rounds on a 1024-wide level at n = 1024,
#   rows naming two adjacent parent rounds at random, as a level's do;
# - ragged: nothing a multiple of the tile, five witness rows mixed;
# - engine_fame_window / northstar_engine_fame: the incremental engine's
#   fame launch over a 16-round window (15 voting rounds) at n = 64 and
#   n = 1024, against the window's compact witness-row table;
# - northstar_engine_probe: the engine's frontier probe at n = 1024.
GATHERED_SHAPES = [
    ("fame_batch", 127 * 64, 64, 64, 127, "tiles"),
    ("frontier_probe", 64, 64, 64, 1, "one"),
    ("northstar_level", 1024, 1024, 1024, 7, "two"),
    ("ragged", 130, 200, 100, 5, "mixed"),
    ("engine_fame_window", 15 * 64, 64, 64, 15, "tiles"),
    ("northstar_engine_fame", 15 * 1024, 1024, 1024, 15, "tiles"),
    ("northstar_engine_probe", 1024, 1024, 1024, 1, "one"),
]
# The pipeline functions that call strongly_see_gathered, by site.
SITES = {"decide_fame": "fame", "sees_sm": "frontier_probe",
         "step": "skip_correction", "compute_rounds": "compute_rounds"}
ENGINE_SITES = ("fame", "frontier_probe", "skip_correction")

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
    from torch.profiler import ProfilerActivity, profile

    from babble_tpu_torch.ops.dag import synthetic_dag

    n, e, seed = HEADLINE
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    _timed_run(dag, s_rank, "auto", device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s, _, _ = _timed_run(dag, s_rank, "auto", device)
    rec["profile"] = p = {"engine": "auto", **profile_summary(prof, wall_s)}
    if "device_busy_s" not in p:
        print("profile: the profiler recorded no device activity: not measured")
        return
    print(f"profile (headline, engine=auto, profiled run {wall_s:.3f} s): "
          f"{p['kernel_launches']} kernels, device busy {p['device_busy_s']:.3f} s "
          f"= {p['device_busy_share']:.1%} of wall; strongly_see {p['strongly_see']}")
    for row in p["top_kernels_us"]:
        print(f"  {row['us'] / 1e3:9.2f} ms  x{row['count']:6d}  {row['name']}")


def profile_summary(prof, wall_s) -> dict:
    """The card's busy time (union of kernel intervals) and share of
    `wall_s`, device time by kernel, and B1's device time per launch,
    from a torch.profiler run; "not measured" where the profiler
    recorded no device activity."""
    from torch.autograd import DeviceType

    events = prof.events()
    kern = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    # Host waits on the card, as the CUDA runtime calls that make them.
    syncs = {}
    for ev in events:
        if ev.device_type != DeviceType.CUDA and "Synchronize" in ev.name:
            syncs[ev.name] = syncs.get(ev.name, 0) + 1
    if not kern:
        return {"wall_s": wall_s, "device_busy_share": "not measured",
                "sync_calls": syncs}
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
    return {
        "wall_s": wall_s, "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall_s, "kernel_launches": len(kern),
        "strongly_see": ss, "sync_calls": syncs,
        "top_kernels_us": [{"name": k[:120], "us": v[0], "count": v[1]} for k, v in top]}


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
    rec["_northstar_out"] = out  # held against northstar_incremental
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


def engine_state(eng, e):
    """The engine's final state, as GOLDEN_SUSTAINED_OUTPUT digests it."""
    return [eng.rounds[:e], eng.witness[:e], eng.witness_table(), eng.famous,
            eng.rr[:e], eng.cts_ns[:e]]


def engine_vs_one_shot(eng, out, e) -> list:
    """Names of the one-shot outputs (rounds, witness, wt, famous, rr,
    cts on the host) the engine's state disagrees with. The DAG's
    timestamps are its event ids, so a consensus-timestamp rank is the
    engine's ns, and rank -1 (Go's zero time) its CTS_SENTINEL."""
    from babble_tpu_torch.ops.incremental import CTS_SENTINEL

    rounds, wit, wt, famous, rr, cts = out
    wt_abs = eng.witness_table()
    rt = wt_abs.shape[0]
    dec = rr >= 0
    checks = {
        "rounds": (eng.rounds[:e] == rounds).all(),
        "witness": (eng.witness[:e] == wit).all(),
        "wt": (wt_abs == wt[:rt]).all() and (wt[rt:] == -1).all(),
        "famous": eng.famous.shape[0] == rt and (eng.famous == famous[:rt]).all(),
        "rr": (eng.rr[:e] == rr).all(),
        "cts": (eng.cts_ns[:e][dec]
                == np.where(cts < 0, CTS_SENTINEL, cts.astype(np.int64))[dec]).all(),
    }
    return [k for k, ok in checks.items() if not ok]


def engine_batches(dag, e, bs=ENGINE_BATCH):
    """The append_batch arguments of each batch, timestamps = event ids
    (as bench.py feeds the engine)."""
    for k in range(0, e, bs):
        hi = min(k + bs, e)
        yield (dag.self_parent[k:hi], dag.other_parent[k:hi], dag.creator[k:hi],
               dag.index[k:hi], dag.coin[k:hi], np.arange(k, hi))


def check_engine_sites(name, launches, sites) -> None:
    """An engine path launches the gathered kernel from the frontier
    probe, the skip correction and fame, and nothing else."""
    if set(sites) != set(ENGINE_SITES) or min(sites.values()) == 0:
        raise AssertionError(f"{name}: launches by site {sites}, expected {ENGINE_SITES}")
    if launches["counts"] != 0 or launches["matrix"] != sites["fame"] or \
            launches["tally"] != sites["frontier_probe"] + sites["skip_correction"]:
        raise AssertionError(f"{name}: launches {launches} by site {sites}")


def phase_sustained(rec, device="cuda"):
    """bench.py's sustained stage on the port: pipelined append /
    collect / dispatch in batches of 4,096, with the per-batch
    host-blocking wall, phase totals from the fourth pass on, launches
    by site, and the host reads and redos of every pass; then the final
    state against the JAX golden digest and the one-shot pipeline."""
    import torch

    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.incremental import IncrementalEngine
    from babble_tpu_torch.ops.pipeline import run_pipeline

    n, e_sus, seed = SUSTAINED
    dag, s_rank = synthetic_dag(n, e_sus, seed=seed)
    in_digest = dag_digest(dag, s_rank)
    if in_digest != GOLDEN_SUSTAINED_INPUT:
        raise AssertionError(f"sustained input digest {in_digest} != golden")
    eng = IncrementalEngine(n, device=device, **SUSTAINED_ENGINE)
    phase_tot, passes = {}, []
    overlap_ns = 0
    prof_from = 3  # the first passes pay the allocator's first allocations

    def harvest(b_i):
        nonlocal overlap_ns
        passes.append({"host_syncs": eng.host_syncs, "redo_count": eng.redo_count,
                       "windows": dict(eng._dbg_windows), "pull_bytes": eng.c_pull_bytes})
        if b_i >= prof_from:
            for ph, ns in eng.phase_ns.items():
                phase_tot[ph] = phase_tot.get(ph, 0) + ns
            overlap_ns += eng.last_overlap_ns

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with launches_by_site() as sites:
        t0 = time.perf_counter()
        per_batch = []
        pending = None
        b_i = 0
        for batch in engine_batches(dag, e_sus):
            tb = time.perf_counter()
            eng.append_batch(*batch)
            if pending is not None:
                eng.collect(pending)
                harvest(b_i)
            pending = eng.dispatch()
            per_batch.append(time.perf_counter() - tb)
            b_i += 1
        if pending is not None:
            eng.collect(pending)
            harvest(b_i)
        pending = eng.dispatch()  # appends staged during the last pass
        if pending is not None:
            eng.collect(pending)
            harvest(b_i + 1)
        total = time.perf_counter() - t0
    launches = read_launches()
    eng.close()
    if e_sus % ENGINE_BATCH:
        per_batch = per_batch[:-1]
    half = per_batch[len(per_batch) // 2:]
    steady = statistics.median(half)
    decided = int((eng.rr[:e_sus] >= 0).sum())
    top = {ph: ns for ph, ns in phase_tot.items() if ph not in ("c_pull_wait", "c_pull_xfer")}
    # frontier / rounds / fame_rr split c_dispatch, as wait / xfer split c_pull
    share_keys = ("coords", "fd_fold", "stage", "c_dispatch", "c_stage_wait", "c_pull",
                  "consensus", "apply")
    denom = sum(top.get(k, 0) for k in share_keys) or 1
    out_digest = digest(engine_state(eng, e_sus))
    res = {
        "n": n, "e": e_sus, "seed": seed, "batch": ENGINE_BATCH, "engine": SUSTAINED_ENGINE,
        "total_s": total, "events_per_s": e_sus / total,
        "steady_batch_s": steady, "steady_events_per_s": ENGINE_BATCH / steady,
        "per_batch_s": per_batch, "decided": decided, "redo_count": eng.redo_count,
        "passes": len(passes), "per_pass": passes,
        "host_syncs_per_pass": [p["host_syncs"] for p in passes],
        "phase_ms": {k: v / 1e6 for k, v in phase_tot.items()},
        "phase_share": {k: top.get(k, 0) / denom for k in share_keys},
        "part_share": {k: phase_tot.get(k, 0) / denom
                       for k in ("frontier", "rounds", "fame_rr", "c_pull_wait", "c_pull_xfer")},
        "overlap_ms": overlap_ns / 1e6, "launches": launches, "launches_by_site": sites,
        "launches_per_pass": {k: v / len(passes) for k, v in sites.items()},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "output_digest": out_digest}
    rec["sustained"] = res
    print(f"sustained: n={n} e={e_sus} batch={ENGINE_BATCH}: {total:.2f} s "
          f"({e_sus / total:,.0f} events/s), steady {ENGINE_BATCH / steady:,.0f} events/s "
          f"(median {steady * 1e3:.1f} ms of the second half, spread "
          f"{min(half) * 1e3:.1f}-{max(half) * 1e3:.1f} ms), {decided} decided, "
          f"{len(passes)} passes, redo_count {eng.redo_count}, host reads per pass "
          f"{res['host_syncs_per_pass']}")
    print(f"sustained launches {launches} by site {sites}; per pass "
          + json.dumps({k: round(v, 1) for k, v in res["launches_per_pass"].items()}))
    print("sustained phase shares: " + json.dumps(
        {k: round(v, 4) for k, v in {**res["phase_share"], **res["part_share"]}.items()}))
    print(f"sustained peak device memory {res['peak_mem_bytes'] / 2**30:.2f} GiB; "
          f"state digest {'ok' if out_digest == GOLDEN_SUSTAINED_OUTPUT else 'MISMATCH'}")
    if launches["matrix"] == 0 or launches["tally"] == 0:
        raise AssertionError(f"sustained launches {launches}: a kernel was never launched")
    check_engine_sites("sustained", launches, sites)
    if decided != SUSTAINED_DECIDED:
        raise AssertionError(f"sustained: {decided} decided != {SUSTAINED_DECIDED}")
    if out_digest != GOLDEN_SUSTAINED_OUTPUT:
        raise AssertionError(f"sustained: state digest {out_digest} != golden")
    one_shot = host(run_pipeline(dag, device=device))
    bad = engine_vs_one_shot(eng, one_shot, e_sus)
    res["equal_to_one_shot"] = not bad
    print(f"sustained state == one-shot run_pipeline on the card: {not bad}")
    if bad:
        raise AssertionError(f"sustained: engine differs from the one-shot run in {bad}")


def sync_warnings(fn) -> int:
    """Run fn() under torch.cuda.set_sync_debug_mode("warn") and count
    the synchronizing torch operations it flags, on every thread."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def phase_sustained_profile(rec, device="cuda"):
    """The sustained engine fed batch by batch with run(): passes 3-6
    with synchronised phase timers (each phase's share including its
    device work); pass 7 under the sync debug mode, which must flag
    exactly the engine's own host reads but the pulls (one flag read
    per frontier round); pass PROFILED_BATCH, a steady pass, under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.incremental import IncrementalEngine

    n, e_sus, seed = SUSTAINED
    dag, _ = synthetic_dag(n, e_sus, seed=seed)
    eng = IncrementalEngine(n, device=device, **SUSTAINED_ENGINE)
    timed = range(3, PROFILED_BATCH - 1)
    phase_tot = {}
    flagged = expected = None
    timers = os.environ.pop("BABBLE_ENGINE_TIMERS", None)  # untimed unless set here
    try:
        for b_i, batch in enumerate(engine_batches(dag, e_sus)):
            eng.append_batch(*batch)
            if b_i in timed:
                os.environ["BABBLE_ENGINE_TIMERS"] = "1"
                try:
                    eng.run()
                finally:
                    os.environ.pop("BABBLE_ENGINE_TIMERS")
                for ph, ns in eng.phase_ns.items():
                    phase_tot[ph] = phase_tot.get(ph, 0) + ns
            elif b_i == PROFILED_BATCH - 1:
                redo0 = eng.redo_count
                flagged = sync_warnings(eng.run)
                expected = eng.host_syncs - (1 + eng.redo_count - redo0)
            elif b_i < PROFILED_BATCH:
                eng.run()
            else:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    eng.run()
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
                break
    finally:
        eng.close()
        if timers is not None:
            os.environ["BABBLE_ENGINE_TIMERS"] = timers
    parts = ("coords", "fd_fold", "frontier", "rounds", "fame_rr", "stage", "c_pull",
             "consensus", "apply")
    denom = sum(phase_tot.get(k, 0) for k in parts) or 1
    p = {"batch": PROFILED_BATCH, "host_syncs": eng.host_syncs,
         "windows": dict(eng._dbg_windows),
         "synced_passes": [timed.start, timed.stop - 1],
         "synced_phase_ms": {k: v / 1e6 for k, v in phase_tot.items()},
         "synced_phase_share": {k: phase_tot.get(k, 0) / denom for k in parts},
         "sync_debug_flagged": flagged, "frontier_reads": expected,
         "profiled_pass_phase_ms": {k: v / 1e6 for k, v in eng.phase_ns.items()},
         **profile_summary(prof, wall_s)}
    rec["sustained_profile"] = p
    print(f"sustained synced phase shares (passes {timed.start}-{timed.stop - 1}): "
          + json.dumps({k: round(v, 4) for k, v in p["synced_phase_share"].items()}))
    print(f"sustained pass {PROFILED_BATCH - 1} under the sync debug mode: {flagged} "
          f"synchronizing operations flagged, {expected} frontier flag reads")
    if flagged != expected:
        raise AssertionError(f"sync debug mode flagged {flagged} host reads, the engine "
                             f"counts {expected} frontier flag reads")
    if "device_busy_s" not in p:
        print("sustained profile: the profiler recorded no device activity: not measured")
        return
    print(f"sustained profile (run() of batch {PROFILED_BATCH}, {wall_s * 1e3:.1f} ms, "
          f"{eng.host_syncs} host reads, windows {p['windows']}): "
          f"{p['kernel_launches']} kernels, device busy {p['device_busy_s'] * 1e3:.2f} ms "
          f"= {p['device_busy_share']:.1%} of wall; strongly_see {p['strongly_see']}; "
          f"host waits {p['sync_calls']}")
    for row in p["top_kernels_us"]:
        print(f"  {row['us'] / 1e3:9.3f} ms  x{row['count']:6d}  {row['name']}")


def phase_northstar_incremental(rec, device="cuda"):
    """bench.py's north-star incremental stage on the port: run() per
    batch of 4,096 over synthetic_dag(1024, 100_000, seed=2)."""
    import torch

    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.incremental import IncrementalEngine
    from babble_tpu_torch.ops.pipeline import run_pipeline

    n, e, seed = NORTHSTAR
    dag, _ = synthetic_dag(n, e, seed=seed)
    one_shot = rec.get("_northstar_out") or host(run_pipeline(dag, device=device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = IncrementalEngine(n, device=device, **NORTHSTAR_ENGINE)
    per_b, syncs = [], []
    phase_tot = {}
    reset_launches()
    with launches_by_site() as sites:
        t0 = time.perf_counter()
        for batch in engine_batches(dag, e):
            eng.append_batch(*batch)
            tb = time.perf_counter()
            eng.run()
            per_b.append(time.perf_counter() - tb)
            syncs.append(eng.host_syncs)
            for ph, ns in eng.phase_ns.items():
                phase_tot[ph] = phase_tot.get(ph, 0) + ns
        total = time.perf_counter() - t0
    launches = read_launches()
    eng.close()
    half = per_b[len(per_b) // 2:]
    steady = statistics.median(half)
    decided = int((eng.rr[:e] >= 0).sum())
    res = {
        "n": n, "e": e, "seed": seed, "batch": ENGINE_BATCH, "engine": NORTHSTAR_ENGINE,
        "total_s": total, "events_per_s": e / total, "steady_batch_s": steady,
        "steady_events_per_s": ENGINE_BATCH / steady, "per_batch_s": per_b,
        "decided": decided, "redo_count": eng.redo_count, "host_syncs_per_pass": syncs,
        "phase_ms": {k: v / 1e6 for k, v in phase_tot.items()},
        "launches": launches, "launches_by_site": sites,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "memory_stats": eng.device_memory_stats()}
    rec["northstar_incremental"] = res
    print(f"northstar incremental: n={n} e={e} batch={ENGINE_BATCH}: {total:.2f} s "
          f"({e / total:,.0f} events/s), steady {ENGINE_BATCH / steady:,.0f} events/s, "
          f"{decided} decided, redo_count {eng.redo_count}, host reads per pass {syncs}, "
          f"peak {res['peak_mem_bytes'] / 2**30:.2f} GiB, launches {launches} by site {sites}")
    print("northstar incremental phases (ms): " + json.dumps(
        {k: round(v, 1) for k, v in res["phase_ms"].items()}))
    check_engine_sites("northstar_incremental", launches, sites)
    if decided != NORTHSTAR_DECIDED:
        raise AssertionError(f"northstar incremental: {decided} != {NORTHSTAR_DECIDED}")
    bad = engine_vs_one_shot(eng, one_shot, e)
    res["equal_to_one_shot"] = not bad
    print(f"northstar incremental state == one-shot run_pipeline on the card: {not bad}")
    if bad:
        raise AssertionError(f"northstar incremental differs from the one-shot run in {bad}")


def kernels_line(rec) -> dict:
    """One entry per entry point of the strongly-see kernel, timed at
    the shape the main path launches most (64^3; for the gathered entry
    the frontier probe's TALLY); `by_shape` holds every shape.
    `launches` are those of the incremental engine's sustained run (the
    live node's path); `launches_by_path` gives every path's."""
    main_path = rec.get("main_path_launches", {})
    engine_path = rec.get("sustained") or {}
    by_mode = engine_path.get("launches", {})
    by_path = {"one_shot_headline": {"by_mode": main_path.get("by_mode"),
                                     "by_site": main_path.get("by_site")}}
    for name in ("sustained", "northstar_incremental"):
        r = rec.get(name) or {}
        by_path[name] = {"by_mode": r.get("launches"), "by_site": r.get("launches_by_site")}
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
              "launches_on": "sustained (the incremental engine)",
              "launches_by_mode": {k: by_mode.get(k, 0) for k in ("matrix", "tally")},
              "launches_by_site": engine_path.get("launches_by_site", {}),
              "launches_by_path": by_path,
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
              ("northstar", phase_northstar), ("sustained", phase_sustained),
              ("sustained_profile", phase_sustained_profile),
              ("northstar_incremental", phase_northstar_incremental)]
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
                                   "profile", "northstar", "sustained",
                                   "sustained_profile", "northstar_incremental",
                                   "phase_s", "total_s")}},
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
