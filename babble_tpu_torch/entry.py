"""The port's top-level entry points (counterparts of __graft_entry__.py).

- entry(device=None): the flagship step, the consensus pipeline
  (DivideRounds -> DecideFame -> FindOrder as tensor sweeps) on a
  synthetic random-gossip DAG, as (fn, args) with the args on the
  device.
- dryrun_multichip(n_devices, device=None): the multi-device consensus
  step, parts (a), (b) and (d) as n_devices rank processes
  (parallel.spawn_ranks, one spawn), part (c) in the calling process:
  (a) replica-parallel consensus: every rank replays the whole DAG's
      consensus, and the ranks agree (the pmax of a digest of the
      order equals its pmin);
  (b) the full pipeline memory-sharded over the ranks (ops/sharded.py),
      equal to the single-device oracle at n = 64, e = max(5000, 24·d);
  (c) the live node's IncrementalEngine with its O(E·n) carries split
      into d shards under one controller (ops/mesh.py, Config.
      engine_mesh), in the calling process after the ranks: n = 16 (or
      2·d), e = 600 in batches of 97, capacity 64, block 64, k_capacity
      8, every RunDelta, the rounds, round received and fame equal to
      the single-device engine's, and the coordinate table physically
      partitioned (d shards whose sizes sum to the whole, none whole).
      JAX gets it by placing the engine's carries with NamedSharding
      and letting GSPMD partition the jitted kernels; the port's engine
      loops over its shards itself;
  (d) for an even d >= 4, the 2 x d/2 ("dcn", "ici") mesh
      (parallel.mesh_axis): its composite axis's a-major index is each
      rank's. Its collectives run over the mesh's ranks flattened, the
      whole group in rank order, so the composite axis is the 1-D axis
      of (b), and (b)'s run is already the sharded pipeline on it; (d)
      adds the layout check, not a second run.

The ranks run gloo on the CPU and wherever d ranks share fewer than d
GPUs, NCCL with a GPU for each rank (default_backend).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .devices import resolve_device
from .ops.dag import synthetic_dag
from .ops.incremental import IncrementalEngine
from .ops.mesh import engine_mesh_devices
from .ops.pipeline import consensus_pipeline, run_pipeline
from .ops.sharded import dag_arrays, oracle_equal, run_sharded
from .parallel import mesh_axis, spawn_ranks

_PIPELINE_ARGS = ("self_parent", "other_parent", "creator", "index", "coin", "levels",
                  "root_round", "chain", "chain_len", "chain_rank")


def entry(device=None):
    """(fn, args): the consensus pipeline step and its arguments, the
    arrays of synthetic_dag(8, 256, seed=0) on `device` (CUDA unless
    the caller names another). fn(*args) gives the six outputs."""
    dev = resolve_device(device)
    dag, _ = synthetic_dag(8, 256, seed=0)
    fn = functools.partial(consensus_pipeline, n=dag.n, sm=dag.super_majority,
                           r=dag.max_rounds, device=dev)
    args = tuple(torch.from_numpy(np.ascontiguousarray(getattr(dag, k))).to(dev)
                 for k in _PIPELINE_ARGS)
    return fn, args


def default_backend(world: int, device) -> str:
    """NCCL where every rank has a GPU of its own, else gloo."""
    dev = torch.device(device)
    return "nccl" if dev.type == "cuda" and world <= torch.cuda.device_count() else "gloo"


def _dryrun_rank(rank, axis, replica, run, mesh, device):
    """Rank side of dryrun_multichip: (a) this rank's replica of the
    small DAG's consensus and the agreement of the ranks' digests, the
    sharded run (b), and (d) the composite axis of `mesh` ((shape,
    names), or None): mesh_axis raises unless its index is the rank."""
    dev = resolve_device(device)
    t = {k: torch.from_numpy(v).to(dev) for k, v in replica["arrays"].items()}
    out = consensus_pipeline(**t, n=replica["n"], sm=replica["sm"], r=replica["r"],
                             device=dev)
    rr, cts = out[4], out[5]
    digest = (rr * 7 + cts * 3).sum(dtype=torch.int32).view(1)
    hi = axis.pmax(digest.clone())
    lo = -axis.pmax(-digest)
    sharded = run_sharded(rank, axis, [run], dev)[0]
    if mesh is not None:
        mesh_axis(*mesh, axis.backend, dev)
    return {"agree": bool(hi == lo), "rr": rr.cpu().numpy(), "sharded": sharded}


def engine_mesh_check(n_devices: int, device) -> dict:
    """Part (c) (module docstring) in this process, on `device`: the
    shards go where a node's Config.engine_mesh puts them (cuda:(p mod
    the card count), or the device itself off CUDA). Raises
    AssertionError on a mismatch; returns the sizes, the seconds of
    each engine and the decided events."""
    dev = resolve_device(device)
    n3 = 16 if 16 % n_devices == 0 else 2 * n_devices
    e3, bs3 = 600, 97
    dag, _ = synthetic_dag(n3, e3, seed=5)
    kw = dict(capacity=64, block=64, k_capacity=8)
    ref = IncrementalEngine(n3, device=dev, **kw)
    eng = IncrementalEngine(n3, mesh=engine_mesh_devices(n_devices, n3, dev) or [dev], **kw)
    seconds = {"single": 0.0, "mesh": 0.0}
    try:
        for k in range(0, e3, bs3):
            hi = min(k + bs3, e3)
            deltas = []
            for name, g in (("single", ref), ("mesh", eng)):
                g.append_batch(dag.self_parent[k:hi], dag.other_parent[k:hi],
                               dag.creator[k:hi], dag.index[k:hi], dag.coin[k:hi],
                               np.arange(k, hi))
                t0 = time.perf_counter()
                deltas.append(g.run())
                seconds[name] += time.perf_counter() - t0
            if deltas[0] != deltas[1]:
                raise AssertionError(f"mesh engine's RunDelta of events [{k}, {hi}) "
                                     "!= single-device")
    finally:
        ref.close()
        eng.close()
    for name in ("rounds", "rr", "famous"):
        if not np.array_equal(getattr(eng, name), getattr(ref, name)):
            raise AssertionError(f"mesh engine {name} != single-device")
    la_total = (ref.cap + 1) * n3
    per_shard = [t.numel() for t in eng.shards("_la")]
    if len(per_shard) != n_devices or sum(per_shard) != la_total or (
            n_devices > 1 and max(per_shard) >= la_total):
        raise AssertionError(f"mesh engine coordinate table is not partitioned: {per_shard}")
    return {"n": n3, "e": e3, "batch": bs3, "shards": n_devices,
            "la_shard_elems": per_shard, "seconds": seconds,
            "decided": int((eng.rr[:e3] >= 0).sum())}


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 900.0):
    """Run parts (a), (b) and (d) (module docstring) on n_devices ranks
    on `device` (CUDA unless the caller names another), then part (c)
    in this process, and raise AssertionError where a part fails.
    Prints one line and returns a record: the backend, the seconds of
    the spawn and of the sharded run (the slowest rank), the decided
    events and the oracle's last round, the collectives a rank made,
    the ranks' host seconds in them, bytes through host memory and peak
    device memory, each rank's strongly-see launches by site, (d)'s
    mesh and (c)'s engine_mesh_check record."""
    dev = resolve_device(device)
    backend = default_backend(n_devices, dev)
    small, _ = synthetic_dag(4, 64, seed=0)
    replica = {"n": small.n, "sm": small.super_majority, "r": small.max_rounds,
               "arrays": {k: np.ascontiguousarray(getattr(small, k)) for k in _PIPELINE_ARGS}}
    n2 = 64 if 64 % n_devices == 0 else 8 * n_devices
    dag, _ = synthetic_dag(n2, max(5000, 24 * n_devices), seed=1)
    two_level = n_devices % 2 == 0 and n_devices >= 4
    mesh = ((2, n_devices // 2), ("dcn", "ici")) if two_level else None
    ref = [o.cpu().numpy() for o in run_pipeline(dag, engine="wavefront", device=dev)]
    if dev.type == "cuda":  # one build, before the ranks load it
        from .ops import hopper_kernels

        hopper_kernels.build(hopper_kernels.SOURCES[0])
    t0 = time.perf_counter()
    res = spawn_ranks(n_devices, _dryrun_rank, replica, {"dag": dag_arrays(dag)}, mesh,
                      str(dev), backend=backend, device=dev, timeout_s=timeout_s)
    spawn_s = time.perf_counter() - t0

    if not all(r["agree"] for r in res):
        raise AssertionError("replicas disagree on consensus")
    if any((r["rr"] != res[0]["rr"]).any() for r in res):
        raise AssertionError("round-received mismatch across replicas")
    bad = oracle_equal(res[0]["sharded"]["outputs"], ref)
    if bad is not None:
        raise AssertionError(f"sharded pipeline {bad} != oracle")
    decided = int((ref[4] >= 0).sum())
    engine = engine_mesh_check(n_devices, dev)
    print(f"dryrun_multichip ok: {n_devices} ranks ({backend}, {dev.type}), "
          f"replica-parallel consensus agreed, sharded pipeline == oracle "
          f"({decided} consensus events)"
          + (f", 2x{n_devices // 2} dcn*ici mesh index a-major" if two_level else "")
          + f", {n_devices}-shard engine == single-device ({engine['decided']} decided)")
    return {
        "ranks": n_devices, "backend": backend, "device": str(dev), "n": n2, "e": dag.e,
        "decided": decided, "max_round": int(ref[0].max()), "spawn_s": spawn_s,
        "mesh": mesh, "engine_mesh": engine,
        "run": {"seconds": max(r["sharded"]["seconds"] for r in res),
                "host_bytes": [r["sharded"]["host_bytes"] for r in res],
                "collectives": res[0]["sharded"]["collectives"],
                "collective_s": [r["sharded"]["collective_s"] for r in res],
                "peak_mem_bytes": [r["sharded"]["peak_mem_bytes"] for r in res],
                "sites": [r["sharded"]["sites"] for r in res],
                "launches": [r["sharded"]["launches"] for r in res]}}
