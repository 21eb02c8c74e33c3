"""The memory-sharded pipeline (babble_tpu_torch/ops/sharded.py) on gloo
rank processes (babble_tpu_torch/parallel.py) on the CPU, against the
JAX package. Tolerance: exact equality of every array.

- the five cases of tests/test_sharded.py::test_sharded_matches_single_device
  (seed 11) on 8 ranks equal the JAX run_pipeline(engine="wavefront"),
  and n64-e5000 also the JAX sharded_pipeline on the 8-device mesh;
  the dcn-ici cases take the composite ("dcn", "ici") axis of a 2 x 4
  mesh, which is the 1-D axis over all ranks once parallel.mesh_axis
  has checked that its a-major index is the rank;
- each rank reaches the strongly-see wrapper once per DAG level in the
  rounds stage and once in fame;
- the chain-sharded coordinates and the event-sharded first
  descendants of each rank (their digests) equal the JAX stages'
  shards, and the shards of the port's single-device tables
  (single_device_table_digests, which the chip check holds config 5's
  ranks to);
- 1, 2 and 4 ranks (e not a multiple of d) equal the same oracle;
- ShardAxis's collectives equal numpy's max, sum, concatenation and
  block transpose;
- a failing rank, or ranks past their deadline, fail the spawn, and no
  rank process is left behind;
- without a CUDA device, sharded_pipeline and spawn_ranks given no
  device raise.

All eight-rank cases run in one spawn (module fixture); every spawn has
its own deadline, so a hung rank fails its test and never stalls the
suite."""

from __future__ import annotations

import multiprocessing

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from babble_tpu.ops import sharded as jsh
from babble_tpu.ops.dag import synthetic_dag as jax_synthetic_dag
from babble_tpu.ops.pipeline import run_pipeline as jax_run_pipeline
from babble_tpu_torch.ops import kernels as tk
from babble_tpu_torch.ops.sharded import (dag_arrays, oracle_equal, run_sharded,
                                          sharded_pipeline, single_device_table_digests,
                                          table_digest)
from babble_tpu_torch.parallel import ShardAxis, collectives_check, spawn_ranks

from test_torch_kernels import carry

CASES = {  # tests/test_sharded.py's cases: (n, e, mesh of the 8 ranks)
    "n8": (8, 400, None),
    "n16": (16, 1000, None),
    "n64-e5000": (64, 5000, None),
    "n8-dcn-ici": (8, 480, ((2, 4), ("dcn", "ici"))),
    "n64-dcn-ici": (64, 5000, ((2, 4), ("dcn", "ici"))),
}
SEED = 11
RANKS = 8
# Seconds each spawn may take, start-up included, before its ranks are
# killed and the test fails.
DEADLINE_S = 600.0


def jax_dag(n, e, seed=SEED):
    return jax_synthetic_dag(n, e, seed=seed)[0]


def jax_oracle(jdag):
    return [np.asarray(x) for x in jax_run_pipeline(jdag, engine="wavefront")]


@pytest.fixture(scope="module")
def eight_ranks():
    """One spawn of 8 gloo ranks for every case; n8 also returns the
    digests of each rank's tables. Records by case name, one per rank."""
    names = list(CASES)
    runs = [{"dag": dag_arrays(carry(jax_dag(n, e))), "mesh": mesh, "tables": name == "n8"}
            for name, (n, e, mesh) in CASES.items()]
    res = spawn_ranks(RANKS, run_sharded, runs, "cpu", backend="gloo", device="cpu",
                      timeout_s=DEADLINE_S)
    return {name: [rank_recs[i] for rank_recs in res] for i, name in enumerate(names)}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_single_device(eight_ranks, case):
    n, e, mesh = CASES[case]
    jdag = jax_dag(n, e)
    recs = eight_ranks[case]
    got = recs[0]["outputs"]
    assert oracle_equal(got, jax_oracle(jdag)) is None
    if case == "n64-e5000":
        jmesh = Mesh(np.array(jax.devices()[:RANKS]), ("sp",))
        want = [np.asarray(x) for x in jsh.sharded_pipeline(jdag, jmesh, axis="sp")]
        assert oracle_equal(got, want) is None
    assert [r["index"] for r in recs] == list(range(RANKS))
    assert all(r["size"] == RANKS and r["backend"] == "gloo" for r in recs)
    # One TALLY call a DAG level at the rounds site and one MATRIX call
    # for every voting round at the fame site, in every rank; the
    # wrapper counts CUDA launches only, none on the CPU.
    for r in recs:
        assert r["sites"] == {"rounds": {"calls": jdag.levels.shape[0], "launches": 0},
                              "fame": {"calls": 1, "launches": 0}}
        assert r["launches"] == {"matrix": 0, "tally": 0} and r["host_bytes"] == 0


def test_stage_tables_match_jax(eight_ranks):
    """Each rank's chain-sharded coordinates [n/8, K, n] and
    event-sharded first descendants [E_pad / 8, n] equal its shard of
    the JAX stages' on the 8-device mesh (by digest)."""
    n, e, _ = CASES["n8"]
    jdag = jax_dag(n, e)
    k = jdag.chain.shape[1]
    e_pad = -(-e // RANKS) * RANKS

    def padded(a, fill):
        out = np.full(e_pad + 1, fill, np.int32)
        out[:e] = np.asarray(a)[:e]
        return out

    sp, op = padded(jdag.self_parent, -1), padded(jdag.other_parent, -1)
    cr, idx = padded(jdag.creator, 0), padded(jdag.index, -1)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("sp",))
    la_cs = jsh.make_last_ancestors(mesh, n=n, k=k)(sp, op, cr, idx, jdag.levels)
    fd_es = jsh.make_first_descendants(mesh, n=n)(la_cs, jdag.chain_len, cr, idx)
    la_cs, fd_es = np.array(la_cs), np.array(fd_es)
    assert la_cs.shape == (n, k, n) and fd_es.shape == (e_pad, n)
    n_loc, e_loc = n // RANKS, e_pad // RANKS
    for p, r in enumerate(eight_ranks["n8"]):
        assert r["tables"] == {
            "la_cs": table_digest(torch.from_numpy(la_cs[p * n_loc: (p + 1) * n_loc])),
            "fd_es": table_digest(torch.from_numpy(fd_es[p * e_loc: (p + 1) * e_loc]))}


def test_single_device_table_digests(eight_ranks):
    """The shards of the port's single-device coordinates and first
    descendants (kernels.compute_last_ancestors,
    compute_first_descendants on the CPU) have each rank's digests."""
    n, e, _ = CASES["n8"]
    dag = carry(jax_dag(n, e))
    t = {f: torch.from_numpy(np.ascontiguousarray(getattr(dag, f)))
         for f in ("self_parent", "other_parent", "creator", "index", "levels", "chain",
                   "chain_len")}
    la = tk.compute_last_ancestors(t["self_parent"], t["other_parent"], t["creator"],
                                   t["index"], t["levels"], n=n)
    fd = tk.compute_first_descendants(la, t["creator"], t["index"], t["chain"],
                                      t["chain_len"], n=n)
    want = single_device_table_digests(la, fd, t["chain"], RANKS)
    assert [r["tables"] for r in eight_ranks["n8"]] == want


@pytest.mark.parametrize("ranks,e", [(1, 400), (2, 403), (4, 402)])
def test_rank_counts_match_oracle(ranks, e):
    jdag = jax_dag(8, e)
    res = spawn_ranks(ranks, run_sharded, [{"dag": dag_arrays(carry(jdag))}], "cpu",
                      backend="gloo", device="cpu", timeout_s=DEADLINE_S)
    assert oracle_equal(res[0][0]["outputs"], jax_oracle(jdag)) is None
    assert [r[0]["size"] for r in res] == [ranks] * ranks


def test_collectives_match_numpy():
    d, rows, cols = 4, 8, 3
    res = spawn_ranks(d, collectives_check, rows, cols, "cpu", backend="gloo",
                      device="cpu", timeout_s=DEADLINE_S)
    xs = [r["x"] for r in res]
    a = rows // d
    for i, r in enumerate(res):
        assert (r["pmax"] == np.max(xs, 0)).all()
        assert (r["psum"] == np.sum(xs, 0)).all()
        assert (r["all_gather"] == np.concatenate(xs)).all()
        # lax.all_to_all(split 0, concat 1, tiled): shard i gets row
        # block i of every shard, side by side in shard order.
        want = np.concatenate([x[i * a:(i + 1) * a] for x in xs], 1)
        assert r["all_to_all"].shape == (a, d * cols) and (r["all_to_all"] == want).all()


def test_failing_rank_fails_the_spawn():
    """Rank 1 raises while rank 0 waits in a collective: the spawn
    raises rank 1's error and kills rank 0."""
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn_ranks(2, collectives_check, 4, 2, "cpu", 1, backend="gloo", device="cpu",
                    timeout_s=DEADLINE_S)
    assert set(multiprocessing.active_children()) <= before


def test_deadline_fails_the_spawn():
    before = set(multiprocessing.active_children())
    with pytest.raises(TimeoutError):
        spawn_ranks(2, collectives_check, 4, 2, "cpu", backend="gloo", device="cpu",
                    timeout_s=0.5)
    assert set(multiprocessing.active_children()) <= before


def test_spawn_refuses_bad_layouts():
    with pytest.raises(ValueError):
        spawn_ranks(2, collectives_check, 4, 2, "cpu", backend="nccl", device="cpu")
    with pytest.raises(ValueError):
        spawn_ranks(2, collectives_check, 4, 2, "cpu", backend="mpi", device="cpu")


def test_sharded_pipeline_without_device_raises(monkeypatch):
    """With no device named the port runs on CUDA; where there is none
    it raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dag = carry(jax_dag(8, 400))
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded_pipeline(dag, ShardAxis(None, 1, 0, "gloo"))
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn_ranks(1, collectives_check, 4, 2, "cpu")
    with pytest.raises(ValueError):
        sharded_pipeline(dag, ShardAxis(None, 3, 0, "gloo"), device="cpu")
