"""Each ported consensus kernel (babble_tpu_torch/ops/kernels.py) against
its JAX twin (babble_tpu/ops/kernels.py), fed the same inputs, on the
CPU. Tolerance: exact equality of every int32/bool output.

DAGs: random gossip from synthetic_dag (n = 4, 8, 16), and the
reference's signed fixture graphs (round, consensus, funky) built by
the JAX package's build_dag and carried across with dag_from_arrays.
The coin world (build_coin_graph, coin forced to 0 and to 1) covers
decide_fame's coin-round branch."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from babble_tpu.ops import build_dag
from babble_tpu.ops import kernels as jk
from babble_tpu.ops.dag import synthetic_dag as jax_synthetic_dag
from babble_tpu.ops.pipeline import tight_round_bucket
from babble_tpu_torch.ops import kernels as tk
from babble_tpu_torch.ops.dag import dag_from_arrays

from fixtures import (
    build_coin_graph,
    build_consensus_graph,
    build_funky_graph,
    build_round_graph,
)

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

CARRIED_FIELDS = ("n", "e", "self_parent", "other_parent", "creator", "index",
                  "coin", "ts_rank", "ts_values", "levels", "depth", "chain",
                  "chain_len", "chain_rank", "root_round", "hexes")


def carry(jdag):
    """The port's DagTensors from a JAX-side DagTensors."""
    return dag_from_arrays(**{k: getattr(jdag, k) for k in CARRIED_FIELDS})


def fixture_dag(name):
    """(JAX DagTensors, GraphBuilder) of a reference fixture graph."""
    if name.startswith("coin"):
        b = build_coin_graph()
    else:
        _, b = {"round": build_round_graph, "consensus": build_consensus_graph,
                "funky": build_funky_graph}[name]()
    jdag = build_dag(b.ordered_events, b.participants())
    if name.startswith("coin"):
        jdag.coin[:] = int(name[-1])  # coin0 / coin1: every coin forced
    return jdag, b


DAGS = ["syn4", "syn8", "syn16", "round", "consensus", "funky", "coin0", "coin1"]
SYNTHETIC = {"syn4": (4, 60, 0), "syn8": (8, 300, 1), "syn16": (16, 600, 2)}


@functools.lru_cache(maxsize=None)
def reference(name):
    """JAX DAG plus every intermediate of the wavefront pipeline."""
    if name in SYNTHETIC:
        n, e, seed = SYNTHETIC[name]
        jdag, _ = jax_synthetic_dag(n, e, seed=seed)
    else:
        jdag, _ = fixture_dag(name)
    n, sm, r = jdag.n, jdag.super_majority, jdag.max_rounds
    la = np.asarray(jk.compute_last_ancestors(
        jdag.self_parent, jdag.other_parent, jdag.creator, jdag.index,
        jdag.levels, n=n))
    cube = np.asarray(jk.first_descendant_cube(la, jdag.chain, jdag.chain_len, n=n))
    fd = np.asarray(jk.fd_from_cube(cube, jdag.creator, jdag.index, n=n))
    rounds, wit, wt = (np.asarray(x) for x in jk.compute_rounds(
        jdag.self_parent, jdag.other_parent, jdag.creator, jdag.index, la, fd,
        jdag.levels, jdag.root_round, n=n, sm=sm, r=r))
    r_small = tight_round_bucket(rounds, r)
    wt_s = wt[:r_small]
    famous = np.asarray(jk.decide_fame(wt_s, la, fd, jdag.index, jdag.coin,
                                       n=n, sm=sm, r=r_small))
    rr, cts = (np.asarray(x) for x in jk.decide_round_received(
        rounds, wt_s, famous, la, fd, jdag.creator, jdag.index, jdag.chain_rank,
        n=n, r=r_small))
    return dict(dag=jdag, port=carry(jdag), la=la, cube=cube, fd=fd,
                rounds=rounds, wit=wit, wt=wt, r_small=r_small, famous=famous,
                rr=rr, cts=cts)


def T(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def same(got, want):
    got = got.numpy()
    assert got.shape == want.shape
    assert (got == want).all()


@pytest.mark.parametrize("name", DAGS)
def test_compute_last_ancestors(name):
    ref = reference(name)
    d = ref["port"]
    got = tk.compute_last_ancestors(T(d.self_parent), T(d.other_parent),
                                    T(d.creator), T(d.index), T(d.levels), n=d.n)
    assert got.dtype == torch.int32
    same(got, ref["la"])


@pytest.mark.parametrize("name", DAGS)
def test_first_descendant_cube_and_gather(name):
    ref = reference(name)
    d = ref["port"]
    cube = tk.first_descendant_cube(T(ref["la"]), T(d.chain), T(d.chain_len), n=d.n)
    same(cube, ref["cube"])
    same(tk.fd_from_cube(T(ref["cube"]), T(d.creator), T(d.index), n=d.n), ref["fd"])
    same(tk.compute_first_descendants(T(ref["la"]), T(d.creator), T(d.index),
                                      T(d.chain), T(d.chain_len), n=d.n), ref["fd"])


@pytest.mark.parametrize("name", DAGS)
def test_compute_rounds(name):
    ref = reference(name)
    d = ref["port"]
    rounds, wit, wt = tk.compute_rounds(
        T(d.self_parent), T(d.other_parent), T(d.creator), T(d.index),
        T(ref["la"]), T(ref["fd"]), T(d.levels), T(d.root_round),
        n=d.n, sm=d.super_majority, r=d.max_rounds)
    same(rounds, ref["rounds"])
    same(wit, ref["wit"])
    same(wt, ref["wt"])


def test_compute_rounds_chunked_levels(monkeypatch):
    """A level wider than the chunk budget: the clamped final chunk of
    the per-level strongly-see loop must agree with the reference."""
    ref = reference("syn16")
    d = ref["port"]
    real = tk.chunk_width
    monkeypatch.setattr(tk, "chunk_width", lambda w, row, budget=1 << 26: real(w, row, 3 * row))
    rounds, wit, wt = tk.compute_rounds(
        T(d.self_parent), T(d.other_parent), T(d.creator), T(d.index),
        T(ref["la"]), T(ref["fd"]), T(d.levels), T(d.root_round),
        n=d.n, sm=d.super_majority, r=d.max_rounds)
    assert d.levels.shape[1] % 3  # the last chunk overlaps
    same(rounds, ref["rounds"])
    same(wt, ref["wt"])


@pytest.mark.parametrize("name", DAGS)
def test_strongly_see_counts_chunked(name):
    ref = reference(name)
    d, wt, j = ref["port"], ref["wt"], 1
    ys = np.where(wt[j] >= 0, wt[j], 0)
    wp = np.where(wt[j - 1] >= 0, wt[j - 1], 0)
    la_y, fd_p = ref["la"][ys], ref["fd"][wp]
    want = np.asarray(jk.strongly_see_counts_chunked(la_y, fd_p, n=d.n))
    same(tk.strongly_see_counts_chunked(T(la_y), T(fd_p)), want)


@pytest.mark.parametrize("name", DAGS)
def test_decide_fame(name):
    ref = reference(name)
    d, r = ref["port"], ref["r_small"]
    famous = tk.decide_fame(T(ref["wt"][:r]), T(ref["la"]), T(ref["fd"]),
                            T(d.index), T(d.coin), n=d.n, sm=d.super_majority, r=r)
    same(famous, ref["famous"])


def test_coin_worlds_differ():
    """The coin is load-bearing in the coin world: forcing it to 0 or
    1 changes the fame table, so the parity above covers both arms of
    decide_fame's coin branch."""
    assert (reference("coin0")["famous"] != reference("coin1")["famous"]).any()


@pytest.mark.parametrize("name", DAGS)
def test_decide_round_received(name):
    ref = reference(name)
    d, r = ref["port"], ref["r_small"]
    rr, cts = tk.decide_round_received(
        T(ref["rounds"]), T(ref["wt"][:r]), T(ref["famous"]), T(ref["la"]),
        T(ref["fd"]), T(d.creator), T(d.index), T(d.chain_rank), n=d.n, r=r)
    same(rr, ref["rr"])
    same(cts, ref["cts"])


@pytest.mark.parametrize("w,row,budget", [(1, 1, 1 << 26), (130, 200 * 100, 7 * 200 * 100),
                                          (97, 0, 1 << 26), (4096, 1 << 20, 1 << 26)])
def test_chunk_width(w, row, budget):
    assert tk.chunk_width(w, row, budget) == jk.chunk_width(w, row, budget)


def test_constants_match():
    for name in ("INT32_MAX", "ZERO_TS_RANK", "FAME_UNDEFINED", "FAME_TRUE", "FAME_FALSE"):
        assert getattr(tk, name) == getattr(jk, name)
    assert tk._bcast_budget(torch.device("cpu")) == 1 << 26
