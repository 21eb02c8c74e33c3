"""The port's block closure and round frontier
(babble_tpu_torch/ops/closure.py, frontier.py) against the JAX
package's, on the CPU — a mirror of tests/test_closure_frontier.py
(random gossip, non-base roots, block sizes), with each output held
against the JAX engine's and against the port's own wavefront.
Tolerance: exact equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from babble_tpu.ops import closure as jc
from babble_tpu.ops import frontier as jf
from babble_tpu.ops import kernels as jk
from babble_tpu.ops.dag import synthetic_dag as jax_synthetic_dag
from babble_tpu_torch.ops import closure as tc
from babble_tpu_torch.ops import frontier as tf
from babble_tpu_torch.ops import kernels as tk
from babble_tpu_torch.ops.pipeline import run_pipeline, run_pipeline_wavefront

from test_torch_kernels import carry

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def T(a):
    return torch.from_numpy(np.array(a))


def _jax_frontier(jdag, block=128, rc=16):
    n, sm = jdag.n, jdag.super_majority
    la, rbase = jc.coordinates(jdag, block=block)
    fd = jk.compute_first_descendants(
        la, jdag.creator, jdag.index, jdag.chain, jdag.chain_len, n=n)
    wt, fr_rel, rho_min = jf.compute_frontier(
        la, rbase, fd, jdag.chain, jdag.chain_len, jdag.root_round,
        n=n, sm=sm, rc=rc)
    e = jdag.e
    rounds, wit = jf.rounds_from_frontier(
        fr_rel, jdag.creator[:e], jdag.index[:e], jdag.self_parent[:e],
        rho_min, n=n)
    return dict(la=np.asarray(la), rbase=np.asarray(rbase), fd=np.asarray(fd),
                wt=np.asarray(wt), fr=np.asarray(fr_rel), rho_min=rho_min,
                rounds=np.asarray(rounds), wit=np.asarray(wit))


def _port_frontier(dag, block=128, rc=16):
    n, sm = dag.n, dag.super_majority
    la, rbase = tc.coordinates(dag, block=block, device="cpu")
    fd = tk.compute_first_descendants(
        la, T(dag.creator), T(dag.index), T(dag.chain), T(dag.chain_len), n=n)
    wt, fr_rel, rho_min = tf.compute_frontier(
        la, rbase, fd, T(dag.chain), T(dag.chain_len), dag.root_round,
        n=n, sm=sm, rc=rc)
    e = dag.e
    rounds, wit = tf.rounds_from_frontier(
        fr_rel, T(dag.creator[:e]), T(dag.index[:e]), T(dag.self_parent[:e]),
        rho_min, n=n)
    return dict(la=la.numpy(), rbase=rbase.numpy(), fd=fd.numpy(), wt=wt.numpy(),
                fr=fr_rel.numpy(), rho_min=rho_min, rounds=rounds.numpy(),
                wit=wit.numpy())


def _assert_same(got, want):
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        assert (g == w).all(), key


@pytest.mark.parametrize(
    "n,e,seed", [(4, 60, 0), (8, 300, 1), (16, 1200, 2), (32, 2500, 3)]
)
def test_parity_random_gossip(n, e, seed):
    jdag, _ = jax_synthetic_dag(n, e, seed=seed)
    dag = carry(jdag)
    got = _port_frontier(dag)
    _assert_same(got, _jax_frontier(jdag))
    # and the port's closure/frontier rounds equal its own wavefront
    rounds, wit, wt = (x.numpy() for x in run_pipeline_wavefront(dag, "cpu")[:3])
    assert (got["rounds"] == rounds).all()
    assert (got["wit"] == wit).all()
    rmax = int(rounds.max())
    assert (got["wt"][: rmax + 1] == wt[: rmax + 1]).all()


def test_parity_nonbase_roots():
    """Non-base root rounds (the Reset / start-from-the-middle path,
    reference hashgraph.go:879-898): rbase must seed frontiers above
    round 0 and the skip correction must hold candidates back."""
    jdag, _ = jax_synthetic_dag(6, 150, seed=5)
    jdag.root_round = np.array([3, 4, 3, 5, 4, 3], dtype=np.int32)
    dag = carry(jdag)
    got = _port_frontier(dag)
    _assert_same(got, _jax_frontier(jdag))
    assert got["rho_min"] == 4
    assert int(got["rounds"].max()) >= 6  # actually started above base
    rounds = run_pipeline_wavefront(dag, "cpu")[0].numpy()
    assert (got["rounds"] == rounds).all()


def test_pipeline_closure_matches_wavefront():
    """Full-pipeline equivalence of the port's two engines (fame,
    round-received, timestamps included)."""
    jdag, _ = jax_synthetic_dag(8, 400, seed=7)
    dag = carry(jdag)
    out_c = run_pipeline(dag, engine="closure", device="cpu")
    out_w = run_pipeline(dag, engine="wavefront", device="cpu")
    for name, a, b in zip(["rounds", "wit", "wt", "famous", "rr", "cts"], out_c, out_w):
        assert a.shape == b.shape, name
        assert (a == b).all(), name


@pytest.mark.parametrize("block", [64, 256])
def test_closure_block_sizes_agree(block):
    """Block size must not affect results (pure scheduling knob)."""
    jdag, _ = jax_synthetic_dag(8, 300, seed=9)
    dag = carry(jdag)
    la, rb = tc.coordinates(dag, block=block, device="cpu")
    la_j, rb_j = jc.coordinates(jdag, block=64)
    assert (la.numpy() == np.asarray(la_j)).all()
    assert (rb.numpy() == np.asarray(rb_j)).all()


def test_closure_apply_in_row_chunks(monkeypatch):
    """A working-set bound small enough to split the closure apply into
    several equal row chunks gives the same coordinates."""
    monkeypatch.setattr(tc, "_APPLY_ELEMS", 64 * 8 * 16)
    assert tc._apply_chunks(64, 8) == 4
    jdag, _ = jax_synthetic_dag(8, 300, seed=9)
    la, rb = tc.coordinates(carry(jdag), block=64, device="cpu")
    la_j, rb_j = jc.coordinates(jdag, block=64)
    assert (la.numpy() == np.asarray(la_j)).all()
    assert (rb.numpy() == np.asarray(rb_j)).all()


def test_frontier_probe_in_chain_chunks(monkeypatch):
    """A cube bound that splits the probe's chains into exact chunks
    (cc < n) gives the same frontier."""
    monkeypatch.setattr(tf, "_CUBE_ELEMS", 16 * 16 * 4)
    assert tf._chain_chunks(16) == 4
    jdag, _ = jax_synthetic_dag(16, 1200, seed=2)
    _assert_same(_port_frontier(carry(jdag)), _jax_frontier(jdag))


@pytest.mark.parametrize("block,n", [(64, 4), (512, 64), (512, 1024), (256, 4096), (512, 3)])
def test_chunk_schedules_match(block, n):
    assert tc._apply_chunks(block, n) == jc._apply_chunks(block, n)
    assert tf._chain_chunks(n) == jf._chain_chunks(n)


def test_pad_for_blocks_matches():
    jdag, _ = jax_synthetic_dag(8, 300, seed=9)
    got, want = tc.pad_for_blocks(carry(jdag), 128), jc.pad_for_blocks(jdag, 128)
    assert got.keys() == want.keys()
    for k in want:
        assert (np.asarray(got[k]) == np.asarray(want[k])).all(), k


def test_frontier_chunk_matches():
    """One rc-round chunk of the frontier from the empty start."""
    jdag, _ = jax_synthetic_dag(8, 300, seed=1)
    dag = carry(jdag)
    n, sm = dag.n, dag.super_majority
    la, rbase = jc.coordinates(jdag, block=128)
    la, rbase = np.asarray(la), np.asarray(rbase)
    fd = np.asarray(jk.compute_first_descendants(
        la, jdag.creator, jdag.index, jdag.chain, jdag.chain_len, n=n))
    cla, crb = jf.build_chain_tables(la, rbase, jdag.chain, n=n)
    want = jf.frontier_chunk(
        cla, crb, jdag.chain_len, la, fd, rbase, jdag.chain,
        np.full(n, -1, np.int32), np.zeros(n, np.int32), np.int32(0), n=n, sm=sm, rc=8)
    tcla, tcrb = tf.build_chain_tables(T(la), T(rbase), T(dag.chain), n=n)
    assert (tcla.numpy() == np.asarray(cla)).all()
    assert (tcrb.numpy() == np.asarray(crb)).all()
    got = tf.frontier_chunk(
        tcla, tcrb, T(dag.chain_len), T(la), T(fd), T(rbase), T(dag.chain),
        torch.full((n,), -1, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
        0, n=n, sm=sm, rc=8)
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()
