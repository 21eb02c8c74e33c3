"""The pure functions of the port's incremental engine
(babble_tpu_torch/ops/incremental.py) against the JAX package's, on the
CPU, on random inputs that hold INT32_MAX pads, la = -1 and pad lanes.
Tolerance: exact equality.

Also: the masked scatter that stands in for JAX's mode="drop"; the
int64 median against the JAX two-key sort, ZERO_TS pairs and pads
included; and the frontier and fame sites giving the same results with
the engine's row view of fd as with the dense fd the one-shot pipeline
passes. The packed buffer of _consensus_fused is compared word for word
on every pass of an engine run in tests/test_torch_incremental.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from babble_tpu.ops import incremental as jinc
from babble_tpu.ops.dag import synthetic_dag
from babble_tpu_torch.ops import closure as tc
from babble_tpu_torch.ops import frontier as tf
from babble_tpu_torch.ops import incremental as tinc
from babble_tpu_torch.ops import kernels as tk

from test_torch_kernels import carry

torch.set_num_threads(1)

INT32_MAX = np.iinfo(np.int32).max


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.array(a))


def _fold_case(n, m, k, cap, seed):
    """Random inputs of the fd fold: coordinates with -1 and values past
    k (clipped into bucket k), a new-event table with -1 pad lanes, one
    valid lane whose position lies past the table (dropped), and
    distinct positions per chain."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, 5, (n, n, k)).astype(np.int32)
    chain_la = rng.integers(-1, k, (n, k, n)).astype(np.int32)
    chain_la[rng.random((n, k, n)) < 0.3] = INT32_MAX
    chain_rb = rng.integers(-1, 4, (n, k)).astype(np.int32)
    la = rng.integers(-1, k + 3, (cap + 1, n)).astype(np.int32)
    la[-1] = -1
    rb = rng.integers(-1, 4, cap + 1).astype(np.int32)
    newtab = rng.integers(0, cap, (n, m)).astype(np.int32)
    newtab[rng.random((n, m)) < 0.4] = -1
    newpos = np.stack([rng.permutation(k)[:m] for _ in range(n)]).astype(np.int32)
    newtab[0, 0], newpos[0, 0] = 3, k + 2  # valid lane past the table
    return ranks, chain_la, chain_rb, la, rb, newtab, newpos


@pytest.mark.parametrize("n,m,k,cap,seed", [(4, 3, 8, 32, 0), (8, 16, 16, 64, 1),
                                             (5, 16, 32, 40, 2)])
def test_tables_update_hist(n, m, k, cap, seed):
    args = _fold_case(n, m, k, cap, seed)
    want = jinc._tables_update_hist(*map(J, args), n=n, m=m)
    targs = list(map(T, args))
    got = tinc._tables_update_hist(*targs, n=n, m=m)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # in place on the resident carries, as the JAX package donates them
    assert got[0] is targs[0] and got[1] is targs[1] and got[2] is targs[2]


@pytest.mark.parametrize("n,m,k,seed", [(4, 3, 8, 0), (6, 10, 8, 1)])
def test_chain_ingest(n, m, k, seed):
    rng = np.random.default_rng(seed)
    chain = rng.integers(-1, 50, (n, k)).astype(np.int32)
    th = rng.integers(-(2**31), 2**31 - 1, (n, k)).astype(np.int32)
    tl = rng.integers(-(2**31), 2**31 - 1, (n, k)).astype(np.int32)
    newtab = rng.integers(0, 99, (n, m)).astype(np.int32)
    newtab[rng.random((n, m)) < 0.5] = -1
    newpos = np.stack([rng.permutation(k + 4)[:m] for _ in range(n)]).astype(np.int32)
    newhi = rng.integers(-(2**31), 2**31 - 1, (n, m)).astype(np.int32)
    newlo = rng.integers(-(2**31), 2**31 - 1, (n, m)).astype(np.int32)
    args = (chain, th, tl, newtab, newpos, newhi, newlo)
    want = jinc._chain_ingest(*map(J, args), n=n, m=m)
    got = tinc._chain_ingest(*map(T, args), n=n, m=m)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_set_where_drops_like_jax():
    """Lanes that are not ok never write — not when they name a live
    slot, not when they are the only lanes, and not past the table —
    and trailing dims ride along, as JAX's .at[].set(mode="drop")."""
    rng = np.random.default_rng(4)
    dst = rng.integers(0, 9, (6, 3)).astype(np.int32)
    rows = np.array([0, 5, 2, 7, 2])
    vals = rng.integers(10, 20, (5, 3)).astype(np.int32)
    for ok in (np.array([True, True, False, False, False]),
               np.array([False, False, True, False, False]),
               np.zeros(5, bool)):
        want = np.asarray(J(dst).at[jnp.where(J(ok), J(rows), 6)].set(J(vals), mode="drop"))
        got = tinc._set_where(T(dst), (T(rows),), T(vals), T(ok))
        assert np.array_equal(got.numpy(), want)


def _ranks_case(n, k, cap, seed):
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, k + 2, (n, n, k)).astype(np.int32)
    chain_len = rng.integers(0, k + 1, n).astype(np.int32)
    creator = rng.integers(0, n, cap + 1).astype(np.int32)
    index = rng.integers(-1, k + 3, cap + 1).astype(np.int32)  # -1 pads, past-k
    return ranks, chain_len, creator, index


@pytest.mark.parametrize("n,k,cap,seed", [(4, 8, 20, 0), (7, 16, 50, 1)])
def test_fd_from_ranks_and_row_view(n, k, cap, seed):
    ranks, chain_len, creator, index = _ranks_case(n, k, cap, seed)
    want = np.asarray(jinc._fd_from_ranks(J(ranks), J(chain_len), J(creator),
                                          J(index), n=n))
    got = tinc._fd_from_ranks(T(ranks), T(chain_len), T(creator), T(index), n=n)
    assert np.array_equal(got.numpy(), want)
    assert (want == INT32_MAX).any() and (want < INT32_MAX).any()
    view = tinc._FdRows(T(ranks), T(chain_len), T(creator), T(index))
    jview = jinc._FdRows(J(ranks), J(chain_len), J(creator), J(index))
    ids = np.random.default_rng(seed).integers(0, cap, (3, 5)).astype(np.int32)
    rows = view[T(ids)].numpy()
    assert np.array_equal(rows, np.asarray(jview[J(ids)]))
    assert np.array_equal(rows, want[ids])


def test_median_pairs_matches_two_key_sort():
    """The int64 median equals JAX's lexicographic (hi, lo) sort, with
    ZERO_TS pairs (first), INT32_MAX pads (last), equal hi words, and
    real timestamps of both signs."""
    rng = np.random.default_rng(5)
    rows, n = 40, 9
    ns = rng.integers(-(2**62), 2**62, (rows, n))
    ns[:, :3] = rng.integers(0, 2**40, (rows, 3)) | (7 << 40)  # equal hi words
    hi, lo = jinc._ts_split(ns)
    zero = rng.random((rows, n)) < 0.2
    hi[zero], lo[zero] = jinc.ZERO_TS_HI, 0
    pad = rng.random((rows, n)) < 0.3
    hi[pad], lo[pad] = INT32_MAX, INT32_MAX
    pick = rng.integers(0, n, (rows, 1))
    s_hi, s_lo = lax.sort((J(hi), J(lo)), dimension=1, num_keys=2)
    want_hi = np.take_along_axis(np.asarray(s_hi), pick, 1)[:, 0]
    want_lo = np.take_along_axis(np.asarray(s_lo), pick, 1)[:, 0]
    got_hi, got_lo = tinc._median_pairs(T(hi), T(lo), T(pick))
    assert np.array_equal(got_hi.numpy(), want_hi)
    assert np.array_equal(got_lo.numpy(), want_lo)
    assert (want_hi == jinc.ZERO_TS_HI).any() and (want_hi == INT32_MAX).any()


@pytest.mark.parametrize("x", [0, 1, 7, 8, 9, 1000, 4097])
def test_buckets_and_timestamp_split(x):
    assert tinc._pow2(x) == jinc._pow2(x)
    assert tinc._pow2(x, 16) == jinc._pow2(x, 16)
    assert tinc._pow4(x, 16) == jinc._pow4(x, 16)
    ts = np.array([x, -x, 2**62 + x, -(2**62) - x, 1_700_000_000_000_000_000 + x])
    hi, lo = tinc._ts_split(ts)
    assert all(tinc._ts_join(h, l) == t for h, l, t in zip(hi, lo, ts))
    assert (tinc.ZERO_TIME_NS, tinc.CTS_SENTINEL, tinc.ZERO_TS_HI) == (
        jinc.ZERO_TIME_NS, jinc.CTS_SENTINEL, jinc.ZERO_TS_HI)


def _rank_view(dag, la):
    """The engine's row view over a DAG's rank cube, and the dense fd."""
    n, k = dag.n, dag.chain.shape[1]
    chain, chain_len = T(dag.chain), T(dag.chain_len)
    valid = chain >= 0
    chain_la = torch.where(valid[:, :, None], la[torch.where(valid, chain, 0)],
                           INT32_MAX)
    ts = torch.arange(k, dtype=torch.int32)
    ranks = (chain_la[:, :, :, None] < ts).sum(1, dtype=torch.int32)  # [n, n, K]
    view = tinc._FdRows(ranks, chain_len, T(dag.creator), T(dag.index))
    dense = tk.compute_first_descendants(
        la, T(dag.creator), T(dag.index), chain, chain_len, n=n)
    return view, dense


@pytest.mark.parametrize("n,e,seed", [(5, 150, 3), (8, 300, 1)])
def test_row_view_equals_dense_fd(n, e, seed):
    """The frontier sweep (probe and skip correction) and fame give the
    same tables with the engine's row view of fd (witness rows gathered
    into a compact table, ids renumbered) as with the dense fd."""
    dag = carry(synthetic_dag(n, e, seed=seed)[0])
    la, rbase = tc.coordinates(dag, block=64, device="cpu")
    view, dense = _rank_view(dag, la)
    assert np.array_equal(view[torch.arange(e)].numpy(), dense.numpy())
    chain, chain_len = T(dag.chain), T(dag.chain_len)
    chain_la, chain_rb = tf.build_chain_tables(la, rbase, chain, n=n)
    sm, rcap, k = dag.super_majority, 64, dag.chain.shape[1]
    sweeps = []
    for fd in (dense, view):
        wt = torch.full((rcap, n), -1, dtype=torch.int32)
        fr = torch.full((rcap, n), k, dtype=torch.int32)
        sweeps.append(tf.frontier_sweep_impl(
            chain_la, chain_rb, chain_len, la, fd, rbase, chain, wt, fr,
            torch.full((n,), -1, dtype=torch.int32),
            torch.zeros((n,), dtype=torch.int32), 0, 0, n=n, sm=sm, rcap=rcap))
    (wt_d, fr_d, t_d), (wt_v, fr_v, t_v) = sweeps
    assert 2 < t_d == t_v < rcap
    assert torch.equal(wt_d, wt_v) and torch.equal(fr_d, fr_v)
    wt_fame = wt_d[: t_d + 1].contiguous()
    fame = [tk.decide_fame(wt_fame, la, fd, T(dag.index), T(dag.coin), n=n, sm=sm,
                           r=t_d + 1) for fd in (dense, view)]
    assert torch.equal(fame[0], fame[1])
    assert (fame[0] != 0).any()


def test_witness_rows_forms():
    """witness_rows: a dense fd passes through; a row view gives the
    witnesses' rows and the table renumbered to them, -1 kept."""
    fd = torch.arange(20, dtype=torch.int32).view(5, 4)
    wt = torch.tensor([[3, -1], [0, 4]], dtype=torch.int32)
    assert tk.witness_rows(fd, wt)[0] is fd

    class View:
        def __getitem__(self, ids):
            return fd[ids]

    f_tab, w_tab = tk.witness_rows(View(), wt)
    assert w_tab.tolist() == [[0, -1], [2, 3]]
    assert torch.equal(f_tab[w_tab[w_tab >= 0].long()], fd[wt[wt >= 0].long()])
