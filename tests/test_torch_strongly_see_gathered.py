"""The port's gathered, batched, thresholded strongly-see
(babble_tpu_torch/ops/hopper_kernels.py strongly_see_gathered, plain
version kernels.strongly_see_gathered_ref) against the JAX package's
Pallas kernel run in interpret mode on the CPU, row by row on the
gathered operands, then thresholded, masked and tallied in numpy.
Tolerance: exact equality (the function is a count).

Also: the four strongly-see sites of the pipeline (decide_fame, the
frontier probe sees_sm, the skip correction in the frontier step,
compute_rounds) reach the gathered wrapper, fame once per call. On the
CPU the wrapper takes its plain version; the CUDA kernel itself is held
against that plain version on the card by chip_smoke.py."""

from __future__ import annotations

import functools
import sys

import numpy as np
import pytest
import torch

from babble_tpu.ops.pallas_kernels import strongly_see_counts as jax_strongly_see_counts
from babble_tpu_torch.ops import closure as tc
from babble_tpu_torch.ops import frontier as tf
from babble_tpu_torch.ops import hopper_kernels
from babble_tpu_torch.ops import kernels as tk
from babble_tpu_torch.ops.hopper_kernels import (
    strongly_see_gathered,
    strongly_see_gathered_ref,
)

from test_torch_kernels import T, reference, same

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

INT32_MAX = np.iinfo(np.int32).max
MODES = ["matrix", "tally"]
# (M rows, W witness slots, n participants, R witness rows, Ex, Ef)
SHAPES = {
    "tile64_mixed_wrow": (64, 64, 64, 3, 90, 80),
    "ragged": (130, 200, 100, 5, 150, 120),
    "n4": (9, 5, 4, 2, 12, 10),
    "no_rows": (0, 7, 6, 2, 5, 5),
    "no_witnesses": (8, 0, 6, 2, 10, 5),
}
CASES = sorted(SHAPES) + ["count_at_sm"]


def _random_case(m, w, n, r, ex, ef, seed=3):
    """Per-row shifted x values spread the counts across sm; 20% of the
    witness slots are -1 and 20% of the fd lanes INT32_MAX."""
    rng = np.random.default_rng(seed)
    x_tab = (rng.integers(0, 100, (ex, n)) + rng.integers(-50, 100, (ex, 1))).astype(np.int32)
    f_tab = rng.integers(0, 100, (ef, n)).astype(np.int32)
    f_tab[rng.random((ef, n)) < 0.2] = INT32_MAX
    w_tab = rng.integers(0, ef, (r, w)).astype(np.int32)
    w_tab[rng.random((r, w)) < 0.2] = -1
    xs = rng.integers(0, ex, m).astype(np.int32)
    wrow = rng.integers(0, r, m).astype(np.int32)
    return x_tab, xs, f_tab, w_tab, wrow, 2 * n // 3 + 1


def _count_at_sm_case():
    """Counts of exactly sm - 1, sm and sm + 1 against valid and -1
    witness slots."""
    n, sm = 8, 6
    f_tab = np.zeros((3, n), np.int32)
    f_tab[2, :] = INT32_MAX  # unreached on every lane: counts 0
    x_tab = np.full((3, n), -1, np.int32)
    for row, c in enumerate((sm - 1, sm, sm + 1)):
        x_tab[row, :c] = 5
    w_tab = np.array([[0, 1, -1, 2], [1, -1, -1, 0]], np.int32)
    xs = np.array([0, 1, 2, 2, 1, 0], np.int32)
    wrow = np.array([0, 0, 0, 1, 1, 1], np.int32)
    return x_tab, xs, f_tab, w_tab, wrow, sm


@functools.lru_cache(maxsize=None)
def case(name):
    if name == "count_at_sm":
        return _count_at_sm_case()
    return _random_case(*SHAPES[name])


@functools.lru_cache(maxsize=None)
def pallas_hits(name):
    """hit[m, w] from the JAX Pallas kernel, one row at a time."""
    x_tab, xs, f_tab, w_tab, wrow, sm = case(name)
    m, w = xs.shape[0], w_tab.shape[1]
    hit = np.zeros((m, w), bool)
    for row in range(m if w else 0):
        ids = w_tab[wrow[row]]
        valid = ids >= 0
        counts = np.asarray(jax_strongly_see_counts(
            x_tab[xs[row]][None], f_tab[np.where(valid, ids, 0)], interpret=True))[0]
        hit[row] = (counts >= sm) & valid
    return hit


def _want(name, mode):
    hit = pallas_hits(name)
    return hit.astype(np.uint8) if mode == "matrix" else hit.sum(-1, dtype=np.int32)


def _args(name):
    x_tab, xs, f_tab, w_tab, wrow, sm = case(name)
    return (*(torch.from_numpy(a) for a in (x_tab, xs, f_tab, w_tab, wrow)), sm)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_pallas_kernel(name, mode):
    got = strongly_see_gathered_ref(*_args(name), mode)
    assert got.dtype == (torch.uint8 if mode == "matrix" else torch.int32)
    same(got, _want(name, mode))


def test_cases_reach_the_threshold_and_the_masks():
    """The random cases hit and miss, and count_at_sm hits at exactly
    sm and not at sm - 1 or on a -1 slot."""
    for name in ("tile64_mixed_wrow", "ragged", "n4"):
        share = pallas_hits(name).mean()
        assert 0.05 < share < 0.95, (name, share)
    assert pallas_hits("count_at_sm").tolist() == [
        [False, False, False, False],
        [True, True, False, False],
        [True, True, False, False],
        [True, False, False, True],
        [True, False, False, True],
        [False, False, False, False],
    ]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["ragged", "count_at_sm"])
def test_cpu_tensor_takes_plain_version(name, mode):
    before = dict(strongly_see_gathered.launches)
    got = strongly_see_gathered(*_args(name), mode)
    assert strongly_see_gathered.launches == before  # no kernel launch on the CPU
    same(got, _want(name, mode))


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_clamped_final_chunk(monkeypatch, mode):
    """A budget of 3 rows per chunk over 130 rows: the clamped final
    chunk re-reads overlapping rows (idempotent) instead of truncating."""
    m, w, n = SHAPES["ragged"][:3]
    monkeypatch.setattr(tk, "_bcast_budget", lambda device: 3 * w * n)
    assert tk.chunk_width(m, w * n, 3 * w * n) == 3 and m % 3
    same(strongly_see_gathered_ref(*_args("ragged"), mode), _want("ragged", mode))


def _bad_inputs():
    x_tab, xs, f_tab, w_tab, wrow, sm = _args("n4")
    ok = (x_tab, xs, f_tab, w_tab, wrow, sm, "tally")

    def but(**kw):
        names = ("x_tab", "xs", "f_tab", "w_tab", "wrow", "sm", "mode")
        return tuple(kw.get(k, v) for k, v in zip(names, ok))

    wide = torch.cat([w_tab, w_tab], 1)
    return {
        "int64_xs": (but(xs=xs.to(torch.int64)), TypeError),
        "float_f_tab": (but(f_tab=f_tab.to(torch.float32)), TypeError),
        "non_contiguous_w_tab": (but(w_tab=wide[:, ::2]), ValueError),
        "two_dim_wrow": (but(wrow=wrow[:, None]), ValueError),
        "rows_mismatch": (but(wrow=wrow[1:].contiguous()), ValueError),
        "participant_mismatch": (but(f_tab=f_tab[:, :3].contiguous()), ValueError),
        "unknown_mode": (but(mode="counts"), ValueError),
        "other_device": (tuple(a.to("meta") if torch.is_tensor(a) else a for a in ok),
                         ValueError),
    }


@pytest.mark.parametrize("case_name", sorted(_bad_inputs()))
def test_wrapper_rejects(case_name):
    args, exc = _bad_inputs()[case_name]
    before = dict(strongly_see_gathered.launches)
    with pytest.raises(exc):
        strongly_see_gathered(*args)
    assert strongly_see_gathered.launches == before


def test_probe_masking_needs_the_chain_end_guard():
    """The frontier probe masks empty witness slots where the plain
    code read them as INT32_MAX fd rows. On every real chain position
    the two agree (a real la row is below INT32_MAX, so it never sees an
    all-INT32_MAX row); on a position past a chain's end (an INT32_MAX
    row) the padded form counts the empty slots and the masked form does
    not. The search's guard mid < hi <= chain_len keeps such positions
    out of every probe it acts on."""
    ref = reference("syn8")
    d = ref["port"]
    n, sm = d.n, d.super_majority
    la, fd = T(ref["la"]), T(ref["fd"])
    chain_la, _ = tf.build_chain_tables(la, torch.zeros(d.e, dtype=torch.int32),
                                        T(d.chain), n=n)
    k_cap = chain_la.shape[1]
    wt_prev = T(ref["wt"][1])
    wt_prev[: n // 2] = -1  # half the witness slots empty
    valid = wt_prev >= 0
    fd_pad = torch.where(valid[:, None], fd[torch.where(valid, wt_prev, 0)], INT32_MAX)
    rows = chain_la.reshape(n * k_cap, n)
    xs = torch.arange(n * k_cap, dtype=torch.int32)
    padded = ((rows[:, None, :] >= fd_pad[None]).sum(-1) >= sm).sum(-1, dtype=torch.int32)
    masked = strongly_see_gathered(rows, xs, fd, wt_prev[None],
                                   torch.zeros_like(xs), sm, "tally")
    real = (torch.arange(k_cap)[None, :] < T(d.chain_len)[:, None]).reshape(-1)
    assert not real.all()  # the table has positions past some chain's end
    assert (masked[real] == padded[real]).all()
    assert (padded[~real] - masked[~real] == n // 2).all()


def _spy(monkeypatch):
    """Record (calling function, mode) for every gathered-wrapper call."""
    calls = []
    real = hopper_kernels.strongly_see_gathered

    def spy(*args):
        calls.append((sys._getframe(1).f_code.co_name, args[-1]))
        return real(*args)

    monkeypatch.setattr(hopper_kernels, "strongly_see_gathered", spy)
    return calls


def test_fame_is_one_gathered_matrix_launch(monkeypatch):
    calls = _spy(monkeypatch)
    ref = reference("syn16")
    d, r = ref["port"], ref["r_small"]
    famous = tk.decide_fame(T(ref["wt"][:r]), T(ref["la"]), T(ref["fd"]),
                            T(d.index), T(d.coin), n=d.n, sm=d.super_majority, r=r)
    same(famous, ref["famous"])
    assert calls == [("decide_fame", "matrix")]


@pytest.mark.parametrize("name", ["syn16", "coin0", "coin1"])
def test_fame_in_round_chunks(monkeypatch, name):
    """An output budget of 3 voting rounds per launch: the round chunks
    give the same fame, one launch per chunk."""
    ref = reference(name)
    d, r = ref["port"], ref["r_small"]
    real = tk.chunk_width
    monkeypatch.setattr(tk, "chunk_width",
                        lambda w, row, budget=1 << 26: real(w, row, 3 * row))
    calls = _spy(monkeypatch)
    famous = tk.decide_fame(T(ref["wt"][:r]), T(ref["la"]), T(ref["fd"]),
                            T(d.index), T(d.coin), n=d.n, sm=d.super_majority, r=r)
    same(famous, ref["famous"])
    assert (r - 1) % 3 and calls == [("decide_fame", "matrix")] * -(-(r - 1) // 3)


def test_compute_rounds_is_one_tally_launch_per_level(monkeypatch):
    calls = _spy(monkeypatch)
    ref = reference("syn16")
    d = ref["port"]
    rounds, wit, wt = tk.compute_rounds(
        T(d.self_parent), T(d.other_parent), T(d.creator), T(d.index),
        T(ref["la"]), T(ref["fd"]), T(d.levels), T(d.root_round),
        n=d.n, sm=d.super_majority, r=d.max_rounds)
    same(rounds, ref["rounds"])
    same(wt, ref["wt"])
    assert calls == [("compute_rounds", "tally")] * d.levels.shape[0]


def test_frontier_probe_and_skip_correction_launches(monkeypatch):
    """Each frontier round: one TALLY launch per probe (sees_sm) and one
    for the skip correction (the round step itself). At n = 16 a probe
    may test 4,095 positions of every chain, so K = 46 takes one probe
    of 46 positions where a bisection took seven."""
    ref = reference("syn16")
    d = ref["port"]
    n, rc = d.n, 8
    la, rbase = tc.coordinates(d, block=128, device="cpu")
    fd = T(ref["fd"])
    chain_la, chain_rbase = tf.build_chain_tables(la, rbase, T(d.chain), n=n)
    calls = _spy(monkeypatch)
    tf.frontier_chunk(chain_la, chain_rbase, T(d.chain_len), la, fd, rbase,
                      T(d.chain), torch.full((n,), -1, dtype=torch.int32),
                      torch.zeros(n, dtype=torch.int32), 0, n=n,
                      sm=d.super_majority, rc=rc)
    probes = tf.search_steps(chain_la.shape[1], chain_la.shape[1])
    assert (chain_la.shape[1], probes) == (46, 1)
    assert set(calls) == {("sees_sm", "tally"), ("step", "tally")}
    assert calls.count(("step", "tally")) == rc
    assert calls.count(("sees_sm", "tally")) == rc * probes
