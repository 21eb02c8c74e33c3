"""The port's batched view simulator (babble_tpu_torch/ops/sim.py) and
the view arguments of its one-shot kernels against the JAX package, on
the CPU. Tolerance: exact equality of every array.

- gossip_schedule and simulate_views draw the JAX package's numbers
  from the same seeds: the same schedules, DAG arrays, masks and s_rank;
- GossipSim builds the JAX package's DAG structure and masks; fed the
  JAX sim's events (carried by their Go-JSON bytes: signing draws a
  random nonce), consensus_views equals the JAX consensus_views;
- consensus_views_factored equals the JAX one on power-law temporal
  views and on a silent-peer network, and the port's fused form;
- a masked view equals the port's host Hashgraph on its sub-DAG;
- valid_mask on compute_rounds, decide_round_received and
  consensus_pipeline, and view_chain_len on compute_frontier, equal
  the JAX package's on a prefix view;
- with a view axis the rounds stage reaches the strongly-see wrapper
  once per DAG level and fame once per chunk of voting rounds, for one
  view and for eight alike;
- without a CUDA device the sim entry points raise."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from babble_tpu.ops import closure as jc
from babble_tpu.ops import frontier as jf
from babble_tpu.ops import kernels as jk
from babble_tpu.ops import sim as jsim
from babble_tpu.ops.dag import synthetic_dag as jax_synthetic_dag
from babble_tpu.ops.pipeline import consensus_pipeline as jax_consensus_pipeline
from babble_tpu_torch.hashgraph.event import event_from_json_obj
from babble_tpu_torch.ops import closure as tc
from babble_tpu_torch.ops import frontier as tf
from babble_tpu_torch.ops import hopper_kernels
from babble_tpu_torch.ops import kernels as tk
from babble_tpu_torch.ops import sim as tsim
from babble_tpu_torch.ops.dag import build_dag, synthetic_dag
from babble_tpu_torch.ops.pipeline import consensus_pipeline, tight_round_bucket

from test_torch_kernels import carry

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

ARRAYS = ("self_parent", "other_parent", "creator", "index", "coin", "ts_rank",
          "ts_values", "levels", "chain", "chain_len", "chain_rank", "root_round")
STRUCTURE = ("self_parent", "other_parent", "creator", "index", "ts_rank", "levels",
             "chain", "chain_len", "chain_rank", "root_round")
OUTPUTS = ("rounds", "witness", "wt", "famous", "rr", "cts")


def T(a):
    return torch.from_numpy(np.array(a))


def same(got, want, name=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    assert (g == w).all(), name


def same_outputs(got, want):
    for name, g, w in zip(OUTPUTS, got, want):
        same(g, w, name)


def jax_sim_digest(name):
    """digest() of the JAX package's consensus_views_factored on
    chip_smoke.SIM_CONFIGS[name]: the GOLDEN_SIM value phase sim holds
    the port's run against."""
    dag, masks, _ = chip_smoke.sim_views(name, jsim.simulate_views)
    return chip_smoke.digest(np.asarray(o) for o in jsim.consensus_views_factored(dag, masks))


def _silent(n, k):
    silent = np.zeros(n, bool)
    silent[n - k:] = True
    return silent


SCHEDULES = {
    "uniform": dict(n=8, steps=300, seed=1),
    "powerlaw": dict(n=16, steps=400, selector="powerlaw", alpha=1.2, seed=5),
    "silent": dict(n=16, steps=400, silent=_silent(16, 5), seed=6),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_gossip_schedule_matches_jax(name):
    kw = SCHEDULES[name]
    got = tsim.gossip_schedule(**kw)
    want = jsim.gossip_schedule(**kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and (g == w).all()


@pytest.mark.parametrize("name", sorted(SCHEDULES) + ["snapshots"])
def test_simulate_views_matches_jax(name):
    kw = SCHEDULES.get(name) or dict(n=16, steps=400, selector="powerlaw", alpha=1.2,
                                     seed=5, snapshots=[100, 200, 300, 400])
    dag, masks, s_rank = tsim.simulate_views(**kw)
    jdag, jmasks, js_rank = jsim.simulate_views(**kw)
    assert (dag.n, dag.e, dag.depth, dag.max_rounds) == (
        jdag.n, jdag.e, jdag.depth, jdag.max_rounds)
    for k in ARRAYS:
        a, b = getattr(dag, k), getattr(jdag, k)
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), k
    assert masks.shape == jmasks.shape and (masks == jmasks).all()
    assert (s_rank == js_rank).all()


def test_simulate_views_rejects_bad_inputs():
    with pytest.raises(ValueError, match="non-silent"):
        tsim.gossip_schedule(4, 10, silent=_silent(4, 3))
    with pytest.raises(ValueError, match="selector"):
        tsim.gossip_schedule(4, 10, selector="ring")
    dag, masks, _ = tsim.simulate_views(4, 20, seed=0)
    with pytest.raises(ValueError, match="events"):
        tsim.consensus_views_factored(dag, masks[:, :-1], device="cpu")


SMALL_CONFIGS = {
    "config2": dict(n=8, steps=300, seed=1),
    "config4": dict(n=8, steps=300, selector="powerlaw", alpha=1.2, seed=5,
                    snapshots=[100, 200, 300]),
    "config3": dict(n=16, steps=600, silent_last=5, seed=9, prefix=400),
}


@pytest.mark.parametrize("name", sorted(SMALL_CONFIGS))
def test_phase_sim_inputs_and_golden_digest(monkeypatch, name):
    """chip_smoke.sim_views builds each configuration's views (a shape
    of SIM_CONFIGS at a small size) alike from either package's
    generator, and the port's run has the digest that jax_sim_digest,
    the script of GOLDEN_SIM, gives."""
    monkeypatch.setattr(chip_smoke, "SIM_CONFIGS", SMALL_CONFIGS)
    dag, masks, s_rank = chip_smoke.sim_views(name, tsim.simulate_views)
    jdag, jmasks, js_rank = chip_smoke.sim_views(name, jsim.simulate_views)
    assert (masks == jmasks).all() and (s_rank == js_rank).all()
    assert masks.shape[0] == {"config2": 8, "config4": 24, "config3": 2}[name]
    if name == "config3":
        assert (dag.creator[16:dag.e] < 11).all() and masks[0].sum() == 400
    got = tsim.consensus_views_factored(dag, masks, device="cpu")
    assert chip_smoke.digest(o.numpy() for o in got) == jax_sim_digest(name)


def _carried_sim_dag(jax_sim):
    """The port's DAG of the JAX GossipSim's events, carried across by
    their Go-JSON bytes (the same hashes and signatures)."""
    events = [event_from_json_obj(json.loads(ev.marshal())) for ev in jax_sim.events]
    return build_dag(events, jax_sim.participants)


def test_gossip_sim_matches_jax():
    """GossipSim(5, seed=3).run(150), tests/test_sim.py's: the same
    participants, masks and DAG structure; on the JAX sim's events the
    port's consensus_views (every peer's view and the full view) equals
    the JAX consensus_views, and so do the views' orders."""
    sim = tsim.GossipSim(5, seed=3)
    sim.run(150)
    jax_sim = jsim.GossipSim(5, seed=3)
    jax_sim.run(150)
    assert sim.participants == jax_sim.participants
    masks = sim.view_masks()
    assert (masks == jax_sim.view_masks()).all()
    dag, jdag = sim.dag(), jax_sim.dag()
    for k in STRUCTURE:
        assert (getattr(dag, k) == getattr(jdag, k)).all(), k

    cdag = _carried_sim_dag(jax_sim)
    assert cdag.hexes == jdag.hexes and (cdag.coin == jdag.coin).all()
    masks = np.vstack([masks, np.ones((1, jdag.e), bool)])
    got = tsim.consensus_views(cdag, masks, device="cpu")
    want = jsim.consensus_views(jdag, masks)
    same_outputs(got, want)
    orders = tsim.check_view_consistency(cdag, got[4], got[5])
    assert orders == jsim.check_view_consistency(jdag, np.asarray(want[4]),
                                                 np.asarray(want[5]))
    assert len(orders[-1]) > 0 and any(len(o) > 0 for o in orders[:-1])


FACTORED = {
    # tests/test_sim.py::test_views_at_scale_factored: 16 peers x 4
    # temporal snapshots, power-law selector
    "powerlaw_snapshots": (dict(n=16, steps=800, selector="powerlaw", alpha=1.2, seed=5,
                                snapshots=[200, 400, 600, 800]), None),
    # tests/test_sim.py::test_views_with_silent_peers: the active views
    "silent": (dict(n=16, steps=400, silent=_silent(16, 5), seed=6), "active"),
}


@pytest.mark.parametrize("name", sorted(FACTORED))
def test_factored_views_match_jax(name):
    kw, rows = FACTORED[name]
    dag, masks, s_rank = tsim.simulate_views(**kw)
    jdag, _, _ = jsim.simulate_views(**kw)
    if rows == "active":
        masks = masks[~kw["silent"]]
    got = tsim.consensus_views_factored(dag, masks, device="cpu")
    want = jsim.consensus_views_factored(jdag, masks)
    same_outputs(got, want)
    orders = tsim.check_view_consistency(dag, got[4], got[5], s_ints=s_rank)
    assert max(len(o) for o in orders) > 50
    if name == "powerlaw_snapshots":
        assert masks.shape[0] == 64


def test_factored_equals_fused():
    """tests/test_sim.py::test_factored_views_match_fused on the port:
    the tight round bucket changes no output."""
    sim = tsim.GossipSim(5, seed=9)
    sim.run(100)
    dag, masks = sim.dag(), sim.view_masks()
    same_outputs(tsim.consensus_views_factored(dag, masks, device="cpu"),
                 tsim.consensus_views(dag, masks, device="cpu"))


def test_masked_view_matches_host_engine():
    """The best-informed peer's view through consensus_views equals the
    port's host Hashgraph fed exactly that sub-DAG: order and rounds."""
    n, seed, steps = chip_smoke.SIM_GOSSIP
    sim = tsim.GossipSim(n, seed=seed)
    sim.run(steps)
    check = chip_smoke.sim_gossip_check(sim, device="cpu")
    assert check["equal"] and check["decided"] > 0


def _prefix_view(jdag, frac=0.7):
    """A prefix of the events, ancestry-closed (ids are topological), as
    a [E+1] mask and its per-creator chain lengths."""
    e = jdag.e
    p = int(e * frac)
    mask = np.zeros(e + 1, bool)
    mask[:p] = True
    chain_len = np.bincount(jdag.creator[:p], minlength=jdag.n).astype(np.int32)
    return mask, chain_len


@pytest.mark.parametrize("n,e,seed", [(4, 120, 0), (8, 400, 7)])
def test_valid_mask_on_the_stages_matches_jax(n, e, seed):
    """compute_rounds and decide_round_received with a prefix view's
    mask equal the JAX kernels; the view's events keep the rounds of
    the whole DAG, and out-of-view events are never received."""
    dag, _ = synthetic_dag(n, e, seed=seed)
    jdag, _ = jax_synthetic_dag(n, e, seed=seed)
    mask, _ = _prefix_view(jdag)
    sm, r = jdag.super_majority, jdag.max_rounds
    la = jk.compute_last_ancestors(jdag.self_parent, jdag.other_parent, jdag.creator,
                                   jdag.index, jdag.levels, n=n)
    fd = jk.compute_first_descendants(la, jdag.creator, jdag.index, jdag.chain,
                                      jdag.chain_len, n=n)
    want = jk.compute_rounds(jdag.self_parent, jdag.other_parent, jdag.creator,
                             jdag.index, la, fd, jdag.levels, jdag.root_round, mask,
                             n=n, sm=sm, r=r)
    got = tk.compute_rounds(T(dag.self_parent), T(dag.other_parent), T(dag.creator),
                            T(dag.index), T(la), T(fd), T(dag.levels), T(dag.root_round),
                            T(mask), n=n, sm=sm, r=r)
    for name, g, w in zip(("rounds", "witness", "wt"), got, want):
        same(g, w, name)
    full = tk.compute_rounds(T(dag.self_parent), T(dag.other_parent), T(dag.creator),
                             T(dag.index), T(la), T(fd), T(dag.levels), T(dag.root_round),
                             n=n, sm=sm, r=r)
    in_view = T(mask[:e])
    same(got[0][in_view], full[0][in_view].numpy(), "a view's own events keep their rounds")
    assert (got[2] != full[2]).any(), "the view's witness table is its own"

    rounds, wt = np.asarray(want[0]), np.asarray(want[2])
    famous = jk.decide_fame(wt, la, fd, jdag.index, jdag.coin, n=n, sm=sm, r=r)
    want_rr = jk.decide_round_received(rounds, wt, famous, la, fd, jdag.creator,
                                       jdag.index, jdag.chain_rank, mask, n=n, r=r)
    got_rr = tk.decide_round_received(T(rounds), T(wt), T(famous), T(la), T(fd),
                                      T(dag.creator), T(dag.index), T(dag.chain_rank),
                                      T(mask), n=n, r=r)
    same(got_rr[0], want_rr[0], "rr")
    same(got_rr[1], want_rr[1], "cts")
    assert (got_rr[0][~T(mask[:e])] == -1).all()
    assert (got_rr[0] >= 0).any()


@pytest.mark.parametrize("masked", [False, True])
def test_consensus_pipeline_matches_jax(masked):
    n, e, seed = 8, 400, 7
    dag, _ = synthetic_dag(n, e, seed=seed)
    jdag, _ = jax_synthetic_dag(n, e, seed=seed)
    mask = _prefix_view(jdag)[0] if masked else None
    args = [getattr(jdag, k) for k in ("self_parent", "other_parent", "creator", "index",
                                       "coin", "levels", "root_round", "chain",
                                       "chain_len", "chain_rank")]
    kw = dict(n=n, sm=jdag.super_majority, r=jdag.max_rounds)
    want = jax_consensus_pipeline(*args, mask, **kw)
    got = consensus_pipeline(*[getattr(dag, k) for k in (
        "self_parent", "other_parent", "creator", "index", "coin", "levels",
        "root_round", "chain", "chain_len", "chain_rank")], mask, device="cpu", **kw)
    same_outputs(got, want)


def test_view_chain_len_on_the_frontier_matches_jax():
    """compute_frontier over a prefix view's chain lengths (coordinates
    of the full DAG) equals the JAX frontier, and stops short of the
    whole DAG's."""
    n, e, seed = 8, 400, 7
    jdag, _ = jax_synthetic_dag(n, e, seed=seed)
    dag = carry(jdag)
    _, view_len = _prefix_view(jdag, 0.5)
    sm = jdag.super_majority
    la, rbase = jc.coordinates(jdag, block=128)
    fd = jk.compute_first_descendants(la, jdag.creator, jdag.index, jdag.chain,
                                      jdag.chain_len, n=n)
    want = jf.compute_frontier(la, rbase, fd, jdag.chain, jdag.chain_len,
                               jdag.root_round, n=n, sm=sm, rc=16,
                               view_chain_len=view_len)
    tla, trbase = tc.coordinates(dag, block=128, device="cpu")
    tfd = tk.compute_first_descendants(tla, T(dag.creator), T(dag.index), T(dag.chain),
                                       T(dag.chain_len), n=n)
    got = tf.compute_frontier(tla, trbase, tfd, T(dag.chain), T(dag.chain_len),
                              dag.root_round, n=n, sm=sm, rc=16, view_chain_len=view_len)
    same(got[0], want[0], "wt")
    same(got[1], want[1], "frontier")
    assert got[2] == want[2]
    whole = tf.compute_frontier(tla, trbase, tfd, T(dag.chain), T(dag.chain_len),
                                dag.root_round, n=n, sm=sm, rc=16)
    assert got[0].shape[0] < whole[0].shape[0]


def _spy(monkeypatch):
    calls = []
    real = hopper_kernels.strongly_see_gathered

    def spy(*args):
        calls.append((sys._getframe(1).f_code.co_name, args[-1]))
        return real(*args)

    monkeypatch.setattr(hopper_kernels, "strongly_see_gathered", spy)
    return calls


@pytest.mark.parametrize("views", [1, 8])
def test_view_axis_launches_do_not_scale_with_views(monkeypatch, views):
    """consensus_views_factored reaches the wrapper once per DAG level
    (rounds, TALLY) and once per chunk of voting rounds (fame, MATRIX;
    an output budget of 3 voting rounds a launch, whatever V), for one
    view and for eight; the eight views equal the JAX package's."""
    dag, masks, _ = tsim.simulate_views(8, 300, seed=2)
    masks = masks[:views]
    real = tk.chunk_width
    monkeypatch.setattr(tk, "chunk_width",
                        lambda w, row, budget=1 << 26: real(w, row, 3 * row))
    calls = _spy(monkeypatch)
    got = tsim.consensus_views_factored(dag, masks, device="cpu")
    r_small = tight_round_bucket(got[0], dag.max_rounds)
    levels = dag.levels.shape[0]
    chunks = -(-(r_small - 1) // 3)
    assert chunks > 1
    assert calls == ([("compute_rounds", "tally")] * levels
                     + [("decide_fame", "matrix")] * chunks)
    if views == 8:
        jdag, _, _ = jsim.simulate_views(8, 300, seed=2)
        same_outputs(got, jsim.consensus_views_factored(jdag, masks))


def test_sim_entry_points_raise_without_cuda():
    """With no device named the simulator runs on CUDA; where there is
    none it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    dag, masks, _ = tsim.simulate_views(4, 40, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.consensus_views(dag, masks)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.consensus_views_factored(dag, masks)
    with pytest.raises(RuntimeError, match="CUDA"):
        consensus_pipeline(dag.self_parent, dag.other_parent, dag.creator, dag.index,
                           dag.coin, dag.levels, dag.root_round, dag.chain,
                           dag.chain_len, dag.chain_rank, n=dag.n,
                           sm=dag.super_majority, r=dag.max_rounds)


def test_view_order_takes_tensors():
    """view_order and check_view_consistency read tensors as they read
    arrays (the JAX tests call them on results)."""
    dag, masks, s_rank = tsim.simulate_views(8, 300, seed=2)
    out = tsim.consensus_views_factored(dag, masks, device="cpu")
    from_tensors = tsim.check_view_consistency(dag, out[4], out[5], s_ints=s_rank)
    from_arrays = tsim.check_view_consistency(dag, out[4].numpy(), out[5].numpy(),
                                              s_ints=list(s_rank))
    assert from_tensors == from_arrays
    assert from_tensors[0] == jsim.view_order(dag, out[4][0].numpy(), out[5][0].numpy(),
                                              s_rank)
