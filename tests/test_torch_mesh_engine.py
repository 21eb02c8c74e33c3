"""The port's incremental engine with its O(E·n) carries split into d
shards under one controller (IncrementalEngine(mesh=...),
babble_tpu_torch/ops/mesh.py) against the JAX package's single-device
IncrementalEngine and the port's own, on the CPU with d shards on the
one CPU device. Tolerance: exact equality.

- tests/test_sharded.py's test_sharded_incremental_engine: n = 16,
  e = 1200 in batches of 131 from capacity 64 and k_capacity 8 (both
  grow), on a 1-D mesh and on a 2 x d/2 ("dcn", "ici") grid given
  a-major, d in {2, 8}: every RunDelta (rounds, witness, round
  received, consensus timestamps, fame, decided rounds) equals the JAX
  engine's and the port's single-device engine's, the final state
  equals the JAX engine's, and _la, _chain_la and _ranks are split into
  d shards whose sizes sum to the whole, none whole;
- a frame-reset mesh engine (test_torch_incremental.py's
  test_frame_reset_engine_matches_jax's inputs) equals the JAX engine;
- tests/test_sharded.py's test_node_engine_mesh_gossip: 4 in-memory
  torch nodes with Config.engine_mesh = 4 converge to round 3;
- Core(engine_mesh=3) over 4 validators shrinks to 2 shards and warns;
- a spy on the strongly-see wrapper: the frontier probe runs once per
  chain shard on that shard's own chain_la rows, and no launch reads a
  partial column slice (every operand is n wide);
- the mesh helpers against dense tensors.

The strongly-see launches take their plain versions on the CPU."""

from __future__ import annotations

import dataclasses
import logging
import sys

import numpy as np
import pytest
import torch

from babble_tpu.ops import incremental as jinc
from babble_tpu.ops.dag import synthetic_dag
from babble_tpu_torch.hashgraph import InmemStore
from babble_tpu_torch.node import Core
from babble_tpu_torch.ops import hopper_kernels
from babble_tpu_torch.ops import incremental as tinc
from babble_tpu_torch.ops.mesh import (ColumnShards, count_below, engine_mesh_devices,
                                       mesh_devices, take_chains)

from test_torch_incremental import SMALL, delta, feed
from test_torch_node_core import keyed

torch.set_num_threads(1)

N, E, BS = 16, 1200, 131
RESET = dict(n=6, e=240, bs=50, root_round=np.array([3, 4, 3, 5, 4, 3], np.int32),
             index_base=np.array([4, 0, 7, 2, 9, 1], np.int32))
SHARDED = ("_la", "_chain_la", "_ranks")


def grid(shape, d):
    """The mesh argument: d CPU devices, flat or as a 2 x d/2 grid."""
    return ["cpu"] * d if shape == "1d" else [["cpu"] * (d // 2)] * 2


def run_batches(engines, dag, e, bs, index_base=None):
    """Feed the batches to every engine, running each after each batch;
    returns each engine's RunDeltas."""
    out = [[] for _ in engines]
    for k in range(0, e, bs):
        hi = min(k + bs, e)
        for g, deltas in zip(engines, out):
            feed(g, dag, k, hi, index_base=index_base)
            deltas.append(delta(g.run()))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX single-device engine over the test DAG: its RunDeltas and
    final engine."""
    dag, _ = synthetic_dag(N, E, seed=5)
    j = jinc.IncrementalEngine(N, **SMALL)
    (deltas,) = run_batches([j], dag, E, BS)
    return dag, deltas, j


def assert_state(t, j):
    for name in ("rounds", "witness", "rr", "cts_ns", "famous"):
        assert np.array_equal(getattr(t, name), getattr(j, name)), name
    assert np.array_equal(t.witness_table(), j.witness_table())
    assert t.undecided_rounds == j.undecided_rounds
    assert t.last_consensus_round == j.last_consensus_round


def assert_partitioned(eng, single, d):
    for name in SHARDED:
        total = getattr(single, name).numel()
        sizes = [t.numel() for t in eng.shards(name)]
        assert len(sizes) == d, name
        assert max(sizes) < total, f"{name} is whole on a shard"
        assert sum(sizes) == total, name


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("shape", ["1d", "dcn-ici"])
def test_mesh_engine_matches_jax_and_single_device(jax_run, shape, d):
    dag, want, j = jax_run
    single = tinc.IncrementalEngine(N, device="cpu", **SMALL)
    eng = tinc.IncrementalEngine(N, mesh=grid(shape, d), **SMALL)
    try:
        got_single, got = run_batches([single, eng], dag, E, BS)
    finally:
        single.close()
        eng.close()
    assert eng._mesh == [torch.device("cpu")] * d
    assert single.cap > SMALL["capacity"] and single.kcap > SMALL["k_capacity"]
    for k, (g, s, w) in enumerate(zip(got, got_single, want)):
        assert g == s == w, k
    assert_state(eng, j)
    assert_partitioned(eng, single, d)


@pytest.fixture(scope="module")
def jax_reset_run():
    dag, _ = synthetic_dag(RESET["n"], RESET["e"], seed=5)
    kw = dict(root_round=RESET["root_round"], index_base=RESET["index_base"],
              from_reset=True)
    j = jinc.IncrementalEngine(RESET["n"], **SMALL, **kw)
    (deltas,) = run_batches([j], dag, RESET["e"], RESET["bs"], RESET["index_base"])
    return dag, deltas, j, kw


@pytest.mark.parametrize("d", [2, 3])
def test_frame_reset_mesh_engine_matches_jax(jax_reset_run, d):
    dag, want, j, kw = jax_reset_run
    eng = tinc.IncrementalEngine(RESET["n"], mesh=["cpu"] * d, **SMALL, **kw)
    single = tinc.IncrementalEngine(RESET["n"], device="cpu", **SMALL, **kw)
    try:
        assert eng.rho_min == 4 and eng.undecided_rounds == []
        got, got_single = run_batches([eng, single], dag, RESET["e"], RESET["bs"],
                                      RESET["index_base"])
    finally:
        eng.close()
        single.close()
    for k, (g, s, w) in enumerate(zip(got, got_single, want)):
        assert g == s == w, k
    assert_state(eng, j)
    assert_partitioned(eng, single, d)


def test_node_engine_mesh_gossip():
    """4 in-memory torch nodes whose engines hold their carries in 4
    shards (Config.engine_mesh): gossip converges as with the
    single-device engine."""
    from test_torch_node import check_gossip, make_nodes, run_gossip

    nodes = make_nodes(["torch"] * 4, engine_mesh=4)
    for node in nodes:
        eng = node.core.hg.engine
        assert eng._mesh is not None and len(eng.shards("_la")) == 4
    run_gossip(nodes, target_round=3)
    check_gossip(nodes)


def test_engine_mesh_shrinks_to_a_divisor(caplog):
    """engine_mesh=3 over 4 validators: 2 shards and the JAX Core's
    warning; engine_mesh 0 and 1 are the unsharded engine."""
    keys, participants = keyed(4)
    opts = dict(SMALL, device="cpu")
    with caplog.at_level(logging.WARNING, logger="babble_tpu_torch"):
        core = Core(0, keys[0], participants, InmemStore(participants, 1000),
                    engine="torch", engine_mesh=3, engine_opts=opts)
    try:
        assert len(core.hg.engine.shards("_la")) == 2
        assert "engine_mesh=3 does not divide 4 validators; using 2 device(s)" in caplog.text
    finally:
        core.hg.close()
    assert engine_mesh_devices(0, 4, "cpu") is None
    assert engine_mesh_devices(1, 4, "cpu") is None
    assert engine_mesh_devices(4, 4, "cpu") == [torch.device("cpu")] * 4


def test_probe_once_per_chain_shard_on_whole_rows(monkeypatch):
    """One pass of the single-device engine and of a 4-shard engine over
    the same batch: the mesh engine's frontier probe launches are d
    times the single engine's, each on its chain shard's own chain_la
    rows ((n/d)·K of them); the skip correction and fame launch as
    often; and every launch's row and witness tables are n wide."""
    real = hopper_kernels.strongly_see_gathered
    calls = []

    def spy(x_tab, xs, f_tab, w_tab, wrow, sm, mode):
        calls.append((sys._getframe(1).f_code.co_name, tuple(x_tab.shape),
                      tuple(f_tab.shape), xs.numel()))
        return real(x_tab, xs, f_tab, w_tab, wrow, sm, mode)

    monkeypatch.setattr(hopper_kernels, "strongly_see_gathered", spy)
    dag, _ = synthetic_dag(N, 600, seed=3)
    d = 4
    by = {}
    for name, kw in (("single", {"device": "cpu"}), ("mesh", {"mesh": ["cpu"] * d})):
        calls.clear()
        eng = tinc.IncrementalEngine(N, **SMALL, **kw)
        feed(eng, dag, 0, 600)
        eng.run()
        eng.close()
        by[name] = list(calls)
        k = eng.kcap
    assert all(x[1] == N and f[1] == N for _, x, f, _ in by["single"] + by["mesh"])
    count = {name: {site: sum(c[0] == site for c in cs) for site in
                    ("sees_sm", "step", "decide_fame")} for name, cs in by.items()}
    assert min(count["single"].values()) > 0
    assert count["mesh"]["sees_sm"] == d * count["single"]["sees_sm"]
    assert count["mesh"]["step"] == count["single"]["step"]
    assert count["mesh"]["decide_fame"] == count["single"]["decide_fame"]
    assert {c[1] for c in by["mesh"] if c[0] == "sees_sm"} == {(N // d * k, N)}
    assert {c[1] for c in by["mesh"] if c[0] == "step"} == {(N, N)}


def test_mesh_helpers_match_dense():
    """ColumnShards' row and element gathers, take_chains and
    count_below on the shards of random tables equal the dense reads;
    mesh_devices flattens a 2 x 2 grid a-major."""
    rng = np.random.default_rng(4)
    n, d, rows, k = 8, 4, 20, 6
    la = torch.from_numpy(rng.integers(-1, 50, (rows, n)).astype(np.int32))
    view = ColumnShards(list(la.split(n // d, 1)), torch.device("cpu"))
    ids = torch.from_numpy(rng.integers(0, rows, (3, 5)).astype(np.int32))
    assert torch.equal(view[ids], la[ids]) and view.shape == (rows, n)
    cols = torch.from_numpy(rng.integers(0, n, (3, 1)).astype(np.int32))
    assert torch.equal(view[ids, cols], la[ids, cols])
    tab = torch.from_numpy(rng.integers(0, 9, (n, k)).astype(np.int32))
    parts = list(tab.split(n // d, 0))
    pos = torch.from_numpy(rng.integers(0, k, (7, n)))
    assert torch.equal(take_chains(parts, pos), tab[torch.arange(n)[None, :], pos])
    assert torch.equal(count_below(parts, 5, "cpu"), (tab < 5).sum(1, dtype=torch.int32))
    devs = mesh_devices([["cpu", "meta"], ["cpu", "meta"]])
    assert [dv.type for dv in devs] == ["cpu", "meta", "cpu", "meta"]


def test_mesh_cost_report_memory_stats_and_prewarm():
    """The cost report counts each shard's bytes, so a 4-shard engine's
    report of a pass equals the single-device engine's (the same bytes,
    split); device_memory_stats counts every shard and names the shards
    and the distinct devices (one, the CPU); prewarm runs a scratch
    engine on the same mesh."""
    dag, _ = synthetic_dag(N, 300, seed=3)
    single = tinc.IncrementalEngine(N, device="cpu", **SMALL)
    eng = tinc.IncrementalEngine(N, mesh=["cpu"] * 4, **SMALL)
    try:
        for g in (single, eng):
            feed(g, dag, 0, 150)
            g.run()
            g.request_cost_report()
            feed(g, dag, 150, 300)
            g.run()
        assert eng.cost_report == single.cost_report
        stats, want = eng.device_memory_stats(), single.device_memory_stats()
        assert stats["device_bytes"] == want["device_bytes"] > 0
        assert stats["mesh_shards"] == 4 and stats["mesh_devices"] == 1
        assert eng.prewarm() is True
    finally:
        single.close()
        eng.close()
