"""The engine's work items and its fame span (babble_tpu_torch/TRACING.md)
at the BFT bound's edge: n = 16 validators of which 5 are silent, so the
11 creators are exactly the supermajority 2n/3 + 1, beside the same
network with every validator but one creating (f = 0).

Each pass's counts (passes, fame's depth steps, undecided rounds,
frontier rounds, redos) equal what the engine's own state gives; the
`engine.fame` span carries its rows and steps and lies inside
`engine.fame_rr`; a Core takes the counts into its phases as items; and
neither the counts nor the span ring changes a result: packed buffers,
RunDeltas, the order and the blocks are equal with the ring on and off."""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from babble_tpu_torch import crypto
from babble_tpu_torch.hashgraph import InmemStore
from babble_tpu_torch.node import Core
from babble_tpu_torch.ops import incremental as tinc
from babble_tpu_torch.ops.dag import synthetic_dag
from babble_tpu_torch.telemetry.trace import SpanRing

torch.set_num_threads(1)

N = 16
SMALL = dict(capacity=64, block=64, k_capacity=8)
COUNTS = ("passes", "fame_steps", "undecided_rounds", "frontier_rounds", "redos")


def edge_dag(f, e, seed=5):
    """A gossip DAG of n = 16 validators whose last 1 + f are silent."""
    dag, _ = synthetic_dag(N - 1 - f, e, seed=seed)
    return dag


def feed(eng, dag, lo, hi):
    eng.append_batch(dag.self_parent[lo:hi], dag.other_parent[lo:hi], dag.creator[lo:hi],
                     dag.index[lo:hi], dag.coin[lo:hi], np.arange(lo, hi))


@pytest.fixture
def fame_reads(monkeypatch):
    """The depth steps of every decide_fame call, in call order."""
    seen = []
    real = tinc.kernels.decide_fame

    def spy(*a, reads=None, **kw):
        mine = []
        out = real(*a, reads=mine, **kw)
        seen.append(len(mine))
        if reads is not None:
            reads += mine
        return out

    monkeypatch.setattr(tinc.kernels, "decide_fame", spy)
    return seen


def small_rcap_floor(monkeypatch):
    """rcap's floor of 2,048 rows at small n made 8, so the frontier
    table overflows and the pass redoes its epilogue."""
    orig = tinc._pow2
    monkeypatch.setattr(tinc, "_pow2", lambda x, floor=8: orig(x, 8 if floor == 2048 else floor))


def passes(eng, dag, bs, fame_reads=()):
    """Each pass over the DAG in batches of `bs`: its packed buffer, its
    RunDelta, the counts taken after it, and what the engine's state
    and the fame spy give for it."""
    out = []
    for lo in range(0, dag.e, bs):
        feed(eng, dag, lo, min(lo + bs, dag.e))
        redo0, calls0 = eng.redo_count, len(fame_reads)
        pp = eng.dispatch()
        delta = dataclasses.asdict(eng.collect(pp))
        win = eng._dbg_windows
        state = {"passes": 1, "fame_steps": sum(fame_reads[calls0:]),
                 "undecided_rounds": len(eng.undecided_rounds),
                 "frontier_rounds": win["t_end"] - win["t0"],
                 "redos": eng.redo_count - redo0}
        out.append({"packed": pp.packed_host.numpy().copy(), "delta": delta,
                    "counts": eng.take_pass_counts(), "state": state,
                    "last_fame_reads": win["fame_reads"], "again": eng.take_pass_counts()})
    return out


@pytest.mark.parametrize("f,e,bs,redo", [(4, 700, 70, False), (0, 700, 70, False),
                                        (4, 1400, 1000, True)],
                         ids=["edge", "f0", "edge-redo"])
def test_pass_counts_are_the_engines_own(monkeypatch, fame_reads, f, e, bs, redo):
    if redo:  # a first pass of 1,000 events sweeps past 8 rows
        small_rcap_floor(monkeypatch)
    dag = edge_dag(f, e)
    ring = SpanRing(1 << 14)
    eng = tinc.IncrementalEngine(N, device="cpu", trace=ring, **SMALL)
    try:
        got = passes(eng, dag, bs, fame_reads)
    finally:
        eng.close()
    for k, ps in enumerate(got):
        assert ps["counts"] == ps["state"], k
        assert ps["again"] == {}, k
        if not ps["state"]["redos"]:
            assert ps["counts"]["fame_steps"] == ps["last_fame_reads"], k
    total = {k: sum(ps["counts"][k] for ps in got) for k in COUNTS}
    assert total["passes"] == len(got) and total["fame_steps"] > 0
    assert total["undecided_rounds"] > 0 and total["frontier_rounds"] > 0
    assert (total["redos"] > 0) is redo

    # one engine.fame span a decide_fame call, inside a fame_rr of its pass
    spans = ring.snapshot()
    fame = [s for s in spans if s["name"] == "engine.fame"]
    fame_rr = [s for s in spans if s["name"] == "engine.fame_rr"]
    assert [s["args"]["steps"] for s in fame] == fame_reads
    assert all(s["args"]["rows"] >= 2 for s in fame)
    for s in fame:
        pid = s["args"]["pass_id"]
        assert any(r["args"]["pass_id"] == pid and r["t0"] <= s["t0"] <= s["t1"] <= r["t1"]
                   for r in fame_rr), s


@pytest.mark.parametrize("f", [4, 0], ids=["edge", "f0"])
def test_the_ring_changes_no_result(f):
    """The same DAG through an engine with a span ring and one without:
    every packed buffer, RunDelta and count equal word for word."""
    dag = edge_dag(f, 500, seed=7)
    ring = SpanRing(1 << 14)
    on = tinc.IncrementalEngine(N, device="cpu", trace=ring, **SMALL)
    off = tinc.IncrementalEngine(N, device="cpu", **SMALL)
    try:
        a, b = passes(on, dag, 45), passes(off, dag, 45)
        assert len(a) == len(b)
        for k, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x["packed"], y["packed"]), k
            assert x["delta"] == y["delta"] and x["counts"] == y["counts"], k
        assert any(s["name"] == "engine.fame" for s in ring.snapshot())
        assert off.trace.capacity == 0 and len(off.trace) == 0
    finally:
        on.close()
        off.close()


def keyed(n, seed_base=9300):
    keys = [crypto.key_from_seed(seed_base + i) for i in range(n)]
    pubs = ["0x" + crypto.pub_key_bytes(k).hex().upper() for k in keys]
    order = sorted(range(n), key=lambda i: pubs[i])
    return [keys[i] for i in order], {pubs[i]: k for k, i in enumerate(order)}


def test_a_core_counts_the_engines_items_at_the_edge(fame_reads):
    """Eleven host Cores gossip (the 5 other validators are silent) and
    two torch Cores of the silent node take the same wire batches, one
    with a span ring: both order the same events and commit the same
    blocks, their engine_* counters are equal, the counts are the
    engine's (fame's steps as the kernel took them, one pass a collect),
    and only the ring's Core records the fame span."""
    keys, participants = keyed(N)
    live = range(N - 1 - 4)
    peers = [Core(i, keys[i], participants, InmemStore(participants, 10_000), engine="host")
             for i in live]
    ring = SpanRing(1 << 14)
    blocks = {"on": [], "off": []}
    nodes = {name: Core(N - 1, keys[N - 1], participants, InmemStore(participants, 10_000),
                        commit_callback=blocks[name].append, engine="torch",
                        engine_opts={**SMALL, "device": "cpu"},
                        trace=ring if name == "on" else None)
             for name in ("on", "off")}
    try:
        for c in peers + list(nodes.values()):
            c.init()
        rng = random.Random(11)
        steps_of = {name: 0 for name in nodes}
        for step in range(1200):
            a, b = rng.sample(range(len(peers)), 2)
            if step % 2:
                peers[a].add_transactions([b"tx %d" % step])
            peers[a].sync(peers[b].to_wire_batch(peers[b].diff(peers[a].known()), "columnar"))
            if step % 100 == 99:
                src = peers[rng.randrange(len(peers))]
                for name, node in nodes.items():
                    node.sync(src.to_wire_batch(src.diff(node.known()), "columnar"))
                    n_calls = len(fame_reads)
                    node.collect_consensus(node.dispatch_consensus())
                    steps_of[name] += sum(fame_reads[n_calls:])
        on, off = nodes["on"], nodes["off"]
        order = on.get_consensus_events()
        assert order and order == off.get_consensus_events()
        assert blocks["on"] and [x.marshal() for x in blocks["on"]] == [
            x.marshal() for x in blocks["off"]]
        items = {name: {k: node.phase_ns[f"engine_{k}"][2] for k in COUNTS}
                 for name, node in nodes.items()}
        assert items["on"] == items["off"]
        assert items["on"]["passes"] == on.phase_ns["consensus_collect"][2] == 12
        assert items["on"]["fame_steps"] == steps_of["on"] == steps_of["off"] > 0
        assert all(on.phase_ns[f"engine_{k}"][:2] == [0, 0] for k in COUNTS)
        fame = [s for s in ring.snapshot() if s["name"] == "engine.fame"]
        assert fame and sum(s["args"]["steps"] for s in fame) == steps_of["on"]
        assert {"rows", "steps", "pass_id"} <= set(fame[0]["args"])
        assert len(off.trace) == 0
    finally:
        for node in nodes.values():
            node.hg.close()
