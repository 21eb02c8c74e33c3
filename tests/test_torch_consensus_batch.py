"""The port's one-shot batch driver (babble_tpu_torch/ops/engine.py
`run_consensus_batch`, with `ops/dag.py::build_dag`) against the JAX
package's, on the CPU. Tolerance: exact equality.

Inputs: the reference fixture graphs (round, consensus, funky, coin) and
signed random gossip at n = 4 and 8, each event carried across by its
Go-JSON bytes. Compared: the DAG arrays, rounds, witness flags and
table, fame, round received, consensus-timestamp ranks and times, the
consensus order, block bytes, last_consensus_round and
undecided_rounds. One stream has two events with equal S (set by hand)
and one shared timestamp, so the order's S key ties and must keep id
order, as the reference's stable sort does."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from babble_tpu import crypto as jcrypto
from babble_tpu.gojson import BigInt, Timestamp
from babble_tpu.hashgraph import Event as JEvent
from babble_tpu.ops import build_dag as jax_build_dag
from babble_tpu.ops import run_consensus_batch as jax_run_consensus_batch
from babble_tpu_torch.ops import build_dag, run_consensus_batch

from test_async_pipeline import _signed_gossip_events
from test_torch_models import carry_event, fixture_builder

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

DAG_ARRAYS = ("self_parent", "other_parent", "creator", "index", "coin",
              "ts_rank", "ts_values", "levels", "chain", "chain_len",
              "chain_rank", "root_round")


def assert_same_result(want, got):
    for name in DAG_ARRAYS:
        assert np.array_equal(getattr(got.dag, name), getattr(want.dag, name)), name
    assert got.dag.hexes == want.dag.hexes
    assert got.dag.hex_to_id == want.dag.hex_to_id
    for name in ("rounds", "witness", "witness_table", "famous",
                 "round_received", "cts_rank"):
        assert np.array_equal(getattr(got, name), np.asarray(getattr(want, name))), name
    assert got.consensus_order == want.consensus_order
    assert [b.marshal() for b in got.blocks] == [b.marshal() for b in want.blocks]
    assert got.last_consensus_round == want.last_consensus_round
    assert got.undecided_rounds == want.undecided_rounds
    for eid, h in enumerate(want.dag.hexes):
        assert got.round_of(h) == want.round_of(h)
        assert int(got.fame_of(h)) == int(want.fame_of(h))
        assert got.consensus_timestamp(eid).ns == want.consensus_timestamp(eid).ns
    for r in range(want.witness_table.shape[0]):
        assert got.witnesses_of_round(r) == want.witnesses_of_round(r)


def both(events, participants):
    want = jax_run_consensus_batch(events, participants)
    got = run_consensus_batch([carry_event(ev) for ev in events], participants,
                              device="cpu")
    return want, got


@pytest.mark.parametrize("name", ["round", "consensus", "funky", "coin"])
def test_fixture_batches_match(name):
    b = fixture_builder(name)
    want, got = both(b.ordered_events, b.participants())
    assert_same_result(want, got)


@pytest.mark.parametrize("n,e", [(4, 240), (8, 400)], ids=["n4", "n8"])
def test_signed_gossip_batches_match(n, e):
    events, participants = _signed_gossip_events(n, e, seed=n)
    want, got = both(events, participants)
    assert len(want.consensus_order) > e // 2
    assert_same_result(want, got)


def _tied_gossip(n=4, e=160, tie=(9, 11)):
    """Signed gossip with one timestamp for every event, and event
    tie[1]'s S set to event tie[0]'s (so its signature no longer
    verifies; the batch driver does not check signatures)."""
    rng = np.random.default_rng(5)
    keys = [jcrypto.key_from_seed(6000 + i) for i in range(n)]
    pubs = [jcrypto.pub_key_bytes(k) for k in keys]
    participants = {"0x" + p.hex().upper(): i for i, p in enumerate(pubs)}
    heads, seqs, events = [""] * n, [-1] * n, []
    for i in range(e):
        c = i if i < n else int(rng.integers(0, n))
        op = heads[(c + int(rng.integers(1, n))) % n] if i >= n else ""
        seqs[c] += 1
        ev = JEvent.new([b"t%d" % i], [heads[c], op], pubs[c], seqs[c],
                        timestamp=Timestamp(1_700_000_000_000_000_000))
        ev.sign(keys[c])
        if i == tie[1]:
            ev.s = BigInt(int(events[tie[0]].s))
            ev.invalidate(body=False)
        heads[c] = ev.hex()
        events.append(ev)
    return events, participants


def test_s_tie_keeps_id_order():
    events, participants = _tied_gossip()
    want, got = both(events, participants)
    assert_same_result(want, got)
    a, b = events[9].hex(), events[11].hex()
    dag = got.dag
    assert int(events[9].s) == int(events[11].s)
    assert got.round_received[dag.hex_to_id[a]] == got.round_received[dag.hex_to_id[b]] >= 0
    assert got.cts_rank[dag.hex_to_id[a]] == got.cts_rank[dag.hex_to_id[b]]
    assert got.consensus_order.index(a) < got.consensus_order.index(b)


def test_build_dag_rejects_a_parent_outside_the_batch():
    b = fixture_builder("round")
    events = [carry_event(ev) for ev in b.ordered_events]
    participants = b.participants()
    with pytest.raises(ValueError, match="not in batch"):
        build_dag(events[3:], participants)
    with pytest.raises(ValueError, match="not in batch"):
        jax_build_dag(b.ordered_events[3:], participants)


def test_run_consensus_batch_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    b = fixture_builder("round")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_consensus_batch([carry_event(ev) for ev in b.ordered_events],
                            b.participants())
