"""The port's host Hashgraph (babble_tpu_torch/hashgraph/graph.py)
against the JAX package's, on the reference fixture graphs (basic,
round, consensus, funky, coin), on the CPU. Tolerance: exact equality.

Both graphs take the same events (the port's carried across by their
Go-JSON bytes). Compared: ancestor, self-ancestor, see and strongly see
for every pair of events; round, witness, fame and round received for
every event; consensus_events(), blocks' bytes, known(); get_frame,
reset with hand-made roots, and reset from a frame."""

from __future__ import annotations

import pytest

from babble_tpu.common import StoreError as JStoreError
from babble_tpu.hashgraph import Event as JEvent
from babble_tpu.hashgraph import Root as JRoot
from babble_tpu_torch.common import StoreError as TStoreError
from babble_tpu_torch.hashgraph import Event as TEvent
from babble_tpu_torch.hashgraph import Hashgraph as THashgraph
from babble_tpu_torch.hashgraph import InmemStore as TInmemStore
from babble_tpu_torch.hashgraph.graph import InsertError as TInsertError

from fixtures import CACHE_SIZE, GraphBuilder
from test_torch_models import FIXTURES, carry_event, carry_roots, fixture_builder


def port_twin(b, basic=False):
    """The port's Hashgraph fed the builder's events (carried across);
    the basic graph installs them without the insert pipeline, as the
    fixture does."""
    participants = b.participants()
    t = THashgraph(participants, TInmemStore(participants, CACHE_SIZE))
    for ev in b.ordered_events:
        te = carry_event(ev)
        if basic:
            t._init_event_coordinates(te)
            t.store.set_event(te)
            t._update_ancestor_first_descendant(te)
        else:
            t.insert_event(te, True)
    return t


def jax_twin(b, basic=False):
    h = b.make_hashgraph()
    for ev in b.ordered_events:
        if basic:
            h._init_event_coordinates(ev)
            h.store.set_event(ev)
            h._update_ancestor_first_descendant(ev)
        else:
            h.insert_event(ev, True)
    return h


def twins(name):
    b = fixture_builder(name)
    basic = name == "basic"
    return jax_twin(b, basic), port_twin(b, basic), b


def run_all(*graphs):
    for g in graphs:
        g.divide_rounds()
        g.decide_fame()
        g.find_order()


def assert_same_consensus(h, t, hexes):
    """Per-event rounds/witness/round received, per-round witness sets
    and fame, the consensus list, blocks, bookkeeping."""
    assert t.store.last_round() == h.store.last_round()
    for x in hexes:
        assert t.round(x) == h.round(x)
        assert t.witness(x) == h.witness(x)
        assert t.round_received(x) == h.round_received(x)
    for r in range(h.store.last_round() + 1):
        try:
            hri = h.store.get_round(r)
        except JStoreError:
            with pytest.raises(TStoreError):
                t.store.get_round(r)
            continue
        tri = t.store.get_round(r)
        assert tri.witnesses() == hri.witnesses(), r
        assert {x: int(e.famous) for x, e in tri.events.items()} == \
            {x: int(e.famous) for x, e in hri.events.items()}, r
    assert t.consensus_events() == h.consensus_events()
    for x in h.consensus_events():
        assert (t.store.get_event(x).consensus_timestamp.ns
                == h.store.get_event(x).consensus_timestamp.ns)
    assert t.last_consensus_round == h.last_consensus_round
    assert t.pending_loaded_events == h.pending_loaded_events
    assert t.consensus_transactions == h.consensus_transactions
    assert t.known() == h.known()
    for r in range(h.store.last_round() + 2):
        try:
            hb = h.store.get_block(r)
        except JStoreError:
            with pytest.raises(TStoreError):
                t.store.get_block(r)
            continue
        assert t.store.get_block(r).marshal() == hb.marshal(), r


@pytest.mark.parametrize("name", FIXTURES)
def test_pairwise_relations_match(name):
    h, t, b = twins(name)
    hexes = [ev.hex() for ev in b.ordered_events] + [""]
    for x in hexes[:-1]:
        for y in hexes:
            assert t.ancestor(x, y) == h.ancestor(x, y)
            assert t.self_ancestor(x, y) == h.self_ancestor(x, y)
            assert t.see(x, y) == h.see(x, y)
            if y:
                assert t.strongly_see(x, y) == h.strongly_see(x, y)
    for x in hexes[:-1]:
        te, he = t.store.get_event(x), h.store.get_event(x)
        assert [(c.index, c.hash) for c in te.last_ancestors] == \
            [(c.index, c.hash) for c in he.last_ancestors]
        assert [(c.index, c.hash) for c in te.first_descendants] == \
            [(c.index, c.hash) for c in he.first_descendants]
    assert t.known() == h.known()


@pytest.mark.parametrize("name", [f for f in FIXTURES if f != "basic"])
def test_consensus_matches(name):
    h, t, b = twins(name)
    run_all(h, t)
    assert_same_consensus(h, t, [ev.hex() for ev in b.ordered_events])
    assert t.undecided_rounds == h.undecided_rounds


@pytest.mark.parametrize("name", ["round", "consensus"])
def test_wire_roundtrip_matches(name):
    h, t, b = twins(name)
    for ev in b.ordered_events:
        hw = h.store.get_event(ev.hex()).to_wire()
        tw = t.store.get_event(ev.hex()).to_wire()
        assert tw.to_dict() == hw.to_dict()
        assert t.read_wire_info(tw).hex() == h.read_wire_info(hw).hex()
    got = t.read_wire_batch([t.store.get_event(ev.hex()).to_wire()
                             for ev in b.ordered_events])
    assert [e.hex() for e in got] == [ev.hex() for ev in b.ordered_events]


def test_fork_rejected_in_port():
    """A second index-0 event by the same creator is refused."""
    b = GraphBuilder(3)
    participants = b.participants()
    t = THashgraph(participants, TInmemStore(participants, CACHE_SIZE))
    for i in range(3):
        t.insert_event(carry_event(b.add_initial(f"e{i}", i)), True)
    fork = JEvent.new([b"yo"], ["", ""], b.nodes[2].pub, 0, timestamp=b._next_ts())
    fork.sign(b.nodes[2].key)
    with pytest.raises(TInsertError):
        t.insert_event(carry_event(fork), True)


def test_get_frame_and_reset_from_frame_match():
    h, t, b = twins("consensus")
    run_all(h, t)
    hf, tf = h.get_frame(), t.get_frame()
    assert [e.hex() for e in tf.events] == [e.hex() for e in hf.events]
    assert {k: r.to_dict() for k, r in tf.roots.items()} == \
        {k: r.to_dict() for k, r in hf.roots.items()}

    h.reset(hf.roots)
    t.reset(tf.roots)
    for ev in hf.events:
        h.insert_event(JEvent(ev.body, r=ev.r, s=ev.s), False)
    for ev in tf.events:
        t.insert_event(TEvent(ev.body, r=ev.r, s=ev.s), False)
    assert t.known() == h.known() == {0: 8, 1: 7, 2: 7}
    run_all(h, t)
    assert h.last_consensus_round == 1
    assert_same_consensus(h, t, [e.hex() for e in hf.events])


def test_reset_with_roots_matches():
    h, t, b = twins("consensus")
    run_all(h, t)
    i = b.index
    evs = ["g1", "g0", "g2", "g10", "g21", "o02", "g02", "h1", "h0", "h2"]
    roots = {
        h.reverse_participants[0]: JRoot(x=i["f02b"], y=i["g1"], index=4,
                                         round=2, others={i["o02"]: i["f21"]}),
        h.reverse_participants[1]: JRoot(x=i["f10"], y=i["f02b"], index=4, round=2),
        h.reverse_participants[2]: JRoot(x=i["f21"], y=i["g1"], index=4, round=2),
    }
    hb = [h.store.get_event(i[nm]) for nm in evs]
    tb = [t.store.get_event(i[nm]) for nm in evs]
    h.reset(roots)
    t.reset(carry_roots(roots))
    for eh, et in zip(hb, tb):
        h.insert_event(JEvent(eh.body, r=eh.r, s=eh.s), False)
        t.insert_event(TEvent(et.body, r=et.r, s=et.s), False)
    assert t.known() == h.known() == {0: 8, 1: 7, 2: 7}
    run_all(h, t)
    assert_same_consensus(h, t, [i[nm] for nm in evs])
