"""The port's device-backed graph (babble_tpu_torch/hashgraph/torch_graph.py,
`TorchHashgraph(device="cpu")`) against the JAX package's `TpuHashgraph`
and host `Hashgraph`, on the CPU. Tolerance: exact equality.

Mirrors tests/test_incremental.py's TpuHashgraph tests (matches the
host engine with interleaved passes, consensus timestamps, get_frame,
reset with roots, reset from a frame, insert_wire_batch against serial
inserts), tests/test_async_pipeline.py's pipelined dispatch/collect
against the host oracle (n = 4, 360 signed events, engine growth across
dispatch boundaries) and tests/test_coin_round.py's coin-world parity.
Every event reaches the port carried across by its Go-JSON bytes; every
engine a test makes is closed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import babble_tpu_torch.hashgraph.graph as tgraph_mod
import babble_tpu_torch.hashgraph.torch_graph as ttorch_mod
from babble_tpu.hashgraph import Event as JEvent
from babble_tpu.hashgraph import Hashgraph as JHashgraph
from babble_tpu.hashgraph import InmemStore as JInmemStore
from babble_tpu.hashgraph import Root as JRoot
from babble_tpu.hashgraph.tpu_graph import TpuHashgraph
from babble_tpu_torch.hashgraph import Event as TEvent
from babble_tpu_torch.hashgraph import InmemStore as TInmemStore
from babble_tpu_torch.hashgraph import TorchHashgraph
from babble_tpu_torch.hashgraph.graph import InsertError

from fixtures import build_coin_graph, build_consensus_graph, build_funky_graph, build_round_graph
from test_async_pipeline import _signed_gossip_events
from test_torch_hashgraph import assert_same_consensus, run_all
from test_torch_models import carry_event, carry_roots

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

CACHE = 10000


@pytest.fixture
def engines():
    """Collects every graph a test makes and closes its engine."""
    made = []
    yield made
    for g in made:
        g.engine.close()


def torch_graph(engines, participants, **kw):
    kw.setdefault("capacity", 64)
    kw.setdefault("block", 64)
    t = TorchHashgraph(participants, TInmemStore(participants, kw.pop("cache", CACHE)),
                       device="cpu", **kw)
    engines.append(t)
    return t


def tpu_graph(engines, participants, **kw):
    kw.setdefault("capacity", 64)
    kw.setdefault("block", 64)
    t = TpuHashgraph(participants, JInmemStore(participants, kw.pop("cache", CACHE)), **kw)
    engines.append(t)
    return t


def make_twin(engines, build):
    """Host graph with consensus run, and a TorchHashgraph fed the same
    events (consensus run once at the end)."""
    h, b = build()
    run_all(h)
    t = torch_graph(engines, b.participants())
    for ev in b.ordered_events:
        t.insert_event(carry_event(ev), True)
    t.run_consensus()
    return h, b, t


@pytest.mark.parametrize(
    "build,every",
    [(build_round_graph, 4), (build_consensus_graph, 7), (build_funky_graph, 3)],
    ids=["round", "consensus", "funky"],
)
def test_torch_graph_matches_host(engines, build, every):
    """Interleaved run_consensus calls reproduce the host engine's and
    the JAX device graph's rounds, witness sets, fame, consensus order
    and blocks."""
    h, b = build()
    run_all(h)
    participants = b.participants()
    t = torch_graph(engines, participants)
    j = tpu_graph(engines, participants)
    for k, ev in enumerate(b.ordered_events):
        t.insert_event(carry_event(ev), True)
        j.insert_event(ev, True)
        if (k + 1) % every == 0:
            t.run_consensus()
            j.run_consensus()
            assert t.consensus_events() == j.consensus_events()
            assert t.undecided_rounds == j.undecided_rounds
    t.run_consensus()
    j.run_consensus()
    hexes = [ev.hex() for ev in b.ordered_events]
    assert_same_consensus(h, t, hexes)
    assert_same_consensus(j, t, hexes)
    assert t.undecided_rounds == j.undecided_rounds
    assert set(t.undetermined_events) == set(h.undetermined_events)


def test_torch_graph_consensus_timestamps(engines):
    h, b, t = make_twin(engines, build_consensus_graph)
    assert h.consensus_events()
    for x in h.consensus_events():
        assert (t.store.get_event(x).consensus_timestamp.ns
                == h.store.get_event(x).consensus_timestamp.ns), b.get_name(x)


def test_torch_graph_get_frame_matches_host(engines):
    h, b, t = make_twin(engines, build_consensus_graph)
    hf, tf = h.get_frame(), t.get_frame()
    assert [e.hex() for e in tf.events] == [e.hex() for e in hf.events]
    assert {k: r.to_dict() for k, r in tf.roots.items()} == \
        {k: r.to_dict() for k, r in hf.roots.items()}


def test_torch_reset(engines):
    """Hand-made roots with offset chain bases and an Others entry,
    then the tail replayed on the device engine."""
    h, b, t = make_twin(engines, build_consensus_graph)
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
    old_engine = t.engine
    h.reset(roots)
    t.reset(carry_roots(roots))
    assert t.engine is not old_engine and t.engine.device.type == "cpu"
    for eh, et in zip(hb, tb):
        h.insert_event(JEvent(eh.body, r=eh.r, s=eh.s), False)
        t.insert_event(TEvent(et.body, r=et.r, s=et.s), False)
    assert t.known() == h.known() == {0: 8, 1: 7, 2: 7}
    run_all(h)
    t.run_consensus()
    assert_same_consensus(h, t, [i[nm] for nm in evs])


def test_torch_reset_from_frame(engines):
    h, b, t = make_twin(engines, build_consensus_graph)
    hf, tf = h.get_frame(), t.get_frame()
    h.reset(hf.roots)
    t.reset(tf.roots)
    for ev in hf.events:
        h.insert_event(JEvent(ev.body, r=ev.r, s=ev.s), False)
    for ev in tf.events:
        t.insert_event(TEvent(ev.body, r=ev.r, s=ev.s), False)
    assert t.known() == h.known() == {0: 8, 1: 7, 2: 7}
    run_all(h)
    t.run_consensus()
    assert h.last_consensus_round == 1
    assert_same_consensus(h, t, [e.hex() for e in hf.events])


def test_torch_insert_wire_batch_matches_serial_inserts(engines):
    """insert_wire_batch (host checks per event, one vectorized engine
    append) equals the serial insert_event loop; a bad signature mid-
    batch aborts there with the validated prefix inserted."""
    _, b = build_consensus_graph()
    participants = b.participants()
    serial = torch_graph(engines, participants)
    batched = torch_graph(engines, participants)
    evs = [carry_event(ev) for ev in b.ordered_events]
    for ev in evs:
        serial.insert_event(TEvent(ev.body, r=ev.r, s=ev.s), True)
    mid = len(evs) // 2
    batched.insert_wire_batch([TEvent(e.body, r=e.r, s=e.s) for e in evs[:mid]])
    batched.insert_wire_batch([TEvent(e.body, r=e.r, s=e.s) for e in evs[mid:]])

    assert serial.known() == batched.known()
    assert serial.undetermined_events == batched.undetermined_events
    for name in ("self_parent", "other_parent", "creator", "index", "coin",
                 "ts_ns", "chain", "chain_len"):
        assert np.array_equal(getattr(serial.engine, name),
                              getattr(batched.engine, name)), name
    serial.run_consensus()
    batched.run_consensus()
    assert serial.store.consensus_events() == batched.store.consensus_events()
    assert serial.last_consensus_round == batched.last_consensus_round

    # Bad signature at position 5: the first five land, nothing after.
    aborted = torch_graph(engines, participants)
    bad = [TEvent(e.body, r=e.r, s=e.s) for e in evs]
    bad[5] = TEvent(bad[5].body, r=bad[5].r, s=int(bad[5].s) ^ 1)
    with pytest.raises(InsertError, match="Invalid signature"):
        aborted.insert_wire_batch(bad)
    assert aborted.engine.e == 5
    assert aborted.undetermined_events == [e.hex() for e in evs[:5]]
    assert aborted.topological_index == 5
    aborted.insert_wire_batch([TEvent(e.body, r=e.r, s=e.s) for e in evs[5:]])
    aborted.run_consensus()
    assert aborted.consensus_events() == serial.consensus_events()


def test_async_torch_graph_matches_host_oracle(engines):
    """The pipelined seam driven as the node's consensus loop drives it
    (insert a chunk, collect the pass in flight, dispatch), with a tiny
    engine so growth crosses dispatch boundaries: the consensus order
    equals the host oracle's byte for byte."""
    events, participants = _signed_gossip_events(4, 360)
    host = JHashgraph(participants, JInmemStore(participants, 100000))
    for ev in events:
        host.insert_event(ev, True)
    host.run_consensus()

    t = torch_graph(engines, participants, capacity=64, block=64,
                    k_capacity=8, cache=100000)
    pending = None
    for lo in range(0, len(events), 60):
        for ev in events[lo:lo + 60]:
            t.insert_event(carry_event(ev), True)
        if pending is not None:
            t.collect_consensus(pending)
        pending = t.dispatch_consensus()
    t.collect_consensus(pending)
    while (pending := t.dispatch_consensus()) is not None:
        t.collect_consensus(pending)

    assert t.consensus_events() == host.consensus_events()
    assert len(t.consensus_events()) > 200
    for ev in events:
        x = ev.hex()
        assert t.round(x) == host.round(x)
        assert t.round_received(x) == host.round_received(x)


@pytest.fixture(scope="module")
def coin_builder():
    return build_coin_graph()


@pytest.mark.parametrize("const", [0, 1], ids=["coin0", "coin1"])
def test_coin_world_device_parity(engines, coin_builder, const, monkeypatch):
    """With the coin forced to each constant, the device graph decides
    the host's coin-world outcome (the coin true world decides w00
    through coin votes; the coin false world stalls round 0)."""
    import babble_tpu.hashgraph.graph as jgraph_mod

    b = coin_builder
    monkeypatch.setattr(jgraph_mod, "middle_bit", lambda hx: bool(const))
    h = b.make_hashgraph(JInmemStore(b.participants(), CACHE))
    for ev in b.ordered_events:
        h.insert_event(JEvent(ev.body, r=ev.r, s=ev.s), True)
    run_all(h)

    monkeypatch.setattr(tgraph_mod, "middle_bit", lambda hx: bool(const))
    monkeypatch.setattr(ttorch_mod, "middle_bit", lambda hx: bool(const))
    t = torch_graph(engines, b.participants())
    for ev in b.ordered_events:
        t.insert_event(carry_event(ev), True)
    t.run_consensus()

    w00 = b.index["w00"]
    assert (t.store.get_round(0).events[w00].famous
            == h.store.get_round(0).events[w00].famous)
    assert t.last_consensus_round == h.last_consensus_round == 3
    assert t.consensus_events() == h.consensus_events()
    assert len(t.consensus_events()) == (20 if const else 0)
    for r in range(h.store.last_round() + 1):
        hr, tr = h.store.get_round(r), t.store.get_round(r)
        assert set(hr.witnesses()) == set(tr.witnesses()), r
        for w in hr.witnesses():
            assert hr.events[w].famous == tr.events[w].famous, r


def test_torch_graph_without_cuda_raises():
    """With no device named the graph runs on CUDA, so it raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, b = build_round_graph()
    participants = b.participants()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchHashgraph(participants, TInmemStore(participants, CACHE))


def test_frame_replay_matches_host_replay(engines):
    """A graph reset from its own last frame and fed the frame's events
    decides as the reference host graph does after the same reset. On
    this stream both decide a round the original run had not (a
    reference behaviour the port keeps)."""
    import json

    import chip_smoke
    from babble_tpu.hashgraph.event import event_from_json_obj as jax_event_from_json_obj

    events, participants, _ = chip_smoke.signed_gossip(8, 3000, 3)
    kw = dict(capacity=1024, block=128, k_capacity=64, cache=100000)
    t = torch_graph(engines, participants, **kw)
    chip_smoke.drive_graph(t, events, batch=512)
    frame = t.get_frame()

    fresh = torch_graph(engines, participants, **kw)
    fresh.reset(frame.roots)
    for ev in frame.events:
        fresh.insert_event(TEvent(ev.body, r=ev.r, s=ev.s), False)
    fresh.run_consensus()

    h = JHashgraph(participants, JInmemStore(participants, 100000))
    h.reset({pk: JRoot(x=r.x, y=r.y, index=r.index, round=r.round, others=dict(r.others))
             for pk, r in frame.roots.items()})
    for ev in frame.events:
        h.insert_event(jax_event_from_json_obj(json.loads(ev.marshal())), False)
    h.run_consensus()

    assert fresh.consensus_events() == h.consensus_events()
    assert fresh.last_consensus_round == h.last_consensus_round
    for ev in frame.events:
        x = ev.hex()
        assert (fresh.round(x), fresh.round_received(x)) == (h.round(x), h.round_received(x))
    assert fresh.last_consensus_round == t.last_consensus_round + 1
    assert fresh.consensus_events()
    assert not set(fresh.consensus_events()) & set(t.consensus_events())
