"""The port's host models (babble_tpu_torch: common, gojson, crypto,
hashgraph models and InmemStore) against the JAX package's, on the CPU.
Tolerance: exact equality of every byte, hash and field.

- the Go-JSON vectors of tests/test_gojson.py through both packages;
- marshal/hash/hex of Event, WireEvent and Block (nil and empty
  transactions), and the fields of Root, RoundInfo and Frame;
- every event of the reference fixture graphs carried across by
  `event_from_json_obj` keeps its hex, bytes, R/S and signature;
- the deterministic signers (_fallback.sign, _openssl.sign) agree with
  each other and with the JAX package's, and signatures verify across
  packages;
- InmemStore CRUD and error types (tests/test_store.py's mirror).

The carry helpers here serve the other tests/test_torch_*.py files of
the hashgraph slice."""

from __future__ import annotations

import json

import pytest

from babble_tpu import crypto as jcrypto
from babble_tpu import gojson as jgojson
from babble_tpu.crypto import _fallback as jfb
from babble_tpu.hashgraph import Block as JBlock
from babble_tpu.hashgraph import Event as JEvent
from babble_tpu.hashgraph import Frame as JFrame
from babble_tpu.hashgraph import Root as JRoot
from babble_tpu.hashgraph import RoundInfo as JRoundInfo
from babble_tpu.hashgraph.event import EventBody as JEventBody
from babble_tpu_torch import common as tcommon
from babble_tpu_torch import crypto as tcrypto
from babble_tpu_torch import gojson as tgojson
from babble_tpu_torch.crypto import _fallback as tfb
from babble_tpu_torch.crypto import _openssl as tossl
from babble_tpu_torch.hashgraph import Block as TBlock
from babble_tpu_torch.hashgraph import Event as TEvent
from babble_tpu_torch.hashgraph import Frame as TFrame
from babble_tpu_torch.hashgraph import InmemStore as TInmemStore
from babble_tpu_torch.hashgraph import Root as TRoot
from babble_tpu_torch.hashgraph import RoundInfo as TRoundInfo
from babble_tpu_torch.hashgraph.event import event_from_json_obj

from fixtures import (
    build_basic_graph,
    build_coin_graph,
    build_consensus_graph,
    build_funky_graph,
    build_round_graph,
)

# ---------------------------------------------------------------- carry


def carry_event(ev):
    """The port's Event from a JAX Event, by its Go-JSON bytes."""
    return event_from_json_obj(json.loads(ev.marshal()))


def carry_root(r):
    return TRoot(x=r.x, y=r.y, index=r.index, round=r.round,
                 others=dict(r.others))


def carry_roots(roots):
    return {pk: carry_root(r) for pk, r in roots.items()}


def fixture_builder(name):
    """GraphBuilder of a reference fixture graph (events signed by the
    JAX package; their hashes differ run to run, never across the two
    packages)."""
    if name == "coin":
        return build_coin_graph()
    return {"basic": build_basic_graph, "round": build_round_graph,
            "consensus": build_consensus_graph,
            "funky": build_funky_graph}[name]()[1]


FIXTURES = ["basic", "round", "consensus", "funky", "coin"]

# ---------------------------------------------------------------- gojson


def _inner(g):
    class Inner(g.GoStruct):
        go_fields = (("A", "a"), ("B", "b"))

        def __init__(self, a, b):
            self.a = a
            self.b = b

    return Inner


GOJSON_VECTORS = {
    "int_str": (lambda g: g.marshal(_inner(g)(1, "x")), b'{"A":1,"B":"x"}\n'),
    "null_empty": (lambda g: g.marshal(_inner(g)(None, [])), b'{"A":null,"B":[]}\n'),
    "bools": (lambda g: g.marshal(_inner(g)(True, False)), b'{"A":true,"B":false}\n'),
    "bytes": (lambda g: g.marshal(_inner(g)(b"hi", None)), b'{"A":"aGk=","B":null}\n'),
    "byte_slices": (lambda g: g.marshal(_inner(g)([b"a", b"bc"], None)),
                    b'{"A":["YQ==","YmM="],"B":null}\n'),
    "html": (lambda g: g.marshal(_inner(g)("<&>", None)),
             b'{"A":"\\u003c\\u0026\\u003e","B":null}\n'),
    "bigint": (lambda g: g.marshal(_inner(g)(g.BigInt(2**300 + 7), 0)),
               b'{"A":%d,"B":0}\n' % (2**300 + 7)),
    "map_keys": (lambda g: g.marshal(_inner(g)({10: "x", 2: "y"}, None)),
                 b'{"A":{"10":"x","2":"y"},"B":null}\n'),
    "ts_nanos": (lambda g: g.Timestamp(1631536000 * 10**9 + 123).rfc3339nano(),
                 "2021-09-13T12:26:40.000000123Z"),
    "ts_trimmed": (lambda g: g.Timestamp(1631536000 * 10**9 + 500_000_000).rfc3339nano(),
                   "2021-09-13T12:26:40.5Z"),
    "ts_whole": (lambda g: g.Timestamp(1631536000 * 10**9).rfc3339nano(),
                 "2021-09-13T12:26:40Z"),
    "zero_time": (lambda g: g.ZERO_TIME.rfc3339nano(), "0001-01-01T00:00:00Z"),
    "parse_nanos": (lambda g: g.Timestamp.parse("2021-09-13T12:26:40.000000123Z").rfc3339nano(),
                    "2021-09-13T12:26:40.000000123Z"),
    "parse_zero": (lambda g: g.Timestamp.parse("0001-01-01T00:00:00Z").ns, None),
    "parse_offset": (lambda g: g.Timestamp.parse("2021-09-13T14:26:40+02:00").rfc3339nano(),
                     "2021-09-13T12:26:40Z"),
}


@pytest.mark.parametrize("name", sorted(GOJSON_VECTORS))
def test_gojson_vectors_match(name):
    fn, want = GOJSON_VECTORS[name]
    got_jax, got_port = fn(jgojson), fn(tgojson)
    assert got_port == got_jax
    if want is not None:
        assert got_port == want


# ---------------------------------------------------------------- models


def _event_pair(txs, parents, index, ts, seed=1000):
    """The same event built and signed (deterministically) in each package."""
    out = []
    for fb, Event, g in ((jfb, JEvent, jgojson), (tfb, TEvent, tgojson)):
        key = fb.key_from_seed(seed)
        ev = Event.new(txs, parents, fb.pub_key_bytes(key), index,
                       timestamp=g.Timestamp(ts))
        r, s = fb.sign(key, ev.body.hash())
        ev.r, ev.s = g.BigInt(r), g.BigInt(s)
        ev.invalidate(body=False)
        out.append(ev)
    return out


@pytest.mark.parametrize("txs", [None, [], [b"a", b"<&>"]], ids=["nil", "empty", "txs"])
def test_event_and_wire_identity(txs):
    j, t = _event_pair(txs, ["0xAB", ""], 3, 1_700_000_000_123_456_789)
    assert t.marshal() == j.marshal()
    assert t.hash() == j.hash()
    assert t.hex() == j.hex()
    assert t.body.hash() == j.body.hash()
    assert t.verify() and j.verify()
    for ev in (j, t):
        ev.set_wire_info(2, 1, 7, 0)
    assert tgojson.marshal(t.to_wire()) == jgojson.marshal(j.to_wire())
    assert t.to_wire().to_dict() == j.to_wire().to_dict()


@pytest.mark.parametrize("txs", [None, [], [b"x", b"y"]], ids=["nil", "empty", "txs"])
def test_block_identity(txs):
    jb, tb = JBlock(5, txs), TBlock(5, txs)
    assert tb.marshal() == jb.marshal()
    assert tb.hex() == jb.hex()
    assert tb.to_json_obj() == jb.to_json_obj()
    want = {None: b'"Transactions":null', (): b'"Transactions":[]'}.get(
        tuple(txs) if txs is not None else None)
    if want is not None:
        assert want in tb.marshal()


def test_root_roundinfo_frame_fields():
    kw = dict(x="0xAA", y="0xBB", index=4, round=2, others={"0xCC": "0xDD"})
    assert TRoot(**kw).to_dict() == JRoot(**kw).to_dict()
    jri, tri = JRoundInfo(), TRoundInfo()
    for ri in (jri, tri):
        ri.add_event("0x0F", True)
        ri.add_event("0xF0", True)
        ri.add_event("0x11", False)
        ri.set_fame("0x0F", True)
        ri.set_fame("0xF0", False)
    assert tri.witnesses() == jri.witnesses()
    assert tri.famous_witnesses() == jri.famous_witnesses()
    assert tri.pseudo_random_number() == jri.pseudo_random_number()
    assert tri.witnesses_decided() == jri.witnesses_decided()
    assert {x: (e.witness, int(e.famous)) for x, e in tri.events.items()} == \
        {x: (e.witness, int(e.famous)) for x, e in jri.events.items()}
    j, t = _event_pair([b"f"], ["", ""], 0, 1_700_000_000_000_000_001)
    jf = JFrame(roots={"0xAA": JRoot(**kw)}, events=[j])
    tf = TFrame(roots={"0xAA": TRoot(**kw)}, events=[t])
    assert [e.hex() for e in tf.events] == [e.hex() for e in jf.events]
    assert {k: r.to_dict() for k, r in tf.roots.items()} == \
        {k: r.to_dict() for k, r in jf.roots.items()}


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_events_carry_across(name):
    b = fixture_builder(name)
    for ev in b.ordered_events:
        t = carry_event(ev)
        assert t.hex() == ev.hex()
        assert t.marshal() == ev.marshal()
        assert (int(t.r), int(t.s)) == (int(ev.r), int(ev.s))
        assert t.verify()
        assert t.transactions() == ev.transactions()
        assert t.body.timestamp.ns == ev.body.timestamp.ns


# ---------------------------------------------------------------- crypto


def test_deterministic_signers_agree():
    for seed in (1, 3000, 3063, 2**40 + 5):
        key = tfb.key_from_seed(seed)
        assert tfb.pub_key_bytes(key) == jfb.pub_key_bytes(jfb.key_from_seed(seed))
        digest = tcrypto.sha256(b"slice-4 %d" % seed)
        sig = tfb.sign(key, digest)
        assert sig == jfb.sign(jfb.key_from_seed(seed), digest)
        if tossl.available():
            assert tossl.sign(key.d, digest) == sig


def test_signatures_verify_across_packages():
    digest = jcrypto.sha256(b"cross")
    jkey, tkey = jcrypto.key_from_seed(77), tcrypto.key_from_seed(77)
    pub = jcrypto.pub_key_bytes(jkey)
    assert tcrypto.pub_key_bytes(tkey) == pub
    r, s = jcrypto.sign(jkey, digest)
    assert tcrypto.verify(tcrypto.pub_key_from_bytes(pub), digest, r, s)
    r, s = tcrypto.sign(tkey, digest)
    assert jcrypto.verify(jcrypto.pub_key_from_bytes(pub), digest, r, s)
    assert not tcrypto.verify(tcrypto.pub_key_from_bytes(pub),
                              jcrypto.sha256(b"other"), r, s)
    assert tcrypto.BACKEND == jcrypto.BACKEND


# ---------------------------------------------------------------- store


def test_inmem_store_crud_and_errors():
    keys = [tcrypto.key_from_seed(7000 + i) for i in range(3)]
    pubs = ["0x" + tcrypto.pub_key_bytes(k).hex().upper() for k in keys]
    participants = {pubs[i]: rank for rank, i in
                    enumerate(sorted(range(3), key=lambda i: pubs[i]))}
    store = TInmemStore(participants, 100)

    with pytest.raises(tcommon.StoreError) as ei:
        store.get_event("0xDEADBEEF")
    assert tcommon.is_store_err(ei.value, tcommon.StoreErrType.KEY_NOT_FOUND)

    ev = TEvent.new([b"tx"], ["", ""], bytes.fromhex(pubs[0][2:]), 0,
                    timestamp=tgojson.Timestamp(10**18))
    ev.sign(keys[0])
    store.set_event(ev)
    assert store.get_event(ev.hex()) is ev
    assert store.participant_event(pubs[0], 0) == ev.hex()
    last, is_root = store.last_from(pubs[0])
    assert last == ev.hex() and not is_root

    with pytest.raises(tcommon.StoreError) as ei:
        store.last_from("0xFF")
    assert tcommon.is_store_err(ei.value, tcommon.StoreErrType.KEY_NOT_FOUND)

    known = store.known()
    assert known[participants[pubs[0]]] == 0
    assert known[participants[pubs[1]]] == -1

    blk = TBlock(1, None)
    store.set_block(blk)
    assert store.get_block(1).marshal() == JBlock(1, None).marshal()
    ri = TRoundInfo()
    ri.add_event(ev.hex(), True)
    store.set_round(0, ri)
    assert store.round_witnesses(0) == [ev.hex()]
    assert store.last_round() == 0


def test_event_json_roundtrip_in_port():
    key = tcrypto.key_from_seed(7000)
    ev = TEvent.new([b"tx"], ["", ""], tcrypto.pub_key_bytes(key), 0,
                    timestamp=tgojson.Timestamp(1_600_000_000_123_456_789))
    ev.sign(key)
    data = ev.marshal()
    ev2 = event_from_json_obj(json.loads(data))
    assert ev2.marshal() == data and ev2.hex() == ev.hex() and ev2.verify()
    jev = JEvent(JEventBody(transactions=[b"tx"], parents=["", ""],
                            creator=tcrypto.pub_key_bytes(key),
                            timestamp=jgojson.Timestamp(1_600_000_000_123_456_789),
                            index=0), r=int(ev.r), s=int(ev.s))
    assert jev.hex() == ev.hex()


def test_inmem_store_capacity_stats_match():
    """The capacity sizing (InmemStore.capacity_stats, through the
    port's copy of telemetry/capacity.py) gives the reference's rows and
    byte estimates on the same events."""
    from babble_tpu.hashgraph import InmemStore as JInmemStore
    from babble_tpu.hashgraph.event import event_from_json_obj as jax_event_from_json_obj

    b = fixture_builder("consensus")
    participants = b.participants()
    jstore, tstore = JInmemStore(participants, 100), TInmemStore(participants, 100)
    for ev in b.ordered_events:  # fresh copies on both sides: no coordinates yet
        jstore.set_event(jax_event_from_json_obj(json.loads(ev.marshal())))
        tstore.set_event(carry_event(ev))
    jstore.set_block(JBlock(1, [b"x"]))
    tstore.set_block(TBlock(1, [b"x"]))
    assert tstore.capacity_stats() == jstore.capacity_stats()
