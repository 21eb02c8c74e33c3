"""The port's sqlite FileStore (babble_tpu_torch/hashgraph/file_store.py)
against the reference's. Tolerance: exact equality.

- tests/test_store.py's FileStore cases, run on the port's modules (one
  parametrised test);
- on-disk parity both ways: a database that one package's FileStore
  wrote from a seeded event script (chip_smoke.signed_gossip, RFC 6979
  signatures) through its host Hashgraph loads in the other package's
  FileStore with equal participants, events (bytes and topological
  index), per-creator indexes, rounds, roots and blocks;
- bootstrap parity: one database from the same script, copied twice;
  the port's Core on the torch engine (CPU) and the reference's host
  Core bootstrap from the copies to equal consensus events, last
  consensus round, block bytes and head/seq;
- tests/test_bootstrap.py::test_bootstrap_all_nodes_tpu_engine with
  engine="torch": 3 FileStore nodes, one restart, prefix-equal history
  (a live net under its own deadline)."""

from __future__ import annotations

import json
import shutil

import pytest

from babble_tpu import crypto as ref_crypto
from babble_tpu.common import StoreError as RefStoreError
from babble_tpu.hashgraph import FileStore as RefFileStore
from babble_tpu.hashgraph import Hashgraph as RefHashgraph
from babble_tpu.hashgraph.event import event_from_json_obj as ref_event_from_json_obj
from babble_tpu.node.core import Core as RefCore
from babble_tpu_torch import crypto
from babble_tpu_torch.common import StoreError, StoreErrType, is_store_err
from babble_tpu_torch.gojson import Timestamp
from babble_tpu_torch.hashgraph import Event, FileStore, Hashgraph, TorchHashgraph
from babble_tpu_torch.hashgraph.block import Block
from babble_tpu_torch.hashgraph.event import event_from_json_obj
from babble_tpu_torch.hashgraph.round_info import RoundInfo
from babble_tpu_torch.node.core import Core
from chip_smoke import HASHGRAPH_KEY_SEED, signed_gossip
from test_torch_node import SMALL_ENGINE, check_gossip, make_nodes, run_gossip, stop

SCRIPT = (4, 240, 11)  # n, events, seed of the event script
CACHE = 10000


def make_participants(n, seed=7000):
    keys = [crypto.key_from_seed(seed + i) for i in range(n)]
    pubs = ["0x" + crypto.pub_key_bytes(k).hex().upper() for k in keys]
    order = sorted(range(n), key=lambda i: pubs[i])
    return keys, pubs, {pubs[i]: rank for rank, i in enumerate(order)}


def signed_event(key, pub_hex, parents, index, ts):
    ev = Event.new([b"tx"], parents, bytes.fromhex(pub_hex[2:]), index,
                   timestamp=Timestamp(ts))
    ev.sign(key)
    return ev


def evicted_file_store(path, cache=4, per_creator=12):
    """tests/test_store.py::_evicted_file_store: two creators,
    `per_creator` events each, LRU size `cache`."""
    keys, pubs, participants = make_participants(2)
    fs = FileStore(participants, cache, str(path / "evict.db"))
    heads = {p: "" for p in pubs}
    evs = {p: [] for p in pubs}
    ts = 1_700_000_000_000_000_000
    for idx in range(per_creator):
        for k, p in zip(keys, pubs):
            ev = signed_event(k, p, [heads[p], ""], idx, ts)
            ts += 1000
            ev.topological_index = idx
            fs.set_event(ev)
            heads[p] = ev.hex()
            evs[p].append(ev)
    return fs, pubs, evs


def chain(keys, pubs, store, n, start_ts=10**18):
    evs, prev = [], ""
    for i in range(n):
        ev = signed_event(keys[0], pubs[0], [prev, ""], i, start_ts + i)
        store.set_event(ev)
        evs.append(ev)
        prev = ev.hex()
    return evs


def raises_kind(kind, fn, *args):
    with pytest.raises(StoreError) as ei:
        fn(*args)
    assert is_store_err(ei.value, kind)


# -- tests/test_store.py's FileStore cases ---------------------------


def case_write_through_and_reload(tmp):
    keys, pubs, participants = make_participants(2)
    path = str(tmp / "store.db")
    store = FileStore(participants, 100, path)
    ev0 = signed_event(keys[0], pubs[0], ["", ""], 0, 10**18)
    ev1 = signed_event(keys[1], pubs[1], ["", ""], 0, 10**18 + 1)
    ev0.topological_index, ev1.topological_index = 0, 1
    store.set_event(ev0)
    store.set_event(ev1)
    store.close()
    store2 = FileStore.load(100, path)
    assert store2.participants() == participants
    got = store2.get_event(ev0.hex())
    assert got.hex() == ev0.hex() and got.verify()
    assert [e.hex() for e in store2.db_topological_events()] == [ev0.hex(), ev1.hex()]
    assert store2.participant_event(pubs[0], 0) == ev0.hex()
    store2.close()


def case_bootstrap_consensus(tmp):
    """The fixture DAG through a FileStore-backed host Hashgraph of the
    port, reloaded and bootstrapped to the same consensus."""
    from fixtures import build_consensus_graph

    _, b = build_consensus_graph()
    participants = b.participants()
    path = str(tmp / "hg.db")
    fs = FileStore(participants, 1000, path)
    h = Hashgraph(participants, fs)
    for ev in b.ordered_events:
        h.insert_event(event_from_json_obj(json.loads(ev.marshal())), True)
    h.run_consensus()
    order, last = h.consensus_events(), h.last_consensus_round
    assert order
    fs.close()
    fs2 = FileStore.load(1000, path)
    h2 = Hashgraph(participants, fs2)
    h2.bootstrap()
    assert h2.consensus_events() == order and h2.last_consensus_round == last
    fs2.close()


def case_get_event_falls_back_to_db(tmp):
    fs, pubs, evs = evicted_file_store(tmp)
    early = evs[pubs[0]][0]
    raises_kind(StoreErrType.KEY_NOT_FOUND, fs.inmem.get_event, early.hex())
    got = fs.get_event(early.hex())
    assert got.marshal() == early.marshal()
    assert got.topological_index == early.topological_index
    raises_kind(StoreErrType.KEY_NOT_FOUND, fs.get_event, "0xDEAD")
    fs.close()


def case_has_event_falls_back_to_db(tmp):
    fs, pubs, evs = evicted_file_store(tmp)
    early = evs[pubs[0]][0]
    assert not fs.inmem.has_event(early.hex())
    assert fs.has_event(early.hex()) and not fs.has_event("0xDEAD")
    fs.close()


def case_participant_events_fall_back_to_db(tmp):
    fs, pubs, evs = evicted_file_store(tmp)
    p = pubs[0]
    raises_kind(StoreErrType.TOO_LATE, fs.inmem.participant_events, p, -1)
    assert fs.participant_events(p, -1) == [e.hex() for e in evs[p]]
    assert fs.participant_events(p, 5) == [e.hex() for e in evs[p][6:]]
    fs.close()


def case_participant_event_falls_back_to_db(tmp):
    fs, pubs, evs = evicted_file_store(tmp)
    p = pubs[0]
    with pytest.raises(StoreError):
        fs.inmem.participant_event(p, 0)
    assert fs.participant_event(p, 0) == evs[p][0].hex()
    raises_kind(StoreErrType.KEY_NOT_FOUND, fs.participant_event, p, 999)
    fs.close()


def case_rounds_fall_back_to_db(tmp):
    _, _, participants = make_participants(2)
    fs = FileStore(participants, 4, str(tmp / "r.db"))
    for r in range(10):
        ri = RoundInfo()
        ri.add_event(f"0xE{r:02d}", r % 2 == 0)
        fs.set_round(r, ri)
    with pytest.raises(StoreError):
        fs.inmem.get_round(0)
    got = fs.get_round(0)
    assert "0xE00" in got.events and got.events["0xE00"].witness
    assert fs.round_witnesses(0) == ["0xE00"] and fs.round_events(0) == 1
    assert fs.last_round() == 9
    raises_kind(StoreErrType.KEY_NOT_FOUND, fs.get_round, 77)
    fs.close()


def case_roots_and_errors(tmp):
    _, pubs, participants = make_participants(2)
    fs = FileStore(participants, 4, str(tmp / "roots.db"))
    root = fs.get_root(pubs[0])
    assert root.index == -1 and root.round == -1
    raises_kind(StoreErrType.NO_ROOT, fs.get_root, "0xNOBODY")
    fs.close()


def case_blocks_fall_back_to_db(tmp):
    _, _, participants = make_participants(2)
    fs = FileStore(participants, 4, str(tmp / "b.db"))
    for rr in range(10):
        fs.set_block(Block(rr, [f"tx{rr}".encode()]))
    with pytest.raises(StoreError):
        fs.inmem.get_block(0)
    got = fs.get_block(0)
    assert got.round_received == 0 and got.transactions == [b"tx0"]
    raises_kind(StoreErrType.KEY_NOT_FOUND, fs.get_block, 99)
    fs.close()


def case_reload_serves_evicted_history(tmp):
    fs, pubs, evs = evicted_file_store(tmp)
    fs.close()
    fs2 = FileStore.load(4, str(tmp / "evict.db"))
    early = evs[pubs[0]][0]
    assert fs2.get_event(early.hex()).marshal() == early.marshal()
    assert fs2.participant_events(pubs[0], -1) == [e.hex() for e in evs[pubs[0]]]
    fs2.close()


def case_passed_index_falls_back_to_db(tmp):
    keys, pubs, participants = make_participants(1)
    fs = FileStore(participants, 5, str(tmp / "pi.db"))
    evs = chain(keys, pubs, fs, 12)
    fs.set_event(evs[0])  # a re-store of old history the db vouches for
    forged = signed_event(keys[0], pubs[0], ["", ""], 0, 10**18 + 999)
    raises_kind(StoreErrType.PASSED_INDEX, fs.set_event, forged)
    fs.close()


CASES = [case_write_through_and_reload, case_bootstrap_consensus,
         case_get_event_falls_back_to_db, case_has_event_falls_back_to_db,
         case_participant_events_fall_back_to_db, case_participant_event_falls_back_to_db,
         case_rounds_fall_back_to_db, case_roots_and_errors, case_blocks_fall_back_to_db,
         case_reload_serves_evicted_history, case_passed_index_falls_back_to_db]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[len("case_"):])
def test_file_store(case, tmp_path):
    case(tmp_path)


# -- cross-package parity ---------------------------------------------

PACKAGES = {
    "ref": (RefFileStore, RefHashgraph, ref_event_from_json_obj),
    "port": (FileStore, Hashgraph, event_from_json_obj),
}


@pytest.fixture(scope="module")
def script():
    events, participants, _ = signed_gossip(*SCRIPT)
    return [json.loads(ev.marshal()) for ev in events], participants


def write_db(pkg, path, script):
    """The script's events through `pkg`'s host Hashgraph over its
    FileStore, consensus run after every 40 inserts."""
    store_cls, graph_cls, from_json = PACKAGES[pkg]
    objs, participants = script
    fs = store_cls(participants, CACHE, path)
    hg = graph_cls(participants, fs)
    for i, obj in enumerate(objs):
        ev = from_json(obj)
        ev._sig_ok = True  # RFC 6979 signatures by the creators' keys
        hg.insert_event(ev, True)
        if i % 40 == 39:
            hg.run_consensus()
    hg.run_consensus()
    assert hg.last_consensus_round is not None and hg.last_consensus_round >= 5
    fs.close()


def block_bytes(store, last):
    """The Go-JSON bytes of every block a store holds up to round `last`."""
    out = {}
    for rr in range(last + 1):
        try:
            out[rr] = store.get_block(rr).marshal()
        except (StoreError, RefStoreError):
            continue
    return out


def dump_db(pkg, path):
    """Everything a FileStore serves from a database, as bytes and ints."""
    fs = PACKAGES[pkg][0].load(CACHE, path)
    try:
        parts = fs.participants()
        last_round = fs.last_round()
        out = {
            "participants": parts,
            "events": [(e.marshal(), e.topological_index) for e in fs.db_topological_events()],
            "by_creator": {p: fs.participant_events(p, -1) for p in parts},
            "known": fs.known(),
            "last_round": last_round,
            "rounds": [sorted((h, ev.witness, ev.famous.value)
                              for h, ev in fs.get_round(r).events.items())
                       for r in range(last_round + 1)],
            "roots": {p: fs.get_root(p).to_dict() for p in parts},
            "blocks": block_bytes(fs, last_round),
        }
        assert out["blocks"]
        return out
    finally:
        fs.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_file_store_on_disk_parity(writer, reader, script, tmp_path):
    path = str(tmp_path / "script.db")
    write_db(writer, path, script)
    assert dump_db(reader, path) == dump_db(writer, path)


def test_file_store_written_equal_by_both(script, tmp_path):
    """The same script written by each package gives equal contents."""
    for pkg in PACKAGES:
        write_db(pkg, str(tmp_path / f"{pkg}.db"), script)
    assert dump_db("port", str(tmp_path / "port.db")) == dump_db("ref", str(tmp_path / "ref.db"))


def test_bootstrap_parity_torch_core_vs_reference_host_core(script, tmp_path):
    """One database (the script through the reference's host graph),
    copied twice; the port's torch Core and the reference's host Core
    of the script's creator 0 bootstrap from the copies."""
    src = str(tmp_path / "run.db")
    write_db("ref", src, script)
    for name in ("port.db", "ref.db"):
        shutil.copyfile(src, str(tmp_path / name))
    _, participants = script
    seed = HASHGRAPH_KEY_SEED  # creator 0 of signed_gossip
    key, ref_key = crypto.key_from_seed(seed), ref_crypto.key_from_seed(seed)
    assert "0x" + crypto.pub_key_bytes(key).hex().upper() in participants

    port = Core(0, key, participants, FileStore.load(CACHE, str(tmp_path / "port.db")),
                engine="torch", engine_opts=SMALL_ENGINE | {"capacity": 512})
    ref = RefCore(0, ref_key, participants, RefFileStore.load(CACHE, str(tmp_path / "ref.db")),
                  engine="host")
    try:
        assert isinstance(port.hg, TorchHashgraph)
        port.bootstrap()
        ref.bootstrap()
        assert port.get_consensus_events() == ref.get_consensus_events()
        assert port.get_consensus_events()
        last = ref.get_last_consensus_round_index()
        assert port.get_last_consensus_round_index() == last
        assert block_bytes(port.hg.store, last) == block_bytes(ref.hg.store, last)
        assert (port.head, port.seq) == (ref.head, ref.seq)
    finally:
        port.hg.close()
        port.hg.store.close()
        ref.hg.store.close()


# -- tests/test_bootstrap.py on the torch engine ----------------------


def make_file_nodes(n, tmp_path, fresh):
    """tests/test_bootstrap.make_file_nodes on the port: n torch nodes
    (CPU) on FileStores, new or reloaded."""

    def store(i, participants):
        path = str(tmp_path / f"node{i}.db")
        return (FileStore(participants, CACHE, path) if fresh
                else FileStore.load(CACHE, path))

    return make_nodes(["torch"] * n, store=store, bootstrap=not fresh)


def test_bootstrap_all_nodes_torch_engine(tmp_path):
    nodes = make_file_nodes(3, tmp_path, fresh=True)
    for node in nodes:
        assert isinstance(node.core.hg, TorchHashgraph)
    run_gossip(nodes, target_round=3)
    check_gossip(nodes)
    first_events = {n.id: n.core.get_consensus_events() for n in nodes}
    first_rounds = {n.id: n.core.get_last_consensus_round_index() for n in nodes}

    # The replay may decide more than the snapshot before the stop (a
    # tip inserted after the last pass), so compare as a prefix.
    nodes = make_file_nodes(3, tmp_path, fresh=False)
    try:
        for node in nodes:
            assert isinstance(node.core.hg, TorchHashgraph)
            assert node.core.get_last_consensus_round_index() >= first_rounds[node.id]
            prior = first_events[node.id]
            assert node.core.get_consensus_events()[:len(prior)] == prior
            assert node.core.head != "" and node.core.seq >= 0
    except BaseException:
        stop(nodes)
        raise
    run_gossip(nodes, target_round=max(first_rounds.values()) + 2)
    check_gossip(nodes)
    for node in nodes:
        prior = first_events[node.id]
        assert node.core.get_consensus_events()[:len(prior)] == prior
        assert node.core.engine_state == "device" and node.core.engine_failovers == 0
