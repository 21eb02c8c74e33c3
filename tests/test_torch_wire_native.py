"""The native columnar reader (babble_tpu_torch/hashgraph/wire_native.py
over csrc/wire_batch.cpp) against the Python path it replaces: every
byte of every body and event encoding, both digests, the hex, R and S,
the wire ints and the sidecars equal what `materialize_wire_event` and
the Python loop of `_read_columnar_batch` give, and what the generic
Go-JSON encoder and hashlib give. Parents resolve the same way (an
earlier row of the batch, the latest with that creator and index; the
store's window; the probe behind it), an unknown parent raises the same
error after the same lookups, and a Core counts the rows either path
built."""

from __future__ import annotations

import ctypes
import hashlib
import random

import numpy as np
import pytest

from babble_tpu_torch import crypto
from babble_tpu_torch.common import StoreError, StoreErrType
from babble_tpu_torch.gojson import GoStruct, Timestamp
from babble_tpu_torch.hashgraph import InmemStore
from babble_tpu_torch.hashgraph import wire_native
from babble_tpu_torch.hashgraph.graph import Hashgraph
from babble_tpu_torch.net.columnar import ColumnarEvents
from babble_tpu_torch.node import Core
from babble_tpu_torch.telemetry.trace import SpanRing

N_PEERS = 4
CREATORS = [bytes([4]) + bytes([17 * i + 1]) * 64 for i in range(N_PEERS)]
PUBS = ["0x" + c.hex().upper() for c in CREATORS]
PARTICIPANTS = {pk: i for i, pk in enumerate(PUBS)}
NS = 1_000_000_000
T0 = 1_700_000_000 * NS + 123_456_789


def fake_hex(tag: str) -> str:
    return "0x" + hashlib.sha256(tag.encode()).hexdigest().upper()


class WindowStore:
    """The two lookups the batch resolver makes: each creator's rolling
    window (items, last index) and the probe behind it (a FileStore's
    sqlite). Logs every lookup."""

    def __init__(self, window_from=5, window_to=9, older_from=0):
        self.window = {pk: ([fake_hex(f"{pk}/{i}") for i in range(window_from, window_to + 1)],
                            window_to) for pk in PUBS}
        self.older = {(pk, i): fake_hex(f"{pk}/{i}")
                      for pk in PUBS for i in range(older_from, window_from)}
        self.calls = []

    def cache_size(self):
        return 100

    def participant_window(self, creator):
        self.calls.append(("window", creator))
        return self.window[creator]

    def participant_event(self, creator, index):
        self.calls.append(("probe", creator, index))
        h = self.older.get((creator, index))
        if h is None:
            raise StoreError(StoreErrType.KEY_NOT_FOUND, creator)
        return h


def columns(rows):
    """A ColumnarEvents batch from row dicts (cid, idx, sp, opc, opi, ts,
    txs, r, s, trace, create)."""
    n = len(rows)
    sigs = b"".join(r.get("r", 7).to_bytes(32, "big") + r.get("s", 9).to_bytes(32, "big")
                    for r in rows)
    counts, lens, blob = [], [], []
    for r in rows:
        txs = r.get("txs")
        counts.append(-1 if txs is None else len(txs))
        for t in txs or []:
            lens.append(len(t))
            blob.append(t)
    trace = [r.get("trace", 0) for r in rows]
    create = [r.get("create", 0) for r in rows]
    col = lambda key, dflt=0: np.asarray([r.get(key, dflt) for r in rows], np.int32)  # noqa: E731
    return ColumnarEvents(
        col("cid"), col("idx"), col("sp", -1), col("opc", -1), col("opi", -1),
        np.asarray([r.get("ts", T0) for r in rows], np.int64), sigs,
        np.asarray(counts, np.int32), np.asarray(lens, np.int32), b"".join(blob),
        np.asarray(trace, np.int64) if any(trace) else None,
        np.asarray(create, np.int64) if any(create) else None)


def chain(cid, first, count, op=None, **kw):
    """Rows first..first+count-1 of one creator, each the self-child of
    the one before; `op` = (creator, index) names an other-parent."""
    out = []
    for i in range(first, first + count):
        row = {"cid": cid, "idx": i, "sp": i - 1, "ts": T0 + i, "txs": [b"tx%d" % i]}
        if op is not None:
            row["opc"], row["opi"] = op
        row.update(kw)
        out.append(row)
    return out


def _random_rows(seed, n=300):
    rng = random.Random(seed)
    tips = {c: 9 for c in range(N_PEERS)}  # the window ends at 9
    rows = []
    for k in range(n):
        c = rng.randrange(N_PEERS)
        tips[c] += 1
        o = rng.randrange(N_PEERS)
        ntx = rng.choice([-1, 0, 1, 5])
        rows.append({
            "cid": c, "idx": tips[c], "sp": tips[c] - 1, "opc": o,
            # the probe, the window or the batch (not the row itself)
            "opi": rng.randint(2, tips[o] - (o == c)),
            "ts": rng.randrange(-2**63, 2**63),
            "txs": None if ntx < 0 else [rng.randbytes(rng.randrange(40)) for _ in range(ntx)],
            "r": rng.getrandbits(rng.choice([8, 200, 256])),
            "s": rng.getrandbits(256),
            "trace": rng.getrandbits(62) if k % 3 == 0 else 0,
            "create": rng.getrandbits(62) if k % 4 == 0 else 0,
        })
    return rows


def _heartbeats(n=300):
    """The longest rows a batch without transactions can hold: nil or
    empty transactions, both parents earlier rows of the batch (so each
    is written twice, into the body and into the event's copy of it),
    ten-digit indexes, 30-character timestamps and 78-digit R and S."""
    first = 2**31 - 1 - n
    tips = {c: first for c in range(N_PEERS)}
    rows = [{"cid": c, "idx": first, "txs": None} for c in range(N_PEERS)]
    for k in range(n - N_PEERS):
        c, o = k % N_PEERS, (k + 1) % N_PEERS
        tips[c] += 1
        rows.append({"cid": c, "idx": tips[c], "sp": tips[c] - 1, "opc": o, "opi": tips[o],
                     "txs": None if k % 2 else []})
    for k, row in enumerate(rows):
        row.update(ts=T0 + k * NS, r=2**256 - 1 - k, s=2**256 - 2 - k)
    return rows


CASES = {
    "transactions": [
        {"cid": 0, "idx": 10, "sp": 9, "txs": None},
        {"cid": 1, "idx": 10, "sp": 9, "txs": []},
        {"cid": 2, "idx": 10, "sp": 9, "txs": [b"a", b"bc", b"def", b"ghij", b"klmno"]},
        {"cid": 3, "idx": 10, "sp": 9,
         "txs": [b"", bytes(range(256)), b"\x00", b"\xff\xfe", b'"\\\n</>']},
    ],
    "index_zero": [
        {"cid": c, "idx": 0, "txs": None} for c in range(N_PEERS)
    ] + [{"cid": 0, "idx": 1, "sp": 0, "opc": 3, "opi": 0, "txs": []}],
    "parent_in_batch": chain(0, 10, 3) + chain(1, 10, 2, op=(0, 11))
    + chain(2, 10, 1, op=(1, 11)),
    "parent_in_window": chain(0, 10, 1, op=(1, 7)) + chain(3, 10, 1, op=(2, 9))
    + [{"cid": 1, "idx": 8, "sp": 7, "opc": 0, "opi": 5}],
    "parent_aged_out": chain(0, 10, 1, op=(1, 2)) + [
        {"cid": 2, "idx": 5, "sp": 4, "opc": 3, "opi": 0},
        {"cid": 3, "idx": 3, "sp": 2, "opc": 0, "opi": 4}],
    "latest_duplicate_wins": [
        {"cid": 0, "idx": 10, "sp": 9, "txs": [b"first"]},
        {"cid": 1, "idx": 10, "sp": 9, "opc": 0, "opi": 10},
        {"cid": 0, "idx": 10, "sp": 9, "txs": [b"second"]},
        {"cid": 2, "idx": 10, "sp": 9, "opc": 0, "opi": 10},
        {"cid": 0, "idx": 11, "sp": 10},
    ],
    "timestamps": [
        {"cid": k % N_PEERS, "idx": 10 + k // N_PEERS, "sp": 9 + k // N_PEERS, "ts": ts}
        for k, ts in enumerate([
            1_700_000_000 * NS, 1_700_000_000 * NS + 120_000_000, 1_700_000_000 * NS + 1,
            1_700_000_000 * NS + 100, 0, 1, -1, -NS, -NS - 1, 951_782_400 * NS,
            -2**63, 2**63 - 1])],
    "signatures": [
        {"cid": 0, "idx": 10, "sp": 9, "r": 1, "s": 1},
        {"cid": 1, "idx": 10, "sp": 9, "r": 2**255, "s": 2**255},
        {"cid": 2, "idx": 10, "sp": 9, "r": 0xFF, "s": 2**128 + 3},
        {"cid": 3, "idx": 10, "sp": 9, "r": 2**256 - 1, "s": 0},
        {"cid": 0, "idx": 11, "sp": 10, "r": 10**76, "s": 10**77 - 1},
    ],
    "random_300": _random_rows(2024),
    "heartbeats_in_batch": _heartbeats(),
}


def _graph(store):
    return Hashgraph(dict(PARTICIPANTS), store)


def _python_path(monkeypatch, cols, store):
    with monkeypatch.context() as m:
        m.setattr(wire_native, "library", lambda: None)
        g = _graph(store)
        out = g.read_wire_batch(cols)
        assert g.wire_reader.last is None
    return out


def _fields(ev):
    b = ev.body
    return (b.transactions, b.parents, b.creator, b.timestamp.ns, b.index,
            b.self_parent_index, b.other_parent_creator_id, b.other_parent_index,
            b.creator_id, int(ev.r), int(ev.s), ev.trace_id, ev.create_ns, ev.creator())


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_rows_equal_the_python_path(monkeypatch, case):
    rows = CASES[case]
    cols = columns(rows)
    g = _graph(WindowStore())
    native = g.read_wire_batch(cols)
    rows_built, t0, t1 = g.wire_reader.last
    assert rows_built == len(rows) and t1 >= t0
    python = _python_path(monkeypatch, cols, WindowStore())
    assert len(native) == len(python) == len(rows)
    for k, (ev, ref) in enumerate(zip(native, python)):
        # Every memo is seeded before any accessor runs.
        assert ev.body._marshal_str is not None and ev.body._marshal is not None
        assert ev.body._hash is not None and ev._hash and ev._hex and ev._marshal
        assert _fields(ev) == _fields(ref), k
        assert ev.body.marshal_value() == ref.body.marshal_value() \
            == GoStruct.marshal_value(ref.body), k
        assert ev.marshal_value() == ref.marshal_value() == GoStruct.marshal_value(ref), k
        assert ev.body.marshal() == ref.body.marshal()
        assert ev.marshal() == ref.marshal()
        assert ev.body.hash() == ref.body.hash() == hashlib.sha256(ref.body.marshal()).digest()
        assert ev.hash() == ref.hash() == hashlib.sha256(ref.marshal()).digest()
        assert ev.hex() == ref.hex() == "0x" + ev.hash().hex().upper()
        assert type(ev.body._marshal_str) is str and type(ev._marshal) is bytes
    if case == "latest_duplicate_wins":
        assert native[3].other_parent() == native[2].hex() != native[0].hex()
        assert native[1].other_parent() == native[0].hex()
        assert native[4].self_parent() == native[2].hex()
    if case == "parent_in_window":
        assert native[0].other_parent() == fake_hex(f"{PUBS[1]}/7")
    if case == "parent_aged_out":
        assert native[0].other_parent() == fake_hex(f"{PUBS[1]}/2")


@pytest.mark.parametrize("fault", ["unknown_self_parent", "unknown_other_parent",
                                   "unknown_creator"])
def test_a_bad_row_raises_the_same_error_after_the_same_lookups(monkeypatch, fault):
    rows = chain(0, 10, 3) + chain(1, 10, 3, op=(0, 11))
    if fault == "unknown_self_parent":
        rows[4]["sp"] = 1  # creator 1's index 1: before the probe's range
    elif fault == "unknown_other_parent":
        rows[4]["opc"], rows[4]["opi"] = 2, 40  # past the window's end
    else:
        rows[4]["cid"] = N_PEERS + 3
    cols = columns(rows)
    errors, logs = [], []
    for path in ("native", "python"):
        store = WindowStore(older_from=2)
        with monkeypatch.context() as m:
            if path == "python":
                m.setattr(wire_native, "library", lambda: None)
            with pytest.raises((StoreError, KeyError)) as exc:
                _graph(store).read_wire_batch(cols)
        errors.append(exc.value)
        logs.append(store.calls)
    a, b = errors
    assert type(a) is type(b) and str(a) == str(b) and a.args == b.args
    if isinstance(a, StoreError):
        assert (a.err_type, a.key) == (b.err_type, b.key)
    assert logs[0] == logs[1] and logs[0]


def test_a_buffer_too_small_is_a_fault(monkeypatch):
    """The output buffer is sized from an upper bound of every row, so
    running out of it is a fault to raise, never a fallback."""
    monkeypatch.setattr(wire_native, "_ROW_BYTES", 100)
    with pytest.raises(RuntimeError, match="overran"):
        _graph(WindowStore()).read_wire_batch(columns(CASES["heartbeats_in_batch"]))


def _lib():
    lib = wire_native.library()
    assert lib is not None, "the native wire library did not build"
    return lib


@pytest.mark.parametrize("portable", [0, 1])
def test_sha256_equals_hashlib(portable):
    lib = _lib()
    rng = random.Random(portable)
    out = ctypes.create_string_buffer(32)
    for n in range(201):
        data = rng.randbytes(n)
        lib.babble_sha256(data, n, out, portable)
        assert out.raw == hashlib.sha256(data).digest(), n


@pytest.mark.parametrize("sec,nanos", [
    (-62135596800, 0),                 # 0001-01-01T00:00:00Z, Go's zero time
    (-62135596800, 1),
    (253402300799, 999_999_999),       # 9999-12-31T23:59:59.999999999Z
    (0, 0), (0, 500_000_000), (-1, 999_999_999),
    (951782400, 10), (951868800, 120_000_000),  # 2000-02-29, 2000-03-01
    (4102444800, 100_000),             # 2100-01-01
])
def test_rfc3339nano_equals_go(sec, nanos):
    """Instants the int64 ns column cannot carry (year 1, year 9999)
    through the formatter the batch uses."""
    out = ctypes.create_string_buffer(30)
    n = _lib().babble_rfc3339nano(sec, nanos, out)
    assert out.raw[:n].decode() == Timestamp(sec * NS + nanos).rfc3339nano()


def _keys(n, seed=9300):
    keys = [crypto.key_from_seed(seed + i) for i in range(n)]
    pubs = ["0x" + crypto.pub_key_bytes(k).hex().upper() for k in keys]
    order = sorted(range(n), key=lambda i: pubs[i])
    return [keys[i] for i in order], {pubs[i]: k for k, i in enumerate(order)}


def test_core_counts_the_rows_each_path_built(monkeypatch):
    """One columnar batch synced into two Cores with the same key: the
    native one counts every row under from_wire_rows and
    from_wire_native, with a sync.from_wire.native span inside
    sync.from_wire; the one whose library is unavailable takes the
    Python path, counts no native row, and stores the same events."""
    keys, participants = _keys(3)
    peers = [Core(i, keys[i], participants, InmemStore(participants, 1000), engine="host")
             for i in range(3)]
    rings = [SpanRing(256), SpanRing(256)]
    mine = [Core(0, keys[0], participants, InmemStore(participants, 1000), engine="host",
                 trace=ring) for ring in rings]
    for c in peers + mine:
        c.init()
    for a, b in ((1, 2), (2, 1), (1, 2)):
        peers[a].sync(peers[b].to_wire_batch(peers[b].diff(peers[a].known()), "columnar"))
    batch = peers[1].to_wire_batch(peers[1].diff(mine[0].known()), "columnar")
    n = len(batch)
    assert n >= 5
    mine[0].sync(batch)
    with monkeypatch.context() as m:
        m.setattr(wire_native, "library", lambda: None)
        mine[1].sync(batch)
    native, python = (c.phase_ns for c in mine)
    assert native["from_wire_rows"][2] == python["from_wire_rows"][2] == n
    assert native["from_wire_native"][2] == n and "from_wire_native" not in python

    def stored(core):
        st = core.hg.store
        return {h: st.get_event(h).marshal() for pk in participants
                for h in st.participant_events(pk, -1)}

    # Each Core's own events carry its clock; every event of the batch
    # is stored byte for byte alike in both.
    theirs, a, b = stored(peers[1]), stored(mine[0]), stored(mine[1])
    assert len(theirs) >= n
    assert all(a[h] == b[h] == m for h, m in theirs.items())
    spans = [{s["name"]: s for s in ring.snapshot()} for ring in rings]
    kid, parent = spans[0]["sync.from_wire.native"], spans[0]["sync.from_wire"]
    assert kid["parent"] == parent["id"] and kid["args"] == {"rows": n}
    assert parent["t0"] <= kid["t0"] <= kid["t1"] <= parent["t1"]
    assert "sync.from_wire.native" not in spans[1] and "sync.from_wire" in spans[1]
