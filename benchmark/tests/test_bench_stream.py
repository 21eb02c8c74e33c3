"""The generator's events and frames are the bytes the system itself
makes of the same events: the port's Event marshal, hash, RFC 6979
signature (its own signer) and columnar wire frame. Without silent
validators every stream is byte for byte what it was before a
configuration could declare them; with them, they create nothing."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

import reference
import signer
import stream

CONFIGS = Path(stream.__file__).resolve().parent / "configs"

# The first 32 hex digits of SHA-256 of frame(0, e) and of the r||s
# signatures, from the generator as it was before `silent_validators`:
# (config, seed, events, rate, topology_seed) -> (frame, signatures).
PINNED = [
    (("peers1024", 2**33 + 17, 3000, None, 2),
     ("4f31675b070b6f5dcb4b83c454ca8f10", "7595a8e97e3658cb9a2fb791322d6749")),
    (("peers1024", 5, 3000, None, 2),
     ("35057913d87c1f4c1553f39ca2b50040", "223ab2ea6ec33fff339580a0770e657d")),
    (("peers64", 2**33 + 17, 3000, None, 2),
     ("2774e99fc8454e51ab8fc5493300bbd4", "63042242e46b101053fc1798e128839a")),
    (("peers64", 5, 3000, 2400.0, 1),
     ("30fc01ecc4914686ccf087ba4088ad98", "19676dc3f984e8d2f90d483cf3d8f90d")),
]


@pytest.fixture(scope="module")
def st():
    return stream.generate({"n": 8, "txs_per_event": 5}, 400, seed=2**40 + 3)


def port_events(st):
    from babble_tpu_torch.gojson import BigInt, Timestamp
    from babble_tpu_torch.hashgraph.event import Event

    out = []
    for i in range(st.e):
        sp, op = int(st.self_parent[i]), int(st.other_parent[i])
        ev = Event.new(st.txs[i], [st.hexes[sp] if sp >= 0 else "",
                                   st.hexes[op] if op >= 0 else ""],
                       st.pubs[st.creator[i]], int(st.index[i]),
                       timestamp=Timestamp(int(st.ts_ns[i])))
        ev.r, ev.s = BigInt(st.r[i]), BigInt(st.s[i])
        ev.invalidate(body=False)
        ev.set_wire_info(int(st.index[i]) - 1 if sp >= 0 else -1,
                         int(st.creator[op]) if op >= 0 else -1,
                         int(st.index[op]) if op >= 0 else -1, int(st.creator[i]))
        out.append(ev)
    return out


def test_bodies_hashes_and_signatures_match_the_port(st):
    from babble_tpu_torch.crypto import _fallback

    evs = port_events(st)
    for i, ev in enumerate(evs):
        assert ev.body.marshal() == (stream.body_string(st, i) + "\n").encode()
        assert ev.hex() == st.hexes[i]
        assert ev.verify()
    # the port's own RFC 6979 signer gives the same bits
    d = stream.key_scalar(2**40 + 3, 1)
    digest = evs[5].body.hash()
    assert signer.Signer().sign(d, digest) == _fallback.sign(_fallback.key_from_seed(d - 1), digest)


def test_frames_match_the_port_encoding(st):
    from babble_tpu_torch.net.columnar import ColumnarEvents

    evs = port_events(st)
    assert st.frame(0, st.e) == ColumnarEvents.from_events(evs).encode()
    assert st.frame(100, 250) == ColumnarEvents.from_events(evs[100:250]).encode()
    ids = [3, 9, 10, 200, 399]
    assert st.frame_ids(ids) == ColumnarEvents.from_events([evs[i] for i in ids]).encode()


def test_silent_node_and_fixed_topology():
    a = stream.generate({"n": 8}, 300, seed=5, topology_seed=1)
    b = stream.generate({"n": 8}, 300, seed=6, topology_seed=1)
    assert a.silent not in set(a.creator.tolist())
    # the same graph, its participants relabelled by their keys
    deg_a = sorted(np.bincount(a.creator, minlength=8).tolist())
    deg_b = sorted(np.bincount(b.creator, minlength=8).tolist())
    assert deg_a == deg_b
    assert np.array_equal(a.self_parent, b.self_parent)
    assert np.array_equal(a.other_parent, b.other_parent)
    assert a.hexes != b.hexes


def test_poisson_gaps_are_one_set_in_seed_order():
    a = stream.generate({"n": 8}, 500, seed=5, rate=1000.0, topology_seed=1)
    b = stream.generate({"n": 8}, 500, seed=7, rate=1000.0, topology_seed=1)
    ga, gb = np.diff(a.due_s, prepend=0.0), np.diff(b.due_s, prepend=0.0)
    assert np.allclose(np.sort(ga), np.sort(gb))
    assert not np.allclose(ga, gb)
    assert abs(a.due_s[-1] - 0.5) < 0.1


@pytest.mark.parametrize("args,want", PINNED)
@pytest.mark.parametrize("silent", [None, 0])
def test_streams_without_silent_validators_are_unchanged(args, want, silent):
    name, seed, events, rate, topology = args
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    if silent is not None:
        cfg["silent_validators"] = silent
    st = stream.generate(cfg, events, seed, rate=rate, topology_seed=topology)
    got = (hashlib.sha256(st.frame(0, st.e)).hexdigest()[:32],
           hashlib.sha256(st.sigs).hexdigest()[:32])
    assert got == want


def test_silent_validators_create_nothing_and_are_never_parents():
    seed = 2**34 + 1
    st = stream.generate({"n": 16, "silent_validators": 4}, 800, seed, topology_seed=2)
    sg = signer.Signer()
    # the silent validators are the last four key indices
    quiet = {st.participants["0x" + sg.pub_bytes(stream.key_scalar(seed, i)).hex().upper()]
             for i in range(12, 16)}
    creators = set(st.creator.tolist())
    parents = set(st.creator[st.other_parent[st.other_parent >= 0]].tolist())
    assert len(quiet) == 4 and st.silent not in quiet
    assert not quiet & creators and not quiet & parents
    assert creators == parents == set(range(16)) - quiet - {st.silent}
    assert len(creators) == reference.supermajority(st.n) == 11
    assert np.bincount(st.creator, minlength=16)[sorted(creators)].min() > 1
    stream.generate({"n": 16, "silent_validators": 13}, 100, seed)  # two creators
    for f in (14, -1):
        with pytest.raises(ValueError):
            stream.generate({"n": 16, "silent_validators": f}, 100, seed)
