"""The generator's events and frames are the bytes the system itself
makes of the same events: the port's Event marshal, hash, RFC 6979
signature (its own signer) and columnar wire frame."""

import numpy as np
import pytest

import signer
import stream


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
