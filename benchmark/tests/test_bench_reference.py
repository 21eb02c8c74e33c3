"""The plain reference against the system's own host consensus, and the
comparison against a node that is a silent participant of the stream."""

import json

import numpy as np
import pytest

import compare
import control
import reference
import stream


def port_graph(st):
    """The port's host Hashgraph (the Go reference's semantics) fed the
    stream's events in order."""
    from babble_tpu_torch.gojson import BigInt, Timestamp
    from babble_tpu_torch.hashgraph import Hashgraph, InmemStore
    from babble_tpu_torch.hashgraph.event import Event

    blocks = []
    h = Hashgraph(st.participants, InmemStore(st.participants, 100_000), blocks.append)
    for i in range(st.e):
        sp, op = int(st.self_parent[i]), int(st.other_parent[i])
        ev = Event.new(st.txs[i], [st.hexes[sp] if sp >= 0 else "",
                                   st.hexes[op] if op >= 0 else ""],
                       st.pubs[st.creator[i]], int(st.index[i]),
                       timestamp=Timestamp(int(st.ts_ns[i])))
        ev.r, ev.s = BigInt(st.r[i]), BigInt(st.s[i])
        ev.invalidate(body=False)
        h.insert_event(ev, True)
    h.run_consensus()
    return h, blocks


@pytest.mark.parametrize("n,e,seed", [(8, 700, 3), (13, 900, 2**33 + 1)])
def test_reference_equals_host_hashgraph_with_a_silent_creator(n, e, seed):
    st = stream.generate({"n": n, "txs_per_event": 3}, e, seed)
    h, blocks = port_graph(st)
    res = reference.consensus(st, "cpu")
    assert [st.hexes[i] for i in res.order] == h.consensus_events()
    assert len(res.order) > e // 2
    assert all(int(res.rounds[i]) == h.round(st.hexes[i]) for i in range(e))
    assert [b.marshal() for b in blocks] == res.blocks
    for x in h.consensus_events():
        assert h.store.get_event(x).consensus_timestamp.ns == res.cts_ns[st.hexes.index(x)]


def core_capture(st, p, limit):
    """A torch Core on the CPU, the silent node, fed the first p events
    in syncs of `limit`, passes after each; its outputs as a capture."""
    from babble_tpu_torch import crypto
    from babble_tpu_torch.hashgraph import InmemStore
    from babble_tpu_torch.net.columnar import ColumnarEvents
    from babble_tpu_torch.node.core import Core

    blocks = []
    core = Core(st.silent, crypto.key_from_seed(st.node_key - 1), st.participants,
                InmemStore(st.participants, 100_000), commit_callback=blocks.append,
                engine="torch", engine_opts={"capacity": 64, "block": 64,
                                             "k_capacity": 8, "device": "cpu"})
    core.init()
    for lo in range(0, p, limit):
        core.sync(ColumnarEvents.decode(st.frame(lo, min(lo + limit, p))))
        core.run_consensus()
    core.run_consensus()
    hg = core.hg
    cap = {"order": core.get_consensus_events(),
           "held": np.array([h in hg._eid_of for h in st.hexes]),
           "rounds": np.array([hg.round(h) for h in st.hexes]),
           "rr": np.array([hg.round_received(h) for h in st.hexes]),
           "cts": {h: hg.store.get_event(h).consensus_timestamp.ns
                   for h in core.get_consensus_events()},
           "blocks": [reference.block_bytes(b.round_received, b.transactions)
                      for b in blocks]}
    hg.close()
    return cap


def test_a_silent_node_passes_and_is_held_to_the_prefix_floor():
    st = stream.generate({"n": 8, "txs_per_event": 2}, 900, seed=77, topology_seed=4)
    index = {h: i for i, h in enumerate(st.hexes)}
    ref = reference.consensus(st, "cpu")
    for p in (300, 700):
        cap = core_capture(st, p, 100)
        floor = len(reference.consensus(stream.prefix(st, p), "cpu").order)
        assert len(cap["order"]) >= floor > 0
        assert compare.compare(cap, ref, st.hexes, index, p, floor) == compare.empty()
        # a node that ordered less than the stream alone decides fails
        short = dict(cap, order=cap["order"][:floor - 1])
        assert compare.compare(short, ref, st.hexes, index, p, floor)["ordered_shortfall"]


@pytest.mark.parametrize("name", ["peers1024.saturate", "peers64.gossip"])
def test_the_control_fails_the_comparison(name):
    """The reference at a simple majority in the node's place, at a size a
    test holds, reads far above every limit (0)."""
    bench = json.loads((control.HERE.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = json.loads((control.HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((control.HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    cfg["n"] = 10
    if "events" in traffic:
        traffic.update(events=800, tail_events=200)
    else:
        traffic.update(rate_events_per_s=100.0, warm_s=2, drain_s=2)
    out = control.readings(cfg, traffic, 2**35 + 1, "cpu", 5.0)
    assert sum(out[k] for k in compare.NUMBERS) > 100
    assert out["round_mismatch"] > 0 and out["order_mismatch"] > 0
