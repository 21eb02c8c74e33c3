"""The port's HTTP service (babble_tpu_torch/service/service.py) on a live
4-node net of the port's Nodes over TCP gossip, every node on the torch
engine (CPU), the Service on node 0: tests/test_service.py's
test_stats_endpoint with engine_state "device", and the service's
tools (promtext, dagdump, tracemerge) from the port. Tolerance: exact
equality.

- /Stats and /debug/peers have the key sets of the reference's service
  on a reference node (a 4-node host net over the reference's TCP
  transport, as tests/test_node.py::test_gossip[tcp] builds it); the
  per-phase time_* keys of /Stats name the phases each engine ran, so
  they are compared apart;
- /metrics parses with the port's promtext, /debug/hashgraph renders
  with its dagdump, /debug/trace passes its tracemerge --check;
- /debug/profile?seconds=0.2 leaves a torch.profiler Chrome trace;
- /debug/profile?cost=1 answers 200 with the torch engine's cost report
  (the JAX engine's key set), and the babble_engine_pass_flops/_bytes
  gauges appear in /metrics;
- the capacity sizer behind those scrapes survives a cache that another
  thread writes (ROADMAP C4).

The port's net is shared by the module (`nets`); the reference's runs
only for the key-set test. Each runs under a deadline of its own."""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict

import pytest

from babble_tpu_torch.hashgraph import TorchHashgraph
from babble_tpu_torch.telemetry.capacity import sampled_bytes
from babble_tpu_torch.service import Service
from babble_tpu_torch.telemetry import dagdump, promtext, tracemerge
from test_torch_node import DEADLINE_S, check_gossip, make_nodes, run_gossip, stop

TARGET_ROUND = 3


def get(addr, path, timeout=30):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=timeout) as r:
        return r.status, r.headers, r.read()


def get_json(addr, path, timeout=30):
    return json.loads(get(addr, path, timeout)[2])


def http_error(addr, path, data=None):
    req = urllib.request.Request(f"http://{addr}{path}", data=data,
                                 method="POST" if data is not None else "GET")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    return ei.value.code, ei.value.read()


def peers_keys(dbg):
    return sorted(dbg), sorted(set().union(*(set(p) for p in dbg["peers"].values())))


def stats_keys(stats):
    fixed = sorted(k for k in stats if not k.startswith("time_"))
    return fixed, sorted(k for k in stats if k.startswith("time_"))


@pytest.fixture(scope="module")
def nets():
    """The port's torch TCP net, left running with the Service on node 0."""
    nodes = make_nodes(["torch"] * 4, transport="tcp")
    service = Service("127.0.0.1:0", nodes[0])
    service.serve_async()
    try:
        run_gossip(nodes, target_round=TARGET_ROUND, shutdown=False)
        yield {"nodes": nodes, "addr": service.addr}
    finally:
        service.close()
        stop(nodes)


def reference_service_answers():
    """/Stats and /debug/peers of the reference's service on node 0 of a
    reference host net over TCP, run to the same round."""
    from babble_tpu.service import Service as RefService
    from test_node import make_nodes as ref_make_nodes
    from test_node import run_gossip as ref_run_gossip

    ref_nodes = ref_make_nodes(4, "tcp")
    ref_service = RefService("127.0.0.1:0", ref_nodes[0])
    ref_service.serve_async()
    try:
        ref_run_gossip(ref_nodes, target_round=TARGET_ROUND, timeout=DEADLINE_S,
                       shutdown=False)
        return {"stats": get_json(ref_service.addr, "/Stats"),
                "peers": get_json(ref_service.addr, "/debug/peers")}
    finally:
        ref_service.close()
        for node in ref_nodes:
            node.shutdown()


def test_stats_endpoint(nets):
    nodes, addr = nets["nodes"], nets["addr"]
    status, headers, body = get(addr, "/Stats")
    assert status == 200 and headers["Access-Control-Allow-Origin"] == "*"
    stats = json.loads(body)
    assert int(stats["last_consensus_round"]) >= TARGET_ROUND
    assert stats["id"].isdigit() and float(stats["events_per_second"]) > 0
    assert stats["engine_state"] == "device" and stats["engine_failovers"] == "0"
    assert stats["store_type"] == "inmem" and "last_committed_block" in stats
    assert stats["state"] == "Babbling"
    check_gossip(nodes)
    assert all(isinstance(n.core.hg, TorchHashgraph) for n in nodes)

    dbg = get_json(addr, "/debug/peers")
    assert dbg["engine_state"] == "device" and dbg["engine_failovers"] == 0
    assert len(dbg["peers"]) == 3  # 4-node net, self excluded
    for state in dbg["peers"].values():
        assert state["state"] in ("closed", "open", "half_open")
        assert {"failures", "successes", "trips", "retry_in"} <= set(state)

    ph = get_json(addr, "/debug/phases")
    for stage in ("sync", "from_wire", "verify", "insert"):
        assert ph["phases"][stage]["calls"] >= 1 and ph["phases"][stage]["total_ns"] >= 0
    eng = ph["engine"]
    assert isinstance(eng["inflight"], bool) and eng["redo_count"] >= 0
    assert eng["backlog"] >= 0 and eng["cost_report"] is None

    # POST /submit: intake without a socket client
    req = urllib.request.Request(f"http://{addr}/submit", data=b"service submitted tx",
                                 method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        assert r.status == 200
        assert json.loads(r.read())["submitted"] == len(b"service submitted tx")
    assert http_error(addr, "/submit", b"")[0] == 400
    assert http_error(addr, "/submit", b"x" * ((1 << 20) + 1))[0] == 413


def test_stats_and_peers_key_sets_match_the_reference(nets):
    ref, addr = reference_service_answers(), nets["addr"]
    stats = get_json(addr, "/Stats")
    fixed, timed = stats_keys(stats)
    assert fixed == stats_keys(ref["stats"])[0]
    # The host engine's phases, and the torch engine's own.
    for phase in ("sync", "from_wire", "verify", "insert", "consensus_dispatch",
                  "consensus_collect", "engine_frontier", "engine_fame_rr"):
        assert f"time_{phase}_ns" in timed, phase
    assert peers_keys(get_json(addr, "/debug/peers")) == peers_keys(ref["peers"])


def test_metrics_parse_with_promtext(nets):
    status, headers, body = get(nets["addr"], "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    samples, types = promtext.parse(body.decode())
    assert types["babble_engine_pass_seconds"] == "histogram"
    passes = promtext.histogram_snapshot(samples, "babble_engine_pass_seconds")
    assert passes.count >= 1
    assert "babble_commit_latency_seconds_bucket" in samples


def test_debug_hashgraph_renders_with_dagdump(nets):
    window = get_json(nets["addr"], "/debug/hashgraph?rounds=2")
    dot = dagdump.render_dot(window)
    assert dot.startswith("digraph") and "->" in dot


def test_debug_trace_passes_tracemerge_check(nets, tmp_path):
    out = str(tmp_path / "merged.json")
    url = f"http://{nets['addr']}/debug/trace"
    assert tracemerge.main(["--check", "-o", out, url]) == 0
    with open(out) as f:
        assert json.load(f)["traceEvents"]


def test_debug_profile_writes_a_torch_profiler_trace(nets):
    addr = nets["addr"]
    info = get_json(addr, "/debug/profile?seconds=0.2")
    assert info["seconds"] == 0.2
    trace = os.path.join(info["trace_dir"], "trace.json")
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    assert http_error(addr, "/debug/profile?seconds=nope")[0] == 400


def test_capacity_sizing_survives_a_concurrent_writer():
    """/Stats, /metrics and /debug/capacity size the store's LRU caches
    (OrderedDicts) on the service's thread while gossip and consensus
    write them. Sized live, a write between two entries raised
    "OrderedDict mutated during iteration" and the service dropped the
    request (ROADMAP §C, C4)."""
    cache = OrderedDict((i, i) for i in range(512))
    stop = threading.Event()

    def writer():
        i = len(cache)
        while not stop.is_set():
            cache[i] = i
            cache.popitem(last=False)
            i += 1

    def sizer(v):
        sum(range(50))  # Python work between entries, as event_bytes does
        return 8

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for _ in range(200):
            assert sampled_bytes(cache.values(), len(cache), sizer) == 8 * 512
    finally:
        stop.set()
        sys.setswitchinterval(old)
        t.join(timeout=10)
    assert not t.is_alive()


def test_cost_report_answers_for_the_torch_engine(nets):
    """?cost=1 arms the engine's one-shot capture and answers 200 once a
    pass has recorded it (202 while it is pending on an idle node: a
    transaction each poll gives the node a pass to record)."""
    addr = nets["addr"]
    deadline = time.monotonic() + DEADLINE_S
    k = 0
    while True:
        nets["nodes"][0].submit_tx(b"cost probe %d" % k)
        k += 1
        status, _, body = get(addr, "/debug/profile?cost=1&seconds=5")
        if status == 200 or time.monotonic() > deadline:
            break
        assert status == 202 and json.loads(body) == {"pending": True}
    assert status == 200
    report = json.loads(body)["cost"]
    assert set(report) == {"consensus_fused", "shapes"}
    assert set(report["consensus_fused"]) == {
        "flops", "bytes_accessed", "output_bytes", "temp_bytes"}
    assert set(report["shapes"]) == {"n", "sm", "rcap", "bp", "rw", "iw", "cb", "tw"}
    assert report["shapes"]["n"] == 4 and report["shapes"]["sm"] == 3
    assert all(v > 0 for v in report["consensus_fused"].values())
    metrics = get(addr, "/metrics")[2].decode()
    assert 'babble_engine_pass_flops{kernel="consensus_fused"' in metrics
    assert 'babble_engine_pass_bytes{kernel="consensus_fused"' in metrics
