"""Live in-memory nets of the port's Nodes (babble_tpu_torch/node/node.py
over InmemTransport and InmemAppProxy), with consensus on the torch
engine (TorchHashgraph on the CPU). Tolerance: exact equality.

- 4 torch nodes gossip to consensus round 5 (tests/test_incremental.py's
  test_gossip_tpu_engine, with tests/test_node.py's consensus interval
  of 0.05 s for the device engine), pass check_gossip and commit
  byte-identical blocks; every node stays on the device engine with no
  failover and no failed pass;
- a mixed net of 2 torch and 2 host nodes commits byte-identical blocks;
- by default a torch node whose engine raises stays on the device
  engine and commits nothing: failover to the host engine is opt-in;
- with failover turned on, the node watchdog (tests/test_failover.py's
  watchdog test) fails a torch node whose engine raises over to the
  host engine while the net keeps converging;
- the node state's wait_routines never joins a routine before it has
  started (ROADMAP C6), under a stress of routines starting.

Each net runs under a deadline of its own (DEADLINE_S): the suite has
no timeout plugin."""

from __future__ import annotations

import logging
import sys
import threading
import time

import pytest

from babble_tpu_torch import crypto
from babble_tpu_torch.hashgraph import InmemStore, TorchHashgraph
from babble_tpu_torch.net import InmemTransport, Peer, TCPTransport
from babble_tpu_torch.net.inmem_transport import connect_all
from babble_tpu_torch.node import Node
from babble_tpu_torch.node.config import Config
from babble_tpu_torch.node.config import test_config as fast_config
from babble_tpu_torch.node.state import NodeState, StateMachine
from chip_smoke import FailedPassRecords, committed_blocks, delivery_check, recording_proxy

SMALL_ENGINE = {"capacity": 64, "block": 64, "k_capacity": 8, "device": "cpu"}
CACHE = 10000
DEADLINE_S = 90.0
# The reference's TCP test cadence. At its 0.01 s in-memory cadence the
# gossip threads keep the interpreter lock busy, and the engines' passes
# (a few thousand torch calls, each releasing and re-taking the lock)
# run 10-50x slower on the CPU than alone.
HEARTBEAT = 0.05


@pytest.fixture
def failed_passes():
    handler = FailedPassRecords()
    logger = logging.getLogger("babble_tpu_torch")
    logger.addHandler(handler)
    yield handler
    logger.removeHandler(handler)


def make_nodes(engines, transport="inmem", store=None, bootstrap=False, engine_mesh=0):
    """tests/test_node.make_nodes: node i on engines[i], over the inmem
    transport or TCP on free localhost ports; torch nodes run consensus
    on the worker every 0.05 s, their engines split into `engine_mesh`
    shards (Config.engine_mesh). `store(i, participants)` makes node i's
    store (default an InmemStore); `bootstrap` recovers each node from
    it."""
    n = len(engines)
    if transport == "tcp":
        trans = [TCPTransport("127.0.0.1:0", timeout=2.0) for _ in range(n)]
    else:
        trans = [InmemTransport(f"addr{i}", timeout=2.0) for i in range(n)]
        connect_all(trans)
    by_addr = {t.local_addr(): t for t in trans}
    keys = [crypto.key_from_seed(5000 + i) for i in range(n)]
    entries = sorted(((k, Peer(t.local_addr(), "0x" + crypto.pub_key_bytes(k).hex().upper()))
                      for k, t in zip(keys, trans)), key=lambda e: e[1].pub_key_hex)
    peers = [p for _, p in entries]
    participants = {p.pub_key_hex: i for i, p in enumerate(peers)}
    nodes = []
    for i, (key, peer) in enumerate(entries):
        conf = fast_config(heartbeat=HEARTBEAT)
        conf.engine = engines[i]
        conf.engine_mesh = engine_mesh
        if engines[i] == "torch":
            conf.engine_opts = SMALL_ENGINE
            conf.consensus_interval = 0.05
        st = store(i, participants) if store else InmemStore(participants, CACHE)
        node = Node(conf, i, key, peers, st, by_addr[peer.net_addr], recording_proxy())
        node.init(bootstrap=bootstrap)
        nodes.append(node)
    return nodes


def run_gossip(nodes, target_round, until=lambda: True, timeout=DEADLINE_S,
               shutdown=True):
    """tests/test_node.run_gossip: submit a transaction every 20 ms
    until every node has decided `target_round` and `until()` holds,
    then shut the net down unless told not to. Returns the submitted
    transactions."""
    for node in nodes:
        node.run_async(gossip=True)
    submitted = []
    deadline = time.monotonic() + timeout
    i = 0
    try:
        while time.monotonic() < deadline:
            tx = f"node{i % len(nodes)} transaction {i}".encode()
            nodes[i % len(nodes)].submit_tx(tx)
            submitted.append(tx)
            i += 1
            if until() and all((n.core.get_last_consensus_round_index() or 0) >= target_round
                               for n in nodes):
                return submitted
            time.sleep(0.02)
        rounds = [n.core.get_last_consensus_round_index() for n in nodes]
        raise AssertionError(f"timeout: consensus rounds {rounds} < {target_round}, "
                             f"engine states {[n.core.engine_state for n in nodes]}")
    finally:
        if shutdown:
            stop(nodes)


def stop(nodes):
    """Shut every node down, wait for its routines to end (the consensus
    worker finishes its pass in flight), then close its torch engine."""
    for node in nodes:
        node.shutdown()
    for node in nodes:
        node.state.wait_routines(timeout=30.0)
        close = getattr(node.core.hg, "close", None)
        if close is not None:
            close()


def running(node):
    return sum(t.is_alive() for t in list(node.state._threads))


def check_gossip(nodes):
    """tests/test_node.check_gossip: consensus events and transactions
    agree on their common prefix across nodes."""
    events = [n.core.get_consensus_events() for n in nodes]
    txs = [n.core.get_consensus_transactions() for n in nodes]
    min_e = min(len(e) for e in events)
    min_t = min(len(t) for t in txs)
    assert min_e > 0, "no consensus events"
    for n, e, t in zip(nodes[1:], events[1:], txs[1:]):
        assert e[:min_e] == events[0][:min_e], f"consensus event mismatch vs node {n.id}"
        assert t[:min_t] == txs[0][:min_t], f"consensus tx mismatch vs node {n.id}"


def check_blocks(nodes, submitted):
    """Committed blocks byte-identical on the rounds every node decided;
    on each stopped node every committed block was delivered to the app
    in round order and equal, or is still queued for delivery, all but
    chip_smoke.DELIVERY_ALLOWANCE of them (chip_smoke.delivery_check: the
    reference node's shutdown race, ROADMAP §C); no transaction
    committed twice, and each one was submitted."""
    committed = [committed_blocks(n.core.hg) for n in nodes]
    common = min(n.core.get_last_consensus_round_index() or -1 for n in nodes)
    ref = {rr: b for rr, b in committed[0].items() if rr <= common}
    assert ref, "no block committed"
    for n, c in zip(nodes[1:], committed[1:]):
        assert {rr: b for rr, b in c.items() if rr <= common} == ref, (
            f"committed blocks differ vs node {n.id}")
    sent = set(submitted)
    for n, c in zip(nodes, committed):
        assert running(n) == 0, f"node {n.id} did not stop"
        ok, counts = delivery_check(n, c)
        assert ok, f"node {n.id} delivery differs from its committed blocks: {counts}"
        txs = n.proxy.committed_transactions()
        assert len(txs) == len(set(txs)), f"node {n.id} committed a transaction twice"
        assert set(txs) <= sent, f"node {n.id} committed a transaction never submitted"


def test_gossip_torch_engine(failed_passes):
    nodes = make_nodes(["torch"] * 4)
    for node in nodes:
        assert isinstance(node.core.hg, TorchHashgraph)
        assert node.core.supports_pipeline()
    submitted = run_gossip(nodes, target_round=5)
    check_gossip(nodes)
    check_blocks(nodes, submitted)
    for node in nodes:
        assert node.core.engine_state == "device"
        assert node.core.engine_failovers == 0
        assert node.core.phase_ns["consensus_collect"][2] > 0
    assert failed_passes.count == 0


def test_mixed_torch_and_host_net(failed_passes):
    engines = ["torch", "host", "torch", "host"]
    nodes = make_nodes(engines)
    submitted = run_gossip(nodes, target_round=5,
                           until=lambda: min(len(n.proxy.blocks) for n in nodes) >= 2)
    check_gossip(nodes)
    check_blocks(nodes, submitted)
    for node, engine in zip(nodes, engines):
        assert node.core.engine_state == ("device" if engine == "torch" else "host")
    assert failed_passes.count == 0


def test_failing_torch_node_stays_on_device_by_default(failed_passes):
    """The port's default config has no failover (threshold 0): a torch
    node whose engine raises on every dispatch is not moved to the host
    engine. It logs each failed pass and commits nothing."""
    nodes = make_nodes(["torch", "host", "host", "host"])
    victim = nodes[0]
    assert victim.conf.engine_failover_threshold == Config().engine_failover_threshold == 0
    engine = victim.core.hg.engine

    def bad_dispatch(unlocked=None):
        raise RuntimeError("injected device failure")

    engine.dispatch = bad_dispatch
    # Twice the reference's default threshold (3) of consecutive failures.
    want = 6
    try:
        for nd in nodes:
            nd.run_async(gossip=True)
        deadline = time.monotonic() + DEADLINE_S
        i = 0
        while failed_passes.count < want and time.monotonic() < deadline:
            nodes[i % len(nodes)].submit_tx(f"tx {i}".encode())
            i += 1
            time.sleep(0.02)
    finally:
        stop(nodes)
    assert failed_passes.count >= want
    assert (victim.core.engine_state, victim.core.engine_failovers) == ("device", 0)
    assert victim.get_stats()["engine_state"] == "device"
    assert victim.core.hg is not None and isinstance(victim.core.hg, TorchHashgraph)
    assert committed_blocks(victim.core.hg) == {} and victim.proxy.blocks == []


def test_node_watchdog_fails_torch_over_and_net_converges(failed_passes):
    """The victim's torch engine raises on every dispatch: after two
    failed passes the watchdog rebuilds it on the host engine, closes
    the torch engine, and the net stays byte-identical."""
    nodes = make_nodes(["torch", "host", "host", "host"])
    victim = nodes[0]
    for nd in nodes:
        nd.conf.consensus_interval = 0.02
    victim.conf.engine_failover_threshold = 2
    engine = victim.core.hg.engine

    def bad_dispatch(unlocked=None):
        raise RuntimeError("injected device failure")

    engine.dispatch = bad_dispatch
    try:
        submitted = run_gossip(nodes, target_round=5, shutdown=False,
                               until=lambda: victim.core.engine_state == "failed_over")
        stats = victim.get_stats()
        assert stats["engine_state"] == "failed_over"
        assert int(stats["engine_failovers"]) == 1
        assert victim.state.get_state() == NodeState.BABBLING
    finally:
        stop(nodes)
    assert engine._stage_thread is None
    assert failed_passes.count >= 2
    check_gossip(nodes)
    check_blocks(nodes, submitted)
    assert len(victim.proxy.committed_transactions()) > 0


@pytest.mark.parametrize("delivered,lost_ok", [
    ([0, 1, 2], True),   # the tx-less round 3 was never the app's to deliver
    ([0, 2], True),      # one block with transactions lost: the forwarder race
    ([0], False),        # two lost is a fault
])
def test_delivery_check_leaves_out_blocks_without_transactions(delivered, lost_ok):
    """delivery_check counts a committed block as lost only if it holds
    transactions: the graphs store a block for every decided round but
    hand the app only those with transactions, so a round decided after
    the last submission is stored and never delivered."""
    import queue
    from types import SimpleNamespace

    from babble_tpu_torch.hashgraph.block import Block

    store = InmemStore({"0xAA": 0}, CACHE)
    blocks = [Block(rr, [b"tx %d" % rr] if rr < 3 else None) for rr in range(4)]
    for blk in blocks:
        store.set_block(blk)
    node = SimpleNamespace(
        core=SimpleNamespace(hg=SimpleNamespace(store=store)),
        proxy=SimpleNamespace(blocks=[(rr, blocks[rr].marshal()) for rr in delivered]),
        _work=queue.Queue(), commit_ch=queue.Queue())
    own = {blk.round_received: blk.marshal() for blk in blocks}
    ok, counts = delivery_check(node, own)
    assert ok is lost_ok
    assert counts["lost"] == [rr for rr in range(3) if rr not in delivered]


def test_wait_routines_never_joins_a_routine_before_it_starts():
    """The node state's routines (node/state.py) started by 16 threads
    while a shutdown's wait_routines joins them, the interpreter
    switching threads every microsecond, for one second: no join meets
    a routine registered but not started, which raised RuntimeError in
    the reference's copy (ROADMAP C6) and failed a node's shutdown."""
    sm = StateMachine()
    stop_spawning = threading.Event()
    errors = []

    def spawner():
        while not stop_spawning.is_set():
            sm.go_func(lambda: time.sleep(0.001))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spawners = [threading.Thread(target=spawner) for _ in range(16)]
    try:
        for t in spawners:
            t.start()
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            try:
                sm.wait_routines(timeout=0.05)
            except RuntimeError as exc:
                errors.append(exc)
    finally:
        stop_spawning.set()
        for t in spawners:
            t.join(5.0)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in spawners)
    assert not errors, errors[:3]
