"""The port's node Core (babble_tpu_torch/node/core.py) on the torch
engine (`Core(engine="torch")`, TorchHashgraph on the CPU), against the
port's host-engine Core and the JAX package's host `Hashgraph` and
`TpuHashgraph`. Tolerance: exact equality.

- the scripted gossip of tests/test_failover.py (`make_cores` +
  `gossip_script`, 600 syncs) with one torch core among host cores, for
  several (seed, consensus cadence, wire format) cases: the torch core
  equals a host-engine twin Core fed the same events at the same
  cadence in consensus events, committed block bytes, head/seq,
  per-event round and round-received; its events, carried by their
  Go-JSON bytes into the JAX host `Hashgraph` and `TpuHashgraph`, give
  the same order and block bytes; every core agrees on the common
  prefix;
- the Core tests of tests/test_node.py (init heads, sync pair,
  duplicates, identical order, over sync limit) on both engines;
- the Core failover tests of tests/test_failover.py (order and commits
  preserved, idempotent on host) with a real torch engine, and
  tests/test_fastsync.py's Core fast-forward on both engines;
- device verify (ops/p256.py): the whole sync batch goes to the port's
  p256.verify_batch in one call, its verdicts land in the memos, a
  kernel failure raises with no host fallback, and a device-verify
  torch Core driven by the script equals its host twin;
- what the torch seam refuses: no CUDA, engine="tpu"; engine_mesh=2
  builds a two-shard engine."""

from __future__ import annotations

import json
import random

import pytest
import torch

from babble_tpu.hashgraph import Hashgraph as JHashgraph
from babble_tpu.hashgraph import InmemStore as JInmemStore
from babble_tpu.hashgraph.event import event_from_json_obj as j_event_from_json_obj
from babble_tpu.hashgraph.tpu_graph import TpuHashgraph
from babble_tpu_torch import crypto
from babble_tpu_torch.common import StoreError
from babble_tpu_torch.hashgraph import Event, InmemStore, Root, TorchHashgraph
from babble_tpu_torch.hashgraph.event import event_from_json_obj
from babble_tpu_torch.net.transport import FastForwardResponse
from babble_tpu_torch.node import Core

SMALL_ENGINE = {"capacity": 64, "block": 64, "k_capacity": 8, "device": "cpu"}
CACHE = 100000


@pytest.fixture
def cores_made():
    """Collects every Core a test makes and closes its engine."""
    made = []
    yield made
    for c in made:
        close = getattr(c.hg, "close", None)
        if close is not None:
            close()


def keyed(n, seed_base=9000):
    """(keys, participants) in canonical (sorted public key) order."""
    keys = [crypto.key_from_seed(seed_base + i) for i in range(n)]
    pubs = ["0x" + crypto.pub_key_bytes(k).hex().upper() for k in keys]
    order = sorted(range(n), key=lambda i: pubs[i])
    keys = [keys[i] for i in order]
    participants = {pubs[i]: k for k, i in enumerate(order)}
    return keys, participants


def make_cores(made, n, engines, commit_logs=None):
    """test_failover.make_cores: core i on engines[i] ("host" or
    "torch"), each initialised with its index-0 event."""
    keys, participants = keyed(n)
    cores = []
    for i in range(n):
        torch_core = engines[i] == "torch"
        core = Core(
            i, keys[i], participants, InmemStore(participants, CACHE),
            commit_callback=(commit_logs[i].append if commit_logs else None),
            engine=engines[i],
            engine_opts=SMALL_ENGINE if torch_core else None)
        made.append(core)
        cores.append(core)
    for c in cores:
        c.init()
    return cores


def gossip_script(cores, steps, seed, consensus_every=5, offset=0,
                  wire="gojson", marks=None):
    """test_failover.gossip_script: a random pair syncs each step, half
    the steps carry a transaction, and the receiver runs consensus every
    `consensus_every` steps. `wire` picks the diff's wire form (the
    Go-JSON list goes through insert_event, the columnar batch through
    insert_wire_batch); `marks[i]` records how many events core i held
    at each of its consensus passes."""
    rng = random.Random(seed)

    def run(i):
        if marks is not None:
            marks[i].append(cores[i].hg.topological_index)
        cores[i].run_consensus()

    for step in range(steps):
        a, b = rng.sample(range(len(cores)), 2)
        diff = cores[b].diff(cores[a].known())
        if rng.random() < 0.5:
            cores[a].add_transactions([f"tx {offset + step}".encode()])
        cores[a].sync(cores[b].to_wire_batch(diff, wire))
        if step % consensus_every == 0:
            run(a)
    for i in range(len(cores)):
        run(i)


def stored_events(core):
    """Every event of a core's store, in its insertion order."""
    store = core.hg.store
    evs = [store.get_event(h) for pk in core.participants
           for h in store.participant_events(pk, -1)]
    return sorted(evs, key=lambda e: e.topological_index)


def replay(events, marks, insert, run):
    """Insert `events` in order, running consensus where the marks say
    the original core did."""
    k = 0
    for m in marks:
        for ev in events[k:m]:
            insert(ev)
        k = max(k, m)
        run()
    for ev in events[k:]:
        insert(ev)
    run()


def carry_to_jax(ev):
    return j_event_from_json_obj(json.loads(ev.marshal()))


def fresh_copy(ev):
    """The port's Event with the same body and signature and none of the
    graph's annotations (the replays must not write on the originals)."""
    return Event(ev.body, r=ev.r, s=ev.s)


def store_blocks(store, last):
    """{round received: block bytes} of the rounds up to `last` that
    hold a block (empty blocks included)."""
    out = {}
    for rr in range(last + 1):
        try:
            out[rr] = store.get_block(rr).marshal()
        except StoreError:
            continue
    return out


def prefix_equal(a, b):
    m = min(len(a), len(b))
    return a[:m] == b[:m]


@pytest.mark.parametrize("seed,every,wire", [
    (13, 5, "gojson"), (14, 3, "columnar"), (15, 7, "gojson"), (16, 1, "columnar")])
def test_core_script_matches_host_and_jax(cores_made, seed, every, wire):
    commits = [[] for _ in range(4)]
    cores = make_cores(cores_made, 4, ["torch", "host", "host", "host"], commits)
    dev = cores[0]
    assert isinstance(dev.hg, TorchHashgraph) and dev.engine_state == "device"
    marks = [[] for _ in cores]
    gossip_script(cores, 600, seed, consensus_every=every, wire=wire, marks=marks)
    order = dev.get_consensus_events()
    assert len(order) > 100 and (dev.get_last_consensus_round_index() or 0) >= 10
    for c in cores[1:]:
        assert prefix_equal(order, c.get_consensus_events())

    # A host-engine twin Core with the torch core's key, fed its events
    # at its cadence.
    events = stored_events(dev)
    twin_commits = []
    twin = Core(dev.id, dev.key, dev.participants, InmemStore(dev.participants, CACHE),
                commit_callback=twin_commits.append, engine="host")
    replay(events, marks[0], lambda ev: twin.insert_event(fresh_copy(ev), True),
           twin.run_consensus)
    assert twin.get_consensus_events() == order
    assert [b.marshal() for b in twin_commits] == [b.marshal() for b in commits[0]]
    assert commits[0], "the torch core committed no block"
    assert (twin.head, twin.seq) == (dev.head, dev.seq)
    assert twin.get_last_consensus_round_index() == dev.get_last_consensus_round_index()
    assert twin.get_consensus_transactions() == dev.get_consensus_transactions()
    for ev in events:
        x = ev.hex()
        assert (dev.hg.round(x), dev.hg.round_received(x)) == (
            twin.hg.round(x), twin.hg.round_received(x)), x
    last = dev.get_last_consensus_round_index()
    assert store_blocks(dev.hg.store, last) == store_blocks(twin.hg.store, last)

    # The same events in the JAX package, carried by their Go-JSON bytes.
    jax_events = [carry_to_jax(ev) for ev in events]
    for kind in ("host", "tpu"):
        blocks = []
        store = JInmemStore(dev.participants, CACHE)
        g = (JHashgraph(dev.participants, store, blocks.append) if kind == "host"
             else TpuHashgraph(dev.participants, store, blocks.append,
                               capacity=64, block=64, k_capacity=8))
        try:
            for jev in jax_events:
                g.insert_event(jev, True)
            g.run_consensus()
        finally:
            if kind == "tpu":
                g.engine.close()
        assert g.consensus_events() == order, kind
        assert [b.marshal() for b in blocks] == [b.marshal() for b in commits[0]], kind
        assert g.last_consensus_round == dev.get_last_consensus_round_index(), kind


# ------------------------------------------------- test_node.py's Core tests


ENGINES = ["host", "torch"]


def init_cores(made, n, engine):
    return make_cores(made, n, [engine] * n)


def synchronize_cores(cores, frm, to, payload=()):
    unknown = cores[frm].diff(cores[to].known())
    cores[to].add_transactions(list(payload))
    cores[to].sync(cores[frm].to_wire(unknown))


@pytest.mark.parametrize("engine", ENGINES)
def test_core_init_heads(cores_made, engine):
    for c in init_cores(cores_made, 3, engine):
        assert c.seq == 0
        assert c.head != ""
        assert c.get_head().creator() == c.hex_id()


@pytest.mark.parametrize("engine", ENGINES)
def test_core_sync_pair(cores_made, engine):
    cores = init_cores(cores_made, 2, engine)
    synchronize_cores(cores, 0, 1, [b"hello"])
    assert cores[1].seq == 1
    assert sorted(cores[1].known().values()) == [0, 1]
    synchronize_cores(cores, 1, 0)
    assert cores[0].seq == 1
    assert all(v == 1 for v in cores[0].known().values())


@pytest.mark.parametrize("engine", ENGINES)
def test_core_sync_tolerates_duplicates(cores_made, engine):
    cores = init_cores(cores_made, 2, engine)
    synchronize_cores(cores, 0, 1, [b"a"])
    stale_known = {pid: -1 for pid in cores[1].known()}
    overlap = cores[0].to_wire(cores[0].diff(stale_known))
    assert len(overlap) >= 1
    before = cores[1].known()
    cores[1].sync(overlap)
    after = cores[1].known()
    for pid, idx in before.items():
        assert after[pid] >= idx
    assert sum(after.values()) == sum(before.values()) + 1
    synchronize_cores(cores, 1, 0)
    synchronize_cores(cores, 0, 1)


@pytest.mark.parametrize("engine", ENGINES)
def test_core_consensus_identical_order(cores_made, engine):
    cores = init_cores(cores_made, 3, engine)
    playbook = [
        (0, 1, [b"tx one"]), (1, 2, []), (2, 0, [b"tx two"]), (0, 1, []),
        (1, 2, [b"tx three"]), (2, 0, []), (0, 1, [b"tx four"]), (1, 2, []),
        (2, 0, []), (0, 1, []), (1, 2, []), (2, 0, []),
    ]
    for frm, to, payload in playbook:
        synchronize_cores(cores, frm, to, payload)
        cores[to].run_consensus()
    orders = [c.get_consensus_events() for c in cores]
    assert max(len(o) for o in orders) > 0, "no consensus reached"
    for o in orders[1:]:
        assert prefix_equal(orders[0], o)


@pytest.mark.parametrize("engine", ENGINES)
def test_core_over_sync_limit(cores_made, engine):
    cores = init_cores(cores_made, 2, engine)
    for _ in range(5):
        synchronize_cores(cores, 0, 1, [b"x"])
        synchronize_cores(cores, 1, 0)
    known_zero = {i: -1 for i in cores[0].known()}
    assert cores[0].over_sync_limit(known_zero, 5)
    assert not cores[0].over_sync_limit(cores[0].known(), 5)


# --------------------------------------------- test_failover.py's Core tests


def test_core_failover_preserves_order_and_commits(cores_made):
    commits = [[] for _ in range(4)]
    cores = make_cores(cores_made, 4, ["torch", "host", "host", "host"], commits)
    dev = cores[0]
    engine = dev.hg.engine
    gossip_script(cores, 160, seed=13)
    assert (dev.get_last_consensus_round_index() or 0) >= 1
    pre_events = list(dev.get_consensus_events())
    pre_rounds = [b.round_received for b in commits[0]]
    pre_head = (dev.head, dev.seq)
    assert pre_events, "the torch engine decided nothing before the failover"

    dev.failover_to_host()

    assert dev.engine_state == "failed_over" and dev.engine_failovers == 1
    assert not dev.supports_pipeline()
    assert engine._stage_thread is None  # the torch engine was closed
    assert (dev.head, dev.seq) == pre_head
    post_events = dev.get_consensus_events()
    assert post_events[:len(pre_events)] == pre_events
    post_rounds = [b.round_received for b in commits[0]]
    assert post_rounds[:len(pre_rounds)] == pre_rounds
    new_rounds = post_rounds[len(pre_rounds):]
    assert all(r > max(pre_rounds, default=-1) for r in new_rounds)
    assert len(post_rounds) == len(set(post_rounds))

    gossip_script(cores, 160, seed=14, offset=1000)
    assert len(dev.get_consensus_events()) > len(post_events)
    assert prefix_equal(cores[1].get_consensus_events(), dev.get_consensus_events())


def test_core_failover_idempotent_on_host(cores_made):
    host = make_cores(cores_made, 2, ["torch", "host"])[1]
    host.failover_to_host()
    assert host.engine_state == "host"
    assert host.engine_failovers == 0


# --------------------------------------------- test_fastsync.py's Core test


@pytest.mark.parametrize("engine", ENGINES)
def test_core_fast_forward_through_wire_frame(cores_made, engine):
    """tests/test_fastsync.py's Core test: a joiner fast-forwards to a
    donor's frame shipped in its wire form (a torch joiner resets its
    engine), then continued gossip reaches the donor's order past two
    rounds beyond the frame."""
    keys, participants = keyed(4, seed_base=7000)
    cores = []
    for i in range(4):
        core = Core(i, keys[i], participants, InmemStore(participants, CACHE), engine=engine,
                    engine_opts=SMALL_ENGINE if engine == "torch" else None)
        cores_made.append(core)
        cores.append(core)
    for c in cores[:3]:
        c.init()
    rng = random.Random(11)

    def gossip_round(a, b):
        cores[a].sync(cores[b].to_wire(cores[b].diff(cores[a].known())))

    for step in range(200):
        a, b = rng.sample(range(3), 2)
        gossip_round(a, b)
        if step % 5 == 0:
            cores[a].run_consensus()
    for c in cores[:3]:
        c.run_consensus()
    donor = cores[0]
    r0 = donor.get_last_consensus_round_index()
    assert r0 >= 1
    frame = donor.get_frame()
    wire = FastForwardResponse.from_dict(FastForwardResponse(
        0, roots={pk: r.to_dict() for pk, r in frame.roots.items()},
        events=[json.loads(e.marshal()) for e in frame.events]).to_dict())
    roots = {pk: Root.from_dict(d) for pk, d in wire.roots.items()}
    joiner = cores[3]
    joiner.init()
    old_engine = getattr(joiner.hg, "engine", None)
    joiner.fast_forward(roots, [event_from_json_obj(o) for o in wire.events])
    if engine == "torch":
        assert joiner.hg.engine is not old_engine and joiner.engine_state == "device"
    want = donor.known()
    for pid, ct in joiner.known().items():
        if pid != 3:
            assert 0 <= ct <= want[pid]

    for step in range(200):
        a, b = rng.sample(range(4), 2)
        gossip_round(a, b)
        if step % 5 == 0:
            cores[a].run_consensus()
    for c in cores:
        c.run_consensus()

    def past_boundary(core):
        return [h for h in core.get_consensus_events()
                if (core.get_event(h).round_received or -1) > r0 + 2]

    jc, dc = past_boundary(joiner), past_boundary(donor)
    assert jc, "no post-boundary consensus to compare"
    assert prefix_equal(jc, dc)


# ------------------------------------------------------ what the seam refuses


def _bare_core(**kw):
    keys, participants = keyed(2)
    return Core(0, keys[0], participants, InmemStore(participants, CACHE), **kw)


def test_device_verify_batch_raises(monkeypatch):
    """With no CUDA device and none named, device verify raises like
    every entry point, and never verifies on the host behind the flag."""
    from babble_tpu_torch.node.ingest import active_backend, verify_events

    core = _bare_core(engine="host")
    core.init()
    head = fresh_copy(core.get_head())
    assert active_backend(True) == "device-p256"
    assert active_backend(False) == crypto.BACKEND
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_events([head], 1, device_verify=True)
    assert head._sig_ok is None
    with pytest.raises(RuntimeError, match="CUDA"):
        _bare_core(engine="host", device_verify=True)


def _signed_events():
    """Three events of one creator signed with the deterministic signer,
    the second one corrupted."""
    from babble_tpu_torch.crypto import _fallback as fb

    key = fb.key_from_seed(5)
    pub = fb.pub_key_bytes(key)
    events = []
    for i in range(3):
        ev = Event.new([b"tx-%d" % i], ["p0", "p1"], pub, i)
        ev.r, ev.s = fb.sign(key, ev.body.hash())
        events.append(ev)
    events[1].r = int(events[1].r) + 1
    return events


def test_device_verify_routes_the_whole_batch(monkeypatch):
    """verify_events(..., device_verify=True) hands the whole batch to
    the port's p256.verify_batch in one call, on the named device, and
    memoizes the verdicts the host path would."""
    from babble_tpu_torch.node.ingest import verify_events
    from babble_tpu_torch.ops import p256

    calls = []
    real = p256.verify_batch

    def spying(pubs, digests, sigs, device=None):
        calls.append((len(pubs), device))
        return real(pubs, digests, sigs, device=device)

    monkeypatch.setattr(p256, "verify_batch", spying)
    events = _signed_events()
    assert [ev._sig_ok for ev in events] == [None] * 3
    verify_events(events, 4, device_verify=True, device="cpu")
    assert calls == [(3, torch.device("cpu"))]
    assert [ev._sig_ok for ev in events] == [True, False, True]
    host = [fresh_copy(ev) for ev in events]
    from babble_tpu_torch.node.ingest import verify_batch_events

    verify_batch_events(host)
    assert [ev._sig_ok for ev in host] == [True, False, True]


def test_device_verify_kernel_failure_raises(monkeypatch):
    """A failing kernel raises out of verify_events; no host path writes
    a memo behind it."""
    from babble_tpu_torch.node.ingest import verify_events
    from babble_tpu_torch.ops import p256

    def failing(*args, **kw):
        raise RuntimeError("p256 kernel launch failed: CUDA error 700")

    monkeypatch.setattr(p256, "verify_batch", failing)
    events = _signed_events()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        verify_events(events, 4, device_verify=True, device="cpu")
    assert [ev._sig_ok for ev in events] == [None] * 3


def test_device_verify_core_matches_host_twin(cores_made):
    """A torch Core with device_verify on the CPU among host cores,
    driven by a short gossip script: every sync's verify runs on the
    plain P-256 ladder (the phase verify_device-p256), and the core
    equals a host-engine twin fed its events at its cadence."""
    keys, participants = keyed(4)
    commits = []
    cores = [Core(i, keys[i], participants, InmemStore(participants, CACHE),
                  commit_callback=commits.append if i == 0 else None,
                  engine="torch" if i == 0 else "host",
                  engine_opts=SMALL_ENGINE if i == 0 else None,
                  device_verify=(i == 0))
             for i in range(4)]
    cores_made.extend(cores)
    for c in cores:
        c.init()
    dev = cores[0]
    assert dev.device_verify and dev._verify_device == torch.device("cpu")
    marks = [[] for _ in cores]
    gossip_script(cores, 60, 21, consensus_every=3, marks=marks)
    assert dev.phase_ns["verify_device-p256"][2] > 0
    assert "verify_" + crypto.BACKEND not in dev.phase_ns
    assert all("verify_device-p256" not in c.phase_ns for c in cores[1:])
    order = dev.get_consensus_events()
    assert order and commits
    events = stored_events(dev)
    twin_commits = []
    twin = Core(dev.id, dev.key, dev.participants, InmemStore(dev.participants, CACHE),
                commit_callback=twin_commits.append, engine="host")
    replay(events, marks[0], lambda ev: twin.insert_event(fresh_copy(ev), True),
           twin.run_consensus)
    assert twin.get_consensus_events() == order
    assert [b.marshal() for b in twin_commits] == [b.marshal() for b in commits]
    assert (twin.head, twin.seq) == (dev.head, dev.seq)
    for c in cores[1:]:
        assert prefix_equal(order, c.get_consensus_events())


def test_defaults_are_the_torch_engine_on_cuda(monkeypatch, cores_made):
    """A Core, and a Node's Config, with no engine named run the torch
    engine on CUDA (no CUDA: they raise); a failing device pass does not
    move the node to the host engine unless failover is turned on."""
    from babble_tpu_torch.node.config import Config, test_config

    for conf in (Config(), test_config()):
        assert (conf.engine, conf.engine_failover_threshold) == ("torch", 0)
    core = _bare_core(engine_opts=SMALL_ENGINE)
    cores_made.append(core)
    assert isinstance(core.hg, TorchHashgraph) and core.engine_state == "device"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _bare_core()


def test_torch_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _bare_core(engine="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        _bare_core(engine="torch", engine_opts={"capacity": 64, "block": 64})


@pytest.mark.parametrize("kw,match", [
    ({"engine": "tpu"}, "'torch'"),
    ({"engine": "jax"}, "unknown consensus engine"),
])
def test_engine_choice_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        _bare_core(**kw)


def test_engine_mesh_builds_a_sharded_engine():
    """Core(engine_mesh=2) over 2 validators builds a two-shard engine on
    the engine's device (the JAX Core's mesh from Config.engine_mesh):
    the coordinate table in two column shards of one column each."""
    core = _bare_core(engine="torch", engine_mesh=2, engine_opts=SMALL_ENGINE)
    try:
        eng = core.hg.engine
        assert [t.device for t in eng.shards("_la")] == [torch.device("cpu")] * 2
        assert [t.shape[1] for t in eng.shards("_la")] == [1, 1]
        assert eng.device_memory_stats()["mesh_shards"] == 2
    finally:
        core.hg.close()


def test_default_presize(monkeypatch):
    """The reference's presize (capacity 65,536, block 512, k_capacity
    max(64, min(cap, 2**28 // (4 n^2)))), each overridable; the engine
    shares the Core's span ring, off in a bare Core."""
    seen = []

    class Spy(TorchHashgraph):
        def __init__(self, *args, **kw):
            seen.append(kw)
            raise RuntimeError("stop")

    import babble_tpu_torch.hashgraph.torch_graph as tg

    monkeypatch.setattr(tg, "TorchHashgraph", Spy)
    for opts, want in [
            (None, dict(capacity=65536, block=512, k_capacity=65536, device=None)),
            ({"capacity": 1024, "device": "cpu"},
             dict(capacity=1024, block=512, k_capacity=1024, device="cpu")),
            ({"k_capacity": 8, "block": 64},
             dict(capacity=65536, block=64, k_capacity=8, device=None))]:
        with pytest.raises(RuntimeError, match="stop"):
            _bare_core(engine="torch", engine_opts=opts, engine_prewarm=True)
        got = seen.pop()
        assert got.pop("trace").capacity == 0
        assert got == dict(want, prewarm=True, mesh=None), got
