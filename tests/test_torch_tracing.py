"""The port's spans and counters (babble_tpu_torch/TRACING.md): spans carry
their parent, their thread and their pass's id; the map of span stamps
onto a profiler trace's clock; verify_batch's counters as the Core's
phases; the timed core lock; the consensus worker's sleep; a bare Core
records nothing. The tests marked `card` need a CUDA device and skip
here (`python -m pytest tests/test_torch_tracing.py -q -m card` on the
chip): a span around a marker kernel and a synchronise encloses the
kernel on the profiler's trace, and a verify call synchronises its
stream once unless the split is asked for."""

from __future__ import annotations

import contextlib
import threading
import time
import types

import pytest
import torch

from babble_tpu_torch import crypto
from babble_tpu_torch.crypto import _fallback as fb
from babble_tpu_torch.hashgraph import InmemStore
from babble_tpu_torch.node import Core
from babble_tpu_torch.node.node import Node
from babble_tpu_torch.ops import incremental as tinc
from babble_tpu_torch.ops import p256
from babble_tpu_torch.ops.dag import synthetic_dag
from babble_tpu_torch.telemetry import devclock
from babble_tpu_torch.telemetry.timedlock import TimedLock
from babble_tpu_torch.telemetry.trace import SpanRing

SMALL_ENGINE = {"capacity": 64, "block": 64, "k_capacity": 8, "device": "cpu"}


def by_name(ring):
    out = {}
    for sp in ring.snapshot():
        out.setdefault(sp["name"], []).append(sp)
    return out


def test_spans_record_parent_and_thread():
    ring = SpanRing(64)
    me = threading.get_native_id()
    with ring.span("outer") as outer:
        assert ring.current() == outer["span_id"]
        with ring.span("inner") as inner:
            ring.record("leaf", 1, 2)
        other = []
        t = threading.Thread(target=lambda: other.append(
            ring.record("elsewhere", 3, 4, parent=outer["span_id"])))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert ring.current() == 0
    sp = by_name(ring)
    assert sp["outer"][0]["parent"] == 0
    assert sp["inner"][0]["parent"] == outer["span_id"]
    assert sp["leaf"][0]["parent"] == inner["span_id"]
    assert {s["tid"] for n in ("outer", "inner", "leaf") for s in sp[n]} == {me}
    assert sp["elsewhere"][0]["parent"] == outer["span_id"]
    assert sp["elsewhere"][0]["tid"] != me
    ev = [e for e in ring.to_chrome_trace()["traceEvents"] if e.get("name") == "inner"]
    assert ev[0]["args"]["parent"] == outer["span_id"] and ev[0]["args"]["thread"] == me


def test_a_ring_of_capacity_zero_records_nothing():
    ring = SpanRing(0)
    with ring.span("a", x=1) as rec:
        assert rec == {"x": 1}
        assert ring.current() == 0
    assert ring.record("b", 1, 2) == 0
    assert len(ring) == 0 and ring.snapshot() == []


def test_the_staging_thread_records_the_dispatching_pass():
    """engine.stage runs on the staging thread, names the dispatching
    span as its parent and carries the pass's id; its stages are its
    children; collect's spans are children of the collecting span."""
    ring = SpanRing(1024)
    eng = tinc.IncrementalEngine(8, device="cpu", trace=ring, capacity=64, block=64,
                                 k_capacity=8)
    dag, _ = synthetic_dag(8, 120, seed=3)
    me = threading.get_native_id()
    try:
        for pid, (lo, hi) in enumerate([(0, 60), (60, 120)], start=1):
            eng.append_batch(dag.self_parent[lo:hi], dag.other_parent[lo:hi],
                             dag.creator[lo:hi], dag.index[lo:hi], dag.coin[lo:hi],
                             torch.arange(lo, hi).numpy())
            with ring.span("dispatch") as disp:
                pp = eng.dispatch()
            assert pp.pass_id == pid
            with ring.span("collect") as coll:
                eng.collect(pp)
            sp = by_name(ring)
            stage = [s for s in sp["engine.stage"] if s["args"]["pass_id"] == pid]
            assert len(stage) == 1
            stage = stage[0]
            assert stage["parent"] == disp["span_id"] and stage["tid"] != me
            kids = {s["name"] for n, ss in sp.items() for s in ss
                    if s["parent"] == stage["id"]}
            assert {"engine.coords", "engine.fd_fold", "engine.frontier"} <= kids
            for name in ("engine.stage_wait", "engine.pull", "engine.apply"):
                mine = [s for s in sp[name] if s["args"]["pass_id"] == pid]
                assert mine and all(s["parent"] == coll["span_id"] and s["tid"] == me
                                    for s in mine)
    finally:
        eng.close()


def test_trace_rebase_maps_anchor_pairs():
    one = devclock.trace_rebase([(1_000, 51_000)])
    assert one(1_000) == 51_000 and one(4_000) == 54_000
    # the trace's clock runs 1e-4 fast against the host's
    two = devclock.trace_rebase([(0, 10_000_000), (1_000_000_000, 1_010_100_000)])
    assert two(0) == 10_000_000
    assert two(500_000_000) == 510_050_000
    assert two(1_000_000_000) == 1_010_100_000
    based = devclock.trace_rebase([(0, 10_000), (1_000, 11_000)], base_ns=10_000)
    assert based(0) == 0 and based(500) == 500
    assert devclock.anchors([(100, 300)], [(5_000, 5_010)]) == [(200, 5_005)]
    with pytest.raises(ValueError):
        devclock.anchors([(0, 1)], [])
    with pytest.raises(ValueError):
        devclock.trace_rebase([])
    assert devclock.is_marker("void at::cuda::(anonymous namespace)::spin_kernel(long)")


def test_timed_lock_counts_a_held_out_thread():
    waits = []
    lock = TimedLock(lambda t0, t1, site: waits.append((t1 - t0, site, lock.locked())))
    with lock:
        pass
    assert waits == []
    held = threading.Event()

    def holder():
        with lock:
            held.set()
            time.sleep(0.05)

    def second_thread():
        with lock:
            pass

    t1 = threading.Thread(target=holder)
    t1.start()
    assert held.wait(10)
    t2 = threading.Thread(target=second_thread)
    t2.start()
    for t in (t1, t2):
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(waits) == 1
    ns, site, locked = waits[0]
    assert ns >= 20_000_000 and site == "second_thread" and locked
    assert not lock.locked()
    assert lock.acquire(blocking=False) and not lock.acquire(blocking=False)
    lock.release()


def test_timed_lock_releases_when_its_report_fails():
    def fail(*_):
        raise RuntimeError("report")

    lock = TimedLock(fail)
    lock.acquire()
    t = threading.Timer(0.02, lock.release)
    t.start()
    with pytest.raises(RuntimeError, match="report"):
        lock.acquire()
    t.join(timeout=10)
    assert not lock.locked()


class _Wakes:
    """A shutdown event whose wait returns at once and is set after
    `n` waits."""

    def __init__(self, n):
        self.left, self.waits = n, []

    def is_set(self):
        return self.left <= 0

    def wait(self, timeout):
        self.waits.append(timeout)
        self.left -= 1
        return self.is_set()


def test_consensus_loop_records_one_sleep_per_wake():
    ring = SpanRing(64)
    counted = []
    core = types.SimpleNamespace(
        supports_pipeline=lambda: True,
        dispatch_consensus=lambda unlocked=None: object(),
        collect_consensus=lambda pp, unlocked=None: time.sleep(0.002),
        count_phase=lambda phase, ns, calls=1: counted.append((phase, ns)))
    node = types.SimpleNamespace(
        conf=types.SimpleNamespace(consensus_interval=0.05, pipeline_depth=1,
                                   engine_failover_threshold=0),
        core=core, _shutdown=_Wakes(4), trace=ring, core_lock=threading.Lock(),
        _core_unlocked=contextlib.nullcontext, logger=None)
    Node._consensus_loop(node)
    sleeps = by_name(ring)["consensus.sleep"]
    assert len(sleeps) == 4
    assert [s["args"]["interval_ms"] for s in sleeps] == [w * 1e3 for w in node._shutdown.waits]
    for s in sleeps:
        a = s["args"]
        assert a["interval_ms"] == min(max(50.0, 2 * a["ema_ms"]), 4 * 50.0 + 1500.0)
    # the wakes that ran a pass count their sleep under the core lock
    assert [p for p, _ in counted] == ["consensus_sleep"] * 3
    assert [ns for _, ns in counted] == [s["t1"] - s["t0"] for s in sleeps[:3]]


def _keys(n, seed=9100):
    keys = [crypto.key_from_seed(seed + i) for i in range(n)]
    pubs = ["0x" + crypto.pub_key_bytes(k).hex().upper() for k in keys]
    order = sorted(range(n), key=lambda i: pubs[i])
    return [keys[i] for i in order], {pubs[i]: k for k, i in enumerate(order)}


def test_verify_counters_and_sync_spans(monkeypatch):
    """A torch Core with device verify on the CPU: the sync's children
    on the ring, verify_batch's parts as its counters (one window table
    per distinct creator key on a cold store, a hit for every other
    signature) and the lock retake; a bare Core beside it records no
    span and builds no table: both Cores pinned the same peers'."""
    keys, participants = _keys(3)
    ring = SpanRing(256)
    dev = Core(0, keys[0], participants, InmemStore(participants, 1000), engine="torch",
               engine_opts=SMALL_ENGINE, device_verify=True, trace=ring)
    bare = Core(0, keys[0], participants, InmemStore(participants, 1000),
                engine="torch", engine_opts=SMALL_ENGINE, device_verify=True)
    peers = [Core(i, keys[i], participants, InmemStore(participants, 1000), engine="host")
             for i in (1, 2)]
    seen = []
    real = p256.verify_batch

    def spying(*a, parts=None, **kw):
        out = real(*a, parts=parts, **kw)
        seen.append(dict(parts))
        return out

    monkeypatch.setattr(p256, "verify_batch", spying)
    p256.window_tables.clear()
    try:
        for c in [dev, bare] + peers:
            c.init()
        peers[0].sync(peers[1].to_wire_batch(peers[1].diff(peers[0].known()), "columnar"))
        batch = peers[0].to_wire_batch(peers[0].diff(dev.known()), "columnar")
        dev.sync(batch, unlocked=contextlib.nullcontext)
        bare.sync(peers[0].to_wire_batch(peers[0].diff(bare.known()), "columnar"))
        assert len(seen) == 2
        parts = seen[0]
        assert parts["tables"] == 2 and parts["signatures"] == 3
        assert parts["table_hits"] == 1  # one creator signed twice
        ph = dev.phase_ns
        assert ph["verify_window_tables"][1:] == [round(parts["tables_s"] * 1e9), 2]
        assert ph["verify_window_hits"][1:] == [0, 1]
        assert ph["verify_prelude"][1:] == [round(parts["prelude"] * 1e9), 1]
        assert ph["verify_signatures"][2] == 3
        assert ph["sync_lock_wait"][2] == 1
        assert "wire_unpack" not in ph
        # The bare Core's keys were pinned by the first sync.
        assert seen[1]["tables"] == 0 and seen[1]["table_hits"] == seen[1]["signatures"]
        sp = by_name(ring)
        sync = sp["sync"][0]
        assert sync["parent"] == 0
        kids = {s["name"]: s for ss in sp.values() for s in ss if s["parent"] == sync["id"]}
        assert set(kids) == {"sync.from_wire", "sync.verify", "sync.lock_wait",
                             "sync.insert"}
        verify = kids["sync.verify"]
        steps = [sp[n][0] for n in ("verify.prelude", "verify.launch", "verify.wait",
                                    "verify.epilogue")]
        assert all(s["parent"] == verify["id"] for s in steps)
        assert steps[0]["args"] == {"signatures": 3, "tables": 2, "table_hits": 1}
        assert verify["t0"] <= steps[0]["t0"] and steps[-1]["t1"] <= verify["t1"]
        assert all(a["t1"] == b["t0"] for a, b in zip(steps, steps[1:]))
        assert bare.trace.capacity == 0 and len(bare.trace) == 0
        assert bare.hg.engine.trace is bare.trace and dev.hg.engine.trace is ring
    finally:
        for c in (dev, bare):
            c.hg.close()


def test_collect_counts_passes_that_order_nothing():
    keys, participants = _keys(2)
    ring = SpanRing(256)
    core = Core(0, keys[0], participants, InmemStore(participants, 1000), engine="torch",
                engine_opts=SMALL_ENGINE, trace=ring)
    try:
        core.init()
        pp = core.dispatch_consensus()
        core.collect_consensus(pp)
        assert core.phase_ns["consensus_collect"][2] == 1
        assert core.phase_ns["consensus_empty"][2] == 1
        sp = by_name(ring)
        assert sp["consensus_dispatch"][0]["args"]["pass_id"] == pp.pass_id == 1
        assert sp["consensus_collect"][0]["args"]["pass_id"] == 1
    finally:
        core.hg.close()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.card
def test_a_span_encloses_its_marker_kernel_on_the_profiler_trace(card):
    from torch.profiler import ProfilerActivity, profile

    ring = SpanRing(16)
    devclock.device_mark()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        devclock.device_mark()  # the profile's first launch, slow: no anchor
        host = [devclock.device_mark()]
        for _ in range(5):
            with ring.span("mark"):
                torch.cuda._sleep(devclock.MARK_CYCLES * 50)
                torch.cuda.synchronize()
        host.append(devclock.device_mark())
    marks = devclock.profiler_marks(prof)[1:]
    assert len(marks) == 7, marks
    to_trace = devclock.trace_rebase(devclock.anchors(host, [marks[0], marks[-1]]))
    slack = []
    for sp, (s, e) in zip(ring.snapshot(), marks[1:-1]):
        t0, t1 = to_trace(sp["t0"]), to_trace(sp["t1"])
        assert t0 <= s and e <= t1, (t0, s, e, t1)
        slack.append((s - t0, t1 - e))
    # The median: a single span's slack also holds the host's wait to
    # schedule its thread around the launch or the synchronise.
    before, after = (sorted(side)[2] for side in zip(*slack))
    assert before <= 100_000 and after <= 100_000, slack


@pytest.mark.card
def test_a_verify_call_synchronises_its_stream_once(card, monkeypatch):
    syncs = []
    real = torch.cuda.Stream.synchronize
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        lambda self: (syncs.append(1), real(self))[1])
    key = fb.key_from_seed(7)
    pub = fb.pub_key_bytes(key)
    digests = [crypto.sha256(b"%d" % i) for i in range(4)]
    sigs = [fb.sign(key, d) for d in digests]
    for kw, want in ((dict(), 1), (dict(parts={}), 1),
                     (dict(parts={}, sync_parts=True), 3)):
        syncs.clear()
        assert p256.verify_batch([pub] * 4, digests, sigs, device=card, **kw) == [True] * 4
        assert len(syncs) == want, (kw, syncs)
