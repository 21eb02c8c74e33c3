"""The port's incremental consensus engine
(babble_tpu_torch/ops/incremental.py IncrementalEngine) against the JAX
package's IncrementalEngine and against the port's one-shot pipeline, on
the CPU. Tolerance: exact equality of every RunDelta, host mirror
(rounds, witness flags, round received, consensus timestamps, fame),
witness table and redo count.

Mirrors tests/test_incremental.py (batched run() against the one-shot
pipeline, the unlocked interleave, retry after a failure, vectorized
append) and tests/test_async_pipeline.py (pipelined dispatch/collect
and its contract), and adds frame-reset engines, forced redos and the
packed buffer of every pass word for word. The pure functions of the
module are held against the JAX package's in
tests/test_torch_incremental_parts.py."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from babble_tpu.ops import incremental as jinc
from babble_tpu.ops.dag import synthetic_dag
from babble_tpu_torch.ops import incremental as tinc
from babble_tpu_torch.ops.pipeline import run_pipeline

from test_torch_kernels import carry

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

SMALL = dict(capacity=64, block=64, k_capacity=8)
MIRRORS = ("rounds", "witness", "rr", "cts_ns", "famous")


def engines(n, **kw):
    """(JAX engine, port engine on the CPU) built alike."""
    kw = {**SMALL, **kw}
    return jinc.IncrementalEngine(n, **kw), tinc.IncrementalEngine(n, device="cpu", **kw)


def feed(g, dag, k, hi, ts=None, index_base=None):
    idx = dag.index[k:hi]
    if index_base is not None:
        idx = idx + index_base[dag.creator[k:hi]]
    return g.append_batch(
        dag.self_parent[k:hi], dag.other_parent[k:hi], dag.creator[k:hi],
        idx, dag.coin[k:hi], np.arange(k, hi) if ts is None else ts[k:hi])


def delta(d):
    return dataclasses.asdict(d)


def assert_same_state(t, j):
    for name in MIRRORS:
        assert np.array_equal(getattr(t, name), getattr(j, name)), name
    assert np.array_equal(t.witness_table(), j.witness_table())
    assert t.undecided_rounds == j.undecided_rounds
    assert t.last_consensus_round == j.last_consensus_round
    assert t.redo_count == j.redo_count


def assert_matches_one_shot(eng, dag):
    """The engine's mirrors equal the port's one-shot pipeline (the JAX
    test_engine_matches_full_pipeline's checks)."""
    e = dag.e
    rounds, wit, wt, famous, rr, cts = (
        x.numpy() for x in run_pipeline(carry(dag), engine="wavefront", device="cpu"))
    assert (eng.rounds[:e] == rounds).all()
    assert (eng.witness[:e] == wit).all()
    assert (eng.rr[:e] == rr).all()
    wt_abs = eng.witness_table()
    rt = wt_abs.shape[0]
    assert (wt_abs == wt[:rt]).all()
    assert (wt[rt:] == -1).all()
    assert (eng.famous == famous[:rt]).all()
    dec = rr >= 0
    # pipeline cts are ranks into dag.ts_values == arange(e); -1 = zero time
    cts_ns = np.where(cts < 0, tinc.CTS_SENTINEL, cts.astype(np.int64))
    assert (eng.cts_ns[:e][dec] == cts_ns[dec]).all()


@pytest.mark.parametrize("n,e,bs", [(8, 300, 37), (5, 97, 10)], ids=["n8", "n5"])
def test_engine_matches_jax_and_one_shot(n, e, bs):
    """Batched ingest with run() between batches, across capacity
    doubling and chain-bucket growth: RunDelta for RunDelta equal to the
    JAX engine, and the final state equal to both the JAX engine and
    the one-shot pipeline."""
    dag, _ = synthetic_dag(n, e, seed=3)
    j, t = engines(n)
    for k in range(0, e, bs):
        hi = min(k + bs, e)
        feed(j, dag, k, hi)
        feed(t, dag, k, hi)
        assert delta(t.run()) == delta(j.run()), k
    assert_same_state(t, j)
    assert_matches_one_shot(t, dag)


@pytest.mark.parametrize("seed", [3, 6])
def test_run_deltas_across_batch_sizes(seed):
    """Batches cycling through sizes 1, 3, 17, 64 and 127 (the single
    event takes append(), the rest append_batch): every RunDelta equal
    to the JAX engine's, and the packed buffer of every pass equal word
    for word (the lanes past each window's live part included)."""
    n, e = 8, 400
    dag, _ = synthetic_dag(n, e, seed=seed)
    j, t = engines(n)
    sizes = (1, 3, 17, 64, 127)
    k = 0
    step = 0
    while k < e:
        hi = min(e, k + sizes[step % len(sizes)])
        feed(j, dag, k, hi)
        feed(t, dag, k, hi)
        pj, pt = j.dispatch(), t.dispatch()
        pj.ready.wait()
        pt.ready.wait()
        assert pj.error is None and pt.error is None
        assert np.array_equal(pt.packed_host.numpy(), np.asarray(pj.packed_dev)), k
        assert delta(t.collect(pt)) == delta(j.collect(pj)), k
        k = hi
        step += 1
    assert_same_state(t, j)
    assert_matches_one_shot(t, dag)


def _small_rcap_floor(orig):
    """A _pow2 whose 2048 floor (the rcap floor at small n) is 8, so a
    pass sweeping 100 rounds overflows the frontier table."""
    def pow2(x, floor=8):
        return orig(x, 8 if floor == 2048 else floor)
    return pow2


def test_redo_on_frontier_overflow(monkeypatch):
    """t_end == rcap: the frontier table overflows and the pass is
    redone at double rcap until it fits — the same redos, deltas and
    state as the JAX engine under the same window floor."""
    monkeypatch.setattr(jinc, "_pow2", _small_rcap_floor(jinc._pow2))
    monkeypatch.setattr(tinc, "_pow2", _small_rcap_floor(tinc._pow2))
    n, e = 4, 600
    dag, _ = synthetic_dag(n, e, seed=3)
    j, t = engines(n)
    for k, hi in ((0, 500), (500, e)):
        feed(j, dag, k, hi)
        feed(t, dag, k, hi)
        assert delta(t.run()) == delta(j.run())
    assert t.redo_count >= 3  # rcap 8 -> 16 -> 32 -> 64 at least
    assert t._dbg_windows["rcap"] > 8
    assert_same_state(t, j)
    assert_matches_one_shot(t, dag)


def test_redo_on_timestamp_bucket_overflow():
    """newly_count > cb: one pass receives more events than the
    consensus-timestamp bucket holds (cb = 1024) and is redone with a
    bigger bucket — the same redos, deltas and state as the JAX engine."""
    n, e = 4, 1500
    dag, _ = synthetic_dag(n, e, seed=3)
    j, t = engines(n)
    feed(j, dag, 0, e)
    feed(t, dag, 0, e)
    assert delta(t.run()) == delta(j.run())
    assert int((t.rr[:e] >= 0).sum()) > 1024
    assert t._dbg_windows["cb"] > 1024
    assert t.redo_count >= 1
    assert_same_state(t, j)
    assert_matches_one_shot(t, dag)


def test_pipelined_engine_matches_one_shot():
    """Batch k+1 appended while pass k is in flight, with capacity and
    chain-bucket regrowth crossing dispatch boundaries (mirror of
    test_async_pipeline.py): every delta equal to the JAX engine driven
    the same way, the final state equal to the one-shot pipeline."""
    n, e, bs = 8, 420, 48
    dag, _ = synthetic_dag(n, e, seed=11)
    j, t = engines(n)
    pend = (None, None)
    for k in range(0, e, bs):
        hi = min(k + bs, e)
        feed(j, dag, k, hi)
        feed(t, dag, k, hi)
        if pend[0] is not None:
            assert delta(t.collect(pend[1])) == delta(j.collect(pend[0]))
        pend = (j.dispatch(), t.dispatch())
    assert delta(t.collect(pend[1])) == delta(j.collect(pend[0]))
    while True:
        pj, pt = j.dispatch(), t.dispatch()
        assert (pj is None) == (pt is None)
        if pt is None:
            break
        assert delta(t.collect(pt)) == delta(j.collect(pj))
    assert_same_state(t, j)
    assert_matches_one_shot(t, dag)
    t.close()


def test_dispatch_collect_contract():
    """Double dispatch raises, collect of a stale pass raises, abandon
    restores the staged batch, and the restored batch reruns cleanly."""
    n = 4
    dag, _ = synthetic_dag(n, 64, seed=2)
    eng = tinc.IncrementalEngine(n, device="cpu", **SMALL)
    feed(eng, dag, 0, 32)
    pp = eng.dispatch()
    assert pp is not None and eng.inflight
    with pytest.raises(RuntimeError):
        eng.dispatch()
    eng.abandon(pp)
    assert not eng.inflight
    assert eng.backlog() == 32
    with pytest.raises(RuntimeError):
        eng.collect(pp)
    d = eng.run()
    assert len(d.new_rounds) == 32
    assert eng.run().new_rounds == []  # fixpoint: nothing to do
    eng.close()


def test_run_unlocked_appends_interleave():
    """Appends landing MID-collect (where a live node releases its
    lock) neither corrupt the dispatched pass nor get lost: the final
    state equals a serial engine fed the same stream, and the one-shot
    pipeline."""
    n, e, bs = 8, 400, 57
    dag, _ = synthetic_dag(n, e, seed=9)
    batches = [(k, min(k + bs, e)) for k in range(0, e, bs)]
    ref = tinc.IncrementalEngine(n, device="cpu", **SMALL)
    for k, hi in batches:
        feed(ref, dag, k, hi)
        ref.run()

    eng = tinc.IncrementalEngine(n, device="cpu", **SMALL)
    state = {"next": 1}

    @contextlib.contextmanager
    def interleave():
        if state["next"] < len(batches):
            k, hi = batches[state["next"]]
            state["next"] += 1
            feed(eng, dag, k, hi)
        yield

    feed(eng, dag, *batches[0])
    for _ in range(3 * len(batches)):
        eng.run(unlocked=interleave)
        if state["next"] >= len(batches):
            break
    eng.run()
    for name in MIRRORS:
        assert np.array_equal(getattr(eng, name)[:e] if name != "famous"
                              else eng.famous,
                              getattr(ref, name)[:e] if name != "famous"
                              else ref.famous), name
    assert eng.undecided_rounds == ref.undecided_rounds
    assert_matches_one_shot(eng, dag)


def test_run_retries_after_transient_failure():
    """A pass that dies in collect leaves its batch staged and the
    result carries uncommitted: the retry gives the same results as an
    engine that never failed."""
    n, e = 8, 200
    dag, _ = synthetic_dag(n, e, seed=4)
    ref = tinc.IncrementalEngine(n, device="cpu", **SMALL)
    feed(ref, dag, 0, 120)
    ref.run()
    feed(ref, dag, 120, e)
    ref.run()

    eng = tinc.IncrementalEngine(n, device="cpu", **SMALL)
    feed(eng, dag, 0, 120)

    @contextlib.contextmanager
    def tunnel_drop():
        raise RuntimeError("tunnel dropped")
        yield  # pragma: no cover

    rounds_d = eng._rounds_d
    with pytest.raises(RuntimeError):
        eng.run(unlocked=tunnel_drop)
    assert eng._rounds_d is rounds_d and eng.backlog() == 120
    eng.run()
    feed(eng, dag, 120, e)
    eng.run()
    for name in MIRRORS:
        assert np.array_equal(getattr(eng, name), getattr(ref, name)), name
    assert eng.undecided_rounds == ref.undecided_rounds


def test_append_batch_vectorized_matches_serial():
    """append_batch leaves the engine identical to per-event appends,
    across capacity doubling and chain-bucket growth, and rejects an
    invalid batch with nothing appended."""
    dag, _ = synthetic_dag(8, 400, seed=3)
    ts = np.arange(400, dtype=np.int64) * 7 + 100
    serial = tinc.IncrementalEngine(8, device="cpu", **SMALL)
    batched = tinc.IncrementalEngine(8, device="cpu", **SMALL)
    for k in range(400):
        serial.append(int(dag.self_parent[k]), int(dag.other_parent[k]),
                      int(dag.creator[k]), int(dag.index[k]),
                      bool(dag.coin[k]), int(ts[k]))
    lo = 0
    for size in (1, 3, 17, 64, 5, 127, 400):
        hi = min(400, lo + size)
        assert feed(batched, dag, lo, hi, ts=ts) == lo
        lo = hi
    for name in ("self_parent", "other_parent", "creator", "index",
                 "coin", "root_base", "ts_ns", "chain", "chain_len",
                 "rounds", "witness", "rr", "cts_ns"):
        assert np.array_equal(getattr(serial, name), getattr(batched, name)), name
    assert serial.e == batched.e
    assert serial._new_since_run == batched._new_since_run

    e_before = batched.e
    with pytest.raises(ValueError):
        batched.append_batch(
            np.array([-1, 5]), np.array([-1, -1]), np.array([0, 0]),
            np.array([999, 1000]), np.array([0, 0]), np.array([1, 2]))
    with pytest.raises(ValueError):  # contiguous, but not the head
        batched.append_batch(
            np.array([3, 3]), np.array([-1, -1]), np.array([0, 0]),
            batched.chain_len[0] + np.array([0, 1]), np.array([0, 0]),
            np.array([1, 2]))
    assert batched.e == e_before and batched.backlog() == 400

    assert delta(serial.run()) == delta(batched.run())
    assert np.array_equal(serial.rr[:400], batched.rr[:400])


def test_frame_reset_engine_matches_jax():
    """A frame-reset engine (non-base root rounds, offset chain bases,
    an empty undecided queue) fed a replayed stream in batches: every
    RunDelta and the final state equal the JAX engine's."""
    n, e, bs = 6, 240, 50
    dag, _ = synthetic_dag(n, e, seed=5)
    root_round = np.array([3, 4, 3, 5, 4, 3], np.int32)
    index_base = np.array([4, 0, 7, 2, 9, 1], np.int32)
    kw = dict(root_round=root_round, index_base=index_base, from_reset=True)
    j, t = engines(n, **kw)
    assert t.rho_min == 4 and t.undecided_rounds == []
    for k in range(0, e, bs):
        hi = min(k + bs, e)
        feed(j, dag, k, hi, index_base=index_base)
        feed(t, dag, k, hi, index_base=index_base)
        assert delta(t.run()) == delta(j.run()), k
    assert_same_state(t, j)
    assert min(t.undecided_rounds + [t.last_consensus_round]) >= 4


def test_one_pass_reaches_the_gathered_kernel(monkeypatch):
    """One pass reaches hopper_kernels.strongly_see_gathered from the
    frontier probe (sees_sm), the skip correction (step) and fame
    (decide_fame), and nowhere else."""
    import sys

    from babble_tpu_torch.ops import hopper_kernels

    real = hopper_kernels.strongly_see_gathered
    calls = {}

    def spy(*args):
        name = sys._getframe(1).f_code.co_name
        calls[(name, args[-1])] = calls.get((name, args[-1]), 0) + 1
        return real(*args)

    monkeypatch.setattr(hopper_kernels, "strongly_see_gathered", spy)
    dag, _ = synthetic_dag(8, 200, seed=3)
    eng = tinc.IncrementalEngine(8, device="cpu", **SMALL)
    feed(eng, dag, 0, 200)
    eng.run()
    assert set(calls) == {("sees_sm", "tally"), ("step", "tally"),
                          ("decide_fame", "matrix")}
    rounds = eng._dbg_windows["t_end"] - eng._dbg_windows["t0"]
    probes = calls[("sees_sm", "tally")]
    assert calls[("step", "tally")] == rounds and probes % rounds == 0
    assert eng.host_syncs == rounds + eng._dbg_windows["fame_reads"] + 1


def test_memory_stats_prewarm_and_left_out_parts():
    """device_memory_stats counts the resident tensors and host mirrors;
    prewarm runs a scratch engine; a mesh the participants do not
    divide over raises, as the JAX engine's does, and a one-device mesh
    is the unsharded engine; the default device is CUDA, which raises
    where there is none."""
    eng = tinc.IncrementalEngine(4, device="cpu", **SMALL)
    stats = eng.device_memory_stats()
    assert stats["device_bytes"] >= eng._chain_la.numel() * 4
    assert stats["host_mirror_bytes"] > 0 and stats["n"] == 4
    assert "mesh_shards" not in stats
    assert eng.prewarm() is True
    assert eng.prewarm(budget_bytes=1) is False
    with pytest.raises(ValueError, match="divide"):
        tinc.IncrementalEngine(4, mesh=["cpu"] * 3, device="cpu")
    one = tinc.IncrementalEngine(4, mesh=["cpu"], **SMALL)
    assert one._mesh is None and isinstance(one._la, torch.Tensor)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tinc.IncrementalEngine(4)


def test_cost_report_matches_jax_shapes():
    """request_cost_report() arms one capture: the next pass records the
    fused epilogue's cost, with the JAX engine's key set, the same
    shapes as the JAX engine's report for the same pass, and the output
    bytes XLA reports for the same three outputs less its output tuple
    (one 8-byte pointer per output). A redo does not re-arm it."""
    n = 8
    dag, _ = synthetic_dag(n, 200, seed=3)
    j, t = engines(n)
    feed(j, dag, 0, 100)
    feed(t, dag, 0, 100)
    assert delta(t.run()) == delta(j.run())
    assert t.cost_report is None
    j.request_cost_report()
    t.request_cost_report()
    assert t.cost_report is None and t._cost_requested
    feed(j, dag, 100, 150)
    feed(t, dag, 100, 150)
    assert delta(t.run()) == delta(j.run())
    jr, tr = j.cost_report, t.cost_report
    assert set(tr) == set(jr) == {"consensus_fused", "shapes"}
    assert set(tr["consensus_fused"]) == set(jr["consensus_fused"]) == {
        "flops", "bytes_accessed", "output_bytes", "temp_bytes"}
    assert tr["shapes"] == jr["shapes"]
    assert tr["consensus_fused"]["output_bytes"] == jr["consensus_fused"]["output_bytes"] - 3 * 8
    for key in ("flops", "bytes_accessed", "temp_bytes"):
        assert tr["consensus_fused"][key] > 0, key
    assert tr["consensus_fused"]["bytes_accessed"] > tr["consensus_fused"]["output_bytes"]
    # One-shot: the next pass leaves the report as it was.
    feed(t, dag, 150, 200)
    t.run()
    assert t.cost_report is tr and not t._cost_requested
    t.close()
    j.close()


def test_cost_report_never_raises():
    assert tinc._analyze_cost((), {}, ()) == {"error": "'n'"}


def test_torch_calls_per_pass_at_node_width(capsys):
    """A pass's torch calls, each a release and re-take of the
    interpreter lock (ROADMAP C1), at a live node's width and presize:
    n = 4, capacity and k_capacity 65,536, 200-event batches. The
    frontier's wide probe, fame by depth over the live rows and the
    chunked round-received sweep keep a pass under 4,000 calls on the
    CPU (whose B1 plain version adds its own); the bisection and the
    sweeps over whole windows took 13,565-17,367."""
    from torch.overrides import TorchFunctionMode

    class Calls(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") != "__get__":  # not an attribute read
                self.n += 1
            return func(*args, **(kwargs or {}))

    dag, _ = synthetic_dag(4, 2400, seed=7)
    eng = tinc.IncrementalEngine(4, device="cpu", capacity=65536, block=512,
                                 k_capacity=65536)
    stage, calls = eng._stage_pass, []

    def counted(pp):  # the mode is per thread: count on the staging worker
        with Calls() as c:
            stage(pp)
        calls.append(c.n)

    eng._stage_pass = counted
    try:
        for k in range(0, 2400, 200):
            feed(eng, dag, k, k + 200)
            eng.run()
    finally:
        eng.close()
    with capsys.disabled():
        print(f"\ntorch calls per pass (n = 4, node presize, CPU): {calls}")
    assert len(calls) == 12 and max(calls) < 4000
    assert eng.last_consensus_round >= 150
