"""The harness: found by name from data files alone, free of JAX and of
the JAX package, and `correct` comes out false when the timed path is
broken underneath (the look for a chip skipped, on the CPU, small)."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

import compare
import control
import core_loop
import run

HERE = Path(run.__file__).resolve().parent
ROOT = HERE.parent


def tiny(cell_name, n=8, **traffic_over):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    cfg["n"] = n
    cfg["node"]["device_verify"] = False  # the plain ladder takes seconds a sync on the CPU
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    if "events" in traffic:
        traffic.update(events=1200, tail_events=300, warm_syncs=2)
        cfg["node"]["sync_limit"] = 100
    else:
        traffic.update(rate_events_per_s=100.0, warm_s=3, drain_s=8, trace_s=2,
                       scratch_events=200)
    traffic.update(traffic_over)
    return bench, cell, cfg, traffic


def run_tiny(cell_name, seconds=3.0, trace=False, **over):
    bench, cell, cfg, traffic = tiny(cell_name, **over)
    return run.run_cell(bench, cell, 2**36 + 5, seconds, trace, "cpu",
                        time.perf_counter(), cfg=cfg, traffic=traffic)


def test_a_cell_added_as_data_files_only_is_found(tmp_path):
    """A new configuration, mix and metric, written as files beside the
    harness's own and named in BENCHMARK.json, run with no code edited."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "peers64.json").read_text())
    cfg.update(name="peers9", n=9)
    cfg["node"].update(device_verify=False, sync_limit=100)
    (tmp_path / "benchmark" / "configs" / "peers9.json").write_text(json.dumps(cfg))
    tr = json.loads((HERE / "traffic" / "saturate.json").read_text())
    tr.update(events=900, tail_events=200, warm_syncs=2)
    (tmp_path / "benchmark" / "traffic" / "short_saturate.json").write_text(json.dumps(tr))
    (tmp_path / "benchmark" / "metrics" / "engine.passes.short.py").write_text(
        "def read(rec):\n    return len(rec['pass_walls_s'])\n")
    cell = {"name": "peers9.short", "config": "peers9", "traffic": "short_saturate",
            "chips": 1, "why": "test"}
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "engine.passes.short", "unit": "passes",
                               "better": "lower", "source": "program_span",
                               "layer": "engine", "moves": "ingested_events_per_s",
                               "workloads": ["peers9.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mod = run.load_module(tmp_path / "benchmark" / "run.py", "run_copy")
    out = mod.run_cell(bench, cell, 9, 2.0, True, "cpu", time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["engine.passes.short"]["value"] > 0
    assert set(out["checks"]) >= {"order_mismatch", "jobs_failed"}
    assert list(out)[-1] == "checks"


def test_no_jax_in_the_run_and_no_program_in_the_reference():
    code = f"""
import sys, time, json
sys.path[:0] = [{str(HERE)!r}, {str(ROOT)!r}, {str(HERE / 'tests')!r}]
import reference, stream, signer, compare, control, bounds
assert not any(m.split('.')[0] == 'babble_tpu_torch' for m in sys.modules), 'reference'
import test_bench_harness as t
out = t.run_tiny('peers1024.saturate', seconds=1.0)
assert out['correct'], out
import run
print(json.dumps(run.forbidden_modules()))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    assert run.FORBIDDEN == {"jax", "jaxlib", "flax", "babble_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "babble_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "babble_tpu.ops", sys)
    assert run.forbidden_modules() == ["babble_tpu"]


def unchanged(monkeypatch):
    """A consensus pass that returns the state unchanged."""
    from babble_tpu_torch.hashgraph.torch_graph import TorchHashgraph

    monkeypatch.setattr(TorchHashgraph, "collect_consensus",
                        lambda self, pending, unlocked=None: self.engine.abandon(pending))


def half_batch(monkeypatch):
    """Half of each sync batch left out of the insert."""
    from babble_tpu_torch.hashgraph.torch_graph import TorchHashgraph

    insert = TorchHashgraph.insert_wire_batch
    monkeypatch.setattr(TorchHashgraph, "insert_wire_batch",
                        lambda self, events: insert(self, events[:len(events) // 2]))


def altered(monkeypatch):
    """One consensus timestamp altered where the engine produces it."""
    from babble_tpu_torch.ops.incremental import IncrementalEngine

    collect = IncrementalEngine.collect

    def bad(self, pp, **kw):
        delta = collect(self, pp, **kw)
        if delta.new_received:
            eid, rr, ns = delta.new_received[0]
            delta.new_received[0] = (eid, rr, ns + 1)
        return delta

    monkeypatch.setattr(IncrementalEngine, "collect", bad)


@pytest.mark.parametrize("cell,fault", [
    ("peers1024.saturate", None), ("peers1024.saturate", unchanged),
    ("peers1024.saturate", half_batch), ("peers1024.saturate", altered),
    # a gossiping node's anti-entropy pulls repair a dropped half-batch, so
    # no answer of that cell can come out wrong by it (only late)
    ("peers64.gossip", None), ("peers64.gossip", unchanged),
    ("peers64.gossip", altered)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    out = run_tiny(cell, seconds=3.0 if "saturate" in cell else 5.0)
    assert out["correct"] is (fault is None), out["checks"]


def silent16():
    """A tiny closed loop at n = 16 with 4 silent validators: the 11
    creators are exactly the supermajority, the BFT bound's edge."""
    bench, cell, cfg, traffic = tiny("peers1024.saturate", n=16)
    cfg["silent_validators"] = 4
    return bench, cell, cfg, traffic


@pytest.fixture
def cores(monkeypatch):
    """(phase_ns, span ring) of every Core the run builds, in order."""
    from babble_tpu_torch.node.core import Core

    made, init = [], Core.init

    def spy(self):
        made.append((self.phase_ns, self.trace))
        init(self)

    monkeypatch.setattr(Core, "init", spy)
    return made


def test_the_bft_edge_with_silent_validators_is_correct(cores):
    bench, cell, cfg, traffic = silent16()
    rec = {}
    out = run.run_cell(bench, cell, 2**36 + 11, 3.0, False, "cpu", time.perf_counter(),
                       cfg=cfg, traffic=traffic, record=rec)
    assert out["correct"], out["checks"]
    assert rec["ordered_in_window"] > 0
    # every phase the window's Cores counted (the first Core is the
    # warm join's), summed as [ns, calls]; no ring in an untraced run
    window = cores[1:]
    assert window and all(ring.capacity == 0 for _, ring in cores)
    want = {}
    for ph, _ in window:
        for k, (_, ns, calls) in ph.items():
            ent = want.setdefault(k, [0, 0])
            ent[0] += ns
            ent[1] += calls
    assert rec["phase_ns"] == want
    assert {"sync", "verify", "from_wire", "insert", "engine_fame_rr"} <= set(want)
    assert "program_spans" not in rec


def test_the_control_fails_at_the_bft_edge():
    _, _, cfg, traffic = silent16()
    out = control.readings(cfg, traffic, 2**36 + 11, "cpu", 3.0)
    assert sum(out[k] for k in compare.NUMBERS) > 0, out


def test_a_traced_run_carries_the_program_spans(cores):
    bench, cell, cfg, traffic = tiny("peers1024.saturate", trace_s=1.5)
    rec = {}
    out = run.run_cell(bench, cell, 2**36 + 13, 3.0, True, "cpu", time.perf_counter(),
                       cfg=cfg, traffic=traffic, record=rec)
    assert out["correct"], out["checks"]
    assert cores[0][1].capacity == 0  # the warm join
    assert all(ring.capacity == core_loop.RING for _, ring in cores[1:])
    spans = rec["program_spans"]
    assert {"engine.stage", "sync", "sync.from_wire", "engine.fame_rr"} <= set(spans)
    for name in ("engine.stage", "sync"):
        ent = spans[name]
        assert ent["count"] > 0 and 0 < ent["median_ns"] <= ent["total_ns"]
    # only spans that closed inside the traced window: fewer syncs than
    # the whole window took
    assert spans["sync"]["count"] < rec["phase_ns"]["sync"][1]
    assert rec["program_spans_dropped"] == 0
    assert out["metrics"]["engine.stage_ms.saturate"]["value"] == pytest.approx(
        spans["engine.stage"]["median_ns"] / 1e6)


def test_program_spans_keep_what_closed_in_the_window():
    from babble_tpu_torch.telemetry import SpanRing

    ring = SpanRing(8)
    for name, t0, t1 in (("a", 1_000, 2_000), ("a", 2_000, 6_000), ("a", 3_000, 12_000),
                         ("b", 500, 1_500), ("b", 9_000, 9_500)):
        ring.record(name, t0, t1)
    ring.flow("s", 1)
    got = core_loop.program_spans([ring, SpanRing(0)], 1e-6, 1e-5)
    assert got == {"a": {"count": 2, "total_ns": 5_000, "median_ns": 2_500},
                   "b": {"count": 2, "total_ns": 1_500, "median_ns": 750}}
