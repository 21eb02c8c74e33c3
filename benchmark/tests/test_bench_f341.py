"""BASELINE config 3 (`configs/peers1024f341.json`): 341 of 1,024
validators silent, so the 683 live creators are exactly the
supermajority. Scaled to n = 16 it keeps that edge and runs correct on
the CPU; there, and at f = 0 on the same seed, the engine's counters in
the run's record are the engines' own, and a traced run reads the four
engine metrics that watch the edge."""

import json
import time

import pytest

import run
from test_bench_harness import cores, tiny  # noqa: F401 - cores is a fixture

HERE = run.HERE
CELL = "peers1024f341.saturate"
COUNTS = ("passes", "fame_steps", "undecided_rounds", "frontier_rounds", "redos")
READERS = ("engine.fame_ms.saturate", "engine.fame_steps_per_pass.saturate",
           "engine.undecided_rounds_per_pass.saturate", "engine.redos_per_pass.saturate")


def edge(n):
    """Silent validators beside the node under test that leave
    f = floor((n - 1) / 3) validators silent, the most BFT survives."""
    return (n - 1) // 3 - 1


def load(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def scaled(n=16, f=None):
    """The cell at n validators, its silent validators at the edge (or f)."""
    bench, cell, cfg, traffic = tiny(CELL, n=n)
    cfg["silent_validators"] = edge(n) if f is None else f
    return bench, cell, cfg, traffic


def test_the_configuration_is_baseline_config_3():
    cfg, base = load("peers1024f341"), load("peers1024")
    n, f = cfg["n"], cfg["silent_validators"]
    assert (n, f, cfg["reduced"]) == (1024, 340, [])
    assert f == edge(n) and n - 1 - f == 2 * n // 3 + 1 == 683
    new = {"name", "source", "deployment", "guarantees", "silent_validators",
           "silent_validators_are"}
    assert {k: v for k, v in cfg.items() if k not in new} == {
        k: v for k, v in base.items() if k not in new}
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "peers1024f341")
    assert conf["file"] == "benchmark/configs/peers1024f341.json" and conf["reduced"] == []
    assert conf["source"] == cfg["source"]
    cell = run.find_cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("peers1024f341", "saturate", 1)
    saturate = [w["name"] for w in bench["workloads"] if w["traffic"] == "saturate"]
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == saturate and m["moves"] == "ingested_events_per_s"


def test_scaled_to_16_it_keeps_the_edge_and_is_correct(cores):
    bench, cell, cfg, traffic = scaled()
    assert cfg["n"] - 1 - cfg["silent_validators"] == 2 * cfg["n"] // 3 + 1 == 11
    rec = {}
    out = run.run_cell(bench, cell, 2**36 + 17, 3.0, False, "cpu", time.perf_counter(),
                       cfg=cfg, traffic=traffic, record=rec)
    assert out["correct"], out["checks"]
    assert rec["ordered_in_window"] > 0
    assert set(out["metrics"]) == {"ingested_events_per_s", "setup_s"}
    for k in COUNTS:
        assert rec["phase_ns"][f"engine_{k}"][0] == 0
    assert rec["phase_ns"]["engine_passes"][1] == len(rec["pass_walls_s"])


@pytest.fixture
def engine_state(monkeypatch):
    """What each collected pass's engine state gives, and the depth
    steps of every decide_fame call."""
    from babble_tpu_torch.ops import incremental as tinc

    seen = {k: 0 for k in COUNTS}
    collect, fame = tinc.IncrementalEngine.collect, tinc.kernels.decide_fame

    def collect_spy(self, pp, **kw):
        redo0 = self.redo_count
        out = collect(self, pp, **kw)
        if pp is not None:
            win = self._dbg_windows
            seen["passes"] += 1
            seen["undecided_rounds"] += len(self.undecided_rounds)
            seen["frontier_rounds"] += win["t_end"] - win["t0"]
            seen["redos"] += self.redo_count - redo0
        return out

    def fame_spy(*a, reads=None, **kw):
        out = fame(*a, reads=reads, **kw)
        seen["fame_steps"] += len(reads)
        return out

    monkeypatch.setattr(tinc.IncrementalEngine, "collect", collect_spy)
    monkeypatch.setattr(tinc.kernels, "decide_fame", fame_spy)
    # prewarm's scratch engine belongs to no Core: no passes of its own
    monkeypatch.setattr(tinc.IncrementalEngine, "prewarm", lambda self, **kw: False)
    return seen


@pytest.mark.parametrize("f", [4, 0], ids=["edge", "f0"])
def test_the_counters_are_the_engines_own(cores, engine_state, f):
    """Over every Core of a run (the warm join's too), each engine_*
    counter's items equal the sum of what the engines' state gave."""
    bench, cell, cfg, traffic = scaled(f=f)
    out = run.run_cell(bench, cell, 2**36 + 19, 3.0, False, "cpu", time.perf_counter(),
                       cfg=cfg, traffic=traffic)
    assert out["correct"], out["checks"]
    got = {k: sum(ph.get(f"engine_{k}", [0, 0, 0])[2] for ph, _ in cores) for k in COUNTS}
    assert got == engine_state
    assert got["passes"] > 0 and got["fame_steps"] > 0 and got["frontier_rounds"] > 0


def test_a_traced_run_reads_the_edge_metrics(cores):
    bench, cell, cfg, traffic = scaled()
    traffic["trace_s"] = 4.0
    rec = {}
    out = run.run_cell(bench, cell, 2**36 + 23, 5.0, True, "cpu", time.perf_counter(),
                       cfg=cfg, traffic=traffic, record=rec)
    assert out["correct"], out["checks"]
    assert rec["program_spans_dropped"] == 0
    fame = rec["program_spans"]["engine.fame"]
    assert fame["count"] > 0
    m = out["metrics"]
    assert set(READERS) <= set(m)
    assert m["engine.fame_ms.saturate"]["value"] == pytest.approx(fame["median_ns"] / 1e6)
    ph = rec["phase_ns"]
    for name, phase in (("fame_steps", "engine_fame_steps"),
                        ("undecided_rounds", "engine_undecided_rounds"),
                        ("redos", "engine_redos")):
        assert m[f"engine.{name}_per_pass.saturate"]["value"] == pytest.approx(
            ph[phase][1] / ph["engine_passes"][1])
    spans = [s for _, ring in cores[1:] for s in ring.snapshot() if s["name"] == "engine.fame"]
    assert spans and all({"rows", "steps", "pass_id"} <= set(s["args"]) for s in spans)
    assert all(s["args"]["rows"] >= 2 for s in spans)


def test_a_program_without_the_counters_reads_nothing():
    """The readers leave their metric out of a record made by a program
    that has neither the span nor the counters."""
    rec = {"phase_ns": {"sync": [10, 1], "engine_fame_rr": [5, 2]},
           "program_spans": {"engine.fame_rr": {"count": 1, "total_ns": 5, "median_ns": 5}}}
    for name in READERS:
        reader = run.load_module(HERE / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))
        assert reader.read(rec) is None
        assert reader.read({}) is None
