"""The readers of the node's own counters, the idle attribution by
program span, and a traced run read through the program's spans (on
the CPU, small)."""

import json

import pytest

import program_trace
import run
from test_bench_harness import HERE, ROOT, tiny

GOSSIP = ("node.lock_wait_ms_per_s.gossip", "node.cadence_sleep_mean_ms.gossip",
          "node.empty_pass_pct.gossip")
SATURATE = ("verify.prelude_us_per_event.saturate", "verify.window_tables_per_sync.saturate",
            "engine.stage_ms.saturate")


def reader(name):
    return run.load_module(HERE / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def test_the_node_counter_readers():
    rec = {"window_s": 40.0, "phase_ns": {
        "consensus_sleep": [4_000_000_000, 10], "core_lock_wait": [80_000_000, 7],
        "consensus_collect": [1_000_000, 8], "consensus_empty": [10_000, 2]}}
    vals = [reader(n).read(rec) for n in GOSSIP]
    assert vals == pytest.approx([2.0, 400.0, 25.0])
    # a counter that never fired reads 0 in a program that has them
    del rec["phase_ns"]["core_lock_wait"], rec["phase_ns"]["consensus_empty"]
    assert [reader(n).read(rec) for n in GOSSIP] == pytest.approx([0.0, 400.0, 0.0])
    # a program without them (the sleep phase missing) reads nothing
    del rec["phase_ns"]["consensus_sleep"]
    assert [reader(n).read(rec) for n in GOSSIP] == [None] * 3
    assert [reader(n).read({"window_s": 1.0}) for n in GOSSIP] == [None] * 3


def test_the_new_metrics_are_declared():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in GOSSIP:
        m = got[name]
        assert m["workloads"] == ["peers64.gossip"] and m["moves"] == "device_bytes_per_event"
        assert m["source"] == "program_counter"


def test_the_saturate_readers():
    rec = {"phase_ns": {"verify_prelude": [4_000_000, 4], "verify_window_tables": [10, 6],
                        "verify_signatures": [9_000_000, 4_000], "sync": [1, 4]},
           "program_spans": {"engine.stage": {"count": 3, "total_ns": 9_000_000,
                                              "median_ns": 2_500_000}}}
    assert [reader(n).read(rec) for n in SATURATE] == pytest.approx([1.0, 1.5, 2.5])
    # no table built in the window reads 0 where the prelude is counted
    del rec["phase_ns"]["verify_window_tables"]
    assert reader(SATURATE[1]).read(rec) == 0.0
    # a record without the source (host verify, an untraced run) reads nothing
    bare = {"phase_ns": {"sync": [1, 4], "verify": [1, 4]}}
    assert [reader(n).read(bare) for n in SATURATE] == [None] * 3
    assert [reader(n).read({}) for n in SATURATE] == [None] * 3


def test_the_saturate_metrics_are_declared():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in SATURATE:
        m = got[name]
        assert m["workloads"] == ["peers1024.saturate", "peers64.saturate"]
        assert m["moves"] == "ingested_events_per_s"
    # every saturate metric reads in both saturate cells but the bytes an
    # event held (at n = 64 a pass's transient peak, not the engine's growth)
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "peers1024.saturate" in m.get("workloads", []):
            assert ("peers64.saturate" in m["workloads"]) is (
                m["name"] != "device_bytes_per_event"), m["name"]


def test_idle_by_program_span():
    # kernels busy [10, 20] and [30, 40] of the window [0, 50]: gaps
    # [0, 10] (mid 5), [20, 30] (mid 25), [40, 50] (mid 45)
    kernels = [("k", 10, 20), ("k", 30, 40)]
    spans = [("sync", 1, 0, 28), ("sync.verify", 1, 2, 8),
             ("engine.stage", 2, 22, 29), ("engine.coords", 2, 23, 24)]
    out = program_trace.idle_by_program_span(kernels, 0, 50, spans)
    rows = dict(out["idle_by_program_span"])
    assert rows == pytest.approx({"sync.verify": 10e-9, "engine.stage + sync": 10e-9,
                                  "none": 10e-9})
    assert out["idle_s"] == pytest.approx(30e-9) and out["no_span_s"] == pytest.approx(10e-9)
    cut = program_trace.idle_by_program_span(kernels, 0, 50, spans, top=1)
    assert [k for k, _ in cut["idle_by_program_span"]][-1] == "rest"
    assert sum(v for _, v in cut["idle_by_program_span"]) == pytest.approx(30e-9)


@pytest.mark.parametrize("cell,seconds", [("peers1024.saturate", 2.0),
                                          ("peers64.gossip", 4.0)])
def test_a_traced_run_through_the_program_spans(cell, seconds):
    bench, cell_d, cfg, traffic = tiny(cell)
    out = program_trace.trace_cell(bench, cell_d, 2**35 + 9, seconds, "cpu",
                                   cfg=cfg, traffic=traffic)
    assert out["correct"], out["checks"]
    prog = out["program"]
    assert prog["dropped"] == 0 and prog["spans"] > 0
    assert sum(v for _, v in prog["idle_by_program_span"]) == pytest.approx(prog["idle_s"])
    assert prog["engine.stages"] > 0 and prog["engine.stage_ms"] > 0
    assert out["end_to_end"]
    if "gossip" in cell:
        for name in GOSSIP + ("commit.p50_ms.gossip", "commit.p95_ms.gossip"):
            assert name in out["metrics"], name
        assert prog["consensus.sleep_ms_median"] > 0
