"""The reader of the share of rows the native columnar reader built."""

import json

import pytest

import run
from test_bench_harness import HERE, ROOT

NAME = "ingest.native_rows_pct.saturate"


def reader():
    return run.load_module(HERE / "metrics" / f"{NAME}.py", "t_native_rows")


def test_the_reader():
    read = reader().read
    rec = {"phase_ns": {"from_wire_rows": [9_000, 3_000], "from_wire_native": [2_000, 3_000]}}
    assert read(rec) == pytest.approx(100.0)
    rec["phase_ns"]["from_wire_native"] = [1_000, 1_500]
    assert read(rec) == pytest.approx(50.0)
    # a library that did not load: rows counted, none built natively
    del rec["phase_ns"]["from_wire_native"]
    assert read(rec) == 0.0
    # a program without the counters reads nothing
    assert read({"phase_ns": {"sync": [1, 4]}}) is None
    assert read({}) is None


def test_declared_for_the_saturate_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    saturate = [w["name"] for w in bench["workloads"] if w["traffic"] == "saturate"]
    assert m["workloads"] == saturate
    assert (m["layer"], m["moves"], m["source"], m["unit"]) == (
        "gossip ingest", "ingested_events_per_s", "program_counter", "%")
