"""On the card (`python -m pytest benchmark/tests -q -m card` on a CUDA
machine): the control at a cell's own size fails the comparison, and a
short run of each cell is correct. Skipped without a CUDA device."""

import json
import time

import pytest

import compare
import control
import run


def cell_files(name):
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = run.find_cell(bench, name)
    cfg = json.loads((run.HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((run.HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


@pytest.mark.card
@pytest.mark.parametrize("name", ["peers1024.saturate", "peers64.saturate", "peers64.gossip"])
def test_the_control_fails_at_the_cells_size(card, name):
    bench, _, cfg, traffic = cell_files(name)
    out = control.readings(cfg, traffic, 2**37 + 3, card, float(bench["run_seconds"]))
    assert sum(out[k] for k in compare.NUMBERS) > 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["peers1024.saturate", "peers64.saturate", "peers64.gossip"])
def test_a_short_run_is_correct(card, name):
    bench, cell, _, _ = cell_files(name)
    out = run.run_cell(bench, cell, 2**37 + 5, 10.0, False, card, time.perf_counter())
    assert out["correct"], out["checks"]
