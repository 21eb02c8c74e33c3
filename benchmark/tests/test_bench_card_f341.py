"""On the card (`python -m pytest benchmark/tests/test_bench_card_f341.py
-q -m card` on a CUDA machine), what test_bench_card.py does for the
other cells, for peers1024f341.saturate (BASELINE config 3, 341 of 1,024
validators silent): the control at the cell's own size fails the
comparison, and a short run is correct. Skipped without a CUDA device."""

import time

import pytest

import compare
import control
import run
from test_bench_card import cell_files

CELL = "peers1024f341.saturate"


@pytest.mark.card
def test_the_control_fails_at_the_cells_size(card):
    bench, _, cfg, traffic = cell_files(CELL)
    out = control.readings(cfg, traffic, 2**37 + 7, card, float(bench["run_seconds"]))
    assert sum(out[k] for k in compare.NUMBERS) > 0


@pytest.mark.card
def test_a_short_run_is_correct(card):
    bench, cell, _, _ = cell_files(CELL)
    out = run.run_cell(bench, cell, 2**37 + 9, 10.0, False, card, time.perf_counter())
    assert out["correct"], out["checks"]
