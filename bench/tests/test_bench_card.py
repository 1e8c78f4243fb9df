"""On the card: the program comes out correct and its control, the same path
with bfloat16 accumulation, does not, under the committed limits, at a size
a test run holds (``python3 -m pytest bench/tests -m card``). The readings
at the cells' own sizes come from ``bench/calibrate.py``."""

import time

import pytest

from bench.harness.main import run_cell

CELLS = ("gene2.stream", "ffn0.decode4", "gene2.requests")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_not_on_the_card(card, make_catalog, cell):
    # rows of ~1,240 nonzeros, so that B1's hub path serves most of them
    catalog = make_catalog(n=4096, nnz_per_row=1240, d=512, f=1368)
    for seed in (2**34 + 1, 2**34 + 2):
        result, check, _ = run_cell(catalog, cell, seed, 0.3, False, card, time.perf_counter())
        assert result["correct"], check
        result, check, _ = run_cell(catalog, cell, seed, 0.3, False, card, time.perf_counter(),
                                    control=True)
        assert not result["correct"], check
