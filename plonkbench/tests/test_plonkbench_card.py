"""On the card, at each cell's own size: a short window is correct, and the
control (every request served with request 0's random source) is not.  Run
there with ``python -m pytest plonkbench/tests/test_plonkbench_card.py``."""

import json
import os

import pytest

from plonkbench import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_window_is_correct(card, cell):
    res = run.run_cell(cell, 2**40 + 98, 10.0, False, device=card)
    assert res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    res = run.run_cell(cell, 2**40 + 99, 10.0, False, device=card,
                       control="stale_blinding")
    assert res["attempted"] >= 2
    assert res["checks"]["wires_wrong"]["value"] == res["attempted"] - 1
    assert not res["correct"]
