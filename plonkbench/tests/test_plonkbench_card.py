"""On the card, at each cell's own size: a short window is correct, and the
controls are not: every request served with request 0's random source, and,
where requests carry inputs of their own, with request 0's input.  Run
there with ``python -m pytest plonkbench/tests/test_plonkbench_card.py``."""

import importlib
import json
import os

import pytest

from plonkbench import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
DRAWN = [c for c in CELLS if hasattr(importlib.import_module(
    f"plonkbench.circuits.{run.load_cell(c)[1]['circuit']}"), "draw")]


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


@pytest.mark.cuda
@pytest.mark.parametrize("cell", DRAWN)
def test_stale_tx_control_is_not_correct(card, cell):
    """Request 0's tx in every request, as a witness cached across requests
    would serve: each later proof carries request 0's public inputs."""
    res = run.run_cell(cell, 2**40 + 97, 10.0, False, device=card, control="stale_tx")
    counts = {k: c["value"] for k, c in res["checks"].items()}
    assert res["attempted"] >= 2
    assert counts["public_inputs_wrong"] + counts["wires_wrong"] >= res["attempted"] - 1
    assert not res["correct"]
