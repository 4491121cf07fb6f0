"""Every name in BENCHMARK.json finds its file: configurations, traffic
mixes, circuit builders and per-layer metric readers."""

import importlib
import json
import os

import pytest

from plonkbench import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell, config, mix, end_to_end, per_layer = run.load_cell(name)
    assert cell["name"] == name
    assert importlib.import_module(f"plonkbench.circuits.{config['circuit']}").build
    assert mix["loop"] == "closed"
    assert "setup_s" in end_to_end and len(end_to_end) >= 2
    assert per_layer
    for m in per_layer:
        assert callable(run.metric_reader(m))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_in_an_empty_run(metric):
    empty = {"setup": {}, "traced": [], "trace": None, "subgroup": 1 << 10, "width": 3}
    assert run.metric_reader(metric)(empty) is None


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell("no_such_cell")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_source_and_cuts(entry):
    with open(os.path.join(run.ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert config["assumed"]
