"""A whole run at a size the CPU holds: the result's shape, the control and
the fault it must catch, the refusal without a card, and that nothing of JAX
or the JAX package is loaded; and a run whose requests each carry an input
of their own (``tiny_requests``): correct, its two controls not, a request
of another circuit shape counted."""

import importlib
import json
import os
import subprocess
import sys

import pytest

import tiny_requests
from conftest import ROOT, tiny_cell
from plonkbench import run



def test_last_line_shape():
    res = {"correct": True, "attempted": 3, "failed": 0, "peak": 123,
           "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
           "checks": {"vk_mismatch": {"value": 0, "limit": 0}},
           "busy_s": 0.5, "traced_window_s": 2.0,
           "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": [["witness", 0.2]]}}
    line = run.result_line(res, "NVIDIA H100 80GB HBM3", 1, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device",
                          "breakdown", "checks"]
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                              "count": 1, "memory_peak_bytes": 123,
                              "busy_s": 0.5, "window_s": 2.0}
    assert json.loads(json.dumps(line)) == line
    plain = run.result_line(res, "x", 1, trace=False)
    assert "breakdown" not in plain and "busy_s" not in plain["device"]


def test_no_card_no_result():
    """Without CUDA the run exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "-m", "plonkbench.run", "--workload",
                        "standard_2p20.serial", "--seed", str(2**40), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _run(seconds: float = 0.001, trace: bool = False, **kw):
    return run.run_cell("tiny", 2**33 + 7, seconds, trace, device="cpu",
                        cell_data=tiny_cell(), **kw)


def test_control_is_not_correct():
    """The control: every request served with request 0's random source, as a
    prover that reused its blinded wire commitments would.  A traced run
    serves request 0 and its traced request 1 however short the window."""
    res = _run(trace=True, control="stale_blinding")
    assert res["attempted"] == 2
    assert res["checks"]["wires_wrong"]["value"] == 1
    assert res["checks"]["proofs_rejected"]["value"] == 0
    assert not res["correct"]


def test_altered_answer_is_not_correct(monkeypatch):
    """The fault: a proof altered where it is produced."""
    from aztec_tpu_torch.plonk.prover import Prover

    original = Prover.construct_proof

    def altered(self):
        proof = bytearray(original(self))
        proof[len(proof) // 3] ^= 0x10
        return bytes(proof)
    monkeypatch.setattr(Prover, "construct_proof", altered)
    res = _run()
    assert res["checks"]["proofs_rejected"]["value"] == 1
    assert not res["correct"] and res["failed"] == 1


def test_sound_run_is_correct_and_loads_no_jax():
    """A whole tiny run in a fresh process: correct, and no module of JAX or
    of the JAX package loaded; the reference alone loads none of the port."""
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'plonkbench/tests')\n"
        "from conftest import tiny_cell\n"
        "from plonkbench.circuits import chain\n"
        "from plonkbench.reference import keys, verifier\n"
        "keys.verification_key(chain.reference({'log2_subgroup': 6}, 9), keys.DEV_TAU)\n"
        "ref_tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from plonkbench import run\n"
        "res = run.run_cell('tiny', 2**40 + 1, 0.001, False, device='cpu',"
        " cell_data=tiny_cell())\n"
        "print(json.dumps({'correct': res['correct'], 'ref': ref_tops,"
        " 'bad': run.forbidden_modules(),"
        " 'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, env=env, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["bad"] == []
    for top in ("jax", "jaxlib", "flax", "aztec_tpu"):
        assert top not in out["tops"]
    assert "aztec_tpu_torch" not in out["ref"] and "torch" not in out["ref"]
    assert "aztec_tpu_torch" in out["tops"]


REQUEST_METRICS = ["request_circuit_ms", "request_key_ms", "witness_ms"]


@pytest.fixture
def requests_cell(monkeypatch):
    """The tiny per-request circuit, found by its name as a configuration's
    circuit module is."""
    monkeypatch.setitem(sys.modules, "plonkbench.circuits.tiny_requests", tiny_requests)

    def cell(**config):
        cell, conf, mix, end_to_end, _ = tiny_cell(dict(tiny_requests.CONFIG, **config))
        return cell, conf, mix, end_to_end, list(REQUEST_METRICS)
    return cell


def _run_requests(cell_data, trace=True, **kw):
    """Requests 0 and 1 (a traced run serves its traced request 1 however
    short the window)."""
    return run.run_cell("tiny", 2**33 + 11, 0.001, trace, device="cpu",
                        cell_data=cell_data, **kw)


def test_per_request_inputs_give_a_correct_run(requests_cell):
    res = _run_requests(requests_cell())
    assert res["attempted"] == 2
    assert res["correct"], res["checks"]
    assert {k: c["value"] for k, c in res["checks"].items()} == {
        "vk_mismatch": 0, "requests_raised": 0, "proofs_rejected": 0,
        "public_inputs_wrong": 0, "wires_wrong": 0, "circuit_differs": 0,
        "tx_repeated": 0}
    assert res["drawn_s"] > 0
    assert set(res["metrics"]) == set(REQUEST_METRICS)


@pytest.mark.parametrize("control,count", [("stale_tx", "public_inputs_wrong"),
                                           ("stale_blinding", "wires_wrong")])
def test_per_request_controls_are_not_correct(requests_cell, control, count):
    """stale_tx serves request 0's input in every request, as a cache of the
    witness across requests would; stale_blinding request 0's random source."""
    res = _run_requests(requests_cell(), control=control)
    assert res["attempted"] == 2
    assert res["checks"][count]["value"] == 1
    assert res["checks"]["proofs_rejected"]["value"] == 0
    assert not res["correct"]


def test_request_of_another_shape_is_counted(requests_cell):
    res = _run_requests(requests_cell(shape_changes_at=0), trace=False)
    assert res["attempted"] == 1
    assert res["checks"]["circuit_differs"]["value"] == 1
    assert not res["correct"]


def test_altered_answer_with_inputs_is_not_correct(requests_cell, monkeypatch):
    """The fault on the path of a request's own circuit: a proof altered
    where it is produced."""
    from aztec_tpu_torch.plonk.prover import Prover

    original = Prover.construct_proof

    def altered(self):
        proof = bytearray(original(self))
        proof[len(proof) // 2] ^= 0x10
        return bytes(proof)
    monkeypatch.setattr(Prover, "construct_proof", altered)
    res = _run_requests(requests_cell(), trace=False)
    assert res["checks"]["proofs_rejected"]["value"] == res["attempted"] == 1
    assert not res["correct"] and res["failed"] == 1


def test_stale_tx_needs_inputs_of_their_own():
    with pytest.raises(ValueError):
        _run(control="stale_tx")


@pytest.mark.parametrize("module", ["chain", "escape_hatch"])
def test_existing_circuits_prove_the_setup_circuit_again(module):
    mod = importlib.import_module(f"plonkbench.circuits.{module}")
    assert not hasattr(mod, "draw") and not hasattr(mod, "build_request")


def test_window_without_inputs_leaves_nothing_out():
    """Where requests carry no input, the window is the loop's whole time:
    nothing drawn, nothing subtracted."""
    res = _run()
    assert res["drawn_s"] == 0.0
    assert res["window_s"] >= sum(res["latencies"])
    assert "circuit_differs" not in res["checks"]
