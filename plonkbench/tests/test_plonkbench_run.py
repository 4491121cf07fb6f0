"""A whole run at a size the CPU holds: the result's shape, the control and
the fault it must catch, the refusal without a card, and that nothing of JAX
or the JAX package is loaded."""

import json
import os
import subprocess
import sys

import pytest

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
