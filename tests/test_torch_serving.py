"""The port's serving layer (aztec_tpu_torch.serving: the proof worker's
frame protocol) and plonk/sol_gen.py (a VK as a Solidity library), on the
CPU.

``serve(stdin, stdout, device="cpu")`` runs in process over byte buffers:
the ready byte, the Standard and Turbo demo proofs (ids 0x100 and 0x101 at
4 gates), each verified by the port's verifier and by aztec_tpu's; a
tx-rollup frame (id 0) and a root-rollup frame (id 1) whose bodies do not
parse, each answered with the empty failed frame while the next request is
still served; 0x202 before any tx-rollup proof answered failed; an unknown
id answered failed, after which ``serve`` returns.  The rollup circuits
themselves (2^24 gates) are proved on the card: chip_smoke.py phase 5d.  The VK queries 0x200 and 0x201 prove the join-split
and account circuits at 2^16-2^17 gates: the ``cuda``-marked case and
chip_smoke.py run them on the card.
"""

import io
import os
import re
import struct
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The CPU proofs' tensors are small: one thread a worker process
    keeps the test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def _frames(stdout: bytes):
    """The ready byte, then (payload, ok) per answered request."""
    assert stdout[:1] == b"\x01"
    out, pos = [], 1
    while pos < len(stdout):
        n = struct.unpack(">I", stdout[pos:pos + 4])[0]
        out.append((stdout[pos + 4:pos + 4 + n], stdout[pos + 4 + n]))
        pos += 5 + n
    return out


@pytest.fixture(scope="module")
def served():
    """The worker's frames, its log, and the demo composers it built (by
    kind; their VKs are the ones its own verifier used)."""
    from aztec_tpu_torch.serving import proof_worker

    built, build = {}, proof_worker._build_demo_circuit

    def recording(kind, num_gates, device):
        built[kind] = build(kind, num_gates, device)
        return built[kind]

    stdin = (struct.pack(">II", 0x100, 4)
             + struct.pack(">III", 0, 2, 3) + b"abc"     # num_txs, the tx
             + struct.pack(">IIII", 1, 1, 1, 2) + b"{}"  # ids, the VK
             + struct.pack(">I", 3) + b"xyz"             # the root tx
             + struct.pack(">II", 0x101, 4)
             + struct.pack(">I", 0x202)
             + struct.pack(">I", 0x999)
             + struct.pack(">II", 0x100, 4))      # never read
    stdout, log = io.BytesIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(proof_worker, "_build_demo_circuit", recording)
        proof_worker.serve(io.BytesIO(stdin), stdout, log, device="cpu")
    return _frames(stdout.getvalue()), log.getvalue(), built


def test_worker_frames(served):
    frames, log, _ = served
    # ok is the port's verifier's verdict on the worker's own proof
    assert [ok for _, ok in frames] == [1, 0, 0, 1, 0, 0]
    assert [len(p) > 0 for p, _ in frames] == [True, False, False, True,
                                               False, False]
    assert "proof_id 0 error: error(" in log           # struct.error
    assert "proof_id 1 error: KeyError" in log
    assert "unknown proof_id 2457" in log


@pytest.mark.parametrize("kind,at,flavor", [("standard", 0, "standard_drive1"),
                                            ("turbo", 3, "turbo_drive")])
def test_worker_demo_proofs_verify(served, kind, at, flavor):
    frames, _, built = served
    proof = frames[at][0]
    # the worker's ok byte (test_worker_frames) is its own port verifier's
    ref = plonk_cases.reference_verifier(
        built[kind].compute_verification_key(), flavor)
    assert ref.verify_proof(proof)
    assert not ref.verify_proof(plonk_cases.tampered(proof))


def test_worker_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from aztec_tpu_torch.serving import proof_worker

    stdout = io.BytesIO()
    with pytest.raises(RuntimeError, match="CUDA"):
        proof_worker.serve(io.BytesIO(b""), stdout, io.StringIO())
    assert stdout.getvalue() == b""         # no ready byte


def test_sol_gen_shape(served):
    """tests/test_serving.py's shape check on the port's sol_gen, with the
    VK of the worker's Turbo demo circuit: the reference's exact line
    layout (sol_gen.hpp:8-76)."""
    from aztec_tpu_torch.plonk.sol_gen import output_vk_sol

    sol = output_vk_sol(served[2]["turbo"].compute_verification_key(),
                        "DemoVk")
    assert "library DemoVk {" in sol
    assert sol.count("mstore(") == 2 + 3 + 15 * 2 + 2 + 4
    for label in ("vk.Q1", "vk.QARITH", "vk.SIGMA4", "vk.g2_x.Y.c0",
                  "vk.circuit_size", "vk.contains_recursive_proof"):
        assert label in sol, label
    for m in re.finditer(r"0x[0-9a-f]{10,}", sol):
        assert len(m.group(0)) == 66


@pytest.mark.cuda
def test_worker_join_split_vk_on_card(tmp_path, monkeypatch):
    """The worker as a process on the card: 0x200 answers the join-split
    VK (2^17 gates, unrolled Turbo) that its padding proof verifies
    against."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from aztec_tpu_torch.plonk.flavors import UnrolledTurboFlavor
    from aztec_tpu_torch.plonk.verifier import Verifier
    from aztec_tpu_torch.rollup import circuit_data
    from aztec_tpu_torch.utils import fixtures

    monkeypatch.setenv("AZTEC_FIXTURES", str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-u", "-m", "aztec_tpu_torch.serving.proof_worker"],
        input=struct.pack(">I", 0x200), capture_output=True, cwd=ROOT,
        timeout=600, check=True)
    (payload, ok), = _frames(out.stdout)
    assert ok == 1
    vk = fixtures.vk_from_json(payload.decode())
    assert vk.n == 1 << 17 and vk.settings.name == "unrolled_turbo"
    cd = circuit_data.join_split_circuit_data()     # the one it stored
    assert Verifier(vk, UnrolledTurboFlavor).verify_proof(cd.padding_proof)
