"""The reference's unrolled Turbo verifier: it accepts the port's unrolled
proofs against their keys and rejects altered ones, and its
Pedersen-Blake2s round hash is the port's transcript's."""

import json
import os

import pytest

from plonkbench import run
from plonkbench.reference import bn254, keys, verifier
from plonkbench.reference.transcript import pedersen_blake2s


def _vector(name):
    with open(os.path.join(run.ROOT, "tests", "torch_vectors", name + ".json")) as f:
        d = json.load(f)
    comms = {k: tuple(int(x, 16) for x in v) for k, v in d["vk"].items()}
    public = [int(x, 16) if isinstance(x, str) else x for x in d["public_inputs"]]
    return bytes.fromhex(d["proof"]), d["n"], comms, public


UNROLLED = ("join_split_d3", "unrolled_turbo_drive")


@pytest.mark.parametrize("name", UNROLLED)
def test_unrolled_turbo_proofs_verify(name):
    """The card's depth-3 join-split (2^16, 14 public inputs, every Turbo
    widget) and a 32-row drive, each against its key."""
    proof, n, comms, public = _vector(name)
    flavor = verifier.for_config({"flavor": "turbo", "transcript": "pedersen_blake2s"})
    assert flavor is verifier.UNROLLED_TURBO
    assert verifier.verify(proof, flavor, n, len(public), comms, keys.DEV_TAU)
    assert verifier.public_inputs(proof, flavor, len(public)) == [v % bn254.R for v in public]
    # the linearised Turbo verifier reads the same bytes otherwise
    assert not verifier.verify(proof, verifier.TURBO, n, len(public), comms, keys.DEV_TAU)


def _swap(proof, a, b):
    """The proof with its elements at byte ranges a and b exchanged."""
    out = bytearray(proof)
    out[a[0]:a[1]], out[b[0]:b[1]] = proof[b[0]:b[1]], proof[a[0]:a[1]]
    return bytes(out)


def _evaluation(k):
    """join_split_d3's k-th opened evaluation: after 14 public inputs, W_1-4,
    Z and T_1-4."""
    start = 14 * 32 + 9 * 64 + 32 * k
    return start, start + 32


@pytest.mark.parametrize("alter", [
    "evaluation", "two_evaluations", "commitment", "public_input"])
def test_altered_unrolled_proof_is_rejected(alter):
    proof, n, comms, public = _vector("join_split_d3")
    w1, z = (14 * 32, 14 * 32 + 64), (14 * 32 + 4 * 64, 14 * 32 + 5 * 64)
    bad = {"evaluation": lambda: _flip(proof, _evaluation(17)[1] - 1),   # q_range
           "two_evaluations": lambda: _swap(proof, _evaluation(0), _evaluation(1)),
           "commitment": lambda: _swap(proof, w1, z),   # two valid points
           "public_input": lambda: _flip(proof, 12 * 32 + 31)}[alter]()
    assert bad != proof
    assert not verifier.verify(bad, verifier.UNROLLED_TURBO, n, len(public), comms,
                               keys.DEV_TAU)


def _flip(proof, where):
    bad = bytearray(proof)
    bad[where] ^= 1
    return bytes(bad)


@pytest.mark.parametrize("buf", [
    b"", bytes(8), bytes(31), bytes(31) + bytes(range(1, 42)),
    bytes(range(256)) * 3 + bytes(32)], ids=["empty", "init", "zero_chunk",
                                            "zero_chunk_then_data", "beta_round"])
def test_round_hash_is_the_ports(buf):
    """Pedersen-compress-then-Blake2s of a round's buffer, against the port's
    transcript hash; a 31-byte chunk of zeros compresses to no point."""
    from aztec_tpu_torch.transcript.transcript import _pedersen_blake2s

    assert pedersen_blake2s(buf) == _pedersen_blake2s(buf)
