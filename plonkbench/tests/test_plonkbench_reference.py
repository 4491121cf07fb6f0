"""The plain reference: it accepts the port's proofs and rejects tampered
ones, and works out the port's verification key from the gates alone."""

import json
import os

import pytest

from plonkbench import run, seeds
from plonkbench.circuits import chain
from plonkbench.reference import bn254, keys, verifier
from plonkbench.reference.keccak import keccak256
from plonkbench.reference.transcript import Transcript

VECTOR = os.path.join(run.ROOT, "tests", "torch_vectors", "escape_hatch_prod.json")


def test_keccak_is_ethereums():
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


@pytest.fixture(scope="module")
def escape_hatch_card_proof():
    """The port's Keccak Turbo proof of the escape hatch at the production
    depths (2^19), made on the card, with its key."""
    with open(VECTOR) as f:
        d = json.load(f)
    comms = {k: tuple(int(x, 16) for x in v) for k, v in d["vk"].items()}
    return bytes.fromhex(d["proof"]), d["n"], comms, [int(x, 16) if isinstance(x, str)
                                                       else x for x in d["public_inputs"]]


def test_turbo_proof_of_the_card_verifies(escape_hatch_card_proof):
    proof, n, comms, public = escape_hatch_card_proof
    assert verifier.verify(proof, verifier.TURBO, n, 26, comms, keys.DEV_TAU)
    assert verifier.public_inputs(proof, verifier.TURBO, 26) == public


@pytest.mark.parametrize("where", [0, 64 * 4 + 5, 26 * 32 + 300, -40, -1])
def test_tampered_turbo_proof_is_rejected(escape_hatch_card_proof, where):
    proof, n, comms, _ = escape_hatch_card_proof
    bad = bytearray(proof)
    bad[where] ^= 1
    assert not verifier.verify(bytes(bad), verifier.TURBO, n, 26, comms, keys.DEV_TAU)


def test_wrong_key_or_size_is_rejected(escape_hatch_card_proof):
    proof, n, comms, _ = escape_hatch_card_proof
    other = dict(comms, Q_M=bn254.mul(2, comms["Q_M"]))
    assert not verifier.verify(proof, verifier.TURBO, n, 26, other, keys.DEV_TAU)
    assert not verifier.verify(proof, verifier.TURBO, n // 2, 26, comms, keys.DEV_TAU)
    assert not verifier.verify(proof[:-1], verifier.TURBO, n, 26, comms, keys.DEV_TAU)


@pytest.fixture(scope="module")
def chain_proof():
    """A 2^8-row chain built and proved by the port on the CPU."""
    config = {"log2_subgroup": 8}
    c = chain.build(config, 2**45 + 3, "cpu")
    vk = c.compute_verification_key()
    p = c.create_prover()
    p.rng = seeds.blinding(2**45 + 3, 5)
    return config, c, vk, p.construct_proof()


def test_reference_key_equals_the_ports(chain_proof):
    config, composer, vk, _ = chain_proof
    comms, n, _ = keys.verification_key(chain.reference(config, 2**45 + 3), keys.DEV_TAU)
    assert n == vk.n == 256
    assert comms == {k: vk.commitments[k] for k in comms}


def test_standard_proof_verifies_with_its_wires(chain_proof):
    config, _, _, proof = chain_proof
    ref = chain.reference(config, 2**45 + 3)
    comms, n, lagrange = keys.verification_key(ref, keys.DEV_TAU)
    assert verifier.verify(proof, verifier.STANDARD, n, 1, comms, keys.DEV_TAU)
    assert verifier.public_inputs(proof, verifier.STANDARD, 1) == ref.public_values()
    base = keys.wire_evaluations(ref, lagrange)
    t = Transcript(verifier.STANDARD.manifest(1), proof)
    got = [bn254.g1_from_bytes(t.elements[f"W_{i}"])[1] for i in (1, 2, 3)]
    assert got == keys.wire_commitments(
        base, seeds.blinding_values(2**45 + 3, 5, 3, 3), lagrange)
    assert got != keys.wire_commitments(
        base, seeds.blinding_values(2**45 + 3, 6, 3, 3), lagrange)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not verifier.verify(bytes(bad), verifier.STANDARD, n, 1, comms, keys.DEV_TAU)
