"""Whole-proof checks of the port (aztec_tpu_torch) against vectors that
the JAX package (aztec_tpu) produced with make_vectors.py (and
``join_split_d3``, which the port proved on the card: make_vectors.py
``CARD_ONLY``).  Shared by tests/test_torch_plonk.py,
tests/test_torch_plonk_chain.py, tests/test_torch_turbo.py,
tests/test_torch_rollup.py and chip_smoke.py."""

from __future__ import annotations

import functools
import json
import os
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_vector(name: str):
    """(the JSON record, the key planes or {} where none were written).
    Only a circuit of make_vectors.CARD_ONLY may hold a record that the
    port proved on the card; every other record must be aztec_tpu's."""
    from make_vectors import CARD_ONLY, REFERENCE

    with open(os.path.join(HERE, f"{name}.json")) as f:
        rec = json.load(f)
    producer = rec.get("producer", REFERENCE)
    assert producer == REFERENCE or name in CARD_ONLY, (
        f"{name}: the record was written by {producer}, not {REFERENCE}")
    path = os.path.join(HERE, f"{name}.npz")
    if not os.path.exists(path):
        return rec, {}
    with np.load(path) as d:
        planes = {k: d[k] for k in d.files}
    return rec, planes


# vectors of one circuit proved two ways: the port proves them on one
# composer (one key, one VK)
SAME_CIRCUIT = {"unrolled_turbo_drive": "turbo_drive"}
# aztec_tpu's flavor (plonk.flavors.FLAVORS) of each vector's proof
FLAVOR = {"turbo_drive": "turbo", "unrolled_turbo_drive": "unrolled_turbo",
          "turbo_pedersen": "turbo", "join_split_d3": "unrolled_turbo"}


def port_classes(device: str = "cpu") -> SimpleNamespace:
    """The port's classes, as make_vectors' circuit functions take them."""
    from aztec_tpu_torch.plonk import composer as comp
    from aztec_tpu_torch.stdlib import pedersen_circuit

    return SimpleNamespace(
        package="aztec_tpu_torch",
        StandardComposer=functools.partial(comp.StandardComposer,
                                           device=device),
        TurboComposer=functools.partial(comp.TurboComposer, device=device),
        pedersen=pedersen_circuit,
        MulTriple=comp.MulTriple, AddTriple=comp.AddTriple)


@functools.lru_cache(maxsize=None)
def prove(name: str):
    """The port's composer, proof, VK and prover for a vector's circuit, on
    the CPU, under the vector's counter rng."""
    from make_vectors import CIRCUITS, counter_rng, make_prover

    build, seed = CIRCUITS[name]
    c = prove(SAME_CIRCUIT[name])[0] if name in SAME_CIRCUIT else build(
        port_classes())
    prover = make_prover(c, name)
    prover.rng = counter_rng(seed)
    proof = prover.construct_proof()
    return c, proof, c.compute_verification_key(), prover


def vk_ints(rec):
    return {k: None if v is None else (int(v[0], 16), int(v[1], 16))
            for k, v in rec["vk"].items()}


def reference_verifier(vk, name: str = "standard_drive1"):
    """aztec_tpu's Verifier of the vector's flavor around a
    VerificationKey holding the port's VK values (no JAX MSM is
    compiled)."""
    from aztec_tpu.plonk.flavors import FLAVORS
    from aztec_tpu.plonk.proving_key import VerificationKey
    from aztec_tpu.plonk.verifier import Verifier

    flavor = FLAVORS[FLAVOR.get(name, "standard")]
    key = VerificationKey(n=vk.n, num_public_inputs=vk.num_public_inputs,
                          commitments=dict(vk.commitments),
                          domain_root=vk.domain_root, g2_x=vk.g2_x,
                          settings=flavor.settings)
    return Verifier(key, flavor)


def linear_generator_stream(pedersen):
    """``get_generator`` of the reference's ``crypto.pedersen`` module, the
    same points from its own ``hash_to_curve`` and ``g_on_curve``, the
    stream extended once: the module's own searches from seed 1 for every
    index (about 20 s for the ~90 generators of an unrolled proof's
    transcript with 42 public inputs)."""
    gens, seed = [], [0]

    def get_generator(index: int):
        while len(gens) <= index:
            seed[0] += 1
            cand = pedersen.hash_to_curve(seed[0])
            if cand is not None and pedersen.g_on_curve(cand):
                gens.append(cand)
        return gens[index]
    return get_generator


TURBO_SELECTORS = ("q_m", "q_c", "q_1", "q_2", "q_3", "q_4", "q_5",
                   "q_arith", "q_ecc_1", "q_range", "q_logic")


def assert_same_circuit(mine, theirs):
    """Two TurboComposers recorded the same circuit: gates, witnesses, copy
    classes, public inputs and the recursive-proof positions."""
    assert mine.n == theirs.n
    assert mine.failed == theirs.failed
    assert mine.variables == theirs.variables
    assert mine.real_variable_index == theirs.real_variable_index
    assert mine.next_var_index == theirs.next_var_index
    assert mine.public_inputs == theirs.public_inputs
    assert (mine.recursive_proof_public_input_indices
            == theirs.recursive_proof_public_input_indices)
    for name in ("w_l", "w_r", "w_o", "w_4") + TURBO_SELECTORS:
        assert getattr(mine, name) == getattr(theirs, name), name


def tampered(proof: bytes) -> bytes:
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 0x01
    return bytes(bad)


def key_planes_equal(name: str) -> None:
    """interop.proving_key_from_numpy of the reference key planes equals
    the port's own proving key, plane for plane."""
    import torch

    from aztec_tpu_torch import interop

    c = prove(name)[0]
    rec, planes = load_vector(name)
    pk = c.compute_proving_key()
    got = interop.proving_key_from_numpy(rec["n"], pk.num_public_inputs,
                                         planes, pk.srs, pk.settings,
                                         device="cpu")
    for kind in ("selectors", "sigmas"):
        mine, theirs = getattr(pk, kind), getattr(got, kind)
        assert sorted(mine) == sorted(theirs)
        for label in mine:
            a, b = mine[label], theirs[label]
            assert torch.equal(a.monomial, b.monomial), label
            assert torch.equal(a.fft, b.fft), label
            if kind == "sigmas":
                assert torch.equal(a.lagrange, b.lagrange), label
