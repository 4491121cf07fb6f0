"""Whole-proof checks of the port (aztec_tpu_torch) against vectors that
the JAX package (aztec_tpu) produced with make_vectors.py (and
``join_split_d3``, which the port proved on the card: make_vectors.py
``CARD_ONLY``).  Shared by tests/test_torch_plonk.py,
tests/test_torch_plonk_chain.py, tests/test_torch_turbo.py,
tests/test_torch_rollup.py, tests/test_torch_ultra.py,
tests/test_torch_mimc.py and chip_smoke.py."""

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
SAME_CIRCUIT = {"unrolled_turbo_drive": "turbo_drive",
                "unrolled_ultra_drive": "ultra_drive"}
# aztec_tpu's flavor (plonk.flavors.FLAVORS) of each vector's proof
FLAVOR = {"turbo_drive": "turbo", "unrolled_turbo_drive": "unrolled_turbo",
          "turbo_pedersen": "turbo", "join_split_d3": "unrolled_turbo",
          "ultra_drive": "ultra", "unrolled_ultra_drive": "unrolled_ultra",
          "mimc_drive": "mimc"}


def port_classes(device: str = "cpu") -> SimpleNamespace:
    """The port's classes, as make_vectors' circuit functions take them."""
    from aztec_tpu_torch.plonk import composer as comp
    from aztec_tpu_torch.plonk import lookup_tables
    from aztec_tpu_torch.stdlib import field_t, mimc_circuit, pedersen_circuit

    return SimpleNamespace(
        package="aztec_tpu_torch",
        StandardComposer=functools.partial(comp.StandardComposer,
                                           device=device),
        TurboComposer=functools.partial(comp.TurboComposer, device=device),
        UltraComposer=functools.partial(comp.UltraComposer, device=device),
        MiMCComposer=functools.partial(comp.MiMCComposer, device=device),
        lookup_tables=lookup_tables, field_t=field_t,
        mimc_circuit=mimc_circuit, pedersen=pedersen_circuit,
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

    from aztec_tpu.plonk.flavors import MimcFlavor

    flavor = dict(FLAVORS, mimc=MimcFlavor)[FLAVOR.get(name, "standard")]
    key = VerificationKey(n=vk.n, num_public_inputs=vk.num_public_inputs,
                          commitments=dict(vk.commitments),
                          domain_root=vk.domain_root, g2_x=vk.g2_x,
                          settings=flavor.settings)
    return Verifier(key, flavor)


def reference_vk(rec):
    """The VK of a reference record (``vk_ints``) with aztec_tpu's domain
    root and dev-SRS G2 point, as ``reference_verifier`` takes it."""
    from aztec_tpu.poly.domain import EvaluationDomain
    from aztec_tpu.srs.reference_string import FakeReferenceStringFactory

    return SimpleNamespace(
        n=rec["n"], num_public_inputs=len(rec["public_inputs"]),
        commitments=vk_ints(rec), domain_root=EvaluationDomain(rec["n"]).root,
        g2_x=FakeReferenceStringFactory().get_verifier_srs().g2_x)


@functools.lru_cache(maxsize=None)
def ultra_planes():
    """make_vectors.ultra_inputs as int32 tensors, and the reference's
    outputs on them (ultra_quotient.npz) as int32 arrays."""
    import torch

    from make_vectors import ultra_inputs

    ins = {k: torch.from_numpy(v.astype(np.int32))
           for k, v in ultra_inputs().items()}
    with np.load(os.path.join(HERE, "ultra_quotient.npz")) as d:
        want = {k: d[k].astype(np.int32) for k in d.files}
    return ins, want


def stand_in_key(quarters: bool, pts, l1, vs, sigmas, selectors):
    """A proving key over seeded 4n coset planes, for a flavor's
    ``quotient_evals``: ``sigmas`` a list of planes, ``selectors`` planes
    by name.  With ``quarters`` each polynomial's "monomial" is its 4n
    plane and quarter j's ``evaluate`` takes its lanes 4k + j, so the
    quarter plan reads the same lanes as the stored plan."""
    import torch

    def store(x):
        return SimpleNamespace(fft=x, monomial=x)

    def quarter(j):
        take = lambda x: x[:, j::4].contiguous()  # noqa: E731
        return take, take(pts), take(l1), take(vs)

    return SimpleNamespace(
        quarters=quarters, device=torch.device("cpu"), quarter=quarter,
        l1_fft=l1, coset_pts=pts, vanish_scale=vs,
        sigmas={f"sigma_{i}": store(x) for i, x in enumerate(sigmas, 1)},
        selectors={k: store(x) for k, x in selectors.items()})


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
