"""The port's UltraPlonk slice against the JAX package, on the CPU.

- the plookup tables and ``build_sorted_halves`` equal aztec_tpu's, and a
  lookup that no table holds raises ``ValueError``;
- ``lookup_grand_product`` and the Ultra quotient (``UltraFlavor.
  quotient_evals``) at n = 16 on seeded planes equal the reference's
  outputs committed in tests/torch_vectors/ultra_quotient.npz, the
  quotient over stored coset forms and by coset quarters;
- each circuit of tests/test_ultra.py recorded on the port's and
  aztec_tpu's ``UltraComposer``: equal gates, witnesses, copy cycles,
  selectors (``q_lookup``, ``q_index`` among them), lookups and subgroup;
- the circuit ``ultra_drive`` (make_vectors.py) proved by the port under a
  counter rng, Keccak and unrolled: the bytes of aztec_tpu's proofs,
  accepted by aztec_tpu's verifier with the reference's VK, a tamper
  rejected; the reference's key planes (tables, ``q_lookup``, ``q_index``
  with their lagrange forms) carried across equal the port's own key;
- a circuit with a lookup outside every table raises ``ValueError`` in
  ``construct_proof``;
- the in-circuit ``_lookup_t_circuit`` equals ``UltraFlavor.
  _lookup_t_terms`` on the evaluations of the committed unrolled-Ultra
  proof;
- the card's committed 2^20-gate Ultra proof and VK (``ultra_2pow20``,
  make_vectors.py ``--card``) are accepted by aztec_tpu's Ultra verifier.

All integer checks: tolerance zero.
"""

import functools
import os
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import make_vectors as mv  # noqa: E402
import plonk_cases  # noqa: E402

M = mv.FR_MOD
NAMES = ("ultra_drive", "unrolled_ultra_drive")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_classes() -> SimpleNamespace:
    from aztec_tpu.plonk import composer as comp
    from aztec_tpu.plonk import lookup_tables

    return SimpleNamespace(package="aztec_tpu",
                           UltraComposer=comp.UltraComposer,
                           lookup_tables=lookup_tables,
                           MulTriple=comp.MulTriple, AddTriple=comp.AddTriple)


# -- tables and the sorted list ---------------------------------------------

TABLES = (("range_table", 3, 1), ("xor_table", 2, 2), ("and_table", 2, 3))


def _tables(lt):
    return [getattr(lt, name)(bits, index) for name, bits, index in TABLES]


def test_tables_and_sorted_halves_match_reference():
    from aztec_tpu.plonk import lookup_tables as ref
    from aztec_tpu_torch.plonk import lookup_tables as lt

    mine, theirs = _tables(lt), _tables(ref)
    assert [(t.name, t.index, t.rows) for t in mine] == \
        [(t.name, t.index, t.rows) for t in theirs]
    rng = random.Random(5)
    eta = rng.randrange(M)
    lookups = [(*rng.choice(t.rows), t.index) for t in mine
               for _ in range(5)]
    assert lt.compress_row(1, 2, 3, 2, eta) == ref.compress_row(1, 2, 3, 2,
                                                                eta)
    got = lt.build_sorted_halves(mine, lookups, eta, 60)
    assert got == ref.build_sorted_halves(theirs, lookups, eta, 60)
    assert len(got[0]) == 61 and len(got[1]) == 60


def test_sorted_halves_reject_a_missing_lookup():
    from aztec_tpu_torch.plonk import lookup_tables as lt

    with pytest.raises(ValueError, match="not present"):
        lt.build_sorted_halves([lt.range_table(3)], [(11, 0, 0, 1)], 7, 28)
    with pytest.raises(ValueError, match="capacity"):
        lt.build_sorted_halves([lt.range_table(3)], [(1, 0, 0, 1)] * 8, 7, 6)


# -- device terms on seeded planes ------------------------------------------

def test_lookup_grand_product_matches_reference():
    from aztec_tpu_torch.plonk import kernels

    ins, want = plonk_cases.ultra_planes()
    z = kernels.lookup_grand_product(*(ins[k] for k in mv.LOOKUP_Z_ARGS),
                                     mv.QUOTIENT_N)
    assert z.shape == (16, mv.QUOTIENT_N)
    assert np.array_equal(z.numpy(), want["lookup_z"])


@pytest.mark.parametrize("quarters", (False, True), ids=("stored",
                                                         "quarters"))
def test_ultra_quotient_matches_reference(quarters):
    from aztec_tpu_torch.plonk.flavors import UltraFlavor

    ins, want = plonk_cases.ultra_planes()
    names = list(UltraFlavor.SELECTOR_ORDER) + [
        f"table_{i}" for i in range(1, 5)] + ["q_lookup", "q_index"]
    planes = list(ins["qffts"].unbind(1)) + list(ins["tffts"].unbind(1)) + [
        ins["qlfft"], ins["qifft"]]
    pk = plonk_cases.stand_in_key(
        quarters, ins["coset_pts"], ins["l1fft"], ins["vanish_scale"],
        ins["sffts"].unbind(1), dict(zip(names, planes)))
    polys = {f"w_{i}": x for i, x in enumerate(ins["wffts"].unbind(1), 1)}
    polys.update(z=ins["zfft"], s_1=ins["s1fft"], s_2=ins["s2fft"],
                 z_lookup=ins["zlfft"])
    ch = {k: ins[k] for k in ("alphas", "beta", "gamma", "delta", "eta")}
    got = UltraFlavor.quotient_evals(pk, polys, polys, ch, mv.QUOTIENT_N)
    assert got.shape == (16, 4 * mv.QUOTIENT_N)
    assert np.array_equal(got.numpy(), want["ultra"])


# -- the composer ------------------------------------------------------------

def _range_lookups(mod):
    c = mod.UltraComposer()
    c.add_lookup_table(mod.lookup_tables.range_table(4, index=1))
    for v in (0, 3, 15, 9):
        c.create_lookup_gate(c.add_variable(v), c.zero_idx, c.zero_idx, 1)
    a, b, s = (c.add_variable(v) for v in (3, 9, 12))
    c.create_add_gate(mod.AddTriple(a, b, s, 1, 1, -1, 0))
    return c


def _xor_reads(mod):
    c = mod.UltraComposer()
    c.add_lookup_table(mod.lookup_tables.xor_table(2, index=2))
    c.read_from_table(2, c.add_variable(1), c.add_variable(3))
    c.read_from_table(2, c.add_variable(3), c.add_variable(3))
    return c


def _multi_table(mod):
    c = mod.UltraComposer()
    c.add_lookup_table(mod.lookup_tables.range_table(3, index=1))
    c.add_lookup_table(mod.lookup_tables.and_table(2, index=3))
    c.create_lookup_gate(c.add_variable(6), c.zero_idx, c.zero_idx, 1)
    c.read_from_table(3, c.add_variable(3), c.add_variable(2))
    return c


def _range_decomposition(mod):
    c = mod.UltraComposer()
    c.add_lookup_table(mod.lookup_tables.range_table(4, index=1))
    c.create_range_constraint_via_lookup(c.add_variable(0xAB), 1, 2, 4)
    return c


def _no_tables(mod):
    c = mod.UltraComposer()
    a, b, p = (c.add_variable(v) for v in (2, 5, 10))
    c.create_mul_gate(mod.MulTriple(a, b, p, 1, -1, 0))
    return c


def _bad_lookup(mod):
    c = mod.UltraComposer()
    c.add_lookup_table(mod.lookup_tables.range_table(3, index=1))
    c.create_lookup_gate(c.add_variable(11), c.zero_idx, c.zero_idx, 1)
    return c


def _public_inputs(mod):
    c = mod.UltraComposer()
    c.add_lookup_table(mod.lookup_tables.range_table(4, index=1))
    x = c.add_public_variable(7)
    c.create_lookup_gate(x, c.zero_idx, c.zero_idx, 1)
    y = c.add_variable(14)
    c.create_add_gate(mod.AddTriple(x, x, y, 1, 1, -1, 0))
    return c


def _unrolled_circuit(mod):
    c = mod.UltraComposer()
    c.add_lookup_table(mod.lookup_tables.xor_table(2, index=2))
    c.read_from_table(2, c.add_variable(2), c.add_variable(3))
    a, b, p = (c.add_variable(v) for v in (4, 6, 24))
    c.create_mul_gate(mod.MulTriple(a, b, p, 1, -1, 0))
    return c


def _bad_read(mod):
    c = mod.UltraComposer()
    c.add_lookup_table(mod.lookup_tables.and_table(2, index=3))
    c.read_from_table(3, c.add_variable(5), c.add_variable(1))
    return c


# tests/test_ultra.py's circuits, the vector's, and a read of keys that no
# row holds (the composer fails, as the reference's does)
CIRCUITS = {"range": _range_lookups, "xor": _xor_reads,
            "multi_table": _multi_table, "range_decomposition":
                _range_decomposition, "no_tables": _no_tables,
            "bad_lookup": _bad_lookup, "public_inputs": _public_inputs,
            "unrolled": _unrolled_circuit, "ultra_drive": mv.build_ultra_drive,
            "bad_read": _bad_read}


@pytest.mark.parametrize("name", CIRCUITS)
def test_composer_matches_reference(name):
    mine = CIRCUITS[name](plonk_cases.port_classes("cpu"))
    theirs = CIRCUITS[name](_reference_classes())
    assert mv.gate_digest(mine) == mv.gate_digest(theirs)
    assert (mine.failed, mine.err) == (theirs.failed, theirs.err)
    assert mine.q_lookup == theirs.q_lookup
    assert mine.q_index == theirs.q_index
    assert mine._lookups == theirs._lookups
    assert sorted(mine.tables) == sorted(theirs.tables)
    n = mine.subgroup_size()
    assert n == theirs.subgroup_size()
    for a, b in zip(mine.compute_sigma_mappings(n, 4),
                    theirs.compute_sigma_mappings(n, 4)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_read_from_table_takes_the_first_matching_row():
    """The port indexes a table once; a table whose keys repeat still
    yields the first row, as the reference's scan does."""
    from aztec_tpu_torch.plonk.composer import UltraComposer
    from aztec_tpu_torch.plonk.lookup_tables import LookupTable

    table = LookupTable("dup", 4, ((1, 2, 7), (1, 2, 9), (3, 4, 5)))
    c = UltraComposer(device="cpu")
    c.add_lookup_table(table)
    out = c.read_from_table(4, c.add_variable(1), c.add_variable(2))
    assert c.get_variable(out) == 7 and not c.failed
    assert c.get_variable(c.read_from_table(4, c.add_variable(3),
                                            c.add_variable(4))) == 5


# -- whole proofs ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _proved(name: str):
    """The port's composer, proof and prover of a vector, on the CPU under
    the vector's counter rng (no VK: the reference's verifies)."""
    build, seed = mv.CIRCUITS[name]
    c = (_proved(plonk_cases.SAME_CIRCUIT[name])[0]
         if name in plonk_cases.SAME_CIRCUIT
         else build(plonk_cases.port_classes("cpu")))
    prover = mv.make_prover(c, name)
    prover.rng = mv.counter_rng(seed)
    return c, prover.construct_proof(), prover


@pytest.mark.parametrize("name", NAMES)
def test_proof_matches_reference_and_verifies(name):
    c, proof, prover = _proved(name)
    rec, _ = plonk_cases.load_vector(name)
    assert rec["producer"] == mv.REFERENCE
    assert proof.hex() == rec["proof"]
    assert prover.settings.name == plonk_cases.FLAVOR[name]
    v = plonk_cases.reference_verifier(plonk_cases.reference_vk(rec), name)
    assert v.verify_proof(proof)
    assert not v.verify_proof(plonk_cases.tampered(proof))
    if name.startswith("unrolled"):
        assert v.pairing_inputs(proof) is not None
        # the keccak verifier does not accept it (another transcript)
        keccak = plonk_cases.reference_verifier(
            plonk_cases.reference_vk(rec), "ultra_drive")
        assert not keccak.verify_proof(proof)


def test_key_planes_carry_across():
    """interop.proving_key_from_numpy of aztec_tpu's Ultra key planes
    equals the port's own key, the lagrange forms of the tables,
    ``q_lookup`` and ``q_index`` too."""
    from aztec_tpu_torch import interop

    c = _proved("ultra_drive")[0]
    rec, planes = plonk_cases.load_vector("ultra_drive")
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
            assert (a.lagrange is None) == (b.lagrange is None), label
            if a.lagrange is not None:
                assert torch.equal(a.lagrange, b.lagrange), label
    assert all(pk.selectors[x].lagrange is not None for x in (
        "table_1", "table_2", "table_3", "table_4", "q_lookup", "q_index"))


def test_lookup_outside_every_table_raises():
    c = _bad_lookup(plonk_cases.port_classes("cpu"))
    assert not c.failed  # the host does not pre-check raw lookup gates
    with pytest.raises(ValueError, match="not present"):
        c.create_prover().construct_proof()


def test_lookup_t_circuit_matches_native_terms():
    """``recursion_verifier._lookup_t_circuit`` over the evaluations and
    challenges of the committed unrolled-Ultra proof, as witnesses of a
    TurboComposer, equals ``UltraFlavor._lookup_t_terms``."""
    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.plonk.flavors import UltraFlavor
    from aztec_tpu_torch.plonk.manifests import UNROLLED_ULTRA
    from aztec_tpu_torch.plonk.serialize import u32_to_bytes
    from aztec_tpu_torch.poly.arithmetic import get_lagrange_evaluations
    from aztec_tpu_torch.poly.domain import EvaluationDomain
    from aztec_tpu_torch.stdlib.field_t import FieldT
    from aztec_tpu_torch.stdlib.recursion_verifier import _lookup_t_circuit
    from aztec_tpu_torch.transcript.transcript import Transcript

    rec, _ = plonk_cases.load_vector("unrolled_ultra_drive")
    s = UNROLLED_ULTRA
    t = Transcript.from_proof(s.create_manifest(len(rec["public_inputs"])),
                              bytes.fromhex(rec["proof"]),
                              hasher=s.hash_type,
                              num_challenge_bytes=s.num_challenge_bytes)
    n = rec["n"]
    t.add_element("circuit_size", u32_to_bytes(n))
    t.add_element("public_input_size", u32_to_bytes(len(rec["public_inputs"])))
    for name in ("init", "eta", "beta", "alpha", "z"):
        t.apply_fiat_shamir(name)
    ch = {"eta": t.get_challenge_fr("eta"), "alpha": t.get_challenge_fr(
        "alpha"), "beta": t.get_challenge_fr("beta", 0),
          "gamma": t.get_challenge_fr("beta", 1)}
    ev = {}
    for info in s.polynomial_manifest:
        ev[info.polynomial_label] = t.get_element_fr(info.polynomial_label)
        if info.requires_shifted_evaluation:
            label = info.polynomial_label + "_omega"
            ev[label] = t.get_element_fr(label)
    root = EvaluationDomain(n, torch.device("cpu")).root
    _, l_start, l_end = get_lagrange_evaluations(t.get_challenge_fr("z"), n,
                                                 root)
    want = UltraFlavor._lookup_t_terms(ev, ch, l_start, l_end)

    c = TurboComposer(device="cpu")
    w = lambda v: FieldT.from_witness(c, v)  # noqa: E731
    ap = [w(pow(ch["alpha"], k, M)) for k in range(24)]
    got = _lookup_t_circuit({k: w(v) for k, v in ev.items()}, w(ch["eta"]),
                            w(ch["beta"]), w(ch["gamma"]), ap, w(l_start),
                            w(l_end))
    assert got.get_value() == want != 0
    assert not c.failed


# -- the card's proof --------------------------------------------------------

def test_card_2pow20_proof_verified_by_reference():
    """The port's Keccak Ultra proof of tools/ultra_circuit.py's 2^20-gate
    circuit (lookups in a range, an XOR and an AND table), made on the
    card (make_vectors.py ``--card ultra_2pow20``), accepted by
    aztec_tpu's UltraFlavor verifier with its VK; a tamper rejected."""
    from aztec_tpu.plonk.flavors import UltraFlavor
    from aztec_tpu.plonk.verifier import Verifier
    from aztec_tpu.utils.fixtures import vk_from_json

    rec, _ = plonk_cases.load_vector("ultra_2pow20")
    assert rec["producer"] == mv.CARD
    vk = vk_from_json(rec["vk_json"])
    assert vk.n == rec["n"] == 1 << 20 and vk.settings.name == "ultra"
    assert rec["gates"] > (1 << 20) - 1024
    assert vk.commitments == plonk_cases.vk_ints(rec)
    proof = bytes.fromhex(rec["proof"])
    v = Verifier(vk, UltraFlavor)
    assert v.verify_proof(proof)
    assert not v.verify_proof(plonk_cases.tampered(proof))


@pytest.mark.cuda
def test_ultra_vectors_on_card():
    """The vectors' proofs made on the card, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mod = plonk_cases.port_classes("cuda")
    c = mv.build_ultra_drive(mod)
    for name in NAMES:
        prover = mv.make_prover(c, name)
        prover.rng = mv.counter_rng(mv.CIRCUITS[name][1])
        assert prover.construct_proof().hex() == \
            plonk_cases.load_vector(name)[0]["proof"]


def test_ultra_composer_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    from aztec_tpu_torch.plonk.composer import MiMCComposer, UltraComposer

    for cls in (UltraComposer, MiMCComposer):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
