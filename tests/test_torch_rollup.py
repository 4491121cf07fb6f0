"""The port's rollup transaction path (aztec_tpu_torch: host Schnorr, the
Merkle trees, the notes, the join-split and account circuits) against
aztec_tpu, host only.

Each circuit (the depth-3 join-split of tests/test_join_split.py, the
account tx of rollup/circuit_data.py and the depth-6 noop join-split behind
the proof worker's padding proof) is recorded once on the port's
TurboComposer (on the CPU) and once on aztec_tpu's: the witnesses, the four
wire lists, the eleven selector lists, the copy cycles (the sigma mappings,
public-input rows included) and the public inputs must be equal;
check_turbo is clean on both, and the reference's negative cases fail on
the port.  Nothing is proved on the CPU.  The committed ``join_split_d3``
vector is the port's unrolled proof of the depth-3 tx on the card
(make_vectors.py ``--card``: aztec_tpu's XLA:CPU proof at 2^16 did not end
within 90 minutes), so it is held to aztec_tpu independently: its 15 VK
commitments equal [sum_i v_i L_i(tau)] G computed on the host from
aztec_tpu's composer lists at the dev tau, aztec_tpu's verifier and the
port's accept its proof and reject a tampered copy, and the
``cuda``-marked case proves it again on the card, byte for byte.
"""

import copy
import functools
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import make_vectors as mv  # noqa: E402
import plonk_cases  # noqa: E402

FR_MOD = mv.FR_MOD
SELECTORS = ("q_m", "q_c", "q_1", "q_2", "q_3", "q_4", "q_5", "q_arith",
             "q_ecc_1", "q_range", "q_logic")
PACKAGES = {"port": "aztec_tpu_torch", "reference": "aztec_tpu"}


def _side(side: str) -> SimpleNamespace:
    """The modules of one package, by the reference's names."""
    import importlib

    pkg = PACKAGES[side]
    mod = functools.partial(importlib.import_module, package=pkg)
    comp = mod(".plonk.composer")
    turbo = (functools.partial(comp.TurboComposer, device="cpu")
             if side == "port" else comp.TurboComposer)
    return SimpleNamespace(
        package=pkg, TurboComposer=turbo, pd=mod(".crypto.pedersen"),
        schnorr=mod(".crypto.schnorr"), merkle=mod(".merkle"),
        nn=mod(".rollup.notes_native"), js=mod(".rollup.join_split"),
        account=mod(".rollup.account"), cd=mod(".rollup.circuit_data"),
        check=mod(".plonk.circuit_check"))


# -- host crypto, trees and notes ------------------------------------------

@pytest.mark.parametrize("k", [0x1234567, FR_MOD - 5])
def test_schnorr_matches_reference(k):
    port, ref = _side("port"), _side("reference")
    priv = 0x0B0B + k % 97
    msg = bytes(range(40))
    sig = port.schnorr.construct_signature(msg, priv, k=k)
    assert sig == ref.schnorr.construct_signature(msg, priv, k=k)
    pub = port.schnorr.derive_public_key(priv)
    assert pub == ref.schnorr.derive_public_key(priv)
    bad = (sig[0], bytes([sig[1][0] ^ 1]) + sig[1][1:])
    for m in (port, ref):
        assert m.schnorr.verify_signature(msg, pub, sig)
        assert not m.schnorr.verify_signature(msg, pub, bad)


def _fill(tree, indices):
    for i in indices:
        tree.update_element(i, (i * 0x9E3779B97F4A7C15).to_bytes(64, "big"))
    return tree.root, [tree.get_hash_path(i) for i in indices]


@pytest.mark.parametrize("kind,depth", [("MemoryTree", 3), ("SparseTree", 3),
                                        ("SparseTree", 32)])
def test_trees_match_reference(kind, depth):
    got = []
    for side in ("port", "reference"):
        merkle = _side(side).merkle
        tree = (merkle.MemoryTree(depth) if kind == "MemoryTree"
                else merkle.SparseTree(merkle.MemoryStore(), depth, b"d"))
        got.append(_fill(tree, [5, (1 << depth) - 1]))
    assert got[0] == got[1]
    assert len(got[0][1][0]) == depth


def test_notes_match_reference():
    got = []
    for side in ("port", "reference"):
        m = _side(side)
        pub = m.pd.fixed_base_scalar_mul_g1(0x0B0B, 254)
        notes = [m.nn.ValueNote(100, 1, 0, pub, 0xAAAA1),
                 m.nn.ValueNote(0, 0, 3, pub, 0xA2)]
        enc = [m.nn.encrypt_note(n) for n in notes]
        got.append((enc,
                    [m.nn.compute_nullifier(e, i, 0x0B0B, i == 0)
                     for i, e in enumerate(enc)],
                    m.nn.encrypt_account_note(
                        m.nn.account_alias_id(0xA11A5, 1), pub, enc[0])))
    assert got[0] == got[1]


# -- the circuits ----------------------------------------------------------

def _account_tx(m, depth: int = 3):
    """The account tx of rollup/circuit_data.py's ``_build_account_data``."""
    pub = m.pd.fixed_base_scalar_mul_g1(0x0B0B, 254)
    spend = m.pd.fixed_base_scalar_mul_g1(0x51, 254)
    tree = m.merkle.MemoryTree(depth)
    tx = m.account.AccountTx(
        merkle_root=tree.root, account_public_key=pub,
        new_account_public_key=pub, new_signing_pub_key_1=spend,
        new_signing_pub_key_2=spend, alias_hash=0xA11A5, nonce=0,
        migrate=True, gibberish=0x61BB, account_index=0,
        account_path=tree.get_hash_path(0), signing_pub_key=spend,
        signature=(bytes(32), bytes(32)))
    tx.signature = m.account.sign_tx(tx, 0x0B0B, k=0xD00D)
    return tx


def _build(case: str, m, alter=None):
    """(composer, the circuit's outputs) of one case on ``m``'s package;
    ``alter`` changes the tx first."""
    if case == "account":
        tx, circuit = _account_tx(m), m.account.account_circuit
    else:
        tx = (mv.join_split_d3_tx(m.package) if case == "join_split_d3"
              else m.cd.noop_join_split_tx(6))
        circuit = m.js.join_split_circuit
    if alter:
        alter(m, tx)
    c = m.TurboComposer()
    return c, circuit(c, tx)


CASES = ("join_split_d3", "account", "noop_join_split_d6")


@pytest.fixture(scope="module")
def circuits():
    """Each case built once per package, on first use."""
    return functools.lru_cache(maxsize=None)(
        lambda case, side: _build(case, _side(side)))


@pytest.mark.parametrize("case", CASES)
def test_circuit_matches_reference(circuits, case):
    mine, out = circuits(case, "port")
    theirs, ref_out = circuits(case, "reference")
    assert not mine.failed and not theirs.failed, (mine.err, theirs.err)
    if out is not None:
        assert (out.tx_fee.get_value(), out.nullifier1.get_value(),
                out.nullifier2.get_value()) == (
            ref_out.tx_fee.get_value(), ref_out.nullifier1.get_value(),
            ref_out.nullifier2.get_value())
    assert mine.n == theirs.n
    assert mine.variables == theirs.variables
    assert mine.real_variable_index == theirs.real_variable_index
    assert mine.public_inputs == theirs.public_inputs
    assert len(mine.public_inputs) == 14
    for name in ("w_l", "w_r", "w_o", "w_4") + SELECTORS:
        assert getattr(mine, name) == getattr(theirs, name), name
    assert mine.subgroup_size() == theirs.subgroup_size()


def test_sigma_mappings_match_reference(circuits):
    """The copy cycles as the proving key takes them, public-input rows
    included (the other cases' cycles follow from the equal
    ``real_variable_index`` and wires)."""
    mine, theirs = (circuits("join_split_d3", side)[0] for side in PACKAGES)
    size = mine.subgroup_size()
    for a, b in zip(mine.compute_sigma_mappings(size, 4),
                    theirs.compute_sigma_mappings(size, 4)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("side", PACKAGES)
@pytest.mark.parametrize("case", CASES)
def test_check_turbo_clean(circuits, case, side):
    assert _side(side).check.check_turbo(circuits(case, side)[0]) == []


def _bad_signature(m, tx):
    s, e = tx.signature
    tx.signature = (s, bytes([e[0] ^ 1]) + e[1:])


def _wrong_root(m, tx):
    tx.old_data_root = (tx.old_data_root + 1) % (1 << 254)


def _unbalanced(m, tx):
    tx.output_note[0].value += 1 << 200         # the fee underflows its range
    tx.signature = m.js.sign_tx(tx, mv.JOIN_SPLIT_PRIV, k=0x1234567)


def _migrate_not_set(m, tx):
    tx.migrate = False
    tx.signature = m.account.sign_tx(tx, 0x0B0B, k=0xFEED)


def _account_key_of_other(m, tx):
    tx.signature = m.account.sign_tx(tx, 0x51, k=0xFEED)


@pytest.mark.parametrize("case,alter", [
    ("join_split_d3", _bad_signature), ("join_split_d3", _wrong_root),
    ("join_split_d3", _unbalanced), ("account", _migrate_not_set),
    ("account", _account_key_of_other)],
    ids=["js_bad_signature", "js_wrong_root", "js_unbalanced",
         "account_nonce0_migrate_required", "account_bad_signature"])
def test_negative_cases_fail_on_port(case, alter):
    m = _side("port")
    c, _ = _build(case, m, alter)
    assert c.failed or m.check.check_turbo(c) != []


# -- the committed join-split proof ---------------------------------------

def _vector_vk():
    """The vector's VK as aztec_tpu's VerificationKey (the domain root and
    the dev SRS's G2 point from aztec_tpu's host code), its JSON by
    aztec_tpu's ``vk_to_json``, and the port's ``vk_from_json`` of that
    JSON."""
    from aztec_tpu.plonk import manifests as ref_manifests
    from aztec_tpu.plonk.proving_key import VerificationKey
    from aztec_tpu.poly.domain import EvaluationDomain
    from aztec_tpu.srs.reference_string import FakeReferenceStringFactory
    from aztec_tpu.utils.fixtures import vk_to_json
    from aztec_tpu_torch.utils import fixtures

    rec, _ = plonk_cases.load_vector("join_split_d3")
    ref_vk = VerificationKey(
        n=rec["n"], num_public_inputs=len(rec["public_inputs"]),
        commitments=plonk_cases.vk_ints(rec),
        domain_root=EvaluationDomain(rec["n"]).root,
        g2_x=FakeReferenceStringFactory().get_verifier_srs().g2_x,
        settings=ref_manifests.UNROLLED_TURBO)
    text = vk_to_json(ref_vk)
    return rec, ref_vk, text, fixtures.vk_from_json(text)


def _with_dummy_gate(c):
    """A copy of composer ``c`` (its lists and maps copied, their ints
    shared) with the dummy gate that compute_proving_key adds."""
    d = copy.copy(c)
    for name, value in vars(c).items():
        if isinstance(value, (list, dict, set)):
            setattr(d, name, copy.copy(value))
    d.create_dummy_gate()
    return d


def _dev_tau_commitments(c, n: int) -> dict:
    """The 15 VK commitments of the depth-3 join-split from aztec_tpu's
    composer ``c`` on the host, with aztec_tpu's constants only:
    [sum_i v_i L_i(tau)] G at the tau of its FakeReferenceStringFactory, in
    the proving key's layout (public-input rows first, the dummy gate
    compute_proving_key adds, a 1 on the last row of every selector;
    sigma = omega^next_row * k of its column)."""
    from aztec_tpu.curves.pairing import g1_mul
    from aztec_tpu.ff.bn254 import FR_COSET_GENERATORS, FR_MOD
    from aztec_tpu.plonk import manifests as ref_manifests
    from aztec_tpu.poly.domain import EvaluationDomain
    from aztec_tpu.srs.reference_string import FakeReferenceStringFactory

    tau = FakeReferenceStringFactory().tau
    c = _with_dummy_gate(c)
    num_pub = len(c.public_inputs)
    omega = EvaluationDomain(n).root
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * omega % FR_MOD
    # L_i(tau) = omega^i (tau^n - 1) / (n (tau - omega^i)), one inversion
    dens = [(tau - w) % FR_MOD for w in pows]
    prefix, run = [0] * n, 1
    for i, d in enumerate(dens):
        prefix[i], run = run, run * d % FR_MOD
    inv = pow(run, -1, FR_MOD) * (pow(tau, n, FR_MOD) - 1) \
        * pow(n, -1, FR_MOD) % FR_MOD
    lag = [0] * n
    for i in range(n - 1, -1, -1):
        lag[i] = pows[i] * inv % FR_MOD * prefix[i] % FR_MOD
        inv = inv * dens[i] % FR_MOD

    def commit(values):
        return g1_mul(sum(v * w for v, w in zip(values, lag)) % FR_MOD,
                      (1, 2))

    out = {}
    for info in ref_manifests.UNROLLED_TURBO.polynomial_manifest:
        if info.source == "selector":
            out[info.commitment_label] = commit(
                [0] * num_pub + getattr(c, info.polynomial_label)
                + [0] * (n - 1 - c.n - num_pub) + [1])
    k = (1,) + FR_COSET_GENERATORS[:3] + (FR_COSET_GENERATORS[7],)
    for col, (rows, factors) in enumerate(zip(
            *c.compute_sigma_mappings(n, 4))):
        out[f"SIGMA_{col + 1}"] = commit(
            [pows[int(r)] * k[int(f)] % FR_MOD for r, f in zip(rows, factors)])
    return out


def test_join_split_vector_vk_is_the_reference_circuits(circuits):
    rec, _ = plonk_cases.load_vector("join_split_d3")
    reference = circuits("join_split_d3", "reference")[0]
    assert _dev_tau_commitments(reference, rec["n"]) == \
        plonk_cases.vk_ints(rec)


def test_vk_json_carries_across():
    from aztec_tpu_torch.plonk import manifests
    from aztec_tpu_torch.utils import fixtures

    _, _, text, vk = _vector_vk()
    assert vk.settings is manifests.UNROLLED_TURBO
    assert vk.num_public_inputs == 14
    assert fixtures.vk_to_json(vk) == text


def test_join_split_vector_public_inputs(circuits):
    c, _ = circuits("join_split_d3", "port")
    rec, _ = plonk_cases.load_vector("join_split_d3")
    assert rec["n"] == c.subgroup_size() == 1 << 16
    assert [hex(c.get_variable(i)) for i in c.public_inputs] == \
        rec["public_inputs"]


@pytest.mark.parametrize("side", PACKAGES)
def test_join_split_vector_verifies(side):
    from aztec_tpu_torch.plonk.flavors import UnrolledTurboFlavor
    from aztec_tpu_torch.plonk.verifier import Verifier

    rec, ref_vk, _, vk = _vector_vk()
    verifier = (Verifier(vk, UnrolledTurboFlavor) if side == "port"
                else plonk_cases.reference_verifier(ref_vk, "join_split_d3"))
    proof = bytes.fromhex(rec["proof"])
    assert verifier.verify_proof(proof)
    assert not verifier.verify_proof(plonk_cases.tampered(proof))


def test_vectors_name_their_producer():
    """Only make_vectors.CARD_ONLY may hold the port's own card proof:
    load_vector refuses such a record under any other name, and
    ``--card`` refuses to write one."""
    names = sorted(f[:-5] for f in os.listdir(plonk_cases.HERE)
                   if f.endswith(".json"))
    producers = {name: plonk_cases.load_vector(name)[0].get(
        "producer", mv.REFERENCE) for name in names}
    for name in mv.CARD_ONLY:
        assert producers.pop(name) == mv.CARD, name
    assert set(producers.values()) == {mv.REFERENCE}
    with pytest.raises(SystemExit, match="turbo_drive"):
        mv.card_vectors(["join_split_d3", "turbo_drive"])


@pytest.mark.cuda
def test_join_split_vector_proved_on_card():
    """The depth-3 tx proved unrolled on the card: the vector's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    build, seed = mv.CIRCUITS["join_split_d3"]
    c = build(plonk_cases.port_classes("cuda"))
    prover = mv.make_prover(c, "join_split_d3")
    prover.rng = mv.counter_rng(seed)
    rec, _ = plonk_cases.load_vector("join_split_d3")
    assert prover.construct_proof().hex() == rec["proof"]
    assert c.compute_verification_key().commitments == \
        plonk_cases.vk_ints(rec)


def test_circuit_data_refuses_missing_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from aztec_tpu_torch.rollup import circuit_data

    monkeypatch.setenv("AZTEC_FIXTURES", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        circuit_data.account_circuit_data()


def test_fixture_dir_is_the_ports_own(tmp_path, monkeypatch):
    from aztec_tpu_torch.utils import fixtures

    monkeypatch.setenv("AZTEC_FIXTURES", str(tmp_path))
    assert fixtures.fixture_dir() == os.path.join(str(tmp_path), "torch")
    assert os.path.isdir(os.path.join(str(tmp_path), "torch"))
