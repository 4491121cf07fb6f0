"""The port's rollup circuits and their host halves (aztec_tpu_torch.rollup:
tree_updates, serialize, inner_proof_data, create_rollup, rollup_circuit,
root_rollup_circuit) against aztec_tpu.rollup, on the CPU.

- the three tree-update checks at the depths of tests/test_tree_updates.py
  recorded on both packages' TurboComposer: equal witnesses, wires,
  selectors, copy cycles and public inputs; ``check_turbo`` clean;
- the rollup and root-rollup transactions written byte for byte as
  aztec_tpu writes them, read back, and the inner proof's 14 public
  inputs parsed;
- ``create_rollup_tx`` and ``create_root_rollup_tx`` over
  ``WorldState(6, 16, 4)`` and the committed ``join_split_d3`` proof, field
  for field;
- the rollup and root-rollup circuits at those depths, gate for gate, with
  ``verify_proof_circuit`` replaced in both packages by one stub that
  witnesses the inner public inputs and two fixed points, and the VK-set
  check by one that records nothing (the in-circuit verifier and the key
  set are held in tests/test_torch_recursion.py): the inner rollup's 42
  public inputs (9 + 4 + 1 + 12 + 16) and the root's;
- the committed tower (``rollup_tower``, proved by the port on the card):
  the inner rollup proof accepted by aztec_tpu's unrolled-Turbo verifier,
  the root by its Turbo verifier with the recursive accumulator folded
  into the pairing, tampered copies rejected.

aztec_tpu's Pedersen generators come from its own hash-to-curve, the
stream found once (``plonk_cases.linear_generator_stream``): its
``get_generator`` searches from seed 1 again for every index.

All integer checks: tolerance zero.
"""

import functools
import os
import random
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402
from plonk_cases import assert_same_circuit  # noqa: E402

FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
NUM_INNER_PUBLIC = 14


def _ns(pkg: str):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    composer = mod("plonk.composer")
    cls = composer.TurboComposer
    if pkg == "aztec_tpu_torch":
        cls = functools.partial(cls, device="cpu")
    return SimpleNamespace(
        pkg=pkg, TurboComposer=cls, check=mod("plonk.circuit_check"),
        tu=mod("rollup.tree_updates"), ws=mod("rollup.world_state"),
        notes=mod("rollup.notes_native"), stdlib=mod("stdlib"),
        field_t=mod("stdlib.field_t"), pedersen=mod("crypto.pedersen"),
        point=mod("stdlib.pedersen_circuit").Point,
        serialize=mod("rollup.serialize"), create=mod("rollup.create_rollup"),
        ipd=mod("rollup.inner_proof_data"), rc=mod("rollup.rollup_circuit"),
        rrc=mod("rollup.root_rollup_circuit"),
        rv=mod("stdlib.recursion_verifier"), bg=mod("stdlib.biggroup"),
        pk=mod("plonk.proving_key"), manifests=mod("plonk.manifests"),
        domain=mod("poly.domain"))


@pytest.fixture(autouse=True, scope="module")
def _reference_generators():
    """aztec_tpu's Pedersen generators, from its own hash-to-curve, found
    once (``plonk_cases.linear_generator_stream``)."""
    from aztec_tpu.crypto import pedersen

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pedersen, "get_generator",
                   plonk_cases.linear_generator_stream(pedersen))
        yield


@functools.lru_cache(maxsize=None)
def _m(side: str):
    return _ns("aztec_tpu_torch" if side == "port" else "aztec_tpu")


# -- tree updates (tests/test_tree_updates.py's depths) ----------------------

def _cpath(m, ctx, path):
    return [(m.stdlib.witness(ctx, a), m.stdlib.witness(ctx, b))
            for (a, b) in path]


def _nullifiers(m, c):
    pub = m.pedersen.fixed_base_scalar_mul_g1(0xB0B, 254)
    ws = m.ws.WorldState(null_depth=16)
    note = m.notes.ValueNote(5, 0, 0, pub, 0x5EC)
    nul1 = m.notes.compute_nullifier(m.notes.encrypt_note(note), 0, 0xB0B,
                                     True)
    nul2 = m.notes.compute_nullifier(m.notes.encrypt_note(note), 1, 0xB0B,
                                     True)
    old_root = ws.null_tree.root
    r1, p1 = ws.insert_nullifier(nul1, True)
    r2, p2 = ws.insert_nullifier(0, False)
    r3, p3 = ws.insert_nullifier(nul2, True)
    w, b = m.stdlib.witness, m.field_t.BoolT.from_witness
    final = m.tu.check_nullifiers_inserted(
        c, [r1, r2, r3], [p1, p2, p3], w(c, old_root),
        [w(c, nul1), w(c, 0), w(c, nul2)],
        [b(c, True), b(c, False), b(c, True)])
    assert final.get_value() == r3
    return r3


def _data_subtree(m, c):
    pub = m.pedersen.fixed_base_scalar_mul_g1(0xB0B, 254)
    note = lambda v, s: m.notes.encrypt_note(m.notes.ValueNote(v, 0, 0, pub,
                                                               s))
    ws = m.ws.WorldState(data_depth=4)
    ws.insert_note(0, note(1, 11))
    ws.insert_note(1, note(2, 12))
    old_root = ws.data_root()
    start = 4
    old_path = ws.data_tree.get_hash_path(start)
    a1, a2 = note(3, 13), note(4, 14)
    ws.insert_note(start, a1)
    ws.insert_note(start + 1, a2)
    w = m.stdlib.witness
    vals = [m.point(w(c, a1[0]), w(c, a1[1])),
            m.point(w(c, a2[0]), w(c, a2[1]))]
    m.tu.check_data_tree_updated(
        c, 1, _cpath(m, c, old_path), _cpath(m, c, old_path), vals,
        w(c, old_root), w(c, ws.data_root()), w(c, start), 4)
    return ws.data_root()


def _root_tree(m, c):
    ws = m.ws.WorldState(root_depth=4)
    old_root = ws.root_tree.root
    old_path = ws.root_tree.get_hash_path(1)
    new_root, _ = ws.insert_data_root(0, 0x1234321)
    w = m.stdlib.witness
    m.tu.check_root_tree_updated(
        c, _cpath(m, c, old_path), w(c, 0), w(c, 0x1234321),
        w(c, new_root), w(c, old_root), 4)
    return new_root


TREE_CASES = {"nullifiers": _nullifiers, "data_subtree": _data_subtree,
              "root_tree": _root_tree}


@pytest.mark.parametrize("case", TREE_CASES)
def test_tree_updates_match_reference(case):
    built = {}
    for side in ("port", "reference"):
        m = _m(side)
        c = m.TurboComposer()
        built[side] = (c, TREE_CASES[case](m, c))
    (mine, got), (theirs, want) = built["port"], built["reference"]
    assert got == want
    assert not mine.failed, mine.err
    assert_same_circuit(mine, theirs)
    assert _m("port").check.check_turbo(mine) == []


# -- serialization and the transactions ----------------------------------------

def _rollup_tx(m):
    return m.rc.RollupTx(
        rollup_id=0, num_txs=1, data_start_index=2, txs=[b"proofbytes"],
        old_data_root=3, new_data_root=4, old_data_path=[(5, 6), (7, 8)],
        old_null_root=9, new_null_roots=[10, 11],
        old_null_paths=[[(1, 2)], [(3, 4)]], data_roots_root=12,
        data_roots_paths=[[(13, 14)]], data_roots_indicies=[1],
        new_data_path=[(15, 16), (17, 18)],
        new_null_paths=[[(19, 20)], [(21, 22)]])


def _root_tx(m):
    return m.rrc.RootRollupTx(
        num_inner_proofs=2, rollup_id=7, rollups=[b"r1", b"r2"],
        old_data_roots_root=1, new_data_roots_root=2,
        old_data_roots_path=[(3, 4), (5, 6)])


def test_serialize_matches_reference_and_round_trips():
    mine, theirs = _m("port"), _m("reference")
    s = mine.serialize
    tx, rtx = _rollup_tx(mine), _root_tx(mine)
    data = s.write_rollup_tx(tx)
    assert data == theirs.serialize.write_rollup_tx(_rollup_tx(theirs))
    assert s.read_rollup_tx(data, rollup_id=0) == tx
    rdata = s.write_root_rollup_tx(rtx, [(9, 9)])
    assert rdata == theirs.serialize.write_root_rollup_tx(_root_tx(theirs),
                                                          [(9, 9)])
    assert s.read_root_rollup_tx(rdata) == rtx
    with pytest.raises(AssertionError):
        s.read_rollup_tx(data + b"\x00")


def _proof():
    rec, _ = plonk_cases.load_vector("join_split_d3")
    return bytes.fromhex(rec["proof"]), rec


def test_inner_proof_data_parses_the_public_inputs():
    proof, rec = _proof()
    mine = _m("port").ipd.InnerProofData.from_proof(proof)
    assert vars(mine) == vars(
        _m("reference").ipd.InnerProofData.from_proof(proof))
    pub = [int(v, 16) if isinstance(v, str) else v
           for v in rec["public_inputs"]]
    F = _m("port").ipd.InnerProofFields
    assert mine.nullifier1 == pub[F.NULLIFIER1]
    assert mine.merkle_root == pub[F.MERKLE_ROOT]
    assert mine.new_note1 == proof[4 * 32:6 * 32]


def _tower_txs(m, proof):
    """The tower's transactions over the committed join-split proof: its
    data root registered in the root tree as rollup 0's, then the tx
    rollup (rollup 1) and the root rollup over a stand-in inner proof."""
    d = m.ipd.InnerProofData.from_proof(proof)
    ws = m.ws.WorldState(data_depth=6, null_depth=16, root_depth=4)
    ws.insert_data_root(0, d.merkle_root)
    rtx = m.create.create_rollup_tx(ws, 1, [proof], rollup_size=1)
    root = m.create.create_root_rollup_tx(ws, 1, [proof[::-1]],
                                          rtx.new_data_root)
    return rtx, root


def test_create_rollup_txs_match_reference():
    proof, _ = _proof()
    mine = _tower_txs(_m("port"), proof)
    theirs = _tower_txs(_m("reference"), proof)
    for a, b in zip(mine, theirs):
        assert vars(a) == vars(b)
    rtx = mine[0]
    assert rtx.num_txs == 1 and rtx.data_start_index == 0
    assert len(rtx.new_null_roots) == 2 and len(rtx.old_null_paths[0]) == 16
    assert rtx.data_roots_indicies == [1]


# -- the circuits, the in-circuit verifier stubbed ------------------------------

P0, P1 = 7, 11  # the stub's points: P0 * G and P1 * G


def _stub_verifier(m):
    def verify_proof_circuit(ctx, proof, vk, manifest=None,
                             previous_output=None):
        F = m.field_t.FieldT
        pub = [F.from_witness(ctx, int.from_bytes(proof[32 * i:32 * i + 32],
                                                  "big"))
               for i in range(vk.num_public_inputs)]
        pts = [m.bg.BigGroup.from_witness(ctx, m.rv.g1_mul(k, (1, 2)))
               for k in (P0, P1)]
        return m.rv.RecursionOutput(P0=pts[0], P1=pts[1], public_inputs=pub)
    return verify_proof_circuit


@pytest.fixture
def stubbed(monkeypatch):
    for side in ("port", "reference"):
        m = _m(side)
        stub = _stub_verifier(m)
        monkeypatch.setattr(m.rc, "verify_proof_circuit", stub)
        monkeypatch.setattr(m.rrc, "verify_proof_circuit", stub)
        monkeypatch.setattr(m.rv.RecursiveVK, "validate_key_is_in_set",
                            lambda self, ctx, keys: None)


def _vk(m, n, num_pub, recursive):
    _, rec = _proof()
    return m.pk.VerificationKey(
        n=n, num_public_inputs=num_pub, commitments=plonk_cases.vk_ints(rec),
        domain_root=m.domain.EvaluationDomain(n, *(
            ("cpu",) if m.pkg == "aztec_tpu_torch" else ())).root,
        g2_x=None, settings=m.manifests.UNROLLED_TURBO,
        contains_recursive_proof=recursive,
        recursive_proof_public_input_indices=(
            tuple(range(num_pub - 16, num_pub)) if recursive else None))


def _rollup_circuit(m, proof):
    rtx, _ = _tower_txs(m, proof)
    c = m.TurboComposer()
    m.rc.rollup_circuit(c, rtx, [_vk(m, 1 << 16, NUM_INNER_PUBLIC, False)],
                        rollup_size=1)
    return c


def _root_rollup_circuit(m, proof):
    _, root = _tower_txs(m, proof)
    # the inner rollup's proof: its 42 public inputs first
    inner = b"".join(random.Random(3).randrange(FR_MOD).to_bytes(32, "big")
                     for _ in range(42)) + proof[14 * 32:]
    root.rollups = [inner]
    c = m.TurboComposer()
    m.rrc.root_rollup_circuit(c, root, inner_rollup_size=1,
                              outer_rollup_size=1,
                              inner_verification_key=_vk(m, 1 << 24, 42,
                                                         True))
    return c


@pytest.mark.parametrize("circuit", ("rollup", "root_rollup"))
def test_rollup_circuits_match_reference(stubbed, circuit):
    build = _rollup_circuit if circuit == "rollup" else _root_rollup_circuit
    proof, _ = _proof()
    mine, theirs = (build(_m(side), proof) for side in ("port", "reference"))
    assert_same_circuit(mine, theirs)
    assert len(mine.public_inputs) == 42
    assert mine.recursive_proof_public_input_indices == tuple(range(26, 42))
    if circuit == "rollup":
        # 9 roots and counts, 4 fees, 1 zero, 12 published inner inputs,
        # 16 accumulator limbs
        pub = [mine.get_variable(i) for i in mine.public_inputs]
        assert pub[1] == 1 and pub[13] == 0
        assert pub[14:26] == [int.from_bytes(proof[32 * i:32 * i + 32], "big")
                              for i in range(12)]
        assert not mine.failed, mine.err
        assert _m("port").check.check_turbo(mine) == []


# -- the committed tower, proved on the card -----------------------------------

@functools.lru_cache(maxsize=None)
def _tower():
    rec, _ = plonk_cases.load_vector("rollup_tower")
    return rec


def _reference_verifier(entry, flavor_name):
    from aztec_tpu.plonk.flavors import FLAVORS
    from aztec_tpu.plonk.verifier import Verifier
    from aztec_tpu.utils.fixtures import vk_from_json

    return Verifier(vk_from_json(entry["vk"]), FLAVORS[flavor_name])


@pytest.mark.parametrize("stage,flavor", (("inner", "unrolled_turbo"),
                                          ("root", "turbo")))
def test_tower_vector_verified_by_reference(stage, flavor):
    entry = _tower()[stage]
    verifier = _reference_verifier(entry, flavor)
    assert verifier.key.contains_recursive_proof
    assert verifier.key.n == 1 << 24
    proof = bytes.fromhex(entry["proof"])
    assert verifier.verify_proof(proof)
    assert not verifier.verify_proof(plonk_cases.tampered(proof))
