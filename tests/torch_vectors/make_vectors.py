"""Reference vectors for the PyTorch port's whole-proof tests.

Proves small circuits with the JAX package (``aztec_tpu``) under a fixed
counter rng and writes, per circuit:

- ``<name>.json``: subgroup size, public inputs, the proof bytes (hex) and
  the verification-key commitments (hex affine ints);
- ``<name>.npz`` (the circuits of ``PLANES``): the proving key's planes as
  uint16 (16, n) Montgomery limbs: selector and sigma monomials plus sigma
  lagrange values.

The circuits: two Standard-PLONK ones (``standard_drive1``,
``standard_chain8``); the TurboPlonk circuit of tests/test_turbo.py proved
with the keccak transcript (``turbo_drive``) and unrolled
(``unrolled_turbo_drive``, the Pedersen-Blake2s transcript, no
linearisation); and ``turbo_pedersen``, aztec_tpu_torch/tools/
turbo_circuit.py's circuit at 2^10 gates (one in-circuit Pedersen
``compress``, one range constraint of each width, one AND, one XOR),
proved only here and on the card (chip_smoke.py), not by the CPU tests;
and ``join_split_d3``, the rollup's depth-3 join-split tx of
tests/test_join_split.py (two input notes, 14 public inputs, 2^16 gates)
proved unrolled, whose proof and VK ``tests/test_torch_rollup.py`` verifies
with both packages and the card proves again (chip_smoke.py).

The committed ``join_split_d3.json`` is the port's proof on the card
(``--card``, below): the JAX package's XLA:CPU proof at 2^16 did not end
within 90 minutes.  tests/test_torch_rollup.py holds its VK to the
dev-tau evaluation of aztec_tpu's composer lists on the host, and
aztec_tpu's verifier accepts its proof.  Every record names its
``producer``: ``aztec_tpu`` (a record without the key was written by this
script before it had one) or ``aztec_tpu_torch/card``, which only the
circuits of ``CARD_ONLY`` may carry.
``tests/test_torch_plonk.py`` and ``tests/test_torch_turbo.py`` hold the
port (``aztec_tpu_torch``) to these bytes without compiling the JAX prover.

The UltraPlonk and MiMC vectors: ``ultra_drive`` (an UltraPlonk circuit
in the manner of tests/test_ultra.py: a range and an AND table, lookups,
subgroup 32; its key planes with the tables' and ``q_lookup`` /
``q_index``'s lagrange forms), the same circuit proved unrolled
(``unrolled_ultra_drive``), and
``mimc_drive`` (tests/test_mimc.py's prove-verify circuit on the
``MiMCComposer``, subgroup 128); and ``ultra_quotient.npz``: the
reference's ``lookup_grand_product`` and ``ultra_quotient`` at n = 16,
``mimc_quotient`` and ``elliptic_identity`` on the seeded planes of
``ultra_inputs``.  The card writes ``ultra_2pow20`` (aztec_tpu_torch/tools/
ultra_circuit.py's 2^20-gate circuit, Keccak) and ``escape_hatch_prod``
(the escape hatch at the production tree depths, Keccak Turbo), each with
its whole VK as JSON (``vk_json``); tests/test_torch_ultra.py and
tests/test_torch_escape_hatch.py hold them to aztec_tpu's verifiers:

    python tests/torch_vectors/make_vectors.py --card ultra_2pow20 escape_hatch_prod

Also ``turbo_quotient.npz``: the reference's ``kernels.turbo_quotient`` at
n = 16 (4n = 64 lanes) on the seeded inputs of ``quotient_inputs``, which
the test rebuilds from the seed.

Also ``mont_pow.npz``: the reference's ``mont_pow``, ``inv_mont`` and
``batch_inv_mont`` (``aztec_tpu.ff.limb``) for Fr and Fq on POW_LANES
lanes of canonical and unreduced 16-bit limbs (0, 1, p - 1, p, p + 1,
2p - 1, all 0xFFFF, canonical and uniform random limbs), with the exponents
p - 2, 2^100, 0 and 1; ``tests/test_torch_ff.py`` holds the port to them.
The batch inversion runs along an axis of length one, so every lane is its
own inversion (along a longer axis the reference's associative scan and
the port's Hillis-Steele scan multiply unreduced lanes in other orders).

Regenerate (minutes of XLA:CPU compiles per circuit, a few for the powers)
with, optionally followed by the names to make (``mont_pow`` and
``turbo_quotient`` among them):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_vectors/make_vectors.py

Also ``recursive_vk.json``: aztec_tpu's native Pedersen compression of a
seeded unrolled-Turbo VK and the gate digest of the circuit that
compresses it in-circuit and checks its membership of a key set
(``recursive_vk_circuit``); tests/test_torch_recursion.py holds the port
to both (aztec_tpu's generators for the 123 inputs take minutes).

Also ``pedersen_lanes.npz``: aztec_tpu's ``hash_single_batch`` (the
batched Pedersen lanes) at hash indices 0 and 1 on eight seeded lanes
(zero, the skew, p - 1 among them), Jacobian limbs; and ``sharded_fft.npz``:
aztec_tpu's ``sharded_coset_fft`` at N = 64 over meshes of 2 and 4 virtual
CPU devices.  tests/test_torch_pedersen_device.py and
tests/test_torch_parallel.py hold the port to them (about a minute):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_vectors/make_vectors.py pedersen_lanes sharded_fft

Also ``stump_d256.json``: aztec_tpu's ``StumpTree`` at depth 256 after a
few seeded nullifier updates (``stump_vector``): its roots and one hash
path, which tests/test_torch_stump_tree.py holds the port to:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_vectors/make_vectors.py stump_d256

With ``--card`` the named circuits, all of ``CARD_ONLY``, are proved by
the port (aztec_tpu_torch) on the card instead, in the same record format
with the card as producer; no JAX is imported.  ``rollup_tower`` is the
whole tower of tools/rollup_tower.py (``tower_vector``), two circuits of
2^24 gates, which only the card proves; tests/test_torch_rollup_circuits.py
holds it to aztec_tpu's verifiers:

    python tests/torch_vectors/make_vectors.py --card join_split_d3
    python tests/torch_vectors/make_vectors.py --card rollup_tower
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def counter_rng(seed: int):
    """Deterministic blinding source shared by both packages' provers."""
    state = [seed]

    def rng():
        state[0] += 1
        return (state[0] * 0x9E3779B97F4A7C15F39CC0605CEDC835) % FR_MOD

    return rng


def build_drive1(mod):
    """The 4-gate circuit of the verify recipe (subgroup 16)."""
    c = mod.StandardComposer()
    c.create_dummy_gates()
    c.add_public_variable(123)
    x = c.add_variable(3)
    y = c.add_variable(4)
    z = c.add_variable(12)
    c.create_mul_gate(mod.MulTriple(x, y, z, 1, -1, 0))
    return c


def build_chain(mod, log2n: int):
    """The chain circuit of tools/cross_verify_big.py at 2^log2n gates."""
    c = mod.StandardComposer()
    c.create_dummy_gates()
    c.add_public_variable(0xCAFEBABE)
    a = c.add_variable(3)
    b = c.add_variable(4)
    prod = c.add_variable(12)
    c.create_mul_gate(mod.MulTriple(a, b, prod, 1, -1, 0))
    acc_val, acc = 12, prod
    for _ in range((1 << log2n) - 16):
        acc_val = (acc_val + 3) % FR_MOD
        nxt = c.add_variable(acc_val)
        c.create_add_gate(mod.AddTriple(acc, a, nxt, 1, 1, -1, 0))
        acc = nxt
    assert c.subgroup_size() == 1 << log2n
    return c


def build_turbo_drive(mod):
    """The TurboPlonk circuit of tests/test_turbo.py (subgroup 32)."""
    c = mod.TurboComposer()
    a = c.add_variable(5)
    b = c.add_variable(7)
    prod = c.add_variable(35)
    c.create_mul_gate(mod.MulTriple(a, b, prod, 1, -1, 0))
    s = c.add_variable(12)
    c.create_add_gate(mod.AddTriple(a, b, s, 1, 1, -1, 0))
    q = c.add_variable(59)
    c.create_big_add_gate(a, b, prod, s, 1, 1, 1, 1, -59)
    c.assert_equal(q, c.put_constant_variable(59), "const")
    c.create_range_constraint(s, 8)
    c.create_and_constraint(a, b, 4)
    c.create_xor_constraint(a, b, 4)
    c.add_public_variable(0xDEAD)
    assert not c.failed, c.err
    return c


def build_turbo_pedersen(mod):
    """aztec_tpu_torch/tools/turbo_circuit.py's circuit at 2^10 gates."""
    from aztec_tpu_torch.tools import turbo_circuit

    return turbo_circuit.build(mod.TurboComposer, mod.pedersen,
                               mod.MulTriple, log2n=10, depth=1, ranges=1,
                               logic=1, seed=10)


JOIN_SPLIT_PRIV = 0x0B0B + 7


def join_split_d3_tx(package: str):
    """The depth-3 tx of tests/test_join_split.py, built with the modules
    of ``package`` (``aztec_tpu`` or ``aztec_tpu_torch``)."""
    mod = lambda name: importlib.import_module(f"{package}.{name}")  # noqa: E731
    nn = mod("rollup.notes_native")
    js = mod("rollup.join_split")
    pub = mod("crypto.pedersen").fixed_base_scalar_mul_g1(JOIN_SPLIT_PRIV,
                                                           254)
    in1 = nn.ValueNote(100, 1, 0, pub, 0xAAAA1)
    in2 = nn.ValueNote(50, 1, 0, pub, 0xAAAA2)
    out1 = nn.ValueNote(70, 1, 0, pub, 0xBBBB1)
    out2 = nn.ValueNote(40, 1, 0, pub, 0xBBBB2)
    tree = mod("merkle").MemoryTree(3)
    tree.update_element(0, nn.leaf_bytes(nn.encrypt_note(in1)))
    tree.update_element(1, nn.leaf_bytes(nn.encrypt_note(in2)))
    tx = js.JoinSplitTx(
        public_input=0, public_output=30, asset_id=1, num_input_notes=2,
        input_index=(0, 1), input_note=(in1, in2), output_note=(out1, out2),
        signing_pub_key=pub, signature=(bytes(32), bytes(32)),
        old_data_root=tree.root,
        input_path=(tree.get_hash_path(0), tree.get_hash_path(1)),
        account_index=2, account_path=tree.get_hash_path(2),
        input_owner=0xAA, output_owner=0xBB,
        account_private_key=JOIN_SPLIT_PRIV, alias_hash=0, nonce=0)
    tx.signature = js.sign_tx(tx, JOIN_SPLIT_PRIV, k=0x1234567)
    return tx


ESCAPE_PRIV = JOIN_SPLIT_PRIV


def escape_hatch_tx(package: str, data_depth: int = 3, null_depth: int = 16,
                    root_depth: int = 3, fee: int = 0):
    """The escape-hatch tx of tests/test_escape_hatch.py (two input notes
    of 100 and 50, outputs of 90 and 60 - ``fee``) over a ``WorldState`` of
    the given depths, built with the modules of ``package``; the
    production depths are rollup/constants.py's (32, 256, 28)."""
    mod = lambda name: importlib.import_module(f"{package}.{name}")  # noqa: E731
    nn = mod("rollup.notes_native")
    js = mod("rollup.join_split")
    eh = mod("rollup.escape_hatch")
    pub = mod("crypto.pedersen").fixed_base_scalar_mul_g1(ESCAPE_PRIV, 254)
    ws = mod("rollup.world_state").WorldState(
        data_depth=data_depth, null_depth=null_depth, root_depth=root_depth)
    in1 = nn.ValueNote(100, 1, 0, pub, 0xAAAA1)
    in2 = nn.ValueNote(50, 1, 0, pub, 0xAAAA2)
    out1 = nn.ValueNote(90, 1, 0, pub, 0xBBBB1)
    out2 = nn.ValueNote(60 - fee, 1, 0, pub, 0xBBBB2)
    enc_in = [nn.encrypt_note(in1), nn.encrypt_note(in2)]
    ws.insert_note(0, enc_in[0])
    ws.insert_note(1, enc_in[1])
    tx = js.JoinSplitTx(
        public_input=0, public_output=0, asset_id=1, num_input_notes=2,
        input_index=(0, 1), input_note=(in1, in2), output_note=(out1, out2),
        signing_pub_key=pub, signature=(bytes(32), bytes(32)),
        old_data_root=ws.data_root(),
        input_path=(ws.data_tree.get_hash_path(0),
                    ws.data_tree.get_hash_path(1)),
        account_index=2, account_path=ws.data_tree.get_hash_path(2),
        input_owner=0xAA, output_owner=0xBB,
        account_private_key=ESCAPE_PRIV, alias_hash=0, nonce=0)
    tx.signature = js.sign_tx(tx, ESCAPE_PRIV, k=0x777)

    old_null_root = ws.null_tree.root
    new_null = [ws.insert_nullifier(nn.compute_nullifier(enc, i, ESCAPE_PRIV,
                                                         True))
                for i, enc in enumerate(enc_in)]
    data_start_index = 2
    old_data_path = ws.data_tree.get_hash_path(data_start_index)
    ws.insert_note(2, nn.encrypt_note(out1))
    ws.insert_note(3, nn.encrypt_note(out2))
    new_data_root = ws.data_root()
    old_roots_root = ws.root_tree.root
    old_roots_path = ws.root_tree.get_hash_path(1)
    new_roots_root, _ = ws.insert_data_root(0, new_data_root)
    return eh.EscapeHatchTx(
        js_tx=tx, rollup_id=0, data_start_index=data_start_index,
        new_data_root=new_data_root, old_data_path=old_data_path,
        new_null_roots=tuple(r for r, _ in new_null),
        old_null_paths=tuple(p for _, p in new_null),
        old_null_root=old_null_root, old_data_roots_root=old_roots_root,
        new_data_roots_root=new_roots_root,
        old_data_roots_path=old_roots_path)


def build_join_split_d3(mod):
    """The join-split circuit of ``join_split_d3_tx`` on ``mod``'s
    composer (subgroup 2^16)."""
    c = mod.TurboComposer()
    js = importlib.import_module(f"{mod.package}.rollup.join_split")
    js.join_split_circuit(c, join_split_d3_tx(mod.package))
    assert not c.failed, c.err
    return c


def build_ultra_drive(mod):
    """An UltraPlonk circuit in the manner of tests/test_ultra.py (subgroup
    32): a range and an AND table, a raw lookup gate on a public input, a
    table read, a range decomposition by lookups, arithmetic over the
    looked-up values."""
    lt = mod.lookup_tables
    c = mod.UltraComposer()
    c.add_lookup_table(lt.range_table(3, index=1))
    c.add_lookup_table(lt.and_table(2, index=3))
    x = c.add_public_variable(5)
    c.create_lookup_gate(x, c.zero_idx, c.zero_idx, 1)
    out = c.read_from_table(3, c.add_variable(3), c.add_variable(2))
    v = c.add_variable(46)
    c.create_range_constraint_via_lookup(v, 1, 2, 3)
    s = c.add_variable(51)
    c.create_add_gate(mod.AddTriple(x, v, s, 1, 1, -1, 0))
    p = c.add_variable(102)
    c.create_mul_gate(mod.MulTriple(out, s, p, 1, -1, 0))
    assert not c.failed, c.err
    assert c.subgroup_size() == 32
    return c


def build_mimc_drive(mod):
    """The circuit of tests/test_mimc.py's prove-verify test: MiMC7 of one
    input in MiMC gates, its output public (subgroup 128)."""
    c = mod.MiMCComposer()
    c.create_dummy_gates()
    x = mod.field_t.FieldT.from_witness(c, 41)
    mod.mimc_circuit.mimc7(c, [x], use_mimc_gates=True).set_public()
    assert not c.failed, c.err
    return c


def build_escape_hatch_prod(mod):
    """The escape-hatch circuit at the production tree depths, on
    ``mod``'s TurboComposer (Keccak Turbo: the circuit is verified on
    chain directly)."""
    c = mod.TurboComposer()
    eh = importlib.import_module(f"{mod.package}.rollup.escape_hatch")
    eh.escape_hatch_circuit(c, escape_hatch_tx(mod.package, 32, 256, 28))
    assert not c.failed, c.err
    return c


def build_ultra_2pow20(mod):
    """aztec_tpu_torch/tools/ultra_circuit.py's circuit at 2^20 gates."""
    from aztec_tpu_torch.tools import ultra_circuit

    return ultra_circuit.build(mod.UltraComposer, mod.lookup_tables,
                               mod.MulTriple, mod.AddTriple, log2n=20)


# name: (the circuit, built from a namespace of a package's classes; its
# counter-rng seed)
CIRCUITS = {
    "standard_drive1": (lambda mod: build_drive1(mod), 7),
    "standard_chain8": (lambda mod: build_chain(mod, 8), 8),
    "turbo_drive": (build_turbo_drive, 9),
    "unrolled_turbo_drive": (build_turbo_drive, 9),
    "turbo_pedersen": (build_turbo_pedersen, 10),
    "join_split_d3": (build_join_split_d3, 11),
    "ultra_drive": (build_ultra_drive, 14),
    "unrolled_ultra_drive": (build_ultra_drive, 14),
    "mimc_drive": (build_mimc_drive, 15),
    "ultra_2pow20": (build_ultra_2pow20, 18),
    "escape_hatch_prod": (build_escape_hatch_prod, 19),
}
# proved with create_unrolled_prover (and verified by the unrolled verifier)
UNROLLED = ("unrolled_turbo_drive", "join_split_d3", "unrolled_ultra_drive")
# the circuits whose proving-key planes are written (the rest: bytes only)
PLANES = ("standard_drive1", "standard_chain8", "turbo_drive", "ultra_drive")
# the circuits whose committed record may be the port's own proof on the
# card (``--card``); every other record is aztec_tpu's
CARD_ONLY = ("join_split_d3", "rollup_tower", "ultra_2pow20",
             "escape_hatch_prod")
REFERENCE, CARD = "aztec_tpu", "aztec_tpu_torch/card"
TOWER_SEEDS = (12, 13)  # counter rngs of the inner and the root rollup proof


def gate_digest(c) -> str:
    """sha256 of a Turbo composer's recorded circuit: gates, witnesses,
    copy classes and public inputs."""
    import hashlib

    lists = [c.n, c.variables, list(c.real_variable_index),
             c.next_var_index, c.public_inputs]
    lists += [getattr(c, w) for w in ("w_l", "w_r", "w_o", "w_4")]
    lists += [getattr(c, s) for s in ("q_m", "q_c", "q_1", "q_2", "q_3",
                                      "q_4", "q_5", "q_arith", "q_ecc_1",
                                      "q_range", "q_logic")]
    return hashlib.sha256(json.dumps(lists).encode()).hexdigest()


def recursive_vk_case(pkg: str):
    """Two unrolled-Turbo VKs of package ``pkg`` with seeded on-curve
    commitments (tests/test_recursion_verifier.py's ``_fake_vk``, seeds 5
    and 900): the key and another of the set."""
    pairing = importlib.import_module(f"{pkg}.curves.pairing")
    manifests = importlib.import_module(f"{pkg}.plonk.manifests")
    proving_key = importlib.import_module(f"{pkg}.plonk.proving_key")
    labels = [item.commitment_label
              for item in manifests.UNROLLED_TURBO.polynomial_manifest
              if item.source != "witness"]

    def vk(seed):
        return proving_key.VerificationKey(
            n=16, num_public_inputs=2,
            commitments={lab: pairing.g1_mul(seed + i * 7 + 1, (1, 2))
                         for i, lab in enumerate(labels)},
            domain_root=pow(5, (FR_MOD - 1) // 16, FR_MOD),
            g2_x=((1, 2), (3, 4)), settings=manifests.UNROLLED_TURBO)
    return vk(5), vk(900)


def recursive_vk_circuit(pkg: str, c) -> int:
    """On composer ``c``: the key of ``recursive_vk_case`` as witnesses,
    its in-circuit compression, and its membership of the set (the other
    key first).  Returns the compression's value."""
    rv = importlib.import_module(f"{pkg}.stdlib.recursion_verifier")
    vk, other = recursive_vk_case(pkg)
    rvk = rv.RecursiveVK.from_witness(c, vk)
    value = rvk.compress(c).get_value()
    rvk.validate_key_is_in_set(c, [other, vk])
    return value


def recursive_vk_vector() -> None:
    """``recursive_vk.json``: aztec_tpu's native compression of the key
    and the gate digest of ``recursive_vk_circuit``."""
    from aztec_tpu.plonk.circuit_check import check_turbo
    from aztec_tpu.plonk.composer import TurboComposer
    from aztec_tpu.stdlib.recursion_verifier import RecursiveVK

    c = TurboComposer()
    value = recursive_vk_circuit("aztec_tpu", c)
    native = RecursiveVK.compress_native(recursive_vk_case("aztec_tpu")[0])
    if value != native or c.failed or check_turbo(c):
        raise AssertionError("recursive_vk: aztec_tpu's circuit is wrong")
    with open(os.path.join(HERE, "recursive_vk.json"), "w") as f:
        json.dump({"producer": REFERENCE, "compressed": hex(native),
                   "gate_digest": gate_digest(c), "gates": c.n}, f, indent=1)
    print(f"recursive_vk: written, {c.n} gates", flush=True)


def tower_vector() -> None:
    """``rollup_tower.json``: the rollup tower proved by the port on the
    card, as tools/rollup_tower.py builds it (one tx, WorldState(6, 16,
    4), the depth-6 join-split padding proof made in a fresh fixture
    directory): the inner rollup proof (unrolled Turbo) with its VK and
    the root rollup proof (Turbo, Keccak) with its VK, each proof under a
    counter rng of ``TOWER_SEEDS`` and verified by the port."""
    import dataclasses
    import tempfile

    os.environ["AZTEC_FIXTURES"] = tempfile.mkdtemp(prefix="tower_vector_")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    from aztec_tpu_torch.plonk import manifests
    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.rollup.circuit_data import join_split_circuit_data
    from aztec_tpu_torch.rollup.create_rollup import (create_rollup_tx,
                                                      create_root_rollup_tx)
    from aztec_tpu_torch.rollup.rollup_circuit import rollup_circuit
    from aztec_tpu_torch.rollup.root_rollup_circuit import root_rollup_circuit
    from aztec_tpu_torch.rollup.world_state import WorldState
    from aztec_tpu_torch.srs.reference_string import FakeReferenceStringFactory
    from aztec_tpu_torch.utils.fixtures import vk_to_json

    crs = FakeReferenceStringFactory(device="cuda")
    cd = join_split_circuit_data(device="cuda")
    ws = WorldState(data_depth=6, null_depth=16, root_depth=4)
    rtx = create_rollup_tx(ws, 0, [cd.padding_proof], rollup_size=1)
    out = {"producer": CARD}
    for stage, seed in zip(("inner", "root"), TOWER_SEEDS):
        c = TurboComposer(crs_factory=crs, device="cuda")
        if stage == "inner":
            rollup_circuit(c, rtx, [cd.vk], rollup_size=1)
            prover = c.create_unrolled_prover()
        else:
            root_tx = create_root_rollup_tx(ws, 0, [inner], rtx.new_data_root)
            root_rollup_circuit(c, root_tx, inner_rollup_size=1,
                                outer_rollup_size=1,
                                inner_verification_key=inner_vk)
            prover = c.create_prover()
        if c.failed:
            raise AssertionError(f"rollup_tower {stage}: {c.err}")
        prover.rng = counter_rng(seed)
        proof = prover.construct_proof()
        del prover
        vk = c.compute_verification_key()
        verifier = (c.create_unrolled_verifier() if stage == "inner"
                    else c.create_verifier())
        if not verifier.verify_proof(proof):
            raise AssertionError(f"rollup_tower {stage}: the port rejects "
                                 "its proof")
        if stage == "inner":
            inner = proof
            inner_vk = vk = dataclasses.replace(
                vk, settings=manifests.UNROLLED_TURBO)
        out[stage] = {"gates": c.n, "n": vk.n, "rng_seed": seed,
                      "proof": proof.hex(), "vk": vk_to_json(vk)}
        print(f"rollup_tower {stage}: {c.n} gates, n={vk.n}, proof="
              f"{len(proof)} bytes, verified", flush=True)
        del c, verifier
    with open(os.path.join(HERE, "rollup_tower.json"), "w") as f:
        json.dump(out, f, indent=1)


STUMP_SEED = 7
STUMP_UPDATES = 3


def stump_vector() -> None:
    """``stump_d256.json``: aztec_tpu's ``StumpTree`` at depth 256 (the
    production nullifier tree) after ``STUMP_UPDATES`` nullifiers of
    ``random.Random(STUMP_SEED)`` (254 bits each, leaf value 1): the empty
    root, the root after each update and the first nullifier's hash path.
    tests/test_torch_stump_tree.py holds the port to them (aztec_tpu's
    tree takes minutes at this depth)."""
    import random

    from aztec_tpu.merkle.sparse_tree import MemoryStore
    from aztec_tpu.merkle.stump_tree import StumpTree

    rng = random.Random(STUMP_SEED)
    tree = StumpTree(MemoryStore(), 256)
    out = {"producer": REFERENCE, "seed": STUMP_SEED, "empty": hex(tree.root),
           "nullifiers": [], "roots": []}
    for _ in range(STUMP_UPDATES):
        n = rng.getrandbits(254)
        tree.update_element(n, (1).to_bytes(64, "big"))
        out["nullifiers"].append(hex(n))
        out["roots"].append(hex(tree.root))
    first = int(out["nullifiers"][0], 16)
    out["path"] = [[hex(a), hex(b)] for a, b in tree.get_hash_path(first)]
    with open(os.path.join(HERE, "stump_d256.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"stump_d256: written, {STUMP_UPDATES} updates", flush=True)


def make_prover(c, name: str):
    return (c.create_unrolled_prover() if name in UNROLLED
            else c.create_prover())


def make_verifier(c, name: str):
    return (c.create_unrolled_verifier() if name in UNROLLED
            else c.create_verifier())


QUOTIENT_N = 16
QUOTIENT_SEED = 16


def _field_draws(rng):
    """field(*shape): uint32 (16, *shape) Montgomery-agnostic planes of
    uniform Fr elements drawn from ``rng``."""
    def field(*shape):
        words = rng.integers(0, 1 << 63, (4,) + shape, dtype=np.int64)
        vals = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            v = sum(int(words[(k,) + idx]) << (63 * k) for k in range(4))
            vals[idx] = v % FR_MOD
        out = np.zeros((16,) + shape, np.uint32)
        for idx in np.ndindex(*shape):
            for i in range(16):
                out[(i,) + idx] = (vals[idx] >> (16 * i)) & 0xFFFF
        return out
    return field


def quotient_inputs(n: int = QUOTIENT_N, seed: int = QUOTIENT_SEED) -> dict:
    """Seeded inputs of ``turbo_quotient`` at subgroup size n: uint32
    Montgomery planes of uniform Fr elements (every selector random, so
    non-zero), wires and sigmas (16, 4, 4n), selectors (16, 11, 4n),
    alphas (16, 21) drawn independently, so that a misplaced power shows."""
    field = _field_draws(np.random.default_rng(seed))
    m = 4 * n
    return {"wffts": field(4, m), "sffts": field(4, m), "zfft": field(m),
            "qffts": field(11, m), "l1fft": field(m), "coset_pts": field(m),
            "vanish_scale": field(m), "alphas": field(21), "beta": field(1),
            "gamma": field(1), "delta": field(1)}


QUOTIENT_ARGS = ("wffts", "sffts", "zfft", "qffts", "l1fft", "coset_pts",
                 "vanish_scale", "alphas", "beta", "gamma", "delta")


def quotient_vectors() -> None:
    import jax.numpy as jnp

    from aztec_tpu.plonk import kernels

    ins = quotient_inputs()
    out = kernels.turbo_quotient(*(jnp.asarray(ins[k]) for k in QUOTIENT_ARGS),
                                 QUOTIENT_N)
    np.savez_compressed(os.path.join(HERE, "turbo_quotient.npz"),
                        out=np.asarray(out).astype(np.uint16))
    print("turbo_quotient: written", flush=True)

ULTRA_SEED = 17


def ultra_inputs(n: int = QUOTIENT_N, seed: int = ULTRA_SEED) -> dict:
    """Seeded inputs of the lookup grand product (n lanes), the Ultra and
    MiMC quotients (4n lanes) and the elliptic identity (n rows): uniform
    Fr planes, every selector random and every power of alpha drawn on its
    own, so that a misplaced term shows."""
    field = _field_draws(np.random.default_rng(seed))
    m = 4 * n
    return {
        # lookup_grand_product
        "wires": field(3, n), "q_lookup": field(n), "q_index": field(n),
        "tables": field(4, n), "h1": field(n), "h2": field(n),
        "randoms": field(3),
        # ultra_quotient
        "wffts": field(4, m), "sffts": field(4, m), "zfft": field(m),
        "qffts": field(11, m), "tffts": field(4, m), "qlfft": field(m),
        "qifft": field(m), "s1fft": field(m), "s2fft": field(m),
        "zlfft": field(m), "l1fft": field(m), "coset_pts": field(m),
        "vanish_scale": field(m), "alphas": field(24), "eta": field(1),
        "beta": field(1), "gamma": field(1), "delta": field(1),
        # mimc_quotient (its wires, sigmas and selectors the first 3 / 7)
        "alpha": field(1),
        # elliptic_identity
        "ell_w": field(4, n), "ell_q": field(4, n), "alpha2": field(1),
    }


LOOKUP_Z_ARGS = ("wires", "q_lookup", "q_index", "tables", "h1", "h2",
                 "eta", "beta", "gamma", "randoms")
ULTRA_ARGS = ("wffts", "sffts", "zfft", "qffts", "tffts", "qlfft", "qifft",
              "s1fft", "s2fft", "zlfft", "l1fft", "coset_pts",
              "vanish_scale", "alphas", "eta", "beta", "gamma", "delta")


def mimc_args(ins: dict) -> tuple:
    """``mimc_quotient``'s arguments from ``ultra_inputs``."""
    return (ins["wffts"][:, :3], ins["sffts"][:, :3], ins["zfft"],
            ins["qffts"][:, :7], ins["l1fft"], ins["coset_pts"],
            ins["vanish_scale"], ins["alpha"], ins["beta"], ins["gamma"],
            ins["delta"])


def elliptic_args(ins: dict) -> tuple:
    """``elliptic_identity``'s arguments from ``ultra_inputs``."""
    q = ins["ell_q"]
    return (ins["ell_w"], q[:, 0], q[:, 1], q[:, 2], q[:, 3], ins["alpha"],
            ins["alpha2"])


def ultra_quotient_vectors() -> None:
    """``ultra_quotient.npz``: the reference's ``lookup_grand_product``,
    ``ultra_quotient``, ``mimc_quotient`` and ``elliptic_identity`` on
    ``ultra_inputs``."""
    import jax.numpy as jnp

    from aztec_tpu.plonk import kernels

    ins = ultra_inputs()
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    out = {
        "lookup_z": kernels.lookup_grand_product(
            *j(ins[k] for k in LOOKUP_Z_ARGS), QUOTIENT_N),
        "ultra": kernels.ultra_quotient(*j(ins[k] for k in ULTRA_ARGS),
                                        QUOTIENT_N),
        "mimc": kernels.mimc_quotient(*j(mimc_args(ins)), QUOTIENT_N),
        "elliptic": kernels.elliptic_identity(*j(elliptic_args(ins))),
    }
    np.savez_compressed(os.path.join(HERE, "ultra_quotient.npz"),
                        **{k: np.asarray(v).astype(np.uint16)
                           for k, v in out.items()})
    print("ultra_quotient: written", flush=True)


POW_LANES = 16
POW_SEED = 7


def pow_exponents(p: int):
    """The exponents of mont_pow.npz, in their order."""
    return (p - 2, 1 << 100, 0, 1)


def pow_inputs(p: int) -> np.ndarray:
    """(16, POW_LANES) uint16 limbs: 0, 1, p - 1, p, p + 1, 2p - 1, all
    0xFFFF, five canonical random elements, four lanes of uniform limbs."""
    rng = np.random.default_rng(POW_SEED + p % 7)
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1, (1 << 256) - 1]
    vals += [int(rng.integers(0, 1 << 62)) ** 4 % p for _ in range(5)]
    vals += [sum(int(w) << (16 * i) for i, w in
                 enumerate(rng.integers(0, 1 << 16, 16)))
             for _ in range(POW_LANES - len(vals))]
    return np.array([[(v >> (16 * i)) & 0xFFFF for v in vals]
                     for i in range(16)], dtype=np.uint16)


def pow_vectors() -> None:
    import jax.numpy as jnp

    from aztec_tpu.ff import FQ, FR, limb

    out = {}
    for name, spec in (("fr", FR), ("fq", FQ)):
        A = pow_inputs(spec.modulus)
        a = jnp.asarray(A.astype(np.uint32))
        out[f"{name}_in"] = A
        for k, e in enumerate(pow_exponents(spec.modulus)):
            bits = np.array([(e >> i) & 1 for i in range(max(e.bit_length(),
                                                              1))],
                            np.uint32)
            out[f"{name}_pow{k}"] = np.asarray(limb.mont_pow(a, bits, spec))
        out[f"{name}_inv"] = np.asarray(limb.inv_mont(a, spec))
        out[f"{name}_batch_inv"] = np.asarray(
            limb.batch_inv_mont(a[:, :, None], spec, axis=-1))[:, :, 0]
    np.savez_compressed(os.path.join(HERE, "mont_pow.npz"),
                        **{k: v.astype(np.uint16) for k, v in out.items()})
    print("mont_pow: written", flush=True)


PEDERSEN_SEED = 23
PEDERSEN_INDICES = (0, 1)


def pedersen_lane_values() -> list:
    """The lanes of ``pedersen_lanes.npz``: 0, 1, 2, p - 1, a value whose
    base is even (the skew), and three seeded field elements."""
    rng = np.random.default_rng(PEDERSEN_SEED)
    return [0, 1, 2, FR_MOD - 1, 0xDEADBEEF] + [
        int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(3)]


def pedersen_vectors() -> None:
    """``pedersen_lanes.npz``: aztec_tpu's ``hash_single_batch`` Jacobian
    limbs (X, Y, Z) of ``pedersen_lane_values`` at each hash index of
    PEDERSEN_INDICES."""
    import jax.numpy as jnp

    from aztec_tpu.crypto.pedersen_device import hash_single_batch
    from aztec_tpu.numeric.bigint import ints_to_limbs

    vals = jnp.asarray(ints_to_limbs(pedersen_lane_values()))
    out = {}
    for i in PEDERSEN_INDICES:
        for name, plane in zip("XYZ", hash_single_batch(vals, i)):
            out[f"h{i}_{name}"] = np.asarray(plane).astype(np.uint16)
    np.savez_compressed(os.path.join(HERE, "pedersen_lanes.npz"), **out)
    print("pedersen_lanes: written", flush=True)


SHARDED_FFT_N = 64
SHARDED_FFT_SEED = 5
SHARDED_FFT_D = (2, 4)


def sharded_fft_coeffs() -> np.ndarray:
    """(16, SHARDED_FFT_N) uint16 Montgomery limbs of seeded coefficients."""
    rng = np.random.default_rng(SHARDED_FFT_SEED)
    r = 1 << 256
    vals = [int.from_bytes(rng.bytes(32), "little") % FR_MOD * r % FR_MOD
            for _ in range(SHARDED_FFT_N)]
    return np.array([[(v >> (16 * i)) & 0xFFFF for v in vals]
                     for i in range(16)], dtype=np.uint16)


def sharded_fft_vectors() -> None:
    """``sharded_fft.npz``: aztec_tpu's ``sharded_coset_fft`` of
    ``sharded_fft_coeffs`` over meshes of SHARDED_FFT_D virtual CPU devices
    (XLA_FLAGS carries the device count: ``main`` sets it before JAX
    starts)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from aztec_tpu.parallel.sharded_fft import sharded_coset_fft
    from aztec_tpu.poly.domain import EvaluationDomain

    x = jnp.asarray(sharded_fft_coeffs().astype(np.uint32))
    out = {}
    for D in SHARDED_FFT_D:
        mesh = Mesh(np.array(jax.devices()[:D]), ("dp",))
        out[f"d{D}"] = np.asarray(sharded_coset_fft(
            mesh, "dp", x, EvaluationDomain(SHARDED_FFT_N))).astype(np.uint16)
    np.savez_compressed(os.path.join(HERE, "sharded_fft.npz"), **out)
    print("sharded_fft: written", flush=True)


def record(name: str, c, prover, proof: bytes, producer: str) -> dict:
    """The JSON record of a vector: the keyed composer ``c``, its prover,
    the proof and the package that proved it."""
    vk = c.compute_verification_key()
    return {
        "producer": producer,
        "n": vk.n,
        "rng_seed": CIRCUITS[name][1],
        "public_inputs": [hex(v) for v in prover.public_values],
        "proof": proof.hex(),
        "vk": {k: None if v is None else [hex(v[0]), hex(v[1])]
               for k, v in vk.commitments.items()},
    }


def card_vectors(names) -> None:
    """Prove ``names`` (all of CARD_ONLY) with the port on the card and
    write their records."""
    import plonk_cases

    refused = [name for name in names if name not in CARD_ONLY]
    if refused:
        raise SystemExit(f"--card writes only {CARD_ONLY}, not {refused}: "
                         "the other records are aztec_tpu's proofs")
    mod = plonk_cases.port_classes("cuda")
    for name in names:
        if name == "rollup_tower":
            tower_vector()
            continue
        build, seed = CIRCUITS[name]
        c = build(mod)
        prover = make_prover(c, name)
        prover.rng = counter_rng(seed)
        proof = prover.construct_proof()
        if not make_verifier(c, name).verify_proof(proof):
            raise AssertionError(f"{name}: the port rejects its proof")
        rec = record(name, c, prover, proof, CARD)
        if name in ("ultra_2pow20", "escape_hatch_prod"):
            # the whole VK (its settings, domain root and G2 point), so
            # that aztec_tpu's vk_from_json rebuilds it
            from aztec_tpu_torch.utils.fixtures import vk_to_json

            rec.update(gates=c.n, vk_json=vk_to_json(
                c.compute_verification_key()))
        with open(os.path.join(HERE, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"{name}: proved on the card, n={c.subgroup_size()} "
              f"proof={len(proof)} bytes, verified", flush=True)


def main() -> None:
    from types import SimpleNamespace

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if "--card" in sys.argv:
        card_vectors(args)
        return

    only = set(args)
    if not only or "sharded_fft" in only:
        # the virtual devices of the sharded FFT's meshes, before JAX starts
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_"
            f"device_count={max(SHARDED_FFT_D)}")
    from aztec_tpu.utils import setup_compile_cache

    setup_compile_cache()
    from aztec_tpu.plonk import composer as comp
    from aztec_tpu.plonk import lookup_tables
    from aztec_tpu.stdlib import field_t, mimc_circuit, pedersen_circuit

    mod = SimpleNamespace(package="aztec_tpu",
                          StandardComposer=comp.StandardComposer,
                          TurboComposer=comp.TurboComposer,
                          UltraComposer=comp.UltraComposer,
                          MiMCComposer=comp.MiMCComposer,
                          lookup_tables=lookup_tables, field_t=field_t,
                          mimc_circuit=mimc_circuit,
                          pedersen=pedersen_circuit,
                          MulTriple=comp.MulTriple, AddTriple=comp.AddTriple)
    if not only or "mont_pow" in only:
        pow_vectors()
    if not only or "pedersen_lanes" in only:
        pedersen_vectors()
    if not only or "sharded_fft" in only:
        sharded_fft_vectors()
    if not only or "turbo_quotient" in only:
        quotient_vectors()
    if not only or "ultra_quotient" in only:
        ultra_quotient_vectors()
    if not only or "recursive_vk" in only:
        recursive_vk_vector()
    if not only or "stump_d256" in only:
        stump_vector()
    for name, (build, seed) in CIRCUITS.items():
        if name not in only and (only or name in CARD_ONLY):
            continue
        c = build(mod)
        prover = make_prover(c, name)
        prover.rng = counter_rng(seed)
        proof = prover.construct_proof()
        pk = c.compute_proving_key()
        if name in PLANES:
            planes = {}
            for s, store in pk.selectors.items():
                planes[f"{s}_monomial"] = np.asarray(store.monomial)
                if store.lagrange is not None:  # Ultra's tables, q_lookup
                    planes[f"{s}_lagrange"] = np.asarray(store.lagrange)
            for s, store in pk.sigmas.items():
                planes[f"{s}_monomial"] = np.asarray(store.monomial)
                planes[f"{s}_lagrange"] = np.asarray(store.lagrange)
            np.savez_compressed(
                os.path.join(HERE, f"{name}.npz"),
                **{k: v.astype(np.uint16) for k, v in planes.items()})
        with open(os.path.join(HERE, f"{name}.json"), "w") as f:
            json.dump(record(name, c, prover, proof, REFERENCE), f,
                      indent=1)
        ok = make_verifier(c, name).verify_proof(proof)
        print(f"{name}: n={pk.n} proof={len(proof)} bytes verified={ok}",
              flush=True)
        if not ok:
            raise AssertionError(f"{name}: the reference rejects its proof")


if __name__ == "__main__":
    main()
