"""The port's escape-hatch circuit against the JAX package, on the CPU.

Mirrors tests/test_escape_hatch.py: the depth-3 tx of make_vectors.py's
``escape_hatch_tx`` recorded on the port's TurboComposer is aztec_tpu's
circuit (gates, public inputs, ``gate_digest``: witnesses, wires,
selectors and copy cycles) and satisfies ``check_turbo``; a non-zero fee
and a wrong nullifier root fail.  The card's production-depth proof
(``escape_hatch_prod``, make_vectors.py ``--card``: data tree 32,
nullifier tree 256, root tree 28) is accepted by aztec_tpu's Turbo
verifier.  Host only; nothing is proved on the CPU.
"""

import copy
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import make_vectors as mv  # noqa: E402
import plonk_cases  # noqa: E402

PACKAGES = ("aztec_tpu_torch", "aztec_tpu")


@functools.lru_cache(maxsize=None)
def _tx(package: str):
    return mv.escape_hatch_tx(package)


def _circuit(package: str, tx):
    import importlib

    comp = importlib.import_module(f"{package}.plonk.composer")
    eh = importlib.import_module(f"{package}.rollup.escape_hatch")
    c = (comp.TurboComposer(device="cpu") if package == "aztec_tpu_torch"
         else comp.TurboComposer())
    eh.escape_hatch_circuit(c, tx)
    return c


@functools.lru_cache(maxsize=None)
def _valid(package: str):
    return _circuit(package, _tx(package))


def test_escape_hatch_valid_matches_reference():
    from aztec_tpu_torch.plonk.circuit_check import check_turbo

    mine, theirs = (_valid(p) for p in PACKAGES)
    assert not mine.failed, mine.err
    assert mine.n == theirs.n
    # rollup-shaped public inputs: 9 + NUM_ASSETS + 1 + 12
    assert len(mine.public_inputs) == 9 + 4 + 1 + 12
    assert ([mine.get_variable(i) for i in mine.public_inputs]
            == [theirs.get_variable(i) for i in theirs.public_inputs])
    assert mv.gate_digest(mine) == mv.gate_digest(theirs)
    assert check_turbo(mine) == []


def test_escape_hatch_is_exported():
    from aztec_tpu_torch import rollup
    from aztec_tpu_torch.rollup import escape_hatch

    assert rollup.escape_hatch_circuit is escape_hatch.escape_hatch_circuit
    assert rollup.EscapeHatchTx is escape_hatch.EscapeHatchTx


def _fails(tx) -> bool:
    from aztec_tpu_torch.plonk.circuit_check import check_turbo

    c = _circuit("aztec_tpu_torch", tx)
    return c.failed or check_turbo(c) != []


def test_escape_hatch_nonzero_fee_fails():
    from aztec_tpu_torch.rollup.join_split import sign_tx

    tx = copy.deepcopy(_tx("aztec_tpu_torch"))
    tx.js_tx.output_note[1].value -= 1  # creates a fee of 1
    tx.js_tx.signature = sign_tx(tx.js_tx, mv.ESCAPE_PRIV, k=0x777)
    assert _fails(tx)


def test_escape_hatch_wrong_null_root_fails():
    tx = copy.deepcopy(_tx("aztec_tpu_torch"))
    tx.new_null_roots = (tx.new_null_roots[0], tx.new_null_roots[1] ^ 1)
    assert _fails(tx)


def test_card_production_proof_verified_by_reference():
    """The port's Keccak Turbo proof of the escape hatch at the production
    depths, made on the card, accepted by aztec_tpu's Turbo verifier with
    its VK; its 26 public inputs are the tx's; a tamper rejected."""
    from aztec_tpu.plonk.flavors import TurboFlavor
    from aztec_tpu.plonk.verifier import Verifier
    from aztec_tpu.utils.fixtures import vk_from_json

    rec, _ = plonk_cases.load_vector("escape_hatch_prod")
    assert rec["producer"] == mv.CARD
    vk = vk_from_json(rec["vk_json"])
    assert vk.settings.name == "turbo" and vk.n == rec["n"]
    assert vk.num_public_inputs == len(rec["public_inputs"]) == 26
    assert vk.commitments == plonk_cases.vk_ints(rec)
    # rollup id 0, rollup size 0 (the escape hatch), data start index 2
    assert [int(v, 16) for v in rec["public_inputs"][:3]] == [0, 0, 2]
    proof = bytes.fromhex(rec["proof"])
    v = Verifier(vk, TurboFlavor)
    assert v.verify_proof(proof)
    assert not v.verify_proof(plonk_cases.tampered(proof))


def test_tree_depths_reach_the_tx():
    tx = _tx("aztec_tpu_torch")
    assert len(tx.old_data_path) == 3
    assert all(len(p) == 16 for p in tx.old_null_paths)
    assert len(tx.old_data_roots_path) == 3
