"""Circuit data: verification keys + noop (padding) proofs, computed once
and persisted (ref: rollup/proofs/compute_circuit_data.hpp,
join_split/create_noop_join_split_proof.cpp, account/compute_circuit_data).

The rollup circuit verifies `rollup_size` proofs unconditionally, so
rollups with fewer real txs are padded with a REAL proof of a noop
join_split (zero values, zero input notes).

Port of aztec_tpu/rollup/circuit_data.py: the circuits are proved on
``device`` (the card unless ``"cpu"`` is given), and persisted in the
port's own fixture directory (``utils/fixtures.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..crypto import pedersen as pd
from ..utils import fixtures
from .join_split import JoinSplitTx, join_split_circuit, sign_tx
from .world_state import WorldState
from . import notes_native as nn

# shallow defaults for this box; production uses rollup.constants depths
DEFAULT_DATA_DEPTH = 6

_NOOP_PRIV = 0x0B0B


def noop_join_split_tx(data_depth: int = DEFAULT_DATA_DEPTH) -> JoinSplitTx:
    """A valid do-nothing join_split (ref:
    create_noop_join_split_proof.cpp): zero input notes, zero values."""
    pub = pd.fixed_base_scalar_mul_g1(_NOOP_PRIV, 254)
    ws = WorldState(data_depth=data_depth)
    zero_note = lambda secret: nn.ValueNote(0, 0, 0, pub, secret)  # noqa: E731
    tx = JoinSplitTx(
        public_input=0, public_output=0, asset_id=0, num_input_notes=0,
        input_index=(0, 1),
        input_note=(zero_note(0xA1), zero_note(0xA2)),
        output_note=(zero_note(0xB1), zero_note(0xB2)),
        signing_pub_key=pub, signature=(bytes(32), bytes(32)),
        old_data_root=ws.data_root(),
        input_path=(ws.data_tree.get_hash_path(0),
                    ws.data_tree.get_hash_path(1)),
        account_index=0, account_path=ws.data_tree.get_hash_path(0),
        input_owner=0, output_owner=0,
        account_private_key=_NOOP_PRIV, alias_hash=0, nonce=0,
    )
    tx.signature = sign_tx(tx, _NOOP_PRIV, k=0xD00D)
    return tx


@dataclasses.dataclass
class CircuitData:
    """ref: compute_circuit_data.hpp circuit_data (proving keys live in
    the composer here; we persist vk + padding proof)."""
    vk: object
    padding_proof: bytes


def _build_join_split_data(data_depth: int, device) -> Tuple[bytes, object]:
    from ..plonk.composer import TurboComposer
    from ..plonk import manifests
    from ..srs.reference_string import FakeReferenceStringFactory

    tx = noop_join_split_tx(data_depth)
    c = TurboComposer(crs_factory=FakeReferenceStringFactory(device=device),
                      device=device)
    join_split_circuit(c, tx)
    assert not c.failed, c.err
    proof = c.create_unrolled_prover().construct_proof()
    vk = dataclasses.replace(c.compute_verification_key(),
                             settings=manifests.UNROLLED_TURBO)
    return proof, vk


def join_split_circuit_data(data_depth: int = DEFAULT_DATA_DEPTH,
                            device="cuda") -> CircuitData:
    """compute-or-load the join_split VK + noop padding proof
    (ref: join_split/compute_circuit_data.hpp)."""
    proof, vk = fixtures.compute_or_load_proof_and_vk(
        f"join_split_circuit_data_d{data_depth}",
        lambda: _build_join_split_data(data_depth, device), version="1")
    return CircuitData(vk=vk, padding_proof=proof)


def _build_account_data(device) -> Tuple[bytes, object]:
    from ..merkle import MemoryTree
    from ..plonk.composer import TurboComposer
    from ..plonk import manifests
    from ..srs.reference_string import FakeReferenceStringFactory
    from .account import AccountTx, account_circuit
    from .account import sign_tx as account_sign_tx

    pub = pd.fixed_base_scalar_mul_g1(_NOOP_PRIV, 254)
    spend = pd.fixed_base_scalar_mul_g1(0x51, 254)
    tree = MemoryTree(3)
    tx = AccountTx(
        merkle_root=tree.root, account_public_key=pub,
        new_account_public_key=pub, new_signing_pub_key_1=spend,
        new_signing_pub_key_2=spend, alias_hash=0xA11A5, nonce=0,
        migrate=True, gibberish=0x61BB, account_index=0,
        account_path=tree.get_hash_path(0), signing_pub_key=spend,
        signature=(bytes(32), bytes(32)),
    )
    tx.signature = account_sign_tx(tx, _NOOP_PRIV, k=0xD00D)
    c = TurboComposer(crs_factory=FakeReferenceStringFactory(device=device),
                      device=device)
    account_circuit(c, tx)
    assert not c.failed, c.err
    proof = c.create_unrolled_prover().construct_proof()
    vk = dataclasses.replace(c.compute_verification_key(),
                             settings=manifests.UNROLLED_TURBO)
    return proof, vk


def account_circuit_data(device="cuda") -> CircuitData:
    """compute-or-load the account-circuit VK + a sample proof
    (ref: account/compute_circuit_data.hpp)."""
    proof, vk = fixtures.compute_or_load_proof_and_vk(
        "account_circuit_data", lambda: _build_account_data(device),
        version="1")
    return CircuitData(vk=vk, padding_proof=proof)
