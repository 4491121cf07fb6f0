"""account: key-registration circuit (ref: rollup/proofs/account/account.cpp).

Registers/migrates an account: binds (alias_hash, nonce) to an account
public key and two spending keys via account notes, emitting nullifiers
that enforce alias uniqueness.  Proven with unrolled turbo settings like
join_split so the rollup circuit can aggregate both through one VK set.

Port of aztec_tpu/rollup/account.py, on the port's composers: host Python,
so the same inputs record the same gates.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..crypto import pedersen as pd
from ..crypto import schnorr
from ..ff.bn254 import FR_MOD
from ..stdlib.field_t import FieldT, BoolT
from ..stdlib import pedersen_circuit as pc
from ..stdlib.pedersen_circuit import Point
from ..stdlib.byte_array import field_to_bytes
from ..stdlib.group_native import NativePoint
from ..stdlib.merkle_circuit import (
    check_membership_bool,
    hash_leaf_xy,
    index_bits_from_field,
)
from ..stdlib import schnorr_circuit
from . import constants as C
from .notes_native import account_alias_id as alias_id_native
from .notes_circuit import encrypt_account_note

M = FR_MOD
HashPath = List[Tuple[int, int]]
GPoint = Tuple[int, int]


@dataclasses.dataclass
class AccountTx:
    """ref: account/account_tx.hpp."""
    merkle_root: int
    account_public_key: GPoint
    new_account_public_key: GPoint
    new_signing_pub_key_1: GPoint
    new_signing_pub_key_2: GPoint
    alias_hash: int
    nonce: int
    migrate: bool
    gibberish: int
    account_index: int
    account_path: HashPath
    signing_pub_key: GPoint
    signature: Tuple[bytes, bytes]


def compute_signing_data(tx: AccountTx) -> bytes:
    """Native signing message (ref: account_tx.cpp sign)."""
    aid = alias_id_native(tx.alias_hash, tx.nonce)
    msg = pd.compress_many([
        aid, tx.account_public_key[0], tx.new_account_public_key[0],
        tx.new_signing_pub_key_1[0], tx.new_signing_pub_key_2[0],
    ], 0)
    return msg.to_bytes(32, "big")


def sign_tx(tx: AccountTx, signing_private_key: int,
            k: Optional[int] = None) -> Tuple[bytes, bytes]:
    return schnorr.construct_signature(compute_signing_data(tx),
                                       signing_private_key, k=k)


def compute_account_alias_id_nullifier(proof_id: FieldT,
                                       account_alias_id: FieldT,
                                       gibberish: FieldT,
                                       migrate: BoolT) -> FieldT:
    """ref: account.cpp:23-30."""
    gated = gibberish * (~migrate).to_field()
    return pc.compress_many([proof_id, account_alias_id, gated.normalize()],
                            C.ACCOUNT_ALIAS_ID_HASH_INDEX)


def compute_gibberish_nullifier(proof_id: FieldT,
                                gibberish: FieldT) -> FieldT:
    """ref: account.cpp:32-35."""
    return pc.compress_many([proof_id, gibberish],
                            C.ACCOUNT_GIBBERISH_HASH_INDEX)


def account_circuit(ctx, tx: AccountTx) -> None:
    """ref: account.cpp:37-122 — same witness layout and the 14
    InnerProofFields public inputs."""
    proof_id = FieldT.from_witness(ctx, 1)
    nonce = FieldT.from_witness(ctx, tx.nonce)
    alias_hash = FieldT.from_witness(ctx, tx.alias_hash)
    migrate = BoolT.from_witness(ctx, tx.migrate)
    gibberish = FieldT.from_witness(ctx, tx.gibberish)

    def point_witness(pt: GPoint, validate: bool = True) -> Point:
        p = Point(FieldT.from_witness(ctx, pt[0]),
                  FieldT.from_witness(ctx, pt[1]))
        if validate:
            NativePoint(p.x, p.y).validate_on_curve()
        return p

    account_public_key = point_witness(tx.account_public_key)
    new_account_public_key = point_witness(tx.new_account_public_key)
    spending_public_key_1 = point_witness(tx.new_signing_pub_key_1, False)
    spending_public_key_2 = point_witness(tx.new_signing_pub_key_2, False)
    account_note_index = FieldT.from_witness(ctx, tx.account_index)
    account_path = [(FieldT.from_witness(ctx, l), FieldT.from_witness(ctx, r))
                    for (l, r) in tx.account_path]
    signing_pub_key = point_witness(tx.signing_pub_key)
    data_tree_root = FieldT.from_witness(ctx, tx.merkle_root)

    ctx.create_range_constraint(alias_hash.witness_index, 224)
    account_alias_id = (alias_hash + nonce * (1 << 224)).normalize()
    output_nonce = (nonce + migrate.to_field()).normalize()
    output_account_alias_id = (alias_hash
                               + output_nonce * (1 << 224)).normalize()

    output_note_1 = encrypt_account_note(
        output_account_alias_id, new_account_public_key,
        spending_public_key_1)
    output_note_2 = encrypt_account_note(
        output_account_alias_id, new_account_public_key,
        spending_public_key_2)

    nullifier_1 = compute_account_alias_id_nullifier(
        proof_id, account_alias_id, gibberish, migrate)
    nullifier_2 = compute_gibberish_nullifier(proof_id, gibberish)

    # nonce == 0 requires migrate == 1 (ref: :73-75)
    zero_nonce = nonce.is_zero()
    (migrate | ~zero_nonce).to_field().assert_equal(
        1, "both nonce and migrate are 0")

    zn = zero_nonce.to_field()
    nzn = FieldT.constant(1) - zn
    signer = Point(
        (account_public_key.x * zn + signing_pub_key.x * nzn).normalize(),
        (account_public_key.y * zn + signing_pub_key.y * nzn).normalize(),
    )

    message = pc.compress_many([
        account_alias_id, account_public_key.x, new_account_public_key.x,
        spending_public_key_1.x, spending_public_key_2.x,
    ], 0)
    schnorr_circuit.verify_signature_fields(
        ctx, field_to_bytes(message, 32),
        NativePoint(signer.x, signer.y), tx.signature)

    # signing account note must exist iff nonce != 0 (ref: :90-98)
    account_note_data = encrypt_account_note(account_alias_id,
                                             account_public_key, signer)
    leaf = hash_leaf_xy(account_note_data.x, account_note_data.y)
    bits = index_bits_from_field(ctx, account_note_index,
                                 len(tx.account_path))
    exists = check_membership_bool(data_tree_root, leaf, bits, account_path)
    exists.to_field().assert_equal((~zero_nonce).to_field(),
                                   "account check_membership failed")

    # account key unchanged unless migrating (ref: :101-105)
    keys_equal = ((account_public_key.x - new_account_public_key.x).is_zero()
                  & (account_public_key.y - new_account_public_key.y)
                  .is_zero())
    (keys_equal | migrate).to_field().assert_equal(
        1, "public key should not change")

    dummy_tx_fee = FieldT.from_witness(ctx, 0)
    dummy_tx_fee.assert_equal(0)

    # public inputs — InnerProofFields slots (ref: :110-122)
    proof_id.set_public()
    new_account_public_key.x.set_public()
    new_account_public_key.y.set_public()
    output_account_alias_id.set_public()
    output_note_1.x.set_public()
    output_note_1.y.set_public()
    output_note_2.x.set_public()
    output_note_2.y.set_public()
    nullifier_1.set_public()
    nullifier_2.set_public()
    spending_public_key_1.x.set_public()
    spending_public_key_2.x.set_public()
    data_tree_root.set_public()
    dummy_tx_fee.set_public()
