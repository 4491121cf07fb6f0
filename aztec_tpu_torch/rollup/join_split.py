"""join_split: 2-in/2-out private value-note transfer circuit
(ref: rollup/proofs/join_split/join_split_circuit.cpp,
join_split_tx.hpp, verify_signature.hpp, sign_notes.cpp).

Consumes up to two value notes from the data tree (proving membership and
nullifying them), creates two output notes, balances values against
public input/output with a fee, and checks a Schnorr spending signature.
The proof is made with UNROLLED turbo settings so the rollup circuit can
recursively verify it.

Port of aztec_tpu/rollup/join_split.py, on the port's composers: host
Python, so the same inputs record the same gates.
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
from .notes_native import (
    ValueNote,
    encrypt_note as encrypt_note_native,
)
from .notes_circuit import (
    create_note_pair,
    compute_nullifier,
    encrypt_account_note,
)

M = FR_MOD
HashPath = List[Tuple[int, int]]


@dataclasses.dataclass
class JoinSplitTx:
    """Native transaction description (ref: join_split_tx.hpp)."""
    public_input: int
    public_output: int
    asset_id: int
    num_input_notes: int
    input_index: Tuple[int, int]
    input_note: Tuple[ValueNote, ValueNote]
    output_note: Tuple[ValueNote, ValueNote]
    signing_pub_key: Tuple[int, int]
    signature: Tuple[bytes, bytes]
    old_data_root: int
    input_path: Tuple[HashPath, HashPath]
    account_index: int
    account_path: HashPath
    input_owner: int
    output_owner: int
    account_private_key: int
    alias_hash: int
    nonce: int


def sign_message_fields(tx: JoinSplitTx, nullifier1: int, nullifier2: int,
                        tx_fee: int) -> List[int]:
    """The 12 fields compressed into the signed message
    (ref: join_split/verify_signature.hpp:27-44)."""
    e1 = encrypt_note_native(tx.output_note[0])
    e2 = encrypt_note_native(tx.output_note[1])
    return [
        tx.public_input, tx.public_output, tx.asset_id,
        e1[0], e1[1], e2[0], e2[1],
        nullifier1, nullifier2,
        tx.input_owner, tx.output_owner, tx_fee,
    ]


def compute_signing_data(tx: JoinSplitTx) -> bytes:
    """Native signing message: 32-byte BE pedersen compression of the tx
    fields (ref: notes/native/sign_notes.cpp)."""
    from .notes_native import compute_nullifier as null_native

    in1 = encrypt_note_native(tx.input_note[0])
    in2 = encrypt_note_native(tx.input_note[1])
    nul1 = null_native(in1, tx.input_index[0], tx.account_private_key,
                       tx.num_input_notes >= 1)
    nul2 = null_native(in2, tx.input_index[1], tx.account_private_key,
                       tx.num_input_notes >= 2)
    total_in = (tx.input_note[0].value + tx.input_note[1].value
                + tx.public_input)
    total_out = (tx.output_note[0].value + tx.output_note[1].value
                 + tx.public_output)
    tx_fee = (total_in - total_out) % M
    msg = pd.compress_many(sign_message_fields(tx, nul1, nul2, tx_fee), 0)
    return msg.to_bytes(32, "big")


def sign_tx(tx: JoinSplitTx, signing_private_key: int,
            k: Optional[int] = None) -> Tuple[bytes, bytes]:
    """Produce the spending signature (ref: sign_notes.cpp)."""
    return schnorr.construct_signature(compute_signing_data(tx),
                                       signing_private_key, k=k)


# --------------------------- circuit ----------------------------------------

def _uint_gt_const(ctx, a: FieldT, const_i: int, bits: int) -> BoolT:
    """a > const_i for a range-constrained `bits`-bit value a: witness the
    outcome and range-constrain the selected difference."""
    av = a.get_value()
    b = BoolT.from_witness(ctx, av > const_i)
    f = b.to_field()
    diff = f * (a - (const_i + 1)) + (FieldT.constant(1) - f) * (
        FieldT.constant(const_i) - a)
    ctx.create_range_constraint(diff.normalize().witness_index, bits)
    return b


def _process_input_note(ctx, account_private_key: FieldT,
                        merkle_root: FieldT, path, index: FieldT,
                        note_commitment: Point, note_value: FieldT,
                        is_real: BoolT, depth: int) -> FieldT:
    """Membership + nullifier for one input note
    (ref: join_split_circuit.cpp:23-49)."""
    leaf = hash_leaf_xy(note_commitment.x, note_commitment.y)
    bits = index_bits_from_field(ctx, index, depth)
    good = check_membership_bool(merkle_root, leaf, bits, path) | ~is_real
    good.to_field().assert_equal(1, "input note not a member")

    valid_value = note_value.is_zero() | is_real
    valid_value.to_field().assert_equal(1, "padding note non zero")

    return compute_nullifier(note_commitment, index, account_private_key,
                             is_real)


@dataclasses.dataclass
class JoinSplitOutputs:
    nullifier1: FieldT
    nullifier2: FieldT
    tx_fee: FieldT


@dataclasses.dataclass
class JoinSplitWitnesses:
    """The circuit-facing witnesses escape_hatch/public-input wiring needs
    (subset of ref join_split_inputs, join_split_circuit.hpp)."""
    public_input: FieldT
    public_output: FieldT
    asset_id: FieldT
    output_note1: Point
    output_note2: Point
    input_owner: FieldT
    output_owner: FieldT
    merkle_root: FieldT


def join_split_circuit(ctx, tx: JoinSplitTx) -> JoinSplitOutputs:
    """Build the full join_split circuit on the given TurboComposer
    (ref: join_split_circuit.cpp:142-187).  Exposes the standard 14
    public inputs (InnerProofFields order, inner_proof_data.hpp)."""
    w, outputs = join_split_circuit_component(ctx, tx)

    # public inputs (InnerProofFields order, ref: :171-186)
    FieldT.from_witness(ctx, 0).set_public()          # proof_id = 0
    w.public_input.set_public()
    w.public_output.set_public()
    w.asset_id.set_public()
    w.output_note1.x.set_public()
    w.output_note1.y.set_public()
    w.output_note2.x.set_public()
    w.output_note2.y.set_public()
    outputs.nullifier1.set_public()
    outputs.nullifier2.set_public()
    w.input_owner.set_public()
    w.output_owner.set_public()
    w.merkle_root.set_public()
    outputs.tx_fee.set_public()
    return outputs


def join_split_circuit_component(ctx, tx: JoinSplitTx):
    """Gate logic without public-input wiring
    (ref: join_split_circuit.cpp:51-140 join_split_circuit_component).
    Returns (JoinSplitWitnesses, JoinSplitOutputs)."""
    data_depth = len(tx.input_path[0])

    public_input = FieldT.from_witness(ctx, tx.public_input)
    public_output = FieldT.from_witness(ctx, tx.public_output)
    asset_id = FieldT.from_witness(ctx, tx.asset_id)
    num_input_notes = FieldT.from_witness(ctx, tx.num_input_notes)
    input_note1_index = FieldT.from_witness(ctx, tx.input_index[0])
    input_note2_index = FieldT.from_witness(ctx, tx.input_index[1])

    in_note1, in_enc1 = create_note_pair(ctx, tx.input_note[0])
    in_note2, in_enc2 = create_note_pair(ctx, tx.input_note[1])
    out_note1, out_enc1 = create_note_pair(ctx, tx.output_note[0])
    out_note2, out_enc2 = create_note_pair(ctx, tx.output_note[1])

    signing_pub_key = Point(FieldT.from_witness(ctx, tx.signing_pub_key[0]),
                            FieldT.from_witness(ctx, tx.signing_pub_key[1]))
    merkle_root = FieldT.from_witness(ctx, tx.old_data_root)
    input_path1 = [(FieldT.from_witness(ctx, l), FieldT.from_witness(ctx, r))
                   for (l, r) in tx.input_path[0]]
    input_path2 = [(FieldT.from_witness(ctx, l), FieldT.from_witness(ctx, r))
                   for (l, r) in tx.input_path[1]]
    account_index = FieldT.from_witness(ctx, tx.account_index)
    account_path = [(FieldT.from_witness(ctx, l), FieldT.from_witness(ctx, r))
                    for (l, r) in tx.account_path]
    input_owner = FieldT.from_witness(ctx, tx.input_owner)
    output_owner = FieldT.from_witness(ctx, tx.output_owner)
    account_private_key = FieldT.from_witness(ctx, tx.account_private_key)
    alias_hash = FieldT.from_witness(ctx, tx.alias_hash)
    nonce = FieldT.from_witness(ctx, tx.nonce)

    # consistent asset ids (ref: :54-68)
    in_note1.asset_id.assert_equal(in_note2.asset_id,
                                   "input note asset ids don't match")
    out_note1.asset_id.assert_equal(out_note2.asset_id,
                                    "output note asset ids don't match")
    in_note1.asset_id.assert_equal(out_note1.asset_id,
                                   "input/output note asset ids don't match")
    in_note1.asset_id.assert_equal(asset_id,
                                   "note asset ids not equal to tx asset id")
    ctx.create_range_constraint(asset_id.normalize().witness_index,
                                C.NUM_ASSETS_BIT_LENGTH)

    # not joining the same note (ref: :71-72)
    indices_equal = (input_note1_index - input_note2_index).is_zero()
    indices_equal.to_field().assert_equal(0, "joining same note")

    # public values + fee (ref: :75-82)
    ctx.create_range_constraint(public_input.witness_index,
                                C.NOTE_VALUE_BIT_LENGTH)
    ctx.create_range_constraint(public_output.witness_index,
                                C.NOTE_VALUE_BIT_LENGTH)
    total_in = in_note1.value + in_note2.value + public_input
    total_out = out_note1.value + out_note2.value + public_output
    tx_fee = (total_in - total_out).normalize()
    ctx.create_range_constraint(tx_fee.witness_index, C.TX_FEE_BIT_LENGTH)

    # input notes owned by the same account (ref: :85-89)
    in_note1.owner.x.assert_equal(in_note2.owner.x,
                                  "input note owners don't match")
    in_note1.owner.y.assert_equal(in_note2.owner.y,
                                  "input note owners don't match")
    in_note1.nonce.assert_equal(in_note2.nonce,
                                "input note nonce don't match")

    # account key derivation (ref: :92-98)
    account_private_key.assert_is_not_zero(
        "join_split_circuit: account private key is zero")
    account_public_key = pc.fixed_base_scalar_mul_g1(account_private_key, 254)
    account_public_key.x.assert_equal(in_note1.owner.x,
                                      "account_private_key incorrect")
    account_public_key.y.assert_equal(in_note1.owner.y,
                                      "account_private_key incorrect")
    nonce.assert_equal(in_note1.nonce, "nonce incorrect")

    # signer selection (ref: :103-105)
    zero_nonce = nonce.is_zero()
    zn = zero_nonce.to_field()
    nzn = FieldT.constant(1) - zn
    signer = Point(
        (account_public_key.x * zn + signing_pub_key.x * nzn).normalize(),
        (account_public_key.y * zn + signing_pub_key.y * nzn).normalize(),
    )

    # account-note membership when nonce > 0 (ref: :108-117)
    ctx.create_range_constraint(alias_hash.witness_index, 224)
    account_alias_id = alias_hash + nonce * (1 << 224)
    account_note = encrypt_account_note(account_alias_id.normalize(),
                                        account_public_key, signer)
    account_leaf = hash_leaf_xy(account_note.x, account_note.y)
    account_bits = index_bits_from_field(ctx, account_index,
                                         len(tx.account_path))
    exists = check_membership_bool(merkle_root, account_leaf, account_bits,
                                   account_path)
    (exists | zero_nonce).to_field().assert_equal(
        1, "account check_membership failed")

    # input note membership + nullifiers (ref: :120-135)
    note_1_valid = ~num_input_notes.is_zero()
    note_2_valid = (num_input_notes - 2).is_zero()
    nullifier1 = _process_input_note(
        ctx, account_private_key, merkle_root, input_path1,
        input_note1_index, in_enc1, in_note1.value, note_1_valid, data_depth)
    nullifier2 = _process_input_note(
        ctx, account_private_key, merkle_root, input_path2,
        input_note2_index, in_enc2, in_note2.value, note_2_valid, data_depth)

    # spending signature (ref: verify_signature.hpp)
    to_compress = [
        public_input, public_output, asset_id,
        out_enc1.x, out_enc1.y, out_enc2.x, out_enc2.y,
        nullifier1, nullifier2, input_owner, output_owner, tx_fee,
    ]
    message = pc.compress_many(to_compress, 0)
    msg_bytes = field_to_bytes(message, 32)
    schnorr_circuit.verify_signature_fields(
        ctx, msg_bytes,
        NativePoint(signer.x, signer.y), tx.signature)

    witnesses = JoinSplitWitnesses(
        public_input=public_input, public_output=public_output,
        asset_id=asset_id, output_note1=out_enc1, output_note2=out_enc2,
        input_owner=input_owner, output_owner=output_owner,
        merkle_root=merkle_root,
    )
    return witnesses, JoinSplitOutputs(nullifier1, nullifier2, tx_fee)
