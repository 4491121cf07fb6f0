"""In-circuit note commitments and nullifiers
(ref: rollup/proofs/notes/circuit/).

All group math is native-field Grumpkin via the Turbo fixed-base ECC gates
(stdlib/pedersen_circuit.py); the nullifier's final hash is the in-circuit
Blake2s.  Bit-for-bit compatible with notes_native.py.

Port of aztec_tpu/rollup/notes_circuit.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

import dataclasses

from ..stdlib.field_t import FieldT, BoolT
from ..stdlib import pedersen_circuit as pc
from ..stdlib.pedersen_circuit import Point
from ..stdlib.byte_array import field_to_bytes
from ..stdlib.recursion_transcript import _blake2s_bytes, bytes_to_field
from . import constants as C
from .notes_native import ValueNote


@dataclasses.dataclass
class ValueNoteCircuit:
    """ref: notes/circuit/value_note.hpp."""
    owner: Point
    value: FieldT
    secret: FieldT
    asset_id: FieldT
    nonce: FieldT


def create_value_note_witness(ctx, note: ValueNote) -> ValueNoteCircuit:
    """ref: value_note.hpp create_value_note_witness — range-constrains
    asset_id (32 bits) and value (252 bits)."""
    secret = FieldT.from_witness(ctx, note.secret)
    ox = FieldT.from_witness(ctx, note.owner[0])
    oy = FieldT.from_witness(ctx, note.owner[1])
    value = FieldT.from_witness(ctx, note.value)
    asset_id = FieldT.from_witness(ctx, note.asset_id)
    nonce = FieldT.from_witness(ctx, note.nonce)
    ctx.create_range_constraint(asset_id.witness_index, 32)
    ctx.create_range_constraint(value.witness_index, C.NOTE_VALUE_BIT_LENGTH)
    return ValueNoteCircuit(Point(ox, oy), value, secret, asset_id, nonce)


def _conditionally_hash_and_accumulate(acc: Point, scalar: FieldT,
                                       num_bits: int,
                                       generator_index: int) -> Point:
    """acc + scalar*G_idx if scalar != 0 else acc
    (ref: encrypt_note.cpp:17-36)."""
    p1 = pc.fixed_base_scalar_mul(scalar, num_bits, generator_index,
                                  forbid_zero_input=False)
    is_zero = scalar.is_zero().to_field()
    lam = (acc.y - p1.y) / (acc.x - p1.x)
    x2 = lam * lam - (acc.x + p1.x)
    y2 = lam * (p1.x - x2) - p1.y
    x2 = (acc.x - x2) * is_zero + x2
    y2 = (acc.y - y2) * is_zero + y2
    return Point(x2.normalize(), y2.normalize())


def encrypt_note(note: ValueNoteCircuit) -> Point:
    """Pedersen note commitment in gates (ref: encrypt_note.cpp:44-61)."""
    h = C.TX_NOTE_HASH_INDEX
    acc = pc.fixed_base_scalar_mul(note.secret, 254, h + 1)
    acc = _conditionally_hash_and_accumulate(
        acc, note.value, C.NOTE_VALUE_BIT_LENGTH, h)
    acc = _conditionally_hash_and_accumulate(acc, note.asset_id, 32, h + 2)
    acc = pc.add_points(acc, pc.compress_to_point(note.owner.x, note.owner.y,
                                                  h + 3))
    acc = _conditionally_hash_and_accumulate(acc, note.nonce, 32, h + 5)
    return acc


def create_note_pair(ctx, note: ValueNote):
    """(plaintext witness, commitment) pair (ref: note_pair.hpp)."""
    plaintext = create_value_note_witness(ctx, note)
    return plaintext, encrypt_note(plaintext)


def compute_nullifier(encrypted_note: Point, tree_index: FieldT,
                      account_private_key: FieldT,
                      is_real: BoolT) -> FieldT:
    """ref: notes/circuit/compute_nullifier.cpp — pedersen encrypt over
    (note.x, hashed_pk.x, hashed_pk.y, index + is_real*2^64), blake2s'd."""
    ctx = tree_index.ctx or encrypted_note.x.ctx
    modified_index = (tree_index + is_real.to_field() * (1 << 64)).normalize()
    hashed_pk = pc.fixed_base_scalar_mul(
        account_private_key, 254, C.TX_NOTE_ACCOUNT_PRIVATE_KEY_INDEX)
    result = pc.encrypt(
        [encrypted_note.x, hashed_pk.x, hashed_pk.y, modified_index],
        C.TX_NOTE_NULLIFIER_INDEX, handle_edge_cases=True)
    blake_in = field_to_bytes(result.x, 32) + field_to_bytes(result.y, 32)
    digest = _blake2s_bytes(ctx, blake_in)
    return bytes_to_field(digest)


def encrypt_account_note(account_alias_id: FieldT,
                         account_public_key: Point,
                         signing_pub_key: Point) -> Point:
    """ref: notes/circuit/account_note.hpp."""
    return pc.encrypt(
        [account_alias_id, account_public_key.x, signing_pub_key.x],
        C.ACCOUNT_NOTE_HASH_INDEX, handle_edge_cases=True)
