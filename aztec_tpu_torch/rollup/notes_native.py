"""Native (host) note types: value notes, account notes, nullifiers
(ref: rollup/proofs/notes/native/).

These are the plaintext/commitment computations the SDK performs when
building a transaction; the in-circuit counterparts live in
notes_circuit.py and must agree bit-for-bit.

Port of aztec_tpu/rollup/notes_native.py, host Python: the same inputs give
the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..crypto import pedersen as pd
from ..crypto.blake2s import blake2s
from ..ff.bn254 import FR_MOD
from . import constants as C

GPoint = Tuple[int, int]


@dataclasses.dataclass
class ValueNote:
    """ref: notes/native/value_note.hpp."""
    value: int
    asset_id: int
    nonce: int
    owner: GPoint          # grumpkin public key
    secret: int            # viewing key, < 2^250

    def to_buffer(self) -> bytes:
        """Wire form (ref: value_note.hpp read/write: value u256,
        asset_id u32, nonce u32, owner g1, secret fr — all big-endian)."""
        return (self.value.to_bytes(32, "big")
                + self.asset_id.to_bytes(4, "big")
                + self.nonce.to_bytes(4, "big")
                + self.owner[0].to_bytes(32, "big")
                + self.owner[1].to_bytes(32, "big")
                + self.secret.to_bytes(32, "big"))

    @staticmethod
    def from_buffer(buf: bytes) -> "ValueNote":
        assert len(buf) == 136
        return ValueNote(
            value=int.from_bytes(buf[0:32], "big"),
            asset_id=int.from_bytes(buf[32:36], "big"),
            nonce=int.from_bytes(buf[36:40], "big"),
            owner=(int.from_bytes(buf[40:72], "big"),
                   int.from_bytes(buf[72:104], "big")),
            secret=int.from_bytes(buf[104:136], "big"),
        )


def encrypt_note(note: ValueNote) -> GPoint:
    """Pedersen note commitment (ref: notes/native/encrypt_note.cpp):
    value*[g0] + secret*[g1] + asset_id*[g2] + compress_to_point(owner)
    + nonce*[g5], zero scalars skipped."""
    h = C.TX_NOTE_HASH_INDEX
    acc = pd.fixed_base_scalar_mul(note.secret, 254, h + 1)
    if note.value > 0:
        acc = pd.g_add(
            acc, pd.fixed_base_scalar_mul(note.value,
                                          C.NOTE_VALUE_BIT_LENGTH, h))
    if note.asset_id > 0:
        acc = pd.g_add(acc, pd.fixed_base_scalar_mul(note.asset_id, 32, h + 2))
    owner_hash = pd.g_add(pd.hash_single(note.owner[0], h + 3),
                          pd.hash_single(note.owner[1], h + 4))
    acc = pd.g_add(acc, owner_hash)
    if note.nonce > 0:
        acc = pd.g_add(acc, pd.fixed_base_scalar_mul(note.nonce, 32, h + 5))
    return acc


def compute_nullifier(encrypted_note: GPoint, tree_index: int,
                      account_private_key: int, is_real: bool) -> int:
    """ref: notes/native/compute_nullifier.cpp — pedersen over
    (note.x, hashed_pk, modified_index) then blake2s."""
    hashed_pk = pd.fixed_base_scalar_mul(
        account_private_key, 254, C.TX_NOTE_ACCOUNT_PRIVATE_KEY_INDEX)
    modified_index = (tree_index + (int(is_real) << 64)) % FR_MOD
    result = pd.encrypt_native(
        [encrypted_note[0], hashed_pk[0], hashed_pk[1], modified_index],
        C.TX_NOTE_NULLIFIER_INDEX,
    )
    digest = blake2s(result[0].to_bytes(32, "big")
                     + result[1].to_bytes(32, "big"))
    return int.from_bytes(digest, "big") % FR_MOD


def encrypt_account_note(account_alias_id: int, account_public_key: GPoint,
                         signing_pub_key: GPoint) -> GPoint:
    """ref: notes/native/account_note.cpp encrypt_account_note —
    pedersen encrypt over (alias_id, account_pub.x, signing_pub.x)."""
    return pd.encrypt_native(
        [account_alias_id, account_public_key[0], signing_pub_key[0]],
        C.ACCOUNT_NOTE_HASH_INDEX,
    )


def account_alias_id(alias_hash: int, nonce: int) -> int:
    """alias_hash + nonce * 2^224 (ref: account.cpp:58)."""
    return (alias_hash + nonce * (1 << 224)) % FR_MOD


def leaf_bytes(pt: GPoint) -> bytes:
    """64-byte data-tree leaf preimage for a note commitment (x || y)."""
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
