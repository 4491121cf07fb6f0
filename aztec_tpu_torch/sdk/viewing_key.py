"""User keys + viewing-key encryption (ref: sdk key derivation +
barretenberg/viewing_key.ts consumed by falafel/sdk).

Account keys are Grumpkin keypairs (the Schnorr spending keys of
join_split).  A note's plaintext (value, asset_id, nonce, secret) travels
to its owner as a viewing key: ECDH against the owner's public key with an
ephemeral keypair, AES-128-CBC under blake2s(shared_x).  The reference
encrypts note data the same way (ephemeral P + AES blob); byte layouts
differ (documented here) since no cross-compatibility target exists for
the TS blob.

Port of aztec_tpu/sdk/viewing_key.py over the port's host Pedersen,
Blake2s and AES-128.  The ephemeral key comes from an explicit random
source, ``randbytes(n) -> bytes`` (``os.urandom`` unless given), drawn at
the same point and size as the reference's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Tuple

from ..crypto import pedersen as pd
from ..crypto.aes128 import decrypt_cbc, encrypt_cbc
from ..crypto.blake2s import blake2s
from ..ff.bn254 import FQ_MOD
from ..rollup.notes_native import ValueNote

GPoint = Tuple[int, int]

GRUMPKIN_ORDER = FQ_MOD  # grumpkin's scalar field is bn254's Fq


def derive_keys(seed: bytes) -> Tuple[int, GPoint]:
    """(private, public) grumpkin account keypair from a seed
    (ref: sdk derives from an Ethereum signature; any 32+ bytes here)."""
    priv = int.from_bytes(blake2s(seed), "big") % GRUMPKIN_ORDER
    priv = priv or 1
    return priv, pd.g_mul(priv, pd.GRUMPKIN_GEN)


@dataclasses.dataclass
class ViewingKey:
    """Ephemeral pubkey + AES blob; 160 bytes on the wire."""
    ephemeral_pub: GPoint
    blob: bytes  # AES-128-CBC(iv=0_16, key=blake2s(shared_x)[:16])

    WIRE_LEN = 64 + 80  # 2x32 point + 80-byte blob (5 AES blocks)

    def to_buffer(self) -> bytes:
        return (self.ephemeral_pub[0].to_bytes(32, "big")
                + self.ephemeral_pub[1].to_bytes(32, "big") + self.blob)

    @staticmethod
    def from_buffer(buf: bytes) -> "ViewingKey":
        assert len(buf) == ViewingKey.WIRE_LEN
        return ViewingKey(
            (int.from_bytes(buf[:32], "big"),
             int.from_bytes(buf[32:64], "big")), buf[64:])


def _shared_key(point: GPoint) -> bytes:
    return blake2s(point[0].to_bytes(32, "big"))[:16]


def encrypt_note_for(note: ValueNote, owner_pub: GPoint,
                     eph_priv: Optional[int] = None,
                     randbytes: Callable[[int], bytes] = os.urandom,
                     ) -> ViewingKey:
    eph_priv = eph_priv or (
        int.from_bytes(randbytes(32), "big") % GRUMPKIN_ORDER or 1)
    eph_pub = pd.g_mul(eph_priv, pd.GRUMPKIN_GEN)
    key = _shared_key(pd.g_mul(eph_priv, owner_pub))
    plain = (note.value.to_bytes(32, "big")
             + note.asset_id.to_bytes(4, "big")
             + note.nonce.to_bytes(4, "big")
             + note.secret.to_bytes(32, "big")
             + bytes(8))  # zero-pad to 80 bytes (5 AES blocks)
    blob = encrypt_cbc(plain, key, bytes(16))
    return ViewingKey(eph_pub, blob)


def try_decrypt_note(vk: ViewingKey, account_priv: int,
                     owner_pub: GPoint) -> Optional[ValueNote]:
    """Returns the note if this viewing key decrypts consistently for the
    given owner (value/asset/nonce/secret recombine to a valid note)."""
    key = _shared_key(pd.g_mul(account_priv, vk.ephemeral_pub))
    try:
        plain = decrypt_cbc(vk.blob, key, bytes(16))
    except Exception:
        return None
    if len(plain) < 72 or any(plain[72:]):
        return None
    value = int.from_bytes(plain[0:32], "big")
    asset_id = int.from_bytes(plain[32:36], "big")
    nonce = int.from_bytes(plain[36:40], "big")
    secret = int.from_bytes(plain[40:72], "big")
    if value >> 252 or secret >> 252:
        return None
    return ValueNote(value, asset_id, nonce, owner_pub, secret)
