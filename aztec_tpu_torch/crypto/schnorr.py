"""Schnorr signatures over Grumpkin (ref: crypto/schnorr/schnorr.tcc).

Host implementation (signing/verification are O(1) scalar muls; the
in-circuit verifier lives in the stdlib layer).  e = H(R.x || m) with the
hash parameterizable (Blake2s by default, matching the SDK account keys).

Port of aztec_tpu/crypto/schnorr.py, host Python: the same inputs give the
same values.
"""

from __future__ import annotations

import secrets
from typing import Callable, Tuple

from ..ff.bn254 import FQ_MOD  # grumpkin group order
from .blake2s import blake2s
from .pedersen import GRUMPKIN_GEN, g_add, g_mul

ORDER = FQ_MOD


def derive_public_key(private_key: int):
    return g_mul(private_key % ORDER, GRUMPKIN_GEN)


def construct_signature(message: bytes, private_key: int,
                        hasher: Callable[[bytes], bytes] = blake2s,
                        k: int | None = None) -> Tuple[bytes, bytes]:
    """Returns (s, e) as 32-byte buffers (ref: schnorr.tcc:6-31)."""
    private_key %= ORDER
    if k is None:
        k = secrets.randbelow(ORDER - 1) + 1
    R = g_mul(k, GRUMPKIN_GEN)
    e_bytes = hasher(R[0].to_bytes(32, "big") + message)
    e = int.from_bytes(e_bytes, "big") % ORDER
    s = (k - private_key * e) % ORDER
    return s.to_bytes(32, "big"), e_bytes


def verify_signature(message: bytes, public_key, sig: Tuple[bytes, bytes],
                     hasher: Callable[[bytes], bytes] = blake2s) -> bool:
    """R = sG + e*pub; accept iff H(R.x || m) == e (ref: schnorr.tcc:95-121)."""
    # invalid-curve check on the public key (ADVICE r1): grumpkin is
    # y^2 = x^3 - 17 over Fr
    from ..ff.bn254 import FR_MOD

    if public_key is None:
        return False
    px, py = public_key
    if not (0 <= px < FR_MOD and 0 <= py < FR_MOD):
        return False
    if (py * py - (px * px * px - 17)) % FR_MOD != 0:
        return False
    s_bytes, e_bytes = sig
    s = int.from_bytes(s_bytes, "big") % ORDER
    e = int.from_bytes(e_bytes, "big") % ORDER
    R = g_add(g_mul(s, GRUMPKIN_GEN), g_mul(e, public_key))
    if R is None:
        return False
    target = hasher(R[0].to_bytes(32, "big") + message)
    return target == e_bytes
