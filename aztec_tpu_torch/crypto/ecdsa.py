"""ECDSA over secp256k1 / secp256r1 — host implementation
(ref: crypto/ecdsa/, ecc/curves/secp256k1, ecc/curves/secp256r1).

Signature support is peripheral in the reference (SDK key recovery); host
big-int math is the right tool.  Deterministic nonces via RFC6979-style
HMAC-SHA256.

Port of aztec_tpu/crypto/ecdsa.py.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CurveParams:
    p: int
    a: int
    b: int
    n: int
    gx: int
    gy: int


SECP256K1 = CurveParams(
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

SECP256R1 = CurveParams(
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)


def _add(c: CurveParams, P, Q):
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % c.p == 0:
            return None
        lam = (3 * x1 * x1 + c.a) * pow(2 * y1, -1, c.p) % c.p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, c.p) % c.p
    x3 = (lam * lam - x1 - x2) % c.p
    return (x3, (lam * (x1 - x3) - y1) % c.p)


def _mul(c: CurveParams, k: int, P):
    acc = None
    while k:
        if k & 1:
            acc = _add(c, acc, P)
        P = _add(c, P, P)
        k >>= 1
    return acc


def derive_public_key(priv: int, curve: CurveParams = SECP256K1):
    return _mul(curve, priv % curve.n, (curve.gx, curve.gy))


def _rfc6979_k(priv: int, digest: bytes, curve: CurveParams) -> int:
    qlen = 32
    x = priv.to_bytes(qlen, "big")
    V = b"\x01" * 32
    K = b"\x00" * 32
    K = hmac.new(K, V + b"\x00" + x + digest, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x + digest, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 1 <= k < curve.n:
            return k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


def sign(message: bytes, priv: int,
         curve: CurveParams = SECP256K1) -> Tuple[int, int]:
    digest = hashlib.sha256(message).digest()
    z = int.from_bytes(digest, "big") % curve.n
    k = _rfc6979_k(priv, digest, curve)
    R = _mul(curve, k, (curve.gx, curve.gy))
    r = R[0] % curve.n
    s = pow(k, -1, curve.n) * (z + r * priv) % curve.n
    if s > curve.n // 2:  # low-s normalization
        s = curve.n - s
    return r, s


def verify(message: bytes, public_key, sig: Tuple[int, int],
           curve: CurveParams = SECP256K1) -> bool:
    r, s = sig
    if not (1 <= r < curve.n and 1 <= s < curve.n):
        return False
    # invalid-curve check: an off-curve or identity "public key" would be
    # processed silently by _mul/_add
    if public_key is None:
        return False
    px, py = public_key
    if not (0 <= px < curve.p and 0 <= py < curve.p):
        return False
    if (py * py - (px * px * px + curve.a * px + curve.b)) % curve.p != 0:
        return False
    z = int.from_bytes(hashlib.sha256(message).digest(), "big") % curve.n
    w = pow(s, -1, curve.n)
    u1 = z * w % curve.n
    u2 = r * w % curve.n
    R = _add(curve, _mul(curve, u1, (curve.gx, curve.gy)),
             _mul(curve, u2, public_key))
    if R is None:
        return False
    return R[0] % curve.n == r
