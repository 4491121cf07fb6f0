"""BN254 constants, G1 arithmetic and the proof's byte encodings.

Plain Python integers.  Points are affine ``(x, y)`` tuples, ``None`` the
point at infinity; scalar products run in Jacobian coordinates.
"""

from __future__ import annotations

Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
G1 = (1, 2)
TWO_ADICITY = 28
ROOT_2_28 = pow(5, (R - 1) >> TWO_ADICITY, R)   # barretenberg's fr root
# barretenberg's fr coset generators (fr.hpp): 5, 6, ..., 12; k_1..k_3 encode
# the sigma columns, the last one (12) the public-input rows of sigma_1
COSET = tuple(range(5, 13))
EXTERNAL_COSET = COSET[7]


def domain_root(n: int) -> int:
    """The generator of the order-n subgroup of Fr* (n a power of two)."""
    return pow(ROOT_2_28, (1 << TWO_ADICITY) // n, R)


def on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 3) % Q == 0


def _jdbl(p):
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return (x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q)


def _jadd(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        return _jdbl(p) if s1 == s2 else (1, 1, 0)
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % Q
    return (x3, y3, z3)


def _affine(p):
    if p[2] == 0:
        return None
    zi = pow(p[2], -1, Q)
    zi2 = zi * zi % Q
    return (p[0] * zi2 % Q, p[1] * zi2 * zi % Q)


def _jac(p):
    return (1, 1, 0) if p is None else (p[0], p[1], 1)


def msm(pairs) -> tuple | None:
    """sum of k * P over [(k, P)], by double-and-add."""
    acc = (1, 1, 0)
    for k, p in pairs:
        k %= R
        base = _jac(p)
        while k:
            if k & 1:
                acc = _jadd(acc, base)
            base = _jdbl(base)
            k >>= 1
    return _affine(acc)


def mul(k: int, p) -> tuple | None:
    return msm([(k, p)])


def add(p, q) -> tuple | None:
    return _affine(_jadd(_jac(p), _jac(q)))


def neg(p) -> tuple | None:
    return None if p is None else (p[0], (-p[1]) % Q)


def g1_from_bytes(b: bytes):
    """barretenberg's affine encoding: y then x, 32 bytes each big-endian,
    bit 7 of byte 0 marks infinity.  Returns (ok, point)."""
    if len(b) != 64:
        return False, None
    if b[0] >> 7:
        return True, None
    y = int.from_bytes(b[:32], "big")
    x = int.from_bytes(b[32:], "big")
    if x >= Q or y >= Q or not on_curve((x, y)):
        return False, None
    return True, (x, y)


def g1_to_bytes(p) -> bytes:
    if p is None:
        return bytes([0x80]) + bytes(63)
    return p[1].to_bytes(32, "big") + p[0].to_bytes(32, "big")


def fr_bytes(v: int) -> bytes:
    return (v % R).to_bytes(32, "big")
