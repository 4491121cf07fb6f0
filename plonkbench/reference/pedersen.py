"""barretenberg's native Pedersen hash over Grumpkin, as the unrolled
transcript uses it (crypto/pedersen/pedersen.cpp compress_native_buffer_to_field,
encrypt_native, hash_single; ecc/groups/wnaf.hpp fixed_wnaf;
affine_element_impl.hpp hash_to_curve), in plain Python integers.

Grumpkin is y^2 = x^3 - 17 over BN254's Fr.  Generator i is the i-th point
of hash_to_curve(1), hash_to_curve(2), ... that lies on the curve; the
stream is extended once and kept, never searched again from seed 1 for each
index.  A hash of one field element walks a "hash ladder": 127 quads of
4^k multiples of generator 2i and the last two quads on generator 2i + 1,
in 2-bit fixed-window NAF digits.  Points are affine ``(x, y)`` tuples,
``None`` the point at infinity; the walks run in Jacobian coordinates.
"""

from __future__ import annotations

import functools

from .bn254 import R as P   # Grumpkin's coordinate field is BN254's Fr
from .keccak import keccak256

CURVE_B = -17 % P
QUAD_LENGTH = 129   # 256 / 2 + 1 ladder entries
NUM_QUADS = 127     # of a 254-bit scalar
CHUNK = 31          # bytes of a buffer compressed into one element
MASK64 = (1 << 64) - 1
_INF = (1, 1, 0)


def _dbl(p):
    x, y, z = p
    if z == 0 or y == 0:
        return _INF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return (x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P)


def _add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    if u1 == u2:
        return _dbl(p) if s1 == s2 else _INF
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    return (x3, y3, ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % P)


def _jac(p):
    return _INF if p is None else (p[0], p[1], 1)


def _affine(p):
    if p[2] == 0:
        return None
    zi = pow(p[2], -1, P)
    return (p[0] * zi * zi % P, p[1] * zi * zi * zi % P)


def add(p, q):
    return _affine(_add(_jac(p), _jac(q)))


def on_curve(p) -> bool:
    return p is None or (p[1] * p[1] - p[0] ** 3 - CURVE_B) % P == 0


def _sqrt(v: int):
    """A square root mod P by Tonelli-Shanks, or None for a non-residue."""
    if v == 0:
        return 0
    if pow(v, (P - 1) // 2, P) != 1:
        return None
    q, s = P - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 5
    while pow(z, (P - 1) // 2, P) == 1:
        z += 1
    m, c, t, r = s, pow(z, q, P), pow(v, q, P), pow(v, (q + 1) // 2, P)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m, c = i, b * b % P
        t, r = t * c % P, r * b % P
    return r


def hash_to_curve(seed: int):
    """The point of keccak256(seed as 8 big-endian bytes, 24 zero bytes):
    x from the low 255 bits (its 64-bit words little-endian), the sign of y
    from the top bit; None where x has no point."""
    h = keccak256(seed.to_bytes(8, "big") + bytes(24))
    words = [int.from_bytes(h[8 * i:8 * i + 8], "little") for i in range(4)]
    packed = words[0] | words[1] << 64 | words[2] << 128 | words[3] << 192
    x = (packed & ~(1 << 255)) % P
    y = _sqrt((x * x * x + CURVE_B) % P)
    if y is None:
        return None
    if (y & 1) != (packed >> 255) & 1:
        y = -y % P
    return (x, y)


class _Generators:
    """The generator stream, extended once as far as it is asked."""

    def __init__(self):
        self.points: list = []
        self.seed = 0

    def __getitem__(self, index: int):
        while len(self.points) <= index:
            self.seed += 1
            p = hash_to_curve(self.seed)
            if p is not None and on_curve(p):
                self.points.append(p)
        return self.points[index]


GENERATORS = _Generators()


@functools.lru_cache(maxsize=None)
def _ladder(index: int) -> tuple:
    """[(4^k G, 3 * 4^k G)] for k = 128 down to 0, of generator ``index``."""
    acc = _jac(GENERATORS[index])
    walk = []
    for _ in range(QUAD_LENGTH):
        two = _dbl(acc)
        walk.append((_affine(acc), _affine(_add(acc, two))))
        acc = _dbl(two)
    return tuple(reversed(walk))


@functools.lru_cache(maxsize=None)
def _hash_ladder(hash_index: int) -> tuple:
    """127 entries of generator 2i's ladder (from its third entry on),
    then the last two of generator 2i + 1's."""
    a, b = _ladder(2 * hash_index), _ladder(2 * hash_index + 1)
    return a[2:] + b[QUAD_LENGTH - 2:]


def fixed_wnaf(scalar: int, num_bits: int) -> tuple:
    """2-bit fixed-window NAF, most significant entry first: (entries,
    skew); an entry holds the digit's half in its low bits and its sign in
    bit 31."""
    entries = (num_bits + 1) // 2
    skew = scalar & 1 == 0
    wnaf = [0] * entries
    previous = (scalar & 3) + skew
    for k in range(1, entries - 1):
        piece = (scalar >> (2 * k)) & 3
        even = 1 if piece & 1 == 0 else 0
        v = (previous - (even << 2)) & MASK64
        if even:
            v ^= MASK64
        wnaf[entries - k] = (v >> 1) | (even << 31)
        previous = piece + even
    final_bits = num_bits - 2 * (entries - 1)
    piece = (scalar >> (2 * (entries - 1))) & ((1 << final_bits) - 1)
    even = 1 if piece & 1 == 0 else 0
    v = (previous - (even << 2)) & MASK64
    if even:
        v ^= MASK64
    wnaf[1] = (v >> 1) | (even << 31)
    wnaf[0] = (piece + even) >> 1
    return wnaf, skew


def hash_single(value: int, hash_index: int):
    """One element's point under hash index ``hash_index``; None for 0."""
    value %= P
    if value == 0:
        return None
    ladder = _hash_ladder(hash_index)[QUAD_LENGTH - NUM_QUADS - 1:]
    base = value if value & 1 else (value - 2) % P
    wnaf, skew = fixed_wnaf(base, 2 * NUM_QUADS + 1)
    acc = _jac(ladder[0][0])
    if skew:
        acc = _add(acc, _jac(GENERATORS[2 * hash_index + 1]))
    for k in range(NUM_QUADS):
        entry = wnaf[k + 1]
        x, y = ladder[k + 1][1] if entry & 0xFFFFFF == 1 else ladder[k + 1][0]
        acc = _add(acc, (x, -y % P if entry >> 31 else y, 1))
    return _affine(acc)


def compress_many(inputs, hash_index: int = 0) -> int:
    """x of the sum of ``hash_single(v_i, hash_index + i)``; 0 for infinity."""
    acc = None
    for i, v in enumerate(inputs):
        acc = add(acc, hash_single(v, hash_index + i))
    return 0 if acc is None else acc[0]


def compress_buffer(data: bytes) -> int:
    """The buffer in 31-byte big-endian chunks, compressed to one element."""
    return compress_many([int.from_bytes(data[i:i + CHUNK], "big") % P
                          for i in range(0, len(data), CHUNK)])
