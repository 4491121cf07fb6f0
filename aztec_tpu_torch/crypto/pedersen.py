"""Pedersen hash over Grumpkin, on the host.

Port of aztec_tpu/crypto/pedersen.py in Python integers (the reference's
own host code; nothing here touches a device), line for line but for two
things that give the same points faster: the generator stream is extended
once, and the ladder walks and ``g_mul`` accumulate in Jacobian
coordinates with one inversion at the end.  It is a
structural re-implementation of barretenberg's crypto/pedersen/pedersen.cpp:
deterministic generators via hash_to_curve(seed) (ecc/groups/
affine_element_impl.hpp:117-125), per-generator fixed-base ladders of
quad-doubled points (pedersen.cpp:115-171), 2-bit fixed-WNAF recoding
(ecc/groups/wnaf.hpp fixed_wnaf), and the stitched "hash ladders" that split
a 254-bit input across two generators for injectivity (pedersen.cpp:38-111).

It serves transcript hashing (the ``pedersen_blake2s`` hasher of
``transcript/transcript.py``) and single hashes.

Grumpkin: y^2 = x^3 - 17 over Fq = bn254-Fr; group order = bn254-Fq
(ecc/curves/grumpkin/grumpkin.hpp:11-29).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

from ..ff.bn254 import FR_MOD as P  # grumpkin coordinate field
from .keccak import keccak256

CURVE_B = (-17) % P
QUAD_LENGTH = 129  # 256/2 + 1
NUM_BITS = 254
NUM_QUADS = 127

GRUMPKIN_GEN = (
    1,
    0x2CF135E7506A45D632D270D45F1181294833FC48D823F272C,
)


# ---- affine grumpkin ops (ints; None = infinity) ----------------------------


def g_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return g_dbl(a)
    lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g_dbl(a):
    if a is None:
        return None
    x, y = a
    if y == 0:
        return None
    lam = 3 * x * x * pow(2 * y, -1, P) % P
    x3 = (lam * lam - 2 * x) % P
    return (x3, (lam * (x - x3) - y) % P)


# ---- Jacobian accumulation (one inversion at the end of a walk) -------------
# (X, Y, Z) stands for (X / Z^2, Y / Z^3); None = infinity.  The walks below
# give the same affine points as the chains of g_add / g_dbl they replace.


def _j_dbl(a):
    if a is None or a[1] == 0:
        return None
    X, Y, Z = a
    YY = Y * Y % P
    S = 4 * X * YY % P
    M = 3 * X * X % P
    X3 = (M * M - 2 * S) % P
    return (X3, (M * (S - X3) - 8 * YY * YY) % P, 2 * Y * Z % P)


def _j_add(a, b):
    """Jacobian a + affine b."""
    if b is None:
        return a
    if a is None:
        return (b[0], b[1], 1)
    X1, Y1, Z1 = a
    ZZ = Z1 * Z1 % P
    H = (b[0] * ZZ - X1) % P
    r = (b[1] * ZZ * Z1 - Y1) % P
    if H == 0:
        return _j_dbl(a) if r == 0 else None
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (r * r - HHH - 2 * V) % P
    return (X3, (r * (V - X3) - Y1 * HHH) % P, Z1 * H % P)


def _affine(a):
    if a is None:
        return None
    X, Y, Z = a
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def _batch_inverse(vals):
    """Inverses of non-zero ints mod P, one ``pow`` (Montgomery's trick)."""
    prefix = [1]
    for v in vals:
        prefix.append(prefix[-1] * v % P)
    inv = pow(prefix[-1], -1, P)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * prefix[i] % P
        inv = inv * vals[i] % P
    return out


def _j_add_j(a, b):
    """Jacobian a + Jacobian b (add-2007-bl)."""
    X1, Y1, Z1 = a
    X2, Y2, Z2 = b
    Z1Z1, Z2Z2 = Z1 * Z1 % P, Z2 * Z2 % P
    U1, U2 = X1 * Z2Z2 % P, X2 * Z1Z1 % P
    S1, S2 = Y1 * Z2 * Z2Z2 % P, Y2 * Z1 * Z1Z1 % P
    H, r = (U2 - U1) % P, (S2 - S1) % P
    if H == 0:
        return _j_dbl(a) if r == 0 else None
    HH = H * H % P
    HHH = H * HH % P
    V = U1 * HH % P
    X3 = (r * r - HHH - 2 * V) % P
    return (X3, (r * (V - X3) - S1 * HHH) % P, Z1 * Z2 * H % P)


def g_neg(a):
    if a is None:
        return None
    return (a[0], (-a[1]) % P)


def g_on_curve(a) -> bool:
    if a is None:
        return True
    x, y = a
    return (y * y - (x * x * x + CURVE_B)) % P == 0


def _sqrt(v: int):
    """Tonelli-Shanks over Fq (p % 4 == 1 here, use generic)."""
    if v == 0:
        return 0
    if pow(v, (P - 1) // 2, P) != 1:
        return None
    # p - 1 = q * 2^s
    q, s = P - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 5  # known non-residue for this field (the multiplicative generator)
    while pow(z, (P - 1) // 2, P) == 1:
        z += 1
    m, c, t, r = s, pow(z, q, P), pow(v, q, P), pow(v, (q + 1) // 2, P)
    while t != 1:
        t2 = t
        i = 0
        while t2 != 1:
            t2 = t2 * t2 % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m, c = i, b * b % P
        t = t * c % P
        r = r * b % P
    return r


def hash_to_curve(seed: int):
    """ref: affine_element_impl.hpp:117-125 + keccak.cpp hash_field_element."""
    data = seed.to_bytes(8, "big") + b"\x00" * 24
    h = keccak256(data)
    words = [int.from_bytes(h[8 * i : 8 * i + 8], "little") for i in range(4)]
    compressed = words[0] | words[1] << 64 | words[2] << 128 | words[3] << 192
    x = (compressed & ~(1 << 255)) % P
    y_bit = (compressed >> 255) & 1
    y2 = (x * x * x + CURVE_B) % P
    y = _sqrt(y2)
    if y is None:
        return None
    if (y & 1) != y_bit:
        y = (-y) % P
    return (x, y)


_GENERATORS: List[Tuple[int, int]] = []    # the stream found so far
_SEED = [0]                                 # the last seed tried


def get_generator(index: int):
    """Deterministic generator stream (ref: group.hpp:42-57): the index-th
    point of hash_to_curve(1), hash_to_curve(2), ... that is on the curve.
    The stream is extended once, not searched again from seed 1 for every
    index."""
    while len(_GENERATORS) <= index:
        _SEED[0] += 1
        cand = hash_to_curve(_SEED[0])
        if cand is not None and g_on_curve(cand):
            _GENERATORS.append(cand)
    return _GENERATORS[index]


@functools.lru_cache(maxsize=None)
def _ladder_from_point(pt: Tuple[int, int]) -> Tuple[Tuple, ...]:
    """[(one, three)] * QUAD_LENGTH, MSB-first (ref: pedersen.cpp:115-134),
    built over an arbitrary base point (generators, or grumpkin g1::one
    for the g1 ladder used by group fixed-base muls)."""
    # 4^i pt and 3 * 4^i pt in Jacobian coordinates, normalised together
    # (one inversion; the same affine points as chains of g_dbl / g_add)
    acc = (pt[0], pt[1], 1)
    walk = []
    for _ in range(QUAD_LENGTH):
        two = _j_dbl(acc)
        walk += [acc, _j_add_j(acc, two)]
        acc = _j_dbl(two)
    zinv = _batch_inverse([z for _, _, z in walk])
    aff = [(X * zi * zi % P, Y * zi * zi * zi % P)
           for (X, Y, _), zi in zip(walk, zinv)]
    ones, threes = aff[0::2][::-1], aff[1::2][::-1]
    return tuple(zip(ones, threes))


def _ladder(generator_index: int) -> Tuple[Tuple, ...]:
    return _ladder_from_point(get_generator(generator_index))


def g1_ladder() -> Tuple[Tuple, ...]:
    """Ladder over grumpkin g1::one (ref: pedersen get_g1_ladder)."""
    return _ladder_from_point(GRUMPKIN_GEN)


@functools.lru_cache(maxsize=None)
def selectors_from_ladder(lad: Tuple[Tuple, ...]):
    """Turbo fixed-base ECC gate selector coefficients per ladder entry
    (ref: pedersen.cpp:135-170): for entry (one=(xb,yb), three=(xg,yg)):

        q_x_1 = (xg - xb)/8,  q_x_2 = (9 xb - xg)/8,
        q_y_1 = (3 yb - yg)/d, q_y_2 = (xb yg - 3 xg yb)/d,  d = 3(xb - xg)
    """
    inv8 = pow(8, -1, P)
    out = []
    dinvs = _batch_inverse([3 * (one[0] - three[0]) % P for one, three in lad])
    for (one, three), dinv in zip(lad, dinvs):
        xb, yb = one
        xg, yg = three
        q_x_1 = (xg - xb) * inv8 % P
        q_x_2 = (9 * xb - xg) * inv8 % P
        q_y_1 = (3 * yb - yg) * dinv % P
        q_y_2 = (xb * yg - 3 * xg * yb) * dinv % P
        out.append((q_x_1, q_x_2, q_y_1, q_y_2))
    return out


def ladder_selectors(generator_index: int, hash_variant: bool = False):
    lad = _hash_ladder(generator_index) if hash_variant else _ladder(generator_index)
    return selectors_from_ladder(tuple(lad))


@functools.lru_cache(maxsize=None)
def _hash_ladder(hash_index: int) -> List[Tuple]:
    """Stitched ladder: 127 high quads on generator 2i, 2 low quads on
    generator 2i+1 (ref: pedersen.cpp:91-104)."""
    lad_a = _ladder(hash_index * 2)
    lad_b = _ladder(hash_index * 2 + 1)
    first_seg = QUAD_LENGTH - 2
    return [lad_a[j + (QUAD_LENGTH - first_seg)] for j in range(first_seg)] + [
        lad_b[j + (QUAD_LENGTH - 2)] for j in range(2)
    ]


MASK64 = (1 << 64) - 1


def fixed_wnaf(scalar: int, num_bits: int, wnaf_bits: int = 2) -> Tuple[List[int], bool]:
    """2-bit fixed-window NAF (ref: ecc/groups/wnaf.hpp:163-191).

    Returns (entries MSB-first, skew).  Entry layout matches the reference:
    low bits = digit>>1, bit 31 = negative.
    """
    entries_n = (num_bits + wnaf_bits - 1) // wnaf_bits
    mask = (1 << wnaf_bits) - 1
    skew = (scalar & 1) == 0
    wnaf = [0] * entries_n
    previous = ((scalar >> 0) & mask) + (1 if skew else 0)
    for round_i in range(1, entries_n - 1):
        slice_ = (scalar >> (round_i * wnaf_bits)) & mask
        predicate = 1 if (slice_ & 1) == 0 else 0
        v = (previous - (predicate << wnaf_bits)) & MASK64
        if predicate:
            v ^= MASK64
        wnaf[entries_n - round_i] = (v >> 1) | (predicate << 31)
        previous = slice_ + predicate
    final_bits = num_bits - wnaf_bits * (entries_n - 1)
    slice_ = (scalar >> ((entries_n - 1) * wnaf_bits)) & ((1 << final_bits) - 1)
    predicate = 1 if (slice_ & 1) == 0 else 0
    v = (previous - (predicate << wnaf_bits)) & MASK64
    if predicate:
        v ^= MASK64
    wnaf[1] = (v >> 1) | (predicate << 31)
    wnaf[0] = (slice_ + predicate) >> 1
    return wnaf, skew


def g_mul(k: int, a):
    """k * a, most significant bit first."""
    acc = None
    for bit in bin(k)[2:] if k > 0 else ():
        acc = _j_dbl(acc)
        if bit == "1":
            acc = _j_add(acc, a)
    return _affine(acc)


def num_quads_for(num_bits: int) -> int:
    base = (num_bits - 1) >> 1
    return base + 1 if (base << 1) + 1 < num_bits else base


def _ladder_mul(value: int, num_bits: int, full_ladder, skew_point):
    """Shared fixed-base ladder walk (ref: group.hpp
    fixed_base_scalar_mul_internal / pedersen.hpp:44-80)."""
    value %= P
    n = num_quads_for(num_bits)
    ladder = full_ladder[QUAD_LENGTH - n - 1 :]
    base = value if (value & 1) else (value - 2) % P
    wnaf, skew = fixed_wnaf(base, (n << 1) + 1, 2)
    acc = _j_add(None, ladder[0][0])
    if skew:
        acc = _j_add(acc, skew_point)
    for i in range(n):
        entry = wnaf[i + 1]
        pt = ladder[i + 1][1] if (entry & 0xFFFFFF) == 1 else ladder[i + 1][0]
        acc = _j_add(acc, g_neg(pt) if (entry >> 31) & 1 else pt)
    return _affine(acc)


def fixed_base_scalar_mul(value: int, num_bits: int, generator_index: int = 0):
    """value * G_idx via the ladder (ref: pedersen.hpp:44-80)."""
    return _ladder_mul(value, num_bits, _ladder(generator_index),
                       get_generator(generator_index))


def fixed_base_scalar_mul_g1(value: int, num_bits: int):
    """value * grumpkin-g1::one (ref: group.hpp fixed_base_scalar_mul_g1)."""
    return _ladder_mul(value, num_bits, g1_ladder(), GRUMPKIN_GEN)


def hash_single(value: int, hash_index: int):
    """ref: pedersen.cpp:230-272."""
    value %= P
    # ladder slice for 254 bits: drop the first entry (get_ladder_internal)
    ladder = _hash_ladder(hash_index)[QUAD_LENGTH - NUM_QUADS - 1 :]
    base = value if (value & 1) else (value - 2) % P
    wnaf, skew = fixed_wnaf(base, 2 * NUM_QUADS + 1, 2)

    acc = _j_add(None, ladder[0][0])
    if skew:
        acc = _j_add(acc, get_generator(hash_index * 2 + 1))
    for i in range(NUM_QUADS):
        entry = wnaf[i + 1]
        pt = ladder[i + 1][1] if (entry & 0xFFFFFF) == 1 else ladder[i + 1][0]
        acc = _j_add(acc, g_neg(pt) if (entry >> 31) & 1 else pt)
    if value == 0:
        return None
    return _affine(acc)


def compress_native(left: int, right: int, hash_index: int = 0) -> int:
    """ref: pedersen.cpp:274-299 (infinity -> x = 0, the affine_element(0,0)
    convention used by encrypt_native)."""
    r = g_add(hash_single(left, hash_index), hash_single(right, hash_index + 1))
    return r[0] if r is not None else 0


def encrypt_native(inputs, hash_index: int = 0):
    acc = None
    for i, v in enumerate(inputs):
        acc = g_add(acc, hash_single(v, hash_index + i))
    return acc if acc is not None else (0, 0)


def compress_many(inputs, hash_index: int = 0) -> int:
    return encrypt_native(inputs, hash_index)[0]


def compress_buffer_to_field(data: bytes) -> int:
    """ref: pedersen.cpp compress_native_buffer_to_field — 31-byte chunks."""
    chunk = 31
    elements = [
        int.from_bytes(data[i : i + chunk], "big") % P
        for i in range(0, len(data), chunk)
    ]
    return compress_many(elements)
