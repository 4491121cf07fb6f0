"""In-circuit SHA-256 over stdlib uint32 (ref: stdlib/hash/sha256/).

Used by the account/alias hashing paths and the root rollup's public-input
hash.  The compression function is adds, xors, and fixed rotations/shifts —
all gate-backed UInt32 ops.  Input enters as 8-bit-constrained byte
witnesses (big-endian words, standard SHA-256 padding applied in-circuit
with constant padding bytes).

Port of aztec_tpu/stdlib/sha256_circuit.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

from typing import List

from .field_t import FieldT
from .uint32 import UInt32

K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)


def _word_from_bytes_be(ctx, bs: List[FieldT]) -> UInt32:
    """4 big-endian 8-bit byte witnesses -> UInt32 (one linear gate chain;
    the word is < 2^32 by construction of its bytes)."""
    acc = FieldT.constant(0)
    for b in bs:
        acc = acc * 256 + b
    if acc.is_constant():
        return UInt32.from_constant(ctx, acc.get_value())
    return UInt32(ctx, acc.normalize().witness_index)


def _compress(ctx, state: List[UInt32], w: List[UInt32]) -> List[UInt32]:
    for t in range(16, 64):
        s0 = w[t - 15].ror(7) ^ w[t - 15].ror(18) ^ (w[t - 15] >> 3)
        s1 = w[t - 2].ror(17) ^ w[t - 2].ror(19) ^ (w[t - 2] >> 10)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = e.ror(6) ^ e.ror(11) ^ e.ror(25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + UInt32.from_constant(ctx, K[t]) + w[t]
        S0 = a.ror(2) ^ a.ror(13) ^ a.ror(22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    return [x + y for x, y in
            zip(state, [a, b, c, d, e, f, g, h])]


def sha256_bytes(ctx, msg_bytes: List[FieldT]) -> List[FieldT]:
    """SHA-256 of in-circuit bytes -> 32 in-circuit digest bytes."""
    from .byte_array import field_to_bytes

    n = len(msg_bytes)
    bitlen = 8 * n
    padded = list(msg_bytes) + [FieldT.constant(0x80)]
    while (len(padded) + 8) % 64:
        padded.append(FieldT.constant(0))
    padded += [FieldT.constant(b) for b in bitlen.to_bytes(8, "big")]

    state = [UInt32.from_constant(ctx, h) for h in H0]
    for off in range(0, len(padded), 64):
        block = padded[off:off + 64]
        w = [_word_from_bytes_be(ctx, block[4 * i:4 * i + 4])
             for i in range(16)]
        state = _compress(ctx, state, w)

    out: List[FieldT] = []
    for word in state:
        wf = FieldT(ctx, word.witness_index, 0, 1)
        out.extend(field_to_bytes(wf, 4))
    return out
