"""byte_array: in-circuit byte decomposition of field elements
(ref: stdlib/primitives/byte_array/byte_array.cpp).

Decomposes a FieldT into big-endian bytes with 8-bit range constraints and
an exact recomposition constraint — the bridge between field elements and
the uint32/blake2s layer in the recursive transcript.

Port of aztec_tpu/stdlib/byte_array.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

from typing import List

from ..ff.bn254 import FR_MOD
from .field_t import FieldT
from .uint32 import UInt32

M = FR_MOD


def field_to_bytes(inp: FieldT, num_bytes: int = 32) -> List[FieldT]:
    """Witness big-endian bytes of a (normalized) field element and
    constrain their recomposition to equal it."""
    if inp.is_constant():
        v = inp.get_value()
        return [
            FieldT.constant((v >> (8 * (num_bytes - 1 - i))) & 0xFF)
            for i in range(num_bytes)
        ]
    ctx = inp.ctx
    a = inp.normalize()
    v = a.get_value()
    assert v < (1 << (8 * num_bytes))
    if num_bytes > 32:
        raise NotImplementedError("witness decomposition beyond 32 bytes")
    byte_vals = [(v >> (8 * (num_bytes - 1 - i))) & 0xFF for i in range(num_bytes)]
    out = []
    acc = FieldT.constant(0)
    for bv in byte_vals:
        b = FieldT.from_witness(ctx, bv)
        ctx.create_range_constraint(b.witness_index, 8)
        out.append(b)
        acc = acc * 256 + b
    acc.assert_equal(a, "byte_array recomposition")
    if num_bytes == 32:
        _constrain_canonical(ctx, out, v)
    return out


def _constrain_canonical(ctx, out: List[FieldT], v: int) -> None:
    """Constrain a 32-byte decomposition to be the CANONICAL representation
    (value < r), mirroring the reference's 'validate input bytes < p'
    borrow-chain (stdlib/primitives/byte_array/byte_array.cpp).

    Without this, any v with v + r < 2^256 has a second valid byte string
    (the bytes of v + r): in the recursive transcript that is a free
    re-roll of every in-circuit Fiat-Shamir challenge (ADVICE r1, high).

    Split the bytes into hi/lo 128-bit halves and prove val <= r - 1:
      y_lo = (r-1)_lo + 2^128 - lo   (in (0, 2^129); no wrap mod r)
      b    = bit 128 of y_lo         (b = 1  iff  lo <= (r-1)_lo)
      y_lo - b*2^128                 range-constrained to 128 bits
      y_hi = (r-1)_hi - hi - (1-b)   range-constrained to 128 bits
    Completeness: every val < r admits such a (b, y_lo, y_hi); soundness:
    the two range checks force hi*2^128 + lo <= r - 1."""
    rm1 = M - 1
    r_lo = rm1 & ((1 << 128) - 1)
    r_hi = rm1 >> 128
    hi = FieldT.constant(0)
    lo = FieldT.constant(0)
    for b in out[:16]:
        hi = hi * 256 + b
    for b in out[16:]:
        lo = lo * 256 + b
    v_lo = v & ((1 << 128) - 1)
    borrow = 1 if v_lo <= r_lo else 0
    y_lo = FieldT.constant(r_lo + (1 << 128)) - lo
    bw = FieldT.from_witness(ctx, borrow)
    ctx.create_bool_gate(bw.witness_index)
    y_lo_low = (y_lo - bw * (1 << 128)).normalize()
    ctx.create_range_constraint(y_lo_low.witness_index, 128)
    y_hi = (FieldT.constant(r_hi) - hi - (FieldT.constant(1) - bw)).normalize()
    ctx.create_range_constraint(y_hi.witness_index, 128)


def bytes_to_uint32_words_le(byte_fields: List[FieldT],
                             ctx=None) -> List[UInt32]:
    """Pack in-circuit bytes (big-endian list) into little-endian uint32
    words as blake2s consumes them (4 bytes per word, LE within word)."""
    assert len(byte_fields) % 4 == 0
    if ctx is None:
        ctx = next(b.ctx for b in byte_fields if b.ctx is not None)
    words = []
    for i in range(0, len(byte_fields), 4):
        w = (
            byte_fields[i]
            + byte_fields[i + 1] * (1 << 8)
            + byte_fields[i + 2] * (1 << 16)
            + byte_fields[i + 3] * (1 << 24)
        )
        # bytes are LE within the word (byte i is the LOW byte); the word is
        # < 2^32 by construction of its 8-bit-constrained bytes
        if w.is_constant():
            words.append(UInt32.from_constant(ctx, w.get_value()))
        else:
            words.append(UInt32(ctx, w.normalize().witness_index))
    return words
