"""bit_array: in-circuit bit vector (ref: stdlib/primitives/bit_array/
bit_array.hpp/.cpp).

Bits are stored LSB-first (index 0 = least-significant), matching the
reference's internal layout after its constructor reversal.  Every witness
bit carries a bool gate; conversions to/from byte_array and UInt32 words
constrain exact recomposition, so a bit_array is a sound bridge between
hash circuits (sha256/blake2s operate on words) and bitwise circuit logic.

Port of aztec_tpu/stdlib/bit_array.py.
"""

from __future__ import annotations

from typing import List, Sequence

from .field_t import FieldT
from .uint32 import UInt32


class BitArray:
    """A fixed-length vector of in-circuit bools."""

    def __init__(self, ctx, bits: List[FieldT]):
        self.ctx = ctx
        self.bits = bits  # LSB-first

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_size(ctx, n: int) -> "BitArray":
        """n zero bits (ref: bit_array(parent_context, n))."""
        return BitArray(ctx, [FieldT.constant(0) for _ in range(n)])

    @staticmethod
    def from_bytes(ctx, data: bytes) -> "BitArray":
        """Witness the bits of a byte string, MSB-of-first-byte = highest
        bit index (the reference's string constructor semantics)."""
        n = len(data) * 8
        v = int.from_bytes(data, "big")
        bits = []
        for i in range(n):  # LSB-first
            b = FieldT.from_witness(ctx, (v >> i) & 1)
            ctx.create_bool_gate(b.witness_index)
            bits.append(b)
        return BitArray(ctx, bits)

    @staticmethod
    def from_byte_array(ctx, byte_fs: Sequence[FieldT]) -> "BitArray":
        """Decompose big-endian in-circuit bytes into constrained bits
        (ref: bit_array(byte_array) — per-byte recomposition gates)."""
        bits: List[FieldT] = []
        for byte in reversed(list(byte_fs)):  # last byte = lowest bits
            bv = byte.get_value()
            acc = FieldT.constant(0)
            byte_bits = []
            for j in range(8):
                b = FieldT.from_witness(ctx, (bv >> j) & 1)
                ctx.create_bool_gate(b.witness_index)
                byte_bits.append(b)
            for b in reversed(byte_bits):
                acc = acc * 2 + b
            acc.assert_equal(byte, "bit_array byte recomposition")
            bits.extend(byte_bits)
        return BitArray(ctx, bits)

    @staticmethod
    def from_uint32s(ctx, words: Sequence[UInt32]) -> "BitArray":
        """Concatenate uint32 words, word 0 = most-significant (ref:
        bit_array(std::array<uint32, N>)).  Each word is decomposed into
        bool-gated bit witnesses with a recomposition constraint."""
        bits: List[FieldT] = []
        for w in reversed(list(words)):
            wv = w.get_value()
            word_bits = []
            for j in range(32):
                b = FieldT.from_witness(ctx, (wv >> j) & 1)
                ctx.create_bool_gate(b.witness_index)
                word_bits.append(b)
            acc = FieldT.constant(0)
            for b in reversed(word_bits):
                acc = acc * 2 + b
            acc.assert_equal(FieldT(ctx, w.witness_index),
                             "bit_array word recomposition")
            bits.extend(word_bits)
        return BitArray(ctx, bits)

    # -- accessors ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.bits)

    def __getitem__(self, i: int) -> FieldT:
        return self.bits[i]

    def __setitem__(self, i: int, b: FieldT) -> None:
        self.bits[i] = b

    def get_value(self) -> int:
        v = 0
        for i, b in enumerate(self.bits):
            v |= int(b.get_value()) << i
        return v

    # -- conversions ----------------------------------------------------------

    def to_uint32s(self) -> List[UInt32]:
        """Split into uint32 words, most-significant word first (ref:
        populate_uint32_array).  Length must be a multiple of 32."""
        assert len(self.bits) % 32 == 0, "bit_array length not word-aligned"
        words = []
        for base in reversed(range(0, len(self.bits), 32)):
            chunk = self.bits[base:base + 32]
            acc = FieldT.constant(0)
            for b in reversed(chunk):
                acc = acc * 2 + b
            v = sum(int(b.get_value()) << i for i, b in enumerate(chunk))
            w = UInt32(self.ctx, self.ctx.add_variable(v))
            acc.assert_equal(FieldT(self.ctx, w.witness_index),
                             "bit_array word recomposition")
            words.append(w)
        return words

    def to_bytes_value(self) -> bytes:
        """Host-side value as bytes (length must be byte-aligned)."""
        assert len(self.bits) % 8 == 0
        return self.get_value().to_bytes(len(self.bits) // 8, "big")
