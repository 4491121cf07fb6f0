"""In-circuit Grumpkin group ops over the NATIVE field.

Grumpkin's coordinate field is Fr — the outer circuit's native field — so
point arithmetic is plain FieldT gates (slope via constrained inversion),
orders of magnitude cheaper than bigfield/biggroup.  This is the group
under the reference's in-circuit Pedersen and Schnorr
(stdlib/encryption/schnorr; curve y^2 = x^3 - 17, grumpkin.hpp:11-29).

Port of aztec_tpu/stdlib/group_native.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..ff.bn254 import FR_MOD
from ..crypto.pedersen import GRUMPKIN_GEN, g_mul, g_neg
from .field_t import FieldT

M = FR_MOD

# offset generator for incomplete-addition safety in scalar-mul ladders
# (scalar reduced mod the grumpkin group order = FQ_MOD)
from ..ff.bn254 import FQ_MOD

_OFFSET_SCALAR = int.from_bytes(b"aztec_tpu.grumpkin.offset.v1\x00\x00\x00\x00",
                                "big") % FQ_MOD
OFFSET_GEN = g_mul(_OFFSET_SCALAR, GRUMPKIN_GEN)


@dataclasses.dataclass
class NativePoint:
    x: FieldT
    y: FieldT

    @staticmethod
    def from_witness(ctx, pt: Tuple[int, int]) -> "NativePoint":
        p = NativePoint(FieldT.from_witness(ctx, pt[0]),
                        FieldT.from_witness(ctx, pt[1]))
        p.validate_on_curve()
        return p

    @staticmethod
    def from_constant(pt: Tuple[int, int]) -> "NativePoint":
        return NativePoint(FieldT.constant(pt[0]), FieldT.constant(pt[1]))

    def get_value(self) -> Tuple[int, int]:
        return (self.x.get_value(), self.y.get_value())

    def validate_on_curve(self):
        """y^2 == x^3 - 17."""
        yy = self.y * self.y
        xxx = self.x * self.x * self.x
        (xxx - yy - 17).assert_equal(0, "grumpkin point not on curve")

    def add(self, other: "NativePoint") -> "NativePoint":
        """Incomplete affine add (x1 != x2; ladder offsets guarantee it)."""
        lam = (other.y - self.y) / (other.x - self.x)
        x3 = (lam * lam - self.x - other.x).normalize()
        y3 = (lam * (self.x - x3) - self.y).normalize()
        return NativePoint(x3, y3)

    def dbl(self) -> "NativePoint":
        xx = self.x * self.x
        lam = (xx + xx + xx) / (self.y + self.y)
        x3 = (lam * lam - self.x - self.x).normalize()
        y3 = (lam * (self.x - x3) - self.y).normalize()
        return NativePoint(x3, y3)

    @staticmethod
    def select(bit: FieldT, a: "NativePoint", b: "NativePoint"):
        return NativePoint(
            (b.x + bit * (a.x - b.x)).normalize(),
            (b.y + bit * (a.y - b.y)).normalize(),
        )


def bits_from_bytes_be(ctx, byte_fs: List[FieldT]) -> List[FieldT]:
    """8-bit byte witnesses -> little-endian bool-constrained bit list,
    with per-byte recomposition constraints."""
    bits: List[FieldT] = []
    for byte_f in reversed(byte_fs):  # LSB byte first
        bv = byte_f.get_value()
        acc = FieldT.constant(0)
        byte_bits = []
        for i in range(8):
            b = FieldT.from_witness(ctx, (bv >> i) & 1)
            ctx.create_bool_gate(b.witness_index)
            byte_bits.append(b)
        for b in reversed(byte_bits):
            acc = acc * 2 + b
        acc.assert_equal(byte_f, "byte bit recomposition")
        bits.extend(byte_bits)
    return bits


def batch_mul_native(ctx, points: List[NativePoint],
                     bitlists: List[List[FieldT]]) -> NativePoint:
    """sum_i scalar_i * P_i, scalars as little-endian bit lists (equal
    lengths).  Joint double-and-add seeded with OFFSET_GEN, offset
    subtracted after the ladder (multiples mod the group order)."""
    bits = len(bitlists[0])
    assert all(len(b) == bits for b in bitlists)
    acc = NativePoint.from_constant(OFFSET_GEN)
    for k in reversed(range(bits)):
        acc = acc.dbl()
        for P, bl in zip(points, bitlists):
            added = acc.add(P)
            acc = NativePoint.select(bl[k], added, acc)
    shift = g_mul(pow(2, bits, FQ_MOD) * _OFFSET_SCALAR % FQ_MOD,
                  GRUMPKIN_GEN)
    return acc.add(NativePoint.from_constant(g_neg(shift)))
