"""biggroup: BN254 G1 operations over bigfield coordinates
(ref: stdlib/primitives/biggroup/biggroup_impl.hpp).

Affine incomplete addition/doubling with witnessed slope: lambda is
introduced as a bigfield witness and tied down by a multiply-add identity;
scalar multiplication is double-and-add over the bit decomposition of a
native-field scalar witness (a batch_mul with WNAF tables is the phase-8
performance upgrade, per the reference's batch_mul).

Port of aztec_tpu/stdlib/biggroup.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..ff.bn254 import FQ_MOD
from ..curves.pairing import g1_add, g1_dbl, g1_mul
from .bigfield import BigField, TARGET
from .field_t import FieldT, BoolT

Q = FQ_MOD


@dataclasses.dataclass
class BigGroup:
    x: BigField
    y: BigField

    @staticmethod
    def from_witness(ctx, pt: Tuple[int, int]) -> "BigGroup":
        g = BigGroup(BigField.from_witness(ctx, pt[0]),
                     BigField.from_witness(ctx, pt[1]))
        g.validate_on_curve(ctx)
        return g

    @staticmethod
    def from_constant(ctx, pt: Tuple[int, int]) -> "BigGroup":
        return BigGroup(BigField.from_constant(ctx, pt[0]),
                        BigField.from_constant(ctx, pt[1]))

    def get_value(self) -> Tuple[int, int]:
        return (self.x.get_value() % Q, self.y.get_value() % Q)

    def validate_on_curve(self, ctx):
        """y^2 == x^3 + 3: (y*y - 3) == x*(x*x)."""
        xx = self.x * self.x
        rhs = xx.madd(self.x, [BigField.from_constant(ctx, 3)])
        yy = self.y * self.y
        yy.assert_equal(rhs, "biggroup point not on curve")

    def add(self, other: "BigGroup", ctx) -> "BigGroup":
        """Incomplete addition (x1 != x2 required, prover-complete inputs)."""
        p1 = self.get_value()
        p2 = other.get_value()
        p3 = g1_add(p1, p2)
        lam_v = (p2[1] - p1[1]) * pow(p2[0] - p1[0], -1, Q) % Q
        lam = BigField.from_witness(ctx, lam_v)
        # lambda * (x2 - x1) + y1 == y2
        chk = lam.madd(other.x - self.x, [self.y])
        chk.assert_equal(other.y, "biggroup add slope")
        # x3 = lambda^2 - x1 - x2:  lambda*lambda == x3 + x1 + x2
        x3 = BigField.from_witness(ctx, p3[0])
        chk2 = lam.madd(lam, [])
        chk2.assert_equal(_canon(x3 + self.x + other.x, ctx), "biggroup add x3")
        # y3 = lambda (x1 - x3) - y1:  lambda*(x1-x3) == y3 + y1
        y3 = BigField.from_witness(ctx, p3[1])
        chk3 = lam.madd(self.x - x3, [])
        chk3.assert_equal(_canon(y3 + self.y, ctx), "biggroup add y3")
        return BigGroup(x3, y3)

    def dbl(self, ctx) -> "BigGroup":
        p1 = self.get_value()
        p3 = g1_dbl(p1)
        lam_v = 3 * p1[0] * p1[0] * pow(2 * p1[1], -1, Q) % Q
        lam = BigField.from_witness(ctx, lam_v)
        # lambda * 2y == 3 x^2 :  lambda*(y+y) == xx + xx + xx
        xx = self.x * self.x
        chk = lam.madd(self.y + self.y, [])
        chk.assert_equal(_canon(xx + xx + xx, ctx), "biggroup dbl slope")
        x3 = BigField.from_witness(ctx, p3[0])
        chk2 = lam.madd(lam, [])
        chk2.assert_equal(_canon(x3 + self.x + self.x, ctx), "biggroup dbl x3")
        y3 = BigField.from_witness(ctx, p3[1])
        chk3 = lam.madd(self.x - x3, [])
        chk3.assert_equal(_canon(y3 + self.y, ctx), "biggroup dbl y3")
        return BigGroup(x3, y3)


def _canon(v: BigField, ctx) -> BigField:
    """Reduce a lazy bigfield to its canonical remainder witness."""
    return v.reduce()
