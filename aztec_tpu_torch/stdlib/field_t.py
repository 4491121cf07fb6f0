"""field_t / bool_t witness wrappers (ref: stdlib/primitives/field/field.cpp,
stdlib/primitives/bool/bool.cpp).  Port of aztec_tpu/stdlib/field_t.py, on
the port's composers.

A FieldT represents ``witness * multiplicative_constant + additive_constant``
without materializing gates; constants compose for free and a gate is only
created when two genuine witnesses interact or a normalized witness is
required — the same lazy algebra as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ff.bn254 import FR_MOD
from ..plonk.composer import AddTriple, PolyTriple

M = FR_MOD
IS_CONSTANT = None


@dataclasses.dataclass
class FieldT:
    ctx: Optional[object]
    witness_index: Optional[int] = IS_CONSTANT
    additive_constant: int = 0
    multiplicative_constant: int = 1

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def constant(v: int) -> "FieldT":
        return FieldT(None, IS_CONSTANT, v % M, 1)

    @staticmethod
    def from_witness(ctx, value: int) -> "FieldT":
        return FieldT(ctx, ctx.add_variable(value % M), 0, 1)

    def is_constant(self) -> bool:
        return self.witness_index is IS_CONSTANT

    def get_value(self) -> int:
        if self.is_constant():
            return self.additive_constant % M
        return (
            self.ctx.get_variable(self.witness_index) * self.multiplicative_constant
            + self.additive_constant
        ) % M

    def _ctx(self, other=None):
        return self.ctx or (other.ctx if other is not None else None)

    # -- arithmetic (ref: field.cpp:86-198) -----------------------------------
    def __add__(self, other):
        if isinstance(other, int):
            other = FieldT.constant(other)
        ctx = self._ctx(other)
        if (
            not self.is_constant()
            and self.witness_index == other.witness_index
        ):
            return FieldT(
                ctx, self.witness_index,
                (self.additive_constant + other.additive_constant) % M,
                (self.multiplicative_constant + other.multiplicative_constant) % M,
            )
        if self.is_constant() and other.is_constant():
            return FieldT.constant(self.additive_constant + other.additive_constant)
        if other.is_constant():
            return FieldT(
                ctx, self.witness_index,
                (self.additive_constant + other.additive_constant) % M,
                self.multiplicative_constant,
            )
        if self.is_constant():
            return other + self
        # both witnesses: one add gate
        out_val = self.get_value() + other.get_value()
        out_idx = ctx.add_variable(out_val % M)
        ctx.create_add_gate(
            AddTriple(
                self.witness_index, other.witness_index, out_idx,
                self.multiplicative_constant, other.multiplicative_constant,
                (-1) % M,
                (self.additive_constant + other.additive_constant) % M,
            )
        )
        return FieldT(ctx, out_idx, 0, 1)

    def __radd__(self, other):
        return self.__add__(other)

    def __neg__(self):
        return FieldT(
            self.ctx, self.witness_index,
            (-self.additive_constant) % M,
            (-self.multiplicative_constant) % M,
        )

    def __sub__(self, other):
        if isinstance(other, int):
            other = FieldT.constant(other)
        return self.__add__(other.__neg__())

    def __mul__(self, other):
        if isinstance(other, int):
            other = FieldT.constant(other)
        ctx = self._ctx(other)
        if self.is_constant() and other.is_constant():
            return FieldT.constant(self.additive_constant * other.additive_constant)
        if other.is_constant():
            return FieldT(
                ctx, self.witness_index,
                self.additive_constant * other.additive_constant % M,
                self.multiplicative_constant * other.additive_constant % M,
            )
        if self.is_constant():
            return other * self
        # both witnesses: poly gate (ref: field.cpp:142-198)
        q_c = self.additive_constant * other.additive_constant % M
        q_r = self.additive_constant * other.multiplicative_constant % M
        q_l = self.multiplicative_constant * other.additive_constant % M
        q_m = self.multiplicative_constant * other.multiplicative_constant % M
        left = ctx.get_variable(self.witness_index)
        right = ctx.get_variable(other.witness_index)
        out = (left * right % M * q_m + left * q_l + right * q_r + q_c) % M
        out_idx = ctx.add_variable(out)
        ctx.create_poly_gate(
            PolyTriple(self.witness_index, other.witness_index, out_idx,
                       q_m, q_l, q_r, (-1) % M, q_c)
        )
        return FieldT(ctx, out_idx, 0, 1)

    def __rmul__(self, other):
        return self.__mul__(other)

    def invert(self) -> "FieldT":
        """Witness 1/x with an x*inv == 1 constraint."""
        if self.is_constant():
            return FieldT.constant(pow(self.get_value(), -1, M))
        ctx = self.ctx
        a = self.normalize()
        inv_val = pow(a.get_value(), -1, M)
        inv = FieldT.from_witness(ctx, inv_val)
        prod = a * inv
        prod.assert_equal(FieldT.constant(1))
        return inv

    def __truediv__(self, other):
        if isinstance(other, int):
            other = FieldT.constant(other)
        return self * other.invert()

    # -- materialization -------------------------------------------------------
    def normalize(self) -> "FieldT":
        """ref: field.cpp:56-84."""
        if self.is_constant() or (
            self.multiplicative_constant == 1 and self.additive_constant == 0
        ):
            return self
        ctx = self.ctx
        out_idx = ctx.add_variable(self.get_value())
        ctx.create_add_gate(
            AddTriple(
                self.witness_index, self.witness_index, out_idx,
                self.multiplicative_constant, 0, (-1) % M,
                self.additive_constant,
            )
        )
        return FieldT(ctx, out_idx, 0, 1)

    def assert_equal(self, other, msg: str = "field_t::assert_equal"):
        if isinstance(other, int):
            other = FieldT.constant(other)
        if self.is_constant() and other.is_constant():
            assert self.get_value() == other.get_value(), msg
            return
        ctx = self._ctx(other)
        if other.is_constant():
            # fix witness: w*mul + add == const
            a = self.normalize()
            idx = ctx.put_constant_variable(other.get_value())
            ctx.assert_equal(a.witness_index, idx, msg)
            return
        if self.is_constant():
            other.assert_equal(self, msg)
            return
        a = self.normalize()
        b = other.normalize()
        ctx.assert_equal(a.witness_index, b.witness_index, msg)

    def is_zero_value(self) -> bool:
        return self.get_value() == 0

    def is_zero(self) -> "BoolT":
        """In-circuit zero test (ref: stdlib field.cpp is_zero): witness
        b and inv, constrain x*inv == 1 - b and x*b == 0 — the only
        satisfying assignments are (x==0, b=1) and (x!=0, b=0, inv=1/x)."""
        if self.is_constant():
            return BoolT.constant(self.get_value() == 0)
        x = self.normalize()
        v = x.get_value()
        b = BoolT.from_witness(self.ctx, v == 0)
        inv = FieldT.from_witness(self.ctx, pow(v, -1, M) if v else 1)
        (x * inv).assert_equal(FieldT.constant(1) - b.to_field(),
                               "is_zero: inverse check")
        (x * b.to_field()).assert_equal(FieldT.constant(0),
                                        "is_zero: zero product")
        return b

    def assert_is_not_zero(self, msg: str = "field_t: value is zero"):
        """Witness the inverse and constrain x * x^{-1} == 1
        (ref: field.cpp assert_is_not_zero)."""
        if self.is_constant():
            assert self.get_value() != 0, msg
            return
        x = self.normalize()
        v = x.get_value()
        inv = FieldT.from_witness(self.ctx, pow(v, -1, M) if v else 0)
        (x * inv).assert_equal(FieldT.constant(1), msg)

    def set_public(self):
        a = self.normalize()
        a.ctx.set_public_input(a.witness_index)
        return a


@dataclasses.dataclass
class BoolT:
    """Boolean witness; gates via the composer's bool gate
    (ref: stdlib/primitives/bool/bool.cpp).  Value = w XOR inverted."""

    ctx: Optional[object]
    witness_index: Optional[int] = IS_CONSTANT
    value: bool = False       # constant value if witness_index is None
    inverted: bool = False

    @staticmethod
    def constant(v: bool) -> "BoolT":
        return BoolT(None, IS_CONSTANT, bool(v), False)

    @staticmethod
    def from_witness(ctx, value: bool) -> "BoolT":
        idx = ctx.add_variable(1 if value else 0)
        ctx.create_bool_gate(idx)
        return BoolT(ctx, idx, bool(value), False)

    def is_constant(self) -> bool:
        return self.witness_index is IS_CONSTANT

    def get_value(self) -> bool:
        if self.is_constant():
            return self.value
        raw = self.ctx.get_variable(self.witness_index) != 0
        return raw != self.inverted

    def to_field(self) -> FieldT:
        if self.is_constant():
            return FieldT.constant(1 if self.get_value() else 0)
        f = FieldT(self.ctx, self.witness_index, 0, 1)
        if self.inverted:
            return FieldT.constant(1) - f
        return f

    def __invert__(self) -> "BoolT":
        if self.is_constant():
            return BoolT.constant(not self.value)
        return BoolT(self.ctx, self.witness_index, self.value, not self.inverted)

    def __and__(self, other: "BoolT") -> "BoolT":
        r = self.to_field() * other.to_field()
        return _bool_from_field(self.ctx or other.ctx, r)

    def __or__(self, other: "BoolT") -> "BoolT":
        a, b = self.to_field(), other.to_field()
        r = a + b - a * b
        return _bool_from_field(self.ctx or other.ctx, r)

    def __xor__(self, other: "BoolT") -> "BoolT":
        a, b = self.to_field(), other.to_field()
        r = a + b - (a * b) * 2
        return _bool_from_field(self.ctx or other.ctx, r)

    def assert_equal(self, other: "BoolT", msg="bool_t::assert_equal"):
        self.to_field().assert_equal(other.to_field(), msg)


def _bool_from_field(ctx, f: FieldT) -> BoolT:
    if f.is_constant():
        return BoolT.constant(f.get_value() != 0)
    n = f.normalize()
    return BoolT(ctx, n.witness_index, n.get_value() != 0, False)


def witness(ctx, value: int) -> FieldT:
    return FieldT.from_witness(ctx, value)


def public_witness(ctx, value: int) -> FieldT:
    f = FieldT.from_witness(ctx, value)
    ctx.set_public_input(f.witness_index)
    return f


def constant(value: int) -> FieldT:
    return FieldT.constant(value)
