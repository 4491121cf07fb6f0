"""Width-generic in-circuit unsigned integers: uint8/16/32/64
(ref: stdlib/primitives/uint/*.cpp — reshaped around the turbo
range/logic accumulator gates rather than the reference's lazy-accumulator
class; uint32.py's UInt32 is the width-32 instance).

Every value wraps one range-constrained witness.  Arithmetic is mod 2^W
(carry/borrow/overflow witnessed and range-constrained away); AND/XOR ride
the turbo logic constraint; rotations/shifts split at the pivot bit with
two range constraints and recombine linearly.

Port of aztec_tpu/stdlib/uint.py, on the port's composers: host Python, so
the same inputs record the same gates.
"""

from __future__ import annotations

import dataclasses

from ..ff.bn254 import FR_MOD
from ..plonk.composer import AddTriple, TurboComposer

M = FR_MOD


@dataclasses.dataclass
class UIntBase:
    ctx: TurboComposer
    witness_index: int  # range-constrained to WIDTH bits

    WIDTH = 32

    @classmethod
    def mask(cls) -> int:
        return (1 << cls.WIDTH) - 1

    @classmethod
    def from_witness(cls, ctx: TurboComposer, value: int):
        idx = ctx.add_variable(value & cls.mask())
        ctx.create_range_constraint(idx, cls.WIDTH)
        return cls(ctx, idx)

    @classmethod
    def from_constant(cls, ctx: TurboComposer, value: int):
        return cls(ctx, ctx.put_constant_variable(value & cls.mask()))

    def get_value(self) -> int:
        return self.ctx.get_variable(self.witness_index) & self.mask()

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, other):
        cls = type(self)
        W = cls.WIDTH
        ctx = self.ctx
        total = (self.ctx.get_variable(self.witness_index)
                 + ctx.get_variable(other.witness_index))
        r_idx = ctx.add_variable(total & cls.mask())
        carry_idx = ctx.add_variable(total >> W)
        ctx.create_bool_gate(carry_idx)
        ctx.create_range_constraint(r_idx, W)
        # a + b - r - 2^W * carry == 0
        ctx.create_big_add_gate(
            self.witness_index, other.witness_index, r_idx, carry_idx,
            1, 1, (-1) % M, (-(1 << W)) % M, 0,
        )
        return cls(ctx, r_idx)

    def __sub__(self, other):
        cls = type(self)
        W = cls.WIDTH
        ctx = self.ctx
        a, b = self.get_value(), other.get_value()
        r_idx = ctx.add_variable((a - b) & cls.mask())
        borrow_idx = ctx.add_variable(1 if a < b else 0)
        ctx.create_bool_gate(borrow_idx)
        ctx.create_range_constraint(r_idx, W)
        # a - b - r + 2^W * borrow == 0
        ctx.create_big_add_gate(
            self.witness_index, other.witness_index, r_idx, borrow_idx,
            1, (-1) % M, (-1) % M, (1 << W) % M, 0,
        )
        return cls(ctx, r_idx)

    def __mul__(self, other):
        cls = type(self)
        W = cls.WIDTH
        ctx = self.ctx
        prod = self.get_value() * other.get_value()
        r_idx = ctx.add_variable(prod & cls.mask())
        ovf_idx = ctx.add_variable(prod >> W)
        ctx.create_range_constraint(r_idx, W)
        ctx.create_range_constraint(ovf_idx, W)
        # a*b - r - 2^W * ovf == 0
        ctx.create_big_mul_gate(
            self.witness_index, other.witness_index, r_idx, ovf_idx,
            1, 0, 0, (-1) % M, (-(1 << W)) % M, 0,
        )
        return cls(ctx, r_idx)

    # -- bitwise --------------------------------------------------------------
    def __and__(self, other):
        acc = self.ctx.create_and_constraint(
            self.witness_index, other.witness_index, type(self).WIDTH
        )
        return type(self)(self.ctx, acc["out"][-1])

    def __xor__(self, other):
        acc = self.ctx.create_xor_constraint(
            self.witness_index, other.witness_index, type(self).WIDTH
        )
        return type(self)(self.ctx, acc["out"][-1])

    def __or__(self, other):
        # a | b = (a ^ b) + (a & b)
        return (self ^ other) + (self & other)

    def __invert__(self):
        ones = type(self).from_constant(self.ctx, self.mask())
        return ones ^ self

    # -- rotations / shifts ---------------------------------------------------
    def _split(self, k: int):
        """a = hi * 2^k + lo with lo < 2^k, hi < 2^{W-k} (two range gates)."""
        W = type(self).WIDTH
        ctx = self.ctx
        a = self.get_value()
        lo_idx = ctx.add_variable(a & ((1 << k) - 1))
        hi_idx = ctx.add_variable(a >> k)
        ctx.create_range_constraint(lo_idx, k)
        ctx.create_range_constraint(hi_idx, W - k)
        ctx.create_add_gate(
            AddTriple(hi_idx, lo_idx, self.witness_index,
                      (1 << k) % M, 1, (-1) % M, 0)
        )
        return lo_idx, hi_idx

    def ror(self, k: int):
        cls = type(self)
        W = cls.WIDTH
        k %= W
        if k == 0:
            return self
        ctx = self.ctx
        lo_idx, hi_idx = self._split(k)
        v = self.get_value()
        out_idx = ctx.add_variable(((v >> k) | (v << (W - k))) & cls.mask())
        ctx.create_add_gate(
            AddTriple(hi_idx, lo_idx, out_idx, 1, (1 << (W - k)) % M,
                      (-1) % M, 0)
        )
        return cls(ctx, out_idx)

    def rol(self, k: int):
        W = type(self).WIDTH
        return self.ror((W - k) % W)

    def __rshift__(self, k: int):
        k %= type(self).WIDTH
        if k == 0:
            return self
        _, hi_idx = self._split(k)
        return type(self)(self.ctx, hi_idx)

    def __lshift__(self, k: int):
        cls = type(self)
        W = cls.WIDTH
        k %= W
        if k == 0:
            return self
        ctx = self.ctx
        lo_idx, _ = self._split(W - k)
        out_idx = ctx.add_variable((self.get_value() << k) & cls.mask())
        ctx.create_add_gate(
            AddTriple(lo_idx, ctx.zero_idx, out_idx, (1 << k) % M, 0,
                      (-1) % M, 0)
        )
        return cls(ctx, out_idx)


class UInt8(UIntBase):
    WIDTH = 8


class UInt16(UIntBase):
    WIDTH = 16


class UInt64(UIntBase):
    WIDTH = 64
