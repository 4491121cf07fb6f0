"""In-circuit Pedersen hash + fixed-base scalar muls over the Turbo
fixed-base ECC gates (ref: stdlib/hash/pedersen/pedersen.cpp:38-196,
stdlib/primitives/group/group.hpp).

The shared ladder walk decomposes the (witnessed) input into 2-bit WNAF
quads and walks a precomputed generator ladder with one
create_fixed_group_add_gate per quad.  Each gate simultaneously constrains
the running scalar accumulator d and the ECC ladder point (a, b); the
final big-add row exposes the result and ties the reconstructed scalar
back to the input witness.

For 254-bit walks the WNAF sum w is only constrained mod r; hash
injectivity additionally needs w < r, enforced by validate_wnaf_is_in_field
(ref: pedersen.cpp:198-396 — schoolbook 126/128-bit limb subtraction from
r with two 128-bit range checks).

Port of aztec_tpu/stdlib/pedersen_circuit.py over the port's
``crypto/pedersen.py`` (the host generators, ladders and WNAF); gate
recording is host Python, so the same inputs give the same gates.
"""

from __future__ import annotations

from typing import List, Tuple

from ..crypto import pedersen as pd
from ..ff.bn254 import FR_MOD
from .field_t import FieldT, BoolT

M = FR_MOD


class Point:
    """An (x, y) pair of field_t — affine grumpkin point in-circuit
    (ref: stdlib/primitives/point.hpp)."""

    __slots__ = ("x", "y")

    def __init__(self, x: FieldT, y: FieldT):
        self.x = x
        self.y = y

    def get_value(self) -> Tuple[int, int]:
        return (self.x.get_value(), self.y.get_value())

    def __iter__(self):
        # (x, y) unpacking — callers predating the Point type rely on it
        return iter((self.x, self.y))


def _walk(start, steps):
    """[start, start + s_0, start + s_0 + s_1, ...] in affine coordinates:
    the sums in Jacobian coordinates, normalised together (one inversion),
    or by affine adds where a sum meets infinity."""
    jac = [(start[0], start[1], 1)]
    for pt in steps:
        jac.append(pd._j_add(jac[-1], pt))
        if jac[-1] is None:
            out = [start]
            for q in steps:
                out.append(pd.g_add(out[-1], q))
            return out
    zinv = pd._batch_inverse([z for _, _, z in jac])
    return [(X * zi * zi % pd.P, Y * zi * zi * zi % pd.P)
            for (X, Y, _), zi in zip(jac, zinv)]


def _ladder_walk(inp: FieldT, num_bits: int, full_ladder, skew_point,
                 conditional_scalar_check: bool):
    """Shared fixed-base gate walk.  Returns (Point, accumulator_witnesses).

    conditional_scalar_check: if True the reconstructed-scalar equality is
    gated on in != 0 (reconstructed*in == in*in), else asserted directly
    (ref: pedersen.cpp:183-190, group.hpp fixed_base_scalar_mul_internal).
    """
    ctx = inp.ctx
    scalar = inp.normalize()
    value = scalar.get_value()

    n = pd.num_quads_for(num_bits)
    ladder = full_ladder[pd.QUAD_LENGTH - n - 1:]
    selectors = pd.selectors_from_ladder(tuple(full_ladder))[
        pd.QUAD_LENGTH - n - 1:]

    origin_0 = ladder[0][0]
    origin_1 = pd.g_add(origin_0, skew_point)

    base = value if (value & 1) else (value - 2) % M
    wnaf, skew = pd.fixed_wnaf(base, 2 * n + 1, 2)

    initial_exponent = num_bits if (num_bits & 1) == 0 else num_bits - 1
    accumulator_offset = pow(pow(2, initial_exponent, M), -1, M)
    origin_acc = (1, (accumulator_offset + 1) % M)

    start = origin_1 if skew else origin_0
    acc_transcript = [origin_acc[1] if skew else origin_acc[0]]
    steps = []
    for i in range(n):
        entry = wnaf[i + 1]
        digit3 = (entry & 0xFFFFFF) == 1
        neg = (entry >> 31) & 1
        scalar_add = 3 if digit3 else 1
        pt = ladder[i + 1][1] if digit3 else ladder[i + 1][0]
        if neg:
            scalar_add = -scalar_add
            pt = pd.g_neg(pt)
        acc_transcript.append((4 * acc_transcript[i] + scalar_add) % M)
        steps.append(pt)
    mult_transcript = _walk(start, steps)

    init = (
        origin_0[0],
        (origin_0[0] - origin_1[0]) % M,
        origin_0[1],
        (origin_0[1] - origin_1[1]) % M,
    )

    accumulator_witnesses: List[int] = []
    x_alpha = accumulator_offset
    for i in range(n):
        d = ctx.add_variable(acc_transcript[i])
        a = ctx.add_variable(mult_transcript[i][0])
        b = ctx.add_variable(mult_transcript[i][1])
        if i == 0:
            c = ctx.put_constant_variable(x_alpha)
        else:
            c = ctx.add_variable(x_alpha)
        x_alpha = (
            ladder[i + 1][1][0]
            if (wnaf[i + 1] & 0xFFFFFF) == 1
            else ladder[i + 1][0][0]
        )
        q = selectors[i + 1]
        if i == 0:
            ctx.create_fixed_group_add_gate_with_init(
                a, b, c, d, q[0], q[1], q[2], q[3], *init
            )
        else:
            ctx.create_fixed_group_add_gate(a, b, c, d, q[0], q[1], q[2], q[3])
        accumulator_witnesses.append(d)

    out_x = ctx.add_variable(mult_transcript[n][0])
    out_y = ctx.add_variable(mult_transcript[n][1])
    out_alpha = ctx.add_variable(x_alpha)
    out_acc = ctx.add_variable(acc_transcript[n])
    ctx.create_big_add_gate(out_x, out_y, out_alpha, out_acc, 0, 0, 0, 0, 0)
    accumulator_witnesses.append(out_acc)

    reconstructed = FieldT(ctx, out_acc, 0, 1)
    if conditional_scalar_check:
        (reconstructed * scalar).assert_equal(
            scalar * scalar, "pedersen scalar reconstruction (conditional)")
    else:
        ctx.assert_equal(out_acc, scalar.witness_index,
                         "pedersen scalar reconstruction")

    return Point(FieldT(ctx, out_x, 0, 1), FieldT(ctx, out_y, 0, 1)), \
        accumulator_witnesses


def validate_wnaf_is_in_field(ctx, accumulators: List[int], inp: FieldT,
                              validate_edge_cases: bool):
    """Constrain the WNAF sum w < r (ref: pedersen.cpp:212-396).

    accumulators = the 128 running-sum witnesses of a 254-bit walk
    ([0] = origin 1 or 1+2^-254, [64] = top-64-quad sum, [-1] = w).
    Splits w into a 126-bit low limb and 128-bit high limb and verifies
    r - w >= 0 by schoolbook subtraction with two 128-bit range checks.
    """
    r_lo = M & ((1 << 126) - 1)
    r_hi = M >> 126
    shift = 1 << 126

    # skew flag: accumulators[0] is 1 (odd input) or 1 + 2^-254 (even)
    is_even = (FieldT(ctx, accumulators[0], 0, 1) - 1) * pow(2, 254, M)
    high_limb_with_skew = FieldT(ctx, accumulators[64], 0, 1)
    reconstructed = FieldT(ctx, accumulators[-1], 0, 1)

    # y_lo = r.lo + 2^126 - w.lo  where w.lo = w - high*2^126 + is_even
    y_lo = (-reconstructed) + high_limb_with_skew * shift \
        + (r_lo + shift) - is_even

    input_not_zero = None
    if validate_edge_cases:
        input_not_zero = ~inp.is_zero()
        y_lo = y_lo * input_not_zero.to_field()

    y_lo_acc = ctx.create_range_constraint(y_lo.normalize().witness_index, 128)
    # most significant quad of y_lo, minus the 2^126 constant's carry
    y_overlap = FieldT(ctx, y_lo_acc[0], 0, 1) - 1

    # y_hi = r.hi + y.overlap - (high - is_even * 2^-126)
    y_hi = is_even * pow(pow(2, 126, M), -1, M) \
        + (-high_limb_with_skew) + (y_overlap + r_hi)
    if validate_edge_cases:
        y_hi = y_hi * input_not_zero.to_field()

    ctx.create_range_constraint(y_hi.normalize().witness_index, 128)


def hash_single(inp: FieldT, hash_index: int,
                validate_edge_cases: bool = False,
                validate_input_is_in_field: bool = True):
    """Pedersen hash of one field element -> Point
    (ref: pedersen.cpp:38-196)."""
    if inp.is_constant():
        r = pd.hash_single(inp.get_value(), hash_index)
        x, y = r if r is not None else (0, 0)
        return Point(FieldT.constant(x), FieldT.constant(y))
    ctx = inp.ctx
    ladder = pd._hash_ladder(hash_index)
    skew_point = pd.get_generator(hash_index * 2 + 1)
    point, acc = _ladder_walk(inp, pd.NUM_BITS, ladder, skew_point,
                              conditional_scalar_check=validate_edge_cases)
    if validate_input_is_in_field:
        validate_wnaf_is_in_field(ctx, acc, inp.normalize(),
                                  validate_edge_cases)
    return point


def fixed_base_scalar_mul(inp: FieldT, num_bits: int, generator_index: int,
                          forbid_zero_input: bool = True) -> Point:
    """in * G_{generator_index} (ref: group.hpp fixed_base_scalar_mul)."""
    if inp.is_constant():
        r = pd.fixed_base_scalar_mul(inp.get_value(), num_bits,
                                     generator_index)
        return Point(FieldT.constant(r[0]), FieldT.constant(r[1]))
    ctx = inp.ctx
    point, acc = _ladder_walk(
        inp, num_bits, pd._ladder(generator_index),
        pd.get_generator(generator_index),
        conditional_scalar_check=not forbid_zero_input,
    )
    if num_bits >= 254:
        validate_wnaf_is_in_field(ctx, acc, inp.normalize(), True)
    return point


def fixed_base_scalar_mul_g1(inp: FieldT, num_bits: int) -> Point:
    """in * grumpkin-g1::one (ref: group.hpp fixed_base_scalar_mul_g1) —
    the account-public-key derivation in join_split."""
    if inp.is_constant():
        r = pd.fixed_base_scalar_mul_g1(inp.get_value(), num_bits)
        return Point(FieldT.constant(r[0]), FieldT.constant(r[1]))
    ctx = inp.ctx
    point, acc = _ladder_walk(inp, num_bits, pd.g1_ladder(), pd.GRUMPKIN_GEN,
                              conditional_scalar_check=False)
    if num_bits >= 254:
        validate_wnaf_is_in_field(ctx, acc, inp.normalize(), True)
    return point


# -- point accumulation (incomplete affine adds) ------------------------------

def add_points(a: Point, b: Point) -> Point:
    """Incomplete affine addition with witnessed slope
    (ref: pedersen.cpp add_points)."""
    lam = (b.y - a.y) / (b.x - a.x)
    x3 = lam * lam - (b.x + a.x)
    y3 = lam * (a.x - x3) - a.y
    return Point(x3.normalize(), y3.normalize())


def accumulate(points: List[Point]) -> Point:
    if not points:
        return Point(FieldT.constant(0), FieldT.constant(0))
    acc = points[0]
    for p in points[1:]:
        acc = add_points(acc, p)
    return acc


def conditionally_accumulate(points: List[Point],
                             inputs: List[FieldT]) -> Point:
    """Accumulate, skipping points whose input scalar is zero
    (ref: pedersen.cpp conditionally_accumulate)."""
    acc = points[0]
    is_acc_zero = inputs[0].is_zero()
    for p, inp in zip(points[1:], inputs[1:]):
        cur_zero = inp.is_zero()
        init_instead = (is_acc_zero & ~cur_zero).to_field()
        lam = (p.y - acc.y) / (p.x - acc.x)
        x3 = lam * lam - (p.x + acc.x)
        y3 = lam * (acc.x - x3) - acc.y
        x3 = (p.x - x3) * init_instead + x3
        y3 = (p.y - y3) * init_instead + y3
        skip = cur_zero.to_field()
        x3 = (acc.x - x3) * skip + x3
        y3 = (acc.y - y3) * skip + y3
        acc = Point(x3.normalize(), y3.normalize())
        is_acc_zero = is_acc_zero & cur_zero
    # if all inputs are zero the result is undefined in the reference too;
    # callers must guarantee at least one nonzero input
    return acc


def encrypt(inputs: List[FieldT], hash_index: int = 0,
            handle_edge_cases: bool = False) -> Point:
    """Multi-input Pedersen -> Point (ref: pedersen.cpp:463-473)."""
    pts = [
        hash_single(v.normalize(), hash_index + i,
                    validate_edge_cases=handle_edge_cases)
        for i, v in enumerate(inputs)
    ]
    if handle_edge_cases:
        return conditionally_accumulate(pts, inputs)
    return accumulate(pts)


def compress_to_point(left: FieldT, right: FieldT,
                      hash_index: int = 0) -> Point:
    """ref: pedersen.cpp:515-520."""
    return add_points(hash_single(left, hash_index),
                      hash_single(right, hash_index + 1))


def compress(left: FieldT, right: FieldT, hash_index: int = 0) -> FieldT:
    """Two-input compression; output = x coordinate
    (ref: stdlib pedersen compress)."""
    if left.is_constant() and right.is_constant():
        return FieldT.constant(
            pd.compress_native(left.get_value(), right.get_value(),
                               hash_index))
    return compress_to_point(left, right, hash_index).x


def compress_many(inputs: List[FieldT], hash_index: int = 0) -> FieldT:
    return encrypt(inputs, hash_index, handle_edge_cases=True).x.normalize()
