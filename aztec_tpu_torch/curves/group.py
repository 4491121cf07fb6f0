"""Batched Jacobian / projective group formulas (short Weierstrass, a = 0),
plain PyTorch.

Port of aztec_tpu/curves/group.py.  Points are tuples of (16, *batch) int32
Montgomery limb planes:

- Jacobian (X, Y, Z), Z == 0 encoding infinity;
- affine (x, y), always finite;
- homogeneous projective (X : Y : Z) for the complete RCB16 formulas,
  identity (0 : 1 : 0).

The formulas are the plain versions of the K2 kernels
(``group_kernels.py``, ``csrc/group_ops.cu``): line-for-line the formulas of
aztec_tpu/curves/group_pallas.py over the ``limb.KF`` helper, so the
coordinates are bit-identical.  The unsafe adds assume P != +-Q when both
are finite (the prover's linearly independent inputs) and handle infinity.

The Jacobian ``dbl``, ``add_complete``, ``neg``, ``is_on_curve_affine`` and
``eq_jacobian`` (the batched Pedersen lanes' formulas) are the reference's
compositions of field ops, each op through ``field_kernels`` (one K1
launch on the card), so their limbs are the reference's too.
"""

from __future__ import annotations

import functools

import torch

from ..ff import limb
from ..ff.spec import FieldSpec
from ..numeric.bigint import int_to_limbs

L = 16


# -- formulas over flattened int64 planes (limb.KF) --------------------------


def f_mixed_add_unsafe(f, X1, Y1, Z1, X2, Y2):
    """Jacobian + affine, 7M + 4S; P = inf -> (X2, Y2, 1)."""
    add, sub, mul, sqr = f.add, f.sub, f.mul, f.sqr
    Z1Z1 = sqr(Z1)
    U2 = mul(X2, Z1Z1)
    S2 = mul(mul(Y2, Z1), Z1Z1)
    H = sub(U2, X1)
    HH = sqr(H)
    I = add(HH, HH)
    I = add(I, I)
    J = mul(H, I)
    r = sub(S2, Y1)
    r = add(r, r)
    V = mul(X1, I)
    r2 = sqr(r)
    X3 = sub(sub(r2, J), add(V, V))
    YJ = mul(Y1, J)
    Y3 = sub(mul(r, sub(V, X3)), add(YJ, YJ))
    ZH = sqr(add(Z1, H))
    Z3 = sub(sub(ZH, Z1Z1), HH)
    p_inf = f.is_zero(Z1)
    return (f.select(p_inf, X2, X3), f.select(p_inf, Y2, Y3),
            f.select(p_inf, f.one_mont_elem(Z3), Z3))


def f_add_unsafe(f, X1, Y1, Z1, X2, Y2, Z2):
    """Jacobian + Jacobian, 11M + 5S."""
    add, sub, mul, sqr = f.add, f.sub, f.mul, f.sqr
    Z1Z1 = sqr(Z1)
    Z2Z2 = sqr(Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(mul(Y1, Z2), Z2Z2)
    S2 = mul(mul(Y2, Z1), Z1Z1)
    H = sub(U2, U1)
    H2 = add(H, H)
    I = sqr(H2)
    J = mul(H, I)
    r = sub(S2, S1)
    r = add(r, r)
    V = mul(U1, I)
    r2 = sqr(r)
    X3 = sub(sub(r2, J), add(V, V))
    SJ = mul(S1, J)
    Y3 = sub(mul(r, sub(V, X3)), add(SJ, SJ))
    ZZ = sqr(add(Z1, Z2))
    Z3 = mul(sub(sub(ZZ, Z1Z1), Z2Z2), H)
    p_inf = f.is_zero(Z1)
    q_inf = f.is_zero(Z2)
    sel = f.select
    return (sel(p_inf, X2, sel(q_inf, X1, X3)),
            sel(p_inf, Y2, sel(q_inf, Y1, Y3)),
            sel(p_inf, Z2, sel(q_inf, Z1, Z3)))


def f_proj_add(f, b3, X1, Y1, Z1, X2, Y2, Z2):
    """RCB16 algorithm 7 (a = 0), complete; b3 = 3b in Montgomery form."""
    add, sub, mul = f.add, f.sub, f.mul
    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t2 = mul(Z1, Z2)
    t3 = mul(add(X1, Y1), add(X2, Y2))
    t3 = sub(t3, add(t0, t1))
    t4 = mul(add(Y1, Z1), add(Y2, Z2))
    t4 = sub(t4, add(t1, t2))
    X3 = mul(add(X1, Z1), add(X2, Z2))
    Y3 = sub(X3, add(t0, t2))
    X3 = add(t0, t0)
    t0 = add(X3, t0)
    t2 = f.mul_small(t2, b3)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    Y3 = f.mul_small(Y3, b3)
    X3 = sub(mul(t3, t1), mul(t4, Y3))
    Y3 = add(mul(t1, Z3), mul(Y3, t0))
    Z3 = add(mul(Z3, t4), mul(t0, t3))
    return (X3, Y3, Z3)


def f_proj_dbl(f, b3, X, Y, Z):
    """RCB16 algorithm 9 (a = 0), complete."""
    add, sub, mul, sqr = f.add, f.sub, f.mul, f.sqr
    t0 = sqr(Y)
    Z3 = add(t0, t0)
    Z3 = add(Z3, Z3)
    Z3 = add(Z3, Z3)
    t1 = mul(Y, Z)
    t2 = f.mul_small(sqr(Z), b3)
    X3 = mul(t2, Z3)
    Y3 = add(t0, t2)
    Z3 = mul(t1, Z3)
    t1 = add(t2, t2)
    t2 = add(t1, t2)
    t0 = sub(t0, t2)
    Y3 = add(X3, mul(t0, Y3))
    X3 = mul(t0, mul(X, Y))
    X3 = add(X3, X3)
    return (X3, Y3, Z3)


def f_j2c(f, X, Y, Z):
    """(Xj : Yj : Zj) -> (Xj Zj : Yj : Zj^3); infinity -> (0 : 1 : 0)."""
    Xp = f.mul(X, Z)
    Zp = f.mul(f.sqr(Z), Z)
    inf = f.is_zero(Z)
    return (Xp, f.select(inf, f.one_mont_elem(Y), Y), Zp)


def f_c2j(f, X, Y, Z):
    """(X : Y : Z) -> Jacobian (X Z, Y Z^2, Z); identity -> Z = 0."""
    return (f.mul(X, Z), f.mul(Y, f.sqr(Z)), Z)


@functools.lru_cache(maxsize=None)
def b3_limbs(spec: FieldSpec, b_int: int) -> tuple:
    """3b in Montgomery form as 16 limb ints (RCB16's b3)."""
    return tuple(int(x) for x in int_to_limbs((3 * b_int * spec.R) % spec.modulus))


def _apply(spec: FieldSpec, formula, coords, *consts):
    planes, bshape = limb.flat(*coords)
    f = limb.kf(spec, coords[0].device)
    cs = [torch.tensor(c, dtype=torch.int64, device=coords[0].device)
          .reshape(L, 1) for c in consts]
    return tuple(limb.unflat(o, bshape) for o in formula(f, *cs, *planes))


# -- plain entry points (int32 planes in and out) ----------------------------


def mixed_add_unsafe(P, Qa, spec: FieldSpec):
    """Jacobian + affine (7M + 4S): assumes Q finite and P != +-Q."""
    return _apply(spec, f_mixed_add_unsafe, (*P, *Qa))


def add_unsafe(P, Q, spec: FieldSpec):
    """Jacobian + Jacobian (11M + 5S): assumes P != +-Q when both finite."""
    return _apply(spec, f_add_unsafe, (*P, *Q))


def proj_add_complete(P, Q, spec: FieldSpec, b_int: int):
    """(X1:Y1:Z1) + (X2:Y2:Z2), complete (RCB16 algorithm 7, a=0)."""
    return _apply(spec, f_proj_add, (*P, *Q), b3_limbs(spec, b_int))


def proj_dbl(P, spec: FieldSpec, b_int: int):
    """2*(X:Y:Z), complete (RCB16 algorithm 9, a=0)."""
    return _apply(spec, f_proj_dbl, P, b3_limbs(spec, b_int))


def proj_dbl_n(P, spec: FieldSpec, b_int: int, steps: int):
    """``steps`` successive complete doublings."""
    def formula(f, b3, X, Y, Z):
        pt = (X, Y, Z)
        for _ in range(steps):
            pt = f_proj_dbl(f, b3, *pt)
        return pt

    return _apply(spec, formula, P, b3_limbs(spec, b_int))


def jacobian_to_proj(P, spec: FieldSpec):
    return _apply(spec, f_j2c, P)


def proj_to_jacobian(P, spec: FieldSpec):
    return _apply(spec, f_c2j, P)


# -- Jacobian formulas over field ops (each op one K1 launch on the card) ---


def _ops(spec: FieldSpec):
    from ..ff import field_kernels as fk

    add = lambda a, b: fk.add_mod(a, b, spec)
    sub = lambda a, b: fk.sub_mod(a, b, spec)
    mul = lambda a, b: fk.mont_mul(a, b, spec)
    sqr = lambda a: fk.mont_mul(a, a, spec)
    return add, sub, mul, sqr


def dbl(P, spec: FieldSpec):
    """Jacobian doubling (a = 0): 2M + 5S.  Infinity (Z = 0) maps to
    infinity."""
    X, Y, Z = P
    add, sub, mul, sqr = _ops(spec)
    A = sqr(X)
    B = sqr(Y)
    C = sqr(B)
    t = sqr(add(X, B))
    D = sub(sub(t, A), C)
    D = add(D, D)  # 2((X+B)^2 - A - C)
    E = add(add(A, A), A)  # 3A
    F = sqr(E)
    X3 = sub(F, add(D, D))
    C2 = add(C, C)
    C4 = add(C2, C2)
    C8 = add(C4, C4)
    Y3 = sub(mul(E, sub(D, X3)), C8)
    Z3 = mul(add(Y, Y), Z)
    return (X3, Y3, Z3)


def add_complete(P, Q, spec: FieldSpec):
    """Jacobian + Jacobian for all inputs: P = Q doubles, P = -Q gives
    infinity, an infinite operand returns the other."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    add, sub, mul, sqr = _ops(spec)
    Z1Z1 = sqr(Z1)
    Z2Z2 = sqr(Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(mul(Y1, Z2), Z2Z2)
    S2 = mul(mul(Y2, Z1), Z1Z1)
    H = sub(U2, U1)
    H2 = add(H, H)
    I = sqr(H2)
    J = mul(H, I)
    r = sub(S2, S1)
    r = add(r, r)
    V = mul(U1, I)
    r2 = sqr(r)
    X3 = sub(sub(r2, J), add(V, V))
    SJ = mul(S1, J)
    Y3 = sub(mul(r, sub(V, X3)), add(SJ, SJ))
    ZZ = sqr(add(Z1, Z2))
    Z3 = mul(sub(sub(ZZ, Z1Z1), Z2Z2), H)

    p_inf = limb.is_zero(Z1)
    q_inf = limb.is_zero(Z2)
    both = ~p_inf & ~q_inf
    x_eq = limb.eq(U1, U2) & both
    y_eq = limb.eq(S1, S2)
    is_dbl = x_eq & y_eq
    is_cancel = x_eq & ~y_eq

    D = dbl(P, spec)
    X3 = limb.select(is_dbl, D[0], X3)
    Y3 = limb.select(is_dbl, D[1], Y3)
    Z3 = limb.select(is_dbl, D[2], Z3)
    Z3 = limb.select(is_cancel, torch.zeros_like(Z3), Z3)
    X3 = limb.select(p_inf, X2, limb.select(q_inf, X1, X3))
    Y3 = limb.select(p_inf, Y2, limb.select(q_inf, Y1, Y3))
    Z3 = limb.select(p_inf, Z2, limb.select(q_inf, Z1, Z3))
    return (X3, Y3, Z3)


def neg(P, spec: FieldSpec):
    X, Y, Z = P
    return (X, limb.neg_mod(Y, spec), Z)


def is_on_curve_affine(Qa, spec: FieldSpec, b_int: int):
    """y^2 == x^3 + b for Montgomery-form affine points."""
    X, Y = Qa
    add, _, mul, sqr = _ops(spec)
    bm = limb.const(int_to_limbs((b_int * spec.R) % spec.modulus), X.dim(),
                    X.device)
    return limb.eq(sqr(Y), add(mul(sqr(X), X), bm.expand_as(X)))


def eq_jacobian(P, Q, spec: FieldSpec):
    """Projective equality with infinity handling."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    _, _, mul, sqr = _ops(spec)
    Z1Z1 = sqr(Z1)
    Z2Z2 = sqr(Z2)
    x_eq = limb.eq(mul(X1, Z2Z2), mul(X2, Z1Z1))
    y_eq = limb.eq(mul(mul(Y1, Z2), Z2Z2), mul(mul(Y2, Z1), Z1Z1))
    p_inf = limb.is_zero(Z1)
    q_inf = limb.is_zero(Z2)
    return (p_inf & q_inf) | (~p_inf & ~q_inf & x_eq & y_eq)


def one_mont_like(Z, spec: FieldSpec):
    return limb.one_mont(spec, Z.shape[1:], Z.device)


def from_affine(Qa, spec: FieldSpec):
    X, Y = Qa
    return (X, Y, one_mont_like(X, spec))


def infinity(spec: FieldSpec, batch_shape, device):
    z = torch.zeros((spec.nlimbs,) + tuple(batch_shape), dtype=torch.int32,
                    device=device)
    return (z, z, z)


def proj_infinity(spec: FieldSpec, batch_shape, device):
    """(0 : 1 : 0) in Montgomery form."""
    z = torch.zeros((spec.nlimbs,) + tuple(batch_shape), dtype=torch.int32,
                    device=device)
    return (z, limb.one_mont(spec, batch_shape, device), z)


def to_affine(P, spec: FieldSpec, axis: int = -1):
    """Batch-normalize via one batched inversion.  Returns (x, y, inf)."""
    from ..ff import field_kernels as fk

    X, Y, Z = P
    zinv = limb.batch_inv_mont(Z, spec, axis=axis)
    z2 = fk.mont_mul(zinv, zinv, spec)
    z3 = fk.mont_mul(z2, zinv, spec)
    return (fk.mont_mul(X, z2, spec), fk.mont_mul(Y, z3, spec),
            limb.is_zero(Z))


def proj_mask_to_infinity(keep_mask, P, spec: FieldSpec):
    X, Y, Z = P
    one = one_mont_like(Y, spec)
    return (torch.where(keep_mask[None], X, 0),
            limb.select(keep_mask, Y, one),
            torch.where(keep_mask[None], Z, 0))
