"""GLV endomorphism scalar splitting on limb planes, plain PyTorch.

Port of aztec_tpu/msm/glv.py.  Each 254-bit scalar k splits into
k = k1 + lambda * k2 (mod r) with |k1|, |k2| < 2^128, so the MSM runs half
the window rounds over a doubled point table (P_i, phi(P_i)) where
phi(x, y) = (beta * x, y).  The split is Babai rounding against a
Gauss-reduced lattice basis with rectangular schoolbook products on 16-bit
limb planes and two's-complement fixups, exactly as the reference computes
it; beta * X goes through the K1 ``mont_mul`` wrapper.

``glv_table`` is the one entry the MSMs call.  For CUDA tensors it is one
launch of ``csrc/glv.cu`` (``glv_table_kernel``: the split, beta * X and
the selected -Y of each point in one thread), bit for bit equal to the
plain composition ``glv_table_plain`` on any 16-bit limbs, which the CPU
runs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import native
from ..ff import field_kernels as fk
from ..ff import limb
from ..curves.spec import CurveSpec
from ..numeric.bigint import int_to_limbs

# Babai rounding precision: c_i = (k * m_i + 2^(S-1)) >> S approximates
# round(k * |b_j| / r) with error <= 1 because k < 2^254 << 2^S / |b_j|.
_SHIFT = 416
_SLIMB = _SHIFT // 16  # 26


# --------------------------- host-side setup -------------------------------


def _host_ec_mul(k: int, pt, p: int, b: int):
    """Tiny affine double-and-add over F_p (host verification only)."""

    def add(P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    acc = None
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def _cube_root(p: int) -> int:
    """A primitive cube root of unity mod p (requires p % 3 == 1)."""
    assert p % 3 == 1
    e = (p - 1) // 3
    g = 2
    while True:
        r = pow(g, e, p)
        if r != 1:
            return r
        g += 1


def _gauss_reduce(u, v):
    """Gauss lattice reduction of a 2D integer basis (shortest vectors)."""

    def norm2(w):
        return w[0] * w[0] + w[1] * w[1]

    while True:
        if norm2(u) > norm2(v):
            u, v = v, u
        n = norm2(u)
        q = round((u[0] * v[0] + u[1] * v[1]) / n)
        if q == 0:
            return u, v
        v = (v[0] - q * u[0], v[1] - q * u[1])


@functools.lru_cache(maxsize=None)
def glv_params(curve: CurveSpec):
    """Derive (lambda, beta, reduced basis, Babai magics) for a curve.

    Returns None when the curve admits no usable GLV split (p or r != 1
    mod 3, or the split bound does not fit 128 bits).
    """
    r = curve.order
    q = curve.field.modulus
    if r % 3 != 1 or q % 3 != 1:
        return None
    lam = _cube_root(r)
    beta = _cube_root(q)
    # Match beta to lam on the generator: phi(G) must equal lam*G; the other
    # cube root pairs with lam^2.
    G = (curve.gen_x, curve.gen_y)
    lamG = _host_ec_mul(lam, G, q, curve.b)
    if lamG != ((beta * G[0]) % q, G[1]):
        beta = pow(beta, 2, q)
        lamG2 = ((beta * G[0]) % q, G[1])
        if lamG != lamG2:
            return None

    # Lattice {(x, y): x + y*lam == 0 mod r}; Babai split vs reduced basis.
    v1, v2 = _gauss_reduce((r, 0), ((-lam) % r, 1))
    a1, b1 = v1
    a2, b2 = v2
    # Babai: k_vec = eps1*v1 + eps2*v2 with |eps_i| <= 1/2 + 2^-100 (nearest
    # rounding; the floor-magic error is folded in), so per coordinate
    # |k1| <= 0.51*(|a1|+|a2|), |k2| <= 0.51*(|b1|+|b2|).
    # reject unless 0.51 * max_coord_sum < 2^128 (the 8-limb output width)
    if max(abs(a1) + abs(a2), abs(b1) + abs(b2)) * 51 >= 100 << 128:
        return None

    det = a1 * b2 - a2 * b1  # = +-r
    assert abs(det) == r
    # c = round(k * (b2, -b1) / det) makes k - c1*v1 - c2*v2 short.  Fold
    # det's sign into the numerators.
    s = 1 if det > 0 else -1
    n1 = s * b2   # c1 = round(k * n1 / r)
    n2 = s * -b1  # c2 = round(k * n2 / r)

    def magic(nv):
        sign = 1 if nv >= 0 else -1
        m = (abs(nv) << _SHIFT) // r  # floor; error folded into bound slack
        return sign, m

    s1m, m1 = magic(n1)
    s2m, m2 = magic(n2)
    return {
        "lam": lam,
        "beta": beta,
        "basis": (v1, v2),
        "c_signs": (s1m, s2m),
        "magics": (m1, m2),
    }


def split_scalar_host(k: int, curve: CurveSpec):
    """Host reference split: k -> (k1, k2) with k = k1 + lam*k2 (mod r)."""
    P = glv_params(curve)
    r = curve.order
    (a1, b1), (a2, b2) = P["basis"]
    (s1m, s2m) = P["c_signs"]
    m1, m2 = P["magics"]
    half = 1 << (_SHIFT - 1)
    c1 = s1m * ((k * m1 + half) >> _SHIFT)
    c2 = s2m * ((k * m2 + half) >> _SHIFT)
    k1 = k - c1 * a1 - c2 * a2
    k2 = -(c1 * b1 + c2 * b2)
    assert (k1 + P["lam"] * k2 - k) % r == 0
    return k1, k2


# --------------------------- device kernels --------------------------------

MASK = 0xFFFF


def _canon(cols):
    """Redundant int64 columns (K, N) -> canonical digits mod 2^(16K)."""
    K = cols.shape[0]
    if K % 2:
        cols = torch.cat([cols, torch.zeros_like(cols[:1])])
    return limb.KF.canon(cols)[0][:K]


def _rect_mul_cols(a, b_limbs, out_cols: int):
    """a (La, N) canonical int64 x host constant b -> out_cols columns of
    whole limb products (column k = sum_{i+j=k} a_i b_j), truncated."""
    La = a.shape[0]
    b = torch.as_tensor(np.asarray(b_limbs, np.int64), device=a.device)
    P = (a[:, None, :] * b[None, :, None]).reshape(La * len(b_limbs), -1)
    i = torch.arange(La, device=a.device)
    j = torch.arange(len(b_limbs), device=a.device)
    idx = (i[:, None] + j[None, :]).reshape(-1)
    cols = torch.zeros((max(out_cols, La + len(b_limbs)), P.shape[1]),
                       dtype=torch.int64, device=a.device)
    cols.index_add_(0, idx, P)
    return cols[:out_cols]


def _neg2c(x):
    """Two's-complement negation of canonical planes (mod 2^(16*W))."""
    y = MASK - x
    y[0] += 1
    return _canon(y)


def _sub2c(x, y):
    """x - y mod 2^(16*W) on canonical planes."""
    z = x + (MASK - y)
    z[0] += 1
    return _canon(z)


_W = 10  # two's-complement workspace limbs (160 bits; |k_i| < 2^128)


def glv_split(scalars, curve: CurveSpec):
    """Batched split: (16, n) canonical scalar planes ->
    (k1_abs (8, n), neg1 (n,), k2_abs (8, n), neg2 (n,))."""
    P = glv_params(curve)
    (a1, b1), (a2, b2) = P["basis"]
    s1m, s2m = P["c_signs"]
    m1, m2 = P["magics"]
    k = scalars.to(torch.int64).reshape(scalars.shape[0], -1)

    def babai_c(m):
        Lb = max((m.bit_length() + 15) // 16, 1)
        out_cols = _SLIMB + 9  # product < 2^(254 + len(m)); c < 2^128
        cols = _rect_mul_cols(k, int_to_limbs(m, Lb), out_cols)
        cols[_SLIMB - 1] += 0x8000  # + 2^(S-1): round-to-nearest
        return _canon(cols)[_SLIMB:_SLIMB + 8]  # (8, n)

    c1 = babai_c(m1)
    c2 = babai_c(m2)

    def term(c, coeff: int, csign: int):
        """(csign*c) * coeff mod 2^(16*_W), as canonical planes."""
        sgn = csign * (1 if coeff >= 0 else -1)
        mag = abs(coeff)
        Lb = max((mag.bit_length() + 15) // 16, 1)
        return _canon(_rect_mul_cols(c, int_to_limbs(mag, Lb), _W)), sgn

    def acc(base, terms):
        v = base
        for t, sgn in terms:
            v = _sub2c(v, t) if sgn > 0 else _canon(v + t)
        return v

    k_low = k[:_W]
    # k1 = k - (s1m*c1)*a1 - (s2m*c2)*a2
    k1 = acc(k_low, [term(c1, a1, s1m), term(c2, a2, s2m)])
    # k2 = -((s1m*c1)*b1 + (s2m*c2)*b2) = 0 - t1 - t2
    k2 = acc(torch.zeros_like(k_low), [term(c1, b1, s1m), term(c2, b2, s2m)])

    def abs_split(v):
        neg = (v[_W - 1] >> 15) != 0
        mag = torch.where(neg[None], _neg2c(v), v)
        return mag[:8].to(torch.int32), neg

    k1a, n1 = abs_split(k1)
    k2a, n2 = abs_split(k2)
    return k1a, n1, k2a, n2


def endo_table(points, curve: CurveSpec):
    """(X, Y) (L, n) Montgomery planes -> endo X plane (beta * X), one K1
    mont_mul with beta broadcast."""
    P = glv_params(curve)
    fq = curve.field
    X, _ = points
    beta_m = limb.const(int_to_limbs(fq.to_mont_int(P["beta"]), fq.nlimbs),
                        X.dim(), X.device)
    return fk.mont_mul(X, beta_m, fq)


def glv_table_plain(points, scalars, curve: CurveSpec):
    """Plain version of ``glv_table``: the split, the endomorphism X plane,
    the selects of -Y and the concatenations, as separate torch ops."""
    X, Y = points
    fq = curve.field
    k1a, n1, k2a, n2 = glv_split(scalars, curve)
    Xe = endo_table(points, curve)
    Yn = limb.neg_mod(Y, fq)
    Y1 = limb.select(n1, Yn, Y)
    Y2 = limb.select(n2, Yn, Y)
    Xt = torch.cat([X, Xe], dim=-1)
    Yt = torch.cat([Y1, Y2], dim=-1)
    st = torch.cat([k1a, k2a], dim=-1)
    return (Xt, Yt), st


# the kernel's Babai product is kept mod 2^(32 * MAGIC_WORDS), its split
# workspace is mod 2^(32 * SPLIT_WORDS) (csrc/glv.cu MW, SW)
MAGIC_WORDS = (_SHIFT + 128) // 32
SPLIT_WORDS = 16 * _W // 32


def _words(v: int, nw: int) -> list:
    """v mod 2^(32 nw) as nw 32-bit words, least significant first."""
    v %= 1 << (32 * nw)
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]


@functools.lru_cache(maxsize=None)
def kernel_consts(curve: CurveSpec) -> ctypes.Array:
    """The host words ``gv_glv_table`` takes for a curve, in csrc/glv.cu
    ``GlvConsts`` order: beta in Montgomery form (8), the magics mod 2^544
    (2 x 17), then A_h = -s_h a_h and B_h = -s_h b_h mod 2^160 (2 x 5
    each): ``glv_split`` subtracts s_h c_h a_h, which mod 2^160 adds c_h A_h."""
    P = glv_params(curve)
    (a1, b1), (a2, b2) = P["basis"]
    s1, s2 = P["c_signs"]
    words = _words(curve.field.to_mont_int(P["beta"]), 8)
    for m in P["magics"]:
        words += _words(m, MAGIC_WORDS)
    for coeffs in ((a1, a2), (b1, b2)):
        for s, v in zip((s1, s2), coeffs):
            words += _words(-s * v, SPLIT_WORDS)
    return (ctypes.c_uint32 * len(words))(*words)


def glv_table(points, scalars, curve: CurveSpec):
    """Doubled GLV point table + 128-bit scalar planes.

    (X, Y) (L, n) Montgomery affine planes, scalars (16, n) canonical ->
    ((X', Y') (L, 2n), scalars' (8, 2n)) with
    sum scalars'_i * P'_i == sum scalars_i * P_i; negative split halves are
    folded into the table by negating y.

    ``glv_table_plain`` for CPU tensors; for CUDA tensors one launch of
    ``gv_glv_table``, which reads (16, n) int32 planes in place at their
    row strides (a column slice of wider planes as it is) and allocates
    only the three outputs."""
    X, Y = points
    if not any(fk.use_kernels(t) for t in (X, Y, scalars)):
        return glv_table_plain(points, scalars, curve)
    n = X.shape[-1]
    dev = X.device
    for t in (X, Y, scalars):
        if t.device != dev or t.dtype != torch.int32 \
                or tuple(t.shape) != (16, n):
            raise ValueError(f"glv_table: expected (16, {n}) int32 planes on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        if n > 1 and t.stride(1) != 1:
            raise ValueError("glv_table: planes need unit column stride, got "
                             f"strides {t.stride()}")
    Xt = torch.empty((16, 2 * n), dtype=torch.int32, device=dev)
    Yt = torch.empty_like(Xt)
    St = torch.empty((8, 2 * n), dtype=torch.int32, device=dev)
    if n:
        rc = native.library("glv").gv_glv_table(
            fk.field_id(curve.field), X.data_ptr(), X.stride(0), Y.data_ptr(),
            Y.stride(0), scalars.data_ptr(), scalars.stride(0), Xt.data_ptr(),
            Yt.data_ptr(), St.data_ptr(), kernel_consts(curve), n,
            torch.cuda.current_stream(dev).cuda_stream)
        native.check(rc, "gv_glv_table")
        fk.LAUNCHES["glv_table"] += 1
        fk.ELEMS["glv_table"] += n
    return (Xt, Yt), St
