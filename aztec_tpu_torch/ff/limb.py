"""Modular arithmetic on 16-bit limb planes in plain PyTorch.

Port of aztec_tpu/ff/limb.py.  A batch of field elements is a ``(16, *batch)``
int32 tensor of little-endian 16-bit limbs in Montgomery form with
R = 2^256 (``ff/spec.py``), the reference's layout, so tensors compare with
the JAX package's arrays as they are.

The arithmetic follows the in-kernel helper ``KF`` of
aztec_tpu/ff/pallas_field.py (schoolbook columns, separated REDC, ripple
carries, conditional subtraction), which is also what the CUDA kernels
compute: canonical inputs give the unique canonical representative, and
any other 16-bit limbs give the reference's bits (sums and U / R taken mod
2^256, then one conditional subtraction of p), so the results are
bit-identical to both on any limbs.  Internally it computes in int64
(this torch build has no add, shift or compare for uint32): a column holds
whole 32-bit limb products (< 2^36), and the carry ripple walks limb pairs
(radix 2^32) to halve the number of sequential steps.

This is the plain version the CPU runs.  The field-kernel wrappers of
``field_kernels.py`` call it for CPU tensors and launch the CUDA kernels for
CUDA tensors; the composite functions here (``to_mont``, ``mont_pow``,
``batch_inv_mont`` ...) multiply through those wrappers, so on the card they
run on the kernels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .spec import FieldSpec

L = 16
MASK = 0xFFFF
I64 = torch.int64
I32 = torch.int32


# -- plain helper over flattened (16, N) int64 planes (the KF of the port) --


class KF:
    """Field formulas on (16, N) int64 limb planes, bound to one field and
    device.  Mirrors aztec_tpu/ff/pallas_field.py ``KF``."""

    def __init__(self, spec: FieldSpec, device):
        self.spec = spec

        def col(limbs):
            return torch.as_tensor(np.asarray(limbs, np.int64),
                                   device=device).reshape(L, 1)

        self.p = col(spec.p_limbs)
        self.pp = col(spec.pprime_limbs)
        self.comp_p = col(spec.comp_p_limbs)
        # (R - p) * R: adds R - p to the high half of a 32-column value
        self.comp_p_hi = torch.cat([torch.zeros_like(self.comp_p), self.comp_p])
        self.one = col(spec.one_mont_limbs)
        one_lsb = np.zeros(L, np.int64)
        one_lsb[0] = 1
        self.lsb = col(one_lsb)

    @staticmethod
    def canon(cols):
        """Ripple redundant columns (K, N), K even, each < 2^47, to 16-bit
        digits.  Returns (digits (K, N), carry_out (N,))."""
        K = cols.shape[0]
        pairs = cols[0::2] + (cols[1::2] << 16)
        vs = []
        carry = None
        for row in pairs.unbind(0):
            v = row if carry is None else row + carry
            vs.append(v)
            carry = v >> 32
        V = torch.stack(vs)
        digits = torch.stack([V & MASK, (V >> 16) & MASK], dim=1)
        return digits.reshape(K, -1), carry

    @staticmethod
    def mul_cols(a, b, ncols: int = 2 * L):
        """Schoolbook product -> the low ncols columns of whole limb
        products: column k = sum_{i+j=k} a_i b_j (< 2^36).  Narrow batches
        take one outer product and one index_add_ (fewest ops); wide ones
        accumulate row i of a into columns i.. (fewest passes over memory)."""
        n = max(a.shape[1], b.shape[1])
        if n < 512:
            cols = torch.zeros((2 * L, n), dtype=I64, device=a.device)
            P = (a[:, None, :] * b[None, :, :]).reshape(L * L, -1)
            cols.index_add_(0, _col_index(a.device), P.expand(L * L, n))
            return cols[:ncols]
        cols = torch.zeros((ncols, n), dtype=I64, device=a.device)
        b = b.expand(L, n)
        for i in range(min(L, ncols)):
            k = min(L, ncols - i)
            cols[i:i + k].addcmul_(a[i].expand(k, n), b[:k])
        return cols

    def _both(self, cols, alt):
        """Ripple ``cols`` and ``cols + alt`` in one pass over 2N lanes:
        (digits, carry) of each."""
        n = cols.shape[1]
        d, co = self.canon(torch.cat([cols, cols + alt], dim=1))
        return d[:, :n], co[:n], d[:, n:], co[n:]

    @staticmethod
    def _cond_sub_p(lo, co_lo, hi, co_hi):
        """The reference's reduction of a sum V held in the top 16 digits:
        t = V mod 2^256 (the 2^256 bit dropped), then t - p where t >= p.
        ``lo, co_lo`` ripple V and ``hi, co_hi`` ripple V + (R - p), both
        digits mod 2^256; co_hi = co_lo + [t >= p], so ``hi`` (= t - p mod
        2^256) is taken exactly when the second ripple carried once more."""
        return torch.where(co_hi != co_lo, hi, lo)

    def add(self, a, b):
        """(a + b) mod p for any 16-bit limbs, as the reference computes it:
        s = (a + b) mod 2^256, then s - p where s >= p."""
        s, co_s, t, co = self._both(a + b, self.comp_p)
        return self._cond_sub_p(s, co_s, t, co)

    def sub(self, a, b):
        """(a - b) mod p: z = a - b + R carries iff a >= b; else z + p."""
        z, co, zp, _ = self._both(a + (MASK - b) + self.lsb, self.p)
        return torch.where(co != 0, z, zp)

    @staticmethod
    def _carry_save(cols):
        """One carry-save pass: columns (< 2^63) -> columns < 2^16 + 2^47
        of the same value mod 2^(16 K)."""
        hi = cols >> 16
        return (cols & MASK) + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]])

    def _redc(self, T):
        """Separated REDC (pallas_field.KF._redc) of 32 redundant columns:
        m = (T mod R) p' mod R, U = T + m p, t = (U / R) mod 2^256, result
        t or t - p.  On unreduced operands U / R may pass 2^256; the bit is
        dropped before the comparison, as the reference drops it."""
        m, _ = self.canon(self._carry_save(self.mul_cols(T[:L], self.pp, L)))
        U = T + self.mul_cols(m, self.p, 2 * L)
        lo, co_lo, hi, co = self._both(U, self.comp_p_hi)
        return self._cond_sub_p(lo[L:], co_lo, hi[L:], co)

    def mul(self, a, b):
        return self._redc(self.mul_cols(a, b))

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small(self, a, c):
        """a * Montgomery constant c (a (16, 1) plane), full REDC."""
        return self.mul(a, c)

    def one_mont_elem(self, like):
        return self.one.expand_as(like)

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask, a, b)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(0)


@functools.lru_cache(maxsize=None)
def _col_index(device: torch.device) -> torch.Tensor:
    """Column i + j of outer-product row i * 16 + j."""
    i = torch.arange(L, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


@functools.lru_cache(maxsize=None)
def kf(spec: FieldSpec, device: torch.device) -> KF:
    """The (immutable) helper for a field on a device."""
    return KF(spec, device)


def flat(*arrs):
    """Broadcast (16, *batch) planes to (16, N) int64; returns (planes,
    batch_shape)."""
    bshape = torch.broadcast_shapes(*(a.shape[1:] for a in arrs))
    n = math.prod(bshape)
    return [a.to(I64).expand((L,) + tuple(bshape)).reshape(L, n)
            for a in arrs], tuple(bshape)


def unflat(x, bshape):
    return x.to(I32).reshape((x.shape[0],) + tuple(bshape))


def _elementwise(spec: FieldSpec, formula, *arrs):
    planes, bshape = flat(*arrs)
    return unflat(formula(kf(spec, arrs[0].device), *planes), bshape)


def const(limbs, ndim: int, device) -> torch.Tensor:
    """An (L,) constant shaped to broadcast against (L, *batch)."""
    return torch.as_tensor(np.asarray(limbs, np.int64), dtype=I32,
                           device=device).reshape((len(limbs),) + (1,) * (ndim - 1))


# -- public plain entry points (int32 planes in and out) --------------------


def canon(cols):
    """Canonicalize redundant columns (K, *batch) to 16-bit limbs.

    Returns ``(limbs int32 (K, *batch), carry_out int64 (*batch))`` where
    the carry is the value shifted out beyond 16*K bits."""
    K = cols.shape[0]
    bshape = cols.shape[1:]
    c = cols.to(I64).reshape(K, -1)
    if K % 2:
        c = torch.cat([c, torch.zeros_like(c[:1])])
    digits, carry = KF.canon(c)
    return digits[:K].to(I32).reshape(cols.shape), carry.reshape(bshape)


def add_mod(a, b, spec: FieldSpec):
    return _elementwise(spec, KF.add, a, b)


def sub_mod(a, b, spec: FieldSpec):
    return _elementwise(spec, KF.sub, a, b)


def mont_mul(a, b, spec: FieldSpec):
    """Montgomery product REDC(a*b) of any 16-bit limbs.  As in the
    reference, (U / R) mod 2^256 is reduced by one conditional subtraction
    of p: canonical operands give the canonical product, unreduced ones the
    reference's bits (which need not be < p)."""
    return _elementwise(spec, KF.mul, a, b)


def mul_add(a, b, c, spec: FieldSpec):
    """a*b + c (Montgomery product, then modular add): pallas_field.mul_add."""
    planes, bshape = flat(a, b, c)
    f = kf(spec, a.device)
    return unflat(f.add(f.mul(planes[0], planes[1]), planes[2]), bshape)


def butterfly(top, bot, tw, spec: FieldSpec):
    """(top + tw*bot, top - tw*bot): one Stockham FFT butterfly."""
    planes, bshape = flat(top, bot, tw)
    f = kf(spec, top.device)
    t = f.mul(planes[1], planes[2])
    return (unflat(f.add(planes[0], t), bshape),
            unflat(f.sub(planes[0], t), bshape))


def _fk():
    from . import field_kernels

    return field_kernels


def neg_mod(a, spec: FieldSpec):
    return _fk().sub_mod(torch.zeros_like(a), a, spec)


def mont_sqr(a, spec: FieldSpec):
    return _fk().mont_mul(a, a, spec)


def to_mont(a, spec: FieldSpec):
    return _fk().mont_mul(a, const(spec.r2_limbs, a.dim(), a.device), spec)


def from_mont(a, spec: FieldSpec):
    one = np.zeros(L, np.int64)
    one[0] = 1
    return _fk().mont_mul(a, const(one, a.dim(), a.device), spec)


def one_mont(spec: FieldSpec, batch_shape, device):
    c = const(spec.one_mont_limbs, 1 + len(batch_shape), device)
    return c.expand((L,) + tuple(batch_shape))


def is_zero(a):
    return (a == 0).all(0)


def eq(a, b):
    return (a == b).all(0)


def select(mask, a, b):
    """mask: (*batch) bool; elementwise field select."""
    return torch.where(mask[None], a, b)


def mont_pow(a, exp_bits, spec: FieldSpec):
    """a^e with e given as LSB-first bits (host constants): square and
    multiply, skipping the multiplies of zero bits."""
    fk = _fk()
    bits = [int(b) for b in np.asarray(exp_bits).reshape(-1)]
    result = one_mont(spec, a.shape[1:], a.device).contiguous()
    base = a
    last = max((i for i, b in enumerate(bits) if b), default=-1)
    for i in range(last + 1):
        if bits[i]:
            result = fk.mont_mul(result, base, spec)
        if i < last:
            base = fk.mont_mul(base, base, spec)
    return result


def inv_mont(a, spec: FieldSpec):
    """Fermat inversion (Montgomery form in/out); maps 0 -> 0."""
    return mont_pow(a, spec.inv_exp_bits, spec)


def scan_mul(x, spec: FieldSpec, axis: int, reverse: bool = False):
    """Inclusive prefix products along ``axis`` (Hillis-Steele)."""
    fk = _fk()
    if reverse:
        x = torch.flip(x, (axis,))
    n = x.shape[axis]
    d = 1
    while d < n:
        tail = fk.mont_mul(x.narrow(axis, d, n - d), x.narrow(axis, 0, n - d),
                           spec)
        x = torch.cat([x.narrow(axis, 0, d), tail], dim=axis)
        d *= 2
    return torch.flip(x, (axis,)) if reverse else x


def batch_inv_mont(a, spec: FieldSpec, axis: int = -1):
    """Montgomery-trick batch inversion along one batch axis: prefix and
    suffix products, ONE Fermat inversion of the total, two products per
    element.  Zeros map to zero."""
    fk = _fk()
    axis = axis % a.dim()
    if axis == 0:
        raise ValueError("axis 0 is the limb axis")
    zero_mask = is_zero(a)
    one = one_mont(spec, a.shape[1:], a.device)
    x = torch.where(zero_mask[None], one, a)
    prefix = scan_mul(x, spec, axis)
    suffix = scan_mul(x, spec, axis, reverse=True)
    n = a.shape[axis]
    tinv = inv_mont(prefix.narrow(axis, n - 1, 1), spec)
    pad = one.narrow(axis, 0, 1)
    pl = torch.cat([pad, prefix.narrow(axis, 0, n - 1)], dim=axis)
    sr = torch.cat([suffix.narrow(axis, 1, n - 1), pad], dim=axis)
    out = fk.mont_mul(fk.mont_mul(pl, sr, spec), tinv, spec)
    return torch.where(zero_mask[None], torch.zeros_like(a), out)
