"""Polynomial arithmetic beyond the FFT.

Port of aztec_tpu/poly/arithmetic.py (the pieces the Standard prover
uses): evaluation as one <coeffs, powers of z> product plus an add_mod
reduction tree, and the Kate quotient by its closed form
dest[i] = -z^-(i+1) * sum_{j<=i} src[j] z^j (a prefix sum instead of a
serial recurrence).  Field sums are exact, so any reduction order gives the
reference's bits.  Lagrange evaluations at a challenge are host ints.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import FR, limb
from ..ff import field_kernels as fk
from ..ff.bn254 import FR_MOD
from ..numeric.bigint import limbs_to_ints
from .domain import mont_plane, powers_table


def fr_mont_plane(v: int, device="cuda") -> torch.Tensor:
    """Canonical int -> (16,) Montgomery limb plane (host boundary)."""
    return mont_plane(v, device)


def to_ints(planes) -> list:
    """(16, n) Montgomery planes -> canonical ints (host)."""
    canon = limb.from_mont(planes, FR)
    return limbs_to_ints(canon.cpu().numpy().astype(np.uint32))


def _tree_sum(y, n: int):
    """add_mod reduction over the last axis (power-of-two padded)."""
    m = 1
    while m < n:
        m *= 2
    if m != n:
        y = torch.cat([y, y.new_zeros(y.shape[:-1] + (m - n,))], dim=-1)
    while m > 1:
        m //= 2
        y = fk.add_mod(y[..., :m], y[..., m:2 * m], FR)
    return y[..., 0]


def poly_eval(coeffs, z_int: int) -> int:
    """Evaluate (16, n) Montgomery coefficients at canonical z (host int)."""
    n = coeffs.shape[-1]
    zp = powers_table(mont_plane(z_int, coeffs.device), n)
    out = _tree_sum(fk.mont_mul(coeffs, zp, FR), n)
    return to_ints(out[:, None])[0]


def poly_eval_many(stack, z_int: int) -> list:
    """Evaluate k polynomials at once: stack (16, k, n) Montgomery planes
    -> k canonical ints."""
    n = stack.shape[-1]
    zp = powers_table(mont_plane(z_int, stack.device), n)
    return to_ints(_tree_sum(fk.mont_mul(stack, zp[:, None, :], FR), n))


def _prefix_add(x):
    """Inclusive prefix sums (add_mod) along the last axis, Hillis-Steele."""
    n = x.shape[-1]
    d = 1
    while d < n:
        x = torch.cat([x[..., :d], fk.add_mod(x[..., d:], x[..., :n - d], FR)],
                      dim=-1)
        d *= 2
    return x


def kate_divide(src, z_int: int):
    """W(X) = (F(X) - F(z)) / (X - z) for exact division; src[0] must
    already hold F_0 - F(z).  Returns (16, n) Montgomery coefficients."""
    n = src.shape[-1]
    z = z_int % FR_MOD
    zinv = pow(z, -1, FR_MOD)
    zp = powers_table(mont_plane(z, src.device), n)
    # z^-(i+1) = zinv * zinv^i
    zinv_m = mont_plane(zinv, src.device)
    zip_ = fk.mont_mul(powers_table(zinv_m, n), zinv_m[:, None], FR)
    prefix = _prefix_add(fk.mont_mul(src, zp, FR))
    return limb.neg_mod(fk.mont_mul(prefix, zip_, FR), FR)


# -- host-side scalar lagrange evaluations (ref polynomial_arithmetic.cpp:752)


def get_lagrange_evaluations(z: int, n: int, root: int, k_roots_cut: int = 4):
    """Returns (vanishing_poly Z*_H(z), l_start L_1(z), l_end L_{n-k}(z))
    as canonical ints; mirrors get_lagrange_evaluations."""
    z = z % FR_MOD
    z_pow_n = pow(z, n, FR_MOD)
    numerator = (z_pow_n - 1) % FR_MOD
    root_inv = pow(root, -1, FR_MOD)

    den0 = 1
    work_root = root_inv
    for _ in range(k_roots_cut):
        den0 = den0 * (z - work_root) % FR_MOD
        work_root = work_root * root_inv % FR_MOD

    den1 = (z - 1) % FR_MOD
    l_end_root = pow(root, k_roots_cut + 1, FR_MOD)
    den2 = (z * l_end_root - 1) % FR_MOD

    n_inv = pow(n, -1, FR_MOD)
    vanishing = numerator * pow(den0, -1, FR_MOD) % FR_MOD
    scaled_num = numerator * n_inv % FR_MOD
    l_start = scaled_num * pow(den1, -1, FR_MOD) % FR_MOD
    l_end = scaled_num * pow(den2, -1, FR_MOD) % FR_MOD
    return vanishing, l_start, l_end


def compute_public_input_delta(inputs, beta: int, gamma: int, root: int):
    """ref: plonk/proof_system/public_inputs/public_inputs_impl.hpp.

    Uses coset generators k_1 (=5) for the numerator and the external coset
    generator (=12) for the denominator.
    """
    from ..ff.bn254 import FR_COSET_GENERATORS

    k1 = FR_COSET_GENERATORS[0]
    k_ext = FR_COSET_GENERATORS[7]
    num = 1
    den = 1
    work_root = 1
    for w in inputs:
        t0 = (w + gamma) % FR_MOD
        t1 = work_root * beta % FR_MOD
        num = num * (t1 * k1 + t0) % FR_MOD
        den = den * (t1 * k_ext + t0) % FR_MOD
        work_root = work_root * root % FR_MOD
    return num * pow(den, -1, FR_MOD) % FR_MOD


def compute_barycentric_evaluation(evals, z_int: int, domain) -> int:
    """r = sum_i L_i(z) f_i from evaluation form, without an iFFT (ref:
    polynomial_arithmetic.cpp:814-846): L_i(z) = ((z^n - 1)/n) /
    (z w^-i - 1), the denominators inverted in one batch inversion.

    evals: (16, m) Montgomery evaluations over the first m points of
    ``domain`` (m <= domain.size); z_int: canonical challenge."""
    m = evals.shape[-1]
    n = domain.size
    dev = evals.device
    z = z_int % FR_MOD
    numerator = (pow(z, n, FR_MOD) - 1) * pow(n, -1, FR_MOD) % FR_MOD
    winv = powers_table(mont_plane(pow(domain.root, -1, FR_MOD), dev), m)
    den = fk.sub_mod(fk.mont_mul(winv, mont_plane(z, dev)[:, None], FR),
                     limb.one_mont(FR, (1,), dev), FR)
    terms = fk.mont_mul(evals, limb.batch_inv_mont(den, FR), FR)
    s = _tree_sum(terms, m)
    return to_ints(fk.mont_mul(s[:, None], mont_plane(numerator, dev)[:, None],
                               FR))[0]
