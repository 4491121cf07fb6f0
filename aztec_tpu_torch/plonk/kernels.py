"""Prover-round device kernels of Standard, Turbo, Ultra and MiMC PLONK.

Port of aztec_tpu/plonk/kernels.py: ``grand_product`` and the plookup
``lookup_grand_product``, ``_perm_quotient``, the Standard, Turbo, Ultra
and MiMC quotients (``_std_terms``, ``_turbo_terms``, ``_ultra_terms``,
``_mimc_terms``: each takes its operands lane by lane, so the prover
evaluates it over the 4n coset or a quarter of it, ``flavors._quotient``),
``elliptic_identity``, ``linear_combination``, ``sigma_from_mapping`` and
``vanishing_scale_table``.  Every field op goes through the K1 wrappers
(``ff/field_kernels.py``), so on the card each is one elementwise kernel
launch; the associative scans of the reference become Hillis-Steele scans
(``limb.scan_mul``), exact in any order.

All polynomials are Montgomery (16, n) limb planes; scalars enter as
(16, 1) Montgomery planes prepared on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import FR, limb
from ..ff import field_kernels as fk
from ..ff.bn254 import FR_COSET_GENERATORS, FR_MOD
from ..poly.domain import mont_plane, powers_table


def _c(v: int, device):
    """Montgomery constant plane (16, 1)."""
    return mont_plane(v, device)[:, None]


def _mul(a, b):
    return fk.mont_mul(a, b, FR)


def _add(a, b):
    return fk.add_mod(a, b, FR)


def _sub(a, b):
    return fk.sub_mod(a, b, FR)


def _cols(x):
    """A (16, W, m) stack or a sequence of (16, m) planes -> a list of W
    planes (a stack's columns are views, nothing is copied)."""
    return list(x.unbind(1)) if torch.is_tensor(x) else list(x)


def _rolled(x, step: int):
    """x at the next point of the small domain: the 4n coset order holds
    the small domain's points every 4 entries, one coset quarter every 1."""
    return torch.roll(x, -step, dims=1)


def grand_product(wires, sigmas, beta, gamma, omega_pows, randoms, n: int):
    """Permutation grand product Z(X) in lagrange form, blinded.

    wires/sigmas: (16, W, n) stacks or W (16, n) planes each; beta/gamma:
    (16, 1); omega_pows: (16, n); randoms: (16, 3).  Z[0] = 1, Z[i] =
    prod_{j<i} num_j/den_j; blinding written to indices n-3 .. n-1
    (ref: permutation_widget_impl.hpp:47-314)."""
    wires, sigmas = _cols(wires), _cols(sigmas)
    dev = omega_pows.device
    b_om = _mul(beta, omega_pows)
    num = den = None
    for k in range(len(wires)):
        wg = _add(wires[k], gamma)
        id_term = b_om if k == 0 else _mul(_c(FR_COSET_GENERATORS[k - 1], dev),
                                           b_om)
        nk = _add(wg, id_term)
        dk = _add(wg, _mul(beta, sigmas[k]))
        num = nk if num is None else _mul(num, nk)
        den = dk if den is None else _mul(den, dk)
    prefix_num = limb.scan_mul(num, FR, axis=1)
    suffix_den = limb.scan_mul(den, FR, axis=1, reverse=True)
    inv_total = limb.inv_mont(suffix_den[:, :1], FR)
    zrest = _mul(_mul(prefix_num[:, : n - 1], suffix_den[:, 1:]), inv_total)
    z = torch.cat([_c(1, dev), zrest], dim=1)
    z[:, n - 4 + 1: n - 4 + 1 + randoms.shape[1]] = randoms
    return z


def _perm_quotient(w, s, z, zw, l1, lend, pts, alpha, beta, gamma, delta):
    """Permutation-argument quotient term (ref:
    permutation_widget_impl.hpp:316-501), lane by lane: w, s lists of
    wire and sigma evaluations, z / zw Z at the point and the next point of
    the small domain, l1 / lend L_1 at the point and at the point 5 steps
    on (L_end: L_1 shifted by k + 1 = 5 roots), pts the points."""
    dev = pts.device
    b_pts = _mul(beta, pts)
    num = den = None
    for k in range(len(w)):
        wg = _add(w[k], gamma)
        id_term = b_pts if k == 0 else _mul(_c(FR_COSET_GENERATORS[k - 1], dev),
                                            b_pts)
        nk = _add(wg, id_term)
        dk = _add(wg, _mul(beta, s[k]))
        num = nk if num is None else _mul(num, nk)
        den = dk if den is None else _mul(den, dk)
    num = _mul(num, z)
    den = _mul(den, zw)
    # (Z(Xw) - delta) * alpha * L_end
    t0a = _mul(_mul(_sub(zw, delta), alpha), lend)
    # (Z(X) - 1) * alpha^2 * L_1
    alpha_sqr = _mul(alpha, alpha)
    t0b = _mul(_mul(_sub(z, _c(1, dev)), alpha_sqr), l1)
    return _mul(_sub(_add(_add(num, t0a), t0b), den), alpha)


def _std_terms(w, ww, s, z, zw, q, l1, lend, pts, vanish_scale, alpha, beta,
               gamma, delta):
    """Standard-PLONK quotient, lane by lane (the arguments as
    ``_turbo_terms``'; ``ww`` unused: no standard gate reads the next
    row): permutation + arithmetic gate
    (qm*w1*w2 + q1*w1 + q2*w2 + q3*w3 + qc) * alpha^4."""
    w1, w2, w3 = w
    perm = _perm_quotient(w, s, z, zw, l1, lend, pts, alpha, beta, gamma,
                          delta)
    alpha_sqr = _mul(alpha, alpha)
    alpha_quad = _mul(alpha_sqr, alpha_sqr)
    arith = _mul(q[0], _mul(w1, w2))
    arith = _add(arith, _mul(q[1], w1))
    arith = _add(arith, _mul(q[2], w2))
    arith = _add(arith, _mul(q[3], w3))
    arith = _add(arith, q[4])
    arith = _mul(arith, alpha_quad)
    return _mul(_add(perm, arith), vanish_scale)


def _quad_range_term(delta):
    """D(D-1)(D-2)(D-3) (ref: turbo_range_widget.hpp)."""
    dev = delta.device
    t0 = _sub(_mul(delta, delta), delta)
    t1 = _sub(delta, _c(2, dev))
    t2 = _sub(delta, _c(3, dev))
    return _mul(_mul(t0, t1), t2)


def _dbl2(x):
    return _add(x, x)


def _x4(x):
    return _dbl2(_dbl2(x))


def _turbo_terms(w, ww, s, z, zw, q, l1, lend, pts, vanish_scale, alphas,
                 beta, gamma, delta):
    """TurboPlonk quotient, lane by lane: permutation + turbo arithmetic +
    fixed-base ECC + range + logic, every field op one K1 launch (ref:
    turbo_arithmetic_widget.hpp, turbo_fixed_base_widget.hpp:8-176,
    turbo_range_widget.hpp, turbo_logic_widget.hpp; alpha schedule per
    transition_widget.hpp:43-90 — perm ends at alpha^4, arithmetic spans
    alpha^4..5, fixed-base alpha^6..12, range alpha^13..16, logic
    alpha^17..20).

    w / ww: the four wires at each point and at the next point of the small
    domain; s: the four sigmas; z / zw; q: the 11 selectors in order qm q1
    q2 q3 q4 q5 qc qarith qecc qrange qlogic; l1 / lend as
    ``_perm_quotient``; alphas: (16, >= 21), alpha^1.. ."""
    dev = pts.device
    a = lambda p: alphas[:, p - 1: p]  # alpha^p as (16, 1)
    c = lambda v: _c(v, dev)

    w1, w2, w3, w4 = w
    w1w, w2w, w3w, w4w = ww
    qm, q1, q2, q3, q4, q5, qc, qarith, qecc, qrange, qlogic = q
    one = c(1)

    perm = _perm_quotient(w, s, z, zw, l1, lend, pts, a(1), beta, gamma,
                          delta)

    # ---- turbo arithmetic (alpha^4, alpha^5) --------------------------------
    arith = _mul(qm, _mul(_mul(w1, w2), qarith))
    arith = _add(arith, _mul(q1, _mul(w1, qarith)))
    arith = _add(arith, _mul(q2, _mul(w2, qarith)))
    arith = _add(arith, _mul(q3, _mul(w3, qarith)))
    arith = _add(arith, _mul(q4, _mul(w4, qarith)))
    # q5 multiplicand: (w4^2 - w4)(w4 - 2) * q_arith * alpha
    t5 = _mul(_sub(_mul(w4, w4), w4), _sub(w4, c(2)))
    arith = _add(arith, _mul(q5, _mul(_mul(t5, qarith), a(1))))
    arith = _add(arith, _mul(qc, qarith))
    arith = _mul(arith, a(4))

    # non-linear quad-extraction term, active when q_arith == 2
    dlt = _sub(w3, _x4(w4))
    t = _mul(dlt, _sub(_sub(_mul(c(9), dlt), _dbl2(_mul(dlt, dlt))), c(7)))
    arith = _add(arith, _mul(_mul(_sub(_mul(qarith, qarith), qarith), t),
                             a(4)))

    # ---- fixed-base ECC (alpha^6..alpha^12) ---------------------------------
    delta_e = _sub(w4w, _x4(w4))
    delta_sq = _mul(delta_e, delta_e)

    fb = _mul(q1, _mul(_mul(delta_sq, qecc), a(7)))
    fb = _add(fb, _mul(q2, _mul(qecc, a(7))))
    q3m = _mul(_mul(_mul(_sub(w1w, w1), delta_e), _mul(w3w, a(9))), qecc)
    t1 = _mul(_mul(delta_e, w3w), _mul(w2, a(8)))
    q3m = _add(q3m, _mul(_dbl2(t1), qecc))
    fb = _add(fb, _mul(q3, q3m))
    fb = _add(fb, _mul(q4, _mul(_mul(w3, qecc), _mul(qc, a(11)))))
    fb = _add(fb, _mul(q5, _mul(_mul(_sub(one, w4), qecc), _mul(qc, a(11)))))
    fb = _add(fb, _mul(qm, _mul(_mul(w3, qecc), _mul(qc, a(12)))))

    # non-linear terms
    acc_id = _mul(
        _mul(_mul(_add(delta_e, one), _add(delta_e, c(3))),
             _mul(_sub(delta_e, one), _sub(delta_e, c(3)))),
        a(6))
    x_alpha_id = limb.neg_mod(_mul(w3w, a(7)), FR)
    t0 = _mul(_add(_add(w1w, w1), w3w), _mul(_sub(w3w, w1), _sub(w3w, w1)))
    t1 = limb.neg_mod(
        _add(_add(_mul(_mul(w3w, w3w), w3w), _mul(w2, w2)),
             c((-17) % FR_MOD)),
        FR)
    t2 = _dbl2(_mul(_mul(delta_e, w2), qecc))
    x_acc_id = _mul(_add(_add(t0, t1), t2), a(8))
    t0 = _mul(_add(w2w, w2), _sub(w3w, w1))
    t1 = _mul(_sub(w1, w1w), _sub(w2, _mul(qecc, delta_e)))
    y_acc_id = _mul(_add(t0, t1), a(9))
    t0 = _sub(w4, one)
    t1 = _sub(t0, w3)
    acc_init_id = _mul(_mul(t0, t1), a(10))
    x_init_id = limb.neg_mod(_mul(_mul(w1, w3), a(11)), FR)
    y_init_id = _mul(_sub(_mul(_sub(one, w4), qc), _mul(w2, w3)), a(12))
    gate_id = _mul(_add(_add(acc_init_id, x_init_id), y_init_id), qc)
    gate_id = _add(_add(gate_id, acc_id),
                   _add(x_alpha_id, _add(x_acc_id, y_acc_id)))
    fb = _add(fb, _mul(gate_id, qecc))

    # ---- range (alpha^13..alpha^16) -----------------------------------------
    d1 = _sub(w3, _x4(w4))
    d2 = _sub(w2, _x4(w3))
    d3 = _sub(w1, _x4(w2))
    d4 = _sub(w4w, _x4(w1))
    rng = _mul(_quad_range_term(d1), a(13))
    rng = _add(rng, _mul(_quad_range_term(d2), a(14)))
    rng = _add(rng, _mul(_quad_range_term(d3), a(15)))
    rng = _add(rng, _mul(_quad_range_term(d4), a(16)))
    rng = _mul(rng, qrange)

    # ---- logic (alpha^17..alpha^20) -----------------------------------------
    alpha1 = a(1)
    qa = _sub(w1w, _x4(w1))
    qb = _sub(w2w, _x4(w2))
    delta_sum = _add(qa, qb)
    qa2 = _mul(qa, qa)
    qb2 = _mul(qb, qb)
    delta_sq_sum = _add(qa2, qb2)
    identity = _sub(_mul(delta_sum, delta_sum), delta_sq_sum)  # 2ab
    identity = _sub(identity, _dbl2(w3))                        # 2(ab - w)
    identity = _mul(identity, alpha1)
    # + a(a-1)(a-2)(a-3), then * alpha
    t2a = _sub(qa2, qa)
    t0 = _add(_sub(t2a, _x4(qa)), c(6))
    identity = _mul(_add(identity, _mul(t0, t2a)), alpha1)
    t3b = _sub(qb2, qb)
    t1 = _add(_sub(t3b, _x4(qb)), c(6))
    identity = _mul(_add(identity, _mul(t1, t3b)), alpha1)

    three_ab = _add(_dbl2(delta_sum), delta_sum)          # 3(a+b)
    nine_ab = _add(_dbl2(three_ab), three_ab)             # 9(a+b)
    eighteen_ab = _dbl2(nine_ab)                          # 18(a+b)
    eightyone_ab = _add(nine_ab, _x4(eighteen_ab))        # 81(a+b)
    eighteen_sq = _mul(c(18), delta_sq_sum)               # 18(a^2+b^2)

    w_term = _add(_sub(_x4(w3), eighteen_ab), c(81))
    w_term = _mul(w_term, w3)
    t1 = _add(_sub(eighteen_sq, eightyone_ab), c(83))
    w_term = _mul(_add(w_term, t1), w3)  # delta_sum in the reference

    qc_term = _sub(w4w, _x4(w4))
    three_c = _add(_dbl2(qc_term), qc_term)
    nine_c = _add(_dbl2(three_c), three_c)
    t3 = _mul(_sub(nine_c, three_ab), qc)
    t2 = _sub(_add(three_c, three_ab), _dbl2(w_term))
    t2 = _add(t2, t3)
    identity = _mul(_add(identity, t2), a(17))
    logic = _mul(identity, qlogic)

    total = _add(_add(perm, arith), _add(fb, _add(rng, logic)))
    return _mul(total, vanish_scale)


def _compress4(a, b, c, d, eta):
    """a + eta b + eta^2 c + eta^3 d via Horner (Montgomery planes)."""
    return _add(a, _mul(eta, _add(b, _mul(eta, _add(c, _mul(eta, d))))))


def _lookup_pair_terms(F, T, Tw, h1, h2, h1w, beta, gamma):
    """The plookup product's numerator and denominator at each lane:
    (1+b)(g + F)(g(1+b) + T + b T(w)) and
    (g(1+b) + h1 + b h2)(g(1+b) + h2 + b h1(w))."""
    one_p_beta = _add(beta, _c(1, F.device))
    gamma_pb = _mul(gamma, one_p_beta)
    num = _mul(_mul(one_p_beta, _add(gamma, F)),
               _add(_add(T, _mul(beta, Tw)), gamma_pb))
    den = _mul(_add(_add(h1, _mul(beta, h2)), gamma_pb),
               _add(_add(h2, _mul(beta, h1w)), gamma_pb))
    return num, den


def lookup_grand_product(wires, q_lookup, q_index, tables, h1, h2, eta, beta,
                         gamma, randoms, n: int):
    """Plookup grand product Z_LOOKUP(X) in lagrange form, blinded.

    Per enforced row i (the sorted list stored as even/odd halves h1/h2 so
    both pair products are row-local):

      z_{i+1}/z_i = (1+b)(g + F_i)(g(1+b) + T_i + b T_{i+1})
                    / [(g(1+b) + h1_i + b h2_i)(g(1+b) + h2_i + b h1_{i+1})]

    F = q_lookup * (w1 + eta w2 + eta^2 w3 + eta^3 q_index);
    T = t1 + eta t2 + eta^2 t3 + eta^3 t4.  The scan and single-inversion
    structure of ``grand_product``; blinding at rows n-3 .. n-1.

    wires: (16, >= 3, n) or >= 3 planes; tables: (16, 4, n) or 4 planes;
    h1/h2: (16, n); eta/beta/gamma: (16, 1); randoms: (16, 3)."""
    w, t = _cols(wires), _cols(tables)
    F = _mul(q_lookup, _compress4(w[0], w[1], w[2], q_index, eta))
    T = _compress4(t[0], t[1], t[2], t[3], eta)
    num, den = _lookup_pair_terms(F, T, _rolled(T, 1), h1, h2, _rolled(h1, 1),
                                  beta, gamma)
    prefix_num = limb.scan_mul(num, FR, axis=1)
    suffix_den = limb.scan_mul(den, FR, axis=1, reverse=True)
    inv_total = limb.inv_mont(suffix_den[:, :1], FR)
    zrest = _mul(_mul(prefix_num[:, : n - 1], suffix_den[:, 1:]), inv_total)
    z = torch.cat([_c(1, h1.device), zrest], dim=1)
    z[:, n - 4 + 1: n - 4 + 1 + randoms.shape[1]] = randoms
    return z


def _lookup_terms(w, x, l1, lend, a, eta, beta, gamma):
    """Plookup quotient terms (alpha^21..23), lane by lane: (num - den)
    over the identity rows, L_1 (z_lookup - 1) and L_end (z_lookup(Xw) -
    1) at the boundaries.  w: the wires; x: the lookup polynomials by name
    (``table_1..4``, ``q_lookup``, ``q_index``, ``s_1``, ``s_2``,
    ``z_lookup``) and, with ``_omega``, the tables, ``s_1`` and
    ``z_lookup`` at the next point of the small domain."""
    F = _mul(x["q_lookup"], _compress4(w[0], w[1], w[2], x["q_index"], eta))
    T = _compress4(*(x[f"table_{i}"] for i in range(1, 5)), eta)
    Tw = _compress4(*(x[f"table_{i}_omega"] for i in range(1, 5)), eta)
    zl, zlw = x["z_lookup"], x["z_lookup_omega"]
    num, den = _lookup_pair_terms(F, T, Tw, x["s_1"], x["s_2"],
                                  x["s_1_omega"], beta, gamma)
    num = _mul(num, zl)
    den = _mul(den, zlw)
    one = _c(1, zl.device)
    t = _mul(_sub(num, den), a(21))
    t = _add(t, _mul(_mul(_sub(zl, one), l1), a(22)))
    return _add(t, _mul(_mul(_sub(zlw, one), lend), a(23)))


def _ultra_terms(w, ww, s, z, zw, q, l1, lend, pts, vanish_scale, alphas,
                 beta, gamma, delta, eta, x):
    """UltraPlonk quotient, lane by lane: the Turbo terms with the
    division deferred (scaled by a plane of ones, as the reference does),
    plus the plookup terms (``_lookup_terms``, the lookup polynomials in
    ``x``), then the vanishing scale."""
    a = lambda p: alphas[:, p - 1: p]  # noqa: E731
    turbo = _turbo_terms(w, ww, s, z, zw, q, l1, lend, pts,
                         _c(1, pts.device), alphas, beta, gamma, delta)
    lk = _lookup_terms(w, x, l1, lend, a, eta, beta, gamma)
    return _mul(_add(turbo, lk), vanish_scale)


def _mimc_terms(w, ww, s, z, zw, q, l1, lend, pts, vanish_scale, alpha, beta,
                gamma, delta):
    """MiMC-composer quotient, lane by lane: Standard PLONK + the x^7
    block-cipher gate (ref: mimc_widget.hpp:8-60: T0 = w1 + w3 +
    q_mimc_coeff, T1 = T0^3 - w2, T2 = w2^2 T0 - w3(Xw), contribution
    (T1 alpha^5 + T2 alpha^6) q_mimc_selector).  q: qm q1 q2 q3 qc
    q_mimc_coefficient q_mimc_selector; ww[2] is w3 at the next point."""
    w1, w2, w3 = w
    perm = _perm_quotient(w, s, z, zw, l1, lend, pts, alpha, beta, gamma,
                          delta)
    alpha_sqr = _mul(alpha, alpha)
    alpha_quad = _mul(alpha_sqr, alpha_sqr)
    arith = _mul(q[0], _mul(w1, w2))
    arith = _add(arith, _mul(q[1], w1))
    arith = _add(arith, _mul(q[2], w2))
    arith = _add(arith, _mul(q[3], w3))
    arith = _add(arith, q[4])
    arith = _mul(arith, alpha_quad)

    a5 = _mul(alpha_quad, alpha)
    a6 = _mul(a5, alpha)
    T0 = _add(_add(w1, w3), q[5])
    T1 = _sub(_mul(_mul(T0, T0), T0), w2)
    T2 = _sub(_mul(_mul(w2, w2), T0), ww[2])
    mimc = _mul(_add(_mul(T1, a5), _mul(T2, a6)), q[6])
    return _mul(_add(_add(perm, arith), mimc), vanish_scale)


def elliptic_identity(wffts, q_beta, q_beta_sqr, q_sign, q_elliptic, alpha,
                      alpha2):
    """EllipticKernel identities (ref: elliptic_widget.hpp:8-80, the ecc
    add gate family; as in the reference, no composer instantiates it).

    wffts: (16, 4, rows) wires in gate layout or 4 planes; the shifted
    access is the next row ((x_1, y_1) at row i in w_2/w_3, (x_2, y_2) at
    row i+1 in w_1/w_4, (x_3, y_3) at row i+1 in w_2/w_3).  Returns the
    combined x/y identity at each row (zero on satisfied gates)."""
    w1, w2, w3, w4 = _cols(wffts)
    x_1, y_1 = w2, w3
    x_2 = _rolled(w1, 1)
    y_2 = _rolled(w4, 1)
    x_3 = _rolled(w2, 1)
    y_3 = _rolled(w3, 1)

    zero = torch.zeros_like(x_2)
    beta_term = _mul(_sub(zero, _mul(x_2, x_1)), _add(_add(x_3, x_3), x_1))
    x2_sqr = _mul(x_2, x_2)
    beta_sqr_term = _mul(x2_sqr, _sub(x_3, x_1))
    sign_term = _mul(y_2, y_1)
    sign_term = _add(sign_term, sign_term)
    leftovers = _mul(x2_sqr, x_2)
    leftovers = _add(leftovers, _mul(_mul(x_1, x_1), _add(x_3, x_1)))
    leftovers = _sub(leftovers, _add(_mul(y_2, y_2), _mul(y_1, y_1)))
    x_identity = _add(
        _add(_mul(beta_term, q_beta), _mul(beta_sqr_term, q_beta_sqr)),
        _add(_mul(sign_term, q_sign), leftovers))
    x_identity = _mul(x_identity, alpha)

    beta_term = _mul(_mul(x_2, _add(y_3, y_1)), q_beta)
    sign_term = _sub(zero, _mul(_mul(y_2, _sub(x_1, x_3)), q_sign))
    leftovers = _sub(_mul(y_1, _sub(x_1, x_3)), _mul(x_1, _add(y_3, y_1)))
    y_identity = _mul(_add(_add(beta_term, sign_term), leftovers), alpha2)
    return _mul(_add(x_identity, y_identity), q_elliptic)


def linear_combination(stack, scalars):
    """sum_k scalars[:, k] * stack[k] -> (16, n); stack a (16, k, n) stack
    or a sequence of k (16, n) planes, scalars (16, k), Montgomery in and
    out."""
    acc = None
    for i, p in enumerate(_cols(stack)):
        y = _mul(p, scalars[:, i:i + 1])
        acc = y if acc is None else _add(acc, y)
    return acc


def sigma_from_mapping(next_row, factor_idx, omega_pows, n: int):
    """sigma lagrange values omega^{next_row} * factor[factor_idx]; factors
    [1, k1, k2, k3, k_external] (ref: utils/permutation.hpp)."""
    dev = omega_pows.device
    factors = torch.cat([_c(v, dev) for v in (
        1, FR_COSET_GENERATORS[0], FR_COSET_GENERATORS[1],
        FR_COSET_GENERATORS[2], FR_COSET_GENERATORS[7])], dim=1)  # (16, 5)
    root = omega_pows.index_select(1, next_row.to(dev, torch.int64))
    f = factors.index_select(1, factor_idx.to(dev, torch.int64))
    return _mul(root, f)


def vanishing_scale(pts, small_n: int, small_root: int, k_cut: int = 4):
    """1/Z*_H at each of ``pts``, with Z*_H(x) = (x^n - 1) /
    prod_{j=1..k} (x - w^{n-j}) (ref: polynomial_arithmetic.cpp:628-725)."""
    dev = pts.device
    xn = limb.mont_pow(pts, np.array([(small_n >> i) & 1
                                      for i in range(small_n.bit_length())]),
                       FR)
    den = _sub(xn, _c(1, dev))
    num = None
    root_inv = pow(small_root, -1, FR_MOD)
    w_pow = root_inv
    for _ in range(k_cut):
        term = _sub(pts, _c(w_pow, dev))
        num = term if num is None else _mul(num, term)
        w_pow = w_pow * root_inv % FR_MOD
    inv_den = limb.batch_inv_mont(den, FR, axis=1)
    return _mul(num, inv_den)


def vanishing_scale_table(small_n: int, large_root: int, small_root: int,
                          generator: int, k_cut: int = 4, device="cuda"):
    """(coset_pts, scale): the 4n coset points g W^i and 1/Z*_H(g W^i)
    (``vanishing_scale``).  Built once per key."""
    W = powers_table(mont_plane(large_root, device), 4 * small_n)
    pts = _mul(_c(generator, device), W)
    return pts, vanishing_scale(pts, small_n, small_root, k_cut)
