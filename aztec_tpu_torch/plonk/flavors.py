"""Scheme flavors: the quotient kernel, the host linear-term scalars for
r(X) and the verifier's [D]_1, and the verifier's quotient-evaluation
reconstruction, for Standard PLONK, TurboPlonk and UltraPlonk, each with
the keccak transcript and unrolled (the Pedersen-Blake2s transcript, no
linearisation), and for the MiMC composer (keccak only).  UltraPlonk's
prover hooks build the plookup sorted list and grand product.

Port of aztec_tpu/plonk/flavors.py.  All host scalar math is canonical-int
mod r.
"""

from __future__ import annotations

import torch

from ..ff.bn254 import FR_MOD, FR_COSET_GENERATORS
from .manifests import (
    MIMC, STANDARD, TURBO, ULTRA, UNROLLED_STANDARD, UNROLLED_TURBO,
    UNROLLED_ULTRA,
)
from . import kernels

M = FR_MOD

# lane slices of a coset quarter: the quotient's temporaries are a slice
# wide, and the card still sees n / 8 lanes a launch (2^21 at 2^24)
QUARTER_SLICES = 8


def _quotient(pk, wire_mono, wire_fft, width, selectors, terms, chs, n,
              shifted_wires=True, extra=()):
    """The quotient's evaluations over the 4n coset, (16, 4n) in the coset's
    order, by ``terms`` (``kernels._std_terms``, ``_turbo_terms``,
    ``_ultra_terms``, ``_mimc_terms``) lane by lane.  A key with 4n coset
    forms (``pk.quarters`` false) is read as it stands; otherwise each
    coset quarter's evaluations are computed from the monomials
    (``pk.quarter``) and its lanes evaluated in ``QUARTER_SLICES`` slices;
    lane k of quarter j is the coset's point 4k + j, so the next point of
    the small domain is lane k + 1 of the same quarter.  Every lane runs
    the same formula either way.  Without ``shifted_wires`` (no gate of
    the flavor reads the next row's wires) ``terms`` gets None for them.

    ``extra``: (name, shifted) pairs of further polynomials, the prover's
    (``wire_mono`` / ``wire_fft``) or the key's selectors; ``terms`` then
    gets one more argument, a dict of their planes by name and, for the
    shifted ones, by ``<name>_omega`` at the next point."""
    wires = [f"w_{i}" for i in range(1, width + 1)]
    sigmas = [f"sigma_{i}" for i in range(1, width + 1)]

    def poly(name, fft):
        """A prover polynomial or a key selector, 4n form or monomial."""
        if name in wire_mono:
            return wire_fft[name] if fft else wire_mono[name]
        store = pk.selectors[name]
        return store.fft if fft else store.monomial

    if not pk.quarters:
        w = [wire_fft[x].contiguous() for x in wires]
        z, l1 = wire_fft["z"], pk.l1_fft
        ww = [kernels._rolled(x, 4) for x in w] if shifted_wires else None
        ext = {}
        for name, shifted in extra:
            ext[name] = poly(name, True)
            if shifted:
                ext[f"{name}_omega"] = kernels._rolled(ext[name], 4)
        return terms(w, ww,
                     [pk.sigmas[x].fft for x in sigmas], z,
                     kernels._rolled(z, 4),
                     [pk.selectors[x].fft for x in selectors], l1,
                     kernels._rolled(l1, 20), pk.coset_pts, pk.vanish_scale,
                     *chs, *((ext,) if extra else ()))
    S = QUARTER_SLICES
    m = n // S
    out = torch.empty((16, n, 4), dtype=torch.int32, device=pk.device)
    for j in range(4):
        evaluate, pts, l1, vs = pk.quarter(j)

        def sliced(x):
            """(16, n) -> (S, 16, m): slice s contiguous, lanes s*m .."""
            return x.view(16, S, m).transpose(0, 1).contiguous()

        w = [sliced(evaluate(wire_mono[x])) for x in wires]
        sg = [sliced(evaluate(pk.sigmas[x].monomial)) for x in sigmas]
        q = [sliced(evaluate(pk.selectors[x].monomial)) for x in selectors]
        z = sliced(evaluate(wire_mono["z"]))
        ex = {name: sliced(evaluate(poly(name, False))) for name, _ in extra}
        del evaluate           # and with it the quarter's powers table
        l1, pts, vs = sliced(l1), sliced(pts), sliced(vs)
        for si in range(S):
            lanes = torch.arange(si * m, (si + 1) * m, device=pk.device)

            def ahead(x, k):
                """Lanes si*m + k .. of x (wrapping), (16, m)."""
                i = (lanes + k) % n
                return x[i // m, :, i % m].t().contiguous()

            ext = {}
            for name, shifted in extra:
                ext[name] = ex[name][si]
                if shifted:
                    ext[f"{name}_omega"] = ahead(ex[name], 1)
            out[:, si * m:(si + 1) * m, j] = terms(
                [x[si] for x in w],
                [ahead(x, 1) for x in w] if shifted_wires else None,
                [x[si] for x in sg], z[si], ahead(z, 1), [x[si] for x in q],
                l1[si], ahead(l1, 5), pts[si], vs[si], *chs,
                *((ext,) if extra else ()))
        del w, sg, q, z, ex
    return out.view(16, 4 * n)


def _perm_linear_terms(ev, ch, l_start, width):
    """z / sigma_last multiplicands for r(X) and [D]_1
    (ref: permutation_widget_impl.hpp:504-593, 785-885)."""
    alpha, beta, gamma, zeta = ch["alpha"], ch["beta"], ch["gamma"], ch["zeta"]
    z_beta = zeta * beta % M
    z_contrib = 1
    for k in range(width):
        kk = 1 if k == 0 else FR_COSET_GENERATORS[k - 1]
        z_contrib = z_contrib * (ev[f"w_{k+1}"] + z_beta * kk + gamma) % M
    z_mult = (z_contrib * alpha + l_start * pow(alpha, 3, M)) % M

    sigma_contrib = 1
    for k in range(width - 1):
        sigma_contrib = (
            sigma_contrib * (ev[f"sigma_{k+1}"] * beta + ev[f"w_{k+1}"] + gamma)
        ) % M
    sigma_mult = (-(sigma_contrib * ev["z_omega"] % M * alpha % M * beta)) % M
    return z_mult, sigma_mult


def _perm_t_contribution(ev, ch, l_start, l_end, delta, width,
                         use_linearisation=True):
    """Permutation part of the verifier's quotient evaluation
    (ref: permutation_widget_impl.hpp:601-783).  Under linearisation the
    r_eval carries the z/sigma polynomial terms; unrolled verifiers add
    them explicitly (parts 4 + 5.2 of the reference)."""
    alpha, beta, gamma = ch["alpha"], ch["beta"], ch["gamma"]
    sigma_contribution = 1
    for i in range(width - 1):
        sigma_contribution = (
            sigma_contribution
            * (ev[f"sigma_{i+1}"] * beta + ev[f"w_{i+1}"] + gamma)
        ) % M
    sigma_contribution = (
        sigma_contribution * (ev[f"w_{width}"] + gamma) % M
        * ev["z_omega"] % M * alpha
    ) % M
    a2 = alpha * alpha % M
    a3 = a2 * alpha % M
    t = (
        (ev["z_omega"] - delta) * l_end % M * a2
        - l_start * a3
        - sigma_contribution
    ) % M
    if use_linearisation:
        return (t + ev["r"]) % M
    z_mult, sigma_mult = _perm_linear_terms(ev, ch, l_start, width)
    t = (t + sigma_mult * ev[f"sigma_{width}"]) % M
    t = (t + z_mult * ev["z"]) % M
    return t


class StandardFlavor:
    settings = STANDARD
    width = 3

    @staticmethod
    def quotient_evals(pk, wire_mono, wire_fft, ch_mont, n):
        return _quotient(
            pk, wire_mono, wire_fft, 3, ("q_m", "q_1", "q_2", "q_3", "q_c"),
            kernels._std_terms, (ch_mont["alpha"], ch_mont["beta"],
                                 ch_mont["gamma"], ch_mont["delta"]), n,
            shifted_wires=False)

    @staticmethod
    def selector_linear_scalars(ev, ch):
        """poly_label -> scalar for r(X) / [D]_1 (alphas folded in).

        ref: arithmetic_widget.hpp:35-68 (alpha_base = alpha^4 after the
        permutation widget).
        """
        alpha4 = pow(ch["alpha"], 4, M)
        a, b, c = ev["w_1"], ev["w_2"], ev["w_3"]
        return {
            "q_m": a * b % M * alpha4 % M,
            "q_1": a * alpha4 % M,
            "q_2": b * alpha4 % M,
            "q_3": c * alpha4 % M,
            "q_c": alpha4,
        }

    @staticmethod
    def perm_linear_terms(ev, ch, l_start):
        return _perm_linear_terms(ev, ch, l_start, 3)

    @staticmethod
    def verifier_t_contribution(ev, ch, l_start, l_end, delta):
        # arithmetic widget adds no non-linear terms under linearisation
        return _perm_t_contribution(ev, ch, l_start, l_end, delta, 3)


class MimcFlavor(StandardFlavor):
    """MiMC composer flavor (ref: mimc_widget.hpp:8-60): standard PLONK
    plus the x^7 block-cipher gate at alpha^5..6, which reads w_3 at the
    next row."""

    settings = MIMC
    width = 3

    @staticmethod
    def quotient_evals(pk, wire_mono, wire_fft, ch_mont, n):
        return _quotient(
            pk, wire_mono, wire_fft, 3,
            ("q_m", "q_1", "q_2", "q_3", "q_c", "q_mimc_coefficient",
             "q_mimc_selector"),
            kernels._mimc_terms, (ch_mont["alpha"], ch_mont["beta"],
                                  ch_mont["gamma"], ch_mont["delta"]), n)

    @staticmethod
    def selector_linear_scalars(ev, ch):
        scalars = StandardFlavor.selector_linear_scalars(ev, ch)
        al = ch["alpha"]
        a5 = pow(al, 5, M)
        a6 = a5 * al % M
        T0 = (ev["w_1"] + ev["w_3"] + ev["q_mimc_coefficient"]) % M
        T1 = (T0 * T0 % M * T0 - ev["w_2"]) % M
        T2 = (ev["w_2"] * ev["w_2"] % M * T0 - ev["w_3_omega"]) % M
        scalars["q_mimc_selector"] = (T1 * a5 + T2 * a6) % M
        return scalars


class TurboFlavor:
    settings = TURBO
    width = 4

    SELECTOR_ORDER = (
        "q_m", "q_1", "q_2", "q_3", "q_4", "q_5", "q_c", "q_arith",
        "q_ecc_1", "q_range", "q_logic",
    )

    @classmethod
    def quotient_evals(cls, pk, wire_mono, wire_fft, ch_mont, n):
        return _quotient(
            pk, wire_mono, wire_fft, 4, cls.SELECTOR_ORDER,
            kernels._turbo_terms, (ch_mont["alphas"], ch_mont["beta"],
                                   ch_mont["gamma"], ch_mont["delta"]), n)

    @staticmethod
    def selector_linear_scalars(ev, ch):
        """Turbo widget linear terms from evaluations, alphas folded in
        (ref: turbo_arithmetic_widget.hpp:18-63 x alpha^4,
        turbo_fixed_base_widget.hpp:18-62 with alpha^6..12,
        turbo_range_widget.hpp with alpha^13..16,
        turbo_logic_widget.hpp with alpha^17)."""
        al = ch["alpha"]
        ap = [pow(al, k, M) for k in range(22)]  # ap[k] = alpha^k
        a, b, c, d = ev["w_1"], ev["w_2"], ev["w_3"], ev["w_4"]
        aw, bw, cw, dw = (
            ev["w_1_omega"], ev["w_2_omega"], ev["w_3_omega"], ev["w_4_omega"]
        )
        q_arith, q_ecc, q_c_ev = ev["q_arith"], ev["q_ecc_1"], ev["q_c"]

        out = {}
        # turbo arithmetic (x alpha^4; q5 term carries one extra alpha)
        out["q_m"] = q_arith * a % M * b % M * ap[4] % M
        out["q_1"] = q_arith * a % M * ap[4] % M
        out["q_2"] = q_arith * b % M * ap[4] % M
        out["q_3"] = q_arith * c % M * ap[4] % M
        out["q_4"] = q_arith * d % M * ap[4] % M
        out["q_5"] = (
            (d * d - d) % M * ((d - 2) % M) % M * q_arith % M * ap[5]
        ) % M
        out["q_c"] = q_arith * ap[4] % M

        # fixed-base ECC
        delta = (dw - 4 * d) % M
        out["q_1"] = (out["q_1"] + delta * delta % M * q_ecc % M * ap[7]) % M
        out["q_2"] = (out["q_2"] + q_ecc * ap[7]) % M
        q3m = (aw - a) % M * delta % M * cw % M * ap[9] % M * q_ecc % M
        t1 = delta * cw % M * b % M * ap[8] % M
        q3m = (q3m + 2 * t1 % M * q_ecc) % M
        out["q_3"] = (out["q_3"] + q3m) % M
        out["q_4"] = (out["q_4"] + c * q_ecc % M * q_c_ev % M * ap[11]) % M
        out["q_5"] = (
            out["q_5"] + (1 - d) % M * q_ecc % M * q_c_ev % M * ap[11]
        ) % M
        out["q_m"] = (out["q_m"] + c * q_ecc % M * q_c_ev % M * ap[12]) % M

        # range
        def quad(x):
            return x % M * ((x - 1) % M) % M * ((x - 2) % M) % M * ((x - 3) % M) % M

        d1 = (c - 4 * d) % M
        d2 = (b - 4 * c) % M
        d3 = (a - 4 * b) % M
        d4 = (dw - 4 * a) % M
        out["q_range"] = (
            quad(d1) * ap[13] + quad(d2) * ap[14]
            + quad(d3) * ap[15] + quad(d4) * ap[16]
        ) % M

        # logic
        qa = (aw - 4 * a) % M
        qb = (bw - 4 * b) % M
        ds = (qa + qb) % M
        dss = (qa * qa + qb * qb) % M
        identity = (ds * ds - dss - 2 * c) % M * al % M
        t2a = (qa * qa - qa) % M
        identity = (identity + (t2a - 4 * qa + 6) % M * t2a) % M * al % M
        t3b = (qb * qb - qb) % M
        identity = (identity + (t3b - 4 * qb + 6) % M * t3b) % M * al % M
        w_term = ((4 * c - 18 * ds + 81) % M) * c % M
        w_term = (w_term + 18 * dss - 81 * ds + 83) % M * c % M
        qc_quad = (dw - 4 * d) % M
        t3 = (9 * qc_quad - 3 * ds) % M * q_c_ev % M
        t2 = (3 * qc_quad + 3 * ds - 2 * w_term + t3) % M
        out["q_logic"] = (identity + t2) % M * ap[17] % M
        return out

    @staticmethod
    def perm_linear_terms(ev, ch, l_start):
        return _perm_linear_terms(ev, ch, l_start, 4)

    @classmethod
    def verifier_t_contribution(cls, ev, ch, l_start, l_end, delta):
        t = _perm_t_contribution(ev, ch, l_start, l_end, delta, 4)
        return (t + cls._nonlinear_t_terms(ev, ch)) % M

    @staticmethod
    def _nonlinear_t_terms(ev, ch):
        """Turbo-arithmetic quad extraction + fixed-base gate identity from
        evaluations (ref: turbo_arithmetic_widget.hpp:66-123,
        turbo_fixed_base_widget.hpp:85-158)."""
        t = 0
        al = ch["alpha"]
        ap = [pow(al, k, M) for k in range(14)]
        a, b, c, d = ev["w_1"], ev["w_2"], ev["w_3"], ev["w_4"]
        aw, bw, cw, dw = (
            ev["w_1_omega"], ev["w_2_omega"], ev["w_3_omega"], ev["w_4_omega"]
        )
        q_arith, q_ecc, q_c_ev = ev["q_arith"], ev["q_ecc_1"], ev["q_c"]

        # arithmetic quad-extraction (q_arith == 2 branch)
        dlt = (c - 4 * d) % M
        term = dlt * ((9 * dlt - 2 * dlt * dlt - 7) % M) % M
        t = (t + (q_arith * q_arith - q_arith) % M * term % M * ap[4]) % M

        # fixed-base non-linear gate identity
        de = (dw - 4 * d) % M
        acc_id = (
            (de + 1) * (de + 3) % M * ((de - 1) % M) % M * ((de - 3) % M) % M
            * ap[6]
        ) % M
        x_alpha_id = (-(cw * ap[7])) % M
        t0 = (aw + a + cw) % M * pow((cw - a) % M, 2, M) % M
        t1 = (-(cw * cw % M * cw + b * b - 17)) % M
        t2 = 2 * de * b % M * q_ecc % M
        x_acc_id = (t0 + t1 + t2) % M * ap[8] % M
        t0 = (bw + b) % M * ((cw - a) % M) % M
        t1 = (a - aw) % M * ((b - q_ecc * de) % M) % M
        y_acc_id = (t0 + t1) % M * ap[9] % M
        t0 = (d - 1) % M
        t1 = (t0 - c) % M
        acc_init_id = t0 * t1 % M * ap[10] % M
        x_init_id = (-(a * c % M * ap[11])) % M
        y_init_id = ((1 - d) * q_c_ev - b * c) % M * ap[12] % M
        gate_id = (acc_init_id + x_init_id + y_init_id) % M * q_c_ev % M
        gate_id = (gate_id + acc_id + x_alpha_id + x_acc_id + y_acc_id) % M
        t = (t + gate_id * q_ecc) % M
        return t


class UnrolledStandardFlavor(StandardFlavor):
    """Unrolled standard PLONK (no linearisation; ref: prover_settings.hpp:
    28-40 + unrolled_standard_verifier_settings)."""

    settings = UNROLLED_STANDARD

    @classmethod
    def verifier_t_contribution(cls, ev, ch, l_start, l_end, delta):
        t = _perm_t_contribution(ev, ch, l_start, l_end, delta, 3,
                                 use_linearisation=False)
        # arithmetic widget linear sum from evaluations
        for sel, scalar in cls.selector_linear_scalars(ev, ch).items():
            t = (t + scalar * ev[sel]) % M
        return t


class UnrolledTurboFlavor(TurboFlavor):
    """Unrolled TurboPlonk (ref: prover_settings.hpp:57-68 +
    unrolled_turbo_verifier_settings)."""

    settings = UNROLLED_TURBO

    @classmethod
    def verifier_t_contribution(cls, ev, ch, l_start, l_end, delta):
        # permutation (unrolled) + all widget non-linear terms
        t = _perm_t_contribution(ev, ch, l_start, l_end, delta, 4,
                                 use_linearisation=False)
        t = (t + TurboFlavor._nonlinear_t_terms(ev, ch)) % M
        for sel, scalar in cls.selector_linear_scalars(ev, ch).items():
            t = (t + scalar * ev[sel]) % M
        return t


# the plookup polynomials the Ultra quotient reads, and whether it reads
# each at the next point too
LOOKUP_POLYS = (
    tuple((f"table_{i}", True) for i in range(1, 5))
    + (("q_lookup", False), ("q_index", False), ("s_1", True),
       ("s_2", False), ("z_lookup", True))
)


class UltraFlavor(TurboFlavor):
    """UltraPlonk: turbo gate set + plookup argument (reserved slots
    polynomial_manifest.hpp:23-46, lookup_tables.md).  Unlinearised; the
    prover hooks commit S_1/S_2 after eta and Z_LOOKUP alongside Z."""

    settings = ULTRA
    uses_lookups = True
    num_alphas = 24

    # -- prover hooks ---------------------------------------------------------
    @staticmethod
    def after_eta(prover):
        """Build the sorted-list halves h1/h2 (host), blind, commit S_1/S_2."""
        from ..poly import fft_ops as pfft
        from .lookup_tables import build_sorted_halves
        from .proving_key import ints_to_mont

        eta = prover.transcript.get_challenge_fr("eta")
        aux = prover.aux
        n = prover.n
        m = n - prover.settings.num_roots_cut_out_of_vanishing_polynomial
        h1, h2 = build_sorted_halves(aux["tables"], aux["lookups"], eta, m)
        h1 = h1 + [0] * (n - len(h1))
        h2 = h2 + [0] * (n - len(h2))
        for name, vals in (("s_1", h1), ("s_2", h2)):
            lag = prover._blind(ints_to_mont(vals, prover.device), 3, n - 3)
            prover.wires_lagrange[name] = lag
            prover.wire_mono[name] = pfft.ifft(lag, prover.key.small_domain)
        prover._commit(prover.wire_mono["s_1"], "S_1")
        prover._commit(prover.wire_mono["s_2"], "S_2")

    @staticmethod
    def third_round_extra(prover):
        """Z_LOOKUP grand product + commitment (its three randoms drawn
        after Z's, as the reference draws them), and the coset FFTs of
        S_1, S_2 and Z_LOOKUP for a key with stored 4n forms."""
        from ..poly import fft_ops as pfft

        key = prover.key
        lag = prover.wires_lagrange
        eta = prover._fr(prover.transcript.get_challenge_fr("eta"))[:, None]
        beta = prover._fr(prover._challenge("beta", 0))[:, None]
        gamma = prover._fr(prover._challenge("beta", 1))[:, None]
        randoms = torch.stack([prover._fr(prover.rng()) for _ in range(3)],
                              dim=1)
        zl = kernels.lookup_grand_product(
            [lag[f"w_{i}"] for i in range(1, 4)],
            key.selectors["q_lookup"].lagrange,
            key.selectors["q_index"].lagrange,
            [key.selectors[f"table_{i}"].lagrange for i in range(1, 5)],
            lag["s_1"], lag["s_2"], eta, beta, gamma, randoms, prover.n)
        zl_mono = pfft.ifft(zl, key.small_domain)
        del zl
        prover.wire_mono["z_lookup"] = zl_mono
        prover._commit(zl_mono, "Z_LOOKUP")
        if key.quarters:
            return  # the quotient evaluates the monomials by coset quarters
        for tag in ("s_1", "s_2", "z_lookup"):
            prover.wire_fft[tag] = pfft.coset_fft(
                key._extend(prover.wire_mono[tag]), key.large_domain)

    # -- quotient -------------------------------------------------------------
    @classmethod
    def quotient_evals(cls, pk, wire_mono, wire_fft, ch_mont, n):
        return _quotient(
            pk, wire_mono, wire_fft, 4, cls.SELECTOR_ORDER,
            kernels._ultra_terms, (ch_mont["alphas"], ch_mont["beta"],
                                   ch_mont["gamma"], ch_mont["delta"],
                                   ch_mont["eta"]), n,
            extra=LOOKUP_POLYS)

    # -- verifier -------------------------------------------------------------
    @staticmethod
    def _lookup_t_terms(ev, ch, l_start, l_end):
        eta, beta, gamma, alpha = ch["eta"], ch["beta"], ch["gamma"], ch["alpha"]
        ap = [pow(alpha, k, M) for k in range(24)]
        F = (
            ev["q_lookup"]
            * ((ev["w_1"] + eta * (ev["w_2"] + eta * (ev["w_3"]
               + eta * ev["q_index"]))) % M)
        ) % M
        T = (ev["table_1"] + eta * (ev["table_2"] + eta * (ev["table_3"]
             + eta * ev["table_4"]))) % M
        Tw = (ev["table_1_omega"] + eta * (ev["table_2_omega"]
              + eta * (ev["table_3_omega"] + eta * ev["table_4_omega"]))) % M
        one_p_beta = (1 + beta) % M
        gamma_pb = gamma * one_p_beta % M
        num = (
            one_p_beta * ((gamma + F) % M) % M
            * ((T + beta * Tw + gamma_pb) % M) % M * ev["z_lookup"]
        ) % M
        den = (
            (ev["s_1"] + beta * ev["s_2"] + gamma_pb) % M
            * ((ev["s_2"] + beta * ev["s_1_omega"] + gamma_pb) % M) % M
            * ev["z_lookup_omega"]
        ) % M
        t = (num - den) * ap[21] % M
        t = (t + (ev["z_lookup"] - 1) * l_start % M * ap[22]) % M
        t = (t + (ev["z_lookup_omega"] - 1) * l_end % M * ap[23]) % M
        return t

    @classmethod
    def verifier_t_contribution(cls, ev, ch, l_start, l_end, delta):
        t = _perm_t_contribution(ev, ch, l_start, l_end, delta, 4,
                                 use_linearisation=False)
        t = (t + TurboFlavor._nonlinear_t_terms(ev, ch)) % M
        for sel, scalar in cls.selector_linear_scalars(ev, ch).items():
            t = (t + scalar * ev[sel]) % M
        t = (t + cls._lookup_t_terms(ev, ch, l_start, l_end)) % M
        return t


class UnrolledUltraFlavor(UltraFlavor):
    """UltraPlonk with the recursion transcript (Pedersen+Blake2s, 16-byte
    challenges).  The quotient math is UltraFlavor's (Ultra is already
    unlinearised); only the Fiat-Shamir hashing changes, so its proofs can
    be verified inside an outer circuit (stdlib/recursion_verifier.py)."""

    settings = UNROLLED_ULTRA


FLAVORS = {
    "standard": StandardFlavor,
    "turbo": TurboFlavor,
    "unrolled_standard": UnrolledStandardFlavor,
    "unrolled_turbo": UnrolledTurboFlavor,
    "ultra": UltraFlavor,
    "unrolled_ultra": UnrolledUltraFlavor,
}
