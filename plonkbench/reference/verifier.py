"""barretenberg's PLONK verifier for the Standard and Turbo flavours with the
Keccak transcript, and for unrolled Turbo with the Pedersen-Blake2s one
(plonk/proof_system/verifier/verifier.cpp under the standard, turbo and
unrolled_turbo settings, the widgets' verifier terms,
kate_commitment_scheme.cpp batch_verify), in plain Python.

A linearised proof opens r(zeta) and the polynomials the linearisation
leaves out; its key's selectors, Z and sigma_last enter the batch opening
through r's multiplicands.  An unrolled proof opens every polynomial: t(zeta)
takes the permutation's Z and sigma_last terms and every widget's selector
terms from their evaluations, and the batch opening takes each polynomial
by its own nu.

The last step differs in form only.  barretenberg checks
e(P0, [1]_2) * e(P1, [x]_2) == 1 with a pairing; the benchmark's reference
string is the dev SRS of a known x = tau, whose G2 point is [tau]_2, and for
points of G1 (cyclic of prime order) that equation holds exactly when
P0 + tau * P1 is the point at infinity.  So the reference checks that.
"""

from __future__ import annotations

import dataclasses

from . import bn254
from .bn254 import COSET, EXTERNAL_COSET, R
from .transcript import (KECCAK, PEDERSEN_BLAKE2S, Hash, Transcript, standard_manifest,
                         turbo_manifest, unrolled_turbo_manifest)

ROOTS_CUT = 4   # num_roots_cut_out_of_vanishing_polynomial


@dataclasses.dataclass(frozen=True)
class Poly:
    commitment: str
    label: str
    linearised: bool
    shifted: bool
    source: str         # witness, selector or permutation


def _polys(rows) -> tuple:
    return tuple(Poly(*r) for r in rows)


STANDARD_POLYS = _polys((
    ("W_1", "w_1", False, False, "witness"), ("W_2", "w_2", False, False, "witness"),
    ("W_3", "w_3", False, True, "witness"), ("Z", "z", True, True, "witness"),
    ("Q_1", "q_1", True, False, "selector"), ("Q_2", "q_2", True, False, "selector"),
    ("Q_3", "q_3", True, False, "selector"), ("Q_M", "q_m", True, False, "selector"),
    ("Q_C", "q_c", True, False, "selector"),
    ("SIGMA_1", "sigma_1", False, False, "permutation"),
    ("SIGMA_2", "sigma_2", False, False, "permutation"),
    ("SIGMA_3", "sigma_3", True, False, "permutation"),
))

TURBO_POLYS = _polys((
    ("W_1", "w_1", False, True, "witness"), ("W_2", "w_2", False, True, "witness"),
    ("W_3", "w_3", False, True, "witness"), ("W_4", "w_4", False, True, "witness"),
    ("Z", "z", True, True, "witness"),
    ("Q_1", "q_1", True, False, "selector"), ("Q_2", "q_2", True, False, "selector"),
    ("Q_3", "q_3", True, False, "selector"), ("Q_4", "q_4", True, False, "selector"),
    ("Q_5", "q_5", True, False, "selector"), ("Q_M", "q_m", True, False, "selector"),
    ("Q_C", "q_c", False, False, "selector"),
    ("Q_ARITHMETIC_SELECTOR", "q_arith", False, False, "selector"),
    ("Q_RANGE_SELECTOR", "q_range", True, False, "selector"),
    ("Q_FIXED_BASE_SELECTOR", "q_ecc_1", False, False, "selector"),
    ("Q_LOGIC_SELECTOR", "q_logic", True, False, "selector"),
    ("SIGMA_1", "sigma_1", False, False, "permutation"),
    ("SIGMA_2", "sigma_2", False, False, "permutation"),
    ("SIGMA_3", "sigma_3", False, False, "permutation"),
    ("SIGMA_4", "sigma_4", True, False, "permutation"),
))


def _perm_linear(ev, ch, l_start, width):
    """The multiplicands of [Z] and [SIGMA_width] in the linearisation."""
    alpha, beta, gamma, zeta = ch["alpha"], ch["beta"], ch["gamma"], ch["zeta"]
    z_contrib = 1
    for k in range(width):
        kk = 1 if k == 0 else COSET[k - 1]
        z_contrib = z_contrib * (ev[f"w_{k + 1}"] + zeta * beta * kk + gamma) % R
    z_mult = (z_contrib * alpha + l_start * pow(alpha, 3, R)) % R
    s = 1
    for k in range(width - 1):
        s = s * (ev[f"sigma_{k + 1}"] * beta + ev[f"w_{k + 1}"] + gamma) % R
    return z_mult, -(s * ev["z_omega"] * alpha * beta) % R


def _perm_t(ev, ch, l_start, l_end, delta, width, linearised):
    """The permutation widget's part of t(zeta): r(zeta) added where the
    proof is linearised, else the Z and sigma_last terms from their
    evaluations."""
    alpha, beta, gamma = ch["alpha"], ch["beta"], ch["gamma"]
    s = 1
    for i in range(width - 1):
        s = s * (ev[f"sigma_{i + 1}"] * beta + ev[f"w_{i + 1}"] + gamma) % R
    s = s * (ev[f"w_{width}"] + gamma) * ev["z_omega"] * alpha % R
    a2 = alpha * alpha % R
    t = (ev["z_omega"] - delta) * l_end * a2 - l_start * a2 * alpha - s
    if linearised:
        return (t + ev["r"]) % R
    z_mult, sigma_mult = _perm_linear(ev, ch, l_start, width)
    return (t + z_mult * ev["z"] + sigma_mult * ev[f"sigma_{width}"]) % R


def _standard_linear(ev, ch):
    """arithmetic_widget.hpp: selector scalars, alpha^4 after the
    permutation widget."""
    a4 = pow(ch["alpha"], 4, R)
    a, b, c = ev["w_1"], ev["w_2"], ev["w_3"]
    return {"q_m": a * b * a4 % R, "q_1": a * a4 % R, "q_2": b * a4 % R,
            "q_3": c * a4 % R, "q_c": a4}


def _turbo_linear(ev, ch):
    """turbo_arithmetic_widget (alpha^4, q_5 alpha^5), turbo_fixed_base_widget
    (alpha^7..12), turbo_range_widget (alpha^13..16), turbo_logic_widget
    (alpha^17): the selector scalars."""
    al = ch["alpha"]
    ap = [pow(al, k, R) for k in range(18)]
    a, b, c, d = ev["w_1"], ev["w_2"], ev["w_3"], ev["w_4"]
    aw, bw, cw, dw = ev["w_1_omega"], ev["w_2_omega"], ev["w_3_omega"], ev["w_4_omega"]
    q_arith, q_ecc, q_c = ev["q_arith"], ev["q_ecc_1"], ev["q_c"]
    out = {"q_m": q_arith * a * b * ap[4], "q_1": q_arith * a * ap[4],
           "q_2": q_arith * b * ap[4], "q_3": q_arith * c * ap[4],
           "q_4": q_arith * d * ap[4],
           "q_5": (d * d - d) * (d - 2) * q_arith * ap[5], "q_c": q_arith * ap[4]}
    delta = dw - 4 * d
    out["q_1"] += delta * delta * q_ecc * ap[7]
    out["q_2"] += q_ecc * ap[7]
    out["q_3"] += (aw - a) * delta * cw * ap[9] * q_ecc + 2 * delta * cw * b * ap[8] * q_ecc
    out["q_4"] += c * q_ecc * q_c * ap[11]
    out["q_5"] += (1 - d) * q_ecc * q_c * ap[11]
    out["q_m"] += c * q_ecc * q_c * ap[12]

    def quad(x):
        return x * (x - 1) * (x - 2) * (x - 3)

    out["q_range"] = (quad(c - 4 * d) * ap[13] + quad(b - 4 * c) * ap[14]
                      + quad(a - 4 * b) * ap[15] + quad(dw - 4 * a) * ap[16])
    qa, qb = (aw - 4 * a) % R, (bw - 4 * b) % R
    ds, dss = (qa + qb) % R, (qa * qa + qb * qb) % R
    identity = (ds * ds - dss - 2 * c) % R * al % R
    t2a = (qa * qa - qa) % R
    identity = (identity + (t2a - 4 * qa + 6) * t2a) % R * al % R
    t3b = (qb * qb - qb) % R
    identity = (identity + (t3b - 4 * qb + 6) * t3b) % R * al % R
    w_term = (4 * c - 18 * ds + 81) * c % R
    w_term = (w_term + 18 * dss - 81 * ds + 83) * c % R
    qc_quad = (dw - 4 * d) % R
    t3 = (9 * qc_quad - 3 * ds) * q_c % R
    t2 = (3 * qc_quad + 3 * ds - 2 * w_term + t3) % R
    out["q_logic"] = (identity + t2) * ap[17]
    return {k: v % R for k, v in out.items()}


def _turbo_nonlinear(ev, ch):
    """turbo_arithmetic_widget's quad extraction and turbo_fixed_base_widget's
    gate identity: the terms of t(zeta) outside r(zeta)."""
    al = ch["alpha"]
    ap = [pow(al, k, R) for k in range(14)]
    a, b, c, d = ev["w_1"], ev["w_2"], ev["w_3"], ev["w_4"]
    aw, bw, cw, dw = ev["w_1_omega"], ev["w_2_omega"], ev["w_3_omega"], ev["w_4_omega"]
    q_arith, q_ecc, q_c = ev["q_arith"], ev["q_ecc_1"], ev["q_c"]
    dlt = c - 4 * d
    t = (q_arith * q_arith - q_arith) * dlt * (9 * dlt - 2 * dlt * dlt - 7) * ap[4]
    de = dw - 4 * d
    acc_id = (de + 1) * (de + 3) * (de - 1) * (de - 3) * ap[6]
    x_alpha_id = -cw * ap[7]
    x_acc_id = ((aw + a + cw) * (cw - a) ** 2 - (cw ** 3 + b * b - 17)
                + 2 * de * b * q_ecc) * ap[8]
    y_acc_id = ((bw + b) * (cw - a) + (a - aw) * (b - q_ecc * de)) * ap[9]
    acc_init_id = (d - 1) * (d - 1 - c) * ap[10]
    x_init_id = -a * c * ap[11]
    y_init_id = ((1 - d) * q_c - b * c) * ap[12]
    gate_id = ((acc_init_id + x_init_id + y_init_id) * q_c + acc_id + x_alpha_id
               + x_acc_id + y_acc_id)
    return (t + gate_id % R * q_ecc) % R


@dataclasses.dataclass(frozen=True)
class Flavor:
    width: int
    manifest: object
    polys: tuple
    linear: object
    nonlinear: object
    linearised: bool = True
    hash: Hash = KECCAK

    def opens(self, p: Poly) -> bool:
        """Whether the proof carries p's evaluation at zeta."""
        return not (self.linearised and p.linearised)


STANDARD = Flavor(3, standard_manifest, STANDARD_POLYS, _standard_linear,
                  lambda ev, ch: 0)
TURBO = Flavor(4, turbo_manifest, TURBO_POLYS, _turbo_linear, _turbo_nonlinear)
UNROLLED_TURBO = Flavor(4, unrolled_turbo_manifest, TURBO_POLYS, _turbo_linear,
                        _turbo_nonlinear, linearised=False, hash=PEDERSEN_BLAKE2S)
FLAVORS = {("standard", "keccak256"): STANDARD, ("turbo", "keccak256"): TURBO,
           ("turbo", "pedersen_blake2s"): UNROLLED_TURBO}


def for_config(config: dict) -> Flavor:
    """The verifier a configuration's ``flavor`` and ``transcript`` name."""
    return FLAVORS[config["flavor"], config["transcript"]]


LABELS = {"q_m": "Q_M", "q_1": "Q_1", "q_2": "Q_2", "q_3": "Q_3", "q_4": "Q_4",
          "q_5": "Q_5", "q_c": "Q_C", "q_arith": "Q_ARITHMETIC_SELECTOR",
          "q_range": "Q_RANGE_SELECTOR", "q_ecc_1": "Q_FIXED_BASE_SELECTOR",
          "q_logic": "Q_LOGIC_SELECTOR"}


def public_inputs(proof: bytes, flavor: Flavor, num_public: int) -> list:
    """The public inputs a proof carries (the first round's element)."""
    t = Transcript(flavor.manifest(num_public), proof, flavor.hash)
    b = t.elements["public_inputs"]
    return [int.from_bytes(b[i:i + 32], "big") for i in range(0, len(b), 32)]


def verify(proof: bytes, flavor: Flavor, n: int, num_public: int,
           commitments: dict, tau: int) -> bool:
    """Whether ``proof`` verifies against the key (``commitments`` by label,
    a circuit of ``n`` rows and ``num_public`` public inputs) over the dev
    SRS of ``tau``.  Malformed bytes are rejected, never raised."""
    try:
        return _verify(proof, flavor, n, num_public, commitments, tau)
    except (ValueError, KeyError, IndexError, ZeroDivisionError):
        return False


def _verify(proof, flavor, n, num_public, commitments, tau) -> bool:
    width = flavor.width
    t = Transcript(flavor.manifest(num_public), proof, flavor.hash)
    t.elements["circuit_size"] = n.to_bytes(4, "big")
    t.elements["public_input_size"] = num_public.to_bytes(4, "big")
    for name in ("init", "eta", "beta", "alpha", "z"):
        t.apply_fiat_shamir(name)
    ch = {"alpha": t.challenge("alpha"), "beta": t.challenge("beta", 0),
          "gamma": t.challenge("beta", 1), "zeta": t.challenge("z")}
    zeta = ch["zeta"]
    root = bn254.domain_root(n)

    # get_lagrange_evaluations: Z*_H(zeta), L_1(zeta), L_{n-k}(zeta)
    num = (pow(zeta, n, R) - 1) % R
    den0, w = 1, pow(root, -1, R)
    for _ in range(ROOTS_CUT):
        den0 = den0 * (zeta - w) % R
        w = w * pow(root, -1, R) % R
    scaled = num * pow(n, -1, R) % R
    vanishing = num * pow(den0, -1, R) % R
    l_start = scaled * pow(zeta - 1, -1, R) % R
    l_end = scaled * pow(zeta * pow(root, ROOTS_CUT + 1, R) - 1, -1, R) % R

    ev = {}
    for p in flavor.polys:
        if flavor.opens(p):
            ev[p.label] = t.fr(p.label)
        if p.shifted:
            ev[p.label + "_omega"] = t.fr(p.label + "_omega")
    if flavor.linearised:
        ev["r"] = t.fr("r")

    pub = t.elements["public_inputs"]
    inputs = [int.from_bytes(pub[i:i + 32], "big") % R
              for i in range(0, len(pub), 32)]
    num_d, den_d, wr = 1, 1, 1
    for v in inputs:
        t1 = wr * ch["beta"] % R
        num_d = num_d * (t1 * COSET[0] + v + ch["gamma"]) % R
        den_d = den_d * (t1 * EXTERNAL_COSET + v + ch["gamma"]) % R
        wr = wr * root % R
    delta = num_d * pow(den_d, -1, R) % R

    t_eval = (_perm_t(ev, ch, l_start, l_end, delta, width, flavor.linearised)
              + flavor.nonlinear(ev, ch))
    if not flavor.linearised:
        t_eval += sum(s * ev[label] for label, s in flavor.linear(ev, ch).items())
    t_eval = t_eval * pow(vanishing, -1, R) % R
    t.elements["t"] = bn254.fr_bytes(t_eval)
    t.apply_fiat_shamir("nu")
    t.apply_fiat_shamir("separator")
    sep = t.challenge("separator")

    points, scalars = {}, {}
    batch_eval = 0
    for p in flavor.polys:
        if p.source == "witness":
            ok, pt = bn254.g1_from_bytes(t.elements[p.commitment])
            if not ok or pt is None:
                return False
        else:
            pt = commitments[p.commitment]
        points[p.commitment] = pt
        s = 0
        if p.shifted:
            c = t.nu(p.label + "_omega")
            s += sep * c
            batch_eval += sep * c * ev[p.label + "_omega"]
        if flavor.opens(p):
            c = t.nu(p.label)
            s += c
            batch_eval += c * ev[p.label]
        scalars[p.commitment] = s % R

    z_n = pow(zeta, n, R)
    nu_t = t.nu("t")
    for i in range(width):
        label = f"T_{i + 1}"
        ok, pt = bn254.g1_from_bytes(t.elements[label])
        if not ok or pt is None:
            return False
        points[label] = pt
        scalars[label] = nu_t * pow(z_n, i, R) % R
    batch_eval = (batch_eval + t_eval * nu_t) % R
    if flavor.linearised:
        nu_r = t.nu("r")
        batch_eval = (batch_eval + nu_r * ev["r"]) % R
        z_mult, sigma_mult = _perm_linear(ev, ch, l_start, width)
        scalars["Z"] = (scalars["Z"] + z_mult * nu_r) % R
        last = f"SIGMA_{width}"
        scalars[last] = (scalars[last] + sigma_mult * nu_r) % R
        for label, s in flavor.linear(ev, ch).items():
            scalars[LABELS[label]] = (scalars[LABELS[label]] + s * nu_r) % R
    points["BATCH_EVALUATION"] = bn254.G1
    scalars["BATCH_EVALUATION"] = -batch_eval % R

    ok_z, pi_z = bn254.g1_from_bytes(t.elements["PI_Z"])
    ok_w, pi_zw = bn254.g1_from_bytes(t.elements["PI_Z_OMEGA"])
    if not (ok_z and ok_w) or pi_z is None or pi_zw is None:
        return False
    points["PI_Z"], scalars["PI_Z"] = pi_z, zeta
    points["PI_Z_OMEGA"], scalars["PI_Z_OMEGA"] = pi_zw, zeta * root * sep % R
    p0 = bn254.msm([(scalars[k], v) for k, v in points.items() if v is not None])
    p1 = bn254.neg(bn254.add(bn254.mul(sep, pi_zw), pi_z))
    # e(P0, [1]_2) e(P1, [tau]_2) == 1  <=>  P0 + tau * P1 == O
    return bn254.add(p0, bn254.mul(tau, p1)) is None
