"""In-circuit PLONK verifier (recursive verification).

TPU-stack port of the reference's stdlib recursion verifier
(stdlib/recursion/verifier/verifier.hpp:190 `verify_proof` ->
recursion_output{P0, P1}): an UNROLLED inner proof is re-verified inside an
outer (Turbo) circuit — transcript replay via in-circuit Pedersen+Blake2s
(RecursiveTranscript, byte-exact vs the native PedersenBlake2s hasher),
all Fr algebra as native field gates, and the Kate batch-verification MSM
over bigfield/biggroup arithmetic.  The final pairing is DEFERRED: the two
pairing inputs P0, P1 surface as 16 public inputs of 68-bit limbs
(`add_proof_outputs_as_public_inputs`), which the native verifier folds via
its recursive-accumulator path (plonk/verifier.py:183-197; ref:
verifier.cpp:173-208).

Inner proofs may use the unrolled-standard, unrolled-turbo, or
unrolled-ultra (plookup) flavor (PedersenBlake2s 16-byte challenges, no
linearisation; the ultra path adds the lookup grand-product quotient
terms, _lookup_t_circuit).  Inner VKs enter
either as circuit constants (fixed-VK case, e.g. root_rollup) or as
witnesses via `RecursiveVK.from_witness` + `validate_key_is_in_set`
(ref: stdlib/recursion/verification_key/verification_key.hpp) — the
rollup case, where the circuit accepts any of a permitted key set.
Accumulators chain across multiple verify_proof calls (`previous_output`,
folded with separator challenge 1, ref: verifier.hpp:332-341), and proofs
whose own VK contains a recursive proof have their accumulator recovered
from public-input limbs and folded with separator^2 — matching this
framework's native verifier (plonk/verifier.py _verify_proof_checked).

The MSM is a joint double-and-add ladder over 254-bit scalar
decompositions with an offset generator for incomplete-addition safety —
the reference's WNAF batch_mul (biggroup_impl.hpp:1-394) is the planned
gate-count upgrade.

Port of aztec_tpu/stdlib/recursion_verifier.py, on the port's
composers: host Python, so the same proof and key record the same gates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..ff.bn254 import FR_MOD, FQ_MOD, FR_COSET_GENERATORS
from ..curves.pairing import g1_mul, g1_neg
from ..plonk.manifests import (
    standard_unrolled_manifest,
    turbo_unrolled_manifest,
    ultra_unrolled_manifest,
)
from ..transcript.manifest import Manifest
from .field_t import FieldT
from .bigfield import BigField, LIMB_BITS, LAST_LIMB_BITS, SHIFT_1, SHIFT_2
from .biggroup import BigGroup
from .byte_array import field_to_bytes
from .recursion_transcript import RecursiveTranscript, bytes_to_field

M = FR_MOD
Q = FQ_MOD

# offset generator for incomplete-addition safety in the MSM ladder: a
# fixed pseudo-random multiple of G, subtracted back out after the ladder
_OFFSET_SCALAR = int.from_bytes(b"aztec_tpu.recursion.offset.v1\x00\x00\x00",
                                "big") % M
OFFSET_GEN = g1_mul(_OFFSET_SCALAR, (1, 2))


@dataclasses.dataclass
class RecursionOutput:
    P0: BigGroup
    P1: BigGroup
    # the inner circuit's public inputs, now witnesses of the outer circuit
    # (ref: verifier.hpp:26-42 recursion_output.public_inputs)
    public_inputs: List[FieldT] = dataclasses.field(default_factory=list)


def bigfield_from_limb_fields(ctx, limbs: List[FieldT]) -> BigField:
    """4 little-endian 68-bit limb witnesses -> bigfield, range-constrained
    (the verifier.cpp:173-208 public-input accumulator recovery shape)."""
    out = []
    for i, l in enumerate(limbs):
        f = l.normalize()
        ctx.create_range_constraint(
            f.witness_index, LIMB_BITS if i < 3 else LAST_LIMB_BITS)
        out.append(f)
    prime = (out[0] + out[1] * SHIFT_1 + out[2] * SHIFT_2
             + out[3] * (SHIFT_1 * SHIFT_2 % M)).normalize()
    maxs = [SHIFT_1 - 1] * 3 + [(1 << LAST_LIMB_BITS) - 1]
    return BigField(ctx, out, prime, maxs)


class RecursiveVK:
    """In-circuit verification key (ref: stdlib/recursion/verification_key/
    verification_key.hpp).  Size parameters (n, num_public_inputs, domain
    root) stay circuit CONSTANTS — all keys in a permitted set must share
    them (circuits are padded to a common subgroup size); only the
    commitments become witnesses, so the aggregation circuit is
    key-independent."""

    def __init__(self, base, commitments: Dict[str, BigGroup]):
        self.base = base
        self.commitments = commitments
        self.n = base.n
        self.num_public_inputs = base.num_public_inputs
        self.domain_root = base.domain_root
        self.settings = base.settings
        self.contains_recursive_proof = base.contains_recursive_proof
        self.recursive_proof_public_input_indices = \
            base.recursive_proof_public_input_indices

    @staticmethod
    def commitment_labels(vk) -> List[str]:
        return [item.commitment_label
                for item in vk.settings.polynomial_manifest
                if item.source != "witness"]

    @staticmethod
    def from_witness(ctx, vk) -> "RecursiveVK":
        comms = {}
        for label in RecursiveVK.commitment_labels(vk):
            comms[label] = BigGroup.from_witness(ctx, vk.commitments[label])
        return RecursiveVK(vk, comms)

    def compress(self, ctx) -> FieldT:
        """Pedersen compression binding every commitment's limbs plus the
        (constant) size parameters (ref: verification_key.hpp compress)."""
        from . import pedersen_circuit as pc

        fields: List[FieldT] = [
            FieldT.constant(self.domain_root),
            FieldT.constant(self.n),
            FieldT.constant(self.num_public_inputs),
        ]
        for label in RecursiveVK.commitment_labels(self.base):
            g = self.commitments[label]
            for bf in (g.x, g.y):
                fields.extend(bf.limbs)
        return pc.compress_many(fields, 0)

    @staticmethod
    def compress_native(vk) -> int:
        from ..crypto.pedersen import compress_many as cm

        fields = [vk.domain_root, vk.n, vk.num_public_inputs]
        for label in RecursiveVK.commitment_labels(vk):
            x, y = vk.commitments[label]
            for coord in (x, y):
                for i in range(4):
                    fields.append((coord >> (LIMB_BITS * i))
                                  & (SHIFT_1 - 1))
        return cm(fields, 0)

    def validate_key_is_in_set(self, ctx, keys_in_set) -> None:
        """ref: verification_key.hpp validate_key_is_in_set."""
        compressed = self.compress(ctx)
        valid = None
        for key in keys_in_set:
            eq = (compressed
                  - FieldT.constant(RecursiveVK.compress_native(key))
                  ).is_zero()
            valid = eq if valid is None else (valid | eq)
        valid.to_field().assert_equal(1, "vk not in permitted set")


def bit_decompose(ctx, f: FieldT, bits: int = 254) -> List[FieldT]:
    """Witness the little-endian bits of f with bool gates and constrain
    their recomposition to f.  (Sum may wrap mod r: both decompositions of
    the same residue act identically on order-r points.)"""
    v = f.get_value()
    out = []
    for i in range(bits):
        b = FieldT.from_witness(ctx, (v >> i) & 1)
        ctx.create_bool_gate(b.witness_index)
        out.append(b)
    acc = FieldT.constant(0)
    for b in reversed(out):
        acc = acc * 2 + b
    acc.assert_equal(f, "bit_decompose recomposition")
    return out


def fq_from_bytes(ctx, be_bytes: List[FieldT]) -> BigField:
    """32 big-endian in-circuit bytes -> bigfield element, binding the
    4x68-bit limbs to the SAME byte witnesses the transcript hashes
    (ref: recursion transcript's convert_field_element).

    68 bits = 8.5 bytes: limb boundaries 68 and 204 split bytes 8 and 25
    (little-endian index) into nibbles; boundary 136 is byte-aligned."""
    le = list(reversed(be_bytes))
    assert len(le) == 32

    def split(byte_f: FieldT) -> Tuple[FieldT, FieldT]:
        bv = byte_f.get_value()
        lo = FieldT.from_witness(ctx, bv & 0xF)
        hi = FieldT.from_witness(ctx, bv >> 4)
        ctx.create_range_constraint(lo.witness_index, 4)
        ctx.create_range_constraint(hi.witness_index, 4)
        (lo + hi * 16).assert_equal(byte_f, "nibble split")
        return lo, hi

    lo8, hi8 = split(le[8])
    lo25, hi25 = split(le[25])

    def acc(parts: List[Tuple[FieldT, int]]) -> FieldT:
        a = FieldT.constant(0)
        for f, shift in parts:
            a = a + f * (1 << shift)
        return a.normalize()

    l0 = acc([(le[k], 8 * k) for k in range(8)] + [(lo8, 64)])
    l1 = acc([(hi8, 0)] + [(le[k], 4 + 8 * (k - 9)) for k in range(9, 17)])
    l2 = acc([(le[k], 8 * (k - 17)) for k in range(17, 25)] + [(lo25, 64)])
    l3 = acc([(hi25, 0)] + [(le[k], 4 + 8 * (k - 26)) for k in range(26, 32)])
    limbs = [l0, l1, l2, l3]
    prime = (l0 + l1 * (1 << LIMB_BITS) + l2 * ((1 << (2 * LIMB_BITS)) % M)
             + l3 * ((1 << (3 * LIMB_BITS)) % M)).normalize()
    # byte-level 8-bit constraints give limb bounds 2^68/2^68/2^68/2^52
    maxs = [(1 << 68) - 1, (1 << 68) - 1, (1 << 68) - 1, (1 << 52) - 1]
    return BigField(ctx, limbs, prime, maxs)


def g1_from_proof_bytes(ctx, el_bytes: List[FieldT]) -> BigGroup:
    """64 proof bytes (y BE || x BE, serialize.g1_to_bytes) -> on-curve
    biggroup point bound to the hashed byte witnesses."""
    y = fq_from_bytes(ctx, el_bytes[0:32])
    x = fq_from_bytes(ctx, el_bytes[32:64])
    g = BigGroup(x, y)
    g.validate_on_curve(ctx)
    return g


def batch_mul(ctx, points: List[BigGroup], scalars: List[FieldT],
              bits: int = 254) -> BigGroup:
    """sum_i scalar_i * P_i via a joint double-and-add ladder.

    Incomplete affine adds are made safe by seeding the accumulator with
    OFFSET_GEN and subtracting 2^bits * OFFSET_GEN at the end (x-coordinate
    collisions with the pseudo-random offset orbit are negligible; an
    adversarial witness that forces one simply fails the slope constraint).
    """
    bitlists = [bit_decompose(ctx, s, bits) for s in scalars]
    acc = BigGroup.from_constant(ctx, OFFSET_GEN)
    for k in reversed(range(bits)):
        acc = acc.dbl(ctx)
        for P, bl in zip(points, bitlists):
            added = acc.add(P, ctx)
            acc = BigGroup(
                BigField.select(bl[k], added.x, acc.x),
                BigField.select(bl[k], added.y, acc.y),
            )
    shift = g1_mul(pow(2, bits, M) * _OFFSET_SCALAR % M, (1, 2))
    return acc.add(BigGroup.from_constant(ctx, g1_neg(shift)), ctx)


def _lagrange_evals(ctx, zeta: FieldT, n: int, root: int, k_cut: int = 4):
    """In-circuit (Z*_H(z), L_1(z), L_end(z)) — mirrors
    poly/arithmetic.get_lagrange_evaluations."""
    zp = zeta
    for _ in range(n.bit_length() - 1):
        zp = (zp * zp).normalize()
    numerator = zp - 1

    root_inv = pow(root, -1, M)
    den0 = FieldT.constant(1)
    w = root_inv
    for _ in range(k_cut):
        den0 = den0 * (zeta - FieldT.constant(w))
        w = w * root_inv % M
    den1 = zeta - 1
    l_end_root = pow(root, k_cut + 1, M)
    den2 = zeta * l_end_root - 1

    n_inv = pow(n, -1, M)
    vanishing = numerator * den0.invert()
    scaled = numerator * n_inv
    l_start = scaled * den1.invert()
    l_end = scaled * den2.invert()
    return vanishing, l_start, l_end, zp


def _public_input_delta(ctx, inputs: List[FieldT], beta: FieldT,
                        gamma: FieldT, root: int) -> FieldT:
    k1 = FR_COSET_GENERATORS[0]
    k_ext = FR_COSET_GENERATORS[7]
    num = FieldT.constant(1)
    den = FieldT.constant(1)
    wr = 1
    for w in inputs:
        t0 = w + gamma
        t1 = beta * wr
        num = num * (t1 * k1 + t0)
        den = den * (t1 * k_ext + t0)
        wr = wr * root % M
    return num * den.invert()


def _perm_t_unrolled(ev: Dict[str, FieldT], alpha, beta, gamma, zeta,
                     l_start, l_end, delta, width: int = 3) -> FieldT:
    """Unrolled permutation quotient contribution (flavors._perm_t_contribution
    with use_linearisation=False), in gates."""
    sigma_contrib = FieldT.constant(1)
    for i in range(width - 1):
        sigma_contrib = sigma_contrib * (
            ev[f"sigma_{i+1}"] * beta + ev[f"w_{i+1}"] + gamma
        )
    sigma_contrib = (
        sigma_contrib * (ev[f"w_{width}"] + gamma) * ev["z_omega"] * alpha
    )
    a2 = alpha * alpha
    a3 = a2 * alpha
    t = (ev["z_omega"] - delta) * l_end * a2 - l_start * a3 - sigma_contrib

    # linear z / sigma_last terms (flavors._perm_linear_terms)
    z_beta = zeta * beta
    z_contrib = FieldT.constant(1)
    for k in range(width):
        kk = 1 if k == 0 else FR_COSET_GENERATORS[k - 1]
        z_contrib = z_contrib * (ev[f"w_{k+1}"] + z_beta * kk + gamma)
    z_mult = z_contrib * alpha + l_start * a3
    sig2 = FieldT.constant(1)
    for k in range(width - 1):
        sig2 = sig2 * (ev[f"sigma_{k+1}"] * beta + ev[f"w_{k+1}"] + gamma)
    sigma_mult = sig2 * ev["z_omega"] * alpha * beta

    t = t + sigma_mult * (FieldT.constant(0) - FieldT.constant(1)) * ev[f"sigma_{width}"]
    t = t + z_mult * ev["z"]
    return t


def _arith_scalars(ev: Dict[str, FieldT], alpha: FieldT) -> Dict[str, FieldT]:
    a2 = alpha * alpha
    alpha4 = (a2 * a2).normalize()
    a, b, c = ev["w_1"], ev["w_2"], ev["w_3"]
    return {
        "q_m": a * b * alpha4,
        "q_1": a * alpha4,
        "q_2": b * alpha4,
        "q_3": c * alpha4,
        "q_c": alpha4,
    }


def _alpha_powers(alpha: FieldT, upto: int) -> List[FieldT]:
    ap = [FieldT.constant(1), alpha]
    for _ in range(upto - 1):
        ap.append((ap[-1] * alpha).normalize())
    return ap


def _turbo_selector_scalars(ev: Dict[str, FieldT],
                            ap: List[FieldT]) -> Dict[str, FieldT]:
    """In-circuit transliteration of plonk.flavors.TurboFlavor.
    selector_linear_scalars (ref: turbo_*_widget.hpp linear terms)."""
    a, b, c, d = ev["w_1"], ev["w_2"], ev["w_3"], ev["w_4"]
    aw, bw, cw, dw = (ev["w_1_omega"], ev["w_2_omega"], ev["w_3_omega"],
                      ev["w_4_omega"])
    q_arith, q_ecc, q_c_ev = ev["q_arith"], ev["q_ecc_1"], ev["q_c"]

    out: Dict[str, FieldT] = {}
    qa4 = q_arith * ap[4]
    out["q_m"] = qa4 * a * b
    out["q_1"] = qa4 * a
    out["q_2"] = qa4 * b
    out["q_3"] = qa4 * c
    out["q_4"] = qa4 * d
    out["q_5"] = (d * d - d) * (d - 2) * q_arith * ap[5]
    out["q_c"] = qa4

    # fixed-base ECC
    delta = dw - d * 4
    out["q_1"] = out["q_1"] + delta * delta * q_ecc * ap[7]
    out["q_2"] = out["q_2"] + q_ecc * ap[7]
    q3m = (aw - a) * delta * cw * ap[9] * q_ecc
    t1 = delta * cw * b * ap[8]
    q3m = q3m + t1 * 2 * q_ecc
    out["q_3"] = out["q_3"] + q3m
    out["q_4"] = out["q_4"] + c * q_ecc * q_c_ev * ap[11]
    out["q_5"] = out["q_5"] + (FieldT.constant(1) - d) * q_ecc * q_c_ev * ap[11]
    out["q_m"] = out["q_m"] + c * q_ecc * q_c_ev * ap[12]

    # range
    def quad(x):
        return x * (x - 1) * (x - 2) * (x - 3)

    d1 = c - d * 4
    d2 = b - c * 4
    d3 = a - b * 4
    d4 = dw - a * 4
    out["q_range"] = (quad(d1) * ap[13] + quad(d2) * ap[14]
                      + quad(d3) * ap[15] + quad(d4) * ap[16])

    # logic
    qa = aw - a * 4
    qb = bw - b * 4
    ds = qa + qb
    dss = qa * qa + qb * qb
    al = ap[1]
    identity = (ds * ds - dss - c * 2) * al
    t2a = qa * qa - qa
    identity = (identity + (t2a - qa * 4 + 6) * t2a) * al
    t3b = qb * qb - qb
    identity = (identity + (t3b - qb * 4 + 6) * t3b) * al
    w_term = (c * 4 - ds * 18 + 81) * c
    w_term = (w_term + dss * 18 - ds * 81 + 83) * c
    qc_quad = dw - d * 4
    t3 = (qc_quad * 9 - ds * 3) * q_c_ev
    t2 = qc_quad * 3 + ds * 3 - w_term * 2 + t3
    out["q_logic"] = (identity + t2) * ap[17]
    return {k: v.normalize() for k, v in out.items()}


def _turbo_nonlinear_t(ev: Dict[str, FieldT], ap: List[FieldT]) -> FieldT:
    """In-circuit plonk.flavors.TurboFlavor._nonlinear_t_terms
    (ref: turbo_arithmetic_widget.hpp:66-123,
    turbo_fixed_base_widget.hpp:85-158)."""
    a, b, c, d = ev["w_1"], ev["w_2"], ev["w_3"], ev["w_4"]
    aw, bw, cw, dw = (ev["w_1_omega"], ev["w_2_omega"], ev["w_3_omega"],
                      ev["w_4_omega"])
    q_arith, q_ecc, q_c_ev = ev["q_arith"], ev["q_ecc_1"], ev["q_c"]

    dlt = c - d * 4
    term = dlt * (dlt * 9 - dlt * dlt * 2 - 7)
    t = (q_arith * q_arith - q_arith) * term * ap[4]

    de = dw - d * 4
    acc_id = (de + 1) * (de + 3) * (de - 1) * (de - 3) * ap[6]
    x_alpha_id = -(cw * ap[7])
    diff = cw - a
    t0 = (aw + a + cw) * diff * diff
    t1 = -(cw * cw * cw + b * b - 17)
    t2 = de * 2 * b * q_ecc
    x_acc_id = (t0 + t1 + t2) * ap[8]
    t0 = (bw + b) * (cw - a)
    t1 = (a - aw) * (b - q_ecc * de)
    y_acc_id = (t0 + t1) * ap[9]
    t0 = d - 1
    t1 = t0 - c
    acc_init_id = t0 * t1 * ap[10]
    x_init_id = -(a * c * ap[11])
    y_init_id = ((FieldT.constant(1) - d) * q_c_ev - b * c) * ap[12]
    gate_id = (acc_init_id + x_init_id + y_init_id) * q_c_ev
    gate_id = gate_id + acc_id + x_alpha_id + x_acc_id + y_acc_id
    return (t + gate_id * q_ecc).normalize()


def _lookup_t_circuit(ev: Dict[str, FieldT], eta: FieldT, beta: FieldT,
                      gamma: FieldT, ap: List[FieldT], l_start: FieldT,
                      l_end: FieldT) -> FieldT:
    """In-circuit plookup quotient contribution — transliteration of
    plonk.flavors.UltraFlavor._lookup_t_terms (docs/ULTRA_DESIGN.md;
    ref design: polynomial_manifest.hpp:23-46 plookup slots)."""
    F = ev["q_lookup"] * (
        ev["w_1"] + eta * (ev["w_2"] + eta * (ev["w_3"]
                                              + eta * ev["q_index"]))
    )
    T = (ev["table_1"] + eta * (ev["table_2"] + eta * (ev["table_3"]
         + eta * ev["table_4"])))
    Tw = (ev["table_1_omega"] + eta * (ev["table_2_omega"]
          + eta * (ev["table_3_omega"] + eta * ev["table_4_omega"])))
    one_p_beta = (beta + 1).normalize()
    gamma_pb = (gamma * one_p_beta).normalize()
    num = (one_p_beta * (F + gamma) * (T + Tw * beta + gamma_pb)
           * ev["z_lookup"])
    den = ((ev["s_1"] + ev["s_2"] * beta + gamma_pb)
           * (ev["s_2"] + ev["s_1_omega"] * beta + gamma_pb)
           * ev["z_lookup_omega"])
    t = (num - den) * ap[21]
    t = t + (ev["z_lookup"] - 1) * l_start * ap[22]
    t = t + (ev["z_lookup_omega"] - 1) * l_end * ap[23]
    return t.normalize()


def verify_proof_circuit(ctx, proof: bytes, vk,
                         manifest: Manifest | None = None,
                         previous_output: Optional[RecursionOutput] = None,
                         ) -> RecursionOutput:
    """Verify an unrolled (standard or turbo) inner proof inside the outer
    circuit (ref: verifier.hpp:190 verify_proof).

    ctx: outer TurboComposer; proof: inner proof bytes; vk: inner
    VerificationKey (circuit constants) or RecursiveVK (witness
    commitments).  previous_output chains accumulators across calls.
    Returns the deferred pairing accumulators + inner public inputs."""
    n = vk.n
    num_pub = vk.num_public_inputs
    root = vk.domain_root
    flavor = vk.settings.name
    is_ultra = flavor in ("ultra", "unrolled_ultra")
    width = 4 if is_ultra or flavor in ("unrolled_turbo", "turbo") else 3
    if manifest is None:
        if is_ultra:
            manifest = ultra_unrolled_manifest(num_pub)
        elif width == 4:
            manifest = turbo_unrolled_manifest(num_pub)
        else:
            manifest = standard_unrolled_manifest(num_pub)

    rt = RecursiveTranscript(ctx, manifest)
    rt.add_element_native("circuit_size", n.to_bytes(4, "big"),
                          as_witness=False)
    rt.add_element_native("public_input_size", num_pub.to_bytes(4, "big"),
                          as_witness=False)
    off = 0
    for r in range(manifest.get_num_rounds()):
        for el in manifest.get_round_manifest(r).elements:
            if not el.derived_by_verifier:
                rt.add_element_native(el.name, proof[off:off + el.num_bytes])
                off += el.num_bytes
    assert off == len(proof), "proof length mismatch"

    for name in ("init", "eta", "beta", "alpha", "z"):
        rt.apply_fiat_shamir(name)

    alpha = rt.get_challenge("alpha")
    beta = rt.get_challenge("beta", 0)
    gamma = rt.get_challenge("beta", 1)
    zeta = rt.get_challenge("z")

    vanishing, l_start, l_end, z_pow_n = _lagrange_evals(ctx, zeta, n, root)

    s = vk.settings
    ev: Dict[str, FieldT] = {}
    for info in s.polynomial_manifest:
        ev[info.polynomial_label] = bytes_to_field(
            rt.elements[info.polynomial_label])
        if info.requires_shifted_evaluation:
            lab = info.polynomial_label + "_omega"
            ev[lab] = bytes_to_field(rt.elements[lab])

    pub_bytes = rt.elements["public_inputs"]
    public_inputs = [
        bytes_to_field(pub_bytes[i * 32:(i + 1) * 32])
        for i in range(num_pub)
    ]
    delta = _public_input_delta(ctx, public_inputs, beta, gamma, root)

    # quotient evaluation reconstruction (no linearisation)
    t_eval = _perm_t_unrolled(ev, alpha, beta, gamma, zeta, l_start, l_end,
                              delta, width=width)
    if width == 4:
        ap = _alpha_powers(alpha, 23 if is_ultra else 17)
        t_eval = t_eval + _turbo_nonlinear_t(ev, ap)
        for sel, scalar in _turbo_selector_scalars(ev, ap).items():
            t_eval = t_eval + scalar * ev[sel]
        if is_ultra:
            eta = rt.get_challenge("eta")
            t_eval = t_eval + _lookup_t_circuit(ev, eta, beta, gamma, ap,
                                                l_start, l_end)
    else:
        for sel, scalar in _arith_scalars(ev, alpha).items():
            t_eval = t_eval + scalar * ev[sel]
    t_eval = (t_eval * vanishing.invert()).normalize()

    rt.add_element_bytes("t", field_to_bytes(t_eval, 32))
    rt.apply_fiat_shamir("nu")
    rt.apply_fiat_shamir("separator")
    separator = rt.get_challenge("separator")

    cmap = manifest.challenge_map()

    def nu(label: str) -> FieldT:
        key = cmap[label]
        if key == -1:
            return FieldT.constant(1)
        return rt.get_challenge("nu", key)

    # Kate batch verification accumulation (manifest-driven, matching
    # plonk/verifier.py)
    points: List[BigGroup] = []
    scalars: List[FieldT] = []
    batch_eval = FieldT.constant(0)

    for item in s.polynomial_manifest:
        label = item.commitment_label
        plabel = item.polynomial_label
        if item.source == "witness":
            pt = g1_from_proof_bytes(ctx, rt.elements[label])
        elif isinstance(vk, RecursiveVK):
            pt = vk.commitments[label]
        else:
            el = vk.commitments[label]
            pt = BigGroup.from_constant(ctx, el) if el is not None else None
        scalar = FieldT.constant(0)
        if item.requires_shifted_evaluation:
            challenge = nu(plabel + "_omega")
            scalar = scalar + separator * challenge
            batch_eval = batch_eval + separator * challenge * ev[plabel + "_omega"]
        challenge = nu(plabel)
        scalar = scalar + challenge
        batch_eval = batch_eval + challenge * ev[plabel]
        if pt is not None:
            points.append(pt)
            scalars.append(scalar.normalize())

    quotient_challenge = nu("t")
    z_power = FieldT.constant(1)
    for i in range(width):
        pt = g1_from_proof_bytes(ctx, rt.elements[f"T_{i+1}"])
        points.append(pt)
        scalars.append((quotient_challenge * z_power).normalize())
        z_power = (z_power * z_pow_n).normalize()

    batch_eval = batch_eval + t_eval * quotient_challenge
    points.append(BigGroup.from_constant(ctx, (1, 2)))
    scalars.append((FieldT.constant(0) - batch_eval).normalize())

    PI_Z = g1_from_proof_bytes(ctx, rt.elements["PI_Z"])
    PI_Z_OMEGA = g1_from_proof_bytes(ctx, rt.elements["PI_Z_OMEGA"])
    points.append(PI_Z)
    scalars.append(zeta.normalize())
    points.append(PI_Z_OMEGA)
    scalars.append((zeta * root * separator).normalize())

    zero = BigField.from_constant(ctx, 0)

    def neg(g: BigGroup) -> BigGroup:
        return BigGroup(g.x, (zero - g.y).reduce())

    # rhs (P1 before negation): separator * PI_Z_OMEGA (+ folds) + PI_Z
    rhs_points: List[BigGroup] = [PI_Z_OMEGA]
    rhs_scalars: List[FieldT] = [separator.normalize()]

    # chain a previous verify_proof's accumulators (ref: verifier.hpp:332-341)
    if previous_output is not None:
        sep1 = rt.get_challenge("separator", 1)
        points.append(previous_output.P0)
        scalars.append(sep1.normalize())
        rhs_points.append(neg(previous_output.P1))
        rhs_scalars.append(sep1.normalize())

    # the inner proof itself carries a recursive accumulator: recover it
    # from its public-input limbs and fold with separator^2, matching the
    # native verifier (plonk/verifier.py; ref: verifier.cpp:173-208)
    if vk.contains_recursive_proof:
        idx = vk.recursive_proof_public_input_indices
        assert idx is not None and len(idx) == 16
        u2 = (separator * separator).normalize()

        def recover(i0: int) -> BigField:
            return bigfield_from_limb_fields(
                ctx, [public_inputs[idx[i0 + k]] for k in range(4)])

        rec_p0 = BigGroup(recover(0), recover(4))
        rec_p1 = BigGroup(recover(8), recover(12))
        rec_p0.validate_on_curve(ctx)
        rec_p1.validate_on_curve(ctx)
        points.append(rec_p0)
        scalars.append(u2)
        rhs_points.append(neg(rec_p1))
        rhs_scalars.append(u2)

    P0 = batch_mul(ctx, points, scalars)
    P1pos = batch_mul(ctx, rhs_points, rhs_scalars)
    P1pos = P1pos.add(PI_Z, ctx)
    P1 = neg(P1pos)
    return RecursionOutput(P0=P0, P1=P1, public_inputs=public_inputs)


def add_proof_outputs_as_public_inputs(ctx, out: RecursionOutput) -> List[int]:
    """Expose P0/P1 as 16 public inputs of 68-bit limbs, in the order the
    native verifier's accumulator recovery expects (plonk/verifier.py
    recover(): P0.x limbs, P0.y limbs, P1.x limbs, P1.y limbs; ref:
    verifier.cpp:173-208 + constants.hpp:8).  Returns the POSITIONS within
    the public-input list (what verification_key.recursive_proof_public_
    input_indices stores) and registers them on the composer."""
    positions = []
    for bf in (out.P0.x, out.P0.y, out.P1.x, out.P1.y):
        red = bf if bf.max_value() < (1 << 254) else bf.reduce()
        for l in red.limbs:
            f = l.normalize() if not l.is_constant() else l
            if f.is_constant():
                f = FieldT.from_witness(ctx, f.get_value())
            f = f.set_public()
            positions.append(len(ctx.public_inputs) - 1)
    if hasattr(ctx, "add_recursive_proof"):
        ctx.add_recursive_proof(positions)
    return positions
