"""PLONK prover: the 6-round protocol with device-resident polynomials.

Port of aztec_tpu/plonk/prover.py: scalar Fiat-Shamir on the host, bulk
math on the proving key's device between transcript barriers, queued on
the work queue and drained at each round end.
"""

from __future__ import annotations

import secrets
from typing import Dict, List

import torch

from ..ff import FR, limb
from ..ff import field_kernels as fk
from ..ff.bn254 import FR_MOD
from ..poly import fft_ops as pfft
from ..poly.arithmetic import (
    get_lagrange_evaluations,
    compute_public_input_delta,
    kate_divide,
    to_ints,
    _tree_sum,
)
from ..poly.domain import powers_table
from ..transcript.transcript import Transcript
from ..utils import spans
from . import kernels
from .proving_key import ProvingKey, fr_mont
from .serialize import fr_to_bytes, g1_to_bytes, u32_to_bytes
from .work_queue import WorkQueue, WorkItem, WorkType

M = FR_MOD


def default_rng():
    return lambda: secrets.randbelow(M)


class Prover:
    def __init__(self, key: ProvingKey, wires: Dict[str, torch.Tensor],
                 public_values: List[int], flavor, rng=None, aux=None):
        self.key = key
        self.device = key.device
        self.flavor = flavor
        self.aux = aux or {}  # flavor-specific data (e.g. plookup witness)
        self.settings = flavor.settings
        self.width = flavor.width
        self.wires_lagrange = wires       # name -> (L, n) Montgomery
        self.public_values = public_values
        self.rng = rng or default_rng()
        self.n = key.n
        self.transcript = Transcript(
            self.settings.create_manifest(len(public_values)),
            hasher=self.settings.hash_type,
            num_challenge_bytes=self.settings.num_challenge_bytes,
        )
        self.wire_mono: Dict[str, torch.Tensor] = {}
        self.wire_fft: Dict[str, torch.Tensor] = {}
        # external-executor seam (ref: work_queue.hpp): bulk math between
        # Fiat-Shamir barriers is queued, then drained at each round end by
        # self.executor (None = the key's device alone)
        self.queue = WorkQueue(key)
        self.executor = None

    # -- helpers ---------------------------------------------------------------
    def _commit(self, mono, tag: str):
        self.queue.add_to_queue(WorkItem(
            WorkType.MSM, tag,
            get_data=lambda mono=mono: limb.from_mont(mono, FR),
            put_result=lambda pt, tag=tag: self.transcript.add_element(
                tag, g1_to_bytes(pt)),
            size=int(mono.shape[1]),
        ))

    def _challenge(self, name: str, idx: int = 0) -> int:
        return self.transcript.get_challenge_fr(name, idx)

    def _fr(self, v: int):
        return fr_mont(v, self.device)

    def _blind(self, lagrange, count: int, offset: int):
        out = lagrange.clone()
        out[:, offset:offset + count] = torch.stack(
            [self._fr(self.rng()) for _ in range(count)], dim=1)
        return out

    def _poly(self, label: str):
        """polynomial label -> monomial-form device array."""
        if label in self.wire_mono:
            return self.wire_mono[label]
        if label.startswith("sigma"):
            return self.key.sigmas[label].monomial
        return self.key.selectors[label].monomial

    def _eval_many(self, polys, zpows):
        """Evaluations of (16, n) polynomials against a powers-of-z table,
        one multiply and one reduction tree per polynomial."""
        cols = [_tree_sum(fk.mont_mul(p, zpows, FR), p.shape[-1])
                for p in polys]
        return to_ints(torch.stack(cols, dim=-1))

    # -- rounds ------------------------------------------------------------------
    def execute_preamble_round(self):
        """ref: prover.cpp:137-195."""
        t = self.transcript
        t.add_element("circuit_size", u32_to_bytes(self.n))
        t.add_element("public_input_size", u32_to_bytes(len(self.public_values)))
        t.apply_fiat_shamir("init")
        k = self.settings.num_roots_cut_out_of_vanishing_polynomial
        for i in range(1, self.width + 1):
            tag = f"w_{i}"
            lag = self._blind(self.wires_lagrange[tag], 3, self.n - k)
            self.wires_lagrange[tag] = lag
            self.queue.add_to_queue(WorkItem(
                WorkType.IFFT, tag,
                get_data=lambda tag=tag: self.wires_lagrange[tag],
                put_result=lambda mono, tag=tag: self.wire_mono.__setitem__(
                    tag, mono),
            ))

    def execute_first_round(self):
        """ref: prover.cpp:197-228 — wire commitments + public inputs."""
        for i in range(1, self.width + 1):
            self._commit(self.wire_mono[f"w_{i}"], f"W_{i}")
        self.transcript.add_element(
            "public_inputs", b"".join(fr_to_bytes(v) for v in self.public_values)
        )

    def execute_second_round(self):
        self.transcript.apply_fiat_shamir("eta")
        if hasattr(self.flavor, "after_eta"):
            # plookup: sorted-list construction + S commitments (eta-bound)
            self.flavor.after_eta(self)

    def execute_third_round(self):
        """ref: prover.cpp:239-273 + permutation_widget_impl.hpp:47-314."""
        t = self.transcript
        t.apply_fiat_shamir("beta")
        beta = self._fr(self._challenge("beta", 0))[:, None]
        gamma = self._fr(self._challenge("beta", 1))[:, None]

        wires = [self.wires_lagrange[f"w_{i}"]
                 for i in range(1, self.width + 1)]
        sigmas = [self.key.sigmas[f"sigma_{i}"].lagrange
                  for i in range(1, self.width + 1)]
        randoms = torch.stack([self._fr(self.rng()) for _ in range(3)], dim=1)
        z_lag = kernels.grand_product(
            wires, sigmas, beta, gamma, self.key.omega_pows, randoms, self.n
        )
        del wires
        extra = getattr(self.flavor, "third_round_extra", None)
        if extra is None:
            # no later round reads the wires' lagrange forms
            self.wires_lagrange = {}
        z_mono = pfft.ifft(z_lag, self.key.small_domain)
        self.wire_mono["z"] = z_mono
        self._commit(z_mono, "Z")
        if extra is not None:
            # the lookup product reads w_1..w_3, s_1 and s_2 in lagrange form
            extra(self)
            self.wires_lagrange = {}

        if self.key.quarters:
            # the quotient evaluates the monomials by coset quarters
            return
        for tag in [f"w_{i}" for i in range(1, self.width + 1)] + ["z"]:
            self.queue.add_to_queue(WorkItem(
                WorkType.FFT, tag,
                get_data=lambda tag=tag: self.wire_mono[tag],
                put_result=lambda f, tag=tag: self.wire_fft.__setitem__(
                    tag, f),
            ))

    def execute_fourth_round(self):
        """ref: prover.cpp:275-363 — fused quotient + split commitments."""
        t = self.transcript
        t.apply_fiat_shamir("alpha")
        alpha = self._challenge("alpha")
        beta_i = self._challenge("beta", 0)
        gamma_i = self._challenge("beta", 1)
        delta = compute_public_input_delta(
            self.public_values, beta_i, gamma_i, self.key.small_domain.root
        )
        num_alphas = getattr(self.flavor, "num_alphas", 21)
        ch_mont = {
            "alpha": self._fr(alpha)[:, None],
            "alphas": torch.stack(
                [self._fr(pow(alpha, k, M)) for k in range(1, num_alphas + 1)],
                dim=1,
            ),
            "beta": self._fr(beta_i)[:, None],
            "gamma": self._fr(gamma_i)[:, None],
            "delta": self._fr(delta)[:, None],
        }
        if getattr(self.flavor, "uses_lookups", False):
            ch_mont["eta"] = self._fr(self._challenge("eta"))[:, None]
        quotient_evals = self.flavor.quotient_evals(
            self.key, self.wire_mono, self.wire_fft, ch_mont, self.n
        )
        tq = pfft.coset_ifft(quotient_evals, self.key.large_domain)
        del quotient_evals
        self.quotient_mono = tq
        n = self.n
        for i in range(self.width - 1):
            self._commit(tq[:, i * n : (i + 1) * n], f"T_{i+1}")
        last = self.width - 1
        extra = 1 if self.width == 3 else 0  # standard t_high has n+1 coeffs
        self._commit(tq[:, last * n : (last + 1) * n + extra], f"T_{self.width}")
        # the 4n coset evaluations are dead after the quotient: rounds
        # 5/6 work on monomials.  Freeing them (~34 MB x width+lookup
        # polys) keeps the ultra flavor inside HBM at 2^17 (OOM, r5).
        self.wire_fft.clear()

    def execute_fifth_round(self):
        """ref: prover.cpp:365-378, 388-417 — evaluations + linearisation.

        Which polynomials get (shifted) evaluations is manifest-driven
        (kate_commitment_scheme.cpp:373-436)."""
        t = self.transcript
        t.apply_fiat_shamir("z")
        zeta = self._challenge("z")
        n = self.n
        root = self.key.small_domain.root
        zeta_omega = zeta * root % M
        s = self.settings

        at_zeta = []
        at_zeta_omega = []
        for info in s.polynomial_manifest:
            if not info.is_linearised or not s.use_linearisation:
                at_zeta.append(info.polynomial_label)
            if info.requires_shifted_evaluation:
                at_zeta_omega.append(info.polynomial_label)

        zp_n = powers_table(self._fr(zeta), n)
        evals = self._eval_many([self._poly(p) for p in at_zeta], zp_n)
        for name, v in zip(at_zeta, evals):
            t.add_element(name, fr_to_bytes(v))

        zpw_n = powers_table(self._fr(zeta_omega), n)
        sevals = self._eval_many([self._poly(p) for p in at_zeta_omega],
                                 zpw_n)
        for name, v in zip(at_zeta_omega, sevals):
            t.add_element(name + "_omega", fr_to_bytes(v))

        # t(zeta) = sum_i zeta^(i n) t_i(zeta) over the quotient's four
        # pieces of n coefficients: the powers of zeta up to n suffice
        zeta_n = pow(zeta, n, M)
        t_eval = sum(v * pow(zeta_n, i, M) for i, v in enumerate(
            self._eval_many([self.quotient_mono[:, i * n:(i + 1) * n]
                             for i in range(4)], zp_n))) % M

        # linearisation polynomial r(X) (linearised settings only)
        if s.use_linearisation:
            ev = {name: t.get_element_fr(name) for name in at_zeta}
            for name in at_zeta_omega:
                ev[name + "_omega"] = t.get_element_fr(name + "_omega")
            ch = {
                "alpha": self._challenge("alpha"),
                "beta": self._challenge("beta", 0),
                "gamma": self._challenge("beta", 1),
                "zeta": zeta,
            }
            _, l_start, _ = get_lagrange_evaluations(zeta, n, root)
            z_mult, sigma_mult = self.flavor.perm_linear_terms(ev, ch, l_start)
            sel_scalars = self.flavor.selector_linear_scalars(ev, ch)

            names = ["z", f"sigma_{self.width}"] + list(sel_scalars)
            scalars = [z_mult, sigma_mult] + [
                sel_scalars[k] for k in sel_scalars
            ]
            lin_stack = [self._poly(p) for p in names]
            lin_scalars = torch.stack([self._fr(v) for v in scalars], dim=1)
            self.linear_mono = kernels.linear_combination(lin_stack, lin_scalars)
            r_eval = self._eval_many([self.linear_mono], zp_n)[0]
            t.add_element("r", fr_to_bytes(r_eval))
        t.add_element("t", fr_to_bytes(t_eval))
        self._zeta = zeta

    def execute_sixth_round(self):
        """ref: prover.cpp:380-386 + kate_commitment_scheme.cpp:133-236."""
        t = self.transcript
        t.apply_fiat_shamir("nu")
        zeta = self._zeta
        n = self.n
        s = self.settings
        root = self.key.small_domain.root
        zeta_omega = zeta * root % M
        nu = lambda label: t.get_challenge_fr_from_map("nu", label)

        z_pow_n = pow(zeta, n, M)
        tq = self.quotient_mono

        # opening polynomial: t_low + zeta^{in} t_i + sum nu_label * poly
        open_polys = [tq[:, :n]]
        open_scalars = [1]
        z_power = z_pow_n
        for i in range(1, self.width):
            open_polys.append(tq[:, i * n : (i + 1) * n])
            open_scalars.append(z_power)
            z_power = z_power * z_pow_n % M
        shifted_polys = []
        shifted_scalars = []
        for info in s.polynomial_manifest:
            if not info.is_linearised or not s.use_linearisation:
                open_polys.append(self._poly(info.polynomial_label))
                open_scalars.append(nu(info.polynomial_label))
            if info.requires_shifted_evaluation:
                shifted_polys.append(self._poly(info.polynomial_label))
                shifted_scalars.append(nu(info.polynomial_label + "_omega"))
        if s.use_linearisation:
            open_polys.append(self.linear_mono)
            open_scalars.append(nu("r"))

        opening = kernels.linear_combination(
            open_polys,
            torch.stack([self._fr(v) for v in open_scalars], dim=1),
        )
        # standard plonk: the (n+1)-th coefficient zeta^{2n} * t[3n]
        # (ref: kate_commitment_scheme.cpp:196-208)
        extra = 0
        if self.width == 3:
            t_3n = to_ints(tq[:, 3 * n: 3 * n + 1])[0]
            extra = pow(zeta, 2 * n, M) * t_3n % M

        zp_n = powers_table(self._fr(zeta), n)
        f_zeta = self._eval_many([opening], zp_n)[0]
        f_zeta = (f_zeta + extra * z_pow_n) % M
        opening = opening.clone()
        opening[:, :1] = fk.sub_mod(opening[:, :1], self._fr(f_zeta)[:, None],
                                    FR)
        w_zeta = kate_divide(opening, zeta)
        self._commit(w_zeta, "PI_Z")

        shifted = kernels.linear_combination(
            shifted_polys,
            torch.stack([self._fr(v) for v in shifted_scalars], dim=1),
        )
        zpw_n = powers_table(self._fr(zeta_omega), n)
        f_zw = self._eval_many([shifted], zpw_n)[0]
        shifted = shifted.clone()
        shifted[:, :1] = fk.sub_mod(shifted[:, :1], self._fr(f_zw)[:, None],
                                    FR)
        w_zeta_omega = kate_divide(shifted, zeta_omega)
        self._commit(w_zeta_omega, "PI_Z_OMEGA")

    def construct_proof(self) -> bytes:
        with spans.span("prove"):
            for rnd in (
                self.execute_preamble_round,
                self.execute_first_round,
                self.execute_second_round,
                self.execute_third_round,
                self.execute_fourth_round,
                self.execute_fifth_round,
                self.execute_sixth_round,
            ):
                rnd()
                # drain the work queue at the Fiat-Shamir barrier; an external
                # executor (self.executor) may service FFT/MSM items here
                self.queue.process_queue(self.executor)
            return self.transcript.export_transcript()
