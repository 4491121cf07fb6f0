"""Proving / verification keys: device-resident polynomial stores.

Port of aztec_tpu/plonk/proving_key.py: per polynomial the monomial form and
the 4n coset-FFT form as Montgomery limb planes on the key's device, plus
the quotient kernel's tables (L_1 on the coset, evaluation points, 1/Z*_H).

From ``QUARTER_MIN_N`` up the key keeps no 4n form: the 4n coset is four
quarters of n points, quarter j the n-point coset with generator
g w_4n^j at the coset's indices 4k + j (the reference's
``work_queue.small_fft_quarter`` decomposition), and the prover evaluates
the quotient one quarter at a time from the monomials (``quarter``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..curves import group
from ..curves.io import planes_to_ints
from ..curves.spec import BN254_G1
from ..ff import FR, limb
from ..ff import field_kernels as fk
from ..ff.bn254 import FR_MOD
from ..msm.pippenger import msm
from ..numeric.bigint import ints_to_limbs
from ..poly import fft_ops as pfft
from ..poly.domain import EvaluationDomain, mont_plane, powers_table
from ..utils import spans
from . import kernels
from .manifests import StandardSettings, STANDARD


# Subgroup sizes from which the key stores no 4n coset form and the quotient
# is evaluated by coset quarters; below it the stored forms save the
# quarters' FFTs of every proof.  Measured on an H100 (chip_smoke.py
# --quarters, --tower): the stored plan at 2^20 (Standard) peaks at 9.0 kB
# a point, the quarters at 2^24 (Turbo) at 4.0 kB, and a stored Turbo key
# adds about 4.9 kB a point to the quarters', so a stored Turbo prover would
# take about 38 GB at 2^22 and 75 GB at 2^23 of the card's 80.  No circuit
# between 2^20 and 2^24 is served or measured: 2^21 is a choice within that
# gap, not a measured limit.
QUARTER_MIN_N = 1 << 21


def fr_mont(v: int, device) -> torch.Tensor:
    return mont_plane(v, device)


def ints_to_mont(vals, device) -> torch.Tensor:
    """Canonical int list -> (16, n) Montgomery planes on ``device``.  Each
    distinct value is converted once (to the device as 16-bit limbs, into
    Montgomery form by one ``mont_mul`` by R^2), then gathered into
    place: a selector list holds few distinct values."""
    pos = {v: i for i, v in enumerate(dict.fromkeys(vals))}
    idx = np.fromiter(map(pos.__getitem__, vals), np.int64, len(vals))
    uniq = torch.as_tensor(ints_to_limbs(pos).astype(np.int32), device=device)
    return limb.to_mont(uniq, FR).index_select(
        1, torch.from_numpy(idx).to(device))


@dataclasses.dataclass
class PolyStore:
    monomial: torch.Tensor              # (16, n)
    fft: Optional[torch.Tensor] = None  # (16, 4n) coset evaluations
    lagrange: Optional[torch.Tensor] = None


def commit_many(srs, monos) -> list:
    """Kate commitments of several (16, m_i) Montgomery coefficient planes
    in ONE batched MSM against the SRS monomials: host affine ints (x, y),
    or None for infinity."""
    return commit_scalars(srs, [limb.from_mont(p, FR) for p in monos])


def commit_scalars(srs, scalars) -> list:
    """``commit_many`` of canonical (16, m_i) scalar planes (the work
    queue's MSM items)."""
    with spans.span("msm"):
        X, Y = srs.get_monomials(max(s.shape[1] for s in scalars))
        P = msm((X, Y), scalars, BN254_G1)
        x, y, inf = group.to_affine(P, BN254_G1.field)
        xs = planes_to_ints(limb.from_mont(x, BN254_G1.field))
        ys = planes_to_ints(limb.from_mont(y, BN254_G1.field))
        inf = inf.cpu().tolist()
    return [None if f else (a, b) for a, b, f in zip(xs, ys, inf)]


class ProvingKey:
    """ref: plonk/proof_system/proving_key/proving_key.hpp."""

    def __init__(self, n: int, num_public_inputs: int, srs,
                 settings: StandardSettings = STANDARD, device="cuda"):
        self.n = n
        self.num_public_inputs = num_public_inputs
        self.settings = settings
        self.device = torch.device(device)
        self.small_domain = EvaluationDomain(n, self.device)
        self.large_domain = EvaluationDomain(4 * n, self.device)
        self.srs = srs  # ProverReferenceString with >= n+1 monomials
        self.selectors: Dict[str, PolyStore] = {}
        self.sigmas: Dict[str, PolyStore] = {}
        self.omega_pows = powers_table(
            fr_mont(self.small_domain.root, self.device), n)
        l1_lagrange = torch.zeros((FR.nlimbs, n), dtype=torch.int32,
                                  device=self.device)
        l1_lagrange[:, 0] = fr_mont(1, self.device)
        l1_mono = pfft.ifft(l1_lagrange, self.small_domain)
        self.quarters = n >= QUARTER_MIN_N
        if self.quarters:
            self.l1_mono = l1_mono
            return
        self.l1_fft = pfft.coset_fft(self._extend(l1_mono), self.large_domain)
        self.coset_pts, self.vanish_scale = kernels.vanishing_scale_table(
            n,
            self.large_domain.root,
            self.small_domain.root,
            self.small_domain.generator,
            settings.num_roots_cut_out_of_vanishing_polynomial,
            self.device,
        )

    def _extend(self, mono):
        """Zero-pad (16, m) monomial coefficients to (16, 4n)."""
        return torch.cat([mono, mono.new_zeros((mono.shape[0],
                                                4 * self.n - mono.shape[1]))],
                         dim=1)

    def add_polynomial(self, kind: str, name: str, lagrange,
                       keep_lagrange: bool = False):
        """lagrange (16, n) Montgomery -> stores monomial + 4n coset fft."""
        mono = pfft.ifft(lagrange, self.small_domain)
        self.add_monomial(kind, name, mono,
                          lagrange if keep_lagrange else None)

    def add_monomial(self, kind: str, name: str, mono, lagrange=None):
        f = (None if self.quarters
             else pfft.coset_fft(self._extend(mono), self.large_domain))
        store = PolyStore(monomial=mono, fft=f, lagrange=lagrange)
        (self.selectors if kind == "selector" else self.sigmas)[name] = store

    def quarter(self, j: int):
        """Coset quarter j (the 4n coset's points g W^(4k + j), W = w_4n):
        (evaluate, points, L_1, 1/Z*_H) over its n points, where
        ``evaluate`` maps an (16, n) monomial to its n evaluations (the
        coefficients scaled by (g W^j)^i, then one n-point FFT)."""
        n = self.n
        dev = self.device
        cj = (self.small_domain.generator
              * pow(self.large_domain.root, j, FR_MOD) % FR_MOD)
        scale = powers_table(fr_mont(cj, dev), n)

        def evaluate(mono):
            return pfft.fft(fk.mont_mul(mono, scale, FR), self.small_domain)

        pts = fk.mont_mul(fr_mont(cj, dev)[:, None], self.omega_pows, FR)
        vs = kernels.vanishing_scale(
            pts, n, self.small_domain.root,
            self.settings.num_roots_cut_out_of_vanishing_polynomial)
        return evaluate, pts, evaluate(self.l1_mono), vs

    def commit(self, mono):
        """One Kate commitment (host affine ints or None)."""
        return commit_many(self.srs, [mono])[0]


@dataclasses.dataclass
class VerificationKey:
    """ref: plonk/proof_system/verification_key/verification_key.hpp."""

    n: int
    num_public_inputs: int
    commitments: Dict[str, Optional[Tuple[int, int]]]
    domain_root: int
    g2_x: tuple  # Fq2 affine pair
    settings: StandardSettings = STANDARD
    contains_recursive_proof: bool = False
    recursive_proof_public_input_indices: Optional[tuple] = None
