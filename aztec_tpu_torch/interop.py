"""Carry the JAX package's arrays into the port's tensors.

The reference keeps field elements as numpy-convertible (16, n) uint32
planes of 16-bit limbs; the port keeps the same planes as int32 tensors.
These helpers take such numpy planes (from ``np.asarray`` of a JAX array,
or from a saved file) and build the port's objects on a device, so that
tests hand both packages the same SRS and keys.
"""

from __future__ import annotations

import numpy as np
import torch

from .plonk.manifests import STANDARD, StandardSettings
from .plonk.proving_key import ProvingKey
from .srs.reference_string import ProverReferenceString


def planes_from_numpy(arr, device="cuda") -> torch.Tensor:
    """(16, ...) uint16/uint32 limb planes -> int32 tensor on ``device``."""
    a = np.asarray(arr)
    if a.ndim < 1 or a.shape[0] != 16:
        raise ValueError(f"expected (16, ...) limb planes, got {a.shape}")
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError("limb planes hold 16-bit digits")
    return torch.as_tensor(a.astype(np.int32), device=device)


def prover_srs_from_planes(X, Y, device="cuda") -> ProverReferenceString:
    """Affine Montgomery Fq planes (X, Y) -> the port's prover SRS."""
    Xt = planes_from_numpy(X, device)
    Yt = planes_from_numpy(Y, device)
    if Xt.shape != Yt.shape or Xt.dim() != 2:
        raise ValueError(f"SRS planes {tuple(Xt.shape)} / {tuple(Yt.shape)}")
    return ProverReferenceString(Xt, Yt, Xt.shape[1])


def proving_key_from_numpy(n: int, num_public_inputs: int, planes: dict, srs,
                           settings: StandardSettings = STANDARD,
                           device="cuda") -> ProvingKey:
    """A proving key from the reference key's planes, for the selectors and
    sigmas of the settings' polynomial manifest (five and three for
    Standard, eleven and four for Turbo; Ultra adds ``table_1..4``,
    ``q_lookup`` and ``q_index`` to the selectors).

    ``planes`` maps ``"<name>_monomial"`` for every selector and sigma, and
    ``"<name>_lagrange"`` for the sigmas and for the selectors the
    reference keeps in lagrange form too (Ultra's tables, ``q_lookup`` and
    ``q_index``), to (16, n) Montgomery planes.  The 4n coset evaluations
    are recomputed on ``device`` from the monomials."""
    pk = ProvingKey(n, num_public_inputs, srs, settings, device)
    manifest = settings.polynomial_manifest
    for name in (p.polynomial_label for p in manifest
                 if p.source == "selector"):
        lag = planes.get(f"{name}_lagrange")
        pk.add_monomial("selector", name,
                        planes_from_numpy(planes[f"{name}_monomial"], device),
                        None if lag is None else planes_from_numpy(lag,
                                                                   device))
    for name in (p.polynomial_label for p in manifest
                 if p.source == "permutation"):
        pk.add_monomial("permutation", name,
                        planes_from_numpy(planes[f"{name}_monomial"], device),
                        planes_from_numpy(planes[f"{name}_lagrange"], device))
    return pk
