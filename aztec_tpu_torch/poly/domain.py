"""Multiplicative FFT domains over BN254 Fr.

Port of aztec_tpu/poly/domain.py: integer facts of the domain plus lazily
built Montgomery tables (half-size root tables, coset powers) on the
domain's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import FR, limb
from ..ff import field_kernels as fk
from ..ff.bn254 import (
    FR_MOD,
    FR_PRIMITIVE_ROOT,
    FR_TWO_ADICITY,
    FR_MULTIPLICATIVE_GENERATOR,
)
from ..numeric.bigint import int_to_limbs


def mont_plane(v: int, device) -> torch.Tensor:
    """Canonical int -> (16,) Montgomery Fr limb plane."""
    return torch.as_tensor(int_to_limbs((v % FR_MOD) * FR.R % FR_MOD)
                           .astype("int32"), device=device)


def powers_table(base, count: int, spec=FR):
    """[1, b, b^2, ..., b^(count-1)] in Montgomery form, (16, count), from a
    (16,) Montgomery plane: the table doubles with one multiply by
    b^(2^k) per step."""
    t = limb.one_mont(spec, (1,), base.device).contiguous()
    bp = base[:, None]
    while t.shape[1] < count:
        t = torch.cat([t, fk.mont_mul(t, bp, spec)], dim=1)
        bp = fk.mont_mul(bp, bp, spec)
    return t[:, :count]


def _bit_reverse_indices(n: int) -> np.ndarray:
    """(n,) int32: i with its log2(n) bits reversed."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    out = np.zeros_like(idx)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out.astype(np.int32)


class EvaluationDomain:
    """FFT domain of size n (power of two) over Fr on one device."""

    def __init__(self, n: int, device="cuda"):
        if n < 2 or n & (n - 1):
            raise ValueError("domain size must be a power of 2")
        log2n = n.bit_length() - 1
        if log2n > FR_TWO_ADICITY:
            raise ValueError("domain larger than Fr's 2-adicity")
        self.device = torch.device(device)
        self.size = n
        self.root = pow(FR_PRIMITIVE_ROOT, 1 << (FR_TWO_ADICITY - log2n), FR_MOD)
        self.root_inverse = pow(self.root, -1, FR_MOD)
        self.domain_inverse = pow(n, -1, FR_MOD)
        self.generator = FR_MULTIPLICATIVE_GENERATOR
        self._tables = {}

    def _table(self, key: str, base_int: int, count: int):
        t = self._tables.get(key)
        if t is None:
            t = powers_table(mont_plane(base_int, self.device), count)
            self._tables[key] = t
        return t

    @property
    def forward_roots(self):
        """(16, n/2) Montgomery powers of the domain root."""
        return self._table("fwd", self.root, max(self.size // 2, 1))

    @property
    def inverse_roots(self):
        return self._table("inv", self.root_inverse, max(self.size // 2, 1))

    @property
    def bitrev(self):
        """(n,) int32 bit-reversal permutation on the domain's device (the
        Stockham FFT never reads it)."""
        t = self._tables.get("bitrev")
        if t is None:
            t = self._tables["bitrev"] = torch.as_tensor(
                _bit_reverse_indices(self.size), device=self.device)
        return t

    def coset_powers(self, g_int: int | None = None, count: int | None = None):
        """Powers of the coset generator (default: multiplicative generator)."""
        g = self.generator if g_int is None else g_int
        count = self.size if count is None else count
        return self._table(f"coset_{g}_{count}", g, count)

    def coset_inverse_powers(self, g_int: int | None = None,
                             count: int | None = None):
        g = self.generator if g_int is None else g_int
        count = self.size if count is None else count
        return self._table(f"cosetinv_{g}_{count}", pow(g, -1, FR_MOD), count)
