"""SRS Lagrange-base transformation
(ref: srs/lagrange_base_transformation/lagrange_base.cpp).

Host copy of aztec_tpu/srs/lagrange_base.py: transforms a monomial SRS
([tau^i]G) into Lagrange-base commitments ([L_i(tau)]G) with a radix-2 FFT
over G1 elements (butterfly twiddles are scalar muls).  Like the reference,
an offline tool that runs once per SRS, so it is host arithmetic.

The output placement matches the reference's transform_srs exactly: fft
output i lands at lagrange index i+1 (mod n), scaled by 1/n, with the
inverse domain root as the FFT twiddle root.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..curves import pairing as pr
from ..ff.bn254 import FR_MOD
from ..poly.domain import EvaluationDomain

GPoint = Optional[Tuple[int, int]]  # None = infinity

M = FR_MOD


def _g1fft(points: List[GPoint], root: int) -> List[GPoint]:
    """Radix-2 FFT over G1 (mirrors g1fft, lagrange_base.cpp:6-30)."""
    n = len(points)
    if n == 1:
        return list(points)
    even = _g1fft(points[0::2], root * root % M)
    odd = _g1fft(points[1::2], root * root % M)
    out: List[GPoint] = [None] * n
    cur = root
    for i in range(n // 2):
        t = pr.g1_mul(cur, odd[i])
        out[i] = pr.g1_add(even[i], t)
        out[n // 2 + i] = pr.g1_add(even[i], pr.g1_neg(t))
        cur = cur * root % M
    return out


def transform_srs(monomials: List[GPoint]) -> List[GPoint]:
    """[tau^i]G (i < n, n a power of two) -> [L_i(tau)]G."""
    n = len(monomials)
    if n & (n - 1):
        raise ValueError(f"{n} monomials: not a power of two")
    # the domain's tables are built lazily; only its root is read here
    root = EvaluationDomain(n, device="cpu").root
    fft_out = _g1fft(list(monomials), pow(root, -1, M))
    n_inv = pow(n, -1, M)
    lagrange: List[GPoint] = [None] * n
    for i in range(n - 1):
        lagrange[i + 1] = pr.g1_mul(n_inv, fft_out[i])
    lagrange[0] = pr.g1_mul(n_inv, fft_out[n - 1])
    return lagrange
