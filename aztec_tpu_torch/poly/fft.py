"""Radix-2 FFT / iFFT / coset FFT over Fr, Stockham formulation.

Port of aztec_tpu/poly/fft.py: log2(n) self-sorting stages, each the
reference's butterfly (top + tw*bot, top - tw*bot) over the stage's halves
and a strided slice of the root table.  No bit-reversal pass.  Polynomials
are Montgomery (16, n) limb planes.  On the card the stages run
``field_kernels.MAX_STAGES`` at a time in one launch of K1's stage kernel
(``field_kernels.fft_stages``), which reads the stage's rows and twiddles
where they lie: no copy of the halves, no broadcast twiddle plane and no
concatenation.
"""

from __future__ import annotations

from ..ff import FR
from ..ff import field_kernels as fk
from .domain import EvaluationDomain, mont_plane

L = 16


def _fft_core(x, roots, n: int):
    """Stockham radix-2: A_t has shape (16, r_t, L_t) with r_t = n/2^t and
    A_t[:, b, :] = FFT_{L_t} of x[b::r_t]; the halves of x[b::r_{t+1}] are
    rows b and b + r_{t+1}, twiddled by a strided slice of the root table."""
    logn = n.bit_length() - 1
    A, t = x, 0
    while t < logn:
        s = min(fk.MAX_STAGES, logn - t)
        A = fk.fft_stages(A, roots, t, s, FR)
        t += s
    return A


def fft(x, domain: EvaluationDomain):
    """Coefficient form -> evaluation form over the domain."""
    return _fft_core(x, domain.forward_roots, domain.size)


def fft_with_bitrev(x, roots, bitrev, n: int, inverse: bool = False):
    """The FFT over an explicit root table (``roots``: the (16, n/2) powers
    of the domain's root, or of its inverse; the reference's signature,
    whose ``bitrev`` and ``inverse`` the self-sorting FFT does not read)."""
    return _fft_core(x, roots, n)


def ifft(x, domain: EvaluationDomain):
    """Evaluation form -> coefficient form (includes the 1/n scale)."""
    y = _fft_core(x, domain.inverse_roots, domain.size)
    return fk.mont_mul(y, mont_plane(domain.domain_inverse, x.device)[:, None],
                       FR)


def coset_fft(x, domain: EvaluationDomain, generator: int | None = None):
    """FFT of p(g X): scale coefficient i by g^i, then FFT."""
    return fft(fk.mont_mul(x, domain.coset_powers(generator), FR), domain)


def coset_ifft(x, domain: EvaluationDomain, generator: int | None = None):
    """Inverse of coset_fft: iFFT, then scale coefficient i by g^-i."""
    return fk.mont_mul(ifft(x, domain), domain.coset_inverse_powers(generator),
                       FR)
