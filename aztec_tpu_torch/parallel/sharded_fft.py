"""Coset FFT sharded over a device mesh with one all-to-all.

Port of aztec_tpu/parallel/sharded_fft.py.  It generalises the
reference's split of one 4n coset FFT into 4 shifted n-FFTs
(work_queue.hpp:166-200; polynomial_arithmetic.cpp:401) to D shards by the
decimation-in-time identity

    X(x) = sum_j x^j c_j(x^D),   c_j(y) = sum_i coeff[D i + j] y^i

Stage 1 (local):      E_j = coset-FFT_m(c_j, generator g^D), m = N/D, on
                      device j
Stage 2 (all-to-all): device k takes block k (m/D points) of every E_j
Stage 3 (local):      X[t + m v] = sum_j g^j W^(t j) zeta_D^(v j) E_j[t]
                      for the t of device k's block, zeta_D = W^m

Layouts: input coefficients (16, D, m) with [:, j, i] = coeff[D i + j]
(``interleave``), shard j on device j; output (16, D, m) with [:, v, t] =
X(g W^(t + m v)), device k holding t in [k m/D, (k + 1) m/D).  Every field
op is one K1 launch on the card.  Requires D^2 | N.
"""

from __future__ import annotations

import functools

import torch

from ..ff import FR
from ..ff import field_kernels as fk
from ..ff.bn254 import FR_MOD
from ..poly import fft_ops as pfft
from ..poly.arithmetic import fr_mont_plane
from ..poly.domain import EvaluationDomain, powers_table
from .mesh import Mesh


@functools.lru_cache(maxsize=None)
def _subdomain(m: int, device: torch.device) -> EvaluationDomain:
    """The m-point domain on one device (its root and coset tables kept)."""
    return EvaluationDomain(m, device)


def interleave(coeffs, D: int):
    """(16, N) monomial coefficients -> (16, D, N/D) residue-major layout."""
    L, N = coeffs.shape
    return coeffs.reshape(L, N // D, D).permute(0, 2, 1)


def deinterleave_output(out):
    """(16, D, m) output with [:, v, t] = X[t + m v] -> natural (16, N)."""
    L, D, m = out.shape
    return out.reshape(L, D * m)


def natural_order(out, D: int):
    """The (16, N) output of ``sharded_coset_fft`` is already in natural
    order q = t + m v."""
    return out


def sharded_coset_fft(mesh: Mesh, coeffs, domain: EvaluationDomain):
    """coeffs: (16, N) Montgomery monomial coefficients (any device), N =
    domain.size.  Returns the (16, N) coset evaluations X(g W^q), natural
    order, on the mesh's first device."""
    D = mesh.size
    N = domain.size
    if N % (D * D):
        raise ValueError(f"a {D}-way sharded FFT needs D^2 | N, N = {N}")
    m = N // D
    blk = m // D
    g, W = domain.generator, domain.root
    zeta = pow(W, m, FR_MOD)
    x = interleave(coeffs, D)

    # stage 1: device j's residue class, a coset FFT with generator g^D
    gD = pow(g, D, FR_MOD)
    E = []
    for j, dev in enumerate(mesh.devices):
        cj = x[:, j, :].contiguous().to(dev)
        E.append(pfft.coset_fft(cj, _subdomain(m, dev), generator=gD))

    out = []
    for k, dev in enumerate(mesh.devices):
        # stage 2: block k of every E_j moves to device k
        Ek = [e[:, k * blk:(k + 1) * blk].to(dev) for e in E]
        # stage 3: factor_j[s] = g^j W^((k blk + s) j), then the v axis
        acc = None
        for j in range(D):
            Wj = pow(W, j, FR_MOD)
            base = pow(g, j, FR_MOD) * pow(Wj, k * blk, FR_MOD) % FR_MOD
            fac = fk.mont_mul(powers_table(fr_mont_plane(Wj, dev), blk),
                              fr_mont_plane(base, dev)[:, None], FR)
            term = fk.mont_mul(Ek[j], fac, FR)                   # (16, blk)
            zv = torch.stack([fr_mont_plane(pow(zeta, v * j, FR_MOD), dev)
                              for v in range(D)], dim=1)          # (16, D)
            contrib = fk.mont_mul(term[:, None, :], zv[:, :, None], FR)
            acc = contrib if acc is None else fk.add_mod(acc, contrib, FR)
        out.append(acc.to(mesh.devices[0]))                      # (16, D, blk)
    return deinterleave_output(torch.cat(out, dim=2))
