"""The least work of a proof, from its shapes alone, and the card's peaks.

Nothing here reads the program: the counts follow from the flavour's width
and the subgroup size, so they stay the same whatever implements the MSM or
the FFT.  They are least counts (a real MSM or FFT does more), so a share of
the peak built on them is a lower bound and cannot pass 100% unless a time
leaves out work.

MSM of N points of BN254 G1 with 254-bit scalars, in 16-bit windows: each
point is added once into a bucket of each of its 16 windows, and each
window's 2^16 buckets take 2 * 2^16 additions to reduce; an addition is a
mixed Jacobian-affine one, 7 products and 4 squarings (11 field products).
Radix-2 FFT of N points: N/2 * log2(N) butterflies of one field product.
A 254-bit field product in 16-bit limbs: 264 int32 multiply-adds (256 limb
products and the Montgomery reduction's, as the port's kernel table counts
them, PERF.md).

A proof of width w (3 Standard, 4 Turbo) over a subgroup of n rows commits
w wires, Z, w quotient parts and the two openings: 2w + 3 MSMs of n points.
Its FFTs at least: w + 1 inverse FFTs of n points (the wires and Z), w + 1
coset FFTs of 4n (the same, for the quotient) and one inverse FFT of 4n (the
quotient).  The quotient's own products are not counted.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM5: 132 SMs at a boost clock of 1980 MHz, 64 int32
# multiply-adds a clock an SM (CUDA C++ Programming Guide, compute
# capability 9.0); HBM3 3.35 TB/s (NVIDIA's H100 data sheet).
PEAK_INT32_MAD_PER_S = 64 * 132 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12

MADS_PER_PRODUCT = 264
PRODUCTS_PER_ADD = 11
WINDOW_BITS = 16
SCALAR_BITS = 254
POINT_BYTES, SCALAR_BYTES = 64, 32


def msm_seconds(points: int) -> float:
    """The least time of one MSM: the larger of its products at the int32
    peak and its points and scalars read once at the HBM peak."""
    windows = math.ceil(SCALAR_BITS / WINDOW_BITS)
    adds = points * windows + windows * 2 * (1 << WINDOW_BITS)
    ops = adds * PRODUCTS_PER_ADD * MADS_PER_PRODUCT
    return max(ops / PEAK_INT32_MAD_PER_S,
               points * (POINT_BYTES + SCALAR_BYTES) / PEAK_BYTES_PER_S)


def proof_msms(width: int) -> int:
    return 2 * width + 3


def fft_products(n: int) -> int:
    return n // 2 * int(math.log2(n))


def proof_seconds(width: int, n: int) -> float:
    """The least time of a proof's MSMs and FFTs at the card's peaks."""
    ffts = (width + 1) * fft_products(n) + (width + 2) * fft_products(4 * n)
    return (proof_msms(width) * msm_seconds(n)
            + ffts * MADS_PER_PRODUCT / PEAK_INT32_MAD_PER_S)
