"""Group-operation bundles: the interface the MSM pipeline consumes.

Port of aztec_tpu/curves/group_ops.py.  ``JacobianOps`` is the elliptic-
curve instantiation (points are tuples of Montgomery limb planes); its
formulas go through the K2 wrappers (``group_kernels.py``), its rakes
through K3 and K5 (``msm/rake.py``) and its bucket phase through K4
(``msm/bucket.py``), which launch CUDA kernels for CUDA tensors and use the
plain formulas for CPU tensors.  ``IntModOps`` is a mock group (Z_m, +) with
the same calling convention, so the pipelines' indexing logic is tested
against plain integer sums; its ``rake_scan``, ``pack_affine`` and
``bucket_phase`` return None, so the MSM engine composes those phases from
the group ops.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ff import limb
from ..ff.spec import FieldSpec
from . import group
from . import group_kernels as gk
from .spec import CurveSpec


@dataclasses.dataclass(frozen=True)
class JacobianOps:
    curve: CurveSpec
    device: torch.device

    @property
    def spec(self) -> FieldSpec:
        return self.curve.field

    def infinity(self, batch_shape=()):
        return group.infinity(self.spec, batch_shape, self.device)

    def add_unsafe(self, P, Q):
        return gk.add_unsafe(P, Q, self.spec)

    def mixed_add_unsafe(self, P, Qa):
        return gk.mixed_add_unsafe(P, Qa, self.spec)

    def from_affine(self, Qa):
        return group.from_affine(Qa, self.spec)

    def select(self, mask, P, Q):
        return tuple(limb.select(mask, a, b) for a, b in zip(P, Q))

    def mask_to_infinity(self, keep_mask, P):
        """Z = 0 where ~keep."""
        X, Y, Z = P
        return (X, Y, torch.where(keep_mask[None], Z, 0))

    # complete homogeneous-projective ops (RCB16): the bucket phase
    def c_infinity(self, batch_shape=()):
        return group.proj_infinity(self.spec, batch_shape, self.device)

    def c_add(self, P, Q):
        return gk.proj_add_complete(P, Q, self.spec, self.curve.b)

    def c_dbl(self, P):
        return gk.proj_dbl(P, self.spec, self.curve.b)

    def c_dbl_n(self, P, steps: int):
        return gk.proj_dbl_n(P, self.spec, self.curve.b, steps)

    def j2c(self, P):
        return gk.jacobian_to_proj(P, self.spec)

    def c2j(self, P):
        return gk.proj_to_jacobian(P, self.spec)

    def c_mask_to_infinity(self, keep_mask, P):
        return group.proj_mask_to_infinity(keep_mask, P, self.spec)

    def pack_affine(self, pts):
        """Affine table with limb pairs packed per word ((16, n): X pairs in
        rows 0-7, Y pairs in 8-15), the rake's input layout."""
        X, Y = pts
        rows = torch.cat([p[0::2].long() | (p[1::2].long() << 16)
                          for p in (X, Y)], dim=0)
        # the words' bit patterns as int32: [2^31, 2^32) -> negative
        return (rows - ((rows >> 31) << 32)).to(torch.int32)

    def rake_scan_packed(self, dig_k, packed_k, B: int, K: int):
        from ..msm import rake

        return rake.rake_scan_packed(dig_k, packed_k, B, K, self.spec)

    def rake_scan(self, sd, pts, B: int, K: int):
        """K5 over n-order sorted entries (the engine's unpacked branch)."""
        from ..msm import rake

        return rake.rake_scan(sd, pts, B, K, self.spec)

    def bucket_phase(self, buckets, nbuckets: int, acc=None,
                     dbl_steps: int = 0):
        """K4 from Jacobian bucket planes; with ``acc`` it also folds the
        round's shift acc' = 2^dbl_steps acc + W.  None when nbuckets is
        not a power-of-two multiple of 1024 (the engine then composes the
        phase from ``c_add``)."""
        from ..msm import bucket

        return bucket.bucket_phase(buckets, nbuckets, self.spec, self.curve.b,
                                   acc, dbl_steps)


@dataclasses.dataclass(frozen=True)
class IntModOps:
    """Mock additive group (Z_m, +); 'points' are 1-tuples of (1, *b) int64."""

    m: int = 1_000_003
    device: torch.device = torch.device("cpu")

    def infinity(self, batch_shape=()):
        return (torch.zeros((1,) + tuple(batch_shape), dtype=torch.int64,
                            device=self.device),)

    def add_unsafe(self, P, Q):
        return ((P[0] + Q[0]) % self.m,)

    mixed_add_unsafe = add_unsafe

    def dbl(self, P):
        return ((P[0] * 2) % self.m,)

    def from_affine(self, Qa):
        return Qa

    def select(self, mask, P, Q):
        return tuple(torch.where(mask[None], a, b) for a, b in zip(P, Q))

    def mask_to_infinity(self, keep_mask, P):
        return tuple(torch.where(keep_mask[None], a, 0) for a in P)

    # "projective" aliases: the mock group has one representation
    c_infinity = infinity
    c_add = add_unsafe
    c_dbl = dbl

    def c_dbl_n(self, P, steps: int):
        return ((P[0] << steps) % self.m,)

    def c_neg(self, P):
        return ((-P[0]) % self.m,)

    def rake_scan(self, sd, pts, B, K):
        return None

    def pack_affine(self, pts):
        return None

    def bucket_phase(self, buckets, nbuckets, acc=None, dbl_steps=0):
        return None

    def j2c(self, P):
        return P

    c2j = j2c
    c_mask_to_infinity = mask_to_infinity
