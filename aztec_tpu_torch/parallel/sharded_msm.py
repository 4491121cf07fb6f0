"""Data-parallel Pippenger MSM over a device mesh.

Port of aztec_tpu/parallel/sharded_msm.py.  Points and scalars are split
into D contiguous shards (shard d on ``mesh.devices[d]``); each shard runs
a whole local MSM, then the D width-1 partial sums (complete projective
points) are gathered onto the first device and folded by one Hillis-Steele
scan of complete adds (K2 ``proj_add_complete``).  Communication is D
points.

Routing as the reference's: with no config, shards of at least 2^11 points
take the chunked pipeline (``sharded_chunked``, K3); the rest, and any
given ``MSMConfig``, run the engine on each shard (``pippenger.msm``: K5 on
the unpacked branch, K3 and K4 on the packed one).
"""

from __future__ import annotations

import torch

from ..curves.group_ops import JacobianOps
from ..curves.spec import CurveSpec
from ..msm import glv as glv_mod
from ..msm.pippenger import MSMConfig, _hillis_scan, default_config, msm
from .mesh import Mesh
from .sharded_chunked import chunked_partials

CHUNKED_MIN_SHARD = 1 << 11


def combine(parts, curve: CurveSpec, device):
    """Width-1 complete projective partials (any devices) -> their sum as a
    width-1 Jacobian point on ``device``: one gather, one scan."""
    ops = JacobianOps(curve, device)
    wide = tuple(torch.cat([p[i].to(device) for p in parts], dim=1)
                 for i in range(3))
    tot = _hillis_scan(ops, wide, ops.c_add)
    return ops.c2j(tuple(a[:, -1:] for a in tot))


def shard_partials(mesh: Mesh, points, scalars, curve: CurveSpec,
                   config: MSMConfig | None = None) -> list:
    """Each shard's MSM as a width-1 complete projective point on its
    device, in mesh order."""
    X, Y = points
    n = scalars.shape[1]
    D = mesh.size
    m = -(-n // D)
    if config is None and m >= CHUNKED_MIN_SHARD:
        return chunked_partials(mesh, (X[:, :n], Y[:, :n]), scalars, curve,
                                use_glv=glv_mod.glv_params(curve) is not None)
    if config is None:
        config = default_config(m, X.is_cuda)
    pad = D * m - n
    if pad:
        # copies of point 0 with zero scalars: digit 0, the dropped bucket
        X = torch.cat([X[:, :n], X[:, :1].expand(-1, pad)], dim=1)
        Y = torch.cat([Y[:, :n], Y[:, :1].expand(-1, pad)], dim=1)
        scalars = torch.cat([scalars, scalars.new_zeros((scalars.shape[0],
                                                         pad))], dim=1)
    parts = []
    for d, dev in enumerate(mesh.devices):
        sl = slice(d * m, (d + 1) * m)
        P = msm((X[:, sl].to(dev), Y[:, sl].to(dev)), scalars[:, sl].to(dev),
                curve, config)
        parts.append(JacobianOps(curve, dev).j2c(P))
    return parts


def sharded_msm(mesh: Mesh, points, scalars, curve: CurveSpec,
                config: MSMConfig | None = None):
    """MSM with points and scalars split along the mesh.

    points: (X, Y) affine Montgomery planes (16, >= n) on any device, all
    finite and pairwise independent (the SRS contract); scalars: (16, n)
    canonical planes.  The shards hold ceil(n / D) points each, the last
    padded with copies of point 0 and zero scalars.  Returns a width-1
    Jacobian point on the mesh's first device."""
    parts = shard_partials(mesh, points, scalars, curve, config)
    return combine(parts, curve, mesh.devices[0])
