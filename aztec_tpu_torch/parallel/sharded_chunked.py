"""Mesh-sharded chunked MSM: the pipeline of ``msm/chunked.py`` per shard.

Port of aztec_tpu/parallel/sharded_chunked.py.  Chunks are the unit of
work: each pass hands one chunk to every device of the mesh, and each
device runs the single-device stages on it (GLV table, sort, K3 rake,
carries, tails, one complete add into its own (16, R, 2^c) bucket planes;
``chunked.chunk_buckets``).  After the last pass every device runs the
bucket phase and the Horner fold over its planes (``chunked._finish``) to
a width-1 partial, and ``sharded_msm.combine`` gathers and folds the D
partials.  Bucket planes never leave their device.
"""

from __future__ import annotations

import torch

from ..curves.group_ops import JacobianOps
from ..curves.spec import CurveSpec
from ..msm import chunked
from ..msm import glv as glv_mod
from .mesh import Mesh


def chunked_partials(mesh: Mesh, points, scalars, curve: CurveSpec, *,
                     c: int = 16, use_glv: bool = True,
                     chunk_log2: int | None = None,
                     K: int | None = None) -> list:
    """Each device's width-1 complete projective partial, in mesh order.

    points: (X, Y) affine Montgomery planes (16, n); scalars (16, n)
    canonical.  The points are padded to a whole number of passes (D chunks
    a pass) with copies of point 0 and zero scalars."""
    X, Y = points
    n = X.shape[1]
    D = mesh.size
    use_glv = use_glv and glv_mod.glv_params(curve) is not None
    R = (128 if use_glv else 256) // c
    nb = 1 << c
    if chunk_log2 is None:
        chunk_log2, K, _, _ = chunked.geometry_for(-(-n // D), use_glv, K)
    chunk = 1 << chunk_log2
    n_eff = (2 if use_glv else 1) * chunk
    K = min(chunked.RAKE_K if K is None else K, n_eff)
    if 16 % c or n_eff % K:
        raise ValueError(f"unsupported geometry c={c}, K={K}, chunk={chunk}")

    span = D * chunk
    pad = (-n) % span
    if pad:
        X = torch.cat([X, X[:, :1].expand(-1, pad)], dim=1)
        Y = torch.cat([Y, Y[:, :1].expand(-1, pad)], dim=1)
        scalars = torch.cat([scalars, scalars.new_zeros((scalars.shape[0],
                                                         pad))], dim=1)
    ops = [JacobianOps(curve, dev) for dev in mesh.devices]
    acc = [o.c_infinity((R, nb)) for o in ops]
    for base in range(0, n + pad, span):
        for d, dev in enumerate(mesh.devices):
            lo = base + d * chunk
            Xc, Yc, sc = (t[:, lo:lo + chunk].to(dev) for t in (X, Y, scalars))
            if use_glv:
                (Xc, Yc), sc = glv_mod.glv_table((Xc, Yc), sc, curve)
            acc[d] = chunked.chunk_buckets(
                ops[d], ops[d].pack_affine((Xc, Yc)), chunked.digits(sc, c, R),
                acc[d], n=n_eff, c=c, K=K, rounds=R)
    return [chunked._finish(o, a, R, c, nb, False) for o, a in zip(ops, acc)]


def sharded_msm_chunked(mesh: Mesh, points, scalars, curve: CurveSpec,
                        **geometry):
    """The chunked MSM over the mesh: a width-1 Jacobian point on the
    mesh's first device (``chunked_partials`` takes the geometry)."""
    from .sharded_msm import combine

    return combine(chunked_partials(mesh, points, scalars, curve, **geometry),
                   curve, mesh.devices[0])
