"""Host-driven staged Pippenger MSM: the engine's packed rounds, one call
each, driven from Python.

Port of aztec_tpu/msm/staged.py.  The reference splits the monolithic MSM
jit into a few small jits (GLV prep, one round, finish) because compiling
the whole engine took too long on its TPU backend; PyTorch runs eagerly, so
here the module is only the round loop: prep (GLV table and limb-pair
packing), then ``pippenger._packed_round`` for each round, most significant
first (acc' = 2^c acc + W), then the conversion to Jacobian.
"""

from __future__ import annotations

from ..curves.group_ops import JacobianOps
from ..curves.spec import CurveSpec
from . import glv as glv_mod
from . import pippenger as pp


def geometry(n_eff: int, c: int, K: int) -> bool:
    """True when the packed branch takes (n_eff, K): B = n_eff / K lanes, a
    multiple of 1024."""
    B = n_eff // K
    return n_eff % K == 0 and B >= 1024 and B % 1024 == 0


def msm_staged(points, scalars, curve: CurveSpec, n: int, c: int, K: int,
               use_glv: bool, return_jacobian: bool = True):
    """Staged MSM.  points: (X, Y) affine Montgomery planes (16, n);
    scalars (16, n) canonical planes; n already padded so the (GLV-doubled)
    table fits the packed geometry.  Returns a width-1 Jacobian tuple (or
    the complete projective accumulator when return_jacobian=False)."""
    X, Y = points
    rounds = (128 if use_glv else 256) // c
    n_eff = 2 * n if use_glv else n
    if not geometry(n_eff, c, K):
        raise ValueError(f"no packed geometry for {n_eff} entries at K={K}")
    ops = JacobianOps(curve, X.device)
    if use_glv:
        (X, Y), scalars = glv_mod.glv_table((X, Y), scalars, curve)
    packed16 = ops.pack_affine((X, Y))
    acc = ops.c_infinity((1,))
    for ri in range(rounds - 1, -1, -1):
        acc = pp._packed_round(ops, packed16, pp.window(scalars, c, ri), acc,
                               n=n_eff, c=c, K=K)
    return ops.c2j(acc) if return_jacobian else acc
