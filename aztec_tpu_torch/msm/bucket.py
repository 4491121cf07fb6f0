"""K4: the bucket phase of the MSM engine (``csrc/bucket.cu``).

Port of aztec_tpu/msm/bucket_pallas.py.  From Jacobian bucket planes
(16, nbuckets):

    acc=None:   W = sum_{j>=1} j * B_j                 (width 1)
    acc given:  acc' = 2^dbl_steps * acc + W           (width 1)

in complete projective form, by the suffix-sum identity over the reversed
bucket stream cut into ``LANES`` lanes of K2 = nbuckets / LANES entries:

    W = sum_l lanesum_l + K2 * sum_l carry_l - T

(lanesum_l: the sum of lane l's running sums; carry_l: the sum of the
totals of the lanes before it; T: the grand total).  The card's kernel
walks the lanes in one launch and combines them in a second (32 groups of
32 lanes, then the groups); ``bucket_phase_plain`` performs the same
complete additions in the same order over an ops bundle, so on the curve it
is bit-identical to the kernel, and on the mock group (Z_m, +) it checks
the algebra.  Against the TPU kernel or the plain engine composition
(``pippenger._bucket_phase``) the projective representative differs, so
those compare in affine.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import native
from ..curves import group
from ..ff import field_kernels as fk
from ..ff import limb
from ..ff.spec import FieldSpec

L = 16
LANES = 1024      # the TPU kernel's split: one (8, 128) tile of lanes
GROUPS = 32       # the combine's threads; each walks LANES / GROUPS lanes


def supported(nbuckets: int) -> bool:
    """bucket_pallas.supported: nbuckets = LANES * K2, K2 a power of two."""
    k2 = nbuckets // LANES
    return nbuckets % LANES == 0 and k2 >= 1 and (k2 & (k2 - 1)) == 0


@dataclasses.dataclass(frozen=True)
class PlainOps:
    """The plain complete-projective formulas of ``curves/group.py`` as an
    ops bundle (whatever the device), for ``bucket_phase_plain``."""

    spec: FieldSpec
    b: int
    device: torch.device

    def c_infinity(self, batch_shape=()):
        return group.proj_infinity(self.spec, batch_shape, self.device)

    def c_add(self, P, Q):
        return group.proj_add_complete(P, Q, self.spec, self.b)

    def c_dbl(self, P):
        return group.proj_dbl(P, self.spec, self.b)

    def c_neg(self, P):
        X, Y, Z = P
        return (X, limb.sub_mod(torch.zeros_like(Y), Y, self.spec), Z)

    def j2c(self, P):
        return group.jacobian_to_proj(P, self.spec)


def _cat(*pts):
    return tuple(torch.cat(cs, dim=-1) for cs in zip(*pts))


def _split(P, parts: int):
    cs = [torch.chunk(c, parts, dim=-1) for c in P]
    return [tuple(c[i] for c in cs) for i in range(parts)]


def _dbl_n(ops, P, steps: int):
    for _ in range(steps):
        P = ops.c_dbl(P)
    return P


def bucket_phase_plain(ops, buckets, nbuckets: int, acc=None,
                       dbl_steps: int = 0):
    """Plain version of K4 over an ops bundle (``c_infinity``, ``c_add``,
    ``c_dbl``, ``c_neg``, ``j2c``): the kernel's additions in its order.
    Additions the kernel makes in one thread one after another but that
    read only earlier values run here as one batched call; each lane's
    result is the same."""
    K2 = nbuckets // LANES
    S = LANES // GROUPS
    rev = tuple(torch.flip(b, dims=(-1,)).reshape(b.shape[0], LANES, K2)
                for b in buckets)
    # launch 1: lane l walks reversed entries l K2 .. l K2 + K2 - 1
    run = ops.c_infinity((LANES,))
    ls = ops.c_infinity((LANES,))
    for k in range(K2):
        run = ops.c_add(run, ops.j2c(tuple(r[..., k] for r in rev)))
        ls = ops.c_add(ls, run)
    # launch 2: thread g walks lanes g S .. g S + S - 1 ...
    tot = tuple(t.reshape(t.shape[0], GROUPS, S) for t in run)
    lsg = tuple(t.reshape(t.shape[0], GROUPS, S) for t in ls)
    inf = ops.c_infinity((GROUPS,))
    C, run, A = inf, inf, inf
    for i in range(S):
        C, run, A = _split(ops.c_add(_cat(C, run, A),
                                     _cat(run, tuple(t[..., i] for t in tot),
                                          tuple(t[..., i] for t in lsg))), 3)
    # ... then thread 0 walks the groups
    inf1 = ops.c_infinity((1,))
    CG, RG, CS, AS = inf1, inf1, inf1, inf1
    for h in range(GROUPS):
        part = [tuple(t[..., h:h + 1] for t in P) for P in (run, C, A)]
        CG, RG, CS, AS = _split(ops.c_add(_cat(CG, RG, CS, AS),
                                          _cat(RG, *part)), 4)
    D = ops.c_add(CS, _dbl_n(ops, CG, S.bit_length() - 1))
    D = _dbl_n(ops, D, K2.bit_length() - 1)
    W = ops.c_add(ops.c_add(AS, D), ops.c_neg(RG))
    if acc is None:
        acc, dbl_steps = inf1, 0
    return ops.c_add(_dbl_n(ops, acc, dbl_steps), W)


def bucket_phase(buckets, nbuckets: int, spec: FieldSpec, b: int, acc=None,
                 dbl_steps: int = 0):
    """K4 wrapper (bucket_pallas.bucket_phase): None when nbuckets is not
    ``supported`` (the caller composes the phase itself); the plain version
    for CPU tensors; the kernel for CUDA tensors."""
    if not supported(nbuckets):
        return None
    X = buckets[0]
    if not fk.use_kernels(X):
        return bucket_phase_plain(PlainOps(spec, b, X.device), buckets,
                                  nbuckets, acc, dbl_steps)
    dev = X.device
    if acc is None:
        acc, dbl_steps = group.proj_infinity(spec, (1,), dev), 0
    for p in tuple(buckets) + tuple(acc):
        if p.device != dev or p.dtype != torch.int32:
            raise ValueError(f"bucket_phase: expected int32 planes on {dev}")
    if any(tuple(p.shape) != (L, nbuckets) for p in buckets):
        raise ValueError(f"bucket_phase: expected (16, {nbuckets}) buckets, "
                         f"got {[tuple(p.shape) for p in buckets]}")
    if any(tuple(p.shape) != (L, 1) for p in acc):
        raise ValueError("bucket_phase: expected a width-1 accumulator")
    bx, by, bz = (p.contiguous() for p in buckets)
    ax, ay, az = (p.contiguous() for p in acc)
    scratch = torch.empty((6, L, LANES), dtype=torch.int32, device=dev)
    outs = [torch.empty((L, 1), dtype=torch.int32, device=dev)
            for _ in range(3)]
    b3 = fk.const256(group.b3_limbs(spec, b))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = native.library("bucket").bk_bucket_phase(
        fk.field_id(spec), bx.data_ptr(), by.data_ptr(), bz.data_ptr(),
        ax.data_ptr(), ay.data_ptr(), az.data_ptr(), scratch.data_ptr(),
        *[o.data_ptr() for o in outs], ctypes.cast(b3, ctypes.c_void_p),
        int(nbuckets // LANES),
        int(dbl_steps), stream)
    native.check(rc, "bk_bucket_phase")
    fk.LAUNCHES["bucket_phase"] += 1
    fk.ELEMS["bucket_phase"] += nbuckets
    return tuple(outs)
