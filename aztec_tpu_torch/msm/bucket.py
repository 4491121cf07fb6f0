"""K4: the bucket phase of the MSM engine (``csrc/bucket.cu``).

Port of aztec_tpu/msm/bucket_pallas.py.  From Jacobian bucket planes
(16, nbuckets):

    acc=None:   W = sum_{j>=1} j * B_j                 (width 1)
    acc given:  acc' = 2^dbl_steps * acc + W           (width 1)

in complete projective form, by the suffix-sum identity over the reversed
bucket stream r: W = sum_s P_s - T, with P_s its prefix sums and T its
total.  The stream is cut into lanes of K2 entries (``geometry``), each
lane walks its entries (its total t and prefix-sum sum s), and segments in
order combine level by level, m at a time:

    t = sum_i t_i,   s = sum_i s_i + len * sum_i C_i,
    C_i = t_0 + ... + t_{i-1},

by a Hillis-Steele scan of the t_i and one tree over the s_i and the C_i
(``_block_combine``): the lanes of a block of BK_THREADS, then the blocks.
``bucket_phase_plain`` performs the kernel's complete additions and
doublings in the same order over an ops bundle, so on the curve it is
bit-identical to the kernel, and on the mock group (Z_m, +) it checks the
algebra.  Against the TPU kernel or the plain engine composition
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
LANES = 1024      # the TPU kernel's split: supported() keeps its contract
BK_THREADS = 128  # lanes a block, and the most blocks (the final block's
                  # threads)
MIN_K2 = 4        # entries a lane, up to BK_THREADS^2 * MIN_K2 buckets


def geometry(nbuckets: int):
    """(K2, nblocks): lanes of K2 entries, BK_THREADS lanes a block.  K2 is
    MIN_K2 up to 2^16 buckets (16,384 lanes in 128 blocks, about one a
    multiprocessor of an H100) and grows beyond, so that the blocks' segments
    fit the final block; 1,024 buckets make two blocks."""
    k2 = max(MIN_K2, nbuckets // (BK_THREADS * BK_THREADS))
    return k2, nbuckets // (k2 * BK_THREADS)


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


def _cols(P, a: int, b: int):
    return tuple(c[..., a:b] for c in P)


def _dbl_n(ops, P, steps: int):
    for _ in range(steps):
        P = ops.c_dbl(P)
    return P


def _block_combine(ops, t, s, log2_len: int):
    """csrc/bucket.cu ``block_combine`` batched over the leading axes: m
    segments of 2^log2_len entries along the last axis (t, s: points of
    shape (..., m)) -> the combined (t, s), each (..., 1)."""
    m = t[0].shape[-1]
    P, d = t, 1
    while d < m:                  # inclusive scan: P_i += P_{i-d}, i >= d
        P = _cat(_cols(P, 0, d), ops.c_add(_cols(P, 0, m - d),
                                           _cols(P, d, m)))
        d *= 2
    carry = _cat(ops.c_infinity(t[0].shape[1:-1] + (1,)), _cols(P, 0, m - 1))
    X = tuple(torch.stack([a, b], dim=-2) for a, b in zip(s, carry))
    d = m // 2
    while d >= 1:                 # one tree over the rows (s, C)
        X = ops.c_add(_cols(X, 0, d), _cols(X, d, 2 * d))
        d //= 2
    S, C = (tuple(c[..., r, :] for c in X) for r in (0, 1))
    return _cols(P, m - 1, m), ops.c_add(S, _dbl_n(ops, C, log2_len))


def bucket_phase_plain(ops, buckets, nbuckets: int, acc=None,
                       dbl_steps: int = 0):
    """Plain version of K4 over an ops bundle (``c_infinity``, ``c_add``,
    ``c_dbl``, ``c_neg``, ``j2c``): the kernel's additions and doublings in
    its order, those of its threads batched."""
    K2, nblocks = geometry(nbuckets)
    rev = tuple(torch.flip(b, dims=(-1,)).reshape(
        b.shape[0], nblocks, BK_THREADS, K2) for b in buckets)
    # launch 1: lane (block, thread) walks its K2 reversed entries ...
    run = ops.c_infinity((nblocks, BK_THREADS))
    ls = ops.c_infinity((nblocks, BK_THREADS))
    for k in range(K2):
        run = ops.c_add(run, ops.j2c(tuple(r[..., k] for r in rev)))
        ls = ops.c_add(ls, run)
    # ... and each block combines its lanes
    t, s = _block_combine(ops, run, ls, K2.bit_length() - 1)
    if acc is None:
        acc, dbl_steps = ops.c_infinity((1,)), 0
    acc = _dbl_n(ops, acc, dbl_steps)
    # launch 2: one block combines the blocks' segments
    t, s = _block_combine(ops, *(tuple(c.reshape(c.shape[0], 1, nblocks)
                                       for c in P) for P in (t, s)),
                          (K2 * BK_THREADS).bit_length() - 1)
    t, s = (tuple(c.reshape(c.shape[0], 1) for c in P) for P in (t, s))
    return ops.c_add(acc, ops.c_add(s, ops.c_neg(t)))


def bucket_phase(buckets, nbuckets: int, spec: FieldSpec, b: int, acc=None,
                 dbl_steps: int = 0):
    """K4 wrapper (bucket_pallas.bucket_phase): None when nbuckets is not
    ``supported`` (the caller composes the phase itself); the plain version
    for CPU tensors; the kernel for CUDA tensors.  Any 16-bit limbs, as the
    reference: the kernel's formulas run lazily reduced where their
    operands lie below p, and exact otherwise."""
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
    K2, nblocks = geometry(nbuckets)
    scratch = torch.empty((6, L, nblocks + 1), dtype=torch.int32, device=dev)
    outs = [torch.empty((L, 1), dtype=torch.int32, device=dev)
            for _ in range(3)]
    b3 = fk.const256(group.b3_limbs(spec, b))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = native.library("bucket").bk_bucket_phase(
        fk.field_id(spec), bx.data_ptr(), by.data_ptr(), bz.data_ptr(),
        ax.data_ptr(), ay.data_ptr(), az.data_ptr(), scratch.data_ptr(),
        *[o.data_ptr() for o in outs], ctypes.cast(b3, ctypes.c_void_p),
        K2, nblocks, int(dbl_steps), stream)
    native.check(rc, "bk_bucket_phase")
    fk.LAUNCHES["bucket_phase"] += 1
    fk.ELEMS["bucket_phase"] += nbuckets
    return tuple(outs)
