"""Chunked fixed-geometry Pippenger MSM, rounds batched per chunk.

Port of aztec_tpu/msm/chunked.py.  Per chunk of 2^chunk_log2 points:

  prep     GLV split + endomorphism table (``glv.glv_table``: one launch of
           ``csrc/glv.cu`` on the card) + limb-pair packing
  sort1    one stable sort of every round's (digit, source index) pairs
  rake     K-major point gather + the K3 rake kernel over a combined lane
           axis of R * B lanes (round boundaries are lane boundaries)
  carries  segmented Hillis-Steele scan of the lane tails
  tails    bucket edges from a histogram (``torch.bincount``) + cumsum;
           gathers of run tails and carries -> Jacobian bucket sums
  fold     one complete add into the running (16, R, 2^c) bucket planes

The per-chunk body up to the bucket sums is the engine's packed round
(``pippenger._packed_round_buckets``) over R rows.  Buckets accumulate
across chunks; the bucket phase (``pippenger._bucket_phase`` over all
rounds at once) and the Horner fold over rounds run once per MSM
(``_finish``).  The TPU-only staging of the reference (the bf16
matrix-unit histogram, ``lax.map`` slicing, K-major relayout tricks)
becomes plain torch ops.

Unlike the reference, a ragged tail of at most ``TAIL_MAX`` points (the
standard-PLONK quotient's (n+1)-th coefficient) is not padded to a whole
extra chunk: its table entries are mixed-added straight into the buckets
they hit (``tail_buckets``, through the K2 ``mixed_add_unsafe`` kernel).
Several MSMs over one point set run as one batch: their rounds are rows of
the same pipeline.
"""

from __future__ import annotations

import torch

from ..curves.group_ops import JacobianOps
from ..curves.spec import CurveSpec
from ..utils import spans
from . import glv as glv_mod
from . import pippenger as pp

CHUNK_LOG2 = 17   # points per chunk on the card (the table doubles under GLV)
RAKE_K = 64       # serial rake depth; B = n_eff / K
TAIL_MAX = 16     # ragged tails up to this many points skip the padded chunk


def digits(scalars, c: int, R: int):
    """(L', n) canonical scalar limbs -> (R, n) int64 c-bit window digits."""
    return torch.stack([pp.window(scalars, c, ri) for ri in range(R)])


def chunk_buckets(ops, packed16, digR, bacc, *, n: int, c: int, K: int,
                  rounds: int):
    """ONE chunk, ALL rounds: sort -> rake -> carries -> tails
    (``pippenger._packed_round_buckets`` over R rows), then the fold into
    the running projective bucket planes.

    digR: (R, n) digits; round row i reads the point table
    packed16[:, (i // rounds) * n : (i // rounds + 1) * n], so a batch of
    MSMs (one table of n entries each) runs as R = batch * rounds rows."""
    bj = pp._packed_round_buckets(ops, packed16, digR, n=n, c=c, K=K,
                                  rounds=rounds)
    return ops.c_add(bacc, ops.j2c(bj))


def _finish(ops, buckets, R: int, c: int, nbuckets: int,
            return_jacobian: bool, batch: int = 1):
    """Batched bucket phase over all rounds + Horner fold
    acc = 2^c acc + W_r, most significant round first.  buckets:
    (*, batch * R, nbuckets), MSM m in rows m*R .. m*R + R - 1; the result
    has width ``batch``."""
    W = pp._bucket_phase(ops, buckets, nbuckets, min(64, nbuckets // 1024 or 1))
    W = tuple(w.reshape(w.shape[:-2] + (batch, R)) for w in W)
    acc = ops.c_infinity((batch,))
    for ri in range(R - 1, -1, -1):
        acc = ops.c_dbl_n(acc, c)
        acc = ops.c_add(acc, tuple(w[..., ri] for w in W))
    return ops.c2j(acc) if return_jacobian else acc


def tail_buckets(ops, X, Y, digR, bacc, *, c: int, rounds: int):
    """Add a few table entries straight into the bucket planes.

    X, Y: (16, batch * E) affine entries (MSM m owns columns m*E ..
    m*E + E - 1); digR: (batch * rounds, E) their digits.  Entry e of every
    MSM is mixed-added into a Jacobian sum per touched (round, digit), E
    sequential K2 ``mixed_add_unsafe`` launches over batch * rounds lanes,
    and the sums are folded into ``bacc`` at the touched buckets only.
    A bucket's sum never meets +-P: the entries are distinct table points
    (the MSM's pairwise-independence contract)."""
    R, E = digR.shape
    nb = 1 << c
    dev = X.device
    idx = torch.arange(R, device=dev)[:, None] * nb + digR        # (R, E)
    uniq, inv = torch.unique(idx, return_inverse=True)
    J = ops.infinity((uniq.numel(),))
    owner = torch.arange(R, device=dev) // rounds                  # MSM of row
    for e in range(E):
        col = owner * E + e
        pos = inv[:, e]
        cur = tuple(a.index_select(1, pos) for a in J)
        pt = (X.index_select(1, col), Y.index_select(1, col))
        new = ops.select(digR[:, e] != 0, ops.mixed_add_unsafe(cur, pt), cur)
        J = tuple(a.index_copy(1, pos, v) for a, v in zip(J, new))
    flat = tuple(a.reshape(a.shape[0], R * nb) for a in bacc)
    got = ops.c_add(tuple(a.index_select(1, uniq) for a in flat), ops.j2c(J))
    return tuple(a.index_copy(1, uniq, v).reshape(a.shape[0], R, nb)
                 for a, v in zip(flat, got))


def geometry_for(n: int, use_glv: bool, K: int | None = None):
    """(chunk_log2, K, full chunks, tail points) for an n-point MSM: the
    chunk is the largest power of two <= n (at most 2^CHUNK_LOG2); a
    remainder above TAIL_MAX points is padded to one more chunk."""
    chunk_log2 = min(CHUNK_LOG2, max(1, n.bit_length() - 1))
    chunk = 1 << chunk_log2
    full, tail = divmod(n, chunk)
    if tail > TAIL_MAX or full == 0:
        full, tail = -(-n // chunk), 0
    n_eff = (2 if use_glv else 1) * chunk
    K = min(RAKE_K if K is None else K, n_eff)
    return chunk_log2, K, full, tail


def msm_chunked(points, scalars, curve: CurveSpec, *, c: int = 16,
                K: int | None = None, use_glv: bool = True):
    """MSMs over one point set, batched.

    points: affine Montgomery planes (X, Y) (16, n), all finite and
    pairwise independent (the prover's SRS contract).  scalars: canonical
    planes (16, n), or a list of (16, n_i) planes with n_i <= n, one MSM
    each (a shorter vector uses the first n_i points).  Returns Jacobian
    points of width 1, or of width len(scalars) for a list.

    The MSMs of a batch share every pipeline pass: their rounds are lanes
    of one rake, one bucket phase and one Horner fold.  Points past the
    last full chunk are padded with copies of point 0 and zero scalars
    (digit 0 lands in the dropped bucket 0), unless they fit the
    bucket tail (``tail_buckets``)."""
    X, Y = points
    scal = [scalars] if torch.is_tensor(scalars) else list(scalars)
    batch = len(scal)
    n = max(s.shape[1] for s in scal)
    if n > X.shape[1]:
        raise ValueError(f"{n} scalars for {X.shape[1]} points")
    X, Y = X[:, :n], Y[:, :n]
    use_glv = use_glv and glv_mod.glv_params(curve) is not None
    chunk_log2, K, full, tail = geometry_for(n, use_glv, K)
    chunk = 1 << chunk_log2
    n_eff = (2 if use_glv else 1) * chunk
    if 16 % c or n_eff % K:
        raise ValueError(f"unsupported geometry c={c}, K={K}, chunk={chunk}")
    R = (128 if use_glv else 256) // c
    nb = 1 << c
    ops = JacobianOps(curve, X.device)

    total = full * chunk + tail
    if total > n:
        X = torch.cat([X, X[:, :1].expand(-1, total - n)], dim=1)
        Y = torch.cat([Y, Y[:, :1].expand(-1, total - n)], dim=1)
    scal = [torch.cat([s, s.new_zeros((s.shape[0], total - s.shape[1]))],
                      dim=1) if s.shape[1] < total else s for s in scal]

    def prep(lo, hi):
        """Each MSM's (GLV) table over points lo..hi, side by side."""
        Xs, Ys, Ss = [], [], []
        for s in scal:
            Xc, Yc, sc = X[:, lo:hi], Y[:, lo:hi], s[:, lo:hi]
            if use_glv:
                (Xc, Yc), sc = glv_mod.glv_table((Xc, Yc), sc, curve)
            Xs.append(Xc)
            Ys.append(Yc)
            Ss.append(sc)
        return torch.cat(Xs, dim=1), torch.cat(Ys, dim=1), Ss

    acc = ops.c_infinity((batch * R, nb))
    for base in range(0, full * chunk, chunk):
        with spans.span("msm.chunk"):
            Xc, Yc, Ss = prep(base, base + chunk)
            digR = torch.cat([digits(sc, c, R) for sc in Ss])
            acc = chunk_buckets(ops, ops.pack_affine((Xc, Yc)), digR, acc,
                                n=n_eff, c=c, K=K, rounds=R)
    if tail:
        Xt, Yt, Ss = prep(total - tail, total)
        acc = tail_buckets(ops, Xt, Yt, torch.cat([digits(sc, c, R)
                                                   for sc in Ss]),
                           acc, c=c, rounds=R)
    with spans.span("msm.finish"):
        return _finish(ops, acc, R, c, nb, True, batch=batch)
