"""Pippenger bucket-method MSM: the engine and the ``msm`` entry point.

Port of aztec_tpu/msm/pippenger.py.  Each window round of the engine
(``msm_engine``):

1. digit extraction from the scalar limb planes (c-bit windows),
2. a stable sort of the digits,
3. a rake scan: the sorted stream cut into B lanes of K entries; each lane
   accumulates its runs in order (K5 ``rake_scan``, or K3 on the packed
   branch); runs that cross lanes are fixed up with a Hillis-Steele
   segmented scan over the B lane tails,
4. the run tails gathered into the bucket array (bucket 0 dropped),
5. the bucket phase sum_j j * B_j (K4 ``bucket_phase``, which also folds
   acc' = 2^c acc + W; or, where K4 does not apply, the suffix-sum
   composition ``_bucket_phase``),

most significant round first.  The engine is group-generic: it works on
tuples of planes through an ops bundle (``curves/group_ops.py``), so its
indexing is tested against the mock group ``IntModOps``.  The reference's
``lax.fori_loop`` over rounds is a Python loop here; there is no jit.

Branches follow the reference: the packed branch (``_packed_round``, the
same sort -> K3 -> carries -> tails body as the chunked pipeline, at one
row) is taken exactly when B is a multiple of 1024; K4 is used exactly when
nbuckets is a power-of-two multiple of 1024.  One difference: the TPU's
``rake_scan`` refuses B that are not multiples of 1024, so on a TPU the
unpacked branch composes its rake from single mixed adds; the card's K5
takes any B, and the unpacked branch runs it.

``msm`` routes like the reference: an explicit ``config`` with one scalar
plane goes to the engine; ``config=None``, and the port's batched list of
scalar planes, run the chunked pipeline (``chunked.py``) at every size.

Point additions use unsafe variants exactly as the reference's
pippenger_unsafe: inputs must be pairwise linearly independent (true for
SRS monomials); infinities are handled.
"""

from __future__ import annotations

import dataclasses

import torch

from ..curves.group_ops import JacobianOps
from ..curves.spec import CurveSpec
from . import glv as glv_mod

SENTINEL = 0x1FFFF  # no digit equals it: a lane's first step restarts


@dataclasses.dataclass(frozen=True)
class MSMConfig:
    c: int = 16             # window bits; must divide 16
    block: int = 64         # K: serial accumulation depth per rake lane
    bucket_block: int = 64  # K2: serial depth of the composed bucket phase
    glv: bool = False       # endomorphism split: half the rounds, 2x points

    def rounds(self) -> int:
        return (128 if self.glv else 256) // self.c


def default_config(n: int, on_card: bool) -> MSMConfig:
    """Window width by size.  On the card every size from 2^12 points runs
    the reference geometry (c = 16, K = 64, GLV); elsewhere the reference's
    off-TPU tiers apply (c = 4 below 2^12 points, c = 8 below 2^18)."""
    if on_card and n >= 1 << 12:
        return MSMConfig(c=16, block=64, glv=True)
    if n >= 1 << 18:
        return MSMConfig(c=16, glv=True)
    if n >= 1 << 12:
        return MSMConfig(c=8, bucket_block=16, glv=True)
    return MSMConfig(c=4, block=32, bucket_block=4, glv=True)


def window(scalars, c: int, ri: int):
    """(L', n) canonical scalar limbs -> (n,) int64 digits of window ri
    (c divides 16, so a window never straddles two limbs)."""
    limb_row = scalars[(c * ri) // 16].to(torch.int64)
    return (limb_row >> ((c * ri) % 16)) & ((1 << c) - 1)


def _roll(P, shift):
    return tuple(torch.roll(a, shift, dims=-1) for a in P)


def _hillis_seg_scan(ops, V, F):
    """Inclusive segmented scan (group add) over the last axis of V with
    head flags F (True = segment start)."""
    B = F.shape[0]
    steps = max((B - 1).bit_length(), 1)
    idx = torch.arange(B, device=F.device)
    for s in range(steps):
        d = 1 << s
        Vp = _roll(V, d)
        Fp = torch.roll(F, d)
        valid = (idx >= d) & ~F
        combined = ops.add_unsafe(Vp, V)
        V = ops.select(valid, combined, V)
        F = F | torch.where(idx >= d, Fp, True)
    return V


def _hillis_scan(ops, V, add):
    """Inclusive unsegmented scan over the last axis with the given add."""
    B = V[0].shape[-1]
    steps = max((B - 1).bit_length(), 1)
    idx = torch.arange(B, device=V[0].device)
    for s in range(steps):
        d = 1 << s
        V = ops.select(idx >= d, add(_roll(V, d), V), V)
    return V


def _rake_segment_scan(ops, sd, pts, B: int, K: int):
    """Sorted digit stream -> running segment partials + cross-lane carries.

    sd: (n,) sorted digits; pts: tuple of (*, n) planes in the same order,
    entry (b, k) at column b * K + k.  Returns (scan: tuple of (*, B, K),
    C: carry to add to each lane's first-run tail, fr: (B, K) first-run
    mask, sdb: (B, K) digits)."""
    sdb = sd.reshape(B, K)
    scan = ops.rake_scan(sd, pts, B, K)
    if scan is None:
        # the composition of single steps (the mock group)
        ptsb = tuple(p.reshape(p.shape[:-1] + (B, K)) for p in pts)
        acc = ops.infinity((B,))
        accd = torch.full((B,), SENTINEL, dtype=sd.dtype, device=sd.device)
        steps = []
        for k in range(K):
            Pk = tuple(p[..., k] for p in ptsb)
            same = sdb[:, k] == accd
            acc = ops.select(same, ops.mixed_add_unsafe(acc, Pk),
                             ops.from_affine(Pk))
            accd = sdb[:, k]
            steps.append(acc)
        scan = tuple(torch.stack([s[i] for s in steps], dim=-1)
                     for i in range(len(acc)))

    T = tuple(s[..., K - 1] for s in scan)  # lane-tail partials (width B)
    C = _block_carries(ops, sdb, T, B, K)
    fr = sdb == sdb[:, :1]  # first-run mask (sorted => contiguous prefix)
    return scan, C, fr, sdb


def _block_carries(ops, sdb, T, B: int, K: int):
    """Cross-lane carry for each lane's first run: segmented scan of the
    lane-tail partials T (width B), rolled one lane right, masked to lanes
    whose first run continues the previous lane's last run."""
    internal = (sdb[:, 1:] != sdb[:, :-1]).any(1)
    return _block_carries_from(ops, sdb[:, 0], sdb[:, K - 1], internal, T)


def _block_carries_from(ops, h, t, internal, T, heads=None):
    """_block_carries from per-lane head digits h, tail digits t and
    internal-break flags.  ``heads`` marks lanes that start a new stream
    (the chunked pipeline's round rows); lane 0 always does."""
    cont = torch.cat([torch.zeros(1, dtype=torch.bool, device=h.device),
                      h[1:] == t[:-1]])
    if heads is not None:
        cont = cont & ~heads
    scanned = _hillis_seg_scan(ops, T, internal | ~cont)
    return ops.select(cont, _roll(scanned, 1), ops.infinity((h.shape[0],)))


def _bucket_phase(ops, buckets, nbuckets: int, K2: int):
    """sum_{j>=1} j * B_j via suffix sums, rake-style, over the last axis:
    complete projective planes (*, nbuckets) -> (*, 1).  Leading batch axes
    (the chunked pipeline's rounds) run side by side.

    Runs entirely on the complete projective ops: suffix-sum plateaus from
    empty buckets produce equal and identity operands, which the
    branchless RCB formulas handle."""
    B2 = nbuckets // K2
    bsh = tuple(buckets[0].shape[1:-1])
    dev = buckets[0].device
    rb = tuple(torch.flip(b, dims=(-1,)).reshape(b.shape[:-1] + (B2, K2))
               for b in buckets)
    acc = ops.c_infinity(bsh + (B2,))
    local = []
    for k in range(K2):
        acc = ops.c_add(acc, tuple(b[..., k] for b in rb))
        local.append(acc)
    local = tuple(torch.stack([pt[i] for pt in local], dim=-1)
                  for i in range(len(acc)))                  # (*, B2, K2)

    # exclusive carry of lane totals
    scanned = _hillis_scan(ops, acc, ops.c_add)
    idx2 = torch.arange(B2, device=dev)
    carry = ops.select(idx2 >= 1, _roll(scanned, 1), ops.c_infinity(bsh + (B2,)))
    S = ops.c_add(local, tuple(cc[..., None] for cc in carry))

    # W = sum over S_rev[0 .. nbuckets-2]  (drop S_rev[last] = S_0)
    Sf = tuple(s.reshape(s.shape[:-2] + (nbuckets,)) for s in S)
    keep = torch.arange(nbuckets, device=dev) != (nbuckets - 1)
    sb = tuple(s.reshape(s.shape[:-1] + (B2, K2))
               for s in ops.c_mask_to_infinity(keep, Sf))
    colsum = ops.c_infinity(bsh + (B2,))
    for k in range(K2):
        colsum = ops.c_add(colsum, tuple(b[..., k] for b in sb))
    tot = _hillis_scan(ops, colsum, ops.c_add)
    return tuple(a[..., -1:] for a in tot)


def _packed_round_buckets(ops, packed16, digR, *, n: int, c: int, K: int,
                          rounds: int = 1):
    """Digit rows -> Jacobian bucket planes (*, R, 2^c): sort -> K3 ->
    carries -> tails.

    packed16: limb-pair packed affine table (ops.pack_affine); digR: (R, n)
    digits, row i reading the table entries (i // rounds) * n ..
    (i // rounds + 1) * n.  Shared by ``_packed_round`` (one row, folded
    into the running accumulator at once) and the chunked pipeline
    (``chunked.chunk_buckets``: every round of a chunk, and a batch of MSMs,
    as rows of one pass, buckets accumulated across chunks).  The rake runs
    over a combined lane axis of R * B lanes; row boundaries are lane
    boundaries.  The reference's two variadic sorts (a TPU workaround for
    slow gathers) are one stable sort and one gather here."""
    R = digR.shape[0]
    B = n // K
    Bp = R * B
    nb = 1 << c
    dev = packed16.device

    # sort: every row's (digit, source index) pairs at once
    sdR, idxR = torch.sort(digR, dim=1, stable=True)
    idxR = idxR + (torch.arange(R, device=dev) // rounds)[:, None] * n

    # rake: (R, n) rank-major -> (K, R*B) K-major (lane = r*B + b)
    def kmajor(x):
        return x.reshape(R, B, K).permute(2, 0, 1).reshape(K, Bp)

    sdk = kmajor(sdR)
    colk = kmajor(idxR).reshape(K * Bp)
    scan = ops.rake_scan_packed(sdk, packed16.index_select(1, colk), Bp, K)

    # carries: run sums crossing lane boundaries within a row
    T = tuple(sc[:, (K - 1) * Bp:] for sc in scan)
    internal = (sdk[1:] != sdk[:-1]).any(0)
    heads = (torch.arange(Bp, device=dev) % B) == 0
    C = _block_carries_from(ops, sdk[0], sdk[K - 1], internal, T, heads)

    # tails: bucket edges from a histogram of the sorted digits
    rid = torch.arange(R, device=dev)[:, None]
    count = torch.bincount((sdR + rid * nb).reshape(-1),
                           minlength=R * nb).reshape(R, nb)
    edges = torch.cat([torch.zeros((R, 1), dtype=count.dtype, device=dev),
                       torch.cumsum(count, dim=1)], dim=1)
    jidx = torch.arange(nb, device=dev)[None]
    valid = (count > 0) & (jidx > 0)
    tc = torch.clamp(edges[:, 1:] - 1, 0, n - 1)
    kk = tc % K
    lane = rid * B + tc // K
    col = (kk * Bp + lane).reshape(R * nb)
    g = tuple(sc.index_select(1, col).reshape(-1, R, nb) for sc in scan)
    # the bucket's run began at or before its lane's first entry: the lane's
    # first run, so the carry into the lane belongs to it
    frj = edges[:, :-1] <= tc - kk
    cg = tuple(cc.index_select(1, lane.reshape(R * nb)).reshape(-1, R, nb)
               for cc in C)
    carry = ops.select(frj & valid, cg, ops.infinity((R, nb)))
    return ops.select(valid, ops.add_unsafe(g, carry), ops.infinity((R, nb)))


def _packed_round(ops, packed16, digits, acc, *, n: int, c: int, K: int):
    """One round on the packed branch: acc' = 2^c * acc + W (acc a width-1
    complete projective accumulator).  The body of ``msm_engine``'s packed
    branch and of the host-driven rounds of ``staged.py``."""
    nbuckets = 1 << c
    buckets = tuple(b[:, 0] for b in _packed_round_buckets(
        ops, packed16, digits[None], n=n, c=c, K=K))
    new_acc = ops.bucket_phase(buckets, nbuckets, acc, c)
    if new_acc is not None:
        # K4 also applied acc' = 2^c acc + W
        return new_acc
    W = _bucket_phase(ops, ops.j2c(buckets), nbuckets, min(64, nbuckets))
    return ops.c_add(ops.c_dbl_n(acc, c), W)


def msm_engine(ops, pts, scalars, n: int, c: int, block: int,
               bucket_block: int, return_jacobian: bool = True,
               nbits: int = 256):
    """Group-generic Pippenger.  pts: tuple of (*, n) planes (affine);
    scalars: (nbits/16, n) canonical limb planes.  Width-1 group element
    (Jacobian by default; ``return_jacobian=False`` keeps the complete
    projective representation)."""
    rounds = nbits // c
    nbuckets = 1 << c
    K = block
    B = n // K
    dev = scalars.device

    packed = ops.pack_affine(pts) if (B % 1024 == 0 and B >= 1024) else None
    jidx = torch.arange(nbuckets, device=dev)
    acc = ops.c_infinity((1,))
    for ri in range(rounds - 1, -1, -1):
        d = window(scalars, c, ri)
        if packed is not None:
            acc = _packed_round(ops, packed, d, acc, n=n, c=c, K=K)
            continue

        perm = torch.sort(d, stable=True).indices
        sd = d[perm]
        spts = tuple(p.index_select(-1, perm) for p in pts)
        scan, C, fr, _ = _rake_segment_scan(ops, sd, spts, B, K)
        # bucket fill by gather: digit j's run tail sits at edges[j+1] - 1,
        # where edges[j] = #digits < j
        edges = torch.searchsorted(sd, torch.arange(nbuckets + 1, device=dev))
        count_j = edges[1:] - edges[:-1]
        valid = (count_j > 0) & (jidx > 0)
        tc = torch.clamp(edges[1:] - 1, 0, n - 1)
        g = tuple(s.reshape(s.shape[:-2] + (n,)).index_select(-1, tc)
                  for s in scan)
        cg = tuple(cc.index_select(-1, tc // K) for cc in C)
        frj = fr.reshape(n)[tc]
        # first-run tails need the cross-lane carry added
        carry = ops.select(frj & valid, cg, ops.infinity((nbuckets,)))
        bt = ops.add_unsafe(g, carry)
        buckets = ops.select(valid, bt, ops.infinity((nbuckets,)))

        new_acc = ops.bucket_phase(buckets, nbuckets, acc, c)
        if new_acc is None:
            W = _bucket_phase(ops, ops.j2c(buckets), nbuckets, bucket_block)
            new_acc = ops.c_add(ops.c_dbl_n(acc, c), W)
        acc = new_acc
    return ops.c2j(acc) if return_jacobian else acc


def _msm_engine_glv(X, Y, scalars, curve: CurveSpec, n: int, c: int,
                    block: int, bucket_block: int, glv: bool = False):
    """The engine on the curve, through the GLV table when ``glv``: 2n
    entries with 128-bit scalars, half the rounds."""
    ops = JacobianOps(curve, X.device)
    if glv:
        (X, Y), scalars = glv_mod.glv_table((X, Y), scalars, curve)
        return msm_engine(ops, (X, Y), scalars, 2 * n, c, block, bucket_block,
                          nbits=128)
    return msm_engine(ops, (X, Y), scalars, n, c, block, bucket_block)


def msm(points, scalars, curve: CurveSpec, config: MSMConfig | None = None):
    """Multi-scalar multiplication.

    points: (X, Y) affine Montgomery limb planes (16, n), all finite and
            pairwise linearly independent (the prover's SRS contract, the
            reference's pippenger_unsafe requirement).
    scalars: (16, n') canonical (non-Montgomery) limb planes, n' <= n (the
             first n' points are used), or a list of such planes: a batch of
             MSMs sharing every pipeline pass.
    config: None (the chunked pipeline, geometry by size), or the engine's
            geometry for one scalar plane (a list still runs chunked, at
            the config's c and K).
    Returns a Jacobian point tuple of width 1 (width len(scalars) for a
    list).  Both paths pad n themselves (copies of point 0 with zero
    scalars).
    """
    from . import chunked

    X, _ = points
    if config is None or not torch.is_tensor(scalars):
        if config is None:
            n = (scalars.shape[1] if torch.is_tensor(scalars)
                 else max(s.shape[1] for s in scalars))
            config = default_config(n, X.is_cuda)
        return chunked.msm_chunked(points, scalars, curve, c=config.c,
                                   K=config.block, use_glv=config.glv)

    n = scalars.shape[1]
    if n > X.shape[1]:
        raise ValueError(f"{n} scalars for {X.shape[1]} points")
    X, Y = (p[:, :n] for p in points)
    use_glv = config.glv and glv_mod.glv_params(curve) is not None
    K = config.block
    # with GLV the engine sees 2n entries; keep them a multiple of K with
    # at least 2 rake lanes
    eff = 2 if use_glv else 1
    pad = (-(eff * n)) % K
    if pad or (eff * n) // K < 2:
        extra = pad if (eff * n) // K >= 2 else pad + K
        extra = -(-extra // eff)  # pad in table-input units
        X = torch.cat([X, X[:, :1].expand(-1, extra)], dim=1)
        Y = torch.cat([Y, Y[:, :1].expand(-1, extra)], dim=1)
        scalars = torch.cat([scalars, scalars.new_zeros((scalars.shape[0],
                                                         extra))], dim=1)
        n += extra
        if (-(eff * n)) % K:  # odd eff-pad rounding; top up one more K
            return msm((X, Y), scalars, curve, config)
    return _msm_engine_glv(X, Y, scalars, curve, n, config.c, config.block,
                           config.bucket_block, use_glv)
