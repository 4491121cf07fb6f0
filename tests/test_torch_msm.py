"""aztec_tpu_torch.msm against aztec_tpu.msm and the host golden.

- the rake's plain version (K3's twin) against the reference's
  ``_rake_scan_packed_xla`` at K=4, B=128, bit-exact, on table points and
  on edge lanes (runs, restarts, alternating digits, P = Q and P = -Q
  inside a run, coordinates 0, 1, p - 1);
- K5's step split over four lanes (``csrc/rake.cu`` ``rake_step4``) on the
  word-level model of the lazy arithmetic against K5's plain version on
  those edge lanes;
- the composed bucket phase over rounds (``pippenger._bucket_phase``) and
  ``_finish`` (bucket phase + Horner fold) on the IntModOps mock group,
  as tests/test_chunked.py does, and against the reference's ``_finish``;
- the GLV split against the reference's host split;
- whole MSMs of the committed dev-SRS table (tau^i * G) against
  (sum_i k_i tau^i) * G computed on the host (bench.py's golden rule),
  compared in affine.
"""

import functools
import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.curves.group_ops import IntModOps as JIntModOps
from aztec_tpu.curves.group_ops import JacobianOps as JJacobianOps
from aztec_tpu.curves.group_ops import _rake_scan_packed_xla
from aztec_tpu.curves.spec import BN254_G1 as JG1
from aztec_tpu.msm import chunked as jchunked
from aztec_tpu.msm import glv as jglv
from aztec_tpu_torch.curves.golden import BN254
from aztec_tpu_torch.curves.group_ops import IntModOps, JacobianOps
from aztec_tpu_torch.curves.io import jacobian_to_host
from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
from aztec_tpu_torch.ff import FQ, FR
from aztec_tpu_torch.ff import field_kernels as fk
from aztec_tpu_torch.msm import chunked, glv, pippenger, rake
from aztec_tpu_torch.numeric.bigint import ints_to_limbs, limbs_to_ints
from aztec_tpu_torch.srs.reference_string import DEV_TAU, load_point_table

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_group import _lazy_field  # noqa: E402

R_ORDER = BN254_G1.order
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _table(n):
    X, Y = load_point_table(n)
    return X.astype(np.int32), Y.astype(np.int32)


def test_rake_plain_matches_reference():
    K, B = 4, 128
    X, Y = _table(K * B)
    rng = np.random.default_rng(31)
    dig = np.sort(rng.integers(0, 3, size=(K, B)), axis=0).astype(np.uint32)
    port_ops = JacobianOps(BN254_G1, CPU)
    packed = port_ops.pack_affine((torch.from_numpy(X), torch.from_numpy(Y)))
    got = rake.rake_scan_packed_plain(torch.from_numpy(dig.astype(np.int64)),
                                      packed, B, K, FQ)
    before = dict(fk.LAUNCHES)
    wrapped = rake.rake_scan_packed(torch.from_numpy(dig.astype(np.int64)),
                                    packed, B, K, FQ)
    assert dict(fk.LAUNCHES) == before
    pk = packed.numpy().view(np.uint32).reshape(16, K, B // 128, 128)
    want = _rake_scan_packed_xla(JJacobianOps(JG1),
                                 jnp.asarray(dig.reshape(K, B // 128, 128)),
                                 jnp.asarray(pk), B, K)
    for g, w, v in zip(got, want, wrapped):
        w = np.asarray(w).reshape(16, K * B).astype(np.int64)
        assert np.array_equal(g.numpy().astype(np.int64), w)
        assert torch.equal(g, v)


def _rake_edge_lanes(spec, B, K, seed=5):
    """K3's inputs (digits (K, B), packed points (16, K * B), K-major) for
    B lanes of K steps of canonical random coordinates, the lanes cycling
    through: one run of all K digits, a restart at every step, alternating
    digits, runs of two whose second point equals the first (P = Q: the
    first step restarts with Z = 1) or is its negative (P = -Q),
    coordinates drawn from {0, 1, p - 1}, and sorted random digits."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    X, Y = (rng.integers(0, 1 << 16, (16, K, B)) for _ in range(2))
    for c in (X, Y):                       # top limb below p's: canonical
        c[15] = rng.integers(0, 0x3064, (K, B))
    k = np.broadcast_to(np.arange(K)[:, None], (K, B))
    kind = np.broadcast_to(np.arange(B)[None, :] % 7, (K, B))
    dig = np.select([kind == 0, kind == 1, kind == 2, (kind == 3) | (kind == 4)],
                    [5, k, k % 2, k // 2],
                    np.sort(rng.integers(0, 4, (K, B)), axis=0))
    pair = (k % 2 == 1) & ((kind == 3) | (kind == 4))
    X[:, pair] = np.roll(X, 1, axis=1)[:, pair]
    Y[:, pair] = np.roll(Y, 1, axis=1)[:, pair]
    neg = pair & (kind == 4)
    Y[:, neg] = ints_to_limbs([-v % p for v in limbs_to_ints(Y[:, neg])])
    special = ints_to_limbs([0, 1, p - 1])
    edge = kind == 5
    for c in (X, Y):
        c[:, edge] = special[:, rng.integers(0, 3, int(edge.sum()))]
    curve = BN254_G1 if spec is FQ else GRUMPKIN_G1
    packed = JacobianOps(curve, CPU).pack_affine(
        tuple(torch.from_numpy(c.reshape(16, K * B).astype(np.int32))
              for c in (X, Y)))
    return dig.astype(np.uint32), packed


def test_rake_plain_matches_reference_on_edge_lanes():
    """The K3 plain version the kernel is held against on the card equals
    the reference's on the edge lanes, bit for bit (K=4, B=128: the shape
    of the test above, so the reference's compiled scan is reused)."""
    K, B = 4, 128
    dig, packed = _rake_edge_lanes(FQ, B, K)
    got = rake.rake_scan_packed_plain(torch.from_numpy(dig.astype(np.int64)),
                                      packed, B, K, FQ)
    pk = packed.numpy().view(np.uint32).reshape(16, K, B // 128, 128)
    want = _rake_scan_packed_xla(JJacobianOps(JG1),
                                 jnp.asarray(dig.reshape(K, B // 128, 128)),
                                 jnp.asarray(pk), B, K)
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(16, K * B).astype(np.int64)
        assert np.array_equal(g.numpy().astype(np.int64), w)
    # the lanes reach the cases they name: P = Q leaves Z = 0 after the
    # pair's second step, and the step after restarts with Z = 1
    Z = got[2].numpy().reshape(16, K, B)
    assert not Z[:, 1, 3].any() and not Z[:, 1, 4].any()
    assert np.array_equal(Z[:, 2, 3], ints_to_limbs([FQ.R % FQ.modulus])[:, 0])


def _lazy_rake_step4(f, p, one, acc, prevd, dk, X2, Y2):
    """csrc/rake.cu ``rake_step4``: lane r computes one product a level;
    every lane forms the sums from the products shuffled in."""
    mul, add, sub, _ = f
    X1, Y1, Z1 = acc
    lanes = range(4)
    m1 = [mul(Y2 if r == 1 else Z1, Z1) for r in lanes]
    Z1Z1, YZ = m1[0], m1[1]
    m2 = [mul(YZ if r == 1 else X2, Z1Z1) for r in lanes]
    H = sub(m2[0], X1)
    R = sub(m2[1], Y1)
    R = add(R, R)
    ops3 = [H if r == 0 else (add(Z1, H) if r == 1 else R) for r in lanes]
    HH, ZH, RR, _ = [mul(o, o) for o in ops3]
    I = add(HH, HH)
    I = add(I, I)
    m4 = [mul(X1 if r == 1 else H, I) for r in lanes]
    J, V = m4[0], m4[1]
    X3 = sub(sub(RR, J), add(V, V))
    m5 = [mul(Y1 if r == 1 else R, J if r == 1 else sub(V, X3))
          for r in lanes]
    Y3 = sub(m5[0], add(m5[1], m5[1]))
    Z3 = sub(sub(ZH, Z1Z1), HH)
    if dk != prevd or Z1 == 0:
        return (X2, Y2, one)
    return tuple(v - p if v >= p else v for v in (X3, Y3, Z3))


@pytest.mark.parametrize("spec", [FR, FQ], ids=["fr", "fq"])
def test_k5_four_lane_step_matches_plain(spec):
    """K5's lazy kernel splits each mixed add over four lanes; on the
    word-level model of the lazy arithmetic (every value kept in [0, 2p))
    its partials equal K5's plain version's on the edge lanes (runs,
    restarts, alternating digits, P = Q, P = -Q, coordinates 0, 1, p - 1),
    bit for bit."""
    K, B = 6, 14
    p = spec.modulus
    dig, packed = _rake_edge_lanes(spec, B, K, seed=8)
    X, Y = rake.unpack(packed)
    nord = torch.arange(K * B).reshape(K, B).T.reshape(-1)
    sd = torch.from_numpy(dig.astype(np.int64)).T.reshape(-1)
    want = rake.rake_scan_plain(sd, (X[:, nord], Y[:, nord]), B, K, spec)
    want = [limbs_to_ints(w.reshape(16, -1).numpy().astype(np.uint32))
            for w in want]
    xs, ys = (limbs_to_ints(c[:, nord].numpy().astype(np.uint32))
              for c in (X, Y))
    f = _lazy_field(p)
    one = spec.R % p
    for b in range(B):
        acc, prevd = (0, 0, 0), rake.SENTINEL
        for k in range(K):
            j = b * K + k
            acc = _lazy_rake_step4(f, p, one, acc, prevd, int(sd[j]), xs[j],
                                   ys[j])
            prevd = int(sd[j])
            assert acc == tuple(w[j] for w in want)


def test_pack_affine_matches_reference():
    X, Y = _table(64)
    got = JacobianOps(BN254_G1, CPU).pack_affine(
        (torch.from_numpy(X), torch.from_numpy(Y)))
    want = JJacobianOps(JG1).pack_affine(
        (jnp.asarray(X.astype(np.uint32)), jnp.asarray(Y.astype(np.uint32))),
        force=True)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    Xu, Yu = rake.unpack(got)
    assert np.array_equal(Xu.numpy(), X) and np.array_equal(Yu.numpy(), Y)


@pytest.mark.parametrize("R,c_bits", [(8, 16), (2, 16), (16, 8), (32, 4)])
def test_bucket_phase_batched_mock(R, c_bits):
    m = 1_000_003
    nb = 1 << c_bits
    rng = np.random.default_rng(11)
    Bk = rng.integers(0, m, (1, R, nb), dtype=np.int64)
    W = pippenger._bucket_phase(IntModOps(m), (torch.from_numpy(Bk),), nb,
                                min(64, nb // 1024 or 1))
    j = np.arange(nb, dtype=np.int64)
    expect = (Bk[0] * j[None, :] % m).sum(axis=1) % m
    assert np.array_equal(W[0][0, :, 0].numpy(), expect)


def test_finish_horner_mock_matches_reference():
    m = 1_000_003
    R, c = 4, 16
    nb = 1 << c
    rng = np.random.default_rng(12)
    Bk = rng.integers(0, m, (1, R, nb), dtype=np.uint32)
    out = chunked._finish(IntModOps(m), (torch.from_numpy(Bk.astype(np.int64)),),
                          R, c, nb, return_jacobian=False)
    got = int(out[0][0, 0])
    j = np.arange(nb, dtype=object)
    W = [(int((Bk[0, r].astype(object) * j).sum()) % m) for r in range(R)]
    assert got == sum((1 << (c * r)) * W[r] for r in range(R)) % m
    want = jchunked._finish(JIntModOps(m), (jnp.asarray(Bk),), R, c, nb,
                            return_jacobian=False)
    assert got == int(np.asarray(want[0])[0, 0])


def test_finish_batch_equals_separate_mock():
    m = 1_000_003
    R, c = 8, 4
    nb = 1 << c
    rng = np.random.default_rng(13)
    Bk = torch.from_numpy(rng.integers(0, m, (1, 3 * R, nb), dtype=np.int64))
    ops = IntModOps(m)
    batched = chunked._finish(ops, (Bk,), R, c, nb, False, batch=3)[0]
    for i in range(3):
        one = chunked._finish(ops, (Bk[:, i * R:(i + 1) * R],), R, c, nb,
                              False)[0]
        assert int(batched[0, i]) == int(one[0, 0])


def test_glv_split_matches_reference():
    """The batched split equals the reference's host split (which its
    device split is tested against in tests/test_msm.py)."""
    rng = random.Random(41)
    ks = [0, 1, R_ORDER - 1] + [rng.randrange(R_ORDER) for _ in range(61)]
    S = ints_to_limbs(ks)
    k1a, n1, k2a, n2 = glv.glv_split(torch.from_numpy(S.astype(np.int32)),
                                     BN254_G1)
    assert glv.glv_params(BN254_G1) == jglv.glv_params(JG1)
    for i, k in enumerate(ks):
        k1 = int(sum(int(v) << (16 * j) for j, v in enumerate(k1a[:, i])))
        k2 = int(sum(int(v) << (16 * j) for j, v in enumerate(k2a[:, i])))
        k1 = -k1 if n1[i] else k1
        k2 = -k2 if n2[i] else k2
        assert (k1, k2) == jglv.split_scalar_host(k, JG1)


M32 = (1 << 32) - 1


def _glv_kernel_split(limbs, consts):
    """csrc/glv.cu's split of one scalar (16 limbs of 16 bits), word for
    word as ``glv_table_kernel`` orders it: each Babai product k m_h kept
    mod 2^544 a row of 32 x 32-bit products at a time, + 2^415 at bit 31 of
    word 12, c_h = words 13-16; k1 = k + c_1 A_1 + c_2 A_2 and k2 = c_1 B_1
    + c_2 B_2 in five words (mod 2^160), each term a row a word of c_h;
    then bit 159 and the low 128 bits of the magnitude.  ``consts`` are
    ``glv.kernel_consts``.  Returns (|k1| limbs, neg1, |k2| limbs, neg2, c)."""
    mw, sw = glv.MAGIC_WORDS, glv.SPLIT_WORDS
    k = [(limbs[2 * i] & 0xFFFF) | (limbs[2 * i + 1] << 16) for i in range(8)]
    rest = list(consts[8:])
    magic = [rest[:mw], rest[mw:2 * mw]]
    coef = [rest[2 * mw + i * sw:2 * mw + (i + 1) * sw] for i in range(4)]
    c = []
    for h in range(2):
        t = [0] * mw
        for i in range(8):
            carry = 0
            for w in range(mw - i):
                s = k[i] * magic[h][w] + t[i + w] + carry
                assert s <= (1 << 64) - 1
                t[i + w], carry = s & M32, s >> 32
        carry = (t[12] + 0x80000000) >> 32
        ch = []
        for w in range(4):
            s = t[13 + w] + carry
            ch.append(s & M32)
            carry = s >> 32
        c.append(ch)

    def mac(acc, ch, a):
        for i in range(4):
            carry = 0
            for j in range(sw - i):
                s = ch[i] * a[j] + acc[i + j] + carry
                assert s <= (1 << 64) - 1
                acc[i + j], carry = s & M32, s >> 32

    k1, k2 = k[:sw], [0] * sw
    for h in range(2):
        mac(k1, c[h], coef[h])
        mac(k2, c[h], coef[2 + h])

    def abs128(v):
        neg = v[sw - 1] >> 31
        carry, mag = 1, []
        for w in range(4):
            s = (~v[w] & M32) + carry
            carry = s >> 32
            mag.append(s & M32 if neg else v[w])
        return [x for w in mag for x in (w & 0xFFFF, w >> 16)], bool(neg)

    return (*abs128(k1), *abs128(k2),
            [sum(w << (32 * i) for i, w in enumerate(ch)) for ch in c])


def _glv_edge_scalars(curve, count, seed):
    """Scalars 0, 1, r - 1, r, lambda, 2^256 - 1 (all 0xFFFF limbs), both
    sides of a Babai rounding edge of each magic (the k where c_h steps
    up: (2c + 1) 2^415 / m_h, rounded up, and one below), then random
    values below r and below 2^256 (the edges lie below r)."""
    P = glv.glv_params(curve)
    r = curve.order
    rng = random.Random(seed)
    ks = [0, 1, r - 1, r, P["lam"], (1 << 256) - 1]
    for m in P["magics"]:
        top = (m * r) >> 416          # c_h of a k just below r
        for c in (1, rng.randrange(1, top), top - 1):
            edge = -(-((2 * c + 1) << 415) // m)
            ks += [edge, edge - 1]
    while len(ks) < count:
        ks.append(rng.randrange(r) if len(ks) % 2 else
                  rng.randrange(1 << 256))
    return ks


@pytest.mark.parametrize("curve", [BN254_G1, GRUMPKIN_G1],
                         ids=["bn254", "grumpkin"])
def test_glv_kernel_split_model_matches_plain(curve):
    """The word-level model of the kernel's split equals ``glv_split`` limb
    for limb on the edge scalars (at and above r too), its c_h equals
    ((k m_h + 2^415) >> 416) mod 2^128, and below r the signed halves equal
    ``split_scalar_host``'s."""
    P = glv.glv_params(curve)
    consts = glv.kernel_consts(curve)
    assert len(consts) == 8 + 2 * glv.MAGIC_WORDS + 4 * glv.SPLIT_WORDS
    ks = _glv_edge_scalars(curve, 96, 43)
    S = ints_to_limbs(ks)
    k1a, n1, k2a, n2 = glv.glv_split(torch.from_numpy(S.astype(np.int32)),
                                     curve)
    for i, k in enumerate(ks):
        a1, neg1, a2, neg2, c = _glv_kernel_split(
            [int(v) for v in S[:, i]], consts)
        assert c == [((k * m + (1 << 415)) >> 416) % (1 << 128)
                     for m in P["magics"]]
        assert a1 == k1a[:, i].tolist() and neg1 == bool(n1[i])
        assert a2 == k2a[:, i].tolist() and neg2 == bool(n2[i])
        if k < curve.order:
            v1 = sum(x << (16 * j) for j, x in enumerate(a1))
            v2 = sum(x << (16 * j) for j, x in enumerate(a2))
            assert ((-v1 if neg1 else v1, -v2 if neg2 else v2)
                    == glv.split_scalar_host(k, curve))


def test_glv_table_on_cpu_runs_plain():
    """On CPU tensors ``glv_table`` is ``glv_table_plain`` and launches
    nothing."""
    n = 40
    X, Y = (torch.from_numpy(a[:, :n]) for a in _table(n))
    S = torch.from_numpy(ints_to_limbs(_glv_edge_scalars(BN254_G1, n, 44))
                         .astype(np.int32))
    before = dict(fk.LAUNCHES)
    (Xt, Yt), St = glv.glv_table((X, Y), S, BN254_G1)
    assert dict(fk.LAUNCHES) == before
    (Xp, Yp), Sp = glv.glv_table_plain((X, Y), S, BN254_G1)
    for a, b in ((Xt, Xp), (Yt, Yp), (St, Sp)):
        assert torch.equal(a, b)


def _glv_edge_points(spec, w, seed):
    """(X, Y) (16, w) planes whose lanes cycle through 0, p - 1, p, 2p - 1,
    all 0xFFFF and a canonical random element, X and Y out of step."""
    rng = random.Random(seed)
    p = spec.modulus
    edge = [0, p - 1, p, 2 * p - 1, (1 << 256) - 1]

    def plane(shift):
        return ints_to_limbs([edge[(i + shift) % 6] if (i + shift) % 6 < 5
                              else rng.randrange(p) for i in range(w)])

    return (torch.from_numpy(plane(0).astype(np.int32)),
            torch.from_numpy(plane(2).astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 33, 8192 + 5, (1 << 17) + 5])
@pytest.mark.parametrize("curve", [BN254_G1, GRUMPKIN_G1],
                         ids=["bn254", "grumpkin"])
def test_glv_table_kernel_matches_plain_on_card(curve, w):
    """One launch of ``glv_table_kernel`` equals ``glv_table_plain`` on
    every output plane, bit for bit, on the edge scalars and the edge
    points (0, p - 1, p, 2p - 1, all 0xFFFF), read as a column slice of
    wider planes as the chunked MSM's ``prep`` passes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    X, Y = _glv_edge_points(curve.field, w + 7, 45)
    S = torch.from_numpy(ints_to_limbs(_glv_edge_scalars(curve, w + 7, 46))
                         .astype(np.int32))
    X, Y, S = (t.cuda() for t in (X, Y, S))
    lo, hi = 3, 3 + w
    pts, sc = (X[:, lo:hi], Y[:, lo:hi]), S[:, lo:hi]
    before = fk.LAUNCHES["glv_table"]
    (Xt, Yt), St = glv.glv_table(pts, sc, curve)
    assert fk.LAUNCHES["glv_table"] == before + 1
    (Xp, Yp), Sp = glv.glv_table_plain(pts, sc, curve)
    for a, b in ((Xt, Xp), (Yt, Yp), (St, Sp)):
        assert a.dtype == b.dtype and torch.equal(a, b.to(a.dtype))


@pytest.mark.parametrize("n,tail", [(1 << 20, 0), ((1 << 17) + 1, 1),
                                    (259, 3), (300, 0), (16, 0), (1, 0)])
def test_geometry(n, tail):
    lg, K, full, t = chunked.geometry_for(n, True)
    chunk = 1 << lg
    assert t == tail
    assert full * chunk + t >= n and (full - 1) * chunk + t < n
    assert lg <= chunked.CHUNK_LOG2 and (2 * chunk) % K == 0


def _golden(scalars, n):
    kk, t = 0, 1
    for k in scalars[:n]:
        kk = (kk + k * t) % R_ORDER
        t = t * DEV_TAU % R_ORDER
    return BN254.mul(kk, BN254.gen)


@pytest.mark.parametrize("sizes,c", [((256,), 4), ((259, 257), 8)])
def test_msm_matches_golden(sizes, c):
    n = max(sizes)
    X, Y = (torch.from_numpy(a) for a in _table(n))
    rng = random.Random(sum(sizes) + c)
    ks = [[rng.randrange(R_ORDER) for _ in range(m)] for m in sizes]
    S = [torch.from_numpy(ints_to_limbs(k).astype(np.int32)) for k in ks]
    arg = S[0] if len(S) == 1 else S
    P = chunked.msm_chunked((X, Y), arg, BN254_G1, c=c, K=16)
    got = jacobian_to_host(P, BN254_G1)
    assert got == [_golden(k, m) for k, m in zip(ks, sizes)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 128, 4096 + 5])
@pytest.mark.parametrize("spec", [FR, FQ], ids=["fr", "fq"])
def test_k3_rake_edge_lanes_on_card(spec, B):
    """The redesigned K3 (lazy mixed add, canonical accumulator) equals its
    plain version on the edge lanes for K in {1, 4, 64}."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for K in (1, 4, 64):
        dig, packed = _rake_edge_lanes(spec, B, K)
        dig = torch.from_numpy(dig.astype(np.int64))
        got = rake.rake_scan_packed(dig.cuda(), packed.cuda(), B, K, spec)
        want = rake.rake_scan_packed_plain(dig, packed, B, K, spec)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 127, 128, 1000, 4096 + 5])
@pytest.mark.parametrize("spec", [FR, FQ], ids=["fr", "fq"])
def test_k5_rake_edge_lanes_on_card(spec, B):
    """The redesigned K5 (four lanes a point, the next entry loaded ahead,
    the exact kernel for flagged lanes) equals its plain version on the
    edge lanes, with the top limb of some points set to 0xFFFF (at or
    above p) in the middle of a run, for K in {1, 4, 32, 64}."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for K in (1, 4, 32, 64):
        dig, packed = _rake_edge_lanes(spec, B, K)
        X, Y = rake.unpack(packed)
        nord = torch.arange(K * B).reshape(K, B).T.reshape(-1)
        X, Y = X[:, nord].clone(), Y[:, nord].clone()
        X[15, K // 2::5 * K + 3] = 0xFFFF
        sd = torch.from_numpy(dig.astype(np.int64)).T.reshape(-1)
        got = rake.rake_scan(sd.cuda(), (X.cuda(), Y.cuda()), B, K, spec)
        want = rake.rake_scan_plain(sd, (X, Y), B, K, spec)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_k3_rake_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    K, B = 64, 1024
    X, Y = (torch.from_numpy(a).cuda() for a in _table(K * B))
    dig = torch.sort(torch.randint(0, 4, (K, B), device="cuda"), dim=0).values
    packed = JacobianOps(BN254_G1, X.device).pack_affine((X, Y))
    for a, b in zip(rake.rake_scan_packed(dig, packed, B, K, FQ),
                    rake.rake_scan_packed_plain(dig, packed, B, K, FQ)):
        assert torch.equal(a, b)
