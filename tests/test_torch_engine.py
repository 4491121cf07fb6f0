"""aztec_tpu_torch's MSM engine (msm/pippenger.py, msm/staged.py) and the
plain versions of its kernels K4 (msm/bucket.py) and K5 (msm/rake.py).

- the engine on the mock group (Z_m, +) against exact integer sums, on the
  cases of tests/test_msm.py, and against aztec_tpu's engine on its mock;
- K4's plain version on the mock against aztec_tpu's composed bucket phase,
  and on BN254 against the host golden sum_j j * B_j (+ 2^c acc), in affine;
- K5's plain version against aztec_tpu's rake composition, bit-exact;
- the EC engine (GLV, c = 4) and one packed round (c = 8) against the host
  golden, compared in affine.

Inputs are made from seeds with numpy and ``random``.  The plain group
formulas are slow on the CPU, so every EC case stays at a few hundred
entries; packed rounds with K4 at c = 16 run only on the card
(``chip_smoke.py``), and the ``cuda`` cases below hold K4 and K5 against
their plain versions there.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.curves.group_ops import IntModOps as JIntModOps
from aztec_tpu.curves.group_ops import JacobianOps as JJacobianOps
from aztec_tpu.curves.spec import BN254_G1 as JG1
from aztec_tpu.msm import pippenger as jpp
from aztec_tpu_torch.curves import group
from aztec_tpu_torch.curves.golden import BN254
from aztec_tpu_torch.curves.group_ops import IntModOps, JacobianOps
from aztec_tpu_torch.curves.io import jacobian_to_host, planes_to_ints
from aztec_tpu_torch.curves.spec import BN254_G1
from aztec_tpu_torch.ff import FQ, limb
from aztec_tpu_torch.ff import field_kernels as fk
from aztec_tpu_torch.msm import bucket, chunked, glv, pippenger, rake, staged
from aztec_tpu_torch.msm.pippenger import MSMConfig, msm, msm_engine
from aztec_tpu_torch.numeric.bigint import ints_to_limbs
from aztec_tpu_torch.srs.reference_string import DEV_TAU, load_point_table

M = 1_000_003
ORDER = BN254_G1.order
q = FQ.modulus
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


# -- the engine on the mock group --------------------------------------------


def _mock_inputs(n, scalars, vals, block):
    """The reference test's padding: zero scalars on value-1 entries."""
    pad = (-n) % block
    extra = pad if n // block >= 2 else pad + block
    extra = extra if pad or n // block < 2 else 0
    S = torch.from_numpy(ints_to_limbs(list(scalars) + [0] * extra)
                         .astype(np.int32))
    V = torch.tensor([list(vals) + [1] * extra], dtype=torch.int64)
    return S, V, n + extra


def _run_mock(n, scalars, vals, c, block, bb):
    S, V, n = _mock_inputs(n, scalars, vals, block)
    out = msm_engine(IntModOps(M), (V,), S, n, c, block, bb)
    assert int(out[0][0, 0]) == sum(k * v for k, v in zip(scalars, vals)) % M
    return S, V, n, int(out[0][0, 0])


@pytest.mark.parametrize("c,block,bb", [(4, 16, 4), (8, 32, 16), (16, 32, 64),
                                        (16, 64, 64)])
def test_engine_mock_random(c, block, bb):
    rng = random.Random(100 * c + block)
    n = 4 * block + 7
    _run_mock(n, [rng.randrange(ORDER) for _ in range(n)],
              [rng.randrange(1, M) for _ in range(n)], c, block, bb)


ADVERSARIAL = ("zero", "max", "one", "runs", "interleaved")


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_engine_mock_adversarial_digits(case):
    rng = random.Random(ADVERSARIAL.index(case))
    c, block, bb = 8, 16, 16
    n = 8 * block
    scalars = {
        "zero": lambda: [0] * n,
        "max": lambda: [ORDER - 1] * n,
        "one": lambda: [1] * n,
        "runs": lambda: [rng.choice([0, 5, 5 << 8, 0xFF]) for _ in range(n)],
        "interleaved": lambda: [(i % 3) * 0x0101010101010101
                                for i in range(n)],
    }[case]()
    _run_mock(n, scalars, [rng.randrange(1, M) for _ in range(n)], c, block, bb)


def test_engine_mock_segment_spanning_blocks():
    rng = random.Random(7)
    c, block, bb = 4, 16, 4
    n = 6 * block
    scalars = [7] * (n - 5) + [rng.randrange(ORDER) for _ in range(5)]
    _run_mock(n, scalars, [rng.randrange(1, M) for _ in range(n)], c, block, bb)


def test_engine_mock_matches_reference():
    rng = random.Random(8)
    c, block, bb = 4, 16, 4
    n = 4 * block + 7
    S, V, n_pad, got = _run_mock(n, [rng.randrange(ORDER) for _ in range(n)],
                                 [rng.randrange(1, M) for _ in range(n)],
                                 c, block, bb)
    want = jpp.msm_engine(JIntModOps(M),
                          (jnp.asarray(V.numpy().astype(np.uint32)),),
                          jnp.asarray(S.numpy().astype(np.uint32)), n_pad, c,
                          block, bb)
    assert got == int(np.asarray(want[0]).reshape(-1)[0])


# -- K4's plain version --------------------------------------------------------


@pytest.mark.parametrize("nb", [1024, 4096])
@pytest.mark.parametrize("with_acc", [False, True])
def test_bucket_plain_mock_matches_reference(nb, with_acc):
    rng = np.random.default_rng(nb + with_acc)
    Bk = rng.integers(0, M, (1, nb), dtype=np.int64)
    acc, steps = ((torch.tensor([[4321]]),), 16) if with_acc else (None, 0)
    before = dict(fk.LAUNCHES)
    got = bucket.bucket_phase_plain(IntModOps(M), (torch.from_numpy(Bk),), nb,
                                    acc, steps)
    assert IntModOps(M).bucket_phase((torch.from_numpy(Bk),), nb) is None
    jops = JIntModOps(M)
    want = jpp._bucket_phase(jops, (jnp.asarray(Bk.astype(np.uint32)),), nb,
                             64)
    if with_acc:
        want = jops.c_add(jops.c_dbl_n((jnp.asarray([[4321]], jnp.uint32),),
                                       steps), want)
    assert int(got[0][0, 0]) == int(np.asarray(want[0])[0, 0])
    j = np.arange(nb, dtype=object)
    expect = (int((Bk[0].astype(object) * j).sum())
              + (4321 << steps if with_acc else 0)) % M
    assert int(got[0][0, 0]) == expect
    assert dict(fk.LAUNCHES) == before


def _mont(vals):
    return torch.from_numpy(ints_to_limbs([v * FQ.R % q for v in vals])
                            .astype(np.int32))


def _jacobian(ks, rng):
    """Points k_i * G as Jacobian planes with random Z; k = 0 -> Z = 0."""
    pts = []
    step = BN254.mul(int(ks[1] - ks[0]) % ORDER, BN254.gen)
    cur = BN254.mul(int(ks[0]), BN254.gen)
    for _ in ks:                       # ks is an arithmetic progression
        pts.append(cur)
        cur = BN254.add(cur, step)
    zs = [int(z) % q or 1 for z in rng.integers(1, 1 << 62, len(ks))]
    X = [0 if p is None else p[0] * z * z % q for p, z in zip(pts, zs)]
    Y = [0 if p is None else p[1] * z ** 3 % q for p, z in zip(pts, zs)]
    Z = [0 if p is None else z for p, z in zip(pts, zs)]
    return tuple(_mont(v) for v in (X, Y, Z))


def _to_host(P):
    """A complete projective width-1 point -> affine ints or None."""
    return jacobian_to_host(group.proj_to_jacobian(P, FQ), BN254_G1)[0]


@pytest.mark.parametrize("nb", [1024, 2048])
@pytest.mark.parametrize("with_acc", [False, True])
def test_bucket_plain_matches_golden(nb, with_acc):
    rng = np.random.default_rng(nb + 2 * with_acc)
    k0, d = (int(x) for x in rng.integers(1, 1 << 62, 2))
    ks = [(k0 + j * d) % ORDER for j in range(nb)]
    Bj = _jacobian(ks, rng)
    inf = rng.random(nb) < 1 / 16
    Bj = tuple(torch.where(torch.from_numpy(inf)[None], 0, p) for p in Bj)
    total = sum(j * k for j, (k, z) in enumerate(zip(ks, inf)) if not z)
    acc, steps = None, 0
    if with_acc:
        ka = int(rng.integers(1, 1 << 62))
        x, y = BN254.mul(ka, BN254.gen)
        acc = tuple(_mont([v]) for v in (x, y, 1))
        steps = nb.bit_length() - 1
        total += ka << steps
    got = bucket.bucket_phase(Bj, nb, FQ, BN254_G1.b, acc, steps)
    assert _to_host(got) == BN254.mul(total % ORDER, BN254.gen)


# -- K5's plain version --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _table(n):
    X, Y = load_point_table(n)
    return X.astype(np.int32), Y.astype(np.int32)


class _ScanOnlyOps(JJacobianOps):
    """aztec_tpu's Jacobian ops with ``add_unsafe`` stubbed out: only the
    cross-lane carries of ``_rake_segment_scan`` read it, not its scan
    output, and the stub saves an XLA:CPU compile of the 256-bit add."""

    def add_unsafe(self, P, Q):
        return P


def test_rake_scan_plain_matches_reference():
    K, B = 4, 128
    X, Y = _table(K * B)
    rng = np.random.default_rng(33)
    sd = np.sort(rng.integers(0, 9, size=K * B)).astype(np.uint32)
    pts = (torch.from_numpy(X), torch.from_numpy(Y))
    got = rake.rake_scan_plain(torch.from_numpy(sd.astype(np.int64)), pts, B,
                               K, FQ)
    scan, _, fr, _ = jpp._rake_segment_scan(
        _ScanOnlyOps(JG1), jnp.asarray(sd),
        (jnp.asarray(X.astype(np.uint32)), jnp.asarray(Y.astype(np.uint32))),
        B, K)
    for g, w in zip(got, scan):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))
    # the same partials as K3's plain version on the K-major packed layout
    ops = JacobianOps(BN254_G1, CPU)
    km = torch.arange(K * B).reshape(B, K).T.reshape(-1)   # K-major order
    packed = ops.pack_affine(tuple(p[:, km] for p in pts))
    dig_k = torch.from_numpy(sd.astype(np.int64))[km].reshape(K, B)
    for g, p in zip(got, rake.rake_scan_packed_plain(dig_k, packed, B, K,
                                                     FQ)):
        assert torch.equal(g, p.reshape(16, K, B).transpose(1, 2))
    # the engine's first-run mask over the same stream equals the reference's
    sdb = torch.from_numpy(sd.astype(np.int64)).reshape(B, K)
    assert np.array_equal((sdb == sdb[:, :1]).numpy(), np.asarray(fr))


# -- the EC engine -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ec_case():
    """70 random points (distinct multiples of G), two special scalars."""
    rng = random.Random(31337)
    n = 70
    pts = [BN254.mul(rng.randrange(1, ORDER), BN254.gen) for _ in range(n)]
    scalars = [rng.randrange(ORDER) for _ in range(n)]
    scalars[3] = 0
    scalars[10] = 1
    expect = None
    for k, p in zip(scalars, pts):
        expect = BN254.add(expect, BN254.mul(k, p))
    X = _mont([p[0] for p in pts])
    Y = _mont([p[1] for p in pts])
    return (X, Y), torch.from_numpy(ints_to_limbs(scalars).astype(np.int32)), \
        expect


@pytest.mark.parametrize("path", ["engine", "chunked"])
def test_ec_msm_matches_golden(path):
    pts, S, expect = _ec_case()
    if path == "engine":
        P = msm(pts, S, BN254_G1, MSMConfig(c=4, block=16, bucket_block=4,
                                            glv=True))
    else:
        P = chunked.msm_chunked(pts, S, BN254_G1, c=4, K=16)
    assert jacobian_to_host(P, BN254_G1)[0] == expect


def test_packed_round_matches_golden():
    """One round of the packed branch at c = 8 on a 1024-point GLV table
    (2048 entries, K = 2, B = 1024; 256 buckets, so the composed bucket
    phase), acc' = 2^8 acc + W, against the host golden; ``staged.geometry``
    takes it."""
    n, c, K, ri = 1024, 8, 2, 5
    X, Y = (torch.from_numpy(a) for a in _table(n))
    rng = random.Random(55)
    S = torch.from_numpy(ints_to_limbs([rng.randrange(ORDER) for _ in range(n)])
                         .astype(np.int32))
    (Xt, Yt), St = glv.glv_table((X, Y), S, BN254_G1)
    assert staged.geometry(2 * n, c, K)
    ops = JacobianOps(BN254_G1, CPU)
    d = pippenger.window(St, c, ri)
    ka = rng.randrange(1, ORDER)
    acc_pt = BN254.mul(ka, BN254.gen)
    acc = tuple(_mont([v]) for v in (*acc_pt, 1))
    got = pippenger._packed_round(ops, ops.pack_affine((Xt, Yt)), d, acc,
                                  n=2 * n, c=c, K=K)
    xs = planes_to_ints(limb.from_mont(Xt, FQ))
    ys = planes_to_ints(limb.from_mont(Yt, FQ))
    buckets = [None] * (1 << c)
    for x, y, j in zip(xs, ys, d.tolist()):
        buckets[j] = BN254.add(buckets[j], (x, y))
    run, W = None, None
    for j in range((1 << c) - 1, 0, -1):      # sum_j j B_j by suffix sums
        run = BN254.add(run, buckets[j])
        W = BN254.add(W, run)
    assert _to_host(got) == BN254.add(BN254.mul(1 << c, acc_pt), W)


# -- the kernels on the card ---------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("nb,steps", [(1024, 0), (1 << 16, 16)])
def test_k4_bucket_matches_plain_on_card(nb, steps):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(nb)
    dev = torch.device("cuda")

    def planes(w):
        x = rng.integers(0, 1 << 16, (16, w)).astype(np.int32)
        x[15] %= 0x3064
        return torch.from_numpy(x).to(dev)

    bk = (planes(nb), planes(nb), planes(nb))
    bk[2][:, ::16] = 0
    acc = tuple(planes(1) for _ in range(3)) if steps else None
    got = bucket.bucket_phase(bk, nb, FQ, BN254_G1.b, acc, steps)
    want = bucket.bucket_phase_plain(bucket.PlainOps(FQ, BN254_G1.b, dev), bk,
                                     nb, acc, steps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(128, 32), (100, 7)])
def test_k5_rake_matches_plain_on_card(B, K):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    X, Y = (torch.from_numpy(a).cuda() for a in _table(B * K))
    sd = torch.sort(torch.randint(0, 5, (B * K,), device="cuda")).values
    for a, b in zip(rake.rake_scan(sd, (X, Y), B, K, FQ),
                    rake.rake_scan_plain(sd, (X, Y), B, K, FQ)):
        assert torch.equal(a, b)
