"""The port on unreduced operands: 16-bit limbs that are not field elements
(uniform limbs, all 0xFFFF, p, p + 1, 2p - 1), which the reference's
formulas take with the mod-2^256 semantics of its field helper.

- on the CPU, the plain group formulas (the versions every K2 kernel is
  held against) and the rake's plain versions (K3's and K5's) against
  aztec_tpu on such lanes, bit for bit, with the unreduced points in the
  middle of a rake's runs;
- on the card (``cuda``), every lazily reduced kernel against its plain
  version on such lanes: the K2 adds and doublings, ``jacobian_to_proj``,
  K3, K5, K4 and the FFT's stage kernel.  A warp mixes lanes in range and
  out of it, and one warp holds only lanes in range.

Inputs are made from seeds with numpy.  The reference runs eagerly at the
width (16, 32) and the rake shape (K = 4, B = 128) of the other port tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.curves import group as jgroup
from aztec_tpu.curves.group_ops import JacobianOps as JJacobianOps
from aztec_tpu.curves.group_ops import _rake_scan_packed_xla
from aztec_tpu.curves.spec import BN254_G1 as JG1
from aztec_tpu.ff import FQ as JFQ, FR as JFR
from aztec_tpu_torch.curves import group, group_kernels as gk
from aztec_tpu_torch.curves.group_ops import JacobianOps
from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
from aztec_tpu_torch.ff import FQ, FR
from aztec_tpu_torch.ff import field_kernels as fk
from aztec_tpu_torch.msm import bucket, rake
from aztec_tpu_torch.numeric.bigint import ints_to_limbs

N = 32
CPU = torch.device("cpu")
B3 = BN254_G1.b


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unreduced(spec, shape, rng, in_range_from=None):
    """(16, *shape) planes of uniform 16-bit limbs (most >= p); the first
    lanes all 0xFFFF, p, p + 1, 2p - 1 and 1, then 0 (a Z of 0 decides
    infinity); lanes from ``in_range_from`` on canonical (top limb below
    p's)."""
    p = spec.modulus
    x = rng.integers(0, 1 << 16, (16,) + tuple(shape)).astype(np.int64)
    flat = x.reshape(16, -1)
    special = ints_to_limbs([(1 << 256) - 1, p, p + 1, 2 * p - 1, 1, 0])
    k = min(flat.shape[1], special.shape[1])
    flat[:, :k] = special[:, :k]
    if in_range_from is not None:
        flat[15, in_range_from:] %= p >> 240
    return torch.from_numpy(x.astype(np.int32))


def _pts(spec, w, seed, count=3, in_range_from=None):
    rng = np.random.default_rng(seed)
    return tuple(unreduced(spec, (w,), rng, in_range_from)
                 for _ in range(count))


def _j(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _same(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32),
                              np.asarray(w).astype(np.uint32))


JSPEC = {id(FQ): JFQ, id(FR): JFR}
FORMULA_CASES = [
    ("mixed_add_unsafe", FQ, None), ("mixed_add_unsafe", FR, None),
    ("add_unsafe", FQ, None), ("add_unsafe", FR, None),
    ("proj_add_complete", FQ, B3), ("proj_add_complete", FR, GRUMPKIN_G1.b),
    ("proj_dbl", FQ, B3), ("proj_dbl", FR, GRUMPKIN_G1.b),
    ("jacobian_to_proj", FQ, None)]
FORMULA_IDS = [f"{f}-{s.name}" + {None: "", B3: "-b3"}.get(b, "-grumpkin")
               for f, s, b in FORMULA_CASES]


def _call(mod, fn, spec, b, P, Q):
    if fn == "mixed_add_unsafe":
        return mod.mixed_add_unsafe(P, Q[:2], spec)
    if fn == "add_unsafe":
        return mod.add_unsafe(P, Q, spec)
    if fn == "proj_add_complete":
        return mod.proj_add_complete(P, Q, spec, b)
    if fn == "proj_dbl":
        return mod.proj_dbl(P, spec, b)
    return mod.jacobian_to_proj(P, spec)


@pytest.mark.parametrize("fn,spec,b", FORMULA_CASES, ids=FORMULA_IDS)
def test_plain_formula_matches_jax_on_unreduced_lanes(fn, spec, b):
    """The plain formulas equal the reference's on unreduced lanes, bit for
    bit (half the lanes canonical, so a lane in range meets one out of it
    in every add)."""
    P = _pts(spec, N, 1)
    Q = _pts(spec, N, 2, in_range_from=N // 2)
    got = _call(group, fn, spec, b, P, Q)
    jP, jQ = tuple(map(_j, P)), tuple(map(_j, Q))
    want = _call(jgroup, fn, JSPEC[id(spec)], b, jP, jQ)
    _same(got, want)


@pytest.mark.parametrize("spec,b", [(FQ, B3), (FR, GRUMPKIN_G1.b)],
                         ids=["fq", "grumpkin"])
def test_plain_proj_dbl_n_matches_jax_on_unreduced_lanes(spec, b):
    P = _pts(spec, N, 3)
    want = tuple(map(_j, P))
    for _ in range(3):
        want = jgroup.proj_dbl(want, JSPEC[id(spec)], b)
    _same(group.proj_dbl_n(P, spec, b, 3), want)


def _rake_unreduced(spec, B, K, seed=6):
    """K3's inputs (digits (K, B), packed points (16, K * B), K-major): runs
    of sorted random digits and one run of all K digits on every 4th lane,
    the points canonical but for unreduced ones in the middle of the runs
    (entries 1 and 2 of every other lane, and every entry of lane 1)."""
    rng = np.random.default_rng(seed)
    X, Y = (unreduced(spec, (K, B), rng).numpy().astype(np.int64)
            for _ in range(2))
    k = np.broadcast_to(np.arange(K)[:, None], (K, B))
    lane = np.broadcast_to(np.arange(B)[None, :], (K, B))
    dig = np.where(lane % 4 == 0, 3,
                   np.sort(rng.integers(0, 3, (K, B)), axis=0))
    keep = ((lane % 2 == 1) & ((k == 1) | (k == 2))) | (lane == 1)
    for c in (X, Y):
        c[15] = np.where(keep, c[15], c[15] % (spec.modulus >> 240))
    curve = BN254_G1 if spec is FQ else GRUMPKIN_G1
    packed = JacobianOps(curve, CPU).pack_affine(
        tuple(torch.from_numpy(c.reshape(16, K * B).astype(np.int32))
              for c in (X, Y)))
    return dig.astype(np.uint32), packed


def test_rake_plain_matches_reference_on_unreduced_lanes():
    """K3's plain version against the reference's rake on unreduced points
    in the middle of runs, and K5's plain version against K3's on the same
    entries in K5's n-order layout."""
    K, B = 4, 128
    dig, packed = _rake_unreduced(FQ, B, K)
    dig_t = torch.from_numpy(dig.astype(np.int64))
    got = rake.rake_scan_packed_plain(dig_t, packed, B, K, FQ)
    pk = packed.numpy().view(np.uint32).reshape(16, K, B // 128, 128)
    want = _rake_scan_packed_xla(JJacobianOps(JG1),
                                 jnp.asarray(dig.reshape(K, B // 128, 128)),
                                 jnp.asarray(pk), B, K)
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(16, K * B).astype(np.int64)
        assert np.array_equal(g.numpy().astype(np.int64), w)
    # an accumulator left the range in some run
    assert (got[0].numpy()[15] >= FQ.modulus >> 240).any()
    X, Y = rake.unpack(packed)
    nord = torch.arange(K * B).reshape(K, B).T.reshape(-1)  # n-order columns
    k5 = rake.rake_scan_plain(dig_t.T.reshape(-1), (X[:, nord], Y[:, nord]),
                              B, K, FQ)
    for a, g in zip(k5, got):
        assert torch.equal(a, g.reshape(16, K, B).transpose(1, 2))


# -- the kernels on the card ------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _eq(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


# widths: one partial warp; a warp of lanes in range beside mixed warps
CARD_WIDTHS = (N, 8192 + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("w", CARD_WIDTHS)
@pytest.mark.parametrize("fn,spec,b", FORMULA_CASES, ids=FORMULA_IDS)
def test_k2_kernel_matches_plain_on_unreduced_lanes_on_card(fn, spec, b, w):
    dev = _card()
    P = _pts(spec, w, 1, in_range_from=64)
    Q = _pts(spec, w, 2, in_range_from=w // 2)
    got = _call(gk, fn, spec, b, tuple(t.to(dev) for t in P),
                tuple(t.to(dev) for t in Q))
    _eq(got, _call(group, fn, spec, b, P, Q))


@pytest.mark.cuda
@pytest.mark.parametrize("w", CARD_WIDTHS)
@pytest.mark.parametrize("spec,b", [(FQ, B3), (FR, GRUMPKIN_G1.b)],
                         ids=["fq", "grumpkin"])
def test_proj_dbl_n_kernel_matches_plain_on_unreduced_lanes_on_card(spec, b,
                                                                    w):
    """Four lanes a point: a warp that holds an unreduced point (lanes < 8
    and one lane in every 97 from 64 on) takes the exact path as a whole,
    the warps of canonical points the lazy one."""
    dev = _card()
    P = _pts(spec, w, 3, in_range_from=8)
    P[1][15, 64::97] = 0xFFFF
    for steps in (1, 16):
        got = gk.proj_dbl_n(tuple(t.to(dev) for t in P), spec, b, steps)
        _eq(got, group.proj_dbl_n(P, spec, b, steps))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
@pytest.mark.parametrize("B,K", [(128, 4), (4096 + 5, 64)])
def test_rakes_match_plain_on_unreduced_lanes_on_card(spec, B, K):
    dev = _card()
    dig, packed = _rake_unreduced(spec, B, K)
    dig_t = torch.from_numpy(dig.astype(np.int64))
    want = rake.rake_scan_packed_plain(dig_t, packed, B, K, spec)
    _eq(rake.rake_scan_packed(dig_t.to(dev), packed.to(dev), B, K, spec), want)
    X, Y = rake.unpack(packed)
    nord = torch.arange(K * B).reshape(K, B).T.reshape(-1)
    sd = dig_t.T.reshape(-1)
    _eq(rake.rake_scan(sd.to(dev), (X[:, nord].to(dev), Y[:, nord].to(dev)),
                       B, K, spec),
        rake.rake_scan_plain(sd, (X[:, nord], Y[:, nord]), B, K, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,steps", [(1024, 0), (1 << 16, 16)])
def test_k4_matches_plain_on_unreduced_buckets_on_card(nb, steps):
    """K4 on buckets of unreduced limbs (every lane from 4096 on canonical)
    and an unreduced accumulator, against its plain version on the card."""
    dev = _card()
    bk = tuple(t.to(dev) for t in _pts(FQ, nb, 4, in_range_from=4096))
    acc = tuple(t.to(dev) for t in _pts(FQ, 1, 5)) if steps else None
    got = bucket.bucket_phase(bk, nb, FQ, B3, acc, steps)
    _eq(got, bucket.bucket_phase_plain(bucket.PlainOps(FQ, B3, dev), bk, nb,
                                       acc, steps))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 3])
def test_fft_stages_match_plain_on_unreduced_lanes_on_card(s):
    """The FFT's stage kernel on unreduced stage inputs and twiddles, every
    stage boundary of a 2^10 FFT and s stages a launch; and ``butterfly``
    with its broadcast twiddle."""
    dev = _card()
    n = 1 << 10
    A = _pts(FR, n, 6, count=1, in_range_from=n // 2)[0]
    roots = _pts(FR, n // 2, 7, count=1, in_range_from=64)[0]
    t = 0
    while t < 10:
        st = min(s, 10 - t)
        got = fk.fft_stages(A.to(dev), roots.to(dev), t, st, FR)
        A = fk.fft_stages_plain(A, roots, t, st, FR)
        _eq((got,), (A,))
        t += st
    top, bot = _pts(FR, n, 8, count=2)
    tw = roots[:, None, :4]
    _eq(fk.butterfly(top.view(16, -1, 4).to(dev), bot.view(16, -1, 4).to(dev),
                     tw.to(dev), FR),
        fk.butterfly(top.view(16, -1, 4), bot.view(16, -1, 4), tw, FR))
