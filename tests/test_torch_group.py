"""aztec_tpu_torch.curves (plain group formulas and the K2 wrappers)
against aztec_tpu.curves.group and the affine golden, bit-exact.

32 BN254 G1 points made from numpy-seeded scalars, with infinity lanes and
no P = +-Q on the unsafe adds.  The JAX side runs eagerly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.curves import group as jgroup
from aztec_tpu.ff import FQ as JFQ, FR as JFR
from aztec_tpu_torch.curves import group, group_kernels as gk
from aztec_tpu_torch.curves.golden import BN254
from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
from aztec_tpu_torch.ff import FQ, FR, limb
from aztec_tpu_torch.ff import field_kernels as fk
from aztec_tpu_torch.numeric.bigint import ints_to_limbs, limbs_to_ints

q = FQ.modulus
B = BN254_G1.b
N = 32
P_INF = (0, 5)       # Jacobian infinity lanes of P (Z = 0)
Q_INF = (1, 5)       # ... of Q (lane 5: both)
C_ID = (2, 7)        # projective identity lanes (0 : 1 : 0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mont(vals):
    return np.asarray(ints_to_limbs([v * FQ.R % q for v in vals]))


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(21)
    ks = [int(x) for x in rng.integers(1, 1 << 62, size=2 * N)]
    pts = [BN254.mul(k, BN254.gen) for k in ks]
    zs = [int(x) % q or 1 for x in rng.integers(1, 1 << 62, size=2 * N)]
    P_aff, Q_aff = pts[:N], pts[N:]

    def jac(aff, z, inf):
        X = [x * zz * zz % q for (x, _), zz in zip(aff, z)]
        Y = [y * zz ** 3 % q for (_, y), zz in zip(aff, z)]
        Z = list(z)
        for i in inf:
            X[i] = Y[i] = Z[i] = 0
        return tuple(_mont(v) for v in (X, Y, Z))

    def proj(aff, z, ident):
        X = [x * zz % q for (x, _), zz in zip(aff, z)]
        Y = [y * zz % q for (_, y), zz in zip(aff, z)]
        Z = list(z)
        for i in ident:
            X[i], Y[i], Z[i] = 0, 1, 0
        return tuple(_mont(v) for v in (X, Y, Z))

    return {
        "P_aff": P_aff, "Q_aff": Q_aff,
        "P": jac(P_aff, zs[:N], P_INF), "Q": jac(Q_aff, zs[N:], Q_INF),
        "Qa": tuple(_mont(v) for v in zip(*Q_aff)),
        "Pc": proj(P_aff, zs[:N], C_ID), "Qc": proj(Q_aff, zs[N:], (3, 7)),
    }


FORMULAS = ("mixed_add_unsafe", "add_unsafe", "proj_add_complete",
            "proj_dbl", "proj_dbl_n", "jacobian_to_proj", "proj_to_jacobian")


@functools.lru_cache(maxsize=None)
def _jax_results():
    d = _data()
    args = {k: tuple(jnp.asarray(a) for a in d[k])
            for k in ("P", "Q", "Qa", "Pc", "Qc")}

    # eager: the reference's limb ops are jitted one by one, so every
    # formula reuses the same few compiled (op, shape) executables
    def run(a):
        dbl = a["Pc"]
        for _ in range(3):
            dbl = jgroup.proj_dbl(dbl, JFQ, B)
        return {
            "mixed_add_unsafe": jgroup.mixed_add_unsafe(a["P"], a["Qa"], JFQ),
            "add_unsafe": jgroup.add_unsafe(a["P"], a["Q"], JFQ),
            "proj_add_complete": jgroup.proj_add_complete(a["Pc"], a["Qc"],
                                                          JFQ, B),
            "proj_dbl": jgroup.proj_dbl(a["Pc"], JFQ, B),
            "proj_dbl_n": dbl,
            "jacobian_to_proj": jgroup.jacobian_to_proj(a["P"], JFQ),
            "proj_to_jacobian": jgroup.proj_to_jacobian(a["Pc"], JFQ),
            "to_affine": jgroup.to_affine(a["Q"], JFQ),
        }

    out = run(args)
    return {k: tuple(np.asarray(c) for c in v) for k, v in out.items()}


def _t(planes):
    return tuple(torch.from_numpy(np.asarray(p).astype(np.int32))
                 for p in planes)


def _port(fn, impl):
    d = _data()
    P, Q, Qa, Pc, Qc = (_t(d[k]) for k in ("P", "Q", "Qa", "Pc", "Qc"))
    calls = {
        "mixed_add_unsafe": lambda m: m.mixed_add_unsafe(P, Qa, FQ),
        "add_unsafe": lambda m: m.add_unsafe(P, Q, FQ),
        "proj_add_complete": lambda m: m.proj_add_complete(Pc, Qc, FQ, B),
        "proj_dbl": lambda m: m.proj_dbl(Pc, FQ, B),
        "proj_dbl_n": lambda m: m.proj_dbl_n(Pc, FQ, B, 3),
        "jacobian_to_proj": lambda m: m.jacobian_to_proj(P, FQ),
        "proj_to_jacobian": lambda m: m.proj_to_jacobian(Pc, FQ),
    }
    return calls[fn](impl)


@pytest.mark.parametrize("impl", ["plain", "wrapper"])
@pytest.mark.parametrize("fn", FORMULAS)
def test_formula_matches_jax(fn, impl):
    before = dict(fk.LAUNCHES)
    got = _port(fn, group if impl == "plain" else gk)
    want = _jax_results()[fn]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64), w.astype(np.int64))
    assert dict(fk.LAUNCHES) == before


def test_to_affine_matches_jax():
    x, y, inf = group.to_affine(_t(_data()["Q"]), FQ)
    jx, jy, jinf = _jax_results()["to_affine"]
    assert np.array_equal(x.numpy(), jx.astype(np.int32))
    assert np.array_equal(y.numpy(), jy.astype(np.int32))
    assert np.array_equal(inf.numpy(), jinf)


def _affine(P):
    x, y, inf = group.to_affine(P, FQ)
    xs = limbs_to_ints(limb.from_mont(x, FQ).numpy().astype(np.uint32))
    ys = limbs_to_ints(limb.from_mont(y, FQ).numpy().astype(np.uint32))
    return [None if f else (a, b) for a, b, f in zip(xs, ys, inf.tolist())]


def test_unsafe_adds_match_golden():
    d = _data()
    Pg = [None if i in P_INF else p for i, p in enumerate(d["P_aff"])]
    Qg = [None if i in Q_INF else p for i, p in enumerate(d["Q_aff"])]
    assert _affine(_port("add_unsafe", group)) == [
        BN254.add(a, b) for a, b in zip(Pg, Qg)]
    assert _affine(_port("mixed_add_unsafe", group)) == [
        BN254.add(a, b) for a, b in zip(Pg, d["Q_aff"])]


def test_complete_formulas_match_golden():
    d = _data()
    Pg = [None if i in C_ID else p for i, p in enumerate(d["P_aff"])]
    Qg = [None if i in (3, 7) else p for i, p in enumerate(d["Q_aff"])]
    s = group.proj_to_jacobian(_port("proj_add_complete", group), FQ)
    assert _affine(s) == [BN254.add(a, b) for a, b in zip(Pg, Qg)]
    dbl = group.proj_to_jacobian(_port("proj_dbl_n", group), FQ)
    assert _affine(dbl) == [None if a is None else BN254.mul(8, a) for a in Pg]
    # the complete add also doubles and cancels
    Pc = _t(d["Pc"])
    twice = group.proj_to_jacobian(group.proj_add_complete(Pc, Pc, FQ, B), FQ)
    assert _affine(twice) == [BN254.dbl(a) for a in Pg]


@pytest.mark.cuda
@pytest.mark.parametrize("fn", FORMULAS)
def test_k2_kernel_matches_plain_on_card(fn):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d = _data()
    P, Q, Qa, Pc, Qc = (tuple(t.cuda() for t in _t(d[k]))
                        for k in ("P", "Q", "Qa", "Pc", "Qc"))
    calls = {
        "mixed_add_unsafe": lambda m: m.mixed_add_unsafe(P, Qa, FQ),
        "add_unsafe": lambda m: m.add_unsafe(P, Q, FQ),
        "proj_add_complete": lambda m: m.proj_add_complete(Pc, Qc, FQ, B),
        "proj_dbl": lambda m: m.proj_dbl(Pc, FQ, B),
        "proj_dbl_n": lambda m: m.proj_dbl_n(Pc, FQ, B, 3),
        "jacobian_to_proj": lambda m: m.jacobian_to_proj(P, FQ),
        "proj_to_jacobian": lambda m: m.proj_to_jacobian(Pc, FQ),
    }
    for k, p in zip(calls[fn](gk), calls[fn](group)):
        assert torch.equal(k, p)


# -- lazy reduction of the redesigned K2 kernels (csrc/field_lazy.cuh) -------

_M32 = (1 << 32) - 1


def _words(x):
    return [(x >> (32 * i)) & _M32 for i in range(8)]


def _lazy_mont_mul(a, b, p):
    """csrc/field_lazy.cuh ``mul`` word by word (the even / odd CIOS on
    32-bit words); asserts that the carries the kernel drops are 0."""
    np_ = -pow(p, -1, 1 << 32) % (1 << 32)
    A, B, P = _words(a), _words(b), _words(p)
    cc = 0

    def chain(acc, src, bi, off, carry_in):
        # acc[j], acc[j+1] += src[j+off] * bi for even j, one carry chain
        nonlocal cc
        c = cc if carry_in else 0
        for j in range(0, 8, 2):
            t = src[j + off] * bi
            lo = acc[j] + (t & _M32) + c
            acc[j], c = lo & _M32, lo >> 32
            hi = acc[j + 1] + (t >> 32) + c
            acc[j + 1], c = hi & _M32, hi >> 32
        cc = c

    def row(even, odd, bi, first):
        nonlocal cc
        if first:
            odd[:] = [0] * 8
            even[:] = [0] * 8
            chain(odd, A, bi, 1, False)
            chain(even, A, bi, 0, False)
        else:
            s = even[0] + odd[1]
            even[0], cc = s & _M32, s >> 32
            # madc_n_rshift: odd <- (odd >> 64) + odd products, flag in
            shifted = odd[2:] + [0, 0]
            odd[:] = shifted
            chain(odd, A, bi, 1, True)
            assert cc == 0                   # its last madc.hi takes no .cc
            chain(even, A, bi, 0, False)
            odd[7] += cc
        m = even[0] * np_ & _M32
        chain(odd, P, m, 1, False)
        assert cc == 0                       # the carry the kernel drops
        chain(even, P, m, 0, False)
        odd[7] += cc
        assert even[0] == 0 and odd[7] <= _M32

    even, odd = [0] * 8, [0] * 8
    for i in range(0, 8, 2):
        row(even, odd, B[i], i == 0)
        row(odd, even, B[i + 1], False)
    val = sum(w << (32 * i) for i, w in enumerate(even)) + sum(
        w << (32 * (i - 1)) for i, w in enumerate(odd) if i)
    assert val < 1 << 256                    # the merge's last addc
    return val


@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_lazy_reduction_invariants(spec):
    """The bounds that let the redesigned K2 kernels keep values in
    [0, 2p): a product, an add and a sub of such values land there again,
    and 9t by four additions is 9t mod p, as the product by 9R is."""
    p, R = spec.modulus, 1 << 256
    assert 4 * p < R
    rinv = pow(R, -1, p)
    rng = np.random.default_rng(4)
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 2, 2 * p - 1]
    vals = edge + [sum(int(w) << (64 * i) for i, w in enumerate(ws)) % (2 * p)
                   for ws in rng.integers(0, 1 << 63, (40, 5))]
    for a in vals:
        for b in vals[:12]:
            prod = _lazy_mont_mul(a, b, p)
            assert prod < 2 * p and prod % p == a * b * rinv % p
            s = a + b
            s = s - 2 * p if s >= 2 * p else s          # add: masked -2p
            d = a - b
            d = d + 2 * p if d < 0 else d               # sub: masked +2p
            assert 0 <= s < 2 * p and s % p == (a + b) % p
            assert 0 <= d < 2 * p and d % p == (a - b) % p
        t = a
        for _ in range(3):                              # 2t, 4t, 8t
            t = t + t - 2 * p if t + t >= 2 * p else t + t
        t = t + a - 2 * p if t + a >= 2 * p else t + a  # 8t + t
        nine_r = 9 * R % p
        assert 0 <= t < 2 * p
        assert t % p == _lazy_mont_mul(a, nine_r, p) % p == 9 * a % p
        assert (t - p if t >= p else t) == 9 * a % p    # canon


# widths of the edge-lane cases: a partial last block at every block size
# the redesigned kernels choose, and the proof's bucket-phase widths
K2_EDGE_WIDTHS = (1, 3, 33, 8192 + 5, 24576)


def _edge_points(spec, w, seed=9):
    """(P, Q) of w lanes of canonical random coordinates whose lanes cycle
    through Z1 = 0, Z2 = 0, both, Q = P, Q = -P, P the identity
    (0 : 1 : 0), Q the identity, two lanes of coordinates from
    {0, 1, p - 1}, and a random lane."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    P, Q = ([[sum(int(v) << (62 * i) for i, v in enumerate(ws)) % p
              for ws in rng.integers(0, 1 << 62, (w, 5))] for _ in range(3)]
            for _ in range(2))
    one = spec.R % p
    for j in range(w):
        k = j % 10
        if k in (0, 2):
            P[2][j] = 0
        if k in (1, 2):
            Q[2][j] = 0
        if k == 3:
            for c in range(3):
                Q[c][j] = P[c][j]
        if k == 4:
            Q[0][j], Q[1][j], Q[2][j] = P[0][j], -P[1][j] % p, P[2][j]
        if k == 5:
            P[0][j], P[1][j], P[2][j] = 0, one, 0
        if k == 6:
            Q[0][j], Q[1][j], Q[2][j] = 0, one, 0
        if k in (7, 8):
            for c in P + Q:
                c[j] = (0, 1, p - 1)[int(rng.integers(0, 3))]
    return tuple(tuple(torch.from_numpy(np.asarray(ints_to_limbs(c))
                                        .astype(np.int32)) for c in pt)
                 for pt in (P, Q))


EDGE_CASES = [("add_unsafe", FR, None), ("add_unsafe", FQ, None),
              ("proj_add_complete", FR, B), ("proj_add_complete", FQ, B),
              ("proj_add_complete", FR, GRUMPKIN_G1.b)]
EDGE_IDS = ["add_unsafe-fr", "add_unsafe-fq", "proj_add-fr", "proj_add-fq",
            "proj_add-grumpkin"]


@pytest.mark.parametrize("fn,spec,b", EDGE_CASES, ids=EDGE_IDS)
def test_plain_k2_formula_matches_jax_on_edge_lanes(fn, spec, b):
    """The plain formulas that the redesigned kernels are held against
    equal the reference's on the edge lanes (N lanes, the width of the
    reference's executables above: every lane kind, a Z of 0, P = +-Q,
    coordinates 0, 1, p - 1), bit for bit."""
    P, Q = _edge_points(spec, N)
    extra = () if b is None else (b,)
    jspec = JFR if spec is FR else JFQ
    want = getattr(jgroup, fn)(
        *(tuple(jnp.asarray(t.numpy().astype(np.uint32)) for t in pt)
          for pt in (P, Q)), jspec, *extra)
    got = getattr(group, fn)(P, Q, spec, *extra)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32),
                              np.asarray(w).astype(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("w", K2_EDGE_WIDTHS)
@pytest.mark.parametrize("fn,spec,b", EDGE_CASES, ids=EDGE_IDS)
def test_redesigned_k2_kernel_edge_lanes_on_card(fn, spec, b, w):
    """The redesigned kernels (lazy reduction, 9t by additions for b = 3,
    the products by 3b for Grumpkin) equal their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    P, Q = _edge_points(spec, w)
    extra = () if b is None else (b,)
    got = getattr(gk, fn)(tuple(t.cuda() for t in P),
                          tuple(t.cuda() for t in Q), spec, *extra)
    want = getattr(group, fn)(P, Q, spec, *extra)
    for g, p in zip(got, want):
        assert torch.equal(g.cpu(), p)
