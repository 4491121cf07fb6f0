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
from aztec_tpu.ff import FQ as JFQ
from aztec_tpu_torch.curves import group, group_kernels as gk
from aztec_tpu_torch.curves.golden import BN254
from aztec_tpu_torch.curves.spec import BN254_G1
from aztec_tpu_torch.ff import FQ, limb
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
