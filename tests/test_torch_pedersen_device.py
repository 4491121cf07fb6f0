"""The port's batched Pedersen lanes (aztec_tpu_torch/crypto/
pedersen_device.py) and the Jacobian formulas they run on
(aztec_tpu_torch/curves/group.py ``dbl``, ``add_complete``, ``neg``,
``eq_jacobian``, ``is_on_curve_affine``), on the CPU.

- the formulas' limbs bit-identical to aztec_tpu.curves.group (run
  eagerly) on BN254 G1 and Grumpkin lanes with P = Q, P = -Q and infinity
  on either side;
- the device WNAF recoder against the host ``fixed_wnaf``;
- ``hash_single_batch``'s Jacobian limbs against aztec_tpu's
  (tests/torch_vectors/pedersen_lanes.npz, make_vectors.py
  ``pedersen_lanes``: aztec_tpu's jit of the 127-step ladder);
- ``compress_batch`` against aztec_tpu's pure-Python ``compress_native``.
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.crypto import pedersen as jpd
from aztec_tpu.curves import group as jgroup
from aztec_tpu.ff import FQ as JFQ, FR as JFR
from aztec_tpu_torch.crypto import pedersen as pd
from aztec_tpu_torch.crypto import pedersen_device as pdev
from aztec_tpu_torch.curves import group
from aztec_tpu_torch.curves.golden import GoldenCurve
from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
from aztec_tpu_torch.ff.bn254 import FR_MOD
from aztec_tpu_torch.numeric.bigint import ints_to_limbs, limbs_to_ints

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import make_vectors  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
W = 8
CURVES = {"bn254": (BN254_G1, JFQ), "grumpkin": (GRUMPKIN_G1, JFR)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    k = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(k)


@functools.lru_cache(maxsize=None)
def _lanes(name):
    """Jacobian P and Q limbs over W lanes: lanes 0, 5-7 generic, 1 P = Q
    and 2 P = -Q (other Z), 3 P at infinity, 4 Q at infinity."""
    curve, _ = CURVES[name]
    spec = curve.field
    q = spec.modulus
    g = GoldenCurve(curve)
    rng = np.random.default_rng(31)
    gen = (curve.gen_x, curve.gen_y)
    pts = [g.mul(int(k), gen) for k in rng.integers(1, 1 << 62, 2 * W)]
    zs = [int(z) % q or 1 for z in rng.integers(1, 1 << 62, 2 * W)]
    P, Q = pts[:W], pts[W:]
    Q[1] = P[1]
    Q[2] = (P[2][0], (-P[2][1]) % q)

    def jac(aff, z, inf):
        X = [x * zz * zz % q for (x, _), zz in zip(aff, z)]
        Y = [y * zz ** 3 % q for (_, y), zz in zip(aff, z)]
        Z = list(z)
        X[inf] = Y[inf] = Z[inf] = 0
        return np.stack([ints_to_limbs([v * spec.R % q for v in c])
                         for c in (X, Y, Z)])

    return jac(P, zs[:W], 3), jac(Q, zs[W:], 4), P


def _port(planes):
    return tuple(torch.from_numpy(p.astype(np.int32)) for p in planes)


def _ref(planes):
    return tuple(jnp.asarray(p.astype(np.uint32)) for p in planes)


def _same(got, want):
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy().astype(np.int64),
                              np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("name", CURVES)
def test_jacobian_formulas_match_reference(name):
    curve, jspec = CURVES[name]
    spec = curve.field
    P, Q, aff = _lanes(name)
    tP, tQ = _port(P), _port(Q)
    jP, jQ = _ref(P), _ref(Q)
    s = group.add_complete(tP, tQ, spec)
    js = jgroup.add_complete(jP, jQ, jspec)
    _same(s, js)
    _same(group.dbl(tP, spec), jgroup.dbl(jP, jspec))
    _same(group.neg(tP, spec), jgroup.neg(jP, jspec))
    # lane 1 doubled, lane 2 cancelled to infinity, lanes 3 and 4 the other
    z = limbs_to_ints(s[2].numpy().astype(np.uint32))
    assert z[2] == 0 and all(z[i] for i in (0, 1, 3, 4, 5, 6, 7))
    eq = group.eq_jacobian(s, tP, spec)
    _same((eq,), (jgroup.eq_jacobian(js, jP, jspec),))
    assert eq.tolist() == [False] * 4 + [True] + [False] * 3
    assert group.eq_jacobian(group.add_complete(tP, tP, spec),
                             group.dbl(tP, spec), spec).all()
    X = tuple(torch.from_numpy(ints_to_limbs(
        [c[k] * spec.R % spec.modulus for c in aff]).astype(np.int32))
        for k in (0, 1))
    on = group.is_on_curve_affine(X, spec, curve.b)
    assert on.all()
    bad = (X[0], X[1].roll(1, dims=1))
    _same((group.is_on_curve_affine(bad, spec, curve.b),),
          (jgroup.is_on_curve_affine(_ref([b.numpy() for b in bad]), jspec,
                                     curve.b),))


def test_wnaf_digits_match_host_recoder():
    vals = make_vectors.pedersen_lane_values()
    vals = [v if v & 1 else (v - 2) % FR_MOD for v in vals]
    digit3, negate, skew = pdev._wnaf_digits(
        torch.from_numpy(ints_to_limbs(vals).astype(np.int32)))
    for lane, v in enumerate(vals):
        wnaf, sk = pd.fixed_wnaf(v, 2 * pd.NUM_QUADS + 1, 2)
        assert bool(skew[lane]) == sk
        for i in range(pd.NUM_QUADS):
            e = wnaf[i + 1]
            assert bool(digit3[i, lane]) == ((e & 0xFFFFFF) == 1)
            assert bool(negate[i, lane]) == bool((e >> 31) & 1)


def test_hash_single_batch_matches_reference_vector():
    vals = make_vectors.pedersen_lane_values()
    x = torch.from_numpy(ints_to_limbs(vals).astype(np.int32))
    with np.load(os.path.join(HERE, "torch_vectors",
                              "pedersen_lanes.npz")) as d:
        ref = {k: d[k] for k in d.files}
    for i in make_vectors.PEDERSEN_INDICES:
        got = pdev.hash_single_batch(x, i)
        for name, plane in zip("XYZ", got):
            assert np.array_equal(plane.numpy(),
                                  ref[f"h{i}_{name}"].astype(np.int32)), (
                i, name)
    assert pdev._ladder_tables(0, torch.device("cpu")) is \
        pdev._ladder_tables(0, torch.device("cpu"))


def test_compress_batch_matches_reference_host():
    rng = np.random.default_rng(21)
    lefts = [1, 0, 0xDEADBEEF, int.from_bytes(rng.bytes(31), "big") % FR_MOD,
             0, FR_MOD - 1]
    rights = [2, 0, 0, int.from_bytes(rng.bytes(31), "big") % FR_MOD, 6,
              4]
    got = pdev.compress_batch(
        torch.from_numpy(ints_to_limbs(lefts).astype(np.int32)),
        torch.from_numpy(ints_to_limbs(rights).astype(np.int32)), 0)
    want = [jpd.compress_native(a, b, 0) for a, b in zip(lefts, rights)]
    assert limbs_to_ints(got.numpy().astype(np.uint32)) == want
    assert want[1] == 0   # both hashes at infinity
