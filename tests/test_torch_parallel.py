"""The port's parallel layer (aztec_tpu_torch/parallel) on meshes of CPU
shards (tests/test_torch_multihost.py runs ``multihost``; the poly/
functions it reaches are held in tests/test_torch_fft.py):

- ``sharded_coset_fft`` at N = 64 over 2 and 4 shards against the port's
  ``coset_fft`` and aztec_tpu's ``sharded_coset_fft`` over as many virtual
  devices (tests/torch_vectors/sharded_fft.npz: aztec_tpu's own test needs
  8 virtual devices, which this process's JAX does not have);
- the sharded MSM by the engine route (a given MSMConfig, two shards) and
  by the chunked pipeline (four shards) against (sum k_i tau^i) G of the
  committed point table, in affine, from aztec_tpu's pure-Python golden
  curve and SRS tau (and the port's golden beside it).
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.curves import golden as ref_golden
from aztec_tpu.curves import spec as ref_spec
from aztec_tpu.parallel import sharded_fft as jsharded
from aztec_tpu.srs.reference_string import FakeReferenceStringFactory
from aztec_tpu_torch.curves import golden
from aztec_tpu_torch.curves.io import jacobian_to_host
from aztec_tpu_torch.curves.spec import BN254_G1
from aztec_tpu_torch.ff.bn254 import FR_MOD
from aztec_tpu_torch.msm.pippenger import MSMConfig
from aztec_tpu_torch.numeric.bigint import ints_to_limbs
from aztec_tpu_torch.parallel import Mesh, sharded_fft, sharded_msm
from aztec_tpu_torch.parallel.sharded_chunked import sharded_msm_chunked
from aztec_tpu_torch.poly import domain
from aztec_tpu_torch.poly import fft_ops as pfft
from aztec_tpu_torch.poly.arithmetic import to_ints
from aztec_tpu_torch.srs.reference_string import DEV_TAU, load_point_table

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import make_vectors  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    k = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(k)


@functools.lru_cache(maxsize=None)
def _vals(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD
            for _ in range(n)]


@pytest.mark.parametrize("D", make_vectors.SHARDED_FFT_D)
def test_sharded_coset_fft_matches_single_device_and_reference(D):
    N = make_vectors.SHARDED_FFT_N
    limbs = make_vectors.sharded_fft_coeffs()
    x = torch.from_numpy(limbs.astype(np.int32))
    got = sharded_fft.sharded_coset_fft(Mesh.local(D, "cpu"), x,
                                        domain.EvaluationDomain(N, "cpu"))
    assert got.shape == (16, N)
    want = pfft.coset_fft(x, domain.EvaluationDomain(N, "cpu"))
    assert to_ints(got) == to_ints(want)
    with np.load(os.path.join(HERE, "torch_vectors", "sharded_fft.npz")) as d:
        ref = torch.from_numpy(d[f"d{D}"].astype(np.int32))
    assert to_ints(got) == to_ints(ref)


def test_layout_helpers_match_reference():
    x = np.arange(16 * 64, dtype=np.uint32).reshape(16, 64)
    inter = sharded_fft.interleave(torch.from_numpy(x.astype(np.int32)), 4)
    assert np.array_equal(inter.numpy(),
                          np.asarray(jsharded.interleave(jnp.asarray(x), 4)))
    out = torch.from_numpy(x.astype(np.int32)).reshape(16, 4, 16)
    assert np.array_equal(sharded_fft.deinterleave_output(out).numpy(),
                          np.asarray(jsharded.deinterleave_output(
                              jnp.asarray(x.reshape(16, 4, 16)))))
    assert sharded_fft.natural_order(out, 4) is out
    with pytest.raises(ValueError, match="D\\^2"):
        sharded_fft.sharded_coset_fft(Mesh.local(3, "cpu"),
                                      torch.from_numpy(x.astype(np.int32)),
                                      domain.EvaluationDomain(64, "cpu"))


def _msm_case(n, seed):
    X, Y = (torch.from_numpy(p.astype(np.int32)) for p in load_point_table(n))
    ks = [v % BN254_G1.order for v in _vals(n, seed)]
    S = torch.from_numpy(ints_to_limbs(ks).astype(np.int32))
    return (X, Y), S, _reference_msm(ks)


def _reference_msm(ks):
    """(sum k_i tau^i) G by aztec_tpu's golden curve and its dev SRS's
    tau, after checking the port's golden agrees."""
    g1 = ref_spec.BN254_G1
    tau = FakeReferenceStringFactory().tau
    kk = sum(k * pow(tau, i, g1.order) for i, k in enumerate(ks)) % g1.order
    expect = ref_golden.GoldenCurve(g1).mul(kk, (g1.gen_x, g1.gen_y))
    r = BN254_G1.order
    kp = sum(k * pow(DEV_TAU, i, r) for i, k in enumerate(ks)) % r
    assert golden.GoldenCurve(BN254_G1).mul(
        kp, (BN254_G1.gen_x, BN254_G1.gen_y)) == expect
    return expect


def test_sharded_msm_engine_route():
    """A given MSMConfig runs the engine on each shard (the reference's
    routing); two shards of 8 points, the second padded with two zero
    scalars (tests/test_torch_multihost.py runs four engine shards in two
    processes)."""
    pts, S, expect = _msm_case(14, 7)
    mesh = Mesh.local(2, "cpu")
    P = sharded_msm(mesh, pts, S, BN254_G1,
                    MSMConfig(c=4, block=4, bucket_block=4, glv=True))
    assert P[0].device == mesh.devices[0]
    assert jacobian_to_host(P, BN254_G1)[0] == expect


def test_sharded_msm_chunked_route():
    """The chunked pipeline on four shards (c = 4, chunks of 8 points: two
    passes, the second padded), folded by the same combine."""
    pts, S, expect = _msm_case(40, 8)
    P = sharded_msm_chunked(Mesh.local(4, "cpu"), pts, S, BN254_G1, c=4,
                            chunk_log2=3, K=8)
    assert jacobian_to_host(P, BN254_G1)[0] == expect


def test_mesh_defaults_to_the_card():
    m = Mesh.local(4)
    assert m.devices == (torch.device("cuda", 0),) * 4 and m.size == 4
    with pytest.raises(ValueError):
        Mesh(())
