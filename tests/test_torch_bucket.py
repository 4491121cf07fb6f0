"""K4's redesigned order (msm/bucket.py): the lane split, the block combine
on the mock group (Z_m, +) against the sums it stands for, and the plain
version on BN254 against the reference's composed bucket phase in affine;
on the card (``cuda``) the kernel against its plain version, bit for bit,
with and without the accumulator.

Inputs are made from seeds with numpy.  The curve cases stay at 1,024
buckets (two blocks of lanes): the plain group formulas are slow on the
CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.curves.group_ops import JacobianOps as JJacobianOps
from aztec_tpu.curves.spec import BN254_G1 as JG1
from aztec_tpu.msm import pippenger as jpp
from aztec_tpu_torch.curves import group
from aztec_tpu_torch.curves.group_ops import IntModOps
from aztec_tpu_torch.curves.io import jacobian_to_host
from aztec_tpu_torch.curves.spec import BN254_G1
from aztec_tpu_torch.ff import FQ
from aztec_tpu_torch.msm import bucket

M = 1_000_003


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nb,k2,nblocks", [(1024, 4, 2), (4096, 4, 8),
                                           (1 << 16, 4, 128),
                                           (1 << 17, 8, 128),
                                           (1 << 20, 64, 128)])
def test_geometry(nb, k2, nblocks):
    assert bucket.geometry(nb) == (k2, nblocks)
    assert k2 * nblocks * bucket.BK_THREADS == nb
    assert bucket.supported(nb)


@pytest.mark.parametrize("m", [1, 2, 32, 128])
@pytest.mark.parametrize("log2_len", [0, 2, 9])
def test_block_combine_mock(m, log2_len):
    """m segments of 2^log2_len entries: t = sum t_i and s = sum s_i +
    len * sum_i (t_0 + ... + t_{i-1}), over two rows at once."""
    rng = np.random.default_rng(m + log2_len)
    t = rng.integers(0, M, (1, 2, m), dtype=np.int64)
    s = rng.integers(0, M, (1, 2, m), dtype=np.int64)
    T, S = bucket._block_combine(IntModOps(M), (torch.from_numpy(t),),
                                 (torch.from_numpy(s),), log2_len)
    carry = np.cumsum(t, axis=-1) - t
    assert np.array_equal(T[0].numpy(), t.sum(-1, keepdims=True) % M)
    want = (s.sum(-1) + (carry.sum(-1) % M << log2_len)) % M
    assert np.array_equal(S[0].numpy()[..., 0], want)


def _planes(rng, w, inf_every=16):
    x = rng.integers(0, 1 << 16, (16, w)).astype(np.int32)
    x[15] %= 0x3064
    return x


def _jacobian(rng, nb):
    """Jacobian buckets c_j * G with random Z, every 16th at infinity."""
    from aztec_tpu_torch.curves.golden import BN254
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs

    q = FQ.modulus
    pts = [BN254.mul(int(k), BN254.gen)
           for k in rng.integers(1, 1 << 20, nb)]
    zs = [int(z) % q or 1 for z in rng.integers(1, 1 << 62, nb)]
    coords = [[p[0] * z * z % q for p, z in zip(pts, zs)],
              [p[1] * z ** 3 % q for p, z in zip(pts, zs)], zs]
    for c in coords:
        c[::16] = [0] * len(c[::16])
    return tuple(torch.from_numpy(ints_to_limbs([v * FQ.R % q for v in c])
                                  .astype(np.int32)) for c in coords)


def test_plain_matches_reference_in_affine():
    """bucket_phase_plain on 1,024 BN254 buckets against the reference's
    composed bucket phase (aztec_tpu msm/pippenger.py ``_bucket_phase``
    over the same buckets in complete form), equal in affine."""
    nb = 1024
    Bj = _jacobian(np.random.default_rng(3), nb)
    got = bucket.bucket_phase(Bj, nb, FQ, BN254_G1.b)
    jops = JJacobianOps(JG1)
    jb = jops.j2c(tuple(jnp.asarray(p.numpy().astype(np.uint32))
                        for p in Bj))
    want = jpp._bucket_phase(jops, jb, nb, 64)
    want = tuple(torch.from_numpy(np.asarray(c).astype(np.int32)
                                  .reshape(16, 1)) for c in want)
    aff = [jacobian_to_host(group.proj_to_jacobian(P, FQ), BN254_G1)[0]
           for P in (got, want)]
    assert aff[0] == aff[1] and aff[0] is not None


# test_torch_engine.py's test_k4_bucket_matches_plain_on_card holds the
# other two pairs, (1024, no acc) and (2^16, acc and 16 doublings)
@pytest.mark.cuda
@pytest.mark.parametrize("nb,steps", [(1024, 16), (1 << 16, 0)])
def test_k4_matches_plain_on_card(nb, steps):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(nb + 1)
    dev = torch.device("cuda")
    bk = tuple(torch.from_numpy(_planes(rng, nb)).to(dev) for _ in range(3))
    bk[2][:, ::16] = 0
    acc = (tuple(torch.from_numpy(_planes(rng, 1)).to(dev) for _ in range(3))
           if steps else None)
    got = bucket.bucket_phase(bk, nb, FQ, BN254_G1.b, acc, steps)
    want = bucket.bucket_phase_plain(bucket.PlainOps(FQ, BN254_G1.b, dev), bk,
                                     nb, acc, steps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
