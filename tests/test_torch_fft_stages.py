"""The FFT's stage entry (``field_kernels.fft_stages``) against aztec_tpu's
FFT at every stage boundary.

Stage t of the Stockham FFT of size n holds A_t[b, :] = FFT_{2^t} of the
subsequence x[b::r_t] (r_t = n / 2^t).  The reference's FFT of size n gives
that for any t: on y with y[m r_t] = x[b + m r_t] and zeros elsewhere,
FFT_n(y)[k] = FFT_{2^t}(x[b::r_t])[k] for k < 2^t, and every value is a
canonical field element.  So each boundary the plain stage entry reaches,
s stages a call for s = 1..4, is held bit for bit against the reference's
FFT of size n, for n = 16 and 256.  The wrapper (the plain version on the
CPU, the kernel on the card) takes up to ``MAX_STAGES`` stages a launch.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.poly import fft_ops as jfft
from aztec_tpu.poly.domain import EvaluationDomain as JDomain
from aztec_tpu_torch.ff import FR
from aztec_tpu_torch.ff import field_kernels as fk
from aztec_tpu_torch.ff.bn254 import FR_MOD
from aztec_tpu_torch.numeric.bigint import ints_to_limbs
from aztec_tpu_torch.poly import EvaluationDomain
from aztec_tpu_torch.poly import fft_ops as pfft


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    k = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(k)


@functools.lru_cache(maxsize=None)
def _input(n):
    rng = np.random.default_rng(1000 + n)
    vals = [int(v) % FR_MOD for v in rng.integers(0, 1 << 62, n)]
    vals = [v * pow(3, 200 + i, FR_MOD) % FR_MOD for i, v in enumerate(vals)]
    return ints_to_limbs([v * FR.R % FR_MOD for v in vals]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _reference_stages(n):
    """[A_0, ..., A_log2(n)] as (16, n) planes, from the reference's FFT of
    size n on the upsampled subsequences."""
    x = _input(n)
    dom = JDomain(n)
    stages = []
    for t in range(n.bit_length()):
        r, Lt = n >> t, 1 << t
        A = np.zeros((16, r, Lt), np.int64)
        for b in range(r):
            y = np.zeros((16, n), np.uint32)
            y[:, ::r] = x[:, b::r]
            A[:, b, :] = np.asarray(jfft.fft(jnp.asarray(y), dom))[:, :Lt]
        stages.append(A.reshape(16, n))
    return stages


def want_t(want, t):
    return torch.from_numpy(want[t].astype(np.int32))


@pytest.mark.parametrize("n", [16, 256])
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_fft_stages_plain_matches_reference_at_every_boundary(s, n):
    want = _reference_stages(n)
    logn = n.bit_length() - 1
    dom = EvaluationDomain(n, "cpu")
    A = torch.from_numpy(_input(n).astype(np.int32))
    assert np.array_equal(A.numpy(), want[0])
    t, launches = 0, dict(fk.LAUNCHES)
    while t < logn:
        st = min(s, logn - t)
        A = fk.fft_stages_plain(A, dom.forward_roots, t, st, FR)
        if st <= fk.MAX_STAGES:
            assert torch.equal(fk.fft_stages(want_t(want, t),
                                             dom.forward_roots, t, st, FR), A)
        t += st
        assert np.array_equal(A.numpy().astype(np.int64), want[t]), t
    assert dict(fk.LAUNCHES) == launches      # the plain version on the CPU
    # the stage entry chained at s stages a launch, and the FFT, end at the
    # same plane
    A, t, sk = torch.from_numpy(_input(n).astype(np.int32)), 0, min(
        s, fk.MAX_STAGES)
    while t < logn:
        st = min(sk, logn - t)
        A, t = fk.fft_stages(A, dom.forward_roots, t, st, FR), t + st
    assert np.array_equal(A.numpy().astype(np.int64), want[logn])
    assert np.array_equal(pfft.fft(torch.from_numpy(_input(n).astype(
        np.int32)), dom).numpy().astype(np.int64), want[logn])


def test_fft_stages_rejects_bad_stage_ranges():
    A = torch.zeros((16, 16), dtype=torch.int32)
    roots = EvaluationDomain(16, "cpu").forward_roots
    for t, s in ((0, 0), (0, fk.MAX_STAGES + 1), (3, 2)):
        with pytest.raises(ValueError):
            fk.fft_stages(A, roots, t, s, FR)


@pytest.mark.cuda
@pytest.mark.parametrize("log2n", [10, 17, 19])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_fft_stages_kernel_matches_plain_on_card(s, log2n):
    """The stage kernel against its plain version at every boundary it
    reaches, s stages a launch, on canonical inputs at 2^10 and at the
    proof's FFT sizes; and the whole FFT at s stages a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = 1 << log2n
    rng = np.random.default_rng(log2n)
    x = rng.integers(0, 1 << 16, (16, n)).astype(np.int32)
    x[15] %= 0x3064
    A = torch.from_numpy(x).cuda()
    roots = EvaluationDomain(n, "cuda").forward_roots
    t, launches = 0, fk.LAUNCHES["butterfly"]
    while t < log2n:
        st = min(s, log2n - t)
        got = fk.fft_stages(A, roots, t, st, FR)
        assert torch.equal(got, fk.fft_stages_plain(A, roots, t, st, FR))
        A, t = got, t + st
    assert fk.LAUNCHES["butterfly"] - launches == -(-log2n // s)
