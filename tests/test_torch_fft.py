"""aztec_tpu_torch.poly (Stockham FFT through the K1 butterfly) against
aztec_tpu.poly.fft, bit-exact, and against a host DFT; the bit-reversal
table, ``fft_with_bitrev``, ``fr_mont_plane``, ``poly_eval_many`` and the
barycentric evaluation against aztec_tpu's and host formulas."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.poly import fft_ops as jfft
from aztec_tpu.poly.domain import EvaluationDomain as JDomain
from aztec_tpu_torch.ff import FR
from aztec_tpu_torch.ff.bn254 import FR_MOD
from aztec_tpu_torch.numeric.bigint import ints_to_limbs, limbs_to_ints
from aztec_tpu_torch.poly import EvaluationDomain, arithmetic, domain
from aztec_tpu_torch.poly import fft_ops as pfft

FUNCS = ("fft", "ifft", "coset_fft", "coset_ifft")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    k = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(k)


@functools.lru_cache(maxsize=None)
def _coeffs(n):
    rng = np.random.default_rng(n)
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    vals = [int(sum(int(l) << (16 * i) for i, l in enumerate(row))) % FR_MOD
            for row in limbs]
    return vals


def _mont(vals):
    return ints_to_limbs([v * FR.R % FR_MOD for v in vals])


@pytest.mark.parametrize("n", [16, 256])
@pytest.mark.parametrize("fn", FUNCS)
def test_fft_matches_reference(fn, n):
    x = _mont(_coeffs(n))
    got = getattr(pfft, fn)(torch.from_numpy(x.astype(np.int32)),
                            EvaluationDomain(n, "cpu"))
    want = getattr(jfft, fn)(jnp.asarray(x), JDomain(n))
    assert np.array_equal(got.numpy().astype(np.int64),
                          np.asarray(want).astype(np.int64))


def _from_mont(t):
    rinv = pow(FR.R, -1, FR_MOD)
    return [v * rinv % FR_MOD for v in limbs_to_ints(t.numpy().astype(np.uint32))]


def test_fft_matches_host_dft_and_inverts():
    n = 16
    dom = EvaluationDomain(n, "cpu")
    c = _coeffs(n)
    x = torch.from_numpy(_mont(c).astype(np.int32))
    ev = pfft.fft(x, dom)
    w = dom.root
    assert _from_mont(ev) == [sum(cj * pow(w, i * j, FR_MOD)
                                  for j, cj in enumerate(c)) % FR_MOD
                              for i in range(n)]
    g = dom.generator
    assert _from_mont(pfft.coset_fft(x, dom)) == [
        sum(cj * pow(g * pow(w, i, FR_MOD), j, FR_MOD)
            for j, cj in enumerate(c)) % FR_MOD for i in range(n)]
    assert torch.equal(pfft.ifft(ev, dom), x)
    assert torch.equal(pfft.coset_ifft(pfft.coset_fft(x, dom), dom), x)


def test_poly_eval_and_kate_divide():
    n = 16
    c = _coeffs(n)
    x = torch.from_numpy(_mont(c).astype(np.int32))
    z = 0x1234567
    fz = sum(cj * pow(z, j, FR_MOD) for j, cj in enumerate(c)) % FR_MOD
    assert arithmetic.poly_eval(x, z) == fz
    src = list(c)
    src[0] = (src[0] - fz) % FR_MOD
    w = _from_mont(arithmetic.kate_divide(
        torch.from_numpy(_mont(src).astype(np.int32)), z))
    # W(X) (X - z) == F(X) - F(z)
    prod = [0] * (n + 1)
    for j, wj in enumerate(w):
        prod[j + 1] = (prod[j + 1] + wj) % FR_MOD
        prod[j] = (prod[j] - z * wj) % FR_MOD
    assert prod[:n] == src and prod[n] == 0


@pytest.mark.parametrize("n", [16, 64])
def test_bitrev_and_fft_with_bitrev(n):
    """``_bit_reverse_indices`` and ``EvaluationDomain.bitrev`` against the
    reference's; ``fft_with_bitrev`` over the forward and inverse root
    tables against the port's FFT and the reference's (n = 16)."""
    from aztec_tpu.poly import domain as jdomain

    ref = jdomain._bit_reverse_indices(n)
    assert np.array_equal(domain._bit_reverse_indices(n), ref)
    d = EvaluationDomain(n, "cpu")
    assert np.array_equal(d.bitrev.numpy(), ref)
    x = _mont(_coeffs(n))
    tx = torch.from_numpy(x.astype(np.int32))
    fwd = pfft.fft_with_bitrev(tx, d.forward_roots, d.bitrev, n)
    assert torch.equal(fwd, pfft.fft(tx, d))
    inv = pfft.fft_with_bitrev(fwd, d.inverse_roots, d.bitrev, n,
                               inverse=True)
    assert _from_mont(inv) == [v * n % FR_MOD for v in _coeffs(n)]
    if n == 16:
        jd = JDomain(n)
        want = jfft.fft_with_bitrev(jnp.asarray(x), jd.forward_roots,
                                    jd.bitrev, n)
        assert np.array_equal(fwd.numpy().astype(np.int64),
                              np.asarray(want).astype(np.int64))


def test_fr_mont_plane_and_poly_eval_many():
    from aztec_tpu.poly import arithmetic as jarith

    for v in (0, 1, FR_MOD - 1, 0xDEADBEEF):
        assert np.array_equal(
            arithmetic.fr_mont_plane(v, "cpu").numpy().astype(np.int64),
            np.asarray(jarith.fr_mont_plane(v)).astype(np.int64))
    k, n = 3, 16
    polys = [_coeffs(n + i)[:n] for i in range(k)]
    stack = np.stack([_mont(p) for p in polys], axis=1)      # (16, k, n)
    z = 0x1234567
    got = arithmetic.poly_eval_many(torch.from_numpy(stack.astype(np.int32)),
                                    z)
    assert got == [sum(c * pow(z, j, FR_MOD) for j, c in enumerate(p))
                   % FR_MOD for p in polys]
    assert got == jarith.poly_eval_many(jnp.asarray(stack), z)


@pytest.mark.parametrize("m", [16, 10])
def test_barycentric_evaluation(m):
    """sum_i L_i(z) f_i over the first m points of a 16-point domain (the
    reference's num_coeffs < domain.size case at m = 10) against the host
    formula and, at m = 10, the reference's."""
    from aztec_tpu.poly import arithmetic as jarith

    n = 16
    d = EvaluationDomain(n, "cpu")
    f = _coeffs(m + 3)[:m]
    z = 0x7654321
    got = arithmetic.compute_barycentric_evaluation(
        torch.from_numpy(_mont(f).astype(np.int32)), z, d)
    num = (pow(z, n, FR_MOD) - 1) * pow(n, -1, FR_MOD) % FR_MOD
    expect = sum(num * pow((z * pow(d.root, -i, FR_MOD) - 1) % FR_MOD, -1,
                           FR_MOD) * fi for i, fi in enumerate(f)) % FR_MOD
    assert got == expect
    if m < n:
        assert got == jarith.compute_barycentric_evaluation(
            jnp.asarray(_mont(f)), z, JDomain(n))
