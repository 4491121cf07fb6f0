"""aztec_tpu_torch.ff (plain limb arithmetic and the K1 wrappers) against
aztec_tpu.ff.limb and the pure-Python golden, bit-exact on the limbs.

Inputs are 64 canonical elements per field made with numpy from a seed,
including 0, 1 and p - 1.  The JAX side runs all functions in one jitted
function per field, so each field costs one XLA:CPU compile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aztec_tpu.ff import FQ as JFQ, FR as JFR, limb as jlimb
from aztec_tpu_torch.ff import FQ, FR, golden, limb
from aztec_tpu_torch.ff import field_kernels as fk
from aztec_tpu_torch.numeric.bigint import ints_to_limbs, limbs_to_ints

SPECS = {"fr": (FR, JFR), "fq": (FQ, JFQ)}
POW_BITS = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1], np.uint32)  # e = 1869


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _elements(p: int, seed: int, count: int = 64):
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(count, 16), dtype=np.int64)
    vals = [int(sum(int(l) << (16 * i) for i, l in enumerate(row))) % p
            for row in limbs]
    vals[:3] = [0, 1, p - 1]
    return vals


def _t(vals):
    return torch.from_numpy(ints_to_limbs(vals).astype(np.int32))


def _ints(t):
    return limbs_to_ints(t.numpy().astype(np.uint32))


@functools.lru_cache(maxsize=None)
def _inputs(name):
    spec = SPECS[name][0]
    return _elements(spec.modulus, 1), _elements(spec.modulus, 2)


@functools.lru_cache(maxsize=None)
def _jax_results(name):
    """Every limb function of the reference on the same inputs, one jit."""
    jspec = SPECS[name][1]
    a, b = _inputs(name)
    A = jnp.asarray(ints_to_limbs(a))
    B = jnp.asarray(ints_to_limbs(b))
    cols = jnp.asarray(_columns())

    @jax.jit
    def run(A, B, cols):
        mask = (A[0] & 1) == 1
        return {
            "canon": jlimb.canon(cols)[0],
            "canon_carry": jlimb.canon(cols)[1],
            "add_mod": jlimb._raw_add_mod(A, B, jspec),
            "sub_mod": jlimb._raw_sub_mod(A, B, jspec),
            "neg_mod": jlimb._raw_neg_mod(A, jspec),
            "mont_mul": jlimb._raw_mont_mul(A, B, jspec),
            "mont_sqr": jlimb._raw_mont_sqr(A, jspec),
            "to_mont": jlimb._raw_to_mont(A, jspec),
            "from_mont": jlimb._raw_from_mont(A, jspec),
            "select": jlimb.select(mask, A, B),
            "eq": jlimb.eq(A, A.at[:, ::2].set(B[:, ::2])),
            "is_zero": jlimb.is_zero(A),
            "mont_pow": jlimb.mont_pow(A, POW_BITS, jspec),
            "inv_mont": jlimb.inv_mont(A, jspec),
            "batch_inv_mont": jlimb._raw_batch_inv_mont(A, jspec, -1),
            "mul_add": jlimb._raw_add_mod(jlimb._raw_mont_mul(A, B, jspec),
                                          A[:, ::-1], jspec),
        }

    return {k: np.asarray(v) for k, v in run(A, B, cols).items()}


def _columns():
    rng = np.random.default_rng(3)
    return rng.integers(0, 1 << 32, size=(16, 64), dtype=np.uint64).astype(
        np.uint32)


def _port(name, fn):
    spec = SPECS[name][0]
    a, b = _inputs(name)
    A, B = _t(a), _t(b)
    mask = (A[0] & 1) == 1
    if fn == "canon":
        return limb.canon(torch.from_numpy(_columns().astype(np.int64)))[0]
    if fn == "canon_carry":
        return limb.canon(torch.from_numpy(_columns().astype(np.int64)))[1]
    if fn in ("add_mod", "sub_mod", "mont_mul"):
        return getattr(limb, fn)(A, B, spec)
    if fn in ("neg_mod", "mont_sqr", "to_mont", "from_mont", "inv_mont",
              "batch_inv_mont"):
        return getattr(limb, fn)(A, spec)
    if fn == "select":
        return limb.select(mask, A, B)
    if fn == "eq":
        B2 = A.clone()
        B2[:, ::2] = B[:, ::2]
        return limb.eq(A, B2)
    if fn == "is_zero":
        return limb.is_zero(A)
    if fn == "mont_pow":
        return limb.mont_pow(A, POW_BITS, spec)
    if fn == "mul_add":
        return limb.mul_add(A, B, A.flip(1), spec)
    raise KeyError(fn)


FUNCS = ("canon", "canon_carry", "add_mod", "sub_mod", "neg_mod", "mont_mul",
         "mont_sqr", "to_mont", "from_mont", "select", "eq", "is_zero",
         "mont_pow", "inv_mont", "batch_inv_mont", "mul_add")


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("fn", FUNCS)
def test_limb_matches_jax(field, fn):
    got = _port(field, fn).numpy().astype(np.int64)
    want = _jax_results(field)[fn].astype(np.int64)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


GOLDEN = {
    "add_mod": lambda s, x, y: golden.add(s, x, y),
    "sub_mod": lambda s, x, y: golden.sub(s, x, y),
    "neg_mod": lambda s, x, y: golden.neg(s, x),
    "mont_mul": lambda s, x, y: golden.mont_mul(s, x, y),
    "mont_sqr": lambda s, x, y: golden.mont_mul(s, x, x),
    "to_mont": lambda s, x, y: golden.to_mont(s, x),
    "from_mont": lambda s, x, y: golden.from_mont(s, x),
    "mont_pow": lambda s, x, y: golden.pow_(s, x, 1869),
    "inv_mont": lambda s, x, y: golden.inv(s, x),
    "batch_inv_mont": lambda s, x, y: golden.inv(s, x),
}


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("fn", sorted(GOLDEN))
def test_limb_matches_golden(field, fn):
    spec = SPECS[field][0]
    a, b = _inputs(field)
    assert _ints(_port(field, fn)) == [GOLDEN[fn](spec, x, y)
                                       for x, y in zip(a, b)]


@pytest.mark.parametrize("field", sorted(SPECS))
def test_field_kernel_wrappers_use_plain_version_on_cpu(field):
    spec = SPECS[field][0]
    a, b = _inputs(field)
    A, B = _t(a), _t(b)
    assert not fk.use_kernels(A)
    before = dict(fk.LAUNCHES)
    assert torch.equal(fk.mont_mul(A, B, spec), limb.mont_mul(A, B, spec))
    assert torch.equal(fk.add_mod(A, B, spec), limb.add_mod(A, B, spec))
    assert torch.equal(fk.sub_mod(A, B, spec), limb.sub_mod(A, B, spec))
    assert torch.equal(fk.mul_add(A, B, A, spec), limb.mul_add(A, B, A, spec))
    tw = B[:, :1]
    plus, minus = fk.butterfly(A, B, tw, spec)
    t = limb.mont_mul(B, tw, spec)
    assert torch.equal(plus, limb.add_mod(A, t, spec))
    assert torch.equal(minus, limb.sub_mod(A, t, spec))
    assert dict(fk.LAUNCHES) == before  # nothing launched on the CPU


def test_cuda_header_constants_match_spec():
    """csrc/field.cuh hard-codes p, R mod p and -p^-1 mod 2^32 per field."""
    import re
    from pathlib import Path

    src = (Path(fk.__file__).parent.parent / "csrc" / "field.cuh").read_text()
    for name, spec in (("Fr", FR), ("Fq", FQ)):
        body = src[src.index(f"struct {name} {{"):]
        body = body[:body.index("NP = ") + 40]
        arrays = [[int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", blk)]
                  for blk in re.findall(r"\{([^{}]*0x[^{}]*)\}", body)]
        P, ONE = arrays[0], arrays[1]
        assert sum(v << (32 * i) for i, v in enumerate(P)) == spec.modulus
        assert sum(v << (32 * i) for i, v in enumerate(ONE)) == spec.R
        np_ = int(re.search(r"NP = 0x([0-9a-f]+)u", body).group(1), 16)
        assert np_ == (-pow(spec.modulus, -1, 1 << 32)) % (1 << 32)


@pytest.mark.cuda
@pytest.mark.parametrize("field", sorted(SPECS))
def test_k1_kernels_match_plain_on_card(field):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = SPECS[field][0]
    a, b = _inputs(field)
    A, B = _t(a).cuda(), _t(b).cuda()
    for fn in ("mont_mul", "add_mod", "sub_mod"):
        assert torch.equal(getattr(fk, fn)(A, B, spec).cpu(),
                           getattr(limb, fn)(A.cpu(), B.cpu(), spec))
    assert torch.equal(fk.mul_add(A, B, A.flip(1), spec).cpu(),
                       limb.mul_add(A.cpu(), B.cpu(), A.flip(1).cpu(), spec))
