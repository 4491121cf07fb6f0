"""aztec_tpu_torch.crypto.pedersen (the host Pedersen hash over Grumpkin)
against aztec_tpu.crypto.pedersen, and a ``pedersen_blake2s`` transcript of
the port against the reference's, on inputs made from seeds with numpy.
Both sides are Python integers: no device and no XLA compile."""

import numpy as np
import pytest

from aztec_tpu.crypto import pedersen as jped
from aztec_tpu.plonk import manifests as jmanifests
from aztec_tpu.transcript.transcript import Transcript as JTranscript
from aztec_tpu_torch.crypto import pedersen
from aztec_tpu_torch.ff.bn254 import FQ_MOD, FR_MOD
from aztec_tpu_torch.plonk import manifests
from aztec_tpu_torch.transcript.transcript import Transcript


def _values(seed, n):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR_MOD
            for row in words]
    # edges: zero (the hash of 0 is infinity), one, an even value (skew),
    # and p - 1
    return [0, 1, 2, FR_MOD - 1] + vals


@pytest.mark.parametrize("hash_index", [0, 3])
def test_hash_single_matches_reference(hash_index):
    for v in _values(hash_index, 4):
        assert pedersen.hash_single(v, hash_index) == jped.hash_single(
            v, hash_index)


def test_compress_native_matches_reference():
    vals = _values(7, 6)
    for left, right in zip(vals, reversed(vals)):
        for hash_index in (0, 2):
            got = pedersen.compress_native(left, right, hash_index)
            assert got == jped.compress_native(left, right, hash_index)
    # x of left * G_0' + right * G_1' (the stitched ladders) is on the curve
    pt = pedersen.g_add(pedersen.hash_single(5, 0), pedersen.hash_single(9, 1))
    assert pedersen.g_on_curve(pt)


@pytest.mark.parametrize("base", ["grumpkin_one", "generator_3"])
def test_g_mul_matches_reference(base):
    """g_mul and the fixed-base ladders, walked in Jacobian coordinates,
    give the reference's affine points; Grumpkin's order is bn254's Fq
    modulus, so k = FQ_MOD gives infinity."""
    pt = (pedersen.GRUMPKIN_GEN if base == "grumpkin_one"
          else pedersen.get_generator(3))
    for k in [0, 1, 2, FQ_MOD - 1, FQ_MOD, FQ_MOD + 1] + _values(11, 3):
        assert pedersen.g_mul(k, pt) == jped.g_mul(k, pt)
    for v in _values(13, 3):
        for bits in (254, 128, 32):
            v %= 1 << bits
            assert (pedersen.fixed_base_scalar_mul(v, bits, 3)
                    == jped.fixed_base_scalar_mul(v, bits, 3))
            assert (pedersen.fixed_base_scalar_mul_g1(v, bits)
                    == jped.fixed_base_scalar_mul_g1(v, bits))


@pytest.mark.parametrize("nbytes", [0, 1, 31, 32, 100])
def test_compress_buffer_to_field_matches_reference(nbytes):
    data = np.random.default_rng(nbytes).integers(
        0, 256, size=nbytes, dtype=np.uint8).tobytes()
    got = pedersen.compress_buffer_to_field(data)
    assert got == jped.compress_buffer_to_field(data)
    assert 0 <= got < FR_MOD


def _run_transcript(cls, manifest, rng_seed):
    """Every round of ``manifest`` with seeded element bytes, 16-byte
    challenges, the Pedersen + Blake2s hasher; returns all challenges."""
    rng = np.random.default_rng(rng_seed)
    t = cls(manifest, "pedersen_blake2s", 16)
    for r in range(manifest.get_num_rounds()):
        rm = manifest.get_round_manifest(r)
        for el in rm.elements:
            t.add_element(el.name, rng.integers(0, 256, size=el.num_bytes,
                                                dtype=np.uint8).tobytes())
        t.apply_fiat_shamir(rm.challenge)
    return t.challenges


def test_pedersen_blake2s_transcript_matches_reference():
    n_pub = 2
    got = _run_transcript(Transcript,
                          manifests.standard_unrolled_manifest(n_pub), 11)
    want = _run_transcript(JTranscript,
                           jmanifests.standard_unrolled_manifest(n_pub), 11)
    assert got == want
    assert any(len(v) > 1 for v in got.values())
