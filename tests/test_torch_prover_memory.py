"""The prover's memory plan and the key's host conversions, on the CPU.

- The committed Standard and Turbo vectors (keccak and unrolled), proved
  through the coset-quarter plan (``proving_key.QUARTER_MIN_N`` lowered to
  their size, so the key keeps no 4n coset form and the quotient is
  evaluated a quarter and a lane slice at a time), give aztec_tpu's bytes;
  the stored plan is held to the same bytes by tests/test_torch_plonk.py
  and tests/test_torch_turbo.py.
- ``ints_to_mont`` (each distinct value converted once, Montgomery form by
  ``mont_mul`` by R^2) equals the host's ``v * R mod r``.
- The dev SRS past the host path (``fixed_base_mul`` of a device table of
  powers of tau) equals tau^i G on the host, and the factory serves a
  smaller request from the first points of the larger one it kept.

All integer checks: tolerance zero.
"""

import functools
import os
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402
from make_vectors import CIRCUITS, counter_rng, make_prover  # noqa: E402

FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _quarter_composer(name: str):
    """The vector's circuit on the port's composer, keyed by quarters (the
    unrolled Turbo vector shares the Turbo one's composer and key)."""
    from aztec_tpu_torch.plonk import proving_key

    name = plonk_cases.SAME_CIRCUIT.get(name, name)
    c = CIRCUITS[name][0](plonk_cases.port_classes())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(proving_key, "QUARTER_MIN_N", c.subgroup_size())
        c.compute_proving_key()
    return c


@pytest.mark.parametrize("name", ("standard_drive1", "turbo_drive",
                                  "unrolled_turbo_drive"))
def test_quarter_plan_gives_the_reference_bytes(name):
    rec, _ = plonk_cases.load_vector(name)
    prover = make_prover(_quarter_composer(name), name)
    assert prover.key.quarters and prover.key.n == rec["n"]
    assert all(s.fft is None for s in prover.key.selectors.values())
    prover.rng = counter_rng(CIRCUITS[name][1])
    assert prover.construct_proof().hex() == rec["proof"]


def test_ints_to_mont_matches_host():
    from aztec_tpu_torch.ff import FR
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs
    from aztec_tpu_torch.plonk.proving_key import ints_to_mont

    rng = random.Random(4)
    vals = [0, 1, FR_MOD - 1, 2, 1, 0] + [rng.randrange(FR_MOD)
                                          for _ in range(20)]
    vals += vals[6:12]
    want = ints_to_limbs([v * FR.R % FR_MOD for v in vals]).astype(np.int32)
    assert np.array_equal(ints_to_mont(vals, "cpu").numpy(), want)


def test_device_srs_powers_and_cache(monkeypatch):
    """The device SRS path's table of powers of tau, normalised to affine,
    against tau^i G on the host (``fixed_base_mul`` itself, the same at
    any width, is held to the committed 2^20-point table on the card:
    chip_smoke.py phase 8); a smaller request is served from the larger
    SRS the factory kept."""
    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves.io import affine_to_device
    from aztec_tpu_torch.curves.pairing import g1_mul
    from aztec_tpu_torch.numeric.bigint import limbs_to_ints
    from aztec_tpu_torch.srs import reference_string as rs

    calls = []

    def host_fixed_base(scalars, curve):
        ks = limbs_to_ints(scalars.numpy())
        calls.append(len(ks))
        X, Y = affine_to_device([g1_mul(k, (1, 2)) for k in ks], curve, "cpu")
        return group.from_affine((X, Y), curve.field)

    monkeypatch.setattr(rs, "fixed_base_mul", host_fixed_base)
    monkeypatch.setattr(rs, "HOST_MAX", 8)
    f = rs.FakeReferenceStringFactory(tau=0x1234567, device="cpu")
    big = f.get_prover_srs(12)
    want = f.host_prover_srs(8)
    assert torch.equal(big.X[:, :8], want.X)
    assert torch.equal(big.Y[:, :8], want.Y)
    small = f.get_prover_srs(9)
    assert calls == [12]
    assert small.size == 9
    assert torch.equal(small.X, big.X[:, :9])
    assert torch.equal(small.Y, big.Y[:, :9])
