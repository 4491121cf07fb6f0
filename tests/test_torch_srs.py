"""aztec_tpu_torch.srs and curves.fixed_base against aztec_tpu and the
committed dev-SRS table.

- ``fixed_base_mul`` of tau^i, i < 2^8, through ``to_affine``, equals the
  first 2^8 columns of .bench_cache/points_2pow20.npz bit for bit (aztec_tpu's
  own fixed_base_mul made that table, scripts/gen_points.py); scalars 0, 1
  and r - 1 against host g1_mul;
- ``FileReferenceStringFactory`` reads a transcript that aztec_tpu's
  ``write_dev_srs`` wrote, and agrees with ``FakeReferenceStringFactory``;
- the transcript writer and reader round-trip, with aztec_tpu's bytes;
- ``lagrange_base.transform_srs`` equals aztec_tpu's at n = 8.
"""

import functools
import os

import numpy as np
import pytest
import torch

from aztec_tpu.srs import io as jio
from aztec_tpu.srs import lagrange_base as jlagrange
from aztec_tpu.srs import reference_string as jrs
from aztec_tpu_torch.curves import group
from aztec_tpu_torch.curves.fixed_base import fixed_base_mul
from aztec_tpu_torch.curves.io import planes_to_ints
from aztec_tpu_torch.curves.pairing import g1_mul
from aztec_tpu_torch.curves.spec import BN254_G1
from aztec_tpu_torch.ff import FQ, FR_MOD, limb
from aztec_tpu_torch.numeric.bigint import ints_to_limbs
from aztec_tpu_torch.srs import io as srs_io
from aztec_tpu_torch.srs import lagrange_base
from aztec_tpu_torch.srs.reference_string import (
    DEV_TAU, FakeReferenceStringFactory, FileReferenceStringFactory,
    load_point_table, write_dev_srs)

N = 1 << 8
SPECIAL = (0, 1, FR_MOD - 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _fixed_base():
    """fixed_base_mul (w = 4) of tau^0 .. tau^(N-1), then 0, 1, r - 1."""
    taus = [pow(DEV_TAU, i, FR_MOD) for i in range(N)] + list(SPECIAL)
    sc = torch.from_numpy(ints_to_limbs(taus).astype(np.int32))
    return group.to_affine(fixed_base_mul(sc, BN254_G1, w=4), FQ)


def test_fixed_base_matches_point_table():
    x, y, inf = _fixed_base()
    X, Y = load_point_table(N)
    assert np.array_equal(x[:, :N].numpy(), X.astype(np.int32))
    assert np.array_equal(y[:, :N].numpy(), Y.astype(np.int32))
    assert not bool(inf[:N].any())


def test_fixed_base_special_scalars():
    x, y, inf = _fixed_base()
    xs = planes_to_ints(limb.from_mont(x[:, N:], FQ))
    ys = planes_to_ints(limb.from_mont(y[:, N:], FQ))
    got = [None if f else (a, b) for a, b, f in zip(xs, ys, inf[N:].tolist())]
    assert got == [g1_mul(k, (1, 2)) for k in SPECIAL]


def test_file_srs_reads_reference_transcript(tmp_path):
    d = str(tmp_path / "ref")
    jrs.write_dev_srs(d, 16)
    mine = str(tmp_path / "port")
    assert write_dev_srs(mine, 16) == DEV_TAU
    with open(os.path.join(d, "transcript00.dat"), "rb") as f:
        ref_bytes = f.read()
    with open(os.path.join(mine, "transcript00.dat"), "rb") as f:
        assert f.read() == ref_bytes
    files = FileReferenceStringFactory(d, device="cpu")
    fake = FakeReferenceStringFactory(device="cpu")
    got, want = files.get_prover_srs(17), fake.get_prover_srs(17)
    assert torch.equal(got.X, want.X) and torch.equal(got.Y, want.Y)
    assert files.get_verifier_srs().g2_x == fake.get_verifier_srs().g2_x


def test_transcript_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    pts = [g1_mul(int(k), (1, 2)) for k in rng.integers(1, 1 << 62, 5)]
    X = ints_to_limbs([p[0] for p in pts])
    Y = ints_to_limbs([p[1] for p in pts])
    g2 = [((1, 2), (3, 4)), ((5, 6), (7, 8))]
    mine, ref = tmp_path / "port.dat", tmp_path / "ref.dat"
    srs_io.write_transcript(str(mine), X, Y, g2, transcript_number=1,
                            total_transcripts=3, start_from=5)
    jio.write_transcript(str(ref), X, Y, g2, transcript_number=1,
                         total_transcripts=3, start_from=5)
    assert mine.read_bytes() == ref.read_bytes()
    man, x, y, g2b = srs_io.read_transcript(str(mine))
    assert (man.num_g1_points, man.start_from, man.transcript_number) == (5, 5, 1)
    assert np.array_equal(x, X) and np.array_equal(y, Y)
    assert srs_io.read_g2_points(g2b) == g2
    bad = bytearray(mine.read_bytes())
    bad[40] ^= 1
    mine.write_bytes(bytes(bad))
    with pytest.raises(ValueError):
        srs_io.read_transcript(str(mine))


def test_lagrange_transform_matches_reference():
    monomials = [g1_mul(pow(DEV_TAU, i, FR_MOD), (1, 2)) for i in range(8)]
    assert (lagrange_base.transform_srs(monomials)
            == jlagrange.transform_srs(monomials))
