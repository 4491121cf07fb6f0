"""Prover / verifier reference strings.

Port of aztec_tpu/srs/reference_string.py:

- ``FakeReferenceStringFactory``, the dev SRS from a known tau:
  - the dev tau up to 2^20 points: a slice of the committed table
    ``.bench_cache/points_2pow20.npz`` (tau^i * G, Montgomery 16-bit
    planes).  Unlike the reference, the table is checked on load: its
    point 1 must equal tau * G;
  - otherwise up to 512 points: tau^i * G on the host;
  - any other size, including more than 2^20 points: ``fixed_base_mul``
    of the powers of tau on the device, then ``group.to_affine``;
- ``FileReferenceStringFactory``: Ignition transcript files (``io.py``),
  and ``write_dev_srs``, which writes a dev SRS in that format.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..curves import group, tower
from ..curves.fixed_base import fixed_base_mul
from ..curves.io import affine_to_device
from ..curves.pairing import g1_mul
from ..curves.spec import BN254_G1
from ..ff import FR, limb
from ..ff.bn254 import FR_MOD
from ..numeric.bigint import int_to_limbs, ints_to_limbs, limbs_to_int
from ..poly.domain import mont_plane, powers_table
from . import io as srs_io

DEV_TAU = 0xB0B0CAFE12345678DEADBEEF
POINT_TABLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".bench_cache", "points_2pow20.npz")
HOST_MAX = 512
TABLE_MAX = 1 << 20


class ProverReferenceString:
    def __init__(self, X, Y, size: int):
        self.X = X  # (16, size) Montgomery Fq limb planes
        self.Y = Y
        self.size = size

    def get_monomials(self, n: int):
        if n > self.size:
            raise ValueError(f"SRS too small: {n} > {self.size}")
        return self.X[:, :n], self.Y[:, :n]


class VerifierReferenceString:
    def __init__(self, g2_x, g2_gen=tower.G2_GEN):
        self.g2_x = g2_x   # [x]_2 affine Fq2 pair
        self.g2_gen = g2_gen


def load_point_table(n: int, tau: int = DEV_TAU, path: str = POINT_TABLE):
    """The first n points of the committed table as uint16 numpy planes
    (X, Y), after checking that its point 1 is tau * G."""
    if n > TABLE_MAX:
        raise ValueError(f"the point table holds 2^20 points, not {n}")
    with np.load(path) as d:
        X = d["X"][:, :max(n, 2)]
        Y = d["Y"][:, :max(n, 2)]
    fq = BN254_G1.field
    got = tuple(fq.from_mont_int(limbs_to_int(p[:, 1].astype(np.uint32)))
                for p in (X, Y))
    if got != g1_mul(tau, (BN254_G1.gen_x, BN254_G1.gen_y)):
        raise ValueError(f"{path}: point 1 is not tau * G for tau {tau:#x}")
    return X[:, :n], Y[:, :n]


def _powers(tau: int, n: int, first: int = 1) -> list:
    """tau^first .. tau^(first + n - 1) mod r."""
    t = pow(tau, first, FR_MOD)
    out = []
    for _ in range(n):
        out.append(t)
        t = t * tau % FR_MOD
    return out


class FakeReferenceStringFactory:
    """SRS from a known tau (dev/test only)."""

    def __init__(self, tau: int | None = None, device="cuda"):
        self.tau = tau if tau is not None else DEV_TAU
        self.device = torch.device(device)
        self._device_srs = None  # the largest device-computed SRS so far
        self.last_seconds = 0.0  # of the last get_prover_srs, synchronised

    def get_prover_srs(self, n: int) -> ProverReferenceString:
        t = time.perf_counter()
        srs = self._prover_srs(n)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_seconds = time.perf_counter() - t
        return srs

    def _prover_srs(self, n: int) -> ProverReferenceString:
        if (self.tau == DEV_TAU and n <= TABLE_MAX
                and os.path.exists(POINT_TABLE)):
            X, Y = load_point_table(n, self.tau)
            dev = self.device
            return ProverReferenceString(
                torch.as_tensor(X.astype(np.int32), device=dev),
                torch.as_tensor(Y.astype(np.int32), device=dev), n)
        if n <= HOST_MAX:
            return self.host_prover_srs(n)
        return self.device_prover_srs(n)

    def host_prover_srs(self, n: int) -> ProverReferenceString:
        """tau^i * G computed on the host (n <= 512)."""
        if n > HOST_MAX:
            raise ValueError(f"the host path stops at {HOST_MAX} points")
        pts = [g1_mul(t, (1, 2)) for t in _powers(self.tau, n, 0)]
        X, Y = affine_to_device(pts, BN254_G1, self.device)
        return ProverReferenceString(X, Y, n)

    def device_prover_srs(self, n: int) -> ProverReferenceString:
        """tau^i * G by ``fixed_base_mul`` on the device, then one batched
        normalisation to affine; the powers of tau are a device table.  The
        factory keeps the largest such SRS and serves smaller requests from
        its first points."""
        got = self._device_srs
        if got is not None and got.size >= n:
            return ProverReferenceString(got.X[:, :n], got.Y[:, :n], n)
        sc = limb.from_mont(powers_table(mont_plane(self.tau, self.device), n),
                            FR)
        x, y, inf = group.to_affine(fixed_base_mul(sc, BN254_G1),
                                    BN254_G1.field)
        if bool(inf.any()):
            raise ValueError("an SRS point is at infinity: tau is a root of "
                             "unity of small order")
        self._device_srs = ProverReferenceString(x, y, n)
        return self._device_srs

    def get_verifier_srs(self) -> VerifierReferenceString:
        return VerifierReferenceString(tower.g2_mul(self.tau, tower.G2_GEN))


class MemReferenceString(ProverReferenceString):
    pass


def write_dev_srs(srs_dir: str, n: int, tau: int | None = None) -> int:
    """Write an Ignition-layout dev SRS ([tau^1..tau^n]G, g2 = [tau]_2),
    readable by both this package's and the reference's file readers.
    Returns tau."""
    os.makedirs(srs_dir, exist_ok=True)
    tau = tau if tau is not None else DEV_TAU
    pts = [g1_mul(v, (1, 2)) for v in _powers(tau, n)]
    srs_io.write_transcript(
        os.path.join(srs_dir, "transcript00.dat"),
        ints_to_limbs([p[0] for p in pts]),
        ints_to_limbs([p[1] for p in pts]),
        [tower.g2_mul(tau, tower.G2_GEN), tower.G2_GEN],
    )
    return tau


class FileReferenceStringFactory:
    """Loads transcript .dat files (Ignition format, srs/io.cpp).

    Layout facts from the reference reader (srs/io.cpp:134-183): monomial 0
    is always the group generator (files hold [x^1]G onward), and the
    verifier's [x]_2 is the first g2 element."""

    def __init__(self, srs_dir: str, device="cuda"):
        self.srs_dir = srs_dir
        self.device = torch.device(device)

    def get_prover_srs(self, n: int) -> ProverReferenceString:
        xs = [int_to_limbs(BN254_G1.gen_x)[:, None]]
        ys = [int_to_limbs(BN254_G1.gen_y)[:, None]]
        got = 1
        i = 0
        while got < n:
            path = os.path.join(self.srs_dir, f"transcript{i:02d}.dat")
            _, x, y, _ = srs_io.read_transcript(path)
            xs.append(x)
            ys.append(y)
            got += x.shape[1]
            i += 1

        def mont(planes):
            t = np.concatenate(planes, axis=1)[:, :n].astype(np.int32)
            return limb.to_mont(torch.as_tensor(t, device=self.device),
                                BN254_G1.field)

        return ProverReferenceString(mont(xs), mont(ys), n)

    def get_verifier_srs(self) -> VerifierReferenceString:
        path = os.path.join(self.srs_dir, "transcript00.dat")
        _, _, _, g2b = srs_io.read_transcript(path)
        return VerifierReferenceString(srs_io.read_g2_points(g2b)[0])
