"""The port's work-queue executor seam (aztec_tpu_torch/plonk/work_queue.py)
against tests/test_work_queue.py's cases and aztec_tpu's proof bytes.

Mechanics with stub items; the 4-way coset split against the direct coset
FFT; and the port's prover with every MSM offloaded through the seam (host
golden group math) and every coset FFT split into quarters placed by a
``MeshExecutor`` over four CPU shards,
whose proof must equal, byte for byte, the committed ``standard_drive1``
vector: aztec_tpu's proof, which tests/test_torch_plonk.py holds the port's
inline proof equal to.
"""

import os
import sys

import numpy as np
import pytest
import torch

from aztec_tpu_torch.ff import FR, limb
from aztec_tpu_torch.ff.bn254 import FR_MOD
from aztec_tpu_torch.numeric.bigint import ints_to_limbs, limbs_to_ints
from aztec_tpu_torch.parallel import Mesh
from aztec_tpu_torch.plonk.work_queue import (
    Executor, MeshExecutor, WorkItem, WorkQueue, WorkType, small_fft_quarter)
from aztec_tpu_torch.poly import fft_ops as pfft
from aztec_tpu_torch.poly.domain import EvaluationDomain

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402

N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    k = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(k)


def test_queue_counts_and_order():
    q = WorkQueue()
    log = []
    q.add_to_queue(WorkItem(WorkType.IFFT, "w_1", lambda: "lag1",
                            lambda r: log.append(("ifft", r))))
    q.add_to_queue(WorkItem(WorkType.MSM, "W_1", lambda: "sc1",
                            lambda r: log.append(("msm", r)), size=32))
    q.add_to_queue(WorkItem(WorkType.FFT, "w_1", lambda: "mono1",
                            lambda r: log.append(("fft", r))))
    info = q.get_queued_work_item_info()
    assert (info.num_scalar_multiplications, info.num_ffts,
            info.num_iffts) == (1, 1, 1)
    assert q.get_scalar_multiplication_data(0) == "sc1"
    assert q.get_scalar_multiplication_size(0) == 32
    assert q.get_ifft_data(0) == "lag1"
    assert q.get_fft_data(0) == "mono1"
    q.put_scalar_multiplication_data((1, 2), 0)
    assert log == [("msm", (1, 2))]
    with pytest.raises(IndexError):
        q.get_scalar_multiplication_data(1)
    q.flush_queue()
    assert q.get_queued_work_item_info().num_scalar_multiplications == 0


def test_external_executor_is_consulted_first():
    q = WorkQueue()
    got = []

    class Grabber(Executor):
        def handle(self, key, item):
            if item.work_type == WorkType.MSM:
                item.put_result("external")
                return True
            return False

    q.add_to_queue(WorkItem(WorkType.MSM, "W_1", lambda: "sc",
                            lambda r: got.append(r)))
    q.process_queue(Grabber())
    assert got == ["external"]
    assert q.get_queued_work_item_info().num_scalar_multiplications == 0


class _Key:
    """The two domains and the zero extension of a proving key."""

    def __init__(self, n):
        self.n = n
        self.device = torch.device("cpu")
        self.small_domain = EvaluationDomain(n, "cpu")
        self.large_domain = EvaluationDomain(4 * n, "cpu")

    def _extend(self, mono):
        return torch.cat([mono, mono.new_zeros((16, 3 * self.n))], dim=1)


def _mono(seed):
    rng = np.random.default_rng(seed)
    vals = [int(v) % FR_MOD for v in rng.integers(1, 1 << 62, size=N)]
    return ints_to_limbs([v * FR.R % FR_MOD for v in vals]).astype(np.int32)


def test_small_fft_split_matches_direct_coset_fft():
    """Four SMALL_FFT quarters, interleaved, equal the direct 4n coset FFT
    limb for limb (tests/test_torch_fft.py holds the port's coset FFT to
    aztec_tpu's)."""
    key = _Key(N)
    mono = torch.from_numpy(_mono(11))
    direct = pfft.coset_fft(key._extend(mono), key.large_domain)

    got = []
    q = WorkQueue(key)
    q.add_to_queue(WorkItem(WorkType.FFT, "w_1", lambda: mono,
                            lambda r: got.append(r)))
    q.expand_small_ffts()
    assert q.get_queued_work_item_info().num_ffts == 0
    assert len(q.items) == 4
    for i in range(4):
        data, j = q.get_small_fft_data(i)
        assert j == i and data is mono
    q.process_queue()
    assert len(got) == 1 and torch.equal(got[0], direct)


def test_small_fft_quarters_distributable():
    """Quarters serviced out of order, each put through the putter, fire
    the assembly once with the right interleave."""
    key = _Key(N)
    mono = torch.from_numpy(_mono(13))
    direct = pfft.coset_fft(key._extend(mono), key.large_domain)
    got = []
    q = WorkQueue(key)
    q.add_to_queue(WorkItem(WorkType.FFT, "w_1", lambda: mono,
                            lambda r: got.append(r)))
    q.expand_small_ffts()
    for i in (2, 0, 3, 1):
        data, j = q.get_small_fft_data(i)
        q.put_small_fft_data(small_fft_quarter(key, data, j), i)
    assert len(got) == 1 and torch.equal(got[0], direct)


def test_mesh_executor_places_quarters():
    """A MeshExecutor services every quarter (and only the quarters of an
    FFT, not the FFT itself or an iFFT) on its mesh."""
    key = _Key(N)
    mono = torch.from_numpy(_mono(17))
    direct = pfft.coset_fft(key._extend(mono), key.large_domain)
    ex = MeshExecutor(Mesh.local(4, "cpu"))
    for t in (WorkType.FFT, WorkType.IFFT):
        assert not ex.handle(key, WorkItem(t, "w_1", lambda: mono, None))
    got = []
    q = WorkQueue(key)
    q.add_to_queue(WorkItem(WorkType.FFT, "w_1", lambda: mono,
                            lambda r: got.append(r)))
    q.process_queue(ex)
    assert len(got) == 1 and torch.equal(got[0], direct)


class Offload(Executor):
    """MSM items through the getter data with host golden group math (an
    'external device' sharing no code path with the port's MSM); SMALL_FFT
    quarters through a MeshExecutor over four CPU shards."""

    splits_ffts = True

    def __init__(self):
        self.serviced = {WorkType.MSM: 0, WorkType.SMALL_FFT: 0}
        self.mesh = MeshExecutor(Mesh.local(4, "cpu"))

    def handle(self, key, item):
        from aztec_tpu_torch.curves.golden import GoldenCurve
        from aztec_tpu_torch.curves.spec import BN254_G1

        if item.work_type == WorkType.SMALL_FFT:
            self.serviced[WorkType.SMALL_FFT] += 1
            return self.mesh.handle(key, item)
        if item.work_type != WorkType.MSM:
            return False
        scalars = limbs_to_ints(item.get_data().numpy().astype(np.uint32))
        fq = BN254_G1.field
        X, Y = (limbs_to_ints(limb.from_mont(p, fq).numpy().astype(np.uint32))
                for p in key.srs.get_monomials(len(scalars)))
        g = GoldenCurve(BN254_G1)
        acc = None
        for s, p in zip(scalars, zip(X, Y)):
            if s:
                t = g.mul(s, p)
                acc = t if acc is None else g.add(acc, t)
        item.put_result(acc)
        self.serviced[WorkType.MSM] += 1
        return True


def test_prover_offloaded_proof_equals_inline_bytes():
    from make_vectors import CIRCUITS, counter_rng

    name = "standard_drive1"
    rec, _ = plonk_cases.load_vector(name)
    build, seed = CIRCUITS[name]
    c = build(plonk_cases.port_classes())
    prover = c.create_prover()
    prover.rng = counter_rng(seed)
    ex = Offload()
    prover.executor = ex
    proof = prover.construct_proof()
    # 3 wires + Z + 3 quotient pieces + PI_Z + PI_Z_OMEGA; 4 coset FFTs
    assert ex.serviced == {WorkType.MSM: 9, WorkType.SMALL_FFT: 16}
    assert proof.hex() == rec["proof"]
