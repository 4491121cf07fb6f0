"""Prover work queue: the external-executor seam for FFT/MSM offload.

Port of aztec_tpu/plonk/work_queue.py (ref: waffle::work_queue,
work_queue.hpp:69-200).  Between Fiat-Shamir barriers the prover enqueues
MSM / FFT / iFFT items; an external executor (``Executor``, such as
``MeshExecutor`` over the sharded kernels of ``parallel/``) may drain them
through the getter/putter API, and ``process_queue`` services what it
leaves: the FFT-type items in order, then every MSM item of the drain in
ONE batched MSM (``proving_key.commit_scalars``), since nothing in a drain
reads an MSM result.

MSM items carry canonical scalar planes (the reference's getter contract);
data is resolved lazily (``get_data`` at drain time).  ``expand_small_ffts``
splits each FFT item into four coset quarters (the reference's 4-way WASM
split), which an executor may place on different devices; an executor
that sets ``splits_ffts`` (``MeshExecutor`` does) has every drain split
first.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional

import torch


class WorkType(enum.Enum):
    MSM = 1
    FFT = 2        # small-domain monomial -> 4n coset FFT
    IFFT = 3       # lagrange -> monomial
    SMALL_FFT = 4  # one n-sized quarter of a 4n coset FFT (4-way split)


@dataclasses.dataclass
class WorkItem:
    work_type: WorkType
    tag: str                      # transcript tag (MSM) or poly label
    get_data: Callable            # () -> operand planes (lazy)
    put_result: Callable          # (result) -> None (store / transcript)
    size: int = 0                 # MSM length (reference: `constant`)
    index: int = 0                # SMALL_FFT coset quarter j in 0..3


@dataclasses.dataclass
class WorkItemInfo:
    """ref: work_queue.hpp:17-21."""

    num_scalar_multiplications: int
    num_ffts: int
    num_iffts: int


class WorkQueue:
    """ref: work_queue.hpp:69-200 (getter/putter external-executor seam)."""

    def __init__(self, key=None):
        self.key = key
        self.items: List[WorkItem] = []

    # -- producer side (the prover) -----------------------------------------
    def add_to_queue(self, item: WorkItem):
        self.items.append(item)

    def flush_queue(self):
        self.items = []

    # -- consumer side (external executors) ---------------------------------
    def get_queued_work_item_info(self) -> WorkItemInfo:
        c = {t: 0 for t in WorkType}
        for it in self.items:
            c[it.work_type] += 1
        return WorkItemInfo(c[WorkType.MSM], c[WorkType.FFT], c[WorkType.IFFT])

    def _nth(self, work_type: WorkType, i: int) -> WorkItem:
        k = 0
        for it in self.items:
            if it.work_type == work_type:
                if k == i:
                    return it
                k += 1
        raise IndexError(f"no {work_type} item {i}")

    def get_scalar_multiplication_data(self, i: int):
        """(16, m) canonical scalar planes for MSM item i."""
        return self._nth(WorkType.MSM, i).get_data()

    def get_scalar_multiplication_size(self, i: int) -> int:
        return self._nth(WorkType.MSM, i).size

    def put_scalar_multiplication_data(self, result, i: int):
        """result: affine (x, y) host ints or None (infinity); writes the
        commitment into the prover's transcript."""
        self._nth(WorkType.MSM, i).put_result(result)

    def get_ifft_data(self, i: int):
        return self._nth(WorkType.IFFT, i).get_data()

    def put_ifft_data(self, result, i: int):
        self._nth(WorkType.IFFT, i).put_result(result)

    def get_fft_data(self, i: int):
        return self._nth(WorkType.FFT, i).get_data()

    def put_fft_data(self, result, i: int):
        self._nth(WorkType.FFT, i).put_result(result)

    def get_small_fft_data(self, i: int):
        """(monomial (16, n) planes, coset quarter j) for SMALL_FFT item i."""
        it = self._nth(WorkType.SMALL_FFT, i)
        return it.get_data(), it.index

    def put_small_fft_data(self, result, i: int):
        self._nth(WorkType.SMALL_FFT, i).put_result(result)

    # -- 4-way coset split ---------------------------------------------------
    def expand_small_ffts(self):
        """Replace every FFT item with four SMALL_FFT quarter items.
        Quarter j is the n-point coset FFT at generator g w_4n^j, the large
        domain's evaluations at indices 4k + j; when all four have reported,
        the interleaved (16, 4n) result goes to the original put_result."""
        new_items: List[WorkItem] = []
        for it in self.items:
            if it.work_type != WorkType.FFT:
                new_items.append(it)
                continue

            slots = [None] * 4

            def make_put(j, slots=slots, orig_put=it.put_result):
                def put(result):
                    slots[j] = result
                    if all(s is not None for s in slots):
                        # out[:, 4k + j] = slots[j][:, k]
                        inter = torch.stack(slots, dim=-1)
                        orig_put(inter.reshape(inter.shape[0], -1))
                return put

            for j in range(4):
                new_items.append(WorkItem(WorkType.SMALL_FFT, it.tag,
                                          it.get_data, make_put(j), index=j))
        self.items = new_items

    # -- built-in executor ----------------------------------------------------
    def process_queue(self, executor: Optional["Executor"] = None):
        """Drain every item (ref: work_queue.hpp:208-280).  ``executor`` is
        asked first for each item, after the FFTs are split into quarters
        if it ``splits_ffts``; what it leaves runs on the key's device,
        the MSMs in one batch."""
        from . import proving_key

        if executor is not None and executor.splits_ffts:
            self.expand_small_ffts()
        msms = []
        for it in self.items:
            if executor is not None and executor.handle(self.key, it):
                continue
            if it.work_type == WorkType.MSM:
                msms.append(it)
            else:
                _local_execute(self.key, it)
        if msms:
            results = proving_key.commit_scalars(
                self.key.srs, [it.get_data() for it in msms])
            for it, pt in zip(msms, results):
                it.put_result(pt)
        self.flush_queue()


class Executor:
    """External-executor interface: return True when the item was
    serviced (its put_result must have been called).  ``splits_ffts``:
    the queue hands it the coset FFTs as SMALL_FFT quarters."""

    splits_ffts = False

    def handle(self, key, item: WorkItem) -> bool:  # pragma: no cover
        raise NotImplementedError


def _local_execute(key, it: WorkItem):
    from ..poly import fft_ops as pfft

    if it.work_type == WorkType.IFFT:
        it.put_result(pfft.ifft(it.get_data(), key.small_domain))
    elif it.work_type == WorkType.FFT:
        it.put_result(pfft.coset_fft(key._extend(it.get_data()),
                                     key.large_domain))
    elif it.work_type == WorkType.SMALL_FFT:
        it.put_result(small_fft_quarter(key, it.get_data(), it.index))
    else:  # pragma: no cover
        raise ValueError(it.work_type)


def small_fft_quarter(key, mono, j: int, domain=None):
    """Quarter j of the 4n coset FFT of a (16, n) monomial: the n-point
    coset FFT with generator g w_4n^j (large-domain indices 4k + j).  Exact
    for degree < n, which every queued monomial satisfies.  ``domain``: the
    n-point domain to run on (default the key's; another device's for an
    executor that places quarters)."""
    from ..ff.bn254 import FR_MOD
    from ..poly import fft_ops as pfft

    g = key.small_domain.generator
    w4n = key.large_domain.root
    gen = g * pow(w4n, j, FR_MOD) % FR_MOD
    return pfft.coset_fft(mono, domain or key.small_domain, generator=gen)


class MeshExecutor(Executor):
    """Services MSM items with the sharded Pippenger
    (``parallel.sharded_msm``) over a ``parallel.Mesh``, and places SMALL_FFT
    quarter j on the mesh's device j % D (ref: work_queue.hpp:166-200)."""

    splits_ffts = True

    def __init__(self, mesh):
        self.mesh = mesh
        self._domains = {}

    def _domain(self, n: int, device: torch.device):
        from ..poly.domain import EvaluationDomain

        d = self._domains.get((n, device))
        if d is None:
            d = self._domains[(n, device)] = EvaluationDomain(n, device)
        return d

    def handle(self, key, item: WorkItem) -> bool:
        if item.work_type == WorkType.SMALL_FFT:
            # one coset quarter per device: computation follows placement
            dev = self.mesh.devices[item.index % self.mesh.size]
            mono = item.get_data().to(dev)
            out = small_fft_quarter(key, mono, item.index,
                                    self._domain(key.n, dev))
            item.put_result(out.to(key.device))
            return True
        if item.work_type != WorkType.MSM:
            return False
        from ..curves.io import jacobian_to_host
        from ..curves.spec import BN254_G1
        from ..parallel.sharded_msm import sharded_msm

        scalars = item.get_data()
        X, Y = key.srs.get_monomials(scalars.shape[1])
        P = sharded_msm(self.mesh, (X, Y), scalars, BN254_G1)
        item.put_result(jacobian_to_host(P, BN254_G1)[0])
        return True
