"""Circuit composer: gate recording, copy cycles, sigma permutations.

Port of the ``StandardComposer``, ``TurboComposer``, ``UltraComposer`` and
``MiMCComposer`` of aztec_tpu/plonk/composer.py.  Gate recording and
copy-cycle bookkeeping are host Python, carried over as they are (so
identical circuits give identical sigma polynomials); selector transforms,
sigma synthesis and key commitments run on the composer's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ff import FR, limb
from ..ff.bn254 import FR_MOD
from ..numeric.bigint import ints_to_limbs
from ..srs.reference_string import FakeReferenceStringFactory
from ..utils import spans
from . import kernels
from .manifests import MIMC, STANDARD, TURBO, ULTRA, StandardSettings
from .proving_key import ProvingKey, VerificationKey, commit_many, ints_to_mont

NUM_RESERVED_GATES = 4  # >= num_roots_cut_out_of_vanishing_polynomial


def _next_pow2(v: int) -> int:
    n = 1
    while n < v:
        n <<= 1
    return n


@dataclasses.dataclass
class AddTriple:
    a: int
    b: int
    c: int
    a_scaling: int
    b_scaling: int
    c_scaling: int
    const_scaling: int


@dataclasses.dataclass
class MulTriple:
    a: int
    b: int
    c: int
    mul_scaling: int
    c_scaling: int
    const_scaling: int


@dataclasses.dataclass
class PolyTriple:
    a: int
    b: int
    c: int
    q_m: int
    q_l: int
    q_r: int
    q_o: int
    q_c: int


class ComposerBase:
    """Variable store + copy-cycle machinery (ref: composer_base.cpp)."""

    def __init__(self):
        self.variables: List[int] = []
        self.next_var_index: List[int] = []
        # the reference's real_variable_index, kept lazily: a class's
        # members point at its real variable or at a member that was real
        # before a merge (``_find`` follows and compresses the pointers)
        self._real: List[int] = []
        self._head: Dict[int, int] = {}     # real variable -> chain head
        self.public_inputs: List[int] = []
        self.n = 0
        self.failed = False
        self.err = ""
        # positions (within public_inputs) of a deferred pairing
        # accumulator exposed by an in-circuit recursive verifier
        # (ref: composer_base add_recursive_proof)
        self.recursive_proof_public_input_indices: Optional[tuple] = None

    def add_recursive_proof(self, public_input_positions) -> None:
        """Mark this circuit as carrying a recursive-proof accumulator in
        the given public-input POSITIONS (16 limbs of P0/P1; ref:
        stdlib recursion_output.add_proof_outputs_as_public_inputs)."""
        assert len(public_input_positions) == 16
        self.recursive_proof_public_input_indices = tuple(
            public_input_positions)

    REAL_VARIABLE = 0xFFFFFFFE

    def add_variable(self, value: int) -> int:
        idx = len(self.variables)
        self.variables.append(value % FR_MOD)
        self.next_var_index.append(self.REAL_VARIABLE)
        self._real.append(idx)
        return idx

    def _find(self, idx: int) -> int:
        """The real variable of idx's class (path compression)."""
        p = self._real
        r = p[idx]
        if p[r] == r:
            return r
        while p[r] != r:
            r = p[r]
        while p[idx] != r:
            p[idx], idx = r, p[idx]
        return r

    def real_variables(self) -> np.ndarray:
        """real_variable_index as an int64 array (pointer jumping)."""
        p = np.asarray(self._real, dtype=np.int64)
        while True:
            q = p[p]
            if np.array_equal(q, p):
                return p
            p = q

    @property
    def real_variable_index(self) -> List[int]:
        """ref: composer_base real_variable_index: each variable's real
        variable, the last of its class's chain."""
        return self.real_variables().tolist()

    def get_variable(self, idx: int) -> int:
        return self.variables[self._find(idx)]

    def add_public_variable(self, value: int) -> int:
        idx = self.add_variable(value)
        self.public_inputs.append(idx)
        return idx

    def set_public_input(self, idx: int):
        self.public_inputs.append(idx)

    def assert_equal(self, a_idx: int, b_idx: int, msg: str = "assert_equal"):
        """ref: composer_base.cpp:8-36: b's class joins a's, its chain
        before a's; every member's real variable becomes a's.  The members
        are re-pointed lazily (``_find``), so a merge costs O(1) where the
        reference walks b's class: the class of the constant 0 grows with
        every in-circuit equality to a constant."""
        if self.get_variable(a_idx) != self.get_variable(b_idx) and not self.failed:
            self.failed = True
            self.err = msg
        a_real = self._find(a_idx)
        b_real = self._find(b_idx)
        if a_real == b_real:
            return
        self._real[b_real] = a_real
        a_start = self._head.pop(a_real, a_real)
        self._head[a_real] = self._head.pop(b_real, b_real)
        self.next_var_index[b_real] = a_start

    # -- copy cycles -> sigma mappings (ref: composer_base.cpp:38-158) -------
    def compute_sigma_mappings(self, subgroup_size: int, program_width: int):
        """Returns per-column (next_row, factor_idx) int32 arrays.

        factor_idx encodes the coset multiplier: column j -> j (0 => 1,
        1 => k1, 2 => k2), 3 => external (public input rows of sigma_1).

        Each copy cycle holds, in order, the (row, column) slots of one
        real variable: its public-input rows (columns 0 and 1) first, then
        its gate slots row by row; a slot maps to the next slot of its
        cycle, the last to the first.  A stable sort by real variable
        groups the cycles in that order (numpy, no loop over slots)."""
        num_pub = len(self.public_inputs)
        n = self.n
        real = self.real_variables()
        wires = np.stack([np.asarray(wl[:n], dtype=np.int64)
                          for wl in self._wire_lists()[:program_width]],
                         axis=1)                               # (n, W)
        pub = np.asarray(self.public_inputs, dtype=np.int64)
        keys = np.concatenate([np.repeat(real[pub], 2),
                               real[wires].reshape(-1)])
        rows = np.concatenate([np.repeat(np.arange(num_pub), 2),
                               np.repeat(np.arange(num_pub, num_pub + n),
                                         program_width)])
        cols = np.concatenate([np.tile([0, 1], num_pub),
                               np.tile(np.arange(program_width), n)])
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        pos = np.arange(sk.size)
        first = np.ones(sk.size, bool)
        first[1:] = sk[1:] != sk[:-1]
        last = np.ones(sk.size, bool)
        last[:-1] = first[1:]
        cycle_start = np.maximum.accumulate(np.where(first, pos, 0))
        nxt = order[np.where(last, cycle_start, pos + 1)]

        next_row = np.tile(np.arange(subgroup_size, dtype=np.int32),
                           (program_width, 1))
        factor_idx = np.repeat(np.arange(program_width, dtype=np.int32)[:, None],
                               subgroup_size, axis=1)
        next_row[cols[order], rows[order]] = rows[nxt]
        factor_idx[cols[order], rows[order]] = cols[nxt]
        # public input consistency override on sigma_1 (external tag = 4)
        next_row[0, :num_pub] = np.arange(num_pub)
        factor_idx[0, :num_pub] = 4
        return list(next_row), list(factor_idx)

    def witness_planes(self, size: int, width: int):
        """Wire lagrange polynomials as device planes.

        Layout (ref: composer_base.cpp:216-264): first num_pub rows carry
        the public input value in w_1 and w_2 (the other wires 0), gates
        follow, zero-pad to the subgroup size.  Every variable is converted
        once; each wire gathers its column of them."""
        with spans.span("witness.host"):
            num_pub = len(self.public_inputs)
            real = self.real_variables()
            limbs = ints_to_limbs(self.variables + [0]).astype(np.int32)
            zero = len(self.variables)
            pub = real[np.asarray(self.public_inputs, dtype=np.int64)]
            idxs = []
            for k, wl in enumerate(self._wire_lists()[:width]):
                idx = np.full(size, zero, np.int64)
                if k < 2:
                    idx[:num_pub] = pub
                idx[num_pub:num_pub + self.n] = real[
                    np.asarray(wl[:self.n], dtype=np.int64)]
                idxs.append(idx)
        # most variables are distinct: no deduplication (ints_to_mont)
        table = limb.to_mont(torch.as_tensor(limbs, device=self.device), FR)
        out = {f"w_{k + 1}": table.index_select(
            1, torch.from_numpy(idx).to(self.device))
            for k, idx in enumerate(idxs)}
        return out, [self.variables[i] for i in pub.tolist()]

    def _wire_lists(self):
        raise NotImplementedError


def _device(device, who: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA was asked for and is not available")
    return dev


class StandardComposer(ComposerBase):
    """Width-3 composer (ref: plonk/composer/standard_composer.cpp)."""

    def __init__(self, crs_factory=None, settings: StandardSettings = STANDARD,
                 device="cuda"):
        super().__init__()
        self.settings = settings
        self.device = _device(device, type(self).__name__)
        self.crs_factory = crs_factory or FakeReferenceStringFactory(
            device=self.device)
        self.w_l: List[int] = []
        self.w_r: List[int] = []
        self.w_o: List[int] = []
        self.q_m: List[int] = []
        self.q_c: List[int] = []
        self.q_1: List[int] = []
        self.q_2: List[int] = []
        self.q_3: List[int] = []
        self.constant_variables: Dict[int, int] = {}
        self.zero_idx = self.put_constant_variable(0)
        self._pk: Optional[ProvingKey] = None
        self._vk: Optional[VerificationKey] = None

    def _wire_lists(self):
        return (self.w_l, self.w_r, self.w_o)

    # -- gates (ref: standard_composer.cpp:20-198) ----------------------------
    def _push(self, a, b, c, qm, q1, q2, q3, qc):
        self.w_l.append(a)
        self.w_r.append(b)
        self.w_o.append(c)
        self.q_m.append(qm % FR_MOD)
        self.q_1.append(q1 % FR_MOD)
        self.q_2.append(q2 % FR_MOD)
        self.q_3.append(q3 % FR_MOD)
        self.q_c.append(qc % FR_MOD)
        self.n += 1

    def create_add_gate(self, t: AddTriple):
        self._push(t.a, t.b, t.c, 0, t.a_scaling, t.b_scaling, t.c_scaling,
                   t.const_scaling)

    def create_mul_gate(self, t: MulTriple):
        self._push(t.a, t.b, t.c, t.mul_scaling, 0, 0, t.c_scaling,
                   t.const_scaling)

    def create_bool_gate(self, a: int):
        self._push(a, a, a, 1, 0, 0, -1, 0)

    def create_poly_gate(self, t: PolyTriple):
        self._push(t.a, t.b, t.c, t.q_m, t.q_l, t.q_r, t.q_o, t.q_c)

    def create_big_add_gate(self, a, b, c, d, a_s, b_s, c_s, d_s, const_s):
        """ref: standard_composer.cpp:35-47 (split into two width-3 gates)."""
        temp = (self.get_variable(a) * a_s + self.get_variable(b) * b_s) % FR_MOD
        temp_idx = self.add_variable(temp)
        self.create_add_gate(AddTriple(a, b, temp_idx, a_s, b_s, -1, 0))
        self.create_add_gate(AddTriple(c, d, temp_idx, c_s, d_s, 1, const_s))

    def fix_witness(self, witness_index: int, value: int):
        self._push(witness_index, getattr(self, "zero_idx", 0),
                   getattr(self, "zero_idx", 0), 0, 1, 0, 0, -value)

    def put_constant_variable(self, value: int) -> int:
        value %= FR_MOD
        if value in self.constant_variables:
            return self.constant_variables[value]
        idx = self.add_variable(value)
        self.fix_witness(idx, value)
        self.constant_variables[value] = idx
        return idx

    def create_dummy_gates(self):
        """ref: standard_composer.cpp:433-476."""
        a = self.add_variable(6)
        b = self.add_variable(7)
        c = self.add_variable((-20) % FR_MOD)
        self._push(a, b, c, 1, 2, 3, 4, 5)
        self._push(c, a, b, 1, 1, 1, 1, 127)

    # -- keys ------------------------------------------------------------------
    def subgroup_size(self) -> int:
        total = self.n + len(self.public_inputs)
        return _next_pow2(total + NUM_RESERVED_GATES)

    def compute_proving_key(self) -> ProvingKey:
        if self._pk is not None:
            return self._pk
        num_pub = len(self.public_inputs)
        size = self.subgroup_size()
        srs = self.crs_factory.get_prover_srs(size + 1)
        pk = ProvingKey(size, num_pub, srs, self.settings, self.device)

        # selectors: [0]*pub + gates + 0-pad + trailing 1
        # (ref: composer_base.cpp:160-214 compute_proving_key_base)
        for name, coeffs in (
            ("q_m", self.q_m), ("q_c", self.q_c), ("q_1", self.q_1),
            ("q_2", self.q_2), ("q_3", self.q_3),
        ):
            padded = (
                [0] * num_pub + list(coeffs)
                + [0] * (size - 1 - self.n - num_pub) + [1]
            )
            pk.add_polynomial("selector", name,
                              ints_to_mont(padded, self.device))

        # sigma permutations
        next_rows, factor_idx = self.compute_sigma_mappings(size, 3)
        for i in range(3):
            lag = kernels.sigma_from_mapping(
                torch.from_numpy(next_rows[i]), torch.from_numpy(factor_idx[i]),
                pk.omega_pows, size,
            )
            pk.add_polynomial("permutation", f"sigma_{i+1}", lag,
                              keep_lagrange=True)
        self._pk = pk
        return pk

    def compute_witness(self):
        return self.witness_planes(self.subgroup_size(), 3)

    def compute_verification_key(self) -> VerificationKey:
        if self._vk is not None:
            return self._vk
        pk = self.compute_proving_key()
        # all selector and sigma commitments in ONE batched MSM
        labels, monos = [], []
        for info in self.settings.polynomial_manifest:
            if info.source in ("selector", "permutation"):
                store = (pk.selectors if info.source == "selector"
                         else pk.sigmas)
                labels.append(info.commitment_label)
                monos.append(store[info.polynomial_label].monomial)
        comms = dict(zip(labels, commit_many(pk.srs, monos)))
        vsrs = self.crs_factory.get_verifier_srs()
        rec = self.recursive_proof_public_input_indices
        self._vk = VerificationKey(
            n=pk.n,
            num_public_inputs=pk.num_public_inputs,
            commitments=comms,
            domain_root=pk.small_domain.root,
            g2_x=vsrs.g2_x,
            settings=self.settings,
            contains_recursive_proof=rec is not None,
            recursive_proof_public_input_indices=rec,
        )
        return self._vk

    def _flavor(self):
        from .flavors import StandardFlavor

        return StandardFlavor

    def _unrolled_flavor(self):
        from .flavors import UnrolledStandardFlavor

        return UnrolledStandardFlavor

    def create_prover(self):
        from .prover import Prover

        pk = self.compute_proving_key()
        wires, pubvals = self.compute_witness()
        return Prover(pk, wires, pubvals, self._flavor())

    def create_verifier(self):
        from .verifier import Verifier

        return Verifier(self.compute_verification_key(), self._flavor())

    def create_unrolled_prover(self):
        """Prover for in-circuit recursive verification
        (ref: standard_composer.cpp create_unrolled_prover)."""
        from .prover import Prover

        pk = self.compute_proving_key()
        wires, pubvals = self.compute_witness()
        return Prover(pk, wires, pubvals, self._unrolled_flavor())

    def create_unrolled_verifier(self):
        from .verifier import Verifier

        return Verifier(self.compute_verification_key(),
                        self._unrolled_flavor())


class TurboComposer(ComposerBase):
    """Width-4 composer with custom gates
    (ref: plonk/composer/turbo_composer.cpp:42-700)."""

    SELECTORS = ("q_m", "q_c", "q_1", "q_2", "q_3", "q_4", "q_5",
                 "q_arith", "q_ecc_1", "q_range", "q_logic")

    def __init__(self, crs_factory=None, settings=TURBO, device="cuda"):
        super().__init__()
        self.settings = settings
        self.device = _device(device, type(self).__name__)
        self.crs_factory = crs_factory or FakeReferenceStringFactory(
            device=self.device)
        self.w_l: List[int] = []
        self.w_r: List[int] = []
        self.w_o: List[int] = []
        self.w_4: List[int] = []
        for s in self.SELECTORS:
            setattr(self, s, [])
        self.constant_variables: Dict[int, int] = {}
        self.zero_idx = self.put_constant_variable(0)
        self._pk: Optional[ProvingKey] = None
        self._vk: Optional[VerificationKey] = None

    def _wire_lists(self):
        return (self.w_l, self.w_r, self.w_o, self.w_4)

    def _flavor(self):
        from .flavors import TurboFlavor

        return TurboFlavor

    def _unrolled_flavor(self):
        from .flavors import UnrolledTurboFlavor

        return UnrolledTurboFlavor

    create_unrolled_prover = StandardComposer.create_unrolled_prover
    create_unrolled_verifier = StandardComposer.create_unrolled_verifier

    # -- gate recording --------------------------------------------------------
    def _push(self, a, b, c, d, q_m=0, q_c=0, q_1=0, q_2=0, q_3=0, q_4=0,
              q_5=0, q_arith=0, q_ecc_1=0, q_range=0, q_logic=0):
        self.w_l.append(a)
        self.w_r.append(b)
        self.w_o.append(c)
        self.w_4.append(d)
        self.q_m.append(q_m % FR_MOD)
        self.q_c.append(q_c % FR_MOD)
        self.q_1.append(q_1 % FR_MOD)
        self.q_2.append(q_2 % FR_MOD)
        self.q_3.append(q_3 % FR_MOD)
        self.q_4.append(q_4 % FR_MOD)
        self.q_5.append(q_5 % FR_MOD)
        self.q_arith.append(q_arith % FR_MOD)
        self.q_ecc_1.append(q_ecc_1 % FR_MOD)
        self.q_range.append(q_range % FR_MOD)
        self.q_logic.append(q_logic % FR_MOD)
        self.n += 1

    def create_dummy_gate(self):
        """All-zero-selector gate with a nonzero wire value
        (ref: turbo_composer.cpp:72-92)."""
        idx = self.add_variable((1 << 64) + 1)
        self._push(idx, idx, idx, idx)

    def create_add_gate(self, t: AddTriple):
        self._push(t.a, t.b, t.c, self.zero_idx, q_1=t.a_scaling,
                   q_2=t.b_scaling, q_3=t.c_scaling, q_c=t.const_scaling,
                   q_arith=1)

    def create_big_add_gate(self, a, b, c, d, a_s, b_s, c_s, d_s, const_s,
                            q_arith=1):
        self._push(a, b, c, d, q_1=a_s, q_2=b_s, q_3=c_s, q_4=d_s,
                   q_c=const_s, q_arith=q_arith)

    def create_big_add_gate_with_bit_extraction(self, a, b, c, d, a_s, b_s,
                                                c_s, d_s, const_s):
        self.create_big_add_gate(a, b, c, d, a_s, b_s, c_s, d_s, const_s,
                                 q_arith=2)

    def create_big_mul_gate(self, a, b, c, d, mul_s, a_s, b_s, c_s, d_s,
                            const_s):
        self._push(a, b, c, d, q_m=mul_s, q_1=a_s, q_2=b_s, q_3=c_s, q_4=d_s,
                   q_c=const_s, q_arith=1)

    def create_balanced_add_gate(self, a, b, c, d, a_s, b_s, c_s, d_s,
                                 const_s):
        """Width-4 add where d must be in [0,3] (q_5 activates the range
        term in the turbo arithmetic kernel)."""
        self._push(a, b, c, d, q_1=a_s, q_2=b_s, q_3=c_s, q_4=d_s,
                   q_5=1, q_c=const_s, q_arith=1)

    def create_mul_gate(self, t: MulTriple):
        self._push(t.a, t.b, t.c, self.zero_idx, q_m=t.mul_scaling,
                   q_3=t.c_scaling, q_c=t.const_scaling, q_arith=1)

    def create_bool_gate(self, a: int):
        self._push(a, a, a, self.zero_idx, q_m=1, q_3=-1, q_arith=1)

    def create_poly_gate(self, t: PolyTriple):
        self._push(t.a, t.b, t.c, self.zero_idx, q_m=t.q_m, q_1=t.q_l,
                   q_2=t.q_r, q_3=t.q_o, q_c=t.q_c, q_arith=1)

    def create_fixed_group_add_gate(self, a, b, c, d, q_x_1, q_x_2, q_y_1,
                                    q_y_2):
        """Grumpkin 2-bit fixed-base ladder add
        (ref: turbo_composer.cpp:269-290)."""
        self._push(a, b, c, d, q_1=q_x_1, q_2=q_x_2, q_3=q_y_1,
                   q_ecc_1=q_y_2)

    def create_fixed_group_add_gate_with_init(self, a, b, c, d, q_x_1, q_x_2,
                                              q_y_1, q_y_2, i_x_1, i_x_2,
                                              i_y_1, i_y_2):
        self._push(a, b, c, d, q_1=q_x_1, q_2=q_x_2, q_3=q_y_1,
                   q_ecc_1=q_y_2, q_4=i_x_1, q_5=i_x_2, q_m=i_y_1,
                   q_c=i_y_2)

    def fix_witness(self, witness_index: int, value: int):
        z = getattr(self, "zero_idx", 0)
        self._push(witness_index, z, z, z, q_1=1, q_c=-value, q_arith=1)

    def put_constant_variable(self, value: int) -> int:
        value %= FR_MOD
        if value in self.constant_variables:
            return self.constant_variables[value]
        idx = self.add_variable(value)
        self.fix_witness(idx, value)
        self.constant_variables[value] = idx
        return idx

    # -- accumulator constraints -------------------------------------------------
    def create_range_constraint(self, witness_index: int, num_bits: int):
        """Base-4 accumulator range check, (bits/8) gates
        (ref: turbo_composer.cpp:337-478)."""
        value = self.get_variable(witness_index)
        num_quad_gates = num_bits >> 3
        if (num_quad_gates << 3) != num_bits:
            num_quad_gates += 1
        num_quads = num_quad_gates << 2
        forced_zero_threshold = 1 + (((num_quads << 1) - num_bits) >> 1)

        wires = (self.w_4, self.w_o, self.w_r, self.w_l)
        accumulators = []
        accumulator = 0
        most_significant_segment = 0
        for i in range(num_quads + 1):
            if i < forced_zero_threshold:
                accumulator_index = self.zero_idx
            else:
                bit_index = (num_quads - i) << 1
                quad = ((value >> bit_index) & 1) + 2 * ((value >> (bit_index + 1)) & 1)
                accumulator = (4 * accumulator + quad) % FR_MOD
                accumulator_index = self.add_variable(accumulator)
                accumulators.append(accumulator_index)
                if i == forced_zero_threshold:
                    most_significant_segment = accumulator_index
            wires[i & 3].append(accumulator_index)

        used_gates = (num_quads + 1 + 3) // 4
        zeros = [0] * used_gates
        for s in self.SELECTORS:
            getattr(self, s).extend(
                [1] * (used_gates - 1) + [0] if s == "q_range" else zeros)
        self.w_l.append(self.zero_idx)
        self.w_r.append(self.zero_idx)
        self.w_o.append(self.zero_idx)

        self.assert_equal(witness_index, accumulators[-1],
                          "range constraint value mismatch")
        accumulators[-1] = witness_index
        self.n += used_gates

        if num_bits & 1:
            self.create_bool_gate(most_significant_segment)
        return accumulators

    def create_logic_constraint(self, a: int, b: int, num_bits: int,
                                is_xor: bool):
        """Quad-accumulator AND/XOR, (bits/2)+1 gates
        (ref: turbo_composer.cpp:480-654)."""
        assert num_bits % 2 == 0
        left_val = self.get_variable(a)
        right_val = self.get_variable(b)
        num_quads = num_bits >> 1

        out = {"left": [], "right": [], "out": []}
        left_acc = right_acc = out_acc = 0

        self.w_l.append(self.zero_idx)
        self.w_r.append(self.zero_idx)
        self.w_4.append(self.zero_idx)
        for i in range(num_quads):
            bit_index = (num_quads - 1 - i) << 1
            lq = ((left_val >> bit_index) & 1) + 2 * ((left_val >> (bit_index + 1)) & 1)
            rq = ((right_val >> bit_index) & 1) + 2 * ((right_val >> (bit_index + 1)) & 1)
            oq = (lq ^ rq) if is_xor else (lq & rq)
            left_acc = (4 * left_acc + lq) % FR_MOD
            right_acc = (4 * right_acc + rq) % FR_MOD
            out_acc = (4 * out_acc + oq) % FR_MOD
            li = self.add_variable(left_acc)
            ri = self.add_variable(right_acc)
            oi = self.add_variable(out_acc)
            pi = self.add_variable(lq * rq)
            out["left"].append(li)
            out["right"].append(ri)
            out["out"].append(oi)
            self.w_l.append(li)
            self.w_r.append(ri)
            self.w_4.append(oi)
            self.w_o.append(pi)
        self.w_o.append(self.zero_idx)

        qc_val = (-1 if is_xor else 1) % FR_MOD
        for i in range(num_quads + 1):
            last = i == num_quads
            for s in self.SELECTORS:
                if s in ("q_c", "q_logic") and not last:
                    getattr(self, s).append(qc_val if s == "q_c" else qc_val)
                else:
                    getattr(self, s).append(0)
        self.assert_equal(out["left"][-1], a, "logic constraint left mismatch")
        out["left"][-1] = a
        self.assert_equal(out["right"][-1], b, "logic constraint right mismatch")
        out["right"][-1] = b
        self.n += num_quads + 1
        return out

    def create_and_constraint(self, a, b, num_bits):
        return self.create_logic_constraint(a, b, num_bits, False)

    def create_xor_constraint(self, a, b, num_bits):
        return self.create_logic_constraint(a, b, num_bits, True)

    # -- keys ------------------------------------------------------------------
    subgroup_size = StandardComposer.subgroup_size
    compute_verification_key = StandardComposer.compute_verification_key
    create_prover = StandardComposer.create_prover
    create_verifier = StandardComposer.create_verifier

    def compute_proving_key(self) -> ProvingKey:
        if self._pk is not None:
            return self._pk
        self.create_dummy_gate()  # ref: turbo_composer.cpp:684
        num_pub = len(self.public_inputs)
        size = self.subgroup_size()
        srs = self.crs_factory.get_prover_srs(size + 1)
        pk = ProvingKey(size, num_pub, srs, self.settings, self.device)
        for name in self.SELECTORS:
            coeffs = getattr(self, name)
            padded = (
                [0] * num_pub + list(coeffs)
                + [0] * (size - 1 - self.n - num_pub) + [1]
            )
            pk.add_polynomial("selector", name,
                              ints_to_mont(padded, self.device))
        next_rows, factor_idx = self.compute_sigma_mappings(size, 4)
        for i in range(4):
            lag = kernels.sigma_from_mapping(
                torch.from_numpy(next_rows[i]), torch.from_numpy(factor_idx[i]),
                pk.omega_pows, size,
            )
            pk.add_polynomial("permutation", f"sigma_{i+1}", lag,
                              keep_lagrange=True)
        self._pk = pk
        return pk

    def compute_witness(self):
        return self.witness_planes(self.subgroup_size(), 4)


class UltraComposer(TurboComposer):
    """UltraPlonk composer: the turbo gate set + plookup lookup gates
    (ref design: barretenberg/lookup_tables.md, polynomial_manifest.hpp:
    23-46 reserved slots).

    A lookup gate places (key1, key2, value) on w_1..w_3 with q_lookup = 1
    and q_index = the table index; the proving key carries the table columns
    as table_1..4 plus q_lookup/q_index, and the prover adds the sorted-list
    halves S_1/S_2 and the Z_LOOKUP grand product (flavors.UltraFlavor).
    """

    SELECTORS = TurboComposer.SELECTORS + ("q_lookup", "q_index")

    def __init__(self, crs_factory=None, settings=ULTRA, device="cuda"):
        super().__init__(crs_factory, settings, device)
        self.tables: Dict[int, object] = {}
        # table index -> {(k1, k2): first matching row}, built on first read
        self._rows_by_keys: Dict[int, Dict[tuple, tuple]] = {}
        self._lookups: List[tuple] = []

    def _flavor(self):
        from .flavors import UltraFlavor

        return UltraFlavor

    def _unrolled_flavor(self):
        from .flavors import UnrolledUltraFlavor

        return UnrolledUltraFlavor

    def _push(self, a, b, c, d, q_lookup=0, q_index=0, **selectors):
        super()._push(a, b, c, d, **selectors)
        self.q_lookup.append(q_lookup % FR_MOD)
        self.q_index.append(q_index % FR_MOD)

    # -- tables / lookup gates -------------------------------------------------
    def add_lookup_table(self, table) -> None:
        if table.index in self.tables:
            assert self.tables[table.index] is table
            return
        self.tables[table.index] = table

    def create_lookup_gate(self, a: int, b: int, c: int, table_index: int):
        """Constrain (w(a), w(b), w(c)) to be a row of the table."""
        assert table_index in self.tables, "register the table first"
        self._push(a, b, c, self.zero_idx, q_lookup=1, q_index=table_index)
        self._lookups.append(
            (self.get_variable(a), self.get_variable(b), self.get_variable(c),
             table_index)
        )

    def read_from_table(self, table_index: int, a: int, b: int = None) -> int:
        """Witness the table value for keys (w(a), w(b)) and add the lookup
        gate; returns the value's witness index.  The row is the table's
        first with these keys, as the reference's linear scan finds it,
        from an index of the table built on its first read."""
        table = self.tables[table_index]
        rows = self._rows_by_keys.get(table_index)
        if rows is None:
            rows = {}
            for r in table.rows:
                rows.setdefault((r[0], r[1]), r)
            self._rows_by_keys[table_index] = rows
        k1 = self.get_variable(a)
        k2 = self.get_variable(b) if b is not None else 0
        row = rows.get((k1, k2))
        if row is None:
            if not self.failed:
                self.failed = True
                self.err = f"lookup ({k1},{k2}) not in table {table_index}"
            row = table.rows[0]
        c = self.add_variable(row[2])
        if b is None:
            b = self.zero_idx
        self.create_lookup_gate(a, b, c, table_index)
        return c

    def create_range_constraint_via_lookup(self, witness_index: int,
                                           table_index: int,
                                           num_chunks: int,
                                           chunk_bits: int):
        """Range-constrain to num_chunks * chunk_bits bits with one lookup
        row per chunk + a recomposition gate chain (vs one turbo gate per
        8 bits)."""
        value = self.get_variable(witness_index)
        base = 1 << chunk_bits
        chunks = [(value >> (chunk_bits * i)) & (base - 1)
                  for i in range(num_chunks)]
        acc_idx = None
        acc_val = 0
        for i in reversed(range(num_chunks)):
            ci = self.add_variable(chunks[i])
            self.create_lookup_gate(ci, self.zero_idx, self.zero_idx,
                                    table_index)
            if acc_idx is None:
                acc_idx, acc_val = ci, chunks[i]
            else:
                new_val = (acc_val * base + chunks[i]) % FR_MOD
                new_idx = self.add_variable(new_val)
                self.create_add_gate(AddTriple(
                    acc_idx, ci, new_idx, base, 1, -1, 0))
                acc_idx, acc_val = new_idx, new_val
        self.assert_equal(acc_idx, witness_index, "range lookup mismatch")
        return acc_idx

    # -- keys ------------------------------------------------------------------
    def _table_size(self) -> int:
        return sum(len(t.rows) for t in self.tables.values())

    def subgroup_size(self) -> int:
        total = self.n + len(self.public_inputs)
        # the sorted list needs #lookups + table rows + zeros to fit 2m+1
        need = max(total + NUM_RESERVED_GATES,
                   self._table_size() + NUM_RESERVED_GATES)
        return _next_pow2(need)

    def compute_proving_key(self) -> ProvingKey:
        if self._pk is not None:
            return self._pk
        from ..poly import fft_ops as pfft

        pk = super().compute_proving_key()
        size = pk.n
        assert self._table_size() <= size - NUM_RESERVED_GATES, \
            "table content exceeds circuit capacity"

        # table column polynomials (content rows first, zero padding after:
        # the order build_sorted_halves assumes)
        cols = [[], [], [], []]
        for idx in sorted(self.tables):
            for k1, k2, v in self.tables[idx].rows:
                cols[0].append(k1)
                cols[1].append(k2)
                cols[2].append(v)
                cols[3].append(idx)
        pad = size - len(cols[0])
        for i in range(4):
            pk.add_polynomial("selector", f"table_{i+1}",
                              ints_to_mont(cols[i] + [0] * pad, self.device),
                              keep_lagrange=True)
        # the z_lookup kernel needs these in lagrange form too
        for name in ("q_lookup", "q_index"):
            store = pk.selectors[name]
            if store.lagrange is None:
                store.lagrange = pfft.fft(store.monomial, pk.small_domain)
        return pk

    def _prover(self, flavor):
        from .prover import Prover

        pk = self.compute_proving_key()
        wires, pubvals = self.compute_witness()
        aux = {"tables": list(self.tables.values()), "lookups": self._lookups}
        return Prover(pk, wires, pubvals, flavor, aux=aux)

    def create_prover(self):
        return self._prover(self._flavor())

    def create_unrolled_prover(self):
        """Recursion-friendly prover: identical polynomial work, Pedersen+
        Blake2s transcript (flavors.UnrolledUltraFlavor)."""
        return self._prover(self._unrolled_flavor())


class MiMCComposer(StandardComposer):
    """Standard composer + the MiMC x^7 block-cipher gate
    (ref: plonk/composer/mimc_composer.cpp).

    A mimc gate at row i encodes one cipher round
    x_out = (x_in + k + c_i)^7 as: w_1 = k, w_2 = x_cubed, w_3 = x_in,
    q_mimc_coefficient = c_i, with x_out read from w_3 of row i+1 (the
    widget's w_3_omega shift), so consecutive mimc gates chain for free,
    and a pending x_out is flushed into a noop row whenever a non-mimc
    gate follows (mimc_composer.cpp:23-116)."""

    def __init__(self, crs_factory=None, settings=None, device="cuda"):
        # set first: the base __init__ seeds constant-0 via the overridden
        # _push path
        self.q_mimc_coefficient: List[int] = []
        self.q_mimc_selector: List[int] = []
        self.current_output_wire: Optional[int] = None
        super().__init__(crs_factory, settings or MIMC, device)

    def _push(self, a, b, c, qm, q1, q2, q3, qc):
        # any standard gate first flushes a pending mimc output row
        self._flush_mimc()
        super()._push(a, b, c, qm, q1, q2, q3, qc)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(0)

    def _flush_mimc(self):
        if self.current_output_wire is None:
            return
        out = self.current_output_wire
        self.current_output_wire = None
        # noop row carrying x_out in w_3 (mimc_composer.cpp:94-116)
        super()._push(self.zero_idx, self.zero_idx, out, 0, 0, 0, 0, 0)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(0)

    def create_mimc_gate(self, x_in_idx: int, x_cubed_idx: int, k_idx: int,
                         x_out_idx: int, mimc_constant: int):
        if (self.current_output_wire is not None
                and x_in_idx != self.current_output_wire):
            self._flush_mimc()
        self.current_output_wire = None
        self.w_l.append(k_idx)
        self.w_r.append(x_cubed_idx)
        self.w_o.append(x_in_idx)
        self.q_m.append(0)
        self.q_1.append(0)
        self.q_2.append(0)
        self.q_3.append(0)
        self.q_c.append(0)
        self.q_mimc_coefficient.append(mimc_constant % FR_MOD)
        self.q_mimc_selector.append(1)
        self.n += 1
        self.current_output_wire = x_out_idx

    def create_dummy_gates(self):
        """Non-zero/non-identical selector rows (mimc_composer.cpp:118-155)."""
        self._flush_mimc()
        # the base rows go through the overridden _push, which already
        # zero-pads the mimc selectors
        super().create_dummy_gates()
        # q_mimc_selector = 1 row over zero wires (satisfied: next row w_3=0)
        super()._push(self.zero_idx, self.zero_idx, self.zero_idx,
                      0, 0, 0, 0, 0)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(1)
        super()._push(self.zero_idx, self.zero_idx, self.zero_idx,
                      0, 0, 0, 0, 0)
        self.q_mimc_coefficient.append(1)
        self.q_mimc_selector.append(0)

    def compute_proving_key(self) -> ProvingKey:
        if self._pk is not None:
            return self._pk
        self._flush_mimc()
        num_pub = len(self.public_inputs)
        size = self.subgroup_size()
        srs = self.crs_factory.get_prover_srs(size + 1)
        pk = ProvingKey(size, num_pub, srs, self.settings, self.device)
        for name, coeffs in (
            ("q_m", self.q_m), ("q_c", self.q_c), ("q_1", self.q_1),
            ("q_2", self.q_2), ("q_3", self.q_3),
            ("q_mimc_coefficient", self.q_mimc_coefficient),
            ("q_mimc_selector", self.q_mimc_selector),
        ):
            padded = (
                [0] * num_pub + list(coeffs)
                + [0] * (size - 1 - self.n - num_pub) + [1]
            )
            pk.add_polynomial("selector", name,
                              ints_to_mont(padded, self.device))
        next_rows, factor_idx = self.compute_sigma_mappings(size, 3)
        for i in range(3):
            lag = kernels.sigma_from_mapping(
                torch.from_numpy(next_rows[i]), torch.from_numpy(factor_idx[i]),
                pk.omega_pows, size,
            )
            pk.add_polynomial("permutation", f"sigma_{i+1}", lag,
                              keep_lagrange=True)
        self._pk = pk
        return pk

    def compute_witness(self):
        self._flush_mimc()
        return super().compute_witness()

    def _flavor(self):
        from .flavors import MimcFlavor

        return MimcFlavor

    def _unrolled_flavor(self):
        raise NotImplementedError("mimc composer has no unrolled settings "
                                  "(matches the reference)")
