"""Inner rollup circuit: recursively verifies N unrolled tx proofs
(join_split / account) and applies their world-state updates
(ref: rollup/proofs/rollup/rollup_circuit.cpp, rollup_tx.hpp).

Proven with UNROLLED turbo settings so the root rollup can aggregate it;
the deferred pairing accumulators surface as 16 public-input limbs.

Port of aztec_tpu/rollup/rollup_circuit.py, on the port's composers:
host Python, so the same rollup tx records the same gates.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..stdlib.field_t import FieldT, BoolT
from ..stdlib.pedersen_circuit import Point
from ..stdlib.recursion_verifier import (
    RecursiveVK,
    RecursionOutput,
    verify_proof_circuit,
    add_proof_outputs_as_public_inputs,
)
from . import tree_updates as tu
from .constants import MAX_TXS_BIT_LENGTH, NUM_ASSETS
from .inner_proof_data import InnerProofFields

HashPath = List[Tuple[int, int]]
F = InnerProofFields


@dataclasses.dataclass
class RollupTx:
    """Native rollup transaction (ref: rollup/rollup_tx.hpp)."""
    rollup_id: int
    num_txs: int
    data_start_index: int
    txs: List[bytes]                       # inner proof data (incl. padding)
    old_data_root: int
    new_data_root: int
    old_data_path: HashPath
    old_null_root: int
    new_null_roots: List[int]              # one per nullifier (2 per tx)
    old_null_paths: List[HashPath]
    data_roots_root: int
    data_roots_paths: List[HashPath]
    data_roots_indicies: List[int]
    # wire-format companions (circuit re-derives these from the old paths;
    # carried for rollup_tx.hpp serialization parity)
    new_data_path: Optional[HashPath] = None
    new_null_paths: Optional[List[HashPath]] = None


def _uint_gt_const(ctx, a: FieldT, const_i: int, bits: int) -> BoolT:
    """a > const_i for a `bits`-bit value (witnessed comparison with a
    range-constrained selected difference)."""
    av = a.get_value()
    b = BoolT.from_witness(ctx, av > const_i)
    f = b.to_field()
    diff = f * (a - (const_i + 1)) + (FieldT.constant(1) - f) * (
        FieldT.constant(const_i) - a)
    ctx.create_range_constraint(diff.normalize().witness_index, bits)
    return b


def propagate_inner_proof_public_inputs(ctx,
                                        public_inputs: List[FieldT]) -> None:
    """ref: rollup_circuit.cpp:17-22."""
    for i in range(F.NUM_PUBLISHED):
        public_inputs[i].set_public()


def add_padding_public_inputs(ctx) -> None:
    """ref: rollup_circuit.cpp:24-31."""
    for _ in range(F.NUM_PUBLISHED):
        zero = FieldT.from_witness(ctx, 0)
        zero.assert_equal(0)
        zero.set_public()


def rollup_circuit(ctx, rollup: RollupTx, verification_keys,
                   rollup_size: int) -> RecursionOutput:
    """ref: rollup_circuit.cpp:96-220.

    verification_keys: list of native VKs indexed by proof_id (all sharing
    n / num_public_inputs / domain — see RecursiveVK docstring).  The
    actual key for each tx enters as a witness validated against this set.
    """
    rollup_size_pow2 = 1 << max(rollup_size - 1, 0).bit_length()

    data_start_index = FieldT.from_witness(ctx, rollup.data_start_index)
    old_data_root = FieldT.from_witness(ctx, rollup.old_data_root)
    new_data_root = FieldT.from_witness(ctx, rollup.new_data_root)
    old_null_root = FieldT.from_witness(ctx, rollup.old_null_root)
    data_roots_root = FieldT.from_witness(ctx, rollup.data_roots_root)
    num_txs = FieldT.from_witness(ctx, rollup.num_txs)
    ctx.create_range_constraint(num_txs.witness_index, MAX_TXS_BIT_LENGTH)

    new_data_values: List[Optional[Point]] = []
    new_null_indices: List[FieldT] = []
    null_is_real: List[BoolT] = []
    inner_public_inputs: List[List[FieldT]] = []
    total_tx_fees = [FieldT.from_witness(ctx, 0) for _ in range(NUM_ASSETS)]
    for fee in total_tx_fees:
        fee.assert_equal(0)

    recursion_output: Optional[RecursionOutput] = None

    for i in range(rollup_size):
        # pick this tx's key by its proof_id and prove set membership
        proof_id = int.from_bytes(
            rollup.txs[i][F.PROOF_ID * 32 + 28:F.PROOF_ID * 32 + 32], "big")
        rvk = RecursiveVK.from_witness(ctx, verification_keys[proof_id])
        rvk.validate_key_is_in_set(ctx, verification_keys)

        recursion_output = verify_proof_circuit(
            ctx, rollup.txs[i], rvk, previous_output=recursion_output)

        is_real = _uint_gt_const(ctx, num_txs, i, MAX_TXS_BIT_LENGTH)
        pub = [(p * is_real.to_field()).normalize()
               for p in recursion_output.public_inputs[:F.NUM_PUBLISHED]] + \
            recursion_output.public_inputs[F.NUM_PUBLISHED:]

        new_data_values.append(Point(pub[F.NEW_NOTE1_X], pub[F.NEW_NOTE1_Y]))
        new_data_values.append(Point(pub[F.NEW_NOTE2_X], pub[F.NEW_NOTE2_Y]))

        # this proof's data root must be in the root tree (unless padding)
        data_root = recursion_output.public_inputs[F.MERKLE_ROOT]
        from ..stdlib.merkle_circuit import (
            check_membership_bool, hash_leaf_32, index_bits_from_field,
        )

        path = [(FieldT.from_witness(ctx, l), FieldT.from_witness(ctx, r))
                for (l, r) in rollup.data_roots_paths[i]]
        root_index = FieldT.from_witness(ctx, rollup.data_roots_indicies[i])
        bits = index_bits_from_field(ctx, root_index,
                                     len(rollup.data_roots_paths[i]))
        leaf = hash_leaf_32(data_root)
        valid = (~data_root.is_zero()) & check_membership_bool(
            data_roots_root, leaf, bits, path)
        valid.to_field().assert_equal(is_real.to_field(),
                                      f"data_root_for_proof_{i}")

        new_null_indices.append(pub[F.NULLIFIER1])
        new_null_indices.append(pub[F.NULLIFIER2])
        null_is_real.extend([is_real, is_real])

        inner_public_inputs.append(pub)

        asset_id = pub[F.ASSET_ID]
        tx_fee = recursion_output.public_inputs[F.TX_FEE]
        for j in range(NUM_ASSETS):
            eq = (asset_id - j).is_zero().to_field()
            total_tx_fees[j] = total_tx_fees[j] \
                + tx_fee * is_real.to_field() * eq

    # zero padding to the pow2 size
    for _ in range(rollup_size, rollup_size_pow2):
        new_data_values.extend([None, None])

    old_data_path = [(FieldT.from_witness(ctx, l),
                      FieldT.from_witness(ctx, r))
                     for (l, r) in rollup.old_data_path]
    tu.check_data_tree_updated(
        ctx, rollup_size_pow2, old_data_path, old_data_path,
        new_data_values, old_data_root, new_data_root, data_start_index,
        len(rollup.old_data_path))

    new_null_root = tu.check_nullifiers_inserted(
        ctx, rollup.new_null_roots, rollup.old_null_paths,
        old_null_root, new_null_indices, null_is_real)

    # public inputs (ref: :195-215 — slot 0 and the post-fee slot are
    # fresh zero witnesses in the reference, filled in by the root rollup)
    FieldT.from_witness(ctx, 0).set_public()
    rsp = FieldT.from_witness(ctx, rollup_size_pow2)
    rsp.assert_equal(rollup_size_pow2)
    rsp.set_public()
    data_start_index.set_public()
    old_data_root.set_public()
    new_data_root.set_public()
    old_null_root.set_public()
    new_null_root.set_public()
    data_roots_root.set_public()
    FieldT.from_witness(ctx, rollup.data_roots_root).set_public()
    for fee in total_tx_fees:
        fee.normalize().set_public()
    FieldT.from_witness(ctx, 0).set_public()
    for inner in inner_public_inputs:
        propagate_inner_proof_public_inputs(ctx, inner)
    for _ in range(rollup_size, rollup_size_pow2):
        add_padding_public_inputs(ctx)

    add_proof_outputs_as_public_inputs(ctx, recursion_output)
    return recursion_output
