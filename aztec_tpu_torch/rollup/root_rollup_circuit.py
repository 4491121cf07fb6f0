"""Root rollup circuit: aggregates M inner rollup proofs and inserts the
final data root into the root tree
(ref: rollup/proofs/root_rollup/root_rollup_circuit.cpp, root_rollup_tx.hpp).

Proven with STANDARD turbo settings (Keccak transcript) for direct
on-chain verification; the accumulated pairing points of all inner
rollups surface as 16 public-input limbs which the native verifier folds
into its final pairing check.

Port of aztec_tpu/rollup/root_rollup_circuit.py, on the port's
composers: host Python, so the same root tx records the same gates.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..stdlib.field_t import FieldT, BoolT
from ..stdlib.recursion_verifier import (
    RecursiveVK,
    RecursionOutput,
    verify_proof_circuit,
    add_proof_outputs_as_public_inputs,
)
from . import tree_updates as tu
from .constants import MAX_TXS_BIT_LENGTH, NUM_ASSETS
from .inner_proof_data import InnerProofFields
from .rollup_circuit import _uint_gt_const

HashPath = List[Tuple[int, int]]
F = InnerProofFields


@dataclasses.dataclass
class RootRollupTx:
    """ref: root_rollup/root_rollup_tx.hpp."""
    num_inner_proofs: int
    rollup_id: int
    rollups: List[bytes]                   # inner rollup proof data
    old_data_roots_root: int
    new_data_roots_root: int
    old_data_roots_path: HashPath


def root_rollup_circuit(ctx, root_rollup: RootRollupTx,
                        inner_rollup_size: int, outer_rollup_size: int,
                        inner_verification_key) -> RecursionOutput:
    """ref: root_rollup_circuit.cpp:49-166.  The inner VK is a circuit
    constant (all inner rollups share one key)."""
    num_proofs = len(root_rollup.rollups)

    rollup_size = FieldT.from_witness(ctx, outer_rollup_size)
    rollup_size.assert_equal(outer_rollup_size)

    num_inner_proofs = FieldT.from_witness(ctx, root_rollup.num_inner_proofs)
    ctx.create_range_constraint(num_inner_proofs.witness_index,
                                MAX_TXS_BIT_LENGTH)
    rollup_id = FieldT.from_witness(ctx, root_rollup.rollup_id)
    data_start_index = FieldT.from_witness(ctx, 0)
    old_data_root = FieldT.from_witness(ctx, 0)
    new_data_root = FieldT.from_witness(ctx, 0)
    old_null_root = FieldT.from_witness(ctx, 0)
    new_null_root = FieldT.from_witness(ctx, 0)
    old_root_root = FieldT.from_witness(ctx, root_rollup.old_data_roots_root)
    new_root_root = FieldT.from_witness(ctx, root_rollup.new_data_roots_root)

    total_tx_fees = [FieldT.from_witness(ctx, 0) for _ in range(NUM_ASSETS)]
    for fee in total_tx_fees:
        fee.assert_equal(0)
    inner_proof_public_inputs: List[FieldT] = []

    recursion_output: Optional[RecursionOutput] = None

    for i in range(num_proofs):
        recursion_output = verify_proof_circuit(
            ctx, root_rollup.rollups[i], inner_verification_key,
            previous_output=recursion_output)
        pub = recursion_output.public_inputs

        is_real = _uint_gt_const(ctx, num_inner_proofs, i,
                                 MAX_TXS_BIT_LENGTH)
        ir = is_real.to_field()
        nir = FieldT.constant(1) - ir
        dsi_inner = pub[2]
        odr_inner = pub[3]
        ndr_inner = pub[4]
        onr_inner = pub[5]
        nnr_inner = pub[6]
        orr_inner = pub[7]

        for j in range(F.NUM_PUBLISHED * inner_rollup_size):
            inner_proof_public_inputs.append(
                (pub[10 + NUM_ASSETS + j] * ir).normalize())

        for j in range(NUM_ASSETS):
            total_tx_fees[j] = total_tx_fees[j] + pub[9 + j] * ir

        # every real inner proof must reference OUR root tree root
        valid_root_root = (~is_real) | (orr_inner - old_root_root).is_zero()
        valid_root_root.to_field().assert_equal(
            1, f"inconsistent_root_roots_{i}")

        if i == 0:
            is_real.to_field().assert_equal(1, "first proof must be real")
            data_start_index = dsi_inner
            old_data_root = odr_inner
            new_data_root = ndr_inner
            old_null_root = onr_inner
            new_null_root = nnr_inner
        else:
            expected_dsi = data_start_index + (i * inner_rollup_size * 2)
            valid_dsi = (~is_real) | (dsi_inner - expected_dsi).is_zero()
            valid_odr = (~is_real) | (odr_inner - new_data_root).is_zero()
            valid_onr = (~is_real) | (onr_inner - new_null_root).is_zero()
            valid_dsi.to_field().assert_equal(
                1, f"incorrect_data_start_index_{i}")
            valid_odr.to_field().assert_equal(
                1, f"inconsistent_data_roots_{i}")
            valid_onr.to_field().assert_equal(
                1, f"inconsistent_null_roots_{i}")
            new_data_root = (ndr_inner * ir + new_data_root * nir).normalize()
            new_null_root = (nnr_inner * ir + new_null_root * nir).normalize()

    old_roots_path = [(FieldT.from_witness(ctx, l),
                       FieldT.from_witness(ctx, r))
                      for (l, r) in root_rollup.old_data_roots_path]
    tu.check_root_tree_updated(ctx, old_roots_path, rollup_id,
                               new_data_root, new_root_root, old_root_root,
                               len(root_rollup.old_data_roots_path))

    # public inputs (ref: :140-163)
    rollup_id.set_public()
    rollup_size.set_public()
    data_start_index.set_public()
    old_data_root.set_public()
    new_data_root.set_public()
    old_null_root.set_public()
    new_null_root.set_public()
    old_root_root.set_public()
    new_root_root.set_public()
    for fee in total_tx_fees:
        fee.normalize().set_public()
    num_inner_proofs.set_public()
    for inp in inner_proof_public_inputs:
        inp.set_public()
    for _ in range(num_proofs, outer_rollup_size // inner_rollup_size):
        for _k in range(F.NUM_PUBLISHED * inner_rollup_size):
            zero = FieldT.from_witness(ctx, 0)
            zero.assert_equal(0)
            zero.set_public()

    add_proof_outputs_as_public_inputs(ctx, recursion_output)
    return recursion_output
