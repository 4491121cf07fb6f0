"""escape_hatch: user-direct exit circuit
(ref: rollup/proofs/escape_hatch/escape_hatch_circuit.cpp).

A join_split whose world-state tree updates are proven INSIDE the same
circuit (no rollup aggregation needed), so a user can exit the system
without the operator.  Its public inputs mimic a 1-tx rollup (minus the
pairing accumulator), proven with standard turbo settings for direct
on-chain verification.

Port of aztec_tpu/rollup/escape_hatch.py over the port's ``tree_updates``
and ``join_split_circuit_component``.  No proof worker id serves it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..stdlib.field_t import FieldT, BoolT
from . import tree_updates as tu
from .constants import NUM_ASSETS
from .join_split import JoinSplitTx, join_split_circuit_component

HashPath = List[Tuple[int, int]]


@dataclasses.dataclass
class EscapeHatchTx:
    """ref: escape_hatch/escape_hatch_tx.hpp."""
    js_tx: JoinSplitTx
    rollup_id: int
    data_start_index: int
    new_data_root: int
    old_data_path: HashPath
    new_null_roots: Tuple[int, int]
    old_null_paths: Tuple[HashPath, HashPath]
    old_null_root: int
    old_data_roots_root: int
    new_data_roots_root: int
    old_data_roots_path: HashPath


def escape_hatch_circuit(ctx, tx: EscapeHatchTx) -> None:
    """ref: escape_hatch_circuit.cpp:18-117."""
    w, outputs = join_split_circuit_component(ctx, tx.js_tx)
    outputs.tx_fee.assert_equal(0, "tx_fee")

    rollup_id = FieldT.from_witness(ctx, tx.rollup_id)
    old_data_root = w.merkle_root
    new_data_root = FieldT.from_witness(ctx, tx.new_data_root)
    old_data_roots_root = FieldT.from_witness(ctx, tx.old_data_roots_root)
    new_data_roots_root = FieldT.from_witness(ctx, tx.new_data_roots_root)
    old_null_root = FieldT.from_witness(ctx, tx.old_null_root)
    data_start_index = FieldT.from_witness(ctx, tx.data_start_index)

    new_null_root = tu.check_nullifiers_inserted(
        ctx, list(tx.new_null_roots),
        [list(p) for p in tx.old_null_paths],
        old_null_root,
        [outputs.nullifier1, outputs.nullifier2],
        [BoolT.constant(True), BoolT.constant(True)],
    )

    old_roots_path = [(FieldT.from_witness(ctx, l),
                       FieldT.from_witness(ctx, r))
                      for (l, r) in tx.old_data_roots_path]
    tu.check_root_tree_updated(ctx, old_roots_path, rollup_id,
                               new_data_root, new_data_roots_root,
                               old_data_roots_root,
                               len(tx.old_data_roots_path))

    old_data_path = [(FieldT.from_witness(ctx, l),
                      FieldT.from_witness(ctx, r))
                     for (l, r) in tx.old_data_path]
    tu.check_data_tree_updated(
        ctx, 1, old_data_path, old_data_path,
        [w.output_note1, w.output_note2],
        old_data_root, new_data_root, data_start_index,
        len(tx.old_data_path))

    # Public inputs mimic a 1-rollup (ref: :87-117)
    rollup_id.set_public()
    FieldT.from_witness(ctx, 0).set_public()  # rollup_size 0 = escape hatch
    data_start_index.set_public()
    old_data_root.set_public()
    new_data_root.set_public()
    old_null_root.set_public()
    new_null_root.set_public()
    old_data_roots_root.set_public()
    new_data_roots_root.set_public()
    for _ in range(NUM_ASSETS):
        zero_fee = FieldT.from_witness(ctx, 0)
        zero_fee.assert_equal(0)
        zero_fee.set_public()
    FieldT.from_witness(ctx, 1).set_public()  # num_txs

    # "inner proof" fields
    FieldT.from_witness(ctx, 0).set_public()  # proof_id
    w.public_input.set_public()
    w.public_output.set_public()
    w.asset_id.set_public()
    w.output_note1.x.set_public()
    w.output_note1.y.set_public()
    w.output_note2.x.set_public()
    w.output_note2.y.set_public()
    outputs.nullifier1.set_public()
    outputs.nullifier2.set_public()
    FieldT.from_witness(ctx, tx.js_tx.input_owner).set_public()
    FieldT.from_witness(ctx, tx.js_tx.output_owner).set_public()
