"""Build rollup / root-rollup transactions from tx proofs + world state
(ref: rollup/proofs/rollup/create_rollup.hpp, rollup/tx_factory,
falafel rollup_creator/rollup_aggregator).

Applies the world-state updates natively while collecting exactly the
witness data (old paths, intermediate roots) the circuits re-verify.

Port of aztec_tpu/rollup/create_rollup.py, host Python: the same world
state and proofs give the same transactions.
"""

from __future__ import annotations

from typing import List

from .inner_proof_data import InnerProofData
from .rollup_circuit import RollupTx
from .root_rollup_circuit import RootRollupTx
from .world_state import WorldState


def create_rollup_tx(ws: WorldState, rollup_id: int,
                     tx_proofs: List[bytes],
                     rollup_size: int | None = None) -> RollupTx:
    """Aggregate tx proofs into a RollupTx, applying data/nullifier tree
    updates to `ws` (ref: create_rollup.hpp create_rollup)."""
    num_txs = len(tx_proofs)
    rollup_size = rollup_size or num_txs
    assert num_txs <= rollup_size
    rollup_size_pow2 = 1 << max(rollup_size - 1, 0).bit_length()

    datas = [InnerProofData.from_proof(p) for p in tx_proofs]

    # data tree: append 2 notes per slot at the next aligned index
    subtree = 2 * rollup_size_pow2
    next_idx = ws.data_tree_next_index
    data_start_index = ((next_idx + subtree - 1) // subtree) * subtree
    old_data_root = ws.data_root()
    old_data_path = ws.data_tree.get_hash_path(data_start_index)

    for i, d in enumerate(datas):
        x1 = int.from_bytes(d.new_note1[0:32], "big")
        y1 = int.from_bytes(d.new_note1[32:64], "big")
        x2 = int.from_bytes(d.new_note2[0:32], "big")
        y2 = int.from_bytes(d.new_note2[32:64], "big")
        ws.insert_note(data_start_index + 2 * i, (x1, y1))
        ws.insert_note(data_start_index + 2 * i + 1, (x2, y2))
    ws.data_tree_next_index = data_start_index + subtree
    new_data_root = ws.data_root()

    new_data_path = ws.data_tree.get_hash_path(data_start_index)

    # nullifier tree: two insertions per tx (padding txs no-op at index 0)
    old_null_root = ws.null_tree.root
    new_null_roots: List[int] = []
    old_null_paths = []
    new_null_paths = []
    for i in range(rollup_size):
        if i < num_txs:
            d = datas[i]
            for nul in (d.nullifier1, d.nullifier2):
                root, path = ws.insert_nullifier(nul, True)
                new_null_roots.append(root)
                old_null_paths.append(path)
                new_null_paths.append(
                    ws.null_tree.get_hash_path(ws.null_index(nul)))
        else:
            for _ in range(2):
                root, path = ws.insert_nullifier(0, False)
                new_null_roots.append(root)
                old_null_paths.append(path)
                new_null_paths.append(ws.null_tree.get_hash_path(0))

    # root-tree membership witness per tx
    data_roots_paths = []
    data_roots_indicies = []
    for i in range(rollup_size):
        if i < num_txs:
            idx = ws.find_data_root_index(datas[i].merkle_root)
        else:
            idx = 0
        data_roots_paths.append(ws.root_tree.get_hash_path(idx))
        data_roots_indicies.append(idx)

    return RollupTx(
        rollup_id=rollup_id,
        num_txs=num_txs,
        data_start_index=data_start_index,
        txs=list(tx_proofs),
        old_data_root=old_data_root,
        new_data_root=new_data_root,
        old_data_path=old_data_path,
        old_null_root=old_null_root,
        new_null_roots=new_null_roots,
        old_null_paths=old_null_paths,
        data_roots_root=ws.root_tree.root,
        data_roots_paths=data_roots_paths,
        data_roots_indicies=data_roots_indicies,
        new_data_path=new_data_path,
        new_null_paths=new_null_paths,
    )


def create_root_rollup_tx(ws: WorldState, rollup_id: int,
                          rollup_proofs: List[bytes],
                          new_data_root: int) -> RootRollupTx:
    """Aggregate inner rollup proofs and insert the final data root into
    the root tree (ref: root_rollup/compute_or_load_fixture.hpp usage +
    root_rollup_circuit.cpp)."""
    old_roots_root = ws.root_tree.root
    old_roots_path = ws.root_tree.get_hash_path(rollup_id + 1)
    new_roots_root, _ = ws.insert_data_root(rollup_id, new_data_root)
    return RootRollupTx(
        num_inner_proofs=len(rollup_proofs),
        rollup_id=rollup_id,
        rollups=list(rollup_proofs),
        old_data_roots_root=old_roots_root,
        new_data_roots_root=new_roots_root,
        old_data_roots_path=old_roots_path,
    )
