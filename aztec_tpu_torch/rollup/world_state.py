"""Native world state: the three Merkle trees the rollup maintains
(ref: falafel/src/world_state.ts:31-56 + rollup/db_cli) — data tree of
note commitments, nullifier tree, and root tree of historic data roots.

Tree depths are constructor parameters so tests can run shallow; the
production values live in rollup.constants.  The nullifier tree indexes by
the low `null_depth` bits of the nullifier (exact for depth >= 254).

Port of aztec_tpu/rollup/world_state.py, host Python: the same inputs give
the same values.
"""

from __future__ import annotations

from typing import List, Tuple

from ..merkle.sparse_tree import MemoryStore, SparseTree
from .notes_native import leaf_bytes

HashPath = List[Tuple[int, int]]


class WorldState:
    def __init__(self, data_depth: int = 8, null_depth: int = 16,
                 root_depth: int = 8):
        self.data_tree = SparseTree(MemoryStore(), data_depth, b"d")
        self.null_tree = SparseTree(MemoryStore(), null_depth, b"n")
        self.root_tree = SparseTree(MemoryStore(), root_depth, b"r")
        self.data_tree_next_index = 0
        # index of each historic data root in the root tree
        self._root_index = {}
        # root tree leaf 0 records the genesis data root
        # (ref: world_state.ts syncState / tx_factory genesis)
        self._root_index[self.data_tree.root] = 0
        self.root_tree.update_element(
            0, self.data_tree.root.to_bytes(32, "big"))

    # -- snapshot / rollback (ref: barretenberg world_state_db commit/
    # rollback — the sequencer pipeline restores state when a pass fails) --
    def snapshot(self) -> dict:
        import copy

        return {
            "data": dict(self.data_tree.store._data),
            "null": dict(self.null_tree.store._data),
            "root": dict(self.root_tree.store._data),
            "roots": (self.data_tree.root, self.null_tree.root,
                      self.root_tree.root),
            "next": self.data_tree_next_index,
            "ridx": copy.copy(self._root_index),
        }

    def restore(self, snap: dict) -> None:
        self.data_tree.store._data = dict(snap["data"])
        self.null_tree.store._data = dict(snap["null"])
        self.root_tree.store._data = dict(snap["root"])
        (self.data_tree.root, self.null_tree.root,
         self.root_tree.root) = snap["roots"]
        self.data_tree_next_index = snap["next"]
        self._root_index = dict(snap["ridx"])

    def find_data_root_index(self, data_root: int) -> int:
        """Index of a historic data root in the root tree (the falafel
        world-state-db lookup the sequencer performs per tx)."""
        return self._root_index[data_root]

    # -- data tree ------------------------------------------------------------
    def insert_note(self, index: int, commitment: Tuple[int, int]) -> int:
        root = self.data_tree.update_element(index, leaf_bytes(commitment))
        self.data_tree_next_index = max(self.data_tree_next_index, index + 1)
        return root

    def data_root(self) -> int:
        return self.data_tree.root

    # -- nullifier tree -------------------------------------------------------
    def null_index(self, nullifier: int) -> int:
        return nullifier & ((1 << self.null_tree.depth) - 1)

    def insert_nullifier(self, nullifier: int,
                         is_real: bool = True) -> Tuple[int, HashPath]:
        """Insert (or no-op for padding) one nullifier; returns
        (new_root, old_path) — the witness data the circuits need."""
        index = self.null_index(nullifier) if is_real else 0
        old_path = self.null_tree.get_hash_path(index)
        if is_real:
            value = (1).to_bytes(64, "big")
            self.null_tree.update_element(index, value)
        return self.null_tree.root, old_path

    # -- root tree ------------------------------------------------------------
    def insert_data_root(self, rollup_id: int,
                         data_root: int) -> Tuple[int, HashPath]:
        index = rollup_id + 1
        old_path = self.root_tree.get_hash_path(index)
        self.root_tree.update_element(index, data_root.to_bytes(32, "big"))
        self._root_index[data_root] = index
        return self.root_tree.root, old_path
