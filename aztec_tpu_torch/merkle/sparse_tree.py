"""Sparse Merkle tree over a key/value store (ref: stdlib/merkle_tree/
merkle_tree.hpp + leveldb_store.hpp, without the stump compression).

Zero subtrees are never materialized: ``zero_hashes[d]`` caches the root of
an all-zero depth-d subtree, so a fresh tree costs O(depth) hashes and
updates cost O(depth) store writes.  The store interface is dict-like
(get/put of bytes), mirroring the reference's LevelDBStore so a real
LevelDB/rocksdb backing can slot in for the falafel-style world state.

Port of aztec_tpu/merkle/sparse_tree.py, host Python: the same inputs give
the same values.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..crypto.pedersen import compress_native
from .memory_tree import hash_value_native


class MemoryStore:
    """ref: stdlib/merkle_tree/memory_store.hpp."""

    def __init__(self):
        self._data = {}

    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def put(self, key: bytes, value: bytes):
        self._data[key] = value


class SparseTree:
    def __init__(self, store, depth: int, tree_id: bytes = b""):
        assert 1 <= depth <= 256
        self.store = store
        self.depth = depth
        self.tree_id = tree_id
        # zero_hashes[0] = hash(zero leaf); zero_hashes[d] = root at depth d
        zh = [hash_value_native(bytes(64))]
        for _ in range(depth):
            zh.append(compress_native(zh[-1], zh[-1]))
        self.zero_hashes = zh
        self.root = zh[depth]

    # node key: (level from leaves, index)
    def _key(self, level: int, index: int) -> bytes:
        return self.tree_id + level.to_bytes(2, "big") + index.to_bytes(32, "big")

    def _node(self, level: int, index: int) -> int:
        raw = self.store.get(self._key(level, index))
        if raw is None:
            return self.zero_hashes[level]
        return int.from_bytes(raw, "big")

    def update_element(self, index: int, value: bytes) -> int:
        current = hash_value_native(value)
        self.store.put(self._key(0, index) + b"~pre", value)
        for level in range(self.depth):
            self.store.put(self._key(level, index), current.to_bytes(32, "big"))
            sibling = self._node(level, index ^ 1)
            if index & 1:
                current = compress_native(sibling, current)
            else:
                current = compress_native(current, sibling)
            index >>= 1
        self.store.put(self._key(self.depth, 0), current.to_bytes(32, "big"))
        self.root = current
        return current

    def get_element(self, index: int) -> bytes:
        raw = self.store.get(self._key(0, index) + b"~pre")
        return raw if raw is not None else bytes(64)

    def get_hash_path(self, index: int) -> List[Tuple[int, int]]:
        path = []
        for level in range(self.depth):
            base = index & ~1
            path.append((self._node(level, base), self._node(level, base + 1)))
            index >>= 1
        return path


def check_hash_path(root: int, index: int, path, leaf_hash: int) -> bool:
    """Native membership check (ref: membership.hpp check_membership)."""
    current = leaf_hash
    for level, (left, right) in enumerate(path):
        expected = current
        got = left if ((index >> level) & 1) == 0 else right
        if got != expected:
            return False
        current = compress_native(left, right)
    return current == root
