"""Content-addressed Merkle tree with stump compression + persistent store
(ref: stdlib/merkle_tree/merkle_tree.cpp:140-310, leveldb_store.hpp:21).

Nodes are stored by hash (key = node hash, value = left||right), so
subtrees are shared/immutable snapshots: any historic root remains
readable.  A subtree containing a SINGLE element is collapsed to a
"stump" record (value, index) — 256-deep trees (the production nullifier
tree) cost O(occupied-path) per op instead of O(depth), exactly the
reference's design.

SqliteStore replaces the reference's LevelDB (not in this image) with the
same dict-of-bytes contract; MemoryStore works for tests.

Port of aztec_tpu/merkle/stump_tree.py over the port's host Pedersen hash.
"""

from __future__ import annotations

import sqlite3
from typing import List, Optional, Tuple

from ..crypto.pedersen import compress_native
from .memory_tree import hash_value_native
from .sparse_tree import MemoryStore

HashPath = List[Tuple[int, int]]

_STUMP_TAG = b"\x01"


class SqliteStore:
    """Persistent key/value store (LevelDbStore role, leveldb_store.hpp)."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
        self._conn.commit()
        self._pending = 0

    def get(self, key: bytes) -> Optional[bytes]:
        row = self._conn.execute(
            "SELECT v FROM kv WHERE k=?", (key,)).fetchone()
        return row[0] if row else None

    def put(self, key: bytes, value: bytes):
        self._conn.execute(
            "INSERT OR REPLACE INTO kv VALUES (?,?)", (key, value))
        self._pending += 1
        if self._pending >= 256:
            self.commit()

    def commit(self):
        self._conn.commit()
        self._pending = 0


def _clz_diff(diff: int, width: int) -> int:
    """count_leading_zeros of a width-bit value."""
    return width - diff.bit_length()


class StumpTree:
    def __init__(self, store, depth: int, tree_id: bytes = b"\x00"):
        assert 1 <= depth <= 256
        self.store = store
        self.depth = depth
        self.tree_id = tree_id
        zh = [hash_value_native(bytes(64))]
        for _ in range(depth):
            zh.append(compress_native(zh[-1], zh[-1]))
        # zero_hashes[h] = root of an all-zero height-h subtree
        self.zero_hashes = zh

    # ---- metadata ----------------------------------------------------------

    @property
    def root(self) -> int:
        raw = self.store.get(self.tree_id)
        if raw is None:
            return self.zero_hashes[self.depth]
        return int.from_bytes(raw[:32], "big")

    @property
    def size(self) -> int:
        raw = self.store.get(self.tree_id)
        return int.from_bytes(raw[32:64], "big") if raw else 0

    # ---- helpers -----------------------------------------------------------

    def _get_node(self, h: int) -> Optional[bytes]:
        return self.store.get(h.to_bytes(32, "big"))

    def _put(self, key: int, left: int, right: int):
        self.store.put(key.to_bytes(32, "big"),
                       left.to_bytes(32, "big") + right.to_bytes(32, "big"))

    def _put_stump(self, key: int, index: int, value: int):
        self.store.put(key.to_bytes(32, "big"),
                       value.to_bytes(32, "big") + index.to_bytes(32, "big")
                       + _STUMP_TAG)

    def _zero_path_hash(self, height: int, index: int, value: int) -> int:
        """Root of a height-`height` subtree empty except `value` at
        `index` (compute_zero_path_hash)."""
        cur = value
        for j in range(height):
            if (index >> j) & 1:
                cur = compress_native(self.zero_hashes[j], cur)
            else:
                cur = compress_native(cur, self.zero_hashes[j])
        return cur

    def _binary_put(self, a_index: int, a: int, b: int, height: int) -> int:
        a_right = (a_index >> (height - 1)) & 1
        left, right = (b, a) if a_right else (a, b)
        key = compress_native(left, right)
        self._put(key, left, right)
        return key

    # ---- element io --------------------------------------------------------

    def get_element(self, index: int) -> bytes:
        raw = self.store.get(
            self.tree_id + b"leaf" + index.to_bytes(32, "big"))
        return raw if raw is not None else bytes(64)

    def update_element(self, index: int, value: bytes) -> int:
        self.store.put(self.tree_id + b"leaf" + index.to_bytes(32, "big"),
                       value)
        leaf = hash_value_native(value)
        r = self._update(self.root, leaf, index, self.depth)
        self.store.put(self.tree_id,
                       r.to_bytes(32, "big") + (index + 1).to_bytes(32, "big"))
        if hasattr(self.store, "commit"):
            self.store.commit()
        return r

    def _update(self, root: int, value: int, index: int, height: int) -> int:
        if height == 0:
            return value
        data = self._get_node(root)
        if data is None:
            key = self._zero_path_hash(height, index, value)
            self._put_stump(key, index, value)
            return key
        if len(data) != 64:
            # stump
            ex_index = int.from_bytes(data[32:64], "big")
            if ex_index == index:
                key = self._zero_path_hash(height, index, value)
                self._put_stump(key, index, value)
                return key
            ex_value = int.from_bytes(data[:32], "big")
            common_height = height - _clz_diff(ex_index ^ index, height)
            return self._fork_stump(ex_value, ex_index, value, index,
                                    height, common_height)
        is_right = (index >> (height - 1)) & 1
        left = int.from_bytes(data[:32], "big")
        right = int.from_bytes(data[32:64], "big")
        child = right if is_right else left
        mask = (1 << (height - 1)) - 1
        child = self._update(child, value, index & mask, height - 1)
        if is_right:
            right = child
        else:
            left = child
        new_root = compress_native(left, right)
        self._put(new_root, left, right)
        return new_root

    def _fork_stump(self, v1: int, i1: int, v2: int, i2: int,
                    height: int, common_height: int) -> int:
        if height == common_height:
            if height == 1:
                return self._binary_put(i1 & 1, v1, v2, height)
            sh = height - 1
            m = (1 << sh) - 1
            s1h = self._zero_path_hash(sh, i1 & m, v1)
            s2h = self._zero_path_hash(sh, i2 & m, v2)
            self._put_stump(s1h, i1 & m, v1)
            self._put_stump(s2h, i2 & m, v2)
            return self._binary_put(i1, s1h, s2h, height)
        new_root = self._fork_stump(v1, i1, v2, i2, height - 1, common_height)
        return self._binary_put(i1, new_root, self.zero_hashes[height - 1],
                                height)

    # ---- hash paths --------------------------------------------------------

    def get_hash_path(self, index: int) -> HashPath:
        path: List[Optional[Tuple[int, int]]] = [None] * self.depth
        data = self._get_node(self.root)
        for i in range(self.depth - 1, -1, -1):
            if data is None:
                path[i] = (self.zero_hashes[i], self.zero_hashes[i])
                continue
            if len(data) == 64:
                left = int.from_bytes(data[:32], "big")
                right = int.from_bytes(data[32:64], "big")
                path[i] = (left, right)
                child = right if (index >> i) & 1 else left
                data = self._get_node(child)
            else:
                # stump: restore the rest of the path from (value, index)
                cur = int.from_bytes(data[:32], "big")
                el_index = int.from_bytes(data[32:64], "big")
                sub_index = index & ((1 << (i + 1)) - 1)
                diff = el_index ^ sub_index
                if diff < 2:
                    for j in range(i + 1):
                        if (el_index >> j) & 1:
                            path[j] = (self.zero_hashes[j], cur)
                        else:
                            path[j] = (cur, self.zero_hashes[j])
                        cur = compress_native(path[j][0], path[j][1])
                else:
                    common_height = i - _clz_diff(diff, i + 1)
                    for j in range(common_height):
                        path[j] = (self.zero_hashes[j], self.zero_hashes[j])
                    cur = self._zero_path_hash(common_height, el_index, cur)
                    for j in range(common_height, i + 1):
                        if (el_index >> j) & 1:
                            path[j] = (self.zero_hashes[j], cur)
                        else:
                            path[j] = (cur, self.zero_hashes[j])
                        cur = compress_native(path[j][0], path[j][1])
                break
        return path  # type: ignore[return-value]
