"""Merkle trees (ref: stdlib/merkle_tree/).

Host implementations backing the rollup world state: ``MemoryTree`` (dense,
test-sized — memory_tree.cpp) and ``SparseTree`` (zero-subtree-cached, any
depth, dict/LevelDB-style store — merkle_tree.cpp).  Leaves/nodes hash with
Pedersen (hash.hpp).  Bulk tree building is a future device kernel (batched
Pedersen lanes).

Port of aztec_tpu/merkle/ (``stump_tree`` included).
"""

from .memory_tree import MemoryTree, hash_value_native  # noqa: F401
from .sparse_tree import SparseTree, MemoryStore  # noqa: F401
from .stump_tree import SqliteStore, StumpTree  # noqa: F401
