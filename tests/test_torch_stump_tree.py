"""The port's stump tree (aztec_tpu_torch.merkle.stump_tree) against
aztec_tpu's and against the port's SparseTree, on the CPU.

On seeded random updates at small depths: the root after each update, the
hash paths (every index against the sparse tree, some against aztec_tpu),
the content-addressed store node for node (so every historic root stays
readable, as in aztec_tpu), and one element updated three times.  The
sqlite store persists through a file and reopens to the same tree.  At
depth 256 (the production nullifier tree) the port is held to
``tests/torch_vectors/stump_d256.json``, aztec_tpu's roots and one hash
path after a few seeded nullifiers, which make_vectors.py ``stump_d256``
writes (aztec_tpu's tree takes minutes at that depth).
"""

import json
import os
import random

import pytest

from aztec_tpu.merkle.sparse_tree import MemoryStore as RefStore
from aztec_tpu.merkle.stump_tree import SqliteStore as RefSqlite
from aztec_tpu.merkle.stump_tree import StumpTree as RefStump
from aztec_tpu_torch.crypto.pedersen import compress_native
from aztec_tpu_torch.merkle import (MemoryStore, SparseTree, SqliteStore,
                                    StumpTree, hash_value_native)

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261018


def leaf(i: int) -> bytes:
    return i.to_bytes(64, "big")


def verify_path(tree, index: int, value: bytes) -> bool:
    """Recompute the root from the hash path (membership check)."""
    cur = hash_value_native(value)
    for lvl, (left, right) in enumerate(tree.get_hash_path(index)):
        if (index >> lvl) & 1:
            if right != cur:
                return False
        elif left != cur:
            return False
        cur = compress_native(left, right)
    return cur == tree.root


@pytest.mark.parametrize("depth,updates", [(4, 12), (6, 10)])
def test_matches_reference_and_sparse_tree(depth, updates):
    rng = random.Random(SEED + depth)
    st = StumpTree(MemoryStore(), depth)
    sp = SparseTree(MemoryStore(), depth)
    ref = RefStump(RefStore(), depth)
    assert st.root == sp.root == ref.root
    roots = []
    for k in range(updates):
        i = rng.randrange(1 << depth)   # repeats update a stored element
        v = leaf(rng.getrandbits(200))
        r = st.update_element(i, v)
        assert r == sp.update_element(i, v) == ref.update_element(i, v), k
        assert st.get_element(i) == v
        roots.append(r)
    assert st.size == ref.size
    assert st.zero_hashes == ref.zero_hashes
    # content-addressed nodes, never overwritten: the same store, and
    # every historic root still readable
    assert st.store._data == ref.store._data
    assert all(st.store.get(r.to_bytes(32, "big")) is not None
               for r in roots)
    for i in range(1 << depth):
        assert st.get_hash_path(i) == sp.get_hash_path(i), i
    for i in rng.sample(range(1 << depth), 4):
        assert st.get_hash_path(i) == ref.get_hash_path(i), i


def test_update_same_element():
    st, sp, ref = StumpTree(MemoryStore(), 5), SparseTree(MemoryStore(), 5), \
        RefStump(RefStore(), 5)
    for v in (leaf(1), leaf(2), leaf(3)):
        r = st.update_element(9, v)
        assert r == sp.update_element(9, v) == ref.update_element(9, v)
    assert verify_path(st, 9, leaf(3))
    assert st.get_hash_path(9) == ref.get_hash_path(9)


def test_sqlite_store_persistence(tmp_path):
    p, q = str(tmp_path / "tree.db"), str(tmp_path / "ref.db")
    st = StumpTree(SqliteStore(p), 8, b"\x01")
    ref = RefStump(RefSqlite(q), 8, b"\x01")
    for i in (1, 7, 200):
        r = st.update_element(i, leaf(i))
        assert r == ref.update_element(i, leaf(i))
    st.store.commit()
    st2 = StumpTree(SqliteStore(p), 8, b"\x01")     # reopened
    assert st2.root == r and st2.size == 201
    assert st2.get_element(7) == leaf(7)
    assert st2.get_element(8) == bytes(64)
    assert verify_path(st2, 200, leaf(200))
    rows = lambda store: sorted(  # noqa: E731
        store._conn.execute("SELECT k, v FROM kv").fetchall())
    assert rows(st2.store) == rows(ref.store)


def test_depth_256_against_committed_vector():
    with open(os.path.join(HERE, "torch_vectors", "stump_d256.json")) as f:
        rec = json.load(f)
    assert rec["producer"] == "aztec_tpu"
    rng = random.Random(rec["seed"])
    st = StumpTree(MemoryStore(), 256)
    assert hex(st.root) == rec["empty"]
    for n, root in zip(rec["nullifiers"], rec["roots"]):
        assert int(n, 16) == rng.getrandbits(254)
        st.update_element(int(n, 16), (1).to_bytes(64, "big"))
        assert hex(st.root) == root
    assert len(rec["roots"]) >= 3
    path = st.get_hash_path(int(rec["nullifiers"][0], 16))
    assert [[hex(a), hex(b)] for a, b in path] == rec["path"]
    assert len(path) == 256
