"""Shared in-circuit world-state tree updates used by the rollup,
root_rollup and escape_hatch circuits (ref: rollup/proofs/rollup/
rollup_circuit.cpp:33-94, root_rollup/root_rollup_circuit.cpp:27-47).

Port of aztec_tpu/rollup/tree_updates.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

from typing import List, Tuple

from ..crypto.pedersen import compress_many, compress_native
from ..stdlib.field_t import FieldT, BoolT
from ..stdlib.byte_array import field_to_bytes
from ..stdlib.group_native import bits_from_bytes_be
from ..stdlib.merkle_circuit import (
    hash_leaf_xy,
    update_membership,
    update_subtree_membership,
    compute_tree_root,
    index_bits_from_field,
)
from ..stdlib.pedersen_circuit import Point
from ..merkle.memory_tree import hash_value_native

CPath = List[Tuple[FieldT, FieldT]]

# hash of a nullifier-tree leaf whose 64-byte preimage encodes `1`
# (byte_array set_bit(0): the little-endian integer 1; ref:
# rollup_circuit.cpp:48-50 + byte_array.cpp:241-245)
_NULL_LEAF_SET = compress_many([0, 0, 1], 0)
_NULL_LEAF_EMPTY = 64  # all-zero 64-byte preimage hashes to its length


def nullifier_leaf_hash(is_real: BoolT) -> FieldT:
    """Hash of the new nullifier leaf: set-bit preimage when real, the
    empty preimage otherwise."""
    f = is_real.to_field()
    return (f * (_NULL_LEAF_SET - _NULL_LEAF_EMPTY)
            + _NULL_LEAF_EMPTY).normalize()


def field_bits_le(ctx, f: FieldT, depth: int) -> List[FieldT]:
    """The low `depth` little-endian bits of a field element via its
    CANONICAL byte decomposition (unique per value — the tree index is
    not malleable).  Used for nullifier indices."""
    bits = bits_from_bytes_be(ctx, field_to_bytes(f.normalize(), 32))
    return bits[:depth]


def check_nullifiers_inserted(ctx, new_null_roots: List[int],
                              old_null_paths: List[List[Tuple[int, int]]],
                              latest_null_root: FieldT,
                              new_null_indices: List[FieldT],
                              is_real_flags: List[BoolT]) -> FieldT:
    """Chain nullifier-tree single-leaf updates (ref:
    rollup_circuit.cpp:33-68; is_real there derives from num_txs — the
    caller passes the flags directly here).  Padding transactions insert
    the empty leaf at index 0, a no-op update.  Returns the final root."""
    F = FieldT

    for i, nullifier in enumerate(new_null_indices):
        is_real = is_real_flags[i]
        new_null_root = F.from_witness(ctx, new_null_roots[i])
        index = (nullifier * is_real.to_field()).normalize()
        depth = len(old_null_paths[i])
        bits_f = field_bits_le(ctx, index, depth)
        bits = [_bool_of(ctx, b) for b in bits_f]
        path = [(F.from_witness(ctx, l), F.from_witness(ctx, r))
                for (l, r) in old_null_paths[i]]

        old_leaf = FieldT.constant(_NULL_LEAF_EMPTY)
        new_leaf = nullifier_leaf_hash(is_real)
        update_membership(new_null_root, new_leaf, latest_null_root,
                          old_leaf, bits, path,
                          msg=f"check_nullifiers_inserted_{i}")
        latest_null_root = new_null_root
    return latest_null_root


def _bool_of(ctx, f: FieldT) -> BoolT:
    from ..stdlib.field_t import _bool_from_field

    return _bool_from_field(ctx, f)


def zero_subtree_root(height: int) -> int:
    """Root of an all-zero-preimage depth-`height` subtree
    (ref: merkle_tree zero_hash_at_height)."""
    h = hash_value_native(bytes(64))
    for _ in range(height):
        h = compress_native(h, h)
    return h


def check_data_tree_updated(ctx, rollup_size_pow2: int,
                            new_data_path: CPath, old_data_path: CPath,
                            new_data_values: List,
                            old_data_root: FieldT, new_data_root: FieldT,
                            data_start_index: FieldT,
                            tree_depth: int) -> None:
    """Append 2*rollup_size note commitments as a subtree replacement
    (ref: rollup_circuit.cpp:70-94).  new_data_values: list of Point
    (note commitments) or None for zero padding leaves."""
    height = rollup_size_pow2.bit_length()  # log2(2 * rollup_size)
    assert (1 << (height - 1)) == rollup_size_pow2

    leaf_hashes = []
    for v in new_data_values:
        if v is None:
            leaf_hashes.append(FieldT.constant(_NULL_LEAF_EMPTY))
        else:
            leaf_hashes.append(hash_leaf_xy(v.x, v.y))
    assert len(leaf_hashes) == 2 * rollup_size_pow2
    rollup_root = compute_tree_root(leaf_hashes)

    zst = FieldT.constant(zero_subtree_root(height))
    bits = index_bits_from_field(ctx, data_start_index, tree_depth)
    update_subtree_membership(
        new_data_root, rollup_root, old_data_root, zst,
        bits[height:], old_data_path[height:],
        msg="check_data_tree_updated")


def check_root_tree_updated(ctx, old_data_roots_path: CPath,
                            rollup_id: FieldT, new_data_root: FieldT,
                            new_data_roots_root: FieldT,
                            old_data_roots_root: FieldT,
                            tree_depth: int) -> None:
    """Insert the new data root into the root tree at index rollup_id + 1
    (ref: root_rollup_circuit.cpp:27-47)."""
    from ..stdlib.merkle_circuit import hash_leaf_32

    new_leaf = hash_leaf_32(new_data_root)
    old_leaf = FieldT.constant(_NULL_LEAF_EMPTY)
    index = (rollup_id + 1).normalize()
    bits = index_bits_from_field(ctx, index, tree_depth)
    update_membership(new_data_roots_root, new_leaf, old_data_roots_root,
                      old_leaf, bits, old_data_roots_path,
                      msg="check_root_tree_updated")
