"""In-circuit Merkle membership (ref: stdlib/merkle_tree/membership.hpp).

check_membership hashes a leaf up a Pedersen path, selecting child order by
the index bits; assert_check_membership pins the result to the root.
update_membership proves old-leaf membership and new-root correctness with
the same path (the world-state update constraint).

Port of aztec_tpu/stdlib/merkle_circuit.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

from typing import List, Tuple

from .field_t import FieldT, BoolT
from .byte_array import field_to_bytes
from . import pedersen_circuit as pc
from .pedersen_circuit import compress


def hash_leaf_elements(elements: List[FieldT], num_bytes: int) -> FieldT:
    """Pedersen hash of a leaf preimage given as its 31-byte-chunk field
    elements (ref: stdlib pedersen.cpp:486-511 compress(byte_array)): an
    all-zero preimage hashes to its byte length."""
    if all(e.is_constant() for e in elements):
        from ..crypto.pedersen import compress_many

        if all(e.get_value() == 0 for e in elements):
            return FieldT.constant(num_bytes)
        return FieldT.constant(
            compress_many([e.get_value() for e in elements], 0))
    compressed = pc.encrypt(elements, 0, handle_edge_cases=True).x
    is_zero = elements[0].is_zero()
    for e in elements[1:]:
        is_zero = is_zero & e.is_zero()
    z = is_zero.to_field()
    return (z * (FieldT.constant(num_bytes) - compressed)
            + compressed).normalize()


def hash_leaf_32(x: FieldT) -> FieldT:
    """Hash of a 32-byte leaf preimage (one field element, e.g. a data
    root in the root tree): chunks of 31 + 1 bytes."""
    b = field_to_bytes(x, 32)

    def pack(chunk: List[FieldT]) -> FieldT:
        acc = FieldT.constant(0)
        for f in chunk:
            acc = acc * 256 + f
        return acc.normalize()

    return hash_leaf_elements([pack(b[0:31]), pack(b[31:32])], 32)


def hash_leaf_xy(x: FieldT, y: FieldT) -> FieldT:
    """Hash of the 64-byte (x || y) leaf preimage used for note
    commitments and tree roots (ref: merkle_tree hash_value of
    byte_array(x).write(y)).  Decomposes to canonical bytes and repacks
    into the 31/31/2-byte chunks the byte-oriented pedersen uses."""
    xb = field_to_bytes(x, 32)
    yb = field_to_bytes(y, 32)
    b = xb + yb

    def pack(chunk: List[FieldT]) -> FieldT:
        acc = FieldT.constant(0)
        for f in chunk:
            acc = acc * 256 + f
        return acc.normalize()

    return hash_leaf_elements([pack(b[0:31]), pack(b[31:62]), pack(b[62:64])],
                              64)


def _select(bit: BoolT, a: FieldT, b: FieldT) -> Tuple[FieldT, FieldT]:
    """(a, b) if bit == 0 else (b, a) — two conditional swaps."""
    f = bit.to_field()
    left = a + f * (b - a)
    right = b + f * (a - b)
    return left, right


def compute_root_from_path(leaf: FieldT, index_bits: List[BoolT],
                           path: List[Tuple[FieldT, FieldT]]) -> FieldT:
    """path[i] = (left_sibling, right_sibling) values at level i."""
    current = leaf
    for bit, (l_sib, r_sib) in zip(index_bits, path):
        # when bit = 0 the current node is the left child: hash(cur, r_sib);
        # when bit = 1 it is the right child: hash(l_sib, cur)
        left, _ = _select(bit, current, l_sib)
        right, _ = _select(bit, r_sib, current)
        current = compress(left, right)
    return current


def check_membership(root: FieldT, leaf: FieldT, index_bits: List[BoolT],
                     path: List[Tuple[FieldT, FieldT]]) -> bool:
    got = compute_root_from_path(leaf, index_bits, path)
    return got.get_value() == root.get_value()


def check_membership_bool(root: FieldT, leaf: FieldT,
                          index_bits: List[BoolT],
                          path: List[Tuple[FieldT, FieldT]]) -> BoolT:
    """In-circuit membership test returning a constrained BoolT
    (ref: membership.hpp:12-37 check_membership → bool_t)."""
    got = compute_root_from_path(leaf, index_bits, path)
    return (got - root).is_zero()


def assert_check_membership(root: FieldT, leaf: FieldT,
                            index_bits: List[BoolT],
                            path: List[Tuple[FieldT, FieldT]]):
    got = compute_root_from_path(leaf, index_bits, path)
    got.assert_equal(root, "merkle membership")


def update_membership(new_root: FieldT, new_leaf: FieldT,
                      old_root: FieldT, old_leaf: FieldT,
                      index_bits: List[BoolT],
                      path: List[Tuple[FieldT, FieldT]],
                      msg: str = "update_membership"):
    """ref: membership.hpp:81-104 update_membership — old and new roots
    are both recomputed from the SAME sibling path, which is what proves
    the update touched only this leaf."""
    assert_check_membership(old_root, old_leaf, index_bits, path)
    assert_check_membership(new_root, new_leaf, index_bits, path)


def update_subtree_membership(new_root: FieldT, new_subtree_root: FieldT,
                              old_root: FieldT, old_subtree_root: FieldT,
                              index_bits_above: List[BoolT],
                              path: List[Tuple[FieldT, FieldT]],
                              msg: str = "update_subtree_membership"):
    """ref: membership.hpp:107-129 — replace a whole subtree: both the old
    and the new subtree roots hash up the same sibling path to their
    respective tree roots.  index_bits_above are the index bits ABOVE the
    subtree (i.e. index >> subtree_height), path covers those levels."""
    assert_check_membership(old_root, old_subtree_root, index_bits_above, path)
    assert_check_membership(new_root, new_subtree_root, index_bits_above, path)


def compute_tree_root(leaf_hashes: List[FieldT]) -> FieldT:
    """Root of a dense pow-2 tree of (already hashed) leaves
    (ref: membership.hpp:131-146 compute_tree_root)."""
    layer = list(leaf_hashes)
    assert layer and (len(layer) & (len(layer) - 1)) == 0
    while len(layer) > 1:
        layer = [compress(layer[2 * i], layer[2 * i + 1])
                 for i in range(len(layer) // 2)]
    return layer[0]


def index_bits_from_field(ctx, index: FieldT, depth: int) -> List[BoolT]:
    """Witness the low `depth` bits of a tree index (LSB first) and
    constrain the recomposition — the circuit form of byte_array(index)
    bit addressing (ref: byte_array.cpp get_bit, little-endian)."""
    v = index.get_value()
    bits = []
    acc = FieldT.constant(0)
    for i in range(depth):
        b = BoolT.from_witness(ctx, bool((v >> i) & 1))
        bits.append(b)
        acc = acc + b.to_field() * (1 << i)
    acc.assert_equal(index, "index bit recomposition")
    return bits
