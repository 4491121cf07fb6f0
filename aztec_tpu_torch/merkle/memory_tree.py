"""Dense in-memory Merkle tree (ref: stdlib/merkle_tree/memory_tree.cpp).

Port of aztec_tpu/merkle/memory_tree.py, host Python: the same inputs give
the same values.
"""

from __future__ import annotations

from typing import List, Tuple

from ..crypto.pedersen import compress_native, compress_buffer_to_field


def hash_value_native(value: bytes) -> int:
    """Pedersen hash of a leaf preimage buffer (ref: hash.hpp:28-36 →
    crypto/pedersen compress_native(vector<uint8_t>): all-zero buffers
    hash to the buffer length, pedersen.cpp:358-371)."""
    if not any(value):
        return len(value)
    return compress_buffer_to_field(value)


class MemoryTree:
    """Depth 1..20 dense tree of 64-byte zero-initialized preimages."""

    def __init__(self, depth: int):
        assert 1 <= depth <= 20
        self.depth = depth
        self.total_size = 1 << depth
        zero = bytes(64)
        self.preimages: List[bytes] = [zero] * self.total_size
        self.hashes: List[int] = [0] * (self.total_size * 2 - 2)

        current = hash_value_native(zero)
        layer_size = self.total_size
        offset = 0
        while offset < len(self.hashes):
            for i in range(layer_size):
                self.hashes[offset + i] = current
            current = compress_native(current, current)
            offset += layer_size
            layer_size //= 2
        self.root = current

    def get_hash_path(self, index: int) -> List[Tuple[int, int]]:
        path = []
        offset = 0
        layer_size = self.total_size
        for _ in range(self.depth):
            index -= index & 1
            path.append((self.hashes[offset + index], self.hashes[offset + index + 1]))
            offset += layer_size
            layer_size >>= 1
            index >>= 1
        return path

    def update_element(self, index: int, value: bytes) -> int:
        self.preimages[index] = value
        offset = 0
        layer_size = self.total_size
        current = hash_value_native(value)
        for _ in range(self.depth):
            self.hashes[offset + index] = current
            index &= ~1
            current = compress_native(
                self.hashes[offset + index], self.hashes[offset + index + 1]
            )
            offset += layer_size
            layer_size //= 2
            index //= 2
        self.root = current
        return self.root

    def get_element(self, index: int) -> bytes:
        return self.preimages[index]
