"""packed_byte_array: byte strings packed 16 bytes per field element
(ref: stdlib/primitives/packed_byte_array/packed_byte_array.hpp/.cpp).

sha256-style circuits hash long messages; storing one witness per byte
(byte_array) costs a range gate per byte, while packing 16 bytes per
field limb amortizes decomposition until a byte-level view is actually
needed.  `append` merges partial limbs exactly like the reference
(bytes_to_append folds into the trailing limb's unused low bytes).

Port of aztec_tpu/stdlib/packed_byte_array.py.
"""

from __future__ import annotations

from typing import List

from .byte_array import field_to_bytes
from .field_t import FieldT

BYTES_PER_ELEMENT = 16


class PackedByteArray:
    def __init__(self, ctx, limbs: List[FieldT], num_bytes: int):
        self.ctx = ctx
        self.limbs = limbs  # big-endian byte packing, 16 bytes per limb
        self.num_bytes = num_bytes

    # -- constructors ----------------------------------------------------------

    @staticmethod
    def from_bytes(ctx, data: bytes) -> "PackedByteArray":
        """Witness limbs of 16 big-endian bytes each (last limb may be
        short; it is stored left-aligned scaled values like the reference:
        value * 2^(8*(16-k)) is NOT applied — short limbs hold the raw
        big-endian integer of their bytes)."""
        limbs = []
        for i in range(0, len(data), BYTES_PER_ELEMENT):
            chunk = data[i:i + BYTES_PER_ELEMENT]
            limbs.append(FieldT.from_witness(ctx, int.from_bytes(chunk, "big")))
        return PackedByteArray(ctx, limbs, len(data))

    @staticmethod
    def from_field_slices(ctx, inputs: List[FieldT],
                          bytes_per_input: int = BYTES_PER_ELEMENT
                          ) -> "PackedByteArray":
        """Re-pack field elements of `bytes_per_input` bytes each into
        16-byte limbs (ref: packed_byte_array(vector<field_pt>, n)).  Each
        input is byte-decomposed (range-constrained), so the resulting
        limbs are bound to the inputs."""
        assert bytes_per_input <= 32
        all_bytes: List[FieldT] = []
        for f in inputs:
            all_bytes.extend(field_to_bytes(f, bytes_per_input))
        limbs = []
        for i in range(0, len(all_bytes), BYTES_PER_ELEMENT):
            chunk = all_bytes[i:i + BYTES_PER_ELEMENT]
            acc = FieldT.constant(0)
            for b in chunk:
                acc = acc * 256 + b
            limbs.append(acc.normalize() if not acc.is_constant() else acc)
        return PackedByteArray(ctx, limbs,
                               len(inputs) * bytes_per_input)

    # -- accessors -------------------------------------------------------------

    def size(self) -> int:
        return self.num_bytes

    def get_limbs(self) -> List[FieldT]:
        return list(self.limbs)

    def get_value(self) -> bytes:
        out = b""
        remaining = self.num_bytes
        for limb in self.limbs:
            k = min(BYTES_PER_ELEMENT, remaining)
            out += limb.get_value().to_bytes(k, "big")
            remaining -= k
        return out

    # -- mutation ---------------------------------------------------------------

    def append(self, to_append: FieldT, bytes_to_append: int) -> None:
        """Append `bytes_to_append` bytes held in `to_append` (ref:
        packed_byte_array::append — folds into the trailing partial limb,
        splitting the appended value at the limb boundary when needed)."""
        assert bytes_to_append <= BYTES_PER_ELEMENT
        used = self.num_bytes % BYTES_PER_ELEMENT
        free = (BYTES_PER_ELEMENT - used) % BYTES_PER_ELEMENT
        v = to_append.get_value()
        assert v < (1 << (8 * bytes_to_append)), "append value too wide"

        if used == 0:
            self.limbs.append(to_append)
        elif bytes_to_append <= free:
            # fold entirely into the trailing limb
            self.limbs[-1] = (self.limbs[-1] * (1 << (8 * bytes_to_append))
                              + to_append)
        else:
            # split at the limb boundary: high part completes the trailing
            # limb, low part starts a new one.  The split is witnessed and
            # constrained (hi * 2^(8*lo_bytes) + lo == to_append).
            lo_bytes = bytes_to_append - free
            hi_v = v >> (8 * lo_bytes)
            lo_v = v & ((1 << (8 * lo_bytes)) - 1)
            hi = FieldT.from_witness(self.ctx, hi_v)
            lo = FieldT.from_witness(self.ctx, lo_v)
            self.ctx.create_range_constraint(hi.witness_index, 8 * free)
            self.ctx.create_range_constraint(lo.witness_index, 8 * lo_bytes)
            (hi * (1 << (8 * lo_bytes)) + lo).assert_equal(
                to_append, "packed_byte_array append split")
            self.limbs[-1] = self.limbs[-1] * (1 << (8 * free)) + hi
            self.limbs.append(lo)
        self.num_bytes += bytes_to_append

    # -- conversions -------------------------------------------------------------

    def to_unverified_byte_slices(self, bytes_per_slice: int) -> List[FieldT]:
        """Re-slice into field elements of `bytes_per_slice` bytes WITHOUT
        range constraints (ref: to_unverified_byte_slices — callers add
        their own constraints, e.g. sha256's word loads)."""
        all_bytes: List[int] = []
        remaining = self.num_bytes
        for limb in self.limbs:
            k = min(BYTES_PER_ELEMENT, remaining)
            lv = limb.get_value()
            all_bytes.extend((lv >> (8 * (k - 1 - j))) & 0xFF
                             for j in range(k))
            remaining -= k
        slices = []
        for i in range(0, len(all_bytes), bytes_per_slice):
            chunk = all_bytes[i:i + bytes_per_slice]
            v = 0
            for b in chunk:
                v = v * 256 + b
            slices.append(FieldT.from_witness(self.ctx, v))
        # bind the unverified slices back to the limbs with one linear
        # constraint per limb-boundary-free region: recompose slices and
        # assert equality against the limb stream
        self._assert_slices_match(slices, bytes_per_slice)
        return slices

    def _assert_slices_match(self, slices: List[FieldT],
                             bytes_per_slice: int) -> None:
        """One global recomposition check: the big-endian concatenation of
        the slices equals the concatenation of the limbs.  (The reference
        leaves slices fully unverified; we add the cheap linear binding —
        per-slice range constraints remain the caller's job, hence the
        name.)"""
        total_bits = 0
        acc_slices = FieldT.constant(0)
        for i, s in enumerate(slices):
            k = min(bytes_per_slice, self.num_bytes - i * bytes_per_slice)
            acc_slices = acc_slices * (1 << (8 * k)) + s
            total_bits += 8 * k
        if total_bits > 250:  # split into <=250-bit windows to avoid wrap
            # compare limb-aligned windows instead
            remaining = self.num_bytes
            si = 0
            for limb in self.limbs:
                k = min(BYTES_PER_ELEMENT, remaining)
                # slices within this limb (only valid when bytes_per_slice
                # divides the limb size)
                if bytes_per_slice > BYTES_PER_ELEMENT or \
                        BYTES_PER_ELEMENT % bytes_per_slice:
                    return  # fall back to unverified (reference behavior)
                per = k // bytes_per_slice if k % bytes_per_slice == 0 else 0
                if not per:
                    return
                acc = FieldT.constant(0)
                for s in slices[si:si + per]:
                    acc = acc * (1 << (8 * bytes_per_slice)) + s
                si += per
                acc.assert_equal(limb, "packed_byte_array slice binding")
                remaining -= k
        else:
            acc_limbs = FieldT.constant(0)
            remaining = self.num_bytes
            for limb in self.limbs:
                k = min(BYTES_PER_ELEMENT, remaining)
                acc_limbs = acc_limbs * (1 << (8 * k)) + limb
                remaining -= k
            acc_slices.assert_equal(acc_limbs,
                                    "packed_byte_array slice binding")
