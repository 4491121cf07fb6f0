"""In-circuit Fiat-Shamir transcript for recursive verification
(ref: stdlib/recursion/transcript/transcript.hpp:27-228).

Mirrors the native unrolled transcript byte-for-byte: per round the buffer
(previous challenge, 32 bytes, round > 0; then each manifest element's
bytes) is Pedersen-compressed in 31-byte chunks
(crypto/pedersen compress_native(vector<uint8_t>)), the compressed field
element's 32 BE bytes are Blake2s-hashed, and the 32-byte output yields two
right-aligned 16-byte challenges; extra challenges hash
(base_hash || counter) with plain Blake2s.

All data lives as in-circuit bytes (8-bit-constrained FieldTs); the
challenges come back as FieldT scalars (128-bit) plus their byte form.

Port of aztec_tpu/stdlib/recursion_transcript.py, on the port's composers:
host Python, so the same inputs record the same gates.
"""

from __future__ import annotations

from typing import Dict, List

from ..transcript.manifest import Manifest
from .field_t import FieldT
from .byte_array import field_to_bytes, bytes_to_uint32_words_le
from .blake2s_circuit import blake2s_words
from .pedersen_circuit import compress_many
from .uint32 import UInt32

PRNG_SIZE = 32
CHALLENGE_BYTES = 16


def _compress_buffer(ctx, buf: List[FieldT]) -> FieldT:
    """Pedersen-compress in-circuit bytes: 31-byte big-endian chunks to
    field elements, their hashes summed over generator indices (ref:
    pedersen.cpp compress_native_buffer_to_field).  A chunk of value 0
    hashes to the point at infinity and adds nothing, as in the native
    transcript: the sum handles it (``compress_many``'s edge cases)."""
    chunks = []
    for i in range(0, len(buf), 31):
        part = buf[i : i + 31]
        acc = FieldT.constant(0)
        for b in part:
            acc = acc * 256 + b
        chunks.append(acc)
    return compress_many(chunks)


def _blake2s_bytes(ctx, buf: List[FieldT]) -> List[FieldT]:
    """Blake2s over in-circuit bytes -> 32 in-circuit output bytes."""
    n = len(buf)
    pad = (-n) % 64 if n % 64 or n == 0 else 0
    padded = list(buf) + [FieldT.constant(0)] * (pad if n else 64)
    words = bytes_to_uint32_words_le(padded, ctx)
    out_words = blake2s_words(ctx, words, n)
    out_bytes: List[FieldT] = []
    for w in out_words:
        wb = field_to_bytes(w_to_field(ctx, w), 4)  # big-endian 4 bytes
        # digest packing is little-endian per word
        out_bytes.extend(reversed(wb))
    return out_bytes


def w_to_field(ctx, w: UInt32) -> FieldT:
    return FieldT(ctx, w.witness_index, 0, 1)


def bytes_to_field(bs: List[FieldT]) -> FieldT:
    acc = FieldT.constant(0)
    for b in bs:
        acc = acc * 256 + b
    return acc.normalize()


class RecursiveTranscript:
    def __init__(self, ctx, manifest: Manifest):
        self.ctx = ctx
        self.manifest = manifest
        self.elements: Dict[str, List[FieldT]] = {}
        self.challenges: Dict[str, List[FieldT]] = {}
        self.current_round = 0
        self.current_challenge_bytes: List[FieldT] = []

    def add_element_bytes(self, name: str, data: List[FieldT]):
        self.elements[name] = data

    def add_element_native(self, name: str, raw: bytes, as_witness=True):
        """Proof bytes enter as 8-bit-constrained witnesses (constants for
        verifier-pinned values like circuit_size)."""
        if not as_witness:
            self.elements[name] = [FieldT.constant(b) for b in raw]
            return
        out = []
        for b in raw:
            f = FieldT.from_witness(self.ctx, b)
            self.ctx.create_range_constraint(f.witness_index, 8)
            out.append(f)
        self.elements[name] = out

    def apply_fiat_shamir(self, challenge_name: str):
        rm = self.manifest.get_round_manifest(self.current_round)
        assert rm.challenge == challenge_name
        num = rm.num_challenges
        if num == 0:
            self.current_round += 1
            return
        ctx = self.ctx
        buf: List[FieldT] = []
        if self.current_round > 0:
            buf.extend(self.current_challenge_bytes)
        for el in rm.elements:
            data = self.elements[el.name]
            assert len(data) == el.num_bytes, (el.name, len(data), el.num_bytes)
            buf.extend(data)

        compressed = _compress_buffer(ctx, buf)
        base_hash = _blake2s_bytes(ctx, field_to_bytes(compressed, 32))

        out: List[List[FieldT]] = []

        def emit(hash_bytes, j):
            c = hash_bytes[j * CHALLENGE_BYTES : (j + 1) * CHALLENGE_BYTES]
            out.append([FieldT.constant(0)] * (PRNG_SIZE - CHALLENGE_BYTES) + c)

        per_hash = PRNG_SIZE // CHALLENGE_BYTES  # 2
        for j in range(per_hash):
            if j < num:
                emit(base_hash, j)
        num_hashes = (num + per_hash - 1) // per_hash
        for i in range(1, num_hashes):
            rolling = list(base_hash) + [FieldT.constant(i)]
            h = _blake2s_bytes(ctx, rolling)
            for j in range(per_hash):
                if per_hash * i + j < num:
                    emit(h, j)

        self.current_challenge_bytes = out[-1]
        self.challenges[challenge_name] = [bytes_to_field(c) for c in out]
        self.current_round += 1

    def get_challenge(self, name: str, idx: int = 0) -> FieldT:
        return self.challenges[name][idx]
