"""In-circuit BLAKE2s over stdlib uint32 (ref: stdlib/hash/blake2s/).

Needed by the recursive transcript (16-byte challenge generation,
stdlib/recursion/transcript/transcript.hpp).  The G function is adds, xors
and fixed rotations — exactly the gate-backed ops UInt32 provides.

Input: bytes (host constants) and/or in-circuit words; this implementation
takes a list of UInt32 message words (little-endian packing of the input,
zero-padded to 64-byte blocks) plus the true byte length.

Port of aztec_tpu/stdlib/blake2s_circuit.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

from typing import List

from .uint32 import UInt32

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _g(ctx, v: List[UInt32], a, b, c, d, x: UInt32, y: UInt32):
    v[a] = v[a] + v[b] + x
    v[d] = (v[d] ^ v[a]).ror(16)
    v[c] = v[c] + v[d]
    v[b] = (v[b] ^ v[c]).ror(12)
    v[a] = v[a] + v[b] + y
    v[d] = (v[d] ^ v[a]).ror(8)
    v[c] = v[c] + v[d]
    v[b] = (v[b] ^ v[c]).ror(7)


def _compress(ctx, h: List[UInt32], m: List[UInt32], t: int, last: bool):
    v = list(h) + [UInt32.from_constant(ctx, x) for x in IV]
    v[12] = v[12] ^ UInt32.from_constant(ctx, t & 0xFFFFFFFF)
    v[13] = v[13] ^ UInt32.from_constant(ctx, (t >> 32) & 0xFFFFFFFF)
    if last:
        v[14] = v[14] ^ UInt32.from_constant(ctx, 0xFFFFFFFF)
    for rnd in range(10):
        s = SIGMA[rnd]
        _g(ctx, v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(ctx, v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(ctx, v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(ctx, v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(ctx, v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(ctx, v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(ctx, v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(ctx, v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    for i in range(8):
        h[i] = h[i] ^ v[i] ^ v[i + 8]
    return h


def blake2s_words(ctx, message_words: List[UInt32], byte_length: int) -> List[UInt32]:
    """BLAKE2s-256 of a message given as zero-padded uint32 words
    (16 words per 64-byte block).  Returns 8 output words (little-endian
    digest packing)."""
    assert len(message_words) % 16 == 0 and len(message_words) >= 16
    h = [UInt32.from_constant(ctx, x) for x in IV]
    # parameter block: digest_length=32, fanout=1, depth=1
    h[0] = h[0] ^ UInt32.from_constant(ctx, 0x01010020)

    nblocks = len(message_words) // 16
    for blk in range(nblocks):
        last = blk == nblocks - 1
        t = byte_length if last else (blk + 1) * 64
        h = _compress(ctx, h, message_words[16 * blk : 16 * blk + 16], t, last)
    return h


def blake2s_bytes_to_words(ctx, data: bytes, as_witness=True) -> tuple:
    """Pack a byte string into zero-padded little-endian uint32 words."""
    n = len(data)
    padded = data + b"\x00" * ((-n) % 64 if n % 64 or n == 0 else 0)
    if len(padded) == 0:
        padded = b"\x00" * 64
    words = []
    for i in range(0, len(padded), 4):
        w = int.from_bytes(padded[i : i + 4], "little")
        words.append(
            UInt32.from_witness(ctx, w) if as_witness
            else UInt32.from_constant(ctx, w)
        )
    return words, n


def digest_bytes(words: List[UInt32]) -> bytes:
    return b"".join(w.get_value().to_bytes(4, "little") for w in words)
