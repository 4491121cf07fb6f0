"""SHA-256 as a Noir program, in the dialect of noir/parser.py.

``source(blocks)`` is the program: the compression function ``compress``
(the message schedule and the 64 rounds over ``uint32``: ``>>>``
rotations, ``>>`` shifts, ``&``, ``^``, ``~`` and wrapping ``+``, with the
round constants a global array) and a ``main`` that runs it over
``blocks`` 64-byte blocks of its ``uint32`` input, starting from the IV,
and returns the eight digest words.  ``pad(message)`` gives that input:
the message with SHA-256's padding, as big-endian words.

The IV enters as constrained words: the dialect keeps a constant on the
host until it meets a witness, and a host-side state would turn the
rotations into plain shifts, so ``main`` adds each IV word to a zero that
it derives from the first input word (``input[0] - input[0]``, a checked
subtraction).

The program is text: it compiles with either package's ``noir`` onto
either package's ``TurboComposer``; this module imports neither.
"""

from __future__ import annotations

import hashlib

BLOCKS = 16

K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_PROGRAM = """
uint32[64] K = [@K@];
uint32[8] IV = [@IV@];

uint32[8] compress(uint32[8] state, uint32[16] block)
{
    uint32[64] w;
    for (i in 0..16) {
        w[i] = block[i];
    }
    for (i in 16..64) {
        uint32 s0 = (w[i - 15] >>> 7) ^ (w[i - 15] >>> 18) ^ (w[i - 15] >> 3);
        uint32 s1 = (w[i - 2] >>> 17) ^ (w[i - 2] >>> 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32 a = state[0];
    uint32 b = state[1];
    uint32 c = state[2];
    uint32 d = state[3];
    uint32 e = state[4];
    uint32 f = state[5];
    uint32 g = state[6];
    uint32 h = state[7];
    for (i in 0..64) {
        uint32 S1 = (e >>> 6) ^ (e >>> 11) ^ (e >>> 25);
        uint32 ch = (e & f) ^ (~e & g);
        uint32 t1 = h + S1 + ch + K[i] + w[i];
        uint32 S0 = (a >>> 2) ^ (a >>> 13) ^ (a >>> 22);
        uint32 maj = (a & b) ^ (a & c) ^ (b & c);
        uint32 t2 = S0 + maj;
        h = g;
        g = f;
        f = e;
        e = d + t1;
        d = c;
        c = b;
        b = a;
        a = t1 + t2;
    }
    return [state[0] + a, state[1] + b, state[2] + c, state[3] + d,
            state[4] + e, state[5] + f, state[6] + g, state[7] + h];
}

uint32[8] main(uint32[@WORDS@] input)
{
    uint32 zero = input[0] - input[0];
    uint32[8] state;
    for (i in 0..8) {
        state[i] = zero + IV[i];
    }
    for (blk in 0..@BLOCKS@) {
        uint32[16] block;
        for (i in 0..16) {
            block[i] = input[16 * blk + i];
        }
        state = compress(state, block);
    }
    return state;
}
"""


def source(blocks: int = BLOCKS) -> str:
    """The program over ``blocks`` blocks (``16 * blocks`` input words)."""
    def words(xs):
        return ", ".join(f"0x{x:08x}" for x in xs)

    return (_PROGRAM.replace("@K@", words(K)).replace("@IV@", words(IV))
            .replace("@WORDS@", str(16 * blocks))
            .replace("@BLOCKS@", str(blocks)))


def pad(message: bytes) -> list:
    """SHA-256's padding of ``message`` as big-endian 32-bit words (16 a
    block)."""
    padded = message + b"\x80"
    padded += b"\x00" * ((56 - len(padded)) % 64)
    padded += (8 * len(message)).to_bytes(8, "big")
    return [int.from_bytes(padded[i:i + 4], "big")
            for i in range(0, len(padded), 4)]


def blocks_of(message: bytes) -> int:
    """The number of blocks ``pad(message)`` fills."""
    return (len(message) + 9 + 63) // 64


def digest_words(message: bytes) -> list:
    """hashlib's digest of ``message`` as eight big-endian words."""
    d = hashlib.sha256(message).digest()
    return [int.from_bytes(d[i:i + 4], "big") for i in range(0, 32, 4)]
