"""Ignition-format SRS transcript IO (ref: srs/io.cpp:11-68).

Host copy of aztec_tpu/srs/io.py (numpy only).

Format (verified against the reference reader):
- manifest: 7 big-endian uint32 fields (transcript_number, total_transcripts,
  total_g1_points, total_g2_points, num_g1_points, num_g2_points, start_from)
- G1 points: num_g1 * 64 bytes; each coordinate is 4 uint64 words stored
  least-significant-word first, each word big-endian
- G2 points: num_g2 * 128 bytes, same word scheme per Fq2 component
- 64-byte blake2b checksum over manifest||G1||G2.  The reference reader
  only skips it (io.cpp:21-28 uses the length for offsets and never
  validates); here the writer stores a real digest and the reader
  validates any NON-zero stored checksum (all-zero = legacy/dev file,
  accepted for compatibility with files the reference tools produced).
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct

import numpy as np

MANIFEST_STRUCT = struct.Struct(">7I")
CHECKSUM_LEN = 64


@dataclasses.dataclass
class Manifest:
    transcript_number: int
    total_transcripts: int
    total_g1_points: int
    total_g2_points: int
    num_g1_points: int
    num_g2_points: int
    start_from: int


def _words_to_limbs(words: np.ndarray) -> np.ndarray:
    """(n, 4) uint64 LSW-first -> (16, n) uint32 16-bit limb planes."""
    n = words.shape[0]
    out = np.zeros((16, n), np.uint32)
    for w in range(4):
        col = words[:, w]
        for k in range(4):
            out[4 * w + k] = ((col >> np.uint64(16 * k)) & np.uint64(0xFFFF)).astype(
                np.uint32
            )
    return out


def _limbs_to_words(limbs: np.ndarray) -> np.ndarray:
    """(16, n) uint32 planes -> (n, 4) uint64 LSW-first."""
    n = limbs.shape[1]
    words = np.zeros((n, 4), np.uint64)
    for w in range(4):
        for k in range(4):
            words[:, w] |= limbs[4 * w + k].astype(np.uint64) << np.uint64(16 * k)
    return words


def read_transcript(path: str):
    """Returns (manifest, g1_x_limbs, g1_y_limbs, g2_bytes).

    g1 limb planes are canonical (not Montgomery): convert on the device.
    """
    with open(path, "rb") as f:
        data = f.read()
    man = Manifest(*MANIFEST_STRUCT.unpack_from(data, 0))
    off = MANIFEST_STRUCT.size
    n1 = man.num_g1_points
    g1 = np.frombuffer(data, dtype=">u8", count=n1 * 8, offset=off).reshape(n1, 2, 4)
    off += n1 * 64
    n2 = man.num_g2_points
    g2_bytes = data[off : off + n2 * 128]
    stored = data[off + n2 * 128 : off + n2 * 128 + CHECKSUM_LEN]
    if len(stored) == CHECKSUM_LEN and any(stored):
        digest = hashlib.blake2b(
            data[: off + n2 * 128], digest_size=CHECKSUM_LEN).digest()
        if digest != stored:
            raise ValueError(f"SRS transcript checksum mismatch: {path}")
    xs = _words_to_limbs(g1[:, 0, :].astype(np.uint64))
    ys = _words_to_limbs(g1[:, 1, :].astype(np.uint64))
    return man, xs, ys, g2_bytes


def read_g2_points(g2_bytes: bytes):
    """G2 affine points as ((x0, x1), (y0, y1)) canonical int tuples."""
    n = len(g2_bytes) // 128
    raw = np.frombuffer(g2_bytes, dtype=">u8", count=n * 16).reshape(n, 4, 4)
    out = []
    for i in range(n):
        vals = []
        for c in range(4):
            v = 0
            for w in range(3, -1, -1):
                v = (v << 64) | int(raw[i, c, w])
            vals.append(v)
        out.append(((vals[0], vals[1]), (vals[2], vals[3])))
    return out


def write_transcript(path: str, g1_x_limbs, g1_y_limbs, g2_points, *,
                     transcript_number=0, total_transcripts=1, start_from=0):
    """Inverse of read_transcript (used to create local dev/test SRS files)."""
    n1 = g1_x_limbs.shape[1]
    n2 = len(g2_points)
    man = MANIFEST_STRUCT.pack(
        transcript_number, total_transcripts, n1, n2, n1, n2, start_from
    )
    xw = _limbs_to_words(np.asarray(g1_x_limbs))
    yw = _limbs_to_words(np.asarray(g1_y_limbs))
    g1 = np.stack([xw, yw], axis=1).astype(">u8")  # (n, 2, 4) big-endian words
    g2_raw = np.zeros((n2, 4, 4), dtype=">u8")
    for i, ((x0, x1), (y0, y1)) in enumerate(g2_points):
        for c, v in enumerate((x0, x1, y0, y1)):
            for w in range(4):
                g2_raw[i, c, w] = (v >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
    body = man + g1.tobytes() + g2_raw.tobytes()
    digest = hashlib.blake2b(body, digest_size=CHECKSUM_LEN).digest()
    with open(path, "wb") as f:
        f.write(body)
        f.write(digest)
