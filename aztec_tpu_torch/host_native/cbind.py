"""ctypes bindings for the flat C ABI (``src/c_bind.cpp``).

Port of aztec_tpu/native/cbind.py, the counterpart of the reference's
c_bind surface (crypto/pedersen/c_bind.cpp, crypto/blake2s/c_bind.cpp,
crypto/schnorr/c_bind.cpp): native host crypto behind byte-buffer entry
points.  Field elements are 32-byte big-endian; points x||y (64 bytes);
infinity is all-zero.  Proving maps to the serving worker protocol
(``serving/proof_worker.py``) instead.
"""

from __future__ import annotations

import ctypes
import functools
import secrets
from typing import List, Optional, Tuple

from .build import build

_P = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
_Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The C ABI library, built on first use (raises without g++)."""
    lib = ctypes.CDLL(str(build("aztec_cbind")))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    size_t = ctypes.c_size_t
    u32 = ctypes.c_uint32
    sigs = {
        "pedersen__compress_fields": [u8p, u8p, u8p],
        "pedersen__compress": [u8p, u32, u32, u8p],
        "pedersen__commit": [u8p, u32, u32, u8p],
        "pedersen__buffer_to_field": [u8p, size_t, u8p],
        "pedersen__fixed_base_scalar_mul": [u8p, u32, u32, u8p],
        "pedersen__get_generator": [u32, u8p],
        "blake2s__hash": [u8p, size_t, u8p],
        "blake2s_to_field": [u8p, size_t, u8p],
        "keccak256__hash": [u8p, size_t, u8p],
        "schnorr__compute_public_key": [u8p, u8p],
        "schnorr__construct_signature": [u8p, size_t, u8p, u8p, u8p, u8p],
        "schnorr__verify_signature": [u8p, size_t, u8p, u8p, u8p],
    }
    for fn, argtypes in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = (ctypes.c_int if fn == "schnorr__verify_signature"
                     else None)
    return lib


def _buf(data: bytes):
    return ((ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data
            else ctypes.cast(0, ctypes.POINTER(ctypes.c_uint8)))


def _out(n: int):
    return (ctypes.c_uint8 * n)()


def _field(v: int) -> bytes:
    return (v % _P).to_bytes(32, "big")


def _point_to_tuple(raw: bytes) -> Optional[Tuple[int, int]]:
    x = int.from_bytes(raw[:32], "big")
    y = int.from_bytes(raw[32:], "big")
    return None if x == 0 and y == 0 else (x, y)


# ------------------------------ pedersen -------------------------------------

def compress_fields(left: int, right: int) -> int:
    out = _out(32)
    load().pedersen__compress_fields(_buf(_field(left)), _buf(_field(right)),
                                     out)
    return int.from_bytes(bytes(out), "big")


def compress_many(inputs: List[int], hash_index: int = 0) -> int:
    data = b"".join(_field(v) for v in inputs)
    out = _out(32)
    load().pedersen__compress(_buf(data), len(inputs), hash_index, out)
    return int.from_bytes(bytes(out), "big")


def commit(inputs: List[int], hash_index: int = 0):
    data = b"".join(_field(v) for v in inputs)
    out = _out(64)
    load().pedersen__commit(_buf(data), len(inputs), hash_index, out)
    return _point_to_tuple(bytes(out)) or (0, 0)


def buffer_to_field(data: bytes) -> int:
    out = _out(32)
    load().pedersen__buffer_to_field(_buf(data), len(data), out)
    return int.from_bytes(bytes(out), "big")


def fixed_base_scalar_mul(value: int, num_bits: int = 254,
                          generator_index: int = 0):
    out = _out(64)
    load().pedersen__fixed_base_scalar_mul(_buf(_field(value)),
                                           generator_index, num_bits, out)
    return _point_to_tuple(bytes(out))


def get_generator(index: int) -> Tuple[int, int]:
    out = _out(64)
    load().pedersen__get_generator(index, out)
    return _point_to_tuple(bytes(out))


# ------------------------------ hashes ---------------------------------------

def blake2s(data: bytes) -> bytes:
    out = _out(32)
    load().blake2s__hash(_buf(data), len(data), out)
    return bytes(out)


def blake2s_to_field(data: bytes) -> int:
    out = _out(32)
    load().blake2s_to_field(_buf(data), len(data), out)
    return int.from_bytes(bytes(out), "big")


def keccak256(data: bytes) -> bytes:
    out = _out(32)
    load().keccak256__hash(_buf(data), len(data), out)
    return bytes(out)


# ------------------------------ schnorr --------------------------------------

def compute_public_key(private_key: int) -> Tuple[int, int]:
    out = _out(64)
    load().schnorr__compute_public_key(_buf(private_key.to_bytes(32, "big")),
                                       out)
    return _point_to_tuple(bytes(out))


def construct_signature(message: bytes, private_key: int,
                        k: int | None = None) -> Tuple[bytes, bytes]:
    if k is None:
        k = secrets.randbelow(_Q - 1) + 1
    s = _out(32)
    e = _out(32)
    load().schnorr__construct_signature(
        _buf(message), len(message), _buf(private_key.to_bytes(32, "big")),
        _buf(k.to_bytes(32, "big")), s, e)
    return bytes(s), bytes(e)


def verify_signature(message: bytes, public_key: Tuple[int, int],
                     sig: Tuple[bytes, bytes]) -> bool:
    pub = public_key[0].to_bytes(32, "big") + public_key[1].to_bytes(32, "big")
    return bool(load().schnorr__verify_signature(
        _buf(message), len(message), _buf(pub), _buf(sig[0]), _buf(sig[1])))
