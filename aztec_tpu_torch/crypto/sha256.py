"""SHA-256 (ref: crypto/sha256/) — host implementation via hashlib.

The reference carries its own C++ SHA-256 for native hashing and a
circuit version in stdlib/hash/sha256; the native role is fully served by
the platform implementation here.  The in-circuit version arrives with the
stdlib hash phase (stdlib/sha256_circuit.py).

Port of aztec_tpu/crypto/sha256.py.
"""

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
