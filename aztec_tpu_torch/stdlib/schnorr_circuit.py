"""In-circuit Schnorr signature verification over Grumpkin
(ref: stdlib/encryption/schnorr — the join_split spending-key check).

Matches crypto/schnorr.py's native scheme: sig = (s, e) 32-byte buffers;
accept iff blake2s(R.x || message) == e where R = s*G + e*pub.  All group
math is native-field Grumpkin (group_native.py); the hash is the blake2s
circuit, with the R.x bytes produced by the canonical field_to_bytes
decomposition (unique byte string per field element).

Port of aztec_tpu/stdlib/schnorr_circuit.py, on the port's composers: host
Python, so the same inputs record the same gates.
"""

from __future__ import annotations

from typing import List, Tuple

from .field_t import FieldT
from .byte_array import field_to_bytes
from .recursion_transcript import _blake2s_bytes
from .group_native import (
    NativePoint,
    batch_mul_native,
    bits_from_bytes_be,
)
from ..crypto.pedersen import GRUMPKIN_GEN


def _witness_bytes(ctx, raw: bytes) -> List[FieldT]:
    out = []
    for b in raw:
        f = FieldT.from_witness(ctx, b)
        ctx.create_range_constraint(f.witness_index, 8)
        out.append(f)
    return out


def verify_signature(ctx, message: bytes, public_key: Tuple[int, int],
                     sig: Tuple[bytes, bytes],
                     pub_witness: NativePoint | None = None) -> None:
    """Constrain that (s, e) is a valid Schnorr signature on message under
    public_key.  message enters as byte witnesses; the public key as an
    on-curve witness point (or pass a pre-built pub_witness)."""
    pub = pub_witness or NativePoint.from_witness(ctx, public_key)
    verify_signature_fields(ctx, _witness_bytes(ctx, message), pub, sig)


def verify_signature_fields(ctx, msg_fs: List[FieldT], pub: NativePoint,
                            sig: Tuple[bytes, bytes]) -> None:
    """Same, but the message is already a list of in-circuit bytes (the
    join_split path: message = pedersen-compressed tx fields,
    ref: join_split/verify_signature.hpp)."""
    s_bytes, e_bytes = sig

    s_fs = _witness_bytes(ctx, s_bytes)
    e_fs = _witness_bytes(ctx, e_bytes)

    s_bits = bits_from_bytes_be(ctx, s_fs)
    e_bits = bits_from_bytes_be(ctx, e_fs)

    G = NativePoint.from_constant(GRUMPKIN_GEN)
    R = batch_mul_native(ctx, [G, pub], [s_bits, e_bits])

    rx_bytes = field_to_bytes(R.x, 32)
    digest = _blake2s_bytes(ctx, rx_bytes + msg_fs)
    assert len(digest) == 32
    for d, e in zip(digest, e_fs):
        d.assert_equal(e, "schnorr: e mismatch")
