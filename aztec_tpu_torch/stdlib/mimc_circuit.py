"""MiMC7 hash, native + in-circuit (ref: stdlib/hash/mimc/mimc.cpp).

Port of aztec_tpu/stdlib/mimc_circuit.py, carried over as it is.

MiMC block cipher with the x^7 permutation, 91 rounds, Miyaguchi-Preneel
compression.  Round constants are the iterated keccak256 chain of the
reference's 32-zero-byte seed (mimc.cpp:26-47: the seed bytes come out
zero there, reproduced exactly so hashes agree with the reference).

Two circuit lowerings, as in the reference:
- `mimc_block_cipher_mimc(composer, ...)` on MiMCComposer, 1 custom gate
  per round (91 gates per cipher call),
- `mimc_block_cipher_standard(...)` on any width-3 composer, 4 mul gates
  per round via field_t.
"""

from __future__ import annotations

from typing import List

from ..crypto.keccak import keccak256
from ..ff.bn254 import FR_MOD
from .field_t import FieldT

M = FR_MOD
NUM_MIMC_ROUNDS = 91


def _round_constants() -> List[int]:
    buf = bytes(32)
    out = []
    for _ in range(NUM_MIMC_ROUNDS):
        buf = keccak256(buf)
        # the reference builds fr{word64s[0..3]} from the digest's little-
        # endian u64 words, i.e. interprets the digest as little-endian
        out.append(int.from_bytes(buf, "little") % M)
    return out


MIMC_ROUND_CONSTANTS = _round_constants()


# ---- native ----------------------------------------------------------------

def mimc_block_cipher_native(message: int, key: int) -> int:
    x = message
    for c in MIMC_ROUND_CONSTANTS:
        t = (x + key + c) % M
        x = pow(t, 7, M)
    return x


def mimc7_native(inputs: List[int]) -> int:
    key = 0
    for m in inputs:
        x = mimc_block_cipher_native(m, key)
        key = (key + x + m) % M
    return key


# ---- circuit: MiMCComposer custom gate ------------------------------------

def mimc_block_cipher_mimc(ctx, message: FieldT, key: FieldT) -> FieldT:
    """One mimc gate per round (mimc.cpp:49-96)."""
    message = message.normalize()
    key = key.normalize()
    x_in = message.get_value()
    k = key.get_value()
    k_idx = key.witness_index
    x_in_idx = message.witness_index
    x_out = x_in
    x_out_idx = x_in_idx
    for c in MIMC_ROUND_CONSTANTS:
        t0 = (x_in + k + c) % M
        x_cubed = t0 * t0 % M * t0 % M
        x_out = x_cubed * x_cubed % M * t0 % M
        x_cubed_idx = ctx.add_variable(x_cubed)
        x_out_idx = ctx.add_variable(x_out)
        ctx.create_mimc_gate(x_in_idx, x_cubed_idx, k_idx, x_out_idx, c)
        x_in_idx = x_out_idx
        x_in = x_out
    return FieldT(ctx, x_out_idx, 0, 1)


# ---- circuit: standard mul gates ------------------------------------------

def mimc_block_cipher_standard(message: FieldT, key: FieldT) -> FieldT:
    """x^7 via 4 muls per round (mimc.cpp:98-115)."""
    x_in = message
    x_out = message
    for c in MIMC_ROUND_CONSTANTS:
        x_out = x_in + key + c
        x_sq = x_out * x_out
        x_4 = x_sq * x_sq
        x_out = x_4 * x_sq * x_out
        x_in = x_out
    return x_out


def mimc7(ctx, inputs: List[FieldT], use_mimc_gates: bool = True) -> FieldT:
    """Miyaguchi-Preneel over the block cipher (mimc.cpp:117-136)."""
    if not inputs:
        return FieldT.constant(0)
    key = FieldT.from_witness(ctx, 0)
    for message in inputs:
        if use_mimc_gates:
            x_out = mimc_block_cipher_mimc(ctx, message, key)
        else:
            x_out = mimc_block_cipher_standard(message, key)
        key = (key + x_out + message).normalize()
    return key
