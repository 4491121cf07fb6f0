"""Minimal EVM execution environment for the on-chain verifier.

The framework assumes no solc and no EVM client, so it ships its
own pair:

- interpreter.py — a self-contained EVM bytecode interpreter covering the
  opcode subset + BN254 precompiles (0x05-0x08) a PLONK verifier needs,
  with per-opcode gas metering;
- asm.py — a tiny assembler (labels, auto-sized PUSH) used by the
  verifier code generator;
- the generator itself lives in contracts/evm_verifier.py: it emits
  straight-line EVM bytecode for a circuit's verification key, the
  executable counterpart of the TurboVerifier.sol text emitted by
  plonk/sol_gen.py (ref: blockchain/contracts/verifier/TurboVerifier.sol).

Port of aztec_tpu/evm/: host Python, the precompiles over the port's own
pairing (curves/pairing.py) and Keccak (crypto/keccak.py).
"""

from .interpreter import EVM, EvmRevert  # noqa: F401
from .asm import Assembler  # noqa: F401
