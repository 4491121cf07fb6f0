"""On-chain layer (ref: blockchain/contracts).

The reference's Solidity contracts — RollupProcessor.sol (escrow + state +
proof dispatch) and TurboVerifier.sol (on-chain PLONK verifier) — re-built
as executable Python components with the same semantics:

- rollup_processor.RollupProcessor: deposits/withdrawals, rollup state,
  decoder, escape-hatch windows; verification delegated to the caller's
  ``verify_proof`` (the TurboVerifier role).  Implements the sequencer's
  Blockchain protocol, closing the falafel -> RollupProcessor loop.
- evm_verifier.generate_verifier: EVM bytecode verifying proofs for one
  VK (keccak linearised flavors), run in the interpreter of evm/.
- sol_verifier.write_verifier_sources: emits the TurboVerifier .sol source
  tree (plus the VK library from plonk/sol_gen.py) for on-EVM deployment;
  no Solidity toolchain is assumed, so the emitted source is checked
  structurally, and solidity_challenges pins its Fiat-Shamir against the
  transcript.

Port of aztec_tpu/contracts/.
"""

from .rollup_processor import (  # noqa: F401
    RollupProcessor, RollupProcessorError,
    RollupProofData)
