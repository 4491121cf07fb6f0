"""On-chain verifier source emission (ref: blockchain/contracts/verifier/).

write_verifier_sources(outdir, vk, name) lays out a deployable source tree:

    <outdir>/cryptography/Types.sol
    <outdir>/cryptography/Bn254Crypto.sol
    <outdir>/cryptography/TurboVerifier.sol
    <outdir>/keys/<Name>Vk.sol          (plonk/sol_gen.py, reference format)
    <outdir>/<Name>Verifier.sol         (VK-bound concrete contract)

The static sources live in contracts/sol/ beside this module (byte for
byte aztec_tpu/contracts/sol/'s).  solidity_challenges
is a line-for-line Python port of TurboVerifier.compute_challenges /
finalize_challenges, used by tests to pin the contract's Fiat-Shamir
against the real Transcript implementation (no solc is assumed).

Port of aztec_tpu/contracts/sol_verifier.py: the emitted files are
aztec_tpu's, byte for byte, the generator's name in the concrete
contract's header included.
"""

from __future__ import annotations

import os
from typing import Dict, List

from ..crypto.keccak import keccak256
from ..ff.bn254 import FR_MOD
from ..plonk.proving_key import VerificationKey
from ..plonk.sol_gen import output_vk_sol

_SOL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sol")

M = FR_MOD


def _concrete_verifier(name: str) -> str:
    return f"""// SPDX-License-Identifier: GPL-2.0-only
// Generated by aztec_tpu.contracts.sol_verifier — {name} circuit verifier.

pragma solidity >=0.6.0 <0.8.0;
pragma experimental ABIEncoderV2;

import {{Types}} from './cryptography/Types.sol';
import {{TurboVerifier}} from './cryptography/TurboVerifier.sol';
import {{{name}Vk}} from './keys/{name}Vk.sol';

contract {name}Verifier is TurboVerifier {{
    function get_verification_key()
        internal pure override returns (Types.VerificationKey memory)
    {{
        return {name}Vk.get_verification_key();
    }}
}}
"""


def write_verifier_sources(outdir: str, vk: VerificationKey,
                           name: str) -> List[str]:
    """Emit the full verifier source tree; returns written paths."""
    crypto_dir = os.path.join(outdir, "cryptography")
    keys_dir = os.path.join(outdir, "keys")
    os.makedirs(crypto_dir, exist_ok=True)
    os.makedirs(keys_dir, exist_ok=True)
    written = []
    for fname in ("Types.sol", "Bn254Crypto.sol", "TurboVerifier.sol"):
        src = open(os.path.join(_SOL_DIR, fname)).read()
        dst = os.path.join(crypto_dir, fname)
        with open(dst, "w") as f:
            f.write(src)
        written.append(dst)
    dst = os.path.join(keys_dir, f"{name}Vk.sol")
    with open(dst, "w") as f:
        f.write(output_vk_sol(vk, f"{name}Vk"))
    written.append(dst)
    dst = os.path.join(outdir, f"{name}Verifier.sol")
    with open(dst, "w") as f:
        f.write(_concrete_verifier(name))
    written.append(dst)
    return written


# ---- Python port of the contract's Fiat-Shamir (test oracle) ---------------


def solidity_challenges(circuit_size: int, pub_bytes: bytes,
                        g1s: Dict[str, bytes], t_eval: int,
                        evals: List[int]) -> Dict[str, int]:
    """Exactly the word/byte sequence TurboVerifier.sol hashes.

    g1s: 64-byte y||x encodings for W_1..W_4, Z, T_1..T_4, PI_Z,
    PI_Z_OMEGA; evals: the 16 round-5 evaluations in manifest order
    (w_1..w_4, sigma_1..3, q_arith, q_ecc_1, q_c, r, z_omega,
    w_1_omega..w_4_omega)."""
    num_pub = len(pub_bytes) // 32
    init = keccak256(circuit_size.to_bytes(4, "big")
                     + num_pub.to_bytes(4, "big"))
    base = keccak256(init + pub_bytes + g1s["W_1"] + g1s["W_2"]
                     + g1s["W_3"] + g1s["W_4"])
    out = {"beta": int.from_bytes(base, "big") % M}
    gamma_h = keccak256(base + bytes([1]))
    out["gamma"] = int.from_bytes(gamma_h, "big") % M
    alpha_h = keccak256(gamma_h + g1s["Z"])
    out["alpha"] = int.from_bytes(alpha_h, "big") % M
    zeta_h = keccak256(alpha_h + g1s["T_1"] + g1s["T_2"] + g1s["T_3"]
                       + g1s["T_4"])
    out["zeta"] = int.from_bytes(zeta_h, "big") % M

    buf = zeta_h + t_eval.to_bytes(32, "big")
    for v in evals:
        buf += v.to_bytes(32, "big")  # raw words, as the contract hashes
    nu_base = keccak256(buf)
    nus = [int.from_bytes(nu_base, "big") % M]
    last = nu_base
    for i in range(1, 11):
        last = keccak256(nu_base + bytes([i]))
        nus.append(int.from_bytes(last, "big") % M)
    out["nu"] = nus
    sep = keccak256(last + g1s["PI_Z"] + g1s["PI_Z_OMEGA"])
    out["separator"] = int.from_bytes(sep, "big") % M
    return out
