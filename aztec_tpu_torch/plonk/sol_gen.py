"""Solidity verification-key library generator.

Byte-for-byte mirror of the reference's output_vk_sol
(plonk/proof_system/verification_key/sol_gen.hpp:8-76; consumed by the
keygen CLI, rollup/keygen/main.cpp:16-40, and checked into
blockchain/contracts/verifier/keys/).  Field elements print as 0x-prefixed
64-hex-digit canonical values — the reference streams fr/fq through
operator<< after from_montgomery_form.

Port of aztec_tpu/plonk/sol_gen.py, host Python: the same inputs give the
same values.
"""

from __future__ import annotations

from ..ff.bn254 import FR_MOD
from .proving_key import VerificationKey


def _u256(v: int) -> str:
    return f"0x{v:064x}"


def output_vk_sol(key: VerificationKey, class_name: str) -> str:
    n = key.n
    root = key.domain_root
    domain_inverse = pow(n, -1, FR_MOD)
    root_inverse = pow(root, -1, FR_MOD)

    lines = []
    out = lines.append

    def print_u256(name: str, element: int, postlabel: str):
        out(f"            {name}{_u256(element)}{postlabel}")

    def print_g1(offset: str, label: str, postlabel: str):
        el = key.commitments[label]
        x, y = el if el is not None else (0, 0)
        out(f"            mstore(mload(add(vk, {offset})), {_u256(x)})"
            f"{postlabel}")
        out(f"            mstore(add(mload(add(vk, {offset})), 0x20), "
            f"{_u256(y)})")

    out("// SPDX-License-Identifier: GPL-2.0-only")
    out("// Copyright 2020 Spilsbury Holdings Ltd")
    out("")
    out("pragma solidity >=0.6.0 <0.8.0;")
    out("pragma experimental ABIEncoderV2;")
    out("")
    out("import {Types} from '../cryptography/Types.sol';")
    out("import {Bn254Crypto} from '../cryptography/Bn254Crypto.sol';")
    out("")
    out(f"library {class_name} {{")
    out("    using Bn254Crypto for Types.G1Point;")
    out("    using Bn254Crypto for Types.G2Point;")
    out("")
    out("    function get_verification_key() internal pure returns "
        "(Types.VerificationKey memory) {")
    out("        Types.VerificationKey memory vk;")
    out("")
    out("        assembly {")
    out(f"            mstore(add(vk, 0x00), {n}) // vk.circuit_size")
    out(f"            mstore(add(vk, 0x20), {key.num_public_inputs})"
        " // vk.num_inputs")
    print_u256("mstore(add(vk, 0x40),", root, ") // vk.work_root")
    print_u256("mstore(add(vk, 0x60),", domain_inverse,
               ") // vk.domain_inverse")
    print_u256("mstore(add(vk, 0x80),", root_inverse,
               ") // vk.work_root_inverse")
    print_g1("0xa0", "Q_1", "//vk.Q1")
    print_g1("0xc0", "Q_2", "//vk.Q2")
    print_g1("0xe0", "Q_3", "//vk.Q3")
    print_g1("0x100", "Q_4", "//vk.Q4")
    print_g1("0x120", "Q_5", "//vk.Q5")
    print_g1("0x140", "Q_M", "//vk.QM")
    print_g1("0x160", "Q_C", "//vk.QC")
    print_g1("0x180", "Q_ARITHMETIC_SELECTOR", "//vk.QARITH")
    print_g1("0x1a0", "Q_FIXED_BASE_SELECTOR", "//vk.QECC")
    print_g1("0x1c0", "Q_RANGE_SELECTOR", "//vk.QRANGE")
    print_g1("0x1e0", "Q_LOGIC_SELECTOR", "//vk.QLOGIC")
    print_g1("0x200", "SIGMA_1", "//vk.SIGMA1")
    print_g1("0x220", "SIGMA_2", "//vk.SIGMA2")
    print_g1("0x240", "SIGMA_3", "//vk.SIGMA3")
    print_g1("0x260", "SIGMA_4", "//vk.SIGMA4")
    rec = key.contains_recursive_proof
    idx0 = (key.recursive_proof_public_input_indices[0]
            if rec and key.recursive_proof_public_input_indices else 0)
    out(f"            mstore(add(vk, 0x280), {'0x01' if rec else '0x00'})"
        " // vk.contains_recursive_proof")
    out(f"            mstore(add(vk, 0x2a0), {idx0})"
        " // vk.recursive_proof_public_input_indices")
    (g2x_x, g2x_y) = key.g2_x
    out(f"            mstore(mload(add(vk, 0x2c0)), {_u256(g2x_x[1])})"
        " // vk.g2_x.X.c1")
    out(f"            mstore(add(mload(add(vk, 0x2c0)), 0x20), "
        f"{_u256(g2x_x[0])}) // vk.g2_x.X.c0")
    out(f"            mstore(add(mload(add(vk, 0x2c0)), 0x40), "
        f"{_u256(g2x_y[1])}) // vk.g2_x.Y.c1")
    out(f"            mstore(add(mload(add(vk, 0x2c0)), 0x60), "
        f"{_u256(g2x_y[0])}) // vk.g2_x.Y.c0")
    out("        }")
    out("        return vk;")
    out("    }")
    out("}")
    return "\n".join(lines) + "\n"
