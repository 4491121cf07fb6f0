// SPDX-License-Identifier: GPL-2.0-only
// Types for the on-chain TurboPlonk verifier.
//
// Field order of VerificationKey matches the memory offsets the generated
// VK libraries poke via assembly (aztec_tpu/plonk/sol_gen.py, mirroring
// the reference's sol_gen.hpp): 0x00 circuit_size .. 0x2c0 g2_x.

pragma solidity >=0.6.0 <0.8.0;
pragma experimental ABIEncoderV2;

library Types {
    struct G1Point {
        uint256 x;
        uint256 y;
    }

    // G2 coordinates are Fq2 elements (c1, c0 word order as the pairing
    // precompile expects them)
    struct G2Point {
        uint256 x1;
        uint256 x0;
        uint256 y1;
        uint256 y0;
    }

    struct VerificationKey {
        uint256 circuit_size;                       // 0x00
        uint256 num_inputs;                         // 0x20
        uint256 work_root;                          // 0x40
        uint256 domain_inverse;                     // 0x60
        uint256 work_root_inverse;                  // 0x80
        G1Point Q1;                                 // 0xa0
        G1Point Q2;                                 // 0xc0
        G1Point Q3;                                 // 0xe0
        G1Point Q4;                                 // 0x100
        G1Point Q5;                                 // 0x120
        G1Point QM;                                 // 0x140
        G1Point QC;                                 // 0x160
        G1Point QARITH;                             // 0x180
        G1Point QECC;                               // 0x1a0
        G1Point QRANGE;                             // 0x1c0
        G1Point QLOGIC;                             // 0x1e0
        G1Point SIGMA1;                             // 0x200
        G1Point SIGMA2;                             // 0x220
        G1Point SIGMA3;                             // 0x240
        G1Point SIGMA4;                             // 0x260
        uint256 contains_recursive_proof;           // 0x280
        uint256 recursive_proof_indices;            // 0x2a0
        G2Point g2_x;                               // 0x2c0
    }

    struct Proof {
        G1Point W1;
        G1Point W2;
        G1Point W3;
        G1Point W4;
        G1Point Z;
        G1Point T1;
        G1Point T2;
        G1Point T3;
        G1Point T4;
        G1Point PI_Z;
        G1Point PI_Z_OMEGA;
        uint256 w1;
        uint256 w2;
        uint256 w3;
        uint256 w4;
        uint256 sigma1;
        uint256 sigma2;
        uint256 sigma3;
        uint256 q_arith;
        uint256 q_ecc;
        uint256 q_c;
        uint256 r_eval;
        uint256 z_omega;
        uint256 w1_omega;
        uint256 w2_omega;
        uint256 w3_omega;
        uint256 w4_omega;
    }

    struct Challenges {
        uint256 alpha;
        uint256 beta;
        uint256 gamma;
        uint256 zeta;
        uint256 separator;
        uint256[11] nu;
    }
}
