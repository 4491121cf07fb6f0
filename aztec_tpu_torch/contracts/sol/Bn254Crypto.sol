// SPDX-License-Identifier: GPL-2.0-only
// BN254 curve + field helpers over the EVM precompiles
// (role of the reference's Bn254Crypto.sol; written against
// aztec_tpu/curves + plonk/verifier.py semantics).

pragma solidity >=0.6.0 <0.8.0;
pragma experimental ABIEncoderV2;

import {Types} from "./Types.sol";

library Bn254Crypto {
    uint256 constant p_mod =
        0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47;
    uint256 constant r_mod =
        0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001;

    function pow_small(uint256 base, uint256 exponent, uint256 modulus)
        internal view returns (uint256 result)
    {
        // modexp precompile (0x05)
        uint256[6] memory input;
        input[0] = 0x20;
        input[1] = 0x20;
        input[2] = 0x20;
        input[3] = base;
        input[4] = exponent;
        input[5] = modulus;
        uint256[1] memory output;
        bool ok;
        assembly {
            ok := staticcall(gas(), 0x05, input, 0xc0, output, 0x20)
        }
        require(ok, "modexp failed");
        return output[0];
    }

    function invert(uint256 v) internal view returns (uint256) {
        return pow_small(v, r_mod - 2, r_mod);
    }

    function ecMul(Types.G1Point memory pt, uint256 s)
        internal view returns (Types.G1Point memory out)
    {
        uint256[3] memory input;
        input[0] = pt.x;
        input[1] = pt.y;
        input[2] = s;
        uint256[2] memory output;
        bool ok;
        assembly {
            ok := staticcall(gas(), 0x07, input, 0x60, output, 0x40)
        }
        require(ok, "ecMul failed");
        out.x = output[0];
        out.y = output[1];
    }

    function ecAdd(Types.G1Point memory a, Types.G1Point memory b)
        internal view returns (Types.G1Point memory out)
    {
        uint256[4] memory input;
        input[0] = a.x;
        input[1] = a.y;
        input[2] = b.x;
        input[3] = b.y;
        uint256[2] memory output;
        bool ok;
        assembly {
            ok := staticcall(gas(), 0x06, input, 0x80, output, 0x40)
        }
        require(ok, "ecAdd failed");
        out.x = output[0];
        out.y = output[1];
    }

    function negate(Types.G1Point memory pt)
        internal pure returns (Types.G1Point memory)
    {
        if (pt.x == 0 && pt.y == 0) {
            return pt;
        }
        return Types.G1Point(pt.x, p_mod - (pt.y % p_mod));
    }

    function validateG1Point(Types.G1Point memory pt) internal pure {
        require(pt.x < p_mod && pt.y < p_mod,
                "point coordinate >= field modulus");
        // y^2 == x^3 + 3
        uint256 lhs = mulmod(pt.y, pt.y, p_mod);
        uint256 rhs = addmod(
            mulmod(mulmod(pt.x, pt.x, p_mod), pt.x, p_mod), 3, p_mod);
        require(lhs == rhs, "point not on curve");
    }

    // e(P0, [1]_2) * e(P1, g2_x) == 1
    function pairingCheck(
        Types.G1Point memory p0,
        Types.G1Point memory p1,
        Types.G2Point memory g2x
    ) internal view returns (bool) {
        // generator of G2 ([1]_2), c1||c0 word order per precompile spec
        uint256[12] memory input;
        input[0] = p0.x;
        input[1] = p0.y;
        input[2] = 0x198e9393920d483a7260bfb731fb5d25f1aa493335a9e71297e485b7aef312c2;
        input[3] = 0x1800deef121f1e76426a00665e5c4479674322d4f75edadd46debd5cd992f6ed;
        input[4] = 0x090689d0585ff075ec9e99ad690c3395bc4b313370b38ef355acdadcd122975b;
        input[5] = 0x12c85ea5db8c6deb4aab71808dcb408fe3d1e7690c43d37b4ce6cc0166fa7daa;
        input[6] = p1.x;
        input[7] = p1.y;
        input[8] = g2x.x1;
        input[9] = g2x.x0;
        input[10] = g2x.y1;
        input[11] = g2x.y0;
        uint256[1] memory output;
        bool ok;
        assembly {
            ok := staticcall(gas(), 0x08, input, 0x180, output, 0x20)
        }
        require(ok, "pairing precompile failed");
        return output[0] == 1;
    }
}
