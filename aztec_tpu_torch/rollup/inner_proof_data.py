"""Inner-proof public-input ABI (ref: rollup/proofs/inner_proof_data.hpp).

Every tx circuit (join_split, account, escape_hatch) exposes the same 14
public inputs; the rollup circuit consumes them by these indices and
publishes the first NUM_PUBLISHED.

Port of aztec_tpu/rollup/inner_proof_data.py.
"""

from __future__ import annotations

import dataclasses


class InnerProofFields:
    PROOF_ID = 0
    PUBLIC_INPUT = 1
    PUBLIC_OUTPUT = 2
    ASSET_ID = 3
    NEW_NOTE1_X = 4
    NEW_NOTE1_Y = 5
    NEW_NOTE2_X = 6
    NEW_NOTE2_Y = 7
    NULLIFIER1 = 8
    NULLIFIER2 = 9
    INPUT_OWNER = 10
    OUTPUT_OWNER = 11
    MERKLE_ROOT = 12
    TX_FEE = 13

    NUM_FIELDS = 14
    NUM_PUBLISHED = 12


@dataclasses.dataclass
class InnerProofData:
    """Parsed view over the 14x32-byte public-input prefix of a tx proof
    (ref: inner_proof_data.cpp)."""
    proof_id: int
    public_input: int
    public_output: int
    asset_id: int
    new_note1: bytes      # 64 bytes (x || y)
    new_note2: bytes
    nullifier1: int
    nullifier2: int
    input_owner: int
    output_owner: int
    merkle_root: int
    tx_fee: int

    @staticmethod
    def from_proof(proof_data: bytes) -> "InnerProofData":
        def f(i: int) -> int:
            return int.from_bytes(proof_data[i * 32:(i + 1) * 32], "big")

        F = InnerProofFields
        return InnerProofData(
            proof_id=f(F.PROOF_ID),
            public_input=f(F.PUBLIC_INPUT),
            public_output=f(F.PUBLIC_OUTPUT),
            asset_id=f(F.ASSET_ID),
            new_note1=proof_data[F.NEW_NOTE1_X * 32:(F.NEW_NOTE1_Y + 1) * 32],
            new_note2=proof_data[F.NEW_NOTE2_X * 32:(F.NEW_NOTE2_Y + 1) * 32],
            nullifier1=f(F.NULLIFIER1),
            nullifier2=f(F.NULLIFIER2),
            input_owner=f(F.INPUT_OWNER),
            output_owner=f(F.OUTPUT_OWNER),
            merkle_root=f(F.MERKLE_ROOT),
            tx_fee=f(F.TX_FEE),
        )
