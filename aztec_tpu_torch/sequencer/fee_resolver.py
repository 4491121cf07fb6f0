"""Tx fee policy (ref: falafel/src/tx_fee_resolver/index.ts).

The reference computes a base fee per tx type plus a fee-surplus ratio that
moves the publish deadline: a tx paying `feeConstant * (1 + s)` shrinks the
wait by ratio s of the publish interval.  Same policy here over the tx_fee
public input (InnerProofFields.TX_FEE).

Port of aztec_tpu/sequencer/fee_resolver.py.
"""

from __future__ import annotations

from typing import Iterable

from ..rollup.inner_proof_data import InnerProofData


class TxFeeResolver:
    def __init__(self, base_fee: int = 10, fee_limit: int | None = None):
        self.base_fee = base_fee
        self.fee_limit = fee_limit

    def get_min_fee(self, proof_id: int) -> int:
        # account txs (proof_id 1) are free in the reference's default config
        return 0 if proof_id == 1 else self.base_fee

    def validate(self, data: InnerProofData) -> bool:
        return data.tx_fee >= self.get_min_fee(data.proof_id)

    def compute_surplus_ratio(self, txs: Iterable[InnerProofData]) -> float:
        """ratio in [0, 1]: 0 = publish now, 1 = wait the full interval
        (ref: tx_fee_resolver computeSurplusRatio)."""
        surplus = 0
        for d in txs:
            surplus += max(d.tx_fee - self.get_min_fee(d.proof_id), 0)
        if self.base_fee <= 0:
            return 1.0
        return min(max(1.0 - surplus / self.base_fee, 0.0), 1.0)
