"""Tx intake (ref: falafel/src/tx_receiver.ts).

Validates an incoming tx proof before admitting it to the pool: proof
verification against the registered circuit VK (the reference loads
join_split/account VKs from halloumi and verifies in-process), fee policy,
double-spend checks against both the chain state and the pending pool.
Serialized with a lock exactly like the reference's mutexed receiveTx.

Port of aztec_tpu/sequencer/tx_receiver.py: the same rejections, in the
same words.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..rollup.inner_proof_data import InnerProofData
from .fee_resolver import TxFeeResolver
from .metrics import Metrics
from .rollup_db import RollupDb, TxDao, tx_id


class VerificationError(Exception):
    pass


class TxReceiver:
    def __init__(self, rollup_db: RollupDb, fee_resolver: TxFeeResolver,
                 metrics: Metrics,
                 verify_proof: Optional[Callable[[bytes], bool]] = None,
                 known_data_roots: Optional[Callable[[int], bool]] = None):
        """verify_proof: bytes -> bool (plug the unrolled-turbo verifier
        for join_split/account VKs; tests may inject a stub).
        known_data_roots: merkle_root -> bool (world-state recency check,
        tx_receiver.ts validateTx's data-root check)."""
        self.db = rollup_db
        self.fees = fee_resolver
        self.metrics = metrics
        self.verify_proof = verify_proof or (lambda proof: True)
        self.known_data_roots = known_data_roots or (lambda root: True)
        self._mutex = threading.Lock()

    def receive_tx(self, proof_data: bytes,
                   viewing_keys: bytes = b"") -> bytes:
        """Validate and enqueue one tx; returns its txId.

        Raises VerificationError on any admission failure (the HTTP layer
        maps this to a 400, matching falafel's app.ts error responses)."""
        with self._mutex:
            data = InnerProofData.from_proof(proof_data)
            self.metrics.tx_received.inc(type=str(data.proof_id))

            if not self.fees.validate(data):
                raise VerificationError("insufficient fee")
            if not self.known_data_roots(data.merkle_root):
                raise VerificationError("unknown data root")

            txid = tx_id(proof_data)
            if self.db.get_tx(txid):
                raise VerificationError("duplicate tx")

            n1 = data.nullifier1.to_bytes(32, "big")
            n2 = data.nullifier2.to_bytes(32, "big")
            if data.nullifier1 == data.nullifier2:
                raise VerificationError("duplicate nullifier in tx")
            if self.db.nullifiers_exist(n1, n2):
                raise VerificationError("nullifier already used")

            if not self.verify_proof(proof_data):
                raise VerificationError("proof verification failed")
            self.db.add_tx(TxDao(
                id=txid, proof_data=proof_data, nullifier1=n1, nullifier2=n2,
                created=time.time(), viewing_keys=viewing_keys))
            self.metrics.pending_txs.set(self.db.get_pending_tx_count())
            return txid
