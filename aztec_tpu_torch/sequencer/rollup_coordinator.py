"""Rollup creation + aggregation + publishing stages
(ref: falafel/src/rollup_creator.ts, rollup_aggregator.ts,
rollup_publisher.ts).

RollupCreator turns a batch of pending txs into an inner-rollup proof via
the proof service; RollupAggregator folds inner proofs into a root rollup;
RollupPublisher submits to the blockchain interface and awaits settlement.
Each stage persists its output in RollupDb before moving on, so a crash at
any point is recovered by PipelineCoordinator.reset()'s delete+replay.

Port of aztec_tpu/sequencer/rollup_coordinator.py.
"""

from __future__ import annotations

import time
from typing import List

from ..rollup.create_rollup import create_rollup_tx, create_root_rollup_tx
from ..rollup.world_state import WorldState
from .metrics import Metrics
from .proof_generator import (
    ProofGenerator,
    root_rollup_frame,
    tx_rollup_frame,
)
from .rollup_db import RollupDb, RollupProofDao, RollupDao, TxDao, tx_id


class RollupProofData:
    """Parsed public-input prefix of an inner rollup proof (field layout of
    rollup_circuit.py's set_public order; ref: rollup_proof_data.hpp)."""

    def __init__(self, proof: bytes):
        f = lambda i: int.from_bytes(proof[i * 32:(i + 1) * 32], "big")
        self.rollup_id = f(0)
        self.rollup_size = f(1)
        self.data_start_index = f(2)
        self.old_data_root = f(3)
        self.new_data_root = f(4)
        self.old_null_root = f(5)
        self.new_null_root = f(6)
        self.data_roots_root = f(7)


class RollupCreator:
    def __init__(self, rollup_db: RollupDb, world_state: WorldState,
                 proof_generator: ProofGenerator, num_inner_txs: int,
                 metrics: Metrics):
        self.db = rollup_db
        self.ws = world_state
        self.proofs = proof_generator
        self.num_inner_txs = num_inner_txs
        self.metrics = metrics
        self._interrupted = False

    def interrupt(self):
        self._interrupted = True

    def create(self, txs: List[TxDao]) -> RollupProofDao:
        """(ref: rollup_creator.ts create): build the rollup tx (applying
        world-state updates natively), prove it, persist the proof."""
        if not txs:
            raise ValueError("txs empty")
        rollup_id = self.db.get_next_rollup_id()
        rtx = create_rollup_tx(
            self.ws, rollup_id, [t.proof_data for t in txs],
            rollup_size=self.num_inner_txs)
        end = self.metrics.tx_rollup_seconds.timer()
        proof = self.proofs.create_proof(
            tx_rollup_frame(rtx, self.num_inner_txs))
        end()
        if not proof:
            raise RuntimeError("failed to create inner rollup proof")
        dao = RollupProofDao(
            id=tx_id(proof), tx_ids=[t.id for t in txs], proof_data=proof,
            rollup_size=self.num_inner_txs,
            data_start_index=rtx.data_start_index, created=time.time())
        self.db.add_rollup_proof(dao)
        return dao


class RollupAggregator:
    def __init__(self, rollup_db: RollupDb, world_state: WorldState,
                 proof_generator: ProofGenerator, num_inner_txs: int,
                 num_outer_proofs: int, inner_vk_json: str,
                 metrics: Metrics):
        self.db = rollup_db
        self.ws = world_state
        self.proofs = proof_generator
        self.num_inner_txs = num_inner_txs
        self.num_outer_proofs = num_outer_proofs
        self.inner_vk_json = inner_vk_json
        self.metrics = metrics
        self._interrupted = False

    def interrupt(self):
        self._interrupted = True

    def aggregate(self, inner_proofs: List[RollupProofDao]) -> RollupDao:
        """(ref: rollup_aggregator.ts aggregateRollupProofs): root-rollup
        proof over the inner proofs + rollup DAO persisted."""
        rollup_id = self.db.get_next_rollup_id()
        last = RollupProofData(inner_proofs[-1].proof_data)
        rtx = create_root_rollup_tx(
            self.ws, rollup_id, [p.proof_data for p in inner_proofs],
            new_data_root=last.new_data_root)
        end = self.metrics.root_rollup_seconds.timer()
        proof = self.proofs.create_proof(root_rollup_frame(
            rtx, self.num_inner_txs, self.num_outer_proofs,
            self.inner_vk_json))
        end()
        if not proof:
            raise RuntimeError("failed to create root rollup proof")
        dao = RollupDao(
            id=rollup_id,
            data_root=last.new_data_root.to_bytes(32, "big"),
            proof_data=proof, created=time.time())
        self.db.add_rollup(dao, [p.id for p in inner_proofs])
        return dao


class RollupPublisher:
    def __init__(self, rollup_db: RollupDb, blockchain, metrics: Metrics):
        self.db = rollup_db
        self.blockchain = blockchain
        self.metrics = metrics
        self._interrupted = False

    def interrupt(self):
        self._interrupted = True

    def publish(self, rollup: RollupDao) -> bool:
        """(ref: rollup_publisher.ts publishRollup): submit, await receipt,
        confirm settlement in the db."""
        txs = self.db.get_txs_for_rollup(rollup.id)
        from ..sdk.viewing_key import ViewingKey

        W = ViewingKey.WIRE_LEN
        vks = [[t.viewing_keys[:W], t.viewing_keys[W:2 * W]] for t in txs]
        first_proof = (self.db.get_rollup_proof(txs[0].rollup_proof_id)
                       if txs else None)
        end = self.metrics.publish_seconds.timer()
        try:
            tx_hash = self.blockchain.send_rollup(
                rollup.id, rollup.proof_data,
                data_start_index=(first_proof.data_start_index
                                  if first_proof else 0),
                tx_datas=[t.proof_data for t in txs],
                viewing_keys=vks)
        except Exception:
            return False
        finally:
            end()
        if tx_hash is None:
            return False
        self.db.confirm_mined(rollup.id, tx_hash)
        self.metrics.rollup_published.inc()
        return True
