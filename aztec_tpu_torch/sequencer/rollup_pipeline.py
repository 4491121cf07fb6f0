"""Pipeline factory (ref: falafel/src/rollup_pipeline.ts): wires the db,
world state, fee resolver, proof generator, blockchain and coordinator into
one restartable unit, and keeps the world state synced from settled blocks
(ref: world_state.ts:31-56 syncState).

Port of aztec_tpu/sequencer/rollup_pipeline.py: ``inner_vk_json`` (copied
into every root-rollup frame) defaults to ``"{}"`` as there; a worker that
checks the VK needs the one its 0x202 answers after the first id-0 request.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..rollup.world_state import WorldState
from .blockchain import Blockchain, LocalBlockchain
from .fee_resolver import TxFeeResolver
from .metrics import Metrics
from .pipeline_coordinator import PipelineCoordinator
from .proof_generator import ProofGenerator
from .rollup_coordinator import (
    RollupAggregator,
    RollupCreator,
    RollupPublisher,
)
from .rollup_db import RollupDb
from .tx_receiver import TxReceiver


@dataclasses.dataclass
class SequencerConfig:
    """(ref: falafel/src/config.ts env-var config module)."""
    num_inner_rollup_txs: int = 2
    num_outer_rollup_proofs: int = 1
    publish_interval_s: float = 10.0
    base_fee: int = 10
    db_path: str = ":memory:"
    data_tree_depth: int = 8
    null_tree_depth: int = 16
    root_tree_depth: int = 8


class RollupPipeline:
    def __init__(self, config: SequencerConfig,
                 proof_generator: ProofGenerator,
                 blockchain: Optional[Blockchain] = None,
                 inner_vk_json: str = "{}",
                 verify_tx_proof=None):
        self.config = config
        self.metrics = Metrics()
        self.db = RollupDb(config.db_path)
        self.world_state = WorldState(
            config.data_tree_depth, config.null_tree_depth,
            config.root_tree_depth)
        # (WorldState.__init__ records the genesis data root at leaf 0)
        self.blockchain = blockchain or LocalBlockchain()
        self.fee_resolver = TxFeeResolver(base_fee=config.base_fee)
        self.tx_receiver = TxReceiver(
            self.db, self.fee_resolver, self.metrics,
            verify_proof=verify_tx_proof,
            known_data_roots=lambda root:
                root in self.world_state._root_index)
        creator = RollupCreator(
            self.db, self.world_state, proof_generator,
            config.num_inner_rollup_txs, self.metrics)
        aggregator = RollupAggregator(
            self.db, self.world_state, proof_generator,
            config.num_inner_rollup_txs, config.num_outer_rollup_proofs,
            inner_vk_json, self.metrics)
        publisher = RollupPublisher(self.db, self.blockchain, self.metrics)
        self.coordinator = PipelineCoordinator(
            creator, aggregator, publisher, self.db, self.fee_resolver,
            config.num_inner_rollup_txs, config.num_outer_rollup_proofs,
            config.publish_interval_s)

    def start(self, poll_s: float = 0.1):
        self.coordinator.start(poll_s)

    def stop(self):
        self.coordinator.stop()

    def status(self) -> dict:
        """(ref: falafel server_status resolver)."""
        import datetime

        return {
            "pendingTxCount": self.db.get_pending_tx_count(),
            "unsettledTxCount": self.db.get_unsettled_tx_count(),
            "nextRollupId": self.db.get_next_rollup_id(),
            "nextPublishTime": datetime.datetime.fromtimestamp(
                self.coordinator.next_publish_time()).isoformat(),
            "dataRoot": hex(self.world_state.data_root()),
            "nullRoot": hex(self.world_state.null_tree.root),
            "rootRoot": hex(self.world_state.root_tree.root),
            "numInnerRollupTxs": self.config.num_inner_rollup_txs,
            "numOuterRollupProofs": self.config.num_outer_rollup_proofs,
        }
