"""Pipeline coordinator (ref: falafel/src/pipeline_coordinator.ts:11-100).

Monitors the pending-tx pool and fires the create -> aggregate -> publish
pipeline when any trigger is met:

  - flush requested (flushTxs),
  - a full outer rollup's worth of txs is pending,
  - no rollup has ever been published and a tx is pending,
  - the publish deadline has passed: publish_interval scaled by the fee
    surplus ratio from the oldest pending tx's arrival.

reset() is the failure-recovery path (pipeline_coordinator.ts:84-91):
unsettled rollups and orphaned inner proofs are deleted, releasing their
txs back to the pool — a crashed/interrupted pipeline replays cleanly.

Port of aztec_tpu/sequencer/pipeline_coordinator.py: the catch-all of
``tick`` is kept, so a failing request is retried on the next poll; a
caller that must stop at the first failure watches ``reset``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..rollup.inner_proof_data import InnerProofData
from .fee_resolver import TxFeeResolver
from .rollup_coordinator import RollupAggregator, RollupCreator, RollupPublisher
from .rollup_db import RollupDb


class PipelineCoordinator:
    def __init__(self, creator: RollupCreator, aggregator: RollupAggregator,
                 publisher: RollupPublisher, rollup_db: RollupDb,
                 fee_resolver: TxFeeResolver,
                 num_inner_txs: int, num_outer_proofs: int,
                 publish_interval_s: float = 10.0):
        self.creator = creator
        self.aggregator = aggregator
        self.publisher = publisher
        self.db = rollup_db
        self.fees = fee_resolver
        self.num_inner_txs = num_inner_txs
        self.num_outer_proofs = num_outer_proofs
        self.publish_interval_s = publish_interval_s
        self.running = False
        self.flush = False
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ---------------------------------------------------------

    def start(self, poll_s: float = 0.1):
        if self.running:
            raise RuntimeError("pipeline coordinator already running")
        self.running = True
        self.flush = False

        def loop():
            self.reset()
            while self.running:
                self.tick()
                time.sleep(poll_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        if not self.running:
            return
        self.running = False
        self.creator.interrupt()
        self.aggregator.interrupt()
        self.publisher.interrupt()
        if self._thread:
            self._thread.join()

    def flush_txs(self):
        self.flush = True

    def reset(self):
        """Erase outstanding rollups/proofs, releasing unsettled txs."""
        self.db.delete_unsettled_rollups()
        self.db.delete_orphaned_rollup_proofs()

    # ---- triggers ----------------------------------------------------------

    def next_publish_time(self) -> float:
        txs = self.db.get_pending_txs()
        if not txs:
            return time.time() + self.publish_interval_s
        if not self.db.get_last_settled_rollup():
            return time.time()  # first ever rollup: go immediately
        if len(txs) >= self.num_inner_txs * self.num_outer_proofs:
            return time.time()
        datas = [InnerProofData.from_proof(t.proof_data) for t in txs]
        ratio = self.fees.compute_surplus_ratio(datas)
        return txs[0].created + self.publish_interval_s * ratio

    def _should_publish(self) -> bool:
        if self.db.get_pending_tx_count() == 0:
            return False
        if self.flush:
            return True
        npt = self.next_publish_time()
        return time.time() >= npt

    # ---- one pipeline pass -------------------------------------------------

    def tick(self) -> bool:
        """Runs one create->aggregate->publish pass if triggered.
        Returns True when a rollup was published."""
        if not self._should_publish():
            return False
        self.flush = False
        inner_proofs = []
        snap = self.creator.ws.snapshot()
        try:
            for _ in range(self.num_outer_proofs):
                txs = self.db.get_pending_txs(take=self.num_inner_txs)
                if not txs:
                    break
                inner_proofs.append(self.creator.create(txs))
            if not inner_proofs:
                return False
            rollup = self.aggregator.aggregate(inner_proofs)
            if self.publisher.publish(rollup):
                return True
            # chain rejected the rollup (or submission failed): same
            # recovery as a thrown stage — release txs and replay
            self.creator.ws.restore(snap)
            self.reset()
            return False
        except Exception as e:  # failed pipeline: reset + replay next tick
            import sys

            print(f"pipeline error, resetting: {e!r}", file=sys.stderr,
                  flush=True)
            self.creator.ws.restore(snap)  # un-apply world-state updates
            self.reset()
            return False
