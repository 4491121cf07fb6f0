"""Rollup sequencer (falafel equivalent).

A re-design of the reference's falafel service (falafel/src/):
tx receiver -> rollup db -> pipeline coordinator -> rollup creator ->
rollup aggregator -> rollup publisher, with Prometheus-style metrics and
reset/replay failure recovery.  Proof generation is delegated to the proof
service (serving/http_server.py or an in-process worker), exactly as
falafel delegates to halloumi.

Port of aztec_tpu/sequencer/: the same stages, schema and recovery;
proofs come from the port's proof worker (``serving/``), which proves on
the card.
"""

from .metrics import Metrics
from .rollup_db import RollupDb, TxDao, RollupProofDao, RollupDao
from .tx_receiver import TxReceiver
from .fee_resolver import TxFeeResolver
from .pipeline_coordinator import PipelineCoordinator
from .rollup_pipeline import RollupPipeline
