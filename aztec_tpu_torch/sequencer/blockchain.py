"""Blockchain interface + local chain (ref: falafel's Blockchain dep +
blockchain/src contract wrappers).

The reference publishes root-rollup proofs to RollupProcessor.sol, which
runs the on-chain TurboVerifier; falafel's WorldState then syncs blocks
back off the chain into its Merkle DB (world_state.ts:31-56).  Here the
same seam is a small protocol: `send_rollup` returns a tx hash once the
block settles, `get_blocks` replays settled blocks for world-state sync.
LocalBlockchain verifies proofs with the native verifier — the same role
the on-chain verifier plays — and is also the test double (the reference
tests against ganache).

Port of aztec_tpu/sequencer/blockchain.py.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, List, Optional, Protocol


@dataclasses.dataclass
class Block:
    """A settled rollup (ref: barretenberg/block_source Block: rollup proof
    + per-tx viewing keys, the payload sdk user states sync from)."""
    rollup_id: int
    tx_hash: bytes
    rollup_proof_data: bytes
    created: float
    data_start_index: int = 0
    tx_datas: List[bytes] = dataclasses.field(default_factory=list)
    viewing_keys: List[List[bytes]] = dataclasses.field(default_factory=list)


class Blockchain(Protocol):
    def send_rollup(self, rollup_id: int, proof_data: bytes,
                    data_start_index: int = 0,
                    tx_datas: Optional[List[bytes]] = None,
                    viewing_keys: Optional[List[List[bytes]]] = None,
                    ) -> Optional[bytes]: ...
    def get_blocks(self, from_rollup_id: int) -> List[Block]: ...


class LocalBlockchain:
    """In-process chain: verify + append (the RollupProcessor contract's
    escrow/verification role, minus Ethereum)."""

    def __init__(self,
                 verify_proof: Optional[Callable[[bytes], bool]] = None):
        self.verify_proof = verify_proof or (lambda proof: True)
        self.blocks: List[Block] = []
        self._lock = threading.Lock()

    def send_rollup(self, rollup_id: int, proof_data: bytes,
                    data_start_index: int = 0,
                    tx_datas: Optional[List[bytes]] = None,
                    viewing_keys: Optional[List[List[bytes]]] = None,
                    ) -> Optional[bytes]:
        if not self.verify_proof(proof_data):
            return None  # on-chain verifier rejected: tx reverts
        with self._lock:
            if any(b.rollup_id == rollup_id for b in self.blocks):
                return None  # duplicate rollup id: nonce protection
            h = hashlib.sha256(b"block" + proof_data).digest()
            self.blocks.append(Block(
                rollup_id, h, proof_data, time.time(), data_start_index,
                list(tx_datas or []), [list(v) for v in viewing_keys or []]))
            return h

    def get_blocks(self, from_rollup_id: int = 0) -> List[Block]:
        with self._lock:
            return [b for b in self.blocks if b.rollup_id >= from_rollup_id]
