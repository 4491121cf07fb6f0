"""RollupProcessor (ref: blockchain/contracts/RollupProcessor.sol).

The contract's semantic core, executable in-process:

- per-(asset, user) pending-deposit escrow (depositPendingFunds /
  userPendingDeposits, RollupProcessor.sol:263-345),
- processRollup: provider allowlist + escape-hatch window, Decoder.sol's
  public-input extraction, Merkle-root/dataStartIndex validation against
  contract state (validateMerkleRoots, :483-520), proof verification (the
  TurboVerifier call at :403-468, here the native verifier), then deposit
  debits / withdrawal credits per published tx (:520+),
- rollup state (dataRoot/nullRoot/rootRoot/dataSize/nextRollupId) and an
  event log.

Implements the sequencer Blockchain protocol (send_rollup / get_blocks) so
RollupPipeline can publish into it directly.

Port of aztec_tpu/contracts/rollup_processor.py.  ``verify_proof`` is the
caller's: the port's native verifier, or the bytecode of
contracts/evm_verifier.py run in the port's EVM (evm/).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..rollup.constants import NUM_ASSETS
from ..rollup.inner_proof_data import InnerProofFields
from ..sequencer.blockchain import Block

F = InnerProofFields

NUM_ROOT_HEADER_FIELDS = 14  # id, size, start, 6 roots, 4 fees, num_inner


class RollupProofData:
    """Decoder.sol role: parse the root-rollup proof's public inputs."""

    def __init__(self, proof: bytes):
        f = lambda i: int.from_bytes(proof[i * 32:(i + 1) * 32], "big")
        self.rollup_id = f(0)
        self.rollup_size = f(1)
        self.data_start_index = f(2)
        self.old_data_root = f(3)
        self.new_data_root = f(4)
        self.old_null_root = f(5)
        self.new_null_root = f(6)
        self.old_root_root = f(7)
        self.new_root_root = f(8)
        self.total_tx_fees = [f(9 + i) for i in range(NUM_ASSETS)]
        self.num_inner_proofs = f(9 + NUM_ASSETS)
        base = NUM_ROOT_HEADER_FIELDS
        self.inner_publics: List[List[int]] = []
        n_txs = self.rollup_size if self.rollup_size else 1
        for t in range(n_txs):
            off = base + t * F.NUM_PUBLISHED
            if (off + F.NUM_PUBLISHED) * 32 > len(proof):
                break
            self.inner_publics.append(
                [f(off + i) for i in range(F.NUM_PUBLISHED)])


class RollupProcessorError(Exception):
    pass


class RollupProcessor:
    def __init__(self,
                 verify_proof: Optional[Callable[[bytes], bool]] = None,
                 escape_block_lower: int = 80,
                 escape_block_upper: int = 100):
        self.verify_proof = verify_proof or (lambda proof: True)
        # escrow (ref: userPendingDeposits)
        self.user_pending_deposits: Dict[Tuple[int, str], int] = {}
        self.user_balances: Dict[Tuple[int, str], int] = {}  # withdrawn
        self.total_deposited = [0] * NUM_ASSETS
        self.total_withdrawn = [0] * NUM_ASSETS
        self.total_fees = [0] * NUM_ASSETS
        # rollup state (ref: dataRoot/nullRoot/rootRoot storage vars)
        self.data_root: Optional[int] = None
        self.null_root: Optional[int] = None
        self.root_root: Optional[int] = None
        self.data_size = 0
        self.next_rollup_id = 0
        self.rollup_providers: Dict[str, bool] = {"owner": True}
        self.escape_block_lower = escape_block_lower
        self.escape_block_upper = escape_block_upper
        self.block_height = 0  # advanced once per processed rollup
        self.blocks: List[Block] = []
        self.events: List[tuple] = []

    # ---- admin (ref: setRollupProvider) ------------------------------------

    def set_rollup_provider(self, provider: str, valid: bool):
        self.rollup_providers[provider] = valid
        self.events.append(("RollupProviderUpdated", provider, valid))

    def get_escape_hatch_status(self) -> Tuple[bool, int]:
        """(ref: getEscapeHatchStatus :168-187): open during
        [lower, upper) of each 100-block cycle."""
        pos = self.block_height % 100
        if self.escape_block_lower <= pos < self.escape_block_upper:
            return True, self.escape_block_upper - pos
        return False, (self.escape_block_lower - pos) % 100

    # ---- escrow (ref: depositPendingFunds / withdraw) ----------------------

    def deposit_pending_funds(self, asset_id: int, amount: int, owner: str):
        if amount <= 0:
            raise RollupProcessorError("deposit amount must be positive")
        key = (asset_id, owner)
        self.user_pending_deposits[key] = \
            self.user_pending_deposits.get(key, 0) + amount
        self.total_deposited[asset_id] += amount
        self.events.append(("Deposit", asset_id, owner, amount))

    def get_user_pending_deposit(self, asset_id: int, owner: str) -> int:
        return self.user_pending_deposits.get((asset_id, owner), 0)

    def get_user_balance(self, asset_id: int, owner: str) -> int:
        return self.user_balances.get((asset_id, owner), 0)

    # ---- rollup processing (ref: processRollup :358-400) -------------------

    def escape_hatch(self, proof_data: bytes) -> bytes:
        """User-submitted escape-hatch rollup (ref: escapeHatch :347-356):
        accepted from anyone, but only inside the escape window."""
        open_, _ = self.get_escape_hatch_status()
        if not open_:
            raise RollupProcessorError("ESCAPE_BLOCK_RANGE_INCORRECT")
        return self.process_rollup(proof_data, provider="escape_hatch")

    def process_rollup(self, proof_data: bytes, provider: str = "owner",
                       ) -> bytes:
        open_, _ = self.get_escape_hatch_status()
        if not self.rollup_providers.get(provider) and not open_:
            raise RollupProcessorError(
                "INVALID_PROVIDER outside escape hatch window")

        d = RollupProofData(proof_data)
        self._validate_merkle_roots(d)

        if not self.verify_proof(proof_data):
            raise RollupProcessorError("proof verification failed")

        # Atomicity (Solidity revert semantics): validate every deposit
        # debit BEFORE mutating any state.
        debits: Dict[Tuple[int, str], int] = {}
        credits: List[Tuple[int, str, int]] = []
        for pub in d.inner_publics:
            asset_id = pub[F.ASSET_ID]
            if pub[F.PUBLIC_INPUT]:
                key = (asset_id, format(pub[F.INPUT_OWNER], "x"))
                debits[key] = debits.get(key, 0) + pub[F.PUBLIC_INPUT]
            if pub[F.PUBLIC_OUTPUT]:
                credits.append((asset_id, format(pub[F.OUTPUT_OWNER], "x"),
                                pub[F.PUBLIC_OUTPUT]))
        for key, amount in debits.items():
            if self.user_pending_deposits.get(key, 0) < amount:
                raise RollupProcessorError("INSUFFICIENT_DEPOSIT")

        # state update (ref: verifyProofAndUpdateState :468-478)
        self.data_root = d.new_data_root
        self.null_root = d.new_null_root
        self.root_root = d.new_root_root
        self.next_rollup_id = d.rollup_id + 1
        n_txs = d.rollup_size if d.rollup_size else 1
        self.data_size = d.data_start_index + 2 * n_txs

        for key, amount in debits.items():
            self.user_pending_deposits[key] -= amount
        for asset_id, owner, amount in credits:
            key = (asset_id, owner)
            self.user_balances[key] = self.user_balances.get(key, 0) + amount
            self.total_withdrawn[asset_id] += amount
            self.events.append(("Withdraw", asset_id, owner, amount))
        for a in range(NUM_ASSETS):
            self.total_fees[a] += d.total_tx_fees[a]

        self.block_height += 1
        h = hashlib.sha256(b"rollup_block" + proof_data).digest()
        self.events.append(("RollupProcessed", d.rollup_id, d.new_data_root,
                            d.new_null_root, d.new_root_root))
        return h

    def _validate_merkle_roots(self, d: RollupProofData):
        """(ref: validateMerkleRoots :483-530)."""
        if self.data_root is not None:
            if d.rollup_id != self.next_rollup_id:
                raise RollupProcessorError("INCORRECT_ROLLUP_ID")
            if d.old_data_root != self.data_root:
                raise RollupProcessorError("INCORRECT_DATA_ROOT")
            if d.old_null_root != self.null_root:
                raise RollupProcessorError("INCORRECT_NULL_ROOT")
            if d.old_root_root != self.root_root:
                raise RollupProcessorError("INCORRECT_ROOT_ROOT")
        toInsert = 2 * (d.rollup_size if d.rollup_size else 1)
        if self.data_size % toInsert == 0:
            expected = self.data_size
        else:
            expected = self.data_size + toInsert - (self.data_size % toInsert)
        if d.data_start_index != expected:
            raise RollupProcessorError("INCORRECT_DATA_START_INDEX")

    # ---- sequencer Blockchain protocol -------------------------------------

    def send_rollup(self, rollup_id: int, proof_data: bytes,
                    data_start_index: int = 0,
                    tx_datas: Optional[List[bytes]] = None,
                    viewing_keys: Optional[List[List[bytes]]] = None,
                    provider: str = "owner") -> Optional[bytes]:
        try:
            h = self.process_rollup(proof_data, provider)
        except RollupProcessorError as e:
            self.events.append(("WithdrawError", str(e)))
            return None
        self.blocks.append(Block(
            rollup_id, h, proof_data, time.time(), data_start_index,
            list(tx_datas or []), [list(v) for v in viewing_keys or []]))
        return h

    def get_blocks(self, from_rollup_id: int = 0) -> List[Block]:
        return [b for b in self.blocks if b.rollup_id >= from_rollup_id]
