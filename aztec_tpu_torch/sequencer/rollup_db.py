"""Sequencer persistence (ref: falafel/src/rollup_db/rollup_db.ts +
entity/{tx,rollup_proof,rollup}.ts).

The reference stores txs / inner rollup proofs / published rollups in SQL
via TypeORM; same schema here on sqlite3 (file-backed for crash recovery,
":memory:" for tests).  The deletion helpers (`delete_unsettled_rollups`,
`delete_orphaned_rollup_proofs`) are the pipeline's failure-recovery
primitives — PipelineCoordinator.reset() replays from this store
(pipeline_coordinator.ts:84-91).

Port of aztec_tpu/sequencer/rollup_db.py: the same schema.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sqlite3
import threading
import time
from typing import List, Optional


@dataclasses.dataclass
class TxDao:
    id: bytes                    # txId = sha256 of proof data (ref: ProofData.txId)
    proof_data: bytes
    nullifier1: bytes
    nullifier2: bytes
    created: float
    rollup_proof_id: Optional[bytes] = None
    mined: Optional[float] = None
    viewing_keys: bytes = b""      # 2 serialized ViewingKeys (sdk sync)


@dataclasses.dataclass
class RollupProofDao:
    id: bytes                    # rollup hash
    tx_ids: List[bytes]
    proof_data: bytes
    rollup_size: int
    data_start_index: int
    created: float
    rollup_id: Optional[int] = None


@dataclasses.dataclass
class RollupDao:
    id: int
    data_root: bytes
    proof_data: bytes
    created: float
    eth_tx_hash: Optional[bytes] = None
    mined: Optional[float] = None


def tx_id(proof_data: bytes) -> bytes:
    return hashlib.sha256(proof_data).digest()


class RollupDb:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        c = self._conn
        c.executescript(
            """
            CREATE TABLE IF NOT EXISTS tx (
              id BLOB PRIMARY KEY, proof_data BLOB, nullifier1 BLOB,
              nullifier2 BLOB, created REAL,
              rollup_proof_id BLOB, mined REAL, viewing_keys BLOB);
            CREATE TABLE IF NOT EXISTS rollup_proof (
              id BLOB PRIMARY KEY, proof_data BLOB, rollup_size INT,
              data_start_index INT, created REAL, rollup_id INT);
            CREATE TABLE IF NOT EXISTS rollup (
              id INTEGER PRIMARY KEY, data_root BLOB, proof_data BLOB,
              created REAL, eth_tx_hash BLOB, mined REAL);
            """
        )
        c.commit()

    # ---- txs ---------------------------------------------------------------

    def add_tx(self, tx: TxDao):
        with self._lock:
            self._conn.execute(
                "INSERT INTO tx VALUES (?,?,?,?,?,?,?,?)",
                (tx.id, tx.proof_data, tx.nullifier1, tx.nullifier2,
                 tx.created, tx.rollup_proof_id, tx.mined,
                 tx.viewing_keys))
            self._conn.commit()

    def get_tx(self, txid: bytes) -> Optional[TxDao]:
        row = self._conn.execute(
            "SELECT * FROM tx WHERE id=?", (txid,)).fetchone()
        return TxDao(*row) if row else None

    def nullifiers_exist(self, *nullifiers: bytes) -> bool:
        ph = ",".join("?" * len(nullifiers))
        q = (f"SELECT COUNT(*) FROM tx WHERE nullifier1 IN ({ph}) "
             f"OR nullifier2 IN ({ph})")
        n = self._conn.execute(q, nullifiers + nullifiers).fetchone()[0]
        return n > 0

    def get_pending_txs(self, take: Optional[int] = None) -> List[TxDao]:
        """Txs not yet in any rollup proof, oldest first."""
        q = "SELECT * FROM tx WHERE rollup_proof_id IS NULL ORDER BY created"
        if take is not None:
            q += f" LIMIT {int(take)}"
        return [TxDao(*r) for r in self._conn.execute(q).fetchall()]

    def get_pending_tx_count(self) -> int:
        return self._conn.execute(
            "SELECT COUNT(*) FROM tx WHERE rollup_proof_id IS NULL"
        ).fetchone()[0]

    def get_unsettled_tx_count(self) -> int:
        return self._conn.execute(
            "SELECT COUNT(*) FROM tx WHERE mined IS NULL").fetchone()[0]

    # ---- inner rollup proofs ----------------------------------------------

    def add_rollup_proof(self, p: RollupProofDao):
        with self._lock:
            self._conn.execute(
                "INSERT INTO rollup_proof VALUES (?,?,?,?,?,?)",
                (p.id, p.proof_data, p.rollup_size, p.data_start_index,
                 p.created, p.rollup_id))
            self._conn.executemany(
                "UPDATE tx SET rollup_proof_id=? WHERE id=?",
                [(p.id, t) for t in p.tx_ids])
            self._conn.commit()

    def get_rollup_proof(self, pid: bytes) -> Optional[RollupProofDao]:
        row = self._conn.execute(
            "SELECT * FROM rollup_proof WHERE id=?", (pid,)).fetchone()
        if not row:
            return None
        txs = [r[0] for r in self._conn.execute(
            "SELECT id FROM tx WHERE rollup_proof_id=? ORDER BY created",
            (pid,)).fetchall()]
        return RollupProofDao(row[0], txs, row[1], row[2], row[3], row[4],
                              row[5])

    def delete_orphaned_rollup_proofs(self):
        """Proofs not attached to a rollup: release their txs (reset path)."""
        with self._lock:
            self._conn.execute(
                "UPDATE tx SET rollup_proof_id=NULL WHERE rollup_proof_id IN "
                "(SELECT id FROM rollup_proof WHERE rollup_id IS NULL)")
            self._conn.execute(
                "DELETE FROM rollup_proof WHERE rollup_id IS NULL")
            self._conn.commit()

    # ---- rollups -----------------------------------------------------------

    def get_next_rollup_id(self) -> int:
        row = self._conn.execute("SELECT MAX(id) FROM rollup").fetchone()
        return (row[0] + 1) if row[0] is not None else 0

    def add_rollup(self, r: RollupDao, proof_ids: List[bytes]):
        with self._lock:
            self._conn.execute(
                "INSERT INTO rollup VALUES (?,?,?,?,?,?)",
                (r.id, r.data_root, r.proof_data, r.created, r.eth_tx_hash,
                 r.mined))
            self._conn.executemany(
                "UPDATE rollup_proof SET rollup_id=? WHERE id=?",
                [(r.id, pid) for pid in proof_ids])
            self._conn.commit()

    def confirm_mined(self, rollup_id: int, eth_tx_hash: bytes):
        now = time.time()
        with self._lock:
            self._conn.execute(
                "UPDATE rollup SET eth_tx_hash=?, mined=? WHERE id=?",
                (eth_tx_hash, now, rollup_id))
            self._conn.execute(
                "UPDATE tx SET mined=? WHERE rollup_proof_id IN "
                "(SELECT id FROM rollup_proof WHERE rollup_id=?)",
                (now, rollup_id))
            self._conn.commit()

    def get_txs_for_rollup(self, rollup_id: int) -> List[TxDao]:
        """Settled txs of one rollup, in rollup order (publisher ->
        block payload; sdk user-state sync reads these back)."""
        rows = self._conn.execute(
            "SELECT tx.* FROM tx JOIN rollup_proof rp "
            "ON tx.rollup_proof_id = rp.id "
            "WHERE rp.rollup_id=? ORDER BY rp.created, tx.created",
            (rollup_id,)).fetchall()
        return [TxDao(*r) for r in rows]

    def get_last_settled_rollup(self) -> Optional[RollupDao]:
        row = self._conn.execute(
            "SELECT * FROM rollup WHERE mined IS NOT NULL "
            "ORDER BY id DESC LIMIT 1").fetchone()
        return RollupDao(*row) if row else None

    def get_rollup(self, rollup_id: int) -> Optional[RollupDao]:
        row = self._conn.execute(
            "SELECT * FROM rollup WHERE id=?", (rollup_id,)).fetchone()
        return RollupDao(*row) if row else None

    def get_rollups(self, take: int = 10) -> List[RollupDao]:
        return [RollupDao(*r) for r in self._conn.execute(
            "SELECT * FROM rollup ORDER BY id DESC LIMIT ?", (take,))]

    def delete_unsettled_rollups(self):
        with self._lock:
            self._conn.execute(
                "UPDATE rollup_proof SET rollup_id=NULL WHERE rollup_id IN "
                "(SELECT id FROM rollup WHERE mined IS NULL)")
            self._conn.execute("DELETE FROM rollup WHERE mined IS NULL")
            self._conn.commit()
