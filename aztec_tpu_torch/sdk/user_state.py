"""Per-user note tracking driven by settled blocks
(ref: sdk/src/user_state — decrypts viewing keys from each rollup block,
adds owned notes, marks spent notes by nullifier).

Port of aztec_tpu/sdk/user_state.py.
"""

from __future__ import annotations

from typing import List

from ..rollup.inner_proof_data import InnerProofData
from ..rollup.notes_native import compute_nullifier, encrypt_note
from .note_store import Note, NoteStore
from .viewing_key import ViewingKey, try_decrypt_note


class UserState:
    def __init__(self, account_priv: int, account_pub):
        self.priv = account_priv
        self.pub = account_pub
        self.notes = NoteStore()
        self.synced_to = -1  # last processed rollup id

    def balance(self, asset_id: int = 0) -> int:
        return self.notes.balance(asset_id)

    def process_tx(self, data: InnerProofData, viewing_keys: List[bytes],
                   data_start_index: int, tx_slot: int):
        """One settled tx: try to claim its two output notes, retire
        nullified inputs (ref: user_state.ts handleJoinSplitTx)."""
        commitments = [
            (int.from_bytes(data.new_note1[:32], "big"),
             int.from_bytes(data.new_note1[32:], "big")),
            (int.from_bytes(data.new_note2[:32], "big"),
             int.from_bytes(data.new_note2[32:], "big")),
        ]
        for i, vk_buf in enumerate(viewing_keys[:2]):
            if len(vk_buf) != ViewingKey.WIRE_LEN:
                continue
            note = try_decrypt_note(
                ViewingKey.from_buffer(vk_buf), self.priv, self.pub)
            if note is None:
                continue
            if encrypt_note(note) != commitments[i]:
                continue  # decrypted but not actually ours / corrupt
            index = data_start_index + 2 * tx_slot + i
            self.notes.add(Note(
                note=note, index=index,
                nullifier=compute_nullifier(commitments[i], index,
                                            self.priv, True)))
        for nul in (data.nullifier1, data.nullifier2):
            self.notes.mark_nullified(nul)
