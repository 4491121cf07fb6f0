"""CoreSdk: the client facade (ref: sdk/src/core_sdk/core_sdk.ts).

Holds users (key pairs + note state), a local mirror of the data tree
(synced from settled blocks, giving membership paths for spends), and
builds/probes/submits join-split txs:

    deposit   public_input = value, 0-2 input notes
    transfer  notes -> notes between users
    withdraw  public_output = value

Proving is pluggable: `prover="circuit"` runs the real join_split circuit
through the Turbo prover (the reference's WASM proof creation, here the
TPU prover); `prover="native"` computes the identical public-input layout
from the native note algebra without a SNARK — the mode sequencer/SDK
integration tests run at (proof bytes then carry a dummy tail, accepted
only by a stub verifier, exactly like the reference's mocked e2e tests).

Port of aztec_tpu/sdk/core_sdk.py.  ``prover="circuit"`` proves on
``device``, the card unless ``"cpu"`` is given (with no card the composer
raises; it never proves on the CPU unasked).  Every random value (the
gibberish notes' and output notes' secrets, the signature's nonce, the
viewing keys' ephemeral keys) comes from ``randbytes(n) -> bytes``
(``os.urandom`` unless given), drawn in the reference's order and sizes.
A padding input note takes the lowest index the other input does not
hold, so that a deposit's circuit holds (the reference pads both at 0).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

from ..merkle import MemoryTree
from ..rollup.inner_proof_data import InnerProofFields
from ..rollup.join_split import JoinSplitTx, sign_tx
from ..rollup.notes_native import (
    ValueNote,
    compute_nullifier,
    encrypt_note,
)
from .note_store import Note
from .user_state import UserState
from .viewing_key import derive_keys, encrypt_note_for

F = InnerProofFields
GPoint = Tuple[int, int]


@dataclasses.dataclass
class TxRequest:
    """A built tx ready for submission: proof bytes + viewing keys."""
    proof_data: bytes
    viewing_keys: bytes
    tx: JoinSplitTx
    output_notes: List[ValueNote]


class CoreSdk:
    def __init__(self, data_tree_depth: int = 8, prover: str = "native",
                 proof_fn: Optional[Callable[[JoinSplitTx], bytes]] = None,
                 device="cuda",
                 randbytes: Callable[[int], bytes] = os.urandom):
        self.device = device
        self.randbytes = randbytes
        self.users = {}
        self.data_tree = MemoryTree(data_tree_depth)
        self.data_tree_next_index = 0
        self.synced_to = -1
        self.prover = prover
        self.proof_fn = proof_fn
        self.known_roots = [self.data_tree.root]

    # ---- users -------------------------------------------------------------

    def add_user(self, seed: bytes) -> UserState:
        priv, pub = derive_keys(seed)
        u = UserState(priv, pub)
        self.users[pub] = u
        return u

    # ---- chain sync (ref: core_sdk processBlock / user_state sync) ---------

    def process_block(self, block) -> None:
        """Apply one settled rollup block: extend the data-tree mirror and
        feed every user state."""
        if block.rollup_id <= self.synced_to:
            return
        for slot, txd in enumerate(block.tx_datas):
            n1 = txd[F.NEW_NOTE1_X * 32:(F.NEW_NOTE1_Y + 1) * 32]
            n2 = txd[F.NEW_NOTE2_X * 32:(F.NEW_NOTE2_Y + 1) * 32]
            base = block.data_start_index + 2 * slot
            self.data_tree.update_element(base, n1)
            self.data_tree.update_element(base + 1, n2)
            self.data_tree_next_index = max(self.data_tree_next_index,
                                            base + 2)
        self.known_roots.append(self.data_tree.root)
        from ..rollup.inner_proof_data import InnerProofData

        for slot, txd in enumerate(block.tx_datas):
            data = InnerProofData.from_proof(txd)
            vks = (block.viewing_keys[slot]
                   if slot < len(block.viewing_keys) else [])
            for u in self.users.values():
                u.process_tx(data, vks, block.data_start_index, slot)
        self.synced_to = block.rollup_id

    def sync(self, blockchain) -> None:
        for b in blockchain.get_blocks(self.synced_to + 1):
            self.process_block(b)

    # ---- tx construction (ref: sdk/src/proofs/join_split_proof) ------------

    def _gibberish_note(self, owner: GPoint) -> ValueNote:
        secret = int.from_bytes(self.randbytes(31), "big")
        return ValueNote(0, 0, 0, owner, secret)

    def create_join_split(self, user: UserState, *, public_input: int = 0,
                          public_output: int = 0, transfer: int = 0,
                          recipient: Optional[GPoint] = None,
                          asset_id: int = 0, tx_fee: int = 0,
                          input_owner: int = 0, output_owner: int = 0,
                          ) -> TxRequest:
        """Build (and prove) one join-split: spend up to two of the user's
        notes plus public_input, emitting a recipient note + change note."""
        recipient = recipient or user.pub
        spend = transfer + public_output + tx_fee
        picked: List[Note] = []
        if spend > public_input:
            picked = user.notes.pick(asset_id, spend - public_input) or []
            if not picked:
                raise ValueError("insufficient funds")
        total_in = public_input + sum(n.note.value for n in picked)
        change = total_in - spend
        assert change >= 0

        # pad to 2 input notes with gibberish (ref: join_split_tx defaults)
        # at the lowest index neither input holds: the circuit refuses two
        # inputs at one index ("joining same note"), and the reference,
        # which pads at index 0, gives a deposit inputs at (0, 0)
        num_input_notes = len(picked)
        in_notes = [n.note for n in picked]
        in_indices = [n.index for n in picked]
        while len(in_notes) < 2:
            in_notes.append(self._gibberish_note(user.pub))
            in_indices.append(min({0, 1, 2} - set(in_indices)))

        # out1 carries the transferred value; out2 the sender's change
        out1 = ValueNote(transfer, asset_id, 0, recipient,
                         int.from_bytes(self.randbytes(31), "big"))
        out2 = ValueNote(change, asset_id, 0, user.pub,
                         int.from_bytes(self.randbytes(31), "big"))

        tx = JoinSplitTx(
            public_input=public_input, public_output=public_output,
            asset_id=asset_id, num_input_notes=num_input_notes,
            input_index=(in_indices[0], in_indices[1]),
            input_note=(in_notes[0], in_notes[1]),
            output_note=(out1, out2),
            signing_pub_key=user.pub, signature=(bytes(32), bytes(32)),
            old_data_root=self.data_tree.root,
            input_path=(self.data_tree.get_hash_path(in_indices[0]),
                        self.data_tree.get_hash_path(in_indices[1])),
            account_index=0,
            account_path=self.data_tree.get_hash_path(0),
            input_owner=input_owner, output_owner=output_owner,
            account_private_key=user.priv, alias_hash=0, nonce=0,
        )
        tx.signature = sign_tx(
            tx, user.priv,
            k=int.from_bytes(self.randbytes(31), "big") or 1)

        proof = self._prove(tx, user, tx_fee)
        vks = (encrypt_note_for(out1, recipient,
                                randbytes=self.randbytes).to_buffer()
               + encrypt_note_for(out2, user.pub,
                                  randbytes=self.randbytes).to_buffer())
        return TxRequest(proof, vks, tx, [out1, out2])

    # ---- proving -----------------------------------------------------------

    def _prove(self, tx: JoinSplitTx, user: UserState, tx_fee: int) -> bytes:
        if self.proof_fn is not None:
            return self.proof_fn(tx)
        if self.prover == "circuit":
            from ..plonk.composer import TurboComposer
            from ..rollup.join_split import join_split_circuit
            from ..srs.reference_string import FakeReferenceStringFactory

            c = TurboComposer(
                crs_factory=FakeReferenceStringFactory(device=self.device),
                device=self.device)
            join_split_circuit(c, tx)
            if c.failed:
                raise RuntimeError(f"join_split circuit failed: {c.err}")
            return c.create_unrolled_prover().construct_proof()
        return self._native_public_inputs(tx, user, tx_fee) + b"\xEE" * 64

    def _native_public_inputs(self, tx: JoinSplitTx, user: UserState,
                              tx_fee: int) -> bytes:
        """The join_split public-input prefix computed natively (bit-exact
        with the circuit's published fields)."""
        enc = [encrypt_note(n) for n in tx.output_note]
        nul = [
            compute_nullifier(encrypt_note(tx.input_note[i]),
                              tx.input_index[i], user.priv,
                              i < tx.num_input_notes)
            for i in range(2)
        ]
        fields = [0] * F.NUM_FIELDS
        fields[F.PROOF_ID] = 0
        fields[F.PUBLIC_INPUT] = tx.public_input
        fields[F.PUBLIC_OUTPUT] = tx.public_output
        fields[F.ASSET_ID] = tx.asset_id
        fields[F.NEW_NOTE1_X] = enc[0][0]
        fields[F.NEW_NOTE1_Y] = enc[0][1]
        fields[F.NEW_NOTE2_X] = enc[1][0]
        fields[F.NEW_NOTE2_Y] = enc[1][1]
        fields[F.NULLIFIER1] = nul[0]
        fields[F.NULLIFIER2] = nul[1]
        fields[F.INPUT_OWNER] = tx.input_owner
        fields[F.OUTPUT_OWNER] = tx.output_owner
        fields[F.MERKLE_ROOT] = tx.old_data_root
        fields[F.TX_FEE] = tx_fee
        return b"".join(v.to_bytes(32, "big") for v in fields)

    # ---- submission --------------------------------------------------------

    def submit(self, req: TxRequest, tx_receiver) -> bytes:
        """Hand the tx to a sequencer TxReceiver (in-process) and register
        the pending output notes for the sender."""
        txid = tx_receiver.receive_tx(req.proof_data, req.viewing_keys)
        return txid
