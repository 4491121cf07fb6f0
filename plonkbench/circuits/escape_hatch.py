"""aztec-2.0's escape hatch (rollup/proofs/escape_hatch): a join-split of two
real input notes whose world-state updates (data, nullifier and root trees)
are proved in the same Turbo circuit, so a user exits without the operator.

The tx is drawn from the seed as ``tests/torch_vectors/make_vectors.py``'s
``escape_hatch_tx`` draws its fixed one: the account key, both input notes'
values and secrets, the split of their sum over the two output notes, the
owners and the signature's nonce.  The tree depths are the configuration's.
The tx's native hashes, trees and signature come from the port's host modules
(``rollup.notes_native``, ``rollup.world_state``, ``rollup.join_split``):
they are the input a wallet hands the prover.
"""

from __future__ import annotations

from .. import seeds
from ..reference.keys import Circuit
from . import turbo_circuit
from .join_split import make_tx


def _tx(config: dict, seed: int):
    from aztec_tpu_torch.rollup import escape_hatch as eh
    from aztec_tpu_torch.rollup import notes_native as nn
    from aztec_tpu_torch.rollup.world_state import WorldState

    ws = WorldState(data_depth=config["data_tree_depth"],
                    null_depth=config["nullifier_tree_depth"],
                    root_depth=config["root_tree_depth"])
    tx = make_tx(config, seeds.stream(seed, "escape_hatch"), ws)
    priv = tx.account_private_key
    o1, o2 = tx.output_note
    enc_in = [nn.encrypt_note(n) for n in tx.input_note]

    old_null_root = ws.null_tree.root
    new_null = [ws.insert_nullifier(nn.compute_nullifier(enc, i, priv, True))
                for i, enc in enumerate(enc_in)]
    old_data_path = ws.data_tree.get_hash_path(2)
    ws.insert_note(2, nn.encrypt_note(o1))
    ws.insert_note(3, nn.encrypt_note(o2))
    new_data_root = ws.data_root()
    old_roots_root = ws.root_tree.root
    old_roots_path = ws.root_tree.get_hash_path(1)
    new_roots_root, _ = ws.insert_data_root(0, new_data_root)
    return eh.EscapeHatchTx(
        js_tx=tx, rollup_id=0, data_start_index=2, new_data_root=new_data_root,
        old_data_path=old_data_path,
        new_null_roots=tuple(r for r, _ in new_null),
        old_null_paths=tuple(p for _, p in new_null),
        old_null_root=old_null_root, old_data_roots_root=old_roots_root,
        new_data_roots_root=new_roots_root, old_data_roots_path=old_roots_path)


def build(config: dict, seed: int, device: str):
    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.rollup.escape_hatch import escape_hatch_circuit

    tx = _tx(config, seed)
    c = TurboComposer(device=device)
    escape_hatch_circuit(c, tx)
    if c.failed:
        raise ValueError(f"the escape hatch's constraints fail: {c.err}")
    if len(c.public_inputs) != config["public_inputs"]:
        raise ValueError(f"{len(c.public_inputs)} public inputs, not "
                         f"{config['public_inputs']}")
    return c


def reference(config: dict, seed: int, composer) -> Circuit:
    """The composer's gates as plain data: the circuit is what the port's
    stdlib built from the tx, so the reference reads it after the key (the
    key's set-up appends Turbo's dummy gate)."""
    return turbo_circuit(composer)
