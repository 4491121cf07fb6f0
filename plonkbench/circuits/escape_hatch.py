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
from ..reference.keys import SELECTORS, Circuit


def _tx(config: dict, seed: int):
    from aztec_tpu_torch.crypto.pedersen import fixed_base_scalar_mul_g1
    from aztec_tpu_torch.rollup import escape_hatch as eh
    from aztec_tpu_torch.rollup import join_split as js
    from aztec_tpu_torch.rollup import notes_native as nn
    from aztec_tpu_torch.rollup.world_state import WorldState

    rnd = seeds.stream(seed, "escape_hatch")
    priv = rnd.randrange(1, 1 << 250)
    v1, v2 = rnd.randrange(1, 1 << 64), rnd.randrange(1, 1 << 64)
    out1 = rnd.randrange(0, v1 + v2 + 1)
    secrets = [rnd.randrange(1, 1 << 250) for _ in range(4)]
    owner_in, owner_out = rnd.randrange(1, 1 << 160), rnd.randrange(1, 1 << 160)
    k = rnd.randrange(1, 1 << 250)

    pub = fixed_base_scalar_mul_g1(priv, 254)
    ws = WorldState(data_depth=config["data_tree_depth"],
                    null_depth=config["nullifier_tree_depth"],
                    root_depth=config["root_tree_depth"])
    asset = config["asset_id"]
    in1 = nn.ValueNote(v1, asset, 0, pub, secrets[0])
    in2 = nn.ValueNote(v2, asset, 0, pub, secrets[1])
    o1 = nn.ValueNote(out1, asset, 0, pub, secrets[2])
    o2 = nn.ValueNote(v1 + v2 - out1, asset, 0, pub, secrets[3])
    enc_in = [nn.encrypt_note(in1), nn.encrypt_note(in2)]
    ws.insert_note(0, enc_in[0])
    ws.insert_note(1, enc_in[1])
    tx = js.JoinSplitTx(
        public_input=0, public_output=0, asset_id=asset, num_input_notes=2,
        input_index=(0, 1), input_note=(in1, in2), output_note=(o1, o2),
        signing_pub_key=pub, signature=(bytes(32), bytes(32)),
        old_data_root=ws.data_root(),
        input_path=(ws.data_tree.get_hash_path(0), ws.data_tree.get_hash_path(1)),
        account_index=2, account_path=ws.data_tree.get_hash_path(2),
        input_owner=owner_in, output_owner=owner_out,
        account_private_key=priv, alias_hash=0, nonce=0)
    tx.signature = js.sign_tx(tx, priv, k=k)

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
    return Circuit(
        "turbo", list(composer.variables), composer.real_variable_index,
        list(composer.public_inputs),
        tuple(list(w) for w in (composer.w_l, composer.w_r, composer.w_o,
                                composer.w_4)),
        {name: list(getattr(composer, name)) for name in SELECTORS["turbo"]})
