"""aztec-2.0's join-split (rollup/proofs/join_split): two real input notes
spent into two output notes, proved with the unrolled Turbo prover as a
wallet or proving service proves each user's tx (join_split.cpp
new_join_split_prover builds the circuit of each tx and calls
create_unrolled_prover).

Every request carries a tx of its own.  ``draw`` makes request ``index``'s
from the seed, in an otherwise empty world state of the configuration's
data-tree depth: the account key, both input notes' values below 2^64 and
secrets, the split of their sum over the two output notes, the owners and
the signature's nonce, with no public input or output.  The tx's native
hashes, tree paths and signature come from the port's host modules
(``rollup.notes_native``, ``rollup.world_state``, ``rollup.join_split``):
they are the input a wallet hands the prover, and so are the 14 public
inputs it expects the proof to carry, worked out natively from the tx.
``build_request`` is ``CoreSdk(prover="circuit")``'s step: the circuit on a
new ``TurboComposer`` over the set-up's SRS factory.
"""

from __future__ import annotations

from .. import seeds
from . import turbo_circuit


def make_tx(config: dict, rnd, ws):
    """A tx of two real input notes, inserted at leaves 0 and 1 of the world
    state ``ws``'s data tree, each value and key drawn from ``rnd``."""
    from aztec_tpu_torch.crypto.pedersen import fixed_base_scalar_mul_g1
    from aztec_tpu_torch.rollup import join_split as js
    from aztec_tpu_torch.rollup import notes_native as nn

    priv = rnd.randrange(1, 1 << 250)
    v1, v2 = rnd.randrange(1, 1 << 64), rnd.randrange(1, 1 << 64)
    out1 = rnd.randrange(0, v1 + v2 + 1)
    secrets = [rnd.randrange(1, 1 << 250) for _ in range(4)]
    owner_in, owner_out = rnd.randrange(1, 1 << 160), rnd.randrange(1, 1 << 160)
    k = rnd.randrange(1, 1 << 250)

    pub = fixed_base_scalar_mul_g1(priv, 254)
    asset = config["asset_id"]
    notes_in = (nn.ValueNote(v1, asset, 0, pub, secrets[0]),
                nn.ValueNote(v2, asset, 0, pub, secrets[1]))
    notes_out = (nn.ValueNote(out1, asset, 0, pub, secrets[2]),
                 nn.ValueNote(v1 + v2 - out1, asset, 0, pub, secrets[3]))
    for i, note in enumerate(notes_in):
        ws.insert_note(i, nn.encrypt_note(note))
    tx = js.JoinSplitTx(
        public_input=0, public_output=0, asset_id=asset,
        num_input_notes=config["input_notes"], input_index=(0, 1),
        input_note=notes_in, output_note=notes_out,
        signing_pub_key=pub, signature=(bytes(32), bytes(32)),
        old_data_root=ws.data_root(),
        input_path=(ws.data_tree.get_hash_path(0), ws.data_tree.get_hash_path(1)),
        account_index=2, account_path=ws.data_tree.get_hash_path(2),
        input_owner=owner_in, output_owner=owner_out,
        account_private_key=priv, alias_hash=0, nonce=0)
    tx.signature = js.sign_tx(tx, priv, k=k)
    return tx


def _tx(config: dict, rnd):
    """(tx, the 14 public inputs the circuit publishes, worked out natively:
    join_split_circuit.cpp:171-186's InnerProofFields)."""
    from aztec_tpu_torch.rollup import notes_native as nn
    from aztec_tpu_torch.rollup.world_state import WorldState

    tx = make_tx(config, rnd, WorldState(data_depth=config["data_tree_depth"]))
    priv = tx.account_private_key
    enc_out = [nn.encrypt_note(n) for n in tx.output_note]
    nullifiers = [nn.compute_nullifier(nn.encrypt_note(n), i, priv, True)
                  for i, n in enumerate(tx.input_note)]
    public = [0, tx.public_input, tx.public_output, tx.asset_id, *enc_out[0], *enc_out[1],
              *nullifiers, tx.input_owner, tx.output_owner, tx.old_data_root, 0]
    return tx, public


def _circuit(config: dict, tx, composer):
    from aztec_tpu_torch.rollup.join_split import join_split_circuit

    join_split_circuit(composer, tx)
    if composer.failed:
        raise ValueError(f"the join-split's constraints fail: {composer.err}")
    if len(composer.public_inputs) != config["public_inputs"]:
        raise ValueError(f"{len(composer.public_inputs)} public inputs, not "
                         f"{config['public_inputs']}")
    return composer


def draw(config: dict, seed: int, index: int):
    """Request ``index``'s (tx, the public inputs its proof must carry)."""
    return _tx(config, seeds.stream(seed, "join_split", index))


def build(config: dict, seed: int, device: str):
    """The set-up circuit, of a tx no request draws, over its own SRS
    factory: the one key every request's proof is verified against."""
    from aztec_tpu_torch.plonk.composer import TurboComposer

    tx, _ = _tx(config, seeds.stream(seed, "join_split", "setup"))
    return _circuit(config, tx, TurboComposer(device=device))


def build_request(config: dict, tx, device: str, shared):
    """A request's circuit on a new composer over the SRS factory of
    ``shared``, the set-up composer."""
    from aztec_tpu_torch.plonk.composer import TurboComposer

    return _circuit(config, tx, TurboComposer(crs_factory=shared.crs_factory,
                                              device=device))


def reference(config: dict, seed: int, composer):
    """The composer's gates as plain data, read after its key."""
    return turbo_circuit(composer)
