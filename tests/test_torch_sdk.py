"""The port's client SDK (aztec_tpu_torch.sdk) and AES-128 against
aztec_tpu's, on the CPU.

AES-128 against the FIPS-197 vector and against aztec_tpu.crypto.aes128 on
seeded blocks (CBC both ways); the account keys; a viewing key byte for
byte for one ephemeral key, its round trip and a wrong key's rejection;
the note picker on seeded notes.  The deposit -> transfer -> withdraw
story of tests/test_sdk.py runs in both packages with ``prover="native"``
from one seeded random stream (the port's ``CoreSdk(randbytes=...)``,
``os.urandom`` patched for aztec_tpu), each through its own sequencer over
a mock worker: the proof bytes, viewing keys and balances after each sync
are equal, and so is the rejection for insufficient funds; only the
deposit's second nullifier differs, as it must (the port pads a deposit's
inputs at indices (0, 1), where aztec_tpu pads both at 0, which its own
join-split circuit refuses), and it is aztec_tpu's nullifier of the same
note at index 1.  The random source is drawn in the reference's order
and sizes.  Without proving, at data-tree depth 3: the SDK's deposit
circuit holds (``check_turbo``) and has the gates, selectors and copy
cycles of the worker's ``noop_join_split_tx`` circuit (the precondition
of the card's in-circuit verification of an SDK proof, chip_smoke.py
phase 5d), and its public inputs are the native prover's.
``prover="circuit"`` with no card raises and does not prove on the CPU.
"""

import os
import random

import numpy as np
import pytest
import torch

from aztec_tpu.crypto import aes128 as ref_aes
from aztec_tpu.sdk import core_sdk as ref_core
from aztec_tpu.sdk import note_store as ref_notes
from aztec_tpu.sdk import viewing_key as ref_vk
from aztec_tpu.rollup import notes_native as ref_nn
from aztec_tpu.rollup.inner_proof_data import InnerProofFields as F
from aztec_tpu.rollup.notes_native import ValueNote as RefValueNote
from aztec_tpu.sequencer.blockchain import LocalBlockchain as RefChain
from aztec_tpu.sequencer.rollup_pipeline import (
    RollupPipeline as RefPipeline, SequencerConfig as RefConfig)
from aztec_tpu_torch.crypto import aes128
from aztec_tpu_torch.rollup.notes_native import ValueNote
from aztec_tpu_torch.sdk import CoreSdk, note_store, viewing_key
from aztec_tpu_torch.sequencer.blockchain import LocalBlockchain
from aztec_tpu_torch.sequencer.rollup_pipeline import (RollupPipeline,
                                                       SequencerConfig)
from test_sequencer import MockProofGenerator as RefMock
from test_torch_sequencer import MockProofGenerator

SEED = 20261018
KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
SELECTORS = ("q_m", "q_c", "q_1", "q_2", "q_3", "q_4", "q_5", "q_arith",
             "q_ecc_1", "q_range", "q_logic")


# -- AES-128 -------------------------------------------------------------------

def test_fips197_block_vector():
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    w = aes128._expand_key(KEY)
    ct = aes128._encrypt_block(pt, w)
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    assert aes128._decrypt_block(ct, w) == pt
    assert w == ref_aes._expand_key(KEY)


@pytest.mark.parametrize("blocks", [1, 5, 16])
def test_cbc_matches_reference(blocks):
    rng = random.Random(SEED + blocks)
    key, iv, data = rng.randbytes(16), rng.randbytes(16), \
        rng.randbytes(16 * blocks)
    ct = aes128.encrypt_cbc(data, key, iv)
    assert ct == ref_aes.encrypt_cbc(data, key, iv) != data
    assert aes128.decrypt_cbc(ct, key, iv) == data
    wrong = rng.randbytes(16 * blocks)
    assert aes128.decrypt_cbc(wrong, key, iv) == \
        ref_aes.decrypt_cbc(wrong, key, iv)


# -- keys and viewing keys -----------------------------------------------------

def test_derive_keys_match_reference():
    for seed in (b"alice", b"bob", random.Random(SEED).randbytes(32)):
        assert viewing_key.derive_keys(seed) == ref_vk.derive_keys(seed)


def test_viewing_key_matches_reference():
    priv, pub = viewing_key.derive_keys(b"owner seed")
    note = ValueNote(1234, 1, 7, pub, 0x5EC1E7)
    vk = viewing_key.encrypt_note_for(note, pub, eph_priv=0x1234)
    ref = ref_vk.encrypt_note_for(RefValueNote(1234, 1, 7, pub, 0x5EC1E7),
                                  pub, eph_priv=0x1234)
    buf = vk.to_buffer()
    assert buf == ref.to_buffer()
    assert len(buf) == viewing_key.ViewingKey.WIRE_LEN
    got = viewing_key.try_decrypt_note(
        viewing_key.ViewingKey.from_buffer(buf), priv, pub)
    assert (got.value, got.asset_id, got.nonce, got.secret) == \
        (1234, 1, 7, 0x5EC1E7)
    other_priv, other_pub = viewing_key.derive_keys(b"other")
    assert viewing_key.try_decrypt_note(vk, other_priv, other_pub) is None
    # the ephemeral key is drawn from the given source, 32 bytes
    draws = []

    def source(n):
        draws.append(n)
        return (0x1234).to_bytes(n, "big")

    assert viewing_key.encrypt_note_for(
        note, pub, randbytes=source).to_buffer() == buf
    assert draws == [32]


def test_note_picker_matches_reference():
    _, pub = viewing_key.derive_keys(b"u")
    rng = random.Random(SEED)
    values = [rng.randrange(1, 60) for _ in range(7)]
    mine, theirs = note_store.NoteStore(), ref_notes.NoteStore()
    for i, v in enumerate(values):
        mine.add(note_store.Note(ValueNote(v, 0, 0, pub, 1 + i), index=i))
        theirs.add(ref_notes.Note(RefValueNote(v, 0, 0, pub, 1 + i),
                                  index=i))
    assert mine.balance(0) == theirs.balance(0) == sum(values)
    for want in range(0, sum(values) + 2, 3):
        a, b = mine.pick(0, want), theirs.pick(0, want)
        assert (a is None) == (b is None), want
        if a is not None:
            assert [n.index for n in a] == [n.index for n in b]
    small = note_store.NoteStore()
    for i, v in enumerate([5, 30, 50]):
        small.add(note_store.Note(ValueNote(v, 0, 0, pub, 1 + i), index=i))
    assert [n.note.value for n in small.pick(0, 40)] == [50]
    assert sorted(n.note.value for n in small.pick(0, 60)) == [30, 50]
    assert small.pick(0, 90) is None


# -- deposit -> transfer -> withdraw ------------------------------------------

DEPTH = 4


def _story(sdk, pipeline):
    """tests/test_sdk.py's story; the requests and balances after each
    sync, and the insufficient-funds rejection; the requests and alice."""
    alice = sdk.add_user(b"alice")
    bob = sdk.add_user(b"bob")
    out = [sdk.data_tree.root == pipeline.world_state.data_root()]
    reqs = []
    steps = ((alice, dict(public_input=100, tx_fee=10)),
             (alice, dict(transfer=30, recipient=bob.pub, tx_fee=10)),
             (bob, dict(public_output=20, tx_fee=10)))
    for user, kw in steps:
        req = sdk.create_join_split(user, **kw)
        reqs.append(req)
        sdk.submit(req, pipeline.tx_receiver)
        ticked = pipeline.coordinator.tick()
        sdk.sync(pipeline.blockchain)
        out.append((req.proof_data, req.viewing_keys, ticked,
                    sdk.data_tree.root == pipeline.world_state.data_root(),
                    alice.balance(), bob.balance()))
    with pytest.raises(ValueError) as e:
        sdk.create_join_split(alice, transfer=80, tx_fee=0)
    out.append(str(e.value))
    return out, reqs, alice


def _config(cls):
    return cls(num_inner_rollup_txs=1, num_outer_rollup_proofs=1,
               publish_interval_s=1000.0, data_tree_depth=DEPTH)


@pytest.fixture(scope="module")
def stories():
    port = _story(
        CoreSdk(data_tree_depth=DEPTH, prover="native",
                randbytes=random.Random(SEED).randbytes),
        RollupPipeline(_config(SequencerConfig), MockProofGenerator(),
                       blockchain=LocalBlockchain()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "urandom", random.Random(SEED).randbytes)
        ref = _story(
            ref_core.CoreSdk(data_tree_depth=DEPTH, prover="native"),
            RefPipeline(_config(RefConfig), RefMock(),
                        blockchain=RefChain()))
    return port, ref


def test_story_balances(stories):
    port, ref = stories[0][0], stories[1][0]
    assert port[0] and ref[0]
    assert [s[2:] for s in port[1:4]] == [(True, True, 90, 0),
                                          (True, True, 50, 30),
                                          (True, True, 50, 0)]
    assert [s[2:] for s in port[1:4]] == [s[2:] for s in ref[1:4]]
    assert port[4] == ref[4] == "insufficient funds"


@pytest.mark.parametrize("step", ["transfer", "withdraw"])
def test_story_bytes_match_reference(stories, step):
    i = 1 + ("deposit", "transfer", "withdraw").index(step)
    port, ref = stories[0][0][i], stories[1][0][i]
    assert len(port[0]) == 14 * 32 + 64
    assert len(port[1]) == 2 * viewing_key.ViewingKey.WIRE_LEN
    assert port[:2] == ref[:2]
    assert stories[0][1][i - 1].tx.input_index == \
        stories[1][1][i - 1].tx.input_index


def test_story_deposit_bytes_but_the_padding_index(stories):
    """The port pads a deposit's inputs at indices (0, 1), where
    aztec_tpu pads both at 0 (which its circuit refuses: "joining same
    note"); so the second nullifier is aztec_tpu's own nullifier of the
    same gibberish note at index 1, and every other byte is equal."""
    port, ref = stories[0][1][0], stories[1][1][0]
    alice = stories[1][2]
    assert port.tx.input_index == (0, 1) and ref.tx.input_index == (0, 0)
    assert port.viewing_keys == ref.viewing_keys
    nul = ref_nn.compute_nullifier(ref_nn.encrypt_note(ref.tx.input_note[1]),
                                   1, alice.priv, False)
    want = bytearray(ref.proof_data)
    want[F.NULLIFIER2 * 32:(F.NULLIFIER2 + 1) * 32] = nul.to_bytes(32, "big")
    assert port.proof_data == bytes(want) != ref.proof_data


def test_random_source_draws_in_reference_order():
    """A deposit draws two gibberish notes' secrets, the two output notes'
    secrets and the signature's nonce (31 bytes each), then the two
    viewing keys' ephemeral keys (32 each)."""
    draws = []
    rng = random.Random(SEED)

    def source(n):
        draws.append(n)
        return rng.randbytes(n)

    sdk = CoreSdk(data_tree_depth=3, prover="native", randbytes=source)
    sdk.create_join_split(sdk.add_user(b"alice"), public_input=100,
                          tx_fee=10)
    assert draws == [31] * 5 + [32] * 2


# -- the deposit's circuit, without proving -----------------------------------

@pytest.fixture(scope="module")
def deposit_circuits():
    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.rollup.circuit_data import noop_join_split_tx
    from aztec_tpu_torch.rollup.join_split import join_split_circuit

    caught = []

    def catch(tx):
        caught.append(tx)
        return b""

    sdk = CoreSdk(data_tree_depth=3, proof_fn=catch,
                  randbytes=random.Random(SEED).randbytes)
    sdk.create_join_split(sdk.add_user(b"alice"), public_input=100,
                          tx_fee=10)
    native = CoreSdk(data_tree_depth=3, prover="native",
                     randbytes=random.Random(SEED).randbytes)
    req = native.create_join_split(native.add_user(b"alice"),
                                   public_input=100, tx_fee=10)
    out = {}
    for name, tx in (("deposit", caught[0]), ("noop", noop_join_split_tx(3))):
        c = TurboComposer(device="cpu")
        join_split_circuit(c, tx)
        out[name] = c
    return out, req.proof_data


def test_deposit_circuit_has_the_padding_circuit_gates(deposit_circuits):
    from aztec_tpu_torch.plonk.circuit_check import check_turbo

    (circuits, _) = deposit_circuits
    dep, noop = circuits["deposit"], circuits["noop"]
    assert not dep.failed and not noop.failed, (dep.err, noop.err)
    assert check_turbo(dep) == []
    assert dep.n == noop.n
    assert len(dep.public_inputs) == len(noop.public_inputs) == 14
    for name in SELECTORS:
        assert getattr(dep, name) == getattr(noop, name), name
    size = dep.subgroup_size()
    assert size == noop.subgroup_size()
    for a, b in zip(dep.compute_sigma_mappings(size, 4),
                    noop.compute_sigma_mappings(size, 4)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_deposit_public_inputs_are_the_native_prefix(deposit_circuits):
    (circuits, native) = deposit_circuits
    dep = circuits["deposit"]
    values = b"".join(dep.get_variable(i).to_bytes(32, "big")
                      for i in dep.public_inputs)
    assert values == native[:14 * 32]


def test_circuit_prover_refuses_missing_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from aztec_tpu_torch.plonk import composer

    def no_cpu_proof(self):
        raise AssertionError("proved on the CPU")

    monkeypatch.setattr(composer.TurboComposer, "create_unrolled_prover",
                        no_cpu_proof)
    sdk = CoreSdk(data_tree_depth=3, prover="circuit",
                  randbytes=random.Random(SEED).randbytes)
    with pytest.raises(RuntimeError, match="CUDA"):
        sdk.create_join_split(sdk.add_user(b"alice"), public_input=100,
                              tx_fee=10)
