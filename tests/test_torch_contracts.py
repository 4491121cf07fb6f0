"""The port's on-chain layer (aztec_tpu_torch.contracts) against
aztec_tpu's, on the CPU.

- ``RollupProcessor``: the scripts of tests/test_contracts.py (escrow and
  withdrawals through the sequencer's pipeline over a mock proof worker,
  an insufficient deposit, two chained rollups, provider gating and the
  escape-hatch window, bad chaining, an escape-hatch submission) run on
  both packages, the port's pipeline over the port's mock
  (tests/test_torch_sequencer.py) and aztec_tpu's over its own
  (tests/test_sequencer.py); the processors' escrow, balances, totals,
  roots, ids, events and blocks (timestamps left out) are equal after
  every step, and the reference's own assertions hold on the port.
- A processor whose ``verify_proof`` is the bytecode of the port's
  ``generate_verifier`` run in the port's ``EVM`` settles the committed
  root-rollup proof (``tests/torch_vectors/rollup_tower.json``, the port's
  2^24 proof from the card): its roots come out as the proof publishes
  them, and a tampered copy is refused without a change of state.
- ``write_verifier_sources`` writes the five files aztec_tpu writes, byte
  for byte, for the same VK (the committed root VK: no VK is computed).
- ``solidity_challenges`` (TurboVerifier.sol's Fiat-Shamir) equals the
  port's ``Transcript`` and aztec_tpu's ``solidity_challenges``.

All checks are exact.
"""

import functools
import os
import random
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402

SEED = 20261018
FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def _side(pkg: str) -> SimpleNamespace:
    import importlib

    mod = lambda name: importlib.import_module(pkg + name)  # noqa: E731
    if pkg == "aztec_tpu":
        from test_sequencer import MockProofGenerator, make_tx_proof
    else:
        from test_torch_sequencer import MockProofGenerator, make_tx_proof
    return SimpleNamespace(
        contracts=mod(".contracts"),
        processor=mod(".contracts.rollup_processor"),
        pipeline=mod(".sequencer.rollup_pipeline"),
        F=mod(".rollup.inner_proof_data").InnerProofFields,
        Mock=MockProofGenerator, make_tx_proof=make_tx_proof)


def _state(proc) -> dict:
    return {
        "pending": dict(proc.user_pending_deposits),
        "balances": dict(proc.user_balances),
        "totals": (list(proc.total_deposited), list(proc.total_withdrawn),
                   list(proc.total_fees)),
        "roots": (proc.data_root, proc.null_root, proc.root_root),
        "ids": (proc.data_size, proc.next_rollup_id, proc.block_height),
        "events": list(proc.events),
        "blocks": [(b.rollup_id, b.tx_hash, b.rollup_proof_data,
                    b.data_start_index, b.tx_datas, b.viewing_keys)
                   for b in proc.blocks],
    }


def _env(s, **cfg):
    config = s.pipeline.SequencerConfig(publish_interval_s=1000.0, **cfg)
    proc = s.contracts.RollupProcessor()
    return s.pipeline.RollupPipeline(config, s.Mock(), blockchain=proc), proc


def _setf(buf, i, v):
    buf[i * 32:(i + 1) * 32] = v.to_bytes(32, "big")


def _header_proof(head) -> bytes:
    return b"".join(v.to_bytes(32, "big") for v in head) + bytes(12 * 32)


def script_deposit_withdraw(s):
    p, proc = _env(s, num_inner_rollup_txs=2, num_outer_rollup_proofs=1)
    ws, F = p.world_state, s.F
    proc.deposit_pending_funds(1, 100, format(0xAA, "x"))
    states = [_state(proc)]
    assert proc.get_user_pending_deposit(1, "aa") == 100
    dep = bytearray(s.make_tx_proof(ws, 1, 2))
    _setf(dep, F.PUBLIC_INPUT, 60)
    _setf(dep, F.ASSET_ID, 1)
    _setf(dep, F.INPUT_OWNER, 0xAA)
    wd = bytearray(s.make_tx_proof(ws, 3, 4))
    _setf(wd, F.PUBLIC_OUTPUT, 30)
    _setf(wd, F.ASSET_ID, 1)
    _setf(wd, F.OUTPUT_OWNER, 0xBB)
    p.tx_receiver.receive_tx(bytes(dep))
    p.tx_receiver.receive_tx(bytes(wd))
    assert p.coordinator.tick()
    states.append(_state(proc))
    assert proc.get_user_pending_deposit(1, "aa") == 40
    assert proc.get_user_balance(1, "bb") == 30
    assert proc.next_rollup_id == 1
    assert proc.data_root == ws.data_root()
    assert ("RollupProcessed", 0, proc.data_root, proc.null_root,
            proc.root_root) in proc.events
    return states


def script_insufficient_deposit(s):
    p, proc = _env(s, num_inner_rollup_txs=1, num_outer_rollup_proofs=1)
    dep = bytearray(s.make_tx_proof(p.world_state, 1, 2))
    _setf(dep, s.F.PUBLIC_INPUT, 60)
    _setf(dep, s.F.INPUT_OWNER, 0xAA)
    p.tx_receiver.receive_tx(bytes(dep))
    assert not p.coordinator.tick()
    assert p.db.get_pending_tx_count() == 1
    assert proc.next_rollup_id == 0
    return [_state(proc)]


def script_two_rollups(s):
    p, proc = _env(s, num_inner_rollup_txs=1, num_outer_rollup_proofs=1)
    ws = p.world_state
    states = []
    for n1, n2 in ((1, 2), (3, 4)):
        p.tx_receiver.receive_tx(s.make_tx_proof(ws, n1, n2))
        assert p.coordinator.tick()
        states.append(_state(proc))
    assert proc.next_rollup_id == 2
    assert proc.data_root == ws.data_root()
    assert len(proc.blocks) == 2
    return states


def script_provider_gating(s):
    proc = s.contracts.RollupProcessor()
    with pytest.raises(s.processor.RollupProcessorError,
                       match="INVALID_PROVIDER"):
        proc.process_rollup(bytes(32 * 20), provider="mallory")
    states = [proc.get_escape_hatch_status()]
    proc.block_height = 85
    states.append(proc.get_escape_hatch_status())
    assert states == [(False, 80), (True, 15)]
    proc.set_rollup_provider("mallory", True)
    states.append(_state(proc))
    return states


def script_bad_chaining(s):
    proc = s.contracts.RollupProcessor()
    proc.process_rollup(_header_proof([0, 1, 0, 11, 22, 33, 44, 55, 66]
                                      + [0] * 4 + [1]))
    states = [_state(proc)]
    for head, match in (
            ([1, 1, 2, 999, 23, 44, 45, 66, 77], "INCORRECT_DATA_ROOT"),
            ([1, 1, 5, 22, 23, 44, 45, 66, 77], "INCORRECT_DATA_START_INDEX"),
            ([2, 1, 2, 22, 23, 44, 45, 66, 77], "INCORRECT_ROLLUP_ID"),
            ([1, 1, 2, 22, 23, 45, 45, 66, 77], "INCORRECT_NULL_ROOT"),
            ([1, 1, 2, 22, 23, 44, 45, 67, 77], "INCORRECT_ROOT_ROOT")):
        with pytest.raises(s.processor.RollupProcessorError, match=match):
            proc.process_rollup(_header_proof(head + [0] * 4 + [1]))
        states.append(_state(proc))
    return states


def script_escape_hatch(s):
    proc = s.contracts.RollupProcessor()
    proof = _header_proof([0, 1, 0, 11, 22, 33, 44, 55, 66] + [0] * 4 + [1])
    with pytest.raises(s.processor.RollupProcessorError,
                       match="ESCAPE_BLOCK_RANGE"):
        proc.escape_hatch(proof)
    proc.block_height = 85
    proc.escape_hatch(proof)
    assert proc.next_rollup_id == 1
    # the sequencer's protocol: a refused rollup is an event, not a block
    assert proc.send_rollup(1, proof) is None
    return [_state(proc)]


SCRIPTS = {f.__name__[len("script_"):]: f for f in (
    script_deposit_withdraw, script_insufficient_deposit, script_two_rollups,
    script_provider_gating, script_bad_chaining, script_escape_hatch)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_processor_script_as_reference(name):
    mine = SCRIPTS[name](_side("aztec_tpu_torch"))
    theirs = SCRIPTS[name](_side("aztec_tpu"))
    assert mine == theirs


# -- the root proof through the bytecode -------------------------------------

@functools.lru_cache(maxsize=None)
def _root():
    from aztec_tpu_torch.utils.fixtures import vk_from_json

    tower, _ = plonk_cases.load_vector("rollup_tower")
    return vk_from_json(tower["root"]["vk"]), bytes.fromhex(
        tower["root"]["proof"]), tower["root"]["vk"]


def test_processor_settles_root_proof_through_bytecode():
    from aztec_tpu_torch.contracts import (RollupProcessor,
                                           RollupProcessorError,
                                           RollupProofData)
    from aztec_tpu_torch.contracts.evm_verifier import generate_verifier
    from aztec_tpu_torch.evm import EVM, EvmRevert

    vk, proof, _ = _root()
    code = generate_verifier(vk)
    runs = []

    def evm_verify(data: bytes) -> bool:
        evm = EVM()
        try:
            ok = int.from_bytes(evm.run(code, data), "big") == 1
        except EvmRevert:
            ok = False
        runs.append((ok, evm.gas_used))
        return ok

    proc = RollupProcessor(verify_proof=evm_verify)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(RollupProcessorError, match="verification failed"):
        proc.process_rollup(bytes(bad))
    assert proc.next_rollup_id == 0 and proc.data_root is None
    assert proc.send_rollup(0, proof, 0, [b"tx"], [[b"vk"]]) is not None
    d = RollupProofData(proof)
    assert (proc.data_root, proc.null_root, proc.root_root) == (
        d.new_data_root, d.new_null_root, d.new_root_root)
    assert proc.next_rollup_id == 1 and proc.data_size == 2
    assert proc.events[-1] == ("RollupProcessed", 0, d.new_data_root,
                               d.new_null_root, d.new_root_root)
    assert [b.rollup_id for b in proc.get_blocks(0)] == [0]
    assert [ok for ok, _ in runs] == [False, True]
    assert runs[1][1] == 370487


# -- the Solidity tree and its transcript ------------------------------------

def test_verifier_sources_byte_identical(tmp_path):
    from aztec_tpu.contracts.sol_verifier import \
        write_verifier_sources as ref_write
    from aztec_tpu.utils.fixtures import vk_from_json as ref_vk_from_json
    from aztec_tpu_torch.contracts.sol_verifier import write_verifier_sources

    vk, _, vk_json = _root()
    mine = write_verifier_sources(str(tmp_path / "port"), vk, "RootRollup")
    theirs = ref_write(str(tmp_path / "ref"), ref_vk_from_json(vk_json),
                       "RootRollup")
    rel = lambda paths, base: [os.path.relpath(p, str(tmp_path / base))  # noqa: E731
                               for p in paths]
    assert rel(mine, "port") == rel(theirs, "ref")
    assert set(rel(mine, "port")) == {
        "cryptography/Types.sol", "cryptography/Bn254Crypto.sol",
        "cryptography/TurboVerifier.sol", "keys/RootRollupVk.sol",
        "RootRollupVerifier.sol"}
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    for f in mine:
        src = open(f).read()
        assert src.count("{") == src.count("}"), f
        assert src.count("(") == src.count(")"), f
        assert "pragma solidity" in src
    vk_src = open(str(tmp_path / "port" / "keys/RootRollupVk.sol")).read()
    assert f"mstore(add(vk, 0x00), {vk.n})" in vk_src


EVAL_ORDER = ("w_1", "w_2", "w_3", "w_4", "sigma_1", "sigma_2", "sigma_3",
              "q_arith", "q_ecc_1", "q_c", "r", "z_omega", "w_1_omega",
              "w_2_omega", "w_3_omega", "w_4_omega")
G1S = ("W_1", "W_2", "W_3", "W_4", "Z", "T_1", "T_2", "T_3", "T_4",
       "PI_Z", "PI_Z_OMEGA")


@pytest.mark.parametrize("num_pub,n", ((3, 64), (42, 1 << 24)))
def test_solidity_challenges_match_transcript(num_pub, n):
    from aztec_tpu.contracts.sol_verifier import \
        solidity_challenges as ref_challenges
    from aztec_tpu_torch.contracts.sol_verifier import solidity_challenges
    from aztec_tpu_torch.plonk.manifests import turbo_manifest
    from aztec_tpu_torch.plonk.serialize import u32_to_bytes
    from aztec_tpu_torch.transcript.transcript import Transcript

    rng = random.Random(SEED + num_pub)
    manifest = turbo_manifest(num_pub)
    t = Transcript(manifest, hasher="keccak256", num_challenge_bytes=32)
    pub_bytes = rng.randbytes(32 * num_pub)
    g1s = {k: rng.randbytes(64) for k in G1S}
    evals = {k: rng.randrange(FR_MOD) for k in EVAL_ORDER}
    t_eval = rng.randrange(FR_MOD)
    t.add_element("circuit_size", u32_to_bytes(n))
    t.add_element("public_input_size", u32_to_bytes(num_pub))
    t.apply_fiat_shamir("init")
    t.apply_fiat_shamir("eta")
    t.add_element("public_inputs", pub_bytes)
    for k in ("W_1", "W_2", "W_3", "W_4"):
        t.add_element(k, g1s[k])
    t.apply_fiat_shamir("beta")
    t.add_element("Z", g1s["Z"])
    t.apply_fiat_shamir("alpha")
    for k in ("T_1", "T_2", "T_3", "T_4"):
        t.add_element(k, g1s[k])
    t.apply_fiat_shamir("z")
    t.add_element("t", t_eval.to_bytes(32, "big"))
    for k in EVAL_ORDER:
        t.add_element(k, evals[k].to_bytes(32, "big"))
    t.apply_fiat_shamir("nu")
    t.add_element("PI_Z", g1s["PI_Z"])
    t.add_element("PI_Z_OMEGA", g1s["PI_Z_OMEGA"])
    t.apply_fiat_shamir("separator")

    args = (n, pub_bytes, g1s, t_eval, [evals[k] for k in EVAL_ORDER])
    sol = solidity_challenges(*args)
    assert sol == ref_challenges(*args)
    assert sol["beta"] == t.get_challenge_fr("beta", 0)
    assert sol["gamma"] == t.get_challenge_fr("beta", 1)
    assert sol["alpha"] == t.get_challenge_fr("alpha")
    assert sol["zeta"] == t.get_challenge_fr("z")
    assert sol["nu"] == [t.get_challenge_fr("nu", i) for i in range(11)]
    assert sol["separator"] == t.get_challenge_fr("separator")
    cmap = manifest.challenge_map()
    assert [cmap[k] for k in EVAL_ORDER] == \
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, -1, 0, 1, 2, 3]
    assert cmap["t"] == -1
