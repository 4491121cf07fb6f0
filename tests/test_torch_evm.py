"""The port's EVM layer (aztec_tpu_torch.evm, contracts/evm_verifier.py)
against aztec_tpu's, on the CPU.

- The assembler: a seeded program of pushes, labels and jumps assembles to
  the same bytes.
- The interpreter: short programs (256-bit arithmetic, ``ADDMOD``,
  ``MULMOD``, ``EXP``, ``SHL``/``SHR``, ``KECCAK256``, reverts, faults) and
  the precompiles (SHA-256, ``MODEXP``, ``ecAdd``, ``ecMul``,
  ``ecPairing`` on known points) give equal return data, gas and reverts in
  both interpreters.
- The generator: for the VK of ``tests/torch_vectors/turbo_drive.json``
  (aztec_tpu's Keccak Turbo proof of tests/test_turbo.py's circuit) and the
  root-rollup VK of ``rollup_tower.json`` (the port's 2^24 root proof from
  the card, 42 public inputs) both packages emit the same bytes; each
  proof is accepted in both interpreters at the same gas, seeded
  mutations get the same verdict from both interpreters and the port's
  native verifier, and truncated calldata reverts.

The VKs come from the committed JSON: no VK or proof is computed here.
All checks are exact.
"""

import functools
import json
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402

from aztec_tpu.evm import EVM as RefEVM  # noqa: E402
from aztec_tpu.evm import Assembler as RefAssembler  # noqa: E402
from aztec_tpu_torch.evm import EVM, Assembler  # noqa: E402

SEED = 20261018
FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
FQ_MOD = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
ROOT_CODE_BYTES = 51612
ROOT_GAS = 370487


def _seeded_program(asm_cls, rng: random.Random):
    """Pushes of every width, labels, forward and backward jumps."""
    a = asm_cls()
    labels = [a.new_label() for _ in range(6)]
    for i, name in enumerate(labels):
        for _ in range(rng.randrange(1, 5)):
            a.push(rng.getrandbits(rng.choice((1, 8, 64, 160, 256))))
            a.emit(rng.choice(("ADD", "MUL", "XOR", "POP", "DUP1", "SWAP1")))
        a.label(name)
        a.jumpi(labels[(i + 3) % len(labels)])
        a.jump(labels[(i + 1) % len(labels)])
    a.push(0).push(0).emit("RETURN")
    return a.assemble()


def test_assembler_same_bytes():
    mine = _seeded_program(Assembler, random.Random(SEED))
    theirs = _seeded_program(RefAssembler, random.Random(SEED))
    assert mine == theirs
    assert len(mine) > 100


def _outcome(evm_cls, code: bytes, calldata: bytes = b""):
    """(kind, return or revert data or fault, gas) of one run."""
    evm = evm_cls()
    try:
        out = evm.run(code, calldata)
        return "return", out, evm.gas_used
    except Exception as e:  # EvmRevert carries data; EvmError a message
        return type(e).__name__, getattr(e, "data", str(e)), evm.gas_used


def _arith_program(rng: random.Random) -> bytes:
    """Seeded ADDMOD / MULMOD / EXP / SHL / SHR / DIV / MOD / BYTE results
    stored in memory, their KECCAK256 appended, all returned."""
    a = Assembler()
    slot = 0
    ops = (("ADDMOD", 3), ("MULMOD", 3), ("EXP", 2), ("SHL", 2), ("SHR", 2),
           ("DIV", 2), ("MOD", 2), ("BYTE", 2), ("SUB", 2), ("LT", 2),
           ("GT", 2), ("EQ", 2), ("ISZERO", 1), ("NOT", 1), ("AND", 2),
           ("OR", 2))
    for op, argc in ops * 3:
        for k in range(argc):
            if op in ("SHL", "SHR", "BYTE") and k == argc - 1:
                v = rng.choice((0, 1, 31, 200, 255, 256, 300))
            elif op == "EXP" and k == 0:
                v = rng.getrandbits(rng.choice((8, 40)))
            elif op in ("ADDMOD", "MULMOD", "DIV", "MOD") and k == 0:
                v = rng.choice((0, FR_MOD, rng.getrandbits(256)))
            else:
                v = rng.getrandbits(256)
            a.push(v)
        a.emit(op)
        a.push(32 * slot).emit("MSTORE")
        slot += 1
    a.push(32 * slot).push(0).emit("KECCAK256")
    a.push(32 * slot).emit("MSTORE")
    a.emit("MSIZE").push(0).emit("RETURN")
    return a.assemble()


def _revert_program() -> bytes:
    a = Assembler()
    a.push(0xDEADBEEF).push(0).emit("MSTORE")
    a.push(32).push(0).emit("REVERT")
    return a.assemble()


def _bad_jump_program() -> bytes:
    return Assembler().push(3).emit("JUMP").push(0).emit("STOP").assemble()


@pytest.mark.parametrize("name,code", (
    ("arith_1", _arith_program(random.Random(SEED + 1))),
    ("arith_2", _arith_program(random.Random(SEED + 2))),
    ("revert", _revert_program()),
    ("bad_jump", _bad_jump_program()),
    ("underflow", bytes([0x01])),
    ("invalid", bytes([0xFE])),
))
def test_interpreter_programs_as_reference(name, code):
    mine = _outcome(EVM, code)
    assert mine == _outcome(RefEVM, code)
    assert mine[0] == {"revert": "EvmRevert", "bad_jump": "EvmError",
                       "underflow": "EvmError",
                       "invalid": "EvmError"}.get(name, "return")


def _precompile_program(addr: int, in_size: int, out_size: int) -> bytes:
    """Calldata -> memory, STATICCALL(addr) into 0x1000, return the success
    word and the output."""
    a = Assembler()
    a.push(in_size).push(0).push(0).emit("CALLDATACOPY")
    a.push(out_size).push(0x1000).push(in_size).push(0).push(addr)
    a.emit("GAS").emit("STATICCALL")
    a.push(0x1000 - 32).emit("MSTORE")
    a.push(32 + out_size).push(0x1000 - 32).emit("RETURN")
    return a.assemble()


def _w(*vals) -> bytes:
    return b"".join(v.to_bytes(32, "big") for v in vals)


def _g2_words(q) -> bytes:
    (xr, xi), (yr, yi) = q
    return _w(xi, xr, yi, yr)


def _precompile_cases():
    from aztec_tpu_torch.curves import pairing, tower

    g = (1, 2)
    g2 = pairing.g1_mul(2, g)
    neg = pairing.g1_neg(g2)
    q = tower.G2_GEN
    q3 = tower.g2_mul(3, q)
    rng = random.Random(SEED + 3)
    return {
        "sha256": (2, rng.randbytes(77), 32),
        "modexp": (5, _w(32, 32, 32, rng.getrandbits(256), FR_MOD - 2, FR_MOD),
                   32),
        "modexp_zero_mod": (5, _w(32, 32, 32, 7, 5, 0), 32),
        "ecadd": (6, _w(*g, *g2), 64),
        "ecadd_infinity": (6, _w(*g2, *neg), 64),
        "ecadd_off_curve": (6, _w(1, 3, *g), 64),
        "ecmul": (7, _w(*g, rng.getrandbits(256)), 64),
        "ecmul_order": (7, _w(*g2, FR_MOD), 64),
        "ecpairing_one": (8, _w(*g2) + _g2_words(q3)
                          + _w(*pairing.g1_mul(6, g)) + _g2_words(
                              tower.g2_neg(q)), 32),
        "ecpairing_not_one": (8, _w(*g2) + _g2_words(q3)
                              + _w(*g) + _g2_words(q), 32),
        "ecpairing_bad_length": (8, _w(*g), 32),
    }


PRECOMPILE_EXPECT = {"ecadd_infinity": _w(0, 0), "ecpairing_one": _w(1),
                     "ecpairing_not_one": _w(0)}


@pytest.mark.parametrize("name", sorted(_precompile_cases()))
def test_precompiles_as_reference(name):
    addr, data, out_size = _precompile_cases()[name]
    code = _precompile_program(addr, len(data), out_size)
    mine = _outcome(EVM, code, data)
    assert mine == _outcome(RefEVM, code, data)
    kind, out, gas = mine
    assert kind == "return" and gas > 700
    ok = int.from_bytes(out[:32], "big")
    assert ok == (0 if name.endswith(("off_curve", "bad_length")) else 1)
    if name in PRECOMPILE_EXPECT:
        assert out[32:] == PRECOMPILE_EXPECT[name]


# -- the generated verifier --------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cases():
    """name -> (the port's VK, aztec_tpu's VK, proof bytes)."""
    from aztec_tpu.plonk import manifests as ref_manifests
    from aztec_tpu.plonk.proving_key import \
        VerificationKey as RefVerificationKey
    from aztec_tpu.utils.fixtures import vk_from_json as ref_vk_from_json
    from aztec_tpu_torch.plonk import manifests
    from aztec_tpu_torch.plonk.proving_key import VerificationKey
    from aztec_tpu_torch.poly.domain import EvaluationDomain
    from aztec_tpu_torch.srs.reference_string import \
        FakeReferenceStringFactory
    from aztec_tpu_torch.utils.fixtures import vk_from_json

    rec, _ = plonk_cases.load_vector("turbo_drive")
    fields = dict(
        n=rec["n"], num_public_inputs=len(rec["public_inputs"]),
        commitments=plonk_cases.vk_ints(rec),
        domain_root=EvaluationDomain(rec["n"], device="cpu").root,
        g2_x=FakeReferenceStringFactory(device="cpu").get_verifier_srs().g2_x)
    tower, _ = plonk_cases.load_vector("rollup_tower")
    return {
        "turbo_drive": (VerificationKey(settings=manifests.TURBO, **fields),
                        RefVerificationKey(settings=ref_manifests.TURBO,
                                           **fields),
                        bytes.fromhex(rec["proof"])),
        "root_rollup": (vk_from_json(tower["root"]["vk"]),
                        ref_vk_from_json(tower["root"]["vk"]),
                        bytes.fromhex(tower["root"]["proof"])),
    }


@functools.lru_cache(maxsize=None)
def _code(name: str) -> bytes:
    from aztec_tpu_torch.contracts.evm_verifier import generate_verifier

    return generate_verifier(_cases()[name][0])


@pytest.mark.parametrize("name", ("turbo_drive", "root_rollup"))
def test_generator_bytes_equal_reference(name):
    from aztec_tpu.contracts.evm_verifier import \
        generate_verifier as ref_generate

    code = _code(name)
    assert code == ref_generate(_cases()[name][1])
    if name == "root_rollup":
        assert len(code) == ROOT_CODE_BYTES


@pytest.mark.parametrize("name", ("turbo_drive", "root_rollup"))
def test_generated_verifier_accepts_in_both(name):
    proof = _cases()[name][2]
    mine = _outcome(EVM, _code(name), proof)
    assert mine == _outcome(RefEVM, _code(name), proof)
    assert mine[:2] == ("return", _w(1))
    if name == "root_rollup":
        assert mine[2] == ROOT_GAS


def test_mutations_same_verdict():
    """Four seeded one-bit mutations of the Turbo drive proof (one in its
    public input): the same outcome in both interpreters, and the port's
    native verifier agrees with the verdict."""
    from aztec_tpu_torch.plonk.flavors import TurboFlavor
    from aztec_tpu_torch.plonk.verifier import Verifier

    vk, _, proof = _cases()["turbo_drive"]
    code = _code("turbo_drive")
    native = Verifier(vk, TurboFlavor)
    rng = random.Random(SEED + 4)
    positions = [rng.randrange(32)] + [rng.randrange(32, len(proof))
                                       for _ in range(3)]
    for pos in positions:
        bad = bytearray(proof)
        bad[pos] ^= 1 << rng.randrange(8)
        mine = _outcome(EVM, code, bytes(bad))
        assert mine == _outcome(RefEVM, code, bytes(bad)), pos
        accepted = mine[:2] == ("return", _w(1))
        assert not accepted, pos
        assert native.verify_proof(bytes(bad)) is False, pos


def test_truncated_calldata_reverts():
    proof = _cases()["turbo_drive"][2]
    mine = _outcome(EVM, _code("turbo_drive"), proof[:-1])
    assert mine == _outcome(RefEVM, _code("turbo_drive"), proof[:-1])
    assert mine[0] == "EvmRevert"


def test_root_vk_carries_recursion():
    """The root VK folds a recursion output into its pairing natively;
    the bytecode (aztec_tpu's, byte for byte) does not read the flag."""
    vk = _cases()["root_rollup"][0]
    assert vk.contains_recursive_proof and vk.num_public_inputs == 42
    assert json.loads(plonk_cases.load_vector("rollup_tower")[0]["root"]
                      ["vk"])["contains_recursive_proof"] is True
