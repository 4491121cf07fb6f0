"""The port's SHA-256 circuit, bit and byte arrays and host hashes
(aztec_tpu_torch.stdlib.sha256_circuit, bit_array, packed_byte_array;
crypto.sha256, crypto.ecdsa) against aztec_tpu's, on the CPU.

- ``sha256_bytes`` over the messages of tests/test_sha256_circuit.py and
  the smoke's stdlib path at 247 bytes (``PackedByteArray`` ->
  ``to_unverified_byte_slices`` -> ``sha256_bytes``, the digest packed
  back into two public limbs): the same recorded circuit on both packages'
  ``TurboComposer`` (``make_vectors.gate_digest``), hashlib's digest,
  ``check_turbo`` clean on the port.
- The cases of tests/test_bit_packed.py on both packages: the same values
  and circuits, and the port's circuit clean (and failing after a
  tampered bit).
- ECDSA over secp256k1 and secp256r1: the same public keys and RFC 6979
  signatures from seeded keys and messages, verification and its
  refusals; the host SHA-256.

All checks are exact.
"""

import hashlib
import importlib
import os
import random
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
from make_vectors import gate_digest  # noqa: E402

SEED = 20261018
SIDES = ("aztec_tpu_torch", "aztec_tpu")


def _side(pkg: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(pkg + name)  # noqa: E731
    comp = mod(".plonk.composer")
    make = (comp.TurboComposer if pkg == "aztec_tpu"
            else lambda: comp.TurboComposer(device="cpu"))
    return SimpleNamespace(
        TurboComposer=make, check=mod(".plonk.circuit_check").check_turbo,
        FieldT=mod(".stdlib.field_t").FieldT,
        UInt32=mod(".stdlib.uint32").UInt32,
        BitArray=mod(".stdlib.bit_array").BitArray,
        Packed=mod(".stdlib.packed_byte_array").PackedByteArray,
        field_to_bytes=mod(".stdlib.byte_array").field_to_bytes,
        sha256_bytes=mod(".stdlib.sha256_circuit").sha256_bytes,
        ecdsa=mod(".crypto.ecdsa"), sha256=mod(".crypto.sha256").sha256)


def _both(fn):
    """fn(side) on each package: (the port's result, the reference's)."""
    return tuple(fn(_side(pkg)) for pkg in SIDES)


# -- sha256_bytes --------------------------------------------------------------

def _hash_bytes(s, msg: bytes):
    c = s.TurboComposer()
    byte_fs = []
    for b in msg:
        f = s.FieldT.from_witness(c, b)
        c.create_range_constraint(f.witness_index, 8)
        byte_fs.append(f)
    digest = s.sha256_bytes(c, byte_fs)
    return c, bytes(int(d.get_value()) for d in digest)


def _packed_path(s, msg: bytes):
    """The smoke's stdlib path: bytes packed 16 to a field element, sliced
    back to range-checked bytes, hashed, the digest packed into two public
    limbs."""
    c = s.TurboComposer()
    packed = s.Packed.from_bytes(c, msg)
    byte_fs = packed.to_unverified_byte_slices(1)
    for f in byte_fs:
        c.create_range_constraint(f.witness_index, 8)
    digest = s.sha256_bytes(c, byte_fs)
    out = s.Packed.from_field_slices(c, digest, 1)
    for limb in out.get_limbs():
        limb.set_public()
    return c, out.get_value()


MESSAGES = (b"", b"abc", b"a" * 55, b"b" * 64, b"c" * 100)


@pytest.mark.parametrize("msg", MESSAGES, ids=[str(len(m)) for m in MESSAGES])
def test_sha256_bytes_as_reference(msg):
    (mine, got), (theirs, ref) = _both(lambda s: _hash_bytes(s, msg))
    assert got == ref == hashlib.sha256(msg).digest()
    assert gate_digest(mine) == gate_digest(theirs)
    assert not mine.failed
    assert _side("aztec_tpu_torch").check(mine) == []


def test_packed_sha256_path_as_reference():
    msg = random.Random(SEED).randbytes(247)
    (mine, got), (theirs, ref) = _both(lambda s: _packed_path(s, msg))
    assert got == ref == hashlib.sha256(msg).digest()
    assert gate_digest(mine) == gate_digest(theirs)
    assert len(mine.public_inputs) == 2
    assert _side("aztec_tpu_torch").check(mine) == []


# -- bit_array and packed_byte_array (tests/test_bit_packed.py) ----------------

def case_bits_from_bytes(s):
    c = s.TurboComposer()
    data = b"\xde\xad\xbe\xef\x01\x02\x03\x80"
    ba = s.BitArray.from_bytes(c, data)
    assert len(ba) == 64 and ba.to_bytes_value() == data
    return c, ba.get_value()


def case_bits_uint32(s):
    c = s.TurboComposer()
    ws = [s.UInt32.from_witness(c, v) for v in (0xCAFEBABE, 0x01020304)]
    ba = s.BitArray.from_uint32s(c, ws)
    assert ba.get_value() == (0xCAFEBABE << 32) | 0x01020304
    words = ba.to_uint32s()
    return c, [w.get_value() for w in words]


def case_bits_from_byte_array(s):
    c = s.TurboComposer()
    f = s.FieldT.from_witness(c, 0x1122334455667788)
    ba = s.BitArray.from_byte_array(c, s.field_to_bytes(f, 8))
    return c, ba.get_value()


def case_bits_from_size(s):
    c = s.TurboComposer()
    ba = s.BitArray.from_size(c, 40)
    ba[3] = s.FieldT.from_witness(c, 1)
    return c, (len(ba), ba.get_value(), ba.to_bytes_value())


def case_packed_pack_unpack(s):
    c = s.TurboComposer()
    data = bytes(range(1, 41))
    pba = s.Packed.from_bytes(c, data)
    assert pba.size() == 40 and pba.get_value() == data
    return c, [x.get_value() for x in pba.get_limbs()]


def case_packed_append(s):
    c = s.TurboComposer()
    pba = s.Packed.from_bytes(c, b"\xaa" * 14)
    pba.append(s.FieldT.from_witness(c, 0x0102), 2)
    pba.append(s.FieldT.from_witness(c, int.from_bytes(b"XYZ", "big")), 3)
    pba.append(s.FieldT.from_witness(c, 0x55), 1)
    assert pba.get_value() == b"\xaa" * 14 + b"\x01\x02XYZ\x55"
    return c, pba.get_value()


def case_packed_reslice(s):
    c = s.TurboComposer()
    vals = [0x11223344, 0xAABBCCDD, 0x01020304, 0x05060708]
    fs = [s.FieldT.from_witness(c, v) for v in vals]
    pba = s.Packed.from_field_slices(c, fs, bytes_per_input=4)
    slices = pba.to_unverified_byte_slices(4)
    assert [x.get_value() for x in slices] == vals
    return c, pba.get_value()


CASES = {f.__name__[len("case_"):]: f for f in (
    case_bits_from_bytes, case_bits_uint32, case_bits_from_byte_array,
    case_bits_from_size, case_packed_pack_unpack, case_packed_append,
    case_packed_reslice)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bit_and_packed_as_reference(name):
    (mine, got), (theirs, ref) = _both(CASES[name])
    assert got == ref
    assert gate_digest(mine) == gate_digest(theirs)
    assert _side("aztec_tpu_torch").check(mine) == []


def test_bit_array_binding_fails_on_tamper():
    s = _side("aztec_tpu_torch")
    c = s.TurboComposer()
    f = s.FieldT.from_witness(c, 0x1122334455667788)
    ba = s.BitArray.from_byte_array(c, s.field_to_bytes(f, 8))
    b0 = ba[0]
    c.variables[b0.witness_index] = 1 - c.variables[b0.witness_index]
    assert s.check(c) != []


# -- ECDSA and the host SHA-256 ------------------------------------------------

@pytest.mark.parametrize("curve", ("SECP256K1", "SECP256R1"))
def test_ecdsa_as_reference(curve):
    rng = random.Random(SEED)
    for _ in range(3):
        priv = rng.getrandbits(256)
        msg = rng.randbytes(rng.randrange(1, 90))

        def run(s):
            cv = getattr(s.ecdsa, curve)
            pub = s.ecdsa.derive_public_key(priv, cv)
            sig = s.ecdsa.sign(msg, priv, cv)
            return (pub, sig, s.ecdsa.verify(msg, pub, sig, cv),
                    s.ecdsa.verify(msg + b"!", pub, sig, cv),
                    s.ecdsa.verify(msg, pub, (sig[0], sig[1] ^ 1), cv),
                    s.ecdsa.verify(msg, (pub[0], pub[1] + 1), sig, cv),
                    s.ecdsa.verify(msg, None, sig, cv))

        mine, theirs = _both(run)
        assert mine == theirs
        assert mine[2:] == (True, False, False, False, False)
        assert mine[1][1] <= getattr(_side("aztec_tpu_torch").ecdsa,
                                     curve).n // 2


def test_host_sha256():
    msg = random.Random(SEED).randbytes(1000)
    mine, theirs = _both(lambda s: s.sha256(msg))
    assert mine == theirs == hashlib.sha256(msg).digest()
