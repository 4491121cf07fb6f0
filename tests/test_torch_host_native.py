"""The port's host C++ core (aztec_tpu_torch/host_native): its own copy of
the C++ sources, built with g++ into build/aztec_tpu_torch/.

- the composer core replaying tests/test_native_core.py's circuit recorded
  on aztec_tpu's ``StandardComposer`` and on the port's: the core's sigma
  mappings (the external coset tagged 255 natively and ``width`` + 1 in
  Python, both read as -1) and exported w_1 column equal to both
  composers' (and the port's witness planes);
- the C ABI (tests/test_cbind.py's cases) against aztec_tpu's pure-Python
  crypto/ and keccak, the port's crypto/, and hashlib.

All of the C ABI sits in this one file, so one test worker builds it.
Skipped only where there is no g++.
"""

import ctypes
import hashlib
import shutil

import numpy as np
import pytest

from aztec_tpu.crypto import pedersen as ref_ped
from aztec_tpu.crypto import schnorr as ref_sch
from aztec_tpu.crypto.keccak import keccak256 as ref_keccak
from aztec_tpu_torch.crypto import pedersen as ped
from aztec_tpu_torch.crypto import schnorr as sch
from aztec_tpu_torch.crypto.keccak import keccak256 as py_keccak
from aztec_tpu_torch.ff.bn254 import FR_MOD


@pytest.fixture(autouse=True)
def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


@pytest.fixture(scope="module")
def cbind():
    from aztec_tpu_torch.host_native import cbind

    cbind.load()
    return cbind


def _u64x4(v):
    return (ctypes.c_uint64 * 4)(*[(v >> (64 * k)) & ((1 << 64) - 1)
                                   for k in range(4)])


def _both(name, port_fn, ref_fn, *args, **kw):
    """port_fn(*args) after checking it equals aztec_tpu's ref_fn."""
    got = port_fn(*args, **kw)
    assert got == ref_fn(*args, **kw), f"{name}{args}: port != aztec_tpu"
    return got


def test_library_names_carry_a_hash_of_the_sources():
    from aztec_tpu_torch.host_native import build

    path = build.build("composer_core")
    assert path.parent == build.BUILD and path.exists()
    assert path.name.startswith("libcomposer_core_") and path.suffix == ".so"
    assert build.library_path("composer_core") == path
    assert "src" not in path.parts[-3:]


def _record(mod, **kw):
    """tests/test_native_core.py's circuit on one composer module's
    ``StandardComposer``."""
    pc = mod.StandardComposer(**kw)
    a = pc.add_variable(3)
    b = pc.add_variable(4)
    c_ = pc.add_variable(12)
    pc.create_mul_gate(mod.MulTriple(a, b, c_, 1, -1, 0))
    d = pc.add_variable(7)
    pc.create_add_gate(mod.AddTriple(a, b, d, 1, 1, -1, 0))
    e = pc.add_variable(12)
    pc.assert_equal(c_, e)
    pub = pc.add_public_variable(99)
    return pc, (c_, e, pub)


def test_sigma_mappings_and_witness_match_both_composers():
    from aztec_tpu.plonk import composer as ref_composer
    from aztec_tpu_torch.host_native import load_composer_core
    from aztec_tpu_torch.plonk import composer
    from aztec_tpu_torch.poly.arithmetic import to_ints

    lib = load_composer_core()
    pc, (c_, e, pub) = _record(composer, device="cpu")
    rc, ids = _record(ref_composer)
    assert ids == (c_, e, pub)
    assert (pc.variables, pc.w_l, pc.w_r, pc.w_o) == (
        rc.variables, rc.w_l, rc.w_r, rc.w_o)
    size = pc.subgroup_size()
    assert rc.subgroup_size() == size

    cc = lib.cc_new(5)
    try:
        for v in pc.variables:
            lib.cc_add_variable(cc, _u64x4(v))
        zeros = (ctypes.c_uint64 * 20)(*([0] * 20))
        for wl, wr, wo in zip(pc.w_l, pc.w_r, pc.w_o):
            lib.cc_gate(cc, 3, (ctypes.c_uint32 * 3)(wl, wr, wo), zeros)
        lib.cc_assert_equal(cc, c_, e)
        lib.cc_set_public(cc, pub)
        assert lib.cc_num_gates(cc) == pc.n == rc.n
        assert lib.cc_num_public(cc) == 1 and not lib.cc_failed(cc)

        nr = np.zeros((3 * size,), np.int32)
        fa = np.zeros((3 * size,), np.uint8)
        lib.cc_sigma_mappings(
            cc, 3, size, nr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        nr = nr.reshape(3, size)
        fa = fa.reshape(3, size)
        got = [-1 if x == 255 else x for x in fa.reshape(-1)]
        for comp, who in ((rc, "aztec_tpu"), (pc, "port")):
            py_next, py_factor = comp.compute_sigma_mappings(size, 3)
            for col in range(3):
                assert list(nr[col]) == list(py_next[col]), \
                    f"{who} col {col} next_row"
                expect = [-1 if x == 4 else x for x in py_factor[col]]
                assert got[col * size:(col + 1) * size] == expect, \
                    f"{who} col {col} factor"

        out = np.zeros((size * 4,), np.uint64)
        lib.cc_export_witness(
            cc, 0, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        w1 = [int(out[4 * i]) | int(out[4 * i + 1]) << 64
              | int(out[4 * i + 2]) << 128 | int(out[4 * i + 3]) << 192
              for i in range(size)]
        for comp in (rc, pc):
            expected = [comp.get_variable(p) for p in comp.public_inputs]
            expected += [comp.get_variable(w) for w in comp.w_l]
            expected += [0] * (size - len(expected))
            assert w1 == [v % FR_MOD for v in expected]
        planes, _ = pc.witness_planes(size, 3)
        assert to_ints(planes["w_1"]) == w1
    finally:
        lib.cc_free(cc)


def test_hashes_match_python(cbind):
    for data in (b"", b"a", b"hello world", bytes(range(256)) * 3):
        assert cbind.blake2s(data) == hashlib.blake2s(data).digest()
        assert cbind.keccak256(data) == _both("keccak256", py_keccak,
                                              ref_keccak, data)
    data = b"abcdefg"
    h = int.from_bytes(hashlib.blake2s(data).digest(), "big")
    assert cbind.blake2s_to_field(data) == h % ped.P == h % ref_ped.P


def test_pedersen_matches_reference_and_port(cbind):
    for idx in (0, 1, 2, 7):
        assert cbind.get_generator(idx) == _both(
            "get_generator", ped.get_generator, ref_ped.get_generator, idx)
    for left, right in [(1, 2), (0, 5), (ped.P - 1, ped.P - 2),
                        (12345, 678910)]:
        assert cbind.compress_fields(left, right) == _both(
            "compress_native", ped.compress_native, ref_ped.compress_native,
            left, right)
    vals = [3, 1, 4, 1, 5]
    assert cbind.compress_many(vals, 0) == _both(
        "compress_many", ped.compress_many, ref_ped.compress_many, vals, 0)
    assert cbind.commit(vals, 2) == _both(
        "encrypt_native", ped.encrypt_native, ref_ped.encrypt_native,
        vals, 2)
    for data in (b"", b"x" * 31, b"y" * 32, bytes(range(100))):
        assert cbind.buffer_to_field(data) == _both(
            "compress_buffer_to_field", ped.compress_buffer_to_field,
            ref_ped.compress_buffer_to_field, data)
    for v, nbits, idx in ((5, 32, 0), (0xDEADBEEF, 64, 1), (7, 254, 0)):
        assert cbind.fixed_base_scalar_mul(v, nbits, idx) == _both(
            "fixed_base_scalar_mul", ped.fixed_base_scalar_mul,
            ref_ped.fixed_base_scalar_mul, v, nbits, idx)


def test_schnorr_roundtrip_and_cross(cbind):
    priv = 0x1234567890ABCDEF1234567890ABCDEF
    msg = b"The quick brown fox"
    pub_c = cbind.compute_public_key(priv)
    assert pub_c == _both("derive_public_key", sch.derive_public_key,
                          ref_sch.derive_public_key, priv)
    k = 0x5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A
    sig_c = cbind.construct_signature(msg, priv, k)
    assert sig_c == _both("construct_signature", sch.construct_signature,
                          ref_sch.construct_signature, msg, priv, k=k)
    assert cbind.verify_signature(msg, pub_c, sig_c)
    assert sch.verify_signature(msg, pub_c, sig_c)
    assert ref_sch.verify_signature(msg, pub_c, sig_c)
    assert not cbind.verify_signature(b"other msg", pub_c, sig_c)
    assert not ref_sch.verify_signature(b"other msg", pub_c, sig_c)
    assert not cbind.verify_signature(msg, pub_c, (sig_c[0], b"\x00" * 32))
    off_curve = (pub_c[0], (pub_c[1] + 1) % ped.P)
    assert not cbind.verify_signature(msg, off_curve, sig_c)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    from aztec_tpu_torch.host_native import build

    monkeypatch.setattr(build, "BUILD", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        build.build("composer_core")
