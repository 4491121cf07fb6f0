"""The port's recursion stdlib (aztec_tpu_torch.stdlib: bigfield,
biggroup, recursion_verifier) against aztec_tpu.stdlib, on the CPU.

Each case records the same circuit on the port's TurboComposer and on
aztec_tpu's, from one seed: the witness values, wires, selectors, copy
cycles and public inputs must be equal, and so must the values computed;
``check_turbo`` must pass on the port's composer.  Cases: ``BigField``
mul, ``madd``, sub, ``reduce``, ``select`` and ``assert_equal``;
``BigGroup`` ``add``, ``dbl`` and ``validate_on_curve``; ``fq_from_bytes``,
``bit_decompose(254)`` and ``g1_from_proof_bytes``; ``batch_mul`` over two
points at 16 bits; ``_lagrange_evals`` at n = 16, ``_public_input_delta``
and the unrolled permutation and Turbo terms on seeded evaluations;
``add_proof_outputs_as_public_inputs``.  ``check_turbo`` fails after an
altered witness.  The recursion transcript's buffer compression over a
chunk of zeros equals aztec_tpu's native transcript's (a fault of
aztec_tpu's in-circuit transcript, repaired in the port).

``RecursiveVK.compress`` and ``validate_key_is_in_set`` are held to the
value and gate digest that tests/torch_vectors/make_vectors.py wrote from
aztec_tpu (``recursive_vk``): aztec_tpu's Pedersen generators for the
compression's 123 inputs take minutes to search at test time.  A key that
is not in the set fails the circuit.

With ``AZTEC_HEAVY=1`` (as the JAX package's heavy tier): the in-circuit
verifier over the committed ``join_split_d3`` proof gives the pairing
inputs aztec_tpu's native verifier computes.
"""

import functools
import os
import random
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402
from make_vectors import (gate_digest, recursive_vk_case,  # noqa: E402
                          recursive_vk_circuit)
from plonk_cases import assert_same_circuit  # noqa: E402

FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
FQ_MOD = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


def _ns(pkg: str):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    cls = mod("plonk.composer").TurboComposer
    if pkg == "aztec_tpu_torch":
        cls = functools.partial(cls, device="cpu")
    return SimpleNamespace(
        TurboComposer=cls, check=mod("plonk.circuit_check"),
        F=mod("stdlib.field_t").FieldT, BF=mod("stdlib.bigfield").BigField,
        BG=mod("stdlib.biggroup").BigGroup, rv=mod("stdlib.recursion_verifier"),
        g1_mul=mod("curves.pairing").g1_mul,
        g1_to_bytes=mod("plonk.serialize").g1_to_bytes)


@pytest.fixture(autouse=True, scope="module")
def _reference_generators():
    """aztec_tpu's Pedersen generators, from its own hash-to-curve, found
    once (``plonk_cases.linear_generator_stream``)."""
    from aztec_tpu.crypto import pedersen

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pedersen, "get_generator",
                   plonk_cases.linear_generator_stream(pedersen))
        yield


@functools.lru_cache(maxsize=None)
def _m(side: str):
    return _ns("aztec_tpu_torch" if side == "port" else "aztec_tpu")


def _point(m, rng):
    return m.g1_mul(rng.randrange(1, FR_MOD), (1, 2))


def _bigfield(m, c, rng):
    a, b, d = (rng.randrange(FQ_MOD) for _ in range(3))
    x, y, z = (m.BF.from_witness(c, v) for v in (a, b, d))
    bit = m.F.from_witness(c, 1)
    c.create_bool_gate(bit.witness_index)
    prod = x * y
    madd = x.madd(y, [z, prod])
    diff = x - y
    red = (x + y + z).reduce()
    sel = m.BF.select(bit, x, y)
    x.assert_equal(m.BF.from_witness(c, a))
    return [v.get_value() % FQ_MOD for v in (prod, madd, diff, red, sel)]


def _biggroup(m, c, rng):
    p, q = m.BG.from_witness(c, _point(m, rng)), m.BG.from_witness(
        c, _point(m, rng))
    s, d = p.add(q, c), p.dbl(c)
    s.validate_on_curve(c)
    return [s.get_value(), d.get_value()]


def _byte_witnesses(m, c, data: bytes):
    out = []
    for byte in data:
        f = m.F.from_witness(c, byte)
        c.create_range_constraint(f.witness_index, 8)
        out.append(f)
    return out


def _bytes(m, c, rng):
    v = rng.randrange(FQ_MOD)
    fq = m.rv.fq_from_bytes(c, _byte_witnesses(m, c, v.to_bytes(32, "big")))
    s = rng.randrange(FR_MOD)
    bits = m.rv.bit_decompose(c, m.F.from_witness(c, s), 254)
    pt = _point(m, rng)
    g = m.rv.g1_from_proof_bytes(c, _byte_witnesses(m, c, m.g1_to_bytes(pt)))
    return [fq.get_value(), [b.get_value() for b in bits], g.get_value()]


def _batch_mul(m, c, rng):
    pts = [m.BG.from_witness(c, _point(m, rng)) for _ in range(2)]
    scs = [m.F.from_witness(c, rng.getrandbits(16)) for _ in range(2)]
    return m.rv.batch_mul(c, pts, scs, bits=16).get_value()


EV_LABELS = ("w_1", "w_2", "w_3", "w_4", "w_1_omega", "w_2_omega",
             "w_3_omega", "w_4_omega", "sigma_1", "sigma_2", "sigma_3",
             "sigma_4", "z", "z_omega", "q_arith", "q_ecc_1", "q_c")


def _verifier_terms(m, c, rng):
    w = lambda: m.F.from_witness(c, rng.randrange(FR_MOD))
    zeta, alpha, beta, gamma = w(), w(), w(), w()
    root = pow(5, (FR_MOD - 1) // 16, FR_MOD)
    vanishing, l_start, l_end, zp = m.rv._lagrange_evals(c, zeta, 16, root)
    delta = m.rv._public_input_delta(c, [w() for _ in range(3)], beta, gamma,
                                     root)
    ev = {k: w() for k in EV_LABELS}
    perm = m.rv._perm_t_unrolled(ev, alpha, beta, gamma, zeta, l_start,
                                 l_end, delta, width=4)
    ap = m.rv._alpha_powers(alpha, 17)
    nonlinear = m.rv._turbo_nonlinear_t(ev, ap)
    scalars = m.rv._turbo_selector_scalars(ev, ap)
    return [v.get_value() for v in (vanishing, l_start, l_end, zp, delta,
                                    perm, nonlinear)] + sorted(
        (k, v.get_value()) for k, v in scalars.items())


def _proof_outputs(m, c, rng):
    out = m.rv.RecursionOutput(P0=m.BG.from_witness(c, _point(m, rng)),
                               P1=m.BG.from_witness(c, _point(m, rng)))
    positions = m.rv.add_proof_outputs_as_public_inputs(c, out)
    return positions, [c.get_variable(i) for i in c.public_inputs]


CASES = {"bigfield": _bigfield, "biggroup": _biggroup, "bytes": _bytes,
         "batch_mul_2x16": _batch_mul, "verifier_terms": _verifier_terms,
         "proof_outputs": _proof_outputs}


@functools.lru_cache(maxsize=None)
def _built(case: str, side: str):
    m = _m(side)
    c = m.TurboComposer()
    return c, CASES[case](m, c, random.Random(case))


@pytest.mark.parametrize("case", CASES)
def test_gates_match_reference(case):
    mine, got = _built(case, "port")
    theirs, want = _built(case, "reference")
    assert got == want
    assert not mine.failed, mine.err
    assert_same_circuit(mine, theirs)
    assert _m("port").check.check_turbo(mine) == []


def test_values_are_the_native_ones():
    (prod, madd, diff, red, sel) = _built("bigfield", "port")[1]
    rng = random.Random("bigfield")
    a, b, d = (rng.randrange(FQ_MOD) for _ in range(3))
    assert (prod, madd, diff, red, sel) == (
        a * b % FQ_MOD, (a * b + d + a * b) % FQ_MOD, (a - b) % FQ_MOD,
        (a + b + d) % FQ_MOD, a)
    positions, pub = _built("proof_outputs", "port")[1]
    assert positions == list(range(16))
    assert all(v < 1 << 68 for v in pub)


def test_check_turbo_fails_on_an_altered_witness():
    m = _m("port")
    c = m.TurboComposer()
    _bigfield(m, c, random.Random("altered"))
    assert m.check.check_turbo(c) == []
    row = max(i for i in range(c.n) if c.q_arith[i])
    var = c.real_variable_index[c.w_o[row]]
    c.variables[var] = (c.variables[var] + 1) % FR_MOD
    assert m.check.check_turbo(c) != []


# -- the transcript's buffer compression on a zero chunk -----------------------

@pytest.mark.parametrize("zero_chunk", (0, 1))
def test_transcript_compression_skips_zero_chunks(zero_chunk):
    """A 31-byte chunk of zeros (the join-split's first public inputs are
    zeros) hashes to the point at infinity in the native transcript and
    adds nothing.  aztec_tpu's in-circuit transcript walks the ladder of
    the value 0 instead, and its scalar check fails the circuit (the
    port's rollup circuits failed so on the card); the port's compression
    equals aztec_tpu's native one and the circuit holds."""
    from aztec_tpu.crypto.pedersen import compress_buffer_to_field
    from aztec_tpu_torch.stdlib.recursion_transcript import _compress_buffer

    m = _m("port")
    rng = random.Random(zero_chunk)
    data = bytearray(rng.randrange(1, 256) for _ in range(70))
    data[31 * zero_chunk:31 * zero_chunk + 31] = bytes(31)
    c = m.TurboComposer()
    buf = [m.F.from_witness(c, b) for b in data]
    got = _compress_buffer(c, buf).get_value()
    assert got == compress_buffer_to_field(bytes(data))
    assert not c.failed, c.err
    assert m.check.check_turbo(c) == []


# -- the recursive VK, against aztec_tpu's committed values ---------------------

def test_recursive_vk_compress_and_set_match_reference():
    rec, _ = plonk_cases.load_vector("recursive_vk")
    m = _m("port")
    vk, _ = recursive_vk_case("aztec_tpu_torch")
    assert m.rv.RecursiveVK.compress_native(vk) == int(rec["compressed"], 16)
    c = m.TurboComposer()
    assert recursive_vk_circuit("aztec_tpu_torch", c) == int(
        rec["compressed"], 16)
    assert not c.failed, c.err
    assert gate_digest(c) == rec["gate_digest"]
    assert m.check.check_turbo(c) == []


def test_recursive_vk_not_in_set_fails():
    m = _m("port")
    vk, other = recursive_vk_case("aztec_tpu_torch")
    c = m.TurboComposer()
    m.rv.RecursiveVK.from_witness(c, vk).validate_key_is_in_set(c, [other])
    assert c.failed and c.err == "vk not in permitted set"
    assert m.check.check_turbo(c) != []


# -- heavy: the whole in-circuit verifier -----------------------------------------

@pytest.mark.skipif(os.environ.get("AZTEC_HEAVY") != "1",
                    reason="~8M-gate outer circuit; set AZTEC_HEAVY=1")
def test_verify_proof_circuit_matches_native_pairing_inputs():
    from aztec_tpu.plonk.flavors import UnrolledTurboFlavor
    from aztec_tpu.plonk.verifier import Verifier
    from test_torch_rollup import _vector_vk

    rec, ref_vk, _, port_vk = _vector_vk()
    proof = bytes.fromhex(rec["proof"])
    want = Verifier(ref_vk, UnrolledTurboFlavor).pairing_inputs(proof)
    m = _m("port")
    c = m.TurboComposer()
    out = m.rv.verify_proof_circuit(c, proof, port_vk)
    assert not c.failed, c.err
    assert (out.P0.get_value(), out.P1.get_value()) == tuple(want)
    assert [f.get_value() for f in out.public_inputs] == [
        int(v, 16) if isinstance(v, str) else v
        for v in rec["public_inputs"]]
