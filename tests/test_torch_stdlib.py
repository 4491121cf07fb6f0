"""The port's in-circuit library (aztec_tpu_torch.stdlib: field_t and the
Pedersen hash over the Turbo fixed-base gates) against aztec_tpu.stdlib,
host only.

Each case records the same circuit on the port's TurboComposer (on the
CPU) and on aztec_tpu's: the witness values, the four wire lists, the
eleven selector lists, the copy cycles and the public inputs must be equal,
and so must the values the circuit computes.  The port's check_turbo must
pass on its composer, as aztec_tpu's does on its own, and fail once a
witness is altered.  No key is built and nothing is proved.
"""

import functools
import random
from types import SimpleNamespace

import pytest

FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
SELECTORS = ("q_m", "q_c", "q_1", "q_2", "q_3", "q_4", "q_5", "q_arith",
             "q_ecc_1", "q_range", "q_logic")


def _port():
    from aztec_tpu_torch.plonk import circuit_check, composer
    from aztec_tpu_torch.stdlib import field_t, pedersen_circuit

    return SimpleNamespace(
        TurboComposer=functools.partial(composer.TurboComposer, device="cpu"),
        MulTriple=composer.MulTriple, pedersen=pedersen_circuit,
        field_t=field_t, check=circuit_check)


def _reference():
    from aztec_tpu.plonk import circuit_check, composer
    from aztec_tpu.stdlib import field_t, pedersen_circuit

    return SimpleNamespace(
        TurboComposer=composer.TurboComposer, MulTriple=composer.MulTriple,
        pedersen=pedersen_circuit, field_t=field_t, check=circuit_check)


def _hash_single(m, c, rng):
    x = m.field_t.FieldT.from_witness(c, rng.randrange(FR_MOD))
    return m.pedersen.hash_single(x, 3).get_value()


def _compress(m, c, rng):
    f = m.field_t.FieldT
    left = f.from_witness(c, rng.randrange(FR_MOD))
    right = f.from_witness(c, rng.randrange(FR_MOD))
    return m.pedersen.compress(left, right).get_value()


def _merkle_depth2(m, c, rng):
    f = m.field_t.FieldT
    node = f.from_witness(c, rng.randrange(FR_MOD))
    for _ in range(2):
        sibling = f.from_witness(c, rng.randrange(FR_MOD))
        node = m.pedersen.compress(sibling, node)
    node.set_public()
    return node.get_value()


def _fixed_base(m, c, rng):
    f = m.field_t.FieldT
    x = f.from_witness(c, rng.randrange(FR_MOD))
    y = f.from_witness(c, rng.getrandbits(128))
    return (m.pedersen.fixed_base_scalar_mul(x, 254, 1).get_value(),
            m.pedersen.fixed_base_scalar_mul_g1(y, 128).get_value())


def _compress_many(m, c, rng):
    f = m.field_t.FieldT
    xs = [f.from_witness(c, v) for v in (rng.randrange(FR_MOD), 0,
                                         rng.randrange(FR_MOD))]
    return m.pedersen.compress_many(xs).get_value()


def _field_ops(m, c, rng):
    f, b = m.field_t.FieldT, m.field_t.BoolT
    x = f.from_witness(c, rng.randrange(FR_MOD))
    y = f.from_witness(c, rng.randrange(FR_MOD))
    z = (x * y + x * 3 - y + 7).normalize()
    inv = z.invert()
    zero = f.from_witness(c, 0)
    p, q = b.from_witness(c, True), b.from_witness(c, False)
    bits = [(p & q).get_value(), (p | q).get_value(), (p ^ ~q).get_value()]
    (z * inv).assert_equal(1)
    (x / y).set_public()
    return (z.get_value(), inv.get_value(), zero.is_zero().get_value(),
            x.is_zero().get_value(), bits)


def _turbo_circuit(m, c, rng):
    from aztec_tpu_torch.tools import turbo_circuit

    built = turbo_circuit.build(lambda: c, m.pedersen, m.MulTriple,
                                log2n=10, depth=1, ranges=1, logic=1, seed=5)
    assert built is c
    return [sum(1 for v in getattr(c, s) if v) for s in SELECTORS]


CASES = {"hash_single": _hash_single, "compress": _compress,
         "merkle_depth2": _merkle_depth2, "fixed_base": _fixed_base,
         "compress_many": _compress_many, "field_ops": _field_ops,
         "turbo_circuit_2pow10": _turbo_circuit}


@functools.lru_cache(maxsize=None)
def _built(case: str, side: str):
    m = _port() if side == "port" else _reference()
    c = m.TurboComposer()
    out = CASES[case](m, c, random.Random(case))
    return m, c, out


@pytest.mark.parametrize("case", CASES)
def test_gates_match_reference(case):
    _, mine, out = _built(case, "port")
    _, theirs, ref_out = _built(case, "reference")
    assert out == ref_out
    assert not mine.failed and not theirs.failed
    assert mine.n == theirs.n
    assert mine.variables == theirs.variables
    assert mine.real_variable_index == theirs.real_variable_index
    assert mine.next_var_index == theirs.next_var_index
    assert mine.public_inputs == theirs.public_inputs
    for name in ("w_l", "w_r", "w_o", "w_4") + SELECTORS:
        assert getattr(mine, name) == getattr(theirs, name), name


@pytest.mark.parametrize("side", ("port", "reference"))
@pytest.mark.parametrize("case", CASES)
def test_check_turbo_passes(case, side):
    m, c, _ = _built(case, side)
    assert m.check.check_turbo(c) == []


def test_every_selector_used_by_the_turbo_circuit():
    _, _, counts = _built("turbo_circuit_2pow10", "port")
    assert all(counts), dict(zip(SELECTORS, counts))


@pytest.mark.parametrize("case", ("compress", "field_ops"))
def test_check_turbo_fails_on_an_altered_witness(case):
    m = _port()
    c = m.TurboComposer()
    CASES[case](m, c, random.Random(case))
    assert m.check.check_turbo(c) == []
    # a witness on the last gate that constrains its own wires
    row = max(i for i in range(c.n)
              if c.q_arith[i] or c.q_ecc_1[i] or c.q_range[i])
    var = c.real_variable_index[c.w_o[row] if c.q_arith[row] else c.w_l[row]]
    c.variables[var] = (c.variables[var] + 1) % FR_MOD
    assert m.check.check_turbo(c) != []


def test_check_standard_matches_reference():
    from aztec_tpu.plonk import circuit_check as ref_check
    from aztec_tpu.plonk.composer import StandardComposer as RefComposer
    from aztec_tpu_torch.plonk import circuit_check
    from aztec_tpu_torch.plonk.composer import StandardComposer, MulTriple

    bad = []
    for cls in (functools.partial(StandardComposer, device="cpu"),
                RefComposer):
        c = cls()
        c.create_dummy_gates()
        x, y = c.add_variable(3), c.add_variable(4)
        c.create_mul_gate(MulTriple(x, y, c.add_variable(13), 1, -1, 0))
        bad.append((circuit_check.check_standard(c),
                    ref_check.check_standard(c)))
    assert bad[0] == bad[1]
    assert bad[0][0] == bad[0][1] and len(bad[0][0]) == 1
