"""A TurboPlonk circuit that uses every Turbo widget.

``build`` records, in this order:

- a depth-``depth`` Merkle path of in-circuit Pedersen ``compress(left,
  right)`` calls (the fixed-base ECC gate, ``q_ecc_1``; 32 is the depth of
  aztec-2.0's data tree), its root the circuit's one public input;
- ``ranges`` range constraints at each of 32, 64, 128 and 252 bits
  (``q_range``);
- ``logic`` AND and ``logic`` XOR constraints at 32 bits (``q_logic``);
- one big add gate with bit extraction (``q_arith`` = 2) and one big mul
  gate (``q_4``, ``q_m``);
- tools/prover_bench.py's chain of mul gates up to 2^log2n - 512 gates.

The composer class and the in-circuit Pedersen module are arguments, so the
same circuit is built with either package's classes; this module imports
neither.  Witnesses come from ``random.Random(seed)``.
"""

from __future__ import annotations

import random

FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
RANGE_BITS = (32, 64, 128, 252)


def build(composer_cls, pedersen, mul_triple, log2n: int = 17,
          depth: int = 32, ranges: int = 16, logic: int = 32,
          seed: int = 101):
    """The circuit on a new ``composer_cls()``; ``pedersen`` is a
    ``stdlib.pedersen_circuit`` module and ``mul_triple`` its package's
    ``MulTriple``.  Its subgroup size is 2^log2n."""
    rng = random.Random(seed)
    c = composer_cls()
    field = pedersen.FieldT

    node = field.from_witness(c, rng.randrange(FR_MOD))
    for _ in range(depth):
        sibling = field.from_witness(c, rng.randrange(FR_MOD))
        if rng.getrandbits(1):
            node = pedersen.compress(node, sibling)
        else:
            node = pedersen.compress(sibling, node)
    node.set_public()

    for bits in RANGE_BITS:
        for _ in range(ranges):
            c.create_range_constraint(c.add_variable(rng.getrandbits(bits)),
                                      bits)
    for is_xor in (False, True):
        for _ in range(logic):
            a = c.add_variable(rng.getrandbits(32))
            b = c.add_variable(rng.getrandbits(32))
            c.create_logic_constraint(a, b, 32, is_xor)

    # q_arith = 2: the extracted quad c - 4d must be 0 or 1
    v = [c.add_variable(x) for x in (1, 2, 21, 5)]
    c.create_big_add_gate_with_bit_extraction(*v, 1, 1, 1, 1, -29)
    v = [c.add_variable(x) for x in (3, 4, 5, 6)]
    c.create_big_mul_gate(*v, 1, 1, 1, 1, 1, -30)

    a_val = seed + 3
    a = c.add_variable(a_val)
    while c.n < (1 << log2n) - 512:
        b_val = rng.randrange(1, 1 << 30)
        prod_val = a_val * b_val % FR_MOD
        prod = c.add_variable(prod_val)
        c.create_mul_gate(mul_triple(a, c.add_variable(b_val), prod, 1, -1,
                                     0))
        a, a_val = prod, prod_val
    if c.failed:
        raise AssertionError(f"turbo circuit: {c.err}")
    if c.subgroup_size() != 1 << log2n:
        raise AssertionError(f"turbo circuit: subgroup {c.subgroup_size()}, "
                             f"not 2^{log2n}")
    return c
