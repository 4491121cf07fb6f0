"""An UltraPlonk circuit with lookups in a range, an XOR and an AND table.

``build`` records, in this order:

- the tables ``range_table(range_bits, 1)``, ``xor_table(logic_bits, 2)``
  and ``and_table(logic_bits, 3)`` (at the defaults 2^16 rows each, 196,608
  in all);
- ``ranges`` range constraints of ``4 * range_bits`` bits (64 at the
  default) by lookups, four chunks of ``range_bits`` each
  (``create_range_constraint_via_lookup``: four lookup gates and three add
  gates);
- ``logic`` XOR and ``logic`` AND reads (``read_from_table``) of random
  ``logic_bits``-bit operands;
- one public input, and tools/prover_bench.py's chain of mul gates up to
  2^log2n - 512 gates.

The composer class and the lookup-table module are arguments, so the same
circuit is built with either package's classes; this module imports
neither.  Witnesses come from ``random.Random(seed)``: two seeds give two
circuits of one shape (the same selectors, tables and copy cycles), with
other witness values.
"""

from __future__ import annotations

import random

FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def build(composer_cls, tables, mul_triple, add_triple, log2n: int = 20,
          range_bits: int = 16, logic_bits: int = 8, ranges: int = 1 << 15,
          logic: int = 1 << 16, seed: int = 111):
    """The circuit on a new ``composer_cls()`` (an ``UltraComposer``);
    ``tables`` is a ``plonk.lookup_tables`` module, ``mul_triple`` and
    ``add_triple`` its package's ``MulTriple`` and ``AddTriple``.  Its
    subgroup size is 2^log2n."""
    rng = random.Random(seed)
    c = composer_cls()
    for table in (tables.range_table(range_bits, 1),
                  tables.xor_table(logic_bits, 2),
                  tables.and_table(logic_bits, 3)):
        c.add_lookup_table(table)

    for _ in range(ranges):
        c.create_range_constraint_via_lookup(
            c.add_variable(rng.getrandbits(4 * range_bits)), 1, 4, range_bits)
    for index in (2, 3):
        for _ in range(logic):
            a = c.add_variable(rng.getrandbits(logic_bits))
            b = c.add_variable(rng.getrandbits(logic_bits))
            c.read_from_table(index, a, b)

    # the sum of two looked-up chunks as the public input, so that the
    # arithmetic and the lookups share witnesses
    x = c.add_variable(rng.getrandbits(range_bits))
    c.create_lookup_gate(x, c.zero_idx, c.zero_idx, 1)
    pub = c.add_public_variable(2 * c.get_variable(x))
    c.create_add_gate(add_triple(x, x, pub, 1, 1, -1, 0))

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
        raise AssertionError(f"ultra circuit: {c.err}")
    if c.subgroup_size() != 1 << log2n:
        raise AssertionError(f"ultra circuit: subgroup {c.subgroup_size()}, "
                             f"not 2^{log2n}")
    return c
