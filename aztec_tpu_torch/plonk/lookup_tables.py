"""Plookup table definitions + sorted-list construction.

Port of aztec_tpu/plonk/lookup_tables.py, carried over as it is (host
Python; the port keeps its own copy).

The reference snapshot only designs plookup (barretenberg/lookup_tables.md;
reserved manifest slots polynomial_manifest.hpp:23-46) — this module fixes
the concrete tables per docs/ULTRA_DESIGN.md:

- RANGE(bits):  rows (v, 0, 0) for v < 2^bits — one lookup row replaces a
  base-4 accumulator chain.
- XOR/AND(bits): rows (a, b, a^b / a&b) over b-bit operands.

A table row (k1, k2, v) with table index j compresses to
k1 + eta k2 + eta^2 v + eta^3 j; a row performing a lookup compresses its
wires the same way (kernels.lookup_grand_product).  Index 0 is reserved for
the "empty" value 0 carried by non-lookup rows and table padding.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Sequence, Tuple

from ..ff.bn254 import FR_MOD

M = FR_MOD


@dataclasses.dataclass(frozen=True)
class LookupTable:
    name: str
    index: int                       # >= 1 (0 = the empty/non-lookup value)
    rows: Tuple[Tuple[int, int, int], ...]

    def __post_init__(self):
        assert self.index >= 1, "table index 0 is reserved"


def range_table(bits: int, index: int = 1) -> LookupTable:
    return LookupTable(
        name=f"range_{bits}",
        index=index,
        rows=tuple((v, 0, 0) for v in range(1 << bits)),
    )


def xor_table(bits: int, index: int = 2) -> LookupTable:
    return LookupTable(
        name=f"xor_{bits}",
        index=index,
        rows=tuple(
            (a, b, a ^ b) for a in range(1 << bits) for b in range(1 << bits)
        ),
    )


def and_table(bits: int, index: int = 3) -> LookupTable:
    return LookupTable(
        name=f"and_{bits}",
        index=index,
        rows=tuple(
            (a, b, a & b) for a in range(1 << bits) for b in range(1 << bits)
        ),
    )


def compress_row(k1: int, k2: int, v: int, index: int, eta: int) -> int:
    return (k1 + eta * (k2 + eta * (v + eta * index))) % M


def build_sorted_halves(
    tables: Sequence[LookupTable],
    lookups: Sequence[Tuple[int, int, int, int]],  # (k1, k2, v, table_index)
    eta: int,
    m: int,
) -> Tuple[List[int], List[int]]:
    """The plookup sorted list s (length 2m+1), as even/odd halves.

    m is the number of identity-enforced rows (n - 4).  The multiset is
    {F_i : i < m} ∪ {T_i : i <= m} where non-lookup rows and table padding
    contribute 0; s is ordered by the table order (content rows first, the
    zero block last — matching the T polynomial layout), which is what the
    pair-product argument requires (plookup Claim 3.1).

    Returns (h1, h2): h1 = s[0::2] (m+1 values), h2 = s[1::2] (m values).
    """
    content: List[int] = []
    for t in sorted(tables, key=lambda t: t.index):
        for k1, k2, v in t.rows:
            content.append(compress_row(k1, k2, v, t.index, eta))

    fvals = [compress_row(k1, k2, v, idx, eta) for k1, k2, v, idx in lookups]
    counts = Counter(fvals)

    s: List[int] = []
    for cv in content:
        s.append(cv)
        c = counts.pop(cv, 0)
        s.extend([cv] * c)
    if counts:
        raise ValueError(
            f"{sum(counts.values())} lookup value(s) not present in any table"
        )
    total = 2 * m + 1
    if len(s) > total:
        raise ValueError("lookups + tables exceed circuit capacity")
    s.extend([0] * (total - len(s)))
    return s[0::2], s[1::2]
