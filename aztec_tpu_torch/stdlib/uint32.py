"""uint32 in-circuit type — the width-32 instance of stdlib.uint.UIntBase
(ref: stdlib/primitives/uint/uint.cpp; see uint.py for the gate design).

Port of aztec_tpu/stdlib/uint32.py, on the port's composers: host Python, so
the same inputs record the same gates.
"""

from __future__ import annotations

from .uint import UIntBase

MASK32 = (1 << 32) - 1


class UInt32(UIntBase):
    WIDTH = 32
