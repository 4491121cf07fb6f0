"""Everything a run draws from ``--seed``: one stream per purpose.

A stream is ``random.Random`` seeded with SHA-256 of the seed and the
stream's labels, so any whole number is a seed, and no two purposes (the
circuit's values, a request's blinding) share draws.
"""

from __future__ import annotations

import hashlib
import random

from .reference.bn254 import R


def stream(seed: int, *labels) -> random.Random:
    key = "/".join(str(x) for x in (seed,) + labels).encode()
    return random.Random(int.from_bytes(hashlib.sha256(key).digest(), "big"))


def field(rnd: random.Random) -> int:
    """A uniform nonzero element of BN254's Fr."""
    return rnd.randrange(1, R)


def blinding(seed: int, request: int):
    """The prover's random source for one request: the values it returns in
    turn (``Prover.rng``), the same for both sides of the comparison."""
    rnd = stream(seed, "blinding", request)
    return lambda: field(rnd)


def blinding_values(seed: int, request: int, width: int, per_wire: int) -> list:
    """The first ``width * per_wire`` values of ``blinding(seed, request)``,
    by wire: what the prover's first round draws."""
    draw = blinding(seed, request)
    return [[draw() for _ in range(per_wire)] for _ in range(width)]
