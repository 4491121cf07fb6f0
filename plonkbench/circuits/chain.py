"""barretenberg's Standard-PLONK benchmark circuit (plonk_bench's chain): two
dummy gates, one public input, a multiplication gate, then addition gates
that step an accumulator until the subgroup of 2^log2_subgroup rows is full.

The seed gives the public input, the step ``a`` and the factor ``b``: the
multiplication gate proves a * b = acc_0, each addition gate
acc_{i+1} = acc_i + a.  The composer's own first gate fixes its constant 0
(variable 0), as barretenberg's StandardComposer does.
"""

from __future__ import annotations

from .. import seeds
from ..reference.bn254 import R
from ..reference.keys import Circuit


def _values(config: dict, seed: int):
    rnd = seeds.stream(seed, "chain")
    pub, a, b = (seeds.field(rnd) for _ in range(3))
    return pub, a, b, _adds(config)


def _adds(config: dict) -> int:
    """Addition gates: the rows left by the constant's gate, two dummy gates,
    the public input, the multiplication gate and the reserved rows, with
    room for one more row (the subgroup stays 2^log2_subgroup)."""
    return (1 << config["log2_subgroup"]) - 16


def build(config: dict, seed: int, device: str):
    from aztec_tpu_torch.plonk import AddTriple, MulTriple, StandardComposer

    pub, a, b, adds = _values(config, seed)
    c = StandardComposer(device=device)
    c.create_dummy_gates()
    c.add_public_variable(pub)
    ia, ib = c.add_variable(a), c.add_variable(b)
    acc_val = a * b % R
    acc = c.add_variable(acc_val)
    c.create_mul_gate(MulTriple(ia, ib, acc, 1, -1, 0))
    for _ in range(adds):
        acc_val = (acc_val + a) % R
        nxt = c.add_variable(acc_val)
        c.create_add_gate(AddTriple(acc, ia, nxt, 1, 1, -1, 0))
        acc = nxt
    if c.subgroup_size() != 1 << config["log2_subgroup"]:
        raise ValueError(f"the chain fills {c.subgroup_size()} rows")
    return c


def reference(config: dict, seed: int, composer=None) -> Circuit:
    """The chain as plain data, from the seed alone (``composer`` unused)."""
    pub, a, b, adds = _values(config, seed)
    variables = [0, 6, 7, -20 % R, pub, a, b, a * b % R]
    acc_val = variables[-1]
    for _ in range(adds):
        acc_val = (acc_val + a) % R
        variables.append(acc_val)
    # gates: the constant 0's, two dummy gates, the product, the additions
    w_l = [0, 1, 3, 5] + list(range(7, 7 + adds))
    w_r = [0, 2, 1, 6] + [5] * adds
    w_o = [0, 3, 2, 7] + list(range(8, 8 + adds))
    sel = {"q_m": [0, 1, 1, 1] + [0] * adds,
           "q_1": [1, 2, 1, 0] + [1] * adds,
           "q_2": [0, 3, 1, 0] + [1] * adds,
           "q_3": [0, 4, 1, R - 1] + [R - 1] * adds,
           "q_c": [0, 5, 127, 0] + [0] * adds}
    c = Circuit("standard", variables, list(range(len(variables))), [4],
                (w_l, w_r, w_o), sel)
    if c.size != 1 << config["log2_subgroup"]:
        raise ValueError(f"the chain fills {c.size} rows")
    return c
