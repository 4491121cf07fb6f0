"""A circuit's verification key and a proof's wire commitments, worked out
from the circuit's gates alone, in plain Python.

The layout is barretenberg's (composer_base.cpp, standard_composer.cpp,
turbo_composer.cpp): the public inputs take the first rows (their value in
w_1 and w_2), the gates follow, then zero rows; every selector carries a 1
in the last row; sigma_c maps each slot of a copy cycle (the public-input
slots first, then the gate slots row by row) to the next slot of its cycle
as omega^row * k_col (k = 1, 5, 6, 7 by column), and sigma_1 maps each
public-input row to itself times the external coset generator 12.

A commitment to the polynomial of evaluations f_j on the subgroup is
[f(tau)] G = [sum_j f_j L_j(tau)] G on the dev SRS of the known tau, with
L_j(tau) = omega^j (tau^n - 1) / (n (tau - omega^j)).
"""

from __future__ import annotations

import dataclasses
import operator

import numpy as np

from . import bn254
from .bn254 import COSET, EXTERNAL_COSET, R
from .verifier import LABELS, ROOTS_CUT

# the dev SRS's tau, [tau^i] G: the reference string every configuration
# proves against (srs/reference_string.py's DEV_TAU in the port)
DEV_TAU = 0xB0B0CAFE12345678DEADBEEF
RESERVED_ROWS = 4     # NUM_RESERVED_GATES: rows kept free for the blinding
BLINDED_ROWS = 3      # each wire's random values, from row n - ROOTS_CUT on
SELECTORS = {"standard": ("q_m", "q_c", "q_1", "q_2", "q_3"),
             "turbo": ("q_m", "q_c", "q_1", "q_2", "q_3", "q_4", "q_5",
                       "q_arith", "q_ecc_1", "q_range", "q_logic")}
WIDTH = {"standard": 3, "turbo": 4}


@dataclasses.dataclass
class Circuit:
    """A circuit as plain data: what the composer was asked to hold."""

    flavor: str                  # "standard" or "turbo"
    variables: list              # each variable's value
    real: list                   # each variable's copy class (its real variable)
    public_inputs: list          # the public inputs' variable indices, in order
    wires: tuple                 # per column, each gate's variable index
    selectors: dict              # per selector, each gate's value

    @property
    def size(self) -> int:
        """The subgroup: the next power of two holding every row."""
        rows = len(self.wires[0]) + len(self.public_inputs) + RESERVED_ROWS
        return 1 << (rows - 1).bit_length()

    def public_values(self) -> list:
        return [self.variables[self.real[i]] for i in self.public_inputs]


def lagrange_at(tau: int, n: int) -> tuple:
    """(L_j(tau) for j < n, omega^j for j < n)."""
    root = bn254.domain_root(n)
    omega = [1] * n
    diffs = [tau % R] * n
    prefix = [1] * (n + 1)
    w, p = 1, 1
    for j in range(n):
        omega[j] = w
        d = diffs[j] = (tau - w) % R
        p = prefix[j + 1] = p * d % R
        w = w * root % R
    # one batch inversion of tau - omega^j, scaled by (tau^n - 1) / n
    inv = pow(p, -1, R) * (pow(tau, n, R) - 1) * pow(n, -1, R) % R
    out = [0] * n
    for j in range(n - 1, -1, -1):
        out[j] = inv * prefix[j] % R * omega[j] % R
        inv = inv * diffs[j] % R
    return out, omega


def evaluate(values, lagrange) -> int:
    """f(tau) of the polynomial with these evaluations on the subgroup."""
    return sum(map(operator.mul, values, lagrange)) % R


def _selector_rows(c: Circuit, name: str, n: int) -> list:
    pub = len(c.public_inputs)
    gates = c.selectors[name]
    return [0] * pub + [v % R for v in gates] + [0] * (n - 1 - pub - len(gates)) + [1]


def _slot_classes(c: Circuit) -> np.ndarray:
    """Each slot's copy class (its real variable): the public-input slots
    (columns 0 and 1 of their rows) first, then the gate slots row by row."""
    width = WIDTH[c.flavor]
    real = np.asarray(c.real, dtype=np.int64)
    return np.concatenate([np.repeat(real[np.asarray(c.public_inputs, dtype=np.int64)], 2),
                           real[np.stack([np.asarray(w, dtype=np.int64)
                                          for w in c.wires[:width]], axis=1)].reshape(-1)])


def shape(c: Circuit) -> tuple:
    """What one key fixes of a circuit: its flavour, its public inputs'
    count, its selectors, and its copy cycles, each slot named by the first
    slot of its cycle (so the variables' numbering does not matter)."""
    _, first, inverse = np.unique(_slot_classes(c), return_index=True,
                                  return_inverse=True)
    return (c.flavor, len(c.public_inputs),
            [c.selectors[name] for name in SELECTORS[c.flavor]],
            first[inverse.reshape(-1)])


def same_shape(a: tuple, b: tuple) -> bool:
    return a[:3] == b[:3] and np.array_equal(a[3], b[3])


def _sigma_rows(c: Circuit, n: int, omega: list) -> list:
    """sigma_1 .. sigma_width as evaluations on the subgroup (not reduced
    mod r: each is omega^row times a small k)."""
    width = WIDTH[c.flavor]
    pub = len(c.public_inputs)
    gates = len(c.wires[0])
    # the slots in cycle order: by copy class, the public-input slots first,
    # then the gate slots row by row (a stable sort keeps that order)
    keys_ = _slot_classes(c)
    rows = np.concatenate([np.repeat(np.arange(pub), 2),
                           np.repeat(np.arange(pub, pub + gates), width)])
    cols = np.concatenate([np.tile([0, 1], pub), np.tile(np.arange(width), gates)])
    order = np.argsort(keys_, kind="stable")
    k_sorted = keys_[order]
    first = np.ones(order.size, bool)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    last = np.append(first[1:], True)
    start = np.maximum.accumulate(np.where(first, np.arange(order.size), 0))
    succ = order[np.where(last, start, np.arange(order.size) + 1)]
    next_row = np.tile(np.arange(n), (width, 1))
    next_col = np.repeat(np.arange(width)[:, None], n, axis=1)
    next_row[cols[order], rows[order]] = rows[succ]
    next_col[cols[order], rows[order]] = cols[succ]
    next_row[0, :pub] = np.arange(pub)
    omega_arr = np.array(omega, dtype=object)
    ks = np.array((1,) + COSET[:width - 1] + (EXTERNAL_COSET,), dtype=object)
    next_col[0, :pub] = len(ks) - 1
    return [(omega_arr[next_row[col]] * ks[next_col[col]]).tolist() for col in range(width)]


def verification_key(c: Circuit, tau: int) -> tuple:
    """({commitment label: affine point}, subgroup size, L_j(tau) table)."""
    n = c.size
    lagrange, omega = lagrange_at(tau, n)
    out = {}
    for name in SELECTORS[c.flavor]:
        out[LABELS[name]] = bn254.mul(evaluate(_selector_rows(c, name, n), lagrange),
                                      bn254.G1)
    for i, rows in enumerate(_sigma_rows(c, n, omega)):
        out[f"SIGMA_{i + 1}"] = bn254.mul(evaluate(rows, lagrange), bn254.G1)
    return out, n, lagrange


def wire_evaluations(c: Circuit, lagrange: list) -> list:
    """w_i(tau) of the unblinded wires, for i = 1 .. width."""
    width = WIDTH[c.flavor]
    pub = c.public_values()
    out = []
    for col in range(width):
        rows = (pub if col < 2 else [0] * len(pub)) + [
            c.variables[c.real[v]] for v in c.wires[col]]
        out.append(evaluate(rows, lagrange))
    return out


def wire_commitments(base: list, blinding: list, lagrange: list) -> list:
    """[W_i] of a proof whose wire i holds ``blinding[i]`` (BLINDED_ROWS
    values) from row n - ROOTS_CUT on, rows the unblinded wires leave zero."""
    n = len(lagrange)
    out = []
    for w, rnd in zip(base, blinding):
        v = (w + sum(b * lagrange[n - ROOTS_CUT + k] for k, b in enumerate(rnd))) % R
        out.append(bn254.mul(v, bn254.G1))
    return out
