"""Reference vectors for the PyTorch port's whole-proof tests.

Proves small circuits with the JAX package (``aztec_tpu``) under a fixed
counter rng and writes, per circuit:

- ``<name>.json``: subgroup size, public inputs, the proof bytes (hex) and
  the verification-key commitments (hex affine ints);
- ``<name>.npz`` (the circuits of ``PLANES``): the proving key's planes as
  uint16 (16, n) Montgomery limbs: selector and sigma monomials plus sigma
  lagrange values.

The circuits: two Standard-PLONK ones (``standard_drive1``,
``standard_chain8``); the TurboPlonk circuit of tests/test_turbo.py proved
with the keccak transcript (``turbo_drive``) and unrolled
(``unrolled_turbo_drive``, the Pedersen-Blake2s transcript, no
linearisation); and ``turbo_pedersen``, aztec_tpu_torch/tools/
turbo_circuit.py's circuit at 2^10 gates (one in-circuit Pedersen
``compress``, one range constraint of each width, one AND, one XOR),
proved only here and on the card (chip_smoke.py), not by the CPU tests.
``tests/test_torch_plonk.py`` and ``tests/test_torch_turbo.py`` hold the
port (``aztec_tpu_torch``) to these bytes without compiling the JAX prover.

Also ``turbo_quotient.npz``: the reference's ``kernels.turbo_quotient`` at
n = 16 (4n = 64 lanes) on the seeded inputs of ``quotient_inputs``, which
the test rebuilds from the seed.

Also ``mont_pow.npz``: the reference's ``mont_pow``, ``inv_mont`` and
``batch_inv_mont`` (``aztec_tpu.ff.limb``) for Fr and Fq on POW_LANES
lanes of canonical and unreduced 16-bit limbs (0, 1, p - 1, p, p + 1,
2p - 1, all 0xFFFF, canonical and uniform random limbs), with the exponents
p - 2, 2^100, 0 and 1; ``tests/test_torch_ff.py`` holds the port to them.
The batch inversion runs along an axis of length one, so every lane is its
own inversion (along a longer axis the reference's associative scan and
the port's Hillis-Steele scan multiply unreduced lanes in other orders).

Regenerate (minutes of XLA:CPU compiles per circuit, a few for the powers)
with, optionally followed by the names to make (``mont_pow`` and
``turbo_quotient`` among them):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_vectors/make_vectors.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def counter_rng(seed: int):
    """Deterministic blinding source shared by both packages' provers."""
    state = [seed]

    def rng():
        state[0] += 1
        return (state[0] * 0x9E3779B97F4A7C15F39CC0605CEDC835) % FR_MOD

    return rng


def build_drive1(mod):
    """The 4-gate circuit of the verify recipe (subgroup 16)."""
    c = mod.StandardComposer()
    c.create_dummy_gates()
    c.add_public_variable(123)
    x = c.add_variable(3)
    y = c.add_variable(4)
    z = c.add_variable(12)
    c.create_mul_gate(mod.MulTriple(x, y, z, 1, -1, 0))
    return c


def build_chain(mod, log2n: int):
    """The chain circuit of tools/cross_verify_big.py at 2^log2n gates."""
    c = mod.StandardComposer()
    c.create_dummy_gates()
    c.add_public_variable(0xCAFEBABE)
    a = c.add_variable(3)
    b = c.add_variable(4)
    prod = c.add_variable(12)
    c.create_mul_gate(mod.MulTriple(a, b, prod, 1, -1, 0))
    acc_val, acc = 12, prod
    for _ in range((1 << log2n) - 16):
        acc_val = (acc_val + 3) % FR_MOD
        nxt = c.add_variable(acc_val)
        c.create_add_gate(mod.AddTriple(acc, a, nxt, 1, 1, -1, 0))
        acc = nxt
    assert c.subgroup_size() == 1 << log2n
    return c


def build_turbo_drive(mod):
    """The TurboPlonk circuit of tests/test_turbo.py (subgroup 32)."""
    c = mod.TurboComposer()
    a = c.add_variable(5)
    b = c.add_variable(7)
    prod = c.add_variable(35)
    c.create_mul_gate(mod.MulTriple(a, b, prod, 1, -1, 0))
    s = c.add_variable(12)
    c.create_add_gate(mod.AddTriple(a, b, s, 1, 1, -1, 0))
    q = c.add_variable(59)
    c.create_big_add_gate(a, b, prod, s, 1, 1, 1, 1, -59)
    c.assert_equal(q, c.put_constant_variable(59), "const")
    c.create_range_constraint(s, 8)
    c.create_and_constraint(a, b, 4)
    c.create_xor_constraint(a, b, 4)
    c.add_public_variable(0xDEAD)
    assert not c.failed, c.err
    return c


def build_turbo_pedersen(mod):
    """aztec_tpu_torch/tools/turbo_circuit.py's circuit at 2^10 gates."""
    from aztec_tpu_torch.tools import turbo_circuit

    return turbo_circuit.build(mod.TurboComposer, mod.pedersen,
                               mod.MulTriple, log2n=10, depth=1, ranges=1,
                               logic=1, seed=10)


# name: (the circuit, built from a namespace of a package's classes; its
# counter-rng seed)
CIRCUITS = {
    "standard_drive1": (lambda mod: build_drive1(mod), 7),
    "standard_chain8": (lambda mod: build_chain(mod, 8), 8),
    "turbo_drive": (build_turbo_drive, 9),
    "unrolled_turbo_drive": (build_turbo_drive, 9),
    "turbo_pedersen": (build_turbo_pedersen, 10),
}
# proved with create_unrolled_prover (and verified by the unrolled verifier)
UNROLLED = ("unrolled_turbo_drive",)
# the circuits whose proving-key planes are written (the rest: bytes only)
PLANES = ("standard_drive1", "standard_chain8", "turbo_drive")


def make_prover(c, name: str):
    return (c.create_unrolled_prover() if name in UNROLLED
            else c.create_prover())


def make_verifier(c, name: str):
    return (c.create_unrolled_verifier() if name in UNROLLED
            else c.create_verifier())


QUOTIENT_N = 16
QUOTIENT_SEED = 16


def quotient_inputs(n: int = QUOTIENT_N, seed: int = QUOTIENT_SEED) -> dict:
    """Seeded inputs of ``turbo_quotient`` at subgroup size n: uint32
    Montgomery planes of uniform Fr elements (every selector random, so
    non-zero), wires and sigmas (16, 4, 4n), selectors (16, 11, 4n),
    alphas (16, 21) drawn independently, so that a misplaced power shows."""
    rng = np.random.default_rng(seed)

    def field(*shape):
        words = rng.integers(0, 1 << 63, (4,) + shape, dtype=np.int64)
        vals = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            v = sum(int(words[(k,) + idx]) << (63 * k) for k in range(4))
            vals[idx] = v % FR_MOD
        out = np.zeros((16,) + shape, np.uint32)
        for idx in np.ndindex(*shape):
            for i in range(16):
                out[(i,) + idx] = (vals[idx] >> (16 * i)) & 0xFFFF
        return out

    m = 4 * n
    return {"wffts": field(4, m), "sffts": field(4, m), "zfft": field(m),
            "qffts": field(11, m), "l1fft": field(m), "coset_pts": field(m),
            "vanish_scale": field(m), "alphas": field(21), "beta": field(1),
            "gamma": field(1), "delta": field(1)}


QUOTIENT_ARGS = ("wffts", "sffts", "zfft", "qffts", "l1fft", "coset_pts",
                 "vanish_scale", "alphas", "beta", "gamma", "delta")


def quotient_vectors() -> None:
    import jax.numpy as jnp

    from aztec_tpu.plonk import kernels

    ins = quotient_inputs()
    out = kernels.turbo_quotient(*(jnp.asarray(ins[k]) for k in QUOTIENT_ARGS),
                                 QUOTIENT_N)
    np.savez_compressed(os.path.join(HERE, "turbo_quotient.npz"),
                        out=np.asarray(out).astype(np.uint16))
    print("turbo_quotient: written", flush=True)

POW_LANES = 16
POW_SEED = 7


def pow_exponents(p: int):
    """The exponents of mont_pow.npz, in their order."""
    return (p - 2, 1 << 100, 0, 1)


def pow_inputs(p: int) -> np.ndarray:
    """(16, POW_LANES) uint16 limbs: 0, 1, p - 1, p, p + 1, 2p - 1, all
    0xFFFF, five canonical random elements, four lanes of uniform limbs."""
    rng = np.random.default_rng(POW_SEED + p % 7)
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1, (1 << 256) - 1]
    vals += [int(rng.integers(0, 1 << 62)) ** 4 % p for _ in range(5)]
    vals += [sum(int(w) << (16 * i) for i, w in
                 enumerate(rng.integers(0, 1 << 16, 16)))
             for _ in range(POW_LANES - len(vals))]
    return np.array([[(v >> (16 * i)) & 0xFFFF for v in vals]
                     for i in range(16)], dtype=np.uint16)


def pow_vectors() -> None:
    import jax.numpy as jnp

    from aztec_tpu.ff import FQ, FR, limb

    out = {}
    for name, spec in (("fr", FR), ("fq", FQ)):
        A = pow_inputs(spec.modulus)
        a = jnp.asarray(A.astype(np.uint32))
        out[f"{name}_in"] = A
        for k, e in enumerate(pow_exponents(spec.modulus)):
            bits = np.array([(e >> i) & 1 for i in range(max(e.bit_length(),
                                                              1))],
                            np.uint32)
            out[f"{name}_pow{k}"] = np.asarray(limb.mont_pow(a, bits, spec))
        out[f"{name}_inv"] = np.asarray(limb.inv_mont(a, spec))
        out[f"{name}_batch_inv"] = np.asarray(
            limb.batch_inv_mont(a[:, :, None], spec, axis=-1))[:, :, 0]
    np.savez_compressed(os.path.join(HERE, "mont_pow.npz"),
                        **{k: v.astype(np.uint16) for k, v in out.items()})
    print("mont_pow: written", flush=True)


def main() -> None:
    from types import SimpleNamespace

    from aztec_tpu.utils import setup_compile_cache

    setup_compile_cache()
    from aztec_tpu.plonk import composer as comp
    from aztec_tpu.stdlib import pedersen_circuit

    mod = SimpleNamespace(StandardComposer=comp.StandardComposer,
                          TurboComposer=comp.TurboComposer,
                          pedersen=pedersen_circuit,
                          MulTriple=comp.MulTriple, AddTriple=comp.AddTriple)
    only = set(sys.argv[1:])
    if not only or "mont_pow" in only:
        pow_vectors()
    if not only or "turbo_quotient" in only:
        quotient_vectors()
    for name, (build, seed) in CIRCUITS.items():
        if only and name not in only:
            continue
        c = build(mod)
        prover = make_prover(c, name)
        prover.rng = counter_rng(seed)
        proof = prover.construct_proof()
        vk = c.compute_verification_key()
        pk = c.compute_proving_key()
        if name in PLANES:
            planes = {}
            for s, store in pk.selectors.items():
                planes[f"{s}_monomial"] = np.asarray(store.monomial)
            for s, store in pk.sigmas.items():
                planes[f"{s}_monomial"] = np.asarray(store.monomial)
                planes[f"{s}_lagrange"] = np.asarray(store.lagrange)
            np.savez_compressed(
                os.path.join(HERE, f"{name}.npz"),
                **{k: v.astype(np.uint16) for k, v in planes.items()})
        rec = {
            "n": pk.n,
            "rng_seed": seed,
            "public_inputs": [hex(v) for v in prover.public_values],
            "proof": proof.hex(),
            "vk": {k: None if v is None else [hex(v[0]), hex(v[1])]
                   for k, v in vk.commitments.items()},
        }
        with open(os.path.join(HERE, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        ok = make_verifier(c, name).verify_proof(proof)
        print(f"{name}: n={pk.n} proof={len(proof)} bytes verified={ok}",
              flush=True)
        if not ok:
            raise AssertionError(f"{name}: the reference rejects its proof")


if __name__ == "__main__":
    main()
