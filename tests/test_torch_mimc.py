"""The port's MiMC composer, MiMC7 hash and elliptic widget against the JAX
package, on the CPU.

Mirrors tests/test_mimc.py and tests/test_elliptic_widget.py:

- the round constants, the native cipher and hash equal aztec_tpu's;
- MiMC7 in MiMC gates and in standard gates matches the native hash,
  ``check_mimc`` / ``check_standard`` are clean, a tampered witness fails,
  and the gates recorded on the port's ``MiMCComposer`` are aztec_tpu's;
- the circuit ``mimc_drive`` (make_vectors.py) proved by the port under a
  counter rng gives aztec_tpu's proof bytes, which aztec_tpu's MiMC
  verifier accepts (a tamper rejected); the composer has no unrolled
  prover, as in the reference;
- the MiMC quotient (``MimcFlavor.quotient_evals``, over stored coset
  forms and by coset quarters) and ``elliptic_identity`` on seeded planes
  equal the reference's outputs in tests/torch_vectors/ultra_quotient.npz;
- ``elliptic_identity`` vanishes on an ecc add gate of Grumpkin points
  (host curve arithmetic) and not on a corrupted one.

All integer checks: tolerance zero.
"""

import functools
import os
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import make_vectors as mv  # noqa: E402
import plonk_cases  # noqa: E402

M = mv.FR_MOD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_round_constants_and_natives_match_reference():
    from aztec_tpu.stdlib import mimc_circuit as ref
    from aztec_tpu_torch.stdlib import mimc_circuit as mc

    assert len(mc.MIMC_ROUND_CONSTANTS) == mc.NUM_MIMC_ROUNDS == 91
    assert len(set(mc.MIMC_ROUND_CONSTANTS)) == 91
    assert mc.MIMC_ROUND_CONSTANTS == ref.MIMC_ROUND_CONSTANTS
    assert mc._round_constants() == mc.MIMC_ROUND_CONSTANTS
    a = mc.mimc_block_cipher_native(123, 456)
    assert a == ref.mimc_block_cipher_native(123, 456)
    assert a != mc.mimc_block_cipher_native(124, 456)
    h = mc.mimc7_native([1, 2, 3])
    assert h == ref.mimc7_native([1, 2, 3])
    assert h != mc.mimc7_native([1, 2, 4]) and h != mc.mimc7_native([1, 2])


def _mimc_gates(mod, values=(11, 22, 33)):
    c = mod.MiMCComposer()
    c.create_dummy_gates()
    xs = [mod.field_t.FieldT.from_witness(c, v) for v in values]
    return c, mod.mimc_circuit.mimc7(c, xs, use_mimc_gates=True)


def _reference_classes():
    from aztec_tpu.plonk import composer as comp
    from aztec_tpu.stdlib import field_t, mimc_circuit

    return SimpleNamespace(MiMCComposer=comp.MiMCComposer, field_t=field_t,
                           mimc_circuit=mimc_circuit)


def test_mimc_gate_circuit_matches_native_and_reference():
    from aztec_tpu_torch.plonk.circuit_check import check_mimc
    from aztec_tpu_torch.stdlib.mimc_circuit import mimc7_native

    c, out = _mimc_gates(plonk_cases.port_classes("cpu"))
    assert out.get_value() == mimc7_native([11, 22, 33])
    assert check_mimc(c) == []
    assert c.n > 3 * 91
    ref, _ = _mimc_gates(_reference_classes())
    ref._flush_mimc()
    assert c.n == ref.n and c.variables == ref.variables
    assert c.real_variable_index == ref.real_variable_index
    for name in ("w_l", "w_r", "w_o", "q_m", "q_1", "q_2", "q_3", "q_c",
                 "q_mimc_coefficient", "q_mimc_selector"):
        assert getattr(c, name) == getattr(ref, name), name


def test_standard_lowering_matches_native():
    from aztec_tpu_torch.plonk.circuit_check import check_standard
    from aztec_tpu_torch.plonk.composer import StandardComposer
    from aztec_tpu_torch.stdlib.field_t import FieldT
    from aztec_tpu_torch.stdlib.mimc_circuit import mimc7, mimc7_native

    c = StandardComposer(device="cpu")
    xs = [FieldT.from_witness(c, v) for v in (7, 8)]
    out = mimc7(c, xs, use_mimc_gates=False)
    assert out.get_value() == mimc7_native([7, 8])
    assert check_standard(c) == []


def test_tampered_mimc_witness_fails_check():
    from aztec_tpu_torch.plonk.circuit_check import check_mimc
    from aztec_tpu_torch.plonk.composer import MiMCComposer
    from aztec_tpu_torch.stdlib.field_t import FieldT
    from aztec_tpu_torch.stdlib.mimc_circuit import mimc7

    c = MiMCComposer(device="cpu")
    mimc7(c, [FieldT.from_witness(c, 5)], use_mimc_gates=True)
    # corrupt one intermediate x_cubed witness
    c.variables[c.w_r[3]] = (c.variables[c.w_r[3]] + 1) % M
    assert check_mimc(c) != []


@functools.lru_cache(maxsize=None)
def _proved():
    build, seed = mv.CIRCUITS["mimc_drive"]
    c = build(plonk_cases.port_classes("cpu"))
    prover = c.create_prover()
    prover.rng = mv.counter_rng(seed)
    return c, prover.construct_proof()


def test_mimc_proof_matches_reference_and_verifies():
    c, proof = _proved()
    rec, _ = plonk_cases.load_vector("mimc_drive")
    assert rec["producer"] == mv.REFERENCE and rec["n"] == 128
    assert proof.hex() == rec["proof"]
    v = plonk_cases.reference_verifier(plonk_cases.reference_vk(rec),
                                       "mimc_drive")
    assert v.verify_proof(proof)
    assert not v.verify_proof(plonk_cases.tampered(proof))
    with pytest.raises(NotImplementedError):
        c.create_unrolled_prover()


@pytest.mark.parametrize("quarters", (False, True), ids=("stored",
                                                         "quarters"))
def test_mimc_quotient_matches_reference(quarters):
    """Over a stand-in key of the seeded 4n planes (``stand_in_key``),
    stored and by coset quarters."""
    from aztec_tpu_torch.plonk.flavors import MimcFlavor

    ins, want = plonk_cases.ultra_planes()
    w, s, z, q, l1, pts, vs, alpha, beta, gamma, delta = mv.mimc_args(ins)
    names = ("q_m", "q_1", "q_2", "q_3", "q_c", "q_mimc_coefficient",
             "q_mimc_selector")
    pk = plonk_cases.stand_in_key(quarters, pts, l1, vs, s.unbind(1),
                                  dict(zip(names, q.unbind(1))))
    polys = {f"w_{i}": x for i, x in enumerate(w.unbind(1), 1)}
    polys["z"] = z
    got = MimcFlavor.quotient_evals(
        pk, polys, polys, {"alpha": alpha, "beta": beta, "gamma": gamma,
                           "delta": delta}, mv.QUOTIENT_N)
    assert np.array_equal(got.numpy(), want["mimc"])


def test_elliptic_identity_matches_reference():
    from aztec_tpu_torch.plonk import kernels

    ins, want = plonk_cases.ultra_planes()
    got = kernels.elliptic_identity(*mv.elliptic_args(ins))
    assert np.array_equal(got.numpy(), want["elliptic"])


def _ec_add(P, Q):
    x1, y1 = P
    x2, y2 = Q
    lam = (y2 - y1) * pow(x2 - x1, -1, M) % M
    x3 = (lam * lam - x1 - x2) % M
    return (x3, (lam * (x1 - x3) - y1) % M)


@pytest.mark.parametrize("sign", (1, -1))
def test_elliptic_identity_on_a_gate(sign):
    """(x_3, y_3) = (x_1, y_1) + (beta x_2, sign y_2) on Grumpkin, beta a
    cube root of unity folded into the selectors: the identity vanishes at
    the gate's row (and q_elliptic masks the others), and not once x_3 is
    corrupted."""
    from aztec_tpu_torch.curves.spec import GRUMPKIN_G1
    from aztec_tpu_torch.msm import glv
    from aztec_tpu_torch.numeric.bigint import limbs_to_ints
    from aztec_tpu_torch.plonk import kernels
    from aztec_tpu_torch.plonk.proving_key import fr_mont, ints_to_mont

    rng = random.Random(99 + sign)
    beta = glv.glv_params(GRUMPKIN_G1)["beta"]
    G = (GRUMPKIN_G1.gen_x, GRUMPKIN_G1.gen_y)
    P1 = glv._host_ec_mul(rng.randrange(2, 1 << 64), G, M, GRUMPKIN_G1.b)
    P2 = glv._host_ec_mul(rng.randrange(2, 1 << 64), G, M, GRUMPKIN_G1.b)
    P3 = _ec_add(P1, (beta * P2[0] % M, sign * P2[1] % M))

    rows = 4
    w = [[0] * rows for _ in range(4)]  # w[col][row]
    w[1][0], w[2][0] = P1               # x_1 = w_2, y_1 = w_3 at row 0
    w[0][1], w[3][1] = P2               # x_2 = w_1, y_2 = w_4 at row 1
    w[1][1], w[2][1] = P3               # x_3 = w_2, y_3 = w_3 at row 1
    mont = lambda vals: ints_to_mont(vals, "cpu")  # noqa: E731
    sel = [mont([v, 0, 0, 0]) for v in (beta, beta * beta % M, sign % M, 1)]
    alpha, alpha2 = (fr_mont(rng.randrange(1, M), "cpu")[:, None]
                     for _ in range(2))

    def identity():
        out = kernels.elliptic_identity([mont(col) for col in w], *sel,
                                        alpha, alpha2)
        from aztec_tpu_torch.ff import FR, limb

        return limbs_to_ints(limb.from_mont(out, FR).numpy())

    assert identity() == [0] * rows
    w[1][1] = (w[1][1] + 1) % M
    assert identity()[0] != 0
