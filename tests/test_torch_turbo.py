"""The port's TurboPlonk slice against the JAX package, on the CPU.

- the Turbo quotient (``TurboFlavor.quotient_evals`` over stored coset
  forms) at n = 16 on seeded inputs equals the reference's ``turbo_quotient``
  output committed in tests/torch_vectors/turbo_quotient.npz (on the card
  too: the ``cuda``-marked case, skipped here);
- the Turbo and unrolled flavors' host terms equal aztec_tpu's on seeded
  evaluations;
- the Turbo circuit of tests/test_turbo.py, proved by aztec_tpu_torch under
  a counter rng with the keccak transcript and unrolled, gives the proof
  bytes and VK that aztec_tpu gave (make_vectors.py; on the card too, a
  ``cuda``-marked case); aztec_tpu's verifier accepts each proof and
  rejects a one-byte tamper;
- the prover's width-4 paths: the shifted evaluations of all four wires,
  the fourth quotient piece of n coefficients, the openings of four
  pieces, and the unrolled flavor's fifth round without r.

All integer checks: tolerance zero.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402
from make_vectors import (HERE, QUOTIENT_ARGS, QUOTIENT_N,  # noqa: E402
                          quotient_inputs)

from aztec_tpu_torch.ff.bn254 import FR_MOD  # noqa: E402
from aztec_tpu_torch.plonk.manifests import TURBO, UNROLLED_TURBO  # noqa: E402

NAMES = ("turbo_drive", "unrolled_turbo_drive")
M = FR_MOD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quotient_matches_reference(device):
    """``TurboFlavor.quotient_evals`` over a key with stored 4n coset forms
    (the prover's path below ``QUARTER_MIN_N``)."""
    from types import SimpleNamespace

    from aztec_tpu_torch.plonk.flavors import TurboFlavor

    ins = {k: torch.from_numpy(ins.astype(np.int32)).to(device)
           for k, ins in quotient_inputs().items() if k in QUOTIENT_ARGS}
    stored = [SimpleNamespace(fft=x) for x in ins["qffts"].unbind(1)]
    pk = SimpleNamespace(
        quarters=False, l1_fft=ins["l1fft"], coset_pts=ins["coset_pts"],
        vanish_scale=ins["vanish_scale"],
        sigmas={f"sigma_{i}": SimpleNamespace(fft=x)
                for i, x in enumerate(ins["sffts"].unbind(1), 1)},
        selectors=dict(zip(TurboFlavor.SELECTOR_ORDER, stored)))
    wire_fft = {f"w_{i}": x for i, x in enumerate(ins["wffts"].unbind(1), 1)}
    wire_fft["z"] = ins["zfft"]
    got = TurboFlavor.quotient_evals(
        pk, None, wire_fft, {k: ins[k] for k in ("alphas", "beta", "gamma",
                                                 "delta")}, QUOTIENT_N)
    with np.load(os.path.join(HERE, "turbo_quotient.npz")) as d:
        want = d["out"].astype(np.int32)
    assert got.shape == (16, 4 * QUOTIENT_N)
    assert np.array_equal(got.cpu().numpy(), want)


def test_turbo_quotient_matches_reference():
    _quotient_matches_reference("cpu")


@pytest.mark.cuda
def test_turbo_quotient_on_card_matches_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _quotient_matches_reference("cuda")


def _evaluations(seed: int):
    """Seeded random evaluations and challenges under every name a Turbo
    verifier or prover reads."""
    rng = random.Random(seed)
    names = [f"w_{i}" for i in range(1, 5)] + [
        f"w_{i}_omega" for i in range(1, 5)] + [
        f"sigma_{i}" for i in range(1, 5)] + [
        "z", "z_omega", "r", "q_m", "q_1", "q_2", "q_3", "q_4", "q_5", "q_c",
        "q_arith", "q_ecc_1", "q_range", "q_logic"]
    ev = {k: rng.randrange(M) for k in names}
    ch = {k: rng.randrange(M) for k in ("alpha", "beta", "gamma", "zeta")}
    return ev, ch, rng.randrange(M), rng.randrange(M), rng.randrange(M)


FLAVOR_TERMS = [(flavor, term) for flavor in ("turbo", "unrolled_turbo",
                                              "unrolled_standard")
                for term in ("selector_linear_scalars", "_nonlinear_t_terms",
                             "perm_linear_terms", "verifier_t_contribution")
                if not (flavor == "unrolled_standard"
                        and term == "_nonlinear_t_terms")]


@pytest.mark.parametrize("flavor,term", FLAVOR_TERMS)
@pytest.mark.parametrize("seed", (1, 2))
def test_flavor_host_terms_match_reference(flavor, term, seed):
    from aztec_tpu.plonk import flavors as ref_flavors
    from aztec_tpu_torch.plonk import flavors

    ev, ch, l_start, l_end, delta = _evaluations(seed)
    mine = getattr(flavors.FLAVORS[flavor], term)
    theirs = getattr(ref_flavors.FLAVORS[flavor], term)
    args = {"selector_linear_scalars": (ev, ch),
            "_nonlinear_t_terms": (ev, ch),
            "perm_linear_terms": (ev, ch, l_start),
            "verifier_t_contribution": (ev, ch, l_start, l_end, delta)}[term]
    assert mine(*args) == theirs(*args)
    assert flavors.FLAVORS[flavor].settings.__class__.__name__ == \
        ref_flavors.FLAVORS[flavor].settings.__class__.__name__


@pytest.fixture(scope="module", params=NAMES)
def proved(request):
    return request.param, plonk_cases.prove(request.param)


def test_proof_bytes_match_reference(proved):
    name, (_, proof, _, _) = proved
    rec, _ = plonk_cases.load_vector(name)
    assert proof.hex() == rec["proof"]


def test_vk_matches_reference(proved):
    name, (_, _, vk, _) = proved
    rec, _ = plonk_cases.load_vector(name)
    assert vk.commitments == plonk_cases.vk_ints(rec)
    assert len(vk.commitments) == 15 and vk.n == rec["n"] == 32


def test_reference_verifier_accepts_and_rejects_tamper(proved):
    name, (_, proof, vk, _) = proved
    v = plonk_cases.reference_verifier(vk, name)
    assert v.verify_proof(proof)
    assert not v.verify_proof(plonk_cases.tampered(proof))


def test_port_verifier_accepts_and_rejects_tamper(proved):
    name, (c, proof, _, _) = proved
    v = (c.create_unrolled_verifier() if name.startswith("unrolled")
         else c.create_verifier())
    assert v.verify_proof(proof)
    assert not v.verify_proof(plonk_cases.tampered(proof))


def _horner(coeffs, x):
    acc = 0
    for v in reversed(coeffs):
        acc = (acc * x + v) % M
    return acc


def test_shifted_evaluations_of_all_four_wires(proved):
    """w_i(zeta * omega) for i = 1..4 (TURBO_POLYNOMIAL_MANIFEST), and
    z(zeta * omega), from the wires' monomials on the host."""
    from aztec_tpu_torch.poly.arithmetic import to_ints

    _, (c, _, _, prover) = proved
    t = prover.transcript
    root = prover.key.small_domain.root
    zeta_omega = prover._zeta * root % M
    for label in ("w_1", "w_2", "w_3", "w_4", "z"):
        want = _horner(to_ints(prover.wire_mono[label]), zeta_omega)
        assert t.get_element_fr(label + "_omega") == want, label


def test_quotient_split_into_four_pieces_of_n(proved):
    """t(X) has 4n coefficients, split into T_1..T_4 of n each (no extra
    coefficient on the last, unlike width 3): t(zeta) = sum_i zeta^{i n}
    T_i(zeta) is the transcript's t."""
    from aztec_tpu_torch.poly.arithmetic import to_ints

    _, (_, _, _, prover) = proved
    n, zeta = prover.n, prover._zeta
    tq = to_ints(prover.quotient_mono)
    assert len(tq) == 4 * n
    pieces = [_horner(tq[i * n:(i + 1) * n], zeta) for i in range(4)]
    t_eval = sum(p * pow(zeta, i * n, M) for i, p in enumerate(pieces)) % M
    assert prover.transcript.get_element_fr("t") == t_eval
    assert all(prover.transcript.has_element(f"T_{i}") for i in range(1, 5))


def test_fifth_round_linearised_or_not(proved):
    """The keccak flavor sends r and leaves the linearised polynomials
    unevaluated; the unrolled flavor sends no r and every polynomial's
    evaluation."""
    name, (_, _, _, prover) = proved
    settings = UNROLLED_TURBO if name.startswith("unrolled") else TURBO
    assert prover.settings is settings
    t = prover.transcript
    assert t.has_element("r") == settings.use_linearisation
    for info in settings.polynomial_manifest:
        sent = not (info.is_linearised and settings.use_linearisation)
        assert t.has_element(info.polynomial_label) == sent, \
            info.polynomial_label


@pytest.mark.cuda
def test_proofs_on_card_match_reference():
    """Both committed Turbo proofs, proved on the card (one composer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from make_vectors import CIRCUITS, counter_rng, make_prover

    build, _ = CIRCUITS["turbo_drive"]
    c = build(plonk_cases.port_classes("cuda"))
    for name in NAMES:
        prover = make_prover(c, name)
        prover.rng = counter_rng(CIRCUITS[name][1])
        rec, _ = plonk_cases.load_vector(name)
        assert prover.construct_proof().hex() == rec["proof"], name


def test_interop_key_matches_port_key():
    plonk_cases.key_planes_equal("turbo_drive")


def test_turbo_composer_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from aztec_tpu_torch.plonk import TurboComposer

    with pytest.raises(RuntimeError, match="CUDA"):
        TurboComposer()
