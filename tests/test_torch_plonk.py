"""The port's Standard PLONK slice as a whole, on the CPU.

The 4-gate circuit of the verify recipe, proved by aztec_tpu_torch under a
counter rng, must give the proof bytes and VK values that aztec_tpu gave
for the same circuit and rng (tests/torch_vectors, made by
make_vectors.py); aztec_tpu's verifier must accept the proof and reject a
one-byte tamper.  tests/test_torch_plonk_chain.py does the same for a
2^8-gate chain circuit.  The proof is made with the port's spans on: its
bytes show that the spans change nothing, and its ranges that they nest as
the prover opens them.
"""

import itertools
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
import plonk_cases  # noqa: E402
from aztec_tpu_torch.utils import spans  # noqa: E402

NAME = "standard_drive1"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """Stands in for ``torch.profiler.record_function`` while the proof
    runs: each range logs its name, the ticks of its enter and exit, and its
    thread (tests/test_torch_spans.py shows the real ranges in a session)."""
    ticks = itertools.count()

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = next(self.ticks)

    def __exit__(self, *exc):
        RANGES.append((self.name, self.start, next(self.ticks),
                       threading.get_ident()))


RANGES = []


@pytest.fixture(scope="module")
def proved():
    """The proof, made with the port's spans on; their ranges in RANGES."""
    with pytest.MonkeyPatch.context() as mp, spans.enabled():
        mp.setattr(torch.profiler, "record_function", _Recorder)
        return plonk_cases.prove(NAME)


def test_proof_bytes_match_reference(proved):
    rec, _ = plonk_cases.load_vector(NAME)
    assert proved[1].hex() == rec["proof"]


def test_spans_nest_inside_the_proof(proved):
    def named(name):
        return [r for r in RANGES if r[0] == spans.PREFIX + name]

    def inside(a, b):
        return b[1] <= a[1] and a[2] <= b[2] and a[3] == b[3]
    prove, = named("prove")
    # the proof's four MSM drains; the others commit the key (set-up)
    msms = [m for m in named("msm") if inside(m, prove)]
    chunks, finishes = named("msm.chunk"), named("msm.finish")
    assert len(named("witness.host")) == 1 and len(msms) == 4
    for m in msms:
        assert sum(inside(f, m) for f in finishes) == 1
        assert any(inside(c, m) for c in chunks)
    assert all(any(inside(s, m) for m in named("msm")) for s in chunks + finishes)


def test_vk_matches_reference(proved):
    rec, _ = plonk_cases.load_vector(NAME)
    assert proved[2].commitments == plonk_cases.vk_ints(rec)
    assert proved[2].n == rec["n"]


def test_reference_verifier_accepts_and_rejects_tamper(proved):
    v = plonk_cases.reference_verifier(proved[2])
    assert v.verify_proof(proved[1])
    assert not v.verify_proof(plonk_cases.tampered(proved[1]))


def test_port_verifier_accepts_and_rejects_tamper(proved):
    v = proved[0].create_verifier()
    assert v.verify_proof(proved[1])
    assert not v.verify_proof(plonk_cases.tampered(proved[1]))


def test_interop_key_matches_port_key(proved):
    plonk_cases.key_planes_equal(NAME)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import pkgutil, sys, aztec_tpu_torch\n"
        "for m in pkgutil.walk_packages(aztec_tpu_torch.__path__, "
        "'aztec_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'aztec_tpu' or m.startswith('aztec_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('aztec_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 30


def test_composer_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from aztec_tpu_torch.plonk import StandardComposer

    with pytest.raises(RuntimeError, match="CUDA"):
        StandardComposer()


def test_srs_host_path_equals_table():
    from aztec_tpu_torch.srs.reference_string import (
        FakeReferenceStringFactory, load_point_table)

    f = FakeReferenceStringFactory(device="cpu")
    host = f.host_prover_srs(9)
    X, Y = load_point_table(9)
    assert np.array_equal(host.X.numpy(), X.astype(np.int32))
    assert np.array_equal(host.Y.numpy(), Y.astype(np.int32))
    with pytest.raises(ValueError, match="tau"):
        load_point_table(4, tau=f.tau + 1)
