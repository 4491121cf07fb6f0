"""Tests of the benchmark harness (run by hand: ``python -m pytest
plonkbench/tests -q`` from the root of the checkout).  Tests that need the
card carry the ``cuda`` marker and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs the benchmark on an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs on the card")
    return "cuda"


TINY = {"circuit": "chain", "flavor": "standard", "transcript": "keccak256",
        "log2_subgroup": 8}
TINY_MIX = {"loop": "closed", "clients": 1, "outstanding": 1,
            "warmup_requests": 0, "traced_requests": 1}
END_TO_END = ["proofs_per_s", "proof_p90_s", "peak_device_gib", "setup_s"]


def tiny_cell(config=TINY, mix=TINY_MIX):
    """A cell small enough for the CPU: the chain at 2^8 rows."""
    cell = {"name": "tiny", "config": "tiny", "traffic": "serial", "chips": 1}
    return (cell, dict(config), dict(mix), list(END_TO_END), [])
