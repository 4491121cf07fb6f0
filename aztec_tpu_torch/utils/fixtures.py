"""Fixture cache: compute-or-load persistence for expensive artifacts.

The reference's fixture/caching pattern
(rollup/proofs/root_rollup/compute_or_load_fixture.hpp:18-40 and
rollup/proofs/compute_circuit_data.hpp): proofs, verification keys and
other multi-minute artifacts (inner proofs for recursion tests, padding
proofs for rollup circuits) are computed once, persisted under
``fixtures_cache/``, and reloaded by later tests/processes.

Keys are (name, version): bump the version string when the producing code
changes semantics so stale fixtures never poison correctness runs.  Set
``AZTEC_NO_FIXTURES=1`` to force recomputation.

Port of aztec_tpu/utils/fixtures.py.  The port keeps its fixtures in a
``torch/`` subdirectory of the reference's directory, so that neither
package loads an artifact the other computed: a proof or VK found there was
computed by this package.  The directory is read from the environment at
every call.  Ported: the (proof, VK) fixture and the VK's JSON form; the
raw-bytes and pickled fixtures have no caller in the port yet.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable


def fixture_dir() -> str:
    """``$AZTEC_FIXTURES/torch``, by default ``<checkout>/fixtures_cache/
    torch``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(os.environ.get(
        "AZTEC_FIXTURES", os.path.join(root, "fixtures_cache")), "torch")
    os.makedirs(path, exist_ok=True)
    return path


def _path(name: str, version: str, ext: str) -> str:
    tag = hashlib.sha256(f"{name}|{version}".encode()).hexdigest()[:16]
    safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in name)
    return os.path.join(fixture_dir(), f"{safe}.{tag}.{ext}")


def _disabled() -> bool:
    return os.environ.get("AZTEC_NO_FIXTURES") == "1"


# -- verification-key (de)serialization --------------------------------------
# JSON form so fixtures stay inspectable; commitments as hex strings
# (ref: verification_key.hpp commitment maps).

def vk_to_json(vk) -> str:
    from ..plonk.proving_key import VerificationKey  # noqa: F401

    def enc_pt(p):
        return None if p is None else [hex(p[0]), hex(p[1])]

    g2 = vk.g2_x
    return json.dumps({
        "n": vk.n,
        "num_public_inputs": vk.num_public_inputs,
        "domain_root": hex(vk.domain_root),
        "settings": vk.settings.name,
        "commitments": {k: enc_pt(v) for k, v in vk.commitments.items()},
        "g2_x": [[hex(c) for c in g2[0]], [hex(c) for c in g2[1]]],
        "contains_recursive_proof": vk.contains_recursive_proof,
        "recursive_proof_public_input_indices":
            list(vk.recursive_proof_public_input_indices)
            if vk.recursive_proof_public_input_indices else None,
    })


def vk_from_json(s: str):
    from ..plonk.proving_key import VerificationKey
    from ..plonk import manifests

    d = json.loads(s)
    settings = {
        "standard": manifests.STANDARD,
        "turbo": manifests.TURBO,
        "unrolled_standard": manifests.UNROLLED_STANDARD,
        "unrolled_turbo": manifests.UNROLLED_TURBO,
        "ultra": manifests.ULTRA,
        "unrolled_ultra": manifests.UNROLLED_ULTRA,
    }[d["settings"]]

    def dec_pt(p):
        return None if p is None else (int(p[0], 16), int(p[1], 16))

    idx = d["recursive_proof_public_input_indices"]
    return VerificationKey(
        n=d["n"],
        num_public_inputs=d["num_public_inputs"],
        commitments={k: dec_pt(v) for k, v in d["commitments"].items()},
        domain_root=int(d["domain_root"], 16),
        g2_x=(tuple(int(c, 16) for c in d["g2_x"][0]),
              tuple(int(c, 16) for c in d["g2_x"][1])),
        settings=settings,
        contains_recursive_proof=d["contains_recursive_proof"],
        recursive_proof_public_input_indices=tuple(idx) if idx else None,
    )


def compute_or_load_proof_and_vk(name: str, fn: Callable[[], tuple],
                                 version: str = "1"):
    """(proof_bytes, vk) fixture — the shape every recursion/rollup test
    needs (inner proof + its verification key)."""
    p = _path(name, version, "json")

    if not _disabled() and os.path.exists(p):
        with open(p) as f:
            d = json.load(f)
        return bytes.fromhex(d["proof"]), vk_from_json(d["vk"])
    proof, vk = fn()
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"proof": proof.hex(), "vk": vk_to_json(vk)}, f)
    os.replace(tmp, p)
    return proof, vk
