"""barretenberg's Fiat-Shamir transcript and the manifests of its Standard
and Turbo provers with the Keccak hash (plonk/transcript/transcript.cpp,
standard_composer.hpp and turbo_composer.hpp create_manifest).

A round hashes the previous round's last challenge (none in round 0) and
the round's elements in manifest order; a hash gives one 32-byte challenge,
and further challenges of a round come from keccak(base_hash || counter).
A manifest entry is ``(name, bytes, derived_by_verifier, nu_index)``.
"""

from __future__ import annotations

from .bn254 import R
from .keccak import keccak256

G1_SIZE, FR_SIZE = 64, 32


def _rounds(width: int, pub: int, nu_elements: tuple, num_nu: int) -> tuple:
    """(elements, challenge, num_challenges, map_challenges) per round."""
    wires = tuple((f"W_{i}", G1_SIZE, False, 0) for i in range(1, width + 1))
    quotient = tuple((f"T_{i}", G1_SIZE, False, 0) for i in range(1, width + 1))
    return (
        ((("circuit_size", 4, True, 0), ("public_input_size", 4, True, 0)),
         "init", 1, False),
        ((), "eta", 0, False),
        ((("public_inputs", FR_SIZE * pub, False, 0),) + wires, "beta", 2, False),
        ((("Z", G1_SIZE, False, 0),), "alpha", 1, False),
        (quotient, "z", 1, False),
        (nu_elements, "nu", num_nu, True),
        ((("PI_Z", G1_SIZE, False, 0), ("PI_Z_OMEGA", G1_SIZE, False, 0)),
         "separator", 1, False),
    )


def standard_manifest(pub: int) -> tuple:
    nu = (("t", FR_SIZE, True, -1), ("w_1", FR_SIZE, False, 0),
          ("w_2", FR_SIZE, False, 1), ("w_3", FR_SIZE, False, 2),
          ("sigma_1", FR_SIZE, False, 3), ("sigma_2", FR_SIZE, False, 4),
          ("r", FR_SIZE, False, 5), ("z_omega", FR_SIZE, False, -1),
          ("w_3_omega", FR_SIZE, False, 2))
    return _rounds(3, pub, nu, 7)


def turbo_manifest(pub: int) -> tuple:
    nu = (("t", FR_SIZE, True, -1), ("w_1", FR_SIZE, False, 0),
          ("w_2", FR_SIZE, False, 1), ("w_3", FR_SIZE, False, 2),
          ("w_4", FR_SIZE, False, 3), ("sigma_1", FR_SIZE, False, 4),
          ("sigma_2", FR_SIZE, False, 5), ("sigma_3", FR_SIZE, False, 6),
          ("q_arith", FR_SIZE, False, 7), ("q_ecc_1", FR_SIZE, False, 8),
          ("q_c", FR_SIZE, False, 9), ("r", FR_SIZE, False, 10),
          ("z_omega", FR_SIZE, False, -1), ("w_1_omega", FR_SIZE, False, 0),
          ("w_2_omega", FR_SIZE, False, 1), ("w_3_omega", FR_SIZE, False, 2),
          ("w_4_omega", FR_SIZE, False, 3))
    return _rounds(4, pub, nu, 11)


class Transcript:
    """A verifier's transcript, filled from the proof's bytes."""

    def __init__(self, manifest: tuple, proof: bytes):
        self.manifest = manifest
        self.elements: dict = {}
        self.challenges: dict = {}
        self.nu_index = {name: idx for els, _, _, mapped in manifest if mapped
                         for name, _, _, idx in els}
        self._round = 0
        self._last = b""
        off = 0
        for els, _, _, _ in manifest:
            for name, size, derived, _ in els:
                if not derived:
                    self.elements[name] = proof[off:off + size]
                    off += size
        if off != len(proof):
            raise ValueError(f"proof of {len(proof)} bytes, manifest {off}")

    def apply_fiat_shamir(self, name: str) -> None:
        els, challenge, count, _ = self.manifest[self._round]
        if challenge != name:
            raise ValueError(f"round {self._round} is {challenge}, not {name}")
        self._round += 1
        if count == 0:
            return
        buf = self._last
        for el, size, _, _ in els:
            data = self.elements[el]
            if len(data) != size:
                raise ValueError(f"{el}: {len(data)} bytes, not {size}")
            buf += data
        base = keccak256(buf)
        out = [base]
        for i in range(1, count):
            out.append(keccak256(base + bytes([i])))
        self._last = out[-1]
        self.challenges[name] = out

    def challenge(self, name: str, idx: int = 0) -> int:
        return int.from_bytes(self.challenges[name][idx], "big") % R

    def nu(self, label: str) -> int:
        idx = self.nu_index[label]
        return 1 if idx == -1 else self.challenge("nu", idx)

    def fr(self, name: str) -> int:
        return int.from_bytes(self.elements[name], "big") % R
