"""barretenberg's Fiat-Shamir transcript and the manifests of its Standard
and Turbo provers, linearised with the Keccak hash and unrolled Turbo with
the Pedersen-then-Blake2s hash (plonk/transcript/transcript.cpp;
standard_composer.hpp and turbo_composer.hpp create_manifest and
create_unrolled_manifest).

A round hashes the previous round's last challenge (none in round 0) and
the round's elements in manifest order.  A hash gives 32 / challenge_bytes
challenges, each its slice of the hash right-aligned in 32 bytes; further
challenges of a round come from expand(base_hash || counter).  Keccak
hashes with keccak256 both ways and takes 32-byte challenges; the unrolled
transcript Pedersen-compresses a round's buffer to one element and
Blake2s-hashes its 32 bytes, expands with plain Blake2s and takes 16-byte
challenges (transcript.cpp:128-133, 170-173).
A manifest entry is ``(name, bytes, derived_by_verifier, nu_index)``.
"""

from __future__ import annotations

import dataclasses
import hashlib

from . import pedersen
from .bn254 import R
from .keccak import keccak256

G1_SIZE, FR_SIZE = 64, 32
PRNG_OUTPUT_SIZE = 32


@dataclasses.dataclass(frozen=True)
class Hash:
    base: object            # a round's buffer -> 32 bytes
    expand: object          # base_hash || counter -> 32 bytes
    challenge_bytes: int


def pedersen_blake2s(buf: bytes) -> bytes:
    return hashlib.blake2s(pedersen.compress_buffer(buf).to_bytes(32, "big")).digest()


def _blake2s(buf: bytes) -> bytes:
    return hashlib.blake2s(buf).digest()


KECCAK = Hash(keccak256, keccak256, 32)
PEDERSEN_BLAKE2S = Hash(pedersen_blake2s, _blake2s, 16)


def _rounds(width: int, pub: int, nu_elements: tuple, num_nu: int,
            num_separator: int = 1) -> tuple:
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
         "separator", num_separator, False),
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


def unrolled_turbo_manifest(pub: int) -> tuple:
    """Every polynomial opened: no r, each selector and sigma_4 and z by
    itself (z_omega shares z's nu), and three separator challenges."""
    opened = ("w_1", "w_2", "w_3", "w_4", "sigma_1", "sigma_2", "sigma_3",
              "sigma_4", "q_1", "q_2", "q_3", "q_4", "q_5", "q_m", "q_c",
              "q_arith", "q_logic", "q_range", "q_ecc_1", "z")
    nu = ((("t", FR_SIZE, True, -1),)
          + tuple((name, FR_SIZE, False, i) for i, name in enumerate(opened))
          + (("z_omega", FR_SIZE, False, 19),)
          + tuple((f"w_{i}_omega", FR_SIZE, False, i - 1) for i in range(1, 5)))
    return _rounds(4, pub, nu, 20, num_separator=3)


class Transcript:
    """A verifier's transcript, filled from the proof's bytes."""

    def __init__(self, manifest: tuple, proof: bytes, hash_: Hash = KECCAK):
        self.manifest = manifest
        self.hash = hash_
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
        size = self.hash.challenge_bytes
        per_hash = PRNG_OUTPUT_SIZE // size
        base = self.hash.base(buf)
        out = []
        for i in range(-(-count // per_hash)):
            h = base if i == 0 else self.hash.expand(base + bytes([i]))
            for j in range(min(per_hash, count - per_hash * i)):
                out.append(bytes(PRNG_OUTPUT_SIZE - size) + h[j * size:(j + 1) * size])
        self._last = out[-1]
        self.challenges[name] = out

    def challenge(self, name: str, idx: int = 0) -> int:
        return int.from_bytes(self.challenges[name][idx], "big") % R

    def nu(self, label: str) -> int:
        idx = self.nu_index[label]
        return 1 if idx == -1 else self.challenge("nu", idx)

    def fr(self, name: str) -> int:
        return int.from_bytes(self.elements[name], "big") % R
