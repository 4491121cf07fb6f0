"""A circuit whose requests each carry an input of their own, small enough
for the CPU: unrolled Turbo at 2^8 rows.  Request ``index`` draws a and b;
its circuit proves a * b = ab and ab + a + shift = p for its public input p,
then steps a chain of additions to fill the rows.  ``shift`` is 1 only for
the request the configuration's ``shape_changes_at`` names, whose circuit
then has another constant in one gate: another shape, under another key."""

from plonkbench import seeds
from plonkbench.circuits import turbo_circuit
from plonkbench.reference.bn254 import R

CONFIG = {"circuit": "tiny_requests", "flavor": "turbo", "transcript": "pedersen_blake2s",
          "prover": "unrolled", "log2_subgroup": 8}
ADDS = 200


def _input(config, rnd, index):
    a, b = seeds.field(rnd), seeds.field(rnd)
    shift = int("shape_changes_at" in config and index == config["shape_changes_at"])
    return (a, b, shift), [(a * b + a + shift) % R]


def _circuit(config, tx, composer):
    from aztec_tpu_torch.plonk import AddTriple, MulTriple

    a, b, shift = tx
    ia, ib = composer.add_variable(a), composer.add_variable(b)
    ab = composer.add_variable(a * b % R)
    composer.create_mul_gate(MulTriple(ia, ib, ab, 1, -1, 0))
    pub = composer.add_public_variable((a * b + a + shift) % R)
    composer.create_add_gate(AddTriple(ab, ia, pub, 1, 1, -1, shift))
    acc, value = pub, (a * b + a + shift) % R
    for _ in range(ADDS):
        value = (value + b) % R
        nxt = composer.add_variable(value)
        composer.create_add_gate(AddTriple(acc, ib, nxt, 1, 1, -1, 0))
        acc = nxt
    if composer.subgroup_size() != 1 << config["log2_subgroup"]:
        raise ValueError(f"the circuit fills {composer.subgroup_size()} rows")
    return composer


def draw(config, seed, index):
    return _input(config, seeds.stream(seed, "tiny", index), index)


def build(config, seed, device):
    from aztec_tpu_torch.plonk.composer import TurboComposer

    tx, _ = _input(config, seeds.stream(seed, "tiny", "setup"), None)
    return _circuit(config, tx, TurboComposer(device=device))


def build_request(config, tx, device, shared):
    from aztec_tpu_torch.plonk.composer import TurboComposer

    return _circuit(config, tx, TurboComposer(crs_factory=shared.crs_factory,
                                              device=device))


def reference(config, seed, composer):
    return turbo_circuit(composer)
