"""The port's Noir compiler (aztec_tpu_torch.noir) against aztec_tpu's, on
the CPU.

The programs of tests/test_noir.py and the SHA-256 program of
``aztec_tpu_torch/tools/noir_sha256.py`` (one and two blocks) parse to the
same ASTs in both packages and compile onto both packages'
``TurboComposer`` to the same results and the same recorded circuit
(``make_vectors.gate_digest``: gates, witnesses, copy classes, public
inputs); the port's circuit passes ``check_turbo``, and the SHA-256
program's digest is hashlib's.  The compiler's refusals (a loop bound or
an index that is not a constant, an undefined name, a wrong arity) are
held to aztec_tpu's words.  All checks are exact.
"""

import hashlib
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_vectors"))
from make_vectors import gate_digest  # noqa: E402

import aztec_tpu.noir as ref_noir  # noqa: E402
from aztec_tpu.plonk.composer import TurboComposer as RefTurboComposer  # noqa: E402
from aztec_tpu_torch import noir  # noqa: E402
from aztec_tpu_torch.plonk.circuit_check import check_turbo  # noqa: E402
from aztec_tpu_torch.plonk.composer import TurboComposer  # noqa: E402
from aztec_tpu_torch.tools import noir_sha256  # noqa: E402

from test_noir import MIX, mix_model  # noqa: E402

SEED = 20261018

FIELD_BOOL = """
field main(field x, field y, bool flip)
{
    field p = x * y + 7;
    if (true) { p = p + 1; }
    bool eq = p == p;
    return p * (x + y);
}
"""

UINT8 = """
uint8 main(uint8 a, uint8 b)
{
    uint8 c = a + b;
    return c ^ (a & b);
}
"""

STATIC_INDEX = """
uint32 main(uint32[4] xs)
{
    uint32 acc = 0;
    for (i in 0..4) {
        acc = acc + xs[3 - i];
    }
    return acc;
}
"""

UINT_MIX = """
uint64 main(uint64 a, uint16 b, uint32 c)
{
    uint64 d = a * a - 5;
    uint16 e = b | (b << 3);
    uint32 f = (c >> 5) ^ (c >>> 9) - 1;
    bool g = f != c;
    uint64 h = -d;
    return d + h + 7;
}
"""

PROGRAMS = {
    "mix": (MIX, [[0x11223344, 0x55667788]], mix_model([0x11223344,
                                                        0x55667788])),
    "field_bool": (FIELD_BOOL, [3, 5, 1], (3 * 5 + 7 + 1) * (3 + 5)),
    "uint8": (UINT8, [200, 100], ((200 + 100) & 0xFF) ^ (200 & 100)),
    "static_index": (STATIC_INDEX, [[1, 2, 3, 4]], 10),
    "uint_mix": (UINT_MIX, [0xFFFFFFFF12345678, 0xBEEF, 0xC0FFEE11], 7),
}


def _sha_case(nbytes: int):
    msg = random.Random(SEED + nbytes).randbytes(nbytes)
    blocks = noir_sha256.blocks_of(msg)
    return (noir_sha256.source(blocks), [noir_sha256.pad(msg)],
            noir_sha256.digest_words(msg))


PROGRAMS["sha256_1_block"] = _sha_case(55)
PROGRAMS["sha256_2_blocks"] = _sha_case(100)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_parse_as_reference(name):
    src = PROGRAMS[name][0]
    assert noir.parse(src) == ref_noir.parse(src)
    assert noir.parser.tokenize(src) == ref_noir.parser.tokenize(src)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_compile_as_reference(name):
    src, inputs, want = PROGRAMS[name]
    mine = TurboComposer(device="cpu")
    theirs = RefTurboComposer()
    out = noir.compile_program(mine, src, inputs)
    ref = ref_noir.compile_program(theirs, src, inputs)
    assert out.result == ref.result == want
    assert gate_digest(mine) == gate_digest(theirs)
    assert not mine.failed
    assert check_turbo(mine) == []


def test_sha256_program_is_hashlib():
    """The padding helper and the digest words against hashlib, and the
    gate counts of one and two blocks (the 16-block program of the smoke
    is 16 times the compression)."""
    for nbytes, blocks in ((0, 1), (55, 1), (56, 2), (64, 2), (1000, 16)):
        msg = bytes(range(256)) * 4
        msg = msg[:nbytes]
        words = noir_sha256.pad(msg)
        assert noir_sha256.blocks_of(msg) == blocks
        assert len(words) == 16 * blocks
        d = hashlib.sha256(msg).digest()
        assert noir_sha256.digest_words(msg) == [
            int.from_bytes(d[i:i + 4], "big") for i in range(0, 32, 4)]
    src, inputs, _ = PROGRAMS["sha256_1_block"]
    c = TurboComposer(device="cpu")
    noir.compile_program(c, src, inputs)
    assert c.n == 28545


def test_sha256_program_tamper_fails():
    src, inputs, want = PROGRAMS["sha256_1_block"]
    c = TurboComposer(device="cpu")
    out = noir.compile_program(c, src, inputs)
    word = out.result_vals[3]
    c.variables[c.real_variable_index[word.witness_index]] ^= 1
    assert out.result == want
    assert check_turbo(c) != []


@pytest.mark.parametrize("src,inputs", (
    ("uint32 main(uint32 x) { for (i in 0..x) { x = x + 1; } return x; }",
     [3]),
    ("uint32 main(uint32[2] x) { return x[x[0]]; }", [[0, 1]]),
    ("uint32 main(uint32 x) { return y; }", [1]),
    ("uint32 main(uint32 x) { y = x; return x; }", [1]),
    ("uint32 main(uint32 x) { return x; }", [1, 2]),
    ("uint32 main(uint32[2] x) { return x[0]; }", [[1, 2, 3]]),
    ("field main(field x) { return x << 2; }", [1]),
))
def test_refusals_as_reference(src, inputs):
    def err(pkg, comp):
        with pytest.raises(Exception) as e:
            pkg.compile_program(comp, src, inputs)
        return type(e.value).__name__, str(e.value)

    assert err(noir, TurboComposer(device="cpu")) == err(ref_noir,
                                                         RefTurboComposer())
