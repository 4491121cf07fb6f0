"""aztec_tpu_torch.tools (the microbenchmark kernels' plain versions)
against the TPU tools of ``tools/``, bit for bit.

``vpu_chain`` against ``tools/vpu_microbench.make(kind, rows)`` run in
Pallas interpret mode with NOPS cut to 16 and 2 grid steps; ``dissect``
against ``tools/kernel_dissect``'s bodies called on jnp arrays of
(16, 8, 128) limbs.  Every integer result must be equal, and ``mul_f32``
too: its only rounding is the IEEE float32 multiply, round to nearest, on
both sides.  Inputs are made with numpy from a seed.  The ``cuda``-marked
cases hold each kernel against its plain version on a card.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aztec_tpu_torch.ff import field_kernels as fk
from aztec_tpu_torch.tools import kernel_dissect, sass, vpu_microbench

TOOLS = Path(__file__).resolve().parent.parent / "tools"
NOPS = 16
NBLOCKS = 2
RAGGED = 1000        # element columns: not a multiple of 128 or of 256


@functools.lru_cache(maxsize=None)
def _tpu_tool(name):
    spec = importlib.util.spec_from_file_location(f"tpu_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vpu_inputs(rows, seed=0):
    rng = np.random.default_rng(seed)
    shape = (rows, NBLOCKS * 8, 128)
    return (rng.integers(0, 1 << 16, shape, dtype=np.uint32),
            rng.integers(1, 1 << 16, shape, dtype=np.uint32))


def _t(x):
    return torch.from_numpy(x.astype(np.int64)).to(torch.int32)


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("rows", vpu_microbench.ROWS_SET)
@pytest.mark.parametrize("kind", vpu_microbench.KINDS)
def test_vpu_chain_matches_tpu_tool(kind, rows, monkeypatch):
    tool = _tpu_tool("vpu_microbench")
    monkeypatch.setattr(tool, "NOPS", NOPS)
    a, b = _vpu_inputs(rows)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tool.make(kind, rows)(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = vpu_microbench.vpu_chain(kind, rows, _t(a), _t(b), NOPS)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_u32(got), want)
    # a ragged width: the first RAGGED element columns alone
    ra, rb = (_t(x).reshape(rows, -1)[:, :RAGGED] for x in (a, b))
    np.testing.assert_array_equal(
        _u32(vpu_microbench.vpu_chain(kind, rows, ra, rb, NOPS)),
        want.reshape(rows, -1)[:, :RAGGED])


def test_vpu_plain_saturates_and_wraps():
    """mul_f32 saturates to 0xFFFFFFFF and keeps 0; the integer chains wrap
    mod 2^32 (the reference's uint32)."""
    a = _t(np.array([[0, 3, 1 << 15, 0xFFFFFFFF]], np.uint32))
    b = _t(np.array([[7, 2, 1 << 15, 0xFFFFFFFF]], np.uint32))
    f32 = _u32(vpu_microbench.vpu_chain_plain("mul_f32", 1, a, b, 5))
    assert f32.tolist() == [[0, 96, 0xFFFFFFFF, 0xFFFFFFFF]]
    mul = _u32(vpu_microbench.vpu_chain_plain("mul_u32", 1, a, b, 3))
    want = [(int(x) * int(y) ** 3) % (1 << 32)
            for x, y in zip(_u32(a)[0], _u32(b)[0])]
    assert mul.tolist() == [want]


def _limbs(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 16, (16,) + shape, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _tpu_body(body, shape):
    """The TPU tool's body on jnp limb planes of ``shape``: (16, *shape)."""
    tool = _tpu_tool("kernel_dissect")
    fn = {"products": tool.body_products, "comba_full": tool.body_comba_full,
          "canon4": tool.body_canon4, "mont_full": tool.body_mont,
          "mont_comba": tool.body_mont_comba}[body]
    a, b = (jnp.asarray(_limbs(s, shape)) for s in (5, 6))
    out = fn([a[i] for i in range(16)], [b[i] for i in range(16)])
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("ragged", [False, True], ids=["tile", "ragged"])
@pytest.mark.parametrize("body", kernel_dissect.BODIES + ("mont_comba",))
def test_dissect_matches_tpu_tool(body, ragged):
    """On the tile, and on its first RAGGED elements (the bodies work
    element by element)."""
    shape = (8, 128)
    want = _tpu_body(body, shape)
    a, b = (_t(_limbs(s, shape)) for s in (5, 6))
    if ragged:
        a, b = (x.reshape(16, -1)[:, :RAGGED] for x in (a, b))
        want = want.reshape(16, -1)[:, :RAGGED]
    if body == "mont_comba":
        got = kernel_dissect.body_mont_comba(a.to(torch.int64).reshape(16, -1),
                                             b.to(torch.int64).reshape(16, -1))
        got = got.to(torch.int32).reshape(a.shape)
    else:
        got = kernel_dissect.dissect(body, a, b)
    np.testing.assert_array_equal(_u32(got), want)


def test_wrappers_use_plain_versions_on_cpu():
    a, b = (_t(_limbs(s, (64,))) for s in (1, 2))
    before = dict(fk.LAUNCHES)
    for body in kernel_dissect.BODIES:
        assert torch.equal(kernel_dissect.dissect(body, a, b),
                           kernel_dissect.dissect_plain(body, a, b))
    for kind in vpu_microbench.KINDS:
        assert torch.equal(vpu_microbench.vpu_chain(kind, 16, a, b, NOPS),
                           vpu_microbench.vpu_chain_plain(kind, 16, a, b,
                                                          NOPS))
    assert dict(fk.LAUNCHES) == before  # nothing launched on the CPU
    with pytest.raises(ValueError):
        vpu_microbench.vpu_chain("div_u32", 16, a, b)
    with pytest.raises(ValueError):
        kernel_dissect.dissect("products", a[:8], b[:8])


# A cut-down ``cuobjdump -sass`` listing: a vpu kernel with an 8-instruction
# loop (its label before the body, the branch back at its end) and a
# straight-line dissect kernel, each ending in a branch to itself.
LISTING = """
        Function : _ZN12_GLOBAL__N_110vpu_kernelILi1ELi4EEEvPKjS2_Pjxij5Masks
        /*0000*/                   LDC R1, c[0x0][0x28] ;
                                                          /* 0x000fe20000000800 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x8, PT ;
        /*0020*/              @!P0 BRA `(.L_x_2) ;
.L_x_1:
        /*0030*/                   IMAD R2, R2, R6, RZ ;
        /*0040*/                   IMAD R3, R3, R7, RZ ;
        /*0050*/                   IMAD R4, R4, R8, RZ ;
        /*0060*/                   IMAD R5, R5, R9, RZ ;
        /*0070*/                   IADD3 R0, R0, 0x8, RZ ;
        /*0080*/                   NOP ;
        /*0090*/                   ISETP.GT.AND P0, PT, R0, R10, PT ;
        /*00a0*/                   IMAD.MOV.U32 R11, RZ, RZ, R0 ;
        /*00b0*/               @P0 BRA `(.L_x_1) ;
.L_x_2:
        /*00c0*/                   STG.E [R12.64], R2 ;
        /*00d0*/                   EXIT ;
.L_x_3:
        /*00e0*/                   BRA `(.L_x_3);
        /*00f0*/                   NOP;
        Function : _ZN12_GLOBAL__N_114dissect_kernelILi2EEEvPKjS2_Pjx
        /*0000*/                   LDG.E R2, [R4.64] ;
        /*0010*/              @P0 EXIT ;
        /*0020*/                   LOP3.LUT R2, R2, 0xffff, RZ, 0xc0, !PT ;
        /*0030*/                   STG.E [R6.64], R2 ;
        /*0040*/                   EXIT ;
        /*0050*/                   BRA 0x50;
        /*0060*/                   NOP;
        Function : _Z11other_kernelPj
        /*0000*/                   EXIT ;
"""


def test_sass_parse_counts_loops_and_instructions():
    got = sass.parse(LISTING)
    assert set(got) == {("vpu_kernel", (1, 4)), ("dissect_kernel", (2,))}
    vpu = got[("vpu_kernel", (1, 4))]
    assert vpu.loop == 8                   # 0x30..0xb0 less the NOP
    assert vpu.count == 13                 # less two NOPs and the tail BRA
    assert vpu.hist["IMAD"] == 5 and vpu.hist["BRA"] == 3
    assert vpu.loop_hist == {"IMAD": 5, "IADD3": 1, "ISETP": 1, "BRA": 1}
    dis = got[("dissect_kernel", (2,))]
    assert (dis.loop, dis.count) == (0, 5)
    assert dis.hist["EXIT"] == 2


@pytest.mark.parametrize("tool", ["vpu", "dissect"])
def test_bounds_take_the_class_rate(tool, monkeypatch):
    """The microbenchmarks' bounds on made-up SASS counts, on a made-up card
    of one SM at 1 GHz: a loop of 16 shifts and 2 other instructions is
    bound by its shifts at 64 a clock (16 / 64 > 18 / 128), one of 16
    fp32 multiplies and 16 other instructions by the issue rate of 128 a
    clock (16 / 128 < 32 / 128); the bytes where they take longer."""
    import collections

    from aztec_tpu_torch.tools import timing

    monkeypatch.setattr(timing, "peak_per_s", lambda rate: rate * 1e9)
    monkeypatch.setattr(timing, "HBM_BYTES_PER_S", 1e12)

    def bound(hist, repeats):
        count = sum(hist.values())
        if tool == "vpu":              # UNROLL steps a trip, rows 1
            k = sass.Kernel(collections.Counter(), count, count,
                            collections.Counter(hist))
            return vpu_microbench.vpu_bound(k, 1, repeats,
                                            vpu_microbench.UNROLL)
        k = sass.Kernel(collections.Counter(hist), 0, count)
        return kernel_dissect.dissect_bound(k, repeats)

    n = 1 << 20
    shifts = {"SHF": 16, "IADD3": 1, "ISETP": 1}
    assert bound(shifts, n) == (pytest.approx(16 * n / 64e9 * 1e3),
                                "operations")
    fmul = {"FMUL": 16, "IADD3": 8, "ISETP": 8}
    assert bound(fmul, n) == (pytest.approx(32 * n / 128e9 * 1e3),
                              "operations")
    monkeypatch.setattr(timing, "HBM_BYTES_PER_S", 1e9)
    nbytes = 12 * n if tool == "vpu" else 192 * n
    assert bound(shifts, n) == (pytest.approx(nbytes / 1e9 * 1e3), "bytes")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [NBLOCKS * 1024, RAGGED])
@pytest.mark.parametrize("rows", vpu_microbench.ROWS_SET)
@pytest.mark.parametrize("kind", vpu_microbench.KINDS)
def test_vpu_kernel_matches_plain_on_card(kind, rows, ncols):
    _needs_card()
    rng = np.random.default_rng(7)
    a = _t(rng.integers(0, 1 << 16, (rows, ncols), dtype=np.uint32))
    b = _t(rng.integers(1, 1 << 16, (rows, ncols), dtype=np.uint32))
    got = vpu_microbench.vpu_chain(kind, rows, a.cuda(), b.cuda())
    assert torch.equal(got.cpu(), vpu_microbench.vpu_chain_plain(kind, rows,
                                                                 a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8 * 128, RAGGED])
@pytest.mark.parametrize("body", kernel_dissect.BODIES)
def test_dissect_kernel_matches_plain_on_card(body, n):
    _needs_card()
    a, b = (_t(_limbs(s, (n,))) for s in (8, 9))
    got = kernel_dissect.dissect(body, a.cuda(), b.cuda())
    assert torch.equal(got.cpu(), kernel_dissect.dissect_plain(body, a, b))


# A cut-down ``cuobjdump -res-usage`` listing: K2 kernels in a namespace
# whose mangled name holds digits, a template with a field and a bool
RES_USAGE = """
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN24_GLOBAL__N_9a1f_group_ops15proj_add_kernelIN5aztec2FqELb1EEEvPKjS4_S4_S4_S4_S4_PjS5_S5_NS1_8Const256Ex:
  REG:128 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:624 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN24_GLOBAL__N_9a1f_group_ops17add_unsafe_kernelIN5aztec2FrEEEvPKjS4_S4_S4_S4_S4_PjS5_S5_x:
  REG:128 STACK:56 SHARED:0 LOCAL:0 CONSTANT[0]:616 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z11other_kernelPj:
  REG:8 STACK:0 SHARED:0 LOCAL:0
"""


def test_sass_parse_resources_keys_fields_and_bools():
    got = sass.parse_resources(RES_USAGE)
    assert set(got) == {("proj_add_kernel", ("Fq", 1)),
                        ("add_unsafe_kernel", ("Fr",))}
    assert got[("add_unsafe_kernel", ("Fr",))]["STACK"] == 56
    assert got[("proj_add_kernel", ("Fq", 1))]["REG"] == 128
    assert sass.parse_resources("Resource usage:\n") == {}
