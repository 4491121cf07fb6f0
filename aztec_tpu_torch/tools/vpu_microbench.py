"""Op-throughput microbenchmark: the card's counterpart of
tools/vpu_microbench.py.

Chains of one 32-bit operation (uint32 mul, add, shift by 1, and with
0xFFFF; the field formulas' mul-mask-add; float32 mul) over ``rows``
independent values per element column, NOPS operations per column, as the
TPU tool runs them over ``rows`` (8, 128) tiles.  ``vpu_chain`` launches
``mb_vpu`` of ``csrc/microbench.cu`` for CUDA tensors and uses
``vpu_chain_plain`` for CPU tensors; both give the TPU kernel's bits.

On the card:

    python -m aztec_tpu_torch.tools.vpu_microbench [--nblocks 64]

prints, for each rows value and kind, the device milliseconds, the
nanoseconds per 1024 element-ops (the TPU tool's ns per (8, 128) vector op),
the element-ops per second beside the CUDA C++ Programming Guide's rate for
the operation's class, the bound, the plain version's time and its
agreement with the kernel, and the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from .. import native
from ..ff import field_kernels as fk
from . import sass, timing

KINDS = ("add_u32", "mul_u32", "shift_u32", "and_u32", "mulmask", "mul_f32")
NOPS = 2048          # operations per element column per launch
ROWS_SET = (4, 16)   # the kernel's unrolled chain counts (the TPU tool's)
TILE = 1024          # elements of one TPU (8, 128) tile: one TPU grid step
UNROLL = 8           # steps of each chain per trip of the kernel's loop
# Results per clock per SM of each kind's instruction class on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput: 32-bit integer add, logic, shift and multiply-add 64, fp32
# multiply 128), and the instructions one element-op takes (mulmask is a
# multiply, an and and an add).
GUIDE = {"add_u32": (64, 1), "mul_u32": (64, 1), "shift_u32": (64, 1),
         "and_u32": (64, 1), "mulmask": (64, 3), "mul_f32": (128, 1)}

I32, I64 = torch.int32, torch.int64
M32 = 0xFFFFFFFF


def launch(entry: str, name: str, lead, a, b, n: int, tail=()):
    """Launch ``entry`` of csrc/microbench.cu as
    entry(*lead, a, b, out, n, *tail, stream) over int32 CUDA tensors of
    one shape; count it as ``name``; return ``out``."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"{name}: both operands must be on one CUDA device")
    if a.dtype != I32 or b.dtype != I32 or a.shape != b.shape:
        raise ValueError(f"{name}: expected int32 operands of one shape, got "
                         f"{a.dtype} {tuple(a.shape)}, {b.dtype} "
                         f"{tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if n:
        stream = torch.cuda.current_stream(a.device).cuda_stream
        f = getattr(native.library("microbench"), entry)
        rc = f(*lead, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, *tail,
               stream)
        native.check(rc, entry)
        fk.LAUNCHES[name] += 1
        fk.ELEMS[name] += n
    return out


def _check(kind, rows, a, b):
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    if a.shape != b.shape or a.dim() < 2 or a.shape[0] != rows:
        raise ValueError(f"expected two ({rows}, ...) operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def mul32(x, y):
    """x * y mod 2^32 of int64 values in [0, 2^32), with no int64
    overflow: y is split into 16-bit halves."""
    return (x * (y & 0xFFFF) + (((x * (y >> 16)) & 0xFFFF) << 16)) & M32


def vpu_chain_plain(kind: str, rows: int, a, b, nops: int = NOPS):
    """The TPU kernel's chains in int64 (this torch has no uint32
    arithmetic on the CPU): nops // rows steps of ``kind`` on each of the
    ``rows`` values of every element column.  a, b: (rows, ...) int32
    holding uint32 bits; returns the same shape."""
    _check(kind, rows, a, b)
    steps = nops // rows
    x, y = a.to(I64) & M32, b.to(I64) & M32
    if kind == "mul_f32":
        if steps:
            xf, yf = x.to(torch.float32), y.to(torch.float32)
            for _ in range(steps):
                xf = xf * yf
            # float -> uint32 saturates as the reference's does: inf and
            # values past 2^32 - 1 give 0xFFFFFFFF, NaN gives 0
            v = xf.to(torch.float64)
            x = torch.where(torch.isnan(v), 0.0,
                            v.clamp(0, M32).trunc()).to(I64)
    else:
        step = {
            "add_u32": lambda x: (x + y) & M32,
            "mul_u32": lambda x: mul32(x, y),
            "shift_u32": lambda x: x >> 1,
            "and_u32": lambda x: x & 0xFFFF,
            "mulmask": lambda x: ((mul32(x, y) & 0xFFFF) + x) & M32,
        }[kind]
        for _ in range(steps):
            x = step(x)
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(I32)


def vpu_chain(kind: str, rows: int, a, b, nops: int = NOPS):
    """NOPS-operation chains of ``kind`` over (rows, ...) int32 operands:
    the CUDA kernel for CUDA tensors (rows 4 or 16), the plain version for
    CPU tensors."""
    _check(kind, rows, a, b)
    if not (a.is_cuda or b.is_cuda):
        return vpu_chain_plain(kind, rows, a, b, nops)
    if rows not in ROWS_SET:
        raise ValueError(f"the kernel is built for rows {ROWS_SET}, not {rows}")
    return launch("mb_vpu", f"vpu_{kind}", (KINDS.index(kind), rows), a, b,
                  a[0].numel(), (nops,))


def run(nblocks: int = 64, device: str = "cuda", log=print) -> dict:
    """Time every kind at each rows value on the card over nblocks TPU
    tiles' worth of element columns (1024 each), a in [0, 2^16) and b in
    [1, 2^16) as the TPU tool draws them, and hold each timed launch's
    output against the plain version on the same inputs, bit for bit.
    Returns {(rows, kind): {ms (device), call_ms (CUDA events around
    wrapper calls), plain_ms, max_abs_err, bound_ms, bound_by,
    instrs_per_op, element_ops, ops_per_s, guide_per_s}}.  The bound is the
    larger of the 12 bytes a chain moves and the compiled loop's
    instructions (``sass``) at the SM's issue rate."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("vpu_microbench times the card: it needs CUDA")
    card = timing.card_line()
    per_sm_clock = timing.peak_per_s(1)
    compiled = sass.kernels("microbench")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ncols = nblocks * TILE
    log(f"vpu_microbench: NOPS={NOPS} nblocks={nblocks} ({ncols} element "
        f"columns) on {card}")
    results = {}
    for rows in ROWS_SET:
        a = torch.randint(0, 1 << 16, (rows, ncols), generator=gen,
                          dtype=I32, device=dev)
        b = torch.randint(1, 1 << 16, (rows, ncols), generator=gen,
                          dtype=I32, device=dev)
        steps = NOPS // rows                  # a multiple of UNROLL
        ops = ncols * rows * steps            # every chain's steps
        for kind in KINDS:
            def fn():
                return vpu_chain(kind, rows, a, b)

            call, out = timing.call_ms(fn)
            ms = timing.device_ms(fn)
            plain_ms, want = timing.call_ms(
                lambda: vpu_chain_plain(kind, rows, a, b), 1)
            err = int((out.to(I64) - want.to(I64)).abs().max())
            if err:
                raise AssertionError(f"vpu_{kind} rows={rows}: the kernel "
                                     f"differs from its plain version at "
                                     f"{ncols} columns")
            del out, want
            loop = compiled[("vpu_kernel", (KINDS.index(kind), rows))].loop
            if not loop:
                raise RuntimeError(f"no loop in the SASS of vpu_{kind} "
                                   f"rows={rows}")
            bnd, by = timing.bound(3 * 4 * rows * ncols, timing.issue_ms(
                ncols * (steps // UNROLL) * loop))
            per_clock, instrs = GUIDE[kind]
            guide = per_clock * per_sm_clock / instrs
            rate = ops / (ms * 1e-3)
            results[(rows, kind)] = {
                "ms": ms, "call_ms": call, "plain_ms": plain_ms,
                "max_abs_err": err, "bound_ms": bnd, "bound_by": by,
                "instrs_per_op": loop / (UNROLL * rows), "element_ops": ops,
                "ops_per_s": rate, "guide_per_s": guide}
            log(f"rows={rows:3d} {kind:10s} {ms:9.4f} ms (call {call:.4f}, "
                f"plain {plain_ms:.2f}, bound {bnd:.4f} by {by}, "
                f"{loop / (UNROLL * rows):.3f} instructions an op)  "
                f"{ms * 1e6 / (ops / TILE):8.4f} ns/1024 element-ops  "
                f"{rate:.4e} element-ops/s  guide {guide:.4e}/s "
                f"({rate / guide:.3f} of it)  max_abs_err={err}  {card}")
        del a, b
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nblocks", type=int, default=64,
                   help="TPU (8, 128) tiles' worth of element columns "
                        "(1024 each); the TPU tool's 64 by default")
    run(p.parse_args(argv).nblocks)


if __name__ == "__main__":
    main()
