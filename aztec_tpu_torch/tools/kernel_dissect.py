"""Dissect a Montgomery product: the card's counterpart of
tools/kernel_dissect.py.

Four bodies over (16, n) planes of 16-bit limbs of the base field Fq, each
its own kernel launch (``mb_dissect`` of ``csrc/microbench.cu``):

  products   - 256 16 x 16-bit products, lo and hi halves into 32 columns,
               folded to 16 outputs (no carries)
  comba_full - product scanning, the low 16 columns rippled to digits
  canon4     - four ripple canonicalisations
  mont_full  - the whole Montgomery product (the TPU's KF.mul)

``dissect`` launches the kernel for CUDA tensors and uses
``dissect_plain`` for CPU tensors.  The first three bodies are defined by
their exact integer outputs, which the plain versions compute in the TPU's
16-bit column form; ``mont_full`` is ``ff.limb.mont_mul``, which gives the
reference's bits on any 16-bit limbs.  Operands are 16-bit limbs, as the
TPU tool draws them.

On the card:

    python -m aztec_tpu_torch.tools.kernel_dissect [--nf 512]
"""

from __future__ import annotations

import argparse

import torch

from ..ff import FQ, limb
from . import sass, timing
from .vpu_microbench import launch

BODIES = ("products", "comba_full", "canon4", "mont_full")
L = 16
MASK = 0xFFFF
I32, I64 = torch.int32, torch.int64


def _cols(a, b):
    """The TPU's split-column schoolbook product (pallas_field.KF.mul_cols):
    the lo half of a_i b_j into column i + j, the hi half into i + j + 1.
    (16, N) int64 limbs -> (32, N) columns, each < 2^21."""
    cols = torch.zeros((2 * L, a.shape[1]), dtype=I64, device=a.device)
    for i in range(L):
        p = a[i] * b                  # a_i b_j for every j: (16, N)
        cols[i:i + L] += p & MASK
        cols[i + 1:i + L + 1] += p >> 16
    return cols


def body_products(a, b):
    cols = _cols(a, b)
    return cols[:L] + cols[L:]


def body_comba_full(a, b):
    """Product scanning: column k of the scan is column k of ``_cols``; the
    low 16 ripple to digits (their carry out is dropped), the high 16 stay
    redundant and are added to them."""
    cols = _cols(a, b)
    digits, carry = [], 0
    for k in range(L):
        v = cols[k] + carry
        digits.append(v & MASK)
        carry = v >> 16
    return torch.stack(digits) + cols[L:]


def body_canon4(a, b):
    x = a + b
    for _ in range(4):
        digits, carry = [], 0
        for k in range(L):
            v = x[k] + carry
            digits.append(v & MASK)
            carry = v >> 16
        x = torch.stack(digits) + b
    return x


def body_mont(a, b):
    return limb.kf(FQ, a.device).mul(a, b)


# the TPU tool's mont_comba falls back to KF.mul: KF has no mul_comba
body_mont_comba = body_mont

PLAIN = {"products": body_products, "comba_full": body_comba_full,
         "canon4": body_canon4, "mont_full": body_mont}


def _check(body, a, b):
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; expected one of {BODIES}")
    if a.shape != b.shape or a.dim() < 2 or a.shape[0] != L:
        raise ValueError(f"expected two (16, ...) limb planes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def dissect_plain(body: str, a, b):
    """The body in int64 on (16, ...) int32 limb planes; same shape out."""
    _check(body, a, b)
    n = a[0].numel()
    out = PLAIN[body](a.to(I64).reshape(L, n), b.to(I64).reshape(L, n))
    return out.to(I32).reshape(a.shape)


def dissect(body: str, a, b):
    """One body over (16, ...) int32 limb planes: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(body, a, b)
    if not (a.is_cuda or b.is_cuda):
        return dissect_plain(body, a, b)
    return launch("mb_dissect", f"dissect_{body}", (BODIES.index(body),), a,
                  b, a[0].numel())


def dissect_bound(kern: sass.Kernel, n: int):
    """(least ms, what bounds it) of one body over n elements from its
    compiled code ``kern`` (one element a thread, no loop): the 192 bytes
    an element moves, its instructions at the SM's issue rate, or its
    instructions of each class at that class's rate, whichever is
    longest."""
    return timing.bound(3 * L * 4 * n, max(timing.issue_ms(n * kern.count),
                                           timing.class_ms(kern.hist, n)))


def run(nf: int = 512, device: str = "cuda", log=print) -> dict:
    """Time every body on the card over nf x 128 elements of uniform 16-bit
    limbs (the TPU tool's inputs), and hold each timed launch's output
    against the plain version on the same inputs, bit for bit.  Returns
    {body: {ms (device), call_ms (CUDA events around wrapper calls),
    plain_ms, max_abs_err, bound_ms, bound_by}}: the bound is
    ``dissect_bound`` of the compiled body (``sass``)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("kernel_dissect times the card: it needs CUDA")
    card = timing.card_line()
    compiled = sass.kernels("microbench")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    n = nf * 128
    a, b = (torch.randint(0, 1 << 16, (L, n), generator=gen, dtype=I32,
                          device=dev) for _ in range(2))
    log(f"kernel_dissect: elems={n} on {card}")
    results = {}
    for body in BODIES:
        def fn():
            return dissect(body, a, b)

        call, out = timing.call_ms(fn)
        ms = timing.device_ms(fn)
        plain_ms, want = timing.call_ms(lambda: dissect_plain(body, a, b), 1)
        err = int((out.to(I64) - want.to(I64)).abs().max())
        if err:
            raise AssertionError(f"dissect_{body}: the kernel differs from "
                                 f"its plain version at {n} elements")
        del out, want
        kern = compiled[("dissect_kernel", (BODIES.index(body),))]
        if kern.loop:
            raise RuntimeError(f"dissect_{body} compiled to a loop: its "
                               "instruction count is not one element's")
        bnd, by = dissect_bound(kern, n)
        results[body] = {"ms": ms, "call_ms": call, "plain_ms": plain_ms,
                         "max_abs_err": err, "bound_ms": bnd, "bound_by": by,
                         "instrs": kern.count}
        log(f"{body:24s} {ms * 1e3:9.1f} us total  "
            f"{ms * 1e6 / n:7.4f} ns/elem  (device time; call "
            f"{call * 1e3:.1f} us, plain {plain_ms:.2f} ms, bound "
            f"{bnd * 1e3:.1f} us by {by}, {kern.count} instructions an "
            f"element)  max_abs_err={err}  {card}")
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nf", type=int, default=512,
                   help="rows of 128 elements; the TPU tool's 512 by default")
    run(p.parse_args(argv).nf)


if __name__ == "__main__":
    main()
