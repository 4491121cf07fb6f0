"""K1: the elementwise field kernels, and the launch plumbing every kernel
wrapper of the port shares.

Port of aztec_tpu/ff/pallas_field.py.  The TPU package runs a field formula
over (16, 8, 128) tiles in one Pallas kernel (``_elementwise_call``); here
``csrc/field_ops.cu`` runs it with one CUDA thread per element, with the
limbs repacked to 8 x 32 bits in registers (``csrc/field.cuh``).

``mont_pow`` runs the whole square-and-multiply ladder of a power (every
Fermat inversion of the prover and of ``to_affine``) in one launch, where
the reference scans ``mont_mul`` (aztec_tpu/ff/limb.py ``mont_pow``).

Dispatch: ``use_kernels(t)`` is true exactly for CUDA tensors.  A wrapper
computes with the plain PyTorch version (``ff/limb.py``) only because its
tensors lie on the CPU; for CUDA tensors it launches the kernel or raises.
Operands that broadcast (1/n, GLV's beta) are materialised with
``expand(...).contiguous()`` before the launch, so every elementwise kernel
sees contiguous (16, N) planes; the FFT's stage kernel (``fft_stages``)
reads its stage's rows and the root table where they lie.

``LAUNCHES`` counts kernel launches by name and ``ELEMS`` the elements
they ran over (lanes, rake entries, buckets); they are the only module
state.
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from .. import native
from . import limb
from .bn254 import FQ_MOD, FR_MOD
from .spec import FieldSpec

L = 16
# most FFT stages one launch of the stage kernel runs, and the stages a
# launch of poly.fft: its 2^s elements a thread stay in registers (four
# stages spilled at 255 registers); 3 is the fastest at the quotient's 2^19
# and 13% behind 2 at 2^17 (PERF.md)
MAX_STAGES = 3
LAUNCHES: collections.Counter = collections.Counter()
ELEMS: collections.Counter = collections.Counter()

FIELD_IDS = {FR_MOD: 0, FQ_MOD: 1}


def use_kernels(t: torch.Tensor) -> bool:
    """True exactly for CUDA tensors."""
    return t.is_cuda


def field_id(spec: FieldSpec) -> int:
    try:
        return FIELD_IDS[spec.modulus]
    except KeyError:
        raise ValueError(f"no CUDA kernels for field {spec.name}") from None


def const256(limbs16) -> ctypes.Array:
    """16 x 16-bit limbs -> a host array of 8 x 32-bit limbs for a kernel."""
    vals = [int(limbs16[2 * i]) | (int(limbs16[2 * i + 1]) << 16)
            for i in range(8)]
    return (ctypes.c_uint32 * 8)(*vals)


def launch(lib: str, fn: str, name: str, spec: FieldSpec, ins, n_out: int,
           extra=()):
    """Launch ``fn`` of ``csrc/<lib>.cu`` elementwise over broadcast inputs.

    ``ins``: (16, *batch) int32 CUDA tensors.  Outputs are allocated here;
    the C entry point takes (field, ins..., outs..., extra..., n, stream).
    """
    dev = ins[0].device
    for x in ins:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{name}: all operands must be on {dev}, "
                             f"got {x.device}")
        if x.dtype != torch.int32 or x.dim() < 1 or x.shape[0] != L:
            raise ValueError(f"{name}: expected (16, ...) int32 planes, got "
                             f"{tuple(x.shape)} {x.dtype}")
    bshape = tuple(torch.broadcast_shapes(*(x.shape[1:] for x in ins)))
    n = math.prod(bshape)
    flats = [x.expand((L,) + bshape).contiguous().view(L, n) for x in ins]
    outs = [torch.empty((L, n), dtype=torch.int32, device=dev)
            for _ in range(n_out)]
    if n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        f = getattr(native.library(lib), fn)
        rc = f(field_id(spec), *[t.data_ptr() for t in flats + outs], *extra,
               n, stream)
        native.check(rc, fn)
        LAUNCHES[name] += 1
        ELEMS[name] += n
    return [o.view((L,) + bshape) for o in outs]


def _on_cpu(*arrs) -> bool:
    return not any(use_kernels(a) for a in arrs)


def mont_mul(a, b, spec: FieldSpec):
    """Montgomery product a*b*R^-1, canonical (limb.mont_mul)."""
    if _on_cpu(a, b):
        return limb.mont_mul(a, b, spec)
    return launch("field_ops", "fk_mont_mul", "mont_mul", spec, (a, b), 1)[0]


def add_mod(a, b, spec: FieldSpec):
    if _on_cpu(a, b):
        return limb.add_mod(a, b, spec)
    return launch("field_ops", "fk_add_mod", "add_mod", spec, (a, b), 1)[0]


def sub_mod(a, b, spec: FieldSpec):
    if _on_cpu(a, b):
        return limb.sub_mod(a, b, spec)
    return launch("field_ops", "fk_sub_mod", "sub_mod", spec, (a, b), 1)[0]


def mul_add(a, b, c, spec: FieldSpec):
    """Fused a*b + c, one launch (limb.mul_add)."""
    if _on_cpu(a, b, c):
        return limb.mul_add(a, b, c, spec)
    return launch("field_ops", "fk_mul_add", "mul_add", spec, (a, b, c), 1)[0]


def exp_words(exp_bits):
    """LSB-first exponent bits -> (8 host words of e, LSB first, its bit
    length); raises past 256 bits."""
    bits = [int(b) & 1 for b in np.asarray(exp_bits).reshape(-1)]
    nbits = max((i + 1 for i, b in enumerate(bits) if b), default=0)
    if nbits > 32 * 8:
        raise ValueError(f"mont_pow: a {nbits}-bit exponent; at most 256")
    words = [0] * 8
    for i in range(nbits):
        words[i // 32] |= bits[i] << (i % 32)
    return (ctypes.c_uint32 * 8)(*words), nbits


def mont_pow(a, exp_bits, spec: FieldSpec):
    """a^e in Montgomery form, e given as LSB-first bits (host constants):
    the whole square-and-multiply ladder of ``limb.mont_pow_plain`` in one
    launch of ``fk_mont_pow``; bit-identical to it on any 16-bit limbs."""
    if _on_cpu(a):
        return limb.mont_pow_plain(a, exp_bits, spec)
    words, nbits = exp_words(exp_bits)
    return launch("field_ops", "fk_mont_pow", "mont_pow", spec, (a,), 1,
                  (words, nbits))[0]


def butterfly(top, bot, tw, spec: FieldSpec):
    """Fused FFT butterfly (top + tw*bot, top - tw*bot), one launch of the
    FFT stage kernel with one stage."""
    if _on_cpu(top, bot, tw):
        return limb.butterfly(top, bot, tw, spec)
    return tuple(launch("field_ops", "fk_butterfly", "butterfly", spec,
                        (top, bot, tw), 2))


def fft_stages_plain(A, roots, t: int, s: int, spec: FieldSpec):
    """Plain version of ``fft_stages``: s successive Stockham stages, each a
    ``limb.butterfly`` of the stage's halves and twiddles and the
    concatenation of its outputs."""
    n = A.shape[1]
    for u in range(t, t + s):
        Lt, r_next = 1 << u, n >> (u + 1)
        A3 = A.reshape(L, 2 * r_next, Lt)
        tw = roots[:, :: n // (2 * Lt)][:, None, :Lt]
        plus, minus = limb.butterfly(A3[:, :r_next], A3[:, r_next:], tw, spec)
        A = torch.cat([plus, minus], dim=2).reshape(L, n)
    return A


def fft_stages(A, roots, t: int, s: int, spec: FieldSpec):
    """Stages t .. t + s - 1 (1 <= s <= MAX_STAGES) of the radix-2 Stockham
    FFT of size n = A.shape[1], in one launch: ``A`` (16, n) holds stage
    t's rows of 2^t columns, ``roots`` the (16, >= n / 2) table of w_n^k.
    Returns stage t + s.  Counted under ``butterfly``: the port of the TPU's
    per-stage butterfly."""
    n = A.shape[1]
    if not 1 <= s <= MAX_STAGES or n < 1 << (t + s):
        raise ValueError(f"fft_stages: stages {t}..{t + s - 1} of size {n}")
    if _on_cpu(A, roots):
        return fft_stages_plain(A, roots, t, s, spec)
    dev = A.device
    for x in (A, roots):
        if x.device != dev or x.dtype != torch.int32 or x.dim() != 2 \
                or x.shape[0] != L:
            raise ValueError("fft_stages: expected (16, n) int32 planes on "
                             f"{dev}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    if roots.shape[1] < n // 2:
        raise ValueError(f"fft_stages: {roots.shape[1]} roots for size {n}")
    A, roots = A.contiguous(), roots.contiguous()
    out = torch.empty_like(A)
    rc = native.library("field_ops").fk_fft_stages(
        field_id(spec), A.data_ptr(), out.data_ptr(), roots.data_ptr(),
        roots.shape[1], n, 1 << t, s,
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "fk_fft_stages")
    LAUNCHES["butterfly"] += 1
    ELEMS["butterfly"] += s * n // 2
    return out
