"""K1: the elementwise field kernels, and the launch plumbing every kernel
wrapper of the port shares.

Port of aztec_tpu/ff/pallas_field.py.  The TPU package runs a field formula
over (16, 8, 128) tiles in one Pallas kernel (``_elementwise_call``); here
``csrc/field_ops.cu`` runs it with one CUDA thread per element, with the
limbs repacked to 8 x 32 bits in registers (``csrc/field.cuh``).

Dispatch: ``use_kernels(t)`` is true exactly for CUDA tensors.  A wrapper
computes with the plain PyTorch version (``ff/limb.py``) only because its
tensors lie on the CPU; for CUDA tensors it launches the kernel or raises.
Operands that broadcast (the FFT twiddles, 1/n, GLV's beta) are
materialised with ``expand(...).contiguous()`` before the launch, so every
kernel sees contiguous (16, N) planes.

``LAUNCHES`` counts kernel launches by name and ``ELEMS`` the elements
they ran over (lanes, rake entries, buckets); they are the only module
state.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from .. import native
from . import limb
from .bn254 import FQ_MOD, FR_MOD
from .spec import FieldSpec

L = 16
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


def butterfly(top, bot, tw, spec: FieldSpec):
    """Fused FFT butterfly (top + tw*bot, top - tw*bot), one launch."""
    if _on_cpu(top, bot, tw):
        return limb.butterfly(top, bot, tw, spec)
    return tuple(launch("field_ops", "fk_butterfly", "butterfly", spec,
                        (top, bot, tw), 2))
