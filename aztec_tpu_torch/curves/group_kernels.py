"""K2: whole group-formula kernels (``csrc/group_ops.cu``).

Port of aztec_tpu/curves/group_pallas.py.  Each wrapper computes with the
plain formula of ``group.py`` only for CPU tensors; for CUDA tensors it
launches the kernel (one thread per point, all intermediates in registers)
or raises.  Launches are counted in ``field_kernels.LAUNCHES`` under the
names below.
"""

from __future__ import annotations

import ctypes

from ..ff import field_kernels as fk
from ..ff.spec import FieldSpec
from . import group

NAMES = ("mixed_add_unsafe", "add_unsafe", "proj_add_complete", "proj_dbl",
         "proj_dbl_n", "jacobian_to_proj", "proj_to_jacobian")


def _b3(spec: FieldSpec, b_int: int):
    return fk.const256(group.b3_limbs(spec, b_int))


def mixed_add_unsafe(P, Qa, spec: FieldSpec):
    if not fk.use_kernels(P[0]):
        return group.mixed_add_unsafe(P, Qa, spec)
    return tuple(fk.launch("group_ops", "gk_mixed_add", "mixed_add_unsafe",
                           spec, (*P, *Qa), 3))


def add_unsafe(P, Q, spec: FieldSpec):
    """Jacobian + Jacobian.  Every coordinate must be canonical (below p):
    the kernel's lazy arithmetic takes its inputs as reduced, so on limbs
    at or above p it leaves the plain formula."""
    if not fk.use_kernels(P[0]):
        return group.add_unsafe(P, Q, spec)
    return tuple(fk.launch("group_ops", "gk_add_unsafe", "add_unsafe", spec,
                           (*P, *Q), 3))


def proj_add_complete(P, Q, spec: FieldSpec, b_int: int):
    """Complete projective add (RCB16 algorithm 7).  Every coordinate must
    be canonical (below p), as for ``add_unsafe``."""
    if not fk.use_kernels(P[0]):
        return group.proj_add_complete(P, Q, spec, b_int)
    b3 = _b3(spec, b_int)
    return tuple(fk.launch("group_ops", "gk_proj_add", "proj_add_complete",
                           spec, (*P, *Q), 3,
                           extra=(ctypes.cast(b3, ctypes.c_void_p),)))


def proj_dbl(P, spec: FieldSpec, b_int: int):
    """One complete doubling (RCB16 algorithm 9)."""
    if not fk.use_kernels(P[0]):
        return group.proj_dbl(P, spec, b_int)
    b3 = _b3(spec, b_int)
    return tuple(fk.launch("group_ops", "gk_proj_dbl", "proj_dbl", spec, P, 3,
                           extra=(ctypes.cast(b3, ctypes.c_void_p),)))


def proj_dbl_n(P, spec: FieldSpec, b_int: int, steps: int):
    """``steps`` successive complete doublings in one launch."""
    if not fk.use_kernels(P[0]):
        return group.proj_dbl_n(P, spec, b_int, steps)
    b3 = _b3(spec, b_int)
    return tuple(fk.launch("group_ops", "gk_proj_dbl_n", "proj_dbl_n", spec,
                           P, 3, extra=(ctypes.cast(b3, ctypes.c_void_p),
                                        int(steps))))


def jacobian_to_proj(P, spec: FieldSpec):
    if not fk.use_kernels(P[0]):
        return group.jacobian_to_proj(P, spec)
    return tuple(fk.launch("group_ops", "gk_j2c", "jacobian_to_proj", spec, P,
                           3))


def proj_to_jacobian(P, spec: FieldSpec):
    if not fk.use_kernels(P[0]):
        return group.proj_to_jacobian(P, spec)
    return tuple(fk.launch("group_ops", "gk_c2j", "proj_to_jacobian", spec, P,
                           3))
