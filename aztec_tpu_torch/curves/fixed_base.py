"""Batch fixed-base scalar multiplication: k_i * G for many k_i, one base.

Port of aztec_tpu/curves/fixed_base.py, which derives reference strings
(tau^i * G) on the device.  Windowed-table method: per w-bit window j, a
table T_j[d] = d * 2^(w j) * G built with a Hillis prefix scan over a
constant row, then each scalar gathers one entry per window and folds them
with complete adds.

All group math runs on the complete projective ops (RCB16): table entries
coincide (d*G against d*G) and entry 0 is the identity, so completeness is
required.  On the card the adds are K2 ``proj_add_complete`` and the base's
w doublings per window are K2 ``proj_dbl`` launches at width 1 (the
reference doubles one step at a time).
"""

from __future__ import annotations

import torch

from ..numeric.bigint import int_to_limbs
from . import group
from .group_ops import JacobianOps
from .spec import CurveSpec


def _prefix_scan_c(ops, V):
    """Inclusive prefix sums (complete adds) along the last axis."""
    n = V[0].shape[-1]
    steps = max((n - 1).bit_length(), 1)
    idx = torch.arange(n, device=V[0].device)
    for s in range(steps):
        d = 1 << s
        shifted = tuple(torch.roll(a, d, dims=-1) for a in V)
        V = ops.select(idx >= d, ops.c_add(shifted, V), V)
    return V


def _window_tables(GX, GY, curve: CurveSpec, w: int):
    """T[j][d] = d * 2^(w j) * G: projective planes, a tuple of
    (256/w, 16, 2^w)."""
    ops = JacobianOps(curve, GX.device)
    size = 1 << w
    keep = torch.arange(size, device=GX.device) != 0  # entry 0 = identity
    base = ops.j2c(group.from_affine((GX, GY), curve.field))
    tables = []
    for _ in range(256 // w):
        row = tuple(a.expand(a.shape[0], size) for a in base)
        tables.append(_prefix_scan_c(ops, ops.c_mask_to_infinity(keep, row)))
        for _ in range(w):
            base = ops.c_dbl(base)
    return tuple(torch.stack([t[i] for t in tables]) for i in range(3))


def _gather_and_sum(tables, scalars, curve: CurveSpec, w: int):
    """Fold one table entry per window into each scalar's sum; Jacobian."""
    ops = JacobianOps(curve, scalars.device)
    n = scalars.shape[1]
    mask = (1 << w) - 1
    acc = ops.c_infinity((n,))
    for j in range(256 // w):
        row = scalars[(w * j) // 16].to(torch.int64)
        digit = (row >> ((w * j) % 16)) & mask
        acc = ops.c_add(acc, tuple(t[j].index_select(1, digit)
                                   for t in tables))
    return ops.c2j(acc)


def fixed_base_mul(scalars, curve: CurveSpec, w: int = 8):
    """scalars: (16, n) canonical planes -> Jacobian batch k_i * G (w
    divides 16)."""
    f = curve.field
    dev = scalars.device

    def mont(v):
        return torch.as_tensor(int_to_limbs(f.to_mont_int(v)).astype("int32"),
                               device=dev)[:, None]

    tables = _window_tables(mont(curve.gen_x), mont(curve.gen_y), curve, w)
    return _gather_and_sum(tables, scalars, curve, w)
