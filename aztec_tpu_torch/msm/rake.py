"""K3 and K5: the rake scans of the MSM (``csrc/rake.cu``).

Port of aztec_tpu/msm/rake_pallas.py ``rake_scan_packed`` (K3, the chunked
pipeline's and the engine's packed branch) and ``rake_scan`` (K5, the
engine's unpacked branch).  B independent lanes walk K sorted entries each:
a lane mixed-adds the next point while the digit repeats and restarts from
the point (Z = 1) when it changes, and every running partial is emitted.
K3 reads limb-pair packed points K-major (column k * B + b); K5 reads 16-bit
planes in n-order (column b * K + k) and emits (16, B, K).

``rake_scan_packed_plain`` and ``rake_scan_plain`` are the plain versions
(the ports of aztec_tpu/curves/group_ops.py ``_rake_scan_packed_xla`` and of
the ``lax.scan`` composition of msm/pippenger.py ``_rake_segment_scan``):
the same steps as a loop of batched plain group formulas.  The wrappers use
them only for CPU tensors; for CUDA tensors they launch the kernels, which
keep each lane's accumulator in registers across its K steps.  Unlike the
TPU's ``rake_scan``, which refuses B that are not multiples of 1024, K5
takes any B.
"""

from __future__ import annotations

import torch

from .. import native
from ..curves import group
from ..ff import field_kernels as fk
from ..ff import limb
from ..ff.spec import FieldSpec

L = 16
SENTINEL = 0x1FFFF  # no digit equals it: a lane's first step restarts


def unpack(packed):
    """(16, ...) packed limb-pair rows -> affine (X, Y) 16-bit limb planes."""
    lo = packed & 0xFFFF
    hi = (packed >> 16) & 0xFFFF
    X = torch.stack([lo[i // 2] if i % 2 == 0 else hi[i // 2]
                     for i in range(L)])
    Y = torch.stack([lo[8 + i // 2] if i % 2 == 0 else hi[8 + i // 2]
                     for i in range(L)])
    return X, Y


def _scan(dk, X, Y, spec: FieldSpec):
    """The lanes' steps: dk (K, B) digits, X, Y (16, K, B) affine points ->
    running partials (X, Y, Z), each (16, K, B)."""
    K, B = dk.shape
    acc = group.infinity(spec, (B,), X.device)
    accd = torch.full((B,), SENTINEL, dtype=dk.dtype, device=dk.device)
    outs = ([], [], [])
    for k in range(K):
        pt = (X[:, k], Y[:, k])
        same = dk[k] == accd
        added = group.mixed_add_unsafe(acc, pt, spec)
        fresh = group.from_affine(pt, spec)
        acc = tuple(limb.select(same, a, f) for a, f in zip(added, fresh))
        accd = dk[k]
        for o, c in zip(outs, acc):
            o.append(c)
    return tuple(torch.stack(o, dim=1) for o in outs)


def rake_scan_packed_plain(dig_k, packed_k, B: int, K: int, spec: FieldSpec):
    """Plain version of K3: dig_k (K, B) digits, packed_k (16, K*B) K-major
    packed points -> running partials (X, Y, Z), each (16, K*B) K-major."""
    X, Y = unpack(packed_k.reshape(L, K, B))
    return tuple(o.reshape(L, K * B)
                 for o in _scan(dig_k.reshape(K, B), X, Y, spec))


def rake_scan_plain(sd, pts, B: int, K: int, spec: FieldSpec):
    """Plain version of K5: sd (n,) sorted digits, pts (X, Y) (16, n) in the
    same order, entry (b, k) at n-order column b * K + k -> running partials
    (X, Y, Z), each (16, B, K)."""
    def kmajor(p):
        return p.reshape(L, B, K).transpose(1, 2)

    X, Y = pts
    outs = _scan(sd.reshape(B, K).T, kmajor(X), kmajor(Y), spec)
    return tuple(o.transpose(1, 2) for o in outs)


def rake_scan(sd, pts, B: int, K: int, spec: FieldSpec):
    """K5 wrapper: plain version for CPU tensors, the kernel for CUDA."""
    X, Y = pts
    if not fk.use_kernels(X):
        return rake_scan_plain(sd, pts, B, K, spec)
    n = K * B
    if sd.numel() != n or any(tuple(p.shape) != (L, n) for p in pts):
        raise ValueError(f"rake_scan: expected {n} digits and (16, {n}) "
                         f"points, got {tuple(sd.shape)}, "
                         f"{[tuple(p.shape) for p in pts]}")
    if (X.dtype != torch.int32 or Y.dtype != torch.int32
            or not (sd.device == X.device == Y.device)):
        raise ValueError("rake_scan: expected int32 points and digits on one "
                         "device")
    dig = sd.reshape(n).to(torch.int32).contiguous()
    px, py = X.contiguous(), Y.contiguous()
    outs = [torch.empty((L, B, K), dtype=torch.int32, device=X.device)
            for _ in range(3)]
    if n:
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = native.library("rake").rk_rake(
            fk.field_id(spec), dig.data_ptr(), px.data_ptr(), py.data_ptr(),
            *[o.data_ptr() for o in outs], int(K), int(B), stream)
        native.check(rc, "rk_rake")
        fk.LAUNCHES["rake_scan"] += 1
        fk.ELEMS["rake_scan"] += n
    return tuple(outs)


def rake_scan_packed(dig_k, packed_k, B: int, K: int, spec: FieldSpec):
    """K3 wrapper: plain version for CPU tensors, the kernel for CUDA."""
    if not fk.use_kernels(packed_k):
        return rake_scan_packed_plain(dig_k, packed_k, B, K, spec)
    if dig_k.numel() != K * B or tuple(packed_k.shape) != (L, K * B):
        raise ValueError(f"rake: expected {K}x{B} digits and (16, {K * B}) "
                         f"points, got {tuple(dig_k.shape)}, "
                         f"{tuple(packed_k.shape)}")
    if packed_k.dtype != torch.int32 or dig_k.device != packed_k.device:
        raise ValueError("rake: expected int32 points and digits on one device")
    dig = dig_k.reshape(K * B).to(torch.int32).contiguous()
    pk = packed_k.contiguous()
    dev = pk.device
    outs = [torch.empty((L, K * B), dtype=torch.int32, device=dev)
            for _ in range(3)]
    if K * B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = native.library("rake").rk_rake_packed(
            fk.field_id(spec), dig.data_ptr(), pk.data_ptr(),
            *[o.data_ptr() for o in outs], int(K), int(B), stream)
        native.check(rc, "rk_rake_packed")
        fk.LAUNCHES["rake_scan_packed"] += 1
        fk.ELEMS["rake_scan_packed"] += K * B
    return tuple(outs)
