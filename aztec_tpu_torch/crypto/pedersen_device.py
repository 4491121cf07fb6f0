"""Batched Pedersen hashing on the device: many hashes a pass.

Port of aztec_tpu/crypto/pedersen_device.py.  The reference hashes Merkle
nodes one pair at a time (pedersen.cpp:274-299); here H independent hash
lanes walk the fixed-base ladder together: 127 steps, each a width-H
complete Jacobian addition (``curves.group.add_complete``, every field op
one K1 launch on the card), with the 2-bit WNAF digits recoded on the
device by a 127-step loop mirroring the host recoder
(ecc/groups/wnaf.hpp fixed_wnaf, ``pedersen.fixed_wnaf``).

Inputs and outputs are canonical (non-Montgomery) (16, H) int32 limb
planes over Grumpkin's base field (BN254 Fr).  A zero input hashes to
infinity, as ``pedersen.hash_single``.
"""

from __future__ import annotations

import functools

import torch

from ..curves import group
from ..ff import FR, limb
from ..ff import field_kernels as fk
from ..ff.bn254 import FR_MOD
from ..numeric.bigint import ints_to_limbs
from . import pedersen as pd

NUM_QUADS = pd.NUM_QUADS  # 127
U32 = 0xFFFFFFFF


def _mont_planes(vals, device) -> torch.Tensor:
    return torch.as_tensor(ints_to_limbs([v * FR.R % FR_MOD for v in vals])
                           .astype("int32"), device=device)


@functools.lru_cache(maxsize=None)
def _ladder_tables(hash_index: int, device: torch.device):
    """Montgomery planes of one hash generator pair's ladder on ``device``
    (the [1:] slice of 254-bit hashing): x, y and -y of the "one" and
    "three" points, (16, 127) each, and the origin and origin + skew
    generator as (16, 1) columns."""
    lad = pd._hash_ladder(hash_index)[pd.QUAD_LENGTH - NUM_QUADS - 1:]
    ones, threes = [e[0] for e in lad[1:]], [e[1] for e in lad[1:]]

    def planes(pts, coord, sign=1):
        return _mont_planes([sign * p[coord] % FR_MOD for p in pts], device)

    origin = lad[0][0]
    origin_skew = pd.g_add(origin, pd.get_generator(hash_index * 2 + 1))
    return {
        "one": (planes(ones, 0), planes(ones, 1), planes(ones, 1, -1)),
        "three": (planes(threes, 0), planes(threes, 1), planes(threes, 1, -1)),
        "origin": (_mont_planes([origin[0]], device),
                   _mont_planes([origin[1]], device)),
        "origin_skew": (_mont_planes([origin_skew[0]], device),
                        _mont_planes([origin_skew[1]], device)),
    }


def _wnaf_digits(base):
    """base: (16, H) canonical planes, odd (or made odd by the caller).

    Returns (digit3 (127, H) bool MSB-first, negate (127, H) bool, skew (H,)
    bool), mirroring fixed_wnaf(num_bits=255, wnaf_bits=2) lane-wise, in
    int64 with the host recoder's 32-bit wraparound."""
    b = base.to(torch.int64)
    # window j = (base >> 2j) & 3: a 2-bit window never straddles two limbs
    W = torch.stack([(b[(2 * j) // 16] >> ((2 * j) % 16)) & 3
                     for j in range(NUM_QUADS + 1)])            # (128, H)
    skew = (W[0] & 1) == 0
    prev = W[0] + skew.to(torch.int64)
    digits, negs = [], []
    for j in range(1, NUM_QUADS + 1):
        pred = (W[j] & 1) == 0
        v = (prev - (pred.to(torch.int64) << 2)) & U32
        v = torch.where(pred, ~v & U32, v)
        digits.append((v >> 1) & 0x7FFFFFFF)
        negs.append(pred)
        prev = W[j] + pred.to(torch.int64)
    # rounds j = 1..127 give the WNAF entries 127..1: flip to MSB-first
    digit3 = torch.stack(digits[::-1]) == 1
    negate = torch.stack(negs[::-1])
    return digit3, negate, skew


def hash_single_batch(values, hash_index: int):
    """values: (16, H) canonical planes -> Jacobian hash points (Montgomery
    planes).  Lane-wise ``pedersen.hash_single``; a zero value maps to
    infinity (Z = 0)."""
    dev = values.device
    H = values.shape[1]
    t = _ladder_tables(hash_index, dev)

    two = torch.zeros_like(values)
    two[0] = 2
    is_odd = (values[0] & 1) == 1
    base = torch.where(is_odd[None], values, fk.sub_mod(values, two, FR))
    digit3, negate, skew = _wnaf_digits(base)

    acc = tuple(torch.where(skew[None], s, o)
                for o, s in zip(t["origin"], t["origin_skew"]))
    acc = (*acc, limb.one_mont(FR, (H,), dev))
    (ox, oy, ony), (tx, ty, tny) = t["one"], t["three"]
    for i in range(NUM_QUADS):
        d3 = digit3[i][None]
        px = torch.where(d3, tx[:, i:i + 1], ox[:, i:i + 1])
        py = torch.where(negate[i][None],
                         torch.where(d3, tny[:, i:i + 1], ony[:, i:i + 1]),
                         torch.where(d3, ty[:, i:i + 1], oy[:, i:i + 1]))
        acc = group.add_complete(acc, group.from_affine((px, py), FR), FR)
    X, Y, Z = acc
    return X, Y, torch.where(limb.is_zero(values)[None], 0, Z)


def compress_batch(left, right, hash_index: int = 0):
    """Batched compress: x(hash(l, i) + hash(r, i + 1)) as canonical
    (16, H) planes; an infinite sum gives 0."""
    h1 = hash_single_batch(left, hash_index)
    h2 = hash_single_batch(right, hash_index + 1)
    x, _, inf = group.to_affine(group.add_complete(h1, h2, FR), FR)
    return torch.where(inf[None], 0, limb.from_mont(x, FR))
