#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``aztec_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line and fails loudly; any mismatch or exception
exits non-zero):

1. the card's name and power limit, and the build of the CUDA kernels
   (``aztec_tpu_torch/csrc``, one nvcc per source, all at once);
2. every kernel (K1 field ops, K2 group formulas, K3 and K5 rakes, K4
   bucket phase, the microbenchmarks' ``mb_vpu`` and ``mb_dissect``)
   against its plain PyTorch version on the same inputs at its path's
   shapes, bit-exact; K1 also on unreduced operands (uniform 16-bit limbs,
   not field elements).  Each path kernel's device time
   (``tools.timing.device_ms``: 20 calls captured in a CUDA graph, its
   replays between CUDA events, no host time inside), its ``call_ms``
   (CUDA events around wrapper calls, the host's launch cost included) and
   its plain version's time.  The two K2 kernels redesigned for the card
   (``add_unsafe``, ``proj_add_complete``) also bit for bit on edge lanes
   (infinities, P = Q, P = -Q, coordinates 0, 1, p - 1) for Fr and Fq at
   widths 1 to 24,576, timed at the proof's four widths, and every K2
   kernel's registers, spill bytes and SASS instructions a point printed
   (a redesigned kernel that spills fails the run);

then the paths, each with the launch counts cleared just before it and
read just after:

3. an MSM of 2^20 points of the committed dev-SRS table through the
   chunked pipeline against the golden (sum k_i tau^i) * G computed on
   the host;
4. the main path: the 2^17-gate Standard-PLONK chain circuit of
   tools/cross_verify_big.py, proved on the card; its 8 verification-key
   commitments must equal artifacts/cross_verify_2pow17_ref_output.log
   (printed by barretenberg's verifier), the proof must verify with the
   port's verifier and a tampered copy must fail;
5. warm proofs of that circuit with the port's MSM paths (ragged tail
   mixed-added into the buckets, a barrier's MSMs batched) and the
   reference's (tail padded to a chunk, one MSM at a time), same bytes
   (timing only: its launches are not counted);
6. the MSM engine at full width: phase 3's MSM through
   ``msm(..., MSMConfig(c=16, block=64, bucket_block=64, glv=True))`` (the
   packed branch: K3 and K4 once a round) and through the staged rounds,
   both equal to the golden;
7. a 2^11-point MSM at the reference's small tier (the engine's unpacked
   branch: K5 once a round) against the golden;
8. the 2^20-point dev SRS from ``fixed_base_mul`` (K2 ``proj_dbl``)
   against the committed table, bit for bit;
9. the chain circuit at 2^20 gates, whose SRS of 2^20 + 1 points comes
   from ``fixed_base_mul``: proved, verified, a tamper rejected;
10. the microbenchmarks (``aztec_tpu_torch.tools``) as a user runs them,
    at widths that fill the card: every ``vpu_microbench`` kind at rows 4
    and 16 over 8192 tiles' worth of columns, with its element-ops per
    second beside the programming guide's rate, and every
    ``kernel_dissect`` body over 2^22 elements, on device time, each timed
    launch's output held against its plain version;
11. the redesign ranking (each kernel's device ms in the profiled warm
    2^17 proof less the bound of the elements it ran over), a JSON line
    with every kernel's launches summed over the paths, times and bound,
    then the card's name and power limit, then the result line.

Exits 2 without a result when CUDA is missing or the package is not beside
this script.

``python3 chip_smoke.py --k2`` runs phase 2's K1-K3 checks and the K2
phase alone, then the profiled warm 2^17 proof and the ranking.  Copied beside an older checkout's package, it measures
that commit's kernels with the same script, on the same card.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_LOG = os.path.join(ROOT, "artifacts", "cross_verify_2pow17_ref_output.log")
SEED = 20261016

# 32-bit integer multiply-add results per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, table of arithmetic
# instruction throughput): half the fp32 FMA rate.  32-bit adds run at the
# same rate on a separate pipe.  The card's rate is this times its SM count
# and its highest SM clock, read at run time (``timing.peak_per_s``).
INT32_PER_CLOCK_PER_SM = 64
PLANE_BYTES = 16 * 4          # one (16,) int32 limb column per element
# CIOS on 8 x 32-bit limbs: 8 rounds of 16 full 32x32->64 products (two
# multiply-add results each: low and high word) and one low product
MUL_OPS = 8 * (16 * 2 + 1)
ADD_OPS = 16                  # 8-limb add (or sub) + 8-limb correction

KERNELS = {
    # name: (source in csrc/, TPU kernel replaced, input planes, output
    #        planes, (Montgomery products, field adds/subs) per element)
    "mont_mul": ("field_ops.cu", "aztec_tpu/ff/pallas_field.py:326", 2, 1,
                 (1, 0)),
    "add_mod": ("field_ops.cu", "aztec_tpu/ff/pallas_field.py:349", 2, 1,
                (0, 1)),
    "sub_mod": ("field_ops.cu", "aztec_tpu/ff/pallas_field.py:354", 2, 1,
                (0, 1)),
    # the twiddle operand broadcasts: its bytes are counted apart
    "butterfly": ("field_ops.cu", "aztec_tpu/ff/pallas_field.py:385", 2, 2,
                  (1, 2)),
    "mixed_add_unsafe": ("group_ops.cu", "aztec_tpu/curves/group_pallas.py:42",
                         5, 3, (11, 14)),
    "add_unsafe": ("group_ops.cu", "aztec_tpu/curves/group_pallas.py:71", 6, 3,
                   (16, 13)),
    # 12 products: the two by 3b are 9t = 8t + t, four adds each
    "proj_add_complete": ("group_ops.cu",
                          "aztec_tpu/curves/group_pallas.py:108", 6, 3,
                          (12, 19 + 2 * 4)),
    "proj_dbl_n": ("group_ops.cu", "aztec_tpu/curves/group_pallas.py:137", 3, 3,
                   (9, 9)),
    "jacobian_to_proj": ("group_ops.cu", "aztec_tpu/curves/group_pallas.py:186",
                         3, 3, (3, 0)),
    "proj_to_jacobian": ("group_ops.cu", "aztec_tpu/curves/group_pallas.py:196",
                         3, 3, (3, 0)),
    # per entry: a 4-byte digit and a packed point in, 3 planes out
    "rake_scan_packed": ("rake.cu", "aztec_tpu/msm/rake_pallas.py:138", 0, 0,
                         (11, 14)),
    # per entry: a 4-byte digit and an affine point in, 3 planes out
    "rake_scan": ("rake.cu", "aztec_tpu/msm/rake_pallas.py:48", 0, 0,
                  (11, 14)),
    # operation totals depend on the lane split: counted in check_new_kernels
    "bucket_phase": ("bucket.cu", "aztec_tpu/msm/bucket_pallas.py:64", 3, 0,
                     (0, 0)),
    "proj_dbl": ("group_ops.cu", "aztec_tpu/curves/group_pallas.py:160", 3, 3,
                 (9, 9)),
    "mul_add": ("field_ops.cu", "aztec_tpu/ff/pallas_field.py:369", 3, 1,
                (1, 1)),
    # the microbenchmarks: their tools compute their bounds
    **{f"vpu_{kind}": ("microbench.cu", "tools/vpu_microbench.py:28", 0, 0,
                       (0, 0))
       for kind in ("add_u32", "mul_u32", "shift_u32", "and_u32", "mulmask",
                    "mul_f32")},
    **{f"dissect_{body}": ("microbench.cu", f"tools/kernel_dissect.py:{line}",
                           2, 1, (0, 0))
       for body, line in (("products", 60), ("comba_full", 78),
                          ("canon4", 70), ("mont_full", 66))},
}
MICROBENCH = [k for k in KERNELS if k.startswith(("vpu_", "dissect_"))]
# mul_add has no caller in either package: its entry counts only its check
NO_PATH = ("mul_add",)
# The microbenchmarks' check sizes are the TPU tools' own (64 tiles of
# columns; 512 x 128 elements) plus a ragged width; their timing sizes fill
# the card.
VPU_NBLOCKS, VPU_TIMED_NBLOCKS = 64, 8192
DISSECT_NF, DISSECT_TIMED_ELEMS = 512, 1 << 22
RAGGED = 1000
# The kernels' CUDA function names, as torch.profiler reports them, for the
# redesign ranking (proj_dbl runs proj_dbl_n_kernel with one step)
SYMBOLS = {"mont_mul_kernel": "mont_mul", "add_mod_kernel": "add_mod",
           "sub_mod_kernel": "sub_mod", "butterfly_kernel": "butterfly",
           "mul_add_kernel": "mul_add", "mixed_add_kernel": "mixed_add_unsafe",
           "add_unsafe_kernel": "add_unsafe",
           "proj_add_kernel": "proj_add_complete",
           "proj_dbl_n_kernel": "proj_dbl_n", "j2c_kernel": "jacobian_to_proj",
           "c2j_kernel": "proj_to_jacobian",
           "rake_packed_kernel": "rake_scan_packed", "rake_kernel": "rake_scan",
           "bucket_lanes_kernel": "bucket_phase",
           "bucket_combine_kernel": "bucket_phase"}

# The widths the 2^17 proof launches the two redesigned K2 kernels
# (add_unsafe, proj_add_complete) at: the widest barrier (24 rows x 2^16:
# the tails and the fold), the composed bucket phase of one MSM and of the
# three-MSM barrier (8 GLV rows x 1024 lanes each), and the Horner fold
# (one lane per MSM)
K2_WIDTHS = (24 << 16, 8192, 24576, 3)
# the edge lanes' widths: a partial last block at every block size
K2_EDGE_WIDTHS = (1, 3, 33, 8192 + 5, 24576)
# Montgomery products a thread of each redesigned kernel computes (proj_add
# computes 3b by two more where its NINE template argument is 0)
K2_PRODUCTS = {"add_unsafe_kernel": 16, "proj_add_kernel": 12}

# The main path's widest work-queue barrier: the three wire (or the three
# quotient) commitments of the 2^17 proof run as one batch of MSMs over one
# 2^17-point chunk, at the card's geometry (c = 16, GLV, K = 64).
PROOF_BATCH = 3
WINDOW = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a, b) -> int:
    import torch

    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def bound_ms(name: str, elems: int, rate: float, steps: int = 1,
             extra_bytes: int = 0, nbytes: int | None = None,
             products: tuple | None = None):
    """Least milliseconds for the work: each input read once and each output
    written once at the memory rate, or the multiply-adds (or, where more,
    the adds) at the integer rate, whichever is longer.  ``products``
    (Montgomery products, field adds) gives the totals where they are not
    a per-element count times ``steps * elems``."""
    from aztec_tpu_torch.tools import timing

    _, _, ins, outs, (muls, adds) = KERNELS[name]
    if nbytes is None:
        nbytes = (ins + outs) * PLANE_BYTES * elems
    if products is None:
        products = (muls * steps * elems, adds * steps * elems)
    ops = max(products[0] * MUL_OPS, products[1] * ADD_OPS)
    return timing.bound(nbytes + extra_bytes, ops / rate * 1e3)


def record(results: dict, rate: float, name, kern, plain, elems, steps=1,
           extra_bytes=0, nbytes=None, products=None, iters=5):
    """Time kern() on the device (``timing.device_ms``) and between CUDA
    events around ``iters`` wrapper calls (``call_ms``), and plain() (one
    run after a warm-up), on the same inputs; require equal outputs, and
    keep the numbers of the kernels line."""
    from aztec_tpu_torch.tools import timing

    call_ms, out_k = timing.call_ms(kern, iters)
    ms = timing.device_ms(kern)
    plain_ms, out_p = timing.call_ms(plain, 1)
    err = max_abs_err(out_k, out_p)
    bnd, by = bound_ms(name, elems, rate, steps, extra_bytes, nbytes, products)
    results[name] = {"max_abs_err": err, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                     "elems": elems}
    log(f"kernel {name}: {elems} elems max_abs_err={err} ms={ms:.4f} "
        f"call_ms={call_ms:.4f} plain_ms={plain_ms:.2f} bound_ms={bnd:.4f} "
        f"({by})")
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain version")


def random_field(gen, shape, device, zero_lanes: bool = False):
    """Canonical random field planes (top limb below 0x3064 < p >> 240),
    with the first lanes set to 0, 1 and a large value near p."""
    import torch

    x = torch.randint(0, 1 << 16, (16,) + shape, generator=gen,
                      dtype=torch.int32, device=device)
    x[15] = torch.randint(0, 0x3064, shape, generator=gen, dtype=torch.int32,
                          device=device)
    flat = x.reshape(16, -1)
    if flat.shape[1] >= 3:
        flat[:, 0] = 0
        flat[:, 1] = 0
        flat[0, 1] = 1
        flat[:, 2] = 0xFFFF
        flat[15, 2] = 0x3063
    if zero_lanes:
        flat[:, ::16] = 0
    return x


def unreduced_field(gen, shape, device):
    """Planes of uniform 16-bit limbs, most lanes >= p (not field elements),
    as the TPU microbenchmarks feed them; lane 0 is all 0xFFFF (U / R passes
    2^256 in a product with itself) and lane 1 is 1."""
    import torch

    x = torch.randint(0, 1 << 16, (16,) + shape, generator=gen,
                      dtype=torch.int32, device=device)
    flat = x.reshape(16, -1)
    flat[:, 0] = 0xFFFF
    if flat.shape[1] > 1:
        flat[:, 1] = 0
        flat[0, 1] = 1
    return x


def check_unreduced(gen, dev, n: int = 1 << 16) -> None:
    """K1 against its plain versions on unreduced operands, bit for bit:
    both reduce a + b and U / R mod 2^256 before one conditional
    subtraction of p, as the reference does.  The pairs (a, a) and (a, b)
    put lane 0 at U / R >= 2^256 and lane 1 at a + b = 2^256."""
    from aztec_tpu_torch.ff import FQ, FR, limb
    from aztec_tpu_torch.ff import field_kernels as fk

    for spec in (FR, FQ):
        a, b, c = (unreduced_field(gen, (n,), dev) for _ in range(3))
        tw = unreduced_field(gen, (1,), dev)
        for x, y in ((a, a), (a, b)):
            for name, args in (("mont_mul", (x, y)), ("add_mod", (x, y)),
                               ("sub_mod", (x, y)), ("mul_add", (x, y, c)),
                               ("butterfly", (x, y, tw))):
                err = max_abs_err(getattr(fk, name)(*args, spec),
                                  getattr(limb, name)(*args, spec))
                if err:
                    raise AssertionError(f"{name} ({spec.name}) differs from "
                                         "its plain version on unreduced "
                                         "operands")
    log(f"kernel K1 on unreduced operands (mont_mul, add_mod, sub_mod, "
        f"mul_add, butterfly; Fr and Fq; {n} lanes): max_abs_err=0")


def check_kernels(results: dict, rate: float) -> None:
    """Phase 2: each kernel of the 2^17 proof vs its plain version at
    main-path shapes."""
    import functools

    import torch

    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves import group_kernels as gk
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.ff import FQ, FR, limb
    from aztec_tpu_torch.ff import field_kernels as fk
    from aztec_tpu_torch.msm import rake

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b = BN254_G1.b
    record_ = functools.partial(record, results, rate)

    # K1 at the quotient's 4n = 2^19 width; the butterfly at one 4n stage
    n4 = 1 << 19
    for spec in (FR, FQ):
        a = random_field(gen, (n4,), dev)
        c = random_field(gen, (n4,), dev)
        sfx = "" if spec is FR else " (Fq)"
        for name, kern, plain in (
            ("mont_mul", fk.mont_mul, limb.mont_mul),
            ("add_mod", fk.add_mod, limb.add_mod),
            ("sub_mod", fk.sub_mod, limb.sub_mod),
        ):
            if spec is FR:
                record_(name, lambda: kern(a, c, spec), lambda: plain(a, c, spec),
                       n4)
            else:
                err = max_abs_err(kern(a, c, spec), plain(a, c, spec))
                log(f"kernel {name}{sfx}: {n4} elems max_abs_err={err}")
                if err:
                    raise AssertionError(f"{name}{sfx} differs")
    check_unreduced(gen, dev)
    # one Stockham stage at 4n: 2^18 butterflies, the twiddle a broadcast
    # (16, 1, Lt) operand (Lt = 2 here) read once
    Lt = 2
    top = random_field(gen, ((1 << 18) // Lt, Lt), dev)
    bot = random_field(gen, ((1 << 18) // Lt, Lt), dev)
    tw = random_field(gen, (Lt,), dev)[:, None, :]
    record_("butterfly", lambda: fk.butterfly(top, bot, tw, FR),
           lambda: limb.butterfly(top, bot, tw, FR), 1 << 18,
           extra_bytes=Lt * PLANE_BYTES)

    # K2 at the widths of the proof's widest barrier, infinity (Z = 0) on
    # every 16th lane
    def pts(w, zero=True):
        return tuple(random_field(gen, (w,), dev, zero_lanes=(zero and i == 2))
                     for i in range(3))

    rows = PROOF_BATCH * 128 // WINDOW      # batch x GLV rounds: 24
    wide = rows << WINDOW   # tails (bucket sums) and fold over rows x 2^c
    P, Q = pts(wide), pts(wide)
    record_("add_unsafe", lambda: gk.add_unsafe(P, Q, FQ),
           lambda: group.add_unsafe(P, Q, FQ), wide)
    record_("proj_add_complete", lambda: gk.proj_add_complete(P, Q, FQ, b),
           lambda: group.proj_add_complete(P, Q, FQ, b), wide)
    record_("jacobian_to_proj", lambda: gk.jacobian_to_proj(P, FQ),
           lambda: group.jacobian_to_proj(P, FQ), wide)
    del P, Q
    # Horner fold: one lane per MSM, 16 doublings a launch
    narrow = pts(PROOF_BATCH)
    record_("proj_dbl_n", lambda: gk.proj_dbl_n(narrow, FQ, b, WINDOW),
           lambda: group.proj_dbl_n(narrow, FQ, b, WINDOW), PROOF_BATCH,
           steps=WINDOW)
    record_("proj_to_jacobian", lambda: gk.proj_to_jacobian(narrow, FQ),
           lambda: group.proj_to_jacobian(narrow, FQ), PROOF_BATCH)
    # the quotient's ragged tail: one lane per (MSM, round)
    tail, tq = pts(rows), pts(rows)
    record_("mixed_add_unsafe",
           lambda: gk.mixed_add_unsafe(tail, tq[:2], FQ),
           lambda: group.mixed_add_unsafe(tail, tq[:2], FQ), rows)
    # the same formulas at 2^14 points with infinity lanes (bit-exactness)
    P, Q = pts(1 << 14), pts(1 << 14)
    for name, kern, plain in (
        ("mixed_add_unsafe", lambda: gk.mixed_add_unsafe(P, Q[:2], FQ),
         lambda: group.mixed_add_unsafe(P, Q[:2], FQ)),
        ("add_unsafe", lambda: gk.add_unsafe(P, Q, FQ),
         lambda: group.add_unsafe(P, Q, FQ)),
        ("proj_dbl_n", lambda: gk.proj_dbl_n(P, FQ, b, 3),
         lambda: group.proj_dbl_n(P, FQ, b, 3)),
        ("proj_to_jacobian", lambda: gk.proj_to_jacobian(P, FQ),
         lambda: group.proj_to_jacobian(P, FQ)),
    ):
        err = max_abs_err(kern(), plain())
        log(f"kernel {name}: {1 << 14} points with infinity lanes "
            f"max_abs_err={err}")
        if err:
            raise AssertionError(f"{name} differs at 2^14")

    # K3 at the widest barrier's chunk: 24 rows x 4096 lanes (2^18 GLV
    # entries / K), K = 64 steps
    K = 64
    B = rows * (2 << 17) // K
    dig = torch.randint(0, 4, (K, B), generator=gen, device=dev)
    dig = torch.sort(dig, dim=0).values      # runs, as in sorted lanes
    Xa, Ya = random_field(gen, (K * B,), dev), random_field(gen, (K * B,), dev)
    from aztec_tpu_torch.curves.group_ops import JacobianOps

    packed = JacobianOps(BN254_G1, dev).pack_affine((Xa, Ya))
    nbytes = K * B * (4 + PLANE_BYTES + 3 * PLANE_BYTES)
    record_("rake_scan_packed",
           lambda: rake.rake_scan_packed(dig, packed, B, K, FQ),
           lambda: rake.rake_scan_packed_plain(dig, packed, B, K, FQ),
           K * B, nbytes=nbytes, iters=3)


def check_new_kernels(results: dict, rate: float) -> None:
    """Phase 2, this slice's kernels (K4, K5, K2 proj_dbl, K1 mul_add) vs
    their plain versions at their paths' shapes."""
    import functools

    import torch

    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves import group_kernels as gk
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.ff import FQ, FR, limb
    from aztec_tpu_torch.ff import field_kernels as fk
    from aztec_tpu_torch.msm import bucket, rake

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    b = BN254_G1.b
    record_ = functools.partial(record, results, rate)

    def pts(w, zero=True):
        return tuple(random_field(gen, (w,), dev, zero_lanes=(zero and i == 2))
                     for i in range(3))

    # K4: one round of the 2^20 engine MSM (2^16 buckets, acc' = 2^16 acc +
    # W), every 16th bucket at infinity
    nb, steps = 1 << WINDOW, WINDOW
    bk, acc = pts(nb), pts(1, zero=False)
    lanes, groups = bucket.LANES, bucket.GROUPS
    k2 = nb // lanes
    adds = 3 * lanes + 4 * groups + 3          # complete adds of the combine
    dbls = (lanes // groups).bit_length() - 1 + k2.bit_length() - 1 + steps
    products = (nb * (3 + 2 * 14) + adds * 14 + dbls * 9,
                nb * 2 * 19 + adds * 19 + dbls * 9)
    plain_ops = bucket.PlainOps(FQ, b, dev)
    record_("bucket_phase",
            lambda: bucket.bucket_phase(bk, nb, FQ, b, acc, steps),
            lambda: bucket.bucket_phase_plain(plain_ops, bk, nb, acc, steps),
            nb, nbytes=(3 * nb + 6) * PLANE_BYTES, products=products)
    for n_b, a_, st in ((1024, None, 0), (2048, acc, 3)):
        small = pts(n_b)
        err = max_abs_err(bucket.bucket_phase(small, n_b, FQ, b, a_, st),
                          bucket.bucket_phase_plain(plain_ops, small, n_b, a_,
                                                    st))
        log(f"kernel bucket_phase: {n_b} buckets dbl_steps={st} "
            f"max_abs_err={err}")
        if err:
            raise AssertionError(f"bucket_phase differs at {n_b} buckets")

    # K5 at the 2^11-point tier (GLV, K = 32, so B = 128 lanes, digits of
    # c = 4), then at B = 1024, K = 64
    for B, K, top, timed_ in ((128, 32, 16, True), (1024, 64, 4, False)):
        sd = torch.sort(torch.randint(0, top, (B * K,), generator=gen,
                                      device=dev)).values
        X, Y = random_field(gen, (B * K,), dev), random_field(gen, (B * K,), dev)
        kern = functools.partial(rake.rake_scan, sd, (X, Y), B, K, FQ)
        plain = functools.partial(rake.rake_scan_plain, sd, (X, Y), B, K, FQ)
        if timed_:
            record_("rake_scan", kern, plain, B * K,
                    nbytes=B * K * (4 + 2 * PLANE_BYTES + 3 * PLANE_BYTES))
        else:
            err = max_abs_err(kern(), plain())
            log(f"kernel rake_scan: B={B} K={K} max_abs_err={err}")
            if err:
                raise AssertionError(f"rake_scan differs at B={B}, K={K}")

    # K2 proj_dbl at its path's width 1 (the fixed-base base point), then at
    # 2^14 points with infinity lanes
    one = pts(1, zero=False)
    record_("proj_dbl", lambda: gk.proj_dbl(one, FQ, b),
            lambda: group.proj_dbl(one, FQ, b), 1)
    wide = pts(1 << 14)
    err = max_abs_err(gk.proj_dbl(wide, FQ, b), group.proj_dbl(wide, FQ, b))
    log(f"kernel proj_dbl: {1 << 14} points with infinity lanes "
        f"max_abs_err={err}")
    if err:
        raise AssertionError("proj_dbl differs at 2^14")

    # K1 mul_add at the quotient's 4n width
    n4 = 1 << 19
    x, y, z = (random_field(gen, (n4,), dev) for _ in range(3))
    record_("mul_add", lambda: fk.mul_add(x, y, z, FR),
            lambda: limb.mul_add(x, y, z, FR), n4)


def edge_points(gen, w: int, spec, device):
    """Two batches (P, Q) of w points of canonical random coordinates whose
    lanes cycle through the edge cases of the two K2 adds: Z1 = 0, Z2 = 0,
    both, Q = P, Q = -P, P the identity (0 : 1 : 0), Q the identity, two
    lanes of coordinates drawn from {0, 1, p - 1}, and a random lane."""
    import numpy as np
    import torch

    from aztec_tpu_torch.ff import limb
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs

    P = [random_field(gen, (w,), device) for _ in range(3)]
    Q = [random_field(gen, (w,), device) for _ in range(3)]
    lane = torch.arange(w, device=device) % 10
    one = limb.one_mont(spec, (w,), device)
    zero = torch.zeros_like(one)
    special = torch.as_tensor(
        ints_to_limbs([0, 1, spec.modulus - 1]).astype(np.int32), device=device)

    def put(pt, k, vals):
        m = torch.isin(lane, torch.tensor(k, device=device))
        for c, v in zip(pt, vals):
            c[:, m] = v[:, m]

    put(P, [0, 2], [P[0], P[1], zero])
    put(Q, [1, 2], [Q[0], Q[1], zero])
    put(Q, [3], P)
    put(Q, [4], [P[0], limb.sub_mod(zero, P[1], spec), P[2]])
    put(P, [5], [zero, one, zero])
    put(Q, [6], [zero, one, zero])
    for pt in (P, Q):
        put(pt, [7, 8], [special[:, torch.randint(0, 3, (w,), generator=gen,
                                                  device=device)]
                         for _ in range(3)])
    return tuple(P), tuple(Q)


def check_k2_edges(device: str = "cuda") -> None:
    """The two redesigned K2 kernels against their plain versions, bit for
    bit, on the edge lanes of ``edge_points`` at every width of
    K2_EDGE_WIDTHS: BN254 G1 (b = 3: ``proj_add`` computes 9t by additions)
    over Fq and over Fr, and Grumpkin's b = -17 over Fr (the products by
    3b)."""
    import torch

    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves import group_kernels as gk
    from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
    from aztec_tpu_torch.ff import FQ, FR

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    for spec, b in ((FR, BN254_G1.b), (FQ, BN254_G1.b), (FR, GRUMPKIN_G1.b)):
        for w in K2_EDGE_WIDTHS:
            P, Q = edge_points(gen, w, spec, device)
            for name, kern, plain in (
                ("add_unsafe", gk.add_unsafe(P, Q, spec),
                 group.add_unsafe(P, Q, spec)),
                ("proj_add_complete", gk.proj_add_complete(P, Q, spec, b),
                 group.proj_add_complete(P, Q, spec, b)),
            ):
                if max_abs_err(kern, plain):
                    raise AssertionError(f"{name} ({spec.name}, b={b}) "
                                         "differs from its plain version on "
                                         f"the edge lanes at width {w}")
    log(f"kernel add_unsafe, proj_add_complete: edge lanes (Z1 = 0, Z2 = 0, "
        f"both, P = Q, P = -Q, identities, coordinates 0, 1, p - 1), Fr and "
        f"Fq, b = 3 and Grumpkin's, widths {list(K2_EDGE_WIDTHS)}: "
        "max_abs_err=0")


def k2_resources(strict: bool = True) -> dict:
    """Registers, spill bytes and SASS instructions a point of every K2
    kernel (``cuobjdump -res-usage`` and ``-sass`` of the group_ops build in
    use); for the two redesigned ones also the IMAD-class instructions a
    Montgomery product.  ``strict``: a redesigned kernel that spills
    raises.  Returns {(kernel, template args): numbers}."""
    from aztec_tpu_torch.tools import sass

    res, code = sass.resources("group_ops"), sass.kernels("group_ops")
    out = {}
    for key in sorted(code):
        r, k = res[key], code[key]
        imad = sum(v for op, v in k.hist.items() if op.startswith("IMAD"))
        row = {"regs": r["REG"], "spill_bytes": r["STACK"] + r["LOCAL"],
               "instructions": k.count, "loop": k.loop, "imad": imad}
        if key[0] in K2_PRODUCTS:
            products = K2_PRODUCTS[key[0]] + 2 * (
                key[0] == "proj_add_kernel" and key[1][-1:] != (1,))
            row["imad_per_product"] = imad / products
        out[key] = row
        log(f"k2 {key[0]}{list(key[1])}: regs={row['regs']} "
            f"spill_bytes={row['spill_bytes']} sass_per_point={k.count} "
            f"loop={k.loop} imad={imad}"
            + (f" imad_per_product={row['imad_per_product']:.1f}"
               if "imad_per_product" in row else "")
            + " " + " ".join(f"{op}={v}" for op, v in k.hist.most_common(6)))
        if strict and key[0] in K2_PRODUCTS and row["spill_bytes"]:
            raise AssertionError(f"{key[0]}{list(key[1])} spills "
                                 f"{row['spill_bytes']} bytes")
    return out


def time_k2() -> dict:
    """The two redesigned K2 kernels (Fq) at the proof's widths
    (K2_WIDTHS): device ms, call ms, ns a point; held against the plain
    version at the narrow widths.  Returns {name: {width: (ms, call_ms)}}."""
    import torch

    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves import group_kernels as gk
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.ff import FQ
    from aztec_tpu_torch.tools import timing

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    b = BN254_G1.b
    calls = {"add_unsafe": (gk.add_unsafe, group.add_unsafe, ()),
             "proj_add_complete": (gk.proj_add_complete,
                                   group.proj_add_complete, (b,))}
    out = {name: {} for name in calls}
    for w in K2_WIDTHS:
        P, Q = (tuple(random_field(gen, (w,), "cuda", zero_lanes=(i == 2))
                      for i in range(3)) for _ in range(2))
        for name, (kern, plain, extra) in calls.items():
            ms = timing.device_ms(lambda: kern(P, Q, FQ, *extra))
            cms, got = timing.call_ms(lambda: kern(P, Q, FQ, *extra))
            if w < 1 << 16 and max_abs_err(got, plain(P, Q, FQ, *extra)):
                raise AssertionError(f"{name} differs at width {w}")
            out[name][w] = (ms, cms)
            log(f"k2 time {name} width={w}: ms={ms:.5f} "
                f"call_ms={cms:.5f} ns_per_point={ms * 1e6 / w:.3f}")
    return out


def check_microbench(results: dict, device: str = "cuda") -> None:
    """Phase 2, the microbenchmarks' kernels (``mb_vpu``, ``mb_dissect``) vs
    their plain versions, bit for bit: every kind at rows 4 and 16 and every
    dissect body, at the TPU tools' sizes and at a ragged width.  (Phase 10
    checks them again at the widths it times.)"""
    import torch

    from aztec_tpu_torch.tools import kernel_dissect as kd
    from aztec_tpu_torch.tools import vpu_microbench as vm

    if MICROBENCH != ([f"vpu_{k}" for k in vm.KINDS]
                      + [f"dissect_{b}" for b in kd.BODIES]):
        raise AssertionError("KERNELS lists other microbenchmarks than "
                             "aztec_tpu_torch.tools")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)

    def check(name, out, want):
        err = max_abs_err(out, want)
        results[name] = {"max_abs_err": err}
        if err:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{tuple(out.shape)}")

    full = VPU_NBLOCKS * vm.TILE
    for rows in vm.ROWS_SET:
        for ncols in (full, RAGGED):
            a = torch.randint(0, 1 << 16, (rows, ncols), generator=gen,
                              dtype=torch.int32, device=dev)
            b = torch.randint(1, 1 << 16, (rows, ncols), generator=gen,
                              dtype=torch.int32, device=dev)
            for kind in vm.KINDS:
                check(f"vpu_{kind}", vm.vpu_chain(kind, rows, a, b),
                      vm.vpu_chain_plain(kind, rows, a, b))
    for n in (DISSECT_NF * 128, RAGGED):
        a, b = (torch.randint(0, 1 << 16, (16, n), generator=gen,
                              dtype=torch.int32, device=dev) for _ in range(2))
        for body in kd.BODIES:
            check(f"dissect_{body}", kd.dissect(body, a, b),
                  kd.dissect_plain(body, a, b))
    log(f"kernel mb_vpu: {len(vm.KINDS)} kinds x rows {vm.ROWS_SET} at "
        f"{full} and {RAGGED} columns, NOPS={vm.NOPS}: max_abs_err=0; "
        f"kernel mb_dissect: {len(kd.BODIES)} bodies at {DISSECT_NF * 128} "
        f"and {RAGGED} elements: max_abs_err=0")


def microbench_path(results: dict) -> None:
    """Phase 10: ``vpu_microbench`` and ``kernel_dissect`` as a user runs
    them, at widths that fill the card.  Each tool holds every timed
    launch's output against its plain version on the same inputs and
    returns its device, call and plain times and its bound (from the
    compiled kernel's SASS); they become the microbenchmarks' entries of
    the kernels line (rows 16 for the kinds)."""
    from aztec_tpu_torch.tools import kernel_dissect as kd
    from aztec_tpu_torch.tools import sass, timing
    from aztec_tpu_torch.tools import vpu_microbench as vm

    per_sm_clock = timing.peak_per_s(1)
    int_rate = INT32_PER_CLOCK_PER_SM * per_sm_clock
    issue = timing.ISSUE_PER_CLOCK_PER_SM * per_sm_clock
    log(f"microbench: guide int32 rate {int_rate:.4e} per s "
        f"({INT32_PER_CLOCK_PER_SM} per clock per SM), fp32 multiply "
        f"{vm.GUIDE['mul_f32'][0] * per_sm_clock:.4e} per s, issue "
        f"{issue:.4e} instructions per s")
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    for (rows, kind), r in vm.run(VPU_TIMED_NBLOCKS, log=log).items():
        log(f"microbench vpu_{kind} rows={rows}: measured "
            f"{r['ops_per_s']:.4e} element-ops/s against the guide's "
            f"{r['guide_per_s']:.4e} ({r['ops_per_s'] / r['guide_per_s']:.3f})"
            f"; {r['instrs_per_op']:.3f} instructions an op; ms={r['ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); "
            f"max_abs_err={r['max_abs_err']} at {r['element_ops'] // vm.NOPS}"
            " elements")
        entry = results[f"vpu_{kind}"]
        entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
        if rows == max(vm.ROWS_SET):
            entry.update({k: r[k] for k in keys},
                         elems=r["element_ops"] // vm.NOPS)
    n = DISSECT_TIMED_ELEMS
    for body, r in kd.run(n // 128, log=log).items():
        log(f"microbench dissect_{body}: ms={r['ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); "
            f"{r['instrs']} instructions an element; "
            f"max_abs_err={r['max_abs_err']} at {n} elements")
        entry = results[f"dissect_{body}"]
        entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
        entry.update({k: r[k] for k in keys}, elems=n)
    for (kernel, targs), k in sorted(sass.kernels("microbench").items()):
        log(f"sass {kernel}{list(targs)}: loop={k.loop} count={k.count} "
            + " ".join(f"{op}={v}" for op, v in k.hist.most_common(8)))


def redesign_ranking(results: dict, cost: dict) -> None:
    """What each kernel costs a warm 2^17 proof beyond its bound, largest
    first: its device time in the profiled proof, less the bound of the
    elements it ran over there (the recorded bound per element, at the
    recorded width).  The order in which the kernels' redesigns pay most."""
    rows = []
    for k, (launches, elems, prof_ms) in cost.items():
        if k not in results or not launches:
            continue
        r = results[k]
        bnd = elems * r["bound_ms"] / r["elems"]
        rows.append((prof_ms - bnd, k, launches, elems, prof_ms, bnd))
    rows.sort(reverse=True)
    log("redesign ranking, warm 2^17 proof (profiled device ms - bound ms "
        "over the elements launched): " + "; ".join(
            f"{k} {n} launches, {e} elements: {p:.3f} - {b:.3f} = "
            f"{score:.3f} ms" for score, k, n, e, p, b in rows))


def check_msm(log2n: int = 20, device: str = "cuda"):
    """Phase 3: 2^20-point MSM of the committed table vs the host golden.
    Returns the case, for the engine's phase: ((X, Y), scalars, golden
    affine point)."""
    import numpy as np
    import torch

    from aztec_tpu_torch.curves import golden
    from aztec_tpu_torch.curves.io import jacobian_to_host
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.msm.pippenger import msm
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs
    from aztec_tpu_torch.srs.reference_string import DEV_TAU, load_point_table

    n = 1 << log2n
    r = BN254_G1.order
    X, Y = load_point_table(n)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    X = torch.as_tensor(X.astype(np.int32), device=dev)
    Y = torch.as_tensor(Y.astype(np.int32), device=dev)
    rnd = random.Random(SEED)
    ks = [rnd.randrange(r) for _ in range(n)]
    S = torch.as_tensor(ints_to_limbs(ks).astype(np.int32), device=dev)
    t0 = time.perf_counter()
    P = msm((X, Y), S, BN254_G1)
    sync()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    P = msm((X, Y), S, BN254_G1)
    sync()
    warm = time.perf_counter() - t0
    kk, t = 0, 1
    for k in ks:
        kk = (kk + k * t) % r
        t = t * DEV_TAU % r
    expect = golden.GoldenCurve(BN254_G1).mul(kk, (BN254_G1.gen_x,
                                                   BN254_G1.gen_y))
    got = jacobian_to_host(P, BN254_G1)[0]
    if got != expect:
        raise AssertionError(f"2^{log2n} MSM differs from the host golden")
    log(f"msm 2^{log2n}: golden OK cold_s={cold:.3f} warm_s={warm:.3f} "
        f"points_per_s={n / warm:.0f}")
    return (X, Y), S, expect


def timed_msm(label: str, fn, n: int, device: str = "cuda"):
    """Run fn() cold and warm (host clock around a synchronised run); print
    seconds, points/s and the warm run's kernel launches.  Returns the
    warm result."""
    import torch

    from aztec_tpu_torch.ff import field_kernels as fk

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    fn()
    sync()
    cold = time.perf_counter() - t0
    before = dict(fk.LAUNCHES)
    t0 = time.perf_counter()
    P = fn()
    sync()
    warm = time.perf_counter() - t0
    per = {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()
           if v - before.get(k, 0)}
    log(f"{label}: cold_s={cold:.3f} warm_s={warm:.3f} "
        f"points_per_s={n / warm:.0f} launches per MSM "
        f"{json.dumps(per, sort_keys=True)}")
    return P, per


def check_engine(case, device: str = "cuda", c: int = 16, K: int = 64):
    """Phase 6: the jit MSM engine at full width: the 2^20 points of phase 3
    through msm(..., MSMConfig(c=16, block=64, bucket_block=64, glv=True))
    (the packed branch: B = 2^21 / 64 = 32768 lanes, 8 rounds, K3 and K4
    each once a round) and through the host-driven staged rounds; both
    equal the golden, which the chunked pipeline met in phase 3."""
    from aztec_tpu_torch.curves.io import jacobian_to_host
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.msm import bucket, staged
    from aztec_tpu_torch.msm.pippenger import MSMConfig, msm

    (X, Y), S, expect = case
    n = X.shape[1]
    cfg = MSMConfig(c=c, block=K, bucket_block=64, glv=True)
    want = {"rake_scan_packed": cfg.rounds()}
    if bucket.supported(1 << c):
        want["bucket_phase"] = cfg.rounds()
    for label, fn in (
        ("engine", lambda: msm((X, Y), S, BN254_G1, cfg)),
        ("staged", lambda: staged.msm_staged((X, Y), S, BN254_G1, n, c, K,
                                             True)),
    ):
        P, per = timed_msm(f"msm {label} 2^{n.bit_length() - 1}", fn, n,
                           device)
        if jacobian_to_host(P, BN254_G1)[0] != expect:
            raise AssertionError(f"{label} MSM differs from the golden and "
                                 "the chunked pipeline")
        if device == "cuda" and any(per.get(k) != v for k, v in want.items()):
            raise AssertionError(f"{label} MSM launches {per}, expected {want}")
    log(f"msm engine and staged 2^{n.bit_length() - 1}: golden OK, equal to "
        "the chunked pipeline in affine")


def check_small_tier(log2n: int = 11, device: str = "cuda") -> None:
    """Phase 7: the reference's small tier MSMConfig(c=4, block=32,
    bucket_block=4, glv=True) at 2^11 points: the engine's unpacked branch
    (B = 128 lanes, 32 rounds of K5, the composed bucket phase)."""
    import numpy as np
    import torch

    from aztec_tpu_torch.curves import golden
    from aztec_tpu_torch.curves.io import jacobian_to_host
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.msm.pippenger import MSMConfig, msm
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs
    from aztec_tpu_torch.srs.reference_string import DEV_TAU, load_point_table

    n = 1 << log2n
    r = BN254_G1.order
    X, Y = (torch.as_tensor(p.astype(np.int32), device=device)
            for p in load_point_table(n))
    rnd = random.Random(SEED + 2)
    ks = [rnd.randrange(r) for _ in range(n)]
    S = torch.as_tensor(ints_to_limbs(ks).astype(np.int32), device=device)
    cfg = MSMConfig(c=4, block=32, bucket_block=4, glv=True)
    P, per = timed_msm(f"msm engine small tier 2^{log2n}",
                       lambda: msm((X, Y), S, BN254_G1, cfg), n, device)
    kk = sum(k * pow(DEV_TAU, i, r) for i, k in enumerate(ks)) % r
    expect = golden.GoldenCurve(BN254_G1).mul(kk, (BN254_G1.gen_x,
                                                   BN254_G1.gen_y))
    if jacobian_to_host(P, BN254_G1)[0] != expect:
        raise AssertionError(f"2^{log2n} small-tier MSM differs from golden")
    if device == "cuda" and per.get("rake_scan") != 128 // 4:
        raise AssertionError(f"small tier: {per.get('rake_scan')} rake_scan "
                             "launches, expected 32")
    log(f"msm engine small tier 2^{log2n}: golden OK")


def check_fixed_base(log2n: int = 20, device: str = "cuda") -> None:
    """Phase 8: fixed_base_mul (w = 8) of tau^i, i < 2^20, through
    to_affine (the SRS factory's device path) equals the committed table
    bit for bit."""
    import numpy as np
    import torch

    from aztec_tpu_torch.srs.reference_string import (
        FakeReferenceStringFactory, load_point_table)

    n = 1 << log2n
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    srs = FakeReferenceStringFactory(device=device).device_prover_srs(n)
    sync()
    secs = time.perf_counter() - t0
    X, Y = load_point_table(n)
    for got, want in ((srs.X, X), (srs.Y, Y)):
        if not np.array_equal(got.cpu().numpy(), want.astype(np.int32)):
            raise AssertionError("fixed_base_mul differs from the point table")
    log(f"srs fixed_base 2^{log2n}: equal to the committed table bit for "
        f"bit; seconds={secs:.2f}")


def build_chain(log2n: int, device: str = "cuda"):
    """tools/cross_verify_big.py's chain circuit at 2^log2n gates."""
    from aztec_tpu_torch.ff.bn254 import FR_MOD
    from aztec_tpu_torch.plonk import AddTriple, MulTriple, StandardComposer

    c = StandardComposer(device=device)
    c.create_dummy_gates()
    c.add_public_variable(0xCAFEBABE)
    a = c.add_variable(3)
    b = c.add_variable(4)
    prod = c.add_variable(12)
    c.create_mul_gate(MulTriple(a, b, prod, 1, -1, 0))
    acc_val, acc = 12, prod
    for _ in range((1 << log2n) - 16):
        acc_val = (acc_val + 3) % FR_MOD
        nxt = c.add_variable(acc_val)
        c.create_add_gate(AddTriple(acc, a, nxt, 1, 1, -1, 0))
        acc = nxt
    if c.subgroup_size() != 1 << log2n:
        raise AssertionError(c.subgroup_size())
    return c


def profile_proof(c):
    """One more warm proof under torch.profiler: device time by kernel.
    Returns (the summed kernel milliseconds, {port kernel: device ms}),
    (0, {}) if the profiler saw none."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prover = c.create_prover()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prover.construct_proof()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernel-level events only: the torch ops that launched them carry
        # the same device time again
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        log("profile: the profiler saw no device time")
        return 0.0, {}
    log(f"profile (warm proof under torch.profiler): wall_ms={wall_ms:.1f} "
        f"kernel_device_ms={busy_ms:.1f} launches={sum(r[2] for r in rows)}")
    for dev_us, key, count in rows[:10]:
        log(f"profile   {dev_us / 1e3:9.2f} ms  x{count:<6d} {key[:70]}")
    by_name = {}
    for dev_us, key, _ in rows:
        m = re.search(r"::(\w+)<", key)
        name = SYMBOLS.get(m.group(1)) if m else None
        if name:
            by_name[name] = by_name.get(name, 0.0) + dev_us / 1e3
    return busy_ms, by_name


def main_path(log2n: int = 17, device: str = "cuda", profile: bool = True):
    """Phase 4 (and 9 at 2^20 gates): the chain proof; at 2^17 gates its VK
    against barretenberg's log.  Beyond 2^20 - 1 gates the SRS of 2^20 + 1
    points comes from the device fixed-base path, and its first 2^20
    points must equal the committed table.  Returns (composer, kernel
    launches of one warm proof, {kernel: (launches, elements, profiled
    device ms)} of a warm proof, empty unless profiled)."""
    import numpy as np
    import torch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    expect = {}
    with open(REF_LOG) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4 and parts[0] == "VK":
                expect[parts[1]] = (int(parts[2], 16), int(parts[3], 16))
    if len(expect) != 8:
        raise AssertionError(f"{REF_LOG}: expected 8 VK lines, got {len(expect)}")

    from aztec_tpu_torch.ff import field_kernels as fk

    t0 = time.perf_counter()
    c = build_chain(log2n, device)
    prover = c.create_prover()
    sync()
    t_key = time.perf_counter() - t0
    if log2n >= 20:
        from aztec_tpu_torch.srs.reference_string import (TABLE_MAX,
                                                          load_point_table)

        srs = c.compute_proving_key().srs
        X, Y = load_point_table(TABLE_MAX)
        if not (np.array_equal(srs.X[:, :TABLE_MAX].cpu().numpy(),
                               X.astype(np.int32))
                and np.array_equal(srs.Y[:, :TABLE_MAX].cpu().numpy(),
                                   Y.astype(np.int32))):
            raise AssertionError("the fixed-base SRS differs from the table")
        log(f"main path 2^{log2n}: SRS of {srs.size} points from "
            "fixed_base_mul; its first 2^20 equal the committed table")
    t0 = time.perf_counter()
    proof = prover.construct_proof()
    sync()
    cold = time.perf_counter() - t0
    prover = c.create_prover()
    before, elems_before = dict(fk.LAUNCHES), dict(fk.ELEMS)
    t0 = time.perf_counter()
    proof2 = prover.construct_proof()
    sync()
    warm = time.perf_counter() - t0
    per_proof = {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()}
    elems = {k: v - elems_before.get(k, 0) for k, v in fk.ELEMS.items()}
    log(f"launches per proof: {json.dumps(per_proof, sort_keys=True)}")
    cost = {}
    if device == "cuda" and profile:
        busy_ms, by_name = profile_proof(c)
        log(f"device idle share of the unprofiled warm proof: "
            f"{1 - busy_ms / (warm * 1e3):.3f}")
        cost = {k: (n, elems.get(k, 0), by_name.get(k, 0.0))
                for k, n in per_proof.items() if n}
    t0 = time.perf_counter()
    vk = c.compute_verification_key()
    t_vk = time.perf_counter() - t0
    for label, pt in expect.items():
        if log2n == 17 and vk.commitments.get(label) != pt:
            raise AssertionError(f"VK {label}: {vk.commitments.get(label)} != "
                                 f"{pt} (barretenberg)")
    verifier = c.create_verifier()
    if not (verifier.verify_proof(proof) and verifier.verify_proof(proof2)):
        raise AssertionError(f"the port's verifier rejects the 2^{log2n} proof")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    if verifier.verify_proof(bytes(bad)):
        raise AssertionError("a tampered proof verified")
    vk_note = "8 VK commitments equal barretenberg's, " if log2n == 17 else ""
    log(f"main path 2^{log2n}: {vk_note}proof verifies, tamper rejected; "
        f"key_s={t_key:.2f} prove_cold_s={cold:.2f} prove_warm_s={warm:.2f} "
        f"vk_s={t_vk:.2f}")
    return c, per_proof, cost


def counter_rng(seed: int):
    """Deterministic blinding, so that proofs can be compared byte for byte."""
    from aztec_tpu_torch.ff.bn254 import FR_MOD

    state = [seed]

    def rng():
        state[0] += 1
        return (state[0] * 0x9E3779B97F4A7C15F39CC0605CEDC835) % FR_MOD
    return rng


def compare_msm_paths(c, reps: int = 10, device: str = "cuda") -> None:
    """Phase 5: warm proofs with the port's MSM paths and the reference's.

    The port mixed-adds a ragged tail of a few points into the buckets
    (``chunked.tail_buckets``) and commits the MSMs of a work-queue barrier
    as one batch; the reference pads the tail to a whole chunk and commits
    one MSM at a time.  Each variant proves under one counter rng and must
    give the same bytes; prints each variant's seconds, interleaved."""
    import torch

    from aztec_tpu_torch.msm import chunked
    from aztec_tpu_torch.plonk import proving_key

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    batched, tail_max = proving_key.commit_many, chunked.TAIL_MAX

    def one_at_a_time(srs, monos):
        return [batched(srs, [m])[0] for m in monos]

    variants = {"tail_batched": (tail_max, batched),
                "padded_batched": (0, batched),
                "tail_one_at_a_time": (tail_max, one_at_a_time),
                "padded_one_at_a_time": (0, one_at_a_time)}
    secs = {k: [] for k in variants}
    proofs = set()
    try:
        for _ in range(reps):
            for name, (tmax, commit) in variants.items():
                chunked.TAIL_MAX, proving_key.commit_many = tmax, commit
                prover = c.create_prover()
                prover.rng = counter_rng(SEED)
                sync()
                t0 = time.perf_counter()
                proofs.add(prover.construct_proof())
                sync()
                secs[name].append(time.perf_counter() - t0)
    finally:
        chunked.TAIL_MAX, proving_key.commit_many = tail_max, batched
    if len(proofs) != 1:
        raise AssertionError("the MSM paths give different proofs")
    log("msm paths, warm proof seconds (one rng, same bytes): "
        + json.dumps(secs))


def run(argv=()) -> int:
    """The smoke; with ``--k2``, only phase 2's checks of K1-K3 and the K2
    phase (registers, spills, SASS, edge lanes, the proof's widths, and the
    design steps where the package builds them), then the profiled warm
    2^17 proof and its ranking: run beside another commit's package, it
    compares that commit's kernels on the same card."""
    k2_only = "--k2" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from aztec_tpu_torch import native
        from aztec_tpu_torch.ff import field_kernels as fk
    except ImportError as e:
        print(f"chip_smoke: the aztec_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aztec_tpu_torch.tools import timing

    card = timing.card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_build = native.build()
    log(f"build: {t_build:.1f}s for {', '.join(native.SOURCES)}")

    rate = timing.peak_per_s(INT32_PER_CLOCK_PER_SM)
    log(f"int32 multiply-add peak (programming guide): {rate:.4g} per s")
    results = {}
    check_kernels(results, rate)
    check_k2_edges()
    k2 = {"resources": {repr(k): v for k, v in
                        k2_resources(strict=not k2_only).items()},
          "times": time_k2()}
    if k2_only:
        _, per_proof, cost = main_path()
        redesign_ranking(results, cost)
        log(json.dumps({"k2": k2, "launches_per_2pow17_proof": per_proof,
                        "profiled_2pow17_ms": {k: v[2] for k, v in
                                               cost.items()}}))
        log(card)
        return 0
    check_new_kernels(results, rate)
    check_microbench(results)

    # each path runs with the counts set to 0 just before it and read just
    # after; the kernels line sums them
    pr1 = [k for k in KERNELS if k not in MICROBENCH
           and k not in ("rake_scan", "bucket_phase", "proj_dbl", "mul_add")]
    paths = {}

    def path(name, required, fn, *args):
        fk.LAUNCHES.clear()
        out = fn(*args)
        paths[name] = dict(fk.LAUNCHES)
        log(f"path {name} launches: {json.dumps(paths[name], sort_keys=True)}")
        missing = [k for k in required if not paths[name].get(k)]
        if missing:
            raise AssertionError(f"path {name} never launched {missing}")
        return out

    case = path("msm_chunked_2pow20", ["rake_scan_packed"], check_msm)
    c, per_proof, cost = path("proof_2pow17", pr1, main_path)
    compare_msm_paths(c)
    del c
    path("msm_engine_2pow20", ["rake_scan_packed", "bucket_phase"],
         check_engine, case)
    del case
    path("msm_engine_2pow11", ["rake_scan"], check_small_tier)
    path("srs_fixed_base_2pow20", ["proj_dbl", "proj_add_complete"],
         check_fixed_base)
    path("proof_2pow20", pr1 + ["proj_dbl"], main_path, 20, "cuda", False)
    path("microbench", MICROBENCH, microbench_path, results)
    redesign_ranking(results, cost)

    kernels = []
    for name, (src, replaces, *_rest) in KERNELS.items():
        r = results[name]
        on = [p for p, counts in paths.items() if counts.get(name)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aztec_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(counts.get(name, 0) for counts in paths.values()),
            "path": on or None, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "launches_per_2pow17_proof":
                per_proof.get(name, 0),
        })
        if name in k2["times"]:
            kernels[-1]["ms_at_widths"] = {w: t[0] for w, t in
                                           k2["times"][name].items()}
    missing = [k["name"] for k in kernels
               if k["launches"] == 0 and k["name"] not in NO_PATH]
    log(json.dumps({"kernels": kernels}))
    if missing:
        log(f"kernels never launched on any path: {missing}")
        return 1
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
