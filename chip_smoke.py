#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``aztec_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line and fails loudly; any mismatch or exception
exits non-zero):

1. the card's name and power limit, and the build of the CUDA kernels
   (``aztec_tpu_torch/csrc``, one nvcc per source, all at once);
2. every kernel (K1 field ops, K2 group formulas, K3 and K5 rakes, K4
   bucket phase) against its plain PyTorch version on the same inputs at
   its path's shapes, bit-exact on the limbs, with kernel and plain times;

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
10. a JSON line with every kernel's launches summed over the paths, times
    and bound, then the card's name and power limit, then the result
    line.

Exits 2 without a result when CUDA is missing or the package is not beside
this script.
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

# H100 SXM memory rate (NVIDIA data sheet): 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-add results per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, table of arithmetic
# instruction throughput): half the fp32 FMA rate.  32-bit adds run at the
# same rate on a separate pipe.  The card's rate is this times its SM count
# and its highest SM clock, read at run time (``int_ops_per_s``).
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
    "proj_add_complete": ("group_ops.cu",
                          "aztec_tpu/curves/group_pallas.py:108", 6, 3,
                          (14, 19)),
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
}
# mul_add has no caller in either package: its entry counts only its check
NO_PATH = ("mul_add",)

# The main path's widest work-queue barrier: the three wire (or the three
# quotient) commitments of the 2^17 proof run as one batch of MSMs over one
# 2^17-point chunk, at the card's geometry (c = 16, GLV, K = 64).
PROOF_BATCH = 3
WINDOW = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, iters: int = 5):
    """Mean device milliseconds of fn() over iters runs (CUDA events),
    after one warm-up run; returns (ms, last result)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


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


def int_ops_per_s() -> float:
    """The card's peak 32-bit integer multiply-add (or add) rate."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_PER_CLOCK_PER_SM * sms * mhz * 1e6


def bound_ms(name: str, elems: int, rate: float, steps: int = 1,
             extra_bytes: int = 0, nbytes: int | None = None,
             products: tuple | None = None):
    """Least milliseconds for the work: each input read once and each output
    written once at the memory rate, or the multiply-adds (or, where more,
    the adds) at the integer rate, whichever is longer.  ``products``
    (Montgomery products, field adds) gives the totals where they are not
    a per-element count times ``steps * elems``."""
    _, _, ins, outs, (muls, adds) = KERNELS[name]
    if nbytes is None:
        nbytes = (ins + outs) * PLANE_BYTES * elems
    if products is None:
        products = (muls * steps * elems, adds * steps * elems)
    t_bytes = (nbytes + extra_bytes) / HBM_BYTES_PER_S * 1e3
    ops = max(products[0] * MUL_OPS, products[1] * ADD_OPS)
    t_ops = ops / rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def record(results: dict, rate: float, name, kern, plain, elems, steps=1,
           extra_bytes=0, nbytes=None, products=None, iters=5):
    """Time kern() (mean of ``iters`` after a warm-up) and plain() (one run
    after a warm-up) on the same inputs, require equal outputs, and keep
    the numbers of the kernels line."""
    ms, out_k = timed(kern, iters)
    plain_ms, out_p = timed(plain, 1)
    err = max_abs_err(out_k, out_p)
    bnd, by = bound_ms(name, elems, rate, steps, extra_bytes, nbytes, products)
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by, "elems": elems}
    log(f"kernel {name}: {elems} elems max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.2f} bound_ms={bnd:.4f} ({by})")
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


def profile_proof(c) -> float:
    """One more warm proof under torch.profiler: device time by kernel.
    Returns the summed kernel milliseconds (0 if none were seen)."""
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
        return 0.0
    log(f"profile (warm proof under torch.profiler): wall_ms={wall_ms:.1f} "
        f"kernel_device_ms={busy_ms:.1f} launches={sum(r[2] for r in rows)}")
    for dev_us, key, count in rows[:10]:
        log(f"profile   {dev_us / 1e3:9.2f} ms  x{count:<6d} {key[:70]}")
    return busy_ms


def main_path(log2n: int = 17, device: str = "cuda", profile: bool = True):
    """Phase 4 (and 9 at 2^20 gates): the chain proof; at 2^17 gates its VK
    against barretenberg's log.  Beyond 2^20 - 1 gates the SRS of 2^20 + 1
    points comes from the device fixed-base path, and its first 2^20
    points must equal the committed table."""
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
    before = dict(fk.LAUNCHES)
    t0 = time.perf_counter()
    proof2 = prover.construct_proof()
    sync()
    warm = time.perf_counter() - t0
    per_proof = {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()}
    log(f"launches per proof: {json.dumps(per_proof, sort_keys=True)}")
    if device == "cuda" and profile:
        busy_ms = profile_proof(c)
        log(f"device idle share of the unprofiled warm proof: "
            f"{1 - busy_ms / (warm * 1e3):.3f}")
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
    return c


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


def run() -> int:
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

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_build = native.build()
    log(f"build: {t_build:.1f}s for {', '.join(native.SOURCES)}")

    rate = int_ops_per_s()
    log(f"int32 multiply-add peak: {rate:.4g} per s")
    results = {}
    check_kernels(results, rate)
    check_new_kernels(results, rate)

    # each path runs with the counts set to 0 just before it and read just
    # after; the kernels line sums them
    pr1 = [k for k in KERNELS
           if k not in ("rake_scan", "bucket_phase", "proj_dbl", "mul_add")]
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
    c = path("proof_2pow17", pr1, main_path)
    compare_msm_paths(c)
    del c
    path("msm_engine_2pow20", ["rake_scan_packed", "bucket_phase"],
         check_engine, case)
    del case
    path("msm_engine_2pow11", ["rake_scan"], check_small_tier)
    path("srs_fixed_base_2pow20", ["proj_dbl", "proj_add_complete"],
         check_fixed_base)
    path("proof_2pow20", pr1 + ["proj_dbl"], main_path, 20, "cuda", False)

    kernels = []
    for name, (src, replaces, *_rest) in KERNELS.items():
        r = results[name]
        on = [p for p, counts in paths.items() if counts.get(name)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aztec_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(counts.get(name, 0) for counts in paths.values()),
            "path": on or None, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
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
    sys.exit(run())
