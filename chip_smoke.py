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
   not field elements); K1 ``mont_pow`` (the whole ladder of a power in one
   launch) also on edge lanes (0, 1, p - 1, p, p + 1, 2p - 1, all 0xFFFF)
   at widths 1 to 2^16 with the exponents p - 2, 2^100, 0 and 1, K5
   on edge lanes with points at or above p, and the GLV table of an MSM
   chunk (``csrc/glv.cu``, one launch) on edge scalars (0, 1, r - 1, r,
   lambda, all 0xFFFF, Babai rounding edges) and edge points (0, p - 1,
   p, 2p - 1, all 0xFFFF) read as column slices, for BN254 G1 and
   Grumpkin, at widths 1 to 2^17 + 5.  Each path kernel's device time
   (``tools.timing.device_ms``: 20 calls captured in a CUDA graph, its
   replays between CUDA events, no host time inside), its ``call_ms``
   (CUDA events around wrapper calls, the host's launch cost included) and
   its plain version's time.  The kernels redesigned for the card (K2
   ``add_unsafe``, ``proj_add_complete`` and ``proj_dbl_n``, K3
   ``rake_scan_packed``) also bit for bit on edge lanes (infinities,
   P = Q, P = -Q, coordinates 0, 1, p - 1; for K3 also runs, restarts and
   alternating digits) for Fr and Fq, timed at the proof's widths (K4 at
   2^16 and 1,024 buckets, the FFT's stage kernel through ``poly.fft`` at
   2^17 and 2^19, 1 to 3 stages a launch), and every K1, K2, rake and K4
   kernel's registers, spill bytes and SASS instructions printed (a
   redesigned kernel or the GLV table that spills fails the run); every
   lazily reduced kernel (the K2 adds and doublings, ``jacobian_to_proj``,
   K3, K5, K4, the FFT's stage kernel) and the GLV table against its plain
   version on unreduced lanes
   (uniform 16-bit limbs, all 0xFFFF, p, p + 1, 2p - 1; in a rake also in
   the middle of runs);

then the paths, each with the launch counts cleared just before it and
read just after:

3. an MSM of 2^20 points of the committed dev-SRS table through the
   chunked pipeline against the golden (sum k_i tau^i) * G computed on
   the host;
4. the main path: the 2^17-gate Standard-PLONK chain circuit of
   tools/cross_verify_big.py, proved on the card; its 8 verification-key
   commitments must equal artifacts/cross_verify_2pow17_ref_output.log
   (printed by barretenberg's verifier), the proof must verify with the
   port's verifier and a tampered copy must fail; the sha256 of a proof
   under a fixed counter rng is printed, to compare commits' bytes;
5. warm proofs of that circuit with the port's MSM paths (ragged tail
   mixed-added into the buckets, a barrier's MSMs batched) and the
   reference's (tail padded to a chunk, one MSM at a time), same bytes,
   three interleaved rounds (timing only: its launches are not counted);
5b. the Turbo path: the committed small TurboPlonk vectors (the JAX
    package's proofs of tests/test_turbo.py's circuit, keccak and
    unrolled, and of a 2^10-gate circuit with an in-circuit Pedersen
    compression) proved on the card, byte for byte; K2 ``add_unsafe``,
    ``proj_add_complete`` and K3 against their plain versions at the
    Turbo barrier's widths (32 rows x 2^16, 32 x 4096 lanes); then, as a
    path, aztec_tpu_torch/tools/turbo_circuit.py's 2^17-gate circuit
    (every Turbo widget) checked by ``check_turbo``, keyed, and proved
    twice with the keccak prover and twice unrolled, each proof verified
    and a tamper rejected (set-up seconds, warm proof seconds, launches by
    kernel and the peak device memory of the key and its keccak proofs
    printed); last, in a process of its own
    (``--turbo-profile``), a warm Turbo proof under torch.profiler: kernel
    time, idle share, the largest kernels;
5c. the rollup's transaction proofs: the committed ``join_split_d3``
    vector (the unrolled proof of the depth-3 join-split of
    tests/test_join_split.py, 2^16 gates, 14 public inputs; written by the
    port on the card, its VK held on the CPU to the JAX package's circuit
    and its proof to the JAX package's verifier) proved again, byte for
    byte; then, as paths, the join-split at the production
    data-tree depth 32 (two real input notes in a ``WorldState`` sparse
    tree, 2^17 gates) built, its 14 public inputs held against the tx's
    native values, checked by ``check_turbo``, keyed and proved twice
    unrolled, each proof verified and a tamper rejected (set-up seconds by
    span, warm proof seconds, launches by kernel printed), then once under
    torch.profiler (kernel time, the device's idle share), and the account
    circuit with a depth-32 path, proved once and verified; last the proof
    worker as a subprocess (``python -u -m
    aztec_tpu_torch.serving.proof_worker``, its fixtures in a fresh
    temporary directory): the ready byte, demo proofs 0x101 and 0x100 at
    2^10 gates verified, 0x202 failed, the join-split and account VKs
    (0x200, 0x201) whose stored padding proofs verify, an id-0 frame that
    does not parse failed with the next request still served, an unknown
    id failed and the worker exiting 0, each request's seconds; its imports
    (``-X importtime``) hold neither JAX nor the JAX package; then the HTTP
    server over its own worker: GET /status and POST /create-proof;
5d. the rollup tower as an operator runs it: a user's deposit (100, fee
    10) built and proved on the card by the port's SDK
    (``CoreSdk(prover="circuit")``, data-tree depth 6, the unrolled Turbo
    join-split, 66,864 gates at 2^17), verified against the worker's
    join-split VK and a
    tamper rejected; the port's sequencer (``RollupPipeline``,
    ``WorldState(6, 16, 4)``, one tx a rollup) served by its HTTP handler
    admits it through ``/tx``, and its pipeline sends id 0 (the inner
    rollup, 8.4M gates at 2^24, unrolled Turbo, its in-circuit verifier
    over the SDK's proof), 0x202 (its VK, which the phase's adapter writes
    into the id-1 frame) and id 1 (the root rollup, 8.8M gates at 2^24,
    Turbo with the Keccak transcript) to the proof worker, a subprocess
    with a fresh fixture directory; the chain is the port's
    ``contracts.RollupProcessor``, into which the user first escrows the
    deposit, and whose verifier is the EVM bytecode that the port's
    ``generate_verifier`` emits for the root VK, run in the port's EVM, and
    the port's native Turbo verifier (which alone folds the recursion
    output into the pairing): both must accept; a failed request, a
    ``WithdrawError`` event, a disagreement of the two verifiers or a reset
    fails the phase at once; the processor's next id is 1, its roots are
    the root proof's and the world state's, the escrow is spent and the
    fees are 10 (the bytecode's length, gas and seconds printed); the user
    syncs the settled block from the processor: the SDK's data root equals
    the world state's and the root proof's, the balance is 90.  Then the inner proof verified
    against the VK 0x202 answered, the root proof verified here again, its
    recursive accumulator folded into the pairing, and a tamper rejected;
    /status and the /metrics seconds; the SDK proof's seconds and
    launches; each circuit's gates, subgroup, build, SRS, key, VK, witness
    and proof seconds, launches by kernel and the worker's peak device
    memory; the three proofs' sha256; the worker's imports hold neither JAX
    nor the JAX package; the worker's launches join the path counts;
5e. UltraPlonk, in a process of its own (``--ultra``): the committed small
    Ultra vectors (the JAX package's Keccak and unrolled proofs of
    make_vectors.py's ``ultra_drive``) proved byte for byte; then, as a
    path, aztec_tpu_torch/tools/ultra_circuit.py's 2^20-gate circuit
    (196,608 rows of a range, an XOR and an AND table; 2^15 64-bit range
    decompositions and 2^17 table reads by lookup; a mul chain) built,
    keyed, its VK computed, proved cold (Keccak) and, with fresh witness
    values, keyed and proved warm against the first VK, then profiled (the
    build, key, VK, round and proof seconds, ``after_eta``'s among them,
    the warm proof's launches, kernel time, idle share and peak device
    memory printed); as another path the same generator at 2^17 proved
    unrolled (its pairing inputs non-null, the Keccak verifier rejecting
    it); a lookup outside every table raises ValueError;
5f. the escape-hatch circuit at the production tree depths (32, 256, 28;
    one tx with two real input notes): 26 public inputs, ``check_turbo``
    clean, keyed, proved with the Keccak Turbo prover, verified, a tamper
    rejected; the tx with a fee of 1 (at depth 3) fails its constraints;
5g. MiMC7 in MiMC gates on the ``MiMCComposer`` at 2^17 gates:
    ``check_mimc`` clean, keyed, proved twice and verified, a tamper
    rejected; then, outside the path, ``elliptic_identity`` over 2^16 rows
    on the card against its result on the CPU (the plain versions);
5h. from a Noir program to the contract (``--noir`` alone): the port's
    Noir compiler compiles aztec_tpu_torch/tools/noir_sha256.py's SHA-256
    program over a 1,000-byte seeded message (16 blocks, about 455,000
    gates, 2^19) onto a ``TurboComposer``; its eight digest words are
    public and equal hashlib's; ``check_turbo`` clean, keyed, proved cold
    and warm (Keccak), each verified natively, a tamper rejected; the
    proof accepted by the bytecode of the port's ``generate_verifier`` in
    the port's EVM and by the native verifier, three one-bit mutations
    (one in a digest word) refused by both; ``write_verifier_sources``
    writes the five Solidity files; then a 247-byte message through
    ``PackedByteArray`` and ``sha256_bytes`` (4 blocks, 2^17) proved once
    and accepted by both verifiers;
6. the MSM engine at full width: phase 3's MSM through
   ``msm(..., MSMConfig(c=16, block=64, bucket_block=64, glv=True))`` (the
   packed branch: K3 and K4 once a round) and through the staged rounds,
   both equal to the golden;
7. a 2^11-point MSM at the reference's small tier (the engine's unpacked
   branch: K5 once a round) against the golden; then, outside the path's
   count, where its time goes: device ms by kernel group and the idle
   share (torch.profiler), and wall seconds by stage (GLV, rake, carries,
   bucket phase, doublings, finish, the rest);
8. the 2^20-point dev SRS from ``fixed_base_mul`` (K2 ``proj_dbl``)
   against the committed table, bit for bit;
9. the chain circuit at 2^20 gates, whose SRS of 2^20 + 1 points comes
   from ``fixed_base_mul``: proved, verified, a tamper rejected (the peak
   device memory of the key and one proof printed, as in phase 4);
10. the microbenchmarks (``aztec_tpu_torch.tools``) as a user runs them,
    at widths that fill the card: every ``vpu_microbench`` kind at rows 4
    and 16 over 8192 tiles' worth of columns, with its element-ops per
    second beside the programming guide's rate, and every
    ``kernel_dissect`` body over 2^22 elements, on device time, each timed
    launch's output held against its plain version;
12. the host C++ core, the Pedersen lanes and the parallel layer
    (``--parallel`` alone): the 2^17 chain circuit replayed gate by gate
    into the g++-built composer core (``aztec_tpu_torch/host_native``,
    built beside nvcc in phase 1), its sigma mappings and witness columns
    equal to the port composer's, and the C ABI (Pedersen, Blake2s,
    Keccak, Schnorr) equal to the port's crypto/; ``compress_batch`` over
    2^16 pairs (one level of a 2^17-leaf tree), 256 sampled lanes (zero
    and skew lanes among them) against the host hash; phase 3's 2^20 MSM
    through ``parallel.sharded_msm`` over 1, 2 and 4 shards of the card
    (the chunked route), each equal to the golden, and 2^11 points over 4
    shards (the engine route, K5) equal to the single-device MSM; the
    2^20-point coset FFT over 4 shards equal to ``poly.fft.coset_fft``;
    as the slice's path, the 2^17 chain proof with
    ``MeshExecutor(Mesh.local(4))`` as the prover's executor and its coset
    FFTs split into quarters, under phase 4's counter rng, equal byte for
    byte to the inline proof and verified; last ``parallel.multihost``:
    two gloo processes of two shards each over 2^16 committed points,
    process 0's result equal to the single-device MSM;
11. the redesign rankings (each kernel's device ms in the profiled warm
    2^17 proof less the bound of the elements it ran over; each kernel's
    launches over the paths times its device ms less its bound), a JSON
    line with every kernel's launches summed over the paths, times, bound
    and launches in a warm join-split, 2^20 Ultra, escape-hatch and 2^19
    Noir SHA-256 proof, and in phase 12's Pedersen lanes and mesh proof
    (``launches_parallel``), then the card's name and power
    limit, then the result line.

Exits 2 without a result when CUDA is missing or the package is not beside
this script.  The smoke imports nothing of JAX or of the JAX package and
fails if it finds either loaded.

``python3 chip_smoke.py --redesigned`` runs phase 2's K1-K3 checks and
the redesigned kernels' phase alone (their edge lanes and their times at
the proof's widths; ``mont_pow`` beside the launch chain it replaces, K5
at the small tier's width and wider), then the profiled warm 2^17 proof
and the ranking, and last the lazy kernels on unreduced lanes (so an older
commit prints its times before its kernels fail that check).  Copied beside an older checkout's package, it measures that
commit's kernels with the same script, on the same card.

``python3 chip_smoke.py --tower`` runs phase 5d alone, ``--noir`` phase
5h alone; ``--quarters`` the
prover's two memory plans on the 2^17 Turbo circuit (keccak and unrolled)
and the 2^20 chain circuit: keyed and proved under the counter rng with
the key's 4n coset forms and by coset quarters, the same bytes, each
plan's key and proof seconds and peak device memory.

``python3 chip_smoke.py --parallel`` runs phase 12 alone (after the
build).

``python3 chip_smoke.py --ultra`` runs phase 5e alone, ``--ultra-recursion``
the in-circuit verifier (a TurboComposer of about 8.4M gates) over the 2^17
unrolled-Ultra proof: its P0/P1 against the native verifier's pairing
inputs, ``check_turbo`` clean (a one-off: not in the whole smoke, for time).

``python3 chip_smoke.py --warm-proofs`` times the stored-coset prover's
warm proofs (2^17 Standard, 2^17 Turbo keccak and unrolled, the depth-32
join-split, 2^20 Standard), then one proof of each by round and under
cProfile.  Copied beside an older checkout's package and run from each
checkout in turns, it compares the two commits' proofs on one card.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
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
    # 8 products a doubling: the one by 3b is 9t = 8t + t, four adds
    "proj_dbl_n": ("group_ops.cu", "aztec_tpu/curves/group_pallas.py:137", 3, 3,
                   (8, 9 + 4)),
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
                 (8, 9 + 4)),
    "mul_add": ("field_ops.cu", "aztec_tpu/ff/pallas_field.py:369", 3, 1,
                (1, 1)),
    # the products depend on the exponent: counted where it is timed
    "mont_pow": ("field_ops.cu", "aztec_tpu/ff/pallas_field.py:326 "
                 "(mont_mul), aztec_tpu/ff/limb.py:248 (mont_pow)", 1, 1,
                 (0, 0)),
    # a fused composition, no Pallas call: X, Y and the scalar in, the two
    # table planes (2 points each) and the scalar plane (2 x 8 limbs) out;
    # beta X and the split's 272 word products (544 multiply-add results,
    # about two Montgomery products), and -Y
    "glv_table": ("glv.cu", "aztec_tpu/msm/glv.py:297 (glv_table: jnp ops, "
                  "no Pallas call)", 3, 5, (3, 1)),
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
           "sub_mod_kernel": "sub_mod", "fft_stages_kernel": "butterfly",
           "mul_add_kernel": "mul_add", "mixed_add_kernel": "mixed_add_unsafe",
           "add_unsafe_kernel": "add_unsafe",
           "proj_add_kernel": "proj_add_complete",
           "proj_dbl_n_kernel": "proj_dbl_n", "j2c_kernel": "jacobian_to_proj",
           "c2j_kernel": "proj_to_jacobian",
           "rake_packed_kernel": "rake_scan_packed",
           "rake_packed_exact_kernel": "rake_scan_packed",
           "rake_lazy_kernel": "rake_scan", "rake_exact_kernel": "rake_scan",
           "mont_pow_kernel": "mont_pow",
           "glv_table_kernel": "glv_table",
           "bucket_lanes_kernel": "bucket_phase",
           "bucket_final_kernel": "bucket_phase",
           # the kernels of an older commit, for a same-card comparison
           "butterfly_kernel": "butterfly", "rake_kernel": "rake_scan",
           "bucket_combine_kernel": "bucket_phase"}

# The widths the 2^17 proof launches the redesigned kernels at.  The two
# K2 adds: the widest barrier (24 rows x 2^16: the tails and the fold), 8,
# 16 and 24 rows x 4096 lanes (a count of the proof's launches by width put
# 65 of its 69 add_unsafe launches there), the composed bucket phase of one
# MSM and of the three-MSM barrier (8 GLV rows x 1024 lanes each), and the
# Horner fold (one lane per MSM).  K3 (K = 64
# steps a lane): the widest barrier's chunk (24 rows x 4096 lanes) and one
# MSM's (8 rows).  proj_dbl_n (16 doublings): the fold of one MSM (1 lane:
# the engine's, the chunked pipeline's Horner fold), of a three-MSM
# barrier (3), and one eight times wider (24).
RAKE_K = 64
K2_ADD_WIDTHS = (24 << 16, 98304, 65536, 32768, 24576, 8192, 3)
REDESIGNED_WIDTHS = {"add_unsafe": K2_ADD_WIDTHS,
                     "proj_add_complete": K2_ADD_WIDTHS,
                     "rake_scan_packed": (24 * 4096, 8 * 4096),
                     "proj_dbl_n": (1, 3, 24),
                     # K4: the engine's 2^16 buckets (c = 16) and 1,024
                     "bucket_phase": (1 << 16, 1024),
                     # the FFT (its stage kernel) at the proof's sizes: n and
                     # the quotient's 4n
                     "butterfly": (1 << 17, 1 << 19),
                     # an Fq inversion (p - 2): the proof's (one element a
                     # barrier), a three-MSM barrier's, the quotient's 4n
                     "mont_pow": (1, 3, 1 << 19),
                     # K5 (B lanes, K steps): the small tier's, then wider
                     "rake_scan": ((128, 32), (1000, 4), (1000, 64),
                                   (4096 + 5, 4), (4096 + 5, 64)),
                     # the GLV table of one MSM's chunk
                     "glv_table": (1 << 17,)}
# the edge lanes' widths: a partial last block at every block size
K2_EDGE_WIDTHS = (1, 3, 33, 8192 + 5, 24576)
DBL_EDGE_WIDTHS, DBL_EDGE_STEPS = (1, 3, 33, 8192 + 5), (1, 16)
RAKE_EDGE_B, RAKE_EDGE_K = (1, 33, 128, 4096 + 5), (1, 4, 64)
K5_EDGE_B, K5_EDGE_K = (1, 127, 128, 1000, 4096 + 5), (1, 4, 32, 64)
# mont_pow's edge widths, and its exponents beside p - 2: 2^k, 0 and 1
POW_EDGE_WIDTHS, POW_EDGE_EXPS = (1, 3, 1000, 1 << 16), (1 << 100, 0, 1)
# the GLV table's edge widths: a chunk's 2^17 points and 5 more, and
# partial last blocks
GLV_EDGE_WIDTHS = (1, 33, 8192 + 5, (1 << 17) + 5)
# exponents 2^64 and 2^192 at width 1: their times' difference over 128
# is the latency of one lazy product, the chain's step
POW_LATENCY_EXPS = (1 << 64, 1 << 192)
# The narrow launches' chain floors: a width-1 to -24 launch is bound by
# its chain of dependent Montgomery products, not by the card's rates.
# name: (dependent product levels of one point, the product's form).  A
# proj_dbl step: Y^2, YZ, Z^2 and XY, then four products of them (2); c2j:
# Z^2 and XZ, then Y Z^2, in field.cuh's canonical form (2);
# mixed_add_unsafe: Z1^2 and Y2 Z1; U2 and S2; H^2, r^2 and (Z1 + H)^2;
# J = H I and V = X1 I; Y1 J and r (V - X3) (5).  The floor is the levels
# times one product's latency (mont_pow's slope, lazy or canonical) plus
# an empty launch's device time, each measured in the same run.
CHAIN_LEVELS = {"proj_dbl": (2, "lazy"), "proj_to_jacobian": (2, "canonical"),
                "mixed_add_unsafe": (5, "lazy")}
# Montgomery products a thread of each redesigned kernel computes a point
# (rake_packed_kernel: an entry; proj_add computes 3b by two more where its
# NINE template argument is 0)
PRODUCTS = {"add_unsafe_kernel": 16, "proj_add_kernel": 12,
            "rake_packed_kernel": 11, "rake_lazy_kernel": 5}
# kernels of the redesigned phase: a spill fails the run
REDESIGNED_SYMBOLS = ("add_unsafe_kernel", "proj_add_kernel",
                      "rake_packed_kernel", "proj_dbl_n_kernel",
                      "fft_stages_kernel", "rake_lazy_kernel",
                      "mont_pow_kernel", "glv_table_kernel")
# the libraries whose kernels' registers, spills and SASS the redesigned
# phase prints (K4 calls its formulas out of line: its stack holds the
# calls' frames, so it is printed and not held to zero)
REDESIGNED_LIBS = ("group_ops", "rake", "bucket", "field_ops", "glv")

# The main path's widest work-queue barrier: the three wire (or the three
# quotient) commitments of the 2^17 proof run as one batch of MSMs over one
# 2^17-point chunk, at the card's geometry (c = 16, GLV, K = 64).
PROOF_BATCH = 3
WINDOW = 16
# The Turbo path's widest barrier commits four MSMs (the four wires, or the
# four quotient pieces): 32 GLV rows.  The committed small Turbo vectors
# it proves first, and the warm proofs a flavor it times.
TURBO_BATCH = 4
TURBO_VECTORS = ("turbo_drive", "unrolled_turbo_drive", "turbo_pedersen")
TURBO_WARM = 1
# Phase 5c: the rollup's join-split at the production data-tree depth
# (rollup/constants.py: 2^17 gates), its warm unrolled proofs, the account
# circuit at the same depth, and the proof worker's demo circuits' size.
JOIN_SPLIT_DEPTH = 32
JOIN_SPLIT_WARM = 1
WORKER_GATES = 1 << 10
TOWER_TXS = 1          # the rollup tower's txs (tools/rollup_tower.py's)
TOWER_TIMEOUT = 900    # seconds the tower's worker may take
TOWER_DEPOSIT = 100    # the SDK's deposit into the tower, and its fee
TOWER_FEE = 10
WARM_REPS = 5          # warm proofs a case of ``--warm-proofs``
# Phase 5e: tools/ultra_circuit.py's circuit at 2^20 gates (the tables and
# lookup counts by subgroup size; 2^17's are smaller so that its tables fit)
# and unrolled at 2^17, after the committed small Ultra vectors
ULTRA_LOG2N = 20
ULTRA_UNROLLED_LOG2N = 17
ULTRA_SHAPES = {
    20: dict(range_bits=16, logic_bits=8, ranges=1 << 15, logic=1 << 16),
    17: dict(range_bits=14, logic_bits=6, ranges=1 << 12, logic=1 << 13),
}
ULTRA_SEEDS = (111, 112)
ULTRA_VECTORS = ("ultra_drive", "unrolled_ultra_drive")
# Phase 5f: the escape hatch at rollup/constants.py's tree depths (data,
# nullifier, root); phase 5g: MiMC gates and the elliptic widget's rows
ESCAPE_DEPTHS = (32, 256, 28)
MIMC_LOG2N = 17
ELLIPTIC_ROWS = 1 << 16
NOIR_MESSAGE_BYTES = 1000   # phase 5h's Noir SHA-256 message: 16 blocks
NOIR_LOG2N = 19
NOIR_STDLIB_BYTES = 247     # the stdlib path's message: 4 blocks
NOIR_STDLIB_LOG2N = 17
NOIR_MUTATIONS = 3          # one-bit mutations, the first in a digest word


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
    put lane 0 at U / R >= 2^256 and lane 1 at a + b = 2^256.  mont_pow
    (where the package has it) raises a to p - 2 and to 2^100."""
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
        for e in (spec.modulus - 2, 1 << 100) if hasattr(fk, "mont_pow") \
                else ():
            if max_abs_err(fk.mont_pow(a, exp_bits(e), spec),
                           limb.mont_pow_plain(a, exp_bits(e), spec)):
                raise AssertionError(f"mont_pow ({spec.name}, e = {e:#x}) "
                                     "differs from its plain version on "
                                     "unreduced operands")
    log(f"kernel K1 on unreduced operands (mont_mul, add_mod, sub_mod, "
        f"mul_add, butterfly, mont_pow; Fr and Fq; {n} lanes): "
        "max_abs_err=0")


def exp_bits(e: int) -> list:
    """e's bits, LSB first (as the ladder takes its exponent)."""
    return [(e >> i) & 1 for i in range(max(e.bit_length(), 1))]


def ladder_products(e: int) -> int:
    """Montgomery products of the ladder for e: a squaring a bit below the
    top one and a product a set bit."""
    return max(e.bit_length() - 1, 0) + bin(e).count("1")


def mont_mul_chain(a, bits, spec, one):
    """The ladder as the port ran it before ``mont_pow``: one K1 mont_mul
    launch a product (the launch chain ``fk.mont_pow`` replaces); ``one``
    the Montgomery one at a's shape, made beforehand so that the chain can
    be captured in a CUDA graph."""
    from aztec_tpu_torch.ff import field_kernels as fk

    result = one
    base = a
    last = max((i for i, b in enumerate(bits) if b), default=-1)
    for i in range(last + 1):
        if bits[i]:
            result = fk.mont_mul(result, base, spec)
        if i < last:
            base = fk.mont_mul(base, base, spec)
    return result


def pow_edge_lanes(gen, spec, w: int, device):
    """(16, w) planes for mont_pow: lanes cycle through 0, 1, p - 1, p,
    p + 1, 2p - 1, all 0xFFFF, a canonical random element and uniform
    16-bit limbs (mostly >= p)."""
    import numpy as np
    import torch

    from aztec_tpu_torch.numeric.bigint import ints_to_limbs

    p = spec.modulus
    special = torch.as_tensor(ints_to_limbs(
        [0, 1, p - 1, p, p + 1, 2 * p - 1, (1 << 256) - 1]).astype(np.int32),
        device=device)
    x = torch.randint(0, 1 << 16, (16, w), generator=gen, dtype=torch.int32,
                      device=device)
    lane = torch.arange(w, device=device) % (special.shape[1] + 2)
    x[15] = torch.where(lane == special.shape[1], x[15] % (p >> 240), x[15])
    pick = lane < special.shape[1]
    x[:, pick] = special[:, lane[pick]]
    return x


def check_mont_pow_edges(gen, device) -> None:
    """``fk.mont_pow`` against its plain version, bit for bit, on
    ``pow_edge_lanes`` at every width of POW_EDGE_WIDTHS, for Fr and Fq,
    with the exponents p - 2 and POW_EDGE_EXPS (the plain version at the
    widest width for p - 2 only)."""
    from aztec_tpu_torch.ff import FQ, FR, limb
    from aztec_tpu_torch.ff import field_kernels as fk

    for spec in (FR, FQ):
        for w in POW_EDGE_WIDTHS:
            x = pow_edge_lanes(gen, spec, w, device)
            exps = ((spec.modulus - 2,) + POW_EDGE_EXPS
                    if w < max(POW_EDGE_WIDTHS) else (spec.modulus - 2,))
            for e in exps:
                if max_abs_err(fk.mont_pow(x, exp_bits(e), spec),
                               limb.mont_pow_plain(x, exp_bits(e), spec)):
                    raise AssertionError(
                        f"mont_pow ({spec.name}, width {w}, e = {e:#x}) "
                        "differs from its plain version on the edge lanes")
    log(f"kernel mont_pow: edge lanes (0, 1, p - 1, p, p + 1, 2p - 1, all "
        f"0xFFFF, canonical, uniform limbs), Fr and Fq, widths "
        f"{list(POW_EDGE_WIDTHS)}, e = p - 2, 2^100, 0, 1: max_abs_err=0")


def glv_flat(table):
    """glv_table's ((Xt, Yt), St) as the flat tuple (Xt, Yt, St)."""
    (Xt, Yt), St = table
    return Xt, Yt, St


def glv_edge_case(gen, curve, w: int, device):
    """(X, Y, S) (16, w + 7) planes for the GLV table, read as the column
    slice 3 .. 3 + w: scalar lanes cycle through 0, 1, r - 1, r, lambda,
    2^256 - 1 (all 0xFFFF), both sides of Babai rounding edges of each
    magic (the k where c_h steps up), a random value below r and uniform
    16-bit limbs; X and Y lanes, out of step, through 0, p - 1, p, 2p - 1,
    all 0xFFFF, a canonical element and uniform limbs."""
    import numpy as np
    import torch

    from aztec_tpu_torch.msm import glv
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs

    P, r, p = glv.glv_params(curve), curve.order, curve.field.modulus
    ks = [0, 1, r - 1, r, P["lam"], (1 << 256) - 1]
    for m in P["magics"]:
        top = (m * r) >> 416
        for c in (1, top // 3, top - 1):
            edge = -(-((2 * c + 1) << 415) // m)
            ks += [edge, edge - 1]

    def lanes(special, shift, below):
        x = torch.randint(0, 1 << 16, (16, w + 7), generator=gen,
                          dtype=torch.int32, device=device)
        sp = torch.as_tensor(ints_to_limbs(special).astype(np.int32),
                             device=device)
        lane = (torch.arange(w + 7, device=device) + shift) % (len(special)
                                                               + 2)
        x[15] = torch.where(lane == len(special), x[15] % (below >> 240),
                            x[15])
        pick = lane < len(special)
        x[:, pick] = sp[:, lane[pick]]
        return x

    pts = [0, p - 1, p, 2 * p - 1, (1 << 256) - 1]
    return lanes(pts, 0, p), lanes(pts, 2, p), lanes(ks, 0, r)


def check_glv_table_edges(gen, device) -> None:
    """``glv.glv_table`` (one launch of csrc/glv.cu) against
    ``glv_table_plain``, bit for bit, on ``glv_edge_case`` at every width
    of GLV_EDGE_WIDTHS, for BN254 G1 (Fq) and Grumpkin (Fr), each input a
    column slice of wider planes, as the chunked MSM passes it."""
    from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
    from aztec_tpu_torch.msm import glv

    for curve in (BN254_G1, GRUMPKIN_G1):
        for w in GLV_EDGE_WIDTHS:
            X, Y, S = glv_edge_case(gen, curve, w, device)
            args = ((X[:, 3:3 + w], Y[:, 3:3 + w]), S[:, 3:3 + w], curve)
            if max_abs_err(glv_flat(glv.glv_table(*args)),
                           glv_flat(glv.glv_table_plain(*args))):
                raise AssertionError(
                    f"glv_table ({curve.field.name}, width {w}) differs from "
                    "its plain version on the edge lanes")
    log(f"kernel glv_table: edge lanes (scalars 0, 1, r - 1, r, lambda, all "
        f"0xFFFF, Babai rounding edges, random, uniform limbs; X, Y 0, "
        f"p - 1, p, 2p - 1, all 0xFFFF, canonical, uniform limbs), column "
        f"slices, BN254 G1 and Grumpkin, widths {list(GLV_EDGE_WIDTHS)}: "
        "max_abs_err=0")


def unreduced_lanes(gen, spec, w: int, device, canonical_from=None):
    """(16, w) planes of uniform 16-bit limbs (most lanes >= p); lanes 0-5
    all 0xFFFF, p, p + 1, 2p - 1, 1 and 0 (a Z of 0); lanes from
    ``canonical_from`` on canonical (top limb below p's)."""
    import numpy as np
    import torch

    from aztec_tpu_torch.numeric.bigint import ints_to_limbs

    p = spec.modulus
    x = torch.randint(0, 1 << 16, (16, w), generator=gen, dtype=torch.int32,
                      device=device)
    special = torch.as_tensor(ints_to_limbs(
        [(1 << 256) - 1, p, p + 1, 2 * p - 1, 1, 0]).astype(np.int32),
        device=device)
    k = min(w, special.shape[1])
    x[:, :k] = special[:, :k]
    if canonical_from is not None:
        x[15, canonical_from:] %= p >> 240
    return x


def rake_unreduced_case(gen, B: int, K: int, spec, device):
    """K3's inputs (digits (K, B), packed points (16, K * B), K-major):
    sorted random digits, one run of all K digits on every 4th lane, the
    points canonical but for unreduced ones in the middle of the runs
    (entries 1 and 2 of every other lane, every entry of lane 1)."""
    import torch

    from aztec_tpu_torch.curves.group_ops import JacobianOps
    from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
    from aztec_tpu_torch.ff import FQ

    X, Y = (unreduced_lanes(gen, spec, K * B, device).reshape(16, K, B)
            for _ in range(2))
    k = torch.arange(K, device=device)[:, None].expand(K, B)
    lane = torch.arange(B, device=device)[None, :].expand(K, B)
    dig = torch.where(lane % 4 == 0, 3, torch.sort(torch.randint(
        0, 3, (K, B), generator=gen, device=device), dim=0).values)
    keep = ((lane % 2 == 1) & ((k == 1) | (k == 2))) | (lane == 1)
    for c in (X, Y):
        c[15] = torch.where(keep, c[15], c[15] % (spec.modulus >> 240))
    curve = BN254_G1 if spec is FQ else GRUMPKIN_G1
    packed = JacobianOps(curve, device).pack_affine(
        (X.reshape(16, K * B), Y.reshape(16, K * B)))
    return dig, packed


def check_unreduced_lazy(gen, dev) -> list:
    """Every lazily reduced kernel against its plain version, bit for bit,
    on unreduced lanes (``unreduced_lanes``; lanes in range and out of it
    share warps, and whole warps lie in range): the K2 adds, doublings and
    ``jacobian_to_proj`` at 8,197 points (Fq with b = 3, Fr with Grumpkin's
    b and with b = 3), K3 at B = 4,101 and K5 at B = 128 with unreduced
    points in the middle of runs, K4 at 1,024 buckets and one engine
    round at 2^16, the FFT's stage kernel at every boundary of a 2^12 FFT,
    1 to 3 stages a launch, and K1 mont_pow (Fr and Fq, e = p - 2) at
    8,197 lanes.  The plain versions equal the reference there.  Returns
    the names of the kernels that differ."""
    import torch

    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves import group_kernels as gk
    from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
    from aztec_tpu_torch.ff import FQ, FR, limb
    from aztec_tpu_torch.ff import field_kernels as fk
    from aztec_tpu_torch.msm import bucket, rake

    failed = []

    def same(name, got, want):
        err = max_abs_err(got, want)
        if err:
            failed.append(name)
        log(f"kernel {name} on unreduced lanes: max_abs_err={err}")

    w = 8192 + 5
    for spec, b in ((FQ, BN254_G1.b), (FR, GRUMPKIN_G1.b), (FR, BN254_G1.b)):
        P = tuple(unreduced_lanes(gen, spec, w, dev, 64) for _ in range(3))
        Q = tuple(unreduced_lanes(gen, spec, w, dev, w // 2)
                  for _ in range(3))
        tag = f"{spec.name}, " + ("b=3" if b == 3 else "Grumpkin's b")
        same(f"mixed_add_unsafe ({tag})", gk.mixed_add_unsafe(P, Q[:2], spec),
             group.mixed_add_unsafe(P, Q[:2], spec))
        same(f"add_unsafe ({tag})", gk.add_unsafe(P, Q, spec),
             group.add_unsafe(P, Q, spec))
        same(f"proj_add_complete ({tag})", gk.proj_add_complete(P, Q, spec, b),
             group.proj_add_complete(P, Q, spec, b))
        same(f"proj_dbl ({tag})", gk.proj_dbl(P, spec, b),
             group.proj_dbl(P, spec, b))
        Pd = (P[0], P[1].clone(), P[2])
        Pd[1][15, 64::97] = 0xFFFF     # one unreduced point in some warps
        same(f"proj_dbl_n ({tag}, {WINDOW} steps)",
             gk.proj_dbl_n(Pd, spec, b, WINDOW),
             group.proj_dbl_n(Pd, spec, b, WINDOW))
        same(f"jacobian_to_proj ({tag})", gk.jacobian_to_proj(P, spec),
             group.jacobian_to_proj(P, spec))
    for spec in (FR, FQ):
        for B, K in ((4096 + 5, 64), (128, 32)):
            dig, packed = rake_unreduced_case(gen, B, K, spec, dev)
            same(f"rake_scan_packed ({spec.name}, B={B}, K={K})",
                 rake.rake_scan_packed(dig, packed, B, K, spec),
                 rake.rake_scan_packed_plain(dig, packed, B, K, spec))
            X, Y = rake.unpack(packed)
            # K5's n-order column b K + k is K3's K-major column k B + b
            nord = torch.arange(K * B, device=dev).reshape(K, B).T.reshape(-1)
            sd = dig.T.reshape(-1)
            pts = (X[:, nord], Y[:, nord])
            same(f"rake_scan ({spec.name}, B={B}, K={K})",
                 rake.rake_scan(sd, pts, B, K, spec),
                 rake.rake_scan_plain(sd, pts, B, K, spec))
    for spec in (FR, FQ) if hasattr(fk, "mont_pow") else ():
        x = unreduced_lanes(gen, spec, w, dev, w // 2)
        bits = exp_bits(spec.modulus - 2)
        same(f"mont_pow ({spec.name}, e = p - 2, {w} lanes)",
             fk.mont_pow(x, bits, spec),
             limb.mont_pow_plain(x, bits, spec))
    from aztec_tpu_torch.msm import glv

    for curve in (BN254_G1, GRUMPKIN_G1) if hasattr(glv, "glv_table_plain") \
            else ():
        spec = curve.field
        X, Y = (unreduced_lanes(gen, spec, w, dev, w // 2) for _ in range(2))
        S = unreduced_lanes(gen, FR if spec is FQ else FQ, w, dev)
        same(f"glv_table ({spec.name}, {w} lanes)",
             glv_flat(glv.glv_table((X, Y), S, curve)),
             glv_flat(glv.glv_table_plain((X, Y), S, curve)))
    b = BN254_G1.b
    plain_ops = bucket.PlainOps(FQ, b, dev)
    for nb, steps in ((1024, 0), (1 << 16, WINDOW)):
        bk = tuple(unreduced_lanes(gen, FQ, nb, dev, 4096) for _ in range(3))
        acc = (tuple(unreduced_lanes(gen, FQ, 1, dev) for _ in range(3))
               if steps else None)
        same(f"bucket_phase ({nb} buckets, dbl_steps={steps})",
             bucket.bucket_phase(bk, nb, FQ, b, acc, steps),
             bucket.bucket_phase_plain(plain_ops, bk, nb, acc, steps))
    if not hasattr(fk, "fft_stages"):
        log("kernel fft_stages: not in this package")
        return failed
    n, logn = 1 << 12, 12
    A0 = unreduced_lanes(gen, FR, n, dev, n // 2)
    roots = unreduced_lanes(gen, FR, n // 2, dev, 64)
    for s in range(1, fk.MAX_STAGES + 1):
        A, t, err = A0, 0, 0
        while t < logn:
            st = min(s, logn - t)
            want = fk.fft_stages_plain(A, roots, t, st, FR)
            err = max(err, max_abs_err(fk.fft_stages(A, roots, t, st, FR),
                                       want))
            A, t = want, t + st
        name = f"fft_stages ({s} stages a launch, 2^{logn})"
        log(f"kernel {name} on unreduced lanes: max_abs_err={err}")
        if err:
            failed.append(name)
    return failed


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


def k4_operations(nb: int, steps: int):
    """(Montgomery products, field adds) that K4's function needs at nb
    buckets with an accumulator and `steps` doublings of it, b = 3: a j2c
    (3 products) and two complete adds a bucket (the suffix sums: the
    running sum and the sum of the running sums), then acc' = 2^steps acc
    + W.  The work of splitting the buckets over lanes (this design's
    scans, trees and their doublings) is not counted.  A complete add is
    12 products and 27 adds (9t by additions), a doubling 8 and 13."""
    adds = 2 * nb + 1
    return (3 * nb + 12 * adds + 8 * steps, 27 * adds + 13 * steps)


def fft_bound_ms(n: int, rate: float):
    """(least ms, what bounds it) of an n-point FFT: the array read once
    and written once and the root table (n / 2 elements) read once, or its
    log2(n) n / 2 products and log2(n) n adds and subs."""
    logn = n.bit_length() - 1
    return bound_ms("butterfly", n, rate, nbytes=(2 * n + n // 2) * PLANE_BYTES,
                    products=(logn * n // 2, logn * n))


def check_new_kernels(results: dict, rate: float) -> None:
    """Phase 2, the later slices' kernels (K4, K5, K2 proj_dbl, K1 mul_add
    and mont_pow, the GLV table) vs their plain versions at their paths'
    shapes."""
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
    products = k4_operations(nb, steps)
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

    # K1 mont_pow at its path's width 1: an Fq inversion (e = p - 2), the
    # to_affine of a commitment barrier
    e = FQ.modulus - 2
    x1 = random_field(gen, (1,), dev)
    record_("mont_pow", lambda: fk.mont_pow(x1, exp_bits(e), FQ),
            lambda: limb.mont_pow_plain(x1, exp_bits(e), FQ), 1,
            products=(ladder_products(e), 0))

    # the GLV table of one MSM's chunk (2^17 points), its inputs a column
    # slice of wider planes, as the chunked MSM's prep passes them
    from aztec_tpu_torch.msm import glv

    w = 1 << 17
    X, Y, S = (random_field(gen, (2 * w,), dev) for _ in range(3))
    args = ((X[:, w:], Y[:, w:]), S[:, w:], BN254_G1)
    record_("glv_table", lambda: glv_flat(glv.glv_table(*args)),
            lambda: glv_flat(glv.glv_table_plain(*args)), w)


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


def rake_edge_case(gen, B: int, K: int, spec, device):
    """K3's inputs for B lanes of K steps, the lanes cycling through: one
    run of all K digits, a restart at every step, alternating digits, runs
    of four whose second point equals the first (P = Q inside a run: the
    first step restarts with Z = 1) or is its negative (P = -Q), points of
    coordinates drawn from {0, 1, p - 1}, and sorted random digits.
    Returns (digits (K, B), packed points (16, K * B)), K-major."""
    import numpy as np
    import torch

    from aztec_tpu_torch.curves.group_ops import JacobianOps
    from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
    from aztec_tpu_torch.ff import FQ, limb
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs

    X, Y = (random_field(gen, (K, B), device) for _ in range(2))
    k = torch.arange(K, device=device)[:, None].expand(K, B)
    kind = (torch.arange(B, device=device) % 7)[None, :].expand(K, B)
    rnd = torch.sort(torch.randint(0, 4, (K, B), generator=gen,
                                   device=device), dim=0).values
    dig = torch.where(kind == 0, 5, torch.where(
        kind == 1, k, torch.where(kind == 2, k % 2, torch.where(
            (kind == 3) | (kind == 4), k // 4, rnd))))
    pair = (k % 4 == 1) & ((kind == 3) | (kind == 4))
    Xp, Yp = torch.roll(X, 1, dims=1), torch.roll(Y, 1, dims=1)
    negYp = limb.sub_mod(torch.zeros_like(Yp), Yp, spec)
    X = torch.where(pair, Xp, X)
    Y = torch.where(pair & (kind == 3), Yp,
                    torch.where(pair & (kind == 4), negYp, Y))
    special = torch.as_tensor(
        ints_to_limbs([0, 1, spec.modulus - 1]).astype(np.int32), device=device)
    edge = kind == 5
    for c in (X, Y):
        pick = special[:, torch.randint(0, 3, (K, B), generator=gen,
                                        device=device)]
        c[:, edge] = pick[:, edge]
    curve = BN254_G1 if spec is FQ else GRUMPKIN_G1
    packed = JacobianOps(curve, device).pack_affine(
        (X.reshape(16, K * B), Y.reshape(16, K * B)))
    return dig, packed


def k5_edge_case(gen, B: int, K: int, spec, device):
    """K5's inputs (sorted digits (B * K,), points (X, Y) (16, B * K) in
    n-order): ``rake_edge_case``'s lanes, with the top limb of X set to
    0xFFFF (a point at or above p) at every 5th lane's middle step, and at
    every step of lane 2."""
    import torch

    from aztec_tpu_torch.msm import rake

    dig, packed = rake_edge_case(gen, B, K, spec, device)
    X, Y = rake.unpack(packed)
    nord = torch.arange(K * B, device=device).reshape(K, B).T.reshape(-1)
    X, Y = X[:, nord].contiguous(), Y[:, nord].contiguous()
    X[15, K // 2::5 * K] = 0xFFFF
    if B > 2:
        X[15, 2 * K:3 * K] = 0xFFFF
    return dig.T.reshape(-1).contiguous(), (X, Y)


def check_redesigned_edges(device: str = "cuda") -> None:
    """The redesigned kernels against their plain versions, bit for bit, on
    edge lanes: the two K2 adds on ``edge_points`` at every width of
    K2_EDGE_WIDTHS, ``proj_dbl_n`` on its P at DBL_EDGE_WIDTHS and
    DBL_EDGE_STEPS (BN254 G1, b = 3: 9t by additions, over Fq and Fr, and
    Grumpkin's b = -17 over Fr: the products by 3b), ``mixed_add_unsafe``
    (which K3 and K5 share) on P and Q's (X, Y), K3 on ``rake_edge_case``
    for every B of RAKE_EDGE_B and K of RAKE_EDGE_K, K5 on
    ``k5_edge_case`` for every B of K5_EDGE_B and K of K5_EDGE_K, Fr and
    Fq, and (where the package has it) K1 mont_pow on its edge lanes
    (``check_mont_pow_edges``) and the GLV table on its own
    (``check_glv_table_edges``)."""
    import torch

    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves import group_kernels as gk
    from aztec_tpu_torch.curves.spec import BN254_G1, GRUMPKIN_G1
    from aztec_tpu_torch.ff import FQ, FR
    from aztec_tpu_torch.msm import rake

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)

    def same(name, kern, plain, what):
        if max_abs_err(kern, plain):
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"the edge lanes ({what})")

    for spec, b in ((FR, BN254_G1.b), (FQ, BN254_G1.b), (FR, GRUMPKIN_G1.b)):
        for w in sorted(set(K2_EDGE_WIDTHS) | set(DBL_EDGE_WIDTHS)):
            P, Q = edge_points(gen, w, spec, device)
            what = f"{spec.name}, b={b}, width {w}"
            if w in K2_EDGE_WIDTHS:
                same("add_unsafe", gk.add_unsafe(P, Q, spec),
                     group.add_unsafe(P, Q, spec), what)
                same("proj_add_complete", gk.proj_add_complete(P, Q, spec, b),
                     group.proj_add_complete(P, Q, spec, b), what)
                same("mixed_add_unsafe", gk.mixed_add_unsafe(P, Q[:2], spec),
                     group.mixed_add_unsafe(P, Q[:2], spec), what)
            if w in DBL_EDGE_WIDTHS:
                for st in DBL_EDGE_STEPS:
                    same("proj_dbl_n", gk.proj_dbl_n(P, spec, b, st),
                         group.proj_dbl_n(P, spec, b, st),
                         f"{what}, {st} steps")
    for spec in (FR, FQ):
        for B in RAKE_EDGE_B:
            for K in RAKE_EDGE_K:
                dig, packed = rake_edge_case(gen, B, K, spec, device)
                same("rake_scan_packed",
                     rake.rake_scan_packed(dig, packed, B, K, spec),
                     rake.rake_scan_packed_plain(dig, packed, B, K, spec),
                     f"{spec.name}, B={B}, K={K}")
        for B in K5_EDGE_B:
            for K in K5_EDGE_K:
                sd, pts = k5_edge_case(gen, B, K, spec, device)
                same("rake_scan", rake.rake_scan(sd, pts, B, K, spec),
                     rake.rake_scan_plain(sd, pts, B, K, spec),
                     f"{spec.name}, B={B}, K={K}")
    log(f"kernel add_unsafe, proj_add_complete, mixed_add_unsafe: edge lanes "
        f"(Z1 = 0, Z2 = 0, both, P = Q, P = -Q, identities, coordinates 0, "
        f"1, p - 1), Fr and Fq, b = 3 and Grumpkin's, widths "
        f"{list(K2_EDGE_WIDTHS)}; proj_dbl_n the same P at widths "
        f"{list(DBL_EDGE_WIDTHS)}, steps {list(DBL_EDGE_STEPS)}; "
        f"rake_scan_packed (runs, restarts, alternating digits, P = Q and "
        f"P = -Q in a run, coordinates 0, 1, p - 1), Fr and Fq, B in "
        f"{list(RAKE_EDGE_B)}, K in {list(RAKE_EDGE_K)}; rake_scan the same "
        f"lanes in n-order with points at or above p, B in "
        f"{list(K5_EDGE_B)}, K in {list(K5_EDGE_K)}: max_abs_err=0")
    from aztec_tpu_torch.ff import field_kernels as fk
    from aztec_tpu_torch.msm import glv

    if hasattr(fk, "mont_pow"):
        check_mont_pow_edges(gen, device)
    if hasattr(glv, "glv_table_plain"):
        check_glv_table_edges(gen, device)


def redesigned_resources() -> dict:
    """Registers, spill bytes and SASS instructions of every K2 and rake
    kernel (``cuobjdump -res-usage`` and ``-sass`` of the group_ops and rake
    builds in use): instructions a thread, and those of its largest loop
    (a K3 entry, a doubling of ``proj_dbl_n``); for the redesigned kernels
    of PRODUCTS also the IMAD-class instructions a Montgomery product.  A
    kernel of REDESIGNED_SYMBOLS that spills is listed under "spills".
    Returns {(kernel, template args): numbers, "spills": [kernel, ...]}."""
    from aztec_tpu_torch import native
    from aztec_tpu_torch.tools import sass

    out, spills = {}, []
    for lib in (x for x in REDESIGNED_LIBS if x in native.SOURCES):
        res, code = sass.resources(lib), sass.kernels(lib)
        for key in sorted(code):
            r, k = res[key], code[key]
            imad = sum(v for op, v in k.hist.items() if op.startswith("IMAD"))
            row = {"regs": r["REG"], "spill_bytes": r["STACK"] + r["LOCAL"],
                   "instructions": k.count, "loop": k.loop, "imad": imad}
            if key[0] in PRODUCTS:
                products = PRODUCTS[key[0]] + 2 * (
                    key[0] == "proj_add_kernel" and key[1][-1:] != (1,))
                row["imad_per_product"] = imad / products
            out[key] = row
            log(f"sass {key[0]}{list(key[1])}: regs={row['regs']} "
                f"spill_bytes={row['spill_bytes']} instructions={k.count} "
                f"loop={k.loop} imad={imad}"
                + (f" imad_per_product={row['imad_per_product']:.1f}"
                   if "imad_per_product" in row else "")
                + " " + " ".join(f"{op}={v}"
                                 for op, v in k.hist.most_common(6)))
            if key[0] in REDESIGNED_SYMBOLS and row["spill_bytes"]:
                spills.append(f"{key[0]}{list(key[1])}")
    out["spills"] = spills
    return out


def time_redesigned(rate: float) -> dict:
    """The redesigned kernels (Fq, BN254 G1) at the proof's widths
    (REDESIGNED_WIDTHS): device ms, call ms, ns a point (or entry, or
    bucket, or FFT element); held against the plain version below 2^16
    points (K3 at every width).  K4 runs one round of the engine
    (acc' = 2^16 acc + W).  The FFT is ``poly.fft`` and, where the package
    has the stage kernel, ``fk.fft_stages`` chained at each of 1 to 3
    stages a launch (width key "<n> s=<s>"), all held against its plain
    version.  K4 and the FFT also get their bound at each width
    (``k4_operations``, ``fft_bound_ms``).  K1 ``mont_pow`` (an Fq
    inversion) runs beside the launch chain it replaces (``mont_mul_chain``,
    width key "<w> chain"), against which it is held; first, the latency
    of one of its lazy products at width 1 (``POW_LATENCY_EXPS``), whose
    multiple by the ladder's length is the chain's floor at widths 1 and
    3.  K5 runs at the small tier's B = 128, K = 32 and wider.  Then the
    canonical product's latency (the same slope on an element above p)
    and an empty launch's device time give the narrow launches' chain
    floors (CHAIN_LEVELS).  Returns {name: {width: (ms, call_ms, bound_ms
    or None)}}, the latency under "mont_pow_product_latency_ms" and the
    floors under "chain_floor_ms"."""
    import numpy as np
    import torch

    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves import group_kernels as gk
    from aztec_tpu_torch.curves.group_ops import JacobianOps
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.ff import FQ, FR, limb
    from aztec_tpu_torch.ff import field_kernels as fk
    from aztec_tpu_torch.msm import bucket, rake
    from aztec_tpu_torch.poly import EvaluationDomain, fft_ops
    from aztec_tpu_torch.tools import timing

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    b = BN254_G1.b

    def pts(w):
        return tuple(random_field(gen, (w,), "cuda", zero_lanes=(i == 2))
                     for i in range(3))

    def rake_args(B):
        dig = torch.sort(torch.randint(0, 4, (RAKE_K, B), generator=gen,
                                       device="cuda"), dim=0).values
        Xa, Ya = (random_field(gen, (RAKE_K * B,), "cuda") for _ in range(2))
        return dig, JacobianOps(BN254_G1, "cuda").pack_affine((Xa, Ya))

    def fft_calls(n):
        dom = EvaluationDomain(n, "cuda")
        x = random_field(gen, (n,), "cuda")
        staged = hasattr(fk, "fft_stages")
        want, logn = None, n.bit_length() - 1
        if staged:              # the plain version: every stage in turn
            want, t = x, 0
            while t < logn:
                want = fk.fft_stages_plain(want, dom.forward_roots, t, 1, FR)
                t += 1
        yield n, (lambda: fft_ops.fft(x, dom)), (lambda: want), n
        for st in range(1, fk.MAX_STAGES + 1) if staged else ():
            def kern(st=st):
                A, t = x, 0
                while t < logn:
                    s = min(st, logn - t)
                    A, t = fk.fft_stages(A, dom.forward_roots, t, s, FR), t + s
                return A
            yield f"{n} s={st}", kern, (lambda: want), n

    def calls(name, w):
        if name == "glv_table":
            from aztec_tpu_torch.msm import glv

            if not hasattr(glv, "glv_table_plain"):
                return []
            X, Y, S = (random_field(gen, (2 * w,), "cuda") for _ in range(3))
            args = ((X[:, w:], Y[:, w:]), S[:, w:], BN254_G1)
            return [(w, lambda: glv_flat(glv.glv_table(*args)),
                     lambda: glv_flat(glv.glv_table_plain(*args)), w)]
        if name == "mont_pow":
            x = random_field(gen, (w,), "cuda")
            bits = exp_bits(FQ.modulus - 2)
            one = limb.one_mont(FQ, (w,), "cuda").contiguous()
            chain = (f"{w} chain", lambda: mont_mul_chain(x, bits, FQ, one),
                     lambda: None, w)
            if not hasattr(fk, "mont_pow"):
                return [chain]
            return [(w, lambda: fk.mont_pow(x, bits, FQ),
                     lambda: mont_mul_chain(x, bits, FQ, one), w), chain]
        if name == "rake_scan":
            B, K = w
            sd = torch.sort(torch.randint(0, 16, (B * K,), generator=gen,
                                          device="cuda")).values
            X, Y = (random_field(gen, (B * K,), "cuda") for _ in range(2))
            return [(f"B={B} K={K}",
                     lambda: rake.rake_scan(sd, (X, Y), B, K, FQ),
                     lambda: rake.rake_scan_plain(sd, (X, Y), B, K, FQ),
                     B * K)]
        if name == "bucket_phase":
            bk, acc = pts(w), pts(1)
            plain_ops = bucket.PlainOps(FQ, b, "cuda")
            return [(w, lambda: bucket.bucket_phase(bk, w, FQ, b, acc, WINDOW),
                     lambda: bucket.bucket_phase_plain(plain_ops, bk, w, acc,
                                                       WINDOW), w)]
        if name == "butterfly":
            return list(fft_calls(w))
        if name == "rake_scan_packed":
            dig, packed = rake_args(w)
            return [(w, lambda: rake.rake_scan_packed(dig, packed, w, RAKE_K,
                                                      FQ),
                     lambda: rake.rake_scan_packed_plain(dig, packed, w,
                                                         RAKE_K, FQ),
                     w * RAKE_K)]
        P = pts(w)
        if name == "proj_dbl_n":
            return [(w, lambda: gk.proj_dbl_n(P, FQ, b, WINDOW),
                     lambda: group.proj_dbl_n(P, FQ, b, WINDOW), w)]
        Q = pts(w)
        extra = (b,) if name == "proj_add_complete" else ()
        return [(w, lambda: getattr(gk, name)(P, Q, FQ, *extra),
                 lambda: getattr(group, name)(P, Q, FQ, *extra), w)]

    out = {name: {} for name in REDESIGNED_WIDTHS}
    lat = None
    if hasattr(fk, "mont_pow"):
        # the chain's step: one lazy product at width 1
        x1 = random_field(gen, (1,), "cuda")
        t = [timing.device_ms(lambda e=e: fk.mont_pow(x1, exp_bits(e), FQ))
             for e in POW_LATENCY_EXPS]
        lat = (t[1] - t[0]) / (POW_LATENCY_EXPS[1].bit_length()
                               - POW_LATENCY_EXPS[0].bit_length())
        out["mont_pow_product_latency_ms"] = lat
        log(f"redesigned mont_pow: one lazy product's latency at width 1 "
            f"{lat * 1e3:.4f} us (e = 2^64: {t[0]:.5f} ms, e = 2^192: "
            f"{t[1]:.5f} ms)")
        # the canonical product's: the ladder takes field.cuh's product
        # for an element at or above p
        big = limb.const(np.full(16, 0xFFFF), 2, "cuda").contiguous()
        tc = [timing.device_ms(lambda e=e: fk.mont_pow(big, exp_bits(e), FQ))
              for e in POW_LATENCY_EXPS]
        lat_c = (tc[1] - tc[0]) / (POW_LATENCY_EXPS[1].bit_length()
                                   - POW_LATENCY_EXPS[0].bit_length())
        empty = timing.empty_launch_ms()
        out["chain_floor_ms"] = {}
        for name, (levels, form) in CHAIN_LEVELS.items():
            floor = levels * (lat if form == "lazy" else lat_c) + empty
            out["chain_floor_ms"][name] = floor
            log(f"chain floor {name}: {levels} {form} product levels x "
                f"{(lat if form == 'lazy' else lat_c) * 1e3:.4f} us + an "
                f"empty launch {empty * 1e3:.4f} us = {floor * 1e3:.4f} us")
        log(f"redesigned mont_pow: one canonical product's latency at width "
            f"1 {lat_c * 1e3:.4f} us; an empty launch's device time "
            f"{empty * 1e3:.4f} us")
    for name, widths in REDESIGNED_WIDTHS.items():
        for w in widths:
            for key, kern, plain, elems in calls(name, w):
                ms = timing.device_ms(kern)
                cms, got = timing.call_ms(kern)
                if (name in ("rake_scan_packed", "butterfly", "rake_scan",
                             "mont_pow", "glv_table") or w < 1 << 16):
                    want = plain()
                    if want is not None and max_abs_err(got, want):
                        raise AssertionError(f"{name} differs at width {key}")
                bnd = None
                if name == "butterfly":
                    bnd = fft_bound_ms(w, rate)
                elif name == "bucket_phase":
                    bnd = bound_ms(name, w, rate, nbytes=(3 * w + 6)
                                   * PLANE_BYTES,
                                   products=k4_operations(w, WINDOW))
                elif name == "rake_scan":
                    bnd = bound_ms(name, elems, rate, nbytes=elems * (
                        4 + 2 * PLANE_BYTES + 3 * PLANE_BYTES))
                elif name == "glv_table":
                    bnd = bound_ms(name, w, rate)
                elif name == "mont_pow":
                    nprod = ladder_products(FQ.modulus - 2)
                    bnd = bound_ms(name, w, rate, products=(nprod * w, 0))
                    if lat is not None and w < 1 << 16:
                        log(f"redesigned mont_pow width={key}: the chain's "
                            f"floor {nprod} x {lat * 1e3:.4f} us = "
                            f"{nprod * lat:.5f} ms")
                out[name][key] = (ms, cms, bnd and bnd[0])
                log(f"redesigned time {name} width={key}: ms={ms:.5f} "
                    f"call_ms={cms:.5f} ns_per_elem={ms * 1e6 / elems:.3f}"
                    + (f" bound_ms={bnd[0]:.5f} ({bnd[1]}) x_bound="
                       f"{ms / bnd[0]:.2f}" if bnd else ""))
                del kern, plain
                torch.cuda.empty_cache()
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


def path_ranking(kernels: list) -> None:
    """What each kernel costs over the smoke's paths beyond its bound,
    largest first: its launches there times (device ms - bound ms) at its
    recorded width."""
    rows = sorted(((k["launches"] * (k["ms"] - k["bound_ms"]), k["name"],
                    k["launches"], k["ms"], k["bound_ms"]) for k in kernels
                   if k["launches"] and k["ms"] is not None), reverse=True)
    log("redesign ranking over the smoke's paths (launches x (device ms - "
        "bound ms)): " + "; ".join(
            f"{name} {n} x ({ms:.4f} - {b:.4f}) = {score:.2f} ms"
            for score, name, n, ms, b in rows))


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


def msm_case(log2n: int = 20, device: str = "cuda"):
    """Phase 3's case: the first 2^log2n points of the committed table on
    ``device``, seeded scalars, and the host golden (sum k_i tau^i) G:
    ((X, Y), scalars, golden affine point)."""
    import numpy as np
    import torch

    from aztec_tpu_torch.curves import golden
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs
    from aztec_tpu_torch.srs.reference_string import DEV_TAU, load_point_table

    n = 1 << log2n
    r = BN254_G1.order
    X, Y = (torch.as_tensor(p.astype(np.int32), device=device)
            for p in load_point_table(n))
    rnd = random.Random(SEED)
    ks = [rnd.randrange(r) for _ in range(n)]
    S = torch.as_tensor(ints_to_limbs(ks).astype(np.int32), device=device)
    kk, t = 0, 1
    for k in ks:
        kk = (kk + k * t) % r
        t = t * DEV_TAU % r
    expect = golden.GoldenCurve(BN254_G1).mul(kk, (BN254_G1.gen_x,
                                                   BN254_G1.gen_y))
    return (X, Y), S, expect


def check_msm(log2n: int = 20, device: str = "cuda"):
    """Phase 3: 2^20-point MSM of the committed table vs the host golden.
    Returns the case, for the engine's phase: ((X, Y), scalars, golden
    affine point)."""
    import torch

    from aztec_tpu_torch.curves.io import jacobian_to_host
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.msm.pippenger import msm

    n = 1 << log2n
    (X, Y), S, expect = msm_case(log2n, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    P = msm((X, Y), S, BN254_G1)
    sync()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    P = msm((X, Y), S, BN254_G1)
    sync()
    warm = time.perf_counter() - t0
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


def small_tier_breakdown(log2n: int = 11) -> dict:
    """Where a warm 2^11 small-tier MSM (phase 7's) goes: its unsynchronised
    wall; torch.profiler's device milliseconds by kernel group and the
    device's idle share over a second run; and a third run's wall seconds
    by stage, each stage's spans synchronised on both sides (so the stages
    and the rest sum to more than the first wall: the rest is the sort, the
    bucket fill by gathers and the torch glue between stages).  Its
    launches are not counted in any path.  Returns the numbers it prints."""
    import collections
    import re

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aztec_tpu_torch.curves.group_ops import JacobianOps
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.msm import pippenger
    from aztec_tpu_torch.msm.pippenger import MSMConfig, msm
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs
    from aztec_tpu_torch.srs.reference_string import load_point_table

    n = 1 << log2n
    X, Y = (torch.as_tensor(p.astype(np.int32), device="cuda")
            for p in load_point_table(n))
    rnd = random.Random(SEED + 2)
    S = torch.as_tensor(ints_to_limbs([rnd.randrange(BN254_G1.order)
                                       for _ in range(n)]).astype(np.int32),
                        device="cuda")
    cfg = MSMConfig(c=4, block=32, bucket_block=4, glv=True)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msm((X, Y), S, BN254_G1, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    wall = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = run()
    groups = collections.Counter()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        m = re.search(r"::(\w+)<", e.key)
        low = e.key.lower()
        groups[(m and SYMBOLS.get(m.group(1))) or (
            "sort" if ("sort" in low or "radix" in low)
            else "torch glue")] += us / 1e3
    busy = sum(groups.values())
    stages = collections.Counter()
    patched = [(JacobianOps, "rake_scan", "rake (K5)"),
               (pippenger, "_block_carries", "carries"),
               (JacobianOps, "j2c", "bucket phase"),
               (pippenger, "_bucket_phase", "bucket phase"),
               (JacobianOps, "c_dbl_n", "doublings"),
               (JacobianOps, "c2j", "finish"),
               (pippenger.glv_mod, "glv_table", "glv")]
    saved = [getattr(owner, attr) for owner, attr, _ in patched]

    def spanned(f, label):
        def g(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            torch.cuda.synchronize()
            stages[label] += time.perf_counter() - t0
            return out
        return g

    try:
        for (owner, attr, label), f in zip(patched, saved):
            setattr(owner, attr, spanned(f, label))
        spanned_wall = run()
    finally:
        for (owner, attr, _), f in zip(patched, saved):
            setattr(owner, attr, f)
    stages["sort, bucket fill and the rest"] = spanned_wall - sum(
        stages.values())
    out = {"wall_s": wall, "profiled_wall_s": prof_wall,
           "device_ms": dict(groups), "device_busy_ms": busy,
           "device_idle_share": 1 - busy / (prof_wall * 1e3),
           "spanned_wall_s": spanned_wall, "stages_s": dict(stages)}
    log(f"msm engine small tier 2^{log2n} breakdown: wall_s={wall:.4f}; "
        f"profiled wall_s={prof_wall:.4f}, device busy ms={busy:.3f}, idle "
        f"share {out['device_idle_share']:.3f}, device ms by group "
        + json.dumps({k: round(v, 4) for k, v in groups.most_common()})
        + f"; synchronised stages (wall_s={spanned_wall:.4f}) "
        + json.dumps({k: round(v, 5) for k, v in stages.most_common()}))
    return out


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


def profile_proof(c, make_prover=None):
    """One more warm proof (``make_prover()``, by default the composer's
    ``create_prover``) under torch.profiler: device time by kernel.
    Returns (the summed kernel milliseconds, {port kernel: device ms}),
    (0, {}) if the profiler saw none."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prover = (make_prover or c.create_prover)()
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
    # the glue the FFT's stage kernel removes: torch.cat's kernels and the
    # copies of .contiguous() / .expand(...).contiguous()
    for label, pat in (("cat", "CatArrayBatchedCopy"), ("copy", "copy_kernel")):
        hit = [r for r in rows if pat in r[1]]
        log(f"profile glue {label}: {sum(r[2] for r in hit)} launches, "
            f"{sum(r[0] for r in hit) / 1e3:.3f} ms")
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

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
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
    if device == "cuda":
        peak_memory(f"main path 2^{log2n}: the key and one proof", c)
    prover = c.create_prover()
    before, elems_before = dict(fk.LAUNCHES), dict(fk.ELEMS)
    t0 = time.perf_counter()
    proof2 = prover.construct_proof()
    sync()
    warm = time.perf_counter() - t0
    per_proof = {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()}
    elems = {k: v - elems_before.get(k, 0) for k, v in fk.ELEMS.items()}
    log(f"launches per proof: {json.dumps(per_proof, sort_keys=True)}")
    # the proof's bytes under a fixed blinding source: another commit's
    # smoke prints the same digest where its kernels compute the same bits
    prover = c.create_prover()
    prover.rng = counter_rng(SEED)
    log(f"main path 2^{log2n}: proof sha256 under the counter rng "
        f"{hashlib.sha256(prover.construct_proof()).hexdigest()}")
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


def peak_memory(label: str, c) -> None:
    """Print the device's peak allocated bytes since the last reset, and
    per point of the composer's subgroup."""
    import torch

    peak = torch.cuda.max_memory_allocated()
    n = c.subgroup_size()
    log(f"{label}: peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB), {peak / n:.0f} bytes a point of the "
        f"subgroup {n}")


def counter_rng(seed: int):
    """Deterministic blinding, so that proofs can be compared byte for byte."""
    from aztec_tpu_torch.ff.bn254 import FR_MOD

    state = [seed]

    def rng():
        state[0] += 1
        return (state[0] * 0x9E3779B97F4A7C15F39CC0605CEDC835) % FR_MOD
    return rng


def compare_msm_paths(c, reps: int = 3, device: str = "cuda") -> None:
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
    batched, tail_max = proving_key.commit_scalars, chunked.TAIL_MAX

    def one_at_a_time(srs, scalars):
        return [batched(srs, [s])[0] for s in scalars]

    variants = {"tail_batched": (tail_max, batched),
                "padded_batched": (0, batched),
                "tail_one_at_a_time": (tail_max, one_at_a_time),
                "padded_one_at_a_time": (0, one_at_a_time)}
    secs = {k: [] for k in variants}
    proofs = set()
    try:
        for _ in range(reps):
            for name, (tmax, commit) in variants.items():
                chunked.TAIL_MAX, proving_key.commit_scalars = tmax, commit
                prover = c.create_prover()
                prover.rng = counter_rng(SEED)
                sync()
                t0 = time.perf_counter()
                proofs.add(prover.construct_proof())
                sync()
                secs[name].append(time.perf_counter() - t0)
    finally:
        chunked.TAIL_MAX, proving_key.commit_scalars = tail_max, batched
    if len(proofs) != 1:
        raise AssertionError("the MSM paths give different proofs")
    log("msm paths, warm proof seconds (one rng, same bytes): "
        + json.dumps(secs))


def turbo_vectors(device: str = "cuda", names=TURBO_VECTORS) -> None:
    """Phase 5b, first: the committed small Turbo vectors (the JAX
    package's proofs under a counter rng, make_vectors.py) proved by the
    port on the card, keccak and unrolled: proof bytes and VK commitments
    equal, the port's verifier accepts.  Phase 5c runs it on
    ``join_split_d3``, whose record the port wrote on the card
    (make_vectors.py ``CARD_ONLY``; ``plonk_cases.load_vector`` refuses
    such a record for any other name).  The circuits come from
    tests/torch_vectors/ (make_vectors.py, plonk_cases.py), which import no
    JAX at import."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_vectors"))
    import make_vectors as mv
    import plonk_cases

    mod = plonk_cases.port_classes(device)
    composers = {}
    for name in names:
        rec, _ = plonk_cases.load_vector(name)
        producer = rec.get("producer", mv.REFERENCE)
        build, seed = mv.CIRCUITS[name]
        if build not in composers:      # one circuit, two flavors: one key
            composers[build] = build(mod)
        c = composers[build]
        prover = mv.make_prover(c, name)
        prover.rng = mv.counter_rng(seed)
        proof = prover.construct_proof()
        if proof.hex() != rec["proof"]:
            raise AssertionError(f"{name}: the proof differs from the "
                                 f"bytes of {producer}'s vector")
        vk = c.compute_verification_key()
        want = plonk_cases.vk_ints(rec)
        if vk.commitments != want:
            raise AssertionError(f"{name}: VK differs from the vector's")
        if not mv.make_verifier(c, name).verify_proof(proof):
            raise AssertionError(f"{name}: the port's verifier rejects it")
        log(f"vector {name}: n={vk.n} proof of {len(proof)} bytes and "
            f"{len(want)} VK commitments equal {producer}'s vector; "
            "verified")


def check_turbo_barrier(rate: float) -> None:
    """Phase 5b: K2 add_unsafe and proj_add_complete at the Turbo
    barrier's width (TURBO_BATCH MSMs x 8 GLV rounds = 32 rows x 2^16
    bucket lanes) and K3 at its chunk (32 rows x 4096 lanes, K = 64), each
    against its plain version, bit for bit; device ms printed."""
    import torch

    from aztec_tpu_torch.curves import group
    from aztec_tpu_torch.curves import group_kernels as gk
    from aztec_tpu_torch.curves.group_ops import JacobianOps
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.ff import FQ
    from aztec_tpu_torch.msm import rake
    from aztec_tpu_torch.tools import timing

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    b = BN254_G1.b
    rows = TURBO_BATCH * 128 // WINDOW
    wide = rows << WINDOW
    P, Q = (tuple(random_field(gen, (wide,), dev, zero_lanes=(i == 2))
                  for i in range(3)) for _ in range(2))
    B = rows * (2 << 17) // RAKE_K
    dig = torch.sort(torch.randint(0, 4, (RAKE_K, B), generator=gen,
                                   device=dev), dim=0).values
    Xa, Ya = (random_field(gen, (RAKE_K * B,), dev) for _ in range(2))
    packed = JacobianOps(BN254_G1, dev).pack_affine((Xa, Ya))
    for name, kern, plain, elems in (
        ("add_unsafe", lambda: gk.add_unsafe(P, Q, FQ),
         lambda: group.add_unsafe(P, Q, FQ), wide),
        ("proj_add_complete", lambda: gk.proj_add_complete(P, Q, FQ, b),
         lambda: group.proj_add_complete(P, Q, FQ, b), wide),
        ("rake_scan_packed",
         lambda: rake.rake_scan_packed(dig, packed, B, RAKE_K, FQ),
         lambda: rake.rake_scan_packed_plain(dig, packed, B, RAKE_K, FQ),
         B * RAKE_K),
    ):
        err = max_abs_err(kern(), plain())
        ms = timing.device_ms(kern)
        nbytes = (B * RAKE_K * (4 + 4 * PLANE_BYTES)
                  if name == "rake_scan_packed" else None)
        bnd, by = bound_ms(name, elems, rate, nbytes=nbytes)
        log(f"turbo barrier {name}: {rows} rows, {elems} elements "
            f"max_abs_err={err} ms={ms:.4f} bound_ms={bnd:.4f} ({by})")
        if err:
            raise AssertionError(f"{name} differs at the Turbo barrier")
        torch.cuda.empty_cache()


def build_turbo(log2n: int = 17, device: str = "cuda"):
    """aztec_tpu_torch/tools/turbo_circuit.py's circuit (a depth-32 Merkle
    path of in-circuit Pedersen compressions, range and logic constraints,
    bit extraction, a big mul gate, a mul chain) at 2^log2n gates."""
    import functools

    from aztec_tpu_torch.plonk.composer import MulTriple, TurboComposer
    from aztec_tpu_torch.stdlib import pedersen_circuit
    from aztec_tpu_torch.tools import turbo_circuit

    return turbo_circuit.build(functools.partial(TurboComposer, device=device),
                               pedersen_circuit, MulTriple, log2n=log2n)


def keyed_circuit(label: str, build, sync):
    """Build a Turbo circuit with ``build()`` (returning the composer),
    check it with ``check_turbo`` and key it; prints the set-up spans."""
    from aztec_tpu_torch.plonk import circuit_check

    spans = {}
    t0 = time.perf_counter()
    c = build()
    spans["circuit_s"] = time.perf_counter() - t0
    gates = c.n
    if c.failed:
        raise AssertionError(f"{label}: the circuit failed: {c.err}")
    t0 = time.perf_counter()
    bad = circuit_check.check_turbo(c)
    spans["check_s"] = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"{label}: {len(bad)} violated identities, "
                             f"first {bad[:5]}")
    t0 = time.perf_counter()
    c.compute_proving_key()
    sync()
    spans["key_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vk = c.compute_verification_key()
    spans["vk_s"] = time.perf_counter() - t0
    log(f"{label}: {gates} gates, subgroup {vk.n}, {vk.num_public_inputs} "
        f"public inputs, {len(vk.commitments)} VK commitments, check_turbo "
        "clean; set-up " + " ".join(f"{k}={v:.2f}" for k, v in spans.items()))
    return c


def prove(label: str, c, proofs: int, sync, flavor: str = "unrolled"):
    """``proofs`` proofs of the keyed composer ``c`` with the port's
    ``flavor`` prover ("keccak": ``create_prover``, "unrolled":
    ``create_unrolled_prover``), each verified by the matching port
    verifier, then a tamper of the last rejected; prints the cold and warm
    seconds and returns the launches of the last proof by kernel and the
    seconds of each proof, and the last proof."""
    from aztec_tpu_torch.ff import field_kernels as fk

    make_prover, verifier = (
        (c.create_prover, c.create_verifier()) if flavor == "keccak"
        else (c.create_unrolled_prover, c.create_unrolled_verifier()))
    secs = []
    for _ in range(proofs):
        prover = make_prover()
        before = dict(fk.LAUNCHES)
        sync()
        t0 = time.perf_counter()
        proof = prover.construct_proof()
        sync()
        secs.append(time.perf_counter() - t0)
        launches = {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()
                    if v - before.get(k, 0)}
        if not verifier.verify_proof(proof):
            raise AssertionError(f"{label} {flavor}: the port's verifier "
                                 "rejects the proof")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    if verifier.verify_proof(bytes(bad)):
        raise AssertionError(f"{label} {flavor}: a tampered proof verified")
    log(f"{label} {flavor}: {proofs} proofs of {len(proof)} bytes verify, "
        f"tamper rejected; prove_cold_s={secs[0]:.3f} prove_warm_s="
        f"{json.dumps([round(x, 4) for x in secs[1:]])}")
    log(f"{label} {flavor}: launches per proof {sum(launches.values())}: "
        f"{json.dumps(launches, sort_keys=True)}")
    return launches, secs, proof


def turbo_path(log2n: int = 17, device: str = "cuda"):
    """Phase 5b: the Turbo circuit at 2^log2n gates built, checked by
    ``circuit_check.check_turbo`` (no violated identity, every selector
    non-zero on some row), keyed, and proved 1 + TURBO_WARM times with
    ``create_prover`` (keccak) and with ``create_unrolled_prover``; every
    proof verified by the matching port verifier, a tampered one of each
    flavor rejected.  Returns {flavor: launches of its last warm proof}."""
    import torch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    label = f"turbo 2^{log2n}"
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    c = keyed_circuit(label, lambda: build_turbo(log2n, device), sync)
    used = {s: sum(1 for v in getattr(c, s) if v) for s in c.SELECTORS}
    if not all(used.values()):
        raise AssertionError(f"{label}: selectors never set: {used}")
    log(f"{label}: rows a selector is non-zero on: {json.dumps(used)}")
    launches = {}
    for flavor in ("keccak", "unrolled"):
        launches[flavor] = prove(label, c, 1 + TURBO_WARM, sync, flavor)[0]
        if device == "cuda" and flavor == "keccak":
            peak_memory(f"{label}: the key and {1 + TURBO_WARM} keccak "
                        "proofs", c)
    return launches


def turbo_profile(log2n: int = 17) -> int:
    """``--turbo-profile``, run by phase 5b in a process of its own (a
    profiled figure is taken in a fresh process: ROADMAP C5): the Turbo
    circuit keyed, one warm-up proof, one unprofiled warm proof (its wall
    seconds), then one under torch.profiler: kernels, kernel ms, the
    largest kernels, the idle share of the unprofiled proof."""
    import torch

    c = build_turbo(log2n)
    c.create_prover().construct_proof()
    prover = c.create_prover()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prover.construct_proof()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    busy_ms, by_name = profile_proof(c)
    log(f"turbo profile: unprofiled warm proof {warm:.3f} s, kernel time "
        f"{busy_ms:.1f} ms, device idle share {1 - busy_ms / (warm * 1e3):.3f}")
    log(json.dumps({"turbo_profile_ms_by_kernel": by_name}))
    return 0


def fresh_process(flag: str) -> list:
    """``python3 chip_smoke.py <flag>`` in a process of its own (the card's
    cache emptied first), its lines relayed; it fails the smoke if it
    fails.  Returns its output lines."""
    import subprocess

    import torch

    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                         capture_output=True, text=True, timeout=900)
    lines = out.stdout.splitlines()
    for line in lines:
        log(f"  {line}")
    if out.returncode != 0:
        raise AssertionError(f"{flag} failed ({out.returncode}): "
                             f"{out.stderr[-2000:]}")
    return lines


def profile_turbo_fresh() -> None:
    """Phase 5b, last: ``--turbo-profile`` in a process of its own."""
    fresh_process("--turbo-profile")


def join_split_tx(depth: int = JOIN_SPLIT_DEPTH):
    """A join-split tx at the production data-tree depth: two real input
    notes in a ``WorldState`` data tree (a ``SparseTree``), two output
    notes, a public output of 30 and a fee of 10, signed with the account
    key (nonce 0).  Host Python: the world state's Pedersen hashes, the
    note commitments and the Schnorr signature."""
    from aztec_tpu_torch.crypto import pedersen as pd
    from aztec_tpu_torch.rollup import notes_native as nn
    from aztec_tpu_torch.rollup.join_split import JoinSplitTx, sign_tx
    from aztec_tpu_torch.rollup.world_state import WorldState

    priv = 0x0B0B + 7
    pub = pd.fixed_base_scalar_mul_g1(priv, 254)
    ins = (nn.ValueNote(100, 1, 0, pub, 0xAAAA1),
           nn.ValueNote(50, 1, 0, pub, 0xAAAA2))
    outs = (nn.ValueNote(70, 1, 0, pub, 0xBBBB1),
            nn.ValueNote(40, 1, 0, pub, 0xBBBB2))
    ws = WorldState(data_depth=depth)
    for i, note in enumerate(ins):
        ws.insert_note(i, nn.encrypt_note(note))
    tree = ws.data_tree
    tx = JoinSplitTx(
        public_input=0, public_output=30, asset_id=1, num_input_notes=2,
        input_index=(0, 1), input_note=ins, output_note=outs,
        signing_pub_key=pub, signature=(bytes(32), bytes(32)),
        old_data_root=ws.data_root(),
        input_path=(tree.get_hash_path(0), tree.get_hash_path(1)),
        account_index=2, account_path=tree.get_hash_path(2),
        input_owner=0xAA, output_owner=0xBB, account_private_key=priv,
        alias_hash=0, nonce=0)
    tx.signature = sign_tx(tx, priv, k=0x1234567)
    return tx


def join_split_public_inputs(tx) -> list:
    """The 14 public inputs the tx computes natively, in the circuit's
    order (rollup/join_split.py ``join_split_circuit``)."""
    from aztec_tpu_torch.ff.bn254 import FR_MOD
    from aztec_tpu_torch.rollup import notes_native as nn

    nul = [nn.compute_nullifier(nn.encrypt_note(tx.input_note[i]),
                                tx.input_index[i], tx.account_private_key,
                                tx.num_input_notes > i) for i in range(2)]
    out = [nn.encrypt_note(n) for n in tx.output_note]
    fee = (sum(n.value for n in tx.input_note) + tx.public_input
           - sum(n.value for n in tx.output_note) - tx.public_output) % FR_MOD
    return [0, tx.public_input, tx.public_output, tx.asset_id,
            *out[0], *out[1], *nul, tx.input_owner, tx.output_owner,
            tx.old_data_root, fee]


def join_split_path(device: str = "cuda") -> dict:
    """Phase 5c: the depth-32 join-split (``join_split_tx``) built on the
    port's TurboComposer, its 14 public inputs held against the values the
    tx computes natively, checked, keyed, and proved 1 + JOIN_SPLIT_WARM
    times unrolled (each verified, a tamper rejected), then once more under
    torch.profiler (kernel time, and the idle share of the warm proofs'
    median).  Returns the launches of the last unprofiled proof by
    kernel."""
    import torch

    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.rollup.join_split import join_split_circuit

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    tx = join_split_tx()
    log(f"join-split depth {JOIN_SPLIT_DEPTH}: tx_s="
        f"{time.perf_counter() - t0:.2f} (world state, notes, signature)")

    def build():
        c = TurboComposer(device=device)
        join_split_circuit(c, tx)
        return c

    label = f"join-split depth {JOIN_SPLIT_DEPTH}"
    c = keyed_circuit(label, build, sync)
    public = [c.get_variable(i) for i in c.public_inputs]
    if public != join_split_public_inputs(tx):
        raise AssertionError(f"{label}: the public inputs differ from the "
                             "tx's native values")
    launches, secs, _ = prove(label, c, 1 + JOIN_SPLIT_WARM, sync)
    if device == "cuda":
        busy_ms, by_name = profile_proof(c, c.create_unrolled_prover)
        warm_ms = sorted(secs[1:])[len(secs[1:]) // 2] * 1e3
        log(f"{label}: kernel time {busy_ms:.1f} ms, device idle share "
            f"{1 - busy_ms / warm_ms:.3f} of the median warm proof "
            f"({warm_ms:.1f} ms); port kernels "
            + json.dumps({k: round(v, 3) for k, v in by_name.items()}))
    return launches


def account_path(device: str = "cuda") -> dict:
    """Phase 5c: the account circuit (rollup/circuit_data.py's tx, a
    nonce-0 registration signed by the account key) with its account path
    from a depth-JOIN_SPLIT_DEPTH ``WorldState`` data tree, checked, keyed,
    proved once unrolled and verified.  Returns the proof's launches."""
    import torch

    from aztec_tpu_torch.crypto import pedersen as pd
    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.rollup.account import (AccountTx, account_circuit,
                                                 sign_tx)
    from aztec_tpu_torch.rollup.world_state import WorldState

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    pub = pd.fixed_base_scalar_mul_g1(0x0B0B, 254)
    spend = pd.fixed_base_scalar_mul_g1(0x51, 254)
    tree = WorldState(data_depth=JOIN_SPLIT_DEPTH).data_tree
    tx = AccountTx(
        merkle_root=tree.root, account_public_key=pub,
        new_account_public_key=pub, new_signing_pub_key_1=spend,
        new_signing_pub_key_2=spend, alias_hash=0xA11A5, nonce=0,
        migrate=True, gibberish=0x61BB, account_index=0,
        account_path=tree.get_hash_path(0), signing_pub_key=spend,
        signature=(bytes(32), bytes(32)))
    tx.signature = sign_tx(tx, 0x0B0B, k=0xD00D)

    def build():
        c = TurboComposer(device=device)
        account_circuit(c, tx)
        return c

    label = f"account depth {JOIN_SPLIT_DEPTH}"
    return prove(label, keyed_circuit(label, build, sync), 1, sync)[0]


class WorkerProcess:
    """The port's proof worker as a child process (``python -u -m
    aztec_tpu_torch.serving.proof_worker``), its stderr in a file, killed
    by a watchdog if a request hangs."""

    def __init__(self, env: dict, err_path: str, timeout: float = 600):
        import subprocess
        import threading

        self.err = open(err_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-u", "-m",
             "aztec_tpu_torch.serving.proof_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.err,
            cwd=ROOT, env=env)
        self.watchdog = threading.Timer(timeout, self.proc.kill)
        self.watchdog.start()

    def request(self, frame: bytes):
        """(payload, ok, seconds) of one request frame."""
        import struct

        t0 = time.perf_counter()
        self.proc.stdin.write(frame)
        self.proc.stdin.flush()
        head = self.proc.stdout.read(4)
        if len(head) < 4:
            raise AssertionError("the worker closed its output")
        n = struct.unpack(">I", head)[0]
        body = self.proc.stdout.read(n + 1)
        if len(body) < n + 1:
            raise AssertionError("the worker closed its output mid-frame")
        return body[:n], body[n], time.perf_counter() - t0

    def close(self) -> int:
        if self.proc.poll() is None:
            self.proc.kill()
        rc = self.proc.wait()
        self.watchdog.cancel()
        self.err.close()
        return rc


def worker_imports(err_path: str) -> list:
    """The modules a child started with ``-X importtime`` imported, from
    its stderr."""
    names = []
    with open(err_path, errors="replace") as f:
        for line in f:
            if line.startswith("import time:") and "|" in line:
                names.append(line.rsplit("|", 1)[1].strip())
    return names


def worker_path(device: str = "cuda") -> None:
    """Phase 5c: the port's proof worker as a subprocess, its fixtures in a
    fresh temporary directory (so that 0x200 and 0x201 really prove): the
    ready byte; 0x101 and 0x100 at WORKER_GATES gates, each proof verified
    here; 0x202 before any tx-rollup proof failed; 0x200 and 0x201 (the
    join-split VK at 2^17 gates, the account VK; both unrolled Turbo) whose
    stored padding proofs verify against the VKs they answered; an id-0
    frame failed and the next request served; an unknown id failed and the
    worker exits 0.  Its imports (``-X importtime``) hold neither JAX nor
    the JAX package.  Then the HTTP server (``serving.http_server``) in
    this process, over its own worker: GET /status and POST /create-proof.
    The worker's launches are its own process's: none is counted here."""
    import shutil
    import struct
    import tempfile

    from aztec_tpu_torch.plonk.flavors import UnrolledTurboFlavor
    from aztec_tpu_torch.plonk.verifier import Verifier
    from aztec_tpu_torch.serving import proof_worker
    from aztec_tpu_torch.utils import fixtures

    tmp = tempfile.mkdtemp(prefix="smoke_fixtures_")
    env = dict(os.environ, AZTEC_FIXTURES=tmp, PYTHONPATH=ROOT)
    err_path = os.path.join(tmp, "worker_stderr.txt")
    demo = {0x100: "standard", 0x101: "turbo"}
    verifiers = {}

    def check_demo(pid, payload, ok):
        if pid not in verifiers:
            c = proof_worker._build_demo_circuit(demo[pid], WORKER_GATES,
                                                 device)
            verifiers[pid] = c.create_verifier()
        if ok != 1 or not verifiers[pid].verify_proof(payload):
            raise AssertionError(f"worker {pid:#x}: the proof does not "
                                 "verify")

    secs = {}
    saved = os.environ.get("AZTEC_FIXTURES")
    worker = WorkerProcess(env, err_path)
    try:
        t0 = time.perf_counter()
        if worker.proc.stdout.read(1) != b"\x01":
            raise AssertionError("the worker sent no ready byte")
        secs["ready"] = time.perf_counter() - t0
        for pid in (0x101, 0x100):
            payload, ok, secs[f"{pid:#x}"] = worker.request(
                struct.pack(">II", pid, WORKER_GATES))
            check_demo(pid, payload, ok)
        payload, ok, secs["0x202"] = worker.request(struct.pack(">I", 0x202))
        if payload or ok:
            raise AssertionError("0x202 before any tx-rollup proof answered")
        # the padding proofs the worker stored, read back from its fixtures
        os.environ["AZTEC_FIXTURES"] = tmp
        for pid, name, n in ((0x200, "join_split_circuit_data_d6", 1 << 17),
                             (0x201, "account_circuit_data", None)):
            payload, ok, secs[f"{pid:#x}"] = worker.request(
                struct.pack(">I", pid))
            if ok != 1:
                raise AssertionError(f"worker {pid:#x} failed")
            vk = fixtures.vk_from_json(payload.decode())
            if vk.settings.name != "unrolled_turbo" or (n and vk.n != n):
                raise AssertionError(f"worker {pid:#x}: VK n={vk.n} "
                                     f"settings {vk.settings.name}")

            def missing():
                raise AssertionError(f"worker {pid:#x} stored no fixture")

            proof, stored = fixtures.compute_or_load_proof_and_vk(
                name, missing, version="1")
            if fixtures.vk_to_json(stored) != payload.decode():
                raise AssertionError(f"worker {pid:#x}: stored VK differs")
            if not Verifier(vk, UnrolledTurboFlavor).verify_proof(proof):
                raise AssertionError(f"worker {pid:#x}: the padding proof "
                                     "does not verify against its VK")
            log(f"worker {pid:#x}: VK n={vk.n} {vk.num_public_inputs} "
                f"public inputs settings={vk.settings.name}; its stored "
                f"proof of {len(proof)} bytes verifies")
        payload, ok, secs["0x0"] = worker.request(
            struct.pack(">III", 0, 1, 3) + b"abc")
        if payload or ok:
            raise AssertionError("an id-0 frame was answered")
        payload, ok, secs["0x101_after_0x0"] = worker.request(
            struct.pack(">II", 0x101, WORKER_GATES))
        check_demo(0x101, payload, ok)
        payload, ok, secs["unknown"] = worker.request(
            struct.pack(">I", 0x999))
        if payload or ok:
            raise AssertionError("an unknown id was answered")
        rc = worker.proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"the worker exited {rc}")
    finally:
        worker.close()
        if saved is None:
            os.environ.pop("AZTEC_FIXTURES", None)
        else:
            os.environ["AZTEC_FIXTURES"] = saved
    imported = worker_imports(err_path)
    leaked = [m for m in imported if m.split(".")[0] in ("jax", "aztec_tpu")]
    # under -m the worker's own module runs as __main__; circuit_data is
    # imported by the 0x200 request, so the list covers the whole run
    if "aztec_tpu_torch.rollup.circuit_data" not in imported or leaked:
        raise AssertionError(f"worker imports: {len(imported)} read, "
                             f"JAX or the JAX package: {leaked[:5]}")
    with open(err_path, errors="replace") as f:
        for line in f:
            if not line.startswith("import time:"):
                log(f"  worker: {line.rstrip()}")
    log(f"worker: {len(imported)} modules imported, none of JAX or the JAX "
        f"package; exit 0 after the unknown id; request seconds "
        + json.dumps({k: round(v, 3) for k, v in secs.items()}))
    http_path(env, verifiers[0x101])
    shutil.rmtree(tmp, ignore_errors=True)


def quarter_plans(device: str = "cuda") -> None:
    """``--quarters``: the prover's two memory plans on one card.  The
    2^17 Turbo circuit (proved keccak and unrolled) and the 2^20 chain
    circuit (Standard) are keyed and proved under the counter rng once with
    the key's 4n coset forms and once by coset quarters
    (``proving_key.QUARTER_MIN_N`` lowered to 1); the bytes must agree.
    Prints each plan's key and proof seconds and its peak device
    memory."""
    import torch

    from aztec_tpu_torch.plonk import proving_key

    sync = torch.cuda.synchronize
    cases = (("turbo 2^17", lambda: build_turbo(17, device),
              ("keccak", "unrolled")),
             ("chain 2^20", lambda: build_chain(20, device), ("keccak",)))
    rule = proving_key.QUARTER_MIN_N
    try:
        for label, build, flavors in cases:
            digests = {}
            for plan, qmin in (("stored", rule), ("quarters", 1)):
                proving_key.QUARTER_MIN_N = qmin
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                c = build()
                t0 = time.perf_counter()
                pk = c.compute_proving_key()
                sync()
                spans = {"key_s": time.perf_counter() - t0}
                if pk.quarters != (plan == "quarters"):
                    raise AssertionError(f"{label}: not the {plan} plan")
                for flavor in flavors:
                    prover = (c.create_prover() if flavor == "keccak"
                              else c.create_unrolled_prover())
                    prover.rng = counter_rng(SEED)
                    t0 = time.perf_counter()
                    proof = prover.construct_proof()
                    sync()
                    spans[f"{flavor}_proof_s"] = time.perf_counter() - t0
                    digests.setdefault(flavor, set()).add(
                        hashlib.sha256(proof).hexdigest())
                log(f"{label} {plan}: "
                    + " ".join(f"{k}={v:.3f}" for k, v in spans.items()))
                peak_memory(f"{label} {plan}: the key and "
                            f"{len(flavors)} proofs", c)
                del c, pk, prover
            for flavor, d in digests.items():
                if len(d) != 1:
                    raise AssertionError(f"{label} {flavor}: the plans give "
                                         "different proofs")
                log(f"{label} {flavor}: both plans give the proof sha256 "
                    f"{d.pop()}")
    finally:
        proving_key.QUARTER_MIN_N = rule


def warm_proofs() -> dict:
    """``--warm-proofs``: each case keyed, proved once cold and WARM_REPS
    times warm (wall seconds, the device synchronised before and after),
    then once more with the device synchronised after every round (seconds
    by round), once under torch.profiler (kernel ms) and once under
    cProfile (the host functions with the most own time).  Uses only entry
    points an older checkout has too.  Returns {case and flavor: its
    numbers}."""
    import cProfile
    import pstats

    import torch

    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.rollup.join_split import join_split_circuit

    sync = torch.cuda.synchronize

    def join_split():
        c = TurboComposer(device="cuda")
        join_split_circuit(c, join_split_tx())
        return c

    cases = (
        ("standard_2pow17", lambda: build_chain(17), ("keccak",)),
        ("turbo_2pow17", lambda: build_turbo(17), ("keccak", "unrolled")),
        ("join_split_d32", join_split, ("unrolled",)),
        ("standard_2pow20", lambda: build_chain(20), ("keccak",)))
    rounds = ("preamble", "first", "second", "third", "fourth", "fifth",
              "sixth")
    out = {}
    for label, build, flavors in cases:
        c = build()
        t0 = time.perf_counter()
        c.compute_proving_key()
        sync()
        key_s = time.perf_counter() - t0
        for flavor in flavors:
            make = (c.create_prover if flavor == "keccak"
                    else c.create_unrolled_prover)
            secs = []
            for _ in range(1 + WARM_REPS):
                prover = make()
                sync()
                t0 = time.perf_counter()
                prover.construct_proof()
                sync()
                secs.append(time.perf_counter() - t0)
            prover = make()
            sync()
            by_round = {}
            for r in rounds:
                t0 = time.perf_counter()
                getattr(prover, f"execute_{r}_round")()
                prover.queue.process_queue()
                sync()
                by_round[r] = round(time.perf_counter() - t0, 4)
            busy_ms, _ = profile_proof(c, make)
            prover = make()
            sync()
            prof = cProfile.Profile()
            prof.enable()
            prover.construct_proof()
            sync()
            prof.disable()
            stats = pstats.Stats(prof)
            top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
            warm = sorted(secs[1:])
            out[f"{label}_{flavor}"] = {
                "key_s": round(key_s, 3), "cold_s": round(secs[0], 4),
                "warm_s": [round(x, 4) for x in secs[1:]],
                "warm_median_s": warm[len(warm) // 2],
                "kernel_ms": round(busy_ms, 2), "by_round_s": by_round,
                "host_top_tottime_s": [
                    [f"{os.path.basename(f)}:{line}:{fn}", nc, round(tt, 4)]
                    for (f, line, fn), (_, nc, tt, _, _) in top]}
            log(f"warm proofs {label} {flavor}: "
                + json.dumps(out[f"{label}_{flavor}"]))
        del c
        torch.cuda.empty_cache()
    return out


def rollup_stats(err_path: str) -> list:
    """The ``rollup_stats`` records a worker logged, in order."""
    out = []
    with open(err_path, errors="replace") as f:
        for line in f:
            if line.startswith("rollup_stats "):
                out.append(json.loads(line.split(" ", 1)[1]))
    return out


class TowerAdapter:
    """Phase 5d's ``ProofGenerator``: the ported sequencer's request frames
    go to the phase's ``WorkerProcess``.  After each id 0 it asks 0x202 and
    keeps the VK the worker answered; into each id-1 frame it writes that
    VK in place of the pipeline's ``inner_vk_json`` (``"{}"`` by default,
    which the port's worker cannot parse).  A failed request is recorded in
    ``errors`` before it raises: the coordinator catches every exception
    and replays on its next poll, and the phase stops at the first."""

    def __init__(self, worker: WorkerProcess):
        self.worker = worker
        self.vk_json = None
        self.proofs = {}
        self.secs = {}
        self.errors = []

    def _request(self, frame: bytes, name: str) -> bytes:
        try:
            payload, ok, secs = self.worker.request(frame)
        except Exception as e:
            self.errors.append(f"{name}: {e!r}")
            raise
        if ok != 1 or not payload:
            self.errors.append(f"{name}: the worker answered failed")
            raise RuntimeError(f"{name}: the worker answered failed")
        self.secs[name] = secs
        return payload

    def create_proof(self, frame: bytes) -> bytes:
        import struct

        proof_id = struct.unpack(">I", frame[:4])[0]
        if proof_id == 1:
            if self.vk_json is None:
                self.errors.append("id 1 before any id 0")
                raise RuntimeError("id 1 before any id 0")
            vlen = struct.unpack(">I", frame[12:16])[0]
            frame = (frame[:12] + struct.pack(">I", len(self.vk_json))
                     + self.vk_json + frame[16 + vlen:])
        proof = self._request(frame, hex(proof_id))
        self.proofs[proof_id] = proof
        if proof_id == 0:
            self.vk_json = self._request(struct.pack(">I", 0x202), "0x202")
        return proof

    def reset(self) -> None:
        pass


class ContractVerifier:
    """A chain's verifier over one VK: the bytecode that the port's
    ``contracts.evm_verifier.generate_verifier`` emits for it, run in the
    port's ``evm.EVM``, and the port's native verifier of ``flavor``.  A
    proof is accepted when both accept it.  Each call appends to ``runs``
    the EVM's verdict (True, False, or the revert or fault it raised), its
    gas and seconds, and the native verdict and seconds.  The native
    verifier alone
    folds a recursion output (``vk.contains_recursive_proof``) into its
    pairing: the bytecode, aztec_tpu's byte for byte, leaves it out."""

    def __init__(self, vk, flavor):
        from aztec_tpu_torch.contracts.evm_verifier import generate_verifier
        from aztec_tpu_torch.plonk.verifier import Verifier

        t0 = time.perf_counter()
        self.code = generate_verifier(vk)
        self.generate_s = time.perf_counter() - t0
        self.native = Verifier(vk, flavor)
        self.runs = []

    def __call__(self, proof: bytes) -> bool:
        from aztec_tpu_torch.evm.interpreter import EVM, EvmError, EvmRevert

        evm = EVM()
        t0 = time.perf_counter()
        try:
            verdict = int.from_bytes(evm.run(self.code, proof), "big") == 1
        except (EvmRevert, EvmError) as e:
            verdict = repr(e)[:80]
        evm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = self.native.verify_proof(proof)
        run = {"evm": verdict, "gas": evm.gas_used, "evm_s": evm_s,
               "native": native, "native_s": time.perf_counter() - t0}
        self.runs.append(run)
        return verdict is True and native

    def summary(self) -> str:
        return (f"bytecode {len(self.code)} bytes (generated in "
                f"{self.generate_s:.3f} s); runs " + json.dumps(
                    [{k: round(v, 3) if isinstance(v, float) else v
                      for k, v in r.items()} for r in self.runs]))


def sequencer_tower(worker, tx_frame: bytes, verify_tx, chain,
                    timeout: float = TOWER_TIMEOUT) -> dict:
    """Phase 5d's sequencer: the port's ``RollupPipeline`` (one tx an inner
    rollup, one inner proof a root rollup, ``WorldState(6, 16, 4)``) over a
    ``TowerAdapter`` of ``worker``, its tx receiver verifying with
    ``verify_tx``, publishing into ``chain`` (the port's
    ``contracts.RollupProcessor``), served by ``sequencer.server.
    make_handler`` on a free local port while the coordinator polls.  POSTs
    ``tx_frame`` to ``/tx`` (202) and ``/flush``, then polls ``/rollups``
    until the rollup is mined; a failed request, a ``WithdrawError`` event
    of the processor (a refused rollup: its verifier, its escrow or its
    roots) or a coordinator reset fails the phase at once, the processor's
    events printed.  Returns the adapter, the pipeline (stopped) and the
    operator's views: /tx's answer, /rollups, /status, /metrics and the
    seconds."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    from aztec_tpu_torch.sequencer.rollup_pipeline import (RollupPipeline,
                                                           SequencerConfig)
    from aztec_tpu_torch.sequencer.server import make_handler

    adapter = TowerAdapter(worker)
    pipeline = RollupPipeline(
        SequencerConfig(num_inner_rollup_txs=TOWER_TXS,
                        num_outer_rollup_proofs=1, data_tree_depth=6,
                        null_tree_depth=16, root_tree_depth=4),
        adapter, blockchain=chain, verify_tx_proof=verify_tx)
    coordinator = pipeline.coordinator
    resets = []
    reset = coordinator.reset

    def watched_reset():
        resets.append(time.perf_counter())   # the first: start()'s own
        reset()

    coordinator.reset = watched_reset
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pipeline))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()

    def ask(method: str, path: str, body: bytes = None):
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=60)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    out = {"adapter": adapter, "pipeline": pipeline}
    pipeline.start()
    try:
        t0 = time.perf_counter()
        code, body = ask("POST", "/tx", tx_frame)
        if code != 202:
            raise AssertionError(f"/tx answered {code}: {body!r}")
        out["tx"] = json.loads(body)
        out["tx_s"] = time.perf_counter() - t0
        code, body = ask("POST", "/flush", b"")
        if code != 200:
            raise AssertionError(f"/flush answered {code}: {body!r}")
        while True:
            refused = [e for e in chain.events if e[0] == "WithdrawError"]
            if adapter.errors or refused or len(resets) > 1:
                for event in chain.events:
                    log(f"  tower chain event: {event}")
                raise AssertionError(
                    f"the pipeline failed: requests {adapter.errors}, "
                    f"{len(refused)} rollups the chain refused, "
                    f"{len(resets) - 1} resets")
            code, body = ask("GET", "/rollups")
            rollups = json.loads(body)
            if code == 200 and rollups and rollups[0]["mined"] is not None:
                break
            if worker.proc.poll() is not None:
                raise AssertionError(f"the worker exited "
                                     f"{worker.proc.returncode}")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"no rollup mined in {timeout} s")
            time.sleep(1.0)
        out["mined_s"] = time.perf_counter() - t0
        out["rollups"] = rollups
        code, body = ask("GET", "/status")
        out["status"] = json.loads(body)
        code, body = ask("GET", "/metrics")
        out["metrics"] = body.decode()
    except BaseException:
        worker.proc.kill()   # a request in flight ends; stop() can join
        raise
    finally:
        pipeline.stop()
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    return out


def _histogram_sum(text: str, name: str) -> float:
    """A histogram's ``_sum`` in a Prometheus exposition."""
    for line in text.splitlines():
        if line.startswith(name + "_sum "):
            return float(line.split()[1])
    raise AssertionError(f"/metrics has no {name}_sum")


def tower_path(device: str = "cuda") -> dict:
    """Phase 5d: the rollup tower as an operator runs it.  A user's deposit
    (``TOWER_DEPOSIT``, fee ``TOWER_FEE``) built and proved on the card by
    the port's ``CoreSdk`` (``prover="circuit"``, data-tree depth 6, the
    unrolled Turbo join-split, 2^17), verified against the worker's
    join-split VK (``join_split_circuit_data(6)``, proved here into a fresh
    fixture directory) and a tamper rejected; the port's sequencer
    (``sequencer_tower``) admits it through ``/tx`` and its pipeline sends
    id 0 (the inner rollup, unrolled Turbo at 2^24, its in-circuit verifier
    over the SDK's proof), 0x202 and id 1 (the root rollup, Turbo with the
    Keccak transcript at 2^24) to the port's proof worker, a subprocess
    under ``-X importtime``; the chain is the port's ``RollupProcessor``,
    into which the user first escrows the deposit for the ``INPUT_OWNER``
    that the SDK's proof carries, and whose ``verify_proof`` is a
    ``ContractVerifier`` of the VK the worker wrote: the bytecode of the
    port's generator in the port's EVM and the port's native verifier, both
    accepting.  The processor's next id is 1, its data, null and root roots
    are the root proof's and the world state's, the escrow is spent, the
    fees are the SDK's fee, and its events hold the processed rollup.
    Then the user syncs from the processor: the SDK's data root equals the
    world state's, the balance is the deposit less the fee, and the root
    proof publishes that data root.  The inner proof verifies here against
    the VK 0x202 answered; the root proof verifies here again, its recursive
    accumulator folded into the pairing, and a tampered root is rejected.
    Prints /status, the /metrics seconds, the SDK proof's seconds and
    launches, each circuit's gates, subgroup, set-up and proof seconds,
    launches by kernel and the worker's peak device memory, and the
    proofs' sha256.  Returns the launches of this process (the SDK's and
    the padding proof) and of the worker's two requests by kernel."""
    import gc
    import hashlib
    import shutil
    import struct
    import tempfile

    import torch

    from aztec_tpu_torch.contracts import RollupProcessor, RollupProofData
    from aztec_tpu_torch.ff import field_kernels as fk
    from aztec_tpu_torch.plonk.flavors import TurboFlavor, UnrolledTurboFlavor
    from aztec_tpu_torch.plonk.verifier import Verifier
    from aztec_tpu_torch.rollup.circuit_data import join_split_circuit_data
    from aztec_tpu_torch.rollup.inner_proof_data import InnerProofFields
    from aztec_tpu_torch.sdk import CoreSdk
    from aztec_tpu_torch.utils import fixtures

    tmp = tempfile.mkdtemp(prefix="smoke_tower_")
    env = dict(os.environ, AZTEC_FIXTURES=tmp, PYTHONPATH=ROOT)
    err_path = os.path.join(tmp, "worker_stderr.txt")
    saved = os.environ.get("AZTEC_FIXTURES")
    os.environ["AZTEC_FIXTURES"] = tmp
    secs = {}
    try:
        t0 = time.perf_counter()
        cd = join_split_circuit_data(data_depth=6, device=device)
        secs["padding_proof"] = time.perf_counter() - t0
        # the user's wallet: a deposit proved on the card
        before = dict(fk.LAUNCHES)
        t0 = time.perf_counter()
        sdk = CoreSdk(data_tree_depth=6, prover="circuit", device=device,
                      randbytes=random.Random(SEED).randbytes)
        user = sdk.add_user(b"smoke user")
        req = sdk.create_join_split(user, public_input=TOWER_DEPOSIT,
                                    tx_fee=TOWER_FEE)
        torch.cuda.synchronize()
        secs["sdk_proof"] = time.perf_counter() - t0
        sdk_launches = {k: v - before.get(k, 0)
                        for k, v in fk.LAUNCHES.items()
                        if v != before.get(k, 0)}
        tx_verifier = Verifier(cd.vk, UnrolledTurboFlavor)
        if not tx_verifier.verify_proof(req.proof_data):
            raise AssertionError("the SDK's deposit proof does not verify "
                                 "against the worker's join-split VK")
        bad = bytearray(req.proof_data)
        bad[len(bad) // 2] ^= 1
        if tx_verifier.verify_proof(bytes(bad)):
            raise AssertionError("a tampered deposit proof verified")
        log(f"tower sdk: the deposit ({TOWER_DEPOSIT}, fee {TOWER_FEE}) "
            f"proved on the card in {secs['sdk_proof']:.2f} s cold "
            f"(circuit, key and proof; unrolled Turbo, data-tree depth 6), "
            f"{sum(sdk_launches.values())} launches: "
            + json.dumps(sdk_launches, sort_keys=True)
            + f"; verified against the worker's join-split VK, a tamper "
            f"rejected; sha256 "
            f"{hashlib.sha256(req.proof_data).hexdigest()} "
            f"({len(req.proof_data)} bytes)")
        # the worker's 2^24 keys need the card: this process's cached
        # blocks (the SDK's and padding proofs', earlier phases') go back
        gc.collect()
        torch.cuda.empty_cache()

        chain_verifiers = []

        def verify_root(proof: bytes) -> bool:
            """The chain's verifier: a ``ContractVerifier`` (the generated
            bytecode in the EVM, and the native Turbo verifier) of the
            root-rollup VK the worker wrote, loaded when it is called."""
            with open(os.path.join(fixtures.fixture_dir(),
                                   "root_rollup_vk.json")) as f:
                vk = fixtures.vk_from_json(f.read())
            chain_verifiers.append(ContractVerifier(vk, TurboFlavor))
            return chain_verifiers[-1](proof)

        F = InnerProofFields
        owner = format(int.from_bytes(
            req.proof_data[F.INPUT_OWNER * 32:(F.INPUT_OWNER + 1) * 32],
            "big"), "x")
        processor = RollupProcessor(verify_proof=verify_root)
        processor.deposit_pending_funds(0, TOWER_DEPOSIT, owner)

        worker = WorkerProcess(env, err_path, timeout=TOWER_TIMEOUT)
        try:
            t0 = time.perf_counter()
            if worker.proc.stdout.read(1) != b"\x01":
                raise AssertionError("the worker sent no ready byte")
            secs["ready"] = time.perf_counter() - t0
            run = sequencer_tower(
                worker, struct.pack(">I", len(req.proof_data))
                + req.proof_data + req.viewing_keys,
                tx_verifier.verify_proof, processor)
            worker.proc.stdin.close()
            rc = worker.proc.wait(timeout=60)
            if rc != 0:
                raise AssertionError(f"the worker exited {rc}")
        except BaseException:
            worker.close()
            with open(err_path, errors="replace") as f:
                tail = [line.rstrip() for line in f
                        if not line.startswith("import time:")][-40:]
            for line in tail:
                log(f"  tower worker: {line}")
            for contract in chain_verifiers:
                log(f"  tower chain verifier: {contract.summary()}")
            raise
        finally:
            worker.close()
        with open(os.path.join(fixtures.fixture_dir(),
                               "root_rollup_vk.json")) as f:
            root_vk = fixtures.vk_from_json(f.read())
    finally:
        if saved is None:
            os.environ.pop("AZTEC_FIXTURES", None)
        else:
            os.environ["AZTEC_FIXTURES"] = saved
    adapter, pipeline = run["adapter"], run["pipeline"]
    secs.update(adapter.secs)
    secs["tx_admitted"] = run["tx_s"]
    secs["mined"] = run["mined_s"]
    inner, root, vk_json = adapter.proofs[0], adapter.proofs[1], \
        adapter.vk_json
    log("tower sequencer /status: " + json.dumps(run["status"],
                                                 sort_keys=True))
    log("tower sequencer /metrics: " + json.dumps({
        name: _histogram_sum(run["metrics"], metric) for name, metric in (
            ("tx_rollup_seconds", "tx_rollup_duration_seconds"),
            ("root_rollup_seconds", "root_rollup_duration_seconds"),
            ("publish_seconds", "publish_duration_seconds"))}))
    log(f"tower sequencer: /tx answered 202 {run['tx']['txId']}, "
        f"/rollups {json.dumps(run['rollups'])}")
    blocks = processor.get_blocks(0)
    if ([b.rollup_id for b in blocks] != [0]
            or blocks[0].rollup_proof_data != root
            or blocks[0].tx_datas != [req.proof_data]):
        raise AssertionError("the chain does not hold the root proof over "
                             "the SDK's deposit as rollup 0")
    contract = chain_verifiers[-1]
    ws = pipeline.world_state
    published = RollupProofData(root)
    roots = {"processor": (processor.data_root, processor.null_root,
                           processor.root_root),
             "root proof": (published.new_data_root,
                            published.new_null_root,
                            published.new_root_root),
             "world state": (ws.data_root(), ws.null_tree.root,
                             ws.root_tree.root)}
    if (len(chain_verifiers) != 1 or processor.next_rollup_id != 1
            or len(set(roots.values())) != 1
            or processor.get_user_pending_deposit(0, owner) != 0
            or processor.total_fees[0] != TOWER_FEE
            or ("RollupProcessed", 0, *roots["processor"])
            not in processor.events):
        for event in processor.events:
            log(f"  tower chain event: {event}")
        raise AssertionError(
            f"the processor: {len(chain_verifiers)} verifications ("
            f"{contract.summary()}), next id {processor.next_rollup_id}, "
            f"roots {roots}, escrow "
            f"{processor.get_user_pending_deposit(0, owner)}, fees "
            f"{processor.total_fees}")
    log(f"tower chain: the port's RollupProcessor settled rollup 0; its "
        f"verifier, the generated EVM bytecode and the native Turbo "
        f"verifier, both accept the root proof: {contract.summary()}; "
        f"escrow of owner {owner} {TOWER_DEPOSIT} -> 0, fees "
        f"{processor.total_fees}, roots equal the root proof's and the "
        f"world state's; events "
        + json.dumps([e[0] for e in processor.events]))
    # the user syncs the settled block from the processor
    sdk.sync(processor)
    ws_root = ws.data_root()
    if sdk.data_tree.root != ws_root or published.new_data_root != ws_root:
        raise AssertionError(f"data roots: the SDK's {sdk.data_tree.root:x}, "
                             f"the world state's {ws_root:x}, the root "
                             f"proof's {published.new_data_root:x}")
    if user.balance() != TOWER_DEPOSIT - TOWER_FEE:
        raise AssertionError(f"the user's balance is {user.balance()}")
    log(f"tower sdk sync: data root {ws_root:#x} equals the world state's "
        f"and the root proof's; balance {user.balance()}")
    inner_vk = fixtures.vk_from_json(vk_json.decode())
    if (inner_vk.settings.name != "unrolled_turbo"
            or not inner_vk.contains_recursive_proof):
        raise AssertionError(f"0x202: settings {inner_vk.settings.name}, "
                             f"recursive {inner_vk.contains_recursive_proof}")
    if not Verifier(inner_vk, UnrolledTurboFlavor).verify_proof(inner):
        raise AssertionError("the inner rollup proof does not verify "
                             "against the VK 0x202 answered")
    if not root_vk.contains_recursive_proof:
        raise AssertionError("the root rollup's VK carries no recursive "
                             "proof")
    verifier = Verifier(root_vk, TurboFlavor)
    t0 = time.perf_counter()
    if not verifier.verify_proof(root):
        raise AssertionError("the root rollup proof does not verify here")
    secs["root_verify_here"] = time.perf_counter() - t0
    bad = bytearray(root)
    bad[len(bad) // 2] ^= 1
    if verifier.verify_proof(bytes(bad)):
        raise AssertionError("a tampered root rollup proof verified")
    imported = worker_imports(err_path)
    leaked = [m for m in imported if m.split(".")[0] in ("jax", "aztec_tpu")]
    if "aztec_tpu_torch.rollup.root_rollup_circuit" not in imported or leaked:
        raise AssertionError(f"tower worker imports: {len(imported)} read, "
                             f"JAX or the JAX package: {leaked[:5]}")
    stats = rollup_stats(err_path)
    if [r["circuit"] for r in stats] != ["tx_rollup", "root_rollup"]:
        raise AssertionError(f"tower worker logged {len(stats)} rollups")
    with open(err_path, errors="replace") as f:
        for line in f:
            if not line.startswith(("import time:", "rollup_stats ")):
                log(f"  tower worker: {line.rstrip()}")
    launches = dict(fk.LAUNCHES)
    for r in stats:
        log(f"tower {r['circuit']}: {r['gates']} gates, "
            f"{r['public_inputs']} public inputs, subgroup {r['subgroup']}; "
            + " ".join(f"{k}={r[k]:.2f}" for k in
                       ("build_s", "srs_s", "key_s", "vk_s", "witness_s",
                        "proof_s", "verify_s"))
            + f"; worker peak device memory {r['peak_bytes']} bytes "
            f"({r['peak_bytes'] / 2**30:.2f} GiB)")
        log(f"tower {r['circuit']}: proof launches "
            f"{sum(r['proof_launches'].values())}: "
            + json.dumps(r["proof_launches"], sort_keys=True))
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"tower: the worker's inner (unrolled Turbo) and root (Turbo, "
        f"Keccak) rollup proofs verify, the root here again with its "
        f"recursive accumulator folded, a tampered root rejected; inner "
        f"sha256 {hashlib.sha256(inner).hexdigest()} ({len(inner)} bytes), "
        f"root sha256 {hashlib.sha256(root).hexdigest()} ({len(root)} "
        f"bytes); {len(imported)} modules imported by the worker, none of "
        f"JAX or the JAX package; request seconds "
        + json.dumps({k: round(v, 3) for k, v in secs.items()}))
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- phase 5e: UltraPlonk --------------------------------------------------

def build_ultra(log2n: int = ULTRA_LOG2N, seed: int = ULTRA_SEEDS[0],
                device: str = "cuda"):
    """aztec_tpu_torch/tools/ultra_circuit.py's circuit at 2^log2n gates,
    with the table and lookup counts of ``ULTRA_SHAPES[log2n]``."""
    import functools

    from aztec_tpu_torch.plonk import lookup_tables
    from aztec_tpu_torch.plonk.composer import (AddTriple, MulTriple,
                                                UltraComposer)
    from aztec_tpu_torch.tools import ultra_circuit

    return ultra_circuit.build(
        functools.partial(UltraComposer, device=device), lookup_tables,
        MulTriple, AddTriple, log2n=log2n, seed=seed, **ULTRA_SHAPES[log2n])


def timed_proof(prover, sync):
    """``prover.construct_proof()`` round by round, synchronised after each
    round's work and its queue's drain: (proof, {round: seconds})."""
    spans = {}
    for rnd in (prover.execute_preamble_round, prover.execute_first_round,
                prover.execute_second_round, prover.execute_third_round,
                prover.execute_fourth_round, prover.execute_fifth_round,
                prover.execute_sixth_round):
        t0 = time.perf_counter()
        rnd()
        sync()
        t1 = time.perf_counter()
        prover.queue.process_queue()
        sync()
        name = rnd.__name__.replace("execute_", "").replace("_round", "")
        spans[name] = round(t1 - t0, 4)
        spans[f"{name}_msm"] = round(time.perf_counter() - t1, 4)
    return prover.transcript.export_transcript(), spans


def ultra_2pow20(device: str = "cuda", log2n: int = ULTRA_LOG2N) -> dict:
    """Phase 5e: tools/ultra_circuit.py's circuit at 2^log2n gates (lookups
    in a range, an XOR and an AND table) built, keyed, its VK computed, and
    proved once cold (Keccak; verified, a tamper rejected); then the same
    circuit with fresh witness values (another seed) keyed again and proved
    warm, verified against the first circuit's VK; then that warm proof
    once more under torch.profiler (kernel time and the device's idle
    share).  Prints each span, the second round's seconds (``after_eta``:
    the sorted list on the host, S_1 and S_2), the warm proof's launches by
    kernel and the peak device memory.  Returns the warm proof's
    launches."""
    import gc

    import torch

    from aztec_tpu_torch.ff import field_kernels as fk

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    label = f"ultra 2^{log2n}"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    spans = {}
    t0 = time.perf_counter()
    c = build_ultra(log2n, ULTRA_SEEDS[0], device)
    spans["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.compute_proving_key()
    sync()
    spans["key_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vk = c.compute_verification_key()
    spans["vk_s"] = time.perf_counter() - t0
    rows = sum(len(t.rows) for t in c.tables.values())
    log(f"{label}: {c.n} gates, subgroup {vk.n}, {len(c._lookups)} lookups, "
        f"{rows} table rows, {len(vk.commitments)} VK commitments; "
        + " ".join(f"{k}={v:.2f}" for k, v in spans.items()))
    verifier = c.create_verifier()
    t0 = time.perf_counter()
    proof, rounds = timed_proof(c.create_prover(), sync)
    cold = time.perf_counter() - t0
    if not verifier.verify_proof(proof):
        raise AssertionError(f"{label}: the port's verifier rejects it")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    if verifier.verify_proof(bytes(bad)):
        raise AssertionError(f"{label}: a tampered proof verified")
    log(f"{label}: cold proof of {len(proof)} bytes verifies, tamper "
        f"rejected; prove_cold_s={cold:.3f} after_eta_s={rounds['second']}"
        f" rounds {json.dumps(rounds)}")
    if cuda:
        peak_memory(f"{label}: the key, VK and a cold proof", c)
    del c
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    c = build_ultra(log2n, ULTRA_SEEDS[1], device)
    build2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.compute_proving_key()
    sync()
    key2 = time.perf_counter() - t0
    prover = c.create_prover()
    before = dict(fk.LAUNCHES)
    t0 = time.perf_counter()
    proof, rounds = timed_proof(prover, sync)
    warm = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()
                if v - before.get(k, 0)}
    del prover
    if not verifier.verify_proof(proof):
        raise AssertionError(f"{label}: the first circuit's VK rejects the "
                             "proof with fresh witnesses")
    log(f"{label}: fresh witnesses: build_s={build2:.2f} key_s={key2:.2f} "
        f"warm proof verifies against the first VK; prove_warm_s={warm:.3f}"
        f" after_eta_s={rounds['second']} rounds {json.dumps(rounds)}")
    log(f"{label}: launches per proof {sum(launches.values())}: "
        f"{json.dumps(launches, sort_keys=True)}")
    if cuda:
        peak_memory(f"{label}: both keys and proofs", c)
        busy_ms, by_name = profile_proof(c)
        log(f"{label}: kernel time {busy_ms:.1f} ms, device idle share "
            f"{1 - busy_ms / (warm * 1e3):.3f} of the warm proof; port "
            "kernels " + json.dumps({k: round(v, 3)
                                     for k, v in by_name.items()}))
    return launches


def ultra_bad_lookup(device: str = "cuda") -> None:
    """Phase 5e: an Ultra circuit with a lookup that no table holds: its
    proof raises ValueError (the sorted list cannot be built)."""
    from aztec_tpu_torch.plonk.composer import UltraComposer
    from aztec_tpu_torch.plonk.lookup_tables import range_table

    c = UltraComposer(device=device)
    c.add_lookup_table(range_table(3, index=1))
    c.create_lookup_gate(c.add_variable(11), c.zero_idx, c.zero_idx, 1)
    try:
        c.create_prover().construct_proof()
    except ValueError as e:
        log(f"ultra: a lookup outside every table raises ValueError ({e})")
        return
    raise AssertionError("ultra: a lookup outside every table was proved")


def unrolled_ultra(device: str = "cuda", log2n: int = ULTRA_UNROLLED_LOG2N):
    """Phase 5e: ``build_ultra`` at 2^log2n, proved with the unrolled
    (Pedersen-Blake2s) prover: the port's unrolled verifier accepts, its
    pairing inputs are not null, the Keccak verifier rejects the proof.
    Returns (composer, proof)."""
    import torch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    label = f"unrolled ultra 2^{log2n}"
    t0 = time.perf_counter()
    c = build_ultra(log2n, ULTRA_SEEDS[0], device)
    build = time.perf_counter() - t0
    c.compute_proving_key()
    sync()
    t0 = time.perf_counter()
    proof = c.create_unrolled_prover().construct_proof()
    sync()
    secs = time.perf_counter() - t0
    v = c.create_unrolled_verifier()
    if not v.verify_proof(proof):
        raise AssertionError(f"{label}: the unrolled verifier rejects it")
    if v.pairing_inputs(proof) is None:
        raise AssertionError(f"{label}: no pairing inputs")
    if c.create_verifier().verify_proof(proof):
        raise AssertionError(f"{label}: the Keccak verifier accepts it")
    log(f"{label}: {c.n} gates, subgroup {c.subgroup_size()}, build_s="
        f"{build:.2f}; proof of {len(proof)} bytes in {secs:.3f} s verifies "
        "unrolled with pairing inputs, the Keccak verifier rejects it")
    return c, proof


def ultra_phase(device: str = "cuda") -> dict:
    """Phase 5e (``--ultra``, and a process of its own in the whole smoke):
    the committed Ultra vectors proved byte for byte, then the 2^20 path
    and the 2^17 unrolled path, each with the launch counts cleared just
    before it and read just after, and the bad lookup.  Returns
    {"paths": {path: launches}, "per_proof": the 2^20 warm proof's}."""
    from aztec_tpu_torch.ff import field_kernels as fk

    turbo_vectors(device, ULTRA_VECTORS)
    paths = {}
    fk.LAUNCHES.clear()
    per_proof = ultra_2pow20(device, ULTRA_LOG2N)
    paths[f"proof_ultra_2pow{ULTRA_LOG2N}"] = dict(fk.LAUNCHES)
    fk.LAUNCHES.clear()
    unrolled_ultra(device, ULTRA_UNROLLED_LOG2N)
    paths[f"proof_unrolled_ultra_2pow{ULTRA_UNROLLED_LOG2N}"] = dict(
        fk.LAUNCHES)
    ultra_bad_lookup(device)
    return {"paths": paths, "per_proof": per_proof}


def ultra_fresh() -> dict:
    """Phase 5e in a process of its own (``--ultra``: a profiled figure is
    taken in a fresh process, ROADMAP C5; the 2^20 stored-path prover's
    memory is returned at its exit).  Returns its ``ultra_phase``
    record."""
    records = [json.loads(line)["ultra_phase"]
               for line in fresh_process("--ultra")
               if line.startswith('{"ultra_phase"')]
    if len(records) != 1:
        raise AssertionError("--ultra printed no ultra_phase record")
    for name, counts in records[0]["paths"].items():
        log(f"path {name} launches: {json.dumps(counts, sort_keys=True)}")
    return records[0]


def ultra_recursion(device: str = "cuda") -> None:
    """``--ultra-recursion``: the in-circuit verifier over the 2^17
    unrolled-Ultra proof (``unrolled_ultra``) on a TurboComposer: its P0/P1
    equal the port's native ``pairing_inputs``, ``check_turbo`` is clean;
    gates, subgroup and seconds printed."""
    import dataclasses

    from aztec_tpu_torch.plonk.circuit_check import check_turbo
    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.plonk.manifests import UNROLLED_ULTRA
    from aztec_tpu_torch.stdlib.recursion_verifier import verify_proof_circuit

    inner, proof = unrolled_ultra(device)
    want = inner.create_unrolled_verifier().pairing_inputs(proof)
    vk = dataclasses.replace(inner.compute_verification_key(),
                             settings=UNROLLED_ULTRA)
    del inner
    t0 = time.perf_counter()
    c = TurboComposer(device=device)
    out = verify_proof_circuit(c, proof, vk)
    build = time.perf_counter() - t0
    if c.failed:
        raise AssertionError(f"ultra recursion: the circuit failed: {c.err}")
    got = (out.P0.get_value(), out.P1.get_value())
    if got != tuple(want):
        raise AssertionError("ultra recursion: P0/P1 differ from the native "
                             "verifier's pairing inputs")
    t0 = time.perf_counter()
    bad = check_turbo(c)
    check = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"ultra recursion: {len(bad)} violated "
                             f"identities, first {bad[:5]}")
    log(f"ultra recursion: outer circuit over the unrolled-Ultra proof: "
        f"{c.n} gates, subgroup {c.subgroup_size()}, build_s={build:.1f}; "
        f"P0/P1 equal the native pairing inputs; check_turbo clean "
        f"({check:.1f} s)")


# -- phase 5f: the escape hatch ---------------------------------------------

def escape_hatch_path(device: str = "cuda") -> dict:
    """Phase 5f: the escape-hatch circuit at the production tree depths
    (``ESCAPE_DEPTHS``, rollup/constants.py; one tx with two real input
    notes, make_vectors.py's ``escape_hatch_tx``) built, its 26 public
    inputs counted, checked by ``check_turbo``, keyed and proved with the
    Keccak Turbo prover (verified, a tamper rejected); then the tx with a
    fee of one at depth 3 fails its constraints.  Returns the proof's
    launches by kernel."""
    import torch

    from aztec_tpu_torch.plonk import circuit_check
    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.rollup.escape_hatch import escape_hatch_circuit

    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_vectors"))
    import make_vectors as mv

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    label = "escape hatch depths " + "/".join(map(str, ESCAPE_DEPTHS))
    t0 = time.perf_counter()
    tx = mv.escape_hatch_tx("aztec_tpu_torch", *ESCAPE_DEPTHS)
    log(f"{label}: tx_s={time.perf_counter() - t0:.2f} (world state, notes, "
        "signature, nullifier and root-tree paths)")

    def build():
        c = TurboComposer(device=device)
        escape_hatch_circuit(c, tx)
        return c

    c = keyed_circuit(label, build, sync)
    if len(c.public_inputs) != 9 + 4 + 1 + 12:
        raise AssertionError(f"{label}: {len(c.public_inputs)} public "
                             "inputs, not 26")
    launches = prove(label, c, 1, sync, "keccak")[0]
    bad_tx = mv.escape_hatch_tx("aztec_tpu_torch", fee=1)
    bad = TurboComposer(device=device)
    escape_hatch_circuit(bad, bad_tx)
    if not (bad.failed or circuit_check.check_turbo(bad)):
        raise AssertionError("escape hatch: a non-zero fee passed")
    log(f"escape hatch: a fee of 1 fails its constraints ({bad.err})")
    return launches


# -- phase 5g: MiMC and the elliptic widget ---------------------------------

def mimc_path(device: str = "cuda", log2n: int = MIMC_LOG2N) -> None:
    """Phase 5g: MiMC7 hashes in MiMC gates on a ``MiMCComposer`` up to
    2^log2n gates, the last output public and equal to the native hash,
    checked by ``check_mimc``, keyed, and proved twice (Keccak), each
    verified, a tamper rejected."""
    import random as _random

    import torch

    from aztec_tpu_torch.ff.bn254 import FR_MOD
    from aztec_tpu_torch.plonk import circuit_check
    from aztec_tpu_torch.plonk.composer import MiMCComposer
    from aztec_tpu_torch.stdlib.field_t import FieldT
    from aztec_tpu_torch.stdlib.mimc_circuit import mimc7, mimc7_native

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    label = f"mimc 2^{log2n}"
    rng = _random.Random(SEED + 11)
    t0 = time.perf_counter()
    c = MiMCComposer(device=device)
    c.create_dummy_gates()
    hashes = 0
    while not hashes or c.n < (1 << log2n) - 1024:
        vals = [rng.randrange(FR_MOD) for _ in range(8)]
        out = mimc7(c, [FieldT.from_witness(c, v) for v in vals])
        hashes += 1
    out.set_public()
    build = time.perf_counter() - t0
    if out.get_value() != mimc7_native(vals):
        raise AssertionError(f"{label}: the hash differs from the native one")
    t0 = time.perf_counter()
    bad = circuit_check.check_mimc(c)
    check = time.perf_counter() - t0
    if bad or c.failed or c.subgroup_size() != 1 << log2n:
        raise AssertionError(f"{label}: {len(bad)} violated identities, "
                             f"subgroup {c.subgroup_size()}")
    t0 = time.perf_counter()
    c.compute_proving_key()
    sync()
    key = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.compute_verification_key()
    vk = time.perf_counter() - t0
    log(f"{label}: {hashes} MiMC7 hashes of 8 inputs, {c.n} gates, "
        f"{sum(c.q_mimc_selector)} MiMC gates, check_mimc clean; build_s="
        f"{build:.2f} check_s={check:.2f} key_s={key:.2f} vk_s={vk:.2f}")
    prove(label, c, 2, sync, "keccak")


def elliptic_check(rows: int = ELLIPTIC_ROWS) -> None:
    """Phase 5g: ``kernels.elliptic_identity`` over ``rows`` rows of seeded
    wires and selectors on the card (every field op a K1 launch) against
    its result on the CPU (the plain versions), bit for bit."""
    import torch

    from aztec_tpu_torch.plonk import kernels

    gen = torch.Generator()
    gen.manual_seed(SEED + 12)
    w = [random_field(gen, (rows,), "cpu") for _ in range(4)]
    q = [random_field(gen, (rows,), "cpu") for _ in range(4)]
    alphas = [random_field(gen, (1,), "cpu") for _ in range(2)]
    card = [x.cuda() for x in w + q + alphas]
    got = kernels.elliptic_identity(card[:4], *card[4:])
    torch.cuda.synchronize()
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        want = kernels.elliptic_identity(w, *q, *alphas)
    finally:
        torch.set_num_threads(threads)
    err = max_abs_err(got.cpu(), want)
    log(f"elliptic identity: {rows} rows on the card against the CPU's "
        f"plain versions, max_abs_err={err}")
    if err:
        raise AssertionError("elliptic_identity differs from its CPU result")


# -- phase 5h: from a Noir program to the contract ---------------------------

def contract_check(label: str, vk, proof: bytes, rng, mutations: int = 0,
                   digest_words: int = 0) -> None:
    """``proof`` through a ``ContractVerifier`` of ``vk`` (Turbo, Keccak):
    both verifiers accept it; then ``mutations`` seeded one-bit mutations
    (the first in one of the first ``digest_words`` public inputs, where
    there are any) refused by both.  Prints the bytecode, the gas and the
    EVM's and the native verifier's seconds."""
    from aztec_tpu_torch.plonk.flavors import TurboFlavor

    contract = ContractVerifier(vk, TurboFlavor)
    if not contract(proof):
        raise AssertionError(f"{label}: the contract refuses the proof: "
                             + contract.summary())
    for i in range(mutations):
        pos = (32 * rng.randrange(digest_words) + rng.randrange(32)
               if i == 0 and digest_words else rng.randrange(len(proof)))
        bad = bytearray(proof)
        bad[pos] ^= 1 << rng.randrange(8)
        contract(bytes(bad))
        if contract.runs[-1]["evm"] is True or contract.runs[-1]["native"]:
            raise AssertionError(f"{label}: a mutation at byte {pos} passed "
                                 + contract.summary())
    log(f"{label} contract: accepted by the generated EVM bytecode and the "
        f"native verifier, {mutations} one-bit mutations refused by both; "
        + contract.summary())


def noir_path(device: str = "cuda") -> dict:
    """Phase 5h (``--noir``): from a Noir program to the contract.  The
    port's ``noir.compile_program`` compiles aztec_tpu_torch/tools/
    noir_sha256.py's SHA-256 program over a ``NOIR_MESSAGE_BYTES``-byte
    message from the smoke's seed (16 blocks, 2^19) onto a
    ``TurboComposer`` on the card; the eight digest words are public
    inputs and equal hashlib's; ``check_turbo`` clean, keyed, VK, proved
    twice with the Keccak Turbo prover (cold, then warm), each verified by
    the native verifier, a tamper rejected; the proof accepted by the
    port's generated bytecode in the port's EVM and by the native
    verifier, ``NOIR_MUTATIONS`` mutations refused by both;
    ``write_verifier_sources`` writes the five Solidity files for the VK.
    Then the stdlib path at its own size: a ``NOIR_STDLIB_BYTES``-byte
    message packed 16 bytes to a field element (``PackedByteArray``),
    sliced back to range-checked bytes, hashed by ``sha256_bytes``, the
    digest packed into two public limbs equal to hashlib's (4 blocks,
    2^17), checked, keyed, proved once and accepted by both verifiers.
    Returns the warm 2^19 proof's launches by kernel."""
    import hashlib
    import shutil
    import tempfile

    import torch

    from aztec_tpu_torch import noir
    from aztec_tpu_torch.contracts.sol_verifier import write_verifier_sources
    from aztec_tpu_torch.plonk.composer import TurboComposer
    from aztec_tpu_torch.stdlib.packed_byte_array import PackedByteArray
    from aztec_tpu_torch.stdlib.sha256_circuit import sha256_bytes
    from aztec_tpu_torch.tools import noir_sha256

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    rng = random.Random(SEED + 13)
    msg = rng.randbytes(NOIR_MESSAGE_BYTES)
    blocks = noir_sha256.blocks_of(msg)
    label = f"noir sha256 {blocks} blocks"

    def build():
        c = TurboComposer(device=device)
        t0 = time.perf_counter()
        out = noir.compile_program(c, noir_sha256.source(blocks),
                                   [noir_sha256.pad(msg)])
        compile_s = time.perf_counter() - t0
        for word in out.result_vals:
            c.set_public_input(word.witness_index)
        if out.result != noir_sha256.digest_words(msg):
            raise AssertionError(f"{label}: digest {out.result} is not "
                                 "hashlib's")
        log(f"{label}: compiled in {compile_s:.2f} s; digest "
            f"{hashlib.sha256(msg).hexdigest()} equals hashlib's")
        return c

    c = keyed_circuit(label, build, sync)
    vk = c.compute_verification_key()
    if vk.n != 1 << NOIR_LOG2N or vk.num_public_inputs != 8:
        raise AssertionError(f"{label}: subgroup {vk.n}, "
                             f"{vk.num_public_inputs} public inputs")
    launches, _, proof = prove(label, c, 2, sync, "keccak")
    contract_check(label, vk, proof, rng, NOIR_MUTATIONS, digest_words=8)
    tmp = tempfile.mkdtemp(prefix="smoke_sol_")
    try:
        files = write_verifier_sources(tmp, vk, "NoirSha256")
        names = sorted(os.path.relpath(f, tmp) for f in files)
        if names != ["NoirSha256Verifier.sol", "cryptography/Bn254Crypto.sol",
                     "cryptography/TurboVerifier.sol",
                     "cryptography/Types.sol", "keys/NoirSha256Vk.sol"]:
            raise AssertionError(f"{label}: write_verifier_sources wrote "
                                 f"{names}")
        sizes = {n: os.path.getsize(os.path.join(tmp, n)) for n in names}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"{label}: write_verifier_sources wrote " + json.dumps(sizes))
    del c
    if device == "cuda":
        torch.cuda.empty_cache()

    small = rng.randbytes(NOIR_STDLIB_BYTES)
    slabel = f"packed sha256_bytes {NOIR_STDLIB_BYTES} bytes"

    def build_stdlib():
        c = TurboComposer(device=device)
        packed = PackedByteArray.from_bytes(c, small)
        byte_fs = packed.to_unverified_byte_slices(1)
        for f in byte_fs:
            c.create_range_constraint(f.witness_index, 8)
        out = PackedByteArray.from_field_slices(c, sha256_bytes(c, byte_fs),
                                                1)
        for limb in out.get_limbs():
            limb.set_public()
        if out.get_value() != hashlib.sha256(small).digest():
            raise AssertionError(f"{slabel}: the digest is not hashlib's")
        return c

    c = keyed_circuit(slabel, build_stdlib, sync)
    svk = c.compute_verification_key()
    if svk.n != 1 << NOIR_STDLIB_LOG2N:
        raise AssertionError(f"{slabel}: subgroup {svk.n}")
    _, _, sproof = prove(slabel, c, 1, sync, "keccak")
    contract_check(slabel, svk, sproof, rng)
    del c
    log(f"noir phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def http_path(env: dict, verifier) -> None:
    """The port's HTTP server in this process, over its own worker child:
    GET /status, then POST /create-proof of a WORKER_GATES-gate Turbo demo
    proof, verified here."""
    import http.client
    import struct
    import threading
    from http.server import ThreadingHTTPServer

    from aztec_tpu_torch.serving.http_server import WorkerClient, make_handler

    saved = dict(os.environ)
    os.environ.update(env)
    worker = WorkerClient()
    try:
        worker.start()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=600)
        conn.request("GET", "/status")
        r = conn.getresponse()
        status = json.loads(r.read())
        if r.status != 200 or status != {"ready": True}:
            raise AssertionError(f"GET /status: {r.status} {status}")
        t0 = time.perf_counter()
        conn.request("POST", "/create-proof",
                     body=struct.pack(">II", 0x101, WORKER_GATES))
        r = conn.getresponse()
        proof = r.read()
        secs = time.perf_counter() - t0
        if r.status != 200 or not verifier.verify_proof(proof):
            raise AssertionError(f"POST /create-proof: {r.status}, the proof "
                                 "does not verify")
        log(f"http: GET /status {status}; POST /create-proof 0x101 at "
            f"{WORKER_GATES} gates: {len(proof)} bytes in {secs:.3f} s, "
            "verified")
    finally:
        httpd.shutdown()
        httpd.server_close()
        worker.stop()


# -- phase 12: the host C++ core, the Pedersen lanes, the parallel layer ----

PARALLEL_LOG2N = 17        # the chain circuit proved through the MeshExecutor
PARALLEL_SHARDS = 4        # shards of the mesh proof, the engine MSM, the FFT
PEDERSEN_PAIRS = 1 << 16   # one level of a 2^17-leaf Merkle tree
PEDERSEN_SAMPLES = 256     # lanes held to the host hash
MSM_SHARDS = (1, 2, 4)     # the sharded 2^20 MSM (phase 3's case)
SHARDED_MSM_LOG2N = 20
SHARDED_ENGINE_LOG2N = 11  # shards of 2^9 points: the engine route
SHARDED_FFT_LOG2N = 20
MULTIHOST_N = 1 << 16
MULTIHOST_TIMEOUT = 300


def _sync(device: str):
    import torch

    return torch.cuda.synchronize if device == "cuda" else (lambda: None)


def _u64x4(vals):
    """Canonical ints -> (k, 4) uint64 little-endian words."""
    import numpy as np

    from aztec_tpu_torch.numeric.bigint import ints_to_limbs

    w = ints_to_limbs(vals).astype(np.uint64)
    return np.ascontiguousarray(
        (w[0::4] | (w[1::4] << np.uint64(16)) | (w[2::4] << np.uint64(32))
         | (w[3::4] << np.uint64(48))).T)


def host_core_check(c, build_s: float) -> None:
    """Phase 12a: the chain circuit replayed gate by gate into the host
    composer core (``cc_gate``): its sigma mappings and exported witness
    columns equal the port composer's (the external coset: 255 natively,
    4 in Python); then the C ABI against the port's crypto/ and hashlib."""
    import ctypes
    import hashlib

    import numpy as np

    from aztec_tpu_torch.crypto import pedersen as ped
    from aztec_tpu_torch.crypto import schnorr as sch
    from aztec_tpu_torch.crypto.keccak import keccak256
    from aztec_tpu_torch.ff import FR, limb
    from aztec_tpu_torch.host_native import cbind, load_composer_core

    if not np.array_equal(c.real_variables(), np.arange(len(c.variables))):
        raise AssertionError("the replay carries no copy merges, the "
                             "circuit has some")
    lib = load_composer_core()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    t0 = time.perf_counter()
    size = c.subgroup_size()
    values = _u64x4(c.variables)
    wires = np.ascontiguousarray(np.stack([c.w_l, c.w_r, c.w_o], axis=1)
                                 .astype(np.uint32))
    sels = np.ascontiguousarray(np.stack(
        [_u64x4(q) for q in (c.q_m, c.q_1, c.q_2, c.q_3, c.q_c)], axis=1))
    cc = lib.cc_new(5)
    try:
        base = values.ctypes.data
        for i in range(len(c.variables)):
            lib.cc_add_variable(cc, ctypes.cast(base + 32 * i, u64p))
        wb, sb = wires.ctypes.data, sels.ctypes.data
        for i in range(c.n):
            lib.cc_gate(cc, 3, ctypes.cast(wb + 12 * i, u32p),
                        ctypes.cast(sb + 160 * i, u64p))
        for p in c.public_inputs:
            lib.cc_set_public(cc, p)
        t_replay = time.perf_counter() - t0
        if (lib.cc_num_gates(cc), lib.cc_num_vars(cc),
                lib.cc_num_public(cc)) != (c.n, len(c.variables),
                                           len(c.public_inputs)):
            raise AssertionError("the composer core's counts differ")
        nr = np.zeros((3, size), np.int32)
        fa = np.zeros((3, size), np.uint8)
        lib.cc_sigma_mappings(
            cc, 3, size, nr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        py_next, py_factor = c.compute_sigma_mappings(size, 3)
        fa = fa.astype(np.int32)
        py_factor = np.asarray(py_factor)
        if not (np.array_equal(nr, np.asarray(py_next))
                and np.array_equal(np.where(fa == 255, -1, fa),
                                   np.where(py_factor == 4, -1, py_factor))):
            raise AssertionError("the composer core's sigma mappings differ")
        planes, _ = c.witness_planes(size, 3)
        for k in range(3):
            out = np.zeros((size, 4), np.uint64)
            lib.cc_export_witness(cc, k, size, out.ctypes.data_as(u64p))
            got = np.stack([(out[:, j // 4] >> np.uint64(16 * (j % 4)))
                            & np.uint64(0xFFFF) for j in range(16)])
            want = limb.from_mont(planes[f"w_{k + 1}"], FR).cpu().numpy()
            if not np.array_equal(got.astype(np.int64), want.astype(np.int64)):
                raise AssertionError(f"the composer core's w_{k + 1} differs")
    finally:
        lib.cc_free(cc)
    t_core = time.perf_counter() - t0

    rnd = random.Random(SEED + 11)
    for _ in range(3):
        a, b = rnd.randrange(ped.P), rnd.randrange(ped.P)
        if cbind.compress_fields(a, b) != ped.compress_native(a, b):
            raise AssertionError("C ABI compress differs")
    vals = [rnd.randrange(ped.P) for _ in range(4)]
    if (cbind.compress_many(vals, 0) != ped.compress_many(vals, 0)
            or cbind.commit(vals, 2) != ped.encrypt_native(vals, 2)
            or cbind.get_generator(5) != ped.get_generator(5)):
        raise AssertionError("C ABI Pedersen differs")
    for data in (b"", bytes(range(200)), b"aztec" * 31):
        if (cbind.blake2s(data) != hashlib.blake2s(data).digest()
                or cbind.keccak256(data) != keccak256(data)
                or cbind.buffer_to_field(data)
                != ped.compress_buffer_to_field(data)):
            raise AssertionError("C ABI hashes differ")
    priv, k = rnd.randrange(1, 1 << 250), rnd.randrange(1, 1 << 250)
    msg = b"phase 12 schnorr"
    pub = cbind.compute_public_key(priv)
    sig = cbind.construct_signature(msg, priv, k)
    if (pub != sch.derive_public_key(priv)
            or sig != sch.construct_signature(msg, priv, k=k)
            or not sch.verify_signature(msg, pub, sig)
            or not cbind.verify_signature(msg, pub, sig)
            or cbind.verify_signature(msg + b"!", pub, sig)):
        raise AssertionError("C ABI Schnorr differs")
    log(f"phase 12a host core: g++ build_s={build_s:.1f} (both libraries, "
        f"beside nvcc); the 2^{PARALLEL_LOG2N} chain circuit ({c.n} gates, "
        f"{len(c.variables)} variables) replayed in {t_replay:.2f}s, sigma "
        f"mappings and w_1..w_3 equal the composer's ({t_core:.2f}s in all); "
        "C ABI Pedersen, Blake2s, Keccak and Schnorr equal the port's crypto")


def pedersen_lanes_check(device: str = "cuda") -> dict:
    """Phase 12b: ``compress_batch`` over PEDERSEN_PAIRS pairs (one level
    of a 2^17-leaf tree), cold and warm; PEDERSEN_SAMPLES lanes, the zero
    lanes among them, against the port's host ``compress_native``.
    Returns the warm call's launches."""
    import numpy as np
    import torch

    from aztec_tpu_torch.crypto import pedersen as ped
    from aztec_tpu_torch.crypto.pedersen_device import compress_batch
    from aztec_tpu_torch.ff import field_kernels as fk
    from aztec_tpu_torch.numeric.bigint import ints_to_limbs, limbs_to_ints

    sync = _sync(device)
    H = PEDERSEN_PAIRS
    rnd = random.Random(SEED + 12)
    left = [rnd.randrange(ped.P) for _ in range(H)]
    right = [rnd.randrange(ped.P) for _ in range(H)]
    # zero on the left, on the right, on both; even values (the skew)
    left[0] = right[1] = left[2] = right[2] = 0
    left[3], right[3] = 2, 4
    L, R = (torch.as_tensor(ints_to_limbs(v).astype(np.int32), device=device)
            for v in (left, right))
    t0 = time.perf_counter()
    compress_batch(L, R, 0)
    sync()
    cold = time.perf_counter() - t0
    before = dict(fk.LAUNCHES)
    t0 = time.perf_counter()
    out = compress_batch(L, R, 0)
    sync()
    warm = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()
                if v - before.get(k, 0)}
    got = limbs_to_ints(out.cpu().numpy().astype(np.uint32))
    sample = sorted({0, 1, 2, 3} | set(rnd.sample(range(4, H),
                                                  PEDERSEN_SAMPLES - 4)))
    t0 = time.perf_counter()
    bad = [i for i in sample if got[i] != ped.compress_native(left[i],
                                                              right[i])]
    t_host = time.perf_counter() - t0
    if bad or got[2] != 0:
        raise AssertionError(f"Pedersen lanes {bad[:5]} differ from the host")
    log(f"phase 12b pedersen lanes: {H} compressions cold_s={cold:.3f} "
        f"warm_s={warm:.3f} hashes_per_s={2 * H / warm:.0f}; "
        f"{len(sample)} sampled lanes (zero and skew lanes among them) equal "
        f"the host's ({t_host:.2f}s on the host); warm launches "
        f"{sum(launches.values())}: {json.dumps(launches, sort_keys=True)}")
    return launches


def sharded_msm_check(device: str = "cuda") -> None:
    """Phase 12c: phase 3's 2^20-point MSM through ``sharded_msm`` over
    1, 2 and 4 shards of the card (the chunked route), each equal to the
    golden in affine."""
    from aztec_tpu_torch.curves.io import jacobian_to_host
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.parallel import Mesh, sharded_msm

    sync = _sync(device)
    (X, Y), S, expect = msm_case(SHARDED_MSM_LOG2N, device)
    secs = {}
    for D in MSM_SHARDS:
        mesh = Mesh.local(D, device)
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            P = sharded_msm(mesh, (X, Y), S, BN254_G1)
            sync()
            ts.append(round(time.perf_counter() - t0, 4))
        if jacobian_to_host(P, BN254_G1)[0] != expect:
            raise AssertionError(f"sharded 2^{SHARDED_MSM_LOG2N} MSM over "
                                 f"{D} shards differs from the golden")
        secs[D] = ts
    log(f"phase 12c sharded msm 2^{SHARDED_MSM_LOG2N} (chunked route): "
        "golden OK at every D; "
        f"seconds (cold, warm) by shards {json.dumps(secs)}")


def sharded_engine_check(device: str = "cuda") -> None:
    """Phase 12c, second part: 2^11 points over 4 shards of 2^9 (below the
    chunked route's 2^11: the engine on each shard, K5), equal to the
    single-device MSM and the golden."""
    from aztec_tpu_torch.curves.io import jacobian_to_host
    from aztec_tpu_torch.curves.spec import BN254_G1
    from aztec_tpu_torch.msm.pippenger import msm
    from aztec_tpu_torch.parallel import Mesh, sharded_msm

    sync = _sync(device)
    (X, Y), S, expect = msm_case(SHARDED_ENGINE_LOG2N, device)
    single = jacobian_to_host(msm((X, Y), S, BN254_G1), BN254_G1)[0]
    t0 = time.perf_counter()
    P = sharded_msm(Mesh.local(PARALLEL_SHARDS, device), (X, Y), S, BN254_G1)
    sync()
    secs = time.perf_counter() - t0
    if not jacobian_to_host(P, BN254_G1)[0] == single == expect:
        raise AssertionError("the sharded engine MSM differs")
    log(f"phase 12c sharded msm 2^{SHARDED_ENGINE_LOG2N} over "
        f"{PARALLEL_SHARDS} shards (engine route): equal to the "
        f"single-device MSM and the golden, {secs:.3f}s")


def sharded_fft_check(device: str = "cuda") -> None:
    """Phase 12d: the 2^20-point coset FFT over 4 shards equal, limb for
    limb in canonical form, to ``poly.fft.coset_fft``."""
    import torch

    from aztec_tpu_torch.ff import FR, limb
    from aztec_tpu_torch.parallel import Mesh
    from aztec_tpu_torch.parallel.sharded_fft import sharded_coset_fft
    from aztec_tpu_torch.poly import fft_ops as pfft
    from aztec_tpu_torch.poly.domain import EvaluationDomain

    sync = _sync(device)
    N = 1 << SHARDED_FFT_LOG2N
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 13)
    # canonical limbs: a top limb below p's (0x3064) keeps every value < p
    x = torch.randint(0, 1 << 16, (16, N), generator=gen, device=device,
                      dtype=torch.int32)
    x[15] = torch.randint(0, 0x3064, (N,), generator=gen, device=device,
                          dtype=torch.int32)
    x = limb.to_mont(x, FR)
    dom = EvaluationDomain(N, device)
    mesh = Mesh.local(PARALLEL_SHARDS, device)
    t0 = time.perf_counter()
    want = pfft.coset_fft(x, dom)
    sync()
    t_solo = time.perf_counter() - t0
    ts = []
    for _ in range(2):
        t0 = time.perf_counter()
        got = sharded_coset_fft(mesh, x, dom)
        sync()
        ts.append(round(time.perf_counter() - t0, 4))
    if not torch.equal(limb.from_mont(got, FR), limb.from_mont(want, FR)):
        raise AssertionError("the sharded coset FFT differs")
    log(f"phase 12d sharded coset fft 2^{SHARDED_FFT_LOG2N} over "
        f"{PARALLEL_SHARDS} shards: equal to coset_fft; single-device "
        f"{t_solo:.4f}s, sharded (cold, warm) {ts}")


def mesh_proof(c, inline: bytes, device: str = "cuda") -> dict:
    """Phase 12e, the slice's end-to-end path: the chain proof with
    ``prover.executor = MeshExecutor(Mesh.local(4))``, which has every
    coset FFT split into quarters (``splits_ffts``), under phase 4's
    counter rng, cold and warm: both equal ``inline`` byte for byte, the port's verifier
    accepts, a tamper fails.  Returns the warm proof's launches."""
    from aztec_tpu_torch.ff import field_kernels as fk
    from aztec_tpu_torch.parallel import Mesh
    from aztec_tpu_torch.plonk.work_queue import MeshExecutor

    sync = _sync(device)
    executor = MeshExecutor(Mesh.local(PARALLEL_SHARDS, device))
    secs, proofs = [], set()
    for _ in range(2):
        prover = c.create_prover()
        prover.rng = counter_rng(SEED)
        prover.executor = executor
        before = dict(fk.LAUNCHES)
        t0 = time.perf_counter()
        proofs.add(prover.construct_proof())
        sync()
        secs.append(round(time.perf_counter() - t0, 4))
    launches = {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()
                if v - before.get(k, 0)}
    if proofs != {inline}:
        raise AssertionError("the MeshExecutor proof differs from the inline "
                             "proof")
    verifier = c.create_verifier()
    bad = bytearray(inline)
    bad[len(bad) // 3] ^= 1
    if not verifier.verify_proof(inline) or verifier.verify_proof(bytes(bad)):
        raise AssertionError("the MeshExecutor proof does not verify")
    log(f"phase 12e proof 2^{PARALLEL_LOG2N} through MeshExecutor over "
        f"{PARALLEL_SHARDS} shards, coset FFTs in quarters: equal to the "
        f"inline proof byte for byte (sha256 "
        f"{hashlib.sha256(inline).hexdigest()[:16]}), verified, tamper "
        f"rejected; seconds (cold, warm) {secs}; warm launches "
        f"{sum(launches.values())}: {json.dumps(launches, sort_keys=True)}")
    return launches


def multihost_check(device: str = "cuda") -> None:
    """Phase 12f: ``multihost.launch`` with 2 processes of 2 shards each on
    the card over MULTIHOST_N committed points (the reference's engine
    config): process 0's result equals the single-device MSM and the
    golden; a failed launch fails the phase."""
    from aztec_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    if not multihost.launch(n=MULTIHOST_N, device=device,
                            timeout_s=MULTIHOST_TIMEOUT):
        raise AssertionError("the multihost run failed")
    log(f"phase 12f multihost: {multihost.N_PROCS} gloo processes x "
        f"{multihost.DEVS_PER_PROC} shards over {MULTIHOST_N} points, equal "
        f"to the single-device MSM and the golden, "
        f"{time.perf_counter() - t0:.1f}s (process start-up included)")


def parallel_phase(path, mesh_kernels, host_build_s: float,
                   device: str = "cuda") -> None:
    """Phase 12 (``--parallel`` alone): 12a-12f, each path through ``path``
    (launch counts cleared before it, read after)."""
    t_phase = time.perf_counter()
    sync = _sync(device)
    t0 = time.perf_counter()
    c = build_chain(PARALLEL_LOG2N, device)
    prover = c.create_prover()
    prover.rng = counter_rng(SEED)
    inline = prover.construct_proof()
    sync()
    log(f"phase 12: the 2^{PARALLEL_LOG2N} chain circuit built, keyed and "
        f"proved inline in {time.perf_counter() - t0:.2f}s")
    host_core_check(c, host_build_s)
    path("pedersen_lanes_2pow16", ["mont_mul", "add_mod", "sub_mod",
                                   "mont_pow"], pedersen_lanes_check, device)
    path("sharded_msm_2pow20", ["rake_scan_packed", "proj_add_complete",
                                "add_unsafe", "jacobian_to_proj",
                                "proj_to_jacobian", "proj_dbl_n"],
         sharded_msm_check, device)
    path(f"sharded_msm_engine_2pow{SHARDED_ENGINE_LOG2N}", ["rake_scan"],
         sharded_engine_check, device)
    path("sharded_fft_2pow20", ["butterfly", "mont_mul", "add_mod"],
         sharded_fft_check, device)
    path("proof_2pow17_mesh", mesh_kernels, mesh_proof, c, inline, device)
    multihost_check(device)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f}s")


def run(argv=()) -> int:
    """The smoke; with ``--redesigned``, only phase 2's checks of K1-K3 and
    the redesigned kernels' phase (registers, spills, SASS, edge lanes, the
    proof's widths), then the profiled warm 2^17 proof and its ranking, and
    last the lazy kernels on unreduced lanes: run beside another commit's
    package, it compares that commit's kernels on the same card."""
    redesigned_only = "--redesigned" in argv
    turbo_profile_only = "--turbo-profile" in argv
    quarters_only = "--quarters" in argv
    tower_only = "--tower" in argv
    warm_only = "--warm-proofs" in argv
    ultra_only = "--ultra" in argv
    ultra_recursion_only = "--ultra-recursion" in argv
    noir_only = "--noir" in argv
    parallel_only = "--parallel" in argv
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
    if turbo_profile_only:
        native.build()
        return turbo_profile()

    from aztec_tpu_torch.tools import timing

    # wall seconds of the default run's spans, each from the previous mark
    spans = {}
    clock = [time.perf_counter()]

    def span(name):
        now = time.perf_counter()
        spans[name] = round(now - clock[0], 1)
        clock[0] = now

    card = timing.card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from concurrent.futures import ThreadPoolExecutor

    from aztec_tpu_torch.host_native import build as host_build

    # the host C++ core's g++ builds run beside the nvcc builds
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(host_build.build_all)
        t_build = native.build()
        t_host = host.result()
    log(f"build: {t_build:.1f}s for {', '.join(native.SOURCES)}; g++ "
        f"{t_host:.1f}s for {', '.join(host_build.LIBRARIES)}")
    span("card, build")

    # each path runs with the counts set to 0 just before it and read just
    # after; the kernels line sums them
    pr1 = [k for k in KERNELS if k not in MICROBENCH
           and k not in ("rake_scan", "bucket_phase", "proj_dbl", "mul_add")]
    # the sharded MSMs pad to whole passes: no ragged tail to mix-add
    mesh_kernels = [k for k in pr1 if k != "mixed_add_unsafe"]
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

    if parallel_only:
        parallel_phase(path, mesh_kernels, t_host)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "aztec_tpu")]
        if leaked:
            raise AssertionError(f"the smoke imported {leaked[:5]}")
        log(card)
        return 0

    if warm_only:
        log(json.dumps({"warm_proofs": warm_proofs()}))
        log(card)
        return 0
    if quarters_only or tower_only or noir_only:
        if quarters_only:
            quarter_plans()
        if tower_only:
            fk.LAUNCHES.clear()
            log("path rollup_tower launches: "
                + json.dumps(tower_path(), sort_keys=True))
        if noir_only:
            fk.LAUNCHES.clear()
            noir_path()
            log("path proof_noir_sha256_2pow19 launches: "
                + json.dumps(dict(fk.LAUNCHES), sort_keys=True))
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "aztec_tpu")]
        if leaked:
            raise AssertionError(f"the smoke imported {leaked[:5]}")
        log(card)
        return 0
    if ultra_only or ultra_recursion_only:
        if ultra_only:
            record = ultra_phase()
        if ultra_recursion_only:
            ultra_recursion()
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "aztec_tpu")]
        if leaked:
            raise AssertionError(f"the smoke imported {leaked[:5]}")
        if ultra_only:
            log(json.dumps({"ultra_phase": record}))
        log(card)
        return 0

    rate = timing.peak_per_s(INT32_PER_CLOCK_PER_SM)
    log(f"int32 multiply-add peak (programming guide): {rate:.4g} per s")
    results = {}
    check_kernels(results, rate)
    check_redesigned_edges()
    resources = redesigned_resources()
    spills = resources.pop("spills")
    redesigned = {"resources": {repr(k): v for k, v in resources.items()},
                  "times": time_redesigned(rate)}
    # after the times, so that a spilling build still prints them
    if spills:
        raise AssertionError(f"{spills} spill")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    if redesigned_only:
        _, per_proof, cost = main_path()
        redesign_ranking(results, cost)
        log(json.dumps({"redesigned": redesigned,
                        "launches_per_2pow17_proof": per_proof,
                        "profiled_2pow17_ms": {k: v[2] for k, v in
                                               cost.items()}}))
        # last, so that an older commit's kernels print their times first
        failed = check_unreduced_lazy(gen, "cuda")
        if failed:
            log(f"kernels that differ from their plain versions on "
                f"unreduced lanes: {failed}")
            return 1
        log(card)
        return 0
    failed = check_unreduced_lazy(gen, "cuda")
    if failed:
        raise AssertionError(f"on unreduced lanes, {failed} differ from "
                             "their plain versions")
    check_new_kernels(results, rate)
    check_microbench(results)
    span("kernel checks")

    case = path("msm_chunked_2pow20", ["rake_scan_packed"], check_msm)
    c, per_proof, cost = path("proof_2pow17", pr1, main_path)
    compare_msm_paths(c)
    del c
    turbo_vectors()
    check_turbo_barrier(rate)
    turbo_launches = path("proof_turbo_2pow17",
                          [k for k in pr1 if k != "mixed_add_unsafe"],
                          turbo_path)
    profile_turbo_fresh()
    turbo_vectors(names=("join_split_d3",))
    turbo_kernels = [k for k in pr1 if k != "mixed_add_unsafe"]
    join_split_launches = path("proof_join_split_2pow17", turbo_kernels,
                               join_split_path)
    path("proof_account", turbo_kernels, account_path)
    span("2^17 Standard, Turbo, join-split, account")
    worker_path()
    span("worker, HTTP")
    # the tower's proofs run in the worker: it counts their launches
    fk.LAUNCHES.clear()
    paths["rollup_tower"] = tower_path()
    log("path rollup_tower launches: "
        + json.dumps(paths["rollup_tower"], sort_keys=True))
    missing = [k for k in turbo_kernels if not paths["rollup_tower"].get(k)]
    if missing:
        raise AssertionError(f"path rollup_tower never launched {missing}")
    span("rollup tower (5d)")
    # phase 5e runs in a process of its own, which counts its launches
    ultra = ultra_fresh()
    paths.update(ultra["paths"])
    for name in ultra["paths"]:
        missing = [k for k in turbo_kernels if not paths[name].get(k)]
        if missing:
            raise AssertionError(f"path {name} never launched {missing}")
    span("Ultra (5e)")
    escape_launches = path("proof_escape_hatch_prod", turbo_kernels,
                           escape_hatch_path)
    path("proof_mimc_2pow17", turbo_kernels, mimc_path)
    elliptic_check()
    span("escape hatch, MiMC, elliptic (5f, 5g)")
    noir_launches = path("proof_noir_sha256_2pow19", turbo_kernels, noir_path)
    span("Noir (5h)")
    path("msm_engine_2pow20", ["rake_scan_packed", "bucket_phase"],
         check_engine, case)
    del case
    path("msm_engine_2pow11", ["rake_scan"], check_small_tier)
    small_tier_breakdown()
    path("srs_fixed_base_2pow20", ["proj_dbl", "proj_add_complete"],
         check_fixed_base)
    path("proof_2pow20", pr1 + ["proj_dbl"], main_path, 20, "cuda", False)
    path("microbench", MICROBENCH, microbench_path, results)
    span("engine, small tier, SRS, 2^20 proof, microbenchmarks")
    parallel_phase(path, mesh_kernels, t_host)
    span("parallel (12)")
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
            "launches_per_2pow17_turbo_proof": {
                flavor: counts.get(name, 0)
                for flavor, counts in turbo_launches.items()},
            "launches_per_join_split_proof": join_split_launches.get(name, 0),
            "launches_per_ultra_2pow20_proof": ultra["per_proof"].get(name, 0),
            "launches_per_escape_hatch_proof": escape_launches.get(name, 0),
            "launches_per_noir_2pow19_proof": noir_launches.get(name, 0),
            "launches_parallel": sum(paths[p].get(name, 0) for p in (
                "pedersen_lanes_2pow16", "proof_2pow17_mesh")),
        })
        floor = redesigned["times"].get("chain_floor_ms", {}).get(name)
        if floor is not None:
            kernels[-1]["chain_floor_ms"] = floor
        if name in redesigned["times"]:
            times = redesigned["times"][name].items()
            kernels[-1]["ms_at_widths"] = {w: t[0] for w, t in times}
            if any(t[2] for _, t in times):
                kernels[-1]["bound_ms_at_widths"] = {w: t[2] for w, t in
                                                     times}
    missing = [k["name"] for k in kernels
               if k["launches"] == 0 and k["name"] not in NO_PATH]
    path_ranking(kernels)
    span("rankings")
    log(f"spans, wall seconds: {json.dumps(spans)}; "
        f"total {round(sum(spans.values()), 1)}")
    log(json.dumps({"kernels": kernels}))
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "aztec_tpu")]
    if leaked:
        raise AssertionError(f"the smoke imported {leaked[:5]}")
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
