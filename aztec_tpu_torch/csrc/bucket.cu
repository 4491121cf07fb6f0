// K4: the bucket phase of the Pippenger MSM engine,
//   W = sum_{j >= 1} j * B_j  over nbuckets Jacobian buckets, and
//   acc' = 2^dbl_steps * acc + W  in complete projective form.
//
// Replaces `_bucket_call` / `bucket_phase` of aztec_tpu/msm/bucket_pallas.py.
// Both compute the suffix-sum identity over the reversed bucket stream
// r_s = B_{nbuckets-1-s}, cut into LANES lanes of K2 = nbuckets / LANES
// consecutive entries (lane l holds r_{l K2} .. r_{l K2 + K2 - 1}):
//
//   W + T = sum_s (prefix sum of r up to s)
//         = sum_l lanesum_l + K2 * sum_l carry_l
//
// where lanesum_l is the sum of the lane's own running sums, carry_l the
// sum of the totals of the lanes before l and T the grand total.  The TPU
// kernel writes sum_l carry_l as F(tot) - T.
//
// How it maps onto the card.  The TPU grid walks the K2 steps in order and
// keeps each lane's running sum and sum of running sums in VMEM across
// steps, then combines the 1024 lanes of one (8, 128) tile with roll-based
// scans and butterflies.  Blocks on the card run in no order and carry
// nothing between them, so the work is two launches on one stream:
//
//   1. bucket_lanes_kernel: one thread per lane (LANES = 1024 lanes, the
//      TPU's split, in blocks of 128 threads), K2 steps in registers:
//      run += j2c(r), lanesum += run.  Writes (run, lanesum) per lane.
//   2. bucket_combine_kernel: one block of GROUPS = 32 threads.  Thread g
//      walks lanes g S .. g S + S - 1 (S = LANES / GROUPS) and sums their
//      carries within the group (C), their totals (run) and their lane
//      sums (A); thread 0 then walks the 32 groups the same way (CG: the
//      sum of the group carries, RG: the grand total T, CS, AS) and forms
//        W = AS + K2 * (CS + S * CG) - T,  acc' = 2^dbl_steps acc + W
//      with doublings for the multiplications by the powers of two S, K2
//      and 2^dbl_steps.
// The plain version (msm/bucket.py `bucket_phase_plain`) performs the same
// complete additions in the same order, so the projective result is
// bit-identical; it differs from the TPU kernel's (and the plain engine
// composition's) representative, so those compare in affine.
//
// Bound on an H100: one j2c (3 products) and two complete adds (14 products
// each) per bucket; at nbuckets = 2^16 that is ~2e6 Montgomery products,
// ~0.03 ms at the int32 multiply-add rate, against ~0.004 ms for the
// 12.6 MB of buckets.  This simple design is far from it: phase 1 runs 1024
// threads on 8 of the 132 SMs, each doing 2 K2 dependent complete adds,
// and phase 2 is one block with a serial tail of ~4 * 32 + 4 * 32 adds.
// A lane count that fills 132 SMs (and a wider, tree-shaped combine) is
// left to a later change.
#include "group.cuh"

using namespace aztec;

namespace {

constexpr int LANES = 1024;
constexpr int LANE_THREADS = 128;
constexpr int GROUPS = 32;
constexpr int S = LANES / GROUPS;   // lanes per group
constexpr int LOG2_S = 5;

// Out-of-line complete add and doubling: the combine makes ~10 calls of
// each, and inlining every one (as group.cuh's __forceinline__ formulas
// would) made a kernel of ~50k instructions that took ptxas minutes to
// build and spilled at 255 registers.  One call costs a few instructions
// against the ~4,000 of the add.
template <class F>
__device__ __noinline__ Pt padd(const Pt& P, const Pt& Q, const Elem& b3) {
  return proj_add<F>(P, Q, b3);
}

// `steps` doublings; nine: b3 is 9 (BN254 G1), computed by additions
template <class F>
__device__ __noinline__ Pt pdbl(const Pt& P, const Elem& b3, bool nine,
                                int steps) {
  return nine ? proj_dbl<F, true>(P, b3, steps)
              : proj_dbl<F, false>(P, b3, steps);
}

template <class F>
__global__ void bucket_lanes_kernel(const u32* __restrict__ bx,
                                    const u32* __restrict__ by,
                                    const u32* __restrict__ bz,
                                    u32* __restrict__ scratch, Const256 b3c,
                                    int K2) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= LANES) return;
  const long long nb = (long long)LANES * K2;
  const Elem b3 = from_const(b3c);
  Pt run = proj_infinity<F>(), ls = proj_infinity<F>();
  for (int k = 0; k < K2; ++k) {
    const long long j = nb - 1 - ((long long)l * K2 + k);
    Pt blk = j2c<F>(load_pt(bx, by, bz, nb, j));
    run = padd<F>(run, blk, b3);
    ls = padd<F>(ls, run, b3);
  }
  const long long P = (long long)16 * LANES;  // one (16, LANES) plane
  store_pt(scratch, scratch + P, scratch + 2 * P, LANES, l, run);
  store_pt(scratch + 3 * P, scratch + 4 * P, scratch + 5 * P, LANES, l, ls);
}

template <class F>
__global__ void bucket_combine_kernel(const u32* __restrict__ scratch,
                                      const u32* __restrict__ ax,
                                      const u32* __restrict__ ay,
                                      const u32* __restrict__ az,
                                      u32* __restrict__ ox, u32* __restrict__ oy,
                                      u32* __restrict__ oz, Const256 b3c,
                                      bool nine, int log2_k2, int dbl_steps) {
  __shared__ Pt part[3][GROUPS];
  const int g = threadIdx.x;
  const Elem b3 = from_const(b3c);
  const long long P = (long long)16 * LANES;
  Pt C = proj_infinity<F>(), run = proj_infinity<F>(), A = proj_infinity<F>();
  for (int i = 0; i < S; ++i) {
    const long long l = (long long)g * S + i;
    Pt tot = load_pt(scratch, scratch + P, scratch + 2 * P, LANES, l);
    Pt ls = load_pt(scratch + 3 * P, scratch + 4 * P, scratch + 5 * P, LANES,
                    l);
    C = padd<F>(C, run, b3);
    run = padd<F>(run, tot, b3);
    A = padd<F>(A, ls, b3);
  }
  part[0][g] = run;
  part[1][g] = C;
  part[2][g] = A;
  __syncthreads();
  if (g != 0) return;
  Pt CG = proj_infinity<F>(), RG = proj_infinity<F>();
  Pt CS = proj_infinity<F>(), AS = proj_infinity<F>();
  for (int h = 0; h < GROUPS; ++h) {
    CG = padd<F>(CG, RG, b3);
    RG = padd<F>(RG, part[0][h], b3);
    CS = padd<F>(CS, part[1][h], b3);
    AS = padd<F>(AS, part[2][h], b3);
  }
  CG = pdbl<F>(CG, b3, nine, LOG2_S);
  Pt D = pdbl<F>(padd<F>(CS, CG, b3), b3, nine, log2_k2);
  Pt W = padd<F>(padd<F>(AS, D, b3), proj_neg<F>(RG), b3);
  Pt acc = load_pt(ax, ay, az, 1, 0);
  acc = pdbl<F>(acc, b3, nine, dbl_steps);
  store_pt(ox, oy, oz, 1, 0, padd<F>(acc, W, b3));
}

template <class F>
int launch(const u32* bx, const u32* by, const u32* bz, const u32* ax,
           const u32* ay, const u32* az, u32* scratch, u32* ox, u32* oy,
           u32* oz, Const256 b3, int K2, int log2_k2, int dbl_steps,
           cudaStream_t s) {
  bucket_lanes_kernel<F><<<LANES / LANE_THREADS, LANE_THREADS, 0, s>>>(
      bx, by, bz, scratch, b3, K2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bucket_combine_kernel<F><<<1, GROUPS, 0, s>>>(
      scratch, ax, ay, az, ox, oy, oz, b3, is_nine<F>(b3), log2_k2, dbl_steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// buckets (16, 1024 * K2) Jacobian planes, acc (16, 1) projective planes,
// scratch 6 x (16, 1024) words, out (16, 1) projective planes; K2 a power
// of two; b3: host pointer to the 8 32-bit limbs of 3b in Montgomery form
int bk_bucket_phase(int field, const u32* bx, const u32* by, const u32* bz,
                    const u32* ax, const u32* ay, const u32* az, u32* scratch,
                    u32* ox, u32* oy, u32* oz, const u32* b3, int K2,
                    int dbl_steps, void* stream) {
  if (K2 < 1 || (K2 & (K2 - 1)) != 0 || dbl_steps < 0)
    return (int)cudaErrorInvalidValue;
  int log2_k2 = 0;
  while ((1 << log2_k2) < K2) ++log2_k2;
  Const256 c = const_from_host(b3);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    return launch<Fr>(bx, by, bz, ax, ay, az, scratch, ox, oy, oz, c, K2,
                      log2_k2, dbl_steps, s);
  if (field == 1)
    return launch<Fq>(bx, by, bz, ax, ay, az, scratch, ox, oy, oz, c, K2,
                      log2_k2, dbl_steps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
