// K4: the bucket phase of the Pippenger MSM engine,
//   W = sum_{j >= 1} j * B_j  over nbuckets Jacobian buckets, and
//   acc' = 2^dbl_steps * acc + W  in complete projective form.
//
// Replaces `_bucket_call` / `bucket_phase` of aztec_tpu/msm/bucket_pallas.py.
// Both compute the suffix-sum identity over the reversed bucket stream
// r_s = B_{nbuckets-1-s}: with P_s = r_0 + ... + r_s its prefix sums and T
// the grand total,
//
//   W = sum_s P_s - T.
//
// The TPU kernel walks 1024 lanes of consecutive entries in grid order and
// combines them in one (8, 128) tile.  Here the stream is cut into LANES
// lanes of K2 consecutive entries (host `geometry`: K2 = 4 up to 2^16
// buckets, 16,384 lanes there), and sum_s P_s is assembled level by level
// from segments: a segment of `len` entries carries its total t and its
// own prefix-sum sum s (the prefix sums restarted at the segment's start).
// m segments in order combine into one of m * len entries by
//
//   t = sum_i t_i,   s = sum_i s_i + len * sum_i C_i,
//
// where C_i = t_0 + ... + t_{i-1} is segment i's carry.  One block of m
// threads does that in log depth (`block_combine`): a Hillis-Steele scan of
// the t_i through shared memory gives the carries, a tree sums the s_i and
// the C_i together (one complete add a thread a level), and thread 0 forms
// s with log2(len) doublings.  Two launches:
//
//   1. bucket_lanes_kernel, one thread a lane in blocks of BK_THREADS: the
//      lane's K2 steps in registers (run += j2c(r), ls += run: t and s of
//      the lane), then the block's lanes combined (len = K2); one (t, s) a
//      block.  One more block doubles acc dbl_steps times meanwhile.
//   2. bucket_final_kernel, one block of one thread a lane block: the block
//      segments combined (len = K2 * BK_THREADS), then W = s - T and
//      acc' = 2^dbl_steps acc + W.
//
// The plain version (msm/bucket.py `bucket_phase_plain`) performs the same
// complete additions and doublings in the same order, so the projective
// result is bit-identical; it differs from the TPU kernel's (and the plain
// engine composition's) representative, so those compare in affine.
//
// What bounds it on an H100: one j2c (3 products) and two complete adds
// (12 products, b = 3) a bucket, ~1.8e6 Montgomery products at 2^16
// buckets, 0.03 ms at the int32 multiply-add rate, against ~0.004 ms for
// the 12.6 MB of buckets; the scans add ~131,000 complete adds (m log2 m
// a block of m), which doubles that.  The design is bound by its
// dependent chain instead: 2 K2 adds and K2 j2c a lane, then
// log2(BK_THREADS) scan and log2(BK_THREADS) tree levels and a few
// doublings in each launch, each add a chain of products whose
// carry-chain statements issue in order (~12 x 0.44 us).
//
// Arithmetic: group.cuh's entry formulas, lazy (field_lazy.cuh) where every
// operand is below p and exact otherwise, so any 16-bit limbs give the
// reference's result.  They are called out of line: one call site a
// formula instead of one inlined copy for each of the ~10 uses keeps the
// build short (the copies inlined made a kernel of ~50k instructions that
// took ptxas minutes); a call costs a few instructions against the ~3,000
// of an add.
#include "group.cuh"

using namespace aztec;

namespace {

constexpr int BK_THREADS = 128;  // lanes a block, and launch 2's most threads

template <class F>
__device__ __noinline__ Pt padd(const Pt& P, const Pt& Q, const Elem& b3,
                                bool nine) {
  return nine ? proj_add<F, true>(P, Q, b3) : proj_add<F, false>(P, Q, b3);
}

// `steps` doublings; nine: 3b is 9 (BN254 G1), 9t by additions
template <class F>
__device__ __noinline__ Pt pdbl(const Pt& P, const Elem& b3, bool nine,
                                int steps) {
  return nine ? proj_dbl<F, true>(P, b3, steps)
              : proj_dbl<F, false>(P, b3, steps);
}

template <class F>
__device__ __noinline__ Pt pj2c(const Pt& P) {
  return j2c<F>(P);
}

// m = blockDim.x segments of `len` entries each, segment i's (t, s) in thread
// i, combined into one; thread 0 returns the combined (t, s).  m a power of
// two up to BK_THREADS; every thread of the block calls it.
template <class F>
__device__ __forceinline__ void block_combine(Pt& t, Pt& s, const Elem& b3,
                                              bool nine, int log2_len,
                                              Pt (*sh)[BK_THREADS]) {
  const int i = threadIdx.x, m = blockDim.x;
  // inclusive scan of the totals: P_i = t_0 + ... + t_i
  Pt P = t;
  for (int d = 1; d < m; d *= 2) {
    sh[0][i] = P;
    __syncthreads();
    if (i >= d) P = padd<F>(sh[0][i - d], P, b3, nine);
    __syncthreads();
  }
  // carries C_i = P_{i-1} (C_0 the identity) beside the s_i, then one tree
  // over both rows: thread i < 2d adds entry i mod d + d of row i / d
  sh[0][i] = s;
  sh[1][i] = P;
  __syncthreads();
  const Pt total = sh[1][m - 1];
  const Pt carry = i ? sh[1][i - 1] : proj_infinity<F>();
  __syncthreads();
  sh[1][i] = carry;
  __syncthreads();
  for (int d = m / 2; d >= 1; d /= 2) {
    const int row = i / d, k = i % d;
    Pt r;
    if (i < 2 * d) r = padd<F>(sh[row][k], sh[row][k + d], b3, nine);
    __syncthreads();
    if (i < 2 * d) sh[row][k] = r;
    __syncthreads();
  }
  if (i == 0) {
    t = total;
    s = padd<F>(sh[0][0], pdbl<F>(sh[1][0], b3, nine, log2_len), b3, nine);
  }
}

// scratch: planes of (16, nblocks + 1) words; columns < nblocks hold the
// blocks' (t, s), column nblocks of the t planes 2^dbl_steps acc
template <class F>
__global__ void __launch_bounds__(BK_THREADS) bucket_lanes_kernel(
    const u32* __restrict__ bx, const u32* __restrict__ by,
    const u32* __restrict__ bz, const u32* __restrict__ ax,
    const u32* __restrict__ ay, const u32* __restrict__ az,
    u32* __restrict__ scratch, Const256 b3c, bool nine, int K2, int log2_k2,
    int dbl_steps) {
  __shared__ Pt sh[2][BK_THREADS];
  const long long nblocks = gridDim.x - 1;
  const long long W = nblocks + 1, P = 16 * W;  // one (16, W) plane
  const Elem b3 = from_const(b3c);
  if (blockIdx.x == nblocks) {
    if (threadIdx.x == 0)
      store_pt(scratch, scratch + P, scratch + 2 * P, W, nblocks,
               pdbl<F>(load_pt(ax, ay, az, 1, 0), b3, nine, dbl_steps));
    return;
  }
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nb = nblocks * blockDim.x * K2;
  Pt run = proj_infinity<F>(), ls = proj_infinity<F>();
  for (int k = 0; k < K2; ++k) {
    const long long j = nb - 1 - (l * K2 + k);
    run = padd<F>(run, pj2c<F>(load_pt(bx, by, bz, nb, j)), b3, nine);
    ls = padd<F>(ls, run, b3, nine);
  }
  block_combine<F>(run, ls, b3, nine, log2_k2, sh);
  if (threadIdx.x == 0) {
    store_pt(scratch, scratch + P, scratch + 2 * P, W, blockIdx.x, run);
    store_pt(scratch + 3 * P, scratch + 4 * P, scratch + 5 * P, W, blockIdx.x,
             ls);
  }
}

template <class F>
__global__ void __launch_bounds__(BK_THREADS) bucket_final_kernel(
    const u32* __restrict__ scratch, u32* __restrict__ ox,
    u32* __restrict__ oy, u32* __restrict__ oz, Const256 b3c, bool nine,
    int log2_len) {
  __shared__ Pt sh[2][BK_THREADS];
  const long long nblocks = blockDim.x;
  const long long W = nblocks + 1, P = 16 * W;
  const Elem b3 = from_const(b3c);
  const int i = threadIdx.x;
  Pt t = load_pt(scratch, scratch + P, scratch + 2 * P, W, i);
  Pt s = load_pt(scratch + 3 * P, scratch + 4 * P, scratch + 5 * P, W, i);
  block_combine<F>(t, s, b3, nine, log2_len, sh);
  if (i != 0) return;
  const Pt w = padd<F>(s, proj_neg<F>(t), b3, nine);
  const Pt acc = load_pt(scratch, scratch + P, scratch + 2 * P, W, nblocks);
  store_pt(ox, oy, oz, 1, 0, padd<F>(acc, w, b3, nine));
}

int log2i(long long v) {
  int k = 0;
  while ((1LL << k) < v) ++k;
  return k;
}

template <class F>
int launch(const u32* bx, const u32* by, const u32* bz, const u32* ax,
           const u32* ay, const u32* az, u32* scratch, u32* ox, u32* oy,
           u32* oz, Const256 b3, int K2, int nblocks, int dbl_steps,
           cudaStream_t s) {
  const bool nine = is_nine<F>(b3);
  bucket_lanes_kernel<F><<<nblocks + 1, BK_THREADS, 0, s>>>(
      bx, by, bz, ax, ay, az, scratch, b3, nine, K2, log2i(K2), dbl_steps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bucket_final_kernel<F><<<1, nblocks, 0, s>>>(
      scratch, ox, oy, oz, b3, nine, log2i((long long)K2 * BK_THREADS));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// buckets (16, nblocks * BK_THREADS * K2) Jacobian planes, acc (16, 1)
// projective planes, scratch 6 x (16, nblocks + 1) words, out (16, 1)
// projective planes; K2 and nblocks powers of two, nblocks <= BK_THREADS
// (msm/bucket.py `geometry`); b3: host pointer to the 8 32-bit limbs of 3b
// in Montgomery form
int bk_bucket_phase(int field, const u32* bx, const u32* by, const u32* bz,
                    const u32* ax, const u32* ay, const u32* az, u32* scratch,
                    u32* ox, u32* oy, u32* oz, const u32* b3, int K2,
                    int nblocks, int dbl_steps, void* stream) {
  if (K2 < 1 || (K2 & (K2 - 1)) != 0 || nblocks < 1 ||
      (nblocks & (nblocks - 1)) != 0 || nblocks > BK_THREADS || dbl_steps < 0)
    return (int)cudaErrorInvalidValue;
  Const256 c = const_from_host(b3);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    return launch<Fr>(bx, by, bz, ax, ay, az, scratch, ox, oy, oz, c, K2,
                      nblocks, dbl_steps, s);
  if (field == 1)
    return launch<Fq>(bx, by, bz, ax, ay, az, scratch, ox, oy, oz, c, K2,
                      nblocks, dbl_steps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
