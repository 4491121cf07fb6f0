// K3 and K5: the rake scans of the Pippenger MSM.
//
// Replace aztec_tpu/msm/rake_pallas.py:
//   rk_rake_packed <- `_rake_packed_call` / `rake_scan_packed` (K3), the
//                     chunked pipeline's and the engine's packed branch;
//   rk_rake        <- `_rake_call` / `rake_scan` (K5), the engine's unpacked
//                     branch (msm/pippenger.py `_rake_segment_scan`).
// B independent lanes each walk K sorted (digit, point) entries in order:
// while the digit repeats, the next affine point is mixed-added into the
// lane's Jacobian accumulator (the 7M + 4S formula of group.cuh), otherwise
// the run restarts from that point with Z = 1.  Every running partial is
// emitted.  K3 runs that step (`rake_step`) one thread a lane; K5 splits it
// over four lanes (`rake_step4`), and its exact path runs `rake_step`.
//
// K3 layouts (all K-major, element (k, b) at column k * B + b):
//   dig     (K * B)         uint32 digits
//   packed  (16, K * B)     rows 0-7: X limb pairs, rows 8-15: Y limb pairs
//                           (limb 2i in the low half-word of row i), which
//                           is exactly the 8 x 32-bit limb form
//   out X/Y/Z (16, K * B)   16-bit limb planes of the running partials
// K5 layouts (n-order, element (b, k) at column b * K + k, the reference's
// `rake_scan` contract):
//   dig     (B * K)         uint32 sorted digits
//   X, Y    (16, B * K)     16-bit limb planes of the sorted points
//   out X/Y/Z (16, B * K)   = (16, B, K)
//
// On the TPU the grid walks K sequentially and carries the accumulator in
// VMEM scratch between grid steps, and `rake_scan` exists only for B a
// multiple of 1024 (the (8, 128) tile).  Blocks on the card run in no
// order, so here the K steps are a loop inside one lane and the
// accumulator stays in registers; nothing is carried between blocks, and
// K5 takes any B.  In K3 neighbouring threads are neighbouring lanes at
// neighbouring columns, so every load and store of a step is coalesced.
//
// What bounds K3 on the card: per entry it reads 68 bytes and writes 192
// against one mixed add of 11 Montgomery products, so at the proof's
// widths (8 or 24 rows of 4096 lanes, K = 64) the products' multiply-adds
// at the 32-bit multiply-add rate bound it, not the bytes.
//
// K3 is redesigned for the card (PERF.md has each step's times, registers
// and SASS, from `python3 chip_smoke.py --redesigned` and the design-step
// builds it records); each step was kept only where it measured faster at
// both proof widths against the step before:
// 1. The lazy mixed add of group.cuh (PTX carry chains, values in [0, 2p),
//    field_lazy.cuh).  The accumulator is carried canonical from step to
//    step: it is stored at every step anyway, and `is_zero(Z1)` must read
//    a canonical Z, since a lazy p is a zero.  K5 does the same.
// 2. `__launch_bounds__` at the largest register cap with no spill
//    (RK_THREADS x RK_BLOCKS below); uncapped, ptxas took more registers
//    and an SM held fewer lanes.  The entry point chooses the block size
//    from B so that the busiest SM gets the fewest lanes.
// Dropped: loading entry k + 1's digit and point before step k's
// arithmetic.  Under the cap it spilled, and it was no faster at the
// widest width.
//
// K5 is redesigned for the card (PERF.md has its times beside the
// one-thread-a-lane kernel's and each step's, from `python3 chip_smoke.py
// --redesigned` on this tree and on copies with the edits it names).  Its
// path is the engine's small tier: B = 128 lanes of K = 32 entries, 32
// launches of a 2^11-point MSM.  The kernel before ran one thread a lane,
// so 128 threads on one SM, each waiting at every step on 32 strided loads
// and then on 11 dependent products.  What bounds it now is the latency of
// a step's chain:
// 1. Four lanes a point (rake_lazy_kernel): the mixed add's products run
//    on separate lanes, one a lane a level, exchanged by `__shfl_sync`
//    (level 1: Z1^2, Y2 Z1; 2: X2 Z1Z1, Y2 Z1 Z1Z1; 3: H^2, (Z1 + H)^2,
//    r^2; 4: H I, X1 I; 5: r (V - X3), Y1 J), so a step waits on five
//    products instead of eleven.  Every lane forms the sums between them
//    from the products shuffled in, so all four hold the accumulator.
// 2. Blocks of R5_POINTS points (one warp), so B = 128 spreads over 16
//    SMs, each lane's next entry loaded into registers before the current
//    step's products, so a step no longer waits on its loads.
// Dropped: staging a window of 8 steps of a block's points through shared
// memory (the block's points own the contiguous columns b0 K .. (b0 + 8) K
// of the n-order planes: one cp.async copy a window, double-buffered, and
// the partials leaving the same way).  It took 185 registers against 128
// and was slower at every width but the widest (on an NVIDIA H100 80GB
// HBM3 at 700 W, B = 128, K = 32: 0.149 against 0.097 ms; B = 4,101,
// K = 64: 0.300 against 0.393 ms): at one warp an SM every instruction of
// a step waits its turn, and the staging added them.
//
// Inputs: any 16-bit limbs, as the reference takes.  K3 and K5 run two
// kernels each: the lazy kernel walks every lane on the lazy formula
// alone, then an exact kernel walks again, on the exact formula, the lanes
// with a point at or above p and overwrites their partials.  (A lane whose
// points all lie below p keeps a canonical accumulator, so its lazy steps
// are exact.)  rake_packed_exact_kernel reads the top words of each lane's
// points, 8 of the 64 bytes of each entry, ~1% of K3's time at the proof's
// widths; K5's lazy kernel tests the points it loads and leaves a flag a
// lane for rake_exact_kernel.  The exact formula inlined beside the lazy
// one in rake_packed_kernel spilled under its register cap and cost it
// 5%, and so did a flag carried through its loop.
#include "group.cuh"

using namespace aztec;

namespace {

constexpr u32 SENTINEL = 0x1FFFFu;  // no digit equals it: first step restarts
// K3's largest block and the blocks an SM must hold: the register cap they
// imply, 65536 / (threads x blocks) = 128, leaves no spill
constexpr int RK_THREADS = 128, RK_BLOCKS = 4;

// the mixed add of a step: group.cuh's lazy or exact formula
enum Form { LAZY, EXACT };

// One step of a lane: continue the run with (X2, Y2), or restart from it.
template <class F, Form FORM>
__device__ __forceinline__ void rake_step(Pt& acc, u32& prevd, u32 dk,
                                          const Elem& X2, const Elem& Y2) {
  Pt added;
  if constexpr (FORM == LAZY)
    added = lazy::mixed_add_unsafe<F>(acc, X2, Y2);
  else
    added = exact::mixed_add_unsafe<F>(acc, X2, Y2);
  const bool same = dk == prevd;
  acc.x = select(same, added.x, X2);
  acc.y = select(same, added.y, Y2);
  acc.z = select(same, added.z, one_mont<F>());
  prevd = dk;
}

// K3 lane b's K steps with the FORM mixed add
template <class F, Form FORM>
__device__ __forceinline__ void rake_packed_lane(
    const u32* __restrict__ dig, const u32* __restrict__ packed,
    u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ oz, int K,
    long long B, long long b) {
  const long long n = (long long)K * B;
  Pt acc{zero(), zero(), zero()};
  u32 prevd = SENTINEL;
  for (int k = 0; k < K; ++k) {
    const long long col = (long long)k * B + b;
    Elem X2, Y2;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      X2.v[i] = packed[(long long)i * n + col];
      Y2.v[i] = packed[(long long)(NL + i) * n + col];
    }
    rake_step<F, FORM>(acc, prevd, dig[col], X2, Y2);
    store_pt(ox, oy, oz, n, col, acc);
  }
}

template <class F>
__global__ void __launch_bounds__(RK_THREADS, RK_BLOCKS) rake_packed_kernel(
    const u32* __restrict__ dig, const u32* __restrict__ packed,
    u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ oz, int K,
    long long B) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  rake_packed_lane<F, LAZY>(dig, packed, ox, oy, oz, K, B, b);
}

// the lanes with a point at or above p (the top words of X and Y, packed
// rows 7 and 15), again on the exact formula
template <class F>
__global__ void rake_packed_exact_kernel(
    const u32* __restrict__ dig, const u32* __restrict__ packed,
    u32* __restrict__ ox, u32* __restrict__ oy, u32* __restrict__ oz, int K,
    long long B) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long n = (long long)K * B;
  bool in_range = true;
  for (int k = 0; k < K; ++k) {
    const long long col = (long long)k * B + b;
    in_range &= (packed[(NL - 1) * n + col] < F::P(NL - 1)) &
                (packed[(2 * NL - 1) * n + col] < F::P(NL - 1));
  }
  if (!in_range) rake_packed_lane<F, EXACT>(dig, packed, ox, oy, oz, K, B, b);
}

// K5's geometry: lanes a point, points a block (one warp)
constexpr int R5_LANES = 4, R5_POINTS = 8, R5_THREADS = R5_LANES * R5_POINTS;

// One step of a point on its four lanes (r = lane): group.cuh's lazy
// `mixed_add_unsafe` (P canonical, (X2, Y2) below p; the same values mod p
// on [0, 2p), so the same reduced coordinates), each level's products on
// separate lanes, then the rake's continue-or-restart select.
template <class F>
__device__ __forceinline__ void rake_step4(Pt& acc, u32& prevd, u32 dk,
                                           const Elem& X2, const Elem& Y2,
                                           int r) {
  const Elem &X1 = acc.x, &Y1 = acc.y, &Z1 = acc.z;
  // level 1: lane 0 Z1^2, lane 1 Y2 Z1
  const Elem m1 = lazy::mul<F>(select(r == 1, Y2, Z1), Z1);
  const Elem Z1Z1 = shfl<R5_LANES>(m1, 0), YZ = shfl<R5_LANES>(m1, 1);
  // level 2: lane 0 U2 = X2 Z1Z1, lane 1 S2 = Y2 Z1 Z1Z1
  const Elem m2 = lazy::mul<F>(select(r == 1, YZ, X2), Z1Z1);
  const Elem H = lazy::sub<F>(shfl<R5_LANES>(m2, 0), X1);
  Elem R = lazy::sub<F>(shfl<R5_LANES>(m2, 1), Y1);
  R = lazy::add<F>(R, R);
  // level 3: lane 0 H^2, lane 1 (Z1 + H)^2, lane 2 R^2
  const Elem m3 = lazy::sqr<F>(
      select(r == 0, H, select(r == 1, lazy::add<F>(Z1, H), R)));
  const Elem HH = shfl<R5_LANES>(m3, 0), ZH = shfl<R5_LANES>(m3, 1),
             RR = shfl<R5_LANES>(m3, 2);
  Elem I = lazy::add<F>(HH, HH);
  I = lazy::add<F>(I, I);
  // level 4: lane 0 J = H I, lane 1 V = X1 I
  const Elem m4 = lazy::mul<F>(select(r == 1, X1, H), I);
  const Elem J = shfl<R5_LANES>(m4, 0), V = shfl<R5_LANES>(m4, 1);
  const Elem X3 = lazy::sub<F>(lazy::sub<F>(RR, J), lazy::add<F>(V, V));
  // level 5: lane 0 R (V - X3), lane 1 Y1 J
  const Elem m5 = lazy::mul<F>(select(r == 1, Y1, R),
                               select(r == 1, J, lazy::sub<F>(V, X3)));
  const Elem YJ = shfl<R5_LANES>(m5, 1);
  const Elem Y3 = lazy::sub<F>(shfl<R5_LANES>(m5, 0), lazy::add<F>(YJ, YJ));
  const Elem Z3 = lazy::sub<F>(lazy::sub<F>(ZH, Z1Z1), HH);
  // a new digit, or the accumulator at infinity: restart from the point
  const bool fresh = (dk != prevd) | is_zero(Z1);
  acc.x = select(fresh, X2, lazy::canon<F>(X3));
  acc.y = select(fresh, Y2, lazy::canon<F>(Y3));
  acc.z = select(fresh, one_mont<F>(), lazy::canon<F>(Z3));
  prevd = dk;
}

// K5 on the lazy formula, four lanes a point (see the header): every lane
// of a point loads its entries (lanes past B load lane B - 1's), the next
// entry's before the current step's products; lane 0 stores the partials.
// flags[b] = 1 where lane b holds a point at or above p.
template <class F>
__global__ void __launch_bounds__(R5_THREADS) rake_lazy_kernel(
    const u32* __restrict__ dig, const u32* __restrict__ px,
    const u32* __restrict__ py, u32* __restrict__ ox, u32* __restrict__ oy,
    u32* __restrict__ oz, u32* __restrict__ flags, int K, long long B) {
  const long long n = (long long)K * B;
  const long long b0 = (long long)blockIdx.x * R5_POINTS;
  const int t = threadIdx.x / R5_LANES, r = threadIdx.x % R5_LANES;
  const bool owner = r == 0 && b0 + t < B;
  const long long b = b0 + t < B ? b0 + t : B - 1;
  Pt acc{zero(), zero(), zero()};
  u32 prevd = SENTINEL;
  bool in_range = true;
  Elem X2 = load(px, n, b * K), Y2 = load(py, n, b * K);
  u32 dk = dig[b * K];
  for (int k = 0; k < K; ++k) {
    const long long col = b * K + k;
    const long long next = k + 1 < K ? col + 1 : col;
    const Elem nX = load(px, n, next), nY = load(py, n, next);
    const u32 nd = dig[next];
    in_range &= below_p<F>(X2) & below_p<F>(Y2);
    rake_step4<F>(acc, prevd, dk, X2, Y2, r);
    if (owner) store_pt(ox, oy, oz, n, col, acc);
    X2 = nX;
    Y2 = nY;
    dk = nd;
  }
  if (owner) flags[b] = !in_range;
}

// the lanes rake_lazy_kernel flagged, one thread each, again on the exact
// formula (K5's n-order layout, strided: these lanes are rare)
template <class F>
__global__ void rake_exact_kernel(const u32* __restrict__ dig,
                                  const u32* __restrict__ px,
                                  const u32* __restrict__ py,
                                  u32* __restrict__ ox, u32* __restrict__ oy,
                                  u32* __restrict__ oz,
                                  const u32* __restrict__ flags, int K,
                                  long long B) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || !flags[b]) return;
  const long long n = (long long)K * B;
  Pt acc{zero(), zero(), zero()};
  u32 prevd = SENTINEL;
  for (int k = 0; k < K; ++k) {
    const long long col = b * K + k;
    rake_step<F, EXACT>(acc, prevd, dig[col], load(px, n, col),
                        load(py, n, col));
    store_pt(ox, oy, oz, n, col, acc);
  }
}

}  // namespace

extern "C" {

int rk_rake_packed(int field, const u32* dig, const u32* packed, u32* ox,
                   u32* oy, u32* oz, int K, long long B, void* stream) {
  unsigned int threads = balanced_threads(B, RK_THREADS);
  unsigned int blocks = (unsigned int)((B + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define RAKE_PACKED(F)                                                      \
  rake_packed_kernel<F><<<blocks, threads, 0, s>>>(dig, packed, ox, oy, oz, \
                                                   K, B);                   \
  if (cudaError_t e = cudaGetLastError()) return (int)e;                    \
  rake_packed_exact_kernel<F><<<blocks_for(B), THREADS, 0, s>>>(            \
      dig, packed, ox, oy, oz, K, B)
  if (field == 0) {
    RAKE_PACKED(Fr);
  } else if (field == 1) {
    RAKE_PACKED(Fq);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef RAKE_PACKED
  return (int)cudaGetLastError();
}

// flags: B words of scratch
int rk_rake(int field, const u32* dig, const u32* px, const u32* py, u32* ox,
            u32* oy, u32* oz, u32* flags, int K, long long B, void* stream) {
  const unsigned int blocks = (unsigned int)((B + R5_POINTS - 1) / R5_POINTS);
  cudaStream_t s = (cudaStream_t)stream;
#define RAKE(F)                                                             \
  rake_lazy_kernel<F><<<blocks, R5_THREADS, 0, s>>>(dig, px, py, ox, oy, oz, \
                                                    flags, K, B);           \
  if (cudaError_t e = cudaGetLastError()) return (int)e;                    \
  rake_exact_kernel<F><<<blocks_for(B), THREADS, 0, s>>>(                   \
      dig, px, py, ox, oy, oz, flags, K, B)
  if (field == 0) {
    RAKE(Fr);
  } else if (field == 1) {
    RAKE(Fq);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef RAKE
  return (int)cudaGetLastError();
}

}  // extern "C"
