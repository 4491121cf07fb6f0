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
// emitted.  Both kernels share that step (`rake_step`) and differ only in
// layout.
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
// order, so here the K steps are a loop inside one thread and the
// accumulator stays in registers; nothing is carried between blocks, and
// K5 takes any B.  In K3 neighbouring threads are neighbouring lanes at
// neighbouring columns, so every load and store of a step is coalesced.
// K5 keeps the reference's n-order layout: neighbouring lanes sit K
// columns apart, so its loads and stores are strided; relaying out to
// K-major (or staging a tile through shared memory) is left to a later
// change.  On its path (B = 128 lanes, 32 rounds of the 2^11-point tier)
// K5 is bound by the launch and by the K sequential steps of one lane,
// not by the card's rates.
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
//    a canonical Z, since a lazy p is a zero.  K5 shares the step.
// 2. `__launch_bounds__` at the largest register cap with no spill
//    (RK_THREADS x RK_BLOCKS below); uncapped, ptxas took more registers
//    and an SM held fewer lanes.  The entry point chooses the block size
//    from B so that the busiest SM gets the fewest lanes.
// Dropped: loading entry k + 1's digit and point before step k's
// arithmetic.  Under the cap it spilled, and it was no faster at the
// widest width.
//
// Inputs: any 16-bit limbs, as the reference takes.  K3 runs two kernels:
// rake_packed_kernel walks every lane on the lazy formula alone, then
// rake_packed_exact_kernel reads the top words of each lane's points and,
// for a lane with a coordinate at or above p, walks it again on the exact
// formula and overwrites its partials.  (A lane whose points all lie below
// p keeps a canonical accumulator, so its lazy steps are exact.)  The
// second kernel reads 8 of the 64 bytes of each entry, ~1% of K3's time at
// the proof's widths.  The exact formula inlined beside the lazy one in
// rake_packed_kernel spilled under its register cap and cost it 5%, and
// so did a flag carried through its loop.  K5 calls group.cuh's entry
// mixed add, which tests the accumulator and the point at every step.
#include "group.cuh"

using namespace aztec;

namespace {

constexpr u32 SENTINEL = 0x1FFFFu;  // no digit equals it: first step restarts
// K3's largest block and the blocks an SM must hold: the register cap they
// imply, 65536 / (threads x blocks) = 128, leaves no spill
constexpr int RK_THREADS = 128, RK_BLOCKS = 4;

// the mixed add of a step: group.cuh's entry formula, or one of its forms
enum Form { ENTRY, LAZY, EXACT };

// One step of a lane: continue the run with (X2, Y2), or restart from it.
template <class F, Form FORM>
__device__ __forceinline__ void rake_step(Pt& acc, u32& prevd, u32 dk,
                                          const Elem& X2, const Elem& Y2) {
  Pt added;
  if constexpr (FORM == LAZY)
    added = lazy::mixed_add_unsafe<F>(acc, X2, Y2);
  else if constexpr (FORM == EXACT)
    added = exact::mixed_add_unsafe<F>(acc, X2, Y2);
  else
    added = mixed_add_unsafe<F>(acc, X2, Y2);
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

template <class F>
__global__ void rake_kernel(const u32* __restrict__ dig,
                            const u32* __restrict__ px,
                            const u32* __restrict__ py, u32* __restrict__ ox,
                            u32* __restrict__ oy, u32* __restrict__ oz, int K,
                            long long B) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long n = (long long)K * B;
  Pt acc{zero(), zero(), zero()};
  u32 prevd = SENTINEL;
  for (int k = 0; k < K; ++k) {
    const long long col = b * K + k;
    rake_step<F, ENTRY>(acc, prevd, dig[col], load(px, n, col),
                        load(py, n, col));
    store_pt(ox, oy, oz, n, col, acc);
  }
}

}  // namespace

#define DISPATCH(field, KERNEL, ...)                                       \
  do {                                                                     \
    cudaStream_t s = (cudaStream_t)stream;                                 \
    if (field == 0)                                                        \
      KERNEL<Fr><<<blocks_for(B), THREADS, 0, s>>>(__VA_ARGS__);           \
    else if (field == 1)                                                   \
      KERNEL<Fq><<<blocks_for(B), THREADS, 0, s>>>(__VA_ARGS__);           \
    else                                                                   \
      return (int)cudaErrorInvalidValue;                                   \
  } while (0)

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

int rk_rake(int field, const u32* dig, const u32* px, const u32* py, u32* ox,
            u32* oy, u32* oz, int K, long long B, void* stream) {
  DISPATCH(field, rake_kernel, dig, px, py, ox, oy, oz, K, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
