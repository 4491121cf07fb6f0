// Microbenchmark kernels: the card's counterparts of the two TPU tools that
// probe what the fused field kernels are made of.
//
// mb_vpu replaces `make(kind, rows)` of tools/vpu_microbench.py (its
// pallas_call at :57): chains of one operation over `rows` independent
// values per element.  The TPU kernel runs NOPS / rows steps on each of
// `rows` (8, 128) tiles; here one thread holds an element column's `rows`
// values in registers and runs the same steps on each.  Its bound is its
// compiled loop: the SASS instructions of each trip at the issue rate of
// 128 per clock per SM, or those of each class at the class's own rate (64
// per clock per SM for 32-bit integer add, logic, shift and multiply-add,
// 128 for fp32 multiply), whichever is longer: with NOPS = 2048 every
// element does thousands of operations per 12 bytes moved.  The design
// gives each thread `rows` independent chains (4 or 16, template
// parameters, fully unrolled) so that the dependent latency of one chain
// hides behind the others, and keeps every step executed: the steps run in
// a loop whose trip count is a kernel argument, the shift amount and the
// masks are kernel arguments, and an empty asm after each integer step
// stops the compiler from folding a chain (x + y + y into x + 2y,
// x * y * y into x * y^2, the idempotent & mask) without changing any
// output.  ptxas still runs two adds (or two ands) of a chain as one
// three-operand IADD3 (LOP3): the card's own form of such a chain, which
// its SASS listing shows.
//
// mb_dissect replaces `run_kernel(body, nf)` of tools/kernel_dissect.py
// (its pallas_call at :49) over (16, n) planes of 16-bit limbs of the base
// field Fq: the TPU's split-column schoolbook product (`products`), its
// product-scanning variant with a ripple over the low half (`comba_full`),
// four ripple canonicalisations (`canon4`), and the whole Montgomery
// product (`mont_full`, the TPU's KF.mul).  The first three are defined by
// their exact uint32 outputs, so they keep the TPU's 16-bit column form
// (each 16 x 16-bit product split into lo and hi halves); `mont_full` is
// field.cuh's CIOS `mul<Fq>` on the repacked 8 x 32-bit limbs, which gives
// the reference's bits on any 16-bit limbs (the sum U / R reduced mod
// 2^256 before one conditional subtraction of p).  One thread per element,
// the limbs in registers.  Bound: every body by the 192 bytes it moves per
// element; its compiled instructions (about 1,200 for the column bodies)
// at the SM's issue rate of 128 per clock fit under that.
//
// Every entry point launches on the given CUDA stream and returns
// cudaGetLastError().
#include "field.cuh"

using namespace aztec;

namespace {

// kinds, in the order of the TPU tool's main loop
enum Kind { ADD = 0, MUL = 1, SHIFT = 2, AND = 3, MULMASK = 4, MULF32 = 5 };
constexpr int UNROLL = 8;  // steps of every chain per trip of the loop

// Distinct masks for the steps of one trip: the compiler cannot know they
// are equal, so it cannot fold a chain's ands into one instruction.
struct Masks {
  u32 v[UNROLL];
};

// An empty asm that the compiler must assume changes x: it emits nothing.
__device__ __forceinline__ void opaque(u32& x) { asm volatile("" : "+r"(x)); }

template <int KIND>
__device__ __forceinline__ u32 step(u32 x, u32 y, u32 shift, u32 mask) {
  if (KIND == ADD) return x + y;
  if (KIND == MUL) return x * y;
  if (KIND == SHIFT) return x >> shift;
  if (KIND == AND) return x & mask;
  return ((x * y) & mask) + x;  // MULMASK: the field formulas' inner pattern
}

template <int KIND, int ROWS>
__global__ void vpu_kernel(const u32* __restrict__ a, const u32* __restrict__ b,
                           u32* __restrict__ out, long long ncols, int steps,
                           u32 shift, Masks masks) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncols) return;
  u32 x[ROWS], y[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    x[i] = a[i * ncols + j];
    y[i] = b[i * ncols + j];
  }
  if (KIND == MULF32) {
    if (steps > 0) {  // the TPU converts on the first step
      float xf[ROWS], yf[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        xf[i] = __uint2float_rn(x[i]);
        yf[i] = __uint2float_rn(y[i]);
      }
      int r = 0;
#pragma unroll 1
      for (; r + UNROLL <= steps; r += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int i = 0; i < ROWS; ++i) xf[i] = __fmul_rn(xf[i], yf[i]);
        }
      }
#pragma unroll 1
      for (; r < steps; ++r) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) xf[i] = __fmul_rn(xf[i], yf[i]);
      }
      // saturating, as the reference's float -> uint32 (inf -> 0xFFFFFFFF)
#pragma unroll
      for (int i = 0; i < ROWS; ++i) x[i] = __float2uint_rz(xf[i]);
    }
  } else {
    int r = 0;
#pragma unroll 1
    for (; r + UNROLL <= steps; r += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          x[i] = step<KIND>(x[i], y[i], shift, masks.v[u]);
          opaque(x[i]);
        }
      }
    }
#pragma unroll 1
    for (; r < steps; ++r) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        x[i] = step<KIND>(x[i], y[i], shift, masks.v[0]);
        opaque(x[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) out[i * ncols + j] = x[i];
}

template <int ROWS>
int launch_vpu(int kind, const u32* a, const u32* b, u32* out, long long ncols,
               int steps, cudaStream_t s) {
  Masks masks;
  for (int u = 0; u < UNROLL; ++u) masks.v[u] = 0xffffu;
  const u32 shift = 1u;
  const unsigned int grid = blocks_for(ncols);
  switch (kind) {
    case ADD:
      vpu_kernel<ADD, ROWS><<<grid, THREADS, 0, s>>>(a, b, out, ncols, steps,
                                                     shift, masks);
      break;
    case MUL:
      vpu_kernel<MUL, ROWS><<<grid, THREADS, 0, s>>>(a, b, out, ncols, steps,
                                                     shift, masks);
      break;
    case SHIFT:
      vpu_kernel<SHIFT, ROWS><<<grid, THREADS, 0, s>>>(a, b, out, ncols, steps,
                                                       shift, masks);
      break;
    case AND:
      vpu_kernel<AND, ROWS><<<grid, THREADS, 0, s>>>(a, b, out, ncols, steps,
                                                     shift, masks);
      break;
    case MULMASK:
      vpu_kernel<MULMASK, ROWS><<<grid, THREADS, 0, s>>>(a, b, out, ncols,
                                                         steps, shift, masks);
      break;
    case MULF32:
      vpu_kernel<MULF32, ROWS><<<grid, THREADS, 0, s>>>(a, b, out, ncols,
                                                        steps, shift, masks);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// -- the dissect bodies, over one element's 16 limbs (16-bit values) --------

enum Body { PRODUCTS = 0, COMBA_FULL = 1, CANON4 = 2, MONT_FULL = 3 };

// The TPU's mul_cols (pallas_field.py:81-96): the lo half of a_i b_j into
// column i + j, the hi half into column i + j + 1.
__device__ __forceinline__ void mul_cols16(const u32 (&a)[16],
                                           const u32 (&b)[16], u32 (&col)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) col[k] = 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      u32 p = a[i] * b[j];
      col[i + j] += p & 0xffffu;
      col[i + j + 1] += p >> 16;
    }
  }
}

// kernel_dissect.py:60-63: the 32 columns folded to 16 outputs
__device__ __forceinline__ void body_products(const u32 (&a)[16],
                                              const u32 (&b)[16],
                                              u32 (&o)[16]) {
  u32 col[32];
  mul_cols16(a, b, col);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = col[i] + col[i + 16];
}

// kernel_dissect.py:78-102: product scanning, the low 16 columns rippled
// to digits as they complete, the high 16 left redundant
__device__ __forceinline__ void body_comba_full(const u32 (&a)[16],
                                                const u32 (&b)[16],
                                                u32 (&o)[16]) {
  u32 carry = 0u, his = 0u;
  u32 tlow[16];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    u32 col = his;
    his = 0u;
#pragma unroll
    for (int i = (k > 15 ? k - 15 : 0); i <= (k < 15 ? k : 15); ++i) {
      u32 p = a[i] * b[k - i];
      col += p & 0xffffu;
      his += p >> 16;
    }
    if (k < 16) {
      u32 v = col + carry;
      tlow[k] = v & 0xffffu;
      carry = v >> 16;
    } else {
      o[k - 16] = tlow[k - 16] + col;
    }
  }
}

// kernel_dissect.py:70-75: four ripples, b added before and after each
__device__ __forceinline__ void body_canon4(const u32 (&a)[16],
                                            const u32 (&b)[16], u32 (&o)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = a[i] + b[i];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u32 carry = 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      u32 v = o[i] + carry;
      o[i] = v & 0xffffu;
      carry = v >> 16;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] += b[i];
  }
}

template <int BODY>
__global__ void dissect_kernel(const u32* __restrict__ a,
                               const u32* __restrict__ b, u32* __restrict__ out,
                               long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  if (BODY == MONT_FULL) {
    store(out, n, j, mul<Fq>(load(a, n, j), load(b, n, j)));
    return;
  }
  u32 x[16], y[16], o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = a[i * n + j];
    y[i] = b[i * n + j];
  }
  if (BODY == PRODUCTS) body_products(x, y, o);
  if (BODY == COMBA_FULL) body_comba_full(x, y, o);
  if (BODY == CANON4) body_canon4(x, y, o);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i * n + j] = o[i];
}

}  // namespace

extern "C" {

// kind: index into (add_u32, mul_u32, shift_u32, and_u32, mulmask,
// mul_f32); rows: 4 or 16; a, b, out: contiguous (rows, ncols) uint32;
// nops: operations per element column, nops / rows steps per chain.
int mb_vpu(int kind, int rows, const u32* a, const u32* b, u32* out,
           long long ncols, int nops, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 4) return launch_vpu<4>(kind, a, b, out, ncols, nops / 4, s);
  if (rows == 16) return launch_vpu<16>(kind, a, b, out, ncols, nops / 16, s);
  return (int)cudaErrorInvalidValue;
}

// body: index into (products, comba_full, canon4, mont_full); a, b, out:
// contiguous (16, n) planes of 16-bit limbs stored one per uint32 word.
int mb_dissect(int body, const u32* a, const u32* b, u32* out, long long n,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = blocks_for(n);
  switch (body) {
    case PRODUCTS:
      dissect_kernel<PRODUCTS><<<grid, THREADS, 0, s>>>(a, b, out, n);
      break;
    case COMBA_FULL:
      dissect_kernel<COMBA_FULL><<<grid, THREADS, 0, s>>>(a, b, out, n);
      break;
    case CANON4:
      dissect_kernel<CANON4><<<grid, THREADS, 0, s>>>(a, b, out, n);
      break;
    case MONT_FULL:
      dissect_kernel<MONT_FULL><<<grid, THREADS, 0, s>>>(a, b, out, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
