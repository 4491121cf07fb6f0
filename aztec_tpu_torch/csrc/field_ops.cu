// K1: elementwise BN254 field kernels over (16, n) limb planes.
//
// Replaces the elementwise Pallas kernel factory of
// aztec_tpu/ff/pallas_field.py (`_elementwise_call` / `elementwise_op`) for
// its four main-path formulas: `mont_mul`, `add_mod`, `sub_mod` and the
// fused Stockham `butterfly` (top + tw*bot, top - tw*bot), and for the fused
// `mul_add` (a*b + c, pallas_field.py:359-371), which no path of either
// package calls yet.
//
// One thread per element; the element's limbs live in registers.  What
// bounds it on an H100: a mont_mul moves 3 x 64 bytes per element (two
// inputs, one output) and does 2 x 64 32-bit multiply-adds plus carries,
// so at 2^16 elements it is launch- and memory-latency bound; at the
// prover's 2^19 widths it sits between the memory rate and the integer
// multiply rate.  The design keeps every intermediate in registers so each
// element is read and written once.
//
// Every entry point takes the field (0 = Fr, 1 = Fq), device pointers to
// contiguous (16, n) uint32 planes, n and the CUDA stream, launches on that
// stream and returns cudaGetLastError().
#include "field.cuh"

using namespace aztec;

namespace {

template <class F>
__global__ void mont_mul_kernel(const u32* __restrict__ a,
                                const u32* __restrict__ b, u32* __restrict__ out,
                                long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  store(out, n, j, mul<F>(load(a, n, j), load(b, n, j)));
}

template <class F>
__global__ void add_mod_kernel(const u32* __restrict__ a,
                               const u32* __restrict__ b, u32* __restrict__ out,
                               long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  store(out, n, j, add<F>(load(a, n, j), load(b, n, j)));
}

template <class F>
__global__ void sub_mod_kernel(const u32* __restrict__ a,
                               const u32* __restrict__ b, u32* __restrict__ out,
                               long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  store(out, n, j, sub<F>(load(a, n, j), load(b, n, j)));
}

template <class F>
__global__ void butterfly_kernel(const u32* __restrict__ top,
                                 const u32* __restrict__ bot,
                                 const u32* __restrict__ tw,
                                 u32* __restrict__ plus, u32* __restrict__ minus,
                                 long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Elem t = load(top, n, j);
  Elem m = mul<F>(load(bot, n, j), load(tw, n, j));
  store(plus, n, j, add<F>(t, m));
  store(minus, n, j, sub<F>(t, m));
}

template <class F>
__global__ void mul_add_kernel(const u32* __restrict__ a,
                               const u32* __restrict__ b,
                               const u32* __restrict__ c, u32* __restrict__ out,
                               long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  store(out, n, j, add<F>(mul<F>(load(a, n, j), load(b, n, j)), load(c, n, j)));
}

}  // namespace

#define DISPATCH(field, KERNEL, ...)                                       \
  do {                                                                     \
    cudaStream_t s = (cudaStream_t)stream;                                 \
    if (field == 0)                                                        \
      KERNEL<Fr><<<blocks_for(n), THREADS, 0, s>>>(__VA_ARGS__);           \
    else if (field == 1)                                                   \
      KERNEL<Fq><<<blocks_for(n), THREADS, 0, s>>>(__VA_ARGS__);           \
    else                                                                   \
      return (int)cudaErrorInvalidValue;                                   \
  } while (0)

extern "C" {

int fk_mont_mul(int field, const u32* a, const u32* b, u32* out, long long n,
                void* stream) {
  DISPATCH(field, mont_mul_kernel, a, b, out, n);
  return (int)cudaGetLastError();
}

int fk_add_mod(int field, const u32* a, const u32* b, u32* out, long long n,
               void* stream) {
  DISPATCH(field, add_mod_kernel, a, b, out, n);
  return (int)cudaGetLastError();
}

int fk_sub_mod(int field, const u32* a, const u32* b, u32* out, long long n,
               void* stream) {
  DISPATCH(field, sub_mod_kernel, a, b, out, n);
  return (int)cudaGetLastError();
}

int fk_butterfly(int field, const u32* top, const u32* bot, const u32* tw,
                 u32* plus, u32* minus, long long n, void* stream) {
  DISPATCH(field, butterfly_kernel, top, bot, tw, plus, minus, n);
  return (int)cudaGetLastError();
}

int fk_mul_add(int field, const u32* a, const u32* b, const u32* c, u32* out,
               long long n, void* stream) {
  DISPATCH(field, mul_add_kernel, a, b, c, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
