// K1: elementwise BN254 field kernels over (16, n) limb planes.
//
// Replaces the elementwise Pallas kernel factory of
// aztec_tpu/ff/pallas_field.py (`_elementwise_call` / `elementwise_op`) for
// its four main-path formulas: `mont_mul`, `add_mod`, `sub_mod` and the
// fused Stockham `butterfly` (top + tw*bot, top - tw*bot), and for the fused
// `mul_add` (a*b + c, pallas_field.py:359-371), which no path of either
// package calls yet.  `mont_pow` runs the whole square-and-multiply ladder
// of a power (every Fermat inversion of the prover and of to_affine) in one
// launch, where the reference scans `mont_mul` (aztec_tpu/ff/limb.py:248).
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
#include "field_lazy.cuh"

constexpr int FFT_THREADS = 128;

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

// One FFT butterfly, top + w bot and top - w bot, with the reference's
// semantics on any 16-bit limbs: the product is the lazy carry-chain form
// (field_lazy.cuh), reduced, where bot and w lie below p, and the canonical
// C form otherwise; the add and sub are field.cuh's, which take any limbs.
template <class F>
__device__ __forceinline__ void butterfly(const Elem& top, const Elem& bot,
                                          const Elem& w, Elem& plus,
                                          Elem& minus) {
  Elem m;
  if ((bot.v[NL - 1] < F::P(NL - 1)) & (w.v[NL - 1] < F::P(NL - 1)))
    m = lazy::canon<F>(lazy::mul<F>(bot, w));
  else
    m = mul<F>(bot, w);
  plus = add<F>(top, m);
  minus = sub<F>(top, m);
}

// S consecutive radix-2 Stockham stages t .. t + S - 1 of an FFT, one thread
// a group, the group's 2^S elements in registers.
//
// Stage t holds A_t (r_t rows of L = 2^t columns, element (b, j) at column
// b L + j of the (16, n) planes), and A_{t+1}[b, j (+ L)] = A_t[b, j] +-
// w_{2L}^j A_t[b + r_{t+1}, j].  After S stages, A_{t+S}[b, j + e L] for
// e < 2^S depends only on A_t[b + m R, j] for m < 2^S (R = r_{t+S}), so the
// thread of group (b, j), g = b L + j < G = R L, loads those, runs the S
// stages' butterflies in the order and on the operands of S separate
// stages (so every stage boundary is bit-identical), and stores its 2^S
// outputs.  Consecutive threads read consecutive columns; the outputs land
// 2^S apart where L = 1, L apart otherwise.
//
// Element m of the group is at column g + m G of in_lo for m < 2^(S-1) and
// at column g + (m - 2^(S-1)) G of in_hi (in_lo + 2^(S-1) G for a stage;
// the `bot` operand for the single butterfly of `fk_butterfly`); output e
// at column b out_row + j + e L of out_lo, or of out_hi for the upper half
// (out_lo + 2^(S-1) L).  Twiddle w_{2L'}^k of stage L' = 2^u L is column
// k tw_stride / 2^u of the root table (tw_stride = n / 2L).
template <class F, int S>
__global__ void __launch_bounds__(FFT_THREADS) fft_stages_kernel(
    const u32* __restrict__ in_lo, const u32* __restrict__ in_hi,
    long long in_n, const u32* __restrict__ tw, long long tw_n,
    long long tw_stride, u32* __restrict__ out_lo, u32* __restrict__ out_hi,
    long long out_n, long long L, long long G, long long out_row) {
  constexpr int E = 1 << S, H = E / 2;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const long long b = g / L, j = g - b * L;
  Elem x[E];
#pragma unroll
  for (int m = 0; m < E; ++m)
    x[m] = m < H ? load(in_lo, in_n, g + m * G) : load(in_hi, in_n,
                                                         g + (m - H) * G);
  // stage u: element (m, e) at x[m 2^u + e], m < 2^(S-u), e < 2^u
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const int half = 1 << (S - u - 1), ne = 1 << u;
    Elem y[E];
#pragma unroll
    for (int e = 0; e < ne; ++e) {
      const Elem w = load(tw, tw_n, (j + e * L) * (tw_stride >> u));
#pragma unroll
      for (int m = 0; m < half; ++m)
        butterfly<F>(x[m * ne + e], x[(m + half) * ne + e], w,
                     y[m * 2 * ne + e], y[m * 2 * ne + e + ne]);
    }
#pragma unroll
    for (int k = 0; k < E; ++k) x[k] = y[k];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < H)
      store(out_lo, out_n, b * out_row + j + e * L, x[e]);
    else
      store(out_hi, out_n, b * out_row + j + (e - H) * L, x[e]);
  }
}

template <class F>
int fft_stages(int s, const u32* in, u32* out, const u32* tw, long long tw_n,
               long long n, long long L, cudaStream_t st) {
  const long long G = n >> s, H = 1LL << (s - 1);
  const unsigned int blocks = (unsigned int)((G + FFT_THREADS - 1) /
                                             FFT_THREADS);
#define STAGES(S)                                                           \
  fft_stages_kernel<F, S><<<blocks, FFT_THREADS, 0, st>>>(                  \
      in, in + H * G, n, tw, tw_n, n / (2 * L), out, out + H * L, n, L, G, \
      L << S)
  switch (s) {
    case 1: STAGES(1); break;
    case 2: STAGES(2); break;
    case 3: STAGES(3); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef STAGES
  return (int)cudaGetLastError();
}

// a^e in Montgomery form, the square-and-multiply ladder of limb.mont_pow
// (aztec_tpu/ff/limb.py:248 `mont_pow`, a lax.scan of mont_mul) in one
// launch: e = sum of bit i of the words `ew` (LSB first) for i < nbits,
// bit nbits - 1 its highest set bit (nbits = 0: e = 0, the result one).
// Result = one; for each bit i, result *= base where the bit is set, then
// base = base^2 unless i is the last.  The exponent is the same for every
// lane, so every branch on its bits is uniform across the warp; the words
// shift right one bit a step, so no register array is indexed at run time.
//
// A lane below p (its top word below p's, so every intermediate is a field
// element and a^e mod p is unique) runs the lazy carry-chain products of
// field_lazy.cuh, values in [0, 2p), and reduces once at the end; a lane at
// or above p runs field.cuh's canonical mul<F>, K1 mont_mul's own product,
// in exactly the ladder's order, which gives the reference's limbs on any
// 16-bit input.  0 maps to 0 on both.
//
// What bounds it: at the proof's inversions (width 1 to 3) the latency of
// one chain of ~380 dependent products (the lazy product's carry chain
// issues in order); at 2^19 lanes the products' multiply-adds.
//
// pow_ladder is the ladder on one lane: LAZY the carry-chain products on
// values in [0, 2p), reduced at the end, otherwise the canonical mul<F>.
template <class F, bool LAZY>
__device__ __forceinline__ Elem pow_ladder(Elem base, const Const256& ew,
                                           int nbits) {
  u32 e[NL];
#pragma unroll
  for (int w = 0; w < NL; ++w) e[w] = ew.v[w];
  Elem result = one_mont<F>();
  for (int i = 0; i < nbits; ++i) {
    if (e[0] & 1u)
      result = LAZY ? lazy::mul<F>(result, base) : mul<F>(result, base);
    if (i + 1 < nbits) base = LAZY ? lazy::sqr<F>(base) : sqr<F>(base);
#pragma unroll
    for (int w = 0; w < NL - 1; ++w)
      e[w] = __funnelshift_r(e[w], e[w + 1], 1);
    e[NL - 1] >>= 1;
  }
  return LAZY ? lazy::canon<F>(result) : result;
}

template <class F>
__global__ void mont_pow_kernel(const u32* __restrict__ a,
                                u32* __restrict__ out, Const256 ew,
                                int nbits, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const Elem x = load(a, n, j);
  store(out, n, j, x.v[NL - 1] < F::P(NL - 1)
                       ? pow_ladder<F, true>(x, ew, nbits)
                       : pow_ladder<F, false>(x, ew, nbits));
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

// does nothing: a launch's own floor, under every narrow launch
__global__ void empty_kernel() {}

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

// one butterfly an element of (16, n) planes: the stage kernel with S = 1,
// one row (G = L = n), the twiddles a plane of their own
int fk_butterfly(int field, const u32* top, const u32* bot, const u32* tw,
                 u32* plus, u32* minus, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)((n + FFT_THREADS - 1) /
                                             FFT_THREADS);
  if (field == 0)
    fft_stages_kernel<Fr, 1><<<blocks, FFT_THREADS, 0, s>>>(
        top, bot, n, tw, n, 1, plus, minus, n, n, n, 0);
  else if (field == 1)
    fft_stages_kernel<Fq, 1><<<blocks, FFT_THREADS, 0, s>>>(
        top, bot, n, tw, n, 1, plus, minus, n, n, n, 0);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// stages t .. t + s - 1 (1 <= s <= 3) of a Stockham FFT of size n: `in` the
// (16, n) planes of stage t (rows of L = 2^t columns), `out` those of stage
// t + s; tw the (16, tw_n) root table w_n^k, k < tw_n = n / 2
int fk_fft_stages(int field, const u32* in, u32* out, const u32* tw,
                  long long tw_n, long long n, long long L, int s,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s < 1 || s > 3 || (L << s) > n) return (int)cudaErrorInvalidValue;
  if (field == 0) return fft_stages<Fr>(s, in, out, tw, tw_n, n, L, st);
  if (field == 1) return fft_stages<Fq>(s, in, out, tw, tw_n, n, L, st);
  return (int)cudaErrorInvalidValue;
}

// a^e over (16, n) planes: exp_words the 8 host words of e, LSB first,
// nbits its bit length (0 <= nbits <= 256)
int fk_mont_pow(int field, const u32* a, u32* out, const u32* exp_words,
                int nbits, long long n, void* stream) {
  if (nbits < 0 || nbits > 32 * NL) return (int)cudaErrorInvalidValue;
  Const256 e;
  for (int i = 0; i < NL; ++i) e.v[i] = exp_words[i];
  DISPATCH(field, mont_pow_kernel, a, out, e, nbits, n);
  return (int)cudaGetLastError();
}

int fk_mul_add(int field, const u32* a, const u32* b, const u32* c, u32* out,
               long long n, void* stream) {
  DISPATCH(field, mul_add_kernel, a, b, c, out, n);
  return (int)cudaGetLastError();
}

// one block of THREADS threads that does nothing (tools/timing.py
// empty_launch_ms): the device time of a launch with no work
int fk_empty(void* stream) {
  empty_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
