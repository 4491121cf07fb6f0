// The GLV table of an MSM chunk: the scalar split and the endomorphism
// table in one launch, one thread a point.
//
// Replaces no Pallas kernel.  aztec_tpu/msm/glv.py:297 `glv_table` (its
// `glv_split`, `endo_table` and the selects and concatenations after them)
// is a composition of jnp ops; its port, msm/glv.py `glv_table_plain`,
// runs on the card as some 330 torch launches a call (16-bit limb products
// through `index_add_`, a ripple carry a limb pair, two's-complement
// fix-ups) and 7 uploads of host constants, each a blocking stream
// synchronise.  Every GLV MSM calls it once a chunk.  This kernel computes
// the same outputs, bit for bit on any 16-bit limbs, in one launch with
// the curve's constants passed by value.
//
// Per point j (k the scalar, the 256-bit value of its 16 limbs; X, Y the
// point's Montgomery limbs, any 16-bit values):
//   c_h  = ((k m_h + 2^415) >> 416) mod 2^128        h = 1, 2 (Babai)
//   k1   = k + c_1 A_1 + c_2 A_2          mod 2^160   A_h = -s_h a_h
//   k2   =     c_1 B_1 + c_2 B_2          mod 2^160   B_h = -s_h b_h
//   neg_i = bit 159 of k_i; |k_i| = low 128 bits of (neg_i ? -k_i : k_i)
//   Xt = [X, beta X]  (field.cuh `mul`, K1 mont_mul's product)
//   Yt = [neg_1 ? -Y : Y, neg_2 ? -Y : Y]  (-Y = field.cuh `sub`(0, Y),
//        K1 sub_mod's)
//   St = [|k1|, |k2|]
// (a_h, b_h) the reduced basis, s_h the magics' signs and m_h the magics of
// glv.py `glv_params`.  The plain version subtracts or adds each term
// s_h c_h a_h by its sign; mod 2^160 that is adding c_h A_h with the sign
// folded into A_h on the host, which is what these constants hold.  The
// product k m_h is needed only mod 2^544 (bits 416-543 make c_h), so any
// magic reduces to 17 words; each A_h, B_h is a 160-bit word string.
//
// Layouts: X, Y and the scalars are (16, n) planes of 16-bit limbs, one a
// 32-bit word, read in place at their own row strides (the chunked MSM
// passes column slices of the whole point and scalar planes); Xt, Yt are
// (16, 2n) and St (8, 2n), contiguous.  Neighbouring threads touch
// neighbouring columns, so every load and store is coalesced.
//
// What bounds it: per point it reads 48 words and writes 80 (512 bytes),
// against one Montgomery product and the split's ~270 32-bit word products
// (two 8 x 17 Babai products, four 4 x 5 terms), so at a chunk's 2^17
// points it is bound by the bytes.  The design keeps every intermediate in
// registers: the scalar's words, the Babai rows and the 160-bit workspace,
// each point read once and each output written once.
#include "field.cuh"

using namespace aztec;

namespace {

constexpr int GLV_THREADS = 256;
constexpr int MW = 17;  // words of k m_h kept: mod 2^544
constexpr int SW = 5;   // words of the split's workspace: mod 2^160

// The curve's constants, by value: beta in Montgomery form, the two
// magics mod 2^544, A_h and B_h mod 2^160 (the order of the host array
// that `gv_glv_table` takes).
struct GlvConsts {
  u32 beta[NL];
  u32 magic[2][MW];
  u32 ka[2][SW];
  u32 kb[2][SW];
};

// acc += c * a mod 2^160: one row a word of c, each rippled to the top
__device__ __forceinline__ void mac160(u32 (&acc)[SW], const u32 (&c)[4],
                                       const u32 (&a)[SW]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u32 carry = 0;
#pragma unroll
    for (int j = 0; i + j < SW; ++j) {
      u64 s = (u64)c[i] * a[j] + acc[i + j] + carry;
      acc[i + j] = (u32)s;
      carry = (u32)(s >> 32);
    }
  }
}

// v (mod 2^160, two's complement) -> (bit 159, low 128 bits of |v|)
__device__ __forceinline__ bool abs128(const u32 (&v)[SW], u32 (&mag)[4]) {
  const bool neg = v[SW - 1] >> 31;
  u32 carry = 1;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    u64 s = (u64)(~v[w]) + carry;
    carry = (u32)(s >> 32);
    mag[w] = neg ? (u32)s : v[w];
  }
  return neg;
}

// 8 words -> limbs 0-7 of column j of a (8, 2n) plane (row stride 2n)
__device__ __forceinline__ void store128(u32* __restrict__ out, long long n2,
                                         long long j, const u32 (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[(2 * i) * n2 + j] = w[i] & 0xffffu;
    out[(2 * i + 1) * n2 + j] = w[i] >> 16;
  }
}

template <class F>
__global__ void __launch_bounds__(GLV_THREADS) glv_table_kernel(
    const u32* __restrict__ X, long long xs, const u32* __restrict__ Y,
    long long ys, const u32* __restrict__ S, long long ss,
    u32* __restrict__ Xt, u32* __restrict__ Yt, u32* __restrict__ St,
    const GlvConsts cs, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long n2 = 2 * n;

  // the split
  const Elem k = load(S, ss, j);
  u32 c[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    u32 t[MW];
#pragma unroll
    for (int w = 0; w < MW; ++w) t[w] = 0u;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      u32 carry = 0;
#pragma unroll
      for (int w = 0; i + w < MW; ++w) {
        u64 s = (u64)k.v[i] * cs.magic[h][w] + t[i + w] + carry;
        t[i + w] = (u32)s;
        carry = (u32)(s >> 32);
      }
    }
    // + 2^415 (bit 31 of word 12); c_h is words 13-16
    u32 carry = (u32)(((u64)t[12] + 0x80000000u) >> 32);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      u64 s = (u64)t[13 + w] + carry;
      c[h][w] = (u32)s;
      carry = (u32)(s >> 32);
    }
  }
  u32 k1[SW], k2[SW];
#pragma unroll
  for (int w = 0; w < SW; ++w) {
    k1[w] = k.v[w];
    k2[w] = 0u;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    u32 a[SW], b[SW];
#pragma unroll
    for (int w = 0; w < SW; ++w) {
      a[w] = cs.ka[h][w];
      b[w] = cs.kb[h][w];
    }
    mac160(k1, c[h], a);
    mac160(k2, c[h], b);
  }
  u32 mag[4];
  const bool neg1 = abs128(k1, mag);
  store128(St, n2, j, mag);
  const bool neg2 = abs128(k2, mag);
  store128(St + n, n2, j, mag);

  // the endomorphism table: X as it is, then beta X
  u32 raw[2 * NL];
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) {
    raw[i] = X[i * xs + j];
    Xt[i * n2 + j] = raw[i];
  }
  Elem x, beta;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    x.v[i] = (raw[2 * i] & 0xffffu) | (raw[2 * i + 1] << 16);
    beta.v[i] = cs.beta[i];
  }
  store(Xt + n, n2, j, mul<F>(x, beta));

  // Y, or -Y where the half's scalar was negative
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) raw[i] = Y[i * ys + j];
  Elem y;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    y.v[i] = (raw[2 * i] & 0xffffu) | (raw[2 * i + 1] << 16);
  const Elem yn = sub<F>(zero(), y);
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) {
    const u32 ng = i % 2 ? yn.v[i / 2] >> 16 : yn.v[i / 2] & 0xffffu;
    Yt[i * n2 + j] = neg1 ? ng : raw[i];
    Yt[i * n2 + n + j] = neg2 ? ng : raw[i];
  }
}

}  // namespace

extern "C" {

// X, Y, S: (16, n) planes at row strides xs, ys, ss (unit column stride);
// Xt, Yt: (16, 2n), St: (8, 2n), contiguous; consts: host pointer to the
// words of GlvConsts in its order
int gv_glv_table(int field, const u32* X, long long xs, const u32* Y,
                 long long ys, const u32* S, long long ss, u32* Xt, u32* Yt,
                 u32* St, const u32* consts, long long n, void* stream) {
  GlvConsts cs;
  const u32* src = consts;
  for (int i = 0; i < NL; ++i) cs.beta[i] = *src++;
  for (int h = 0; h < 2; ++h)
    for (int w = 0; w < MW; ++w) cs.magic[h][w] = *src++;
  for (int h = 0; h < 2; ++h)
    for (int w = 0; w < SW; ++w) cs.ka[h][w] = *src++;
  for (int h = 0; h < 2; ++h)
    for (int w = 0; w < SW; ++w) cs.kb[h][w] = *src++;
  const unsigned int threads = balanced_threads(n, GLV_THREADS);
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    glv_table_kernel<Fr><<<blocks, threads, 0, s>>>(X, xs, Y, ys, S, ss, Xt,
                                                    Yt, St, cs, n);
  else if (field == 1)
    glv_table_kernel<Fq><<<blocks, threads, 0, s>>>(X, xs, Y, ys, S, ss, Xt,
                                                    Yt, St, cs, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
