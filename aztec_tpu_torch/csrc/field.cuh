// BN254 Fr / Fq Montgomery arithmetic for Hopper (sm_90a), shared by every
// kernel of the port.
//
// Replaces the in-kernel field helper `KF` of aztec_tpu/ff/pallas_field.py
// (canon / mul_cols / _redc / add / sub / mul / sqr / mul_small / select /
// is_zero).  The TPU helper works on 16 planes of 16-bit limbs because the
// TPU vector unit has no 32x32->64 multiply; the card has one, so an element
// lives in registers as 8 x 32-bit limbs and multiplies with CIOS Montgomery
// (R = 2^256, the same R as the 16 x 16-bit form, so Montgomery values are
// identical).  Every result is the canonical representative (< p), so
// outputs are bit-identical to the plain PyTorch path and to the reference.
//
// Memory layout at the kernel boundary is the reference's: a batch of n
// elements is a (16, n) plane of 16-bit limbs stored one per 32-bit word,
// limb i of element j at word i * n + j.  Neighbouring threads (j, j + 1)
// touch neighbouring words, so the 16 loads and stores of an element are
// coalesced as they are.  `load` and `store` repack 16-bit limb pairs into
// 32-bit limbs and back.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aztec {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int NL = 8;  // 32-bit limbs per element

// Limb i of a field constant.  The arrays are local to constexpr functions
// so that device code may read them; every index is a compile-time constant
// after unrolling, so each read folds to an immediate.
struct Fr {
  __host__ __device__ static constexpr u32 P(int i) {
    constexpr u32 v[NL] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                           0x2833e848u, 0x8181585du, 0xb85045b6u,
                           0xe131a029u, 0x30644e72u};
    return v[i];
  }
  // R mod p (Montgomery one)
  __host__ __device__ static constexpr u32 ONE(int i) {
    constexpr u32 v[NL] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u,
                           0x36fc7695u, 0x7879462eu, 0x666ea36fu,
                           0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
  static constexpr u32 NP = 0xefffffffu;  // -p^-1 mod 2^32
};

struct Fq {
  __host__ __device__ static constexpr u32 P(int i) {
    constexpr u32 v[NL] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du,
                           0x97816a91u, 0x8181585du, 0xb85045b6u,
                           0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __host__ __device__ static constexpr u32 ONE(int i) {
    constexpr u32 v[NL] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du,
                           0x0a78eb28u, 0x7879462cu, 0x666ea36fu,
                           0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
  static constexpr u32 NP = 0xe4866389u;
};

struct Elem {
  u32 v[NL];
};

// A 256-bit constant passed to a kernel by value (e.g. 3b in Montgomery form).
struct Const256 {
  u32 v[NL];
};

__device__ __forceinline__ Elem load(const u32* __restrict__ plane, long long n,
                                     long long j) {
  Elem e;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u32 lo = plane[(2 * i) * n + j];
    u32 hi = plane[(2 * i + 1) * n + j];
    e.v[i] = (lo & 0xffffu) | (hi << 16);
  }
  return e;
}

__device__ __forceinline__ void store(u32* __restrict__ plane, long long n,
                                      long long j, const Elem& e) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    plane[(2 * i) * n + j] = e.v[i] & 0xffffu;
    plane[(2 * i + 1) * n + j] = e.v[i] >> 16;
  }
}

__device__ __forceinline__ Elem from_const(const Const256& c) {
  Elem e;
#pragma unroll
  for (int i = 0; i < NL; ++i) e.v[i] = c.v[i];
  return e;
}

template <class F>
__device__ __forceinline__ Elem one_mont() {
  Elem e;
#pragma unroll
  for (int i = 0; i < NL; ++i) e.v[i] = F::ONE(i);
  return e;
}

__device__ __forceinline__ Elem zero() {
  Elem e;
#pragma unroll
  for (int i = 0; i < NL; ++i) e.v[i] = 0u;
  return e;
}

// t in [0, 2p) -> t mod p
template <class F>
__device__ __forceinline__ Elem cond_sub_p(const Elem& t) {
  Elem d;
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 s = (u64)t.v[i] - F::P(i) - borrow;
    d.v[i] = (u32)s;
    borrow = (u32)(s >> 63);
  }
  // borrow == 1 <=> t < p: keep t
  Elem r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = borrow ? t.v[i] : d.v[i];
  return r;
}

template <class F>
__device__ __forceinline__ Elem add(const Elem& a, const Elem& b) {
  // a + b < 2p < 2^256: no carry out of the top limb
  Elem s;
  u32 carry = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 t = (u64)a.v[i] + b.v[i] + carry;
    s.v[i] = (u32)t;
    carry = (u32)(t >> 32);
  }
  return cond_sub_p<F>(s);
}

template <class F>
__device__ __forceinline__ Elem sub(const Elem& a, const Elem& b) {
  Elem d;
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 t = (u64)a.v[i] - b.v[i] - borrow;
    d.v[i] = (u32)t;
    borrow = (u32)(t >> 63);
  }
  if (borrow) {  // a < b: add p back
    u32 carry = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      u64 t = (u64)d.v[i] + F::P(i) + carry;
      d.v[i] = (u32)t;
      carry = (u32)(t >> 32);
    }
  }
  return d;
}

// CIOS Montgomery product a * b * 2^-256 mod p; inputs canonical, output
// canonical.  p < 2^254 keeps the running value below 2p < 2^256.
template <class F>
__device__ __forceinline__ Elem mul(const Elem& a, const Elem& b) {
  u32 t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      u64 s = (u64)a.v[j] * b.v[i] + t[j] + carry;
      t[j] = (u32)s;
      carry = s >> 32;
    }
    u64 s = (u64)t[NL] + carry;
    t[NL] = (u32)s;
    t[NL + 1] = (u32)(s >> 32);
    u32 m = t[0] * F::NP;
    s = (u64)m * F::P(0) + t[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      s = (u64)m * F::P(j) + t[j] + carry;
      t[j - 1] = (u32)s;
      carry = s >> 32;
    }
    s = (u64)t[NL] + carry;
    t[NL - 1] = (u32)s;
    t[NL] = t[NL + 1] + (u32)(s >> 32);
  }
  Elem r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = t[i];
  return cond_sub_p<F>(r);
}

template <class F>
__device__ __forceinline__ Elem sqr(const Elem& a) {
  return mul<F>(a, a);
}

__device__ __forceinline__ bool is_zero(const Elem& a) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= a.v[i];
  return acc == 0u;
}

__device__ __forceinline__ Elem select(bool mask, const Elem& a,
                                       const Elem& b) {
  Elem r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = mask ? a.v[i] : b.v[i];
  return r;
}

// Launch geometry shared by the elementwise kernels: one thread per element.
constexpr int THREADS = 256;

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}

// Threads per block of a redesigned kernel over n threads' work: the power
// of two from 32 to max_threads whose launch gives the busiest SM the
// fewest threads (ceil(blocks / SMs) blocks of it); a smaller block must
// cut that share by more than 1/16.
inline unsigned int balanced_threads(long long n, unsigned int max_threads) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  unsigned int best = max_threads;
  long long best_load = -1;
  for (unsigned int t = max_threads; t >= 32; t /= 2) {
    long long blocks = (n + t - 1) / t;
    long long load = (blocks + sms - 1) / sms * t;
    if (best_load < 0 || load * 16 < best_load * 15) {
      best = t;
      best_load = load;
    }
  }
  return best;
}

}  // namespace aztec
