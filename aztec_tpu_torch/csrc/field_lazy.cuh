// Lazily reduced BN254 Fr / Fq arithmetic for Hopper (sm_90a), written with
// PTX carry chains: the field ops of the redesigned K2 kernels
// (group_ops.cu `add_unsafe_kernel`, `proj_add_kernel`).
//
// Beside field.cuh, not instead of it: the other kernels keep `mul<F>`,
// `add<F>`, `sub<F>` until their own redesign.  Same representation (8 x
// 32-bit limbs, Montgomery form with R = 2^256), but values stay in
// [0, 2p) inside a formula instead of [0, p):
//
// - p < 2^254 for both fields, so 4p < 2^256: a sum of two values below 2p
//   fits in 256 bits, and a Montgomery product of a, b < 2p is below
//   ab / R + p < 4p^2 / R + p < 2p with no final subtraction;
// - `add` and `sub` bring their result back into [0, 2p) with one
//   branch-free masked correction by 2p;
// - `canon` maps [0, 2p) to the canonical [0, p) (a lazy p stores as 0); a
//   kernel applies it only to the coordinates it stores.
//
// Every value is congruent mod p to what the canonical ops of field.cuh
// compute, so the stored coordinates are bit-identical to theirs.
//
// The product is CIOS with the even / odd split of GPU MSM libraries
// (sppark's mont_t): the partial products a[j] * b[i] of even j fill
// disjoint word pairs of one accumulator and those of odd j of another, so
// each row is two unbroken `mad.lo.cc` / `madc.hi.cc` chains that ptxas can
// issue as wide multiply-adds with carry, where the C form of field.cuh
// spends separate adds on every carry.  A chain's carry flag passes from
// one asm statement to the next; every statement is volatile, so none is
// reordered, and no code between them writes the flag.
#pragma once

#include "field.cuh"

namespace aztec {
namespace lazy {

// limb i of 2p
template <class F>
__host__ __device__ constexpr u32 P2(int i) {
  return (F::P(i) << 1) | (i ? F::P(i - 1) >> 31 : 0u);
}

// acc[j], acc[j + 1] = a[j + OFF] * bi for even j
template <int OFF>
__device__ __forceinline__ void mul_n(u32* acc, const u32* a, u32 bi) {
#pragma unroll
  for (int j = 0; j < NL; j += 2)
    asm volatile("mul.lo.u32 %0, %2, %3; mul.hi.u32 %1, %2, %3;"
                 : "=r"(acc[j]), "=r"(acc[j + 1])
                 : "r"(a[j + OFF]), "r"(bi));
}

// acc += sum over even j of a[j + OFF] * bi at words j, j + 1; the carry
// out of word NL - 1 is left in the flag
template <int OFF>
__device__ __forceinline__ void cmad_n(u32* acc, const u32* a, u32 bi) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(acc[0]), "+r"(acc[1])
               : "r"(a[OFF]), "r"(bi));
#pragma unroll
  for (int j = 2; j < NL; j += 2)
    asm volatile(
        "madc.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
        : "+r"(acc[j]), "+r"(acc[j + 1])
        : "r"(a[j + OFF]), "r"(bi));
}

// the same with the modulus: acc += sum over even j of p[j + OFF] * m
template <class F, int OFF>
__device__ __forceinline__ void cmad_p(u32* acc, u32 m) {
  u32 p[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) p[j] = F::P(j);
  cmad_n<OFF>(acc, p, m);
}

// odd <- (odd >> 64 bits) + sum over odd j of a[j] * bi at words j - 1, j,
// taking the flag in at word 0
__device__ __forceinline__ void madc_n_rshift(u32* odd, const u32* a, u32 bi) {
#pragma unroll
  for (int j = 0; j < NL - 2; j += 2)
    asm volatile(
        "madc.lo.cc.u32 %0, %2, %3, %4; madc.hi.cc.u32 %1, %2, %3, %5;"
        : "=r"(odd[j]), "=r"(odd[j + 1])
        : "r"(a[j + 1]), "r"(bi), "r"(odd[j + 2]), "r"(odd[j + 3]));
  asm volatile("madc.lo.cc.u32 %0, %2, %3, 0; madc.hi.u32 %1, %2, %3, 0;"
               : "=r"(odd[NL - 2]), "=r"(odd[NL - 1])
               : "r"(a[NL - 1]), "r"(bi));
}

// One CIOS row: the accumulator even + 2^32 odd (shifted one word by the
// previous row) takes a * bi, then m * p with m chosen so that its low word
// cancels.  The next row swaps the two arrays' roles.
template <class F>
__device__ __forceinline__ void mad_n_redc(u32* even, u32* odd, const u32* a,
                                           u32 bi, bool first) {
  if (first) {
    mul_n<1>(odd, a, bi);
    mul_n<0>(even, a, bi);
  } else {
    asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(even[0]) : "r"(odd[1]));
    madc_n_rshift(odd, a, bi);
    cmad_n<0>(even, a, bi);
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(odd[NL - 1]));
  }
  u32 m = even[0] * F::NP;
  // the running value stays below (a + p) 2^32 < 2^288: the odd chain
  // never carries out of its top word
  cmad_p<F, 1>(odd, m);
  cmad_p<F, 0>(even, m);
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(odd[NL - 1]));
}

// a * b * 2^-256 mod p for a, b in [0, 2p); result in [0, 2p)
template <class F>
__device__ __forceinline__ Elem mul(const Elem& a, const Elem& b) {
  u32 even[NL], odd[NL];
#pragma unroll
  for (int i = 0; i < NL; i += 2) {
    mad_n_redc<F>(even, odd, a.v, b.v[i], i == 0);
    mad_n_redc<F>(odd, even, a.v, b.v[i + 1], false);
  }
  // merge: the value is (odd >> 32) + even
  Elem r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r.v[0]) : "r"(even[0]),
               "r"(odd[1]));
#pragma unroll
  for (int i = 1; i < NL - 1; ++i)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r.v[i]) : "r"(even[i]),
                 "r"(odd[i + 1]));
  asm volatile("addc.u32 %0, %1, 0;" : "=r"(r.v[NL - 1]) : "r"(even[NL - 1]));
  return r;
}

template <class F>
__device__ __forceinline__ Elem sqr(const Elem& a) {
  return lazy::mul<F>(a, a);
}

// a + b, with no correction: the caller knows a + b < 2p (e.g. both
// canonical)
__device__ __forceinline__ Elem add_nc(const Elem& a, const Elem& b) {
  Elem s;
  asm volatile(
      "add.cc.u32 %0, %8, %16; addc.cc.u32 %1, %9, %17;"
      "addc.cc.u32 %2, %10, %18; addc.cc.u32 %3, %11, %19;"
      "addc.cc.u32 %4, %12, %20; addc.cc.u32 %5, %13, %21;"
      "addc.cc.u32 %6, %14, %22; addc.u32 %7, %15, %23;"
      : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]),
        "=r"(s.v[4]), "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  return s;
}

// t - c (c = p or 2p, limb by limb in C), kept where t < c: a
// branch-free select on the final borrow
template <class C>
__device__ __forceinline__ Elem sub_if_ge(const Elem& t) {
  Elem d;
  u32 keep;
  asm volatile(
      "sub.cc.u32 %0, %9, %17; subc.cc.u32 %1, %10, %18;"
      "subc.cc.u32 %2, %11, %19; subc.cc.u32 %3, %12, %20;"
      "subc.cc.u32 %4, %13, %21; subc.cc.u32 %5, %14, %22;"
      "subc.cc.u32 %6, %15, %23; subc.cc.u32 %7, %16, %24;"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(keep)
      : "r"(t.v[0]), "r"(t.v[1]), "r"(t.v[2]), "r"(t.v[3]), "r"(t.v[4]),
        "r"(t.v[5]), "r"(t.v[6]), "r"(t.v[7]), "r"(C::W(0)), "r"(C::W(1)),
        "r"(C::W(2)), "r"(C::W(3)), "r"(C::W(4)), "r"(C::W(5)),
        "r"(C::W(6)), "r"(C::W(7)));
  // keep = all ones where t < c
  Elem r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = (t.v[i] & keep) | (d.v[i] & ~keep);
  return r;
}

template <class F>
struct ModP {
  __host__ __device__ static constexpr u32 W(int i) { return F::P(i); }
};

template <class F>
struct Mod2P {
  __host__ __device__ static constexpr u32 W(int i) { return P2<F>(i); }
};

// a + b mod p for a, b in [0, 2p); result in [0, 2p)
template <class F>
__device__ __forceinline__ Elem add(const Elem& a, const Elem& b) {
  return sub_if_ge<Mod2P<F>>(add_nc(a, b));
}

// a - b mod p for a, b in [0, 2p); result in [0, 2p): 2p added back
// where the difference borrowed
template <class F>
__device__ __forceinline__ Elem sub(const Elem& a, const Elem& b) {
  Elem d;
  u32 mask;
  asm volatile(
      "sub.cc.u32 %0, %9, %17; subc.cc.u32 %1, %10, %18;"
      "subc.cc.u32 %2, %11, %19; subc.cc.u32 %3, %12, %20;"
      "subc.cc.u32 %4, %13, %21; subc.cc.u32 %5, %14, %22;"
      "subc.cc.u32 %6, %15, %23; subc.cc.u32 %7, %16, %24;"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(mask)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  Elem c;
#pragma unroll
  for (int i = 0; i < NL; ++i) c.v[i] = P2<F>(i) & mask;
  return add_nc(d, c);
}

// [0, 2p) -> [0, p)
template <class F>
__device__ __forceinline__ Elem canon(const Elem& t) {
  return sub_if_ge<ModP<F>>(t);
}

// 9t = 8t + t by four additions: 3b for b = 3 (BN254 G1), congruent to the
// Montgomery product of t by 9R
template <class F>
__device__ __forceinline__ Elem times9(const Elem& t) {
  Elem u = lazy::add<F>(t, t);
  u = lazy::add<F>(u, u);
  u = lazy::add<F>(u, u);
  return lazy::add<F>(u, t);
}

}  // namespace lazy
}  // namespace aztec
