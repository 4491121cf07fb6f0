// Elliptic-curve group formulas (short Weierstrass, a = 0) on points held in
// registers, shared by the K2 (group_ops.cu), K3 and K5 (rake.cu) and K4
// (bucket.cu) kernels.
//
// Line-for-line mirrors of the formulas of aztec_tpu/curves/group_pallas.py
// (same operation order, same infinity selects), in three layers:
//
//   exact::  canonical field ops of field.cuh.  They take any 16-bit limbs
//            with the reference's semantics (a sum and a REDC reduced mod
//            2^256 before one conditional subtraction of p), so on any input
//            their coordinates are bit-identical to the reference's and to
//            the plain PyTorch formulas of aztec_tpu_torch/curves/group.py.
//   lazy::   the PTX carry-chain arithmetic of field_lazy.cuh, values kept
//            in [0, 2p) inside a formula and only the results reduced.
//            They take canonical inputs (below p): the sums of raw inputs
//            are taken without a correction and `is_zero` reads a raw Z.  On
//            such inputs they return the exact formulas' coordinates.
//   (none)   the entry formulas the kernels call: each tests the top word of
//            every operand it reads against p's, runs the lazy formula when
//            all lie below it (so every operand is below p) and the exact one
//            otherwise.  So the kernels take any 16-bit limbs, as the
//            reference does, at the cost of one compare an operand on the
//            lazy path; a value below p whose top word equals p's takes the
//            exact path, which returns the same limbs.
//
// The lazy formulas return canonical coordinates, so a chain of them (a
// rake's run, K4's sums) stays on the lazy path once its inputs are below
// p; a result of the exact path on an input at or above p may itself lie
// at or above p, and the next formula that reads it tests it again.
#pragma once

#include "field_lazy.cuh"

namespace aztec {

struct Pt {
  Elem x, y, z;
};

// the complete-projective identity (0 : 1 : 0)
template <class F>
__device__ __forceinline__ Pt proj_infinity() {
  Pt out{zero(), one_mont<F>(), zero()};
  return out;
}

// -(X : Y : Z) = (X : 0 - Y : Z), the canonical sub (any limbs)
template <class F>
__device__ __forceinline__ Pt proj_neg(const Pt& P) {
  Pt out{P.x, sub<F>(zero(), P.y), P.z};
  return out;
}

// a top word below p's: a < p (conservative: some a < p answer false)
template <class F>
__device__ __forceinline__ bool below_p(const Elem& a) {
  return a.v[NL - 1] < F::P(NL - 1);
}

template <class F>
__device__ __forceinline__ bool below_p(const Pt& P) {
  return below_p<F>(P.x) & below_p<F>(P.y) & below_p<F>(P.z);
}

// an element from lane `src` of this thread's group of LANES lanes, for a
// formula split over the LANES lanes of a point (every lane of the warp
// takes part)
template <int LANES>
__device__ __forceinline__ Elem shfl(const Elem& a, int src) {
  Elem r;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    r.v[i] = __shfl_sync(0xffffffffu, a.v[i], src, LANES);
  return r;
}

namespace exact {

// Jacobian + affine, 7M + 4S (group_pallas.py `_f_mixed_add_unsafe`); the
// same operations on the same operands, Z3 computed early so that Z1,
// Z1Z1 and HH die before the rest (a rake's step holds this beside its
// lane's state under a register cap)
template <class F>
__device__ __forceinline__ Pt mixed_add_unsafe(const Pt& P, const Elem& X2,
                                               const Elem& Y2) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const bool p_inf = is_zero(Z1);
  Elem Z1Z1 = sqr<F>(Z1);
  Elem S2 = mul<F>(mul<F>(Y2, Z1), Z1Z1);
  Elem H = sub<F>(mul<F>(X2, Z1Z1), X1);
  Elem HH = sqr<F>(H);
  Elem Z3 = sub<F>(sub<F>(sqr<F>(add<F>(Z1, H)), Z1Z1), HH);
  Elem I = add<F>(HH, HH);
  I = add<F>(I, I);
  Elem J = mul<F>(H, I);
  Elem r = sub<F>(S2, Y1);
  r = add<F>(r, r);
  Elem V = mul<F>(X1, I);
  Elem X3 = sub<F>(sub<F>(sqr<F>(r), J), add<F>(V, V));
  Elem YJ = mul<F>(Y1, J);
  Elem Y3 = sub<F>(mul<F>(r, sub<F>(V, X3)), add<F>(YJ, YJ));
  Pt out;
  out.x = select(p_inf, X2, X3);
  out.y = select(p_inf, Y2, Y3);
  out.z = select(p_inf, one_mont<F>(), Z3);
  return out;
}

// Jacobian + Jacobian, 11M + 5S (`_f_add_unsafe`)
template <class F>
__device__ __forceinline__ Pt add_unsafe(const Pt& P, const Pt& Q) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const Elem &X2 = Q.x, &Y2 = Q.y, &Z2 = Q.z;
  Elem Z1Z1 = sqr<F>(Z1);
  Elem Z2Z2 = sqr<F>(Z2);
  Elem U1 = mul<F>(X1, Z2Z2);
  Elem U2 = mul<F>(X2, Z1Z1);
  Elem S1 = mul<F>(mul<F>(Y1, Z2), Z2Z2);
  Elem S2 = mul<F>(mul<F>(Y2, Z1), Z1Z1);
  Elem H = sub<F>(U2, U1);
  Elem I = sqr<F>(add<F>(H, H));
  Elem J = mul<F>(H, I);
  Elem r = sub<F>(S2, S1);
  r = add<F>(r, r);
  Elem V = mul<F>(U1, I);
  Elem X3 = sub<F>(sub<F>(sqr<F>(r), J), add<F>(V, V));
  Elem SJ = mul<F>(S1, J);
  Elem Y3 = sub<F>(mul<F>(r, sub<F>(V, X3)), add<F>(SJ, SJ));
  Elem ZZ = sqr<F>(add<F>(Z1, Z2));
  Elem Z3 = mul<F>(sub<F>(sub<F>(ZZ, Z1Z1), Z2Z2), H);
  bool p_inf = is_zero(Z1);
  bool q_inf = is_zero(Z2);
  Pt out;
  out.x = select(p_inf, X2, select(q_inf, X1, X3));
  out.y = select(p_inf, Y2, select(q_inf, Y1, Y3));
  out.z = select(p_inf, Z2, select(q_inf, Z1, Z3));
  return out;
}

// RCB16 algorithm 7 (a = 0), complete (`_make_proj_add`); the products by
// 3b are full Montgomery products, as the reference's `mul_small`
template <class F>
__device__ __forceinline__ Pt proj_add(const Pt& P, const Pt& Q,
                                       const Elem& b3) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const Elem &X2 = Q.x, &Y2 = Q.y, &Z2 = Q.z;
  Elem t0 = mul<F>(X1, X2);
  Elem t1 = mul<F>(Y1, Y2);
  Elem t2 = mul<F>(Z1, Z2);
  Elem t3 = mul<F>(add<F>(X1, Y1), add<F>(X2, Y2));
  t3 = sub<F>(t3, add<F>(t0, t1));
  Elem t4 = mul<F>(add<F>(Y1, Z1), add<F>(Y2, Z2));
  t4 = sub<F>(t4, add<F>(t1, t2));
  Elem X3 = mul<F>(add<F>(X1, Z1), add<F>(X2, Z2));
  Elem Y3 = sub<F>(X3, add<F>(t0, t2));
  X3 = add<F>(t0, t0);
  t0 = add<F>(X3, t0);
  t2 = mul<F>(t2, b3);
  Elem Z3 = add<F>(t1, t2);
  t1 = sub<F>(t1, t2);
  Y3 = mul<F>(Y3, b3);
  X3 = sub<F>(mul<F>(t3, t1), mul<F>(t4, Y3));
  Y3 = add<F>(mul<F>(t1, Z3), mul<F>(Y3, t0));
  Z3 = add<F>(mul<F>(Z3, t4), mul<F>(t0, t3));
  Pt out;
  out.x = X3;
  out.y = Y3;
  out.z = Z3;
  return out;
}

// `steps` successive RCB16 algorithm 9 doublings (a = 0; `_make_proj_dbl`)
template <class F>
__device__ __forceinline__ Pt proj_dbl(const Pt& P, const Elem& b3,
                                       int steps) {
  Elem X = P.x, Y = P.y, Z = P.z;
  for (int s = 0; s < steps; ++s) {
    Elem t0 = sqr<F>(Y);
    Elem Z3 = add<F>(t0, t0);
    Z3 = add<F>(Z3, Z3);
    Z3 = add<F>(Z3, Z3);
    Elem t1 = mul<F>(Y, Z);
    Elem t2 = mul<F>(sqr<F>(Z), b3);
    Elem X3 = mul<F>(t2, Z3);
    Elem Y3 = add<F>(t0, t2);
    Z3 = mul<F>(t1, Z3);
    t1 = add<F>(t2, t2);
    t2 = add<F>(t1, t2);
    t0 = sub<F>(t0, t2);
    Y3 = add<F>(X3, mul<F>(t0, Y3));
    X3 = mul<F>(t0, mul<F>(X, Y));
    X = add<F>(X3, X3);
    Y = Y3;
    Z = Z3;
  }
  Pt out{X, Y, Z};
  return out;
}

// Jacobian (X : Y : Z) -> complete homogeneous projective (X Z : Y : Z^3);
// infinity (Z = 0) -> (0 : 1 : 0)  (`_f_j2c`)
template <class F>
__device__ __forceinline__ Pt j2c(const Pt& P) {
  Pt out;
  out.x = mul<F>(P.x, P.z);
  out.z = mul<F>(sqr<F>(P.z), P.z);
  out.y = select(is_zero(P.z), one_mont<F>(), P.y);
  return out;
}

}  // namespace exact

namespace lazy {

// Jacobian + affine (7M + 4S): P canonical, (X2, Y2) canonical and finite;
// the canonical Z1 decides infinity
template <class F>
__device__ __forceinline__ Pt mixed_add_unsafe(const Pt& P, const Elem& X2,
                                               const Elem& Y2) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  Elem Z1Z1 = lazy::sqr<F>(Z1);
  Elem U2 = lazy::mul<F>(X2, Z1Z1);
  Elem S2 = lazy::mul<F>(lazy::mul<F>(Y2, Z1), Z1Z1);
  Elem H = lazy::sub<F>(U2, X1);
  Elem HH = lazy::sqr<F>(H);
  Elem I = lazy::add<F>(HH, HH);
  I = lazy::add<F>(I, I);
  Elem J = lazy::mul<F>(H, I);
  Elem r = lazy::sub<F>(S2, Y1);
  r = lazy::add<F>(r, r);
  Elem V = lazy::mul<F>(X1, I);
  Elem X3 = lazy::sub<F>(lazy::sub<F>(lazy::sqr<F>(r), J),
                         lazy::add<F>(V, V));
  Elem YJ = lazy::mul<F>(Y1, J);
  Elem Y3 = lazy::sub<F>(lazy::mul<F>(r, lazy::sub<F>(V, X3)),
                         lazy::add<F>(YJ, YJ));
  Elem ZH = lazy::sqr<F>(lazy::add<F>(Z1, H));
  Elem Z3 = lazy::sub<F>(lazy::sub<F>(ZH, Z1Z1), HH);
  bool p_inf = is_zero(Z1);
  Pt out;
  out.x = select(p_inf, X2, lazy::canon<F>(X3));
  out.y = select(p_inf, Y2, lazy::canon<F>(Y3));
  out.z = select(p_inf, one_mont<F>(), lazy::canon<F>(Z3));
  return out;
}

// Jacobian + Jacobian (11M + 5S) from its first two products, Z1^2 and
// Z2^2; the canonical inputs decide infinity
template <class F>
__device__ __forceinline__ Pt add_unsafe_from(const Pt& P, const Pt& Q,
                                              const Elem& Z1Z1,
                                              const Elem& Z2Z2) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const Elem &X2 = Q.x, &Y2 = Q.y, &Z2 = Q.z;
  Elem U1 = lazy::mul<F>(X1, Z2Z2);
  Elem U2 = lazy::mul<F>(X2, Z1Z1);
  Elem S1 = lazy::mul<F>(lazy::mul<F>(Y1, Z2), Z2Z2);
  Elem S2 = lazy::mul<F>(lazy::mul<F>(Y2, Z1), Z1Z1);
  Elem H = lazy::sub<F>(U2, U1);
  Elem I = lazy::sqr<F>(lazy::add<F>(H, H));
  Elem J = lazy::mul<F>(H, I);
  Elem r = lazy::sub<F>(S2, S1);
  r = lazy::add<F>(r, r);
  Elem V = lazy::mul<F>(U1, I);
  Elem X3 = lazy::sub<F>(lazy::sub<F>(lazy::sqr<F>(r), J),
                         lazy::add<F>(V, V));
  Elem SJ = lazy::mul<F>(S1, J);
  Elem Y3 = lazy::sub<F>(lazy::mul<F>(r, lazy::sub<F>(V, X3)),
                         lazy::add<F>(SJ, SJ));
  // canonical inputs: Z1 + Z2 < 2p
  Elem ZZ = lazy::sqr<F>(lazy::add_nc(Z1, Z2));
  Elem Z3 = lazy::mul<F>(lazy::sub<F>(lazy::sub<F>(ZZ, Z1Z1), Z2Z2), H);
  bool p_inf = is_zero(Z1);
  bool q_inf = is_zero(Z2);
  Pt out;
  out.x = select(p_inf, X2, select(q_inf, X1, lazy::canon<F>(X3)));
  out.y = select(p_inf, Y2, select(q_inf, Y1, lazy::canon<F>(Y3)));
  out.z = select(p_inf, Z2, select(q_inf, Z1, lazy::canon<F>(Z3)));
  return out;
}

// RCB16 algorithm 7 (a = 0) in exact::proj_add's operation order, from its
// first three products t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2; NINE: 3b = 9
// (BN254 G1), so t * 3b is 9t = 8t + t by four additions
template <class F, bool NINE>
__device__ __forceinline__ Pt proj_add_from(const Pt& P, const Pt& Q,
                                            const Elem& b3, Elem t0, Elem t1,
                                            Elem t2) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const Elem &X2 = Q.x, &Y2 = Q.y, &Z2 = Q.z;
  // sums of canonical inputs are below 2p
  Elem t3 = lazy::mul<F>(lazy::add_nc(X1, Y1), lazy::add_nc(X2, Y2));
  t3 = lazy::sub<F>(t3, lazy::add<F>(t0, t1));
  Elem t4 = lazy::mul<F>(lazy::add_nc(Y1, Z1), lazy::add_nc(Y2, Z2));
  t4 = lazy::sub<F>(t4, lazy::add<F>(t1, t2));
  Elem X3 = lazy::mul<F>(lazy::add_nc(X1, Z1), lazy::add_nc(X2, Z2));
  Elem Y3 = lazy::sub<F>(X3, lazy::add<F>(t0, t2));
  X3 = lazy::add<F>(t0, t0);
  t0 = lazy::add<F>(X3, t0);
  t2 = NINE ? lazy::times9<F>(t2) : lazy::mul<F>(t2, b3);
  Elem Z3 = lazy::add<F>(t1, t2);
  t1 = lazy::sub<F>(t1, t2);
  Y3 = NINE ? lazy::times9<F>(Y3) : lazy::mul<F>(Y3, b3);
  X3 = lazy::sub<F>(lazy::mul<F>(t3, t1), lazy::mul<F>(t4, Y3));
  Y3 = lazy::add<F>(lazy::mul<F>(t1, Z3), lazy::mul<F>(Y3, t0));
  Z3 = lazy::add<F>(lazy::mul<F>(Z3, t4), lazy::mul<F>(t0, t3));
  Pt out;
  out.x = lazy::canon<F>(X3);
  out.y = lazy::canon<F>(Y3);
  out.z = lazy::canon<F>(Z3);
  return out;
}

// `steps` successive doublings (RCB16 algorithm 9, a = 0): each doubling's
// inputs and outputs in [0, 2p), only the result reduced; NINE as above
template <class F, bool NINE>
__device__ __forceinline__ Pt proj_dbl(const Pt& P, const Elem& b3,
                                       int steps) {
  Elem X = P.x, Y = P.y, Z = P.z;
  for (int s = 0; s < steps; ++s) {
    Elem t0 = lazy::sqr<F>(Y);
    Elem Z3 = lazy::add<F>(t0, t0);
    Z3 = lazy::add<F>(Z3, Z3);
    Z3 = lazy::add<F>(Z3, Z3);
    Elem t1 = lazy::mul<F>(Y, Z);
    Elem t2 = lazy::sqr<F>(Z);
    t2 = NINE ? lazy::times9<F>(t2) : lazy::mul<F>(t2, b3);
    Elem X3 = lazy::mul<F>(t2, Z3);
    Elem Y3 = lazy::add<F>(t0, t2);
    Z3 = lazy::mul<F>(t1, Z3);
    t1 = lazy::add<F>(t2, t2);
    t2 = lazy::add<F>(t1, t2);
    t0 = lazy::sub<F>(t0, t2);
    Y3 = lazy::add<F>(X3, lazy::mul<F>(t0, Y3));
    X3 = lazy::mul<F>(t0, lazy::mul<F>(X, Y));
    X = lazy::add<F>(X3, X3);
    Y = Y3;
    Z = Z3;
  }
  Pt out;
  out.x = lazy::canon<F>(X);
  out.y = lazy::canon<F>(Y);
  out.z = lazy::canon<F>(Z);
  return out;
}

// Jacobian -> complete projective, as exact::j2c
template <class F>
__device__ __forceinline__ Pt j2c(const Pt& P) {
  Pt out;
  out.x = lazy::canon<F>(lazy::mul<F>(P.x, P.z));
  out.z = lazy::canon<F>(lazy::mul<F>(lazy::sqr<F>(P.z), P.z));
  out.y = select(is_zero(P.z), one_mont<F>(), P.y);
  return out;
}

}  // namespace lazy

// ---- entry formulas: lazy where every operand is below p, else exact ----

template <class F>
__device__ __forceinline__ Pt mixed_add_unsafe(const Pt& P, const Elem& X2,
                                               const Elem& Y2) {
  if (below_p<F>(P) & below_p<F>(X2) & below_p<F>(Y2))
    return lazy::mixed_add_unsafe<F>(P, X2, Y2);
  return exact::mixed_add_unsafe<F>(P, X2, Y2);
}

// The two adds start their first lazy products before the range test, as
// the lazy formula alone does: with the test first, every operand had to
// arrive before any product (the compiler hoisted all 96 loads above the
// branch), and the K2 adds lost 4-6% at the proof's narrow widths.
template <class F>
__device__ __forceinline__ Pt add_unsafe(const Pt& P, const Pt& Q) {
  const Elem Z1Z1 = lazy::sqr<F>(P.z), Z2Z2 = lazy::sqr<F>(Q.z);
  if (below_p<F>(P) & below_p<F>(Q))
    return lazy::add_unsafe_from<F>(P, Q, Z1Z1, Z2Z2);
  return exact::add_unsafe<F>(P, Q);
}

template <class F, bool NINE>
__device__ __forceinline__ Pt proj_add(const Pt& P, const Pt& Q,
                                       const Elem& b3) {
  const Elem t0 = lazy::mul<F>(P.x, Q.x), t1 = lazy::mul<F>(P.y, Q.y),
             t2 = lazy::mul<F>(P.z, Q.z);
  if (below_p<F>(P) & below_p<F>(Q))
    return lazy::proj_add_from<F, NINE>(P, Q, b3, t0, t1, t2);
  return exact::proj_add<F>(P, Q, b3);
}

// the lazy doublings keep a canonical input's values in range through every
// step, so one test of the input decides all `steps`
template <class F, bool NINE>
__device__ __forceinline__ Pt proj_dbl(const Pt& P, const Elem& b3,
                                       int steps) {
  if (below_p<F>(P)) return lazy::proj_dbl<F, NINE>(P, b3, steps);
  return exact::proj_dbl<F>(P, b3, steps);
}

template <class F>
__device__ __forceinline__ Pt j2c(const Pt& P) {
  if (below_p<F>(P)) return lazy::j2c<F>(P);
  return exact::j2c<F>(P);
}

__device__ __forceinline__ Pt load_pt(const u32* X, const u32* Y, const u32* Z,
                                      long long n, long long j) {
  Pt p{load(X, n, j), load(Y, n, j), load(Z, n, j)};
  return p;
}

__device__ __forceinline__ void store_pt(u32* X, u32* Y, u32* Z, long long n,
                                         long long j, const Pt& p) {
  store(X, n, j, p.x);
  store(Y, n, j, p.y);
  store(Z, n, j, p.z);
}

// 9 in Montgomery form (9R mod p, from R mod p by host arithmetic): the b3
// of BN254 G1, for which the lazy formulas compute 3b t as 9t by additions
template <class F>
inline bool is_nine(const Const256& b3) {
  u64 w[NL];
  u64 carry = 0;
  for (int i = 0; i < NL; ++i) {
    u64 t = (u64)F::ONE(i) * 9u + carry;
    w[i] = t & 0xffffffffu;
    carry = t >> 32;
  }
  for (;;) {  // reduce below p: 9R mod p < 9p, at most 8 subtractions
    bool ge = carry != 0;
    if (!ge) {
      ge = true;
      for (int i = NL - 1; i >= 0; --i)
        if (w[i] != F::P(i)) {
          ge = w[i] > F::P(i);
          break;
        }
    }
    if (!ge) break;
    u64 borrow = 0;
    for (int i = 0; i < NL; ++i) {
      u64 t = w[i] - F::P(i) - borrow;
      w[i] = t & 0xffffffffu;
      borrow = (t >> 63) & 1u;
    }
    carry -= borrow;
  }
  for (int i = 0; i < NL; ++i)
    if (b3.v[i] != (u32)w[i]) return false;
  return true;
}

inline Const256 const_from_host(const u32* limbs) {
  Const256 c;
  for (int i = 0; i < NL; ++i) c.v[i] = limbs[i];
  return c;
}

}  // namespace aztec
