// Elliptic-curve group formulas (short Weierstrass, a = 0) on points held in
// registers, and which kernels use them:
//
//   mixed_add_unsafe  lazy (field_lazy.cuh)  K2 gk_mixed_add; K3 and K5
//                                            (rake.cu `rake_step`)
//   proj_dbl          lazy (field_lazy.cuh)  K4's doublings (bucket.cu);
//                                            K2 gk_proj_dbl(_n) runs the
//                                            same steps split over four
//                                            lanes (group_ops.cu)
//   proj_add, j2c     canonical (field.cuh)  K4; j2c also K2 gk_j2c
//   proj_neg, proj_infinity                  K4
//
// K2's gk_add_unsafe and gk_proj_add keep their own formulas on the lazy
// arithmetic (group_ops.cu).
//
// Line-for-line mirrors of the formulas of aztec_tpu/curves/group_pallas.py
// (same operation order, same infinity selects).  The canonical formulas
// return the canonical representative of every field op; the lazy ones
// keep values in [0, 2p) and reduce only their results.  Both take
// canonical inputs, and their coordinates are bit-identical to the plain
// PyTorch formulas of aztec_tpu_torch/curves/group.py.
#pragma once

#include "field_lazy.cuh"

namespace aztec {

struct Pt {
  Elem x, y, z;
};

// Jacobian + affine (7M + 4S) on lazy values: P canonical, (X2, Y2)
// canonical and finite; the canonical Z1 decides infinity, and only the
// formula's result is reduced, so the output is canonical
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
  t2 = mul<F>(t2, b3);  // mul_small(t2, 3b): one full REDC
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

// `steps` successive doublings (RCB16 algorithm 9, a = 0) on lazy values:
// P canonical, each doubling's inputs and outputs in [0, 2p), and only the
// result reduced.  NINE: 3b = 9 (BN254 G1) by additions; any other b keeps
// the product by b3.
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

// Jacobian (X : Y : Z) -> complete homogeneous projective (X Z : Y : Z^3);
// infinity (Z = 0) -> (0 : 1 : 0)  (curves/group_pallas.py `_f_j2c`)
template <class F>
__device__ __forceinline__ Pt j2c(const Pt& P) {
  Pt out;
  out.x = mul<F>(P.x, P.z);
  out.z = mul<F>(sqr<F>(P.z), P.z);
  out.y = select(is_zero(P.z), one_mont<F>(), P.y);
  return out;
}

// -(X : Y : Z) = (X : -Y : Z)
template <class F>
__device__ __forceinline__ Pt proj_neg(const Pt& P) {
  Pt out{P.x, sub<F>(zero(), P.y), P.z};
  return out;
}

// the complete-projective identity (0 : 1 : 0)
template <class F>
__device__ __forceinline__ Pt proj_infinity() {
  Pt out{zero(), one_mont<F>(), zero()};
  return out;
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
// of BN254 G1, for which the formulas compute 3b t as 9t by additions
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
