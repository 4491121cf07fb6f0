// Elliptic-curve group formulas (short Weierstrass, a = 0) on points held in
// registers, shared by the kernels of group_ops.cu (K2), rake.cu (K3, K5) and
// bucket.cu (K4).
//
// Line-for-line mirrors of the formulas of aztec_tpu/curves/group_pallas.py
// (same operation order, same infinity selects); every field op returns the
// canonical representative, so the coordinates are bit-identical to the
// plain PyTorch formulas of aztec_tpu_torch/curves/group.py.
#pragma once

#include "field.cuh"

namespace aztec {

struct Pt {
  Elem x, y, z;
};

template <class F>
__device__ __forceinline__ Pt mixed_add_unsafe(const Pt& P, const Elem& X2,
                                               const Elem& Y2) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  Elem Z1Z1 = sqr<F>(Z1);
  Elem U2 = mul<F>(X2, Z1Z1);
  Elem S2 = mul<F>(mul<F>(Y2, Z1), Z1Z1);
  Elem H = sub<F>(U2, X1);
  Elem HH = sqr<F>(H);
  Elem I = add<F>(HH, HH);
  I = add<F>(I, I);
  Elem J = mul<F>(H, I);
  Elem r = sub<F>(S2, Y1);
  r = add<F>(r, r);
  Elem V = mul<F>(X1, I);
  Elem r2 = sqr<F>(r);
  Elem X3 = sub<F>(sub<F>(r2, J), add<F>(V, V));
  Elem YJ = mul<F>(Y1, J);
  Elem Y3 = sub<F>(mul<F>(r, sub<F>(V, X3)), add<F>(YJ, YJ));
  Elem ZH = sqr<F>(add<F>(Z1, H));
  Elem Z3 = sub<F>(sub<F>(ZH, Z1Z1), HH);
  bool p_inf = is_zero(Z1);
  Pt out;
  out.x = select(p_inf, X2, X3);
  out.y = select(p_inf, Y2, Y3);
  out.z = select(p_inf, one_mont<F>(), Z3);
  return out;
}

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
  Elem H2 = add<F>(H, H);
  Elem I = sqr<F>(H2);
  Elem J = mul<F>(H, I);
  Elem r = sub<F>(S2, S1);
  r = add<F>(r, r);
  Elem V = mul<F>(U1, I);
  Elem r2 = sqr<F>(r);
  Elem X3 = sub<F>(sub<F>(r2, J), add<F>(V, V));
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

template <class F>
__device__ __forceinline__ Pt proj_dbl(const Pt& P, const Elem& b3) {
  const Elem &X = P.x, &Y = P.y, &Z = P.z;
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
  X3 = add<F>(X3, X3);
  Pt out;
  out.x = X3;
  out.y = Y3;
  out.z = Z3;
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

inline Const256 const_from_host(const u32* limbs) {
  Const256 c;
  for (int i = 0; i < NL; ++i) c.v[i] = limbs[i];
  return c;
}

}  // namespace aztec
