// K2: whole elliptic-curve group formulas (short Weierstrass, a = 0) over
// (16, n) limb planes, one thread per point.
//
// Replaces the group-formula kernels of aztec_tpu/curves/group_pallas.py
// (built on the elementwise factory of ff/pallas_field.py):
//   gk_mixed_add     <- _f_mixed_add_unsafe  Jacobian + affine, 7M + 4S
//   gk_add_unsafe    <- _f_add_unsafe        Jacobian + Jacobian, 11M + 5S
//   gk_proj_add      <- _make_proj_add       RCB16 algorithm 7, complete
//   gk_proj_dbl      <- _make_proj_dbl       RCB16 algorithm 9, one doubling
//   gk_proj_dbl_n    <- _make_proj_dbl_n     `steps` RCB16 alg. 9 doublings
//   gk_j2c           <- _f_j2c               Jacobian -> homogeneous projective
//   gk_c2j           <- _f_c2j               projective -> Jacobian
// The formulas live in group.cuh (line-for-line mirrors of the TPU
// formulas), so the coordinates are bit-identical.
//
// Bound on an H100: a mixed add reads 5 x 64 bytes and writes 3 x 64 bytes
// per point against ~11 Montgomery products of 128 32-bit multiply-adds
// each; at 2^14..2^19 points the integer multiply rate bounds it, so the
// design keeps all intermediates in registers (no shared memory) and
// touches device memory only for the inputs and outputs.  `gk_proj_dbl`
// runs at width 1 on its path (the fixed-base window tables double one
// base point), where one launch of one thread is bound by the launch
// itself; batching the doublings of a window (`gk_proj_dbl_n`) is left to
// a later change, since the reference's `fixed_base.py` doubles one step at
// a time.
#include "group.cuh"

using namespace aztec;

namespace {

#define INDEX                                                      \
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; \
  if (j >= n) return;

template <class F>
__global__ void mixed_add_kernel(const u32* X1, const u32* Y1, const u32* Z1,
                                 const u32* X2, const u32* Y2, u32* X3, u32* Y3,
                                 u32* Z3, long long n) {
  INDEX
  Pt R = mixed_add_unsafe<F>(load_pt(X1, Y1, Z1, n, j), load(X2, n, j),
                             load(Y2, n, j));
  store_pt(X3, Y3, Z3, n, j, R);
}

template <class F>
__global__ void add_unsafe_kernel(const u32* X1, const u32* Y1, const u32* Z1,
                                  const u32* X2, const u32* Y2, const u32* Z2,
                                  u32* X3, u32* Y3, u32* Z3, long long n) {
  INDEX
  Pt R = add_unsafe<F>(load_pt(X1, Y1, Z1, n, j), load_pt(X2, Y2, Z2, n, j));
  store_pt(X3, Y3, Z3, n, j, R);
}

template <class F>
__global__ void proj_add_kernel(const u32* X1, const u32* Y1, const u32* Z1,
                                const u32* X2, const u32* Y2, const u32* Z2,
                                u32* X3, u32* Y3, u32* Z3, Const256 b3,
                                long long n) {
  INDEX
  Pt R = proj_add<F>(load_pt(X1, Y1, Z1, n, j), load_pt(X2, Y2, Z2, n, j),
                     from_const(b3));
  store_pt(X3, Y3, Z3, n, j, R);
}

template <class F>
__global__ void proj_dbl_n_kernel(const u32* X1, const u32* Y1, const u32* Z1,
                                  u32* X3, u32* Y3, u32* Z3, Const256 b3,
                                  int steps, long long n) {
  INDEX
  Pt P = load_pt(X1, Y1, Z1, n, j);
  Elem b = from_const(b3);
  for (int s = 0; s < steps; ++s) P = proj_dbl<F>(P, b);
  store_pt(X3, Y3, Z3, n, j, P);
}

template <class F>
__global__ void j2c_kernel(const u32* X1, const u32* Y1, const u32* Z1,
                           u32* X3, u32* Y3, u32* Z3, long long n) {
  INDEX
  store_pt(X3, Y3, Z3, n, j, j2c<F>(load_pt(X1, Y1, Z1, n, j)));
}

template <class F>
__global__ void c2j_kernel(const u32* X1, const u32* Y1, const u32* Z1,
                           u32* X3, u32* Y3, u32* Z3, long long n) {
  INDEX
  Elem X = load(X1, n, j), Y = load(Y1, n, j), Z = load(Z1, n, j);
  store(X3, n, j, mul<F>(X, Z));
  store(Y3, n, j, mul<F>(Y, sqr<F>(Z)));
  store(Z3, n, j, Z);
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

int gk_mixed_add(int field, const u32* X1, const u32* Y1, const u32* Z1,
                 const u32* X2, const u32* Y2, u32* X3, u32* Y3, u32* Z3,
                 long long n, void* stream) {
  DISPATCH(field, mixed_add_kernel, X1, Y1, Z1, X2, Y2, X3, Y3, Z3, n);
  return (int)cudaGetLastError();
}

int gk_add_unsafe(int field, const u32* X1, const u32* Y1, const u32* Z1,
                  const u32* X2, const u32* Y2, const u32* Z2, u32* X3,
                  u32* Y3, u32* Z3, long long n, void* stream) {
  DISPATCH(field, add_unsafe_kernel, X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n);
  return (int)cudaGetLastError();
}

// b3: host pointer to the 8 32-bit limbs of 3b in Montgomery form
int gk_proj_add(int field, const u32* X1, const u32* Y1, const u32* Z1,
                const u32* X2, const u32* Y2, const u32* Z2, u32* X3, u32* Y3,
                u32* Z3, const u32* b3, long long n, void* stream) {
  Const256 c = const_from_host(b3);
  DISPATCH(field, proj_add_kernel, X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, c, n);
  return (int)cudaGetLastError();
}

// one doubling: the loop body of gk_proj_dbl_n, launched with steps = 1
int gk_proj_dbl(int field, const u32* X1, const u32* Y1, const u32* Z1,
                u32* X3, u32* Y3, u32* Z3, const u32* b3, long long n,
                void* stream) {
  Const256 c = const_from_host(b3);
  DISPATCH(field, proj_dbl_n_kernel, X1, Y1, Z1, X3, Y3, Z3, c, 1, n);
  return (int)cudaGetLastError();
}

int gk_proj_dbl_n(int field, const u32* X1, const u32* Y1, const u32* Z1,
                  u32* X3, u32* Y3, u32* Z3, const u32* b3, int steps,
                  long long n, void* stream) {
  Const256 c = const_from_host(b3);
  DISPATCH(field, proj_dbl_n_kernel, X1, Y1, Z1, X3, Y3, Z3, c, steps, n);
  return (int)cudaGetLastError();
}

int gk_j2c(int field, const u32* X1, const u32* Y1, const u32* Z1, u32* X3,
           u32* Y3, u32* Z3, long long n, void* stream) {
  DISPATCH(field, j2c_kernel, X1, Y1, Z1, X3, Y3, Z3, n);
  return (int)cudaGetLastError();
}

int gk_c2j(int field, const u32* X1, const u32* Y1, const u32* Z1, u32* X3,
           u32* Y3, u32* Z3, long long n, void* stream) {
  DISPATCH(field, c2j_kernel, X1, Y1, Z1, X3, Y3, Z3, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
