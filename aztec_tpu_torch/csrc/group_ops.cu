// K2: whole elliptic-curve group formulas (short Weierstrass, a = 0) over
// (16, n) limb planes, one thread per point (proj_dbl_n: four).
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
// Every coordinate is bit-identical to the TPU formulas'.
//
// Redesigned for the card, in the order of the 2^17 proof's device time:
// gk_add_unsafe and gk_proj_add (first), gk_proj_dbl_n and gk_proj_dbl,
// its one-step launch (second); gk_mixed_add and gk_j2c run the entry
// formulas of group.cuh.  gk_c2j keeps the canonical arithmetic of
// field.cuh, one thread per point in 256-thread blocks.  Each design step
// below was kept only where it measured faster at the proof's widths on
// one card against the step before, and every kernel stays bit-exact with
// its plain version; PERF.md has each step's times, registers and SASS,
// from `python3 chip_smoke.py --redesigned` and the design-step builds
// it records.
//
// What bounds them: a wide launch by the multiply-adds of its products at
// the card's 32-bit multiply-add rate; a narrow one (the proof's folds run
// proj_dbl_n on 1 to 3 points) by the latency of one chain of dependent
// products, since the carry-chain statements of a product issue in order.
//
// add_unsafe and proj_add:
// 1. Arithmetic (field_lazy.cuh): Montgomery products as PTX carry chains
//    (the even / odd CIOS of GPU MSM libraries), which ptxas issues as one
//    wide IMAD per 32 x 32 multiply-add with its carries, where the C form
//    of field.cuh spends separate adds on the carries; lazy reduction:
//    values stay in [0, 2p), a product takes no final subtraction, an add
//    or sub corrects by 2p without a branch, and only the stored
//    coordinates are reduced to [0, p).  The infinity tests and selects of
//    add_unsafe read the canonical inputs.
// 2. proj_add for b = 3 (BN254 G1, 3b = 9): t2 * 3b and Y3 * 3b become
//    9t = 8t + t, four lazy additions each.  The entry point compares the
//    b3 it is given with 9 in Montgomery form (group.cuh `is_nine`); any
//    other b keeps the products.
// 3. Registers and geometry: `__launch_bounds__` caps the registers where
//    no spill follows (PA_ and AU_ below), and the entry points choose the
//    block size from n so that the busiest SM gets the fewest points.
// Dropped: 8 threads a point for narrow launches (one of the 6
// independent products of each level on each, exchanged by shuffles): no
// faster at 8,192 points, slower in the profiled proof.
//
// proj_dbl_n:
// 1. group.cuh `proj_dbl` on lazy values through all `steps` doublings,
//    9t by additions for b = 3, only the stored coordinates reduced.
// 2. Four lanes a point (DBL_LANES): a doubling's independent products run
//    on separate lanes, Y^2, YZ, Z^2, XY, then t2 Z3, t1 Z3, t0 Y3, t0 XY,
//    exchanged by `__shfl_sync`, so a doubling waits on two products
//    instead of eight (three for b != 3).  Faster than step 1 at every
//    width measured, the proof's narrow ones and 8,192 points alike.
//
// Inputs: any 16-bit limbs, as the reference takes.  Each kernel runs the
// entry formulas of group.cuh, which take the lazy path above where every
// operand of a point lies below p and the exact (canonical field.cuh)
// formula otherwise; proj_dbl_n decides once a warp, since its four lanes a
// point exchange products by shuffles: a warp that holds a coordinate at or
// above p runs the exact doublings one thread a point.  The exact formulas
// are inlined, so no call frame comes with them.  Measured against the
// lazy-only kernels on one card (PERF.md): the range test ahead of the
// formula made the two adds wait on all 96 loads before their first
// product (4-6% slower at 8,192-24,576 points), so they start their first
// lazy products before it; proj_add then spilled under its cap of 128
// registers and now runs in blocks of 128 under a cap of 170 (157 used).
#include "group.cuh"

// step 3: each kernel's largest block and the blocks an SM must hold; the
// register cap they imply, 65536 / (threads x blocks), leaves no spill
constexpr int PA_THREADS = 128, PA_BLOCKS = 3;  // proj_add: 170 registers
// (b = 3; 256 x 2, a cap of 128, spilled beside the inlined exact
// formula; any other b keeps the products by 3b and runs uncapped)
constexpr int AU_THREADS = 128, AU_BLOCKS = 3;  // add_unsafe: 168
// proj_dbl_n: lanes a point, and the largest block
constexpr int DBL_LANES = 4, DBL_THREADS = 128;

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
__global__ void __launch_bounds__(AU_THREADS, AU_BLOCKS) add_unsafe_kernel(
    const u32* X1, const u32* Y1, const u32* Z1, const u32* X2, const u32* Y2,
    const u32* Z2, u32* X3, u32* Y3, u32* Z3, long long n) {
  INDEX
  Pt R = add_unsafe<F>(load_pt(X1, Y1, Z1, n, j), load_pt(X2, Y2, Z2, n, j));
  store_pt(X3, Y3, Z3, n, j, R);
}

template <class F, bool NINE>
__global__ void __launch_bounds__(PA_THREADS, NINE ? PA_BLOCKS : 1)
    proj_add_kernel(
    const u32* X1, const u32* Y1, const u32* Z1, const u32* X2, const u32* Y2,
    const u32* Z2, u32* X3, u32* Y3, u32* Z3, Const256 b3, long long n) {
  INDEX
  Pt R = proj_add<F, NINE>(load_pt(X1, Y1, Z1, n, j),
                           load_pt(X2, Y2, Z2, n, j), from_const(b3));
  store_pt(X3, Y3, Z3, n, j, R);
}

// group.cuh `proj_dbl` split over the DBL_LANES lanes of a point: each
// level's independent products run on separate lanes (level 1: Y^2, YZ,
// Z^2, XY; level 2: t2 Z3, t1 Z3, t0 Y3, t0 XY), so a doubling waits on
// two products instead of eight.  The sums between them are computed on
// every lane from the products shuffled in.  Lanes past n load point n - 1
// (every lane of the warp takes part in the shuffles) and store nothing.
template <class F, bool NINE>
__global__ void __launch_bounds__(DBL_THREADS) proj_dbl_n_kernel(
    const u32* X1, const u32* Y1, const u32* Z1, u32* X3, u32* Y3, u32* Z3,
    Const256 b3c, int steps, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long j = t / DBL_LANES;
  const int r = threadIdx.x % DBL_LANES;
  const long long jl = j < n ? j : n - 1;
  const Elem b3 = from_const(b3c);
  Elem X = load(X1, n, jl), Y = load(Y1, n, jl), Z = load(Z1, n, jl);
  // all four lanes of a point, and every point of the warp, take one branch:
  // a warp that holds a coordinate at or above p runs the exact doublings,
  // each lane the whole formula for its point
  if (!__all_sync(0xffffffffu, below_p<F>(Pt{X, Y, Z}))) {
    const Pt R = exact::proj_dbl<F>(Pt{X, Y, Z}, b3, steps);
    if (j >= n) return;
    if (r == 3) store(X3, n, j, R.x);
    if (r == 0) store(Y3, n, j, R.y);
    if (r == 1) store(Z3, n, j, R.z);
    return;
  }
  for (int s = 0; s < steps; ++s) {
    Elem m1 = lazy::mul<F>(select(r == 3, X, select(r == 2, Z, Y)),
                           select(r == 0 || r == 3, Y, Z));
    const Elem t0 = shfl<DBL_LANES>(m1, 0);  // Y^2; lane 1 YZ, lane 3 XY
    Elem t2 = shfl<DBL_LANES>(m1, 2);        // Z^2
    t2 = NINE ? lazy::times9<F>(t2) : lazy::mul<F>(t2, b3);
    Elem z3 = lazy::add<F>(t0, t0);  // 8 t0
    z3 = lazy::add<F>(z3, z3);
    z3 = lazy::add<F>(z3, z3);
    const Elem y3 = lazy::add<F>(t0, t2);
    const Elem t0x = lazy::sub<F>(t0, lazy::add<F>(lazy::add<F>(t2, t2), t2));
    Elem m2 = lazy::mul<F>(select(r == 0, t2, select(r == 1, m1, t0x)),
                           select(r <= 1, z3, select(r == 2, y3, m1)));
    Y = lazy::add<F>(shfl<DBL_LANES>(m2, 0), shfl<DBL_LANES>(m2, 2));
    Z = shfl<DBL_LANES>(m2, 1);
    X = lazy::add<F>(m2, m2);  // lane 3's; only lane 3 reads X
  }
  if (j >= n) return;
  if (r == 3) store(X3, n, j, lazy::canon<F>(X));
  if (r == 0) store(Y3, n, j, lazy::canon<F>(Y));
  if (r == 1) store(Z3, n, j, lazy::canon<F>(Z));
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
  unsigned int threads = balanced_threads(n, AU_THREADS);
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    add_unsafe_kernel<Fr><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, Z2,
                                                     X3, Y3, Z3, n);
  else if (field == 1)
    add_unsafe_kernel<Fq><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, Z2,
                                                     X3, Y3, Z3, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// b3: host pointer to the 8 32-bit limbs of 3b in Montgomery form
int gk_proj_add(int field, const u32* X1, const u32* Y1, const u32* Z1,
                const u32* X2, const u32* Y2, const u32* Z2, u32* X3, u32* Y3,
                u32* Z3, const u32* b3, long long n, void* stream) {
  Const256 c = const_from_host(b3);
  unsigned int threads = balanced_threads(n, PA_THREADS);
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define PROJ_ADD(F, NINE)                                               \
  proj_add_kernel<F, NINE><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, \
                                                      Z2, X3, Y3, Z3, c, n)
  if (field == 0) {
    if (is_nine<Fr>(c)) PROJ_ADD(Fr, true);
    else PROJ_ADD(Fr, false);
  } else if (field == 1) {
    if (is_nine<Fq>(c)) PROJ_ADD(Fq, true);
    else PROJ_ADD(Fq, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PROJ_ADD
  return (int)cudaGetLastError();
}

// b3: host pointer to the 8 32-bit limbs of 3b in Montgomery form
int gk_proj_dbl_n(int field, const u32* X1, const u32* Y1, const u32* Z1,
                  u32* X3, u32* Y3, u32* Z3, const u32* b3, int steps,
                  long long n, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  Const256 c = const_from_host(b3);
  const long long nt = n * DBL_LANES;
  unsigned int threads = balanced_threads(nt, DBL_THREADS);
  unsigned int blocks = (unsigned int)((nt + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define PROJ_DBL(F, NINE)                                                  \
  proj_dbl_n_kernel<F, NINE><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X3, Y3, \
                                                        Z3, c, steps, n)
  if (field == 0) {
    if (is_nine<Fr>(c)) PROJ_DBL(Fr, true);
    else PROJ_DBL(Fr, false);
  } else if (field == 1) {
    if (is_nine<Fq>(c)) PROJ_DBL(Fq, true);
    else PROJ_DBL(Fq, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PROJ_DBL
  return (int)cudaGetLastError();
}

// one doubling: gk_proj_dbl_n with steps = 1
int gk_proj_dbl(int field, const u32* X1, const u32* Y1, const u32* Z1,
                u32* X3, u32* Y3, u32* Z3, const u32* b3, long long n,
                void* stream) {
  return gk_proj_dbl_n(field, X1, Y1, Z1, X3, Y3, Z3, b3, 1, n, stream);
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
