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
// Every coordinate is bit-identical to the TPU formulas'.
//
// gk_add_unsafe and gk_proj_add, the two kernels on which a 2^17 proof
// spent the most device time, are redesigned for the card.  The other five
// keep the canonical arithmetic of field.cuh and the formulas of group.cuh,
// one thread per point in 256-thread blocks, until their own redesign.
//
// The redesign, each step kept because it measured faster at the proof's
// widths and stayed bit-exact (PERF.md, "K2 redesign", has each step's
// device times at the proof's four widths, from `python3 chip_smoke.py --k2`
// on an NVIDIA H100 80GB HBM3 at 700 W):
//
// 1. Arithmetic (field_lazy.cuh): Montgomery products as PTX carry chains
//    (the even / odd CIOS of GPU MSM libraries), which ptxas issues as one
//    IMAD.WIDE per 32 x 32 multiply-add with its carries (136 IMADs a
//    product, where the C form of field.cuh spends about 270 IMADs and as
//    many IADD3s), and lazy reduction: values stay in [0, 2p), a product
//    takes no final subtraction, an add or sub corrects by 2p without a
//    branch, and only the stored coordinates are reduced to [0, p).  The
//    infinity tests and selects of add_unsafe read the canonical inputs.
//    It cut about two thirds of both kernels' wide-launch time.
// 2. proj_add for b = 3 (BN254 G1, 3b = 9): t2 * 3b and Y3 * 3b become
//    9t = 8t + t, four lazy additions each, instead of two of 14 products.
//    The entry point compares the b3 it is given with 9 in Montgomery
//    form; any other b keeps the products.
// 3. Registers and geometry: `__launch_bounds__` caps the registers where
//    no spill follows (proj_add 128 registers, 2 blocks of 256 an SM;
//    add_unsafe 168, 3 blocks of 128; at 128 it spilled), and the entry
//    points choose the block size from n so that the busiest SM gets the
//    fewest points: the proof's 8,192- and 24,576-lane launches reach every
//    SM in 64-thread blocks.  It cut about 30% at 8,192 lanes.
//
// A fourth step, 8 threads a point for narrow launches (each computing one
// of the 6 independent products of each level, exchanged by warp
// shuffles), was no faster at 8,192 points and made the profiled proof's
// proj_add time longer; it is not kept.
//
// Precondition: every input coordinate is canonical (below p), as every
// caller's points are.  The sums of raw inputs (X1 + Y1, Z1 + Z2) are taken
// without a correction and `is_zero` reads the raw Z, so on limbs at or
// above p these two kernels leave the plain formulas, which reduce any
// 256-bit operand first.
//
// What bounds them: the multiply-adds of their products at 64 per clock
// per SM (264 a product); their SASS takes about half that at the issue
// rate of 128 per clock.  `chip_smoke.py` prints both, with registers and
// spills from `cuobjdump -res-usage`; PERF.md keeps the numbers.
#include "field_lazy.cuh"
#include "group.cuh"

// step 3: each kernel's largest block and the blocks an SM must hold; the
// register cap they imply, 65536 / (threads x blocks), leaves no spill
constexpr int PA_THREADS = 256, PA_BLOCKS = 2;  // proj_add: 128 registers
constexpr int AU_THREADS = 128, AU_BLOCKS = 3;  // add_unsafe: 168

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

// Jacobian + Jacobian (11M + 5S) on lazy values; the canonical inputs
// decide infinity, and only the result of the formula is reduced
template <class F>
__device__ __forceinline__ Pt add_unsafe_lazy(const Pt& P, const Pt& Q) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const Elem &X2 = Q.x, &Y2 = Q.y, &Z2 = Q.z;
  Elem Z1Z1 = lazy::sqr<F>(Z1);
  Elem Z2Z2 = lazy::sqr<F>(Z2);
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

// RCB16 algorithm 7 (a = 0) on lazy values, the operation order of
// group.cuh `proj_add`; NINE: 3b = 9 by additions
template <class F, bool NINE>
__device__ __forceinline__ Pt proj_add_lazy(const Pt& P, const Pt& Q,
                                            const Elem& b3) {
  const Elem &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const Elem &X2 = Q.x, &Y2 = Q.y, &Z2 = Q.z;
  Elem t0 = lazy::mul<F>(X1, X2);
  Elem t1 = lazy::mul<F>(Y1, Y2);
  Elem t2 = lazy::mul<F>(Z1, Z2);
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

template <class F>
__global__ void __launch_bounds__(AU_THREADS, AU_BLOCKS) add_unsafe_kernel(
    const u32* X1, const u32* Y1, const u32* Z1, const u32* X2, const u32* Y2,
    const u32* Z2, u32* X3, u32* Y3, u32* Z3, long long n) {
  INDEX
  Pt R = add_unsafe_lazy<F>(load_pt(X1, Y1, Z1, n, j),
                            load_pt(X2, Y2, Z2, n, j));
  store_pt(X3, Y3, Z3, n, j, R);
}

template <class F, bool NINE>
__global__ void __launch_bounds__(PA_THREADS, PA_BLOCKS) proj_add_kernel(
    const u32* X1, const u32* Y1, const u32* Z1, const u32* X2, const u32* Y2,
    const u32* Z2, u32* X3, u32* Y3, u32* Z3, Const256 b3, long long n) {
  INDEX
  Pt R = proj_add_lazy<F, NINE>(load_pt(X1, Y1, Z1, n, j),
                                load_pt(X2, Y2, Z2, n, j), from_const(b3));
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

// 9 in Montgomery form (9R mod p, from R mod p by host arithmetic), the b3
// of BN254 G1; the 9t-by-additions kernel is taken only for it
template <class F>
static bool is_nine(const Const256& b3) {
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

// Threads per block of a redesigned K2 kernel for n points: the power of
// two from 32 to max_threads whose launch gives the busiest SM the fewest
// points (ceil(blocks / SMs) blocks of it); a smaller block must cut that
// share by more than 1/16.
static unsigned int k2_threads(long long n, unsigned int max_threads) {
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
  unsigned int threads = k2_threads(n, AU_THREADS);
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
  unsigned int threads = k2_threads(n, PA_THREADS);
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
