// One batched-affine halving level with the inversion chunked inside the
// level, in two variants, each instantiated for BLS12-381 Fq (L = 12
// limbs) and BN254 Fq (L = 8); the C entry points take L at run time.
//
// Total unified add/double: replaces crypto_tpu/ops/pallas/curve_kernels.py
// chunked_level_kernels_for (call_prefix / call_down):
//   prefix(x1, y1, m1, x2, y2, m2) -> (prefix, total, dbl, inf3)
//   down(x1, y1, m1, x2, y2, m2, prefix, tinv, dbl) -> (x3, y3)
// Doubling-free: replaces chunked_level_kernels_fast (call_prefix /
// call_down), the default of the MSM's wide levels:
//   prefix_fast(x1, m1, x2, m2) -> (prefix, total, inf3)
//   down_fast(x1, y1, m1, x2, y2, m2, prefix, tinv) -> (x3, y3)
// with d = x2 - x1 (denom_fast), so a colliding pair makes its thread's
// total 0; the caller flags it and keeps the batch inversion valid.  The
// fast pair drops the x1^2 of the doubling numerator, the equality tests
// and the negation of y2 from every pair: prefix 1 mul a pair, down 4 and
// a square.
// The TPU kernel ran Montgomery's trick over k = 8 sub-slices of 512 lanes
// in a block; here thread t owns the K = 8 pairs t + j*T (T = M/K, so a
// warp's loads stay contiguous), emits the running products prefix[j] =
// d_0 * ... * d_j at those pairs and one total at t.  The caller inverts
// only the (L, T) totals; down walks the K pairs back (dinv_j = t *
// prefix_{j-1}, t *= d_j with d_j recomputed as prefix formed it, so the
// products match) and applies the unified formula.  The total down pass
// rebuilds d_j from the doubling flag that prefix wrote, with no equality
// test and no negation: d = 2*y1 where dbl, else x2 - x1, and a plain 1
// where an operand is infinite or d == 0.  That is denom_dbl_inf's d in
// every case: a doubling pair has both operands finite, and a pair that
// denom_dbl_inf finds dead with both finite (P + (-P): the same x, not
// doubling) has x2 - x1 = 0.
//
// Bound on the H100: about 7 Montgomery muls and 13 coordinate reads and
// writes per pair, near the balance point of the integer multiply rate and
// the memory rate.  All values stay in registers; the cost is K-fold fewer
// threads than pairs, so the level wants M well above the card's thread
// count (the caller takes this path only for wide levels).
//
// Both down passes, the G1 MSM's costliest level kernel and the rerun's,
// run their products on even/odd accumulators (field.cuh mont_mul_eo: no
// register moves, which took about as many instructions as the products
// in mont_mul) and square lambda, and x1 on a doubling pair, with
// mont_sqr (234 wide products against 300).  They load each coordinate
// where it is needed, x1 and x2 (or y1) for d, then the prefix, then y1
// and y2 (or x1) for lambda's numerator, and read the other point back in
// the rare branch of an infinite operand, so only t, dinv and lambda live
// across the products: under __launch_bounds__(T, 4), 4 blocks an SM, no
// spill.
#include "field.cuh"

namespace {

constexpr int K = 8;
constexpr int T = 128;

template <int L>
__global__ void __launch_bounds__(T) prefix_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2,
    uint32_t* __restrict__ prefix, uint32_t* __restrict__ total, int* __restrict__ dbl,
    int* __restrict__ inf3, long long M, ctt::Mod<L> m) {
  const long long Tn = M / K;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  uint32_t acc[L];
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    long long i = t + j * Tn;
    uint32_t X1[L], Y1[L], X2[L], Y2[L], D[L];
    ctt::load<L>(X1, x1, M, i);
    ctt::load<L>(Y1, y1, M, i);
    ctt::load<L>(X2, x2, M, i);
    ctt::load<L>(Y2, y2, M, i);
    bool is_dbl, is_inf3;
    ctt::denom_dbl_inf<L>(D, is_dbl, is_inf3, X1, Y1, X2, Y2, m1[i] != 0, m2[i] != 0, m);
    if (j == 0) {
      ctt::copy<L>(acc, D);
    } else {
      ctt::mont_mul<L>(acc, acc, D, m);
    }
    ctt::store<L>(prefix, acc, M, i);
    dbl[i] = is_dbl ? 1 : 0;
    inf3[i] = is_inf3 ? 1 : 0;
  }
  ctt::store<L>(total, acc, Tn, t);
}

// The end of both down passes at pair i, given lambda's numerator in a
// and dinv in b: lambda = a * dinv, x3 = lambda^2 - x1 - x2, y3 = lambda
// (x1 - x3) - y1, stored, an infinite operand passing the other point
// through.  x1, x2, y1 and y2 are read where they are needed, so only
// lambda and one more value live across a product.  a, b and c are
// scratch.
template <int L>
__device__ __forceinline__ void apply_store(
    uint32_t a[L], uint32_t b[L], uint32_t c[L],
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, bool i1, bool i2, long long M,
    long long i, const ctt::Mod<L>& m) {
  ctt::mont_mul_eo<L>(a, a, b, m);        // lambda
  ctt::mont_sqr<L>(b, a, m);
  ctt::load<L>(c, x1, M, i);
  ctt::sub<L>(b, b, c, m);
  ctt::load<L>(c, x2, M, i);
  ctt::sub<L>(b, b, c, m);                // x3 = lambda^2 - x1 - x2
  ctt::load<L>(c, x1, M, i);
  ctt::sub<L>(c, c, b, m);                // x1 - x3
  if (i1) {
    ctt::load<L>(b, x2, M, i);
  } else if (i2) {
    ctt::load<L>(b, x1, M, i);
  }
  ctt::store<L>(x3, b, M, i);
  ctt::mont_mul_eo<L>(a, a, c, m);
  ctt::load<L>(c, y1, M, i);
  ctt::sub<L>(a, a, c, m);                // y3 = lambda (x1 - x3) - y1
  if (i1) {
    ctt::load<L>(a, y2, M, i);
  } else if (i2) {
    ctt::copy<L>(a, c);
  }
  ctt::store<L>(y3, a, M, i);
}

constexpr int DOWN_BLOCKS = 4;  // blocks an SM: at most 128 registers a thread

template <int L>
__global__ void __launch_bounds__(T, DOWN_BLOCKS) down_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2,
    const uint32_t* __restrict__ prefix, const uint32_t* __restrict__ tinv,
    const int* __restrict__ dbl, uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
    long long M, ctt::Mod<L> m) {
  const long long Tn = M / K;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  uint32_t inv[L];
  ctt::load<L>(inv, tinv, Tn, t);
#pragma unroll 1
  for (int j = K - 1; j >= 0; --j) {
    const long long i = t + j * Tn;
    const bool i1 = m1[i] != 0, i2 = m2[i] != 0, is_dbl = dbl[i] != 0;
    uint32_t a[L], b[L], c[L];
    if (j > 0) {
      // prefix's d from its doubling flag (see the head of the file)
      if (is_dbl) {
        ctt::load<L>(a, y1, M, i);
        ctt::add<L>(c, a, a, m);
      } else {
        ctt::load<L>(a, x1, M, i);
        ctt::load<L>(b, x2, M, i);
        ctt::sub<L>(c, b, a, m);
      }
      if (i1 || i2 || ctt::is_zero<L>(c)) {
#pragma unroll
        for (int l = 0; l < L; ++l) c[l] = l == 0 ? 1u : 0u;
      }
      ctt::load<L>(a, prefix, M, i - Tn);
      ctt::mont_mul_eo<L>(b, inv, a, m);    // dinv
      ctt::mont_mul_eo<L>(inv, inv, c, m);
    } else {
      ctt::copy<L>(b, inv);
    }
    if (is_dbl) {                                  // rare: not on distinct bases
      ctt::load<L>(c, x1, M, i);
      ctt::mont_sqr<L>(c, c, m);
      ctt::add<L>(a, c, c, m);
      ctt::add<L>(a, a, c, m);              // 3 x1^2
    } else {
      ctt::load<L>(a, y2, M, i);
      ctt::load<L>(c, y1, M, i);
      ctt::sub<L>(a, a, c, m);              // y2 - y1
    }
    apply_store<L>(a, b, c, x1, y1, x2, y2, x3, y3, i1, i2, M, i, m);
  }
}

template <int L>
__global__ void __launch_bounds__(T) prefix_fast_kernel(
    const uint32_t* __restrict__ x1, const int* __restrict__ m1,
    const uint32_t* __restrict__ x2, const int* __restrict__ m2,
    uint32_t* __restrict__ prefix, uint32_t* __restrict__ total, int* __restrict__ inf3,
    long long M, ctt::Mod<L> m) {
  const long long Tn = M / K;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  uint32_t acc[L];
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    long long i = t + j * Tn;
    uint32_t X1[L], X2[L], D[L];
    ctt::load<L>(X1, x1, M, i);
    ctt::load<L>(X2, x2, M, i);
    bool is_inf3;
    ctt::denom_fast<L>(D, is_inf3, X1, X2, m1[i] != 0, m2[i] != 0, m);
    if (j == 0) {
      ctt::copy<L>(acc, D);
    } else {
      ctt::mont_mul<L>(acc, acc, D, m);
    }
    ctt::store<L>(prefix, acc, M, i);
    inf3[i] = is_inf3 ? 1 : 0;
  }
  ctt::store<L>(total, acc, Tn, t);
}

template <int L>
__global__ void __launch_bounds__(T, DOWN_BLOCKS) down_fast_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2,
    const uint32_t* __restrict__ prefix, const uint32_t* __restrict__ tinv,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, long long M, ctt::Mod<L> m) {
  const long long Tn = M / K;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  uint32_t inv[L];
  ctt::load<L>(inv, tinv, Tn, t);
#pragma unroll 1
  for (int j = K - 1; j >= 0; --j) {
    const long long i = t + j * Tn;
    const bool i1 = m1[i] != 0, i2 = m2[i] != 0;
    uint32_t a[L], b[L], c[L];
    if (j > 0) {
      ctt::load<L>(a, x1, M, i);
      ctt::load<L>(b, x2, M, i);
      bool is_inf2;
      ctt::denom_fast<L>(c, is_inf2, a, b, i1, i2, m);
      ctt::load<L>(a, prefix, M, i - Tn);
      ctt::mont_mul_eo<L>(b, inv, a, m);    // dinv
      ctt::mont_mul_eo<L>(inv, inv, c, m);
    } else {
      ctt::copy<L>(b, inv);
    }
    ctt::load<L>(a, y2, M, i);
    ctt::load<L>(c, y1, M, i);
    ctt::sub<L>(a, a, c, m);                // y2 - y1
    apply_store<L>(a, b, c, x1, y1, x2, y2, x3, y3, i1, i2, M, i, m);
  }
}

}  // namespace

// kernel<N> over M pairs (M/K threads) for the run-time limb count L, the
// modulus by value
#define LAUNCH(kernel, M, stream, ...)                                             \
  ctt::by_limbs(L, [&](auto n) {                                                   \
    constexpr int N = decltype(n)::value;                                          \
    kernel<N><<<ctt::blocks_for(M / K, T), T, 0, (cudaStream_t)stream>>>(         \
        __VA_ARGS__, M, ctt::make_mod<N>((const uint32_t*)p, n0inv));              \
    return cudaSuccess;                                                            \
  })

extern "C" int crypto_chunked_prefix(const void* x1, const void* y1, const void* m1,
                                     const void* x2, const void* y2, const void* m2,
                                     void* prefix, void* total, void* dbl, void* inf3,
                                     long long M, int L, const void* p, unsigned int n0inv,
                                     void* stream) {
  if (M % K != 0) return (int)cudaErrorInvalidValue;
  return LAUNCH(prefix_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const int*)m1, (const uint32_t*)x2, (const uint32_t*)y2, (const int*)m2,
                (uint32_t*)prefix, (uint32_t*)total, (int*)dbl, (int*)inf3);
}

extern "C" int crypto_chunked_down(const void* x1, const void* y1, const void* m1,
                                   const void* x2, const void* y2, const void* m2,
                                   const void* prefix, const void* tinv, const void* dbl,
                                   void* x3, void* y3, long long M, int L, const void* p,
                                   unsigned int n0inv, void* stream) {
  if (M % K != 0) return (int)cudaErrorInvalidValue;
  return LAUNCH(down_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const int*)m1, (const uint32_t*)x2, (const uint32_t*)y2, (const int*)m2,
                (const uint32_t*)prefix, (const uint32_t*)tinv, (const int*)dbl,
                (uint32_t*)x3, (uint32_t*)y3);
}

extern "C" int crypto_chunked_prefix_fast(const void* x1, const void* m1, const void* x2,
                                          const void* m2, void* prefix, void* total,
                                          void* inf3, long long M, int L, const void* p,
                                          unsigned int n0inv, void* stream) {
  if (M % K != 0) return (int)cudaErrorInvalidValue;
  return LAUNCH(prefix_fast_kernel, M, stream, (const uint32_t*)x1, (const int*)m1,
                (const uint32_t*)x2, (const int*)m2, (uint32_t*)prefix, (uint32_t*)total,
                (int*)inf3);
}

extern "C" int crypto_chunked_down_fast(const void* x1, const void* y1, const void* m1,
                                        const void* x2, const void* y2, const void* m2,
                                        const void* prefix, const void* tinv, void* x3,
                                        void* y3, long long M, int L, const void* p,
                                        unsigned int n0inv, void* stream) {
  if (M % K != 0) return (int)cudaErrorInvalidValue;
  return LAUNCH(down_fast_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const int*)m1, (const uint32_t*)x2, (const uint32_t*)y2, (const int*)m2,
                (const uint32_t*)prefix, (const uint32_t*)tinv, (uint32_t*)x3,
                (uint32_t*)y3);
}
