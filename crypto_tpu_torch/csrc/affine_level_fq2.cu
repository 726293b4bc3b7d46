// One batched-affine halving level over Fq2 (u^2 = -1) in two kernels,
// around a batch inversion of the denominators, on the total unified
// add/double, each instantiated for BLS12-381 G2 (L = 12 limbs a
// component) and BN254 G2 (L = 8); the C entry points take L at run time.
//
// Replaces crypto_tpu/ops/pallas/curve_kernels.py affine_kernels_for_fq2
// (call_pre / call_post), the level of every G2 MSM level in the
// reference (no chunked level over Fq2):
//   pre(x1, y1, m1, x2, y2, m2) -> (d, dbl, inf3)
//   post(x1, y1, x2, y2, dinv, dbl, m1, m2) -> (x3, y3)
// with the contract of affine_level.cu's pre/post: d = 2*y1 when doubling,
// else x2 - x1, and a plain limb-0 1 in row 0 (c0) where the lane is dead
// (an infinite operand, P + (-P)) or d == 0.  Coordinates are (2L, M)
// limb-major uint32 (c0's limbs in rows [0, L), c1's in [L, 2L)), masks
// (M,) int32.  The equality tests compare all 24 limbs, so they rely on
// canonical operands, which the Python side keeps.
//
// Bound on the H100: pre moves 4 coordinates in and 1 out (96 bytes each)
// with no multiplication: memory-bound.  post moves 5 in and 2 out
// against 2 Fq2 products (field.cuh fq2_mul: Karatsuba with lazy
// reduction, 744 32x32->64-bit products each) and 1 square, 2 when
// doubling (complex squaring, 2 Montgomery products each, as the
// reference's Fq2Ctx.square), on the operations side.
//
// One thread per pair.  An Fq2 product alone keeps about 100 words live
// (two operands, the Karatsuba sums and two double-width products), and
// post needs x1 and lambda across its products besides: held in
// registers that made 222, so 2 blocks of 128 threads an SM.  post
// therefore keeps x1 and lambda in shared memory while a product runs,
// one column per thread, word-major (a warp's accesses to one word are
// consecutive, on distinct banks), and inside a product the Karatsuba
// sums and v0 + v1 wait there too (fq2_mul_parked).  It writes x3,
// selects applied, as soon as it is known, so x3 is not live in the
// second product; x2, y1 and y2 are read from memory where they are
// needed.  That fits the 128 registers that __launch_bounds__(T, 4)
// allows (4 blocks, 16 warps an SM) with no spill; the three scratch
// arrays take 36 KB a block (24 KB at L = 8), so post asks for the largest shared-memory
// carveout.
//
// The other limit is the instruction cache: fully unrolled, each
// Montgomery or wide product is several hundred instructions, and the
// kernel several thousand.  The square of x1, which only doubling lanes
// need (none on distinct bases), runs on the rolled CIOS
// (mont_mul_rolled): a twelfth of its code, the same bits.  Unrolled,
// warps that held a doubling lane ran far slower than the rest.
#include "field.cuh"

namespace {

constexpr int T = 128;

template <int L>
__global__ void __launch_bounds__(T) pre_fq2_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2, uint32_t* __restrict__ d,
    int* __restrict__ dbl, int* __restrict__ inf3, long long M, ctt::Mod<L> m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[2 * L], X2[2 * L], Y1[2 * L], t[2 * L];
  ctt::load<2 * L>(X1, x1, M, i);
  ctt::load<2 * L>(X2, x2, M, i);
  ctt::load<2 * L>(Y1, y1, M, i);
  ctt::load<2 * L>(t, y2, M, i);
  ctt::fq2_neg(t, t, m);
  const bool i1 = m1[i] != 0, i2 = m2[i] != 0;
  const bool same_x = ctt::eq<2 * L>(X1, X2);
  const bool y_opp = ctt::eq<2 * L>(Y1, t);
  const bool both = !i1 && !i2;
  const bool is_dbl = same_x && !y_opp && both;
  const bool is_inf3 = (same_x && y_opp && both) || (i1 && i2);
  const bool dead = !both || is_inf3;
  if (is_dbl) {
    ctt::fq2_add(t, Y1, Y1, m);
  } else {
    ctt::fq2_sub(t, X2, X1, m);
  }
  if (dead || ctt::is_zero<2 * L>(t)) {
#pragma unroll
    for (int j = 0; j < 2 * L; ++j) t[j] = j == 0 ? 1u : 0u;
  }
  ctt::store<2 * L>(d, t, M, i);
  dbl[i] = is_dbl ? 1 : 0;
  inf3[i] = is_inf3 ? 1 : 0;
}

// Columns of per-thread scratch in shared memory, word-major.  The
// accesses are volatile, so the compiler cannot forward a stash to its
// fetch and keep the words in registers after all.
template <int W>
__device__ __forceinline__ void stash(volatile uint32_t (*s)[T], const uint32_t a[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) s[j][threadIdx.x] = a[j];
}

template <int W>
__device__ __forceinline__ void fetch(uint32_t a[W], volatile uint32_t (*s)[T]) {
#pragma unroll
  for (int j = 0; j < W; ++j) a[j] = s[j][threadIdx.x];
}

// r = a*b, the Karatsuba product of field.cuh fq2_mul step for step (so
// the same bits), with what waits parked in the scratch columns: the sums
// a0 + a1 and b0 + b1 in `sums` while the half products v0 = a0*b0 and
// v1 = a1*b1 are formed, and v0 + v1 in `vsum` while c0 is reduced.  At
// most the operands' halves and two double-width products are live, 72
// words at L = 12.  r may alias a or b.
template <int L>
__device__ __forceinline__ void fq2_mul_parked(uint32_t r[2 * L], const uint32_t a[2 * L],
                                               const uint32_t b[2 * L], const ctt::Mod<L>& m,
                                               const ctt::PSquare<L>& p2,
                                               volatile uint32_t (*sums)[T],
                                               volatile uint32_t (*vsum)[T]) {
  constexpr int W = 2 * L;
  uint32_t v0[W], t[W];
  {
    uint32_t sab[W];
    ctt::add_words<L>(sab, a, a + L);
    ctt::add_words<L>(sab + L, b, b + L);
    stash<W>(sums, sab);
  }
  ctt::mul_wide<L>(v0, a, b);
  {
    uint32_t v1[W];
    ctt::mul_wide<L>(v1, a + L, b + L);
    ctt::add_words<W>(t, v0, p2.w);
    ctt::sub_words<W>(t, t, v1);         // v0 + p^2 - v1
    ctt::add_words<W>(v0, v0, v1);       // v0 + v1 < 2p^2
    stash<W>(vsum, v0);
  }
  ctt::redc<L>(r, t, m);
  fetch<W>(v0, sums);
  ctt::mul_wide<L>(t, v0, v0 + L);
  fetch<W>(v0, vsum);
  ctt::sub_words<W>(t, t, v0);           // a0*b1 + a1*b0
  ctt::redc<L>(r + L, t, m);
}

constexpr int POST_BLOCKS = 4;  // blocks an SM: at most 128 registers a thread

template <int L>
__global__ void __launch_bounds__(T, POST_BLOCKS) post_fq2_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    const uint32_t* __restrict__ dinv, const int* __restrict__ dbl,
    const int* __restrict__ m1, const int* __restrict__ m2, uint32_t* __restrict__ x3,
    uint32_t* __restrict__ y3, long long M, ctt::Mod<L> m, ctt::PSquare<L> p2) {
  // x1; lambda, or a product's Karatsuba sums; a product's v0 + v1
  __shared__ volatile uint32_t s_x1[2 * L][T], s_lam[2 * L][T], s_v[2 * L][T];
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;  // no barrier below: each thread owns its columns
  const bool is_dbl = dbl[i] != 0, i1 = m1[i] != 0, i2 = m2[i] != 0;
  uint32_t a[2 * L], b[2 * L];
  ctt::load<2 * L>(a, x1, M, i);
  stash<2 * L>(s_x1, a);
  if (is_dbl) {
    ctt::fq2_sqr<true>(b, a, m);                           // rare: rolled
    ctt::fq2_add(a, b, b, m);
    ctt::fq2_add(a, a, b, m);                              // 3 x1^2
  } else {
    ctt::load<2 * L>(a, y2, M, i);
    ctt::load<2 * L>(b, y1, M, i);
    ctt::fq2_sub(a, a, b, m);                              // y2 - y1
  }
  ctt::load<2 * L>(b, dinv, M, i);
  fq2_mul_parked<L>(a, a, b, m, p2, s_lam, s_v);           // lambda
  stash<2 * L>(s_lam, a);
  ctt::fq2_sqr(a, a, m);
  fetch<2 * L>(b, s_x1);
  ctt::fq2_sub(a, a, b, m);
  ctt::load<2 * L>(b, x2, M, i);
  ctt::fq2_sub(a, a, b, m);                                // x3 = lambda^2 - x1 - x2
  fetch<2 * L>(b, s_x1);
  ctt::fq2_sub(b, b, a, m);                                // x1 - x3
  if (i1) {
    ctt::load<2 * L>(a, x2, M, i);
  } else if (i2) {
    fetch<2 * L>(a, s_x1);
  }
  ctt::store<2 * L>(x3, a, M, i);                          // x3 is dead from here
  fetch<2 * L>(a, s_lam);
  fq2_mul_parked<L>(a, a, b, m, p2, s_lam, s_v);
  ctt::load<2 * L>(b, y1, M, i);
  ctt::fq2_sub(a, a, b, m);                                // y3 = lambda (x1 - x3) - y1
  if (i1) {
    ctt::load<2 * L>(a, y2, M, i);
  } else if (i2) {
    ctt::copy<2 * L>(a, b);
  }
  ctt::store<2 * L>(y3, a, M, i);
}

}  // namespace

extern "C" int crypto_affine_pre_fq2(const void* x1, const void* y1, const void* m1,
                                     const void* x2, const void* y2, const void* m2, void* d,
                                     void* dbl, void* inf3, long long M, int L, const void* p,
                                     unsigned int n0inv, void* stream) {
  return ctt::by_limbs(L, [&](auto n) {
    constexpr int N = decltype(n)::value;
    pre_fq2_kernel<N><<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const int*)m1, (const uint32_t*)x2,
        (const uint32_t*)y2, (const int*)m2, (uint32_t*)d, (int*)dbl, (int*)inf3, M,
        ctt::make_mod<N>((const uint32_t*)p, n0inv));
    return cudaSuccess;
  });
}

extern "C" int crypto_affine_post_fq2(const void* x1, const void* y1, const void* x2,
                                      const void* y2, const void* dinv, const void* dbl,
                                      const void* m1, const void* m2, void* x3, void* y3,
                                      long long M, int L, const void* p, unsigned int n0inv,
                                      void* stream) {
  return ctt::by_limbs(L, [&](auto n) {
    constexpr int N = decltype(n)::value;
    // room in shared memory for POST_BLOCKS blocks an SM
    const cudaError_t err = cudaFuncSetAttribute(
        post_fq2_kernel<N>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    post_fq2_kernel<N><<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)x2, (const uint32_t*)y2,
        (const uint32_t*)dinv, (const int*)dbl, (const int*)m1, (const int*)m2,
        (uint32_t*)x3, (uint32_t*)y3, M, ctt::make_mod<N>((const uint32_t*)p, n0inv),
        ctt::make_p_square<N>((const uint32_t*)p));
    return cudaSuccess;
  });
}
