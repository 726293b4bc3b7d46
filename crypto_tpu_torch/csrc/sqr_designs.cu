// Designs of the Montgomery square and of the Fq2 square over BLS12-381
// Fq, one kernel each, for crypto_tpu_torch/time_sqr_designs.py to time
// against each other.  Not part of the port's library (build.py does not
// compile it).  For canonical inputs every design gives the same bits.
//
// mont_sqr_design_kernel<D>, r = a*a*R^-1 on (12, M) limb-major:
//   0  ctt::mont_sqr, redc(sqr_wide(a)): the G1 down pass's square
//   1  the same on sqr_wide_folded: the cross products' odd array added
//      into w after every row, so its words die early
//   2  ctt::mont_mul_eo(a, a)
//   3  ctt::mont_mul(a, a), CIOS: the parent's down pass squared so
// fq2_sqr_design_kernel<D>, r = a^2 on (24, M):
//   0  complex squaring with lazy reduction (blst's sqr_mont_382x):
//      c0 = mont_mul_eo(a0 + a1, a0 + p - a1), c1 = mont_mul_eo(2*a0, a1),
//      the sums left unreduced below 2p (600 wide products)
//   1  ctt::fq2_sqr_karatsuba: three sqr_wide squares and two redc
//      (546 wide products): the port's fq2_sqr kernel
//   2  1 on sqr_wide_folded
//   3  ctt::fq2_sqr: two CIOS products and three modular adds and subs,
//      the kernel before both
// With SQR_DESIGNS_FOLDED_ONLY defined it holds only ctt::mont_sqr_folded,
// for the script's build of chunked_level.cu with its square on it.
#include "field.cuh"

namespace ctt {

// Row I of sqr_wide_folded: sqr_cross's chains, then od's two words
// 2I, 2I + 1 folded into w's words 2I + 1, 2I + 2 (no later row touches
// them), the fold's carry c passed on to the next row's fold.
template <int N, int I>
__device__ __forceinline__ void sqr_cross_folded(uint32_t w[2 * N], uint32_t od[2 * N],
                                                 uint32_t& c, const uint32_t a[N]) {
  if constexpr (I < N - 1) {
    constexpr int nA = (N - I) / 2, nB = (N - 1 - I) / 2;
    mad_pass<2 * nA, 0>(od + 2 * I, a + I + 1, a[I]);
    if constexpr ((N - I) % 2 == 1) od[I + N - 1] = ptx::addc(od[I + N - 1], 0);
    if constexpr (nB > 0) {
      mad_pass<2 * nB, 0>(w + 2 * I + 2, a + I + 2, a[I]);
      if constexpr ((N - 1 - I) % 2 == 1) w[I + N] = ptx::addc(w[I + N], 0);
    }
    w[2 * I + 1] = ptx::add_cc(w[2 * I + 1], od[2 * I]);
    w[2 * I + 2] = ptx::addc_cc(w[2 * I + 2], od[2 * I + 1]);
    const uint32_t c2 = ptx::addc(0, 0);
    w[2 * I + 1] = ptx::add_cc(w[2 * I + 1], c);
    w[2 * I + 2] = ptx::addc_cc(w[2 * I + 2], 0);
    c = ptx::addc(c2, 0);  // at most 1: with c2 = 1 the two words are below 2^64 - 1
    sqr_cross_folded<N, I + 1>(w, od, c, a);
  }
}

template <int N>
__device__ __forceinline__ void sqr_wide_folded(uint32_t w[2 * N], const uint32_t a[N]) {
  uint32_t od[2 * N], c = 0;
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) w[j] = od[j] = 0;
  sqr_cross_folded<N, 0>(w, od, c, a);
  w[2 * N - 1] = w[2 * N - 2] >> 31;
#pragma unroll
  for (int j = 2 * N - 2; j > 0; --j) w[j] = __funnelshift_l(w[j - 1], w[j], 1);
  w[0] = ptx::mad_lo_cc(a[0], a[0], w[0]);
  w[1] = ptx::madc_hi_cc(a[0], a[0], w[1]);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    w[2 * i] = ptx::madc_lo_cc(a[i], a[i], w[2 * i]);
    w[2 * i + 1] = ptx::madc_hi_cc(a[i], a[i], w[2 * i + 1]);
  }
}

// mont_sqr on sqr_wide_folded.
template <int N>
__device__ __forceinline__ void mont_sqr_folded(uint32_t r[N], const uint32_t a[N],
                                                const Mod<N>& m) {
  uint32_t w[2 * N];
  sqr_wide_folded<N>(w, a);
  redc<N>(r, w, m);
}

}  // namespace ctt

#ifndef SQR_DESIGNS_FOLDED_ONLY
namespace {

using namespace ctt;
constexpr int T = 128;

// Design 0.  s*d < 4p^2 and 2*a0*a1 < 2p^2 lie below p*R, and s, d, 2*a0
// below 2p < R - p, as mont_mul_eo needs.
__device__ __forceinline__ void fq2_sqr_lazy(uint32_t r[FQ2_LIMBS], const uint32_t a[FQ2_LIMBS],
                                             const Fq& m) {
  constexpr int L = FQ_LIMBS;
  uint32_t s[L], d[L], t[L];
  add_words<L>(t, a, a);
  mont_mul_eo<L>(t, t, a + L, m);
  add_words<L>(s, a, a + L);
  add_words<L>(d, a, m.p);
  sub_words<L>(d, d, a + L);
  mont_mul_eo<L>(r, s, d, m);
  copy<L>(r + L, t);
}

// Design 2: ctt::fq2_sqr_karatsuba on sqr_wide_folded.
__device__ __forceinline__ void fq2_sqr_karatsuba_folded(uint32_t r[FQ2_LIMBS],
                                                         const uint32_t a[FQ2_LIMBS],
                                                         const Fq& m, const FqSquare& p2) {
  constexpr int L = FQ_LIMBS, W = 2 * FQ_LIMBS;
  uint32_t s[L], v0[W], v1[W];
  add_words<L>(s, a, a + L);
  sqr_wide_folded<L>(v0, a);
  sqr_wide_folded<L>(v1, a + L);
  {
    uint32_t t[W];
    add_words<W>(t, v0, p2.w);
    sub_words<W>(t, t, v1);
    redc<L>(r, t, m);
  }
  add_words<W>(v0, v0, v1);
  sqr_wide_folded<L>(v1, s);
  sub_words<W>(v1, v1, v0);
  redc<L>(r + L, v1, m);
}

template <int D>
__global__ void __launch_bounds__(T) mont_sqr_design_kernel(const uint32_t* __restrict__ a,
                                                            uint32_t* __restrict__ out,
                                                            long long M, Fq m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[FQ_LIMBS];
  load<FQ_LIMBS>(x, a, M, i);
  if constexpr (D == 0) {
    mont_sqr<FQ_LIMBS>(x, x, m);
  } else if constexpr (D == 1) {
    mont_sqr_folded<FQ_LIMBS>(x, x, m);
  } else if constexpr (D == 2) {
    mont_mul_eo<FQ_LIMBS>(x, x, x, m);
  } else {
    mont_mul<FQ_LIMBS>(x, x, x, m);
  }
  store<FQ_LIMBS>(out, x, M, i);
}

template <int D>
__global__ void __launch_bounds__(T) fq2_sqr_design_kernel(const uint32_t* __restrict__ a,
                                                           uint32_t* __restrict__ out,
                                                           long long M, Fq m, FqSquare p2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[FQ2_LIMBS];
  load<FQ2_LIMBS>(x, a, M, i);
  if constexpr (D == 0) {
    fq2_sqr_lazy(x, x, m);
  } else if constexpr (D == 1) {
    fq2_sqr_karatsuba(x, x, m, p2);
  } else if constexpr (D == 2) {
    fq2_sqr_karatsuba_folded(x, x, m, p2);
  } else {
    fq2_sqr(x, x, m);
  }
  store<FQ2_LIMBS>(out, x, M, i);
}

template <int D>
void launch(int fq2, const void* a, void* out, long long M, const Fq& m, const FqSquare& p2,
            cudaStream_t s) {
  if (fq2) {
    fq2_sqr_design_kernel<D><<<blocks_for(M, T), T, 0, s>>>((const uint32_t*)a,
                                                            (uint32_t*)out, M, m, p2);
  } else {
    mont_sqr_design_kernel<D><<<blocks_for(M, T), T, 0, s>>>((const uint32_t*)a,
                                                             (uint32_t*)out, M, m);
  }
}

}  // namespace

// fq2 = 0: mont_sqr_design_kernel<design> on (12, M); 1: the Fq2 square's
// on (24, M).  Returns cudaGetLastError(), -1 for an unknown design.
extern "C" int sqr_design(int fq2, int design, const void* a, void* out, long long M,
                          const void* p, unsigned int n0inv, void* stream) {
  const Fq m = make_mod<FQ_LIMBS>((const uint32_t*)p, n0inv);
  const FqSquare p2 = make_fq_square((const uint32_t*)p);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (design) {
    case 0: launch<0>(fq2, a, out, M, m, p2, s); break;
    case 1: launch<1>(fq2, a, out, M, m, p2, s); break;
    case 2: launch<2>(fq2, a, out, M, m, p2, s); break;
    case 3: launch<3>(fq2, a, out, M, m, p2, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
#endif  // SQR_DESIGNS_FOLDED_ONLY
