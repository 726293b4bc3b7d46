// The split narrow level that affine_level.cu replaced, kept for one
// timing comparison only: chip_smoke.py builds this file as a library of
// its own (the port's library does not hold it; no path of the port
// launches it) and times pre -> msm_v2.batch_inv_t -> post against the
// one-launch level at the same widths.
//
// Total unified add/double (crypto_tpu/ops/pallas/curve_kernels.py
// affine_kernels_for, call_pre / call_post):
//   pre(x1, y1, m1, x2, y2, m2) -> (d, dbl, inf3)
//   post(x1, y1, x2, y2, dinv, dbl, m1, m2) -> (x3, y3)
// Doubling-free (affine_kernels_fast):
//   pre_fast(x1, m1, x2, m2) -> (d, inf3), d = x2 - x1 (0 on a collision)
//   post_fast(x1, y1, x2, y2, dinv, m1, m2) -> (x3, y3), 3 muls
// Coordinates are (L, M) limb-major uint32, masks (M,) int32; one thread a
// pair, each instantiated at L = 12 and 8.
#include "field.cuh"

namespace {

constexpr int T = 128;

template <int L>
__global__ void __launch_bounds__(T) pre_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2, uint32_t* __restrict__ d,
    int* __restrict__ dbl, int* __restrict__ inf3, long long M, ctt::Mod<L> m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[L], Y1[L], X2[L], Y2[L], D[L];
  ctt::load<L>(X1, x1, M, i);
  ctt::load<L>(Y1, y1, M, i);
  ctt::load<L>(X2, x2, M, i);
  ctt::load<L>(Y2, y2, M, i);
  bool is_dbl, is_inf3;
  ctt::denom_dbl_inf<L>(D, is_dbl, is_inf3, X1, Y1, X2, Y2, m1[i] != 0, m2[i] != 0, m);
  ctt::store<L>(d, D, M, i);
  dbl[i] = is_dbl ? 1 : 0;
  inf3[i] = is_inf3 ? 1 : 0;
}

template <int L>
__global__ void __launch_bounds__(T) post_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    const uint32_t* __restrict__ dinv, const int* __restrict__ dbl,
    const int* __restrict__ m1, const int* __restrict__ m2, uint32_t* __restrict__ x3,
    uint32_t* __restrict__ y3, long long M, ctt::Mod<L> m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[L], Y1[L], X2[L], Y2[L], DI[L];
  uint32_t X3[L], Y3[L];
  ctt::load<L>(X1, x1, M, i);
  ctt::load<L>(Y1, y1, M, i);
  ctt::load<L>(X2, x2, M, i);
  ctt::load<L>(Y2, y2, M, i);
  ctt::load<L>(DI, dinv, M, i);
  ctt::unified_apply<L>(X3, Y3, X1, Y1, X2, Y2, DI, dbl[i] != 0, m1[i] != 0, m2[i] != 0, m);
  ctt::store<L>(x3, X3, M, i);
  ctt::store<L>(y3, Y3, M, i);
}

template <int L>
__global__ void __launch_bounds__(T) pre_fast_kernel(
    const uint32_t* __restrict__ x1, const int* __restrict__ m1,
    const uint32_t* __restrict__ x2, const int* __restrict__ m2, uint32_t* __restrict__ d,
    int* __restrict__ inf3, long long M, ctt::Mod<L> m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[L], X2[L], D[L];
  ctt::load<L>(X1, x1, M, i);
  ctt::load<L>(X2, x2, M, i);
  bool is_inf3;
  ctt::denom_fast<L>(D, is_inf3, X1, X2, m1[i] != 0, m2[i] != 0, m);
  ctt::store<L>(d, D, M, i);
  inf3[i] = is_inf3 ? 1 : 0;
}

template <int L>
__global__ void __launch_bounds__(T) post_fast_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    const uint32_t* __restrict__ dinv, const int* __restrict__ m1,
    const int* __restrict__ m2, uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
    long long M, ctt::Mod<L> m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[L], Y1[L], X2[L], Y2[L], DI[L];
  uint32_t X3[L], Y3[L];
  ctt::load<L>(X1, x1, M, i);
  ctt::load<L>(Y1, y1, M, i);
  ctt::load<L>(X2, x2, M, i);
  ctt::load<L>(Y2, y2, M, i);
  ctt::load<L>(DI, dinv, M, i);
  ctt::fast_apply<L>(X3, Y3, X1, Y1, X2, Y2, DI, m1[i] != 0, m2[i] != 0, m);
  ctt::store<L>(x3, X3, M, i);
  ctt::store<L>(y3, Y3, M, i);
}

}  // namespace

// kernel<N> over M pairs for the run-time limb count L, the modulus by value
#define LAUNCH(kernel, M, stream, ...)                                             \
  ctt::by_limbs(L, [&](auto n) {                                                   \
    constexpr int N = decltype(n)::value;                                          \
    kernel<N><<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(             \
        __VA_ARGS__, M, ctt::make_mod<N>((const uint32_t*)p, n0inv));              \
    return cudaSuccess;                                                            \
  })

extern "C" int crypto_affine_pre(const void* x1, const void* y1, const void* m1,
                                 const void* x2, const void* y2, const void* m2, void* d,
                                 void* dbl, void* inf3, long long M, int L, const void* p,
                                 unsigned int n0inv, void* stream) {
  return LAUNCH(pre_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const int*)m1, (const uint32_t*)x2, (const uint32_t*)y2, (const int*)m2,
                (uint32_t*)d, (int*)dbl, (int*)inf3);
}

extern "C" int crypto_affine_post(const void* x1, const void* y1, const void* x2,
                                  const void* y2, const void* dinv, const void* dbl,
                                  const void* m1, const void* m2, void* x3, void* y3,
                                  long long M, int L, const void* p, unsigned int n0inv,
                                  void* stream) {
  return LAUNCH(post_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)dinv,
                (const int*)dbl, (const int*)m1, (const int*)m2, (uint32_t*)x3,
                (uint32_t*)y3);
}

extern "C" int crypto_affine_pre_fast(const void* x1, const void* m1, const void* x2,
                                      const void* m2, void* d, void* inf3, long long M, int L,
                                      const void* p, unsigned int n0inv, void* stream) {
  return LAUNCH(pre_fast_kernel, M, stream, (const uint32_t*)x1, (const int*)m1,
                (const uint32_t*)x2, (const int*)m2, (uint32_t*)d, (int*)inf3);
}

extern "C" int crypto_affine_post_fast(const void* x1, const void* y1, const void* x2,
                                       const void* y2, const void* dinv, const void* m1,
                                       const void* m2, void* x3, void* y3, long long M, int L,
                                       const void* p, unsigned int n0inv, void* stream) {
  return LAUNCH(post_fast_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)dinv,
                (const int*)m1, (const int*)m2, (uint32_t*)x3, (uint32_t*)y3);
}
