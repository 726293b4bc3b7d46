// One batched-affine halving level in two kernels, around a batch
// inversion of the denominators (BLS12-381 Fq), in two variants.
//
// Total unified add/double: replaces crypto_tpu/ops/pallas/curve_kernels.py
// affine_kernels_for (call_pre / call_post), the level used below the
// chunked level's threshold:
//   pre(x1, y1, m1, x2, y2, m2) -> (d, dbl, inf3)
//   post(x1, y1, x2, y2, dinv, dbl, m1, m2) -> (x3, y3)
// Doubling-free: replaces affine_kernels_fast (call_pre / call_post):
//   pre_fast(x1, m1, x2, m2) -> (d, inf3), d = x2 - x1 (0 on a collision)
//   post_fast(x1, y1, x2, y2, dinv, m1, m2) -> (x3, y3), 3 muls
// Coordinates are (12, M) limb-major uint32, masks (M,) int32 (nonzero =
// infinity / doubling / infinite result).
//
// Bound on the H100: pre moves 4 coordinates in and 1 out with no
// multiplications (memory-bound; pre_fast reads only the two x); post
// moves 5 in and 2 out against 4 or 5 Montgomery muls (post_fast 3), near
// the balance point.  One thread per pair, all field values in registers,
// so each coordinate is read once.
#include "field.cuh"

namespace {

using ctt::FQ_LIMBS;
constexpr int T = 128;

__global__ void __launch_bounds__(T) pre_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2, uint32_t* __restrict__ d,
    int* __restrict__ dbl, int* __restrict__ inf3, long long M, ctt::Fq m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[FQ_LIMBS], Y1[FQ_LIMBS], X2[FQ_LIMBS], Y2[FQ_LIMBS], D[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(X1, x1, M, i);
  ctt::load<FQ_LIMBS>(Y1, y1, M, i);
  ctt::load<FQ_LIMBS>(X2, x2, M, i);
  ctt::load<FQ_LIMBS>(Y2, y2, M, i);
  bool is_dbl, is_inf3;
  ctt::denom_dbl_inf(D, is_dbl, is_inf3, X1, Y1, X2, Y2, m1[i] != 0, m2[i] != 0, m);
  ctt::store<FQ_LIMBS>(d, D, M, i);
  dbl[i] = is_dbl ? 1 : 0;
  inf3[i] = is_inf3 ? 1 : 0;
}

__global__ void __launch_bounds__(T) post_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    const uint32_t* __restrict__ dinv, const int* __restrict__ dbl,
    const int* __restrict__ m1, const int* __restrict__ m2, uint32_t* __restrict__ x3,
    uint32_t* __restrict__ y3, long long M, ctt::Fq m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[FQ_LIMBS], Y1[FQ_LIMBS], X2[FQ_LIMBS], Y2[FQ_LIMBS], DI[FQ_LIMBS];
  uint32_t X3[FQ_LIMBS], Y3[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(X1, x1, M, i);
  ctt::load<FQ_LIMBS>(Y1, y1, M, i);
  ctt::load<FQ_LIMBS>(X2, x2, M, i);
  ctt::load<FQ_LIMBS>(Y2, y2, M, i);
  ctt::load<FQ_LIMBS>(DI, dinv, M, i);
  ctt::unified_apply(X3, Y3, X1, Y1, X2, Y2, DI, dbl[i] != 0, m1[i] != 0, m2[i] != 0, m);
  ctt::store<FQ_LIMBS>(x3, X3, M, i);
  ctt::store<FQ_LIMBS>(y3, Y3, M, i);
}

__global__ void __launch_bounds__(T) pre_fast_kernel(
    const uint32_t* __restrict__ x1, const int* __restrict__ m1,
    const uint32_t* __restrict__ x2, const int* __restrict__ m2, uint32_t* __restrict__ d,
    int* __restrict__ inf3, long long M, ctt::Fq m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[FQ_LIMBS], X2[FQ_LIMBS], D[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(X1, x1, M, i);
  ctt::load<FQ_LIMBS>(X2, x2, M, i);
  bool is_inf3;
  ctt::denom_fast(D, is_inf3, X1, X2, m1[i] != 0, m2[i] != 0, m);
  ctt::store<FQ_LIMBS>(d, D, M, i);
  inf3[i] = is_inf3 ? 1 : 0;
}

__global__ void __launch_bounds__(T) post_fast_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    const uint32_t* __restrict__ dinv, const int* __restrict__ m1,
    const int* __restrict__ m2, uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
    long long M, ctt::Fq m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[FQ_LIMBS], Y1[FQ_LIMBS], X2[FQ_LIMBS], Y2[FQ_LIMBS], DI[FQ_LIMBS];
  uint32_t X3[FQ_LIMBS], Y3[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(X1, x1, M, i);
  ctt::load<FQ_LIMBS>(Y1, y1, M, i);
  ctt::load<FQ_LIMBS>(X2, x2, M, i);
  ctt::load<FQ_LIMBS>(Y2, y2, M, i);
  ctt::load<FQ_LIMBS>(DI, dinv, M, i);
  ctt::fast_apply(X3, Y3, X1, Y1, X2, Y2, DI, m1[i] != 0, m2[i] != 0, m);
  ctt::store<FQ_LIMBS>(x3, X3, M, i);
  ctt::store<FQ_LIMBS>(y3, Y3, M, i);
}

}  // namespace

extern "C" int crypto_affine_pre(const void* x1, const void* y1, const void* m1,
                                 const void* x2, const void* y2, const void* m2, void* d,
                                 void* dbl, void* inf3, long long M, const void* p,
                                 unsigned int n0inv, void* stream) {
  pre_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const int*)m1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const int*)m2, (uint32_t*)d, (int*)dbl, (int*)inf3, M,
      ctt::make_mod<FQ_LIMBS>((const uint32_t*)p, n0inv));
  return (int)cudaGetLastError();
}

extern "C" int crypto_affine_post(const void* x1, const void* y1, const void* x2,
                                  const void* y2, const void* dinv, const void* dbl,
                                  const void* m1, const void* m2, void* x3, void* y3,
                                  long long M, const void* p, unsigned int n0inv,
                                  void* stream) {
  post_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)x2, (const uint32_t*)y2,
      (const uint32_t*)dinv, (const int*)dbl, (const int*)m1, (const int*)m2,
      (uint32_t*)x3, (uint32_t*)y3, M, ctt::make_mod<FQ_LIMBS>((const uint32_t*)p, n0inv));
  return (int)cudaGetLastError();
}

extern "C" int crypto_affine_pre_fast(const void* x1, const void* m1, const void* x2,
                                      const void* m2, void* d, void* inf3, long long M,
                                      const void* p, unsigned int n0inv, void* stream) {
  pre_fast_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const int*)m1, (const uint32_t*)x2, (const int*)m2,
      (uint32_t*)d, (int*)inf3, M, ctt::make_mod<FQ_LIMBS>((const uint32_t*)p, n0inv));
  return (int)cudaGetLastError();
}

extern "C" int crypto_affine_post_fast(const void* x1, const void* y1, const void* x2,
                                       const void* y2, const void* dinv, const void* m1,
                                       const void* m2, void* x3, void* y3, long long M,
                                       const void* p, unsigned int n0inv, void* stream) {
  post_fast_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)x2, (const uint32_t*)y2,
      (const uint32_t*)dinv, (const int*)m1, (const int*)m2, (uint32_t*)x3,
      (uint32_t*)y3, M, ctt::make_mod<FQ_LIMBS>((const uint32_t*)p, n0inv));
  return (int)cudaGetLastError();
}
