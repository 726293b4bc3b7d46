// One batched-affine halving level over Fq2 (BLS12-381 G2, u^2 = -1) in
// two kernels, around a batch inversion of the denominators, on the total
// unified add/double.
//
// Replaces crypto_tpu/ops/pallas/curve_kernels.py affine_kernels_for_fq2
// (call_pre / call_post), the level of every G2 MSM level in the
// reference (no chunked level over Fq2):
//   pre(x1, y1, m1, x2, y2, m2) -> (d, dbl, inf3)
//   post(x1, y1, x2, y2, dinv, dbl, m1, m2) -> (x3, y3)
// with the contract of affine_level.cu's pre/post: d = 2*y1 when doubling,
// else x2 - x1, and a plain limb-0 1 in row 0 (c0) where the lane is dead
// (an infinite operand, P + (-P)) or d == 0.  Coordinates are (24, M)
// limb-major uint32 (c0's limbs in rows [0, 12), c1's in [12, 24)), masks
// (M,) int32.  The equality tests compare all 24 limbs, so they rely on
// canonical operands, which the Python side keeps.
//
// Bound on the H100: pre moves 4 coordinates in and 1 out (96 bytes each)
// with no multiplication: memory-bound.  post moves 5 in and 2 out
// against 2 Fq2 products (field.cuh fq2_mul: Karatsuba with lazy
// reduction, 744 32x32->64-bit products each) and 1 square, 2 when
// doubling (complex squaring, 2 Montgomery products each, as the
// reference's Fq2Ctx.square), on the operations side.
// One thread per pair.  post's 5 inputs, lambda and the
// results would hold over 200 words and spill; it computes lambda first,
// so that dinv and y2 die, and reloads x2, y1 and y2 from memory where
// the result and the infinity selects need them.
#include "field.cuh"

namespace {

using ctt::FQ2_LIMBS;
constexpr int T = 128;

__global__ void __launch_bounds__(T) pre_fq2_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2, uint32_t* __restrict__ d,
    int* __restrict__ dbl, int* __restrict__ inf3, long long M, ctt::Fq m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[FQ2_LIMBS], X2[FQ2_LIMBS], Y1[FQ2_LIMBS], t[FQ2_LIMBS];
  ctt::load<FQ2_LIMBS>(X1, x1, M, i);
  ctt::load<FQ2_LIMBS>(X2, x2, M, i);
  ctt::load<FQ2_LIMBS>(Y1, y1, M, i);
  ctt::load<FQ2_LIMBS>(t, y2, M, i);
  ctt::fq2_neg(t, t, m);
  const bool i1 = m1[i] != 0, i2 = m2[i] != 0;
  const bool same_x = ctt::eq<FQ2_LIMBS>(X1, X2);
  const bool y_opp = ctt::eq<FQ2_LIMBS>(Y1, t);
  const bool both = !i1 && !i2;
  const bool is_dbl = same_x && !y_opp && both;
  const bool is_inf3 = (same_x && y_opp && both) || (i1 && i2);
  const bool dead = !both || is_inf3;
  if (is_dbl) {
    ctt::fq2_add(t, Y1, Y1, m);
  } else {
    ctt::fq2_sub(t, X2, X1, m);
  }
  if (dead || ctt::is_zero<FQ2_LIMBS>(t)) {
#pragma unroll
    for (int j = 0; j < FQ2_LIMBS; ++j) t[j] = j == 0 ? 1u : 0u;
  }
  ctt::store<FQ2_LIMBS>(d, t, M, i);
  dbl[i] = is_dbl ? 1 : 0;
  inf3[i] = is_inf3 ? 1 : 0;
}

__global__ void __launch_bounds__(T) post_fq2_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    const uint32_t* __restrict__ dinv, const int* __restrict__ dbl,
    const int* __restrict__ m1, const int* __restrict__ m2, uint32_t* __restrict__ x3,
    uint32_t* __restrict__ y3, long long M, ctt::Fq m, ctt::FqSquare p2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const bool is_dbl = dbl[i] != 0, i1 = m1[i] != 0, i2 = m2[i] != 0;
  uint32_t X1[FQ2_LIMBS], lam[FQ2_LIMBS], t[FQ2_LIMBS];
  ctt::load<FQ2_LIMBS>(X1, x1, M, i);
  if (is_dbl) {
    ctt::fq2_sqr(t, X1, m);
    ctt::fq2_add(lam, t, t, m);
    ctt::fq2_add(lam, lam, t, m);                          // 3 x1^2
  } else {
    ctt::load<FQ2_LIMBS>(lam, y2, M, i);
    ctt::load<FQ2_LIMBS>(t, y1, M, i);
    ctt::fq2_sub(lam, lam, t, m);                          // y2 - y1
  }
  ctt::load<FQ2_LIMBS>(t, dinv, M, i);
  ctt::fq2_mul(lam, lam, t, m, p2);                            // lambda
  uint32_t X3[FQ2_LIMBS];
  ctt::fq2_sqr(X3, lam, m);
  ctt::fq2_sub(X3, X3, X1, m);
  ctt::load<FQ2_LIMBS>(t, x2, M, i);
  ctt::fq2_sub(X3, X3, t, m);                              // x3 = lambda^2 - x1 - x2
  ctt::fq2_sub(t, X1, X3, m);
  ctt::fq2_mul(t, lam, t, m, p2);
  ctt::load<FQ2_LIMBS>(lam, y1, M, i);
  ctt::fq2_sub(t, t, lam, m);                              // y3 = lambda (x1 - x3) - y1
  if (i1) {
    ctt::load<FQ2_LIMBS>(X3, x2, M, i);
    ctt::load<FQ2_LIMBS>(t, y2, M, i);
  } else if (i2) {
    ctt::copy<FQ2_LIMBS>(X3, X1);
    ctt::copy<FQ2_LIMBS>(t, lam);
  }
  ctt::store<FQ2_LIMBS>(x3, X3, M, i);
  ctt::store<FQ2_LIMBS>(y3, t, M, i);
}

}  // namespace

extern "C" int crypto_affine_pre_fq2(const void* x1, const void* y1, const void* m1,
                                     const void* x2, const void* y2, const void* m2, void* d,
                                     void* dbl, void* inf3, long long M, const void* p,
                                     unsigned int n0inv, void* stream) {
  pre_fq2_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const int*)m1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const int*)m2, (uint32_t*)d, (int*)dbl, (int*)inf3, M,
      ctt::make_mod<ctt::FQ_LIMBS>((const uint32_t*)p, n0inv));
  return (int)cudaGetLastError();
}

extern "C" int crypto_affine_post_fq2(const void* x1, const void* y1, const void* x2,
                                      const void* y2, const void* dinv, const void* dbl,
                                      const void* m1, const void* m2, void* x3, void* y3,
                                      long long M, const void* p, unsigned int n0inv,
                                      void* stream) {
  post_fq2_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)x2, (const uint32_t*)y2,
      (const uint32_t*)dinv, (const int*)dbl, (const int*)m1, (const int*)m2,
      (uint32_t*)x3, (uint32_t*)y3, M,
      ctt::make_mod<ctt::FQ_LIMBS>((const uint32_t*)p, n0inv),
      ctt::make_fq_square((const uint32_t*)p));
  return (int)cudaGetLastError();
}
