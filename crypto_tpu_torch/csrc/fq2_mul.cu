// Batched Fq2 multiplication and squaring over BLS12-381 Fq (u^2 = -1),
// (24, M) x (24, M) -> (24, M) and (24, M) -> (24, M), limb-major: c0's 12
// limbs in rows [0, 12), c1's in rows [12, 24), Montgomery form.
//
// The product replaces crypto_tpu/ops/pallas/curve_kernels.py fq2_mul_t_fn
// (Fq2Ctx.mul fused in one kernel), behind the G2 MSM's batch_inv_t and
// every Fq2 product of the G2 tail; the square is the reference's complex
// squaring (Fq2Ctx.square, JQuadField.square), every Fq2 square of the G2
// tail.  One thread per element with every intermediate in registers,
// the modulus (and, for the product, p^2) by value in the kernel
// parameters (constant bank).
//
// The product is Karatsuba with lazy reduction (field.cuh fq2_mul, as
// blst's mul_mont_384x): three unreduced 12 x 12-word products, v0 =
// a0*b0, v1 = a1*b1 and t = (a0 + a1)(b0 + b1), then two Montgomery
// reductions, c0 = redc(v0 + p^2 - v1) and c1 = redc(t - v0 - v1), the
// products on PTX carry chains, the reductions on even/odd accumulators.
// Contract: for canonical inputs (below p) the result is the canonical
// product, bit for bit what the reference's three Montgomery products
// give and what the plain version (fq2_mul_plain, three CIOS products)
// gives; both reduction inputs lie in [0, 2p^2), below p*R.  Every path
// feeds canonical inputs (dead slots are zero, pads a limb-0 1).  The
// square is the same Karatsuba with b = a (field.cuh fq2_sqr_karatsuba):
// three 78-product squares (sqr_wide) and the same two reductions, which
// leave ptxas no register moves; the same bits as the reference's complex
// squaring, c0 = (a0 + a1)(a0 - a1), c1 = 2*a0*a1.  crypto_tpu_torch/time_sqr_designs.py
// times it against the complex squaring with lazy reduction and the CIOS
// form before it.
//
// Bound on the H100: a product moves 96 bytes in per operand and 96 out
// (288) against 3 x 144 + 2 x 156 = 744 32x32->64-bit products (1,488
// 32-bit multiply-adds); a square moves 192 against 3 x 78 + 2 x 156 =
// 546.  Both sit just on the operations side of the balance point, like
// mont_mul; only the operands and the result touch memory.
#include "field.cuh"

namespace {

using ctt::FQ2_LIMBS;
constexpr int T = 128;

__global__ void __launch_bounds__(T) fq2_mul_kernel(const uint32_t* __restrict__ a,
                                                    const uint32_t* __restrict__ b,
                                                    uint32_t* __restrict__ out, long long M,
                                                    ctt::Fq m, ctt::FqSquare p2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[FQ2_LIMBS], y[FQ2_LIMBS];
  ctt::load<FQ2_LIMBS>(x, a, M, i);
  ctt::load<FQ2_LIMBS>(y, b, M, i);
  ctt::fq2_mul(x, x, y, m, p2);
  ctt::store<FQ2_LIMBS>(out, x, M, i);
}

__global__ void __launch_bounds__(T) fq2_sqr_kernel(const uint32_t* __restrict__ a,
                                                    uint32_t* __restrict__ out, long long M,
                                                    ctt::Fq m, ctt::FqSquare p2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[FQ2_LIMBS];
  ctt::load<FQ2_LIMBS>(x, a, M, i);
  ctt::fq2_sqr_karatsuba(x, x, m, p2);
  ctt::store<FQ2_LIMBS>(out, x, M, i);
}

}  // namespace

extern "C" int crypto_fq2_mul(const void* a, const void* b, void* out, long long M,
                              const void* p, unsigned int n0inv, void* stream) {
  fq2_mul_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, M,
      ctt::make_mod<ctt::FQ_LIMBS>((const uint32_t*)p, n0inv),
      ctt::make_fq_square((const uint32_t*)p));
  return (int)cudaGetLastError();
}

extern "C" int crypto_fq2_sqr(const void* a, void* out, long long M, const void* p,
                              unsigned int n0inv, void* stream) {
  fq2_sqr_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, M,
      ctt::make_mod<ctt::FQ_LIMBS>((const uint32_t*)p, n0inv),
      ctt::make_fq_square((const uint32_t*)p));
  return (int)cudaGetLastError();
}
