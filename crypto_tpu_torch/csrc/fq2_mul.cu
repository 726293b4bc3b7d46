// Batched Fq2 multiplication and squaring (u^2 = -1), (2L, M) x (2L, M)
// -> (2L, M) and (2L, M) -> (2L, M), limb-major: c0's L limbs in rows [0,
// L), c1's in rows [L, 2L), Montgomery form; instantiated for BLS12-381 Fq
// (L = 12) and BN254 Fq (L = 8), the C entry points taking L at run time
// as mont_mul.cu's do.
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
// blst's mul_mont_384x): three unreduced L x L-word products, v0 =
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
// Bound on the H100: at L = 12 a product moves 96 bytes in per operand
// and 96 out (288) against 3 x 144 + 2 x 156 = 744 32x32->64-bit products
// (1,488 32-bit multiply-adds); a square moves 192 against 3 x 78 + 2 x
// 156 = 546.  At L = 8: 192 bytes against 336 products, 128 against 252.  Both sit just on the operations side of the balance point, like
// mont_mul; only the operands and the result touch memory.
#include "field.cuh"

namespace {

constexpr int T = 128;

template <int L>
__global__ void __launch_bounds__(T) fq2_mul_kernel(const uint32_t* __restrict__ a,
                                                    const uint32_t* __restrict__ b,
                                                    uint32_t* __restrict__ out, long long M,
                                                    ctt::Mod<L> m, ctt::PSquare<L> p2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[2 * L], y[2 * L];
  ctt::load<2 * L>(x, a, M, i);
  ctt::load<2 * L>(y, b, M, i);
  ctt::fq2_mul<L>(x, x, y, m, p2);
  ctt::store<2 * L>(out, x, M, i);
}

template <int L>
__global__ void __launch_bounds__(T) fq2_sqr_kernel(const uint32_t* __restrict__ a,
                                                    uint32_t* __restrict__ out, long long M,
                                                    ctt::Mod<L> m, ctt::PSquare<L> p2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[2 * L];
  ctt::load<2 * L>(x, a, M, i);
  ctt::fq2_sqr_karatsuba<L>(x, x, m, p2);
  ctt::store<2 * L>(out, x, M, i);
}

}  // namespace

extern "C" int crypto_fq2_mul(const void* a, const void* b, void* out, long long M, int L,
                              const void* p, unsigned int n0inv, void* stream) {
  return ctt::by_limbs(L, [&](auto n) {
    constexpr int N = decltype(n)::value;
    fq2_mul_kernel<N><<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, M,
        ctt::make_mod<N>((const uint32_t*)p, n0inv), ctt::make_p_square<N>((const uint32_t*)p));
    return cudaSuccess;
  });
}

extern "C" int crypto_fq2_sqr(const void* a, void* out, long long M, int L, const void* p,
                              unsigned int n0inv, void* stream) {
  return ctt::by_limbs(L, [&](auto n) {
    constexpr int N = decltype(n)::value;
    fq2_sqr_kernel<N><<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, M, ctt::make_mod<N>((const uint32_t*)p, n0inv),
        ctt::make_p_square<N>((const uint32_t*)p));
    return cudaSuccess;
  });
}
