// Batched Jacobian -> affine normalisation by Fermat inversion (BLS12-381
// G1), one thread a point, the whole chain in registers.
//
// Replaces crypto_tpu/ops/pallas/curve_kernels.py _mul_call_for, the
// batched Montgomery-mul kernel that make_normalize_fn scans about 770
// times: z^(p-2) by left-to-right square-and-multiply over the bits of
// p - 2, then x * z^-2 and y * z^-3, and Z set to the Montgomery 1, or
// to 0 for an infinite point (0^(p-2) = 0).  The TPU kernel computes one
// mul per launch; this kernel computes what the scan of those muls
// computes, in one launch:
//   normalize(X, Y, Z) -> (x, y, z)
//
// Bound on the H100: 380 squarings, 228 multiplies and 4 more Montgomery
// muls a point against 6 coordinates moved, so it is bound by the integer
// multiply rate by two orders of magnitude; the bound counts the 460
// products of a 5-bit sliding-window chain for p - 2, not the 608 of the
// binary chain run here.  The exponent's bits are the
// same for every thread, so the square-and-multiply branch never diverges.
#include "field.cuh"

namespace {

using ctt::FQ_LIMBS;
using ctt::Fq;
constexpr int T = 128;

struct Limbs {
  uint32_t w[FQ_LIMBS];
};

__global__ void __launch_bounds__(T) normalize_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const uint32_t* __restrict__ z, uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
    uint32_t* __restrict__ zo, long long M, Fq m, ctt::Exponent e, Limbs one) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t Z[FQ_LIMBS], acc[FQ_LIMBS], t[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(Z, z, M, i);
  ctt::pow_fixed<FQ_LIMBS>(acc, Z, e, m);                  // z^(p-2)
  uint32_t inv2[FQ_LIMBS];
  ctt::mont_mul<FQ_LIMBS>(inv2, acc, acc, m);              // z^-2
  ctt::load<FQ_LIMBS>(t, x, M, i);
  ctt::mont_mul<FQ_LIMBS>(t, t, inv2, m);
  ctt::store<FQ_LIMBS>(xo, t, M, i);
  ctt::mont_mul<FQ_LIMBS>(acc, inv2, acc, m);              // z^-3
  ctt::load<FQ_LIMBS>(t, y, M, i);
  ctt::mont_mul<FQ_LIMBS>(t, t, acc, m);
  ctt::store<FQ_LIMBS>(yo, t, M, i);
  const bool inf = ctt::is_zero<FQ_LIMBS>(Z);
#pragma unroll
  for (int j = 0; j < FQ_LIMBS; ++j) t[j] = inf ? 0u : one.w[j];
  ctt::store<FQ_LIMBS>(zo, t, M, i);
}

}  // namespace

// e: the limbs of p - 2; one: the limbs of the Montgomery 1 (R mod p).
extern "C" int crypto_normalize(const void* x, const void* y, const void* z, void* xo,
                                void* yo, void* zo, long long M, const void* p,
                                unsigned int n0inv, const void* e, const void* one,
                                void* stream) {
  static_assert(ctt::EXP_WORDS == FQ_LIMBS, "p - 2 is passed in FQ_LIMBS words");
  const ctt::Exponent ex = ctt::make_exponent((const uint32_t*)e);
  Limbs r;
  for (int j = 0; j < FQ_LIMBS; ++j) r.w[j] = ((const uint32_t*)one)[j];
  if (ex.top < 0) return (int)cudaErrorInvalidValue;
  normalize_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)xo,
      (uint32_t*)yo, (uint32_t*)zo, M, ctt::make_mod<FQ_LIMBS>((const uint32_t*)p, n0inv),
      ex, r);
  return (int)cudaGetLastError();
}
