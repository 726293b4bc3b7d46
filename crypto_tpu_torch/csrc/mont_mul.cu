// Batched Montgomery multiplication, (N, M) x (N, M) -> (N, M), and
// batched fixed-exponent powers, (N, M) -> (N, M), limb-major.
//
// mont_mul replaces crypto_tpu/ops/pallas/field_kernels.py mont_mul_t_fn
// (the TPU kernel behind every device field mul and batch_inv_t).  One
// thread per element; CIOS over N 32-bit limbs in registers (field.cuh
// mont_mul: a row adds a*b_i in two PTX carry chains, the even limbs'
// products then the odd limbs', each product's low and high halves side
// by side, mad.lo.cc / madc.hi.cc, which ptxas issues as 64-bit
// multiply-adds with carry; then the same for m_i*p), the modulus by value
// in the kernel parameters (constant bank).
// N = 12 (BLS12-381 Fq) and N = 8 (Fr) are instantiated.
//
// mont_pow computes what the reference's JField.pow_fixed computes, a
// lax.scan of square-and-multiply steps over mont_mul: a^e for a fixed e,
// here the whole chain in one launch.  One thread per element with the
// accumulator and the base in registers, a `#pragma unroll 1` loop over
// e's bits left to right (field.cuh pow_fixed), e by value in the kernel
// parameters.  TField.inv's Fermat root (e = p - 2: 380 squares, 228
// multiplies) is one launch instead of 608.
//
// Bounds on the H100: mont_mul moves 48 bytes in per operand and 48 out
// (N = 12) against 2N^2 + N = 300 wide products (600 32-bit multiply-
// adds): near the balance point of the card's integer multiply rate and
// its memory rate, on the bytes side.  mont_pow moves 96 bytes an element;
// its bound counts the products of a short addition chain for e, not the
// binary chain it runs (a 5-bit sliding window: 460 products for p - 2
// against 608): bound by the multiply rate at width, and at the MSM's
// roots (1 to 16 elements) by the latency of one thread's dependent
// products, which no byte or operation count sees.
#include "field.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(256) mont_mul_kernel(const uint32_t* __restrict__ a,
                                                       const uint32_t* __restrict__ b,
                                                       uint32_t* __restrict__ out,
                                                       long long M, ctt::Mod<N> m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[N], y[N], r[N];
  ctt::load<N>(x, a, M, i);
  ctt::load<N>(y, b, M, i);
  ctt::mont_mul<N>(r, x, y, m);
  ctt::store<N>(out, r, M, i);
}

template <int N>
__global__ void __launch_bounds__(128) mont_pow_kernel(const uint32_t* __restrict__ a,
                                                       uint32_t* __restrict__ out,
                                                       long long M, ctt::Mod<N> m,
                                                       ctt::Exponent e) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[N];
  ctt::load<N>(x, a, M, i);
  ctt::pow_fixed<N>(x, x, e, m);
  ctt::store<N>(out, x, M, i);
}

template <int N>
void launch_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, long long M,
                const uint32_t* p, uint32_t n0inv, cudaStream_t s) {
  const int T = 256;
  mont_mul_kernel<N><<<ctt::blocks_for(M, T), T, 0, s>>>(a, b, out, M,
                                                         ctt::make_mod<N>(p, n0inv));
}

template <int N>
void launch_pow(const uint32_t* a, uint32_t* out, long long M, const uint32_t* p,
                uint32_t n0inv, const ctt::Exponent& e, cudaStream_t s) {
  const int T = 128;
  mont_pow_kernel<N><<<ctt::blocks_for(M, T), T, 0, s>>>(a, out, M,
                                                         ctt::make_mod<N>(p, n0inv), e);
}

}  // namespace

extern "C" int crypto_mont_mul(const void* a, const void* b, void* out, long long M,
                               int L, const void* p, unsigned int n0inv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  const uint32_t* pp = (const uint32_t*)p;
  if (L == 12) {
    launch_mul<12>(pa, pb, po, M, pp, n0inv, s);
  } else if (L == 8) {
    launch_mul<8>(pa, pb, po, M, pp, n0inv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// e: ctt::EXP_WORDS 32-bit words of the exponent, least significant
// first; e >= 1.
extern "C" int crypto_mont_pow(const void* a, void* out, long long M, int L, const void* p,
                               unsigned int n0inv, const void* e, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ctt::Exponent ex = ctt::make_exponent((const uint32_t*)e);
  if (ex.top < 0) return (int)cudaErrorInvalidValue;
  const uint32_t* pa = (const uint32_t*)a;
  uint32_t* po = (uint32_t*)out;
  const uint32_t* pp = (const uint32_t*)p;
  if (L == 12) {
    launch_pow<12>(pa, po, M, pp, n0inv, ex, s);
  } else if (L == 8) {
    launch_pow<8>(pa, po, M, pp, n0inv, ex, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
