// Batched Montgomery multiplication, (N, M) x (N, M) -> (N, M), limb-major.
//
// Replaces crypto_tpu/ops/pallas/field_kernels.py mont_mul_t_fn (the TPU
// kernel behind every device field mul and batch_inv_t).  One thread per
// element; CIOS over N 32-bit limbs in registers (field.cuh), the modulus
// by value in the kernel parameters (constant bank).  N = 12 (BLS12-381
// Fq) and N = 8 (Fr) are instantiated.
//
// Bound on the H100: 48 bytes in per operand and 48 out (N = 12) against
// 2N^2 + N wide products; near the balance point of the card's integer
// multiply rate and its memory rate.  The design keeps all intermediates
// in registers, so only operands and result touch memory.
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
void launch(const uint32_t* a, const uint32_t* b, uint32_t* out, long long M,
            const uint32_t* p, uint32_t n0inv, cudaStream_t s) {
  const int T = 256;
  mont_mul_kernel<N><<<ctt::blocks_for(M, T), T, 0, s>>>(a, b, out, M,
                                                         ctt::make_mod<N>(p, n0inv));
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
    launch<12>(pa, pb, po, M, pp, n0inv, s);
  } else if (L == 8) {
    launch<8>(pa, pb, po, M, pp, n0inv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
