// Jacobian point arithmetic on BLS12-381 G1 (a = 0), one thread a point.
//
// Replaces crypto_tpu/ops/pallas/curve_kernels.py _kernels_for
// (call_full_add / call_affine_add / call_double, behind make_add_fns):
//   full_add(X1, Y1, Z1, X2, Y2, Z2) -> (X3, Y3, Z3, flag)   add-2007-bl
//   mixed_add(X1, Y1, X2, Y2) -> (X3, Y3, Z3, flag)          mmadd-2007-bl
//   double(X1, Y1, Z1) -> (X3, Y3, Z3)                       dbl-2009-l
// with the reference's case handling: an infinite operand (Z == 0) passes
// the other one through, P + (-P) gives (1, 1, 0) with plain-1 limbs, and
// P + P is not doubled: it raises the flag (H == 0, r == 0, both finite)
// and the caller redoes the batch on a total path.  The mixed add takes
// both operands affine and finite.
//
// Bound on the H100: full add does 11 Montgomery muls and 5 squares
// against 10 coordinates moved (6 in, 3 out and the flag), so it is bound
// by the integer multiply rate; mixed add 4 muls and 2 squares against 7
// coordinates and double 2 muls and 5 squares against 6 are bound by it
// too, within a factor of about 2.5 of the byte rate.  All intermediates
// stay in registers; the reference's (L, B) blocks of 1,536 lanes in VMEM
// become one thread per point, and its lax.map over fixed blocks (a
// compile-count workaround) becomes one launch over the whole batch.
//
// The full add runs its products on even/odd accumulators (field.cuh
// mont_mul_eo: no register moves; its inputs are canonical by contract)
// and its five squares with mont_sqr (234 wide products against 300).  A
// pair with an infinite operand copies the other point and leaves.  The
// rest load each coordinate where it is needed, read Z1 and Z2 back rather
// than keep them and square Z1 + Z2 while only Z1Z1 and Z2Z2 are live.
// Z3 is stored as soon as H is known: where H = 0 it is 0, which is also
// what P + (-P) gives.  ptxas takes 194 registers for it all the same;
// capped at 168 or 128 it spills, so the full add runs 8 warps an SM.
//
// The double runs the same way: its five squares (A, B, C, (X1 + B)^2,
// E^2) on mont_sqr, its two products (Y1 Z1 and E (D - X3)) on
// mont_mul_eo, Z3 computed and stored first, while Y1 is loaded, and X1
// loaded where B is added to it, under the launch bound DOUBLE_BLOCKS
// that ptxas serves without spill.
#include "field.cuh"

namespace {

using ctt::FQ_LIMBS;
using ctt::Fq;
constexpr int T = 128;

__device__ __forceinline__ void plain_one(uint32_t r[FQ_LIMBS]) {
#pragma unroll
  for (int j = 0; j < FQ_LIMBS; ++j) r[j] = j == 0 ? 1u : 0u;
}

__device__ __forceinline__ void zero(uint32_t r[FQ_LIMBS]) {
#pragma unroll
  for (int j = 0; j < FQ_LIMBS; ++j) r[j] = 0u;
}

// blocks an SM of the full add.  An SM's four schedulers hold 16,384
// registers each: at 194 registers a thread 2 warps fit on each, 8 an SM;
// 3 warps on each (blocks of 128 x 3, 64 x 5, 32 x 11) cap a thread at
// 168, and the full add spills there
constexpr int FULL_ADD_BLOCKS = 2;

__global__ void __launch_bounds__(T, FULL_ADD_BLOCKS) full_add_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
    int* __restrict__ flag, long long M, Fq m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t a[FQ_LIMBS], b[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(a, z1, M, i);
  ctt::load<FQ_LIMBS>(b, z2, M, i);
  const bool p_inf = ctt::is_zero<FQ_LIMBS>(a);
  if (p_inf || ctt::is_zero<FQ_LIMBS>(b)) {  // pass the other point through
    const uint32_t* src[3] = {p_inf ? x2 : x1, p_inf ? y2 : y1, p_inf ? z2 : z1};
    uint32_t* dst[3] = {x3, y3, z3};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ctt::load<FQ_LIMBS>(a, src[c], M, i);
      ctt::store<FQ_LIMBS>(dst[c], a, M, i);
    }
    flag[i] = 0;
    return;
  }
  uint32_t Z1Z1[FQ_LIMBS], Z2Z2[FQ_LIMBS], U1[FQ_LIMBS], H[FQ_LIMBS];
  ctt::mont_sqr<FQ_LIMBS>(Z1Z1, a, m);
  ctt::mont_sqr<FQ_LIMBS>(Z2Z2, b, m);
  ctt::load<FQ_LIMBS>(a, z1, M, i);
  ctt::load<FQ_LIMBS>(b, z2, M, i);
  ctt::add<FQ_LIMBS>(a, a, b, m);
  ctt::mont_sqr<FQ_LIMBS>(a, a, m);
  ctt::sub<FQ_LIMBS>(a, a, Z1Z1, m);
  ctt::sub<FQ_LIMBS>(H, a, Z2Z2, m);                       // 2 Z1 Z2, for Z3
  ctt::load<FQ_LIMBS>(a, x1, M, i);
  ctt::mont_mul_eo<FQ_LIMBS>(U1, a, Z2Z2, m);              // U1 = X1*Z2Z2
  ctt::load<FQ_LIMBS>(b, x2, M, i);
  ctt::mont_mul_eo<FQ_LIMBS>(b, b, Z1Z1, m);
  ctt::sub<FQ_LIMBS>(a, b, U1, m);                         // H = X2*Z1Z1 - U1
  ctt::mont_mul_eo<FQ_LIMBS>(H, H, a, m);
  ctt::store<FQ_LIMBS>(z3, H, M, i);                       // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  ctt::copy<FQ_LIMBS>(H, a);
  uint32_t S1[FQ_LIMBS], r[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(a, y1, M, i);
  ctt::load<FQ_LIMBS>(b, z2, M, i);
  ctt::mont_mul_eo<FQ_LIMBS>(a, a, b, m);
  ctt::mont_mul_eo<FQ_LIMBS>(S1, a, Z2Z2, m);              // S1 = Y1*Z2*Z2Z2
  ctt::load<FQ_LIMBS>(r, y2, M, i);
  ctt::load<FQ_LIMBS>(b, z1, M, i);
  ctt::mont_mul_eo<FQ_LIMBS>(r, r, b, m);
  ctt::mont_mul_eo<FQ_LIMBS>(r, r, Z1Z1, m);
  ctt::sub<FQ_LIMBS>(r, r, S1, m);
  ctt::add<FQ_LIMBS>(r, r, r, m);                          // r = 2*(Y2*Z1*Z1Z1 - S1)
  const bool h0 = ctt::is_zero<FQ_LIMBS>(H);
  const bool r0 = ctt::is_zero<FQ_LIMBS>(r);
  ctt::add<FQ_LIMBS>(a, H, H, m);
  ctt::mont_sqr<FQ_LIMBS>(a, a, m);                        // I = (2H)^2
  ctt::mont_mul_eo<FQ_LIMBS>(H, H, a, m);                  // J = H*I
  ctt::mont_mul_eo<FQ_LIMBS>(b, U1, a, m);                 // V = U1*I
  ctt::mont_sqr<FQ_LIMBS>(a, r, m);
  ctt::sub<FQ_LIMBS>(a, a, H, m);
  ctt::sub<FQ_LIMBS>(a, a, b, m);
  ctt::sub<FQ_LIMBS>(a, a, b, m);                          // X3 = r^2 - J - 2V
  ctt::sub<FQ_LIMBS>(b, b, a, m);
  const bool opposite = h0 && !r0;                         // P + (-P): (1, 1, 0)
  if (opposite) plain_one(a);
  ctt::store<FQ_LIMBS>(x3, a, M, i);
  ctt::mont_mul_eo<FQ_LIMBS>(b, r, b, m);
  ctt::mont_mul_eo<FQ_LIMBS>(a, S1, H, m);
  ctt::add<FQ_LIMBS>(a, a, a, m);
  ctt::sub<FQ_LIMBS>(b, b, a, m);                          // Y3 = r(V - X3) - 2 S1 J
  if (opposite) plain_one(b);
  ctt::store<FQ_LIMBS>(y3, b, M, i);
  flag[i] = (h0 && r0) ? 1 : 0;
}

__global__ void __launch_bounds__(T) mixed_add_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
    int* __restrict__ flag, long long M, Fq m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[FQ_LIMBS], Y1[FQ_LIMBS], H[FQ_LIMBS], r[FQ_LIMBS], t[FQ_LIMBS];
  uint32_t I[FQ_LIMBS], J[FQ_LIMBS], V[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(X1, x1, M, i);
  ctt::load<FQ_LIMBS>(Y1, y1, M, i);
  ctt::load<FQ_LIMBS>(t, x2, M, i);
  ctt::sub<FQ_LIMBS>(H, t, X1, m);                         // H = X2 - X1
  ctt::load<FQ_LIMBS>(t, y2, M, i);
  ctt::sub<FQ_LIMBS>(r, t, Y1, m);
  ctt::add<FQ_LIMBS>(r, r, r, m);                          // r = 2(Y2 - Y1)
  ctt::mont_mul<FQ_LIMBS>(t, H, H, m);
  ctt::add<FQ_LIMBS>(t, t, t, m);
  ctt::add<FQ_LIMBS>(I, t, t, m);                          // I = 4 H^2
  ctt::mont_mul<FQ_LIMBS>(J, H, I, m);
  ctt::mont_mul<FQ_LIMBS>(V, X1, I, m);
  uint32_t X3[FQ_LIMBS], Y3[FQ_LIMBS], Z3[FQ_LIMBS];
  ctt::mont_mul<FQ_LIMBS>(t, r, r, m);
  ctt::sub<FQ_LIMBS>(t, t, J, m);
  ctt::add<FQ_LIMBS>(X3, V, V, m);
  ctt::sub<FQ_LIMBS>(X3, t, X3, m);                        // X3 = r^2 - J - 2V
  ctt::sub<FQ_LIMBS>(t, V, X3, m);
  ctt::mont_mul<FQ_LIMBS>(Y3, r, t, m);
  ctt::mont_mul<FQ_LIMBS>(t, Y1, J, m);
  ctt::add<FQ_LIMBS>(t, t, t, m);
  ctt::sub<FQ_LIMBS>(Y3, Y3, t, m);                        // Y3 = r(V - X3) - 2 Y1 J
  ctt::add<FQ_LIMBS>(Z3, H, H, m);                         // Z3 = 2H
  const bool h0 = ctt::is_zero<FQ_LIMBS>(H);
  const bool r0 = ctt::is_zero<FQ_LIMBS>(r);
  if (h0 && !r0) {
    plain_one(X3);
    plain_one(Y3);
    zero(Z3);
  }
  ctt::store<FQ_LIMBS>(x3, X3, M, i);
  ctt::store<FQ_LIMBS>(y3, Y3, M, i);
  ctt::store<FQ_LIMBS>(z3, Z3, M, i);
  flag[i] = (h0 && r0) ? 1 : 0;
}

// blocks an SM of the double: ptxas takes 168 registers for it at 1 to 3
// (3 warps on each scheduler); 4 cap it at 128 and it spills
constexpr int DOUBLE_BLOCKS = 3;

__global__ void __launch_bounds__(T, DOUBLE_BLOCKS) double_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ z1, uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
    uint32_t* __restrict__ z3, long long M, Fq m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t a[FQ_LIMBS], b[FQ_LIMBS], C[FQ_LIMBS];
  ctt::load<FQ_LIMBS>(a, y1, M, i);
  ctt::load<FQ_LIMBS>(b, z1, M, i);
  const bool bad = ctt::is_zero<FQ_LIMBS>(a) || ctt::is_zero<FQ_LIMBS>(b);
  ctt::mont_mul_eo<FQ_LIMBS>(b, a, b, m);
  ctt::add<FQ_LIMBS>(b, b, b, m);                          // Z3 = 2 Y1 Z1
  if (bad) zero(b);
  ctt::store<FQ_LIMBS>(z3, b, M, i);
  ctt::mont_sqr<FQ_LIMBS>(a, a, m);                        // B = Y1^2
  ctt::mont_sqr<FQ_LIMBS>(C, a, m);                        // C = B^2
  ctt::load<FQ_LIMBS>(b, x1, M, i);
  ctt::add<FQ_LIMBS>(a, b, a, m);
  ctt::mont_sqr<FQ_LIMBS>(a, a, m);
  ctt::mont_sqr<FQ_LIMBS>(b, b, m);                        // A = X1^2
  ctt::sub<FQ_LIMBS>(a, a, b, m);
  ctt::sub<FQ_LIMBS>(a, a, C, m);
  uint32_t D[FQ_LIMBS], E[FQ_LIMBS];
  ctt::add<FQ_LIMBS>(D, a, a, m);                          // D = 2((X1+B)^2 - A - C)
  ctt::add<FQ_LIMBS>(E, b, b, m);
  ctt::add<FQ_LIMBS>(E, E, b, m);                          // E = 3A
  ctt::mont_sqr<FQ_LIMBS>(a, E, m);
  ctt::add<FQ_LIMBS>(b, D, D, m);
  ctt::sub<FQ_LIMBS>(a, a, b, m);                          // X3 = E^2 - 2D
  ctt::sub<FQ_LIMBS>(b, D, a, m);
  if (bad) plain_one(a);
  ctt::store<FQ_LIMBS>(x3, a, M, i);
  ctt::mont_mul_eo<FQ_LIMBS>(b, E, b, m);
  ctt::add<FQ_LIMBS>(C, C, C, m);
  ctt::add<FQ_LIMBS>(C, C, C, m);
  ctt::add<FQ_LIMBS>(C, C, C, m);
  ctt::sub<FQ_LIMBS>(b, b, C, m);                          // Y3 = E(D - X3) - 8C
  if (bad) plain_one(b);
  ctt::store<FQ_LIMBS>(y3, b, M, i);
}

inline Fq mod_of(const void* p, unsigned int n0inv) {
  return ctt::make_mod<FQ_LIMBS>((const uint32_t*)p, n0inv);
}

}  // namespace

extern "C" int crypto_jac_add(const void* x1, const void* y1, const void* z1,
                              const void* x2, const void* y2, const void* z2, void* x3,
                              void* y3, void* z3, void* flag, long long M, const void* p,
                              unsigned int n0inv, void* stream) {
  full_add_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3,
      (uint32_t*)z3, (int*)flag, M, mod_of(p, n0inv));
  return (int)cudaGetLastError();
}

extern "C" int crypto_jac_add_mixed(const void* x1, const void* y1, const void* x2,
                                    const void* y2, void* x3, void* y3, void* z3,
                                    void* flag, long long M, const void* p,
                                    unsigned int n0inv, void* stream) {
  mixed_add_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)x2, (const uint32_t*)y2,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, (int*)flag, M, mod_of(p, n0inv));
  return (int)cudaGetLastError();
}

extern "C" int crypto_jac_double(const void* x1, const void* y1, const void* z1, void* x3,
                                 void* y3, void* z3, long long M, const void* p,
                                 unsigned int n0inv, void* stream) {
  double_kernel<<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (uint32_t*)x3,
      (uint32_t*)y3, (uint32_t*)z3, M, mod_of(p, n0inv));
  return (int)cudaGetLastError();
}
