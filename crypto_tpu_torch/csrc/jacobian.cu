// Jacobian point arithmetic on a short Weierstrass curve with a = 0, one
// thread a point, instantiated for BLS12-381 G1 (L = 12 limbs) and BN254
// G1 (L = 8); the C entry points take L at run time (ctt::by_limbs).
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

using ctt::plain_one;
constexpr int T = 128;

template <int N>
__device__ __forceinline__ void zero(uint32_t r[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = 0u;
}

// blocks an SM of the full add.  An SM's four schedulers hold 16,384
// registers each: at 194 registers a thread 2 warps fit on each, 8 an SM;
// 3 warps on each (blocks of 128 x 3, 64 x 5, 32 x 11) cap a thread at
// 168, and the full add spills there
constexpr int FULL_ADD_BLOCKS = 2;

template <int N>
__global__ void __launch_bounds__(T, FULL_ADD_BLOCKS) full_add_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
    int* __restrict__ flag, long long M, ctt::Mod<N> m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t a[N], b[N];
  ctt::load<N>(a, z1, M, i);
  ctt::load<N>(b, z2, M, i);
  const bool p_inf = ctt::is_zero<N>(a);
  if (p_inf || ctt::is_zero<N>(b)) {  // pass the other point through
    const uint32_t* src[3] = {p_inf ? x2 : x1, p_inf ? y2 : y1, p_inf ? z2 : z1};
    uint32_t* dst[3] = {x3, y3, z3};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ctt::load<N>(a, src[c], M, i);
      ctt::store<N>(dst[c], a, M, i);
    }
    flag[i] = 0;
    return;
  }
  uint32_t Z1Z1[N], Z2Z2[N], U1[N], H[N];
  ctt::mont_sqr<N>(Z1Z1, a, m);
  ctt::mont_sqr<N>(Z2Z2, b, m);
  ctt::load<N>(a, z1, M, i);
  ctt::load<N>(b, z2, M, i);
  ctt::add<N>(a, a, b, m);
  ctt::mont_sqr<N>(a, a, m);
  ctt::sub<N>(a, a, Z1Z1, m);
  ctt::sub<N>(H, a, Z2Z2, m);                       // 2 Z1 Z2, for Z3
  ctt::load<N>(a, x1, M, i);
  ctt::mont_mul_eo<N>(U1, a, Z2Z2, m);              // U1 = X1*Z2Z2
  ctt::load<N>(b, x2, M, i);
  ctt::mont_mul_eo<N>(b, b, Z1Z1, m);
  ctt::sub<N>(a, b, U1, m);                         // H = X2*Z1Z1 - U1
  ctt::mont_mul_eo<N>(H, H, a, m);
  ctt::store<N>(z3, H, M, i);                       // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  ctt::copy<N>(H, a);
  uint32_t S1[N], r[N];
  ctt::load<N>(a, y1, M, i);
  ctt::load<N>(b, z2, M, i);
  ctt::mont_mul_eo<N>(a, a, b, m);
  ctt::mont_mul_eo<N>(S1, a, Z2Z2, m);              // S1 = Y1*Z2*Z2Z2
  ctt::load<N>(r, y2, M, i);
  ctt::load<N>(b, z1, M, i);
  ctt::mont_mul_eo<N>(r, r, b, m);
  ctt::mont_mul_eo<N>(r, r, Z1Z1, m);
  ctt::sub<N>(r, r, S1, m);
  ctt::add<N>(r, r, r, m);                          // r = 2*(Y2*Z1*Z1Z1 - S1)
  const bool h0 = ctt::is_zero<N>(H);
  const bool r0 = ctt::is_zero<N>(r);
  ctt::add<N>(a, H, H, m);
  ctt::mont_sqr<N>(a, a, m);                        // I = (2H)^2
  ctt::mont_mul_eo<N>(H, H, a, m);                  // J = H*I
  ctt::mont_mul_eo<N>(b, U1, a, m);                 // V = U1*I
  ctt::mont_sqr<N>(a, r, m);
  ctt::sub<N>(a, a, H, m);
  ctt::sub<N>(a, a, b, m);
  ctt::sub<N>(a, a, b, m);                          // X3 = r^2 - J - 2V
  ctt::sub<N>(b, b, a, m);
  const bool opposite = h0 && !r0;                         // P + (-P): (1, 1, 0)
  if (opposite) plain_one<N>(a);
  ctt::store<N>(x3, a, M, i);
  ctt::mont_mul_eo<N>(b, r, b, m);
  ctt::mont_mul_eo<N>(a, S1, H, m);
  ctt::add<N>(a, a, a, m);
  ctt::sub<N>(b, b, a, m);                          // Y3 = r(V - X3) - 2 S1 J
  if (opposite) plain_one<N>(b);
  ctt::store<N>(y3, b, M, i);
  flag[i] = (h0 && r0) ? 1 : 0;
}

template <int N>
__global__ void __launch_bounds__(T) mixed_add_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
    int* __restrict__ flag, long long M, ctt::Mod<N> m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t X1[N], Y1[N], H[N], r[N], t[N];
  uint32_t I[N], J[N], V[N];
  ctt::load<N>(X1, x1, M, i);
  ctt::load<N>(Y1, y1, M, i);
  ctt::load<N>(t, x2, M, i);
  ctt::sub<N>(H, t, X1, m);                         // H = X2 - X1
  ctt::load<N>(t, y2, M, i);
  ctt::sub<N>(r, t, Y1, m);
  ctt::add<N>(r, r, r, m);                          // r = 2(Y2 - Y1)
  ctt::mont_mul<N>(t, H, H, m);
  ctt::add<N>(t, t, t, m);
  ctt::add<N>(I, t, t, m);                          // I = 4 H^2
  ctt::mont_mul<N>(J, H, I, m);
  ctt::mont_mul<N>(V, X1, I, m);
  uint32_t X3[N], Y3[N], Z3[N];
  ctt::mont_mul<N>(t, r, r, m);
  ctt::sub<N>(t, t, J, m);
  ctt::add<N>(X3, V, V, m);
  ctt::sub<N>(X3, t, X3, m);                        // X3 = r^2 - J - 2V
  ctt::sub<N>(t, V, X3, m);
  ctt::mont_mul<N>(Y3, r, t, m);
  ctt::mont_mul<N>(t, Y1, J, m);
  ctt::add<N>(t, t, t, m);
  ctt::sub<N>(Y3, Y3, t, m);                        // Y3 = r(V - X3) - 2 Y1 J
  ctt::add<N>(Z3, H, H, m);                         // Z3 = 2H
  const bool h0 = ctt::is_zero<N>(H);
  const bool r0 = ctt::is_zero<N>(r);
  if (h0 && !r0) {
    plain_one<N>(X3);
    plain_one<N>(Y3);
    zero<N>(Z3);
  }
  ctt::store<N>(x3, X3, M, i);
  ctt::store<N>(y3, Y3, M, i);
  ctt::store<N>(z3, Z3, M, i);
  flag[i] = (h0 && r0) ? 1 : 0;
}

// blocks an SM of the double: ptxas takes 168 registers for it at 1 to 3
// (3 warps on each scheduler); 4 cap it at 128 and it spills
constexpr int DOUBLE_BLOCKS = 3;

template <int N>
__global__ void __launch_bounds__(T, DOUBLE_BLOCKS) double_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ z1, uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
    uint32_t* __restrict__ z3, long long M, ctt::Mod<N> m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t a[N], b[N], C[N];
  ctt::load<N>(a, y1, M, i);
  ctt::load<N>(b, z1, M, i);
  const bool bad = ctt::is_zero<N>(a) || ctt::is_zero<N>(b);
  ctt::mont_mul_eo<N>(b, a, b, m);
  ctt::add<N>(b, b, b, m);                          // Z3 = 2 Y1 Z1
  if (bad) zero<N>(b);
  ctt::store<N>(z3, b, M, i);
  ctt::mont_sqr<N>(a, a, m);                        // B = Y1^2
  ctt::mont_sqr<N>(C, a, m);                        // C = B^2
  ctt::load<N>(b, x1, M, i);
  ctt::add<N>(a, b, a, m);
  ctt::mont_sqr<N>(a, a, m);
  ctt::mont_sqr<N>(b, b, m);                        // A = X1^2
  ctt::sub<N>(a, a, b, m);
  ctt::sub<N>(a, a, C, m);
  uint32_t D[N], E[N];
  ctt::add<N>(D, a, a, m);                          // D = 2((X1+B)^2 - A - C)
  ctt::add<N>(E, b, b, m);
  ctt::add<N>(E, E, b, m);                          // E = 3A
  ctt::mont_sqr<N>(a, E, m);
  ctt::add<N>(b, D, D, m);
  ctt::sub<N>(a, a, b, m);                          // X3 = E^2 - 2D
  ctt::sub<N>(b, D, a, m);
  if (bad) plain_one<N>(a);
  ctt::store<N>(x3, a, M, i);
  ctt::mont_mul_eo<N>(b, E, b, m);
  ctt::add<N>(C, C, C, m);
  ctt::add<N>(C, C, C, m);
  ctt::add<N>(C, C, C, m);
  ctt::sub<N>(b, b, C, m);                          // Y3 = E(D - X3) - 8C
  if (bad) plain_one<N>(b);
  ctt::store<N>(y3, b, M, i);
}

// kernel<N> over M points for the run-time limb count L, the modulus by value
#define LAUNCH(kernel, M, stream, ...)                                             \
  ctt::by_limbs(L, [&](auto n) {                                                   \
    constexpr int N = decltype(n)::value;                                          \
    kernel<N><<<ctt::blocks_for(M, T), T, 0, (cudaStream_t)stream>>>(             \
        __VA_ARGS__, M, ctt::make_mod<N>((const uint32_t*)p, n0inv));              \
    return cudaSuccess;                                                            \
  })

}  // namespace

extern "C" int crypto_jac_add(const void* x1, const void* y1, const void* z1,
                              const void* x2, const void* y2, const void* z2, void* x3,
                              void* y3, void* z3, void* flag, long long M, int L,
                              const void* p, unsigned int n0inv, void* stream) {
  return LAUNCH(full_add_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const uint32_t*)z1, (const uint32_t*)x2, (const uint32_t*)y2,
                (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3,
                (int*)flag);
}

extern "C" int crypto_jac_add_mixed(const void* x1, const void* y1, const void* x2,
                                    const void* y2, void* x3, void* y3, void* z3,
                                    void* flag, long long M, int L, const void* p,
                                    unsigned int n0inv, void* stream) {
  return LAUNCH(mixed_add_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const uint32_t*)x2, (const uint32_t*)y2, (uint32_t*)x3, (uint32_t*)y3,
                (uint32_t*)z3, (int*)flag);
}

extern "C" int crypto_jac_double(const void* x1, const void* y1, const void* z1, void* x3,
                                 void* y3, void* z3, long long M, int L, const void* p,
                                 unsigned int n0inv, void* stream) {
  return LAUNCH(double_kernel, M, stream, (const uint32_t*)x1, (const uint32_t*)y1,
                (const uint32_t*)z1, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3);
}
