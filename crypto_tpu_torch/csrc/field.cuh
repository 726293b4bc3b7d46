// Shared device code of the port's kernels: prime-field arithmetic on
// N 32-bit limbs held in registers, the batched-affine level helpers
// that affine_level.cu and chunked_level.cu both use (the total formula
// and the doubling-free fast one), and Fq2 arithmetic for fq2_mul.cu and
// affine_level_fq2.cu.
//
// Layout: a batch of M field elements is limb-major, (N, M) uint32 (int32
// tensors on the Python side); thread i reads limb j of element i at
// j*M + i, so a warp's loads of one limb are contiguous.
//
// Every function below computes exactly what the plain PyTorch versions
// in crypto_tpu_torch compute (canonical results for canonical inputs), so
// kernels and plain versions agree bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ctt {

template <int N>
struct Mod {
  uint32_t p[N];
  uint32_t n0inv;  // -p^-1 mod 2^32
};

template <int N>
__host__ inline Mod<N> make_mod(const uint32_t* p, uint32_t n0inv) {
  Mod<N> m;
  for (int i = 0; i < N; ++i) m.p[i] = p[i];
  m.n0inv = n0inv;
  return m;
}

template <int N>
__device__ __forceinline__ void load(uint32_t r[N], const uint32_t* __restrict__ a,
                                     long long M, long long i) {
#pragma unroll
  for (int l = 0; l < N; ++l) r[l] = a[l * M + i];
}

template <int N>
__device__ __forceinline__ void store(uint32_t* __restrict__ a, const uint32_t r[N],
                                      long long M, long long i) {
#pragma unroll
  for (int l = 0; l < N; ++l) a[l * M + i] = r[l];
}

template <int N>
__device__ __forceinline__ void copy(uint32_t r[N], const uint32_t a[N]) {
#pragma unroll
  for (int l = 0; l < N; ++l) r[l] = a[l];
}

// r = cond ? a : b
template <int N>
__device__ __forceinline__ void sel(uint32_t r[N], bool cond, const uint32_t a[N],
                                    const uint32_t b[N]) {
#pragma unroll
  for (int l = 0; l < N; ++l) r[l] = cond ? a[l] : b[l];
}

template <int N>
__device__ __forceinline__ bool is_zero(const uint32_t a[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int l = 0; l < N; ++l) acc |= a[l];
  return acc == 0;
}

template <int N>
__device__ __forceinline__ bool eq(const uint32_t a[N], const uint32_t b[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int l = 0; l < N; ++l) acc |= a[l] ^ b[l];
  return acc == 0;
}

// Montgomery product r = a*b*2^(-32N) mod p, CIOS (coarsely integrated
// operand scanning).  Returns (a*b + m*p)/R, less p once if that is >= p:
// canonical for canonical inputs, and the same value as the plain
// version for any inputs below R.  r may alias a or b.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t r[N], const uint32_t a[N],
                                         const uint32_t b[N], const Mod<N>& m) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t mi = t[0] * m.n0inv;
    s = (uint64_t)mi * m.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)mi * m.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  uint32_t d[N];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)t[j] - m.p[j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  bool ge = (t[N] != 0) || (br == 0);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = ge ? d[j] : t[j];
}

// r = a + b mod p (a, b < p)
template <int N>
__device__ __forceinline__ void add(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N], const Mod<N>& m) {
  uint32_t s[N], d[N];
  uint32_t c = 0, br = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t t = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t t = (uint64_t)s[j] - m.p[j] - br;
    d[j] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
  bool keep = (br != 0) && (c == 0);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = keep ? s[j] : d[j];
}

// r = a - b mod p (a, b < p)
template <int N>
__device__ __forceinline__ void sub(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N], const Mod<N>& m) {
  uint32_t d[N];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t t = (uint64_t)a[j] - b[j] - br;
    d[j] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
  uint32_t c = 0;
  uint32_t mask = br ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t t = (uint64_t)d[j] + (m.p[j] & mask) + c;
    r[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
}

// r = -a mod p, with -0 = 0
template <int N>
__device__ __forceinline__ void neg(uint32_t r[N], const uint32_t a[N], const Mod<N>& m) {
  bool z = is_zero<N>(a);
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t t = (uint64_t)m.p[j] - a[j] - br;
    r[j] = z ? 0u : (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
}

// ---------------------------------------------------------------------------
// batched-affine level helpers (BLS12-381 Fq, N = 12)
// ---------------------------------------------------------------------------

constexpr int FQ_LIMBS = 12;
using Fq = Mod<FQ_LIMBS>;

// Denominator of the total unified affine add/double of P1 + P2, and the
// case masks: d = 2*y1 when doubling, else x2 - x1; a plain limb-0 1 in
// dead lanes (an infinite operand, P + (-P), or d == 0) so the inversion
// stays valid.  The prefix and down kernels of the chunked level both call
// this, so they multiply the identical d values.
__device__ __forceinline__ void denom_dbl_inf(uint32_t d[FQ_LIMBS], bool& is_dbl,
                                              bool& is_inf3, const uint32_t x1[FQ_LIMBS],
                                              const uint32_t y1[FQ_LIMBS],
                                              const uint32_t x2[FQ_LIMBS],
                                              const uint32_t y2[FQ_LIMBS], bool i1,
                                              bool i2, const Fq& m) {
  bool same_x = eq<FQ_LIMBS>(x1, x2);
  uint32_t t[FQ_LIMBS];
  neg<FQ_LIMBS>(t, y2, m);
  bool y_opp = eq<FQ_LIMBS>(y1, t);
  bool both = !i1 && !i2;
  is_dbl = same_x && !y_opp && both;
  is_inf3 = (same_x && y_opp && both) || (i1 && i2);
  bool dead = !both || is_inf3;
  if (is_dbl) {
    add<FQ_LIMBS>(d, y1, y1, m);
  } else {
    sub<FQ_LIMBS>(d, x2, x1, m);
  }
  if (dead || is_zero<FQ_LIMBS>(d)) {
#pragma unroll
    for (int j = 0; j < FQ_LIMBS; ++j) d[j] = j == 0 ? 1u : 0u;
  }
}

// Denominator of the doubling-free affine add (crypto_tpu's _denom_fast):
// d = x2 - x1, a plain limb-0 1 where either operand is infinite, and
// inf3 = both infinite.  d == 0 (P + P or P + (-P)) stays 0: the caller
// detects it and reruns the window with the total formula.  Prefix and
// down of the fast chunked level both call this.
__device__ __forceinline__ void denom_fast(uint32_t d[FQ_LIMBS], bool& is_inf3,
                                           const uint32_t x1[FQ_LIMBS],
                                           const uint32_t x2[FQ_LIMBS], bool i1, bool i2,
                                           const Fq& m) {
  sub<FQ_LIMBS>(d, x2, x1, m);
  if (i1 || i2) {
#pragma unroll
    for (int j = 0; j < FQ_LIMBS; ++j) d[j] = j == 0 ? 1u : 0u;
  }
  is_inf3 = i1 && i2;
}

// The distinct-points affine add given dinv = 1/(x2 - x1): lambda =
// (y2 - y1) * dinv, x3 = lambda^2 - x1 - x2, y3 = lambda*(x1 - x3) - y1
// (3 Montgomery muls); an infinite operand passes the other one through.
__device__ __forceinline__ void fast_apply(uint32_t x3[FQ_LIMBS], uint32_t y3[FQ_LIMBS],
                                           const uint32_t x1[FQ_LIMBS],
                                           const uint32_t y1[FQ_LIMBS],
                                           const uint32_t x2[FQ_LIMBS],
                                           const uint32_t y2[FQ_LIMBS],
                                           const uint32_t dinv[FQ_LIMBS], bool i1, bool i2,
                                           const Fq& m) {
  uint32_t t[FQ_LIMBS], lam[FQ_LIMBS];
  sub<FQ_LIMBS>(t, y2, y1, m);
  mont_mul<FQ_LIMBS>(lam, t, dinv, m);
  mont_mul<FQ_LIMBS>(t, lam, lam, m);
  sub<FQ_LIMBS>(t, t, x1, m);
  sub<FQ_LIMBS>(x3, t, x2, m);
  sub<FQ_LIMBS>(t, x1, x3, m);
  mont_mul<FQ_LIMBS>(t, lam, t, m);
  sub<FQ_LIMBS>(y3, t, y1, m);
  if (i1) {
    copy<FQ_LIMBS>(x3, x2);
    copy<FQ_LIMBS>(y3, y2);
  } else if (i2) {
    copy<FQ_LIMBS>(x3, x1);
    copy<FQ_LIMBS>(y3, y1);
  }
}

// Given dinv = 1/d: lambda = (3*x1^2 when doubling, else y2 - y1) * dinv,
// x3 = lambda^2 - x1 - x2, y3 = lambda*(x1 - x3) - y1; an infinite
// operand passes the other one through.
__device__ __forceinline__ void unified_apply(uint32_t x3[FQ_LIMBS], uint32_t y3[FQ_LIMBS],
                                              const uint32_t x1[FQ_LIMBS],
                                              const uint32_t y1[FQ_LIMBS],
                                              const uint32_t x2[FQ_LIMBS],
                                              const uint32_t y2[FQ_LIMBS],
                                              const uint32_t dinv[FQ_LIMBS], bool is_dbl,
                                              bool i1, bool i2, const Fq& m) {
  uint32_t num[FQ_LIMBS], t[FQ_LIMBS], lam[FQ_LIMBS];
  if (is_dbl) {
    mont_mul<FQ_LIMBS>(t, x1, x1, m);
    add<FQ_LIMBS>(num, t, t, m);
    add<FQ_LIMBS>(num, num, t, m);
  } else {
    sub<FQ_LIMBS>(num, y2, y1, m);
  }
  mont_mul<FQ_LIMBS>(lam, num, dinv, m);
  mont_mul<FQ_LIMBS>(t, lam, lam, m);
  sub<FQ_LIMBS>(t, t, x1, m);
  sub<FQ_LIMBS>(x3, t, x2, m);
  sub<FQ_LIMBS>(t, x1, x3, m);
  mont_mul<FQ_LIMBS>(t, lam, t, m);
  sub<FQ_LIMBS>(y3, t, y1, m);
  if (i1) {
    copy<FQ_LIMBS>(x3, x2);
    copy<FQ_LIMBS>(y3, y2);
  } else if (i2) {
    copy<FQ_LIMBS>(x3, x1);
    copy<FQ_LIMBS>(y3, y1);
  }
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1) over BLS12-381 Fq (beta = -1)
// ---------------------------------------------------------------------------
//
// An element is 24 limbs: c0's 12 in [0, 12), c1's in [12, 24), which is
// the (24, M) row order of the Python side (crypto_tpu_torch.fields.ttower).
// add, sub, neg, eq and is_zero are the base templates on each half (or on
// all 24 limbs at once for eq and is_zero); a product takes three
// Montgomery products, a square two.

constexpr int FQ2_LIMBS = 2 * FQ_LIMBS;

__device__ __forceinline__ void fq2_add(uint32_t r[FQ2_LIMBS], const uint32_t a[FQ2_LIMBS],
                                        const uint32_t b[FQ2_LIMBS], const Fq& m) {
  add<FQ_LIMBS>(r, a, b, m);
  add<FQ_LIMBS>(r + FQ_LIMBS, a + FQ_LIMBS, b + FQ_LIMBS, m);
}

__device__ __forceinline__ void fq2_sub(uint32_t r[FQ2_LIMBS], const uint32_t a[FQ2_LIMBS],
                                        const uint32_t b[FQ2_LIMBS], const Fq& m) {
  sub<FQ_LIMBS>(r, a, b, m);
  sub<FQ_LIMBS>(r + FQ_LIMBS, a + FQ_LIMBS, b + FQ_LIMBS, m);
}

__device__ __forceinline__ void fq2_neg(uint32_t r[FQ2_LIMBS], const uint32_t a[FQ2_LIMBS],
                                        const Fq& m) {
  neg<FQ_LIMBS>(r, a, m);
  neg<FQ_LIMBS>(r + FQ_LIMBS, a + FQ_LIMBS, m);
}

// r = a*b by Karatsuba over three Montgomery products (crypto_tpu's
// Fq2Ctx.mul): v0 = a0*b0, v1 = a1*b1, c0 = v0 - v1, c1 = (a0 + a1)(b0 +
// b1) - v0 - v1.  r may alias a or b.
__device__ __forceinline__ void fq2_mul(uint32_t r[FQ2_LIMBS], const uint32_t a[FQ2_LIMBS],
                                        const uint32_t b[FQ2_LIMBS], const Fq& m) {
  uint32_t v0[FQ_LIMBS], v1[FQ_LIMBS], s[FQ_LIMBS], t[FQ_LIMBS];
  mont_mul<FQ_LIMBS>(v0, a, b, m);
  mont_mul<FQ_LIMBS>(v1, a + FQ_LIMBS, b + FQ_LIMBS, m);
  add<FQ_LIMBS>(s, a, a + FQ_LIMBS, m);
  add<FQ_LIMBS>(t, b, b + FQ_LIMBS, m);
  mont_mul<FQ_LIMBS>(t, s, t, m);
  sub<FQ_LIMBS>(r, v0, v1, m);
  sub<FQ_LIMBS>(t, t, v0, m);
  sub<FQ_LIMBS>(r + FQ_LIMBS, t, v1, m);
}

// r = a^2 by complex squaring over two Montgomery products (crypto_tpu's
// Fq2Ctx.square): c0 = (a0 + a1)(a0 - a1), c1 = 2*a0*a1.  r may alias a.
__device__ __forceinline__ void fq2_sqr(uint32_t r[FQ2_LIMBS], const uint32_t a[FQ2_LIMBS],
                                        const Fq& m) {
  uint32_t s[FQ_LIMBS], t[FQ_LIMBS];
  add<FQ_LIMBS>(s, a, a + FQ_LIMBS, m);
  sub<FQ_LIMBS>(t, a, a + FQ_LIMBS, m);
  mont_mul<FQ_LIMBS>(s, s, t, m);
  mont_mul<FQ_LIMBS>(t, a, a + FQ_LIMBS, m);
  copy<FQ_LIMBS>(r, s);
  add<FQ_LIMBS>(r + FQ_LIMBS, t, t, m);
}

inline int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace ctt
