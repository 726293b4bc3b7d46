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
// The Montgomery product is a CIOS whose rows run on PTX carry chains
// (ptx.cuh: mad.lo.cc / madc.hi.cc / addc.cc): mont_mul for any inputs
// below R, mont_mul_eo (on even/odd accumulators, no register moves) for
// canonical ones; the one Montgomery reduction, redc, and the square
// mont_sqr run on even/odd accumulators too.  The Fq2 product is
// Karatsuba with lazy reduction (three unreduced products, two
// reductions), and pow_fixed the square-and-multiply chain of a fixed
// exponent in one thread (pow_window a sliding-window chain on mont_sqr
// and mont_mul_eo, for canonical inputs).
//
// Every function below computes exactly what the plain PyTorch versions
// in crypto_tpu_torch compute (canonical results for canonical inputs;
// mont_mul also for any inputs below R), so kernels and plain versions
// agree bit for bit.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "ptx.cuh"

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

// ---------------------------------------------------------------------------
// Montgomery arithmetic on PTX carry chains (ptx.cuh)
// ---------------------------------------------------------------------------
//
// The running value t of a product is held in N + 2 words.  A row adds
// a*b_i (mul_row), or adds m_i*p and drops the low word, which that makes
// 0 (reduce_row).  Each row is two carry chains (mad_pass): the products
// of the even limbs, then those of the odd limbs, each product's low and
// high halves side by side in its chain, so that ptxas can issue the pair
// as one 64-bit multiply-add with carry.

// t[j] += lo(a_j*b), t[j + 1] += hi(a_j*b) for j = S, S + 2, ... < N in one
// carry chain; its carry out of t[N - 1 + S] is left in the flag.  N even.
template <int N, int S>
__device__ __forceinline__ void mad_pass(uint32_t* t, const uint32_t* a, uint32_t b) {
  static_assert(N % 2 == 0, "the passes pair limbs");
  t[S] = ptx::mad_lo_cc(a[S], b, t[S]);
  t[S + 1] = ptx::madc_hi_cc(a[S], b, t[S + 1]);
#pragma unroll
  for (int j = S + 2; j < N; j += 2) {
    t[j] = ptx::madc_lo_cc(a[j], b, t[j]);
    t[j + 1] = ptx::madc_hi_cc(a[j], b, t[j + 1]);
  }
}

// t += a*bi, for t < 2R on entry (t[N] <= 1, t[N + 1] = 0).
template <int N>
__device__ __forceinline__ void mul_row(uint32_t t[N + 2], const uint32_t a[N],
                                        uint32_t bi) {
  mad_pass<N, 0>(t, a, bi);
  t[N] = ptx::addc(t[N], 0);
  mad_pass<N, 1>(t, a, bi);
  t[N + 1] = ptx::addc(t[N + 1], 0);
}

// t = (t + m_i*p) / 2^32 with m_i = t[0] * n0inv, which makes the low word
// 0; t[N + 1] is 0 after.
template <int N>
__device__ __forceinline__ void reduce_row(uint32_t t[N + 2], const Mod<N>& m) {
  const uint32_t mi = t[0] * m.n0inv;
  mad_pass<N, 0>(t, m.p, mi);
  t[N] = ptx::addc_cc(t[N], 0);
  t[N + 1] = ptx::addc(t[N + 1], 0);
  mad_pass<N, 1>(t, m.p, mi);
  t[N + 1] = ptx::addc(t[N + 1], 0);
#pragma unroll
  for (int j = 0; j <= N; ++j) t[j] = t[j + 1];
  t[N + 1] = 0;
}

// r = the (N + 1)-word value (top, t) less p if that is >= p, else t
// (top <= 1).
template <int N>
__device__ __forceinline__ void sub_p_once(uint32_t r[N], const uint32_t t[N], uint32_t top,
                                           const Mod<N>& m) {
  uint32_t d[N];
  d[0] = ptx::sub_cc(t[0], m.p[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = ptx::subc_cc(t[j], m.p[j]);
  const bool lt = ptx::subc(top, 0) == 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = lt ? t[j] : d[j];
}

// Montgomery product r = a*b*2^(-32N) mod p, CIOS (coarsely integrated
// operand scanning): N rows of mul_row then reduce_row, 2N^2 + N wide
// products.  Returns (a*b + m*p)/R, less p once if that is >= p:
// canonical for canonical inputs, and the same value as the plain version
// for any inputs below R (t < a + p < 2R after every row).  r may alias a
// or b.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t r[N], const uint32_t a[N],
                                         const uint32_t b[N], const Mod<N>& m) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mul_row<N>(t, a, b[i]);
    reduce_row<N>(t, m);
  }
  sub_p_once<N>(r, t, t[N], m);
}

// mont_mul with its row loop rolled: b rotates down a word a row, so
// every index stays static and the product stays in registers.  The same
// operations in the same order (the same result as mont_mul), in about a
// twelfth of the code, for 11 moves more a row: for a product that a
// kernel runs rarely, whose unrolled rows would only crowd the
// instruction cache.
template <int N>
__device__ __forceinline__ void mont_mul_rolled(uint32_t r[N], const uint32_t a[N],
                                                const uint32_t b[N], const Mod<N>& m) {
  uint32_t t[N + 2], bb[N];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) bb[j] = b[j];
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    mul_row<N>(t, a, bb[0]);
    reduce_row<N>(t, m);
#pragma unroll
    for (int j = 0; j < N - 1; ++j) bb[j] = bb[j + 1];
  }
  sub_p_once<N>(r, t, t[N], m);
}

// w = a*b in 2N words, schoolbook: N rows of the same two passes, N^2
// wide products.
template <int N>
__device__ __forceinline__ void mul_wide(uint32_t w[2 * N], const uint32_t a[N],
                                         const uint32_t b[N]) {
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) w[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mad_pass<N, 0>(w + i, a, b[i]);
    w[i + N] = ptx::addc(w[i + N], 0);
    mad_pass<N, 1>(w + i, a, b[i]);  // no carry out: a*b fits 2N words
  }
}

// r = a + b and r = a - b over W words, for sums that fit and differences
// that are not negative (no carry or borrow out).
template <int W>
__device__ __forceinline__ void add_words(uint32_t r[W], const uint32_t a[W],
                                          const uint32_t b[W]) {
  r[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) r[j] = ptx::addc_cc(a[j], b[j]);
  r[W - 1] = ptx::addc(a[W - 1], b[W - 1]);
}

template <int W>
__device__ __forceinline__ void sub_words(uint32_t r[W], const uint32_t a[W],
                                          const uint32_t b[W]) {
  r[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) r[j] = ptx::subc_cc(a[j], b[j]);
  r[W - 1] = ptx::subc(a[W - 1], b[W - 1]);
}

// ---------------------------------------------------------------------------
// Montgomery arithmetic on even/odd accumulators
// ---------------------------------------------------------------------------
//
// ptxas fuses a product's mad.lo.cc and madc.hi.cc into one 64-bit
// multiply-add (IMAD.WIDE.U32.X) whose accumulator is an aligned pair of
// registers.  In mont_mul and mul_wide the pair a product adds to moves
// by a word from one pass or row to the next, and ptxas moves words into
// place: their SASS holds more moves than products, and the moves compete
// with the products for the multiply pipe.  Below, a value is kept
// as t = ev + 2^32*od, two N-word arrays: the products of a's even limbs
// go to ev's 64-bit lanes (ev[2k], ev[2k + 1]), those of its odd limbs to
// od's, so every product lands on a fixed aligned pair.  A Montgomery
// row's one-word shift becomes a swap of the two arrays' roles, ev's
// second word added into od's first, and a two-word shift of the old ev
// folded into the next odd chain (as sppark's mont_t does for moduli with
// spare top bits).  No moves; the same values as the functions above.
// Before a row's shift the value is below (a + p)*2^32, so od stays below
// a + p < R and fits its N words; ev's carry out of its N words goes into
// od's top word.

// Row i of mont_mul_eo on t = ev + 2^32*od: t = (t + a*bi + mi*p)/2^32
// with mi = t_0*n0inv, the arrays' roles swapped by the caller after it
// (ev then holds 0 in its first word).  The first row starts from t = 0.
template <int N, bool First>
__device__ __forceinline__ void eo_mul_row(uint32_t ev[N], uint32_t od[N], const uint32_t a[N],
                                           uint32_t bi, const Mod<N>& m) {
  static_assert(N % 2 == 0, "the lanes pair limbs");
  if constexpr (First) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      uint64_t w = (uint64_t)a[j] * bi;
      ev[j] = (uint32_t)w;
      ev[j + 1] = (uint32_t)(w >> 32);
      w = (uint64_t)a[j + 1] * bi;
      od[j] = (uint32_t)w;
      od[j + 1] = (uint32_t)(w >> 32);
    }
  } else {
    // the shift of the last row: ev (the old od) takes the old ev's second
    // word, the old ev moves down two words into od under the odd limbs'
    // products
    ev[0] = ptx::add_cc(ev[0], od[1]);
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
      od[j] = ptx::madc_lo_cc(a[j + 1], bi, od[j + 2]);
      od[j + 1] = ptx::madc_hi_cc(a[j + 1], bi, od[j + 3]);
    }
    od[N - 2] = ptx::madc_lo_cc(a[N - 1], bi, 0);
    od[N - 1] = ptx::madc_hi(a[N - 1], bi, 0);
    mad_pass<N, 0>(ev, a, bi);
    od[N - 1] = ptx::addc(od[N - 1], 0);
  }
  const uint32_t mi = ev[0] * m.n0inv;
  mad_pass<N, 0>(od, m.p + 1, mi);  // no carry out: od stays below 2^(32N)
  mad_pass<N, 0>(ev, m.p, mi);
  od[N - 1] = ptx::addc(od[N - 1], 0);
}

// r = ev + (od >> 32), less p once if that is >= p: the value the last
// row leaves, od + 2^32*ev with od[0] = 0 (the roles swapped), over 2^32,
// which is below 2p.
template <int N>
__device__ __forceinline__ void eo_final(uint32_t r[N], uint32_t ev[N], const uint32_t od[N],
                                         const Mod<N>& m) {
  ev[0] = ptx::add_cc(ev[0], od[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) ev[j] = ptx::addc_cc(ev[j], od[j + 1]);
  ev[N - 1] = ptx::addc(ev[N - 1], 0);
  sub_p_once<N>(r, ev, 0, m);
}

// Montgomery product r = a*b*2^(-32N) mod p, CIOS on even/odd
// accumulators: mont_mul's rows (2N^2 + N wide products) without its
// moves.  Returns (a*b + m*p)/R, less p once if that is >= p, for a < R -
// p and any b: canonical when a*b < p*R (so for inputs below 2p, and bit
// for bit mont_mul's result for canonical ones).  r may alias a or b.
template <int N>
__device__ __forceinline__ void mont_mul_eo(uint32_t r[N], const uint32_t a[N],
                                            const uint32_t b[N], const Mod<N>& m) {
  uint32_t ev[N], od[N];
  eo_mul_row<N, true>(ev, od, a, b[0], m);
  eo_mul_row<N, false>(od, ev, a, b[1], m);
#pragma unroll
  for (int i = 2; i < N; i += 2) {
    eo_mul_row<N, false>(ev, od, a, b[i], m);
    eo_mul_row<N, false>(od, ev, a, b[i + 1], m);
  }
  eo_final<N>(r, ev, od, m);
}

// A reduction row of redc: eo_mul_row without the product.
template <int N>
__device__ __forceinline__ void eo_reduce_row(uint32_t ev[N], uint32_t od[N],
                                              const Mod<N>& m) {
  ev[0] = ptx::add_cc(ev[0], od[1]);
  const uint32_t mi = ev[0] * m.n0inv;
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    od[j] = ptx::madc_lo_cc(m.p[j + 1], mi, od[j + 2]);
    od[j + 1] = ptx::madc_hi_cc(m.p[j + 1], mi, od[j + 3]);
  }
  od[N - 2] = ptx::madc_lo_cc(m.p[N - 1], mi, 0);
  od[N - 1] = ptx::madc_hi(m.p[N - 1], mi, 0);
  mad_pass<N, 0>(ev, m.p, mi);
  od[N - 1] = ptx::addc(od[N - 1], 0);
}

// Montgomery reduction r = T*R^-1 mod p, canonical, for 0 <= T < p*R in
// 2N words, on even/odd accumulators: N reduction rows over T's low half
// give (T_lo + m*p)/R <= p, then T's high half is added: (T + m*p)/R <
// 2p, so one subtraction of p ends it.  N^2 + N wide products.
template <int N>
__device__ __forceinline__ void redc(uint32_t r[N], const uint32_t T[2 * N],
                                     const Mod<N>& m) {
  uint32_t ev[N], od[N];
#pragma unroll
  for (int j = 0; j < N; ++j) ev[j] = T[j];
  {
    const uint32_t mi = ev[0] * m.n0inv;
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      const uint64_t w = (uint64_t)m.p[j + 1] * mi;
      od[j] = (uint32_t)w;
      od[j + 1] = (uint32_t)(w >> 32);
    }
    mad_pass<N, 0>(ev, m.p, mi);
    od[N - 1] = ptx::addc(od[N - 1], 0);
  }
  eo_reduce_row<N>(od, ev, m);
#pragma unroll
  for (int i = 2; i < N; i += 2) {
    eo_reduce_row<N>(ev, od, m);
    eo_reduce_row<N>(od, ev, m);
  }
  // (T_lo + m*p)/R = ev + (od >> 32) <= p, plus T's high half: below 2p
  ev[0] = ptx::add_cc(ev[0], od[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) ev[j] = ptx::addc_cc(ev[j], od[j + 1]);
  ev[N - 1] = ptx::addc(ev[N - 1], 0);
  add_words<N>(ev, ev, T + N);
  sub_p_once<N>(r, ev, 0, m);
}

// Rows I.. of sqr_wide's cross products a_I*a_j (j > I) on w + 2^32*od
// (2N words each): I + j even on w's lanes from w[2I + 2], I + j odd on
// od's lanes from od[2I], one chain each.  Rows 0..I sum to at most
// (a mod 2^(32(I+1)))*a < 2^(32(I + N + 1)), so w's words from I + N + 1
// and od's from I + N are 0 after row I: the chain that ends on its
// array's last such pair carries nothing out, and the other adds its carry
// into the word after it, which was 0.
template <int N, int I>
__device__ __forceinline__ void sqr_cross(uint32_t w[2 * N], uint32_t od[2 * N],
                                          const uint32_t a[N]) {
  if constexpr (I < N - 1) {
    constexpr int nA = (N - I) / 2, nB = (N - 1 - I) / 2;  // products a chain
    mad_pass<2 * nA, 0>(od + 2 * I, a + I + 1, a[I]);
    if constexpr ((N - I) % 2 == 1) od[I + N - 1] = ptx::addc(od[I + N - 1], 0);
    if constexpr (nB > 0) {
      mad_pass<2 * nB, 0>(w + 2 * I + 2, a + I + 2, a[I]);
      if constexpr ((N - 1 - I) % 2 == 1) w[I + N] = ptx::addc(w[I + N], 0);
    }
    sqr_cross<N, I + 1>(w, od, a);
  }
}

// w = a^2 in 2N words: the N(N - 1)/2 cross products a_i*a_j (i < j) once
// (sqr_cross), od added into w in one chain, the sum doubled by a one-bit
// shift, then the N squares a_i^2 added at w[2i] in one carry chain.
// N(N + 1)/2 wide products (78 at N = 12) against mul_wide's N^2, every
// one on an aligned pair; the same 2N words as mul_wide(a, a).
template <int N>
__device__ __forceinline__ void sqr_wide(uint32_t w[2 * N], const uint32_t a[N]) {
  uint32_t od[2 * N];
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) w[j] = od[j] = 0;
  sqr_cross<N, 0>(w, od, a);
  // the cross sum is below 2^(32(2N - 1)): od's words from 2N - 2 are 0,
  // and w + 2^32*od lies in words [1, 2N - 2]
  w[1] = ptx::add_cc(w[1], od[0]);
#pragma unroll
  for (int j = 2; j < 2 * N - 2; ++j) w[j] = ptx::addc_cc(w[j], od[j - 1]);
  w[2 * N - 2] = ptx::addc(w[2 * N - 2], od[2 * N - 3]);
  w[2 * N - 1] = w[2 * N - 2] >> 31;
#pragma unroll
  for (int j = 2 * N - 2; j > 0; --j) w[j] = __funnelshift_l(w[j - 1], w[j], 1);
  w[0] = ptx::mad_lo_cc(a[0], a[0], w[0]);
  w[1] = ptx::madc_hi_cc(a[0], a[0], w[1]);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    w[2 * i] = ptx::madc_lo_cc(a[i], a[i], w[2 * i]);
    w[2 * i + 1] = ptx::madc_hi_cc(a[i], a[i], w[2 * i + 1]);
  }
}

// Montgomery square r = a*a*2^(-32N) mod p = redc(sqr_wide(a)): N^2/2 +
// N/2 + N^2 + N wide products (234 at N = 12) against mont_mul's 2N^2 +
// N.  Canonical for a^2 < p*R, so for canonical a bit for bit what
// mont_mul(a, a) gives.  r may alias a.
template <int N>
__device__ __forceinline__ void mont_sqr(uint32_t r[N], const uint32_t a[N],
                                         const Mod<N>& m) {
  uint32_t w[2 * N];
  sqr_wide<N>(w, a);
  redc<N>(r, w, m);
}

// Fixed exponents for pow_fixed, by value in the kernel parameters: up to
// EXP_WORDS 32-bit words and the index of the top set bit.  Every thread
// reads the same bits, so pow_fixed's branch never diverges.
constexpr int EXP_WORDS = 12;

struct Exponent {
  uint32_t w[EXP_WORDS];
  int top;  // index of the most significant set bit; -1 for e = 0
};

__host__ inline Exponent make_exponent(const uint32_t* e) {
  Exponent ex;
  ex.top = -1;
  for (int j = 0; j < EXP_WORDS; ++j) {
    ex.w[j] = e[j];
    for (int b = 0; b < 32; ++b)
      if ((ex.w[j] >> b) & 1u) ex.top = 32 * j + b;
  }
  return ex;
}

// r = a^e (e >= 1) by left-to-right square-and-multiply over e's bits
// below the top one: the order of TField.pow_fixed's plain version.  0^e
// = 0.  r may alias a.
template <int N>
__device__ __forceinline__ void pow_fixed(uint32_t r[N], const uint32_t a[N],
                                          const Exponent& e, const Mod<N>& m) {
  uint32_t acc[N];
  copy<N>(acc, a);
#pragma unroll 1
  for (int b = e.top - 1; b >= 0; --b) {
    mont_mul<N>(acc, acc, acc, m);
    if ((e.w[b >> 5] >> (b & 31)) & 1u) mont_mul<N>(acc, acc, a, m);
  }
  copy<N>(r, acc);
}

// A fixed exponent e >= 1 as a left-to-right sliding-window chain of
// width W, built on the host and passed by value: x^e = x^(2*first + 1),
// then for each window k, squares[k] squares and a product by
// x^(2*odd[k] + 1), then `tail` squares.  A window starts at a set bit and
// spans at most W bits, ending at a set bit, so windows start at least W
// bits apart.  W = 1 is the binary chain of pow_fixed.
template <int W>
struct WindowChain {
  static constexpr int MAX = 32 * EXP_WORDS / W + 1;
  uint16_t squares[MAX];
  uint8_t odd[MAX];
  int windows, first, tail;
};

template <int W>
__host__ inline WindowChain<W> make_window_chain(const Exponent& e) {
  WindowChain<W> c{};
  auto bit = [&](int b) { return (e.w[b >> 5] >> (b & 31)) & 1u; };
  int sq = 0;
  bool first = true;
  for (int i = e.top; i >= 0;) {
    if (!bit(i)) {
      ++sq;
      --i;
      continue;
    }
    int j = i - W + 1 > 0 ? i - W + 1 : 0;                // window bits i..j
    while (!bit(j)) ++j;
    int d = 0;
    for (int b = i; b >= j; --b) d = 2 * d + (int)bit(b);
    if (first) {
      c.first = d >> 1;
      first = false;
    } else {
      c.squares[c.windows] = (uint16_t)(sq + i - j + 1);
      c.odd[c.windows++] = (uint8_t)(d >> 1);
    }
    sq = 0;
    i = j - 1;
  }
  c.tail = sq;
  return c;
}

// r = a^e by the window chain c, its squares on mont_sqr and its products
// on mont_mul_eo, the odd powers a, a^3, ..., a^(2^W - 1) first (in local
// memory for W > 1: the chain indexes them at run time): for canonical a,
// the canonical power, bit for bit what pow_fixed gives.  r may alias a.
template <int N, int W>
__device__ __forceinline__ void pow_window(uint32_t r[N], const uint32_t a[N],
                                           const WindowChain<W>& c, const Mod<N>& m) {
  uint32_t odd[1 << (W - 1)][N], acc[N];
  copy<N>(odd[0], a);
  if constexpr (W > 1) {
    mont_sqr<N>(acc, a, m);
#pragma unroll 1
    for (int k = 1; k < (1 << (W - 1)); ++k) mont_mul_eo<N>(odd[k], odd[k - 1], acc, m);
  }
  copy<N>(acc, odd[c.first]);
#pragma unroll 1
  for (int k = 0; k < c.windows; ++k) {
#pragma unroll 1
    for (int s = 0; s < c.squares[k]; ++s) mont_sqr<N>(acc, acc, m);
    mont_mul_eo<N>(acc, acc, odd[c.odd[k]], m);
  }
#pragma unroll 1
  for (int s = 0; s < c.tail; ++s) mont_sqr<N>(acc, acc, m);
  copy<N>(r, acc);
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
// batched-affine level helpers, on N limbs: BLS12-381 Fq (N = 12) and
// BN254 Fq (N = 8)
// ---------------------------------------------------------------------------

// BLS12-381 Fq, the field of the kernels that take 12 limbs only
// (jacobian.cu, normalize.cu, sqr_designs.cu).
constexpr int FQ_LIMBS = 12;
using Fq = Mod<FQ_LIMBS>;

// r = a plain limb-0 1 (the inversion's filler in a dead lane)
template <int N>
__device__ __forceinline__ void plain_one(uint32_t r[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = j == 0 ? 1u : 0u;
}

// Denominator of the total unified affine add/double of P1 + P2, and the
// case masks: d = 2*y1 when doubling, else x2 - x1; a plain limb-0 1 in
// dead lanes (an infinite operand, P + (-P), or d == 0) so the inversion
// stays valid.  The chunked level's prefix and the affine level's pre call
// this; the total down pass rebuilds the same d from the prefix's dbl mask
// (see chunked_level.cu).
template <int N>
__device__ __forceinline__ void denom_dbl_inf(uint32_t d[N], bool& is_dbl, bool& is_inf3,
                                              const uint32_t x1[N], const uint32_t y1[N],
                                              const uint32_t x2[N], const uint32_t y2[N],
                                              bool i1, bool i2, const Mod<N>& m) {
  bool same_x = eq<N>(x1, x2);
  uint32_t t[N];
  neg<N>(t, y2, m);
  bool y_opp = eq<N>(y1, t);
  bool both = !i1 && !i2;
  is_dbl = same_x && !y_opp && both;
  is_inf3 = (same_x && y_opp && both) || (i1 && i2);
  bool dead = !both || is_inf3;
  if (is_dbl) {
    add<N>(d, y1, y1, m);
  } else {
    sub<N>(d, x2, x1, m);
  }
  if (dead || is_zero<N>(d)) plain_one<N>(d);
}

// Denominator of the doubling-free affine add (crypto_tpu's _denom_fast):
// d = x2 - x1, a plain limb-0 1 where either operand is infinite, and
// inf3 = both infinite.  d == 0 (P + P or P + (-P)) stays 0: the caller
// detects it and reruns the window with the total formula.  Prefix and
// down of the fast chunked level both call this.
template <int N>
__device__ __forceinline__ void denom_fast(uint32_t d[N], bool& is_inf3, const uint32_t x1[N],
                                           const uint32_t x2[N], bool i1, bool i2,
                                           const Mod<N>& m) {
  sub<N>(d, x2, x1, m);
  if (i1 || i2) plain_one<N>(d);
  is_inf3 = i1 && i2;
}

// The distinct-points affine add given dinv = 1/(x2 - x1): lambda =
// (y2 - y1) * dinv, x3 = lambda^2 - x1 - x2, y3 = lambda*(x1 - x3) - y1
// (3 Montgomery muls); an infinite operand passes the other one through.
template <int N>
__device__ __forceinline__ void fast_apply(uint32_t x3[N], uint32_t y3[N], const uint32_t x1[N],
                                           const uint32_t y1[N], const uint32_t x2[N],
                                           const uint32_t y2[N], const uint32_t dinv[N],
                                           bool i1, bool i2, const Mod<N>& m) {
  uint32_t t[N], lam[N];
  sub<N>(t, y2, y1, m);
  mont_mul<N>(lam, t, dinv, m);
  mont_mul<N>(t, lam, lam, m);
  sub<N>(t, t, x1, m);
  sub<N>(x3, t, x2, m);
  sub<N>(t, x1, x3, m);
  mont_mul<N>(t, lam, t, m);
  sub<N>(y3, t, y1, m);
  if (i1) {
    copy<N>(x3, x2);
    copy<N>(y3, y2);
  } else if (i2) {
    copy<N>(x3, x1);
    copy<N>(y3, y1);
  }
}

// Given dinv = 1/d: lambda = (3*x1^2 when doubling, else y2 - y1) * dinv,
// x3 = lambda^2 - x1 - x2, y3 = lambda*(x1 - x3) - y1; an infinite
// operand passes the other one through.
template <int N>
__device__ __forceinline__ void unified_apply(uint32_t x3[N], uint32_t y3[N],
                                              const uint32_t x1[N], const uint32_t y1[N],
                                              const uint32_t x2[N], const uint32_t y2[N],
                                              const uint32_t dinv[N], bool is_dbl, bool i1,
                                              bool i2, const Mod<N>& m) {
  uint32_t num[N], t[N], lam[N];
  if (is_dbl) {
    mont_mul<N>(t, x1, x1, m);
    add<N>(num, t, t, m);
    add<N>(num, num, t, m);
  } else {
    sub<N>(num, y2, y1, m);
  }
  mont_mul<N>(lam, num, dinv, m);
  mont_mul<N>(t, lam, lam, m);
  sub<N>(t, t, x1, m);
  sub<N>(x3, t, x2, m);
  sub<N>(t, x1, x3, m);
  mont_mul<N>(t, lam, t, m);
  sub<N>(y3, t, y1, m);
  if (i1) {
    copy<N>(x3, x2);
    copy<N>(y3, y2);
  } else if (i2) {
    copy<N>(x3, x1);
    copy<N>(y3, y1);
  }
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1) on N-limb halves (beta = -1: BLS12-381 Fq at N =
// 12, BN254 Fq at N = 8)
// ---------------------------------------------------------------------------
//
// An element is 2N limbs: c0's N in [0, N), c1's in [N, 2N), which is
// the (2N, M) row order of the Python side (crypto_tpu_torch.fields.ttower).
// add, sub, neg, eq and is_zero are the base templates on each half (or on
// all 2N limbs at once for eq and is_zero); a product takes three
// unreduced products and two reductions; a square three wide squares and
// two reductions in fq2_sqr_karatsuba (the square kernel's), or two CIOS
// products in fq2_sqr (the Fq2 post's).
//
// The lazy reductions need p^2 < 2^(32*2N) / 2 and 2p < 2^(32N), and each
// REDC input below p*R: both hold when 4p < R, so for both moduli (BLS12-381
// Fq leaves 3 spare bits in 384, BN254 Fq 2 in 256).

constexpr int FQ2_LIMBS = 2 * FQ_LIMBS;

// p^2 in 2N words, the offset of fq2_mul's and fq2_sqr_karatsuba's lazy
// reduction, built on the host and passed by value only to the kernels
// that call them.
template <int N>
struct PSquare {
  uint32_t w[2 * N];
};
using FqSquare = PSquare<FQ_LIMBS>;

template <int N>
__host__ inline PSquare<N> make_p_square(const uint32_t* p) {
  PSquare<N> s;
  for (int i = 0; i < 2 * N; ++i) s.w[i] = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < N; ++j) {
      uint64_t t = (uint64_t)p[i] * p[j] + s.w[i + j] + c;
      s.w[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    s.w[i + N] = (uint32_t)c;
  }
  return s;
}

__host__ inline FqSquare make_fq_square(const uint32_t* p) {
  return make_p_square<FQ_LIMBS>(p);
}

template <int N>
__device__ __forceinline__ void fq2_add(uint32_t r[2 * N], const uint32_t a[2 * N],
                                        const uint32_t b[2 * N], const Mod<N>& m) {
  add<N>(r, a, b, m);
  add<N>(r + N, a + N, b + N, m);
}

template <int N>
__device__ __forceinline__ void fq2_sub(uint32_t r[2 * N], const uint32_t a[2 * N],
                                        const uint32_t b[2 * N], const Mod<N>& m) {
  sub<N>(r, a, b, m);
  sub<N>(r + N, a + N, b + N, m);
}

template <int N>
__device__ __forceinline__ void fq2_neg(uint32_t r[2 * N], const uint32_t a[2 * N],
                                        const Mod<N>& m) {
  neg<N>(r, a, m);
  neg<N>(r + N, a + N, m);
}

// r = a*b by Karatsuba with lazy reduction (blst's mul_mont_384x): three
// unreduced N x N-word products v0 = a0*b0, v1 = a1*b1 and t = (a0 +
// a1)(b0 + b1), the sums left unreduced (below 2p < 2^(32N)), then two
// reductions: c0 = redc(v0 + p^2 - v1) and c1 = redc(t - v0 - v1).  Both
// inputs lie in [0, 2p^2), below p*R, so each redc ends canonical: for
// canonical inputs the result is the canonical product, which the
// reference's three Montgomery products (Fq2Ctx.mul) also give.  3N^2 +
// 2(N^2 + N) wide products (744 at N = 12, 336 at N = 8) against 3(2N^2 +
// N) for three CIOS products.  r may alias a or b.
template <int N>
__device__ __forceinline__ void fq2_mul(uint32_t r[2 * N], const uint32_t a[2 * N],
                                        const uint32_t b[2 * N], const Mod<N>& m,
                                        const PSquare<N>& p2) {
  constexpr int L = N, W = 2 * N;
  uint32_t sa[L], sb[L], v0[W], v1[W], t[W];
  add_words<L>(sa, a, a + L);
  add_words<L>(sb, b, b + L);
  mul_wide<L>(v0, a, b);
  mul_wide<L>(v1, a + L, b + L);
  add_words<W>(t, v0, p2.w);
  sub_words<W>(t, t, v1);                 // v0 + p^2 - v1
  add_words<W>(v0, v0, v1);               // v0 + v1 < 2p^2
  redc<L>(r, t, m);
  mul_wide<L>(t, sa, sb);
  sub_words<W>(t, t, v0);                 // a0*b1 + a1*b0
  redc<L>(r + L, t, m);
}

// r = a^2 by Karatsuba on squares (fq2_mul with b = a): v0 = a0^2, v1 =
// a1^2 and t = (a0 + a1)^2 by sqr_wide, the sum a0 + a1 left unreduced
// (below 2p), then c0 = redc(v0 + p^2 - v1) and c1 = redc(t - v0 -
// v1) = redc(2*a0*a1), both inputs in [0, 2p^2), below p*R, so each
// ends canonical: for canonical inputs bit for bit what fq2_sqr gives.
// 3N(N + 1)/2 + 2(N^2 + N) wide products (546 at N = 12, 252 at N = 8)
// against fq2_sqr's 2(2N^2 + N), without its moves and its three modular
// adds and subs.  r may alias a.
template <int N>
__device__ __forceinline__ void fq2_sqr_karatsuba(uint32_t r[2 * N], const uint32_t a[2 * N],
                                                  const Mod<N>& m, const PSquare<N>& p2) {
  constexpr int L = N, W = 2 * N;
  uint32_t s[L], v0[W], v1[W];
  add_words<L>(s, a, a + L);
  sqr_wide<L>(v0, a);
  sqr_wide<L>(v1, a + L);
  {
    uint32_t t[W];
    add_words<W>(t, v0, p2.w);
    sub_words<W>(t, t, v1);               // v0 + p^2 - v1
    redc<L>(r, t, m);
  }
  add_words<W>(v0, v0, v1);               // v0 + v1 < 2p^2
  sqr_wide<L>(v1, s);
  sub_words<W>(v1, v1, v0);               // 2*a0*a1
  redc<L>(r + L, v1, m);
}

// r = a^2 by complex squaring over two Montgomery products (crypto_tpu's
// Fq2Ctx.square): c0 = (a0 + a1)(a0 - a1), c1 = 2*a0*a1.  r may alias a.
// Rolled = true takes mont_mul_rolled (the same result, less code).
template <bool Rolled = false, int N>
__device__ __forceinline__ void fq2_sqr(uint32_t r[2 * N], const uint32_t a[2 * N],
                                        const Mod<N>& m) {
  uint32_t s[N], t[N];
  add<N>(s, a, a + N, m);
  sub<N>(t, a, a + N, m);
  if constexpr (Rolled) {
    mont_mul_rolled<N>(s, s, t, m);
    mont_mul_rolled<N>(t, a, a + N, m);
  } else {
    mont_mul<N>(s, s, t, m);
    mont_mul<N>(t, a, a + N, m);
  }
  copy<N>(r, s);
  add<N>(r + N, t, t, m);
}

// Run fn(std::integral_constant<int, N>{}) for the limb count L (12 or 8):
// the C entry points' instantiation by their runtime L.  fn launches and
// returns a cudaError_t; then the launch's own error, or
// cudaErrorInvalidValue for another L.
template <class Fn>
inline int by_limbs(int L, Fn&& fn) {
  cudaError_t err;
  if (L == 12) {
    err = fn(std::integral_constant<int, 12>{});
  } else if (L == 8) {
    err = fn(std::integral_constant<int, 8>{});
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

inline int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace ctt
