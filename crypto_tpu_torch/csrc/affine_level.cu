// One narrow batched-affine halving level in one launch: the affine add of
// M pairs with the batch inversion of their denominators folded in, in two
// variants, each instantiated for BLS12-381 Fq (L = 12 limbs) and BN254 Fq
// (L = 8); the C entry points take L at run time (ctt::by_limbs).
//
// Doubling-free: replaces crypto_tpu/ops/pallas/curve_kernels.py
// affine_kernels_fast (call_pre / call_post) and the batch inversion that
// crypto_tpu/ops/msm_v2.py _fused_ctx's narrow pair_add_t runs between
// them:
//   affine_level_fast(x1, y1, m1, x2, y2, m2) -> (x3, y3, inf3, zero)
// with d = x2 - x1 (field.cuh denom_fast) and the 3-mul distinct-points
// add (fast_apply).  zero marks the pairs whose d is 0 (P + P or
// P + (-P)); there d enters the inversion as a plain limb-0 1, the
// substitute msm_v2.pair_add_t writes, so those lanes too are bit for bit
// the plain version's and no collision spoils another lane.
// Total unified add/double: replaces affine_kernels_for (call_pre /
// call_post) and its inversion the same way:
//   affine_level(x1, y1, m1, x2, y2, m2) -> (x3, y3, inf3)
// with d and the doubling mask from denom_dbl_inf and unified_apply.
// Coordinates are (L, M) limb-major uint32, masks (M,) int32 (nonzero =
// infinity), zero (M,) bytes of 0 or 1 (torch.bool).
//
// Design (normalize.cu's batch inversion around the level's pre and
// post): thread j of block b takes a chunk of CHUNK pairs, b*T*CHUNK + j +
// s*T for s < CHUNK (a warp's limb loads stay contiguous), computes each
// pair's d in registers and forms the prefix products of its chunk, each
// parked in the x3 output at its pair's index.  The block's T chunk totals
// go up a product tree in shared memory, one sliding-window Fermat chain
// inverts the root (field.cuh pow_window, width CHAIN_WINDOW: 460 steps
// for BLS12-381's p - 2, 306 for BN254's), and the tree is walked back
// down to each thread's inverse total.  Each thread then walks its chunk
// back, re-reading the pair's operands (L2 holds them at these widths)
// and rebuilding its d: 1/d = (1/prefix s) * prefix s-1, 1/prefix s-1 =
// (1/prefix s) * d, and applies the add at once.  An inverse is unique
// and every product canonical, so a block-local inversion gives bit for
// bit what msm_v2.batch_inv_t gives.
//
// Bound on the H100: the level moves 4 coordinates and 2 masks in and 2
// coordinates and the masks out, against 3 Montgomery products a pair for
// the inversion, the add's 2 products and a square (the total formula's
// doublings one square more) and one chain a block: microseconds of bytes
// and products at the widths that take this level (under msm_v2's
// CHUNK_MIN_PAIRS = 4,096 pairs).  What bounds it is latency: one thread's
// chain of ~460 dependent steps, then the tree's 2 * log2(T) levels and
// the chunk's walk.  All blocks are resident at once (at most
// ceil(4095 / (T * CHUNK)) of them, one chain each on its own SM), so the
// level waits for one chain, not one a wave, and one launch takes the
// place of pre, post and the ~3 log2(M) product launches, the concats and
// the Fermat root launch of the inversion between them.  T = 128 and
// CHUNK = 1 (1 to 32 blocks over widths 1 to 4,095): a thread's walk adds
// its dependent products to the chain's latency, and more chains cost
// nothing while each has an SM of its own.  time_launch_bounds.py builds
// CHUNK = 1 to 16 and times them: on an H100 at 700 W, 1 held 0.383-0.385
// ms at every width from 1 to 4,095 pairs (12 limbs), 4 took 0.407 and
// 16 0.496 at 4,095.
#include "field.cuh"

namespace {

constexpr int T = 128;          // threads a block
constexpr int CHUNK = 1;        // pairs a thread
constexpr int TREE_LOG = 7;     // levels of the product tree: log2 T, one chain a block
static_assert((1 << TREE_LOG) == T, "one chain a block");
// the width of the Fermat chain's sliding window
constexpr int CHAIN_WINDOW = 5;

template <int N>
struct Limbs {
  uint32_t w[N];
};

// Pair i's operands and its denominator as the plain version feeds it to
// the inversion: never 0 (a dead lane's and, on the fast formula, a
// colliding pair's d is a plain limb-0 1).
template <int N, bool Fast>
struct Pair {
  uint32_t x1[N], y1[N], x2[N], y2[N], d[N];
  bool i1, i2, dbl, inf3, zero;

  __device__ __forceinline__ void load(const uint32_t* __restrict__ X1,
                                       const uint32_t* __restrict__ Y1,
                                       const int* __restrict__ M1,
                                       const uint32_t* __restrict__ X2,
                                       const uint32_t* __restrict__ Y2,
                                       const int* __restrict__ M2, long long M, long long i,
                                       const ctt::Mod<N>& m) {
    ctt::load<N>(x1, X1, M, i);
    ctt::load<N>(x2, X2, M, i);
    ctt::load<N>(y1, Y1, M, i);   // the fast prefix never reads y: dead loads
    ctt::load<N>(y2, Y2, M, i);
    i1 = M1[i] != 0;
    i2 = M2[i] != 0;
    if constexpr (Fast) {
      ctt::denom_fast<N>(d, inf3, x1, x2, i1, i2, m);
      dbl = false;
      zero = ctt::is_zero<N>(d);
      if (zero) ctt::plain_one<N>(d);
    } else {
      ctt::denom_dbl_inf<N>(d, dbl, inf3, x1, y1, x2, y2, i1, i2, m);
      zero = false;
    }
  }
};

// The tree lives in shared memory as N rows of 2T - 1 nodes (a thread's
// limb loads side by side): the T chunk totals, then each level up the
// tree after the one below it, the root last.
template <int N, bool Fast>
__device__ __forceinline__ void level(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2, uint32_t* __restrict__ x3,
    uint32_t* __restrict__ y3, int* __restrict__ inf3, bool* __restrict__ zero, long long M,
    const ctt::Mod<N>& m, const ctt::WindowChain<CHAIN_WINDOW>& e, const Limbs<N>& one,
    uint32_t* node) {
  constexpr int nodes = 2 * T - 1;
  const int j = threadIdx.x;
  const long long first = (long long)blockIdx.x * T * CHUNK + j;
  const int n = first < M ? (int)min((long long)CHUNK, (M - 1 - first) / T + 1) : 0;
  uint32_t acc[N], t[N];
  ctt::copy<N>(acc, one.w);                                // an empty chunk's total
#pragma unroll 1
  for (int s = 0; s < n; ++s) {                            // d and its prefix products
    const long long i = first + (long long)s * T;
    Pair<N, Fast> q;
    q.load(x1, y1, m1, x2, y2, m2, M, i, m);
    inf3[i] = q.inf3 ? 1 : 0;
    if constexpr (Fast) zero[i] = q.zero;
    if (s == 0) {
      ctt::copy<N>(acc, q.d);
    } else {
      ctt::mont_mul_eo<N>(acc, acc, q.d, m);
    }
    ctt::store<N>(x3, acc, M, i);
  }
  ctt::store<N>(node, acc, nodes, j);
  int off = 0;                                             // this level's first node
  for (int lev = 0; lev < TREE_LOG; ++lev) {               // up the tree
    const int w = T >> (lev + 1);                          // nodes a level up
    __syncthreads();
    if (j < w) {
      ctt::load<N>(acc, node, nodes, off + 2 * j);
      ctt::load<N>(t, node, nodes, off + 2 * j + 1);
      ctt::mont_mul_eo<N>(acc, acc, t, m);
      ctt::store<N>(node, acc, nodes, off + 2 * w + j);
    }
    off += 2 * w;
  }
  __syncthreads();
  if (j == 0) {                                            // the block's chain
    ctt::load<N>(acc, node, nodes, off);
    ctt::pow_window<N, CHAIN_WINDOW>(acc, acc, e, m);
    ctt::store<N>(node, acc, nodes, off);
  }
  for (int lev = TREE_LOG; lev > 0; --lev) {               // down the tree
    const int w = T >> lev;
    off -= 2 * w;
    __syncthreads();
    if (j < w) {
      uint32_t inv[N];
      ctt::load<N>(inv, node, nodes, off + 2 * w + j);
      ctt::load<N>(t, node, nodes, off + 2 * j + 1);
      ctt::mont_mul_eo<N>(acc, inv, t, m);                 // 1/left = right/(left right)
      ctt::load<N>(t, node, nodes, off + 2 * j);
      ctt::mont_mul_eo<N>(inv, inv, t, m);
      ctt::store<N>(node, acc, nodes, off + 2 * j);
      ctt::store<N>(node, inv, nodes, off + 2 * j + 1);
    }
  }
  __syncthreads();
  ctt::load<N>(acc, node, nodes, j);                       // 1 / the chunk's total
#pragma unroll 1
  for (int s = n - 1; s >= 0; --s) {                       // the walk back and the add
    const long long i = first + (long long)s * T;
    Pair<N, Fast> q;
    q.load(x1, y1, m1, x2, y2, m2, M, i, m);
    uint32_t dinv[N], X3[N], Y3[N];
    if (s > 0) {
      ctt::load<N>(dinv, x3, M, i - T);
      ctt::mont_mul_eo<N>(dinv, acc, dinv, m);             // 1/d
      ctt::mont_mul_eo<N>(acc, acc, q.d, m);               // 1 / prefix s-1
    } else {
      ctt::copy<N>(dinv, acc);
    }
    if constexpr (Fast) {
      ctt::fast_apply<N>(X3, Y3, q.x1, q.y1, q.x2, q.y2, dinv, q.i1, q.i2, m);
    } else {
      ctt::unified_apply<N>(X3, Y3, q.x1, q.y1, q.x2, q.y2, dinv, q.dbl, q.i1, q.i2, m);
    }
    ctt::store<N>(x3, X3, M, i);
    ctt::store<N>(y3, Y3, M, i);
  }
}

template <int N>
__global__ void __launch_bounds__(T) affine_level_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2, uint32_t* __restrict__ x3,
    uint32_t* __restrict__ y3, int* __restrict__ inf3, long long M, ctt::Mod<N> m,
    ctt::WindowChain<CHAIN_WINDOW> e, Limbs<N> one) {
  __shared__ uint32_t node[N * (2 * T - 1)];
  level<N, false>(x1, y1, m1, x2, y2, m2, x3, y3, inf3, nullptr, M, m, e, one, node);
}

template <int N>
__global__ void __launch_bounds__(T) affine_level_fast_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const int* __restrict__ m1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const int* __restrict__ m2, uint32_t* __restrict__ x3,
    uint32_t* __restrict__ y3, int* __restrict__ inf3, bool* __restrict__ zero, long long M,
    ctt::Mod<N> m, ctt::WindowChain<CHAIN_WINDOW> e, Limbs<N> one) {
  __shared__ uint32_t node[N * (2 * T - 1)];
  level<N, true>(x1, y1, m1, x2, y2, m2, x3, y3, inf3, zero, M, m, e, one, node);
}

// kernel<N> over M pairs for the run-time limb count L: the modulus, the
// window chain of e = p - 2 and the Montgomery 1 by value
template <class Launch>
int launch_level(int L, const void* e, Launch&& launch) {
  if (L != 8 && L != 12) return (int)cudaErrorInvalidValue;
  uint32_t ew[ctt::EXP_WORDS] = {};                         // p - 2, zero-padded
  for (int k = 0; k < L; ++k) ew[k] = ((const uint32_t*)e)[k];
  const ctt::Exponent ex = ctt::make_exponent(ew);
  if (ex.top < 0) return (int)cudaErrorInvalidValue;
  const ctt::WindowChain<CHAIN_WINDOW> chain = ctt::make_window_chain<CHAIN_WINDOW>(ex);
  return ctt::by_limbs(L, [&](auto n) { return launch(n, chain); });
}

}  // namespace

// e: the L limbs of p - 2; one: the L limbs of the Montgomery 1 (R mod p).
extern "C" int crypto_affine_level(const void* x1, const void* y1, const void* m1,
                                   const void* x2, const void* y2, const void* m2, void* x3,
                                   void* y3, void* inf3, long long M, int L, const void* p,
                                   unsigned int n0inv, const void* e, const void* one,
                                   void* stream) {
  return launch_level(L, e, [&](auto n, const ctt::WindowChain<CHAIN_WINDOW>& chain) {
    constexpr int N = decltype(n)::value;
    Limbs<N> r;
    for (int k = 0; k < N; ++k) r.w[k] = ((const uint32_t*)one)[k];
    affine_level_kernel<N><<<ctt::blocks_for(M, T * CHUNK), T, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const int*)m1, (const uint32_t*)x2,
        (const uint32_t*)y2, (const int*)m2, (uint32_t*)x3, (uint32_t*)y3, (int*)inf3, M,
        ctt::make_mod<N>((const uint32_t*)p, n0inv), chain, r);
    return cudaSuccess;
  });
}

extern "C" int crypto_affine_level_fast(const void* x1, const void* y1, const void* m1,
                                        const void* x2, const void* y2, const void* m2,
                                        void* x3, void* y3, void* inf3, void* zero,
                                        long long M, int L, const void* p, unsigned int n0inv,
                                        const void* e, const void* one, void* stream) {
  return launch_level(L, e, [&](auto n, const ctt::WindowChain<CHAIN_WINDOW>& chain) {
    constexpr int N = decltype(n)::value;
    Limbs<N> r;
    for (int k = 0; k < N; ++k) r.w[k] = ((const uint32_t*)one)[k];
    affine_level_fast_kernel<N><<<ctt::blocks_for(M, T * CHUNK), T, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const int*)m1, (const uint32_t*)x2,
        (const uint32_t*)y2, (const int*)m2, (uint32_t*)x3, (uint32_t*)y3, (int*)inf3,
        (bool*)zero, M, ctt::make_mod<N>((const uint32_t*)p, n0inv), chain, r);
    return cudaSuccess;
  });
}
