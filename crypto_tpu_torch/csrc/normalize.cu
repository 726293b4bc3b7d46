// Batched Jacobian -> affine normalisation (BLS12-381 G1) by Montgomery's
// batch inversion, in one launch.
//
// Replaces crypto_tpu/ops/pallas/curve_kernels.py _mul_call_for, the
// batched Montgomery-mul kernel that make_normalize_fn scans about 770
// times: z^(p-2) by square-and-multiply over the bits of p - 2, then
// x * z^-2 and y * z^-3, and Z set to the Montgomery 1, or to 0 for an
// infinite point (0^(p-2) = 0).  This kernel computes what that scan
// computes:
//   normalize(X, Y, Z) -> (x, y, z), and (0, 0, 0) where Z = 0.
//
// Design: Montgomery's trick.  Thread j of block b takes a chunk of
// CHUNK points, b*T*CHUNK + j + s*T for s < CHUNK (a warp's limb loads
// stay contiguous), and forms the prefix products of their Z, a Z of 0
// entering as the Montgomery 1; each prefix is parked in the x output at
// its point's index, where the walk back reads it before it writes x.
// The block's T chunk totals are multiplied up a product tree in shared
// memory, one Fermat chain inverts the root (field.cuh pow_window: a
// sliding window of width CHAIN_WINDOW, 460 steps for p - 2 at width 5
// against the binary chain's 608), and the tree is walked back down to
// each thread's inverse total.  Then each thread walks its chunk back:
// z^-1 = (1/prefix s) * prefix s-1, 1/prefix s-1 = (1/prefix s) * z,
// fused with z^-2 (a square), z^-3, x z^-2 and y z^-3.  T = 128 and
// CHUNK = 16 make 512 blocks of a 2^20 batch, all resident at once, so
// the batch waits for one chain's latency, not one a wave.
// time_launch_bounds.py builds other shapes by rewriting T, CHUNK and
// TREE_LOG (0: a chain a thread) and times them (PERF.md).
//
// Bound on the H100: 6 Montgomery products and 1 square a point (the
// prefix product and the two of the walk back, z^-3, x z^-2, y z^-3;
// z^-2) and one chain a batch, against 6 coordinates moved: bound by the
// integer multiply rate.  An inverse is unique, so the result is bit for
// bit the chain a point that the reference runs.  The chain on one
// thread (460 dependent steps) is a latency floor that no count of bytes
// or products sees: at 2^20 points it is about half the kernel's time.
#include "field.cuh"

namespace {

using ctt::FQ_LIMBS;
using ctt::Fq;
constexpr int T = 128;         // threads a block
constexpr int CHUNK = 16;      // points a thread
constexpr int TREE_LOG = 7;    // levels of the product tree: log2 T, one chain a block
static_assert((T & (T - 1)) == 0 && (T >> TREE_LOG) >= 1, "a tree within the block");
// the width of the Fermat chain's sliding window (1: the binary chain)
constexpr int CHAIN_WINDOW = 5;

struct Limbs {
  uint32_t w[FQ_LIMBS];
};

__device__ __forceinline__ void zero_if(uint32_t r[FQ_LIMBS], bool cond) {
#pragma unroll
  for (int l = 0; l < FQ_LIMBS; ++l) r[l] = cond ? 0u : r[l];
}

// The block's tree lives in shared memory as FQ_LIMBS rows of 2T - 1
// nodes (a thread's limb loads side by side): the T chunk totals, then
// each level up the tree after the one below it; T >> TREE_LOG roots,
// a chain each.
__global__ void __launch_bounds__(T) normalize_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const uint32_t* __restrict__ z, uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
    uint32_t* __restrict__ zo, long long M, Fq m, ctt::WindowChain<CHAIN_WINDOW> e,
    Limbs one) {
  constexpr int nodes = 2 * T - 1;
  __shared__ uint32_t node[FQ_LIMBS * nodes];
  const int j = threadIdx.x;
  const long long first = (long long)blockIdx.x * T * CHUNK + j;
  const int n = first < M ? (int)min((long long)CHUNK, (M - 1 - first) / T + 1) : 0;
  uint32_t acc[FQ_LIMBS], t[FQ_LIMBS];
  ctt::copy<FQ_LIMBS>(acc, one.w);
#pragma unroll 1
  for (int s = 0; s < n; ++s) {                            // prefix products
    const long long i = first + (long long)s * T;
    ctt::load<FQ_LIMBS>(t, z, M, i);
    if (ctt::is_zero<FQ_LIMBS>(t)) ctt::copy<FQ_LIMBS>(t, one.w);
    if (s == 0) {
      ctt::copy<FQ_LIMBS>(acc, t);
    } else {
      ctt::mont_mul_eo<FQ_LIMBS>(acc, acc, t, m);
    }
    ctt::store<FQ_LIMBS>(xo, acc, M, i);
  }
  ctt::store<FQ_LIMBS>(node, acc, nodes, j);
  int off = 0;                                             // this level's first node
  for (int lev = 0; lev < TREE_LOG; ++lev) {               // up the tree
    const int w = T >> (lev + 1);                          // nodes a level up
    __syncthreads();
    if (j < w) {
      ctt::load<FQ_LIMBS>(acc, node, nodes, off + 2 * j);
      ctt::load<FQ_LIMBS>(t, node, nodes, off + 2 * j + 1);
      ctt::mont_mul_eo<FQ_LIMBS>(acc, acc, t, m);
      ctt::store<FQ_LIMBS>(node, acc, nodes, off + 2 * w + j);
    }
    off += 2 * w;
  }
  __syncthreads();
  if (j < (T >> TREE_LOG)) {                               // a chain a root
    ctt::load<FQ_LIMBS>(acc, node, nodes, off + j);
    ctt::pow_window<FQ_LIMBS, CHAIN_WINDOW>(acc, acc, e, m);
    ctt::store<FQ_LIMBS>(node, acc, nodes, off + j);
  }
  for (int lev = TREE_LOG; lev > 0; --lev) {               // down the tree
    const int w = T >> lev;
    off -= 2 * w;
    __syncthreads();
    if (j < w) {
      uint32_t inv[FQ_LIMBS];
      ctt::load<FQ_LIMBS>(inv, node, nodes, off + 2 * w + j);
      ctt::load<FQ_LIMBS>(t, node, nodes, off + 2 * j + 1);
      ctt::mont_mul_eo<FQ_LIMBS>(acc, inv, t, m);          // 1/left = right/(left right)
      ctt::load<FQ_LIMBS>(t, node, nodes, off + 2 * j);
      ctt::mont_mul_eo<FQ_LIMBS>(inv, inv, t, m);
      ctt::store<FQ_LIMBS>(node, acc, nodes, off + 2 * j);
      ctt::store<FQ_LIMBS>(node, inv, nodes, off + 2 * j + 1);
    }
  }
  __syncthreads();
  ctt::load<FQ_LIMBS>(acc, node, nodes, j);                // 1 / the chunk's total
#pragma unroll 1
  for (int s = n - 1; s >= 0; --s) {                       // the walk back
    const long long i = first + (long long)s * T;
    uint32_t zi[FQ_LIMBS], c[FQ_LIMBS];
    ctt::load<FQ_LIMBS>(t, z, M, i);
    const bool inf = ctt::is_zero<FQ_LIMBS>(t);
    if (s > 0) {
      ctt::load<FQ_LIMBS>(zi, xo, M, i - T);
      ctt::mont_mul_eo<FQ_LIMBS>(zi, acc, zi, m);          // z^-1
      if (inf) ctt::copy<FQ_LIMBS>(t, one.w);
      ctt::mont_mul_eo<FQ_LIMBS>(acc, acc, t, m);          // 1 / prefix s-1
    } else {
      ctt::copy<FQ_LIMBS>(zi, acc);
    }
    ctt::mont_sqr<FQ_LIMBS>(t, zi, m);                     // z^-2
    ctt::load<FQ_LIMBS>(c, x, M, i);
    ctt::mont_mul_eo<FQ_LIMBS>(c, c, t, m);
    zero_if(c, inf);
    ctt::store<FQ_LIMBS>(xo, c, M, i);
    ctt::mont_mul_eo<FQ_LIMBS>(zi, t, zi, m);              // z^-3
    ctt::load<FQ_LIMBS>(c, y, M, i);
    ctt::mont_mul_eo<FQ_LIMBS>(c, c, zi, m);
    zero_if(c, inf);
    ctt::store<FQ_LIMBS>(yo, c, M, i);
    ctt::copy<FQ_LIMBS>(c, one.w);
    zero_if(c, inf);
    ctt::store<FQ_LIMBS>(zo, c, M, i);
  }
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
  normalize_kernel<<<ctt::blocks_for(M, T * CHUNK), T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)xo,
      (uint32_t*)yo, (uint32_t*)zo, M, ctt::make_mod<FQ_LIMBS>((const uint32_t*)p, n0inv),
      ctt::make_window_chain<CHAIN_WINDOW>(ex), r);
  return (int)cudaGetLastError();
}
