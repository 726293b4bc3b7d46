// Row gather with transposed output: (payload (N, C) uint32, point-major,
// idx (M,) int64) -> (C, M) limb-major: row idx[j] of the payload in
// column j, and a zero column where idx[j] < 0 (an empty slot) or
// idx[j] >= N.
//
// Replaces crypto_tpu/ops/pallas/field_kernels.py gather_rows_t_fn, the
// row gather with transposed output that lays out the MSM's bucket slots
// (there a scalar-prefetch DMA of each live slot's payload row into VMEM,
// dead slots issuing no DMA, and one transpose of the block).  The
// contract is the reference's: rows of a point-major payload in, the
// limb-major layout the level kernels read out.  The kernel reads no
// address outside the payload, and gives what the plain version gives
// for every index.
//
// Bound on the H100: bytes; it does no arithmetic.  Most of them are the
// output (C words a slot, live or dead); then each live slot's row and
// each slot's index.
//
// Design: one thread per slot, T slots a block.  A thread loads its
// slot's index once, and, if the slot is live, its row as C/4 16-byte
// vector loads from contiguous addresses (3 for C = 12, 48 bytes; 6 for
// C = 24, 96 bytes: three whole 32-byte sectors; 2 and 4 for BN254's C =
// 8 and 16, one and two whole sectors), all issued before the
// first is used, so 6 x 2,048 loads are in flight on an SM at full
// occupancy; a dead slot loads nothing.  The transpose happens in
// registers: the thread owns its slot's output column, so for each word
// w a warp stores 32 consecutive slots of row w, 128 contiguous bytes.
// The stores stream (evict-first), so the 1-2 GB of output does not push
// the payload out of L2.  Rows are 12 or 24 words (a BLS12-381 Fq or
// Fq2 coordinate) or 8 or 16 (BN254's) and the payload 16-byte aligned:
// the wrapper refuses others.
//
// slot_tables_kernel builds the gather's two payloads of an MSM, once per
// MSM, from its limb-major coordinates: (x, y (U, N)) -> xtab (N, U), x's
// rows, and ytab (2N, U), y's rows then -y's (p - y in each base-field
// component, 0 staying 0), so a slot's sign picks its row.  In the
// reference XLA builds the payload (crypto_tpu/ops/msm_v2.py:719-721, x
// and the signed y packed in 30 bits).  One thread a point: its limb
// loads are coalesced across the warp, its rows go out as 16-byte
// stores.  Bound by bytes: 2 coordinates in, 3 rows out.
#include "field.cuh"

namespace {

constexpr int T = 256;

// C words a row, C a multiple of 4; payload 16-byte aligned.
template <int C>
__global__ void __launch_bounds__(T) gather_rows_t_kernel(const uint4* __restrict__ payload,
                                                          const long long* __restrict__ idx,
                                                          uint32_t* __restrict__ out,
                                                          long long N, long long M) {
  static_assert(C % 4 == 0, "rows of whole 16-byte vectors");
  constexpr int Q = C / 4;
  const long long j = (long long)blockIdx.x * T + threadIdx.x;
  if (j >= M) return;
  const long long c = idx[j];
  uint4 v[Q];
  if (c >= 0 && c < N) {
    const uint4* row = payload + c * Q;
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = row[q];
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t* col = out + j;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    __stcs(col + (4 * q + 0) * M, v[q].x);
    __stcs(col + (4 * q + 1) * M, v[q].y);
    __stcs(col + (4 * q + 2) * M, v[q].z);
    __stcs(col + (4 * q + 3) * M, v[q].w);
  }
}

// U = L (an Fq coordinate) or 2L (Fq2, c0's limbs then c1's), L = 12
// (BLS12-381) or 8 (BN254).
template <int U, int L>
__global__ void __launch_bounds__(T) slot_tables_kernel(const uint32_t* __restrict__ x,
                                                        const uint32_t* __restrict__ y,
                                                        uint4* __restrict__ xtab,
                                                        uint4* __restrict__ ytab, long long N,
                                                        ctt::Mod<L> m) {
  constexpr int Q = U / 4;
  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  if (i >= N) return;
  uint32_t r[U];
  ctt::load<U>(r, x, N, i);
#pragma unroll
  for (int q = 0; q < Q; ++q)
    xtab[i * Q + q] = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  ctt::load<U>(r, y, N, i);
#pragma unroll
  for (int q = 0; q < Q; ++q)
    ytab[i * Q + q] = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
#pragma unroll
  for (int c = 0; c < U / L; ++c) ctt::neg<L>(r + c * L, r + c * L, m);
#pragma unroll
  for (int q = 0; q < Q; ++q)
    ytab[(N + i) * Q + q] = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

}  // namespace

// U words a row from L-limb coordinates: U = L or 2L, L = 12 or 8.
extern "C" int crypto_slot_tables(const void* x, const void* y, void* xtab, void* ytab, long long U,
                                  long long N, int L, const void* p, unsigned int n0inv,
                                  void* stream) {
  const unsigned int blocks = (unsigned int)((N + T - 1) / T);
  if (U != L && U != 2 * L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return ctt::by_limbs(L, [&](auto n) {
    constexpr int LN = decltype(n)::value;
    const ctt::Mod<LN> m = ctt::make_mod<LN>((const uint32_t*)p, n0inv);
    if (U == LN) {
      slot_tables_kernel<LN, LN><<<blocks, T, 0, s>>>((const uint32_t*)x, (const uint32_t*)y,
                                                      (uint4*)xtab, (uint4*)ytab, N, m);
    } else {
      slot_tables_kernel<2 * LN, LN><<<blocks, T, 0, s>>>(
          (const uint32_t*)x, (const uint32_t*)y, (uint4*)xtab, (uint4*)ytab, N, m);
    }
    return cudaSuccess;
  });
}

extern "C" int crypto_gather_rows_t(const void* payload, const void* idx, void* out,
                                    long long N, long long C, long long M, void* stream) {
  const unsigned int blocks = (unsigned int)((M + T - 1) / T);
  if ((uintptr_t)payload % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* p = (const uint4*)payload;
  const long long* ix = (const long long*)idx;
  uint32_t* o = (uint32_t*)out;
  if (C == 8) {
    gather_rows_t_kernel<8><<<blocks, T, 0, s>>>(p, ix, o, N, M);
  } else if (C == 12) {
    gather_rows_t_kernel<12><<<blocks, T, 0, s>>>(p, ix, o, N, M);
  } else if (C == 16) {
    gather_rows_t_kernel<16><<<blocks, T, 0, s>>>(p, ix, o, N, M);
  } else if (C == 24) {
    gather_rows_t_kernel<24><<<blocks, T, 0, s>>>(p, ix, o, N, M);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
