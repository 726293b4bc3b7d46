// Column gather: (src (U, N) uint32, idx (M,) int64) -> (U, M), column
// idx[j] of src in column j, and a zero column where idx[j] < 0 (an empty
// slot) or idx[j] >= N.
//
// Replaces crypto_tpu/ops/pallas/field_kernels.py gather_rows_t_fn, the
// row gather with transposed output that lays out the MSM's bucket slots
// (there a scalar-prefetch DMA gather of payload rows, dead slots issuing
// no DMA).  The port's payload is limb-major already, so the gather is of
// columns and no transpose is left to do.  The kernel reads no address
// outside src, and gives what the plain version gives for every index.
//
// Bound on the H100: bytes; it does no arithmetic.  One thread per (row,
// output column), the row in blockIdx.y: a warp's writes and index loads
// are contiguous (coalesced), its reads of src are scattered, as in any
// gather, one 4-byte word each.  The index is read once per row, from
// L2 after the first.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 256;

__global__ void __launch_bounds__(T) gather_kernel(const uint32_t* __restrict__ src,
                                                   const long long* __restrict__ idx,
                                                   uint32_t* __restrict__ out, long long N,
                                                   long long M) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  const long long u = blockIdx.y;
  const long long c = idx[j];
  out[u * M + j] = (c >= 0 && c < N) ? src[u * N + c] : 0u;
}

}  // namespace

extern "C" int crypto_gather_cols(const void* src, const void* idx, void* out, long long U,
                                  long long N, long long M, void* stream) {
  if (U > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)((M + T - 1) / T), (unsigned int)U);
  gather_kernel<<<grid, T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)src, (const long long*)idx, (uint32_t*)out, N, M);
  return (int)cudaGetLastError();
}
