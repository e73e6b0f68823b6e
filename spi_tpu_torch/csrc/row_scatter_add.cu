// Row scatter-add for Hopper.
//
// Replaces the Pallas TPU kernel `kernel` of `pallas_rmw_probe` in
// tools/probe_scatter_r5.py: zeros(R, C).at[rows].add(upd), a serial
// read-modify-write of one VMEM-resident table, row by row, along a
// sequential grid. Rows outside [0, R) are dropped, as JAX's scatter
// drops them.
//
// What bounds it on an H100: bytes (updates and row ids read once, the
// table written once: ~112 MB for 786,432 rows of 32 f32 into 65,536,
// ~34 us at 3.35 TB/s), and in practice the atomic read-modify-writes in
// L2, about 12 updates a table row. Blocks run in no order, so nothing
// can carry a table from one to the next: one thread owns one (row,
// 4-channel group), loads its update as one float4 and adds it with one
// 128-bit vector atomicAdd (sm_90), as csrc/plane_splat.cu does; a warp
// covers four rows of 32 channels in coalesced 128 B segments.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void row_scatter_add_kernel(const int* __restrict__ rows,
                                       const float* __restrict__ upd,
                                       float* __restrict__ out, long long n,
                                       int c, int out_rows) {
  const int groups = c / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * groups) return;
  const long long i = t / groups;
  const int cg = (int)(t % groups);
  const int r = __ldg(rows + i);
  if (r < 0 || r >= out_rows) return;
  const float4 v = __ldg(reinterpret_cast<const float4*>(upd + i * c) + cg);
  atomicAdd(reinterpret_cast<float4*>(out + (size_t)r * c) + cg, v);
}

}  // namespace

// Zeroes `out` (out_rows, C) and adds upd (n, C) into it at rows (n,).
// C must be a multiple of 4 and upd / out 16-byte aligned (checked by the
// Python wrapper). Returns cudaGetLastError() after the launch.
extern "C" int spi_row_scatter_add(const int* rows, const float* upd, float* out,
                                   int n, int c, int out_rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)out_rows * c, s);
  const long long total = (long long)n * (c / 4);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (blocks > 0) {
    row_scatter_add_kernel<<<blocks, kThreads, 0, s>>>(rows, upd, out, n, c, out_rows);
  }
  return (int)cudaGetLastError();
}
