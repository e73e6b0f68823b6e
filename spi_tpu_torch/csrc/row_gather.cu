// Row gather along axis 0 (take_along_axis) for Hopper.
//
// Replaces the Pallas TPU kernel `gather_kernel` of
// tools/profile_gather.py (launched by `pallas_gather`):
// out[i, j] = tab[idx[i, j], j] for a (R, C) f32 table and (P, C) i32
// indices. Mosaic required the output to have the table's shape; here P
// is any number of rows. An index outside [0, R) gives 0 (the plain
// version, torch.gather, raises on it).
//
// What bounds it on an H100: bytes (the indices and the output once, the
// table at most once: 25.2 MB at the probe's 65536 x 32, ~7.5 us at
// 3.35 TB/s). One thread per output element: neighbouring threads read
// neighbouring indices and write neighbouring outputs, and when a row's
// indices are equal (the probe broadcasts one row index over C) they read
// one contiguous table row, so every access is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void row_gather_kernel(const float* __restrict__ tab,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, long long n, int c,
                                  int rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = __ldg(idx + i);
  const int j = (int)(i % c);
  out[i] = (r >= 0 && r < rows) ? __ldg(tab + (size_t)r * c + j) : 0.0f;
}

}  // namespace

// tab (rows, C) f32; idx and out (P, C). Returns cudaGetLastError().
extern "C" int spi_row_gather(const float* tab, const int* idx, float* out,
                              int p, int c, int rows, void* stream) {
  const long long n = (long long)p * c;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (blocks > 0) {
    row_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(tab, idx, out, n, c,
                                                                     rows);
  }
  return (int)cudaGetLastError();
}
