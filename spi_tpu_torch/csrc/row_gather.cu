// Row gather along axis 0 (take_along_axis) for Hopper.
//
// Replaces the Pallas TPU kernel `gather_kernel` of
// tools/profile_gather.py (launched by `pallas_gather`):
// out[i, j] = tab[idx[i, j], j] for a (R, C) f32 table and (P, C) i32
// indices, C a multiple of 4. Mosaic required the output to have the
// table's shape; here P is any number of rows. As jnp.take_along_axis in
// its default mode, an index in [-R, 0) wraps to idx + R and any other
// index outside [0, R) gives NaN.
//
// What bounds it on an H100: bytes (the indices and the output once, the
// table at most once: 25.2 MB at the probe's 65536 x 32, 7.5 us at
// 3.35 TB/s; 209.7 MB, 62.6 us, at the render pass's 786,432 rows).
// Each thread handles four consecutive columns of one row: one 16-byte
// index load, then one 16-byte table load when the four wrapped indices
// are equal and in range (a row index broadcast over the columns, the
// probe's case and the triplane lookup's form), else four scalar loads
// with the range check; one 16-byte store. A few blocks per SM walk the elements with a
// grid-stride loop.
//
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W power
// limit), with a row index broadcast over the columns: device-only
// 0.0052 ms at the probe's shape, under the HBM bound because repeated
// calls find the 25 MB in the 50 MB L2 (torch.gather on int64 indices
// 0.0098 ms), and 0.089 ms at the render pass's (torch.gather 0.134 ms);
// with an index per element 0.019 and 0.212 ms (torch.gather 0.021 and
// 0.223). Back-to-back, at the probe's shape, a call is paced by its host
// work (about 14 us: checks, allocation, ctypes, launch), not by the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// The quiet NaN that take_along_axis fills with.
__device__ __forceinline__ float fill() { return __int_as_float(0x7fc00000); }

// An index in [-rows, 0) wraps to [0, rows).
__device__ __forceinline__ int wrap(int r, int rows) { return r < 0 ? r + rows : r; }

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ tab, const int4* __restrict__ idx,
                  float4* __restrict__ out, int n4, int c, int rows) {
  const int c4 = c / 4;
  const int stride = gridDim.x * kThreads;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < n4; q += stride) {
    int4 r = __ldg(idx + q);
    r.x = wrap(r.x, rows);
    r.y = wrap(r.y, rows);
    r.z = wrap(r.z, rows);
    r.w = wrap(r.w, rows);
    const float* col = tab + (size_t)(q % c4) * 4;
    float4 v;
    if (r.x == r.y && r.x == r.z && r.x == r.w && (unsigned)r.x < (unsigned)rows) {
      v = __ldg(reinterpret_cast<const float4*>(col + (size_t)r.x * c));
    } else {
      v.x = (unsigned)r.x < (unsigned)rows ? __ldg(col + (size_t)r.x * c) : fill();
      v.y = (unsigned)r.y < (unsigned)rows ? __ldg(col + (size_t)r.y * c + 1) : fill();
      v.z = (unsigned)r.z < (unsigned)rows ? __ldg(col + (size_t)r.z * c + 2) : fill();
      v.w = (unsigned)r.w < (unsigned)rows ? __ldg(col + (size_t)r.w * c + 3) : fill();
    }
    out[q] = v;
  }
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return 132;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

}  // namespace

// tab (rows, C) f32; idx and out (P, C), C a multiple of 4, fewer than
// 2^31 elements, every pointer 16-byte aligned (checked by the Python
// wrapper). Returns cudaGetLastError().
extern "C" int spi_row_gather(const float* tab, const int* idx, float* out, int p, int c,
                              int rows, void* stream) {
  const int n4 = (int)((long long)p * c / 4);
  const int need = (n4 + kThreads - 1) / kThreads;
  const int cap = sm_count() * kBlocksPerSm;
  const int blocks = need < cap ? need : cap;
  if (blocks > 0) {
    row_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tab, reinterpret_cast<const int4*>(idx), reinterpret_cast<float4*>(out), n4, c, rows);
  }
  return (int)cudaGetLastError();
}
