// Triplane lookup (the forward of `sample_planes`) for Hopper: the
// 3-plane bilinear sample of every render pass.
//
// Replaces no Pallas kernel: spi_tpu runs this lookup as an XLA
// composition (four corner gathers, spi_tpu/ops/grid_sample.py, called by
// sample_from_planes in spi_tpu/models/rendering/renderer.py). The
// nearest TPU kernel is the row gather `gather_kernel` of
// tools/profile_gather.py:111, measured there at a render pass's rows;
// this kernel fuses its four gathers with the texel math and the weighted
// sum. out[n, p, m, :] is the bilinear sample of plane p of table n at
// point m's projection: (N, 3, H*W, C) channels-last planes in float32 or
// bfloat16, (N, M, 3) float32 world points, float32 (N, 3, M, C) out,
// align_corners=False, zeros padding.
//
// Arithmetic: the texel math of plane_texels.cuh (the splat's too), then,
// for each output element, the order of the plain version
// (`sample_planes_plain`, ops/grid_sample.py `sample_flat`): each corner's
// weight times 0 or 1 for its range test, row x weight rounded once per
// corner (a bfloat16 row value widens to float32 exactly), summed left to
// right over the corners (0,0), (1,0), (0,1), (1,1), with _rn intrinsics
// so that nothing is contracted into an FMA. An out-of-range corner reads
// its clamped texel and weighs zero, as in the plain version, so the two
// agree bitwise.
//
// What bounds it on an H100: bytes. A 128^2 x 48 coarse pass at C = 32
// reads 9.4 MB of coordinates and at most 25.2 MB of f32 planes (12.6 MB
// bf16) and writes 302.0 MB of f32 features: 0.1005 ms (f32) and 0.0967 ms
// (bf16) at 3.35 TB/s, the output's writes nine tenths of it. There is no
// product for the tensor cores and no regular tile for TMA: it is a
// gather. The design:
//   - a group of C/4 (f32) or C/8 (bf16) consecutive threads owns one
//     point; each thread owns 16 bytes of each corner row (4 f32 or 8
//     bf16 channels), so a group reads each 128-byte (f32) or 64-byte
//     (bf16) corner row in one coalesced sweep, and writes its 16 or 32
//     bytes of each plane's output with streaming stores (the output is
//     read by the next op, not by this one, and should not push the planes
//     out of the L2);
//   - every thread of the group computes the point's corners itself (the
//     coordinates are one broadcast load), for the three planes in turn,
//     so the 12 corner loads of a thread are independent and in flight
//     together;
//   - blocks are numbered table by table, points in order within a table,
//     so the blocks in flight at any time work on one table: one image's
//     25 MB of f32 planes stays in the 50 MB L2 while its points are read.
//     A vmapped batch of B images is B * N tables of one launch.
//
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W power
// limit), a coarse pass device-only: f32 0.144 ms, 68% of its bound
// counted over the 124,405 corner rows the pass reads (0.0977 ms); bf16
// 0.164 ms, 58% of 0.0953 ms; the plain version 8.47 ms, F.grid_sample on
// the same planes 1.47 ms (f32). A four-camera pass (3,145,728 points)
// 0.565 ms f32, 0.651 ms bf16; a GAN pass of 8 tables x 196,608 points
// 0.319 / 0.322 ms. What holds it above the bound: the output's writes,
// behind a chain of dependent loads (coordinates, then corner rows); the
// bf16 form runs half the threads, each with twice the loads, at 43
// registers against 34 (5 blocks of 256 an SM against 7).

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_texels.cuh"

namespace {

constexpr int kThreads = 256;

// 16 bytes of one corner row, widened to float32.
template <typename T>
struct Row;

template <>
struct Row<float> {
  static constexpr int kChannels = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};

template <>
struct Row<uint16_t> {  // bfloat16 bits; channel 2i is the low half of word i
  static constexpr int kChannels = 8;
  __device__ __forceinline__ static void load(const uint16_t* p, float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

// planes (tables, 3, h * w, c); coords (tables, m, 3); out (tables, 3, m, c).
// Thread q serves point q / lanes (over all tables) and channels
// [(q % lanes) * kChannels, + kChannels) of it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
plane_sample_kernel(const T* __restrict__ planes, const float* __restrict__ coords,
                    float* __restrict__ out, int items, int lanes, int m, int h, int w, int c,
                    float scale) {
  constexpr int kC = Row<T>::kChannels;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= items) return;
  const int point = q / lanes;
  const int lane = q - point * lanes;
  const int table = point / m;
  const int i = point - table * m;
  const float* p = coords + (size_t)point * 3;
  const float xyz[3] = {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
#pragma unroll
  for (int plane = 0; plane < 3; ++plane) {
    const plane_texels::Corners k = plane_texels::corners(
        xyz[plane_texels::axis_u(plane)], xyz[plane_texels::axis_v(plane)], scale, h, w);
    const T* tab = planes + (size_t)(table * 3 + plane) * h * w * c + lane * kC;
    float acc[kC];
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      float v[kC];
      Row<T>::load(tab + (size_t)plane_texels::clamped_texel(k, corner, h, w) * c, v);
      const float wt =
          __fmul_rn(k.wt[corner], plane_texels::in_plane(k, corner, h, w) ? 1.0f : 0.0f);
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float t = __fmul_rn(v[j], wt);
        acc[j] = corner == 0 ? t : __fadd_rn(acc[j], t);
      }
    }
    float4* dst = reinterpret_cast<float4*>(out + ((size_t)(table * 3 + plane) * m + i) * c +
                                            lane * kC);
#pragma unroll
    for (int j = 0; j < kC / 4; ++j) {
      __stcs(dst + j, make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
    }
  }
}

template <typename T>
int launch(const T* planes, const float* coords, float* out, int tables, int m, int h, int w,
           int c, float scale, void* stream) {
  const int lanes = c / Row<T>::kChannels;
  const long long items = (long long)tables * m * lanes;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (items > 0) {
    const unsigned blocks = (unsigned)((items + kThreads - 1) / kThreads);
    plane_sample_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        planes, coords, out, (int)items, lanes, m, h, w, c, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// planes (tables, 3, h * w, c) float32 with c a multiple of 4, or bfloat16
// with c a multiple of 8, 16-byte aligned; coords (tables, m, 3) float32;
// out (tables, 3, m, c) float32, 16-byte aligned; fewer than 2^31 output
// and plane entries (checked by the Python wrapper). scale = 2 / box_warp.
// Returns cudaGetLastError() after the launch.
extern "C" int spi_plane_sample(const float* planes, const float* coords, float* out, int tables,
                                int m, int h, int w, int c, float scale, void* stream) {
  return launch<float>(planes, coords, out, tables, m, h, w, c, scale, stream);
}

extern "C" int spi_plane_sample_bf16(const void* planes, const float* coords, float* out,
                                     int tables, int m, int h, int w, int c, float scale,
                                     void* stream) {
  return launch<uint16_t>(static_cast<const uint16_t*>(planes), coords, out, tables, m, h, w, c,
                          scale, stream);
}
