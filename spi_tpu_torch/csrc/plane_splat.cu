// Triplane-gather backward (bilinear splat) for Hopper.
//
// Replaces the Pallas TPU kernel `_splat_kernel` of
// spi_tpu/ops/plane_splat.py (launched by `_splat_pallas`, driven by
// `windowed_splat` and `splat_planes`): the gradient of the 3-plane
// bilinear gather of spi_tpu/models/rendering/renderer.py. Each sample
// point's C-channel cotangent is added into each of its three (H, W, C)
// f32 plane-gradient tables with align_corners=False, zeros-padding
// bilinear weights: corners outside the plane are dropped, so a point
// fully outside adds nothing.
//
// Plane coordinates are recomputed here from the stored world-space
// points, exactly as the forward gather computes them: scale by
// 2 / box_warp, pick the plane axes of `project_onto_planes` (plane 0
// reads (x, y), plane 1 (x, z), plane 2 (z, x)), then map to texels with
// f = ((u + 1) * size - 1) / 2. The arithmetic is written with _rn
// intrinsics so that nvcc does not contract it into FMAs and the corner
// weights round as the PyTorch forward's do.
//
// What bounds it on an H100: bytes, as counted by the roofline (each
// cotangent read once, the coordinates read once, the tables written
// once: ~336 MB for a 128^2 x 48 coarse pass at C = 32, ~0.10 ms at the
// H100 SXM's 3.35 TB/s), but in practice the atomic traffic: 4 corners x 3 planes
// of C floats per point land in L2 as read-modify-writes, and samples of
// one ray hit the same few texels of plane 0. The TPU kernel avoided its
// slow scatter with per-tile windows reduced on the MXU and a fallback
// when a window overflowed. Here one thread owns one (view, plane, point,
// 4-channel group); it loads its cotangent as one float4 and issues one
// 128-bit vector atomicAdd (sm_90) per corner, so a warp covers four
// points' full 32-channel rows in coalesced 128 B segments. The kernel
// is exact for any point layout, so it serves coarse, fine and
// multi-camera passes and needs no overflow fallback. A shared-memory
// window per ray tile is later work. Measured by chip_smoke.py at the
// coarse-pass shape on an NVIDIA H100 80GB HBM3 with a 700 W power limit:
// 0.433 ms against the 0.100 ms bound, where the 4-corner index_add_ plain
// version takes 4.30 ms and PyTorch's grid_sampler_2d_backward 3.41 ms.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void add_corner(float* __restrict__ table, int xi,
                                           int yi, int h, int w, int c,
                                           float wgt, float4 g) {
  if (xi < 0 || xi >= w || yi < 0 || yi >= h) return;
  float4* dst = reinterpret_cast<float4*>(table + ((size_t)yi * w + xi) * c);
  atomicAdd(dst, make_float4(wgt * g.x, wgt * g.y, wgt * g.z, wgt * g.w));
}

// coords (N, M, 3); g (N, 3, M, C); out (N * 3, H * W, C), zeroed.
__global__ void plane_splat_kernel(const float* __restrict__ coords,
                                   const float* __restrict__ g,
                                   float* __restrict__ out, int n_views,
                                   int m, int h, int w, int c, float scale) {
  const int groups = c / 4;
  const long long total = (long long)n_views * 3 * m * groups;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cg = (int)(t % groups);
  const long long pm = t / groups;        // (view, plane, point)
  const int pt = (int)(pm % m);
  const int vp = (int)(pm / m);           // view * 3 + plane
  const int plane = vp % 3;
  const int view = vp / 3;

  const float* p = coords + ((long long)view * m + pt) * 3;
  const float cx = __fmul_rn(p[0], scale);
  const float cy = __fmul_rn(p[1], scale);
  const float cz = __fmul_rn(p[2], scale);
  const float u = plane == 2 ? cz : cx;
  const float v = plane == 0 ? cy : (plane == 1 ? cz : cx);
  const float fx = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.0f), (float)w), 1.0f), 0.5f);
  const float fy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(v, 1.0f), (float)h), 1.0f), 0.5f);
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  const float tx = __fsub_rn(fx, x0f);
  const float ty = __fsub_rn(fy, y0f);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;

  const float4 gv = *reinterpret_cast<const float4*>(g + pm * c + cg * 4);
  float* table = out + (size_t)vp * h * w * c + cg * 4;
  add_corner(table, x0, y0, h, w, c, __fmul_rn(1.0f - tx, 1.0f - ty), gv);
  add_corner(table, x0 + 1, y0, h, w, c, __fmul_rn(tx, 1.0f - ty), gv);
  add_corner(table, x0, y0 + 1, h, w, c, __fmul_rn(1.0f - tx, ty), gv);
  add_corner(table, x0 + 1, y0 + 1, h, w, c, __fmul_rn(tx, ty), gv);
}

constexpr int kThreads = 256;

}  // namespace

// Zeroes `out` and splats into it. C must be a multiple of 4 and every
// pointer 16-byte aligned (checked by the Python wrapper). Returns
// cudaGetLastError() after the launch.
extern "C" int spi_plane_splat(const float* coords, const float* g, float* out,
                               int n_views, int m, int h, int w, int c,
                               float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_views * 3 * h * w * c, s);
  const long long total = (long long)n_views * 3 * m * (c / 4);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (blocks > 0) {
    plane_splat_kernel<<<blocks, kThreads, 0, s>>>(coords, g, out, n_views, m,
                                                   h, w, c, scale);
  }
  return (int)cudaGetLastError();
}
