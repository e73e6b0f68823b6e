// Triplane-gather backward (bilinear splat) for Hopper: group by texel
// and reduce per ray tile.
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
// once: 336.6 MB for a 128^2 x 48 coarse pass at C = 32, 0.1005 ms at
// 3.35 TB/s). The earlier design gave each (point, plane, 4-channel
// group) one thread and four float4 atomics: 75.5 M reductions into the
// L2 for a coarse pass, most of them onto texels that neighbouring rays
// share, and 0.43 ms. A shared-memory window does not help on sm_90,
// where an f32 atomicAdd to shared memory is a compare-and-swap loop
// (ATOMS.CAST.SPIN).
//
// This design: one block owns one (ray tile, plane). A ray tile is
// tv x tu neighbouring rays x ts consecutive samples of one view (the
// caller's ray geometry; without one, a run of consecutive points), at
// most kTilePoints points; a ragged tile is masked. The block
//   1. starts cp.async copies of the tile's cotangent rows into shared
//      memory, which land while it
//   2. computes each point's in-plane corners (texel, weight) and groups
//      them by texel in an open-addressing table in shared memory: one
//      integer compare-and-swap per probe (ATOMS.CAS) finds the texel's
//      slot, one integer atomicAdd (ATOMS.ADD) a rank in it,
//   3. lays the slots out as runs with one block scan and writes each
//      corner's (point, weight) at its run's start plus its rank,
//   4. gives each (run, 4-channel group) one thread, which sums weight x
//      cotangent in registers from the staged rows, and
//   5. issues ONE float4 atomicAdd (REDG.E.ADD.F32 on sm_90) per
//      (distinct texel, group) into the zeroed table.
// No f32 value is added with a shared-memory atomic. The table has a slot
// per corner, so it never fills: the result is exact for any point layout,
// with no window and no overflow path; a spread tile only costs more
// reductions. The order of the adds within a run follows the atomicAdd
// ranks, so the f32 sums, like the global reductions, may differ in their
// last bits from run to run.
//
// Measured (chip_smoke.py phase 2 and tools/splat_tiles.py, device-only,
// NVIDIA H100 80GB HBM3, 700 W power limit): with 16 x 4 rays x 4 samples
// a tile, a coarse pass issues 10.7 M reductions in place of 75.5 M and
// takes 0.177 ms against its 0.1005 ms bound (the earlier kernel 0.434 ms
// in the same run); a fine pass, with 16 x 2 x 8 tiles, 0.205 ms (0.452),
// the two-camera 'mir' coarse pass 0.348 ms (0.856). The time hardly
// follows the number of reductions: tiles of 32 x 4 x 4 issue 7.5 M and
// take 0.187 ms. What holds it above the bound is each block's chain of
// latencies (coordinate loads, shared-memory round trips, barriers), which
// four blocks of 256 threads an SM hide only in part. A version that
// sorted the corners by key with cub::BlockRadixSort in place of the hash
// table was slower; the sort took the largest share of each block's time.

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;  // channels staged in shared memory at a time

// Ray geometry of the points of one table, and the tile shape.
struct Geometry {
  int m;        // points per table
  int views;    // views per table
  int rays_h, rays_w, samples;
  int tv, tu, ts;                  // tile: rays down, rays across, samples
  int tiles_h, tiles_w, tiles_s;   // tiles per view along each axis
};

constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

template <int kTilePoints, int kThreads>
struct Config {
  static constexpr int kEntries = 4 * kTilePoints;
  static constexpr int kItems = kEntries / kThreads;
  static constexpr int kPoints = kTilePoints / kThreads;  // points a thread owns
  // A slot per entry: there are never more distinct texels than slots.
  static constexpr int kSlots = kEntries;
  static constexpr int kSlotBits = log2i(kSlots);
  static constexpr int kSlotsPerThread = kSlots / kThreads;
  // A run is packed as texel << kStartBits | first entry; texels < 2^kTexelBits.
  static constexpr int kStartBits = log2i(kEntries) + 1;
  static constexpr int kTexelBits = 32 - kStartBits;
  using Scan = cub::BlockScan<int, kThreads>;
  struct Smem {
    int slot_texel[kSlots];   // texel held by each slot, -1 while empty
    int slot_count[kSlots];   // entries in each slot, then where its run starts
    unsigned run[kEntries + 1];
    float2 pw[kEntries];      // (local point, weight), grouped by run
    typename Scan::TempStorage scan;
    int rows[kTilePoints];    // point index within its table, -1 if masked
  };
  static constexpr size_t kHead = (sizeof(Smem) + 15) / 16 * 16;
  static constexpr size_t kBytes = kHead + sizeof(float) * kTilePoints * kChunk;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Copy channels [c0, c0 + cw) of the tile's cotangent rows into gs,
// (point, channel) row-major; masked points are skipped.
template <int kThreads>
__device__ __forceinline__ void stage(float* gs, const float* gt, const int* rows, int tp,
                                      int c, int c0, int cw) {
  const int groups = cw / 4;
  for (int i = threadIdx.x; i < tp * groups; i += kThreads) {
    const int l = i / groups;
    const int cg = i - l * groups;
    const int row = rows[l];
    if (row >= 0) cp_async16(gs + l * cw + cg * 4, gt + (size_t)row * c + c0 + cg * 4);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// coords (tables, m, 3); g (tables, 3, m, C); out (tables * 3, H * W, C),
// zeroed. grid = (tables * views * tiles per view, 3 planes).
template <int kTilePoints, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
plane_splat_kernel(const float* __restrict__ coords, const float* __restrict__ g,
                   float* __restrict__ out, Geometry geo, int h, int w, int c, float scale) {
  using Cfg = Config<kTilePoints, kThreads>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<typename Cfg::Smem*>(smem_raw);
  float* gs = reinterpret_cast<float*>(smem_raw + Cfg::kHead);

  const int plane = blockIdx.y;
  const int per_view = geo.tiles_h * geo.tiles_w * geo.tiles_s;
  int rest = blockIdx.x;
  const int table = rest / (geo.views * per_view);
  rest -= table * geo.views * per_view;
  const int view = rest / per_view;
  rest -= view * per_view;
  const int th = rest / (geo.tiles_w * geo.tiles_s);
  rest -= th * geo.tiles_w * geo.tiles_s;
  const int tw = rest / geo.tiles_s;
  const int tsg = rest - tw * geo.tiles_s;
  const int tp = geo.tv * geo.tu * geo.ts;

  // 1. The tile's points (index within the table, -1 where masked) and
  // their plane coordinates, loaded before the copies below are issued;
  // empty slots.
  int rows[Cfg::kPoints];
  float pu[Cfg::kPoints], pv[Cfg::kPoints];
#pragma unroll
  for (int k = 0; k < Cfg::kPoints; ++k) {
    const int l = threadIdx.x + k * kThreads;
    rows[k] = -1;
    if (l < tp) {
      const int ry = th * geo.tv + l / (geo.tu * geo.ts);
      const int rx = tw * geo.tu + (l / geo.ts) % geo.tu;
      const int sp = tsg * geo.ts + l % geo.ts;
      if (ry < geo.rays_h && rx < geo.rays_w && sp < geo.samples) {
        rows[k] = ((view * geo.rays_h + ry) * geo.rays_w + rx) * geo.samples + sp;
      }
    }
    sm.rows[l] = rows[k];
    if (rows[k] >= 0) {
      const float* p = coords + ((size_t)table * geo.m + rows[k]) * 3;
      pu[k] = __ldg(p + (plane == 2 ? 2 : 0));
      pv[k] = __ldg(p + (plane == 0 ? 1 : (plane == 1 ? 2 : 0)));
    }
  }
#pragma unroll
  for (int i = 0; i < Cfg::kSlotsPerThread; ++i) {
    sm.slot_texel[threadIdx.x + i * kThreads] = -1;
    sm.slot_count[threadIdx.x + i * kThreads] = 0;
  }
  __syncthreads();

  // 2. Start copying the first channel chunk's cotangent rows.
  const float* gt = g + (size_t)(table * 3 + plane) * geo.m * c;
  stage<kThreads>(gs, gt, sm.rows, tp, c, 0, c < kChunk ? c : kChunk);

  // 3. Each point's in-plane corners: texel and weight. Each corner finds
  // its texel's slot in an open-addressing table (an integer CAS per
  // probe) and takes a rank in it (an integer atomicAdd).
  int slot[Cfg::kItems], rank[Cfg::kItems];
  float wt[Cfg::kItems];
#pragma unroll
  for (int k = 0; k < Cfg::kPoints; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) slot[k * 4 + q] = -1;
    if (rows[k] < 0) continue;
    const float u = __fmul_rn(pu[k], scale);
    const float v = __fmul_rn(pv[k], scale);
    const float fx = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.0f), (float)w), 1.0f), 0.5f);
    const float fy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(v, 1.0f), (float)h), 1.0f), 0.5f);
    const float x0f = floorf(fx);
    const float y0f = floorf(fy);
    const float tx = __fsub_rn(fx, x0f);
    const float ty = __fsub_rn(fy, y0f);
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const float corner_wt[4] = {__fmul_rn(1.0f - tx, 1.0f - ty), __fmul_rn(tx, 1.0f - ty),
                                __fmul_rn(1.0f - tx, ty), __fmul_rn(tx, ty)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int xi = x0 + (q & 1);
      const int yi = y0 + (q >> 1);
      if (xi < 0 || xi >= w || yi < 0 || yi >= h) continue;
      const int texel = yi * w + xi;
      unsigned s = ((unsigned)texel * 2654435761u) >> (32 - Cfg::kSlotBits);
      for (;;) {
        const int held = atomicCAS(&sm.slot_texel[s], -1, texel);
        if (held == -1 || held == texel) break;
        s = (s + 1) & (Cfg::kSlots - 1);
      }
      slot[k * 4 + q] = (int)s;
      rank[k * 4 + q] = atomicAdd(&sm.slot_count[s], 1);
      wt[k * 4 + q] = corner_wt[q];
    }
  }
  __syncthreads();

  // 4. Runs: one per occupied slot, laid out by one block scan over
  // (occupied, count) packed as occupied << 16 | count.
  int packed[Cfg::kSlotsPerThread];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < Cfg::kSlotsPerThread; ++i) {
    const int n = sm.slot_count[threadIdx.x * Cfg::kSlotsPerThread + i];
    packed[i] = n > 0 ? (1 << 16) | n : 0;
    sum += packed[i];
  }
  int before, total;
  typename Cfg::Scan(sm.scan).ExclusiveSum(sum, before, total);
#pragma unroll
  for (int i = 0; i < Cfg::kSlotsPerThread; ++i) {
    const int s = threadIdx.x * Cfg::kSlotsPerThread + i;
    if (packed[i]) {
      const unsigned first = (unsigned)(before & 0xffff);
      sm.run[before >> 16] = ((unsigned)sm.slot_texel[s] << Cfg::kStartBits) | first;
      sm.slot_count[s] = (int)first;
    }
    before += packed[i];
  }
  const int runs = total >> 16;
  if (threadIdx.x == 0) sm.run[runs] = (unsigned)(total & 0xffff);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < Cfg::kItems; ++i) {
    if (slot[i] >= 0) {
      const int l = threadIdx.x + (i / 4) * kThreads;
      sm.pw[sm.slot_count[slot[i]] + rank[i]] = make_float2(__int_as_float(l), wt[i]);
    }
  }
  __syncthreads();

  // 5. One thread per (run, 4-channel group): sum weight x cotangent in
  // registers, then one float4 reduction into the table.
  constexpr unsigned kStartMask = (1u << Cfg::kStartBits) - 1;
  float* table_out = out + (size_t)(table * 3 + plane) * h * w * c;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int cw = c - c0 < kChunk ? c - c0 : kChunk;
    const int groups = cw / 4;
    if (c0 > 0) {
      __syncthreads();  // every thread is done with the previous chunk
      stage<kThreads>(gs, gt, sm.rows, tp, c, c0, cw);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    const float4* g4 = reinterpret_cast<const float4*>(gs);
    for (int task = threadIdx.x; task < runs * groups; task += kThreads) {
      const int r = task / groups;
      const int cg = task - r * groups;
      const unsigned head = sm.run[r];
      const int s1 = (int)(sm.run[r + 1] & kStartMask);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
      for (int j = (int)(head & kStartMask); j < s1; ++j) {
        const float2 pw = sm.pw[j];
        const float4 v = g4[__float_as_int(pw.x) * groups + cg];
        acc.x = __fmaf_rn(pw.y, v.x, acc.x);
        acc.y = __fmaf_rn(pw.y, v.y, acc.y);
        acc.z = __fmaf_rn(pw.y, v.z, acc.z);
        acc.w = __fmaf_rn(pw.y, v.w, acc.w);
      }
      const size_t texel = head >> Cfg::kStartBits;
      atomicAdd(reinterpret_cast<float4*>(table_out + texel * c + c0) + cg, acc);
    }
  }
}

template <int kTilePoints, int kThreads>
int launch(const float* coords, const float* g, float* out, int tables, const Geometry& geo,
           int h, int w, int c, float scale, cudaStream_t s) {
  using Cfg = Config<kTilePoints, kThreads>;
  static bool configured[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(plane_splat_kernel<kTilePoints, kThreads>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)Cfg::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  if ((long long)h * w > (1ll << Cfg::kTexelBits)) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)tables * geo.views * geo.tiles_h * geo.tiles_w * geo.tiles_s;
  if (blocks > 0) {
    plane_splat_kernel<kTilePoints, kThreads><<<dim3((unsigned)blocks, 3), kThreads, Cfg::kBytes, s>>>(
        coords, g, out, geo, h, w, c, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Zeroes `out` and splats into it. The points of each of the `tables`
// tables are `views` views of rays_h x rays_w rays x `samples` samples,
// tiled tv x tu x ts (at most 512 points a tile). C must be a multiple
// of 4 and every pointer 16-byte aligned (checked by the Python wrapper).
// Returns cudaGetLastError() after the launch.
extern "C" int spi_plane_splat(const float* coords, const float* g, float* out, int tables,
                               int views, int rays_h, int rays_w, int samples, int tv, int tu,
                               int ts, int h, int w, int c, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int m = views * rays_h * rays_w * samples;
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)tables * 3 * h * w * c, s);
  const Geometry geo{m, views, rays_h, rays_w, samples, tv, tu, ts,
                     (rays_h + tv - 1) / tv, (rays_w + tu - 1) / tu, (samples + ts - 1) / ts};
  const int tp = tv * tu * ts;
  if (tp <= 256) return launch<256, 256>(coords, g, out, tables, geo, h, w, c, scale, s);
  if (tp <= 512) return launch<512, 512>(coords, g, out, tables, geo, h, w, c, scale, s);
  return (int)cudaErrorInvalidValue;
}
