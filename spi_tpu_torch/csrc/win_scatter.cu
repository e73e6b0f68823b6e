// Windowed bilinear splat (round-5 probe) for Hopper: bin by window cell
// and reduce per tile.
//
// Replaces the Pallas TPU kernel `_make_kernel` of
// tools/probe_winscatter_r5.py (launched by `win_scatter`). Tile t holds
// P points whose window-relative coordinates are fyx[t, 0, :] (rows) and
// fyx[t, 1, :] (columns) and whose C-channel cotangents are gft[t, :, p].
// Each point is added into a (win_h, win_w, C) window with the hat weight
// relu(1 - |i - f|) per axis; corners outside the window are dropped, so
// a dead point (coordinates -10) adds nothing. The window is then added
// into the (out_h, out_w * C) f32 table at row offsets[t, 0] and column
// offsets[t, 1]; when win_h == out_h the row offset is ignored (the
// probe's K2 strips). Window cells that would land outside the table are
// dropped.
//
// Rounding follows the Pallas kernel: in f32, hy * (hx * g); in bf16 the
// hat weights are rounded to bf16, hx * g is rounded to bf16, and the
// product with hy (exact in f32) is accumulated in f32, as the MXU does.
// The hat weights are evaluated with _rn intrinsics so that they round as
// the Pallas and PyTorch versions do.
//
// What bounds it on an H100: bytes, as the roofline counts them (each
// cotangent read once, two coordinate rows per tile, the offsets, the table
// written once): 115.3 MB in f32 and 65.0 MB in bf16 for the probe's 384
// tiles of 2048 points at C = 32 into a 256 x 256 x 32 table, 0.0344 and
// 0.0194 ms at 3.35 TB/s. Beside the bytes, a per-tile design issues one
// float4 reduction into the L2 per nonzero (tile, window cell, 4-channel
// group), since windows of different tiles overlap and blocks run in no
// order: 9.10 M for the probe's K1 64 x 64 windows, 1.92 M for 64 x 32,
// 17.4 M for K2 256 x 48 strips.
//
// The TPU kernel made each tile a dense one-hot product on the MXU; its
// first port kept a whole f32 window per (tile, channel group) in shared
// memory and lost 46 times its bound to four things, each answered here:
//   1. f32 shared-memory atomicAdd compiles to a compare-and-swap loop
//      (ATOMS.CAST.SPIN) that retries under contention. Here no f32 value
//      is added with a shared atomic: the corners are binned by window cell
//      with integer atomics only (a counting sort: a 16-bit count per cell,
//      two to a word, whose atomicAdd, ATOMS.ADD, also gives the corner's
//      rank; one block scan; placement), and each cell's sum is taken in
//      registers.
//   2. A whole window per block, zeroed and swept. Here a block holds a
//      16-bit count per cell and a 16-bit point index per corner; the scan
//      lists the nonzero cells, and an empty cell costs nothing after it.
//   3. A grid of (tile, channel group) recomputed every point's weights for
//      each group and read the cotangents as scattered 4-byte loads. Here
//      one block bins its tile once, and the tile's cotangents arrive by
//      16-byte cp.async as contiguous (channels, P) slabs, 64 bytes a point
//      a pass (16 f32 or 32 bf16 channels): two passes in f32, one in bf16.
//   4. The flush issued one float4 atomicAdd per nonzero window cell and
//      group, each alone in its line. Here too one float4 reduction (REDG)
//      per nonzero (cell, group), which a per-tile design cannot cut, but
//      4 (f32) or 8 (bf16) neighbouring lanes sum one cell, 4 channels
//      each, so that a cell's reductions leave together, 64 or 128
//      contiguous bytes; a swizzle of the slab keeps those lanes on
//      distinct banks. The cells are taken in order of their corner count
//      (a second counting sort over 16 length buckets, warp-aggregated), so
//      the lanes of a warp run loops of equal length.
// A tile is binned kPoints points at a time (one chunk for the probe's
// 2048-point tiles); each chunk reduces on its own.
//
// Shared memory of a block (bytes): the slab 64 x kPoints (131,072), the
// chunk's coordinates 8 x kPoints (16,384), a 16-bit point index per
// corner (16,384), a 16-bit count, then start, per cell, and two 16-bit
// lists of the nonzero cells (cell order, length order), each at most
// min(cells, 4 x kPoints): 188,416 for 64 x 64 windows, 221,184 for
// 256 x 48 strips. So one block of 1024 threads takes an SM; two blocks an
// SM would need a slab of half the bytes, which halves the lanes that
// share a cell's reductions.
//
// Measured (device-only, NVIDIA H100 80GB HBM3, 700 W; PERF.md): K1 64 x 64
// 0.131 ms in f32 and 0.119 in bf16, where the first port took 1.599 and
// 1.626 in the same run. What sets the pace (measured on the same card by
// marks of %globaltimer in each block and by a kernel that issues the
// reductions alone; PERF.md): the same reductions alone, from values made
// in registers, take 0.056 ms at K1 (f32, 4 lanes a cell) and 0.048 (bf16,
// 8 lanes), so the kernel is 2.3-2.5 times its reductions at K1 and
// 1.6-1.7 times at K2. A K1 f32 block spends 57% of its time in the sums, close to the
// reductions' rate, and 43% binning, scanning, placing and waiting for
// the second pass's slab, when its SM, which holds one block, issues no
// reduction.
//
// The order of the adds within a cell follows the atomicAdd ranks, so the
// f32 sums, like the global reductions, may differ in their last bits from
// run to run.

#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kPoints = 2048;          // points binned at a time (POINT_CHUNK in Python)
constexpr int kEntries = 4 * kPoints;  // corners of a chunk, < 2^16
constexpr int kPointsPerThread = kPoints / kThreads;
constexpr int kRunsPerThread = kEntries / kThreads;
constexpr int kStageBytes = 64;        // bytes of a point's cotangents a pass stages
constexpr int kBuckets = 16;           // run lengths 1, ..., 15 and 16 or more
constexpr int kMaxCells = 15872;       // window cells whose lists fit shared memory
constexpr int kMaxSmem = 232448;       // bytes of shared memory a block may use on sm_90
constexpr int kDynSmem = kMaxSmem - 4096;  // of which dynamic: room for the scan's storage

using Scan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// relu(1 - |i - f|), the Pallas kernel's hat function.
__device__ __forceinline__ float hat(float i, float f) {
  return fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(i, f))), 0.0f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// A pass stages kStageC channels (64 bytes a point), summed by kLanes
// lanes a cell, 4 channels each.
template <typename T>
struct Pass {
  static constexpr int kStageC = kStageBytes / sizeof(T);
  static constexpr int kLanes = kStageC / 4;
  static constexpr int kPer16 = 16 / sizeof(T);  // points in a 16-byte piece
};

// Where cotangent (channel ch, point l) of a pass lies in the stage
// buffer: channel-major, with the 16-byte pieces of a channel's row
// permuted by the channel's 4-channel group, so that the lanes that read
// one point's channels for one cell hit distinct banks.
template <typename T>
__device__ __forceinline__ int piece(int group, int l) {
  return Pass<T>::kPer16 * ((l / Pass<T>::kPer16) ^ group) + l % Pass<T>::kPer16;
}

// Byte offsets of the dynamic shared memory's parts.
struct Smem {
  size_t fyx, entry, count, run, order, total;
  __host__ __device__ explicit Smem(int cells) {
    const size_t runs = (size_t)(cells < kEntries ? cells : kEntries);
    fyx = (size_t)kStageBytes * kPoints;
    entry = fyx + kPoints * sizeof(float2);
    count = entry + kEntries * sizeof(unsigned short);
    run = count + align16((size_t)(cells + 1) / 2 * sizeof(unsigned));
    order = run + align16(runs * sizeof(unsigned short));
    total = order + align16(runs * sizeof(unsigned short));
  }
};

// Start copying channels [0, sc) of np cotangents (global row stride p)
// into the stage buffer: 16-byte cp.async where the rows allow, else
// element by element through registers.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int p, int np, int sc, bool vec) {
  constexpr int kPer16 = Pass<T>::kPer16;
  if (vec) {
    const int pieces = np / kPer16;
    for (int i = threadIdx.x; i < sc * pieces; i += kThreads) {
      const int ch = i / pieces;
      const int k = i - ch * pieces;
      cp_async16(dst + ch * kPoints + kPer16 * (k ^ (ch >> 2)), src + (size_t)ch * p + k * kPer16);
    }
  } else {
    for (int i = threadIdx.x; i < sc * np; i += kThreads) {
      const int ch = i / np;
      const int l = i - ch * np;
      dst[ch * kPoints + piece<T>(ch >> 2, l)] = src[(size_t)ch * p + l];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// offsets (T, 2) i32; fyx (T, rows, P) f32; gft (T, C, P); out (out_h,
// out_w * C) f32, zeroed. One block per tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
win_scatter_kernel(const int* __restrict__ offsets, const float* __restrict__ fyx,
                   const T* __restrict__ gft, float* __restrict__ out, int fyx_rows, int p,
                   int c, int win_h, int win_w, int out_h, int out_w, int dyn_rows) {
  using Cfg = Pass<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int bucket[kBuckets];  // runs a length bucket holds, then where it starts
  const int cells = win_h * win_w;
  const Smem lay(cells);
  T* buf = reinterpret_cast<T*>(smem);
  float2* fyx_s = reinterpret_cast<float2*>(smem + lay.fyx);
  unsigned short* entry = reinterpret_cast<unsigned short*>(smem + lay.entry);
  unsigned* count = reinterpret_cast<unsigned*>(smem + lay.count);  // two cells a word
  unsigned short* start = reinterpret_cast<unsigned short*>(count);  // after the scan
  unsigned short* run = reinterpret_cast<unsigned short*>(smem + lay.run);
  unsigned short* order = reinterpret_cast<unsigned short*>(smem + lay.order);

  const int t = blockIdx.x;
  const int lane_id = threadIdx.x & 31;
  const int passes = (c + Cfg::kStageC - 1) / Cfg::kStageC;
  const int oy = dyn_rows ? offsets[2 * t] : 0;
  const int ox = offsets[2 * t + 1];
  const float* fy_g = fyx + (size_t)t * fyx_rows * p;
  const float* fx_g = fy_g + p;
  const T* g_tile = gft + (size_t)t * c * p;
  const bool vec = (p * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(gft) % 16 == 0;
  auto pass_channels = [&](int ps) {
    return c - ps * Cfg::kStageC < Cfg::kStageC ? c - ps * Cfg::kStageC : Cfg::kStageC;
  };

  for (int p0 = 0; p0 < p; p0 += kPoints) {
    const int np = p - p0 < kPoints ? p - p0 : kPoints;
    if (p0 > 0) __syncthreads();  // every thread is done with the previous chunk
    stage(buf, g_tile + p0, p, np, pass_channels(0), vec);
    for (int i = threadIdx.x; i < (cells + 1) / 2; i += kThreads) count[i] = 0;
    if (threadIdx.x < kBuckets) bucket[threadIdx.x] = 0;
    __syncthreads();

    // 1. Each corner of nonzero weight inside the window and the table
    // counts into its cell; the count before it is its rank.
    unsigned key[4 * kPointsPerThread];  // cell << 16 | rank, ~0u for none
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) key[4 * k + q] = ~0u;
      const int l = threadIdx.x + k * kThreads;
      if (l >= np) continue;
      const float fy = __ldg(fy_g + p0 + l);
      const float fx = __ldg(fx_g + p0 + l);
      fyx_s[l] = make_float2(fy, fx);
      const float y0f = floorf(fy);
      const float x0f = floorf(fx);
      // Some corner must lie in the window (false for NaN too).
      if (!(y0f >= -1.0f && y0f < (float)win_h && x0f >= -1.0f && x0f < (float)win_w)) continue;
      const int y0 = (int)y0f;
      const int x0 = (int)x0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int y = y0 + (q >> 1);
        const int x = x0 + (q & 1);
        if (y < 0 || y >= win_h || x < 0 || x >= win_w) continue;
        if (oy + y < 0 || oy + y >= out_h || ox + x < 0 || ox + x >= out_w) continue;
        if (hat((float)y, fy) == 0.0f || hat((float)x, fx) == 0.0f) continue;
        const unsigned cell = (unsigned)(y * win_w + x);
        const unsigned shift = (cell & 1u) * 16u;
        const unsigned old = atomicAdd(&count[cell >> 1], 1u << shift);
        key[4 * k + q] = cell << 16 | ((old >> shift) & 0xffffu);
      }
    }
    __syncthreads();

    // 2. One block scan over (nonzero, count) packed as nonzero << 16 |
    // count, over a run of cells per thread: each cell's start replaces its
    // count, and the nonzero cells (runs) are listed in cell order.
    const int per = (cells + kThreads - 1) / kThreads;
    const int cb = (int)threadIdx.x * per < cells ? (int)threadIdx.x * per : cells;
    const int ce = cb + per < cells ? cb + per : cells;
    int packed = 0;
    for (int i = cb; i < ce; ++i) {
      const int n = start[i];
      if (n) packed += (1 << 16) | n;
    }
    int before, total;
    Scan(scan_tmp).ExclusiveSum(packed, before, total);
    const int runs = total >> 16;
    const int corners = total & 0xffff;
    {
      int r = before >> 16;
      int s = before & 0xffff;
      for (int i = cb; i < ce; ++i) {
        const int n = start[i];
        start[i] = (unsigned short)s;
        if (n) {
          run[r++] = (unsigned short)i;
          s += n;
        }
      }
    }
    __syncthreads();

    // 3. Each corner's point goes to its cell's start plus its rank. Each
    // run takes a rank among the runs of its length bucket (one shared
    // atomic a bucket and warp).
#pragma unroll
    for (int i = 0; i < 4 * kPointsPerThread; ++i) {
      if (key[i] != ~0u) {
        entry[start[key[i] >> 16] + (key[i] & 0xffffu)] =
            (unsigned short)(threadIdx.x + (i / 4) * kThreads);
      }
    }
    auto run_end = [&](int r) { return r + 1 < runs ? (int)start[run[r + 1]] : corners; };
    unsigned rank[kRunsPerThread];  // bucket << 16 | rank in it, ~0u for none
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k) {
      rank[k] = ~0u;
      const int r = threadIdx.x + k * kThreads;
      if (r >= runs) continue;
      const int len = run_end(r) - start[run[r]];
      const unsigned b = (unsigned)(len < kBuckets ? len : kBuckets) - 1u;
      const unsigned peers = __match_any_sync(__activemask(), b);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane_id == leader) base = atomicAdd(&bucket[b], __popc(peers));
      base = __shfl_sync(peers, base, leader);
      rank[k] = b << 16 | (unsigned)(base + __popc(peers & ((1u << lane_id) - 1u)));
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // where each bucket starts: a scan over the buckets
      const int n = lane_id < kBuckets ? bucket[lane_id] : 0;
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane_id >= d) incl += v;
      }
      if (lane_id < kBuckets) bucket[lane_id] = incl - n;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k) {
      if (rank[k] != ~0u) {
        order[bucket[rank[k] >> 16] + (rank[k] & 0xffffu)] =
            (unsigned short)(threadIdx.x + k * kThreads);
      }
    }

    // 4. Per pass: kLanes neighbouring lanes take one nonzero cell, runs
    // of equal length side by side; each lane sums its 4 channels of the
    // cell's corners in registers and issues one float4 reduction, so that
    // a cell's reductions are contiguous.
    for (int ps = 0; ps < passes; ++ps) {
      if (ps > 0) {
        __syncthreads();  // every thread is done with the previous pass
        stage(buf, g_tile + (size_t)ps * Cfg::kStageC * p + p0, p, np, pass_channels(ps), vec);
      }
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();  // the pass's cotangents and step 3's lists are in place
      const int lanes = pass_channels(ps) / 4;
      float* out_c = out + ps * Cfg::kStageC;
      for (int task = threadIdx.x; task < runs * Cfg::kLanes; task += kThreads) {
        const int lane = task % Cfg::kLanes;
        if (lane >= lanes) continue;
        const int r = order[task / Cfg::kLanes];
        const int cell = run[r];
        const int j1 = run_end(r);
        const int y = cell / win_w;
        const int x = cell - y * win_w;
        const float yf = (float)y;
        const float xf = (float)x;
        const T* g_lane = buf + 4 * lane * kPoints;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
        for (int j = start[cell]; j < j1; ++j) {
          const int l = entry[j];
          const float2 f = fyx_s[l];
          const float hy = hat(yf, f.x);
          const float hx = hat(xf, f.y);
          const T* gp = g_lane + piece<T>(lane, l);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float g = to_f32(gp[i * kPoints]);
            if constexpr (std::is_same<T, __nv_bfloat16>::value) {
              // hy * bf16(bf16(hx) * g) is exact in f32: one fused add.
              acc[i] = __fmaf_rn(round_bf16(hy), round_bf16(__fmul_rn(round_bf16(hx), g)), acc[i]);
            } else {
              acc[i] = __fadd_rn(acc[i], __fmul_rn(hy, __fmul_rn(hx, g)));
            }
          }
        }
        const size_t at = ((size_t)(oy + y) * out_w + ox + x) * c + 4 * lane;
        atomicAdd(reinterpret_cast<float4*>(out_c + at), make_float4(acc[0], acc[1], acc[2], acc[3]));
      }
    }
  }
}

template <typename T>
int launch(const int* offsets, const float* fyx, const void* gft, float* out, int t,
           int fyx_rows, int p, int c, int win_h, int win_w, int out_h, int out_w, int dyn_rows,
           cudaStream_t s) {
  static bool configured[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        win_scatter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const size_t smem = Smem(win_h * win_w).total;
  if (smem > (size_t)kDynSmem) return (int)cudaErrorInvalidValue;
  win_scatter_kernel<T><<<(unsigned)t, kThreads, smem, s>>>(
      offsets, fyx, static_cast<const T*>(gft), out, fyx_rows, p, c, win_h, win_w, out_h, out_w,
      dyn_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Zeroes `out` and splats into it. gft is f32 (bf16 = 0) or bf16
// (bf16 = 1); C is a multiple of 4 and the window has at most 15,872
// cells (checked by the Python wrapper). Returns cudaGetLastError() after
// the launch.
extern "C" int spi_win_scatter(const int* offsets, const float* fyx, const void* gft,
                               float* out, int t, int fyx_rows, int p, int c, int win_h,
                               int win_w, int out_h, int out_w, int dyn_rows, int bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)out_h * out_w * c, s);
  if (c % 4 || win_h * win_w > kMaxCells) return (int)cudaErrorInvalidValue;
  if (t == 0 || p == 0) return (int)cudaGetLastError();
  return bf16 ? launch<__nv_bfloat16>(offsets, fyx, gft, out, t, fyx_rows, p, c, win_h, win_w,
                                      out_h, out_w, dyn_rows, s)
              : launch<float>(offsets, fyx, gft, out, t, fyx_rows, p, c, win_h, win_w, out_h,
                              out_w, dyn_rows, s);
}
