// Windowed bilinear splat (round-5 probe) for Hopper.
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
// What bounds it on an H100: bytes (each cotangent read once, two
// coordinate rows per tile, the table written once: ~115 MB for 384 tiles
// of 2048 points at C = 32 in f32, ~34 us at 3.35 TB/s). The TPU kernel
// reduced each tile on the MXU into a VMEM window carried along a
// sequential grid. Here one CTA owns one (tile, channel group) and keeps
// its window in shared memory: the points are added into it with
// shared-memory atomics, and the window is flushed with global atomicAdd,
// because windows of different tiles overlap and CTAs run in no order.
// The channel group is the largest divisor of C, a multiple of 4, whose
// window fits in the 227 KB a block may use (64x64 windows take 8
// channels, 256x48 strips 4); the flush adds four channels at a time with
// 128-bit atomicAdd, so C must be a multiple of 4.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 with a 700 W power
// limit, K1 64x64 in f32: 1.59 ms against the 0.034 ms bound, where the
// plain version takes 2.91 ms. The shared-memory f32 atomicAdd compiles to
// a compare-and-swap loop (ATOMS.CAST.SPIN in the SASS), which costs more
// than the global atomics the window saves: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on sm_90

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// relu(1 - |i - f|), the Pallas kernel's hat function.
__device__ __forceinline__ float hat(float i, float f) {
  return fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(i, f))), 0.0f);
}

// offsets (T, 2) i32; fyx (T, rows, P) f32; gft (T, C, P); out (out_h,
// out_w * C) f32, zeroed. Grid (T, C / cg); dynamic shared memory holds
// the (win_h, win_w, cg) window.
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
win_scatter_kernel(const int* __restrict__ offsets, const float* __restrict__ fyx,
                   const T* __restrict__ gft, float* __restrict__ out, int fyx_rows,
                   int p, int c, int cg, int win_h, int win_w, int out_h,
                   int out_w, int dyn_rows) {
  extern __shared__ float win[];
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * cg;
  const int cells = win_h * win_w * cg;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) win[i] = 0.0f;
  __syncthreads();

  const float* fy_row = fyx + (size_t)t * fyx_rows * p;
  const float* fx_row = fy_row + p;
  const T* g_tile = gft + ((size_t)t * c + c0) * p;
  const int work = p * cg;
  for (int i = threadIdx.x; i < work; i += blockDim.x) {
    const int ch = i / p;
    const int pt = i - ch * p;
    const float fy = __ldg(fy_row + pt);
    const float fx = __ldg(fx_row + pt);
    const float y0f = floorf(fy);
    const float x0f = floorf(fx);
    // Some corner must lie in the window (false for NaN too).
    if (!(y0f >= -1.0f && y0f < (float)win_h && x0f >= -1.0f && x0f < (float)win_w)) continue;
    const float g = load_f32(g_tile + (size_t)ch * p + pt);
    const int y0 = (int)y0f;
    const int x0 = (int)x0f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = y0 + dy;
      if (y < 0 || y >= win_h) continue;
      float hy = hat((float)y, fy);
      if (kBf16) hy = round_bf16(hy);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = x0 + dx;
        if (x < 0 || x >= win_w) continue;
        const float hx = hat((float)x, fx);
        const float v = kBf16 ? __fmul_rn(hy, round_bf16(__fmul_rn(round_bf16(hx), g)))
                              : __fmul_rn(hy, __fmul_rn(hx, g));
        if (v != 0.0f) atomicAdd(&win[(y * win_w + x) * cg + ch], v);
      }
    }
  }
  __syncthreads();

  // Flush: the table address of window element i, or null outside the table.
  const int oy = dyn_rows ? offsets[2 * t] : 0;
  const int ox = offsets[2 * t + 1];
  auto dst = [&](int i) -> float* {
    const int cell = i / cg;
    const int gy = oy + cell / win_w;
    const int gx = ox + cell % win_w;
    if (gy < 0 || gy >= out_h || gx < 0 || gx >= out_w) return nullptr;
    return out + ((size_t)gy * out_w + gx) * c + c0 + i % cg;
  };
  // 4 channels at a time (cg is a multiple of 4), one 128-bit atomicAdd (sm_90).
  for (int i = threadIdx.x * 4; i < cells; i += blockDim.x * 4) {
    const float4 v = *reinterpret_cast<const float4*>(win + i);
    if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) continue;
    float* d = dst(i);
    if (d) atomicAdd(reinterpret_cast<float4*>(d), v);
  }
}

template <typename T, bool kBf16>
int launch(const int* offsets, const float* fyx, const void* gft, float* out,
           int t, int fyx_rows, int p, int c, int cg, int win_h, int win_w,
           int out_h, int out_w, int dyn_rows, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)win_h * win_w * cg;
  cudaFuncSetAttribute(win_scatter_kernel<T, kBf16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((unsigned)t, (unsigned)(c / cg));
  win_scatter_kernel<T, kBf16><<<grid, kThreads, smem, s>>>(
      offsets, fyx, static_cast<const T*>(gft), out, fyx_rows, p, c, cg, win_h,
      win_w, out_h, out_w, dyn_rows);
  return (int)cudaGetLastError();
}

// The channel group of a window: the largest divisor of C that is a
// multiple of 4 and whose (win_h, win_w, cg) f32 window fits in shared
// memory; 0 if none.
int channel_group(int c, int win_h, int win_w) {
  for (int cg = c - c % 4; cg >= 4; cg -= 4) {
    if (c % cg == 0 && sizeof(float) * (size_t)win_h * win_w * cg <= (size_t)kMaxSmem) return cg;
  }
  return 0;
}

}  // namespace

// Zeroes `out` and splats into it. gft is f32 (bf16 = 0) or bf16
// (bf16 = 1). Shapes and pointers are checked by the Python wrapper.
// Returns cudaGetLastError() after the launch.
extern "C" int spi_win_scatter(const int* offsets, const float* fyx, const void* gft,
                               float* out, int t, int fyx_rows, int p, int c,
                               int win_h, int win_w, int out_h, int out_w,
                               int dyn_rows, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)out_h * out_w * c, s);
  const int cg = channel_group(c, win_h, win_w);
  if (cg == 0) return (int)cudaErrorInvalidValue;
  if (t == 0 || p == 0) return (int)cudaGetLastError();
  return bf16 ? launch<__nv_bfloat16, true>(offsets, fyx, gft, out, t, fyx_rows, p, c, cg,
                                            win_h, win_w, out_h, out_w, dyn_rows, s)
              : launch<float, false>(offsets, fyx, gft, out, t, fyx_rows, p, c, cg, win_h,
                                     win_w, out_h, out_w, dyn_rows, s);
}
