// upfirdn2d for Hopper, float32 and bfloat16, NCHW: zero-upsample, pad or
// crop, FIR filter and downsample in one pass, each (n, c) plane on its own.
//
// Replaces no Pallas kernel: spi_tpu runs this op as XLA
// (`lax.conv_general_dilated` in spi_tpu/ops/upfirdn2d.py). Before this
// kernel the port ran EG3D's `_upfirdn2d_ref` composition (kept as
// `upfirdn2d_plain` in ops/upfirdn2d.py): a zero-upsample pad, a border
// pad, both full copies of the input, then ATen's generic depthwise
// convolution, whose backward adds another copy for the pads' gradient.
// Every resampling convolution of the StyleGAN2 synthesis and the
// superresolution runs it twice a layer (after each transposed convolution
// of an up block, and on each ToRGB skip), and StyleGAN3's filtered_lrelu
// twice a layer.
//
// Semantics, as the plain version: y[oy, ox] is the correlation of the
// zero-upsampled (up - 1 zeros after each pixel), padded (negative: crop)
// input with w = f * gain, flipped unless flip_filter, at (oy * down,
// ox * down). A 1-D filter stands for its outer product with itself. The
// taps are folded in float32 (f[i] * f[j], then * gain) and, for bf16,
// rounded to bf16 as the plain version's `f.to(x.dtype)` does; products
// are summed in float32 and rounded once at the store. So against the
// plain version only the order of the float32 sum differs.
//
// What bounds it on an H100: bytes. A 4x4 filter costs 16 multiply-adds
// an output (4 at up = 2) against 4 bytes read and written in bf16, far
// below the card's operations-to-bytes ratio; the least time is the input
// read once plus the output written once over 3.35 TB/s. The design:
// - a block takes a tile of outputs of one plane and stages the input
//   tile and its halo in shared memory, as float32, read in aligned
//   16-byte chunks that each thread issues all together (one instruction
//   for 8 bf16 pixels: loads of single pixels left a bf16 tile paced by
//   instructions, at half the float32 tile's bytes a second); the border
//   pad is the zero fill of loads outside the input and a negative pad an
//   offset, so neither is a tensor;
// - the zero-upsample is polyphase: a leading shift of the taps (`sx`,
//   `sy`: zero taps put in front) makes the pad a whole number of input
//   pixels, and each output sums only the taps that land on input pixels
//   (4 of 16 for the 4x4 filter at up = 2); the downsample computes only
//   the kept outputs;
// - the main path's cases (a 4x4 filter at up 1 / down 1, up 2, down 2:
//   the FIR after a transposed convolution, the ToRGB skip and their
//   adjoints) take `upfirdn2d_depthwise_kernel`, whose up, down and taps
//   are compile-time: each thread computes a micro-tile of MY x MX outputs
//   from registers, reading each input row segment once from shared
//   memory as float4s and the taps once into registers, and stores MX
//   neighbouring outputs as one vector (bf16x2 pairs, float4) where the
//   row is aligned; where an axis ends a few outputs past whole tiles (the
//   adjoint's 2H + 1 after 2H), the last tile takes them, one a thread,
//   rather than a whole tile more with one column in it (81 tiles a 513^2
//   plane against 64 for 512^2);
// - any other up, down or taps (StyleGAN3's filters, the identity with a
//   pad) take the same algorithm with run-time parameters, one output a
//   thread (`upfirdn2d_depthwise_generic_kernel`); a 1-D filter in float32
//   is applied separably, rows then columns through shared memory
//   (`upfirdn2d_depthwise_sep_kernel`). In bf16 a 1-D filter keeps the
//   2-D form, since bf16(f[i] * f[j] * gain) is no product of bf16 taps.
// The backward is this kernel on the adjoint problem (ops/upfirdn2d.py).
// Every kernel's name holds `depthwise`, the convolution metric's mark.
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W) at the
// superresolution's block1 FIR, (16, 128, 513, 513) bf16: 1.08 ms against a
// 0.64 ms bound (ATen's depthwise convolution alone: 8.6 ms); its adjoint,
// on 512-wide rows, 1.39 ms. Where rows start 16-byte aligned, every
// chunk of a warp starts on a multiple of 8 floats in shared memory, so
// their stores meet in a quarter of the banks: such tiles take 30% longer
// (wide stores take back some of it; see load_tile). Float32 tiles
// reach 79-88% of the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 32;    // filter taps a side
constexpr int kMaxFactor = 8;   // largest up and down factor
constexpr int kThreads = 256;

// The filter as the caller holds it: none (one tap of 1), 1-D (standing for
// its outer product) or 2-D (h rows of w); float32 or bf16 entries.
struct Filter {
  const void* f;
  int bf16, ndim, w, h, flip;
  float gain;
};

// Shapes of one call. Output o reads the upsampled, padded input at
// o * down + k for taps k in [0, kw), shifted by the `s` zero taps in front
// of the filter; with the shift the pad is p0 whole input pixels, so tap
// k of output o lands on input pixel (o * down + k) / up - p0 when
// o * down + k is a multiple of up, and on an inserted zero otherwise.
struct Geometry {
  int planes, in_h, in_w, out_h, out_w;
  int upx, upy, downx, downy;
  int sx, sy, p0x, p0y;
  int kw, kh;  // taps a side after the shift, rounded up to a multiple of up
  int tiles_x, tiles_y;
  // The compile-time form: the last tile along x (y) takes the thin rest
  // of the row (column), at most one micro-tile, as the adjoint's 2H + 1
  // after 2H, rather than one more tile with little in it.
  int ext_x, ext_y;
};

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// Pixel j of a 16-byte chunk (j known at compile time once unrolled: bit
// operations on the chunk's words, so the chunk stays in registers).
__device__ __forceinline__ unsigned word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}
__device__ __forceinline__ float pixel_of(const uint4& v, int j, const float*) {
  return __uint_as_float(word_of(v, j));
}
__device__ __forceinline__ float pixel_of(const uint4& v, int j, const __nv_bfloat16*) {
  const unsigned w = word_of(v, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}
// Two floats rounded to a bf16 pair, as one 32-bit word (the first low).
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float entry(const Filter& f, int i) {
  return f.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(f.f)[i])
                : static_cast<const float*>(f.f)[i];
}

// Correlation weight (a, b) of the unshifted filter, in float32: the plain
// version's (outer(f, f) or f) * gain, flipped unless flip_filter.
__device__ float weight2d(const Filter& f, int a, int b) {
  if (f.ndim == 0) return f.gain;
  const int ra = f.flip ? a : f.h - 1 - a;
  const int rb = f.flip ? b : f.w - 1 - b;
  if (f.ndim == 1) return __fmul_rn(__fmul_rn(entry(f, ra), entry(f, rb)), f.gain);
  return __fmul_rn(entry(f, ra * f.w + rb), f.gain);
}

// The shifted kh x kw taps into shared memory, rounded to T.
template <typename T>
__device__ void load_taps(float* sw, const Filter& f, const Geometry& g) {
  for (int i = threadIdx.x; i < g.kh * g.kw; i += blockDim.x) {
    const int ky = i / g.kw, kx = i - ky * g.kw;
    const int a = ky - g.sy, b = kx - g.sx;
    float v = 0.0f;
    if (a >= 0 && a < f.h && b >= 0 && b < f.w)
      v = round_to(weight2d(f, a, b), (const T*)nullptr);
    sw[i] = v;
  }
}

// n floats to shared memory with the widest stores dst's alignment allows
// (16, 8 or, at a 4-byte aligned start, one float then 8-byte pairs): fewer
// store instructions than pixels, and in fewer bank conflicts.
template <int N>
__device__ __forceinline__ void store_floats(float* dst, const float (&p)[N]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if ((a & 15) == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(p[j], p[j + 1], p[j + 2], p[j + 3]);
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 2)
      *reinterpret_cast<float2*>(dst + j) = make_float2(p[j], p[j + 1]);
  } else {
    dst[0] = p[0];
#pragma unroll
    for (int j = 1; j + 1 < N; j += 2)
      *reinterpret_cast<float2*>(dst + j) = make_float2(p[j], p[j + 1]);
    dst[N - 1] = p[N - 1];
  }
}

// A tile of rows x cols input pixels from (iy0, ix0) of one plane into
// shared memory as float32 (row stride `stride`), zero outside the input.
// Each row is read in the 16-byte chunks that cover it, aligned to 16
// bytes wherever the row starts (bf16 rows of odd width start anywhere),
// consecutive threads on consecutive chunks; each thread issues kBatch
// chunk loads before it stores any. A chunk that holds a pixel of the row
// lies in the row's allocation (16-byte chunks never cross the 256-byte
// granules memory is allocated in); its pixels outside the row (the next
// or the last row's) are stored as the pad's zeros.
template <int kBatch, typename T>
__device__ __forceinline__ void load_tile(float* xs, int stride, const T* __restrict__ x,
                                          const Geometry& g, int iy0, int ix0, int rows,
                                          int cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = (cols - 1) / kVec + 2;  // chunks that cover a row at any alignment
  const int n = rows * per_row;
  const bool rows16 =
      (g.in_w * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int first = threadIdx.x; first < n; first += kBatch * blockDim.x) {
    uint4 v[kBatch];
    int r[kBatch], c0[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = first + k * blockDim.x;
      r[k] = i / per_row;
      const int iy = iy0 + r[k];
      const T* row = x + (ptrdiff_t)iy * g.in_w;
      const int lead = (int)((reinterpret_cast<uintptr_t>(row + ix0) & 15) / sizeof(T));
      c0[k] = (i - r[k] * per_row) * kVec - lead;  // tile column of the chunk's first pixel
      const int ix = ix0 + c0[k];
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && iy >= 0 && iy < g.in_h && ix < g.in_w && ix + kVec > 0)
        v[k] = *reinterpret_cast<const uint4*>(row + ix);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (first + k * (int)blockDim.x >= n) break;
      float p[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) p[j] = pixel_of(v[k], j, (const T*)nullptr);
      const int c = c0[k], ix = ix0 + c;
      float* dst = xs + r[k] * stride + c;
      // Where every row starts 16-byte aligned, the chunks of all rows share
      // one alignment in shared memory: wide stores with no divergence.
      if (rows16 && c >= 0 && c + kVec <= cols && ix >= 0 && ix + kVec <= g.in_w) {
        store_floats<kVec>(dst, p);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (c + j >= 0 && c + j < cols) dst[j] = ix + j >= 0 && ix + j < g.in_w ? p[j] : 0.0f;
      }
    }
  }
}

// Tile b's plane and output origin.
struct Tile {
  int plane, oy, ox;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, int th, int tw, int b) {
  const int tx = b % g.tiles_x;
  b /= g.tiles_x;
  const int ty = b % g.tiles_y;
  return Tile{b / g.tiles_y, ty * th, tx * tw};
}

// MX neighbouring outputs of one row, with the widest stores the address
// allows: one vector where all MX are in the row and it is aligned to
// their width; else pairs (bf16x2, float2) after a single where the first
// is not aligned to a pair; one by one at the row's end.
template <int MX>
__device__ __forceinline__ void store_row(float* p, const float (&v)[MX], int left) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (left >= MX && MX % 4 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int q = 0; q < MX / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                    v[4 * q + 3]);
  } else if (left >= MX && MX % 2 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int q = 0; q < MX / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < MX; ++i)
      if (i < left) p[i] = v[i];
  }
}

template <int MX>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[MX], int left) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (left < MX) {
#pragma unroll
    for (int i = 0; i < MX; ++i)
      if (i < left) p[i] = __float2bfloat16_rn(v[i]);
    return;
  }
  if constexpr (MX == 8) {
    if (a % 16 == 0) {
      *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                                bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
      return;
    }
  } else if constexpr (MX == 4) {
    if (a % 8 == 0) {
      *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
      return;
    }
  }
  // Pairs where the first output is 4-byte aligned, else a single, pairs
  // and a single (indices known at compile time: v stays in registers).
  if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i + 1 < MX; i += 2)
      *reinterpret_cast<unsigned*>(p + i) = bf16_pair(v[i], v[i + 1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
#pragma unroll
    for (int i = 1; i + 1 < MX; i += 2)
      *reinterpret_cast<unsigned*>(p + i) = bf16_pair(v[i], v[i + 1]);
    p[MX - 1] = __float2bfloat16_rn(v[MX - 1]);
  }
}

// Shapes of the compile-time form: BX x BY threads, each MX x MY outputs;
// K x K taps after the shift; the input of a tile extended by one
// micro-tile along y and x, IN_H_EXT x IN_W_EXT, in a row stride that lets
// every thread read its RX columns as float4s.
template <int UP, int DOWN, int K, int MX, int MY, int BX, int BY>
struct Tiled {
  static constexpr int TW = BX * MX, TH = BY * MY;
  static constexpr int IN_W_EXT = ((TW + MX - 1) * DOWN + K - 1) / UP + 1;
  static constexpr int IN_H_EXT = ((TH + MY - 1) * DOWN + K - 1) / UP + 1;
  static constexpr int RX = ((MX - 1) * DOWN + K - 1) / UP + 1;
  static constexpr int RY = ((MY - 1) * DOWN + K - 1) / UP + 1;
  static constexpr int RXV = (RX + 3) / 4 * 4;
  static constexpr int COL_STEP = MX * DOWN / UP;
  static constexpr int ROW_STEP = MY * DOWN / UP;
  static constexpr int STRIDE = ((BX - 1) * COL_STEP + RXV > IN_W_EXT
                                     ? (BX - 1) * COL_STEP + RXV : IN_W_EXT + 3) / 4 * 4;
  static_assert(COL_STEP * UP == MX * DOWN && COL_STEP % 4 == 0, "columns a thread apart");
  static_assert(ROW_STEP * UP == MY * DOWN, "rows a thread apart");
  static_assert(K % UP == 0 && STRIDE >= IN_W_EXT, "tile");
};

// First real tap of output o along one axis, and the input pixel under it
// relative to the tile's first input pixel (that of output o0).
__device__ __forceinline__ void phase(int o, int o0, int up, int down, int& k0, int& i0) {
  k0 = (up - (o * down) % up) % up;
  i0 = (o * down + k0) / up - (o0 * down) / up;
}

template <typename T, int UP, int DOWN, int K, int MX, int MY, int BX, int BY>
__global__ void __launch_bounds__(BX * BY)
upfirdn2d_depthwise_kernel(const T* __restrict__ x, T* __restrict__ y, Filter f, Geometry g) {
  using S = Tiled<UP, DOWN, K, MX, MY, BX, BY>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLoads = (S::IN_H_EXT * ((S::IN_W_EXT - 1) / kVec + 2) + BX * BY - 1) / (BX * BY);
  __shared__ __align__(16) float xs[S::IN_H_EXT * S::STRIDE];
  __shared__ float sw[K * K];
  const Tile t = tile_of(g, S::TH, S::TW, blockIdx.x);
  const bool wide = g.ext_x && t.ox == (g.tiles_x - 1) * S::TW;
  const bool tall = g.ext_y && t.oy == (g.tiles_y - 1) * S::TH;
  // Every tile loads the extended tile (one shape, known at compile time):
  // 6% more rows, as many 16-byte chunks a row.
  load_tile<kLoads>(xs, S::STRIDE, x + (size_t)t.plane * g.in_h * g.in_w, g,
                    t.oy * DOWN / UP - g.p0y, t.ox * DOWN / UP - g.p0x, S::IN_H_EXT,
                    S::IN_W_EXT);
  load_taps<T>(sw, f, g);
  __syncthreads();

  float w[K][K];
#pragma unroll
  for (int ky = 0; ky < K; ++ky)
#pragma unroll
    for (int kx = 0; kx < K; ++kx) w[ky][kx] = sw[ky * K + kx];
  const int tx = threadIdx.x % BX, ty = threadIdx.x / BX;
  const float* base = xs + ty * S::ROW_STEP * S::STRIDE + tx * S::COL_STEP;
  float acc[MY][MX];
#pragma unroll
  for (int j = 0; j < MY; ++j)
#pragma unroll
    for (int i = 0; i < MX; ++i) acc[j][i] = 0.0f;
  // Input row r of the thread's window feeds output row j through tap
  // UP * r - j * DOWN, and input column c output column i through
  // UP * c - i * DOWN: all known at compile time, so only real taps run.
#pragma unroll
  for (int r = 0; r < S::RY; ++r) {
    float v[S::RXV];
#pragma unroll
    for (int c = 0; c < S::RXV; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(base + r * S::STRIDE + c);
      v[c] = q.x;
      v[c + 1] = q.y;
      v[c + 2] = q.z;
      v[c + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < MY; ++j) {
      const int ky = UP * r - j * DOWN;
      if (ky < 0 || ky >= K) continue;
#pragma unroll
      for (int i = 0; i < MX; ++i)
#pragma unroll
        for (int c = 0; c < S::RX; ++c) {
          const int kx = UP * c - i * DOWN;
          if (kx >= 0 && kx < K) acc[j][i] = fmaf(v[c], w[ky][kx], acc[j][i]);
        }
    }
  }
  T* yp = y + (size_t)t.plane * g.out_h * g.out_w;
  const int ox = t.ox + tx * MX;
#pragma unroll
  for (int j = 0; j < MY; ++j) {
    const int oy = t.oy + ty * MY + j;
    if (oy < g.out_h && ox < g.out_w)
      store_row<MX>(yp + (size_t)oy * g.out_w + ox, acc[j], g.out_w - ox);
  }
  if (!wide && !tall) return;
  // The extension, one output a thread: MX columns right of the tile (and
  // of its extension below), then MY rows below it; taps from shared memory.
  const int right = wide ? (tall ? S::TH + MY : S::TH) * MX : 0;
  const int below = tall ? MY * S::TW : 0;
  for (int o = threadIdx.x; o < right + below; o += BX * BY) {
    const int ly = o < right ? o / MX : S::TH + (o - right) / S::TW;
    const int lx = o < right ? S::TW + o % MX : (o - right) % S::TW;
    const int oy = t.oy + ly, oxe = t.ox + lx;
    if (oy >= g.out_h || oxe >= g.out_w) continue;
    const int ky0 = (UP - ly * DOWN % UP) % UP, kx0 = (UP - lx * DOWN % UP) % UP;
    const float* xr = xs + (ly * DOWN + ky0) / UP * S::STRIDE + (lx * DOWN + kx0) / UP;
    float a = 0.0f;
#pragma unroll
    for (int r = 0; r < K / UP; ++r)
#pragma unroll
      for (int c = 0; c < K / UP; ++c)
        a = fmaf(xr[r * S::STRIDE + c], sw[(ky0 + r * UP) * K + kx0 + c * UP], a);
    store_one(yp + (size_t)oy * g.out_w + oxe, a);
  }
}

// The run-time form: any up, down and taps the wrapper takes, one output a
// thread, a GW x GH tile a block.
constexpr int GW = 32, GH = kThreads / GW;

__host__ __device__ __forceinline__ int generic_in_w(const Geometry& g, int tw) {
  return ((tw - 1) * g.downx + g.kw - 1) / g.upx + 2;
}
__host__ __device__ __forceinline__ int generic_in_h(const Geometry& g, int th) {
  return ((th - 1) * g.downy + g.kh - 1) / g.upy + 2;
}
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_depthwise_generic_kernel(const T* __restrict__ x, T* __restrict__ y, Filter f,
                                   Geometry g) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* xs = smem + round4(g.kh * g.kw);
  const int in_w = generic_in_w(g, GW), in_h = generic_in_h(g, GH);
  const Tile t = tile_of(g, GH, GW, blockIdx.x);
  load_taps<T>(sw, f, g);
  load_tile<4>(xs, in_w, x + (size_t)t.plane * g.in_h * g.in_w, g,
               t.oy * g.downy / g.upy - g.p0y, t.ox * g.downx / g.upx - g.p0x, in_h, in_w);
  __syncthreads();
  const int ox = t.ox + threadIdx.x % GW, oy = t.oy + threadIdx.x / GW;
  if (ox >= g.out_w || oy >= g.out_h) return;
  int kx0, ix0, ky0, iy0;
  phase(ox, t.ox, g.upx, g.downx, kx0, ix0);
  phase(oy, t.oy, g.upy, g.downy, ky0, iy0);
  float acc = 0.0f;
  for (int a = 0; a < g.kh / g.upy; ++a) {
    const float* xr = xs + (iy0 + a) * in_w + ix0;
    const float* wr = sw + (ky0 + a * g.upy) * g.kw + kx0;
    for (int b = 0; b < g.kw / g.upx; ++b) acc = fmaf(xr[b], wr[b * g.upx], acc);
  }
  store_one(y + (size_t)t.plane * g.out_h * g.out_w + (size_t)oy * g.out_w + ox, acc);
}

// A 1-D float32 filter, separably: each input row of the tile filtered
// along x into shared memory (only the tile's output columns), then each
// output along y; the gain goes with the column taps.
constexpr int SW = 32, SH = 16;

__global__ void __launch_bounds__(kThreads)
upfirdn2d_depthwise_sep_kernel(const float* __restrict__ x, float* __restrict__ y, Filter f,
                               Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int in_w = generic_in_w(g, SW), in_h = generic_in_h(g, SH);
  float* wx = smem;
  float* wy = wx + round4(g.kw);
  float* xs = wy + round4(g.kh);
  float* ts = xs + in_h * in_w;
  const Tile t = tile_of(g, SH, SW, blockIdx.x);
  for (int i = threadIdx.x; i < g.kw + g.kh; i += blockDim.x) {
    const bool along_x = i < g.kw;
    const int k = along_x ? i : i - g.kw;
    const int a = k - (along_x ? g.sx : g.sy);
    float v = 0.0f;
    if (a >= 0 && a < f.w) v = entry(f, f.flip ? a : f.w - 1 - a);
    if (along_x) wx[k] = v;
    else wy[k] = __fmul_rn(v, f.gain);
  }
  load_tile<4>(xs, in_w, x + (size_t)t.plane * g.in_h * g.in_w, g,
               t.oy * g.downy / g.upy - g.p0y, t.ox * g.downx / g.upx - g.p0x, in_h, in_w);
  __syncthreads();
  for (int i = threadIdx.x; i < in_h * SW; i += blockDim.x) {
    const int r = i / SW, ox = t.ox + i % SW;
    int k0, i0;
    phase(ox, t.ox, g.upx, g.downx, k0, i0);
    const float* xr = xs + r * in_w + i0;
    float acc = 0.0f;
    for (int b = 0; b < g.kw / g.upx; ++b) acc = fmaf(xr[b], wx[k0 + b * g.upx], acc);
    ts[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SH * SW; i += blockDim.x) {
    const int ox = t.ox + i % SW, oy = t.oy + i / SW;
    if (ox >= g.out_w || oy >= g.out_h) continue;
    int k0, i0;
    phase(oy, t.oy, g.upy, g.downy, k0, i0);
    const float* tc = ts + i0 * SW + i % SW;
    float acc = 0.0f;
    for (int a = 0; a < g.kh / g.upy; ++a) acc = fmaf(tc[a * SW], wy[k0 + a * g.upy], acc);
    y[(size_t)t.plane * g.out_h * g.out_w + (size_t)oy * g.out_w + ox] = acc;
  }
}

int pos_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// The shift of one axis: s zero taps in front make pad0 + s a multiple of
// up; the taps, s + n, are rounded up to a multiple of up.
void shift_axis(int pad0, int up, int n, int& s, int& p0, int& k) {
  s = pos_mod(-pad0, up);
  p0 = (pad0 + s) / up;
  k = (s + n + up - 1) / up * up;
}

bool tiles(Geometry& g, int tw, int th) {
  g.tiles_x = (g.out_w + tw - 1) / tw;
  g.tiles_y = (g.out_h + th - 1) / th;
  return (long long)g.planes * g.tiles_x * g.tiles_y < (1ll << 31);
}

// Where an axis of n outputs has a thin rest past whole tiles of t (at most
// one micro-tile of m), its last whole tile takes the rest.
void extend(int n, int t, int m, int& tiles, int& ext) {
  const int rest = n % t;
  ext = n > t && rest > 0 && rest <= m;
  if (ext) tiles = n / t;
}

template <typename T, int UP, int DOWN, int MX, int MY, int BX, int BY>
int launch_tiled(const T* x, T* y, const Filter& f, Geometry g, cudaStream_t s) {
  using S = Tiled<UP, DOWN, 4, MX, MY, BX, BY>;
  if (!tiles(g, S::TW, S::TH)) return (int)cudaErrorInvalidConfiguration;
  extend(g.out_w, S::TW, MX, g.tiles_x, g.ext_x);
  extend(g.out_h, S::TH, MY, g.tiles_y, g.ext_y);
  upfirdn2d_depthwise_kernel<T, UP, DOWN, 4, MX, MY, BX, BY>
      <<<g.planes * g.tiles_x * g.tiles_y, BX * BY, 0, s>>>(x, y, f, g);
  return (int)cudaGetLastError();
}

template <typename K>
int launch_dynamic(K kernel, size_t smem, unsigned blocks, cudaStream_t s, void** args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err = cudaLaunchKernel((const void*)kernel, dim3(blocks), dim3(kThreads),
                                           args, smem, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, T* y, Filter f, Geometry g, bool separable, cudaStream_t s) {
  if (g.planes == 0 || g.out_h <= 0 || g.out_w <= 0) return 0;
  const bool square = g.upx == g.upy && g.downx == g.downy && g.kw == 4 && g.kh == 4;
  const int up = g.upx, down = g.downx;
  if (square && up == 1 && down == 1) return launch_tiled<T, 1, 1, 4, 4, 16, 16>(x, y, f, g, s);
  if (square && up == 2 && down == 1) return launch_tiled<T, 2, 1, 8, 4, 16, 16>(x, y, f, g, s);
  if (square && up == 1 && down == 2) return launch_tiled<T, 1, 2, 4, 2, 16, 16>(x, y, f, g, s);
  void* args[] = {(void*)&x, (void*)&y, (void*)&f, (void*)&g};
  if (separable) {
    if (!tiles(g, SW, SH)) return (int)cudaErrorInvalidConfiguration;
    const int in_w = generic_in_w(g, SW), in_h = generic_in_h(g, SH);
    const size_t smem = sizeof(float) * (round4(g.kw) + round4(g.kh) + in_h * in_w + in_h * SW);
    return launch_dynamic(upfirdn2d_depthwise_sep_kernel, smem,
                          g.planes * g.tiles_x * g.tiles_y, s, args);
  }
  if (!tiles(g, GW, GH)) return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      sizeof(float) * (round4(g.kh * g.kw) + generic_in_h(g, GH) * generic_in_w(g, GW));
  return launch_dynamic(upfirdn2d_depthwise_generic_kernel<T>, smem,
                        g.planes * g.tiles_x * g.tiles_y, s, args);
}

int run(const void* x, void* y, bool bf16, const void* f, int f_bf16, int f_ndim, int fw,
        int fh, int planes, int in_h, int in_w, int out_h, int out_w, int upx, int upy,
        int downx, int downy, int padx0, int pady0, int flip, float gain, void* stream) {
  if (fw < 1 || fh < 1 || fw > kMaxTaps || fh > kMaxTaps || upx < 1 || upy < 1 ||
      downx < 1 || downy < 1 || upx > kMaxFactor || upy > kMaxFactor ||
      downx > kMaxFactor || downy > kMaxFactor || (f == nullptr) != (f_ndim == 0))
    return (int)cudaErrorInvalidValue;
  Filter fl{f, f_bf16, f_ndim, fw, fh, flip, gain};
  Geometry g{planes, in_h, in_w, out_h, out_w, upx, upy, downx, downy};
  shift_axis(padx0, upx, fw, g.sx, g.p0x, g.kw);
  shift_axis(pady0, upy, fh, g.sy, g.p0y, g.kh);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), fl, g,
                  false, s);
  return launch(static_cast<const float*>(x), static_cast<float*>(y), fl, g, f_ndim == 1, s);
}

}  // namespace

// x: (planes, in_h, in_w) contiguous, y: (planes, out_h, out_w); f: null
// (f_ndim 0), fw taps (f_ndim 1) or fh x fw (f_ndim 2), float32 or bf16
// (f_bf16). padx0 / pady0 are the leading pads (negative: crops); the
// trailing ones follow from the output's size. Returns cudaGetLastError()
// after the launch.
extern "C" int spi_upfirdn2d(const float* x, float* y, const void* f, int f_bf16, int f_ndim,
                             int fw, int fh, int planes, int in_h, int in_w, int out_h,
                             int out_w, int upx, int upy, int downx, int downy, int padx0,
                             int pady0, int flip, float gain, void* stream) {
  return run(x, y, false, f, f_bf16, f_ndim, fw, fh, planes, in_h, in_w, out_h, out_w, upx, upy,
             downx, downy, padx0, pady0, flip, gain, stream);
}

extern "C" int spi_upfirdn2d_bf16(const void* x, void* y, const void* f, int f_bf16,
                                  int f_ndim, int fw, int fh, int planes, int in_h, int in_w,
                                  int out_h, int out_w, int upx, int upy, int downx, int downy,
                                  int padx0, int pady0, int flip, float gain, void* stream) {
  return run(x, y, true, f, f_bf16, f_ndim, fw, fh, planes, in_h, in_w, out_h, out_w, upx, upy,
             downx, downy, padx0, pady0, flip, gain, stream);
}
