// filtered_lrelu for Hopper, float32, NCHW: StyleGAN3's alias-free
// nonlinearity (bias, up-FIR, leaky ReLU with gain and clamp, down-FIR) in
// one kernel forward and one backward, the upsampled map kept in shared
// memory.
//
// Replaces no Pallas kernel: spi_tpu composes the op from XLA ops
// (spi_tpu/ops/filtered_lrelu.py). Before this kernel the port composed it
// on the card from two bias_act and two upfirdn2d launches each way (still
// the route of what this kernel does not take, ops/filtered_lrelu.py): each
// call wrote the upsampled map (up to 81 x 2098^2 floats an image) and read
// it back four times, and bias_act's backward kept the upsampled
// pre-activations (10 GB a StyleGAN3-T pass at batch 2).
//
// Semantics, as the plain versions (filtered_lrelu_fwd_plain / _bwd_plain):
//   u = upfirdn2d(x + b, fu, up, pad (px0, .., py0, ..), gain up^2)   up_h x up_w
//   v = clamp(lrelu(u, slope) * gain, -clamp, clamp)                  (clamp < 0: none)
//   y = upfirdn2d(v, fd, down)
// with 1-D filters applied separably (up * fu along each axis), true
// convolutions unless flip. Where asked, the forward writes 2 bits of each
// u to s (planes, up_h, sw = ceil(up_w / 4)) uint8, value 4g + j of a row in
// bits 2j ("not u >= 0": lrelu' is the slope) and 2j + 1 ("not |v| <
// clamp": clamped, the gradient is 0), csrc/bias_act.cu's tests. The
// backward reads them and dy alone:
//   dv = dy through fd's adjoint; du = dv * (slope or 1) * gain, 0 where
//   clamped; dx = du through fu's adjoint; db[c] = the sum of dx over c.
//
// What bounds it on an H100: float32 multiply-adds on the CUDA cores (the
// largest StyleGAN3-T call, 81 x 534^2 -> 2098^2 -> 1044^2 at batch 2,
// counts 25.7 GFLOP against 0.89 GB). The design:
// - a forward block takes a T x T tile of outputs of one (n, c) plane,
//   stages its input and halo in shared memory with the bias added, and
//   runs four 1-D passes through shared memory: the up-FIR along x then y
//   (polyphase: each output sums only its 6 real taps; the computed region
//   starts on the up-FIR's phase 0, so the taps of each output are known at
//   compile time), the activation on the second pass's results, the
//   down-FIR along x then y at the kept outputs only. The upsampled map
//   never reaches device memory;
// - in every pass a thread computes kStrip neighbouring outputs along the
//   filtered axis from registers (each input read once from shared memory,
//   the taps in registers), neighbouring threads on neighbouring lines: a
//   pass along y reads neighbouring columns, one along x rows an odd stride
//   apart, so a warp's loads meet no bank twice;
// - the signs of an upsampled value are written by the one tile that owns
//   it (its rows and columns from the tile's first down-FIR input to the
//   next tile's; the last tile's to the map's end), from codes kept in
//   shared memory, so every byte is written once and no memset runs; the
//   halos are recomputed, not written;
// - the backward is the same structure on the adjoint problem, a block a
//   tile of dx: dy's tile zero-upsampled and filtered along x then y
//   (fd's adjoint), masked by the signs, filtered along x then y at every
//   up-th value (fu's adjoint); each block writes its partial sum of dx
//   and `filtered_lrelu_bias_grad_kernel` adds a channel's in a fixed
//   order, so db is the same in every run. Its region's sign bytes are
//   staged in shared memory beside dy's tile, their loads all in flight at
//   once (read inside the pass, one a value, they took the backward at L10
//   from 3.9 to 6.6 ms); its tile is 24 a side at up 4, 32 otherwise;
// - the forms: up 1, 2, 4 and down 1, 2 at compile time (6 * factor taps a
//   filter, none at 1). Float32 throughout; only the order of the sums
//   differs from the plain versions, and the separable sums are those of
//   csrc/upfirdn2d.cu's separable form: y and dx equal the composition's
//   bitwise.
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W) at L10, batch 2:
// forward 2.10 ms (2.63 writing the signs) against a 0.383 ms bound, the
// composition's kernels 21.1 ms; backward 3.85 ms against their 21.8.
// Larger forward tiles (48, 64) lost more to occupancy than they saved in
// halo. Every kernel's name holds `filtered_lrelu` and none of the
// convolution metric's words (benchmark/metrics/fir_ms_per_step.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFilterTaps = 6;  // real taps of a filter a phase: 6 * factor taps
constexpr int kStrip = 8;       // outputs a thread computes along a pass's axis
constexpr int kOutTile = 32;    // forward: outputs a tile side

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int taps_of(int factor) {
  return factor == 1 ? 1 : kFilterTaps * factor;
}
__host__ __device__ __forceinline__ int pos_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

struct Params {
  const float* x;   // forward input (planes, in_h, in_w)
  const float* b;   // bias (channels), or null
  const float* dy;  // backward: output gradient (planes, out_h, out_w)
  const float* fu;  // up filter (taps_of(up)), null at up 1
  const float* fd;  // down filter (taps_of(down)), null at down 1
  float* y;         // forward output (planes, out_h, out_w)
  float* dx;        // backward: input gradient (planes, in_h, in_w)
  float* part;      // backward: each block's sum of its dx, or null
  uint8_t* s;       // signs (planes, up_h, sw): forward writes (null: none), backward reads
  int planes, channels, in_h, in_w, up_h, up_w, out_h, out_w, sw;
  int px0, py0, flip;
  float gain, slope, clamp;  // clamp < 0: none
  int tiles_x, tiles_y;
};

// Tap k of a pass's correlation of n taps: f[n - 1 - k] (a true
// convolution) where `reverse`, else f[k]; times `scale`. No filter: one
// tap of `scale`.
__device__ __forceinline__ float tap(const float* f, int n, int k, bool reverse, float scale) {
  return f == nullptr ? scale : f[reverse ? n - 1 - k : k] * scale;
}

// One 1-D FIR pass over a region in shared memory, with the zero-upsample
// and the downsample folded in: output o of a line is
//   sum over k < K of w[k] * in[(o * DOWN + k) / UP + off]  where UP divides o * DOWN + k
// (UP > 1 only with DOWN 1 and off 0; the caller starts the region on phase
// 0). LINES lines (rows if ALONG_X, else columns) of STRIPS * M outputs;
// each thread takes strips of M outputs of a line, neighbouring threads
// neighbouring lines, and hands every output to emit(row, column, value).
// The tap of each (input, output) pair is known at compile time.
template <int UP, int DOWN, int K, int M, bool ALONG_X, int LINES, int STRIPS, typename Emit>
__device__ __forceinline__ void fir_pass(const float* __restrict__ in, int stride, int off,
                                         const float* taps, Emit emit) {
  constexpr int NIN = ((M - 1) * DOWN + K - 1) / UP + 1;  // inputs a strip reads
  static_assert(M % UP == 0, "a strip starts on phase 0");
  float w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = taps[k];
  const int step = ALONG_X ? 1 : stride;
  for (int i = threadIdx.x; i < LINES * STRIPS; i += kThreads) {
    const int line = i % LINES, o0 = i / LINES * M;
    const float* p = in + (ALONG_X ? line * stride : line) + (o0 * DOWN / UP + off) * step;
    float acc[M];
#pragma unroll
    for (int j = 0; j < M; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int t = 0; t < NIN; ++t) {
      const float v = p[t * step];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int k = t * UP - j * DOWN;
        if (k >= 0 && k < K) acc[j] = fmaf(v, w[k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (ALONG_X) emit(line, o0 + j, acc[j]);
      else emit(o0 + j, line, acc[j]);
    }
  }
}

// The tile's plane and position among the plane's tiles.
struct Tile {
  int plane, ty, tx;
};

__device__ __forceinline__ Tile tile_of(const Params& p) {
  int b = blockIdx.x;
  const int tx = b % p.tiles_x;
  b /= p.tiles_x;
  return Tile{b / p.tiles_y, b % p.tiles_y, tx};
}

// A tile of rows x cols of one plane from (r0, c0) into shared memory (row
// stride `stride`), plus `add`, zero outside the plane.
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* __restrict__ src,
                                          int h, int w, int r0, int c0, int rows, int cols,
                                          float add) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    const int sy = r0 + r, sx = c0 + c;
    dst[r * stride + c] =
        sy >= 0 && sy < h && sx >= 0 && sx < w ? __ldg(src + (size_t)sy * w + sx) + add : 0.0f;
  }
}

// The block's sum of v into `out` (a fixed order: the same in every run).
__device__ __forceinline__ void block_sum(float v, float* red, float* out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
    *out = s;
  }
}

// The forward's shapes at up U, down D: a T x T tile of outputs reads NQ x
// NQ upsampled values (its down-FIR inputs, up to U - 1 more in front to
// start on the up-FIR's phase 0, D - 1 more behind for the last tile's
// signs), which read NI x NI input pixels. Shared memory, in floats: R0
// the input tile, then the codes of the signs (a byte each); R1 the up-FIR
// along x, then the down-FIR along x; R2 the activated upsampled tile.
template <int U, int D>
struct Fwd {
  static constexpr int KU = taps_of(U), KD = taps_of(D);
  static constexpr int T = kOutTile;
  static constexpr int NQ = round_up(U - 1 + T * D + KD - 1, kStrip);
  static constexpr int NI = (NQ - 1 + KU - 1) / U + 1;
  static constexpr int SX = NI | 1, SH = NQ | 1, SA = NQ | 1, SD = T | 1;
  static constexpr int R0 = cmax(NI * SX, NQ * NQ / 4);
  static constexpr int R1 = cmax(NI * SH, NQ * SD);
  static constexpr int R2 = NQ * SA;
  static constexpr size_t kSmem = sizeof(float) * (R0 + R1 + R2 + KU + KD);
  static_assert(T * D % 4 == 0 && T % kStrip == 0 && NQ % 4 == 0, "tile");
};

template <int U, int D>
__global__ void __launch_bounds__(kThreads) filtered_lrelu_fwd_kernel(Params p) {
  using G = Fwd<U, D>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* hs = xs + G::R0;
  float* as = hs + G::R1;
  float* w = as + G::R2;  // KU up taps, then KD down taps
  uint8_t* codes = reinterpret_cast<uint8_t*>(xs);
  const Tile t = tile_of(p);
  const int ox0 = t.tx * G::T, oy0 = t.ty * G::T;
  // The region starts at the tile's first down-FIR input, moved back onto
  // the up-FIR's phase 0 (q - pad0 a multiple of U), ex / ey values early.
  const int ex = pos_mod(ox0 * D - p.px0, U), ey = pos_mod(oy0 * D - p.py0, U);
  const int qx0 = ox0 * D - ex, qy0 = oy0 * D - ey;
  for (int i = threadIdx.x; i < G::KU + G::KD; i += kThreads)
    w[i] = i < G::KU ? tap(p.fu, G::KU, i, !p.flip, (float)U)
                     : tap(p.fd, G::KD, i - G::KU, !p.flip, 1.0f);
  load_tile(xs, G::SX, p.x + (size_t)t.plane * p.in_h * p.in_w, p.in_h, p.in_w,
            (qy0 - p.py0) / U, (qx0 - p.px0) / U, G::NI, G::NI,
            p.b ? __ldg(p.b + t.plane % p.channels) : 0.0f);
  __syncthreads();
  fir_pass<U, 1, G::KU, kStrip, true, G::NI, G::NQ / kStrip>(
      xs, G::SX, 0, w, [&](int r, int c, float v) { hs[r * G::SH + c] = v; });
  __syncthreads();
  const bool signs = p.s != nullptr;
  const float gain = p.gain, slope = p.slope, clamp = p.clamp;
  fir_pass<U, 1, G::KU, kStrip, false, G::NQ, G::NQ / kStrip>(
      hs, G::SH, 0, w, [&](int r, int c, float u) {
        float v = (u >= 0.0f ? u : u * slope) * gain;
        unsigned code = u >= 0.0f ? 0u : 1u;
        if (clamp >= 0.0f) {
          if (!(v > -clamp && v < clamp)) code |= 2u;
          v = fminf(fmaxf(v, -clamp), clamp);
        }
        as[r * G::SA + c] = v;
        if (signs) codes[r * G::NQ + c] = (uint8_t)code;
      });
  __syncthreads();
  if (signs) {
    // The owned rows and byte columns: from the tile's first down-FIR
    // input to the next tile's, the last tile's to the map's end.
    const int g0 = ox0 * D / 4, r0 = oy0 * D;
    const int g1 = t.tx == p.tiles_x - 1 ? p.sw : (ox0 + G::T) * D / 4;
    const int r1 = t.ty == p.tiles_y - 1 ? p.up_h : (oy0 + G::T) * D;
    const int ng = g1 - g0;
    uint8_t* sp = p.s + (size_t)t.plane * p.up_h * p.sw;
    for (int i = threadIdx.x; i < (r1 - r0) * ng; i += kThreads) {
      const int qy = r0 + i / ng, g = g0 + i % ng;
      const int at = (qy - qy0) * G::NQ + 4 * g - qx0;
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < p.up_w) bits |= (unsigned)codes[at + j] << (2 * j);
      sp[(size_t)qy * p.sw + g] = (uint8_t)bits;
    }
  }
  fir_pass<1, D, G::KD, kStrip, true, G::NQ, G::T / kStrip>(
      as, G::SA, ex, w + G::KU, [&](int r, int c, float v) { hs[r * G::SD + c] = v; });
  __syncthreads();
  float* yp = p.y + (size_t)t.plane * p.out_h * p.out_w;
  fir_pass<1, D, G::KD, 4, false, G::T, G::T / 4>(
      hs, G::SD, ey, w + G::KU, [&](int r, int c, float v) {
        const int oy = oy0 + r, ox = ox0 + c;
        if (oy < p.out_h && ox < p.out_w) yp[(size_t)oy * p.out_w + ox] = v;
      });
}

// The backward's shapes at up U, down D: a T x T tile of dx reads NQ x NQ
// values of du (KU - 1 before its first value's position, up to D - 1 more
// in front to start on fd's adjoint's phase 0), which read NO x NO of dy
// and NQ rows of NG sign bytes. Shared memory, in floats: R0 dy's tile,
// then fu's adjoint along x; R1 fd's adjoint along x; R2 du; R3 the sign
// bytes. M4: outputs a strip of the last pass.
template <int U, int D>
struct Bwd {
  static constexpr int KU = taps_of(U), KD = taps_of(D);
  static constexpr int T = U == 4 ? 24 : 32;
  static constexpr int M4 = T == 32 ? 4 : 2;
  static constexpr int NQ = round_up(D - 1 + (T - 1) * U + KU, kStrip);
  static constexpr int NO = (NQ - 1 + KD - 1) / D + 1;
  static constexpr int SY = NO | 1, SG = NQ | 1, SU = NQ | 1, SE = T | 1;
  static constexpr int R0 = cmax(NO * SY, NQ * SE);
  static constexpr int R1 = NO * SG;
  static constexpr int R2 = NQ * SU;
  static constexpr int NG = NQ / 4 + 1;
  static constexpr int R3 = (NQ * NG + 3) / 4;
  static constexpr size_t kSmem = sizeof(float) * (R0 + R1 + R2 + R3 + KU + KD + kThreads / 32);
  static_assert(T % kStrip == 0 && T % M4 == 0 && NQ % 4 == 0, "tile");
};

template <int U, int D>
__global__ void __launch_bounds__(kThreads) filtered_lrelu_bwd_kernel(Params p) {
  using G = Bwd<U, D>;
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;
  float* gs = ys + G::R0;
  float* us = gs + G::R1;
  uint8_t* ss = reinterpret_cast<uint8_t*>(us + G::R2);
  float* w = us + G::R2 + G::R3;  // KD taps of fd's adjoint, then KU of fu's
  float* red = w + G::KU + G::KD;
  const Tile t = tile_of(p);
  const int ix0 = t.tx * G::T, iy0 = t.ty * G::T;
  // dx[i] = sum over k < KU of wu'[k] du[i * U + pad0 - (KU - 1) + k]: the
  // region starts there, moved back onto fd's adjoint's phase 0.
  const int bx = ix0 * U + p.px0 - (G::KU - 1), by = iy0 * U + p.py0 - (G::KU - 1);
  const int ex = pos_mod(bx - (G::KD - 1), D), ey = pos_mod(by - (G::KD - 1), D);
  const int qx0 = bx - ex, qy0 = by - ey;
  for (int i = threadIdx.x; i < G::KU + G::KD; i += kThreads)
    w[i] = i < G::KD ? tap(p.fd, G::KD, i, p.flip, 1.0f)
                     : tap(p.fu, G::KU, i - G::KD, p.flip, (float)U);
  load_tile(ys, G::SY, p.dy + (size_t)t.plane * p.out_h * p.out_w, p.out_h, p.out_w,
            (qy0 - (G::KD - 1)) / D, (qx0 - (G::KD - 1)) / D, G::NO, G::NO, 0.0f);
  // The region's sign bytes (byte columns from qx0's, floor(qx / 4): the
  // shifts are arithmetic); outside the map every value reads clamped, so
  // its du is 0 (its dv is 0 there too).
  const uint8_t* sp = p.s + (size_t)t.plane * p.up_h * p.sw;
  const int g0 = qx0 >> 2;
  for (int i = threadIdx.x; i < G::NQ * G::NG; i += kThreads) {
    const int r = i / G::NG, g = g0 + i - r * G::NG, qy = qy0 + r;
    ss[i] = qy >= 0 && qy < p.up_h && g >= 0 && g < p.sw ? __ldg(sp + (size_t)qy * p.sw + g)
                                                          : (uint8_t)0xaa;
  }
  __syncthreads();
  fir_pass<D, 1, G::KD, kStrip, true, G::NO, G::NQ / kStrip>(
      ys, G::SY, 0, w, [&](int r, int c, float v) { gs[r * G::SG + c] = v; });
  __syncthreads();
  const float gain = p.gain, slope = p.slope;
  fir_pass<D, 1, G::KD, kStrip, false, G::NQ, G::NQ / kStrip>(
      gs, G::SG, 0, w, [&](int r, int c, float v) {
        const int qx = qx0 + c;
        const unsigned code = (ss[r * G::NG + (qx >> 2) - g0] >> (2 * (qx & 3))) & 3u;
        us[r * G::SU + c] = code & 2u ? 0.0f : (code & 1u ? v * slope : v) * gain;
      });
  __syncthreads();
  fir_pass<1, U, G::KU, kStrip, true, G::NQ, G::T / kStrip>(
      us, G::SU, ex, w + G::KD, [&](int r, int c, float v) { ys[r * G::SE + c] = v; });
  __syncthreads();
  float* dxp = p.dx + (size_t)t.plane * p.in_h * p.in_w;
  float sum = 0.0f;
  fir_pass<1, U, G::KU, G::M4, false, G::T, G::T / G::M4>(
      ys, G::SE, ey, w + G::KD, [&](int r, int c, float v) {
        const int iy = iy0 + r, ix = ix0 + c;
        if (iy < p.in_h && ix < p.in_w) {
          dxp[(size_t)iy * p.in_w + ix] = v;
          sum += v;
        }
      });
  if (p.part) block_sum(sum, red, p.part + blockIdx.x);
}

// db[c]: the blocks' partial sums of channel c over the n images, in a
// fixed order. One block a channel.
__global__ void __launch_bounds__(kThreads)
filtered_lrelu_bias_grad_kernel(const float* __restrict__ part, float* __restrict__ db, int n,
                                int channels, int tiles) {
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x;
  float sum = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float* pp = part + ((size_t)k * channels + c) * tiles;
    for (int i = threadIdx.x; i < tiles; i += kThreads) sum += pp[i];
  }
  block_sum(sum, red, db + c);
}

template <typename K>
int launch(K kernel, size_t smem, long long blocks, cudaStream_t s, const Params& p) {
  if (blocks == 0) return 0;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int U, int D>
int launch_fwd(Params p, cudaStream_t s) {
  using G = Fwd<U, D>;
  p.tiles_x = (p.out_w + G::T - 1) / G::T;
  p.tiles_y = (p.out_h + G::T - 1) / G::T;
  return launch(filtered_lrelu_fwd_kernel<U, D>, G::kSmem,
                (long long)p.planes * p.tiles_x * p.tiles_y, s, p);
}

template <int U, int D>
int launch_bwd(Params p, cudaStream_t s) {
  using G = Bwd<U, D>;
  p.tiles_x = (p.in_w + G::T - 1) / G::T;
  p.tiles_y = (p.in_h + G::T - 1) / G::T;
  return launch(filtered_lrelu_bwd_kernel<U, D>, G::kSmem,
                (long long)p.planes * p.tiles_x * p.tiles_y, s, p);
}

// The forms: (up, down) in {1, 2, 4} x {1, 2}, the filters as taps_of.
bool valid(const Params& p, int up, int down) {
  return (up == 1 || up == 2 || up == 4) && (down == 1 || down == 2) &&
         (p.fu == nullptr) == (up == 1) && (p.fd == nullptr) == (down == 1) && p.planes >= 0 &&
         p.up_h >= taps_of(down) && p.up_w >= taps_of(down) &&
         p.out_h == (p.up_h - taps_of(down)) / down + 1 &&
         p.out_w == (p.up_w - taps_of(down)) / down + 1;
}

int tiles_of(int up, int in_h, int in_w) {
  const int t = up == 4 ? Bwd<4, 1>::T : Bwd<1, 1>::T;
  return ((in_h + t - 1) / t) * ((in_w + t - 1) / t);
}

}  // namespace

// x, y: (planes, in_h, in_w), (planes, out_h, out_w) contiguous; b: null or
// (channels), plane k's channel k % channels; fu / fd: null or taps_of(up)
// / taps_of(down) taps; s: null (no signs) or (planes, up_h, ceil(up_w / 4))
// uint8. up_h / up_w: the upsampled, up-filtered map; px0 / py0 the leading
// pads (negative: crops), the trailing ones follow from up_h / up_w.
// clamp < 0: none. Returns cudaGetLastError() after the launch.
extern "C" int spi_filtered_lrelu_fwd(const float* x, const float* b, const float* fu,
                                      const float* fd, float* y, uint8_t* s, int planes,
                                      int channels, int in_h, int in_w, int up_h, int up_w,
                                      int out_h, int out_w, int up, int down, int px0, int py0,
                                      int flip, float gain, float slope, float clamp,
                                      void* stream) {
  // Params' fields in order: the pointers x, b, dy, fu, fd, y, dx, part,
  // s; the shapes; the pads and flip; gain, slope, clamp; the tiles.
  Params p{x,     b,     nullptr, fu,    fd,   y,     nullptr,        nullptr, s,
           planes, channels, in_h, in_w, up_h, up_w, out_h, out_w, (up_w + 3) / 4,
           px0,   py0,   flip,    gain,  slope, clamp, 0,             0};
  if (!valid(p, up, down) || channels < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (up * 10 + down) {
    case 11: return launch_fwd<1, 1>(p, st);
    case 12: return launch_fwd<1, 2>(p, st);
    case 21: return launch_fwd<2, 1>(p, st);
    case 22: return launch_fwd<2, 2>(p, st);
    case 41: return launch_fwd<4, 1>(p, st);
    case 42: return launch_fwd<4, 2>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dy: (planes, out_h, out_w); s: the forward's signs; dx: (planes, in_h,
// in_w); part: null, or planes x spi_filtered_lrelu_bwd_tiles(...) floats,
// each block's sum of its dx (for spi_filtered_lrelu_bias_grad). The rest
// as the forward's.
extern "C" int spi_filtered_lrelu_bwd(const float* dy, const uint8_t* s, const float* fu,
                                      const float* fd, float* dx, float* part, int planes,
                                      int in_h, int in_w, int up_h, int up_w, int out_h,
                                      int out_w, int up, int down, int px0, int py0, int flip,
                                      float gain, float slope, void* stream) {
  Params p{nullptr, nullptr, dy,   fu,   fd,   nullptr, dx,    part, const_cast<uint8_t*>(s),
           planes,  1,       in_h, in_w, up_h, up_w,    out_h, out_w, (up_w + 3) / 4,
           px0,     py0,     flip, gain, slope, -1.0f,  0,     0};
  if (!valid(p, up, down) || s == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (up * 10 + down) {
    case 11: return launch_bwd<1, 1>(p, st);
    case 12: return launch_bwd<1, 2>(p, st);
    case 21: return launch_bwd<2, 1>(p, st);
    case 22: return launch_bwd<2, 2>(p, st);
    case 41: return launch_bwd<4, 1>(p, st);
    case 42: return launch_bwd<4, 2>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward's tiles a plane (the partial sums a plane), or -1.
extern "C" int spi_filtered_lrelu_bwd_tiles(int up, int down, int in_h, int in_w) {
  if (!(up == 1 || up == 2 || up == 4) || !(down == 1 || down == 2) || in_h < 0 || in_w < 0)
    return -1;
  return tiles_of(up, in_h, in_w);
}

// db (channels) from part (n, channels, tiles): the bias gradient.
extern "C" int spi_filtered_lrelu_bias_grad(const float* part, float* db, int n, int channels,
                                            int tiles, void* stream) {
  if (n < 1 || channels < 1 || tiles < 0) return (int)cudaErrorInvalidValue;
  filtered_lrelu_bias_grad_kernel<<<channels, kThreads, 0, (cudaStream_t)stream>>>(
      part, db, n, channels, tiles);
  return (int)cudaGetLastError();
}
