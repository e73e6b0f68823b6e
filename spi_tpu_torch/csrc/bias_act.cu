// Fused bias + activation + gain + clamp, forward and backward, for Hopper,
// in float32 and bfloat16.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// spi_tpu/ops/bias_act_pallas.py (launched by `_call_2d`), which in turn
// stand for EG3D's bias_act.cu. Semantics of `_bias_act_ref` / the Pallas
// rule:
//   forward   y  = clamp(act(x + b[ch]) * gain, -clamp, clamp)
//   backward  dx = g * act'(x + b[ch]) * gain, and 0 where the forward
//             clamped (|act(x + b) * gain| >= clamp); act' is recomputed
//             from x + b rather than saved, and at x + b = 0 is that of
//             spi_tpu's impl='xla' path (see act_grad). db is a sum of dx
//             outside the kernel.
// Rounding, as the Pallas kernels: x + b is added in the input's type
// (for bf16: the f32 sum of two bf16 values rounded once to bf16, which is
// the correctly rounded bf16 sum), then widened to f32; the activation, its
// derivative, the gain and the clamp run in f32; the result is rounded once
// to the input's type at the store. For f32 every step is f32, as before.
// The channel of flat element i is (i / trail) % C, so both NCHW tensors
// (trail = H*W) and the FC / decoder calls (trail = 1) are served; the TPU
// rule that C be a multiple of 8 does not apply.
//
// What bounds it on an H100: bytes. The forward reads x and writes y, the
// backward reads g and x and writes dx: 8 and 12 B an element in f32, 4
// and 6 in bf16, against ~2 flops of transcendental work per element, far
// below the card's 67 TFLOP/s f32 / 3.35 TB/s ratio. The f32 design is a
// plain grid-stride elementwise pass: consecutive threads touch
// consecutive addresses, so every load and store is a coalesced 128 B
// line; the bias vector (at most a few KB) stays in L1. The bf16 form
// moves 16 bytes a thread a load (8 elements, one `uint4`) where every
// pointer is 16-byte aligned, and walks the 8 elements' channels
// incrementally (one divide per 8 elements); an unaligned call takes the
// scalar pass. Index math is 32-bit (the wrapper rejects tensors of 2^31
// elements or more) so the channel computation is a cheap unsigned divide,
// not a 64-bit one.
// Measured by chip_smoke.py at (1, 128, 256, 256) on an NVIDIA H100 80GB
// HBM3 with a 700 W power limit, f32: forward 0.036 ms against a 0.020 ms
// bound, backward 0.051 ms against 0.030 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act {
  kLinear = 0, kRelu = 1, kLrelu = 2, kTanh = 3, kSigmoid = 4,
  kElu = 5, kSelu = 6, kSoftplus = 7, kSwish = 8
};

constexpr float kSeluLambda = 1.0507009873554805f;
constexpr float kSeluAlpha = 1.6732632423543772f;

__device__ __forceinline__ float act_fwd(int act, float x, float alpha) {
  switch (act) {
    case kRelu: return fmaxf(x, 0.0f);
    case kLrelu: return x >= 0.0f ? x : x * alpha;
    case kTanh: return tanhf(x);
    case kSigmoid: return 1.0f / (1.0f + expf(-x));
    case kElu: return x >= 0.0f ? x : expm1f(x);
    case kSelu: return kSeluLambda * (x >= 0.0f ? x : kSeluAlpha * expm1f(x));
    case kSoftplus: return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    case kSwish: return x / (1.0f + expf(-x));
    default: return x;
  }
}

// d act / d x from the input x and the (pre-gain) activation y. At x = 0
// each takes the branch that jax.grad of spi_tpu's default impl='xla' takes
// (relu'(0) = 0, lrelu'(0) = 1, elu'(0) = 1, selu'(0) = lambda alpha), not
// the Pallas kernel's x >= 0 branch for relu and selu.
__device__ __forceinline__ float act_grad(int act, float x, float y, float alpha) {
  switch (act) {
    case kRelu: return x > 0.0f ? 1.0f : 0.0f;
    case kLrelu: return x >= 0.0f ? 1.0f : alpha;
    case kTanh: return 1.0f - y * y;
    case kSigmoid: return y * (1.0f - y);
    case kElu: return x >= 0.0f ? 1.0f : y + 1.0f;
    case kSelu: return x > 0.0f ? kSeluLambda : y + kSeluLambda * kSeluAlpha;
    case kSoftplus: return 1.0f / (1.0f + expf(-x));
    case kSwish: {
      float s = 1.0f / (1.0f + expf(-x));
      return s * (1.0f + x * (1.0f - s));
    }
    default: return 1.0f;
  }
}

// Loads, stores and the rounding of x + b, by element type.
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float add_in(float x, float b, const float*) { return x + b; }
__device__ __forceinline__ float add_in(float x, float b, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x + b));
}

struct Params {
  unsigned n, c, trail;
  int act;
  float alpha, gain, clamp;  // clamp < 0: no clamp
};

template <typename T>
__device__ __forceinline__ float fwd_one(const Params& p, float x, float b) {
  float v = act_fwd(p.act, add_in(x, b, (const T*)nullptr), p.alpha) * p.gain;
  if (p.clamp >= 0.0f) v = fminf(fmaxf(v, -p.clamp), p.clamp);
  return v;
}

template <typename T>
__device__ __forceinline__ float bwd_one(const Params& p, float g, float x, float b) {
  float xb = add_in(x, b, (const T*)nullptr);
  float ya = act_fwd(p.act, xb, p.alpha);
  float d = g * act_grad(p.act, xb, ya, p.alpha) * p.gain;
  if (p.clamp >= 0.0f) {
    float yv = ya * p.gain;
    if (!(yv > -p.clamp && yv < p.clamp)) d = 0.0f;
  }
  return d;
}

template <typename T>
__global__ void bias_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                    T* __restrict__ y, Params p) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < p.n;
       i += gridDim.x * blockDim.x) {
    store(&y[i], fwd_one<T>(p, load(&x[i]), load(&b[(i / p.trail) % p.c])));
  }
}

template <typename T>
__global__ void bias_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                                    const T* __restrict__ b, T* __restrict__ dx, Params p) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < p.n;
       i += gridDim.x * blockDim.x) {
    store(&dx[i], bwd_one<T>(p, load(&g[i]), load(&x[i]), load(&b[(i / p.trail) % p.c])));
  }
}

// bf16, 8 elements (16 bytes) a thread a step. Element i0 + k's channel is
// walked from i0's: the position within the trail advances by one, and the
// channel by one (mod C) each time it wraps. The last n % 8 elements are
// taken by the grid's first thread.
constexpr unsigned kVec = 8;

__device__ __forceinline__ void channel_of(const Params& p, unsigned i, unsigned& ch,
                                           unsigned& r) {
  unsigned q = i / p.trail;
  r = i - q * p.trail;
  ch = q % p.c;
}

__device__ __forceinline__ void next_channel(const Params& p, unsigned& ch, unsigned& r) {
  if (++r == p.trail) {
    r = 0;
    if (++ch == p.c) ch = 0;
  }
}

__global__ void bias_act_fwd_bf16x8_kernel(const uint4* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ b,
                                           uint4* __restrict__ y, Params p) {
  const unsigned n8 = p.n / kVec;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (unsigned v = tid; v < n8; v += gridDim.x * blockDim.x) {
    uint4 xv = x[v], out;
    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&out);
    unsigned ch, r;
    channel_of(p, v * kVec, ch, r);
#pragma unroll
    for (unsigned k = 0; k < kVec; ++k) {
      oe[k] = __float2bfloat16_rn(
          fwd_one<__nv_bfloat16>(p, __bfloat162float(xe[k]), __bfloat162float(b[ch])));
      next_channel(p, ch, r);
    }
    y[v] = out;
  }
  if (tid == 0) {
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(y);
    for (unsigned i = n8 * kVec; i < p.n; ++i)
      store(&ys[i], fwd_one<__nv_bfloat16>(p, load(&xs[i]), load(&b[(i / p.trail) % p.c])));
  }
}

__global__ void bias_act_bwd_bf16x8_kernel(const uint4* __restrict__ g,
                                           const uint4* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ b,
                                           uint4* __restrict__ dx, Params p) {
  const unsigned n8 = p.n / kVec;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (unsigned v = tid; v < n8; v += gridDim.x * blockDim.x) {
    uint4 gv = g[v], xv = x[v], out;
    const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&out);
    unsigned ch, r;
    channel_of(p, v * kVec, ch, r);
#pragma unroll
    for (unsigned k = 0; k < kVec; ++k) {
      oe[k] = __float2bfloat16_rn(bwd_one<__nv_bfloat16>(
          p, __bfloat162float(ge[k]), __bfloat162float(xe[k]), __bfloat162float(b[ch])));
      next_channel(p, ch, r);
    }
    dx[v] = out;
  }
  if (tid == 0) {
    const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(g);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(dx);
    for (unsigned i = n8 * kVec; i < p.n; ++i)
      store(&ds[i], bwd_one<__nv_bfloat16>(p, load(&gs[i]), load(&xs[i]),
                                           load(&b[(i / p.trail) % p.c])));
  }
}

constexpr int kThreads = 256;

unsigned grid_for(unsigned n) {
  // Enough blocks to cover n once, capped at a few waves of the 132 SMs;
  // the grid-stride loop covers the rest.
  unsigned blocks = (n + kThreads - 1) / kThreads;
  const unsigned cap = 132u * 32u;
  return blocks < cap ? (blocks > 0 ? blocks : 1) : cap;
}

bool aligned16(const void* a, const void* b, const void* c = nullptr) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
}

Params params(int n, int c, int trail, int act, float alpha, float gain, float clamp) {
  return Params{(unsigned)n, (unsigned)c, (unsigned)trail, act, alpha, gain, clamp};
}

}  // namespace

// clamp < 0 disables clamping. Returns cudaGetLastError() after the launch.
extern "C" int spi_bias_act_fwd(const float* x, const float* b, float* y,
                                int n, int c, int trail, int act, float alpha,
                                float gain, float clamp, void* stream) {
  bias_act_fwd_kernel<float><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, b, y, params(n, c, trail, act, alpha, gain, clamp));
  return (int)cudaGetLastError();
}

extern "C" int spi_bias_act_bwd(const float* g, const float* x, const float* b,
                                float* dx, int n, int c, int trail, int act,
                                float alpha, float gain, float clamp,
                                void* stream) {
  bias_act_bwd_kernel<float><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      g, x, b, dx, params(n, c, trail, act, alpha, gain, clamp));
  return (int)cudaGetLastError();
}

extern "C" int spi_bias_act_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* b,
                                     __nv_bfloat16* y, int n, int c, int trail, int act,
                                     float alpha, float gain, float clamp, void* stream) {
  Params p = params(n, c, trail, act, alpha, gain, clamp);
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(x, y)) {
    bias_act_fwd_bf16x8_kernel<<<grid_for((n + kVec - 1) / kVec), kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(x), b, reinterpret_cast<uint4*>(y), p);
  } else {
    bias_act_fwd_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, s>>>(x, b, y, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int spi_bias_act_bwd_bf16(const __nv_bfloat16* g, const __nv_bfloat16* x,
                                     const __nv_bfloat16* b, __nv_bfloat16* dx, int n, int c,
                                     int trail, int act, float alpha, float gain, float clamp,
                                     void* stream) {
  Params p = params(n, c, trail, act, alpha, gain, clamp);
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(g, x, dx)) {
    bias_act_bwd_bf16x8_kernel<<<grid_for((n + kVec - 1) / kVec), kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(g), reinterpret_cast<const uint4*>(x), b,
        reinterpret_cast<uint4*>(dx), p);
  } else {
    bias_act_bwd_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, s>>>(g, x, b, dx, p);
  }
  return (int)cudaGetLastError();
}
