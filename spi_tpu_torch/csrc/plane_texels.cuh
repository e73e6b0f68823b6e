// Texel math of the 3-plane bilinear lookup, shared by its forward
// (plane_sample.cu) and its gradient (plane_splat.cu), so that the two
// can never disagree on a corner or a weight.
//
// A world point is scaled by 2 / box_warp and projected onto the planes'
// axes as `project_onto_planes` does (plane 0 reads (x, y), plane 1
// (x, z), plane 2 (z, x)), then mapped to texels with align_corners=False:
// f = ((u + 1) * size - 1) / 2. The corners are (x0, y0), (x0 + 1, y0),
// (x0, y0 + 1), (x0 + 1, y0 + 1), x0 = floor(fx), weighted (1 - tx)(1 - ty),
// tx (1 - ty), (1 - tx) ty, tx ty with tx = fx - x0. That is the order of
// operations of `texel_coords` and `bilinear_corners`
// (spi_tpu_torch/ops/grid_sample.py), written with _rn intrinsics so that
// nvcc contracts nothing into an FMA: each weight rounds as PyTorch's does.

#pragma once

namespace plane_texels {

// The world axis that plane `plane` reads as u, and as v.
__device__ __forceinline__ int axis_u(int plane) { return plane == 2 ? 2 : 0; }
__device__ __forceinline__ int axis_v(int plane) { return plane == 0 ? 1 : (plane == 1 ? 2 : 0); }

struct Corners {
  int x0, y0;   // the first corner's texel; x0 in [-2, w], y0 in [-2, h]
  float wt[4];  // corner q = (x0 + (q & 1), y0 + (q >> 1)); weights before the range test
};

// The corners of the point whose plane coordinates are (pu, pv), before
// scaling. The floors are clamped to [-2, size] before they become
// integers: a point that far outside has both corners of that axis out
// of range, as it would unclamped, and no conversion overflows.
__device__ __forceinline__ Corners corners(float pu, float pv, float scale, int h, int w) {
  const float u = __fmul_rn(pu, scale);
  const float v = __fmul_rn(pv, scale);
  const float fx = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.0f), (float)w), 1.0f), 0.5f);
  const float fy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(v, 1.0f), (float)h), 1.0f), 0.5f);
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  const float tx = __fsub_rn(fx, x0f);
  const float ty = __fsub_rn(fy, y0f);
  Corners k;
  k.x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w);
  k.y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h);
  k.wt[0] = __fmul_rn(__fsub_rn(1.0f, tx), __fsub_rn(1.0f, ty));
  k.wt[1] = __fmul_rn(tx, __fsub_rn(1.0f, ty));
  k.wt[2] = __fmul_rn(__fsub_rn(1.0f, tx), ty);
  k.wt[3] = __fmul_rn(tx, ty);
  return k;
}

// Whether corner q lies on the plane.
__device__ __forceinline__ bool in_plane(const Corners& k, int q, int h, int w) {
  const int xi = k.x0 + (q & 1);
  const int yi = k.y0 + (q >> 1);
  return xi >= 0 && xi < w && yi >= 0 && yi < h;
}

// Corner q's texel, for a corner on the plane.
__device__ __forceinline__ int texel(const Corners& k, int q, int w) {
  return (k.y0 + (q >> 1)) * w + k.x0 + (q & 1);
}

// Corner q's texel, clamped onto the plane (where it is out of range, the
// nearest texel: its weight is then zero).
__device__ __forceinline__ int clamped_texel(const Corners& k, int q, int h, int w) {
  const int xi = min(max(k.x0 + (q & 1), 0), w - 1);
  const int yi = min(max(k.y0 + (q >> 1), 0), h - 1);
  return yi * w + xi;
}

}  // namespace plane_texels
