// What the MSDA forward (ms_deform_attn_fwd.cu) and backward (ms_deform_attn_bwd.cu)
// kernels share: the level table, dtype conversions, 8-channel vector loads and stores,
// and the geometry of one bilinear sample.
//
// The vector routes give each thread an 8-channel slice of one (b, q, m): D / 8
// threads (a "group", aligned inside a warp) serve one (b, q, m). A corner of one
// head is then one 16-byte load per thread in bf16 (two in f32). Each sample's
// geometry (corner tokens, weights, bounds) is computed once, by one thread of the
// group, and staged in shared memory for the others.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 16

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// Fills `lv` from a host array of L (H, W) pairs; false unless 1 <= L <= 16 and the
// levels hold S tokens.
static inline bool fill_levels(Levels& lv, const int* shapes, int L, int S) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return false;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  return start == S;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive channels, 16-byte aligned: one read-only 16-byte load in bf16, two in f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);           // low half first
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // .x low
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One bilinear sample at normalized (lx, ly) on an H x W level, with the forward's
// floor and bounds decisions: pixel x = lx*W - 0.5, corner (y0+dy, x0+dx) for dy, dx in
// {0, 1}, in corner order 00, 01, 10, 11 (row-major). A corner outside the level has
// its bit clear in `inside` and a token clamped into the level, so that its address
// is always valid. Bounds are tested in float, so a far-out or non-finite location
// never reaches an int conversion out of range.
struct Sample {
  int tok[4];     // token of each corner within the level (clamped), row-major y * W + x
  float fx, fy;   // x - x0, y - y0
  unsigned inside;  // bit c set when corner c lies in the level
};

__device__ __forceinline__ Sample bilinear_sample(float lx, float ly, int H, int W) {
  Sample s;
  // rounded as the plain version rounds (a product, then a difference): a contracted
  // fma could floor a location that lies on a pixel centre into the other cell
  const float x = __fsub_rn(__fmul_rn(lx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, (float)H), 0.5f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  s.fx = x - x0f;
  s.fy = y - y0f;
  const bool x0_in = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool x1_in = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool y0_in = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool y1_in = y0f >= -1.f && y0f <= (float)(H - 2);
  s.inside = (unsigned)(y0_in && x0_in) | ((unsigned)(y0_in && x1_in) << 1)
             | ((unsigned)(y1_in && x0_in) << 2) | ((unsigned)(y1_in && x1_in) << 3);
  // fmaxf(NaN, 0) is 0, so a NaN location clamps to the level's first token
  const int xa = (int)fminf(fmaxf(x0f, 0.f), (float)(W - 1));
  const int xb = (int)fminf(fmaxf(x0f + 1.f, 0.f), (float)(W - 1));
  const int ya = (int)fminf(fmaxf(y0f, 0.f), (float)(H - 1));
  const int yb = (int)fminf(fmaxf(y0f + 1.f, 0.f), (float)(H - 1));
  s.tok[0] = ya * W + xa;
  s.tok[1] = ya * W + xb;
  s.tok[2] = yb * W + xa;
  s.tok[3] = yb * W + xb;
  return s;
}

// The bilinear weights of the four corners, zero outside the level; the products in
// the forward's order (wy * wx).
__device__ __forceinline__ void corner_weights(const Sample& s, float (&w)[4]) {
  const float wx0 = 1.f - s.fx, wx1 = s.fx, wy0 = 1.f - s.fy, wy1 = s.fy;
  w[0] = (s.inside & 1u) ? wy0 * wx0 : 0.f;
  w[1] = (s.inside & 2u) ? wy0 * wx1 : 0.f;
  w[2] = (s.inside & 4u) ? wy1 * wx0 : 0.f;
  w[3] = (s.inside & 8u) ? wy1 * wx1 : 0.f;
}
