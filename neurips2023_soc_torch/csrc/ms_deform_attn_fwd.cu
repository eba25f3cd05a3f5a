// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel neurips2023_soc_tpu/ops/pallas_msda.py:ms_deform_attn_pallas
// (body _make_kernel). Same function, written from its semantics, not its TPU layout:
//
//   out[b,q,m,d] = sum_l sum_p attn[b,q,m,l,p]
//                  * bilinear_zero_pad(value_l[b,:,m,d], loc_x*W_l - 0.5, loc_y*H_l - 0.5)
//
// Every corner outside its level gets zero weight (grid_sample, zeros padding,
// align_corners=False); a size-1 level needs no special case because its
// out-of-range corners fail the same bounds check. The sum runs in f32 and the
// output is written once in the value type.
//
// What bounds it on the H100: device-memory bytes (value, loc, attn read once,
// out written once) plus the locality of the corner gathers; the f32 FMAs are
// far below the card's rate. Design: one thread per output element (b, q, m, d);
// neighbouring threads take neighbouring d, so each corner read of one head is
// one coalesced segment (64 bytes in bf16 at D = 32) and the loc/attn reads of
// a warp are broadcasts. No shared-memory staging, TMA or split over levels yet.
//
// C interface (bound with ctypes): msda_fwd(...) launches on the given stream
// and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 16

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename A>
__global__ void msda_fwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const A* __restrict__ attn,
                                T* __restrict__ out,
                                int S, int M, int D, int Lq, int L, int P,
                                Levels lv, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int d = (int)(i % D);
  int64_t r = i / D;
  const int m = (int)(r % M);
  r /= M;
  const int q = (int)(r % Lq);
  const int b = (int)(r / Lq);

  const int64_t bqm = ((int64_t)b * Lq + q) * M + m;
  const float* lp = loc + bqm * L * P * 2;
  const A* ap = attn + bqm * L * P;
  const int64_t row = (int64_t)M * D;  // elements between two tokens
  const T* vb = value + (int64_t)b * S * row + (int64_t)m * D + d;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const T* vl = vb + (int64_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float x = lp[2 * k] * W - 0.5f;
      const float y = lp[2 * k + 1] * H - 0.5f;
      const float a = to_f32(ap[k]);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float fx = x - x0f;
      const float fy = y - y0f;
      // bounds are tested in float so that far-out or non-finite locations
      // never reach an int conversion
      const bool x0_in = x0f >= 0.f && x0f <= (float)(W - 1);
      const bool x1_in = x0f >= -1.f && x0f <= (float)(W - 2);
      const bool y0_in = y0f >= 0.f && y0f <= (float)(H - 1);
      const bool y1_in = y0f >= -1.f && y0f <= (float)(H - 2);
      if (!((x0_in || x1_in) && (y0_in || y1_in))) continue;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float wx0 = 1.f - fx, wx1 = fx;
      const float wy0 = 1.f - fy, wy1 = fy;
      if (y0_in) {
        const T* vrow = vl + (int64_t)y0 * W * row;
        if (x0_in) acc += to_f32(vrow[(int64_t)x0 * row]) * (wy0 * wx0 * a);
        if (x1_in) acc += to_f32(vrow[(int64_t)(x0 + 1) * row]) * (wy0 * wx1 * a);
      }
      if (y1_in) {
        const T* vrow = vl + (int64_t)(y0 + 1) * W * row;
        if (x0_in) acc += to_f32(vrow[(int64_t)x0 * row]) * (wy1 * wx0 * a);
        if (x1_in) acc += to_f32(vrow[(int64_t)(x0 + 1) * row]) * (wy1 * wx1 * a);
      }
    }
  }
  out[i] = from_f32<T>(acc);
}

template <typename T, typename A>
static void launch(const void* value, const void* loc, const void* attn, void* out,
                   int S, int M, int D, int Lq, int L, int P, const Levels& lv,
                   int64_t total, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  msda_fwd_kernel<T, A><<<(unsigned int)blocks, threads, 0, stream>>>(
      (const T*)value, (const float*)loc, (const A*)attn, (T*)out,
      S, M, D, Lq, L, P, lv, total);
}

extern "C" int msda_fwd(const void* value, const void* loc, const void* attn, void* out,
                        int B, int S, int M, int D, int Lq, int L, int P,
                        const int* shapes,  // host array of L (H, W) pairs
                        int value_bf16, int attn_bf16, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * Lq * M * D;
  if (total == 0) return 0;
  if ((total + 255) / 256 > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16) {
    if (attn_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(value, loc, attn, out, S, M, D, Lq, L, P, lv, total, s);
    else
      launch<__nv_bfloat16, float>(value, loc, attn, out, S, M, D, Lq, L, P, lv, total, s);
  } else {
    if (attn_bf16)
      launch<float, __nv_bfloat16>(value, loc, attn, out, S, M, D, Lq, L, P, lv, total, s);
    else
      launch<float, float>(value, loc, attn, out, S, M, D, Lq, L, P, lv, total, s);
  }
  return (int)cudaGetLastError();
}
