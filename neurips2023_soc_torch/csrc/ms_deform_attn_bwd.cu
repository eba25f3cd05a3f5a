// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel neurips2023_soc_tpu/ops/pallas_msda.py:ms_deform_attn_pallas_bwd
// (body _make_bwd_kernel). Same function, written from its semantics
// (neurips2023_soc_tpu/ops/ms_deform_attn.py:55-113), not its TPU layout: no patch
// tables, packed bf16, tile-major permutation or one-hot MXU scatter. For the
// cotangent g (B, Lq, M*D) of out = msda(value, loc, attn):
//
//   x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5; corner c of the 2x2 bilinear patch has
//   weight w_c (zero, with zero slope, outside the level; size-1 levels included)
//   dot_c         = sum_d value_l[b, c, m, d] * g[b, q, m, d]
//   d_value[c]   += attn * w_c * g            (scatter-add over every sample)
//   d_attn        = sum_c w_c * dot_c
//   d_loc         = attn * (W_l, H_l) * sum_c (dw_c/dx, dw_c/dy) * dot_c
//
// What bounds it on the H100: device-memory bytes (value, loc, attn, g read once;
// d_value, d_loc, d_attn written once) plus the locality of the corner gathers and
// scatters; about 4*D f32 flops per in-range corner are far below the card's rate.
// Design: one warp per (b, q, m), lanes over the D channels (a loop for D > 32), so a
// corner row of one head is one coalesced read (64 bytes in bf16 at D = 32) and one
// run of 32 consecutive f32 atomics. dot_c and the three per-sample sums are reduced
// with __shfl_xor_sync; lane 0 writes d_attn and d_loc. d_value is accumulated with
// f32 atomicAdd into a buffer the wrapper zeroes and casts once to the value type, so
// the order of its sums, and its last bits, vary from run to run.
//
// C interface (bound with ctypes): msda_bwd(...) launches on the given stream and
// returns cudaGetLastError() as an int.

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One in-range corner: scatter attn*w*g into d_value and return this lane's part
// of dot = <v_corner, g>.
template <typename T>
__device__ __forceinline__ float corner(const T* __restrict__ vrow, float* __restrict__ dvrow,
                                        const T* __restrict__ g, float aw, int D, int lane) {
  float dot = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float gd = to_f32(g[d]);
    dot += to_f32(vrow[d]) * gd;
    atomicAdd(dvrow + d, aw * gd);
  }
  return dot;
}

template <typename T, typename A>
__global__ void msda_bwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const A* __restrict__ attn,
                                const T* __restrict__ grad_out,
                                float* __restrict__ d_value,
                                float* __restrict__ d_loc,
                                A* __restrict__ d_attn,
                                int S, int M, int D, int Lq, int L, int P,
                                Levels lv, int64_t warps) {
  const int lane = threadIdx.x & 31;
  const int64_t bqm = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (bqm >= warps) return;  // whole warps leave together
  const int m = (int)(bqm % M);
  const int64_t bq = bqm / M;
  const int b = (int)(bq / Lq);

  const float* lp = loc + bqm * L * P * 2;
  const A* ap = attn + bqm * L * P;
  float* dlp = d_loc + bqm * L * P * 2;
  A* dap = d_attn + bqm * L * P;
  const int64_t row = (int64_t)M * D;  // elements between two tokens
  const T* vb = value + (int64_t)b * S * row + (int64_t)m * D;
  float* dvb = d_value + (int64_t)b * S * row + (int64_t)m * D;
  const T* g = grad_out + bq * row + (int64_t)m * D;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const T* vl = vb + (int64_t)lv.start[l] * row;
    float* dvl = dvb + (int64_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      // the forward's exact floor and bounds decisions (ms_deform_attn_fwd.cu)
      const float x = lp[2 * k] * W - 0.5f;
      const float y = lp[2 * k + 1] * H - 0.5f;
      const float a = to_f32(ap[k]);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float fx = x - x0f;
      const float fy = y - y0f;
      const bool x0_in = x0f >= 0.f && x0f <= (float)(W - 1);
      const bool x1_in = x0f >= -1.f && x0f <= (float)(W - 2);
      const bool y0_in = y0f >= 0.f && y0f <= (float)(H - 1);
      const bool y1_in = y0f >= -1.f && y0f <= (float)(H - 2);
      // per-lane parts of sum_c w_c*dot_c, sum_c dw_c/dx*dot_c, sum_c dw_c/dy*dot_c
      float s_w = 0.f, s_x = 0.f, s_y = 0.f;
      if ((x0_in || x1_in) && (y0_in || y1_in)) {  // uniform across the warp
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const float wx0 = 1.f - fx, wx1 = fx;
        const float wy0 = 1.f - fy, wy1 = fy;
        if (y0_in) {
          const int64_t r = ((int64_t)y0 * W + x0) * row;
          if (x0_in) {  // w = wy0*wx0; dw/dx = -wy0, dw/dy = -wx0
            const float dot = corner(vl + r, dvl + r, g, wy0 * wx0 * a, D, lane);
            s_w += wy0 * wx0 * dot; s_x -= wy0 * dot; s_y -= wx0 * dot;
          }
          if (x1_in) {  // w = wy0*wx1; dw/dx = wy0, dw/dy = -wx1
            const float dot = corner(vl + r + row, dvl + r + row, g, wy0 * wx1 * a, D, lane);
            s_w += wy0 * wx1 * dot; s_x += wy0 * dot; s_y -= wx1 * dot;
          }
        }
        if (y1_in) {
          const int64_t r = ((int64_t)(y0 + 1) * W + x0) * row;
          if (x0_in) {  // w = wy1*wx0; dw/dx = -wy1, dw/dy = wx0
            const float dot = corner(vl + r, dvl + r, g, wy1 * wx0 * a, D, lane);
            s_w += wy1 * wx0 * dot; s_x -= wy1 * dot; s_y += wx0 * dot;
          }
          if (x1_in) {  // w = wy1*wx1; dw/dx = wy1, dw/dy = wx1
            const float dot = corner(vl + r + row, dvl + r + row, g, wy1 * wx1 * a, D, lane);
            s_w += wy1 * wx1 * dot; s_x += wy1 * dot; s_y += wx1 * dot;
          }
        }
      }
      s_w = warp_sum(s_w);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == 0) {
        dap[k] = from_f32<A>(s_w);
        dlp[2 * k] = a * (float)W * s_x;
        dlp[2 * k + 1] = a * (float)H * s_y;
      }
    }
  }
}

template <typename T, typename A>
static void launch(const void* value, const void* loc, const void* attn, const void* g,
                   void* d_value, void* d_loc, void* d_attn,
                   int S, int M, int D, int Lq, int L, int P, const Levels& lv,
                   int64_t warps, cudaStream_t stream) {
  const int threads = 256;  // 8 warps
  const int64_t blocks = (warps * 32 + threads - 1) / threads;
  msda_bwd_kernel<T, A><<<(unsigned int)blocks, threads, 0, stream>>>(
      (const T*)value, (const float*)loc, (const A*)attn, (const T*)g,
      (float*)d_value, (float*)d_loc, (A*)d_attn, S, M, D, Lq, L, P, lv, warps);
}

// d_value: float32 (B, S, M, D), zeroed by the caller; d_loc: float32 like loc;
// d_attn: like attn; grad_out: (B, Lq, M*D) in the value type.
extern "C" int msda_bwd(const void* value, const void* loc, const void* attn,
                        const void* grad_out, void* d_value, void* d_loc, void* d_attn,
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
  const int64_t warps = (int64_t)B * Lq * M;
  if (warps == 0) return 0;
  if ((warps * 32 + 255) / 256 > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16) {
    if (attn_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(value, loc, attn, grad_out, d_value, d_loc, d_attn,
                                           S, M, D, Lq, L, P, lv, warps, s);
    else
      launch<__nv_bfloat16, float>(value, loc, attn, grad_out, d_value, d_loc, d_attn,
                                   S, M, D, Lq, L, P, lv, warps, s);
  } else {
    if (attn_bf16)
      launch<float, __nv_bfloat16>(value, loc, attn, grad_out, d_value, d_loc, d_attn,
                                   S, M, D, Lq, L, P, lv, warps, s);
    else
      launch<float, float>(value, loc, attn, grad_out, d_value, d_loc, d_attn,
                           S, M, D, Lq, L, P, lv, warps, s);
  }
  return (int)cudaGetLastError();
}
