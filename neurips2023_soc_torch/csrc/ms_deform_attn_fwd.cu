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
// out-of-range corners fail the same bounds check. The sum runs in f32, over the
// samples in (level, point, corner) order, and the output is written once in the
// value type.
//
// What bounds it on the H100: not the device-memory bytes (value, loc, attn read once
// and out written once take 0.053 ms at the encoder shape) nor the f32 FMAs, but the
// corner gathers (39.5 M corners of 64 bytes at the encoder shape, served from L1/L2
// because one frame's value slice stays in L2) and their latency.
//
// Two routes, chosen by the wrapper from the shape alone (ops/ms_deform_attn.py:
// fwd_route):
//   vec    (D a power-of-two multiple of 8 up to 256, staging <= 48 KB): each thread
//          owns 8 channels of one (b, q, m), so D / 8 threads (a group) serve it and a
//          corner is one 16-byte load per thread in bf16. For each level, the group's
//          threads split its P samples, compute each sample's corner tokens and
//          attn-scaled weights once and stage them in shared memory; then every thread
//          runs the level's P x 4 corners without a branch (a corner outside its level
//          has weight 0 and a clamped, valid address), so all of a level's loads can be
//          in flight. P = 4 is compiled with the loop unrolled; other P loop at run time.
//          The output slice is one 16-byte store in bf16.
//   scalar (any other D): one thread per output element (b, q, m, d), the first port of
//          this kernel.
//
// C interface (bound with ctypes): msda_fwd(...) launches on the given stream and
// returns cudaGetLastError() as an int.

#include "msda_common.cuh"

#define MSDA_VEC_THREADS 256

// ------------------------------------------------------------------ vec route
template <typename T, typename A, int kP>
__global__ void __launch_bounds__(MSDA_VEC_THREADS, 2)
msda_fwd_vec_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const A* __restrict__ attn, T* __restrict__ out,
                    int S, int M, int D, int Lq, int L, int P_rt, Levels lv,
                    int64_t groups) {
  // per group and sample: {int4 corner tokens, float4 attn-scaled weights}
  extern __shared__ int4 stage[];
  const int P = kP ? kP : P_rt;
  const int T8 = D >> 3;  // threads per group
  const int t = threadIdx.x & (T8 - 1);
  const int grp = threadIdx.x / T8;
  const int64_t bqm_raw = (int64_t)blockIdx.x * (blockDim.x / T8) + grp;
  const bool active = bqm_raw < groups;
  const int64_t bqm = active ? bqm_raw : groups - 1;  // idle groups still meet __syncwarp
  const int m = (int)(bqm % M);
  const int b = (int)(bqm / ((int64_t)Lq * M));
  const int64_t row = (int64_t)M * D;  // elements between two tokens
  const T* vb = value + (int64_t)b * S * row + (int64_t)m * D + 8 * t;
  const float* lp = loc + bqm * L * P * 2;
  const A* ap = attn + bqm * L * P;
  int4* rec = stage + (size_t)grp * P * 2;

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l], st = lv.start[l];
    for (int p = t; p < P; p += T8) {  // each sample's geometry, once per group
      const int k = l * P + p;
      const float2 xy = *reinterpret_cast<const float2*>(lp + 2 * k);
      const float a = to_f32(ap[k]);
      const Sample s = bilinear_sample(xy.x, xy.y, H, W);
      float w[4];
      corner_weights(s, w);
      rec[2 * p] = make_int4(st + s.tok[0], st + s.tok[1], st + s.tok[2], st + s.tok[3]);
      rec[2 * p + 1] = make_int4(__float_as_int(w[0] * a), __float_as_int(w[1] * a),
                                 __float_as_int(w[2] * a), __float_as_int(w[3] * a));
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < (kP ? kP : P); ++p) {
      const int4 tk = rec[2 * p];
      const int4 wi = rec[2 * p + 1];
      const int tok[4] = {tk.x, tk.y, tk.z, tk.w};
      const float aw[4] = {__int_as_float(wi.x), __int_as_float(wi.y),
                           __int_as_float(wi.z), __int_as_float(wi.w)};
      float v[4][8];
#pragma unroll
      for (int c = 0; c < 4; ++c) load8(vb + (int64_t)tok[c] * row, v[c]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += v[c][j] * aw[c];
      }
    }
    __syncwarp();  // the staging is rewritten for the next level
  }
  if (active) store8(out + bqm * D + 8 * t, acc);
}

// ---------------------------------------------------------------- scalar route
template <typename T, typename A>
__global__ void msda_fwd_scalar_kernel(const T* __restrict__ value,
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
      const Sample s = bilinear_sample(lp[2 * k], lp[2 * k + 1], H, W);
      if (!s.inside) continue;
      const float a = to_f32(ap[k]);
      float w[4];
      corner_weights(s, w);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (s.inside & (1u << c)) acc += to_f32(vl[(int64_t)s.tok[c] * row]) * (w[c] * a);
    }
  }
  out[i] = from_f32<T>(acc);
}

// ------------------------------------------------------------------- launches
enum { ROUTE_VEC = 0, ROUTE_SCALAR = 1 };

static bool vec_shape_ok(int D, int P) {
  const int T8 = D / 8;
  return D % 8 == 0 && T8 >= 1 && T8 <= 32 && (T8 & (T8 - 1)) == 0
         && (size_t)(MSDA_VEC_THREADS / T8) * P * 32 <= 48 * 1024;
}

template <typename T, typename A>
static int launch(int route, const void* value, const void* loc, const void* attn, void* out,
                  int B, int S, int M, int D, int Lq, int L, int P, const Levels& lv,
                  cudaStream_t stream) {
  if (route == ROUTE_VEC) {
    if (!vec_shape_ok(D, P)) return (int)cudaErrorInvalidValue;
    const int64_t groups = (int64_t)B * Lq * M;
    const int per_block = MSDA_VEC_THREADS / (D / 8);
    const int64_t blocks = (groups + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = (size_t)per_block * P * 32;
    if (P == 4)
      msda_fwd_vec_kernel<T, A, 4><<<(unsigned)blocks, MSDA_VEC_THREADS, smem, stream>>>(
          (const T*)value, (const float*)loc, (const A*)attn, (T*)out,
          S, M, D, Lq, L, P, lv, groups);
    else
      msda_fwd_vec_kernel<T, A, 0><<<(unsigned)blocks, MSDA_VEC_THREADS, smem, stream>>>(
          (const T*)value, (const float*)loc, (const A*)attn, (T*)out,
          S, M, D, Lq, L, P, lv, groups);
  } else if (route == ROUTE_SCALAR) {
    const int64_t total = (int64_t)B * Lq * M * D;
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    msda_fwd_scalar_kernel<T, A><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)value, (const float*)loc, (const A*)attn, (T*)out,
        S, M, D, Lq, L, P, lv, total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// value (B, S, M, D) and out (B, Lq, M*D) in the value type, 16-byte aligned for the
// vec route; loc (B, Lq, M, L, P, 2) f32, 8-byte aligned; attn (B, Lq, M, L, P).
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn, void* out,
                        int B, int S, int M, int D, int Lq, int L, int P,
                        const int* shapes,  // host array of L (H, W) pairs
                        int value_bf16, int attn_bf16, int route, void* stream) {
  Levels lv;
  if (!fill_levels(lv, shapes, L, S) || P < 1) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Lq * M * D == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (value_bf16)
    return attn_bf16 ? launch<bf, bf>(route, value, loc, attn, out, B, S, M, D, Lq, L, P, lv, s)
                     : launch<bf, float>(route, value, loc, attn, out, B, S, M, D, Lq, L, P, lv, s);
  return attn_bf16 ? launch<float, bf>(route, value, loc, attn, out, B, S, M, D, Lq, L, P, lv, s)
                   : launch<float, float>(route, value, loc, attn, out, B, S, M, D, Lq, L, P, lv, s);
}
