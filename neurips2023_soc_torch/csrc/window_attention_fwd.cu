// Swin (shifted-)window attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel neurips2023_soc_tpu/ops/window_attention.py:window_attention_pallas
// (bodies _kernel_masked, _kernel_nomask, _attend_one). Same function, per (window w, head h):
//
//   s[i,j] = (q[i] . k[j] in f32) * Dh^-1/2 + bias[h,i,j]  (- 100 where ids[w % nW, i] != ids[w % nW, j])
//   out[i] = sum_j softmax_j(s[i,:]) * v[j]               (f32 sums, one rounding to q's type)
//
// The shift-region mask is rebuilt from the two tokens' region ids; the (nW, N, N) mask is
// never read. Unlike the TPU kernel, p is not rounded to v's type before the product with v.
//
// What bounds it on the H100: at the Video-Swin-B shapes (N = 392, Dh = 32) the work is
// 4 N^2 Dh flops per (window, head) against 4 N Dh elements of q, k, v and out, so the
// tensor cores would be bound by bytes; this first kernel runs on the f32 CUDA cores and is
// bound by their rate. Design: one CTA per (window, head), one query row per thread; k and v
// of the window are converted to f32 once and staged in shared memory (2 * N * 32 * 4 bytes,
// about 100 KB at N = 392, so the dynamic shared memory limit is raised); every thread of a
// warp reads the same key row, a broadcast with no bank conflict. The softmax is online: keys
// go in tiles of 16 with a running max and sum, so the N x N scores never leave registers.
// The bias row of the thread's query is read from (H, N, N) in f32 (the windows of one head
// run as consecutive CTAs, so a head's bias stays in L2). No tensor cores, TMA or wgmma yet.
//
// Layout: q, k and v share strides (in elements) over (window, head, token) and have a
// contiguous Dh; 16-byte aligned rows. out is (B_, N, H, Dh) contiguous, which is the
// (B_, N, C) layout that the output projection reads.
//
// C interface (bound with ctypes): wattn_fwd(...) launches on the given stream and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WATTN_DH 32
#define WATTN_MAX_N 512
#define WATTN_TILE 16

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* src) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(src[4], src[5], src[6], src[7]);
}

// One tile of TJ keys starting at j0 for the calling thread's query row, in the log2
// domain (s2 = s * log2(e)), with the running max m2, sum l and accumulator acc.
template <int TJ>
__device__ __forceinline__ void attend_tile(const float* __restrict__ Ks,
                                            const float* __restrict__ Vs,
                                            const int* __restrict__ ids_s,
                                            const float* __restrict__ brow, int j0,
                                            const float* qr, int my_id, bool masked,
                                            float scale2, float& m2, float& l, float* acc) {
  const float LOG2E = 1.4426950408889634f;
  float s[TJ];
  float tmax = -INFINITY;
#pragma unroll
  for (int t = 0; t < TJ; ++t) {
    const int j = j0 + t;
    const float4* kr = reinterpret_cast<const float4*>(Ks + j * WATTN_DH);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < WATTN_DH / 4; ++c) {
      const float4 kv = kr[c];
      dot = fmaf(qr[4 * c], kv.x, dot);
      dot = fmaf(qr[4 * c + 1], kv.y, dot);
      dot = fmaf(qr[4 * c + 2], kv.z, dot);
      dot = fmaf(qr[4 * c + 3], kv.w, dot);
    }
    float add = brow[j];
    if (masked && ids_s[j] != my_id) add -= 100.f;
    // s * log2(e) = dot * (Dh^-1/2 * log2(e)) + (bias + mask) * log2(e)
    s[t] = fmaf(dot, scale2, add * LOG2E);
    tmax = fmaxf(tmax, s[t]);
  }
  const float m_new = fmaxf(m2, tmax);
  const float corr = exp2f(m2 - m_new);  // 0 on the first tile (m2 = -inf)
  l *= corr;
#pragma unroll
  for (int d = 0; d < WATTN_DH; ++d) acc[d] *= corr;
#pragma unroll
  for (int t = 0; t < TJ; ++t) {
    const float p = exp2f(s[t] - m_new);
    l += p;
    const float4* vr = reinterpret_cast<const float4*>(Vs + (j0 + t) * WATTN_DH);
#pragma unroll
    for (int c = 0; c < WATTN_DH / 4; ++c) {
      const float4 vv = vr[c];
      acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
      acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
      acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
      acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
    }
  }
  m2 = m_new;
}

template <typename T>
__global__ void __launch_bounds__(WATTN_MAX_N, 1)
wattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const int* __restrict__ ids,
                 T* __restrict__ out, int H, int N, int nW, int64_t sb, int64_t sh,
                 int64_t sn, float scale2) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + N * WATTN_DH;
  int* ids_s = reinterpret_cast<int*>(Vs + N * WATTN_DH);

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)w * sb + (int64_t)h * sh;

  // stage k and v of this (window, head) as f32, 8 elements (one 16-byte or two 16-byte
  // reads) per step; neighbouring threads read neighbouring chunks of a row
  for (int e = tid * 8; e < N * WATTN_DH; e += blockDim.x * 8) {
    const int n = e / WATTN_DH;
    const int d = e % WATTN_DH;
    float tmp[8];
    load8(k + base + n * sn + d, tmp);
#pragma unroll
    for (int i = 0; i < 8; ++i) Ks[e + i] = tmp[i];
    load8(v + base + n * sn + d, tmp);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vs[e + i] = tmp[i];
  }
  const bool masked = ids != nullptr;
  if (masked)
    for (int j = tid; j < N; j += blockDim.x) ids_s[j] = ids[(int64_t)(w % nW) * N + j];
  __syncthreads();
  if (tid >= N) return;

  float qr[WATTN_DH];
#pragma unroll
  for (int c = 0; c < WATTN_DH; c += 8) load8(q + base + tid * sn + c, qr + c);
  const float* brow = bias + ((int64_t)h * N + tid) * N;
  const int my_id = masked ? ids_s[tid] : 0;

  float m2 = -INFINITY, l = 0.f;
  float acc[WATTN_DH];
#pragma unroll
  for (int d = 0; d < WATTN_DH; ++d) acc[d] = 0.f;

  int j0 = 0;
  for (; j0 + WATTN_TILE <= N; j0 += WATTN_TILE)
    attend_tile<WATTN_TILE>(Ks, Vs, ids_s, brow, j0, qr, my_id, masked, scale2, m2, l, acc);
  for (; j0 < N; ++j0)
    attend_tile<1>(Ks, Vs, ids_s, brow, j0, qr, my_id, masked, scale2, m2, l, acc);

  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < WATTN_DH; ++d) acc[d] *= inv;
  T* orow = out + (((int64_t)w * N + tid) * H + h) * WATTN_DH;
#pragma unroll
  for (int c = 0; c < WATTN_DH; c += 8) store8(orow + c, acc + c);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const float* bias,
                  const int* ids, void* out, int B_, int H, int N, int nW, int64_t sb,
                  int64_t sh, int64_t sn, cudaStream_t stream) {
  const size_t smem = (size_t)N * WATTN_DH * 2 * sizeof(float) + (size_t)N * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(wattn_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (N + 31) / 32 * 32;
  const float scale2 = (1.0f / sqrtf((float)WATTN_DH)) * 1.4426950408889634f;
  wattn_fwd_kernel<T><<<dim3(B_, H), threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, ids, (T*)out, H, N, nW, sb, sh, sn,
      scale2);
  return (int)cudaGetLastError();
}

extern "C" int wattn_fwd(const void* q, const void* k, const void* v, const void* bias,
                         const void* ids,  // (nW, N) int32 or null
                         void* out, int B_, int H, int N, int Dh, int nW,
                         long long sb, long long sh, long long sn, int is_bf16,
                         void* stream) {
  if (Dh != WATTN_DH || N < 1 || N > WATTN_MAX_N || B_ < 1 || H < 1 || B_ > 0x7fffffff
      || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (ids != nullptr && (nW < 1 || B_ % nW != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, (const float*)bias, (const int*)ids, out, B_, H, N,
                                 nW, sb, sh, sn, s);
  return launch<float>(q, k, v, (const float*)bias, (const int*)ids, out, B_, H, N, nW, sb,
                       sh, sn, s);
}
