// Swin (shifted-)window attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel neurips2023_soc_tpu/ops/window_attention.py:window_attention_pallas
// (bodies _kernel_masked, _kernel_nomask, _attend_one). Same function, per (window w, head h):
//
//   s[i,j] = (q[i] . k[j] in f32) * Dh^-1/2 + bias[h,i,j]  (- 100 where ids[w % nW, i] != ids[w % nW, j])
//   out[i] = sum_j softmax_j(s[i,:]) * v[j]               (f32 sums, one rounding to q's type)
//
// The shift-region mask is rebuilt from the two tokens' region ids; the (nW, N, N) mask is
// never read. Both routes run the softmax online over key tiles in the log2 domain (exp2f,
// a running max and sum per query row), so the N x N scores never leave registers.
//
// Two routes, picked by q's dtype:
//
// bf16: tensor cores (wattn_tc_kernel). What bounds it: at the Video-Swin-B shapes (N = 392,
// Dh = 32) a (window, head) does 4 N^2 Dh flops on 4 N Dh elements of q, k, v and out, so on
// the bf16 tensor cores the work is bound by bytes; but its (N, N) f32 bias is 614 KB against
// 100 KB of q/k/v/out, so a kernel that reads the bias once per (window, head) is bound by that
// traffic instead, and past both, by the N^2 exp2 of the softmax on the MUFU unit. The design:
//   - Scores and P.V on the tensor cores: mma.sync m16n8k16, bf16 operands, f32 accumulators.
//     q and k fragments come from shared memory by ldmatrix, v by ldmatrix.trans. A warp owns
//     16 query rows and walks keys in steps of 64 (then 16 up to N): the scores stay in its
//     accumulators, get the scale, the f32 bias and the mask in f32, and the online-softmax
//     update; exp2(s - m) is rounded to bf16 and fed straight from the accumulators as the A
//     operand of P.V (no trip through shared memory). Each step's q.k is started before the
//     previous step's softmax, so the tensor cores and the softmax overlap. O stays in f32, is
//     divided by the row sum once and rounded once. Unlike the TPU kernel, which rounds the
//     normalised p to bf16, this rounds the unnormalised exp2(s - m) in [0, 1]; the row sum
//     is taken over the f32 values.
//   - Bias read once per (head, query tile): a CTA owns one head and one tile of 64 query
//     rows, stages that tile's f32 bias rows in shared memory once, 64 x (N + 8) x 4 bytes =
//     104 KB at N = 392, and then walks over a group of windows of that head.
//   - Eight warps per CTA: two for each 16 rows, one taking the first half of the 64-key steps
//     and one the rest and the 16-key remainder, each with its own running max and sum; the
//     second hands (m, l, O) to the first through 10 KB of shared memory, and the first merges
//     and stores. One CTA fits on an SM, so this is what puts two warps on each scheduler.
//   - Loads: q, k, v and the ids of window w + 2 are fetched with 16-byte cp.async by the
//     second half's warps while the first half merges and stores window w, into the buffer
//     window w has just released; two buffers of 2 x 400 x 64 + 64 x 64 + 400 x 4 bytes
//     (114 KB). 228,480 bytes in all at N = 392, within the 232,448 a block may use; above
//     N = 400 the two buffers do not fit and the CTA runs with one. Keys are padded to a multiple of 16 with
//     zero-filled k and v rows whose scores are set to -inf; query rows beyond N are
//     zero-filled and never stored.
//   - Group size: one CTA per SM fits at N = 392, so a launch of H x ceil(N / 64) x G CTAs runs
//     in waves of 132. The host picks the windows per CTA that minimise waves x (windows + 2),
//     the 2 standing for the bias staging (about two windows' worth of loads). At a
//     16 x 360 x 640 clip: stage 1 (598 windows, 4 heads) 34 windows per CTA, 504 CTAs in 4
//     waves; stage 2 (168, 8) 24, 392 CTAs in 3 waves; stage 3 (48, 16) 48, 112 CTAs in one
//     wave; stage 4 (12, 32) 12, 224 CTAs in 2 waves. CTAs of one window group and head run
//     next to each other in the grid, so the 7 query tiles of a window read its k and v from L2.
//   - Shared memory: k, v and q rows are 64 bytes; their four 16-byte chunks are XOR-swizzled
//     by (row / 2) % 4, so the eight rows of an ldmatrix phase hit distinct banks. The bias row
//     stride is N_pad + 8 floats, so the float2 reads of one accumulator tile are conflict-free.
//
// f32: CUDA cores (wattn_f32_kernel), the tests' and the small models' dtype; no Video-Swin-B
// path runs it, and it is the route that holds the JAX suite's 2e-5 (TF32 tensor cores would
// not). One CTA per (window, head), one query row per thread; k and v of the window are staged
// in shared memory (2 x N x 32 x 4 bytes, about 100 KB at N = 392, so the dynamic shared memory
// limit is raised); every thread of a warp reads the same key row, a broadcast. The bias row
// of the thread's query is read from (H, N, N) in f32 (the windows of one head run as
// consecutive CTAs, so a head's bias stays in L2). p is not rounded before the product with v.
//
// Layout: q, k and v share strides (in elements) over (window, head, token) and have a
// contiguous Dh; 16-byte aligned rows. out is (B_, N, H, Dh) contiguous, which is the
// (B_, N, C) layout that the output projection reads. Dh = 32, 1 <= N <= 512.
//
// C interface (bound with ctypes): wattn_fwd(...) launches on the given stream and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#define WATTN_DH 32
#define WATTN_MAX_N 512

static constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- f32: CUDA cores
#define WATTN_TILE 16

__device__ __forceinline__ void load8(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
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

__global__ void __launch_bounds__(WATTN_MAX_N, 1)
wattn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ ids, float* __restrict__ out, int H, int N, int nW,
                 int64_t sb, int64_t sh, int64_t sn, float scale2) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + N * WATTN_DH;
  int* ids_s = reinterpret_cast<int*>(Vs + N * WATTN_DH);

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)w * sb + (int64_t)h * sh;

  // stage k and v of this (window, head), 8 elements (two 16-byte reads) per step;
  // neighbouring threads read neighbouring chunks of a row
  for (int e = tid * 8; e < N * WATTN_DH; e += blockDim.x * 8) {
    const int n = e / WATTN_DH;
    const int d = e % WATTN_DH;
    load8(k + base + n * sn + d, Ks + e);
    load8(v + base + n * sn + d, Vs + e);
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
  float* orow = out + (((int64_t)w * N + tid) * H + h) * WATTN_DH;
#pragma unroll
  for (int c = 0; c < WATTN_DH; c += 8) store8(orow + c, acc + c);
}

static int launch_f32(const float* q, const float* k, const float* v, const float* bias,
                      const int* ids, float* out, int B_, int H, int N, int nW, int64_t sb,
                      int64_t sh, int64_t sn, float scale2, cudaStream_t stream) {
  const size_t smem = (size_t)N * WATTN_DH * 2 * sizeof(float) + (size_t)N * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(wattn_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (N + 31) / 32 * 32;
  wattn_f32_kernel<<<dim3(B_, H), threads, smem, stream>>>(q, k, v, bias, ids, out, H, N, nW,
                                                           sb, sh, sn, scale2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: tensor cores
#define TC_ROWS 64      // query rows per CTA: 4 warps x 16, twice (two halves of the keys)
#define TC_THREADS 256
#define TC_KEYS 64     // keys per online-softmax step; the rest in steps of 16
#define TC_ROW_BYTES (WATTN_DH * 2)

// Byte offset of 16-byte chunk c (0..3) of 64-byte row r in a swizzled k, v or q tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * TC_ROW_BYTES + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group is in flight, or none.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the MUFU unit alone. Results below 2^-126 flush to 0: next to the row's largest
// p = exp2(s - m), which is 1, such terms change neither the f32 sums nor the bf16 output.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Raw scores q . k of the NT 8-key tiles from j0 for the calling warp's 16 query rows. The
// thread holds rows r and r + 8 (r = lane / 4) and, of each tile, keys 2 (lane % 4) and + 1:
// the m16n8 accumulator layout.
template <int NT>
__device__ __forceinline__ void tc_scores(const uint32_t (&qa)[2][4], uint32_t ks, int j0,
                                          int lane, float (&s)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    uint32_t b[4];  // k rows j0 + 8t .. + 7, dims 0-7, 8-15, 16-23, 24-31
    ldsm_x4(b, ks + swz(j0 + 8 * t + (lane & 7), lane >> 3));
    mma_bf16(s[t], qa[0], b[0], b[1]);
    mma_bf16(s[t], qa[1], b[2], b[3]);
  }
}

// The online-softmax update and P.V for the raw scores s of keys j0 .. j0 + 8 NT - 1 (s is
// consumed): scale, f32 bias and mask in the log2 domain, running max m and sum l per row,
// O rescaled and accumulated. RAGGED steps set the scores of keys >= N to -inf.
template <int NT, bool MASKED, bool RAGGED>
__device__ __forceinline__ void tc_softmax_pv(float (&s)[NT][4], uint32_t vs,
                                              const float* __restrict__ brow0,
                                              const float* __restrict__ brow1,
                                              const int* __restrict__ ids_s, int id0, int id1,
                                              int j0, int N, int lane, float scale2,
                                              float (&m)[2], float (&l)[2], float (&o)[4][4]) {
  const float MASK2 = 100.f * LOG2E;
  float mx[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int j = j0 + 8 * t + 2 * (lane & 3);
    const float2 b0 = *reinterpret_cast<const float2*>(brow0 + j);
    const float2 b1 = *reinterpret_cast<const float2*>(brow1 + j);
    s[t][0] = fmaf(s[t][0], scale2, b0.x);
    s[t][1] = fmaf(s[t][1], scale2, b0.y);
    s[t][2] = fmaf(s[t][2], scale2, b1.x);
    s[t][3] = fmaf(s[t][3], scale2, b1.y);
    if (MASKED) {
      const int2 kid = *reinterpret_cast<const int2*>(ids_s + j);
      if (kid.x != id0) s[t][0] -= MASK2;
      if (kid.y != id0) s[t][1] -= MASK2;
      if (kid.x != id1) s[t][2] -= MASK2;
      if (kid.y != id1) s[t][3] -= MASK2;
    }
    if (RAGGED) {
      if (j >= N) s[t][0] = s[t][2] = -INFINITY;
      if (j + 1 >= N) s[t][1] = s[t][3] = -INFINITY;
    }
    mx[t][0] = fmaxf(s[t][0], s[t][1]);
    mx[t][1] = fmaxf(s[t][2], s[t][3]);
  }
#pragma unroll
  for (int w = 1; w < NT; w *= 2)  // a tree, not a chain
#pragma unroll
    for (int t = 0; t + w < NT; t += 2 * w) {
      mx[t][0] = fmaxf(mx[t][0], mx[t + w][0]);
      mx[t][1] = fmaxf(mx[t][1], mx[t + w][1]);
    }
  float mx0 = mx[0][0], mx1 = mx[0][1];
  // the four threads of a row hold its 8-key tiles between them
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every step holds a key < N, so the new max is finite; ex2(-inf) = 0 on the first step
  const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
  const float c0 = ex2(m[0] - mn0), c1 = ex2(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  l[0] *= c0;
  l[1] *= c1;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    o[d][0] *= c0;
    o[d][1] *= c0;
    o[d][2] *= c1;
    o[d][3] *= c1;
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    s[t][0] = ex2(s[t][0] - mn0);
    s[t][1] = ex2(s[t][1] - mn0);
    s[t][2] = ex2(s[t][2] - mn1);
    s[t][3] = ex2(s[t][3] - mn1);
    l[0] += s[t][0] + s[t][1];
    l[1] += s[t][2] + s[t][3];
  }
  // P.V: two 8-key score tiles are one 16-key A fragment
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const int row = j0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t b[4];  // v rows j0 + 16kk .. + 15, dims 16 half .. + 15, transposed
      ldsm_x4_t(b, vs + swz(row, 2 * half + (lane >> 4)));
      mma_bf16(o[2 * half], pa, b[0], b[1]);
      mma_bf16(o[2 * half + 1], pa, b[2], b[3]);
    }
  }
}

// The key steps [s0, s1) of 64 keys for the calling warp, each step's q.k started before the
// previous step's softmax so that the tensor cores and the softmax overlap.
template <bool MASKED>
__device__ __forceinline__ void tc_full_steps(int s0, int s1, const uint32_t (&qa)[2][4],
                                              uint32_t ks, uint32_t vs,
                                              const float* __restrict__ brow0,
                                              const float* __restrict__ brow1,
                                              const int* __restrict__ ids_s, int id0, int id1,
                                              int N, int lane, float scale2, float (&m)[2],
                                              float (&l)[2], float (&o)[4][4]) {
  if (s1 <= s0) return;
  float s[TC_KEYS / 8][4];
  tc_scores<TC_KEYS / 8>(qa, ks, s0 * TC_KEYS, lane, s);
  for (int st = s0 + 1; st < s1; ++st) {
    float next[TC_KEYS / 8][4];
    tc_scores<TC_KEYS / 8>(qa, ks, st * TC_KEYS, lane, next);
    tc_softmax_pv<TC_KEYS / 8, MASKED, false>(s, vs, brow0, brow1, ids_s, id0, id1,
                                              (st - 1) * TC_KEYS, N, lane, scale2, m, l, o);
#pragma unroll
    for (int t = 0; t < TC_KEYS / 8; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[t][x] = next[t][x];
  }
  tc_softmax_pv<TC_KEYS / 8, MASKED, false>(s, vs, brow0, brow1, ids_s, id0, id1,
                                            (s1 - 1) * TC_KEYS, N, lane, scale2, m, l, o);
}

// Shared memory of the tensor-core kernel: the bias tile; the (m, l, O) that the second key
// half hands to the first, 20 floats a thread, component-major; nbuf buffers of k, v, q, ids.
__host__ __device__ inline size_t tc_bias_bytes(int npad) {
  return (size_t)TC_ROWS * (npad + 8) * 4;
}
#define TC_XCHG_BYTES (20 * (TC_THREADS / 2) * 4)
__host__ __device__ inline size_t tc_buf_bytes(int npad) {
  return (size_t)2 * npad * TC_ROW_BYTES + TC_ROWS * TC_ROW_BYTES + (size_t)npad * 4;
}

template <bool MASKED>
__global__ void __launch_bounds__(TC_THREADS, 1)
wattn_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                const int* __restrict__ ids, __nv_bfloat16* __restrict__ out, int B_, int H,
                int N, int nW, int64_t sb, int64_t sh, int64_t sn, int per_cta, int nbuf,
                float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npad = (N + 15) & ~15;
  const int ldb = npad + 8;
  float* bias_s = reinterpret_cast<float*>(smem);
  float* xchg = reinterpret_cast<float*>(smem + tc_bias_bytes(npad));
  unsigned char* bufs = smem + tc_bias_bytes(npad) + TC_XCHG_BYTES;
  const size_t buf_bytes = tc_buf_bytes(npad);
  const uint32_t k_off = 0, v_off = npad * TC_ROW_BYTES, q_off = 2 * npad * TC_ROW_BYTES;
  const uint32_t ids_off = q_off + TC_ROWS * TC_ROW_BYTES;

  const int q0 = blockIdx.x * TC_ROWS;
  const int w0 = blockIdx.y * per_cta;
  const int cnt = min(per_cta, B_ - w0);
  const int h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp & 3;     // the warp's 16 rows of the tile
  const int half = warp >> 2;  // 0: the first half of the key steps, 1: the rest

  // q, k, v (and ids) of window w into buffer b, by the second half's 128 threads; rows
  // beyond N are zero-filled
  auto fetch = [&](int w, int b) {
    const int t0 = tid - TC_THREADS / 2, step = TC_THREADS / 2;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(bufs + b * buf_bytes);
    const int64_t base = (int64_t)w * sb + (int64_t)h * sh;
    for (int e = t0; e < npad * 4; e += step) {
      const int n = e >> 2, c = e & 3;
      const bool ok = n < N;
      const int64_t off = base + (int64_t)(ok ? n : 0) * sn + c * 8;
      cp_async16(dst + k_off + swz(n, c), k + off, ok);
      cp_async16(dst + v_off + swz(n, c), v + off, ok);
    }
    for (int e = t0; e < TC_ROWS * 4; e += step) {
      const int r = e >> 2, c = e & 3, n = q0 + r;
      const bool ok = n < N;
      cp_async16(dst + q_off + swz(r, c), q + base + (int64_t)(ok ? n : 0) * sn + c * 8, ok);
    }
    if (MASKED) {
      const int* row = ids + (int64_t)(w % nW) * N;
      for (int j = t0; j < npad; j += step)
        cp_async4(dst + ids_off + j * 4, row + (j < N ? j : 0), j < N);
    }
  };

  // the bias rows of this query tile, once for all the windows of the group: 16-byte copies
  // where N % 4 == 0 keeps the rows aligned, else 4-byte ones; zeros beyond N
  const int vec = (N & 3) == 0 ? 4 : 1;
  const float* bias_h = bias + (int64_t)h * N * N;
  const uint32_t bias_dst = (uint32_t)__cvta_generic_to_shared(bias_s);
  for (int e = tid * vec; e < TC_ROWS * npad; e += TC_THREADS * vec) {
    const int r = e / npad, j = e - r * npad, i = q0 + r;
    const bool ok = i < N && j < N;
    const float* src = bias_h + (ok ? (int64_t)i * N + j : 0);
    if (vec == 4)
      cp_async16(bias_dst + (r * ldb + j) * 4, src, ok);
    else
      cp_async4(bias_dst + (r * ldb + j) * 4, src, ok);
  }
  // cp.async groups are committed by every thread at the same points (empty in the first
  // half but for the bias), one per window: windows w0 (with the bias) and w0 + 1 now,
  // w + 2 at the end of window w
  if (half) fetch(w0, 0);
  cp_async_commit();
  if (half && nbuf == 2 && cnt > 1) fetch(w0 + 1, 1);
  cp_async_commit();
  // each thread scales the bias it copied by log2(e) once its copies have landed
  cp_async_wait1();
  for (int e = tid * vec; e < TC_ROWS * npad; e += TC_THREADS * vec) {
    const int r = e / npad, j = e - r * npad;
    for (int x = 0; x < vec; ++x) bias_s[r * ldb + j + x] *= LOG2E;
  }

  const int r_lo = rw * 16 + (lane >> 2);  // this thread's rows in the tile: r_lo, r_lo + 8
  const float* brow0 = bias_s + r_lo * ldb;
  const float* brow1 = brow0 + 8 * ldb;
  // the first half takes full steps [0, split), the second [split, full) and the 16-key rest
  const int full = N / TC_KEYS, split = (full + 1) / 2;
  float* slot = xchg + (rw * 32 + lane);  // this thread's slot in the exchange, stride 128
  for (int it = 0; it < cnt; ++it) {
    const int w = w0 + it;
    if (nbuf == 2)
      cp_async_wait1();  // all but window it + 1's group
    else
      cp_async_wait0();
    __syncthreads();

    unsigned char* buf = bufs + (nbuf == 2 ? (it & 1) : 0) * buf_bytes;
    const uint32_t bs = (uint32_t)__cvta_generic_to_shared(buf);
    const int* ids_s = reinterpret_cast<const int*>(buf + ids_off);
    uint32_t qa[2][4];  // A fragments of this warp's 16 q rows, dims 0-15 and 16-31
#pragma unroll
    for (int kstep = 0; kstep < 2; ++kstep)
      ldsm_x4(qa[kstep], bs + q_off + swz(rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          2 * kstep + (lane >> 4)));
    int id0 = 0, id1 = 0;
    if (MASKED) {
      id0 = ids_s[min(q0 + r_lo, N - 1)];
      id1 = ids_s[min(q0 + r_lo + 8, N - 1)];
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[4][4];
#pragma unroll
    for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

    tc_full_steps<MASKED>(half ? split : 0, half ? full : split, qa, bs + k_off, bs + v_off,
                          brow0, brow1, ids_s, id0, id1, N, lane, scale2, m, l, o);
    if (half)
      for (int j0 = full * TC_KEYS; j0 < N; j0 += 16) {
        float s[2][4];
        tc_scores<2>(qa, bs + k_off, j0, lane, s);
        tc_softmax_pv<2, MASKED, true>(s, bs + v_off, brow0, brow1, ids_s, id0, id1, j0, N,
                                       lane, scale2, m, l, o);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (half) {
      slot[0] = m[0];
      slot[128] = m[1];
      slot[256] = l[0];
      slot[384] = l[1];
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) slot[(4 + 4 * d + e) * 128] = o[d][e];
    }
    // both halves are done with this buffer (so it may be refilled) and the second half's
    // (m, l, O) is in place; a half with no key step holds m = -inf, l = 0, O = 0
    __syncthreads();
    if (!half) {
      float c[2][2];  // the factors of this half's and the other half's sums, per row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mo = slot[128 * r], mn = fmaxf(m[r], mo);
        c[r][0] = ex2(m[r] - mn);
        c[r][1] = ex2(mo - mn);
      }
      const float inv0 = 1.f / (l[0] * c[0][0] + slot[256] * c[0][1]);
      const float inv1 = 1.f / (l[1] * c[1][0] + slot[384] * c[1][1]);
      const int i0 = q0 + r_lo, i1 = i0 + 8;
      __nv_bfloat16* orow = out + (((int64_t)w * N + i0) * H + h) * WATTN_DH + 2 * (lane & 3);
      const int64_t down8 = (int64_t)8 * H * WATTN_DH;  // row i0 + 8
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float* xo = slot + (4 + 4 * d) * 128;
        if (i0 < N)
          *reinterpret_cast<uint32_t*>(orow + 8 * d) =
              pack_bf16((o[d][0] * c[0][0] + xo[0] * c[0][1]) * inv0,
                        (o[d][1] * c[0][0] + xo[128] * c[0][1]) * inv0);
        if (i1 < N)
          *reinterpret_cast<uint32_t*>(orow + down8 + 8 * d) =
              pack_bf16((o[d][2] * c[1][0] + xo[256] * c[1][1]) * inv1,
                        (o[d][3] * c[1][0] + xo[384] * c[1][1]) * inv1);
      }
    }
    // while the first half merges and stores, the second refills the buffer just released
    if (half && nbuf == 2 && it + 2 < cnt) fetch(w + 2, it & 1);
    if (half && nbuf == 1 && it + 1 < cnt) fetch(w + 1, 0);
    cp_async_commit();
  }
}

// Windows per CTA that minimise waves x (windows + 2): a wave puts one CTA on every slot
// (SMs x CTAs per SM), and the 2 stands for staging the bias tile. gridDim.y stays <= 65535;
// groups of more than 4096 windows beyond that floor are not searched.
static int window_group(int B_, long long pairs, long long slots) {
  const long long lo = ((long long)B_ + 65534) / 65535;
  long long best = lo, best_cost = -1;
  for (long long per = lo; per <= B_ && per <= lo + 4096; ++per) {
    const long long groups = (B_ + per - 1) / per;
    const long long cost = ((pairs * groups + slots - 1) / slots) * (per + 2);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = per;
    }
  }
  return (int)best;
}

// What a launch needs to know of its card, found on the card's first launch of each kind and
// kept, so that a later launch only picks the window group: the SM count, the shared memory a
// block may opt into (the kernels' dynamic limit is raised to it once), and the CTAs an SM
// holds per (masked, N), which sets the window group. Guarded by a mutex: ctypes releases the
// GIL, so two host threads may launch at once.
#define TC_MAX_CARDS 64
struct TcCard {
  int sms = 0, optin = 0;
  bool raised[2] = {false, false};
  short per_sm[2][WATTN_MAX_N + 1] = {};  // 0: not found yet
};
static TcCard tc_cards[TC_MAX_CARDS];
static std::mutex tc_cards_mu;

static int launch_tc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const float* bias, const int* ids, __nv_bfloat16* out, int B_, int H,
                     int N, int nW, int64_t sb, int64_t sh, int64_t sn, float scale2,
                     cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= TC_MAX_CARDS) return (int)cudaErrorInvalidDevice;
  const bool masked = ids != nullptr;
  auto kern = masked ? wattn_tc_kernel<true> : wattn_tc_kernel<false>;
  const int npad = (N + 15) & ~15;
  size_t smem = 0;
  int sms = 0, per_sm = 0, nbuf = 2;
  {
    std::lock_guard<std::mutex> lock(tc_cards_mu);
    TcCard& card = tc_cards[dev];
    if (card.sms == 0) {
      int s = 0, o = 0;
      err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return (int)err;
      card.sms = s;
      card.optin = o;
    }
    if (tc_bias_bytes(npad) + TC_XCHG_BYTES + 2 * tc_buf_bytes(npad) > (size_t)card.optin)
      nbuf = 1;
    smem = tc_bias_bytes(npad) + TC_XCHG_BYTES + nbuf * tc_buf_bytes(npad);
    if (smem > (size_t)card.optin) return (int)cudaErrorInvalidValue;
    if (!card.raised[masked]) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, card.optin);
      if (err != cudaSuccess) return (int)err;
      card.raised[masked] = true;
    }
    if (card.per_sm[masked][N] == 0) {
      int found = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&found, kern, TC_THREADS, smem);
      if (err != cudaSuccess) return (int)err;
      card.per_sm[masked][N] = (short)(found > 0 ? found : 1);
    }
    sms = card.sms;
    per_sm = card.per_sm[masked][N];
  }
  const int tiles = (N + TC_ROWS - 1) / TC_ROWS;
  const int per = window_group(B_, (long long)tiles * H, (long long)sms * per_sm);
  const int groups = (int)(((long long)B_ + per - 1) / per);
  kern<<<dim3(tiles, groups, H), TC_THREADS, smem, stream>>>(q, k, v, bias, ids, out, B_, H, N,
                                                              nW, sb, sh, sn, per, nbuf, scale2);
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
  const float scale2 = (1.0f / sqrtf((float)WATTN_DH)) * LOG2E;
  if (is_bf16)
    return launch_tc((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                     (const __nv_bfloat16*)v, (const float*)bias, (const int*)ids,
                     (__nv_bfloat16*)out, B_, H, N, nW, sb, sh, sn, scale2, s);
  return launch_f32((const float*)q, (const float*)k, (const float*)v, (const float*)bias,
                    (const int*)ids, (float*)out, B_, H, N, nW, sb, sh, sn, scale2, s);
}
