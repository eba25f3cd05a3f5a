// LayerNorm over the last axis, forward, bfloat16 out, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its LayerNorm (flax nn.LayerNorm) to XLA,
// which fuses the upcast, the statistics and the downcast into the neighbouring ops. The port's
// plain version (ops/layer_norm.py:layer_norm_ref) takes three kernels for it in bf16: a copy
// to f32, PyTorch's f32 LayerNorm and a copy back, 20 bytes of traffic an element. Per row of C
// channels this kernel computes what that plain version does:
//
//   mean = sum(x) / C,  var = sum((x - mean)^2) / C,  rstd = rsqrt(var + eps)
//   y = (x - mean) * rstd * w + b                     (f32, w and b f32; one rounding to bf16)
//
// with x bf16 or f32, read once, and y written once: 4 bytes an element for bf16 in, plus w and
// b once a CTA. It does about 8 operations an element, so on this card it is bound by bytes
// (3.35 TB/s), far from any compute limit. The design follows from that:
//   - One pass over memory. A row stays in registers as f32 between its load and its store;
//     the mean and then the centred second moment are two passes over those registers.
//   - 16-byte loads and stores: a thread holds its share of a row as chunks of 8 channels (one
//     uint4 of bf16, or two float4 of f32) and writes 8 bf16 at a time.
//   - A group of G lanes (4, 8, 16 or 32) owns a row, so short rows fill a warp: the host picks
//     the smallest G whose chunks a lane needs, NV, are at most 4 (G < 32) or 16 (G = 32).
//     C = 128: 4 lanes x 4 chunks, 8 rows a warp; 192: 8 x 3; 256: 8 x 4; 384: 16 x 3;
//     768: 32 x 3; 1536: 32 x 6; 3072: 32 x 12; Swin-T's 96: 4 x 3. The group sums with
//     shuffles inside the warp; no shared memory or barrier is needed per row.
//   - w and b are staged once a CTA in shared memory, split into the low and high halves of
//     each chunk so that a lane's 16-byte reads of consecutive chunks hit distinct banks; every
//     row the CTA walks reads them there. CTAs walk the rows with a grid stride, and the grid
//     is what the card holds at once (SMs x resident CTAs, found once per card and kernel).
//   - The sums are divided by C (IEEE division, one per row), not multiplied by a rounded 1 / C:
//     a row of equal bf16 values then has that value as its mean exactly and a variance of 0,
//     as PyTorch's Welford statistics give, so y = b there even at eps 1e-12, where rstd is 1e6
//     and any rounding of the mean would show.
//   - The vector route needs C % 8 == 0, C <= 4096 and 16-byte aligned x, w, b and y; every
//     width of the port's configurations takes it. Anything else takes the scalar route of the
//     same arithmetic: a warp a row, lanes striding over the channels, three passes over the
//     row in memory (the second and third from cache).
//
// Layout: x is (rows, C) contiguous (the wrapper makes a strided input contiguous), w and b are
// (C,) f32, y is (rows, C) bf16 contiguous.
//
// C interface (bound with ctypes): ln_fwd(...) launches on the given stream on card `device`
// and returns cudaGetLastError() as an int (cudaErrorInvalidValue for what it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#define LN_THREADS 128
#define LN_VEC 8  // channels a chunk
#define LN_MAX_C (32 * 16 * LN_VEC)

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <int G>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Vector route: a group of G lanes a row, NV chunks of 8 channels a lane (chunk j * G + lane).
template <typename Tin, int G, int NV>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_vec_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, __nv_bfloat16* __restrict__ y, long long rows,
                  int C, float eps) {
  extern __shared__ float4 ln_smem[];  // [w lo, w hi, b lo, b hi] x chunks
  const int chunks = C / LN_VEC;
  float4* sw = ln_smem;
  float4* sb = ln_smem + 2 * chunks;
  for (int i = threadIdx.x; i < 2 * chunks; i += LN_THREADS) {
    const int slot = (i & 1) * chunks + (i >> 1);  // float4 i is half (i & 1) of chunk i / 2
    sw[slot] = __ldg(reinterpret_cast<const float4*>(w) + i);
    sb[slot] = __ldg(reinterpret_cast<const float4*>(b) + i);
  }
  __syncthreads();

  constexpr int ROWS_PER_CTA = LN_THREADS / G;
  const int lane = threadIdx.x % G;
  // base is the same for every lane of a warp, so the loop and the shuffles are warp-uniform
  const long long first = (long long)blockIdx.x * ROWS_PER_CTA + (threadIdx.x & ~31) / G;
  for (long long base = first; base < rows; base += (long long)gridDim.x * ROWS_PER_CTA) {
    const long long r = base + (threadIdx.x & 31) / G;
    const bool row_ok = r < rows;
    const Tin* xr = x + r * C;
    float v[NV][LN_VEC];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * G + lane;
      if (row_ok && c < chunks) {
        load8(xr + c * LN_VEC, v[j]);
      } else {
#pragma unroll
        for (int k = 0; k < LN_VEC; ++k) v[j][k] = 0.0f;
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < LN_VEC; ++k) s += v[j][k];
    const float mean = group_sum<G>(s) / (float)C;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j * G + lane < chunks) {
#pragma unroll
        for (int k = 0; k < LN_VEC; ++k) {
          const float d = v[j][k] - mean;
          q += d * d;
        }
      }
    }
    const float rstd = rsqrtf(group_sum<G>(q) / (float)C + eps);
    if (!row_ok) continue;
    __nv_bfloat16* yr = y + r * C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * G + lane;
      if (c < chunks) {
        const float4 w0 = sw[c], w1 = sw[chunks + c], b0 = sb[c], b1 = sb[chunks + c];
        const float wv[LN_VEC] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float bv[LN_VEC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        uint4 u;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          h[k] = __floats2bfloat162_rn((v[j][2 * k] - mean) * rstd * wv[2 * k] + bv[2 * k],
                                       (v[j][2 * k + 1] - mean) * rstd * wv[2 * k + 1]
                                           + bv[2 * k + 1]);
        *reinterpret_cast<uint4*>(yr + c * LN_VEC) = u;
      }
    }
  }
}

// Scalar route: a warp a row, any C and alignment.
template <typename Tin>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_scalar_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
                     long long rows, int C, float eps) {
  constexpr int WARPS = LN_THREADS / 32;
  const int lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32; r < rows;
       r += (long long)gridDim.x * WARPS) {
    const Tin* xr = x + r * C;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
    const float mean = group_sum<32>(s) / (float)C;
    float q = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f32(xr[c]) - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(group_sum<32>(q) / (float)C + eps);
    __nv_bfloat16* yr = y + r * C;
    for (int c = lane; c < C; c += 32)
      yr[c] = __float2bfloat16_rn((to_f32(xr[c]) - mean) * rstd * w[c] + b[c]);
  }
}

template <typename Tin, int G, int NV>
static const void* vec_kernel() {
  return (const void*)ln_fwd_vec_kernel<Tin, G, NV>;
}

// The vector route's kernel for C and the input type (and its G), or null where C does not
// fit it.
template <typename Tin>
static const void* pick_vec(int C, int* G) {
  if (C % LN_VEC != 0 || C < LN_VEC || C > LN_MAX_C) return nullptr;
  const int chunks = C / LN_VEC;
  for (int g = 4; g < 32; g *= 2) {
    const int nv = (chunks + g - 1) / g;
    if (nv > 4) continue;
    *G = g;
    switch (g * 16 + nv) {
      case 4 * 16 + 1: return vec_kernel<Tin, 4, 1>();
      case 4 * 16 + 2: return vec_kernel<Tin, 4, 2>();
      case 4 * 16 + 3: return vec_kernel<Tin, 4, 3>();
      case 4 * 16 + 4: return vec_kernel<Tin, 4, 4>();
      case 8 * 16 + 1: return vec_kernel<Tin, 8, 1>();
      case 8 * 16 + 2: return vec_kernel<Tin, 8, 2>();
      case 8 * 16 + 3: return vec_kernel<Tin, 8, 3>();
      case 8 * 16 + 4: return vec_kernel<Tin, 8, 4>();
      case 16 * 16 + 1: return vec_kernel<Tin, 16, 1>();
      case 16 * 16 + 2: return vec_kernel<Tin, 16, 2>();
      case 16 * 16 + 3: return vec_kernel<Tin, 16, 3>();
      case 16 * 16 + 4: return vec_kernel<Tin, 16, 4>();
    }
  }
  *G = 32;
  const int nv = (chunks + 31) / 32;  // 3 to 16: 64 < chunks <= 512
  if (nv <= 3) return vec_kernel<Tin, 32, 3>();
  if (nv <= 4) return vec_kernel<Tin, 32, 4>();
  if (nv <= 6) return vec_kernel<Tin, 32, 6>();
  if (nv <= 8) return vec_kernel<Tin, 32, 8>();
  if (nv <= 12) return vec_kernel<Tin, 32, 12>();
  return vec_kernel<Tin, 32, 16>();
}

// What a launch needs to know of its card: the SM count, and the CTAs an SM holds of each
// kernel at each dynamic shared memory size, found on first use and kept. Guarded by a mutex:
// ctypes releases the GIL, so two host threads may launch at once.
static std::map<int, int> ln_sms;
static std::map<std::tuple<int, const void*, size_t>, int> ln_per_sm;
static std::mutex ln_mu;

static cudaError_t resident_ctas(int dev, const void* kern, size_t smem, long long* ctas) {
  std::lock_guard<std::mutex> lock(ln_mu);
  auto sms = ln_sms.find(dev);
  if (sms == ln_sms.end()) {
    int s = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms = ln_sms.emplace(dev, s).first;
  }
  const auto key = std::make_tuple(dev, kern, smem);
  auto per = ln_per_sm.find(key);
  if (per == ln_per_sm.end()) {
    int found = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&found, kern, LN_THREADS, smem);
    if (err != cudaSuccess) return err;
    per = ln_per_sm.emplace(key, found > 0 ? found : 1).first;
  }
  *ctas = (long long)sms->second * per->second;
  return cudaSuccess;
}

template <typename Tin>
static cudaError_t launch(const Tin* x, const float* w, const float* b, __nv_bfloat16* y,
                          long long rows, int C, float eps, int dev, cudaStream_t stream) {
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)b | (uintptr_t)y) & 15) == 0;
  int G = 0;
  const void* kern = aligned ? pick_vec<Tin>(C, &G) : nullptr;
  size_t smem = 0;
  long long rows_per_cta = LN_THREADS / 32;
  if (kern) {
    smem = 2 * (size_t)C * sizeof(float);  // w and b
    rows_per_cta = LN_THREADS / G;
  } else {
    kern = (const void*)ln_fwd_scalar_kernel<Tin>;
  }
  long long ctas = 0;
  cudaError_t err = resident_ctas(dev, kern, smem, &ctas);
  if (err != cudaSuccess) return err;
  const long long need = (rows + rows_per_cta - 1) / rows_per_cta;
  const dim3 grid((unsigned)(need < ctas ? need : ctas));
  void* args[] = {(void*)&x, (void*)&w, (void*)&b, (void*)&y, (void*)&rows, (void*)&C,
                  (void*)&eps};
  err = cudaLaunchKernel(kern, grid, dim3(LN_THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int ln_fwd(const void* x, const void* w, const void* b, void* y, long long rows,
                      int C, float eps, int x_is_bf16, int device, void* stream) {
  if (rows < 0 || C < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16)
    err = launch((const __nv_bfloat16*)x, (const float*)w, (const float*)b,
                 (__nv_bfloat16*)y, rows, C, eps, device, s);
  else
    err = launch((const float*)x, (const float*)w, (const float*)b, (__nv_bfloat16*)y, rows, C,
                 eps, device, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
