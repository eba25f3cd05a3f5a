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
// What bounds it on the H100: device-memory bytes are small (0.047 ms at the training
// shape); what costs is summing d_value: 19.7 M in-range corners x D channels at the
// training shape, as f32 reductions at the L2. sm_90 has no f32 add on shared memory
// (atomicAdd on a shared or distributed-shared f32 compiles to a compare-and-swap loop,
// ATOMS.CAST.SPIN), so a cluster that held one (b, m)'s slice in distributed shared
// memory and summed every corner there ran several times slower than the L2's native
// vector reductions. What shared memory does well is integer atomics; the vec route
// uses them to merge, inside a CTA, the hits of its queries on one corner before
// a single reduction leaves the SM.
//
// Two routes, chosen by the wrapper from the shape alone (ops/ms_deform_attn.py:
// bwd_route):
//   vec    (D a power-of-two multiple of 8 up to 128): the thread layout of the
//          forward's vec route. D / 8 threads (a group) per (b, q, m), 8 channels each;
//          the cotangent slice is loaded once per (b, q, m); each sample's geometry is
//          computed once, by one thread of the group, and staged in shared memory; dot_c
//          is 8 in-thread FMAs; the per-sample sums (d_attn and the two slopes) are
//          reduced over the group with log2(D / 8) shuffles each. A CTA's groups are
//          neighbouring queries of one head (q fastest), whose samples often hit the
//          same corner. Per level, each in-range corner hit goes into a hash table in
//          shared memory keyed by its token (atomicCAS to claim a slot, atomicExch to
//          push the hit on the slot's list: native integer atomics); then one thread
//          per (slot, 8 channels) sums its hits' attn * w * g in f32 and adds the sum to
//          d_value with two 16-byte vector reductions (atomicAdd on float4, one
//          REDG.E.ADD.F32x4 each) into an f32 buffer that the wrapper zeroes and casts.
//          64 groups per CTA; fewer (down to a full warp) where the grid would not fill
//          two waves of the card, as for the decoder's 20 queries.
//   scalar (any other D): one warp per (b, q, m), lanes over channels, f32 atomics per
//          channel (the first port of this kernel).
// d_value is summed by atomics, in an order that varies from run to run.
//
// C interface (bound with ctypes): msda_bwd(...) launches on the given stream and
// returns cudaGetLastError() as an int.

#include "msda_common.cuh"

#define MSDA_MAX_GROUPS 64  // (b, q, m) per CTA
#define MSDA_SMEM_LIMIT 232448  // the shared memory a CTA may opt into on sm_90

// -------------------------------------------------------------------- vec route
// Per group and sample: {int4 corner tokens, int4 {fx, fy, attn, inside bits}}.
struct StagedSample {
  int4 src, geo;
};

// One CTA serves G groups (G * D / 8 threads): G neighbouring queries of one head, as
// groups run over (b, m, q) with q fastest (a CTA at the end of a head's queries spans
// two or more (b, m)). A hit's key is its token + S * (its (b, m) - the CTA's first).
// Shared memory: the staged samples (G * P), a hash table of 2^tab_bits slots (key,
// list head), per hit of a level its next hit, its attn-scaled weight and the slots in
// use (G * P * 4 each), and the G cotangent slices.
template <typename T, typename A, int kP>
__global__ void __launch_bounds__(1024)
msda_bwd_vec_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const A* __restrict__ attn, const T* __restrict__ grad_out,
                    float* __restrict__ d_value, float* __restrict__ d_loc,
                    A* __restrict__ d_attn, int S, int M, int D, int Lq, int L, int P_rt,
                    Levels lv, int64_t groups, int tab_bits) {
  extern __shared__ int4 smem4[];
  const int P = kP ? kP : P_rt;
  const int T8 = D >> 3;  // threads per group
  const int t = threadIdx.x & (T8 - 1);
  const int grp = threadIdx.x / T8;
  const int G = blockDim.x / T8;
  const int nhit = G * P * 4;  // corner hits of one level
  const int tab = 1 << tab_bits;  // hash slots, at least 2 * nhit
  StagedSample* rec = reinterpret_cast<StagedSample*>(smem4) + grp * P;
  int* tab_key = reinterpret_cast<int*>(reinterpret_cast<StagedSample*>(smem4)
                                        + G * P);
  int* tab_head = tab_key + tab;
  int* hit_next = tab_head + tab;
  float* hit_aw = reinterpret_cast<float*>(hit_next + nhit);
  int* occ = reinterpret_cast<int*>(hit_aw + nhit);  // the slots in use, in claim order
  float* gtile = reinterpret_cast<float*>(occ + nhit);  // the CTA's cotangent slices
  __shared__ int n_occ;
  for (int i = threadIdx.x; i < tab; i += blockDim.x) {
    tab_key[i] = -1;
    tab_head[i] = -1;
  }
  if (threadIdx.x == 0) n_occ = 0;

  const int64_t gid0 = (int64_t)blockIdx.x * G;
  const int64_t gid_raw = gid0 + grp;
  const bool active = gid_raw < groups;
  const int64_t gid = active ? gid_raw : groups - 1;
  const int bm0 = (int)(gid0 / Lq);
  const int bm = (int)(gid / Lq);
  const int m = bm % M, b = bm / M;
  const int64_t bqm = ((int64_t)b * Lq + (int)(gid % Lq)) * M + m;
  const int64_t row = (int64_t)M * D;
  const T* vb = value + (int64_t)b * S * row + (int64_t)m * D + 8 * t;
  const float* lp = loc + bqm * L * P * 2;
  const A* ap = attn + bqm * L * P;
  float* dlp = d_loc + bqm * L * P * 2;
  A* dap = d_attn + bqm * L * P;
  float g[8];
  load8(grad_out + bqm * D + 8 * t, g);
#pragma unroll
  for (int j = 0; j < 8; ++j) gtile[grp * D + 8 * t + j] = g[j];
  __syncthreads();  // the table is empty before the first insert

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l], st = lv.start[l];
    for (int p = t; p < P; p += T8) {  // each sample's geometry, once per group
      const int k = l * P + p;
      const float2 xy = *reinterpret_cast<const float2*>(lp + 2 * k);
      const float a = to_f32(ap[k]);
      const Sample s = bilinear_sample(xy.x, xy.y, H, W);
      StagedSample r;
      r.src = make_int4(st + s.tok[0], st + s.tok[1], st + s.tok[2], st + s.tok[3]);
      r.geo = make_int4(__float_as_int(s.fx), __float_as_int(s.fy), __float_as_int(a),
                        (int)s.inside);
      rec[p] = r;
      float w[4];
      corner_weights(s, w);
      for (int c = 0; c < 4; ++c) {  // the sample's hits go into the CTA's table
        if (!(active && (s.inside & (1u << c)))) continue;
        const int h = (grp * P + p) * 4 + c;
        hit_aw[h] = w[c] * a;
        const int key = st + s.tok[c] + S * (bm - bm0);
        unsigned slot = ((unsigned)key * 2654435761u) >> (32 - tab_bits);
        for (;;) {  // linear probing; the table is at least twice the level's hits
          const int prev = atomicCAS(tab_key + slot, -1, key);
          if (prev == -1) occ[atomicAdd(&n_occ, 1)] = slot;
          if (prev == -1 || prev == key) break;
          slot = (slot + 1) & (tab - 1);
        }
        hit_next[h] = atomicExch(tab_head + slot, h);
      }
    }
    __syncthreads();  // the staging and the table hold the whole level
#pragma unroll
    for (int p = 0; p < (kP ? kP : P); ++p) {
      const StagedSample r = rec[p];
      const int src[4] = {r.src.x, r.src.y, r.src.z, r.src.w};
      const float fx = __int_as_float(r.geo.x), fy = __int_as_float(r.geo.y);
      const float a = __int_as_float(r.geo.z);
      const unsigned inside = (unsigned)r.geo.w;
      const float wx[2] = {1.f - fx, fx}, wy[2] = {1.f - fy, fy};
      float s_w = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!(active && (inside & (1u << c)))) continue;  // uniform over the group
        const int cy = c >> 1, cx = c & 1;
        const float w = wy[cy] * wx[cx];
        float v[8];
        load8(vb + (int64_t)src[c] * row, v);
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dot += v[j] * g[j];
        s_w += w * dot;
        s_x += (cx ? wy[cy] : -wy[cy]) * dot;  // dw/dx
        s_y += (cy ? wx[cx] : -wx[cx]) * dot;  // dw/dy
      }
      for (int o = T8 >> 1; o > 0; o >>= 1) {
        s_w += __shfl_xor_sync(0xffffffffu, s_w, o);
        s_x += __shfl_xor_sync(0xffffffffu, s_x, o);
        s_y += __shfl_xor_sync(0xffffffffu, s_y, o);
      }
      if (active && (p & (T8 - 1)) == t) {
        const int k = l * P + p;
        dap[k] = from_f32<A>(s_w);
        dlp[2 * k] = a * (float)W * s_x;
        dlp[2 * k + 1] = a * (float)H * s_y;
      }
    }
    // one thread per (slot, 8 channels): the slot's hits summed, one vector reduction
    const int nocc = n_occ;
    for (int i = threadIdx.x; i < nocc * T8; i += blockDim.x) {
      const int slot = occ[i / T8], j = i & (T8 - 1);
      int h = tab_head[slot];
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      do {
        const float aw = hit_aw[h];
        const float* gq = gtile + (h / (P * 4)) * D + 8 * j;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += aw * gq[e];
        h = hit_next[h];
      } while (h >= 0);
      const int key = tab_key[slot];
      const int dbm = key / S, tok = key - dbm * S;
      const int bmk = bm0 + dbm;
      float4* cell = reinterpret_cast<float4*>(
          d_value + ((int64_t)(bmk / M) * S + tok) * row + (int64_t)(bmk % M) * D + 8 * j);
      atomicAdd(cell, make_float4(acc[0], acc[1], acc[2], acc[3]));
      atomicAdd(cell + 1, make_float4(acc[4], acc[5], acc[6], acc[7]));
    }
    __syncthreads();  // the level's table and staging are read
    for (int i = threadIdx.x; i < nocc; i += blockDim.x) {
      tab_key[occ[i]] = -1;
      tab_head[occ[i]] = -1;
    }
    if (threadIdx.x == 0) n_occ = 0;
    __syncthreads();  // the table is empty for the next level
  }
}

// ----------------------------------------------------------------- scalar route
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
__global__ void msda_bwd_scalar_kernel(const T* __restrict__ value,
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
      const Sample s = bilinear_sample(lp[2 * k], lp[2 * k + 1], H, W);
      const float a = to_f32(ap[k]);
      const float wx[2] = {1.f - s.fx, s.fx}, wy[2] = {1.f - s.fy, s.fy};
      // per-lane parts of sum_c w_c*dot_c, sum_c dw_c/dx*dot_c, sum_c dw_c/dy*dot_c
      float s_w = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!(s.inside & (1u << c))) continue;  // uniform across the warp
        const int cy = c >> 1, cx = c & 1;
        const int64_t r = (int64_t)s.tok[c] * row;
        const float w = wy[cy] * wx[cx];
        const float dot = corner(vl + r, dvl + r, g, w * a, D, lane);
        s_w += w * dot;
        s_x += (cx ? wy[cy] : -wy[cy]) * dot;
        s_y += (cy ? wx[cx] : -wx[cx]) * dot;
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

// ------------------------------------------------------------------- launches
enum { ROUTE_VEC = 0, ROUTE_SCALAR = 1 };

// The vec route's plan for a shape: groups per CTA (64, halved while the grid would not
// fill two waves of 132 SMs, down to a full warp), hash-table size, shared memory.
struct VecPlan {
  int G, tab_bits;
  size_t smem;
};

static void size_plan(int G, int D, int P, VecPlan& vp) {
  const int nhit = G * P * 4;  // corner hits of one level
  vp.G = G;
  vp.tab_bits = 4;
  while ((1 << vp.tab_bits) < 2 * nhit) ++vp.tab_bits;
  vp.smem = (size_t)G * P * sizeof(StagedSample) + (size_t)2 * 4 * (1 << vp.tab_bits)
            + (size_t)3 * 4 * nhit + (size_t)4 * G * D;
}

// False unless the shape fits the route at 64 groups per CTA (the wrapper's rule).
static bool vec_plan(int D, int P, int64_t groups, VecPlan& vp) {
  const int T8 = D / 8;
  if (D % 8 != 0 || T8 < 1 || T8 > 16 || (T8 & (T8 - 1)) != 0 || P < 1) return false;
  size_plan(MSDA_MAX_GROUPS, D, P, vp);
  if (vp.smem > MSDA_SMEM_LIMIT) return false;
  const int g_min = 32 / T8 > 8 ? 32 / T8 : 8;
  int G = MSDA_MAX_GROUPS;
  while (G > g_min && (groups + G - 1) / G < 2 * 132) G /= 2;
  size_plan(G, D, P, vp);
  return true;
}

// Raises an instance's dynamic shared memory limit once per size it needs (the
// attribute belongs to the function on every card).
template <typename T, typename A, int kP>
static int allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(msda_bwd_vec_kernel<T, A, kP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return (int)e;
}

template <typename T, typename A>
static int launch(int route, const void* value, const void* loc, const void* attn,
                  const void* g, void* d_value, void* d_loc, void* d_attn,
                  int B, int S, int M, int D, int Lq, int L, int P, const Levels& lv,
                  cudaStream_t stream) {
  typedef const T* CT;
  if (route == ROUTE_VEC) {
    const int64_t groups = (int64_t)B * Lq * M;
    VecPlan vp;
    if (!vec_plan(D, P, groups, vp) || (int64_t)S * MSDA_MAX_GROUPS >= 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const int64_t blocks = (groups + vp.G - 1) / vp.G;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const unsigned threads = vp.G * (D / 8);
    int err;
    if (P == 4) {
      if ((err = allow_smem<T, A, 4>(vp.smem)) != 0) return err;
      msda_bwd_vec_kernel<T, A, 4><<<(unsigned)blocks, threads, vp.smem, stream>>>(
          (CT)value, (const float*)loc, (const A*)attn, (CT)g, (float*)d_value,
          (float*)d_loc, (A*)d_attn, S, M, D, Lq, L, P, lv, groups, vp.tab_bits);
    } else {
      if ((err = allow_smem<T, A, 0>(vp.smem)) != 0) return err;
      msda_bwd_vec_kernel<T, A, 0><<<(unsigned)blocks, threads, vp.smem, stream>>>(
          (CT)value, (const float*)loc, (const A*)attn, (CT)g, (float*)d_value,
          (float*)d_loc, (A*)d_attn, S, M, D, Lq, L, P, lv, groups, vp.tab_bits);
    }
  } else if (route == ROUTE_SCALAR) {
    const int64_t warps = (int64_t)B * Lq * M;
    const int threads = 256;  // 8 warps
    const int64_t blocks = (warps * 32 + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    msda_bwd_scalar_kernel<T, A><<<(unsigned)blocks, threads, 0, stream>>>(
        (CT)value, (const float*)loc, (const A*)attn, (CT)g, (float*)d_value, (float*)d_loc,
        (A*)d_attn, S, M, D, Lq, L, P, lv, warps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// d_value: float32 (B, S, M, D), zeroed by the caller; d_loc: float32 like loc; d_attn:
// like attn; grad_out: (B, Lq, M*D) in the value type. vec route: value, grad_out and
// d_value 16-byte aligned, loc 8-byte aligned.
extern "C" int msda_bwd(const void* value, const void* loc, const void* attn,
                        const void* grad_out, void* d_value, void* d_loc, void* d_attn,
                        int B, int S, int M, int D, int Lq, int L, int P,
                        const int* shapes,  // host array of L (H, W) pairs
                        int value_bf16, int attn_bf16, int route, void* stream) {
  Levels lv;
  if (!fill_levels(lv, shapes, L, S) || P < 1) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Lq * M * D == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
#define MSDA_BWD_ARGS route, value, loc, attn, grad_out, d_value, d_loc, d_attn, \
                      B, S, M, D, Lq, L, P, lv, s
  if (value_bf16)
    return attn_bf16 ? launch<bf, bf>(MSDA_BWD_ARGS) : launch<bf, float>(MSDA_BWD_ARGS);
  return attn_bf16 ? launch<float, bf>(MSDA_BWD_ARGS) : launch<float, float>(MSDA_BWD_ARGS);
#undef MSDA_BWD_ARGS
}
