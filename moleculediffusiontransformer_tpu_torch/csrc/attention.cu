// Softmax attention with the whole K and V of a (batch, head) resident on
// the SM, for Hopper (sm_90a).  Replaces the two Pallas TPU kernels of
// moleculediffusiontransformer_tpu/ops/attention.py:
//
//   attn_forward         _attention_kernel         (:37)  K9
//   attn_packed_forward  _packed_attention_kernel  (:96)  K10
//
// Both compute o = softmax(q k^T * scale) v for q, o (bh, n, d) and k, v
// (bh, m, d), contiguous, float32 or bfloat16, d in 8, 16, 32, 64, 128.  The
// rounding points are the Pallas kernels': q and k widened to float32, the
// scores float32 and scaled after the product, a single-pass softmax (row
// max, exp, row sum), p / sum rounded to v's type before the product with v,
// that product accumulated in float32, one rounding to q's type.
//
// Bound: bytes.  Each element of q, k and v takes part in at most 2 max(n, m)
// operations, and these kernels exist for short n and m, so a call moves its
// tensors once and does little with them.  Every input is read from device
// memory once; scores and probabilities never leave the SM.  The host
// (ops/attention.py::plan) picks one of three routes and its block shape and
// passes them in; the entries check the plan against the shape.
//
// Route 0, rows (up to a few query rows, either type, any d).  A team of
// lanes owns one (batch-head, group of query rows).  Lane (r, c) of a team
// reads chunk c (16 bytes) of K and V rows r, r + lanes/CH, ... straight
// into registers: all of its K and V loads are issued before the first score
// is used, with no shared memory, no staging and no block barrier.  A score
// is the lane's 16-byte dot product summed over the CH lanes of its row by
// shuffles; the row max and sum are shuffles over the team's other lanes;
// p . v is a per-lane partial sum met by the same shuffles.  K and V stay in
// registers for all the team's query rows.  Short K and V take part of a
// warp (several teams a warp, so that its lanes load and work); where one
// warp would hold more than ROW_CHUNKS chunks of K and of V (d 64 and 128 at
// m 64, long m), the key rows are split over several warps, which are then
// the whole block and meet through a small shared buffer, in a fixed order.
//
// Route 1, tiles (16 query rows and more, bfloat16, d >= 16).  A warp owns
// 16 query rows, a block up to 64.  Q, K and V are staged once a block in
// bfloat16 into swizzled shared memory by `cp.async`, K's and V's copies in
// flight together; the wait on V comes only before p . v.  Both products run
// on `mma.sync` m16n8k16 through the fragments of the flash kernels
// (flash_attention_tc.cuh).  Scores stay in registers up to m 256; past
// that, two passes over the resident K: the row max and sum (the sum rescaled
// where a later chunk raises the max), then p recomputed and rounded exactly
// as the single pass rounds it.  Key rows past m are masked to -inf, and
// their staged rows are copies of row m - 1, so that a zero p never meets a
// non-finite value.
//
// Route 2, CUDA-core tiles (the first design, for float32 and d 8 past the row
// route, and for long m): one block per (batch-head, tile of up to 16 query
// rows); K, then V in its place, staged as float32 with a padded row, a warp
// carrying four query rows.  float32 stays on the CUDA cores everywhere, as
// the JAX kernel pins float32 products to HIGHEST: no TF32.
//
// Each output element is written once by one thread and every sum has a
// fixed order: two calls give the same bits.
#include "flash_attention_tc.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int SHARED_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ERR_SHARED = -2;
constexpr int ERR_PLAN = -3;

enum Route { ROUTE_ROWS = 0, ROUTE_TILES = 1, ROUTE_CUDA_TILES = 2 };

// ---------------------------------------------------------------- shared

// A probability as the p.v product sees it: rounded to v's type.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// ---------------------------------------------------------------- route 0

// 16 bytes of T: their element count, their widening to float32 and their
// narrowing from it.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// An opaque copy of `w`: a widening written after it is done where it
// stands, not hoisted out of the query-row loop into registers that would
// hold all of K and V twice.
__device__ __forceinline__ uint32_t opaque(uint32_t w) {
  asm volatile("" : "+r"(w));
  return w;
}

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float (&f)[8]) {
    const uint32_t w[4] = {opaque(r.x), opaque(r.y), opaque(r.z), opaque(r.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
    return make_uint4(tc::pack2(f[0], f[1]), tc::pack2(f[2], f[3]), tc::pack2(f[4], f[5]),
                      tc::pack2(f[6], f[7]));
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Route 0.  A team is `lanes` lanes (CH .. 32, a power of two) of each of
// `team_warps` warps; a warp holds 32 / lanes teams, and a team of several
// warps (lanes 32) is the whole block.  Team `team` of block b owns item
// b * teams + team = (batch-head hb, query rows r0 .. r0 + rows - 1).  Lane
// (rl, c) of warp tw of the team holds chunk c of key rows first + t * RPG,
// t < NT (RPG = lanes / CH rows a load), of K in kr[t] and of V in vr[t].
// Items past the last are computed on the last one's inputs and not stored,
// so that every lane of a warp takes part in its shuffles.  `red`
// (team_warps > 1): 2 team_warps + team_warps D floats, the maxima, sums and
// p.v partials of the block's warps.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(256, 1) row_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int items, int groups, int n, int m, int rows, int team_warps, int lanes, float scale) {
  using C = Chunk<T>;
  constexpr int VEC = C::N, CH = D / VEC;
  extern __shared__ float red[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = 32 / lanes;
  const int tw = warp % team_warps;
  const int teams = (blockDim.x >> 5) / team_warps * per_warp;
  const int item = blockIdx.x * teams + warp / team_warps * per_warp + lane / lanes;
  const bool live = item < items;
  const int it = live ? item : items - 1;
  const long long hb = it / groups;
  const int r0 = it % groups * rows;
  const int count = min(rows, n - r0);
  const int gl = lane % lanes, c = gl % CH, rl = gl / CH;
  const int rpg = lanes / CH;
  const int first = tw * NT * rpg + rl;

  const T* qp = q + (hb * n + r0) * D + c * VEC;
  uint4 qr = load16(qp);
  uint4 kr[NT], vr[NT];
  const T* kp = k + hb * m * D + c * VEC;
  const T* vp = v + hb * m * D + c * VEC;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int j = first + t * rpg;
    kr[t] = j < m ? load16(kp + (long long)j * D) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int j = first + t * rpg;
    vr[t] = j < m ? load16(vp + (long long)j * D) : make_uint4(0, 0, 0, 0);
  }
  float* tmax = red;
  float* tsum = tmax + team_warps;
  float* tacc = tsum + team_warps;

  // `rows` passes in every team, so that the teams of a warp shuffle
  // together; a team's passes past its `count` rows redo its last row
  for (int i = 0; i < rows; ++i) {
    float qf[VEC];
    C::widen(qr, qf);
    if (i + 1 < rows) qr = load16(qp + (long long)min(i + 1, count - 1) * D);
    float s[NT];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float kf[VEC];
      C::widen(kr[t], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
      for (int off = 1; off < CH; off <<= 1) dot += __shfl_xor_sync(FULL, dot, off);
      s[t] = first + t * rpg < m ? dot * scale : -INFINITY;
      mx = fmaxf(mx, s[t]);
    }
    for (int off = CH; off < lanes; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    if (team_warps > 1) {
      if (lane == 0) tmax[tw] = mx;
      __syncthreads();
      mx = tmax[0];
      for (int w = 1; w < team_warps; ++w) mx = fmaxf(mx, tmax[w]);
    }
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      s[t] = expf(s[t] - mx);
      sum += s[t];
    }
    for (int off = CH; off < lanes; off <<= 1) sum += __shfl_xor_sync(FULL, sum, off);
    if (team_warps > 1) {
      if (lane == 0) tsum[tw] = sum;
      __syncthreads();
      sum = tsum[0];
      for (int w = 1; w < team_warps; ++w) sum += tsum[w];
    }
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float p = round_to<T>(s[t] / sum);
      float vf[VEC];
      C::widen(vr[t], vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    for (int off = CH; off < lanes; off <<= 1)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(FULL, acc[e], off);
    if (team_warps > 1) {
      if (rl == 0)
#pragma unroll
        for (int e = 0; e < VEC; ++e) tacc[tw * D + c * VEC + e] = acc[e];
      __syncthreads();
      if (tw == 0 && rl == 0)
        for (int w = 1; w < team_warps; ++w)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += tacc[w * D + c * VEC + e];
    }
    if (live && i < count && tw == 0 && rl == 0)
      *reinterpret_cast<uint4*>(o + (hb * n + r0 + i) * D + c * VEC) = C::narrow(acc);
  }
}

// ---------------------------------------------------------------- route 1

// Key rows route 1 stages for m keys: 16, 32 or 64 for one chunk of 2, 4 or
// 8 n8 tiles kept in registers; m rounded up to 64 for two or four chunks
// (m <= 128, m <= 256) or for the two-pass kernel (m > 256).
__host__ __device__ inline int tile_kv_rows(int m) {
  if (m <= 16) return 16;
  if (m <= 32) return 32;
  return (m + 63) / 64 * 64;
}

// Scale the warp's score tile (chunk base `key0`, NT n8 tiles, rows g and g
// + 8 of the thread) and mask keys past m to -inf; returns the two rows'
// maxima over the tile, met over the quad.
template <int NT>
__device__ __forceinline__ void scale_mask(float (&s)[NT][4], int key0, int m, float scale,
                                           int lane, float& mx0, float& mx1) {
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int key = key0 + j * 8 + 2 * t4;
    s[j][0] = key < m ? s[j][0] * scale : -INFINITY;
    s[j][1] = key + 1 < m ? s[j][1] * scale : -INFINITY;
    s[j][2] = key < m ? s[j][2] * scale : -INFINITY;
    s[j][3] = key + 1 < m ? s[j][3] * scale : -INFINITY;
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// exp(s - max) in place; returns the two rows' sums over the tile, met over
// the quad in a fixed order.
template <int NT>
__device__ __forceinline__ void exp_sum(float (&s)[NT][4], float mx0, float mx1, float& sum0,
                                        float& sum1) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = expf(s[j][0] - mx0); s[j][1] = expf(s[j][1] - mx0);
    s[j][2] = expf(s[j][2] - mx1); s[j][3] = expf(s[j][3] - mx1);
    a += s[j][0] + s[j][1];
    b += s[j][2] + s[j][3];
  }
  sum0 = quad_sum(a);
  sum1 = quad_sum(b);
}

template <int NT>
__device__ __forceinline__ void normalise(float (&s)[NT][4], float sum0, float sum1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][0] / sum0; s[j][1] = s[j][1] / sum0;
    s[j][2] = s[j][2] / sum1; s[j][3] = s[j][3] / sum1;
  }
}

// Route 1.  Block (batch-head hb, tile of 16 x warps query rows).  Shared
// memory: Q (16 warps, D), K and V (kv_rows, D), bf16, swizzled.  KT chunks
// of NT n8 tiles of scores in registers; TWO: the two-pass kernel, one chunk
// of 8 tiles at a time.
template <int D, int KT, int NT, bool TWO>
__global__ void __launch_bounds__(128) tile_kernel(const tc::bf16* __restrict__ q,
                                                   const tc::bf16* __restrict__ k,
                                                   const tc::bf16* __restrict__ v,
                                                   tc::bf16* __restrict__ o, int n, int m,
                                                   int tiles, float scale) {
  using namespace tc;
  constexpr int CHK = D / 8;   // 16-byte chunks a row
  constexpr int CHUNK = NT * 8;
  extern __shared__ __align__(16) unsigned char raw[];
  const int warps = blockDim.x >> 5, R = warps * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_rows = tile_kv_rows(m);
  bf16* Qs = reinterpret_cast<bf16*>(raw);
  bf16* Ks = Qs + R * D;
  bf16* Vs = Ks + kv_rows * D;
  const long long hb = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * R;
  const bf16* qb = q + hb * n * D;
  const bf16* kb = k + hb * m * D;
  const bf16* vb = v + hb * m * D;

  for (int idx = threadIdx.x; idx < R * CHK; idx += blockDim.x) {
    const int r = idx / CHK, c = idx % CHK;
    cp_async16(Qs + swz<D>(r, c), qb + (long long)min(row0 + r, n - 1) * D + c * 8);
  }
  for (int idx = threadIdx.x; idx < kv_rows * CHK; idx += blockDim.x) {
    const int r = idx / CHK, c = idx % CHK;
    cp_async16(Ks + swz<D>(r, c), kb + (long long)min(r, m - 1) * D + c * 8);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < kv_rows * CHK; idx += blockDim.x) {
    const int r = idx / CHK, c = idx % CHK;
    cp_async16(Vs + swz<D>(r, c), vb + (long long)min(r, m - 1) * D + c * 8);
  }
  cp_async_commit();
  cp_async_wait<1>();   // Q and K
  __syncthreads();

  OwnedRows<D> a;
  a.init(Qs, warp * 16, lane);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if constexpr (!TWO) {
    float s[KT][NT][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      if (c * CHUNK >= m) continue;   // all masked: never read
      product_abt<D, NT>(s[c], a, Ks + c * CHUNK * D, lane);
      scale_mask<NT>(s[c], c * CHUNK, m, scale, lane, mx0, mx1);
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      if (c * CHUNK >= m) continue;
      float a0, a1;
      exp_sum<NT>(s[c], mx0, mx1, a0, a1);
      sum0 += a0;
      sum1 += a1;
    }
    cp_async_wait<0>();   // V
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      if (c * CHUNK >= m) continue;
      normalise<NT>(s[c], sum0, sum1);
      uint32_t p[NT / 2][4];
      to_a_frags<NT>(p, s[c]);
      product_ab<D, NT>(acc, p, Vs + c * CHUNK * D, lane);
    }
  } else {
    const int chunks = (m + CHUNK - 1) / CHUNK;
    float mx0 = -INFINITY, mx1 = -INFINITY, sum0 = 0.f, sum1 = 0.f;
    for (int c = 0; c < chunks; ++c) {
      float s[NT][4];
      product_abt<D, NT>(s, a, Ks + c * CHUNK * D, lane);
      float c0 = -INFINITY, c1 = -INFINITY;
      scale_mask<NT>(s, c * CHUNK, m, scale, lane, c0, c1);
      c0 = fmaxf(mx0, quad_max(c0));
      c1 = fmaxf(mx1, quad_max(c1));
      sum0 *= expf(mx0 - c0);   // 0 on the first chunk: exp(-inf)
      sum1 *= expf(mx1 - c1);
      mx0 = c0;
      mx1 = c1;
      float a0, a1;
      exp_sum<NT>(s, mx0, mx1, a0, a1);
      sum0 += a0;
      sum1 += a1;
    }
    cp_async_wait<0>();   // V
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      float s[NT][4];
      product_abt<D, NT>(s, a, Ks + c * CHUNK * D, lane);
      float c0 = -INFINITY, c1 = -INFINITY;
      scale_mask<NT>(s, c * CHUNK, m, scale, lane, c0, c1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = expf(s[j][0] - mx0) / sum0; s[j][1] = expf(s[j][1] - mx0) / sum0;
        s[j][2] = expf(s[j][2] - mx1) / sum1; s[j][3] = expf(s[j][3] - mx1) / sum1;
      }
      uint32_t p[NT / 2][4];
      to_a_frags<NT>(p, s);
      product_ab<D, NT>(acc, p, Vs + c * CHUNK * D, lane);
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int r = row0 + warp * 16 + g;
  bf16* out = o + (hb * n + r) * (long long)D + 2 * t4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r < n) *reinterpret_cast<uint32_t*>(out + 8 * j) = pack2(acc[j][0], acc[j][1]);
    if (r + 8 < n)
      *reinterpret_cast<uint32_t*>(out + 8LL * D + 8 * j) = pack2(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------- route 2

constexpr int RPW = 4;         // query rows a warp carries at once
constexpr int MAX_WARPS = 4;   // warps a block, so tiles of <= 16 rows

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]);

template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// `rows` rows of D elements at `src` -> dst[r * ld + k] as float32, by the
// `count` threads of which this one is `tid`; four elements a load.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int rows, int tid,
                                      int count) {
  constexpr int Q = D / 4;
  for (int idx = tid; idx < rows * Q; idx += count) {
    const int r = idx / Q, kq = idx % Q;
    float v[4];
    load4<T>(src + (long long)r * D + kq * 4, v);
    float* p = dst + r * ld + kq * 4;
    p[0] = v[0]; p[1] = v[1]; p[2] = v[2]; p[3] = v[3];
  }
}

// The query rows of a pass: `rows` real ones, zeros up to `all`.
template <typename T, int D>
__device__ __forceinline__ void stage_queries(float* dst, const T* src, int rows, int all, int tid,
                                              int count) {
  stage<T, D>(dst, D, src, rows, tid, count);
  for (int idx = rows * D + tid; idx < all * D; idx += count) dst[idx] = 0.f;
}

// s[i] = q_i . k_j for the warp's four query rows `Qw` (stride D) and the K
// row `kr`: one K value from shared memory feeds four products.
template <int D>
__device__ __forceinline__ void dot_rows(float (&s)[RPW], const float* Qw, const float* kr) {
#pragma unroll
  for (int i = 0; i < RPW; ++i) s[i] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    const float kv = kr[kk];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = fmaf(Qw[i * D + kk], kv, s[i]);
  }
}

// out[i][c] = sum_j P[i * ldp + j] * Vs[j * D + c] for the warp's four rows,
// of which the first `valid` are written.  With D >= 32 a lane owns columns
// lane, lane + 32, ...; with D < 32 the 32 / D lane groups split the j range
// and their partial sums meet by shuffles, so no lane idles on a short row.
template <typename T, int D>
__device__ __forceinline__ void pv_rows(T* out, const float* P, int ldp, const float* Vs, int m,
                                        int valid, int lane) {
  constexpr int CPL = D >= 32 ? D / 32 : 1;   // columns a lane
  constexpr int JG = D >= 32 ? 1 : 32 / D;    // lane groups over j
  constexpr int W = D >= 32 ? 32 : D;
  const int c0 = lane % W, g = lane / W;
  float acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  for (int j = g; j < m; j += JG) {
    float vv[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) vv[c] = Vs[j * D + c0 + 32 * c];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float p = P[i * ldp + j];
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
    }
  }
  if (JG > 1) {
#pragma unroll
    for (int off = W; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < RPW; ++i) acc[i][0] += __shfl_xor_sync(FULL, acc[i][0], off);
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      if (i < valid)
#pragma unroll
        for (int c = 0; c < CPL; ++c) store1(out + (long long)i * D + c0 + 32 * c, acc[i][c]);
  }
}

// Route 2.  Block (batch-head hb, tile) of blockDim.x / 32 warps and R = 4
// warps' rows; shared memory: KV m x (D + 1), Qs R x D, Ps R x m floats.  K
// is staged with a row stride of D + 1 floats (lane j reads row j: no bank
// conflicts), the tile's scores go to shared memory, each row's softmax is
// done by the warp that owns it, then V takes K's place.
template <typename T, int D>
__global__ void cuda_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ o, int n, int m,
                                 int tiles, float scale) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, count = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int R = (count >> 5) * RPW;
  const long long hb = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * R;
  const int rows = min(R, n - row0);
  float* KV = smem;
  float* Qs = KV + m * (D + 1);
  float* Ps = Qs + R * D;

  stage<T, D>(KV, D + 1, k + hb * m * D, m, tid, count);
  stage_queries<T, D>(Qs, q + (hb * n + row0) * D, rows, R, tid, count);
  __syncthreads();

  const int r0 = warp * RPW;
  const float* Qw = Qs + r0 * D;
  float* Pw = Ps + r0 * m;
  for (int j = lane; j < m; j += 32) {
    float s[RPW];
    dot_rows<D>(s, Qw, KV + j * (D + 1));
#pragma unroll
    for (int i = 0; i < RPW; ++i) Pw[i * m + j] = s[i] * scale;
  }
  __syncwarp();
  for (int i = 0; i < RPW && r0 + i < rows; ++i) {
    float* pr = Pw + i * m;
    float mx = -INFINITY;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, pr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < m; j += 32) pr[j] = round_to<T>(pr[j] / sum);
  }
  __syncthreads();   // every warp is done with K: V takes its place
  stage<T, D>(KV, D, v + hb * m * D, m, tid, count);
  __syncthreads();
  pv_rows<T, D>(o + (hb * n + row0 + r0) * D, Pw, m, KV, m, rows - r0, lane);
}

// ---------------------------------------------------------------- host

// The block shape the host chose (ops/attention.py::plan): grid size,
// warps a block, query rows a team (route 0) or a block (routes 1, 2), warps
// a team, lanes a team uses in each of them and 16-byte chunks a lane (route
// 0), shared bytes.
struct Plan {
  long long blocks;
  int warps, rows, team_warps, lanes, chunks, shared;
};

inline int launch_check(int shared, const void* kernel) {
  if (shared > SHARED_LIMIT) return ERR_SHARED;
  if (shared > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  return 0;
}

template <typename T, int D, int NT>
int launch_rows(const void* q, const void* k, const void* v, void* o, int items, int groups,
                int n, int m, const Plan& p, float scale, cudaStream_t s) {
  auto kernel = row_kernel<T, D, NT>;
  if (int err = launch_check(p.shared, (const void*)kernel)) return err;
  kernel<<<(unsigned)p.blocks, p.warps * 32, (size_t)p.shared, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, items, groups, n, m, p.rows, p.team_warps,
      p.lanes, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int rows_route(const void* q, const void* k, const void* v, void* o, long long bh, int n, int m,
               const Plan& p, float scale, cudaStream_t s) {
  constexpr int CH = D / Chunk<T>::N;
  if (p.team_warps < 1 || p.warps < 1 || p.warps > 8 || p.warps % p.team_warps) return ERR_PLAN;
  if (p.lanes < CH || p.lanes > 32 || (p.lanes & (p.lanes - 1))) return ERR_PLAN;
  // a team of several warps takes whole warps and is the block
  if (p.team_warps > 1 && (p.lanes != 32 || p.warps != p.team_warps)) return ERR_PLAN;
  const int teams = p.warps / p.team_warps * (32 / p.lanes);
  const int rpg = p.lanes / CH;
  if (p.chunks < 1 || p.chunks > 8 || (long long)p.chunks * rpg * p.team_warps < m ||
      (long long)p.chunks * rpg * (p.team_warps - 1) >= m || p.rows < 1)
    return ERR_PLAN;
  const int groups = (n + p.rows - 1) / p.rows;
  const long long items = bh * groups;
  if (items > 0x7fffffffLL || p.blocks < 1 || p.blocks * teams < items ||
      (p.blocks - 1) * teams >= items)
    return ERR_PLAN;
  if (p.shared != (p.team_warps > 1 ? 4 * p.team_warps * (2 + D) : 0)) return ERR_PLAN;
  const int it = (int)items;
  switch (p.chunks) {
    case 1: return launch_rows<T, D, 1>(q, k, v, o, it, groups, n, m, p, scale, s);
    case 2: return launch_rows<T, D, 2>(q, k, v, o, it, groups, n, m, p, scale, s);
    case 3: return launch_rows<T, D, 3>(q, k, v, o, it, groups, n, m, p, scale, s);
    case 4: return launch_rows<T, D, 4>(q, k, v, o, it, groups, n, m, p, scale, s);
    case 5: return launch_rows<T, D, 5>(q, k, v, o, it, groups, n, m, p, scale, s);
    case 6: return launch_rows<T, D, 6>(q, k, v, o, it, groups, n, m, p, scale, s);
    case 7: return launch_rows<T, D, 7>(q, k, v, o, it, groups, n, m, p, scale, s);
    case 8: return launch_rows<T, D, 8>(q, k, v, o, it, groups, n, m, p, scale, s);
    default: return ERR_PLAN;
  }
}

template <int D, int KT, int NT, bool TWO>
int launch_tiles(const void* q, const void* k, const void* v, void* o, int n, int m, int tiles,
                 const Plan& p, float scale, cudaStream_t s) {
  auto kernel = tile_kernel<D, KT, NT, TWO>;
  if (int err = launch_check(p.shared, (const void*)kernel)) return err;
  kernel<<<(unsigned)p.blocks, p.warps * 32, (size_t)p.shared, s>>>(
      (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v, (tc::bf16*)o, n, m, tiles,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int tiles_route(const void* q, const void* k, const void* v, void* o, long long bh, int n, int m,
                const Plan& p, float scale, cudaStream_t s) {
  if constexpr (sizeof(T) != 2 || D < 16) {
    return ERR_PLAN;   // bfloat16 at d >= 16 only
  } else {
    if (p.warps < 1 || p.warps > 4 || p.rows != 16 * p.warps) return ERR_PLAN;
    const long long tiles = (n + p.rows - 1) / p.rows;
    if (p.blocks != bh * tiles || p.blocks > 0x7fffffffLL) return ERR_PLAN;
    if (p.shared != 2LL * D * (p.rows + 2LL * tile_kv_rows(m))) return ERR_PLAN;
    const int t = (int)tiles;
    if (m <= 16) return launch_tiles<D, 1, 2, false>(q, k, v, o, n, m, t, p, scale, s);
    if (m <= 32) return launch_tiles<D, 1, 4, false>(q, k, v, o, n, m, t, p, scale, s);
    if (m <= 64) return launch_tiles<D, 1, 8, false>(q, k, v, o, n, m, t, p, scale, s);
    if (m <= 128) return launch_tiles<D, 2, 8, false>(q, k, v, o, n, m, t, p, scale, s);
    if (m <= 256) return launch_tiles<D, 4, 8, false>(q, k, v, o, n, m, t, p, scale, s);
    return launch_tiles<D, 1, 8, true>(q, k, v, o, n, m, t, p, scale, s);
  }
}

template <typename T, int D>
int cuda_tiles_route(const void* q, const void* k, const void* v, void* o, long long bh, int n,
                     int m, const Plan& p, float scale, cudaStream_t s) {
  const int wanted = (n + RPW - 1) / RPW;
  if (p.warps != (wanted < MAX_WARPS ? wanted : MAX_WARPS) || p.rows != p.warps * RPW)
    return ERR_PLAN;
  const long long tiles = (n + p.rows - 1) / p.rows;
  if (p.blocks != bh * tiles || p.blocks > 0x7fffffffLL) return ERR_PLAN;
  if (p.shared != 4LL * ((long long)m * (D + 1) + (long long)p.rows * (D + m))) return ERR_PLAN;
  auto kernel = cuda_tile_kernel<T, D>;
  if (int err = launch_check(p.shared, (const void*)kernel)) return err;
  kernel<<<(unsigned)p.blocks, p.warps * 32, (size_t)p.shared, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n, m, (int)tiles, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int attention(const void* q, const void* k, const void* v, void* o, long long bh, int n, int m,
              float scale, int route, const Plan& p, cudaStream_t s) {
  if (route == ROUTE_ROWS) return rows_route<T, D>(q, k, v, o, bh, n, m, p, scale, s);
  if (route == ROUTE_TILES) return tiles_route<T, D>(q, k, v, o, bh, n, m, p, scale, s);
  if (route == ROUTE_CUDA_TILES) return cuda_tiles_route<T, D>(q, k, v, o, bh, n, m, p, scale, s);
  return ERR_PLAN;
}

// Calls fn<T, D>(args...) for the runtime (dtype, d); ERR_ARGS for a pair
// that has no kernel.
#define ATTN_DISPATCH_D(fn, T, d, ...)                  \
  do {                                                  \
    if ((d) == 8) return fn<T, 8>(__VA_ARGS__);         \
    if ((d) == 16) return fn<T, 16>(__VA_ARGS__);       \
    if ((d) == 32) return fn<T, 32>(__VA_ARGS__);       \
    if ((d) == 64) return fn<T, 64>(__VA_ARGS__);       \
    if ((d) == 128) return fn<T, 128>(__VA_ARGS__);     \
  } while (0)

inline int forward(const void* q, const void* k, const void* v, void* o, long long bh, int n,
                   int m, int d, float scale, int dtype, int route, const Plan& p, int device,
                   void* stream) {
  if (!q || !k || !v || !o || bh < 1 || n < 1 || m < 1) return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) ATTN_DISPATCH_D(attention, float, d, q, k, v, o, bh, n, m, scale, route, p, s);
  if (dtype == 1)
    ATTN_DISPATCH_D(attention, __nv_bfloat16, d, q, k, v, o, bh, n, m, scale, route, p, s);
  return ERR_ARGS;
}

}  // namespace

extern "C" {

// K9: o from q, k, v.  dtype 0 float32, 1 bfloat16; route and block shape
// from ops/attention.py::plan.
int attn_forward(const void* q, const void* k, const void* v, void* o, long long bh, int n, int m,
                 int d, float scale, int dtype, int route, long long blocks, int warps, int rows,
                 int team_warps, int lanes, int chunks, int shared, int device, void* stream) {
  const Plan p{blocks, warps, rows, team_warps, lanes, chunks, shared};
  return forward(q, k, v, o, bh, n, m, d, scale, dtype, route, p, device, stream);
}

// K10: the same function for n, m <= 64, the micro-shapes the TPU kernel
// packs several head-batches into one block for; here a block holds as many
// head-batches as the plan gives it.
int attn_packed_forward(const void* q, const void* k, const void* v, void* o, long long bh, int n,
                        int m, int d, float scale, int dtype, int route, long long blocks,
                        int warps, int rows, int team_warps, int lanes, int chunks, int shared,
                        int device, void* stream) {
  if (n > 64 || m > 64) return ERR_ARGS;
  const Plan p{blocks, warps, rows, team_warps, lanes, chunks, shared};
  return forward(q, k, v, o, bh, n, m, d, scale, dtype, route, p, device, stream);
}

const char* attn_error_string(int err) {
  if (err == ERR_ARGS) return "invalid arguments";
  if (err == ERR_SHARED) return "K and V do not fit a block's shared memory";
  if (err == ERR_PLAN) return "the block plan does not fit the shape";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
