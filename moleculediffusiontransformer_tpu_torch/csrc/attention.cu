// Softmax attention with the whole K and V of a (batch, head) resident in
// shared memory, for Hopper (sm_90a).  Replaces the two Pallas TPU kernels of
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
// operations, and these kernels exist for n and m of 1 ... 256, so a call
// moves its tensors once and does little with them.  What the designs do
// about it: every input is read from device memory exactly once, 8 or 16
// bytes a thread, into shared memory as float32; scores and probabilities
// never leave the block.
//
// K9 takes one block per (batch-head, tile of up to 16 query rows).  A warp
// carries four query rows at once, so a K or V value read from shared memory
// feeds four products.  K is staged with a row stride of d + 1 floats (lane j
// reads row j: no bank conflicts), the scores of the tile go to shared
// memory, each row's softmax is done by the warp that owns it with shuffles,
// then V takes K's place in the same buffer.  That halves the shared memory:
// 4 (m (d + 1) + 16 (d + m)) bytes must fit the 232,448 a block may opt
// into, which holds for m <= 386 at d 128 and m <= 704 at d 64.
//
// K10 is for n, m <= 64, where one problem cannot fill a block.  The TPU
// kernel packs G head-batches into one masked (G n, G m) product; the mask
// only zeroes what does not belong to a head-batch, so here each warp simply
// takes one head-batch: its K and V in its own slice of shared memory, the
// scores of four rows in registers (lane j holds columns j and j + 32),
// softmax by shuffles, no mask and no block-wide barrier.  A block holds up
// to 8 warps, fewer where 8 slices would not fit; tail warps leave at once.
//
// Each output element is written once by one thread and every sum has a
// fixed order: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int RPW = 4;              // query rows a warp carries at once
constexpr int MAX_WARPS = 4;        // K9: warps a block, so tiles of <= 16 rows
constexpr int PACK_WARPS = 8;       // K10: most head-batches a block
constexpr int PACK_MAX = 64;        // K10: longest n and m
constexpr int SHARED_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

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

// K9.  Block (batch-head hb, tile) of blockDim.x / 32 warps and R = 4 warps'
// rows; shared memory: KV m x (D + 1), Qs R x D, Ps R x m floats.
template <typename T, int D>
__global__ void attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

// K10.  Warp w of block b takes head-batch b * warps + w; its slice of
// `warp_floats` floats holds Ks m x (D + 1), Vs m x D, Qs 4 x D, Ps 4 x 64.
template <typename T, int D>
__global__ void packed_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, T* __restrict__ o, long long bh,
                                        int n, int m, int warp_floats, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long hb = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (hb >= bh) return;
  float* Ks = smem + (size_t)warp * warp_floats;
  float* Vs = Ks + m * (D + 1);
  float* Qs = Vs + m * D;
  float* Ps = Qs + RPW * D;

  stage<T, D>(Ks, D + 1, k + hb * m * D, m, lane, 32);
  stage<T, D>(Vs, D, v + hb * m * D, m, lane, 32);
  for (int row0 = 0; row0 < n; row0 += RPW) {
    const int rows = min(RPW, n - row0);
    __syncwarp();   // the last pass is done with Qs and Ps
    stage_queries<T, D>(Qs, q + (hb * n + row0) * D, rows, RPW, lane, 32);
    __syncwarp();
    float s[2][RPW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < m) {
        dot_rows<D>(s[h], Qs, Ks + j * (D + 1));
      } else {
#pragma unroll
        for (int i = 0; i < RPW; ++i) s[h][i] = 0.f;
      }
    }
    const bool has0 = lane < m, has1 = lane + 32 < m;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (i >= rows) break;   // the same for the whole warp
      const float s0 = has0 ? s[0][i] * scale : -INFINITY;
      const float s1 = has1 ? s[1][i] * scale : -INFINITY;
      const float mx = warp_max(fmaxf(s0, s1));
      const float e0 = has0 ? expf(s0 - mx) : 0.f;
      const float e1 = has1 ? expf(s1 - mx) : 0.f;
      const float sum = warp_sum(e0 + e1);
      Ps[i * PACK_MAX + lane] = round_to<T>(e0 / sum);
      Ps[i * PACK_MAX + lane + 32] = round_to<T>(e1 / sum);
    }
    __syncwarp();
    pv_rows<T, D>(o + (hb * n + row0) * D, Ps, PACK_MAX, Vs, m, rows, lane);
  }
}

constexpr int ERR_ARGS = -1;
constexpr int ERR_SHARED = -2;

// Dynamic shared memory above 48 KB must be asked for.
template <typename Kernel>
inline int opt_in(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int D>
int attention(const void* q, const void* k, const void* v, void* o, long long bh, int n, int m,
              float scale, cudaStream_t s) {
  const int wanted = (n + RPW - 1) / RPW;
  const int warps = wanted < MAX_WARPS ? wanted : MAX_WARPS;
  const int R = warps * RPW;
  const long long tiles = (n + R - 1) / R;
  if (bh * tiles > 0x7fffffffLL) return ERR_ARGS;
  const long long bytes = 4LL * ((long long)m * (D + 1) + (long long)R * D + (long long)R * m);
  if (bytes > SHARED_LIMIT) return ERR_SHARED;
  if (int err = opt_in(attention_kernel<T, D>, bytes)) return err;
  attention_kernel<T, D><<<(unsigned)(bh * tiles), warps * 32, (size_t)bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n, m, (int)tiles, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int packed_attention(const void* q, const void* k, const void* v, void* o, long long bh, int n,
                     int m, float scale, cudaStream_t s) {
  if (n > PACK_MAX || m > PACK_MAX) return ERR_ARGS;
  const int warp_floats = m * (D + 1) + m * D + RPW * D + RPW * PACK_MAX;
  long long warps = SHARED_LIMIT / (4LL * warp_floats);
  if (warps > PACK_WARPS) warps = PACK_WARPS;
  if (warps > bh) warps = bh;
  if (warps < 1) return ERR_SHARED;
  const long long blocks = (bh + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return ERR_ARGS;
  const long long bytes = 4LL * warp_floats * warps;
  if (int err = opt_in(packed_attention_kernel<T, D>, bytes)) return err;
  packed_attention_kernel<T, D><<<(unsigned)blocks, (int)warps * 32, (size_t)bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, bh, n, m, warp_floats, scale);
  return (int)cudaGetLastError();
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

#define ATTN_DISPATCH(fn, dtype, d, ...)                                      \
  do {                                                                        \
    if ((dtype) == 0) ATTN_DISPATCH_D(fn, float, d, __VA_ARGS__);             \
    if ((dtype) == 1) ATTN_DISPATCH_D(fn, __nv_bfloat16, d, __VA_ARGS__);     \
    return ERR_ARGS;                                                          \
  } while (0)

inline bool bad_args(const void* q, const void* k, const void* v, const void* o, long long bh,
                     int n, int m) {
  return !q || !k || !v || !o || bh < 1 || n < 1 || m < 1;
}

}  // namespace

extern "C" {

// K9: o from q, k, v.  dtype 0 float32, 1 bfloat16.
int attn_forward(const void* q, const void* k, const void* v, void* o, long long bh, int n, int m,
                 int d, float scale, int dtype, int device, void* stream) {
  if (bad_args(q, k, v, o, bh, n, m)) return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  ATTN_DISPATCH(attention, dtype, d, q, k, v, o, bh, n, m, scale, s);
}

// K10: the same function for n, m <= 64, one warp a head-batch.
int attn_packed_forward(const void* q, const void* k, const void* v, void* o, long long bh, int n,
                        int m, int d, float scale, int dtype, int device, void* stream) {
  if (bad_args(q, k, v, o, bh, n, m)) return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  ATTN_DISPATCH(packed_attention, dtype, d, q, k, v, o, bh, n, m, scale, s);
}

const char* attn_error_string(int err) {
  if (err == ERR_ARGS) return "invalid arguments";
  if (err == ERR_SHARED) return "K and V do not fit a block's shared memory";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
