// Streaming softmax attention for long sequences, forward and backward, for
// Hopper (sm_90a).  Replaces the three Pallas TPU kernels of
// moleculediffusiontransformer_tpu/ops/flash_attention.py:
//
//   fa_forward   _fwd_kernel  (:89)   o = softmax(q k^T * scale) v, and
//                                     optionally lse = m + log l per row
//   fa_backward  _dq_kernel   (:185)  dq = sum_kv ds k
//                _dkv_kernel  (:220)  dv = sum_q p^T do, dk = sum_q ds^T q
//                with p = exp(s - lse), ds = (do v^T - di) * p * scale
//
// q, do, o, dq are (bh, n, d); k, v, dk, dv (bh, m, d); lse and di (bh, n)
// float32; all contiguous.  n and m are multiples of 64, d is 16, 32, 64 or 128.
// Inputs are float32 or bfloat16 and are widened to float32 on their way into
// shared memory; scores, probabilities, the running max and normaliser and
// every accumulator are float32, and each output is rounded once, when it is
// written.  These are the Pallas kernels' rounding points.
//
// What the TPU grid carried from step to step in VMEM scratch (acc, m, l;
// dk_acc, dv_acc) is a loop inside one block here: the forward and the dq
// kernel take one block per (bh, 64 query rows) and sweep the KV tiles
// through shared memory, the dk/dv kernel one block per (bh, 64 KV rows) and
// sweeps the query tiles.  Each output tile is written once, by the block
// that owns it: no atomics, and two calls give the same bits.  di =
// rowsum(o * do) is not computed here: the caller hands it in, as
// `_bwd_pallas` computes it outside its kernels.
//
// Bound: operations.  At n = m = 4096, d = 64 the forward is 4 n m d flops a
// (batch, head) against 4 n d elements moved, ~2,000 flops a byte in bf16.
// The products here run on the CUDA cores: 256 threads hold a 64 x 64 (or
// 64 x d) float32 tile as 4 x 4 (4 x d/16) a thread and read both operands
// from shared memory as float4, the row operand broadcast within a
// half-warp.  That keeps the FMA pipe, not shared memory, the limit of the
// inner loop; the tensor cores (wgmma) and asynchronous copies (TMA) are
// what a faster version would add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int TILE = 64;       // query rows and KV rows of a tile
constexpr int THREADS = 256;   // 16 x 16: thread (ty, tx) owns rows ty*4..+3
constexpr int LDT = TILE + 4;  // row stride of a transposed (d, 64) tile

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

// 64 rows of D elements at `src` (row stride D) -> dst[row][D], float32.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src) {
  constexpr int Q = D / 4;
  for (int idx = threadIdx.x; idx < TILE * Q; idx += THREADS) {
    const int r = idx / Q, kq = idx % Q;
    float v[4];
    load4<T>(src + (long long)r * D + kq * 4, v);
    *reinterpret_cast<float4*>(dst + r * D + kq * 4) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The same rows transposed: dst[k][row], row stride LDT.  Four lanes read 32
// (bf16) or 64 (fp32) contiguous bytes of one row, eight rows a warp; the
// stores of a warp then fall on 16 banks.
template <typename T, int D>
__device__ __forceinline__ void load_rows_transposed(float* dst, const T* src) {
  constexpr int QH = D / 16;
  for (int idx = threadIdx.x; idx < TILE * (D / 4); idx += THREADS) {
    const int kq_l = idx & 3, r_l = (idx >> 2) & 7, rest = idx >> 5;
    const int kq = (rest % QH) * 4 + kq_l, r = (rest / QH) * 8 + r_l;
    float v[4];
    load4<T>(src + (long long)r * D + kq * 4, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(kq * 4 + e) * LDT + r] = v[e];
  }
}

// Columns of thread tx in a 64 x (16 * CO) product: groups of VEC = min(CO, 4)
// neighbours, group g at g * 16 * VEC + tx * VEC.
template <int CO>
struct Cols {
  static constexpr int VEC = CO >= 4 ? 4 : CO;
  static constexpr int NG = CO / VEC;
  __device__ static __forceinline__ int at(int tx, int g) { return g * 16 * VEC + tx * VEC; }
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (VEC == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

// acc[i][c] += sum_k A[ty*4+i][k] * B[k][col(c)]: A (64, K) row-major with
// stride lda, read four k at a time; B (K, 16 * CO) row-major with stride ldb.
template <int CO>
__device__ __forceinline__ void mma_an(float (&acc)[4][CO], const float* A, int lda,
                                       const float* B, int ldb, int K, int ty, int tx) {
  using C = Cols<CO>;
  for (int k = 0; k < K; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec<4>(A + (ty * 4 + i) * lda + k, a[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[CO];
#pragma unroll
      for (int g = 0; g < C::NG; ++g)
        load_vec<C::VEC>(B + (k + kk) * ldb + C::at(tx, g), b + g * C::VEC);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(a[i][kk], b[c], acc[i][c]);
    }
  }
}

// acc[i][c] += sum_k At[k][ty*4+i] * B[k][col(c)]: the row operand stored
// k-major (a product with A transposed).
template <int CO>
__device__ __forceinline__ void mma_at(float (&acc)[4][CO], const float* At, int lda,
                                       const float* B, int ldb, int K, int ty, int tx) {
  using C = Cols<CO>;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[CO];
    load_vec<4>(At + k * lda + ty * 4, a);
#pragma unroll
    for (int g = 0; g < C::NG; ++g) load_vec<C::VEC>(B + k * ldb + C::at(tx, g), b + g * C::VEC);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// Thread (ty, tx)'s 4 x CO values -> rows ty*4+i of a (64, 16 * CO) tile of
// `dst` (row stride ld), rounded to T.
template <typename T, int CO>
__device__ __forceinline__ void store_tile(T* dst, int ld, const float (&acc)[4][CO], int ty,
                                           int tx) {
  using C = Cols<CO>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        store1(dst + (long long)(ty * 4 + i) * ld + C::at(tx, g) + e, acc[i][g * C::VEC + e]);
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s = (q k^T) * scale for this thread's 4 x 4 of a 64 x 64 score tile.
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* Qs, const float* Kt,
                                       float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  mma_an<4>(s, Qs, D, Kt, LDT, D, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= scale;
}

__device__ __forceinline__ void store_scores(float* Ps, const float (&p)[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * TILE + tx * 4) =
        make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
}

// ---------------------------------------------------------------- forward

template <int D>
constexpr int fwd_smem_floats() { return TILE * D + D * LDT + TILE * D + TILE * TILE; }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int n, int m, float scale) {
  constexpr int CO = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // (64, D)
  float* Kt = Qs + TILE * D;      // (D, 64) at stride LDT
  float* Vs = Kt + D * LDT;       // (64, D)
  float* Ps = Vs + TILE * D;      // (64, 64)

  const int q_tiles = n / TILE;
  const long long bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, D>(Qs, q + (bh * n + row0) * D);

  float acc[4][CO], row_m[4], row_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  for (int col0 = 0; col0 < m; col0 += TILE) {
    __syncthreads();   // the previous tile's products are done with Kt, Vs, Ps
    load_rows_transposed<T, D>(Kt, k + (bh * m + col0) * D);
    load_rows<T, D>(Vs, v + (bh * m + col0) * D);
    __syncthreads();

    float s[4][4];
    scores<D>(s, Qs, Kt, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_cur = row_max16(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(row_m[i], m_cur);
      // the first tile has no old statistics: exp(-inf - m_new) is 0
      const float alpha = row_m[i] == -INFINITY ? 0.f : __expf(row_m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      row_l[i] = alpha * row_l[i] + row_sum16(sum);
      row_m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
    store_scores(Ps, s, ty, tx);
    __syncthreads();
    mma_an<CO>(acc, Ps, TILE, Vs, D, TILE, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / row_l[i];
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] *= inv;
    if (lse != nullptr && tx == 0) lse[bh * n + row0 + ty * 4 + i] = row_m[i] + logf(row_l[i]);
  }
  store_tile<T, CO>(o + (bh * n + row0) * D, D, acc, ty, tx);
}

// --------------------------------------------------------------------- dq

template <int D>
constexpr int dq_smem_floats() { return 2 * TILE * D + 2 * D * LDT + TILE * D + TILE * TILE; }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
          T* __restrict__ dq, int n, int m, float scale) {
  constexpr int CO = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // (64, D)
  float* dOs = Qs + TILE * D;       // (64, D)
  float* Kt = dOs + TILE * D;       // (D, 64) at stride LDT
  float* Vt = Kt + D * LDT;         // (D, 64) at stride LDT
  float* Ks = Vt + D * LDT;         // (64, D)
  float* dSs = Ks + TILE * D;       // (64, 64)

  const int q_tiles = n / TILE;
  const long long bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, D>(Qs, q + (bh * n + row0) * D);
  load_rows<T, D>(dOs, dout + (bh * n + row0) * D);
  float row_lse[4], row_di[4], acc[4][CO];
  load_vec<4>(lse + bh * n + row0 + ty * 4, row_lse);
  load_vec<4>(di + bh * n + row0 + ty * 4, row_di);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;

  for (int col0 = 0; col0 < m; col0 += TILE) {
    __syncthreads();
    load_rows_transposed<T, D>(Kt, k + (bh * m + col0) * D);
    load_rows_transposed<T, D>(Vt, v + (bh * m + col0) * D);
    load_rows<T, D>(Ks, k + (bh * m + col0) * D);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(s, Qs, Kt, scale, ty, tx);
    scores<D>(dp, dOs, Vt, 1.f, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = (dp[i][j] - row_di[i]) * __expf(s[i][j] - row_lse[i]) * scale;
    store_scores(dSs, s, ty, tx);
    __syncthreads();
    mma_an<CO>(acc, dSs, TILE, Ks, D, TILE, ty, tx);
  }
  store_tile<T, CO>(dq + (bh * n + row0) * D, D, acc, ty, tx);
}

// ------------------------------------------------------------------ dk, dv

template <int D>
constexpr int dkv_smem_floats() { return 2 * D * LDT + 2 * TILE * D + 2 * TILE * TILE; }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
           T* __restrict__ dk, T* __restrict__ dv, int n, int m, float scale) {
  constexpr int CO = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                 // (D, 64) at stride LDT
  float* Vt = Kt + D * LDT;         // (D, 64) at stride LDT
  float* Qs = Vt + D * LDT;         // (64, D)
  float* dOs = Qs + TILE * D;       // (64, D)
  float* Ps = dOs + TILE * D;       // (64 query rows, 64 KV rows)
  float* dSs = Ps + TILE * TILE;    // the same shape

  const int kv_tiles = m / TILE;
  const long long bh = blockIdx.x / kv_tiles;
  const int col0 = (blockIdx.x % kv_tiles) * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows_transposed<T, D>(Kt, k + (bh * m + col0) * D);
  load_rows_transposed<T, D>(Vt, v + (bh * m + col0) * D);
  float dk_acc[4][CO], dv_acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int row0 = 0; row0 < n; row0 += TILE) {
    __syncthreads();
    load_rows<T, D>(Qs, q + (bh * n + row0) * D);
    load_rows<T, D>(dOs, dout + (bh * n + row0) * D);
    float row_lse[4], row_di[4];
    load_vec<4>(lse + bh * n + row0 + ty * 4, row_lse);
    load_vec<4>(di + bh * n + row0 + ty * 4, row_di);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(s, Qs, Kt, scale, ty, tx);
    scores<D>(dp, dOs, Vt, 1.f, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __expf(s[i][j] - row_lse[i]);
        dp[i][j] = (dp[i][j] - row_di[i]) * s[i][j] * scale;
      }
    store_scores(Ps, s, ty, tx);
    store_scores(dSs, dp, ty, tx);
    __syncthreads();
    // rows of the accumulators are KV rows: the query rows are summed over
    mma_at<CO>(dv_acc, Ps, TILE, dOs, D, TILE, ty, tx);
    mma_at<CO>(dk_acc, dSs, TILE, Qs, D, TILE, ty, tx);
  }
  store_tile<T, CO>(dk + (bh * m + col0) * D, D, dk_acc, ty, tx);
  store_tile<T, CO>(dv + (bh * m + col0) * D, D, dv_acc, ty, tx);
}

// ---------------------------------------------------------------- launches

constexpr int ERR_ARGS = -1;

inline bool bad_shape(long long bh, int n, int m) {
  return bh < 1 || n < TILE || m < TILE || n % TILE || m % TILE ||
         bh * (n / TILE) > 0x7fffffffLL || bh * (m / TILE) > 0x7fffffffLL;
}

template <typename Kernel>
inline int opt_in(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, long long bh, int n,
            int m, float scale, cudaStream_t s) {
  constexpr int bytes = fwd_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(fwd_kernel<T, D>, bytes)) return err;
  fwd_kernel<T, D><<<(unsigned)(bh * (n / TILE)), THREADS, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, n, m, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int backward_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* di, void* dq, long long bh, int n, int m, float scale,
                cudaStream_t s) {
  constexpr int bytes = dq_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(dq_kernel<T, D>, bytes)) return err;
  dq_kernel<T, D><<<(unsigned)(bh * (n / TILE)), THREADS, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, di, (T*)dq, n, m, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int backward_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* di, void* dk, void* dv, long long bh, int n, int m, float scale,
                 cudaStream_t s) {
  constexpr int bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(dkv_kernel<T, D>, bytes)) return err;
  dkv_kernel<T, D><<<(unsigned)(bh * (m / TILE)), THREADS, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, di, (T*)dk, (T*)dv, n, m,
      scale);
  return (int)cudaGetLastError();
}

// Calls fn<T, D>(args...) for the runtime (dtype, d); ERR_ARGS for a pair
// that has no kernel.
#define FA_DISPATCH(fn, dtype, d, ...)                                  \
  do {                                                                  \
    if ((dtype) == 0) {                                                 \
      if ((d) == 16) return fn<float, 16>(__VA_ARGS__);                 \
      if ((d) == 32) return fn<float, 32>(__VA_ARGS__);                 \
      if ((d) == 64) return fn<float, 64>(__VA_ARGS__);                 \
      if ((d) == 128) return fn<float, 128>(__VA_ARGS__);               \
    } else if ((dtype) == 1) {                                          \
      if ((d) == 16) return fn<__nv_bfloat16, 16>(__VA_ARGS__);         \
      if ((d) == 32) return fn<__nv_bfloat16, 32>(__VA_ARGS__);         \
      if ((d) == 64) return fn<__nv_bfloat16, 64>(__VA_ARGS__);         \
      if ((d) == 128) return fn<__nv_bfloat16, 128>(__VA_ARGS__);       \
    }                                                                   \
    return ERR_ARGS;                                                    \
  } while (0)

}  // namespace

extern "C" {

// o (and lse unless it is null) from q, k, v.  dtype 0 float32, 1 bfloat16.
int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse, long long bh,
               int n, int m, int d, float scale, int dtype, int device, void* stream) {
  if (bad_shape(bh, n, m) || !q || !k || !v || !o) return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  FA_DISPATCH(forward, dtype, d, q, k, v, o, (float*)lse, bh, n, m, scale, s);
}

// dq from q, k, v, do, lse and di = rowsum(o * do).
int fa_backward_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* di, void* dq, long long bh, int n, int m, int d, float scale,
                   int dtype, int device, void* stream) {
  if (bad_shape(bh, n, m) || !q || !k || !v || !dout || !lse || !di || !dq) return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  FA_DISPATCH(backward_dq, dtype, d, q, k, v, dout, (const float*)lse, (const float*)di, dq, bh,
              n, m, scale, s);
}

// dk and dv from the same inputs.
int fa_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* di, void* dk, void* dv, long long bh, int n,
                    int m, int d, float scale, int dtype, int device, void* stream) {
  if (bad_shape(bh, n, m) || !q || !k || !v || !dout || !lse || !di || !dk || !dv)
    return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  FA_DISPATCH(backward_dkv, dtype, d, q, k, v, dout, (const float*)lse, (const float*)di, dk, dv,
              bh, n, m, scale, s);
}

const char* fa_error_string(int err) {
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
