// CUDA-core tile helpers shared by the streaming-attention sources
// (flash_attention.cu: the forward; flash_attention_bwd.cu: the float32
// backward).  256 threads hold a 64 x 64 (or 64 x d) float32 tile as 4 x 4
// (4 x d/16) a thread and read both operands of a product from float32 tiles
// in shared memory as float4, the row operand broadcast within a half-warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int ERR_ARGS = -1;
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

inline bool bad_shape(long long bh, int n, int m, int tile) {
  return bh < 1 || n < tile || m < tile || n % tile || m % tile ||
         bh * (n / tile) > 0x7fffffffLL || bh * (m / tile) > 0x7fffffffLL;
}

template <typename Kernel>
inline int opt_in(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
