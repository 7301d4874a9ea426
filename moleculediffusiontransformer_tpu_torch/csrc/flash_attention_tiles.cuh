// CUDA-core tile helpers shared by the streaming-attention sources
// (flash_attention.cu: the forward; flash_attention_bwd.cu: the float32
// backward).  256 threads hold a 64 x 64 (or 64 x d) float32 tile as 4 x 4
// (4 x d/16) a thread and read both operands of a product from float32 tiles
// in shared memory as float4, the row operand broadcast within a half-warp.
// Also what every streaming-attention kernel shares about its arguments: the
// strided layout of q, k, v and their outputs (`Rows`) and the shape check.
#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int ERR_ARGS = -1;
constexpr int TILE = 64;       // query rows and KV rows of a tile
constexpr int THREADS = 256;   // 16 x 16: thread (ty, tx) owns rows ty*4..+3
constexpr int LDT = TILE + 4;  // row stride of a transposed (d, 64) tile

// Where the rows of one (batch, head) of a (b, h, rows, d) tensor start and
// how far apart they are, in elements; d is unit-stride.  Split heads are
// views of one (b, rows, h, d) buffer, a contiguous (bh, rows, d) tensor is
// the case h = 1.  The wrappers pass strides that are multiples of 16 bytes
// and base pointers on 16-byte boundaries: every load is 16 bytes wide.  The
// row stride is 32 bits (`bad_strides`), so that the kernels' row addresses
// are one wide multiply-add of two 32-bit registers.
struct Rows {
  long long batch, head;
  int row;

  // the element offset of row r of (batch, head) pair bh
  __device__ __forceinline__ long long at(long long bh, int heads, int r = 0) const {
    return (bh / heads) * batch + (bh % heads) * head + (long long)r * row;
  }
};

// The layout of tensor i of a host array of (batch, head, row) strides.
inline Rows rows_of(const long long* strides, int i) {
  return Rows{strides[3 * i], strides[3 * i + 1], (int)strides[3 * i + 2]};
}

// 64 rows of D floats at `src` (row stride ld) -> dst[row][D].
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int ld) {
  constexpr int Q = D / 4;
  for (int idx = threadIdx.x; idx < TILE * Q; idx += THREADS) {
    const int r = idx / Q, kq = idx % Q;
    *reinterpret_cast<float4*>(dst + r * D + kq * 4) =
        *reinterpret_cast<const float4*>(src + (long long)r * ld + kq * 4);
  }
}

// The same rows transposed: dst[k][row], row stride LDT.  Four lanes read 64
// contiguous bytes of one row, eight rows a warp; the stores of a warp then
// fall on 16 banks.
template <int D>
__device__ __forceinline__ void load_rows_transposed(float* dst, const float* src, int ld) {
  constexpr int QH = D / 16;
  for (int idx = threadIdx.x; idx < TILE * (D / 4); idx += THREADS) {
    const int kq_l = idx & 3, r_l = (idx >> 2) & 7, rest = idx >> 5;
    const int kq = (rest % QH) * 4 + kq_l, r = (rest / QH) * 8 + r_l;
    const float4 f = *reinterpret_cast<const float4*>(src + (long long)r * ld + kq * 4);
    dst[(kq * 4) * LDT + r] = f.x;
    dst[(kq * 4 + 1) * LDT + r] = f.y;
    dst[(kq * 4 + 2) * LDT + r] = f.z;
    dst[(kq * 4 + 3) * LDT + r] = f.w;
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
// `dst` (row stride ld).
template <int CO>
__device__ __forceinline__ void store_tile(float* dst, int ld, const float (&acc)[4][CO], int ty,
                                           int tx) {
  using C = Cols<CO>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        dst[(long long)(ty * 4 + i) * ld + C::at(tx, g) + e] = acc[i][g * C::VEC + e];
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

// n query rows in blocks of n_tile, m KV rows in blocks of m_tile; the
// grid (bh times the blocks of one side) must fit its x dimension.
inline bool bad_shape(long long bh, int heads, int n, int m, int n_tile, int m_tile) {
  return bh < 1 || heads < 1 || bh % heads || n < n_tile || m < m_tile || n % n_tile ||
         m % m_tile || bh * (n / n_tile) > 0x7fffffffLL || bh * (m / m_tile) > 0x7fffffffLL;
}

// Every load and store of the kernels is 16 bytes wide (or a part of 16
// aligned bytes): base pointers on 16-byte boundaries, strides multiples of
// 16 bytes.
inline bool misaligned(const void* p) { return p == nullptr || (uintptr_t)p % 16; }

// `count` (batch, head, row) strides: none negative, each a multiple of 16
// bytes, each row stride below 2^31 elements (`Rows`).
inline bool bad_strides(const long long* strides, int count, int elem_bytes) {
  for (int i = 0; i < count; ++i)
    if (strides[i] < 0 || strides[i] * elem_bytes % 16 || (i % 3 == 2 && strides[i] > 0x7fffffffLL))
      return true;
  return false;
}

// Calls fn<D>(args...) for the runtime head size; ERR_ARGS where there is no
// kernel for it.
#define FA_HEAD_DISPATCH(fn, d, ...)             \
  switch (d) {                                   \
    case 16: return fn<16>(__VA_ARGS__);         \
    case 32: return fn<32>(__VA_ARGS__);         \
    case 64: return fn<64>(__VA_ARGS__);         \
    case 128: return fn<128>(__VA_ARGS__);       \
    default: return ERR_ARGS;                    \
  }

template <typename Kernel>
inline int opt_in(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
