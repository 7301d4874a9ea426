// Tiles of the Transformer1d stack's attention core at lengths past 64: the
// pieces the tiled forward (`transformer1d_fwd.cu`) and the tiled backward
// (`transformer1d_bwd.cu`) share.
//
// A block owns one (batch, head) and a tile of up to TQ query rows (or, in
// the dK/dV pass, TK key rows) and sweeps the other side in tiles of 64 rows
// through shared memory, every value widened to float32 on load.  The row
// statistics of the softmax (the running max and the sum of exponentials)
// are taken online over the key tiles in float32.  The probabilities are then
// recomputed from them, normalised, and rounded to the compute dtype exactly
// where the whole-row core rounds them (before P.V and dV; dS before dQ and
// dK), so the tiled core keeps the rounding points of the L, m <= 64 core and
// of the Pallas kernel.  Products run on the CUDA cores, as the L, m <= 64
// core's do.
//
// Thread layout of the accumulators: THREADS = 256 threads, four to a row of
// the block's 64-row tile, thread t owning row t / 4 and the columns
// t % 4 + 4 k (k < 32), so a head size up to 128 fits in 32 registers.
#pragma once

#include "gemm.cuh"

namespace {
namespace tiles {

constexpr int TQ = 64, TK = 64;   // query rows and key rows of a tile
constexpr int THREADS = 256;
constexpr int COLS = 4;           // threads a row
constexpr int PER = 128 / COLS;   // columns a thread at head size 128
constexpr int SP = TK + 1;        // score rows' stride: no bank conflicts

// rows [0, n) of a matrix of leading dimension ld, d columns from src, into
// dst (n x dp) widened to float32
template <typename T>
__device__ __forceinline__ void load(float* dst, const T* __restrict__ src, long long ld,
                                     int n, int d, int dp) {
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    dst[r * dp + c] = to_f(src[(size_t)r * ld + c]);
  }
}

// s[r][j] = scale * a[r] . b[j] for r < na, j < nb (a, b of row stride dp;
// s of row stride SP)
__device__ __forceinline__ void dots(float* s, const float* a, const float* b, int na,
                                     int nb, int d, int dp, float scale) {
  for (int i = threadIdx.x; i < TQ * TK; i += blockDim.x) {
    const int r = i / TK, j = i % TK;
    if (r < na && j < nb) {
      float acc = 0.f;
      for (int t = 0; t < d; ++t) acc = fmaf(a[r * dp + t], b[j * dp + t], acc);
      s[r * SP + j] = acc * scale;
    }
  }
}

// The softmax statistics of the block's nq query rows (qs, in shared memory)
// against all m keys of kb (rows of leading dimension ld): mx[r] the row max
// and l[r] the sum of exp(s - mx[r]), float32, taken online over the key
// tiles, one warp a row.  ks and ss are scratch (TK x dp, TQ x SP).  Every
// thread sees mx and l when it returns.
template <typename T>
__device__ void row_stats(float* mx, float* l, const float* qs, float* ks, float* ss,
                          const T* __restrict__ kb, long long ld, int nq, int m, int d,
                          int dp, float scale) {
  for (int r = threadIdx.x; r < TQ; r += blockDim.x) {
    mx[r] = -INFINITY;
    l[r] = 0.f;
  }
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int k0 = 0; k0 < m; k0 += TK) {
    const int nk = min(TK, m - k0);
    __syncthreads();  // the last tile's scores read, mx and l set
    load(ks, kb + (size_t)k0 * ld, ld, nk, d, dp);
    __syncthreads();
    dots(ss, qs, ks, nq, nk, d, dp, scale);
    __syncthreads();
    for (int r = threadIdx.x >> 5; r < nq; r += nwarps) {
      const float* sr = ss + r * SP;
      const float old = mx[r];
      float tm = -INFINITY;
      for (int j = lane; j < nk; j += 32) tm = fmaxf(tm, sr[j]);
      const float m_new = fmaxf(old, warp_max(tm));
      float e = 0.f;
      for (int j = lane; j < nk; j += 32) e += expf(sr[j] - m_new);
      e = warp_sum(e);
      if (lane == 0) {
        l[r] = l[r] * expf(old - m_new) + e;
        mx[r] = m_new;
      }
    }
  }
  __syncthreads();
}

// The normalised probability of a score s in a row of statistics (mx, l),
// float32: the whole-row core's exp(s - max) / sum.
__device__ __forceinline__ float prob(float s, float mx, float l) {
  return expf(s - mx) / l;
}

}  // namespace tiles
}  // namespace
