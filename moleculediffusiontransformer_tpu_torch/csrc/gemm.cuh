// Shared device helpers of the Transformer1d kernels (forward and backward):
// dtype conversion with the JAX package's rounding, warp/block reductions,
// and the one tiled GEMM both directions use.
//
// The GEMM computes out (M, N) = epilogue(sum_k A[m, k] * B[k, n]) with A and
// B addressed through strides, so one kernel serves the three products of a
// layer and its backward:
//   NT  out = A W^T   (forward projections; W in torch's (out, in) layout)
//   NN  out = G W     (input grads)
//   TN  dW  = G^T A   (weight grads: the reduction runs over all M = b*L rows
//                      inside one block, so each output tile is owned by one
//                      block and the sum has a fixed order)
// Accumulation is float32 on the CUDA cores (64x64 tile, 4x4 outputs a
// thread); no atomics anywhere, so a second call on the same inputs gives
// bitwise the same result.  gemm_tc.cuh's `launch_gemm_tc` takes the same
// `GemmArgs` and sends every product whose rows are 16-byte vectors to the
// tensor cores (bf16 in one pass, float32 in three TF32 passes); this
// kernel takes the shapes it does not, none of them at the models' shapes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// value rounded to T and widened back (a no-op for float)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; every thread gets the result.  `red` holds 32 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(t);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// --------------------------------------------------------------------- GEMM
enum Epilogue {
  EPI_NONE = 0,      // acc
  EPI_BIAS = 1,      // acc + bias[n]
  EPI_BIAS_RES = 2,  // round_to<out>(acc + bias[n]) + res[m, n]   (forward residual)
  EPI_BIAS_GELU = 3, // gelu(acc + bias[n])
  EPI_RES = 4,       // acc + res[m, n]          (backward: a float32 running grad)
  EPI_MUL = 5,       // acc * mul[m, n]          (backward: times the GELU derivative)
};

constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

template <typename T, typename O>
struct GemmArgs {
  const T* A;
  long long sam, sak;  // A[m, k] = A[m * sam + k * sak]
  const T* B;
  long long sbk, sbn;  // B[k, n] = B[k * sbk + n * sbn]
  O* out;              // (M, N) row-major
  int M, N, K, epi;
  const float* bias;   // (N,) for the EPI_BIAS* modes
  const O* res;        // (M, N) for EPI_BIAS_RES / EPI_RES; may alias out
  const float* mul;    // (M, N) for EPI_MUL
  T* out_t;            // optional second output, the same value rounded to T
};

// The epilogue of output element idx = m * N + n, from its float32 sum.
// `res` may alias `out`: each element's residual is read by the thread that
// writes it.
template <typename T, typename O>
__device__ __forceinline__ float epilogue_value(const GemmArgs<T, O>& g, size_t idx, int n,
                                                float v) {
  switch (g.epi) {
    case EPI_BIAS: return v + g.bias[n];
    case EPI_BIAS_RES: return round_to<O>(v + g.bias[n]) + to_f(g.res[idx]);
    case EPI_BIAS_GELU: return gelu_erf(v + g.bias[n]);
    case EPI_RES: return v + to_f(g.res[idx]);
    case EPI_MUL: return v * g.mul[idx];
    default: return v;
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs<T, O> g) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // load along whichever index is contiguous in memory (coalesced)
  const bool a_k_fast = g.sak == 1, b_k_fast = g.sbk == 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
      const int r = a_k_fast ? i / BK : i % BM;
      const int kk = a_k_fast ? i % BK : i / BM;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < g.M && gk < g.K) ? to_f(g.A[gm * g.sam + gk * g.sak]) : 0.f;
    }
    for (int i = tid; i < BN * BK; i += GEMM_THREADS) {
      const int c = b_k_fast ? i / BK : i % BN;
      const int kk = b_k_fast ? i % BK : i / BN;
      const int gn = n0 + c, gk = k0 + kk;
      Bs[kk][c] = (gn < g.N && gk < g.K) ? to_f(g.B[gk * g.sbk + gn * g.sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= g.N) continue;
      const size_t idx = (size_t)gm * g.N + gn;
      const float v = epilogue_value(g, idx, gn, acc[i][j]);
      g.out[idx] = from_f<O>(v);
      if (g.out_t != nullptr) g.out_t[idx] = from_f<T>(v);
    }
  }
}

template <typename T, typename O>
int launch_gemm(const GemmArgs<T, O>& g, cudaStream_t s) {
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  gemm_kernel<T, O><<<grid, GEMM_THREADS, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// out (M, N) = A (M, K) . W (N, K)^T
template <typename T, typename O>
GemmArgs<T, O> gemm_nt(const T* A, const T* W, O* out, int M, int N, int K) {
  GemmArgs<T, O> g = {};
  g.A = A; g.sam = K; g.sak = 1;
  g.B = W; g.sbk = 1; g.sbn = K;
  g.out = out; g.M = M; g.N = N; g.K = K; g.epi = EPI_NONE;
  return g;
}

// out (M, N) = G (M, K) . W (K, N)
template <typename T, typename O>
GemmArgs<T, O> gemm_nn(const T* G, const T* W, O* out, int M, int N, int K) {
  GemmArgs<T, O> g = {};
  g.A = G; g.sam = K; g.sak = 1;
  g.B = W; g.sbk = N; g.sbn = 1;
  g.out = out; g.M = M; g.N = N; g.K = K; g.epi = EPI_NONE;
  return g;
}

// dW (N, K) = G (rows, N)^T . A (rows, K): the weight grad of out = A W^T,
// reduced over all rows in one block per tile.
template <typename T>
GemmArgs<T, float> gemm_tn(const T* G, const T* A, float* dw, int rows, int N, int K) {
  GemmArgs<T, float> g = {};
  g.A = G; g.sam = 1; g.sak = N;
  g.B = A; g.sbk = K; g.sbn = 1;
  g.out = dw; g.M = N; g.N = K; g.K = rows; g.epi = EPI_NONE;
  return g;
}

// variadic: a call's template arguments may hold commas
#define T1D_CHECK(...)                 \
  do {                                 \
    const int err_ = (__VA_ARGS__);    \
    if (err_ != 0) return err_;        \
  } while (0)

constexpr int DTYPE_F32 = 0, DTYPE_BF16 = 1;

}  // namespace
