// Streaming softmax attention for long sequences, the forward, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel _fwd_kernel of
// moleculediffusiontransformer_tpu/ops/flash_attention.py (:89):
//
//   fa_forward   o = softmax(q k^T * scale) v, and optionally
//                lse = m + log l per row
//
// (The backward, _dq_kernel and _dkv_kernel, is flash_attention_bwd.cu.)
//
// q, o are (bh, n, d); k, v (bh, m, d); lse (bh, n) float32; all contiguous.
// n and m are multiples of 64, d is 16, 32, 64 or 128.  Inputs are float32 or
// bfloat16 and are widened to float32 on their way into shared memory;
// scores, probabilities, the running max and normaliser and the accumulator
// are float32, and the output is rounded once, when it is written.  These
// are the Pallas kernel's rounding points.
//
// What the TPU grid carried from step to step in VMEM scratch (acc, m, l) is
// a loop inside one block here: one block per (bh, 64 query rows) sweeps the
// KV tiles through shared memory.
//
// Bound: operations.  At n = m = 4096, d = 64 the forward is 4 n m d flops a
// (batch, head) against 4 n d elements moved, ~2,000 flops a byte in bf16.
// The products here run on the CUDA cores (flash_attention_tiles.cuh), which
// keeps the FMA pipe, not shared memory, the limit of the inner loop; the
// tensor cores and asynchronous copies, which the backward kernels use, are
// what a faster version would add.
#include "flash_attention_tiles.cuh"

namespace {

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

template <typename T, int D>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, long long bh, int n,
            int m, float scale, cudaStream_t s) {
  constexpr int bytes = fwd_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(fwd_kernel<T, D>, bytes)) return err;
  fwd_kernel<T, D><<<(unsigned)(bh * (n / TILE)), THREADS, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, n, m, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int forward_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
              long long bh, int n, int m, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return forward<T, 16>(q, k, v, o, lse, bh, n, m, scale, s);
    case 32: return forward<T, 32>(q, k, v, o, lse, bh, n, m, scale, s);
    case 64: return forward<T, 64>(q, k, v, o, lse, bh, n, m, scale, s);
    case 128: return forward<T, 128>(q, k, v, o, lse, bh, n, m, scale, s);
  }
  return ERR_ARGS;
}

}  // namespace

extern "C" {

// o (and lse unless it is null) from q, k, v.  dtype 0 float32, 1 bfloat16.
int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse, long long bh,
               int n, int m, int d, float scale, int dtype, int device, void* stream) {
  if (bad_shape(bh, n, m, TILE) || !q || !k || !v || !o) return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return forward_d<float>(d, q, k, v, o, (float*)lse, bh, n, m, scale, s);
  if (dtype == 1)
    return forward_d<__nv_bfloat16>(d, q, k, v, o, (float*)lse, bh, n, m, scale, s);
  return ERR_ARGS;
}

const char* fa_error_string(int err) {
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
