// Transformer1d stack forward for Hopper (sm_90a): GroupNorm(32, eps 1e-6)
// -> 1x1 conv in -> per layer [pre-LN self-attention; pre-LN
// cross-attention on the context; exact-GELU feed-forward], each residual
// -> 1x1 conv out.
//
// Replaces: moleculediffusiontransformer_tpu/ops/transformer_fusion.py
// `_kernel` (launched by `_fused_forward`), the whole-stack Pallas
// megakernel of the JAX package, with and without its activation stash
// (`with_stash`: the input of every residual sub-block, kept for the
// backward in `transformer1d_bwd.cu`), and with a uniform context, the
// `attention_shared_kv` variant (`uniform_ctx`): one (1, m, C_ctx) context
// shared by every row, the CFG null half's FixedEmbedding table.
//
// What bounds it on this card.  At the flagship shapes (batch 2x512 under
// CFG; L 8 at C 256, L 2 at C 512; 8 heads x 64; ctx 12 x 128) almost all
// of the work is matrix products with M = batch*L rows and N, K in
// 256..1024: about 420 GFLOP an eval of the 91M model's nine stacks, 0.42
// ms at the bf16 tensor-core peak, with every operand resident in the 50 MB
// L2 (the largest activation of a stack, 8192 x 512 bf16, is 8 MB; a
// layer's weights at most 5 MB).  On the CUDA cores those products ran at
// ~16 TFLOP/s and took three quarters of an eval's device time; on the
// tensor cores they take a few microseconds a launch, and what is left is
// the chain's ~14 launches a layer (norms, attention, products), each a
// few microseconds of device time at any batch, and the host's time to
// issue them.
//
// What the design does about it.  The TPU kernel keeps every layer's
// weights resident in VMEM (~22 MB at C=512), which cannot fit in 227 KB of
// shared memory, and packs (batch, head) pairs block-diagonally to fill the
// TPU's 128x128 matrix unit; neither carries over.  Here the stack runs as
// a short sequence of simple kernels, launched back to back on the caller's
// stream by one host entry point (`t1d_forward`):
//   * GroupNorm: one block per (batch, group), float32 two-pass statistics;
//   * LayerNorm: one warp per row, float32 two-pass statistics;
//   * every product, C = A W^T with W in torch's (out, in) layout, through
//     gemm_tc.cuh's `launch_gemm_tc` with a fused epilogue (+ bias, exact
//     GELU (erff), + residual): in bf16 on the tensor cores (`wgmma` from
//     swizzled shared memory, a TMA-fed ring, 128 x 128 or 64 x 64
//     blocks chosen from the shape so that a request of a few rows does not
//     launch 128-row blocks), in float32 as three TF32 passes on the same
//     tensor cores (hi.hi + hi.lo + lo.hi of each operand's TF32 split,
//     staged K-major by the threads: some 1e-7 of the output's scale, so
//     that float32 keeps its 1e-4 parity with the CPU);
//   * attention: for L, m <= 64 one block per (batch, head), q/k/v and the
//     L x m score matrix in shared memory, float32 scores and stable
//     softmax, float32 P.V, on the CUDA cores (a small share of the work at
//     L 8 and m 12); past 64 (up to the JAX gate's 512: the audio preset's
//     stacks run at L 128-512 on waveforms of 2^18-2^20 samples) one block
//     per (batch, head, 64 query rows), K and V in tiles of 64 rows through
//     shared memory, the softmax statistics taken online in a first sweep
//     and the rounded probabilities applied in a second (q.k twice and P.V
//     once: 1.6 GFLOP at L = m = 512, 8 heads of 64, batch 2, beside 5.4
//     GFLOP of the stack's products on the tensor cores; moving this core
//     onto the tensor cores is later work).
// With a uniform context the cross-attention's context LayerNorm and KV
// projection run once, on m rows instead of B*m, and every (batch, head)
// block reads that one K/V (batch stride 0).
// Ragged edges are masked everywhere; nothing assumes L or M is a multiple
// of a tile.  Rounding follows the Pallas kernel: q and kv are cast to the
// compute dtype after projection, probabilities before P.V, every
// projection's (acc + bias) before the residual add, and the residual
// stream stays in the compute dtype; the feed-forward hidden activation is
// float32 until after the GELU.  Activations stay in global memory (in L2)
// between kernels: fewer launches a layer (LayerNorm in the products'
// prologue, the attention core on the tensor cores) is later work.
#include "gemm_tc.cuh"
#include "stack_attention_tiles.cuh"

namespace {

// The longest L and m the whole-row attention core takes in one block, and
// the longest the tiled core takes (the JAX gate's L <= 512).
constexpr int WHOLE_ROWS = 64;
constexpr int MAX_TILED_LENGTH = 512;

// ---------------------------------------------------------------- GroupNorm
// x (B, L, C) -> y (B, L, C) in T; one block per (batch, group).
template <typename T>
__global__ void group_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta, int L, int C,
                                  int groups, float eps) {
  __shared__ float red[32];
  const int b = blockIdx.x / groups, g = blockIdx.x % groups;
  const int cpg = C / groups, n = L * cpg;
  const size_t base = (size_t)b * L * C + (size_t)g * cpg;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s += to_f(x[base + (size_t)(i / cpg) * C + i % cpg]);
  const float mean = block_sum(s, red) / n;
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = to_f(x[base + (size_t)(i / cpg) * C + i % cpg]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / n + eps);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t idx = base + (size_t)(i / cpg) * C + i % cpg;
    const int c = g * cpg + i % cpg;
    y[idx] = from_f<T>((to_f(x[idx]) - mean) * rstd * gamma[c] + beta[c]);
  }
}

// ---------------------------------------------------------------- LayerNorm
// x (rows, C) -> y (rows, C) in T; one warp per row.
template <typename T>
__global__ void layer_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta, int rows, int C,
                                  float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + eps);
  T* yr = y + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = from_f<T>((to_f(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
}

// ---------------------------------------------------------------- attention
// q (B*L, heads*d), kv (m rows a batch, 2*heads*d) with k in the first
// heads*d columns and v in the last -> o (B*L, heads*d).  One block per
// (batch, head); a batch's kv rows start kv_bstride elements after the
// previous batch's (m*2*heads*d, or 0 when every batch shares one K/V).
constexpr int ATTN_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                 T* __restrict__ o, int L, int m, int heads, int d, long long kv_bstride,
                 float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int inner = heads * d, dp = d + 1;  // +1: no bank conflicts across rows
  float* qs = smem;           // L x dp
  float* ks = qs + L * dp;    // m x dp
  float* vs = ks + m * dp;    // m x d
  float* ps = vs + m * d;     // L x m
  const T* qb = q + (size_t)b * L * inner + h * d;
  const T* kb = kv + (size_t)b * kv_bstride + h * d;
  const T* vb = kb + inner;
  for (int i = threadIdx.x; i < L * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    qs[r * dp + c] = to_f(qb[(size_t)r * inner + c]);
  }
  for (int i = threadIdx.x; i < m * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    ks[r * dp + c] = to_f(kb[(size_t)r * 2 * inner + c]);
    vs[r * d + c] = to_f(vb[(size_t)r * 2 * inner + c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * m; i += blockDim.x) {
    const int r = i / m, j = i % m;
    float s = 0.f;
    for (int t = 0; t < d; ++t) s = fmaf(qs[r * dp + t], ks[j * dp + t], s);
    ps[i] = s * scale;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < L; r += nwarps) {
    float* pr = ps + r * m;
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
  __syncthreads();
  for (int i = threadIdx.x; i < L * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    float s = 0.f;
    for (int j = 0; j < m; ++j) s = fmaf(ps[r * m + j], vs[j * d + c], s);
    o[((size_t)b * L + r) * inner + h * d + c] = from_f<T>(s);
  }
}

// The same core at any L, m up to MAX_TILED_LENGTH: one block per (batch,
// head, tile of up to 64 query rows), K and V swept in tiles of 64 rows
// through shared memory (stack_attention_tiles.cuh).  A first sweep over K
// takes each row's max and sum online; a second recomputes the scores,
// rounds the normalised probabilities to T and accumulates P.V, so the
// rounding points are attention_kernel's.
template <typename T>
__global__ void __launch_bounds__(tiles::THREADS)
attention_tiled_kernel(const T* __restrict__ q, const T* __restrict__ kv, T* __restrict__ o,
                       int L, int m, int heads, int d, long long kv_bstride, float scale) {
  using namespace tiles;
  extern __shared__ float smem[];
  const int qtiles = (L + TQ - 1) / TQ;
  const int bh = blockIdx.x / qtiles, r0 = (blockIdx.x % qtiles) * TQ;
  const int b = bh / heads, h = bh % heads;
  const int nq = min(TQ, L - r0);
  const int inner = heads * d, dp = d + 1;
  const long long ld = 2LL * inner;
  float* qs = smem;          // TQ x dp
  float* ks = qs + TQ * dp;  // TK x dp
  float* vs = ks + TK * dp;  // TK x dp
  float* ss = vs + TK * dp;  // TQ x SP: scores, then probabilities
  float* mx = ss + TQ * SP;  // TQ
  float* l = mx + TQ;        // TQ
  const T* kb = kv + (size_t)b * kv_bstride + h * d;
  const T* vb = kb + inner;
  load(qs, q + ((size_t)b * L + r0) * inner + h * d, inner, nq, d, dp);
  row_stats(mx, l, qs, ks, ss, kb, ld, nq, m, d, dp, scale);
  const int row = threadIdx.x / COLS, col = threadIdx.x % COLS;
  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.f;
  for (int k0 = 0; k0 < m; k0 += TK) {
    const int nk = min(TK, m - k0);
    __syncthreads();  // the last tile's probabilities and values read
    load(ks, kb + (size_t)k0 * ld, ld, nk, d, dp);
    load(vs, vb + (size_t)k0 * ld, ld, nk, d, dp);
    __syncthreads();
    dots(ss, qs, ks, nq, nk, d, dp, scale);
    __syncthreads();
    for (int i = threadIdx.x; i < TQ * TK; i += blockDim.x) {
      const int r = i / TK, j = i % TK;
      if (r < nq && j < nk) ss[r * SP + j] = round_to<T>(prob(ss[r * SP + j], mx[r], l[r]));
    }
    __syncthreads();
    if (row < nq) {
      for (int j = 0; j < nk; ++j) {
        const float p = ss[row * SP + j];
        const float* vr = vs + j * dp;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int c = col + COLS * k;
          if (c < d) acc[k] = fmaf(p, vr[c], acc[k]);
        }
      }
    }
  }
  if (row < nq) {
    T* orow = o + ((size_t)b * L + r0 + row) * inner + h * d;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = col + COLS * k;
      if (c < d) orow[c] = from_f<T>(acc[k]);
    }
  }
}

// ------------------------------------------------------------- host helpers

inline long long align64(long long n) { return (n + 63) / 64 * 64; }

struct Workspace {
  long long lnq, lnkv, y, q, kv, o, h, total;
};

Workspace plan_workspace(long long B, long long L, long long C, long long ctx_len,
                         long long ctx_c, long long heads, long long head_dim,
                         long long mult) {
  const long long R = B * L, I = heads * head_dim;
  const long long kv_rows = R > B * ctx_len ? R : B * ctx_len;
  const long long lnkv = R * C > B * ctx_len * ctx_c ? R * C : B * ctx_len * ctx_c;
  Workspace w;
  w.lnq = 0;
  w.lnkv = w.lnq + align64(R * C);
  w.y = w.lnkv + align64(lnkv);
  w.q = w.y + align64(R * C);
  w.kv = w.q + align64(R * I);
  w.o = w.kv + align64(kv_rows * 2 * I);
  w.h = w.o + align64(R * I);
  w.total = w.h + align64(R * mult * C);
  return w;
}

size_t attention_smem_bytes(int L, int m, int d) {
  return sizeof(float) * ((size_t)L * (d + 1) + (size_t)m * (d + 1) + (size_t)m * d +
                          (size_t)L * m);
}

size_t attention_tiled_smem_bytes(int d) {
  using namespace tiles;
  return sizeof(float) * ((size_t)(TQ + 2 * TK) * (d + 1) + (size_t)TQ * SP + 2 * TQ);
}

// out = epilogue(A W^T): the forward's one product shape
template <typename T>
int fwd_gemm(const T* A, const T* W, const float* bias, const T* res, T* out, int M, int N,
             int K, int epi, cudaStream_t s) {
  GemmArgs<T, T> g = gemm_nt<T, T>(A, W, out, M, N, K);
  g.epi = epi;
  g.bias = bias;
  g.res = res;
  return launch_gemm_tc(g, s);
}

template <typename T>
int launch_layer_norm(const T* x, T* y, const float* g, const float* b, int rows, int C,
                      cudaStream_t s) {
  const int warps = 8;
  layer_norm_kernel<T><<<(rows + warps - 1) / warps, warps * 32, 0, s>>>(x, y, g, b, rows,
                                                                        C, 1e-5f);
  return (int)cudaGetLastError();
}

// The whole-row core where L and m fit one block (<= WHOLE_ROWS), the tiled
// core past that.
template <typename T>
int launch_attention(const T* q, const T* kv, T* o, int B, int L, int m, int heads, int d,
                     long long kv_bstride, cudaStream_t s) {
  if (L > WHOLE_ROWS || m > WHOLE_ROWS) {
    const size_t smem = attention_tiled_smem_bytes(d);
    const cudaError_t e = cudaFuncSetAttribute(
        attention_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int qtiles = gtc::cdiv(L, tiles::TQ);
    attention_tiled_kernel<T><<<B * heads * qtiles, tiles::THREADS, smem, s>>>(
        q, kv, o, L, m, heads, d, kv_bstride, 1.0f / sqrtf((float)d));
    return (int)cudaGetLastError();
  }
  const size_t smem = attention_smem_bytes(L, m, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_kernel<T><<<B * heads, ATTN_THREADS, smem, s>>>(q, kv, o, L, m, heads, d,
                                                           kv_bstride, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// One pre-LN attention sub-block: y_out = y_in + attention(y_in, kv_src).
// y_out may be y_in (in place) or the next stash slot.  kv_src has m rows a
// batch, or m rows in all when `shared_kv` (every batch attends them).
template <typename T>
int attention_block(const T* y_in, T* y_out, const T* kv_src, int kv_c, int m, bool shared_kv,
                    const void* const* w, T* lnq, T* lnkv, T* qb, T* kvb, T* ob, int B,
                    int L, int C, int heads, int d, cudaStream_t s) {
  const int R = B * L, I = heads * d;
  const int kv_rows = shared_kv ? m : B * m;
  const long long kv_bstride = shared_kv ? 0 : (long long)m * 2 * I;
  const float* ns = (const float*)w[0];
  const float* nb = (const float*)w[1];
  const float* cs = (const float*)w[2];
  const float* cb = (const float*)w[3];
  const T* wq = (const T*)w[4];
  const T* wkv = (const T*)w[5];
  const T* wout = (const T*)w[6];
  const float* bout = (const float*)w[7];
  T1D_CHECK(launch_layer_norm<T>(y_in, lnq, ns, nb, R, C, s));
  T1D_CHECK(launch_layer_norm<T>(kv_src, lnkv, cs, cb, kv_rows, kv_c, s));
  T1D_CHECK(fwd_gemm<T>(lnq, wq, nullptr, nullptr, qb, R, I, C, EPI_NONE, s));
  T1D_CHECK(fwd_gemm<T>(lnkv, wkv, nullptr, nullptr, kvb, kv_rows, 2 * I, kv_c, EPI_NONE,
                        s));
  T1D_CHECK(launch_attention<T>(qb, kvb, ob, B, L, m, heads, d, kv_bstride, s));
  T1D_CHECK(fwd_gemm<T>(ob, wout, bout, y_in, y_out, R, C, I, EPI_BIAS_RES, s));
  return 0;
}

// `stash` is null or (n_stash_slots, B, L, C): the residual stream lives in
// its slots, each sub-block reading slot i and writing slot i + 1, so the
// input of every sub-block (and of conv out) stays there for the backward.
// Without a stash the stream is updated in place in the workspace.
template <typename T>
int stack_forward(const T* x, const T* ctx, T* out, T* stash, const void* const* w, T* ws,
                  int B, int L, int C, int ctx_len, int ctx_c, bool uniform_ctx, int num_layers,
                  int heads, int head_dim, int mult, cudaStream_t s) {
  const Workspace p = plan_workspace(B, L, C, ctx_len, ctx_c, heads, head_dim, mult);
  T* lnq = ws + p.lnq;
  T* lnkv = ws + p.lnkv;
  T* qb = ws + p.q;
  T* kvb = ws + p.kv;
  T* ob = ws + p.o;
  T* hb = ws + p.h;
  const int R = B * L, groups = 32;
  const bool cross = ctx != nullptr;
  const size_t slot = stash != nullptr ? (size_t)R * C : 0;
  T* y = stash != nullptr ? stash : ws + p.y;

  group_norm_kernel<T><<<B * groups, 128, 0, s>>>(x, lnq, (const float*)w[0],
                                                  (const float*)w[1], L, C, groups, 1e-6f);
  T1D_CHECK((int)cudaGetLastError());
  T1D_CHECK(fwd_gemm<T>(lnq, (const T*)w[2], (const float*)w[3], nullptr, y, R, C, C,
                        EPI_BIAS, s));
  int k = 4;
  for (int layer = 0; layer < num_layers; ++layer) {
    T1D_CHECK(attention_block<T>(y, y + slot, y, C, L, false, w + k, lnq, lnkv, qb, kvb, ob,
                                 B, L, C, heads, head_dim, s));
    y += slot;
    k += 8;
    if (cross) {
      T1D_CHECK(attention_block<T>(y, y + slot, ctx, ctx_c, ctx_len, uniform_ctx, w + k,
                                   lnq, lnkv, qb, kvb, ob, B, L, C, heads, head_dim, s));
      y += slot;
      k += 8;
    }
    T1D_CHECK(fwd_gemm<T>(y, (const T*)w[k], (const float*)w[k + 1], nullptr, hb, R,
                          mult * C, C, EPI_BIAS_GELU, s));
    T1D_CHECK(fwd_gemm<T>(hb, (const T*)w[k + 2], (const float*)w[k + 3], y, y + slot, R, C,
                          mult * C, EPI_BIAS_RES, s));
    y += slot;
    k += 4;
  }
  T1D_CHECK(fwd_gemm<T>(y, (const T*)w[k], (const float*)w[k + 1], nullptr, out, R, C, C,
                        EPI_BIAS, s));
  return 0;
}

}  // namespace

extern "C" {

// Elements of the compute dtype the caller allocates as `workspace`.
long long t1d_workspace_elems(int B, int L, int C, int ctx_len, int ctx_c, int heads,
                              int head_dim, int mult) {
  return plan_workspace(B, L, C, ctx_len, ctx_c, heads, head_dim, mult).total;
}

// Number of weight pointers `t1d_forward` expects, in the order of the JAX
// package's `_abi_paths`: GroupNorm scale/bias, conv-in W/b; per layer the
// self-attention's [norm w/b, norm_context w/b, to_q, to_kv, to_out W/b],
// the same for the cross-attention when there is a context, then the
// feed-forward's W0/b0/W2/b2; conv-out W/b.  Matrices are in torch's
// (out, in) layout and the compute dtype, vectors float32.
int t1d_num_weights(int num_layers, int cross) {
  return 4 + num_layers * ((cross ? 16 : 8) + 4) + 2;
}

// Number of stash slots `t1d_forward` fills when given a stash: each
// layer's self-attention, cross-attention (with a context) and feed-forward
// input, in processing order, then the conv-out input (the JAX package's
// `n_stash_slots`).
int t1d_num_stash_slots(int num_layers, int cross) {
  return num_layers * (cross ? 3 : 2) + 1;
}

// Runs the stack on `stream` of `device`.  x, out (B, L, C); ctx
// (B, ctx_len, ctx_c), or (1, ctx_len, ctx_c) shared by every batch when
// `uniform_ctx` is 1, or null; stash null or (t1d_num_stash_slots, B, L, C),
// all in the compute dtype; dtype 0 = float32, 1 = bfloat16.  Returns 0, a
// cudaError_t from the first call that failed, or -1 for arguments the
// kernels do not take.
int t1d_forward(const void* x, const void* ctx, void* out, void* stash,
                const void* const* weights, int n_weights, void* workspace, int B, int L,
                int C, int ctx_len, int ctx_c, int uniform_ctx, int num_layers, int heads,
                int head_dim, int mult, int dtype, int device, void* stream) {
  if (n_weights != t1d_num_weights(num_layers, ctx != nullptr) || C % 32 != 0 ||
      L < 1 || L > MAX_TILED_LENGTH || head_dim < 1 || head_dim > 128 ||
      (ctx != nullptr && (ctx_len < 1 || ctx_len > MAX_TILED_LENGTH)) ||
      (uniform_ctx && ctx == nullptr))
    return -1;
  T1D_CHECK((int)cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return stack_forward<float>((const float*)x, (const float*)ctx, (float*)out,
                                (float*)stash, weights, (float*)workspace, B, L, C,
                                ctx_len, ctx_c, uniform_ctx != 0, num_layers, heads, head_dim,
                                mult, s);
  if (dtype == DTYPE_BF16)
    return stack_forward<__nv_bfloat16>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)ctx, (__nv_bfloat16*)out,
        (__nv_bfloat16*)stash, weights, (__nv_bfloat16*)workspace, B, L, C, ctx_len, ctx_c,
        uniform_ctx != 0, num_layers, heads, head_dim, mult, s);
  return -1;
}

// Products this library has sent to the tensor cores (gemm_tc.cuh) since
// it was loaded or last reset.
long long t1d_fwd_gemm_tc_launches(int reset) {
  const long long n = gtc::g_tc_launches;
  if (reset) gtc::g_tc_launches = 0;
  return n;
}

const char* t1d_error_string(int err) {
  if (err == gtc::ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused a TMA tensor map";
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
