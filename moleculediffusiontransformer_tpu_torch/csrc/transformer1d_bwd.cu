// Transformer1d stack backward for Hopper (sm_90a): the three segment
// kernels the training step chains after the stash forward
// (`transformer1d_fwd.cu` with a stash):
//   conv-out backward -> per layer, last first: feed-forward, cross-attention,
//   self-attention backward -> GroupNorm + conv-in backward.
//
// Replaces, in moleculediffusiontransformer_tpu/ops/transformer_fusion.py:
//   K3 `_bwd_convout_kernel`   (launched by `_bwd_conv_out`)  -> t1d_bwd_conv_out
//   K2 `_bwd_layer_kernel`     (launched by `_bwd_layer`)     -> t1d_bwd_layer
//   K4 `_bwd_convin_gn_kernel` (launched by `_bwd_conv_in_gn`) -> t1d_bwd_conv_in_gn
//
// What bounds it on this card.  As in the forward, matrix products with
// M = batch*L rows (4096 at the flagship's L 8 and micro-batch 512) and N, K
// in 256..1024: the backward does about three times the forward's
// multiplies (the recomputed q/kv and feed-forward hidden, then an input
// and a weight grad of each), some 0.3 ms of a layer's work at the bf16
// tensor-core peak over the flagship's twelve layers, every operand
// resident in L2.  The weight grads are the awkward part: their output is
// only C x C..2I x C, so one block an output tile gives 4..64 tiles of
// 128 x 128 for 132 SMs, each reducing over all 4096 rows; on the CUDA
// cores, tile by tile, they made K2 slower than its plain version.  K3 and
// K4 are two C x C products over the R rows each (0.5..1 GFLOP at the
// flagship's shapes, a few microseconds at the tensor-core peak) and passes
// over a few MB (the column sums, the GroupNorm recompute and backward):
// bound by launches and by how many SMs each pass keeps busy, not by bytes.
//
// What the design does about it.  The TPU kernels zero the weight-grad banks
// at grid step 0 and then `+=` across the batch grid, which is right only
// because a TPU grid runs in order.  Here every product of K2, K3 and K4
// runs through gemm_tc.cuh's `launch_gemm_tc`: in bf16 on the tensor cores
// (`wgmma` from swizzled shared memory), in float32 on the CUDA cores
// (gemm.cuh), chosen on the host by dtype and shape, never by a retry.
// Every weight grad is dW = G^T A with G^T read in place (`wgmma`'s
// transpose of A), and in bf16 its rows are split into S chunks, S chosen
// from the shape so that (tile, chunk) blocks fill the card about once:
// each block writes a float32 partial into the workspace and a second pass
// sums the S partials in chunk order.  (K3's and K4's C x C weight grads
// have only 4..16 tiles of 128 x 128, and at 8 k-steps a chunk the plan
// gives them 32 blocks for 132 SMs: an under-filled grid, left so.)  K2's
// bias and LayerNorm parameter grads are column sums by one block per 32
// columns, each column summed in a fixed order.  K3's and K4's column sums
// (db, and K4's GroupNorm dgamma, dbeta) are split over rows the same way
// (`launch_colsums`: (C / 32) x S blocks, about one an SM, each writing a
// float32 partial a column, and an in-order second pass), K4's two in one
// launch.  There is no float atomicAdd, so two calls on the same inputs give
// bitwise the same grads.  K4's GroupNorm recompute and backward run one
// warp per (batch, group), eight groups a block.  Launches a call: K3 5
// (dW and its split sum, db and its second pass, dy), K4 7 (GroupNorm
// statistics, dW and its split sum, dgn, the column sums and their second
// pass, dx); one fewer for each that does not split (float32 products, or
// too few rows).  Attention is one block per (batch, head): q, k, v, dO and
// the L x m probability and dP matrices sit in shared memory (L, m <= 64,
// d <= 128: at most 165 KB, asked for with cudaFuncSetAttribute), P is
// recomputed from q and k.
//
// Rounding follows the Pallas kernels: g and dO in the compute dtype before
// their products, the probabilities rounded before dV (and the recomputed
// forward output before dW_out), dS rounded before dQ and dK, dq and dkv
// rounded before their weight and input grads, the GELU derivative exact
// (cdf + h phi(h)) and dh rounded after it, the running dy float32 inside a
// layer and rounded at the layer's output, dcontext rounded per layer and
// summed across layers in the compute dtype, the recomputed GroupNorm output
// rounded before dW_in; every weight grad float32.
#include "gemm_tc.cuh"

namespace {

constexpr long long GRID_CAP = 4096;

template <typename TI, typename TO>
__global__ void cast_kernel(const TI* __restrict__ in, TO* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = from_f<TO>(to_f(in[i]));
}

template <typename TI, typename TO>
int launch_cast(const TI* in, TO* out, long long n, cudaStream_t s) {
  const long long blocks = (n + 255) / 256 < GRID_CAP ? (n + 255) / 256 : GRID_CAP;
  cast_kernel<TI, TO><<<(int)blocks, 256, 0, s>>>(in, out, n);
  return (int)cudaGetLastError();
}

// h (float32) -> gval = gelu(h) rounded to T; h is overwritten with the
// exact derivative cdf(h) + h * pdf(h).
template <typename T>
__global__ void gelu_grad_kernel(float* __restrict__ h, T* __restrict__ gval, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = h[i];
    const float cdf = 0.5f * (1.f + erff(v * 0.70710678118654752f));
    gval[i] = from_f<T>(v * cdf);
    h[i] = cdf + v * 0.39894228040143268f * expf(-0.5f * v * v);
  }
}

// --------------------------------------------------------------- LayerNorm
// Forward recompute: y = LN(x) in T, plus each row's mean and rstd.  One warp
// per row, the forward kernel's arithmetic.
template <typename T>
__global__ void ln_stats_kernel(const T* __restrict__ x, T* __restrict__ y,
                                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, int rows, int C) {
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
  const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
  T* yr = y + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = from_f<T>((to_f(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Input grad of y = LN(x) * gamma + beta given dL/dy (float32):
//   dx = rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)),  dxh = dy * gamma.
// Added to `acc32` (the layer's float32 running grad) when it is given;
// otherwise rounded to T and written to `out_t`, or added to it in T when
// `accumulate` (dcontext summed across layers in the compute dtype).
template <typename T>
__global__ void ln_bwd_kernel(const float* __restrict__ dy, const T* __restrict__ x,
                              const float* __restrict__ mean, const float* __restrict__ rstd,
                              const float* __restrict__ gamma, int rows, int C, float* acc32,
                              T* out_t, int accumulate) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float mu = mean[row], rs = rstd[row];
  const float* dyr = dy + (size_t)row * C;
  const T* xr = x + (size_t)row * C;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dxh = dyr[c] * gamma[c];
    s1 += dxh;
    s2 += dxh * ((to_f(xr[c]) - mu) * rs);
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (to_f(xr[c]) - mu) * rs;
    const float dx = rs * (dyr[c] * gamma[c] - m1 - xhat * m2);
    const size_t idx = (size_t)row * C + c;
    if (acc32 != nullptr) {
      acc32[idx] += dx;
    } else {
      float v = round_to<T>(dx);
      if (accumulate) v = to_f(out_t[idx]) + v;
      out_t[idx] = from_f<T>(v);
    }
  }
}

// ------------------------------------------------------------ column sums
// sum[c] = sum_r a[r, c]; with x given, also xsum[c] = sum_r a[r, c] * xhat[r, c]
// where xhat = (x - mean[s]) * rstd[s] and the statistic index is
// s = (r / rows_per_stat) * stats_per_row + c / cols_per_stat (LayerNorm: one
// per row; GroupNorm: one per (batch, group)).  One block per 32 columns,
// 32 row lanes, each column's partials added in a fixed order: K2's column
// sums.  (The block count is only C/32: on an H100 with 8 lanes the
// LayerNorm grads took 10% of a flagship train step's device time.  K3 and
// K4 take the split over rows below, `launch_colsums`, which fills the card.)
constexpr int CS_COLS = 32, CS_LANES = 32;

template <typename TA, typename T>
__global__ void colsum_kernel(const TA* __restrict__ a, int rows, int cols,
                              float* __restrict__ sum, float* __restrict__ xsum,
                              const T* __restrict__ x, const float* __restrict__ mean,
                              const float* __restrict__ rstd, int rows_per_stat,
                              int stats_per_row, int cols_per_stat) {
  __shared__ float red_s[CS_LANES][CS_COLS + 1];
  __shared__ float red_x[CS_LANES][CS_COLS + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * CS_COLS + tx;
  float s = 0.f, xs = 0.f;
  if (c < cols) {
    for (int r = ty; r < rows; r += CS_LANES) {
      const size_t idx = (size_t)r * cols + c;
      const float v = to_f(a[idx]);
      s += v;
      if (x != nullptr) {
        const int st = (r / rows_per_stat) * stats_per_row + c / cols_per_stat;
        xs += v * ((to_f(x[idx]) - mean[st]) * rstd[st]);
      }
    }
  }
  red_s[ty][tx] = s;
  red_x[ty][tx] = xs;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float ts = 0.f, tx_sum = 0.f;
    for (int i = 0; i < CS_LANES; ++i) {
      ts += red_s[i][tx];
      tx_sum += red_x[i][tx];
    }
    sum[c] = ts;
    if (xsum != nullptr) xsum[c] = tx_sum;
  }
}

template <typename TA, typename T>
int launch_colsum(const TA* a, int rows, int cols, float* sum, float* xsum, const T* x,
                  const float* mean, const float* rstd, int rows_per_stat, int stats_per_row,
                  int cols_per_stat, cudaStream_t s) {
  colsum_kernel<TA, T><<<(cols + CS_COLS - 1) / CS_COLS, dim3(CS_COLS, CS_LANES), 0, s>>>(
      a, rows, cols, sum, xsum, x, mean, rstd, rows_per_stat, stats_per_row, cols_per_stat);
  return (int)cudaGetLastError();
}

template <typename TA>
int launch_colsum(const TA* a, int rows, int cols, float* sum, cudaStream_t s) {
  return launch_colsum<TA, TA>(a, rows, cols, sum, nullptr, nullptr, nullptr, nullptr, 1, 1,
                               cols, s);
}

// Column sums split over rows (K3, K4).  One sum of a call: sum[c] over all
// rows of `a` and, with x given, xsum[c] as colsum_kernel computes them.
template <typename T>
struct ColSum {
  const void* a;      // (rows, cols): float32 when a_f32, else T
  int a_f32;
  float *sum, *xsum;  // (cols,) float32; xsum null unless x is given
  const T* x;
  const float *mean, *rstd;
  int rows_per_stat, stats_per_row, cols_per_stat;
  int slot;           // this sum's first row of a chunk's partials
};

// The rows cut into S chunks so that (cols / 32) x S blocks come to about one
// an SM (a call of two sums, K4's, two), each chunk at least CS_MIN_ROWS rows.
constexpr int CS_MIN_ROWS = 64;
struct ColsumPlan {
  int splits, chunk;
};
inline ColsumPlan colsum_plan(int rows, int cols) {
  const int col_blocks = gtc::cdiv(cols, CS_COLS);
  const int want =
      std::max(1, std::min(gtc::cdiv(gtc::SMS, col_blocks), rows / CS_MIN_ROWS));
  const int chunk = gtc::cdiv(rows, want);
  return {gtc::cdiv(rows, chunk), chunk};
}

// Floats of partials a split call of `slots` sums over (rows, cols) takes (0
// when it would not split).
inline long long colsum_elems(int rows, int cols, int slots) {
  const ColsumPlan p = colsum_plan(rows, cols);
  return p.splits > 1 ? (long long)p.splits * slots * cols : 0;
}

// Block (column block, chunk z, sum j): the chunk's sums of 32 columns,
// 32 row lanes, each lane's rows in order and the lanes in order.  Written
// to the sum's outputs when `part` is null (one chunk), else to
// part[z][slot][c] (and the xsum to slot + 1).
template <typename T>
__global__ void colsum_split_kernel(const ColSum<T> j0, const ColSum<T> j1, int rows, int cols,
                                    int chunk, float* __restrict__ part, int slots) {
  __shared__ float red_s[CS_LANES][CS_COLS + 1];
  __shared__ float red_x[CS_LANES][CS_COLS + 1];
  const ColSum<T> j = blockIdx.z == 0 ? j0 : j1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * CS_COLS + tx;
  const int r0 = blockIdx.y * chunk, r1 = min(rows, r0 + chunk);
  float s = 0.f, xs = 0.f;
  if (c < cols) {
    for (int r = r0 + ty; r < r1; r += CS_LANES) {
      const size_t idx = (size_t)r * cols + c;
      const float v = j.a_f32 ? static_cast<const float*>(j.a)[idx]
                              : to_f(static_cast<const T*>(j.a)[idx]);
      s += v;
      if (j.x != nullptr) {
        const int st = (r / j.rows_per_stat) * j.stats_per_row + c / j.cols_per_stat;
        xs += v * ((to_f(j.x[idx]) - j.mean[st]) * j.rstd[st]);
      }
    }
  }
  red_s[ty][tx] = s;
  red_x[ty][tx] = xs;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float ts = 0.f, txs = 0.f;
    for (int i = 0; i < CS_LANES; ++i) {
      ts += red_s[i][tx];
      txs += red_x[i][tx];
    }
    float* sum = j.sum;
    float* xsum = j.xsum;
    if (part != nullptr) {
      sum = part + ((size_t)blockIdx.y * slots + j.slot) * cols;
      xsum = sum + cols;
    }
    sum[c] = ts;
    if (j.x != nullptr) xsum[c] = txs;
  }
}

// out[slot][c] = the chunks' partials part[z][slot][c] summed in chunk order.
struct ColsumOuts {
  float* out[4];
};
__global__ void colsum_finish_kernel(const float* __restrict__ part, int splits, int cols,
                                     int slots, const ColsumOuts o) {
  const int n = slots * cols;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float v = part[i];
    for (int z = 1; z < splits; ++z) v += part[(size_t)z * n + i];
    o.out[i / cols][i % cols] = v;
  }
}

// One or two column sums (j1 null: one) over the same rows and columns in
// one launch, then, when the rows are split, one launch of the second pass.
// `part` holds colsum_elems(rows, cols, slots) floats.
template <typename T>
int launch_colsums(ColSum<T> j0, const ColSum<T>* j1, int rows, int cols, float* part,
                   cudaStream_t s) {
  ColSum<T> second = j1 != nullptr ? *j1 : j0;
  j0.slot = 0;
  second.slot = j0.x != nullptr ? 2 : 1;
  const int slots = j1 != nullptr ? second.slot + (second.x != nullptr ? 2 : 1) : second.slot;
  const ColsumPlan p = colsum_plan(rows, cols);
  float* chunks = p.splits > 1 ? part : nullptr;
  if (p.splits > 1 && part == nullptr) return -1;
  const dim3 grid(gtc::cdiv(cols, CS_COLS), p.splits, j1 != nullptr ? 2 : 1);
  colsum_split_kernel<T><<<grid, dim3(CS_COLS, CS_LANES), 0, s>>>(j0, second, rows, cols,
                                                                  p.chunk, chunks, slots);
  T1D_CHECK((int)cudaGetLastError());
  if (p.splits == 1) return 0;
  ColsumOuts o = {{j0.sum, j0.xsum, second.sum, second.xsum}};
  if (j0.x == nullptr) o = {{j0.sum, second.sum, second.xsum, nullptr}};
  const int n = slots * cols;
  colsum_finish_kernel<<<gtc::cdiv(n, 256), 256, 0, s>>>(part, p.splits, cols, slots, o);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- GroupNorm
// One warp per (batch, group), GN_WARPS groups a block: a group is L x
// C/groups values (8..64 at the stack shapes), too few for a block of its
// own.  The values of warp w (= b * groups + g) lie at rows b L.. of the
// columns g C/groups..; i runs over them row by row.
constexpr int GN_WARPS = 8;

__device__ __forceinline__ size_t gn_index(int b, int g, int i, int L, int C, int cpg) {
  return (size_t)b * L * C + (size_t)(i / cpg) * C + (size_t)g * cpg + i % cpg;
}

// Forward recompute: y = GN(x) rounded to T, plus each group's mean and rstd
// (the forward kernel's arithmetic, float32).
template <typename T>
__global__ void __launch_bounds__(GN_WARPS * 32)
gn_stats_kernel(const T* __restrict__ x, T* __restrict__ y, float* __restrict__ mean_out,
                float* __restrict__ rstd_out, const float* __restrict__ gamma,
                const float* __restrict__ beta, int B, int L, int C, int groups, float eps) {
  const int w = blockIdx.x * GN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= B * groups) return;
  const int b = w / groups, g = w % groups;
  const int cpg = C / groups, n = L * cpg;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += to_f(x[gn_index(b, g, i, L, C, cpg)]);
  const float mean = warp_sum(s) / n;
  float v = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float d = to_f(x[gn_index(b, g, i, L, C, cpg)]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / n + eps);
  for (int i = lane; i < n; i += 32) {
    const size_t idx = gn_index(b, g, i, L, C, cpg);
    const int c = g * cpg + i % cpg;
    y[idx] = from_f<T>((to_f(x[idx]) - mean) * rstd * gamma[c] + beta[c]);
  }
  if (lane == 0) {
    mean_out[w] = mean;
    rstd_out[w] = rstd;
  }
}

// dx = rstd * (dxh - mean_g(dxh) - xhat * mean_g(dxh * xhat)), dxh = dgn * gamma,
// means over the group's L x C/groups values.
template <typename T>
__global__ void __launch_bounds__(GN_WARPS * 32)
gn_bwd_kernel(const float* __restrict__ dgn, const T* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ gamma, T* __restrict__ dx, int B, int L, int C,
              int groups) {
  const int w = blockIdx.x * GN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= B * groups) return;
  const int b = w / groups, g = w % groups;
  const int cpg = C / groups, n = L * cpg;
  const float mu = mean[w], rs = rstd[w];
  // dxh rounded to float32 once (no FMA contraction into dxh - m1), as the
  // plain version holds it: a group of one value then gives dx = 0 exactly,
  // not its rounding error times rstd (1/sqrt(eps) there)
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < n; i += 32) {
    const size_t idx = gn_index(b, g, i, L, C, cpg);
    const float dxh = __fmul_rn(dgn[idx], gamma[g * cpg + i % cpg]);
    s1 += dxh;
    s2 += dxh * ((to_f(x[idx]) - mu) * rs);
  }
  const float m1 = warp_sum(s1) / n;
  const float m2 = warp_sum(s2) / n;
  for (int i = lane; i < n; i += 32) {
    const size_t idx = gn_index(b, g, i, L, C, cpg);
    const float xhat = (to_f(x[idx]) - mu) * rs;
    const float dxh = __fmul_rn(dgn[idx], gamma[g * cpg + i % cpg]);
    dx[idx] = from_f<T>(rs * (dxh - m1 - xhat * m2));
  }
}

// ---------------------------------------------------------------- attention
// Backward of o = softmax(q k^T * scale) v for one (batch, head) per block.
// q (B*L, heads*d), kv (B*m, 2*heads*d) with k then v, dout (B*L, heads*d),
// all T.  Writes the recomputed forward output o (B*L, heads*d), dq (B*L,
// heads*d) and dkv (B*m, 2*heads*d), each rounded to T.
constexpr int ATTN_BWD_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ATTN_BWD_THREADS)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                     const T* __restrict__ dout, T* __restrict__ o, T* __restrict__ dq,
                     T* __restrict__ dkv, int L, int m, int heads, int d, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int inner = heads * d, dp = d + 1;  // +1: no bank conflicts across rows
  float* qs = smem;            // L x dp
  float* ks = qs + L * dp;     // m x dp
  float* vs = ks + m * dp;     // m x dp
  float* dos = vs + m * dp;    // L x dp
  float* ps = dos + L * dp;    // L x m: probabilities, float32
  float* dps = ps + L * m;     // L x m: dP, then dS rounded to T
  const T* qb = q + (size_t)b * L * inner + h * d;
  const T* kb = kv + (size_t)b * m * 2 * inner + h * d;
  const T* vb = kb + inner;
  const T* dob = dout + (size_t)b * L * inner + h * d;
  for (int i = threadIdx.x; i < L * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    qs[r * dp + c] = to_f(qb[(size_t)r * inner + c]);
    dos[r * dp + c] = to_f(dob[(size_t)r * inner + c]);
  }
  for (int i = threadIdx.x; i < m * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    ks[r * dp + c] = to_f(kb[(size_t)r * 2 * inner + c]);
    vs[r * dp + c] = to_f(vb[(size_t)r * 2 * inner + c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * m; i += blockDim.x) {
    const int r = i / m, j = i % m;
    float s = 0.f, t = 0.f;
    for (int k = 0; k < d; ++k) {
      s = fmaf(qs[r * dp + k], ks[j * dp + k], s);
      t = fmaf(dos[r * dp + k], vs[j * dp + k], t);
    }
    ps[i] = s * scale;
    dps[i] = t;
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
    for (int j = lane; j < m; j += 32) pr[j] = pr[j] / sum;
  }
  __syncthreads();
  // the forward output (for dW_out) and dV, both from the rounded P
  for (int i = threadIdx.x; i < L * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    float s = 0.f;
    for (int j = 0; j < m; ++j) s = fmaf(round_to<T>(ps[r * m + j]), vs[j * dp + c], s);
    o[((size_t)b * L + r) * inner + h * d + c] = from_f<T>(s);
  }
  for (int i = threadIdx.x; i < m * d; i += blockDim.x) {
    const int j = i / d, c = i % d;
    float s = 0.f;
    for (int r = 0; r < L; ++r) s = fmaf(round_to<T>(ps[r * m + j]), dos[r * dp + c], s);
    dkv[((size_t)b * m + j) * 2 * inner + inner + h * d + c] = from_f<T>(s);
  }
  // dS = P (dP - rowsum(dP P)) scale, rounded; one warp per row
  for (int r = threadIdx.x >> 5; r < L; r += nwarps) {
    const float* pr = ps + r * m;
    float* dr = dps + r * m;
    float rs = 0.f;
    for (int j = lane; j < m; j += 32) rs += dr[j] * pr[j];
    rs = warp_sum(rs);
    for (int j = lane; j < m; j += 32) dr[j] = round_to<T>(pr[j] * (dr[j] - rs) * scale);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    float s = 0.f;
    for (int j = 0; j < m; ++j) s = fmaf(dps[r * m + j], ks[j * dp + c], s);
    dq[((size_t)b * L + r) * inner + h * d + c] = from_f<T>(s);
  }
  for (int i = threadIdx.x; i < m * d; i += blockDim.x) {
    const int j = i / d, c = i % d;
    float s = 0.f;
    for (int r = 0; r < L; ++r) s = fmaf(dps[r * m + j], qs[r * dp + c], s);
    dkv[((size_t)b * m + j) * 2 * inner + h * d + c] = from_f<T>(s);
  }
}

size_t attention_bwd_smem_bytes(int L, int m, int d) {
  return sizeof(float) * ((size_t)(2 * L + 2 * m) * (d + 1) + 2 * (size_t)L * m);
}

// ------------------------------------------------------------- host helpers
inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// Byte offsets into the caller's workspace.  float32 buffers first, then
// buffers of the compute dtype (element size `es`).
struct BwdWorkspace {
  size_t partial, dy32, h32, dh32, dq_in32, dkv_in32, q_mean, q_rstd, kv_mean, kv_rstd, gn_mean,
      gn_rstd, dy_dt, gd, dh_dt, q_in, kv_in, q, kv, dout, o, dq, dkv, total;
};

// Floats of partials a K3 call takes: its weight grad's split (bf16) and its
// column sum's, which share them in stream order.
long long conv_out_partial_elems(long long R, long long C, size_t es) {
  const long long gemm = es == 2 ? gtc::split_elems((int)C, (int)C, (int)R) : 0;
  return std::max(gemm, colsum_elems((int)R, (int)C, 1));
}

BwdWorkspace plan_bwd(long long B, long long L, long long C, long long ctx_len,
                      long long ctx_c, long long heads, long long head_dim, long long mult,
                      size_t es) {
  const long long R = B * L, I = heads * head_dim, H = mult * C;
  const long long kv_rows = R > B * ctx_len ? R : B * ctx_len;
  const long long kv_in = R * C > B * ctx_len * ctx_c ? R * C : B * ctx_len * ctx_c;
  BwdWorkspace w;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += align256(bytes);
    return here;
  };
  // First, at offset 0, so that K3, which is handed the whole workspace but
  // not its plan, finds it there: the largest of the weight grads split over
  // rows of a layer and of K3 and K4 (bf16 only: the float32 products stay
  // on the CUDA cores, unsplit), and the column sums of K3 and K4 (up to
  // three sums of R x C).  The products and sums of a call take it in turn,
  // in stream order.
  long long part = std::max(conv_out_partial_elems(R, C, es), colsum_elems((int)R, (int)C, 3));
  if (es == 2) {
    const long long shapes[][3] = {{C, C, R}, {C, H, R},     {H, C, R},
                                   {C, I, R}, {I, C, R},     {2 * I, C, R},
                                   {2 * I, ctx_c, B * ctx_len}};
    for (const auto& sh : shapes)
      if (sh[0] > 0 && sh[1] > 0 && sh[2] > 0)
        part = std::max(part, gtc::split_elems((int)sh[0], (int)sh[1], (int)sh[2]));
  }
  w.partial = take(4 * part);
  w.dy32 = take(4 * R * C);
  w.h32 = take(4 * R * H);
  w.dh32 = take(4 * R * H);
  w.dq_in32 = take(4 * R * C);
  w.dkv_in32 = take(4 * kv_in);
  w.q_mean = take(4 * R);
  w.q_rstd = take(4 * R);
  w.kv_mean = take(4 * kv_rows);
  w.kv_rstd = take(4 * kv_rows);
  w.gn_mean = take(4 * B * 32);
  w.gn_rstd = take(4 * B * 32);
  w.dy_dt = take(es * R * C);
  w.gd = take(es * R * H);
  w.dh_dt = take(es * R * H);
  w.q_in = take(es * R * C);
  w.kv_in = take(es * kv_in);
  w.q = take(es * R * I);
  w.kv = take(es * kv_rows * 2 * I);
  w.dout = take(es * R * I);
  w.o = take(es * R * I);
  w.dq = take(es * R * I);
  w.dkv = take(es * kv_rows * 2 * I);
  w.total = at;
  return w;
}

template <typename T>
struct Buffers {
  float *dy32, *h32, *dh32, *dq_in32, *dkv_in32, *q_mean, *q_rstd, *kv_mean, *kv_rstd,
      *gn_mean, *gn_rstd, *partial;
  T *dy_dt, *gd, *dh_dt, *q_in, *kv_in, *q, *kv, *dout, *o, *dq, *dkv;
};

template <typename T>
Buffers<T> carve(char* base, const BwdWorkspace& w) {
  Buffers<T> b;
  b.dy32 = (float*)(base + w.dy32);
  b.h32 = (float*)(base + w.h32);
  b.dh32 = (float*)(base + w.dh32);
  b.dq_in32 = (float*)(base + w.dq_in32);
  b.dkv_in32 = (float*)(base + w.dkv_in32);
  b.q_mean = (float*)(base + w.q_mean);
  b.q_rstd = (float*)(base + w.q_rstd);
  b.kv_mean = (float*)(base + w.kv_mean);
  b.kv_rstd = (float*)(base + w.kv_rstd);
  b.gn_mean = (float*)(base + w.gn_mean);
  b.gn_rstd = (float*)(base + w.gn_rstd);
  b.partial = (float*)(base + w.partial);
  b.dy_dt = (T*)(base + w.dy_dt);
  b.gd = (T*)(base + w.gd);
  b.dh_dt = (T*)(base + w.dh_dt);
  b.q_in = (T*)(base + w.q_in);
  b.kv_in = (T*)(base + w.kv_in);
  b.q = (T*)(base + w.q);
  b.kv = (T*)(base + w.kv);
  b.dout = (T*)(base + w.dout);
  b.o = (T*)(base + w.o);
  b.dq = (T*)(base + w.dq);
  b.dkv = (T*)(base + w.dkv);
  return b;
}

constexpr int ROW_WARPS = 8;

template <typename T>
int launch_ln_stats(const T* x, T* y, float* mean, float* rstd, const float* g,
                    const float* b, int rows, int C, cudaStream_t s) {
  ln_stats_kernel<T><<<(rows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(
      x, y, mean, rstd, g, b, rows, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ln_bwd(const float* dy, const T* x, const float* mean, const float* rstd,
                  const float* gamma, int rows, int C, float* acc32, T* out_t, int accumulate,
                  cudaStream_t s) {
  ln_bwd_kernel<T><<<(rows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(
      dy, x, mean, rstd, gamma, rows, C, acc32, out_t, accumulate);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attention_bwd(const T* q, const T* kv, const T* dout, T* o, T* dq, T* dkv, int B,
                         int L, int m, int heads, int d, cudaStream_t s) {
  const size_t smem = attention_bwd_smem_bytes(L, m, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_bwd_kernel<T><<<B * heads, ATTN_BWD_THREADS, smem, s>>>(
      q, kv, dout, o, dq, dkv, L, m, heads, d, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// Backward through one pre-LN attention sub-block evaluated at the stashed
// input `a` (q side) and `kv_src` (kv side).  Adds the q path's input grad
// to dy32; the kv path's input grad is added to dy32 too (self-attention,
// dctx == null) or goes to dctx (cross-attention).  w: the sub-block's 8
// ABI weights; dw: their 8 float32 grads.
template <typename T>
int attention_bwd(float* dy32, const T* a, const T* kv_src, int kv_rows, int kv_c, int m,
                  const void* const* w, void* const* dw, T* dctx, int dctx_accumulate,
                  const Buffers<T>& bf, int B, int L, int C, int heads, int d,
                  cudaStream_t s) {
  const int R = B * L, I = heads * d;
  const float* ns = (const float*)w[0];
  const float* nb = (const float*)w[1];
  const float* cs = (const float*)w[2];
  const float* cb = (const float*)w[3];
  const T* wq = (const T*)w[4];
  const T* wkv = (const T*)w[5];
  const T* wout = (const T*)w[6];
  float* const* g = (float* const*)dw;
  // recompute the forward's norms and projections
  T1D_CHECK(launch_ln_stats<T>(a, bf.q_in, bf.q_mean, bf.q_rstd, ns, nb, R, C, s));
  T1D_CHECK(launch_ln_stats<T>(kv_src, bf.kv_in, bf.kv_mean, bf.kv_rstd, cs, cb, kv_rows,
                               kv_c, s));
  T1D_CHECK(launch_gemm_tc(gemm_nt<T, T>(bf.q_in, wq, bf.q, R, I, C), s));
  T1D_CHECK(launch_gemm_tc(gemm_nt<T, T>(bf.kv_in, wkv, bf.kv, kv_rows, 2 * I, kv_c), s));
  // out-projection backward
  T1D_CHECK(launch_cast<float, T>(dy32, bf.dy_dt, (long long)R * C, s));
  T1D_CHECK(launch_gemm_tc(gemm_nn<T, T>(bf.dy_dt, wout, bf.dout, R, I, C), s));
  T1D_CHECK(launch_colsum<float>(dy32, R, C, g[7], s));
  T1D_CHECK(launch_attention_bwd<T>(bf.q, bf.kv, bf.dout, bf.o, bf.dq, bf.dkv, B, L, m,
                                    heads, d, s));
  T1D_CHECK(launch_gemm_tc(gemm_tn<T>(bf.dy_dt, bf.o, g[6], R, C, I), s, bf.partial));
  T1D_CHECK(launch_gemm_tc(gemm_tn<T>(bf.dq, bf.q_in, g[4], R, I, C), s, bf.partial));
  T1D_CHECK(launch_gemm_tc(gemm_tn<T>(bf.dkv, bf.kv_in, g[5], kv_rows, 2 * I, kv_c), s,
                           bf.partial));
  T1D_CHECK(launch_gemm_tc(gemm_nn<T, float>(bf.dq, wq, bf.dq_in32, R, C, I), s));
  T1D_CHECK(launch_gemm_tc(gemm_nn<T, float>(bf.dkv, wkv, bf.dkv_in32, kv_rows, kv_c, 2 * I),
                           s));
  // LayerNorm parameter grads, then input grads
  T1D_CHECK(launch_colsum<float, T>(bf.dq_in32, R, C, g[1], g[0], a, bf.q_mean, bf.q_rstd, 1,
                                    1, C, s));
  T1D_CHECK(launch_colsum<float, T>(bf.dkv_in32, kv_rows, kv_c, g[3], g[2], kv_src,
                                    bf.kv_mean, bf.kv_rstd, 1, 1, kv_c, s));
  T1D_CHECK(launch_ln_bwd<T>(bf.dq_in32, a, bf.q_mean, bf.q_rstd, ns, R, C, dy32, nullptr, 0,
                             s));
  if (dctx != nullptr)
    return launch_ln_bwd<T>(bf.dkv_in32, kv_src, bf.kv_mean, bf.kv_rstd, cs, kv_rows, kv_c,
                            nullptr, dctx, dctx_accumulate, s);
  return launch_ln_bwd<T>(bf.dkv_in32, kv_src, bf.kv_mean, bf.kv_rstd, cs, kv_rows, kv_c,
                          dy32, nullptr, 0, s);
}

// K2: one layer's backward, feed-forward, then cross-attention, then
// self-attention, from the layer's stashed inputs a (self), c (cross) and
// f (feed-forward).
template <typename T>
int layer_bwd(const T* dy, const T* a, const T* c, const T* f, const T* ctx,
              const void* const* w, T* dy_prev, T* dctx, int dctx_accumulate,
              void* const* dw, const Buffers<T>& bf, int B, int L, int C, int ctx_len,
              int ctx_c, int heads, int d, int mult, cudaStream_t s) {
  const int R = B * L, H = mult * C;
  const bool cross = ctx != nullptr;
  const int ff0 = cross ? 16 : 8;
  const T* w0 = (const T*)w[ff0];
  const float* b0 = (const float*)w[ff0 + 1];
  const T* w2 = (const T*)w[ff0 + 2];
  float* const* g = (float* const*)dw;

  T1D_CHECK(launch_cast<T, float>(dy, bf.dy32, (long long)R * C, s));
  // feed-forward backward at the stashed input f: recompute h, then
  // dW2 = dy^T gelu(h), dh = (dy W2) * gelu'(h), dW0 = dh^T f, dy += dh W0
  GemmArgs<T, float> h = gemm_nt<T, float>(f, w0, bf.h32, R, H, C);
  h.epi = EPI_BIAS;
  h.bias = b0;
  T1D_CHECK(launch_gemm_tc(h, s));
  {
    const long long n = (long long)R * H;
    const long long blocks = (n + 255) / 256 < GRID_CAP ? (n + 255) / 256 : GRID_CAP;
    gelu_grad_kernel<T><<<(int)blocks, 256, 0, s>>>(bf.h32, bf.gd, n);
    T1D_CHECK((int)cudaGetLastError());
  }
  T1D_CHECK(launch_gemm_tc(gemm_tn<T>(dy, bf.gd, g[ff0 + 2], R, C, H), s, bf.partial));
  T1D_CHECK(launch_colsum<T>(dy, R, C, g[ff0 + 3], s));
  GemmArgs<T, float> dh = gemm_nn<T, float>(dy, w2, bf.dh32, R, H, C);
  dh.epi = EPI_MUL;
  dh.mul = bf.h32;
  dh.out_t = bf.dh_dt;
  T1D_CHECK(launch_gemm_tc(dh, s));
  T1D_CHECK(launch_gemm_tc(gemm_tn<T>(bf.dh_dt, f, g[ff0], R, H, C), s, bf.partial));
  T1D_CHECK(launch_colsum<float>(bf.dh32, R, H, g[ff0 + 1], s));
  GemmArgs<T, float> res = gemm_nn<T, float>(bf.dh_dt, w0, bf.dy32, R, C, H);
  res.epi = EPI_RES;
  res.res = bf.dy32;
  T1D_CHECK(launch_gemm_tc(res, s));

  if (cross)
    T1D_CHECK(attention_bwd<T>(bf.dy32, c, ctx, B * ctx_len, ctx_c, ctx_len, w + 8, dw + 8,
                               dctx, dctx_accumulate, bf, B, L, C, heads, d, s));
  T1D_CHECK(attention_bwd<T>(bf.dy32, a, a, R, C, L, w, dw, (T*)nullptr, 0, bf, B, L, C,
                             heads, d, s));
  return launch_cast<float, T>(bf.dy32, dy_prev, (long long)R * C, s);
}

// A plain column sum of `a` into `sum`
template <typename T, typename TA>
ColSum<T> col_sum(const TA* a, float* sum) {
  ColSum<T> j = {};
  j.a = a;
  j.a_f32 = std::is_same<TA, float>::value;
  j.sum = sum;
  return j;
}

// K3: dW = g^T y, db = sum g, dy = g W.  `partial`: conv_out_partial_elems
// floats.
template <typename T>
int conv_out_bwd(const T* g, const T* y, const T* w, T* dy, float* dw, float* db, float* partial,
                 int R, int C, cudaStream_t s) {
  T1D_CHECK(launch_gemm_tc(gemm_tn<T>(g, y, dw, R, C, C), s, partial));
  T1D_CHECK(launch_colsums(col_sum<T>(g, db), (const ColSum<T>*)nullptr, R, C, partial, s));
  return launch_gemm_tc(gemm_nn<T, T>(g, w, dy, R, C, C), s);
}

// K4: recompute GroupNorm(32, eps 1e-6), then the conv-in and GroupNorm
// backward.
template <typename T>
int conv_in_gn_bwd(const T* x, const T* dy0, const T* w, const float* gs, const float* gb,
                   T* dx, float* dw, float* db, float* dgs, float* dgb, const Buffers<T>& bf,
                   int B, int L, int C, cudaStream_t s) {
  const int R = B * L, groups = 32;
  const int gn_blocks = gtc::cdiv((long long)B * groups, GN_WARPS);
  gn_stats_kernel<T><<<gn_blocks, GN_WARPS * 32, 0, s>>>(x, bf.q_in, bf.gn_mean, bf.gn_rstd, gs,
                                                         gb, B, L, C, groups, 1e-6f);
  T1D_CHECK((int)cudaGetLastError());
  T1D_CHECK(launch_gemm_tc(gemm_tn<T>(dy0, bf.q_in, dw, R, C, C), s, bf.partial));
  T1D_CHECK(launch_gemm_tc(gemm_nn<T, float>(dy0, w, bf.dq_in32, R, C, C), s));
  // db = sum dy0, and dbeta = sum dgn, dgamma = sum dgn * xhat, in one launch
  ColSum<T> dg = col_sum<T>(bf.dq_in32, dgb);
  dg.xsum = dgs;
  dg.x = x;
  dg.mean = bf.gn_mean;
  dg.rstd = bf.gn_rstd;
  dg.rows_per_stat = L;
  dg.stats_per_row = groups;
  dg.cols_per_stat = C / groups;
  T1D_CHECK(launch_colsums(col_sum<T>(dy0, db), &dg, R, C, bf.partial, s));
  gn_bwd_kernel<T><<<gn_blocks, GN_WARPS * 32, 0, s>>>(bf.dq_in32, x, bf.gn_mean, bf.gn_rstd,
                                                       gs, dx, B, L, C, groups);
  return (int)cudaGetLastError();
}

// One call of `launch_gemm_tc` on its own (the entry `t1d_gemm_tc`).
template <typename T, typename O>
int gemm_tc_alone(const void* A, long long sam, long long sak, const void* B, long long sbk,
                  long long sbn, void* out, int M, int N, int K, int epi, const void* bias,
                  const void* res, const void* mul, void* out_t, int split, void* partial,
                  int* route, int* splits, cudaStream_t s) {
  GemmArgs<T, O> g = {};
  g.A = (const T*)A;
  g.sam = sam;
  g.sak = sak;
  g.B = (const T*)B;
  g.sbk = sbk;
  g.sbn = sbn;
  g.out = (O*)out;
  g.M = M;
  g.N = N;
  g.K = K;
  g.epi = epi;
  g.bias = (const float*)bias;
  g.res = (const O*)res;
  g.mul = (const float*)mul;
  g.out_t = (T*)out_t;
  return launch_gemm_tc(g, s, split ? (float*)partial : nullptr, route, splits);
}

bool shapes_ok(int L, int C, int ctx_len, bool cross, int head_dim) {
  return C % 32 == 0 && L >= 1 && L <= 64 && head_dim >= 1 && head_dim <= 128 &&
         (!cross || (ctx_len >= 1 && ctx_len <= 64));
}

}  // namespace

extern "C" {

// Bytes of workspace `t1d_bwd_layer` and `t1d_bwd_conv_in_gn` take (and
// `t1d_bwd_conv_out`, which uses its start).
long long t1d_bwd_workspace_bytes(int B, int L, int C, int ctx_len, int ctx_c, int heads,
                                  int head_dim, int mult, int dtype) {
  return (long long)plan_bwd(B, L, C, ctx_len, ctx_c, heads, head_dim, mult,
                             dtype == DTYPE_BF16 ? 2 : 4)
      .total;
}

// Floats of `partial` a `t1d_bwd_conv_out` call takes: its bf16 weight
// grad's split over rows and its column sum's, one after the other in the
// same floats.  A `t1d_bwd_workspace_bytes` workspace of the same rows and
// C holds at least this many at its start.
long long t1d_bwd_conv_out_partial_elems(int rows, int C, int dtype) {
  if (rows < 1 || C < 1) return 0;
  return conv_out_partial_elems(rows, C, dtype == DTYPE_BF16 ? 2 : 4);
}

// K3.  g, y (rows, C) and w (C, C) in the compute dtype; dy (rows, C) out in
// the compute dtype, dw (C, C) and db (C,) float32; partial:
// t1d_bwd_conv_out_partial_elems floats.
int t1d_bwd_conv_out(const void* g, const void* y, const void* w, void* dy, void* dw,
                     void* db, void* partial, int rows, int C, int dtype, int device,
                     void* stream) {
  if (rows < 1 || C < 1 || C % 32 != 0) return -1;
  T1D_CHECK((int)cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return conv_out_bwd<float>((const float*)g, (const float*)y, (const float*)w,
                               (float*)dy, (float*)dw, (float*)db, (float*)partial, rows, C,
                               s);
  if (dtype == DTYPE_BF16)
    return conv_out_bwd<__nv_bfloat16>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)y, (const __nv_bfloat16*)w,
        (__nv_bfloat16*)dy, (float*)dw, (float*)db, (float*)partial, rows, C, s);
  return -1;
}

// K2.  dy, a, c, f (B, L, C) and ctx (B, ctx_len, ctx_c) or null (c is null
// too then), in the compute dtype; weights: the layer's ABI entries (self
// attention's 8, the cross-attention's 8 with a context, the feed-forward's
// 4: matrices (out, in) in the compute dtype, vectors float32).  Out:
// dy_prev (B, L, C) and, with a context, dctx (B, ctx_len, ctx_c) in the
// compute dtype (added to what it holds when `dctx_accumulate`); dweights:
// float32 grads in the order and shapes of `weights`.
int t1d_bwd_layer(const void* dy, const void* a, const void* c, const void* f,
                  const void* ctx, const void* const* weights, int n_weights, void* dy_prev,
                  void* dctx, int dctx_accumulate, void* const* dweights, void* workspace,
                  int B, int L, int C, int ctx_len, int ctx_c, int heads, int head_dim,
                  int mult, int dtype, int device, void* stream) {
  const bool cross = ctx != nullptr;
  if (n_weights != (cross ? 20 : 12) || !shapes_ok(L, C, ctx_len, cross, head_dim) ||
      (cross && (c == nullptr || dctx == nullptr)))
    return -1;
  T1D_CHECK((int)cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) {
    const BwdWorkspace p = plan_bwd(B, L, C, ctx_len, ctx_c, heads, head_dim, mult, 4);
    return layer_bwd<float>((const float*)dy, (const float*)a, (const float*)c,
                            (const float*)f, (const float*)ctx, weights, (float*)dy_prev,
                            (float*)dctx, dctx_accumulate, dweights,
                            carve<float>((char*)workspace, p), B, L, C, ctx_len, ctx_c,
                            heads, head_dim, mult, s);
  }
  if (dtype == DTYPE_BF16) {
    typedef __nv_bfloat16 bf;
    const BwdWorkspace p = plan_bwd(B, L, C, ctx_len, ctx_c, heads, head_dim, mult, 2);
    return layer_bwd<bf>((const bf*)dy, (const bf*)a, (const bf*)c, (const bf*)f,
                         (const bf*)ctx, weights, (bf*)dy_prev, (bf*)dctx, dctx_accumulate,
                         dweights, carve<bf>((char*)workspace, p), B, L, C, ctx_len, ctx_c,
                         heads, head_dim, mult, s);
  }
  return -1;
}

// K4.  x, dy0 (B, L, C) and w (C, C) in the compute dtype, gs, gb (C,)
// float32; out dx (B, L, C) in the compute dtype, dw (C, C), db, dgs, dgb
// (C,) float32.  The workspace is sized by `t1d_bwd_workspace_bytes` for the
// same B, L, C (any heads/mult).
int t1d_bwd_conv_in_gn(const void* x, const void* dy0, const void* w, const void* gs,
                       const void* gb, void* dx, void* dw, void* db, void* dgs, void* dgb,
                       void* workspace, int B, int L, int C, int dtype, int device,
                       void* stream) {
  if (!shapes_ok(L, C, 0, false, 1)) return -1;
  T1D_CHECK((int)cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) {
    const BwdWorkspace p = plan_bwd(B, L, C, 0, 0, 1, 1, 1, 4);
    return conv_in_gn_bwd<float>((const float*)x, (const float*)dy0, (const float*)w,
                                 (const float*)gs, (const float*)gb, (float*)dx, (float*)dw,
                                 (float*)db, (float*)dgs, (float*)dgb,
                                 carve<float>((char*)workspace, p), B, L, C, s);
  }
  if (dtype == DTYPE_BF16) {
    typedef __nv_bfloat16 bf;
    const BwdWorkspace p = plan_bwd(B, L, C, 0, 0, 1, 1, 1, 2);
    return conv_in_gn_bwd<bf>((const bf*)x, (const bf*)dy0, (const bf*)w, (const float*)gs,
                              (const float*)gb, (bf*)dx, (float*)dw, (float*)db,
                              (float*)dgs, (float*)dgb, carve<bf>((char*)workspace, p), B, L,
                              C, s);
  }
  return -1;
}

// One product through `launch_gemm_tc` alone (the GEMM of K1-K4; no model
// path calls this entry): out (M, N) = epilogue(A B) with A[m, k] =
// A[m sam + k sak], B[k, n] = B[k sbk + n sbn] in `dtype`; out float32 when
// `out_float`, else in `dtype` (float32 inputs give a float32 out); bias
// (N,) and mul (M, N) float32, res (M, N) of out's type, out_t (M, N) in
// `dtype`, each null unless the epilogue `epi` (gemm.cuh) reads it.
// `split` 1: a plain float32 sum is split over the rows of k as K2 splits
// its weight grads, into `partial` (t1d_gemm_partial_elems(M, N, K)
// floats); 0: no split.  `route` (0 CUDA cores, 1 tensor cores 64 x 64, 2
// tensor cores 128 x 128) and `splits` get what the call ran, when not
// null.
int t1d_gemm_tc(const void* A, long long sam, long long sak, const void* B, long long sbk,
                long long sbn, void* out, int out_float, int M, int N, int K, int epi,
                const void* bias, const void* res, const void* mul, void* out_t, int split,
                void* partial, int* route, int* splits, int dtype, int device,
                void* stream) {
  if (M < 1 || N < 1 || K < 1 || epi < EPI_NONE || epi > EPI_MUL) return -1;
  T1D_CHECK((int)cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return gemm_tc_alone<float, float>(A, sam, sak, B, sbk, sbn, out, M, N, K, epi, bias, res,
                                       mul, out_t, split, partial, route, splits, s);
  if (dtype == DTYPE_BF16 && out_float)
    return gemm_tc_alone<__nv_bfloat16, float>(A, sam, sak, B, sbk, sbn, out, M, N, K, epi,
                                               bias, res, mul, out_t, split, partial, route,
                                               splits, s);
  if (dtype == DTYPE_BF16)
    return gemm_tc_alone<__nv_bfloat16, __nv_bfloat16>(A, sam, sak, B, sbk, sbn, out, M, N, K,
                                                       epi, bias, res, mul, out_t, split,
                                                       partial, route, splits, s);
  return -1;
}

// Float32 elements of `partial` a split `t1d_gemm_tc` call of this shape
// takes (0 when it would not split).
long long t1d_gemm_partial_elems(int M, int N, int K) {
  if (M < 1 || N < 1 || K < 1) return 0;
  return gtc::split_elems(M, N, K);
}

// Products this library has sent to the tensor cores (gemm_tc.cuh) since
// it was loaded or last reset.
long long t1d_bwd_gemm_tc_launches(int reset) {
  const long long n = gtc::g_tc_launches;
  if (reset) gtc::g_tc_launches = 0;
  return n;
}

#ifdef GTC_TRACE
// The stamps of the last traced `gemm_tc` launch (gemm_tc.cuh) -> host[64].
int t1d_gemm_trace(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, gtc::g_trace, sizeof(gtc::g_trace));
}
#endif

const char* t1d_bwd_error_string(int err) {
  if (err == gtc::ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused a TMA tensor map";
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
