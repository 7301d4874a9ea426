// A run of N ResnetBlock1d's for Hopper (sm_90a), forward: per block
//   [skip concat x scale] -> GroupNorm(8, eps 1e-5) -> SiLU -> k3 conv
//   -> GroupNorm -> [FiLM h * (scale + 1) + shift] -> SiLU -> k3 conv
//   -> + x, or + the 1x1 projection of a widened x;
// every block's output kept when the caller collects them (the UNet's
// down-block skips).
//
// Replaces: moleculediffusiontransformer_tpu/ops/resnet_fusion.py `_kernel`
// (launched by `_fused_forward`, called by `resnet_stack_fused`), the Pallas
// program of a UNet stage's resnet run.  Its backward was never a kernel (the
// JAX `custom_vjp` differentiates the module composition), and is not one
// here either.
//
// What bounds it on this card.  At the QM9 presets (batch 1,024 under CFG;
// L 8 at C 256 and L 2 at C 512 for the 91M inverse model, L 4 at C 128 and
// L 1 at C 256 for the 18M forward model) the work is the two k3 convs of
// each block as matrix products with M = batch*L rows, K = 3*C_in and
// N = C_out, ~160 GFLOP over the eight runs of the two presets: bound by
// the operations at the bf16 tensor-core rate (~0.17 ms), with every
// activation (at most 8,192 x 3,072) resident in the 50 MB L2 between
// launches.  On the CUDA cores those products ran at 12-14 TFLOP/s and were
// nearly all of the kernel's time.  At small batch it is bound by launches.
//
// What the design does about it.  The TPU kernel holds a pack of rows and
// every weight in VMEM and builds GroupNorm from segment-indicator matmuls
// and the conv's im2col from shifted rows inside one program; neither fits
// 227 KB of shared memory.  Here one host entry point (`rs_forward`) launches
// a short chain on the caller's stream: SiLU of the mapping and ONE FiLM
// product for the whole run, then per block 4 launches (6 for an up block):
//   * concat: [x, skip * scale] for an up block (scale and product rounded to
//     the compute dtype, as the JAX kernel multiplies in it);
//   * GroupNorm + FiLM + SiLU + im2col: one warp per (batch, group), eight a
//     block.  A group of up to 32 x GN_VECS 16-byte vectors (1,024 bf16, 512
//     float32 values; every group of the presets) is read once into
//     registers; larger groups (the long Model1d's, L in the thousands) loop
//     over global memory instead.  Float32 two-pass statistics (mean, then
//     the squared deviations) summed in a fixed order of lanes and shuffles:
//     deterministic.  Each value is normalised, FiLM-ed (block 2), passed
//     through SiLU, rounded to the compute dtype and written as 16-byte
//     vectors to its three im2col taps [prev, cur, next] of width C, zero at
//     each sequence's ends.  At L = 1 the prev and next taps are all zeros:
//     only the centre tap is written, as (B, C);
//   * every product through gemm_tc.cuh's `launch_gemm_tc` (bf16 on the
//     tensor cores: `wgmma`, TMA-fed ring, staged epilogue; float32 on the
//     CUDA cores of gemm.cuh, which keeps the 1e-4 float32 band that TF32
//     would break), C = A W^T with the conv weight laid out (C_out, 3*C_in)
//     tap-major: conv 1 with + bias; conv 2 with + bias + residual; the 1x1
//     projection with + bias; at L = 1 each conv multiplies the (B, C)
//     centre tap by W's middle column block, read in place through its row
//     stride 3 C, so that K is C and not 3 C of which two thirds are zeros;
//   * the FiLM Dense silu(mapping) . [W_0; ..; W_{n-1}]^T + b, float32 out,
//     once for the run: the blocks' (2 C_out, C_m) FiLM weights (and biases)
//     must lie one after the other in memory, as one (n 2 C_out, C_m)
//     matrix (`kernel_weights` builds them so); block i reads its scale and
//     shift at column i 2 C_out.  Each element's sum is that of one product
//     a block.
// Without collect the stream runs in place in outs[0]: conv 2 of block i > 0
// reads its residual from the tensor it writes.  That is safe because
// gemm_tc's epilogue (and gemm.cuh's) reads each element's residual in the
// thread that then writes that element, and no other thread touches it.
// Rounding follows the Pallas kernel: each conv's (acc + bias) and the
// projection rounded to the compute dtype; GroupNorm, FiLM and SiLU in
// float32, rounded before each conv; h + x in the compute dtype.  The
// im2col stays in global memory (in L2): an implicit im2col through a 3-D
// TMA map is later work.
#include "gemm_tc.cuh"

namespace {

__device__ __forceinline__ float silu_f(float v) { return v * (1.f / (1.f + expf(-v))); }

constexpr long long GRID_CAP = 4096;

inline int grid_for(long long n) {
  const long long blocks = (n + 255) / 256;
  return (int)(blocks < GRID_CAP ? blocks : GRID_CAP);
}

// out = silu(in) rounded to T
template <typename T>
__global__ void silu_kernel(const T* __restrict__ in, T* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = from_f<T>(silu_f(to_f(in[i])));
}

// xin (R, cx + cs) = [x (R, cx), skip (R, cs) * scale]
template <typename T>
__global__ void concat_skip_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                                   T* __restrict__ xin, long long R, int cx, int cs,
                                   float scale) {
  const float sc = round_to<T>(scale);
  const int cin = cx + cs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < R * cin;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / cin;
    const int c = (int)(i % cin);
    xin[i] = c < cx ? x[r * cx + c] : from_f<T>(to_f(skip[r * cs + c - cx]) * sc);
  }
}

// ------------------------------------------- GroupNorm + FiLM + SiLU + im2col
constexpr int GN_WARPS = 8;   // groups a block, one warp each
constexpr int GN_VECS = 4;    // vectors a lane holds in registers

// W consecutive elements as one 16-byte access when W * sizeof(T) is 16,
// else one at a time
template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[W]) {
  if constexpr (W * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_vec(T* p, const T (&o)[W]) {
  if constexpr (W * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < W; ++i) e[i] = o[i];
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = o[i];
  }
}

// x (B, L, C) -> cols: GroupNorm over each (batch, group), then
// h * (ss[b, c] + 1) + ss[b, C + c] when ss is given (row stride ss_ld),
// SiLU, rounded to T.  With taps 3, scattered to the im2col rows (B*L, 3C);
// with taps 1 (L = 1), written as (B, C).  The group's values are taken W at
// a time: vector j lies at row j / vpr, columns g cpg + (j % vpr) W.., and
// lane `lane` takes vectors lane, lane + 32, ..
template <typename T, int W>
__global__ void __launch_bounds__(GN_WARPS * 32)
gn_silu_cols_kernel(const T* __restrict__ x, T* __restrict__ cols,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ ss, int ss_ld, int B, int L, int C, int groups,
                    int taps, float eps) {
  const int w = blockIdx.x * GN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= B * groups) return;   // the whole warp: the shuffles below see 32 lanes
  const int b = w / groups, g = w % groups;
  const int cpg = C / groups, vpr = cpg / W, nvec = L * vpr, n = L * cpg;
  const T* xg = x + (size_t)b * L * C + (size_t)g * cpg;
  const float* sb = ss != nullptr ? ss + (size_t)b * ss_ld : nullptr;
  const size_t ldc = (size_t)taps * C;
  T* rows = cols + (size_t)b * L * ldc;
  auto at = [&](int j) { return (size_t)(j / vpr) * C + (size_t)(j % vpr) * W; };
  auto emit = [&](int j, const float(&v)[W], float mean, float rstd) {
    const int l = j / vpr, c = g * cpg + (j % vpr) * W;
    T o[W], zero[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      float h = (v[e] - mean) * rstd * gamma[c + e] + beta[c + e];
      if (sb != nullptr) h = h * (sb[c + e] + 1.f) + sb[C + c + e];
      o[e] = from_f<T>(silu_f(h));
      zero[e] = from_f<T>(0.f);
    }
    if (taps == 1) {
      store_vec(rows + (size_t)l * C + c, o);
      return;
    }
    store_vec(rows + (size_t)l * ldc + C + c, o);                         // row l, centre
    if (l + 1 < L) store_vec(rows + (size_t)(l + 1) * ldc + c, o);        // row l+1, prev
    else store_vec(rows + (size_t)l * ldc + 2 * C + c, zero);             // last row, next
    if (l > 0) store_vec(rows + (size_t)(l - 1) * ldc + 2 * C + c, o);    // row l-1, next
    else store_vec(rows + c, zero);                                       // first row, prev
  };

  if (nvec <= 32 * GN_VECS) {   // the group in registers, read once
    float v[GN_VECS][W];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < GN_VECS; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        load_vec<T, W>(xg + at(j), v[k]);
#pragma unroll
        for (int e = 0; e < W; ++e) s += v[k][e];
      }
    }
    const float mean = warp_sum(s) / n;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < GN_VECS; ++k)
      if (lane + 32 * k < nvec) {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float d = v[k][e] - mean;
          q += d * d;
        }
      }
    const float rstd = rsqrtf(warp_sum(q) / n + eps);
#pragma unroll
    for (int k = 0; k < GN_VECS; ++k)
      if (lane + 32 * k < nvec) emit(lane + 32 * k, v[k], mean, rstd);
    return;
  }
  // a group too large for the registers: three passes over global memory
  float s = 0.f;
  for (int j = lane; j < nvec; j += 32) {
    float v[W];
    load_vec<T, W>(xg + at(j), v);
#pragma unroll
    for (int e = 0; e < W; ++e) s += v[e];
  }
  const float mean = warp_sum(s) / n;
  float q = 0.f;
  for (int j = lane; j < nvec; j += 32) {
    float v[W];
    load_vec<T, W>(xg + at(j), v);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float d = v[e] - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / n + eps);
  for (int j = lane; j < nvec; j += 32) {
    float v[W];
    load_vec<T, W>(xg + at(j), v);
    emit(j, v, mean, rstd);
  }
}

// 16-byte vectors where a group's row segment is whole vectors and the
// buffers lie on 16-byte boundaries, else one element at a time
template <typename T>
int gn_silu_cols(const T* x, T* cols, const float* gamma, const float* beta, const float* ss,
                 int ss_ld, int B, int L, int C, int groups, int taps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int blocks = gtc::cdiv((long long)B * groups, GN_WARPS);
  if ((C / groups) % VEC == 0 && gtc::aligned16(x) && gtc::aligned16(cols))
    gn_silu_cols_kernel<T, VEC><<<blocks, GN_WARPS * 32, 0, s>>>(
        x, cols, gamma, beta, ss, ss_ld, B, L, C, groups, taps, 1e-5f);
  else
    gn_silu_cols_kernel<T, 1><<<blocks, GN_WARPS * 32, 0, s>>>(
        x, cols, gamma, beta, ss, ss_ld, B, L, C, groups, taps, 1e-5f);
  return (int)cudaGetLastError();
}

// out (M, N) = a (M, K) . W^T + bias [+ res], W's rows `ldw` apart (a
// column block of a wider weight, read in place)
template <typename T>
int linear(const T* a, const T* w, int ldw, const float* bias, const T* res, T* out, long long M,
           int N, int K, cudaStream_t s) {
  GemmArgs<T, T> g = gemm_nt<T, T>(a, w, out, (int)M, N, K);
  g.sbn = ldw;
  g.epi = res != nullptr ? EPI_BIAS_RES : EPI_BIAS;
  g.bias = bias;
  g.res = res;
  return launch_gemm_tc(g, s);
}

// A k3 conv of the (R, taps C) columns: taps 3, the whole (N, 3C) weight;
// taps 1, its centre column block
template <typename T>
int conv(const T* cols, const T* w, const float* bias, const T* res, T* out, long long R, int N,
         int C, int taps, cudaStream_t s) {
  return linear(cols, taps == 1 ? w + C : w, 3 * C, bias, res, out, R, N, taps * C, s);
}

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

struct Plan {
  size_t xin, cols, h, xproj, smap, ss, total;
};

// Byte offsets of the scratch buffers in the caller's workspace.
Plan plan_workspace(int n, const int* cin, const int* skip_c, int cout, long long B, int L,
                    int cm, size_t tsize) {
  const long long R = B * L;
  int cin_max = 0;
  bool any_skip = false, any_proj = false;
  for (int i = 0; i < n; ++i) {
    cin_max = cin[i] > cin_max ? cin[i] : cin_max;
    any_skip = any_skip || skip_c[i] > 0;
    any_proj = any_proj || cin[i] != cout;
  }
  const int cmax = cin_max > cout ? cin_max : cout;
  const int taps = L == 1 ? 1 : 3;
  Plan p;
  p.xin = 0;
  p.cols = p.xin + align256(any_skip ? R * cin_max * tsize : 0);
  p.h = p.cols + align256(R * taps * cmax * tsize);
  p.xproj = p.h + align256(R * cout * tsize);
  p.smap = p.xproj + align256(any_proj ? R * cout * tsize : 0);
  p.ss = p.smap + align256(cm > 0 ? B * cm * tsize : 0);
  p.total = p.ss + align256(cm > 0 ? B * n * 2 * cout * sizeof(float) : 0);
  return p;
}

// One block's entries of the weight list, in the JAX `flatten_stack`
// order: GroupNorm 1 scale, bias; conv 1 W (cout, 3*cin), b; [FiLM W
// (2*cout, cm), b]; GroupNorm 2 scale, bias; conv 2 W (cout, 3*cout), b;
// [projection W (cout, cin), b when cin != cout].  Matrices in T, vectors
// float32.
template <typename T>
struct BlockWeights {
  const float *g1s, *g1b, *b1, *fb, *g2s, *g2b, *b2, *pb;
  const T *w1, *fw, *w2, *pw;
};

template <typename T>
BlockWeights<T> take_block(const void* const* w, int& k, bool film, bool proj) {
  BlockWeights<T> b = {};
  b.g1s = (const float*)w[k];
  b.g1b = (const float*)w[k + 1];
  b.w1 = (const T*)w[k + 2];
  b.b1 = (const float*)w[k + 3];
  k += 4;
  if (film) {
    b.fw = (const T*)w[k];
    b.fb = (const float*)w[k + 1];
    k += 2;
  }
  b.g2s = (const float*)w[k];
  b.g2b = (const float*)w[k + 1];
  b.w2 = (const T*)w[k + 2];
  b.b2 = (const float*)w[k + 3];
  k += 4;
  if (proj) {
    b.pw = (const T*)w[k];
    b.pb = (const float*)w[k + 1];
    k += 2;
  }
  return b;
}

// True when the blocks' FiLM weights and biases lie one after the other,
// as one (n 2 cout, cm) matrix and one (n 2 cout,) vector.
template <typename T>
bool film_contiguous(const void* const* w, int n, const int* cin, int cout, int cm) {
  int k = 0;
  const BlockWeights<T> first = take_block<T>(w, k, true, cin[0] != cout);
  for (int i = 1; i < n; ++i) {
    const BlockWeights<T> b = take_block<T>(w, k, true, cin[i] != cout);
    if (b.fw != first.fw + (size_t)i * 2 * cout * cm || b.fb != first.fb + (size_t)i * 2 * cout)
      return false;
  }
  return true;
}

template <typename T>
int run_stack(const T* x, const T* mapping, const void* const* skips, void* const* outs,
              bool collect, const void* const* w, char* ws, int n, const int* cin,
              const int* skip_c, int cout, int B, int L, int cm, int groups, float skip_scale,
              cudaStream_t s) {
  const bool film = cm > 0;
  if (film && !film_contiguous<T>(w, n, cin, cout, cm)) return -1;
  const Plan p = plan_workspace(n, cin, skip_c, cout, B, L, cm, sizeof(T));
  T* xin_buf = (T*)(ws + p.xin);
  T* cols = (T*)(ws + p.cols);
  T* h = (T*)(ws + p.h);
  T* xproj = (T*)(ws + p.xproj);
  T* smap = (T*)(ws + p.smap);
  float* ss = (float*)(ws + p.ss);
  const long long R = (long long)B * L;
  const int taps = L == 1 ? 1 : 3;
  const int ss_ld = n * 2 * cout;
  if (film) {   // every block's scale and shift: one product for the run
    silu_kernel<T><<<grid_for((long long)B * cm), 256, 0, s>>>(mapping, smap, (long long)B * cm);
    T1D_CHECK((int)cudaGetLastError());
    int k = 0;
    const BlockWeights<T> first = take_block<T>(w, k, true, cin[0] != cout);
    GemmArgs<T, float> g = gemm_nt<T, float>(smap, first.fw, ss, B, ss_ld, cm);
    g.epi = EPI_BIAS;
    g.bias = first.fb;
    T1D_CHECK(launch_gemm_tc(g, s));
  }
  const T* cur = x;
  int k = 0;
  for (int i = 0; i < n; ++i) {
    const BlockWeights<T> bw = take_block<T>(w, k, film, cin[i] != cout);
    // without collect the stream runs in place in outs[0] (see the note above)
    T* dst = (T*)(collect ? outs[i] : outs[0]);
    const T* xin = cur;
    if (skip_c[i] > 0) {
      const int cx = cin[i] - skip_c[i];
      concat_skip_kernel<T><<<grid_for(R * cin[i]), 256, 0, s>>>(
          cur, (const T*)skips[i], xin_buf, R, cx, skip_c[i], skip_scale);
      T1D_CHECK((int)cudaGetLastError());
      xin = xin_buf;
    }
    T1D_CHECK(gn_silu_cols<T>(xin, cols, bw.g1s, bw.g1b, nullptr, 0, B, L, cin[i], groups, taps,
                              s));
    T1D_CHECK(conv<T>(cols, bw.w1, bw.b1, nullptr, h, R, cout, cin[i], taps, s));
    T1D_CHECK(gn_silu_cols<T>(h, cols, bw.g2s, bw.g2b, film ? ss + (size_t)i * 2 * cout : nullptr,
                              ss_ld, B, L, cout, groups, taps, s));
    const T* res = xin;
    if (bw.pw != nullptr) {
      T1D_CHECK(linear<T>(xin, bw.pw, cin[i], bw.pb, nullptr, xproj, R, cout, cin[i], s));
      res = xproj;
    }
    T1D_CHECK(conv<T>(cols, bw.w2, bw.b2, res, dst, R, cout, cout, taps, s));
    cur = dst;
  }
  return 0;
}

bool valid_chain(int n, const int* cin, const int* skip_c, int cout, int groups) {
  if (n < 1 || cout < 1 || groups < 1 || cout % groups != 0) return false;
  for (int i = 0; i < n; ++i) {
    if (skip_c[i] < 0 || cin[i] <= skip_c[i] || cin[i] % groups != 0) return false;
    if (i > 0 && cin[i] - skip_c[i] != cout) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Number of weight pointers `rs_forward` expects for a run of n blocks
// whose block i takes cin[i] channels (after its skip concat).
int rs_num_weights(int n, const int* cin, int cout, int use_mapping) {
  int count = 0;
  for (int i = 0; i < n; ++i) count += 8 + (use_mapping ? 2 : 0) + (cin[i] != cout ? 2 : 0);
  return count;
}

// Bytes the caller allocates as `workspace`; dtype 0 = float32, 1 = bfloat16.
long long rs_workspace_bytes(int n, const int* cin, const int* skip_c, int cout, int B, int L,
                             int cm, int dtype) {
  const size_t tsize = dtype == DTYPE_BF16 ? 2 : 4;
  return (long long)plan_workspace(n, cin, skip_c, cout, B, L, cm, tsize).total;
}

// Runs the n blocks on `stream` of `device`.  x (B, L, cin[0] - skip_c[0]);
// mapping (B, cm), or null with cm = 0 (no FiLM); skips[i] (B, L, skip_c[i])
// or null where skip_c[i] = 0; outs: n outputs (B, L, cout) with `collect`,
// else one; all in the compute dtype.  The blocks' FiLM weights and biases
// lie one after the other (see the note at the top).  Returns 0, a
// cudaError_t from the first call that failed, -2 where a TMA tensor map was
// refused, or -1 for arguments the kernels do not take.
int rs_forward(const void* x, const void* mapping, const void* const* skips, void* const* outs,
               int collect, const void* const* weights, int n_weights, void* workspace,
               long long workspace_bytes, int n, const int* cin, const int* skip_c, int cout,
               int B, int L, int cm, int groups, float skip_scale, int dtype, int device,
               void* stream) {
  if (!valid_chain(n, cin, skip_c, cout, groups) || B < 1 || L < 1 || cm < 0 ||
      (cm > 0) != (mapping != nullptr) ||
      (long long)B * L > 65535LL * BM ||   // the GEMM grid's row blocks
      n_weights != rs_num_weights(n, cin, cout, cm > 0) ||
      workspace_bytes < rs_workspace_bytes(n, cin, skip_c, cout, B, L, cm, dtype))
    return -1;
  for (int i = 0; i < n; ++i)
    if ((skip_c[i] > 0) != (skips[i] != nullptr)) return -1;
  T1D_CHECK((int)cudaSetDevice(device));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return run_stack<float>((const float*)x, (const float*)mapping, skips, outs, collect != 0,
                            weights, (char*)workspace, n, cin, skip_c, cout, B, L, cm, groups,
                            skip_scale, s);
  if (dtype == DTYPE_BF16)
    return run_stack<__nv_bfloat16>((const __nv_bfloat16*)x, (const __nv_bfloat16*)mapping,
                                    skips, outs, collect != 0, weights, (char*)workspace, n,
                                    cin, skip_c, cout, B, L, cm, groups, skip_scale, s);
  return -1;
}

// Products this library has sent to the tensor cores (gemm_tc.cuh) since
// it was loaded or last reset.
long long rs_gemm_tc_launches(int reset) {
  const long long n = gtc::g_tc_launches;
  if (reset) gtc::g_tc_launches = 0;
  return n;
}

const char* rs_error_string(int err) {
  if (err == gtc::ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused a TMA tensor map";
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
