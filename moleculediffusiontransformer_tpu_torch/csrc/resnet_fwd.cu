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
// N = C_out: multiply-bound, like the Transformer1d stacks, and small enough
// (at most 8,192 x 3,072 activations) that everything stays in the 50 MB L2
// between launches.  At small batch it is bound by launch latency (5 to 7
// launches a block).
//
// What the design does about it.  The TPU kernel holds a pack of rows and
// every weight in VMEM and builds GroupNorm from segment-indicator matmuls
// and the conv's im2col from shifted rows inside one program; neither fits
// 227 KB of shared memory.  Here one host entry point (`rs_forward`) launches
// a short chain per block on the caller's stream:
//   * concat: [x, skip * scale] for an up block (scale and product rounded to
//     the compute dtype, as the JAX kernel multiplies in it);
//   * GroupNorm + FiLM + SiLU + im2col: one block per (batch, group), float32
//     two-pass statistics in a fixed order (deterministic), then each value
//     normalised, FiLM-ed (block 2), passed through SiLU, rounded to the
//     compute dtype and written to its three im2col slots: taps
//     [prev, cur, next] of width C, zero at each sequence's ends (so L = 1
//     keeps only the centre tap);
//   * the convs, the FiLM Dense (silu(mapping) . W + b, float32 out) and the
//     1x1 projection as the tiled GEMM of `gemm.cuh`, C = A W^T with the conv
//     weight laid out (C_out, 3*C_in) tap-major, float32 accumulation on the
//     CUDA cores, epilogues + bias and + residual.
// Rounding follows the Pallas kernel: each conv's (acc + bias) and the
// projection rounded to the compute dtype; GroupNorm, FiLM and SiLU in
// float32, rounded before each conv; h + x in the compute dtype.  This first
// version uses no tensor cores and keeps the im2col in global memory: wgmma,
// an implicit im2col and fewer launches are later work.
#include "gemm.cuh"

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

// x (B, L, C) -> cols (B*L, 3C): GroupNorm over each (batch, group), then
// h * (ss[b, c] + 1) + ss[b, C + c] when ss (B, 2C) is given, SiLU, rounded
// to T and scattered to the three im2col taps.  One block per (batch, group).
constexpr int GN_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_silu_im2col_kernel(const T* __restrict__ x, T* __restrict__ cols,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ ss, int L, int C, int groups, float eps) {
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
  const size_t C3 = 3 * (size_t)C;
  T* rows = cols + (size_t)b * L * C3;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = i / cpg, c = g * cpg + i % cpg;
    float h = (to_f(x[base + (size_t)l * C + i % cpg]) - mean) * rstd * gamma[c] + beta[c];
    if (ss != nullptr) {
      const float* sb = ss + (size_t)b * 2 * C;
      h = h * (sb[c] + 1.f) + sb[C + c];
    }
    const T t = from_f<T>(silu_f(h));
    rows[(size_t)l * C3 + C + c] = t;                              // row l, centre tap
    if (l + 1 < L) rows[(size_t)(l + 1) * C3 + c] = t;             // row l+1, prev tap
    else rows[(size_t)l * C3 + 2 * C + c] = from_f<T>(0.f);         // last row, next tap
    if (l > 0) rows[(size_t)(l - 1) * C3 + 2 * C + c] = t;         // row l-1, next tap
    else rows[c] = from_f<T>(0.f);                                  // first row, prev tap
  }
}

template <typename T>
int gemm_bias(const T* A, const T* W, const float* bias, const T* res, T* out, long long M,
              int N, int K, cudaStream_t s) {
  GemmArgs<T, T> g = gemm_nt<T, T>(A, W, out, (int)M, N, K);
  g.epi = res != nullptr ? EPI_BIAS_RES : EPI_BIAS;
  g.bias = bias;
  g.res = res;
  return launch_gemm(g, s);
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
  Plan p;
  p.xin = 0;
  p.cols = p.xin + align256(any_skip ? R * cin_max * tsize : 0);
  p.h = p.cols + align256(R * 3 * cmax * tsize);
  p.xproj = p.h + align256(R * cout * tsize);
  p.smap = p.xproj + align256(any_proj ? R * cout * tsize : 0);
  p.ss = p.smap + align256(cm > 0 ? B * cm * tsize : 0);
  p.total = p.ss + align256(cm > 0 ? B * 2 * cout * sizeof(float) : 0);
  return p;
}

// Weights per block, in the JAX `flatten_stack` order: GroupNorm 1 scale,
// bias; conv 1 W (cout, 3*cin), b; [FiLM W (2*cout, cm), b]; GroupNorm 2
// scale, bias; conv 2 W (cout, 3*cout), b; [projection W (cout, cin), b when
// cin != cout].  Matrices in T, vectors float32.
template <typename T>
int run_stack(const T* x, const T* mapping, const void* const* skips, void* const* outs,
              bool collect, const void* const* w, char* ws, int n, const int* cin,
              const int* skip_c, int cout, int B, int L, int cm, int groups, float skip_scale,
              cudaStream_t s) {
  const Plan p = plan_workspace(n, cin, skip_c, cout, B, L, cm, sizeof(T));
  T* xin_buf = (T*)(ws + p.xin);
  T* cols = (T*)(ws + p.cols);
  T* h = (T*)(ws + p.h);
  T* xproj = (T*)(ws + p.xproj);
  T* smap = (T*)(ws + p.smap);
  float* ss = (float*)(ws + p.ss);
  const long long R = (long long)B * L;
  const bool film = cm > 0;
  if (film) {
    silu_kernel<T><<<grid_for((long long)B * cm), 256, 0, s>>>(mapping, smap, (long long)B * cm);
    T1D_CHECK((int)cudaGetLastError());
  }
  const T* cur = x;
  int k = 0;
  for (int i = 0; i < n; ++i) {
    // without collect the stream runs in place in outs[0]: each element's
    // residual is read by the GEMM thread that overwrites it
    T* dst = (T*)(collect ? outs[i] : outs[0]);
    const T* xin = cur;
    if (skip_c[i] > 0) {
      const int cx = cin[i] - skip_c[i];
      concat_skip_kernel<T><<<grid_for(R * cin[i]), 256, 0, s>>>(
          cur, (const T*)skips[i], xin_buf, R, cx, skip_c[i], skip_scale);
      T1D_CHECK((int)cudaGetLastError());
      xin = xin_buf;
    }
    const float* g1s = (const float*)w[k];
    const float* g1b = (const float*)w[k + 1];
    const T* w1 = (const T*)w[k + 2];
    const float* b1 = (const float*)w[k + 3];
    k += 4;
    const T* fw = nullptr;
    const float* fb = nullptr;
    if (film) {
      fw = (const T*)w[k];
      fb = (const float*)w[k + 1];
      k += 2;
    }
    const float* g2s = (const float*)w[k];
    const float* g2b = (const float*)w[k + 1];
    const T* w2 = (const T*)w[k + 2];
    const float* b2 = (const float*)w[k + 3];
    k += 4;

    gn_silu_im2col_kernel<T><<<B * groups, GN_THREADS, 0, s>>>(xin, cols, g1s, g1b, nullptr, L,
                                                               cin[i], groups, 1e-5f);
    T1D_CHECK((int)cudaGetLastError());
    T1D_CHECK(gemm_bias<T>(cols, w1, b1, nullptr, h, R, cout, 3 * cin[i], s));
    if (film) {
      GemmArgs<T, float> g = gemm_nt<T, float>(smap, fw, ss, B, 2 * cout, cm);
      g.epi = EPI_BIAS;
      g.bias = fb;
      T1D_CHECK(launch_gemm(g, s));
    }
    gn_silu_im2col_kernel<T><<<B * groups, GN_THREADS, 0, s>>>(
        h, cols, g2s, g2b, film ? ss : nullptr, L, cout, groups, 1e-5f);
    T1D_CHECK((int)cudaGetLastError());
    const T* res = xin;
    if (cin[i] != cout) {
      T1D_CHECK(gemm_bias<T>(xin, (const T*)w[k], (const float*)w[k + 1], nullptr, xproj, R,
                             cout, cin[i], s));
      k += 2;
      res = xproj;
    }
    T1D_CHECK(gemm_bias<T>(cols, w2, b2, res, dst, R, cout, 3 * cout, s));
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
// else one; all in the compute dtype.  Returns 0, a cudaError_t from the
// first call that failed, or -1 for arguments the kernels do not take.
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

const char* rs_error_string(int err) {
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
