// Streaming softmax attention for long sequences, the backward, for Hopper
// (sm_90a).  Replaces the two Pallas TPU kernels of
// moleculediffusiontransformer_tpu/ops/flash_attention.py:
//
//   fa_backward_dq   _dq_kernel   (:185)  dq = sum_kv ds k
//   fa_backward_dkv  _dkv_kernel  (:220)  dv = sum_q p^T do, dk = sum_q ds^T q
//                    with s = q k^T * scale, p = exp(s - lse),
//                    ds = (do v^T - di) * p * scale
//
// q, do, dq are (bh, n, d); k, v, dk, dv (bh, m, d); lse and di (bh, n)
// float32; all contiguous; d is 16, 32, 64 or 128.  di = rowsum(o * do) is
// not computed here: the caller hands it in, as `_bwd_pallas` computes it
// outside its kernels.
//
// One owner a tile: the dq kernel takes one block per (bh, tile of query
// rows) and sweeps the KV tiles, the dk/dv kernel one block per (bh, tile of
// KV rows) and sweeps the query tiles -- what the TPU grid carried from step
// to step in VMEM scratch (dq's sum; dk_acc, dv_acc) is a loop inside one
// block.  Each output tile is written once, by the block that owns it: no
// atomics, and two calls give the same bits.
//
// Bound: operations (6 and 8 bh n m d flops against O(bh (n + m) d) bytes,
// ~2,000 flops a byte in bf16).  Two designs, chosen by the input type in the
// entry points at the end of this file:
//
// * bfloat16 -> the tensor cores (`tc` below).  The operands stay bf16 from
//   device memory to the matrix instruction and every product accumulates in
//   float32; bf16 x bf16 products are exact in float32, so q k^T and do v^T
//   differ from a float32 product only by summation order.  p and ds are
//   rounded to bf16 once, as operands of the second products, and each
//   output once, when it is written.  That is what the TPU does at these
//   points: for bf16 inputs the Pallas kernels run their dots at default
//   precision, one bf16 pass of the matrix unit.  A block owns a 128-row
//   tile.  The swept tiles arrive by `cp.async` into a ring of swizzled
//   shared memory while the products of the previous tile run; each of K and
//   V (Q and dO) is staged once and read both ways, along its rows and along
//   its columns, for its two roles.  p and ds never reach shared memory: the
//   accumulator fragment of a score tile is, pair of n8 tiles by pair, the
//   A-operand fragment of the next product.  In the dk/dv kernel the block's
//   KV rows are the M dimension (s^T = k q^T, dp^T = v do^T), so that p^T
//   and ds^T come out in A-operand layout too; lse and di are then per
//   column and are read from shared memory.  exp is `ex2.approx` with
//   log2(e) folded into the scale and lse.  The instruction depends on the
//   head size, by the rule in `tc::backward_dq` and `tc::backward_dkv`:
//   d 64, the size of every model in the repository, runs on
//   `wgmma.mma_async.m64n64k16` (`tc::wg`: two warpgroups a block, a
//   three-stage ring, matrix descriptors over the 128-byte swizzle); d 16,
//   32 and 128 run on `mma.sync.m16n8k16` with `ldmatrix` (8 warps of 16
//   rows, a two-stage ring; swept tiles of 64 rows, 32 at d 128, where the
//   accumulators of 128 columns leave no room for more).
// * float32 -> the CUDA cores, from float32 tiles in shared memory
//   (flash_attention_tiles.cuh).  TF32 tensor-core products would leave the
//   1e-4 band in which the float32 path is held against the CPU.
#include "flash_attention_tiles.cuh"

#include <stdint.h>

namespace {

// ================================================================ float32

// --------------------------------------------------------------------- dq

template <int D>
constexpr int dq_smem_floats() { return 2 * TILE * D + 2 * D * LDT + TILE * D + TILE * TILE; }

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ di, float* __restrict__ dq, int n, int m, float scale) {
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

  load_rows<float, D>(Qs, q + (bh * n + row0) * D);
  load_rows<float, D>(dOs, dout + (bh * n + row0) * D);
  float row_lse[4], row_di[4], acc[4][CO];
  load_vec<4>(lse + bh * n + row0 + ty * 4, row_lse);
  load_vec<4>(di + bh * n + row0 + ty * 4, row_di);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;

  for (int col0 = 0; col0 < m; col0 += TILE) {
    __syncthreads();
    load_rows_transposed<float, D>(Kt, k + (bh * m + col0) * D);
    load_rows_transposed<float, D>(Vt, v + (bh * m + col0) * D);
    load_rows<float, D>(Ks, k + (bh * m + col0) * D);
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
  store_tile<float, CO>(dq + (bh * n + row0) * D, D, acc, ty, tx);
}

// ------------------------------------------------------------------ dk, dv

template <int D>
constexpr int dkv_smem_floats() { return 2 * D * LDT + 2 * TILE * D + 2 * TILE * TILE; }

template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv, int n,
           int m, float scale) {
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

  load_rows_transposed<float, D>(Kt, k + (bh * m + col0) * D);
  load_rows_transposed<float, D>(Vt, v + (bh * m + col0) * D);
  float dk_acc[4][CO], dv_acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int row0 = 0; row0 < n; row0 += TILE) {
    __syncthreads();
    load_rows<float, D>(Qs, q + (bh * n + row0) * D);
    load_rows<float, D>(dOs, dout + (bh * n + row0) * D);
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
  store_tile<float, CO>(dk + (bh * m + col0) * D, D, dk_acc, ty, tx);
  store_tile<float, CO>(dv + (bh * m + col0) * D, D, dv_acc, ty, tx);
}

template <int D>
int backward_dq(const float* q, const float* k, const float* v, const float* dout,
                const float* lse, const float* di, float* dq, long long bh, int n, int m,
                float scale, cudaStream_t s) {
  constexpr int bytes = dq_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(dq_kernel<D>, bytes)) return err;
  dq_kernel<D><<<(unsigned)(bh * (n / TILE)), THREADS, bytes, s>>>(q, k, v, dout, lse, di, dq, n,
                                                                    m, scale);
  return (int)cudaGetLastError();
}

template <int D>
int backward_dkv(const float* q, const float* k, const float* v, const float* dout,
                 const float* lse, const float* di, float* dk, float* dv, long long bh, int n,
                 int m, float scale, cudaStream_t s) {
  constexpr int bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(dkv_kernel<D>, bytes)) return err;
  dkv_kernel<D><<<(unsigned)(bh * (m / TILE)), THREADS, bytes, s>>>(q, k, v, dout, lse, di, dk,
                                                                     dv, n, m, scale);
  return (int)cudaGetLastError();
}

// =============================================================== bfloat16
//
// First the pieces both bf16 designs share and the `mma.sync` kernels (every
// head size but 64), then `wg`, the `wgmma` kernels of d 64.

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int NTHREADS = WARPS * 32;
constexpr int OWN = WARPS * 16;     // rows of the tile a block owns, 16 a warp
constexpr float LOG2E = 1.4426950408889634f;

// Rows of a swept tile: the two score tiles of a warp are 16 x SWEEP float32
// in registers beside its accumulators.
template <int D>
constexpr int SWEEP = D <= 64 ? 64 : 32;

// The owned tile's A fragments stay in registers for the whole sweep where
// they fit (d/16 x 4 registers an operand); at d 128 they are read from
// shared memory at every use.
template <int D>
constexpr bool A_IN_REGS = D <= 64;

// Element offset of the 16-byte chunk `chunk` of row `row` in a (rows, D)
// bf16 tile.  The chunk index is XORed with row bits so that the eight row
// addresses of an 8 x 8 `ldmatrix` (eight consecutive rows, one logical
// chunk) fall on eight different 16-byte bank groups, whatever D: rows of
// 128 bytes and more differ in row & 7; rows of 64 bytes share a 128-byte
// line in pairs, rows of 32 bytes in fours.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (D >= 64) return row * D + ((chunk ^ (row & 7)) << 3);
  else if constexpr (D == 32) return row * D + ((chunk ^ ((row >> 1) & 3)) << 3);
  else return row * D + ((chunk ^ ((row >> 2) & 1)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS contiguous rows of D bf16 at `src` -> the swizzled tile `dst`, 16
// bytes a thread, asynchronously.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    cp_async16(dst + swz<D>(r, c), src + (long long)r * D + c * 8);
  }
}

// COUNT contiguous floats (a multiple of 4) -> dst, by threads first..
template <int COUNT>
__device__ __forceinline__ void load_floats_async(float* dst, const float* src, int first) {
  const int idx = (int)threadIdx.x - first;
  if (idx >= 0 && idx < COUNT / 4) cp_async16(dst + idx * 4, src + idx * 4);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16) b (16 x 8, bf16).  Thread
// (g = lane / 4, t = lane % 4) holds c[g][2t, 2t+1], c[g+8][2t, 2t+1];
// a[g | g+8][2t.. | 2t+8..]; b[2t.. | 2t+8..][g].
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two float32 -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragment of rows row0..row0+15, columns 16 kk..16 kk+15 of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int kk,
                                       int lane) {
  ldsm4(a, tile + swz<D>(row0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// A warp's 16 rows of an owned (OWN, D) tile as A fragments, one a k16 step.
template <int D>
struct OwnedRows {
  static constexpr bool IN_REGS = A_IN_REGS<D>;
  uint32_t frag[IN_REGS ? D / 16 : 1][4];
  const bf16* tile;
  int row0;

  __device__ __forceinline__ void init(const bf16* t, int r0, int lane) {
    tile = t;
    row0 = r0;
    if constexpr (IN_REGS) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<D>(frag[kk], t, r0, kk, lane);
    }
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk, int lane) const {
    if constexpr (IN_REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = frag[kk][i];
    } else {
      load_a<D>(a, tile, row0, kk, lane);
    }
  }
};

// acc (16 x 8 NT) = A (16 x D) B^T, B a swizzled (8 NT, D) tile: one
// `ldmatrix.x4` brings the B fragments of two n8 tiles for one k16 step.
template <int D, int NT>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4], const OwnedRows<D>& a,
                                            const bf16* B, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int brow = (lane & 7) + ((lane >> 4) << 3), bchunk = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    a.get(af, kk, lane);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm4(b, B + swz<D>(jp * 16 + brow, 2 * kk + bchunk));
      mma16816(acc[2 * jp], af, b[0], b[1]);
      mma16816(acc[2 * jp + 1], af, b[2], b[3]);
    }
  }
}

// acc (16 x D) += P (16 x 8 NT, as NT/2 A fragments) B, B a swizzled
// (8 NT, D) tile read through `ldmatrix.trans`: two n8 tiles of one k16 step
// an instruction.
template <int D, int NT>
__device__ __forceinline__ void product_ab(float (&acc)[D / 8][4], const uint32_t (&p)[NT / 2][4],
                                           const bf16* B, int lane) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm4_trans(b, B + swz<D>(ks * 16 + (lane & 15), 2 * dp + (lane >> 4)));
      mma16816(acc[2 * dp], p[ks], b[0], b[1]);
      mma16816(acc[2 * dp + 1], p[ks], b[2], b[3]);
    }
  }
}

// A score tile's accumulators (16 x 8 NT float32) -> the A fragments of the
// same tile in bf16: n8 tiles 2 ks and 2 ks + 1 are k16 step ks.
template <int NT>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    a[ks][0] = pack2(c[2 * ks][0], c[2 * ks][1]);
    a[ks][1] = pack2(c[2 * ks][2], c[2 * ks][3]);
    a[ks][2] = pack2(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    a[ks][3] = pack2(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

// A warp's 16 x D accumulators -> rows row_lo = g and g + 8 of `dst` (row
// stride D), rounded to bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(dst + (long long)g * D + 8 * j + 2 * t) =
        pack2(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(dst + (long long)(g + 8) * D + 8 * j + 2 * t) =
        pack2(acc[j][2], acc[j][3]);
  }
}

// --------------------------------------------------------------------- dq

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * OWN * D + 4 * SWEEP<D> * D) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ di, bf16* __restrict__ dq, int n, int m, float scale) {
  constexpr int BN = SWEEP<D>, NT = BN / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // (OWN, D)
  bf16* dOs = Qs + OWN * D;                       // (OWN, D)
  bf16* Ks = dOs + OWN * D;                       // 2 stages of (BN, D)
  bf16* Vs = Ks + 2 * BN * D;                     // 2 stages of (BN, D)

  const int q_tiles = n / OWN;
  const long long bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * OWN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const bf16* kbase = k + bh * m * D;
  const bf16* vbase = v + bh * m * D;

  load_tile_async<D, OWN>(Qs, q + (bh * n + row0) * D);
  load_tile_async<D, OWN>(dOs, dout + (bh * n + row0) * D);
  cp_async_commit();
  load_tile_async<D, BN>(Ks, kbase);
  load_tile_async<D, BN>(Vs, vbase);
  cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const long long r_lo = bh * n + row0 + warp * 16 + g;
  const float lse_lo = lse[r_lo] * LOG2E, lse_hi = lse[r_lo + 8] * LOG2E;
  const float di_lo = di[r_lo], di_hi = di[r_lo + 8];
  const float scale2 = scale * LOG2E;

  cp_async_wait<1>();
  __syncthreads();
  OwnedRows<D> qa, doa;
  qa.init(Qs, warp * 16, lane);
  doa.init(dOs, warp * 16, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int tiles = m / BN;
  for (int j = 0; j < tiles; ++j) {
    // tile j has landed and every warp is done with tile j - 1, whose
    // stage the next copies overwrite
    cp_async_wait<0>();
    __syncthreads();
    const int stage = j & 1;
    if (j + 1 < tiles) {
      load_tile_async<D, BN>(Ks + (stage ^ 1) * BN * D, kbase + (long long)(j + 1) * BN * D);
      load_tile_async<D, BN>(Vs + (stage ^ 1) * BN * D, vbase + (long long)(j + 1) * BN * D);
      cp_async_commit();
    }
    const bf16* Kt = Ks + stage * BN * D;
    const bf16* Vt = Vs + stage * BN * D;

    float s[NT][4], dp[NT][4];
    product_abt<D, NT>(s, qa, Kt, lane);
    product_abt<D, NT>(dp, doa, Vt, lane);
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      s[jt][0] = (dp[jt][0] - di_lo) * ex2(fmaf(s[jt][0], scale2, -lse_lo)) * scale;
      s[jt][1] = (dp[jt][1] - di_lo) * ex2(fmaf(s[jt][1], scale2, -lse_lo)) * scale;
      s[jt][2] = (dp[jt][2] - di_hi) * ex2(fmaf(s[jt][2], scale2, -lse_hi)) * scale;
      s[jt][3] = (dp[jt][3] - di_hi) * ex2(fmaf(s[jt][3], scale2, -lse_hi)) * scale;
    }
    uint32_t dsa[NT / 2][4];
    to_a_frags<NT>(dsa, s);
    product_ab<D, NT>(acc, dsa, Kt, lane);
  }
  store_rows<D>(dq + (bh * n + row0 + warp * 16) * D, acc, lane);
}

// ------------------------------------------------------------------ dk, dv

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * OWN * D + 4 * SWEEP<D> * D) * (int)sizeof(bf16) +
         4 * SWEEP<D> * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
           int m, float scale) {
  constexpr int BM = SWEEP<D>, NT = BM / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // (OWN, D)
  bf16* Vs = Ks + OWN * D;                        // (OWN, D)
  bf16* Qs = Vs + OWN * D;                        // 2 stages of (BM, D)
  bf16* dOs = Qs + 2 * BM * D;                    // 2 stages of (BM, D)
  float* lses = reinterpret_cast<float*>(dOs + 2 * BM * D);   // 2 stages of BM
  float* dis = lses + 2 * BM;                                  // 2 stages of BM

  const int kv_tiles = m / OWN;
  const long long bh = blockIdx.x / kv_tiles;
  const int col0 = (blockIdx.x % kv_tiles) * OWN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bf16* qbase = q + bh * n * D;
  const bf16* dobase = dout + bh * n * D;
  const float* lsebase = lse + bh * n;
  const float* dibase = di + bh * n;

  load_tile_async<D, OWN>(Ks, k + (bh * m + col0) * D);
  load_tile_async<D, OWN>(Vs, v + (bh * m + col0) * D);
  cp_async_commit();
  load_tile_async<D, BM>(Qs, qbase);
  load_tile_async<D, BM>(dOs, dobase);
  load_floats_async<BM>(lses, lsebase, 0);
  load_floats_async<BM>(dis, dibase, BM / 4);
  cp_async_commit();

  const float scale2 = scale * LOG2E;
  cp_async_wait<1>();
  __syncthreads();
  OwnedRows<D> ka, va;
  ka.init(Ks, warp * 16, lane);
  va.init(Vs, warp * 16, lane);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int tiles = n / BM;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    const int stage = j & 1;
    if (j + 1 < tiles) {
      const long long next = (long long)(j + 1) * BM;
      load_tile_async<D, BM>(Qs + (stage ^ 1) * BM * D, qbase + next * D);
      load_tile_async<D, BM>(dOs + (stage ^ 1) * BM * D, dobase + next * D);
      load_floats_async<BM>(lses + (stage ^ 1) * BM, lsebase + next, 0);
      load_floats_async<BM>(dis + (stage ^ 1) * BM, dibase + next, BM / 4);
      cp_async_commit();
    }
    const bf16* Qt = Qs + stage * BM * D;
    const bf16* dOt = dOs + stage * BM * D;
    const float* lset = lses + stage * BM;
    const float* dit = dis + stage * BM;

    // rows are this warp's KV rows, columns the tile's query rows: p^T, then
    // dv += p^T do while p^T stays in float32 for ds^T
    float p[NT][4];
    product_abt<D, NT>(p, ka, Qt, lane);
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      const float2 l = *reinterpret_cast<const float2*>(lset + 8 * jt + 2 * t);
      const float l0 = l.x * LOG2E, l1 = l.y * LOG2E;
      p[jt][0] = ex2(fmaf(p[jt][0], scale2, -l0));
      p[jt][1] = ex2(fmaf(p[jt][1], scale2, -l1));
      p[jt][2] = ex2(fmaf(p[jt][2], scale2, -l0));
      p[jt][3] = ex2(fmaf(p[jt][3], scale2, -l1));
    }
    uint32_t frags[NT / 2][4];
    to_a_frags<NT>(frags, p);
    product_ab<D, NT>(dv_acc, frags, dOt, lane);

    float dp[NT][4];
    product_abt<D, NT>(dp, va, dOt, lane);
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      const float2 dd = *reinterpret_cast<const float2*>(dit + 8 * jt + 2 * t);
      dp[jt][0] = (dp[jt][0] - dd.x) * p[jt][0] * scale;
      dp[jt][1] = (dp[jt][1] - dd.y) * p[jt][1] * scale;
      dp[jt][2] = (dp[jt][2] - dd.x) * p[jt][2] * scale;
      dp[jt][3] = (dp[jt][3] - dd.y) * p[jt][3] * scale;
    }
    to_a_frags<NT>(frags, dp);
    product_ab<D, NT>(dk_acc, frags, Qt, lane);
  }
  store_rows<D>(dk + (bh * m + col0 + warp * 16) * D, dk_acc, lane);
  store_rows<D>(dv + (bh * m + col0 + warp * 16) * D, dv_acc, lane);
}

// ----------------------------------------------------- d 64: warpgroup MMA
//
// At d 64 the five products run as `wgmma.mma_async.m64n64k16`: a warpgroup
// (4 warps) owns 64 rows, a block two warpgroups.  p and ds go straight from
// the accumulators into A-operand registers; the B operand is the swept tile
// in shared memory, read through a matrix descriptor: K-major for
// s = q k^T and dp = do v^T, MN-major (the same tile, `tnspB`) for the
// second products.  The owned rows are the A operand of the first products:
// register fragments in the dq kernel, and a descriptor of the owned tile in
// the dk/dv kernel, whose four accumulators leave no registers for them.  A
// (64, 64) bf16 tile has rows of 128 bytes, so `swz<64>` is the hardware's
// 128-byte swizzle when the tile starts on a 1024-byte boundary.  The swept
// tiles go through a three-stage `cp.async` ring, and the loop is skewed by
// one tile: the first products of tile j are started together with the second
// products of tile j - 1, so that the exponentials of tile j run while the
// tensor cores finish tile j - 1.  No instruction but `wgmma` writes an
// accumulator, and no product stays in flight from one turn of the loop to
// the next (either would make the compiler serialise them): p and ds are
// packed into one of two sets of fragment registers, turn by turn.
namespace wg {

constexpr int D = 64;
constexpr int ROWS = 64;                  // rows a warpgroup owns; rows of a swept tile
constexpr int NTHREADS = 2 * 128;         // two warpgroups
constexpr int STAGES = 3;
constexpr int TILE_ELEMS = ROWS * D;      // 8 KB: eight 1024-byte swizzle atoms
constexpr int ALIGN = 1024;

static_assert(OWN == 2 * ROWS, "a block owns two warpgroups' rows");

// The shared-memory matrix descriptor of a (64, 64) bf16 tile with the
// 128-byte swizzle: start address, leading offset (unused by a swizzled
// 64-wide tile: 1), stride between 8-row groups (1024 bytes), all in units
// of 16 bytes; swizzle mode 1 in bits 62-63.
__device__ __forceinline__ uint64_t tile_desc(const bf16* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}
// k16 step `kk` of the tile's columns (K-major use): 32 bytes along a row.
__device__ __forceinline__ uint64_t desc_cols(uint64_t desc, int kk) { return desc + 2 * kk; }
// k16 step `ks` of the tile's rows (MN-major use): 16 rows of 128 bytes.
__device__ __forceinline__ uint64_t desc_rows(uint64_t desc, int ks) { return desc + 128 * ks; }

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Writes by `cp.async` (the generic proxy) made visible to `wgmma`'s reads
// (the async proxy); executed by every thread before the block's barrier.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (the warpgroup's 64 x 64, this thread's 8 n8 tiles x 4 as in `mma16816`)
// = or += a (this warp's 16 x 16 fragment) b (16 x 64 through `desc`).
// TRANS_B 0: b is read K-major (b[k][n] = tile[n][k]); 1: MN-major
// (b[k][n] = tile[k][n]).
template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc,
                                      int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// The same with a (64 x 16) read from shared memory through `adesc`,
// K-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t adesc, uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(adesc), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// acc = A tile^T: the owned rows' fragments against the swept tile's rows.
__device__ __forceinline__ void product_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                            uint64_t desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma<0>(acc, a[kk], desc_cols(desc, kk), kk > 0);
}

// The same with the owned rows read from their tile in shared memory.
__device__ __forceinline__ void product_abt(float (&acc)[8][4], uint64_t adesc, uint64_t desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(acc, desc_cols(adesc, kk), desc_cols(desc, kk), kk > 0);
}

// acc (+)= P tile: p or ds as fragments, summed over the swept tile's rows.
// The first tile of a sweep starts the sum (`accumulate` 0): nothing but
// `wgmma` ever writes these accumulators.
__device__ __forceinline__ void product_ab(float (&acc)[8][4], const uint32_t (&p)[4][4],
                                           uint64_t desc, int accumulate) {
#pragma unroll
  for (int ks = 0; ks < ROWS / 16; ++ks)
    wgmma<1>(acc, p[ks], desc_rows(desc, ks), ks > 0 ? 1 : accumulate);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((ALIGN - (smem_addr(raw) & (ALIGN - 1))) & (ALIGN - 1));
}

constexpr int DQ_SMEM_BYTES = (2 * OWN * D + 2 * STAGES * TILE_ELEMS) * (int)sizeof(bf16) + ALIGN;

__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ di, bf16* __restrict__ dq, int n, int m, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(aligned_smem(smem_raw));   // (OWN, 64)
  bf16* dOs = Qs + OWN * D;                                     // (OWN, 64)
  bf16* Ks = dOs + OWN * D;                                     // STAGES of (64, 64)
  bf16* Vs = Ks + STAGES * TILE_ELEMS;                          // STAGES of (64, 64)

  const int q_tiles = n / OWN;
  const long long bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * OWN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const bf16* kbase = k + bh * m * D;
  const bf16* vbase = v + bh * m * D;
  const int tiles = m / ROWS;

  load_tile_async<D, OWN>(Qs, q + (bh * n + row0) * D);
  load_tile_async<D, OWN>(dOs, dout + (bh * n + row0) * D);
  cp_async_commit();
  load_tile_async<D, ROWS>(Ks, kbase);
  load_tile_async<D, ROWS>(Vs, vbase);
  cp_async_commit();
  if (tiles > 1) {
    load_tile_async<D, ROWS>(Ks + TILE_ELEMS, kbase + TILE_ELEMS);
    load_tile_async<D, ROWS>(Vs + TILE_ELEMS, vbase + TILE_ELEMS);
  }
  cp_async_commit();

  const long long r_lo = bh * n + row0 + warp * 16 + g;
  const float lse_lo = lse[r_lo] * LOG2E, lse_hi = lse[r_lo + 8] * LOG2E;
  const float di_lo = di[r_lo], di_hi = di[r_lo + 8];
  const float scale2 = scale * LOG2E;

  cp_async_wait<2>();
  __syncthreads();
  uint32_t qa[D / 16][4], doa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<D>(qa[kk], Qs, warp * 16, kk, lane);
    load_a<D>(doa[kk], dOs, warp * 16, kk, lane);
  }
  cp_async_wait<1>();
  fence_async_proxy();
  __syncthreads();

  float s[8][4], dp[8][4], acc[8][4];
  uint32_t ds_even[ROWS / 16][4], ds_odd[ROWS / 16][4];

  // ds of tile j from its s and dp, packed as A fragments.
  auto ds_frags = [&](uint32_t (&dsa)[ROWS / 16][4]) {
#pragma unroll
    for (int ks = 0; ks < ROWS / 16; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jt = 2 * ks + half;
        dsa[ks][2 * half] =
            pack2((dp[jt][0] - di_lo) * ex2(fmaf(s[jt][0], scale2, -lse_lo)) * scale,
                  (dp[jt][1] - di_lo) * ex2(fmaf(s[jt][1], scale2, -lse_lo)) * scale);
        dsa[ks][2 * half + 1] =
            pack2((dp[jt][2] - di_hi) * ex2(fmaf(s[jt][2], scale2, -lse_hi)) * scale,
                  (dp[jt][3] - di_hi) * ex2(fmaf(s[jt][3], scale2, -lse_hi)) * scale);
      }
  };
  // Every warp's products of tile j - 1 are done and tile j + 1 has landed:
  // tile j + 2 goes into tile j - 1's stage.
  auto advance_ring = [&](int j) {
    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();
    if (j + 2 < tiles) {
      const int into = (j + 2) % STAGES;
      load_tile_async<D, ROWS>(Ks + into * TILE_ELEMS, kbase + (long long)(j + 2) * TILE_ELEMS);
      load_tile_async<D, ROWS>(Vs + into * TILE_ELEMS, vbase + (long long)(j + 2) * TILE_ELEMS);
    }
    cp_async_commit();
  };
  // Tile j >= 1: its s and dp, then dq += ds k of tile j - 1 (`done`); ds of
  // tile j is computed into `mine` while that last product runs.
  auto tile_step = [&](int j, uint32_t (&mine)[ROWS / 16][4],
                       const uint32_t (&done)[ROWS / 16][4]) {
    const int stage = j % STAGES, before = (j - 1) % STAGES;
    wg_fence();
    product_abt(s, qa, tile_desc(Ks + stage * TILE_ELEMS));
    product_abt(dp, doa, tile_desc(Vs + stage * TILE_ELEMS));
    wg_commit();
    product_ab(acc, done, tile_desc(Ks + before * TILE_ELEMS), j > 1);
    wg_commit();
    wg_wait<1>();
    ds_frags(mine);
    wg_wait<0>();
    advance_ring(j);
  };

  wg_fence();
  product_abt(s, qa, tile_desc(Ks));
  product_abt(dp, doa, tile_desc(Vs));
  wg_commit();
  wg_wait<0>();
  ds_frags(ds_even);
  advance_ring(0);
  // m is a multiple of OWN: an even count of tiles
  for (int j = 1; j + 1 < tiles; j += 2) {
    tile_step(j, ds_odd, ds_even);
    tile_step(j + 1, ds_even, ds_odd);
  }
  tile_step(tiles - 1, ds_odd, ds_even);
  wg_fence();
  product_ab(acc, ds_odd, tile_desc(Ks + ((tiles - 1) % STAGES) * TILE_ELEMS), 1);
  wg_commit();
  wg_wait<0>();
  store_rows<D>(dq + (bh * n + row0 + warp * 16) * D, acc, lane);
}

constexpr int DKV_SMEM_BYTES = (2 * OWN * D + 2 * STAGES * TILE_ELEMS) * (int)sizeof(bf16) +
                               2 * STAGES * ROWS * (int)sizeof(float) + ALIGN;

__global__ void __launch_bounds__(NTHREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
           int m, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(aligned_smem(smem_raw));   // (OWN, 64)
  bf16* Vs = Ks + OWN * D;                                      // (OWN, 64)
  bf16* Qs = Vs + OWN * D;                                      // STAGES of (64, 64)
  bf16* dOs = Qs + STAGES * TILE_ELEMS;                         // STAGES of (64, 64)
  float* lses = reinterpret_cast<float*>(dOs + STAGES * TILE_ELEMS);   // STAGES of 64
  float* dis = lses + STAGES * ROWS;                                    // STAGES of 64

  const int kv_tiles = m / OWN;
  const long long bh = blockIdx.x / kv_tiles;
  const int col0 = (blockIdx.x % kv_tiles) * OWN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bf16* qbase = q + bh * n * D;
  const bf16* dobase = dout + bh * n * D;
  const float* lsebase = lse + bh * n;
  const float* dibase = di + bh * n;
  const int tiles = n / ROWS;

  auto load_swept = [&](int tile, int into) {
    load_tile_async<D, ROWS>(Qs + into * TILE_ELEMS, qbase + (long long)tile * TILE_ELEMS);
    load_tile_async<D, ROWS>(dOs + into * TILE_ELEMS, dobase + (long long)tile * TILE_ELEMS);
    load_floats_async<ROWS>(lses + into * ROWS, lsebase + tile * ROWS, 0);
    load_floats_async<ROWS>(dis + into * ROWS, dibase + tile * ROWS, ROWS / 4);
  };

  load_tile_async<D, OWN>(Ks, k + (bh * m + col0) * D);
  load_tile_async<D, OWN>(Vs, v + (bh * m + col0) * D);
  cp_async_commit();
  load_swept(0, 0);
  cp_async_commit();
  if (tiles > 1) load_swept(1, 1);
  cp_async_commit();

  const float scale2 = scale * LOG2E;
  // this warpgroup's 64 of the owned rows, as the A operand
  const uint64_t ka = tile_desc(Ks + (warp >> 2) * TILE_ELEMS);
  const uint64_t va = tile_desc(Vs + (warp >> 2) * TILE_ELEMS);
  cp_async_wait<1>();
  fence_async_proxy();
  __syncthreads();

  // rows are this warp's KV rows, columns the swept tile's query rows
  float st[8][4], dpt[8][4], dk_acc[8][4], dv_acc[8][4];
  uint32_t p_even[ROWS / 16][4], ds_even[ROWS / 16][4], p_odd[ROWS / 16][4],
      ds_odd[ROWS / 16][4];

  // p^T and ds^T of tile j from its s^T and dp^T, packed as A fragments.
  auto p_ds_frags = [&](int j, uint32_t (&pa)[ROWS / 16][4], uint32_t (&dsa)[ROWS / 16][4]) {
    const float* lset = lses + (j % STAGES) * ROWS;
    const float* dit = dis + (j % STAGES) * ROWS;
#pragma unroll
    for (int ks = 0; ks < ROWS / 16; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jt = 2 * ks + half;
        const float2 l = *reinterpret_cast<const float2*>(lset + 8 * jt + 2 * t);
        const float2 dd = *reinterpret_cast<const float2*>(dit + 8 * jt + 2 * t);
        const float l0 = l.x * LOG2E, l1 = l.y * LOG2E;
        const float p0 = ex2(fmaf(st[jt][0], scale2, -l0));
        const float p1 = ex2(fmaf(st[jt][1], scale2, -l1));
        const float p2 = ex2(fmaf(st[jt][2], scale2, -l0));
        const float p3 = ex2(fmaf(st[jt][3], scale2, -l1));
        pa[ks][2 * half] = pack2(p0, p1);
        pa[ks][2 * half + 1] = pack2(p2, p3);
        dsa[ks][2 * half] =
            pack2((dpt[jt][0] - dd.x) * p0 * scale, (dpt[jt][1] - dd.y) * p1 * scale);
        dsa[ks][2 * half + 1] =
            pack2((dpt[jt][2] - dd.x) * p2 * scale, (dpt[jt][3] - dd.y) * p3 * scale);
      }
  };
  // Every warp's products of tile j - 1 are done and tile j + 1 has landed:
  // tile j + 2 goes into tile j - 1's stage.
  auto advance_ring = [&](int j) {
    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();
    if (j + 2 < tiles) load_swept(j + 2, (j + 2) % STAGES);
    cp_async_commit();
  };
  // Tile j >= 1: its s^T and dp^T, then dv += p^T do and dk += ds^T q of
  // tile j - 1 (`p_done`, `ds_done`); p^T and ds^T of tile j are computed
  // into `pa` and `dsa` while those last products run.
  auto tile_step = [&](int j, uint32_t (&pa)[ROWS / 16][4], uint32_t (&dsa)[ROWS / 16][4],
                       const uint32_t (&p_done)[ROWS / 16][4],
                       const uint32_t (&ds_done)[ROWS / 16][4]) {
    const int stage = j % STAGES, before = (j - 1) % STAGES;
    wg_fence();
    product_abt(st, ka, tile_desc(Qs + stage * TILE_ELEMS));
    product_abt(dpt, va, tile_desc(dOs + stage * TILE_ELEMS));
    wg_commit();
    product_ab(dv_acc, p_done, tile_desc(dOs + before * TILE_ELEMS), j > 1);
    product_ab(dk_acc, ds_done, tile_desc(Qs + before * TILE_ELEMS), j > 1);
    wg_commit();
    wg_wait<1>();
    p_ds_frags(j, pa, dsa);
    wg_wait<0>();
    advance_ring(j);
  };

  wg_fence();
  product_abt(st, ka, tile_desc(Qs));
  product_abt(dpt, va, tile_desc(dOs));
  wg_commit();
  wg_wait<0>();
  p_ds_frags(0, p_even, ds_even);
  advance_ring(0);
  // n is a multiple of OWN: an even count of tiles
  for (int j = 1; j + 1 < tiles; j += 2) {
    tile_step(j, p_odd, ds_odd, p_even, ds_even);
    tile_step(j + 1, p_even, ds_even, p_odd, ds_odd);
  }
  tile_step(tiles - 1, p_odd, ds_odd, p_even, ds_even);
  const int last = (tiles - 1) % STAGES;
  wg_fence();
  product_ab(dv_acc, p_odd, tile_desc(dOs + last * TILE_ELEMS), 1);
  product_ab(dk_acc, ds_odd, tile_desc(Qs + last * TILE_ELEMS), 1);
  wg_commit();
  wg_wait<0>();
  store_rows<D>(dk + (bh * m + col0 + warp * 16) * D, dk_acc, lane);
  store_rows<D>(dv + (bh * m + col0 + warp * 16) * D, dv_acc, lane);
}

}  // namespace wg

template <int D>
int backward_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                const float* di, bf16* dq, long long bh, int n, int m, float scale,
                cudaStream_t s) {
  const unsigned blocks = (unsigned)(bh * (n / OWN));
  if constexpr (D == wg::D) {
    if (int err = opt_in(wg::dq_kernel, wg::DQ_SMEM_BYTES)) return err;
    wg::dq_kernel<<<blocks, wg::NTHREADS, wg::DQ_SMEM_BYTES, s>>>(q, k, v, dout, lse, di, dq, n,
                                                                  m, scale);
  } else {
    constexpr int bytes = dq_smem_bytes<D>();
    if (int err = opt_in(dq_kernel<D>, bytes)) return err;
    dq_kernel<D><<<blocks, NTHREADS, bytes, s>>>(q, k, v, dout, lse, di, dq, n, m, scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int backward_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                 const float* di, bf16* dk, bf16* dv, long long bh, int n, int m, float scale,
                 cudaStream_t s) {
  const unsigned blocks = (unsigned)(bh * (m / OWN));
  if constexpr (D == wg::D) {
    if (int err = opt_in(wg::dkv_kernel, wg::DKV_SMEM_BYTES)) return err;
    wg::dkv_kernel<<<blocks, wg::NTHREADS, wg::DKV_SMEM_BYTES, s>>>(q, k, v, dout, lse, di, dk,
                                                                    dv, n, m, scale);
  } else {
    constexpr int bytes = dkv_smem_bytes<D>();
    if (int err = opt_in(dkv_kernel<D>, bytes)) return err;
    dkv_kernel<D><<<blocks, NTHREADS, bytes, s>>>(q, k, v, dout, lse, di, dk, dv, n, m, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc

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

}  // namespace

extern "C" {

// dq from q, k, v, do, lse and di = rowsum(o * do).  dtype 0, float32: the
// CUDA-core kernel (n, m multiples of 64); dtype 1, bfloat16: the
// tensor-core kernel, at every head size (n, m multiples of 128).
int fa_backward_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* di, void* dq, long long bh, int n, int m, int d, float scale,
                   int dtype, int device, void* stream) {
  if (!q || !k || !v || !dout || !lse || !di || !dq) return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* r = (const float*)di;
  if (dtype == 0) {
    if (bad_shape(bh, n, m, TILE)) return ERR_ARGS;
    FA_HEAD_DISPATCH(backward_dq, d, (const float*)q, (const float*)k, (const float*)v,
                     (const float*)dout, l, r, (float*)dq, bh, n, m, scale, s);
  }
  if (dtype == 1) {
    if (bad_shape(bh, n, m, tc::OWN)) return ERR_ARGS;
    FA_HEAD_DISPATCH(tc::backward_dq, d, (const tc::bf16*)q, (const tc::bf16*)k,
                     (const tc::bf16*)v, (const tc::bf16*)dout, l, r, (tc::bf16*)dq, bh, n, m,
                     scale, s);
  }
  return ERR_ARGS;
}

// dk and dv from the same inputs, by the same rule.
int fa_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* di, void* dk, void* dv, long long bh, int n,
                    int m, int d, float scale, int dtype, int device, void* stream) {
  if (!q || !k || !v || !dout || !lse || !di || !dk || !dv) return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* r = (const float*)di;
  if (dtype == 0) {
    if (bad_shape(bh, n, m, TILE)) return ERR_ARGS;
    FA_HEAD_DISPATCH(backward_dkv, d, (const float*)q, (const float*)k, (const float*)v,
                     (const float*)dout, l, r, (float*)dk, (float*)dv, bh, n, m, scale, s);
  }
  if (dtype == 1) {
    if (bad_shape(bh, n, m, tc::OWN)) return ERR_ARGS;
    FA_HEAD_DISPATCH(tc::backward_dkv, d, (const tc::bf16*)q, (const tc::bf16*)k,
                     (const tc::bf16*)v, (const tc::bf16*)dout, l, r, (tc::bf16*)dk,
                     (tc::bf16*)dv, bh, n, m, scale, s);
  }
  return ERR_ARGS;
}

const char* fa_bwd_error_string(int err) {
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
