// Streaming softmax attention for long sequences, the backward, for Hopper
// (sm_90a).  Replaces the two Pallas TPU kernels of
// moleculediffusiontransformer_tpu/ops/flash_attention.py:
//
//   fa_backward_dq   _dq_kernel   (:185)  dq = sum_kv ds k
//   fa_backward_dkv  _dkv_kernel  (:220)  dv = sum_q p^T do, dk = sum_q ds^T q
//                    with s = q k^T * scale, p = exp(s - lse),
//                    ds = (do v^T - di) * p * scale
//
// q, do, dq are (b, h, n, d); k, v, dk, dv (b, h, m, d), each with its own
// batch, head and row strides (`BwdLayout`: split heads are read and written
// in place in their (b, rows, h, d) buffers); lse and di (b h, n) float32,
// contiguous; d is 16, 32, 64 or 128.  di = rowsum(o * do) is not computed
// here: the caller hands it in, as `_bwd_pallas` computes it outside its
// kernels.
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
//   accumulators of 128 columns leave no room for more).  The pieces both
//   directions use are in flash_attention_tc.cuh.
// * float32 -> the CUDA cores, from float32 tiles in shared memory
//   (flash_attention_tiles.cuh).  TF32 tensor-core products would leave the
//   1e-4 band in which the float32 path is held against the CPU.
#include "flash_attention_tc.cuh"

namespace {

// The strided layouts of the backward's tensors (flash_attention_tiles.cuh,
// `Rows`) and the heads a batch entry holds.
struct BwdLayout {
  Rows q, k, v, dout, dq, dk, dv;
  int heads;
};

// ================================================================ float32

// --------------------------------------------------------------------- dq

template <int D>
constexpr int dq_smem_floats() { return 2 * TILE * D + 2 * D * LDT + TILE * D + TILE * TILE; }

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ di, float* __restrict__ dq, BwdLayout L, int n, int m,
          float scale) {
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

  const float* kbase = k + L.k.at(bh, L.heads);
  const float* vbase = v + L.v.at(bh, L.heads);
  load_rows<D>(Qs, q + L.q.at(bh, L.heads, row0), L.q.row);
  load_rows<D>(dOs, dout + L.dout.at(bh, L.heads, row0), L.dout.row);
  float row_lse[4], row_di[4], acc[4][CO];
  load_vec<4>(lse + bh * n + row0 + ty * 4, row_lse);
  load_vec<4>(di + bh * n + row0 + ty * 4, row_di);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;

  for (int col0 = 0; col0 < m; col0 += TILE) {
    __syncthreads();
    load_rows_transposed<D>(Kt, kbase + (long long)col0 * L.k.row, L.k.row);
    load_rows_transposed<D>(Vt, vbase + (long long)col0 * L.v.row, L.v.row);
    load_rows<D>(Ks, kbase + (long long)col0 * L.k.row, L.k.row);
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
  store_tile<CO>(dq + L.dq.at(bh, L.heads, row0), L.dq.row, acc, ty, tx);
}

// ------------------------------------------------------------------ dk, dv

template <int D>
constexpr int dkv_smem_floats() { return 2 * D * LDT + 2 * TILE * D + 2 * TILE * TILE; }

template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv,
           BwdLayout L, int n, int m, float scale) {
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

  const float* qbase = q + L.q.at(bh, L.heads);
  const float* dobase = dout + L.dout.at(bh, L.heads);
  load_rows_transposed<D>(Kt, k + L.k.at(bh, L.heads, col0), L.k.row);
  load_rows_transposed<D>(Vt, v + L.v.at(bh, L.heads, col0), L.v.row);
  float dk_acc[4][CO], dv_acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int row0 = 0; row0 < n; row0 += TILE) {
    __syncthreads();
    load_rows<D>(Qs, qbase + (long long)row0 * L.q.row, L.q.row);
    load_rows<D>(dOs, dobase + (long long)row0 * L.dout.row, L.dout.row);
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
  store_tile<CO>(dk + L.dk.at(bh, L.heads, col0), L.dk.row, dk_acc, ty, tx);
  store_tile<CO>(dv + L.dv.at(bh, L.heads, col0), L.dv.row, dv_acc, ty, tx);
}

template <int D>
int backward_dq(const float* q, const float* k, const float* v, const float* dout,
                const float* lse, const float* di, float* dq, const BwdLayout& L, long long bh,
                int n, int m, float scale, cudaStream_t s) {
  constexpr int bytes = dq_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(dq_kernel<D>, bytes)) return err;
  dq_kernel<D><<<(unsigned)(bh * (n / TILE)), THREADS, bytes, s>>>(q, k, v, dout, lse, di, dq, L,
                                                                    n, m, scale);
  return (int)cudaGetLastError();
}

template <int D>
int backward_dkv(const float* q, const float* k, const float* v, const float* dout,
                 const float* lse, const float* di, float* dk, float* dv, const BwdLayout& L,
                 long long bh, int n, int m, float scale, cudaStream_t s) {
  constexpr int bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(dkv_kernel<D>, bytes)) return err;
  dkv_kernel<D><<<(unsigned)(bh * (m / TILE)), THREADS, bytes, s>>>(q, k, v, dout, lse, di, dk,
                                                                     dv, L, n, m, scale);
  return (int)cudaGetLastError();
}

// =============================================================== bfloat16
//
// The `mma.sync` kernels (every head size but 64), then `wg`, the `wgmma`
// kernels of d 64; the pieces they share with the forward are in
// flash_attention_tc.cuh.

namespace tc {

// --------------------------------------------------------------------- dq

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * OWN * D + 4 * SWEEP<D> * D) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ di, bf16* __restrict__ dq, BwdLayout L, int n, int m,
          float scale) {
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
  const bf16* kbase = k + L.k.at(bh, L.heads);
  const bf16* vbase = v + L.v.at(bh, L.heads);

  load_tile_async<D, OWN>(Qs, q + L.q.at(bh, L.heads, row0), L.q.row);
  load_tile_async<D, OWN>(dOs, dout + L.dout.at(bh, L.heads, row0), L.dout.row);
  cp_async_commit();
  load_tile_async<D, BN>(Ks, kbase, L.k.row);
  load_tile_async<D, BN>(Vs, vbase, L.v.row);
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
      const int next = (j + 1) * BN;
      load_tile_async<D, BN>(Ks + (stage ^ 1) * BN * D, kbase + (long long)next * L.k.row, L.k.row);
      load_tile_async<D, BN>(Vs + (stage ^ 1) * BN * D, vbase + (long long)next * L.v.row, L.v.row);
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
  store_rows<D>(dq + L.dq.at(bh, L.heads, row0 + warp * 16), acc, lane, L.dq.row);
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
           const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
           BwdLayout L, int n, int m, float scale) {
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
  const bf16* qbase = q + L.q.at(bh, L.heads);
  const bf16* dobase = dout + L.dout.at(bh, L.heads);
  const float* lsebase = lse + bh * n;
  const float* dibase = di + bh * n;

  load_tile_async<D, OWN>(Ks, k + L.k.at(bh, L.heads, col0), L.k.row);
  load_tile_async<D, OWN>(Vs, v + L.v.at(bh, L.heads, col0), L.v.row);
  cp_async_commit();
  load_tile_async<D, BM>(Qs, qbase, L.q.row);
  load_tile_async<D, BM>(dOs, dobase, L.dout.row);
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
      const int next = (j + 1) * BM;
      load_tile_async<D, BM>(Qs + (stage ^ 1) * BM * D, qbase + (long long)next * L.q.row, L.q.row);
      load_tile_async<D, BM>(dOs + (stage ^ 1) * BM * D, dobase + (long long)next * L.dout.row,
                             L.dout.row);
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
  const int own0 = col0 + warp * 16;
  store_rows<D>(dk + L.dk.at(bh, L.heads, own0), dk_acc, lane, L.dk.row);
  store_rows<D>(dv + L.dv.at(bh, L.heads, own0), dv_acc, lane, L.dv.row);
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

static_assert(OWN == 2 * ROWS, "a block owns two warpgroups' rows");

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


constexpr int DQ_SMEM_BYTES = (2 * OWN * D + 2 * STAGES * TILE_ELEMS) * (int)sizeof(bf16) + ALIGN;

__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ di, bf16* __restrict__ dq, BwdLayout L, int n, int m,
          float scale) {
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
  const bf16* kbase = k + L.k.at(bh, L.heads);
  const bf16* vbase = v + L.v.at(bh, L.heads);
  const int tiles = m / ROWS;

  load_tile_async<D, OWN>(Qs, q + L.q.at(bh, L.heads, row0), L.q.row);
  load_tile_async<D, OWN>(dOs, dout + L.dout.at(bh, L.heads, row0), L.dout.row);
  cp_async_commit();
  load_tile_async<D, ROWS>(Ks, kbase, L.k.row);
  load_tile_async<D, ROWS>(Vs, vbase, L.v.row);
  cp_async_commit();
  if (tiles > 1) {
    load_tile_async<D, ROWS>(Ks + TILE_ELEMS, kbase + (long long)ROWS * L.k.row, L.k.row);
    load_tile_async<D, ROWS>(Vs + TILE_ELEMS, vbase + (long long)ROWS * L.v.row, L.v.row);
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
      const int next = (j + 2) * ROWS;
      load_tile_async<D, ROWS>(Ks + into * TILE_ELEMS, kbase + (long long)next * L.k.row, L.k.row);
      load_tile_async<D, ROWS>(Vs + into * TILE_ELEMS, vbase + (long long)next * L.v.row, L.v.row);
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
  store_rows<D>(dq + L.dq.at(bh, L.heads, row0 + warp * 16), acc, lane, L.dq.row);
}

constexpr int DKV_SMEM_BYTES = (2 * OWN * D + 2 * STAGES * TILE_ELEMS) * (int)sizeof(bf16) +
                               2 * STAGES * ROWS * (int)sizeof(float) + ALIGN;

__global__ void __launch_bounds__(NTHREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
           BwdLayout L, int n, int m, float scale) {
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
  const bf16* qbase = q + L.q.at(bh, L.heads);
  const bf16* dobase = dout + L.dout.at(bh, L.heads);
  const float* lsebase = lse + bh * n;
  const float* dibase = di + bh * n;
  const int tiles = n / ROWS;

  auto load_swept = [&](int tile, int into) {
    const int first = tile * ROWS;
    load_tile_async<D, ROWS>(Qs + into * TILE_ELEMS, qbase + (long long)first * L.q.row, L.q.row);
    load_tile_async<D, ROWS>(dOs + into * TILE_ELEMS, dobase + (long long)first * L.dout.row,
                             L.dout.row);
    load_floats_async<ROWS>(lses + into * ROWS, lsebase + tile * ROWS, 0);
    load_floats_async<ROWS>(dis + into * ROWS, dibase + tile * ROWS, ROWS / 4);
  };

  load_tile_async<D, OWN>(Ks, k + L.k.at(bh, L.heads, col0), L.k.row);
  load_tile_async<D, OWN>(Vs, v + L.v.at(bh, L.heads, col0), L.v.row);
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
  const int own0 = col0 + warp * 16;
  store_rows<D>(dk + L.dk.at(bh, L.heads, own0), dk_acc, lane, L.dk.row);
  store_rows<D>(dv + L.dv.at(bh, L.heads, own0), dv_acc, lane, L.dv.row);
}

}  // namespace wg

template <int D>
int backward_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                const float* di, bf16* dq, const BwdLayout& L, long long bh, int n, int m,
                float scale, cudaStream_t s) {
  const unsigned blocks = (unsigned)(bh * (n / OWN));
  if constexpr (D == wg::D) {
    if (int err = opt_in(wg::dq_kernel, wg::DQ_SMEM_BYTES)) return err;
    wg::dq_kernel<<<blocks, wg::NTHREADS, wg::DQ_SMEM_BYTES, s>>>(q, k, v, dout, lse, di, dq, L,
                                                                  n, m, scale);
  } else {
    constexpr int bytes = dq_smem_bytes<D>();
    if (int err = opt_in(dq_kernel<D>, bytes)) return err;
    dq_kernel<D><<<blocks, NTHREADS, bytes, s>>>(q, k, v, dout, lse, di, dq, L, n, m, scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int backward_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                 const float* di, bf16* dk, bf16* dv, const BwdLayout& L, long long bh, int n,
                 int m, float scale, cudaStream_t s) {
  const unsigned blocks = (unsigned)(bh * (m / OWN));
  if constexpr (D == wg::D) {
    if (int err = opt_in(wg::dkv_kernel, wg::DKV_SMEM_BYTES)) return err;
    wg::dkv_kernel<<<blocks, wg::NTHREADS, wg::DKV_SMEM_BYTES, s>>>(q, k, v, dout, lse, di, dk,
                                                                    dv, L, n, m, scale);
  } else {
    constexpr int bytes = dkv_smem_bytes<D>();
    if (int err = opt_in(dkv_kernel<D>, bytes)) return err;
    dkv_kernel<D><<<blocks, NTHREADS, bytes, s>>>(q, k, v, dout, lse, di, dk, dv, L, n, m,
                                                  scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc

// The arguments both entry points check: the layout from the host array of
// (batch, head, row) strides of q, k, v, do, dq, dk, dv, in elements; the
// shape (n, m multiples of 64 in float32, of 128 in bfloat16: the tensor-core
// kernels own 128 rows a block and sweep an even count of 64-row tiles); and
// the alignment of every pointer and stride to 16 bytes.
BwdLayout layout_of(const long long* strides, int heads) {
  BwdLayout L;
  Rows* rows[] = {&L.q, &L.k, &L.v, &L.dout, &L.dq, &L.dk, &L.dv};
  for (int i = 0; i < 7; ++i) *rows[i] = rows_of(strides, i);
  L.heads = heads;
  return L;
}

int check_args(const void* const* ptrs, int count, const long long* strides, long long b,
               int h, int n, int m, int dtype) {
  for (int i = 0; i < count; ++i)
    if (misaligned(ptrs[i])) return ERR_ARGS;
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const int tile = dtype == 0 ? TILE : tc::OWN;
  if (!elem || !strides || bad_strides(strides, 21, elem) ||
      bad_shape(b * h, h, n, m, tile, tile))
    return ERR_ARGS;
  return 0;
}

}  // namespace

extern "C" {

// dq from q, k, v, do, lse and di = rowsum(o * do), for b x h (batch,
// head) pairs.  dtype 0, float32: the CUDA-core kernel; dtype 1, bfloat16:
// the tensor-core kernel, at every head size.
int fa_backward_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* di, void* dq, const long long* strides, long long b, int h, int n,
                   int m, int d, float scale, int dtype, int device, void* stream) {
  const void* ptrs[] = {q, k, v, dout, lse, di, dq};
  if (int err = check_args(ptrs, 7, strides, b, h, n, m, dtype)) return err;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const BwdLayout L = layout_of(strides, h);
  const float* l = (const float*)lse;
  const float* r = (const float*)di;
  if (dtype == 0)
    FA_HEAD_DISPATCH(backward_dq, d, (const float*)q, (const float*)k, (const float*)v,
                     (const float*)dout, l, r, (float*)dq, L, b * h, n, m, scale, s);
  FA_HEAD_DISPATCH(tc::backward_dq, d, (const tc::bf16*)q, (const tc::bf16*)k,
                   (const tc::bf16*)v, (const tc::bf16*)dout, l, r, (tc::bf16*)dq, L, b * h, n,
                   m, scale, s);
  return ERR_ARGS;
}

// dk and dv from the same inputs, by the same rule.
int fa_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* di, void* dk, void* dv,
                    const long long* strides, long long b, int h, int n, int m, int d,
                    float scale, int dtype, int device, void* stream) {
  const void* ptrs[] = {q, k, v, dout, lse, di, dk, dv};
  if (int err = check_args(ptrs, 8, strides, b, h, n, m, dtype)) return err;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const BwdLayout L = layout_of(strides, h);
  const float* l = (const float*)lse;
  const float* r = (const float*)di;
  if (dtype == 0)
    FA_HEAD_DISPATCH(backward_dkv, d, (const float*)q, (const float*)k, (const float*)v,
                     (const float*)dout, l, r, (float*)dk, (float*)dv, L, b * h, n, m, scale, s);
  FA_HEAD_DISPATCH(tc::backward_dkv, d, (const tc::bf16*)q, (const tc::bf16*)k,
                   (const tc::bf16*)v, (const tc::bf16*)dout, l, r, (tc::bf16*)dk,
                   (tc::bf16*)dv, L, b * h, n, m, scale, s);
  return ERR_ARGS;
}

const char* fa_bwd_error_string(int err) {
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
