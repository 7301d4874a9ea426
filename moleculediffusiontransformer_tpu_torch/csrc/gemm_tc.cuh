// The GEMM of the Transformer1d stack kernels and the resnet-run kernel on
// the H100's tensor cores (K1, transformer1d_fwd.cu; K2, K3 and K4,
// transformer1d_bwd.cu; K8, resnet_fwd.cu): bf16 in one pass, float32 in
// three TF32 passes.
//
// `launch_gemm_tc` takes gemm.cuh's `GemmArgs<T, O>` (the layout by
// strides, the six epilogues, the optional second output `out_t`) and
// computes what `launch_gemm` computes, with the same rounding points: the
// sum is float32, the epilogue is gemm.cuh's `epilogue_value` in float32, the
// output bf16 or float32.  Only the order of the float32 sums differs, and
// for float32 operands the products' precision: hi.hi + hi.lo + lo.hi of
// each operand's TF32 split keeps some 21-22 bits of a product (float32: 24),
// within 1e-7 of the output's scale at the stack's shapes and well inside
// the 1e-4 band in which the float32 stack is held against the CPU; one TF32
// pass (11 bits) would leave it, and no product takes one.
//
// The route is chosen from the dtype and the shape alone, on the host
// (`tc_layout`): a call whose operands each have one unit-stride dimension
// of a multiple of 16 bytes (8 bf16, 4 float32 elements) and a leading
// dimension of such a multiple, whose N is one too and whose pointers lie
// on 16-byte boundaries takes the tensor cores; anything else takes
// gemm.cuh's `gemm_kernel` on the CUDA cores (no product of the stack
// kernels or of K8 at the models' shapes does).  A launch error is
// returned, never retried on the other route.
//
// What bounds it on this card.  The stack's products have M = batch * L
// rows (2 .. 12,288 on the main path) and N, K of 128 .. 1,024: a few
// GFLOP a call at most, microseconds at the tensor cores' peak, with every
// operand resident in the 50 MB L2.  What decides the time is the latency a
// block spends around its products: moving its tiles in and its output tile
// out.  (A clock64 trace of a first version, which filled the ring by
// `cp.async` from every thread and stored the accumulators straight from
// their registers, found the load issue of a k-step several times longer
// than its products, and the scattered 4-byte stores of the epilogue longer
// than all of them; the GTC_TRACE stamps below measure this design.)
//
// What the design does about it.
//   * Tiles.  A warpgroup owns 64 output rows and issues
//     `wgmma.mma_async.m64n64k16` with both operands read from shared
//     memory through descriptors; the k-step is 64 (one 128-byte swizzled
//     row of bf16), and the tiles of three k-steps sit in a ring of shared
//     memory filled by TMA: one thread issues a k-step's boxes, an
//     `mbarrier` a stage counts their bytes, and the loads of k-steps t + 1
//     and t + 2 run under the products of k-step t.  TMA writes the 128-byte
//     swizzle the descriptors read and fills the boxes past M, N or K with
//     zeros: nothing assumes a size is a multiple of a tile.  float32
//     (`gemm_tf32x3_kernel`, below): the same blocks, `m64n64k8.tf32`, a
//     k-step of 32 floats, each operand split into hi and lo by the threads
//     that stage it (TF32 operands are read K-major only).
//   * The epilogue goes through shared memory: the accumulators are staged
//     as a float32 tile in the (by then free) ring, and each thread then
//     reads 4 consecutive columns of a row, applies the epilogue and writes
//     them as one 8- or 16-byte store, so a warp writes whole rows.
//   * Two block shapes, chosen on the host from M and N (`tile_for`): 128 x
//     128 (two warpgroups, each with two n64 products a k16 step) when that
//     grid alone has a block for every SM, else 64 x 64 (one warpgroup), so
//     that a call of a few rows (a request of 1 under CFG: M = 2) does not
//     launch a 128-row block for two rows, and a call of a few thousand rows
//     spreads over more SMs.  Timed at every 91M product shape with each
//     shape forced, 64 x 64 won wherever the 128 x 128 grid has up to 128
//     blocks (M 8,192 x N 256 included), 128 x 128 at all but one shape of
//     256 blocks or more (PERF.md, findings).
//   * Layouts.  A is K-major (NT, NN) or MN-major (TN: A = G^T, read in
//     place through `wgmma`'s transpose of A); B is K-major (NT) or MN-major
//     (NN, TN).  Each (64, 64) block of a tile is one 128-byte swizzle atom
//     (rows of 128 bytes along the unit-stride dimension), the layout both
//     transposes of the descriptor read and one TMA box (two for a 128-wide
//     MN-major tile) writes.
//   * Weight grads split over rows.  dW = G^T A has an output of only
//     256 x 128 .. 1,024 x 1,024 and sums over all batch * L rows.  With a
//     float32 partial buffer the caller (K2, K3, K4) splits the rows into S chunks,
//     S from the shape (`split_plan`, about one block an SM); block
//     (tile, chunk) writes its float32 partial, and a second pass sums the S
//     partials of each element in chunk order.  No atomics: a call gives
//     bitwise the same grads every time.
//   * `wgmma` stays asynchronous.  Nothing but `wgmma` writes the
//     accumulators between a fence and its wait (each tile's sum starts with
//     `scale-d` 0, not a zeroing loop), and no product is in flight at the
//     loop's back-edge; otherwise ptxas serialises every product
//     (tools/check_torch_gemm.py counts `WARPGROUP.DEPBAR` against `HGMMA`
//     in every instance, the float32 ones too).
#pragma once

#include "gemm.cuh"
#include "tensor_core.cuh"

#include <cuda.h>   // CUtensorMap and its enums (the encoder is fetched at run time)

#include <algorithm>
#include <type_traits>

namespace {
namespace gtc {

using tc::bf16;

constexpr int ATOM = 64 * 64;     // elements of a (64, 64) swizzle atom, 8 KB
// A k-step is 64 (one 128-byte row of bf16, one swizzle atom wide) and the
// ring holds 3 of them: a 128-deep k-step or a deeper ring measured no
// faster at the stack's shapes (PERF.md, findings).
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int SMS = 132;          // the H100 SXM's SMs: the grids aim at them
// A split call aims at one block an SM, each chunk at least 8 k-steps:
// measured against two blocks an SM and 2-step chunks, which write four
// times the float32 partials, this takes K2 from 7.8-8.0 to 7.3 ms
// (PERF.md, findings)
constexpr int SPLIT_BLOCKS = SMS;
constexpr int MIN_SPLIT_STEPS = 8;
// A float32 split call's chunks: at least this many k-steps of BK, where a
// k-step's products cost three passes
constexpr int F32_MIN_SPLIT_STEPS = 4;
constexpr int MAX_DEVICES = 64;

enum Route { ROUTE_CUDA_CORES = 0, ROUTE_TC_64 = 1, ROUTE_TC_128 = 2 };
constexpr int ERR_TENSOR_MAP = -2;   // cuTensorMapEncodeTiled refused a tensor map

// shared-memory bytes of a block of WGS warpgroups and BN columns
template <int WGS, int BN>
constexpr int SMEM_BYTES = STAGES * (WGS * 64 + BN) * BK * (int)sizeof(bf16) + tc::wg::ALIGN;

// GEMMs this library has sent to the tensor cores since it was loaded (or
// the caller's last reset): one a `launch_gemm_tc` call that took them.
long long g_tc_launches = 0;

// Built with -DGTC_TRACE (tools/check_torch_gemm.py --trace builds such a
// library apart), thread 0 of block (0, 0, 0) writes the clock64 cycles
// since its start at every stamp: after the first loads are issued; each
// k-step after its wait, after the barrier, after the next loads are
// issued, after its products; after the epilogue.  g_trace[63] holds the
// count.  Without it the stamps compile to nothing.
#ifdef GTC_TRACE
__device__ long long g_trace[64];
#define GTC_STAMP()                                                                    \
  do {                                                                                 \
    if (trace_on && trace_at < 63) g_trace[trace_at++] = clock64() - trace_start;     \
  } while (0)
#else
#define GTC_STAMP() \
  do {              \
  } while (0)
#endif

// A stored row of 4 elements in the output type
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// TMA boxes of the k-step at k0 of one operand into its ROWS / 64 atoms,
// atom rb holding rows 64 rb.. .  TRANS 0 (k unit-stride): one box of 64 k
// x ROWS rows, which lands as ROWS rows of 128 swizzled bytes, atom after
// atom; 1 (the rows unit-stride): one box of 64 rows x 64 k an atom.  The
// map's coordinates are (unit-stride, other); past the tensor's edge the
// box is zeros.
template <int ROWS, int TRANS>
__device__ __forceinline__ void load_operand(bf16* dst, const CUtensorMap* map, int row0, int k0,
                                             uint64_t* bar) {
  if constexpr (TRANS == 0) {
    tc::tma_load_2d(dst, map, k0, row0, bar);
  } else {
#pragma unroll
    for (int rb = 0; rb < ROWS / 64; ++rb)
      tc::tma_load_2d(dst + rb * ATOM, map, row0 + 64 * rb, k0, bar);
  }
}

// The epilogue of a (WGS * 64, BN) tile whose float32 sums `acc` the
// warpgroups hold, through `tile` (shared memory the ring is done with), so
// that it reads and writes whole rows: thread (g4, t4) of warp w in
// warpgroup wgi holds rows wgi * 64 + (w % 4) * 16 + g4 (+ 8) and columns
// h * 64 + j * 8 + 2 t4 (+ 1).  Then 4 consecutive columns a thread (N a
// multiple of 4: a group is all in or all out) go through `epilogue_value`
// into out (and out_t), or, with `partial`, into this chunk's partial.
template <int WGS, int BN, typename T, typename O>
__device__ __forceinline__ void store_tile(const GemmArgs<T, O>& g,
                                           const float (&acc)[BN / 64][8][4], float* tile, int m0,
                                           int n0, float* partial) {
  constexpr int BM = WGS * 64, NH = BN / 64, THREADS = WGS * 128;
  constexpr int LD = BN + 8;   // a staged output row, in floats: no bank conflicts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wgi = warp >> 2;
  {
    const int r = wgi * 64 + (warp & 3) * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(tile + (r + 8 * half) * LD + h * 64 + j * 8 + c) =
              make_float2(acc[h][j][2 * half], acc[h][j][2 * half + 1]);
  }
  __syncthreads();
  float* part = partial != nullptr ? partial + (size_t)blockIdx.z * g.M * g.N : nullptr;
  for (int e = threadIdx.x; e < BM * (BN / 4); e += THREADS) {
    const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= g.M || gn >= g.N) continue;
    const float4 q = *reinterpret_cast<const float4*>(tile + r * LD + c);
    float v[4] = {q.x, q.y, q.z, q.w};
    const size_t idx = (size_t)gm * g.N + gn;
    if (part != nullptr) {
      store4(part + idx, v);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = epilogue_value(g, idx + i, gn + i, v[i]);
    store4(g.out + idx, v);
    if (g.out_t != nullptr) store4(g.out_t + idx, v);
  }
}

// out (or, with `partial`, this chunk's float32 partial) of one
// (BM, BN) tile over the rows [blockIdx.z * chunk, + chunk) of k.  The
// operands come through the tensor maps `ta` and `tb` (`encode_operand`).
template <int WGS, int BN, int TA, int TB, typename O>
__global__ void __launch_bounds__(WGS * 128)
gemm_tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const GemmArgs<bf16, O> g, const int chunk, float* __restrict__ partial) {
  constexpr int BM = WGS * 64, NH = BN / 64;
  constexpr int A_ELEMS = BM * BK, STAGE = (BM + BN) * BK;
  static_assert(BM * (BN + 8) * 4 <= STAGES * STAGE * 2, "the output tile fits in the ring");
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES];   // one arrival + the TMA bytes of a stage
  bf16* smem = reinterpret_cast<bf16*>(tc::wg::aligned_smem(smem_raw));
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(g.K, kbeg + chunk);
  const int steps = (kend - kbeg + BK - 1) / BK;   // >= 1: the host makes no empty chunk
  const int wgi = threadIdx.x >> 7;                 // the warpgroup
#ifdef GTC_TRACE
  const bool trace_on = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                        blockIdx.z == 0;
  const long long trace_start = clock64();
  int trace_at = 0;
#endif

  // k-step t into stage t % STAGES, by one thread.  Chunks are whole
  // k-steps, so a box never reaches into the next chunk's rows of k; at K's
  // own edge the box is zeros.
  const CUtensorMap* map_a = &ta;
  const CUtensorMap* map_b = &tb;
  auto load = [&](int t) {
    if (t < steps) {
      uint64_t* bar = &full[t % STAGES];
      bf16* As = smem + (t % STAGES) * STAGE;
      const int k0 = kbeg + t * BK;
      tc::mbar_expect_tx(bar, STAGE * (int)sizeof(bf16));
      load_operand<BM, TA>(As, map_a, m0, k0, bar);
      load_operand<BN, TB>(As + A_ELEMS, map_b, n0, k0, bar);
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) tc::mbar_init(&full[s], 1);
    tc::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) load(t);
  }
  GTC_STAMP();

  float acc[NH][8][4];
  for (int t = 0; t < steps; ++t) {
    // k-step t has landed; once every warpgroup is past the barrier, none
    // reads t - 1's stage any more, and k-step t + STAGES - 1 fills it
    tc::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    GTC_STAMP();
    __syncthreads();
    GTC_STAMP();
    if (threadIdx.x == 0) load(t + STAGES - 1);
    GTC_STAMP();
    const bf16* As = smem + (t % STAGES) * STAGE;
    const bf16* Bs = As + A_ELEMS;
    tc::wg::wg_fence();
    const uint64_t adesc = tc::wg::tile_desc(As + wgi * ATOM);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a = TA ? tc::wg::desc_rows(adesc, kk) : tc::wg::desc_cols(adesc, kk);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t bdesc = tc::wg::tile_desc(Bs + h * ATOM);
        const uint64_t b = TB ? tc::wg::desc_rows(bdesc, kk) : tc::wg::desc_cols(bdesc, kk);
        tc::wg::wgmma_ss_t<TA, TB>(acc[h], a, b, (t | kk) != 0);
      }
    }
    tc::wg::wg_commit();
    tc::wg::wg_wait<0>();
    GTC_STAMP();
  }

  __syncthreads();
  store_tile<WGS, BN>(g, acc, reinterpret_cast<float*>(smem), m0, n0, partial);
  GTC_STAMP();
#ifdef GTC_TRACE
  if (trace_on) g_trace[63] = trace_at;
#endif
}

// ---- float32 as three TF32 passes
//
// A float32 operand x is split once, where its tile is staged, into
// hi = rna(x) and lo = rna(x - hi), both TF32 (`tc::tf32_rna`); a product
// is then hi.hi + hi.lo + lo.hi, each `wgmma ... .tf32` pass accumulating in
// float32 (lo.lo, below 2^-22 of the product, is dropped).  That keeps some
// 21-22 bits of each product, where one TF32 pass keeps 11.  The tensor
// cores' float32 additions truncate: a sum over thousands of k kept in
// their accumulators drifts by some 1e-5 of its scale (on an H100, a weight
// grad over 4,096 rows so kept ended 2.8e-5 of scale from the same grad
// split into 8 chunks), so each k-step's sum is added to a running sum on
// the CUDA cores, rounded to nearest.
//
// TF32 operands must be K-major in shared memory (`wgmma` transposes only
// 16-bit types), so no TMA box lands as the products read it: the threads
// copy each k-step from global memory (`cp.async`, 16-byte vectors along
// the operand's unit-stride dimension, k or its rows, zeros past the edges)
// into slots of their own in a ring of RAW_STAGES raw stages, and later
// read their own vectors back, split them, and store hi and lo into K-major
// tiles with the 128-byte swizzle, transposing an MN-major operand (NN's B,
// TN's A and B) on the way.  A k-step is 32 floats (one 128-byte swizzle
// row); the copies of k-steps t + 1 and t + 2 are in flight while the
// products of t run, and t + 1 is split into the other of two hi/lo stages
// before their wait.  The ring is there for the loads' latency: with one
// k-step in flight (32 KB a block, loaded into registers) a k-step took
// several times its products on an H100.
constexpr int BK32 = 32;
constexpr int ATOM32 = 64 * BK32;   // floats of a (64 rows, 32 k) swizzle atom, 8 KB
constexpr int RAW_STAGES = 3;

// shared-memory bytes of a block of WGS warpgroups and BN columns: two
// stages of hi and lo of A and B, and RAW_STAGES raw k-steps
template <int WGS, int BN>
constexpr int SMEM_BYTES_F32 =
    (2 * 2 + RAW_STAGES) * (WGS * 64 + BN) * BK32 * (int)sizeof(float) + tc::wg::ALIGN;

// Float offset of (row, 4-float chunk) in a K-major tile of 32-float rows
// with the 128-byte swizzle (`wgmma` descriptor mode 1: the 16-byte chunk
// XORed with the row's low 3 bits).
__device__ __forceinline__ int swz32(int row, int chunk) {
  return row * BK32 + ((chunk ^ (row & 7)) << 2);
}

// The first row r and k of 16-byte vector f of a k-step's (ROWS, 32) tile.
// TRANS 0 (k unit-stride): row f / 8, k 4 (f % 8) .. + 3.  TRANS 1 (rows
// unit-stride): a warp's 32 vectors are 16 rows of k by 2 vectors of 4
// rows, so that each k row is read as one 32-byte sector and the
// transposed stores of a warp fall on 32 banks; rows r .. r + 3 at k.
template <int TRANS>
__device__ __forceinline__ void vec_at(int f, int& r, int& k) {
  if constexpr (TRANS == 0) {
    r = f >> 3;
    k = (f & 7) << 2;
  } else {
    const int w = f >> 5, lane = f & 31;
    k = ((w & 1) << 4) + (lane & 15);
    r = (((w >> 1) << 1) + (lane >> 4)) << 2;
  }
}

// This thread's ROWS * 8 / THREADS vectors of the k-step at k0 of one
// operand (rows `row0` .., `extent` in all; `ld` apart along the dimension
// that is not unit-stride), copied into its slots of the raw stage `raw`
// (vector i at (i THREADS + thread) 4), zeros past `extent` and `kend`: a
// vector is all in or all out, since K (K-major) or `extent` (MN-major) is
// a multiple of 4.
template <int ROWS, int THREADS, int TRANS>
__device__ __forceinline__ void fetch32(float* raw, const float* base, long long ld, int extent,
                                        int row0, int k0, int kend) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    int r, k;
    vec_at<TRANS>(threadIdx.x + i * THREADS, r, k);
    const int gr = row0 + r, gk = k0 + k;
    const bool in = gr < extent && gk < kend;
    tc::cp_async16_zfill(raw + (i * THREADS + threadIdx.x) * 4,
                         in ? (TRANS == 0 ? base + gr * ld + gk : base + gk * ld + gr) : base,
                         in);
  }
}

// The vectors `fetch32` copied into `raw` (their copies done) split into hi
// and lo and stored K-major into the tiles `hi` and `lo` (ROWS x 32 floats
// each)
template <int ROWS, int THREADS, int TRANS>
__device__ __forceinline__ void stage32(const float* raw, float* hi, float* lo) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    int r, k;
    vec_at<TRANS>(threadIdx.x + i * THREADS, r, k);
    const float4 v = *reinterpret_cast<const float4*>(raw + (i * THREADS + threadIdx.x) * 4);
    const float x[4] = {v.x, v.y, v.z, v.w};
    float h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = tc::tf32_rna(x[j]);
      l[j] = tc::tf32_rna(x[j] - h[j]);
    }
    if constexpr (TRANS == 0) {
      const int at = swz32(r, k >> 2);
      *reinterpret_cast<float4*>(hi + at) = make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(lo + at) = make_float4(l[0], l[1], l[2], l[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = swz32(r + j, k >> 2) + (k & 3);
        hi[at] = h[j];
        lo[at] = l[j];
      }
    }
  }
}

// out (or, with `partial`, this chunk's float32 partial) of one (BM, BN)
// tile over the rows [blockIdx.z * chunk, + chunk) of k, float32 operands
// as three TF32 passes.  TA / TB: 0 K-major, 1 MN-major in global memory.
template <int WGS, int BN, int TA, int TB, typename O>
__global__ void __launch_bounds__(WGS * 128)
gemm_tf32x3_kernel(const GemmArgs<float, O> g, const int chunk, float* __restrict__ partial) {
  constexpr int BM = WGS * 64, NH = BN / 64, THREADS = WGS * 128;
  constexpr int A_TILE = BM * BK32, B_TILE = BN * BK32, STAGE = 2 * (A_TILE + B_TILE);
  constexpr int RAW = A_TILE + B_TILE;   // floats of a raw stage
  static_assert(BM * 8 % THREADS == 0 && BN * 8 % THREADS == 0, "whole vectors a thread");
  static_assert(BM * (BN + 8) <= 2 * STAGE, "the output tile fits in the hi/lo stages");
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(tc::wg::aligned_smem(smem_raw));
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(g.K, kbeg + chunk);
  const int steps = (kend - kbeg + BK32 - 1) / BK32;   // >= 1: no empty chunk
  const int wgi = threadIdx.x >> 7;
  // A[m, k] = A[m sam + k sak]: K-major rows `sam` apart, MN-major k `sak`
  const long long lda = TA ? g.sak : g.sam, ldb = TB ? g.sbk : g.sbn;

  float* const raw = smem + 2 * STAGE;
  // k-step t's copies into raw stage t % RAW_STAGES; one commit group a
  // step, empty past the last, so that a wait counts steps
  auto fetch = [&](int t) {
    if (t < steps) {
      float* r = raw + (t % RAW_STAGES) * RAW;
      const int k0 = kbeg + t * BK32;
      fetch32<BM, THREADS, TA>(r, g.A, lda, g.M, m0, k0, kend);
      fetch32<BN, THREADS, TB>(r + A_TILE, g.B, ldb, g.N, n0, k0, kend);
    }
    tc::cp_async_commit();
  };
  // once k-step t's copies (this thread's own) are done: hi A, lo A, hi B,
  // lo B of stage t % 2, made visible to `wgmma` (the async proxy) before
  // the barrier that precedes its products
  auto stage = [&](int t) {
    tc::cp_async_wait<RAW_STAGES - 2>();
    const float* r = raw + (t % RAW_STAGES) * RAW;
    float* st = smem + (t & 1) * STAGE;
    stage32<BM, THREADS, TA>(r, st, st + A_TILE);
    stage32<BN, THREADS, TB>(r + A_TILE, st + 2 * A_TILE, st + 2 * A_TILE + B_TILE);
    tc::wg::fence_async_proxy();
  };
#pragma unroll
  for (int t = 0; t < RAW_STAGES - 1; ++t) fetch(t);
  stage(0);
  __syncthreads();

  // `acc`: one k-step's sums, the tensor cores' (whose additions truncate);
  // `sum`: the k-steps' added in order on the CUDA cores, rounded to nearest,
  // so that a long k (a weight grad over thousands of rows) gathers no bias
  float acc[NH][8][4], sum[NH][8][4] = {};
  for (int t = 0; t < steps; ++t) {
    const bool next = t + 1 < steps;
    fetch(t + RAW_STAGES - 1);
    const float* st = smem + (t & 1) * STAGE;
    const uint64_t a_hi = tc::wg::tile_desc(st + wgi * ATOM32);
    const uint64_t a_lo = tc::wg::tile_desc(st + A_TILE + wgi * ATOM32);
    tc::wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK32 / 8; ++kk) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t b_hi =
            tc::wg::desc_cols(tc::wg::tile_desc(st + 2 * A_TILE + h * ATOM32), kk);
        const uint64_t b_lo =
            tc::wg::desc_cols(tc::wg::tile_desc(st + 2 * A_TILE + B_TILE + h * ATOM32), kk);
        // the small terms first, then hi.hi, in this order at every k8
        tc::wg::wgmma_tf32(acc[h], tc::wg::desc_cols(a_lo, kk), b_hi, kk != 0);
        tc::wg::wgmma_tf32(acc[h], tc::wg::desc_cols(a_hi, kk), b_lo, 1);
        tc::wg::wgmma_tf32(acc[h], tc::wg::desc_cols(a_hi, kk), b_hi, 1);
      }
    }
    tc::wg::wg_commit();
    // the next k-step into the other hi/lo stage, whose products (t - 1)
    // the last barrier saw done, while these run
    if (next) stage(t + 1);
    tc::wg::wg_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[h][j][e] += acc[h][j][e];
    __syncthreads();
  }
  store_tile<WGS, BN>(g, sum, smem, m0, n0, partial);
}

// out[i] = the S partials of element i summed in chunk order, 4 elements a
// thread (count is a multiple of 4).
__global__ void split_sum_kernel(const float* __restrict__ partial, int splits, long long count,
                                 float* __restrict__ out) {
  for (long long i = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x); i < count;
       i += 4LL * gridDim.x * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(partial + i);
    for (int z = 1; z < splits; ++z) {
      const float4 p = *reinterpret_cast<const float4*>(partial + z * count + i);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    *reinterpret_cast<float4*>(out + i) = s;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// cuTensorMapEncodeTiled, the CUDA tensor-map encoder, fetched through the
// runtime once, so that the library links only the CUDA runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The tensor map of one operand of `g` (A when `a`, else B) for a block of
// `rows` rows: the operand as a 2-D tensor (its unit-stride dimension
// innermost), boxes of 64 unit-stride elements (128 bytes, the swizzle's
// span) by `rows` (K-major: rows of M or N) or by 64 (MN-major: rows of k),
// the 128-byte swizzle, zeros past the edges.
template <typename O>
int encode_operand(CUtensorMap* map, const GemmArgs<bf16, O>& g, bool a, int trans, int rows) {
  const bf16* base = a ? g.A : g.B;
  const long long extent = a ? g.M : g.N;                 // rows of M (A) or N (B)
  const long long s_row = a ? g.sam : g.sbn, s_k = a ? g.sak : g.sbk;
  const cuuint64_t dims[2] = {(cuuint64_t)(trans ? extent : g.K),
                              (cuuint64_t)(trans ? g.K : extent)};
  const cuuint64_t stride[1] = {(cuuint64_t)(trans ? s_k : s_row) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)(trans ? 64 : rows)};
  const cuuint32_t unit[2] = {1, 1};
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)base, dims, stride, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : ERR_TENSOR_MAP;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 0 / 1: A's (or B's) k / rows are unit-stride; -1: neither, in a way the
// tensor-core loads take (rows of 16 bytes: `vec` elements).  `rows` is M
// for A, N for B.
inline int operand_layout(long long s_row, long long s_k, int rows, int K, int vec) {
  if (s_k == 1 && s_row % vec == 0 && K % vec == 0) return 0;
  if (s_row == 1 && s_k % vec == 0 && rows % vec == 0) return 1;
  return -1;
}

// The layout (TA, TB) as 2 TA + TB a call takes to the tensor cores (bf16
// in one pass, float32 in three TF32 passes): NT 0, NN 1, TN 3; or -1 for
// gemm.cuh's kernel: an operand without 16-byte rows (8 bf16 or 4 float32
// elements, unit-stride along k or along its rows), N not a multiple of 8
// (bf16) or 4 (float32), a pointer off a 16-byte boundary, or the layout TA
// 1, TB 0, which no caller has.
template <typename T, typename O>
int tc_layout(const GemmArgs<T, O>& g) {
  const int vec = 16 / (int)sizeof(T);
  if (g.M < 1 || g.N < 1 || g.K < 1 || g.N % vec != 0 || !aligned16(g.A) || !aligned16(g.B) ||
      !aligned16(g.out) || !aligned16(g.res) || !aligned16(g.mul) || !aligned16(g.out_t))
    return -1;
  const int ta = operand_layout(g.sam, g.sak, g.M, g.K, vec);
  const int tb = operand_layout(g.sbn, g.sbk, g.N, g.K, vec);
  if (ta < 0 || tb < 0 || (ta == 1 && tb == 0)) return -1;
  return 2 * ta + tb;
}

// The block shape of an unsplit call: 128 x 128 when that grid has a block
// for every SM, else 64 x 64.  Built with -DGTC_TILE=1 or 2, every unsplit
// call takes that shape (tools/check_torch_gemm.py --tiles builds such
// libraries apart to time the products on each).
inline int tile_for(int M, int N) {
#ifdef GTC_TILE
  return GTC_TILE;
#else
  return (long long)cdiv(M, 128) * cdiv(N, 128) >= SMS ? ROUTE_TC_128 : ROUTE_TC_64;
#endif
}

// Rows of k split into `splits` chunks of `chunk` (a multiple of BK), for
// 128 x 128 tiles: about SPLIT_BLOCKS blocks, each chunk at least
// MIN_SPLIT_STEPS k-steps of BK (`f32`: F32_MIN_SPLIT_STEPS), the last one
// shorter where the k-steps do not divide evenly.  No chunk is empty.
struct SplitPlan {
  int splits, chunk;
};
inline SplitPlan split_plan(int M, int N, int K, bool f32) {
  const int steps = cdiv(K, BK);
  const int want = std::max(1, std::min(cdiv(SPLIT_BLOCKS, (long long)cdiv(M, 128) * cdiv(N, 128)),
                                        steps / (f32 ? F32_MIN_SPLIT_STEPS : MIN_SPLIT_STEPS)));
  const int per = cdiv(steps, want);
  return {cdiv(steps, per), per * BK};
}

// Float32 elements of partial buffer a split call of this shape takes (0
// when it would not split).
inline long long split_elems(int M, int N, int K, bool f32) {
  const SplitPlan p = split_plan(M, N, K, f32);
  return p.splits > 1 ? (long long)p.splits * M * N : 0;
}

template <int WGS, int BN, int TA, int TB, typename O>
int launch_tile(const GemmArgs<bf16, O>& g, const SplitPlan& p, float* partial,
                cudaStream_t s) {
  constexpr int bytes = SMEM_BYTES<WGS, BN>;
  static bool opted[MAX_DEVICES] = {};
  int dev = 0;
  T1D_CHECK((int)cudaGetDevice(&dev));
  if (dev < 0 || dev >= MAX_DEVICES) return -1;
  if (!opted[dev]) {
    T1D_CHECK((int)cudaFuncSetAttribute(gemm_tc_kernel<WGS, BN, TA, TB, O>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    opted[dev] = true;
  }
  CUtensorMap ta, tb;
  T1D_CHECK(encode_operand(&ta, g, true, TA, WGS * 64));
  T1D_CHECK(encode_operand(&tb, g, false, TB, BN));
  const dim3 grid(cdiv(g.N, BN), cdiv(g.M, WGS * 64), p.splits);
  gemm_tc_kernel<WGS, BN, TA, TB, O><<<grid, WGS * 128, bytes, s>>>(ta, tb, g, p.chunk, partial);
  return (int)cudaGetLastError();
}

template <int WGS, int BN, int TA, int TB, typename O>
int launch_tile(const GemmArgs<float, O>& g, const SplitPlan& p, float* partial,
                cudaStream_t s) {
  constexpr int bytes = SMEM_BYTES_F32<WGS, BN>;
  static bool opted[MAX_DEVICES] = {};
  int dev = 0;
  T1D_CHECK((int)cudaGetDevice(&dev));
  if (dev < 0 || dev >= MAX_DEVICES) return -1;
  if (!opted[dev]) {
    T1D_CHECK((int)cudaFuncSetAttribute(gemm_tf32x3_kernel<WGS, BN, TA, TB, O>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    opted[dev] = true;
  }
  const dim3 grid(cdiv(g.N, BN), cdiv(g.M, WGS * 64), p.splits);
  gemm_tf32x3_kernel<WGS, BN, TA, TB, O><<<grid, WGS * 128, bytes, s>>>(g, p.chunk, partial);
  return (int)cudaGetLastError();
}

template <int TA, int TB, typename T, typename O>
int launch_layout(const GemmArgs<T, O>& g, int route, const SplitPlan& p, float* partial,
                  cudaStream_t s) {
  if (route == ROUTE_TC_128) return launch_tile<2, 128, TA, TB, O>(g, p, partial, s);
  return launch_tile<1, 64, TA, TB, O>(g, p, partial, s);
}

}  // namespace gtc

// out = epilogue(A B) on the tensor cores where `tc_layout` takes the call
// (bf16 in one pass, float32 in three TF32 passes), else by gemm.cuh's
// kernel.  With `partial` (room for gtc::split_elems(M, N, K, T is float)
// floats) a plain float32 sum into `out` on the tensor cores is split over
// the rows of k as gtc::split_plan says and summed by a second pass.
// `route` and `splits`, if given, get the kernel taken (gtc::Route) and the
// chunks it ran.
template <typename T, typename O>
int launch_gemm_tc(const GemmArgs<T, O>& g, cudaStream_t s, float* partial = nullptr,
                   int* route = nullptr, int* splits = nullptr) {
  if (route != nullptr) *route = gtc::ROUTE_CUDA_CORES;
  if (splits != nullptr) *splits = 1;
  const int layout = gtc::tc_layout(g);
  if (layout < 0) return launch_gemm(g, s);
  gtc::SplitPlan p = {1, g.K};
  if (partial != nullptr && std::is_same<O, float>::value && g.epi == EPI_NONE &&
      g.out_t == nullptr)
    p = gtc::split_plan(g.M, g.N, g.K, std::is_same<T, float>::value);
  const bool split = p.splits > 1;
  if (!split) p = {1, g.K};
  const int tile = split ? gtc::ROUTE_TC_128 : gtc::tile_for(g.M, g.N);
  if (route != nullptr) *route = tile;
  if (splits != nullptr) *splits = p.splits;
  float* part = split ? partial : nullptr;
  int err = -1;
  if (layout == 0) err = gtc::launch_layout<0, 0>(g, tile, p, part, s);
  if (layout == 1) err = gtc::launch_layout<0, 1>(g, tile, p, part, s);
  if (layout == 3) err = gtc::launch_layout<1, 1>(g, tile, p, part, s);
  if (err != 0) return err;
  ++gtc::g_tc_launches;
  if (split) {
    if constexpr (std::is_same<O, float>::value) {
      const long long count = (long long)g.M * g.N;
      const long long blocks = std::min<long long>((count / 4 + 255) / 256, 4 * gtc::SMS);
      gtc::split_sum_kernel<<<(int)blocks, 256, 0, s>>>(partial, p.splits, count, g.out);
      return (int)cudaGetLastError();
    }
  }
  return 0;
}

}  // namespace
