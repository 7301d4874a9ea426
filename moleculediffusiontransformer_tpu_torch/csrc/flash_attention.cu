// Streaming softmax attention for long sequences, the forward, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel _fwd_kernel of
// moleculediffusiontransformer_tpu/ops/flash_attention.py (:89):
//
//   fa_forward   o = softmax(q k^T * scale) v, and optionally
//                lse = m + log l per row
//
// (The backward, _dq_kernel and _dkv_kernel, is flash_attention_bwd.cu.)
//
// q, o are (b, h, n, d) and k, v (b, h, m, d), each with its own batch, head
// and row strides (`FwdLayout`): split heads are read and written in place
// in their (b, rows, h, d) buffers, and a contiguous (bh, rows, d) tensor is
// the case h = 1.  lse is (b h, n) float32, contiguous; d is 16, 32, 64 or
// 128.  What the TPU grid carried from step to step in VMEM scratch (acc, m,
// l) is a loop inside one block here: a block owns a tile of query rows and
// sweeps the KV tiles, and writes its output tile once.
//
// Bound: operations.  At n = m = 4096, d = 64 the forward is 4 n m d flops a
// (batch, head) against 4 n d elements moved, ~2,000 flops a byte in bf16.
// It also takes n m exponentials, which the SMs' special-function units do
// at 16 an SM a clock: at d 64 that is as long as the products take at the
// tensor cores' peak, so a kernel that runs softmax and products one after
// the other comes near neither.  Two designs, chosen by the input type in
// the entry point at the end of this file:
//
// * bfloat16 -> the tensor cores (`tc`).  q, k and v stay bf16 from device
//   memory to the matrix instruction; s = q k^T sums in float32; the running
//   max, the normaliser l and the rescale alpha are float32, and l sums the
//   float32 p; p is rounded to bf16 once, as the A operand of p v, which
//   sums in float32; o is rounded once, when it is written.  These are the
//   Pallas kernel's rounding points for bf16 inputs, whose dots run at
//   default precision, one bf16 pass of the matrix unit.  p never reaches
//   shared memory: the accumulator fragment of s is, pair of n8 tiles by
//   pair, the A-operand fragment of p v.  exp is `ex2.approx` with
//   log2(e) * scale folded into one multiply.  A block owns 128 query rows;
//   the KV tiles of 64 rows arrive by `cp.async` into a ring of swizzled
//   shared memory while the products of the previous tile run.  By head size:
//   - d 64 and 128 (`tc::wg`): `wgmma.mma_async.m64n64k16`, two warpgroups
//     a block, each owning 64 query rows and reading them as the A operand
//     of s = q k^T through a descriptor of its tile in shared memory, the K
//     tile through a K-major descriptor, the V tile of o += p v through an
//     MN-major (`tnspB`) one, 64 columns of o a product.  A three-stage ring,
//     and the loop skewed by one tile as the backward's is: s of tile j is
//     started together with p v of tile j - 1, so that the exponentials of
//     tile j run while the tensor cores finish tile j - 1.  alpha o, the one
//     write of an accumulator that is not a `wgmma`, comes after the wait
//     for tile j - 1's p v and before the next fence, and no product stays
//     in flight from one turn of the loop to the next (either would make
//     the compiler serialise every product): p is packed into one of two
//     sets of fragment registers, turn by turn.  At d 64 two blocks share an
//     SM, so that one block's exponentials also run under the other's
//     products.
//   - d 16 and 32: `mma.sync.m16n8k16` with `ldmatrix`, 8 warps of 16 rows,
//     a two-stage ring.
// * float32 -> the CUDA cores, from float32 tiles in shared memory
//   (flash_attention_tiles.cuh), one block per 64 query rows.  TF32
//   tensor-core products would leave the 1e-4 band in which the float32
//   path is held against the CPU.
#include "flash_attention_tc.cuh"

namespace {

// The strided layouts of the forward's tensors (flash_attention_tiles.cuh,
// `Rows`) and the heads a batch entry holds.
struct FwdLayout {
  Rows q, k, v, o;
  int heads;
};

constexpr float LN2 = 0.6931471805599453f;

// ================================================================ float32

template <int D>
constexpr int fwd_smem_floats() { return TILE * D + D * LDT + TILE * D + TILE * TILE; }

template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, FwdLayout L, int n, int m,
           float scale) {
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
  const float* kbase = k + L.k.at(bh, L.heads);
  const float* vbase = v + L.v.at(bh, L.heads);

  load_rows<D>(Qs, q + L.q.at(bh, L.heads, row0), L.q.row);

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
    load_rows_transposed<D>(Kt, kbase + (long long)col0 * L.k.row, L.k.row);
    load_rows<D>(Vs, vbase + (long long)col0 * L.v.row, L.v.row);
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
  store_tile<CO>(o + L.o.at(bh, L.heads, row0), L.o.row, acc, ty, tx);
}

template <int D>
int forward(const float* q, const float* k, const float* v, float* o, float* lse,
            const FwdLayout& L, long long bh, int n, int m, float scale, cudaStream_t s) {
  constexpr int bytes = fwd_smem_floats<D>() * (int)sizeof(float);
  if (int err = opt_in(fwd_kernel<D>, bytes)) return err;
  fwd_kernel<D><<<(unsigned)(bh * (n / TILE)), THREADS, bytes, s>>>(q, k, v, o, lse, L, n, m,
                                                                     scale);
  return (int)cudaGetLastError();
}

// =============================================================== bfloat16

namespace tc {

// One tile's online softmax for this thread's two rows (g and g + 8 of its
// warp's 16), from NT n8 tiles of raw scores in the accumulator layout:
// the new running max `mx` (of s * scale2, in log2 units), `alpha`, the
// factor of the old o and l, p = exp2(s * scale2 - mx) packed as the bf16 A
// fragments `pa` of p v, and l = alpha l + this thread's part of the row
// sum of the float32 p (the four threads of a row add their parts once, at
// the end).  The row max is taken over the raw scores: scale2 >= 0 (a
// negative scale is carried by q, `negate_rows`).
template <int NT>
__device__ __forceinline__ void online_softmax(const float (&s)[NT][4], float scale2,
                                               float (&mx)[2], float (&l)[2], float (&alpha)[2],
                                               uint32_t (&pa)[NT / 2][4]) {
  float cur[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jt = 0; jt < NT; ++jt) {
    cur[0] = fmaxf(cur[0], fmaxf(s[jt][0], s[jt][1]));
    cur[1] = fmaxf(cur[1], fmaxf(s[jt][2], s[jt][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cur[r] = fmaxf(cur[r], __shfl_xor_sync(0xffffffffu, cur[r], 1));
    cur[r] = fmaxf(cur[r], __shfl_xor_sync(0xffffffffu, cur[r], 2));
    const float m_new = fmaxf(mx[r], cur[r] * scale2);
    alpha[r] = ex2(mx[r] - m_new);   // the first tile: exp2(-inf) = 0
    mx[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jt = 2 * ks + half;
      const float p0 = ex2(fmaf(s[jt][0], scale2, -mx[0]));
      const float p1 = ex2(fmaf(s[jt][1], scale2, -mx[0]));
      const float p2 = ex2(fmaf(s[jt][2], scale2, -mx[1]));
      const float p3 = ex2(fmaf(s[jt][3], scale2, -mx[1]));
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[ks][2 * half] = pack2(p0, p1);
      pa[ks][2 * half + 1] = pack2(p2, p3);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
}

// A negative scale: s * scale = (-q) k^T * |scale|, and negating bf16 is
// exact, so the block negates its ELEMS elements of q in shared memory once
// and sweeps with |scale|; the row max of the raw scores then stays the max
// of the scaled ones.
template <int ELEMS>
__device__ __forceinline__ void negate_rows(bf16* tile) {
  uint4* words = reinterpret_cast<uint4*>(tile);
  for (int i = threadIdx.x; i < ELEMS / 8; i += NTHREADS) {
    uint4 w = words[i];
    w.x ^= 0x80008000u;
    w.y ^= 0x80008000u;
    w.z ^= 0x80008000u;
    w.w ^= 0x80008000u;
    words[i] = w;
  }
}

// The end of a sweep for this thread's two rows: the row sums of l, 1 / l
// into `inv`, and lse (natural log) for rows r_lo and r_lo + 8 of `lse`
// when it is not null (by one thread of the four that share a row).
__device__ __forceinline__ void finish_rows(float (&l)[2], const float (&mx)[2], float (&inv)[2],
                                            float* lse, long long r_lo, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  if (lse != nullptr && (lane & 3) == 0) {
    lse[r_lo] = (mx[0] + log2f(l[0])) * LN2;
    lse[r_lo + 8] = (mx[1] + log2f(l[1])) * LN2;
  }
}

// ------------------------------------------------- d 16, 32: `mma.sync`

template <int D>
constexpr int fwd_smem_bytes() {
  return (OWN * D + 4 * SWEEP<D> * D) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ o, float* __restrict__ lse, FwdLayout L, int n, int m,
           float scale) {
  constexpr int BN = SWEEP<D>, NT = BN / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // (OWN, D)
  bf16* Ks = Qs + OWN * D;                        // 2 stages of (BN, D)
  bf16* Vs = Ks + 2 * BN * D;                     // 2 stages of (BN, D)

  const int q_tiles = n / OWN;
  const long long bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * OWN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kbase = k + L.k.at(bh, L.heads);
  const bf16* vbase = v + L.v.at(bh, L.heads);

  load_tile_async<D, OWN>(Qs, q + L.q.at(bh, L.heads, row0), L.q.row);
  cp_async_commit();
  load_tile_async<D, BN>(Ks, kbase, L.k.row);
  load_tile_async<D, BN>(Vs, vbase, L.v.row);
  cp_async_commit();

  const float scale2 = fabsf(scale) * LOG2E;
  cp_async_wait<1>();
  __syncthreads();
  if (scale < 0.f) {
    negate_rows<OWN * D>(Qs);
    __syncthreads();
  }
  OwnedRows<D> qa;
  qa.init(Qs, warp * 16, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

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
    float s[NT][4], alpha[2];
    uint32_t pa[NT / 2][4];
    product_abt<D, NT>(s, qa, Ks + stage * BN * D, lane);
    online_softmax<NT>(s, scale2, mx, l, alpha, pa);
#pragma unroll
    for (int jt = 0; jt < D / 8; ++jt) {
      acc[jt][0] *= alpha[0];
      acc[jt][1] *= alpha[0];
      acc[jt][2] *= alpha[1];
      acc[jt][3] *= alpha[1];
    }
    product_ab<D, NT>(acc, pa, Vs + stage * BN * D, lane);
  }

  float inv[2];
  const int first = row0 + warp * 16;
  finish_rows(l, mx, inv, lse, bh * n + first + (lane >> 2), lane);
#pragma unroll
  for (int jt = 0; jt < D / 8; ++jt) {
    acc[jt][0] *= inv[0];
    acc[jt][1] *= inv[0];
    acc[jt][2] *= inv[1];
    acc[jt][3] *= inv[1];
  }
  store_rows<D>(o + L.o.at(bh, L.heads, first), acc, lane, L.o.row);
}

// ------------------------------------------------- d 64, 128: `wgmma`

namespace wg {

constexpr int ROWS = 64;     // query rows a warpgroup owns; KV rows of a swept tile
constexpr int STAGES = 3;
constexpr int ATOM = ROWS * 64;   // a (64, 64) block of 128-byte rows: 8 KB
// A (64, D) tile is D / 64 such column blocks, one after the other, each
// with the 128-byte swizzle (`swz<64>`) and on a 1024-byte boundary.
template <int D>
constexpr int TILE_ELEMS = ROWS * D;

static_assert(OWN == 2 * ROWS, "a block owns two warpgroups' rows");

// NROWS rows of D bf16 at `src`, `ld` elements apart -> NROWS / 64
// consecutive (64, D) tiles at `dst`, asynchronously.
template <int D, int NROWS>
__device__ __forceinline__ void load_tiles_async(bf16* dst, const bf16* src, int ld) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < NROWS * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    cp_async16(dst + (r / ROWS) * TILE_ELEMS<D> + (c >> 3) * ATOM + swz<64>(r % ROWS, c & 7),
               src + (long long)r * ld + c * 8);
  }
}

template <int D>
constexpr int FWD_SMEM_BYTES = (2 + 2 * STAGES) * TILE_ELEMS<D> * (int)sizeof(bf16) + ALIGN;

template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 2 : 1)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ o, float* __restrict__ lse, FwdLayout L, int n, int m,
           float scale) {
  constexpr int HALVES = D / 64, TE = TILE_ELEMS<D>;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(aligned_smem(smem_raw));   // 2 of (64, D), one a warpgroup
  bf16* Ks = Qs + 2 * TE;                                       // STAGES of (64, D)
  bf16* Vs = Ks + STAGES * TE;                                  // STAGES of (64, D)

  const int q_tiles = n / OWN;
  const long long bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * OWN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kbase = k + L.k.at(bh, L.heads);
  const bf16* vbase = v + L.v.at(bh, L.heads);
  const int tiles = m / ROWS;

  load_tiles_async<D, OWN>(Qs, q + L.q.at(bh, L.heads, row0), L.q.row);
  load_tiles_async<D, ROWS>(Ks, kbase, L.k.row);
  load_tiles_async<D, ROWS>(Vs, vbase, L.v.row);
  cp_async_commit();
  if (tiles > 1) {
    load_tiles_async<D, ROWS>(Ks + TE, kbase + (long long)ROWS * L.k.row, L.k.row);
    load_tiles_async<D, ROWS>(Vs + TE, vbase + (long long)ROWS * L.v.row, L.v.row);
  }
  cp_async_commit();

  const float scale2 = fabsf(scale) * LOG2E;
  const bf16* Qw = Qs + (warp >> 2) * TE;   // this warpgroup's 64 rows
  cp_async_wait<1>();
  if (scale < 0.f) {
    __syncthreads();
    negate_rows<2 * TE>(Qs);
  }
  fence_async_proxy();
  __syncthreads();

  float s[8][4], acc[HALVES][8][4], mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p_even[ROWS / 16][4], p_odd[ROWS / 16][4];

  // s = q k^T against the K tile in `stage`; the first k16 step starts the
  // sum (`scale-d` 0): nothing but `wgmma` writes s.
  auto scores = [&](int stage) {
    const bf16* Kt = Ks + stage * TE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(s, desc_cols(tile_desc(Qw + (kk >> 2) * ATOM), kk & 3),
                  desc_cols(tile_desc(Kt + (kk >> 2) * ATOM), kk & 3), kk > 0);
  };
  // o (+)= p v against the V tile in `stage`, 64 columns of o a product;
  // the first tile of the sweep starts the sum.
  auto accumulate = [&](const uint32_t (&pa)[ROWS / 16][4], int stage, bool first) {
    const bf16* Vt = Vs + stage * TE;
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int ks = 0; ks < ROWS / 16; ++ks)
        wgmma<1>(acc[h], pa[ks], desc_rows(tile_desc(Vt + h * ATOM), ks), ks > 0 || !first);
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
      load_tiles_async<D, ROWS>(Ks + into * TE, kbase + (long long)next * L.k.row, L.k.row);
      load_tiles_async<D, ROWS>(Vs + into * TE, vbase + (long long)next * L.v.row, L.v.row);
    }
    cp_async_commit();
  };
  // Tile j >= 1: its s, then o += p v of tile j - 1 (`done`); the softmax
  // of tile j is computed into `mine` while that product runs, and o takes
  // tile j's alpha once it is done.
  auto tile_step = [&](int j, uint32_t (&mine)[ROWS / 16][4],
                       const uint32_t (&done)[ROWS / 16][4]) {
    wg_fence();
    scores(j % STAGES);
    wg_commit();
    accumulate(done, (j - 1) % STAGES, j == 1);
    wg_commit();
    wg_wait<1>();
    online_softmax<8>(s, scale2, mx, l, alpha, mine);
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        acc[h][jt][0] *= alpha[0];
        acc[h][jt][1] *= alpha[0];
        acc[h][jt][2] *= alpha[1];
        acc[h][jt][3] *= alpha[1];
      }
    advance_ring(j);
  };

  wg_fence();
  scores(0);
  wg_commit();
  wg_wait<0>();
  online_softmax<8>(s, scale2, mx, l, alpha, p_even);
  advance_ring(0);
  int j = 1;
  for (; j + 1 < tiles; j += 2) {
    tile_step(j, p_odd, p_even);
    tile_step(j + 1, p_even, p_odd);
  }
  if (j < tiles) {   // an even count of tiles: the last one's p is odd
    tile_step(j, p_odd, p_even);
    wg_fence();
    accumulate(p_odd, j % STAGES, false);
  } else {
    wg_fence();
    accumulate(p_even, (tiles - 1) % STAGES, tiles == 1);
  }
  wg_commit();
  wg_wait<0>();

  float inv[2];
  const int first = row0 + warp * 16;
  finish_rows(l, mx, inv, lse, bh * n + first + (lane >> 2), lane);
  bf16* orow = o + L.o.at(bh, L.heads, first);
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      acc[h][jt][0] *= inv[0];
      acc[h][jt][1] *= inv[0];
      acc[h][jt][2] *= inv[1];
      acc[h][jt][3] *= inv[1];
    }
    store_rows<64>(orow + h * 64, acc[h], lane, L.o.row);
  }
}

}  // namespace wg

template <int D>
int forward(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, const FwdLayout& L,
            long long bh, int n, int m, float scale, cudaStream_t s) {
  const unsigned blocks = (unsigned)(bh * (n / OWN));
  if constexpr (D >= 64) {
    constexpr int bytes = wg::FWD_SMEM_BYTES<D>;
    if (int err = opt_in(wg::fwd_kernel<D>, bytes)) return err;
    wg::fwd_kernel<D><<<blocks, NTHREADS, bytes, s>>>(q, k, v, o, lse, L, n, m, scale);
  } else {
    constexpr int bytes = fwd_smem_bytes<D>();
    if (int err = opt_in(fwd_kernel<D>, bytes)) return err;
    fwd_kernel<D><<<blocks, NTHREADS, bytes, s>>>(q, k, v, o, lse, L, n, m, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// o (and lse unless it is null) from q, k, v for b x h (batch, head) pairs;
// `strides` holds the (batch, head, row) strides of q, k, v and o, in
// elements.  dtype 0, float32: the CUDA-core kernel, n and m multiples of 64;
// dtype 1, bfloat16: the tensor-core kernels, n a multiple of 128 (a block's
// rows), m of 64 (a swept tile).  Every pointer on a 16-byte boundary,
// every stride a multiple of 16 bytes, every row stride below 2^31 elements.
int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse,
               const long long* strides, long long b, int h, int n, int m, int d, float scale,
               int dtype, int device, void* stream) {
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (!elem || !strides || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(o) ||
      (lse != nullptr && misaligned(lse)) || bad_strides(strides, 12, elem))
    return ERR_ARGS;
  if (dtype == 0 ? bad_shape(b * h, h, n, m, TILE, TILE)
                 : bad_shape(b * h, h, n, m, tc::OWN, tc::wg::ROWS))
    return ERR_ARGS;
  if (int err = (int)cudaSetDevice(device)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const FwdLayout L{rows_of(strides, 0), rows_of(strides, 1), rows_of(strides, 2),
                    rows_of(strides, 3), h};
  float* l = (float*)lse;
  if (dtype == 0)
    FA_HEAD_DISPATCH(forward, d, (const float*)q, (const float*)k, (const float*)v, (float*)o, l,
                     L, b * h, n, m, scale, s);
  FA_HEAD_DISPATCH(tc::forward, d, (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v,
                   (tc::bf16*)o, l, L, b * h, n, m, scale, s);
  return ERR_ARGS;
}

const char* fa_error_string(int err) {
  return err < 0 ? "invalid arguments" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
