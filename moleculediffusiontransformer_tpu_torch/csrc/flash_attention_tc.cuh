// Tensor-core pieces shared by the streaming-attention sources for bfloat16
// (flash_attention.cu: the forward, K5; flash_attention_bwd.cu: the
// backward, K6 and K7): the 128-byte swizzle of a bf16 tile in shared
// memory, the `cp.async` copies that fill it, `ldmatrix`, `mma.sync`,
// `ex2` and the packing of float32 accumulators into A-operand fragments,
// and (`tc::wg`) the matrix descriptors, fences and `wgmma` wrappers of the
// warpgroup products.
#pragma once

#include "flash_attention_tiles.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {
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

// ROWS rows of D bf16 at `src`, `ld` elements apart -> the swizzled tile
// `dst`, 16 bytes a thread, asynchronously.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int ld) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    cp_async16(dst + swz<D>(r, c), src + (long long)r * ld + c * 8);
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

// A warp's 16 x D accumulators -> rows g and g + 8 of `dst` (row stride
// ld), rounded to bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int lane,
                                           int ld) {
  const int g = lane >> 2, t = lane & 3;
  bf16* lo = dst + (long long)g * ld + 2 * t;
  bf16* hi = lo + 8LL * ld;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(lo + 8 * j) = pack2(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(hi + 8 * j) = pack2(acc[j][2], acc[j][3]);
  }
}

namespace wg {

constexpr int ALIGN = 1024;   // a 128-byte swizzle atom is 8 rows of 128 bytes

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

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((ALIGN - (smem_addr(raw) & (ALIGN - 1))) & (ALIGN - 1));
}

}  // namespace wg
}  // namespace tc
}  // namespace
