// Tensor-core pieces of the streaming-attention sources for bfloat16
// (flash_attention.cu: the forward, K5; flash_attention_bwd.cu: the
// backward, K6 and K7): the tile shapes a block owns and sweeps, the
// `cp.async` tile loads, the A-operand fragments of an owned tile, the
// `mma.sync` products of a sweep, `ex2`, and the packing of score
// accumulators into A-operand fragments.  The swizzle, copies, matrix
// instructions and `wgmma` wrappers themselves are tensor_core.cuh's,
// which the stack GEMM (gemm_tc.cuh) shares.
#pragma once

#include "flash_attention_tiles.cuh"
#include "tensor_core.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace tc {

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

}  // namespace tc
}  // namespace
