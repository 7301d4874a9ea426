// Tensor-core building blocks for bfloat16 on Hopper (sm_90a), shared by
// the streaming-attention kernels (flash_attention_tc.cuh) and the stack
// GEMM (gemm_tc.cuh): the 128-byte swizzle of a bf16 tile in shared memory,
// the `cp.async` copies and the TMA loads (with their mbarriers) that fill
// it, `ldmatrix`, `mma.sync` and the packing of float32 accumulators into
// bf16 operand registers, and (`tc::wg`) the matrix descriptors, fences and
// `wgmma` wrappers of the warpgroup products.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

// Element offset of the 16-byte chunk `chunk` of row `row` in a (rows, D)
// bf16 tile.  The chunk index is XORed with row bits so that the eight row
// addresses of an 8 x 8 `ldmatrix` (eight consecutive rows, one logical
// chunk) fall on eight different 16-byte bank groups, whatever D: rows of
// 128 bytes and more differ in row & 7; rows of 64 bytes share a 128-byte
// line in pairs, rows of 32 bytes in fours.  At D 64 this is the hardware's
// 128-byte swizzle, which `wgmma` descriptors name (mode 1).
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

// two float32 -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- mbarriers and TMA (the Tensor Memory Accelerator)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of transfers to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the barrier's phase of parity `parity` has completed.  A phase that
// never completes (bytes announced that no copy delivers) stops the kernel
// with a trap after some seconds instead of spinning for ever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}
// the box of the 2-D tensor map `map` at (c0 innermost, c1) -> dst, its
// bytes counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
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

// The same with a (64 x 16) read from shared memory through `adesc`:
// TRANS_A 0 reads it K-major (a[m][k] = tile[m][k]), 1 MN-major
// (a[m][k] = tile[k][m]); TRANS_B as above.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[8][4], uint64_t adesc, uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(adesc), "l"(desc), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// a K-major from shared memory (the streaming-attention kernels' use)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t adesc, uint64_t desc,
                                         int accumulate) {
  wgmma_ss_t<0, TRANS_B>(d, adesc, desc, accumulate);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((ALIGN - (smem_addr(raw) & (ALIGN - 1))) & (ALIGN - 1));
}

}  // namespace wg
}  // namespace tc
}  // namespace
