// PTX wrappers for Hopper (sm_90a): cp.async, wgmma and the swizzled
// shared-memory tiles that wgmma's descriptors read, mma.sync and
// ldmatrix. Used by flash_attention.cu's bf16 kernels, paged_decode.cu
// (cp.async) and fused_rnn.cu's recurrent sweeps and dW GEMM.
//
// Tile layout. A tile of R rows x D bf16 columns (row-major in device
// memory, D = 32, 64, 128 or 256) is held in shared memory as D / 64
// sub-tiles of 64 columns (one of 32 columns when D = 32). A sub-tile
// row is one swizzle row of kSwB = 128 bytes (64 for D = 32), and the
// 16-byte chunk at byte offset o of a sub-tile sits at o ^ ((o >> 3) &
// mask): bits 7-9 of the offset (bits 7-8 for 64-byte rows) XORed into
// bits 4-6 (4-5), the 128B (64B) swizzle of wgmma and TMA. Sub-tiles
// start on 1024-byte boundaries. The same bytes serve both operand forms:
//   * K-major (the product reduces over D, rows are M or N): a k-step of
//     16 columns starts 32 bytes further along the row, or in the next
//     sub-tile; 8-row groups lie SBO = 8 * kSwB bytes apart;
//   * MN-major (the product reduces over the rows, a sub-tile's columns
//     are N): a k-step of 16 rows starts 16 * kSwB bytes further on,
//     8-row groups again SBO apart, one sub-tile an instruction.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ cp.async
// 16 bytes device -> shared, asynchronous; the 16 bytes are zeros when
// !valid (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes device -> shared, asynchronous; zeros when !valid.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes device -> shared, asynchronous; zero when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma, which reads through the async proxy. Each writing
// thread fences before the CTA barrier that publishes its writes.
// mbarriers in shared memory (addresses as from smem_u32): init with an
// arrival count (then fence_mbarrier_init and a cluster barrier before a
// peer signals it), arrive with a number of transaction bytes to expect,
// and wait until the phase of the given parity has completed (acquire).
__device__ __forceinline__ void mbarrier_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint32_t bar,
                                                          uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The shared::cluster address, in CTA `rank` of the cluster, of this
// CTA's shared address `addr`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// A 4-byte store into a peer CTA's shared memory (shared::cluster
// addresses, from mapa) that completes 4 transaction bytes on the peer's
// mbarrier `bar` once the value is there.
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// A 16-byte store into a peer CTA's shared memory (16-byte aligned), as
// st_async: 16 transaction bytes on the peer's mbarrier `bar`.
__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// mbarrier_wait with acquire at cluster scope: for a phase completed by
// a peer CTA (its st.async bytes, or its remote arrive).
__device__ __forceinline__ void mbarrier_wait_cluster(uint32_t bar,
                                                      uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on a peer CTA's mbarrier (a shared::cluster address, from
// mapa), releasing this thread's earlier shared-memory accesses to the
// cluster.
__device__ __forceinline__ void mbarrier_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// The cluster barrier in two halves: every thread of every CTA of the
// cluster arrives (its earlier shared-memory writes released to the
// cluster), then waits for all of them (acquiring theirs). A thread
// arrives once before each wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// TMA: the box of a tensor map (built on the host with
// cuTensorMapEncodeTiled, passed as a __grid_constant__ parameter) at
// coordinates (c0, c1, c2), innermost first, into this CTA's shared
// memory at `dst`, completing its bytes on mbarrier `bar`. Elements
// outside the tensor land as zeros (and count as bytes).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_view_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------- tiles
template <int D>
struct Tile {
  static constexpr int kSwB = D >= 64 ? 128 : 64;     // bytes a row
  static constexpr int kSubCols = kSwB / 2;           // columns a sub-tile
  static constexpr int kSubs = D / kSubCols;          // sub-tiles
  static constexpr int kChunks = D / 8;               // 16 B chunks a row
  static constexpr int kSubChunks = kSwB / 16;
  static constexpr uint64_t kSwizzleMode = kSwB == 128 ? 1 : 2;  // B128/B64
  static constexpr uint32_t kMask = kSwB == 128 ? 0x70u : 0x30u;

  static constexpr __host__ __device__ uint32_t bytes(int rows) {
    return (uint32_t)rows * D * 2;
  }

  // byte offset, from the tile's start, of chunk c (8 columns) of row r
  // in a tile of `rows` rows
  static __device__ __forceinline__ uint32_t chunk(int rows, int r, int c) {
    const uint32_t o = (uint32_t)r * kSwB + (c % kSubChunks) * 16;
    return (uint32_t)(c / kSubChunks) * rows * kSwB + (o ^ ((o >> 3) & kMask));
  }
};

// Asynchronous copy of rows [row0, row0 + rows) of a (nrows, D) bf16
// matrix with row stride `ld` elements (a multiple of 8; D for a whole
// matrix, more for a column block of a wider one) into a tile at shared
// address `dst`, by threads tid of nthreads; rows past nrows become
// zeros. Thread tid copies chunks tid, tid + nthreads, ... —
// `for_own_chunks` visits the same ones.
template <int D>
__device__ __forceinline__ void load_tile_ld(uint32_t dst,
                                             const __nv_bfloat16* src,
                                             int ld, int row0, int rows,
                                             int nrows, int tid,
                                             int nthreads) {
  using L = Tile<D>;
  for (int i = tid; i < rows * L::kChunks; i += nthreads) {
    const int r = i / L::kChunks;
    const int c = i % L::kChunks;
    const bool valid = row0 + r < nrows;
    const __nv_bfloat16* g =
        src + (valid ? (size_t)(row0 + r) * ld + c * 8 : 0);
    cp_async16(dst + L::chunk(rows, r, c), g, valid);
  }
}

template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int nrows, int tid,
                                          int nthreads) {
  load_tile_ld<D>(dst, src, D, row0, rows, nrows, tid, nthreads);
}

// The chunks thread tid copied in load_tile, as generic pointers: after
// its cp_async_wait the thread may rewrite them before publishing.
template <int D, typename F>
__device__ __forceinline__ void for_own_chunks(uint8_t* tile, int rows,
                                               int tid, int nthreads, F f) {
  using L = Tile<D>;
  for (int i = tid; i < rows * L::kChunks; i += nthreads)
    f(reinterpret_cast<uint4*>(tile + L::chunk(rows, i / L::kChunks,
                                               i % L::kChunks)));
}

// ------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// k-step kk (16 columns) of a K-major operand: 64 rows from row `row` of
// a tile of `rows` rows at `base`
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int row,
                                           int kk) {
  using L = Tile<D>;
  constexpr int kSteps = L::kSwB / 32;                 // k-steps a row
  return desc(base + (uint32_t)(kk / kSteps) * rows * L::kSwB +
                  (uint32_t)row * L::kSwB + (kk % kSteps) * 32,
              16, 8 * L::kSwB, L::kSwizzleMode);
}

// k-step kk (16 rows) of an MN-major operand: sub-tile `sub` (its
// kSubCols columns are N) of a tile of `rows` rows at `base`
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int sub,
                                            int kk) {
  using L = Tile<D>;
  return desc(base + (uint32_t)sub * rows * L::kSwB +
                  (uint32_t)kk * 16 * L::kSwB,
              (uint32_t)rows * L::kSwB, 8 * L::kSwB, L::kSwizzleMode);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers in place around an asynchronous wgmma: the compiler may
// not move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SM90_ACC8(i)                                                  \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),     \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 fp32) = a . b^T (+ d when accumulate): a is 64 x 16 and b
// 64 x 16, both K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += a . b: a is 64 x 16 bf16 in registers (the
// accumulator layout's pairs, packed), b 16 x 64 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same with N = 32 (D = 32 tiles)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC8(0), SM90_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192 fp32) += a . b: a as in wgmma_rs, b 3 MN-major
// sub-tiles of 64 columns, the descriptor's leading byte offset apart
// (one instruction for a warpgroup's 3 sub-tiles of O)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
        SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56),
        SM90_ACC8(64), SM90_ACC8(72), SM90_ACC8(80), SM90_ACC8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 fp32) += a . b: a as in wgmma_rs, b 4 MN-major
// sub-tiles of 64 columns, the descriptor's leading byte offset apart
// (one instruction for a warpgroup's 4 sub-tiles of O)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
        SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56),
        SM90_ACC8(64), SM90_ACC8(72), SM90_ACC8(80), SM90_ACC8(88),
        SM90_ACC8(96), SM90_ACC8(104), SM90_ACC8(112), SM90_ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SM90_ACC8

// ---------------------------------------------------------- mma.sync
// d (16 x 8 fp32) += a (16 x 16 bf16, row-major) . b (16 x 8 bf16,
// column-major), one warp. With g = lane / 4 and q = lane % 4: a holds
// {a[g][2q, 2q+1], a[g+8][2q, 2q+1], a[g][2q+8, 2q+9], a[g+8][2q+8, 2q+9]},
// b {b[2q, 2q+1][g], b[2q+8, 2q+9][g]}, the lower column or row in the
// low half; d {d[g][2q], d[g][2q+1], d[g+8][2q], d[g+8][2q+1]}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8 (16 contiguous bytes), and r[i] receives
// {m_i[g][2q], m_i[g][2q+1]} (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8 (16 contiguous bytes), and
// r[i] receives {m_i[2q][g], m_i[2q+1][g]} (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two fp32 values rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace sm90
