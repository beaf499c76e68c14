// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu, flash_decode.cu,
// flash_attention_tf32.cu, flash_attention_bwd_tf32_sm90.cu, moe_gemm.cu,
// moe_gemm_bwd.cu, mamba_scan.cu, mamba_scan_bwd.cu,
// mamba_scan_bwd_sm90.cu):
// mbarriers, named barriers, TMA tile loads (multicast to a cluster too)
// and the host-side tensor maps that describe them (bf16 and float32),
// cluster barriers and remote arrivals, `cp.async` copies, warp-level
// `ldmatrix` / `mma.sync` (bf16 and TF32), warpgroup-level `wgmma`
// (shared-memory descriptors, fences, m64nNk16 bf16 and m64nNk8 TF32
// products), a block-wide inclusive scan (the grouped GEMMs' prologues),
// the 3xTF32 split of a float32 value, and the exponential in base 2.
//
// The tensor maps are encoded with `cuTensorMapEncodeTiled`, looked up
// through the runtime (`cudaGetDriverEntryPoint`), so the library links
// against the runtime alone (no -lcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barrier `id` (1-15; 0 is __syncthreads) of `threads` threads, a
// multiple of 32, every thread of each warp taking part: `bar_sync` arrives
// and waits until all have arrived, `bar_arrive` arrives without waiting
// (a producer's signal to threads that `bar_sync` on the same barrier).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's earlier shared-memory accesses (generic proxy)
// before later accesses by the async proxy (TMA), once a barrier has
// passed them on to the thread that issues the copy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA ------------------------------------------------------------------
// Load the box at coordinates (c0, c1) of a 2-D tensor map into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same for a 3-D tensor map, at (c0, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Load the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `tma_load_2d`, written into the shared memory of every block of the
// cluster in `mask` (bit r: the block of rank r), at this block's offsets
// of `dst` and `bar`; each block's barrier counts the bytes it receives.
__device__ __forceinline__ void tma_load_2d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "h"(mask)
      : "memory");
}

// The byte offset of 16-byte chunk `chunk` of row `row` in a tile whose
// rows are `RowBytes` (64 or 128) long and swizzled as TMA's
// CU_TENSOR_MAP_SWIZZLE_{64,128}B writes them: the chunk index is XORed
// with address bits 7-9 (128 B) or 7-8 (64 B) of the row's start.
template <int RowBytes>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  static_assert(RowBytes == 64 || RowBytes == 128, "64 or 128 B rows");
  const int x = RowBytes == 128 ? (row & 7) : ((row >> 1) & 3);
  return row * RowBytes + ((chunk ^ x) << 4);
}

// ---- thread block clusters ------------------------------------------------
// Every thread of every block of the cluster arrives, then waits for all.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// One arrival on the barrier at `bar`'s offset in the shared memory of the
// cluster's block of rank `cta` (this block's own too).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::
          "r"(smem_addr(bar)),
      "r"(cta)
      : "memory");
}

// ---- cp.async ------------------------------------------------------------
// Copy `bytes` (0-16) of the 16-byte chunk at `src` to `dst` and fill the
// rest of the 16 bytes with zeros; both addresses 16-byte aligned. With
// bytes == 0 nothing is read (`src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// The same for one 4-byte word (bytes 0 or 4), 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `N` of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- warp-level tensor-core operations ------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a · b for one m16n8k16 tile: bf16 a (row-major) and b (column-
// major) fragments, float32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b for one m16n8k8 tile of TF32 operands (a row-major, b column-
// major; each a 32-bit register whose low 13 bits are zero), float32 d.
// Fragments (g = lane / 4, t = lane % 4): a = {(g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)}, b = {(t, g), (t + 4, g)}, d = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- warpgroup-level tensor-core operations (wgmma) -----------------------
// A shared-memory matrix descriptor for `wgmma`: start address, leading
// and stride byte offsets (16-byte units), swizzle layout (1 = 128 B,
// 2 = 64 B). For a K-major operand of 128-byte swizzled rows the stride
// offset is 8 rows (1024 B) and the start moves 32 B a k16 step; for an
// MN-major one (read with the transpose bit) the leading offset is the
// distance between 64-wide column blocks and the start moves 16 rows a
// k16 step.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo,
                                               uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most `N` of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Pins registers that an asynchronous wgmma writes or reads: no use is
// moved across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma m64nNk16, f32 += bf16 · bf16 (d = a · b where `accumulate` is 0).
// d: the warpgroup's 64 x N sums, N / 2 a thread: d[4j + e] at row 16·warp
// + lane / 4 + 8·(e / 2), column 8j + 2·(lane % 4) + e % 2.
// ss: A and B by descriptor, both K-major; ss_tb: A K-major, B MN-major
// (the transpose bit); ss_tt: both MN-major; rs: A from registers, B
// MN-major.
#define SM90_D32                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define SM90_D64                                                            \
  SM90_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),             \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_R16                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define SM90_R32                                                            \
  SM90_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
           "%28, %29, %30, %31"
#define SM90_R64                                                            \
  SM90_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
           "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
           "%56, %57, %58, %59, %60, %61, %62, %63"

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "n64 or n128");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

__device__ __forceinline__ void wgmma_ss_tb_n32(float (&d)[16], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" SM90_R16
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_tb_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_R32
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : SM90_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_tb_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_R64
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : SM90_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// A and B both MN-major (both transpose bits): A's M and B's N run along
// the shared-memory rows, the depth down them, as for dw = xᵀ · dy with x
// and dy stored row by row.
__device__ __forceinline__ void wgmma_ss_tt_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_R64
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : SM90_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "n32, n64 or n128");
  if constexpr (N == 32) wgmma_ss_tb_n32(d, da, db, accumulate);
  else if constexpr (N == 64) wgmma_ss_tb_n64(d, da, db, accumulate);
  else wgmma_ss_tb_n128(d, da, db, accumulate);
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" SM90_R16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// wgmma m64nNk8, f32 += tf32 · tf32, A from registers, B by descriptor
// (K-major: TF32 has no transpose bit). The tensor core reads each float32
// operand truncated to TF32 (its 13 low mantissa bits dropped) and
// truncates the sum it writes. A fragments, as `mma_tf32`'s a warp (g =
// lane / 4, t = lane % 4, rows 16·warp + ...): a = {(g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)}; d as the bf16 products'. The caller zeroes
// d before the first product (every product accumulates).
__device__ __forceinline__ void wgmma_rs_tf32_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" SM90_R16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" SM90_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SM90_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" SM90_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SM90_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "n32, n64 or n128");
  if constexpr (N == 32) wgmma_rs_tf32_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_tf32_n64(d, a, db);
  else wgmma_rs_tf32_n128(d, a, db);
}

#undef SM90_D32
#undef SM90_D64
#undef SM90_R16
#undef SM90_R32
#undef SM90_R64

// ---- block-wide scans -----------------------------------------------------
// Inclusive scan of one value per thread over the block: shuffles within
// each warp, then over the warps' totals. `total` gets the block's sum;
// `buf` holds 32 values, and the caller synchronizes before it is used
// again.
__device__ __forceinline__ long long block_inclusive_scan(
    long long v, long long* buf, long long& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  if (lane == 31) buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long u = lane < n_warps ? buf[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, u, off);
      if (lane >= off) u += up;
    }
    buf[lane] = u;
  }
  __syncthreads();
  total = buf[n_warps - 1];
  return warp > 0 ? v + buf[warp - 1] : v;
}

// ---- arithmetic -----------------------------------------------------------
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The pair (a, b) as bf16 `hi` and the bf16 rounding of what `hi` left out
// as `lo`: hi + lo carries 16 bits of each value's mantissa, so a product
// with p = hi + lo keeps p's float32 weights to ~2^-17 (one bf16 rounding
// of p alone errs by up to 2^-9).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A float32 value as TF32 `hi` and the rest `lo`: hi = a with its 13 low
// mantissa bits cleared (TF32 by truncation, what the tensor core would
// read from a alone), lo = a − hi, exact in float32, passed as it is and
// truncated to TF32 by the tensor core. hi + lo carries 21 bits of a's
// 24: a product hi·hi + hi·lo + lo·hi misses a·b by less than 3·2^-20 of
// |a·b| (one TF32 truncation of each operand misses by up to 2^-9). Two
// instructions, where a rounding to nearest (`cvt.rna`, which compiles to
// several) would cost about three times as many: the split, not the
// product, is what these kernels' inner loops issue most.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a · b in 3xTF32: the two small products first, then the large one,
// each an m16n8k8 product into the same float32 sums.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b_hi0, uint32_t b_hi1,
                                           uint32_t b_lo0, uint32_t b_lo1) {
  mma_tf32(d, a_lo, b_hi0, b_hi1);
  mma_tf32(d, a_hi, b_lo0, b_lo1);
  mma_tf32(d, a_hi, b_hi0, b_hi1);
}

// ---- host: tensor maps ----------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (or, with `f32`, float32) tensor of `rank` (2-4) dimensions as a
// tensor map: dims[0] is the dense innermost dimension, strides[i] the byte
// stride of dimension i + 1 (each a multiple of 16 bytes), read in boxes of
// box[0 .. rank) swizzled by box[0]'s bytes (64 or 128). Elements outside
// the tensor read as zero. Needs a 16-byte aligned base.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rank,
                            const uint64_t* dims, const uint64_t* strides,
                            const uint32_t* box, bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (rank < 2 || rank > 4) return cudaErrorInvalidValue;
  cuuint64_t d[4], st[3];
  cuuint32_t b[4];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) st[i] = strides[i];
  }
  const CUresult r = fn(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      rank, const_cast<void*>(base), d, st, b, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box[0] * (f32 ? 4 : 2) == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 (or float32) tensor of shape (n3, n2, n1, n0), contiguous, as a
// 4-D tensor map (n0, n1, n2, n3) read in boxes of (box0, box1, box2, 1).
inline cudaError_t make_map(CUtensorMap* map, const void* base, uint64_t n0,
                            uint64_t n1, uint64_t n2, uint64_t n3, int box0,
                            int box1, int box2, bool f32 = false) {
  const uint64_t e = f32 ? 4 : 2;
  const uint64_t dims[4] = {n0, n1, n2, n3};
  const uint64_t strides[3] = {n0 * e, n0 * n1 * e, n0 * n1 * n2 * e};
  const uint32_t box[4] = {static_cast<uint32_t>(box0),
                           static_cast<uint32_t>(box1),
                           static_cast<uint32_t>(box2), 1};
  return make_map(map, base, 4, dims, strides, box, f32);
}

}  // namespace sm90
