// Grouped (block-diagonal) GEMM for MoE experts for Hopper, sm_90a.
//
// Replaces the TPU kernel `grouped_gemm_padded` in
// src/repro/kernels/moe_gemm/kernel.py, which took rows already scattered
// into a padded layout (every block_m-row tile single-group, after a static
// worst-case pad of G * block_m rows built by kernels/moe_gemm/ops.py) and a
// scalar-prefetched tile->group map. Here no padded copy of x is made: a
// one-block prologue reads the group sizes on the device and writes the
// tile table itself, so nothing waits on the host.
//
// y[r] = x[r] @ w[g(r)] for the rows r of group g (rows sorted by group,
// group g owning the next group_sizes[g] rows); rows at or beyond the
// groups' sum are written as 0. Negative sizes count as 0, and rows past M
// are cut. float32 operands, float32 accumulation (`gg_tf32`); or bf16
// operands, float32 accumulation and bf16 output (`gg_sm90` or `gg_bf16`,
// below), as the Pallas kernel computes for bf16 operands. w may be a
// strided view (dense rows of N, any group and row stride), so a caller
// can pass slices of a wider weight row without copying them.
//
// What bounds it on this card: at decode sizes, memory. Each expert's
// weight block (K x N) is read once per row tile of that expert, and a
// decode step gives an expert a few dozen rows, so the weights dominate the
// bytes (a 1,024-row in-projection over 40 experts reads 252 MB of weights
// and 6 MB of activations). At prefill sizes (tens of thousands of rows)
// it is the arithmetic: 1.03e11 FLOP at M = 32,768, K = 1,536, N = 1,024.
//
// Design: the prologue (`gg_plan`, one block) takes an exclusive scan of
// the clamped group sizes and of ceil(size / BM), and writes one entry per
// row tile of BM rows: (group, first row, end row). The tiles of the zero
// tail follow with group -1, and the rest of the worst-case grid of
// ceil(M / BM) + G tiles with -2, whose blocks exit at once. The main
// kernel (`gg_tf32`) gives each block one BM x 128 output tile, the column
// tiles of a row tile next to each other in launch order (they share the x
// tile in L2). BM is 128, or 64 where the groups average fewer than 128
// rows (a decode step: ~26 an expert), so that a hot expert's rows spread
// over more blocks, and two blocks share an SM:
// - Products on the tensor cores in 3xTF32: each float32 operand is split
//   into TF32 hi (a truncated) and lo = a - hi (truncated to TF32 by the
//   tensor core; `sm90::split_tf32`), and hi·hi + hi·lo + lo·hi go into
//   float32 sums (`sm90::mma_3xtf32`). One TF32 rounding would miss the
//   float32 gate (chip_smoke.py's TF32 control); the split keeps 21 bits
//   of each operand, at 3 products for one: 165 TFLOP/s of float32 work
//   at the card's 495 TFLOP/s in TF32, against 67 in FMAs.
// - `mma.sync` m16n8k8, with fragments read by plain shared-memory loads
//   and split in registers. TF32 `wgmma` takes B K-major from shared
//   memory only, and w (K x N, N contiguous) is N-major: it would need a
//   transposing split pass through shared memory and twice the ring. With
//   `mma.sync` any layout works, no copy is made, and each thread splits
//   the values it loads.
// - The tiles of x and w pass through a ring of kStages shared-memory
//   stages by `cp.async`, with rows padded so the fragment loads hit 32
//   banks (x rows kBK + 8 floats, read as float2: the depth of each k8
//   step is permuted, slot t <-> 2t and t + 4 <-> 2t + 1, the same in a
//   and b, so a thread's two a values lie side by side; w rows kBN + 4).
//   The wrapper chooses 16-byte copies where x, w and their strides are
//   16-byte aligned, and 4-byte copies otherwise. Rows at or past the
//   tile's end row and columns past K or N are filled with zeros, not read.
// - 8 warps as 2 x 4, each a BM / 2 x 32 piece (at 128 rows 4 x 4 m16n8
//   tiles: per k8 step a warp loads 24 values, splits them, and issues 48
//   products). A warp skips the m16 row tiles past the tile's end row, so
//   a decode expert of 26 rows costs 2 m16 tiles' products. The number of
//   row tiles is a template argument of the stage's loop (one switch a
//   stage), so no branch sits between the products: with one there, ptxas
//   kept them in order and the loop ran at half the speed.
// - The tensor core truncates the float32 sum it writes (round toward
//   zero), so a sum carried through every product of K = 1,536 would
//   drift by up to 2^-23 of itself per product, 576 of them: several
//   times the parameter server's gate of 1e-5. Each stage's 12 products go
//   into sums of their own, which are added to the tile's sums in float32
//   (rounded to nearest) after the stage.
//
// bf16 operands, two kernels (granite-moe computes in bf16). Both read x
// and w as they are (no float32 copy of either), take every product of two
// bf16 values exactly in float32, sum in float32 and round y to bf16 once;
// both use the prologue, the tile table and the 64/128-row choice above.
// The wrapper picks by the operands alone (`ops.route`): `gg_sm90` where a
// TMA tensor map can describe them (x, w and w's strides 16-byte aligned,
// K > 0, K and N multiples of 8), else `gg_bf16`.
//
// `gg_sm90` (Hopper's own path; counter "moe_gemm_sm90"). At granite's
// prefill (a 262,144-row in-projection, K = 1,536, N = 1,024) the
// arithmetic bounds it: 8.2e11 FLOP, 0.83 ms at 989 TFLOP/s; at a decode
// step (64 rows over ~34 experts) the routed experts' weights, 0.032 ms of
// bytes. Design:
// - TMA tiles into a ring of 64-deep stages (6 of 32 KB at 128 rows, 8 of
//   24 KB at 64) with a full and an empty mbarrier a stage: x as a 2-D map
//   (K, M) in 128-byte swizzled rows, w as a 3-D map (N, K, G) with w's
//   own strides (a strided view is read in place) in boxes of 64 x 64.
//   Rows past M and columns past K or N read as zeros.
// - One producer warpgroup (one thread issues the loads; `setmaxnreg` 40)
//   and two consumer warpgroups (232 registers): `wgmma` m64nNk16, A (x)
//   K-major and B (w, N contiguous) MN-major through the transpose bit,
//   both from shared memory. A 128 x 128 tile gives each warpgroup 64 rows
//   (m64n128); a 64 x 128 tile (decode) 64 columns each (m64n64).
// - Stage sums: the tensor core truncates the float32 sum it writes, by
//   up to 2^-23 of it a k16 step, so a sum carried through all 96 k16
//   steps of K = 1,536 can miss gemm_check's 1e-5·Σ|x w| term (1.1e-5 on
//   adversarial same-sign operands, tests/test_torch_moe_gemm_sm90.py). A
//   sum stays on the tensor core for kSumDepth = 256 of k (its first
//   `wgmma` with the scale of d at 0) and is then added into the tile's
//   float32 sums, which keeps the emulated error under half that term.
//   The second set of sums is why the tile is 128 x 128 (128 accumulators
//   a consumer thread) and not 128 x 256. The warpgroups add half a sum
//   apart, so one keeps the tensor cores busy while the other adds.
// - Each stage is released once the next one's products are issued
//   (`wgmma.wait_group 1`); no branch reads or waits on the `wgmma`
//   registers (ptxas would serialize the products).
// - A persistent walk: about one block an SM walks the (row tile, column
//   tile) table with the column tiles of a row tile adjacent (they share
//   the x tile in L2) and row tiles in group order (an expert's weights
//   stay in L2); `gg_plan` writes the count of used tiles into entry 0, so
//   the walk skips the -2 tail without reading it, and zero-tail tiles
//   store zeros. The producer runs into the next tiles' loads while the
//   consumers finish a tile, and a tile's stores (through shared memory,
//   16 bytes a thread) run while the next tile's first sum is on the
//   tensor cores. Rows of a row tile that belong to the next group are
//   computed and not stored (no TMA store: a box cannot stop at the
//   group's end).
// - At 128-row tiles two blocks form a cluster over 256 columns and
//   share the x tile through TMA multicast (each loads half, both
//   receive it), which cuts a 128 x 128 tile's L2 traffic by a quarter.
//   gg_sm90_variants.py on an H100 80GB HBM3 at 700 W: granite's prefill
//   in-projection 1.46 ms with the pair, 1.59 without (the out-projection
//   the same either way). A 2 x 2 cluster, w shared too, was tried and
//   not kept: it was no faster.
// - The column tile is 128 at every shape. At granite's decode shapes 64,
//   128 and 256 columns (544, 272 and 136 tiles over 132 SMs) measured
//   within 7% of each other (the same script), in no order of whole
//   waves: where the weights' bytes bound, a short last wave costs little.
// - `gg_sm90` is launched as a programmatic dependent of `gg_plan`: its
//   blocks set up their barriers while the plan is written, then read the
//   plan through L2 after `griddepcontrol.wait`.
//
// `gg_bf16` (any layout; counter "moe_gemm_bf16"): `mma.sync` m16n8k16
// (bf16 in, float32 sums) over a `cp.async` ring of kStages stages of 64
// deep, A fragments by `ldmatrix` from the x tile and B fragments by
// `ldmatrix.trans` from the N-major w tile (rows padded by 16 bytes, so
// the eight rows of an 8x8 matrix hit distinct banks). 8 warps as 2 x 4 as
// above; a stage's 4 k16 products go into sums of their own, added to the
// tile's sums in float32 after the stage. 16-byte copies where x, w and
// their strides are 16-byte aligned, else one value a load (synchronous
// stores into the ring).
//
// The backward's dx = dy · w[g]ᵀ (the JAX package differentiates
// `lax.ragged_dot`; the port's `grouped_gemm` is a `torch.autograd.
// Function`) is the same grouped GEMM over the same row-sorted groups,
// prologue and tiles, with dy (M, N) for x and w read transposed in place
// (template flag kWT; entry points `tdorch_grouped_gemm_dx*`): `gg_tf32`
// copies w's rows of N into a w stage of output rows (padded as x's, so a
// thread's two depth values are one float2 load); `gg_bf16` stores them the
// same way and loads B fragments by a plain `ldmatrix`; `gg_sm90` takes
// its w boxes at (depth, row) of the forward's own (N, K, G) tensor map,
// so each output column is a 128-byte swizzled row, and reads B K-major
// (the transpose bit off), as x. Rows past the groups' sum are stored as
// zeros. dw = x_gᵀ · dy_g is csrc/moe_gemm_bwd.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kBN = 128;  // columns of a tile
constexpr int kBK = 32;   // depth of one ring stage
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kWN = 32;        // a warp's columns of the tile
constexpr int kLdA = kBK + 8;  // x rows in shared memory (floats)
constexpr int kLdB = kBN + 4;  // w rows in shared memory (floats)
constexpr int kPlanThreads = 1024;

static_assert(kBN == 4 * kWN, "8 warps as 2 x 4");
static_assert(kLdA % 32 == 8 && kLdB % 32 == 4, "conflict-free fragments");

// Two blocks share an SM where both fit its shared memory (an H100's 228
// KB, each block's 1 KB reserve and statics apart): `__launch_bounds__`
// asks for no more, so a block that stands alone keeps 255 registers.
constexpr int kSmemPerSM = 233472;
constexpr int blocks_per_sm(int smem) {
  return 2 * (smem + 1536) <= kSmemPerSM ? 2 : 1;
}

// A tile of BM rows (128, or 64 where groups are small): each warp takes
// BM / 2 rows. kWT (dx = dy · wᵀ): the w stage holds the tile's kBN output
// columns as rows of kBK depth values (w read transposed), padded as x's
// rows are.
template <int BM, bool kWT = false>
struct Tile {
  static constexpr int kWM = BM / 2;
  static constexpr int kStageFloats =
      BM * kLdA + (kWT ? kBN * kLdA : kBK * kLdB);
  // 149,504 bytes at 128 rows, 108,544 at 64 (kWT: 163,840 and 122,880);
  // two blocks an SM only at 64 rows without kWT
  static constexpr int kSmem = kStages * kStageFloats * 4;
  static constexpr int kBlocksPerSM = blocks_per_sm(kSmem);
  static_assert(BM == 64 || BM == 128, "tiles of 64 or 128 rows");
};

// plan[t] = (group, first row, end row, 0) for t in [0, num_tiles); group
// -1 marks a tile of the zero tail, -2 a tile with no rows. The -2 tiles
// come last, and entry 0's 4th field is the count of the others (what
// `gg_sm90`'s tile walk covers).
__global__ void gg_plan(const int* __restrict__ sizes, int G, int M,
                        int tile_rows, int num_tiles,
                        int4* __restrict__ plan) {
  // the kernel that reads the plan may start its prologue now (a
  // programmatic dependent launch; it waits for this grid's writes)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ long long buf[32];
  long long row_carry = 0, tile_carry = 0;  // the same in every thread
  for (int base = 0; base < G; base += kPlanThreads) {
    const int g = base + threadIdx.x;
    const long long s = g < G ? max(sizes[g], 0) : 0;
    long long rows_total, tiles_total;
    const long long rows_incl =
        row_carry + sm90::block_inclusive_scan(s, buf, rows_total);
    __syncthreads();
    const long long r0 = min(rows_incl - s, static_cast<long long>(M));
    const long long r1 = min(rows_incl, static_cast<long long>(M));
    const long long t = (r1 - r0 + tile_rows - 1) / tile_rows;
    const long long tiles_incl =
        tile_carry + sm90::block_inclusive_scan(t, buf, tiles_total);
    __syncthreads();
    for (long long j = 0; j < t; ++j) {
      const long long tile = tiles_incl - t + j;
      if (tile < num_tiles) {
        plan[tile] = make_int4(g, static_cast<int>(r0 + j * tile_rows),
                               static_cast<int>(min(r0 + (j + 1) * tile_rows, r1)),
                               0);
      }
    }
    row_carry += rows_total;
    tile_carry += tiles_total;
  }
  const long long z0 = min(row_carry, static_cast<long long>(M));
  const long long zero_tiles = (M - z0 + tile_rows - 1) / tile_rows;
  for (long long tile = tile_carry + threadIdx.x; tile < num_tiles;
       tile += blockDim.x) {
    const long long j = tile - tile_carry;
    plan[tile] = j < zero_tiles
        ? make_int4(-1, static_cast<int>(z0 + j * tile_rows),
                    static_cast<int>(min(z0 + (j + 1) * tile_rows,
                                         static_cast<long long>(M))), 0)
        : make_int4(-2, 0, 0, 0);
  }
  __syncthreads();  // every entry is written; entry 0 may be this block's
  if (threadIdx.x == 0)
    plan[0].w = static_cast<int>(
        min(tile_carry + zero_tiles, static_cast<long long>(num_tiles)));
}

// Copy stage `kt` (depth k0 = kt * kBK) of the x rows [row0, row_end) and
// of w[g]'s columns [n0, n0 + kBN) into shared memory. kVec = 4: 16-byte
// copies (x, w and their strides 16-byte aligned); kVec = 1: 4-byte ones.
// kWT: the operand's element (k, n) is w[g]'s (n, k), at wg + n·stride + k,
// and lands at bs[n][k] (rows of kLdA).
template <int BM, int kVec, bool kWT = false>
__device__ __forceinline__ void load_stage(
    float* as, float* bs, const float* __restrict__ x,
    const float* __restrict__ wg, long long w_row_stride, int row0,
    int row_end, int n0, int k0, int K, int N) {
  constexpr int kAChunks = BM * kBK / kVec / kThreads;
  constexpr int kBChunks = kBK * kBN / kVec / kThreads;
#pragma unroll
  for (int l = 0; l < kAChunks; ++l) {
    const int c = threadIdx.x + l * kThreads;
    const int r = c / (kBK / kVec), kk = (c % (kBK / kVec)) * kVec;
    const int row = row0 + r, k = k0 + kk;
    const int n_in = row < row_end ? max(0, min(kVec, K - k)) : 0;
    const float* src = n_in ? x + static_cast<long long>(row) * K + k : x;
    if constexpr (kVec == 4)
      sm90::cp_async16(as + r * kLdA + kk, src, 4 * n_in);
    else
      sm90::cp_async4(as + r * kLdA + kk, src, 4 * n_in);
  }
  if constexpr (kWT) {
#pragma unroll
    for (int l = 0; l < kBChunks; ++l) {
      const int c = threadIdx.x + l * kThreads;
      const int nn = c / (kBK / kVec), kk = (c % (kBK / kVec)) * kVec;
      const int k = k0 + kk, n = n0 + nn;
      const int n_in = n < N ? max(0, min(kVec, K - k)) : 0;
      const float* src = n_in ? wg + n * w_row_stride + k : wg;
      if constexpr (kVec == 4)
        sm90::cp_async16(bs + nn * kLdA + kk, src, 4 * n_in);
      else
        sm90::cp_async4(bs + nn * kLdA + kk, src, 4 * n_in);
    }
  } else {
#pragma unroll
    for (int l = 0; l < kBChunks; ++l) {
      const int c = threadIdx.x + l * kThreads;
      const int kk = c / (kBN / kVec), nn = (c % (kBN / kVec)) * kVec;
      const int k = k0 + kk, n = n0 + nn;
      const int n_in = k < K ? max(0, min(kVec, N - n)) : 0;
      const float* src = n_in ? wg + k * w_row_stride + n : wg;
      if constexpr (kVec == 4)
        sm90::cp_async16(bs + kk * kLdB + nn, src, 4 * n_in);
      else
        sm90::cp_async4(bs + kk * kLdB + nn, src, 4 * n_in);
    }
  }
}

// One ring stage's products for the warp's first MT m16 row tiles and
// its kWN columns (as / bs: the warp's rows of the x tile, its columns of
// the w tile), into stage sums that are then added to acc. kWT: a b pair
// (depth 2t, 2t + 1 of a column) sits side by side, read as a float2.
template <int WM, int MT, bool kWT>
__device__ __forceinline__ void stage_products(
    const float* as, const float* bs, float (&acc)[WM / 16][kWN / 8][4]) {
  const int gr = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  float part[MT][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* ap = as + (16 * i + gr) * kLdA + 8 * ks + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(ap);
      const float2 v = *reinterpret_cast<const float2*>(ap + 8 * kLdA);
      sm90::split_tf32(u.x, a_hi[i][0], a_lo[i][0]);
      sm90::split_tf32(v.x, a_hi[i][1], a_lo[i][1]);
      sm90::split_tf32(u.y, a_hi[i][2], a_lo[i][2]);
      sm90::split_tf32(v.y, a_hi[i][3], a_lo[i][3]);
    }
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
      if constexpr (kWT) {
        const float2 b = *reinterpret_cast<const float2*>(
            bs + (8 * j + gr) * kLdA + 8 * ks + 2 * t);
        sm90::split_tf32(b.x, b_hi0, b_lo0);
        sm90::split_tf32(b.y, b_hi1, b_lo1);
      } else {
        const float* bp = bs + (8 * ks + 2 * t) * kLdB + 8 * j + gr;
        sm90::split_tf32(bp[0], b_hi0, b_lo0);
        sm90::split_tf32(bp[kLdB], b_hi1, b_lo1);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
        sm90::mma_3xtf32(part[i][j], a_hi[i], a_lo[i], b_hi0, b_hi1, b_lo0,
                         b_lo1);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// stage_products for the warp's m_tiles row tiles (none for 0): one branch
// a stage, none between the products.
template <int WM, bool kWT, int MT = WM / 16>
__device__ __forceinline__ void stage_products_for(
    int m_tiles, const float* as, const float* bs,
    float (&acc)[WM / 16][kWN / 8][4]) {
  if (m_tiles == MT)
    stage_products<WM, MT, kWT>(as, bs, acc);
  else if constexpr (MT > 1)
    stage_products_for<WM, kWT, MT - 1>(m_tiles, as, bs, acc);
}

// One BM x kBN tile of y = x[rows] @ w[g] in 3xTF32 (kWT: of
// y = x[rows] @ w[g]ᵀ, w read transposed in place: dx = dy · wᵀ, K the
// depth N of w and N its rows K); block b is column tile b % n_col_tiles
// of row tile b / n_col_tiles.
template <int BM, int kVec, bool kWT>
__global__ void __launch_bounds__(kThreads, Tile<BM, kWT>::kBlocksPerSM)
gg_tf32(const float* __restrict__ x, const float* __restrict__ w,
        long long w_group_stride, long long w_row_stride,
        const int4* __restrict__ plan, int K, int N, int n_col_tiles,
        float* __restrict__ y) {
  const int4 p = plan[blockIdx.x / n_col_tiles];
  const int g = p.x, row0 = p.y, row_end = p.z;
  if (g == -2) return;
  const int n0 = (blockIdx.x % n_col_tiles) * kBN;
  if (g == -1) {
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int r = row0 + i / kBN, c = n0 + i % kBN;
      if (r < row_end && c < N) y[static_cast<long long>(r) * N + c] = 0.f;
    }
    return;
  }
  using C = Tile<BM, kWT>;
  constexpr int kWM = C::kWM, kStageFloats = C::kStageFloats;
  extern __shared__ __align__(16) float smem[];
  const float* wg = w + g * w_group_stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  // the warp's m16 row tiles that hold rows of the group
  const int m_tiles =
      min(kWM / 16, max(0, (row_end - row0 - wm * kWM + 15) / 16));
  float acc[kWM / 16][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      load_stage<BM, kVec, kWT>(smem + s * kStageFloats,
                           smem + s * kStageFloats + BM * kLdA, x, wg,
                           w_row_stride, row0, row_end, n0, s * kBK, K, N);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    sm90::cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread, and stage kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < n_k) {
      float* st = smem + (next % kStages) * kStageFloats;
      load_stage<BM, kVec, kWT>(st, st + BM * kLdA, x, wg, w_row_stride,
                                row0, row_end, n0, next * kBK, K, N);
    }
    sm90::cp_async_commit();
    const float* as = smem + (kt % kStages) * kStageFloats + wm * kWM * kLdA;
    const float* bs = smem + (kt % kStages) * kStageFloats + BM * kLdA +
                      wn * kWN * (kWT ? kLdA : 1);
    stage_products_for<kWM, kWT>(m_tiles, as, bs, acc);
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kWM / 16; ++i) {
    if (i >= m_tiles) continue;
    const int r = row0 + wm * kWM + 16 * i + gr;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int c = n0 + wn * kWN + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e / 2) * 8, cc = c + (e % 2);
        if (rr < row_end && cc < N)
          y[static_cast<long long>(rr) * N + cc] = acc[i][j][e];
      }
    }
  }
}

template <int BM, int kVec, bool kWT>
cudaError_t launch_tiles(const float* x, const float* w,
                         long long w_group_stride, long long w_row_stride,
                         const int4* plan, int K, int N, int num_tiles,
                         float* y, cudaStream_t stream) {
  constexpr int kSmem = Tile<BM, kWT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      gg_tf32<BM, kVec, kWT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const int n_col_tiles = (N + kBN - 1) / kBN;
  const long long blocks = static_cast<long long>(num_tiles) * n_col_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gg_tf32<BM, kVec, kWT><<<static_cast<unsigned>(blocks), kThreads, kSmem,
                           stream>>>(x, w, w_group_stride, w_row_stride,
                                     plan, K, N, n_col_tiles, y);
  return cudaGetLastError();
}


// ---- bf16 operands: gg_bf16 ---------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kBK16 = 64;          // depth of one ring stage (bf16 values)
constexpr int kLdA16 = kBK16 + 8;  // x rows in shared memory: 144 bytes
constexpr int kLdB16 = kBN + 8;    // w rows in shared memory: 272 bytes

static_assert(kLdA16 * 2 % 128 == 16 && kLdB16 * 2 % 128 == 16,
              "ldmatrix rows land 16 bytes apart mod 128: no conflicts");

template <int BM, bool kWT = false>
struct Tile16 {
  static constexpr int kWM = BM / 2;
  // kWT: the w stage as kBN rows of kBK16 depth values (w transposed)
  static constexpr int kStageElems =
      BM * kLdA16 + (kWT ? kBN * kLdA16 : kBK16 * kLdB16);
  // 143,360 bytes at 128 rows, 106,496 at 64 (kWT: 147,456 and 110,592);
  // two blocks an SM at 64 rows
  static constexpr int kSmem = kStages * kStageElems * 2;
  static constexpr int kBlocksPerSM = blocks_per_sm(kSmem);
  static_assert(BM == 64 || BM == 128, "tiles of 64 or 128 rows");
};

// Copy stage k0 of the x rows [row0, row_end) and of w[g]'s columns
// [n0, n0 + kBN) into shared memory. kVec = 8: 16-byte copies (x, w, K
// and both strides 16-byte aligned); kVec = 1: one value a load, stored
// synchronously. Values past the rows, K or N are stored as zeros. kWT:
// the operand's (k, n) is w[g]'s (n, k), stored at bs[n][k] (rows of
// kLdA16).
template <int BM, int kVec, bool kWT = false>
__device__ __forceinline__ void load_stage16(
    bf16* as, bf16* bs, const bf16* __restrict__ x,
    const bf16* __restrict__ wg, long long w_row_stride, int row0,
    int row_end, int n0, int k0, int K, int N) {
  constexpr int kAChunks = BM * kBK16 / kVec / kThreads;
  constexpr int kBChunks = kBK16 * kBN / kVec / kThreads;
#pragma unroll
  for (int l = 0; l < kAChunks; ++l) {
    const int c = threadIdx.x + l * kThreads;
    const int r = c / (kBK16 / kVec), kk = (c % (kBK16 / kVec)) * kVec;
    const int row = row0 + r, k = k0 + kk;
    const int n_in = row < row_end ? max(0, min(kVec, K - k)) : 0;
    const bf16* src = n_in ? x + static_cast<long long>(row) * K + k : x;
    if constexpr (kVec == 8)
      sm90::cp_async16(as + r * kLdA16 + kk, src, 2 * n_in);
    else
      as[r * kLdA16 + kk] = n_in ? *src : __float2bfloat16_rn(0.f);
  }
  if constexpr (kWT) {
#pragma unroll
    for (int l = 0; l < kBChunks; ++l) {
      const int c = threadIdx.x + l * kThreads;
      const int nn = c / (kBK16 / kVec), kk = (c % (kBK16 / kVec)) * kVec;
      const int k = k0 + kk, n = n0 + nn;
      const int n_in = n < N ? max(0, min(kVec, K - k)) : 0;
      const bf16* src = n_in ? wg + n * w_row_stride + k : wg;
      if constexpr (kVec == 8)
        sm90::cp_async16(bs + nn * kLdA16 + kk, src, 2 * n_in);
      else
        bs[nn * kLdA16 + kk] = n_in ? *src : __float2bfloat16_rn(0.f);
    }
  } else {
#pragma unroll
    for (int l = 0; l < kBChunks; ++l) {
      const int c = threadIdx.x + l * kThreads;
      const int kk = c / (kBN / kVec), nn = (c % (kBN / kVec)) * kVec;
      const int k = k0 + kk, n = n0 + nn;
      const int n_in = k < K ? max(0, min(kVec, N - n)) : 0;
      const bf16* src = n_in ? wg + k * w_row_stride + n : wg;
      if constexpr (kVec == 8)
        sm90::cp_async16(bs + kk * kLdB16 + nn, src, 2 * n_in);
      else
        bs[kk * kLdB16 + nn] = n_in ? *src : __float2bfloat16_rn(0.f);
    }
  }
}

// One ring stage's products for the warp's first MT m16 row tiles and its
// kWN columns (as / bs: the warp's rows of the x tile, its columns of the
// w tile), into stage sums that are then added to acc. Per k16 step: A
// fragments by ldmatrix (lanes 0-15 rows 0-15 at depth 0, lanes 16-31 at
// depth 8), B fragments of two n8 tiles by one ldmatrix.trans (matrix
// lane / 8: depth 8·(m & 1), columns 8·(m >> 1)); kWT: by one ldmatrix
// from the transposed tile (the same matrices, rows 8·(m >> 1) + lane % 8
// of it at depth 8·(m & 1)).
template <int WM, int MT, bool kWT>
__device__ __forceinline__ void stage_products16(
    const bf16* as, const bf16* bs, float (&acc)[WM / 16][kWN / 8][4]) {
  const int lane = threadIdx.x % 32, mat = lane / 8;
  float part[MT][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kBK16 / 16; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      sm90::ldmatrix_x4(a[i], sm90::smem_addr(
          as + (16 * i + lane % 16) * kLdA16 + 16 * ks + 8 * (lane / 16)));
#pragma unroll
    for (int jj = 0; jj < kWN / 16; ++jj) {
      uint32_t b[4];  // {depth 0-7, 8-15} of columns 0-7, then of 8-15
      if constexpr (kWT)
        sm90::ldmatrix_x4(b, sm90::smem_addr(
            bs + (16 * jj + 8 * (mat >> 1) + lane % 8) * kLdA16 + 16 * ks +
            8 * (mat & 1)));
      else
        sm90::ldmatrix_x4_trans(b, sm90::smem_addr(
            bs + (16 * ks + 8 * (mat & 1) + lane % 8) * kLdB16 + 16 * jj +
            8 * (mat >> 1)));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        sm90::mma_bf16(part[i][2 * jj], a[i], b[0], b[1]);
        sm90::mma_bf16(part[i][2 * jj + 1], a[i], b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

template <int WM, bool kWT, int MT = WM / 16>
__device__ __forceinline__ void stage_products16_for(
    int m_tiles, const bf16* as, const bf16* bs,
    float (&acc)[WM / 16][kWN / 8][4]) {
  if (m_tiles == MT)
    stage_products16<WM, MT, kWT>(as, bs, acc);
  else if constexpr (MT > 1)
    stage_products16_for<WM, kWT, MT - 1>(m_tiles, as, bs, acc);
}

// One BM x kBN tile of y = x[rows] @ w[g] from bf16 operands, float32
// sums, y rounded to bf16 once (kWT: w read transposed, as gg_tf32's);
// block b is column tile b % n_col_tiles of row tile b / n_col_tiles.
template <int BM, int kVec, bool kWT>
__global__ void __launch_bounds__(kThreads, Tile16<BM, kWT>::kBlocksPerSM)
gg_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
        long long w_group_stride, long long w_row_stride,
        const int4* __restrict__ plan, int K, int N, int n_col_tiles,
        bf16* __restrict__ y) {
  const int4 p = plan[blockIdx.x / n_col_tiles];
  const int g = p.x, row0 = p.y, row_end = p.z;
  if (g == -2) return;
  const int n0 = (blockIdx.x % n_col_tiles) * kBN;
  if (g == -1) {
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int r = row0 + i / kBN, c = n0 + i % kBN;
      if (r < row_end && c < N)
        y[static_cast<long long>(r) * N + c] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  using C = Tile16<BM, kWT>;
  constexpr int kWM = C::kWM, kStageElems = C::kStageElems;
  extern __shared__ __align__(16) unsigned char smem16_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem16_raw);
  const bf16* wg = w + g * w_group_stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m_tiles =
      min(kWM / 16, max(0, (row_end - row0 - wm * kWM + 15) / 16));
  float acc[kWM / 16][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = (K + kBK16 - 1) / kBK16;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      load_stage16<BM, kVec, kWT>(smem + s * kStageElems,
                             smem + s * kStageElems + BM * kLdA16, x, wg,
                             w_row_stride, row0, row_end, n0, s * kBK16, K,
                             N);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    sm90::cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread, and stage kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < n_k) {
      bf16* st = smem + (next % kStages) * kStageElems;
      load_stage16<BM, kVec, kWT>(st, st + BM * kLdA16, x, wg,
                                  w_row_stride, row0, row_end, n0,
                                  next * kBK16, K, N);
    }
    sm90::cp_async_commit();
    const bf16* as = smem + (kt % kStages) * kStageElems + wm * kWM * kLdA16;
    const bf16* bs = smem + (kt % kStages) * kStageElems + BM * kLdA16 +
                     wn * kWN * (kWT ? kLdA16 : 1);
    stage_products16_for<kWM, kWT>(m_tiles, as, bs, acc);
  }
  sm90::cp_async_wait<0>();

  const bool pairs = N % 2 == 0;  // two columns a 4-byte store
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i) {
    if (i >= m_tiles) continue;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int c = n0 + wn * kWN + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm * kWM + 16 * i + gr + 8 * h;
        if (r >= row_end || c >= N) continue;
        bf16* dst = y + static_cast<long long>(r) * N + c;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          dst[0] = __float2bfloat16_rn(acc[i][j][2 * h]);
          if (c + 1 < N) dst[1] = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

template <int BM, int kVec, bool kWT>
cudaError_t launch_tiles16(const bf16* x, const bf16* w,
                           long long w_group_stride, long long w_row_stride,
                           const int4* plan, int K, int N, int num_tiles,
                           bf16* y, cudaStream_t stream) {
  constexpr int kSmem = Tile16<BM, kWT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      gg_bf16<BM, kVec, kWT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const int n_col_tiles = (N + kBN - 1) / kBN;
  const long long blocks = static_cast<long long>(num_tiles) * n_col_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gg_bf16<BM, kVec, kWT><<<static_cast<unsigned>(blocks), kThreads, kSmem,
                           stream>>>(x, w, w_group_stride, w_row_stride,
                                     plan, K, N, n_col_tiles, y);
  return cudaGetLastError();
}

// ---- bf16 operands through TMA and wgmma: gg_sm90 ---------------------------
// A ring stage is 64 deep: one 128-byte swizzled row of x a tile row, and
// 64 rows of 128 bytes a 64-column block of w.
constexpr int kDepth = 64;
// Depth of a sum on the tensor core before it is added into the tile's
// float32 sums (tests/test_torch_moe_gemm_sm90.py emulates it and holds it
// to chip_smoke.py's gate): 4 ring stages.
constexpr int kSumDepth = 256;
constexpr int kFoldStages = kSumDepth / kDepth;
constexpr int kSmThreads = 384;  // two consumer warpgroups and a producer
constexpr int kSmemMax = 232448 - 512;  // an H100 block's, less the statics

static_assert(kSumDepth % kDepth == 0 && kFoldStages % 2 == 0,
              "whole ring stages, staggered by half a sum");

// A block's BM x 128 tile: two consumer warpgroups of 64 rows each (BM =
// 128), or of 64 columns each (BM = 64). At BM = 128 two blocks form a
// cluster over a 128 x 256 tile of one group: each loads half of the x box
// for both (TMA multicast), so the pair reads each x tile from L2 once.
template <int BM>
struct TileSm90 {
  static_assert(BM == 64 || BM == 128, "64 or 128 rows");
  static constexpr int kBN = 128;  // columns of a block's tile
  static constexpr int kCluster = BM == 128 ? 2 : 1;
  static constexpr int kWgN = BM == 128 ? kBN : kBN / 2;  // a warpgroup's
  static constexpr int kXRows = BM / kCluster;  // rows of this block's x box
  static constexpr int kABytes = BM * 128;      // x: BM rows of 64 values
  static constexpr int kBBytes = kBN * 128;     // w: 64 x 64 boxes
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the epilogue's staging: each warpgroup's 64 x kWgN tile in bf16
  static constexpr int kStagingBytes = 2 * 64 * kWgN * 2;
  static constexpr int kRing = kSmemMax - 1024 - kStagingBytes;
  static constexpr int kStages =
      kRing / kStageBytes < 8 ? kRing / kStageBytes : 8;
  // 6 x 32 KB at 128 rows, 8 x 24 KB at 64
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kStagingBytes;
};

// Named barrier 1 + wg: the 128 threads of consumer warpgroup wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A consumer warp's release of ring stage `s`: one arrival on its empty
// barrier in every block of the cluster, lane r on block r's.
template <int kCluster>
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  if constexpr (kCluster == 1) {
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  } else {
    if (lane < kCluster) sm90::mbar_arrive_cluster(&empty[s], lane);
  }
}

// A warpgroup's 64 x kWgN sums (wgmma's accumulator layout) rounded to
// bf16 once into y at rows [row0, row0 + 64) below row_end and columns
// [col0, col0 + kWgN) below N, through the warpgroup's staging (16-byte
// chunks, swizzled by the row so neither pass conflicts on banks) into
// 16-byte stores. Rows of the next group and columns past N are computed,
// not stored.
template <int kWgN>
__device__ __forceinline__ void store_tile(const float (&acc)[kWgN / 2],
                                           uint8_t* staging, int wg,
                                           int row0, int row_end, int col0,
                                           int N, bf16* __restrict__ y) {
  constexpr int kChunks = kWgN / 8;
  constexpr int kSwz = kChunks < 8 ? kChunks - 1 : 7;
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  warpgroup_sync(wg);  // the last tile's stores have read the staging
#pragma unroll
  for (int j = 0; j < kWgN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wi + g + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(
          staging + r * kWgN * 2 + ((j ^ (r & kSwz)) << 4) + 4 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  warpgroup_sync(wg);
#pragma unroll
  for (int q = 0; q < kChunks / 2; ++q) {
    const int i = tid + 128 * q;
    const int r = i / kChunks, c = i % kChunks;
    const int gr = row0 + r, gc = col0 + 8 * c;
    if (gr < row_end && gc < N)  // N % 8 == 0: the chunk is inside
      *reinterpret_cast<uint4*>(y + static_cast<long long>(gr) * N + gc) =
          *reinterpret_cast<const uint4*>(staging + r * kWgN * 2 +
                                          ((c ^ (r & kSwz)) << 4));
  }
}

// One persistent block an SM (a cluster of two blocks at BM = 128) walks
// the table of cluster tiles: tile t is column tile t % n_col_tiles (of
// kCluster·128 columns) of row tile t / n_col_tiles (plan entry, BM rows),
// t from the cluster's index in steps of the number of clusters, up to the
// used row tiles (plan[0].w). Warps 0-7 are the consumer warpgroups,
// warps 8-11 the producer (one thread of it issues the TMA loads and runs
// ahead into the next tiles' loads). kWT (dx = dy · wᵀ, K the depth N of
// w and N its rows K): the w boxes are taken at (depth, row) of the same
// (N, K, G) map, so each of the tile's 128 output columns lands as one
// 128-byte swizzled row of 64 depth values, and B is read K-major (the
// transpose bit off), as x is.
template <int BM, bool kWT>
__global__ void __launch_bounds__(kSmThreads, 1)
gg_sm90(const __grid_constant__ CUtensorMap x_map,
        const __grid_constant__ CUtensorMap w_map, const int4* plan, int K,
        int N, int n_col_tiles, bf16* __restrict__ y) {
  using C = TileSm90<BM>;
  constexpr int kStages = C::kStages, kWgN = C::kWgN;
  constexpr int kCluster = C::kCluster;
  extern __shared__ uint8_t smem_sm90_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_sm90_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + kStages * C::kStageBytes;
  const int n_k = (K + kDepth - 1) / kDepth;
  const int rank = blockIdx.x % kCluster;  // this block's column half
  const int cluster = blockIdx.x / kCluster;
  const int n_clusters = gridDim.x / kCluster;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      // one arrival a consumer warp of each block of the cluster: a stage
      // is free when neither block still reads the x half this one wrote
      sm90::mbar_init(&empty[s], 8 * kCluster);
    }
    sm90::mbar_fence_init();
  }
  if constexpr (kCluster > 1) sm90::cluster_sync();
  else __syncthreads();
  // everything above ran beside the prologue (`gg_plan`); the plan from
  // here, read through L2 (`__ldcg`) from a pointer the compiler may not
  // take for read-only: a load hoisted above the wait, or served from
  // another call's lines, would walk a stale table
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int n_tiles = __ldcg(&plan[0].w) * n_col_tiles;

  if (warp >= 8) {  // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = cluster; tile < n_tiles; tile += n_clusters) {
        const int4 p = __ldcg(&plan[tile / n_col_tiles]);
        if (p.x < 0) continue;  // the zero tail loads nothing
        const int n0 = ((tile % n_col_tiles) * kCluster + rank) * C::kBN;
        for (int kt = 0; kt < n_k; ++kt) {
          sm90::mbar_wait(&empty[s], phase ^ 1);
          sm90::mbar_expect_tx(&full[s], C::kStageBytes);
          uint8_t* st = ring + s * C::kStageBytes;
          if constexpr (kCluster == 1)
            sm90::tma_load_2d(st, &x_map, &full[s], kt * kDepth, p.y);
          else
            sm90::tma_load_2d_multicast(st + rank * C::kXRows * 128, &x_map,
                                        &full[s], kt * kDepth,
                                        p.y + rank * C::kXRows, 0x3);
#pragma unroll
          for (int j = 0; j < C::kBN / 64; ++j) {
            if constexpr (kWT)
              sm90::tma_load_3d(st + C::kABytes + j * 64 * 128, &w_map,
                                &full[s], kt * kDepth, n0 + 64 * j, p.x);
            else
              sm90::tma_load_3d(st + C::kABytes + j * 64 * 128, &w_map,
                                &full[s], n0 + 64 * j, kt * kDepth, p.x);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      if constexpr (kCluster > 1) {
        // the other block's consumers arrive on this block's barriers:
        // stay until they have released every stage
        for (int i = 0; i < kStages; ++i) {
          sm90::mbar_wait(&empty[s], phase ^ 1);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4;
    const int row_off = BM == 128 ? 64 * wg : 0;  // this warpgroup's part
    const int col_off = BM == 128 ? 0 : kWgN * wg;
    // the two warpgroups add their sums half a sum apart, so one of them
    // keeps the tensor cores busy while the other waits and adds (or
    // stores the last tile)
    const int shift = wg * (kFoldStages / 2);
    const uint32_t ring_base = sm90::smem_addr(ring);
    uint8_t* stage_out = staging + wg * 64 * kWgN * 2;
    float acc[kWgN / 2], part[kWgN / 2];
#pragma unroll
    for (int i = 0; i < kWgN / 2; ++i) part[i] = acc[i] = 0.f;
    // the tile whose sums `acc` holds, stored while the next one's first
    // sum runs on the tensor cores
    int last_row0 = 0, last_end = 0, last_col0 = 0;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = cluster; tile < n_tiles; tile += n_clusters) {
      const int4 p = __ldcg(&plan[tile / n_col_tiles]);
      // one sum at a time: its stages' products into `part` (the first
      // with the scale of d at 0), each stage released once the next one's
      // products are issued; then the sum added into `acc`. No branch
      // reads or waits on the wgmma registers (ptxas would serialize the
      // products); a zero-tail tile runs no sum.
      const int k_end = p.x >= 0 ? n_k : 0;
      for (int k0 = 0; k0 < k_end;) {
        const int k1 = min(k_end, (k0 + shift) / kFoldStages * kFoldStages +
                                      kFoldStages - shift);
        int held = -1;  // a stage whose products may still be running
        for (int kt = k0; kt < k1; ++kt) {
          sm90::mbar_wait(&full[s], phase);
          const uint32_t a_base =
              ring_base + s * C::kStageBytes + row_off * 128;
          // (a warpgroup's columns may start inside a 128-byte swizzled
          // row, as 32 of a 64-column tile would: the swizzle is of the
          // address; kWT: a column is a row)
          const uint32_t b_base =
              ring_base + s * C::kStageBytes + C::kABytes +
              (kWT ? col_off * 128
                   : (col_off / 64) * 64 * 128 + (col_off % 64) * 2);
          sm90::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kDepth / 16; ++ks) {
            // x K-major: 32 bytes a k16 step, 8 rows 1024 bytes apart;
            // w MN-major: 16 rows a k16 step, column blocks 8 KB apart
            // (kWT: K-major, as x)
            const uint64_t da =
                sm90::descriptor(a_base + 32 * ks, 16, 1024, 1);
            if constexpr (kWT) {
              const uint64_t db =
                  sm90::descriptor(b_base + 32 * ks, 16, 1024, 1);
              sm90::wgmma_ss<kWgN>(part, da, db, ks > 0 || kt > k0);
            } else {
              const uint64_t db = sm90::descriptor(b_base + 16 * 128 * ks,
                                                   64 * 128, 1024, 1);
              sm90::wgmma_ss_tb<kWgN>(part, da, db, ks > 0 || kt > k0);
            }
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the previous stage's products are done
          __syncwarp();
          if (held >= 0) release<kCluster>(empty, held, lane);
          held = s;
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
        if (k0 == 0 && last_end > last_row0)
          store_tile<kWgN>(acc, stage_out, wg, last_row0, last_end,
                           last_col0, N, y);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(part);
        __syncwarp();
        release<kCluster>(empty, held, lane);
        const bool fresh = k0 == 0;  // a tile's first sum replaces `acc`
#pragma unroll
        for (int i = 0; i < kWgN / 2; ++i)
          acc[i] = part[i] + (fresh ? 0.f : acc[i]);
        k0 = k1;
      }
      if (k_end == 0) {  // the zero tail: store the last tile, then zeros
        if (last_end > last_row0)
          store_tile<kWgN>(acc, stage_out, wg, last_row0, last_end,
                           last_col0, N, y);
#pragma unroll
        for (int i = 0; i < kWgN / 2; ++i) acc[i] = 0.f;
      }
      last_row0 = p.y + row_off;
      last_end = p.z;
      last_col0 =
          ((tile % n_col_tiles) * kCluster + rank) * C::kBN + col_off;
    }
    if (last_end > last_row0)
      store_tile<kWgN>(acc, stage_out, wg, last_row0, last_end, last_col0, N,
                       y);
  }
}

template <int BM, bool kWT>
cudaError_t launch_sm90(int device, const bf16* x, const bf16* w,
                        long long w_group_stride, long long w_row_stride,
                        const int4* plan, int M, int K, int N, int G,
                        int num_tiles, bf16* y, cudaStream_t stream) {
  using C = TileSm90<BM>;
  constexpr auto kernel = gg_sm90<BM, kWT>;
  // x as (K, M) in boxes of (64, BM / kCluster); w as (N, K, G) with its
  // own strides in boxes of (64, 64, 1): a strided view is read in place
  // (kWT: w's dims are (K, N, G), its rows the output's columns)
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K),
                              static_cast<uint64_t>(M)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t x_box[2] = {kDepth, C::kXRows};
  const uint64_t w_dims[3] = {static_cast<uint64_t>(kWT ? K : N),
                              static_cast<uint64_t>(kWT ? N : K),
                              static_cast<uint64_t>(G)};
  const uint64_t w_strides[2] = {static_cast<uint64_t>(w_row_stride) * 2,
                                 static_cast<uint64_t>(w_group_stride) * 2};
  const uint32_t w_box[3] = {64, kDepth, 1};
  cudaError_t err = sm90::make_map(&x_map, x, 2, x_dims, x_strides, x_box);
  if (err == cudaSuccess)
    err = sm90::make_map(&w_map, w, 3, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  // launched as the prologue's programmatic dependent: it may start while
  // `gg_plan` runs and waits for the plan (griddepcontrol.wait)
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = C::kCluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kSmThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  // once a device: the shared-memory opt-in and the blocks the card keeps
  // resident (whole clusters)
  static int resident[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    int n = 0;
    if constexpr (C::kCluster == 1) {
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                   device);
    } else {
      cfg.gridDim = dim3(C::kCluster, 1, 1);
      cfg.attrs = attr + 1;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    }
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    resident[device] = n * C::kCluster;
  }
  const int n_col_tiles =
      (N + C::kCluster * C::kBN - 1) / (C::kCluster * C::kBN);
  const long long blocks =
      static_cast<long long>(num_tiles) * n_col_tiles * C::kCluster;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(static_cast<unsigned>(
      blocks < resident[device] ? blocks : resident[device]), 1, 1);
  cfg.attrs = attr;
  cfg.numAttrs = C::kCluster > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, x_map, w_map, plan, K, N,
                            n_col_tiles, y);
}

// The prologue: the tile table of `tile_rows`-row tiles into `plan`.
cudaError_t plan_tiles(const int* sizes, int G, int M, int tile_rows,
                       int num_tiles, int4* plan, cudaStream_t stream) {
  gg_plan<<<1, kPlanThreads, 0, stream>>>(sizes, G, M, tile_rows, num_tiles,
                                          plan);
  return cudaGetLastError();
}

// The three entry points of each kernel share these: check, plan the
// tiles, launch. kWT: dx = dy · wᵀ (K the depth N of w, N its rows K).
template <bool kWT>
int run_tf32(int device, const float* x, const float* w,
             long long w_group_stride, long long w_row_stride,
             const int* sizes, int M, int K, int N, int G, int tile_rows,
             int num_tiles, int vec16, int* plan, float* y,
             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile_rows != 64 && tile_rows != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0 && N > 0 && num_tiles > 0) {
    int4* plan4 = reinterpret_cast<int4*>(plan);
    err = plan_tiles(sizes, G, M, tile_rows, num_tiles, plan4, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    using Launch = cudaError_t (*)(const float*, const float*, long long,
                                   long long, const int4*, int, int, int,
                                   float*, cudaStream_t);
    const Launch launch = tile_rows == 64
        ? (vec16 ? &launch_tiles<64, 4, kWT> : &launch_tiles<64, 1, kWT>)
        : (vec16 ? &launch_tiles<128, 4, kWT> : &launch_tiles<128, 1, kWT>);
    err = launch(x, w, w_group_stride, w_row_stride, plan4, K, N, num_tiles,
                 y, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kWT>
int run_bf16(int device, const void* x, const void* w,
             long long w_group_stride, long long w_row_stride,
             const int* sizes, int M, int K, int N, int G, int tile_rows,
             int num_tiles, int vec16, int* plan, void* y,
             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile_rows != 64 && tile_rows != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0 && N > 0 && num_tiles > 0) {
    int4* plan4 = reinterpret_cast<int4*>(plan);
    err = plan_tiles(sizes, G, M, tile_rows, num_tiles, plan4, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    using Launch = cudaError_t (*)(const bf16*, const bf16*, long long,
                                   long long, const int4*, int, int, int,
                                   bf16*, cudaStream_t);
    const Launch launch = tile_rows == 64
        ? (vec16 ? &launch_tiles16<64, 8, kWT> : &launch_tiles16<64, 1, kWT>)
        : (vec16 ? &launch_tiles16<128, 8, kWT>
                 : &launch_tiles16<128, 1, kWT>);
    err = launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                 w_group_stride, w_row_stride, plan4, K, N, num_tiles,
                 static_cast<bf16*>(y), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kWT>
int run_sm90(int device, const void* x, const void* w,
             long long w_group_stride, long long w_row_stride,
             const int* sizes, int M, int K, int N, int G, int tile_rows,
             int num_tiles, int* plan, void* y, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || w_group_stride % 8 != 0 ||
      w_row_stride % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = cudaError_t (*)(int, const bf16*, const bf16*, long long,
                                 long long, const int4*, int, int, int, int,
                                 int, bf16*, cudaStream_t);
  Launch launch = nullptr;
  if (tile_rows == 128) launch = &launch_sm90<128, kWT>;
  if (tile_rows == 64) launch = &launch_sm90<64, kWT>;
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0 && N > 0 && num_tiles > 0) {
    int4* plan4 = reinterpret_cast<int4*>(plan);
    err = plan_tiles(sizes, G, M, tile_rows, num_tiles, plan4, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch(device, static_cast<const bf16*>(x),
                 static_cast<const bf16*>(w), w_group_stride, w_row_stride,
                 plan4, M, K, N, G, num_tiles, static_cast<bf16*>(y), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) float32, rows sorted by group; w: (G, K, N) float32, element
// (g, k, n) at w[g * w_group_stride + k * w_row_stride + n]; sizes: (G,)
// int32 on the device; tile_rows: 64 or 128 (the wrapper takes 64 where the
// groups average fewer than 128 rows); plan: (num_tiles, 4) int32 scratch
// with num_tiles = ceil(M / tile_rows) + G; y: (M, N) float32, fully
// written. vec16: x, w, K and both strides allow 16-byte copies (the
// wrapper decides from the shape).
extern "C" int tdorch_grouped_gemm(int device, const float* x, const float* w,
                                   long long w_group_stride,
                                   long long w_row_stride, const int* sizes,
                                   int M, int K, int N, int G, int tile_rows,
                                   int num_tiles, int vec16, int* plan,
                                   float* y, cudaStream_t stream) {
  return run_tf32<false>(device, x, w, w_group_stride, w_row_stride, sizes,
                         M, K, N, G, tile_rows, num_tiles, vec16, plan, y,
                         stream);
}

// The same for bf16 x, w and y (`gg_bf16`): float32 sums, y rounded to
// bf16 once. vec16: x, w, K and both strides allow 16-byte copies (8
// values).
extern "C" int tdorch_grouped_gemm_bf16(int device, const void* x,
                                        const void* w,
                                        long long w_group_stride,
                                        long long w_row_stride,
                                        const int* sizes, int M, int K,
                                        int N, int G, int tile_rows,
                                        int num_tiles, int vec16, int* plan,
                                        void* y, cudaStream_t stream) {
  return run_bf16<false>(device, x, w, w_group_stride, w_row_stride, sizes,
                         M, K, N, G, tile_rows, num_tiles, vec16, plan, y,
                         stream);
}

// The same for bf16 x, w and y through TMA and `wgmma` (`gg_sm90`): x, w,
// and w's strides 16-byte aligned, K > 0 and K, N multiples of 8 (the
// wrapper routes other operands to `gg_bf16`); tile_rows 64 or 128, as the
// other two take.
extern "C" int tdorch_grouped_gemm_sm90(int device, const void* x,
                                        const void* w,
                                        long long w_group_stride,
                                        long long w_row_stride,
                                        const int* sizes, int M, int K,
                                        int N, int G, int tile_rows,
                                        int num_tiles, int* plan, void* y,
                                        cudaStream_t stream) {
  return run_sm90<false>(device, x, w, w_group_stride, w_row_stride, sizes,
                         M, K, N, G, tile_rows, num_tiles, plan, y, stream);
}

// The backward's dx = dy · wᵀ, row by row over the same tile walk: dy
// (M, K) takes x's place and w (G, N, K) — element (g, n, k) at
// w[g * w_group_stride + n * w_row_stride + k] — is read transposed in
// place; dx (M, N) is fully written, zeros past the groups' sum. Here K is
// the forward's N (w's depth-major width) and N the forward's K. The
// arguments are the forward's; the route (`ops.route_dx`) the same rules.
extern "C" int tdorch_grouped_gemm_dx(int device, const float* dy,
                                      const float* w,
                                      long long w_group_stride,
                                      long long w_row_stride,
                                      const int* sizes, int M, int K, int N,
                                      int G, int tile_rows, int num_tiles,
                                      int vec16, int* plan, float* dx,
                                      cudaStream_t stream) {
  return run_tf32<true>(device, dy, w, w_group_stride, w_row_stride, sizes,
                        M, K, N, G, tile_rows, num_tiles, vec16, plan, dx,
                        stream);
}

extern "C" int tdorch_grouped_gemm_dx_bf16(int device, const void* dy,
                                           const void* w,
                                           long long w_group_stride,
                                           long long w_row_stride,
                                           const int* sizes, int M, int K,
                                           int N, int G, int tile_rows,
                                           int num_tiles, int vec16,
                                           int* plan, void* dx,
                                           cudaStream_t stream) {
  return run_bf16<true>(device, dy, w, w_group_stride, w_row_stride, sizes,
                        M, K, N, G, tile_rows, num_tiles, vec16, plan, dx,
                        stream);
}

extern "C" int tdorch_grouped_gemm_dx_sm90(int device, const void* dy,
                                           const void* w,
                                           long long w_group_stride,
                                           long long w_row_stride,
                                           const int* sizes, int M, int K,
                                           int N, int G, int tile_rows,
                                           int num_tiles, int* plan, void* dx,
                                           cudaStream_t stream) {
  return run_sm90<true>(device, dy, w, w_group_stride, w_row_stride, sizes,
                        M, K, N, G, tile_rows, num_tiles, plan, dx, stream);
}
