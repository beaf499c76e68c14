// The weight gradient of the grouped (block-diagonal) GEMM for MoE experts,
// for Hopper, sm_90a: dw[g] = x_gᵀ · dy_g.
//
// Replaces no Pallas kernel. The TPU kernel `grouped_gemm_padded`
// (src/repro/kernels/moe_gemm/kernel.py) has no backward: the JAX package
// trains its MoE models through autodiff of `lax.ragged_dot`
// (src/repro/core/spmd.py), whose transpose XLA computes. Here the port's
// `grouped_gemm` is a `torch.autograd.Function`; its dx = dy · wᵀ runs the
// forward's tile walk with w read transposed (csrc/moe_gemm.cu), and this
// file computes dw.
//
// x: (M, K) and dy: (M, N), rows sorted by group (group g owns the next
// sizes[g] rows; negative sizes count as 0, rows past M are cut); dw: (G,
// K, N), dense, every element written: a group's sum runs over its own
// rows only, rows at or beyond the groups' sum are never read, and an
// empty group's dw is 0.
//
// What bounds it on this card: the arithmetic at training sizes (2·M·K·N:
// 2.7e11 FLOP for granite-moe-1b-a400m's in-projection over 131,072
// assignments, 0.28 ms at 989 TFLOP/s in bf16), the bytes of x and dy at a
// decode step's handful of rows a group.
//
// The walk, shared by the three kernels:
// - A one-block prologue (`dw_plan`) reads the sizes on the device and cuts
//   each group's rows, from its first row, into chunks of at most C rows
//   (C from the host, `ops.dw_chunk_rows`: an SM's fair share of the
//   call, a multiple of kSumDepth); an empty group is one chunk of no
//   rows, whose units write zeros. It lists the chunks longest first, ties
//   in (group, chunk) order. A work unit is (chunk, 128 x 128 tile of dw),
//   the tiles of a chunk next to each other (they share its rows in L2).
// - One block a (group, tile) in group order, as before, let the hottest
//   group (a third of the rows under granite's Zipf-1.2 routing) start last,
//   each of its blocks walking all of its rows alone: such a call cannot
//   end before 1.3-2x an SM's fair share of the work. Now one persistent
//   block an SM, launched as the prologue's programmatic dependent, takes
//   unit blockIdx.x first and then the next untaken unit of the list from
//   a counter in the plan's header (`next_unit`), longest first, as it
//   frees up: a fixed stride, or one alternating direction each round,
//   left the busiest SM later at granite's in-projection than the
//   hardware's own dispatch of one block a tile did (PERF.md, row 4d).
//   The counter is in no sum: which block takes a unit never changes its
//   bits.
// - A unit of a group of one chunk writes its tile of dw, rounded once. A
//   split group's units write float32 partials to a workspace (the plan's
//   slots), and `dw_reduce` adds each split group's partials in chunk
//   order, rounds once and writes dw: every sum's order is the plan's,
//   never the timing's. Chunks start at multiples of kSumDepth from the
//   group's first row, so the kernels fold their sums where they did
//   before the split; only the partials' sum is new.
// - No atomics: every element is summed by one thread in one order, so two
//   calls on the same inputs give the same bits (the trainer's restore is
//   checked bit for bit).
//
// The kernels:
// - `gg_dw_sm90` (bf16 x and dy that TMA can describe: 16-byte aligned
//   bases, K and N multiples of 8). A stage is 64 rows: x's 128 columns of
//   the tile as two 64-column boxes and dy's 128 columns as two, each box
//   64 rows of 128-byte swizzled lines (32 KB a stage, a ring of 7), loaded
//   by one producer thread (its warpgroup at 40 registers after
//   `setmaxnreg`). Two consumer warpgroups (232 registers) each take 64 of
//   the tile's K columns, one of x's boxes: `wgmma` m64n128k16 with A = xᵀ
//   and B = dy both read MN-major from shared memory (both transpose
//   bits), 4 k16 steps a stage. The reduction runs over rows, so both
//   operands arrive MN-major, and the transpose bits read them as TMA laid
//   them down. TMA zero-fills only past M, so in a unit's last stage each
//   consumer warpgroup zeroes its x rows at or past the chunk's end (whole
//   128-byte lines, whatever the swizzle) and fences them for the tensor
//   core; a zero x row adds nothing, whatever dy holds there.
// - `gg_dw_bf16` (other bf16 operands): `mma.sync` m16n8k16 with A (xᵀ)
//   and B (dy) fragments by `ldmatrix.trans` from a 4-stage `cp.async`
//   ring of 64-row stages; `gg_dw_tf32` (float32): `mma.sync` m16n8k8 in
//   3xTF32 (hi·hi + hi·lo + lo·hi, `sm90::mma_3xtf32`) from 32-row stages,
//   the fragments read by plain loads and split in registers (the depth of
//   each k8 step permuted as in `gg_tf32`: a pair of rows 2t, 2t + 1). Both
//   copy 16 bytes at a time where x, dy, K and N are 16-byte aligned, else
//   one value a load; rows past the chunk's end and columns past K or N
//   land as zeros. 8 warps as 2 x 4, each a 64 x 32 piece of the tile.
//   TF32 `wgmma` reads shared memory K-major only, and both of dw's
//   operands arrive MN-major, so the float32 kernel keeps `mma.sync`.
// - Sums: the tensor core truncates the float32 sum it writes, by up to
//   2^-23 of it a k step, and a group at granite's training shape holds
//   ~4,096 rows (a hot expert many more). bf16: a sum stays on the tensor
//   core for kSumDepth = 256 rows (4 stages) and is then added into the
//   tile's float32 sums, as `gg_sm90` does over its depth (`gg_dw_sm90`'s
//   second warpgroup half a sum later, so one keeps the tensor cores busy
//   while the other adds); float32: each 32-row stage's products go into
//   sums of their own, added to the tile's after the stage, as `gg_tf32`
//   does. dw is rounded to its dtype once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // rows of a dw tile (along K)
constexpr int kBN = 128;       // columns of a dw tile (along N)
constexpr int kThreads = 256;  // 8 warps: 2 along K x 4 along N
constexpr int kWM = 64;        // a warp's rows of the tile
constexpr int kWN = 32;        // a warp's columns
constexpr int kStages = 4;
constexpr int kDepth32 = 32;  // rows of x and dy a float32 stage
constexpr int kDepth16 = 64;  // rows a bf16 stage
// Rows a bf16 sum stays on the tensor core before it is added into the
// tile's float32 sums (tests/test_torch_moe_gemm_bwd.py emulates it): 4
// ring stages. A chunk of a group's rows is a multiple of it.
constexpr int kSumDepth = 256;
constexpr int kFoldStages = kSumDepth / kDepth16;
constexpr int kLd32 = kBN + 4;  // float32 rows in shared memory
constexpr int kLd16 = kBN + 8;  // bf16 rows in shared memory: 272 bytes
constexpr int kPlanThreads = 1024;

static_assert(kBM == kBN, "x's and dy's stage rows are equally long");
static_assert(kBM == 2 * kWM && kBN == 4 * kWN, "8 warps as 2 x 4");
static_assert(kSumDepth % kDepth16 == 0 && kFoldStages % 2 == 0,
              "whole ring stages a sum, halved between the warpgroups");
static_assert(kLd32 % 32 == 4, "rows 2t, 2t + 1 of a pair on other banks");
static_assert(kLd16 * 2 % 128 == 16, "ldmatrix rows 16 bytes apart mod 128");

constexpr int kTile32 = kDepth32 * kLd32;  // one operand's float32 stage
constexpr int kTile16 = kDepth16 * kLd16;
constexpr int kSmem32 = kStages * 2 * kTile32 * 4;  // 135,168 bytes
constexpr int kSmem16 = kStages * 2 * kTile16 * 2;  // 139,264 bytes

// gg_dw_sm90: a box is 64 rows of 64 bf16 values (128-byte lines), a stage
// x's two boxes then dy's two
constexpr int kSmThreads = 384;  // two consumer warpgroups and a producer
constexpr int kSmemMax = 232448 - 512;  // an H100 block's, less the statics
constexpr int kBoxBytes = kDepth16 * 128;
constexpr int kSmStageBytes = 4 * kBoxBytes;  // 32 KB
constexpr int kSmStages = (kSmemMax - 1024) / kSmStageBytes;  // 7
constexpr int kSmSmem = 1024 + kSmStages * kSmStageBytes;     // 230,400
static_assert(kBM == 2 * 64 && kBN == 2 * 64, "two 64-column boxes a side");

// ---- the walk ---------------------------------------------------------------
// The plan, int4 entries written by `dw_plan`:
//   [0]                          (chunks, split groups, units taken by the
//                                walk's counter, 0)
//   [1, 1 + max_chunks)          the chunks in walk order: (group, first
//                                row, end row, slot), slot -1 where the
//                                group is one chunk (its units write dw)
//   [1 + max_chunks, + G)        the split groups: (group, first slot,
//                                chunks, 0), in group order
//   [1 + max_chunks + G, + G)    scratch: each group's last chunk (first
//                                row, end row, slot, rows), rows -1 where
//                                its chunks are all C long

// The plan of chunks of at most C rows (ops.dw_plan_ref is its plain
// twin): the chunks of C rows first, in (group, chunk) order (scans of the
// clamped sizes and of the chunk counts), then each group's shorter last
// chunk, ranked by its length, ties by group.
__global__ void __launch_bounds__(kPlanThreads)
dw_plan(const int* __restrict__ sizes, int G, int M, int C, int max_chunks,
        int4* __restrict__ plan) {
  // the dw kernel may start its prologue now (a programmatic dependent
  // launch; it waits for this grid's writes)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ long long buf[32];
  int4* chunks = plan + 1;
  int4* splits = chunks + max_chunks;
  int4* last = splits + G;
  // carries, the same in every thread
  long long rows_c = 0, full_c = 0, slot_c = 0, split_c = 0, rest_c = 0;
  for (int base = 0; base < G; base += kPlanThreads) {
    const int g = base + threadIdx.x;
    const long long s = g < G ? max(sizes[g], 0) : 0;
    long long t_rows, t_full, t_slot, t_split;
    const long long rows_incl =
        rows_c + sm90::block_inclusive_scan(s, buf, t_rows);
    __syncthreads();
    const int r0 = static_cast<int>(min(rows_incl - s,
                                        static_cast<long long>(M)));
    const int r1 = static_cast<int>(min(rows_incl, static_cast<long long>(M)));
    const int rows = r1 - r0;
    const int n_full = g < G ? rows / C : 0;
    const bool rest = g < G && (rows % C != 0 || rows == 0);
    const bool split = g < G && rows > C;
    const int n = n_full + rest;
    const long long full_incl =
        full_c + sm90::block_inclusive_scan(n_full, buf, t_full);
    __syncthreads();
    const long long slot0 =
        slot_c + sm90::block_inclusive_scan(split ? n : 0, buf, t_slot) -
        (split ? n : 0);
    __syncthreads();
    const long long split_incl =
        split_c + sm90::block_inclusive_scan(split, buf, t_split);
    rest_c += __syncthreads_count(rest);  // and `buf` is free again
    if (g < G) {
      for (int j = 0; j < n_full; ++j) {
        const long long c = full_incl - n_full + j;
        if (c < max_chunks)
          chunks[c] = make_int4(g, r0 + j * C, r0 + (j + 1) * C,
                                split ? static_cast<int>(slot0) + j : -1);
      }
      last[g] = make_int4(r0 + n_full * C, r1,
                          split ? static_cast<int>(slot0) + n_full : -1,
                          rest ? rows % C : -1);
      if (split)
        splits[split_incl - 1] = make_int4(g, static_cast<int>(slot0), n, 0);
    }
    rows_c += t_rows;
    full_c += t_full;
    slot_c += t_slot;
    split_c += t_split;
  }
  __syncthreads();  // every group's last chunk is written
  for (int g = threadIdx.x; g < G; g += kPlanThreads) {
    const int4 me = last[g];
    if (me.w < 0) continue;
    long long rank = full_c;
    for (int h = 0; h < G; ++h) {
      const int rows = last[h].w;
      rank += rows > me.w || (rows == me.w && h < g);
    }
    if (rank < max_chunks) chunks[rank] = make_int4(g, me.x, me.y, me.z);
  }
  if (threadIdx.x == 0)
    plan[0] = make_int4(
        static_cast<int>(min(full_c + rest_c,
                             static_cast<long long>(max_chunks))),
        static_cast<int>(split_c), 0, 0);
}

// The next unit for a block that has finished its last one: the first
// gridDim.x units go one to a block, the rest in list order by the plan's
// counter (zeroed by `dw_plan`).
__device__ __forceinline__ int next_unit(int4* plan) {
  return static_cast<int>(gridDim.x) + atomicAdd(&plan[0].z, 1);
}

// A work unit: the chunk's group, rows and slot, and the tile's corner.
struct Unit {
  int g, r0, r1, slot, k0, n0;
};

// Unit u of the plan (chunk u / tiles, tile u % tiles of tiles_n a row),
// read through L2: the plan is another grid's output, read after
// `griddepcontrol.wait`.
__device__ __forceinline__ Unit unit_at(const int4* plan, int u, int tiles,
                                        int tiles_n) {
  const int4 c = __ldcg(&plan[1 + u / tiles]);
  const int t = u % tiles;
  return {c.x, c.y, c.z, c.w, (t / tiles_n) * kBM, (t % tiles_n) * kBN};
}

// Where a unit's sums go: dw[g] (a group of one chunk) or the workspace
// slot of its chunk, both (K, N).
__device__ __forceinline__ long long unit_base(const Unit& w, int K, int N) {
  return static_cast<long long>(w.slot < 0 ? w.g : w.slot) * K * N;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// dw[g] = round(Σ_c partial[first slot + c]) for each split group, the
// partials added in chunk order: one row of blocks a split group (blocks
// past the plan's count exit), a grid-stride loop over the K·N elements.
template <typename T>
__global__ void __launch_bounds__(256)
dw_reduce(const int4* __restrict__ plan, int max_chunks,
          const float* __restrict__ ws, long long kn, T* __restrict__ dw) {
  if (static_cast<int>(blockIdx.y) >= plan[0].y) return;
  const int4 sp = plan[1 + max_chunks + blockIdx.y];
  const float* src = ws + sp.y * kn;
  T* dst = dw + sp.x * kn;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < kn; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = src[e];
    for (int c = 1; c < sp.z; ++c) v += src[c * kn + e];
    dst[e] = from_float<T>(v);
  }
}

// ---- the mma.sync kernels ---------------------------------------------------
// Copy rows [row, row + kDepth) of `src` (rows of `cols` values), columns
// [col0, col0 + 128), into `dst` (rows of kLd): rows at or past row_end
// and columns past `cols` as zeros. kVec values a copy: 16 bytes, or one
// value (a 4-byte `cp.async` for float32, a synchronous store for bf16).
template <typename T, int kDepth, int kLd, int kVec>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int row, int row_end, int col0,
                                          int cols) {
  constexpr int kChunks = kDepth * 128 / kVec / kThreads;
#pragma unroll
  for (int l = 0; l < kChunks; ++l) {
    const int c = threadIdx.x + l * kThreads;
    const int rr = c / (128 / kVec), cc = (c % (128 / kVec)) * kVec;
    const int r = row + rr, col = col0 + cc;
    const int n_in = r < row_end ? max(0, min(kVec, cols - col)) : 0;
    const T* p = n_in ? src + static_cast<long long>(r) * cols + col : src;
    T* d = dst + rr * kLd + cc;
    if constexpr (kVec * sizeof(T) == 16)
      sm90::cp_async16(d, p, static_cast<int>(sizeof(T)) * n_in);
    else if constexpr (sizeof(T) == 4)
      sm90::cp_async4(d, p, 4 * n_in);
    else
      *d = n_in ? *p : __float2bfloat16_rn(0.f);
  }
}

// A warp's 64 x 32 sums (mma.sync's fragments: acc[i][j][e] at row 16i +
// lane / 4 + 8·(e / 2), column 8j + 2·(lane % 4) + e % 2 of its piece)
// written to the unit's tile: rounded to T in dw[g], or float32 in its
// workspace slot; rows past K and columns past N are not stored.
template <typename T>
__device__ __forceinline__ void store_mma(
    const float (&acc)[kWM / 16][kWN / 8][4], const Unit& w, int K, int N,
    float* __restrict__ ws, T* __restrict__ dw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const long long base = unit_base(w, K, N);
  const bool pairs = N % 2 == 0;  // two columns a store
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int n = w.n0 + wn * kWN + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = w.k0 + wm * kWM + 16 * i + gr + 8 * h;
        if (k >= K || n >= N) continue;
        const long long at = base + static_cast<long long>(k) * N + n;
        const float a = acc[i][j][2 * h], b = acc[i][j][2 * h + 1];
        if (w.slot >= 0) {
          if (pairs) {
            *reinterpret_cast<float2*>(ws + at) = make_float2(a, b);
          } else {
            ws[at] = a;
            if (n + 1 < N) ws[at + 1] = b;
          }
        } else if constexpr (sizeof(T) == 2) {
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dw + at) =
                __floats2bfloat162_rn(a, b);
          } else {
            dw[at] = from_float<T>(a);
            if (n + 1 < N) dw[at + 1] = from_float<T>(b);
          }
        } else {
          if (pairs) {
            *reinterpret_cast<float2*>(dw + at) = make_float2(a, b);
          } else {
            dw[at] = a;
            if (n + 1 < N) dw[at + 1] = b;
          }
        }
      }
    }
}

// ---- float32: 3xTF32 ------------------------------------------------------
template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
gg_dw_tf32(const float* __restrict__ x, const float* __restrict__ dy,
           int4* plan, int K, int N, int tiles_n, int tiles,
           float* __restrict__ ws, float* __restrict__ dw) {
  extern __shared__ __align__(16) float smem_dw32[];
  __shared__ int next[2];  // a unit's successor, by the units' parity
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  // everything above ran beside the prologue; the plan from here
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int n_units = __ldcg(&plan[0].x) * tiles;
  for (int u = blockIdx.x, i = 0; u < n_units; ++i) {
    const Unit w = unit_at(plan, u, tiles, tiles_n);
    float acc[kWM / 16][kWN / 8][4];
#pragma unroll
    for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int n_s = (w.r1 - w.r0 + kDepth32 - 1) / kDepth32;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_s) {
        float* st = smem_dw32 + s * 2 * kTile32;
        load_rows<float, kDepth32, kLd32, kVec>(st, x, w.r0 + s * kDepth32,
                                                w.r1, w.k0, K);
        load_rows<float, kDepth32, kLd32, kVec>(
            st + kTile32, dy, w.r0 + s * kDepth32, w.r1, w.n0, N);
      }
      sm90::cp_async_commit();
    }
    for (int s = 0; s < n_s; ++s) {
      sm90::cp_async_wait<kStages - 2>();  // stage s has landed
      __syncthreads();  // ... for every thread, and stage s - 1 is free
      const int next = s + kStages - 1;
      if (next < n_s) {
        float* st = smem_dw32 + (next % kStages) * 2 * kTile32;
        load_rows<float, kDepth32, kLd32, kVec>(
            st, x, w.r0 + next * kDepth32, w.r1, w.k0, K);
        load_rows<float, kDepth32, kLd32, kVec>(
            st + kTile32, dy, w.r0 + next * kDepth32, w.r1, w.n0, N);
      }
      sm90::cp_async_commit();
      const float* xs = smem_dw32 + (s % kStages) * 2 * kTile32 + wm * kWM;
      const float* ys =
          smem_dw32 + (s % kStages) * 2 * kTile32 + kTile32 + wn * kWN;
      float part[kWM / 16][kWN / 8][4];
#pragma unroll
      for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kDepth32 / 8; ++ks) {
        // a = xᵀ: (m, k) is x's (row 8ks + k, column m); slots t and t + 4
        // of the k8 step hold rows 2t and 2t + 1, in a and b alike
        uint32_t a_hi[kWM / 16][4], a_lo[kWM / 16][4];
#pragma unroll
        for (int i = 0; i < kWM / 16; ++i) {
          const float* ap = xs + (8 * ks + 2 * t) * kLd32 + 16 * i + gr;
          sm90::split_tf32(ap[0], a_hi[i][0], a_lo[i][0]);
          sm90::split_tf32(ap[8], a_hi[i][1], a_lo[i][1]);
          sm90::split_tf32(ap[kLd32], a_hi[i][2], a_lo[i][2]);
          sm90::split_tf32(ap[kLd32 + 8], a_hi[i][3], a_lo[i][3]);
        }
#pragma unroll
        for (int j = 0; j < kWN / 8; ++j) {
          const float* bp = ys + (8 * ks + 2 * t) * kLd32 + 8 * j + gr;
          uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
          sm90::split_tf32(bp[0], b_hi0, b_lo0);
          sm90::split_tf32(bp[kLd32], b_hi1, b_lo1);
#pragma unroll
          for (int i = 0; i < kWM / 16; ++i)
            sm90::mma_3xtf32(part[i][j], a_hi[i], a_lo[i], b_hi0, b_hi1,
                             b_lo0, b_lo1);
        }
      }
#pragma unroll
      for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    sm90::cp_async_wait<0>();
    if (threadIdx.x == 0) next[i & 1] = next_unit(plan);
    __syncthreads();  // the ring is free for the next unit, `next` written
    u = next[i & 1];
    store_mma<float>(acc, w, K, N, ws, dw);
  }
}

// ---- bf16: mma.sync m16n8k16, float32 sums --------------------------------
template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
gg_dw_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy,
           int4* plan, int K, int N, int tiles_n, int tiles,
           float* __restrict__ ws, bf16* __restrict__ dw) {
  extern __shared__ __align__(16) unsigned char smem_dw16_raw[];
  __shared__ int next[2];  // a unit's successor, by the units' parity
  bf16* smem = reinterpret_cast<bf16*>(smem_dw16_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mat = lane / 8;
  const int wm = warp / 4, wn = warp % 4;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int n_units = __ldcg(&plan[0].x) * tiles;
  for (int u = blockIdx.x, i = 0; u < n_units; ++i) {
    const Unit w = unit_at(plan, u, tiles, tiles_n);
    float acc[kWM / 16][kWN / 8][4], part[kWM / 16][kWN / 8][4];
#pragma unroll
    for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = acc[i][j][e] = 0.f;

    const int n_s = (w.r1 - w.r0 + kDepth16 - 1) / kDepth16;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_s) {
        bf16* st = smem + s * 2 * kTile16;
        load_rows<bf16, kDepth16, kLd16, kVec>(st, x, w.r0 + s * kDepth16,
                                               w.r1, w.k0, K);
        load_rows<bf16, kDepth16, kLd16, kVec>(
            st + kTile16, dy, w.r0 + s * kDepth16, w.r1, w.n0, N);
      }
      sm90::cp_async_commit();
    }
    for (int s = 0; s < n_s; ++s) {
      sm90::cp_async_wait<kStages - 2>();  // stage s has landed
      __syncthreads();  // ... for every thread, and stage s - 1 is free
      const int next = s + kStages - 1;
      if (next < n_s) {
        bf16* st = smem + (next % kStages) * 2 * kTile16;
        load_rows<bf16, kDepth16, kLd16, kVec>(
            st, x, w.r0 + next * kDepth16, w.r1, w.k0, K);
        load_rows<bf16, kDepth16, kLd16, kVec>(
            st + kTile16, dy, w.r0 + next * kDepth16, w.r1, w.n0, N);
      }
      sm90::cp_async_commit();
      const bf16* xs = smem + (s % kStages) * 2 * kTile16 + wm * kWM;
      const bf16* ys =
          smem + (s % kStages) * 2 * kTile16 + kTile16 + wn * kWN;
#pragma unroll
      for (int ks = 0; ks < kDepth16 / 16; ++ks) {
        // A = xᵀ by ldmatrix.trans of x's rows: matrix m holds columns
        // 8·(m & 1) of the m16 tile at rows 8·(m >> 1) of the k16 step
        uint32_t a[kWM / 16][4];
#pragma unroll
        for (int i = 0; i < kWM / 16; ++i)
          sm90::ldmatrix_x4_trans(a[i], sm90::smem_addr(
              xs + (16 * ks + 8 * (mat >> 1) + lane % 8) * kLd16 + 16 * i +
              8 * (mat & 1)));
#pragma unroll
        for (int jj = 0; jj < kWN / 16; ++jj) {
          uint32_t b[4];  // {rows 0-7, 8-15} of columns 0-7, then of 8-15
          sm90::ldmatrix_x4_trans(b, sm90::smem_addr(
              ys + (16 * ks + 8 * (mat & 1) + lane % 8) * kLd16 + 16 * jj +
              8 * (mat >> 1)));
#pragma unroll
          for (int i = 0; i < kWM / 16; ++i) {
            sm90::mma_bf16(part[i][2 * jj], a[i], b[0], b[1]);
            sm90::mma_bf16(part[i][2 * jj + 1], a[i], b[2], b[3]);
          }
        }
      }
      if ((s + 1) % kFoldStages == 0 || s == n_s - 1) {  // fold the sum
#pragma unroll
        for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
          for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][j][e] += part[i][j][e];
              part[i][j][e] = 0.f;
            }
      }
    }
    sm90::cp_async_wait<0>();
    if (threadIdx.x == 0) next[i & 1] = next_unit(plan);
    __syncthreads();  // the ring is free for the next unit, `next` written
    u = next[i & 1];
    store_mma<bf16>(acc, w, K, N, ws, dw);
  }
}

// ---- bf16 on Hopper: TMA + wgmma, both operands MN-major -------------------
// Named barrier 1 + wg: the 128 threads of consumer warpgroup wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Rows [valid, 64) of a box of 64 128-byte lines zeroed by the warpgroup
// (a swizzled row is one whole line, whatever the swizzle), then made
// visible to the tensor core's reads (the async proxy) before any thread
// of the warpgroup issues its products.
__device__ __forceinline__ void zero_rows(uint8_t* box, int valid, int wg) {
  for (int i = valid * 8 + static_cast<int>(threadIdx.x % 128);
       i < kDepth16 * 8; i += 128)
    *reinterpret_cast<uint4*>(box + 16 * i) = make_uint4(0, 0, 0, 0);
  sm90::fence_proxy_async();
  warpgroup_sync(wg);
}

// A consumer warpgroup's 64 x 128 sums (wgmma's accumulator layout: d[4j +
// e] at row 16·warp + lane / 4 + 8·(e / 2), column 8j + 2·(lane % 4) + e %
// 2) written to its 64 rows of the unit's tile: bf16 pairs into dw[g] or
// float32 pairs into the chunk's workspace slot; rows past K and columns
// past N are not stored (N is a multiple of 8: a pair is whole).
__device__ __forceinline__ void store_wgmma(const float (&acc)[64],
                                            const Unit& w, int wg, int K,
                                            int N, float* __restrict__ ws,
                                            bf16* __restrict__ dw) {
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32;
  const int k_first = w.k0 + 64 * wg + 16 * wi + lane / 4;
  const int n_first = w.n0 + 2 * (lane % 4);
  const long long base = unit_base(w, K, N);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k_first + 8 * h, n = n_first + 8 * j;
      if (k >= K || n >= N) continue;
      const long long at = base + static_cast<long long>(k) * N + n;
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if (w.slot >= 0)
        *reinterpret_cast<float2*>(ws + at) = make_float2(a, b);
      else
        *reinterpret_cast<__nv_bfloat162*>(dw + at) =
            __floats2bfloat162_rn(a, b);
    }
}

// A consumer warp's release of stage s: one arrival on its empty barrier.
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&empty[s]);
}

// One persistent block an SM walks the plan's units. Warps 0-7 are the
// consumer warpgroups (warpgroup wg: the tile's K columns [64·wg, 64·wg +
// 64)), warps 8-11 the producer: one thread of it takes the units
// (`next_unit`), writes each stage's unit beside it (`units`: the
// consumers read it there, not from L2), and issues its TMA loads,
// running ahead into the next unit's stages; a unit of no rows is one
// stage with no loads, the walk's end a stage of group -1. x and dy are
// 2-D maps (K, M) and (N, M) read in boxes of 64 x 64; rows past M read as
// zeros. A unit's stores run while the next unit's first sum is on the
// tensor cores.
__global__ void __launch_bounds__(kSmThreads, 1)
gg_dw_sm90(const __grid_constant__ CUtensorMap x_map,
           const __grid_constant__ CUtensorMap dy_map, int4* plan, int K,
           int N, int tiles_n, int tiles, float* __restrict__ ws,
           bf16* __restrict__ dw) {
  extern __shared__ uint8_t smem_dw_sm90_raw[];
  __shared__ __align__(8) uint64_t full[kSmStages], empty[kSmStages];
  __shared__ Unit units[kSmStages];  // the unit each stage belongs to
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_dw_sm90_raw) + 1023) &
      ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSmStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // everything above ran beside the prologue (`dw_plan`); the plan from
  // here, read through L2
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  if (warp >= 8) {  // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      const int n_units = __ldcg(&plan[0].x) * tiles;
      int s = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x;; u = next_unit(plan)) {
        const Unit w = u < n_units ? unit_at(plan, u, tiles, tiles_n)
                                   : Unit{-1, 0, 0, 0, 0, 0};
        const int n_s = (w.r1 - w.r0 + kDepth16 - 1) / kDepth16;
        for (int si = 0; si < max(n_s, 1); ++si) {
          sm90::mbar_wait(&empty[s], phase ^ 1);
          units[s] = w;  // published by the arrival below
          if (n_s == 0) {  // no rows, or the end: a stage with no loads
            sm90::mbar_arrive(&full[s]);
          } else {
            const int row = w.r0 + si * kDepth16;
            uint8_t* st = ring + s * kSmStageBytes;
            sm90::mbar_expect_tx(&full[s], kSmStageBytes);
            sm90::tma_load_2d(st, &x_map, &full[s], w.k0, row);
            sm90::tma_load_2d(st + kBoxBytes, &x_map, &full[s], w.k0 + 64,
                              row);
            sm90::tma_load_2d(st + 2 * kBoxBytes, &dy_map, &full[s], w.n0,
                              row);
            sm90::tma_load_2d(st + 3 * kBoxBytes, &dy_map, &full[s],
                              w.n0 + 64, row);
          }
          if (++s == kSmStages) {
            s = 0;
            phase ^= 1;
          }
        }
        if (w.g < 0) break;
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4;
    // the two warpgroups add their sums half a sum apart, so one keeps the
    // tensor cores busy while the other waits and adds
    const int shift = wg * (kFoldStages / 2);
    const uint32_t ring_base = sm90::smem_addr(ring);
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = acc[i] = 0.f;
    Unit last = {-1, 0, 0, 0, 0, 0};  // the unit whose sums `acc` holds
    int s = 0;
    uint32_t phase = 0;
    for (;;) {
      sm90::mbar_wait(&full[s], phase);  // the unit's first stage
      const Unit w = units[s];
      if (w.g < 0) break;
      const int n_s = (w.r1 - w.r0 + kDepth16 - 1) / kDepth16;
      if (n_s == 0) {  // an empty group's unit: its stage, then zeros
        release(empty, s, lane);
        if (++s == kSmStages) {
          s = 0;
          phase ^= 1;
        }
        if (last.g >= 0) store_wgmma(acc, last, wg, K, N, ws, dw);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        last = w;
        continue;
      }
      // one sum at a time: its stages' products into `part` (the first
      // with the scale of d at 0), each stage released once the next one's
      // products are issued; then the sum added into `acc`. No branch
      // reads or waits on the wgmma registers (ptxas would serialize the
      // products).
      for (int s0 = 0; s0 < n_s;) {
        const int s1 = min(n_s, (s0 + shift) / kFoldStages * kFoldStages +
                                    kFoldStages - shift);
        int held = -1;  // a stage whose products may still be running
        for (int si = s0; si < s1; ++si) {
          sm90::mbar_wait(&full[s], phase);
          const int valid = w.r1 - w.r0 - si * kDepth16;
          if (valid < kDepth16)  // the chunk's end: the next group's rows
            zero_rows(ring + s * kSmStageBytes + wg * kBoxBytes, valid, wg);
          // A = xᵀ (this warpgroup's box) and B = dy (two boxes 8 KB
          // apart), MN-major: 16 rows (2 KB) a k16 step, 8 rows 1024 B
          // apart, column blocks of 64 kBoxBytes apart
          const uint32_t a = ring_base + s * kSmStageBytes + wg * kBoxBytes;
          const uint32_t b = ring_base + s * kSmStageBytes + 2 * kBoxBytes;
          sm90::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kDepth16 / 16; ++ks)
            sm90::wgmma_ss_tt_n128(
                part, sm90::descriptor(a + 2048 * ks, kBoxBytes, 1024, 1),
                sm90::descriptor(b + 2048 * ks, kBoxBytes, 1024, 1),
                ks > 0 || si > s0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the previous stage's products are done
          if (held >= 0) release(empty, held, lane);
          held = s;
          if (++s == kSmStages) {
            s = 0;
            phase ^= 1;
          }
        }
        // the last unit's stores, beside this unit's first sum
        if (s0 == 0 && last.g >= 0) store_wgmma(acc, last, wg, K, N, ws, dw);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(part);
        release(empty, held, lane);
        const bool fresh = s0 == 0;  // a unit's first sum replaces `acc`
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = part[i] + (fresh ? 0.f : acc[i]);
        s0 = s1;
      }
      last = w;
    }
    if (last.g >= 0) store_wgmma(acc, last, wg, K, N, ws, dw);
  }
}

// Launch `kernel` on `blocks` blocks as the prologue's programmatic
// dependent: its blocks may start while `dw_plan` runs, and wait for the
// plan (`griddepcontrol.wait`). Its shared-memory opt-in is made once a
// device (`opted`: the caller's flags for this kernel).
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), bool* opted,
                             int device, int blocks, int threads, int smem,
                             cudaStream_t stream, Args... args) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted[device] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The three entry points share this: check the walk's numbers, plan,
// launch the kernel (`launch(plan, tiles_n, tiles)`), then add the split
// groups' partials where any group can be split (max_split > 0).
template <typename T, typename Launch>
int run_dw(int device, const int* sizes, int M, int K, int N, int G, int C,
           int max_chunks, int blocks, int max_split, int* plan_raw,
           float* ws, T* dw, cudaStream_t stream, Launch launch) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G <= 0 || K <= 0 || N <= 0) return 0;
  if (C < kSumDepth || C % kSumDepth != 0 || max_chunks < G || blocks <= 0 ||
      max_split < 0 || max_split > 65535 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int4* plan = reinterpret_cast<int4*>(plan_raw);
  dw_plan<<<1, kPlanThreads, 0, stream>>>(sizes, G, M, C, max_chunks, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_n = (N + kBN - 1) / kBN;
  err = launch(plan, tiles_n, (K + kBM - 1) / kBM * tiles_n);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_split > 0) {
    const long long kn = static_cast<long long>(K) * N;
    const long long bx = kn < 1024 * 256 ? (kn + 255) / 256 : 1024;
    dw_reduce<T><<<dim3(static_cast<unsigned>(bx),
                        static_cast<unsigned>(max_split), 1),
                   256, 0, stream>>>(plan, max_chunks, ws, kn, dw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dw[g] = x_gᵀ · dy_g: x (M, K) and dy (M, N) float32, contiguous, rows
// sorted by group; sizes (G,) int32 on the device; dw (G, K, N) float32,
// contiguous, fully written (3xTF32 products, float32 sums). The walk's
// numbers come from the host (`ops.dw_walk`): chunk_rows (C, a multiple of
// 256), max_chunks (G + ⌈M/C⌉), blocks (the persistent grid), max_split
// (groups that can exceed C; 0: none, no reduce). plan: (1 + max_chunks +
// 2G, 4) int32 scratch; ws: the split groups' float32 partials, (2⌈M/C⌉,
// K, N) where max_split > 0. vec16: x, dy, K and N allow 16-byte copies
// (the wrapper decides).
extern "C" int tdorch_grouped_gemm_dw(int device, const float* x,
                                      const float* dy, const int* sizes,
                                      int M, int K, int N, int G,
                                      int chunk_rows, int max_chunks,
                                      int blocks, int max_split, int vec16,
                                      int* plan, float* ws, float* dw,
                                      cudaStream_t stream) {
  static bool opted[2][64];  // a flag a device for each copy width
  const auto kernel = vec16 ? &gg_dw_tf32<4> : &gg_dw_tf32<1>;
  return run_dw<float>(
      device, sizes, M, K, N, G, chunk_rows, max_chunks, blocks, max_split,
      plan, ws, dw, stream, [&](int4* p, int tiles_n, int tiles) {
        return launch_dependent(kernel, opted[vec16 != 0], device, blocks,
                                kThreads, kSmem32, stream, x, dy, p, K, N,
                                tiles_n, tiles, ws, dw);
      });
}

// The same for bf16 x, dy and dw (`gg_dw_bf16`: exact bf16 products,
// float32 sums, dw rounded to bf16 once). vec16: 16-byte copies (8
// values).
extern "C" int tdorch_grouped_gemm_dw_bf16(int device, const void* x,
                                           const void* dy, const int* sizes,
                                           int M, int K, int N, int G,
                                           int chunk_rows, int max_chunks,
                                           int blocks, int max_split,
                                           int vec16, int* plan, float* ws,
                                           void* dw, cudaStream_t stream) {
  static bool opted[2][64];  // a flag a device for each copy width
  const auto kernel = vec16 ? &gg_dw_bf16<8> : &gg_dw_bf16<1>;
  bf16* out = static_cast<bf16*>(dw);
  return run_dw<bf16>(
      device, sizes, M, K, N, G, chunk_rows, max_chunks, blocks, max_split,
      plan, ws, out, stream, [&](int4* p, int tiles_n, int tiles) {
        return launch_dependent(kernel, opted[vec16 != 0], device, blocks,
                                kThreads, kSmem16, stream,
                                static_cast<const bf16*>(x),
                                static_cast<const bf16*>(dy), p, K, N,
                                tiles_n, tiles, ws, out);
      });
}

// The same through TMA and `wgmma` (`gg_dw_sm90`): x and dy 16-byte
// aligned, K and N multiples of 8 (the wrapper routes other bf16 operands
// to `gg_dw_bf16`, `ops.route_dw`).
extern "C" int tdorch_grouped_gemm_dw_sm90(int device, const void* x,
                                           const void* dy, const int* sizes,
                                           int M, int K, int N, int G,
                                           int chunk_rows, int max_chunks,
                                           int blocks, int max_split,
                                           int* plan, float* ws, void* dw,
                                           cudaStream_t stream) {
  if (K % 8 != 0 || N % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // x as (K, M) and dy as (N, M) in boxes of (64, 64); with no rows no unit
  // loads anything, and the maps stay unset
  CUtensorMap x_map, dy_map;
  std::memset(&x_map, 0, sizeof(x_map));
  std::memset(&dy_map, 0, sizeof(dy_map));
  if (M > 0 && K > 0 && N > 0) {
    const uint32_t box[2] = {64, kDepth16};
    const uint64_t x_dims[2] = {static_cast<uint64_t>(K),
                                static_cast<uint64_t>(M)};
    const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
    const uint64_t dy_dims[2] = {static_cast<uint64_t>(N),
                                 static_cast<uint64_t>(M)};
    const uint64_t dy_strides[1] = {static_cast<uint64_t>(N) * 2};
    cudaError_t err =
        sm90::make_map(&x_map, x, 2, x_dims, x_strides, box);
    if (err == cudaSuccess)
      err = sm90::make_map(&dy_map, dy, 2, dy_dims, dy_strides, box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  static bool opted[64];
  bf16* out = static_cast<bf16*>(dw);
  return run_dw<bf16>(
      device, sizes, M, K, N, G, chunk_rows, max_chunks, blocks, max_split,
      plan, ws, out, stream, [&](int4* p, int tiles_n, int tiles) {
        return launch_dependent(gg_dw_sm90, opted, device, blocks,
                                kSmThreads, kSmSmem, stream, x_map, dy_map,
                                p, K, N, tiles_n, tiles, ws, out);
      });
}
