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
// Design (a simple kernel first; speed is later work):
// - One block a (group, 128 x 128 tile of dw), the tiles of a group next to
//   each other in launch order (they share the group's rows in L2). The
//   block finds its group's first row by an exclusive scan of the clamped
//   sizes (one warp), then walks the rows in ring stages: the stage's rows
//   of x (its 128 columns of K) and of dy (its 128 columns of N) pass
//   through a ring of kStages shared-memory stages by `cp.async` (16-byte
//   copies where x, dy, K and N are 16-byte aligned, else one value a
//   load), rows past the group's end and columns past K or N as zeros.
// - The reduction runs over rows, so both operands are read down their
//   columns: bf16 `mma.sync` m16n8k16 with A (xᵀ) and B (dy) fragments by
//   `ldmatrix.trans`; float32 `mma.sync` m16n8k8 in 3xTF32 (hi·hi + hi·lo
//   + lo·hi, `sm90::mma_3xtf32`) with the fragments read from shared
//   memory by plain loads and split in registers (the depth of each k8
//   step permuted as in `gg_tf32`: a pair of rows 2t, 2t + 1).
// - 8 warps as 2 x 4, each a 64 x 32 piece of the tile.
// - Sums: the tensor core truncates the float32 sum it writes, by up to
//   2^-23 of it a k step, and a group at granite's training shape holds
//   ~4,096 rows (a hot expert many more). bf16: a sum stays on the tensor
//   core for kSumDepth = 256 rows (4 stages) and is then added into the
//   tile's float32 sums, as `gg_sm90` does over its depth; float32: each
//   32-row stage's products go into sums of their own, added to the tile's
//   after the stage, as `gg_tf32` does. dw is rounded to its dtype once.
// - No atomics: every element is summed by one thread in one order, so two
//   calls on the same inputs give the same bits (the trainer's restore is
//   checked bit for bit).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// ring stages.
constexpr int kSumDepth = 256;
constexpr int kFoldStages = kSumDepth / kDepth16;
constexpr int kLd32 = kBN + 4;  // float32 rows in shared memory
constexpr int kLd16 = kBN + 8;  // bf16 rows in shared memory: 272 bytes

static_assert(kBM == kBN, "x's and dy's stage rows are equally long");
static_assert(kBM == 2 * kWM && kBN == 4 * kWN, "8 warps as 2 x 4");
static_assert(kSumDepth % kDepth16 == 0, "whole ring stages a sum");
static_assert(kLd32 % 32 == 4, "rows 2t, 2t + 1 of a pair on other banks");
static_assert(kLd16 * 2 % 128 == 16, "ldmatrix rows 16 bytes apart mod 128");

constexpr int kTile32 = kDepth32 * kLd32;  // one operand's float32 stage
constexpr int kTile16 = kDepth16 * kLd16;
constexpr int kSmem32 = kStages * 2 * kTile32 * 4;  // 135,168 bytes
constexpr int kSmem16 = kStages * 2 * kTile16 * 2;  // 139,264 bytes

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

// The first and end row of group g: the clamped sizes' exclusive scan up
// to g (warp 0), cut at M.
__device__ __forceinline__ void group_rows(const int* __restrict__ sizes,
                                           int g, int M, int& r0, int& r1) {
  __shared__ long long start;
  if (threadIdx.x < 32) {
    long long v = 0;
    for (int i = threadIdx.x; i < g; i += 32) v += max(sizes[i], 0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) start = v;
  }
  __syncthreads();
  const long long a = min(start, static_cast<long long>(M));
  r0 = static_cast<int>(a);
  r1 = static_cast<int>(
      min(a + max(sizes[g], 0), static_cast<long long>(M)));
}

// dw[g]'s tile (k0, n0) for block b: group b / tiles_per_group, then the
// tile's row of tiles and column.
__device__ __forceinline__ void block_tile(int tiles_n, int tiles_per_group,
                                           int& g, int& k0, int& n0) {
  g = blockIdx.x / tiles_per_group;
  const int t = blockIdx.x % tiles_per_group;
  k0 = (t / tiles_n) * kBM;
  n0 = (t % tiles_n) * kBN;
}

// ---- float32: 3xTF32 ------------------------------------------------------
template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
gg_dw_tf32(const float* __restrict__ x, const float* __restrict__ dy,
           const int* __restrict__ sizes, int M, int K, int N, int tiles_n,
           int tiles_per_group, float* __restrict__ dw) {
  int g, k0, n0, r0, r1;
  block_tile(tiles_n, tiles_per_group, g, k0, n0);
  group_rows(sizes, g, M, r0, r1);
  extern __shared__ __align__(16) float smem_dw32[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  float acc[kWM / 16][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_s = (r1 - r0 + kDepth32 - 1) / kDepth32;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_s) {
      float* st = smem_dw32 + s * 2 * kTile32;
      load_rows<float, kDepth32, kLd32, kVec>(st, x, r0 + s * kDepth32, r1,
                                              k0, K);
      load_rows<float, kDepth32, kLd32, kVec>(st + kTile32, dy,
                                              r0 + s * kDepth32, r1, n0, N);
    }
    sm90::cp_async_commit();
  }
  for (int s = 0; s < n_s; ++s) {
    sm90::cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();  // ... for every thread, and stage s - 1 is free
    const int next = s + kStages - 1;
    if (next < n_s) {
      float* st = smem_dw32 + (next % kStages) * 2 * kTile32;
      load_rows<float, kDepth32, kLd32, kVec>(st, x, r0 + next * kDepth32,
                                              r1, k0, K);
      load_rows<float, kDepth32, kLd32, kVec>(
          st + kTile32, dy, r0 + next * kDepth32, r1, n0, N);
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

  float* out = dw + static_cast<long long>(g) * K * N;
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + wm * kWM + 16 * i + gr + 8 * (e / 2);
        const int n = n0 + wn * kWN + 8 * j + 2 * t + e % 2;
        if (k < K && n < N)
          out[static_cast<long long>(k) * N + n] = acc[i][j][e];
      }
}

// ---- bf16: mma.sync m16n8k16, float32 sums --------------------------------
template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
gg_dw_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy,
           const int* __restrict__ sizes, int M, int K, int N, int tiles_n,
           int tiles_per_group, bf16* __restrict__ dw) {
  int g, k0, n0, r0, r1;
  block_tile(tiles_n, tiles_per_group, g, k0, n0);
  group_rows(sizes, g, M, r0, r1);
  extern __shared__ __align__(16) unsigned char smem_dw16_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_dw16_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4, mat = lane / 8;
  const int wm = warp / 4, wn = warp % 4;
  float acc[kWM / 16][kWN / 8][4], part[kWM / 16][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = acc[i][j][e] = 0.f;

  const int n_s = (r1 - r0 + kDepth16 - 1) / kDepth16;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_s) {
      bf16* st = smem + s * 2 * kTile16;
      load_rows<bf16, kDepth16, kLd16, kVec>(st, x, r0 + s * kDepth16, r1,
                                             k0, K);
      load_rows<bf16, kDepth16, kLd16, kVec>(st + kTile16, dy,
                                             r0 + s * kDepth16, r1, n0, N);
    }
    sm90::cp_async_commit();
  }
  for (int s = 0; s < n_s; ++s) {
    sm90::cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();  // ... for every thread, and stage s - 1 is free
    const int next = s + kStages - 1;
    if (next < n_s) {
      bf16* st = smem + (next % kStages) * 2 * kTile16;
      load_rows<bf16, kDepth16, kLd16, kVec>(st, x, r0 + next * kDepth16,
                                             r1, k0, K);
      load_rows<bf16, kDepth16, kLd16, kVec>(
          st + kTile16, dy, r0 + next * kDepth16, r1, n0, N);
    }
    sm90::cp_async_commit();
    const bf16* xs = smem + (s % kStages) * 2 * kTile16 + wm * kWM;
    const bf16* ys = smem + (s % kStages) * 2 * kTile16 + kTile16 + wn * kWN;
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

  bf16* out = dw + static_cast<long long>(g) * K * N;
  const bool pairs = N % 2 == 0;  // two columns a 4-byte store
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int n = n0 + wn * kWN + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wm * kWM + 16 * i + gr + 8 * h;
        if (k >= K || n >= N) continue;
        bf16* dst = out + static_cast<long long>(k) * N + n;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          dst[0] = __float2bfloat16_rn(acc[i][j][2 * h]);
          if (n + 1 < N) dst[1] = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
        }
      }
    }
}

// Launch `kernel` over every (group, tile) with `smem` bytes of dynamic
// shared memory.
template <typename T>
cudaError_t launch_dw(void (*kernel)(const T*, const T*, const int*, int,
                                     int, int, int, int, T*),
                      int smem, const T* x, const T* dy, const int* sizes,
                      int M, int K, int N, int G, T* dw,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + kBN - 1) / kBN;
  const long long per_group =
      static_cast<long long>((K + kBM - 1) / kBM) * tiles_n;
  const long long blocks = per_group * G;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, dy, sizes, M, K, N, tiles_n, static_cast<int>(per_group), dw);
  return cudaGetLastError();
}

}  // namespace

// dw[g] = x_gᵀ · dy_g: x (M, K) and dy (M, N) float32, contiguous, rows
// sorted by group; sizes (G,) int32 on the device; dw (G, K, N) float32,
// contiguous, fully written (3xTF32 products, float32 sums). vec16: x,
// dy, K and N allow 16-byte copies (the wrapper decides).
extern "C" int tdorch_grouped_gemm_dw(int device, const float* x,
                                      const float* dy, const int* sizes,
                                      int M, int K, int N, int G, int vec16,
                                      float* dw, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 0 && K > 0 && N > 0) {
    err = launch_dw<float>(vec16 ? &gg_dw_tf32<4> : &gg_dw_tf32<1>, kSmem32,
                           x, dy, sizes, M, K, N, G, dw, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same for bf16 x, dy and dw: exact bf16 products, float32 sums, dw
// rounded to bf16 once. vec16: 16-byte copies (8 values).
extern "C" int tdorch_grouped_gemm_dw_bf16(int device, const void* x,
                                           const void* dy, const int* sizes,
                                           int M, int K, int N, int G,
                                           int vec16, void* dw,
                                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 0 && K > 0 && N > 0) {
    err = launch_dw<bf16>(vec16 ? &gg_dw_bf16<8> : &gg_dw_bf16<1>, kSmem16,
                          static_cast<const bf16*>(x),
                          static_cast<const bf16*>(dy), sizes, M, K, N, G,
                          static_cast<bf16*>(dw), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
