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
// are cut. float32 operands, float32 accumulation. w may be a strided view
// (dense rows of N, any group and row stride), so a caller can pass slices
// of a wider weight row without copying them.
//
// What bounds it on this card: at decode sizes, memory. Each expert's
// weight block (K x N) is read once per row tile of that expert, and a
// decode step gives an expert a few dozen rows, so the weights dominate the
// bytes (a 1,024-row in-projection over 40 experts reads 252 MB of weights
// and 6 MB of activations). At prefill sizes (tens of thousands of rows)
// it is the float32 arithmetic.
//
// Design: the prologue (`gg_plan`, one block) takes an exclusive scan of
// the clamped group sizes and of ceil(size / kBM), and writes one entry per
// row tile: (group, first row, end row). The tiles of the zero tail follow
// with group -1, and the rest of the worst-case grid of ceil(M/kBM) + G
// tiles with -2, whose blocks exit at once. The main kernel (`gg_tile`)
// gives each block one kBM x kBN output tile; x and w[g] pass through
// shared memory in slices of kBK along K, and each of the 256 threads keeps
// a 4 x 4 register block of sums in float32 FMA. Every load and store is
// bounds-checked, so any M, K and N work.
//
// Later work, not done here: TF32 or bf16 tensor cores through wgmma, TMA
// loads into a ring of shared-memory stages, and a persistent schedule.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;  // rows of a tile
constexpr int kBN = 64;  // columns of a tile
constexpr int kBK = 16;  // depth of one shared-memory slice
constexpr int kTM = 4;   // rows of a thread's register block
constexpr int kTN = 4;   // columns of a thread's register block
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPlanThreads = 1024;

static_assert(kBM * kBK % kThreads == 0, "x slice must split evenly");
static_assert(kBK * kBN % kThreads == 0, "w slice must split evenly");

// Inclusive scan of one value per thread over the block (Hillis-Steele).
// Leaves the block's total in buf[blockDim.x - 1]; the caller synchronizes
// before `buf` is used again.
__device__ long long block_inclusive_scan(long long v, long long* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const long long add = threadIdx.x >= off ? buf[threadIdx.x - off] : 0;
    __syncthreads();
    buf[threadIdx.x] += add;
    __syncthreads();
  }
  return buf[threadIdx.x];
}

// plan[t] = (group, first row, end row, 0) for t in [0, num_tiles); group
// -1 marks a tile of the zero tail, -2 a tile with no rows.
__global__ void gg_plan(const int* __restrict__ sizes, int G, int M,
                        int num_tiles, int4* __restrict__ plan) {
  __shared__ long long buf[kPlanThreads];
  long long row_carry = 0, tile_carry = 0;  // the same in every thread
  for (int base = 0; base < G; base += kPlanThreads) {
    const int g = base + threadIdx.x;
    const long long s = g < G ? max(sizes[g], 0) : 0;
    const long long rows_incl = row_carry + block_inclusive_scan(s, buf);
    const long long rows_total = buf[kPlanThreads - 1];
    __syncthreads();
    const long long r0 = min(rows_incl - s, static_cast<long long>(M));
    const long long r1 = min(rows_incl, static_cast<long long>(M));
    const long long t = (r1 - r0 + kBM - 1) / kBM;
    const long long tiles_incl = tile_carry + block_inclusive_scan(t, buf);
    const long long tiles_total = buf[kPlanThreads - 1];
    __syncthreads();
    for (long long j = 0; j < t; ++j) {
      const long long tile = tiles_incl - t + j;
      if (tile < num_tiles) {
        plan[tile] = make_int4(g, static_cast<int>(r0 + j * kBM),
                               static_cast<int>(min(r0 + (j + 1) * kBM, r1)),
                               0);
      }
    }
    row_carry += rows_total;
    tile_carry += tiles_total;
  }
  const long long z0 = min(row_carry, static_cast<long long>(M));
  const long long zero_tiles = (M - z0 + kBM - 1) / kBM;
  for (long long tile = tile_carry + threadIdx.x; tile < num_tiles;
       tile += blockDim.x) {
    const long long j = tile - tile_carry;
    plan[tile] = j < zero_tiles
        ? make_int4(-1, static_cast<int>(z0 + j * kBM),
                    static_cast<int>(min(z0 + (j + 1) * kBM,
                                         static_cast<long long>(M))), 0)
        : make_int4(-2, 0, 0, 0);
  }
}

// One kBM x kBN tile of y = x[rows] @ w[g]; blockIdx.x is the row tile,
// blockIdx.y the column tile.
__global__ void __launch_bounds__(kThreads)
gg_tile(const float* __restrict__ x, const float* __restrict__ w,
        long long w_group_stride, long long w_row_stride,
        const int4* __restrict__ plan, int K, int N, float* __restrict__ y) {
  const int4 p = plan[blockIdx.x];
  const int g = p.x, row0 = p.y, row_end = p.z;
  if (g == -2) return;
  const int n0 = blockIdx.y * kBN;
  if (g == -1) {
    for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
      const int r = row0 + i / kBN, c = n0 + i % kBN;
      if (r < row_end && c < N) y[static_cast<long long>(r) * N + c] = 0.f;
    }
    return;
  }
  // x slice k-major, padded so the 16-byte row reads stay aligned and the
  // transposing stores spread over the banks
  __shared__ __align__(16) float xs[kBK][kBM + 4];
  __shared__ __align__(16) float ws[kBK][kBN];
  const float* wg = w + g * w_group_stride;
  const int tx = threadIdx.x % (kBN / kTN);  // column lane: tx + 16 j
  const int ty = threadIdx.x / (kBN / kTN);  // row block: 4 ty + i
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kBM * kBK / kThreads; ++l) {
      const int i = threadIdx.x + l * kThreads;
      const int r = i / kBK, kk = i % kBK;
      const int row = row0 + r, k = k0 + kk;
      xs[kk][r] = (row < row_end && k < K)
          ? x[static_cast<long long>(row) * K + k] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kBK * kBN / kThreads; ++l) {
      const int i = threadIdx.x + l * kThreads;
      const int kk = i / kBN, c = i % kBN;
      const int k = k0 + kk, n = n0 + c;
      ws[kk][c] = (k < K && n < N) ? wg[k * w_row_stride + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + j * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx + j * (kBN / kTN);
      if (c < N) y[static_cast<long long>(r) * N + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int tdorch_grouped_gemm_tile_rows() { return kBM; }

// x: (M, K) float32, rows sorted by group; w: (G, K, N) float32, element
// (g, k, n) at w[g * w_group_stride + k * w_row_stride + n]; sizes: (G,)
// int32 on the device; plan: (num_tiles, 4) int32 scratch with num_tiles =
// ceil(M / kBM) + G; y: (M, N) float32, fully written.
extern "C" int tdorch_grouped_gemm(int device, const float* x, const float* w,
                                   long long w_group_stride,
                                   long long w_row_stride, const int* sizes,
                                   int M, int K, int N, int G, int num_tiles,
                                   int* plan, float* y, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M > 0 && N > 0 && num_tiles > 0) {
    int4* plan4 = reinterpret_cast<int4*>(plan);
    gg_plan<<<1, kPlanThreads, 0, stream>>>(sizes, G, M, num_tiles, plan4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(num_tiles, (N + kBN - 1) / kBN);
    gg_tile<<<grid, kThreads, 0, stream>>>(x, w, w_group_stride,
                                           w_row_stride, plan4, K, N, y);
  }
  return static_cast<int>(cudaGetLastError());
}
