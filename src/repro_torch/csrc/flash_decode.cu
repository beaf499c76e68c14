// Single-token GQA decode attention over a long KV cache, for Hopper
// (sm_90a): split-K flash-decoding, SIMT in float32 (`fd_split`) and on
// tensor cores over a TMA-fed cache stream in bf16 (`fd_sm90`).
//
// Replaces the TPU kernel `flash_decode` in
// src/repro/kernels/flash_decode/kernel.py:60 (`_decode_kernel`), whose
// grid (B, KV, T / block_t) walked the cache tiles in order on one core,
// carrying the online-softmax state (m, l, acc) in VMEM from tile to tile.
//
// out[b, h] = softmax(q[b, h] · K[b, :, h / G]ᵀ · hd^-0.5) · V[b, :, h / G]
// over the T positions of the cache, where positions at or beyond `length`
// get the finite score -2.0e38, as in the TPU kernel: with length <= 0
// every position ties and the result is the mean of V over the cache.
// float32 or bfloat16 q and caches; float32 scores, softmax and sums; the
// output in the inputs' type.
//
// What bounds it on this card: bytes. A decode step reads the whole valid
// prefix of both caches once and does 4 FLOPs per cached element and
// query head of its group (2 for q·k, 2 for p·v): a tinyllama step (G = 8)
// does 2 FLOPs per byte of float32 cache (8 of bf16), a zamba2 step (G =
// 1) 0.25 (1), far below the card's 20 float32 or 295 bf16 FLOPs per
// byte. So the design is about streaming the cache at the memory's rate:
// - One block serves every query head of its KV head (up to kGroupMax at
//   a time in float32, 16 in bf16), so the cache is read once, as the TPU
//   kernel's (G, hd) q block did; one block per query head would read a
//   tinyllama cache 8 times.
// - B·KV blocks alone do not fill 132 SMs (zamba2's long_500k decode has
//   B·KV = 32), so T is cut into splits, one block each (the grid's
//   x axis), sized by the wrapper to give some 16 blocks an SM. Each
//   block writes its split's (m, l, acc) per query head; a second launch
//   (`fd_combine`) merges the splits and divides by max(l, 1e-30), as the
//   TPU kernel's last step does (kernel.py:56).
// - `length` is read on the device when the caller passes it as a
//   tensor: no host sync. Positions past min(length, T) are not read
//   (their weight exp(-2e38 - m) is exactly 0 in float32), unless
//   length <= 0, where all T are.
// float32, `fd_split`: each lane loads 4 consecutive elements of a cache
// row (16 bytes), hd / 4 lanes share a row and a warp reads 128 / hd rows
// at once, kUnroll row groups ahead of the arithmetic; the q·k partial
// sums meet by xor shuffles within the row's lanes, and each row slot
// keeps its own (m, l, acc), merged by shuffles and then across warps
// through shared memory at the end of the split.
// bf16, `fd_sm90`: done that way, bf16 was bound by instruction issue, not
// bytes (every lane of a row ran the row's shuffles and exponentials for
// every query head). Here the G <= 16 query heads of a KV head are the 16
// rows of `mma.sync` m16n8k16 (bf16 in, float32 sums; `wgmma`'s 64-row
// minimum would waste most of its rows at G <= 16, and at ~8 FLOPs per
// byte the warp-level rate is ample). A producer warp streams K and V
// tiles by TMA (4-D maps over (hd, KV, T, B), swizzled as `ldmatrix`
// reads them) into a ring of kRingStages stages with full and empty
// mbarriers: 64 KB in flight a block at hd 64, several blocks an SM. A
// block serves up to 4 neighbouring KV heads (when G <= 16), so a stage
// is one box of their rows of each position (4 x 128 bytes at hd 64, a
// whole cache row at tinyllama's 4 KV heads) rather than 128-byte pieces
// that other blocks read at other times. Each of 4 consumer warps takes
// 16 positions of one head a stage: S = Q·Kᵀ from K fragments by
// `ldmatrix`, each score scaled (base 2) and exponentiated once by the
// thread whose accumulator holds it, the row maximum and sum across the 4
// threads of a quad, and P·V with V's fragments by `ldmatrix.trans`. P is split into bf16 hi = bf16(p) and lo
// = bf16(p − hi), two products into the same float32 sums, so the weights
// keep ~2^-17 of their value (one bf16 rounding of p errs by 2^-9, past
// the bf16 gate; see flash_attention_sm90.cu).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr float kMasked = -2.0e38f;  // score of a position >= length
constexpr float kEmpty = -3.0e38f;   // running max of a state with no row
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 2;  // row groups a lane loads before it computes
constexpr int kGroupMax = 8;

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Merge the softmax state (mo, lo, acco) into (m, l, acc).
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float mo, float lo, const float* acco) {
  const float mn = fmaxf(m, mo);
  const float a = expf(m - mn), ao = expf(mo - mn);
  l = l * a + lo * ao;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + acco[e] * ao;
  m = mn;
}

// One block per (split of T, KV head x group of NG query heads, batch row).
// part_ml[(bh * splits + split) * 2 + {0, 1}] = (m, l) and
// part_acc[(bh * splits + split) * HD + d] = acc[d] of query head bh.
template <int HD, int NG>
__global__ void __launch_bounds__(kThreads)
fd_split(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const long long* __restrict__ len_ptr,
         long long len_val, int Tn, int KV, int G, int split_len,
         float scale, float* __restrict__ part_ml,
         float* __restrict__ part_acc) {
  constexpr int kLanesPerRow = HD / 4;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kStep = kWarps * kUnroll * kRowsPerWarp;
  static_assert(HD % 4 == 0 && 32 % kLanesPerRow == 0, "unsupported hd");
  __shared__ float s_ml[kWarps][NG][2];
  __shared__ float s_acc[kWarps][NG][HD];

  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = (G + NG - 1) / NG;
  const int kv = blockIdx.y / groups, g0 = (blockIdx.y % groups) * NG;
  const int ng = min(NG, G - g0);
  const int H = KV * G, splits = gridDim.x;
  const long long length = len_ptr != nullptr ? *len_ptr : len_val;
  const bool all_masked = length <= 0;
  const int n_valid = all_masked ? Tn
                                 : static_cast<int>(min(length,
                                                        (long long)Tn));
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, n_valid);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / kLanesPerRow, d0 = (lane % kLanesPerRow) * 4;
  const int h0 = kv * G + g0;

  float qr[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g < ng) {
      load4(q + (static_cast<long long>(b) * H + h0 + g) * HD + d0, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[g][e] = 0.f;
    }
  }
  float m[NG], l[NG], acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = kEmpty;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  const long long row_stride = static_cast<long long>(KV) * HD;
  const long long base_off =
      (static_cast<long long>(b) * Tn * KV + kv) * HD + d0;
  for (int base = t_begin + warp * kUnroll * kRowsPerWarp; base < t_end;
       base += kStep) {
    float kr[kUnroll][4], vr[kUnroll][4];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * kRowsPerWarp + slot;
      ok[u] = t < t_end;
      if (ok[u]) {
        load4(k + base_off + t * row_stride, kr[u]);
        load4(v + base_off + t * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float s[kUnroll];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = qr[g][0] * kr[u][0];
#pragma unroll
        for (int e = 1; e < 4; ++e) part = fmaf(qr[g][e], kr[u][e], part);
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u] = !ok[u] ? -INFINITY : all_masked ? kMasked : part * scale;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[u] - mx);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // merge the warp's row slots (lanes kLanesPerRow apart), then the warps
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
      float other[4];
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        other[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      merge<4>(m[g], l[g], acc[g], mo, lo, other);
    }
    if (slot == 0) {
      if (d0 == 0) {
        s_ml[warp][g][0] = m[g];
        s_ml[warp][g][1] = l[g];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float mm = s_ml[0][g][0], ll = s_ml[0][g][1], aa = s_acc[0][g][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      merge<1>(mm, ll, &aa, s_ml[w][g][0], s_ml[w][g][1], &s_acc[w][g][d]);
    const long long row =
        (static_cast<long long>(b) * H + h0 + g) * splits + split;
    part_acc[row * HD + d] = aa;
    if (d == 0) {
      part_ml[row * 2] = mm;
      part_ml[row * 2 + 1] = ll;
    }
  }
}

// One block of HD threads per (batch row, query head): merge the splits.
// Base2: the splits' maxima are in base 2 (fd_sm90), else natural units.
template <typename T, bool Base2>
__global__ void fd_combine(const float* __restrict__ part_ml,
                           const float* __restrict__ part_acc, int splits,
                           int HD, T* __restrict__ out) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  float mx = kEmpty;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = Base2 ? exp2f(ml[2 * s] - mx) : expf(ml[2 * s] - mx);
    l = fmaf(ml[2 * s + 1], w, l);
    acc = fmaf(part_acc[(bh * splits + s) * HD + d], w, acc);
  }
  store(out + bh * HD + d, acc / fmaxf(l, 1e-30f));
}

template <int HD, int NG>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const long long* len_ptr, long long len_val, int B,
                   int Tn, int KV, int G, int splits, int split_len,
                   float scale, float* part_ml, float* part_acc, float* out,
                   cudaStream_t stream) {
  const dim3 grid(splits, KV * ((G + NG - 1) / NG), B);
  fd_split<HD, NG><<<grid, kThreads, 0, stream>>>(
      q, k, v, len_ptr, len_val, Tn, KV, G, split_len, scale, part_ml,
      part_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fd_combine<float, false><<<B * KV * G, HD, 0, stream>>>(
      part_ml, part_acc, splits, HD, out);
  return cudaGetLastError();
}

template <int HD>
cudaError_t by_group(int G, const float* q, const float* k, const float* v,
                     const long long* len_ptr, long long len_val, int B,
                     int Tn, int KV, int splits, int split_len, float scale,
                     float* part_ml, float* part_acc, float* out,
                     cudaStream_t stream) {
  // the smallest group width that holds G (G > 8 runs in groups of 8)
  if (G == 1)
    return launch<HD, 1>(q, k, v, len_ptr, len_val, B, Tn, KV, G, splits,
                         split_len, scale, part_ml, part_acc, out, stream);
  if (G == 2)
    return launch<HD, 2>(q, k, v, len_ptr, len_val, B, Tn, KV, G, splits,
                         split_len, scale, part_ml, part_acc, out, stream);
  if (G <= 4)
    return launch<HD, 4>(q, k, v, len_ptr, len_val, B, Tn, KV, G, splits,
                         split_len, scale, part_ml, part_acc, out, stream);
  return launch<HD, kGroupMax>(q, k, v, len_ptr, len_val, B, Tn, KV, G,
                               splits, split_len, scale, part_ml, part_acc,
                               out, stream);
}

// ---- bf16: tensor cores over a TMA-fed cache stream ----------------------
constexpr int kTK = 64;          // cache rows (position x KV head) a stage
constexpr int kRingStages = 4;
constexpr int kRows = 16;        // query heads a block: mma's m16
constexpr int kSm90Threads = 32 * kWarps + 32;  // 4 consumer warps + 1

template <int HD>
struct Ring {
  static constexpr int kRowBytes = HD * 2 < 128 ? HD * 2 : 128;  // swizzle
  static constexpr int kAtoms = HD * 2 / kRowBytes;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kTileBytes = kTK * HD * 2;  // one K or V tile
  static constexpr int kSmem = 1024 + 2 * kRingStages * kTileBytes;
  static_assert(kWarps * kRows * (HD + 2) * 4 <= 2 * kRingStages *
                                                     kTileBytes,
                "the warps' merge reuses the ring");
};

// Shared-memory address of 16-byte chunk `chunk` (of hd) of row `row`
// in a tile of kTK rows (position-major, then KV head) as TMA wrote it.
template <int HD>
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int row,
                                              int chunk) {
  using R = Ring<HD>;
  constexpr int kChunks = R::kRowBytes / 16;  // chunks a swizzled row
  return tile + (chunk / kChunks) * kTK * R::kRowBytes +
         sm90::swizzled<R::kRowBytes>(row, chunk % kChunks);
}

// One block per (KH KV heads x group of up to 16 query heads, split of
// T, batch row): warps 0-3 consume, warp 4 produces. A stage holds
// kTK / KH positions of the block's KH heads, read by TMA as one box, so
// the rows of neighbouring heads come in one piece (KH x 128 B at hd 64);
// each warp takes 16 positions of one head. Writes part_ml / part_acc as
// fd_split does.
template <int HD, int KH>
__global__ void __launch_bounds__(kSm90Threads)
fd_sm90(const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const __nv_bfloat16* __restrict__ q,
        const long long* __restrict__ len_ptr, long long len_val, int Tn,
        int KV, int G, int split_len, float scale_log2,
        float* __restrict__ part_ml, float* __restrict__ part_acc) {
  using R = Ring<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kRingStages], empty[kRingStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  constexpr int kPos = kTK / KH;        // positions a stage
  constexpr int kWarpsPerHead = kWarps / KH;
  static_assert(kPos == 16 * kWarpsPerHead, "16 positions a warp");
  const int split = blockIdx.y, b = blockIdx.z;
  const int groups = (G + kRows - 1) / kRows;
  const int kv0 = blockIdx.x / groups * KH;
  const int g0 = (blockIdx.x % groups) * kRows;
  const int ng = min(kRows, G - g0);
  const int H = KV * G, splits = gridDim.y;
  const long long length = len_ptr != nullptr ? *len_ptr : len_val;
  const bool all_masked = length <= 0;
  const int n_valid =
      all_masked ? Tn : static_cast<int>(min(length, (long long)Tn));
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, n_valid);
  const int n_tiles =
      t_end > t_begin ? (t_end - t_begin + kPos - 1) / kPos : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // ---- producer warp ----
    if (lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kRingStages;
        sm90::mbar_wait(&empty[s], ((j / kRingStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], 2 * R::kTileBytes);
        uint8_t* ks = ring + s * 2 * R::kTileBytes;
        uint8_t* vs = ks + R::kTileBytes;
        const int t0 = t_begin + j * kPos;
        for (int a = 0; a < R::kAtoms; ++a) {
          sm90::tma_load_4d(ks + a * kTK * R::kRowBytes, &k_map, &full[s],
                            a * R::kBoxCols, kv0, t0, b);
          sm90::tma_load_4d(vs + a * kTK * R::kRowBytes, &v_map, &full[s],
                            a * R::kBoxCols, kv0, t0, b);
        }
      }
    }
    return;
  }

  // ---- consumer warps: rows g and g + 8 of the 16 query heads ----
  const int head = warp / kWarpsPerHead, kv = kv0 + head;
  const int pos_w = (warp % kWarpsPerHead) * 16;  // the warp's positions
  const int g = lane / 4, t = lane % 4;
  uint32_t qa[HD / 16][4];  // A fragments of q, one a 16-wide slice of hd
  {
    const __nv_bfloat16* qb =
        q + (static_cast<long long>(b) * H + kv * G + g0) * HD + 2 * t;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e & 1), c = 16 * ks + 8 * (e >> 1);
        qa[ks][e] = r < ng ? *reinterpret_cast<const uint32_t*>(
                                 qb + r * HD + c)
                           : 0u;
      }
    }
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kEmpty, kEmpty}, l[2] = {0.f, 0.f};

  const uint32_t ring_base = sm90::smem_addr(ring);
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix: which 8x8, row
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kRingStages;
    sm90::mbar_wait(&full[s], (j / kRingStages) & 1);
    const uint32_t k_tile = ring_base + s * 2 * R::kTileBytes;
    const uint32_t v_tile = k_tile + R::kTileBytes;

    // S (16 heads x this warp's 16 positions) = Q · Kᵀ
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t kb[4];  // {positions 0-7, 8-15} x {hd lo 8, hi 8}
      sm90::ldmatrix_x4(
          kb, tile_addr<HD>(k_tile,
                            (pos_w + 8 * (mat >> 1) + mrow) * KH + head,
                            2 * ks + (mat & 1)));
      sm90::mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
      sm90::mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
    }

    // scale (base 2) and mask; each score is exponentiated once
    const int pos0 = t_begin + j * kPos + pos_w + 2 * t;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = pos0 + 8 * n + (e & 1) < t_end;
        float x = all_masked ? kMasked : sc[n][e] * scale_log2;
        sc[n][e] = ok ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      const float alpha = sm90::exp2_approx(m[r] - mx[r]);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[i][2 * r] *= alpha;
        acc[i][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
    }
    uint32_t p_hi[4], p_lo[4];  // A fragment: {row g, g + 8} x {2t, 8 + 2t}
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = sm90::exp2_approx(sc[n][e] - mx[e >> 1]);
        l[e >> 1] += p[e];
      }
      sm90::split_bf16x2(p[0], p[1], p_hi[2 * n], p_lo[2 * n]);
      sm90::split_bf16x2(p[2], p[3], p_hi[2 * n + 1], p_lo[2 * n + 1]);
    }

    // O += (P_hi + P_lo) · V, V's fragments transposed by ldmatrix
#pragma unroll
    for (int c = 0; c < HD / 8; c += 2) {
      uint32_t vb[4];  // {positions 0-7, 8-15} x {hd chunk c, c + 1}
      sm90::ldmatrix_x4_trans(
          vb, tile_addr<HD>(v_tile, (pos_w + 8 * (mat & 1) + mrow) * KH + head,
                            c + (mat >> 1)));
      sm90::mma_bf16(acc[c], p_hi, vb[0], vb[1]);
      sm90::mma_bf16(acc[c], p_lo, vb[0], vb[1]);
      sm90::mma_bf16(acc[c + 1], p_hi, vb[2], vb[3]);
      sm90::mma_bf16(acc[c + 1], p_lo, vb[2], vb[3]);
    }
    // the stage's reads (generic proxy) before the producer's next TMA
    // write to it (async proxy); without this fence TMA has been seen to
    // overwrite a stage under the last ldmatrix of its readers
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // the quad's partial sums, then the warps through shared memory (the
  // ring is free once every consumer warp has passed its last tile)
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
  float* s_acc = reinterpret_cast<float*>(ring);  // [kWarps][kRows][HD]
  float* s_ml = s_acc + kWarps * kRows * HD;      // [kWarps][kRows][2]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float* dst = s_acc + (warp * kRows + row) * HD + 2 * t;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      dst[8 * i] = acc[i][2 * r];
      dst[8 * i + 1] = acc[i][2 * r + 1];
    }
    if (t == 0) {
      s_ml[(warp * kRows + row) * 2] = m[r];
      s_ml[(warp * kRows + row) * 2 + 1] = l[r];
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
  for (int i = threadIdx.x; i < KH * ng * HD; i += 32 * kWarps) {
    const int hh = i / (ng * HD), row = i / HD % ng, d = i % HD;
    const int w0 = hh * kWarpsPerHead;  // the head's warps
    float mm = s_ml[(w0 * kRows + row) * 2];
    float ll = s_ml[(w0 * kRows + row) * 2 + 1];
    float aa = s_acc[(w0 * kRows + row) * HD + d];
#pragma unroll
    for (int w = w0 + 1; w < w0 + kWarpsPerHead; ++w) {
      const float mo = s_ml[(w * kRows + row) * 2];
      const float mn = fmaxf(mm, mo);
      const float a = sm90::exp2_approx(mm - mn);
      const float ao = sm90::exp2_approx(mo - mn);
      ll = ll * a + s_ml[(w * kRows + row) * 2 + 1] * ao;
      aa = aa * a + s_acc[(w * kRows + row) * HD + d] * ao;
      mm = mn;
    }
    const long long out_row =
        (static_cast<long long>(b) * H + (kv0 + hh) * G + g0 + row) *
            splits +
        split;
    part_acc[out_row * HD + d] = aa;
    if (d == 0) {  // m in base 2: fd_combine<..., true> weighs by exp2
      part_ml[out_row * 2] = mm;
      part_ml[out_row * 2 + 1] = ll;
    }
  }
}

template <int HD, int KH>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        const long long* len_ptr, long long len_val, int B,
                        int Tn, int KV, int G, int splits, int split_len,
                        float scale_log2, float* part_ml, float* part_acc,
                        void* out, cudaStream_t stream) {
  using R = Ring<HD>;
  CUtensorMap k_map, v_map;
  cudaError_t err = sm90::make_map(&k_map, k, HD, KV, Tn, B, R::kBoxCols,
                                   KH, kTK / KH);
  if (err == cudaSuccess)
    err = sm90::make_map(&v_map, v, HD, KV, Tn, B, R::kBoxCols, KH,
                         kTK / KH);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fd_sm90<HD, KH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             R::kSmem);
  if (err != cudaSuccess) return err;
  // KV heads fastest: blocks that run together read the same positions of
  // neighbouring heads, so the cache rows (all KV heads of a position) are
  // read whole, not in pieces far apart in time
  const dim3 grid(KV / KH * ((G + kRows - 1) / kRows), splits, B);
  fd_sm90<HD, KH><<<grid, kSm90Threads, R::kSmem, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), len_ptr, len_val,
      Tn, KV, G, split_len, scale_log2, part_ml, part_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fd_combine<__nv_bfloat16, true><<<B * KV * G, HD, 0, stream>>>(
      part_ml, part_acc, splits, HD, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

template <int HD>
cudaError_t by_heads_sm90(int KH, const void* q, const void* k,
                          const void* v, const long long* len_ptr,
                          long long len_val, int B, int Tn, int KV, int G,
                          int splits, int split_len, float scale_log2,
                          float* part_ml, float* part_acc, void* out,
                          cudaStream_t stream) {
  switch (KH) {
    case 1:
      return launch_sm90<HD, 1>(q, k, v, len_ptr, len_val, B, Tn, KV, G,
                                splits, split_len, scale_log2, part_ml,
                                part_acc, out, stream);
    case 2:
      return launch_sm90<HD, 2>(q, k, v, len_ptr, len_val, B, Tn, KV, G,
                                splits, split_len, scale_log2, part_ml,
                                part_acc, out, stream);
    case 4:
      return launch_sm90<HD, 4>(q, k, v, len_ptr, len_val, B, Tn, KV, G,
                                splits, split_len, scale_log2, part_ml,
                                part_acc, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, KV * G, HD); k, v: (B, T, KV, HD), all float32, contiguous and
// 16-byte aligned; HD 32, 64 or 128. length: *len_ptr (an int64 on the
// device) if len_ptr is not null, else len_val. part_ml: (B * KV * G,
// splits, 2) and part_acc: (B * KV * G, splits, HD) float32 scratch;
// split_len * splits >= T. out: (B, KV * G, HD) float32.
extern "C" int tdorch_flash_decode(int device, const void* q, const void* k,
                                   const void* v, const long long* len_ptr,
                                   long long len_val, int B, int Tn, int KV,
                                   int G, int HD, int splits, int split_len,
                                   float scale, float* part_ml,
                                   float* part_acc, void* out,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || KV == 0 || G == 0) return 0;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  switch (HD) {
    case 32:
      err = by_group<32>(G, qf, kf, vf, len_ptr, len_val, B, Tn, KV, splits,
                         split_len, scale, part_ml, part_acc, of, stream);
      break;
    case 64:
      err = by_group<64>(G, qf, kf, vf, len_ptr, len_val, B, Tn, KV, splits,
                         split_len, scale, part_ml, part_acc, of, stream);
      break;
    case 128:
      err = by_group<128>(G, qf, kf, vf, len_ptr, len_val, B, Tn, KV,
                          splits, split_len, scale, part_ml, part_acc, of,
                          stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The same in bfloat16 on tensor cores (`fd_sm90`): q: (B, KV * G, HD);
// k, v: (B, T, KV, HD), bfloat16, contiguous and 16-byte aligned; HD 32,
// 64 or 128. A block serves KH (1, 2 or 4, dividing KV; 1 when G > 16)
// KV heads. part_ml / part_acc as above (m in base 2). out: (B, KV * G,
// HD) bfloat16.
extern "C" int tdorch_flash_decode_sm90(int device, const void* q,
                                        const void* k, const void* v,
                                        const long long* len_ptr,
                                        long long len_val, int B, int Tn,
                                        int KV, int G, int HD, int KH,
                                        int splits, int split_len,
                                        float scale, float* part_ml,
                                        float* part_acc, void* out,
                                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || KV == 0 || G == 0) return 0;
  if (KV % KH || (KH > 1 && G > kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  switch (HD) {
    case 32:
      err = by_heads_sm90<32>(KH, q, k, v, len_ptr, len_val, B, Tn, KV, G,
                              splits, split_len, scale_log2, part_ml,
                              part_acc, out, stream);
      break;
    case 64:
      err = by_heads_sm90<64>(KH, q, k, v, len_ptr, len_val, B, Tn, KV, G,
                              splits, split_len, scale_log2, part_ml,
                              part_acc, out, stream);
      break;
    case 128:
      err = by_heads_sm90<128>(KH, q, k, v, len_ptr, len_val, B, Tn, KV, G,
                               splits, split_len, scale_log2, part_ml,
                               part_acc, out, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
