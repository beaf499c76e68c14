// GQA flash attention, backward, in float32 for Hopper (sm_90a): dq, dk
// and dv of o = softmax(q · kᵀ · hd^-0.5) · v from the forward's o and its
// row log-sum-exp, in 3xTF32 on `mma.sync` m16n8k8. bf16 inputs take the
// `wgmma` + TMA kernels of flash_attention_bwd_sm90.cu.
//
// Replaces, for float32 inputs, the backward rule of the JAX package's
// flash attention, its custom VJP `_flash_bwd_rule`
// (src/repro/models/attention.py:137), which XLA runs as a scan over key
// chunks (not a Pallas kernel; the forward it differentiates is
// `flash_attention`'s, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:75 that flash_attention_tf32.cu
// ports). The arithmetic is that rule's:
//   P   = exp(s − lse),  s = q · k · hd^-0.5 (−2e38 above the diagonal
//         under `causal`), lse the forward's row log-sum-exp;
//   D   = rowsum(dO ⊙ O);
//   dS  = P ⊙ (dO · vᵀ − D);
//   dq  = dS · k · hd^-0.5,  dk = dSᵀ · q · hd^-0.5,  dv = Pᵀ · dO,
// dk and dv summed over the G query heads of their KV head. Float32 sums
// throughout; every operand is split hi/lo (`sm90::split_tf32`), so float32
// accuracy does not depend on `allow_tf32`.
//
// Three kernels, no atomics, so a step is deterministic:
// - fa_bwd_pre: D, one 16-byte vector a thread, a row's vectors summed
//   across its lanes.
// - fa_bwd_dkdv: one block of 4 warps per (64 keys, KV head, batch row),
//   16 keys a warp. It walks the G query heads of its KV head and, for
//   each, the query tiles at or after its key tile (all of them without
//   `causal`), with q and dO tiles (and their rows' lse and D) double
//   buffered by `cp.async` behind the k and v tiles, which stay. A step
//   recomputes Sᵀ = k · qᵀ and Pᵀ, then dPᵀ = v · dOᵀ and dSᵀ, and adds
//   Pᵀ · dO to dv and dSᵀ · q to dk. Pᵀ and dSᵀ go from the accumulators of
//   one product straight into the A fragments of the next (no shared
//   memory); q and dO are read as they lie, by 8-byte loads for the first
//   products and scalar loads for the second. Each dk and dv is written
//   once.
// - fa_bwd_dq: one block of 4 warps per (64 query rows, head, batch row), 16
//   rows a warp; it walks the key tiles up to its diagonal (all without
//   `causal`), k and v double buffered, and adds dS · k to dq.
// - The tensor core truncates the sums it writes (the products aligned to
//   the largest addend): a dk or dv sum carried on it over the 32,768 rows
//   of 4,096 positions x G = 8 heads would land far past the float32 gate.
//   So each step's products go into sums of their own, added to the running
//   dk and dv in float32 in shared memory (a thread's own elements: no
//   barrier); dq adds a key tile's sums in registers.
// - Rows past S read lse = +inf (P = 0) and D = 0; keys past T read as zero
//   rows, which add nothing to dq and whose own dk, dv are not stored.
//   Under `causal` only tiles that reach past the diagonal are masked,
//   and a warp skips the steps whose keys all follow its rows.
//
// What bounds it on this card: operations. The backward does the forward's
// two products over the causal half three more times (Sᵀ and dPᵀ again,
// dq, dk, dv): 2.5x the forward's, 5 · 2·B·H·S²·hd/2 FLOP, 4.17 ms at
// 495/3 TFLOP/s (3xTF32) for tinyllama's training shape (4, 4096, 32
// heads, 4 KV heads, 64). Recomputing S and dP in both the dq and the dk/dv
// kernel adds two products to those five: the price of no atomics.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // 4 warps of 16 keys (dkdv) or rows (dq)

// float32 products in 3xTF32 on `mma.sync` m16n8k8: each operand split
// into TF32 hi and lo in registers, hi·hi + hi·lo + lo·hi into float32
// sums. The depth of each k8 step is permuted, slot t <-> 2t and t + 4 <->
// 2t + 1 in A and B alike, so that a thread's two values of a row lie side
// by side (one 8-byte load), and an accumulator's columns (2t, 2t + 1) of
// each 8 are exactly an A fragment's slots (t, t + 4).
//
// c (16 x N) += A · Xᵀ over K: A 16 rows of lda, X N rows of ldx.
template <int N, int K>
__device__ __forceinline__ void gemm_nt(float (&c)[N / 8][4], const float* a,
                                        int lda, const float* x, int ldx,
                                        int lane) {
  const int g = lane / 4, t = lane % 4;
  const float* ap = a + g * lda + 2 * t;
  const float* xp = x + g * ldx + 2 * t;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float2 a0 = *reinterpret_cast<const float2*>(ap + 8 * kk);
    const float2 a1 =
        *reinterpret_cast<const float2*>(ap + 8 * lda + 8 * kk);
    uint32_t a_hi[4], a_lo[4];
    sm90::split_tf32(a0.x, a_hi[0], a_lo[0]);
    sm90::split_tf32(a1.x, a_hi[1], a_lo[1]);
    sm90::split_tf32(a0.y, a_hi[2], a_lo[2]);
    sm90::split_tf32(a1.y, a_hi[3], a_lo[3]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 b =
          *reinterpret_cast<const float2*>(xp + 8 * j * ldx + 8 * kk);
      uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
      sm90::split_tf32(b.x, b_hi0, b_lo0);
      sm90::split_tf32(b.y, b_hi1, b_lo1);
      sm90::mma_3xtf32(c[j], a_hi, a_lo, b_hi0, b_hi1, b_lo0, b_lo1);
    }
  }
}

// c (16 x N) += P · X: P (16 x K) an accumulator's fragments, X K rows of
// ldx read down its columns (scalar loads).
template <int N, int K>
__device__ __forceinline__ void gemm_rn(float (&c)[N / 8][4],
                                        const float (&p)[K / 8][4],
                                        const float* x, int ldx, int lane) {
  const int g = lane / 4, t = lane % 4;
  const float* xp = x + 2 * t * ldx + g;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    sm90::split_tf32(p[kk][0], a_hi[0], a_lo[0]);
    sm90::split_tf32(p[kk][2], a_hi[1], a_lo[1]);
    sm90::split_tf32(p[kk][1], a_hi[2], a_lo[2]);
    sm90::split_tf32(p[kk][3], a_hi[3], a_lo[3]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
      sm90::split_tf32(xp[8 * kk * ldx + 8 * j], b_hi0, b_lo0);
      sm90::split_tf32(xp[(8 * kk + 1) * ldx + 8 * j], b_hi1, b_lo1);
      sm90::mma_3xtf32(c[j], a_hi, a_lo, b_hi0, b_hi1, b_lo0, b_lo1);
    }
  }
}

template <int HD>
struct Tiles {
  static constexpr int kKeys = 64;                // dkdv: keys a block
  static constexpr int kRows = HD == 128 ? 32 : 64;  // dkdv: rows a step
  static constexpr int kQRows = 64;               // dq: rows a block
  static constexpr int kKTile = HD == 128 ? 32 : 64;  // dq: keys a step
  // shared row strides: tiles read only row-wise (A, or Xᵀ of gemm_nt)
  // take 8-byte loads conflict-free at hd + 8;
  // tiles also read transposed (X of gemm_rn, scalar loads) take hd + 4
  static constexpr int kLdA = HD + 8;
  static constexpr int kLdB = HD + 4;
  static constexpr int kDkdvSmem =
      (2 * kKeys * kLdA + 4 * kRows * kLdB) * 4 + 4 * kRows * 4 +
      2 * kKeys * (HD + 8) * 4;  // the running dk and dv, float32
  static constexpr int kDqSmem =
      (2 * kQRows * kLdA + 2 * kKTile * (kLdA + kLdB)) * 4 +
      2 * kQRows * 4;
};

// Copy `rows` rows of HD elements, row i from src + i * src_row (zeros for
// rows at or past `valid`), into shared rows of `ld` elements, 16 bytes a
// copy, spread over the block.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long long src_row, int rows,
                                          int valid) {
  constexpr int kVec = 4;
  for (int c = threadIdx.x; c < rows * (HD / kVec); c += kThreads) {
    const int r = c / (HD / kVec), d = (c % (HD / kVec)) * kVec;
    const bool in = r < valid;
    sm90::cp_async16(dst + r * ld + d, in ? src + r * src_row + d : src,
                     in ? 16 : 0);
  }
}

// Rows' lse (times log2 e, +inf past S) and D into shared memory.
__device__ __forceinline__ void load_row_stats(float* ls, float* ds,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ D,
                                               long long base, int r0,
                                               int rows, int S) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int row = r0 + r;
    ls[r] = row < S ? lse[base + row] * kLog2e : INFINITY;
    ds[r] = row < S ? D[base + row] : 0.f;
  }
}

// D[b, h, s] = Σ_d dO[b, s, h, d] · O[b, s, h, d] in float32.
template <int HD>
__global__ void __launch_bounds__(256)
fa_bwd_pre(const float* __restrict__ o, const float* __restrict__ dout,
           float* __restrict__ D, long long rows, int S, int H) {
  constexpr int kVec = 4, kLanes = HD / kVec;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = idx / kLanes;
  const int part = static_cast<int>(idx % kLanes);
  float sum = 0.f;
  if (row < rows) {
    const float4 ov =
        *reinterpret_cast<const float4*>(o + row * HD + part * kVec);
    const float4 dv =
        *reinterpret_cast<const float4*>(dout + row * HD + part * kVec);
    sum = fmaf(dv.x, ov.x, sum);
    sum = fmaf(dv.y, ov.y, sum);
    sum = fmaf(dv.z, ov.z, sum);
    sum = fmaf(dv.w, ov.w, sum);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0 && row < rows) {
    const long long b = row / (static_cast<long long>(S) * H);
    const int s = static_cast<int>((row / H) % S), h = static_cast<int>(row % H);
    D[(b * H + h) * S + s] = sum;
  }
}

// dk, dv of 64 keys of one KV head (see the top of the file).
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            float* __restrict__ dk, float* __restrict__ dv, int S, int Tn,
            int H, int KV, int G, float scale, int causal) {
  using C = Tiles<HD>;
  constexpr int kKeys = C::kKeys, kRows = C::kRows, kLdA = C::kLdA,
                kLdB = C::kLdB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // kKeys x kLdA
  float* vs = ks + kKeys * kLdA;
  float* qs = vs + kKeys * kLdA;                   // 2 stages of kRows x kLdB
  float* dos = qs + 2 * kRows * kLdB;
  float* ls = reinterpret_cast<float*>(dos + 2 * kRows * kLdB);  // 2 x kRows
  float* dsum = ls + 2 * kRows;                                // 2 x kRows
  constexpr int kLdS = HD + 8;     // float32 sums: conflict-free float2
  float* sums = dsum + 2 * kRows;  // the running dk, then dv: kKeys x kLdS

  const int k0 = (gridDim.x - 1 - blockIdx.x) * kKeys;  // heaviest first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 16 * warp;  // this warp's first key
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const float scale_log2 = scale * kLog2e;

  const int first = causal ? k0 / kRows : 0;  // rows before k0 see no key
  const int n_qt = (S + kRows - 1) / kRows;
  const int per_head = n_qt - first;
  const int n_steps = per_head > 0 ? G * per_head : 0;
  auto load_step = [&](int st) {
    const int h = kvh * G + st / per_head;
    const int r0 = (first + st % per_head) * kRows;
    const int buf = st % 2;
    const long long off =
        (static_cast<long long>(b) * S + r0) * q_row + static_cast<long long>(h) * HD;
    load_rows<HD>(qs + buf * kRows * kLdB, kLdB, q + off, q_row, kRows,
                     S - r0);
    load_rows<HD>(dos + buf * kRows * kLdB, kLdB, dout + off, q_row,
                     kRows, S - r0);
    load_row_stats(ls + buf * kRows, dsum + buf * kRows, lse, D,
                   (static_cast<long long>(b) * H + h) * S, r0, kRows, S);
  };

  const long long kv_off = (static_cast<long long>(b) * Tn + k0) * kv_row +
                           static_cast<long long>(kvh) * HD;
  load_rows<HD>(ks, kLdA, k + kv_off, kv_row, kKeys, Tn - k0);
  load_rows<HD>(vs, kLdA, v + kv_off, kv_row, kKeys, Tn - k0);
  if (n_steps > 0) load_step(0);
  sm90::cp_async_commit();

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  float* my_sums = sums + (16 * warp + g) * kLdS + 2 * t;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* p = my_sums + m * kKeys * kLdS + r * 8 * kLdS + 8 * i;
        p[0] = p[1] = 0.f;
      }

  for (int st = 0; st < n_steps; ++st) {
    if (st + 1 < n_steps) load_step(st + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // step st has landed (this thread's copies)
    __syncthreads();           // ... and every thread's
    const int buf = st % 2;
    const int r0 = (first + st % per_head) * kRows;
    if (!(causal && r0 + kRows - 1 < kw0)) {  // not all above the diagonal
      const float* qb = qs + buf * kRows * kLdB;
      const float* dob = dos + buf * kRows * kLdB;
      const float* lb = ls + buf * kRows;
      const float* db = dsum + buf * kRows;
      // Sᵀ = k · qᵀ: this warp's 16 keys x kRows rows
      float s[kRows / 8][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      gemm_nt<kRows, HD>(s, ks + 16 * warp * kLdA, kLdA, qb, kLdB, lane);
      // Pᵀ: s[j] = {(key g, row 8j+2t), (g, 8j+2t+1), (g+8, ..), (g+8, ..)}
      const bool mask = causal && r0 < kw0 + 15;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = 8 * j + 2 * t + (e & 1);
          float p = sm90::exp2_approx(fmaf(s[j][e], scale_log2, -lb[rl]));
          if (mask && r0 + rl < kw0 + g + (e & 2 ? 8 : 0)) p = 0.f;
          s[j][e] = p;
        }
      // dPᵀ = v · dOᵀ, then dSᵀ = Pᵀ ⊙ (dPᵀ − D)
      float dp[kRows / 8][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
      gemm_nt<kRows, HD>(dp, vs + 16 * warp * kLdA, kLdA, dob, kLdB, lane);
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - db[8 * j + 2 * t + (e & 1)]);
      // this step's sums of their own, added to the running sums in
      // float32
      gemm_rn<HD, kRows>(dv_acc, s, dob, kLdB, lane);
      gemm_rn<HD, kRows>(dk_acc, dp, qb, kLdB, lane);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* pk = my_sums + r * 8 * kLdS + 8 * i;
          float* pv = pk + kKeys * kLdS;
          pk[0] += dk_acc[i][2 * r];
          pk[1] += dk_acc[i][2 * r + 1];
          pv[0] += dv_acc[i][2 * r];
          pv[1] += dv_acc[i][2 * r + 1];
          dk_acc[i][2 * r] = dk_acc[i][2 * r + 1] = 0.f;
          dv_acc[i][2 * r] = dv_acc[i][2 * r + 1] = 0.f;
        }
    }
    __syncthreads();  // every warp is done with this stage before its reload
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* pk = my_sums + r * 8 * kLdS + 8 * i;
      const float* pv = pk + kKeys * kLdS;
      dk_acc[i][2 * r] = pk[0];
      dk_acc[i][2 * r + 1] = pk[1];
      dv_acc[i][2 * r] = pv[0];
      dv_acc[i][2 * r + 1] = pv[1];
    }
  // dk[b, key, kvh], dv[b, key, kvh]: rows g and g + 8 of this warp's keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= Tn) continue;
    const long long off = (static_cast<long long>(b) * Tn + key) * kv_row +
                          static_cast<long long>(kvh) * HD + 2 * t;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      *reinterpret_cast<float2*>(dk + off + 8 * i) =
          make_float2(dk_acc[i][2 * r] * scale, dk_acc[i][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * i) =
          make_float2(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
    }
  }
}

// dq of 64 query rows of one head (see the top of the file).
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          float* __restrict__ dq, int S, int Tn, int H, int KV, int G,
          float scale, int causal) {
  using C = Tiles<HD>;
  constexpr int kQRows = C::kQRows, kKT = C::kKTile, kLdA = C::kLdA,
                kLdB = C::kLdB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // kQRows x kLdA
  float* dos = qs + kQRows * kLdA;
  float* ks = dos + kQRows * kLdA;                 // 2 stages of kKT x kLdB
  float* vs = ks + 2 * kKT * kLdB;                 // 2 stages of kKT x kLdA
  float* ls = reinterpret_cast<float*>(vs + 2 * kKT * kLdA);  // kQRows
  float* dsum = ls + kQRows;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int warp_row = q0 + 16 * warp;
  const int k_end = causal ? min(Tn, q0 + kQRows) : Tn;
  const int n_tiles = (k_end + kKT - 1) / kKT;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const float scale_log2 = scale * kLog2e;

  const long long q_off = (static_cast<long long>(b) * S + q0) * q_row +
                          static_cast<long long>(h) * HD;
  const long long kv_base = static_cast<long long>(b) * Tn * kv_row +
                            static_cast<long long>(kvh) * HD;
  auto load_tile = [&](int j) {
    const int kt0 = j * kKT;
    load_rows<HD>(ks + (j % 2) * kKT * kLdB, kLdB,
                     k + kv_base + kt0 * kv_row, kv_row, kKT, Tn - kt0);
    load_rows<HD>(vs + (j % 2) * kKT * kLdA, kLdA,
                     v + kv_base + kt0 * kv_row, kv_row, kKT, Tn - kt0);
  };
  load_rows<HD>(qs, kLdA, q + q_off, q_row, kQRows, S - q0);
  load_rows<HD>(dos, kLdA, dout + q_off, q_row, kQRows, S - q0);
  load_row_stats(ls, dsum, lse, D, (static_cast<long long>(b) * H + h) * S,
                 q0, kQRows, S);
  if (n_tiles > 0) load_tile(0);
  sm90::cp_async_commit();

  float acc[HD / 8][4], part[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = part[i][e] = 0.f;
  const int rl0 = 16 * warp + g;  // this thread's rows: rl0, rl0 + 8

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const int kt0 = j * kKT;
    if (!(causal && kt0 > warp_row + 15)) {  // some key at or before a row
      const float* kb = ks + (j % 2) * kKT * kLdB;
      const float* vb = vs + (j % 2) * kKT * kLdA;
      float s[kKT / 8][4], dp[kKT / 8][4];
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      gemm_nt<kKT, HD>(s, qs + 16 * warp * kLdA, kLdA, kb, kLdB, lane);
      gemm_nt<kKT, HD>(dp, dos + 16 * warp * kLdA, kLdA, vb, kLdA, lane);
      // s[n] = {(row rl0, key kt0+8n+2t), (rl0, +1), (rl0+8, ..), (rl0+8, ..)}
      const bool mask = causal && kt0 + kKT - 1 > warp_row;
      const float l0 = ls[rl0], l1 = ls[rl0 + 8];
      const float d0 = dsum[rl0], d1 = dsum[rl0 + 8];
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e & 2;
          float p = sm90::exp2_approx(
              fmaf(s[n][e], scale_log2, -(hi ? l1 : l0)));
          if (mask && kt0 + 8 * n + 2 * t + (e & 1) > q0 + rl0 + (hi ? 8 : 0))
            p = 0.f;
          dp[n][e] = p * (dp[n][e] - (hi ? d1 : d0));  // dS
        }
      // a tile's sums of their own, added in float32
      gemm_rn<HD, kKT>(part, dp, kb, kLdB, lane);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] += part[i][e];
          part[i][e] = 0.f;
        }
    }
    __syncthreads();
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl0 + 8 * r;
    if (row >= S) continue;
    float* out = dq + (static_cast<long long>(b) * S + row) * q_row +
                 static_cast<long long>(h) * HD + 2 * t;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(out + 8 * i) =
          make_float2(acc[i][2 * r] * scale, acc[i][2 * r + 1] * scale);
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse, int B,
                   int S, int Tn, int H, int KV, float scale, int causal,
                   float* D, float* dq, float* dk, float* dv,
                   cudaStream_t stream) {
  using C = Tiles<HD>;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long pre_blocks = (rows * (HD / 4) + 255) / 256;
  fa_bwd_pre<HD><<<static_cast<unsigned>(pre_blocks), 256, 0, stream>>>(
      o, dout, D, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkdvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Tn + C::kKeys - 1) / C::kKeys, KV, B);
  fa_bwd_dkdv<HD><<<grid_kv, kThreads, C::kDkdvSmem, stream>>>(
      q, k, v, dout, lse, D, dk, dv, S, Tn, H, KV, H / KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((S + C::kQRows - 1) / C::kQRows, H, B);
  fa_bwd_dq<HD><<<grid_q, kThreads, C::kDqSmem, stream>>>(
      q, k, v, dout, lse, D, dq, S, Tn, H, KV, H / KV, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout: (B, S, H, HD); k, v: (B, T, KV, HD) with H = KV * G; lse
// (B, H, S) float32, the forward's row log-sum-exp; all contiguous and
// 16-byte aligned, HD 32, 64 or 128; causal needs S == T (the wrapper
// checks). D: (B, H, S) float32 scratch. dq (B, S, H, HD), dk and dv (B, T,
// KV, HD), each fully written. All float32.
extern "C" int tdorch_flash_attention_bwd_tf32(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, int B, int S, int Tn, int H, int KV,
    int HD, float scale, int causal, float* D, void* dq, void* dk, void* dv,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* df = static_cast<const float*>(dout);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  switch (HD) {
    case 32:
      err = launch<32>(qf, kf, vf, of, df, lse, B, S, Tn, H, KV, scale,
                       causal, D, dqf, dkf, dvf, stream);
      break;
    case 64:
      err = launch<64>(qf, kf, vf, of, df, lse, B, S, Tn, H, KV, scale,
                       causal, D, dqf, dkf, dvf, stream);
      break;
    case 128:
      err = launch<128>(qf, kf, vf, of, df, lse, B, S, Tn, H, KV, scale,
                        causal, D, dqf, dkf, dvf, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
