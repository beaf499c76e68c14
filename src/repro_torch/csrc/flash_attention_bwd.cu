// GQA flash attention, backward, for Hopper (sm_90a): dq, dk and dv of
// o = softmax(q · kᵀ · hd^-0.5) · v from the forward's o and its row
// log-sum-exp, in bf16 (`mma.sync` m16n8k16) and float32 (3xTF32
// `mma.sync` m16n8k8).
//
// Replaces the backward rule of the JAX package's flash attention, its
// custom VJP `_flash_bwd_rule` (src/repro/models/attention.py:137), which
// XLA runs as a scan over key chunks (not a Pallas kernel; the forward it
// differentiates is `flash_attention`'s, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:75 that flash_attention_sm90.cu
// and flash_attention_tf32.cu port). The arithmetic is that rule's:
//   P   = exp(s − lse),  s = q · k · hd^-0.5 (−2e38 above the diagonal
//         under `causal`), lse the forward's row log-sum-exp;
//   D   = rowsum(dO ⊙ O);
//   dS  = P ⊙ (dO · vᵀ − D);
//   dq  = dS · k · hd^-0.5,  dk = dSᵀ · q · hd^-0.5,  dv = Pᵀ · dO,
// dk and dv summed over the G query heads of their KV head. Float32 sums
// throughout; in bf16 P and dS are rounded to bf16 once before their
// products (the rule keeps them in float32; the gate chip_smoke.py holds
// the kernels to covers that rounding), in float32 every operand is split
// hi/lo (`sm90::split_tf32`), so float32 accuracy does not depend on
// `allow_tf32`.
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
//   memory); q and dO are read as they lie, by `ldmatrix` (bf16) or 8-byte
//   loads (float32) for the first products and `ldmatrix.trans` or
//   scalar loads for the second. Each dk and dv is written once.
// - fa_bwd_dq: one block of 4 warps per (64 query rows, head, batch row),
//   16 rows a warp; it walks the key tiles up to its diagonal (all without
//   `causal`), k and v double buffered, and adds dS · k to dq.
// - The tensor core truncates the sums it writes (the products aligned to
//   the largest addend): a dk or dv sum carried on it over the 32,768 rows
//   of 4,096 positions x G = 8 heads could lose up to half an ulp of
//   itself an addend, ~2^-9 of it over 32,768 same-sign terms in bf16 and
//   far past the float32 gate. So each step's products go into sums of
//   their own, added to the running dk and dv in float32 in shared memory
//   (a thread's own elements: no barrier), in both routes. dq sums at most
//   64 key tiles: in bf16 on the tensor core, in float32 a tile's sums
//   added in registers.
// - Rows past S read lse = +inf (P = 0) and D = 0; keys past T read as zero
//   rows, which add nothing to dq and whose own dk, dv are not stored.
//   Under `causal` only tiles that reach past the diagonal are masked,
//   and a warp skips the steps whose keys all follow its rows.
//
// What bounds it on this card: operations. The backward does the forward's
// two products over the causal half three more times (Sᵀ and dPᵀ again,
// dq, dk, dv): 2.5x the forward's, 5 · 2·B·H·S²·hd/2 FLOP, 0.695 ms at
// 989 TFLOP/s for tinyllama's training shape (4, 4096, 32 heads, 4 KV
// heads, 64). Recomputing S and dP in both the dq and the dk/dv kernel
// adds two products to those five: the price of no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // 4 warps of 16 keys (dkdv) or rows (dq)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16 products on `mma.sync` m16n8k16 with float32 sums; operands by
// `ldmatrix` from rows padded to 16 bytes past hd (conflict-free).
struct Bf16 {
  using E = __nv_bfloat16;
  static constexpr bool kTileSums = false;  // dq: sums on the tensor core
  static constexpr int kPad = 8;  // elements past hd in a shared row

  // c (16 x N) += A · Xᵀ: A (16 x K) the rows at a (stride lda), X (N x K)
  // the rows at x (stride ldx), both in shared memory.
  template <int N, int K>
  __device__ static void gemm_nt(float (&c)[N / 8][4], const E* a, int lda,
                                 const E* x, int ldx, int lane) {
    const uint32_t a_addr =
        sm90::smem_addr(a + (lane % 16) * lda + (lane / 16) * 8);
    const uint32_t x_addr = sm90::smem_addr(
        x + ((lane / 16) * 8 + lane % 8) * ldx + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t af[4];
      sm90::ldmatrix_x4(af, a_addr + kk * 32);
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        uint32_t bf[4];
        sm90::ldmatrix_x4(bf, x_addr + (j * 16 * ldx) * 2 + kk * 32);
        sm90::mma_bf16(c[2 * j], af, bf[0], bf[1]);
        sm90::mma_bf16(c[2 * j + 1], af, bf[2], bf[3]);
      }
    }
  }

  // c (16 x N) += P · X: P (16 x K) in the accumulator layout of an
  // earlier product (p[i] the 8 columns 8i ..), rounded to bf16 once; X
  // (K x N) the rows at x (stride ldx), read transposed.
  template <int N, int K>
  __device__ static void gemm_rn(float (&c)[N / 8][4],
                                 const float (&p)[K / 8][4], const E* x,
                                 int ldx, int lane) {
    const uint32_t x_addr =
        sm90::smem_addr(x + (lane % 16) * ldx + (lane / 16) * 8);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      const uint32_t af[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        uint32_t bf[4];
        sm90::ldmatrix_x4_trans(bf, x_addr + (kk * 16 * ldx + j * 16) * 2);
        sm90::mma_bf16(c[2 * j], af, bf[0], bf[1]);
        sm90::mma_bf16(c[2 * j + 1], af, bf[2], bf[3]);
      }
    }
  }

  __device__ static void store2(E* dst, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  }
};

// float32 products in 3xTF32 on `mma.sync` m16n8k8: each operand split
// into TF32 hi and lo in registers, hi·hi + hi·lo + lo·hi into float32
// sums. The depth of each k8 step is permuted, slot t <-> 2t and t + 4 <->
// 2t + 1 in A and B alike, so that a thread's two values of a row lie side
// by side (one 8-byte load), and an accumulator's columns (2t, 2t + 1) of
// each 8 are exactly an A fragment's slots (t, t + 4).
struct Tf32 {
  using E = float;
  static constexpr bool kTileSums = true;  // dq: a tile's sums added
  static constexpr int kPad = 4;  // rows read transposed (scalar loads)

  template <int N, int K>
  __device__ static void gemm_nt(float (&c)[N / 8][4], const E* a, int lda,
                                 const E* x, int ldx, int lane) {
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

  template <int N, int K>
  __device__ static void gemm_rn(float (&c)[N / 8][4],
                                 const float (&p)[K / 8][4], const E* x,
                                 int ldx, int lane) {
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

  __device__ static void store2(E* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
};

template <class P, int HD>
struct Tiles {
  using E = typename P::E;
  static constexpr bool kF32 = sizeof(E) == 4;
  static constexpr int kKeys = 64;                // dkdv: keys a block
  static constexpr int kRows = HD == 128 ? 32 : 64;  // dkdv: rows a step
  static constexpr int kQRows = 64;               // dq: rows a block
  static constexpr int kKTile = kF32 && HD == 128 ? 32 : 64;  // dq: keys a step
  // shared row strides: tiles read only row-wise (A, or Xᵀ of gemm_nt)
  // take 8-byte loads (float32) or ldmatrix conflict-free at hd + 8;
  // tiles also read transposed (X of gemm_rn) take hd + P::kPad
  static constexpr int kLdA = HD + 8;
  static constexpr int kLdB = HD + P::kPad;
  static constexpr int kDkdvSmem =
      (2 * kKeys * kLdA + 4 * kRows * kLdB) * sizeof(E) + 4 * kRows * 4 +
      2 * kKeys * (HD + 8) * 4;  // the running dk and dv, float32
  static constexpr int kDqSmem =
      (2 * kQRows * kLdA + 2 * kKTile * (kLdA + kLdB)) * sizeof(E) +
      2 * kQRows * 4;
};

// Copy `rows` rows of HD elements, row i from src + i * src_row (zeros for
// rows at or past `valid`), into shared rows of `ld` elements, 16 bytes a
// copy, spread over the block.
template <typename E, int HD>
__device__ __forceinline__ void load_rows(E* dst, int ld,
                                          const E* __restrict__ src,
                                          long long src_row, int rows,
                                          int valid) {
  constexpr int kVec = 16 / sizeof(E);
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
template <typename E, int HD>
__global__ void __launch_bounds__(256)
fa_bwd_pre(const E* __restrict__ o, const E* __restrict__ dout,
           float* __restrict__ D, long long rows, int S, int H) {
  constexpr int kVec = 16 / sizeof(E), kLanes = HD / kVec;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = idx / kLanes;
  const int part = static_cast<int>(idx % kLanes);
  float sum = 0.f;
  if (row < rows) {
    const uint4 ov =
        *reinterpret_cast<const uint4*>(o + row * HD + part * kVec);
    const uint4 dv =
        *reinterpret_cast<const uint4*>(dout + row * HD + part * kVec);
    const E* oe = reinterpret_cast<const E*>(&ov);
    const E* de = reinterpret_cast<const E*>(&dv);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      sum = fmaf(to_float(de[i]), to_float(oe[i]), sum);
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
template <class P, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const typename P::E* __restrict__ q,
            const typename P::E* __restrict__ k,
            const typename P::E* __restrict__ v,
            const typename P::E* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            typename P::E* __restrict__ dk, typename P::E* __restrict__ dv,
            int S, int Tn, int H, int KV, int G, float scale, int causal) {
  using C = Tiles<P, HD>;
  using E = typename P::E;
  constexpr int kKeys = C::kKeys, kRows = C::kRows, kLdA = C::kLdA,
                kLdB = C::kLdB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  E* ks = reinterpret_cast<E*>(smem_raw);  // kKeys x kLdA
  E* vs = ks + kKeys * kLdA;
  E* qs = vs + kKeys * kLdA;               // 2 stages of kRows x kLdB
  E* dos = qs + 2 * kRows * kLdB;
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
    load_rows<E, HD>(qs + buf * kRows * kLdB, kLdB, q + off, q_row, kRows,
                     S - r0);
    load_rows<E, HD>(dos + buf * kRows * kLdB, kLdB, dout + off, q_row,
                     kRows, S - r0);
    load_row_stats(ls + buf * kRows, dsum + buf * kRows, lse, D,
                   (static_cast<long long>(b) * H + h) * S, r0, kRows, S);
  };

  const long long kv_off = (static_cast<long long>(b) * Tn + k0) * kv_row +
                           static_cast<long long>(kvh) * HD;
  load_rows<E, HD>(ks, kLdA, k + kv_off, kv_row, kKeys, Tn - k0);
  load_rows<E, HD>(vs, kLdA, v + kv_off, kv_row, kKeys, Tn - k0);
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
      const E* qb = qs + buf * kRows * kLdB;
      const E* dob = dos + buf * kRows * kLdB;
      const float* lb = ls + buf * kRows;
      const float* db = dsum + buf * kRows;
      // Sᵀ = k · qᵀ: this warp's 16 keys x kRows rows
      float s[kRows / 8][4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      P::template gemm_nt<kRows, HD>(s, ks + 16 * warp * kLdA, kLdA, qb,
                                     kLdB, lane);
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
      P::template gemm_nt<kRows, HD>(dp, vs + 16 * warp * kLdA, kLdA, dob,
                                     kLdB, lane);
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - db[8 * j + 2 * t + (e & 1)]);
      // this step's sums of their own, added to the running sums in
      // float32
      P::template gemm_rn<HD, kRows>(dv_acc, s, dob, kLdB, lane);
      P::template gemm_rn<HD, kRows>(dk_acc, dp, qb, kLdB, lane);
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
      P::store2(dk + off + 8 * i, dk_acc[i][2 * r] * scale,
                dk_acc[i][2 * r + 1] * scale);
      P::store2(dv + off + 8 * i, dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
    }
  }
}

// dq of 64 query rows of one head (see the top of the file).
template <class P, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const typename P::E* __restrict__ q,
          const typename P::E* __restrict__ k,
          const typename P::E* __restrict__ v,
          const typename P::E* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          typename P::E* __restrict__ dq, int S, int Tn, int H, int KV, int G,
          float scale, int causal) {
  using C = Tiles<P, HD>;
  using E = typename P::E;
  constexpr int kQRows = C::kQRows, kKT = C::kKTile, kLdA = C::kLdA,
                kLdB = C::kLdB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  E* qs = reinterpret_cast<E*>(smem_raw);  // kQRows x kLdA
  E* dos = qs + kQRows * kLdA;
  E* ks = dos + kQRows * kLdA;             // 2 stages of kKT x kLdB
  E* vs = ks + 2 * kKT * kLdB;             // 2 stages of kKT x kLdA
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
    load_rows<E, HD>(ks + (j % 2) * kKT * kLdB, kLdB,
                     k + kv_base + kt0 * kv_row, kv_row, kKT, Tn - kt0);
    load_rows<E, HD>(vs + (j % 2) * kKT * kLdA, kLdA,
                     v + kv_base + kt0 * kv_row, kv_row, kKT, Tn - kt0);
  };
  load_rows<E, HD>(qs, kLdA, q + q_off, q_row, kQRows, S - q0);
  load_rows<E, HD>(dos, kLdA, dout + q_off, q_row, kQRows, S - q0);
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
      const E* kb = ks + (j % 2) * kKT * kLdB;
      const E* vb = vs + (j % 2) * kKT * kLdA;
      float s[kKT / 8][4], dp[kKT / 8][4];
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      P::template gemm_nt<kKT, HD>(s, qs + 16 * warp * kLdA, kLdA, kb, kLdB,
                                   lane);
      P::template gemm_nt<kKT, HD>(dp, dos + 16 * warp * kLdA, kLdA, vb,
                                   kLdA, lane);
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
      if constexpr (!P::kTileSums) {
        P::template gemm_rn<HD, kKT>(acc, dp, kb, kLdB, lane);
      } else {
        P::template gemm_rn<HD, kKT>(part, dp, kb, kLdB, lane);
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][e] += part[i][e];
            part[i][e] = 0.f;
          }
      }
    }
    __syncthreads();
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl0 + 8 * r;
    if (row >= S) continue;
    E* out = dq + (static_cast<long long>(b) * S + row) * q_row +
             static_cast<long long>(h) * HD + 2 * t;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      P::store2(out + 8 * i, acc[i][2 * r] * scale,
                acc[i][2 * r + 1] * scale);
  }
}

template <class P, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse, int B,
                   int S, int Tn, int H, int KV, float scale, int causal,
                   float* D, void* dq, void* dk, void* dv,
                   cudaStream_t stream) {
  using C = Tiles<P, HD>;
  using E = typename P::E;
  const auto* qe = static_cast<const E*>(q);
  const auto* ke = static_cast<const E*>(k);
  const auto* ve = static_cast<const E*>(v);
  const auto* doe = static_cast<const E*>(dout);
  const long long rows = static_cast<long long>(B) * S * H;
  constexpr int kLanes = HD / (16 / sizeof(E));
  const long long pre_blocks = (rows * kLanes + 255) / 256;
  fa_bwd_pre<E, HD><<<static_cast<unsigned>(pre_blocks), 256, 0, stream>>>(
      static_cast<const E*>(o), doe, D, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv<P, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkdvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Tn + C::kKeys - 1) / C::kKeys, KV, B);
  fa_bwd_dkdv<P, HD><<<grid_kv, kThreads, C::kDkdvSmem, stream>>>(
      qe, ke, ve, doe, lse, D, static_cast<E*>(dk), static_cast<E*>(dv), S,
      Tn, H, KV, H / KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq<P, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((S + C::kQRows - 1) / C::kQRows, H, B);
  fa_bwd_dq<P, HD><<<grid_q, kThreads, C::kDqSmem, stream>>>(
      qe, ke, ve, doe, lse, D, static_cast<E*>(dq), S, Tn, H, KV, H / KV,
      scale, causal);
  return cudaGetLastError();
}

template <class P>
int dispatch(int device, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, int B, int S,
             int Tn, int H, int KV, int HD, float scale, int causal, float* D,
             void* dq, void* dk, void* dv, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  switch (HD) {
    case 32:
      err = launch<P, 32>(q, k, v, o, dout, lse, B, S, Tn, H, KV, scale,
                          causal, D, dq, dk, dv, stream);
      break;
    case 64:
      err = launch<P, 64>(q, k, v, o, dout, lse, B, S, Tn, H, KV, scale,
                          causal, D, dq, dk, dv, stream);
      break;
    case 128:
      err = launch<P, 128>(q, k, v, o, dout, lse, B, S, Tn, H, KV, scale,
                           causal, D, dq, dk, dv, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// q, o, dout: (B, S, H, HD); k, v: (B, T, KV, HD) with H = KV * G; lse
// (B, H, S) float32, the forward's row log-sum-exp; all contiguous and
// 16-byte aligned, HD 32, 64 or 128; causal needs S == T (the wrapper
// checks). D: (B, H, S) float32 scratch. dq (B, S, H, HD), dk and dv (B, T,
// KV, HD), each fully written. bf16 and float32 entry points.
extern "C" int tdorch_flash_attention_bwd_bf16(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, int B, int S, int Tn, int H, int KV,
    int HD, float scale, int causal, float* D, void* dq, void* dk, void* dv,
    cudaStream_t stream) {
  return dispatch<Bf16>(device, q, k, v, o, dout, lse, B, S, Tn, H, KV, HD,
                        scale, causal, D, dq, dk, dv, stream);
}

extern "C" int tdorch_flash_attention_bwd_tf32(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, int B, int S, int Tn, int H, int KV,
    int HD, float scale, int causal, float* D, void* dq, void* dk, void* dv,
    cudaStream_t stream) {
  return dispatch<Tf32>(device, q, k, v, o, dout, lse, B, S, Tn, H, KV, HD,
                        scale, causal, D, dq, dk, dv, stream);
}
