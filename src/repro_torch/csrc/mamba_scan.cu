// Mamba2 SSD chunk scan (one B/C group, without the D·x skip term), for
// Hopper (sm_90a): chunk-parallel, on the tensor cores.
//
// Replaces the TPU kernel `ssd_scan` in
// src/repro/kernels/mamba_scan/kernel.py:58 (`_ssd_kernel`), whose grid
// (B, nh, S / chunk) walked the chunks of a (batch row, head) in order on
// one core, carrying the (hd x ds) state in VMEM scratch.
//
// For each (b, head) with A = A[head] and, within a chunk, l the inclusive
// cumulative sum of dt·A:
//   y_t = Σ_{s≤t} (C_t·B_s) exp(l_t − l_s) dt_s x_s + exp(l_t) C_t·h_prev
//   h   = exp(l_end) h_prev + Σ_s exp(l_end − l_s) dt_s x_s ⊗ B_s
// x, B, C float32 or bfloat16 (one type), dt and A float32; float32 sums;
// y in x's type. exp(l_t − l_s) can overflow for s > t when |dt·A| is
// large, so it is computed only for s <= t (the TPU kernel discards it with
// jnp.where, kernel.py:40); a product with a 0/1 mask would give
// inf · 0 = NaN.
//
// What bounds it on this card: a (b, chunk, head) of c steps does c²·hd
// (the causal half of M·x) + 2·c·ds·hd (C·hᵀ) + 2·c·hd·ds (its state)
// multiply-adds, and a (b, chunk) 2·c²·ds more for C·Bᵀ, which its heads
// share; at zamba2's widths in float32 the operations on the tensor cores
// (3xTF32) and the bytes of x, dt, B, C and y take about as long, and the
// passes below add the float32 states' traffic. The design follows the decomposition of Mamba2's own GPU
// implementation (state-spaces/mamba, mamba_ssm/ops/triton/
// ssd_combined.py: chunk cumsum, bmm-chunk, chunk state, state passing,
// chunk scan) in three kernels:
// (i)   ssd_states: in parallel over (b, chunk, heads), the chunk's local
//       state s_k = Σ_s exp(l_end − l_s)·dt_s·x_s ⊗ B_s (hd x ds) into a
//       float32 scratch (B, nh, NC, hd, ds), and l into (B, nh, NC, 128)
//       for (ii) (exp(l_end)) and (iii). B is staged once for the
//       block's heads; every warp scans dt·A itself (no block barrier) and
//       takes its weights w_s by shuffles.
// (ii)  ssd_state_pass: per (b, head), in chunk order, in parallel over the
//       hd·ds elements (4 a thread), h_k = exp(l_end,k)·h_{k−1} + s_k in
//       float32, overwriting s_k with h_{k−1}, the state entering chunk k.
//       Loads run eight chunks ahead of the dependent multiply-adds. The
//       state after the last chunk (what a model's decode starts from)
//       goes to `final_state` when the caller asks for it.
// (iii) ssd_outputs: in parallel over (b, chunk, heads), C·Bᵀ once per
//       block, shared by its heads; per head M = tril(C·Bᵀ ∘ exp(l_t − l_s)
//       ∘ dt_s), then y = M·x + exp(l_t)·C·h_{k−1}ᵀ. C·Bᵀ and M are kept
//       for their 36 causal 16 x 16 tiles only, which leaves room for two
//       buffers of every per-head operand. Four groups of 4 warps each
//       multiply two row tiles (pair, 7 − pair: the same causal work) and
//       form those rows of M themselves, behind a barrier of their own.
// (i) and (iii) run one block a (b, chunk, group of up to 32 heads) and
// copy the next head's x (and in (iii) its state, dt and l) with 16-byte
// cp.async while the current head computes (a batched synchronous copy
// where the rows are not whole 16-byte chunks).
// Products run on the tensor cores through `mma.sync`, with float32 sums a
// slice of 32 deep outside the tensor core (it truncates its own sums):
// - float32: 3xTF32 m16n8k8, each operand split hi = a truncated to TF32,
//   lo = a − hi (sm90::split_tf32, mma_3xtf32). One TF32 rounding of M
//   would miss the float32 gate (tests/test_torch_ssd_emulation.py).
// - bf16: m16n8k16, fragments by ldmatrix. x, B and C are exact in bf16,
//   so C·Bᵀ is one product; the float32 operands (M in M·x, h in C·hᵀ,
//   w ∘ x in the state) are split into bf16 hi + lo (sm90::split_bf16x2),
//   two products each, M and h split once where they are formed. The
//   state stays float32.
// exp(l_t − l_s) and exp(l_t) in (iii) are ex2.approx of the difference
// times log2 e (2 ulp, inside the gate's 8·u32·max|l|).
// Operands are staged in shared memory (x, B, C in their own type), rows
// padded so that each fragment load is free of bank conflicts; hd and ds
// are padded to 64 and a chunk to 128 steps with zeros (padded steps carry
// dt = 0, so l holds at l_end past the chunk and their terms are 0). The
// chunk the kernels run is at most 128 steps: the scan's value does not
// depend on it, and the wrapper runs a larger requested chunk as its
// largest divisor <= 128 (kernels/mamba_scan/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 128;
constexpr int kWidth = 64;  // hd and ds, padded
constexpr int kSlice = 32;  // products summed in float32 outside the core
constexpr int kStateThreads = 256;
constexpr int kOutThreads = 512;
constexpr int kAhead = 8;  // chunks the state pass loads ahead
constexpr float kLog2e = 1.4426950408889634f;

// Row strides (elements) of the staged arrays. A TF32 fragment reads 8
// rows (g = lane / 4) by 4 (t = lane % 4) words of an array that is read
// along its rows, or 4 rows by 8 of one read down its columns; the pads
// put the 32 lanes' words on 32 banks. bf16 fragments come by ldmatrix
// (rows of 144 bytes: 8 rows on 8 distinct groups of 4 banks), but for
// the scaled x of the state, read a value at a time down its columns.
template <typename T>
struct Pad;
template <>
struct Pad<float> {
  static constexpr int kRow = kWidth + 4;       // C, B as C·Bᵀ's B, h
  static constexpr int kCB = kMaxChunk + 4;     // C·Bᵀ and M
  static constexpr int kCol = kWidth + 8;       // x; B in the state
  static constexpr int kK = 8;                  // the product's depth
};
template <>
struct Pad<bf16> {
  static constexpr int kRow = kWidth + 8;
  static constexpr int kCB = kMaxChunk + 8;
  static constexpr int kCol = kWidth + 8;
  static constexpr int kK = 16;
};

__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16(v);
  }
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// ---- fragments --------------------------------------------------------------
// An operand held split (hi, lo) or exact (hi only).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// A (16 x K) at (r0, k0) of a row-major float array m (element (r, k) at
// m[r * ld + k]), split into TF32 hi and lo.
__device__ __forceinline__ void a_rows(const float* m, int ld, int r0, int k0,
                                       FragA& f) {
  const int g = lane_g(), t = lane_t();
  const float* p0 = m + (r0 + g) * ld + k0;
  const float* p1 = p0 + 8 * ld;
  const float v[4] = {p0[t], p1[t], p0[t + 4], p1[t + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) sm90::split_tf32(v[i], f.hi[i], f.lo[i]);
}

// The same from a bf16 array (exact values, or a split's hi or lo part):
// pairs along k are one word.
__device__ __forceinline__ void a_rows_bf16(const bf16* m, int ld, int r0,
                                            int k0, FragA& f) {
  const int g = lane_g(), t = lane_t();
  const bf16* p0 = m + (r0 + g) * ld + k0 + 2 * t;
  const bf16* p1 = p0 + 8 * ld;
  f.hi[0] = *reinterpret_cast<const uint32_t*>(p0);
  f.hi[1] = *reinterpret_cast<const uint32_t*>(p1);
  f.hi[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  f.hi[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// The k of the product's depth whose weights a lane's A fragment needs,
// as offsets from k0: TF32 {t, t + 4}; bf16 {2t, 2t + 1, 2t + 8, 2t + 9}.
template <typename T>
__device__ __forceinline__ int weight_k(int i) {
  const int t = lane_t();
  if constexpr (std::is_same_v<T, float>) {
    return t + 4 * i;
  } else {
    return 2 * t + (i & 1) + 8 * (i >> 1);
  }
}

// A (16 x K) at (r0, k0) whose element (r, k) is m[k * LD + r] · w_k
// (m read down its columns, scaled per k), split; w holds the lane's
// weights in weight_k's order.
template <int LD, typename T>
__device__ __forceinline__ void a_cols_scaled(const T* m, const float* w,
                                              int r0, int k0, FragA& f) {
  const int g = lane_g(), t = lane_t();
  if constexpr (std::is_same_v<T, float>) {
    const float* p = m + (k0 + t) * LD + r0 + g;
    const float w0 = w[0], w1 = w[1];
    const float v[4] = {p[0] * w0, p[8] * w0, p[4 * LD] * w1,
                        p[4 * LD + 8] * w1};
#pragma unroll
    for (int i = 0; i < 4; ++i) sm90::split_tf32(v[i], f.hi[i], f.lo[i]);
  } else {
    const int k = k0 + 2 * t;
    const T* p = m + k * LD + r0 + g;
    const float w0 = w[0], w1 = w[1], w8 = w[2], w9 = w[3];
    sm90::split_bf16x2(to_float(p[0]) * w0, to_float(p[LD]) * w1, f.hi[0],
                       f.lo[0]);
    sm90::split_bf16x2(to_float(p[8]) * w0, to_float(p[LD + 8]) * w1,
                       f.hi[1], f.lo[1]);
    sm90::split_bf16x2(to_float(p[8 * LD]) * w8, to_float(p[9 * LD]) * w9,
                       f.hi[2], f.lo[2]);
    sm90::split_bf16x2(to_float(p[8 * LD + 8]) * w8,
                       to_float(p[9 * LD + 8]) * w9, f.hi[3], f.lo[3]);
  }
}

// B (K x 8) at (k0, n0) of a float array read down its columns: element
// (k, n) at m[k * LD + n], split into TF32 hi and lo.
template <int LD>
__device__ __forceinline__ void b_cols(const float* m, int k0, int n0,
                                       FragB& f) {
  const int g = lane_g(), t = lane_t();
  const float* p = m + (k0 + t) * LD + n0 + g;
  sm90::split_tf32(p[0], f.hi[0], f.lo[0]);
  sm90::split_tf32(p[4 * LD], f.hi[1], f.lo[1]);
}

// B (K x 8) at (k0, n0) of an array read along its rows: element (k, n) at
// m[n * LD + k]. A float array split into TF32 hi and lo; a bf16 one
// exact (or one part of a split).
template <int LD>
__device__ __forceinline__ void b_rows(const float* m, int k0, int n0,
                                       FragB& f) {
  const int g = lane_g(), t = lane_t();
  const float* p = m + (n0 + g) * LD + k0 + t;
  sm90::split_tf32(p[0], f.hi[0], f.lo[0]);
  sm90::split_tf32(p[4], f.hi[1], f.lo[1]);
}
template <int LD>
__device__ __forceinline__ void b_rows(const bf16* m, int k0, int n0,
                                       FragB& f) {
  const int g = lane_g(), t = lane_t();
  const bf16* p = m + (n0 + g) * LD + k0 + 2 * t;
  f.hi[0] = *reinterpret_cast<const uint32_t*>(p);
  f.hi[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// bf16 fragments by ldmatrix, from arrays whose rows are 16-byte aligned
// (16 (mt + 1) + 8 or 72 values: 8 rows of a matrix fall on 8 distinct
// groups of 4 banks). Lane l gives the address of row (l & 15) (A, or B
// read transposed from a [k][n] array) or row (l & 7) + 8 (l >> 4) (B from
// an [n][k] array) of the 16 x 16 block.
// A (16 x 16) at (r0, k0) of a row-major array with row stride ld
__device__ __forceinline__ void a_ldm(const bf16* m, int ld, int r0, int k0,
                                      uint32_t (&r)[4]) {
  const int l = threadIdx.x & 31;
  sm90::ldmatrix_x4(
      r, sm90::smem_addr(m + (r0 + (l & 15)) * ld + k0 + 8 * (l >> 4)));
}
// B of n-tiles n0 and n0 + 8 (k16 at k0) from a [k][n] array
template <int LD>
__device__ __forceinline__ void b2_cols_ldm(const bf16* m, int k0, int n0,
                                            FragB (&f)[2]) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  sm90::ldmatrix_x4_trans(
      r, sm90::smem_addr(m + (k0 + (l & 15)) * LD + n0 + 8 * (l >> 4)));
  f[0].hi[0] = r[0];
  f[0].hi[1] = r[1];
  f[1].hi[0] = r[2];
  f[1].hi[1] = r[3];
}
// B of n-tiles n0 and n0 + 8 (k16 at k0) from an [n][k] array, into hi
// (or lo, for the second part of a split)
template <int LD>
__device__ __forceinline__ void b2_rows_ldm(const bf16* m, int k0, int n0,
                                            FragB (&f)[2], bool lo) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  sm90::ldmatrix_x4(r, sm90::smem_addr(m + (n0 + (l & 7) + 8 * (l >> 4)) * LD +
                                       k0 + 8 * ((l >> 3) & 1)));
  uint32_t* d0 = lo ? f[0].lo : f[0].hi;
  uint32_t* d1 = lo ? f[1].lo : f[1].hi;
  d0[0] = r[0];
  d0[1] = r[1];
  d1[0] = r[2];
  d1[1] = r[3];
}

// d += a·b: 3xTF32 (float), or bf16 with the split operand(s) as two
// products (kSplitA / kSplitB; at most one of them)
template <typename T, bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma(float (&d)[4], const FragA& a,
                                    const FragB& b) {
  if constexpr (std::is_same_v<T, float>) {
    sm90::mma_3xtf32(d, a.hi, a.lo, b.hi[0], b.hi[1], b.lo[0], b.lo[1]);
  } else {
    if constexpr (kSplitA) sm90::mma_bf16(d, a.lo, b.hi[0], b.hi[1]);
    if constexpr (kSplitB) sm90::mma_bf16(d, a.hi, b.lo[0], b.lo[1]);
    sm90::mma_bf16(d, a.hi, b.hi[0], b.hi[1]);
  }
}

// ---- staging ----------------------------------------------------------------
// Rows [0, R) x cols [0, 64) of a (rows, width) slice with row stride
// `stride` into s[r * LD + c], zero past (L, width). kAsync: 16-byte
// cp.async copies that land while the block computes (the wrapper takes
// this route where width is a whole number of 16-byte chunks and the
// tensors are 16-byte aligned); else loads issued in batches of up to 16
// a thread before any store, so they are in flight together.
template <bool kAsync, int R, int LD, int kThreads, typename T>
__device__ __forceinline__ void fetch(T* __restrict__ s,
                                      const T* __restrict__ g,
                                      long long stride, int L, int width) {
  if constexpr (kAsync) {
    constexpr int kE = 16 / static_cast<int>(sizeof(T));
    constexpr int kRowChunks = kWidth / kE;
    for (int i = threadIdx.x; i < R * kRowChunks; i += kThreads) {
      const int r = i / kRowChunks, c = (i % kRowChunks) * kE;
      const bool in = r < L && c < width;
      sm90::cp_async16(s + r * LD + c, in ? g + r * stride + c : g,
                       in ? 16 : 0);
    }
  } else {
    constexpr int kPer = R * kWidth / kThreads;
    constexpr int kBatch = kPer < 16 ? kPer : 16;
#pragma unroll
    for (int b0 = 0; b0 < kPer; b0 += kBatch) {
      T v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = threadIdx.x + (b0 + j) * kThreads;
        const int r = i / kWidth, c = i % kWidth;
        v[j] = (r < L && c < width) ? g[r * stride + c]
                                    : from_float<T>(0.f);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = threadIdx.x + (b0 + j) * kThreads;
        s[(i / kWidth) * LD + i % kWidth] = v[j];
      }
    }
  }
}

// dt of the chunk's steps for one head into dts (0 past the chunk)
template <bool kAsync>
__device__ __forceinline__ void fetch_dt(float* dts, const float* dt,
                                         long long row0, int nh, int head,
                                         int L) {
  if (threadIdx.x < kMaxChunk) {
    const int s = threadIdx.x;
    const float* src = s < L ? dt + (row0 + s) * nh + head : dt;
    if constexpr (kAsync) {
      sm90::cp_async4(dts + s, src, s < L ? 4 : 0);
    } else {
      dts[s] = s < L ? *src : 0.f;
    }
  }
}

// The chunk's l (128 values, written by ssd_states) into ls
template <bool kAsync>
__device__ __forceinline__ void fetch_l(float* ls, const float* l) {
  if constexpr (kAsync) {
    if (threadIdx.x < kMaxChunk / 4)
      sm90::cp_async16(ls + 4 * threadIdx.x, l + 4 * threadIdx.x, 16);
  } else if (threadIdx.x < kMaxChunk) {
    ls[threadIdx.x] = l[threadIdx.x];
  }
}

// Wait for the 128 threads of a group of 4 warps (named barrier `id`, 1-4;
// 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---- (i) chunk states -----------------------------------------------------
template <typename T>
constexpr int states_smem() {
  return 3 * kMaxChunk * Pad<T>::kCol * static_cast<int>(sizeof(T)) +
         2 * kMaxChunk * 4;
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(kStateThreads)
ssd_states(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bc,
           float* __restrict__ states, float* __restrict__ lout, int S,
           int nh, int hd, int ds, int chunk, int NC, int hpb) {
  constexpr int LD = Pad<T>::kCol, KS = Pad<T>::kK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bs = reinterpret_cast<T*>(smem);
  T* xb = bs + kMaxChunk * LD;  // two buffers: this head's and the next's
  float* dtb = reinterpret_cast<float*>(xb + 2 * kMaxChunk * LD);  // two

  const int k = blockIdx.x, b = blockIdx.z;
  const int c0 = k * chunk, L = min(chunk, S - c0);
  const int kend = (L + 15) / 16 * 16;
  const long long row0 = static_cast<long long>(b) * S + c0;
  const long long xstride = static_cast<long long>(nh) * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane_g(), t = lane_t();
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int head_lo = static_cast<int>(blockIdx.y) * hpb;
  const int head_hi = min(nh, head_lo + hpb);
  fetch<false, kMaxChunk, LD, kStateThreads>(bs, Bc + row0 * ds, ds, L, ds);
  fetch<kAsync, kMaxChunk, LD, kStateThreads>(
      xb, x + row0 * xstride + head_lo * hd, xstride, L, hd);
  fetch_dt<kAsync>(dtb, dt, row0, nh, head_lo, L);
  if constexpr (kAsync) sm90::cp_async_commit();

  for (int head = head_lo; head < head_hi; ++head) {
    const int cur = (head - head_lo) & 1;
    T* xs = xb + cur * kMaxChunk * LD;
    const float* dts = dtb + cur * kMaxChunk;
    if (head + 1 < head_hi) {  // the next head's x and dt, while this one runs
      fetch<kAsync, kMaxChunk, LD, kStateThreads>(
          xb + (cur ^ 1) * kMaxChunk * LD, x + row0 * xstride + (head + 1) * hd,
          xstride, L, hd);
      fetch_dt<kAsync>(dtb + (cur ^ 1) * kMaxChunk, dt, row0, nh, head + 1,
                       L);
    }
    if constexpr (kAsync) {
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();  // this head's copies have landed
    }
    __syncthreads();
    // every warp scans the chunk itself (no block barrier): l for steps
    // 32 q + lane in lq[q], then w_s = exp(l_end − l_s)·dt_s
    const float a_head = A[head];
    float lq[4], wq[4], carry = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = dts[32 * q + lane] * a_head;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += up;
      }
      lq[q] = v + carry;
      carry = __shfl_sync(0xffffffffu, lq[q], 31);
    }
    const float l_end = carry;  // padded steps add 0
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wq[q] = expf(l_end - lq[q]) * dts[32 * q + lane];
    const long long bhk = (static_cast<long long>(b) * nh + head) * NC + k;
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) lout[bhk * kMaxChunk + 32 * q + lane] = lq[q];
    }

    // s[p][n] = Σ_s (w_s x_s[p]) B_s[n]: rows p of this warp, 4 n-tiles;
    // slice q holds steps [32 q, 32 q + 32), whose weights are wq[q]
    float acc[4][4] = {};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (32 * q >= kend) break;
      float part[4][4] = {};
#pragma unroll
      for (int kk = 32 * q; kk < 32 * q + kSlice; kk += KS) {
        if (kk >= kend) break;
        float w[KS / 4];
#pragma unroll
        for (int i = 0; i < KS / 4; ++i)
          w[i] = __shfl_sync(0xffffffffu, wq[q], kk - 32 * q + weight_k<T>(i));
        FragA a;
        a_cols_scaled<LD>(xs, w, m0, kk, a);
        if constexpr (std::is_same_v<T, bf16>) {
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            FragB bf[2];
            b2_cols_ldm<LD>(bs, kk, n0 + 8 * j, bf);
            mma<T, true, false>(part[j], a, bf[0]);
            mma<T, true, false>(part[j + 1], a, bf[1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragB bf;
            b_cols<LD>(bs, kk, n0 + 8 * j, bf);
            mma<T, true, false>(part[j], a, bf);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
    float* out = states + bhk * hd * ds;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = m0 + g + (e >> 1) * 8, n = n0 + 8 * j + 2 * t + (e & 1);
        if (p < hd && n < ds) out[p * ds + n] = acc[j][e];
      }
    __syncthreads();  // this head's buffers are free for the one after next
  }
}

// ---- (ii) state passing ---------------------------------------------------
// kVec consecutive elements a thread (float4 where hd·ds is a multiple of
// 4), loads kAhead chunks ahead of the stores. A chunk's decay is
// exp(l_end), l_end the last of its l (padded steps add 0).
template <int kVec>
__global__ void __launch_bounds__(kStateThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ l,
               float* __restrict__ final_state, int nh, int NC, int hdds) {
  using V = std::conditional_t<kVec == 4, float4, float>;
  const int e = (blockIdx.x * kStateThreads + threadIdx.x) * kVec;
  if (e >= hdds) return;
  const long long bh = static_cast<long long>(blockIdx.z) * nh + blockIdx.y;
  V* s = reinterpret_cast<V*>(states + bh * NC * hdds + e);
  const long long step = hdds / kVec;  // one chunk, in V
  const float* l_end = l + bh * NC * kMaxChunk + kMaxChunk - 1;
  V sv[kAhead];
  float av[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < NC) {
      sv[j] = s[j * step];
      av[j] = expf(l_end[j * kMaxChunk]);
    }
  }
  float h[kVec] = {};
  for (int k0 = 0; k0 < NC; k0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int k = k0 + j;
      if (k < NC) {
        const V cur = sv[j];
        const float ak = av[j];
        if (k + kAhead < NC) {  // load ahead, before this chunk's store
          sv[j] = s[(k + kAhead) * step];
          av[j] = expf(l_end[(k + kAhead) * kMaxChunk]);
        }
        if constexpr (kVec == 4) {
          s[k * step] = make_float4(h[0], h[1], h[2], h[3]);  // entering k
          h[0] = ak * h[0] + cur.x;
          h[1] = ak * h[1] + cur.y;
          h[2] = ak * h[2] + cur.z;
          h[3] = ak * h[3] + cur.w;
        } else {
          s[k * step] = h[0];  // the state entering chunk k
          h[0] = ak * h[0] + cur;
        }
      }
    }
  }
  if (final_state != nullptr) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) final_state[bh * hdds + e + i] = h[i];
  }
}

// ---- (iii) outputs --------------------------------------------------------
// C·Bᵀ and M are kept for their causal 16 x 16 tiles only: row tile mt
// (rows 16 mt .. 16 mt + 15) holds columns [0, 16 (mt + 1)) with a row
// stride of 16 (mt + 1) + pad (pad 4 for TF32, 8 for bf16 pairs: the
// fragment loads stay free of bank conflicts). 56% of the square.
template <typename T>
struct Tri {
  static constexpr int kPad = Pad<T>::kCB - kMaxChunk;
  __device__ static constexpr int ld(int mt) { return 16 * (mt + 1) + kPad; }
  __device__ static constexpr int base(int mt) {
    return 128 * mt * (mt + 1) + 16 * kPad * mt;
  }
  static constexpr int kFloats = 128 * 8 * 9 + 16 * kPad * 8;
};

template <typename T>
struct OutSmem {
  static constexpr int kTri = Tri<T>::kFloats * 4;  // C·Bᵀ; M
  static constexpr int kC = kMaxChunk * Pad<T>::kRow * static_cast<int>(sizeof(T));
  static constexpr int kX =  // B (at kRow), then two buffers of x
      kMaxChunk * (Pad<T>::kRow > Pad<T>::kCol ? Pad<T>::kRow : Pad<T>::kCol) *
      static_cast<int>(sizeof(T));
  static constexpr int kH = kWidth * Pad<T>::kRow * 4;  // two buffers
  // bf16: the head's h split into bf16 hi and lo (as many bytes as h), and
  // y staged for row-wise stores
  static constexpr int kHSplit = std::is_same_v<T, bf16> ? kH : 0;
  static constexpr int kY =
      std::is_same_v<T, bf16> ? kMaxChunk * Pad<T>::kCol * 2 : 0;
  static constexpr int kBytes = 2 * kTri + kC + 2 * kX + 2 * kH + kHSplit +
                                kY + 4 * kMaxChunk * 4;  // dt, l: two each
};

template <typename T, bool kAsync>
__global__ void __launch_bounds__(kOutThreads)
ssd_outputs(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bc,
            const T* __restrict__ Cc, const float* __restrict__ states,
            const float* __restrict__ lin, T* __restrict__ y, int S, int nh,
            int hd, int ds, int chunk, int NC, int hpb) {
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  constexpr int LR = Pad<T>::kRow, LX = Pad<T>::kCol, KS = Pad<T>::kK;
  using Sm = OutSmem<T>;
  using Tr = Tri<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cb = reinterpret_cast<float*>(smem);
  float* ms = reinterpret_cast<float*>(smem + Sm::kTri);
  T* cs = reinterpret_cast<T*>(smem + 2 * Sm::kTri);
  unsigned char* x_at = smem + 2 * Sm::kTri + Sm::kC;
  float* hb = reinterpret_cast<float*>(x_at + 2 * Sm::kX);  // two buffers
  float* dtb = hb + 2 * kWidth * LR;                         // two buffers
  float* lb = dtb + 2 * kMaxChunk;                           // two buffers
  // bf16: M as split hi and lo bf16 arrays in M's bytes, and the head's h
  // split likewise, so the products load ready fragments
  bf16* m_hi = reinterpret_cast<bf16*>(ms);
  bf16* m_lo = m_hi + Tr::kFloats;
  bf16* hs_hi = reinterpret_cast<bf16*>(lb + 2 * kMaxChunk);
  bf16* hs_lo = hs_hi + kWidth * LR;
  bf16* ys = hs_lo + kWidth * LR;  // [128][LX]

  const int k = blockIdx.x, b = blockIdx.z;
  const int c0 = k * chunk, L = min(chunk, S - c0);
  const int nrt = (L + 15) / 16;
  const long long row0 = static_cast<long long>(b) * S + c0;
  const long long xstride = static_cast<long long>(nh) * hd;
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int head_lo = static_cast<int>(blockIdx.y) * hpb;
  const int head_hi = min(nh, head_lo + hpb);
  auto xbuf = [&](int i) { return reinterpret_cast<T*>(x_at + i * Sm::kX); };
  auto bhk = [&](int head) {
    return (static_cast<long long>(b) * nh + head) * NC + k;
  };

  // C, and B in x's second buffer; the first head's x, h and dt in flight
  fetch<false, kMaxChunk, LR, kOutThreads>(cs, Cc + row0 * ds, ds, L, ds);
  fetch<false, kMaxChunk, LR, kOutThreads>(xbuf(1), Bc + row0 * ds, ds, L,
                                           ds);
  fetch<kAsync, kMaxChunk, LX, kOutThreads>(xbuf(0), x + row0 * xstride +
                                                         head_lo * hd,
                                            xstride, L, hd);
  fetch<kAsync, kWidth, LR, kOutThreads>(hb, states + bhk(head_lo) * hd * ds,
                                         ds, hd, ds);
  fetch_dt<kAsync>(dtb, dt, row0, nh, head_lo, L);
  fetch_l<kAsync>(lb, lin + bhk(head_lo) * kMaxChunk);
  if constexpr (kAsync) sm90::cp_async_commit();
  __syncthreads();

  // C·Bᵀ over its causal tiles, once for the block's heads
  for (int i = warp; i < nrt * (nrt + 1); i += kOutThreads / 32) {
    int mt = 0;  // row tile mt holds n-tiles 0 .. 2mt + 1
    while ((mt + 1) * (mt + 2) <= i) ++mt;
    const int nt = i - mt * (mt + 1);
    float d[4] = {};
    for (int n0 = 0; n0 < kWidth; n0 += kSlice) {
      float part[4] = {};
#pragma unroll
      for (int kk = n0; kk < n0 + kSlice; kk += KS) {
        FragA a;
        FragB bf;
        if constexpr (kBf16) {
          a_rows_bf16(cs, LR, 16 * mt, kk, a);
          b_rows<LR>(xbuf(1), kk, 8 * nt, bf);
        } else {
          a_rows(cs, LR, 16 * mt, kk, a);
          b_rows<LR>(xbuf(1), kk, 8 * nt, bf);
        }
        mma<T, false, false>(part, a, bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] += part[e];
    }
    float* tile = cb + Tr::base(mt);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(g + (e >> 1) * 8) * Tr::ld(mt) + 8 * nt + 2 * t + (e & 1)] = d[e];
  }
  __syncthreads();  // B's buffer is free

  // a group of 4 warps multiplies row tiles {pair, 7 − pair} (16 · 9 rows
  // of M·x's causal work, the same for every group), a warp 16 of hd's 64
  // columns
  const int pair = warp >> 2, q = warp & 3;
  for (int head = head_lo; head < head_hi; ++head) {
    const int cur = (head - head_lo) & 1;
    const T* xs = xbuf(cur);
    const float* hs = hb + cur * kWidth * LR;
    const float* dts = dtb + cur * kMaxChunk;
    const float* ls = lb + cur * kMaxChunk;
    if (head + 1 < head_hi) {  // the next head's tiles, while this one runs
      const int nx = cur ^ 1;
      fetch<kAsync, kMaxChunk, LX, kOutThreads>(
          xbuf(nx), x + row0 * xstride + (head + 1) * hd, xstride, L, hd);
      fetch<kAsync, kWidth, LR, kOutThreads>(
          hb + nx * kWidth * LR, states + bhk(head + 1) * hd * ds, ds, hd,
          ds);
      fetch_dt<kAsync>(dtb + nx * kMaxChunk, dt, row0, nh, head + 1, L);
      fetch_l<kAsync>(lb + nx * kMaxChunk, lin + bhk(head + 1) * kMaxChunk);
    }
    if constexpr (kAsync) {
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();  // this head's copies have landed
    }
    __syncthreads();
    if constexpr (kBf16) {  // h split once for every warp's products
      for (int i = 2 * threadIdx.x; i < kWidth * kWidth; i += 2 * kOutThreads) {
        const int at = (i / kWidth) * LR + i % kWidth;
        uint32_t hi, lo;
        sm90::split_bf16x2(hs[at], hs[at + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(hs_hi + at) = hi;
        *reinterpret_cast<uint32_t*>(hs_lo + at) = lo;
      }
      __syncthreads();
    }
    // M[t][s] = (C_t·B_s) exp(l_t − l_s) dt_s for s <= t, else 0, over the
    // causal tiles of the rows this group of 4 warps multiplies (row tiles
    // pair and 7 − pair). Row rr of both tiles holds 4 (pair + 1) +
    // 4 (8 − pair) = 36 quads of columns, the same for every group: 8
    // threads a row pair, 4 or 5 quads each. The group then waits for its
    // own 128 threads only, so groups overlap one's M with another's
    // products. exp as ex2.approx of the difference times log2 e: 2 ulp,
    // inside the gate's 8·u32·max|l|. The select drops exp(l_t − l_s) for
    // s > t, which may be inf, without multiplying it.
    {
      const int gt = threadIdx.x & 127, rr = gt >> 3, part = gt & 7;
      const int quads_a = 4 * (pair + 1);  // tile `pair`'s quads a row
      const int mt_b = 7 - pair;
      const float l_a = ls[16 * pair + rr], l_b = ls[16 * mt_b + rr];
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int quad = (36 * part) / 8 + j;
        if (quad >= (36 * (part + 1)) / 8) break;
        const bool in_a = quad < quads_a;
        const int mt = in_a ? pair : mt_b;
        if (mt >= nrt) continue;
        const int c = 4 * (in_a ? quad : quad - quads_a);
        const int r = 16 * mt + rr;
        const int at = Tr::base(mt) + rr * Tr::ld(mt) + c;
        const float lr = in_a ? l_a : l_b;
        const float4 cv = *reinterpret_cast<const float4*>(cb + at);
        const float4 lv = *reinterpret_cast<const float4*>(ls + c);
        const float4 dv = *reinterpret_cast<const float4*>(dts + c);
        auto m_of = [&](float cbv, float lsv, float dtv, int s) {
          return s <= r ? cbv * sm90::exp2_approx((lr - lsv) * kLog2e) * dtv
                        : 0.f;
        };
        const float4 mv = make_float4(
            m_of(cv.x, lv.x, dv.x, c), m_of(cv.y, lv.y, dv.y, c + 1),
            m_of(cv.z, lv.z, dv.z, c + 2), m_of(cv.w, lv.w, dv.w, c + 3));
        if constexpr (kBf16) {  // split once, for the 4 warps that read it
          uint2 hi, lo;
          sm90::split_bf16x2(mv.x, mv.y, hi.x, lo.x);
          sm90::split_bf16x2(mv.z, mv.w, hi.y, lo.y);
          *reinterpret_cast<uint2*>(m_hi + at) = hi;
          *reinterpret_cast<uint2*>(m_lo + at) = lo;
        } else {
          *reinterpret_cast<float4*>(ms + at) = mv;
        }
      }
    }
    group_sync(1 + pair);

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int mt = ri == 0 ? pair : 7 - pair;
      if (mt >= nrt) continue;
      const int r0 = 16 * mt;
      const float* m_tile = ms + Tr::base(mt);
      float acc[2][4] = {};
      // M·x over s < 16 (mt + 1), in float32 slices; unrolled with guards
      // so that a step's loads can run ahead of the last step's products
#pragma unroll
      for (int s0 = 0; s0 < kMaxChunk; s0 += kSlice) {
        if (s0 >= r0 + 16) break;
        float part[2][4] = {};
#pragma unroll
        for (int kk = s0; kk < s0 + kSlice; kk += KS) {
          if (kk >= r0 + 16) break;
          FragA a;
          if constexpr (kBf16) {
            a_ldm(m_hi + Tr::base(mt), Tr::ld(mt), 0, kk, a.hi);
            a_ldm(m_lo + Tr::base(mt), Tr::ld(mt), 0, kk, a.lo);
            FragB bf[2];
            b2_cols_ldm<LX>(xs, kk, 16 * q, bf);
            mma<T, true, false>(part[0], a, bf[0]);
            mma<T, true, false>(part[1], a, bf[1]);
          } else {
            a_rows(m_tile, Tr::ld(mt), 0, kk, a);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              FragB bf;
              b_cols<LX>(xs, kk, 16 * q + 8 * j, bf);
              mma<T, true, false>(part[j], a, bf);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
      }
      // exp(l_t) · C_t·h_prevᵀ over the state's 64 columns
      float ch[2][4] = {};
      for (int n0 = 0; n0 < kWidth; n0 += kSlice) {
        float part[2][4] = {};
#pragma unroll
        for (int kk = n0; kk < n0 + kSlice; kk += KS) {
          FragA a;
          if constexpr (kBf16) {
            a_ldm(cs, LR, r0, kk, a.hi);
            FragB bf[2];
            b2_rows_ldm<LR>(hs_hi, kk, 16 * q, bf, false);
            b2_rows_ldm<LR>(hs_lo, kk, 16 * q, bf, true);
            mma<T, false, true>(part[0], a, bf[0]);
            mma<T, false, true>(part[1], a, bf[1]);
          } else {
            a_rows(cs, LR, r0, kk, a);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              FragB bf;
              b_rows<LR>(hs, kk, 16 * q + 8 * j, bf);
              mma<T, false, true>(part[j], a, bf);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ch[j][e] += part[j][e];
      }
      const float e_lo = sm90::exp2_approx(ls[r0 + g] * kLog2e);
      const float e_hi = sm90::exp2_approx(ls[r0 + g + 8] * kLog2e);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8: two columns each
          const int r = r0 + g + 8 * h;
          const int p = 16 * q + 8 * j + 2 * t;
          const float e_r = h ? e_hi : e_lo;
          const float v0 = acc[j][2 * h] + e_r * ch[j][2 * h];
          const float v1 = acc[j][2 * h + 1] + e_r * ch[j][2 * h + 1];
          if constexpr (kBf16 && kAsync) {  // staged; stored row-wise below
            *reinterpret_cast<__nv_bfloat162*>(ys + r * LX + p) =
                __floats2bfloat162_rn(v0, v1);
            continue;
          }
          T* out = y + ((row0 + r) * nh + head) * hd + p;
          if (r >= L || p >= hd) continue;
          if (p + 1 < hd && hd % 2 == 0) {  // one store of the pair
            if constexpr (kBf16) {
              *reinterpret_cast<__nv_bfloat162*>(out) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
            }
          } else {
            out[0] = from_float<T>(v0);
            if (p + 1 < hd) out[1] = from_float<T>(v1);
          }
        }
    }
    if constexpr (kBf16 && kAsync) {
      // the group's rows of y in 16-byte pieces, whole rows at a time (the
      // per-lane pairs of the fragments would spread a warp's stores over
      // 8 rows)
      group_sync(1 + pair);
      for (int i = threadIdx.x & 127; i < 32 * 8; i += 128) {
        const int rr = i / 8, c = 8 * (i % 8);
        const int mt = rr < 16 ? pair : 7 - pair;
        const int r = 16 * mt + rr % 16;
        if (mt < nrt && r < L && c < hd)
          *reinterpret_cast<uint4*>(y + ((row0 + r) * nh + head) * hd + c) =
              *reinterpret_cast<const uint4*>(ys + r * LX + c);
      }
    }
    __syncthreads();  // this head's buffers are free for the one after next
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool kAsync>
cudaError_t run(const T* x, const float* dt, const float* A, const T* Bc,
                const T* Cc, int B, int S, int nh, int hd, int ds, int chunk,
                float* states, float* l, float* final_state, T* y,
                cudaStream_t stream) {
  const int NC = (S + chunk - 1) / chunk;
  const int groups = (nh + 31) / 32;  // a block takes up to 32 heads
  const int hpb = (nh + groups - 1) / groups;
  const dim3 grid(NC, groups, B);

  constexpr int st_bytes = states_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states<T, kAsync>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      st_bytes);
  if (err != cudaSuccess) return err;
  ssd_states<T, kAsync><<<grid, kStateThreads, st_bytes, stream>>>(
      x, dt, A, Bc, states, l, S, nh, hd, ds, chunk, NC, hpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int hdds = hd * ds;
  if (hdds % 4 == 0 && aligned16(states)) {
    ssd_state_pass<4><<<dim3((hdds / 4 + kStateThreads - 1) / kStateThreads,
                             nh, B),
                        kStateThreads, 0, stream>>>(states, l, final_state,
                                                    nh, NC, hdds);
  } else {
    ssd_state_pass<1><<<dim3((hdds + kStateThreads - 1) / kStateThreads, nh,
                             B),
                        kStateThreads, 0, stream>>>(states, l, final_state,
                                                    nh, NC, hdds);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int out_bytes = OutSmem<T>::kBytes;
  err = cudaFuncSetAttribute(ssd_outputs<T, kAsync>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out_bytes);
  if (err != cudaSuccess) return err;
  ssd_outputs<T, kAsync><<<grid, kOutThreads, out_bytes, stream>>>(
      x, dt, A, Bc, Cc, states, l, y, S, nh, hd, ds, chunk, NC, hpb);
  return cudaGetLastError();
}

// The 16-byte cp.async route where each row of x and of a state is a whole
// number of 16-byte chunks at 16-byte aligned addresses; else the loads
// are synchronous (batched).
template <typename T>
cudaError_t route(const void* x, const float* dt, const float* A,
                  const void* Bc, const void* Cc, int B, int S, int nh,
                  int hd, int ds, int chunk, float* states, float* l,
                  float* final_state, void* y, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bc);
  const T* ct = static_cast<const T*>(Cc);
  T* yt = static_cast<T*>(y);
  const int per_chunk = 16 / static_cast<int>(sizeof(T));
  const bool async = hd % per_chunk == 0 && ds % 4 == 0 && aligned16(x) &&
                     aligned16(states) && aligned16(l) && aligned16(y);
  return async ? run<T, true>(xt, dt, A, bt, ct, B, S, nh, hd, ds, chunk,
                              states, l, final_state, yt, stream)
               : run<T, false>(xt, dt, A, bt, ct, B, S, nh, hd, ds, chunk,
                               states, l, final_state, yt, stream);
}

}  // namespace

// x: (B, S, nh, hd) and Bc, Cc: (B, S, ds), float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); dt: (B, S, nh) and A: (nh,) float32; all
// contiguous; 1 <= hd, ds <= 64; 1 <= chunk <= 128; B, nh <= 65535.
// states: (B, nh, ceil(S / chunk), hd, ds) and l: (B, nh, ceil(S /
// chunk), 128) float32 scratch. final_state: null, or (B, nh, hd, ds)
// float32, fully written with the state after the last step. y: (B, S,
// nh, hd) in x's type, fully written.
extern "C" int tdorch_ssd_scan(int device, const void* x, const float* dt,
                               const float* A, const void* Bc,
                               const void* Cc, int B, int S, int nh, int hd,
                               int ds, int chunk, int is_bf16, float* states,
                               float* l, float* final_state, void* y,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || nh == 0 || hd == 0) return 0;
  if (hd > kWidth || ds > kWidth || chunk < 1 || chunk > kMaxChunk ||
      B > 65535 || nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  err = is_bf16 ? route<bf16>(x, dt, A, Bc, Cc, B, S, nh, hd, ds, chunk,
                              states, l, final_state, y, stream)
                : route<float>(x, dt, A, Bc, Cc, B, S, nh, hd, ds, chunk,
                               states, l, final_state, y, stream);
  return static_cast<int>(err);
}
