// GQA flash attention (forward) in float32 for Hopper (sm_90a): the
// products on the tensor cores in 3xTF32, the route for float32 inputs
// (bf16 inputs take flash_attention_sm90.cu).
//
// Replaces, for float32 inputs, the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py:75 (`_flash_kernel`), whose
// grid (B, H, S / block_q, T / block_k) walked the key tiles of a query
// tile in order on one core, keeping the online-softmax state (m, l, acc)
// in VMEM scratch from one key tile to the next.
//
// o[b, r, h] = softmax_c(q[b, r, h] · k[b, c, h / G] · hd^-0.5) · v[b, c, h / G]
// with, under `causal`, the score of every key c > r set to -2.0e38 (the
// wrapper takes causal attention only for S == T). float32 q, k, v,
// scores, softmax, sums and output. hd 32, 64 or 128.
//
// What bounds it on this card: operations. A causal zamba2 prefill
// (S = 32,768, 32 heads of 64) does 4.4 TFLOP of products: 66 ms in
// float32 FMAs (67 TFLOP/s), 27 ms in 3xTF32 at the card's 495 TFLOP/s in
// TF32. The design is about float32 accuracy at tensor-core speed:
// - 3xTF32: every operand of Q·Kᵀ and P·V is split in registers into
//   TF32 hi (a truncated) and lo = a - hi (truncated to TF32 by the tensor
//   core; `sm90::split_tf32`), and hi·hi + hi·lo + lo·hi go into float32
//   sums (`sm90::mma_3xtf32`). One TF32 rounding of the operands misses the
//   float32 gate of 2e-5·(1+|ref|) several times over
//   (tests/test_torch_tf32.py pins it); the split keeps 21 bits.
// - `mma.sync` m16n8k8 with fragments read by plain shared-memory loads.
//   TF32 `wgmma` takes B K-major from shared memory only, and V (keys x
//   hd, hd contiguous) is N-major as the B of P·V: it would need a
//   transposing split pass and hi/lo copies in shared memory, which at
//   hd 128 leave no room for a ring. With `mma.sync` Q, K and V are read
//   as they lie, and the S accumulators are P's A fragments without a
//   shuffle (below). The price: `mma.sync` reaches well under `wgmma`'s
//   TF32 rate on this card, and that rate, not the splits, the loads or
//   the exponentials, is what this kernel runs at (splitting K and V once
//   a block, issuing the next tile's S before the softmax, and two 64-row
//   blocks an SM each left its time as it was). TF32 `wgmma` is the next
//   step.
// - One block of 8 warps per (tile of 128 query rows, query head, batch
//   row), 16 query rows a warp; head h reads KV head h / G through its
//   offsets (the G heads of a KV head meet in L2). The q tile and key /
//   value tiles of kBK keys (64, or 32 at hd 128) pass through shared
//   memory by `cp.async`, the key and value tiles through a ring of
//   kStages stages, rows padded so that every fragment load hits 32 banks
//   (q and k rows hd + 8 floats, v rows hd + 4).
// - The depth of each k8 step is permuted, slot t <-> 2t and t + 4 <->
//   2t + 1, the same in A and B: for Q·Kᵀ a thread's two values of a row
//   of q or k lie side by side (one float2 load); for P·V the accumulator
//   of S holds keys (2t, 2t + 1) of each 8, which are then exactly the A
//   fragment's slots (t, t + 4), and v is read at those keys.
// - Online softmax in base 2 on the accumulators (scale · log2 e folded
//   into the exponent's fma), a row's maximum and sum across the 4 threads
//   of its quad; P split hi/lo in registers.
// - The tensor core truncates the float32 sum it writes (round toward
//   zero): a P·V sum carried over 32,768 keys would drift by up to 2^-23
//   of itself per product. Each key tile's P·V goes into sums of its own,
//   added to O in float32 (rounded to nearest) with the rescale's fma.
// - Under `causal`, key tiles past the query tile's last row are not
//   loaded, a warp skips the tiles past its own last row, only tiles that
//   reach past a warp's first row are masked, and the tiles with most work
//   (the last query tiles) are launched first. Keys past T score -inf
//   (weight exactly 0); query rows past S are not stored.
// - For the backward (flash_attention_bwd_tf32_sm90.cu) the epilogue can
//   also write each row's log-sum-exp, m·ln 2 + ln l (one thread of a
//   quad).

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr float kMasked = -2.0e38f;  // score of a key after the query
constexpr float kLn2 = 0.6931471805599453f;  // the maxima are in base 2
constexpr int kBQ = 128;             // query rows a block
constexpr int kThreads = 256;        // 8 warps of 16 query rows
constexpr int kStages = 3;

template <int HD>
struct Tile {
  static constexpr int kBK = HD == 128 ? 32 : 64;  // keys a tile
  static constexpr int kLdQ = HD + 8;  // q and k rows (float2 fragments)
  static constexpr int kLdV = HD + 4;  // v rows (scalar fragments)
  static constexpr int kQFloats = kBQ * kLdQ;
  static constexpr int kKFloats = kBK * kLdQ;
  static constexpr int kStageFloats = kKFloats + kBK * kLdV;
  // 78,848 / 144,384 / 172,544 bytes at hd 32 / 64 / 128
  static constexpr int kSmem = (kQFloats + kStages * kStageFloats) * 4;
  static_assert(kLdQ % 32 == 8 && kLdV % 32 == 4, "conflict-free fragments");
};

// Copy `rows` rows of hd floats, row i from src + i * src_row (zeros for
// rows at or past `valid`), into shared rows of `ld` floats, 16 bytes a
// copy, spread over the block.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long long src_row, int rows,
                                          int valid) {
  for (int c = threadIdx.x; c < rows * (HD / 4); c += kThreads) {
    const int r = c / (HD / 4), d = (c % (HD / 4)) * 4;
    const bool in = r < valid;
    sm90::cp_async16(dst + r * ld + d, in ? src + r * src_row + d : src,
                     in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_tf32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ o,
        float* __restrict__ lse, int S, int Tn, int H, int KV, int G,
        float scale_log2, int causal) {
  using C = Tile<HD>;
  constexpr int kBK = C::kBK, kLdQ = C::kLdQ, kLdV = C::kLdV;
  constexpr int kNT = kBK / 8;  // key n-tiles of S, k-steps of P·V
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = smem + C::kQFloats;  // a stage: K tile, then V tile

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int k_end = causal ? min(Tn, q0 + kBQ) : Tn;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int warp_row = q0 + 16 * warp;  // first row of this warp
  const int r0 = warp_row + g, r1 = r0 + 8;

  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const float* qb = q + (static_cast<long long>(b) * S + q0) * q_row +
                    static_cast<long long>(h) * HD;
  const float* kb = k + static_cast<long long>(b) * Tn * kv_row +
                    static_cast<long long>(kvh) * HD;
  const float* vb = v + static_cast<long long>(b) * Tn * kv_row +
                    static_cast<long long>(kvh) * HD;
  auto load_tile = [&](int j) {
    float* ks = ring + (j % kStages) * C::kStageFloats;
    const int k0 = j * kBK;
    load_rows<HD>(ks, kLdQ, kb + k0 * kv_row, kv_row, kBK, Tn - k0);
    load_rows<HD>(ks + C::kKFloats, kLdV, vb + k0 * kv_row, kv_row, kBK,
                  Tn - k0);
  };

  // group 0: the q tile and key tile 0; then one group a tile
  load_rows<HD>(qs, kLdQ, qb, q_row, kBQ, S - q0);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_tile(j);
    sm90::cp_async_commit();
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = kMasked, m1 = kMasked;  // running maxima, scaled (base 2)
  float l0 = 0.f, l1 = 0.f;          // running sums, this thread's columns
  const float* qw = qs + (16 * warp + g) * kLdQ + 2 * t;

  for (int j = 0; j < n_tiles; ++j) {
    sm90::cp_async_wait<kStages - 2>();  // tile j has landed
    __syncthreads();  // ... for every thread, and tile j - 1's stage is free
    if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);
    sm90::cp_async_commit();
    const int k0 = j * kBK;
    if (causal && k0 > warp_row + 15) continue;  // all masked for this warp
    const float* ks = ring + (j % kStages) * C::kStageFloats;
    const float* vs = ks + C::kKFloats;

    // S = Q · Kᵀ: m16 rows of this warp x kBK keys, hd deep
    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float2 qa = *reinterpret_cast<const float2*>(qw + 8 * kk);
      const float2 qc =
          *reinterpret_cast<const float2*>(qw + 8 * kLdQ + 8 * kk);
      uint32_t a_hi[4], a_lo[4];
      sm90::split_tf32(qa.x, a_hi[0], a_lo[0]);
      sm90::split_tf32(qc.x, a_hi[1], a_lo[1]);
      sm90::split_tf32(qa.y, a_hi[2], a_lo[2]);
      sm90::split_tf32(qc.y, a_hi[3], a_lo[3]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 kf = *reinterpret_cast<const float2*>(
            ks + (8 * n + g) * kLdQ + 8 * kk + 2 * t);
        uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
        sm90::split_tf32(kf.x, b_hi0, b_lo0);
        sm90::split_tf32(kf.y, b_hi1, b_lo1);
        sm90::mma_3xtf32(sc[n], a_hi, a_lo, b_hi0, b_hi1, b_lo0, b_lo1);
      }
    }

    // sc[n] = {(r0, c), (r0, c + 1), (r1, c), (r1, c + 1)}, c = k0 + 8n + 2t
    if (k0 + kBK > Tn || (causal && k0 + kBK - 1 > warp_row)) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * n + 2 * t + (e & 1);
          if (c >= Tn) sc[n][e] = -INFINITY;
          else if (causal && c > (e & 2 ? r1 : r0)) sc[n][e] = kMasked;
        }
    }
    float mx0 = sc[0][0], mx1 = sc[0][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // scale > 0, so the scaled maximum is the maximum of the scaled scores
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    const float a0 = sm90::exp2_approx(m0 - mx0);
    const float a1 = sm90::exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // P as A fragments of P·V: k-step n holds keys 8n + 2t (slot t) and
    // 8n + 2t + 1 (slot t + 4) of rows r0 (a[0], a[2]) and r1 (a[1], a[3])
    uint32_t p_hi[kNT][4], p_lo[kNT][4];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float p0 = sm90::exp2_approx(fmaf(sc[n][0], scale_log2, -mx0));
      const float p1 = sm90::exp2_approx(fmaf(sc[n][1], scale_log2, -mx0));
      const float p2 = sm90::exp2_approx(fmaf(sc[n][2], scale_log2, -mx1));
      const float p3 = sm90::exp2_approx(fmaf(sc[n][3], scale_log2, -mx1));
      s0 += p0 + p1;
      s1 += p2 + p3;
      sm90::split_tf32(p0, p_hi[n][0], p_lo[n][0]);
      sm90::split_tf32(p2, p_hi[n][1], p_lo[n][1]);
      sm90::split_tf32(p1, p_hi[n][2], p_lo[n][2]);
      sm90::split_tf32(p3, p_hi[n][3], p_lo[n][3]);
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;

    // O = O · alpha + P · V, kBK keys deep, hd wide; the tile's products go
    // into sums of their own (the tensor core truncates each sum it writes,
    // so a sum carried over every key would drift), added in float32;
    // b = {v[8n + 2t][d], v[8n + 2t + 1][d]}
    const float* vp = vs + 2 * t * kLdV + g;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
        sm90::split_tf32(vp[8 * n * kLdV + 8 * i], b_hi0, b_lo0);
        sm90::split_tf32(vp[(8 * n + 1) * kLdV + 8 * i], b_hi1, b_lo1);
        sm90::mma_3xtf32(pv, p_hi[n], p_lo[n], b_hi0, b_hi1, b_lo0, b_lo1);
      }
      acc[i][0] = fmaf(acc[i][0], a0, pv[0]);
      acc[i][1] = fmaf(acc[i][1], a0, pv[1]);
      acc[i][2] = fmaf(acc[i][2], a1, pv[2]);
      acc[i][3] = fmaf(acc[i][3], a1, pv[3]);
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && t == 0) {  // the backward's row log-sum-exp
    float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    if (r0 < S) lb[r0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
    if (r1 < S) lb[r1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
  }
  float* ob = o + static_cast<long long>(b) * S * q_row +
              static_cast<long long>(h) * HD + 2 * t;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    if (r0 < S)
      *reinterpret_cast<float2*>(ob + r0 * q_row + 8 * i) =
          make_float2(acc[i][0] * inv0, acc[i][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<float2*>(ob + r1 * q_row + 8 * i) =
          make_float2(acc[i][2] * inv1, acc[i][3] * inv1);
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int S, int Tn, int H, int KV,
                   float scale_log2, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fa_tf32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fa_tf32<HD><<<grid, kThreads, Tile<HD>::kSmem, stream>>>(
      q, k, v, o, lse, S, Tn, H, KV, H / KV, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, HD); k, v: (B, T, KV, HD) with H = KV * G; all float32,
// contiguous and 16-byte aligned; HD 32, 64 or 128. o: (B, S, H, HD)
// float32, fully written. lse: null, or (B, H, S) float32 that takes each
// row's log-sum-exp of its scaled scores (what the backward needs; serving
// passes null). causal needs S == T (the wrapper checks).
extern "C" int tdorch_flash_attention_tf32(int device, const void* q,
                                           const void* k, const void* v,
                                           int B, int S, int Tn, int H,
                                           int KV, int HD, float scale,
                                           int causal, void* o, float* lse,
                                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  switch (HD) {
    case 32:
      err = launch<32>(qf, kf, vf, of, lse, B, S, Tn, H, KV, scale_log2,
                        causal, stream);
      break;
    case 64:
      err = launch<64>(qf, kf, vf, of, lse, B, S, Tn, H, KV, scale_log2,
                        causal, stream);
      break;
    case 128:
      err = launch<128>(qf, kf, vf, of, lse, B, S, Tn, H, KV, scale_log2,
                        causal, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
