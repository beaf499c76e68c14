// GQA flash attention (forward) in bf16, for Hopper (sm_90a): tensor
// cores through `wgmma`, tiles through TMA.
//
// Replaces, for bf16 inputs, the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py:75 (`_flash_kernel`), whose
// grid (B, H, S / block_q, T / block_k) walked the key tiles of a query
// tile in order on one core, keeping the online-softmax state (m, l, acc)
// in VMEM scratch from one key tile to the next. float32 inputs take the
// 3xTF32 kernel of flash_attention_tf32.cu.
//
// o[b, r, h] = softmax_c(q[b, r, h] · k[b, c, h / G] · hd^-0.5) · v[b, c, h / G]
// with, under `causal`, the score of every key c > r set to -2.0e38 (the
// wrapper takes causal attention only for S == T). bf16 q, k, v, float32
// scores, softmax and sums, the output rounded to bf16. hd 32, 64 or 128.
//
// What bounds it on this card: operations. A causal zamba2 prefill
// (S = 32,768, 32 heads of 64) does 4.4 TFLOP of products, ~4.4 ms at the
// card's 989 TFLOP/s in bf16 and ~70x that in float32 FMAs. So the design
// is about keeping the tensor cores busy:
// - One block per (tile of 128 query rows, query head, batch row): two
//   consumer warpgroups of 64 rows (`wgmma`'s m64) and a producer
//   warpgroup, one thread of which issues the loads. The producer gives
//   up its registers (`setmaxnreg` 24) so that each consumer thread may
//   hold 240. Head h reads KV head h / G through its coordinates (no copy
//   of k or v a query head; the G heads of a KV head meet in L2).
// - The producer loads the q tile once and streams key and value tiles of
//   128 rows through TMA into a ring of kStages stages, with a full and an
//   empty mbarrier a stage. TMA reads the (B, S, H, hd) and (B, T, KV, hd)
//   tensors in place through 4-D maps (hd, H or KV, S or T, B), swizzled
//   128 B (64 B at hd 32) as `wgmma` reads them; rows past S or T read as
//   zeros.
// - S = Q·Kᵀ is one `wgmma` m64n128k16 a 16-wide slice of hd, both
//   operands in shared memory, K K-major as it lies. The online softmax
//   runs on the accumulator registers in base 2 (scale·log2 e folded into
//   the exponent's fma): a row's maximum and sum need the 4 threads of its
//   quad.
// - P·V takes P from registers as `wgmma`'s A operand, V's tile from
//   shared memory MN-major (the transpose bit). P is split as hi = bf16(p)
//   and lo = bf16(p − hi), two products into the same float32 sums: one
//   bf16 rounding of p errs by up to 2^-9 of each weight, which puts rows
//   with few keys and |o| near 0 tens of times past the bf16 gate
//   (tests/test_torch_attention.py pins it); hi + lo keeps ~2^-17. That
//   costs 1.5x the tensor-core work of the function.
// - The exponentials (64 a thread a tile, on the 16-a-clock special
//   function units) take about as long as a warpgroup's products, so the
//   two warpgroups take turns: a turn issues tile j's P·V and tile j + 1's
//   S back to back, and the warpgroup then runs tile j + 1's softmax while
//   the other's turn keeps the tensor cores busy. Every turn issues the
//   same products (past the last tile S reads a stale stage and is
//   dropped): a branch around a `wgmma` makes ptxas serialize them all.
// - Under `causal`, key tiles past the query tile's last row are not
//   loaded, only the diagonal tile is masked, and the tiles with most work
//   (the last query tiles) are launched first. Keys past T score -inf
//   (weight exactly 0); query rows past S are not stored.
// - For the backward (flash_attention_bwd_sm90.cu) the epilogue can also
//   write each row's log-sum-exp, m·ln 2 + ln l, from the maxima and sums
//   the softmax already holds: one thread of a quad, two floats, no
//   register held through the loop.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using sm90::descriptor;
using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_wait;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_rs;
using sm90::wgmma_ss_n128;
using sm90::wgmma_wait_all;

constexpr float kMasked = -2.0e38f;  // score of a key after the query
constexpr float kLn2 = 0.6931471805599453f;  // the maxima are in base 2
constexpr int kBQ = 128;             // query rows a block
constexpr int kConsumers = 256;      // two warpgroups of 64 query rows
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup

template <int HD>
struct Tile {
  static constexpr int kRowBytes = HD * 2 < 128 ? HD * 2 : 128;  // swizzle
  static constexpr int kAtoms = HD * 2 / kRowBytes;  // column blocks of hd
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBK = 128;  // keys a tile (S is m64n128 a warpgroup)
  static constexpr int kStages = HD == 128 ? 3 : 4;  // 225 / 145 / 73 KB
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;      // one K or V tile
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes;
  // wgmma descriptor's layout type: 1 = 128 B swizzle, 2 = 64 B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
};

// Turn-taking between the two consumer warpgroups: named barrier 1 + w
// opens warpgroup w's turn; each turn needs its own 128 threads (bar.sync)
// and the other warpgroup's 128 (bar.arrive).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kConsumers)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + wg), "n"(kConsumers)
               : "memory");
}

// One tile's softmax on the accumulator registers of S (raw scores):
// masks (the diagonal tile, keys past T), row maxima and sums across the
// quad in base 2 (scale folded into the exponent's fma), the rescale
// factors (a0, a1) for the rows' earlier sums, and P split into hi / lo A
// fragments for P·V.
template <int BK>
struct Softmax {
  float m0 = kMasked, m1 = kMasked;  // running maxima, scaled (base 2)
  float l0 = 0.f, l1 = 0.f;          // running sums, this thread's columns

  __device__ __forceinline__ void tile(float (&sc)[BK / 2],
                                       uint32_t (&p_hi)[BK / 16][4],
                                       uint32_t (&p_lo)[BK / 16][4],
                                       float& a0, float& a1, bool mask,
                                       int k0, int Tn, int causal, int r0,
                                       int r1, int t, float scale_log2) {
    if (mask) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int c = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (c >= Tn) sc[i] = -INFINITY;
        else if (causal && c > (i & 2 ? r1 : r0)) sc[i] = kMasked;
      }
    }
    // row maxima in 4 independent chains a row (columns i mod 4)
    float x0[4], x1[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x0[u] = sc[4 * (u / 2) + (u % 2)];
      x1[u] = sc[4 * (u / 2) + 2 + (u % 2)];
    }
#pragma unroll
    for (int i = 2; i < BK / 8; i += 2)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x0[u] = fmaxf(x0[u], sc[4 * (i + u / 2) + (u % 2)]);
        x1[u] = fmaxf(x1[u], sc[4 * (i + u / 2) + 2 + (u % 2)]);
      }
    float mx0 = fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3]));
    float mx1 = fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // scale > 0, so the scaled maximum is the maximum of the scaled scores
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    a0 = sm90::exp2_approx(m0 - mx0);
    a1 = sm90::exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int u = 0; u < 4; ++u) x0[u] = x1[u] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float p0 = sm90::exp2_approx(fmaf(sc[4 * i], scale_log2, -mx0));
      const float p1 =
          sm90::exp2_approx(fmaf(sc[4 * i + 1], scale_log2, -mx0));
      const float p2 =
          sm90::exp2_approx(fmaf(sc[4 * i + 2], scale_log2, -mx1));
      const float p3 =
          sm90::exp2_approx(fmaf(sc[4 * i + 3], scale_log2, -mx1));
      x0[i % 4] += p0 + p1;  // row sums in 4 chains too
      x1[i % 4] += p2 + p3;
      // A fragment of k-slice i / 2: {row g, row g + 8} x {cols 2t, 8 + 2t}
      const int kk = i / 2, hi8 = (i % 2) * 2;
      sm90::split_bf16x2(p0, p1, p_hi[kk][hi8], p_lo[kk][hi8]);
      sm90::split_bf16x2(p2, p3, p_hi[kk][hi8 + 1], p_lo[kk][hi8 + 1]);
    }
    l0 = l0 * a0 + ((x0[0] + x0[1]) + (x0[2] + x0[3]));
    l1 = l1 * a1 + ((x1[0] + x1[1]) + (x1[2] + x1[3]));
  }
};

// S = Q · Kᵀ for one warpgroup's 64 rows over hd, in slices of 16 (32
// bytes of a swizzled row): Q and K both K-major in shared memory.
template <int HD>
__device__ __forceinline__ void issue_s(float (&sc)[Tile<HD>::kBK / 2],
                                        uint32_t q_base, uint32_t k_base) {
  using C = Tile<HD>;
  constexpr int kRB = C::kRowBytes;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int atom = ks * 32 / kRB, off = ks * 32 % kRB;
    const uint64_t dq = descriptor(q_base + atom * kBQ * kRB + off, 16,
                                   8 * kRB, C::kLayout);
    const uint64_t dk = descriptor(k_base + atom * C::kBK * kRB + off, 16,
                                   8 * kRB, C::kLayout);
    wgmma_ss_n128(sc, dq, dk, ks > 0);
  }
}

// O += (P_hi + P_lo) · V, 16 keys a step: P from registers, V MN-major.
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&acc)[HD / 2], const uint32_t (&p_hi)[Tile<HD>::kBK / 16][4],
    const uint32_t (&p_lo)[Tile<HD>::kBK / 16][4], uint32_t v_base) {
  using C = Tile<HD>;
  constexpr int kRB = C::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < C::kBK / 16; ++kk) {
    const uint64_t dv = descriptor(v_base + kk * 16 * kRB, C::kBK * kRB,
                                   8 * kRB, C::kLayout);
    wgmma_rs<HD>(acc, p_hi[kk], dv);
    wgmma_rs<HD>(acc, p_lo[kk], dv);
  }
}

// One block per (tile of kBQ query rows, query head, batch row): warps 0-7
// are two consumer warpgroups (64 query rows each), warps 8-11 the
// producer warpgroup (one thread of it issues the loads). The producer
// gives up registers (setmaxnreg) so that each consumer thread has 240.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_sm90(const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
        int Tn, int H, int G, float scale_log2, int causal) {
  using C = Tile<HD>;
  constexpr int kBK = C::kBK, kStages = C::kStages, kRB = C::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], q_full;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                 // kAtoms blocks of (kBQ x kRB bytes)
  uint8_t* ring = smem + C::kQBytes;  // a stage: K tile, then V tile

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int k_end = causal ? min(Tn, q0 + kBQ) : Tn;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);
    }
    sm90::mbar_init(&q_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(&q_full, C::kQBytes);
      for (int a = 0; a < C::kAtoms; ++a)
        sm90::tma_load_4d(qs + a * kBQ * kRB, &q_map, &q_full,
                          a * C::kBoxCols, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKVBytes);
        uint8_t* ks = ring + s * 2 * C::kKVBytes;
        uint8_t* vs = ks + C::kKVBytes;
        for (int a = 0; a < C::kAtoms; ++a) {
          sm90::tma_load_4d(ks + a * kBK * kRB, &k_map, &full[s],
                            a * C::kBoxCols, kvh, j * kBK, b);
          sm90::tma_load_4d(vs + a * kBK * kRB, &v_map, &full[s],
                            a * C::kBoxCols, kvh, j * kBK, b);
        }
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4, wi = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int warp_row = q0 + wg * 64 + wi * 16;  // first row of this warp
    const int r0 = warp_row + g, r1 = r0 + 8;     // this thread's two rows
    const uint32_t q_base = sm90::smem_addr(qs) + wg * 64 * kRB;
    const uint32_t ring_base = sm90::smem_addr(ring);
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    Softmax<kBK> sm;
    float sc[kBK / 2], a0, a1;
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];

    // Each warpgroup's turn issues tile j's P·V and tile j + 1's S = Q·Kᵀ
    // back to back, then it waits for both and runs tile j + 1's softmax
    // while the other warpgroup's turn keeps the tensor cores busy. The
    // turns alternate: bar.sync on the warpgroup's own barrier, bar.arrive
    // on the other's.
    if (wg == 1) turn_pass(0);
    mbar_wait(&q_full, 0);
    mbar_wait(&full[0], 0);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    turn_wait(wg);
    wgmma_fence();
    issue_s<HD>(sc, q_base, ring_base);
    wgmma_commit();
    turn_pass(wg ^ 1);
    wgmma_wait_all();
    fence_regs(sc);
    sm.tile(sc, p_hi, p_lo, a0, a1,
            kBK > Tn || (causal && kBK - 1 > warp_row), 0, Tn, causal, r0,
            r1, t, scale_log2);
    for (int j = 0; j < n_tiles; ++j) {
      const bool next = j + 1 < n_tiles;
      const uint32_t v_base =
          ring_base + (j % kStages) * 2 * C::kKVBytes + C::kKVBytes;
      const uint32_t k_next =
          ring_base + ((j + 1) % kStages) * 2 * C::kKVBytes;
      if (next) mbar_wait(&full[(j + 1) % kStages], ((j + 1) / kStages) & 1);
      // past the last tile S reads a stage no load is writing and is
      // dropped: one path for every turn keeps the products asynchronous
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
      turn_wait(wg);
      wgmma_fence();
      issue_pv<HD>(acc, p_hi, p_lo, v_base);
      issue_s<HD>(sc, q_base, k_next);
      wgmma_commit();
      if (wg == 0 || next) turn_pass(wg ^ 1);  // none after the last turn
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
      if (next) {
        const int k0 = (j + 1) * kBK;
        sm.tile(sc, p_hi, p_lo, a0, a1,
                k0 + kBK > Tn || (causal && k0 + kBK - 1 > warp_row), k0,
                Tn, causal, r0, r1, t, scale_log2);
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          acc[4 * i] *= a0;
          acc[4 * i + 1] *= a0;
          acc[4 * i + 2] *= a1;
          acc[4 * i + 3] *= a1;
        }
      }
    }

    float l0 = sm.l0, l1 = sm.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (lse != nullptr && t == 0) {  // the backward's row log-sum-exp
      float* lb = lse + (static_cast<long long>(b) * H + h) * S;
      if (r0 < S) lb[r0] = sm.m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
      if (r1 < S) lb[r1] = sm.m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
    }
    const long long row_stride = static_cast<long long>(H) * HD;
    __nv_bfloat16* ob = o + static_cast<long long>(b) * S * row_stride +
                        static_cast<long long>(h) * HD + 2 * t;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * row_stride + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (r1 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * row_stride + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2] * inv1,
                                  acc[4 * i + 3] * inv1);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int Tn, int H, int KV,
                   float scale_log2, int causal, cudaStream_t stream) {
  using C = Tile<HD>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err =
      sm90::make_map(&q_map, q, HD, H, S, B, C::kBoxCols, 1, kBQ);
  if (err == cudaSuccess)
    err = sm90::make_map(&k_map, k, HD, KV, Tn, B, C::kBoxCols, 1, C::kBK);
  if (err == cudaSuccess)
    err = sm90::make_map(&v_map, v, HD, KV, Tn, B, C::kBoxCols, 1, C::kBK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_sm90<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fa_sm90<HD><<<grid, kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, S, Tn, H,
      H / KV, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, HD); k, v: (B, T, KV, HD) with H = KV * G; all bfloat16,
// contiguous and 16-byte aligned; HD 32, 64 or 128. o: (B, S, H, HD)
// bfloat16, fully written. lse: null, or (B, H, S) float32 that takes each
// row's log-sum-exp of its scaled scores (what the backward needs; serving
// passes null). causal needs S == T (the wrapper checks).
extern "C" int tdorch_flash_attention_sm90(int device, const void* q,
                                           const void* k, const void* v,
                                           int B, int S, int Tn, int H,
                                           int KV, int HD, float scale,
                                           int causal, void* o, float* lse,
                                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  const float scale_log2 = scale * 1.4426950408889634f;
  switch (HD) {
    case 32:
      err = launch<32>(q, k, v, o, lse, B, S, Tn, H, KV, scale_log2,
                        causal, stream);
      break;
    case 64:
      err = launch<64>(q, k, v, o, lse, B, S, Tn, H, KV, scale_log2,
                        causal, stream);
      break;
    case 128:
      err = launch<128>(q, k, v, o, lse, B, S, Tn, H, KV, scale_log2,
                        causal, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
