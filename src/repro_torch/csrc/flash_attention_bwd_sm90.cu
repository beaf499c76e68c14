// GQA flash attention, backward, in bf16 for Hopper (sm_90a): dq, dk and dv
// of o = softmax(q · kᵀ · hd^-0.5) · v from the forward's o and its row
// log-sum-exp, on the tensor cores through `wgmma`, tiles through TMA.
// float32 inputs take the 3xTF32 kernels of flash_attention_bwd.cu.
//
// Replaces, for bf16 inputs, the backward rule of the JAX package's flash
// attention, its custom VJP `_flash_bwd_rule` (src/repro/models/
// attention.py:137), which XLA runs as a scan over key chunks (not a Pallas
// kernel; the forward it differentiates is `flash_attention`'s, the TPU
// kernel src/repro/kernels/flash_attention/kernel.py:75 that
// flash_attention_sm90.cu ports). The arithmetic is that rule's:
//   P   = exp(s − lse),  s = q · k · hd^-0.5 (−2e38 above the diagonal
//         under `causal`), lse the forward's row log-sum-exp;
//   D   = rowsum(dO ⊙ O);
//   dS  = P ⊙ (dO · vᵀ − D);
//   dq  = dS · k · hd^-0.5,  dk = dSᵀ · q · hd^-0.5,  dv = Pᵀ · dO,
// dk and dv summed over the G query heads of their KV head. bf16 operands,
// float32 sums; P and dS are rounded to bf16 once before their products
// (the rule keeps them in float32; the gate chip_smoke.py holds the kernels
// to covers that rounding). hd 32, 64 or 128.
//
// What bounds it on this card: operations. The backward does the forward's
// two products over the causal half three more times (dq, dk, dv, and S and
// dP again): 5 · 2·B·H·S²·hd/2 FLOP, 0.695 ms at 989 TFLOP/s for
// tinyllama's training shape (4, 4096, 32 heads, 4 KV heads, 64). This
// design computes S and dP in both of its main kernels (7 products, a floor
// of 0.97 ms there) so that no sum needs atomics and a step is
// deterministic. Three kernels:
// - fa_bwd_pre_sm90: D, one 16-byte vector a thread, a row's vectors summed
//   across its lanes.
// - fa_bwd_dkdv_sm90: one block per (128 keys, KV head, batch row): two
//   consumer warpgroups of 64 keys (`wgmma`'s m64) and a producer
//   warpgroup (`setmaxnreg` 40, so a consumer thread may hold 232
//   registers). The block's K and V tiles arrive once by TMA and stay; one
//   producer thread streams Q and dO tiles of kRows rows (128 at hd <= 64,
//   64 at hd 128, where dk and dv alone take 128 registers a thread) of the
//   G query heads, the query tiles at or after the block's first key (all
//   without `causal`), into a ring of kStages stages with a full and an
//   empty mbarrier each, and a producer warp writes each stage's rows of
//   lse·log2 e (+inf past S) and D beside it. A step: Sᵀ = K·Qᵀ and dPᵀ =
//   V·dOᵀ by `wgmma` with both operands in shared memory, K-major as they
//   lie (m64n128k16 at hd <= 64); Pᵀ by exp2 (scale·log2 e folded into its
//   fma) and dSᵀ on the accumulator registers, each packed to bf16 as the A
//   fragments of dv += Pᵀ·dO and dk += dSᵀ·Q (`wgmma` with A from
//   registers, dO and Q MN-major by the transpose bit). dk and dv stay on
//   the tensor core through the whole walk and are written once, dk
//   scaled, in bf16.
// - fa_bwd_dq_sm90: one block per (128 query rows, head, batch row), the
//   same structure: Q, dO and the rows' lse and D once, K and V tiles of
//   kKT keys (128 at hd <= 64, 64 at hd 128) streamed up to the diagonal
//   (all without `causal`); S = Q·Kᵀ and dP = dO·Vᵀ, then dS, then dq +=
//   dS·K (K MN-major), a tile's dq product issued in one group with the
//   next tile's S and dP.
// - The tensor core truncates the sums it carries (each k16 step's 16
//   products added to the sum and cut toward zero). A dk or dv sum carried
//   over the 32,768 rows of 4,096 positions × G = 8 heads drifts by at most
//   2^-23 of itself a k16 step, 2^-12 over its 2,048 steps on same-sign
//   terms, well inside the gate's 2^-7·Σ|terms|; tests/test_torch_flash_bwd.py
//   emulates these sums step for step against the JAX rule.
// - Under `causal` only tiles that cross the diagonal are masked, and the
//   blocks with most work are launched first (the first key tiles for dk /
//   dv, the last query tiles for dq). Rows past S read lse = +inf (P = 0)
//   and D = 0 and TMA reads them as zero rows; keys past T read as zero
//   rows, are masked out of dq and their own dk, dv are not stored.

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
using sm90::wgmma_wait_all;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kStages = 4;                  // ring depth of both kernels
// registers a thread after `setmaxnreg`: 256 x 232 + 128 x 40 of the SM's
// 65,536
constexpr int kConsumerRegs = 232, kProducerRegs = 40;

template <int HD>
struct Tile {
  static constexpr int kRowBytes = HD * 2 < 128 ? HD * 2 : 128;  // swizzle
  static constexpr int kAtoms = HD * 2 / kRowBytes;  // column blocks of hd
  static constexpr int kBoxCols = kRowBytes / 2;
  // wgmma descriptor's layout type: 1 = 128 B swizzle, 2 = 64 B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  // fa_bwd_dkdv_sm90: keys a block (64 a warpgroup), query rows a step
  // (128 where dk and dv leave room for 128-row Sᵀ and dPᵀ: m64n128 products)
  static constexpr int kKeys = 128;
  static constexpr int kRows = HD <= 64 ? 128 : 64;
  static constexpr int kKVBytes = kKeys * HD * 2;  // the K or the V tile
  static constexpr int kQBytes = kRows * HD * 2;   // a stage's Q or dO tile
  static constexpr int kDkdvSmem =
      1024 + 2 * kKVBytes + kStages * 2 * kQBytes + kStages * 2 * kRows * 4;
  // fa_bwd_dq_sm90: query rows a block (64 a warpgroup), keys a step
  static constexpr int kQRows = 128;
  static constexpr int kKT = HD <= 64 ? 128 : 64;
  static constexpr int kQTileBytes = kQRows * HD * 2;  // Q or dO
  static constexpr int kKTBytes = kKT * HD * 2;        // a stage's K or V
  static constexpr int kDqSmem =
      1024 + 2 * kQTileBytes + kStages * 2 * kKTBytes;
};

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The descriptor of k-slice ks (16 values of hd) of a K-major tile at
// `base` whose column blocks (atoms) lie `rows` rows apart.
template <int HD>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int ks) {
  using C = Tile<HD>;
  constexpr int kRB = C::kRowBytes;
  const int atom = ks * 32 / kRB, off = ks * 32 % kRB;
  return descriptor(base + atom * rows * kRB + off, 16, 8 * kRB, C::kLayout);
}

// The descriptor of rows 16·kk .. 16·kk + 15 of the same tile read as an
// MN-major B operand (the transpose bit): K runs down the rows, N along hd.
template <int HD>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows,
                                            int kk) {
  using C = Tile<HD>;
  constexpr int kRB = C::kRowBytes;
  return descriptor(base + kk * 16 * kRB, rows * kRB, 8 * kRB, C::kLayout);
}

// c (64 x N) = A · Bᵀ over hd: A the warpgroup's 64 rows of a K-major tile
// at a (atoms a_rows apart), B the N rows of a K-major tile at b (atoms
// b_rows apart). The caller zeroes c before its `wgmma_fence` (the first
// product does not read it; the zeroes end its old values' lives).
template <int HD, int N>
__device__ __forceinline__ void gemm_nt(float (&c)[N / 2], uint32_t a,
                                        int a_rows, uint32_t b, int b_rows) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    sm90::wgmma_ss<N>(c, kmajor<HD>(a, a_rows, ks), kmajor<HD>(b, b_rows, ks),
                      ks > 0);
}

// c (64 x HD) += A · X: A (64 x K) bf16 fragments in registers, X the K
// rows of the tile at x (atoms x_rows apart), read MN-major.
template <int HD, int K>
__device__ __forceinline__ void gemm_rn(float (&c)[HD / 2],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t x, int x_rows) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    sm90::wgmma_rs<HD>(c, a[kk], mnmajor<HD>(x, x_rows, kk));
}

// D[b, h, s] = Σ_d dO[b, s, h, d] · O[b, s, h, d] in float32.
template <int HD>
__global__ void __launch_bounds__(256)
fa_bwd_pre_sm90(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ D, long long rows, int S, int H) {
  constexpr int kVec = 8, kLanes = HD / kVec;
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
    const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      sum = fmaf(__bfloat162float(de[i]), __bfloat162float(oe[i]), sum);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0 && row < rows) {
    const long long b = row / (static_cast<long long>(S) * H);
    const int s = static_cast<int>((row / H) % S);
    const int h = static_cast<int>(row % H);
    D[(b * H + h) * S + s] = sum;
  }
}

// dk, dv of 128 keys of one KV head (see the top of the file): warps 0-7
// two consumer warpgroups (64 keys each), warp 8 lane 0 the TMA loads,
// warp 9 the rows' lse and D.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int S, int Tn, int H,
                 int KV, int B, float scale, int causal) {
  using C = Tile<HD>;
  constexpr int kKeys = C::kKeys, kRows = C::kRows, kRB = C::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], kv_full;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;                        // kAtoms x (kKeys x kRB)
  uint8_t* vs = ks + C::kKVBytes;
  uint8_t* ring = vs + C::kKVBytes;          // a stage: Q tile, dO tile
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * C::kQBytes);

  // heaviest first: under `causal` the first key tiles walk most rows
  const int kt = blockIdx.x / (KV * B), rest = blockIdx.x % (KV * B);
  const int kvh = rest % KV, b = rest / KV, G = H / KV;
  const int k0 = kt * kKeys;
  const int first = causal ? k0 / kRows : 0;  // rows before k0 see no key
  const int per_head = (S + kRows - 1) / kRows - first;
  const int n_steps = per_head > 0 ? G * per_head : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);  // the TMA thread, the stats warp
      sm90::mbar_init(&empty[s], kConsumers / 32);
    }
    sm90::mbar_init(&kv_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(&kv_full, 2 * C::kKVBytes);
      for (int a = 0; a < C::kAtoms; ++a) {
        sm90::tma_load_4d(ks + a * kKeys * kRB, &k_map, &kv_full,
                          a * C::kBoxCols, kvh, k0, b);
        sm90::tma_load_4d(vs + a * kKeys * kRB, &v_map, &kv_full,
                          a * C::kBoxCols, kvh, k0, b);
      }
      for (int st = 0; st < n_steps; ++st) {
        const int s = st % kStages;
        const int h = kvh * G + st / per_head;
        const int r0 = (first + st % per_head) * kRows;
        mbar_wait(&empty[s], ((st / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kQBytes);
        uint8_t* qs = ring + s * 2 * C::kQBytes;
        for (int a = 0; a < C::kAtoms; ++a) {
          sm90::tma_load_4d(qs + a * kRows * kRB, &q_map, &full[s],
                            a * C::kBoxCols, h, r0, b);
          sm90::tma_load_4d(qs + C::kQBytes + a * kRows * kRB, &do_map,
                            &full[s], a * C::kBoxCols, h, r0, b);
        }
      }
    } else if (warp == kConsumers / 32 + 1) {
      for (int st = 0; st < n_steps; ++st) {
        const int s = st % kStages;
        const int h = kvh * G + st / per_head;
        const int r0 = (first + st % per_head) * kRows;
        const long long base = (static_cast<long long>(b) * H + h) * S;
        mbar_wait(&empty[s], ((st / kStages) & 1) ^ 1);
        float* ls = stats + s * 2 * kRows;
        for (int i = lane; i < kRows; i += 32) {
          const int row = r0 + i;
          ls[i] = row < S ? lse[base + row] * kLog2e : INFINITY;
          ls[kRows + i] = row < S ? D[base + row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int wg = warp / 4, wi = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int kw0 = k0 + wg * 64;          // this warpgroup's first key
    const int key0 = kw0 + wi * 16 + g;    // this thread's keys: key0, +8
    const uint32_t k_base = sm90::smem_addr(ks) + wg * 64 * kRB;
    const uint32_t v_base = sm90::smem_addr(vs) + wg * 64 * kRB;
    const uint32_t ring_base = sm90::smem_addr(ring);
    const float scale_log2 = scale * kLog2e;
    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float sc[kRows / 2], dp[kRows / 2];
    uint32_t pa[kRows / 16][4], da[kRows / 16][4];

    mbar_wait(&kv_full, 0);
    for (int st = 0; st < n_steps; ++st) {
      const int s = st % kStages;
      const int r0 = (first + st % per_head) * kRows;
      const uint32_t qb = ring_base + s * 2 * C::kQBytes;
      const uint32_t dob = qb + C::kQBytes;
      mbar_wait(&full[s], (st / kStages) & 1);
      zero(sc);
      zero(dp);
      wgmma_fence();
      gemm_nt<HD, kRows>(sc, k_base, kKeys, qb, kRows);
      gemm_nt<HD, kRows>(dp, v_base, kKeys, dob, kRows);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      // Pᵀ and dSᵀ: sc[4j + e] is (key key0 + 8·(e / 2), row r0 + 8j + 2t
      // + e % 2), and goes to the A fragments of k-slice j / 2 (16 rows)
      const float* ls = stats + s * 2 * kRows;
      const bool mask = causal && r0 < kw0 + 63;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
        const float2 d =
            *reinterpret_cast<const float2*>(ls + kRows + 8 * j + 2 * t);
        float p[4], x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = sm90::exp2_approx(
              fmaf(sc[4 * j + e], scale_log2, -(e & 1 ? l.y : l.x)));
          if (mask && r0 + 8 * j + 2 * t + (e & 1) < key0 + (e & 2 ? 8 : 0))
            p[e] = 0.f;
          x[e] = p[e] * (dp[4 * j + e] - (e & 1 ? d.y : d.x));
        }
        const int kk = j / 2, sl = (j % 2) * 2;
        pa[kk][sl] = pack_bf16(p[0], p[1]);
        pa[kk][sl + 1] = pack_bf16(p[2], p[3]);
        da[kk][sl] = pack_bf16(x[0], x[1]);
        da[kk][sl + 1] = pack_bf16(x[2], x[3]);
      }
      wgmma_fence();
      gemm_rn<HD, kRows>(dv_acc, pa, dob, kRows);
      gemm_rn<HD, kRows>(dk_acc, da, qb, kRows);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // dk[b, key, kvh], dv[b, key, kvh]: acc[4i + e] is (key key0 + 8·(e /
    // 2), column 8i + 2t + e % 2)
    const long long kv_row = static_cast<long long>(KV) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Tn) continue;
      const long long off = (static_cast<long long>(b) * Tn + key) * kv_row +
                            static_cast<long long>(kvh) * HD + 2 * t;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * i) =
            __floats2bfloat162_rn(dk_acc[4 * i + 2 * r] * scale,
                                  dk_acc[4 * i + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * i) =
            __floats2bfloat162_rn(dv_acc[4 * i + 2 * r],
                                  dv_acc[4 * i + 2 * r + 1]);
      }
    }
  }
}

// dq of 128 query rows of one head (see the top of the file): warps 0-7
// two consumer warpgroups (64 rows each), warp 8 lane 0 the TMA loads.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_sm90(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const float* __restrict__ lse, const float* __restrict__ D,
               __nv_bfloat16* __restrict__ dq, int S, int Tn, int H, int KV,
               int B, float scale, int causal) {
  using C = Tile<HD>;
  constexpr int kQRows = C::kQRows, kKT = C::kKT, kRB = C::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], q_full;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                        // kAtoms x (kQRows x kRB)
  uint8_t* dos = qs + C::kQTileBytes;
  uint8_t* ring = dos + C::kQTileBytes;      // a stage: K tile, V tile

  // heaviest first: under `causal` the last query tiles walk most keys
  const int n_qt = (S + kQRows - 1) / kQRows;
  const int rank = blockIdx.x / (H * B), rest = blockIdx.x % (H * B);
  const int h = rest % H, b = rest / H, kvh = h / (H / KV);
  const int q0 = (causal ? n_qt - 1 - rank : rank) * kQRows;
  const int k_end = causal ? min(Tn, q0 + kQRows) : Tn;
  const int n_tiles = (k_end + kKT - 1) / kKT;
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(&q_full, 2 * C::kQTileBytes);
      for (int a = 0; a < C::kAtoms; ++a) {
        sm90::tma_load_4d(qs + a * kQRows * kRB, &q_map, &q_full,
                          a * C::kBoxCols, h, q0, b);
        sm90::tma_load_4d(dos + a * kQRows * kRB, &do_map, &q_full,
                          a * C::kBoxCols, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKTBytes);
        uint8_t* kb = ring + s * 2 * C::kKTBytes;
        for (int a = 0; a < C::kAtoms; ++a) {
          sm90::tma_load_4d(kb + a * kKT * kRB, &k_map, &full[s],
                            a * C::kBoxCols, kvh, j * kKT, b);
          sm90::tma_load_4d(kb + C::kKTBytes + a * kKT * kRB, &v_map,
                            &full[s], a * C::kBoxCols, kvh, j * kKT, b);
        }
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int wg = warp / 4, wi = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int warp_row = q0 + wg * 64 + wi * 16;  // first row of this warp
    const int r0 = warp_row + g, r1 = r0 + 8;     // this thread's two rows
    const long long base = (static_cast<long long>(b) * H + h) * S;
    const float l0 = r0 < S ? lse[base + r0] * kLog2e : INFINITY;
    const float l1 = r1 < S ? lse[base + r1] * kLog2e : INFINITY;
    const float d0 = r0 < S ? D[base + r0] : 0.f;
    const float d1 = r1 < S ? D[base + r1] : 0.f;
    const uint32_t q_base = sm90::smem_addr(qs) + wg * 64 * kRB;
    const uint32_t do_base = sm90::smem_addr(dos) + wg * 64 * kRB;
    const uint32_t ring_base = sm90::smem_addr(ring);
    const float scale_log2 = scale * kLog2e;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float sc[kKT / 2], dp[kKT / 2];
    uint32_t dsa[kKT / 16][4];

    auto tile = [&](int j) {
      return ring_base + (j % kStages) * 2 * C::kKTBytes;
    };
    // S = Q·Kᵀ and dP = dO·Vᵀ of the stage at kb (V after K) into sc, dp
    auto issue_sdp = [&](uint32_t kb) {
      gemm_nt<HD, kKT>(sc, q_base, kQRows, kb, kKT);
      gemm_nt<HD, kKT>(dp, do_base, kQRows, kb + C::kKTBytes, kKT);
    };
    // dS of tile j into the A fragments dsa: sc[4n + e] is (row e < 2 ? r0
    // : r1, key kt0 + 8n + 2t + e % 2), and goes to k-slice n / 2
    auto probs = [&](int j) {
      const int kt0 = j * kKT;
      const bool mask =
          (causal && kt0 + kKT - 1 > warp_row) || kt0 + kKT > Tn;
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e & 2;
          float p = sm90::exp2_approx(
              fmaf(sc[4 * n + e], scale_log2, -(hi ? l1 : l0)));
          const int key = kt0 + 8 * n + 2 * t + (e & 1);
          if (mask && ((causal && key > (hi ? r1 : r0)) || key >= Tn))
            p = 0.f;
          x[e] = p * (dp[4 * n + e] - (hi ? d1 : d0));
        }
        dsa[n / 2][(n % 2) * 2] = pack_bf16(x[0], x[1]);
        dsa[n / 2][(n % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
      }
    };

    mbar_wait(&q_full, 0);
    mbar_wait(&full[0], 0);
    zero(sc);
    zero(dp);
    wgmma_fence();
    issue_sdp(tile(0));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    probs(0);
    // A step issues dq += dS·K of tile j and the next tile's S and dP in
    // one group. The last step has no next tile: it issues S and dP of its
    // own tile again and drops them. One path for every step is faster than
    // a branch or a last step apart (flash_bwd_variants.py: dq_branch,
    // dq_peeled).
    for (int j = 0; j < n_tiles; ++j) {
      const int jn = j + 1 < n_tiles ? j + 1 : j;
      if (jn > j) mbar_wait(&full[jn % kStages], (jn / kStages) & 1);
      zero(sc);
      zero(dp);
      wgmma_fence();
      gemm_rn<HD, kKT>(acc, dsa, tile(j), kKT);
      issue_sdp(tile(jn));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(dsa);
      fence_regs(sc);
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
      probs(jn);  // the last step's: dropped
    }

    const long long q_row = static_cast<long long>(H) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? r0 : r1;
      if (row >= S) continue;
      __nv_bfloat16* out = dq + (static_cast<long long>(b) * S + row) * q_row +
                           static_cast<long long>(h) * HD + 2 * t;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale,
                                  acc[4 * i + 2 * r + 1] * scale);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse, int B,
                   int S, int Tn, int H, int KV, float scale, int causal,
                   float* D, void* dq, void* dk, void* dv,
                   cudaStream_t stream) {
  using C = Tile<HD>;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long pre_blocks = (rows * (HD / 8) + 255) / 256;
  fa_bwd_pre_sm90<HD><<<static_cast<unsigned>(pre_blocks), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), D, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the (B, S, H, hd) and (B, T, KV, hd) tensors as 4-D maps (hd, heads,
  // rows, B), in boxes of each kernel's tile rows
  CUtensorMap q_kv, do_kv, k_kv, v_kv, q_q, do_q, k_q, v_q;
  const void* qs[4] = {q, dout, k, v};
  CUtensorMap* kv_maps[4] = {&q_kv, &do_kv, &k_kv, &v_kv};
  CUtensorMap* q_maps[4] = {&q_q, &do_q, &k_q, &v_q};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const bool query = i < 2;
    const uint64_t heads = query ? H : KV, len = query ? S : Tn;
    err = sm90::make_map(kv_maps[i], qs[i], HD, heads, len, B, C::kBoxCols,
                         1, query ? C::kRows : C::kKeys);
    if (err == cudaSuccess)
      err = sm90::make_map(q_maps[i], qs[i], HD, heads, len, B, C::kBoxCols,
                           1, query ? C::kQRows : C::kKT);
  }
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(fa_bwd_dkdv_sm90<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkdvSmem);
  if (err != cudaSuccess) return err;
  const long long kv_blocks =
      static_cast<long long>((Tn + C::kKeys - 1) / C::kKeys) * KV * B;
  fa_bwd_dkdv_sm90<HD>
      <<<static_cast<unsigned>(kv_blocks), kThreads, C::kDkdvSmem, stream>>>(
          q_kv, do_kv, k_kv, v_kv, lse, D, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), S, Tn, H, KV, B, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(fa_bwd_dq_sm90<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDqSmem);
  if (err != cudaSuccess) return err;
  const long long q_blocks =
      static_cast<long long>((S + C::kQRows - 1) / C::kQRows) * H * B;
  fa_bwd_dq_sm90<HD>
      <<<static_cast<unsigned>(q_blocks), kThreads, C::kDqSmem, stream>>>(
          q_q, do_q, k_q, v_q, lse, D, static_cast<__nv_bfloat16*>(dq), S,
          Tn, H, KV, B, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout: (B, S, H, HD); k, v: (B, T, KV, HD) with H = KV * G; all
// bfloat16. lse (B, H, S) float32, the forward's row log-sum-exp; all
// contiguous and 16-byte aligned, HD 32, 64 or 128; causal needs S == T
// (the wrapper checks). D: (B, H, S) float32 scratch. dq (B, S, H, HD), dk
// and dv (B, T, KV, HD), bfloat16, each fully written.
extern "C" int tdorch_flash_attention_bwd_bf16(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, int B, int S, int Tn, int H, int KV,
    int HD, float scale, int causal, float* D, void* dq, void* dk, void* dv,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  switch (HD) {
    case 32:
      err = launch<32>(q, k, v, o, dout, lse, B, S, Tn, H, KV, scale,
                       causal, D, dq, dk, dv, stream);
      break;
    case 64:
      err = launch<64>(q, k, v, o, dout, lse, B, S, Tn, H, KV, scale,
                       causal, D, dq, dk, dv, stream);
      break;
    case 128:
      err = launch<128>(q, k, v, o, dout, lse, B, S, Tn, H, KV, scale,
                        causal, D, dq, dk, dv, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
