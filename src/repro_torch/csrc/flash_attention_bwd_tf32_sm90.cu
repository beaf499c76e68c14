// GQA flash attention, backward, in float32 for Hopper (sm_90a): dq, dk and
// dv of o = softmax(q · kᵀ · hd^-0.5) · v from the forward's o and its row
// log-sum-exp, in 3xTF32 on the tensor cores through `wgmma`, tiles
// through TMA. bf16 inputs take flash_attention_bwd_sm90.cu.
//
// Replaces, for float32 inputs, the backward rule of the JAX package's
// flash attention, its custom VJP `_flash_bwd_rule` (src/repro/models/
// attention.py:137), which XLA runs as a scan over key chunks (not a Pallas
// kernel; the forward it differentiates is `flash_attention`'s, the TPU
// kernel src/repro/kernels/flash_attention/kernel.py:75 that
// flash_attention_tf32.cu ports). The arithmetic is that rule's:
//   P   = exp(s − lse),  s = q · k · hd^-0.5 (−2e38 above the diagonal
//         under `causal`), lse the forward's row log-sum-exp;
//   D   = rowsum(dO ⊙ O);
//   dS  = P ⊙ (dO · vᵀ − D);
//   dq  = dS · k · hd^-0.5,  dk = dSᵀ · q · hd^-0.5,  dv = Pᵀ · dO,
// dk and dv summed over the G query heads of their KV head. Every product
// in 3xTF32: each float32 operand x is read as hi = x truncated to TF32 (the
// tensor core truncates what it reads, so x itself serves) and lo = x − hi,
// and a product is lo·hi + hi·lo + hi·hi, three `wgmma`s into the same
// float32 sums, so float32 accuracy does not depend on `allow_tf32`.
// hd 32, 64 or 128.
//
// What bounds it on this card: operations. 5 · 2·B·H·S²·hd/2 FLOP over the
// causal half, three TF32 products each: 4.17 ms at 495/3 TFLOP/s for
// tinyllama's training shape (4, 4096, 32 heads, 4 KV heads, 64). S and dP
// are computed in both main kernels (7 products) so that no sum needs
// atomics: two calls on the same inputs give the same bits.
//
// Operand layout. TF32 `wgmma` reads a shared-memory operand K-major only
// (the transpose bit is for 16-bit types), and every shared-memory operand
// needs its lo half beside it. The products are arranged so that the only
// operands read by descriptor are K and V tiles as they lie (their lo
// halves from fa_bwd_pre_tf32's scratch, by TMA beside them) and P / dS
// tiles the consumers write themselves; Q and dO, and K where a product
// needs it transposed, are A operands, loaded from their natural TMA tiles
// into registers and split there:
//   S  = Q · Kᵀ,  dP = dO · Vᵀ   A = Q or dO rows (registers), B = K or V
//                                (K-major as they lie, lo halves beside);
//   dvᵀ += dOᵀ · P,  dkᵀ += Qᵀ · dS   (fa_bwd_dkdv_tf32): A = the Q or dO
//                                tile read down its columns, B = P or dS,
//                                which the consumer writes K-major over the
//                                rows with its lo half;
//   dqᵀ += Kᵀ · dSᵀ              (fa_bwd_dq_tf32): A = the K tile read down
//                                its columns, B = dS K-major over the keys.
// The transposed products put hd in `wgmma`'s m64: one m64 at hd 64, two
// at hd 128, and at hd 32 half of one (its upper 32 rows are zeros).
//
// Three kernels, no atomics:
// - fa_bwd_pre_tf32: D, one 16-byte vector a thread, a row's vectors summed
//   across its lanes; and k_lo, v_lo (k − its TF32 truncation) into the
//   wrapper's scratch, which TMA then reads beside k and v.
// - fa_bwd_dkdv_tf32: one block per (kKeys keys, KV head, batch row): a
//   producer warpgroup (`setmaxnreg` 24: lane 0 of warp 8 the TMA loads,
//   warp 9 the rows' lse·log2 e and D) and two consumer warpgroups (240
//   registers a thread). K, K_lo, V, V_lo arrive once and stay; Q and dO
//   tiles of kRows = 64 rows of the G query heads, the query tiles at or
//   after the block's first key (all without `causal`), stream through a
//   ring of kStages stages. A step: warpgroup 0 computes S and P, writes
//   P and P_lo, then dvᵀ += dOᵀ·P; warpgroup 1 computes dP at the same
//   time, reads P, writes dS and dS_lo, then dkᵀ += Qᵀ·dS. Named barriers
//   hand P over and back (kPReady, kPFree).
// - fa_bwd_dq_tf32: one block per (64 query rows, head, batch row): Q and
//   dO once, K, K_lo, V, V_lo tiles of kKT keys streamed up to the
//   diagonal (all without `causal`). The two consumer warpgroups take the
//   tiles in turns (warpgroup j % 2 tile j), each for all 64 rows: S, dP,
//   dS into its own dS and dS_lo tiles (after a barrier of the warpgroup:
//   each warp's dqᵀ product of its last tile reads all of them), then
//   dqᵀ += Kᵀ·dSᵀ; one's exponentials and dS run while the other's
//   products hold the tensor core. dq is warpgroup 0's sums plus warpgroup
//   1's, in that order.
// - The float32 folds. The tensor core truncates the sums it carries (each
//   `wgmma`'s products added and cut toward zero). A dk or dv sum carried
//   on it over a whole walk of G·S rows loses up to an ulp of itself a
//   product, which lands past the float32 gate; so each step's dkᵀ / dvᵀ
//   products (kRows rows, 24 `wgmma`s) go into sums of their own, added in
//   float32 to running sums in registers, and dq adds each key tile's sums
//   (kKT keys) the same way, a sum for each warpgroup's tiles. S and dP are
//   carried over hd (3·hd/8 `wgmma`s).
//   tests/test_torch_flash_bwd.py emulates these sums step for step against
//   the JAX rule, with the tile sizes read from this file.
// - Under `causal` only tiles that cross the diagonal are masked, and the
//   blocks with most work go first (the first key tiles for dk / dv, the
//   last query tiles for dq). Rows past S read lse = +inf (P = 0) and D =
//   0 and TMA reads them as zero rows; keys past T read as zero rows, are
//   masked out of dq and their own dk, dv are not stored.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_wait;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait_all;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// registers a thread after `setmaxnreg`: 256 x 240 + 128 x 24 of the SM's
// 65,536 (232 and 40 spilled more in fa_bwd_dq_tf32 and read 1-3% slower
// at two of row 5c's shapes: flash_bwd_variants.py, regs_232)
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
// named barriers (0 is __syncthreads)
constexpr int kPReady = 1;  // fa_bwd_dkdv_tf32: P written (warpgroup 0 -> 1)
constexpr int kPFree = 2;   // P read (warpgroup 1 -> 0)
constexpr int kOwn = 3;     // 3 + w: warpgroup w alone (its P / dS
                            // tiles written, or free to write)
constexpr int kSums = 5;    // fa_bwd_dq_tf32: the walks, then the sums, done
// k8 slices a group of `wgmma`s issues before it waits: 32 registers of A
// fragments (hi and lo) a thread
constexpr int kChunk = 4;

template <int HD>
struct Tile {
  static constexpr int kAtoms = HD / 32;  // 128-byte column blocks of hd
  static constexpr int kMT = HD == 128 ? 2 : 1;  // m64 tiles of hd (dkᵀ ...)
  // ring depth: even, because fa_bwd_dq_tf32's warpgroups take the tiles
  // in turns, so that each stage has one warpgroup, which waits on its
  // phases in order (with an odd depth a warpgroup could wait on a phase
  // parity that the stage's previous phase, another warpgroup's, matches)
  static constexpr int kStages = HD == 32 ? 4 : 2;
  static_assert(kStages % 2 == 0, "each ring stage has one dq warpgroup");
  // fa_bwd_dkdv_tf32: query rows a step (S's m64), keys a block
  static constexpr int kRows = 64;
  static constexpr int kKeys = HD <= 64 ? 64 : 32;
  static constexpr int kKVBytes = kKeys * HD * 4;  // K, K_lo, V or V_lo
  static constexpr int kQBytes = kRows * HD * 4;   // a stage's Q or dO
  static constexpr int kXBytes = kKeys * kRows * 4;  // P, P_lo, dS or dS_lo
  static constexpr int kDkdvSmem = 1024 + 4 * kKVBytes +
                                   kStages * 2 * kQBytes + 4 * kXBytes +
                                   kStages * 2 * kRows * 4;
  // fa_bwd_dq_tf32: query rows a block, keys a step
  static constexpr int kQRows = 64;
  static constexpr int kKT = HD <= 64 ? 64 : 32;
  static constexpr int kQTileBytes = kQRows * HD * 4;  // Q or dO
  static constexpr int kKTBytes = kKT * HD * 4;  // a stage's K, K_lo, V, V_lo
  static constexpr int kDqXBytes = kQRows * kKT * 4;  // dS or dS_lo
  static constexpr int kDqSmem =
      1024 + 2 * kQTileBytes + kStages * 4 * kKTBytes + 4 * kDqXBytes;
  // the two warpgroups' dq sums meet in the first stage
  static_assert(4 * kKTBytes >= kMT * kQRows * 64 * 4, "dq sums");
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "shared memory");
};

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) zero(r[i]);
}

// The dynamic shared memory from its first 1,024-byte boundary (the
// 128-byte swizzle's atom). Derived from `smem_raw` by an offset, not through
// an integer, so that the compiler knows every pointer into it is shared:
// the tiles' loads and stores compile to LDS / STS on 32-bit addresses, not
// to generic LD / ST on 64-bit ones (two registers an address).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* smem_raw) {
  return smem_raw + ((1024u - (sm90::smem_addr(smem_raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// The byte offset of float (r, c) in a tile of 128-byte rows (32 floats)
// swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes them, whose 32-column
// blocks (atoms) lie `rows` rows apart; c >= 0. The 16-byte chunk is
// (c & 31) >> 2, not (c % 32) / 4: nvcc 12.9 at -O3 folded the latter, for
// an odd c < 32, to c itself (its PTX for fa_bwd_dq_tf32<128> with one
// store a key put the odd keys' dS c chunks along, past the end of shared
// memory from the tile's last rows); nor (c >> 2) & 7, which compiled to
// slower tile loads (flash_bwd_variants.py: at_divide, at_shift).
__device__ __forceinline__ uint32_t at(int rows, int r, int c) {
  return (c / 32) * rows * 128 + sm90::swizzled<128>(r, (c & 31) >> 2) +
         (c & 3) * 4;
}

__device__ __forceinline__ float load(const uint8_t* tile, uint32_t off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// The descriptor of k8 slice ks (8 values of K, 32 bytes) of a K-major
// operand at `base` (a tile as `at` lays it out, K along its columns).
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int rows, int ks) {
  return sm90::descriptor(base + (ks / 4) * rows * 128 + (ks % 4) * 32, 16,
                          1024, 1);
}

// One k8 slice of c += A · B in 3xTF32: lo·hi, hi·lo, then hi·hi.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N / 2],
                                     const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint64_t b,
                                     uint64_t b_lo) {
  sm90::wgmma_rs_tf32<N>(c, lo, b);
  sm90::wgmma_rs_tf32<N>(c, hi, b_lo);
  sm90::wgmma_rs_tf32<N>(c, hi, b);
}

// A fragments of one k8 slice, split hi / lo: A(m, k) = tile(m, k), or
// tile(k, m) with kTrans, for m = m0 + g (+8), k = k0 + t (+4); rows m at
// or past m_end read as zero.
template <bool kTrans>
__device__ __forceinline__ void frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                     const uint8_t* tile, int rows, int m0,
                                     int k0, int m_end, int g, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + g + 8 * (i & 1), k = k0 + t + 4 * (i >> 1);
    const float x = m < m_end
                        ? load(tile, kTrans ? at(rows, k, m) : at(rows, m, k))
                        : 0.f;
    sm90::split_tf32(x, hi[i], lo[i]);
  }
}

// c (64 x N) = A · Bᵀ over hd: A this warpgroup's 64 rows of the tile at
// a (atoms a_rows apart; warp wi's 16 from row 16·wi), B the N rows of the
// K-major tile at b and its lo half at b_lo (atoms N rows apart).
template <int HD, int N>
__device__ __forceinline__ void gemm_rows(float (&c)[N / 2],
                                          const uint8_t* a, int a_rows,
                                          uint32_t b, uint32_t b_lo, int wi,
                                          int g, int t) {
  constexpr int kSlices = HD / 8;
  constexpr int kGroup = kSlices < kChunk ? kSlices : kChunk;
  zero(c);
#pragma unroll
  for (int c0 = 0; c0 < kSlices; c0 += kGroup) {
    uint32_t hi[kGroup][4], lo[kGroup][4];
#pragma unroll
    for (int s = 0; s < kGroup; ++s)
      frag<false>(hi[s], lo[s], a, a_rows, 16 * wi, 8 * (c0 + s), 1 << 30,
                  g, t);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kGroup; ++s)
      mma3<N>(c, hi[s], lo[s], kdesc(b, N, c0 + s), kdesc(b_lo, N, c0 + s));
    wgmma_commit();
    wgmma_wait_all();
    sm90::fence_regs(c);
    sm90::fence_regs(hi);
    sm90::fence_regs(lo);
  }
}

// c (64 x N) += A · B over K, for hd's m64 tile mt: A(m, k) = element (row
// k, column 64·mt + m) of the tile at a (atoms a_rows apart; columns past
// HD read as zero), B the K-major tile at b (N rows of K, atoms b_rows
// apart) and its lo half at b_lo.
template <int HD, int N, int K>
__device__ __forceinline__ void gemm_cols(float (&c)[N / 2], int mt,
                                          const uint8_t* a, int a_rows,
                                          uint32_t b, uint32_t b_lo,
                                          int b_rows, int wi, int g, int t) {
  constexpr int kSlices = K / 8;
  constexpr int kGroup = kSlices < kChunk ? kSlices : kChunk;
#pragma unroll
  for (int c0 = 0; c0 < kSlices; c0 += kGroup) {
    uint32_t hi[kGroup][4], lo[kGroup][4];
#pragma unroll
    for (int s = 0; s < kGroup; ++s)
      frag<true>(hi[s], lo[s], a, a_rows, 64 * mt + 16 * wi, 8 * (c0 + s),
                 HD, g, t);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kGroup; ++s)
      mma3<N>(c, hi[s], lo[s], kdesc(b, b_rows, c0 + s),
              kdesc(b_lo, b_rows, c0 + s));
    wgmma_commit();
    wgmma_wait_all();
    sm90::fence_regs(c);
    sm90::fence_regs(hi);
    sm90::fence_regs(lo);
  }
}

// D[b, h, s] = Σ_d dO[b, s, h, d] · O[b, s, h, d] in float32 (the first
// d_threads threads, a whole number of blocks), then k_lo and v_lo, one
// 16-byte vector a thread.
template <int HD>
__global__ void __launch_bounds__(256)
fa_bwd_pre_tf32(const float* __restrict__ o, const float* __restrict__ dout,
                const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ D, float* __restrict__ k_lo,
                float* __restrict__ v_lo, long long rows,
                long long d_threads, long long kv_vecs, int S, int H) {
  constexpr int kVec = 4, kLanes = HD / kVec;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= d_threads) {
    const long long j = idx - d_threads;
    if (j < kv_vecs) {
      const float4 a = reinterpret_cast<const float4*>(k)[j];
      const float4 c = reinterpret_cast<const float4*>(v)[j];
      reinterpret_cast<float4*>(k_lo)[j] = make_float4(
          tf32_lo(a.x), tf32_lo(a.y), tf32_lo(a.z), tf32_lo(a.w));
      reinterpret_cast<float4*>(v_lo)[j] = make_float4(
          tf32_lo(c.x), tf32_lo(c.y), tf32_lo(c.z), tf32_lo(c.w));
    }
    return;
  }
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
    const int s = static_cast<int>((row / H) % S);
    const int h = static_cast<int>(row % H);
    D[(b * H + h) * S + s] = sum;
  }
}

// dk, dv of kKeys keys of one KV head (see the top of the file): warps 0-7
// two consumer warpgroups, warp 8 lane 0 the TMA loads, warp 9 the rows'
// lse and D.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_tf32(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap klo_map,
                 const __grid_constant__ CUtensorMap vlo_map,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 float* __restrict__ dk, float* __restrict__ dv, int S,
                 int Tn, int H, int KV, int B, float scale, int causal) {
  using C = Tile<HD>;
  constexpr int kKeys = C::kKeys, kRows = C::kRows, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], kv_full;
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* ks = smem;  // K, K_lo, V, V_lo: kAtoms x (kKeys x 128 B) each
  uint8_t* klos = ks + C::kKVBytes;
  uint8_t* vs = klos + C::kKVBytes;
  uint8_t* vlos = vs + C::kKVBytes;
  uint8_t* ring = vlos + C::kKVBytes;  // a stage: Q tile, dO tile
  // P, P_lo, dS, dS_lo: keys x rows, K-major over the rows (kRows / 32
  // atoms of kKeys x 128 B)
  uint8_t* xp = ring + kStages * 2 * C::kQBytes;
  uint8_t* xplo = xp + C::kXBytes;
  uint8_t* xds = xplo + C::kXBytes;
  uint8_t* xdslo = xds + C::kXBytes;
  float* stats = reinterpret_cast<float*>(xdslo + C::kXBytes);

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
      mbar_expect_tx(&kv_full, 4 * C::kKVBytes);
      for (int a = 0; a < C::kAtoms; ++a) {
        const int off = a * kKeys * 128;
        sm90::tma_load_4d(ks + off, &k_map, &kv_full, a * 32, kvh, k0, b);
        sm90::tma_load_4d(klos + off, &klo_map, &kv_full, a * 32, kvh, k0, b);
        sm90::tma_load_4d(vs + off, &v_map, &kv_full, a * 32, kvh, k0, b);
        sm90::tma_load_4d(vlos + off, &vlo_map, &kv_full, a * 32, kvh, k0, b);
      }
      for (int st = 0; st < n_steps; ++st) {
        const int s = st % kStages;
        const int h = kvh * G + st / per_head;
        const int r0 = (first + st % per_head) * kRows;
        mbar_wait(&empty[s], ((st / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kQBytes);
        uint8_t* qs = ring + s * 2 * C::kQBytes;
        for (int a = 0; a < C::kAtoms; ++a) {
          sm90::tma_load_4d(qs + a * kRows * 128, &q_map, &full[s], a * 32, h,
                            r0, b);
          sm90::tma_load_4d(qs + C::kQBytes + a * kRows * 128, &do_map,
                            &full[s], a * 32, h, r0, b);
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
    const int rl = 16 * wi + g;  // this thread's rows of a step: rl, rl + 8
    const float scale_log2 = scale * kLog2e;
    // warpgroup 0: dvᵀ, warpgroup 1: dkᵀ (hd x keys), float32 sums
    float run[C::kMT][kKeys / 2], part[C::kMT][kKeys / 2];
    zero(run);
    float sc[kKeys / 2];  // S (warpgroup 0) or dP (1): rows x keys
    // sc[4j + e] is (row rl + 8·(e / 2), key 8j + 2t + e % 2); its offset
    // in the P / dS tiles (keys x rows)
    auto x_at = [&](int j, int e) {
      return at(kKeys, 8 * j + 2 * t + (e & 1), rl + 8 * (e >> 1));
    };

    mbar_wait(&kv_full, 0);
    for (int st = 0; st < n_steps; ++st) {
      const int s = st % kStages;
      const int r0 = (first + st % per_head) * kRows;
      const uint8_t* qt = ring + s * 2 * C::kQBytes;
      const uint8_t* dot = qt + C::kQBytes;
      const float* ls = stats + s * 2 * kRows;
      mbar_wait(&full[s], (st / kStages) & 1);
      // S = Q·Kᵀ (warpgroup 0) or dP = dO·Vᵀ (warpgroup 1)
      gemm_rows<HD, kKeys>(sc, wg == 0 ? qt : dot, kRows,
                           sm90::smem_addr(wg == 0 ? ks : vs),
                           sm90::smem_addr(wg == 0 ? klos : vlos), wi, g, t);
      zero(part);
      if (wg == 0) {
        const float l0 = ls[rl], l1 = ls[rl + 8];
        const bool mask = causal && k0 + kKeys - 1 > r0;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = sm90::exp2_approx(
                fmaf(sc[4 * j + e], scale_log2, -(e & 2 ? l1 : l0)));
            if (mask && k0 + 8 * j + 2 * t + (e & 1) > r0 + rl + 8 * (e >> 1))
              p = 0.f;
            sc[4 * j + e] = p;
          }
        if (st > 0) sm90::bar_sync(kPFree, kConsumers);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t off = x_at(j, e);
            *reinterpret_cast<float*>(xp + off) = sc[4 * j + e];
            *reinterpret_cast<float*>(xplo + off) = tf32_lo(sc[4 * j + e]);
          }
        sm90::fence_proxy_async();
        sm90::bar_arrive(kPReady, kConsumers);
        sm90::bar_sync(kOwn + wg, 128);
        // dvᵀ += dOᵀ · P over this step's rows
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt)
          gemm_cols<HD, kKeys, kRows>(part[mt], mt, dot, kRows,
                                      sm90::smem_addr(xp),
                                      sm90::smem_addr(xplo), kKeys, wi, g,
                                      t);
      } else {
        const float d0 = ls[kRows + rl], d1 = ls[kRows + rl + 8];
        sm90::bar_sync(kPReady, kConsumers);
        float p[kKeys / 2];
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[4 * j + e] = load(xp, x_at(j, e));
        if (st + 1 < n_steps) sm90::bar_arrive(kPFree, kConsumers);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = p[4 * j + e] * (sc[4 * j + e] - (e & 2 ? d1 : d0));
            const uint32_t off = x_at(j, e);
            *reinterpret_cast<float*>(xds + off) = x;
            *reinterpret_cast<float*>(xdslo + off) = tf32_lo(x);
          }
        sm90::fence_proxy_async();
        sm90::bar_sync(kOwn + wg, 128);
        // dkᵀ += Qᵀ · dS over this step's rows
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt)
          gemm_cols<HD, kKeys, kRows>(part[mt], mt, qt, kRows,
                                      sm90::smem_addr(xds),
                                      sm90::smem_addr(xdslo), kKeys, wi, g,
                                      t);
      }
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) run[mt][i] += part[mt][i];
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // run[mt][4j + e] is (column 64·mt + rl + 8·(e / 2), key k0 + 8j + 2t +
    // e % 2): dv[b, key, kvh, column] (warpgroup 0), dk (1, scaled)
    float* out = wg == 0 ? dv : dk;
    const float f = wg == 0 ? 1.f : scale;
    const long long kv_row = static_cast<long long>(KV) * HD;
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 64 * mt + rl + 8 * (e >> 1);
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (col < HD && key < Tn)
            out[(static_cast<long long>(b) * Tn + key) * kv_row +
                static_cast<long long>(kvh) * HD + col] =
                run[mt][4 * j + e] * f;
        }
  }
}

// dq of 64 query rows of one head (see the top of the file): warps 0-7 two
// consumer warpgroups that take the key tiles in turns, warp 8 lane 0 the
// TMA loads.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_tf32(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap klo_map,
               const __grid_constant__ CUtensorMap vlo_map,
               const float* __restrict__ lse, const float* __restrict__ D,
               float* __restrict__ dq, int S, int Tn, int H, int KV, int B,
               float scale, int causal) {
  using C = Tile<HD>;
  constexpr int kQRows = C::kQRows, kKT = C::kKT, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], q_full;
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* qs = smem;  // kAtoms x (kQRows x 128 B)
  uint8_t* dos = qs + C::kQTileBytes;
  uint8_t* ring = dos + C::kQTileBytes;  // a stage: K, K_lo, V, V_lo
  // each warpgroup's dS and dS_lo: rows x keys, K-major over the keys
  // (kKT / 32 atoms of kQRows x 128 B)
  uint8_t* xds = ring + kStages * 4 * C::kKTBytes;

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
      sm90::mbar_init(&empty[s], 4);  // the warps of the tile's warpgroup
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
        sm90::tma_load_4d(qs + a * kQRows * 128, &q_map, &q_full, a * 32, h,
                          q0, b);
        sm90::tma_load_4d(dos + a * kQRows * 128, &do_map, &q_full, a * 32,
                          h, q0, b);
      }
      const CUtensorMap* maps[4] = {&k_map, &klo_map, &v_map, &vlo_map};
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 4 * C::kKTBytes);
        uint8_t* kb = ring + s * 4 * C::kKTBytes;
        for (int m = 0; m < 4; ++m)
          for (int a = 0; a < C::kAtoms; ++a)
            sm90::tma_load_4d(kb + m * C::kKTBytes + a * kKT * 128, maps[m],
                              &full[s], a * 32, kvh, j * kKT, b);
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int wg = warp / 4, wi = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int tid = threadIdx.x % 128;
    const int rl = 16 * wi + g;  // this thread's rows: q0 + rl, + 8
    const int warp_row = q0 + 16 * wi;
    const long long base = (static_cast<long long>(b) * H + h) * S;
    const int r0 = q0 + rl, r1 = r0 + 8;
    const float scale_log2 = scale * kLog2e;
    const float l0 = r0 < S ? lse[base + r0] * kLog2e : INFINITY;
    const float l1 = r1 < S ? lse[base + r1] * kLog2e : INFINITY;
    const float d0 = r0 < S ? D[base + r0] : 0.f;
    const float d1 = r1 < S ? D[base + r1] : 0.f;
    uint8_t* xs = xds + wg * 2 * C::kDqXBytes;  // this warpgroup's dS
    uint8_t* xslo = xs + C::kDqXBytes;
    // dqᵀ (hd x the 64 rows) of this warpgroup's tiles, float32 sums
    float run[C::kMT][kQRows / 2], part[kQRows / 2];
    zero(run);
    float sc[kKT / 2], dp[kKT / 2];  // S and dP: rows x keys

    mbar_wait(&q_full, 0);
    for (int j = wg; j < n_tiles; j += 2) {
      const int s = j % kStages;
      const uint8_t* kb = ring + s * 4 * C::kKTBytes;
      const uint8_t* vb = kb + 2 * C::kKTBytes;
      const int kt0 = j * kKT;
      mbar_wait(&full[s], (j / kStages) & 1);
      gemm_rows<HD, kKT>(sc, qs, kQRows, sm90::smem_addr(kb),
                         sm90::smem_addr(kb + C::kKTBytes), wi, g, t);
      gemm_rows<HD, kKT>(dp, dos, kQRows, sm90::smem_addr(vb),
                         sm90::smem_addr(vb + C::kKTBytes), wi, g, t);
      // every warp of this warpgroup is past its previous tile's dqᵀ
      // product, whose B operand (all 64 rows of dS) each warp reads for its
      // own rows of hd: only then is dS written again (the ring orders this
      // at a depth of 2, where the previous tile's stage is this one's, but
      // not at 4)
      sm90::bar_sync(kOwn + wg, 128);
      // sc[4n + e] is (row e < 2 ? r0 : r1, key kt0 + 8n + 2t + e % 2):
      // dS of keys 8n + 2t and 8n + 2t + 1 of a row, side by side
      const bool mask =
          (causal && kt0 + kKT - 1 > warp_row) || kt0 + kKT > Tn;
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 4 * n + 2 * r + c;
            float p = sm90::exp2_approx(
                fmaf(sc[i], scale_log2, -(r ? l1 : l0)));
            const int key = kt0 + 8 * n + 2 * t + c;
            if (mask && ((causal && key > (r ? r1 : r0)) || key >= Tn))
              p = 0.f;
            x[c] = p * (dp[i] - (r ? d1 : d0));
          }
          const uint32_t off = at(kQRows, rl + 8 * r, 8 * n + 2 * t);
          *reinterpret_cast<float2*>(xs + off) = make_float2(x[0], x[1]);
          *reinterpret_cast<float2*>(xslo + off) =
              make_float2(tf32_lo(x[0]), tf32_lo(x[1]));
        }
      sm90::fence_proxy_async();
      sm90::bar_sync(kOwn + wg, 128);
      // dqᵀ += Kᵀ · dSᵀ over this tile's keys, an m64 tile of hd at a time
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt) {
        zero(part);
        gemm_cols<HD, kQRows, kKT>(part, mt, kb, kKT, sm90::smem_addr(xs),
                                   sm90::smem_addr(xslo), kQRows, wi, g, t);
#pragma unroll
        for (int i = 0; i < kQRows / 2; ++i) run[mt][i] += part[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // dq = warpgroup 0's sums + warpgroup 1's, through the ring (every tile
    // consumed): run[mt][4i + e] is (column 64·mt + rl + 8·(e / 2), row q0
    // + 8i + 2t + e % 2)
    float* xr = reinterpret_cast<float*>(ring);
    sm90::bar_sync(kSums, kConsumers);
    if (wg == 1) {
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
        for (int i = 0; i < kQRows / 2; ++i)
          xr[(mt * kQRows / 2 + i) * 128 + tid] = run[mt][i];
    }
    sm90::bar_sync(kSums, kConsumers);
    if (wg == 0) {
      const long long q_row = static_cast<long long>(H) * HD;
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
        for (int i = 0; i < kQRows / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 64 * mt + rl + 8 * (e >> 1);
            const int row = q0 + 8 * i + 2 * t + (e & 1);
            const int k = 4 * i + e;
            if (col < HD && row < S)
              dq[(static_cast<long long>(b) * S + row) * q_row +
                 static_cast<long long>(h) * HD + col] =
                  (run[mt][k] + xr[(mt * kQRows / 2 + k) * 128 + tid]) *
                  scale;
          }
    }
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse, int B,
                   int S, int Tn, int H, int KV, float scale, int causal,
                   float* D, float* k_lo, float* v_lo, float* dq, float* dk,
                   float* dv, cudaStream_t stream) {
  using C = Tile<HD>;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long d_threads = (rows * (HD / 4) + 255) / 256 * 256;
  const long long kv_vecs = static_cast<long long>(B) * Tn * KV * (HD / 4);
  const long long pre_blocks = (d_threads + kv_vecs + 255) / 256;
  fa_bwd_pre_tf32<HD><<<static_cast<unsigned>(pre_blocks), 256, 0, stream>>>(
      o, dout, k, v, D, k_lo, v_lo, rows, d_threads, kv_vecs, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the (B, S, H, hd) and (B, T, KV, hd) tensors as 4-D float32 maps (hd,
  // heads, rows, B) in boxes of 32 columns: 64 query rows (both kernels'
  // Q and dO tiles), kKeys = kKT keys (K, K_lo, V, V_lo)
  static_assert(C::kKeys == C::kKT && C::kRows == C::kQRows, "one box");
  CUtensorMap maps[6];
  const void* bases[6] = {q, dout, k, v, k_lo, v_lo};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i) {
    const bool query = i < 2;
    err = sm90::make_map(&maps[i], bases[i], HD, query ? H : KV,
                         query ? S : Tn, B, 32, 1,
                         query ? C::kRows : C::kKeys, true);
  }
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(fa_bwd_dkdv_tf32<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkdvSmem);
  if (err != cudaSuccess) return err;
  const long long kv_blocks =
      static_cast<long long>((Tn + C::kKeys - 1) / C::kKeys) * KV * B;
  fa_bwd_dkdv_tf32<HD>
      <<<static_cast<unsigned>(kv_blocks), kThreads, C::kDkdvSmem, stream>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], lse, D, dk,
          dv, S, Tn, H, KV, B, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(fa_bwd_dq_tf32<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDqSmem);
  if (err != cudaSuccess) return err;
  const long long q_blocks =
      static_cast<long long>((S + C::kQRows - 1) / C::kQRows) * H * B;
  fa_bwd_dq_tf32<HD>
      <<<static_cast<unsigned>(q_blocks), kThreads, C::kDqSmem, stream>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], lse, D, dq,
          S, Tn, H, KV, B, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout: (B, S, H, HD); k, v: (B, T, KV, HD) with H = KV * G; lse
// (B, H, S) float32, the forward's row log-sum-exp; all contiguous and
// 16-byte aligned, HD 32, 64 or 128; causal needs S == T (the wrapper
// checks). Scratch: D (B, H, S), k_lo and v_lo (B, T, KV, HD), 16-byte
// aligned. dq (B, S, H, HD), dk and dv (B, T, KV, HD), each fully written.
// All float32.
extern "C" int tdorch_flash_attention_bwd_tf32(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, int B, int S, int Tn, int H, int KV,
    int HD, float scale, int causal, float* D, float* k_lo, float* v_lo,
    void* dq, void* dk, void* dv, cudaStream_t stream) {
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
                       causal, D, k_lo, v_lo, dqf, dkf, dvf, stream);
      break;
    case 64:
      err = launch<64>(qf, kf, vf, of, df, lse, B, S, Tn, H, KV, scale,
                       causal, D, k_lo, v_lo, dqf, dkf, dvf, stream);
      break;
    case 128:
      err = launch<128>(qf, kf, vf, of, df, lse, B, S, Tn, H, KV, scale,
                        causal, D, k_lo, v_lo, dqf, dkf, dvf, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
