// The backward of the Mamba2 SSD chunk scan (mamba_scan.cu), float32, for
// Hopper (sm_90a): TF32 `wgmma` on tiles brought by TMA, every product in
// 3xTF32. The route for operands a TMA tensor map can describe (hd and ds
// multiples of 4, x, dy, B, C and the forward's states 16-byte aligned);
// mamba_scan_bwd.cu keeps the others (kernels/mamba_scan/ops.py:
// `bwd_route`).
//
// The JAX package has no backward kernel for its scan: `jax.grad`
// differentiates the XLA ops of src/repro/models/mamba.py:77
// (`mamba_chunked`). The arithmetic is mamba_scan_bwd.cu's (the formulas
// at its top, `ssd_scan_bwd_ref` in kernels/mamba_scan/ref.py); per (b,
// head, chunk) of c steps, l the chunk's cumulative dt·A, E[t,s] =
// exp(l_t − l_s) for s <= t, H the state entering the chunk, G the
// gradient of the state leaving it:
//   W = (C·Bᵀ) ∘ E ∘ dt_s,  P = dy·xᵀ,  Q = P ∘ E ∘ dt_s,  Z = P ∘ (C·Bᵀ) ∘ E
//   dx = Wᵀ·dy + w ∘ (B·Gᵀ),  dB = Σ_h Qᵀ·C + w ∘ (x·G),
//   dC = Σ_h Q·B + exp(l) ∘ (dy·H),  w_s = exp(L − l_s)·dt_s,
// and dl, ddt, dA from Z's sums, (x·G)·B, (dy·H)·C and ⟨G, H⟩.
//
// Two kernels here and one of mamba_scan_bwd.cu:
// - ssd_bwd_dstates_sm90: D_k = Σ_t exp(l_t)·dy_t ⊗ C_t for each (b,
//   chunk, head) into the gradient scratch, on `wgmma`: A = (exp(l) ∘ dy)ᵀ
//   read down dy's columns, B = Cᵀ, written once a block of kDsHeads heads
//   with its lo half. It moves bytes (dy read once, D written once): the
//   heads' dy tiles stream through a TMA ring of kDsStages.
// - ssd_bwd_state_pass (mamba_scan_bwd.cu, through
//   tdorch_ssd_bwd_state_pass): G_{k−1} = exp(L_k)·G_k + D_k in reverse.
// - ssd_bwd_chunk_sm90: everything else, one persistent block an SM
//   walking (b, chunk, group of heads) units; the wrapper counts the
//   groups (`ops.SM90_HEADS_PER_BLOCK`) and the kernel checks them.
//
// ssd_bwd_chunk_sm90's design.
// - The Q products once a unit. Σ_h Qᵀ·C = (Σ_h Q)ᵀ·C and Σ_h Q·B =
//   (Σ_h Q)·B: B and C belong to the chunk, not the head, so the block
//   sums Q over its heads in float32 registers and multiplies the sum by C
//   and B once at the unit's end. B·Cᵀ is formed once a unit too (kept in
//   shared memory as float32), and P once a head (mamba_scan_bwd.cu's
//   kernel forms P twice and B·Cᵀ once a head).
// - The causal triangle of a 128-step chunk is three 64 x 64 blocks
//   (s0,t0), (s0,t1), (s1,t1), split evenly over the two consumer
//   warpgroups. Warpgroup WG owns the steps [64 WG, + 64) as s for Q's
//   sums, W, dx, x·G and dB, and as t for H·dy and dC. Pᵀ is 96 columns
//   of t a warpgroup: warpgroup 0 its rows for t < 96 (n64 + n32),
//   warpgroup 1 its rows (n64) and warpgroup 0's rows for t >= 96 (n32),
//   whose Z column sums it leaves apart (`Vecs::colz2`). W·dy runs a warp's
//   16 rows s over the k8 steps t >= their first s; the warps of warpgroup
//   1 take their block's strips in reverse, so that the two warps on each
//   of the SM's four sub-partitions (w and w + 4) carry 18 k8 steps
//   together (16 − 2w and 2 + 2w). The unit's end is 24 k8 steps each.
// - Products and their operands. TF32 `wgmma` reads its shared-memory
//   operand K-major only and needs its lo half beside it, so the operands
//   read by descriptor are tiles as TMA lays them out, with lo halves the
//   consumers write into one slot in turn (C's once a unit; a head's dy's,
//   then G's once the products with dy are done, then x's):
//     Pᵀ[s][t] = x·dyᵀ      wgmma, A = x rows, B = dy
//     (H·dy)ᵀ[n][t]         wgmma, A = H read down its columns, B = dy
//     (B·Gᵀ)[s][p]          wgmma, A = B rows, B = G: dx's w ∘ (B·Gᵀ), and
//                           x·(B·Gᵀ) summed over p is (x·G)·B
//     (x·G)ᵀ[n][s]          wgmma, A = G read down its columns, B = x
//     B·Cᵀ[s][t]            wgmma once a unit, A = B rows, B = C
//   The products whose K-major operand would be a tile seen transposed
//   (dyᵀ for W·dy; C and Σ_h Q at the unit's end) run as 3xTF32 `mma.sync`
//   m16n8k8, whose B fragments load from the tiles in any order. No tile
//   is copied to be transposed: one head's x, H, G, dy (two deep) and the
//   lo slot fit beside B·Cᵀ.
// - Warp specialisation: warp 8 lane 0 issues the TMA loads (dy into two
//   stages, x, H, G into one each, C a unit), warp 9 stages each head's l,
//   dt and exp(l), warp 10 takes each head's dl, its reverse cumulative
//   sum, ddt and dA's partial from the sums the consumers leave in shared
//   memory (two heads deep) while they go on with the next head. Each slot
//   has a full and an empty mbarrier and is released after its last use
//   (H after H·dy, x after x·G, G and dy after dx), so the next head's
//   tiles arrive while this head's products run.
// - Sums. Every product is lo·hi, hi·lo, hi·hi (hi the float32 value,
//   truncated by the tensor core as it reads it; lo the rest, exact in
//   float32). The tensor core carries a product's sum over its depth (64 of
//   B·Cᵀ, P, H·dy, B·Gᵀ, x·G; dx carries w ∘ (B·Gᵀ) on through W·dy's 128;
//   128 at the unit's end) and truncates it; what is summed across heads
//   (Σ_h Q, w ∘ (x·G), exp(l) ∘ (dy·H)) is folded in float32 once a head,
//   and dstates' D every 32 steps of t. tests/test_torch_ssd_emulation.py
//   emulates these sums step for step and shows them within the float32
//   gate, and dB / dC carried on the tensor core through a unit's heads
//   missing it.
// - dB and dC are written once a unit as partials a head group that the
//   wrapper adds; dA as a partial a (row, chunk, head). No atomics: two
//   calls on the same inputs give the same bits.
// - Rows past a chunk's end (a chunk shorter than 128, whose tiles reach
//   into the next chunk) are masked: E = 0 there, and nothing of them is
//   stored. Columns past hd or ds and rows past S read as zeros (TMA).
//
// What bounds it on this card: operations (chip_smoke.py `_ssd_bwd_work`:
// 0.1578 ms at 495/3 TFLOP/s for zamba2's training shape, the Q products
// counted once a (b, chunk)), with the bytes of x, dy, H and G of every
// (b, chunk, head) close behind (0.1446 ms).
// What holds it back (PERF.md §6 row 7b): W·dy on `mma.sync`, about a
// fifth of the kernel's time at that shape (tools/ssd_bwd_variants.py
// `no_wdy`), and each head's chain of single-slot loads and hand-offs.
// tools/ssd_bwd_variants.py also times the kernel with the triangle's
// balance undone.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

// the state pass of mamba_scan_bwd.cu, shared by both routes
extern "C" int tdorch_ssd_bwd_state_pass(const float* l,
                                         const float* dh_final, int B,
                                         int nh, int NC, int hdds,
                                         float* grads, cudaStream_t stream);

namespace {

using sm90::bar_sync;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_wait;

constexpr int kC = 128;  // a chunk's rows (mamba_scan.cu's kMaxChunk)
constexpr float kLog2e = 1.4426950408889634f;

// ssd_bwd_chunk_sm90
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// registers a thread after `setmaxnreg`: 256 x 232 + 128 x 40 of the
// 64,512 the block starts with (168 a thread)
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kAll = 1;  // named barrier of the two consumer warpgroups
constexpr int kTile = kC * 64 * 4;      // x, dy, dy_lo or C: 128 x 64
constexpr int kState = 64 * 64 * 4;     // H or G: 64 x 64
constexpr int kBlock = 64 * 64 * 4;     // a 64 x 64 block of B·Cᵀ
constexpr int kXOff = 0, kDyOff = kTile, kDyLoOff = 3 * kTile;
constexpr int kHOff = 4 * kTile, kGOff = kHOff + kState;
constexpr int kBcOff = kGOff + kState;  // C, then B·Cᵀ, then Σ_h Qᵀ
constexpr int kChunkSmem = 1024 + kBcOff + 3 * kBlock;

// ssd_bwd_dstates_sm90
constexpr int kDsHeads = 16;  // heads a block
// dy tiles in flight a block: even, because the two consumer warpgroups
// take the heads in turns, so that each stage has one warpgroup, which
// waits on its phases in order (with an odd depth a warpgroup could pass a
// wait on the parity of the stage's previous phase, the other's)
constexpr int kDsStages = 4;
static_assert(kDsStages % 2 == 0, "each ring stage has one warpgroup");
constexpr int kDsThreads = 256 + 32;  // two consumer warpgroups, a TMA warp
constexpr int kDsSmem = 1024 + 2 * kTile + kDsStages * kTile;  // Cᵀ, lo, dy

__device__ __forceinline__ float ex(float v) {
  return sm90::exp2_approx(v * kLog2e);
}

__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

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

// The dynamic shared memory from its first 1,024-byte boundary, derived by
// an offset so that the compiler keeps every pointer into it in shared
// memory (LDS / STS).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* smem_raw) {
  return smem_raw + ((1024u - (sm90::smem_addr(smem_raw) & 1023u)) & 1023u);
}

// The byte offset of float (r, c) in a tile of 128-byte rows (32 floats)
// swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes them, whose
// 32-column atoms lie `rows` rows apart. (c & 31) >> 2, as in
// flash_attention_bwd_tf32_sm90.cu.
__device__ __forceinline__ uint32_t at(int rows, int r, int c) {
  return (c >> 5) * rows * 128 + sm90::swizzled<128>(r, (c & 31) >> 2) +
         (c & 3) * 4;
}

__device__ __forceinline__ float lds(const uint8_t* tile, uint32_t off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// B·Cᵀ's (and at a unit's end Σ_h Qᵀ's) element (s, t), t >= 64 or s <
// 64: block (s0,t0), (s0,t1) or (s1,t1), each a 64 x 64 swizzled tile.
__device__ __forceinline__ uint32_t blk(int s, int t) {
  const int b = s < 64 ? (t < 64 ? 0 : 1) : 2;
  return b * kBlock + at(64, s & 63, t & 63);
}

// The descriptor of k8 slice ks (32 bytes of K) of a K-major tile at `base`
// whose 32-column atoms lie 128 rows apart.
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int ks,
                                          int atom_rows = kC) {
  return sm90::descriptor(base + (ks / 4) * atom_rows * 128 + (ks % 4) * 32,
                          16, 1024, 1);
}

// One k8 slice of c += A · B on `wgmma`, 3xTF32: lo·hi, hi·lo, hi·hi.
template <int N>
__device__ __forceinline__ void wmma3(float (&c)[N / 2],
                                      const uint32_t (&hi)[4],
                                      const uint32_t (&lo)[4], uint64_t b,
                                      uint64_t b_lo) {
  sm90::wgmma_rs_tf32<N>(c, lo, b);
  sm90::wgmma_rs_tf32<N>(c, hi, b_lo);
  sm90::wgmma_rs_tf32<N>(c, hi, b);
}

// c (64 x N) = A · B over 64 of K on `wgmma`: A(m, k) = a_at(m, k) for
// this thread's rows m = m0 + g (+8) (m0 = the warp's first row), the
// k8 slice and the fragment's register also given, split into registers; B the N rows of the K-major tile at b (atoms atom_rows
// rows apart) with its lo half at b_lo. The tensor core carries the sum
// over the 8 slices.
template <int N, typename F>
__device__ __forceinline__ void wg_gemm(float (&c)[N / 2], F&& a_at, int m0,
                                        uint32_t b, uint32_t b_lo, int g,
                                        int t, int atom_rows = kC) {
  constexpr int kGroup = 2;
  zero(c);
#pragma unroll
  for (int c0 = 0; c0 < 8; c0 += kGroup) {
    uint32_t hi[kGroup][4], lo[kGroup][4];
#pragma unroll
    for (int s = 0; s < kGroup; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sm90::split_tf32(a_at(m0 + g + 8 * (i & 1),
                              8 * (c0 + s) + t + 4 * (i >> 1), c0 + s, i),
                         hi[s][i], lo[s][i]);
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kGroup; ++s)
      wmma3<N>(c, hi[s], lo[s], kdesc(b, c0 + s, atom_rows),
               kdesc(b_lo, c0 + s, atom_rows));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(c);
    sm90::fence_regs(hi);
    sm90::fence_regs(lo);
  }
}

// A fragment of `mma.sync` m16n8k8 from four floats, split hi / lo.
struct Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit Frag(const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sm90::split_tf32(v[i], hi[i], lo[i]);
  }
};

// d += a · b on `mma.sync` m16n8k8, 3xTF32, b = {(k = t, n = g), (k = t +
// 4, n = g)}; the tensor core carries d.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  sm90::split_tf32(b0, h0, l0);
  sm90::split_tf32(b1, h1, l1);
  sm90::mma_3xtf32(d, a.hi, a.lo, h0, h1, l0, l1);
}

// ---- ssd_bwd_dstates_sm90 ----------------------------------------------------
// D[p][n] = Σ_t (exp(l_t)·dy_t[p])·C_t[n] for kDsHeads heads of one (b,
// chunk) on `wgmma`: A = (exp(l) ∘ dy)ᵀ, read down dy's columns into
// registers; B = Cᵀ (K-major over t), which the block writes once with its
// lo half from C's TMA tile. The two consumer warpgroups take the heads in
// turns, each a whole 64 x 64 D; warp 8 lane 0 brings each head's dy
// through a ring of kDsStages stages. The tensor core carries 32 steps of
// t (4 slices), each added to a float32 sum.
__global__ void __launch_bounds__(kDsThreads, 1)
ssd_bwd_dstates_sm90(const __grid_constant__ CUtensorMap dy_map,
                     const __grid_constant__ CUtensorMap c_map,
                     const float* __restrict__ l, float* __restrict__ dstates,
                     int S, int nh, int hd, int ds, int chunk, int NC) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDsStages], empty[kDsStages], c_full,
      c_done;
  __shared__ float el[kDsHeads][kC];  // exp(l_t), 0 past the chunk
  uint8_t* sm = aligned_smem(smem_raw);
  uint8_t* cts = sm;              // Cᵀ: (n, t), atoms 64 rows apart
  uint8_t* ctlo = cts + kTile;    // its lo half
  uint8_t* ring = ctlo + kTile;   // kDsStages stages of dy
  // C as TMA lays it out, (t, n), in the last stage until it is transposed
  const uint8_t* cs = ring + (kDsStages - 1) * kTile;

  const int k = blockIdx.x, b = blockIdx.z;
  const int c0 = k * chunk, L = min(chunk, S - c0);
  const int head_lo = blockIdx.y * kDsHeads;
  const int n_heads = min(nh, head_lo + kDsHeads) - head_lo;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int j = 0; j < kDsStages; ++j) {
      sm90::mbar_init(&full[j], 1);
      sm90::mbar_init(&empty[j], 4);  // the warps of the head's warpgroup
    }
    sm90::mbar_init(&c_full, 1);
    sm90::mbar_init(&c_done, 8);  // the consumer warps
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (warp == 8) {  // ---- TMA ----
    if (lane == 0) {
      mbar_expect_tx(&c_full, kTile);
      for (int a = 0; a < 2; ++a)
        sm90::tma_load_3d(ring + (kDsStages - 1) * kTile + a * kC * 128,
                          &c_map, &c_full, a * 32, c0, b);
      for (int j = 0; j < n_heads; ++j) {
        const int s = j % kDsStages;
        if (j == kDsStages - 1) mbar_wait(&c_done, 0);  // C is transposed
        mbar_wait(&empty[s], ((j / kDsStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kTile);
        for (int a = 0; a < 2; ++a)
          sm90::tma_load_4d(ring + s * kTile + a * kC * 128, &dy_map,
                            &full[s], a * 32, head_lo + j, c0, b);
      }
    }
    return;
  }
  for (int e = tid; e < n_heads * kC; e += 256) {
    const int t = e % kC;
    const long long bhk =
        (static_cast<long long>(b) * nh + head_lo + e / kC) * NC + k;
    el[e / kC][t] = t < L ? ex(l[bhk * kC + t]) : 0.f;
  }
  mbar_wait(&c_full, 0);
  for (int e = tid; e < kC * 64; e += 256) {  // Cᵀ and its lo half
    const int t = e / 64, n = e % 64;
    const float v = lds(cs, at(kC, t, n));
    *reinterpret_cast<float*>(cts + at(64, n, t)) = v;
    *reinterpret_cast<float*>(ctlo + at(64, n, t)) = tf32_lo(v);
  }
  sm90::fence_proxy_async();
  bar_sync(1, 256);
  if (lane == 0) mbar_arrive(&c_done);

  const int wg = warp / 4, wi = warp % 4, g = lane / 4, q = lane % 4;
  const uint32_t bt = sm90::smem_addr(cts), bt_lo = sm90::smem_addr(ctlo);
  for (int j = wg; j < n_heads; j += 2) {
    const int s = j % kDsStages;
    const uint8_t* dys = ring + s * kTile;
    mbar_wait(&full[s], (j / kDsStages) & 1);
    float acc[32], part[32];
    zero(acc);
#pragma unroll 1
    for (int kc = 0; kc < 16; kc += 4) {  // 32 steps of t a sum
      zero(part);
#pragma unroll
      for (int c2 = 0; c2 < 4; c2 += 2) {
        uint32_t hi[2][4], lo[2][4];
#pragma unroll
        for (int ss = 0; ss < 2; ++ss)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = 8 * (kc + c2 + ss) + q + 4 * (r >> 1);
            const int pr = 16 * wi + g + 8 * (r & 1);
            sm90::split_tf32(lds(dys, at(kC, t, pr)) * el[j][t], hi[ss][r],
                             lo[ss][r]);
          }
        sm90::wgmma_fence();
#pragma unroll
        for (int ss = 0; ss < 2; ++ss)
          wmma3<64>(part, hi[ss], lo[ss], kdesc(bt, kc + c2 + ss, 64),
                    kdesc(bt_lo, kc + c2 + ss, 64));
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(part);
        sm90::fence_regs(hi);
        sm90::fence_regs(lo);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += part[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    const long long bhk =
        (static_cast<long long>(b) * nh + head_lo + j) * NC + k;
    float* out = dstates + bhk * hd * ds;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wi + g + 8 * h, n = 8 * jn + 2 * q;
        if (r < hd && n < ds)
          *reinterpret_cast<float2*>(out + r * ds + n) =
              make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
      }
  }
}

// ---- ssd_bwd_chunk_sm90 ------------------------------------------------------
struct Args {
  const float *dt, *A, *Bc, *Cc, *l;
  float *dx, *ddt, *dB_part, *dC_part, *dA_part;
  int B, S, nh, hd, ds, chunk, NC, groups, hpb, units;
};

// One head's sums, left by the consumers for the tail warp.
struct Vecs {
  float colz[kC];     // Σ_t Z[t][s], by s (for s < 64, t < 96)
  float colz2[64];    // Σ_t Z[t][s] over t >= 96, by s < 64
  float xgb[kC];      // (x·G)·B, by s
  float rowz[8][kC];  // Σ_s Z[t][s]·dt_s over each consumer warp's rows s
                      // (warpgroup 0's for t < 96, warpgroup 1's t >= 64)
  float dyhc[4][kC];  // (dy·H)·C over the n of each warp of t's block
  float gh[4];        // ⟨G, H⟩ over each of warpgroup 1's warps
};

struct Bars {
  uint64_t c_full, bc_empty, x_full, x_empty, g_full, g_empty, h_full,
      h_empty, vec_full[2], vec_empty[2], dy_full[2], dy_empty[2];
};

// the dynamic shared memory and the static (two heads' sums, l / dt /
// exp(l) a dy stage, the barriers) within the 232,448 bytes a block may use
static_assert(kChunkSmem + 2 * sizeof(Vecs) + 2 * 3 * kC * 4 + sizeof(Bars) <=
                  232448,
              "shared memory");

struct Unit {
  int b, k, grp, c0, L, head_lo, head_hi;
  long long row0;
  __device__ Unit(const Args& a, int u) {
    grp = u % a.groups;
    const int bk = u / a.groups;
    k = bk % a.NC;
    b = bk / a.NC;
    c0 = k * a.chunk;
    L = min(a.chunk, a.S - c0);
    row0 = static_cast<long long>(b) * a.S + c0;
    head_lo = grp * a.hpb;
    head_hi = min(a.nh, head_lo + a.hpb);
  }
};

template <int V>
using Int = std::integral_constant<int, V>;

// The consumer warpgroup WG: steps [64 WG, + 64) as s (Q's sums, W, dx,
// x·G, dB) and as t ((H·dy)ᵀ, dC); Pᵀ over 96 columns of t (the header).
// Its warp w takes the 16 rows s of strip w of the block, warpgroup 1's in
// reverse (strip 3 − w).
template <int WG>
__device__ __forceinline__ void consume(const Args& a, uint8_t* sm,
                                        Vecs* vecs, float (*ldt)[3 * kC],
                                        Bars& bar) {
  constexpr int kS0 = 64 * WG;  // its rows s, and its block of t
  constexpr int kNT = 16 - kS0 / 8;  // n8 tiles of t >= kS0: B·Cᵀ's row
  // Σ_h Qᵀ's n8 tiles of t kept by this WG: warpgroup 0 t < 96 of its
  // rows; warpgroup 1 its rows (8 tiles), then t >= 96 of warpgroup 0's
  constexpr int kQT = 12;
  const uint8_t* xs = sm + kXOff;
  uint8_t* dylo = sm + kDyLoOff;
  const uint8_t* hs = sm + kHOff;
  const uint8_t* gs = sm + kGOff;
  uint8_t* bcs = sm + kBcOff;
  const int tid = threadIdx.x, warp = tid / 32, wi = warp % 4;
  const int strip = WG == 0 ? wi : 3 - wi;
  const int m0 = kS0 + 16 * strip;  // the warp's first row s
  const int lane = tid % 32, g = lane / 4, q = lane % 4;
  const int sr[2] = {m0 + g, m0 + g + 8};
  const int ds = a.ds, nh = a.nh, hd = a.hd;
  // tile j of qsum: its first t, and whether its rows are warpgroup 0's
  // strip wi (warpgroup 1's tiles of t >= 96)
  auto q_t = [](int j) {
    return WG == 0 ? 8 * j : j < 8 ? 64 + 8 * j : 32 + 8 * j;
  };
  auto q_other = [](int j) { return WG == 1 && j >= 8; };

  float qsum[kQT * 4];  // Σ_h Qᵀ: (s, t) as B·Cᵀ's, tiles as q_t says
  float dcst[32];       // Σ_h exp(l) ∘ (dy·H)ᵀ: rows n, this WG's t block
  float dbst[32];       // Σ_h w ∘ (x·G)ᵀ: rows n, this WG's block of s
  int i = 0;  // heads taken, over the walk
  int uc = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uc) {
    const Unit un(a, u);
    const int L = un.L;
    const float* Bg = a.Bc + un.row0 * ds;
    const float* Cg = a.Cc + un.row0 * ds;
    auto bval = [&](int s, int n) {
      return s < L && n < ds ? Bg[s * ds + n] : 0.f;
    };
    auto cval = [&](int t, int n) {
      return t < L && n < ds ? Cg[t * ds + n] : 0.f;
    };
    auto b_at = [&](int s, int n, int, int) { return bval(s, n); };

    // ---- B·Cᵀ, once a unit: C by TMA, its lo half into dy_lo's slot
    mbar_wait(&bar.c_full, uc & 1);
    {
      const float* cf = reinterpret_cast<const float*>(bcs);
      float* clo = reinterpret_cast<float*>(dylo);
      for (int e = tid; e < kC * 64; e += kConsumers) clo[e] = tf32_lo(cf[e]);
    }
    sm90::fence_proxy_async();
    bar_sync(kAll, kConsumers);
    {
      float bc[kNT * 4];
      wg_gemm<kNT * 8>(bc, b_at, m0, sm90::smem_addr(bcs) + kS0 * 128,
                       sm90::smem_addr(dylo) + kS0 * 128, g, q);
      bar_sync(kAll, kConsumers);  // C and its lo half read by all
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(bcs + blk(sr[h], kS0 + 8 * j + 2 * q)) =
              make_float2(bc[4 * j + 2 * h], bc[4 * j + 2 * h + 1]);
    }
    zero(qsum);
    zero(dcst);
    zero(dbst);

    for (int head = un.head_lo; head < un.head_hi; ++head, ++i) {
      // the lane, opaque to the compiler once a head: the unrolled loops'
      // shared-memory offsets are formed where they are used rather than
      // hoisted out of the head loop and held in registers across it
      int ln = lane;
      asm volatile("" : "+r"(ln));
      const int g = ln / 4, q = ln % 4;
      const int sr[2] = {m0 + g, m0 + g + 8};
      const int so[2] = {16 * wi + g, 16 * wi + g + 8};  // strip wi of s0
      const int slot = i & 1;
      Vecs& vec = vecs[slot];
      const uint8_t* dyt = sm + kDyOff + slot * kTile;
      // both warpgroups' B·Cᵀ stored (a new unit), and the last head's
      // readers of dy_lo done
      mbar_wait(&bar.dy_full[slot], (i >> 1) & 1);
      bar_sync(kAll, kConsumers);
      {
        const float* src = reinterpret_cast<const float*>(dyt);
        float* dst = reinterpret_cast<float*>(dylo);
        for (int e = tid; e < kC * 64; e += kConsumers)
          dst[e] = tf32_lo(src[e]);
      }
      sm90::fence_proxy_async();
      bar_sync(kAll, kConsumers);
      const float* lv = ldt[slot];
      const float* dtv = lv + kC;
      const float ls[2] = {lv[sr[0]], lv[sr[1]]};
      const float dts[2] = {dtv[sr[0]], dtv[sr[1]]};
      const float lend = lv[kC - 1];
      const float ws[2] = {ex(lend - ls[0]) * dts[0],
                           ex(lend - ls[1]) * dts[1]};

      // ---- Pᵀ = x·dyᵀ, N columns of t from tb over the rows rs (l_s and
      // dt_s beside them), into Σ_h Q's tiles from J0 and Z's sums: its
      // column sums into cz, Z ∘ dt_s summed over the warp's rows into
      // rowz (ACC: onto what the same lane stored there in the warp's
      // earlier pass)
      mbar_wait(&bar.x_full, i & 1);
      auto p_pass = [&](auto n_, auto j0_, auto first_, auto acc_, int rm0,
                        int tb, const int(&rs)[2], const float(&lr)[2],
                        const float(&dr)[2], float(&cz)[2]) {
        constexpr int N = decltype(n_)::value, J0 = decltype(j0_)::value;
        float pt[N / 2];
        wg_gemm<N>(
            pt, [&](int m, int kk, int, int) { return lds(xs, at(kC, m, kk)); },
            rm0, sm90::smem_addr(dyt) + tb * 128,
            sm90::smem_addr(dylo) + tb * 128, g, q);
        if constexpr (decltype(first_)::value)  // the tail is done with
          // this buffer's last head
          mbar_wait(&bar.vec_empty[slot], ((i >> 1) & 1) ^ 1);
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj) {
          const int j = J0 + jj;
          const int tc = tb + 8 * jj + 2 * q;
          const float2 lt = *reinterpret_cast<const float2*>(lv + tc);
          float rz[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 bc =
                *reinterpret_cast<const float2*>(bcs + blk(rs[h], tc));
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int t = tc + c, e = 4 * jj + 2 * h + c;
              const float E = rs[h] <= t && t < L
                                  ? ex((c ? lt.y : lt.x) - lr[h])
                                  : 0.f;
              qsum[4 * j + 2 * h + c] += pt[e] * E * dr[h];
              const float z = pt[e] * (c ? bc.y : bc.x) * E;
              cz[h] += z;
              rz[c] += z * dr[h];
            }
          }
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              rz[c] += __shfl_xor_sync(0xffffffffu, rz[c], off);
          if (g == 0) {
            if constexpr (decltype(acc_)::value) {
              vec.rowz[warp][tc] += rz[0];
              vec.rowz[warp][tc + 1] += rz[1];
            } else {
              vec.rowz[warp][tc] = rz[0];
              vec.rowz[warp][tc + 1] = rz[1];
            }
          }
        }
      };
      auto store_colz = [&](float(&cz)[2], float* dst, const int(&rs)[2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            cz[h] += __shfl_xor_sync(0xffffffffu, cz[h], off);
        if (q == 0) {
          dst[rs[0]] = cz[0];
          dst[rs[1]] = cz[1];
        }
      };
      {
        float colz[2] = {0.f, 0.f};
        if constexpr (WG == 0) {  // t in [0, 96) of its rows
          p_pass(Int<64>{}, Int<0>{}, Int<1>{}, Int<0>{}, m0, 0, sr, ls, dts,
                 colz);
          p_pass(Int<32>{}, Int<8>{}, Int<0>{}, Int<0>{}, m0, 64, sr, ls,
                 dts, colz);
        } else {  // t in [64, 128) of its rows, t in [96, 128) of strip wi
          p_pass(Int<64>{}, Int<0>{}, Int<1>{}, Int<0>{}, m0, 64, sr, ls,
                 dts, colz);
          const float lso[2] = {lv[so[0]], lv[so[1]]};
          const float dso[2] = {dtv[so[0]], dtv[so[1]]};
          float colz2[2] = {0.f, 0.f};
          p_pass(Int<32>{}, Int<8>{}, Int<0>{}, Int<1>{}, 16 * wi, 96, so,
                 lso, dso, colz2);
          store_colz(colz2, vec.colz2, so);
        }
        store_colz(colz, vec.colz, sr);
      }

      // ---- (H·dy)ᵀ[n][t] = Σ_p H[p][n]·dy[t][p] over this WG's block of
      // t: dC's exp(l) ∘ (dy·H), (dy·H)·C; and ⟨G, H⟩ (warpgroup 1)
      mbar_wait(&bar.h_full, i & 1);
      {
        float yh[32];
        wg_gemm<64>(
            yh,
            [&](int m, int kk, int, int) { return lds(hs, at(64, kk, m)); },
            16 * wi, sm90::smem_addr(dyt) + kS0 * 128,
            sm90::smem_addr(dylo) + kS0 * 128, g, q);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int tc = kS0 + 8 * j + 2 * q;
          const float2 elt =
              *reinterpret_cast<const float2*>(lv + 2 * kC + tc);
          float dcol[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = 16 * wi + g + 8 * h;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * h + c;
              dcol[c] += yh[e] * cval(tc + c, n);
              dcst[e] += (c ? elt.y : elt.x) * yh[e];
            }
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              dcol[c] += __shfl_xor_sync(0xffffffffu, dcol[c], off);
            if (g == 0) vec.dyhc[wi][tc + c] = dcol[c];
          }
        }
      }
      mbar_wait(&bar.g_full, i & 1);
      if constexpr (WG == 1) {
        float v = 0.f;  // the tiles share a layout: element by element
        const float* gf = reinterpret_cast<const float*>(gs);
        const float* hf = reinterpret_cast<const float*>(hs);
        for (int e = tid - 128; e < 64 * 64; e += 128) v += gf[e] * hf[e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) vec.gh[wi] = v;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar.h_empty);

      // ---- G's lo half, into dy_lo's slot (its readers, H·dy and Pᵀ, are
      // done); (B·Gᵀ)[s][p] on wgmma (A = B rows, B = G, K-major over n),
      // x·(B·Gᵀ) summed over p as (x·G)·B, then times w_s: dx's first part
      uint8_t* glo = dylo;
      bar_sync(kAll, kConsumers);
      {
        const float* gf = reinterpret_cast<const float*>(gs);
        float* gl = reinterpret_cast<float*>(glo);
        for (int e = tid; e < 64 * 64; e += kConsumers) gl[e] = tf32_lo(gf[e]);
      }
      sm90::fence_proxy_async();
      bar_sync(kAll, kConsumers);
      float dxa[32];
      wg_gemm<64>(dxa, b_at, m0, sm90::smem_addr(gs),
                  sm90::smem_addr(glo), g, q, 64);
      {
        float xgb[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, p = 8 * j + 2 * q + (e & 1);
            xgb[h] += dxa[4 * j + e] * lds(xs, at(kC, sr[h], p));
            dxa[4 * j + e] *= ws[h];
          }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            xgb[h] += __shfl_xor_sync(0xffffffffu, xgb[h], off);
        if (q == 0) {
          vec.xgb[sr[0]] = xgb[0];
          vec.xgb[sr[1]] = xgb[1];
        }
      }

      // ---- x's lo half, into the lo slot ((B·Gᵀ) is done with G's);
      // (x·G)ᵀ[n][s] = Σ_p G[p][n]·x[s][p] on wgmma over this WG's block of
      // s (A = G read down its columns, B = x, K-major over p): dB's w ∘
      // (x·G), folded in float32
      bar_sync(kAll, kConsumers);
      {
        const float* xf = reinterpret_cast<const float*>(xs);
        float* xl = reinterpret_cast<float*>(dylo);
        for (int e = tid; e < kC * 64; e += kConsumers) xl[e] = tf32_lo(xf[e]);
      }
      sm90::fence_proxy_async();
      bar_sync(kAll, kConsumers);
      {
        float xg[32];
        wg_gemm<64>(
            xg,
            [&](int m, int kk, int, int) { return lds(gs, at(64, kk, m)); },
            16 * wi, sm90::smem_addr(xs) + kS0 * 128,
            sm90::smem_addr(dylo) + kS0 * 128, g, q);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int sc = kS0 + 8 * j + 2 * q;
          const float2 l2 = *reinterpret_cast<const float2*>(lv + sc);
          const float2 d2 = *reinterpret_cast<const float2*>(dtv + sc);
          const float w0 = ex(lend - l2.x) * d2.x, w1 = ex(lend - l2.y) * d2.y;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            dbst[4 * j + 2 * h] += w0 * xg[4 * j + 2 * h];
            dbst[4 * j + 2 * h + 1] += w1 * xg[4 * j + 2 * h + 1];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar.x_empty);

      mbar_arrive(&bar.vec_full[slot]);  // this thread's sums are in

      // ---- dx += Wᵀ·dy (mma.sync, carried on the tensor core), rows s:
      // the k8 steps of t from the strip's first s (W[t][s] = 0 for t <
      // s), the others skipped in a loop of constant bounds (a loop from
      // m0 ran slower: tools/ssd_bwd_variants.py `from_m0`)
      {
#pragma unroll 2
        for (int kk = kS0; kk < kC; kk += 8) {
          if (kk < m0) continue;
          float v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int h = r & 1, t = kk + q + 4 * (r >> 1);
            v[r] = sr[h] <= t && t < L
                       ? lds(bcs, blk(sr[h], t)) * ex(lv[t] - ls[h]) * dts[h]
                       : 0.f;
          }
          const Frag fa(v);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma3(*reinterpret_cast<float(*)[4]>(dxa + 4 * nt), fa,
                 lds(dyt, at(kC, kk + q, 8 * nt + g)),
                 lds(dyt, at(kC, kk + q + 4, 8 * nt + g)));
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&bar.g_empty);
          mbar_arrive(&bar.dy_empty[slot]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 8 * nt + 2 * q;
            if (sr[h] < L && p < hd)
              *reinterpret_cast<float2*>(
                  a.dx + ((un.row0 + sr[h]) * nh + head) * hd + p) =
                  make_float2(dxa[4 * nt + 2 * h], dxa[4 * nt + 2 * h + 1]);
          }
      }
    }

    // ---- the unit's end: dB = (Σ_h Q)ᵀ·C + Σ_h w ∘ (x·G), dC = (Σ_h Q)·B
    // + Σ_h exp(l) ∘ (dy·H), both transposed (rows n), through Σ_h Qᵀ in
    // B·Cᵀ's blocks
    bar_sync(kAll, kConsumers);  // the last head's products are all done
#pragma unroll
    for (int j = 0; j < kQT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = q_other(j) ? 16 * wi + g + 8 * h : sr[h];
        *reinterpret_cast<float2*>(bcs + blk(s, q_t(j) + 2 * q)) =
            make_float2(qsum[4 * j + 2 * h], qsum[4 * j + 2 * h + 1]);
      }
    bar_sync(kAll, kConsumers);  // both warpgroups' Σ_h Qᵀ are in
    const long long part0 = static_cast<long long>(un.grp) * a.B * a.S;
    {  // dBᵀ[n][s] of this WG's block of s: Σ_t C[t][n]·Σ_h Qᵀ[s][t], t >=
       // the block's first s
      float db[8][4];
      zero(db);
#pragma unroll 1
      for (int ks = kS0 / 8; ks < 16; ++ks) {  // t in [8 ks, + 8)
        const int t0 = 8 * ks + q, n0 = 16 * wi + g;
        const float v[4] = {cval(t0, n0), cval(t0, n0 + 8), cval(t0 + 4, n0),
                            cval(t0 + 4, n0 + 8)};
        const Frag fa(v);
#pragma unroll
        for (int js = 0; js < 8; ++js)
          mma3(db[js], fa, lds(bcs, blk(kS0 + 8 * js + g, t0)),
               lds(bcs, blk(kS0 + 8 * js + g, t0 + 4)));
      }
#pragma unroll
      for (int js = 0; js < 8; ++js)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 16 * wi + g + 8 * (e >> 1);
          const int sv = kS0 + 8 * js + 2 * q + (e & 1);
          if (sv < L && n < ds)
            a.dB_part[(part0 + un.row0 + sv) * ds + n] =
                db[js][e] + dbst[4 * js + e];
        }
    }
    {  // dCᵀ[n][t] of this WG's block of t: Σ_s B[s][n]·Σ_h Qᵀ[s][t], s <=
       // the block's last t
      float dc[8][4];
      zero(dc);
#pragma unroll 1
      for (int ks = 0; ks < (WG + 1) * 8; ++ks) {
        const int s0 = 8 * ks + q, n0 = 16 * wi + g;
        const float v[4] = {bval(s0, n0), bval(s0, n0 + 8), bval(s0 + 4, n0),
                            bval(s0 + 4, n0 + 8)};
        const Frag fa(v);
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
          mma3(dc[jt], fa, lds(bcs, blk(s0, kS0 + 8 * jt + g)),
               lds(bcs, blk(s0 + 4, kS0 + 8 * jt + g)));
      }
#pragma unroll
      for (int jt = 0; jt < 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 16 * wi + g + 8 * (e >> 1);
          const int t = kS0 + 8 * jt + 2 * q + (e & 1);
          if (t < L && n < ds)
            a.dC_part[(part0 + un.row0 + t) * ds + n] =
                dc[jt][e] + dcst[4 * jt + e];
        }
    }
    sm90::fence_proxy_async();  // before TMA writes the next unit's C
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.bc_empty);
  }
}

// Each head's dl, its reverse cumulative sum, ddt and dA's partial, from the
// consumers' sums (mamba_scan_bwd.cu's warp-0 step): lane j the steps [4j,
// 4j + 4).
__device__ __forceinline__ void tail(const Args& a, const Vecs& vec,
                                     uint64_t& full, int parity,
                                     const Unit& un, int head) {
  const int lane = threadIdx.x % 32, L = un.L;
  const long long bhk =
      (static_cast<long long>(un.b) * a.nh + head) * a.NC + un.k;
  const float* lr = a.l + bhk * kC;
  float lu[4], dtu[4], dl[4], colz[4], r_sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // loaded while the sums are formed
    const int u = 4 * lane + i;
    lu[i] = lr[u];
    dtu[i] = u < L ? a.dt[(un.row0 + u) * a.nh + head] : 0.f;
  }
  const float l_end = __shfl_sync(0xffffffffu, lu[3], 31);
  mbar_wait(&full, parity);
  const float gh = vec.gh[0] + vec.gh[1] + vec.gh[2] + vec.gh[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = 4 * lane + i;
    float row = 0.f;
    if (u < 96)
      row += vec.rowz[0][u] + vec.rowz[1][u] + vec.rowz[2][u] +
             vec.rowz[3][u];
    if (u >= 64)
      row += vec.rowz[4][u] + vec.rowz[5][u] + vec.rowz[6][u] +
             vec.rowz[7][u];
    colz[i] = vec.colz[u] + (u < 64 ? vec.colz2[u] : 0.f);
    const float dyhc =
        vec.dyhc[0][u] + vec.dyhc[1][u] + vec.dyhc[2][u] + vec.dyhc[3][u];
    const float R = ex(l_end - lu[i]) * dtu[i] * vec.xgb[u];
    dl[i] = u < L ? row - dtu[i] * colz[i] + ex(lu[i]) * dyhc - R : 0.f;
    r_sum += u < L ? R : 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    r_sum += __shfl_xor_sync(0xffffffffu, r_sum, off);
  const float tail_term = r_sum + ex(l_end) * gh;  // the last step's term
  float above = dl[0] + dl[1] + dl[2] + dl[3];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {  // Σ of this lane and above
    const float v = __shfl_down_sync(0xffffffffu, above, off);
    if (lane + off < 32) above += v;
  }
  const float beyond = __shfl_down_sync(0xffffffffu, above, 1);
  float run = (lane < 31 ? beyond : 0.f) + tail_term;
  const float a_head = a.A[head];
  float da = 0.f;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    const int u = 4 * lane + i;
    run += dl[i];
    if (u < L) {
      a.ddt[(un.row0 + u) * a.nh + head] =
          colz[i] + ex(l_end - lu[i]) * vec.xgb[u] + a_head * run;
      da += dtu[i] * run;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    da += __shfl_xor_sync(0xffffffffu, da, off);
  if (lane == 0)
    a.dA_part[(static_cast<long long>(un.b) * a.NC + un.k) * a.nh + head] =
        da;
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_sm90(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap dy_map,
                   const __grid_constant__ CUtensorMap c_map,
                   const __grid_constant__ CUtensorMap h_map,
                   const __grid_constant__ CUtensorMap g_map, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Vecs vecs[2];  // a head's sums, two heads deep
  // per dy stage: l, dt and exp(l) (both 0 past the chunk's end)
  __shared__ __align__(16) float ldt[2][3 * kC];
  __shared__ __align__(8) Bars bar;
  uint8_t* sm = aligned_smem(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar.c_full, 1);
    sm90::mbar_init(&bar.bc_empty, kConsumers / 32);
    sm90::mbar_init(&bar.x_full, 1);
    sm90::mbar_init(&bar.x_empty, kConsumers / 32);
    sm90::mbar_init(&bar.g_full, 1);
    sm90::mbar_init(&bar.g_empty, kConsumers / 32);
    sm90::mbar_init(&bar.h_full, 1);
    sm90::mbar_init(&bar.h_empty, kConsumers / 32);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&bar.vec_full[s], kConsumers);
      sm90::mbar_init(&bar.vec_empty[s], 1);
      sm90::mbar_init(&bar.dy_full[s], 1 + 32);  // TMA, the l / dt warp
      sm90::mbar_init(&bar.dy_empty[s], kConsumers / 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    const int role = warp - kConsumers / 32;
    int i = 0, uc = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uc) {
      const Unit un(a, u);
      for (int head = un.head_lo; head < un.head_hi; ++head, ++i) {
        const int slot = i & 1;
        const long long bhk =
            (static_cast<long long>(un.b) * a.nh + head) * a.NC + un.k;
        if (role == 0 && lane == 0) {  // TMA
          mbar_wait(&bar.dy_empty[slot], ((i >> 1) & 1) ^ 1);
          mbar_expect_tx(&bar.dy_full[slot], kTile);
          uint8_t* dyt = sm + kDyOff + slot * kTile;
          for (int at_ = 0; at_ < 2; ++at_)
            sm90::tma_load_4d(dyt + at_ * kC * 128, &dy_map,
                              &bar.dy_full[slot], at_ * 32, head, un.c0,
                              un.b);
          mbar_wait(&bar.x_empty, (i & 1) ^ 1);
          mbar_expect_tx(&bar.x_full, kTile);
          for (int at_ = 0; at_ < 2; ++at_)
            sm90::tma_load_4d(sm + kXOff + at_ * kC * 128, &x_map,
                              &bar.x_full, at_ * 32, head, un.c0, un.b);
          mbar_wait(&bar.h_empty, (i & 1) ^ 1);
          mbar_expect_tx(&bar.h_full, kState);
          for (int at_ = 0; at_ < 2; ++at_)
            sm90::tma_load_3d(sm + kHOff + at_ * 64 * 128, &h_map,
                              &bar.h_full, at_ * 32, 0,
                              static_cast<int>(bhk));
          mbar_wait(&bar.g_empty, (i & 1) ^ 1);
          mbar_expect_tx(&bar.g_full, kState);
          for (int at_ = 0; at_ < 2; ++at_)
            sm90::tma_load_3d(sm + kGOff + at_ * 64 * 128, &g_map,
                              &bar.g_full, at_ * 32, 0,
                              static_cast<int>(bhk));
          if (head == un.head_lo) {  // C, once the last unit is done with it
            mbar_wait(&bar.bc_empty, (uc & 1) ^ 1);
            mbar_expect_tx(&bar.c_full, kTile);
            for (int at_ = 0; at_ < 2; ++at_)
              sm90::tma_load_3d(sm + kBcOff + at_ * kC * 128, &c_map,
                                &bar.c_full, at_ * 32, un.c0, un.b);
          }
        } else if (role == 1) {  // l and dt of the head, beside its dy
          mbar_wait(&bar.dy_empty[slot], ((i >> 1) & 1) ^ 1);
          for (int t = lane; t < kC; t += 32) {
            const float lt = a.l[bhk * kC + t];
            ldt[slot][t] = lt;
            ldt[slot][kC + t] =
                t < un.L ? a.dt[(un.row0 + t) * a.nh + head] : 0.f;
            ldt[slot][2 * kC + t] = t < un.L ? ex(lt) : 0.f;
          }
          mbar_arrive(&bar.dy_full[slot]);
        } else if (role == 2) {  // the head's dl, ddt and dA
          tail(a, vecs[slot], bar.vec_full[slot], (i >> 1) & 1, un, head);
          __syncwarp();
          if (lane == 0) mbar_arrive(&bar.vec_empty[slot]);
        }
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    if (warp < 4)
      consume<0>(a, sm, vecs, ldt, bar);
    else
      consume<1>(a, sm, vecs, ldt, bar);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A (rows, inner) row-major float32 slab of `n` such, as a 3-D tensor map
// (inner, rows, n) read in boxes of (32, box_rows, 1).
cudaError_t slab_map(CUtensorMap* map, const void* base, int inner,
                     int rows, long long n, int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(inner),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(n)};
  const uint64_t strides[2] = {static_cast<uint64_t>(inner) * 4,
                               static_cast<uint64_t>(inner) * rows * 4};
  const uint32_t box[3] = {32, static_cast<uint32_t>(box_rows), 1};
  return sm90::make_map(map, base, 3, dims, strides, box, true);
}

}  // namespace

// The route of kernels/mamba_scan/ops.py `bwd_route` "sm90": the arguments
// of mamba_scan_bwd.cu's tdorch_ssd_scan_bwd, with hd and ds multiples of
// 4 (4 to 64) and x, dy, Bc, Cc, states and grads 16-byte aligned; groups
// of ceil(nh / groups) heads, none empty. Refuses (cudaErrorInvalidValue)
// what it cannot describe.
extern "C" int tdorch_ssd_scan_bwd_sm90(
    int device, const float* x, const float* dt, const float* A,
    const float* Bc, const float* Cc, const float* dy, const float* dh_final,
    const float* states, const float* l, int B, int S, int nh, int hd,
    int ds, int chunk, int groups, float* grads, float* dx, float* ddt,
    float* dB_part, float* dC_part, float* dA_part, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || nh == 0 || hd == 0) return 0;
  if (hd > 64 || ds > 64 || hd % 4 != 0 || ds % 4 != 0 || ds < 4 ||
      chunk < 1 || chunk > kC || B > 65535 || nh > 65535 || groups < 1 ||
      groups > nh || (groups - 1) * ((nh + groups - 1) / groups) >= nh ||
      !aligned16(x) || !aligned16(dy) || !aligned16(Bc) || !aligned16(Cc) ||
      !aligned16(states) || !aligned16(grads))
    return static_cast<int>(cudaErrorInvalidValue);
  const int NC = (S + chunk - 1) / chunk;
  const long long bhk = static_cast<long long>(B) * nh * NC;
  if (bhk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  // x, dy (B, S, nh, hd) as (hd, nh, S, B) in boxes of 32 x 1 x 128; C (B,
  // S, ds) as (ds, S, B) in 32 x 128; the states and their gradients (B,
  // nh, NC, hd, ds) as (ds, hd, B·nh·NC) in 32 x 64
  CUtensorMap x_map, dy_map, c_map, h_map, g_map;
  err = sm90::make_map(&x_map, x, hd, nh, S, B, 32, 1, kC, true);
  if (err == cudaSuccess)
    err = sm90::make_map(&dy_map, dy, hd, nh, S, B, 32, 1, kC, true);
  if (err == cudaSuccess)
    err = slab_map(&c_map, Cc, ds, S, B, kC);
  if (err == cudaSuccess) err = slab_map(&h_map, states, ds, hd, bhk, 64);
  if (err == cudaSuccess) err = slab_map(&g_map, grads, ds, hd, bhk, 64);
  if (err != cudaSuccess) return static_cast<int>(err);

  // once a device: both kernels' shared-memory opt-in and the SM count
  static int sms[64] = {0};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(ssd_bwd_dstates_sm90,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDsSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_chunk_sm90,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kChunkSmem);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    sms[device] = n;
  }
  ssd_bwd_dstates_sm90<<<dim3(NC, (nh + kDsHeads - 1) / kDsHeads, B),
                         kDsThreads, kDsSmem, stream>>>(dy_map, c_map, l, grads, S, nh,
                                            hd, ds, chunk, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rc = tdorch_ssd_bwd_state_pass(l, dh_final, B, nh, NC, hd * ds,
                                           grads, stream);
  if (rc != 0) return rc;

  Args a{dt, A, Bc, Cc, l, dx, ddt, dB_part, dC_part, dA_part, B, S, nh, hd,
         ds, chunk, NC, groups, (nh + groups - 1) / groups, 0};
  const long long units = static_cast<long long>(B) * NC * groups;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.units = static_cast<int>(units);
  const int grid =
      static_cast<int>(units < sms[device] ? units : sms[device]);
  ssd_bwd_chunk_sm90<<<grid, kThreads, kChunkSmem, stream>>>(
      x_map, dy_map, c_map, h_map, g_map, a);
  return static_cast<int>(cudaGetLastError());
}
