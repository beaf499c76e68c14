// The backward of the Mamba2 SSD chunk scan (mamba_scan.cu), float32, for
// Hopper (sm_90a): chunk-parallel, on the tensor cores.
//
// The JAX package has no backward kernel for its scan: `jax.grad`
// differentiates the XLA ops of src/repro/models/mamba.py:77
// (`mamba_chunked`), whose forward the TPU kernel `ssd_scan`
// (src/repro/kernels/mamba_scan/kernel.py:58) replaces in serving. These
// kernels give the port's forward (mamba_scan.cu) a backward of its own,
// so that training keeps only the forward's inputs and its chunk states
// (not the intra-chunk products autograd would save).
//
// Per (b, head, chunk) of c steps, with l the chunk's inclusive cumulative
// sum of dt·A, L = l_{c−1}, E[t,s] = exp(l_t − l_s) for s <= t (else 0),
// H the state entering the chunk (saved by the forward) and G the gradient
// of the state leaving it (dh_final, or 0, for the last chunk):
//   W = (C·Bᵀ) ∘ E ∘ dt_s,  P = dy·xᵀ,  Q = P ∘ E ∘ dt_s,  Z = P ∘ (C·Bᵀ) ∘ E,
//   w_s = exp(L − l_s)·dt_s
//   dx  = Wᵀ·dy + w ∘ (B·Gᵀ)
//   dC  = Σ_heads Q·B + exp(l) ∘ (dy·H)
//   dB  = Σ_heads Qᵀ·C + w ∘ (x·G)
//   dl_t = Σ_s Z[t,s]·dt_s − dt_t·Σ_u Z[u,t] + exp(l_t)·(dy·H)_t·C_t − R_t
//          (+ Σ_s R_s + exp(L)·⟨G, H⟩ at the last step), R_s = w_s·(x·G)_s·B_s
//   ddt_u = Σ_t Z[t,u] + exp(L − l_u)·(x·G)_u·B_u + A·Σ_{t≥u} dl_t
//   dA    = Σ_u dt_u·Σ_{t≥u} dl_t
//   and the previous chunk's G = exp(L)·G + Σ_t exp(l_t)·dy_t ⊗ C_t.
// (kernels/mamba_scan/ref.py: `ssd_scan_bwd_ref`, the same pass in torch.)
// exp(l_t − l_s) is formed only for s <= t: for s > t it may be inf, and a
// product with a 0/1 mask would give NaN.
//
// Three kernels, the forward's three passes run backwards:
// (i)   ssd_bwd_dstates: in parallel over (b, chunk, heads), the chunk's
//       D_k = Σ_t exp(l_t)·dy_t ⊗ C_t (hd x ds) into a float32 scratch of
//       the states' shape; the forward's `ssd_states` with dy for x, C for
//       B and exp(l_t) for exp(L − l_s)·dt_s.
// (ii)  ssd_bwd_state_pass: per (b, head), over the chunks in reverse, in
//       parallel over the hd·ds elements, G_{k−1} = exp(L_k)·G_k + D_k in
//       float32, seeded by dh_final or 0, writing G_k over D_k.
// (iii) ssd_bwd_chunk: in parallel over (b, chunk, group of up to 32
//       heads), everything else. A block stages B and C once, and per head
//       x, dy, H, G, dt and l. Warp w owns the rows of steps [16 w, 16 w +
//       16): as s it forms, for each 8 columns of t >= s, the tiles x·dyᵀ
//       (Pᵀ) and B·Cᵀ on the tensor core, then W, Qᵀ and Z in registers,
//       and multiplies W by dy (into dx) and Qᵀ by C (into dB); as t it
//       forms P = dy·xᵀ for s <= t and multiplies Q by B (into dC). The
//       accumulator tiles feed the next product without shared memory: a
//       sum fragment holds columns (2q, 2q + 1) where an A fragment wants
//       (q, q + 4), so those products take their depth in that order, and
//       their B fragments read rows (2q, 2q + 1) to match. Z's column sums
//       stay in the warp; its row sums go through shared memory, one
//       partial a warp, added in warp order. Then B·Gᵀ, x·G and dy·H, and a
//       block reduction of ⟨G, H⟩. One warp takes the head's dl, its
//       reverse cumulative sum, ddt and dA's partial while the others load
//       the next head. dB and dC are summed over the block's heads in
//       registers and written once, as partials the wrapper adds over the
//       head groups (no atomics: two calls give the same bits).
// Products run on the tensor cores as 3xTF32 `mma.sync` m16n8k8 (each
// operand split hi = a truncated to TF32, lo = a − hi; sm90::split_tf32,
// mma_3xtf32), each k-step's product added to a float32 sum outside the
// tensor core (which truncates its own sums). One TF32 rounding of W or P
// would miss the float32 gate (tests/test_torch_ssd_emulation.py).
// exp as ex2.approx of the argument times log2 e (2 ulp, inside the gate's
// 8·u32·max|l|).
//
// What bounds it on this card: a (b, chunk, head) does c²·hd/2 multiply-
// adds for each of Pᵀ, P and Wᵀ·dy, c²·ds/2 for each of B·Cᵀ, Qᵀ·C and Q·B,
// 3·c·hd·ds for the products with G and H and c·hd·ds for D_k: at zamba2's
// widths ~2.5 times the forward's operations, and the bytes of x, dy, dx,
// the states H and G twice, B, C, dt; 3xTF32 on the tensor cores keeps the
// operations near the bytes' time. Staged arrays have rows of 64 + 4
// floats: every fragment load is free of bank conflicts. A block of (iii)
// holds ~183 KB of shared memory, one a multiprocessor, one buffer a head's
// operands (no room for two); its loads are 16-byte cp.async where the
// rows are whole 16-byte chunks, else synchronous.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kMaxChunk = 128;  // mamba_scan.cu's, and l's row length
constexpr int kWidth = 64;      // hd and ds, padded
constexpr int kLd = kWidth + 4; // staged rows: conflict-free fragments
constexpr int kThreads = 256;   // eight warps
constexpr int kStateThreads = 256;
constexpr int kAhead = 8;       // chunks the state pass loads ahead
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_q() { return threadIdx.x & 3; }
__device__ __forceinline__ float ex(float v) {
  return sm90::exp2_approx(v * kLog2e);
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_a(const float (&v)[4], FragA& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) sm90::split_tf32(v[i], f.hi[i], f.lo[i]);
}
__device__ __forceinline__ void split_b(float v0, float v1, FragB& f) {
  sm90::split_tf32(v0, f.hi[0], f.lo[0]);
  sm90::split_tf32(v1, f.hi[1], f.lo[1]);
}

// A (16 x 8) at (r0, k0) of a row-major staged array: (r, k) at m[r·kLd + k]
__device__ __forceinline__ void a_rows(const float* m, int r0, int k0,
                                       FragA& f) {
  const int g = lane_g(), q = lane_q();
  const float* p0 = m + (r0 + g) * kLd + k0;
  const float* p1 = p0 + 8 * kLd;
  const float v[4] = {p0[q], p1[q], p0[q + 4], p1[q + 4]};
  split_a(v, f);
}

// A (16 x 8) from a sum fragment (columns 2q, 2q + 1 of rows g, g + 8),
// the depth taken in the order (2q → q, 2q + 1 → q + 4)
__device__ __forceinline__ void a_from_sums(const float (&d)[4], FragA& f) {
  const float v[4] = {d[0], d[2], d[1], d[3]};
  split_a(v, f);
}

// B (8 x 8) at (k0, n0), element (k, n) at m[n·kLd + k] (read along rows)
__device__ __forceinline__ void b_rows(const float* m, int k0, int n0,
                                       FragB& f) {
  const float* p = m + (n0 + lane_g()) * kLd + k0 + lane_q();
  split_b(p[0], p[4], f);
}

// B (8 x 8) at (k0, n0), element (k, n) at m[k·kLd + n] (down columns)
__device__ __forceinline__ void b_cols(const float* m, int k0, int n0,
                                       FragB& f) {
  const float* p = m + (k0 + lane_q()) * kLd + n0 + lane_g();
  split_b(p[0], p[4 * kLd], f);
}

// b_cols with the depth in a_from_sums' order: rows k0 + 2q and k0 + 2q + 1
__device__ __forceinline__ void b_cols_paired(const float* m, int k0, int n0,
                                              FragB& f) {
  const float* p = m + (k0 + 2 * lane_q()) * kLd + n0 + lane_g();
  split_b(p[0], p[kLd], f);
}

// d = a·b, one k-step, added to `sum` in float32 outside the tensor core
__device__ __forceinline__ void mma_add(float (&sum)[4], const FragA& a,
                                        const FragB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  sm90::mma_3xtf32(d, a.hi, a.lo, b.hi[0], b.hi[1], b.lo[0], b.lo[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) sum[e] += d[e];
}

// Rows [0, R) x columns [0, 64) of a (rows, width) slice with row stride
// `stride` into s[r·kLd + c], zero past (rows, width): 16-byte cp.async
// (kAsync: width a multiple of 4, g and stride 16-byte aligned) or loads.
// The caller commits and waits.
template <int R, bool kAsync>
__device__ __forceinline__ void stage(float* __restrict__ s,
                                      const float* __restrict__ g,
                                      long long stride, int rows, int width) {
  if constexpr (kAsync) {
    for (int i = threadIdx.x; i < R * (kWidth / 4); i += kThreads) {
      const int r = i / (kWidth / 4), c = (i % (kWidth / 4)) * 4;
      const bool in = r < rows && c < width;
      sm90::cp_async16(s + r * kLd + c, in ? g + r * stride + c : g,
                       in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * kWidth; i += kThreads) {
      const int r = i / kWidth, c = i % kWidth;
      s[r * kLd + c] = (r < rows && c < width) ? g[r * stride + c] : 0.f;
    }
  }
}

template <bool kAsync>
__device__ __forceinline__ void landed() {
  if constexpr (kAsync) {
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
  }
  __syncthreads();
}

// ---- (i) the chunks' D_k ----------------------------------------------------
constexpr int kDstatesSmem = (2 * kMaxChunk * kLd + kMaxChunk) * 4;

template <bool kAsync>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstates(const float* __restrict__ dy, const float* __restrict__ Cc,
                const float* __restrict__ l, float* __restrict__ dstates,
                int S, int nh, int hd, int ds, int chunk, int NC, int hpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  float* dys = cs + kMaxChunk * kLd;
  float* el = dys + kMaxChunk * kLd;  // exp(l_t)

  const int k = blockIdx.x, b = blockIdx.z;
  const int c0 = k * chunk, L = min(chunk, S - c0);
  const int kend = (L + 7) / 8 * 8;
  const long long row0 = static_cast<long long>(b) * S + c0;
  const long long xstride = static_cast<long long>(nh) * hd;
  const int warp = threadIdx.x >> 5, g = lane_g(), q = lane_q();
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int head_lo = static_cast<int>(blockIdx.y) * hpb;
  const int head_hi = min(nh, head_lo + hpb);
  stage<kMaxChunk, kAsync>(cs, Cc + row0 * ds, ds, L, ds);

  for (int head = head_lo; head < head_hi; ++head) {
    const long long bhk = (static_cast<long long>(b) * nh + head) * NC + k;
    stage<kMaxChunk, kAsync>(dys, dy + row0 * xstride + head * hd, xstride,
                             L, hd);
    if (threadIdx.x < kMaxChunk)
      el[threadIdx.x] = ex(l[bhk * kMaxChunk + threadIdx.x]);
    landed<kAsync>();
    // D[p][n] = Σ_t (exp(l_t)·dy_t[p])·C_t[n]: rows p of this warp, 4
    // n-tiles of 8
    float acc[4][4] = {};
    for (int kk = 0; kk < kend; kk += 8) {
      const float* p = dys + (kk + q) * kLd + m0 + g;
      const float e0 = el[kk + q], e1 = el[kk + q + 4];
      const float v[4] = {p[0] * e0, p[8] * e0, p[4 * kLd] * e1,
                          p[4 * kLd + 8] * e1};
      FragA a;
      split_a(v, a);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bf;
        b_cols(cs, kk, n0 + 8 * j, bf);
        mma_add(acc[j], a, bf);
      }
    }
    float* out = dstates + bhk * hd * ds;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + g + (e >> 1) * 8, n = n0 + 8 * j + 2 * q + (e & 1);
        if (r < hd && n < ds) out[r * ds + n] = acc[j][e];
      }
    __syncthreads();  // dys and el are free for the next head
  }
}

// ---- (ii) the gradients of the chunk states, in reverse ---------------------
// kVec consecutive elements a thread (float4 where hd·ds is a multiple of
// 4), loads kAhead chunks ahead of the stores. A chunk's decay is
// exp(L), L the last of its l (padded steps add 0).
template <int kVec>
__global__ void __launch_bounds__(kStateThreads)
ssd_bwd_state_pass(float* __restrict__ grads, const float* __restrict__ l,
                   const float* __restrict__ dh_final, int nh, int NC,
                   int hdds) {
  using V = std::conditional_t<kVec == 4, float4, float>;
  const int e = (blockIdx.x * kStateThreads + threadIdx.x) * kVec;
  if (e >= hdds) return;
  const long long bh = static_cast<long long>(blockIdx.z) * nh + blockIdx.y;
  V* s = reinterpret_cast<V*>(grads + bh * NC * hdds + e);
  const long long step = hdds / kVec;  // one chunk, in V
  const float* l_end = l + bh * NC * kMaxChunk + kMaxChunk - 1;
  float gv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    gv[i] = dh_final != nullptr ? dh_final[bh * hdds + e + i] : 0.f;
  V sv[kAhead];
  float av[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int k = NC - 1 - j;
    if (k >= 0) {
      sv[j] = s[k * step];
      av[j] = ex(l_end[k * kMaxChunk]);
    }
  }
  for (int j0 = 0; j0 < NC; j0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int k = NC - 1 - (j0 + j);
      if (k >= 0) {
        const V cur = sv[j];
        const float ak = av[j];
        if (k - kAhead >= 0) {  // load ahead, before this chunk's store
          sv[j] = s[(k - kAhead) * step];
          av[j] = ex(l_end[(k - kAhead) * kMaxChunk]);
        }
        if constexpr (kVec == 4) {
          s[k * step] = make_float4(gv[0], gv[1], gv[2], gv[3]);  // G_k
          gv[0] = ak * gv[0] + cur.x;
          gv[1] = ak * gv[1] + cur.y;
          gv[2] = ak * gv[2] + cur.z;
          gv[3] = ak * gv[3] + cur.w;
        } else {
          s[k * step] = gv[0];  // G_k, the gradient of the state leaving k
          gv[0] = ak * gv[0] + cur;
        }
      }
    }
  }
}

// ---- (iii) everything else ---------------------------------------------------
struct ChunkSmem {
  static constexpr int kRows = kMaxChunk * kLd;  // x, dy, B, C
  static constexpr int kState = kWidth * kLd;    // H, G
  // per head, two buffers (the finishing warp reads one while the others
  // fill the next): dt, l, Σ_t Z (colz), (x·G)·B (xgb), (dy·H)·C (dyhc),
  // the 8 warps' row sums of Z ∘ dt (rowz) and ⟨G, H⟩ partials (gh)
  static constexpr int kPerHead = 5 * kMaxChunk + 8 * kMaxChunk + 8;
  static constexpr int kFloats = 4 * kRows + 2 * kState + 2 * kPerHead;
  static constexpr int kBytes = kFloats * 4;
};

struct HeadBufs {
  float *dt, *l, *colz, *xgb, *dyhc, *rowz, *gh;
  __device__ HeadBufs(float* base) {
    dt = base;
    l = dt + kMaxChunk;
    colz = l + kMaxChunk;
    xgb = colz + kMaxChunk;
    dyhc = xgb + kMaxChunk;
    rowz = dyhc + kMaxChunk;  // [t][warp]
    gh = rowz + 8 * kMaxChunk;
  }
};

template <bool kAsync>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bc,
              const float* __restrict__ Cc, const float* __restrict__ dy,
              const float* __restrict__ states, const float* __restrict__ l,
              const float* __restrict__ grads, float* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ dB_part,
              float* __restrict__ dC_part, float* __restrict__ dA_part,
              int B, int S, int nh, int hd, int ds, int chunk, int NC,
              int hpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* dys = xs + ChunkSmem::kRows;
  float* bs = dys + ChunkSmem::kRows;
  float* cs = bs + ChunkSmem::kRows;
  float* hs = cs + ChunkSmem::kRows;
  float* gs = hs + ChunkSmem::kState;
  float* per_head = gs + ChunkSmem::kState;

  const int k = blockIdx.x, b = blockIdx.z;
  const int c0 = k * chunk, L = min(chunk, S - c0);
  const int ntb = (L + 7) / 8;      // 8-step column blocks
  const int kd = (hd + 7) / 8 * 8;  // depths, padded to a k-step
  const int kn = (ds + 7) / 8 * 8;
  const long long row0 = static_cast<long long>(b) * S + c0;
  const long long xstride = static_cast<long long>(nh) * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane_g(), q = lane_q();
  const int r0 = 16 * warp;  // this warp's steps, as s and as t
  const bool rows_in = r0 < L;
  const int grp = blockIdx.y;
  const int head_lo = grp * hpb, head_hi = min(nh, head_lo + hpb);

  stage<kMaxChunk, kAsync>(bs, Bc + row0 * ds, ds, L, ds);
  stage<kMaxChunk, kAsync>(cs, Cc + row0 * ds, ds, L, ds);

  float dB[8][4] = {}, dC[8][4] = {};  // summed over the block's heads
  for (int head = head_lo; head < head_hi; ++head) {
    const int cur = (head - head_lo) & 1;
    HeadBufs hb(per_head + cur * ChunkSmem::kPerHead);
    const long long bhk = (static_cast<long long>(b) * nh + head) * NC + k;
    stage<kMaxChunk, kAsync>(xs, x + row0 * xstride + head * hd, xstride, L,
                             hd);
    stage<kMaxChunk, kAsync>(dys, dy + row0 * xstride + head * hd, xstride,
                             L, hd);
    stage<kWidth, kAsync>(hs, states + bhk * hd * ds, ds, hd, ds);
    stage<kWidth, kAsync>(gs, grads + bhk * hd * ds, ds, hd, ds);
    if (threadIdx.x < kMaxChunk) {
      const int t = threadIdx.x;
      hb.dt[t] = t < L ? dt[(row0 + t) * nh + head] : 0.f;
      hb.l[t] = l[bhk * kMaxChunk + t];
    }
    landed<kAsync>();

    const float l_end = hb.l[kMaxChunk - 1];
    float dx_acc[8][4] = {};
    float colz[2] = {0.f, 0.f}, xgb[2] = {0.f, 0.f}, dyhc[2] = {0.f, 0.f};
    // this lane's rows r0 + g and r0 + g + 8: l, dt, exp(L − l)·dt
    const float l_r[2] = {hb.l[r0 + g], hb.l[r0 + g + 8]};
    const float dt_r[2] = {hb.dt[r0 + g], hb.dt[r0 + g + 8]};
    const float w_r[2] = {ex(l_end - l_r[0]) * dt_r[0],
                          ex(l_end - l_r[1]) * dt_r[1]};
    if (rows_in) {
      // as s: for each 8 columns of t >= s
      for (int tb = 2 * warp; tb < ntb; ++tb) {
        const int t0 = 8 * tb;
        float pt[4] = {}, cbt[4] = {};
        for (int kk = 0; kk < kd; kk += 8) {  // Pᵀ[s][t] = x_s·dy_t
          FragA a;
          FragB bf;
          a_rows(xs, r0, kk, a);
          b_rows(dys, kk, t0, bf);
          mma_add(pt, a, bf);
        }
        for (int kk = 0; kk < kn; kk += 8) {  // (B·Cᵀ)[s][t] = B_s·C_t
          FragA a;
          FragB bf;
          a_rows(bs, r0, kk, a);
          b_rows(cs, kk, t0, bf);
          mma_add(cbt, a, bf);
        }
        float w[4], qt[4], rz[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, s = r0 + g + 8 * h, t = t0 + 2 * q + (e & 1);
          const float E = s <= t ? ex(hb.l[t] - l_r[h]) : 0.f;
          w[e] = cbt[e] * E * dt_r[h];
          qt[e] = pt[e] * E * dt_r[h];
          const float z = pt[e] * cbt[e] * E;
          colz[h] += z;
          rz[e & 1] += z * dt_r[h];
        }
        // Σ over the warp's 16 rows of Z ∘ dt_s, a partial of row t's sum
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            rz[j] += __shfl_xor_sync(0xffffffffu, rz[j], off);
        if (g == 0) {
          hb.rowz[(t0 + 2 * q) * 8 + warp] = rz[0];
          hb.rowz[(t0 + 2 * q + 1) * 8 + warp] = rz[1];
        }
        FragA aw, aq;
        a_from_sums(w, aw);
        a_from_sums(qt, aq);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (8 * nt < hd) {  // dx_s += W[t][s]·dy_t
            FragB bf;
            b_cols_paired(dys, t0, 8 * nt, bf);
            mma_add(dx_acc[nt], aw, bf);
          }
          if (8 * nt < ds) {  // dB_s += Q[t][s]·C_t
            FragB bf;
            b_cols_paired(cs, t0, 8 * nt, bf);
            mma_add(dB[nt], aq, bf);
          }
        }
      }
      // as t: for each 8 columns of s <= t, dC_t += Q[t][s]·B_s
      for (int sb = 0; sb < min(2 * warp + 2, ntb); ++sb) {
        const int s0 = 8 * sb;
        float p[4] = {};
        for (int kk = 0; kk < kd; kk += 8) {  // P[t][s] = dy_t·x_s
          FragA a;
          FragB bf;
          a_rows(dys, r0, kk, a);
          b_rows(xs, kk, s0, bf);
          mma_add(p, a, bf);
        }
        float qv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, t = r0 + g + 8 * h, s = s0 + 2 * q + (e & 1);
          const float E = s <= t ? ex(l_r[h] - hb.l[s]) : 0.f;
          qv[e] = p[e] * E * hb.dt[s];
        }
        FragA aq;
        a_from_sums(qv, aq);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (8 * nt < ds) {
            FragB bf;
            b_cols_paired(bs, s0, 8 * nt, bf);
            mma_add(dC[nt], aq, bf);
          }
        }
      }
      // the products with the states: dx += w ∘ (B·Gᵀ); x·G into dB and
      // (x·G)·B; dy·H into dC and (dy·H)·C
      const float el_r[2] = {ex(l_r[0]), ex(l_r[1])};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (8 * nt < hd) {
          float bg[4] = {};
          for (int kk = 0; kk < kn; kk += 8) {
            FragA a;
            FragB bf;
            a_rows(bs, r0, kk, a);
            b_rows(gs, kk, 8 * nt, bf);
            mma_add(bg, a, bf);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) dx_acc[nt][e] += w_r[e >> 1] * bg[e];
        }
        if (8 * nt < ds) {
          float xg[4] = {}, yh[4] = {};
          for (int kk = 0; kk < kd; kk += 8) {
            FragA a;
            FragB bf;
            b_cols(gs, kk, 8 * nt, bf);
            a_rows(xs, r0, kk, a);
            mma_add(xg, a, bf);
            b_cols(hs, kk, 8 * nt, bf);
            a_rows(dys, r0, kk, a);
            mma_add(yh, a, bf);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, r = r0 + g + 8 * h;
            const int n = 8 * nt + 2 * q + (e & 1);
            dB[nt][e] += w_r[h] * xg[e];
            dC[nt][e] += el_r[h] * yh[e];
            xgb[h] += xg[e] * bs[r * kLd + n];
            dyhc[h] += yh[e] * cs[r * kLd + n];
          }
        }
      }
      // the quad's sums of its rows
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          colz[h] += __shfl_xor_sync(0xffffffffu, colz[h], off);
          xgb[h] += __shfl_xor_sync(0xffffffffu, xgb[h], off);
          dyhc[h] += __shfl_xor_sync(0xffffffffu, dyhc[h], off);
        }
      if (q == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hb.colz[r0 + g + 8 * h] = colz[h];
          hb.xgb[r0 + g + 8 * h] = xgb[h];
          hb.dyhc[r0 + g + 8 * h] = dyhc[h];
        }
      }
      // dx of this head's rows
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = r0 + g + 8 * (e >> 1), p = 8 * nt + 2 * q + (e & 1);
          if (s < L && p < hd)
            dx[((row0 + s) * nh + head) * hd + p] = dx_acc[nt][e];
        }
    }
    {  // ⟨G, H⟩: each thread 16 of the 64 x 64 (zero-padded) elements
      float v = 0.f;
      for (int i = threadIdx.x; i < kWidth * kWidth; i += kThreads) {
        const int at = (i / kWidth) * kLd + i % kWidth;
        v += gs[at] * hs[at];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) hb.gh[warp] = v;
    }
    __syncthreads();  // the head's sums are in; x, dy, H, G are free

    if (warp == 0) {  // dl, its reverse cumulative sum, ddt and dA
      float gh = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < 8; ++w8) gh += hb.gh[w8];
      float dl[4], r_sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = 4 * lane + i;
        float row = 0.f;
        for (int a = 0; a <= u / 16; ++a) row += hb.rowz[u * 8 + a];
        const float R = ex(l_end - hb.l[u]) * hb.dt[u] * hb.xgb[u];
        dl[i] = u < L ? row - hb.dt[u] * hb.colz[u] +
                            ex(hb.l[u]) * hb.dyhc[u] - R
                      : 0.f;
        r_sum += u < L ? R : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        r_sum += __shfl_xor_sync(0xffffffffu, r_sum, off);
      const float tail = r_sum + ex(l_end) * gh;  // the last step's term
      float above = dl[0] + dl[1] + dl[2] + dl[3];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {  // Σ of this lane and above
        const float v = __shfl_down_sync(0xffffffffu, above, off);
        if (lane + off < 32) above += v;
      }
      const float beyond = __shfl_down_sync(0xffffffffu, above, 1);
      float run = (lane < 31 ? beyond : 0.f) + tail;
      const float a_head = A[head];
      float da = 0.f;
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        const int u = 4 * lane + i;
        run += dl[i];
        if (u < L) {
          ddt[(row0 + u) * nh + head] =
              hb.colz[u] + ex(l_end - hb.l[u]) * hb.xgb[u] + a_head * run;
          da += hb.dt[u] * run;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, off);
      if (lane == 0)
        dA_part[(static_cast<long long>(b) * NC + k) * nh + head] = da;
    }
  }
  // dB and dC of the block's heads, this warp's rows
  if (rows_in) {
    float* dbo = dB_part + ((static_cast<long long>(grp) * B) * S + row0) * ds;
    float* dco = dC_part + ((static_cast<long long>(grp) * B) * S + row0) * ds;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), n = 8 * nt + 2 * q + (e & 1);
        if (r < L && n < ds) {
          dbo[r * ds + n] = dB[nt][e];
          dco[r * ds + n] = dC[nt][e];
        }
      }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// (ii) over the chunks' D_k in `grads`, seeded by dh_final (or 0).
cudaError_t state_pass(const float* l, const float* dh_final, int B, int nh,
                       int NC, int hdds, float* grads, cudaStream_t stream) {
  if (hdds % 4 == 0 && aligned16(grads) && aligned16(dh_final)) {
    ssd_bwd_state_pass<4>
        <<<dim3((hdds / 4 + kStateThreads - 1) / kStateThreads, nh, B),
           kStateThreads, 0, stream>>>(grads, l, dh_final, nh, NC, hdds);
  } else {
    ssd_bwd_state_pass<1>
        <<<dim3((hdds + kStateThreads - 1) / kStateThreads, nh, B),
           kStateThreads, 0, stream>>>(grads, l, dh_final, nh, NC, hdds);
  }
  return cudaGetLastError();
}

template <bool kAsync>
cudaError_t run(const float* x, const float* dt, const float* A,
                const float* Bc, const float* Cc, const float* dy,
                const float* dh_final, const float* states, const float* l,
                int B, int S, int nh, int hd, int ds, int chunk,
                int groups, float* grads, float* dx, float* ddt,
                float* dB_part, float* dC_part, float* dA_part,
                cudaStream_t stream) {
  const int NC = (S + chunk - 1) / chunk;
  const int hpb = (nh + groups - 1) / groups;  // a block's heads
  const dim3 grid(NC, groups, B);

  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_dstates<kAsync>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDstatesSmem);
  if (err != cudaSuccess) return err;
  ssd_bwd_dstates<kAsync><<<grid, kThreads, kDstatesSmem, stream>>>(
      dy, Cc, l, grads, S, nh, hd, ds, chunk, NC, hpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = state_pass(l, dh_final, B, nh, NC, hd * ds, grads, stream);
  if (err != cudaSuccess) return err;

  constexpr int bytes = ChunkSmem::kBytes;
  err = cudaFuncSetAttribute(ssd_bwd_chunk<kAsync>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk<kAsync><<<grid, kThreads, bytes, stream>>>(
      x, dt, A, Bc, Cc, dy, states, l, grads, dx, ddt, dB_part, dC_part,
      dA_part, B, S, nh, hd, ds, chunk, NC, hpb);
  return cudaGetLastError();
}

}  // namespace

// The state pass alone, for mamba_scan_bwd_sm90.cu's route: grads (B, nh,
// NC, hd·ds) holds each chunk's D_k and gets G_k; l the forward's (B, nh,
// NC, 128); dh_final (B, nh, hd·ds) or null.
extern "C" int tdorch_ssd_bwd_state_pass(const float* l,
                                         const float* dh_final, int B,
                                         int nh, int NC, int hdds,
                                         float* grads, cudaStream_t stream) {
  return static_cast<int>(
      state_pass(l, dh_final, B, nh, NC, hdds, grads, stream));
}

// x, dy: (B, S, nh, hd); Bc, Cc: (B, S, ds); dt: (B, S, nh); A: (nh,);
// all float32 and contiguous, 1 <= hd, ds <= 64, 1 <= chunk <= 128, B, nh
// <= 65535. dh_final: null (zero) or (B, nh, hd, ds). states and l: the
// forward's scratch (tdorch_ssd_scan), (B, nh, NC, hd, ds) and (B, nh, NC,
// 128), NC = ceil(S / chunk). grads: (B, nh, NC, hd, ds) float32 scratch.
// groups: the blocks of heads, each taking ceil(nh / groups) of them,
// none empty. Writes dx (B, S, nh, hd), ddt (B, S, nh), dB_part
// and dC_part (groups, B, S, ds) — one partial a group of heads — and
// dA_part (B, NC, nh).
extern "C" int tdorch_ssd_scan_bwd(
    int device, const float* x, const float* dt, const float* A,
    const float* Bc, const float* Cc, const float* dy, const float* dh_final,
    const float* states, const float* l, int B, int S, int nh, int hd,
    int ds, int chunk, int groups, float* grads, float* dx, float* ddt,
    float* dB_part, float* dC_part, float* dA_part, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || nh == 0 || hd == 0) return 0;
  if (hd > kWidth || ds > kWidth || ds < 1 || chunk < 1 ||
      chunk > kMaxChunk || B > 65535 || nh > 65535 || groups < 1 ||
      groups > nh || (groups - 1) * ((nh + groups - 1) / groups) >= nh)
    return static_cast<int>(cudaErrorInvalidValue);  // or a group empty
  const bool async = hd % 4 == 0 && ds % 4 == 0 && aligned16(x) &&
                     aligned16(dy) && aligned16(Bc) && aligned16(Cc) &&
                     aligned16(states) && aligned16(grads);
  err = async ? run<true>(x, dt, A, Bc, Cc, dy, dh_final, states, l, B, S,
                          nh, hd, ds, chunk, groups, grads, dx, ddt,
                          dB_part, dC_part, dA_part, stream)
              : run<false>(x, dt, A, Bc, Cc, dy, dh_final, states, l, B, S,
                           nh, hd, ds, chunk, groups, grads, dx, ddt,
                           dB_part, dC_part, dA_part, stream);
  return static_cast<int>(err);
}
