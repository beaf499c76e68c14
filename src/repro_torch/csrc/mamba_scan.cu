// Mamba2 SSD chunk scan (one B/C group, without the D·x skip term), for
// Hopper (sm_90a): SIMT float32.
//
// Replaces the TPU kernel `ssd_scan` in
// src/repro/kernels/mamba_scan/kernel.py:58 (`_ssd_kernel`), whose grid
// (B, nh, S / chunk) walked the chunks of a (batch row, head) in order on
// one core, carrying the (hd x ds) state in VMEM scratch.
//
// For each (b, head) with A = A[head] and, within a chunk, l the inclusive
// cumulative sum of dt·A:
//   y_t = Σ_{s≤t} (C_t·B_s) exp(l_t − l_s) dt_s x_s + exp(l_t) h_prev·C_t
//   h   = exp(l_end) h_prev + Σ_s exp(l_end − l_s) dt_s x_s ⊗ B_s
// x, B, C float32 or bfloat16 (one type), dt and A float32; float32
// arithmetic; y in x's type. exp(l_t − l_s) can overflow for s > t when
// |dt·A| is large, so it is computed only for s <= t (the TPU kernel
// discards it with jnp.where, kernel.py:40); a product with a 0/1 mask
// would give inf · 0 = NaN.
//
// What bounds it on this card: operations. A chunk of c steps does
// 2·c²·ds (C·Bᵀ) + 2·c²·hd (M·x) + 2·c·ds·hd (C·h) + 2·c·hd·ds (the state)
// FLOPs for c·(hd + 2·ds + 1) words read: at zamba2's widths (c 128,
// hd = ds = 64) 6.29 MFLOP for 33 KB, ~190 FLOPs per byte, and the heads
// recompute C·Bᵀ, which they share (as the TPU kernel does; left for a
// later change). So the design keeps every operand of a chunk in shared
// memory and the arithmetic in register blocks:
// - One block of 256 threads per (batch row, head) loops over the chunks
//   itself, in place of the TPU grid's sequential chunk axis; the state h
//   never leaves shared memory.
// - Per chunk: x, B, C and dt are staged (zero-padded to 128 steps and to
//   the padded widths HDP, DSP, so the loops have fixed trip counts); a
//   warp-shuffle scan gives l; then three register-blocked products on a
//   16 x 16 thread grid: M = tril(C·Bᵀ ∘ decay ∘ dt) (8 x 8 a thread),
//   y = M·x + exp(l)·C·hᵀ, and the state update h = exp(l_end)·h +
//   (w ∘ x)ᵀ·B with w_s = exp(l_end − l_s)·dt_s.
// - Padded steps carry dt = 0, so l holds at l_end past the chunk: the
//   padded rows' decays stay <= 1 and their terms are 0.
// - Shared memory, at chunk 128 and hd = ds = 64: x 32 KB, B and C 33 KB
//   each, M 66 KB, h 17 KB, l/exp(l)/dt/w 2 KB, ~184 KB: dynamic, opted in
//   above 48 KB. That leaves one block an SM, and B·nh = 128 blocks at
//   zamba2's batch of 2 fill 128 of 132 SMs.
// - The chunk the kernel runs is at most 128 steps. The value of the scan
//   does not depend on the chunk, so the wrapper runs a larger requested
//   chunk as its largest divisor <= 128 (kernels/mamba_scan/ops.py).
//
// Later work, not done here: C·Bᵀ once per (b, chunk) for all heads;
// chunk-parallel state passing (B·nh blocks barely fill the card); tensor
// cores for the three products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kMaxChunk = 128;
constexpr int kRowsPerThread = kMaxChunk / 16;  // 8

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16(v);
}

template <int HDP, int DSP>
constexpr int smem_floats() {
  return kMaxChunk * HDP             // x: [128][HDP]
         + 2 * kMaxChunk * (DSP + 1)  // B, C: [128][DSP + 1]
         + kMaxChunk * (kMaxChunk + 1)  // M: [128][129]
         + HDP * (DSP + 1)           // h: [HDP][DSP + 1]
         + 4 * kMaxChunk;            // l, exp(l), dt, w
}

template <int HDP, int DSP, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan(const T* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ A, const T* __restrict__ Bc,
         const T* __restrict__ Cc, T* __restrict__ y, int S, int nh, int hd,
         int ds, int chunk) {
  constexpr int kB = DSP + 1;       // row stride of B, C and h
  constexpr int kM = kMaxChunk + 1;  // row stride of M
  constexpr int NH = HDP / 16, NS = DSP / 16;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* bs = xs + kMaxChunk * HDP;
  float* cs = bs + kMaxChunk * kB;
  float* ms = cs + kMaxChunk * kB;
  float* hs = ms + kMaxChunk * kM;
  float* ls = hs + HDP * kB;
  float* els = ls + kMaxChunk;
  float* dts = els + kMaxChunk;
  float* ws = dts + kMaxChunk;
  __shared__ float warp_tot[kThreads / 32];

  const int head = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float a_head = A[head];
  for (int i = threadIdx.x; i < HDP * kB; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int L = min(chunk, S - c0);
    const long long row0 = static_cast<long long>(b) * S + c0;
    // stage the chunk; every padded element is 0
    for (int i = threadIdx.x; i < kMaxChunk * HDP; i += kThreads) {
      const int s = i / HDP, p = i % HDP;
      xs[i] = (s < L && p < hd)
                  ? load(x, ((row0 + s) * nh + head) * hd + p) : 0.f;
    }
    for (int i = threadIdx.x; i < kMaxChunk * DSP; i += kThreads) {
      const int s = i / DSP, n = i % DSP;
      const bool in = s < L && n < ds;
      bs[s * kB + n] = in ? load(Bc, (row0 + s) * ds + n) : 0.f;
      cs[s * kB + n] = in ? load(Cc, (row0 + s) * ds + n) : 0.f;
    }
    // l = inclusive scan of dt·A over the chunk (4 warps of 32 steps)
    float step = 0.f;
    if (threadIdx.x < kMaxChunk) {
      const int s = threadIdx.x;
      const float d = s < L ? dt[(row0 + s) * nh + head] : 0.f;
      dts[s] = d;
      step = d * a_head;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, step, off);
        if (lane >= off) step += up;
      }
      if (lane == 31) warp_tot[warp] = step;
    }
    __syncthreads();
    if (threadIdx.x < kMaxChunk) {
      for (int w = 0; w < warp; ++w) step += warp_tot[w];
      ls[threadIdx.x] = step;
    }
    __syncthreads();
    const float l_end = ls[kMaxChunk - 1];  // padded steps add 0
    if (threadIdx.x < kMaxChunk) {
      const int s = threadIdx.x;
      els[s] = expf(ls[s]);
      ws[s] = expf(l_end - ls[s]) * dts[s];
    }

    // M[t][s] = (C_t·B_s) exp(l_t − l_s) dt_s for s <= t, else 0
    {
      float acc[kRowsPerThread][kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < DSP; ++n) {
        float a[kRowsPerThread], bb[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          a[i] = cs[(ty + 16 * i) * kB + n];
          bb[i] = bs[(tx + 16 * i) * kB + n];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j)
            acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int t = ty + 16 * i;
        const float lt = ls[t];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int s = tx + 16 * j;
          ms[t * kM + s] =
              s <= t ? acc[i][j] * expf(lt - ls[s]) * dts[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // y_t = Σ_s M[t][s] x_s + exp(l_t) Σ_n C_t[n] h[:, n]
    {
      float acc[kRowsPerThread][NH];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < NH; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < DSP; ++n) {
        float a[kRowsPerThread], hb[NH];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          a[i] = cs[(ty + 16 * i) * kB + n];
#pragma unroll
        for (int j = 0; j < NH; ++j) hb[j] = hs[(tx + 16 * j) * kB + n];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < NH; ++j) acc[i][j] = fmaf(a[i], hb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float e = els[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NH; ++j) acc[i][j] *= e;
      }
      for (int s = 0; s < L; ++s) {
        float a[kRowsPerThread], xb[NH];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          a[i] = ms[(ty + 16 * i) * kM + s];
#pragma unroll
        for (int j = 0; j < NH; ++j) xb[j] = xs[s * HDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < NH; ++j) acc[i][j] = fmaf(a[i], xb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int t = ty + 16 * i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int p = tx + 16 * j;
          if (p < hd)
            store(y, ((row0 + t) * nh + head) * hd + p, acc[i][j]);
        }
      }
    }
    __syncthreads();  // every reader of h is done

    // h[p][n] = exp(l_end) h[p][n] + Σ_s w_s x_s[p] B_s[n]
    {
      float acc[NH][NS];
#pragma unroll
      for (int i = 0; i < NH; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float w = ws[s];
        float a[NH], bb[NS];
#pragma unroll
        for (int i = 0; i < NH; ++i) a[i] = xs[s * HDP + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < NS; ++j) bb[j] = bs[s * kB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NH; ++i)
#pragma unroll
          for (int j = 0; j < NS; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      const float decay = expf(l_end);
#pragma unroll
      for (int i = 0; i < NH; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          float* h = hs + (ty + 16 * i) * kB + tx + 16 * j;
          *h = decay * *h + acc[i][j];
        }
    }
    __syncthreads();  // the next chunk overwrites the staged operands
  }
}

template <int HDP, int DSP, typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bc, const void* Cc, void* y, int B, int S,
                   int nh, int hd, int ds, int chunk, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HDP, DSP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<HDP, DSP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  ssd_scan<HDP, DSP, T><<<dim3(nh, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), static_cast<T*>(y), S, nh, hd, ds, chunk);
  return cudaGetLastError();
}

int padded(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : 64; }

template <int HDP, typename T>
cudaError_t by_state(const void* x, const float* dt, const float* A,
                     const void* Bc, const void* Cc, void* y, int B, int S,
                     int nh, int hd, int ds, int chunk, cudaStream_t stream) {
  switch (padded(ds)) {
    case 16:
      return launch<HDP, 16, T>(x, dt, A, Bc, Cc, y, B, S, nh, hd, ds, chunk,
                                stream);
    case 32:
      return launch<HDP, 32, T>(x, dt, A, Bc, Cc, y, B, S, nh, hd, ds, chunk,
                                stream);
    default:
      return launch<HDP, 64, T>(x, dt, A, Bc, Cc, y, B, S, nh, hd, ds, chunk,
                                stream);
  }
}

template <typename T>
cudaError_t by_head_dim(const void* x, const float* dt, const float* A,
                        const void* Bc, const void* Cc, void* y, int B, int S,
                        int nh, int hd, int ds, int chunk,
                        cudaStream_t stream) {
  switch (padded(hd)) {
    case 16:
      return by_state<16, T>(x, dt, A, Bc, Cc, y, B, S, nh, hd, ds, chunk,
                             stream);
    case 32:
      return by_state<32, T>(x, dt, A, Bc, Cc, y, B, S, nh, hd, ds, chunk,
                             stream);
    default:
      return by_state<64, T>(x, dt, A, Bc, Cc, y, B, S, nh, hd, ds, chunk,
                             stream);
  }
}

}  // namespace

// x: (B, S, nh, hd) and Bc, Cc: (B, S, ds), float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); dt: (B, S, nh) and A: (nh,) float32; all
// contiguous; 1 <= hd, ds <= 64; 1 <= chunk <= 128. y: (B, S, nh, hd) in
// x's type, fully written.
extern "C" int tdorch_ssd_scan(int device, const void* x, const float* dt,
                               const float* A, const void* Bc,
                               const void* Cc, int B, int S, int nh, int hd,
                               int ds, int chunk, int bf16, void* y,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || nh == 0 || hd == 0) return 0;
  if (hd > 64 || ds > 64 || chunk < 1 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  err = bf16 ? by_head_dim<__nv_bfloat16>(x, dt, A, Bc, Cc, y, B, S, nh, hd,
                                          ds, chunk, stream)
             : by_head_dim<float>(x, dt, A, Bc, Cc, y, B, S, nh, hd, ds,
                                  chunk, stream);
  return static_cast<int>(err);
}
