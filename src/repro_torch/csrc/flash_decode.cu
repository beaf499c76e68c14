// Single-token GQA decode attention over a long KV cache, for Hopper
// (sm_90a): split-K flash-decoding.
//
// Replaces the TPU kernel `flash_decode` in
// src/repro/kernels/flash_decode/kernel.py:60 (`_decode_kernel`), whose
// grid (B, KV, T / block_t) walked the cache tiles in order on one core,
// carrying the online-softmax state (m, l, acc) in VMEM from tile to tile.
//
// out[b, h] = softmax(q[b, h] · K[b, :, h / G]ᵀ · hd^-0.5) · V[b, :, h / G]
// over the T positions of the cache, where positions at or beyond `length`
// get the finite score -2.0e38, as in the TPU kernel: with length <= 0
// every position ties and the result is the mean of V over the cache.
// float32 or bfloat16 q and caches; float32 scores, softmax and sums; the
// output in the inputs' type.
//
// What bounds it on this card: bytes. A decode step reads the whole valid
// prefix of both caches once and does 4 FLOPs per cached element and
// query head of its group (2 for q·k, 2 for p·v): a tinyllama step (G = 8)
// does 2 FLOPs per byte of float32 cache, a zamba2 step (G = 1) 0.25,
// against the card's 20 float32 FLOPs per byte. So the design is about
// streaming the cache at the memory's rate:
// - One block serves every query head of its KV head (up to kGroupMax at
//   a time), so the cache is read once, as the TPU kernel's (G, hd) q
//   block did; one block per query head would read a tinyllama cache 8
//   times.
// - B·KV blocks alone do not fill 132 SMs (zamba2's long_500k decode has
//   B·KV = 32), so T is cut into splits, one block each (the grid's
//   x axis), sized by the wrapper to give some 16 blocks an SM. Each
//   block writes its split's (m, l, acc) per query head; a second launch
//   (`fd_combine`) merges the splits and divides by max(l, 1e-30), as the
//   TPU kernel's last step does (kernel.py:56).
// - Inside a block, each lane loads 4 consecutive elements of a cache
//   row (16 bytes in float32), hd / 4 lanes share a row and a warp reads
//   128 / hd rows at once, kUnroll row groups ahead of the arithmetic;
//   the q·k partial sums meet by xor shuffles within the row's lanes, and
//   each row slot keeps its own (m, l, acc), merged by shuffles and then
//   across warps through shared memory at the end of the split.
// - `length` is read on the device when the caller passes it as a
//   tensor: no host sync. Positions past min(length, T) are not read
//   (their weight exp(-2e38 - m) is exactly 0 in float32), unless
//   length <= 0, where all T are.
//
// Later work, not done here: TMA or cp.async loads into a ring of shared
// memory stages, and fewer exponentials (one rescale per row group).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMasked = -2.0e38f;  // score of a position >= length
constexpr float kEmpty = -3.0e38f;   // running max of a state with no row
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 2;  // row groups a lane loads before it computes
constexpr int kGroupMax = 8;

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Merge the softmax state (mo, lo, acco) into (m, l, acc).
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float mo, float lo, const float* acco) {
  const float mn = fmaxf(m, mo);
  const float a = expf(m - mn), ao = expf(mo - mn);
  l = l * a + lo * ao;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + acco[e] * ao;
  m = mn;
}

// One block per (split of T, KV head x group of NG query heads, batch row).
// part_ml[(bh * splits + split) * 2 + {0, 1}] = (m, l) and
// part_acc[(bh * splits + split) * HD + d] = acc[d] of query head bh.
template <int HD, int NG, typename T>
__global__ void __launch_bounds__(kThreads)
fd_split(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const long long* __restrict__ len_ptr,
         long long len_val, int Tn, int KV, int G, int split_len,
         float scale, float* __restrict__ part_ml,
         float* __restrict__ part_acc) {
  constexpr int kLanesPerRow = HD / 4;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kStep = kWarps * kUnroll * kRowsPerWarp;
  static_assert(HD % 4 == 0 && 32 % kLanesPerRow == 0, "unsupported hd");
  __shared__ float s_ml[kWarps][NG][2];
  __shared__ float s_acc[kWarps][NG][HD];

  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = (G + NG - 1) / NG;
  const int kv = blockIdx.y / groups, g0 = (blockIdx.y % groups) * NG;
  const int ng = min(NG, G - g0);
  const int H = KV * G, splits = gridDim.x;
  const long long length = len_ptr != nullptr ? *len_ptr : len_val;
  const bool all_masked = length <= 0;
  const int n_valid = all_masked ? Tn
                                 : static_cast<int>(min(length,
                                                        (long long)Tn));
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, n_valid);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / kLanesPerRow, d0 = (lane % kLanesPerRow) * 4;
  const int h0 = kv * G + g0;

  float qr[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g < ng) {
      load4(q + (static_cast<long long>(b) * H + h0 + g) * HD + d0, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[g][e] = 0.f;
    }
  }
  float m[NG], l[NG], acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = kEmpty;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  const long long row_stride = static_cast<long long>(KV) * HD;
  const long long base_off =
      (static_cast<long long>(b) * Tn * KV + kv) * HD + d0;
  for (int base = t_begin + warp * kUnroll * kRowsPerWarp; base < t_end;
       base += kStep) {
    float kr[kUnroll][4], vr[kUnroll][4];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * kRowsPerWarp + slot;
      ok[u] = t < t_end;
      if (ok[u]) {
        load4(k + base_off + t * row_stride, kr[u]);
        load4(v + base_off + t * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float s[kUnroll];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = qr[g][0] * kr[u][0];
#pragma unroll
        for (int e = 1; e < 4; ++e) part = fmaf(qr[g][e], kr[u][e], part);
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u] = !ok[u] ? -INFINITY : all_masked ? kMasked : part * scale;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[u] - mx);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // merge the warp's row slots (lanes kLanesPerRow apart), then the warps
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
      float other[4];
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        other[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      merge<4>(m[g], l[g], acc[g], mo, lo, other);
    }
    if (slot == 0) {
      if (d0 == 0) {
        s_ml[warp][g][0] = m[g];
        s_ml[warp][g][1] = l[g];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float mm = s_ml[0][g][0], ll = s_ml[0][g][1], aa = s_acc[0][g][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      merge<1>(mm, ll, &aa, s_ml[w][g][0], s_ml[w][g][1], &s_acc[w][g][d]);
    const long long row =
        (static_cast<long long>(b) * H + h0 + g) * splits + split;
    part_acc[row * HD + d] = aa;
    if (d == 0) {
      part_ml[row * 2] = mm;
      part_ml[row * 2 + 1] = ll;
    }
  }
}

// One block of HD threads per (batch row, query head): merge the splits.
template <typename T>
__global__ void fd_combine(const float* __restrict__ part_ml,
                           const float* __restrict__ part_acc, int splits,
                           int HD, T* __restrict__ out) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  float mx = kEmpty;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(ml[2 * s] - mx);
    l = fmaf(ml[2 * s + 1], w, l);
    acc = fmaf(part_acc[(bh * splits + s) * HD + d], w, acc);
  }
  store(out + bh * HD + d, acc / fmaxf(l, 1e-30f));
}

template <int HD, int NG, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const long long* len_ptr, long long len_val, int B,
                   int Tn, int KV, int G, int splits, int split_len,
                   float scale, float* part_ml, float* part_acc, void* out,
                   cudaStream_t stream) {
  const dim3 grid(splits, KV * ((G + NG - 1) / NG), B);
  fd_split<HD, NG, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len_ptr, len_val, Tn, KV, G, split_len,
      scale, part_ml, part_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fd_combine<T><<<B * KV * G, HD, 0, stream>>>(part_ml, part_acc, splits,
                                                HD, static_cast<T*>(out));
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const long long* len_ptr, long long len_val, int B,
                     int Tn, int KV, int splits, int split_len, float scale,
                     float* part_ml, float* part_acc, void* out,
                     cudaStream_t stream) {
  // the smallest group width that holds G (G > 8 runs in groups of 8)
  if (G == 1)
    return launch<HD, 1, T>(q, k, v, len_ptr, len_val, B, Tn, KV, G, splits,
                            split_len, scale, part_ml, part_acc, out, stream);
  if (G == 2)
    return launch<HD, 2, T>(q, k, v, len_ptr, len_val, B, Tn, KV, G, splits,
                            split_len, scale, part_ml, part_acc, out, stream);
  if (G <= 4)
    return launch<HD, 4, T>(q, k, v, len_ptr, len_val, B, Tn, KV, G, splits,
                            split_len, scale, part_ml, part_acc, out, stream);
  return launch<HD, kGroupMax, T>(q, k, v, len_ptr, len_val, B, Tn, KV, G,
                                  splits, split_len, scale, part_ml,
                                  part_acc, out, stream);
}

template <typename T>
cudaError_t by_head_dim(int HD, int G, const void* q, const void* k,
                        const void* v, const long long* len_ptr,
                        long long len_val, int B, int Tn, int KV, int splits,
                        int split_len, float scale, float* part_ml,
                        float* part_acc, void* out, cudaStream_t stream) {
  switch (HD) {
    case 32:
      return by_group<32, T>(G, q, k, v, len_ptr, len_val, B, Tn, KV, splits,
                             split_len, scale, part_ml, part_acc, out,
                             stream);
    case 64:
      return by_group<64, T>(G, q, k, v, len_ptr, len_val, B, Tn, KV, splits,
                             split_len, scale, part_ml, part_acc, out,
                             stream);
    case 128:
      return by_group<128, T>(G, q, k, v, len_ptr, len_val, B, Tn, KV,
                              splits, split_len, scale, part_ml, part_acc,
                              out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, KV * G, HD); k, v: (B, T, KV, HD), all float32 (bf16 = 0) or
// bfloat16 (bf16 = 1), contiguous and 16-byte aligned; HD 32, 64 or 128.
// length: *len_ptr (an int64 on the device) if len_ptr is not null, else
// len_val. part_ml: (B * KV * G, splits, 2) and part_acc: (B * KV * G,
// splits, HD) float32 scratch; split_len * splits >= T. out: (B, KV * G,
// HD) in the inputs' type.
extern "C" int tdorch_flash_decode(int device, const void* q, const void* k,
                                   const void* v, const long long* len_ptr,
                                   long long len_val, int B, int Tn, int KV,
                                   int G, int HD, int splits, int split_len,
                                   float scale, int bf16, float* part_ml,
                                   float* part_acc, void* out,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || KV == 0 || G == 0) return 0;
  err = bf16 ? by_head_dim<__nv_bfloat16>(HD, G, q, k, v, len_ptr, len_val,
                                          B, Tn, KV, splits, split_len,
                                          scale, part_ml, part_acc, out,
                                          stream)
             : by_head_dim<float>(HD, G, q, k, v, len_ptr, len_val, B, Tn,
                                  KV, splits, split_len, scale, part_ml,
                                  part_acc, out, stream);
  return static_cast<int>(err);
}
