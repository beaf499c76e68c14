// GQA flash attention (forward), for Hopper (sm_90a): SIMT float32, the
// route for float32 inputs (bf16 inputs take flash_attention_sm90.cu).
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py:75 (`_flash_kernel`), whose
// grid (B, H, S / block_q, T / block_k) walked the key tiles of a query
// tile in order on one core, keeping the online-softmax state (m, l, acc)
// in VMEM scratch from one key tile to the next.
//
// o[b, r, h] = softmax_c(q[b, r, h] · k[b, c, h / G] · hd^-0.5) · v[b, c, h / G]
// with, under `causal`, the score of every key c > r set to -2.0e38 (the
// TPU kernel's row >= col mask; the wrapper takes causal attention only
// for S == T, where the JAX package's kernel and oracle agree). float32
// q, k, v, scores, softmax, sums and output. hd is 32, 64 or 128. (On
// tensor cores float32 would run as TF32, whose 10-bit mantissa the
// float32 gate of 2e-5 does not admit.)
//
// What bounds it on this card: operations. A query tile of 64 rows does
// 2 · 64 · 64 · hd FLOPs per key tile for q·kᵀ and as many for p·v, and
// reads each key tile once from device memory (L2 serves the other query
// tiles of the same KV head): at zamba2's prefill (S = 32,768, hd 64)
// that is ~32 FLOPs per byte of float32 k/v read per tile, and the whole
// causal call does 2 · S² · hd · H FLOPs. So the design is about keeping
// the FMA units fed from shared memory:
// - One block of 256 threads per (tile of 64 query rows, query head,
//   batch row). Head h reads KV head h / G through its offsets: no copy of
//   k or v is made per query head.
// - The q tile is staged once, transposed, so a thread reads its 4 rows of
//   one column in one 16-byte load; key tiles of 64 rows are staged with
//   a padded row (hd + 1) so the 16 column lanes hit 16 banks; v is
//   staged as it lies. Each thread owns a 4 x 4 block of the 64 x 64 score
//   tile (rows 4·ty + i, columns tx + 16·j) and a 4 x hd/16 block of the
//   output, all in registers.
// - Online softmax per row: the tile's row maximum and row sum meet by
//   xor shuffles over the 16 lanes that share the rows; p goes through
//   shared memory (transposed) into the p·v product.
// - Under `causal`, key tiles past the query tile's last row are skipped,
//   as the TPU kernel's pl.when does (kernel.py:63-65), and the tiles
//   with most work (the last query tiles) are launched first.
// - Shared memory (43 KB at hd 32, 68 KB at 64, 118 KB at 128) is
//   dynamic, above the 48 KB default once hd > 32.

#include <cuda_runtime.h>

namespace {

constexpr float kMasked = -2.0e38f;  // score of a key after the query
constexpr int kBQ = 64;              // query rows of a block
constexpr int kBK = 64;              // keys of a tile
constexpr int kThreads = 256;        // 16 x 16: ty picks rows, tx columns
constexpr int kQPad = kBQ + 4;       // transposed q / p rows (16 B aligned)

static_assert(kBQ == 4 * 16 && kBK == 4 * 16, "4 x 4 blocks on 16 x 16");

template <int HD>
constexpr int smem_floats() {
  return HD * kQPad            // q tile, transposed: [HD][kQPad]
         + kBK * (HD + 1)      // key tile: [kBK][HD + 1]
         + kBK * HD            // value tile: [kBK][HD]
         + kBK * kQPad;        // p, transposed: [kBK][kQPad]
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_forward(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int S, int Tn, int H,
           int KV, int G, float scale, int causal) {
  constexpr int TN = HD / 16;  // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + HD * kQPad;
  float* vs = ks + kBK * (HD + 1);
  float* ps = vs + kBK * HD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const float* qb = q + (static_cast<long long>(b) * S * H + h) * HD;
  const long long q_row = static_cast<long long>(H) * HD;
  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[d * kQPad + r] = q0 + r < S ? qb[(q0 + r) * q_row + d] : 0.f;
  }

  float acc[4][TN], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  const float* kb = k + (static_cast<long long>(b) * Tn * KV + kvh) * HD;
  const float* vb = v + (static_cast<long long>(b) * Tn * KV + kvh) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const int k_end = causal ? min(Tn, q0 + kBQ) : Tn;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done (and q is staged)
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const bool in = k0 + c < Tn;
      ks[c * (HD + 1) + d] = in ? kb[(k0 + c) * kv_row + d] : 0.f;
      vs[c * HD + d] = in ? vb[(k0 + c) * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(
          qs + d * kQPad + 4 * ty);
      float bk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] = fmaf(a.x, bk[j], s[0][j]);
        s[1][j] = fmaf(a.y, bk[j], s[1][j]);
        s[2][j] = fmaf(a.z, bk[j], s[2][j]);
        s[3][j] = fmaf(a.w, bk[j], s[3][j]);
      }
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (c >= Tn) x = -INFINITY;  // past the keys: weight 0
        else if (causal && c > r) x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - mx);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * kQPad + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(ps + c * kQPad +
                                                        4 * ty);
      float bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[0][j] = fmaf(a.x, bv[j], acc[0][j]);
        acc[1][j] = fmaf(a.y, bv[j], acc[1][j]);
        acc[2][j] = fmaf(a.z, bv[j], acc[2][j]);
        acc[3][j] = fmaf(a.w, bv[j], acc[3][j]);
      }
    }
  }

  float* ob = o + (static_cast<long long>(b) * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      ob[r * q_row + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int Tn, int H, int KV, int G, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fa_forward<HD><<<grid, kThreads, bytes, stream>>>(q, k, v, o, S, Tn, H, KV,
                                                     G, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, HD); k, v: (B, T, KV, HD) with H = KV * G; all float32,
// contiguous; HD 32, 64 or 128. o: (B, S, H, HD) float32, fully written.
// causal needs S == T (the wrapper checks).
extern "C" int tdorch_flash_attention(int device, const void* q,
                                      const void* k, const void* v, int B,
                                      int S, int Tn, int H, int KV, int HD,
                                      float scale, int causal, void* o,
                                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || H == 0) return 0;
  const int G = H / KV;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  switch (HD) {
    case 32:
      err = launch<32>(qf, kf, vf, of, B, S, Tn, H, KV, G, scale, causal,
                       stream);
      break;
    case 64:
      err = launch<64>(qf, kf, vf, of, B, S, Tn, H, KV, G, scale, causal,
                       stream);
      break;
    case 128:
      err = launch<128>(qf, kf, vf, of, B, S, Tn, H, KV, G, scale, causal,
                        stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
