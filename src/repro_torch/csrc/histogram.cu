// Contention histogram (TD-Orch Phase 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel `histogram` in src/repro/kernels/histogram/kernel.py
// (a one-hot compare plus a column sum into a bin vector held in VMEM, which
// capped the number of bins). Here it also takes the weighted form that the
// JAX package left to a jnp scatter (histogram/ops.py `count_ids`), so the
// Phase-1 root call, which is weighted, reaches the kernel.
//
// What bounds it on this card: memory. Each id (and weight) is read once and
// each bin written once; there is no arithmetic to speak of. The hazard is
// atomics: many ids on one bin serialize on that address.
//
// Design: when the bins fit a block's shared memory (kSharedBins), every
// block keeps a private copy of the whole bin vector in shared memory, so
// hot-bin atomics stay on the SM, and merges its non-zero bins into global
// memory once at the end. Beyond that budget, ids add straight into global
// memory (atomics resolve in L2), with no cap on the bin count. Ids outside
// [0, num_bins) are dropped. With weights, a bin gains the id's int32 weight
// instead of 1. The output must be zero-filled by the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 12288;  // 48 KiB of int32 bins: no opt-in needed
constexpr int kIdsPerThread = 16;   // shared path: amortize the bin merge
constexpr int kMaxSharedBlocks = 264;
constexpr int kMaxGlobalBlocks = 132 * 16;

template <bool kWeighted>
__global__ void hist_shared(const int* __restrict__ ids,
                            const int* __restrict__ weights, long long n,
                            int num_bins, int* __restrict__ out) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int id = ids[i];
    if (id >= 0 && id < num_bins) {
      atomicAdd(&bins[id], kWeighted ? weights[i] : 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    const int c = bins[b];
    if (c != 0) atomicAdd(&out[b], c);
  }
}

template <bool kWeighted>
__global__ void hist_global(const int* __restrict__ ids,
                            const int* __restrict__ weights, long long n,
                            int num_bins, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int id = ids[i];
    if (id >= 0 && id < num_bins) {
      atomicAdd(&out[id], kWeighted ? weights[i] : 1);
    }
  }
}

int blocks_for(long long work, long long per_block, int cap) {
  const long long want = (work + per_block - 1) / per_block;
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace

extern "C" int tdorch_histogram_shared_bins() { return kSharedBins; }

// ids: (n,) int32; weights: (n,) int32 or null; out: (num_bins,) int32,
// zero-filled by the caller.
extern "C" int tdorch_histogram(int device, const int* ids, const int* weights,
                                long long n, int num_bins, int* out,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && num_bins > 0) {
    if (num_bins <= kSharedBins) {
      const int blocks = blocks_for(n, static_cast<long long>(kThreads) *
                                           kIdsPerThread, kMaxSharedBlocks);
      const size_t smem = static_cast<size_t>(num_bins) * sizeof(int);
      if (weights != nullptr) {
        hist_shared<true><<<blocks, kThreads, smem, stream>>>(
            ids, weights, n, num_bins, out);
      } else {
        hist_shared<false><<<blocks, kThreads, smem, stream>>>(
            ids, weights, n, num_bins, out);
      }
    } else {
      const int blocks = blocks_for(n, kThreads, kMaxGlobalBlocks);
      if (weights != nullptr) {
        hist_global<true><<<blocks, kThreads, 0, stream>>>(ids, weights, n,
                                                          num_bins, out);
      } else {
        hist_global<false><<<blocks, kThreads, 0, stream>>>(ids, weights, n,
                                                           num_bins, out);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
