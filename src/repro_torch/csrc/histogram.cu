// Contention histogram (TD-Orch Phase 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel `histogram` in src/repro/kernels/histogram/kernel.py
// (a one-hot compare plus a column sum into a bin vector held in VMEM, which
// capped the number of bins). Here it also takes the weighted form that the
// JAX package left to a jnp scatter (histogram/ops.py `count_ids`), so the
// Phase-1 root call, which is weighted, reaches the kernel.
//
// What bounds it on this card: memory, and before it the call itself. Each
// id (and weight) is read once and each bin written once; there is no
// arithmetic to speak of. The path's calls are small (40 to 800,000 ids),
// so the fixed cost of a call weighs: the entry point zero-fills the bins
// itself (`cudaMemsetAsync`, no separate fill launch) and sets the device
// only when it is not the current one. The hazard inside the kernel is
// atomics: many ids on one bin serialize on that address.
//
// Two routes; the wrapper picks one and the grid (`ops.route`):
// - Shared: every block keeps a private copy of the whole bin vector in
//   shared memory (up to the opt-in limit, 227 KB on an H100: 58,112 bins;
//   above 48 KB after `cudaFuncSetAttribute`), so hot-bin atomics stay on
//   the SM, and merges its non-zero bins into global memory once at the
//   end. Taken only where the ids outnumber that merge (blocks x bins).
// - Global: ids add straight into global memory (atomics resolve in L2),
//   with no cap on the bin count, one id a thread a pass. The grid is the
//   SMs' resident blocks, fewer for few ids. (Warp-aggregated atomics,
//   `__match_any_sync` over a warp's ids, were tried: on the paths' calls
//   they merged too little to pay for themselves; see PERF.md.)
// Ids outside [0, num_bins) are dropped. With weights, a bin gains the id's
// int32 weight instead of 1 (int32 sums wrap, as the plain version's cast
// does).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a block; `ops.route` reads it (limits)
constexpr size_t kStaticShared = 48 * 1024;  // beyond it: the opt-in

enum Route { kShared = 0, kGlobal = 1 };

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
hist_shared(const int* __restrict__ ids, const int* __restrict__ weights,
            long long n, int num_bins, int* __restrict__ out) {
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
__global__ void __launch_bounds__(kThreads)
hist_global(const int* __restrict__ ids, const int* __restrict__ weights,
            long long n, int num_bins, int* __restrict__ out) {
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

template <bool kWeighted>
cudaError_t launch_route(const int* ids, const int* weights, long long n,
                         int num_bins, int route, int blocks, int* out,
                         cudaStream_t stream) {
  if (route == kShared) {
    const size_t smem = static_cast<size_t>(num_bins) * sizeof(int);
    if (smem > kStaticShared) {
      const cudaError_t err = cudaFuncSetAttribute(
          hist_shared<kWeighted>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    hist_shared<kWeighted><<<blocks, kThreads, smem, stream>>>(
        ids, weights, n, num_bins, out);
  } else if (route == kGlobal) {
    hist_global<kWeighted><<<blocks, kThreads, 0, stream>>>(
        ids, weights, n, num_bins, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// What `ops.route` reads: out[0] the shared memory a block may opt in to,
// out[1] an SM's shared memory, out[2] the shared memory the card keeps
// back a block (bytes), out[3] the SMs, out[4] an SM's resident threads,
// out[5] this kernel's threads a block.
extern "C" int tdorch_histogram_limits(int device, int* out) {
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxThreadsPerMultiProcessor};
  for (int i = 0; i < 5; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(&out[i], attrs[i], device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  out[5] = kThreads;
  return static_cast<int>(cudaSuccess);
}

// ids: (n,) int32; weights: (n,) int32 or null; out: (num_bins,) int32,
// zero-filled here; route (kShared, kGlobal) and blocks from `ops.route`.
extern "C" int tdorch_histogram(int device, const int* ids, const int* weights,
                                long long n, int num_bins, int route,
                                int blocks, int* out, cudaStream_t stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_bins <= 0) return static_cast<int>(cudaGetLastError());
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(num_bins) * sizeof(int),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
    err = weights != nullptr
        ? launch_route<true>(ids, weights, n, num_bins, route, blocks, out,
                             stream)
        : launch_route<false>(ids, weights, n, num_bins, route, blocks, out,
                              stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
