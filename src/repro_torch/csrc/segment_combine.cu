// Merge-able write-back ⊗-combine (TD-Orch Phase 4) for Hopper, sm_90a.
//
// Replaces the TPU kernel `segment_add` in
// src/repro/kernels/segment_combine/kernel.py (a one-hot-transposed matmul
// per tile into a destination block held in VMEM), and takes over the
// min/max/or scatters of segment_combine/ops.py `combine` and the ordered
// "write" merge of core/jaxexec.py `_segment_combine`.
//
// What bounds it on this card: memory. Each value row and segment id is read
// once and each output row written once; an add is one operation per
// element. The hazard is atomics: on skewed batches a hot segment receives
// hundreds of thousands of rows, and atomics on one address serialize.
//
// Design: one thread per (row, column) element, neighbouring threads on
// neighbouring columns, so a row's loads coalesce. add uses atomicAdd
// (float and double); min/max/or use a compare-and-swap loop on the value's
// bits, which is exact and leaves the output untouched unless the new value
// wins. The caller pre-fills the output with the merge identity (0, +max,
// -max, 0), so empty segments hold it. Rows whose segment lies outside
// [0, num_segments) are dropped. "write" packs
// ((order + 2^31) << 32) | row into one 64-bit key per row and keeps the
// per-segment minimum with a 64-bit atomicMin: the lowest order wins, then
// the lowest row, and the bias keeps negative int32 orders in order. A second
// pass gathers each segment's winning row (0 where nobody wrote).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;
constexpr unsigned long long kNoWinner = ~0ULL;

enum Op { kAdd = 0, kMin = 1, kMax = 2, kOr = 3 };

__device__ __forceinline__ void atomic_min(float* addr, float v) {
  int* bits = reinterpret_cast<int*>(addr);
  int old = *bits;
  while (v < __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(bits, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ void atomic_max(float* addr, float v) {
  int* bits = reinterpret_cast<int*>(addr);
  int old = *bits;
  while (v > __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(bits, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ void atomic_min(double* addr, double v) {
  unsigned long long* bits = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *bits;
  while (v < __longlong_as_double(static_cast<long long>(old))) {
    const unsigned long long assumed = old;
    old = atomicCAS(bits, assumed,
                    static_cast<unsigned long long>(__double_as_longlong(v)));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ void atomic_max(double* addr, double v) {
  unsigned long long* bits = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *bits;
  while (v > __longlong_as_double(static_cast<long long>(old))) {
    const unsigned long long assumed = old;
    old = atomicCAS(bits, assumed,
                    static_cast<unsigned long long>(__double_as_longlong(v)));
    if (old == assumed) break;
  }
}

template <typename T, int kOp>
__global__ void seg_combine(const T* __restrict__ values,
                            const int* __restrict__ seg, long long n, int w,
                            int num_segments, T* __restrict__ out) {
  const long long total = n * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long row = i / w;
    const int s = seg[row];
    if (s < 0 || s >= num_segments) continue;
    T* dst = out + static_cast<long long>(s) * w + (i - row * w);
    const T v = values[i];
    if (kOp == kAdd) {
      atomicAdd(dst, v);
    } else if (kOp == kMin) {
      atomic_min(dst, v);
    } else {  // kMax and kOr: "or" is max over an identity of 0
      atomic_max(dst, v);
    }
  }
}

__global__ void write_elect(const int* __restrict__ seg,
                            const int* __restrict__ order, long long n,
                            int num_segments,
                            unsigned long long* __restrict__ winner) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    const int s = seg[r];
    if (s < 0 || s >= num_segments) continue;
    // order + 2^31 as an unsigned 32-bit number: flip the sign bit
    const unsigned long long biased =
        static_cast<unsigned int>(order[r]) ^ 0x80000000u;
    atomicMin(&winner[s], (biased << 32) | static_cast<unsigned long long>(r));
  }
}

template <typename T>
__global__ void write_gather(const T* __restrict__ values,
                             const unsigned long long* __restrict__ winner,
                             int num_segments, int w, T* __restrict__ out) {
  const long long total = static_cast<long long>(num_segments) * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long s = i / w;
    const unsigned long long key = winner[s];
    const long long row = static_cast<long long>(key & 0xffffffffULL);
    out[i] = key == kNoWinner ? T(0) : values[row * w + (i - s * w)];
  }
}

int blocks_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

template <typename T>
cudaError_t launch_combine(const T* values, const int* seg, long long n, int w,
                           int num_segments, int op, T* out,
                           cudaStream_t stream) {
  const int blocks = blocks_for(n * w);
  switch (op) {
    case kAdd:
      seg_combine<T, kAdd><<<blocks, kThreads, 0, stream>>>(
          values, seg, n, w, num_segments, out);
      break;
    case kMin:
      seg_combine<T, kMin><<<blocks, kThreads, 0, stream>>>(
          values, seg, n, w, num_segments, out);
      break;
    case kMax:
    case kOr:
      seg_combine<T, kMax><<<blocks, kThreads, 0, stream>>>(
          values, seg, n, w, num_segments, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// values: (n, w) float32 (is_f64 == 0) or float64; seg: (n,) int32;
// out: (num_segments, w) of the values' type, pre-filled with the identity.
extern "C" int tdorch_segment_combine(int device, const void* values,
                                      int is_f64, const int* seg, long long n,
                                      int w, int num_segments, int op,
                                      void* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && w > 0 && num_segments > 0) {
    err = is_f64
        ? launch_combine(static_cast<const double*>(values), seg, n, w,
                         num_segments, op, static_cast<double*>(out), stream)
        : launch_combine(static_cast<const float*>(values), seg, n, w,
                         num_segments, op, static_cast<float*>(out), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ordered "write" merge. order: (n,) int32; winner: (num_segments,)
// scratch pre-filled with all ones bits; out: (num_segments, w), every
// element written. n must be below 2^32 (rows are packed into 32 bits).
extern "C" int tdorch_segment_write(int device, const void* values, int is_f64,
                                    const int* seg, const int* order,
                                    long long n, int w, int num_segments,
                                    unsigned long long* winner, void* out,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_segments > 0 && w > 0) {
    if (n > 0) {
      write_elect<<<blocks_for(n), kThreads, 0, stream>>>(seg, order, n,
                                                         num_segments, winner);
    }
    const int blocks = blocks_for(static_cast<long long>(num_segments) * w);
    if (is_f64) {
      write_gather<double><<<blocks, kThreads, 0, stream>>>(
          static_cast<const double*>(values), winner, num_segments, w,
          static_cast<double*>(out));
    } else {
      write_gather<float><<<blocks, kThreads, 0, stream>>>(
          static_cast<const float*>(values), winner, num_segments, w,
          static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
