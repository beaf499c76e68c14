// Ragged fused stage, gather-reduce half (TD-Orch Phases 3+4) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel `fused_stage_pallas` in
// src/repro/kernels/stage_fused/kernel.py, which walked the CSR pair list in
// task tiles x pair blocks and gathered with one-hot matmuls against a value
// table held whole in VMEM (so the table, the segment count and the pair
// count were capped). On this card the table stays in device memory and is
// gathered directly; the per-task `finish` epilogue (a Python callable) runs
// as torch ops on this kernel's output, and the writer ⊗-combine runs the
// segment-combine kernel (segment_combine.cu), so no VMEM-style gate applies.
//
// What bounds it on this card: memory. Every (task, key) pair reads one row
// of w values at a random key, plus its index; each task writes one row. A
// row of 16 float32 values is 64 bytes, so a random gather wastes little of
// a 32-byte sector, and a hot key's row is served from L2.
//
// Design: one warp per task. Lanes stride over the w columns and loop over
// the task's pairs indptr[t]..indptr[t+1], so a warp's loads of one row are
// contiguous and every lane reads the same index (a broadcast). read_op add
// sums in the values' type in pair order; first takes the first pair's row;
// a task with no pairs (arity 0) gives 0 for every op. min/max start from
// the task's first pair and propagate NaN (as numpy's min/max do: a compare
// alone would drop it, and fminf/fmaxf drop it too), then fold in
// +-float32max/2 where the task's arity is below the batch's max arity:
// the oracle reduces a padded (n, max_arity, w) view whose empty slots
// hold that fill, so a task at the max arity reads its pairs alone. A
// skewed batch with a few very long rows leaves their warps running after
// the rest: binning tasks by arity is work for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr float kBig = 3.4028234663852886e38f / 2.0f;  // float32 max / 2

enum ReadOp { kAdd = 0, kMin = 1, kMax = 2, kFirst = 3 };

// min / max that return a NaN operand: a NaN anywhere makes the result NaN
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T, int kOp>
__global__ void fused_reduce(const T* __restrict__ values, int w,
                             const int* __restrict__ indptr,
                             const int* __restrict__ indices, long long n,
                             int max_arity, T* __restrict__ out) {
  const long long task =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (task >= n) return;
  const int lane = threadIdx.x % kWarp;
  const int start = indptr[task];
  const int end = indptr[task + 1];
  T* row = out + task * w;
  for (int c = lane; c < w; c += kWarp) {
    T acc = T(0);
    if (start < end) {
      acc = values[static_cast<long long>(indices[start]) * w + c];
      if (kOp != kFirst) {
        for (int p = start + 1; p < end; ++p) {
          const T v = values[static_cast<long long>(indices[p]) * w + c];
          if (kOp == kAdd) {
            acc += v;
          } else if (kOp == kMin) {
            acc = nan_min(acc, v);
          } else {
            acc = nan_max(acc, v);
          }
        }
        if (end - start < max_arity) {  // the padded view's fill
          if (kOp == kMin) acc = nan_min(acc, T(kBig));
          if (kOp == kMax) acc = nan_max(acc, T(-kBig));
        }
      }
    }
    row[c] = acc;
  }
}

template <typename T>
cudaError_t launch(const T* values, int w, const int* indptr,
                   const int* indices, long long n, int read_op,
                   int max_arity, T* out, cudaStream_t stream) {
  const long long warps_per_block = kThreads / kWarp;
  const long long blocks = (n + warps_per_block - 1) / warps_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(blocks));
  switch (read_op) {
    case kAdd:
      fused_reduce<T, kAdd><<<grid, kThreads, 0, stream>>>(
          values, w, indptr, indices, n, max_arity, out);
      break;
    case kMin:
      fused_reduce<T, kMin><<<grid, kThreads, 0, stream>>>(
          values, w, indptr, indices, n, max_arity, out);
      break;
    case kMax:
      fused_reduce<T, kMax><<<grid, kThreads, 0, stream>>>(
          values, w, indptr, indices, n, max_arity, out);
      break;
    case kFirst:
      fused_reduce<T, kFirst><<<grid, kThreads, 0, stream>>>(
          values, w, indptr, indices, n, max_arity, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// values: (K, w) float32 (is_f64 == 0) or float64; indptr: (n+1,) int32;
// indices: (nnz,) int32 keys in [0, K); max_arity: the batch's largest
// arity (min/max fold the fill into the tasks below it); out: (n, w) of
// the values' type.
extern "C" int tdorch_fused_reduce(int device, const void* values, int is_f64,
                                   int w, const int* indptr,
                                   const int* indices, long long n,
                                   int read_op, int max_arity, void* out,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && w > 0) {
    err = is_f64
        ? launch(static_cast<const double*>(values), w, indptr, indices, n,
                 read_op, max_arity, static_cast<double*>(out), stream)
        : launch(static_cast<const float*>(values), w, indptr, indices, n,
                 read_op, max_arity, static_cast<float*>(out), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
