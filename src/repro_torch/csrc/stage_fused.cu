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
// What bounds it on this card: latency more than bytes. Every (task, key)
// pair reads one row of w values at a random key, plus its index; each task
// writes one row. On skewed keys few distinct rows are read (stage (c) of
// the main path reads 30,020 rows, 1.9 MB, for 3.6 M pairs), so the rows
// come from L1 and L2, and what limits the kernel is how many loads the
// card keeps in flight across a chain of three dependent ones a task
// (indptr, then indices, then rows).
//
// Design: lanes over 16-byte column vectors, many warps an SM.
// - A row is w / kV vectors (kV = 16 bytes / sizeof(T), or 1 where w is not
//   a multiple of it or the rows are not 16-byte aligned: the wrapper
//   decides, `ops.layout`). A group of G lanes (a power of two, at most 32)
//   serves one task, so a warp serves 32 / G consecutive tasks. Narrow rows
//   (at most 32 vectors, 512 bytes) take G = the next power of two of the
//   vector count and one vector a lane: G = 4 for w = 16 float32, 8 tasks a
//   warp. Wide rows take G = 32 and kCols = 4 vectors a lane a pass, in
//   column passes of 128 vectors (w = 1536 float32: three passes).
// - Consecutive tasks have contiguous CSR slices, so the warp loads the
//   indices of its tasks in chunks (64 a chunk for narrow rows, two
//   coalesced loads; 32 for wide ones) and hands each group its pairs'
//   keys by `__shfl_sync`: at w = 16, one chunk holds a warp's ~36 pairs.
// - Loads in flight come from warps for narrow rows: the kernel is held to
//   32 registers (`__launch_bounds__`, 8 blocks of 256 an SM: every warp
//   slot of the SM) and a lane loads one pair's vector at a time. Loading
//   2, 4 or 8 pairs before combining them took more registers, fewer warps
//   and more time at stage (c). Wide rows load 4 pairs' 4 vectors before
//   combining them, 16 in flight a lane.
// - The indices of a narrow row's tasks are read once (one column pass) and
//   go through the cache as streaming loads (`__ldcs`); wide rows read them
//   once a pass and keep them cached. The output is written with streaming
//   16-byte stores (`__stcs`), so the (n, w) rows, read by later kernels,
//   do not push the gathered rows out of L2 while this one runs.
// - Values combine per column in pair order, as the one-warp-a-task kernel
//   did: add sums in the values' type starting from the first pair, first
//   takes the first pair's row, min/max start from the first pair and
//   propagate NaN (a compare alone, fminf or fmaxf would drop it), then
//   fold in +-float32max/2 where the task's arity is below the batch's max
//   arity: the oracle reduces a padded (n, max_arity, w) view whose empty
//   slots hold that fill, so a task at the max arity reads its pairs alone.
//   A task with no pairs (arity 0) gives 0 for every op.
// A skewed batch with a few very long rows leaves their groups running
// after the rest: binning tasks by arity is work for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4028234663852886e38f / 2.0f;  // float32 max / 2

enum ReadOp { kAdd = 0, kMin = 1, kMax = 2, kFirst = 3 };

template <typename T, int kV>
struct alignas(sizeof(T) * kV) Vec {
  T x[kV];
};

template <typename T, int kV>
__device__ __forceinline__ Vec<T, kV> load(const T* p) {
  Vec<T, kV> v;
  if constexpr (kV == 1) {
    v.x[0] = __ldg(p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v.x[0] = f.x;
    v.x[1] = f.y;
    v.x[2] = f.z;
    v.x[3] = f.w;
  } else {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v.x[0] = d.x;
    v.x[1] = d.y;
  }
  return v;
}

template <typename T, int kV>
__device__ __forceinline__ void store_streaming(T* p, const Vec<T, kV>& v) {
  if constexpr (kV == 1) {
    __stcs(p, v.x[0]);
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(v.x[0], v.x[1], v.x[2], v.x[3]));
  } else {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v.x[0], v.x[1]));
  }
}

// min / max that return a NaN operand: a NaN anywhere makes the result NaN
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <int kOp, typename T>
__device__ __forceinline__ T merge(T a, T b) {
  if constexpr (kOp == kAdd) return a + b;
  if constexpr (kOp == kMin) return nan_min(a, b);
  return nan_max(a, b);
}

// values: (K, w) rows; G = 1 << log_g lanes a task; kCols vectors a lane a
// column pass (1 for narrow rows, whose G lanes cover the row).
template <typename T, int kV, int kOp, int kCols>
__global__ void __launch_bounds__(kThreads, kCols == 1 ? 8 : 1)
fused_reduce(const T* __restrict__ values, int w,
             const int* __restrict__ indptr, const int* __restrict__ indices,
             long long n, int max_arity, int log_g, T* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int group = 1 << log_g;
  const long long t0 = warp * (kWarp >> log_g);  // the warp's first task
  if (t0 >= n) return;  // the whole warp
  const long long t_end = min(t0 + (kWarp >> log_g), n);
  const long long task = t0 + (lane >> log_g);
  const int sub = lane & (group - 1);  // the lane's place in its group
  const bool live = task < n;
  const int start = live ? indptr[task] : 0;
  const int end = live ? indptr[task + 1] : 0;
  const int warp_start = indptr[t0], warp_end = indptr[t_end];
  const int nvec = w / kV;
  // pairs whose rows a lane loads before it combines any; indices a lane
  // holds of a chunk (a chunk is kKeys * 32 of the warp's pairs)
  constexpr int kUnroll = kCols == 1 ? 1 : 4;
  constexpr int kKeys = kCols == 1 ? 2 : 1;
  constexpr int kChunk = kKeys * kWarp;

  for (int c0 = 0; c0 < nvec; c0 += group * kCols) {
    Vec<T, kV> acc[kCols];
    bool started = false;
    // the warp's pairs a chunk at a time, each group taking its own
    for (int base = warp_start; base < warp_end; base += kChunk) {
      int keys[kKeys];
#pragma unroll
      for (int q = 0; q < kKeys; ++q) {
        const int p = base + q * kWarp + lane;
        keys[q] = p >= warp_end ? 0
                  : kCols == 1  ? __ldcs(indices + p)  // read once
                                : __ldg(indices + p);
      }
      const int lo = max(start, base);
      int hi = min(end, base + kChunk);
      if (kOp == kFirst) hi = min(hi, start + 1);
      const int count = hi - lo;  // this group's pairs in the chunk
      const int rounds = __reduce_max_sync(kFull, count);
      for (int j = 0; j < rounds; j += kUnroll) {
        Vec<T, kV> v[kUnroll][kCols];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int slot = lo + j + u - base;  // in the chunk where used
          int key = __shfl_sync(kFull, keys[0], slot & (kWarp - 1));
          if constexpr (kKeys == 2) {
            const int upper = __shfl_sync(kFull, keys[1], slot & (kWarp - 1));
            key = slot >= kWarp ? upper : key;
          }
          if (j + u < count) {
            const T* row = values + static_cast<long long>(key) * w;
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
              const int c = c0 + sub + k * group;
              if (c < nvec) v[u][k] = load<T, kV>(row + c * kV);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u < count) {
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
#pragma unroll
              for (int e = 0; e < kV; ++e) {
                acc[k].x[e] = started ? merge<kOp>(acc[k].x[e], v[u][k].x[e])
                                      : v[u][k].x[e];
              }
            }
            started = true;
          }
        }
      }
    }
    if (!live) continue;
    const bool fill = end - start < max_arity;  // the padded view's fill
    T* dst = out + task * w;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = c0 + sub + k * group;
      if (c >= nvec) continue;
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        T a = started ? acc[k].x[e] : T(0);
        if (started && fill) {
          if (kOp == kMin) a = nan_min(a, T(kBig));
          if (kOp == kMax) a = nan_max(a, T(-kBig));
        }
        acc[k].x[e] = a;
      }
      store_streaming<T, kV>(dst + c * kV, acc[k]);
    }
  }
}

template <typename T, int kV, int kCols>
cudaError_t launch_op(const T* values, int w, const int* indptr,
                      const int* indices, long long n, int read_op,
                      int max_arity, int log_g, T* out,
                      cudaStream_t stream) {
  const long long tasks_per_block = (kThreads / kWarp) * (kWarp >> log_g);
  const long long blocks = (n + tasks_per_block - 1) / tasks_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(blocks));
  switch (read_op) {
    case kAdd:
      fused_reduce<T, kV, kAdd, kCols><<<grid, kThreads, 0, stream>>>(
          values, w, indptr, indices, n, max_arity, log_g, out);
      break;
    case kMin:
      fused_reduce<T, kV, kMin, kCols><<<grid, kThreads, 0, stream>>>(
          values, w, indptr, indices, n, max_arity, log_g, out);
      break;
    case kMax:
      fused_reduce<T, kV, kMax, kCols><<<grid, kThreads, 0, stream>>>(
          values, w, indptr, indices, n, max_arity, log_g, out);
      break;
    case kFirst:
      fused_reduce<T, kV, kFirst, kCols><<<grid, kThreads, 0, stream>>>(
          values, w, indptr, indices, n, max_arity, log_g, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* values, int w, const int* indptr,
                   const int* indices, long long n, int read_op,
                   int max_arity, int vec, int log_g, int cols, void* out,
                   cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const T* v = static_cast<const T*>(values);
  T* o = static_cast<T*>(out);
  const bool vector = vec == kV;
  if (!(vector || vec == 1) || w % vec != 0 || log_g < 0 || log_g > 5 ||
      !(cols == 1 || (cols == 4 && log_g == 5)))
    return cudaErrorInvalidValue;
  if (vector) {
    return cols == 1
        ? launch_op<T, kV, 1>(v, w, indptr, indices, n, read_op, max_arity,
                              log_g, o, stream)
        : launch_op<T, kV, 4>(v, w, indptr, indices, n, read_op, max_arity,
                              log_g, o, stream);
  }
  return cols == 1
      ? launch_op<T, 1, 1>(v, w, indptr, indices, n, read_op, max_arity,
                           log_g, o, stream)
      : launch_op<T, 1, 4>(v, w, indptr, indices, n, read_op, max_arity,
                           log_g, o, stream);
}

}  // namespace

// values: (K, w) float32 (is_f64 == 0) or float64; indptr: (n+1,) int32;
// indices: (nnz,) int32 keys in [0, K); max_arity: the batch's largest
// arity (min/max fold the fill into the tasks below it); out: (n, w) of
// the values' type. The layout (`ops.layout`): vec values a load (1, or
// 16 bytes' worth where w and both bases allow it), 1 << log_g lanes a
// task, cols vectors a lane a column pass (4 only with 32 lanes a task).
extern "C" int tdorch_fused_reduce(int device, const void* values, int is_f64,
                                   int w, const int* indptr,
                                   const int* indices, long long n,
                                   int read_op, int max_arity, int vec,
                                   int log_g, int cols, void* out,
                                   cudaStream_t stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && w > 0) {
    err = is_f64 ? launch<double>(values, w, indptr, indices, n, read_op,
                                  max_arity, vec, log_g, cols, out, stream)
                 : launch<float>(values, w, indptr, indices, n, read_op,
                                 max_arity, vec, log_g, cols, out, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
