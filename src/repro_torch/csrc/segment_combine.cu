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
// element. The hazard is atomics: the rows arrive in task order, not sorted
// by segment, and on skewed batches a hot segment receives hundreds of
// thousands of rows (a Zipf-2.0 batch puts ~60% of its rows on one). Atomics
// on one address serialize, so the kernel combines equal segments on chip
// before it touches device memory:
// - Warp pre-combine. A warp takes 32 consecutive rows, one lane a row, and
//   loads each row's columns as 16-byte vectors where the rows allow it.
//   `__match_any_sync` on the segment id groups the lanes that share a
//   segment; each group of two or more rows reduces in registers (a
//   butterfly over the warp in which lanes outside the group give the
//   merge's neutral value), and the group's first lane (its leader)
//   carries the result on.
// - Coalesced write-out. The leaders' rows are staged in shared memory and
//   written column-parallel, 16 lanes a row (8 for float64), so each row's
//   update is one contiguous access, as a library scatter's would be;
//   lane-per-row atomics spread one instruction over 32 rows and ran
//   slower than `index_add_` on uniform keys.
// - Privatization. Each warp keeps a small table in shared memory for the
//   segments that recur in its rows: a segment claims a slot (a CAS on the
//   slot's id, linear probing) when it recurs within the warp's 32 rows,
//   and later rows of it, recurring or not, merge into the slot. A slot
//   has one writer at a time (a warp's groups hold distinct segments), so
//   it is updated without atomics: on this card a float atomic in shared
//   memory is a compare-and-swap loop. When the block ends, the warps'
//   tables merge into one block table (shared atomics, at most one
//   contribution a warp) and that is flushed with one global atomic a slot
//   and column. A row whose segment has no slot goes straight to the
//   global atomics. The hot segment so receives one global atomic per
//   block and column, not one per row and column.
// - The merges: add with atomicAdd (float and double); min/max/or with a
//   compare-and-swap loop on the value's bits that propagates NaN, as
//   np.minimum.at / np.maximum.at do (a NaN update wins, a NaN already
//   stored stays; a compare alone, fminf or fmaxf would drop it). "or" is
//   max over an identity of 0. The caller pre-fills the output with the
//   merge identity (0, +max, -max, 0), so empty segments hold it and hit
//   segments fold it in. Rows whose segment lies outside [0, num_segments)
//   are dropped.
// - "write" runs the same kernel on one 64-bit key per row,
//   ((order + 2^31) << 32) | row, under an unsigned min (warp butterfly,
//   shared and global atomicMin): the lowest order wins, then the lowest
//   row, and the bias keeps negative int32 orders in order. A second pass
//   gathers each segment's winning row (0 where nobody wrote).
// Float sums stay order-nondeterministic (atomics); min, max, or and write
// are exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kWarpSlots = 32;  // a warp's table; the block's has twice
constexpr int kTableBytes = 24576;  // shared memory for the tables' rows
constexpr int kProbes = 4;
constexpr int kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoWinner = ~0ULL;

enum Op { kAdd = 0, kMin = 1, kMax = 2, kOr = 3, kWrite = 4 };

// The value a lane outside a group contributes, and a fresh slot's.
template <int kOp, typename T>
__device__ __forceinline__ T neutral() {
  if constexpr (kOp == kAdd) {
    return T(0);
  } else if constexpr (kOp == kWrite) {
    return kNoWinner;
  } else if constexpr (kOp == kMin) {
    return static_cast<T>(__int_as_float(0x7f800000));  // +inf
  } else {
    return static_cast<T>(__int_as_float(0xff800000));  // -inf
  }
}

// a ⊗ b; min and max return a NaN operand
template <int kOp, typename T>
__device__ __forceinline__ T merge(T a, T b) {
  if constexpr (kOp == kAdd) {
    return a + b;
  } else if constexpr (kOp == kWrite) {
    return a < b ? a : b;
  } else if constexpr (kOp == kMin) {
    return (a < b || a != a) ? a : b;
  } else {
    return (a > b || a != a) ? a : b;
  }
}

// Whether `v` replaces `cur` under min (kMin) or max: a NaN update wins, a
// NaN already stored stays.
template <int kOp, typename T>
__device__ __forceinline__ bool wins(T v, T cur) {
  if (cur != cur) return false;
  return v != v || (kOp == kMin ? v < cur : v > cur);
}

// *addr ⊗= v, on shared or global memory
template <int kOp>
__device__ __forceinline__ void atomic_merge(float* addr, float v) {
  if constexpr (kOp == kAdd) {
    atomicAdd(addr, v);
  } else {
    int* bits = reinterpret_cast<int*>(addr);
    int old = *bits;
    while (wins<kOp>(v, __int_as_float(old))) {
      const int assumed = old;
      old = atomicCAS(bits, assumed, __float_as_int(v));
      if (old == assumed) break;
    }
  }
}

template <int kOp>
__device__ __forceinline__ void atomic_merge(double* addr, double v) {
  if constexpr (kOp == kAdd) {
    atomicAdd(addr, v);
  } else {
    unsigned long long* bits = reinterpret_cast<unsigned long long*>(addr);
    unsigned long long old = *bits;
    while (wins<kOp>(v, __longlong_as_double(static_cast<long long>(old)))) {
      const unsigned long long assumed = old;
      old = atomicCAS(bits, assumed,
                      static_cast<unsigned long long>(__double_as_longlong(v)));
      if (old == assumed) break;
    }
  }
}

template <int kOp>
__device__ __forceinline__ void atomic_merge(unsigned long long* addr,
                                             unsigned long long v) {
  atomicMin(addr, v);
}

// The slot of segment `s` in the block's table, claiming an empty one on
// its probe path if `claim`; -1 if it has none. Slots are only ever
// claimed, never freed, so a lookup may stop at the first empty slot.
__device__ __forceinline__ int find_slot(int* ids, int slots, int s,
                                         bool claim) {
  unsigned h = static_cast<unsigned>(s);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  for (int p = 0; p < kProbes; ++p) {
    const int i = static_cast<int>((h + p) & (slots - 1));
    int id = *reinterpret_cast<volatile int*>(ids + i);
    if (id == kEmpty) {
      if (!claim) return -1;
      id = atomicCAS(ids + i, kEmpty, s);
      if (id == kEmpty) return i;
    }
    if (id == s) return i;
  }
  return -1;
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T x[kVec];
};

// Shared memory: the ids of the warps' and the block's slots, then their
// rows (block_slots for the block, kWarps * slots for the warps), then
// each warp's staging of its leaders' rows.
__host__ __device__ constexpr int table_offset(int slots, int block_slots) {
  return ((kWarps * slots + block_slots) * static_cast<int>(sizeof(int)) +
          15) / 16 * 16;
}

// values: (n, w) rows (unused for kWrite, whose value is the packed key
// from `order`); out: (num_segments, w). kC columns a pass, loaded kVec at
// a time (w % kVec == 0 and 16-byte aligned rows when kVec > 1).
template <typename T, int kOp, int kC, int kVec>
__global__ void __launch_bounds__(kThreads)
seg_combine(const T* __restrict__ values, const int* __restrict__ seg,
            const int* __restrict__ order, long long n, int w,
            int num_segments, int slots, int block_slots,
            T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* block_ids = reinterpret_cast<int*>(smem);
  int* ids = block_ids + block_slots + warp * slots;  // this warp's
  T* block_table =
      reinterpret_cast<T*>(smem + table_offset(slots, block_slots));
  T* table = block_table + (block_slots + warp * slots) * w;
  const int all_slots = kWarps * slots + block_slots;
  // the warp's leaders' rows of a pass: [32][kC + 1] (padded: no bank
  // conflicts between rows)
  T* buf = block_table + all_slots * w + warp * 32 * (kC + 1);
  for (int i = threadIdx.x; i < all_slots; i += kThreads)
    block_ids[i] = kEmpty;
  for (int i = threadIdx.x; i < all_slots * w; i += kThreads)
    block_table[i] = neutral<kOp, T>();
  __syncthreads();

  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
       tile * 32 < n; tile += warps) {
    const long long row = tile * 32 + lane;
    const int s = row < n ? seg[row] : -1;
    const bool valid = row < n && s >= 0 && s < num_segments;
    // lanes out of range share the key -1, which no valid lane has
    const unsigned peers = __match_any_sync(kFull, valid ? s : -1);
    const bool leader = valid && lane == __ffs(peers) - 1;
    const bool multi = __popc(peers) > 1;
    int slot = -1;
    if (leader && slots > 0) slot = find_slot(ids, slots, s, multi);
    const unsigned groups = __ballot_sync(kFull, leader && multi);
    for (int c0 = 0; c0 < w; c0 += kC) {
      T v[kC];
      if constexpr (kOp == kWrite) {
        // order + 2^31 as an unsigned 32-bit number: flip the sign bit
        const unsigned long long biased =
            valid ? static_cast<unsigned int>(order[row]) ^ 0x80000000u : 0;
        v[0] = valid ? (biased << 32) | static_cast<unsigned long long>(row)
                     : kNoWinner;
      } else {
        const T* src = values + row * w + c0;
#pragma unroll
        for (int q = 0; q < kC / kVec; ++q) {
          if (valid && c0 + q * kVec < w) {
            const Pack<T, kVec> p =
                *reinterpret_cast<const Pack<T, kVec>*>(src + q * kVec);
#pragma unroll
            for (int j = 0; j < kVec; ++j) v[q * kVec + j] = p.x[j];
          } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j) v[q * kVec + j] = neutral<kOp, T>();
          }
        }
      }
      // each group of two or more rows, reduced into its first lane
      for (unsigned g = groups; g; g &= g - 1) {
        const int head = __ffs(g) - 1;
        const bool member = (__shfl_sync(kFull, peers, head) >> lane) & 1u;
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          T t = member ? v[j] : neutral<kOp, T>();
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            t = merge<kOp>(t, __shfl_xor_sync(kFull, t, off));
          if (lane == head) v[j] = t;
        }
      }
      if constexpr (kC == 1) {  // one value a leader: its own lane
        if (leader && slot >= 0) {
          table[slot] = merge<kOp>(table[slot], v[0]);
        } else if (leader) {
          atomic_merge<kOp>(out + s, v[0]);
        }
      } else {
        // The leaders' rows go out column-parallel, kC lanes a leader and
        // 32 / kC leaders a pass, so that each row is one contiguous
        // (coalesced) access: lane-per-row atomics would spread a warp's
        // instruction over 32 rows. A slot is updated by one leader.
        if (leader) {
#pragma unroll
          for (int j = 0; j < kC; ++j) buf[lane * (kC + 1) + j] = v[j];
        }
        __syncwarp();
        const int sub = lane / kC, col = lane % kC;
        for (unsigned todo = __ballot_sync(kFull, leader); todo;) {
          unsigned m = todo;
          for (int k = 0; k < sub && m; ++k) m &= m - 1;
          const int who = m ? __ffs(m) - 1 : 0;
          const int s_who = __shfl_sync(kFull, s, who);
          const int slot_who = __shfl_sync(kFull, slot, who);
          for (int k = 0; k < 32 / kC && todo; ++k) todo &= todo - 1;
          if (m && c0 + col < w) {
            const T val = buf[who * (kC + 1) + col];
            if (slot_who >= 0) {
              T* dst = table + slot_who * w + c0 + col;
              *dst = merge<kOp>(*dst, val);
            } else {
              atomic_merge<kOp>(out + static_cast<long long>(s_who) * w +
                                    c0 + col,
                                val);
            }
          }
        }
        __syncwarp();  // `buf` is free for the next pass
      }
    }
    __syncwarp();  // this tile's slot updates are seen by the next one's
  }
  __syncthreads();  // every row of the block is in its warps' tables
  // the warps' tables into the block's, a warp's slot by a warp's lanes
  for (int i = lane; i < slots * w; i += 32) {
    const int id = ids[i / w];
    if (id == kEmpty) continue;
    const int b = block_slots > 0 ? find_slot(block_ids, block_slots, id,
                                              true)
                                  : -1;
    T* dst = b >= 0 ? block_table + b * w
                    : out + static_cast<long long>(id) * w;
    atomic_merge<kOp>(dst + i % w, table[i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < block_slots * w; i += kThreads) {
    const int id = block_ids[i / w];
    if (id != kEmpty)
      atomic_merge<kOp>(out + static_cast<long long>(id) * w + i % w,
                        block_table[i]);
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

int max_blocks(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess || sms <= 0)
    sms = 132;
  return sms * kBlocksPerSm;
}

int blocks_for(long long work, int cap) {
  const long long want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

// The slots of a warp's table for rows of w values of `bytes` each: a
// power of two up to kWarpSlots such that the warps' tables and the
// block's (twice as many slots) fit in kTableBytes, or 0 (no tables) for
// very wide rows.
int table_slots(int w, int bytes) {
  int slots = kWarpSlots;
  while (slots > 0 && static_cast<long long>(slots) * (kWarps + 2) * w *
                              bytes > kTableBytes)
    slots >>= 1;
  return slots;
}

template <typename T, int kOp, int kC, int kVec>
cudaError_t launch_rows(const T* values, const int* seg, const int* order,
                        long long n, int w, int num_segments, T* out,
                        int device, cudaStream_t stream) {
  const int slots = table_slots(w, sizeof(T));
  const int block_slots = 2 * slots;
  const int bytes = table_offset(slots, block_slots) +
                    ((kWarps * slots + block_slots) * w +
                     (kC > 1 ? kWarps * 32 * (kC + 1) : 0)) *
                        static_cast<int>(sizeof(T));
  const int blocks = blocks_for((n + 31) / 32 * 32, max_blocks(device));
  seg_combine<T, kOp, kC, kVec><<<blocks, kThreads, bytes, stream>>>(
      values, seg, order, n, w, num_segments, slots, block_slots, out);
  return cudaGetLastError();
}

// float rows in 16-byte vectors where w and the base allow it
template <int kOp>
cudaError_t launch_op(const float* values, const int* seg, long long n, int w,
                      int num_segments, float* out, int device,
                      cudaStream_t stream) {
  const bool vec = w % 4 == 0 && reinterpret_cast<size_t>(values) % 16 == 0;
  return vec ? launch_rows<float, kOp, 16, 4>(values, seg, nullptr, n, w,
                                             num_segments, out, device, stream)
             : launch_rows<float, kOp, 16, 1>(values, seg, nullptr, n, w,
                                             num_segments, out, device,
                                             stream);
}

template <int kOp>
cudaError_t launch_op(const double* values, const int* seg, long long n,
                      int w, int num_segments, double* out, int device,
                      cudaStream_t stream) {
  const bool vec = w % 2 == 0 && reinterpret_cast<size_t>(values) % 16 == 0;
  return vec ? launch_rows<double, kOp, 8, 2>(values, seg, nullptr, n, w,
                                             num_segments, out, device, stream)
             : launch_rows<double, kOp, 8, 1>(values, seg, nullptr, n, w,
                                             num_segments, out, device,
                                             stream);
}

template <typename T>
cudaError_t launch_combine(const T* values, const int* seg, long long n, int w,
                           int num_segments, int op, T* out, int device,
                           cudaStream_t stream) {
  switch (op) {
    case kAdd:
      return launch_op<kAdd>(values, seg, n, w, num_segments, out, device,
                             stream);
    case kMin:
      return launch_op<kMin>(values, seg, n, w, num_segments, out, device,
                             stream);
    case kMax:
    case kOr:  // max over the pre-filled identity 0
      return launch_op<kMax>(values, seg, n, w, num_segments, out, device,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
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
                         num_segments, op, static_cast<double*>(out), device,
                         stream)
        : launch_combine(static_cast<const float*>(values), seg, n, w,
                         num_segments, op, static_cast<float*>(out), device,
                         stream);
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
      err = launch_rows<unsigned long long, kWrite, 1, 1>(
          nullptr, seg, order, n, 1, num_segments, winner, device, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int blocks = blocks_for(static_cast<long long>(num_segments) * w,
                                  max_blocks(device) * 8);
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
