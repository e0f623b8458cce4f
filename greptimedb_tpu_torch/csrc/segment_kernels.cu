// Hand-written Hopper kernels of the SQL row path.
//
// Built by greptimedb_tpu_torch/ops/segment_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libgreptime_segment.so
//        segment_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Every
// entry point launches on the caller's stream, allocates nothing (the
// wrapper passes outputs and scratch) and returns the first nonzero
// cudaGetLastError() of its launches.  The scan and the one-bit radix pass
// come from scan.cuh, shared with promql_kernels.cu.
//
// A row i is live when mask[i] (if a mask is given) and 0 <= ids[i] < ns;
// an element (i, c) of a live row counts when its value is not NaN.  Every
// reduction returns per (segment, column) the count of counted elements
// (int64, exact) and the sum / min / max of their values, or the identity
// where the count is 0 (sum 0, min +inf or INT64_MAX, max -inf or
// INT64_MIN); the wrapper applies the reference's NULL rules on top.
//
// segment_reduce
//   Replaces K4: greptimedb_tpu/ops/segment.py:79 `segment_reduce` (the
//   jax.ops.segment_sum/min/max scatters), the two passes of
//   segment_first_last (:165; int64 max of ts, then int64 min of the row
//   index) and the scatter half of the wide [N, C] pass of
//   greptimedb_tpu/query/physical.py:1846-1853.
//   Values f32, f64 or int64: one column or C f32 columns read in place
//   through a pointer array (C sums and C counts in one pass, no stacked
//   [N, C] copy).  A warp takes 32 x kRows consecutive rows in kRows steps
//   of 32 (lane l reads row 32 j + l: coalesced loads) and keeps one open
//   run, a segment id shared by the warp: a step whose live rows all carry
//   that id folds them into per-lane registers, with no shuffle and no
//   atomic (the common case: the resident table is sorted by series and
//   time).  A step that crosses a boundary closes the run (a fixed shuffle
//   tree, one flush) and merges its other rows by a segmented shuffle scan
//   over consecutive equal ids; each finished segment flushes once, the
//   last one stays open.  So a run of equal ids costs one flush per warp
//   chunk it touches, and a boundary one warp close.  Flushes go to shared-memory
//   accumulators when ns x C of them fit in 48 KB (privatised: each block
//   owns a contiguous row span and adds its accumulators to device memory
//   once at the end), else straight to device memory.  Summation order:
//   float sums add in step order within a lane, then in a fixed shuffle
//   tree (or scan) within the warp, then in the order the atomics land,
//   which changes from run to run; int64 sums wrap exactly (two's
//   complement) and counts are exact.  float/double min and max go through
//   an order-preserving unsigned key (atomicMin/Max on the key), so -0.0 <
//   +0.0 and the +-inf fills survive.
//   Bound: bytes.  The result needs every mask byte and the ids and values
//   of the live rows only: at the TSBS wide pass (N = 35.65 M, 17.28 M
//   live rows of the 12 h window, C = 10) ~0.80 GB, ~0.24 ms at 3.35 TB/s.
//
// sorted_segment_reduce
//   Replaces K5: ops/segment.py:272 `sorted_segment_reduce`, :240
//   `segmented_sum_scan` and the sorted half of the wide pass
//   (physical.py:1830-1845).  For nondecreasing ids: segment_bounds gives
//   each segment its [start, end) with two binary searches (searchsorted
//   left and right), then one warp per segment reduces its contiguous range
//   in a fixed order (lane l takes rows start + l, start + l + 32, ..., in
//   ascending order; the lanes combine by __shfl_down_sync with offsets 16,
//   8, 4, 2, 1), so every result repeats bit for bit from run to run.  No
//   atomics, no scatter.  Bound: bytes: the mask, the live rows' values,
//   the bounds and the outputs (the ids are only binary-searched).
//
// compact
//   Replaces ops/masks.py:37 `compact_rows` (the stable argsort of the mask
//   in physical.py:1986) and the rank scatter of K6 `compact_groups`
//   (ops/segment.py:353).  compact_order: an int32 inclusive scan of the
//   mask (scan.cuh), then order[rows before i that are set] = i for every
//   set row i: the kept rows in row order (incl[n - 1] of them; the clear
//   rows are not listed).  gather: dst[i] = src[order[i]] over the kept
//   rows, for 1-, 2-, 4- and 8-byte elements, one launch per column.  rank_scatter: an int32 scan of "sorted key differs
//   from the previous one" gives each sorted row its dense rank; one pass
//   writes dense[order[i]] (num_groups on invalid rows) and group_keys[rank]
//   = key.  Bound: bytes (compact reads the mask and the kept rows of each
//   column and writes them; rank_scatter reads key, order and valid and
//   writes dense and group_keys).
//
// radix_argsort
//   Replaces K6's sorts: the jnp.argsort of compact_groups
//   (ops/segment.py:353) and the jnp.lexsort((values, ids)) of
//   segment_distinct_count (:206, as two stable sweeps).  Stable LSD radix
//   argsort of int64 keys, one bit per pass (scan.cuh's radix_pass, as
//   sort_layout's), over only the bits the key range needs: argsort_keys
//   finds min and max over the valid rows (64-bit atomicMin/Max, order
//   free), maps key -> key - min (unsigned) and gives invalid rows the key
//   (max - min) + 1, so they sort last in row order.  When the valid keys
//   span all 2^64 values the wrapper instead runs 64 passes and then one
//   pass on the invalid flag.  Bound: bytes; each pass moves ~44 B/row
//   against the one-pass bound of 8 B in + 4 B out per row.
//
// segment_select
//   Replaces K12's sorts: the two-key lax.sort of (group id, value) per
//   step column in the PromQL aggregations quantile (engine.py:1601-1624)
//   and topk/bottomk (:1625-1651; for ng == 1 a full column sort).  Given
//   group-contiguous rows (row_order, offsets) of a [S, T] f32 matrix it
//   returns, per (rank set r, group g, step t), the value at rank
//   ranks[r, g, t] of the group's column in ascending order, NaN last and
//   -0.0 below +0.0 (the keys are the bits of the value, so the result is
//   the value itself, bit for bit).  Only order statistics are read, so no
//   column is sorted in full, and every route is chosen on the device from
//   the group sizes (no host sync, no host-built group lists):
//   - groups of up to kSelTiny (32) rows (`quantile by (pod)`: 10): one
//     thread a (group, step), lanes along the steps so a warp reads a
//     series' T consecutive floats; the keys sit in registers, a bitonic
//     network unrolled for 4, 8, 16 or 32 keys sorts them and each rank
//     set's rank is picked by compare-and-select.  The same launch files
//     the larger groups (step-0 thread): mid groups into a list by
//     warp-aggregated appends, large groups into slots;
//   - groups of 33 to kSelSmall (1,024) rows: persistent warps, one a
//     (listed group, step), sort the keys in shared memory (bitonic,
//     padded to a power of two) and read every rank set;
//   - larger groups (topk/bottomk without grouping: ng = 1 over 2^20
//     series): an MSD radix select per (rank set, group, step) over the
//     32-bit keys, 8 bits a pass, four launches.  [S, T] is read in place
//     through row_order (blocks stage 256 rows x their steps in shared
//     memory; no transposed copy); a warp owns a step, so each histogram
//     in shared memory is the warp's own (no other warp's atomics on the
//     shared top byte), and a block adds each nonzero bin once into the
//     group's global histogram.  The second pass writes the keys whose top
//     byte was chosen to a candidate buffer; the last two read only those.
//     The last block of a (group, step slice) to finish a pass picks the
//     digits (a warp a task), so no separate pick launch.
//   Bound: bytes.  Small groups: [S, T] once, ranks and out once.  Large
//   groups: [S, T] twice plus the candidates of the first digit written
//   once and read twice, against a one-read bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "scan.cuh"

namespace {

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

constexpr int kRows = 32;          // rows folded by one thread per chunk
constexpr int kRedThreads = 256;   // 8 warps
constexpr int kWarpRows = 32 * kRows;
constexpr int kPrivBytes = 48 * 1024;
constexpr int kWideC = 16;         // columns of one wide launch

// The value columns of one launch, passed by value: element (i, c) is
// p[c][i * ld].  Separate [N] columns (ld 1) need no stacked copy; a
// row-major [N, C] matrix is p[c] = base + c, ld = C.
template <typename T>
struct Cols {
  const T* p[kWideC];
  long long ld;
};

template <typename T>
Cols<T> make_cols(const void* const* ptrs, int C, long long ld) {
  Cols<T> cols{};
  for (int c = 0; c < C && c < kWideC; ++c) {
    cols.p[c] = ptrs != nullptr ? (const T*)ptrs[c] : nullptr;
  }
  cols.ld = ld;
  return cols;
}

__device__ __forceinline__ unsigned long long d2key(double f) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(f);
  return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
}
__device__ __forceinline__ double key2d(unsigned long long k) {
  return __longlong_as_double((long long)((k & 0x8000000000000000ull)
                                              ? (k & 0x7fffffffffffffffull)
                                              : ~k));
}

__device__ __forceinline__ bool is_nan(float x) { return isnan(x); }
__device__ __forceinline__ bool is_nan(double x) { return isnan(x); }
__device__ __forceinline__ bool is_nan(long long) { return false; }

// Accumulator of one (type, op): the value kept in registers, shared and
// device memory.  float/double min/max keep order-preserving keys and are
// decoded in place at the end (`decode`).
template <typename T, int OP>
struct Red;

template <>
struct Red<float, OP_SUM> {
  using Acc = float;
  static constexpr bool kKeyed = false;
  __device__ static Acc identity() { return 0.0f; }
  __device__ static Acc lift(float v) { return v; }
  __device__ static Acc combine(Acc a, Acc b) { return a + b; }
  __device__ static void atomic(Acc* p, Acc v) { atomicAdd(p, v); }
};
template <>
struct Red<double, OP_SUM> {
  using Acc = double;
  static constexpr bool kKeyed = false;
  __device__ static Acc identity() { return 0.0; }
  __device__ static Acc lift(double v) { return v; }
  __device__ static Acc combine(Acc a, Acc b) { return a + b; }
  __device__ static void atomic(Acc* p, Acc v) { atomicAdd(p, v); }
};
template <>
struct Red<long long, OP_SUM> {
  using Acc = unsigned long long;  // wraps exactly, as int64 sums do
  static constexpr bool kKeyed = false;
  __device__ static Acc identity() { return 0ull; }
  __device__ static Acc lift(long long v) { return (Acc)v; }
  __device__ static Acc combine(Acc a, Acc b) { return a + b; }
  __device__ static void atomic(Acc* p, Acc v) { atomicAdd(p, v); }
};
template <int OP>
struct RedKeyF {
  using Acc = unsigned int;
  static constexpr bool kKeyed = true;
  __device__ static Acc identity() {
    return f32_key(OP == OP_MIN ? INFINITY : -INFINITY);
  }
  __device__ static Acc lift(float v) { return f32_key(v); }
  __device__ static Acc combine(Acc a, Acc b) {
    return OP == OP_MIN ? (a < b ? a : b) : (a > b ? a : b);
  }
  __device__ static void atomic(Acc* p, Acc v) {
    if (OP == OP_MIN) atomicMin(p, v); else atomicMax(p, v);
  }
};
template <int OP>
struct RedKeyD {
  using Acc = unsigned long long;
  static constexpr bool kKeyed = true;
  __device__ static Acc identity() {
    return d2key(OP == OP_MIN ? (double)INFINITY : -(double)INFINITY);
  }
  __device__ static Acc lift(double v) { return d2key(v); }
  __device__ static Acc combine(Acc a, Acc b) {
    return OP == OP_MIN ? (a < b ? a : b) : (a > b ? a : b);
  }
  __device__ static void atomic(Acc* p, Acc v) {
    if (OP == OP_MIN) atomicMin(p, v); else atomicMax(p, v);
  }
};
template <int OP>
struct RedI64 {
  using Acc = long long;
  static constexpr bool kKeyed = false;
  __device__ static Acc identity() {
    return OP == OP_MIN ? kI64Max : (-kI64Max - 1);
  }
  __device__ static Acc lift(long long v) { return v; }
  __device__ static Acc combine(Acc a, Acc b) {
    return OP == OP_MIN ? (a < b ? a : b) : (a > b ? a : b);
  }
  __device__ static void atomic(Acc* p, Acc v) {
    if (OP == OP_MIN) atomicMin(p, v); else atomicMax(p, v);
  }
};
template <> struct Red<float, OP_MIN> : RedKeyF<OP_MIN> {};
template <> struct Red<float, OP_MAX> : RedKeyF<OP_MAX> {};
template <> struct Red<double, OP_MIN> : RedKeyD<OP_MIN> {};
template <> struct Red<double, OP_MAX> : RedKeyD<OP_MAX> {};
template <> struct Red<long long, OP_MIN> : RedI64<OP_MIN> {};
template <> struct Red<long long, OP_MAX> : RedI64<OP_MAX> {};

// ---------------------------------------------------------------------------
// segment_reduce
// ---------------------------------------------------------------------------

template <typename T, int OP>
__global__ void seg_init_kernel(typename Red<T, OP>::Acc* acc,
                                unsigned long long* cnt, int ns, int C,
                                long long ldo) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)ns * C) return;
  const long long s = k / C, c = k - s * C;
  if (acc != nullptr) acc[s * ldo + c] = Red<T, OP>::identity();
  cnt[s * ldo + c] = 0ull;
}

template <typename T, int OP>
__global__ void seg_decode_kernel(typename Red<T, OP>::Acc* acc, int ns,
                                  int C, long long ldo) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)ns * C) return;
  const long long s = k / C, c = k - s * C;
  const long long at = s * ldo + c;
  if constexpr (sizeof(typename Red<T, OP>::Acc) == 4) {
    reinterpret_cast<float*>(acc)[at] = f32_of_key((unsigned int)acc[at]);
  } else {
    reinterpret_cast<double*>(acc)[at] =
        key2d((unsigned long long)acc[at]);
  }
}

template <typename T, int OP, int CMAX, bool PRIV>
__device__ __forceinline__ void seg_flush(
    int seg, const typename Red<T, OP>::Acc* acc, const unsigned int* cnt,
    int C, typename Red<T, OP>::Acc* s_acc, unsigned int* s_cnt,
    typename Red<T, OP>::Acc* acc_out, unsigned long long* cnt_out,
    long long ldo) {
  using R = Red<T, OP>;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C && cnt[c] > 0) {
      if (PRIV) {
        R::atomic(&s_acc[seg * C + c], acc[c]);
        atomicAdd(&s_cnt[seg * C + c], cnt[c]);
      } else {
        if (acc_out != nullptr) R::atomic(&acc_out[seg * ldo + c], acc[c]);
        atomicAdd(&cnt_out[seg * ldo + c], (unsigned long long)cnt[c]);
      }
    }
  }
}

// Close the warp's open run: a fixed shuffle tree sums the lanes' shares
// into lane 0, which flushes them; every lane's share restarts empty.
template <typename T, int OP, int CMAX, bool PRIV>
__device__ __forceinline__ void seg_close(
    int run, typename Red<T, OP>::Acc* acc, unsigned int* cnt, int C,
    typename Red<T, OP>::Acc* s_acc, unsigned int* s_cnt,
    typename Red<T, OP>::Acc* acc_out, unsigned long long* cnt_out,
    long long ldo) {
  using R = Red<T, OP>;
  if (run < 0) return;  // warp-uniform
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[c] = R::combine(acc[c], __shfl_down_sync(0xffffffffu, acc[c], off));
        cnt[c] += __shfl_down_sync(0xffffffffu, cnt[c], off);
      }
    }
  }
  if ((threadIdx.x & 31) == 0) {
    seg_flush<T, OP, CMAX, PRIV>(run, acc, cnt, C, s_acc, s_cnt, acc_out,
                                 cnt_out, ldo);
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    acc[c] = R::identity();
    cnt[c] = 0u;
  }
}

template <typename T, int OP, int CMAX, bool PRIV>
__global__ void __launch_bounds__(kRedThreads) segment_reduce_kernel(
    const Cols<T> v, int C,
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ mask,
    long long n, int ns, long long span,
    typename Red<T, OP>::Acc* __restrict__ acc_out, long long ldo,
    unsigned long long* __restrict__ cnt_out) {
  using R = Red<T, OP>;
  using Acc = typename R::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* s_acc = reinterpret_cast<Acc*>(smem);
  unsigned int* s_cnt =
      reinterpret_cast<unsigned int*>(smem + sizeof(Acc) * (size_t)ns * C);
  if (PRIV) {
    for (int k = threadIdx.x; k < ns * C; k += blockDim.x) {
      s_acc[k] = R::identity();
      s_cnt[k] = 0u;
    }
    __syncthreads();
  }
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b0 = (long long)blockIdx.x * span;
  const long long b1 = b0 + span < n ? b0 + span : n;
  const bool counts_only = v.p[0] == nullptr;
  for (long long w0 = b0 + (long long)warp * kWarpRows; w0 < b1;
       w0 += (long long)(kRedThreads / 32) * kWarpRows) {
    // The warp's open run (warp-uniform id) and this lane's share of it.
    int run = -1;
    Acc acc[CMAX];
    unsigned int cnt[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      acc[c] = R::identity();
      cnt[c] = 0u;
    }
    for (int j = 0; j < kRows; ++j) {
      // step j: lane l takes row w0 + 32 j + l, so every load is coalesced
      const long long i = w0 + (long long)j * 32 + lane;
      // all of the step's loads issue together (one memory round trip);
      // the mask applies after them
      int id = -1;  // -1: no live row here
      T xr[CMAX];
      if (i < b1) {
        const int raw = ids[i];
        const bool on = mask == nullptr || mask[i] != 0;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < C && !counts_only) xr[c] = v.p[c][i * v.ld];
        }
        if (on && raw >= 0 && raw < ns) id = raw;
      }
      Acc xv[CMAX];
      unsigned int xc[CMAX];
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        xv[c] = R::identity();
        xc[c] = 0u;
        if (c < C && id >= 0 && (counts_only || !is_nan(xr[c]))) {
          if (!counts_only) xv[c] = R::lift(xr[c]);
          xc[c] = 1u;
        }
      }
      if (__all_sync(full, id < 0 || id == run)) {
        // the common case on sorted ids: the whole step continues the run
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          acc[c] = R::combine(acc[c], xv[c]);
          cnt[c] += xc[c];
        }
        continue;
      }
      // A boundary: this step's rows of the open run join it, the run
      // closes, and the other rows merge by a segmented shuffle scan over
      // consecutive equal ids.  Each finished segment flushes from its
      // last lane; the last segment of the step becomes the open run.
      if (id >= 0 && id == run) {
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          acc[c] = R::combine(acc[c], xv[c]);
          cnt[c] += xc[c];
        }
        id = -1;
      }
      seg_close<T, OP, CMAX, PRIV>(run, acc, cnt, C, s_acc, s_cnt, acc_out,
                                   cnt_out, ldo);
      const unsigned rest = __ballot_sync(full, id >= 0);
      const int last = 31 - __clz(rest);
      const int key = id >= 0 ? id : -1 - lane;  // idle lanes never merge
      const int prev = __shfl_up_sync(full, key, 1);
      const unsigned heads = __ballot_sync(full, lane == 0 || prev != key);
      const int start = 31 - __clz(heads & (full >> (31 - lane)));
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < C) {
            const Acc oa = __shfl_up_sync(full, xv[c], off);
            const unsigned int oc = __shfl_up_sync(full, xc[c], off);
            if (lane - off >= start) {
              xv[c] = R::combine(oa, xv[c]);
              xc[c] += oc;
            }
          }
        }
      }
      const int next = __shfl_down_sync(full, key, 1);
      run = __shfl_sync(full, id, last);
      if (id >= 0 && (lane == 31 || next != key)) {
        if (lane == last) {
#pragma unroll
          for (int c = 0; c < CMAX; ++c) {
            acc[c] = xv[c];
            cnt[c] = xc[c];
          }
        } else {
          seg_flush<T, OP, CMAX, PRIV>(id, xv, xc, C, s_acc, s_cnt, acc_out,
                                       cnt_out, ldo);
        }
      }
    }
    seg_close<T, OP, CMAX, PRIV>(run, acc, cnt, C, s_acc, s_cnt, acc_out,
                                 cnt_out, ldo);
  }
  if (PRIV) {
    __syncthreads();
    for (int k = threadIdx.x; k < ns * C; k += blockDim.x) {
      if (s_cnt[k] > 0u) {
        const int s = k / C, c = k - s * C;
        if (acc_out != nullptr) R::atomic(&acc_out[s * ldo + c], s_acc[k]);
        atomicAdd(&cnt_out[s * ldo + c], (unsigned long long)s_cnt[k]);
      }
    }
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T, int OP, int CMAX, bool PRIV>
int launch_reduce_mode(const Cols<T>& v, int C, const int32_t* ids,
                       const uint8_t* mask, long long n, int ns,
                       typename Red<T, OP>::Acc* acc, long long ldo,
                       unsigned long long* cnt, cudaStream_t st) {
  using Acc = typename Red<T, OP>::Acc;
  const long long per_block = (long long)(kRedThreads / 32) * kWarpRows;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = (long long)num_sms() * (PRIV ? 4 : 8);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  long long span = (n + blocks - 1) / blocks;
  span = (span + kWarpRows - 1) / kWarpRows * kWarpRows;
  const size_t smem = PRIV ? (sizeof(Acc) + 4) * (size_t)ns * C : 0;
  segment_reduce_kernel<T, OP, CMAX, PRIV>
      <<<(unsigned)blocks, kRedThreads, smem, st>>>(
          v, C, ids, mask, n, ns, span, acc, ldo, cnt);
  return last_error();
}

template <typename T, int OP>
int launch_reduce(const Cols<T>& v, int C, const int32_t* ids,
                  const uint8_t* mask, long long n, int ns, void* out,
                  long long ldo, long long* cnt_out, cudaStream_t st) {
  using R = Red<T, OP>;
  using Acc = typename R::Acc;
  Acc* acc = reinterpret_cast<Acc*>(out);
  unsigned long long* cnt = reinterpret_cast<unsigned long long*>(cnt_out);
  const long long slots = (long long)ns * C;
  if (slots <= 0) return last_error();
  seg_init_kernel<T, OP><<<blocks_for(slots), kThreads, 0, st>>>(
      acc, cnt, ns, C, ldo);
  if (int e = last_error()) return e;
  if (n > 0) {
    const bool priv = (sizeof(Acc) + 4) * slots <= (long long)kPrivBytes;
    int e;
    if (C == 1) {
      e = priv ? launch_reduce_mode<T, OP, 1, true>(v, C, ids, mask, n, ns,
                                                    acc, ldo, cnt, st)
               : launch_reduce_mode<T, OP, 1, false>(v, C, ids, mask, n, ns,
                                                     acc, ldo, cnt, st);
    } else if constexpr (std::is_same<T, float>::value) {
      if (C > kWideC) return (int)cudaErrorInvalidValue;
      e = priv ? launch_reduce_mode<T, OP, kWideC, true>(
                     v, C, ids, mask, n, ns, acc, ldo, cnt, st)
               : launch_reduce_mode<T, OP, kWideC, false>(
                     v, C, ids, mask, n, ns, acc, ldo, cnt, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    if (e) return e;
  }
  if constexpr (R::kKeyed) {
    if (acc != nullptr) {
      seg_decode_kernel<T, OP><<<blocks_for(slots), kThreads, 0, st>>>(
          acc, ns, C, ldo);
      if (int e = last_error()) return e;
    }
  }
  return 0;
}

template <typename T>
int dispatch_reduce(int op, const void* const* cols, long long ld, int C,
                    const int32_t* ids, const uint8_t* mask, long long n,
                    int ns, void* out, long long ldo, long long* cnt,
                    cudaStream_t st) {
  if (C < 1 || C > kWideC) return (int)cudaErrorInvalidValue;
  const Cols<T> v = make_cols<T>(cols, C, ld);
  switch (op) {
    case OP_SUM:
      return launch_reduce<T, OP_SUM>(v, C, ids, mask, n, ns, out, ldo, cnt,
                                      st);
    case OP_MIN:
      return launch_reduce<T, OP_MIN>(v, C, ids, mask, n, ns, out, ldo, cnt,
                                      st);
    case OP_MAX:
      return launch_reduce<T, OP_MAX>(v, C, ids, mask, n, ns, out, ldo, cnt,
                                      st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// sorted_segment_reduce
// ---------------------------------------------------------------------------

__global__ void segment_bounds_kernel(const int32_t* __restrict__ ids,
                                      long long n, int ns,
                                      long long* __restrict__ starts,
                                      long long* __restrict__ ends) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  long long lo = 0, hi = n;  // first index with ids[i] >= s
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ids[mid] < s) lo = mid + 1; else hi = mid;
  }
  starts[s] = lo;
  hi = n;  // first index with ids[i] > s
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ids[mid] <= s) lo = mid + 1; else hi = mid;
  }
  ends[s] = lo;
}

// Value-domain accumulator of the sorted reduction (no atomics, no keys).
template <typename T, int OP>
struct SRed {
  using Acc = T;
  __device__ static T identity() {
    if (OP == OP_SUM) return T(0);
    return OP == OP_MIN ? T(INFINITY) : T(-INFINITY);
  }
  __device__ static T combine(T a, T b) {
    if (OP == OP_SUM) return a + b;
    return OP == OP_MIN ? (b < a ? b : a) : (b > a ? b : a);
  }
};
template <int OP>
struct SRed<long long, OP> {
  using Acc = unsigned long long;  // int64 sums wrap exactly
  __device__ static Acc identity() {
    if (OP == OP_SUM) return 0ull;
    return (Acc)(OP == OP_MIN ? kI64Max : (-kI64Max - 1));
  }
  __device__ static Acc combine(Acc a, Acc b) {
    if (OP == OP_SUM) return a + b;
    const long long x = (long long)a, y = (long long)b;
    return (Acc)(OP == OP_MIN ? (y < x ? y : x) : (y > x ? y : x));
  }
};

template <typename T, int OP>
__global__ void sorted_reduce_kernel(
    const Cols<T> v, int C,
    const uint8_t* __restrict__ mask, const long long* __restrict__ starts,
    const long long* __restrict__ ends, int ns, T* __restrict__ out,
    long long ldo, long long* __restrict__ cnt_out) {
  using R = SRed<T, OP>;
  using Acc = typename R::Acc;
  const long long seg = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                        >> 5;
  if (seg >= ns) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long lo = starts[seg], hi = ends[seg];
  const bool counts_only = v.p[0] == nullptr;
#pragma unroll
  for (int c = 0; c < kWideC; ++c) {
    if (c >= C) break;
    Acc acc = R::identity();
    long long cnt = 0;
    for (long long i = lo + lane; i < hi; i += 32) {
      // masked rows skip their value loads: WHERE-excluded rows come in
      // whole blocks of a series (outside the time window)
      if (mask != nullptr && mask[i] == 0) continue;
      if (counts_only) {
        ++cnt;
        continue;
      }
      const T x = v.p[c][i * v.ld];
      if (!is_nan(x)) {
        acc = R::combine(acc, (Acc)x);
        ++cnt;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Acc oa = __shfl_down_sync(0xffffffffu, acc, off);
      const long long oc = __shfl_down_sync(0xffffffffu, cnt, off);
      acc = R::combine(acc, oa);
      cnt += oc;
    }
    if (lane == 0) {
      if (out != nullptr) out[seg * ldo + c] = (T)acc;
      cnt_out[seg * ldo + c] = cnt;
    }
  }
}

template <typename T>
int dispatch_sorted(int op, const void* const* cols, long long ld, int C,
                    const uint8_t* mask, const long long* starts,
                    const long long* ends, int ns, T* out, long long ldo,
                    long long* cnt, cudaStream_t st) {
  if (ns <= 0) return last_error();
  if (C < 1 || C > kWideC) return (int)cudaErrorInvalidValue;
  const Cols<T> v = make_cols<T>(cols, C, ld);
  const long long threads = (long long)ns * 32;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  switch (op) {
    case OP_SUM:
      sorted_reduce_kernel<T, OP_SUM><<<grid, kThreads, 0, st>>>(
          v, C, mask, starts, ends, ns, out, ldo, cnt);
      return last_error();
    case OP_MIN:
      sorted_reduce_kernel<T, OP_MIN><<<grid, kThreads, 0, st>>>(
          v, C, mask, starts, ends, ns, out, ldo, cnt);
      return last_error();
    case OP_MAX:
      sorted_reduce_kernel<T, OP_MAX><<<grid, kThreads, 0, st>>>(
          v, C, mask, starts, ends, ns, out, ldo, cnt);
      return last_error();
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// compact
// ---------------------------------------------------------------------------

struct MaskSrc {  // 1 where the row is kept
  const uint8_t* mask;
  __device__ int operator()(long long i) const { return mask[i] != 0; }
};

struct KeyChangeSrc {  // 1 where the sorted key differs from the previous
  const long long* key;
  const int32_t* order;
  __device__ int operator()(long long i) const {
    return i > 0 && key[order[i]] != key[order[i - 1]] ? 1 : 0;
  }
};

__global__ void compact_order_kernel(const uint8_t* __restrict__ mask,
                                     const int32_t* __restrict__ incl,
                                     long long n,
                                     int32_t* __restrict__ order) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (mask[i] != 0) order[incl[i] - 1] = (int32_t)i;
}

template <typename E>
__global__ void gather_kernel(const E* __restrict__ src,
                              const int32_t* __restrict__ order, long long n,
                              E* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  dst[i] = src[order[i]];
}

__global__ void fill_i64_kernel(long long* p, long long n, long long value) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = value;
}

__global__ void rank_scatter_kernel(
    const long long* __restrict__ key, const int32_t* __restrict__ order,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ rank,
    long long n, long long num_groups, int32_t* __restrict__ dense,
    long long* __restrict__ group_keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = order[i];
  const int32_t rk = rank[i];
  const long long k = key[r];
  dense[r] = valid[r] != 0 ? rk : (int32_t)num_groups;
  // every row of a rank writes the same key, so the race is benign; ranks
  // past the overflow slot are dropped, as JAX drops out-of-bounds scatters
  if (k != kI64Max && (long long)rk <= num_groups) group_keys[rk] = k;
}

// ---------------------------------------------------------------------------
// radix_argsort
// ---------------------------------------------------------------------------

// acc: [0] min, [1] max over the valid rows, [2] any valid row
__global__ void argsort_init_kernel(long long* acc) {
  acc[0] = kI64Max;
  acc[1] = -kI64Max - 1;
  acc[2] = 0;
}

__global__ void argsort_minmax_kernel(const long long* __restrict__ key,
                                      const uint8_t* __restrict__ valid,
                                      long long n, long long* acc) {
  long long lo = kI64Max, hi = -kI64Max - 1, any = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (valid == nullptr || valid[i] != 0) {
      const long long k = key[i];
      lo = k < lo ? k : lo;
      hi = k > hi ? k : hi;
      any = 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const long long olo = __shfl_down_sync(0xffffffffu, lo, off);
    const long long ohi = __shfl_down_sync(0xffffffffu, hi, off);
    const long long oan = __shfl_down_sync(0xffffffffu, any, off);
    lo = olo < lo ? olo : lo;
    hi = ohi > hi ? ohi : hi;
    any = oan > any ? oan : any;
  }
  if ((threadIdx.x & 31) == 0 && any) {
    atomicMin(&acc[0], lo);
    atomicMax(&acc[1], hi);
    atomicMax(&acc[2], any);
  }
}

// scal: [0] the invalid rows' relative key (the largest one), [1] 1 when
// the valid keys span all 2^64 values (no room above them)
__global__ void argsort_key_kernel(const long long* __restrict__ key,
                                   const uint8_t* __restrict__ valid,
                                   long long n, const long long* acc,
                                   long long* __restrict__ rel,
                                   int32_t* __restrict__ idx,
                                   long long* scal) {
  const bool any = acc[2] != 0;
  const unsigned long long mn = any ? (unsigned long long)acc[0] : 0ull;
  const unsigned long long mx = any ? (unsigned long long)acc[1] : 0ull;
  const unsigned long long range = mx - mn;
  const bool full = range == ~0ull;
  const unsigned long long inv = full ? 0ull : range + 1ull;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    scal[0] = (long long)inv;
    scal[1] = full ? 1 : 0;
  }
  if (i >= n) return;
  const bool ok = valid == nullptr || valid[i] != 0;
  rel[i] = (long long)(ok ? (unsigned long long)key[i] - mn : inv);
  idx[i] = (int32_t)i;
}

// ---------------------------------------------------------------------------
// segment_select
// ---------------------------------------------------------------------------

constexpr int kSelTiny = 32;      // largest group a thread selects in
constexpr int kSelSmall = 1024;   // largest group a warp sorts
constexpr int kSelWarps = 8;
constexpr int kSelMidBlocks = 1056;  // 8 a streaming multiprocessor
constexpr int kSelBins = 256;
constexpr int kSelChunk = 1024;   // positions of row_order a pass block
constexpr int kSelTile = 256;     // rows a pass block stages at a time
constexpr int kSelBatch = 8;      // candidate loads a lane has in flight
constexpr int kSelHistCap = 64;   // rank sets x steps of a pass block
constexpr unsigned kSelFull = 0xffffffffu;

// Arguments and scratch of one segment_select call (select_layout).
struct SelArgs {
  const float* values;
  long long T;
  const int32_t* row_order;
  const long long* offsets;
  long long ng;
  const int32_t* ranks;
  int R;
  float* out;
  long long S;
  int* ctr;              // [0] mid groups, [1] large groups
  int32_t* slot_of;      // [ng]: a large group's slot
  int32_t* mid_list;     // [max_mid]
  unsigned* slots;       // [nslots][slot_words]: histograms, done counts
  long long slot_words;
  unsigned* prefix;      // [R][nslots][T]: the key's digits chosen so far
  int32_t* want;         // [R][nslots][T]: the rank left among them
  unsigned* cand;        // [R][T][S]: candidates of a (rank set, step)
  int32_t* cand_cnt;     // [R][T][nchunks][2]
  long long max_mid, nslots, nchunks;
  int TS, nslices;
};

// Scratch bytes of a call, and the pointers into it (base may be null to
// size only).  Small and mid groups need the counters, slot_of and
// mid_list; large groups (> kSelSmall rows: at most S / 1025 of them)
// the rest.
inline long long select_layout(SelArgs& a, unsigned char* base) {
  a.max_mid = a.S / (kSelTiny + 1) < a.ng ? a.S / (kSelTiny + 1) : a.ng;
  a.nslots = a.S / (kSelSmall + 1) < a.ng ? a.S / (kSelSmall + 1) : a.ng;
  a.nchunks = (a.S + kSelChunk - 1) / kSelChunk;
  int ts = kSelHistCap / a.R;
  ts = ts < 32 ? ts : 32;
  ts = ts < 1 ? 1 : ts;
  a.TS = a.T < ts ? (int)a.T : ts;
  a.nslices = a.TS > 0 ? (int)((a.T + a.TS - 1) / a.TS) : 0;
  a.slot_words =
      ((long long)a.R * a.T * kSelBins + 4LL * a.nslices + 3) & ~3LL;
  const bool large = a.nslots > 0;
  long long off = 0;
  auto take = [&](long long bytes) {
    const long long at = off;
    off += (bytes + 255) & ~255LL;
    return base == nullptr ? nullptr : base + at;
  };
  a.ctr = (int*)take(2 * sizeof(int));
  a.slot_of = (int32_t*)take(a.ng * 4);
  a.mid_list = (int32_t*)take(a.max_mid * 4);
  a.slots = (unsigned*)take(large ? a.nslots * a.slot_words * 4 : 0);
  a.prefix = (unsigned*)take(large ? (long long)a.R * a.nslots * a.T * 4 : 0);
  a.want = (int32_t*)take(large ? (long long)a.R * a.nslots * a.T * 4 : 0);
  a.cand = (unsigned*)take(large ? (long long)a.R * a.T * a.S * 4 : 0);
  a.cand_cnt =
      (int32_t*)take(large ? (long long)a.R * a.T * a.nchunks * 2 * 4 : 0);
  return off;
}

// The value at each rank set's rank of a group of up to P keys: the keys
// in registers (padded with kPadKey, above every sort key), an ascending
// bitonic network unrolled at compile time, then the rank picked by
// compare-and-select (no dynamic register index).
template <int P>
__device__ __forceinline__ void tiny_select(const SelArgs& a, long long g,
                                            long long t, long long off,
                                            int size) {
  uint32_t k[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    k[j] = j < size ? f32_sort_key(
                          a.values[(long long)a.row_order[off + j] * a.T + t])
                    : kPadKey;
  }
#pragma unroll
  for (int kk = 2; kk <= P; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int p = i ^ j;
        if (p > i) {
          const uint32_t x = k[i], y = k[p];
          const uint32_t lo = x < y ? x : y, hi = x < y ? y : x;
          k[i] = (i & kk) == 0 ? lo : hi;
          k[p] = (i & kk) == 0 ? hi : lo;
        }
      }
    }
  }
  for (int r = 0; r < a.R; ++r) {
    const long long o = ((long long)r * a.ng + g) * a.T + t;
    int rr = a.ranks[o];
    rr = rr < 0 ? 0 : (rr >= size ? size - 1 : rr);
    uint32_t v = k[0];
#pragma unroll
    for (int j = 1; j < P; ++j) v = j == rr ? k[j] : v;
    a.out[o] = size > 0 ? f32_of_key(v) : NAN;
  }
}

// One thread a (group, step), consecutive threads on consecutive steps:
// a warp reads a series' T consecutive floats.  Groups of up to kSelTiny
// rows are answered here; the step-0 thread of a larger group files it:
// mid groups into mid_list (warp-aggregated appends), large groups get a
// slot.
__global__ void __launch_bounds__(kThreads) select_tiny_kernel(SelArgs a) {
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = q < a.ng * a.T;
  long long g = 0, t = 0, off = 0, size = 0;
  if (live) {
    g = q / a.T;
    t = q - g * a.T;
    off = a.offsets[g];
    size = a.offsets[g + 1] - off;
  }
  const bool mid = live && t == 0 && size > kSelTiny && size <= kSelSmall;
  const unsigned mm = __ballot_sync(kSelFull, mid);
  if (mm != 0) {
    const int leader = __ffs((int)mm) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(&a.ctr[0], __popc(mm));
    at = __shfl_sync(kSelFull, at, leader);
    if (mid) a.mid_list[at + __popc(mm & ((1u << lane) - 1u))] = (int32_t)g;
  }
  if (live && t == 0 && size > kSelSmall) {
    a.slot_of[g] = atomicAdd(&a.ctr[1], 1);
  }
  if (!live || size > kSelTiny) return;
  if (size <= 4) {
    tiny_select<4>(a, g, t, off, (int)size);
  } else if (size <= 8) {
    tiny_select<8>(a, g, t, off, (int)size);
  } else if (size <= 16) {
    tiny_select<16>(a, g, t, off, (int)size);
  } else {
    tiny_select<32>(a, g, t, off, (int)size);
  }
}

// Persistent warps: first zero the large groups' histograms and done
// counts (their slots are known now), then one warp a (mid group, step)
// sorts the group's keys in shared memory (bitonic, padded to a power of
// two) and reads every rank set.
__global__ void __launch_bounds__(kSelWarps * 32)
    select_mid_kernel(SelArgs a) {
  __shared__ uint32_t sm[kSelWarps][kSelSmall];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long quads = (long long)a.ctr[1] * a.slot_words / 4;
  uint4* z = reinterpret_cast<uint4*>(a.slots);
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < quads; w += stride) {
    z[w] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tasks = (long long)a.ctr[0] * a.T;
  for (long long task = (long long)blockIdx.x * kSelWarps + warp;
       task < tasks; task += (long long)gridDim.x * kSelWarps) {
    const long long gi = task / a.T;
    const long long t = task - gi * a.T;
    const long long g = a.mid_list[gi];
    const long long off = a.offsets[g];
    const int size = (int)(a.offsets[g + 1] - off);
    int P = 1;
    while (P < size) P <<= 1;
    uint32_t* buf = sm[warp];
    for (int j = lane; j < P; j += 32) {
      buf[j] = j < size ? f32_sort_key(
                              a.values[(long long)a.row_order[off + j] * a.T +
                                       t])
                        : kPadKey;
    }
    __syncwarp();
    warp_bitonic_sort(buf, P, lane);
    if (lane < a.R) {
      const long long o = ((long long)lane * a.ng + g) * a.T + t;
      int r = a.ranks[o];
      r = r < 0 ? 0 : (r >= size ? size - 1 : r);
      a.out[o] = f32_of_key(buf[r]);
    }
    __syncwarp();  // buf is rewritten by the warp's next task
  }
}

// Count `bin` of an active lane into the warp's own shared histogram (a
// warp owns its steps, so no other warp touches these bins).  One
// atomicAdd a lane: on the H100 this timed faster than aggregating the
// lanes of a bin first with __match_any_sync, whose cost every group of
// 32 pays, even where a step's keys share their top byte.
__device__ __forceinline__ void hist_add(unsigned* h, unsigned bin,
                                         bool act) {
  if (act) atomicAdd(&h[bin], 1u);
}

// The group holding position p of row_order (offsets[g] <= p <
// offsets[g + 1]; p < offsets[ng]).
__device__ __forceinline__ long long group_of(const long long* offsets,
                                              long long ng, long long p) {
  long long lo = 0, hi = ng;  // the last g with offsets[g] <= p
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (offsets[mid] <= p) lo = mid; else hi = mid;
  }
  return lo;
}

// One MSD radix-select pass over the large groups: 8 bits of the sort
// key a pass, from the top (pass 0, shift 24) down.  Block (c, slice)
// takes the positions [c * kSelChunk, +kSelChunk) of row_order and the
// steps [slice * TS, +TS); a large group has more rows than a chunk, so
// at most two meet it.  Per (rank set, step) a warp owns the step and
// counts into its own shared histogram (hist_add), then the block adds
// each nonzero bin once into the group's slot.  Passes 0 and 1 stage the
// rows (row_order's order, [S, T] read in place: no transposed copy) in a
// shared tile; pass 1 also writes the keys whose top byte is the chosen
// one to cand (compaction after the first digit), in the chunk's part of
// the (rank set, step) region, and passes 2 and 3 read only those (pass 2
// compacts them again in place).  The last block of a (group, slice) to
// flush (a done count per pass) picks each task's digit: one warp a task,
// 8 bins a lane and a warp scan; pass 3 writes the value.
template <int pass>
__global__ void __launch_bounds__(kThreads) select_pass_kernel(SelArgs a) {
  extern __shared__ unsigned sel_smem[];
  __shared__ long long s_lo, s_hi, s_g[2];
  __shared__ int s_n, s_last;
  if (a.ctr[1] == 0) return;  // no large group: block-uniform
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  constexpr int shift = 24 - 8 * pass;
  const long long c = blockIdx.x / a.nslices;
  const int slice = (int)(blockIdx.x - c * a.nslices);
  const long long t0 = (long long)slice * a.TS;
  const int tn = (int)(a.T - t0 < a.TS ? a.T - t0 : a.TS);
  const long long pend = a.offsets[a.ng];
  const long long lo = c * kSelChunk;
  if (lo >= pend) return;  // positions past every group: block-uniform
  const long long hi = lo + kSelChunk < pend ? lo + kSelChunk : pend;
  const int Rh = pass == 0 ? 1 : a.R;  // pass 0's histogram serves every r
  const int stride = a.TS | 1;          // odd: conflict-free column reads
  unsigned* hist = sel_smem;                              // [R][TS][256]
  unsigned* pre = hist + (long long)a.R * a.TS * kSelBins;  // [R][TS]
  int* cbase = (int*)(pre + a.R * a.TS);                  // [R][TS]
  int* rowid = cbase + a.R * a.TS;                        // [kSelTile]
  float* tile = (float*)(rowid + kSelTile);               // [kSelTile][stride]

  if (threadIdx.x == 0) {
    s_n = 0;
    s_lo = group_of(a.offsets, a.ng, lo);
    s_hi = group_of(a.offsets, a.ng, hi - 1);
  }
  __syncthreads();
  for (long long g = s_lo + threadIdx.x; g <= s_hi; g += blockDim.x) {
    if (a.offsets[g + 1] - a.offsets[g] > kSelSmall) {
      s_g[atomicAdd(&s_n, 1)] = g;
    }
  }
  __syncthreads();
  for (int e = 0; e < s_n; ++e) {
    const long long g = s_g[e];
    const long long goff = a.offsets[g];
    const long long gend = a.offsets[g + 1];
    const long long seg_a = goff > lo ? goff : lo;
    const long long seg_b = gend < hi ? gend : hi;
    const int j = goff > lo ? 1 : 0;  // which of the chunk's two segments
    const long long slot = a.slot_of[g];
    unsigned* ghist = a.slots + slot * a.slot_words;
    for (int i = threadIdx.x; i < Rh * a.TS * kSelBins; i += blockDim.x) {
      hist[i] = 0;
    }
    for (int i = threadIdx.x; i < a.R * tn; i += blockDim.x) {
      const int r = i / tn, tl = i - r * tn;
      pre[r * a.TS + tl] =
          pass == 0 ? 0u
                    : __ldcg(&a.prefix[((long long)r * a.nslots + slot) *
                                           a.T + t0 + tl]);
      cbase[r * a.TS + tl] = 0;
    }
    __syncthreads();
    if (pass <= 1) {
      for (long long r0 = seg_a; r0 < seg_b; r0 += kSelTile) {
        const int rows = (int)(seg_b - r0 < kSelTile ? seg_b - r0 : kSelTile);
        // the row ids first, so the value loads do not wait on them
        if (threadIdx.x < rows) rowid[threadIdx.x] = a.row_order[r0 +
                                                                threadIdx.x];
        __syncthreads();
#pragma unroll 8
        for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
          const int row = i / tn, tl = i - row * tn;
          tile[row * stride + tl] =
              a.values[(long long)rowid[row] * a.T + t0 + tl];
        }
        __syncthreads();
        for (int tl = warp; tl < tn; tl += kSelWarps) {
          if (pass == 0) {
            for (int rb = 0; rb < rows; rb += 32) {
              const int row = rb + lane;
              const bool in = row < rows;
              const unsigned key =
                  in ? f32_sort_key(tile[row * stride + tl]) : 0u;
              hist_add(hist + tl * kSelBins, key >> 24, in);
            }
            continue;
          }
          for (int r = 0; r < a.R; ++r) {  // the warp owns (r, tl)
            const int ti = r * a.TS + tl;
            const unsigned top = pre[ti] >> 24;
            unsigned* dst =
                a.cand + ((long long)r * a.T + t0 + tl) * a.S + seg_a;
            int at = cbase[ti];
            for (int rb = 0; rb < rows; rb += 32) {
              const int row = rb + lane;
              const bool in = row < rows;
              const unsigned key =
                  in ? f32_sort_key(tile[row * stride + tl]) : 0u;
              const bool m = in && (key >> 24) == top;
              const unsigned bal = __ballot_sync(kSelFull, m);
              if (m) dst[at + __popc(bal & below)] = key;
              at += __popc(bal);
              hist_add(hist + ti * kSelBins, (key >> 16) & 0xffu, m);
            }
            if (lane == 0) cbase[ti] = at;
          }
        }
        __syncthreads();  // the tile is rewritten next
      }
      if (pass == 1) {
        for (int i = threadIdx.x; i < a.R * tn; i += blockDim.x) {
          const int r = i / tn, tl = i - r * tn;
          a.cand_cnt[(((long long)r * a.T + t0 + tl) * a.nchunks + c) * 2 +
                     j] = cbase[r * a.TS + tl];
        }
      }
    } else {
      const unsigned hmask =
          shift + 8 >= 32 ? 0u : 0xffffffffu << ((shift + 8) & 31);
      for (int tl = warp; tl < tn; tl += kSelWarps) {
        for (int r = 0; r < a.R; ++r) {
          const int ti = r * a.TS + tl;
          const long long ci =
              (((long long)r * a.T + t0 + tl) * a.nchunks + c) * 2 + j;
          const int cnt = a.cand_cnt[ci];
          unsigned* src =
              a.cand + ((long long)r * a.T + t0 + tl) * a.S + seg_a;
          const unsigned want_hi = pre[ti] & hmask;
          int kept = 0;
          for (int i0 = 0; i0 < cnt; i0 += 32 * kSelBatch) {
            unsigned key[kSelBatch];  // loads in flight before any use
#pragma unroll
            for (int q = 0; q < kSelBatch; ++q) {
              const int i = i0 + q * 32 + lane;
              key[q] = i < cnt ? src[i] : 0u;
            }
#pragma unroll
            for (int q = 0; q < kSelBatch; ++q) {
              const int i = i0 + q * 32 + lane;
              const bool m = i < cnt && (key[q] & hmask) == want_hi;
              const unsigned bal = __ballot_sync(kSelFull, m);
              // in place: slot kept + rank is never past i, read already
              if (pass == 2 && m) src[kept + __popc(bal & below)] = key[q];
              kept += __popc(bal);
              hist_add(hist + ti * kSelBins, (key[q] >> shift) & 0xffu, m);
            }
          }
          if (pass == 2 && lane == 0) a.cand_cnt[ci] = kept;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Rh * tn * kSelBins; i += blockDim.x) {
      const int r = i / (tn * kSelBins);
      const int rest = i - r * tn * kSelBins;
      const int tl = rest / kSelBins, bin = rest - tl * kSelBins;
      const unsigned v = hist[(r * a.TS + tl) * kSelBins + bin];
      if (v != 0) {
        atomicAdd(&ghist[((long long)r * a.T + t0 + tl) * kSelBins + bin], v);
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* done = ghist + (long long)a.R * a.T * kSelBins +
                       pass * a.nslices + slice;
      const long long chunks = (gend - 1) / kSelChunk - goff / kSelChunk + 1;
      s_last = atomicAdd(done, 1u) == (unsigned)(chunks - 1) ? 1 : 0;
    }
    __syncthreads();
    if (s_last) {  // block-uniform: every chunk of the group has flushed
      __threadfence();
      const long long size = gend - goff;
      for (int task = warp; task < a.R * tn; task += kSelWarps) {
        const int r = task / tn, tl = task - r * tn;
        const long long t = t0 + tl;
        const long long ti = ((long long)r * a.nslots + slot) * a.T + t;
        const unsigned* h =
            ghist + ((long long)(pass == 0 ? 0 : r) * a.T + t) * kSelBins;
        unsigned w;
        if (pass == 0) {
          long long rr = a.ranks[((long long)r * a.ng + g) * a.T + t];
          rr = rr < 0 ? 0 : (rr >= size ? size - 1 : rr);
          w = (unsigned)rr;
        } else {
          w = (unsigned)__ldcg(&a.want[ti]);
        }
        unsigned c8[8], sum = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          c8[q] = __ldcg(&h[lane * 8 + q]);
          sum += c8[q];
        }
        unsigned incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned v = __shfl_up_sync(kSelFull, incl, o);
          if (lane >= o) incl += v;
        }
        const unsigned excl = incl - sum;
        const unsigned hit = __ballot_sync(kSelFull, excl <= w && w < incl);
        if (lane == __ffs((int)hit) - 1) {
          unsigned cum = excl;
          int d = lane * 8 + 7;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (cum + c8[q] > w) {
              d = lane * 8 + q;
              break;
            }
            cum += c8[q];
          }
          const unsigned key =
              (pass == 0 ? 0u : __ldcg(&a.prefix[ti])) |
              ((unsigned)d << shift);
          if (pass == 3) {
            a.out[((long long)r * a.ng + g) * a.T + t] = f32_of_key(key);
          } else {
            a.prefix[ti] = key;
            a.want[ti] = (int32_t)(w - cum);
          }
        }
      }
      if (pass < 3) {  // the next pass reuses the bins
        __syncthreads();
        for (int i = threadIdx.x; i < Rh * tn * kSelBins; i += blockDim.x) {
          const int r = i / (tn * kSelBins);
          const int rest = i - r * tn * kSelBins;
          ghist[((long long)r * a.T + t0 + rest / kSelBins) * kSelBins +
                rest % kSelBins] = 0u;
        }
      }
    }
    __syncthreads();  // shared state is reset for the next segment
  }
}


template <int pass>
int launch_pass(const SelArgs& a, unsigned grid, int smem, cudaStream_t st) {
  if (int e = (int)cudaFuncSetAttribute(
          select_pass_kernel<pass>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) {
    return e;
  }
  select_pass_kernel<pass><<<grid, kThreads, smem, st>>>(a);
  return last_error();
}

}  // namespace

extern "C" {

// Scratch bytes gt_segment_select needs for these shapes.
long long gt_segment_select_scratch(long long S, long long T, long long ng,
                                    int R) {
  SelArgs a{};
  a.S = S;
  a.T = T;
  a.ng = ng;
  a.R = R;
  return select_layout(a, nullptr);
}

// values [S, T] f32; row_order [S]; offsets [ng + 1] (offsets[ng] <= S);
// ranks / out [R, ng, T] (1 <= R <= 32); scratch: the bytes
// gt_segment_select_scratch gives, 256-byte aligned.
int gt_segment_select(const float* values, long long T,
                      const int32_t* row_order, const long long* offsets,
                      long long ng, const int32_t* ranks, int R, long long S,
                      void* scratch, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ng <= 0 || T <= 0) return (int)cudaGetLastError();
  SelArgs a{};
  a.values = values;
  a.T = T;
  a.row_order = row_order;
  a.offsets = offsets;
  a.ng = ng;
  a.ranks = ranks;
  a.R = R;
  a.out = out;
  a.S = S;
  select_layout(a, (unsigned char*)scratch);
  if (int e = (int)cudaMemsetAsync(a.ctr, 0, 2 * sizeof(int), st)) return e;
  select_tiny_kernel<<<blocks_for(ng * T), kThreads, 0, st>>>(a);
  if (int e = last_error()) return e;
  if (a.max_mid > 0) {
    const long long want = (a.max_mid * T + kSelWarps - 1) / kSelWarps;
    const long long quads = a.nslots * a.slot_words / 4;
    const long long zero = (quads + kSelWarps * 32 - 1) / (kSelWarps * 32);
    long long grid = want > zero ? want : zero;
    grid = grid < kSelMidBlocks ? grid : kSelMidBlocks;
    select_mid_kernel<<<(unsigned)grid, kSelWarps * 32, 0, st>>>(a);
    if (int e = last_error()) return e;
  }
  if (a.nslots > 0) {
    const int smem = (int)(((long long)a.R * a.TS * (kSelBins + 2) +
                            (long long)kSelTile * ((a.TS | 1) + 1)) * 4);
    const unsigned grid = (unsigned)(a.nchunks * a.nslices);
    if (int e = launch_pass<0>(a, grid, smem, st)) return e;
    if (int e = launch_pass<1>(a, grid, smem, st)) return e;
    if (int e = launch_pass<2>(a, grid, smem, st)) return e;
    if (int e = launch_pass<3>(a, grid, smem, st)) return e;
  }
  return 0;
}

// cols: a host array of C (1..16) column pointers, element (i, c) at
// cols[c][i * ld] (null: counts only); out: [ns, ldo] of the value type
// (int64 for int64 values, null with counts only), cnt: [ns, ldo] int64;
// columns [0, C) of each row are written.  C > 1 only for f32 values.
int gt_segment_reduce_f32(const void* const* cols, long long ld,
                          int C, const int32_t* ids, const uint8_t* mask,
                          long long n, int ns, int op, void* out,
                          long long ldo, long long* cnt, void* stream) {
  return dispatch_reduce<float>(op, cols, ld, C, ids, mask, n, ns, out, ldo,
                                cnt, (cudaStream_t)stream);
}

int gt_segment_reduce_f64(const void* const* cols, long long ld,
                          int C, const int32_t* ids, const uint8_t* mask,
                          long long n, int ns, int op, void* out,
                          long long ldo, long long* cnt, void* stream) {
  return dispatch_reduce<double>(op, cols, ld, C, ids, mask, n, ns, out, ldo,
                                 cnt, (cudaStream_t)stream);
}

int gt_segment_reduce_i64(const void* const* cols, long long ld,
                          int C, const int32_t* ids, const uint8_t* mask,
                          long long n, int ns, int op, void* out,
                          long long ldo, long long* cnt, void* stream) {
  return dispatch_reduce<long long>(op, cols, ld, C, ids, mask, n, ns, out,
                                    ldo, cnt, (cudaStream_t)stream);
}

int gt_segment_bounds(const int32_t* ids, long long n, int ns,
                      long long* starts, long long* ends, void* stream) {
  if (ns <= 0) return last_error();
  segment_bounds_kernel<<<blocks_for(ns), kThreads, 0,
                          (cudaStream_t)stream>>>(ids, n, ns, starts, ends);
  return last_error();
}

int gt_sorted_reduce_f32(const void* const* cols, long long ld,
                         int C, const uint8_t* mask, const long long* starts,
                         const long long* ends, int ns, int op, float* out,
                         long long ldo, long long* cnt, void* stream) {
  return dispatch_sorted<float>(op, cols, ld, C, mask, starts, ends, ns, out,
                                ldo, cnt, (cudaStream_t)stream);
}

int gt_sorted_reduce_f64(const void* const* cols, long long ld,
                         int C, const uint8_t* mask, const long long* starts,
                         const long long* ends, int ns, int op, double* out,
                         long long ldo, long long* cnt, void* stream) {
  return dispatch_sorted<double>(op, cols, ld, C, mask, starts, ends, ns,
                                 out, ldo, cnt, (cudaStream_t)stream);
}

int gt_sorted_reduce_i64(const void* const* cols, long long ld,
                         int C, const uint8_t* mask, const long long* starts,
                         const long long* ends, int ns, int op,
                         long long* out, long long ldo, long long* cnt,
                         void* stream) {
  return dispatch_sorted<long long>(op, cols, ld, C, mask, starts, ends, ns,
                                    out, ldo, cnt, (cudaStream_t)stream);
}

// incl: [n] int32 (the inclusive scan of the mask; incl[n-1] is the number
// of set rows), tile_sums: [ceil(n / 4096)] int32 scratch; order: [n] int32,
// of which the first incl[n-1] entries are written.
int gt_compact_order(const uint8_t* mask, long long n, int32_t* incl,
                     int32_t* tile_sums, int32_t* order, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return last_error();
  if (int e = launch_scan<int32_t, MaskSrc>(MaskSrc{mask}, n, tile_sums, incl,
                                            st)) {
    return e;
  }
  compact_order_kernel<<<blocks_for(n), kThreads, 0, st>>>(mask, incl, n,
                                                           order);
  return last_error();
}

int gt_gather(const void* src, const int32_t* order, long long n,
              int elem_bytes, void* dst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return last_error();
  const unsigned grid = blocks_for(n);
  switch (elem_bytes) {
    case 1:
      gather_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
          (const uint8_t*)src, order, n, (uint8_t*)dst);
      break;
    case 2:
      gather_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
          (const uint16_t*)src, order, n, (uint16_t*)dst);
      break;
    case 4:
      gather_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
          (const uint32_t*)src, order, n, (uint32_t*)dst);
      break;
    case 8:
      gather_kernel<unsigned long long><<<grid, kThreads, 0, st>>>(
          (const unsigned long long*)src, order, n,
          (unsigned long long*)dst);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return last_error();
}

// key: [n] int64 (I64_MAX on invalid rows), order: the stable argsort of
// key, valid: [n]; rank: [n] int32 scratch; group_keys: [num_groups + 1].
int gt_rank_scatter(const long long* key, const int32_t* order,
                    const uint8_t* valid, long long n, long long num_groups,
                    int32_t* rank, int32_t* tile_sums, int32_t* dense,
                    long long* group_keys, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  fill_i64_kernel<<<blocks_for(num_groups + 1), kThreads, 0, st>>>(
      group_keys, num_groups + 1, kI64Max);
  if (int e = last_error()) return e;
  if (n <= 0) return 0;
  if (int e = launch_scan<int32_t, KeyChangeSrc>(KeyChangeSrc{key, order}, n,
                                                 tile_sums, rank, st)) {
    return e;
  }
  rank_scatter_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      key, order, valid, rank, n, num_groups, dense, group_keys);
  return last_error();
}

// acc: [3] int64 scratch; rel: [n] int64 relative keys; idx: [n] int32 row
// indices; scal: [2] int64 (see argsort_key_kernel).
int gt_argsort_keys(const long long* key, const uint8_t* valid, long long n,
                    long long* acc, long long* rel, int32_t* idx,
                    long long* scal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  argsort_init_kernel<<<1, 1, 0, st>>>(acc);
  if (int e = last_error()) return e;
  if (n > 0) {
    const long long want = blocks_for(n);
    const unsigned grid = (unsigned)(want < 4096 ? want : 4096);
    argsort_minmax_kernel<<<grid, kThreads, 0, st>>>(key, valid, n, acc);
    if (int e = last_error()) return e;
  }
  argsort_key_kernel<<<blocks_for(n > 0 ? n : 1), kThreads, 0, st>>>(
      key, valid, n, acc, rel, idx, scal);
  return last_error();
}

int gt_radix_pass(const long long* key_in, const int32_t* idx_in, long long n,
                  int shift, int32_t* zeros, int32_t* tile_sums,
                  long long* key_out, int32_t* idx_out, void* stream) {
  return radix_pass(key_in, idx_in, n, shift, zeros, tile_sums, key_out,
                    idx_out, (cudaStream_t)stream);
}

}  // extern "C"
