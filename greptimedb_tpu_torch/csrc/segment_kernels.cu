// Hand-written Hopper kernels of the SQL row path.
//
// Built by greptimedb_tpu_torch/ops/segment_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libgreptime_segment.so
//        segment_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Every
// entry point launches on the caller's stream, allocates nothing (the
// wrapper passes outputs and scratch) and returns the first nonzero
// cudaGetLastError() of its launches.  The single-pass scan and the 8-bit
// radix pass come from scan.cuh, shared with promql_kernels.cu and
// topk_kernels.cu.
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
//   chunk it touches, and a boundary one warp close.
//   Loads: what bounds the kernel is bytes in flight, and the rows whose
//   mask byte is unset need no id or value.  So a warp first reads the
//   chunk's 1,024 mask bytes (two 16-byte loads a lane: lane l holds step
//   l's 32 bytes as a 32-bit word, which every lane reads by one shuffle a
//   step), then issues the ids and values of kBatch steps at once (8 for
//   one column, 4 up to 4 columns, 2 above), each lane loading only where
//   its row's mask byte is set: a step with no live row loads nothing and
//   is skipped, and a 32-byte sector of ids or values whose rows are all
//   unset is never fetched.  The register arrays are sized to the launch's
//   columns (instances for 1, 4, 10 and 16 columns).
//   Flushes go to shared-memory accumulators when ns x C of them fit in
//   48 KB (privatised: each block owns a contiguous row span and adds its
//   accumulators to device memory once at the end), else straight to
//   device memory.  A privatised block of one column has 1,024 threads,
//   so one copy of the accumulators (int64 min/max over 4,096 segments:
//   48 KB) serves 32 warps (512 for more columns, whose registers 64 a
//   thread would not hold), and its warps take the block's chunks in turn;
//   a block flushing to device memory has 256, each warp one contiguous
//   span of its rows (warps of a block flushing one segment at once
//   contend for it).  The grid is one wave at the occupancy the card
//   reports.
//   Summation order: float sums add in step order within a lane, then in a
//   fixed shuffle tree (or scan) within the warp, then in the order the
//   atomics land, which changes from run to run; int64 sums wrap exactly
//   (two's complement) and counts are exact.  float/double min and max go
//   through an order-preserving unsigned key (atomicMin/Max on the key), so
//   -0.0 < +0.0 and the +-inf fills survive.
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
//   in physical.py:1986).  Three launches and one host sync a call, every
//   column in one launch, no [N] intermediate.  The rows are cut into at
//   most 792 spans (6 blocks a multiprocessor), a block a span, in both
//   passes over the mask.  Launch 1 (compact_count) counts each span's
//   kept rows, 16 mask bytes a thread a load; the host reads the 792
//   counts (the one sync), turns them into each span's output offset (an
//   exclusive sum) and sizes one output buffer and a [kept] int32 order.
//   Launch 2 (compact_order) writes each span's kept rows to the order
//   from its offset, 16,384 rows a step (a thread 64 rows, four 16-byte
//   loads; a block scan; the step's kept rows listed in shared memory and
//   written coalesced): a reduce-then-scan whose middle scan is the
//   host's, so no block waits on another.  Launch 3 (compact_gather)
//   copies every column (1-, 2-, 4- or 8-byte elements; a descriptor
//   table uploaded with the offsets, so no column limit): a thread a kept
//   row, 4 columns a round with their loads in flight.  Launch 1 and the
//   host's read are one C call, the upload and launches 2 and 3 another:
//   a ctypes call costs more host time than a launch.  Designs built and
//   measured slower than this one, and not kept: a single-pass look-back
//   scan (scan.cuh) writing the order, the copy fused into that scan's
//   epilogue (each tile's copy waits on its look-back), and a gather a
//   block a column.  Bound: bytes: the mask, and the kept rows of each
//   column read once and written once.
//
// rank_scatter
//   Replaces the rank scatter of K6 `compact_groups` (ops/segment.py:353).
//   An int32 inclusive scan of "sorted key differs from the previous one"
//   (scan.cuh's launch_scan) gives each sorted row its dense rank; one pass
//   writes dense[order[i]] (num_groups on invalid rows) and
//   group_keys[rank] = key.  Bound: bytes (key, order and valid read,
//   dense and group_keys written).
//
// radix_argsort
//   Replaces K6's sorts: the jnp.argsort of compact_groups
//   (ops/segment.py:353) and the jnp.lexsort((values, ids)) of
//   segment_distinct_count (:206, as two stable sweeps).  Stable LSD radix
//   argsort of int64 keys on 8-bit digits (scan.cuh's radix_pass, as
//   sort_layout's general route), over only the bits the key range needs:
//   argsort_minmax finds min and max over the valid rows (64-bit
//   atomicMin/Max, order free), which the wrapper reads (the one host
//   sync) to pick the key width and the digits; argsort_keys maps key ->
//   key - min (u32 when the range fits 32 bits, else u64), gives invalid
//   rows the key (max - min) + 1, so they sort last in row order, and
//   builds every digit's histogram in the same read; then one scatter
//   launch a digit (ceil(bits / 8)): the first reads no row indices, the
//   last writes none of the keys.  When the valid keys span all 2^64
//   values the wrapper instead runs 8 passes and then one pass on the
//   invalid flag (argsort_flag).  Bound: bytes, the key and the mask read
//   once and the order written once (13 B/row); the passes move 12 B/row
//   each with u32 keys (the hostname codes: 13 bits, 2 passes).
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
//     series' T consecutive floats; the keys sit in registers, scan.cuh's
//     reg_bitonic_sort (unrolled for 4, 8, 16 or 32 keys) sorts them and
//     each rank set's rank is read by reg_pick.  The same launch files
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

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "scan.cuh"

namespace {

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

constexpr int kRows = 32;          // rows folded by one thread per chunk
constexpr int kRedThreads = 256;   // 8 warps (device-memory flushes)
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

// One step of 32 rows (lane l: id, or -1 for no live row, and its
// lifted values xv / counts xc) folded into the warp's open run; returns
// the run open after it.  Every lane calls it.
template <typename T, int OP, int CMAX, bool PRIV>
__device__ __forceinline__ int seg_step(
    int id, int run, typename Red<T, OP>::Acc* xv, unsigned int* xc,
    typename Red<T, OP>::Acc* acc, unsigned int* cnt, int C,
    typename Red<T, OP>::Acc* s_acc, unsigned int* s_cnt,
    typename Red<T, OP>::Acc* acc_out, unsigned long long* cnt_out,
    long long ldo) {
  using R = Red<T, OP>;
  using Acc = typename R::Acc;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (__all_sync(full, id < 0 || id == run)) {
    // the common case on sorted ids: the whole step continues the run
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      acc[c] = R::combine(acc[c], xv[c]);
      cnt[c] += xc[c];
    }
    return run;
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
  return run;
}

// Steps of a warp chunk whose ids and values load together.
template <int CMAX>
__host__ __device__ constexpr int batch_steps() {
  return CMAX == 1 ? 8 : (CMAX <= 4 ? 4 : 2);
}

// Threads of a block: a privatised block shares one copy of the
// accumulators among 32 warps where one register column leaves 64
// registers a thread enough, among 16 where more columns need more; a
// block that flushes to device memory has 8 warps.
template <int CMAX, bool PRIV>
__host__ __device__ constexpr int reduce_threads() {
  return PRIV ? (CMAX == 1 ? 1024 : 512) : kRedThreads;
}

// Bit r: byte r of the 16 nonzero.
__device__ __forceinline__ unsigned nonzero_bits16(uint4 w) {
  const unsigned q[4] = {w.x, w.y, w.z, w.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned t = q[k] | (q[k] >> 4);
    t |= t >> 2;
    t |= t >> 1;
    t &= 0x01010101u;  // bit 8 b: byte b nonzero
    bits |= ((t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xfu) << (4 * k);
  }
  return bits;
}

// Lane l's word of a warp chunk from row w0: bit r set when row
// w0 + 32 l + r lies below b1 and its mask byte is set (every row below
// b1 without a mask), so step j's rows are the bits of lane j's word.
__device__ __forceinline__ unsigned chunk_mask_word(const uint8_t* mask,
                                                    long long w0,
                                                    long long b1, int lane) {
  const long long r0 = w0 + 32LL * lane;
  if (r0 >= b1) return 0u;
  if (mask == nullptr) {
    return b1 - r0 >= 32 ? 0xffffffffu : (1u << (b1 - r0)) - 1u;
  }
  if (r0 + 32 <= b1 && (((uintptr_t)(mask + r0)) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(mask + r0);
    return nonzero_bits16(q[0]) | (nonzero_bits16(q[1]) << 16);
  }
  unsigned bits = 0;
  for (int r = 0; r < 32 && r0 + r < b1; ++r) {
    if (mask[r0 + r] != 0) bits |= 1u << r;
  }
  return bits;
}

template <typename T, int OP, int CMAX, bool PRIV>
__global__ void __launch_bounds__(reduce_threads<CMAX, PRIV>())
    segment_reduce_kernel(const Cols<T> v, int C,
                          const int32_t* __restrict__ ids,
                          const uint8_t* __restrict__ mask, long long n,
                          int ns, long long span,
                          typename Red<T, OP>::Acc* __restrict__ acc_out,
                          long long ldo,
                          unsigned long long* __restrict__ cnt_out) {
  using R = Red<T, OP>;
  using Acc = typename R::Acc;
  constexpr int kThr = reduce_threads<CMAX, PRIV>();
  constexpr int kBatch = batch_steps<CMAX>();
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
  // Privatised, the block's warps take its chunks in turn (neighbouring
  // warps read neighbouring rows).  Flushing to device memory, each warp
  // takes one contiguous span of the block's rows (whole steps), so the
  // warps of a block seldom flush to one segment at the same time.
  long long wfirst = b0 + (long long)warp * kWarpRows, wend = b1;
  long long wstride = (long long)(kThr / 32) * kWarpRows;
  if (!PRIV) {
    const long long per_warp =
        ((b1 - b0 + kThr / 32 - 1) / (kThr / 32) + 31) & ~31LL;
    wfirst = b0 + (long long)warp * per_warp;
    wend = wfirst + per_warp < b1 ? wfirst + per_warp : b1;
    wstride = kWarpRows;
  }
  // the chunk's live rows first: step j's are the bits of lane j's word
  unsigned mw_next = chunk_mask_word(mask, wfirst, wend, lane);
  for (long long w0 = wfirst; w0 < wend; w0 += wstride) {
    const unsigned mw = mw_next;
    // the next chunk's mask bytes load while this chunk folds
    mw_next = chunk_mask_word(mask, w0 + wstride, wend, lane);
    // The warp's open run (warp-uniform id) and this lane's share of it.
    int run = -1;
    Acc acc[CMAX];
    unsigned int cnt[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      acc[c] = R::identity();
      cnt[c] = 0u;
    }
    for (int j0 = 0; j0 < kRows; j0 += kBatch) {
      // kBatch steps' ids and values issue together, each lane loading
      // only a live row (step j: lane l takes row w0 + 32 j + l)
      unsigned sw[kBatch];
      int raw[kBatch];
      T xr[kBatch][CMAX];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        sw[u] = __shfl_sync(full, mw, j0 + u);
        raw[u] = -1;
        if ((sw[u] >> lane) & 1u) {
          const long long i = w0 + (long long)(j0 + u) * 32 + lane;
          raw[u] = ids[i];
#pragma unroll
          for (int c = 0; c < CMAX; ++c) {
            if (c < C && !counts_only) xr[u][c] = v.p[c][i * v.ld];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (sw[u] == 0u) continue;  // warp-uniform: no live row
        const int id = raw[u] >= 0 && raw[u] < ns ? raw[u] : -1;
        Acc xv[CMAX];
        unsigned int xc[CMAX];
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          xv[c] = R::identity();
          xc[c] = 0u;
          if (c < C && id >= 0 && (counts_only || !is_nan(xr[u][c]))) {
            if (!counts_only) xv[c] = R::lift(xr[u][c]);
            xc[c] = 1u;
          }
        }
        run = seg_step<T, OP, CMAX, PRIV>(id, run, xv, xc, acc, cnt, C,
                                          s_acc, s_cnt, acc_out, cnt_out,
                                          ldo);
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
  static const int sms = [] {  // a static's initialisation is thread-safe
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  return sms;
}

template <typename T, int OP, int CMAX, bool PRIV>
int launch_reduce_mode(const Cols<T>& v, int C, const int32_t* ids,
                       const uint8_t* mask, long long n, int ns,
                       typename Red<T, OP>::Acc* acc, long long ldo,
                       unsigned long long* cnt, cudaStream_t st) {
  using Acc = typename Red<T, OP>::Acc;
  constexpr int thr = reduce_threads<CMAX, PRIV>();
  const size_t smem = PRIV ? (sizeof(Acc) + 4) * (size_t)ns * C : 0;
  // one wave: each privatised block flushes once.  The occupancy query
  // costs host time, so it is kept a shared-memory size, under a lock:
  // calls come from several host threads.
  static std::mutex occ_lock;
  static std::unordered_map<size_t, int> occ_by_smem;
  int occ = 0;
  {
    std::lock_guard<std::mutex> hold(occ_lock);
    const auto it = occ_by_smem.find(smem);
    if (it != occ_by_smem.end()) {
      occ = it->second;
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, segment_reduce_kernel<T, OP, CMAX, PRIV>, thr, smem);
      occ_by_smem.emplace(smem, occ);
    }
  }
  const long long per_block = (long long)(thr / 32) * kWarpRows;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = (long long)num_sms() * (occ > 0 ? occ : 1);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  long long span = (n + blocks - 1) / blocks;
  span = (span + kWarpRows - 1) / kWarpRows * kWarpRows;
  segment_reduce_kernel<T, OP, CMAX, PRIV>
      <<<(unsigned)blocks, thr, smem, st>>>(v, C, ids, mask, n, ns, span,
                                            acc, ldo, cnt);
  return last_error();
}

// The instance for C columns: the register arrays hold 1, 4, 10 or 16.
template <typename T, int OP, bool PRIV>
int launch_reduce_cols(const Cols<T>& v, int C, const int32_t* ids,
                       const uint8_t* mask, long long n, int ns,
                       typename Red<T, OP>::Acc* acc, long long ldo,
                       unsigned long long* cnt, cudaStream_t st) {
  if (C == 1) {
    return launch_reduce_mode<T, OP, 1, PRIV>(v, C, ids, mask, n, ns, acc,
                                              ldo, cnt, st);
  }
  if constexpr (std::is_same<T, float>::value) {
    if (C <= 4) {
      return launch_reduce_mode<T, OP, 4, PRIV>(v, C, ids, mask, n, ns, acc,
                                                ldo, cnt, st);
    }
    if (C <= 10) {
      return launch_reduce_mode<T, OP, 10, PRIV>(v, C, ids, mask, n, ns,
                                                 acc, ldo, cnt, st);
    }
    if (C <= kWideC) {
      return launch_reduce_mode<T, OP, kWideC, PRIV>(v, C, ids, mask, n, ns,
                                                     acc, ldo, cnt, st);
    }
  }
  return (int)cudaErrorInvalidValue;
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
    const int e =
        priv ? launch_reduce_cols<T, OP, true>(v, C, ids, mask, n, ns, acc,
                                               ldo, cnt, st)
             : launch_reduce_cols<T, OP, false>(v, C, ids, mask, n, ns, acc,
                                                ldo, cnt, st);
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

template <typename T, int OP, int CMAX, bool PRIV>
int reduce_attrs(int* regs, long long* local) {
  cudaFuncAttributes a;
  if (int e = (int)cudaFuncGetAttributes(
          &a, segment_reduce_kernel<T, OP, CMAX, PRIV>)) {
    return e;
  }
  *regs = a.numRegs;
  *local = (long long)a.localSizeBytes;
  return 0;
}

template <typename T, int OP, bool PRIV>
int reduce_attrs_cols(int cmax, int* regs, long long* local) {
  if (cmax == 1) return reduce_attrs<T, OP, 1, PRIV>(regs, local);
  if constexpr (std::is_same<T, float>::value) {
    if (cmax == 4) return reduce_attrs<T, OP, 4, PRIV>(regs, local);
    if (cmax == 10) return reduce_attrs<T, OP, 10, PRIV>(regs, local);
    if (cmax == kWideC) return reduce_attrs<T, OP, kWideC, PRIV>(regs, local);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int OP>
int reduce_attrs_priv(int cmax, int priv, int* regs, long long* local) {
  return priv ? reduce_attrs_cols<T, OP, true>(cmax, regs, local)
              : reduce_attrs_cols<T, OP, false>(cmax, regs, local);
}

template <typename T>
int reduce_attrs_op(int op, int cmax, int priv, int* regs, long long* local) {
  switch (op) {
    case OP_SUM: return reduce_attrs_priv<T, OP_SUM>(cmax, priv, regs, local);
    case OP_MIN: return reduce_attrs_priv<T, OP_MIN>(cmax, priv, regs, local);
    case OP_MAX: return reduce_attrs_priv<T, OP_MAX>(cmax, priv, regs, local);
  }
  return (int)cudaErrorInvalidValue;
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

// 1 where the sorted key differs from the previous.  launch_scan calls it
// by whole warps on consecutive rows: the previous key comes from lane
// l - 1 by shuffle, and only lane 0 gathers it.
struct KeyChangeSrc {
  const long long* key;
  const int32_t* order;
  __device__ int operator()(long long i) const {
    const long long k = key[order[i]];
    long long pk = __shfl_up_sync(kAllLanes, k, 1);
    if ((threadIdx.x & 31) == 0 && i > 0) pk = key[order[i - 1]];
    return i > 0 && k != pk ? 1 : 0;
  }
};

// compact: the kept-row flags of four mask bytes as the low four bits
// (byte b -> bit b); a byte counts when it is nonzero.
__device__ __forceinline__ unsigned nonzero_nibble(unsigned x) {
  const unsigned nz = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  const unsigned m = nz >> 7;  // bits 0, 8, 16 and 24
  return (m | (m >> 7) | (m >> 14) | (m >> 21)) & 0xfu;
}

constexpr int kMaskChunk = 16;  // mask bytes of one 16-byte load
// the order pass takes a block's span in steps of 256 threads x 64 rows
// (four 16-byte loads a thread in flight), its kept rows listed in shared
// memory (32 KB: 6 blocks an SM)
constexpr int kCompactItems = 4 * kMaskChunk;
constexpr int kCompactStep = kThreads * kCompactItems;  // 16,384
constexpr int kCompactBlocksMax = 792;  // 6 blocks an SM of 132
constexpr int kCompactDesc = 3;  // words a column: source, offset, width
constexpr int kGatherCols = 4;   // columns a gather thread loads at once

// The flags of mask[row0, row0 + 16) as bits 0-15 (clear past n): one
// 16-byte load where the mask is 16-byte aligned and the rows are whole.
template <bool kVec>
__device__ __forceinline__ unsigned mask_bits(const uint8_t* mask,
                                              long long row0, long long n) {
  if (kVec && row0 + kMaskChunk <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + row0);
    return nonzero_nibble(v.x) | (nonzero_nibble(v.y) << 4) |
           (nonzero_nibble(v.z) << 8) | (nonzero_nibble(v.w) << 12);
  }
  unsigned bits = 0;
  for (int j = 0; j < kMaskChunk; ++j) {
    if (row0 + j < n && mask[row0 + j] != 0) bits |= 1u << j;
  }
  return bits;
}

// compact, launch 1: block b counts the kept rows of its span, rows
// [b * span, (b + 1) * span) (span a multiple of 16), 16 mask bytes a
// thread at a time, into partial[b]; the host reads the partials (the
// call's one sync) and turns them into each span's output offset.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    compact_count_kernel(const uint8_t* __restrict__ mask, long long n,
                         long long span, long long* __restrict__ partial) {
  __shared__ long long warp_sum[kThreads / 32];
  const long long lo = (long long)blockIdx.x * span;
  const long long hi = lo + span < n ? lo + span : n;
  long long cnt = 0;
  for (long long r = lo + (long long)threadIdx.x * kMaskChunk; r < hi;
       r += kThreads * kMaskChunk) {
    cnt += __popc(mask_bits<kVec>(mask, r, hi));
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(kAllLanes, cnt, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sum[w];
    partial[blockIdx.x] = sum;
  }
}

// compact, launch 2: block b writes the kept rows of its span to
// order[offset[b], ...), in row order.  It walks the span 16,384 rows at
// a time: each thread's 64 contiguous rows (four 16-byte loads), a block
// scan of the threads' counts, the kept rows listed in shared memory,
// then written out coalesced.  The offsets come from the host (the
// partials' exclusive sum), so no block waits on another.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 6)
    compact_order_kernel(const uint8_t* __restrict__ mask, long long n,
                         long long span,
                         const long long* __restrict__ offset,
                         int32_t* __restrict__ order) {
  __shared__ uint16_t rows[kCompactStep];
  __shared__ long long sm[33];
  const int tid = threadIdx.x;
  const long long lo = (long long)blockIdx.x * span;
  const long long hi = lo + span < n ? lo + span : n;
  long long out0 = offset[blockIdx.x];
  for (long long base = lo; base < hi; base += kCompactStep) {
    const long long row0 = base + (long long)tid * kCompactItems;
    unsigned long long bits = 0;
#pragma unroll
    for (int j = 0; j < kCompactItems / kMaskChunk; ++j) {
      bits |= (unsigned long long)mask_bits<kVec>(
                  mask, row0 + j * kMaskChunk, hi)
              << (j * kMaskChunk);
    }
    long long step_kept;
    int p = (int)block_exclusive_scan((long long)__popcll(bits), sm,
                                      step_kept);
    while (bits != 0) {
      rows[p++] = (uint16_t)(tid * kCompactItems + __ffsll(bits) - 1);
      bits &= bits - 1;
    }
    __syncthreads();
    for (int q = tid; q < (int)step_kept; q += kThreads) {
      order[out0 + q] = (int32_t)(base + rows[q]);
    }
    out0 += step_kept;
  }
}

__device__ __forceinline__ unsigned long long load_elem(const void* p,
                                                        long long i, int w) {
  switch (w) {
    case 1: return static_cast<const uint8_t*>(p)[i];
    case 2: return static_cast<const uint16_t*>(p)[i];
    case 4: return static_cast<const uint32_t*>(p)[i];
    default: return static_cast<const unsigned long long*>(p)[i];
  }
}

__device__ __forceinline__ void store_elem(void* p, long long i, int w,
                                           unsigned long long v) {
  switch (w) {
    case 1: static_cast<uint8_t*>(p)[i] = (uint8_t)v; break;
    case 2: static_cast<uint16_t*>(p)[i] = (uint16_t)v; break;
    case 4: static_cast<uint32_t*>(p)[i] = (uint32_t)v; break;
    default: static_cast<unsigned long long*>(p)[i] = v; break;
  }
}

// compact, launch 3: every column of the kept rows in one launch, a thread
// a kept row q (its order entry read once): kCols columns a round, their
// loads, then their stores.  Column c's output starts at out + kept *
// desc[3c + 1] and holds desc[3c + 2]-byte elements read from desc[3c].
template <int kCols>
__global__ void __launch_bounds__(kThreads)
    compact_gather_kernel(const long long* __restrict__ desc, int ncols,
                          const int32_t* __restrict__ order, long long kept,
                          uint8_t* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= kept) return;
  const long long i = order[q];
  for (int c0 = 0; c0 < ncols; c0 += kCols) {
    unsigned long long v[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      if (c0 + u < ncols) {
        const long long* d = desc + (long long)(c0 + u) * kCompactDesc;
        v[u] = load_elem((const void*)d[0], i, (int)d[2]);
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      if (c0 + u < ncols) {
        const long long* d = desc + (long long)(c0 + u) * kCompactDesc;
        store_elem(out + kept * d[1], q, (int)d[2], v[u]);
      }
    }
  }
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

// The relative keys (K: u32 when they fit, else u64): key - mn on valid
// rows, `inv` (above every valid key) on the rest, so a stable sort puts
// the invalid rows last in row order; and, in the same read, the 256-bin
// histograms of the `passes` digits (hist: [passes][256], zeroed).
template <typename K>
__global__ void argsort_key_kernel(const long long* __restrict__ key,
                                   const uint8_t* __restrict__ valid,
                                   long long n, unsigned long long mn,
                                   unsigned long long inv, int passes,
                                   K* __restrict__ rel, unsigned* hist) {
  __shared__ unsigned sh[kRadixMaxPasses * kRadixBins];
  radix_hist_zero(sh, passes);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x; i0 < n;
       i0 += stride) {
    const long long i = i0 + threadIdx.x;
    const bool in = i < n;
    K r = 0;
    if (in) {
      const bool ok = valid == nullptr || valid[i] != 0;
      r = (K)(ok ? (unsigned long long)key[i] - mn : inv);
      rel[i] = r;
    }
    radix_hist_add(sh, r, passes, in);
  }
  __syncthreads();
  radix_hist_flush(sh, hist, passes);
}

// The extra pass of a key range that spans all 2^64 values: flag[i] = 1
// where row idx[i] is invalid, and its one-digit histogram (hist: [256],
// zeroed).
__global__ void argsort_flag_kernel(const uint8_t* __restrict__ valid,
                                    const int32_t* __restrict__ idx,
                                    long long n, uint32_t* __restrict__ flag,
                                    unsigned* hist) {
  __shared__ unsigned sh[kRadixBins];
  radix_hist_zero(sh, 1);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x; i0 < n;
       i0 += stride) {
    const long long i = i0 + threadIdx.x;
    const bool in = i < n;
    uint32_t f = 0;
    if (in) {
      f = valid[idx[i]] != 0 ? 0u : 1u;
      flag[i] = f;
    }
    radix_hist_add(sh, f, 1, in);
  }
  __syncthreads();
  radix_hist_flush(sh, hist, 1);
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
// in registers (padded with kPadKey, above every sort key), scan.cuh's
// reg_bitonic_sort, then each rank read by reg_pick.
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
  reg_bitonic_sort<P>(k);
  for (int r = 0; r < a.R; ++r) {
    const long long o = ((long long)r * a.ng + g) * a.T + t;
    int rr = a.ranks[o];
    rr = rr < 0 ? 0 : (rr >= size ? size - 1 : rr);
    a.out[o] = size > 0 ? f32_of_key(reg_pick<P>(k, rr)) : NAN;
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

// Registers a thread and local (spill) bytes of the segment_reduce
// instance of value type `type` (0 f32, 1 f64, 2 int64), op, register
// columns cmax (1; f32 also 4, 10, 16) and privatisation.
int gt_segment_reduce_regs(int type, int op, int cmax, int priv, int* regs,
                           long long* local) {
  switch (type) {
    case 0: return reduce_attrs_op<float>(op, cmax, priv, regs, local);
    case 1: return reduce_attrs_op<double>(op, cmax, priv, regs, local);
    case 2: return reduce_attrs_op<long long>(op, cmax, priv, regs, local);
  }
  return (int)cudaErrorInvalidValue;
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

// compact, launch 1 and the call's one host sync.  scratch: blocks + 3 *
// ncols int64 on the card (the spans' counts, then the offsets and the
// descriptor table that compact_copy uploads over them); host: as many on
// the host, of which the first `blocks` receive each span's exclusive
// offset.  Returns the kept rows in *kept.
int gt_compact_count(const uint8_t* mask, long long n, long long span,
                     int blocks, long long* scratch, long long* host,
                     long long* kept, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks <= 0 || blocks > kCompactBlocksMax || span <= 0 ||
      span % kMaskChunk || (long long)blocks * span < n) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)mask & 15) == 0) {
    compact_count_kernel<true><<<blocks, kThreads, 0, st>>>(mask, n, span,
                                                            scratch);
  } else {
    compact_count_kernel<false><<<blocks, kThreads, 0, st>>>(mask, n, span,
                                                             scratch);
  }
  if (int e = last_error()) return e;
  if (int e = (int)cudaMemcpyAsync(host, scratch, sizeof(long long) * blocks,
                                   cudaMemcpyDeviceToHost, st)) {
    return e;
  }
  if (int e = (int)cudaStreamSynchronize(st)) return e;
  long long sum = 0;
  for (int b = 0; b < blocks; ++b) {
    const long long c = host[b];
    host[b] = sum;
    sum += c;
  }
  *kept = sum;
  return 0;
}

// compact, launches 2 and 3 (after launch 1 on the same scratch and host
// buffer, whose entries blocks .. blocks + 3 * ncols hold the descriptor
// table: kCompactDesc words a column, source pointer, output offset in
// bytes a kept row, element width 1, 2, 4 or 8): the offsets and the
// table copied to the scratch, the order pass into order [kept] int32,
// then the gather of every column into out (kept * sum(widths) bytes).
int gt_compact_copy(const uint8_t* mask, long long n, long long span,
                    int blocks, long long* scratch, const long long* host,
                    int ncols, int32_t* order, long long kept, uint8_t* out,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || kept <= 0 || ncols <= 0) return last_error();
  const size_t words = (size_t)blocks + (size_t)kCompactDesc * ncols;
  if (int e = (int)cudaMemcpyAsync(scratch, host, sizeof(long long) * words,
                                   cudaMemcpyHostToDevice, st)) {
    return e;
  }
  if (((uintptr_t)mask & 15) == 0) {
    compact_order_kernel<true><<<blocks, kThreads, 0, st>>>(mask, n, span,
                                                            scratch, order);
  } else {
    compact_order_kernel<false><<<blocks, kThreads, 0, st>>>(
        mask, n, span, scratch, order);
  }
  if (int e = last_error()) return e;
  compact_gather_kernel<kGatherCols>
      <<<(unsigned)((kept + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          scratch + blocks, ncols, order, kept, out);
  return last_error();
}

// key: [n] int64 (I64_MAX on invalid rows), order: the stable argsort of
// key, valid: [n]; rank: [n] int32 scratch; scratch: the scan's tile
// status (int32); group_keys: [num_groups + 1].
int gt_rank_scatter(const long long* key, const int32_t* order,
                    const uint8_t* valid, long long n, long long num_groups,
                    int32_t* rank, void* scratch, int32_t* dense,
                    long long* group_keys, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  fill_i64_kernel<<<blocks_for(num_groups + 1), kThreads, 0, st>>>(
      group_keys, num_groups + 1, kI64Max);
  if (int e = last_error()) return e;
  if (n <= 0) return 0;
  if (int e = launch_scan<int32_t, KeyChangeSrc>(KeyChangeSrc{key, order}, n,
                                                 scratch, rank, st)) {
    return e;
  }
  rank_scatter_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      key, order, valid, rank, n, num_groups, dense, group_keys);
  return last_error();
}

// acc: [3] int64: the valid rows' min and max, and whether any row is
// valid (the wrapper reads it: the one host sync of radix_argsort).
int gt_argsort_minmax(const long long* key, const uint8_t* valid, long long n,
                      long long* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  argsort_init_kernel<<<1, 1, 0, st>>>(acc);
  if (int e = last_error()) return e;
  if (n > 0) {
    const long long want = blocks_for(n);
    const unsigned grid = (unsigned)(want < 4096 ? want : 4096);
    argsort_minmax_kernel<<<grid, kThreads, 0, st>>>(key, valid, n, acc);
  }
  return last_error();
}

// rel: [n] u64 (wide) or u32 relative keys; hist: [passes][256] uint32.
int gt_argsort_keys(const long long* key, const uint8_t* valid, long long n,
                    long long mn, unsigned long long inv, int wide,
                    int passes, void* rel, unsigned* hist, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (passes < 1 || passes > kRadixMaxPasses) {
    return (int)cudaErrorInvalidValue;
  }
  if (int e = (int)cudaMemsetAsync(hist, 0, sizeof(unsigned) * kRadixBins *
                                                passes, st)) {
    return e;
  }
  if (n <= 0) return last_error();
  const unsigned grid = radix_hist_grid(n);
  if (wide) {
    argsort_key_kernel<unsigned long long><<<grid, kThreads, 0, st>>>(
        key, valid, n, (unsigned long long)mn, inv, passes,
        (unsigned long long*)rel, hist);
  } else {
    argsort_key_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        key, valid, n, (unsigned long long)mn, inv, passes, (uint32_t*)rel,
        hist);
  }
  return last_error();
}

// flag: [n] u32; hist: [256] uint32 (see argsort_flag_kernel).
int gt_argsort_flag(const uint8_t* valid, const int32_t* idx, long long n,
                    uint32_t* flag, unsigned* hist, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (int e = (int)cudaMemsetAsync(hist, 0, sizeof(unsigned) * kRadixBins,
                                   st)) {
    return e;
  }
  if (n <= 0) return last_error();
  argsort_flag_kernel<<<radix_hist_grid(n), kThreads, 0, st>>>(valid, idx, n,
                                                               flag, hist);
  return last_error();
}

// One 8-bit digit pass (scan.cuh radix_pass): keys u64 (wide) or u32.
int gt_radix_pass(const void* key_in, const int32_t* idx_in, long long n,
                  int wide, int shift, const unsigned* hist,
                  unsigned long long* status, void* key_out, int32_t* idx_out,
                  void* stream) {
  return radix_pass_any(key_in, idx_in, n, wide, shift, hist, status,
                        key_out, idx_out, (cudaStream_t)stream);
}

}  // extern "C"
