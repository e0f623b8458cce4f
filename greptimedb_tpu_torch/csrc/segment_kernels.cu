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

__device__ __forceinline__ unsigned int f2key(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key2f(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
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
    return f2key(OP == OP_MIN ? INFINITY : -INFINITY);
  }
  __device__ static Acc lift(float v) { return f2key(v); }
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
    reinterpret_cast<float*>(acc)[at] = key2f((unsigned int)acc[at]);
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

}  // namespace

extern "C" {

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
