// Hand-written Hopper kernels of the PromQL range-vector path.
//
// Built by greptimedb_tpu_torch/ops/promql_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o build/kernels/libgreptime_promql.so
//        promql_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Every
// entry point launches on the caller's stream, allocates nothing (the
// wrapper passes outputs and scratch) and returns the first nonzero
// cudaGetLastError() of its launches, so a refused launch surfaces in the
// wrapper.  -fmad=false: no multiply-add contraction anywhere in this file,
// so the f64 window arithmetic rounds after every operation, as the plain
// PyTorch version's separate elementwise ops do.
//
// prefix_scan
//   Replaces the cumulative sums of the JAX reference's window body
//   (greptimedb_tpu/promql/engine.py:405-425, `_window_body`: the f64
//   cumsum of counter-reset drops) and serves the split counts of the
//   radix sort below.  It runs scan.cuh's launch_scan (the one scan of
//   the csrc/ libraries) with a fused prologue: the counter drop (f64)
//   drop[i] = (tsid[i] == tsid[i-1] && valid[i] && valid[i-1] &&
//   val[i-1] > val[i]) ? val[i-1] : 0.
//   Bound: bytes.  The f64 mode reads val f32 + tsid i32 + valid u8 twice
//   (phases 1 and 3: 18 B/row) and writes 8 B/row; at N = 41.9 M padded rows
//   ~1.1 GB, ~0.33 ms at 3.35 TB/s against a 0.44 GB one-pass bound.
//
// sort_layout (layout_scan + layout_finalize, then one of two routes)
//   Replaces K8, `_build_sort_layout` (engine.py:257): the query-
//   independent composite-key stable sort of a resident table, key =
//   tsid*kp + (ts - ts_min) with kp = ts_max - ts_min + 2 on valid rows
//   (valid = mask & !isnan(val)), I64_MAX on the rest.
//   layout_scan: a warp a segment of 1,024 rows (coalesced, 4 groups of
//   32 in flight) finds its valid rows' count, ts and tsid ranges, first
//   and last (tsid, ts), and whether a valid row falls below the valid row
//   before it (the nearest valid lane below by ballot, else the segment's
//   last valid row, across any invalid rows); a block's 8 segments combine
//   in order into one summary.  layout_finalize (one block, a fixed order:
//   deterministic) reduces those to ts_min / kp / the invalid rows' key,
//   checks the order across blocks (each first key against the largest
//   last key before it) and scans the counts into each block's first
//   valid slot.  The partition pass is queued right behind it and returns
//   at once unless the keys were in order; the wrapper then reads the
//   scalars: the one host sync.
//   Presorted route (the valid keys non-decreasing in row order, as on
//   every resident DeviceTable: storage/scan.py's merge_parts leaves it in
//   (tsid, ts, seq) order, pad rows last): the stable argsort is one
//   stable partition, valid rows in row order then invalid rows in row
//   order.  layout_partition writes it straight into key_s, ts_s, val_s,
//   tsid_s and valid_s: a warp a segment, its slots from the counts and a
//   ballot a group.  No look-back: pass 1 is compulsory (ts_min and kp
//   come before any key), and its per-segment counts make the offsets.
//   General route (any other input): layout_key writes (key, row index)
//   with the invalid rows' key (max tsid + 1) * kp, above every valid key,
//   then a stable LSD radix sort, one bit per pass, each scan.cuh's
//   radix_pass (a "bit is zero" scan plus a scatter); only as many passes
//   run as that key has bits (40 at 1 M series x 585 s); layout_gather
//   writes the five columns.
//   Bound: bytes, 42 B/row (read ts/val/tsid/mask 17 B, write the five
//   sorted arrays 25 B).  The presorted route moves 59 B/row (pass 1 reads
//   the 17 B again).  The general route adds ~44 B/row a pass (the key read
//   twice for the scan and once with the row index for the scatter, both
//   written again); moving it onto 8-bit digit passes is later work.
//
// counter_window
//   Replaces K9's searchsorted geometry (`_sorted_window_bounds`,
//   engine.py:288-346), K10's `counter` and `instant` kinds (engine.py:
//   427-454) and, in rate mode, K11's epilogue `_extrapolated`
//   (engine.py:1839; Prometheus extrapolatedRate).  One thread per
//   (selected series, step): two binary searches over key_s (left for the
//   window start rel_lo, right for the end rel_hi, with the clips of
//   engine.py:335-336), first/last gathers, delta_adj = (val + gdrop)[last]
//   - (val + gdrop)[first] in f64, then f32.  Stats mode writes the
//   reference's _KIND_KEYS outputs; rate mode writes v[S, T] f32 for
//   rate/increase/delta computed in f64 as _extrapolated computes it.
//   Bound: the searches are 2 x log2(N) dependent loads per thread; the
//   compulsory bytes are the S x T outputs plus the gathered rows, so the
//   kernel is latency-bound far above its byte bound.  The top levels of
//   the search stay in L2; a per-series range search is later work.
//
// series_ranges + gather_ts_mat (the count geometry)
//   Replace the rest of K9: `_series_ranges` (engine.py:348) and
//   `_gather_ts_mat` (:360), the state of the reference's second window
//   geometry (`_sorted_window_bounds` with `bounds`, :313-328).
//   series_ranges: one thread a selected series, two binary searches for
//   its row range [start, start + cnt) (start int64, cnt int32) and the
//   largest cnt by one atomicMax a warp, which the wrapper reads once to
//   size L (the next power of two).  gather_ts_mat: one thread an element
//   of the [S, L] int64 timestamp matrix, I64_MAX past cnt.  With that
//   state window_bounds counts, per window, the series' timestamps <= t -
//   range and <= t in its L-wide row: O(L) sequential compares instead of
//   two O(log N) dependent searches, the same integer bounds.
//   counter_window, window_stats and minmax_window take either geometry
//   with no change to their bodies.
//   Bound: series_ranges, 2 log2(N) dependent loads a series (latency);
//   bytes: the selection read and start/cnt written.  gather_ts_mat:
//   bytes, the S x L matrix written (512 MiB at S = 2^20, L = 64) and the
//   selected rows' timestamps read once.
//
// window_stats
//   Replaces K10's other kinds of `_window_body` (engine.py:455-499):
//   gauge_window (sum, avg, var, first/last), counter_rc (resets and
//   changes), regression (least-squares slope and intercept, time in
//   seconds from the grid's start) and irate (the last two samples).  One
//   thread per (selected series, step): the same two binary searches as
//   counter_window, then a loop over the window's rows [lo, hi) that sums
//   in f64 directly, where the reference differences five full-table f64
//   prefix sums (cs_v, cs_v2, cs_t, cs_tv, cs_t2; 1.7 GB at 41.9 M rows).
//   The function is the same; the direct sum does not cancel against the
//   table's running total, so it is at least as exact (the tests hold the
//   two within 1e-5 * max(1, |b|); counts and timestamps exactly).  gauge's
//   mean comes from the f32-rounded sum and var subtracts it from the f64
//   square sum, in the reference's order; counter_rc counts the pairs
//   (j-1, j) for j in lo+1 .. hi-1 (exact integers).
//   Bound: bytes.  Each window reads its rows once (ts i64 + val f32) and
//   writes its outputs; windows overlap (range/step = 20 at 5 m / 15 s),
//   so the rows come from L2 after their first read.  Compulsory: the
//   selected rows once plus the S x T outputs.
//
// minmax_window
//   Replaces K13, the `minmax` kind's fori_loop of range/step + 1 scatter-
//   min/max passes over the whole table into [S*T + 1] (engine.py:500-535).
//   One thread per window loops over [lo, hi) from the same bounds: each
//   sample meets exactly the windows it would have been scattered into, so
//   the extremes are equal (exact, in any order).  A window without
//   samples, or whose extreme is infinite, is NaN, as the reference's
//   isfinite test makes it.  Bound: bytes, as window_stats.
//
// window_count_max + window_matrix
//   Replace K14: `_count_max_kernel` (engine.py:541; the largest window
//   count, an atomicMax per warp) and `_matrix_kernel` (:555), which
//   gathers [S*T, lmax] windows (2.7 GB at 1 M series x 20 steps x 32) and
//   sorts each row.  Here a warp finds the bounds of 32 windows at once
//   (one a lane), then takes them in turn and keeps each in its own buffer
//   only: the samples as scan.cuh's order-preserving 32-bit sort keys (NaN
//   canonical and last; -0.0 below +0.0), padded to a power of two with an
//   all-ones key above +inf, then scan.cuh's warp bitonic sort.  The buffer
//   lies in shared memory up to 16,384 keys a window; wider windows sort
//   in a global scratch the wrapper allocates, one slot per launched warp,
//   the warps striding over the windows.  quantile reads the two
//   straddling order statistics and interpolates with the reference's f32
//   formula `vlo + (vhi - vlo) * (rank - lo)`; mad sorts |x - median| a
//   second time in the same buffer; holt runs its f32 scan in time order,
//   one lane per window.
//   -fmad=false keeps every other step rounded as the reference rounds it;
//   the fused multiply-adds that XLA's CPU backend contracts the reference
//   into (gauge's var = q - mean * mean, Holt's two updates) are explicit
//   fma/fmaf calls here and fma64/fma32 in the plain versions.
//   Bound: bytes (the window's rows once, the S x T output); the sort is
//   log2(L) (log2(L) + 1) / 2 compare-exchange stages per window.
//
// window_matrix_dense
//   The same sorts over a subquery's [S, T, K] window matrix (NaN = not a
//   sample) instead of the sort layout: the quantile and mad reducers of
//   `_eval_subquery_window` (engine.py:1415-1437), one warp per window.
//   Bound: bytes (the matrix once, the S x T output) or the sort's
//   compare-exchanges, whichever is larger.
//
// subquery_counter
//   Replaces `_eval_subquery_counter` (engine.py:1309-1363): the first /
//   last gathers, the K-step counter-drop fori_loop (:1342-1354) and the
//   `_extrapolated` epilogue (the same device function as counter_window's
//   rate mode) for rate/increase/delta over a subquery; for irate/idelta
//   the last two samples.  One thread per window, one pass in window
//   order; the drop sum is a sequential f32 sum, bit for bit the
//   reference's.  Bound: bytes (the matrix once, the outputs once).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

// ---------------------------------------------------------------------------
// prefix_scan
// ---------------------------------------------------------------------------

struct DropSrc {  // counter-reset drop of the sorted layout, as f64
  const float* val;
  const int32_t* tsid;
  const uint8_t* valid;
  __device__ double operator()(long long i) const {
    if (i == 0) return 0.0;
    const bool prev_same =
        tsid[i] == tsid[i - 1] && valid[i] != 0 && valid[i - 1] != 0;
    const float pv = val[i - 1];
    return (prev_same && pv > val[i]) ? (double)pv : 0.0;
  }
};

// ---------------------------------------------------------------------------
// sort_layout
// ---------------------------------------------------------------------------

// Row geometry of layout_scan and layout_partition: warp s of the grid
// walks segment s, kSegRows consecutive rows, in groups of 32 (one row a
// lane, coalesced), kLayoutUnroll groups loaded before any is used.
constexpr int kLayoutUnroll = 4;
constexpr int kSegIters = 8;
constexpr int kSegRows = 32 * kLayoutUnroll * kSegIters;  // 1024
constexpr int kLayoutWarps = kThreads / 32;
constexpr int kFinThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// One segment's valid rows, written by layout_scan_kernel.
struct SegSum {
  long long cnt;                 // valid rows
  long long ts_lo, ts_hi;        // their timestamp range
  long long first_ts, last_ts;   // the first and the last valid row
  int tsid_lo, tsid_hi;
  int first_tsid, last_tsid;
  int flags;                     // kSegAny | kSegBad
  int pad;
};
static_assert(sizeof(SegSum) == 64, "ops/promql_kernels.py _SEG_BYTES");
constexpr int kSegAny = 1;  // the segment holds a valid row
constexpr int kSegBad = 2;  // a valid row sorts below the valid row before it

// scal (int64, 5 words: ops/promql_kernels.py _SCAL_WORDS): [0] ts_min,
// [1] kp, [2] the invalid rows' sort key, [3] 1 when the valid keys are
// non-decreasing in row order, [4] valid rows

__device__ __forceinline__ bool pair_less(int a_id, long long a_ts, int b_id,
                                          long long b_ts) {
  return a_id < b_id || (a_id == b_id && a_ts < b_ts);
}

struct SumOp {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};
struct MinOp {
  __device__ long long operator()(long long a, long long b) const {
    return a < b ? a : b;
  }
};
struct MaxOp {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};

// Every thread gets op over the block (blockDim.x a power of two).
template <typename Op>
__device__ long long block_allreduce(long long v, long long* sm, Op op) {
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sm[threadIdx.x] = op(sm[threadIdx.x],
                                                 sm[threadIdx.x + off]);
    __syncthreads();
  }
  const long long r = sm[0];
  __syncthreads();
  return r;
}

// Exclusive scan over the block's threads in a fixed order (Hillis-Steele).
template <typename Op>
__device__ long long block_exclusive(long long v, long long* sm, Op op,
                                     long long identity) {
  const int tid = threadIdx.x;
  sm[tid] = v;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const long long add = tid >= off ? sm[tid - off] : identity;
    __syncthreads();
    sm[tid] = op(sm[tid], add);
    __syncthreads();
  }
  const long long ex = tid > 0 ? sm[tid - 1] : identity;
  __syncthreads();
  return ex;
}

// Pass 1 (both routes): per segment the valid rows' count, timestamp and
// tsid ranges, first and last (tsid, ts), and whether a valid row's
// (tsid, ts) falls below that of the valid row before it.  The previous
// valid row of a lane is the nearest valid lane below it (ballot), else
// the segment's last valid row so far, however many invalid rows lie in
// between.  Each segment's count goes to seg_cnt; the block's segments
// combine in order (the same check across them) into one summary a
// block, and layout_finalize checks across blocks.
__global__ void __launch_bounds__(kThreads)
    layout_scan_kernel(const long long* __restrict__ ts,
                       const float* __restrict__ val,
                       const int32_t* __restrict__ tsid,
                       const uint8_t* __restrict__ mask, long long n,
                       long long nseg, int32_t* __restrict__ seg_cnt,
                       SegSum* __restrict__ blk) {
  __shared__ SegSum wsum[kLayoutWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * kLayoutWarps + warp;
  const long long base = s < nseg ? s * kSegRows : n;  // none: no rows
  const unsigned below = (1u << lane) - 1u;
  long long lo = kI64Max, hi = -(1LL << 62), cnt = 0;
  int id_lo = 0x7fffffff, id_hi = -0x7fffffff - 1;
  bool have = false, bad = false;
  int first_id = 0, last_id = 0;
  long long first_ts = 0, last_ts = 0;
  for (int it = 0; it < kSegIters; ++it) {
    long long t[kLayoutUnroll];
    int id[kLayoutUnroll];
    bool ok[kLayoutUnroll];
#pragma unroll
    for (int u = 0; u < kLayoutUnroll; ++u) {
      const long long i =
          base + (long long)(it * kLayoutUnroll + u) * 32 + lane;
      t[u] = 0;
      id[u] = 0;
      ok[u] = false;
      if (i < n) {
        t[u] = ts[i];
        id[u] = tsid[i];
        ok[u] = mask[i] != 0 && !isnan(val[i]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLayoutUnroll; ++u) {
      const unsigned bal = __ballot_sync(kFull, ok[u]);
      if (bal == 0) continue;  // warp-uniform
      const unsigned prior = bal & below;
      const int src = prior ? 31 - __clz(prior) : 0;
      const int p_id = __shfl_sync(kFull, id[u], src);
      const long long p_ts = __shfl_sync(kFull, t[u], src);
      if (ok[u]) {
        lo = t[u] < lo ? t[u] : lo;
        hi = t[u] > hi ? t[u] : hi;
        id_lo = id[u] < id_lo ? id[u] : id_lo;
        id_hi = id[u] > id_hi ? id[u] : id_hi;
        if (prior) {
          bad |= pair_less(id[u], t[u], p_id, p_ts);
        } else if (have) {
          bad |= pair_less(id[u], t[u], last_id, last_ts);
        }
      }
      const int fl = __ffs((int)bal) - 1;
      const int ll = 31 - __clz(bal);
      const int f_id = __shfl_sync(kFull, id[u], fl);
      const long long f_ts = __shfl_sync(kFull, t[u], fl);
      const int l_id = __shfl_sync(kFull, id[u], ll);
      const long long l_ts = __shfl_sync(kFull, t[u], ll);
      if (!have) {
        first_id = f_id;
        first_ts = f_ts;
        have = true;
      }
      last_id = l_id;
      last_ts = l_ts;
      cnt += __popc(bal);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const long long olo = __shfl_xor_sync(kFull, lo, off);
    const long long ohi = __shfl_xor_sync(kFull, hi, off);
    const int oil = __shfl_xor_sync(kFull, id_lo, off);
    const int oih = __shfl_xor_sync(kFull, id_hi, off);
    lo = olo < lo ? olo : lo;
    hi = ohi > hi ? ohi : hi;
    id_lo = oil < id_lo ? oil : id_lo;
    id_hi = oih > id_hi ? oih : id_hi;
  }
  bad = __any_sync(kFull, bad);
  if (lane == 0) {
    if (s < nseg) seg_cnt[s] = (int32_t)cnt;
    SegSum& q = wsum[warp];
    q.cnt = cnt;
    q.ts_lo = lo;
    q.ts_hi = hi;
    q.first_ts = first_ts;
    q.last_ts = last_ts;
    q.tsid_lo = id_lo;
    q.tsid_hi = id_hi;
    q.first_tsid = first_id;
    q.last_tsid = last_id;
    q.flags = (have ? kSegAny : 0) | (bad ? kSegBad : 0);
    q.pad = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the block's segments in row order
    SegSum b = wsum[0];
    for (int w = 1; w < kLayoutWarps; ++w) {
      const SegSum& q = wsum[w];
      b.flags |= q.flags & kSegBad;
      if (!(q.flags & kSegAny)) continue;
      if (!(b.flags & kSegAny)) {
        const int bad_so_far = b.flags & kSegBad;
        b = q;
        b.flags |= bad_so_far;
        continue;
      }
      if (pair_less(q.first_tsid, q.first_ts, b.last_tsid, b.last_ts)) {
        b.flags |= kSegBad;
      }
      b.cnt += q.cnt;
      b.ts_lo = q.ts_lo < b.ts_lo ? q.ts_lo : b.ts_lo;
      b.ts_hi = q.ts_hi > b.ts_hi ? q.ts_hi : b.ts_hi;
      b.tsid_lo = q.tsid_lo < b.tsid_lo ? q.tsid_lo : b.tsid_lo;
      b.tsid_hi = q.tsid_hi > b.tsid_hi ? q.tsid_hi : b.tsid_hi;
      b.last_ts = q.last_ts;
      b.last_tsid = q.last_tsid;
    }
    blk[blockIdx.x] = b;
  }
}

// One block: the table's ts_min / kp / invalid-row key from the block
// summaries (a fixed reduction order: deterministic), the route flag and
// each scan block's first output slot for its valid rows (an exclusive
// scan of the counts).  The valid keys are in row order when no block saw a
// descent inside and every block's first valid key is at least the
// largest last key of the blocks before it.  Within a block the check
// compared (tsid, ts) pairs, whose order is the key order while every key
// fits: tsid >= 0 and (max tsid + 1) * kp <= I64_MAX, required here.
__global__ void __launch_bounds__(kFinThreads)
    layout_finalize_kernel(const SegSum* __restrict__ seg, long long nseg,
                           long long* __restrict__ blk_off,
                           long long* __restrict__ scal) {
  __shared__ long long sm[kFinThreads];
  const int tid = threadIdx.x;
  const long long per = (nseg + kFinThreads - 1) / kFinThreads;
  long long k0 = (long long)tid * per;
  k0 = k0 < nseg ? k0 : nseg;
  const long long k1 = k0 + per < nseg ? k0 + per : nseg;
  long long cnt = 0, lo = kI64Max, hi = -(1LL << 62);
  long long id_lo = kI64Max, id_hi = -(1LL << 62);
  bool bad = false;
  for (long long k = k0; k < k1; ++k) {
    const SegSum& q = seg[k];
    if (q.flags & kSegAny) {
      cnt += q.cnt;
      lo = q.ts_lo < lo ? q.ts_lo : lo;
      hi = q.ts_hi > hi ? q.ts_hi : hi;
      id_lo = q.tsid_lo < id_lo ? q.tsid_lo : id_lo;
      id_hi = q.tsid_hi > id_hi ? q.tsid_hi : id_hi;
    }
    bad |= (q.flags & kSegBad) != 0;
  }
  const long long total = block_allreduce(cnt, sm, SumOp());
  lo = block_allreduce(lo, sm, MinOp());
  hi = block_allreduce(hi, sm, MaxOp());
  id_lo = block_allreduce(id_lo, sm, MinOp());
  id_hi = block_allreduce(id_hi, sm, MaxOp());
  const bool any = total > 0;
  const long long ts_min = any ? lo : 0;
  const long long ts_max = any ? hi : 0;
  const long long kp = ts_max - ts_min + 2;
  const long long max_tsid = any ? id_hi : -1;
  const bool fits = !any || (id_lo >= 0 && max_tsid + 1 <= kI64Max / kp);
  if (fits) {
    // keys are >= 0 here: -1 is "no valid row yet"
    long long run = -1, first = -1;
    for (long long k = k0; k < k1; ++k) {
      const SegSum& q = seg[k];
      if (!(q.flags & kSegAny)) continue;
      const long long fk = (long long)q.first_tsid * kp + (q.first_ts - ts_min);
      const long long lk = (long long)q.last_tsid * kp + (q.last_ts - ts_min);
      if (first < 0) first = fk;
      bad |= fk < run;
      run = lk > run ? lk : run;
    }
    const long long before = block_exclusive(run, sm, MaxOp(), -1LL);
    bad |= first >= 0 && first < before;
  }
  const int sorted = __syncthreads_or(bad ? 1 : 0) == 0 && fits;
  long long off = block_exclusive(cnt, sm, SumOp(), 0LL);
  for (long long k = k0; k < k1; ++k) {
    blk_off[k] = off;
    if (seg[k].flags & kSegAny) off += seg[k].cnt;
  }
  if (tid == 0) {
    scal[0] = ts_min;
    scal[1] = kp;
    scal[2] = (max_tsid + 1) * kp;
    scal[3] = sorted ? 1 : 0;
    scal[4] = total;
  }
}

// The presorted route: one stable partition, the valid rows in row order
// then the invalid ones, written straight into the five sorted columns.
// Segment s's valid rows start at v = blk_off[its block] + the counts of
// the block's segments before it, its invalid rows at n_valid + (its
// first row - v); inside, a ballot a group of 32.
__global__ void __launch_bounds__(kThreads)
    layout_partition_kernel(const long long* __restrict__ ts,
                            const float* __restrict__ val,
                            const int32_t* __restrict__ tsid,
                            const uint8_t* __restrict__ mask, long long n,
                            long long nseg,
                            const int32_t* __restrict__ seg_cnt,
                            const long long* __restrict__ blk_off,
                            const long long* __restrict__ scal,
                            long long* __restrict__ key_s,
                            long long* __restrict__ ts_s,
                            float* __restrict__ val_s,
                            int32_t* __restrict__ tsid_s,
                            uint8_t* __restrict__ valid_s) {
  const int lane = threadIdx.x & 31;
  const long long s =
      (long long)blockIdx.x * kLayoutWarps + (threadIdx.x >> 5);
  // launched right after the scan, before the host reads the route: a
  // table out of order leaves it to the general route
  if (s >= nseg || scal[3] == 0) return;  // warp-uniform
  const long long ts_min = scal[0], kp = scal[1], n_valid = scal[4];
  const long long base = s * kSegRows;
  const unsigned below = (1u << lane) - 1u;
  long long vpos = blk_off[blockIdx.x];
  for (long long k = s - (threadIdx.x >> 5); k < s; ++k) vpos += seg_cnt[k];
  long long ipos = n_valid + (base - vpos);
  for (int it = 0; it < kSegIters; ++it) {
    long long t[kLayoutUnroll];
    float v[kLayoutUnroll];
    int id[kLayoutUnroll];
    bool in[kLayoutUnroll], ok[kLayoutUnroll];
#pragma unroll
    for (int u = 0; u < kLayoutUnroll; ++u) {
      const long long i =
          base + (long long)(it * kLayoutUnroll + u) * 32 + lane;
      in[u] = i < n;
      t[u] = 0;
      v[u] = 0.f;
      id[u] = 0;
      ok[u] = false;
      if (in[u]) {
        t[u] = ts[i];
        v[u] = val[i];
        id[u] = tsid[i];
        ok[u] = mask[i] != 0 && !isnan(v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLayoutUnroll; ++u) {
      const unsigned bal = __ballot_sync(kFull, ok[u]);
      const unsigned inr = __ballot_sync(kFull, in[u]);
      const int r = __popc(bal & below);
      if (in[u]) {
        const long long dst = ok[u] ? vpos + r : ipos + (lane - r);
        key_s[dst] = ok[u] ? (long long)id[u] * kp + (t[u] - ts_min)
                           : kI64Max;
        ts_s[dst] = t[u];
        val_s[dst] = v[u];
        tsid_s[dst] = id[u];
        valid_s[dst] = ok[u] ? 1 : 0;
      }
      vpos += __popc(bal);
      ipos += __popc(inr) - __popc(bal);
    }
  }
}

// The general route's radix input: key[i] = tsid*kp + (ts - ts_min) on
// valid rows, the invalid rows' key (max tsid + 1) * kp on the rest (above
// every valid key, so a stable sort puts them last in row order, exactly
// where the reference's I64_MAX ties land), idx[i] = i.
__global__ void layout_key_kernel(const long long* ts, const float* val,
                                  const int32_t* tsid, const uint8_t* mask,
                                  long long n, const long long* scal,
                                  long long* key, int32_t* idx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long ts_min = scal[0], kp = scal[1], invalid_key = scal[2];
  const bool ok = mask[i] != 0 && !isnan(val[i]);
  key[i] = ok ? (long long)tsid[i] * kp + (ts[i] - ts_min) : invalid_key;
  idx[i] = (int32_t)i;
}


__global__ void layout_gather_kernel(
    const long long* key_sorted, const int32_t* idx, const long long* ts,
    const float* val, const int32_t* tsid, const uint8_t* mask, long long n,
    long long* key_s, long long* ts_s, float* val_s, int32_t* tsid_s,
    uint8_t* valid_s) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = idx[i];
  const float v = val[r];
  const bool ok = mask[r] != 0 && !isnan(v);
  key_s[i] = ok ? key_sorted[i] : kI64Max;
  ts_s[i] = ts[r];
  val_s[i] = v;
  tsid_s[i] = tsid[r];
  valid_s[i] = ok ? 1 : 0;
}


// ---------------------------------------------------------------------------
// counter_window
// ---------------------------------------------------------------------------

enum WindowMode { MODE_INSTANT = 0, MODE_COUNTER = 1, MODE_RATE = 2 };

__device__ __forceinline__ long long search_left(const long long* a,
                                                 long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long search_right(const long long* a,
                                                  long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Geometry {  // the window grid over one sort layout
  const long long* key_s;
  long long n;
  const long long* ts_min_p;
  const long long* kp_p;
  const int32_t* sel;
  long long S, T, start_ms, step_ms, range_ms;
  // the count geometry's state (null: the searchsorted geometry): each
  // selected series' first sorted row and its [S, L] timestamp matrix
  const long long* series_start = nullptr;
  const long long* ts_mat = nullptr;
  long long L = 0;
};

struct Bounds {
  long long lo, hi;
  int cnt;
  bool sel_ok, has;
};

// Window w = s * T + t of the grid: the sorted-row range [lo, hi) of
// (step - range, step].  Two geometries with the same integer bounds on
// every selected series: the count geometry (engine.py:313-328) when the
// state is given, each bound the series' first row plus a count of its
// timestamps <= the threshold (padding holds I64_MAX and never counts),
// else two binary searches over the whole layout (engine.py:330-345).
__device__ __forceinline__ Bounds window_bounds(const Geometry& g,
                                                long long w) {
  const long long s = w / g.T;
  const long long step = g.start_ms + g.step_ms * (w - s * g.T);
  const int sel_t = g.sel[s];
  Bounds b;
  b.sel_ok = sel_t >= 0;
  if (g.ts_mat != nullptr) {
    const long long* row = g.ts_mat + s * g.L;
    const long long lo_t = step - g.range_ms;
    int lo_off = 0, hi_off = 0;
    for (long long j = 0; j < g.L; ++j) {
      const long long t = row[j];
      lo_off += t <= lo_t ? 1 : 0;
      hi_off += t <= step ? 1 : 0;
    }
    const long long start = g.series_start[s];
    b.lo = start + lo_off;
    b.hi = start + hi_off;
    b.cnt = hi_off - lo_off;
    b.has = b.cnt > 0 && b.sel_ok;
    return b;
  }
  const long long ts_min = *g.ts_min_p;
  const long long kp = *g.kp_p;
  const long long skey = (b.sel_ok ? (long long)sel_t : 0LL) * kp;
  const long long rel_lo = clampll(step - g.range_ms + 1 - ts_min, 0, kp - 1);
  const long long rel_hi = clampll(step - ts_min, -1, kp - 1);
  b.lo = search_left(g.key_s, g.n, skey + rel_lo);
  b.hi = search_right(g.key_s, g.n, skey + rel_hi);
  b.cnt = (int)(b.hi - b.lo > 0 ? b.hi - b.lo : 0);
  b.has = b.cnt > 0 && b.sel_ok;
  return b;
}

struct WindowOut {
  float* count;
  long long* first_ts;
  long long* last_ts;
  float* first_val;
  float* last_val;
  float* delta_adj;
  float* delta_raw;
  float* last;
  float* rate;
};

// engine.py:1839 `_extrapolated`, operation for operation, for one window:
// its first and last sample timestamps (ms), its end (ms), its sample
// count, its first value and its counter-adjusted and raw deltas.  Shared
// by counter_window's rate mode and subquery_counter.
__device__ float extrapolated_rate(long long ft_i, long long lt_i,
                                   double range_end, float fcount,
                                   float fv, float d_adj, float d_raw,
                                   int counter, int is_rate,
                                   double range_s) {
  const double rng_ms = range_s * 1000.0;
  const double ft = (double)ft_i;
  const double lt = (double)lt_i;
  const double range_start = range_end - rng_ms;
  const double sampled = (lt - ft) / 1000.0;
  const float cm1 = fcount - 1.0f;
  const double avg_dur = sampled / (double)(cm1 > 1.0f ? cm1 : 1.0f);
  double dur_to_start = (ft - range_start) / 1000.0;
  double dur_to_end = (range_end - lt) / 1000.0;
  const double threshold = avg_dur * 1.1;
  if (dur_to_start >= threshold) dur_to_start = avg_dur / 2;
  if (dur_to_end >= threshold) dur_to_end = avg_dur / 2;
  const double d64 = (double)(counter ? d_adj : d_raw);
  if (counter) {
    const double fv64 = (double)fv;
    const double dur_to_zero =
        d64 > 0 ? sampled * (fv64 / (d64 > 1e-30 ? d64 : 1e-30)) : INFINITY;
    if (isnan(dur_to_zero) || dur_to_zero < dur_to_start) {
      dur_to_start = dur_to_zero;
    }
  }
  const double factor = (sampled + dur_to_start + dur_to_end) /
                        (sampled > 1e-30 ? sampled : 1e-30);
  double result = d64 * factor;
  if (is_rate) result = result / range_s;
  return fcount >= 2.0f ? (float)result : NAN;
}

__global__ void counter_window_kernel(Geometry g, const long long* ts_s,
                                      const float* val_s, const double* gdrop,
                                      int mode, int counter, int is_rate,
                                      double range_s, WindowOut o) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.S * g.T) return;
  const Bounds b = window_bounds(g, i);
  const long long n = g.n;
  const long long step = g.start_ms + g.step_ms * (i % g.T);
  const int cnt = b.cnt;
  const bool has = b.has;
  const bool has2 = cnt >= 2 && b.sel_ok;
  const long long fi = clampll(b.lo, 0, n - 1);
  const long long li = clampll(b.hi - 1, 0, n - 1);
  const float fcount = has ? (float)cnt : 0.0f;
  if (mode == MODE_INSTANT) {
    o.count[i] = fcount;
    o.last[i] = has ? val_s[li] : NAN;
    o.last_ts[i] = has ? ts_s[li] : 0;
    return;
  }
  const long long ft_i = has ? ts_s[fi] : 0;
  const long long lt_i = has ? ts_s[li] : 0;
  const float fv = has ? val_s[fi] : NAN;
  const float lv = has ? val_s[li] : NAN;
  const float d_adj =
      has2 ? (float)(((double)val_s[li] + gdrop[li]) -
                     ((double)val_s[fi] + gdrop[fi]))
           : NAN;
  const float d_raw = has2 ? val_s[li] - val_s[fi] : NAN;
  if (mode == MODE_COUNTER) {
    o.count[i] = fcount;
    o.first_ts[i] = ft_i;
    o.last_ts[i] = lt_i;
    o.first_val[i] = fv;
    o.last_val[i] = lv;
    o.delta_adj[i] = d_adj;
    o.delta_raw[i] = d_raw;
    return;
  }
  o.rate[i] = extrapolated_rate(ft_i, lt_i, (double)step, fcount, fv, d_adj,
                                d_raw, counter, is_rate, range_s);
}

// ---------------------------------------------------------------------------
// series_ranges, gather_ts_mat: the count geometry's state
// ---------------------------------------------------------------------------

// Series s's rows in the sorted layout, [start, start + cnt): skey =
// sel * kp starts the series and skey + kp - 1 lies above its every key
// (rel <= kp - 2) and below the next series' first (engine.py:349-357).
// A pad selection (sel < 0) reads series 0's range and gets cnt 0.  The
// largest count goes to *cnt_max (one atomic a warp), which sizes L.
__global__ void series_ranges_kernel(const long long* key_s, long long n,
                                     const long long* kp_p,
                                     const int32_t* sel, long long S,
                                     long long* start, int32_t* cnt,
                                     int* cnt_max) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int c = 0;
  if (s < S) {
    const long long kp = *kp_p;
    const int sel_t = sel[s];
    const long long skey = (sel_t >= 0 ? (long long)sel_t : 0LL) * kp;
    const long long lo = search_left(key_s, n, skey);
    const long long hi = search_right(key_s, n, skey + (kp - 1));
    start[s] = lo;
    c = sel_t >= 0 ? (int)(hi - lo) : 0;
    cnt[s] = c;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_down_sync(0xffffffffu, c, off);
    c = o > c ? o : c;
  }
  if ((threadIdx.x & 31) == 0 && c > 0) atomicMax(cnt_max, c);
}

// The [S, L] timestamp matrix (engine.py:360-368): ts_s[start + j] for j
// < cnt, I64_MAX after, so a threshold count never takes the padding.
// Only j < cnt reads ts_s, and there start + j < n: a pad row or a series
// starting at n reads nothing.  One thread an element, row-major.
__global__ void gather_ts_mat_kernel(const long long* ts_s,
                                     const long long* start,
                                     const int32_t* cnt, long long S,
                                     long long L, long long* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * L) return;
  const long long s = i / L;
  const long long j = i - s * L;
  out[i] = j < cnt[s] ? ts_s[start[s] + j] : kI64Max;
}

// ---------------------------------------------------------------------------
// window_stats, minmax_window, window_count_max, window_matrix
// ---------------------------------------------------------------------------

enum StatsKind {
  KIND_GAUGE = 0, KIND_COUNTER_RC = 1, KIND_REGRESSION = 2, KIND_IRATE = 3
};

struct StatsOut {
  float* count;
  float* sum;
  float* avg;
  float* var;
  float* last;
  float* first;
  long long* first_ts;
  long long* last_ts;
  float* resets;
  float* changes;
  float* slope;
  float* intercept;
  long long* prev_ts;
  float* last_val;
  float* prev_val;
};

__global__ void window_stats_kernel(Geometry g, const long long* ts_s,
                                    const float* val_s, int kind,
                                    StatsOut o) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.S * g.T) return;
  const Bounds b = window_bounds(g, i);
  const long long n = g.n;
  const long long fi = clampll(b.lo, 0, n - 1);
  const long long li = clampll(b.hi - 1, 0, n - 1);
  const bool has = b.has;
  const bool has2 = b.cnt >= 2 && b.sel_ok;
  if (kind == KIND_IRATE) {
    const long long pi = clampll(b.hi - 2, 0, n - 1);
    o.last_ts[i] = has2 ? ts_s[li] : 0;
    o.prev_ts[i] = has2 ? ts_s[pi] : 0;
    o.last_val[i] = has2 ? val_s[li] : NAN;
    o.prev_val[i] = has2 ? val_s[pi] : NAN;
    return;
  }
  const float fcnt = (float)b.cnt;
  o.count[i] = has ? fcnt : 0.0f;
  if (kind == KIND_COUNTER_RC) {
    int resets = 0, changes = 0;
    if (has) {
      float prev = val_s[b.lo];
      for (long long j = b.lo + 1; j < b.hi; ++j) {
        const float v = val_s[j];
        resets += prev > v ? 1 : 0;
        changes += prev != v ? 1 : 0;
        prev = v;
      }
    }
    o.resets[i] = has ? (float)resets : NAN;
    o.changes[i] = has ? (float)changes : NAN;
    return;
  }
  double sw = 0.0, s2 = 0.0, st = 0.0, stv = 0.0, st2 = 0.0;
  if (has) {
    const long long start_ms = g.start_ms;
    for (long long j = b.lo; j < b.hi; ++j) {
      const double v = (double)val_s[j];
      sw += v;
      if (kind == KIND_GAUGE) {
        s2 += v * v;
      } else {
        const double tsec = (double)(ts_s[j] - start_ms) / 1000.0;
        st += tsec;
        stv += tsec * v;
        st2 += tsec * tsec;
      }
    }
  }
  if (kind == KIND_GAUGE) {
    const float s = (float)sw;
    const double c = (double)(b.cnt > 1 ? b.cnt : 1);
    const double mean = (double)s / c;
    double var = fma(-mean, mean, s2 / c);
    if (var < 0.0) var = 0.0;  // jnp.maximum(var, 0): NaN stays NaN
    o.sum[i] = has ? s : NAN;
    o.avg[i] = has ? s / (fcnt > 1.0f ? fcnt : 1.0f) : NAN;
    o.var[i] = has ? (float)var : NAN;
    o.last[i] = has ? val_s[li] : NAN;
    o.first[i] = has ? val_s[fi] : NAN;
    o.first_ts[i] = has ? ts_s[fi] : 0;
    o.last_ts[i] = has ? ts_s[li] : 0;
    return;
  }
  // KIND_REGRESSION
  const double cn = (double)b.cnt;
  const double denom = cn * st2 - st * st;
  const double slope = denom != 0.0 ? (cn * stv - st * sw) / denom : NAN;
  const double intercept = cn > 0.0 ? (sw - slope * st) / cn : NAN;
  o.slope[i] = has2 ? (float)slope : NAN;
  o.intercept[i] = has2 ? (float)intercept : NAN;
  o.last_ts[i] = has ? ts_s[li] : 0;
}

__global__ void minmax_window_kernel(Geometry g, const float* val_s,
                                     float* out_min, float* out_max) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.S * g.T) return;
  const Bounds b = window_bounds(g, i);
  float mn = INFINITY, mx = -INFINITY;
  if (b.sel_ok) {
    for (long long j = b.lo; j < b.hi; ++j) {
      const float v = val_s[j];
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
    }
  }
  out_min[i] = isfinite(mn) ? mn : NAN;
  out_max[i] = isfinite(mx) ? mx : NAN;
}

__global__ void window_count_max_kernel(Geometry g, int* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int c = 0;
  if (i < g.S * g.T) {
    const Bounds b = window_bounds(g, i);
    c = b.sel_ok ? b.cnt : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_down_sync(0xffffffffu, c, off);
    c = o > c ? o : c;
  }
  if ((threadIdx.x & 31) == 0 && c > 0) atomicMax(out, c);
}

// The reference's q_of: rank = q * max(cnt - 1, 0) in f32, the two
// straddling order statistics (indices clipped to [0, top]), linear
// interpolation.  A NaN rank reads index 0; its result is NaN anyway.
__device__ float q_of(const uint32_t* sorted, float q, int cnt, int top) {
  const float rank = q * (float)(cnt - 1 > 0 ? cnt - 1 : 0);
  int lo_r = 0, hi_r = 0;
  if (!isnan(rank)) {
    const float fl = floorf(rank), ce = ceilf(rank);
    lo_r = fl <= 0.0f ? 0 : (fl >= (float)top ? top : (int)fl);
    hi_r = ce <= 0.0f ? 0 : (ce >= (float)top ? top : (int)ce);
  }
  const float vlo = f32_of_key(sorted[lo_r]);
  const float vhi = f32_of_key(sorted[hi_r]);
  return vlo + (vhi - vlo) * (rank - (float)lo_r);
}

enum MatrixMode { MODE_QUANTILE = 0, MODE_MAD = 1, MODE_HOLT = 2 };

// The window's samples as keys in buf[0, L), ascending, then quantile or
// mad.  `load(j)` gives sample j's key (j < cnt); the rest are padding.
template <typename Load>
__device__ float sorted_reducer(uint32_t* buf, int L, int lane, int cnt,
                                int mode, float q, int top, Load load) {
  for (int j = lane; j < L; j += 32) buf[j] = load(j);
  __syncwarp();
  warp_bitonic_sort(buf, L, lane);
  if (mode == MODE_QUANTILE) {
    const float r = q_of(buf, q, cnt, top);
    return q < 0.0f ? -INFINITY : (q > 1.0f ? INFINITY : r);
  }
  // mad: |x - median| over the same samples (the sorted buffer holds
  // them), sorted again
  const float med = q_of(buf, 0.5f, cnt, top);
  __syncwarp();
  for (int j = lane; j < cnt; j += 32) {
    buf[j] = f32_sort_key(fabsf(f32_of_key(buf[j]) - med));
  }
  __syncwarp();
  warp_bitonic_sort(buf, L, lane);
  return q_of(buf, 0.5f, cnt, top);
}

// Each warp's sort buffer of L keys: in shared memory (scratch null), or
// for windows wider than shared memory holds, its slot of the global
// scratch (one slot per launched warp).
__device__ __forceinline__ uint32_t* warp_buffer(uint32_t* smem,
                                                 uint32_t* scratch,
                                                 long long gwarp, int warp,
                                                 int L) {
  return scratch != nullptr ? scratch + gwarp * (long long)L
                            : smem + (size_t)warp * L;
}

// Warps stride over groups of 32 consecutive windows of the sort layout's
// grid: lane i finds the bounds of window w0 + i (32 binary searches in
// flight at once), then the warp sorts the windows one after another; for
// holt each lane scans its own window.  `lmax` is the reference's padded
// width: the rank clip and the Holt scan follow it.
__global__ void window_matrix_kernel(Geometry g, const float* val_s, int lmax,
                                     int mode, const float* a1,
                                     const float* a2, uint32_t* scratch,
                                     float* out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long W = g.S * g.T;
  const long long n = g.n;
  const long long gwarp = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const long long nwarps = (long long)gridDim.x * (blockDim.x >> 5);
  uint32_t* buf = warp_buffer(smem, scratch, gwarp, warp, lmax);
  for (long long w0 = gwarp * 32; w0 < W; w0 += nwarps * 32) {  // warp-uniform
    const long long mine = w0 + lane;
    Bounds b{0, 0, 0, false, false};
    if (mine < W) b = window_bounds(g, mine);
    if (mode == MODE_HOLT) {
      if (mine >= W) continue;
      const long long t = mine % g.T;
      const float sf = a1[t], tf = a2[t];
      float s = val_s[clampll(b.lo, 0, n - 1)];
      float bb = val_s[clampll(b.lo + 1, 0, n - 1)] - s;
      for (int i = 1; i < b.cnt && i < lmax; ++i) {
        const float x = val_s[b.lo + i];
        const float s1 = fmaf(sf, x, (1.0f - sf) * (s + bb));
        const float b1 = fmaf(1.0f - tf, bb, tf * (s1 - s));
        s = s1;
        bb = b1;
      }
      const bool param_ok = sf > 0.0f && sf < 1.0f && tf > 0.0f && tf < 1.0f;
      const float res = b.cnt >= 2 && param_ok ? s : NAN;
      out[mine] = b.cnt > 0 && b.has ? res : NAN;
      continue;
    }
    const int count = W - w0 < 32 ? (int)(W - w0) : 32;
    for (int i = 0; i < count; ++i) {
      const long long lo = __shfl_sync(0xffffffffu, b.lo, i);
      const int cnt = __shfl_sync(0xffffffffu, b.cnt, i);
      const int has = __shfl_sync(0xffffffffu, b.has ? 1 : 0, i);
      const long long w = w0 + i;
      const float res = sorted_reducer(
          buf, lmax, lane, cnt, mode, a1[w % g.T], lmax - 1, [&](int j) {
            return j < cnt ? f32_sort_key(val_s[lo + j]) : kPadKey;
          });
      if (lane == 0) out[w] = cnt > 0 && has ? res : NAN;
      __syncwarp();  // every lane is done with buf before the next window
    }
  }
}

// Warps stride over the windows of a subquery's [S*T, K] window matrix (NaN
// = not a sample), one window at a time; buffer width L (a power of two
// >= K).
__global__ void window_matrix_dense_kernel(const float* win, long long W,
                                           long long K, long long T, int L,
                                           int mode, const float* a1,
                                           uint32_t* scratch, float* out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long gwarp = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const long long nwarps = (long long)gridDim.x * (blockDim.x >> 5);
  uint32_t* buf = warp_buffer(smem, scratch, gwarp, warp, L);
  for (long long w = gwarp; w < W; w += nwarps) {  // warp-uniform
    const float* x = win + w * K;
    int cnt = 0;
    for (long long k = lane; k < K; k += 32) cnt += isnan(x[k]) ? 0 : 1;
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    // absent entries sort last: as +inf in the reference, only ranks below
    // cnt are read for q in [0, 1]
    const float res = sorted_reducer(
        buf, L, lane, cnt, mode, a1[w % T], (int)K - 1, [&](int j) {
          const float v = j < K ? x[j] : NAN;
          return isnan(v) ? kPadKey : f32_sort_key(v);
        });
    if (lane == 0) out[w] = cnt > 0 ? res : NAN;
    __syncwarp();  // every lane is done with buf before the next window
  }
}

// Launch shape of the two sorting kernels: with no scratch, blocks of up to
// 8 warps whose buffers fit 48 KB of shared memory (one warp past that,
// with the opt-in attribute set), enough blocks for every task once; with a
// global scratch, one warp per block and one block per scratch slot.
struct MatrixLaunch {
  unsigned blocks;
  int threads;
  size_t smem;
};

MatrixLaunch matrix_launch(long long tasks, int L, int scratch_warps) {
  if (scratch_warps > 0) return {(unsigned)scratch_warps, 32, 0};
  const long long per = (long long)L * 4;
  const long long fit = 49152 / (per > 0 ? per : 1);
  const int warps = fit >= 8 ? 8 : (fit >= 1 ? (int)fit : 1);
  return {(unsigned)((tasks + warps - 1) / warps), warps * 32,
          (size_t)warps * (size_t)L * 4};
}

template <typename Kernel>
int opt_in_smem(Kernel k, size_t bytes) {
  if (bytes <= 49152) return 0;
  return (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// subquery_counter
// ---------------------------------------------------------------------------

enum SubqueryMode { SUBQ_RATE = 0, SUBQ_PAIR = 1 };

// One thread per window w = s * T + t of a subquery's [S*T, K] window
// matrix (NaN = not a sample; sample k of step t was taken at ts_tk[t, k]):
// one pass in window order counts the samples, finds the first, last and
// second-to-last, and sums the counter-reset drops (the fori_loop of
// engine.py:1342-1354, a sequential f32 sum).  Indices clip as the
// reference's take_along_axis gathers clip them.  SUBQ_RATE then finishes
// rate/increase/delta with extrapolated_rate against the step's end
// steps[t]; SUBQ_PAIR writes the last two samples for irate/idelta.
__global__ void subquery_counter_kernel(
    const float* win, long long W, long long K, long long T,
    const long long* ts_tk, const long long* steps, int mode, int counter,
    int is_rate, double range_s, float* rate, float* count,
    long long* last_ts, long long* prev_ts, float* last_val,
    float* prev_val) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const long long t = w % T;
  const float* x = win + w * K;
  const long long* ts = ts_tk + t * K;
  int cnt = 0;
  long long first_k = K, last_k = -1, prev_k = -1;
  float prev = 0.0f, drops = 0.0f;
  for (long long k = 0; k < K; ++k) {
    const float v = x[k];
    if (isnan(v)) continue;
    if (cnt > 0 && prev > v) drops = drops + prev;
    prev = v;
    if (cnt == 0) first_k = k;
    prev_k = last_k;
    last_k = k;
    ++cnt;
  }
  const long long fk = clampll(first_k, 0, K - 1);
  const long long lk = clampll(last_k, 0, K - 1);
  const float fcount = (float)cnt;
  if (mode == SUBQ_PAIR) {
    const long long pk = clampll(prev_k, 0, K - 1);
    count[w] = fcount;
    last_ts[w] = ts[lk];
    prev_ts[w] = ts[pk];
    last_val[w] = x[lk];
    prev_val[w] = x[pk];
    return;
  }
  const float fv = x[fk];
  const float d_raw = x[lk] - fv;
  const float d_adj = d_raw + drops;
  rate[w] = extrapolated_rate(ts[fk], ts[lk], (double)steps[t], fcount, fv,
                              d_adj, d_raw, counter, is_rate, range_s);
}

}  // namespace

extern "C" {

int gt_scan_drop_f64(const float* val, const int32_t* tsid,
                     const uint8_t* valid, long long n, double* tile_sums,
                     double* out, void* stream) {
  return launch_scan<double, DropSrc>(DropSrc{val, tsid, valid}, n, tile_sums,
                                      out, (cudaStream_t)stream);
}

// Pass 1 of both sort_layout routes: segment counts (seg_cnt [nseg]) and
// block summaries (blk: scratch of nblk SegSums, 64 bytes each, nblk =
// ceil(nseg / 8)), then the scalars (scal, 5 words) and each block's
// valid-row offset (blk_off [nblk]).
int gt_layout_scan(const long long* ts, const float* val, const int32_t* tsid,
                   const uint8_t* mask, long long n, int32_t* seg_cnt,
                   void* blk, long long* blk_off, long long* scal,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nseg = (n + kSegRows - 1) / kSegRows;
  const long long nblk = (nseg + kLayoutWarps - 1) / kLayoutWarps;
  if (nblk > 0) {
    layout_scan_kernel<<<(unsigned)nblk, kThreads, 0, st>>>(
        ts, val, tsid, mask, n, nseg, seg_cnt, (SegSum*)blk);
    if (int e = last_error()) return e;
  }
  layout_finalize_kernel<<<1, kFinThreads, 0, st>>>((const SegSum*)blk,
                                                    nblk, blk_off, scal);
  return last_error();
}

// The presorted route's one pass (after gt_layout_scan; a no-op unless
// scal[3] says the valid keys are in row order): the five sorted columns,
// each [n].
int gt_layout_partition(const long long* ts, const float* val,
                        const int32_t* tsid, const uint8_t* mask, long long n,
                        const int32_t* seg_cnt, const long long* blk_off,
                        const long long* scal, long long* key_s,
                        long long* ts_s, float* val_s, int32_t* tsid_s,
                        uint8_t* valid_s, void* stream) {
  const long long nseg = (n + kSegRows - 1) / kSegRows;
  if (nseg <= 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((nseg + kLayoutWarps - 1) / kLayoutWarps);
  layout_partition_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ts, val, tsid, mask, n, nseg, seg_cnt, blk_off, scal, key_s, ts_s,
      val_s, tsid_s, valid_s);
  return last_error();
}

// The general route's radix input (after gt_layout_scan): key, idx [n].
int gt_layout_key(const long long* ts, const float* val, const int32_t* tsid,
                  const uint8_t* mask, long long n, const long long* scal,
                  long long* key, int32_t* idx, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  layout_key_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      ts, val, tsid, mask, n, scal, key, idx);
  return last_error();
}

int gt_radix_pass(const long long* key_in, const int32_t* idx_in, long long n,
                  int shift, int32_t* zeros, int32_t* tile_sums,
                  long long* key_out, int32_t* idx_out, void* stream) {
  return radix_pass(key_in, idx_in, n, shift, zeros, tile_sums, key_out,
                    idx_out, (cudaStream_t)stream);
}

int gt_layout_gather(const long long* key_sorted, const int32_t* idx,
                     const long long* ts, const float* val,
                     const int32_t* tsid, const uint8_t* mask, long long n,
                     long long* key_s, long long* ts_s, float* val_s,
                     int32_t* tsid_s, uint8_t* valid_s, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  layout_gather_kernel<<<blocks_for(n), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      key_sorted, idx, ts, val, tsid, mask, n, key_s, ts_s, val_s, tsid_s,
      valid_s);
  if (int e = last_error()) return e;
  return 0;
}

int gt_series_ranges(const long long* key_s, long long n,
                     const long long* kp, const int32_t* sel, long long S,
                     long long* start, int32_t* cnt, int* cnt_max,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (int e = (int)cudaMemsetAsync(cnt_max, 0, sizeof(int), st)) return e;
  if (S <= 0) return (int)cudaGetLastError();
  series_ranges_kernel<<<blocks_for(S), kThreads, 0, st>>>(
      key_s, n, kp, sel, S, start, cnt, cnt_max);
  return last_error();
}

int gt_gather_ts_mat(const long long* ts_s, const long long* start,
                     const int32_t* cnt, long long S, long long L,
                     long long* out, void* stream) {
  if (S * L <= 0) return (int)cudaGetLastError();
  gather_ts_mat_kernel<<<blocks_for(S * L), kThreads, 0,
                         (cudaStream_t)stream>>>(ts_s, start, cnt, S, L,
                                                 out);
  return last_error();
}

int gt_counter_window(const long long* key_s, const long long* ts_s,
                      const float* val_s, const double* gdrop, long long n,
                      const long long* ts_min, const long long* kp,
                      const int32_t* sel, long long S, long long T,
                      long long start_ms, long long step_ms,
                      long long range_ms, const long long* series_start,
                      const long long* ts_mat, long long L, int mode,
                      int counter, int is_rate, double range_s, float* count,
                      long long* first_ts, long long* last_ts,
                      float* first_val, float* last_val, float* delta_adj,
                      float* delta_raw, float* last, float* rate,
                      void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0) return (int)cudaGetLastError();
  WindowOut o{count, first_ts, last_ts, first_val, last_val,
              delta_adj, delta_raw, last, rate};
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             series_start, ts_mat, L};
  counter_window_kernel<<<blocks_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
      g, ts_s, val_s, gdrop, mode, counter, is_rate, range_s, o);
  if (int e = last_error()) return e;
  return 0;
}

int gt_window_stats(const long long* key_s, const long long* ts_s,
                    const float* val_s, long long n, const long long* ts_min,
                    const long long* kp, const int32_t* sel, long long S,
                    long long T, long long start_ms, long long step_ms,
                    long long range_ms, const long long* series_start,
                    const long long* ts_mat, long long L, int kind,
                    float* count, float* sum,
                    float* avg, float* var, float* last, float* first,
                    long long* first_ts, long long* last_ts, float* resets,
                    float* changes, float* slope, float* intercept,
                    long long* prev_ts, float* last_val, float* prev_val,
                    void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0) return (int)cudaGetLastError();
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             series_start, ts_mat, L};
  StatsOut o{count, sum, avg, var, last, first, first_ts, last_ts, resets,
             changes, slope, intercept, prev_ts, last_val, prev_val};
  window_stats_kernel<<<blocks_for(total), kThreads, 0,
                        (cudaStream_t)stream>>>(g, ts_s, val_s, kind, o);
  return last_error();
}

int gt_minmax_window(const long long* key_s, const float* val_s, long long n,
                     const long long* ts_min, const long long* kp,
                     const int32_t* sel, long long S, long long T,
                     long long start_ms, long long step_ms,
                     long long range_ms, const long long* series_start,
                     const long long* ts_mat, long long L, float* out_min,
                     float* out_max, void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0) return (int)cudaGetLastError();
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             series_start, ts_mat, L};
  minmax_window_kernel<<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(g, val_s, out_min, out_max);
  return last_error();
}

int gt_window_count_max(const long long* key_s, long long n,
                        const long long* ts_min, const long long* kp,
                        const int32_t* sel, long long S, long long T,
                        long long start_ms, long long step_ms,
                        long long range_ms, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (int e = (int)cudaMemsetAsync(out, 0, sizeof(int), st)) return e;
  const long long total = S * T;
  if (total <= 0 || n <= 0) return (int)cudaGetLastError();
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms};
  window_count_max_kernel<<<blocks_for(total), kThreads, 0, st>>>(g, out);
  return last_error();
}

int gt_window_matrix(const long long* key_s, const float* val_s, long long n,
                     const long long* ts_min, const long long* kp,
                     const int32_t* sel, long long S, long long T,
                     long long start_ms, long long step_ms,
                     long long range_ms, int lmax, int mode, const float* a1,
                     const float* a2, uint32_t* scratch, int scratch_warps,
                     float* out, void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0) return (int)cudaGetLastError();
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms};
  // holt keeps no buffer; the sorts take 32 windows per warp
  const long long groups = (total + 31) / 32;
  MatrixLaunch l = mode == MODE_HOLT ? MatrixLaunch{
      (unsigned)((groups + 7) / 8), 256, 0}
      : matrix_launch(groups, lmax, scratch_warps);
  if (mode == MODE_HOLT) scratch = nullptr;
  if (int e = opt_in_smem(window_matrix_kernel, l.smem)) return e;
  window_matrix_kernel<<<l.blocks, l.threads, l.smem,
                         (cudaStream_t)stream>>>(g, val_s, lmax, mode, a1, a2,
                                                 scratch, out);
  return last_error();
}

int gt_window_matrix_dense(const float* win, long long W, long long K,
                           long long T, int L, int mode, const float* a1,
                           uint32_t* scratch, int scratch_warps, float* out,
                           void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  const MatrixLaunch l = matrix_launch(W, L, scratch_warps);
  if (int e = opt_in_smem(window_matrix_dense_kernel, l.smem)) return e;
  window_matrix_dense_kernel<<<l.blocks, l.threads, l.smem,
                               (cudaStream_t)stream>>>(win, W, K, T, L, mode,
                                                       a1, scratch, out);
  return last_error();
}

int gt_subquery_counter(const float* win, long long W, long long K,
                        long long T, const long long* ts_tk,
                        const long long* steps, int mode, int counter,
                        int is_rate, double range_s, float* rate,
                        float* count, long long* last_ts, long long* prev_ts,
                        float* last_val, float* prev_val, void* stream) {
  if (W <= 0 || K <= 0) return (int)cudaGetLastError();
  subquery_counter_kernel<<<blocks_for(W), kThreads, 0,
                            (cudaStream_t)stream>>>(
      win, W, K, T, ts_tk, steps, mode, counter, is_rate, range_s, rate,
      count, last_ts, prev_ts, last_val, prev_val);
  return last_error();
}

}  // extern "C"
