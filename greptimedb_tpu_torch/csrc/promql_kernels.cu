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
// sort_layout (layout_key + radix_split passes + layout_gather)
//   Replaces K8, `_build_sort_layout` (engine.py:257): the query-
//   independent composite-key stable sort of a resident table.
//   layout_key: one grid-stride reduction finds ts_min/ts_max/max tsid over
//   the valid rows (valid = mask & !isnan(val); 64-bit atomicMin/Max — order
//   free, so deterministic), then key[i] = tsid*kp + (ts - ts_min) with
//   kp = ts_max - ts_min + 2 on valid rows.  Invalid rows take the sort key
//   (max_tsid + 1) * kp, above every valid key, so a stable sort puts them
//   last in row order, exactly where the reference's I64_MAX ties land.
//   radix_split: a stable LSD radix sort of (key, row index), one bit per
//   pass, each pass scan.cuh's radix_pass (a "bit is zero" scan plus a scatter:
//   dst = zero ? zeros_before : total_zeros + ones_before); only as many
//   passes run as the invalid-row key has bits (40 at 1 M series x 585 s).
//   layout_gather writes key_s (I64_MAX on invalid rows), ts_s, val_s,
//   tsid_s and valid_s in one launch.
//   Bound: bytes.  One pass per bit reads the key twice for the scan and
//   once more with the row index for the scatter, which writes both again:
//   ~44 B/row/pass.  The one-pass bound (read ts/val/tsid/mask 17 B, write
//   the five sorted arrays 25 B) is 42 B/row; the 40 passes are the price
//   of the simple design (a onesweep radix sort is later work).
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

// acc: [0] ts_min, [1] ts_max, [2] max tsid, [3] any valid row
__global__ void layout_init_kernel(long long* acc) {
  acc[0] = kI64Max;
  acc[1] = -(1LL << 62);
  acc[2] = -1;
  acc[3] = 0;
}

__global__ void layout_minmax_kernel(const long long* ts, const float* val,
                                     const int32_t* tsid, const uint8_t* mask,
                                     long long n, long long* acc) {
  long long lo = kI64Max, hi = -(1LL << 62), tmax = -1, any = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (mask[i] != 0 && !isnan(val[i])) {
      const long long t = ts[i];
      lo = t < lo ? t : lo;
      hi = t > hi ? t : hi;
      tmax = tsid[i] > tmax ? tsid[i] : tmax;
      any = 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const long long olo = __shfl_down_sync(0xffffffffu, lo, off);
    const long long ohi = __shfl_down_sync(0xffffffffu, hi, off);
    const long long otm = __shfl_down_sync(0xffffffffu, tmax, off);
    const long long oan = __shfl_down_sync(0xffffffffu, any, off);
    lo = olo < lo ? olo : lo;
    hi = ohi > hi ? ohi : hi;
    tmax = otm > tmax ? otm : tmax;
    any = oan > any ? oan : any;
  }
  if ((threadIdx.x & 31) == 0 && any) {
    atomicMin(&acc[0], lo);
    atomicMax(&acc[1], hi);
    atomicMax(&acc[2], tmax);
    atomicMax(&acc[3], any);
  }
}

// scal: [0] ts_min, [1] kp, [2] the invalid rows' sort key
__global__ void layout_key_kernel(const long long* ts, const float* val,
                                  const int32_t* tsid, const uint8_t* mask,
                                  long long n, const long long* acc,
                                  long long* key, int32_t* idx,
                                  long long* scal) {
  const bool any = acc[3] != 0;
  const long long ts_min = any ? acc[0] : 0;
  const long long ts_max = any ? acc[1] : 0;
  const long long kp = ts_max - ts_min + 2;
  const long long invalid_key = (acc[2] + 1) * kp;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    scal[0] = ts_min;
    scal[1] = kp;
    scal[2] = invalid_key;
  }
  if (i >= n) return;
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

__global__ void counter_window_kernel(
    const long long* key_s, const long long* ts_s, const float* val_s,
    const double* gdrop, long long n, const long long* ts_min_p,
    const long long* kp_p, const int32_t* sel, long long S, long long T,
    long long start_ms, long long step_ms, long long range_ms, int mode,
    int counter, int is_rate, double range_s, WindowOut o) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * T) return;
  const long long s = i / T;
  const long long t = i - s * T;
  const long long ts_min = *ts_min_p;
  const long long kp = *kp_p;
  const int sel_t = sel[s];
  const bool sel_ok = sel_t >= 0;
  const long long skey = (sel_ok ? (long long)sel_t : 0LL) * kp;
  const long long step = start_ms + step_ms * t;
  const long long rel_lo = clampll(step - range_ms + 1 - ts_min, 0, kp - 1);
  const long long rel_hi = clampll(step - ts_min, -1, kp - 1);
  const long long lo = search_left(key_s, n, skey + rel_lo);
  const long long hi = search_right(key_s, n, skey + rel_hi);
  const int cnt = (int)(hi - lo > 0 ? hi - lo : 0);
  const bool has = cnt > 0 && sel_ok;
  const bool has2 = cnt >= 2 && sel_ok;
  const long long fi = clampll(lo, 0, n - 1);
  const long long li = clampll(hi - 1, 0, n - 1);
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
  // MODE_RATE: engine.py:1839 `_extrapolated`, operation for operation.
  const double rng_ms = range_s * 1000.0;
  const double ft = (double)ft_i;
  const double lt = (double)lt_i;
  const double range_end = (double)step;
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
  o.rate[i] = fcount >= 2.0f ? (float)result : NAN;
}

}  // namespace

extern "C" {

int gt_scan_drop_f64(const float* val, const int32_t* tsid,
                     const uint8_t* valid, long long n, double* tile_sums,
                     double* out, void* stream) {
  return launch_scan<double, DropSrc>(DropSrc{val, tsid, valid}, n, tile_sums,
                                      out, (cudaStream_t)stream);
}

int gt_layout_key(const long long* ts, const float* val, const int32_t* tsid,
                  const uint8_t* mask, long long n, long long* acc,
                  long long* key, int32_t* idx, long long* scal,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  layout_init_kernel<<<1, 1, 0, st>>>(acc);
  if (int e = last_error()) return e;
  if (n > 0) {
    const long long want = blocks_for(n);
    const unsigned grid = (unsigned)(want < 4096 ? want : 4096);
    layout_minmax_kernel<<<grid, kThreads, 0, st>>>(ts, val, tsid,
                                                            mask, n, acc);
    if (int e = last_error()) return e;
  }
  layout_key_kernel<<<blocks_for(n > 0 ? n : 1), kThreads, 0, st>>>(
      ts, val, tsid, mask, n, acc, key, idx, scal);
  if (int e = last_error()) return e;
  return 0;
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

int gt_counter_window(const long long* key_s, const long long* ts_s,
                      const float* val_s, const double* gdrop, long long n,
                      const long long* ts_min, const long long* kp,
                      const int32_t* sel, long long S, long long T,
                      long long start_ms, long long step_ms,
                      long long range_ms, int mode, int counter, int is_rate,
                      double range_s, float* count, long long* first_ts,
                      long long* last_ts, float* first_val, float* last_val,
                      float* delta_adj, float* delta_raw, float* last,
                      float* rate, void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0) return (int)cudaGetLastError();
  WindowOut o{count, first_ts, last_ts, first_val, last_val,
              delta_adj, delta_raw, last, rate};
  counter_window_kernel<<<blocks_for(total), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      key_s, ts_s, val_s, gdrop, n, ts_min, kp, sel, S, T, start_ms, step_ms,
      range_ms, mode, counter, is_rate, range_s, o);
  if (int e = last_error()) return e;
  return 0;
}

}  // extern "C"
