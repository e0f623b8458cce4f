// Variants of counter_window's rate mode and window_stats' gauge kind in
// the range geometry, for probes/window_bodies.py: the port's own
// csrc/promql_kernels.cu is compiled into this file, so each variant is
// the port's kernel body with one part changed.
//
// cw_kernel<PAIR, DROPS, MINB> (rate mode, counter on):
//   PAIR   the window's two searches in one loop (interleaved lower and
//          upper bounds over the series' rows, the same integers) instead
//          of window_bounds' two loops one after the other;
//   DROPS  0: each thread sums its window's drops in row order (the
//          port); 1: no drops (d_adj = d_raw: the body's cost without its
//          loop, a wrong rate); 2: each warp writes the f64 prefix of the
//          drops over the span of rows its windows cover (<= kSpan rows,
//          a shuffle scan a 32-row chunk) into shared memory and a
//          window's sum is the difference of two prefixes; a wider span
//          sums in row order as the port does;
//          3: the port's row-order sum on 32-bit offsets from the
//          window's first row, unrolled by 4; 4: the same through __ldg;
//          5: a compare-only pass over the window first, the row-order f64
//          sum (3) only where it saw a drop (3-5 are bit for bit the port);
//   MINB   __launch_bounds__' minimum blocks of 256 an SM (1: no limit).
// gauge_kernel<PAIR, BODY, MINB> (window_stats' gauge kind):
//   BODY   0: the port's f64 loop; 1: no loop (the sums 0: the bounds, the
//          first/last gathers and the eight stores alone).
// kMode, kStats: the port's counter_window_kernel<MODE, MINB> and
//   window_stats_kernel<KIND, MINB> for every mode and kind under each
//   minimum blocks an SM of kMinb (the port launches minimum 1 below
//   kDenseSteps steps, kCounterDenseMinb / kStatsDenseMinb from there).
//
// Built by probes/window_bodies.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o probes/build/libprobe_window_bodies.so
//        probes/window_bodies.cu

#include "../greptimedb_tpu_torch/csrc/promql_kernels.cu"

namespace {

constexpr int kSpan = 128;  // rows of a warp's prefix (1 KB of f64)

// window_bounds' range geometry with its two searches in one loop
__device__ __forceinline__ Bounds bounds_pair(const Geometry& g,
                                              long long w) {
  const long long s = w / g.T;
  const long long step = g.start_ms + g.step_ms * (w - s * g.T);
  const int sel_t = g.sel[s];
  Bounds b;
  b.sel_ok = sel_t >= 0;
  b.step = step;
  const long long ts_min = *g.ts_min_p;
  const long long kp = *g.kp_p;
  const long long t = b.sel_ok ? (long long)sel_t : 0LL;
  const long long skey = t * kp;
  const long long x_lo = skey + clampll(step - g.range_ms + 1 - ts_min, 0,
                                        kp - 1);
  const long long x_hi = skey + clampll(step - ts_min, -1, kp - 1);
  const long long r = t < g.n_off - 2 ? t : g.n_off - 2;
  const long long base = g.series_off[r];
  const long long* k = g.key_s + base;
  long long lf = 0, lc = g.series_off[r + 1] - base, hf = 0, hc = lc;
  while (lc > 0 || hc > 0) {
    if (lc > 0) {
      const long long h = lc >> 1;
      if (k[lf + h] < x_lo) { lf += h + 1; lc -= h + 1; } else { lc = h; }
    }
    if (hc > 0) {
      const long long h = hc >> 1;
      if (k[hf + h] <= x_hi) { hf += h + 1; hc -= h + 1; } else { hc = h; }
    }
  }
  b.lo = base + lf;
  b.hi = base + hf;
  b.cnt = (int)(b.hi - b.lo > 0 ? b.hi - b.lo : 0);
  b.has = b.cnt > 0 && b.sel_ok;
  return b;
}

template <bool PAIR>
__device__ __forceinline__ Bounds bounds_of(const Geometry& g, long long w) {
  return PAIR ? bounds_pair(g, w) : window_bounds(g, w);
}

__device__ __forceinline__ double drops_in_order(const float* val_s,
                                                 long long fi, long long li) {
  double dsum = 0.0;
  float prev = val_s[fi];
  for (long long j = fi + 1; j <= li; ++j) {
    const float v = val_s[j];
    if (prev > v) dsum += (double)prev;
    prev = v;
  }
  return dsum;
}

template <bool LDG>
__device__ __forceinline__ double drops_loop32(const float* val_s,
                                               long long fi, long long li) {
  const float* p = val_s + fi;
  const int m = (int)(li - fi);
  double dsum = 0.0;
  float prev = LDG ? __ldg(p) : p[0];
#pragma unroll 4
  for (int k = 1; k <= m; ++k) {
    const float v = LDG ? __ldg(p + k) : p[k];
    if (prev > v) dsum += (double)prev;
    prev = v;
  }
  return dsum;
}

__device__ __forceinline__ double drops_two_pass(const float* val_s,
                                                 long long fi, long long li) {
  const float* p = val_s + fi;
  const int m = (int)(li - fi);
  bool any = false;
  float prev = p[0];
#pragma unroll 4
  for (int k = 1; k <= m; ++k) {
    const float v = p[k];
    any |= prev > v;
    prev = v;
  }
  return any ? drops_loop32<false>(val_s, fi, li) : 0.0;
}

template <bool PAIR, int DROPS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    cw_kernel(Geometry g, const long long* ts_s, const float* val_s,
              int is_rate, double range_s, float* rate) {
  __shared__ double pre[kThreads / 32][kSpan];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < g.S * g.T;
  if (DROPS != 2 && !live) return;
  Bounds b{0, 0, 0, false, false, 0};
  if (live) b = bounds_of<PAIR>(g, i);
  const long long n = g.n;
  const bool has = b.has;
  const bool has2 = b.cnt >= 2 && b.sel_ok;
  const long long fi = clampll(b.lo, 0, n - 1);
  const long long li = clampll(b.hi - 1, 0, n - 1);
  double dsum = 0.0;
  if (DROPS == 0 && has2) dsum = drops_in_order(val_s, fi, li);
  if (DROPS == 3 && has2) dsum = drops_loop32<false>(val_s, fi, li);
  if (DROPS == 4 && has2) dsum = drops_loop32<true>(val_s, fi, li);
  if (DROPS == 5 && has2) dsum = drops_two_pass(val_s, fi, li);
  if (DROPS == 2) {
    const int lane = threadIdx.x & 31;
    long long a = has2 ? fi : kI64Max, z = has2 ? li : -1;
    for (int o = 16; o > 0; o >>= 1) {
      const long long oa = __shfl_xor_sync(kAllLanes, a, o);
      const long long oz = __shfl_xor_sync(kAllLanes, z, o);
      a = oa < a ? oa : a;
      z = oz > z ? oz : z;
    }
    if (z >= a && z - a < kSpan) {  // warp-uniform
      double* p = pre[threadIdx.x >> 5];
      double carry = 0.0;
      for (long long c = a; c <= z; c += 32) {
        const long long j = c + lane;
        double d = 0.0;
        if (j > a && j <= z) {
          const float pv = val_s[j - 1], v = val_s[j];
          d = pv > v ? (double)pv : 0.0;
        }
        for (int o = 1; o < 32; o <<= 1) {
          const double y = __shfl_up_sync(kAllLanes, d, o);
          if (lane >= o) d += y;
        }
        d += carry;
        if (j <= z) p[j - a] = d;
        carry = __shfl_sync(kAllLanes, d, 31);
      }
      __syncwarp();
      if (has2) dsum = p[li - a] - p[fi - a];
    } else if (has2) {
      dsum = drops_in_order(val_s, fi, li);
    }
    if (!live) return;
  }
  const float fcount = has ? (float)b.cnt : 0.0f;
  const long long ft_i = has ? ts_s[fi] : 0;
  const long long lt_i = has ? ts_s[li] : 0;
  const float fv = has ? val_s[fi] : NAN;
  const float d_raw = has2 ? val_s[li] - val_s[fi] : NAN;
  const float d_adj =
      !has2 ? NAN
            : (DROPS == 1 ? d_raw
                          : (float)(((double)val_s[li] - (double)val_s[fi]) +
                                    dsum));
  rate[i] = extrapolated_rate(ft_i, lt_i, (double)b.step, fcount, fv, d_adj,
                              d_raw, 1, is_rate, range_s);
}

template <bool PAIR, int BODY, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    gauge_kernel(Geometry g, const long long* ts_s, const float* val_s,
                 StatsOut o) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.S * g.T) return;
  const Bounds b = bounds_of<PAIR>(g, i);
  const long long n = g.n;
  const long long fi = clampll(b.lo, 0, n - 1);
  const long long li = clampll(b.hi - 1, 0, n - 1);
  const bool has = b.has;
  const float fcnt = (float)b.cnt;
  o.count[i] = has ? fcnt : 0.0f;
  double sw = 0.0, s2 = 0.0;
  if (BODY == 0 && has) {
    for (long long j = b.lo; j < b.hi; ++j) {
      const double v = (double)val_s[j];
      sw += v;
      s2 += v * v;
    }
  }
  const float s = (float)sw;
  const double c = (double)(b.cnt > 1 ? b.cnt : 1);
  const double mean = (double)s / c;
  double var = fma(-mean, mean, s2 / c);
  if (var < 0.0) var = 0.0;
  o.sum[i] = has ? s : NAN;
  o.avg[i] = has ? s / (fcnt > 1.0f ? fcnt : 1.0f) : NAN;
  o.var[i] = has ? (float)var : NAN;
  o.last[i] = has ? val_s[li] : NAN;
  o.first[i] = has ? val_s[fi] : NAN;
  o.first_ts[i] = has ? ts_s[fi] : 0;
  o.last_ts[i] = has ? ts_s[li] : 0;
}

using CwFn = void (*)(Geometry, const long long*, const float*, int, double,
                      float*);
using GaugeFn = void (*)(Geometry, const long long*, const float*, StatsOut);

// the variants in the order probes/window_bodies.py names them
const CwFn kCw[] = {
    cw_kernel<false, 0, 1>, cw_kernel<false, 1, 1>, cw_kernel<false, 2, 1>,
    cw_kernel<true, 0, 1>,  cw_kernel<true, 2, 1>,  cw_kernel<false, 0, 4>,
    cw_kernel<false, 0, 6>, cw_kernel<true, 2, 6>,  cw_kernel<false, 1, 6>,
    cw_kernel<false, 3, 1>, cw_kernel<false, 3, 6>,  cw_kernel<false, 4, 6>,
    cw_kernel<false, 5, 6>, cw_kernel<false, 3, 8>,  cw_kernel<false, 1, 8>,
};
const GaugeFn kGauge[] = {
    gauge_kernel<false, 0, 1>, gauge_kernel<false, 1, 1>,
    gauge_kernel<true, 0, 1>,  gauge_kernel<false, 0, 4>,
    gauge_kernel<false, 0, 6>, gauge_kernel<true, 0, 6>,
};

using ModeFn = void (*)(Geometry, const long long*, const float*, int, int,
                        double, WindowOut);
using StatsFn = void (*)(Geometry, const long long*, const float*, StatsOut);
const int kMinb[] = {1, 4, 5, 6, 8};
#define GT_MINBS(K, M) {K<M, 1>, K<M, 4>, K<M, 5>, K<M, 6>, K<M, 8>}
const ModeFn kMode[3][5] = {
    GT_MINBS(counter_window_kernel, MODE_INSTANT),
    GT_MINBS(counter_window_kernel, MODE_COUNTER),
    GT_MINBS(counter_window_kernel, MODE_RATE)};
const StatsFn kStats[4][5] = {
    GT_MINBS(window_stats_kernel, KIND_GAUGE),
    GT_MINBS(window_stats_kernel, KIND_COUNTER_RC),
    GT_MINBS(window_stats_kernel, KIND_REGRESSION),
    GT_MINBS(window_stats_kernel, KIND_IRATE)};
#undef GT_MINBS

int attrs_of(const void* fn, int* out) {
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, fn)) return (int)e;
  int blocks = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, kThreads, 0)) {
    return (int)e;
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}

}  // namespace

extern "C" {

int probe_cw_count() { return (int)(sizeof(kCw) / sizeof(kCw[0])); }
int probe_gauge_count() { return (int)(sizeof(kGauge) / sizeof(kGauge[0])); }

// registers a thread, local (spill) bytes and resident blocks of 256 an
// SM: which 0 = a cw variant, 1 = a gauge variant, 2 = the port's
// counter_window_kernel<mode, kMinb[variant]>, 3 = its
// window_stats_kernel<kind, kMinb[variant]> (mode / kind: `sub`)
int probe_attrs(int which, int sub, int variant, int* out) {
  const void* fn = which == 0   ? (const void*)kCw[variant]
                   : which == 1 ? (const void*)kGauge[variant]
                   : which == 2 ? (const void*)kMode[sub][variant]
                                : (const void*)kStats[sub][variant];
  return attrs_of(fn, out);
}

int probe_cw(int variant, const long long* key_s, const long long* ts_s,
             const float* val_s, long long n, const long long* ts_min,
             const long long* kp, const int32_t* sel, long long S,
             long long T, long long start_ms, long long step_ms,
             long long range_ms, const int32_t* series_off, long long n_off,
             int is_rate, double range_s, float* rate, void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0 || n_off < 2) return (int)cudaErrorInvalidValue;
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             nullptr, nullptr, 0, series_off, n_off};
  kCw[variant]<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      g, ts_s, val_s, is_rate, range_s, rate);
  return last_error();
}

int probe_minb_count() { return (int)(sizeof(kMinb) / sizeof(kMinb[0])); }
int probe_minb(int variant) { return kMinb[variant]; }

// the port's counter_window_kernel (every mode) and window_stats_kernel
// (every kind) under kMinb[variant] on a grid of at most `cap` blocks an
// SM (0: one thread a window): the port's entry points' arguments
int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

// the grid: a block every kThreads windows, or at most `cap` blocks an SM
unsigned probe_grid(long long total, int cap) {
  const long long want = blocks_for(total);
  const long long most = cap > 0 ? (long long)num_sms() * cap : want;
  return (unsigned)(want < most ? want : most);
}

int probe_cw_mode(int variant, int cap, const long long* key_s, const long long* ts_s,
                  const float* val_s, long long n, const long long* ts_min,
                  const long long* kp, const int32_t* sel, long long S,
                  long long T, long long start_ms, long long step_ms,
                  long long range_ms, const int32_t* series_off,
                  long long n_off, int mode, int counter, int is_rate,
                  double range_s, float* count, long long* first_ts,
                  long long* last_ts, float* first_val, float* last_val,
                  float* delta_adj, float* delta_raw, float* last,
                  float* rate, void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0 || n_off < 2) return (int)cudaErrorInvalidValue;
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             nullptr, nullptr, 0, series_off, n_off};
  WindowOut o{count, first_ts, last_ts, first_val, last_val,
              delta_adj, delta_raw, last, rate};
  kMode[mode][variant]<<<probe_grid(total, cap), kThreads, 0,
                         (cudaStream_t)stream>>>(g, ts_s, val_s, counter,
                                                 is_rate, range_s, o);
  return last_error();
}

int probe_stats(int variant, int cap, const long long* key_s, const long long* ts_s,
                const float* val_s, long long n, const long long* ts_min,
                const long long* kp, const int32_t* sel, long long S,
                long long T, long long start_ms, long long step_ms,
                long long range_ms, const int32_t* series_off,
                long long n_off, int kind, float* count, float* sum,
                float* avg, float* var, float* last, float* first,
                long long* first_ts, long long* last_ts, float* resets,
                float* changes, float* slope, float* intercept,
                long long* prev_ts, float* last_val, float* prev_val,
                void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0 || n_off < 2) return (int)cudaErrorInvalidValue;
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             nullptr, nullptr, 0, series_off, n_off};
  StatsOut o{count, sum, avg, var, last, first, first_ts, last_ts, resets,
             changes, slope, intercept, prev_ts, last_val, prev_val};
  kStats[kind][variant]<<<probe_grid(total, cap), kThreads, 0,
                          (cudaStream_t)stream>>>(g, ts_s, val_s, o);
  return last_error();
}

int probe_gauge(int variant, const long long* key_s, const long long* ts_s,
                const float* val_s, long long n, const long long* ts_min,
                const long long* kp, const int32_t* sel, long long S,
                long long T, long long start_ms, long long step_ms,
                long long range_ms, const int32_t* series_off,
                long long n_off, float* count, float* sum, float* avg,
                float* var, float* last, float* first, long long* first_ts,
                long long* last_ts, void* stream) {
  const long long total = S * T;
  if (total <= 0 || n <= 0 || n_off < 2) return (int)cudaErrorInvalidValue;
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             nullptr, nullptr, 0, series_off, n_off};
  StatsOut o{count, sum, avg, var, last, first, first_ts, last_ts, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  kGauge[variant]<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      g, ts_s, val_s, o);
  return last_error();
}

}  // extern "C"
