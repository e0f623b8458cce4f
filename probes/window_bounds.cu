// Variants of the window kernels' range geometry, for
// probes/window_bounds.py: the port's own csrc/promql_kernels.cu is
// compiled into this file, so the variants share its search functions and
// differ from window_bounds' range geometry only in how a thread's
// searches reach the keys.  Each is one thread a window; mode 0 writes
// each window's [lo, hi) (the probe's check), mode 1 its count as int32
// (the timing: the bounds and one coalesced 4-byte store a window, where
// window_count_max's one atomicMax a warp on a single word would time the
// atomics).  bounds_port is window_bounds itself (the range geometry with
// the table, the whole-layout search without).
//
// bounds_staged: each warp copies the span of sorted keys its 32 windows'
//   series cover (the lowest off[t] to the highest off[t + 1]) into
//   shared memory with coalesced loads, then every thread runs its two
//   searches there.  A warp whose span exceeds kStage keys (series far
//   apart in the layout) searches device memory as window_bounds does.
// bounds_block: the same with one span a block of 256 windows, staged in
//   `cap` keys of dynamic shared memory (a block whose span is wider
//   searches device memory).
// bounds_i32: window_bounds' range geometry with 32-bit index arithmetic
//   (the window's series and step by a 32-bit division, the searches on
//   int32 indices relative to off[t]).
//
// Built by probes/window_bounds.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o probes/build/libprobe_window_bounds.so
//        probes/window_bounds.cu

#include "../greptimedb_tpu_torch/csrc/promql_kernels.cu"

namespace {

constexpr int kStage = 1536;     // keys of a warp's staged span (12 KB)
constexpr int kStageWarps = 4;   // warps a block: 48 KB of shared memory

__global__ void __launch_bounds__(kStageWarps * 32)
    bounds_staged_kernel(Geometry g, int mode, long long* lo_out,
                         long long* hi_out, int* cnt) {
  __shared__ long long keys[kStageWarps][kStage];
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < g.S * g.T;
  long long base = 0, len = 0, x_lo = 0, x_hi = 0;
  bool sel_ok = false;
  if (live) {  // window_bounds' keys and series range
    const long long s = w / g.T;
    const long long step = g.start_ms + g.step_ms * (w - s * g.T);
    const int sel_t = g.sel[s];
    sel_ok = sel_t >= 0;
    const long long ts_min = *g.ts_min_p, kp = *g.kp_p;
    const long long t = sel_ok ? (long long)sel_t : 0LL;
    const long long skey = t * kp;
    x_lo = skey + clampll(step - g.range_ms + 1 - ts_min, 0, kp - 1);
    x_hi = skey + clampll(step - ts_min, -1, kp - 1);
    const long long r = t < g.n_off - 2 ? t : g.n_off - 2;
    base = g.series_off[r];
    len = g.series_off[r + 1] - base;
  }
  long long a = live ? base : kI64Max, e = live ? base + len : -1;
  for (int off = 16; off > 0; off >>= 1) {
    const long long o_a = __shfl_xor_sync(kAllLanes, a, off);
    const long long o_e = __shfl_xor_sync(kAllLanes, e, off);
    a = o_a < a ? o_a : a;
    e = o_e > e ? o_e : e;
  }
  const long long* k = g.key_s + base;
  if (e >= a && e - a <= kStage) {  // warp-uniform
    long long* span = keys[threadIdx.x >> 5];
    for (long long i = a + lane; i < e; i += 32) span[i - a] = g.key_s[i];
    __syncwarp();
    k = span + (live ? base - a : 0);
  }
  const long long lo = base + search_left(k, len, x_lo);
  const long long hi = base + search_right(k, len, x_hi);
  if (!live) return;
  if (mode == 0) {
    lo_out[w] = lo;
    hi_out[w] = hi;
    return;
  }
  cnt[w] = sel_ok && hi > lo ? (int)(hi - lo) : 0;
}

// The window's search keys and its series' rows [base, base + len), as
// window_bounds computes them (the range geometry).
struct Probe {
  long long base, len, x_lo, x_hi;
  bool sel_ok;
};

__device__ __forceinline__ Probe probe_of(const Geometry& g, long long w) {
  const long long s = w / g.T;
  const long long step = g.start_ms + g.step_ms * (w - s * g.T);
  const int sel_t = g.sel[s];
  Probe p;
  p.sel_ok = sel_t >= 0;
  const long long ts_min = *g.ts_min_p, kp = *g.kp_p;
  const long long t = p.sel_ok ? (long long)sel_t : 0LL;
  p.x_lo = t * kp + clampll(step - g.range_ms + 1 - ts_min, 0, kp - 1);
  p.x_hi = t * kp + clampll(step - ts_min, -1, kp - 1);
  const long long r = t < g.n_off - 2 ? t : g.n_off - 2;
  p.base = g.series_off[r];
  p.len = g.series_off[r + 1] - p.base;
  return p;
}

__device__ __forceinline__ void probe_out(int mode, bool live, bool sel_ok,
                                          long long w, long long lo,
                                          long long hi, long long* lo_out,
                                          long long* hi_out, int* cnt) {
  if (!live) return;
  if (mode == 0) {
    lo_out[w] = lo;
    hi_out[w] = hi;
    return;
  }
  cnt[w] = sel_ok && hi > lo ? (int)(hi - lo) : 0;
}

__global__ void __launch_bounds__(kThreads)
    bounds_port_kernel(Geometry g, int mode, long long* lo_out,
                       long long* hi_out, int* cnt) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= g.S * g.T) return;
  const Bounds b = window_bounds(g, w);
  probe_out(mode, true, b.sel_ok, w, b.lo, b.hi, lo_out, hi_out, cnt);
}

__global__ void __launch_bounds__(kThreads)
    bounds_block_kernel(Geometry g, int mode, long long cap,
                        long long* lo_out, long long* hi_out, int* cnt) {
  extern __shared__ long long staged[];
  __shared__ long long span[2];
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < g.S * g.T;
  Probe p{0, 0, 0, 0, false};
  if (live) p = probe_of(g, w);
  if (threadIdx.x == 0) {
    span[0] = kI64Max;
    span[1] = -1;
  }
  __syncthreads();
  long long a = live ? p.base : kI64Max, e = live ? p.base + p.len : -1;
  for (int off = 16; off > 0; off >>= 1) {
    const long long o_a = __shfl_xor_sync(kAllLanes, a, off);
    const long long o_e = __shfl_xor_sync(kAllLanes, e, off);
    a = o_a < a ? o_a : a;
    e = o_e > e ? o_e : e;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&span[0], a);
    atomicMax(&span[1], e);
  }
  __syncthreads();
  const long long A = span[0], E = span[1];
  const long long* k = g.key_s + p.base;
  if (E >= A && E - A <= cap) {  // block-uniform
    for (long long i = A + threadIdx.x; i < E; i += blockDim.x) {
      staged[i - A] = g.key_s[i];
    }
    __syncthreads();
    k = staged + (live ? p.base - A : 0);
  }
  const long long lo = p.base + search_left(k, p.len, p.x_lo);
  const long long hi = p.base + search_right(k, p.len, p.x_hi);
  probe_out(mode, live, p.sel_ok, w, lo, hi, lo_out, hi_out, cnt);
}

__device__ __forceinline__ int search_left32(const long long* a, int n,
                                             long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int search_right32(const long long* a, int n,
                                              long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// 32-bit window indices (S * T < 2^31, checked by the entry point)
__global__ void __launch_bounds__(kThreads)
    bounds_i32_kernel(Geometry g, int mode, long long* lo_out,
                      long long* hi_out, int* cnt) {
  const unsigned w = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < (unsigned)(g.S * g.T);
  long long lo = 0, hi = 0;
  bool sel_ok = false;
  if (live) {
    const unsigned T = (unsigned)g.T;
    const unsigned s = w / T;
    const long long step = g.start_ms + g.step_ms * (long long)(w - s * T);
    const int sel_t = __ldg(g.sel + s);
    sel_ok = sel_t >= 0;
    const long long ts_min = __ldg(g.ts_min_p), kp = __ldg(g.kp_p);
    const int t = sel_ok ? sel_t : 0;
    const int r = t < (int)g.n_off - 2 ? t : (int)g.n_off - 2;
    const int base = __ldg(g.series_off + r);
    const int len = __ldg(g.series_off + r + 1) - base;
    const long long skey = (long long)t * kp;
    const long long* k = g.key_s + base;
    lo = base + search_left32(
        k, len, skey + clampll(step - g.range_ms + 1 - ts_min, 0, kp - 1));
    hi = base + search_right32(k, len, skey + clampll(step - ts_min, -1,
                                                      kp - 1));
  }
  probe_out(mode, live, sel_ok, w, lo, hi, lo_out, hi_out, cnt);
}

}  // namespace

extern "C" {

// The warp-staged variant: each window's count (mode 1: cnt [S * T]
// int32) or bounds (mode 0: lo, hi [S * T] int64).
int probe_bounds_staged(const long long* key_s, long long n,
                        const long long* ts_min, const long long* kp,
                        const int32_t* sel, long long S, long long T,
                        long long start_ms, long long step_ms,
                        long long range_ms, const int32_t* series_off,
                        long long n_off, int mode, long long* lo,
                        long long* hi, int* cnt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = S * T;
  if (total <= 0 || n <= 0 || n_off < 2) return (int)cudaGetLastError();
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             nullptr, nullptr, 0, series_off, n_off};
  const int threads = kStageWarps * 32;
  bounds_staged_kernel<<<(unsigned)((total + threads - 1) / threads),
                         threads, 0, st>>>(g, mode, lo, hi, cnt);
  return last_error();
}

// variant 0: bounds_port (series_off null: the whole-layout search);
// 1: bounds_block with `cap` staged keys a block; 2: bounds_i32.
int probe_bounds_variant(int variant, const long long* key_s, long long n,
                         const long long* ts_min, const long long* kp,
                         const int32_t* sel, long long S, long long T,
                         long long start_ms, long long step_ms,
                         long long range_ms, const int32_t* series_off,
                         long long n_off, int mode, long long cap,
                         long long* lo, long long* hi, int* cnt,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = S * T;
  if (total <= 0 || n <= 0) return (int)cudaGetLastError();
  if (total >= (1LL << 31) || (variant != 0 && n_off < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             nullptr, nullptr, 0, series_off, n_off};
  if (variant == 0) {
    bounds_port_kernel<<<blocks_for(total), kThreads, 0, st>>>(
        g, mode, lo, hi, cnt);
  } else if (variant == 1) {
    const size_t bytes = (size_t)cap * sizeof(long long);
    if (int e = opt_in_smem(bounds_block_kernel, bytes)) return e;
    bounds_block_kernel<<<blocks_for(total), kThreads, bytes, st>>>(
        g, mode, cap, lo, hi, cnt);
  } else {
    bounds_i32_kernel<<<blocks_for(total), kThreads, 0, st>>>(
        g, mode, lo, hi, cnt);
  }
  return last_error();
}

}  // extern "C"
