// Staged variants of K14's register routes, for probes/window_matrix.py:
// the port's own csrc/promql_kernels.cu is compiled into this file, so the
// variants share its window geometry, sorting network and reducer, and
// differ from window_matrix_reg_kernel / window_matrix_dense_reg_kernel
// only in where a thread reads its window's keys from (both find their
// bounds in the range geometry, from the layout's series offset table).
//
// matrix_staged: each warp copies the span of sorted rows its 32 windows
//   cover (lowest first row to highest last row it reads) into shared
//   memory with coalesced loads, then every thread reads its window from
//   there; a warp whose span exceeds kSpan floats (windows of series far
//   apart in the sort layout) reads device memory as the register route
//   does.
// dense_staged: each block copies its 256 rows of the [W, K] matrix (256 K
//   contiguous floats) into shared memory with coalesced loads, then each
//   thread reads its row at stride K (2-way bank conflicts at K = 6).
//
// Built by probes/window_matrix.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o probes/build/libprobe_window_matrix.so
//        probes/window_matrix.cu

#include "../greptimedb_tpu_torch/csrc/promql_kernels.cu"

namespace {

constexpr int kSpan = 1024;  // floats of a warp's staged span

template <int P>
__global__ void __launch_bounds__(kThreads)
    matrix_staged_kernel(Geometry g, const float* val_s, int mode,
                         const float* a1, float* out) {
  __shared__ float span[kThreads / 32][kSpan];
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < g.S * g.T;
  Bounds b{0, 0, 0, false, false};
  if (live) b = window_bounds(g, w);
  const int take = b.cnt < P ? b.cnt : P;
  long long lo = b.has ? b.lo : kI64Max;
  long long hi = b.has ? b.lo + take : -1;
  for (int off = 16; off > 0; off >>= 1) {
    const long long o_lo = __shfl_xor_sync(kAllLanes, lo, off);
    const long long o_hi = __shfl_xor_sync(kAllLanes, hi, off);
    lo = o_lo < lo ? o_lo : lo;
    hi = o_hi > hi ? o_hi : hi;
  }
  const bool staged = hi >= lo && hi - lo <= kSpan;  // warp-uniform
  float* s = span[threadIdx.x >> 5];
  if (staged) {
    for (long long i = lo + (threadIdx.x & 31); i < hi; i += 32) {
      s[i - lo] = val_s[i];
    }
    __syncwarp();
  }
  if (!live) return;
  if (!b.has) {
    out[w] = NAN;
    return;
  }
  uint32_t k[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    k[j] = j < b.cnt ? f32_sort_key(staged ? s[b.lo - lo + j]
                                           : val_s[b.lo + j])
                     : kPadKey;
  }
  out[w] = reg_sorted_reducer<P>(k, b.cnt, mode, a1[w % g.T], P - 1);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    dense_staged_kernel(const float* win, long long W, int K, long long T,
                        int mode, const float* a1, float* out) {
  __shared__ float rows[kThreads * P];
  const long long w0 = (long long)blockIdx.x * kThreads;
  const long long nrow = W - w0 < kThreads ? W - w0 : kThreads;
  const float* src = win + w0 * K;
  for (long long i = threadIdx.x; i < nrow * K; i += kThreads) {
    rows[i] = src[i];
  }
  __syncthreads();
  const long long w = w0 + threadIdx.x;
  if (w >= W) return;
  const float* x = rows + threadIdx.x * K;
  uint32_t k[P];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float v = j < K ? x[j] : NAN;
    const bool absent = isnan(v);
    cnt += absent ? 0 : 1;
    k[j] = absent ? kPadKey : f32_sort_key(v);
  }
  const float res = reg_sorted_reducer<P>(k, cnt, mode, a1[w % T], K - 1);
  out[w] = cnt > 0 ? res : NAN;
}

template <int P>
struct MatrixStaged {
  static int run(Geometry g, const float* val_s, int mode, const float* a1,
                 float* out, cudaStream_t st) {
    matrix_staged_kernel<P><<<blocks_for(g.S * g.T), kThreads, 0, st>>>(
        g, val_s, mode, a1, out);
    return last_error();
  }
};

template <int P>
struct DenseStaged {
  static int run(const float* win, long long W, int K, long long T,
                 int mode, const float* a1, float* out, cudaStream_t st) {
    dense_staged_kernel<P><<<blocks_for(W), kThreads, 0, st>>>(
        win, W, K, T, mode, a1, out);
    return last_error();
  }
};

}  // namespace

extern "C" {

// gt_window_matrix's register route (quantile, mad), staged.
int probe_matrix_staged(const long long* key_s, const float* val_s,
                        long long n, const long long* ts_min,
                        const long long* kp, const int32_t* sel, long long S,
                        long long T, long long start_ms, long long step_ms,
                        long long range_ms, const int32_t* series_off,
                        long long n_off, int lmax, int mode,
                        const float* a1, float* out, void* stream) {
  if (S * T <= 0 || n <= 0) return (int)cudaGetLastError();
  Geometry g{key_s, n, ts_min, kp, sel, S, T, start_ms, step_ms, range_ms,
             nullptr, nullptr, 0, series_off, n_off};
  return with_reg_width<MatrixStaged>(lmax, g, val_s, mode, a1, out,
                                      (cudaStream_t)stream);
}

// gt_window_matrix_dense's register route, staged.
int probe_dense_staged(const float* win, long long W, long long K,
                       long long T, int L, int mode, const float* a1,
                       float* out, void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  if (K > L) return (int)cudaErrorInvalidValue;
  return with_reg_width<DenseStaged>(L, win, W, (int)K, T, mode, a1, out,
                                     (cudaStream_t)stream);
}

}  // extern "C"
