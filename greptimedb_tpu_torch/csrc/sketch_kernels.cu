// Hand-written Hopper kernels of the sketch aggregates (HyperLogLog and
// UDDSketch).
//
// Built by greptimedb_tpu_torch/ops/sketch_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libgreptime_sketch.so
//        sketch_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Every
// entry point launches on the caller's stream, allocates nothing (the
// wrapper passes zeroed or filled outputs) and returns the first nonzero
// cudaGetLastError() of its launches.
//
// A row i is live when mask[i] and 0 <= gid[i] < ng; rows that are not
// live touch nothing (the reference routes them to a dead cell it slices
// off).
//
// hll_fold
//   Replaces K18: greptimedb_tpu/ops/sketch.py:49 `hll_fold` and, in merge
//   mode, :80 `hll_merge_fold`.
//   Fold mode: one thread a row.  The value (f32 or f64, widened to f64 as
//   the reference does) is split into its integer part's two 32-bit words
//   and 30 fraction bits; three murmur3 finalizers in uint32 (logical
//   shifts, multiplies that wrap at 32 bits) give h1 and h2; the register
//   is the top 12 bits of h1 and the rank the count of leading zeros of
//   w = h2 >> 1 as a 32-bit word (the docstring's exact leading-zero rank:
//   31 - floor(log2 w) for w > 0, 32 for w = 0), merged by atomicMax into
//   the [ng, 4096] int32 registers.  Max is order-free, so the result is
//   exact whatever order the atomics land in.
//   Merge mode: one block a row; its threads max-merge the row's vocabulary
//   register vector (chosen by the row's dictionary code) into its group's
//   registers, so the reference's [n, 4096] gather never exists.
//   Bound: bytes: the values, ids and mask of every row and the registers
//   written once (fold); the codes, ids and mask, the vocabulary rows the
//   live rows name, once each, and the registers (merge).
//
// udd_fold
//   Replaces K19: ops/sketch.py:136-200 `udd_keys`, `udd_key_extremes`,
//   `udd_bucket_counts` and `udd_fold` and, in merge mode, :203
//   `udd_merge_fold`.
//   Fold mode, two launches.  Pass 1, a thread a row: the base-gamma key
//   k = ceil(log(v) / log(gamma)) in f64 of each live row with a positive
//   finite value, and int64 atomicMin / atomicMax of k into the group's
//   (k_min, k_max); a warp whose live rows share one group (the resident
//   table keeps a series' rows together) folds its keys by shuffles and
//   sends one atomic pair.  Pass 2, a thread a row: the group's collapse
//   factor c,
//   the least power of two >= need = ceil((span + 2) / nb) with span =
//   max(k_max - k_min + 1, 1), computed in integers (the reference's CPU
//   exp2 is inexact: c = 7 where it means 8), its grid base
//   floor(k_min / c) * c, the row's bucket clamp(ceil((k - base) / c), 0,
//   nb - 1) and an int64 atomicAdd into it, one per warp and bucket
//   (__match_any_sync groups a warp's lanes by bucket); the first ng threads also
//   write the group's k_min and c into columns nb and nb + 1.  Counts add
//   exactly in any order.
//   The two passes also run alone (`passes`): the mesh's local phase
//   (greptimedb_tpu/parallel/dist.py:404-424) runs pass 1 on each shard,
//   merges the shards' extremes into the global ones, then runs pass 2 on
//   each shard against those, so every shard buckets with one collapse.
//   Merge mode: one block a row adds its vocabulary count row into its
//   group (int64 atomicAdd) and thread 0 folds the row's config id into the
//   group's (min, max) columns.
//   Bound: bytes (values, ids, mask read once; [ng, nb + 2] int64 written
//   once); the f64 log is ~20 operations a row, far under the f64 peak.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHllP = 12;
constexpr int kHllM = 1 << kHllP;  // 4096 registers
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

template <typename T>
__global__ void hll_fold_kernel(const T* __restrict__ vals,
                                const int32_t* __restrict__ gid,
                                const bool* __restrict__ mask, long long n,
                                long long ng, int32_t* __restrict__ regs) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!mask[i]) return;
  const int32_t g = gid[i];
  if (g < 0 || g >= ng) return;
  const double v = (double)vals[i];
  if (!isfinite(v)) return;
  const double vi = floor(v);
  const long long k = (long long)fmin(fmax(vi, -9.2e18), 9.2e18);
  const uint32_t lo = (uint32_t)((unsigned long long)k & 0xFFFFFFFFull);
  const uint32_t hi = (uint32_t)((unsigned long long)k >> 32);
  const uint32_t frac = (uint32_t)(int32_t)((v - vi) * 1073741824.0);
  const uint32_t h1 = mix32(lo ^ mix32(hi ^ mix32(frac)));
  const uint32_t h2 = mix32((frac + 0x9E3779B9u) ^ h1);
  const uint32_t idx = h1 >> (32 - kHllP);
  const int rho = __clz((int)(h2 >> 1));  // 32 for w == 0
  atomicMax(&regs[(long long)g * kHllM + idx], rho);
}

__global__ void hll_merge_kernel(const int32_t* __restrict__ codes,
                                 const int32_t* __restrict__ vocab,
                                 long long nv,
                                 const int32_t* __restrict__ gid,
                                 const bool* __restrict__ mask, long long n,
                                 long long ng, int32_t* __restrict__ regs) {
  const long long i = blockIdx.x;
  if (i >= n || !mask[i]) return;
  const int32_t c = codes[i];
  const int32_t g = gid[i];
  if (c < 0 || c >= nv || g < 0 || g >= ng) return;
  const int32_t* src = vocab + (long long)c * kHllM;
  int32_t* dst = regs + (long long)g * kHllM;
  for (int r = threadIdx.x; r < kHllM; r += blockDim.x) {
    const int32_t v = src[r];
    if (v > 0) atomicMax(&dst[r], v);
  }
}

// gt_udd_fold's passes: the key extremes, the bucket counts, or both.  The
// mesh runs them apart, with the shards' extremes merged in between.
constexpr int kUddExtremes = 1;
constexpr int kUddCounts = 2;

template <typename T>
__device__ __forceinline__ bool udd_key(const T* vals, long long i,
                                        double log_gamma, long long* k) {
  const double v = (double)vals[i];
  if (!(v > 0.0) || !isfinite(v)) return false;
  *k = (long long)ceil(log(fmax(v, 1e-300)) / log_gamma);
  return true;
}

// A row's key, or false when the row is not live or its value is not a
// positive finite number.  Every lane of a warp returns here (no early
// exit), so the warp-level folds below see all 32 lanes.
template <typename T>
__device__ __forceinline__ bool live_key(const T* vals, const int32_t* gid,
                                         const bool* mask, long long n,
                                         long long ng, long long i,
                                         double log_gamma, int32_t* g,
                                         long long* k) {
  *g = -1;
  if (i >= n || !mask[i]) return false;
  *g = gid[i];
  if (*g < 0 || *g >= ng) return false;
  return udd_key(vals, i, log_gamma, k);
}

template <typename T>
__global__ void udd_extremes_kernel(const T* __restrict__ vals,
                                    const int32_t* __restrict__ gid,
                                    const bool* __restrict__ mask,
                                    long long n, long long ng,
                                    double log_gamma,
                                    long long* __restrict__ kmin,
                                    long long* __restrict__ kmax) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  int32_t g;
  long long k = 0;
  const bool valid = live_key(vals, gid, mask, n, ng, i, log_gamma, &g, &k);
  // the resident table keeps a series' rows together, so most warps hold
  // one group: fold their keys by shuffles and send one atomic pair
  const unsigned full = 0xffffffffu;
  const unsigned live = __ballot_sync(full, valid);
  if (live == 0) return;
  const int lead = __ffs(live) - 1;
  const int32_t g0 = __shfl_sync(full, g, lead);
  if (__all_sync(full, !valid || g == g0)) {
    long long mn = valid ? k : LLONG_MAX;
    long long mx = valid ? k : LLONG_MIN;
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(full, mn, o));
      mx = max(mx, __shfl_xor_sync(full, mx, o));
    }
    if ((int)(threadIdx.x & 31) == lead) {
      atomicMin(&kmin[g0], mn);
      atomicMax(&kmax[g0], mx);
    }
    return;
  }
  if (valid) {
    atomicMin(&kmin[g], k);
    atomicMax(&kmax[g], k);
  }
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ long long collapse(long long kmin, long long kmax,
                                              long long nb) {
  long long span = kmax - kmin + 1;
  if (span < 1) span = 1;
  const long long need = (span + 2 + nb - 1) / nb;
  long long c = 1;
  while (c < need) c <<= 1;
  return c;
}

template <typename T>
__global__ void udd_count_kernel(const T* __restrict__ vals,
                                 const int32_t* __restrict__ gid,
                                 const bool* __restrict__ mask, long long n,
                                 long long ng, double log_gamma, long long nb,
                                 const long long* __restrict__ kmin,
                                 const long long* __restrict__ kmax,
                                 long long* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long width = nb + 2;
  if (i < ng) {
    out[i * width + nb] = kmin[i];
    out[i * width + nb + 1] = collapse(kmin[i], kmax[i], nb);
  }
  int32_t g;
  long long k = 0;
  const bool valid = live_key(vals, gid, mask, n, ng, i, log_gamma, &g, &k);
  unsigned long long cell = ~0ull;
  if (valid) {
    const long long c = collapse(kmin[g], kmax[g], nb);
    const long long base = floor_div(kmin[g], c) * c;
    long long idx = floor_div(k - base + c - 1, c);
    idx = idx < 0 ? 0 : (idx > nb - 1 ? nb - 1 : idx);
    cell = (unsigned long long)(g * width + idx);
  }
  // lanes that count into one bucket send one atomic with their number
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  if (valid && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(reinterpret_cast<unsigned long long*>(&out[cell]),
              (unsigned long long)__popc(peers));
}

__global__ void udd_merge_kernel(const int32_t* __restrict__ codes,
                                 const long long* __restrict__ vocab,
                                 long long nv, long long width,
                                 const int32_t* __restrict__ cfg,
                                 const int32_t* __restrict__ gid,
                                 const bool* __restrict__ mask, long long n,
                                 long long ng, long long* __restrict__ out) {
  const long long i = blockIdx.x;
  if (i >= n || !mask[i]) return;
  const int32_t c = codes[i];
  const int32_t g = gid[i];
  if (c < 0 || c >= nv || g < 0 || g >= ng) return;
  const long long cf = cfg[c];
  if (cf < 0) return;
  const long long* src = vocab + (long long)c * width;
  long long* dst = out + (long long)g * (width + 2);
  for (long long r = threadIdx.x; r < width; r += blockDim.x) {
    const long long v = src[r];
    if (v != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(&dst[r]),
                (unsigned long long)v);
  }
  if (threadIdx.x == 0) {
    atomicMin(&dst[width], cf);
    atomicMax(&dst[width + 1], cf);
  }
}

unsigned blocks(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" {

// vals [n] (f32 when is_f64 == 0, else f64), gid [n] int32, mask [n] bool;
// regs [ng, 4096] int32, zeroed by the caller.
int gt_hll_fold(const void* vals, int is_f64, const int32_t* gid,
                const bool* mask, long long n, long long ng, int32_t* regs,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (is_f64)
      hll_fold_kernel<double><<<blocks(n), kThreads, 0, s>>>(
          static_cast<const double*>(vals), gid, mask, n, ng, regs);
    else
      hll_fold_kernel<float><<<blocks(n), kThreads, 0, s>>>(
          static_cast<const float*>(vals), gid, mask, n, ng, regs);
  }
  return (int)cudaGetLastError();
}

// codes [n] int32, vocab [nv, 4096] int32; regs [ng, 4096] zeroed.
int gt_hll_merge(const int32_t* codes, const int32_t* vocab, long long nv,
                 const int32_t* gid, const bool* mask, long long n,
                 long long ng, int32_t* regs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    hll_merge_kernel<<<(unsigned)n, kThreads, 0, s>>>(codes, vocab, nv, gid,
                                                      mask, n, ng, regs);
  return (int)cudaGetLastError();
}

// kmin [ng] filled with 2^30, kmax [ng] with -2^30; out [ng, nb + 2]
// int64 zeroed.
int gt_udd_fold(const void* vals, int is_f64, const int32_t* gid,
                const bool* mask, long long n, long long ng,
                double log_gamma, long long nb, int passes, long long* kmin,
                long long* kmax, long long* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((passes & kUddExtremes) && n > 0) {
    if (is_f64)
      udd_extremes_kernel<double><<<blocks(n), kThreads, 0, s>>>(
          static_cast<const double*>(vals), gid, mask, n, ng, log_gamma,
          kmin, kmax);
    else
      udd_extremes_kernel<float><<<blocks(n), kThreads, 0, s>>>(
          static_cast<const float*>(vals), gid, mask, n, ng, log_gamma,
          kmin, kmax);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long m = n > ng ? n : ng;
  if ((passes & kUddCounts) && m > 0) {
    if (is_f64)
      udd_count_kernel<double><<<blocks(m), kThreads, 0, s>>>(
          static_cast<const double*>(vals), gid, mask, n, ng, log_gamma, nb,
          kmin, kmax, out);
    else
      udd_count_kernel<float><<<blocks(m), kThreads, 0, s>>>(
          static_cast<const float*>(vals), gid, mask, n, ng, log_gamma, nb,
          kmin, kmax, out);
  }
  return (int)cudaGetLastError();
}

// codes [n] int32, vocab [nv, width] int64, cfg [nv] int32; out
// [ng, width + 2] int64: counts zeroed, column width filled with 2^30,
// column width + 1 with -1.
int gt_udd_merge(const int32_t* codes, const long long* vocab, long long nv,
                 long long width, const int32_t* cfg, const int32_t* gid,
                 const bool* mask, long long n, long long ng, long long* out,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    udd_merge_kernel<<<(unsigned)n, 128, 0, s>>>(codes, vocab, nv, width, cfg,
                                                 gid, mask, n, ng, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
