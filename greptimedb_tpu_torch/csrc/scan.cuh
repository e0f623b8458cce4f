// Shared scan and radix machinery of the hand-written CUDA libraries.
//
// Included by promql_kernels.cu (the f64 counter-drop scan and the radix
// passes of sort_layout) and segment_kernels.cu (the mask scan of compact,
// the rank scan of compact_groups and the radix passes of radix_argsort):
// one scan implementation, instantiated in each library.
//
// launch_scan: deterministic inclusive scan in a fixed tree order, three
// phases: (1) each block reduces a tile of 4096 elements (256 threads x 16,
// coalesced loads, a shared-memory tree); (2) one block of 1024 threads
// turns the tile sums into exclusive tile offsets (contiguous runs per
// thread, then a Hillis-Steele block scan); (3) each block stages its tile
// in shared memory, every thread scans its 16 contiguous elements, a block
// scan adds the thread prefixes and the tile offset.  Element sources are
// fused prologues (functors with `T operator()(long long i)`).
//
// radix_pass: one stable one-bit split of (key, row index) pairs: a "bit is
// zero" scan, then a scatter (dst = zero ? zeros_before : total_zeros +
// ones_before).  Keys are 64-bit patterns; the shift selects the bit.
//
// f32_key / f32_sort_key / warp_bitonic_sort: the order-preserving 32-bit
// keys of floats and the warp-wide bitonic sort that window_matrix (promql)
// and segment_select (segment) sort windows and groups with, and that the
// f32 min/max reductions of segment_reduce compare by.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;  // 4096
constexpr int kTopThreads = 1024;
constexpr int kThreads = 256;
constexpr long long kI64Max = 0x7fffffffffffffffLL;

// The launch just made was refused (or an earlier fault is pending): 0 or
// the cudaError_t, checked right after every launch.
inline int last_error() { return (int)cudaGetLastError(); }

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

struct BitZeroSrc {  // 1 where bit `shift` of key[i] is 0
  const long long* key;
  int shift;
  __device__ int operator()(long long i) const {
    return ((key[i] >> shift) & 1LL) == 0 ? 1 : 0;
  }
};

// Exclusive scan over the block's threads (Hillis-Steele, fixed order);
// `total` receives the block's sum.  `sm` holds blockDim.x elements.
template <typename T>
__device__ T block_exclusive_scan(T v, T* sm, T& total) {
  const int tid = threadIdx.x;
  sm[tid] = v;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const T add = tid >= off ? sm[tid - off] : T(0);
    __syncthreads();
    sm[tid] += add;
    __syncthreads();
  }
  const T excl = tid > 0 ? sm[tid - 1] : T(0);
  total = sm[blockDim.x - 1];
  __syncthreads();
  return excl;
}

template <typename T, typename Src>
__global__ void scan_reduce_kernel(Src src, long long n, T* tile_sums) {
  __shared__ T sm[kScanThreads];
  const long long base = (long long)blockIdx.x * kScanTile;
  T acc = T(0);
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = base + (long long)j * kScanThreads + threadIdx.x;
    if (i < n) acc += src(i);
  }
  sm[threadIdx.x] = acc;
  __syncthreads();
  for (int off = kScanThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sm[threadIdx.x] += sm[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = sm[0];
}

template <typename T>
__global__ void scan_top_kernel(T* tile_sums, long long ntiles) {
  __shared__ T sm[kTopThreads];
  const long long per = (ntiles + kTopThreads - 1) / kTopThreads;
  const long long k0 = (long long)threadIdx.x * per;
  const long long k1 = k0 + per < ntiles ? k0 + per : ntiles;
  T acc = T(0);
  for (long long k = k0; k < k1; ++k) acc += tile_sums[k];
  T total;
  T run = block_exclusive_scan(acc, sm, total);
  for (long long k = k0; k < k1; ++k) {
    const T v = tile_sums[k];
    tile_sums[k] = run;
    run += v;
  }
}

// Shared-memory slot of tile element k: one pad slot every 16 elements
// keeps a thread's 16 contiguous elements off its neighbours' banks.
__device__ __forceinline__ int sidx(int k) { return k + (k >> 4); }

template <typename T, typename Src>
__global__ void scan_apply_kernel(Src src, long long n, const T* tile_offsets,
                                  T* out) {
  __shared__ T tile[kScanTile + kScanTile / 16];
  __shared__ T sm[kScanThreads];
  const long long base = (long long)blockIdx.x * kScanTile;
  for (int j = 0; j < kScanItems; ++j) {
    const int k = j * kScanThreads + threadIdx.x;
    const long long i = base + k;
    tile[sidx(k)] = i < n ? src(i) : T(0);
  }
  __syncthreads();
  const int k0 = threadIdx.x * kScanItems;
  T acc = T(0);
  for (int j = 0; j < kScanItems; ++j) {
    acc += tile[sidx(k0 + j)];
    tile[sidx(k0 + j)] = acc;
  }
  T total;
  const T pre = tile_offsets[blockIdx.x] + block_exclusive_scan(acc, sm, total);
  for (int j = 0; j < kScanItems; ++j) {
    tile[sidx(k0 + j)] = pre + tile[sidx(k0 + j)];
  }
  __syncthreads();
  for (int j = 0; j < kScanItems; ++j) {
    const int k = j * kScanThreads + threadIdx.x;
    const long long i = base + k;
    if (i < n) out[i] = tile[sidx(k)];
  }
}

template <typename T, typename Src>
int launch_scan(Src src, long long n, T* tile_sums, T* out, cudaStream_t st) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long ntiles = (n + kScanTile - 1) / kScanTile;
  scan_reduce_kernel<T, Src><<<(unsigned)ntiles, kScanThreads, 0, st>>>(
      src, n, tile_sums);
  if (int e = last_error()) return e;
  scan_top_kernel<T><<<1, kTopThreads, 0, st>>>(tile_sums, ntiles);
  if (int e = last_error()) return e;
  scan_apply_kernel<T, Src><<<(unsigned)ntiles, kScanThreads, 0, st>>>(
      src, n, tile_sums, out);
  if (int e = last_error()) return e;
  return 0;
}


__global__ void radix_scatter_kernel(const long long* key_in,
                                     const int32_t* idx_in,
                                     const int32_t* zeros_incl, long long n,
                                     int shift, long long* key_out,
                                     int32_t* idx_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = key_in[i];
  const long long zero = ((k >> shift) & 1LL) == 0 ? 1 : 0;
  const long long zeros_before = (long long)zeros_incl[i] - zero;
  const long long dst =
      zero ? zeros_before : (long long)zeros_incl[n - 1] + (i - zeros_before);
  key_out[dst] = k;
  idx_out[dst] = idx_in[i];
}

// One stable one-bit radix pass over n (key, idx) pairs; `zeros` [n] and
// `tile_sums` [ceil(n / 4096)] are int32 scratch.
int radix_pass(const long long* key_in, const int32_t* idx_in, long long n,
               int shift, int32_t* zeros, int32_t* tile_sums,
               long long* key_out, int32_t* idx_out, cudaStream_t st) {
  if (n <= 0) return (int)cudaGetLastError();
  const int rc = launch_scan<int32_t, BitZeroSrc>(BitZeroSrc{key_in, shift}, n,
                                                  tile_sums, zeros, st);
  if (rc != 0) return rc;
  radix_scatter_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      key_in, idx_in, zeros, n, shift, key_out, idx_out);
  return last_error();
}

// Order-preserving 32-bit key of a float: negative values flip every bit,
// the rest set the sign bit, so -0.0 orders below +0.0 and -inf / +inf sit
// at the ends.  f32_of_key inverts it.
__device__ __forceinline__ uint32_t f32_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float f32_of_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The sort key: f32_key with every NaN made the canonical positive NaN, so
// NaN orders above +inf (last, as lax.sort puts it).  kPadKey orders above
// every sort key.
constexpr uint32_t kPadKey = 0xffffffffu;

__device__ __forceinline__ uint32_t f32_sort_key(float x) {
  return f32_key(isnan(x) ? __uint_as_float(0x7fc00000u) : x);
}

// Ascending bitonic sort of buf[0, L) (L a power of two; shared or global
// memory) by one warp; every stage ends with __syncwarp, so each lane sees
// the others' writes and the caller sees the sorted buffer.
__device__ void warp_bitonic_sort(uint32_t* buf, int L, int lane) {
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < L; i += 32) {
        const int p = i ^ j;
        if (p > i) {
          const uint32_t x = buf[i];
          const uint32_t y = buf[p];
          const bool up = (i & k) == 0;
          if (up ? x > y : x < y) {
            buf[i] = y;
            buf[p] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace
