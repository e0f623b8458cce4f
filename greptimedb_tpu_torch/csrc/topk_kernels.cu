// Hand-written Hopper kernels of the raw scan's ORDER BY ... LIMIT k.
//
// Built by greptimedb_tpu_torch/ops/topk_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libgreptime_topk.so
//        topk_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Each
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launches.
//
// topk_select
//   Replaces the top-k branch of the reference's raw scan:
//   greptimedb_tpu/query/physical.py:1961-1984 (eligibility `_topk_spec`,
//   :1871), `jnp.lexsort(keys)[:k]` over the keys
//     (~mask, rank_1, +-v_1, rank_2, +-v_2, ...)   (most significant first)
//   where a float key's rank is 0 / 2 for NaN (NULLS FIRST / LAST) and 1
//   otherwise, NaN reads as 0, and DESC negates the value in the column's
//   own dtype with its wrap (INT64_MIN stays INT64_MIN; for unsigned
//   columns -0 == 0 sorts first and -1 becomes the largest value).  The
//   sort is stable, so rows equal on every key keep row order.
//
//   Design: the keys form one composite MSD key per row, cut into levels
//   of at most 8 bits: level 0 the invalid flag, then per ORDER BY key its
//   rank (floats only) and its value's order key from the top byte down.
//   Float order keys take -0.0 as +0.0 first, so the two compare equal as
//   in lexsort (scan.cuh's f32_key would order -0.0 below +0.0 and reorder
//   tied rows).  A radix SELECT walks the levels: per level one histogram
//   pass over the rows still equal to the chosen prefix (shared-memory
//   bins, warp-aggregated atomics), then one thread picks the digit that
//   holds the k-th row, and rows whose digit differs are marked below or
//   above the prefix for good (one byte a row).  A device flag stops the
//   remaining levels as soon as the rows equal to the prefix all fit, so
//   the host launches every level without waiting on any.  Then one
//   tile scan (scan.cuh) over (below, equal) counts collects, in row
//   order, every row below the prefix and the first k_rem rows equal to
//   it: exactly k row indices, whatever the ties.  `topk_words` then
//   writes the survivors' keys as int64 words whose signed order is the
//   key order, which the wrapper sorts with the stable radix_argsort of
//   segment_kernels.cu (least significant word first, the invalid flag
//   last): the k rows come out in lexsort order.
//
//   Bound: bytes.  The keys and the mask are read once and k indices
//   written; the kernel reads the mask and the first key once more
//   (levels 0 and 1) and one byte a row per later level, and a level is
//   skipped once the prefix is decided.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

enum KeyType : int {
  kF32 = 0,
  kF64 = 1,
  kI64 = 2,
  kI32 = 3,
  kI16 = 4,
  kI8 = 5,
  kU8 = 6,
  kU16 = 7,
  kU32 = 8,
};

// row classes after a level: still equal to the prefix, below it, above it
constexpr uint8_t kAlive = 0;
constexpr uint8_t kBelow = 1;
constexpr uint8_t kAbove = 2;

// state words
constexpr int kRem = 0;     // rows still to take from those equal to prefix
constexpr int kDone = 1;    // 1 once the rows equal to the prefix all fit
constexpr int kLast = 2;    // the last level picked
constexpr int kCount = 3;   // rows with the mask set
constexpr int kPicked = 4;  // [levels]: the digit picked at each level

constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

// Key and level descriptors, one int64 array (ops/topk_kernels.py
// `_descriptors`): [nkeys] column pointers, [nkeys] KeyType, [nkeys] flags
// (bit 0 DESC, bit 1 NULLS FIRST), then per level its key (-1: the invalid
// flag), its part (0 the rank, 1 the value) and its shift.
struct Desc {
  const long long* d;
  int nkeys;
  int levels;
  __device__ const void* ptr(int j) const { return (const void*)d[j]; }
  __device__ int type(int j) const { return (int)d[nkeys + j]; }
  __device__ int flags(int j) const { return (int)d[2 * nkeys + j]; }
  __device__ int lkey(int l) const { return (int)d[3 * nkeys + l]; }
  __device__ int lpart(int l) const { return (int)d[3 * nkeys + levels + l]; }
  __device__ int lshift(int l) const {
    return (int)d[3 * nkeys + 2 * levels + l];
  }
};

__device__ __forceinline__ bool is_wide(int t) {
  return t == kF64 || t == kI64;
}

// Key j of row i as (rank, order key of the value): the rank is 0 / 2 for
// a NaN float (NULLS FIRST / LAST) and 1 otherwise; the order key is an
// unsigned integer (64 bits for f64 / int64, else at most 32) whose order
// is the order of the possibly negated value.
__device__ __forceinline__ void key_parts(const Desc& ds, int j, long long i,
                                          unsigned& rank,
                                          unsigned long long& ord) {
  const int t = ds.type(j);
  const int fl = ds.flags(j);
  const bool desc = (fl & 1) != 0;
  const bool nf = (fl & 2) != 0;
  const void* p = ds.ptr(j);
  rank = 1;
  switch (t) {
    case kF32: {
      float v = static_cast<const float*>(p)[i];
      if (isnan(v)) {
        rank = nf ? 0 : 2;
        v = 0.0f;
      }
      if (desc) v = -v;
      const uint32_t b = v == 0.0f ? 0u : __float_as_uint(v);  // -0 == +0
      ord = (b & 0x80000000u) ? (uint32_t)~b : (b | 0x80000000u);
      return;
    }
    case kF64: {
      double v = static_cast<const double*>(p)[i];
      if (isnan(v)) {
        rank = nf ? 0 : 2;
        v = 0.0;
      }
      if (desc) v = -v;
      const unsigned long long b =
          v == 0.0 ? 0ull : (unsigned long long)__double_as_longlong(v);
      ord = (b >> 63) ? ~b : (b | 0x8000000000000000ull);
      return;
    }
    case kI64: {
      unsigned long long x =
          (unsigned long long)static_cast<const long long*>(p)[i];
      if (desc) x = 0ull - x;
      ord = x ^ 0x8000000000000000ull;
      return;
    }
    case kI32: {
      uint32_t x = (uint32_t)static_cast<const int32_t*>(p)[i];
      if (desc) x = 0u - x;
      ord = x ^ 0x80000000u;
      return;
    }
    case kI16: {
      uint16_t x = (uint16_t)static_cast<const int16_t*>(p)[i];
      if (desc) x = (uint16_t)(0u - x);
      ord = (uint16_t)(x ^ 0x8000u);
      return;
    }
    case kI8: {
      uint8_t x = (uint8_t)static_cast<const int8_t*>(p)[i];
      if (desc) x = (uint8_t)(0u - x);
      ord = (uint8_t)(x ^ 0x80u);
      return;
    }
    case kU8: {
      uint8_t x = static_cast<const uint8_t*>(p)[i];
      if (desc) x = (uint8_t)(0u - x);
      ord = x;
      return;
    }
    case kU16: {
      uint16_t x = static_cast<const uint16_t*>(p)[i];
      if (desc) x = (uint16_t)(0u - x);
      ord = x;
      return;
    }
    default: {  // kU32
      uint32_t x = static_cast<const uint32_t*>(p)[i];
      if (desc) x = 0u - x;
      ord = x;
      return;
    }
  }
}

// The digit of row i at level l.
__device__ __forceinline__ unsigned level_digit(const Desc& ds,
                                                const uint8_t* mask, int l,
                                                long long i) {
  if (l == 0) return mask[i] != 0 ? 0u : 1u;
  unsigned rank;
  unsigned long long ord;
  key_parts(ds, ds.lkey(l), i, rank, ord);
  if (ds.lpart(l) == 0) return rank;
  return (unsigned)((ord >> ds.lshift(l)) & 0xffull);
}

__global__ void topk_init_kernel(long long* st, long long k) {
  st[kRem] = k;
  st[kDone] = 0;
  st[kLast] = -1;
  st[kCount] = 0;
}

// Level l: rows still equal to the prefix (cand; every row at level 0)
// first compare their level l-1 digit with the one picked there and leave
// for good when it differs; the rest count their level l digit.
__global__ void __launch_bounds__(kThreads)
    topk_hist_kernel(Desc ds, const uint8_t* __restrict__ mask, long long n,
                     int l, uint8_t* __restrict__ cand,
                     const long long* __restrict__ st,
                     unsigned* __restrict__ hist) {
  __shared__ unsigned bins[kBins];
  if (st[kDone] != 0) return;  // block-uniform
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const unsigned prev = l > 0 ? (unsigned)st[kPicked + l - 1] : 0u;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is warp-uniform, so every lane reaches the warp votes
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    int dg = -1;
    if (i < n) {
      bool alive = true;
      if (l >= 1) {
        const uint8_t c = l == 1 ? kAlive : cand[i];
        if (c != kAlive) {
          alive = false;
        } else {
          const unsigned dp = level_digit(ds, mask, l - 1, i);
          if (dp != prev) {
            cand[i] = dp < prev ? kBelow : kAbove;
            alive = false;
          } else if (l == 1) {
            cand[i] = kAlive;
          }
        }
      }
      if (alive) dg = (int)level_digit(ds, mask, l, i);
    }
    const unsigned act = __ballot_sync(kFull, dg >= 0);
    if (dg >= 0) {
      const unsigned peers = __match_any_sync(act, dg);
      if (lane == __ffs(peers) - 1) atomicAdd(&bins[dg], __popc(peers));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    if (bins[b] != 0) atomicAdd(&hist[(long long)l * kBins + b], bins[b]);
  }
}

// One thread: the digit of level l that holds the k_rem-th row still equal
// to the prefix; the rows below it are taken.  Done once the rows equal to
// the new prefix all fit.
__global__ void topk_pick_kernel(const unsigned* __restrict__ hist, int l,
                                 long long* __restrict__ st) {
  if (st[kDone] != 0) return;
  const unsigned* h = hist + (long long)l * kBins;
  const long long want = st[kRem];
  long long cum = 0;
  int d = kBins - 1;
  for (int b = 0; b < kBins; ++b) {
    if (cum + (long long)h[b] >= want) {
      d = b;
      break;
    }
    cum += h[b];
  }
  st[kPicked + l] = d;
  st[kRem] = want - cum;
  st[kLast] = l;
  if ((long long)h[d] == want - cum) st[kDone] = 1;
  if (l == 0) st[kCount] = h[0];
}

// A row's class against the final prefix, as scan input: 1 below the
// prefix, 1 << 32 equal to it, 0 above.
struct ClassSrc {
  Desc ds;
  const uint8_t* mask;
  const uint8_t* cand;
  const long long* st;
  __device__ long long operator()(long long i) const {
    const int last = (int)st[kLast];
    uint8_t c = last >= 1 ? cand[i] : kAlive;
    if (c == kAlive) {
      const unsigned d = level_digit(ds, mask, last, i);
      const unsigned p = (unsigned)st[kPicked + last];
      c = d < p ? kBelow : (d == p ? kAlive : kAbove);
    }
    return c == kBelow ? 1LL : (c == kAlive ? (1LL << 32) : 0LL);
  }
};

// scan_apply_kernel's tile scan with a scatter for an epilogue: a row below
// the prefix goes to (rows below before it) + min(equal rows before it,
// k_rem); an equal row with fewer than k_rem equal rows before it to
// (rows below before it) + (equal rows before it).  Row order throughout.
__global__ void __launch_bounds__(kScanThreads)
    topk_collect_kernel(ClassSrc src, long long n,
                        const long long* __restrict__ tile_offsets,
                        int32_t* __restrict__ sel) {
  __shared__ long long tile[kScanTile + kScanTile / 16];
  __shared__ long long sm[kScanThreads];
  const long long base = (long long)blockIdx.x * kScanTile;
  for (int j = 0; j < kScanItems; ++j) {
    const int k = j * kScanThreads + threadIdx.x;
    const long long i = base + k;
    tile[sidx(k)] = i < n ? src(i) : 0LL;
  }
  __syncthreads();
  const int k0 = threadIdx.x * kScanItems;
  long long own[kScanItems];
  long long acc = 0;
  for (int j = 0; j < kScanItems; ++j) {
    own[j] = tile[sidx(k0 + j)];
    acc += own[j];
  }
  long long total;
  long long run = tile_offsets[blockIdx.x] + block_exclusive_scan(acc, sm,
                                                                  total);
  const long long rem = src.st[kRem];
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = base + k0 + j;
    const long long below = run & 0xffffffffLL;
    const long long equal = run >> 32;
    if (i < n) {
      if (own[j] == 1) {
        sel[below + (equal < rem ? equal : rem)] = (int32_t)i;
      } else if (own[j] != 0 && equal < rem) {
        sel[below + equal] = (int32_t)i;
      }
    }
    run += own[j];
  }
}

// One thread a survivor: its valid flag and its key words, per key the
// rank (floats) then the value, as int64 whose signed order is the key
// order.
__global__ void topk_words_kernel(Desc ds, const uint8_t* __restrict__ mask,
                                  const int32_t* __restrict__ sel,
                                  long long k, long long* __restrict__ words,
                                  uint8_t* __restrict__ valid) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= k) return;
  const long long i = sel[s];
  valid[s] = mask[i];
  long long w = 0;
  for (int j = 0; j < ds.nkeys; ++j) {
    unsigned rank;
    unsigned long long ord;
    key_parts(ds, j, i, rank, ord);
    const int t = ds.type(j);
    if (t == kF32 || t == kF64) words[(w++) * k + s] = rank;
    words[(w++) * k + s] =
        is_wide(t) ? (long long)(ord ^ 0x8000000000000000ull)
                   : (long long)ord;
  }
}

}  // namespace

extern "C" {

// desc: the descriptors above (device); mask: [n] bool; cand: [n] uint8
// scratch; hist: [levels, 256] uint32 scratch; st: [4 + levels] int64
// (st[3] receives the number of rows with the mask set); tile_sums:
// [ceil(n / 4096)] int64 scratch; sel: [k] int32, the selected row indices
// in row order.  1 <= k <= n.
int gt_topk_select(const long long* desc, int nkeys, int levels,
                   const uint8_t* mask, long long n, long long k,
                   uint8_t* cand, unsigned* hist, long long* st,
                   long long* tile_sums, int32_t* sel, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || k <= 0 || k > n) return (int)cudaErrorInvalidValue;
  const Desc ds{desc, nkeys, levels};
  if (int e = (int)cudaMemsetAsync(hist, 0,
                                   sizeof(unsigned) * kBins * levels, s)) {
    return e;
  }
  topk_init_kernel<<<1, 1, 0, s>>>(st, k);
  if (int e = last_error()) return e;
  const long long want = blocks_for(n);
  const unsigned grid = (unsigned)(want < 2048 ? want : 2048);
  for (int l = 0; l < levels; ++l) {
    topk_hist_kernel<<<grid, kThreads, 0, s>>>(ds, mask, n, l, cand, st,
                                               hist);
    if (int e = last_error()) return e;
    topk_pick_kernel<<<1, 1, 0, s>>>(hist, l, st);
    if (int e = last_error()) return e;
  }
  const ClassSrc src{ds, mask, cand, st};
  const long long ntiles = (n + kScanTile - 1) / kScanTile;
  scan_reduce_kernel<long long, ClassSrc>
      <<<(unsigned)ntiles, kScanThreads, 0, s>>>(src, n, tile_sums);
  if (int e = last_error()) return e;
  scan_top_kernel<long long><<<1, kTopThreads, 0, s>>>(tile_sums, ntiles);
  if (int e = last_error()) return e;
  topk_collect_kernel<<<(unsigned)ntiles, kScanThreads, 0, s>>>(
      src, n, tile_sums, sel);
  return last_error();
}

// words: [parts, k] int64 (parts: one per key, two for a float key);
// valid: [k] uint8.
int gt_topk_words(const long long* desc, int nkeys, int levels,
                  const uint8_t* mask, const int32_t* sel, long long k,
                  long long* words, uint8_t* valid, void* stream) {
  if (k <= 0) return last_error();
  const Desc ds{desc, nkeys, levels};
  topk_words_kernel<<<blocks_for(k), kThreads, 0, (cudaStream_t)stream>>>(
      ds, mask, sel, k, words, valid);
  return last_error();
}

}  // extern "C"
