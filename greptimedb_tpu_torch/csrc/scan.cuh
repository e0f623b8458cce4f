// Shared scan and radix machinery of the hand-written CUDA libraries.
//
// Included by promql_kernels.cu (the f64 counter-drop scan and the radix
// passes of sort_layout's general route), segment_kernels.cu (the mask scan
// of compact, the rank scan of rank_scatter and the radix passes of
// radix_argsort) and topk_kernels.cu (the class scan of topk_select): one
// scan and one radix sort, instantiated in each library.
//
// launch_scan / launch_scan_with: single-pass inclusive scan with decoupled
// look-back, one launch after a reset of the tile status.  A block takes
// the next tile id from an atomic counter (so every tile below it has
// started and the look-back makes progress), stages its 4,096 elements in
// shared memory with coalesced reads, scans each thread's 16 contiguous
// elements in order and the thread sums by warp shuffles, and warp 0
// publishes the tile's aggregate, looks back for the sum of every tile
// below it and publishes its inclusive prefix.  Integer sums, exact in any
// order, publish flag and value in one 64-bit status word (as radix_pass
// does), so relaxed loads and stores carry them and a look-back reads each
// tile once; the look-back adds by a warp tree.  Float sums keep value and
// flag apart: the value is written, then __threadfence(), then its flag
// (st.release); a reader loads the flag with ld.acquire, then the value.
// Their look-back folds the tile sums in ascending tile order onto the
// nearest inclusive prefix it finds (a left fold, not a tree), so every
// tile's prefix is the same left fold of the tile sums whichever tiles it
// read: f64 results repeat bit for bit from run to run.  It reads the 64
// tiles below at once (256 for integer sums) and folds in registers; with
// no inclusive prefix among them, or a tile above it unpublished, it reads
// again.
// Element sources are fused prologues (functors with `T operator()(long
// long i)`), called by whole warps with lane l on element i0 + l (past the
// end on element n - 1, whose value is dropped), so a source may take row
// i - 1 from lane l - 1 by a shuffle and read it only on lane 0.  An
// epilogue functor receives (i, the exclusive prefix, the inclusive
// prefix); the default one stores the inclusive prefix.
//
// radix_pass: one stable LSD pass of (key, row index) pairs on an 8-bit
// digit, onesweep style.  The caller's key kernel has built every pass's
// 256-bin histogram in one read (radix_hist_add / radix_hist_flush: bins
// in shared memory, lanes with equal digits add once, each block adds its
// nonzero bins to device memory once).  Per pass one scatter launch: a
// block takes a tile id from an atomic counter, loads 4,096 keys warp-
// striped, ranks each key among the tile's keys of its digit in row order
// (a warp multi-split: __match_any_sync, the lanes below with the same
// digit and the warp's running count a digit), publishes its 256 digit
// counts, then one thread a digit looks back over the tiles below, eight
// status words at a time, for the digit's global offset (tile 0 starts
// from the histogram's exclusive scan) and publishes the inclusive count.
// A status word is 64 bits, as the integer scan's: the flag in the top two,
// the count below (no count can overflow it), so relaxed loads and stores
// carry it.  Keys,
// then row indices (read only now; the first pass reads none, its rows
// are 0..n-1), are staged through shared memory in digit order, so each
// digit's run of the tile lands contiguously in device memory.  Keys are
// u32 or u64 (the caller picks the narrowest that holds them); the last
// pass may skip writing keys.  A pass whose digit every key shares (one
// bin of the histogram holds n) copies keys and indices as they are.
// Bound: bytes, per pass the keys and
// indices read and written once: 16 B/row for u32 keys, 24 for u64, 4
// less on the first pass and on the last.
//
// f32_key / f32_sort_key / warp_bitonic_sort: the order-preserving 32-bit
// keys of floats and the warp-wide bitonic sort that window_matrix (promql)
// and segment_select (segment) sort windows and groups with, and that the
// f32 min/max reductions of segment_reduce compare by.
//
// reg_bitonic_sort / reg_pick: the same sort for up to 32 keys a thread,
// held in a register array: an ascending bitonic network unrolled at
// compile time (P/2 * log2 P * (log2 P + 1) / 2 compare-exchanges, each a
// min and a max, 240 at P = 32), and the read of one order statistic by
// compare-and-select over every slot, since a runtime index into a
// register array sends the array to local memory.  The register routes of
// window_matrix / window_matrix_dense (promql) and segment_select's tiny
// groups (segment) sort with them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr long long kI64Max = 0x7fffffffffffffffLL;
constexpr unsigned kAllLanes = 0xffffffffu;

// The launch just made was refused (or an earlier fault is pending): 0 or
// the cudaError_t, checked right after every launch.
inline int last_error() { return (int)cudaGetLastError(); }

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// The scan's flags: a value is published before its flag (gpu scope).
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Status words of the integer scan and the radix passes: flag and value in
// one 64-bit word, the flag in the top two bits and the value's low 62 bits
// below, so relaxed loads and stores suffice (no other data rides on
// them).  A 32-bit value may be any; a 64-bit one must lie in [0, 2^62).
constexpr unsigned long long kWordAggregate = 1ull << 62;
constexpr unsigned long long kWordInclusive = 2ull << 62;
constexpr unsigned long long kWordValue = (1ull << 62) - 1;

template <typename T>
__device__ __forceinline__ unsigned long long status_word(
    unsigned long long flag, T v) {
  using U = typename std::make_unsigned<T>::type;
  return flag | ((unsigned long long)(U)v & kWordValue);
}

template <typename T>
__device__ __forceinline__ T status_value(unsigned long long w) {
  using U = typename std::make_unsigned<T>::type;
  return (T)(U)(w & kWordValue);
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <typename T>
__device__ __forceinline__ T ld_volatile(const T* p) {
  return *(const volatile T*)p;
}

// Inclusive scan over the warp's lanes (shuffles, a fixed order).
template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T u = __shfl_up_sync(kAllLanes, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Exclusive scan over the block's threads (blockDim.x a multiple of 32);
// `total` receives the block's sum.  `sm` holds 33 elements.  Every
// thread of the block calls it.
template <typename T>
__device__ T block_exclusive_scan(T v, T* sm, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const T inc = warp_inclusive_scan(v, lane);
  if (lane == 31) sm[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < nw ? sm[lane] : T(0);
    const T winc = warp_inclusive_scan(w, lane);
    const T wex = __shfl_up_sync(kAllLanes, winc, 1);
    if (lane < nw) sm[lane] = lane == 0 ? T(0) : wex;
    if (lane == nw - 1) sm[32] = winc;
  }
  __syncthreads();
  total = sm[32];
  const T ex = __shfl_up_sync(kAllLanes, inc, 1);
  const T r = sm[warp] + (lane == 0 ? T(0) : ex);
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// launch_scan
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;  // 4096
// Windows of 32 tiles a look-back reads at once: integer sums fold in any
// order (a warp tree), float sums in ascending tile order (one lane).
constexpr int kLookWindowsInt = 8;
constexpr int kLookWindowsFloat = 2;

enum : unsigned { kTileNone = 0, kTileAggregate = 1, kTileInclusive = 2 };

// The status of a scan's tiles, carved from one scratch buffer
// (cuda_build.scan_scratch).  Integer sums: a status word a tile
// [ntiles], then the tile counter (ntiles * 8 + 4 bytes).  Float sums:
// aggregates [ntiles], inclusive prefixes [ntiles], flags [ntiles], then
// the tile counter (ntiles * (2 * sizeof(T) + 4) + 4 bytes).
template <typename T>
struct ScanTiles {
  static constexpr bool kPacked = std::is_integral<T>::value;
  unsigned long long* word = nullptr;
  T* agg = nullptr;
  T* incl = nullptr;
  unsigned* flag = nullptr;
  unsigned* next;
  ScanTiles(void* scratch, long long ntiles) {
    if constexpr (kPacked) {
      word = (unsigned long long*)scratch;
      next = (unsigned*)(word + ntiles);
    } else {
      agg = (T*)scratch;
      incl = agg + ntiles;
      flag = (unsigned*)(incl + ntiles);
      next = flag + ntiles;
    }
  }
  // What each launch resets: the status words or flags, and the counter.
  void* reset_base() const { return kPacked ? (void*)word : (void*)flag; }
  size_t reset_bytes(long long ntiles) const {
    return kPacked ? sizeof(unsigned long long) * ntiles + sizeof(unsigned)
                   : sizeof(unsigned) * (ntiles + 1);
  }
  // Tile t's aggregate (kTileAggregate) or inclusive prefix.
  __device__ void publish(long long t, unsigned f, T v) const {
    if constexpr (kPacked) {
      st_relaxed(&word[t], status_word(
          f == kTileInclusive ? kWordInclusive : kWordAggregate, v));
    } else {
      (f == kTileInclusive ? incl : agg)[t] = v;
      __threadfence();
      st_release(&flag[t], f);
    }
  }
};

template <typename T>
struct StoreOut {  // the default epilogue: out[i] = inclusive prefix
  T* out;
  __device__ void operator()(long long i, T, T incl) const { out[i] = incl; }
};

// The sum of every tile below t (see the header).  Run by one warp: lane
// l reads tile t - 32 (r + 1) + l of window r, all windows at once; the
// sum starts at the nearest inclusive prefix and needs every tile above
// it published, else the warp reads again.  Integer sums read flag and
// value in one word and add by a warp tree; float sums read the flags,
// then the values, and fold the tiles in ascending order (a left fold).
template <typename T>
__device__ T scan_look_back(const ScanTiles<T>& tiles, long long t,
                            int lane) {
  constexpr bool kPacked = ScanTiles<T>::kPacked;
  constexpr int kW = kPacked ? kLookWindowsInt : kLookWindowsFloat;
  while (true) {
    unsigned long long w[kW];  // integer sums: the status words
    unsigned f[kW], inc[kW], none[kW];
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      const long long j = t - 32 * (r + 1) + lane;
      // below tile 0: an empty aggregate, never folded (tile 0 is inclusive)
      if constexpr (kPacked) {
        w[r] = j >= 0 ? ld_relaxed(&tiles.word[j]) : kWordAggregate;
        f[r] = (unsigned)(w[r] >> 62);
      } else {
        f[r] = j >= 0 ? ld_acquire(&tiles.flag[j]) : (unsigned)kTileAggregate;
      }
      inc[r] = __ballot_sync(kAllLanes, f[r] == kTileInclusive);
      none[r] = __ballot_sync(kAllLanes, f[r] == kTileNone);
    }
    int rp = -1, hp = 0;  // the nearest inclusive prefix: window, lane
#pragma unroll
    for (int r = kW - 1; r >= 0; --r) {
      if (inc[r] != 0) {
        rp = r;
        hp = 31 - __clz(inc[r]);
      }
    }
    if (rp < 0) continue;
    bool ready = (none[rp] & ~((2u << hp) - 1u)) == 0;
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      if (r < rp && none[r] != 0) ready = false;
    }
    if (!ready) continue;
    if constexpr (kPacked) {
      T acc = T(0);
#pragma unroll
      for (int r = 0; r < kW; ++r) {
        const bool in = r < rp || (r == rp && lane >= hp);
        if (in) acc += status_value<T>(w[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kAllLanes, acc, off);
      }
      return acc;
    } else {
      T v[kW];
#pragma unroll
      for (int r = 0; r < kW; ++r) {
        const long long j = t - 32 * (r + 1) + lane;
        const bool in = r < rp || (r == rp && lane >= hp);
        v[r] = in && j >= 0 ? ld_volatile(f[r] == kTileInclusive
                                              ? &tiles.incl[j]
                                              : &tiles.agg[j])
                            : T(0);
      }
      T acc = T(0);
#pragma unroll
      for (int r = kW - 1; r >= 0; --r) {
        if (r > rp) continue;
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          const T x = __shfl_sync(kAllLanes, v[r], l);
          if (r == rp && l < hp) continue;
          acc = (r == rp && l == hp) ? x : acc + x;
        }
      }
      return acc;
    }
  }
}

// Shared-memory slot of tile element k: one pad slot every 16 elements
// keeps a thread's 16 contiguous elements off its neighbours' banks.
__device__ __forceinline__ int sidx(int k) { return k + (k >> 4); }

// One tile: src into shared memory (coalesced: element k = j * 256 + tid,
// so lane l of a warp calls src on element i0 + l; past the end it calls
// src(n - 1) and drops the value), each thread's 16 contiguous elements
// scanned in order, a block scan of the thread sums, warp 0's look-back,
// then the epilogue over the tile, coalesced again.
template <typename T, typename Src, typename Out>
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(Src src, long long n, ScanTiles<T> tiles, Out out) {
  __shared__ T tile[kScanTile + kScanTile / 16];
  __shared__ T sm[33];
  __shared__ T tile_prefix;
  __shared__ unsigned tile_id;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_id = atomicAdd(tiles.next, 1u);
  __syncthreads();
  const long long t = tile_id;
  const long long base = t * kScanTile;
  T x[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = base + j * kScanThreads + tid;
    x[j] = src(i < n ? i : n - 1);
  }
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int k = j * kScanThreads + tid;
    tile[sidx(k)] = base + k < n ? x[j] : T(0);
  }
  __syncthreads();
  const int k0 = tid * kScanItems;
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    acc += tile[sidx(k0 + j)];
    tile[sidx(k0 + j)] = acc;
  }
  T aggregate;
  const T thread_excl = block_exclusive_scan(acc, sm, aggregate);
  if (warp == 0) {
    T prefix = T(0);
    if (t > 0) {
      if (lane == 0) tiles.publish(t, kTileAggregate, aggregate);
      prefix = scan_look_back(tiles, t, lane);
    }
    if (lane == 0) {
      tiles.publish(t, kTileInclusive, prefix + aggregate);
      tile_prefix = prefix;
    }
  }
  __syncthreads();
  const T pre = tile_prefix + thread_excl;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    tile[sidx(k0 + j)] = pre + tile[sidx(k0 + j)];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int k = j * kScanThreads + tid;
    const long long i = base + k;
    if (i < n) {
      out(i, k == 0 ? tile_prefix : tile[sidx(k - 1)], tile[sidx(k)]);
    }
  }
}

// Inclusive scan of src(0..n-1) through the epilogue `out`; `scratch`
// holds the tile status (ScanTiles).  One reset, one launch.
template <typename T, typename Src, typename Out>
int launch_scan_with(Src src, long long n, void* scratch, Out out,
                     cudaStream_t st) {
  if (n <= 0) return last_error();
  const long long ntiles = (n + kScanTile - 1) / kScanTile;
  const ScanTiles<T> tiles(scratch, ntiles);
  if (int e = (int)cudaMemsetAsync(tiles.reset_base(), 0,
                                   tiles.reset_bytes(ntiles), st)) {
    return e;
  }
  scan_kernel<T, Src, Out><<<(unsigned)ntiles, kScanThreads, 0, st>>>(
      src, n, tiles, out);
  return last_error();
}

// out[i] = src(0) + ... + src(i).
template <typename T, typename Src>
int launch_scan(Src src, long long n, void* scratch, T* out,
                cudaStream_t st) {
  return launch_scan_with<T, Src, StoreOut<T>>(src, n, scratch,
                                               StoreOut<T>{out}, st);
}

// ---------------------------------------------------------------------------
// radix_pass
// ---------------------------------------------------------------------------

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;
constexpr int kSortTile = kSortThreads * kSortItems;  // 4096
constexpr int kRadixBins = 256;  // one a thread of the scatter block
constexpr int kRadixMaxPasses = 8;
constexpr int kLookDepth = 8;  // status words a digit's look-back reads

template <typename K>
__device__ __forceinline__ unsigned radix_digit(K key, int shift) {
  return (unsigned)(key >> shift) & 0xffu;
}

// Adds the key's `passes` digits (bits 0-7, 8-15, ...) to the block's
// bins sh[passes][256].  Every lane of the warp calls it; `in` is false
// past the end.  Lanes that share a digit add once.
template <typename K>
__device__ __forceinline__ void radix_hist_add(unsigned* sh, K key,
                                               int passes, bool in) {
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < passes; ++p) {
    const unsigned d = in ? radix_digit(key, 8 * p) : (unsigned)kRadixBins;
    const unsigned peers = __match_any_sync(kAllLanes, d);
    if (in && lane == __ffs(peers) - 1) {
      atomicAdd(&sh[p * kRadixBins + d], (unsigned)__popc(peers));
    }
  }
}

__device__ __forceinline__ void radix_hist_zero(unsigned* sh, int passes) {
  for (int b = threadIdx.x; b < passes * kRadixBins; b += blockDim.x) {
    sh[b] = 0;
  }
}

// The block's nonzero bins into hist[passes][256] (after __syncthreads).
__device__ __forceinline__ void radix_hist_flush(const unsigned* sh,
                                                 unsigned* hist, int passes) {
  for (int b = threadIdx.x; b < passes * kRadixBins; b += blockDim.x) {
    if (sh[b] != 0) atomicAdd(&hist[b], sh[b]);
  }
}

// Grid of a key kernel that builds the histograms: a few blocks a
// multiprocessor, so each block flushes its bins once.
unsigned radix_hist_grid(long long n) {
  const long long want = blocks_for(n > 0 ? n : 1);
  return (unsigned)(want < 1056 ? want : 1056);
}

// The count of digit b in every tile below t: thread b reads kLookDepth
// tiles' status words at once, adds them from the nearest down and stops
// at an inclusive one; an unpublished word is read again.
__device__ __forceinline__ long long radix_look_back(
    const unsigned long long* status, long long t, int b) {
  long long sum = 0;
  long long j = t - 1;  // the nearest tile not yet added
  while (true) {
    unsigned long long s[kLookDepth];
#pragma unroll
    for (int k = 0; k < kLookDepth; ++k) {
      // below tile 0 nothing is read: tile 0 is inclusive, the walk stops
      s[k] = j - k >= 0 ? ld_relaxed(status + 1 + (j - k) * kRadixBins + b)
                        : kWordInclusive;
    }
    bool done = false;
    int used = kLookDepth;
#pragma unroll
    for (int k = 0; k < kLookDepth; ++k) {
      if (!done && used == kLookDepth) {
        const unsigned long long f = s[k] & ~kWordValue;
        if (f == 0) {
          used = k;
        } else {
          sum += (long long)(s[k] & kWordValue);
          done = f == kWordInclusive;
        }
      }
    }
    if (done) return sum;
    j -= used;
  }
}

// One stable scatter on the digit at `shift` (see the header).  hist:
// this digit's 256 counts over all n keys; status: 1 + ceil(n / 4096) *
// 256 words, zeroed (the tile counter, then a word a (tile, digit)).
template <typename K>
__global__ void __launch_bounds__(kSortThreads)
    radix_scatter_kernel(const K* __restrict__ key_in,
                         const int32_t* __restrict__ idx_in, long long n,
                         int shift, const unsigned* __restrict__ hist,
                         unsigned long long* status, K* __restrict__ key_out,
                         int32_t* __restrict__ idx_out) {
  __shared__ K buf[kSortTile];  // keys, then row indices, in digit order
  __shared__ unsigned warp_cnt[kSortWarps][kRadixBins];
  __shared__ unsigned tile_excl[kRadixBins];
  __shared__ int gofs[kRadixBins];  // output slot of the digit's tile slot 0
  __shared__ unsigned sm[33];
  __shared__ unsigned long long tile_id;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // hist sums to n: a digit every key shares leaves the order as it is, so
  // each block copies its tile and no look-back runs
  if (__syncthreads_or(hist[tid] == (unsigned)n)) {
    const long long base = (long long)blockIdx.x * kSortTile;
    for (int o = tid; o < kSortTile && base + o < n; o += kSortThreads) {
      const long long i = base + o;
      if (key_out != nullptr) key_out[i] = key_in[i];
      idx_out[i] = idx_in != nullptr ? idx_in[i] : (int32_t)i;
    }
    return;
  }
  if (tid == 0) tile_id = atomicAdd(status, 1ull);
  for (int b = tid; b < kSortWarps * kRadixBins; b += kSortThreads) {
    (&warp_cnt[0][0])[b] = 0;
  }
  __syncthreads();
  const long long t = (long long)tile_id;
  const long long tile_base = t * kSortTile;
  const long long left = n - tile_base;
  const int tile_n = left < kSortTile ? (int)left : kSortTile;
  const int wbase = warp * (32 * kSortItems) + lane;  // tile slot of item 0
  K key[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int o = wbase + j * 32;
    key[j] = o < tile_n ? key_in[tile_base + o] : K(0);
  }
  // stable rank among the warp's keys of the same digit: items in (j, lane)
  // order are the warp's keys in row order
  unsigned* wc = warp_cnt[warp];
  const unsigned below = (1u << lane) - 1u;
  int slot[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const bool in = wbase + j * 32 < tile_n;
    const unsigned d = in ? radix_digit(key[j], shift) : (unsigned)kRadixBins;
    const unsigned peers = __match_any_sync(kAllLanes, d);
    const unsigned c = in ? wc[d] : 0u;
    __syncwarp();
    if (in && lane == 31 - __clz(peers)) wc[d] = c + __popc(peers);
    __syncwarp();
    slot[j] = (int)(c + __popc(peers & below));
  }
  __syncthreads();
  // thread b owns digit b: the warps' offsets, the tile's count, its
  // offset in the tile and, by the look-back, in the output
  const int b = tid;
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const unsigned c = warp_cnt[w][b];
    warp_cnt[w][b] = count;
    count += c;
  }
  unsigned total;
  const unsigned excl = block_exclusive_scan(count, sm, total);
  tile_excl[b] = excl;
  unsigned long long* mine = status + 1 + t * kRadixBins;
  long long global;
  if (t == 0) {
    global = block_exclusive_scan(hist[b], sm, total);
  } else {
    st_relaxed(&mine[b], kWordAggregate | count);
    global = radix_look_back(status, t, b);
  }
  st_relaxed(&mine[b], kWordInclusive | (unsigned long long)(global + count));
  gofs[b] = (int)(global - excl);  // n < 2^31
  __syncthreads();
  // keys into shared memory in digit order, then out: slot p of digit d
  // goes to gofs[d] + p
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (wbase + j * 32 < tile_n) {
      const unsigned d = radix_digit(key[j], shift);
      slot[j] += (int)(tile_excl[d] + wc[d]);
      buf[slot[j]] = key[j];
    }
  }
  __syncthreads();
  int dst[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int p = k * kSortThreads + tid;
    dst[k] = -1;
    if (p < tile_n) {
      const K kk = buf[p];
      dst[k] = gofs[radix_digit(kk, shift)] + p;
      if (key_out != nullptr) key_out[dst[k]] = kk;
    }
  }
  __syncthreads();
  // the row indices take the keys' slots (read now, not held through the
  // ranking: fewer registers)
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int o = wbase + j * 32;
    if (o < tile_n) {
      const long long i = tile_base + o;
      buf[slot[j]] = (K)(uint32_t)(idx_in != nullptr ? idx_in[i]
                                                     : (int32_t)i);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (dst[k] >= 0) {
      idx_out[dst[k]] = (int32_t)(uint32_t)buf[k * kSortThreads + tid];
    }
  }
}

// One stable radix pass over n (key, row index) pairs on the digit at
// `shift`: idx_in null reads rows 0..n-1; key_out may be null (the last
// pass); hist: the digit's 256 counts; status: 1 + ceil(n / 4096) * 256
// words of scratch, reset here.
template <typename K>
int radix_pass(const K* key_in, const int32_t* idx_in, long long n,
               int shift, const unsigned* hist, unsigned long long* status,
               K* key_out, int32_t* idx_out, cudaStream_t st) {
  if (n <= 0) return last_error();
  const long long ntiles = (n + kSortTile - 1) / kSortTile;
  if (int e = (int)cudaMemsetAsync(
          status, 0, sizeof(unsigned long long) * (1 + ntiles * kRadixBins),
          st)) {
    return e;
  }
  radix_scatter_kernel<K><<<(unsigned)ntiles, kSortThreads, 0, st>>>(
      key_in, idx_in, n, shift, hist, status, key_out, idx_out);
  return last_error();
}

// radix_pass on u64 keys (`wide`) or u32 keys, for the C entry points.
int radix_pass_any(const void* key_in, const int32_t* idx_in, long long n,
                   int wide, int shift, const unsigned* hist,
                   unsigned long long* status, void* key_out,
                   int32_t* idx_out, cudaStream_t st) {
  if (wide) {
    return radix_pass<unsigned long long>(
        (const unsigned long long*)key_in, idx_in, n, shift, hist, status,
        (unsigned long long*)key_out, idx_out, st);
  }
  return radix_pass<uint32_t>((const uint32_t*)key_in, idx_in, n, shift,
                              hist, status, (uint32_t*)key_out, idx_out, st);
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

// Ascending bitonic sort of k[0, P) in registers (P a power of two), one
// thread: the network is unrolled at compile time, so every index is a
// constant and the array never leaves registers.
template <int P>
__device__ __forceinline__ void reg_bitonic_sort(uint32_t (&k)[P]) {
#pragma unroll
  for (int kk = 2; kk <= P; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int p = i ^ j;
        if (p > i) {
          const uint32_t x = k[i], y = k[p];
          const uint32_t lo = x < y ? x : y, hi = x < y ? y : x;
          k[i] = (i & kk) == 0 ? lo : hi;
          k[p] = (i & kk) == 0 ? hi : lo;
        }
      }
    }
  }
}

// k[r] for a runtime r in [0, P) (k[0] for any other r) by compare-and-
// select over every slot, keeping k in registers.
template <int P>
__device__ __forceinline__ uint32_t reg_pick(const uint32_t (&k)[P], int r) {
  uint32_t v = k[0];
#pragma unroll
  for (int j = 1; j < P; ++j) v = j == r ? k[j] : v;
  return v;
}

}  // namespace
