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
//   Order keys.  Each ORDER BY key becomes one unsigned order key a row
//   (`order_key`: 8 to 64 bits, the column's width) whose unsigned order
//   is the (rank, value) order: DESC negates in the dtype, a float's bits
//   are flipped to an unsigned order with -0.0 taken as +0.0 (so the two
//   tie, as in lexsort), and NaN becomes 0 (NULLS FIRST) or all ones
//   (NULLS LAST): no other value reaches either.  The row index is the
//   last key, the mask's class (set rows first) the first.
//
//   Candidate route (the rule).  Bound: bytes, the mask and the keys read
//   once and k indices written; what holds a radix select back is one
//   pass over all N rows per digit.  So each pass over N splits as much as
//   it can, and after it only the rows that can still be in the answer
//   are read:
//   1. topk_sample (no pass over N): the AND and OR of the first key's
//      order keys over the rows with the mask set in up to 1,024 warp tiles
//      (512 rows each) spread evenly over the table: the bits that such
//      rows share, by the sample.
//   2. topk_scan0 (pass 1 over N): counts the rows with the mask set, takes
//      the exact AND / OR of their first key, and counts them in 2,048
//      shared-memory bins by the 11-bit digit below the bits the sample's
//      rows share (lanes with equal digits add once).  Mask bytes are read
//      16 a lane; a row's key is loaded only where its mask byte is set.
//      The last block to finish (a done counter after a __threadfence)
//      keeps the histogram when at least k rows are set and the exact
//      range's top varying bit is the sample's, and picks the digit that
//      holds the k-th row.  The entry point then reads the state back: the
//      call's one host sync, which gives the rows with the mask set and
//      the size of the picked bin.  When the histogram does not stand (a
//      sample that missed the extremes, fewer than k rows set), topk_hist0
//      (pass 2) counts the set S by the exact range: the rows with the
//      mask set when there are at least k of them, else the unset rows
//      (the set rows all go to the answer first; the digit is then the
//      key's top bits), and a second sync reads it back.
//   3. When the picked bin fits the candidate buffer (the wrapper's
//      capacity), topk_split0 (pass 2, or 3) appends every row strictly
//      better than the picked prefix to the output (fewer than k) and
//      every row in the picked bin to a candidate buffer of (row, order key),
//      keeping the AND / OR of the candidates' key.  Appends are block-
//      aggregated: one atomic a block and a step for each list.
//   4. The candidates are refined by phases, each one launch over the
//      buffer only: `range` (the next key's order keys gathered by row
//      and stored in the buffer, with their AND / OR), `hist` (the next
//      11-bit digit below the bits every candidate shares; the last block
//      picks) and `split` (better candidates to the output, the picked
//      ones to the other buffer).  Each phase's last block writes the
//      next phase, so the host launches a fixed number of steps and waits
//      on none; a step finds the phase on the device and returns at once
//      when there is nothing left for it (done, or few candidates left).
//   5. topk_finish, one block: the remaining phases while the output and
//      the candidates hold more than `stop` rows (k up to the shared-memory
//      sort's capacity: stop = min(capacity, max(2 k, 512))) or until
//      exactly k rows are chosen (larger k), then, for small k, a bitonic
//      sort in shared memory of the output and the candidates by (class,
//      keys..., row), whose first k rows are the answer.  Larger k leaves
//      the k rows to gt_topk_order, which waits on nothing: topk_span takes
//      the AND / OR of their sort words (class, order keys, row),
//      topk_pack packs each word's varying bits into a composite key of
//      as many u64 words as the widest composite needs (the wrapper's
//      static width), and scan.cuh's radix passes sort it, the least
//      significant word first; the passes above the bits that vary find
//      one digit in every row and copy.
//   So N is read twice, or three times when the sample's digit does not
//   stand (mask and first key; the first key only where the mask byte is
//   set), and every later phase reads only the candidates: on
//   chip_smoke.py's shapes a few thousand for (j), the walk's ties at
//   100.0 / 0.0 and their neighbours for (k) and (l).
//
//   Rows route (overflow).  When the picked bin is larger than the buffer
//   (a constant or all-NaN first key, a huge tie), the previous design
//   runs: one histogram pass over N per 8-bit level of (class, order
//   keys...), each level's digit picked by one block, a device flag
//   stopping the levels once the rows equal to the prefix fit, then one
//   single-pass scan (scan.cuh's launch_scan_with, the collect as its
//   epilogue) that collects in row order every row below the prefix and
//   the first k_rem rows equal to it; gt_topk_order sorts the k rows as
//   above.  Both routes equal the stable lexsort row for row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

// Key and level descriptors, one int64 array (ops/topk_kernels.py
// `_descriptors`), uploaded with the state: [nkeys] column pointers,
// [nkeys] KeyType, [nkeys] flags (bit 0 DESC, bit 1 NULLS FIRST), then the
// rows route's levels: per level its key (-1: the mask's class) and shift.
struct Desc {
  const long long* d;
  int nkeys;
  int levels;
  __device__ const void* ptr(int j) const { return (const void*)d[j]; }
  __device__ int type(int j) const { return (int)d[nkeys + j]; }
  __device__ int flags(int j) const { return (int)d[2 * nkeys + j]; }
  __device__ int lkey(int l) const { return (int)d[3 * nkeys + l]; }
  __device__ int lshift(int l) const { return (int)d[3 * nkeys + levels + l]; }
};

__device__ __forceinline__ int key_bits(int t) {
  return (t == kF64 || t == kI64) ? 64
         : (t == kF32 || t == kI32 || t == kU32) ? 32
         : (t == kI16 || t == kU16) ? 16 : 8;
}

// The element type of a column of KeyType T, and the register type of its
// order keys (32 bits for keys up to 32 bits wide).
template <int T> struct Col { using type = float; };
template <> struct Col<kF64> { using type = double; };
template <> struct Col<kI64> { using type = long long; };
template <> struct Col<kI32> { using type = int32_t; };
template <> struct Col<kI16> { using type = int16_t; };
template <> struct Col<kI8> { using type = int8_t; };
template <> struct Col<kU8> { using type = uint8_t; };
template <> struct Col<kU16> { using type = uint16_t; };
template <> struct Col<kU32> { using type = uint32_t; };
template <int T>
using okey_t = typename std::conditional<sizeof(typename Col<T>::type) == 8,
                                         u64, uint32_t>::type;

// The order key of a value of a column of type T (see the header).
template <int T>
__device__ __forceinline__ u64 order_key_of(typename Col<T>::type v, int fl) {
  const bool desc = (fl & 1) != 0;
  const bool nf = (fl & 2) != 0;
  if constexpr (T == kF32) {
    if (isnan(v)) return nf ? 0ull : 0xffffffffull;
    if (desc) v = -v;
    const uint32_t b = v == 0.0f ? 0u : __float_as_uint(v);  // -0 == +0
    return (b & 0x80000000u) ? (uint32_t)~b : (b | 0x80000000u);
  } else if constexpr (T == kF64) {
    if (isnan(v)) return nf ? 0ull : ~0ull;
    if (desc) v = -v;
    const u64 b = v == 0.0 ? 0ull : (u64)__double_as_longlong(v);
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  } else if constexpr (T == kI64) {
    u64 x = (u64)v;
    if (desc) x = 0ull - x;
    return x ^ 0x8000000000000000ull;
  } else if constexpr (T == kI32) {
    uint32_t x = (uint32_t)v;
    if (desc) x = 0u - x;
    return x ^ 0x80000000u;
  } else if constexpr (T == kI16) {
    uint16_t x = (uint16_t)v;
    if (desc) x = (uint16_t)(0u - x);
    return (uint16_t)(x ^ 0x8000u);
  } else if constexpr (T == kI8) {
    uint8_t x = (uint8_t)v;
    if (desc) x = (uint8_t)(0u - x);
    return (uint8_t)(x ^ 0x80u);
  } else if constexpr (T == kU8 || T == kU16) {
    if (desc) v = (typename Col<T>::type)(0u - v);
    return v;
  } else {  // kU32
    if (desc) v = 0u - v;
    return v;
  }
}

// The order key of row i of a column of type T.
template <int T>
__device__ __forceinline__ u64 order_key_t(const void* p, long long i,
                                           int fl) {
  return order_key_of<T>(static_cast<const typename Col<T>::type*>(p)[i],
                         fl);
}

// Key j of row i; key nkeys is the row index itself.
__device__ __forceinline__ u64 order_key(const Desc& ds, int j, long long i) {
  if (j >= ds.nkeys) return (u64)i;
  const void* p = ds.ptr(j);
  const int fl = ds.flags(j);
  switch (ds.type(j)) {
    case kF32: return order_key_t<kF32>(p, i, fl);
    case kF64: return order_key_t<kF64>(p, i, fl);
    case kI64: return order_key_t<kI64>(p, i, fl);
    case kI32: return order_key_t<kI32>(p, i, fl);
    case kI16: return order_key_t<kI16>(p, i, fl);
    case kI8: return order_key_t<kI8>(p, i, fl);
    case kU8: return order_key_t<kU8>(p, i, fl);
    case kU16: return order_key_t<kU16>(p, i, fl);
    default: return order_key_t<kU32>(p, i, fl);
  }
}

// ---------------------------------------------------------------------------
// Candidate route
// ---------------------------------------------------------------------------

constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;  // 2,048
constexpr int kPassThreads = 256;       // 8 warps
// the histogram pass: 16 warps a block, two an SM, so few blocks add
// their 2,048 bins to device memory
constexpr int kHistThreads = 512;
constexpr int kTileRows = 512;          // a warp's tile: 16 mask bytes a lane
constexpr int kStepThreads = 256;
constexpr int kStepItems = 4;           // candidates a thread a round
constexpr int kFinishThreads = 1024;

// State words (int64) after the descriptors; ops/topk_kernels.py `STATE`
// holds the same names and their initial values.
enum : int {
  cK = 0,      // k
  cLive,       // rows with the mask set
  cAnd,        // AND of the current key's order keys over the set
  cOr,         // OR of them
  cTarget,     // 0: the set is rows with the mask set; 1: the unset rows
  cRem,        // rows still to take from the set
  cKey,        // the set's current key (nkeys: the row index)
  cShift,      // the current digit: bits [shift, shift + width)
  cWidth,
  cPick,       // the picked digit
  cPickCnt,    // rows in its bin
  cFinal,      // 1 when the bin fits: its rows go to the output
  cOut,        // rows in the output
  cCnt0,       // candidates in buffer 0 / 1
  cCnt1,
  cBuf,        // the buffer holding the set
  cPhase,      // kRange / kHist / kSplit / kDone
  cTicket,     // blocks done in the current launch
  cSAnd,       // the sample's AND / OR of the first key over the set rows
  cSOr,
  cSLive,      // the sample's rows with the mask set
  cValid,      // 1 when pass 1's histogram (the sample's digit) stands
  cWords
};
enum : int { kRange = 0, kHist = 1, kSplit = 2, kDone = 3 };

template <typename T>
__device__ __forceinline__ T vload(const T* p) {
  return *(const volatile T*)p;
}

__device__ __forceinline__ void digit_of(u64 a, u64 o, long long& shift,
                                         long long& width) {
  const u64 x = a ^ o;
  if (x == 0) {
    shift = 0;
    width = 0;
    return;
  }
  const int hi = 63 - __clzll((long long)x);
  const int lo = __ffsll((long long)x) - 1;
  shift = hi - (kDigitBits - 1) > lo ? hi - (kDigitBits - 1) : lo;
  width = hi - shift + 1;
}

__device__ __forceinline__ unsigned digit(u64 key, int shift, int width) {
  return width == 0 ? 0u
                    : (unsigned)((key >> shift) & ((1ull << width) - 1ull));
}

// The 16 rows base + 16 lane + r of a warp tile: bit r the mask set, bit
// 16 + r the row exists.
__device__ __forceinline__ unsigned tile_bits(const uint8_t* mask,
                                              long long n, long long base,
                                              int lane) {
  const long long r0 = base + 16LL * lane;
  if (r0 + 16 <= n && (((uintptr_t)(mask + r0)) & 15) == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(mask + r0);
    const unsigned q[4] = {w.x, w.y, w.z, w.w};
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned t = q[k] | (q[k] >> 4);
      t |= t >> 2;
      t |= t >> 1;
      t &= 0x01010101u;  // bit 8 b: byte b nonzero
      live |= ((t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xfu) << (4 * k);
    }
    return live | 0xffff0000u;
  }
  unsigned bits = 0;
  for (int r = 0; r < 16; ++r) {
    if (r0 + r < n) bits |= ((mask[r0 + r] != 0 ? 1u : 0u) << r) | (1u << (16 + r));
  }
  return bits;
}

// Row base + 32 j + lane of the tile: (mask set, exists) from the owner
// lane's bits.  Every lane calls it.
__device__ __forceinline__ void row_bits(unsigned bits, int j, int lane,
                                         bool& live, bool& exists) {
  const unsigned s = __shfl_sync(kFull, bits, 2 * j + (lane >> 4));
  live = ((s >> (lane & 15)) & 1u) != 0;
  exists = ((s >> (16 + (lane & 15))) & 1u) != 0;
}

// AND / OR of the block's threads into st[wa] / st[wo].
__device__ void block_and_or(u64 a, u64 o, long long* st, int wa = cAnd,
                             int wo = cOr) {
  __shared__ u64 sa[32], so[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a &= __shfl_xor_sync(kFull, a, off);
    o |= __shfl_xor_sync(kFull, o, off);
  }
  if (lane == 0) {
    sa[warp] = a;
    so[warp] = o;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      a &= sa[w];
      o |= so[w];
    }
    if (a != ~0ull) atomicAnd((u64*)&st[wa], a);
    if (o != 0ull) atomicOr((u64*)&st[wo], o);
  }
  __syncthreads();
}

// Count of digit d (in: the lane has one) into bins, a run of equal
// digits on consecutive lanes adding once (rows near each other in row
// order often share a digit).  Every lane calls it.
__device__ __forceinline__ void bin_add(unsigned* bins, unsigned d, bool in,
                                        int lane) {
  const unsigned key = in ? d : (0x80000000u | lane);
  const unsigned prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  if (in && ((heads >> lane) & 1u)) {
    const unsigned rest = lane == 31 ? 0u : heads >> (lane + 1);
    atomicAdd(&bins[d], rest ? (unsigned)__ffs(rest) : 32u - lane);
  }
}

__device__ void bins_zero(unsigned* bins) {
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) bins[b] = 0;
}

// The block's nonzero bins into the global ones (after __syncthreads).
__device__ void bins_flush(const unsigned* sh, unsigned* bins) {
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    if (sh[b] != 0) atomicAdd(&bins[b], sh[b]);
  }
}

// Block-aggregated appends to two lists, each warp's in lane order: every
// thread passes its flags for up to 32 items (bit u: item u goes to the
// list), all lanes of a warp the same items u; receives the slot of its
// first item of each list, later items following in (item, lane) order
// through `next_slot`.  One atomic a block and a list.
struct Slots {
  long long at[2];    // the warp's next slot in each list
  unsigned flags[2];  // this lane's flags
};

__device__ Slots block_slots(unsigned f_out, unsigned f_set, long long* st,
                             int set_word) {
  __shared__ unsigned cnt[2][32];
  __shared__ long long base[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned c0 = __popc(f_out), c1 = __popc(f_set);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c0 += __shfl_xor_sync(kFull, c0, off);
    c1 += __shfl_xor_sync(kFull, c1, off);
  }
  if (lane == 0) {
    cnt[0][warp] = c0;
    cnt[1][warp] = c1;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const int l = threadIdx.x;
    const int nw = blockDim.x >> 5;
    unsigned long long total = 0;
    for (int w = 0; w < nw; ++w) total += cnt[l][w];
    long long at = total ? (long long)atomicAdd(
                               (u64*)&st[l == 0 ? cOut : set_word], total)
                         : 0;
    for (int w = 0; w < nw; ++w) {
      base[l][w] = at;
      at += cnt[l][w];
    }
  }
  __syncthreads();
  return Slots{{base[0][warp], base[1][warp]}, {f_out, f_set}};
}

// The same for one warp: an atomic a list when the warp has items for it.
// Every lane calls it.  (In a pass over N most warps have none: no block
// barrier holds back the others' loads.)
__device__ Slots warp_slots(unsigned f_out, unsigned f_set, long long* st,
                            int set_word) {
  const int lane = threadIdx.x & 31;
  const unsigned c0 = __reduce_add_sync(kFull, (unsigned)__popc(f_out));
  const unsigned c1 = __reduce_add_sync(kFull, (unsigned)__popc(f_set));
  long long b0 = 0, b1 = 0;
  if (lane == 0) {
    if (c0) b0 = (long long)atomicAdd((u64*)&st[cOut], (u64)c0);
    if (c1) b1 = (long long)atomicAdd((u64*)&st[set_word], (u64)c1);
  }
  return Slots{{__shfl_sync(kFull, b0, 0), __shfl_sync(kFull, b1, 0)},
               {f_out, f_set}};
}

// The slot of item u in list l, or -1 when the lane's item does not go
// there.  Every lane of the warp calls it, for u in increasing order.
__device__ __forceinline__ long long next_slot(Slots& s, int l, int u,
                                               int lane) {
  const bool mine = (s.flags[l] >> u) & 1u;
  const unsigned b = __ballot_sync(kFull, mine);
  const long long at = s.at[l] + __popc(b & ((1u << lane) - 1u));
  s.at[l] += __popc(b);
  return mine ? at : -1;
}

// True in the last block of the launch to get here; every thread calls it.
__device__ bool last_block(long long* st) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd((u64*)&st[cTicket], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last != 0;
}

// The digit holding the want-th row of the set (1-based), from the global
// bins; the rows below it are taken.  Every thread of the block calls it;
// the bins are zeroed for the next histogram.
__device__ void pick(unsigned* bins, long long want, long long* st) {
  __shared__ unsigned sm[33];
  __shared__ long long found[3];
  const int per = kBins / blockDim.x;
  const int b0 = threadIdx.x * per;
  unsigned own = 0;
  for (int b = 0; b < per; ++b) own += __ldcg(&bins[b0 + b]);
  unsigned total;
  const unsigned ex = block_exclusive_scan<unsigned>(own, sm, total);
  if ((long long)ex < want && want <= (long long)ex + own) {
    long long cum = ex;
    for (int b = 0; b < per; ++b) {
      const unsigned h = __ldcg(&bins[b0 + b]);
      if (cum + h >= want) {
        found[0] = b0 + b;
        found[1] = h;
        found[2] = cum;
        break;
      }
      cum += h;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) bins[b] = 0;
  if (threadIdx.x == 0) {
    st[cPick] = found[0];
    st[cPickCnt] = found[1];
    st[cRem] = want - found[2];
    st[cFinal] = found[1] == want - found[2] ? 1 : 0;
    st[cAnd] = -1;  // the split keeps the AND / OR of the picked rows' key
    st[cOr] = 0;
    st[cPhase] = kSplit;
  }
}

// After a range (fresh = true: the current key's AND / OR are over the
// set) or a split of the set, the next phase: the next key's range when
// every candidate shares the current key, else a histogram of its next
// digit.  One thread.
__device__ void advance(long long* st, int nkeys) {
  const u64 a = (u64)vload(&st[cAnd]), o = (u64)vload(&st[cOr]);
  st[cAnd] = -1;
  st[cOr] = 0;
  if (a == o) {
    st[cKey] = st[cKey] + 1 <= nkeys ? st[cKey] + 1 : nkeys;
    st[cPhase] = kRange;
    return;
  }
  long long shift, width;
  digit_of(a, o, shift, width);
  st[cShift] = shift;
  st[cWidth] = width;
  st[cPhase] = kHist;
}

// ---- passes over N -------------------------------------------------------

// The first key's order keys of the warp tile's 16 rows j, loaded where
// want(live, exists) holds (else 0), and whether it held.  The 16 loads
// issue before any key is formed, so they are in flight together.
template <int T, typename Want>
__device__ __forceinline__ unsigned tile_keys(const void* p, int fl,
                                              unsigned bits, long long base,
                                              int lane, Want want,
                                              okey_t<T> (&kv)[16],
                                              unsigned& live16) {
  using V = typename Col<T>::type;
  const V* col = static_cast<const V*>(p);
  unsigned in = 0;
  live16 = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    bool live, exists;
    row_bits(bits, j, lane, live, exists);
    if (live) live16 |= 1u << j;
    if (want(live, exists)) in |= 1u << j;
  }
  V raw[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    raw[j] = (in >> j) & 1u ? col[base + 32LL * j + lane] : V(0);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    kv[j] = (in >> j) & 1u ? (okey_t<T>)order_key_of<T>(raw[j], fl) : 0;
  }
  return in;
}

// Blocks an SM: passes 1 and 2 (kHistThreads each, 64 registers a thread)
// and the split pass (kPassThreads; its grid takes kSplitPerSm an SM).
constexpr int kScanMinBlocks = 2;
constexpr int kSplitMinBlocks = 4;
constexpr int kSplitPerSm = 8;
constexpr int kSampleTiles = 1024;  // warp tiles of the sample, at most

__device__ __forceinline__ int top_bit(u64 x) {
  return x == 0 ? -1 : 63 - __clzll((long long)x);
}

// The sample: the AND / OR of the first key over the rows with the mask
// set in up to kSampleTiles warp tiles spread evenly over the table, and
// their count, into cSAnd / cSOr / cSLive.  Pass 1 histograms by the digit
// below the bits these rows share.
template <int T, int THREADS>
__device__ void sample_body(Desc ds, const uint8_t* mask, long long n,
                            long long* st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int warps = THREADS / 32;
  const long long total = (n + kTileRows - 1) / kTileRows;
  const long long tiles = total < kSampleTiles ? total : kSampleTiles;
  const void* p = ds.ptr(0);
  const int fl = ds.flags(0);
  u64 a = ~0ull, o = 0ull;
  unsigned cnt = 0;
  for (long long t = (long long)blockIdx.x * warps + warp; t < tiles;
       t += (long long)gridDim.x * warps) {  // warp-uniform
    const long long base = t * total / tiles * kTileRows;
    const unsigned bits = tile_bits(mask, n, base, lane);
    cnt += __popc(bits & 0xffffu);
    okey_t<T> kv[16];
    unsigned live16;
    const unsigned in = tile_keys<T>(
        p, fl, bits, base, lane, [](bool live, bool) { return live; }, kv,
        live16);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (in & (1u << j)) {
        a &= kv[j];
        o |= kv[j];
      }
    }
  }
  block_and_or(a, o, st, cSAnd, cSOr);
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, off);
  }
  if (lane == 0 && cnt != 0) atomicAdd((u64*)&st[cSLive], (u64)cnt);
}

// Pass 1: the rows with the mask set, counted (cLive), the AND / OR of
// their first key (cAnd / cOr, exact), and their histogram by the 11-bit
// digit below the bits the sample's rows share.  The last block keeps the
// histogram (cValid = 1) when it splits as the exact range's digit would:
// at least k rows set, and the exact range's top varying bit is the
// sample's (a sample's range lies within the exact one, so every row
// shares the bits above it; a digit whose low end lies above the exact
// range's is only coarser).  It then picks the digit that holds the k-th
// row, as hist0 does; else the bins are cleared and hist0 runs as pass 2.
template <int T, int THREADS>
__device__ void scan0_body(Desc ds, const uint8_t* mask, long long n,
                           long long* st, unsigned* bins, unsigned* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr long long block_rows = (long long)(THREADS / 32) * kTileRows;
  __shared__ int valid;
  const bool use = st[cSLive] > 0;  // block-uniform
  long long s = 0, w = 0;
  if (use) {
    digit_of((u64)st[cSAnd], (u64)st[cSOr], s, w);
    bins_zero(sh);
  }
  __syncthreads();
  const int shift = (int)s, width = (int)w;
  const void* p = ds.ptr(0);
  const int fl = ds.flags(0);
  u64 a = ~0ull, o = 0ull;
  unsigned cnt = 0;
  const long long stride = (long long)gridDim.x * block_rows;
  long long base = (long long)blockIdx.x * block_rows +
                   (long long)warp * kTileRows;
  unsigned bits = base < n ? tile_bits(mask, n, base, lane) : 0u;
  for (; base < n; base += stride) {  // warp-uniform
    cnt += __popc(bits & 0xffffu);
    okey_t<T> kv[16];
    unsigned live16;
    const unsigned in = tile_keys<T>(
        p, fl, bits, base, lane, [](bool live, bool) { return live; }, kv,
        live16);
    // the next tile's mask bytes load while these keys arrive
    bits = base + stride < n ? tile_bits(mask, n, base + stride, lane) : 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (in & (1u << j)) {
        a &= kv[j];
        o |= kv[j];
      }
      if (use) bin_add(sh, digit(kv[j], shift, width), (in >> j) & 1u, lane);
    }
  }
  block_and_or(a, o, st);
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, off);
  }
  if (lane == 0 && cnt != 0) atomicAdd((u64*)&st[cLive], (u64)cnt);
  if (use) bins_flush(sh, bins);
  if (!last_block(st)) return;
  if (threadIdx.x == 0) {
    const u64 xs = (u64)vload(&st[cSAnd]) ^ (u64)vload(&st[cSOr]);
    const u64 xe = (u64)vload(&st[cAnd]) ^ (u64)vload(&st[cOr]);
    valid = use && vload(&st[cLive]) >= st[cK] && top_bit(xs) == top_bit(xe);
    st[cValid] = valid;
    st[cTicket] = 0;
  }
  __syncthreads();
  if (!valid) {
    for (int b = threadIdx.x; b < kBins; b += blockDim.x) bins[b] = 0;
    return;
  }
  pick(bins, st[cK], st);
  if (threadIdx.x == 0) {
    st[cTarget] = 0;
    st[cShift] = shift;
    st[cWidth] = width;
    st[cKey] = 0;
  }
}

// The level-0 set and digit, the same in every block of a pass: target
// (0: mask set, 1: unset), the digit and the rows wanted from the set.
__device__ __forceinline__ void level0(const Desc& ds, const long long* st,
                                       long long n, int& target, int& shift,
                                       int& width, long long& want) {
  const long long k = st[cK], live = st[cLive];
  target = live >= k ? 0 : 1;
  want = target == 0 ? k : k - live;
  long long s, w;
  if (target == 0) {
    digit_of((u64)st[cAnd], (u64)st[cOr], s, w);
  } else {  // no range of the unset rows: the key's top bits
    const int bits = key_bits(ds.type(0));
    s = bits > kDigitBits ? bits - kDigitBits : 0;
    w = bits - s;
  }
  shift = (int)s;
  width = (int)w;
}

template <int T, int THREADS>
__device__ void hist0_body(Desc ds, const uint8_t* mask, long long n,
                           long long* st, unsigned* bins, unsigned* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr long long block_rows = (long long)(THREADS / 32) * kTileRows;
  int target, shift, width;
  long long want;
  level0(ds, st, n, target, shift, width, want);
  bins_zero(sh);
  __syncthreads();
  const void* p = ds.ptr(0);
  const int fl = ds.flags(0);
  const long long stride = (long long)gridDim.x * block_rows;
  long long base = (long long)blockIdx.x * block_rows +
                   (long long)warp * kTileRows;
  unsigned bits = base < n ? tile_bits(mask, n, base, lane) : 0u;
  for (; base < n; base += stride) {  // warp-uniform
    okey_t<T> kv[16];
    unsigned live16;
    const unsigned in = tile_keys<T>(
        p, fl, bits, base, lane,
        [target](bool live, bool exists) {
          return exists && live == (target == 0);
        },
        kv, live16);
    bits = base + stride < n ? tile_bits(mask, n, base + stride, lane) : 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bin_add(sh, digit(kv[j], shift, width), (in >> j) & 1u, lane);
    }
  }
  __syncthreads();
  bins_flush(sh, bins);
  if (!last_block(st)) return;
  pick(bins, want, st);
  if (threadIdx.x == 0) {
    st[cTarget] = target;
    st[cShift] = shift;
    st[cWidth] = width;
    st[cKey] = 0;
    st[cTicket] = 0;
  }
}

template <int T, int THREADS>
__device__ void split0_body(Desc ds, const uint8_t* mask, long long n,
                            long long* st, int32_t* out, int32_t* rows,
                            u64* keys) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr long long block_rows = (long long)(THREADS / 32) * kTileRows;
  const int target = (int)st[cTarget], shift = (int)st[cShift];
  const int width = (int)st[cWidth];
  const unsigned pk = (unsigned)st[cPick];
  const bool final_ = st[cFinal] != 0;
  const void* p = ds.ptr(0);
  const int fl = ds.flags(0);
  u64 a = ~0ull, o = 0ull;
  const long long stride = (long long)gridDim.x * block_rows;
  const long long first = (long long)blockIdx.x * block_rows +
                          (long long)warp * kTileRows;
  unsigned bits = first < n ? tile_bits(mask, n, first, lane) : 0u;
  for (long long b = (long long)blockIdx.x * block_rows; b < n;
       b += stride) {
    const long long base = b + (long long)warp * kTileRows;
    okey_t<T> kv[16];
    unsigned in = 0, live16 = 0, to_out = 0, to_set = 0;
    if (base < n) {  // warp-uniform
      in = tile_keys<T>(
          p, fl, bits, base, lane,
          [target](bool live, bool exists) {
            return exists && live == (target == 0);
          },
          kv, live16);
      bits = base + stride < n ? tile_bits(mask, n, base + stride, lane)
                               : 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (in & (1u << j)) {
          const unsigned d = digit(kv[j], shift, width);
          if (d < pk || (d == pk && final_)) {
            to_out |= 1u << j;
          } else if (d == pk) {
            to_set |= 1u << j;
            a &= kv[j];
            o |= kv[j];
          }
        } else if (target == 1 && (live16 & (1u << j))) {
          to_out |= 1u << j;  // a set row ahead of every unset one
        }
      }
    }
    if (base < n && __any_sync(kFull, to_out | to_set)) {
      Slots sl = warp_slots(to_out, to_set, st, cCnt0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long i = base + 32LL * j + lane;
        const long long at_out = next_slot(sl, 0, j, lane);
        const long long at_set = next_slot(sl, 1, j, lane);
        if (at_out >= 0) out[at_out] = (int32_t)i;
        if (at_set >= 0) {
          rows[at_set] = (int32_t)i;
          // read again (a cache hit): no key stays live across the appends
          keys[at_set] = order_key_t<T>(p, i, fl);
        }
      }
    }
  }
  block_and_or(a, o, st);
  if (!last_block(st)) return;
  if (threadIdx.x == 0) {
    st[cBuf] = 0;
    st[cTicket] = 0;
    if (final_) {
      st[cPhase] = kDone;
    } else {
      advance(st, ds.nkeys);
    }
  }
}

#define TOPK_DISPATCH(BODY, THREADS, ...)                \
  switch (ds.type(0)) {                                  \
    case kF32: BODY<kF32, THREADS>(__VA_ARGS__); break;  \
    case kF64: BODY<kF64, THREADS>(__VA_ARGS__); break;  \
    case kI64: BODY<kI64, THREADS>(__VA_ARGS__); break;  \
    case kI32: BODY<kI32, THREADS>(__VA_ARGS__); break;  \
    case kI16: BODY<kI16, THREADS>(__VA_ARGS__); break;  \
    case kI8: BODY<kI8, THREADS>(__VA_ARGS__); break;    \
    case kU8: BODY<kU8, THREADS>(__VA_ARGS__); break;    \
    case kU16: BODY<kU16, THREADS>(__VA_ARGS__); break;  \
    default: BODY<kU32, THREADS>(__VA_ARGS__); break;    \
  }

__global__ void __launch_bounds__(kPassThreads)
    topk_sample_kernel(Desc ds, const uint8_t* __restrict__ mask,
                       long long n, long long* st) {
  TOPK_DISPATCH(sample_body, kPassThreads, ds, mask, n, st)
}

__global__ void __launch_bounds__(kHistThreads, kScanMinBlocks)
    topk_scan0_kernel(Desc ds, const uint8_t* __restrict__ mask, long long n,
                      long long* st, unsigned* bins) {
  __shared__ unsigned sh[kBins];  // one for every instance of the body
  TOPK_DISPATCH(scan0_body, kHistThreads, ds, mask, n, st, bins, sh)
}

__global__ void __launch_bounds__(kHistThreads, 2)
    topk_hist0_kernel(Desc ds, const uint8_t* __restrict__ mask, long long n,
                      long long* st, unsigned* bins) {
  __shared__ unsigned sh[kBins];  // one for every instance of the body
  TOPK_DISPATCH(hist0_body, kHistThreads, ds, mask, n, st, bins, sh)
}

__global__ void __launch_bounds__(kPassThreads, kSplitMinBlocks)
    topk_split0_kernel(Desc ds, const uint8_t* __restrict__ mask,
                       long long n, long long* st, int32_t* out,
                       int32_t* rows, u64* keys) {
  TOPK_DISPATCH(split0_body, kPassThreads, ds, mask, n, st, out, rows, keys)
}

// ---- phases over the candidates ------------------------------------------

struct Bufs {
  int32_t* rows[2];
  u64* keys[2];
  int32_t* out;
};

// The candidates [0, c) of a range phase: their rows, and their keys
// written; block `first` / `stride` as in phase_body.
struct Gather {
  const int32_t* rows;
  u64* keys;
  long long c, first, stride;
};

// The order keys of key column p (type T; -1: the row index itself) at the
// candidates' rows into g.keys, and their AND / OR.  A thread's rows, then
// its kStepItems gathers, issue before any key is formed.
template <int T>
__device__ void gather_keys(const void* p, int fl, const Gather& g, u64& a,
                            u64& o) {
  using V = typename std::conditional<T < 0, int32_t,
                                      typename Col<(T < 0 ? 0 : T)>::type>::type;
  const V* col = static_cast<const V*>(p);
  for (long long e0 = g.first + threadIdx.x; e0 < g.c; e0 += g.stride) {
    int32_t r[kStepItems];
    V raw[kStepItems];
#pragma unroll
    for (int u = 0; u < kStepItems; ++u) {
      const long long e = e0 + (long long)u * blockDim.x;
      r[u] = e < g.c ? g.rows[e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kStepItems; ++u) {
      const long long e = e0 + (long long)u * blockDim.x;
      if constexpr (T >= 0) raw[u] = e < g.c ? col[r[u]] : V(0);
    }
#pragma unroll
    for (int u = 0; u < kStepItems; ++u) {
      const long long e = e0 + (long long)u * blockDim.x;
      if (e < g.c) {
        u64 x;
        if constexpr (T >= 0) {
          x = order_key_of<T>(raw[u], fl);
        } else {
          x = (u64)r[u];
        }
        g.keys[e] = x;
        a &= x;
        o |= x;
      }
    }
  }
}

// One phase's work over the set (buffer b, c candidates) by block bid of
// nb: range, histogram into `bins`, or split.
__device__ void phase_body(int phase, const Desc& ds, long long* st,
                           unsigned* bins, const Bufs& bf, int bid, int nb) {
  __shared__ unsigned sh[kBins];
  const int lane = threadIdx.x & 31;
  const int b = (int)st[cBuf];
  const long long c = st[cCnt0 + b];
  // (selects, not an index into the parameter: that would copy it to
  // local memory)
  const int32_t* rows = b ? bf.rows[1] : bf.rows[0];
  u64* keys = b ? bf.keys[1] : bf.keys[0];
  const long long stride = (long long)nb * blockDim.x * kStepItems;
  const long long first = (long long)bid * blockDim.x * kStepItems;
  if (phase == kRange) {
    const int j = (int)st[cKey];
    u64 a = ~0ull, o = 0ull;
    const Gather g{rows, keys, c, first, stride};
    if (j >= ds.nkeys) {
      gather_keys<-1>(nullptr, 0, g, a, o);  // the row index
    } else {
      const void* p = ds.ptr(j);
      const int fl = ds.flags(j);
      switch (ds.type(j)) {
        case kF32: gather_keys<kF32>(p, fl, g, a, o); break;
        case kF64: gather_keys<kF64>(p, fl, g, a, o); break;
        case kI64: gather_keys<kI64>(p, fl, g, a, o); break;
        case kI32: gather_keys<kI32>(p, fl, g, a, o); break;
        case kI16: gather_keys<kI16>(p, fl, g, a, o); break;
        case kI8: gather_keys<kI8>(p, fl, g, a, o); break;
        case kU8: gather_keys<kU8>(p, fl, g, a, o); break;
        case kU16: gather_keys<kU16>(p, fl, g, a, o); break;
        default: gather_keys<kU32>(p, fl, g, a, o); break;
      }
    }
    block_and_or(a, o, st);
  } else if (phase == kHist) {
    const int shift = (int)st[cShift], width = (int)st[cWidth];
    bins_zero(sh);
    __syncthreads();
    // warp-uniform bounds: the warp's first element decides
    const long long w0 = first + (threadIdx.x & ~31);
    for (long long e0 = w0; e0 < c; e0 += stride) {
      u64 kv[kStepItems];
#pragma unroll
      for (int u = 0; u < kStepItems; ++u) {
        const long long e = e0 + (long long)u * blockDim.x + lane;
        kv[u] = e < c ? keys[e] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kStepItems; ++u) {
        const long long e = e0 + (long long)u * blockDim.x + lane;
        bin_add(sh, digit(kv[u], shift, width), e < c, lane);
      }
    }
    __syncthreads();
    bins_flush(sh, bins);
  } else {  // kSplit
    const int shift = (int)st[cShift], width = (int)st[cWidth];
    const unsigned pk = (unsigned)st[cPick];
    const bool final_ = st[cFinal] != 0;
    int32_t* nrows = b ? bf.rows[0] : bf.rows[1];
    u64* nkeys = b ? bf.keys[0] : bf.keys[1];
    u64 a = ~0ull, o = 0ull;
    // block-uniform bounds (block_slots synchronizes the block)
    for (long long e0 = first; e0 < c; e0 += stride) {
      u64 kv[kStepItems];
      int32_t rv[kStepItems];
      unsigned to_out = 0, to_set = 0;
#pragma unroll
      for (int u = 0; u < kStepItems; ++u) {
        const long long e = e0 + (long long)u * blockDim.x + threadIdx.x;
        if (e < c) {
          kv[u] = keys[e];
          rv[u] = rows[e];
        }
      }
#pragma unroll
      for (int u = 0; u < kStepItems; ++u) {
        const long long e = e0 + (long long)u * blockDim.x + threadIdx.x;
        if (e < c) {
          const unsigned d = digit(kv[u], shift, width);
          if (d < pk || (d == pk && final_)) {
            to_out |= 1u << u;
          } else if (d == pk) {
            to_set |= 1u << u;
            a &= kv[u];
            o |= kv[u];
          }
        }
      }
      Slots sl = block_slots(to_out, to_set, st, cCnt0 + (b ^ 1));
      if (__any_sync(kFull, to_out | to_set)) {
#pragma unroll
        for (int u = 0; u < kStepItems; ++u) {
          const long long o = next_slot(sl, 0, u, lane);
          const long long e = next_slot(sl, 1, u, lane);
          if (o >= 0) bf.out[o] = rv[u];
          if (e >= 0) {
            nrows[e] = rv[u];
            nkeys[e] = kv[u];
          }
        }
      }
    }
    block_and_or(a, o, st);
  }
}

// The phase's end, by one block after every block's body: the pick, or the
// next phase.  Every thread calls it.
__device__ void phase_end(int phase, const Desc& ds, long long* st,
                          unsigned* bins) {
  if (phase == kHist) {
    pick(bins, st[cRem], st);
    return;
  }
  if (threadIdx.x != 0) return;
  if (phase == kSplit) {
    const int b = (int)st[cBuf];
    st[cBuf] = b ^ 1;
    st[cCnt0 + b] = 0;
    if (st[cFinal] != 0) {
      st[cPhase] = kDone;
      return;
    }
  }
  advance(st, ds.nkeys);
}

// A phase over many candidates; returns at once when the set is done or
// small enough for topk_finish.
__global__ void __launch_bounds__(kStepThreads, 4)
    topk_step_kernel(Desc ds, long long* st, unsigned* bins, Bufs bf,
                     long long finish_max) {
  const int phase = (int)vload(&st[cPhase]);
  if (phase == kDone) return;
  const int b = (int)vload(&st[cBuf]);
  if (vload(&st[cCnt0 + b]) <= finish_max) return;
  phase_body(phase, ds, st, bins, bf, blockIdx.x, gridDim.x);
  if (!last_block(st)) return;
  phase_end(phase, ds, st, bins);
  if (threadIdx.x == 0) st[cTicket] = 0;
}

// (class, keys..., row) order of two entries of the sort (pads last).
__device__ __forceinline__ bool sort_less(int a, int b, int m, int nkeys,
                                          const u64* kw, const uint8_t* cls,
                                          const uint32_t* row, int cap) {
  if (b >= m) return a < m;
  if (a >= m) return false;
  if (cls[a] != cls[b]) return cls[a] < cls[b];
  for (int j = 0; j < nkeys; ++j) {
    const u64 x = kw[j * cap + a], y = kw[j * cap + b];
    if (x != y) return x < y;
  }
  return row[a] < row[b];
}

// One block: the remaining phases, then (small) the sort of the output and
// the set by (class, keys..., row) into result[0, k), once they are at
// most `stop` (<= cap, the sort's capacity) rows.
__global__ void __launch_bounds__(kFinishThreads)
    topk_finish_kernel(Desc ds, const uint8_t* __restrict__ mask,
                       long long* st, unsigned* bins, Bufs bf, int small,
                       int cap, int stop, long long* __restrict__ result) {
  while (true) {
    __syncthreads();
    const int phase = (int)vload(&st[cPhase]);
    const int b = (int)vload(&st[cBuf]);
    const long long c = vload(&st[cCnt0 + b]);
    const long long o = vload(&st[cOut]);
    if (phase == kDone || (small && o + c <= stop)) break;
    phase_body(phase, ds, st, bins, bf, 0, 1);
    __syncthreads();
    __threadfence_block();
    phase_end(phase, ds, st, bins);
  }
  if (!small) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nk = ds.nkeys;
  u64* kw = reinterpret_cast<u64*>(smem);
  uint32_t* row = reinterpret_cast<uint32_t*>(kw + (size_t)nk * cap);
  uint16_t* idx = reinterpret_cast<uint16_t*>(row + cap);
  uint8_t* cls = reinterpret_cast<uint8_t*>(idx + cap);
  const int b = (int)vload(&st[cBuf]);
  const long long o = vload(&st[cOut]);
  const int m = (int)(o + vload(&st[cCnt0 + b]));
  const int32_t* set = b ? bf.rows[1] : bf.rows[0];
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  for (int e = threadIdx.x; e < p2; e += blockDim.x) {
    idx[e] = (uint16_t)e;
    if (e >= m) continue;
    const long long r = e < o ? bf.out[e] : set[e - o];
    row[e] = (uint32_t)r;
    cls[e] = mask[r] != 0 ? 0 : 1;
    for (int j = 0; j < nk; ++j) kw[j * cap + e] = order_key(ds, j, r);
  }
  __syncthreads();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p2 / 2; t += blockDim.x) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const int x = idx[lo], y = idx[hi];
        if (sort_less(y, x, m, nk, kw, cls, row, cap) == asc) {
          idx[lo] = (uint16_t)y;
          idx[hi] = (uint16_t)x;
        }
      }
      __syncthreads();
    }
  }
  const long long k = st[cK];
  for (int t = threadIdx.x; t < k; t += blockDim.x) result[t] = row[idx[t]];
}

// ---------------------------------------------------------------------------
// Rows route (overflow): 8-bit levels over N, then the row-order collect
// ---------------------------------------------------------------------------

// row classes after a level: still equal to the prefix, below it, above it
constexpr uint8_t kAlive = 0;
constexpr uint8_t kBelow = 1;
constexpr uint8_t kAbove = 2;

// state words of the rows route
constexpr int kRem = 0;     // rows still to take from those equal to prefix
constexpr int kDoneFlag = 1;  // 1 once the rows equal to the prefix all fit
constexpr int kLast = 2;    // the last level picked
constexpr int kCount = 3;   // rows with the mask set
constexpr int kPicked = 4;  // [levels]: the digit picked at each level

constexpr int kLevelBins = 256;

// The digit of row i at level l: the class, or a byte of an order key.
__device__ __forceinline__ unsigned level_digit(const Desc& ds,
                                                const uint8_t* mask, int l,
                                                long long i) {
  const int j = ds.lkey(l);
  if (j < 0) return mask[i] != 0 ? 0u : 1u;
  return (unsigned)((order_key(ds, j, i) >> ds.lshift(l)) & 0xffull);
}

__global__ void topk_init_kernel(long long* st, long long k) {
  st[kRem] = k;
  st[kDoneFlag] = 0;
  st[kLast] = -1;
  st[kCount] = 0;
}

// Level l: rows still equal to the prefix (cand; every row at level 0)
// first compare their level l-1 digit with the one picked there and leave
// for good when it differs; the rest count their level l digit.  The last
// block picks the level's digit.
__global__ void __launch_bounds__(kThreads)
    topk_hist_kernel(Desc ds, const uint8_t* __restrict__ mask, long long n,
                     int l, uint8_t* __restrict__ cand, long long* st,
                     unsigned* __restrict__ hist, unsigned* ticket) {
  __shared__ unsigned bins[kLevelBins];
  __shared__ int last;
  if (st[kDoneFlag] != 0) return;  // block-uniform
  for (int b = threadIdx.x; b < kLevelBins; b += blockDim.x) bins[b] = 0;
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
    const unsigned peers = __match_any_sync(kFull, dg >= 0 ? dg : -1 - lane);
    if (dg >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&bins[dg], __popc(peers));
    }
  }
  __syncthreads();
  unsigned* h = hist + (long long)l * kLevelBins;
  for (int b = threadIdx.x; b < kLevelBins; b += blockDim.x) {
    if (bins[b] != 0) atomicAdd(&h[b], bins[b]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  // the digit that holds the k_rem-th row still equal to the prefix; the
  // rows below it are taken; done once the rows equal to it all fit
  *ticket = 0;
  const long long want = st[kRem];
  long long cum = 0;
  int d = kLevelBins - 1;
  for (int b = 0; b < kLevelBins; ++b) {
    const long long c = __ldcg(&h[b]);
    if (cum + c >= want) {
      d = b;
      break;
    }
    cum += c;
  }
  st[kPicked + l] = d;
  st[kRem] = want - cum;
  st[kLast] = l;
  if ((long long)__ldcg(&h[d]) == want - cum) st[kDoneFlag] = 1;
  if (l == 0) st[kCount] = __ldcg(&h[0]);
}

// A row's class against the final prefix, as scan input: 1 below the
// prefix, 1 << 31 equal to it, 0 above.  Both counts stay below 2^31
// (n < 2^31), so their sum fits the 62 bits of the scan's status word.
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
    return c == kBelow ? 1LL : (c == kAlive ? (1LL << 31) : 0LL);
  }
};

// The scan's epilogue: a row below the prefix goes to (rows below before
// it) + min(equal rows before it, k_rem); an equal row with fewer than
// k_rem equal rows before it to (rows below before it) + (equal rows
// before it).  Row order throughout.
struct CollectOut {
  const long long* st;
  int32_t* sel;
  __device__ void operator()(long long i, long long run,
                             long long incl) const {
    const long long own = incl - run;  // exact: integer counts
    const long long below = run & 0x7fffffffLL;
    const long long equal = run >> 31;
    const long long rem = st[kRem];
    if (own == 1) {
      sel[below + (equal < rem ? equal : rem)] = (int32_t)i;
    } else if (own != 0 && equal < rem) {
      sel[below + equal] = (int32_t)i;
    }
  }
};

// ---------------------------------------------------------------------------
// Order of the chosen rows (both routes, k above the sort capacity)
// ---------------------------------------------------------------------------

// The sort words of chosen row s: 0 the class (0: mask set), 1 .. nkeys
// the order keys, nkeys + 1 the row.
__device__ __forceinline__ u64 chosen_word(const Desc& ds,
                                           const uint8_t* mask, long long i,
                                           int w) {
  if (w == 0) return mask[i] != 0 ? 0ull : 1ull;
  return order_key(ds, w - 1, i);  // w - 1 == nkeys: the row
}

// The AND and OR of every sort word over the k chosen rows.
__global__ void topk_span_kernel(Desc ds, const uint8_t* __restrict__ mask,
                                 const int32_t* __restrict__ sel, long long k,
                                 u64* acc) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int words = ds.nkeys + 2;
  const long long i = s < k ? sel[s] : 0;
  for (int w = 0; w < words; ++w) {
    u64 a = s < k ? chosen_word(ds, mask, i, w) : ~0ull;
    u64 o = s < k ? a : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a &= __shfl_xor_sync(kFull, a, off);
      o |= __shfl_xor_sync(kFull, o, off);
    }
    if ((threadIdx.x & 31) == 0 && (long long)(s - (threadIdx.x & 31)) < k) {
      atomicAnd(&acc[w], a);
      atomicOr(&acc[words + w], o);
    }
  }
}

// One composite key a chosen row in `nw` u64 words (word q at comp[q * k],
// word 0 the least significant): each sort word's varying bits [lo, lo +
// width), read from acc by every thread, packed from bit 0 up, the row's
// lowest and the class's highest.  The bits of a word outside its span are
// the same in every chosen row, so the composite's unsigned order is the
// (class, keys..., row) order.
__global__ void topk_pack_kernel(Desc ds, const uint8_t* __restrict__ mask,
                                 const int32_t* __restrict__ sel, long long k,
                                 const u64* __restrict__ acc, int nw,
                                 u64* __restrict__ comp) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= k) return;
  const long long i = sel[s];
  const int words = ds.nkeys + 2;
  for (int q = 0; q < nw; ++q) comp[q * k + s] = 0ull;
  int at = 0;
  for (int w = words - 1; w >= 0; --w) {
    const u64 x = acc[w] ^ acc[words + w];
    if (x == 0ull) continue;
    const int lo = __ffsll((long long)x) - 1;
    const int width = 64 - __clzll((long long)x) - lo;
    u64 f = chosen_word(ds, mask, i, w) >> lo;
    if (width < 64) f &= (1ull << width) - 1ull;
    const int q = at >> 6, r = at & 63;
    comp[q * k + s] |= f << r;
    if (r != 0 && r + width > 64) comp[(q + 1) * k + s] |= f >> (64 - r);
    at += width;
  }
}

// The 8 digit histograms of composite word blockIdx.y over the k rows,
// as radix_pass reads them: hist [nw][8][256].
__global__ void __launch_bounds__(kThreads)
    topk_comp_hist_kernel(const u64* __restrict__ comp, long long k,
                          unsigned* __restrict__ hist) {
  __shared__ unsigned sh[kRadixMaxPasses * kRadixBins];
  radix_hist_zero(sh, kRadixMaxPasses);
  __syncthreads();
  const u64* key = comp + (long long)blockIdx.y * k;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is warp-uniform, so every lane reaches the warp votes
  for (long long base = (long long)blockIdx.x * blockDim.x; base < k;
       base += stride) {
    const long long s = base + threadIdx.x;
    radix_hist_add(sh, s < k ? key[s] : 0ull, kRadixMaxPasses, s < k);
  }
  __syncthreads();
  radix_hist_flush(sh, hist + (long long)blockIdx.y * kRadixMaxPasses *
                              kRadixBins, kRadixMaxPasses);
}

// out[p] = word[idx[p]]: a composite word in the order the words below it
// left.
__global__ void topk_gather_word_kernel(const u64* __restrict__ word,
                                        const int32_t* __restrict__ idx,
                                        long long k, u64* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < k) out[p] = word[idx[p]];
}

// result[p] = sel[idx[p]] (idx null: sel as it is), as int64 rows.
__global__ void topk_result_kernel(const int32_t* __restrict__ sel,
                                   const int32_t* __restrict__ idx,
                                   long long k, long long* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < k) out[p] = sel[idx != nullptr ? idx[p] : p];
}

// Blocks of `threads` for a pass over n rows: at most `per_sm` an SM.
unsigned pass_grid(long long n, int threads, int per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long rows = (long long)(threads / 32) * kTileRows;
  const long long want = (n + rows - 1) / rows;
  const long long cap = (long long)sms * per_sm;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

extern "C" {

// Candidate route, first half: uploads `host` (the descriptors, `dwords`
// int64, then the state, cWords) into ws, zeroes the bins that follow it,
// runs the sample and pass 1 (and pass 2, hist0, when pass 1's histogram
// does not stand: cValid = 0 in the first copy) and copies the state back
// into `back`: the call's one host sync (two with pass 2).  1 <= k <= n.
int gt_topk_plan(const long long* host, int dwords, int nkeys, int levels,
                 long long* ws, const uint8_t* mask, long long n,
                 long long* back, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long k = host[dwords + cK];
  if (n <= 0 || k <= 0 || k > n) return (int)cudaErrorInvalidValue;
  const size_t up = sizeof(long long) * (dwords + cWords);
  if (int e = (int)cudaMemcpyAsync(ws, host, up, cudaMemcpyHostToDevice, s)) {
    return e;
  }
  long long* st = ws + dwords;
  unsigned* bins = (unsigned*)(st + cWords);
  if (int e = (int)cudaMemsetAsync(bins, 0, sizeof(unsigned) * kBins, s)) {
    return e;
  }
  const Desc ds{ws, nkeys, levels};
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const long long sampled = tiles < kSampleTiles ? tiles : kSampleTiles;
  const int warps = kPassThreads / 32;
  topk_sample_kernel<<<(unsigned)((sampled + warps - 1) / warps),
                       kPassThreads, 0, s>>>(ds, mask, n, st);
  if (int e = last_error()) return e;
  const unsigned grid = pass_grid(n, kHistThreads, kScanMinBlocks);
  topk_scan0_kernel<<<grid, kHistThreads, 0, s>>>(ds, mask, n, st, bins);
  if (int e = last_error()) return e;
  for (int pass = 1;; ++pass) {
    if (int e = (int)cudaMemcpyAsync(back, st, sizeof(long long) * cWords,
                                     cudaMemcpyDeviceToHost, s)) {
      return e;
    }
    if (int e = (int)cudaStreamSynchronize(s)) return e;
    if (back[cValid] != 0 || pass == 2) return 0;
    // the sample's digit did not stand: the histogram by the exact range
    topk_hist0_kernel<<<grid, kHistThreads, 0, s>>>(ds, mask, n, st, bins);
    if (int e = last_error()) return e;
  }
}

// Candidate route, second half: pass 3, `steps` phase launches of
// `step_grid` blocks over the candidates (rows0/1 int32 and keys0/1 u64
// [cap] each), then topk_finish.  out: [k] int32, the chosen rows.
// small: result [k] int64 receives the answer in order (the finish block
// refines to `stop` rows and sorts them: capacity `cap_sort` entries,
// `smem` bytes); else out holds the k rows unsorted.
int gt_topk_candidates(long long* ws, int dwords, int nkeys, int levels,
                       const uint8_t* mask, long long n, int32_t* rows0,
                       int32_t* rows1, long long* keys0, long long* keys1,
                       int32_t* out, int steps, int step_grid,
                       long long finish_max, int small, int cap_sort,
                       int stop, long long smem, long long* result,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Desc ds{ws, nkeys, levels};
  long long* st = ws + dwords;
  unsigned* bins = (unsigned*)(st + cWords);
  topk_split0_kernel<<<pass_grid(n, kPassThreads, kSplitPerSm),
                       kPassThreads, 0, s>>>(ds, mask, n, st, out, rows0,
                                             (u64*)keys0);
  if (int e = last_error()) return e;
  const Bufs bf{{rows0, rows1}, {(u64*)keys0, (u64*)keys1}, out};
  for (int i = 0; i < steps; ++i) {
    topk_step_kernel<<<step_grid, kStepThreads, 0, s>>>(ds, st, bins, bf,
                                                        finish_max);
    if (int e = last_error()) return e;
  }
  if (small) {
    if (int e = (int)cudaFuncSetAttribute(
            topk_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem)) {
      return e;
    }
  }
  topk_finish_kernel<<<1, kFinishThreads, small ? (size_t)smem : 0, s>>>(
      ds, mask, st, bins, bf, small, cap_sort, stop, result);
  return last_error();
}

// Rows route: the levels over N (`levels` of them, 8 bits each, from the
// descriptors in ws) and the collect.  cand: [n] uint8; hist: [levels,
// 256] uint32 and a ticket (zeroed here); rst: [4 + levels] int64;
// scratch: the scan's tile status; sel: [k] int32, the chosen rows in row
// order.
int gt_topk_rows(const long long* ws, int nkeys, int levels,
                 const uint8_t* mask, long long n, long long k,
                 uint8_t* cand, unsigned* hist, long long* rst,
                 void* scratch, int32_t* sel, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || k <= 0 || k > n) return (int)cudaErrorInvalidValue;
  const Desc ds{ws, nkeys, levels};
  if (int e = (int)cudaMemsetAsync(
          hist, 0, sizeof(unsigned) * (kLevelBins * levels + 1), s)) {
    return e;
  }
  unsigned* ticket = hist + kLevelBins * levels;
  topk_init_kernel<<<1, 1, 0, s>>>(rst, k);
  if (int e = last_error()) return e;
  const long long want = blocks_for(n);
  const unsigned grid = (unsigned)(want < 2048 ? want : 2048);
  for (int l = 0; l < levels; ++l) {
    topk_hist_kernel<<<grid, kThreads, 0, s>>>(ds, mask, n, l, cand, rst,
                                               hist, ticket);
    if (int e = last_error()) return e;
  }
  return launch_scan_with<long long, ClassSrc, CollectOut>(
      ClassSrc{ds, mask, cand, rst}, n, scratch, CollectOut{rst, sel}, s);
}

// The k chosen rows (sel: [k] int32, in any order) in key order, with no
// host sync: topk_span's AND / OR into acc [2 (nkeys + 2)], topk_pack's
// composite keys into comp [nw, k], their digit histograms into hist [nw,
// 8, 256], then stable radix passes over the composite's `bits` lowest
// bits (the widest it can be; a digit every row shares is a copy), the
// least significant word first.  keys: [2, k] u64 and idx: [2, k] int32
// of scratch; status: radix_pass's; result: [k] int64, the rows in order.
int gt_topk_order(const long long* ws, int nkeys, int levels,
                  const uint8_t* mask, const int32_t* sel, long long k,
                  int nw, int bits, long long* acc, long long* comp,
                  long long* keys, int32_t* idx, unsigned* hist,
                  unsigned long long* status, long long* result,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 0 || nw <= 0 || bits <= 0 || bits > 64 * nw) {
    return (int)cudaErrorInvalidValue;
  }
  const int words = nkeys + 2;
  if (int e = (int)cudaMemsetAsync(acc, 0xff, sizeof(long long) * words,
                                   s)) {
    return e;
  }
  if (int e = (int)cudaMemsetAsync(acc + words, 0, sizeof(long long) * words,
                                   s)) {
    return e;
  }
  if (int e = (int)cudaMemsetAsync(
          hist, 0, sizeof(unsigned) * nw * kRadixMaxPasses * kRadixBins, s)) {
    return e;
  }
  const Desc ds{ws, nkeys, levels};
  u64* cw = (u64*)comp;
  topk_span_kernel<<<blocks_for(k), kThreads, 0, s>>>(ds, mask, sel, k,
                                                      (u64*)acc);
  if (int e = last_error()) return e;
  topk_pack_kernel<<<blocks_for(k), kThreads, 0, s>>>(ds, mask, sel, k,
                                                      (const u64*)acc, nw, cw);
  if (int e = last_error()) return e;
  topk_comp_hist_kernel<<<dim3(radix_hist_grid(k), (unsigned)nw), kThreads, 0,
                          s>>>(cw, k, hist);
  if (int e = last_error()) return e;
  u64* kb[2] = {(u64*)keys, (u64*)keys + k};
  int32_t* ib[2] = {idx, idx + k};
  int cur = -1;  // the index buffer of the order so far (-1: rows 0..k-1)
  for (int w = 0; w < nw; ++w) {
    const int left = bits - 64 * w;
    const int passes = left >= 64 ? kRadixMaxPasses : (left + 7) / 8;
    const u64* kin = cw;
    if (w > 0) {
      topk_gather_word_kernel<<<blocks_for(k), kThreads, 0, s>>>(
          cw + (long long)w * k, ib[cur], k, kb[0]);
      if (int e = last_error()) return e;
      kin = kb[0];
    }
    for (int p = 0; p < passes; ++p) {
      u64* kout = p + 1 == passes ? nullptr : (kin == kb[0] ? kb[1] : kb[0]);
      const int next = cur < 0 ? 0 : cur ^ 1;
      const unsigned* h = hist + ((long long)w * kRadixMaxPasses + p) *
                                     kRadixBins;
      if (int e = radix_pass<u64>(kin, cur < 0 ? nullptr : ib[cur], k, 8 * p,
                                  h, status, kout, ib[next], s)) {
        return e;
      }
      cur = next;
      kin = kout;
    }
  }
  topk_result_kernel<<<blocks_for(k), kThreads, 0, s>>>(
      sel, cur < 0 ? nullptr : ib[cur], k, result);
  return last_error();
}

}  // extern "C"
