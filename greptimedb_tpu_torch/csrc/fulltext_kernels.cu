// Hand-written Hopper kernels of the full-text and LogQL paths.
//
// Built by greptimedb_tpu_torch/ops/fulltext_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libgreptime_fulltext.so
//        fulltext_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Each
// entry point launches on the caller's stream, allocates nothing (scratch
// comes from the wrapper) and returns cudaGetLastError() of its launches.
//
// fp_candidates (K16)
//   Replaces greptimedb_tpu/fulltext/resident.py:75 _candidate_kernel: for
//   every row of the [npad, W] fingerprint matrix (32-bit words), is
//   (fp & m) == m in every word for SOME of the k query masks [k, W]?
//   One thread a row; the k x W masks are staged in shared memory once per
//   block (read from global memory when they exceed 48 KB), the row is
//   read with 16-byte vector loads when W is a multiple of 4 and the
//   matrix 16-byte aligned, and the thread stops at the first alternative
//   that holds (an alternative stops at its first failing word).
//   Bound: bytes: the matrix read once (npad * W * 4) and one byte a row
//   written.
//
// logs_layout (K17)
//   Replaces greptimedb_tpu/fulltext/loki.py:101 _logs_layout: the masked
//   min / max of ts (sentinels I64_MAX and -(1 << 62); ts_min = 0 and
//   kp = 2 without a valid row), then key = tsid * kp + (ts - ts_min), or
//   I64_MAX where masked.  One grid-stride pass of 264 blocks reduces by
//   warp shuffles, then across the block's warps, and folds each block
//   with one 64-bit atomicMin / atomicMax (one atomic a warp, contended on
//   one address, took 0.11 ms at 2^20 rows on an H100 80GB HBM3 at
//   700 W); a second elementwise pass writes the keys and (thread 0) the
//   two scalars, which stay on the device.  Bound: bytes: ts, tsid and
//   mask read once, the keys written once (the two passes read ts and
//   mask twice).
//
// line_vals (K17)
//   Replaces greptimedb_tpu/fulltext/loki.py:115 _line_vals and :124
//   _byte_vals in one pass: ind = 1.0 where the row is live, its code >= 0
//   and verified[clamp(code)], else 0.0; vals = blen[clamp(code)] on those
//   rows when blen is given.  Bound: bytes: codes and mask read, one or two
//   f32 written a row (the gathers hit a vocabulary-sized table).
//
// row_match (K17)
//   Replaces greptimedb_tpu/fulltext/loki.py:131 _row_match: live AND
//   lo <= ts < hi AND code >= 0 AND verified[clamp(code)] AND tsid in sel.
//   Membership is a bitmap over [0, nbits) built from sel (-1 pads and
//   ids outside the bitmap set no bit) by two small launches before the
//   row pass; a tsid outside [0, nbits) scans sel, so the answer is exact
//   for any sel (unsorted, padded) without an [N, S] broadcast.
//   Bound: bytes: codes, mask, ts, tsid read, one byte a row written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kI64Max = 0x7fffffffffffffffLL;
constexpr long long kTsMaxInit = -(1LL << 62);
constexpr long long kSmemBytes = 48 * 1024;
// grid-stride reduction: two blocks an SM of the H100's 132
constexpr long long kReduceBlocks = 264;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

inline int last_error() { return (int)cudaGetLastError(); }

// ---------------------------------------------------------------------------
// fp_candidates
// ---------------------------------------------------------------------------

__global__ void fp_candidates_kernel(const uint32_t* __restrict__ fp,
                                     const uint32_t* __restrict__ masks,
                                     long long npad, int W, int k,
                                     int use_smem, int vec4,
                                     uint8_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const uint32_t* m = masks;
  if (use_smem) {
    for (int j = threadIdx.x; j < k * W; j += blockDim.x) smem[j] = masks[j];
    __syncthreads();
    m = smem;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const uint32_t* row = fp + i * W;
  bool hit = false;
  for (int a = 0; a < k && !hit; ++a) {
    const uint32_t* q = m + a * W;
    bool ok = true;
    if (vec4) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
      for (int w = 0; w < W / 4 && ok; ++w) {
        const uint4 v = __ldg(r4 + w);
        const uint32_t q0 = q[4 * w], q1 = q[4 * w + 1], q2 = q[4 * w + 2],
                       q3 = q[4 * w + 3];
        ok = ((v.x & q0) == q0) && ((v.y & q1) == q1) && ((v.z & q2) == q2) &&
             ((v.w & q3) == q3);
      }
    } else {
      for (int w = 0; w < W && ok; ++w) {
        const uint32_t v = __ldg(row + w);
        ok = (v & q[w]) == q[w];
      }
    }
    hit = ok;
  }
  out[i] = hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// logs_layout
// ---------------------------------------------------------------------------

__global__ void logs_init_kernel(long long* acc) {
  acc[0] = kI64Max;
  acc[1] = kTsMaxInit;
  acc[2] = 0;
}

__device__ inline void warp_minmax(long long& lo, long long& hi,
                                   long long& any) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long olo = __shfl_down_sync(0xffffffffu, lo, off);
    const long long ohi = __shfl_down_sync(0xffffffffu, hi, off);
    const long long oan = __shfl_down_sync(0xffffffffu, any, off);
    lo = olo < lo ? olo : lo;
    hi = ohi > hi ? ohi : hi;
    any = oan > any ? oan : any;
  }
}

__global__ void logs_minmax_kernel(const long long* __restrict__ ts,
                                   const uint8_t* __restrict__ mask,
                                   long long n, long long* acc) {
  __shared__ long long s_lo[32], s_hi[32], s_any[32];
  long long lo = kI64Max, hi = kTsMaxInit, any = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (mask[i] != 0) {
      const long long t = ts[i];
      lo = t < lo ? t : lo;
      hi = t > hi ? t : hi;
      any = 1;
    }
  }
  // warps, then the block's warps in warp 0: one set of atomics a block
  warp_minmax(lo, hi, any);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_any[warp] = any;
  }
  __syncthreads();
  if (warp != 0) return;
  const int nw = blockDim.x >> 5;
  lo = lane < nw ? s_lo[lane] : kI64Max;
  hi = lane < nw ? s_hi[lane] : kTsMaxInit;
  any = lane < nw ? s_any[lane] : 0;
  warp_minmax(lo, hi, any);
  if (lane == 0 && any) {
    atomicMin(&acc[0], lo);
    atomicMax(&acc[1], hi);
    atomicMax(&acc[2], any);
  }
}

__global__ void logs_key_kernel(const long long* __restrict__ ts,
                                const int32_t* __restrict__ tsid,
                                const uint8_t* __restrict__ mask, long long n,
                                const long long* __restrict__ acc,
                                long long* __restrict__ key,
                                long long* ts_min_out, long long* kp_out) {
  const bool any = acc[2] != 0;
  const long long ts_min = any ? acc[0] : 0;
  const long long ts_max = any ? acc[1] : 0;
  const long long kp = ts_max - ts_min + 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    *ts_min_out = ts_min;
    *kp_out = kp;
  }
  if (i >= n) return;
  // two's-complement wraparound, as the reference's int64 arithmetic
  const unsigned long long k =
      (unsigned long long)(long long)tsid[i] * (unsigned long long)kp +
      ((unsigned long long)ts[i] - (unsigned long long)ts_min);
  key[i] = mask[i] != 0 ? (long long)k : kI64Max;
}

// ---------------------------------------------------------------------------
// line_vals
// ---------------------------------------------------------------------------

__global__ void line_vals_kernel(const int32_t* __restrict__ codes,
                                 const uint8_t* __restrict__ verified,
                                 long long npad,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ blen, long long n,
                                 float* __restrict__ ind,
                                 float* __restrict__ vals) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t c = codes[i];
  const long long safe = c < 0 ? 0 : (c >= npad ? npad - 1 : c);
  const bool ok = mask[i] != 0 && c >= 0 && verified[safe] != 0;
  ind[i] = ok ? 1.0f : 0.0f;
  if (vals != nullptr) vals[i] = ok ? blen[safe] : 0.0f;
}

// ---------------------------------------------------------------------------
// row_match
// ---------------------------------------------------------------------------

__global__ void bitmap_zero_kernel(uint32_t* bitmap, long long words) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < words) bitmap[i] = 0u;
}

__global__ void bitmap_set_kernel(const int32_t* __restrict__ sel, long long S,
                                  long long nbits, uint32_t* bitmap) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  const long long t = sel[i];
  if (t >= 0 && t < nbits) atomicOr(&bitmap[t >> 5], 1u << (t & 31));
}

__global__ void row_match_kernel(
    const int32_t* __restrict__ codes, const uint8_t* __restrict__ verified,
    long long npad, const uint8_t* __restrict__ mask,
    const long long* __restrict__ ts, const int32_t* __restrict__ tsid,
    const int32_t* __restrict__ sel, long long S,
    const uint32_t* __restrict__ bitmap, long long nbits, long long lo,
    long long hi, long long n, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t c = codes[i];
  const long long t = ts[i];
  const long long safe = c < 0 ? 0 : (c >= npad ? npad - 1 : c);
  bool ok = mask[i] != 0 && t >= lo && t < hi && c >= 0 &&
            verified[safe] != 0;
  if (ok) {
    const long long s = tsid[i];
    if (s >= 0 && s < nbits) {
      ok = (bitmap[s >> 5] >> (s & 31)) & 1u;
    } else {
      bool found = false;
      for (long long j = 0; j < S && !found; ++j) found = sel[j] == s;
      ok = found;
    }
  }
  out[i] = ok ? 1 : 0;
}

}  // namespace

extern "C" {

// fp [npad, W] and masks [k, W] 32-bit words; out [npad] bytes (bool).
int gt_fp_candidates(const uint32_t* fp, const uint32_t* masks, long long npad,
                     int W, int k, int vec4, uint8_t* out, void* stream) {
  if (W <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (npad <= 0) return last_error();
  const long long mbytes = (long long)k * W * 4;
  const int use_smem = mbytes <= kSmemBytes ? 1 : 0;
  fp_candidates_kernel<<<blocks_for(npad), kThreads,
                         use_smem ? (size_t)mbytes : 0,
                         (cudaStream_t)stream>>>(fp, masks, npad, W, k,
                                                 use_smem, vec4, out);
  return last_error();
}

// ts [n] int64, tsid [n] int32, mask [n] bool; acc [3] int64 scratch;
// key [n] int64, ts_min / kp one int64 each.
int gt_logs_layout(const long long* ts, const int32_t* tsid,
                   const uint8_t* mask, long long n, long long* acc,
                   long long* key, long long* ts_min, long long* kp,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  logs_init_kernel<<<1, 1, 0, st>>>(acc);
  if (int e = last_error()) return e;
  if (n > 0) {
    const long long want = blocks_for(n);
    const unsigned grid =
        (unsigned)(want < kReduceBlocks ? want : kReduceBlocks);
    logs_minmax_kernel<<<grid, kThreads, 0, st>>>(ts, mask, n, acc);
    if (int e = last_error()) return e;
  }
  logs_key_kernel<<<blocks_for(n > 0 ? n : 1), kThreads, 0, st>>>(
      ts, tsid, mask, n, acc, key, ts_min, kp);
  return last_error();
}

// codes [n] int32, verified [npad] bool, mask [n] bool, blen [npad] f32 or
// null; ind [n] f32, vals [n] f32 or null (with blen).
int gt_line_vals(const int32_t* codes, const uint8_t* verified,
                 long long npad, const uint8_t* mask, const float* blen,
                 long long n, float* ind, float* vals, void* stream) {
  if (npad <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return last_error();
  line_vals_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      codes, verified, npad, mask, blen, n, ind, vals);
  return last_error();
}

// as line_vals, plus ts [n] int64, tsid [n] int32, sel [S] int32 (any
// order, -1 pads); bitmap [(nbits + 31) / 32] 32-bit scratch; out [n] bool.
int gt_row_match(const int32_t* codes, const uint8_t* verified,
                 long long npad, const uint8_t* mask, const long long* ts,
                 const int32_t* tsid, const int32_t* sel, long long S,
                 uint32_t* bitmap, long long nbits, long long lo,
                 long long hi, long long n, uint8_t* out, void* stream) {
  if (npad <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long words = (nbits + 31) / 32;
  if (words > 0) {
    bitmap_zero_kernel<<<blocks_for(words), kThreads, 0, st>>>(bitmap, words);
    if (int e = last_error()) return e;
    if (S > 0) {
      bitmap_set_kernel<<<blocks_for(S), kThreads, 0, st>>>(sel, S, nbits,
                                                           bitmap);
      if (int e = last_error()) return e;
    }
  }
  if (n <= 0) return last_error();
  row_match_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      codes, verified, npad, mask, ts, tsid, sel, S, bitmap, nbits, lo, hi,
      n, out);
  return last_error();
}

}  // extern "C"
