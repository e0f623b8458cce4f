// Hand-written Hopper kernels of the SQL dense-grid aggregation path.
//
// Built by greptimedb_tpu_torch/ops/grid_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libgreptime_grid.so grid_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so a refused launch surfaces in the wrapper.
//
// bucket_reduce
//   Replaces the jitted bucket reductions of the JAX reference:
//   greptimedb_tpu/query/physical.py:1129 (_bucket_major_partials.build_fn,
//   `reshape(..., nb, r) @ ones[r]`) and the bdot/breduce reductions inside
//   physical.py:1255 (_build_grid_kernel.kernel).
//   out[p, s, b] = op over j in [0, r) of x[p, s, t] with t = b*r + j - pad_l,
//   where t outside [0, w_raw) is padding (the op's identity), a cell is live
//   when mask[s, t] (if given) and, with skip_nan, x is not NaN; weight[t]
//   multiplies sums/counts and a zero weight drops the cell from min/max.
//   Identities: sum/count 0, min +inf, max -inf (breduce's fills).
//   Summation order (fixed, run to run): lane l of the warp that owns bucket
//   b accumulates j = l, l+32, l+64, ... in ascending order into an f32
//   register; the 32 lane partials then combine by __shfl_down_sync with
//   offsets 16, 8, 4, 2, 1 and lane 0 stores.  min/max propagate NaN like
//   jnp.min/jnp.max.
//   Bound: bytes.  Each input element is read once and each output written
//   once; at the TSBS main path (C=10, Spad=4096, Tpad=10240, r=360) that is
//   ~1.72 GB, ~0.51 ms at the H100 SXM data-sheet 3.35 TB/s.  Design: one
//   block per (p, s) row, warps over buckets, lanes over consecutive time
//   steps, so every warp load is one coalesced 128-byte line of the
//   contiguous time axis; no shared memory, no atomics.  Tiling, TMA and
//   wider loads are left to later work.
//
// group_merge
//   Replaces the series->group merge `gseg` (jax.ops.segment_sum/min/max
//   over [S, NB] into ngt+1 segments, the overflow segment dropped) of
//   physical.py:1176 (_bm_kernel_fn.kernel) and physical.py:1255.
//   out[p, g, b] = op over the series of group g (CSR `order`/`offsets`,
//   built once per (grid, GROUP BY) by a stable sort of the group ids, so
//   each group's series come in ascending series order — the order the
//   reference's CPU segment_sum adds them) of x[p, s, b] (times factor[s]
//   for sums; a zero factor drops the series from min/max).  Deterministic:
//   one thread owns one output, no atomics.  Empty groups give the
//   identity (0, +inf, -inf).
//   Bound: at the TSBS shape the merge reads ~2.2 MB, so it is
//   launch-bound; the design keeps it to one launch per call.
//
// group_merge_stacked
//   Replaces the stacked dispatch of the reference: physical.py:979
//   (execute_grid_batch, jax.jit(jax.vmap(_bm_kernel_fn(...).kernel)) over
//   each member's window start b_lo and, for tag-filtered members, its
//   per-series mask row).  For member m of npad (the pow2-padded batch):
//     b0      = clamp_start(b_lo[m], nbw, NB)   (JAX dynamic-slice clamp)
//     cnt[m, g, b]    = sum over group g's series s of
//                       (int64)(cnts[s, b0 + b] * mask[m, s])
//     out[m, p, g, b] = sum over group g's series s of
//                       sums[planes[p], s, b0 + b] * mask[m, s]
//   (no mask: the factor is dropped, as in the unfiltered solo kernel).
//   Each output element is one thread running group_merge_kernel's loop:
//   the same CSR order (ascending series within a group), the same f32
//   accumulator and the same expressions, so every member equals its solo
//   bm run (one int64 and one f32 group_merge launch) bit for bit.  A
//   masked series is never skipped: NaN or inf times 0 stays NaN in both.
//   The window is read in place (no narrow copy).  Two launches per batch,
//   whatever its size: counts, then sums.
//   Bound: bytes.  The batch reads the union of its members' windows of
//   the used planes and counts once, the mask stack and the layout, and
//   writes npad * (P * 4 + 8) * ngt * nbw bytes; at the TSBS serving shape
//   (P=10, S=4096, 12 of 24 buckets, npad=16, ngt=4096) that is ~42 MB,
//   ~0.013 ms at 3.35 TB/s.  Simple first: one thread per output, the
//   series gathers of a group are strided by NB floats.
//
// series_mask
//   Replaces physical.py:1008 (_series_mask, jitted at :1023): a batch
//   member's tag-only WHERE evaluated over the grid's tag codes,
//   broadcast_to(where_fn(env), (spad,)).astype(f32).  A tag-only
//   predicate's truth depends only on the codes of the tags it names, so
//   the host evaluates it once (its compiled torch form, on the CPU) over
//   the product of the code ranges [-1, card_t) into a 0/1 u8 table; the
//   kernel gathers, for every member and series at once,
//     mask[m, s] = lut[off[m'] + sum_t (codes[t, s] + 1) * stride[m', t]]
//   with m' = m for real members and 0 (the leader) for pow2 pad rows.
//   Grid codes lie in [-1, card_t) (the grid is built from the region's
//   encoders, which only grow, and pads are -1); an index outside the
//   table is clamped into it rather than read out of bounds.
//   Bound: bytes (T * spad * 4 read, npad * spad * 4 written, the tables
//   gathered through L1/L2).  One launch per batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Op { OP_SUM = 0, OP_COUNT = 1, OP_MIN = 2, OP_MAX = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) { return v ? 1.0f : 0.0f; }

__device__ __forceinline__ float identity_of(int op) {
  return op == OP_MIN ? INFINITY : (op == OP_MAX ? -INFINITY : 0.0f);
}

// NaN-propagating min/max (jnp semantics): once NaN, stays NaN.
__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == OP_MIN) return (isnan(a) || a < b) ? a : b;
  if (op == OP_MAX) return (isnan(a) || a > b) ? a : b;
  return a + b;
}

template <typename T>
__global__ void bucket_reduce_kernel(
    const T* __restrict__ x, long long x_sp, long long x_ss,
    const uint8_t* __restrict__ mask, long long m_ss,
    const float* __restrict__ weight, float* __restrict__ out,
    int S, int w_raw, int pad_l, int r, int nb, int op, int skip_nan) {
  const long long row = blockIdx.x;  // p * S + s
  const long long p = row / S;
  const long long s = row - p * S;
  const T* xr = x + p * x_sp + s * x_ss;
  const uint8_t* mr = mask != nullptr ? mask + s * m_ss : nullptr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float ident = identity_of(op);
  for (int b = warp; b < nb; b += nwarps) {
    float acc = ident;
    const int t0 = b * r - pad_l;
    for (int j = lane; j < r; j += 32) {
      const int t = t0 + j;
      if (t < 0 || t >= w_raw) continue;  // padding: the identity
      const float v = to_f32(xr[t]);
      const bool live = (mr == nullptr || mr[t] != 0) &&
                        !(skip_nan && isnan(v));
      const float w = weight != nullptr ? weight[t] : 1.0f;
      if (op == OP_SUM) {
        if (live) acc += v * w;
      } else if (op == OP_COUNT) {
        if (live) acc += w;
      } else if (live && w != 0.0f) {
        acc = combine(op, acc, v);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float other = __shfl_down_sync(0xffffffffu, acc, off);
      acc = (op == OP_SUM || op == OP_COUNT) ? acc + other
                                             : combine(op, acc, other);
    }
    if (lane == 0) out[row * nb + b] = acc;
  }
}

template <typename T>
__global__ void group_merge_kernel(
    const T* __restrict__ x, long long x_sp, long long x_ss,
    const int32_t* __restrict__ order, const int64_t* __restrict__ offsets,
    const float* __restrict__ factor, T* __restrict__ out,
    int P, int ngt, int nb, int op) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)P * ngt * nb;
  if (i >= total) return;
  const long long b = i % nb;
  const long long pg = i / nb;
  const long long g = pg % ngt;
  const long long p = pg / ngt;
  const T* xp = x + p * x_sp + b;
  const long long k0 = offsets[g];
  const long long k1 = offsets[g + 1];
  if constexpr (std::is_integral<T>::value) {
    T acc = 0;  // integer counts: sum only
    for (long long k = k0; k < k1; ++k) acc += xp[(long long)order[k] * x_ss];
    out[i] = acc;
  } else {
    float acc = identity_of(op);
    for (long long k = k0; k < k1; ++k) {
      const long long s = order[k];
      const float v = xp[s * x_ss];
      if (op == OP_SUM) {
        acc += factor != nullptr ? v * factor[s] : v;
      } else if (factor == nullptr || factor[s] != 0.0f) {
        acc = combine(op, acc, v);
      }
    }
    out[i] = acc;
  }
}

// jax.lax.dynamic_slice_in_dim's start: negative counts from the end,
// then clamps so the slice fits (ops/grid_kernels.py clamp_start).
__device__ __forceinline__ long long clamp_start_dev(long long start,
                                                     long long width,
                                                     long long size) {
  if (start < 0) start += size;
  long long hi = size - width;
  if (hi < 0) hi = 0;
  return start < 0 ? 0 : (start > hi ? hi : start);
}

__global__ void stacked_count_kernel(
    const float* __restrict__ cnts, long long c_ss,
    const int32_t* __restrict__ b_lo, const int32_t* __restrict__ order,
    const int64_t* __restrict__ offsets, const float* __restrict__ mask,
    long long m_ms, int64_t* __restrict__ out, int npad, int ngt, int nbw,
    int nb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)npad * ngt * nbw;
  if (i >= total) return;
  const long long b = i % nbw;
  const long long mg = i / nbw;
  const long long g = mg % ngt;
  const long long m = mg / ngt;
  const long long b0 = clamp_start_dev(b_lo[m], nbw, nb);
  const float* cp = cnts + b0 + b;
  const float* mrow = mask != nullptr ? mask + m * m_ms : nullptr;
  const long long k0 = offsets[g];
  const long long k1 = offsets[g + 1];
  int64_t acc = 0;
  for (long long k = k0; k < k1; ++k) {
    const long long s = order[k];
    float c = cp[s * c_ss];
    if (mrow != nullptr) c = c * mrow[s];
    acc += (int64_t)c;  // the solo path's .to(int64): truncation
  }
  out[i] = acc;
}

__global__ void stacked_sum_kernel(
    const float* __restrict__ sums, long long s_sc, long long s_ss,
    const int32_t* __restrict__ planes, const int32_t* __restrict__ b_lo,
    const int32_t* __restrict__ order, const int64_t* __restrict__ offsets,
    const float* __restrict__ mask, long long m_ms, float* __restrict__ out,
    int npad, int P, int ngt, int nbw, int nb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)npad * P * ngt * nbw;
  if (i >= total) return;
  const long long b = i % nbw;
  long long rest = i / nbw;
  const long long g = rest % ngt;
  rest /= ngt;
  const long long p = rest % P;
  const long long m = rest / P;
  const long long b0 = clamp_start_dev(b_lo[m], nbw, nb);
  const float* xp = sums + (long long)planes[p] * s_sc + b0 + b;
  const float* mrow = mask != nullptr ? mask + m * m_ms : nullptr;
  const long long k0 = offsets[g];
  const long long k1 = offsets[g + 1];
  float acc = identity_of(OP_SUM);
  for (long long k = k0; k < k1; ++k) {
    const long long s = order[k];
    const float v = xp[s * s_ss];
    acc += mrow != nullptr ? v * mrow[s] : v;  // group_merge_kernel's sum
  }
  out[i] = acc;
}

__global__ void series_mask_kernel(
    const int32_t* __restrict__ codes, long long codes_st, int T, int spad,
    const uint8_t* __restrict__ lut, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ strides, const int32_t* __restrict__ extents,
    int n, float* __restrict__ out, int npad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)npad * spad;
  if (i >= total) return;
  const long long s = i % spad;
  const long long m = i / spad;
  const long long mm = m < n ? m : 0;  // pad rows: the leader's twin
  long long idx = offsets[mm];
  for (int t = 0; t < T; ++t) {
    int c = codes[(long long)t * codes_st + s] + 1;
    const int e = extents[t];
    c = c < 0 ? 0 : (c >= e ? e - 1 : c);
    idx += (long long)c * strides[mm * T + t];
  }
  out[i] = lut[idx] != 0 ? 1.0f : 0.0f;
}

constexpr int kReduceThreads = 256;
constexpr int kMergeThreads = 256;

template <typename T>
int launch_bucket_reduce(const T* x, long long x_sp, long long x_ss,
                         const uint8_t* mask, long long m_ss,
                         const float* weight, float* out, int P, int S,
                         int w_raw, int pad_l, int r, int nb, int op,
                         int skip_nan, void* stream) {
  const long long rows = (long long)P * S;
  if (rows > 0 && nb > 0) {
    bucket_reduce_kernel<T><<<(unsigned)rows, kReduceThreads, 0,
                               (cudaStream_t)stream>>>(
        x, x_sp, x_ss, mask, m_ss, weight, out, S, w_raw, pad_l, r, nb, op,
        skip_nan);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group_merge(const T* x, long long x_sp, long long x_ss,
                       const int32_t* order, const int64_t* offsets,
                       const float* factor, T* out, int P, int ngt, int nb,
                       int op, void* stream) {
  const long long total = (long long)P * ngt * nb;
  if (total > 0) {
    const unsigned blocks =
        (unsigned)((total + kMergeThreads - 1) / kMergeThreads);
    group_merge_kernel<T><<<blocks, kMergeThreads, 0, (cudaStream_t)stream>>>(
        x, x_sp, x_ss, order, offsets, factor, out, P, ngt, nb, op);
  }
  return (int)cudaGetLastError();
}

inline unsigned blocks_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

extern "C" {

int gt_bucket_reduce_f32(const float* x, long long x_sp, long long x_ss,
                         const uint8_t* mask, long long m_ss,
                         const float* weight, float* out, int P, int S,
                         int w_raw, int pad_l, int r, int nb, int op,
                         int skip_nan, void* stream) {
  return launch_bucket_reduce<float>(x, x_sp, x_ss, mask, m_ss, weight, out,
                                     P, S, w_raw, pad_l, r, nb, op, skip_nan,
                                     stream);
}

int gt_bucket_reduce_u8(const uint8_t* x, long long x_sp, long long x_ss,
                        const uint8_t* mask, long long m_ss,
                        const float* weight, float* out, int P, int S,
                        int w_raw, int pad_l, int r, int nb, int op,
                        int skip_nan, void* stream) {
  return launch_bucket_reduce<uint8_t>(x, x_sp, x_ss, mask, m_ss, weight,
                                       out, P, S, w_raw, pad_l, r, nb, op,
                                       skip_nan, stream);
}

int gt_group_merge_f32(const float* x, long long x_sp, long long x_ss,
                       const int32_t* order, const int64_t* offsets,
                       const float* factor, float* out, int P, int ngt,
                       int nb, int op, void* stream) {
  return launch_group_merge<float>(x, x_sp, x_ss, order, offsets, factor, out,
                                   P, ngt, nb, op, stream);
}

int gt_group_merge_i64(const int64_t* x, long long x_sp, long long x_ss,
                       const int32_t* order, const int64_t* offsets,
                       int64_t* out, int P, int ngt, int nb, void* stream) {
  return launch_group_merge<int64_t>(x, x_sp, x_ss, order, offsets, nullptr,
                                     out, P, ngt, nb, OP_SUM, stream);
}

int gt_group_merge_stacked_count(const float* cnts, long long c_ss,
                                 const int32_t* b_lo, const int32_t* order,
                                 const int64_t* offsets, const float* mask,
                                 long long m_ms, int64_t* out, int npad,
                                 int ngt, int nbw, int nb, void* stream) {
  const long long total = (long long)npad * ngt * nbw;
  if (total > 0) {
    stacked_count_kernel<<<blocks_for(total, kMergeThreads), kMergeThreads, 0,
                           (cudaStream_t)stream>>>(
        cnts, c_ss, b_lo, order, offsets, mask, m_ms, out, npad, ngt, nbw,
        nb);
  }
  return (int)cudaGetLastError();
}

int gt_group_merge_stacked_sum(const float* sums, long long s_sc,
                               long long s_ss, const int32_t* planes,
                               const int32_t* b_lo, const int32_t* order,
                               const int64_t* offsets, const float* mask,
                               long long m_ms, float* out, int npad, int P,
                               int ngt, int nbw, int nb, void* stream) {
  const long long total = (long long)npad * P * ngt * nbw;
  if (total > 0) {
    stacked_sum_kernel<<<blocks_for(total, kMergeThreads), kMergeThreads, 0,
                         (cudaStream_t)stream>>>(
        sums, s_sc, s_ss, planes, b_lo, order, offsets, mask, m_ms, out, npad,
        P, ngt, nbw, nb);
  }
  return (int)cudaGetLastError();
}

int gt_series_mask(const int32_t* codes, long long codes_st, int T, int spad,
                   const uint8_t* lut, const int32_t* offsets,
                   const int32_t* strides, const int32_t* extents, int n,
                   float* out, int npad, void* stream) {
  const long long total = (long long)npad * spad;
  if (total > 0) {
    series_mask_kernel<<<blocks_for(total, kMergeThreads), kMergeThreads, 0,
                         (cudaStream_t)stream>>>(
        codes, codes_st, T, spad, lut, offsets, strides, extents, n, out,
        npad);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
