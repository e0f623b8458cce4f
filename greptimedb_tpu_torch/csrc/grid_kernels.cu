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
//   Bound: bytes.  Each input element is read once and each output written
//   once; at the TSBS main path (C=10, Spad=4096, Tpad=10240, r=360) that is
//   ~1.68 GB, ~0.50 ms at the H100 SXM data-sheet 3.35 TB/s.
//   Design: a streaming reduction.  A task is one (row, bucket); a group of
//   G lanes (G a power of two, G = bucket_lanes(r, itemsize) in the
//   wrapper: enough lanes that each issues about kReduceUnroll vectors)
//   owns one task, a warp 32 / G tasks, and warps walk the tasks in
//   (s, p, b) order with a grid stride, so no warp idles in a round and a
//   mask row stays in L1/L2 while the P planes of its series read it.  The
//   bucket's live range [lo, hi) = [b*r - pad_l, +r) clipped to
//   [0, w_raw) is decided once, at its edges, and split by the 16-byte
//   alignment of x's row: a scalar head up to the first aligned element, a
//   body of whole 16-byte vectors (float4 for f32, 16 bytes of u8), a
//   scalar tail.  The body has no padding branch.  Each lane first issues
//   up to kReduceUnroll independent vector loads (x streamed with
//   ld.global.cs, the mask as aligned 32-bit words realigned by a funnel
//   shift, so mask and x need not share an alignment), then folds them;
//   the weight is read per quad through two aligned float4s (one 1-D row
//   shared by every series, so it stays in cache).
//   Summation order (fixed run to run for a given shape, window start and
//   row alignment): lane j of a task's group folds, in this order, the head
//   cells lo + j, lo + j + G, ...; the body vectors j, j + G, j + 2G, ...,
//   each vector's cells in ascending t; then the tail cells e + j,
//   e + j + G, ...; all into one f32 register (sums add v * w as a rounded
//   product, __fmul_rn, then __fadd_rn).  The G lane partials then combine
//   by __shfl_down_sync with offsets G/2, ..., 1 and lane 0 stores.
//   min/max propagate NaN like jnp.min/jnp.max; counts of live cells are
//   exact below 2^24.
//
// group_merge, group_merge_pair
//   Replace the series->group merge `gseg` (jax.ops.segment_sum/min/max
//   over [S, NB] into ngt+1 segments, the overflow segment dropped) of
//   physical.py:1176 (_bm_kernel_fn.kernel) and physical.py:1255.
//   out[p, g, b] = op over the series of group g (CSR `order`/`offsets`,
//   built once per (grid, GROUP BY) by a stable sort of the group ids, so
//   each group's series come in ascending series order — the order the
//   reference's CPU segment_sum adds them) of x[p, s, b] (times factor[s]
//   for sums; a zero factor drops the series from min/max).  Empty groups
//   give the identity (0, +inf, -inf).
//   group_merge_pair merges the grid path's count plane and its sum planes
//   over one layout in one launch: cnt[g, b] = sum over the group of
//   (int64)(c[s, b] * factor[s]) (the truncation of the solo path's
//   `.to(int64)` and of stacked_count_kernel), sums[p, g, b] as above.
//   Summation order (unchanged from the one-thread-per-output kernel this
//   replaces): every output adds its group's series in ascending series
//   order into one accumulator (f32, or int64 for counts); a factor
//   multiplies as a rounded product (__fmul_rn) before the add, so the
//   result equals a sequential fold, group_merge_stacked's members and,
//   with 0/1 factors, the earlier kernel, bit for bit.
//   Bound: bytes, but at the TSBS shape ([10, 4096, 24] -> 4096, ~4.3 MB)
//   the merge is latency-bound: each output runs a chain of dependent
//   loads (offsets, then order, then x).  Design: one thread an output,
//   in (plane, group, bucket) order, as before, with the series loop
//   unrolled by 4 (four order entries, then four values, in flight) and
//   64-bit index arithmetic.  probes/group_merge.py (with its
//   probes/group_merge.cu) rebuilds the layouts that were tried and times
//   them on the card: the loop with 32-bit indices (no gain at either
//   main-path shape), 8 series loaded at once, and a warp a group (its
//   ids loaded once and shuffled, lanes over (plane, bucket)), which loses
//   at both shapes: too few groups in flight a multiprocessor to hide the
//   chain.  The pair saves the launches and the two elementwise kernels
//   (counts times the factor, the cast to int64) of the two merges it
//   replaces.
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
//   Each output element is one thread folding as group_merge does: the
//   same CSR order (ascending series within a group), the same f32 or
//   int64 accumulator and the same truncation, so with series_mask's 0/1
//   masks (whose products are exact) every member equals its solo bm run
//   (one group_merge_pair launch) bit for bit.  A masked series is never
//   skipped: NaN or inf times 0 stays NaN in both.
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

namespace {

enum Op { OP_SUM = 0, OP_COUNT = 1, OP_MIN = 2, OP_MAX = 3 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kReduceThreads = 256;
constexpr int kReduceUnroll = 4;   // vector loads a lane issues before use
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float identity_of(int op) {
  return op == OP_MIN ? INFINITY : (op == OP_MAX ? -INFINITY : 0.0f);
}

// NaN-propagating min/max (jnp semantics): once NaN, stays NaN.
__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == OP_MIN) return (isnan(a) || a < b) ? a : b;
  if (op == OP_MAX) return (isnan(a) || a > b) ? a : b;
  return __fadd_rn(a, b);
}

// SMs of the current device, read once per device.  A failed query is
// returned, and the launcher returns it in place of launching.
cudaError_t sm_count(int* n) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int v = 0;
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cached[dev] = v;
  }
  *n = cached[dev];
  return cudaSuccess;
}

// Blocks for `warps` warps of work under a grid stride, capped at per_sm
// blocks a multiprocessor.  The cap only bounds the grid: blocks beyond
// what a multiprocessor holds at once wait for a slot, and every block
// loops over its stride.
inline unsigned grid_for(long long warps, int threads, int per_sm, int sms) {
  const long long want = (warps * 32 + threads - 1) / threads;
  const long long cap = (long long)sms * per_sm;
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

// ---------------------------------------------------------------------------
// bucket_reduce
// ---------------------------------------------------------------------------

// The 16-byte vector of each input type: E cells.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using V = float4;
  static constexpr int E = 4;
  __device__ static __forceinline__ float cell(const V& v, int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
  }
};
template <> struct Vec<uint8_t> {
  using V = uint4;
  static constexpr int E = 16;
  __device__ static __forceinline__ float cell(const V& v, int i) {
    const unsigned w = (i >> 2) == 0 ? v.x
                       : ((i >> 2) == 1 ? v.y : ((i >> 2) == 2 ? v.z : v.w));
    return ((w >> (8 * (i & 3))) & 0xffu) ? 1.0f : 0.0f;
  }
};

__device__ __forceinline__ float scalar_f32(float v) { return v; }
__device__ __forceinline__ float scalar_f32(uint8_t v) {
  return v ? 1.0f : 0.0f;
}

// Four weights starting at w (any float alignment): two aligned float4
// reads of the 16-byte chunks that hold them, realigned.  A chunk holding
// a live element never crosses a page, so the second read is safe even
// where it runs past the array's end (its extra lanes are unused).
__device__ __forceinline__ void weight4(const float* w, float (&out)[4]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(w);
  const int d = (int)((addr >> 2) & 3);
  const float4* base = reinterpret_cast<const float4*>(addr - 4 * d);
  const float4 a = __ldg(base);
  const float4 b = d ? __ldg(base + 1) : a;
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = d == 0 ? f[i]
             : (d == 1 ? f[i + 1] : (d == 2 ? f[i + 2] : f[i + 3]));
  }
}

template <int OP, bool MASK, bool WEIGHT>
__device__ __forceinline__ void fold_cell(float& acc, float v, bool m,
                                          float w, bool skip_nan) {
  const bool live = (!MASK || m) && !(skip_nan && isnan(v));
  if (OP == OP_SUM) {
    if (live) acc = __fadd_rn(acc, WEIGHT ? __fmul_rn(v, w) : v);
  } else if (OP == OP_COUNT) {
    if (live) acc = __fadd_rn(acc, WEIGHT ? w : 1.0f);
  } else if (live && (!WEIGHT || w != 0.0f)) {
    acc = combine(OP, acc, v);
  }
}

template <typename T, int OP, bool MASK, bool WEIGHT>
__device__ __forceinline__ void fold_scalar(float& acc, const T* xr,
                                            const uint8_t* mr,
                                            const float* weight, int t,
                                            bool skip_nan) {
  const float v = scalar_f32(xr[t]);
  fold_cell<OP, MASK, WEIGHT>(acc, v, MASK ? mr[t] != 0 : true,
                              WEIGHT ? __ldg(weight + t) : 1.0f, skip_nan);
}

template <typename T, int OP, bool MASK, bool WEIGHT>
__global__ void __launch_bounds__(kReduceThreads)
bucket_reduce_kernel(const T* __restrict__ x, long long x_sp, long long x_ss,
                     const uint8_t* __restrict__ mask, long long m_ss,
                     const float* __restrict__ weight, float* __restrict__ out,
                     int P, int S, int w_raw, int pad_l, int r, int nb,
                     int skip_nan_i, int glog, long long tasks) {
  using VT = Vec<T>;
  using V = typename VT::V;
  constexpr int E = VT::E;
  constexpr int NW = E / 4 + 1;  // aligned mask words behind E mask bytes
  const bool skip_nan = skip_nan_i != 0;
  const int G = 1 << glog;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int gpw = 32 >> glog;
  const long long warp0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long wtasks = (tasks + gpw - 1) / gpw;
  for (long long wt = warp0; wt < wtasks; wt += nwarps) {
    const long long task = wt * gpw + (lane >> glog);
    float acc = identity_of(OP);
    long long o = -1;
    if (task < tasks) {
      // tasks in (s, p, b) order
      const int b = (int)(task % nb);
      const long long ps = task / nb;
      const long long p = ps % P;
      const long long s = ps / P;
      o = (p * S + s) * nb + b;
      const T* xr = x + p * x_sp + s * x_ss;
      const uint8_t* mr = MASK ? mask + s * m_ss : nullptr;
      int lo = b * r - pad_l;
      int hi = lo + r;
      lo = lo < 0 ? 0 : lo;
      hi = hi > w_raw ? w_raw : hi;
      if (hi < lo) hi = lo;
      // head [lo, a), body [a, e) of whole aligned vectors, tail [e, hi)
      const int mis = (int)((reinterpret_cast<uintptr_t>(xr) / sizeof(T)) %
                            E);
      int a = lo + (E - (lo + mis) % E) % E;
      a = a > hi ? hi : a;
      const int nvec = (hi - a) / E;
      const int e = a + nvec * E;
      for (int t = lo + gl; t < a; t += G) {
        fold_scalar<T, OP, MASK, WEIGHT>(acc, xr, mr, weight, t, skip_nan);
      }
      int msh = 0;
      if (MASK) {
        msh = (int)((reinterpret_cast<uintptr_t>(mr + a) & 3) * 8);
      }
      for (int k0 = gl; k0 < nvec; k0 += G * kReduceUnroll) {
        V xv[kReduceUnroll];
        uint32_t mw[kReduceUnroll][NW];
#pragma unroll
        for (int u = 0; u < kReduceUnroll; ++u) {
          const int k = k0 + u * G;
          if (k < nvec) {
            const int t = a + k * E;
            xv[u] = __ldcs(reinterpret_cast<const V*>(xr + t));
            if (MASK) {
              const uint32_t* mwp = reinterpret_cast<const uint32_t*>(
                  reinterpret_cast<uintptr_t>(mr + t) & ~(uintptr_t)3);
#pragma unroll
              for (int q = 0; q < NW - 1; ++q) mw[u][q] = __ldg(mwp + q);
              mw[u][NW - 1] = msh ? __ldg(mwp + NW - 1) : 0u;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kReduceUnroll; ++u) {
          const int k = k0 + u * G;
          if (k < nvec) {
            const int t = a + k * E;
#pragma unroll
            for (int q = 0; q < E / 4; ++q) {
              uint32_t mq = 0xffffffffu;
              if (MASK) mq = __funnelshift_r(mw[u][q], mw[u][q + 1], msh);
              float wq[4] = {1.0f, 1.0f, 1.0f, 1.0f};
              if (WEIGHT) weight4(weight + t + 4 * q, wq);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                fold_cell<OP, MASK, WEIGHT>(
                    acc, VT::cell(xv[u], 4 * q + i),
                    ((mq >> (8 * i)) & 0xffu) != 0, wq[i], skip_nan);
              }
            }
          }
        }
      }
      for (int t = e + gl; t < hi; t += G) {
        fold_scalar<T, OP, MASK, WEIGHT>(acc, xr, mr, weight, t, skip_nan);
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      const float other = __shfl_down_sync(kFull, acc, off, G);
      acc = (OP == OP_SUM || OP == OP_COUNT) ? __fadd_rn(acc, other)
                                             : combine(OP, acc, other);
    }
    if (o >= 0 && gl == 0) out[o] = acc;
  }
}

// ---------------------------------------------------------------------------
// group_merge / group_merge_pair
// ---------------------------------------------------------------------------

enum MergeMode { MERGE_F32 = 0, MERGE_I64 = 1, MERGE_PAIR = 2 };

struct MergeArgs {
  const void* x;             // planes [P, S, nb] (f32, or i64 counts)
  long long x_sp, x_ss;
  const float* cnt;          // pair: the f32 count plane [S, nb]
  long long c_ss;
  const int32_t* order;
  const int64_t* offsets;
  const float* factor;       // [S] or null
  void* out;                 // [P, ngt, nb] (f32, or i64)
  int64_t* out_cnt;          // pair: [ngt, nb]
  int P, ngt, nb, op;
};

// One thread an output (q, g, b), q the plane (the pair's plane 0 is the
// count plane), in (q, g, b) order: neighbouring threads read neighbouring
// buckets of one series and write neighbouring outputs, and the threads of
// a group share its offsets and order entries through L1.  Each mode runs
// its own tight loop over the group's series, unrolled by 4 so that four
// series' order entries, then their values, are in flight at once.
template <int MODE>
__global__ void __launch_bounds__(kMergeThreads)
group_merge_kernel(MergeArgs a, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i % a.nb;
  const long long qg = i / a.nb;
  const long long g = qg % a.ngt;
  const long long q = qg / a.ngt;
  const long long k0 = a.offsets[g];
  const long long k1 = a.offsets[g + 1];
  const int32_t* __restrict__ order = a.order;
  const float* __restrict__ fac = a.factor;
  const long long cell = (long long)g * a.nb + b;
  if (MODE == MERGE_I64) {
    const long long* __restrict__ xp =
        static_cast<const long long*>(a.x) + (long long)q * a.x_sp + b;
    long long acc = 0;
#pragma unroll 4
    for (long long k = k0; k < k1; ++k) acc += xp[order[k] * a.x_ss];
    static_cast<long long*>(a.out)[(long long)q * a.ngt * a.nb + cell] = acc;
    return;
  }
  if (MODE == MERGE_PAIR && q == 0) {  // counts: (int64)(c * factor)
    const float* __restrict__ cp = a.cnt + b;
    long long acc = 0;
    if (fac != nullptr) {
#pragma unroll 4
      for (long long k = k0; k < k1; ++k) {
        const int s = order[k];
        acc += (long long)__fmul_rn(cp[s * a.c_ss], fac[s]);
      }
    } else {
#pragma unroll 4
      for (long long k = k0; k < k1; ++k) {
        acc += (long long)cp[order[k] * a.c_ss];
      }
    }
    a.out_cnt[cell] = acc;
    return;
  }
  const long long plane = MODE == MERGE_PAIR ? q - 1 : q;
  const float* __restrict__ xp =
      static_cast<const float*>(a.x) + (long long)plane * a.x_sp + b;
  float acc = identity_of(MODE == MERGE_F32 ? a.op : OP_SUM);
  if (MODE == MERGE_PAIR || a.op == OP_SUM) {
    if (fac != nullptr) {
#pragma unroll 4
      for (long long k = k0; k < k1; ++k) {
        const int s = order[k];
        acc = __fadd_rn(acc, __fmul_rn(xp[s * a.x_ss], fac[s]));
      }
    } else {
#pragma unroll 4
      for (long long k = k0; k < k1; ++k) {
        acc = __fadd_rn(acc, xp[order[k] * a.x_ss]);
      }
    }
  } else {
#pragma unroll 4
    for (long long k = k0; k < k1; ++k) {
      const int s = order[k];
      const float v = xp[s * a.x_ss];
      if (fac == nullptr || fac[s] != 0.0f) acc = combine(a.op, acc, v);
    }
  }
  static_cast<float*>(a.out)[(long long)plane * a.ngt * a.nb + cell] = acc;
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

template <typename T, int OP, bool MASK, bool WEIGHT>
void launch_reduce_op(const T* x, long long x_sp, long long x_ss,
                      const uint8_t* mask, long long m_ss, const float* weight,
                      float* out, int P, int S, int w_raw, int pad_l, int r,
                      int nb, int skip_nan, int glog, int sms,
                      cudaStream_t stream) {
  const long long tasks = (long long)P * S * nb;
  const long long warps = (tasks + (32 >> glog) - 1) / (32 >> glog);
  bucket_reduce_kernel<T, OP, MASK, WEIGHT>
      <<<grid_for(warps, kReduceThreads, 16, sms), kReduceThreads, 0,
         stream>>>(
          x, x_sp, x_ss, mask, m_ss, weight, out, P, S, w_raw, pad_l, r, nb,
          skip_nan, glog, tasks);
}

template <typename T, bool MASK, bool WEIGHT>
void launch_reduce_flags(const T* x, long long x_sp, long long x_ss,
                         const uint8_t* mask, long long m_ss,
                         const float* weight, float* out, int P, int S,
                         int w_raw, int pad_l, int r, int nb, int op,
                         int skip_nan, int glog, int sms,
                         cudaStream_t stream) {
#define GT_REDUCE(OPV)                                                       \
  launch_reduce_op<T, OPV, MASK, WEIGHT>(x, x_sp, x_ss, mask, m_ss, weight,  \
                                         out, P, S, w_raw, pad_l, r, nb,     \
                                         skip_nan, glog, sms, stream)
  switch (op) {
    case OP_SUM: GT_REDUCE(OP_SUM); break;
    case OP_COUNT: GT_REDUCE(OP_COUNT); break;
    case OP_MIN: GT_REDUCE(OP_MIN); break;
    default: GT_REDUCE(OP_MAX); break;
  }
#undef GT_REDUCE
}

template <typename T>
int launch_bucket_reduce(const T* x, long long x_sp, long long x_ss,
                         const uint8_t* mask, long long m_ss,
                         const float* weight, float* out, int P, int S,
                         int w_raw, int pad_l, int r, int nb, int op,
                         int skip_nan, int glog, void* stream) {
  if (glog < 0 || glog > 5 || op < OP_SUM || op > OP_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)P * S * nb <= 0) return (int)cudaGetLastError();
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
#define GT_FLAGS(M, W)                                                      \
  launch_reduce_flags<T, M, W>(x, x_sp, x_ss, mask, m_ss, weight, out, P, S, \
                               w_raw, pad_l, r, nb, op, skip_nan, glog, sms,  \
                               st)
  if (mask != nullptr && weight != nullptr) {
    GT_FLAGS(true, true);
  } else if (mask != nullptr) {
    GT_FLAGS(true, false);
  } else if (weight != nullptr) {
    GT_FLAGS(false, true);
  } else {
    GT_FLAGS(false, false);
  }
#undef GT_FLAGS
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_group_merge(const MergeArgs& a, void* stream) {
  const long long total =
      (long long)(MODE == MERGE_PAIR ? a.P + 1 : a.P) * a.ngt * a.nb;
  if (total <= 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((total + kMergeThreads - 1) / kMergeThreads);
  group_merge_kernel<MODE><<<blocks, kMergeThreads, 0,
                             (cudaStream_t)stream>>>(a, total);
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
                         int skip_nan, int glog, void* stream) {
  return launch_bucket_reduce<float>(x, x_sp, x_ss, mask, m_ss, weight, out,
                                     P, S, w_raw, pad_l, r, nb, op, skip_nan,
                                     glog, stream);
}

int gt_bucket_reduce_u8(const uint8_t* x, long long x_sp, long long x_ss,
                        const uint8_t* mask, long long m_ss,
                        const float* weight, float* out, int P, int S,
                        int w_raw, int pad_l, int r, int nb, int op,
                        int skip_nan, int glog, void* stream) {
  return launch_bucket_reduce<uint8_t>(x, x_sp, x_ss, mask, m_ss, weight,
                                       out, P, S, w_raw, pad_l, r, nb, op,
                                       skip_nan, glog, stream);
}

int gt_group_merge_f32(const float* x, long long x_sp, long long x_ss,
                       const int32_t* order, const int64_t* offsets,
                       const float* factor, float* out, int P, int ngt,
                       int nb, int op, void* stream) {
  if (op != OP_SUM && op != OP_MIN && op != OP_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  MergeArgs a = {x, x_sp, x_ss, nullptr, 0, order, offsets, factor,
                 out, nullptr, P, ngt, nb, op};
  return launch_group_merge<MERGE_F32>(a, stream);
}

int gt_group_merge_i64(const int64_t* x, long long x_sp, long long x_ss,
                       const int32_t* order, const int64_t* offsets,
                       int64_t* out, int P, int ngt, int nb, void* stream) {
  MergeArgs a = {x, x_sp, x_ss, nullptr, 0, order, offsets, nullptr,
                 out, nullptr, P, ngt, nb, OP_SUM};
  return launch_group_merge<MERGE_I64>(a, stream);
}

int gt_group_merge_pair(const float* cnt, long long c_ss, const float* sums,
                        long long s_sp, long long s_ss, const int32_t* order,
                        const int64_t* offsets, const float* factor,
                        int64_t* out_cnt, float* out_sum, int P, int ngt,
                        int nb, void* stream) {
  MergeArgs a = {sums, s_sp, s_ss, cnt, c_ss, order, offsets, factor,
                 out_sum, out_cnt, P, ngt, nb, OP_SUM};
  return launch_group_merge<MERGE_PAIR>(a, stream);
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
