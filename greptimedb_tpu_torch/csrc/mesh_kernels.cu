// Hand-written Hopper kernel of the mesh row path's exchange phase.
//
// Built by greptimedb_tpu_torch/ops/mesh_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o build/kernels/libgreptime_mesh.so
//        mesh_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Every
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.
//
// mesh_merge
//   Replaces the collectives of the JAX reference's mesh aggregate
//   (greptimedb_tpu/parallel/dist.py:199-204 `_MERGE`, and the psum / pmin
//   / pmax inside `local`, :297-459, run under shard_map over ICI).  The
//   port's mesh is one process: each shard's local partials ([G] or [G, M]
//   per shard, from the row-path kernels) are brought to the mesh's first
//   device and stacked [D, G(, M)]; this kernel folds the shard axis.  One
//   thread an output element, the D shards read in mesh order:
//   - sum (f32 in shard order, as the plain version adds; int64 exact;
//     counts are int64 sums), min and max (f32, f64, int32 and int64; a
//     NaN operand gives NaN, as torch.minimum / torch.maximum do);
//   - udd: a UDDSketch partial row [nb + 2] per group, the nb bucket counts
//     summed, column nb (k_min) by min and column nb + 1 (collapse) by max;
//     every shard bucketed against the same global extremes, so the two
//     tail columns agree and the fold keeps them;
//   - pick (first_value / last_value, :425-457): per group the extreme
//     timestamp over the shards that hold rows (max for last, min for
//     first), then the largest value among the shards that hold it, -inf
//     (INT64_MIN for integers) where none does.  This is the reference's
//     cross-shard tie rule, not row order.
//   hll is a max over [D, G, 4096] int32 registers.
//   Bound: bytes, the D partials read once and the result written once;
//   one pass of coalesced loads (neighbouring threads, neighbouring
//   elements of one shard's partial).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum MergeOp { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_UDD = 3 };
enum DType { DT_F32 = 0, DT_F64 = 1, DT_I32 = 2, DT_I64 = 3 };

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T max_of(T a, T b) { return b > a ? b : a; }
// floats: NaN in either operand gives NaN (torch.minimum / maximum)
template <>
__device__ __forceinline__ float min_of(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (b < a ? b : a);
}
template <>
__device__ __forceinline__ float max_of(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (b > a ? b : a);
}
template <>
__device__ __forceinline__ double min_of(double a, double b) {
  return (isnan(a) || isnan(b)) ? NAN : (b < a ? b : a);
}
template <>
__device__ __forceinline__ double max_of(double a, double b) {
  return (isnan(a) || isnan(b)) ? NAN : (b > a ? b : a);
}

// parts [D, E] row-major (E = G * M elements a shard); out [E]
template <typename T>
__global__ void mesh_merge_kernel(const T* __restrict__ parts, long long D,
                                  long long E, long long M, int op,
                                  T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  int o = op;
  if (op == OP_UDD) {
    const long long col = i % M;
    o = col < M - 2 ? OP_SUM : (col == M - 2 ? OP_MIN : OP_MAX);
  }
  T acc = parts[i];
  for (long long d = 1; d < D; ++d) {
    const T v = parts[d * E + i];
    acc = o == OP_SUM ? (T)(acc + v) : (o == OP_MIN ? min_of(acc, v)
                                                    : max_of(acc, v));
  }
  out[i] = acc;
}

// ts, has, vals [D, G]; out_ts, out_val [G]
template <typename V>
__global__ void mesh_pick_kernel(const long long* __restrict__ ts,
                                 const bool* __restrict__ has,
                                 const V* __restrict__ vals, long long D,
                                 long long G, int last, V fill,
                                 long long* __restrict__ out_ts,
                                 V* __restrict__ out_val) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  long long best = last ? LLONG_MIN : LLONG_MAX;
  for (long long d = 0; d < D; ++d) {
    if (!has[d * G + g]) continue;
    const long long t = ts[d * G + g];
    best = last ? (t > best ? t : best) : (t < best ? t : best);
  }
  V val = fill;
  for (long long d = 0; d < D; ++d) {
    const long long k = d * G + g;
    if (has[k] && ts[k] == best) val = max_of(val, vals[k]);
  }
  out_ts[g] = best;
  out_val[g] = val;
}

template <typename T>
int launch_merge(const void* parts, long long D, long long E, long long M,
                 int op, void* out, cudaStream_t st) {
  mesh_merge_kernel<T><<<blocks_for(E), kThreads, 0, st>>>(
      static_cast<const T*>(parts), D, E, M, op, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_mesh_merge(const void* parts, int dtype, long long D, long long E,
                  long long M, int op, void* out, void* stream) {
  if (D <= 0 || E <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32: return launch_merge<float>(parts, D, E, M, op, out, st);
    case DT_F64: return launch_merge<double>(parts, D, E, M, op, out, st);
    case DT_I32: return launch_merge<int32_t>(parts, D, E, M, op, out, st);
    case DT_I64:
      return launch_merge<long long>(parts, D, E, M, op, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int gt_mesh_pick(const long long* ts, const bool* has, const void* vals,
                 int dtype, long long D, long long G, int last,
                 long long* out_ts, void* out_val, void* stream) {
  if (G <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      mesh_pick_kernel<float><<<blocks_for(G), kThreads, 0, st>>>(
          ts, has, static_cast<const float*>(vals), D, G, last, -INFINITY,
          out_ts, static_cast<float*>(out_val));
      break;
    case DT_F64:
      mesh_pick_kernel<double><<<blocks_for(G), kThreads, 0, st>>>(
          ts, has, static_cast<const double*>(vals), D, G, last,
          (double)-INFINITY, out_ts, static_cast<double*>(out_val));
      break;
    case DT_I64:
      mesh_pick_kernel<long long><<<blocks_for(G), kThreads, 0, st>>>(
          ts, has, static_cast<const long long*>(vals), D, G, last,
          LLONG_MIN, out_ts, static_cast<long long*>(out_val));
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
