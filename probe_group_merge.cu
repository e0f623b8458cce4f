// Layouts of the series->group merge (csrc/grid_kernels.cu's
// group_merge_kernel, f32 sums), built and timed against each other by
// probe_group_merge.py.  Every variant adds a group's series in ascending
// series order into one f32 accumulator an output, so each equals the
// port's group_merge bit for bit; only the launch shape and the loop
// differ.
//   0 parent       a thread an output (p, g, b), 64-bit indices, the op
//                  tested inside the series loop, no launch bounds: the
//                  loop of the kernel before the dense-grid redesign (its
//                  min branch, which these sums never take, uses fminf
//                  where that kernel propagates NaN).
//   1 unroll4      a thread an output, 64-bit indices, the op decided
//                  before a series loop unrolled by 4 (the port's loop),
//                  under __launch_bounds__(256, 1).
//   2 unroll4_i32  unroll4 with 32-bit index arithmetic.
//   3 batch8       a thread an output that loads 8 order entries, then
//                  their 8 values, then adds the 8 in order.
//   4 warp_group   a warp a group: lanes load 32 order entries at a time
//                  and __shfl_sync hands each to every lane; lane l owns
//                  outputs l, l + 32, ... of the group's P * nb (at most
//                  kWarpOuts a lane), all over one series list.
//   5 unroll4_occ8 unroll4 with __launch_bounds__(256, 8): the full 2,048
//                  threads a multiprocessor asked of the register
//                  allocator, as the port's kernel gets at 32 registers.
// Entry: probe_merge(variant, ...) returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown variant or P * nb too wide for
// warp_group.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpOuts = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void merge_parent(const float* __restrict__ x, long long x_sp, long long x_ss,
                             const int32_t* __restrict__ order,
                             const int64_t* __restrict__ offsets,
                             const float* __restrict__ factor,
                             float* __restrict__ out, int P, int ngt, int nb,
                             int op) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)P * ngt * nb;
  if (i >= total) return;
  const long long b = i % nb;
  const long long pg = i / nb;
  const long long g = pg % ngt;
  const long long p = pg / ngt;
  const float* xp = x + p * x_sp + b;
  const long long k0 = offsets[g];
  const long long k1 = offsets[g + 1];
  float acc = op == 0 ? 0.0f : INFINITY;
  for (long long k = k0; k < k1; ++k) {
    const long long s = order[k];
    const float v = xp[s * x_ss];
    if (op == 0) {
      acc += factor != nullptr ? v * factor[s] : v;
    } else if (factor == nullptr || factor[s] != 0.0f) {
      acc = fminf(acc, v);
    }
  }
  out[i] = acc;
}

template <typename I, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_unroll4(const float* __restrict__ x, long long x_sp, long long x_ss,
              const int32_t* __restrict__ order,
              const int64_t* __restrict__ offsets,
              const float* __restrict__ factor, float* __restrict__ out,
              int ngt, int nb, int op, I total) {
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const I b = i % nb;
  const I pg = i / nb;
  const I g = pg % ngt;
  const I p = pg / ngt;
  const long long k0 = offsets[g];
  const long long k1 = offsets[g + 1];
  const float* __restrict__ xp = x + (long long)p * x_sp + b;
  float acc = op == 0 ? 0.0f : INFINITY;
  if (op == 0) {
    if (factor != nullptr) {
#pragma unroll 4
      for (long long k = k0; k < k1; ++k) {
        const int s = order[k];
        acc = __fadd_rn(acc, __fmul_rn(xp[s * x_ss], factor[s]));
      }
    } else {
#pragma unroll 4
      for (long long k = k0; k < k1; ++k) {
        acc = __fadd_rn(acc, xp[order[k] * x_ss]);
      }
    }
  } else {
#pragma unroll 4
    for (long long k = k0; k < k1; ++k) {
      const int s = order[k];
      if (factor == nullptr || factor[s] != 0.0f) {
        acc = fminf(acc, xp[s * x_ss]);
      }
    }
  }
  out[(long long)p * ngt * nb + (long long)g * nb + b] = acc;
}

__global__ void __launch_bounds__(kThreads)
merge_batch8(const float* __restrict__ x, long long x_sp, long long x_ss,
             const int32_t* __restrict__ order,
             const int64_t* __restrict__ offsets, float* __restrict__ out,
             int ngt, int nb, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i % nb;
  const long long pg = i / nb;
  const long long g = pg % ngt;
  const long long p = pg / ngt;
  const float* __restrict__ xp = x + p * x_sp + b;
  long long k = offsets[g];
  const long long k1 = offsets[g + 1];
  float acc = 0.0f;
  for (; k + 8 <= k1; k += 8) {
    int s[8];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = order[k + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = xp[s[j] * x_ss];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, v[j]);
  }
  for (; k < k1; ++k) acc = __fadd_rn(acc, xp[order[k] * x_ss]);
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
merge_warp_group(const float* __restrict__ x, long long x_sp, long long x_ss,
                 const int32_t* __restrict__ order,
                 const int64_t* __restrict__ offsets, float* __restrict__ out,
                 int P, int ngt, int nb) {
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= ngt) return;  // whole warps leave together
  const int outs = P * nb;
  float acc[kWarpOuts];
  long long base[kWarpOuts];
#pragma unroll
  for (int j = 0; j < kWarpOuts; ++j) {
    const int o = lane + 32 * j;
    acc[j] = 0.0f;
    base[j] = o < outs ? (long long)(o / nb) * x_sp + o % nb : 0;
  }
  const long long k0 = offsets[g];
  const long long k1 = offsets[g + 1];
  for (long long c = k0; c < k1; c += 32) {
    const int n = k1 - c < 32 ? (int)(k1 - c) : 32;
    const int mine = lane < n ? order[c + lane] : 0;
    for (int t = 0; t < n; ++t) {
      const long long s = __shfl_sync(kFull, mine, t);
#pragma unroll
      for (int j = 0; j < kWarpOuts; ++j) {
        if (lane + 32 * j < outs) {
          acc[j] = __fadd_rn(acc[j], x[base[j] + s * x_ss]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kWarpOuts; ++j) {
    const int o = lane + 32 * j;
    if (o < outs) {
      out[(long long)(o / nb) * ngt * nb + g * nb + o % nb] = acc[j];
    }
  }
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int probe_merge(int variant, const float* x, long long x_sp,
                           long long x_ss, const int32_t* order,
                           const int64_t* offsets, float* out, int P,
                           int ngt, int nb, void* stream) {
  const long long total = (long long)P * ngt * nb;
  if (total <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      merge_parent<<<blocks_for(total), kThreads, 0, st>>>(
          x, x_sp, x_ss, order, offsets, nullptr, out, P, ngt, nb, 0);
      break;
    case 1:
      merge_unroll4<long long, 1><<<blocks_for(total), kThreads, 0, st>>>(
          x, x_sp, x_ss, order, offsets, nullptr, out, ngt, nb, 0, total);
      break;
    case 2:
      if (total >= (1LL << 31) - kThreads) return (int)cudaErrorInvalidValue;
      merge_unroll4<int, 1><<<blocks_for(total), kThreads, 0, st>>>(
          x, x_sp, x_ss, order, offsets, nullptr, out, ngt, nb, 0,
          (int)total);
      break;
    case 3:
      merge_batch8<<<blocks_for(total), kThreads, 0, st>>>(
          x, x_sp, x_ss, order, offsets, out, ngt, nb, total);
      break;
    case 4:
      if (P * nb > 32 * kWarpOuts) return (int)cudaErrorInvalidValue;
      merge_warp_group<<<blocks_for((long long)ngt * 32), kThreads, 0, st>>>(
          x, x_sp, x_ss, order, offsets, out, P, ngt, nb);
      break;
    case 5:
      merge_unroll4<long long, 8><<<blocks_for(total), kThreads, 0, st>>>(
          x, x_sp, x_ss, order, offsets, nullptr, out, ngt, nb, 0, total);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
