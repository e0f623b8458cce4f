// Hand-written Hopper kernel of exact vector search (K22).
//
// Built by greptimedb_tpu_torch/ops/vector_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libgreptime_vector.so
//        vector_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  The
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.
//
// vec_distance
//   Replaces K22, the distances of greptimedb_tpu/query/exprs.py:853
//   `_vocab_distances` (`M @ qd`, `sum((M - qd)**2, 1)`, and
//   `1 - (M @ qd) / max(norm(M, 1) * norm(qd), 1e-30)`), which
//   `_compile_vec_distance` (:890) and the host evaluator (:1254) then
//   gather to rows by dictionary code.
//   One warp takes four vectors, their loads in flight together (the
//   matrix is read once: streaming loads).  For each vector lane c
//   accumulates, in f32, the terms of the components c, c + 32, ... (four
//   at a time with 16-byte loads when the width is a multiple of 4), then
//   an xor butterfly over the 32 lanes adds the partial sums (offsets 16,
//   8, 4, 2, 1).  The products may contract into FMAs.  That order is not
//   XLA's, so f32 results differ from the reference's by rounding only;
//   with integer components whose sums stay below 2^24 every partial sum
//   is exact and so are dot and L2^2.  A vector whose text did not parse
//   (valid 0) gets NaN.
//   Bound: bytes.  The [D, dim] matrix is read once (4 D dim bytes) and D
//   f32 written; 3 dim flops a vector are far below the card's f32 rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // vectors a warp takes, loads in flight together
constexpr unsigned kFull = 0xffffffffu;

enum Op : int { kDot = 0, kL2sq = 1, kCos = 2 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Component c of vector `row` (zero past the last vector); the matrix is
// read once, so its loads stream past the caches.
__device__ __forceinline__ float4 load4(const float4* m4, long long row,
                                        long long D, int w4, int c) {
  return row < D ? __ldcs(m4 + row * w4 + c) : make_float4(0, 0, 0, 0);
}

__device__ __forceinline__ float load1(const float* m, long long row,
                                       long long D, int dim, int c) {
  return row < D ? __ldcs(m + row * dim + c) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    vec_distance_kernel(const float* __restrict__ mat,
                        const uint8_t* __restrict__ valid, long long D,
                        int dim, const float* __restrict__ q, int op,
                        int vec4, float* __restrict__ out) {
  const long long row0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  const int lane = threadIdx.x & 31;
  if (row0 >= D) return;  // warp-uniform
  float dot[kRows], l2[kRows], nm[kRows];
  float nq = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) dot[r] = l2[r] = nm[r] = 0.0f;
  if (vec4) {
    const float4* m4 = reinterpret_cast<const float4*>(mat);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int w4 = dim / 4;
    for (int c = lane; c < w4; c += 32) {
      float4 a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = load4(m4, row0 + r, D, w4, c);
      const float4 b = q4[c];
      nq += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float d0 = a[r].x - b.x, d1 = a[r].y - b.y, d2 = a[r].z - b.z,
                    d3 = a[r].w - b.w;
        dot[r] += a[r].x * b.x + a[r].y * b.y + a[r].z * b.z + a[r].w * b.w;
        l2[r] += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
        nm[r] += a[r].x * a[r].x + a[r].y * a[r].y + a[r].z * a[r].z +
                 a[r].w * a[r].w;
      }
    }
  } else {
    for (int c = lane; c < dim; c += 32) {
      float a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = load1(mat, row0 + r, D, dim, c);
      const float b = q[c];
      nq += b * b;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float d = a[r] - b;
        dot[r] += a[r] * b;
        l2[r] += d * d;
        nm[r] += a[r] * a[r];
      }
    }
  }
  if (op == kCos) nq = warp_sum(nq);
  float res = 0.0f;  // lane r keeps vector r's result
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v;
    if (op == kDot) {
      v = warp_sum(dot[r]);
    } else if (op == kL2sq) {
      v = warp_sum(l2[r]);
    } else {
      v = 1.0f - warp_sum(dot[r]) /
                     fmaxf(sqrtf(warp_sum(nm[r])) * sqrtf(nq), 1e-30f);
    }
    if (lane == r) res = v;
  }
  const long long row = row0 + lane;
  if (lane < kRows && row < D) out[row] = valid[row] != 0 ? res : NAN;
}

}  // namespace

extern "C" {

// mat: [D, dim] f32 row-major; valid: [D] bool; q: [dim] f32; op: 0 dot,
// 1 L2 squared, 2 cosine distance; vec4: 1 when dim % 4 == 0 and mat and
// q are 16-byte aligned; out: [D] f32.
int gt_vec_distance(const float* mat, const uint8_t* valid, long long D,
                    int dim, const float* q, int op, int vec4, float* out,
                    void* stream) {
  if (D <= 0) return (int)cudaGetLastError();
  const long long per_block = (long long)kWarps * kRows;
  const long long blocks = (D + per_block - 1) / per_block;
  vec_distance_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(mat, valid, D, dim, q, op,
                                                vec4, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
