// Hand-written Hopper kernel of the device flow fold.
//
// Built by greptimedb_tpu_torch/ops/flow_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libgreptime_flow.so
//        flow_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  The
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.
//
// flow_merge
//   Replaces the state half of K15: greptimedb_tpu/flow/device.py:452-492,
//   the scatter-merge of a chunk's per-affected-slot partials into the
//   resident [Gpad, Wpad] accumulator matrices and the gather of the
//   merged slots back out (the chunk partials themselves come from the
//   segment_reduce kernel, ops/segment_kernels.py).
//   One thread an affected slot (g, w).  The slots are unique (np.unique
//   of the chunk's (group, window) ids), so no two threads touch one state
//   element and the kernel needs no atomics.  Pad slots (g outside
//   [0, Gpad), the reference's dropped scatters) write zeros to the
//   outputs and touch no state.  Per slot, in the reference's merge order:
//   read the OLD rows count (fresh = rows == 0) and, for every companion
//   timestamp accumulator, decide from the OLD state whether the chunk's
//   pick wins (touched and (fresh or strictly better): the state wins
//   ties); then merge every accumulator in place (f64 / int64 add, f64
//   min / max, pick value, companion ts), write each merged value to its
//   output, and add the chunk's row count to rows last.
//   Bound: bytes: per affected slot, each accumulator's chunk partial read
//   and its output written once, and its state element read and written
//   once (A + 1 accumulators of 8 bytes: 32 (A + 1) bytes a slot).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAcc = 48;
constexpr int kThreads = 256;

enum Kind : int {
  kAddF64 = 0,
  kAddI64 = 1,
  kMinF64 = 2,
  kMaxF64 = 3,
  kPick = 4,    // value of a first/last pick (f64), decided by link[a]
  kTsMin = 5,   // companion min(ts) of first_value (int64)
  kTsMax = 6,   // companion max(ts) of last_value (int64)
};

struct FlowArgs {
  int A;  // accumulators, rows excluded
  int kind[kMaxAcc];
  int link[kMaxAcc];  // kPick: index of its companion ts accumulator
  void* state[kMaxAcc + 1];  // [Gpad * Wpad] each; state[A] = rows
  const void* chunk[kMaxAcc];  // [apad] each
  void* out[kMaxAcc + 1];  // [apad] each; out[A] = rows
};

__global__ void flow_merge_kernel(FlowArgs args,
                                  const long long* __restrict__ rows_any,
                                  const int32_t* __restrict__ aff_g,
                                  const int32_t* __restrict__ aff_w,
                                  long long apad, long long gpad,
                                  long long wpad) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= apad) return;
  const int A = args.A;
  const long long g = aff_g[i];
  const long long w = aff_w[i];
  if (g < 0 || g >= gpad || w < 0 || w >= wpad) {
    for (int a = 0; a <= A; ++a) static_cast<long long*>(args.out[a])[i] = 0;
    return;
  }
  const long long off = g * wpad + w;
  long long* rows = static_cast<long long*>(args.state[A]);
  const long long old_rows = rows[off];
  const long long ra = rows_any[i];
  const bool fresh = old_rows == 0;
  const bool touched = ra > 0;
  // picks decide against the OLD companion timestamps
  unsigned long long better = 0;
  for (int a = 0; a < A; ++a) {
    const int k = args.kind[a];
    if (k != kTsMin && k != kTsMax) continue;
    const long long cv = static_cast<const long long*>(args.chunk[a])[i];
    const long long cur = static_cast<const long long*>(args.state[a])[off];
    const bool b = touched && (fresh || (k == kTsMax ? cv > cur : cv < cur));
    if (b) better |= 1ull << a;
  }
  for (int a = 0; a < A; ++a) {
    const int k = args.kind[a];
    if (k == kAddI64 || k == kTsMin || k == kTsMax) {
      long long* s = static_cast<long long*>(args.state[a]);
      const long long cv = static_cast<const long long*>(args.chunk[a])[i];
      const long long cur = s[off];
      long long nv;
      if (k == kAddI64) {
        nv = cur + cv;
      } else if (!touched) {
        nv = cur;
      } else if (fresh) {
        nv = cv;
      } else {
        nv = k == kTsMax ? (cv > cur ? cv : cur) : (cv < cur ? cv : cur);
      }
      s[off] = nv;
      static_cast<long long*>(args.out[a])[i] = nv;
    } else {
      double* s = static_cast<double*>(args.state[a]);
      const double cv = static_cast<const double*>(args.chunk[a])[i];
      const double cur = s[off];
      double nv;
      if (k == kAddF64) {
        nv = cur + cv;
      } else if (k == kMinF64) {
        nv = cv < cur ? cv : cur;
      } else if (k == kMaxF64) {
        nv = cv > cur ? cv : cur;
      } else {  // kPick
        nv = (better >> args.link[a]) & 1ull ? cv : cur;
      }
      s[off] = nv;
      static_cast<double*>(args.out[a])[i] = nv;
    }
  }
  rows[off] = old_rows + ra;
  static_cast<long long*>(args.out[A])[i] = old_rows + ra;
}

}  // namespace

extern "C" {

// kinds / links [A] (host arrays); state [A + 1], chunk [A], out [A + 1]
// (host arrays of device pointers); rows_any [apad] int64, aff_g / aff_w
// [apad] int32.
int gt_flow_merge(int A, const int* kinds, const int* links, void** state,
                  void** chunk, void** out, const long long* rows_any,
                  const int32_t* aff_g, const int32_t* aff_w, long long apad,
                  long long gpad, long long wpad, void* stream) {
  if (A < 0 || A > kMaxAcc) return (int)cudaErrorInvalidValue;
  FlowArgs args;
  args.A = A;
  for (int a = 0; a < A; ++a) {
    args.kind[a] = kinds[a];
    args.link[a] = links[a];
    args.chunk[a] = chunk[a];
  }
  for (int a = 0; a <= A; ++a) {
    args.state[a] = state[a];
    args.out[a] = out[a];
  }
  if (apad > 0) {
    const long long nb = (apad + kThreads - 1) / kThreads;
    flow_merge_kernel<<<(unsigned)nb, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        args, rows_any, aff_g, aff_w, apad, gpad, wpad);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
