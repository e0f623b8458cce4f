// Hand-written Hopper kernels of the write path's device side: extending a
// resident DeviceTable and a resident dense grid in place of a rebuild.
//
// Built by greptimedb_tpu_torch/ops/storage_kernels.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o build/kernels/libgreptime_storage.so
//        storage_kernels.cu
// and bound with ctypes (plain C entry points, no PyTorch headers).  Every
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.
//
// extend_merge (extend_offsets + extend_merge_kernel)
//   Replaces the JAX reference's re-sort of an extended DeviceTable
//   (greptimedb_tpu/storage/cache.py:339-353 `extend_device_table`): the
//   delta written at rows [n_old, n_new) of the padded table, then a stable
//   `jnp.lexsort((ts, tsid, ~mask))` over every padded row and a gather of
//   every column by that order.
//   Precondition (the region's append log, storage/region.py `write`):
//   every delta timestamp is strictly after every resident one, and the
//   delta holds no duplicate (tsid, ts).  The resident live rows
//   [0, n_old) are in (tsid, ts) order (a build's scan order, or an
//   earlier extend's), and its pad rows hold each column's pad value.
//   Why a merge equals the lexsort, row for row:
//   - the primary key ~mask puts the n_new live rows first and the pad
//     rows after them; the pad rows are identical in every column (each
//     column's pad value, mask False), so their relative order, the one
//     thing a stable sort decides among equal keys, cannot be seen;
//   - among live rows the key (tsid, ts) is unique (resident keys are
//     unique, delta keys are unique, and a delta ts exceeds every resident
//     ts), so the sorted order of the live rows is the only order, and
//     stability plays no part;
//   - a resident row i of tsid t is preceded by the i resident rows before
//     it and by the delta rows of smaller tsid, D[t] of them (a delta row
//     of the same tsid has a later ts): it goes to i + D[t];
//   - the delta row of sorted rank j (the delta sorted alone by (tsid, ts))
//     and tsid t is preceded by the j delta rows before it and by every
//     resident row of tsid <= t, R[t + 1] of them: it goes to R[t + 1] + j;
//   - rows [n_new, new_padded) are pad rows.
//   These destinations are a bijection onto [0, new_padded).  R[t] is the
//   first resident row of tsid t (a lower bound over the sorted resident
//   tsids), D[t] the first sorted delta rank of tsid t (a lower bound over
//   the delta's tsids read through its order); both tables hold n_series
//   + 1 entries and are written by extend_offsets, one thread an entry.
//   The delta's order comes from radix_argsort (segment_kernels.cu) of a
//   packed (tsid, ts) key in the wrapper.
//   extend_merge_kernel: one thread a source item k of [0, new_padded):
//   k < n_old is resident row k, k < n_new is the delta row of sorted rank
//   k - n_old (read at order[k - n_old]), the rest pad rows; the thread
//   finds the item's destination once, then copies that row of every
//   column (a descriptor table in shared memory: old pointer, delta
//   pointer, output pointer, element width 1, 2, 4 or 8 bytes, pad bits)
//   and writes the row mask.  One launch takes all columns.  Resident rows
//   read and write in runs (a series' rows keep one shift D[t]), so a
//   warp's loads and stores coalesce; delta rows gather by their order.
//   Bound: bytes.  The old table read once, the delta once and the new
//   table written once: at TSBS (ts 8, tsid 4, 10 x f32, hostname 4,
//   mask 1 = 57 B a row; 35.65 M rows in, 37.75 M out) ~4.2 GB, ~1.2 ms
//   at 3.35 TB/s.
//
// grid_scatter
//   Replaces the delta scatter into the resident [C, S, T] grid of the JAX
//   reference (greptimedb_tpu/storage/grid.py:491-494 `extend_grid_table`
//   and :612-614 `catch_up_grid_table`): `values.at[:, tsid, tidx].set(
//   delta)` and `valid.at[tsid, tidx].set(flags)`.  Cells of one scatter
//   are distinct (the append log's precondition; an SST part holds one row
//   a key), so no two threads write one cell and the write order cannot
//   change the result.  Two kernels, one wrapper each, picked by the
//   caller from the cells' shape:
//   - cells (grid_scatter_kernel, the wrapper grid_scatter): one thread a
//     delta cell, in the delta's order: the offset tsid[i] * tpad +
//     tidx[i] in 64 bits, then the C field planes (plane c at c * spad *
//     tpad) and the validity plane.  A delta in (tsid, ts) order (a
//     catch-up part read from an SST) stores consecutive t of one series
//     from consecutive threads.  Bound: bytes, the delta read once (C f32
//     values, two int64 indices and a flag a cell) and n x (4C + 1) bytes
//     written.
//   - steps (grid_scatter_steps_kernel, the wrapper grid_scatter_steps):
//     the cells of k whole steps, cell r * S + p = (seq[p], steps[r]), as
//     an append of every series once a step arrives (time-major:
//     neighbouring cells are neighbouring series, one row of T apart, so
//     the cells kernel gives each 4-byte store its own 32-byte sector).  A
//     block takes a tile of 32 steps x 32 series of one plane: it reads
//     the tile coalesced along the series into shared memory and writes it
//     back transposed, so a warp stores 32 consecutive t of one series
//     (128 bytes, whole sectors: where the steps are consecutive the step
//     tiles start at a multiple of 32 in t, and a grid row starts at a
//     multiple of 256 bytes).  Planes are the grid's third dimension (the
//     C field planes, then the validity plane).  Bound: bytes, the delta
//     and the flags read once, seq and steps (S + k int64, no index a
//     cell) and n x (4C + 1) bytes written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 64;   // columns of one extend_merge launch
constexpr int kDescWords = 5;  // old, delta, out, width, pad bits

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// first index j of [0, n) with key(j) >= t, keys nondecreasing
template <typename Key>
__device__ long long lower_bound(long long n, long long t, Key key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if ((long long)key(mid) < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void extend_offsets_kernel(const int* __restrict__ old_tsid,
                                      long long n_old,
                                      const int* __restrict__ delta_tsid,
                                      const int* __restrict__ order,
                                      long long dn, long long entries,
                                      long long* __restrict__ R,
                                      long long* __restrict__ D) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= entries) return;
  R[t] = lower_bound(n_old, t, [&](long long i) { return old_tsid[i]; });
  D[t] = lower_bound(dn, t,
                     [&](long long j) { return delta_tsid[order[j]]; });
}

__device__ __forceinline__ void copy_elem(const void* src, long long si,
                                          void* dst, long long di, int w) {
  switch (w) {
    case 1:
      static_cast<uint8_t*>(dst)[di] = static_cast<const uint8_t*>(src)[si];
      break;
    case 2:
      static_cast<uint16_t*>(dst)[di] =
          static_cast<const uint16_t*>(src)[si];
      break;
    case 4:
      static_cast<uint32_t*>(dst)[di] =
          static_cast<const uint32_t*>(src)[si];
      break;
    default:
      static_cast<uint64_t*>(dst)[di] =
          static_cast<const uint64_t*>(src)[si];
      break;
  }
}

__device__ __forceinline__ void set_elem(void* dst, long long di, int w,
                                         unsigned long long bits) {
  switch (w) {
    case 1: static_cast<uint8_t*>(dst)[di] = (uint8_t)bits; break;
    case 2: static_cast<uint16_t*>(dst)[di] = (uint16_t)bits; break;
    case 4: static_cast<uint32_t*>(dst)[di] = (uint32_t)bits; break;
    default: static_cast<uint64_t*>(dst)[di] = (uint64_t)bits; break;
  }
}

__global__ void extend_merge_kernel(const long long* __restrict__ desc,
                                    int ncols,
                                    const int* __restrict__ old_tsid,
                                    long long n_old,
                                    const int* __restrict__ delta_tsid,
                                    const int* __restrict__ order,
                                    long long dn,
                                    const long long* __restrict__ R,
                                    const long long* __restrict__ D,
                                    long long new_padded,
                                    uint8_t* __restrict__ mask_out) {
  __shared__ long long sd[kMaxCols * kDescWords];
  for (int i = threadIdx.x; i < ncols * kDescWords; i += blockDim.x)
    sd[i] = desc[i];
  __syncthreads();
  const long long n_new = n_old + dn;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < new_padded; k += stride) {
    if (k < n_old) {
      const long long dest = k + D[old_tsid[k]];
      for (int c = 0; c < ncols; ++c) {
        const long long* d = sd + c * kDescWords;
        copy_elem((const void*)d[0], k, (void*)d[2], dest, (int)d[3]);
      }
      mask_out[dest] = 1;
    } else if (k < n_new) {
      const long long j = k - n_old;
      const long long src = order[j];
      const long long dest = R[delta_tsid[src] + 1] + j;
      for (int c = 0; c < ncols; ++c) {
        const long long* d = sd + c * kDescWords;
        copy_elem((const void*)d[1], src, (void*)d[2], dest, (int)d[3]);
      }
      mask_out[dest] = 1;
    } else {
      for (int c = 0; c < ncols; ++c) {
        const long long* d = sd + c * kDescWords;
        set_elem((void*)d[2], k, (int)d[3], (unsigned long long)d[4]);
      }
      mask_out[k] = 0;
    }
  }
}

__global__ void grid_scatter_kernel(float* __restrict__ values,
                                    uint8_t* __restrict__ valid,
                                    long long plane, long long tpad, int C,
                                    const long long* __restrict__ tsid,
                                    const long long* __restrict__ tidx,
                                    const float* __restrict__ delta,
                                    const uint8_t* __restrict__ flags,
                                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long off = tsid[i] * tpad + tidx[i];
  for (int c = 0; c < C; ++c)
    values[(long long)c * plane + off] = delta[(long long)c * n + i];
  valid[off] = flags[i];
}

constexpr int kStepTile = 32;  // steps and series of a steps-route tile

// Plane blockIdx.z (< C: field plane, C: the validity plane) of the tile of
// series [32 bx, 32 bx + 32) and steps [32 by - shift, 32 by - shift + 32)
// (clipped to [0, S) and [0, k)), blockIdx.x = by * series_tiles + bx.
// shift = steps[0] mod 32 where the steps are consecutive (steps are
// strictly increasing: consecutive when steps[k - 1] - steps[0] = k - 1),
// else 0; the grid holds ceil((k + 31) / 32) step tiles, enough for any
// shift.  Threads: 32 x 8.
__global__ void __launch_bounds__(kStepTile * 8)
    grid_scatter_steps_kernel(float* __restrict__ values,
                              uint8_t* __restrict__ valid, long long plane,
                              long long tpad, int C,
                              const long long* __restrict__ seq, long long S,
                              const long long* __restrict__ steps,
                              long long k, long long series_tiles,
                              const float* __restrict__ delta,
                              const uint8_t* __restrict__ flags) {
  __shared__ float tile[kStepTile][kStepTile + 1];  // [step][series]
  __shared__ uint8_t ftile[kStepTile][kStepTile + 1];
  __shared__ long long row[kStepTile];  // seq[p] * tpad
  __shared__ long long col[kStepTile];  // steps[r]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long s0 = steps[0];
  const int shift = steps[k - 1] - s0 == k - 1 ? (int)(s0 % kStepTile) : 0;
  const long long p0 = (long long)(blockIdx.x % series_tiles) * kStepTile;
  const long long r0 =
      (long long)(blockIdx.x / series_tiles) * kStepTile - shift;
  const int c = blockIdx.z;
  const long long n = k * S;
  if (ty == 0) {
    const long long p = p0 + tx, r = r0 + tx;
    row[tx] = p < S ? seq[p] * tpad : 0;
    col[tx] = r >= 0 && r < k ? steps[r] : 0;
  }
  // read: warp ty takes steps ty, ty + 8, ...; lane tx the series p0 + tx
  const long long p = p0 + tx;
  for (int rr = ty; rr < kStepTile; rr += 8) {
    const long long r = r0 + rr;
    if (r >= 0 && r < k && p < S) {
      const long long i = r * S + p;
      if (c < C) {
        tile[rr][tx] = delta[(long long)c * n + i];
      } else {
        ftile[rr][tx] = flags[i];
      }
    }
  }
  __syncthreads();
  // write: warp ty takes series ty, ty + 8, ...; lane tx the step r0 + tx
  const long long r = r0 + tx;
  if (r < 0 || r >= k) return;
  for (int pp = ty; pp < kStepTile; pp += 8) {
    if (p0 + pp >= S) break;
    const long long off = row[pp] + col[tx];
    if (c < C) {
      values[(long long)c * plane + off] = tile[tx][pp];
    } else {
      valid[off] = ftile[tx][pp];
    }
  }
}

}  // namespace

extern "C" {

int gt_extend_offsets(const int* old_tsid, long long n_old,
                      const int* delta_tsid, const int* order, long long dn,
                      long long entries, long long* R, long long* D,
                      void* stream) {
  if (entries <= 0) return (int)cudaGetLastError();
  extend_offsets_kernel<<<blocks_for(entries), kThreads, 0,
                          (cudaStream_t)stream>>>(
      old_tsid, n_old, delta_tsid, order, dn, entries, R, D);
  return (int)cudaGetLastError();
}

int gt_extend_merge(const long long* desc, int ncols, const int* old_tsid,
                    long long n_old, const int* delta_tsid, const int* order,
                    long long dn, const long long* R, const long long* D,
                    long long new_padded, uint8_t* mask_out, void* stream) {
  if (ncols > kMaxCols || ncols < 0) return (int)cudaErrorInvalidValue;
  if (new_padded <= 0) return (int)cudaGetLastError();
  extend_merge_kernel<<<blocks_for(new_padded), kThreads, 0,
                        (cudaStream_t)stream>>>(
      desc, ncols, old_tsid, n_old, delta_tsid, order, dn, R, D, new_padded,
      mask_out);
  return (int)cudaGetLastError();
}

int gt_grid_scatter(float* values, uint8_t* valid, long long plane,
                    long long tpad, int C, const long long* tsid,
                    const long long* tidx, const float* delta,
                    const uint8_t* flags, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  grid_scatter_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      values, valid, plane, tpad, C, tsid, tidx, delta, flags, n);
  return (int)cudaGetLastError();
}

// The steps route: n = k * S cells, cell r * S + p = (seq[p], steps[r]),
// steps strictly increasing; delta [C, n], flags [n].
int gt_grid_scatter_steps(float* values, uint8_t* valid, long long plane,
                          long long tpad, int C, const long long* seq,
                          long long S, const long long* steps, long long k,
                          const float* delta, const uint8_t* flags,
                          void* stream) {
  if (S <= 0 || k <= 0) return (int)cudaGetLastError();
  const long long series_tiles = (S + kStepTile - 1) / kStepTile;
  const long long tiles =
      series_tiles * ((k + 2 * kStepTile - 2) / kStepTile);
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, (unsigned)(C + 1));
  grid_scatter_steps_kernel<<<grid, dim3(kStepTile, 8), 0,
                              (cudaStream_t)stream>>>(
      values, valid, plane, tpad, C, seq, S, steps, k, series_tiles, delta,
      flags);
  return (int)cudaGetLastError();
}

}  // extern "C"
