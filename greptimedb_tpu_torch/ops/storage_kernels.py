"""The write path's device kernels: extend_merge and grid_scatter.

Hand-written CUDA kernels (``csrc/storage_kernels.cu``) carry the device
side of the resident tables' incremental protocol (``storage/cache.py``,
``storage/grid.py``); each has a plain PyTorch version here.  The
wrappers pick by where the tensors lie: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises — there is no
fallback).  Launches count in ``<wrapper>.launches``, incremented only
where a wrapper launches its kernel.

- ``extend_merge`` replaces the re-sort of an extended DeviceTable in
  the JAX reference (``greptimedb_tpu/storage/cache.py:339-353``: the
  delta written after the resident rows, a stable lexsort by (pad flag,
  tsid, ts) and a gather of every column).  Under the append log's
  precondition (delta timestamps after every resident one, no duplicate
  key) the sort is a merge: the delta is sorted alone by (tsid, ts) on
  ``radix_argsort`` (K6), and one launch writes every column of the new
  padded table.  ``extend_merge_plain`` is the reference's lexsort
  (three stable argsorts) and gather;
- ``grid_scatter`` replaces the delta scatter into the resident
  ``[C, S, T]`` grid (``greptimedb_tpu/storage/grid.py:491-494`` and
  ``:612-614``): the C field planes and the validity plane of n cells in
  one launch, in place, a thread a cell (any distinct cells);
- ``grid_scatter_steps`` is the same scatter for k whole steps of the
  same S series, as ``step_cells`` finds them in an append (a
  transposing tile, so a warp stores consecutive t of one series).

Bounds, design notes and the proof that the merge equals the lexsort
live in the CUDA source.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops.cuda_build import check as _check
from greptimedb_tpu_torch.ops.cuda_build import on_cpu as _on_cpu
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

SOURCE = cuda_build.CSRC / "storage_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_storage.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS
MAX_COLUMNS = 64  # columns of one extend_merge launch (csrc kMaxCols)

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/storage_kernels.cu`` into ``build/kernels/``
    (skipped when the library is newer than its source)."""
    return cuda_build.build_many([(SOURCE, LIBRARY, NVCC_FLAGS)], force)[0]


def _load():
    """Build (if needed) and bind the library once per process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sigs = {
            "gt_extend_offsets": [vp, ll, vp, vp, ll, ll, vp, vp, vp],
            "gt_extend_merge": [vp, i, vp, ll, vp, vp, ll, vp, vp, ll, vp,
                                vp],
            "gt_grid_scatter": [vp, vp, ll, ll, i, vp, vp, vp, vp, ll, vp],
            "gt_grid_scatter_steps": [vp, vp, ll, ll, i, vp, ll, vp, ll,
                                      vp, vp, vp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# extend_merge (K23)
# ---------------------------------------------------------------------------

def pad_bits(value, dtype: torch.dtype) -> int:
    """The bit pattern (as an int64) of one pad element of ``dtype``, so
    the kernel writes exactly what ``torch.full`` writes."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    raw = np.zeros(8, dtype=np.uint8)
    one = np.array([value], dtype=np_dtype).view(np.uint8)
    raw[:one.size] = one
    return int(raw.view(np.int64)[0])


def delta_order_key(tsid, ts, n_series: int):
    """The delta's (tsid, ts) sort key packed into one int64 —
    ``tsid << b | (ts - ts_min)`` with b the bits of the ts span — or
    None when the two do not fit 63 bits together (the caller then sorts
    in two stable passes)."""
    if ts.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=ts.device)
    lo, hi = (int(v) for v in torch.aminmax(ts))
    tbits = (hi - lo).bit_length()
    if tbits + max(int(n_series) - 1, 0).bit_length() > 63:
        return None
    return (tsid.to(torch.int64) << tbits) | (ts - lo)


def grown_table(old_cols: dict, n_old: int, delta_cols: dict,
                new_padded: int, pads: dict):
    """The reference's extended table before its sort: every column grown
    to ``new_padded`` rows with its pad value and the delta written at
    ``[n_old, n_new)``.  Returns (columns, row mask)."""
    n_new = n_old + _delta_rows(delta_cols)
    grown = {}
    for name, col in old_cols.items():
        out = torch.full((new_padded,), pads[name], dtype=col.dtype,
                         device=col.device)
        out[:n_old] = col[:n_old]
        out[n_old:n_new] = delta_cols[name]
        grown[name] = out
    device = next(iter(grown.values())).device
    return grown, torch.arange(new_padded, device=device) < n_new


def extend_merge_plain(old_cols: dict, n_old: int, delta_cols: dict,
                       new_padded: int, pads: dict, *, tsid: str, ts: str):
    """The reference's extend: ``grown_table``, then a stable lexsort by
    (pad flag, tsid, ts) — three stable argsorts, last key first — and a
    gather.  Returns (columns, row mask)."""
    grown, mask = grown_table(old_cols, n_old, delta_cols, new_padded, pads)
    order = torch.argsort(grown[ts], stable=True)
    order = order[torch.argsort(grown[tsid][order], stable=True)]
    order = order[torch.argsort((~mask[order]).to(torch.int8), stable=True)]
    return ({k: torch.index_select(v, 0, order) for k, v in grown.items()},
            mask[order])


def _delta_rows(delta_cols: dict) -> int:
    return int(next(iter(delta_cols.values())).shape[0]) if delta_cols else 0


def extend_merge(old_cols: dict, n_old: int, delta_cols: dict,
                 new_padded: int, pads: dict, n_series: int, *, tsid: str,
                 ts: str):
    """The extended table of ``old_cols`` (each ``[old_padded]``, live rows
    ``[0, n_old)`` in (tsid, ts) order, pad rows after them) and
    ``delta_cols`` (each ``[dn]``, same names and dtypes, any row order):
    every column at ``new_padded`` rows in (tsid, ts) order with the pad
    rows last (each column's value from ``pads``), and the row mask.
    ``n_series`` bounds the tsids.  Precondition: each delta ts is after
    every resident ts and no (tsid, ts) repeats — then the result equals
    ``extend_merge_plain`` row for row.  Returns (columns, row mask)."""
    names = list(old_cols)
    if set(delta_cols) != set(names) or tsid not in names or ts not in names:
        raise ValueError("extend_merge: the delta needs the table's columns "
                         f"(table {sorted(names)}, delta "
                         f"{sorted(delta_cols)})")
    if len(names) > MAX_COLUMNS:
        raise ValueError(f"extend_merge: {len(names)} columns exceed "
                         f"{MAX_COLUMNS}")
    dn = _delta_rows(delta_cols)
    old_padded = int(old_cols[tsid].shape[0])
    if not 0 <= n_old <= old_padded or new_padded < n_old + dn:
        raise ValueError(f"extend_merge: {n_old} + {dn} rows do not fit "
                         f"{new_padded}")
    for name in names:
        o, d = old_cols[name], delta_cols[name]
        if o.dim() != 1 or d.dim() != 1 or o.dtype != d.dtype:
            raise ValueError(f"extend_merge: column {name!r} wants [N] and "
                             f"[dn] of one dtype ({o.dtype}, {d.dtype})")
    if old_cols[tsid].dtype != torch.int32 or old_cols[ts].dtype != torch.int64:
        raise ValueError("extend_merge: tsid int32 and ts int64")
    if _on_cpu("extend_merge", *old_cols.values(), *delta_cols.values()):
        return extend_merge_plain(old_cols, n_old, delta_cols, new_padded,
                                  pads, tsid=tsid, ts=ts)
    from greptimedb_tpu_torch.ops.segment_kernels import radix_argsort

    if new_padded >= 1 << 31:
        raise ValueError(f"extend_merge: {new_padded} rows exceed int32 "
                         f"row indices")
    dev = old_cols[tsid].device
    lib = _load()
    stream = _stream_ptr(old_cols[tsid])
    dtsid = delta_cols[tsid].contiguous()
    dts = delta_cols[ts].contiguous()
    key = delta_order_key(dtsid, dts, n_series)
    if key is not None:
        order = radix_argsort(key)
    else:
        # the key span needs two stable passes: by ts, then by tsid
        first = radix_argsort(dts)
        order = first[radix_argsort(dtsid[first]).long()]
    order = order.contiguous()
    entries = int(n_series) + 1
    R = torch.empty(entries, dtype=torch.int64, device=dev)
    D = torch.empty(entries, dtype=torch.int64, device=dev)
    _check(lib.gt_extend_offsets(old_cols[tsid].data_ptr(), n_old,
                                 dtsid.data_ptr(), order.data_ptr(), dn,
                                 entries, R.data_ptr(), D.data_ptr(), stream),
           "extend_merge (offsets)")
    out, desc = {}, []
    keep = []  # contiguous copies must outlive the launch
    for name in names:
        o = old_cols[name].contiguous()
        d = delta_cols[name].contiguous()
        keep += [o, d]
        out[name] = torch.empty(new_padded, dtype=o.dtype, device=dev)
        desc += [o.data_ptr(), d.data_ptr() if dn else 0,
                 out[name].data_ptr(), o.element_size(),
                 pad_bits(pads[name], o.dtype)]
    desc_t = torch.tensor(desc, dtype=torch.int64).to(dev, non_blocking=True)
    mask = torch.empty(new_padded, dtype=torch.bool, device=dev)
    rc = lib.gt_extend_merge(desc_t.data_ptr(), len(names),
                             old_cols[tsid].data_ptr(), n_old,
                             dtsid.data_ptr(), order.data_ptr(), dn,
                             R.data_ptr(), D.data_ptr(), new_padded,
                             mask.data_ptr(), stream)
    extend_merge.launches += 1
    _check(rc, "extend_merge")
    return out, mask


extend_merge.launches = 0


# ---------------------------------------------------------------------------
# grid_scatter (K24)
# ---------------------------------------------------------------------------

STEPS_MIN = 8  # steps of grid_scatter_steps: a series' run fills a sector


def _first_change(a: np.ndarray) -> int:
    """The first index i with ``a[i] != a[0]`` (``len(a)`` when none),
    searched in windows that grow fourfold, so a short first run costs a
    short read."""
    lo, width = 1, 1 << 14
    while lo < len(a):
        hit = np.flatnonzero(a[lo:lo + width] != a[0])
        if len(hit):
            return lo + int(hit[0])
        lo, width = lo + width, width * 4
    return len(a)


def step_cells(tsid: np.ndarray, tidx: np.ndarray):
    """The cells ``(tsid[i], tidx[i])`` as k whole steps of one series
    sequence, or None: ``(seq, steps)`` when the n cells are ``k =
    len(steps) >= STEPS_MIN`` rows of ``S = len(seq)`` cells, cell
    ``r * S + p`` being ``(seq[p], steps[r])``, with ``steps`` strictly
    increasing — an append that brings every series once a step, in time
    order.  Host numpy: O(1) reads of the rows' ends first (a delta in
    (tsid, ts) order, a catch-up part, fails there), then one compare of
    each array with itself shifted (a row's tidx against its neighbour's,
    a row's tsid against the row before's); a ragged step, rows whose
    series sequence differs, repeated or decreasing steps, or fewer than
    ``STEPS_MIN`` steps give None (``grid_scatter``'s cells)."""
    n = len(tidx)
    if n == 0 or len(tsid) != n:
        return None
    s = _first_change(tidx)
    if s == n or n % s or n // s < STEPS_MIN:
        return None
    # the last row starts and ends as the first and holds one step
    if (tsid[n - s] != tsid[0] or tsid[n - 1] != tsid[s - 1]
            or tidx[n - s] != tidx[n - 1]):
        return None
    steps = tidx[::s]
    if not bool((steps[1:] > steps[:-1]).all()):
        return None
    inside = tidx[1:] != tidx[:-1]  # a change of step, allowed at a row end
    inside[s - 1::s] = False
    if inside.any() or not np.array_equal(tsid[s:], tsid[:-s]):
        return None
    return np.ascontiguousarray(tsid[:s]), np.ascontiguousarray(steps)


def _check_grid(name, values, valid) -> None:
    if (values.dim() != 3 or values.dtype != torch.float32
            or valid.dtype != torch.bool
            or tuple(valid.shape) != tuple(values.shape[1:])):
        raise ValueError(f"{name}: values f32 [C, S, T] and valid bool "
                         f"[S, T]")


def grid_scatter_plain(values, valid, tsid, tidx, delta, flags) -> None:
    values[:, tsid, tidx] = delta
    valid[tsid, tidx] = flags


def grid_scatter(values, valid, tsid, tidx, delta, flags) -> None:
    """In place: ``values[:, tsid[i], tidx[i]] = delta[:, i]`` and
    ``valid[tsid[i], tidx[i]] = flags[i]`` for the n cells of one delta
    (``values`` f32 ``[C, S, T]``, ``valid`` bool ``[S, T]``, ``tsid`` /
    ``tidx`` int64 ``[n]``, ``delta`` f32 ``[C, n]``, ``flags`` bool
    ``[n]``).  The cells must be distinct."""
    _check_grid("grid_scatter", values, valid)
    c, n = values.shape[0], tsid.shape[0]
    if (tidx.shape != tsid.shape or tuple(delta.shape) != (c, n)
            or flags.shape != tsid.shape or delta.dtype != torch.float32
            or tsid.dtype != torch.int64 or tidx.dtype != torch.int64
            or flags.dtype != torch.bool):
        raise ValueError("grid_scatter: tsid / tidx int64 [n], delta f32 "
                         "[C, n], flags bool [n]")
    if _on_cpu("grid_scatter", values, valid, tsid, tidx, delta, flags):
        return grid_scatter_plain(values, valid, tsid, tidx, delta, flags)
    if not (values.is_contiguous() and valid.is_contiguous()):
        raise ValueError("grid_scatter: values and valid must be contiguous")
    tsid, tidx = tsid.contiguous(), tidx.contiguous()
    delta, flags = delta.contiguous(), flags.contiguous()
    spad, tpad = valid.shape
    rc = _load().gt_grid_scatter(values.data_ptr(), valid.data_ptr(),
                                 spad * tpad, tpad, c, tsid.data_ptr(),
                                 tidx.data_ptr(), delta.data_ptr(),
                                 flags.data_ptr(), n, _stream_ptr(values))
    grid_scatter.launches += 1
    _check(rc, "grid_scatter")


grid_scatter.launches = 0


def grid_scatter_steps_plain(values, valid, seq, steps, delta,
                             flags) -> None:
    grid_scatter_plain(values, valid, seq.repeat(steps.shape[0]),
                       steps.repeat_interleave(seq.shape[0]), delta, flags)


def grid_scatter_steps(values, valid, seq, steps, delta, flags) -> None:
    """``grid_scatter`` of k whole steps of one series sequence, as
    ``step_cells`` finds them: ``seq`` int64 ``[S]``, ``steps`` int64
    ``[k]`` strictly increasing, n = k * S and cell ``r * S + p`` is
    ``(seq[p], steps[r])`` (``delta`` f32 ``[C, n]``, ``flags`` bool
    ``[n]``).  The series must be distinct."""
    _check_grid("grid_scatter_steps", values, valid)
    c, n = values.shape[0], seq.shape[0] * steps.shape[0]
    if (seq.dim() != 1 or steps.dim() != 1
            or tuple(delta.shape) != (c, n) or tuple(flags.shape) != (n,)
            or delta.dtype != torch.float32 or seq.dtype != torch.int64
            or steps.dtype != torch.int64 or flags.dtype != torch.bool):
        raise ValueError("grid_scatter_steps: seq int64 [S], steps int64 "
                         "[k], delta f32 [C, k * S], flags bool [k * S]")
    if _on_cpu("grid_scatter_steps", values, valid, seq, steps, delta,
               flags):
        return grid_scatter_steps_plain(values, valid, seq, steps, delta,
                                        flags)
    if not (values.is_contiguous() and valid.is_contiguous()):
        raise ValueError("grid_scatter_steps: values and valid must be "
                         "contiguous")
    seq, steps = seq.contiguous(), steps.contiguous()
    delta, flags = delta.contiguous(), flags.contiguous()
    spad, tpad = valid.shape
    rc = _load().gt_grid_scatter_steps(
        values.data_ptr(), valid.data_ptr(), spad * tpad, tpad, c,
        seq.data_ptr(), seq.shape[0], steps.data_ptr(), steps.shape[0],
        delta.data_ptr(), flags.data_ptr(), _stream_ptr(values))
    grid_scatter_steps.launches += 1
    _check(rc, "grid_scatter_steps")


grid_scatter_steps.launches = 0


def reset_launch_counts() -> None:
    extend_merge.launches = 0
    grid_scatter.launches = 0
    grid_scatter_steps.launches = 0
