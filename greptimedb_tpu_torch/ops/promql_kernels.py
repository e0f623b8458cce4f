"""The PromQL kernels: prefix_scan, sort_layout, the count geometry's
series_ranges and gather_ts_mat, and the window kernels.

Hand-written CUDA kernels (``csrc/promql_kernels.cu``) carry the device
work of the PromQL range-vector path; each has a plain PyTorch version
here.  The wrappers pick by where the tensors lie: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises — there is no
fallback).  Each wrapper counts its launches in ``<wrapper>.launches``,
incremented only where it launches its kernel.

- ``prefix_scan`` (the f64 scan with the counter-reset drop fused in)
  replaces the cumulative sums of the JAX reference's window body
  (``greptimedb_tpu/promql/engine.py:405-425``): one single-pass
  look-back scan launch, bit-for-bit repeatable.
- ``sort_layout`` replaces K8, ``_build_sort_layout`` (``engine.py:257``).
  Two routes: a table whose valid keys are already non-decreasing in row
  order (every resident DeviceTable) takes one stable-partition pass
  (``sort_layout.presorted``); any other input an LSD radix sort on
  8-bit digits, one pass a digit (``sort_layout.general``; its passes
  count there, not under ``radix_argsort``).
- ``counter_window`` replaces K9's searchsorted geometry
  (``engine.py:288``), K10's ``counter``/``instant`` kinds (``:383``) and,
  in rate mode, the ``_extrapolated`` epilogue (``:1839``) of K11.
- ``series_ranges`` and ``gather_ts_mat`` replace the rest of K9,
  ``_series_ranges`` (``:348``) and ``_gather_ts_mat`` (``:360``): the
  state of the count geometry (``:313-328``), which ``counter_window``,
  ``window_stats`` and ``minmax_window`` take through ``bounds`` in place
  of their binary searches, with the same integer bounds.
- ``window_stats`` replaces K10's other kinds (``gauge_window``,
  ``counter_rc``, ``regression``, ``irate``; ``engine.py:455-499``): it
  sums each window directly in f64 where the reference differences
  full-table f64 prefix sums.
- ``minmax_window`` replaces K13, the ``minmax`` kind's ``fori_loop`` of
  scatter-min/max passes (``engine.py:500-535``).
- ``window_count_max`` and ``window_matrix`` replace K14,
  ``_count_max_kernel`` (``engine.py:541``) and ``_matrix_kernel``
  (``:555``: per-window sorts for quantile/mad, the Holt scan).
- ``window_matrix_dense`` runs the same sorts over a subquery's ``[S, T,
  K]`` window matrix: the quantile/mad reducers of
  ``_eval_subquery_window`` (``:1415-1437``).
- ``subquery_counter`` replaces ``_eval_subquery_counter`` (``:1309-1363``:
  the first/last gathers, the counter-drop loop and ``_extrapolated``).

Bounds and design notes live in the CUDA source.  Its library builds with
``-fmad=false`` (see ``csrc/promql_kernels.cu``).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops.cuda_build import check as _check
from greptimedb_tpu_torch.ops.cuda_build import on_cpu as _on_cpu
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

SOURCE = cuda_build.CSRC / "promql_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_promql.so"
NVCC_FLAGS = [*cuda_build.BASE_FLAGS, "-fmad=false"]
I64_MAX = (1 << 63) - 1
# sort_layout's pass 1: rows a segment (csrc kSegRows), segments a block
# (kLayoutWarps), bytes of a block summary (sizeof(SegSum)), int64 scalars
_LAYOUT_SEG = 1024
_LAYOUT_BLOCK_SEGS = 8
_SEG_BYTES = 64
_SCAL_WORDS = 5
# counter_window modes (csrc WindowMode) and the outputs each one writes
_MODES = {"instant": 0, "counter": 1, "rate": 2}
KIND_KEYS = {
    "instant": ("count", "last", "last_ts"),
    "counter": ("count", "first_ts", "last_ts", "first_val", "last_val",
                "delta_adj", "delta_raw"),
    "counter_rc": ("count", "resets", "changes"),
    "gauge_window": ("count", "sum", "avg", "var", "last", "first",
                     "first_ts", "last_ts"),
    "regression": ("count", "slope", "intercept", "last_ts"),
    "irate": ("last_ts", "prev_ts", "last_val", "prev_val"),
    "minmax": ("min", "max"),
}
# window_stats kinds (csrc StatsKind) and window_matrix modes (MatrixMode)
_STATS_KINDS = {"gauge_window": 0, "counter_rc": 1, "regression": 2,
                "irate": 3}
_MATRIX_MODES = {"quantile": 0, "mad": 1, "holt": 2}
# subquery_counter modes (csrc SubqueryMode)
_SUBQ_MODES = {"rate": 0, "pair": 1}
# widest window (keys, a power of two) a warp sorts in shared memory; wider
# windows sort in a global scratch of at most _SCRATCH_BYTES
SMEM_WIDTH = 1 << 14
_SCRATCH_BYTES = 1 << 28

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/promql_kernels.cu`` into ``build/kernels/`` (skipped
    when the library is newer than its source)."""
    return cuda_build.build_many([(SOURCE, LIBRARY, NVCC_FLAGS)], force)[0]


def _load():
    """Build (if needed) and bind the library once per process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, i, d = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_double)
        sigs = {
            "gt_scan_drop_f64": [vp, vp, vp, ll, vp, vp, vp],
            "gt_layout_scan": [vp, vp, vp, vp, ll, vp, vp, vp, vp, vp],
            "gt_layout_partition": [vp, vp, vp, vp, ll, vp, vp, vp, vp, vp,
                                    vp, vp, vp, vp],
            "gt_layout_key": [vp, vp, vp, vp, ll, vp, i, vp, vp, vp],
            "gt_radix_pass": [vp, vp, ll, i, i, vp, vp, vp, vp, vp],
            "gt_layout_gather": [vp, vp, vp, vp, vp, ll, vp, vp, vp, vp, vp,
                                 vp, vp],
            "gt_series_ranges": [vp, ll, vp, vp, ll, vp, vp, vp, vp],
            "gt_gather_ts_mat": [vp, vp, vp, ll, ll, vp, vp],
            "gt_counter_window": [vp, vp, vp, vp, ll, vp, vp, vp, ll, ll, ll,
                                  ll, ll, vp, vp, ll, i, i, i, d]
            + [vp] * 10,
            "gt_window_stats": [vp, vp, vp, ll, vp, vp, vp, ll, ll, ll, ll,
                                ll, vp, vp, ll, i] + [vp] * 16,
            "gt_minmax_window": [vp, vp, ll, vp, vp, vp, ll, ll, ll, ll, ll,
                                 vp, vp, ll, vp, vp, vp],
            "gt_window_count_max": [vp, ll, vp, vp, vp, ll, ll, ll, ll, ll,
                                    vp, vp],
            "gt_window_matrix": [vp, vp, ll, vp, vp, vp, ll, ll, ll, ll, ll,
                                 i, i, vp, vp, vp, i, vp, vp],
            "gt_window_matrix_dense": [vp, ll, ll, ll, i, i, vp, vp, i, vp,
                                       vp],
            "gt_subquery_counter": [vp, ll, ll, ll, vp, vp, i, i, i, d]
            + [vp] * 7,
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        _lib = lib
        return lib


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def _flat(what: str, t: torch.Tensor, dtype, n: int | None = None):
    if t.dtype != dtype or t.dim() != 1 or (n is not None and
                                            t.shape[0] != n):
        raise ValueError(f"{what}: want {dtype} [{n if n is not None else 'N'}]"
                         f", got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


# ---------------------------------------------------------------------------
# prefix_scan
# ---------------------------------------------------------------------------

def prefix_scan_plain(val_s, tsid_s, valid_s) -> torch.Tensor:
    """The reference's ``gdrop`` (engine.py:405-410): the f64 cumulative
    sum of counter-reset drops over the sorted layout."""
    prev_same = torch.zeros_like(valid_s)
    prev_same[1:] = ((tsid_s[1:] == tsid_s[:-1]) & valid_s[1:]
                     & valid_s[:-1])
    prev_val = torch.cat([val_s[:1] * 0, val_s[:-1]])
    drop = torch.where(prev_same & (prev_val > val_s), prev_val, 0.0)
    return torch.cumsum(drop.to(torch.float64), 0)


def prefix_scan(val_s, tsid_s, valid_s) -> torch.Tensor:
    """The f64 counter-drop prefix scan: ``gdrop[i]`` = sum over j <= i of
    ``val_s[j-1]`` where rows j-1 and j are valid samples of one series
    and the counter fell (``val_s[j-1] > val_s[j]``), else 0.  Inputs are
    the sorted layout's ``val_s`` f32, ``tsid_s`` i32, ``valid_s`` bool."""
    n = val_s.shape[0]
    val_s = _flat("prefix_scan", val_s, torch.float32)
    tsid_s = _flat("prefix_scan", tsid_s, torch.int32, n)
    valid_s = _flat("prefix_scan", valid_s, torch.bool, n)
    if _on_cpu("prefix_scan", val_s, tsid_s, valid_s):
        return prefix_scan_plain(val_s, tsid_s, valid_s)
    out = torch.empty(n, dtype=torch.float64, device=val_s.device)
    sums = cuda_build.scan_scratch(n, torch.float64, val_s.device)
    rc = _load().gt_scan_drop_f64(
        val_s.data_ptr(), tsid_s.data_ptr(), valid_s.data_ptr(), n,
        sums.data_ptr(), out.data_ptr(), _stream_ptr(val_s))
    prefix_scan.launches += 1
    _check(rc, "prefix_scan")
    return out


prefix_scan.launches = 0


# ---------------------------------------------------------------------------
# sort_layout
# ---------------------------------------------------------------------------

def sort_layout_plain(ts, val, tsid, mask) -> tuple:
    """The reference's ``_build_sort_layout`` (engine.py:257), with a
    stable argsort (``jnp.argsort`` is stable; the invalid rows tie at
    I64_MAX and keep their row order)."""
    valid = mask & ~torch.isnan(val)
    any_valid = valid.any()
    zero = torch.zeros((), dtype=torch.int64, device=ts.device)
    ts_min = torch.where(any_valid, torch.where(valid, ts, I64_MAX).min(),
                         zero)
    ts_max = torch.where(any_valid,
                         torch.where(valid, ts, -(1 << 62)).max(), zero)
    kp = ts_max - ts_min + 2
    key = torch.where(valid, tsid.to(torch.int64) * kp + (ts - ts_min),
                      I64_MAX)
    order = torch.argsort(key, stable=True)
    return (key[order], ts[order], val[order], tsid[order], valid[order],
            ts_min, kp)


def sort_layout(ts, val, tsid, mask) -> tuple:
    """Composite-key stable sort of a resident table: returns
    ``(key_s, ts_s, val_s, tsid_s, valid_s, ts_min, kp)`` with
    ``key = tsid * kp + (ts - ts_min)`` on valid rows (``mask`` and not
    NaN) and I64_MAX on the rest, which sort last in row order; ``ts_min``
    and ``kp`` are 0-d int64 tensors.  Inputs: ``ts`` i64, ``val`` f32,
    ``tsid`` i32 (>= 0 on live rows), ``mask`` bool, each ``[N]``."""
    n = ts.shape[0]
    ts = _flat("sort_layout", ts, torch.int64)
    val = _flat("sort_layout", val, torch.float32, n)
    tsid = _flat("sort_layout", tsid, torch.int32, n)
    mask = _flat("sort_layout", mask, torch.bool, n)
    if _on_cpu("sort_layout", ts, val, tsid, mask):
        return sort_layout_plain(ts, val, tsid, mask)
    return sort_layout_routed(ts, val, tsid, mask)


def sort_layout_routed(ts, val, tsid, mask, allow_presorted: bool = True):
    """``sort_layout``'s kernels on CUDA tensors (checked by the caller).
    Pass 1 finds ts_min, kp and whether the valid keys are non-decreasing
    in row order; the presorted route's one stable-partition pass is
    queued behind it and does nothing unless they are.  Reading the route
    is the one host sync; the general route (8-bit digit passes) follows
    it.
    ``allow_presorted=False`` takes the general route on any table (the
    tests and ``chip_smoke.py`` hold both routes on one table)."""
    n = ts.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"sort_layout: {n} rows exceed int32 row indices")
    dev = ts.device
    lib = _load()
    stream = _stream_ptr(ts)
    nseg = -(-n // _LAYOUT_SEG)
    nblk = max(1, -(-nseg // _LAYOUT_BLOCK_SEGS))
    seg_cnt = torch.empty(max(nseg, 1), dtype=torch.int32, device=dev)
    blk = torch.empty(nblk * _SEG_BYTES, dtype=torch.uint8, device=dev)
    blk_off = torch.empty(nblk, dtype=torch.int64, device=dev)
    scal = torch.empty(_SCAL_WORDS, dtype=torch.int64, device=dev)
    out = (torch.empty(n, dtype=torch.int64, device=dev),
           torch.empty(n, dtype=torch.int64, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    _check(lib.gt_layout_scan(ts.data_ptr(), val.data_ptr(), tsid.data_ptr(),
                              mask.data_ptr(), n, seg_cnt.data_ptr(),
                              blk.data_ptr(), blk_off.data_ptr(),
                              scal.data_ptr(), stream),
           "sort_layout (layout_scan)")
    if allow_presorted:
        # queued before the host reads the route, so the card does not wait
        # on the host; it writes nothing unless the table is presorted
        _check(lib.gt_layout_partition(
            ts.data_ptr(), val.data_ptr(), tsid.data_ptr(), mask.data_ptr(),
            n, seg_cnt.data_ptr(), blk_off.data_ptr(), scal.data_ptr(),
            *(t.data_ptr() for t in out), stream),
            "sort_layout (layout_partition)")
    _ts_min, _kp, invalid_key, presorted, _n_valid = scal.tolist()
    if presorted and allow_presorted:
        sort_layout.launches += 1
        sort_layout.presorted += 1
        return out + (scal[0], scal[1])
    del seg_cnt, blk, blk_off
    # the invalid rows' key is the largest: its bits are the digits needed
    # (the keys stay u64 whatever their width)
    shifts = cuda_build.radix_digits(invalid_key.bit_length())[1]
    key = torch.empty(n, dtype=torch.int64, device=dev)
    hist = torch.empty((len(shifts), cuda_build.RADIX_BINS),
                       dtype=torch.int32, device=dev)
    _check(lib.gt_layout_key(ts.data_ptr(), val.data_ptr(), tsid.data_ptr(),
                             mask.data_ptr(), n, scal.data_ptr(),
                             len(shifts), key.data_ptr(), hist.data_ptr(),
                             stream),
           "sort_layout (layout_key)")
    key2 = torch.empty_like(key) if len(shifts) > 1 else None
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    idx2 = torch.empty_like(idx)
    status = cuda_build.radix_status(n, dev)
    for p, shift in enumerate(shifts):
        last = p == len(shifts) - 1
        _check(lib.gt_radix_pass(key.data_ptr(),
                                 idx.data_ptr() if p else None, n, 1, shift,
                                 hist[p].data_ptr(), status.data_ptr(),
                                 None if last else key2.data_ptr(),
                                 idx2.data_ptr(), stream),
               f"sort_layout (digit at bit {shift})")
        key, key2, idx, idx2 = key2, key, idx2, idx
    del key, key2, idx2, status, hist
    rc = lib.gt_layout_gather(idx.data_ptr(), ts.data_ptr(), val.data_ptr(),
                              tsid.data_ptr(), mask.data_ptr(), n,
                              scal.data_ptr(), *(t.data_ptr() for t in out),
                              stream)
    sort_layout.launches += 1
    sort_layout.general += 1
    _check(rc, "sort_layout (layout_gather)")
    return out + (scal[0], scal[1])


def sort_layout_presorted_plain(ts, val, tsid, mask) -> bool:
    """Whether ``sort_layout``'s presorted route applies: the valid rows'
    keys are non-decreasing in row order and every key fits (tsid >= 0,
    ``(max tsid + 1) * kp`` within int64).  The plain version of pass 1's
    route flag, for the tests' check of the resident tables."""
    valid = mask & ~torch.isnan(val)
    if not bool(valid.any()):
        return True
    t, s = ts[valid], tsid[valid].to(torch.int64)
    kp = int(t.max()) - int(t.min()) + 2
    if int(s.min()) < 0 or int(s.max()) + 1 > I64_MAX // kp:
        return False
    key = s * kp + (t - t.min())
    return bool((key[1:] >= key[:-1]).all())


sort_layout.launches = 0
sort_layout.presorted = 0
sort_layout.general = 0


# ---------------------------------------------------------------------------
# series_ranges + gather_ts_mat: the count geometry's state (K9)
# ---------------------------------------------------------------------------

def series_ranges_plain(key_s, kp, sel):
    """The reference's ``_series_ranges`` (engine.py:348): each selected
    series' rows ``[start, start + cnt)`` of the sorted layout (``start``
    int64, ``cnt`` int32, 0 on pad selections), and the largest count."""
    sel_ok = sel >= 0
    skey = torch.where(sel_ok, sel.to(torch.int64), 0) * kp
    start = torch.searchsorted(key_s, skey, side="left")
    end = torch.searchsorted(key_s, skey + (kp - 1), side="right")
    cnt = torch.where(sel_ok, (end - start).to(torch.int32), 0)
    return start, cnt, int(cnt.max()) if cnt.numel() else 0


def series_ranges(key_s, kp, sel):
    """``(start [S] int64, cnt [S] int32, cnt_max)`` of the selected series
    ``sel`` ``[S]`` int32 (padding -1) over a sort layout's ``key_s`` and
    ``kp``.  ``cnt_max`` is a Python int: reading it is the one host sync
    of the count geometry, as in the reference."""
    key_s = _flat("series_ranges", key_s, torch.int64)
    sel = _flat("series_ranges", sel, torch.int32)
    if _on_cpu("series_ranges", key_s, sel, kp):
        return series_ranges_plain(key_s, kp, sel)
    if kp.dtype != torch.int64:
        raise ValueError("series_ranges: kp must be int64")
    S, dev = sel.shape[0], key_s.device
    start = torch.empty(S, dtype=torch.int64, device=dev)
    cnt = torch.empty(S, dtype=torch.int32, device=dev)
    cnt_max = torch.empty(1, dtype=torch.int32, device=dev)
    rc = _load().gt_series_ranges(
        key_s.data_ptr(), key_s.shape[0], kp.data_ptr(), sel.data_ptr(), S,
        start.data_ptr(), cnt.data_ptr(), cnt_max.data_ptr(),
        _stream_ptr(key_s))
    series_ranges.launches += 1
    _check(rc, "series_ranges")
    return start, cnt, int(cnt_max.item())


series_ranges.launches = 0


def gather_ts_mat_plain(ts_s, start, cnt, L: int):
    """The reference's ``_gather_ts_mat`` (engine.py:360): ``[S, L]`` int64,
    ``ts_s[clip(start + j, 0, n - 1)]`` where ``j < cnt``, else I64_MAX."""
    n = ts_s.shape[0]
    j = torch.arange(L, dtype=torch.int64, device=ts_s.device)
    idx = torch.clamp(start[:, None] + j[None, :], 0, max(n - 1, 0))
    mat = ts_s[idx] if n else torch.zeros(idx.shape, dtype=torch.int64,
                                          device=ts_s.device)
    return torch.where(j[None, :] < cnt[:, None], mat, I64_MAX)


def gather_ts_mat(ts_s, start, cnt, L: int):
    """The count geometry's ``[S, L]`` timestamp matrix of the series rows
    ``series_ranges`` found (padding I64_MAX)."""
    n = ts_s.shape[0]
    ts_s = _flat("gather_ts_mat", ts_s, torch.int64)
    start = _flat("gather_ts_mat", start, torch.int64)
    cnt = _flat("gather_ts_mat", cnt, torch.int32, start.shape[0])
    if L < 1:
        raise ValueError(f"gather_ts_mat: L must be >= 1, got {L}")
    if _on_cpu("gather_ts_mat", ts_s, start, cnt):
        return gather_ts_mat_plain(ts_s, start, cnt, L)
    S = start.shape[0]
    out = torch.empty((S, L), dtype=torch.int64, device=ts_s.device)
    rc = _load().gt_gather_ts_mat(ts_s.data_ptr() if n else None,
                                  start.data_ptr(), cnt.data_ptr(), S, L,
                                  out.data_ptr(), _stream_ptr(ts_s))
    gather_ts_mat.launches += 1
    _check(rc, "gather_ts_mat")
    return out


gather_ts_mat.launches = 0


def _bounds_args(what: str, bounds, S: int):
    """Validated ``(series_start, cnt, ts_mat)`` of the count geometry (or
    None, the searchsorted geometry): ``(tensors, start_ptr, ts_mat_ptr,
    L)`` for a kernel's entry point."""
    if bounds is None:
        return [], None, None, 0
    start, cnt, ts_mat = bounds
    start = _flat(what, start, torch.int64, S)
    cnt = _flat(what, cnt, torch.int32, S)
    if (ts_mat.dtype != torch.int64 or ts_mat.dim() != 2
            or ts_mat.shape[0] != S or ts_mat.shape[1] < 1):
        raise ValueError(f"{what}: ts_mat must be int64 [{S}, L], got "
                         f"{ts_mat.dtype} {tuple(ts_mat.shape)}")
    ts_mat = ts_mat.contiguous()
    return ([start, cnt, ts_mat], start.data_ptr(), ts_mat.data_ptr(),
            ts_mat.shape[1])


# ---------------------------------------------------------------------------
# counter_window
# ---------------------------------------------------------------------------

def window_bounds_plain(key_s, ts_min, kp, sel, start_ms: int, step_ms: int,
                        num_steps: int, range_ms: int, bounds=None):
    """Per (series, step) the half-open sorted-row range ``[lo, hi)`` of
    the left-exclusive window ``(t - range, t]``: the reference's
    searchsorted geometry (engine.py:330-345), or with ``bounds`` =
    ``(series_start, cnt, ts_mat)`` its count geometry (:313-328), which
    gives the same bounds on every selected series (pad rows differ; both
    leave them empty).  Returns ``(lo, hi, cnt, has, sel_ok)``."""
    S = sel.shape[0]
    steps = start_ms + step_ms * torch.arange(num_steps, dtype=torch.int64,
                                              device=key_s.device)
    sel_ok = sel >= 0
    if bounds is not None:
        series_start, _cnt, ts_mat = bounds
        lo_off = (ts_mat[:, None, :] <= (steps - range_ms)[None, :, None]
                  ).sum(-1, dtype=torch.int32)
        hi_off = (ts_mat[:, None, :] <= steps[None, :, None]).sum(
            -1, dtype=torch.int32)
        cnt = hi_off - lo_off
        has = (cnt > 0) & sel_ok[:, None]
        return (series_start[:, None] + lo_off,
                series_start[:, None] + hi_off, cnt, has, sel_ok)
    skey = torch.where(sel_ok, sel.to(torch.int64), 0) * kp
    zero = torch.zeros((), dtype=torch.int64, device=key_s.device)
    rel_lo = torch.minimum(torch.maximum(steps - range_ms + 1 - ts_min, zero),
                           kp - 1)
    rel_hi = torch.minimum(torch.maximum(steps - ts_min, zero - 1), kp - 1)
    lo = torch.searchsorted(
        key_s, (skey[:, None] + rel_lo[None, :]).reshape(-1),
        side="left").reshape(S, num_steps)
    hi = torch.searchsorted(
        key_s, (skey[:, None] + rel_hi[None, :]).reshape(-1),
        side="right").reshape(S, num_steps)
    cnt = torch.clamp(hi - lo, min=0).to(torch.int32)
    has = (cnt > 0) & sel_ok[:, None]
    return lo, hi, cnt, has, sel_ok


def counter_stats_plain(kind, key_s, ts_s, val_s, gdrop, ts_min, kp, sel,
                       start_ms, step_ms, num_steps, range_ms,
                       bounds=None) -> dict:
    """The reference's window body (engine.py:401-454) for the
    ``instant`` and ``counter`` kinds: ``[S, T]`` outputs of KIND_KEYS."""
    n = key_s.shape[0]
    lo, hi, cnt, has, sel_ok = window_bounds_plain(
        key_s, ts_min, kp, sel, start_ms, step_ms, num_steps, range_ms,
        bounds)
    has2 = (cnt >= 2) & sel_ok[:, None]
    first_i = torch.clamp(lo, 0, n - 1)
    last_i = torch.clamp(hi - 1, 0, n - 1)
    nan = float("nan")
    out = {"count": torch.where(has, cnt.to(torch.float32), 0.0)}
    if kind == "instant":
        out["last"] = torch.where(has, val_s[last_i], nan)
        out["last_ts"] = torch.where(has, ts_s[last_i], 0)
        return out
    lv, fv = val_s[last_i], val_s[first_i]
    d_adj = ((lv.to(torch.float64) + gdrop[last_i])
             - (fv.to(torch.float64) + gdrop[first_i])).to(torch.float32)
    out["first_ts"] = torch.where(has, ts_s[first_i], 0)
    out["last_ts"] = torch.where(has, ts_s[last_i], 0)
    out["first_val"] = torch.where(has, fv, nan)
    out["last_val"] = torch.where(has, lv, nan)
    out["delta_adj"] = torch.where(has2, d_adj, nan)
    out["delta_raw"] = torch.where(has2, lv - fv, nan)
    return out


def extrapolated(out: dict, range_s: float, range_end_ms,
                 counter: bool, is_rate: bool) -> torch.Tensor:
    """Prometheus extrapolatedRate (the reference's ``_extrapolated``,
    engine.py:1839).  Every timestamp is cast to float64 first: torch
    computes ``int64 - float`` in float32, which on epoch milliseconds
    (~1.7e12) loses ~1e5 ms; the reference computes it in float64."""
    rng_ms = range_s * 1000.0
    ft = out["first_ts"].to(torch.float64)
    lt = out["last_ts"].to(torch.float64)
    cnt = out["count"]
    delta = out["delta_adj"] if counter else out["delta_raw"]
    range_end = torch.as_tensor(range_end_ms, device=ft.device).to(
        torch.float64)[None, :]
    range_start = range_end - rng_ms
    sampled = (lt - ft) / 1000.0
    avg_dur = sampled / torch.clamp(cnt - 1, min=1)
    dur_to_start = (ft - range_start) / 1000.0
    dur_to_end = (range_end - lt) / 1000.0
    threshold = avg_dur * 1.1
    dur_to_start = torch.where(dur_to_start >= threshold, avg_dur / 2,
                               dur_to_start)
    dur_to_end = torch.where(dur_to_end >= threshold, avg_dur / 2,
                             dur_to_end)
    d64 = delta.to(torch.float64)
    if counter:
        fv = out["first_val"].to(torch.float64)
        dur_to_zero = torch.where(
            d64 > 0, sampled * (fv / torch.clamp(d64, min=1e-30)), math.inf)
        dur_to_start = torch.minimum(dur_to_start, dur_to_zero)
    factor = (sampled + dur_to_start + dur_to_end) / torch.clamp(
        sampled, min=1e-30)
    result = d64 * factor
    if is_rate:
        result = result / range_s
    return torch.where(cnt >= 2, result.to(torch.float32), float("nan"))


def counter_window_plain(layout, gdrop, sel, start_ms, *, step_ms,
                         num_steps, range_ms, kind, func=None, range_s=None,
                         bounds=None):
    key_s, ts_s, val_s, _tsid_s, _valid_s, ts_min, kp = layout
    stats_kind = "counter" if kind == "rate" else kind
    out = counter_stats_plain(stats_kind, key_s, ts_s, val_s, gdrop, ts_min,
                              kp, sel, start_ms, step_ms, num_steps, range_ms,
                              bounds)
    if kind != "rate":
        return out
    range_end = start_ms + step_ms * torch.arange(
        num_steps, dtype=torch.int64, device=key_s.device)
    return extrapolated(out, range_s, range_end, counter=func != "delta",
                        is_rate=func == "rate")


def counter_window(layout, gdrop, sel, start_ms: int, *, step_ms: int,
                   num_steps: int, range_ms: int, kind: str, func=None,
                   range_s: float | None = None, bounds=None):
    """Window statistics of the selected series over a sort layout.

    ``layout`` is ``sort_layout``'s tuple, ``sel`` ``[S]`` int32 selected
    tsids (padding -1), ``gdrop`` the layout's ``prefix_scan`` (the
    ``counter`` and ``rate`` kinds; None for ``instant``).  Windows are
    ``(t - range_ms, t]`` at ``t = start_ms + step_ms * j``, their bounds
    from the searchsorted geometry or, with ``bounds`` = ``(series_start,
    cnt, ts_mat)`` (``series_ranges`` + ``gather_ts_mat``), the count
    geometry.
    ``kind`` ``instant``/``counter`` returns the dict of ``KIND_KEYS`` ``[S,
    T]`` tensors; ``rate`` returns ``[S, T]`` f32 of ``func``
    (rate/increase/delta) over ``range_s`` seconds."""
    if kind not in _MODES:
        raise ValueError(f"counter_window: unknown kind {kind!r}")
    if kind == "rate" and (func not in ("rate", "increase", "delta")
                           or range_s is None):
        raise ValueError("counter_window: rate mode takes func "
                         "rate/increase/delta and range_s")
    key_s, ts_s, val_s, _tsid_s, _valid_s, ts_min, kp = layout
    n = key_s.shape[0]
    key_s = _flat("counter_window", key_s, torch.int64)
    ts_s = _flat("counter_window", ts_s, torch.int64, n)
    val_s = _flat("counter_window", val_s, torch.float32, n)
    sel = _flat("counter_window", sel, torch.int32)
    btensors, bstart, bmat, L = _bounds_args("counter_window", bounds,
                                             sel.shape[0])
    tensors = [key_s, ts_s, val_s, sel, ts_min, kp, *btensors]
    if kind != "instant":
        gdrop = _flat("counter_window", gdrop, torch.float64, n)
        tensors.append(gdrop)
    if _on_cpu("counter_window", *tensors):
        return counter_window_plain(
            (key_s, ts_s, val_s, None, None, ts_min, kp), gdrop, sel,
            start_ms, step_ms=step_ms, num_steps=num_steps,
            range_ms=range_ms, kind=kind, func=func, range_s=range_s,
            bounds=btensors or None)
    S, T, dev = sel.shape[0], int(num_steps), key_s.device
    if ts_min.dtype != torch.int64 or kp.dtype != torch.int64:
        raise ValueError("counter_window: ts_min/kp must be int64")

    def buf(dtype):
        return torch.empty((S, T), dtype=dtype, device=dev)

    f32, i64 = torch.float32, torch.int64
    if kind == "rate":
        outs = {"rate": buf(f32)}
    else:
        outs = {k: buf(i64 if k.endswith("_ts") else f32)
                for k in KIND_KEYS[kind]}
    order = ("count", "first_ts", "last_ts", "first_val", "last_val",
             "delta_adj", "delta_raw", "last", "rate")
    rc = _load().gt_counter_window(
        key_s.data_ptr(), ts_s.data_ptr(), val_s.data_ptr(), _ptr(gdrop), n,
        ts_min.data_ptr(), kp.data_ptr(), sel.data_ptr(), S, T,
        int(start_ms), int(step_ms), int(range_ms), bstart, bmat, L,
        _MODES[kind], int(func != "delta"), int(func == "rate"),
        float(range_s) if range_s is not None else 0.0,
        *(_ptr(outs.get(k)) for k in order), _stream_ptr(key_s))
    counter_window.launches += 1
    _check(rc, "counter_window")
    return outs["rate"] if kind == "rate" else outs


counter_window.launches = 0


# ---------------------------------------------------------------------------
# window_stats: K10's gauge_window, counter_rc, regression and irate kinds
# ---------------------------------------------------------------------------

def _layout_inputs(what, layout, sel):
    """Validated ``(key_s, ts_s, val_s, sel, ts_min, kp)`` of a sort
    layout and a padded selection."""
    key_s, ts_s, val_s, _tsid_s, _valid_s, ts_min, kp = layout
    n = key_s.shape[0]
    key_s = _flat(what, key_s, torch.int64)
    ts_s = _flat(what, ts_s, torch.int64, n)
    val_s = _flat(what, val_s, torch.float32, n)
    sel = _flat(what, sel, torch.int32)
    if ts_min.dtype != torch.int64 or kp.dtype != torch.int64:
        raise ValueError(f"{what}: ts_min/kp must be int64")
    return key_s, ts_s, val_s, sel, ts_min, kp


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums in the association XLA's CPU backend gives
    ``jnp.cumsum``: sequential within blocks of 16, the block totals
    scanned the same way and added.  Window sums are differences of these
    prefixes, so where a window's terms cancel (few samples, near-constant
    values) the association shows; this one repeats the reference's."""
    n = x.shape[0]
    if n <= 16:
        return torch.cumsum(x, 0)
    nb = -(-n // 16)
    loc = torch.cumsum(torch.cat([x, x.new_zeros(nb * 16 - n)]).reshape(
        nb, 16), 1)
    pre = _blocked_cumsum(loc[:, -1])
    pre = torch.cat([pre.new_zeros(1), pre[:-1]])
    return (loc + pre[:, None]).reshape(-1)[:n]


def fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, in f64 (Dekker's exact product and
    Knuth's exact sum): the fused multiply-add that XLA's CPU backend
    contracts the reference's ``q - mean * mean`` into, which decides the
    result where the terms cancel."""
    p = a * b
    split = 134217729.0  # 2^27 + 1
    ta, tb = a * split, b * split
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on f32 values with one rounding to f32 (the f32
    product is exact in f64): the contraction XLA's CPU backend applies to
    the reference's f32 recurrences."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def _cs(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``cs`` (engine.py:416): f64 prefix sums with a
    leading zero."""
    return torch.cat([torch.zeros(1, dtype=torch.float64, device=x.device),
                      _blocked_cumsum(x.to(torch.float64))])


def window_stats_plain(kind, layout, sel, start_ms, *, step_ms, num_steps,
                       range_ms, bounds=None) -> dict:
    """The reference's window body (engine.py:401-499) for the
    ``gauge_window``, ``counter_rc``, ``regression`` and ``irate`` kinds,
    by its full-table f64 prefix-sum differences."""
    key_s, ts_s, val_s, tsid_s, valid_s, ts_min, kp = layout
    n = key_s.shape[0]
    lo, hi, cnt, has, sel_ok = window_bounds_plain(
        key_s, ts_min, kp, sel, start_ms, step_ms, num_steps, range_ms,
        bounds)
    has2 = (cnt >= 2) & sel_ok[:, None]
    first_i = torch.clamp(lo, 0, n - 1)
    last_i = torch.clamp(hi - 1, 0, n - 1)
    fcnt = cnt.to(torch.float32)
    nan = float("nan")
    if kind == "irate":
        prev_i = torch.clamp(hi - 2, 0, n - 1)
        return {"last_ts": torch.where(has2, ts_s[last_i], 0),
                "prev_ts": torch.where(has2, ts_s[prev_i], 0),
                "last_val": torch.where(has2, val_s[last_i], nan),
                "prev_val": torch.where(has2, val_s[prev_i], nan)}
    out = {"count": torch.where(has, fcnt, 0.0)}
    if kind == "counter_rc":
        # indicator i compares rows i-1 and i: the window's pairs are
        # lo+1 .. hi-1, so the pair crossing into the window is left out
        prev_same = torch.zeros_like(valid_s)
        prev_same[1:] = ((tsid_s[1:] == tsid_s[:-1]) & valid_s[1:]
                         & valid_s[:-1])
        prev_val = torch.cat([val_s[:1] * 0, val_s[:-1]])
        cs_r = _cs(prev_same & (prev_val > val_s))
        cs_c = _cs(prev_same & (prev_val != val_s))
        lo1 = torch.clamp(lo + 1, 0, n)
        out["resets"] = torch.where(has, (cs_r[hi] - cs_r[lo1]).float(), nan)
        out["changes"] = torch.where(has, (cs_c[hi] - cs_c[lo1]).float(),
                                     nan)
        return out
    cs_v = _cs(torch.where(valid_s, val_s, 0.0))
    if kind == "gauge_window":
        cs_v2 = _cs(torch.where(valid_s, val_s.to(torch.float64) ** 2, 0.0))
        s = (cs_v[hi] - cs_v[lo]).to(torch.float32)
        c = torch.clamp(cnt, min=1)
        # mean from the f32-rounded sum, var from the f64 square sums
        mean = s.to(torch.float64) / c
        var = fma64(-mean, mean, (cs_v2[hi] - cs_v2[lo]) / c)
        out.update({
            "sum": torch.where(has, s, nan),
            "avg": torch.where(has, s / torch.clamp(fcnt, min=1), nan),
            "var": torch.where(has, torch.clamp(var, min=0.0).float(), nan),
            "last": torch.where(has, val_s[last_i], nan),
            "first": torch.where(has, val_s[first_i], nan),
            "first_ts": torch.where(has, ts_s[first_i], 0),
            "last_ts": torch.where(has, ts_s[last_i], 0)})
        return out
    # regression: seconds relative to this window grid's start
    tsec = (ts_s - start_ms).to(torch.float64) / 1000.0
    cs_t = _cs(torch.where(valid_s, tsec, 0.0))
    cs_tv = _cs(torch.where(valid_s, tsec * val_s.to(torch.float64), 0.0))
    cs_t2 = _cs(torch.where(valid_s, tsec * tsec, 0.0))
    sw = cs_v[hi] - cs_v[lo]
    st = cs_t[hi] - cs_t[lo]
    stv = cs_tv[hi] - cs_tv[lo]
    st2 = cs_t2[hi] - cs_t2[lo]
    cn = cnt.to(torch.float64)
    denom = cn * st2 - st * st
    slope = torch.where(denom != 0, (cn * stv - st * sw) / denom, nan)
    intercept = torch.where(cn > 0, (sw - slope * st) / cn, nan)
    out.update({"slope": torch.where(has2, slope.float(), nan),
                "intercept": torch.where(has2, intercept.float(), nan),
                "last_ts": torch.where(has, ts_s[last_i], 0)})
    return out


def var_slack(val_s, valid_s, cnt, sums) -> torch.Tensor:
    """How far ``window_stats_plain``'s ``var`` may stray from the
    kernel's by the plain version's method alone, per window ``[S, T]``
    (``cnt`` the window counts, ``sums`` the plain version's f32 window
    sums).  Two terms: (1) its square sums are differences of two
    table-wide f64 prefix sums, each built by up to 16 additions per level
    of ``_blocked_cumsum``'s recursion and so off by up to that many
    roundings of the table's total ``sum(v**2)``, divided by the window
    count; (2) ``mean`` comes from the window sum rounded to f32, and the
    kernel's direct sum and the plain version's prefix difference may
    round to neighbouring f32 values: ``var`` then moves by up to
    ``2 * |mean| * ulp(sum) / cnt``."""
    n = val_s.shape[0]
    levels = max(1, math.ceil(math.log(max(n, 2), 16)))
    total = float(torch.where(valid_s, val_s.to(torch.float64) ** 2,
                              0.0).sum())
    c = torch.clamp(cnt, min=1).to(torch.float64)
    a = sums.abs()
    ulp = (torch.nextafter(a, torch.full_like(a, math.inf)) - a).to(
        torch.float64)
    mean = a.to(torch.float64) / c
    return (2 * 16 * levels * torch.finfo(torch.float64).eps * total / c
            + 2 * mean * ulp / c).nan_to_num(0.0)


def window_stats(layout, sel, start_ms: int, *, step_ms: int,
                 num_steps: int, range_ms: int, kind: str,
                 bounds=None) -> dict:
    """Window statistics of ``kind`` (``gauge_window``, ``counter_rc``,
    ``regression``, ``irate``) of the selected series over a sort layout:
    the dict of ``KIND_KEYS[kind]`` ``[S, T]`` tensors (``*_ts`` int64,
    the rest f32), for windows ``(t - range_ms, t]`` at
    ``t = start_ms + step_ms * j``.  ``regression`` measures time in
    seconds from ``start_ms``.  ``bounds``: the count geometry's state, as
    for ``counter_window``."""
    if kind not in _STATS_KINDS:
        raise ValueError(f"window_stats: unknown kind {kind!r}")
    key_s, ts_s, val_s, sel, ts_min, kp = _layout_inputs(
        "window_stats", layout, sel)
    btensors, bstart, bmat, L = _bounds_args("window_stats", bounds,
                                             sel.shape[0])
    if _on_cpu("window_stats", key_s, ts_s, val_s, sel, ts_min, kp,
               *btensors):
        return window_stats_plain(kind, layout, sel, start_ms,
                                  step_ms=step_ms, num_steps=num_steps,
                                  range_ms=range_ms, bounds=btensors or None)
    S, T, n, dev = sel.shape[0], int(num_steps), key_s.shape[0], key_s.device
    outs = {k: torch.empty((S, T), dtype=torch.int64 if k.endswith("_ts")
                           else torch.float32, device=dev)
            for k in KIND_KEYS[kind]}
    order = ("count", "sum", "avg", "var", "last", "first", "first_ts",
             "last_ts", "resets", "changes", "slope", "intercept",
             "prev_ts", "last_val", "prev_val")
    rc = _load().gt_window_stats(
        key_s.data_ptr(), ts_s.data_ptr(), val_s.data_ptr(), n,
        ts_min.data_ptr(), kp.data_ptr(), sel.data_ptr(), S, T,
        int(start_ms), int(step_ms), int(range_ms), bstart, bmat, L,
        _STATS_KINDS[kind],
        *(_ptr(outs.get(k)) for k in order), _stream_ptr(key_s))
    window_stats.launches += 1
    _check(rc, "window_stats")
    return outs


window_stats.launches = 0


# ---------------------------------------------------------------------------
# minmax_window: K13
# ---------------------------------------------------------------------------

def minmax_window_plain(layout, sel, start_ms, *, step_ms, num_steps,
                        range_ms, bounds=None) -> dict:
    """min/max of each window's samples, gathered by the window bounds
    (the reference scatters each sample into every window it falls in;
    the same sets, so the same extremes).  A window without samples, or
    whose extreme is infinite, is NaN, as ``jnp.isfinite`` makes it."""
    key_s, _ts_s, val_s, _tsid_s, _valid_s, ts_min, kp = layout
    n = key_s.shape[0]
    lo, _hi, cnt, has, _sel_ok = window_bounds_plain(
        key_s, ts_min, kp, sel, start_ms, step_ms, num_steps, range_ms,
        bounds)
    width = max(int(cnt.max()) if cnt.numel() else 0, 1)
    j = torch.arange(width, device=key_s.device)
    ok = (j < cnt[..., None]) & has[..., None]
    x = val_s[torch.clamp(lo[..., None] + j, 0, max(n - 1, 0))] if n else \
        torch.zeros(ok.shape, dtype=torch.float32, device=key_s.device)
    inf, nan = float("inf"), float("nan")
    mn = torch.where(ok, x, inf).amin(-1)
    mx = torch.where(ok, x, -inf).amax(-1)
    return {"min": torch.where(torch.isfinite(mn), mn, nan),
            "max": torch.where(torch.isfinite(mx), mx, nan)}


def minmax_window(layout, sel, start_ms: int, *, step_ms: int,
                  num_steps: int, range_ms: int, bounds=None) -> dict:
    """``{"min", "max"}`` ``[S, T]`` f32 of each window ``(t - range_ms,
    t]`` of the selected series over a sort layout (NaN where a window is
    empty or its extreme is infinite).  Exact.  ``bounds``: the count
    geometry's state, as for ``counter_window``."""
    key_s, ts_s, val_s, sel, ts_min, kp = _layout_inputs(
        "minmax_window", layout, sel)
    btensors, bstart, bmat, L = _bounds_args("minmax_window", bounds,
                                             sel.shape[0])
    if _on_cpu("minmax_window", key_s, val_s, sel, ts_min, kp, *btensors):
        return minmax_window_plain(layout, sel, start_ms, step_ms=step_ms,
                                   num_steps=num_steps, range_ms=range_ms,
                                   bounds=btensors or None)
    S, T, dev = sel.shape[0], int(num_steps), key_s.device
    mn = torch.empty((S, T), dtype=torch.float32, device=dev)
    mx = torch.empty_like(mn)
    rc = _load().gt_minmax_window(
        key_s.data_ptr(), val_s.data_ptr(), key_s.shape[0],
        ts_min.data_ptr(), kp.data_ptr(), sel.data_ptr(), S, T,
        int(start_ms), int(step_ms), int(range_ms), bstart, bmat, L,
        mn.data_ptr(), mx.data_ptr(), _stream_ptr(key_s))
    minmax_window.launches += 1
    _check(rc, "minmax_window")
    return {"min": mn, "max": mx}


minmax_window.launches = 0


# ---------------------------------------------------------------------------
# window_count_max + window_matrix: K14
# ---------------------------------------------------------------------------

def window_count_max_plain(layout, sel, start_ms, *, step_ms, num_steps,
                           range_ms) -> int:
    key_s, _ts_s, _val_s, _tsid_s, _valid_s, ts_min, kp = layout
    _lo, _hi, cnt, _has, sel_ok = window_bounds_plain(
        key_s, ts_min, kp, sel, start_ms, step_ms, num_steps, range_ms)
    c = torch.where(sel_ok[:, None], cnt, 0)
    return int(c.max()) if c.numel() else 0


def window_count_max(layout, sel, start_ms: int, *, step_ms: int,
                     num_steps: int, range_ms: int) -> int:
    """The most samples in any window of a selected series (the reference's
    ``_count_max_kernel``, which sizes the window matrix)."""
    key_s, _ts_s, _val_s, sel, ts_min, kp = _layout_inputs(
        "window_count_max", layout, sel)
    if _on_cpu("window_count_max", key_s, sel, ts_min, kp):
        return window_count_max_plain(layout, sel, start_ms,
                                      step_ms=step_ms, num_steps=num_steps,
                                      range_ms=range_ms)
    out = torch.empty(1, dtype=torch.int32, device=key_s.device)
    rc = _load().gt_window_count_max(
        key_s.data_ptr(), key_s.shape[0], ts_min.data_ptr(), kp.data_ptr(),
        sel.data_ptr(), sel.shape[0], int(num_steps), int(start_ms),
        int(step_ms), int(range_ms), out.data_ptr(), _stream_ptr(key_s))
    window_count_max.launches += 1
    _check(rc, "window_count_max")
    return int(out.item())


window_count_max.launches = 0


def _floor_index(rank: torch.Tensor, top: int) -> tuple:
    """``floor``/``ceil`` of a rank as indices clipped to ``[0, top]``; a
    NaN rank reads index 0 (its result is NaN whichever it reads)."""
    big = float(top + 1)
    lo = torch.nan_to_num(torch.floor(rank), nan=0.0, posinf=big,
                          neginf=-1.0).clamp(0, top).long()
    hi = torch.nan_to_num(torch.ceil(rank), nan=0.0, posinf=big,
                          neginf=-1.0).clamp(0, top).long()
    return lo, hi


def _q_of(sorted_rows: torch.Tensor, q, cnt: torch.Tensor) -> torch.Tensor:
    """Prometheus' linear-interpolation quantile over rows sorted
    ascending along the last axis, in f32 (the reference's ``q_of``,
    engine.py:586 and :1418)."""
    rank = q * torch.clamp(cnt - 1, min=0).to(torch.float32)
    lo_r, hi_r = _floor_index(rank, sorted_rows.shape[-1] - 1)
    vlo = torch.gather(sorted_rows, -1, lo_r[..., None])[..., 0]
    vhi = torch.gather(sorted_rows, -1, hi_r[..., None])[..., 0]
    return vlo + (vhi - vlo) * (rank - lo_r.to(torch.float32))


def window_matrix_plain(layout, sel, start_ms, *, step_ms, num_steps,
                        range_ms, lmax, kind, a1=None, a2=None):
    """The reference's ``_matrix_kernel`` (engine.py:555-631): each
    window's samples gathered into ``[S*T, lmax]``, then per-row sorts
    (``quantile``, ``mad``) or the Holt scan (``holt``)."""
    key_s, _ts_s, val_s, _tsid_s, _valid_s, ts_min, kp = layout
    n = key_s.shape[0]
    S, T = sel.shape[0], int(num_steps)
    lo, _hi, cnt, has, _sel_ok = window_bounds_plain(
        key_s, ts_min, kp, sel, start_ms, step_ms, num_steps, range_ms)
    cntf = cnt.reshape(-1)
    j = torch.arange(lmax, device=key_s.device)
    rows = val_s[torch.clamp(lo.reshape(-1)[:, None] + j, 0, n - 1)]
    ok = j[None, :] < cntf[:, None]
    inf, nan = float("inf"), float("nan")

    def per_window(a):
        return a[None, :].expand(S, T).reshape(-1)

    if kind == "quantile":
        srt = torch.sort(torch.where(ok, rows, inf), dim=1).values
        qv = per_window(a1)
        res = _q_of(srt, qv, cntf)
        res = torch.where(qv < 0, -inf, torch.where(qv > 1, inf, res))
    elif kind == "mad":
        srt = torch.sort(torch.where(ok, rows, inf), dim=1).values
        med = _q_of(srt, 0.5, cntf)
        dev = torch.sort(torch.where(ok, (rows - med[:, None]).abs(), inf),
                         dim=1).values
        res = _q_of(dev, 0.5, cntf)
    elif kind == "holt":
        sf, tf = per_window(a1), per_window(a2)
        s = rows[:, 0]
        b = rows[:, min(1, lmax - 1)] - s
        for i in range(1, lmax):
            x = rows[:, i]
            act = i < cntf
            s1 = fma32(sf, x, (1 - sf) * (s + b))
            b1 = fma32(1 - tf, b, tf * (s1 - s))
            s, b = torch.where(act, s1, s), torch.where(act, b1, b)
        param_ok = (sf > 0) & (sf < 1) & (tf > 0) & (tf < 1)
        res = torch.where((cntf >= 2) & param_ok, s, nan)
    else:
        raise ValueError(f"window_matrix: unknown kind {kind!r}")
    out = torch.where(cntf > 0, res, nan).reshape(S, T)
    return torch.where(has, out, nan)


def _params(what, a, T, dev):
    if a is None:
        return torch.ones(T, dtype=torch.float32, device=dev)
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    return a.expand(T).contiguous() if a.dim() == 0 else _flat(
        what, a, torch.float32, T)


def _scratch(width: int, tasks: int, dev) -> tuple:
    """The global sort buffers of windows wider than ``SMEM_WIDTH`` keys:
    one slot of ``width`` keys per launched warp, as many warps as
    ``_SCRATCH_BYTES`` holds (at least one, at most one per task).
    ``(None, 0)`` where shared memory holds the windows."""
    if width <= SMEM_WIDTH:
        return None, 0
    warps = max(1, min(tasks, _SCRATCH_BYTES // (4 * width)))
    return torch.empty(warps * width, dtype=torch.int32, device=dev), warps


def window_matrix(layout, sel, start_ms: int, *, step_ms: int,
                  num_steps: int, range_ms: int, lmax: int, kind: str,
                  a1=None, a2=None) -> torch.Tensor:
    """``[S, T]`` f32 of a function that needs each window's samples as a
    whole: ``quantile`` (φ per step in ``a1``), ``mad`` (median absolute
    deviation) or ``holt`` (double exponential smoothing with factors
    ``a1``, ``a2`` per step).  ``lmax`` (a power of two >= 2, at least
    ``window_count_max``) is the reference's padded window width: the
    rank clip and the Holt scan length follow it."""
    if kind not in ("quantile", "mad", "holt"):
        raise ValueError(f"window_matrix: unknown kind {kind!r}")
    if lmax < 2 or lmax & (lmax - 1):
        raise ValueError(f"window_matrix: lmax {lmax} is not a power of two "
                         f">= 2")
    key_s, ts_s, val_s, sel, ts_min, kp = _layout_inputs(
        "window_matrix", layout, sel)
    T, dev = int(num_steps), key_s.device
    a1 = _params("window_matrix", a1, T, dev)
    a2 = _params("window_matrix", a2, T, dev)
    if _on_cpu("window_matrix", key_s, val_s, sel, ts_min, kp, a1, a2):
        return window_matrix_plain(layout, sel, start_ms, step_ms=step_ms,
                                   num_steps=num_steps, range_ms=range_ms,
                                   lmax=lmax, kind=kind, a1=a1, a2=a2)
    S = sel.shape[0]
    out = torch.empty((S, T), dtype=torch.float32, device=dev)
    scratch, warps = (None, 0) if kind == "holt" else _scratch(
        lmax, -(-S * T // 32), dev)
    rc = _load().gt_window_matrix(
        key_s.data_ptr(), val_s.data_ptr(), key_s.shape[0],
        ts_min.data_ptr(), kp.data_ptr(), sel.data_ptr(), S, T,
        int(start_ms), int(step_ms), int(range_ms), int(lmax),
        _MATRIX_MODES[kind], a1.data_ptr(), a2.data_ptr(), _ptr(scratch),
        warps, out.data_ptr(), _stream_ptr(key_s))
    window_matrix.launches += 1
    _check(rc, "window_matrix")
    return out


window_matrix.launches = 0


# ---------------------------------------------------------------------------
# window_matrix_dense + subquery_counter: the subquery reducers
# ---------------------------------------------------------------------------

def window_matrix_dense_plain(win, kind, a1=None) -> torch.Tensor:
    """The reference's subquery reducers ``quantile`` and ``mad`` over a
    ``[S, T, K]`` window matrix, NaN = not a sample of the window
    (``_eval_subquery_window``, engine.py:1415-1438)."""
    m = ~torch.isnan(win)
    cnt = m.sum(-1)
    inf, nan = float("inf"), float("nan")
    srt = torch.sort(torch.where(m, win, inf), dim=-1).values
    if kind == "quantile":
        qv = a1[None, :].expand(cnt.shape)
        out = _q_of(srt, qv, cnt)
        out = torch.where(qv < 0, -inf, torch.where(qv > 1, inf, out))
    elif kind == "mad":
        med = _q_of(srt, 0.5, cnt)
        dev = torch.sort(torch.where(m, (win - med[..., None]).abs(), inf),
                         dim=-1).values
        out = _q_of(dev, 0.5, cnt)
    else:
        raise ValueError(f"window_matrix_dense: unknown kind {kind!r}")
    return torch.where(cnt > 0, out, nan)


def _window_matrix_3d(what: str, win: torch.Tensor) -> torch.Tensor:
    if win.dtype != torch.float32 or win.dim() != 3:
        raise ValueError(f"{what}: want f32 [S, T, K], got {win.dtype} "
                         f"{tuple(win.shape)}")
    return win.contiguous()


def window_matrix_dense(win: torch.Tensor, kind: str,
                        a1=None) -> torch.Tensor:
    """``quantile`` (φ per step in ``a1``) or ``mad`` over a subquery's
    window matrix ``win`` ``[S, T, K]`` f32 (NaN where an entry is not a
    sample of its window).  Returns ``[S, T]`` f32."""
    if kind not in ("quantile", "mad"):
        raise ValueError(f"window_matrix_dense: unknown kind {kind!r}")
    win = _window_matrix_3d("window_matrix_dense", win)
    S, T, K = win.shape
    a1 = _params("window_matrix_dense", a1, T, win.device)
    if _on_cpu("window_matrix_dense", win, a1):
        return window_matrix_dense_plain(win, kind, a1)
    out = torch.empty((S, T), dtype=torch.float32, device=win.device)
    if S * T == 0:
        return out
    width = 1 << max(K - 1, 1).bit_length()
    scratch, warps = _scratch(width, S * T, win.device)
    rc = _load().gt_window_matrix_dense(
        win.data_ptr(), S * T, K, T, width, _MATRIX_MODES[kind],
        a1.data_ptr(), _ptr(scratch), warps, out.data_ptr(),
        _stream_ptr(win))
    window_matrix_dense.launches += 1
    _check(rc, "window_matrix_dense")
    return out


window_matrix_dense.launches = 0


def subquery_counter_plain(win, ts_tk, steps, *, kind, func=None,
                           range_s=None):
    """The reference's ``_eval_subquery_counter`` (engine.py:1309-1363)
    after its window matrix: first/last gathers along K (indices clipped
    as ``take_along_axis`` clips them), then for ``rate`` the counter-drop
    loop (a sequential f32 sum in window order) and ``extrapolated``; for
    ``pair`` the last two samples."""
    m = ~torch.isnan(win)
    K = win.shape[2]
    ks = torch.arange(K, device=win.device)
    cnt = m.sum(-1)
    last_k = torch.where(m, ks, -1).amax(-1)

    def at(x, k):
        return torch.gather(x, -1, torch.clamp(k, 0, K - 1)[..., None])[..., 0]

    ts_b = ts_tk[None].expand(win.shape)
    lv, lt = at(win, last_k), at(ts_b, last_k)
    if kind == "pair":
        prev_k = torch.where(m & (ks < last_k[..., None]), ks, -1).amax(-1)
        return {"count": cnt.to(torch.float32), "last_ts": lt,
                "prev_ts": at(ts_b, prev_k), "last_val": lv,
                "prev_val": at(win, prev_k)}
    first_k = torch.where(m, ks, K).amin(-1)
    fv, ft = at(win, first_k), at(ts_b, first_k)
    prev = torch.zeros(win.shape[:2], dtype=win.dtype, device=win.device)
    has_prev = torch.zeros(win.shape[:2], dtype=torch.bool,
                           device=win.device)
    drops = torch.zeros_like(prev)
    for k in range(K):
        v, valid = win[..., k], m[..., k]
        reset = valid & has_prev & (prev > v)
        drops = drops + torch.where(reset, prev, 0.0)
        prev = torch.where(valid, v, prev)
        has_prev = has_prev | valid
    out = {"first_ts": ft, "last_ts": lt, "first_val": fv,
           "count": cnt.to(torch.float32), "delta_adj": lv - fv + drops,
           "delta_raw": lv - fv}
    return extrapolated(out, range_s, steps, counter=func != "delta",
                        is_rate=func == "rate")


def subquery_counter(win: torch.Tensor, ts_tk: torch.Tensor,
                     steps: torch.Tensor, *, kind: str, func=None,
                     range_s: float | None = None):
    """A counter function over a subquery's window matrix ``win`` ``[S, T,
    K]`` f32 (NaN where an entry is not a sample), its sample times
    ``ts_tk`` ``[T, K]`` int64 ms and the steps' window ends ``steps``
    ``[T]`` int64 ms.  ``kind`` ``rate`` returns ``[S, T]`` f32 of
    ``func`` (rate/increase/delta) over ``range_s`` seconds; ``pair``
    returns the dict ``count``, ``last_ts``, ``prev_ts``, ``last_val``,
    ``prev_val`` ``[S, T]`` of irate/idelta."""
    if kind not in _SUBQ_MODES:
        raise ValueError(f"subquery_counter: unknown kind {kind!r}")
    if kind == "rate" and (func not in ("rate", "increase", "delta")
                           or range_s is None):
        raise ValueError("subquery_counter: rate mode takes func "
                         "rate/increase/delta and range_s")
    win = _window_matrix_3d("subquery_counter", win)
    S, T, K = win.shape
    if (ts_tk.dtype != torch.int64 or tuple(ts_tk.shape) != (T, K)
            or steps.dtype != torch.int64 or tuple(steps.shape) != (T,)):
        raise ValueError(f"subquery_counter: want int64 ts_tk [{T}, {K}] "
                         f"and steps [{T}]")
    ts_tk, steps = ts_tk.contiguous(), steps.contiguous()
    if _on_cpu("subquery_counter", win, ts_tk, steps):
        return subquery_counter_plain(win, ts_tk, steps, kind=kind,
                                      func=func, range_s=range_s)
    dev = win.device

    def buf(dtype):
        return torch.empty((S, T), dtype=dtype, device=dev)

    f32, i64 = torch.float32, torch.int64
    outs = ({"rate": buf(f32)} if kind == "rate" else
            {"count": buf(f32), "last_ts": buf(i64), "prev_ts": buf(i64),
             "last_val": buf(f32), "prev_val": buf(f32)})
    order = ("rate", "count", "last_ts", "prev_ts", "last_val", "prev_val")
    rc = _load().gt_subquery_counter(
        win.data_ptr(), S * T, K, T, ts_tk.data_ptr(), steps.data_ptr(),
        _SUBQ_MODES[kind], int(func != "delta"), int(func == "rate"),
        float(range_s) if range_s is not None else 0.0,
        *(_ptr(outs.get(k)) for k in order), _stream_ptr(win))
    subquery_counter.launches += 1
    _check(rc, "subquery_counter")
    return outs["rate"] if kind == "rate" else outs


subquery_counter.launches = 0


def reset_launch_counts() -> None:
    prefix_scan.launches = 0
    series_ranges.launches = 0
    gather_ts_mat.launches = 0
    sort_layout.launches = 0
    sort_layout.presorted = 0
    sort_layout.general = 0
    counter_window.launches = 0
    window_stats.launches = 0
    minmax_window.launches = 0
    window_count_max.launches = 0
    window_matrix.launches = 0
    window_matrix_dense.launches = 0
    subquery_counter.launches = 0
