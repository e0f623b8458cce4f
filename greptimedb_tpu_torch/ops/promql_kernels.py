"""The PromQL kernels: prefix_scan, sort_layout and counter_window.

Hand-written CUDA kernels (``csrc/promql_kernels.cu``) carry the device
work of the PromQL range-vector path; each has a plain PyTorch version
here.  The wrappers pick by where the tensors lie: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises — there is no
fallback).  Each wrapper counts its launches in ``<wrapper>.launches``,
incremented only where it launches its kernel.

- ``prefix_scan`` (the f64 scan with the counter-reset drop fused in)
  replaces the cumulative sums of the JAX reference's window body
  (``greptimedb_tpu/promql/engine.py:405-425``); the radix passes of
  ``sort_layout`` run the same scan and count as its launches too.
- ``sort_layout`` replaces K8, ``_build_sort_layout`` (``engine.py:257``).
- ``counter_window`` replaces K9's searchsorted geometry
  (``engine.py:288``), K10's ``counter``/``instant`` kinds (``:383``) and,
  in rate mode, the ``_extrapolated`` epilogue (``:1839``) of K11.

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
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

SOURCE = cuda_build.CSRC / "promql_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_promql.so"
NVCC_FLAGS = [*cuda_build.BASE_FLAGS, "-fmad=false"]
I64_MAX = (1 << 63) - 1
_SCAN_TILE = 4096
# counter_window modes (csrc WindowMode) and the outputs each one writes
_MODES = {"instant": 0, "counter": 1, "rate": 2}
KIND_KEYS = {
    "instant": ("count", "last", "last_ts"),
    "counter": ("count", "first_ts", "last_ts", "first_val", "last_val",
                "delta_adj", "delta_raw"),
}

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
            "gt_layout_key": [vp, vp, vp, vp, ll, vp, vp, vp, vp, vp],
            "gt_radix_pass": [vp, vp, ll, i, vp, vp, vp, vp, vp],
            "gt_layout_gather": [vp, vp, vp, vp, vp, vp, ll, vp, vp, vp, vp,
                                 vp, vp],
            "gt_counter_window": [vp, vp, vp, vp, ll, vp, vp, vp, ll, ll, ll,
                                  ll, ll, i, i, i, d] + [vp] * 10,
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        _lib = lib
        return lib


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def _on_cpu(what: str, *tensors) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors all on
    one device (kernel); raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return False


def _flat(what: str, t: torch.Tensor, dtype, n: int | None = None):
    if t.dtype != dtype or t.dim() != 1 or (n is not None and
                                            t.shape[0] != n):
        raise ValueError(f"{what}: want {dtype} [{n if n is not None else 'N'}]"
                         f", got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _tiles(n: int) -> int:
    return max(1, -(-n // _SCAN_TILE))


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
    sums = torch.empty(_tiles(n), dtype=torch.float64, device=val_s.device)
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
    if n >= 1 << 31:
        raise ValueError(f"sort_layout: {n} rows exceed int32 row indices")
    dev = ts.device
    lib = _load()
    stream = _stream_ptr(ts)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    acc = torch.empty(4, dtype=torch.int64, device=dev)
    scal = torch.empty(3, dtype=torch.int64, device=dev)
    _check(lib.gt_layout_key(ts.data_ptr(), val.data_ptr(), tsid.data_ptr(),
                             mask.data_ptr(), n, acc.data_ptr(),
                             key.data_ptr(), idx.data_ptr(), scal.data_ptr(),
                             stream), "sort_layout (layout_key)")
    # the invalid rows' key is the largest: its bits are the passes needed
    passes = int(scal[2]).bit_length()
    if passes:
        key2, idx2 = torch.empty_like(key), torch.empty_like(idx)
        zeros = torch.empty(n, dtype=torch.int32, device=dev)
        sums = torch.empty(_tiles(n), dtype=torch.int32, device=dev)
        for shift in range(passes):
            rc = lib.gt_radix_pass(key.data_ptr(), idx.data_ptr(), n, shift,
                                   zeros.data_ptr(), sums.data_ptr(),
                                   key2.data_ptr(), idx2.data_ptr(), stream)
            prefix_scan.launches += 1
            _check(rc, f"sort_layout (radix pass {shift})")
            key, key2, idx, idx2 = key2, key, idx2, idx
        del key2, idx2, zeros, sums
    out = (torch.empty(n, dtype=torch.int64, device=dev),
           torch.empty(n, dtype=torch.int64, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    rc = lib.gt_layout_gather(key.data_ptr(), idx.data_ptr(), ts.data_ptr(),
                              val.data_ptr(), tsid.data_ptr(),
                              mask.data_ptr(), n, *(t.data_ptr() for t in out),
                              stream)
    sort_layout.launches += 1
    _check(rc, "sort_layout (layout_gather)")
    return out + (scal[0], scal[1])


sort_layout.launches = 0


# ---------------------------------------------------------------------------
# counter_window
# ---------------------------------------------------------------------------

def window_bounds_plain(key_s, ts_min, kp, sel, start_ms: int, step_ms: int,
                        num_steps: int, range_ms: int):
    """The reference's searchsorted geometry (engine.py:330-345): per
    (series, step) the half-open sorted-row range ``[lo, hi)`` of the
    left-exclusive window ``(t - range, t]``.  Returns
    ``(lo, hi, cnt, has, sel_ok)``."""
    S = sel.shape[0]
    steps = start_ms + step_ms * torch.arange(num_steps, dtype=torch.int64,
                                              device=key_s.device)
    sel_ok = sel >= 0
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


def window_stats_plain(kind, key_s, ts_s, val_s, gdrop, ts_min, kp, sel,
                       start_ms, step_ms, num_steps, range_ms) -> dict:
    """The reference's window body (engine.py:401-454) for the
    ``instant`` and ``counter`` kinds: ``[S, T]`` outputs of KIND_KEYS."""
    n = key_s.shape[0]
    lo, hi, cnt, has, sel_ok = window_bounds_plain(
        key_s, ts_min, kp, sel, start_ms, step_ms, num_steps, range_ms)
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
                         num_steps, range_ms, kind, func=None, range_s=None):
    key_s, ts_s, val_s, _tsid_s, _valid_s, ts_min, kp = layout
    stats_kind = "counter" if kind == "rate" else kind
    out = window_stats_plain(stats_kind, key_s, ts_s, val_s, gdrop, ts_min,
                             kp, sel, start_ms, step_ms, num_steps, range_ms)
    if kind != "rate":
        return out
    range_end = start_ms + step_ms * torch.arange(
        num_steps, dtype=torch.int64, device=key_s.device)
    return extrapolated(out, range_s, range_end, counter=func != "delta",
                        is_rate=func == "rate")


def counter_window(layout, gdrop, sel, start_ms: int, *, step_ms: int,
                   num_steps: int, range_ms: int, kind: str, func=None,
                   range_s: float | None = None):
    """Window statistics of the selected series over a sort layout.

    ``layout`` is ``sort_layout``'s tuple, ``sel`` ``[S]`` int32 selected
    tsids (padding -1), ``gdrop`` the layout's ``prefix_scan`` (the
    ``counter`` and ``rate`` kinds; None for ``instant``).  Windows are
    ``(t - range_ms, t]`` at ``t = start_ms + step_ms * j``.
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
    tensors = [key_s, ts_s, val_s, sel, ts_min, kp]
    if kind != "instant":
        gdrop = _flat("counter_window", gdrop, torch.float64, n)
        tensors.append(gdrop)
    if _on_cpu("counter_window", *tensors):
        return counter_window_plain(
            (key_s, ts_s, val_s, None, None, ts_min, kp), gdrop, sel,
            start_ms, step_ms=step_ms, num_steps=num_steps,
            range_ms=range_ms, kind=kind, func=func, range_s=range_s)
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
        int(start_ms), int(step_ms), int(range_ms), _MODES[kind],
        int(func != "delta"), int(func == "rate"),
        float(range_s) if range_s is not None else 0.0,
        *(_ptr(outs.get(k)) for k in order), _stream_ptr(key_s))
    counter_window.launches += 1
    _check(rc, "counter_window")
    return outs["rate"] if kind == "rate" else outs


counter_window.launches = 0


def reset_launch_counts() -> None:
    prefix_scan.launches = 0
    sort_layout.launches = 0
    counter_window.launches = 0
