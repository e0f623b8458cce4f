"""The row-path kernels: segment_reduce, sorted_segment_reduce, compact,
rank_scatter and radix_argsort.

Hand-written CUDA kernels (``csrc/segment_kernels.cu``) carry the device
work of the SQL row path; each has a plain PyTorch version here.  The
wrappers pick by where the tensors lie: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises — there is no
fallback).  Each wrapper counts its launches in ``<wrapper>.launches``,
incremented only where it launches its kernel.

- ``segment_reduce`` replaces K4 (the JAX reference's
  ``greptimedb_tpu/ops/segment.py:79`` scatters, the two passes of
  ``segment_first_last`` and the scatter half of the wide pass,
  ``greptimedb_tpu/query/physical.py:1846``).
- ``sorted_segment_reduce`` replaces K5 (``ops/segment.py:272`` and
  ``:240``, the sorted half of the wide pass, ``physical.py:1830``).
- ``compact`` replaces ``ops/masks.py:37`` ``compact_rows``;
  ``rank_scatter`` the rank scatter of K6's ``compact_groups``
  (``ops/segment.py:353``).
- ``radix_argsort`` replaces K6's sorts (``ops/segment.py:353`` and the
  lexsort of ``:206``).
- ``segment_select`` replaces K12's sorts, the per-step two-key sorts of
  the PromQL ``quantile`` and ``topk``/``bottomk`` aggregations
  (``greptimedb_tpu/promql/engine.py:1601-1651``): it reads order
  statistics of group-contiguous columns without sorting them in full,
  by a route per group size chosen on the device (a thread a (group,
  step) up to ``SELECT_TINY`` rows, a warp sort up to ``SELECT_SMALL``,
  a radix select above).

Contract shared by both reductions: a row is live when ``mask`` (if given)
is set and ``0 <= ids < ns``; an element of a live row counts when it is
not NaN.  They return ``(val, cnt)``: ``cnt`` the int64 count of counted
elements per segment (and column), ``val`` the sum / min / max of their
values in the value dtype (int64 for integer values), or the identity
where ``cnt`` is 0 (sum 0, min +inf / INT64_MAX, max -inf / INT64_MIN).
``values`` may be ``[N]``, ``[N, C]`` or a list of C ``[N]`` columns (C
columns in one pass; the kernels read a list in place, with no stacked
copy), or None (counts only; ``val`` is then None).

Bounds and design notes live in the CUDA source.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops.cuda_build import check as _check
from greptimedb_tpu_torch.ops.cuda_build import on_cpu as _on_cpu
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

SOURCE = cuda_build.CSRC / "segment_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_segment.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS
I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
_OPS = {"sum": 0, "min": 1, "max": 2}
_SCAN_TILE = 4096
_WIDE_C = 16  # columns of one wide segment_reduce launch (csrc kWideC)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.int64: "i64"}

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/segment_kernels.cu`` into ``build/kernels/`` (skipped
    when the library is newer than its source and headers)."""
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
            "gt_segment_bounds": [vp, ll, i, vp, vp, vp],
            "gt_compact_order": [vp, ll, vp, vp, vp, vp],
            "gt_gather": [vp, vp, ll, i, vp, vp],
            "gt_rank_scatter": [vp, vp, vp, ll, ll, vp, vp, vp, vp, vp],
            "gt_argsort_keys": [vp, vp, ll, vp, vp, vp, vp, vp],
            "gt_radix_pass": [vp, vp, ll, i, vp, vp, vp, vp, vp],
            "gt_segment_select": [vp, ll, vp, vp, ll, vp, i, ll, vp, vp, vp],
        }
        for sfx in _SUFFIX.values():
            sigs[f"gt_segment_reduce_{sfx}"] = [vp, ll, i, vp, vp, ll, i, i,
                                                vp, ll, vp, vp]
            sigs[f"gt_sorted_reduce_{sfx}"] = [vp, ll, i, vp, vp, vp, i, i,
                                               vp, ll, vp, vp]
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        lib.gt_segment_select_scratch.argtypes = [ll, ll, ll, i]
        lib.gt_segment_select_scratch.restype = ll
        _lib = lib
        return lib


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def _tiles(n: int) -> int:
    return max(1, -(-n // _SCAN_TILE))


def value_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a reduction computes in: f32 and f64 stay, every integer
    and bool type widens to int64 (the reference's exact integer path)."""
    if dtype in (torch.float32, torch.float64):
        return dtype
    if dtype.is_floating_point:
        return torch.float32
    return torch.int64


def identity(dtype: torch.dtype, op: str):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    return I64_MAX if op == "min" else I64_MIN


def _check_args(what, values, ids, ns, op, mask):
    if op not in _OPS:
        raise ValueError(f"{what}: unknown op {op!r}")
    if ids.dim() != 1:
        raise ValueError(f"{what}: ids must be 1-D, got {tuple(ids.shape)}")
    n = ids.shape[0]
    if isinstance(values, (list, tuple)):
        if not values or any(v.dim() != 1 or v.shape[0] != n
                             or v.dtype != values[0].dtype for v in values):
            raise ValueError(f"{what}: columns must be [{n}] of one dtype")
        values = [v.to(value_dtype(v.dtype)) for v in values]
    elif values is not None:
        if values.dim() not in (1, 2) or values.shape[0] != n:
            raise ValueError(f"{what}: values {tuple(values.shape)} do not "
                             f"match {n} ids")
        values = values.to(value_dtype(values.dtype))
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (n,)):
        raise ValueError(f"{what}: mask must be bool [{n}]")
    if ns < 0 or ns >= 1 << 31:
        raise ValueError(f"{what}: {ns} segments outside [0, 2^31)")
    return values


def _out_shape(values, ns):
    if isinstance(values, list):
        return (ns, len(values))
    return (ns,) if values is None or values.dim() == 1 else (
        ns, values.shape[1])


def _stacked(values):
    """The plain versions' view of the values: a list becomes [N, C]."""
    return torch.stack(values, dim=1) if isinstance(values, list) else values


def _columns(values):
    """``(pointers, ld, keep)`` of the value columns for the kernels:
    element (i, c) at ``pointers[c] + i * ld`` elements; ``keep`` holds the
    tensors the pointers point into."""
    if values is None:
        return None, 1, []
    if isinstance(values, list):
        cols = [v.contiguous() for v in values]
        return [c.data_ptr() for c in cols], 1, cols
    v = values.contiguous()
    if v.dim() == 1:
        return [v.data_ptr()], 1, [v]
    return ([v.data_ptr() + c * v.element_size() for c in range(v.shape[1])],
            v.shape[1], [v])


def _launch_columns(ptrs, ld, out, cnt, what, counter, launch):
    """Call a reduction entry point once per block of at most 16 columns
    (``launch(cols_array, ld, c, out_ptr, cnt_ptr)``)."""
    cols = 1 if ptrs is None else len(ptrs)
    esize = out.element_size() if out is not None else 0
    for c0 in range(0, cols, _WIDE_C):
        c = min(_WIDE_C, cols - c0)
        arr = None if ptrs is None else (ctypes.c_void_p * c)(
            *ptrs[c0:c0 + c])
        rc = launch(arr, ld, c,
                    out.data_ptr() + c0 * esize if out is not None else None,
                    cnt.data_ptr() + c0 * 8)
        counter.launches += 1
        _check(rc, what)


# ---------------------------------------------------------------------------
# segment_reduce (K4)
# ---------------------------------------------------------------------------

def segment_reduce_plain(values, ids, ns: int, op: str, mask=None):
    """The reference's masked scatter (``jax.ops.segment_*`` into ns + 1
    segments, the overflow one sliced off) on torch ``scatter_add_`` /
    ``scatter_reduce_``."""
    values = _stacked(_check_args("segment_reduce", values, ids, ns, op,
                                  mask))
    live = (ids >= 0) & (ids < ns)
    if mask is not None:
        live = live & mask
    ids64 = ids.to(torch.int64)
    if values is None:
        idx = torch.where(live, ids64, ns)
        cnt = torch.zeros(ns + 1, dtype=torch.int64, device=ids.device)
        cnt.index_add_(0, idx, torch.ones_like(idx))
        return None, cnt[:ns]
    wide = values.dim() == 2
    live_e = live[:, None] if wide else live
    if values.is_floating_point():
        live_e = live_e & ~torch.isnan(values)
    idx = torch.where(live_e, ids64[:, None] if wide else ids64, ns)
    shape = (ns + 1,) + tuple(values.shape[1:])
    cnt = torch.zeros(shape, dtype=torch.int64, device=ids.device)
    cnt.scatter_add_(0, idx, torch.ones_like(idx))
    if op == "sum":
        val = torch.zeros(shape, dtype=values.dtype, device=ids.device)
        val.scatter_add_(0, idx, torch.where(live_e, values, 0))
    else:
        val = torch.full(shape, identity(values.dtype, op),
                         dtype=values.dtype, device=ids.device)
        val.scatter_reduce_(0, idx, values, "amin" if op == "min" else "amax",
                            include_self=True)
    return val[:ns], cnt[:ns]


def segment_reduce(values, ids, ns: int, op: str, mask=None):
    """Masked scatter reduction of ``values`` ([N], [N, C], a list of [N]
    columns, or None) by the int32 segment ids ``ids`` [N] into ``ns``
    segments: ``(val, cnt)`` as the module docstring says.  op: sum, min
    or max (every op counts)."""
    values = _check_args("segment_reduce", values, ids, ns, op, mask)
    first = values[0] if isinstance(values, list) else values
    if _on_cpu("segment_reduce", first, ids, mask):
        return segment_reduce_plain(values, ids, ns, op, mask)
    if ids.dtype != torch.int32:
        raise ValueError("segment_reduce: ids must be int32 on CUDA")
    n, dev = ids.shape[0], ids.device
    shape = _out_shape(values, ns)
    dtype = first.dtype if first is not None else torch.float32
    if len(shape) == 2 and dtype != torch.float32:
        raise ValueError("segment_reduce: several columns must be float32 "
                         "on CUDA")
    ptrs, ld, _keep = _columns(values)
    cnt = torch.empty(shape, dtype=torch.int64, device=dev)
    val = (torch.empty(shape, dtype=dtype, device=dev)
           if values is not None else None)
    ids = ids.contiguous()
    mask = mask.contiguous() if mask is not None else None
    fn = getattr(_load(), f"gt_segment_reduce_{_SUFFIX[dtype]}")
    stream = _stream_ptr(ids)
    _launch_columns(
        ptrs, ld, val, cnt, "segment_reduce", segment_reduce,
        lambda arr, ld_, c, out_p, cnt_p: fn(
            arr, ld_, c, ids.data_ptr(), _ptr(mask), n, ns, _OPS[op], out_p,
            shape[1] if len(shape) == 2 else 1, cnt_p, stream))
    return val, cnt


segment_reduce.launches = 0


# ---------------------------------------------------------------------------
# sorted_segment_reduce (K5)
# ---------------------------------------------------------------------------

def segment_bounds_plain(ids, ns: int):
    """``searchsorted`` left and right of every segment id over the
    nondecreasing ``ids``: int64 ``(starts, ends)``."""
    grid = torch.arange(ns, dtype=ids.dtype, device=ids.device)
    ids = ids.contiguous()
    return (torch.searchsorted(ids, grid),
            torch.searchsorted(ids, grid, right=True))


def sorted_segment_reduce_plain(values, ids, ns: int, op: str, mask=None):
    """Each segment reduced over its row range ``[start, end)``: the rows
    of the ranges are listed and handed to the scatter reduction with
    their segment as id.  f32 sums accumulate in f64 and round once: the
    kernel's warp tree and the reference's segmented scan both add in a
    tree order, whose f32 sums stay within a few ulps of the exact sum,
    where a sequential f32 sum over a thousand rows can drift by ~1e-5
    relative."""
    values = _stacked(_check_args("sorted_segment_reduce", values, ids, ns,
                                  op, mask))
    starts, ends = segment_bounds_plain(ids, ns)
    lengths = torch.clamp(ends - starts, min=0)
    seg = torch.repeat_interleave(
        torch.arange(ns, dtype=torch.int64, device=ids.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    rows = (starts.repeat_interleave(lengths)
            + torch.arange(seg.shape[0], dtype=torch.int64,
                           device=ids.device)
            - first.repeat_interleave(lengths))
    sub = values[rows] if values is not None else None
    f32_sum = op == "sum" and sub is not None and sub.dtype == torch.float32
    val, cnt = segment_reduce_plain(
        sub.to(torch.float64) if f32_sum else sub, seg, ns, op,
        mask[rows] if mask is not None else None)
    return (val.to(torch.float32) if f32_sum else val), cnt


def sorted_segment_reduce(values, ids, ns: int, op: str, mask=None):
    """Scatter-free reduction for nondecreasing int32 ``ids``: segment s
    reduces the rows of ``[start, end)`` = searchsorted left/right of s.
    Returns ``(val, cnt)`` as ``segment_reduce``."""
    values = _check_args("sorted_segment_reduce", values, ids, ns, op, mask)
    first = values[0] if isinstance(values, list) else values
    if _on_cpu("sorted_segment_reduce", first, ids, mask):
        return sorted_segment_reduce_plain(values, ids, ns, op, mask)
    if ids.dtype != torch.int32:
        raise ValueError("sorted_segment_reduce: ids must be int32 on CUDA")
    n, dev = ids.shape[0], ids.device
    lib = _load()
    stream = _stream_ptr(ids)
    ids = ids.contiguous()
    starts = torch.empty(ns, dtype=torch.int64, device=dev)
    ends = torch.empty(ns, dtype=torch.int64, device=dev)
    _check(lib.gt_segment_bounds(ids.data_ptr(), n, ns, starts.data_ptr(),
                                 ends.data_ptr(), stream),
           "sorted_segment_reduce (bounds)")
    shape = _out_shape(values, ns)
    dtype = first.dtype if first is not None else torch.float32
    ptrs, ld, _keep = _columns(values)
    cnt = torch.empty(shape, dtype=torch.int64, device=dev)
    val = (torch.empty(shape, dtype=dtype, device=dev)
           if values is not None else None)
    mask = mask.contiguous() if mask is not None else None
    fn = getattr(lib, f"gt_sorted_reduce_{_SUFFIX[dtype]}")
    _launch_columns(
        ptrs, ld, val, cnt, "sorted_segment_reduce",
        sorted_segment_reduce,
        lambda arr, ld_, c, out_p, cnt_p: fn(
            arr, ld_, c, _ptr(mask), starts.data_ptr(), ends.data_ptr(), ns,
            _OPS[op], out_p, shape[1] if len(shape) == 2 else 1, cnt_p,
            stream))
    return val, cnt


sorted_segment_reduce.launches = 0


# ---------------------------------------------------------------------------
# compact
# ---------------------------------------------------------------------------

def compact_plain(columns: dict, mask):
    """The reference's ``compact_rows``: a stable argsort of the inverted
    mask, then a gather of each column, cut to the kept rows."""
    n = int(mask.sum())
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:n]
    return {k: v[order] for k, v in columns.items()}, n


def compact(columns: dict, mask):
    """Stable compaction: the rows of every ``[N]`` column where ``mask`` is
    set, in row order.  Returns ``(columns, n)``: each column ``[n]``, n the
    number of set rows."""
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError("compact: mask must be bool [N]")
    n = mask.shape[0]
    for k, v in columns.items():
        if v.dim() != 1 or v.shape[0] != n:
            raise ValueError(f"compact: column {k} is {tuple(v.shape)}, "
                             f"want [{n}]")
    if _on_cpu("compact", mask, *columns.values()):
        return compact_plain(columns, mask)
    dev = mask.device
    lib = _load()
    stream = _stream_ptr(mask)
    mask = mask.contiguous()
    incl = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty(_tiles(n), dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    _check(lib.gt_compact_order(mask.data_ptr(), n, incl.data_ptr(),
                                sums.data_ptr(), order.data_ptr(), stream),
           "compact (order)")
    kept = int(incl[-1]) if n else 0
    out = {}
    for k, v in columns.items():
        v = v.contiguous()
        if v.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"compact: column {k} has {v.dtype}")
        dst = torch.empty(kept, dtype=v.dtype, device=dev)
        _check(lib.gt_gather(v.data_ptr(), order.data_ptr(), kept,
                             v.element_size(), dst.data_ptr(), stream),
               "compact (gather)")
        out[k] = dst
    compact.launches += 1
    return out, kept


compact.launches = 0


def rank_scatter_plain(key, order, valid, num_groups: int):
    """The rank half of the reference's ``compact_groups``: dense ranks of
    the sorted keys scattered back to row order (``num_groups`` on invalid
    rows) and the key of every rank (I64_MAX where none)."""
    n = key.shape[0]
    order = order.to(torch.int64)
    sk = key[order]
    new = torch.zeros(n, dtype=torch.int32, device=key.device)
    new[1:] = (sk[1:] != sk[:-1]).to(torch.int32)
    rank = torch.cumsum(new, 0, dtype=torch.int32)
    dense = torch.empty(n, dtype=torch.int32, device=key.device)
    dense[order] = rank
    dense = torch.where(valid, dense, num_groups).to(torch.int32)
    gk = torch.full((num_groups + 1,), I64_MAX, dtype=torch.int64,
                    device=key.device)
    sel = (sk != I64_MAX) & (rank <= num_groups)
    gk[rank[sel].to(torch.int64)] = sk[sel]
    return dense, gk[:num_groups]


def rank_scatter(key, order, valid, num_groups: int):
    """``key`` int64 [N] (I64_MAX on invalid rows), ``order`` its stable
    argsort, ``valid`` bool [N]: returns ``(dense int32 [N], group_keys
    int64 [num_groups])``."""
    n = key.shape[0]
    if key.dtype != torch.int64 or valid.dtype != torch.bool:
        raise ValueError("rank_scatter: key int64 and valid bool")
    if _on_cpu("rank_scatter", key, order, valid):
        return rank_scatter_plain(key, order, valid, num_groups)
    if num_groups >= 1 << 31:
        raise ValueError("rank_scatter: num_groups exceeds int32")
    dev = key.device
    order = order.to(torch.int32).contiguous()
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty(_tiles(n), dtype=torch.int32, device=dev)
    dense = torch.empty(n, dtype=torch.int32, device=dev)
    gk = torch.empty(num_groups + 1, dtype=torch.int64, device=dev)
    rc = _load().gt_rank_scatter(
        key.contiguous().data_ptr(), order.data_ptr(),
        valid.contiguous().data_ptr(), n, num_groups, rank.data_ptr(),
        sums.data_ptr(), dense.data_ptr(), gk.data_ptr(), _stream_ptr(key))
    rank_scatter.launches += 1
    _check(rc, "rank_scatter")
    return dense, gk[:num_groups]


rank_scatter.launches = 0


# ---------------------------------------------------------------------------
# radix_argsort (K6)
# ---------------------------------------------------------------------------

def order_key(values) -> torch.Tensor:
    """int64 keys in the order of ``values``: integers and bools widen;
    floats map through their bits (negative ones flipped), with -0.0 taken
    as 0.0 first, so equal floats get equal keys.  NaNs get keys too; the
    callers mark them invalid."""
    if values.dtype == torch.float32:
        b = (values + 0.0).view(torch.int32)
        return torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)
    if values.dtype == torch.float64:
        b = (values + 0.0).view(torch.int64)
        return torch.where(b < 0, b ^ I64_MAX, b)
    if values.is_floating_point():
        return order_key(values.to(torch.float32))
    return values.to(torch.int64)


def radix_argsort_plain(keys, valid=None):
    if valid is not None:
        keys = torch.where(valid, keys, 0)  # invalid rows keep row order
    order = torch.argsort(keys, stable=True)
    if valid is not None:
        order = order[torch.argsort((~valid[order]).to(torch.int8),
                                    stable=True)]
    return order.to(torch.int32)


def radix_argsort(values, valid=None) -> torch.Tensor:
    """Stable ascending argsort (int32 row indices) of ``values`` [N]
    (integers, bools or floats, through ``order_key``); rows where
    ``valid`` is False come last, in row order."""
    if values.dim() != 1 or (valid is not None and (
            valid.dtype != torch.bool or valid.shape != values.shape)):
        raise ValueError("radix_argsort: values [N] and valid bool [N]")
    keys = order_key(values).contiguous()
    if _on_cpu("radix_argsort", keys, valid):
        return radix_argsort_plain(keys, valid)
    n, dev = keys.shape[0], keys.device
    if n >= 1 << 31:
        raise ValueError(f"radix_argsort: {n} rows exceed int32 indices")
    lib = _load()
    stream = _stream_ptr(keys)
    valid = valid.contiguous() if valid is not None else None
    acc = torch.empty(3, dtype=torch.int64, device=dev)
    rel = torch.empty(n, dtype=torch.int64, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    scal = torch.empty(2, dtype=torch.int64, device=dev)
    _check(lib.gt_argsort_keys(keys.data_ptr(), _ptr(valid), n,
                               acc.data_ptr(), rel.data_ptr(), idx.data_ptr(),
                               scal.data_ptr(), stream),
           "radix_argsort (keys)")
    inv, full = scal.tolist()
    passes = 64 if full else (inv & ((1 << 64) - 1)).bit_length()
    zeros = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty(_tiles(n), dtype=torch.int32, device=dev)
    rel2, idx2 = torch.empty_like(rel), torch.empty_like(idx)

    def one_pass(key, shift):
        nonlocal idx, idx2
        rc = lib.gt_radix_pass(key.data_ptr(), idx.data_ptr(), n, shift,
                               zeros.data_ptr(), sums.data_ptr(),
                               rel2.data_ptr(), idx2.data_ptr(), stream)
        _check(rc, f"radix_argsort (pass {shift})")
        idx, idx2 = idx2, idx

    for shift in range(passes):
        one_pass(rel, shift)
        rel, rel2 = rel2, rel
    if full and valid is not None:
        # the valid keys fill all 2^64 values: one more stable pass on the
        # invalid flag puts the invalid rows last
        one_pass((~valid)[idx].to(torch.int64), 0)
    radix_argsort.launches += 1
    return idx


radix_argsort.launches = 0


# ---------------------------------------------------------------------------
# segment_select (K12's sorts)
# ---------------------------------------------------------------------------

SELECT_TINY = 32     # largest group a thread selects in (csrc kSelTiny)
SELECT_SMALL = 1024  # largest group the warp sort takes (csrc kSelSmall)


def segment_select_plain(values, row_order, offsets, ranks):
    """Per column, the rows sorted by (group, value) as the reference's
    two-key ``lax.sort`` orders them (NaN last), read at each group's
    ranks."""
    S, T = values.shape
    R, ng, _ = ranks.shape
    dev = values.device
    sizes = torch.diff(offsets)
    gid = torch.repeat_interleave(torch.arange(ng, device=dev), sizes)
    vs, p1 = torch.sort(values.index_select(0, row_order.long()), dim=0,
                        stable=True)
    _g, p2 = torch.sort(gid[p1], dim=0, stable=True)
    srt = torch.gather(vs, 0, p2)
    size = sizes[None, :, None]
    r = torch.minimum(torch.clamp(ranks.long(), min=0),
                      torch.clamp(size - 1, min=0))
    rows = (offsets[:-1][None, :, None] + r).clamp(0, max(S - 1, 0))
    cols = torch.arange(T, device=dev)[None, None, :].expand(R, ng, T)
    out = srt[rows, cols] if S else torch.zeros((R, ng, T), device=dev)
    return torch.where(size > 0, out, float("nan"))


def segment_select(values, row_order, offsets, ranks) -> torch.Tensor:
    """Order statistics of group-contiguous columns: ``values`` ``[S, T]``
    f32, groups given by ``row_order`` ``[S]`` int32 (rows of group g at
    ``row_order[offsets[g]:offsets[g + 1]]``) and ``offsets`` ``[ng + 1]``
    int64; ``ranks`` ``[R, ng, T]`` int32 (clamped into each group).
    Returns ``[R, ng, T]`` f32: the value at that rank of the group's
    column in ascending order, NaN last (NaN for an empty group)."""
    if values.dtype != torch.float32 or values.dim() != 2:
        raise ValueError(f"segment_select: values f32 [S, T], got "
                         f"{values.dtype} {tuple(values.shape)}")
    S, T = values.shape
    if row_order.dtype != torch.int32 or row_order.shape != (S,):
        raise ValueError("segment_select: row_order int32 [S]")
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise ValueError("segment_select: offsets int64 [ng + 1]")
    ng = offsets.shape[0] - 1
    if (ranks.dtype != torch.int32 or ranks.dim() != 3
            or ranks.shape[1:] != (ng, T) or not 1 <= ranks.shape[0] <= 32):
        raise ValueError(f"segment_select: ranks int32 [R<=32, {ng}, {T}], "
                         f"got {ranks.dtype} {tuple(ranks.shape)}")
    values, row_order = values.contiguous(), row_order.contiguous()
    offsets, ranks = offsets.contiguous(), ranks.contiguous()
    if _on_cpu("segment_select", values, row_order, offsets, ranks):
        return segment_select_plain(values, row_order, offsets, ranks)
    R, dev = ranks.shape[0], values.device
    out = torch.empty((R, ng, T), dtype=torch.float32, device=dev)
    if ng == 0 or T == 0:
        return out
    lib = _load()
    # routes are picked per group on the device: no host sync, no host copy
    scratch = torch.empty(lib.gt_segment_select_scratch(S, T, ng, R),
                          dtype=torch.uint8, device=dev)
    rc = lib.gt_segment_select(
        values.data_ptr(), T, row_order.data_ptr(), offsets.data_ptr(), ng,
        ranks.data_ptr(), R, S, scratch.data_ptr(), out.data_ptr(),
        _stream_ptr(values))
    segment_select.launches += 1
    _check(rc, "segment_select")
    return out


segment_select.launches = 0


def reset_launch_counts() -> None:
    segment_reduce.launches = 0
    sorted_segment_reduce.launches = 0
    compact.launches = 0
    rank_scatter.launches = 0
    radix_argsort.launches = 0
    segment_select.launches = 0
