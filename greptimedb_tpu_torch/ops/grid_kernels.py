"""The grid aggregation kernels: bucket_reduce and group_merge.

Two hand-written CUDA kernels (``csrc/grid_kernels.cu``) carry the device
work of the SQL dense-grid path; each has a plain PyTorch version here.
The wrappers pick by where the tensors lie: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises — there is no
fallback).  Each wrapper counts its launches in ``<wrapper>.launches``,
incremented only where it launches the kernel.

- ``bucket_reduce`` replaces the per-time-bucket reductions of the JAX
  reference: ``greptimedb_tpu/query/physical.py:1129``
  (``_bucket_major_partials.build_fn``) and the ``bdot``/``breduce``
  reductions of ``physical.py:1255`` (``_build_grid_kernel.kernel``).
- ``group_merge`` replaces their series→group ``segment_sum``/``_min``/
  ``_max`` merge (``physical.py:1176`` and ``:1255``).

Bounds and design notes live in the CUDA source.  The shared library is
built from the repository's sources by ``nvcc`` at first use into
``build/kernels/`` (plain C entry points, bound with ctypes — no PyTorch
headers, so the build takes seconds).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops.cuda_build import check as _check
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

_OPS = {"sum": 0, "count": 1, "min": 2, "max": 3}
SOURCE = cuda_build.CSRC / "grid_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_grid.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/grid_kernels.cu`` into ``build/kernels/`` (skipped
    when the library is newer than its source).  Raises on a failed
    build, with nvcc's output."""
    return cuda_build.build_many([(SOURCE, LIBRARY, NVCC_FLAGS)], force)[0]


def _load():
    """Build (if needed) and bind the library once per process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        reduce_args = [vp, ll, ll, vp, ll, vp, vp, i, i, i, i, i, i, i, i, vp]
        for name in ("gt_bucket_reduce_f32", "gt_bucket_reduce_u8"):
            fn = getattr(lib, name)
            fn.argtypes = reduce_args
            fn.restype = i
        lib.gt_group_merge_f32.argtypes = [vp, ll, ll, vp, vp, vp, vp, i, i,
                                           i, i, vp]
        lib.gt_group_merge_f32.restype = i
        lib.gt_group_merge_i64.argtypes = [vp, ll, ll, vp, vp, vp, i, i, i,
                                           vp]
        lib.gt_group_merge_i64.restype = i
        _lib = lib
        return lib


def clamp_start(start: int, width: int, size: int) -> int:
    """``jax.lax.dynamic_slice_in_dim`` semantics: a negative start counts
    from the end, then the start clamps so the slice fits (``torch.narrow``
    would raise instead)."""
    start = int(start)
    if start < 0:
        start += size
    return min(max(start, 0), max(size - width, 0))


# ---------------------------------------------------------------------------
# bucket_reduce
# ---------------------------------------------------------------------------

@dataclass
class _Window:
    x: torch.Tensor          # [P, S, w_raw] view, last stride 1
    mask: torch.Tensor | None
    weight: torch.Tensor | None
    squeeze: bool
    w_raw: int
    pad_l: int
    pad_r: int


def _window(x, r, nb, s0, w_raw, pad_l, pad_r, mask, mask_s0, weight
            ) -> _Window:
    squeeze = x.dim() == 2
    if squeeze:
        x = x.unsqueeze(0)
    if x.dim() != 3:
        raise ValueError(f"bucket_reduce: x must be [P, S, W] or [S, W], "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bool):
        raise TypeError(f"bucket_reduce: x must be float32 or bool, "
                        f"got {x.dtype}")
    width = x.shape[-1]
    w_raw = width if w_raw is None else int(w_raw)
    if not 0 <= w_raw <= width:
        raise ValueError(f"bucket_reduce: w_raw {w_raw} outside [0, {width}]")
    if pad_r is None:
        pad_r = nb * r - pad_l - w_raw
    if pad_l < 0 or pad_r < 0 or pad_l + w_raw + pad_r != nb * r:
        raise ValueError(
            f"bucket_reduce: pad_l {pad_l} + w_raw {w_raw} + pad_r {pad_r} "
            f"!= nb {nb} * r {r}")
    xs = x.narrow(-1, clamp_start(s0, w_raw, width), w_raw)
    ms = None
    if mask is not None:
        if mask.dtype != torch.bool or mask.dim() != 2 or (
                mask.shape[0] != x.shape[1]):
            raise ValueError(f"bucket_reduce: mask must be bool [S, W], got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        m0 = s0 if mask_s0 is None else mask_s0
        ms = mask.narrow(-1, clamp_start(m0, w_raw, mask.shape[-1]), w_raw)
    if weight is not None:
        if weight.shape != (w_raw,):
            raise ValueError(f"bucket_reduce: weight must be [{w_raw}], got "
                             f"{tuple(weight.shape)}")
        weight = weight.to(torch.float32)
    return _Window(xs, ms, weight, squeeze, w_raw, pad_l, pad_r)


def bucket_reduce_plain(x, op, *, r, nb, s0=0, w_raw=None, pad_l=0,
                        pad_r=None, mask=None, mask_s0=None, weight=None,
                        skip_nan=False):
    """The plain PyTorch version: window slice → mask → pad → view
    ``[..., nb, r]`` → sum/amin/amax over the last axis."""
    w = _window(x, r, nb, s0, w_raw, pad_l, pad_r, mask, mask_s0, weight)
    xs = w.x.to(torch.float32)
    live = w.mask
    if skip_nan:
        ok = ~torch.isnan(xs)
        live = ok if live is None else live & ok
    if op == "sum":
        v = xs if live is None else torch.where(live, xs, 0.0)
        if w.weight is not None:
            v = v * w.weight
        fill = 0.0
    elif op == "count":
        v = (torch.ones_like(xs) if live is None
             else live.expand(xs.shape).to(torch.float32))
        if w.weight is not None:
            v = v * w.weight
        fill = 0.0
    elif op in ("min", "max"):
        if w.weight is not None:
            on = w.weight != 0
            live = on if live is None else live & on
        fill = float("inf") if op == "min" else float("-inf")
        v = xs if live is None else torch.where(live, xs, fill)
    else:
        raise ValueError(f"bucket_reduce: unknown op {op!r}")
    v = F.pad(v, (w.pad_l, w.pad_r), value=fill)
    v = v.reshape(v.shape[0], v.shape[1], nb, r)
    if op in ("sum", "count"):
        out = v.sum(-1)
    else:
        out = v.amin(-1) if op == "min" else v.amax(-1)
    return out[0] if w.squeeze else out


def bucket_reduce(x, op, *, r, nb, s0=0, w_raw=None, pad_l=0, pad_r=None,
                  mask=None, mask_s0=None, weight=None, skip_nan=False):
    """Per-time-bucket reduction of a window of the grid's time axis.

    ``x`` is ``[P, S, W]`` (or ``[S, W]``), float32 or bool.  The window is
    ``x[..., s0 : s0 + w_raw]`` with the start clamped as JAX's dynamic
    slice clamps it, padded by ``pad_l``/``pad_r`` identity cells and cut
    into ``nb`` buckets of ``r`` steps.  ``op`` is ``sum`` (bool counts as
    0/1), ``count`` (live cells), ``min`` or ``max``.  A cell is live when
    ``mask[s, mask_s0 + t]`` (if given; ``mask_s0`` defaults to ``s0``)
    and, with ``skip_nan``, its value is not NaN.  ``weight`` ``[w_raw]``
    multiplies sums and counts; a zero weight drops the cell from min/max.
    Returns ``[P, S, nb]`` (or ``[S, nb]``) float32."""
    if op not in _OPS:
        raise ValueError(f"bucket_reduce: unknown op {op!r}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"bucket_reduce: unsupported device {x.device}")
        return bucket_reduce_plain(
            x, op, r=r, nb=nb, s0=s0, w_raw=w_raw, pad_l=pad_l, pad_r=pad_r,
            mask=mask, mask_s0=mask_s0, weight=weight, skip_nan=skip_nan)
    w = _window(x, r, nb, s0, w_raw, pad_l, pad_r, mask, mask_s0, weight)
    xs = w.x
    if xs.stride(-1) != 1:
        xs = xs.contiguous()
    p, s = xs.shape[0], xs.shape[1]
    ms = w.mask
    if ms is not None:
        if ms.device != xs.device:
            raise ValueError("bucket_reduce: mask on another device")
        if ms.stride(-1) != 1:
            ms = ms.contiguous()
    wt = w.weight
    if wt is not None:
        if wt.device != xs.device:
            raise ValueError("bucket_reduce: weight on another device")
        wt = wt.contiguous()
    out = torch.empty((p, s, nb), dtype=torch.float32, device=xs.device)
    lib = _load()
    fn = (lib.gt_bucket_reduce_f32 if xs.dtype == torch.float32
          else lib.gt_bucket_reduce_u8)
    rc = fn(xs.data_ptr(), xs.stride(0), xs.stride(1),
            ms.data_ptr() if ms is not None else None,
            ms.stride(0) if ms is not None else 0,
            wt.data_ptr() if wt is not None else None,
            out.data_ptr(), p, s, w.w_raw, w.pad_l, r, nb, _OPS[op],
            int(bool(skip_nan)), _stream_ptr(xs))
    bucket_reduce.launches += 1
    _check(rc, "bucket_reduce")
    return out[0] if w.squeeze else out


bucket_reduce.launches = 0


# ---------------------------------------------------------------------------
# group_merge
# ---------------------------------------------------------------------------

@dataclass
class GroupLayout:
    """Series→group routing in CSR form: ``ids`` ``[S]`` int32 in
    ``[0, ngt]`` (``ngt`` = overflow, dropped); ``order`` lists series by
    group, ascending series within a group (stable sort);
    ``offsets[g]:offsets[g+1]`` is group g's slice of ``order``."""

    ids: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    ngt: int


def group_layout(ids: torch.Tensor, ngt: int) -> GroupLayout:
    """Build the CSR routing once per (grid, GROUP BY)."""
    ids = ids.to(torch.int32)
    order = torch.argsort(ids, stable=True).to(torch.int32)
    counts = torch.bincount(ids.to(torch.int64), minlength=ngt + 1)
    offsets = torch.zeros(ngt + 1, dtype=torch.int64, device=ids.device)
    offsets[1:] = torch.cumsum(counts[:ngt], 0)
    return GroupLayout(ids, order, offsets, int(ngt))


def _merge_input(x, factor, op):
    squeeze = x.dim() == 2
    if squeeze:
        x = x.unsqueeze(0)
    if x.dim() != 3:
        raise ValueError(f"group_merge: x must be [P, S, NB] or [S, NB], "
                         f"got {tuple(x.shape)}")
    if op not in ("sum", "min", "max"):
        raise ValueError(f"group_merge: unknown op {op!r}")
    if x.dtype == torch.int64:
        if op != "sum" or factor is not None:
            raise ValueError("group_merge: int64 input takes op='sum' and "
                             "no factor")
    elif x.dtype != torch.float32:
        raise TypeError(f"group_merge: x must be float32 or int64, got "
                        f"{x.dtype}")
    return x, squeeze


def group_merge_plain(x, layout: GroupLayout, op, factor=None):
    """The plain PyTorch version: ``index_add_`` (sum) or
    ``scatter_reduce_`` (min/max) into ``ngt + 1`` segments, the overflow
    segment sliced off."""
    x, squeeze = _merge_input(x, factor, op)
    p, s, nb = x.shape
    ids = layout.ids.to(torch.int64)
    if op == "sum":
        v = x if factor is None else x * factor[None, :, None]
        out = torch.zeros((p, layout.ngt + 1, nb), dtype=x.dtype,
                          device=x.device)
        out.index_add_(1, ids, v)
    else:
        fill = float("inf") if op == "min" else float("-inf")
        v = x if factor is None else torch.where(
            (factor == 0)[None, :, None], fill, x)
        out = torch.full((p, layout.ngt + 1, nb), fill, dtype=x.dtype,
                         device=x.device)
        out.scatter_reduce_(1, ids[None, :, None].expand(p, s, nb), v,
                            reduce="amin" if op == "min" else "amax",
                            include_self=True)
    out = out[:, :layout.ngt]
    return out[0] if squeeze else out


def group_merge(x, layout: GroupLayout, op, factor=None):
    """Series→group merge: ``out[p, g, b]`` = op over the series routed to
    group ``g`` of ``x[p, s, b]`` (times ``factor[s]`` for sums; a zero
    factor drops the series from min/max).  ``x`` is ``[P, S, NB]`` (or
    ``[S, NB]``), float32, or int64 for count sums.  Series routed to the
    overflow id ``ngt`` are dropped; empty groups give the identity."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"group_merge: unsupported device {x.device}")
        return group_merge_plain(x, layout, op, factor)
    x, squeeze = _merge_input(x, factor, op)
    if x.stride(-1) != 1:
        x = x.contiguous()
    p, s, nb = x.shape
    if layout.ids.shape[0] != s:
        raise ValueError(f"group_merge: layout has {layout.ids.shape[0]} "
                         f"series, x has {s}")
    for t in (layout.order, layout.offsets):
        if t.device != x.device:
            raise ValueError("group_merge: layout on another device")
    out = torch.empty((p, layout.ngt, nb), dtype=x.dtype, device=x.device)
    lib = _load()
    if x.dtype == torch.int64:
        rc = lib.gt_group_merge_i64(
            x.data_ptr(), x.stride(0), x.stride(1), layout.order.data_ptr(),
            layout.offsets.data_ptr(), out.data_ptr(), p, layout.ngt, nb,
            _stream_ptr(x))
    else:
        fac = None
        if factor is not None:
            if factor.device != x.device or factor.shape != (s,):
                raise ValueError("group_merge: factor must be [S] on x's "
                                 "device")
            fac = factor.to(torch.float32).contiguous()
        rc = lib.gt_group_merge_f32(
            x.data_ptr(), x.stride(0), x.stride(1), layout.order.data_ptr(),
            layout.offsets.data_ptr(),
            fac.data_ptr() if fac is not None else None, out.data_ptr(), p,
            layout.ngt, nb, _OPS[op], _stream_ptr(x))
    group_merge.launches += 1
    _check(rc, "group_merge")
    return out[0] if squeeze else out


group_merge.launches = 0


def reset_launch_counts() -> None:
    bucket_reduce.launches = 0
    group_merge.launches = 0
