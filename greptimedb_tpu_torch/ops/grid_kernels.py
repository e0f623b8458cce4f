"""The grid aggregation kernels: bucket_reduce, group_merge and the
stacked batch's group_merge_stacked and series_mask.

Hand-written CUDA kernels (``csrc/grid_kernels.cu``) carry the device
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
- ``group_merge_stacked`` replaces the stacked dispatch's
  ``jax.jit(jax.vmap(bm kernel))`` (``physical.py:979``): the aligned-
  window merge of every member of a coalesced batch in two launches.
- ``series_mask`` replaces ``_series_mask`` (``physical.py:1008``): the
  members' tag-only WHERE masks, gathered from lookup tables.

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
        lib.gt_group_merge_stacked_count.argtypes = [vp, ll, vp, vp, vp, vp,
                                                     ll, vp, i, i, i, i, vp]
        lib.gt_group_merge_stacked_count.restype = i
        lib.gt_group_merge_stacked_sum.argtypes = [vp, ll, ll, vp, vp, vp, vp,
                                                   vp, ll, vp, i, i, i, i, i,
                                                   vp]
        lib.gt_group_merge_stacked_sum.restype = i
        lib.gt_series_mask.argtypes = [vp, ll, i, i, vp, vp, vp, vp, i, vp, i,
                                       vp]
        lib.gt_series_mask.restype = i
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


# ---------------------------------------------------------------------------
# group_merge_stacked (K2 stacked)
# ---------------------------------------------------------------------------

def _stacked_input(sums, cnts, b_lo, layout, planes, nbw, mask):
    if sums.dtype != torch.float32 or sums.dim() != 3:
        raise ValueError(f"group_merge_stacked: sums must be float32 "
                         f"[C, S, NB], got {sums.dtype} {tuple(sums.shape)}")
    if cnts.dtype != torch.float32 or cnts.shape != sums.shape[1:]:
        raise ValueError(f"group_merge_stacked: cnts must be float32 "
                         f"{tuple(sums.shape[1:])}, got {cnts.dtype} "
                         f"{tuple(cnts.shape)}")
    if b_lo.dtype != torch.int32 or b_lo.dim() != 1:
        raise ValueError("group_merge_stacked: b_lo must be int32 [npad]")
    if planes.dtype != torch.int32 or planes.dim() != 1:
        raise ValueError("group_merge_stacked: planes must be int32 [P]")
    s, nb = cnts.shape
    if layout.ids.shape[0] != s:
        raise ValueError(f"group_merge_stacked: layout has "
                         f"{layout.ids.shape[0]} series, partials have {s}")
    if not 0 < nbw <= nb:
        raise ValueError(f"group_merge_stacked: window {nbw} outside "
                         f"(0, {nb}]")
    if mask is not None and (mask.dtype != torch.float32
                             or mask.shape != (b_lo.shape[0], s)):
        raise ValueError(f"group_merge_stacked: mask must be float32 "
                         f"[{b_lo.shape[0]}, {s}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")


def group_merge_stacked_plain(sums, cnts, b_lo, layout: GroupLayout, planes,
                              nbw: int, mask=None):
    """The plain PyTorch version: each member's window stacked, times its
    mask row, then ``index_add_`` into ``ngt + 1`` segments (the overflow
    sliced off) — per element the same ascending-series sums as
    ``group_merge_plain`` over one member's window."""
    _stacked_input(sums, cnts, b_lo, layout, planes, nbw, mask)
    nb = cnts.shape[1]
    starts = [clamp_start(b, nbw, nb) for b in b_lo.tolist()]
    ids = layout.ids.to(torch.int64)
    npad, ngt = len(starts), layout.ngt
    c_w = torch.stack([cnts.narrow(1, b0, nbw) for b0 in starts])
    if mask is not None:
        c_w = c_w * mask[:, :, None]
    cnt = torch.zeros((npad, ngt + 1, nbw), dtype=torch.int64,
                      device=cnts.device)
    cnt.index_add_(1, ids, c_w.to(torch.int64))
    x = sums.index_select(0, planes.to(torch.int64))
    s_w = torch.stack([x.narrow(2, b0, nbw) for b0 in starts])
    if mask is not None:
        s_w = s_w * mask[:, None, :, None]
    sg = torch.zeros((npad, x.shape[0], ngt + 1, nbw), dtype=torch.float32,
                     device=sums.device)
    sg.index_add_(2, ids, s_w)
    return cnt[:, :ngt], sg[:, :, :ngt]


def group_merge_stacked(sums, cnts, b_lo, layout: GroupLayout, planes,
                        nbw: int, mask=None):
    """Aligned-window series→group merge for a whole batch of members.

    ``sums`` ``[C, S, NB]`` and ``cnts`` ``[S, NB]`` float32 are the
    resident bucket-major partials; member ``m`` reads buckets
    ``[b0, b0 + nbw)`` with ``b0 = clamp_start(b_lo[m], nbw, NB)``
    (``b_lo`` ``[npad]`` int32), of the planes listed in ``planes``
    ``[P]`` int32, each series weighted by ``mask[m, s]`` (``[npad, S]``
    float32, optional).  Returns the int64 counts ``[npad, ngt, nbw]``
    (the masked counts truncated to int64, then summed) and the float32
    sums ``[npad, P, ngt, nbw]``, each member bit-identical to its solo
    ``group_merge`` pair.  Two launches, whatever ``npad``."""
    if not cuda_build.on_cpu("group_merge_stacked", sums, cnts, b_lo,
                             planes, mask, layout.order, layout.offsets):
        return _group_merge_stacked_cuda(sums, cnts, b_lo, layout, planes,
                                         nbw, mask)
    return group_merge_stacked_plain(sums, cnts, b_lo, layout, planes, nbw,
                                     mask)


def _group_merge_stacked_cuda(sums, cnts, b_lo, layout, planes, nbw, mask):
    _stacked_input(sums, cnts, b_lo, layout, planes, nbw, mask)
    if sums.stride(-1) != 1:
        sums = sums.contiguous()
    if cnts.stride(-1) != 1:
        cnts = cnts.contiguous()
    b_lo, planes = b_lo.contiguous(), planes.contiguous()
    if mask is not None and mask.stride(-1) != 1:
        mask = mask.contiguous()
    npad, p = b_lo.shape[0], planes.shape[0]
    nb, ngt = cnts.shape[1], layout.ngt
    dev = cnts.device
    cnt = torch.empty((npad, ngt, nbw), dtype=torch.int64, device=dev)
    sg = torch.empty((npad, p, ngt, nbw), dtype=torch.float32, device=dev)
    lib = _load()
    mptr = mask.data_ptr() if mask is not None else None
    mst = mask.stride(0) if mask is not None else 0
    rc = lib.gt_group_merge_stacked_count(
        cnts.data_ptr(), cnts.stride(0), b_lo.data_ptr(),
        layout.order.data_ptr(), layout.offsets.data_ptr(), mptr, mst,
        cnt.data_ptr(), npad, ngt, nbw, nb, _stream_ptr(cnts))
    group_merge_stacked.launches += 1
    _check(rc, "group_merge_stacked")
    if p:
        rc = lib.gt_group_merge_stacked_sum(
            sums.data_ptr(), sums.stride(0), sums.stride(1),
            planes.data_ptr(), b_lo.data_ptr(), layout.order.data_ptr(),
            layout.offsets.data_ptr(), mptr, mst, sg.data_ptr(), npad, p,
            ngt, nbw, nb, _stream_ptr(sums))
        group_merge_stacked.launches += 1
        _check(rc, "group_merge_stacked")
    return cnt, sg


group_merge_stacked.launches = 0


# ---------------------------------------------------------------------------
# series_mask (K21)
# ---------------------------------------------------------------------------

def _mask_input(codes, lut, offsets, strides, extents, npad):
    if codes.dtype != torch.int32 or codes.dim() != 2:
        raise ValueError(f"series_mask: codes must be int32 [T, S], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    t = codes.shape[0]
    if lut.dtype != torch.uint8 or lut.dim() != 1 or lut.shape[0] == 0:
        raise ValueError("series_mask: lut must be a non-empty uint8 [L]")
    n = offsets.shape[0]
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or not (
            0 < n <= npad):
        raise ValueError(f"series_mask: offsets must be int32 [n], "
                         f"0 < n <= npad {npad}")
    if strides.dtype != torch.int32 or strides.shape != (n, t):
        raise ValueError(f"series_mask: strides must be int32 [{n}, {t}]")
    if extents.dtype != torch.int32 or extents.shape != (t,):
        raise ValueError(f"series_mask: extents must be int32 [{t}]")


def series_mask_plain(codes, lut, offsets, strides, extents, npad: int):
    """The plain PyTorch version: the same index arithmetic and clamp as
    the kernel, one ``lut`` gather, cast to float32."""
    _mask_input(codes, lut, offsets, strides, extents, npad)
    n = offsets.shape[0]
    row = torch.arange(npad, device=codes.device)
    mm = torch.where(row < n, row, torch.zeros_like(row))
    c = codes.to(torch.int64) + 1
    hi = (extents.to(torch.int64) - 1)[:, None]
    c = torch.minimum(torch.clamp(c, min=0), hi)                # [T, S]
    st = strides.to(torch.int64)[mm]                            # [npad, T]
    idx = offsets.to(torch.int64)[mm][:, None] + (
        st[:, :, None] * c[None]).sum(1)                        # [npad, S]
    return (lut[idx] != 0).to(torch.float32)


def series_mask(codes, lut, offsets, strides, extents, npad: int):
    """Series masks of a stacked batch: ``out[m, s] = lut[offsets[m'] +
    sum_t (codes[t, s] + 1) * strides[m', t]]`` as float 0/1, with
    ``m' = m`` for the ``n`` real members and 0 (the leader's twin) for
    the pad rows up to ``npad``.  ``codes`` ``[T, S]`` int32 are the grid
    codes of the tags the members' predicates name (-1 = NULL/pad);
    ``lut`` concatenates each member's 0/1 table over the product of its
    tags' code ranges ``[-1, card_t)``; ``extents[t] = card_t + 1``.
    One launch for the whole batch."""
    if not cuda_build.on_cpu("series_mask", codes, lut, offsets, strides,
                             extents):
        return _series_mask_cuda(codes, lut, offsets, strides, extents, npad)
    return series_mask_plain(codes, lut, offsets, strides, extents, npad)


def _series_mask_cuda(codes, lut, offsets, strides, extents, npad):
    _mask_input(codes, lut, offsets, strides, extents, npad)
    if codes.shape[0] and codes.stride(-1) != 1:
        codes = codes.contiguous()
    lut, offsets = lut.contiguous(), offsets.contiguous()
    strides, extents = strides.contiguous(), extents.contiguous()
    t, s = codes.shape
    out = torch.empty((npad, s), dtype=torch.float32, device=codes.device)
    rc = _load().gt_series_mask(
        codes.data_ptr(), codes.stride(0) if t else 0, t, s, lut.data_ptr(),
        offsets.data_ptr(), strides.data_ptr(), extents.data_ptr(),
        offsets.shape[0], out.data_ptr(), npad, _stream_ptr(codes))
    series_mask.launches += 1
    _check(rc, "series_mask")
    return out


series_mask.launches = 0


def reset_launch_counts() -> None:
    bucket_reduce.launches = 0
    group_merge.launches = 0
    group_merge_stacked.launches = 0
    series_mask.launches = 0
