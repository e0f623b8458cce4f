"""The mesh row path's exchange kernel: mesh_merge.

A hand-written CUDA kernel (``csrc/mesh_kernels.cu``) folds the shard
axis of the mesh aggregate's stacked partials; it has a plain PyTorch
version here.  The wrappers pick by where the tensors lie: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (or raises —
there is no fallback).  Launches count in ``mesh_merge.launches``,
incremented only where a wrapper launches the kernel (``mesh_pick``, its
first/last mode, counts there too).

- ``mesh_merge`` replaces the collectives of the JAX reference's mesh
  aggregate (``greptimedb_tpu/parallel/dist.py:199-204`` ``_MERGE`` and
  the psum / pmin / pmax of ``local``, ``:297-459``): ``[D, G(, M)]``
  partials in, ``[G(, M)]`` out, with op ``sum`` (f32 in shard order;
  int64 exact), ``min`` / ``max`` (f32, f64, int32, int64; NaN
  propagates), or ``udd`` (UDDSketch rows: counts summed, then k_min by
  min and the collapse by max);
- ``mesh_pick`` is its first/last mode (``:425-457``): the global extreme
  timestamp over the shards holding rows, then the largest value among
  the shards holding it.

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

SOURCE = cuda_build.CSRC / "mesh_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_mesh.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS
I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
_OPS = {"sum": 0, "min": 1, "max": 2, "udd": 3}
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
           torch.int64: 3}

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/mesh_kernels.cu`` into ``build/kernels/`` (skipped
    when the library is newer than its source)."""
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
            "gt_mesh_merge": [vp, i, ll, ll, ll, i, vp, vp],
            "gt_mesh_pick": [vp, vp, vp, i, ll, ll, i, vp, vp, vp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        _lib = lib
        return lib


def _parts_args(parts, op):
    if op not in _OPS:
        raise ValueError(f"mesh_merge: unknown op {op!r}")
    if parts.dtype not in _DTYPES or parts.dim() < 2:
        raise ValueError(f"mesh_merge: want [D, G(, M)] f32/f64/i32/i64, "
                         f"got {parts.dtype} {tuple(parts.shape)}")
    if op == "udd" and (parts.dtype != torch.int64 or parts.dim() != 3
                        or parts.shape[2] < 3):
        raise ValueError("mesh_merge: udd rows are int64 [D, G, nb + 2]")


def mesh_merge_plain(parts, op: str):
    """The shard axis of ``parts`` [D, ...] folded in mesh order."""
    _parts_args(parts, op)
    acc = parts[0].clone()
    for d in range(1, parts.shape[0]):
        v = parts[d]
        if op == "sum":
            acc = acc + v
        elif op == "min":
            acc = torch.minimum(acc, v)
        elif op == "max":
            acc = torch.maximum(acc, v)
        else:
            acc = torch.cat([acc[..., :-2] + v[..., :-2],
                             torch.minimum(acc[..., -2:-1], v[..., -2:-1]),
                             torch.maximum(acc[..., -1:], v[..., -1:])], -1)
    return acc


def mesh_merge(parts, op: str):
    """``[D, G(, M)]`` partials of D shards, on one device, folded to
    ``[G(, M)]`` by ``op`` (sum, min, max, udd)."""
    _parts_args(parts, op)
    if _on_cpu("mesh_merge", parts):
        return mesh_merge_plain(parts, op)
    parts = parts.contiguous()
    D = parts.shape[0]
    out = torch.empty(parts.shape[1:], dtype=parts.dtype,
                      device=parts.device)
    rc = _load().gt_mesh_merge(
        parts.data_ptr(), _DTYPES[parts.dtype], D, out.numel(),
        parts.shape[-1] if op == "udd" else 1, _OPS[op], out.data_ptr(),
        _stream_ptr(parts))
    mesh_merge.launches += 1
    _check(rc, "mesh_merge")
    return out


mesh_merge.launches = 0


def _pick_args(ts, has, vals):
    if (ts.dtype != torch.int64 or has.dtype != torch.bool
            or ts.dim() != 2 or ts.shape != has.shape
            or ts.shape != vals.shape
            or vals.dtype not in (torch.float32, torch.float64,
                                  torch.int64)):
        raise ValueError("mesh_pick: ts int64, has bool and vals "
                         "f32/f64/i64, all [D, G]")


def mesh_pick_plain(ts, has, vals, last: bool):
    """(extreme timestamp [G], value [G]) of first/last over D shards: the
    extreme over the shards that hold rows, then the largest value among
    the shards at it; -inf / INT64_MIN where none holds one."""
    _pick_args(ts, has, vals)
    sent = torch.where(has, ts, I64_MIN if last else I64_MAX)
    g_ts = sent.amax(0) if last else sent.amin(0)
    fill = float("-inf") if vals.is_floating_point() else I64_MIN
    cand = torch.where(has & (sent == g_ts), vals, fill)
    out = cand[0].clone()
    for d in range(1, cand.shape[0]):
        out = torch.maximum(out, cand[d])
    return g_ts, out


def mesh_pick(ts, has, vals, last: bool):
    """The first/last mode of ``mesh_merge``: per group the shards' local
    (extreme timestamp, value, has-rows) partials, ``[D, G]`` each,
    merged as ``mesh_pick_plain`` says."""
    _pick_args(ts, has, vals)
    if _on_cpu("mesh_pick", ts, has, vals):
        return mesh_pick_plain(ts, has, vals, last)
    ts, has, vals = ts.contiguous(), has.contiguous(), vals.contiguous()
    D, G = ts.shape
    out_ts = torch.empty(G, dtype=torch.int64, device=ts.device)
    out_val = torch.empty(G, dtype=vals.dtype, device=ts.device)
    rc = _load().gt_mesh_pick(ts.data_ptr(), has.data_ptr(), vals.data_ptr(),
                              _DTYPES[vals.dtype], D, G, int(last),
                              out_ts.data_ptr(), out_val.data_ptr(),
                              _stream_ptr(ts))
    mesh_merge.launches += 1
    _check(rc, "mesh_merge (pick)")
    return out_ts, out_val


def reset_launch_counts() -> None:
    mesh_merge.launches = 0
