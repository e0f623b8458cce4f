"""The full-text and LogQL kernels: fp_candidates, logs_layout, line_vals
and row_match.

Hand-written CUDA kernels (``csrc/fulltext_kernels.cu``) carry the device
work of the fingerprint prefilter and the LogQL evaluator; each has a
plain PyTorch version here.  The wrappers pick by where the tensors lie: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel (or
raises — there is no fallback).  Each wrapper counts its launches in
``<name>.launches``, incremented only where it launches its kernel.

- ``fp_candidates`` replaces K16 (the JAX reference's
  ``greptimedb_tpu/fulltext/resident.py:75`` ``_candidate_kernel``).
- ``logs_layout``, ``line_vals`` and ``row_match`` replace K17
  (``greptimedb_tpu/fulltext/loki.py:101`` ``_logs_layout``, ``:115``
  ``_line_vals`` with ``:124`` ``_byte_vals``, ``:131`` ``_row_match``).

The fingerprint matrix keeps the reference's uint32 bits in an int32
tensor: bitwise AND and equality give the same answers on the same bits,
and many torch ops have no CUDA kernel for ``torch.uint32``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops.cuda_build import check as _check
from greptimedb_tpu_torch.ops.cuda_build import on_cpu as _on_cpu
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

SOURCE = cuda_build.CSRC / "fulltext_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_fulltext.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS
I64_MAX = torch.iinfo(torch.int64).max
_TS_MAX_INIT = -(1 << 62)

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/fulltext_kernels.cu`` into ``build/kernels/``
    (skipped when the library is newer than its source)."""
    return cuda_build.build_many([(SOURCE, LIBRARY, NVCC_FLAGS)], force)[0]


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sigs = {
            "gt_fp_candidates": [vp, vp, ll, i, i, i, vp, vp],
            "gt_logs_layout": [vp, vp, vp, ll, vp, vp, vp, vp, vp],
            "gt_line_vals": [vp, vp, ll, vp, vp, ll, vp, vp, vp],
            "gt_row_match": [vp, vp, ll, vp, vp, vp, vp, ll, vp, ll, ll, ll,
                             ll, vp, vp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        _lib = lib
        return lib


def _want(what: str, t: torch.Tensor, dtype, shape=None) -> torch.Tensor:
    if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f"{what}: want {dtype} {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


# ---------------------------------------------------------------------------
# fp_candidates: K16
# ---------------------------------------------------------------------------

def fp_candidates_plain(fp: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """OR over the k alternatives of AND over the W words of
    ``(fp & m) == m``."""
    out = torch.zeros(fp.shape[0], dtype=torch.bool, device=fp.device)
    for i in range(masks.shape[0]):
        m = masks[i]
        out |= ((fp & m) == m).all(dim=1)
    return out


def fp_candidates(fp: torch.Tensor, masks: "torch.Tensor | None"
                  ) -> torch.Tensor:
    """Candidate flags ``[npad]`` bool of a fingerprint matrix ``fp``
    ``[npad, W]`` int32 against the query masks ``[k, W]`` int32 (the
    uint32 bits); every row is a candidate when ``masks`` is None (no
    extractable literal: nothing launches)."""
    if fp.dim() != 2 or fp.dtype != torch.int32:
        raise ValueError(f"fp_candidates: fp must be int32 [npad, W], got "
                         f"{fp.dtype} {tuple(fp.shape)}")
    npad, W = fp.shape
    if masks is None:
        return torch.ones(npad, dtype=torch.bool, device=fp.device)
    if masks.dim() != 2 or masks.dtype != torch.int32 or masks.shape[1] != W:
        raise ValueError(f"fp_candidates: masks must be int32 [k, {W}], got "
                         f"{masks.dtype} {tuple(masks.shape)}")
    if _on_cpu("fp_candidates", fp, masks):
        return fp_candidates_plain(fp, masks)
    k = masks.shape[0]
    out = torch.empty(npad, dtype=torch.bool, device=fp.device)
    if k == 0 or npad == 0:
        out.zero_()
        return out
    fp, masks = fp.contiguous(), masks.contiguous()
    vec4 = int(W % 4 == 0 and fp.data_ptr() % 16 == 0)
    rc = _load().gt_fp_candidates(fp.data_ptr(), masks.data_ptr(), npad, W,
                                  k, vec4, out.data_ptr(), _stream_ptr(fp))
    fp_candidates.launches += 1
    _check(rc, "fp_candidates")
    return out


fp_candidates.launches = 0


# ---------------------------------------------------------------------------
# logs_layout: K17
# ---------------------------------------------------------------------------

def logs_layout_plain(ts, tsid, mask):
    if ts.numel() == 0:
        ts_min = torch.zeros((), dtype=torch.int64, device=ts.device)
        kp = ts_min + 2
    else:
        any_valid = mask.any()
        ts_min = torch.where(any_valid, torch.where(mask, ts, I64_MAX).amin(),
                             0)
        ts_max = torch.where(any_valid,
                             torch.where(mask, ts, _TS_MAX_INIT).amax(), 0)
        kp = ts_max - ts_min + 2
    key = torch.where(mask, tsid.to(torch.int64) * kp + (ts - ts_min),
                      I64_MAX)
    return key, ts_min, kp


def logs_layout(ts: torch.Tensor, tsid: torch.Tensor, mask: torch.Tensor):
    """``(key [N] int64, ts_min, kp)`` of the resident log table in its own
    (tsid, ts) order: ``key = tsid * kp + (ts - ts_min)`` on live rows,
    ``I64_MAX`` elsewhere, with ``kp = max(ts) - min(ts) + 2`` over the
    live rows (``ts_min = 0``, ``kp = 2`` without one).  ``ts_min`` and
    ``kp`` are 0-d int64 tensors on the inputs' device (no host sync)."""
    n = ts.shape[0]
    ts = _want("logs_layout", ts, torch.int64, (n,))
    tsid = _want("logs_layout", tsid, torch.int32, (n,))
    mask = _want("logs_layout", mask, torch.bool, (n,))
    if _on_cpu("logs_layout", ts, tsid, mask):
        return logs_layout_plain(ts, tsid, mask)
    dev = ts.device
    key = torch.empty(n, dtype=torch.int64, device=dev)
    acc = torch.empty(3, dtype=torch.int64, device=dev)
    scal = torch.empty(2, dtype=torch.int64, device=dev)
    rc = _load().gt_logs_layout(
        ts.data_ptr(), tsid.data_ptr(), mask.data_ptr(), n, acc.data_ptr(),
        key.data_ptr(), scal[0].data_ptr(), scal[1].data_ptr(),
        _stream_ptr(ts))
    logs_layout.launches += 1
    _check(rc, "logs_layout")
    return key, scal[0], scal[1]


logs_layout.launches = 0


# ---------------------------------------------------------------------------
# line_vals: K17
# ---------------------------------------------------------------------------

def _passes(codes, verified, mask):
    safe = torch.clamp(codes, 0, verified.shape[0] - 1).to(torch.int64)
    return mask & (codes >= 0) & verified[safe], safe


def line_vals_plain(codes, verified, mask, blen=None):
    ok, safe = _passes(codes, verified, mask)
    ind = torch.where(ok, 1.0, 0.0).to(torch.float32)
    if blen is None:
        return ind, ind
    return torch.where(ok, blen[safe], 0.0).to(torch.float32), ind


def line_vals(codes: torch.Tensor, verified: torch.Tensor,
              mask: torch.Tensor, blen: "torch.Tensor | None" = None):
    """``(vals, ind)`` [N] f32: ``ind`` is 1.0 on live rows whose line code
    passes the combined filters (``verified[code]``; code -1 never
    passes), 0.0 elsewhere; ``vals`` is the passing rows' ``blen[code]``
    (0.0 elsewhere) when ``blen`` [npad] f32 is given, else ``ind``
    itself."""
    n = codes.shape[0]
    npad = verified.shape[0]
    codes = _want("line_vals", codes, torch.int32, (n,))
    verified = _want("line_vals", verified, torch.bool, (npad,))
    mask = _want("line_vals", mask, torch.bool, (n,))
    if blen is not None:
        blen = _want("line_vals", blen, torch.float32, (npad,))
    if npad == 0:
        raise ValueError("line_vals: empty verified vector")
    if _on_cpu("line_vals", codes, verified, mask, blen):
        return line_vals_plain(codes, verified, mask, blen)
    ind = torch.empty(n, dtype=torch.float32, device=codes.device)
    vals = torch.empty_like(ind) if blen is not None else None
    rc = _load().gt_line_vals(
        codes.data_ptr(), verified.data_ptr(), npad, mask.data_ptr(),
        blen.data_ptr() if blen is not None else None, n, ind.data_ptr(),
        vals.data_ptr() if vals is not None else None, _stream_ptr(codes))
    line_vals.launches += 1
    _check(rc, "line_vals")
    return (vals if vals is not None else ind), ind


line_vals.launches = 0


# ---------------------------------------------------------------------------
# row_match: K17
# ---------------------------------------------------------------------------

def row_match_plain(codes, verified, mask, ts, tsid, sel, lo, hi):
    ok, _safe = _passes(codes, verified, mask)
    ok = ok & (ts >= lo) & (ts < hi)
    return ok & torch.isin(tsid, sel)


def row_match(codes: torch.Tensor, verified: torch.Tensor,
              mask: torch.Tensor, ts: torch.Tensor, tsid: torch.Tensor,
              sel: torch.Tensor, lo: int, hi: int,
              num_series: int = 0) -> torch.Tensor:
    """Row mask [N] bool of a log (stream) query: live, ``lo <= ts < hi``,
    the line code passes (``verified[code]``, code >= 0) and ``tsid`` is
    in ``sel`` [S] int32 (any order; -1 pads match nothing since tsids
    are >= 0).  ``num_series`` sizes the kernel's membership bitmap
    (tsids at or past it are looked up in ``sel`` directly)."""
    n = codes.shape[0]
    npad = verified.shape[0]
    codes = _want("row_match", codes, torch.int32, (n,))
    verified = _want("row_match", verified, torch.bool, (npad,))
    mask = _want("row_match", mask, torch.bool, (n,))
    ts = _want("row_match", ts, torch.int64, (n,))
    tsid = _want("row_match", tsid, torch.int32, (n,))
    sel = _want("row_match", sel, torch.int32)
    if sel.dim() != 1:
        raise ValueError("row_match: sel must be 1-d")
    if npad == 0:
        raise ValueError("row_match: empty verified vector")
    if _on_cpu("row_match", codes, verified, mask, ts, tsid, sel):
        return row_match_plain(codes, verified, mask, ts, tsid, sel, lo, hi)
    dev = codes.device
    nbits = max(int(num_series), 0)
    bitmap = torch.empty(max((nbits + 31) // 32, 1), dtype=torch.int32,
                         device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    rc = _load().gt_row_match(
        codes.data_ptr(), verified.data_ptr(), npad, mask.data_ptr(),
        ts.data_ptr(), tsid.data_ptr(), sel.data_ptr(), sel.shape[0],
        bitmap.data_ptr(), nbits, int(lo), int(hi), n, out.data_ptr(),
        _stream_ptr(codes))
    row_match.launches += 1
    _check(rc, "row_match")
    return out


row_match.launches = 0


def reset_launch_counts() -> None:
    fp_candidates.launches = 0
    logs_layout.launches = 0
    line_vals.launches = 0
    row_match.launches = 0
