"""The sketch kernels: hll_fold and udd_fold, each with a merge mode.

Hand-written CUDA kernels (``csrc/sketch_kernels.cu``) carry the device
work of the HyperLogLog and UDDSketch aggregates; each has a plain PyTorch
version here.  The wrappers pick by where the tensors lie: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (or raises —
there is no fallback).  Each kernel counts its launches in
``hll_fold.launches`` / ``udd_fold.launches``, incremented only where a
wrapper launches it (both modes of a kernel count on it).

- ``hll_fold`` replaces K18 (the JAX reference's
  ``greptimedb_tpu/ops/sketch.py:49`` ``hll_fold``); ``hll_merge`` is its
  merge mode (``:80`` ``hll_merge_fold``).
- ``udd_fold`` replaces K19 (``ops/sketch.py:136-200``: ``udd_keys``,
  ``udd_key_extremes``, ``udd_bucket_counts``, ``udd_fold``);
  ``udd_merge`` is its merge mode (``:203`` ``udd_merge_fold``);
  ``udd_extremes`` runs its key pass alone and ``udd_fold(extremes=...)``
  its count pass alone, for the mesh's local phase.

Where the reference's CPU arithmetic and its own docstrings part, the port
keeps the docstrings, in integers on both routes:

- the HLL rank is the exact leading-zero count of the 31-bit word
  ``w = h2 >> 1`` (``32 - bit_length(w)``); the reference computes
  ``31 - floor(log2(float32(w)))``, which XLA's CPU rounds to the next
  integer for some ``w`` within ``2^(k-8)`` of a power of two ``2^k``;
- the UDDSketch collapse factor is the least power of two ``>= need``; the
  reference's ``exp2(ceil(log2(need)))`` gives 7 for 8 and 15 for 16 on
  XLA's CPU.

The hash runs on uint32 words: the CUDA kernel in ``uint32_t``; the plain
version in int64 masked to 32 bits, with the multiplies split so that no
product leaves int64 (torch's ``>>`` on int32 would be arithmetic).
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

SOURCE = cuda_build.CSRC / "sketch_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_sketch.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS
HLL_PRECISION = 12
HLL_M = 1 << HLL_PRECISION
K_SENTINEL = 1 << 30
_M32 = 0xFFFFFFFF

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/sketch_kernels.cu`` into ``build/kernels/`` (skipped
    when the library is newer than its source)."""
    return cuda_build.build_many([(SOURCE, LIBRARY, NVCC_FLAGS)], force)[0]


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, i, d = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_double)
        sigs = {
            "gt_hll_fold": [vp, i, vp, vp, ll, ll, vp, vp],
            "gt_hll_merge": [vp, vp, ll, vp, vp, ll, ll, vp, vp],
            "gt_udd_fold": [vp, i, vp, vp, ll, ll, d, ll, i, vp, vp, vp,
                            vp],
            "gt_udd_merge": [vp, vp, ll, ll, vp, vp, vp, ll, ll, vp, vp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        _lib = lib
        return lib


def _rows_args(what, vals, gid, ng, mask):
    n = gid.shape[0]
    if gid.dim() != 1 or vals.shape != (n,):
        raise ValueError(f"{what}: values {tuple(vals.shape)} and ids "
                         f"{tuple(gid.shape)} must be [n]")
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=gid.device)
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise ValueError(f"{what}: mask must be bool [{n}]")
    if ng < 1 or ng >= 1 << 31:
        raise ValueError(f"{what}: {ng} groups outside [1, 2^31)")
    return mask


def _live(gid, ng, mask):
    return mask & (gid >= 0) & (gid < ng)


# ---------------------------------------------------------------------------
# hll_fold (K18)
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32): the multiply split
    into 16-bit halves of ``c``, so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32_plain(x):
    """murmur3's 32-bit finalizer on int64 words in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def bit_length(w):
    """Bit length of int64 ``w`` >= 0 (0 for 0), exact below 2^53."""
    _m, e = torch.frexp(w.to(torch.float64))
    return torch.where(w > 0, e.to(torch.int64), 0)


def hll_hash_plain(vals):
    """Per row: (register index, rank, hashable) — the reference's hash of
    the value widened to f64, with the exact leading-zero rank of
    ``w = h2 >> 1`` (``32 - bit_length(w)``; 32 for w = 0).  ``hashable``
    is False for NaN and +-inf."""
    v = vals.to(torch.float64)
    ok = torch.isfinite(v)
    v = torch.where(ok, v, 0.0)
    vi = torch.floor(v)
    k = torch.clamp(vi, -9.2e18, 9.2e18).to(torch.int64)
    lo = k & _M32
    hi = (k >> 32) & _M32
    frac = ((v - vi) * float(1 << 30)).to(torch.int64)
    h1 = mix32_plain(lo ^ mix32_plain(hi ^ mix32_plain(frac)))
    h2 = mix32_plain(((frac + 0x9E3779B9) & _M32) ^ h1)
    idx = h1 >> (32 - HLL_PRECISION)
    rho = 32 - bit_length(h2 >> 1)
    return idx, rho, ok


def hll_fold_plain(vals, gid, ng: int, mask=None):
    """[ng, 4096] int32 registers: the max rank per (group, register) over
    the live rows with finite values (a scatter-max, as the reference's)."""
    mask = _rows_args("hll_fold", vals, gid, ng, mask)
    idx, rho, ok = hll_hash_plain(vals)
    live = _live(gid, ng, mask) & ok
    cell = torch.where(live, gid.to(torch.int64) * HLL_M + idx, ng * HLL_M)
    grid = torch.zeros(ng * HLL_M + 1, dtype=torch.int32, device=gid.device)
    grid.scatter_reduce_(0, cell, torch.where(live, rho, 0).to(torch.int32),
                         "amax", include_self=True)
    return grid[:-1].reshape(ng, HLL_M)


def hll_merge_plain(codes, vocab, gid, ng: int, mask=None):
    """Each live row's vocabulary register vector (by its code) max-merged
    into its group: [ng, 4096] int32."""
    mask = _rows_args("hll_merge", codes, gid, ng, mask)
    nv = vocab.shape[0]
    ok = _live(gid, ng, mask) & (codes >= 0) & (codes < nv)
    rows = vocab[torch.clamp(codes.to(torch.int64), 0, max(nv - 1, 0))]
    rows = torch.where(ok[:, None], rows, 0)
    ids = torch.where(ok, gid.to(torch.int64), ng)
    grid = torch.zeros((ng + 1, HLL_M), dtype=torch.int32,
                       device=gid.device)
    grid.scatter_reduce_(0, ids[:, None].expand(-1, HLL_M),
                         rows.to(torch.int32), "amax")
    return grid[:ng]


def hll_fold(vals, gid, ng: int, mask=None):
    """HLL registers [ng, 4096] int32 of ``vals`` (f32 or f64, [n]) by the
    int32 group ids ``gid``."""
    mask = _rows_args("hll_fold", vals, gid, ng, mask)
    if _on_cpu("hll_fold", vals, gid, mask):
        return hll_fold_plain(vals, gid, ng, mask)
    if vals.dtype not in (torch.float32, torch.float64):
        vals = vals.to(torch.float64)
    vals, gid, mask = vals.contiguous(), _i32(gid), mask.contiguous()
    regs = torch.zeros((ng, HLL_M), dtype=torch.int32, device=gid.device)
    rc = _load().gt_hll_fold(vals.data_ptr(), int(vals.dtype == torch.float64),
                             gid.data_ptr(), mask.data_ptr(), gid.shape[0],
                             ng, regs.data_ptr(), _stream_ptr(gid))
    hll_fold.launches += 1
    _check(rc, "hll_fold")
    return regs


hll_fold.launches = 0


def hll_merge(codes, vocab, gid, ng: int, mask=None):
    """Merge mode of ``hll_fold``: the max-merge of stored register vectors
    ``vocab`` [nv, 4096] int32 picked by the int ``codes`` per row."""
    mask = _rows_args("hll_merge", codes, gid, ng, mask)
    if vocab.dim() != 2 or vocab.shape[1] != HLL_M:
        raise ValueError(f"hll_merge: vocab must be [nv, {HLL_M}]")
    if _on_cpu("hll_merge", codes, vocab, gid, mask):
        return hll_merge_plain(codes, vocab, gid, ng, mask)
    codes, gid, mask = _i32(codes), _i32(gid), mask.contiguous()
    vocab = vocab.to(torch.int32).contiguous()
    regs = torch.zeros((ng, HLL_M), dtype=torch.int32, device=gid.device)
    rc = _load().gt_hll_merge(codes.data_ptr(), vocab.data_ptr(),
                              vocab.shape[0], gid.data_ptr(), mask.data_ptr(),
                              gid.shape[0], ng, regs.data_ptr(),
                              _stream_ptr(gid))
    hll_fold.launches += 1
    _check(rc, "hll_fold (merge)")
    return regs


def _i32(t):
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    return t.contiguous()


# ---------------------------------------------------------------------------
# udd_fold (K19)
# ---------------------------------------------------------------------------

def udd_keys_plain(vals, mask, gamma: float):
    """(base-gamma key per row, validity): key k covers (gamma^(k-1),
    gamma^k]; only positive finite values count."""
    v = vals.to(torch.float64)
    ok = mask & (v > 0) & torch.isfinite(v)
    v = torch.where(ok, v, 1.0)
    k = torch.ceil(torch.log(torch.clamp(v, min=1e-300))
                   / math.log(gamma)).to(torch.int64)
    return torch.where(ok, k, 0), ok


def udd_key_extremes_plain(k, ok, gid, ng: int):
    """Per-group (k_min, k_max) int64 with the empty-group sentinels
    (2^30, -2^30)."""
    live = _live(gid, ng, ok)
    ids = torch.where(live, gid.to(torch.int64), ng)
    kmin = torch.full((ng + 1,), K_SENTINEL, dtype=torch.int64,
                      device=k.device)
    kmin.scatter_reduce_(0, ids, torch.where(live, k, K_SENTINEL), "amin")
    kmax = torch.full((ng + 1,), -K_SENTINEL, dtype=torch.int64,
                      device=k.device)
    kmax.scatter_reduce_(0, ids, torch.where(live, k, -K_SENTINEL), "amax")
    return kmin[:ng], kmax[:ng]


def udd_collapse_plain(kmin, kmax, nb: int):
    """The collapse factor per group: the least power of two >= need =
    ceil((span + 2) / nb), span = max(k_max - k_min + 1, 1)."""
    span = torch.clamp(kmax - kmin + 1, min=1)
    need = (span + 2 + nb - 1) // nb
    return torch.ones_like(need) << bit_length(need - 1)


def udd_bucket_counts_plain(k, ok, gid, ng: int, nb: int, kmin, kmax):
    """([ng, nb] int64 counts, [ng] collapse c): buckets widen to c base
    keys, the grid starts at floor(k_min / c) * c and base key k belongs
    to bucket ceil((k - base) / c), clamped to [0, nb)."""
    c = udd_collapse_plain(kmin, kmax, nb)
    base = torch.div(kmin, c, rounding_mode="floor") * c
    gidc = torch.clamp(gid.to(torch.int64), 0, ng - 1)
    c_row, base_row = c[gidc], base[gidc]
    idx = torch.clamp(torch.div(k - base_row + c_row - 1, c_row,
                                rounding_mode="floor"), 0, nb - 1)
    live = _live(gid, ng, ok)
    cell = torch.where(live, gid.to(torch.int64) * nb + idx, ng * nb)
    grid = torch.zeros(ng * nb + 1, dtype=torch.int64, device=k.device)
    grid.index_add_(0, cell, live.to(torch.int64))
    return grid[:-1].reshape(ng, nb), c


def udd_extremes_plain(vals, gid, ng: int, mask, gamma: float):
    mask = _rows_args("udd_extremes", vals, gid, ng, mask)
    k, ok = udd_keys_plain(vals, mask, gamma)
    return udd_key_extremes_plain(k, ok, gid, ng)


def udd_fold_plain(vals, gid, ng: int, mask, gamma: float, nb: int,
                   extremes=None):
    mask = _rows_args("udd_fold", vals, gid, ng, mask)
    k, ok = udd_keys_plain(vals, mask, gamma)
    kmin, kmax = (udd_key_extremes_plain(k, ok, gid, ng) if extremes is None
                  else extremes)
    counts, c = udd_bucket_counts_plain(k, ok, gid, ng, nb, kmin, kmax)
    return torch.cat([counts, kmin[:, None], c[:, None]], dim=1)


def udd_merge_plain(codes, vocab, cfg_ids, gid, ng: int, mask=None):
    mask = _rows_args("udd_merge", codes, gid, ng, mask)
    nv, width = vocab.shape
    safe = torch.clamp(codes.to(torch.int64), 0, max(nv - 1, 0))
    cfg = cfg_ids.to(torch.int64)[safe]
    ok = (_live(gid, ng, mask) & (codes >= 0) & (codes < nv) & (cfg >= 0))
    rows = torch.where(ok[:, None], vocab[safe].to(torch.int64), 0)
    ids = torch.where(ok, gid.to(torch.int64), ng)
    grid = torch.zeros((ng + 1, width), dtype=torch.int64, device=gid.device)
    grid.index_add_(0, ids, rows)
    cmin = torch.full((ng + 1,), K_SENTINEL, dtype=torch.int64,
                      device=gid.device)
    cmin.scatter_reduce_(0, ids, torch.where(ok, cfg, K_SENTINEL), "amin")
    cmax = torch.full((ng + 1,), -1, dtype=torch.int64, device=gid.device)
    cmax.scatter_reduce_(0, ids, torch.where(ok, cfg, -1), "amax")
    return torch.cat([grid[:ng], cmin[:ng, None], cmax[:ng, None]], dim=1)


def _udd_launch(what, vals, gid, ng, mask, gamma, nb, passes, kmin, kmax,
                out):
    if vals.dtype not in (torch.float32, torch.float64):
        vals = vals.to(torch.float64)
    vals, gid, mask = vals.contiguous(), _i32(gid), mask.contiguous()
    rc = _load().gt_udd_fold(
        vals.data_ptr(), int(vals.dtype == torch.float64), gid.data_ptr(),
        mask.data_ptr(), gid.shape[0], ng, math.log(gamma), nb, passes,
        kmin.data_ptr(), kmax.data_ptr(),
        out.data_ptr() if out is not None else None, _stream_ptr(gid))
    udd_fold.launches += 1
    _check(rc, what)


def udd_extremes(vals, gid, ng: int, mask, gamma: float):
    """The key pass of ``udd_fold`` alone: per group (k_min, k_max) int64
    [ng] of the live rows' base-gamma keys, the sentinels (2^30, -2^30)
    where a group has none.  The mesh merges these across shards and hands
    the global extremes to ``udd_fold(extremes=...)``."""
    mask = _rows_args("udd_extremes", vals, gid, ng, mask)
    if _on_cpu("udd_extremes", vals, gid, mask):
        return udd_extremes_plain(vals, gid, ng, mask, gamma)
    dev = gid.device
    kmin = torch.full((ng,), K_SENTINEL, dtype=torch.int64, device=dev)
    kmax = torch.full((ng,), -K_SENTINEL, dtype=torch.int64, device=dev)
    _udd_launch("udd_fold (extremes)", vals, gid, ng, mask, gamma, 1, 1,
                kmin, kmax, None)
    return kmin, kmax


def udd_fold(vals, gid, ng: int, mask, gamma: float, nb: int,
             extremes=None):
    """[ng, nb + 2] int64: the bucket counts of ``vals`` (f32 or f64)
    per group, then k_min and the collapse factor c.  ``extremes``:
    (k_min, k_max) int64 [ng] from outside (the mesh's global extremes)
    in place of the groups' own; the key pass is then skipped."""
    mask = _rows_args("udd_fold", vals, gid, ng, mask)
    if nb < 1:
        raise ValueError("udd_fold: nb must be >= 1")
    if extremes is not None and any(
            e.dtype != torch.int64 or e.shape != (ng,) for e in extremes):
        raise ValueError(f"udd_fold: extremes must be int64 [{ng}]")
    if _on_cpu("udd_fold", vals, gid, mask,
               *(extremes if extremes is not None else ())):
        return udd_fold_plain(vals, gid, ng, mask, gamma, nb, extremes)
    dev = gid.device
    if extremes is None:
        kmin = torch.full((ng,), K_SENTINEL, dtype=torch.int64, device=dev)
        kmax = torch.full((ng,), -K_SENTINEL, dtype=torch.int64, device=dev)
        passes = 3
    else:
        kmin, kmax = (e.contiguous() for e in extremes)
        passes = 2
    out = torch.zeros((ng, nb + 2), dtype=torch.int64, device=dev)
    _udd_launch("udd_fold", vals, gid, ng, mask, gamma, nb, passes, kmin,
                kmax, out)
    return out


udd_fold.launches = 0


def udd_merge(codes, vocab, cfg_ids, gid, ng: int, mask=None):
    """Merge mode of ``udd_fold``: [ng, width + 2] int64, the sums of the
    stored count rows ``vocab`` [nv, width] picked by ``codes``, then the
    min and max config id of the group's selected rows (2^30 and -1 where
    none)."""
    mask = _rows_args("udd_merge", codes, gid, ng, mask)
    if vocab.dim() != 2 or cfg_ids.shape != (vocab.shape[0],):
        raise ValueError("udd_merge: vocab [nv, width], cfg_ids [nv]")
    if _on_cpu("udd_merge", codes, vocab, cfg_ids, gid, mask):
        return udd_merge_plain(codes, vocab, cfg_ids, gid, ng, mask)
    codes, gid, mask = _i32(codes), _i32(gid), mask.contiguous()
    vocab = vocab.to(torch.int64).contiguous()
    cfg = _i32(cfg_ids)
    nv, width = vocab.shape
    out = torch.zeros((ng, width + 2), dtype=torch.int64, device=gid.device)
    out[:, width] = K_SENTINEL
    out[:, width + 1] = -1
    rc = _load().gt_udd_merge(codes.data_ptr(), vocab.data_ptr(), nv, width,
                              cfg.data_ptr(), gid.data_ptr(), mask.data_ptr(),
                              gid.shape[0], ng, out.data_ptr(),
                              _stream_ptr(gid))
    udd_fold.launches += 1
    _check(rc, "udd_fold (merge)")
    return out


def reset_launch_counts() -> None:
    hll_fold.launches = 0
    udd_fold.launches = 0
