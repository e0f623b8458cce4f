"""The raw scan's device top-k: topk_select.

A hand-written CUDA kernel (``csrc/topk_kernels.cu``) selects the first k
rows of ``ORDER BY <numeric columns> LIMIT k`` on the device, in the
order of the JAX reference's ``jnp.lexsort`` (the top-k branch of
``greptimedb_tpu/query/physical.py:1961-1984``), so only k rows cross to
the host.  The plain PyTorch version beside it is taken only for tensors
on the CPU; a CUDA tensor launches the kernel or raises.
``topk_select.launches`` counts the launches.

Key semantics, the reference's:

- a float key's NaN gets rank 0 (NULLS FIRST) or 2 (NULLS LAST; the
  default is NULLS FIRST exactly when DESC) and reads as 0; every other
  value has rank 1, and the rank orders before the value;
- DESC negates the value in the column's own dtype, with its wrap:
  INT64_MIN stays INT64_MIN (first under DESC), and an unsigned 0 stays 0
  and sorts first under DESC while 1 becomes the dtype's largest value;
- ``-0.0`` and ``+0.0`` compare equal;
- rows where ``mask`` is unset sort last; equal rows keep row order.

Bool keys read as int8 (the reference's int32 cast orders them alike).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.ops.cuda_build import check as _check
from greptimedb_tpu_torch.ops.cuda_build import on_cpu as _on_cpu
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

SOURCE = cuda_build.CSRC / "topk_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_topk.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS
# csrc KeyType and the bits of each value's order key
_TYPES = {torch.float32: (0, 32), torch.float64: (1, 64),
          torch.int64: (2, 64), torch.int32: (3, 32), torch.int16: (4, 16),
          torch.int8: (5, 8), torch.uint8: (6, 8), torch.uint16: (7, 16),
          torch.uint32: (8, 32)}
_SCAN_TILE = 4096

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/topk_kernels.cu`` into ``build/kernels/``."""
    return cuda_build.build_many([(SOURCE, LIBRARY, NVCC_FLAGS)], force)[0]


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gt_topk_select.argtypes = [vp, i, i, vp, ll, ll, vp, vp, vp, vp,
                                       vp, vp]
        lib.gt_topk_words.argtypes = [vp, i, i, vp, vp, ll, vp, vp, vp]
        lib.gt_topk_select.restype = i
        lib.gt_topk_words.restype = i
        _lib = lib
        return lib


def _key_column(v: torch.Tensor) -> torch.Tensor:
    return v.view(torch.int8) if v.dtype == torch.bool else v


def _nulls_first(asc: bool, nulls_first) -> bool:
    return (not asc) if nulls_first is None else bool(nulls_first)


def sort_words(v: torch.Tensor, asc: bool, nulls_first=None) -> list:
    """One ORDER BY key as int64 words whose signed order, most significant
    word first, is the reference's lexsort order of the key: the rank and
    the value for a float key, the value alone otherwise."""
    v = _key_column(v)
    if v.dtype not in _TYPES:
        raise ValueError(f"topk_select: unsupported key dtype {v.dtype}")
    if v.is_floating_point():
        isnull = torch.isnan(v)
        nf = _nulls_first(asc, nulls_first)
        rank = torch.where(isnull, 0 if nf else 2, 1).to(torch.int64)
        v = torch.where(isnull, 0.0, v)
        if not asc:
            v = -v
        v = torch.where(v == 0, 0.0, v)  # -0.0 == +0.0
        if v.dtype == torch.float32:
            b = v.view(torch.int32)
            word = torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)
        else:
            b = v.view(torch.int64)
            word = torch.where(b < 0, b ^ sk.I64_MAX, b)
        return [rank, word]
    bits = _TYPES[v.dtype][1]
    if bits == 64:
        return [v if asc else torch.neg(v)]  # two's complement: wraps
    x = v.to(torch.int64)
    if not asc:
        x = -x
    size = 1 << bits
    if v.dtype in (torch.uint8, torch.uint16, torch.uint32):
        return [x & (size - 1)]
    half = size >> 1
    return [((x + half) & (size - 1)) - half]


def _check_args(keys, mask):
    if not keys:
        raise ValueError("topk_select: no keys")
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError("topk_select: mask must be bool [N]")
    n = mask.shape[0]
    for v, _asc, _nf in keys:
        if v.dim() != 1 or v.shape[0] != n:
            raise ValueError(f"topk_select: key {tuple(v.shape)}, want [{n}]")
        if _key_column(v).dtype not in _TYPES:
            raise ValueError(f"topk_select: unsupported key dtype {v.dtype}")


def topk_select_plain(keys, mask, k: int):
    """A stable lexsort: argsorts from the least significant word up, the
    mask last; the first k rows."""
    n = mask.shape[0]
    order = torch.arange(n, device=mask.device)
    words = [w for v, asc, nf in keys for w in sort_words(v, asc, nf)]
    for w in reversed(words):
        order = order[torch.argsort(w[order], stable=True)]
    order = order[torch.argsort((~mask[order]).to(torch.int8), stable=True)]
    k = min(k, n)
    return order[:k], min(int(mask.sum()), k)


def _descriptors(cols, keys, levels) -> list:
    """csrc ``Desc``: column pointers, types and flags, then per level its
    key, part and shift."""
    d = [c.data_ptr() for c in cols]
    d += [_TYPES[c.dtype][0] for c in cols]
    d += [(0 if asc else 1) | (2 if _nulls_first(asc, nf) else 0)
          for _v, asc, nf in keys]
    d += [lv[0] for lv in levels]
    d += [lv[1] for lv in levels]
    d += [lv[2] for lv in levels]
    return d


def topk_select(keys, mask, k: int):
    """The first k rows of a stable lexsort by ``keys`` (a list of
    ``(column [N], asc, nulls_first)``, most significant first;
    ``nulls_first`` None takes the default) with the rows where ``mask``
    (bool [N]) is unset last.  Returns ``(rows, n)``: ``rows`` the int64
    row indices [min(k, N)] in that order, ``n`` = min(rows with the mask
    set, k), the rows the caller keeps."""
    _check_args(keys, mask)
    if k < 0:
        raise ValueError(f"topk_select: k = {k}")
    if _on_cpu("topk_select", mask, *[v for v, _a, _n in keys]):
        return topk_select_plain(keys, mask, k)
    n, dev = mask.shape[0], mask.device
    if n >= 1 << 31:
        raise ValueError(f"topk_select: {n} rows exceed int32 indices")
    k = min(k, n)
    if k == 0:
        return torch.empty(0, dtype=torch.int64, device=dev), 0
    cols = [_key_column(v).contiguous() for v, _a, _n in keys]
    mask = mask.contiguous()
    levels = [(-1, 0, 0)]  # the invalid flag
    parts = 0
    for j, c in enumerate(cols):
        if c.is_floating_point():
            levels.append((j, 0, 0))
            parts += 1
        levels += [(j, 1, s) for s in range(_TYPES[c.dtype][1] - 8, -1, -8)]
        parts += 1
    desc = torch.tensor(_descriptors(cols, keys, levels),
                        dtype=torch.int64).to(dev)
    nl = len(levels)
    cand = torch.empty(n, dtype=torch.uint8, device=dev)
    hist = torch.empty((nl, 256), dtype=torch.int32, device=dev)
    st = torch.empty(4 + nl, dtype=torch.int64, device=dev)
    tiles = torch.empty(-(-n // _SCAN_TILE), dtype=torch.int64, device=dev)
    sel = torch.empty(k, dtype=torch.int32, device=dev)
    lib = _load()
    stream = _stream_ptr(mask)
    rc = lib.gt_topk_select(desc.data_ptr(), len(cols), nl, mask.data_ptr(),
                            n, k, cand.data_ptr(), hist.data_ptr(),
                            st.data_ptr(), tiles.data_ptr(), sel.data_ptr(),
                            stream)
    topk_select.launches += 1
    _check(rc, "topk_select")
    words = torch.empty((parts, k), dtype=torch.int64, device=dev)
    valid = torch.empty(k, dtype=torch.bool, device=dev)
    _check(lib.gt_topk_words(desc.data_ptr(), len(cols), nl, mask.data_ptr(),
                             sel.data_ptr(), k, words.data_ptr(),
                             valid.data_ptr(), stream),
           "topk_select (words)")
    # the k survivors in row order, sorted by their words from the least
    # significant up with the stable radix_argsort; the mask decides last
    perm = None
    for p in range(parts - 1, -1, -1):
        w = words[p] if perm is None else words[p][perm]
        ok = None if p else (valid if perm is None else valid[perm])
        o = sk.radix_argsort(w, valid=ok).to(torch.int64)
        perm = o if perm is None else perm[o]
    rows = sel.to(torch.int64)[perm]
    return rows, min(int(st[3]), k)


topk_select.launches = 0


def reset_launch_counts() -> None:
    topk_select.launches = 0
