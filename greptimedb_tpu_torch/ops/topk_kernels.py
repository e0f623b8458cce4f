"""The raw scan's device top-k: topk_select.

A hand-written CUDA kernel (``csrc/topk_kernels.cu``) selects the first k
rows of ``ORDER BY <numeric columns> LIMIT k`` on the device, in the
order of the JAX reference's ``jnp.lexsort`` (the top-k branch of
``greptimedb_tpu/query/physical.py:1961-1984``), so only k rows cross to
the host.  The plain PyTorch version beside it is taken only for tensors
on the CPU; a CUDA tensor launches the kernel or raises.
``topk_select.launches`` counts the calls that launch it; ``.candidates``
and ``.rows`` count them by route (the candidate buffer, or the 8-bit
levels over all rows when the first digit's bin overflows the buffer) and
``full_passes()`` their passes over all N rows.  A call waits on the card
once (twice when pass 1's histogram does not stand).  The design is in
the CUDA source.

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
        sigs = {
            "gt_topk_plan": [vp, i, i, i, vp, vp, ll, vp, vp],
            "gt_topk_candidates": [vp, i, i, i, vp, ll, vp, vp, vp, vp, vp,
                                   i, i, ll, i, i, i, ll, vp, vp],
            "gt_topk_rows": [vp, i, i, vp, ll, ll, vp, vp, vp, vp, vp, vp],
            "gt_topk_order": [vp, i, i, vp, vp, ll, i, i, vp, vp, vp, vp, vp,
                              vp, vp, vp],
        }
        for name, argt in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argt
            fn.restype = i
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


# csrc state words of the candidate route (enum cK ... cValid), in order
STATE = ("k", "live", "and", "or", "target", "rem", "key", "shift", "width",
         "pick", "pick_cnt", "final", "out", "cnt0", "cnt1", "buf", "phase",
         "ticket", "s_and", "s_or", "s_live", "valid")
_S = {name: i for i, name in enumerate(STATE)}
DIGIT_BITS = 11      # csrc kDigitBits: a digit of the candidate route
BINS = 1 << DIGIT_BITS
STEP_THREADS, STEP_ITEMS = 256, 4  # csrc kStepThreads, kStepItems
STEP_GRID_MAX = 528  # blocks of a phase launch over the candidates
MAX_STEPS = 12       # phase launches over many candidates at most
FINISH_MAX = 16_384  # candidates left to the one-block finish
SORT_SMEM = 200 * 1024  # shared bytes of the finish block's sort
SORT_CAP = 4096      # rows the finish block sorts at most
SORT_MIN = 512       # rows it refines to before sorting, at least


def _levels(cols) -> list:
    """The rows route's 8-bit levels, most significant first: the mask's
    class, then each key's order key from its top byte down, as
    ``(key, shift)``."""
    out = [(-1, 0)]
    for j, c in enumerate(cols):
        out += [(j, s) for s in range(_TYPES[c.dtype][1] - 8, -1, -8)]
    return out


def _descriptors(cols, keys, levels) -> list:
    """csrc ``Desc``: column pointers, types and flags, then per level its
    key and shift."""
    d = [c.data_ptr() for c in cols]
    d += [_TYPES[c.dtype][0] for c in cols]
    d += [(0 if asc else 1) | (2 if _nulls_first(asc, nf) else 0)
          for _v, asc, nf in keys]
    d += [lv[0] for lv in levels]
    d += [lv[1] for lv in levels]
    return d


def order_bits(cols, n: int) -> int:
    """The widest the composite sort key of chosen rows can be: the class
    bit, each key's order key, the row index's bits."""
    return (1 + sum(_TYPES[c.dtype][1] for c in cols)
            + max(n - 1, 1).bit_length())


def candidate_capacity(n: int) -> int:
    """Rows the candidate buffer may hold: the picked bin of the first
    digit must fit, else the rows route runs."""
    return min(n, max(n // 4, 1 << 16))


def sort_capacity(nkeys: int) -> int:
    """Rows the finish block sorts in shared memory (a power of two): an
    order key a key, the row, the class and a 16-bit index each."""
    cap = SORT_CAP
    while cap > 1 and cap * (8 * nkeys + 7) > SORT_SMEM:
        cap //= 2
    return cap


def sort_stop(k: int, cap: int) -> int:
    """Rows at which the finish block stops refining and sorts (k <= cap):
    a phase over a few thousand rows costs less than sorting them."""
    return min(cap, max(2 * k, SORT_MIN))


def step_plan(n: int, bits: list, shift0: int, c0: int) -> tuple:
    """(phase launches, blocks each) over the c0 candidates of the first
    split: the first key's digits below its first (at ``shift0``), a range
    and the digits of every later key and of the row index, at most
    ``MAX_STEPS``; none when the one-block finish can take them."""
    if c0 <= FINISH_MAX:
        return 0, 1
    steps = 2 * -(-shift0 // DIGIT_BITS)
    for b in bits[1:] + [max(n - 1, 1).bit_length()]:
        steps += 1 + 2 * -(-b // DIGIT_BITS)
    grid = min(STEP_GRID_MAX, -(-c0 // (STEP_THREADS * STEP_ITEMS)))
    return min(steps, MAX_STEPS), max(grid, 1)


def topk_select(keys, mask, k: int):
    """The first k rows of a stable lexsort by ``keys`` (a list of
    ``(column [N], asc, nulls_first)``, most significant first;
    ``nulls_first`` None takes the default) with the rows where ``mask``
    (bool [N]) is unset last.  Returns ``(rows, n)``: ``rows`` the int64
    row indices [min(k, N)] in that order, ``n`` = min(rows with the mask
    set, k), the rows the caller keeps.  On the card the wrapper counts
    its route (``topk_select.candidates`` / ``.rows``) and its passes over
    all N rows (``full_passes()``)."""
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
    levels = _levels(cols)
    desc = _descriptors(cols, keys, levels)
    nd, nk, nl = len(desc), len(cols), len(levels)
    lib = _load()
    stream = _stream_ptr(mask)
    cap = sort_capacity(nk)
    # the descriptors and the state, uploaded by the first C call; the
    # histogram's bins after them, then the answer when the finish block
    # sorts it (k <= cap)
    head = nd + len(STATE) + BINS // 2
    ws = torch.empty(head + (k if k <= cap else 0), dtype=torch.int64,
                     device=dev)
    init = [0] * len(STATE)
    init[_S["k"]] = k
    init[_S["and"]] = init[_S["s_and"]] = -1
    host = (ctypes.c_longlong * (nd + len(STATE)))(*desc, *init)
    back = (ctypes.c_longlong * len(STATE))()
    _check(lib.gt_topk_plan(host, nd, nk, nl, ws.data_ptr(),
                            mask.data_ptr(), n, back, stream),
           "topk_select (plan)")
    topk_select.launches += 1
    kept = min(back[_S["live"]], k)
    plan_passes = 1 if back[_S["valid"]] else 2
    args = (ws, nd, nk, nl, mask, n, k, lib, stream, order_bits(cols, n))
    if back[_S["final"]] or back[_S["pick_cnt"]] <= candidate_capacity(n):
        topk_select.candidates += 1
        topk_select.full_passes += plan_passes + 1
        return _candidates(args, cols, back, cap, head), kept
    topk_select.rows += 1
    return _rows_route(args, plan_passes), kept


def _candidates(args, cols, back, cap: int, head: int):
    """The split pass and the phases over the candidates (see the CUDA
    source)."""
    ws, nd, nk, nl, mask, n, k, lib, stream, _bits = args
    c0 = max(0 if back[_S["final"]] else back[_S["pick_cnt"]], 1)
    # one buffer: the two candidate key lists (int64), then the two row
    # lists and the output (int32)
    buf = torch.empty(2 * c0 + c0 + (k + 1) // 2, dtype=torch.int64,
                      device=mask.device)
    ints = buf[2 * c0:].view(torch.int32)
    keys = (buf.data_ptr(), buf.data_ptr() + 8 * c0)
    rows = (ints.data_ptr(), ints.data_ptr() + 4 * c0)
    out = ints[2 * c0:2 * c0 + k]
    small = k <= cap
    result = ws[head:] if small else ws
    steps, grid = step_plan(n, [_TYPES[c.dtype][1] for c in cols],
                            back[_S["shift"]], c0)
    _check(lib.gt_topk_candidates(
        ws.data_ptr(), nd, nk, nl, mask.data_ptr(), n, rows[0], rows[1],
        keys[0], keys[1], out.data_ptr(), steps, grid, FINISH_MAX,
        int(small), cap, sort_stop(k, cap), cap * (8 * nk + 7),
        result.data_ptr(), stream), "topk_select (candidates)")
    if small:
        return result
    return _sort_chosen(args, out)


def _rows_route(args, plan_passes: int):
    """The 8-bit levels over N and the row-order collect (see the CUDA
    source): the overflow of the candidate buffer."""
    ws, nd, nk, nl, mask, n, k, lib, stream, _bits = args
    dev = mask.device
    cand = torch.empty(n, dtype=torch.uint8, device=dev)
    hist = torch.empty(nl * 256 + 1, dtype=torch.int32, device=dev)
    rst = torch.empty(4 + nl, dtype=torch.int64, device=dev)
    tiles = cuda_build.scan_scratch(n, torch.int64, dev)
    sel = torch.empty(k, dtype=torch.int32, device=dev)
    _check(lib.gt_topk_rows(ws.data_ptr(), nk, nl, mask.data_ptr(), n, k,
                            cand.data_ptr(), hist.data_ptr(), rst.data_ptr(),
                            tiles.data_ptr(), sel.data_ptr(), stream),
           "topk_select (rows)")
    rows = _sort_chosen(args, sel)
    # the plan's passes and the collect; the levels that ran (the last
    # level picked, plus one) stay on the card until full_passes() reads
    # them
    topk_select.full_passes += plan_passes + 1
    with _pending_lock:
        _pending_levels.append(rst[2])
        drain = len(_pending_levels) >= _PENDING_MAX
    if drain:
        full_passes()
    return rows


def _sort_chosen(args, sel):
    """The k chosen rows ``sel`` (int32, in any order) in key order, by
    ``gt_topk_order`` with no host sync: the varying bits of (class,
    keys..., row) packed into a composite of ``order_bits`` bits at most,
    sorted by 8-bit radix passes."""
    ws, nd, nk, nl, mask, n, k, lib, stream, bits = args
    dev = mask.device
    nw = -(-bits // 64)
    words = nk + 2
    # int64 scratch: acc, the composite, two key buffers, two int32 index
    # buffers, the [nw, 8, 256] uint32 histograms
    hist_at = 2 * words + nw * k + 2 * k + k
    scratch = torch.empty(hist_at + nw * 8 * 256 // 2, dtype=torch.int64,
                          device=dev)
    comp_at = 2 * words
    keys_at = comp_at + nw * k
    idx = scratch[keys_at + 2 * k:hist_at].view(torch.int32)
    status = cuda_build.radix_status(k, dev)
    result = torch.empty(k, dtype=torch.int64, device=dev)
    _check(lib.gt_topk_order(
        ws.data_ptr(), nk, nl, mask.data_ptr(), sel.data_ptr(), k, nw, bits,
        scratch.data_ptr(), scratch[comp_at:].data_ptr(),
        scratch[keys_at:].data_ptr(), idx.data_ptr(),
        scratch[hist_at:].data_ptr(), status.data_ptr(), result.data_ptr(),
        stream), "topk_select (order)")
    return result


topk_select.launches = 0
topk_select.candidates = 0
topk_select.rows = 0
topk_select.full_passes = 0


_pending_levels = []  # the rows route's last level picked, on the card
_pending_lock = threading.Lock()
_PENDING_MAX = 256    # read them at most this many calls apart


def full_passes() -> int:
    """Passes over all N rows since the last reset: ``topk_select.
    full_passes`` plus the levels of the rows route's calls, which the
    call leaves on the card and this reads (a sync)."""
    with _pending_lock:
        pending = _pending_levels[:]
        _pending_levels.clear()
    for last in pending:
        topk_select.full_passes += int(last) + 1
    return topk_select.full_passes


def reset_launch_counts() -> None:
    topk_select.launches = 0
    topk_select.candidates = 0
    topk_select.rows = 0
    topk_select.full_passes = 0
    with _pending_lock:
        _pending_levels.clear()
