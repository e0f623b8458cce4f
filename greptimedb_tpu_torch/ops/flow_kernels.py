"""The flow fold's state kernel: flow_merge.

A hand-written CUDA kernel (``csrc/flow_kernels.cu``) merges one chunk's
per-affected-slot partials into a streaming flow's resident ``[Gpad,
Wpad]`` accumulator matrices, in place, and gathers the merged slots back
out for the sink upsert; it replaces the state half of K15 (the JAX
reference's ``greptimedb_tpu/flow/device.py:452-492``).  The chunk
partials come from the ``segment_reduce`` kernel (``flow/device.py``
``chunk_partials``).  The plain PyTorch version beside it is taken only
for tensors on the CPU; a CUDA tensor launches the kernel or raises.
``flow_merge.launches`` counts the launches.

Accumulator kinds (``KINDS``): ``add_f64`` / ``add_i64`` (running sums and
counts), ``min_f64`` / ``max_f64``, ``pick`` (a first/last value, decided
by its companion timestamp accumulator ``links[a]``) and ``ts_min`` /
``ts_max`` (those companions).  The merge order is the reference's: the
OLD ``rows`` count decides ``fresh``, the OLD companion timestamps decide
whether a pick wins (touched, and fresh or strictly better: the state wins
ties), and ``rows`` is added last.  Pad slots (``aff_g`` outside ``[0,
Gpad)``: the reference's dropped scatters) touch no state and give zero
outputs.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops.cuda_build import check as _check
from greptimedb_tpu_torch.ops.cuda_build import on_cpu as _on_cpu
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

SOURCE = cuda_build.CSRC / "flow_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_flow.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS
KINDS = {"add_f64": 0, "add_i64": 1, "min_f64": 2, "max_f64": 3, "pick": 4,
         "ts_min": 5, "ts_max": 6}
MAX_ACC = 48  # csrc kMaxAcc
_I64_KINDS = ("add_i64", "ts_min", "ts_max")

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/flow_kernels.cu`` into ``build/kernels/``."""
    return cuda_build.build_many([(SOURCE, LIBRARY, NVCC_FLAGS)], force)[0]


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gt_flow_merge.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, ll,
                                      ll, ll, vp]
        lib.gt_flow_merge.restype = i
        _lib = lib
        return lib


def _check_args(state, chunk, rows_any, aff_g, aff_w, kinds, links):
    A = len(kinds)
    if len(state) != A + 1 or len(chunk) != A or len(links) != A:
        raise ValueError(f"flow_merge: {A} kinds need {A + 1} state, {A} "
                         "chunk and links")
    if A > MAX_ACC:
        raise ValueError(f"flow_merge: {A} accumulators, at most {MAX_ACC}")
    shape = tuple(state[-1].shape)
    apad = aff_g.shape[0]
    for a, k in enumerate(kinds):
        if k not in KINDS:
            raise ValueError(f"flow_merge: unknown kind {k!r}")
        want = torch.int64 if k in _I64_KINDS else torch.float64
        if state[a].dtype != want or chunk[a].dtype != want:
            raise ValueError(f"flow_merge: accumulator {a} ({k}) must be "
                             f"{want}")
        if tuple(state[a].shape) != shape or chunk[a].shape != (apad,):
            raise ValueError(f"flow_merge: accumulator {a} shapes")
        if k == "pick" and kinds[links[a]] not in ("ts_min", "ts_max"):
            raise ValueError(f"flow_merge: pick {a} links to {links[a]}")
    if state[-1].dtype != torch.int64 or len(shape) != 2:
        raise ValueError("flow_merge: rows must be int64 [Gpad, Wpad]")
    if (rows_any.dtype != torch.int64 or rows_any.shape != (apad,)
            or aff_w.shape != (apad,)):
        raise ValueError("flow_merge: rows_any int64, aff_g / aff_w [apad]")


def flow_merge_plain(state, chunk, rows_any, aff_g, aff_w, kinds, links):
    """The merge on torch index ops: pad slots are cut out before any
    index touches the state (torch's ``index_put_`` raises where JAX's
    ``mode="drop"`` drops)."""
    gpad, wpad = state[-1].shape
    apad = aff_g.shape[0]
    live = (aff_g >= 0) & (aff_g < gpad) & (aff_w >= 0) & (aff_w < wpad)
    sel = torch.nonzero(live).flatten()
    flat = aff_g[sel].to(torch.int64) * wpad + aff_w[sel].to(torch.int64)
    views = [s.view(-1) for s in state]
    old_rows = views[-1][flat]
    ra = rows_any[sel]
    fresh = old_rows == 0
    touched = ra > 0
    better = {}
    for a, k in enumerate(kinds):
        if k in ("ts_min", "ts_max"):
            cv, cur = chunk[a][sel], views[a][flat]
            strictly = cv > cur if k == "ts_max" else cv < cur
            better[a] = touched & (fresh | strictly)
    outs = []
    for a, k in enumerate(kinds):
        cv, cur = chunk[a][sel], views[a][flat]
        if k in ("add_f64", "add_i64"):
            nv = cur + cv
        elif k == "min_f64":
            nv = torch.where(cv < cur, cv, cur)
        elif k == "max_f64":
            nv = torch.where(cv > cur, cv, cur)
        elif k == "pick":
            nv = torch.where(better[links[a]], cv, cur)
        else:
            ext = (torch.maximum(cur, cv) if k == "ts_max"
                   else torch.minimum(cur, cv))
            nv = torch.where(touched, torch.where(fresh, cv, ext), cur)
        views[a][flat] = nv
        out = torch.zeros(apad, dtype=nv.dtype, device=nv.device)
        out[sel] = nv
        outs.append(out)
    views[-1][flat] = old_rows + ra
    out = torch.zeros(apad, dtype=torch.int64, device=ra.device)
    out[sel] = old_rows + ra
    outs.append(out)
    return outs


def flow_merge(state, chunk, rows_any, aff_g, aff_w, kinds, links):
    """Merge the chunk partials ``chunk`` (A tensors [apad]) and the chunk
    row counts ``rows_any`` [apad] into ``state`` (A + 1 contiguous
    tensors [Gpad, Wpad], rows last) at the affected slots ``(aff_g,
    aff_w)`` [apad] int32, in place.  Returns the A + 1 merged slot values
    [apad] (zeros at pad slots)."""
    _check_args(state, chunk, rows_any, aff_g, aff_w, kinds, links)
    if _on_cpu("flow_merge", *state, *chunk, rows_any, aff_g, aff_w):
        return flow_merge_plain(state, chunk, rows_any, aff_g, aff_w, kinds,
                                links)
    if aff_g.dtype != torch.int32 or aff_w.dtype != torch.int32:
        raise ValueError("flow_merge: aff_g / aff_w must be int32 on CUDA")
    if any(not s.is_contiguous() for s in state):
        raise ValueError("flow_merge: state must be contiguous (in place)")
    A = len(kinds)
    apad = aff_g.shape[0]
    gpad, wpad = state[-1].shape
    chunk = [c.contiguous() for c in chunk]
    rows_any, aff_g, aff_w = (rows_any.contiguous(), aff_g.contiguous(),
                              aff_w.contiguous())
    outs = [torch.empty(apad, dtype=s.dtype, device=s.device) for s in state]
    vp = ctypes.c_void_p
    rc = _load().gt_flow_merge(
        A, (ctypes.c_int * max(A, 1))(*[KINDS[k] for k in kinds]),
        (ctypes.c_int * max(A, 1))(*[int(x) for x in links]),
        (vp * (A + 1))(*[s.data_ptr() for s in state]),
        (vp * max(A, 1))(*[c.data_ptr() for c in chunk]),
        (vp * (A + 1))(*[o.data_ptr() for o in outs]),
        rows_any.data_ptr(), aff_g.data_ptr(), aff_w.data_ptr(), apad, gpad,
        wpad, _stream_ptr(aff_g))
    flow_merge.launches += 1
    _check(rc, "flow_merge")
    return outs


flow_merge.launches = 0


def reset_launch_counts() -> None:
    flow_merge.launches = 0
