"""Exact vector search's distances (K22): vec_distance.

A hand-written CUDA kernel (``csrc/vector_kernels.cu``) computes the
distance from one query vector to every row of a ``[D, dim]`` f32 matrix
of distinct vectors: the device half of the JAX reference's
``_vocab_distances`` (``greptimedb_tpu/query/exprs.py:853``), which
``_compile_vec_distance`` (``:890``) and the host evaluator gather to rows
by dictionary code.  The plain PyTorch version beside it is taken only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.
``vec_distance.launches`` counts the launches.

Distances (``OPS``): ``vec_dot_product`` ``M @ q``; ``vec_l2sq_distance``
``sum((M - q)**2, 1)``; ``vec_cos_distance``
``1 - (M @ q) / max(|M| |q|, 1e-30)``.  Rows whose ``valid`` flag is unset
(their text did not parse) get NaN.  The kernel sums in f32 in its own
order (see the source), so it agrees with the plain version and with the
reference to rounding; with integer components whose sums stay below 2^24
dot and L2^2 are exact.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops.cuda_build import check as _check
from greptimedb_tpu_torch.ops.cuda_build import on_cpu as _on_cpu
from greptimedb_tpu_torch.ops.cuda_build import stream_ptr as _stream_ptr

SOURCE = cuda_build.CSRC / "vector_kernels.cu"
LIBRARY = cuda_build.BUILD_DIR / "libgreptime_vector.so"
NVCC_FLAGS = cuda_build.BASE_FLAGS
OPS = {"vec_dot_product": 0, "vec_l2sq_distance": 1, "vec_cos_distance": 2}

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False):
    """Compile ``csrc/vector_kernels.cu`` into ``build/kernels/``."""
    return cuda_build.build_many([(SOURCE, LIBRARY, NVCC_FLAGS)], force)[0]


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gt_vec_distance.argtypes = [vp, vp, ll, i, vp, i, i, vp, vp]
        lib.gt_vec_distance.restype = i
        _lib = lib
        return lib


def _check_args(mat, valid, q, name):
    if name not in OPS:
        raise ValueError(f"vec_distance: unknown distance {name!r}")
    if mat.dtype != torch.float32 or mat.dim() != 2:
        raise ValueError("vec_distance: mat must be f32 [D, dim]")
    if q.dtype != torch.float32 or tuple(q.shape) != (mat.shape[1],):
        raise ValueError(f"vec_distance: q must be f32 [{mat.shape[1]}]")
    if valid.dtype != torch.bool or tuple(valid.shape) != (mat.shape[0],):
        raise ValueError(f"vec_distance: valid must be bool [{mat.shape[0]}]")


def vec_distance_plain(mat, valid, q, name: str):
    """The reference's formulas in torch f32."""
    if name == "vec_dot_product":
        d = mat @ q
    elif name == "vec_l2sq_distance":
        d = torch.sum((mat - q[None, :]) ** 2, dim=1)
    else:
        denom = torch.linalg.norm(mat, dim=1) * torch.linalg.norm(q)
        d = 1.0 - (mat @ q) / torch.clamp(denom, min=1e-30)
    return torch.where(valid, d, float("nan"))


def vec_distance(mat, valid, q, name: str) -> torch.Tensor:
    """Distance ``name`` (a key of ``OPS``) from ``q`` (f32 [dim]) to every
    row of ``mat`` (f32 [D, dim]); f32 [D], NaN where ``valid`` (bool [D])
    is unset."""
    _check_args(mat, valid, q, name)
    if _on_cpu("vec_distance", mat, valid, q):
        return vec_distance_plain(mat, valid, q, name)
    D, dim = mat.shape
    if dim >= 1 << 31:
        raise ValueError(f"vec_distance: {dim} components exceed int32")
    mat, valid, q = mat.contiguous(), valid.contiguous(), q.contiguous()
    out = torch.empty(D, dtype=torch.float32, device=mat.device)
    vec4 = int(dim % 4 == 0 and mat.data_ptr() % 16 == 0
               and q.data_ptr() % 16 == 0)
    rc = _load().gt_vec_distance(mat.data_ptr(), valid.data_ptr(), D, dim,
                                 q.data_ptr(), OPS[name], vec4,
                                 out.data_ptr(), _stream_ptr(mat))
    vec_distance.launches += 1
    _check(rc, "vec_distance")
    return out


vec_distance.launches = 0


def reset_launch_counts() -> None:
    vec_distance.launches = 0
