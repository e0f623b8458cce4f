"""Build and bind the hand-written CUDA sources of ``csrc/``.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under the repository's ``.gitignore``d
``build/kernels/`` and is bound with ctypes: no PyTorch headers, so a
build takes seconds.  A library newer than its source is reused.
``build_many`` starts one ``nvcc`` per stale source, all at once.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = REPO / "build" / "kernels"
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_many(specs, force: bool = False) -> list[Path]:
    """Compile each ``(source, library, flags)`` whose library is missing
    or older than its source (every one with ``force``), one ``nvcc``
    process per source, all started together.  Raises on a failed build,
    with nvcc's output."""
    procs = []
    for source, library, flags in specs:
        if (not force and library.exists()
                and library.stat().st_mtime >= source.stat().st_mtime):
            continue
        library.parent.mkdir(parents=True, exist_ok=True)
        tmp = library.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc(), *flags, "-o", str(tmp), str(source)]
        procs.append((cmd, tmp, library, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, library, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
        else:
            os.replace(tmp, library)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library for _source, library, _flags in specs]


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
