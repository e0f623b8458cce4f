"""Build and bind the hand-written CUDA sources of ``csrc/``.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under the repository's ``.gitignore``d
``build/kernels/`` and is bound with ctypes: no PyTorch headers, so a
build takes seconds.  A library newer than its source and every shared
header of ``csrc/`` (``*.cuh``) is reused.
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
SCAN_TILE = 4096   # elements a tile of scan.cuh's launch_scan (kScanTile)
SORT_TILE = 4096   # keys a tile of scan.cuh's radix_pass (kSortTile)
RADIX_BINS = 256   # 8-bit digits (kRadixBins)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_many(specs, force: bool = False) -> list[Path]:
    """Compile each ``(source, library, flags)`` whose library is missing
    or older than its source or a ``csrc/*.cuh`` header (every one with
    ``force``), one ``nvcc`` process per source, all started together.
    Raises on a failed build, with nvcc's output."""
    procs = []
    headers = [h.stat().st_mtime for h in CSRC.glob("*.cuh")]
    for source, library, flags in specs:
        if (not force and library.exists() and library.stat().st_mtime
                >= max([source.stat().st_mtime, *headers])):
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


def scan_scratch(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Tile status of one ``launch_scan`` over n elements of ``dtype``
    (scan.cuh ``ScanTiles``), then the tile counter: for integer sums a
    64-bit status word a tile (flag and value in one), for float sums each
    tile's aggregate and inclusive prefix and its flag."""
    tiles = max(1, -(-n // SCAN_TILE))
    if dtype.is_floating_point:
        size = tiles * (2 * torch.finfo(dtype).bits // 8 + 4) + 4
    else:
        size = tiles * 8 + 4
    return torch.empty(size, dtype=torch.uint8, device=device)


def radix_status(n: int, device) -> torch.Tensor:
    """Status words of one ``radix_pass`` over n keys: the tile counter,
    then a word a (tile, digit).  Every pass resets them."""
    tiles = max(1, -(-n // SORT_TILE))
    return torch.empty(1 + tiles * RADIX_BINS, dtype=torch.int64,
                       device=device)


def radix_digits(bits: int) -> tuple[bool, list[int]]:
    """The digit plan of an LSD radix sort of keys below ``2**bits``:
    whether the keys need 64 bits (else 32), and the shift of each 8-bit
    digit pass, least significant first (at least one pass)."""
    if not 0 <= bits <= 64:
        raise ValueError(f"radix_digits: {bits} bits")
    return bits > 32, list(range(0, max(bits, 1), 8))


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s card as an int, through torch's raw
    getter: ~0.1 us a call on the H100, where
    ``torch.cuda.current_stream(dev).cuda_stream`` takes 3-8 us to build
    a Stream object (measured by ``time_scans.py grid``)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_cpu(what: str, *tensors) -> bool:
    """True for CPU tensors (the plain version), False for CUDA tensors all
    on one device (the kernel); raises otherwise.  ``None`` entries are
    skipped."""
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return False
