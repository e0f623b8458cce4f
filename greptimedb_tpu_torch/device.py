"""Device selection for the port: the card unless the caller asks for the CPU.

There is no fallback: a caller that did not ask for the CPU gets the CUDA
device or an error, so a missing card can never masquerade as a slow run.
"""

from __future__ import annotations

import torch

from greptimedb_tpu_torch.errors import InvalidArguments


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda"/"cuda:N" → that CUDA device (raises when CUDA is
    absent); "cpu" → the CPU.  A ``torch.device`` passes through the same
    checks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise InvalidArguments(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise InvalidArguments(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
