"""Whole-chain fusion gate of the PromQL path.

The reference's query-compiler subsystem (fused XLA programs, persistent
compile cache, AOT warmup) has one part the port needs: the fused
selection→window→group chain (``fused.py``) and its
``GREPTIME_PLAN_FUSION`` switch.  The port compiles nothing per shape, so
there is no compile cache or warmup to port.
"""

from __future__ import annotations

import os

__all__ = ["fusion_enabled"]


def fusion_enabled() -> bool:
    """GREPTIME_PLAN_FUSION gate for the fused PromQL chain.  ``off``
    restores the multi-step path (window statistics + eager epilogue +
    group reduce) — the twin every fusion parity test compares against."""
    return os.environ.get("GREPTIME_PLAN_FUSION", "on").lower() not in (
        "off", "0", "false")
