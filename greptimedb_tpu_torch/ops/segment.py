"""Dense group keys: row-major combine/decompose of dictionary codes.

Torch counterpart of ``combine_keys``/``decompose_keys`` in the
reference's ``ops/segment.py`` — the key mixing of a dense-grid GROUP BY
(tags are dictionary codes, so a group id is a mixed-radix number).  The
scatter/sort segment reductions wait for the row-path slice.
"""

from __future__ import annotations

import torch


def combine_keys(keys: list[torch.Tensor], cards: list[int]
                 ) -> tuple[torch.Tensor, int]:
    """Row-major combine of dense key codes into one int64 id per row.

    ``cards[i]`` is the (static) cardinality bound of ``keys[i]``.  Codes
    outside [0, card) (e.g. -1 for "unseen") poison the row id to -1 so the
    caller's mask can drop it.
    """
    total = 1
    for c in cards:
        total *= int(c)
    out = torch.zeros(keys[0].shape, dtype=torch.int64, device=keys[0].device)
    bad = torch.zeros(keys[0].shape, dtype=torch.bool, device=keys[0].device)
    for k, c in zip(keys, cards):
        k64 = k.to(torch.int64)
        bad = bad | (k64 < 0) | (k64 >= c)
        out = out * c + k64.clamp(0, c - 1)
    return torch.where(bad, torch.full_like(out, -1), out), total


def decompose_keys(seg_ids: torch.Tensor, cards: list[int]
                   ) -> list[torch.Tensor]:
    """Invert combine_keys for a dense grid: group id → per-key codes
    (floor modulo/division, so the inverse holds for every int64 id)."""
    out = []
    rem = seg_ids.to(torch.int64)
    for c in reversed(cards):
        out.append(torch.remainder(rem, c).to(torch.int32))
        rem = torch.div(rem, c, rounding_mode="floor")
    return list(reversed(out))
