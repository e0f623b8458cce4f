"""Segment reductions: the group-by engine of the row path.

Torch counterpart of the reference's ``ops/segment.py``: a GROUP BY is
(combine key codes) → (segment sum/min/max) → (decompose codes), tags
being dictionary codes so a group id is a mixed-radix number (dense grid)
or, for sparse keys, a rank from a sort (``compact_groups``).

The device work runs in the hand-written kernels of
``ops/segment_kernels.py`` (``segment_reduce``, ``sorted_segment_reduce``,
``compact``, ``rank_scatter``, ``radix_argsort``); each function here
dispatches through them, so a CUDA tensor takes the kernel and a CPU
tensor its plain version.  What surrounds them (the NULL rules, dtype
widening, the gathers of ``segment_first_last``) is torch elementwise
code, as the reference's is jnp.

Dtype rules mirror the reference: float aggregates in the input float
dtype, integer sum/min/max in int64, the mean of integers an int64 sum
divided in float32.  Empty segments: float min/max/mean/sum → NaN, int
min/max → 0 (callers consult a count).
"""

from __future__ import annotations

import torch

from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.ops.masks import valid_mask

_I64_MAX = sk.I64_MAX
_I64_MIN = sk.I64_MIN


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


def _ids32(seg_ids: torch.Tensor, num_segments: int,
           route: bool = False) -> torch.Tensor:
    """Segment ids as int32 for the kernels, ids outside [0, num_segments)
    routed to the overflow id num_segments: always with ``route`` (the
    sorted path, whose trailing padding must sort last), else only where
    an int64 id could wrap into range in the cast."""
    if seg_ids.dtype == torch.int32 and not route:
        return seg_ids
    bad = (seg_ids < 0) | (seg_ids >= num_segments)
    return torch.where(bad, num_segments, seg_ids).to(torch.int32)


def _prep(values, seg_ids, num_segments, mask):
    """Shared validity/overflow-routing: returns (m, ids) with invalid rows
    routed to segment num_segments."""
    m = valid_mask(values, mask if mask is not None else torch.ones(
        values.shape, dtype=torch.bool, device=values.device))
    m = m & (seg_ids >= 0) & (seg_ids < num_segments)
    ids = torch.where(m, seg_ids, num_segments).to(torch.int32)
    return m, ids


def _finish(op: str, is_float: bool, val, cnt):
    """The reference's NULL rules over a reduction's (val, cnt)."""
    nan = float("nan")
    if op == "count":
        return cnt
    if op == "sum":
        # SQL: float SUM over zero rows is NULL; ints have no device NULL
        # and keep 0 (callers mask empty groups via their count)
        return torch.where(cnt > 0, val, nan) if is_float else val
    if op == "mean":
        s = val if is_float else val.to(torch.float32)
        return torch.where(cnt > 0, s / torch.clamp(cnt, min=1).to(s.dtype),
                           nan)
    return torch.where(cnt > 0, val, nan if is_float else 0)


def _reduce(kernel, values, seg_ids, num_segments, op, mask):
    if op not in ("count", "sum", "mean", "min", "max"):
        raise ValueError(f"unknown segment op: {op}")
    is_float = values.is_floating_point()
    ids = _ids32(seg_ids, num_segments,
                 route=kernel is sk.sorted_segment_reduce)
    if op == "count":
        # counts skip NaN values; integer values cannot be NaN, so they
        # are not even read
        _v, cnt = kernel(values if is_float else None, ids, num_segments,
                         "sum", mask)
        return cnt
    kop = "sum" if op == "mean" else op
    val, cnt = kernel(values, ids, num_segments, kop, mask)
    return _finish(op, is_float, val, cnt)


def segment_reduce(values, seg_ids, num_segments: int, op: str, mask=None):
    """Masked, NaN-aware segment reduction (op count/sum/mean/min/max).

    Invalid rows (mask False, NaN value, or seg_id outside
    [0, num_segments)) contribute nothing."""
    return _reduce(sk.segment_reduce, values, seg_ids, num_segments, op,
                   mask)


def segment_mean(values, seg_ids, num_segments: int, mask=None):
    return segment_reduce(values, seg_ids, num_segments, "mean", mask)


def segment_count(values, seg_ids, num_segments: int, mask=None):
    return segment_reduce(values, seg_ids, num_segments, "count", mask)


def segment_first_last(ts, values, seg_ids, num_segments: int, mask=None,
                       last: bool = True):
    """Per-segment (timestamp, value) of the newest (or oldest) valid row.

    Two passes through ``segment_reduce``'s int64 mode: the extreme ts per
    segment, then the lowest row index achieving it; ties at the extreme
    ts take the lowest row index.  Empty segments give ts 0 and a NaN (or,
    for integer values, 0) value.  Reference semantics: TSBS `lastpoint`."""
    n = ts.shape[0]
    m, ids = _prep(values, seg_ids, num_segments, mask)
    op, fill = ("max", _I64_MIN) if last else ("min", _I64_MAX)
    ext, _cnt = sk.segment_reduce(ts.to(torch.int64), ids, num_segments, op,
                                  m)
    ext = torch.cat([ext, ext.new_full((1,), fill)])
    winner = m & (ts == ext[ids])
    idx = torch.arange(n, dtype=torch.int64, device=ts.device)
    win_idx, _cnt = sk.segment_reduce(idx, ids, num_segments, "min", winner)
    has = win_idx < _I64_MAX
    safe = torch.where(has, win_idx, 0)
    out_ts = torch.where(has, ts[safe], 0)
    empty = float("nan") if values.is_floating_point() else 0
    return out_ts, torch.where(has, values[safe], empty).to(values.dtype)


def segment_distinct_count(values, seg_ids, num_segments: int, mask=None):
    """Per-segment count of DISTINCT valid values (COUNT(DISTINCT x)).

    Rows sorted by (segment, value) as two stable radix sweeps, the value
    sweep first (the reference's ``lexsort((values, ids))``); first
    occurrences at (segment, value) changes are counted per segment.  -0.0
    and 0.0 are one value; invalid rows (mask False, NaN, poisoned ids)
    are excluded."""
    m = valid_mask(values, mask if mask is not None else torch.ones(
        values.shape, dtype=torch.bool, device=values.device))
    m = m & (seg_ids >= 0) & (seg_ids < num_segments)
    ids = torch.where(m, seg_ids, num_segments).to(torch.int32)
    by_value = sk.radix_argsort(values, m)
    order = by_value[sk.radix_argsort(ids[by_value])]
    g = ids[order]
    v = values[order]
    first = torch.ones(g.shape, dtype=torch.bool, device=g.device)
    first[1:] = (g[1:] != g[:-1]) | (v[1:] != v[:-1])
    _v, cnt = sk.segment_reduce(None, g, num_segments, "sum",
                                first & (g < num_segments))
    return cnt


def sorted_segment_reduce(values, seg_ids, num_segments: int, op: str,
                          mask=None):
    """Scatter-free segment reduction for NONDECREASING seg_ids, with the
    semantics of ``segment_reduce``.  Out-of-range ids (trailing padding)
    route past the last segment, so the id array stays sorted; masked rows
    keep their sorted ids and are neutralized by the mask."""
    return _reduce(sk.sorted_segment_reduce, values, seg_ids, num_segments,
                   op, mask)


def compact_groups(combined_ids, mask, num_groups: int):
    """Sort-based dense ranking for sparse key spaces.

    Returns (dense_ids [N] int32 — rank of each row's group in sorted key
    order, group_keys [num_groups] — the combined key per rank (I64_MAX
    where none), group_mask [num_groups]).  Rows with mask False or a
    poisoned (-1) key get dense id num_groups."""
    valid_row = mask & (combined_ids >= 0)
    key = torch.where(valid_row, combined_ids.to(torch.int64), _I64_MAX)
    order = sk.radix_argsort(combined_ids, valid_row)
    dense, group_keys = sk.rank_scatter(key, order, valid_row, num_groups)
    return dense, group_keys, group_keys != _I64_MAX
