"""Time bucketing: date_bin / date_trunc / date_part over epoch integers.

Torch counterpart of the reference's ``ops/time.py``.  Pure integer
arithmetic over epoch timestamps — the device never sees calendars.  Every
function takes a torch tensor (device work) or a numpy array (the host
evaluator shapes results with the same code).  Division and modulo FLOOR,
including below zero: ``torch.div(..., rounding_mode="floor")`` and
``torch.remainder``, never truncation or ``fmod``.
"""

from __future__ import annotations

import numpy as np
import torch

# Fixed-width truncation units expressible as integer modulo in ms.
_FIXED_MS = {
    "second": 1_000,
    "minute": 60_000,
    "hour": 3_600_000,
    "day": 86_400_000,
    "week": 7 * 86_400_000,
}
_DAY_MS = 86_400_000


def _i64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return np.asarray(x).astype(np.int64)


def _fdiv(a, b):
    """Floor division on tensors, arrays and Python ints alike."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.div(a, b, rounding_mode="floor")
    return a // b


def _mod(a, b):
    """Floor modulo (the result takes the divisor's sign)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.remainder(a, b)
    return a % b


def _int(cond):
    """Boolean → 0/1 integers (torch refuses arithmetic on bool tensors)."""
    if isinstance(cond, torch.Tensor):
        return cond.to(torch.int64)
    return np.asarray(cond).astype(np.int64)


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def time_bucket(ts, interval: int, origin: int = 0):
    """Floor timestamps to interval-aligned buckets (date_bin semantics),
    in the timestamp's own unit; floor (not truncate-toward-zero) below
    zero."""
    shifted = _i64(ts) - origin
    return _fdiv(shifted, interval) * interval + origin


def bucket_index(ts, interval: int, start: int):
    """Bucket ordinal relative to a range start — the dense group code for
    time axes (negative → -1, poisoning combine_keys)."""
    idx = _fdiv(_i64(ts) - start, interval)
    return _where(ts >= start, idx, -1)


def civil_from_days(z):
    """Days-since-epoch → (year, month, day), proleptic Gregorian UTC
    (Howard Hinnant's civil_from_days in floor-division arithmetic)."""
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + 3 - 12 * _int(mp >= 10)
    y = y + _int(m <= 2)
    return y, m, d


def days_from_civil(y, m, d):
    """(year, month, day) → days since epoch (inverse of
    civil_from_days; same integer-only arithmetic)."""
    y = y - _int(m <= 2)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m + 12 * _int(m < 3) - 3
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def date_trunc_bucket(ts_ms, unit: str):
    """date_trunc over ms timestamps (UTC).  Fixed-width units truncate by
    integer modulo; week aligns to Monday (epoch day 0 was a Thursday,
    offset 3); month/quarter/year go through the civil-calendar integer
    conversion."""
    u = unit.lower()
    if u == "week":
        w = _FIXED_MS["week"]
        return _fdiv(_i64(ts_ms) + 3 * _DAY_MS, w) * w - 3 * _DAY_MS
    if u in _FIXED_MS:
        return time_bucket(ts_ms, _FIXED_MS[u])
    if u in ("month", "quarter", "year"):
        days = _fdiv(_i64(ts_ms), _DAY_MS)
        y, m, _d = civil_from_days(days)
        if u == "year":
            m = m * 0 + 1
        elif u == "quarter":
            m = _fdiv(m - 1, 3) * 3 + 1
        return days_from_civil(y, m, 1) * _DAY_MS
    raise ValueError(f"unknown date_trunc unit: {unit}")


def date_part_of(ms, part: str):
    """date_part/extract over ms timestamps (UTC) — pure integer
    arithmetic, so one implementation serves the device compile and the
    host evaluator."""
    p = part.lower()
    if p in ("second", "seconds"):
        return _mod(_fdiv(ms, 1000), 60)
    if p in ("minute", "minutes"):
        return _mod(_fdiv(ms, 60_000), 60)
    if p in ("hour", "hours"):
        return _mod(_fdiv(ms, 3_600_000), 24)
    if p in ("dow", "dayofweek"):
        return _mod(_fdiv(ms, _DAY_MS) + 4, 7)  # 0 = Sunday
    if p in ("epoch",):
        return _fdiv(ms, 1000)
    days = _fdiv(ms, _DAY_MS)
    y, m, d = civil_from_days(days)
    if p in ("day", "days"):
        return d
    if p in ("month", "months"):
        return m
    if p == "quarter":
        return _fdiv(m - 1, 3) + 1
    if p in ("year", "years"):
        return y
    if p in ("doy", "dayofyear"):
        return days - days_from_civil(y, m * 0 + 1, d * 0 + 1) + 1
    raise ValueError(f"unknown date_part unit: {part}")
