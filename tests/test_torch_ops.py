"""Port parity: ops/time.py and combine_keys/decompose_keys.

The same int64 inputs, made from a seed with numpy, go through the JAX
reference (greptimedb_tpu.ops) and the torch port (greptimedb_tpu_torch.ops);
integer results must be equal exactly.  Inputs include negative
timestamps (floor, not truncation, below the epoch) and poisoned -1 codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import segment as ref_segment
from greptimedb_tpu.ops import time as ref_time
from greptimedb_tpu_torch.ops import segment as port_segment
from greptimedb_tpu_torch.ops import time as port_time

_DAY_MS = 86_400_000


def _timestamps(seed: int = 3) -> np.ndarray:
    """Epoch-ms timestamps across eras: negative (pre-1970), near zero,
    calendar edges and far future, plus random ones."""
    rng = np.random.default_rng(seed)
    fixed = np.array([
        0, -1, 1, -999, -1000, -1001, _DAY_MS - 1, -_DAY_MS, -_DAY_MS - 1,
        951_782_400_000,        # 2000-02-29 (leap day)
        -2_208_988_800_000,     # 1900-01-01
        1_451_606_400_000,      # 2016-01-01, the TSBS epoch
        4_102_444_800_000,      # 2100-01-01 (not a leap year)
        -62_135_596_800_000,    # 0001-01-01
    ], dtype=np.int64)
    rand = rng.integers(-4_000_000_000_000, 4_000_000_000_000, size=500,
                        dtype=np.int64)
    return np.concatenate([fixed, rand])


def _port(fn, ts: np.ndarray, *args):
    out = fn(torch.from_numpy(ts.copy()), *args)
    return out.numpy()


def _ref(fn, ts: np.ndarray, *args):
    return np.asarray(fn(jnp.asarray(ts), *args))


@pytest.mark.parametrize("unit", ["second", "minute", "hour", "day", "week",
                                  "month", "quarter", "year"])
def test_date_trunc_bucket_every_unit(unit):
    ts = _timestamps()
    want = _ref(ref_time.date_trunc_bucket, ts, unit)
    got = _port(port_time.date_trunc_bucket, ts, unit)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # the host evaluator calls the same function on numpy arrays
    np.testing.assert_array_equal(port_time.date_trunc_bucket(ts, unit), want)


def test_date_trunc_unknown_unit_raises():
    with pytest.raises(ValueError):
        port_time.date_trunc_bucket(torch.zeros(1, dtype=torch.int64),
                                    "fortnight")


@pytest.mark.parametrize("part", ["second", "minute", "hour", "dow", "epoch",
                                  "day", "month", "quarter", "year", "doy"])
def test_date_part_of(part):
    ts = _timestamps(5)
    want = _ref(ref_time.date_part_of, ts, part)
    got = _port(port_time.date_part_of, ts, part)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interval,origin", [
    (10_000, 0), (3_600_000, 0), (7, -3), (300_000, 1_451_606_400_000),
    (60_000, -45_000),
])
def test_time_bucket_floors_below_zero(interval, origin):
    ts = _timestamps(7)
    want = _ref(ref_time.time_bucket, ts, interval, origin)
    got = _port(port_time.time_bucket, ts, interval, origin)
    np.testing.assert_array_equal(got, want)
    # floor, not truncation: every bucket start is <= its timestamp
    assert (got <= ts).all() and (ts - got < interval).all()


@pytest.mark.parametrize("start", [0, -10_000, 1_451_606_400_000])
def test_bucket_index_poisons_before_start(start):
    ts = _timestamps(9)
    want = _ref(ref_time.bucket_index, ts, 10_000, start)
    got = _port(port_time.bucket_index, ts, 10_000, start)
    np.testing.assert_array_equal(got, want)
    assert (got[ts < start] == -1).all()


def test_civil_round_trip():
    days = np.arange(-800_000, 800_000, 997, dtype=np.int64)
    y, m, d = port_time.civil_from_days(torch.from_numpy(days))
    ry, rm, rd = ref_time.civil_from_days(jnp.asarray(days))
    for a, b in ((y, ry), (m, rm), (d, rd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = port_time.days_from_civil(y, m, d)
    np.testing.assert_array_equal(back.numpy(), days)


@pytest.mark.parametrize("cards", [[3, 4], [5], [2, 3, 7], [4096, 8]])
def test_combine_keys_with_poisoned_codes(cards):
    rng = np.random.default_rng(len(cards))
    n = 300
    keys = []
    for c in cards:
        k = rng.integers(-1, c + 1, size=n).astype(np.int32)  # -1 and c: bad
        keys.append(k)
    want, want_total = ref_segment.combine_keys(
        [jnp.asarray(k) for k in keys], cards)
    got, total = port_segment.combine_keys(
        [torch.from_numpy(k) for k in keys], cards)
    assert total == want_total
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bad = np.zeros(n, bool)
    for k, c in zip(keys, cards):
        bad |= (k < 0) | (k >= c)
    assert (got.numpy()[bad] == -1).all()


@pytest.mark.parametrize("cards", [[3, 4], [4096, 16], [2, 2, 2, 2]])
def test_decompose_keys_inverts_combine(cards):
    total = int(np.prod(cards))
    ids = np.arange(total, dtype=np.int64)
    want = ref_segment.decompose_keys(jnp.asarray(ids), cards)
    got = port_segment.decompose_keys(torch.from_numpy(ids), cards)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    again, _ = port_segment.combine_keys(got, cards)
    np.testing.assert_array_equal(again.numpy(), ids)
