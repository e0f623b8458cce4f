"""Port parity of the window kernels' range geometry: the series offset
table (``series_offsets``, the first sorted row of every tsid) that
replaces the whole-layout binary searches of K9's searchsorted geometry
(``greptimedb_tpu/promql/engine.py:288-346``, ``_sorted_window_bounds``)
with searches over each series' rows, and ``counter_window``, which sums
each window's counter drops itself instead of reading a whole-table
``prefix_scan`` (the reference's ``gdrop`` cumsum, ``:410``).

- ``series_offsets_plain`` equals ``jnp.searchsorted`` of the reference's
  sorted keys, for series counts below, at and past the data.
- The range geometry's bounds (``range_bounds`` below: the kernel's
  clamp and bisection over each series' rows, emulated with torch) equal
  ``window_bounds_plain``'s searchsorted bounds and the reference's
  exactly, over pad selections, a series with no valid sample, tsids
  past the data and past the table, NaN rows, duplicate timestamps and
  windows before and after the data: the argument of the kernel
  source's header, checked on the CPU.
- ``counter_window`` (no ``gdrop`` argument) against the reference's
  ``counter`` / ``instant`` window body and its ``_extrapolated`` rates:
  counts, timestamps and values exact, ``delta_adj`` and rates within
  ``1e-5*max(1,|b|)``.
- The evaluator builds the table with the sort layout, in its cache
  entry, and no PromQL query calls ``prefix_scan``.

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_promql_ranges_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.promql import engine as ref_engine
from greptimedb_tpu_torch.ops import promql_kernels as pk
from greptimedb_tpu_torch.promql.engine import PromEvaluator
from greptimedb_tpu_torch.promql.parser import parse_promql
from greptimedb_tpu_torch.standalone import GreptimeDB
from test_torch_promql import DDL, M, write_counters
from test_torch_promql_kernels import GEOMETRY, T0, both_layouts, close
from test_torch_promql_kernels import make_table, selection

# make_table kwargs: NaN rows, duplicated (tsid, ts) rows, no valid row
# at all, much padding, in-order rows
TABLES = [
    dict(seed=1), dict(seed=2, dup=25, series=60, scrapes=40),
    dict(seed=3, nan_frac=0.5), dict(seed=6, nan_frac=1.0),
    dict(seed=7, pad=5000), dict(seed=5, shuffle=False, dup=7),
]


def _table(case):
    """make_table with series 5 holding no valid sample."""
    t = make_table(**case)
    t["val"][(t["tsid"] == 5) & t["mask"]] = np.nan
    return t


def _pick(series):
    """Every tsid, a series without samples (5), tsids past the data and
    past any table below (series .. series + 3, 10 * series), repeats."""
    return np.concatenate([np.arange(series + 4)[::-1], [5, 5, 10 * series,
                                                         0]])


def _sel(series):
    pick = _pick(series)
    return torch.from_numpy(selection(series, pick, 1 << len(pick)
                                      .bit_length()))


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", TABLES)
@pytest.mark.parametrize("below", [0, 7, None])
def test_series_offsets_match_reference_searchsorted(case, below):
    """Entry t is the reference layout's first row of key t * kp; the
    last is the layout's length, whatever the series count."""
    t = _table(case)
    ref, port = both_layouts(t)
    n_series = t["series"] if below is None else max(t["series"] - below, 0)
    got = pk.series_offsets(port[0], port[6], n_series)
    keys = np.arange(n_series + 1, dtype=np.int64) * int(ref[6])
    want = np.append(np.asarray(jnp.searchsorted(ref[0], keys, side="left")),
                     ref[0].shape[0])
    close(got.numpy(), want, exact=True)
    assert got.dtype == torch.int32 and got.shape == (n_series + 2,)
    assert pk.series_offsets.launches == 0


def test_series_offsets_saturate_past_int64():
    """t * kp past I64_MAX saturates: the first invalid row, as a search
    for any key above the valid ones finds it."""
    key_s = torch.tensor([0, 5, 9, pk.I64_MAX, pk.I64_MAX])
    kp = torch.tensor(pk.I64_MAX // 3, dtype=torch.int64)
    got = pk.series_offsets(key_s, kp, 5)
    assert got.tolist() == [0, 3, 3, 3, 3, 3, 5]


def test_with_series_offsets_appends_the_table():
    t = _table(dict(seed=11))
    _ref, port = both_layouts(t)
    lay = pk.with_series_offsets(port, t["series"])
    assert len(lay) == 8 and all(a is b for a, b in zip(lay[:7], port))
    assert torch.equal(lay[7], pk.series_offsets_plain(port[0], port[6],
                                                       t["series"]))


# ---------------------------------------------------------------------------
# the bounds
# ---------------------------------------------------------------------------

def _bisect(key_s, a, e, x, right: bool) -> torch.Tensor:
    """Per element, the row of ``x`` in ``key_s[a:e]`` (left: the first
    key >= x; right: the first key > x), bisected as the kernel's
    ``search_left`` / ``search_right`` do."""
    lo, hi = a.clone(), e.clone()
    last = max(key_s.shape[0] - 1, 0)
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) >> 1
        k = key_s[mid.clamp(max=last)]
        up = live & ((k <= x) if right else (k < x))
        lo = torch.where(up, mid + 1, lo)
        hi = torch.where(live & ~up, mid, hi)
    return lo


def range_bounds(key_s, ts_min, kp, sel, start, step, steps, rng, off):
    """The range geometry's ``[lo, hi)`` as ``window_bounds`` computes
    them: tsid t = sel (a pad reads 0) clamped to the table's last
    series, the two searches over ``key_s[off[t], off[t + 1])``."""
    t = torch.where(sel >= 0, sel.to(torch.int64), 0)
    grid = start + step * torch.arange(steps, dtype=torch.int64)
    rel_lo = torch.clamp(grid - rng + 1 - ts_min, min=0, max=int(kp) - 1)
    rel_hi = torch.clamp(grid - ts_min, min=-1, max=int(kp) - 1)
    x_lo = ((t * kp)[:, None] + rel_lo[None, :]).reshape(-1)
    x_hi = ((t * kp)[:, None] + rel_hi[None, :]).reshape(-1)
    r = torch.clamp(t, max=off.shape[0] - 2)
    off = off.to(torch.int64)
    a = off[r][:, None].expand(-1, steps).reshape(-1)
    e = off[r + 1][:, None].expand(-1, steps).reshape(-1)
    lo = _bisect(key_s, a, e, x_lo, right=False)
    hi = _bisect(key_s, a, e, x_hi, right=True)
    return lo.reshape(-1, steps), hi.reshape(-1, steps)


@pytest.mark.parametrize("case", TABLES)
@pytest.mark.parametrize("geo", GEOMETRY + [(600_000, 15_000, 6, 465_000)])
def test_range_bounds_equal_searchsorted_and_reference(case, geo):
    off, step, steps, rng = geo
    t = _table(case)
    ref, port = both_layouts(t)
    sel = _sel(t["series"])
    args = (port[0], port[5], port[6], sel, T0 + off, step, steps, rng)
    want = pk.window_bounds_plain(*args)
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps, range_ms=rng,
                                num_sel=sel.shape[0], total_series=64,
                                kind="counter")
    ref_b = ref_engine._sorted_window_bounds(
        p, ref[0], ref[5], ref[6], jnp.asarray(sel.numpy()),
        np.int64(T0 + off))
    for w, r in zip(want, ref_b):
        close(w.numpy(), np.asarray(r), exact=True)
    # the table's series count below, at and past the data: the same
    for n_series in (0, t["series"] // 2, t["series"], 3 * t["series"]):
        off_t = pk.series_offsets(port[0], port[6], n_series)
        lo, hi = range_bounds(*args, off_t)
        assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    assert not want[3][len(_pick(t["series"])):].any()  # pads: no window


# ---------------------------------------------------------------------------
# counter_window without gdrop
# ---------------------------------------------------------------------------

def _ref_window(kind, ref_layout, sel, start, step, steps, rng):
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps, range_ms=rng,
                                num_sel=len(sel), total_series=64, kind=kind)
    return ref_engine._window_body(p)(*ref_layout, jnp.asarray(sel),
                                      np.int64(start))


EXACT = ("count", "first_ts", "last_ts", "first_val", "last_val", "last",
         "delta_raw")


@pytest.mark.parametrize("kind", ["counter", "instant"])
@pytest.mark.parametrize("case", [dict(seed=31, reset_frac=0.2),
                                  dict(seed=32, dup=9, nan_frac=0.2),
                                  dict(seed=33, reset_frac=0.5)])
@pytest.mark.parametrize("geometry", ["range", "search"])
def test_counter_window_matches_reference(kind, case, geometry):
    t = _table(case)
    ref, port = both_layouts(t)
    lay = pk.with_series_offsets(port, t["series"])
    sel = _sel(t["series"]).numpy()
    for off, step, steps, rng in GEOMETRY:
        want = _ref_window(kind, ref, sel, T0 + off, step, steps, rng)
        got = pk.counter_window(lay, torch.from_numpy(sel), T0 + off,
                                step_ms=step, num_steps=steps, range_ms=rng,
                                kind=kind, geometry=geometry)
        assert set(got) == set(pk.KIND_KEYS[kind])
        for k in pk.KIND_KEYS[kind]:
            close(got[k].numpy(), np.asarray(want[k]), exact=k in EXACT)


@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
@pytest.mark.parametrize("seed", [41, 42])
def test_counter_window_rate_matches_reference(func, seed):
    t = _table(dict(seed=seed, reset_frac=0.15))
    ref, port = both_layouts(t)
    lay = pk.with_series_offsets(port, t["series"])
    sel = _sel(t["series"]).numpy()
    for off, step, steps, rng in GEOMETRY:
        stats = _ref_window("counter", ref, sel, T0 + off, step, steps, rng)
        range_end = T0 + off + step * np.arange(steps, dtype=np.float64)
        want = ref_engine._extrapolated(stats, rng / 1000, range_end,
                                        counter=func != "delta",
                                        is_rate=func == "rate")
        got = pk.counter_window(lay, torch.from_numpy(sel), T0 + off,
                                step_ms=step, num_steps=steps, range_ms=rng,
                                kind="rate", func=func, range_s=rng / 1000)
        close(got.numpy(), np.asarray(want))


def test_window_drop_sum_is_the_prefix_difference():
    """The kernel's drop sum over a window's rows, in f64, is the
    reference's ``gdrop[li] - gdrop[fi]`` up to rounding: here, with
    integer-valued counters, exactly."""
    t = _table(dict(seed=51, reset_frac=0.3))
    t["val"] = np.floor(t["val"])
    _ref, port = both_layouts(t)
    val_s = port[2].double()
    gdrop = pk.prefix_scan_plain(port[2], port[3], port[4])
    lo, hi, cnt, _has, _ok = pk.window_bounds_plain(
        port[0], port[5], port[6], _sel(t["series"]), T0 + 300_000, 15_000,
        20, 300_000)
    for fi, li in zip(lo[cnt >= 2].tolist(), (hi - 1)[cnt >= 2].tolist()):
        v = val_s[fi:li + 1]
        dsum = float(torch.where(v[:-1] > v[1:], v[:-1], 0.0).sum())
        assert dsum == float(gdrop[li] - gdrop[fi])


def test_wrappers_validate_geometry():
    t = _table(dict(seed=61))
    _ref, port = both_layouts(t)
    sel = torch.zeros(2, dtype=torch.int32)
    kw = dict(step_ms=1, num_steps=1, range_ms=1)
    with pytest.raises(ValueError, match="geometry"):
        pk.window_stats(port, sel, T0, kind="irate", geometry="ranges", **kw)
    bounds = (torch.zeros(2, dtype=torch.int64),
              torch.zeros(2, dtype=torch.int32),
              torch.zeros((2, 1), dtype=torch.int64))
    with pytest.raises(ValueError, match="count geometry"):
        pk.counter_window(port, sel, T0, kind="instant", bounds=bounds,
                          geometry="search", **kw)
    with pytest.raises(ValueError, match="entries"):
        pk.window_count_max((*port, torch.zeros(1, dtype=torch.int32)), sel,
                            T0, **kw)


@pytest.mark.parametrize("kind", ["gauge_window", "counter_rc", "regression",
                                  "irate", "minmax", "count_max", "quantile"])
def test_other_window_kernels_equal_in_both_geometries(kind):
    """On the CPU every window wrapper takes either geometry on a layout
    with its table and gives its plain version's outputs, the same for
    both (the card's kernels: ``test_torch_promql_ranges_cuda.py``)."""
    t = _table(dict(seed=71, dup=11, nan_frac=0.1))
    _ref, port = both_layouts(t)
    lay = pk.with_series_offsets(port, t["series"])
    sel = _sel(t["series"])
    for off, step, steps, rng in GEOMETRY:
        kw = dict(step_ms=step, num_steps=steps, range_ms=rng)

        def run(geometry):
            if kind == "minmax":
                return pk.minmax_window(lay, sel, T0 + off,
                                        geometry=geometry, **kw)
            if kind == "count_max":
                return {"cm": torch.tensor(pk.window_count_max(
                    lay, sel, T0 + off, geometry=geometry, **kw))}
            if kind == "quantile":
                return {"q": pk.window_matrix(
                    lay, sel, T0 + off, lmax=64, kind="quantile", a1=0.9,
                    geometry=geometry, **kw)}
            return pk.window_stats(lay, sel, T0 + off, kind=kind,
                                   geometry=geometry, **kw)

        got, want = run("range"), run("search")
        for k in want:
            assert torch.equal(got[k].nan_to_num(-7.0),
                               want[k].nan_to_num(-7.0)), (kind, k)


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

@pytest.fixture
def db():
    port = GreptimeDB(device="cpu")
    port.sql(DDL)
    write_counters(port)
    yield port
    port.close()


def test_evaluator_holds_the_table_in_the_layout_entry(db, monkeypatch):
    """The sort layout's cache entry carries its offset table (8 arrays,
    their bytes counted), and no query of the path calls prefix_scan."""

    def no_scan(*_a, **_k):
        raise AssertionError("prefix_scan on the PromQL path")

    monkeypatch.setattr(pk, "prefix_scan", no_scan)
    end = T0 + 450_000
    for expr in (f"sum by (pod) (rate({M}[5m]))", f"rate({M}[5m])",
                 f"increase({M}[2m])", f"sum(delta({M}[1m]))", M):
        ev = PromEvaluator(db, (T0 + 300_000) / 1000, end / 1000, 15)
        res = ev.eval(parse_promql(expr))
        assert res.values.shape[1] == ev.num_steps
    cache = db.promql_cache
    entries = [e for k, e in cache._lru.items() if k[1] == "sort"]
    assert len(entries) == 1
    lay = entries[0].arrays
    assert len(lay) == 8
    table = db.cache.get(db._table_view(M))
    assert lay[7].shape == (table.num_series + 2,)
    assert entries[0].nbytes == sum(a.numel() * a.element_size()
                                    for a in lay)
    assert torch.equal(lay[7], pk.series_offsets_plain(lay[0], lay[6],
                                                       table.num_series))
