"""The range geometry on the card: ``series_offsets`` against
``torch.searchsorted`` exactly, and each of the five window kernels
(``counter_window``, ``window_stats``, ``minmax_window``,
``window_count_max``, ``window_matrix``) in the range geometry bit for bit
against the forced whole-layout search (``geometry="search"``), with the
wrappers' geometry counters asserted; ``counter_window`` also against its
plain version (every output exact but ``delta_adj`` and the rates, which
sum the window's drops in another f64 order: ``1e-5*max(1,|b|)``).

Every test here needs a CUDA card and skips without one; the file imports
no JAX (the CPU parity with the reference is
``tests/test_torch_promql_ranges.py``).
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.ops import promql_kernels as pk

T0 = 1_700_000_000_000
# (start offset from T0 ms, step ms, steps, range ms): windows inside the
# data, before it, after it, one step, and ~31 samples (lmax 32)
GEOMETRY = [
    (300_000, 15_000, 20, 300_000),
    (-600_000, 60_000, 8, 120_000),
    (0, 30_000, 30, 60_000),
    (400_000, 1_000, 1, 300_000),
    (900_000, 90_000, 6, 30_000),
    (600_000, 15_000, 6, 465_000),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def counters(seed, series=60, scrapes=40, pad=64, nan_frac=0.03,
             reset_frac=0.1, dup=0, shuffle=True, empty=(5,)):
    """Counter columns (ts, val, tsid, mask) scraped every 15 s with
    jitter, resets, NaN samples, ``dup`` duplicated (tsid, ts) rows,
    ``pad`` padding rows and the series ``empty`` without a valid
    sample."""
    rng = np.random.default_rng(seed)
    tsid = np.repeat(np.arange(series, dtype=np.int32), scrapes)
    k = np.tile(np.arange(scrapes), series)
    ts = T0 + k * 15_000 + rng.integers(-500, 500, tsid.size)
    val = np.cumsum(rng.uniform(100, 200, (series, scrapes)), axis=1)
    reset = rng.random((series, scrapes)) < reset_frac
    for s, j in zip(*np.nonzero(reset)):
        val[s, j:] -= val[s, j] - rng.uniform(0, 10)
    val = val.reshape(-1).astype(np.float32)
    val[rng.random(val.size) < nan_frac] = np.nan
    val[np.isin(tsid, empty)] = np.nan
    if dup:
        pick = rng.choice(tsid.size, dup, replace=False)
        tsid = np.concatenate([tsid, tsid[pick]])
        ts = np.concatenate([ts, ts[pick]])
        val = np.concatenate([val, val[pick] + 1])
    if shuffle:
        perm = rng.permutation(tsid.size)
        tsid, ts, val = tsid[perm], ts[perm], val[perm]
    mask = np.concatenate([np.ones(tsid.size, bool), np.zeros(pad, bool)])
    tsid = np.concatenate([tsid, np.zeros(pad, np.int32)])
    ts = np.concatenate([ts, np.zeros(pad, np.int64)]).astype(np.int64)
    val = np.concatenate([val, np.full(pad, np.nan, np.float32)])
    return [torch.from_numpy(a) for a in (ts, val, tsid, mask)]


TABLES = [dict(seed=1), dict(seed=2, dup=25, series=300),
          dict(seed=3, nan_frac=1.0), dict(seed=4, pad=5000, shuffle=False),
          dict(seed=5, nan_frac=0.4, reset_frac=0.4)]


def selection(series, size):
    """Every tsid, a series without samples, tsids past the data, then
    -1 pads."""
    pick = np.concatenate([np.arange(series + 3)[::-1], [5, 0, 4 * series]])
    sel = np.full(size, -1, np.int32)
    sel[:len(pick)] = pick
    return torch.from_numpy(sel)


def same(a, b):
    """Equal bit for bit (f32 compared as int32: -0.0 apart, NaN payloads
    included)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def close(got, want, rel=1e-5):
    g, w = got.double(), want.double()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    ok = ~torch.isnan(w)
    assert ((g - w).abs()[ok] <= rel * w.abs()[ok].clamp(min=1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 4097, 10_485_760])
def test_cuda_series_offsets_equal_searchsorted(cuda_device, n):
    """Keys of series of 1-80 rows (some series empty), then the invalid
    rows' I64_MAX; the table for series counts below, at and past the
    data equals torch.searchsorted's."""
    pk.reset_launch_counts()
    rng = np.random.default_rng(n % 997)
    valid = n - n // 50
    tsid = np.sort(rng.integers(0, max(valid // 40, 1), valid))
    ts = rng.integers(0, 600_000, valid)
    kp = 600_002
    key = np.concatenate([np.sort(tsid * kp + ts),
                          np.full(n - valid, pk.I64_MAX)]).astype(np.int64)
    key_c = torch.from_numpy(key).to(cuda_device)
    kp_c = torch.tensor(kp, dtype=torch.int64, device=cuda_device)
    top = int(tsid.max()) + 1 if valid else 0
    calls = 0
    for n_series in sorted({0, top // 2, top, top + 7}):
        got = pk.series_offsets(key_c, kp_c, n_series)
        want = pk.series_offsets_plain(key_c, kp_c, n_series)
        assert torch.equal(got, want)
        assert int(got[-1]) == n
        calls += 1
    torch.cuda.synchronize()
    assert pk.series_offsets.launches == calls


@pytest.mark.cuda
@pytest.mark.parametrize("case", TABLES)
def test_cuda_window_kernels_range_equal_search(cuda_device, case):
    """The five window kernels in the range geometry, bit for bit against
    the forced whole-layout search on the same layout; counter_window also
    against its plain version (the reference's prefix-sum formula)."""
    pk.reset_launch_counts()
    series = case.get("series", 60)
    cols = counters(**case)
    want_l = pk.sort_layout_plain(*cols)
    got_l = pk.with_series_offsets(
        pk.sort_layout(*(c.to(cuda_device) for c in cols)), series)
    sel = selection(series, 512)
    sel_c = sel.to(cuda_device)
    launches = 0
    for off, step, steps, rng in GEOMETRY:
        geo = dict(step_ms=step, num_steps=steps, range_ms=rng)
        start = T0 + off
        for kind, func in (("instant", None), ("counter", None),
                           ("rate", "rate"), ("rate", "increase"),
                           ("rate", "delta")):
            kw = dict(kind=kind, func=func,
                      range_s=rng / 1000 if func else None, **geo)
            g = pk.counter_window(got_l, sel_c, start, **kw)
            s = pk.counter_window(got_l, sel_c, start, geometry="search",
                                  **kw)
            w = pk.counter_window_plain(want_l, sel, start, **kw)
            if kind == "rate":
                g, s, w = {"rate": g}, {"rate": s}, {"rate": w}
            for k in w:
                assert same(g[k], s[k]), (kind, func, k)
                if k in ("delta_adj", "rate"):
                    close(g[k].cpu(), w[k])
                else:
                    assert same(g[k].cpu(), w[k]), (kind, k)
        for kind in ("gauge_window", "counter_rc", "regression", "irate"):
            g = pk.window_stats(got_l, sel_c, start, kind=kind, **geo)
            s = pk.window_stats(got_l, sel_c, start, kind=kind,
                                geometry="search", **geo)
            for k in g:
                assert same(g[k], s[k]), (kind, k)
        g = pk.minmax_window(got_l, sel_c, start, **geo)
        s = pk.minmax_window(got_l, sel_c, start, geometry="search", **geo)
        assert all(same(g[k], s[k]) for k in g)
        cm = pk.window_count_max(got_l, sel_c, start, **geo)
        assert cm == pk.window_count_max(got_l, sel_c, start,
                                         geometry="search", **geo)
        assert cm == pk.window_count_max_plain(want_l, sel, start, **geo)
        lmax = max(2, 1 << (max(cm, 1) - 1).bit_length())
        for kind in ("quantile", "mad", "holt"):
            mkw = dict(lmax=lmax, kind=kind, a1=0.9 if kind != "holt" else
                       0.5, a2=0.3, **geo)
            g = pk.window_matrix(got_l, sel_c, start, **mkw)
            s = pk.window_matrix(got_l, sel_c, start, geometry="search",
                                 **mkw)
            assert same(g, s), kind
        launches += 1
    torch.cuda.synchronize()
    per = {pk.counter_window: 5, pk.window_stats: 4, pk.minmax_window: 1,
           pk.window_count_max: 1, pk.window_matrix: 3}
    for wrapper, n in per.items():
        assert wrapper.range == wrapper.search == n * launches, wrapper
        assert wrapper.launches == 2 * n * launches
    assert pk.series_offsets.launches == 1
    assert pk.prefix_scan.launches == 0


@pytest.mark.cuda
def test_cuda_range_geometry_needs_the_table(cuda_device):
    cols = [c.to(cuda_device) for c in counters(9)]
    lay = pk.sort_layout(*cols)
    sel = selection(60, 128).to(cuda_device)
    geo = dict(step_ms=15_000, num_steps=4, range_ms=300_000)
    with pytest.raises(ValueError, match="series offset table"):
        pk.window_stats(lay, sel, T0, kind="gauge_window", **geo)
    out = pk.window_stats(lay, sel, T0, kind="gauge_window",
                          geometry="search", **geo)
    assert out["count"].shape == (128, 4)
