"""Port parity: the plain versions of the PromQL kernels against the JAX
reference's programs.

- K8: ``_build_sort_layout`` (``greptimedb_tpu/promql/engine.py:257``) vs
  ``sort_layout`` — exact, with NaN values, padding rows, I64_MAX ties and
  duplicate (tsid, ts) keys (the sort must be stable);
- K9: ``_sorted_window_bounds`` (``:288``) vs ``window_bounds_plain`` —
  exact, with windows before and after the data and padding selections;
- K10: ``_window_body`` (``:383``) kinds ``counter``/``instant`` vs
  ``counter_window`` with counter resets and empty windows;
- ``_extrapolated`` (``:1839``) vs ``extrapolated``, including the float64
  promotion hazard of epoch milliseconds;
- K11: ``compile/fused.py`` ``_build_fused`` vs the port's fused chain
  (``counter_window`` + ``group_reduce``) across {rate, increase, delta,
  instant} x {sum, avg, count, group, min, max}.

Inputs are made from a seed with numpy and handed to both packages.  On
the CPU the wrappers take the plain versions, so the launch counters stay
at 0.  Tolerances: integers, bounds, counts, timestamps, min and max
exact; float sums and rates ``|a-b| <= 1e-5*max(1,|b|)`` (the golden
comparer's bound, tests/test_golden.py) — the scan and the group sums add
in another order than XLA.  The last tests run the CUDA kernels against
the plain versions and need the card; ``prefix_scan`` must also repeat
bit for bit over two calls (its look-back folds f64 tile sums in one
fixed order) from 1 to 41,943,040 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.compile.fused import _build_fused
from greptimedb_tpu.promql import engine as ref_engine
from greptimedb_tpu_torch.ops import grid_kernels as gk
from greptimedb_tpu_torch.ops import promql_kernels as pk
from greptimedb_tpu_torch.promql.engine import group_reduce

REL = 1e-5
I64_MAX = np.iinfo(np.int64).max
T0 = 1_700_000_000_000
SCRAPE = 15_000


def close(got, want, exact=False, rel=None):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    g = got.astype(np.float64)
    w = want.astype(np.float64)
    nan = np.isnan(w)
    assert (np.isnan(g) == nan).all()
    inf = np.isinf(w)
    assert (g[inf] == w[inf]).all()
    ok = ~nan & ~inf
    rel = REL if rel is None else rel
    assert (np.abs(g[ok] - w[ok]) <= rel * np.maximum(1.0, np.abs(w[ok]))
            ).all(), np.abs(g[ok] - w[ok]).max()


def make_table(seed, series=40, scrapes=30, pad=64, nan_frac=0.03,
               reset_frac=0.05, dup=0, shuffle=True):
    """A resident table as the port's DeviceTable lays it out: counters
    scraped every 15 s with jitter, resets and NaN samples, ``pad`` padding
    rows (mask False, tsid 0, ts 0, NaN) and ``dup`` duplicated (tsid, ts)
    rows; rows shuffled so the sort has work to do."""
    rng = np.random.default_rng(seed)
    tsid = np.repeat(np.arange(series, dtype=np.int32), scrapes)
    k = np.tile(np.arange(scrapes), series)
    ts = T0 + k * SCRAPE + rng.integers(-500, 500, tsid.size)
    val = np.cumsum(rng.uniform(100, 200, (series, scrapes)), axis=1)
    reset = rng.random((series, scrapes)) < reset_frac
    for s, j in zip(*np.nonzero(reset)):
        val[s, j:] -= val[s, j] - rng.uniform(0, 10)
    val = val.reshape(-1).astype(np.float32)
    val[rng.random(val.size) < nan_frac] = np.nan
    if dup:
        pick = rng.choice(tsid.size, dup, replace=False)
        tsid = np.concatenate([tsid, tsid[pick]])
        ts = np.concatenate([ts, ts[pick]])
        val = np.concatenate([val, val[pick] + 1])
    mask = np.ones(tsid.size, bool)
    if shuffle:
        perm = rng.permutation(tsid.size)
        tsid, ts, val = tsid[perm], ts[perm], val[perm]
    tsid = np.concatenate([tsid, np.zeros(pad, np.int32)])
    ts = np.concatenate([ts, np.zeros(pad, np.int64)]).astype(np.int64)
    val = np.concatenate([val, np.full(pad, np.nan, np.float32)])
    mask = np.concatenate([mask, np.zeros(pad, bool)])
    return dict(ts=ts, val=val, tsid=tsid, mask=mask, series=series)


def both_layouts(t):
    ref = ref_engine._build_sort_layout(
        jnp.asarray(t["ts"]), jnp.asarray(t["val"]), jnp.asarray(t["tsid"]),
        jnp.asarray(t["mask"]))
    port = pk.sort_layout(*(torch.from_numpy(t[k])
                            for k in ("ts", "val", "tsid", "mask")))
    return ref, port


def selection(series, pick, pad_to):
    sel = np.full(pad_to, -1, np.int32)
    sel[:len(pick)] = pick
    return sel


# ---------------------------------------------------------------------------
# K8: the sort layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(seed=1), dict(seed=2, dup=25), dict(seed=3, nan_frac=0.5),
    dict(seed=4, pad=0), dict(seed=5, shuffle=False, dup=7),
    dict(seed=6, nan_frac=1.0),  # no valid row at all
])
def test_sort_layout_matches_reference_exactly(case):
    pk.reset_launch_counts()
    ref, port = both_layouts(make_table(**case))
    names = ("key_s", "ts_s", "val_s", "tsid_s", "valid_s", "ts_min", "kp")
    for name, r, p in zip(names, ref, port):
        close(p.numpy(), np.asarray(r), exact=True)
    assert pk.sort_layout.launches == 0 and pk.prefix_scan.launches == 0


def test_sort_layout_keeps_tied_rows_in_row_order():
    """Invalid rows tie at I64_MAX and duplicated (tsid, ts) rows tie at
    one key: a stable sort keeps both groups in row order."""
    t = make_table(9, series=5, scrapes=4, pad=6, dup=4, nan_frac=0.3)
    key_s, ts_s, val_s, tsid_s, valid_s, _tmin, _kp = pk.sort_layout(
        *(torch.from_numpy(t[k]) for k in ("ts", "val", "tsid", "mask")))
    n_valid = int(valid_s.sum())
    assert (key_s[n_valid:] == I64_MAX).all()
    invalid_rows = np.flatnonzero(~(t["mask"] & ~np.isnan(t["val"])))
    # the trailing run is the invalid rows in their original order
    np.testing.assert_array_equal(ts_s[n_valid:].numpy(),
                                  t["ts"][invalid_rows])
    assert (torch.diff(key_s[:n_valid]) >= 0).all()


# ---------------------------------------------------------------------------
# prefix_scan
# ---------------------------------------------------------------------------

def test_counter_drop_scan_matches_reference_program():
    """``gdrop`` of engine.py:405-410, traced through JAX on the same
    sorted layout."""
    ref, _port = both_layouts(make_table(11, reset_frac=0.2))
    _key, _ts, val_s, tsid_s, valid_s, _tmin, _kp = ref
    prev_same = jnp.concatenate([jnp.array([False]), (
        tsid_s[1:] == tsid_s[:-1]) & valid_s[1:] & valid_s[:-1]])
    prev_val = jnp.concatenate([val_s[:1] * 0, val_s[:-1]])
    drop = jnp.where(prev_same & (prev_val > val_s), prev_val, 0.0)
    want = jnp.cumsum(drop.astype(jnp.float64))
    got = pk.prefix_scan(*(torch.from_numpy(np.array(a))
                                 for a in (val_s, tsid_s, valid_s)))
    assert got.dtype == torch.float64
    close(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K9 geometry and K10 window statistics
# ---------------------------------------------------------------------------

# (start offset from T0 ms, step ms, steps, range ms): windows inside the
# data, before it (rel_hi clips to -1) and after it
GEOMETRY = [
    (300_000, 15_000, 20, 300_000),
    (-600_000, 60_000, 8, 120_000),
    (0, 30_000, 30, 60_000),
    (400_000, 1_000, 1, 300_000),
    (900_000, 90_000, 6, 30_000),
]


def _ref_window(kind, ref_layout, sel, start, step, steps, rng):
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps, range_ms=rng,
                                num_sel=len(sel), total_series=64, kind=kind)
    return p, ref_engine._window_body(p)(
        *ref_layout, jnp.asarray(sel), np.int64(start))


@pytest.mark.parametrize("geo", GEOMETRY)
def test_window_bounds_match_reference_exactly(geo):
    off, step, steps, rng = geo
    t = make_table(21)
    ref, port = both_layouts(t)
    sel = selection(t["series"], [3, 0, 17, 39, 5], 8)  # 3 padding slots
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps, range_ms=rng,
                                num_sel=8, total_series=64, kind="counter")
    lo, hi, cnt, has, sel_ok, _n = ref_engine._sorted_window_bounds(
        p, ref[0], ref[5], ref[6], jnp.asarray(sel), np.int64(T0 + off))
    plo, phi, pcnt, phas, psel = pk.window_bounds_plain(
        port[0], port[5], port[6], torch.from_numpy(sel), T0 + off, step,
        steps, rng)
    for got, want in ((plo, lo), (phi, hi), (pcnt, cnt), (phas, has),
                      (psel, sel_ok)):
        close(got.numpy(), np.asarray(want), exact=True)
    assert not phas[5:].any()  # padding selections never have a window


@pytest.mark.parametrize("kind", ["counter", "instant"])
@pytest.mark.parametrize("geo", GEOMETRY)
def test_window_stats_match_reference(kind, geo):
    off, step, steps, rng = geo
    t = make_table(31, reset_frac=0.1)
    ref, port = both_layouts(t)
    sel = selection(t["series"], [0, 1, 2, 30, 12, 7], 8)
    _p, want = _ref_window(kind, ref, sel, T0 + off, step, steps, rng)
    gdrop = pk.prefix_scan(port[2], port[3], port[4]) \
        if kind == "counter" else None
    got = pk.counter_window(port, gdrop, torch.from_numpy(sel), T0 + off,
                            step_ms=step, num_steps=steps, range_ms=rng,
                            kind=kind)
    assert set(got) == set(pk.KIND_KEYS[kind]) == set(
        ref_engine.PromEvaluator._KIND_KEYS[kind])
    for k in pk.KIND_KEYS[kind]:
        exact = k in ("count", "first_ts", "last_ts", "first_val",
                      "last_val", "last", "delta_raw")
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype
        close(got[k].numpy(), np.asarray(want[k]), exact=exact)


# ---------------------------------------------------------------------------
# _extrapolated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
def test_extrapolated_matches_reference(func):
    t = make_table(41, reset_frac=0.1)
    ref, port = both_layouts(t)
    sel = selection(t["series"], np.arange(40), 64)
    off, step, steps, rng = 300_000, 15_000, 20, 300_000
    _p, stats = _ref_window("counter", ref, sel, T0 + off, step, steps, rng)
    range_end = T0 + off + step * np.arange(steps, dtype=np.float64)
    want = ref_engine._extrapolated(stats, rng / 1000, range_end,
                                    counter=func != "delta",
                                    is_rate=func == "rate")
    port_stats = {k: torch.from_numpy(np.array(v)) for k, v in
                  stats.items()}
    got = pk.extrapolated(port_stats, rng / 1000, range_end,
                          counter=func != "delta", is_rate=func == "rate")
    close(got.numpy(), np.asarray(want))
    # the fused route hands range_end over as int64 epoch milliseconds
    got_i64 = pk.extrapolated(
        port_stats, rng / 1000,
        torch.from_numpy(range_end.astype(np.int64)),
        counter=func != "delta", is_rate=func == "rate")
    np.testing.assert_array_equal(got_i64.numpy(), got.numpy())


def test_extrapolated_float64_promotion_hazard():
    """torch computes int64 - float in float32, JAX (x64) in float64: on
    epoch milliseconds the float32 result is off by up to ~1e5 ms.  The
    port casts every timestamp to float64 first, so a window whose first
    sample sits 7 ms after its start extrapolates as the reference does."""
    end = torch.tensor([T0 + 300_007], dtype=torch.int64)
    assert (end - 300_000.0).dtype == torch.float32
    assert float(end - 300_000.0) != T0 + 7
    stats = {
        "first_ts": torch.tensor([[T0 + 14]]),
        "last_ts": torch.tensor([[T0 + 285_014]]),
        "count": torch.tensor([[20.0]]),
        "first_val": torch.tensor([[100.0]]),
        "delta_adj": torch.tensor([[2850.0]]),
        "delta_raw": torch.tensor([[2850.0]]),
    }
    ref_stats = {k: jnp.asarray(v.numpy()) for k, v in stats.items()}
    want = ref_engine._extrapolated(ref_stats, 300.0, np.asarray(
        [T0 + 300_007], np.float64), counter=True, is_rate=True)
    got = pk.extrapolated(stats, 300.0, end, counter=True, is_rate=True)
    close(got.numpy(), np.asarray(want))
    assert float(got[0, 0]) == pytest.approx(float(want[0, 0]), rel=1e-7)


# ---------------------------------------------------------------------------
# K11: the fused chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "avg", "count", "group", "min", "max"])
@pytest.mark.parametrize("func", ["rate", "increase", "delta", None])
def test_fused_chain_matches_reference(func, op):
    t = make_table(51, series=60, reset_frac=0.08)
    ref, port = both_layouts(t)
    n_sel = 50
    rng_np = np.random.default_rng(5)
    pick = np.sort(rng_np.choice(60, n_sel, replace=False)).astype(np.int32)
    sel = selection(60, pick, 64)
    ng = 7
    gid = rng_np.integers(0, ng, n_sel).astype(np.int32)
    gid[:ng] = np.arange(ng)  # every group has a member
    off, step, steps = 300_000, 30_000, 12
    rng_ms = 300_000 if func is not None else 300_000  # lookback = range
    kind = "counter" if func is not None else "instant"
    range_s = rng_ms / 1000 if func is not None else None
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps,
                                range_ms=rng_ms, num_sel=64,
                                total_series=64, kind=kind)
    fused = jax.jit(_build_fused(p, func, op, ng, n_sel, range_s))
    want = fused(*ref, jnp.asarray(sel), np.int64(T0 + off),
                 jnp.asarray(gid))
    gid_t = torch.from_numpy(gid)
    order = np.argsort(gid, kind="stable")
    offsets = np.append(np.searchsorted(gid[order], np.arange(ng)), n_sel)
    layout = gk.GroupLayout(
        torch.cat([gid_t, torch.full((64 - n_sel,), ng, dtype=torch.int32)]),
        torch.from_numpy(order.astype(np.int32)),
        torch.from_numpy(offsets.astype(np.int64)), ng)
    sel_t = torch.from_numpy(sel)
    if func is None:
        v = pk.counter_window(port, None, sel_t, T0 + off, step_ms=step,
                              num_steps=steps, range_ms=rng_ms,
                              kind="instant")["last"]
    else:
        gdrop = pk.prefix_scan(port[2], port[3], port[4])
        v = pk.counter_window(port, gdrop, sel_t, T0 + off, step_ms=step,
                              num_steps=steps, range_ms=rng_ms, kind="rate",
                              func=func, range_s=range_s)
    got = group_reduce(v, layout, op)
    close(got.numpy(), np.asarray(want),
          exact=op in ("count", "group", "min", "max"))


def test_wrappers_validate_inputs():
    t = make_table(61)
    args = [torch.from_numpy(t[k]) for k in ("ts", "val", "tsid", "mask")]
    with pytest.raises(ValueError):
        pk.sort_layout(args[0].to(torch.int32), *args[1:])
    layout = pk.sort_layout(*args)
    val_s, tsid_s, valid_s = layout[2:5]
    with pytest.raises(ValueError, match="prefix_scan"):
        pk.prefix_scan(val_s.double(), tsid_s, valid_s)
    with pytest.raises(ValueError, match="prefix_scan"):
        pk.prefix_scan(val_s, tsid_s[1:], valid_s)
    with pytest.raises(ValueError, match="kind"):
        pk.counter_window(layout, None, torch.zeros(2, dtype=torch.int32),
                          T0, step_ms=1, num_steps=1, range_ms=1,
                          kind="irate")
    with pytest.raises(ValueError, match="rate mode"):
        pk.counter_window(layout, None, torch.zeros(2, dtype=torch.int32),
                          T0, step_ms=1, num_steps=1, range_ms=1,
                          kind="rate", func="irate", range_s=1.0)


# ---------------------------------------------------------------------------
# the CUDA kernels (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    pk.reset_launch_counts()
    for case in (dict(seed=1), dict(seed=2, dup=25, series=300, scrapes=40),
                 dict(seed=6, nan_frac=1.0), dict(seed=7, pad=5000)):
        t = make_table(**case)
        args = [torch.from_numpy(t[k]) for k in ("ts", "val", "tsid",
                                                  "mask")]
        want = pk.sort_layout_plain(*args)
        got = pk.sort_layout(*(a.to(cuda_device) for a in args))
        for g, w in zip(got, want):
            close(g.cpu().numpy(), w.numpy(), exact=True)
        gd_want = pk.prefix_scan_plain(*want[2:5])
        gd = pk.prefix_scan(*got[2:5])
        # f64 sums in two tree orders: far inside 1e-9, and a missed or
        # repeated drop (>= 1 here) breaks it anywhere in the array
        close(gd.cpu().numpy(), gd_want.numpy(), rel=1e-9)
        sel = selection(0, np.arange(0, t["series"], 2), 256)
        sel_c = torch.from_numpy(sel).to(cuda_device)
        for off, step, steps, rng in GEOMETRY:
            for kind in ("instant", "counter"):
                w = pk.counter_window_plain(
                    want, gd_want, torch.from_numpy(sel), T0 + off,
                    step_ms=step, num_steps=steps, range_ms=rng, kind=kind)
                g = pk.counter_window(
                    got, gd if kind == "counter" else None, sel_c, T0 + off,
                    step_ms=step, num_steps=steps, range_ms=rng, kind=kind)
                for k in pk.KIND_KEYS[kind]:
                    close(g[k].cpu().numpy(), w[k].numpy(),
                          exact=k != "delta_adj")
            for func in ("rate", "increase", "delta"):
                kw = dict(step_ms=step, num_steps=steps, range_ms=rng,
                          kind="rate", func=func, range_s=rng / 1000)
                w = pk.counter_window_plain(want, gd_want,
                                            torch.from_numpy(sel), T0 + off,
                                            **kw)
                g = pk.counter_window(got, gd, sel_c, T0 + off, **kw)
                close(g.cpu().numpy(), w.numpy())
    torch.cuda.synchronize()
    # four prefix_scan calls (the general route's radix passes count under
    # sort_layout); the shuffled tables take the general route, the
    # all-NaN one (no valid row) the presorted partition
    assert pk.prefix_scan.launches == 4 and pk.sort_layout.launches == 4
    assert pk.sort_layout.general == 3 and pk.sort_layout.presorted == 1
    assert pk.counter_window.launches == 4 * len(GEOMETRY) * 5


def _drop_layout(n, seed):
    """A sorted layout of n rows: series of 1 to 400 samples, counters
    with frequent resets of large values (so the f64 running sum grows to
    ~1e9 and rounds differently in other summation orders), invalid
    rows."""
    rng = np.random.default_rng(seed)
    tsid = np.cumsum(rng.random(n) < 1 / 200).astype(np.int32)
    val = rng.uniform(0, 1e4, n).astype(np.float32)
    valid = rng.random(n) < 0.95
    return [torch.from_numpy(a) for a in (val, tsid, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4095, 4096, 4097, 3_000_017,
                               41_943_040])
def test_cuda_prefix_scan_repeats_bit_for_bit(cuda_device, n):
    """The single-pass scan's f64 prefixes are one left fold of the tile
    sums whichever tiles a look-back reads: two calls agree bit for bit,
    and both within 1e-9 of the plain version's sequential cumsum."""
    args = _drop_layout(n, n % 1000)
    want = pk.prefix_scan_plain(*args)
    dev = [a.to(cuda_device) for a in args]
    first = pk.prefix_scan(*dev)
    second = pk.prefix_scan(*dev)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int64), second.view(torch.int64))
    close(first.cpu().numpy(), want.numpy(), rel=1e-9)
