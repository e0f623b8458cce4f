"""Port parity of K9's count geometry: the reference's second window
geometry (``greptimedb_tpu/promql/engine.py:313-328``), its state
``_series_ranges`` (``:348``) and ``_gather_ts_mat`` (``:360``), cached as
the ``bounds`` kind of the PromQL cache (``SelectorData.window_bounds``,
``:787-829``) and chosen by ``_prep_window`` (``:933-938``).

- The plain versions of ``series_ranges`` and ``gather_ts_mat`` equal the
  reference's programs exactly, over pad selections, a series with no
  valid sample, tsids past the data and widths ``L`` of 1 and 64.
- ``window_bounds_plain`` in the count geometry gives the searchsorted
  geometry's integer bounds on every kept (selected) row; on pad rows the
  two differ and both leave the window empty.
- Evaluator parity with the bounds route taken on BOTH sides (the
  ``bounds_miss`` then ``bounds_hit`` events of each evaluator) for every
  window kind the geometry serves: ``counter``, ``instant``,
  ``gauge_window``, ``counter_rc``, ``regression``, ``irate`` and
  ``minmax``.  Against the reference the golden bound holds
  (``|a-b| <= 1e-5*max(1,|b|)``, counts and timestamps exact); against
  the port's own searchsorted route (``GREPTIME_PROMQL_CACHE=off``) the
  values are identical.
- 64 steps take the route, 65 do not; a selection whose ``S·T·L`` passes
  the cap does not, and builds no state; a write invalidates the entry;
  a PromQL cache too small for the entry, or for the entry beside the
  sort layout it derives from, rejects it and answers the same.

Tests marked ``cuda`` hold the two kernels and the count-geometry mode of
``counter_window``, ``window_stats`` and ``minmax_window`` to their plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.promql import engine as ref_engine
from greptimedb_tpu.promql.engine import PromEvaluator as RefEvaluator
from greptimedb_tpu.promql.parser import parse_promql as ref_parse
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.ops import promql_kernels as pk
from greptimedb_tpu_torch.promql import engine as port_engine
from greptimedb_tpu_torch.promql.engine import PromEvaluator
from greptimedb_tpu_torch.promql.parser import parse_promql
from greptimedb_tpu_torch.standalone import GreptimeDB
from test_torch_promql import DDL, M, T0, rows_match, write_counters
from test_torch_promql_kernels import GEOMETRY, both_layouts, close
from test_torch_promql_kernels import make_table, selection

# every window kind the count geometry serves, one selector each
KIND_EXPRS = {
    "counter": f"rate({M}[5m])",
    "instant": M,
    "gauge_window": f"avg_over_time({M}[2m])",
    "counter_rc": f"resets({M}[5m])",
    "regression": f"deriv({M}[3m])",
    "irate": f"irate({M}[1m])",
    "minmax": f"max_over_time({M}[4m])",
}


def _table_with_gaps(seed):
    """make_table with series 5 holding no valid sample (all NaN)."""
    t = make_table(seed, series=40, scrapes=30)
    t["val"][(t["tsid"] == 5) & t["mask"]] = np.nan
    return t


def _ref_state(ref_layout, sel, L):
    start, cnt = ref_engine._series_ranges(ref_layout[0], ref_layout[6],
                                           jnp.asarray(sel))
    mat = ref_engine._gather_ts_mat(ref_layout[1], start, cnt, L)
    return np.asarray(start), np.asarray(cnt), np.asarray(mat)


# pad -1 slots, a series without samples (5), tsids past the data (40, 99)
PICKS = [[3, 0, 17, 39, 5], [5, 40, 99, 1], [0], list(range(40))]


@pytest.mark.parametrize("pick", PICKS)
@pytest.mark.parametrize("L", [1, 64])
def test_state_matches_reference_exactly(pick, L):
    t = _table_with_gaps(81)
    ref, port = both_layouts(t)
    sel = selection(40, pick, 64)
    want_start, want_cnt, want_mat = _ref_state(ref, sel, L)
    start, cnt, cnt_max = pk.series_ranges(port[0], port[6],
                                           torch.from_numpy(sel))
    assert start.dtype == torch.int64 and cnt.dtype == torch.int32
    close(start.numpy(), want_start.astype(np.int64), exact=True)
    close(cnt.numpy(), want_cnt, exact=True)
    assert cnt_max == int(want_cnt.max())
    mat = pk.gather_ts_mat(port[1], start, cnt, L)
    assert mat.dtype == torch.int64 and tuple(mat.shape) == (64, L)
    close(mat.numpy(), want_mat, exact=True)
    # the series without samples and the tsids past the data count 0
    for s, tsid in enumerate(pick):
        if tsid == 5 or tsid >= 40:
            assert cnt[s] == 0 and (mat[s] == pk.I64_MAX).all()
    assert (cnt[len(pick):] == 0).all()  # pad selections


def test_state_of_a_layout_without_valid_rows():
    t = make_table(82, series=8, nan_frac=1.0)
    ref, port = both_layouts(t)
    sel = selection(8, [0, 3, 7], 4)
    want_start, want_cnt, want_mat = _ref_state(ref, sel, 1)
    start, cnt, cnt_max = pk.series_ranges(port[0], port[6],
                                           torch.from_numpy(sel))
    close(start.numpy(), want_start.astype(np.int64), exact=True)
    close(cnt.numpy(), want_cnt, exact=True)
    assert cnt_max == 0
    close(pk.gather_ts_mat(port[1], start, cnt, 1).numpy(), want_mat,
          exact=True)


@pytest.mark.parametrize("geo", GEOMETRY)
def test_count_geometry_bounds_equal_searchsorted(geo):
    off, step, steps, rng = geo
    t = _table_with_gaps(83)
    _ref, port = both_layouts(t)
    pick = [3, 0, 17, 39, 5, 40]
    sel = torch.from_numpy(selection(40, pick, 8))
    start, cnt, lmax = pk.series_ranges(port[0], port[6], sel)
    L = 1 << (max(lmax, 1) - 1).bit_length()
    bounds = (start, cnt, pk.gather_ts_mat(port[1], start, cnt, L))
    args = (port[0], port[5], port[6], sel, T0 + off, step, steps, rng)
    lo, hi, c, has, sel_ok = pk.window_bounds_plain(*args)
    blo, bhi, bc, bhas, bsel_ok = pk.window_bounds_plain(*args,
                                                         bounds=bounds)
    keep = len(pick)
    for got, want in ((blo, lo), (bhi, hi), (bc, c), (bhas, has)):
        assert torch.equal(got[:keep], want[:keep])
    assert torch.equal(bsel_ok, sel_ok)
    # pad rows: other bounds, but no window on either side
    assert not has[keep:].any() and not bhas[keep:].any()
    # and the reference's count geometry gives the same bounds
    ref, _port = both_layouts(t)
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps, range_ms=rng,
                                num_sel=8, total_series=64, kind="counter",
                                bounds_l=L)
    rs, rc = ref_engine._series_ranges(ref[0], ref[6],
                                       jnp.asarray(sel.numpy()))
    rmat = ref_engine._gather_ts_mat(ref[1], rs, rc, L)
    rlo, rhi, rcnt, rhas, _ok, _n = ref_engine._sorted_window_bounds(
        p, ref[0], ref[5], ref[6], jnp.asarray(sel.numpy()),
        np.int64(T0 + off), (rs, rc, rmat))
    for got, want in ((blo, rlo), (bhi, rhi), (bc, rcnt), (bhas, rhas)):
        close(got.numpy(), np.asarray(want), exact=True)


@pytest.mark.parametrize("kind", ["instant", "counter", "rate",
                                  "gauge_window", "counter_rc",
                                  "regression", "irate", "minmax"])
def test_window_kernels_plain_equal_in_both_geometries(kind):
    """The window outputs from the count geometry are the searchsorted
    geometry's, bit for bit (the same rows, the same arithmetic)."""
    t = _table_with_gaps(84)
    _ref, port = both_layouts(t)
    pick = [0, 5, 9, 39, 22, 40]
    sel = torch.from_numpy(selection(40, pick, 8))
    start, cnt, lmax = pk.series_ranges(port[0], port[6], sel)
    L = 1 << (max(lmax, 1) - 1).bit_length()
    bounds = (start, cnt, pk.gather_ts_mat(port[1], start, cnt, L))
    for off, step, steps, rng in GEOMETRY:
        geo = dict(step_ms=step, num_steps=steps, range_ms=rng)

        def run(b):
            if kind in ("instant", "counter"):
                return pk.counter_window(port, sel, T0 + off,
                                         kind=kind, bounds=b, **geo)
            if kind == "rate":
                return {"rate": pk.counter_window(
                    port, sel, T0 + off, kind="rate", func="rate",
                    range_s=rng / 1000, bounds=b, **geo)}
            if kind == "minmax":
                return pk.minmax_window(port, sel, T0 + off, bounds=b,
                                        **geo)
            return pk.window_stats(port, sel, T0 + off, kind=kind,
                                   bounds=b, **geo)

        want, got = run(None), run(bounds)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k][:len(pick)].nan_to_num(-7.0),
                               want[k][:len(pick)].nan_to_num(-7.0)), k


# ---------------------------------------------------------------------------
# the evaluator: the bounds route on both sides
# ---------------------------------------------------------------------------

def _dbs(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # the reference on one device, as tests/test_torch_promql.py keeps it
    monkeypatch.setenv("GREPTIME_MESH", "off")
    ref = RefDB()
    monkeypatch.delenv("GREPTIME_MESH")
    port = GreptimeDB(device="cpu")
    for db in (ref, port):
        db.sql(DDL)
        write_counters(db)
    return ref, port


@pytest.fixture
def dbs(monkeypatch):
    ref, port = _dbs(monkeypatch)
    yield ref, port
    ref.close()
    port.close()


def _eval_both(ref, port, expr, start, end, step):
    rev = RefEvaluator(ref, start / 1000, end / 1000, step)
    rres = rev.eval(ref_parse(expr))
    pev = PromEvaluator(port, start / 1000, end / 1000, step)
    pres = pev.eval(parse_promql(expr))
    return rev, rres, pev, pres


def _events(ev):
    return {k: v for k, v in ev.cache_events.items()
            if k.startswith("bounds")}


def _values_match(pres, rres, exact=False):
    assert list(pres.labels) == list(rres.labels)
    close(pres.values.numpy(), np.asarray(rres.values), exact=exact)


@pytest.mark.parametrize("kind", sorted(KIND_EXPRS))
def test_evaluator_bounds_route_matches_reference(kind, dbs, monkeypatch):
    ref, port = dbs
    expr = KIND_EXPRS[kind]
    start, end, step = T0 + 300_000, T0 + 450_000, 15
    exact = kind in ("instant", "counter_rc", "minmax")
    for want_event in ("bounds_miss", "bounds_hit"):
        rev, rres, pev, pres = _eval_both(ref, port, expr, start, end,
                                          step)
        assert _events(rev) == {want_event: 1}, rev.cache_events
        assert _events(pev) == {want_event: 1}, pev.cache_events
        _values_match(pres, rres, exact=exact)
    # the port's searchsorted route gives the same values, bit for bit
    monkeypatch.setenv("GREPTIME_PROMQL_CACHE", "off")
    pev = PromEvaluator(port, start / 1000, end / 1000, step)
    plain = pev.eval(parse_promql(expr))
    assert not _events(pev)
    assert torch.equal(plain.values.nan_to_num(-7.0),
                       pres.values.nan_to_num(-7.0))


@pytest.mark.parametrize("steps,route", [(64, True), (65, False)])
def test_num_steps_limit(steps, route, dbs):
    ref, port = dbs
    start = T0 + 60_000
    end = start + (steps - 1) * 5_000
    expr = f"rate({M}[1m])"
    rev, rres, pev, pres = _eval_both(ref, port, expr, start, end, 5)
    assert pres.values.shape[1] == steps
    assert bool(_events(rev)) is route and bool(_events(pev)) is route
    _values_match(pres, rres)


def test_selection_over_the_compare_cap_is_refused(dbs, monkeypatch):
    """S·T·L above the cap takes the searchsorted geometry and builds no
    state; the width is kept, so a repeat runs no search; under the cap
    the state is built and serves the same values."""
    ref, port = dbs
    seen, searched = [], []
    window, ranges = PromEvaluator._window, pk.series_ranges

    def spy(self, *a, bounds=None, **kw):
        seen.append(bounds is not None)
        return window(self, *a, bounds=bounds, **kw)

    def ranges_spy(*a):
        searched.append(1)
        return ranges(*a)

    monkeypatch.setattr(PromEvaluator, "_window", spy)
    monkeypatch.setattr(pk, "series_ranges", ranges_spy)
    expr = f"irate({M}[1m])"
    start, end = T0 + 300_000, T0 + 450_000
    # S = 128 selected, T = 11 steps, L = 64: 90,112 compares
    monkeypatch.setattr(port_engine, "BOUNDS_COMPARE_CAP", 90_111)
    results = []
    for _ in range(2):
        _rev, rres, pev, pres = _eval_both(ref, port, expr, start, end, 15)
        assert _events(pev) == {"bounds_miss": 1, "bounds_refused": 1}
        _values_match(pres, rres)
        results.append(pres)
    assert seen == [False, False] and searched == [1]
    assert port.promql_cache.stats()["bounds_misses"] == 2
    assert not any(k[1] == "bounds" for k in port.promql_cache._lru)
    monkeypatch.setattr(port_engine, "BOUNDS_COMPARE_CAP", 90_112)
    for want in ("bounds_miss", "bounds_hit"):
        _rev, rres, pev, pres = _eval_both(ref, port, expr, start, end, 15)
        assert _events(pev) == {want: 1}
        _values_match(pres, rres)
        results.append(pres)
    assert seen == [False, False, True, True] and searched == [1, 1]
    # a resident state is refused past the cap too
    monkeypatch.setattr(port_engine, "BOUNDS_COMPARE_CAP", 90_111)
    _rev, rres, pev, pres = _eval_both(ref, port, expr, start, end, 15)
    assert _events(pev) == {"bounds_refused": 1} and seen[-1] is False
    for other in results[1:] + [pres]:
        assert torch.equal(other.values.nan_to_num(-7.0),
                           results[0].values.nan_to_num(-7.0))


def test_state_never_evicts_its_sort_layout(dbs):
    """A budget that holds the sort layout but not the state beside it
    rejects the state (same answer, the searchsorted geometry) and keeps
    serving the sort layout from the cache."""
    ref, port = dbs
    expr = f"rate({M}[5m])"
    t = T0 + 585_000
    cache = port.promql_cache
    _rev, rres, pev, first = _eval_both(ref, port, expr, t, t, 1)
    assert _events(pev) == {"bounds_miss": 1}
    size = {k[1]: e.nbytes for k, e in cache._lru.items()}
    rid = port._table_view(M).region_id
    cache.invalidate_region(rid)
    cache.capacity = size["sort"] + size["bounds"] - 1
    for sort_event in ("sort_miss", "sort_hit"):
        pev = PromEvaluator(port, t / 1000, t / 1000, 1)
        res = pev.eval(parse_promql(expr))
        assert _events(pev) == {"bounds_miss": 1, "bounds_reject": 1}
        assert pev.cache_events[sort_event] == 1
        assert any(k[1] == "sort" for k in cache._lru)
        assert torch.equal(res.values.nan_to_num(-7.0),
                           first.values.nan_to_num(-7.0))
    _values_match(res, rres)


def test_fused_and_matrix_routes_keep_searchsorted(dbs):
    ref, port = dbs
    start, end = T0 + 300_000, T0 + 585_000
    for expr in (f"sum by (pod) (rate({M}[5m]))",
                 f"quantile_over_time(0.5, {M}[2m])"):
        rev, rres, pev, pres = _eval_both(ref, port, expr, start, end, 15)
        assert not _events(rev) and not _events(pev), expr
        rows_match_values(pres, rres)


def rows_match_values(pres, rres):
    assert len(pres.labels) == len(rres.labels)
    close(pres.values.numpy(), np.asarray(rres.values))


def test_write_invalidates_the_state(dbs):
    ref, port = dbs
    expr = f"changes({M}[5m])"
    t = T0 + 585_000
    for want in ("bounds_miss", "bounds_hit"):
        rev, rres, pev, pres = _eval_both(ref, port, expr, t, t, 1)
        assert _events(pev) == {want: 1} and _events(rev) == {want: 1}
    for db in (ref, port):
        write_counters(db, seed=9, scrapes=5, first=40)
    t = T0 + 44 * 15_000
    rev, rres, pev, pres = _eval_both(ref, port, expr, t, t, 1)
    assert _events(pev) == {"bounds_miss": 1}
    assert _events(rev) == {"bounds_miss": 1}
    _values_match(pres, rres, exact=True)
    assert np.nansum(pres.values.numpy()) > 0


def test_small_cache_rejects_the_state(monkeypatch):
    ref, port = _dbs(monkeypatch, GREPTIME_PROMQL_CACHE_BYTES="4096")
    try:
        expr = f"rate({M}[5m])"
        t = T0 + 585_000
        for _ in range(2):
            rev, rres, pev, pres = _eval_both(ref, port, expr, t, t, 1)
            assert _events(pev) == {"bounds_miss": 1, "bounds_reject": 1}
            assert _events(rev) == {"bounds_miss": 1, "bounds_reject": 1}
            _values_match(pres, rres)
        tql = f"TQL EVAL ({t / 1000}, {t / 1000}, 1) {expr}"
        rows_match(port.sql(tql), ref.sql(tql))
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_count_geometry_matches_plain(cuda_device):
    pk.reset_launch_counts()
    for case in (dict(seed=91), dict(seed=92, series=300, scrapes=64,
                                     dup=40), dict(seed=93, nan_frac=1.0)):
        t = make_table(**case)
        args = [torch.from_numpy(t[k]) for k in ("ts", "val", "tsid",
                                                  "mask")]
        want_l = pk.sort_layout_plain(*args)
        got_l = pk.with_series_offsets(
            pk.sort_layout(*(a.to(cuda_device) for a in args)), t["series"])
        n_sel = t["series"] + 3
        sel = selection(0, np.arange(-1, n_sel - 1)[::-1], 512)
        sel_c = torch.from_numpy(sel).to(cuda_device)
        ws, wc, wmax = pk.series_ranges_plain(want_l[0], want_l[6],
                                              torch.from_numpy(sel))
        gs, gc, gmax = pk.series_ranges(got_l[0], got_l[6], sel_c)
        assert gmax == wmax
        assert torch.equal(gs.cpu(), ws) and torch.equal(gc.cpu(), wc)
        L = 1 << (max(wmax, 1) - 1).bit_length()
        for width in (1, L):
            wm = pk.gather_ts_mat_plain(want_l[1], ws, wc, width)
            gm = pk.gather_ts_mat(got_l[1], gs, gc, width)
            assert torch.equal(gm.cpu(), wm)
        wb = (ws, wc, pk.gather_ts_mat_plain(want_l[1], ws, wc, L))
        gb = (gs, gc, pk.gather_ts_mat(got_l[1], gs, gc, L))
        for off, step, steps, rng in GEOMETRY:
            geo = dict(step_ms=step, num_steps=steps, range_ms=rng)
            for kind in ("instant", "counter"):
                w = pk.counter_window_plain(want_l, torch.from_numpy(sel),
                                            T0 + off, kind=kind, bounds=wb,
                                            **geo)
                g = pk.counter_window(got_l, sel_c, T0 + off, kind=kind,
                                      bounds=gb, **geo)
                for k in pk.KIND_KEYS[kind]:
                    close(g[k].cpu().numpy(), w[k].numpy(),
                          exact=k != "delta_adj")
            kw = dict(kind="rate", func="rate", range_s=rng / 1000, **geo)
            w = pk.counter_window_plain(want_l, torch.from_numpy(sel),
                                        T0 + off, bounds=wb, **kw)
            g = pk.counter_window(got_l, sel_c, T0 + off, bounds=gb, **kw)
            close(g.cpu().numpy(), w.numpy())
            for kind in ("gauge_window", "counter_rc", "regression",
                         "irate"):
                w = pk.window_stats_plain(kind, want_l,
                                          torch.from_numpy(sel), T0 + off,
                                          bounds=wb, **geo)
                g = pk.window_stats(got_l, sel_c, T0 + off, kind=kind,
                                    bounds=gb, **geo)
                for k in pk.KIND_KEYS[kind]:
                    exact = k in ("count", "first_ts", "last_ts", "last",
                                  "first", "resets", "changes", "prev_ts",
                                  "last_val", "prev_val")
                    if k == "var":
                        continue  # direct sums vs prefix sums: see below
                    close(g[k].cpu().numpy(), w[k].numpy(), exact=exact)
            w = pk.minmax_window_plain(want_l, torch.from_numpy(sel),
                                       T0 + off, bounds=wb, **geo)
            g = pk.minmax_window(got_l, sel_c, T0 + off, bounds=gb, **geo)
            for k in ("min", "max"):
                close(g[k].cpu().numpy(), w[k].numpy(), exact=True)
            # the kernels' two geometries agree bit for bit
            g_s = pk.window_stats(got_l, sel_c, T0 + off,
                                  kind="gauge_window", **geo)
            g_b = pk.window_stats(got_l, sel_c, T0 + off,
                                  kind="gauge_window", bounds=gb, **geo)
            for k in g_s:
                assert torch.equal(g_s[k][:n_sel].nan_to_num(-7.0),
                                   g_b[k][:n_sel].nan_to_num(-7.0)), k
    torch.cuda.synchronize()
    assert pk.series_ranges.launches == 3
    assert pk.gather_ts_mat.launches == 3 * 3
