"""Port parity: the plain versions of the PromQL window kernels of the
fourth slice against the JAX reference's programs.

- K10's other kinds (``greptimedb_tpu/promql/engine.py:455-499``):
  ``gauge_window``, ``counter_rc``, ``regression``, ``irate`` vs
  ``window_stats``, with offsets (another ``start``), windows of one and
  two samples (the regression's ``denom`` cancels) and near-constant
  values (the variance cancels);
- K13 (``:500-535``) vs ``minmax_window``;
- K14 (``:541``, ``:555``) vs ``window_count_max`` and ``window_matrix``
  (quantile with φ < 0, 0, 1, > 1 per step; mad; Holt with valid and
  invalid factors);
- the subquery reducers (``:1415-1437``) vs ``window_matrix_dense`` and
  the subquery counter functions (``:1309-1363``) vs
  ``subquery_counter``;
- windows wider than the kernels' shared-memory buffers (16,384 samples)
  through ``window_matrix`` and ``window_matrix_dense``;
- K12's sorts (``:1601-1651``) vs ``segment_select``, with NaN members,
  ±inf, ties, groups of one and ``ng == 1``;
- K11 (``compile/fused.py:_build_fused``) vs the port's fused chain for
  every window kind.

Inputs come from a numpy seed.  Tolerances: counts, timestamps, min/max,
order statistics and integers exact; float sums, variances, slopes,
quantile interpolations and Holt values ``|a-b| <= 1e-5*max(1,|b|)`` (the
golden comparer's bound).  The reference's CPU backend contracts some of
its floating-point steps into fused multiply-adds (the variance
``q - mean * mean``, Holt's updates) and sums prefixes in blocks of 16;
the plain versions repeat both, so where the terms cancel the two still
agree.  The ``cuda`` tests run each kernel against its plain version and
need the card: there the kernels sum each window directly instead of
differencing table-wide prefix sums, which the tests hold to the same
bound on tables of a few thousand rows.  K14's sorts run at every width
of ``matrix_route``'s register route and on the warp route, each held
bit for bit against the forced warp route (``allow_register=False``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.compile.fused import _FUNC_KIND as REF_FUNC_KIND
from greptimedb_tpu.compile.fused import _build_fused
from greptimedb_tpu.promql import engine as ref_engine
from greptimedb_tpu_torch.ops import grid_kernels as gk
from greptimedb_tpu_torch.ops import promql_kernels as pk
from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.promql.engine import (
    group_reduce, instant_pair, window_function,
)
from test_torch_promql_kernels import (
    GEOMETRY, T0, both_layouts, close, make_table, selection,
)

# windows of one and two samples (15 s scrapes): the regression's
# denominator and the variance cancel there
FEW = [(300_000, 15_000, 12, 15_000), (120_000, 30_000, 10, 30_000)]
STATS_EXACT = ("count", "first_ts", "last_ts", "last", "first", "resets",
               "changes", "prev_ts", "last_val", "prev_val", "min", "max")


def _ref_window(kind, ref_layout, sel, start, step, steps, rng):
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps, range_ms=rng,
                                num_sel=len(sel), total_series=64, kind=kind)
    return ref_engine._window_body(p)(
        *ref_layout, jnp.asarray(sel), np.int64(start))


def near_constant_table(seed, series=12, scrapes=30):
    """Gauges that sit near 1e4 and move by ~1e-3: the variance of a
    window is ~1e-7 against squares of ~1e8."""
    t = make_table(seed, series=series, scrapes=scrapes, reset_frac=0.0,
                   nan_frac=0.05)
    rng = np.random.default_rng(seed)
    live = t["mask"]
    t["val"][live] = (10_000.0 + rng.normal(0, 1e-3, live.sum())).astype(
        np.float32)
    t["val"][live & (rng.random(live.size) < 0.05)] = np.nan
    return t


@pytest.mark.parametrize("kind", ["gauge_window", "counter_rc",
                                  "regression", "irate", "minmax"])
@pytest.mark.parametrize("geo", GEOMETRY + FEW)
def test_window_kinds_match_reference(kind, geo):
    off, step, steps, rng = geo
    t = make_table(71, reset_frac=0.1)
    ref, port = both_layouts(t)
    sel = selection(t["series"], [0, 3, 2, 30, 12, 7, 39], 8)
    want = _ref_window(kind, ref, sel, T0 + off, step, steps, rng)
    sel_t = torch.from_numpy(sel)
    geo_kw = dict(step_ms=step, num_steps=steps, range_ms=rng)
    if kind == "minmax":
        got = pk.minmax_window(port, sel_t, T0 + off, **geo_kw)
    else:
        got = pk.window_stats(port, sel_t, T0 + off, kind=kind, **geo_kw)
    assert set(got) == set(pk.KIND_KEYS[kind]) == set(
        ref_engine.PromEvaluator._KIND_KEYS[kind])
    for k in pk.KIND_KEYS[kind]:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        close(got[k].numpy(), np.asarray(want[k]), exact=k in STATS_EXACT)
    assert pk.window_stats.launches == 0 and pk.minmax_window.launches == 0


@pytest.mark.parametrize("geo", GEOMETRY + FEW)
def test_variance_of_near_constant_windows_matches_reference(geo):
    """Trouble spot: ``mean`` from the f32-rounded sum, ``var`` from the
    f64 square sums minus ``mean**2`` — near-constant values cancel."""
    off, step, steps, rng = geo
    t = near_constant_table(72)
    ref, port = both_layouts(t)
    sel = selection(t["series"], np.arange(12), 16)
    want = _ref_window("gauge_window", ref, sel, T0 + off, step, steps, rng)
    got = pk.window_stats(port, torch.from_numpy(sel), T0 + off,
                          step_ms=step, num_steps=steps, range_ms=rng,
                          kind="gauge_window")
    for k in ("var", "sum", "avg"):
        close(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("off", [0, 7_000, 60_000, -45_000])
def test_regression_with_offsets_and_few_samples(off):
    """The regression's time axis starts at the grid start minus the
    offset; 2-sample windows make ``cn*st2 - st*st`` cancel."""
    t = make_table(73, series=20, scrapes=40, reset_frac=0.2)
    ref, port = both_layouts(t)
    sel = selection(20, np.arange(20), 32)
    for rng in (30_000, 45_000, 300_000):
        start = T0 + 300_000 - off
        want = _ref_window("regression", ref, sel, start, 15_000, 20, rng)
        got = pk.window_stats(port, torch.from_numpy(sel), start,
                              step_ms=15_000, num_steps=20, range_ms=rng,
                              kind="regression")
        for k in pk.KIND_KEYS["regression"]:
            close(got[k].numpy(), np.asarray(want[k]),
                  exact=k in STATS_EXACT)


def _matrix_params(kind, steps):
    if kind == "quantile":
        q = np.array([-0.5, 0.0, 0.3, 0.5, 0.9, 1.0, 1.5] * 8,
                     np.float32)[:steps]
        return q, np.ones(steps, np.float32)
    if kind == "holt":
        sf = np.array([0.5, 0.9, 0.1, 1.0, 0.0, 0.3] * 8, np.float32)[:steps]
        tf = np.array([0.3, 0.1, 0.7, 0.5, 0.5, 1.2] * 8, np.float32)[:steps]
        return sf, tf
    return np.ones(steps, np.float32), np.ones(steps, np.float32)


@pytest.mark.parametrize("kind", ["quantile", "mad", "holt"])
@pytest.mark.parametrize("geo", GEOMETRY + FEW)
def test_window_matrix_matches_reference(kind, geo):
    off, step, steps, rng = geo
    t = make_table(74, reset_frac=0.1)
    ref, port = both_layouts(t)
    sel = selection(t["series"], [5, 0, 17, 39, 2, 11], 8)
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps, range_ms=rng,
                                num_sel=8, total_series=64, kind=kind)
    args = (*ref, jnp.asarray(sel), np.int64(T0 + off))
    cnt_max = int(ref_engine._count_max_kernel(p)(*args))
    sel_t = torch.from_numpy(sel)
    geo_kw = dict(step_ms=step, num_steps=steps, range_ms=rng)
    assert pk.window_count_max(port, sel_t, T0 + off, **geo_kw) == cnt_max
    lmax = max(2, 1 << (max(cnt_max, 1) - 1).bit_length())
    a1, a2 = _matrix_params(kind, steps)
    want = ref_engine._matrix_kernel(p, lmax, kind)(
        *args, jnp.asarray(a1), jnp.asarray(a2))
    got = pk.window_matrix(port, sel_t, T0 + off, lmax=lmax, kind=kind,
                           a1=torch.from_numpy(a1), a2=torch.from_numpy(a2),
                           **geo_kw)
    close(got.numpy(), np.asarray(want))
    assert pk.window_matrix.launches == 0


def _ref_subquery_reducer(win, m, kind, q):
    """engine.py:1415-1437: quantile/mad over a subquery window matrix, on
    jnp arrays."""
    K = win.shape[2]
    cnt = m.sum(axis=-1)
    srt = jnp.sort(jnp.where(m, win, jnp.inf), axis=-1)

    def q_of(sorted_w, qq):
        rank = qq * jnp.maximum(cnt - 1, 0).astype(jnp.float32)
        lo_r = jnp.clip(jnp.floor(rank).astype(jnp.int32), 0, K - 1)
        hi_r = jnp.clip(jnp.ceil(rank).astype(jnp.int32), 0, K - 1)
        vlo = jnp.take_along_axis(sorted_w, lo_r[..., None], -1)[..., 0]
        vhi = jnp.take_along_axis(sorted_w, hi_r[..., None], -1)[..., 0]
        return vlo + (vhi - vlo) * (rank - lo_r.astype(jnp.float32))

    if kind == "quantile":
        qv = jnp.broadcast_to(jnp.asarray(q)[None, :], cnt.shape)
        out = q_of(srt, qv)
        out = jnp.where(qv < 0, -jnp.inf, jnp.where(qv > 1, jnp.inf, out))
    else:
        med = q_of(srt, jnp.float32(0.5))
        dev = jnp.sort(jnp.where(m, jnp.abs(win - med[..., None]), jnp.inf),
                       axis=-1)
        out = q_of(dev, jnp.float32(0.5))
    return jnp.where(cnt > 0, out, jnp.nan)


def _subquery_window_matrix(K, S=24, T=7, seed=None):
    """A counter-like [S, T, K] window matrix with resets and its mask
    (row 0 holds no samples)."""
    rng = np.random.default_rng(K if seed is None else seed)
    win = np.cumsum(rng.uniform(0, 50, (S, T, K)), -1).astype(np.float32)
    win[rng.random((S, T, K)) < 0.1] = rng.uniform(0, 5)  # resets
    m = rng.random((S, T, K)) > 0.25
    m[0] = False  # windows without samples
    return win, m


@pytest.mark.parametrize("kind", ["quantile", "mad"])
@pytest.mark.parametrize("K", [1, 3, 6, 21, 40])
def test_window_matrix_dense_matches_reference(kind, K):
    win, m = _subquery_window_matrix(K)
    q = np.array([0.5, -1.0, 0.0, 1.0, 1.5, 0.9, 0.25], np.float32)
    want = _ref_subquery_reducer(jnp.asarray(win), jnp.asarray(m), kind,
                                 q)
    got = pk.window_matrix_dense(
        torch.from_numpy(np.where(m, win, np.nan).astype(np.float32)), kind,
        torch.from_numpy(q))
    close(got.numpy(), np.asarray(want))
    assert pk.window_matrix_dense.launches == 0


def _subquery_times(K, T, sub_ms=15_000, step_ms=30_000):
    """Sample times ``ts_tk`` [T, K] and window ends ``steps`` [T] (ms) of
    a subquery grid whose last sample lands on each step."""
    steps = T0 + 600_000 + step_ms * np.arange(T, dtype=np.int64)
    ts_tk = steps[:, None] - sub_ms * np.arange(K - 1, -1, -1,
                                                dtype=np.int64)[None, :]
    return ts_tk, steps


def _ref_subquery_counter(win, m, ts_tk, steps, f, range_s):
    """engine.py:1320-1363 after the window matrix (gathers, the
    counter-drop fori_loop, ``_extrapolated`` / ``_instant_pair``), on jnp
    arrays."""
    K = win.shape[2]
    ks = jnp.arange(K)
    cnt = m.sum(axis=-1)
    first_k = jnp.where(m, ks, K).min(-1)
    last_k = jnp.where(m, ks, -1).max(-1)

    def at(x, k):
        return jnp.take_along_axis(x, jnp.clip(k, 0, K - 1)[..., None],
                                   -1)[..., 0]

    ts_b = jnp.broadcast_to(jnp.asarray(ts_tk)[None, :, :], win.shape)
    fv, lv, ft, lt = at(win, first_k), at(win, last_k), at(
        ts_b, first_k), at(ts_b, last_k)
    if f in ("irate", "idelta"):
        prev_k = jnp.where(m & (ks < last_k[..., None]), ks, -1).max(-1)
        return ref_engine._instant_pair(f, lt, at(ts_b, prev_k), lv,
                                        at(win, prev_k), guard=cnt >= 2)

    def body(k, carry):
        prev, has_prev, dropsum = carry
        v = jax.lax.dynamic_slice_in_dim(win, k, 1, axis=2)[..., 0]
        valid = jax.lax.dynamic_slice_in_dim(m, k, 1, axis=2)[..., 0]
        reset = valid & has_prev & (prev > v)
        dropsum = dropsum + jnp.where(reset, prev, 0.0)
        return (jnp.where(valid, v, prev), has_prev | valid, dropsum)

    zeros = jnp.zeros(win.shape[:2], win.dtype)
    drops = jax.lax.fori_loop(0, K, body, (
        zeros, jnp.zeros(win.shape[:2], bool), zeros))[2]
    out = {"first_ts": ft, "last_ts": lt, "first_val": fv,
           "count": cnt.astype(jnp.float32), "delta_adj": lv - fv + drops,
           "delta_raw": lv - fv}
    return ref_engine._extrapolated(out, range_s, steps.astype(np.float64),
                                    counter=f != "delta",
                                    is_rate=f == "rate")


def _port_subquery_counter(win, m, ts_tk, steps, f, range_s, dev="cpu"):
    args = (torch.from_numpy(np.where(m, win, np.nan).astype(
        np.float32)).to(dev), torch.from_numpy(ts_tk).to(dev),
        torch.from_numpy(steps).to(dev))
    if f in ("irate", "idelta"):
        out = pk.subquery_counter(*args, kind="pair")
        return instant_pair(f, out["last_ts"], out["prev_ts"],
                            out["last_val"], out["prev_val"],
                            guard=out["count"] >= 2)
    return pk.subquery_counter(*args, kind="rate", func=f, range_s=range_s)


@pytest.mark.parametrize("f", ["rate", "increase", "delta", "irate",
                               "idelta"])
@pytest.mark.parametrize("K", [1, 3, 6, 21, 40])
def test_subquery_counter_matches_reference(f, K):
    win, m = _subquery_window_matrix(K, seed=K + 100)
    ts_tk, steps = _subquery_times(K, win.shape[1])
    range_s = K * 15.0
    want = _ref_subquery_counter(jnp.asarray(win), jnp.asarray(m), ts_tk,
                                 steps, f, range_s)
    got = _port_subquery_counter(win, m, ts_tk, steps, f, range_s)
    close(got.numpy(), np.asarray(want))
    assert pk.subquery_counter.launches == 0


WIDE = 17_500  # samples in one window: past the 16,384-key shared buffer


@pytest.mark.parametrize("kind", ["quantile", "mad", "holt"])
def test_window_matrix_wider_than_shared_memory_matches_reference(kind):
    """A window of ~17,300 samples pads to lmax 32,768, past the kernels'
    shared-memory buffer: the wrapper takes it all the same."""
    t = make_table(77, series=3, scrapes=WIDE, pad=8, nan_frac=0.01)
    ref, port = both_layouts(t)
    sel = selection(3, [2, 0], 4)
    rng_ms, step = WIDE * 15_000, 20 * 15_000
    start = T0 + rng_ms - step
    p = ref_engine.WindowParams(step_ms=step, num_steps=2, range_ms=rng_ms,
                                num_sel=4, total_series=3, kind=kind)
    args = (*ref, jnp.asarray(sel), np.int64(start))
    cnt_max = int(ref_engine._count_max_kernel(p)(*args))
    sel_t = torch.from_numpy(sel)
    geo_kw = dict(step_ms=step, num_steps=2, range_ms=rng_ms)
    assert pk.window_count_max(port, sel_t, start, **geo_kw) == cnt_max
    lmax = 1 << (cnt_max - 1).bit_length()
    assert lmax > pk.SMEM_WIDTH
    a1 = np.array([0.9, 0.25] if kind == "quantile" else [0.5, 0.3],
                  np.float32)
    a2 = np.array([0.3, 0.6], np.float32)
    want = ref_engine._matrix_kernel(p, lmax, kind)(
        *args, jnp.asarray(a1), jnp.asarray(a2))
    got = pk.window_matrix(port, sel_t, start, lmax=lmax, kind=kind,
                           a1=torch.from_numpy(a1), a2=torch.from_numpy(a2),
                           **geo_kw)
    close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["quantile", "mad"])
def test_window_matrix_dense_wider_than_shared_memory_matches_reference(
        kind):
    win, m = _subquery_window_matrix(WIDE, S=3, T=2)
    q = np.array([0.9, 0.5], np.float32)
    want = _ref_subquery_reducer(jnp.asarray(win), jnp.asarray(m), kind, q)
    got = pk.window_matrix_dense(
        torch.from_numpy(np.where(m, win, np.nan).astype(np.float32)), kind,
        torch.from_numpy(q))
    close(got.numpy(), np.asarray(want))


def _ref_segment_sort(v, gid, row_order):
    """The reference's two-key lax.sort of (group id, value) per column
    (engine.py:1608-1611)."""
    gs = jnp.asarray(gid)[jnp.asarray(row_order)]
    gb = jnp.broadcast_to(gs[:, None], v.shape)
    _, sv = jax.lax.sort((gb, jnp.asarray(v)[jnp.asarray(row_order)]),
                         dimension=0, num_keys=2)
    return np.asarray(sv)


@pytest.mark.parametrize("ng", [1, 5, 40, 200])
def test_segment_select_matches_reference_sort(ng):
    rng = np.random.default_rng(ng)
    S, T = 400, 6
    v = rng.normal(0, 100, (S, T)).astype(np.float32)
    v[rng.random((S, T)) < 0.1] = np.nan
    v[rng.random((S, T)) < 0.05] = np.inf
    v[rng.random((S, T)) < 0.05] = -np.inf
    v[rng.random((S, T)) < 0.1] = 7.0  # ties
    gid = rng.integers(0, ng, S).astype(np.int32)
    gid[:ng] = np.arange(ng)
    order = np.argsort(gid, kind="stable").astype(np.int32)
    offsets = np.append(np.searchsorted(gid[order], np.arange(ng)),
                        S).astype(np.int64)
    sizes = np.diff(offsets)
    ranks = np.stack([rng.integers(0, sizes[:, None], (ng, T)),
                      np.broadcast_to(sizes[:, None] - 1, (ng, T))]
                     ).astype(np.int32)
    got = sk.segment_select(torch.from_numpy(v), torch.from_numpy(order),
                            torch.from_numpy(offsets), torch.from_numpy(
                                ranks)).numpy()
    sv = _ref_segment_sort(v, gid, order)
    want = np.take_along_axis(sv, (offsets[:-1][:, None] + ranks).reshape(
        -1, T), 0).reshape(2, ng, T)
    np.testing.assert_array_equal(got, want)
    assert sk.segment_select.launches == 0


def _ref_agg(op, v, gid, ng, param):
    """The reference's quantile/topk/bottomk branches of
    ``eval_aggregation`` (engine.py:1601-1651) on jnp arrays."""
    S = v.shape[0]
    order = np.argsort(gid, kind="stable")
    seg_start = np.searchsorted(gid[order], np.arange(ng))
    present = ~jnp.isnan(v)
    cnt = jax.ops.segment_sum(present.astype(jnp.int32), jnp.asarray(gid),
                              num_segments=ng)
    fcnt = cnt.astype(jnp.float32)
    gb = jnp.broadcast_to(jnp.asarray(gid)[order][:, None], v.shape)
    if op == "quantile":
        q = param
        _, sv = jax.lax.sort((gb, v[order]), dimension=0, num_keys=2)
        base = jnp.asarray(seg_start, dtype=jnp.int32)[:, None]
        rank = jnp.float32(q) * jnp.maximum(fcnt - 1, 0)
        lo_r = jnp.floor(rank).astype(jnp.int32)
        hi_r = jnp.ceil(rank).astype(jnp.int32)
        vlo = jnp.take_along_axis(sv, jnp.clip(base + lo_r, 0, S - 1), 0)
        vhi = jnp.take_along_axis(sv, jnp.clip(base + hi_r, 0, S - 1), 0)
        out = vlo + (vhi - vlo) * (rank - lo_r.astype(jnp.float32))
        if q < 0:
            out = jnp.full_like(out, -jnp.inf)
        elif q > 1:
            out = jnp.full_like(out, jnp.inf)
        return jnp.where(cnt > 0, out, jnp.nan)
    k = int(param)
    sign = 1.0 if op == "topk" else -1.0
    work = jnp.where(present, sign * v, -jnp.inf)
    _, sw = jax.lax.sort((gb, -work[order]), dimension=0, num_keys=2)
    sizes = np.diff(np.append(seg_start, S))
    kth_row = jnp.asarray(seg_start + np.minimum(k, sizes) - 1)
    kth = -jnp.take_along_axis(
        sw, jnp.broadcast_to(kth_row[:, None], (ng, v.shape[1])), 0)
    keep = work >= kth[jnp.asarray(gid)]
    return jnp.where(keep & present, v, jnp.nan)


@pytest.mark.parametrize("op,param", [
    ("quantile", 0.5), ("quantile", 0.0), ("quantile", 1.0),
    ("quantile", 0.99), ("quantile", -0.5), ("quantile", 1.5),
    ("topk", 1), ("topk", 3), ("topk", 1000), ("bottomk", 2),
    ("bottomk", 1),
])
@pytest.mark.parametrize("ng", [1, 6, 120])
def test_order_statistic_aggregations_match_reference(op, param, ng):
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import Aggregation, NumberLit

    rng = np.random.default_rng(ng + 7)
    S, T = 300, 5
    v = np.round(rng.normal(50, 20, (S, T)), 1).astype(np.float32)  # ties
    v[rng.random((S, T)) < 0.15] = np.nan
    v[:3, 1] = np.nan  # a column with absent members
    gid = rng.integers(0, ng, S).astype(np.int32)
    gid[:ng] = np.arange(ng)
    want = _ref_agg(op, jnp.asarray(v), gid, ng, param)
    order = np.argsort(gid, kind="stable")
    offsets = np.append(np.searchsorted(gid[order], np.arange(ng)), S)
    layout = gk.GroupLayout(torch.from_numpy(gid),
                            torch.from_numpy(order.astype(np.int32)),
                            torch.from_numpy(offsets.astype(np.int64)), ng)

    class _Db:
        device = torch.device("cpu")

    ev = PromEvaluator(_Db(), 0, 0, 1)
    agg = Aggregation(op=op, expr=None, param=NumberLit(param))
    got = ev._order_statistic(agg, torch.from_numpy(v), layout, [{}] * S,
                              [{}] * ng)
    close(got.values.numpy(), np.asarray(want), exact=op != "quantile")


@pytest.mark.parametrize("op", ["stddev", "stdvar"])
def test_stddev_stdvar_match_reference(op):
    rng = np.random.default_rng(9)
    S, T, ng = 200, 6, 9
    v = rng.normal(20, 3, (S, T)).astype(np.float32)
    v[rng.random((S, T)) < 0.1] = np.nan
    gid = rng.integers(0, ng, S).astype(np.int32)
    gid[:ng] = np.arange(ng)
    present = ~np.isnan(v)
    s = jax.ops.segment_sum(jnp.where(present, v, 0), gid, num_segments=ng)
    s2 = jax.ops.segment_sum(jnp.where(present, v * v, 0), gid,
                             num_segments=ng)
    cnt = jax.ops.segment_sum(present.astype(np.int32), gid,
                              num_segments=ng)
    fcnt = cnt.astype(jnp.float32)
    mean = s / jnp.maximum(fcnt, 1)
    var = jnp.maximum(s2 / jnp.maximum(fcnt, 1) - mean * mean, 0)
    want = jnp.where(cnt > 0, var if op == "stdvar" else jnp.sqrt(var),
                     jnp.nan)
    order = np.argsort(gid, kind="stable")
    offsets = np.append(np.searchsorted(gid[order], np.arange(ng)), S)
    layout = gk.GroupLayout(torch.from_numpy(gid),
                            torch.from_numpy(order.astype(np.int32)),
                            torch.from_numpy(offsets.astype(np.int64)), ng)
    got = group_reduce(torch.from_numpy(v), layout, op)
    close(got.numpy(), np.asarray(want))


FUSED_FUNCS = ["irate", "idelta", "resets", "changes", "avg_over_time",
               "sum_over_time", "count_over_time", "last_over_time",
               "first_over_time", "stddev_over_time", "stdvar_over_time",
               "present_over_time", "min_over_time", "max_over_time",
               "deriv"]


@pytest.mark.parametrize("op", ["sum", "avg", "count", "min", "max"])
@pytest.mark.parametrize("func", FUSED_FUNCS)
def test_fused_chain_of_every_kind_matches_reference(func, op):
    t = make_table(75, series=60, reset_frac=0.08)
    ref, port = both_layouts(t)
    n_sel = 50
    rng_np = np.random.default_rng(6)
    pick = np.sort(rng_np.choice(60, n_sel, replace=False)).astype(np.int32)
    sel = selection(60, pick, 64)
    ng = 7
    gid = rng_np.integers(0, ng, n_sel).astype(np.int32)
    gid[:ng] = np.arange(ng)
    off, step, steps, rng_ms = 300_000, 30_000, 12, 120_000
    kind = REF_FUNC_KIND[func]
    p = ref_engine.WindowParams(step_ms=step, num_steps=steps,
                                range_ms=rng_ms, num_sel=64,
                                total_series=64, kind=kind)
    fused = jax.jit(_build_fused(p, func, op, ng, n_sel, rng_ms / 1000))
    want = fused(*ref, jnp.asarray(sel), np.int64(T0 + off),
                 jnp.asarray(gid))
    order = np.argsort(gid, kind="stable")
    offsets = np.append(np.searchsorted(gid[order], np.arange(ng)), n_sel)
    layout = gk.GroupLayout(
        torch.cat([torch.from_numpy(gid),
                   torch.full((64 - n_sel,), ng, dtype=torch.int32)]),
        torch.from_numpy(order.astype(np.int32)),
        torch.from_numpy(offsets.astype(np.int64)), ng)
    geo_kw = dict(step_ms=step, num_steps=steps, range_ms=rng_ms)
    sel_t = torch.from_numpy(sel)
    if kind == "minmax":
        stats = pk.minmax_window(port, sel_t, T0 + off, **geo_kw)
    else:
        stats = pk.window_stats(port, sel_t, T0 + off, kind=kind, **geo_kw)
    got = group_reduce(window_function(func, stats), layout, op)
    close(got.numpy(), np.asarray(want),
          exact=op in ("count", "min", "max") and func not in (
              "irate", "deriv", "stddev_over_time", "stdvar_over_time",
              "avg_over_time", "sum_over_time"))


def test_wrappers_validate_inputs():
    t = make_table(76)
    layout = pk.sort_layout(*(torch.from_numpy(t[k])
                              for k in ("ts", "val", "tsid", "mask")))
    sel = torch.zeros(2, dtype=torch.int32)
    kw = dict(step_ms=1, num_steps=1, range_ms=1)
    with pytest.raises(ValueError, match="kind"):
        pk.window_stats(layout, sel, T0, kind="counter", **kw)
    with pytest.raises(ValueError, match="window_stats"):
        pk.window_stats(layout, sel.long(), T0, kind="irate", **kw)
    with pytest.raises(ValueError, match="lmax"):
        pk.window_matrix(layout, sel, T0, lmax=6, kind="mad", **kw)
    with pytest.raises(ValueError, match="kind"):
        pk.window_matrix(layout, sel, T0, lmax=8, kind="holtz", **kw)
    with pytest.raises(ValueError, match="window_matrix_dense"):
        pk.window_matrix_dense(torch.zeros((2, 3)), "mad")
    with pytest.raises(ValueError, match="kind"):
        pk.window_matrix_dense(torch.zeros((2, 3, 4)), "drops")
    win = torch.zeros((2, 3, 4))
    ts_tk, steps = (torch.from_numpy(a) for a in _subquery_times(4, 3))
    with pytest.raises(ValueError, match="ts_tk"):
        pk.subquery_counter(win, ts_tk[:, :2], steps, kind="pair")
    with pytest.raises(ValueError, match="func"):
        pk.subquery_counter(win, ts_tk, steps, kind="rate", func="irate",
                            range_s=60.0)
    with pytest.raises(ValueError, match="kind"):
        pk.subquery_counter(win, ts_tk, steps, kind="drops")
    v = torch.zeros((4, 2))
    order = torch.arange(4, dtype=torch.int32)
    offsets = torch.tensor([0, 4])
    with pytest.raises(ValueError, match="ranks"):
        sk.segment_select(v, order, offsets,
                          torch.zeros((1, 2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="row_order"):
        sk.segment_select(v, order.long(), offsets,
                          torch.zeros((1, 1, 2), dtype=torch.int32))


@pytest.mark.parametrize("width,route", [
    (2, "register"), (32, "register"), (33, "warp"), (64, "warp"),
    (pk.SMEM_WIDTH, "warp"), (pk.SMEM_WIDTH + 1, "scratch")])
def test_matrix_route(width, route):
    """A thread a window in registers up to REGISTER_WIDTH keys, a warp in
    shared memory up to SMEM_WIDTH, a warp on global scratch above."""
    assert pk.REGISTER_WIDTH == 32
    assert pk.matrix_route(width) == route


# ---------------------------------------------------------------------------
# the CUDA kernels (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_tables():
    return [make_table(1), make_table(2, dup=25, series=300, scrapes=40),
            make_table(6, nan_frac=1.0), near_constant_table(8)]


@pytest.mark.cuda
def test_cuda_window_stats_and_minmax_match_plain(cuda_device):
    pk.reset_launch_counts()
    calls = 0
    for t in _cuda_tables():
        args = [torch.from_numpy(t[k]) for k in ("ts", "val", "tsid",
                                                  "mask")]
        want_l = pk.sort_layout_plain(*args)
        got_l = pk.with_series_offsets(
            pk.sort_layout(*(a.to(cuda_device) for a in args)), t["series"])
        sel = selection(0, np.arange(0, t["series"], 2), 256)
        sel_c = torch.from_numpy(sel).to(cuda_device)
        for off, step, steps, rng in GEOMETRY + FEW:
            kw = dict(step_ms=step, num_steps=steps, range_ms=rng)
            gauge = pk.window_stats_plain("gauge_window", want_l,
                                          torch.from_numpy(sel), T0 + off,
                                          **kw)
            # windows of >= 2 samples that all share one timestamp
            # (duplicated rows): the regression's exact denominator is 0,
            # so the kernel's slope is NaN; the plain version's prefix
            # differences leave a rounding residue there instead
            flat = (gauge["count"] >= 2) & (
                gauge["first_ts"] == gauge["last_ts"])
            for kind in ("gauge_window", "counter_rc", "regression",
                         "irate"):
                w = pk.window_stats_plain(kind, want_l, torch.from_numpy(sel),
                                          T0 + off, **kw)
                g = pk.window_stats(got_l, sel_c, T0 + off, kind=kind, **kw)
                calls += 1
                if kind == "regression":
                    for k in ("slope", "intercept"):
                        assert torch.isnan(g[k].cpu()[flat]).all()
                        w[k] = torch.where(flat, float("nan"), w[k])
                for k in pk.KIND_KEYS[kind]:
                    if k == "var":
                        # the plain version's prefix-sum rounding on top of
                        # the golden bound (pk.var_slack)
                        cnt = pk.window_bounds_plain(
                            want_l[0], want_l[5], want_l[6],
                            torch.from_numpy(sel), T0 + off, step, steps,
                            rng)[2]
                        slack = pk.var_slack(want_l[2], want_l[4], cnt,
                                             w["sum"])
                        gv, wv = g[k].cpu().double(), w[k].double()
                        assert (torch.isnan(gv) == torch.isnan(wv)).all()
                        ok = ~torch.isnan(wv)
                        over = ((gv - wv).abs() - 1e-5 * wv.abs().clamp(
                            min=1) - slack)[ok]
                        assert (over <= 0).all(), (
                            float(over.max()), gv[ok][over.argmax()],
                            wv[ok][over.argmax()], slack[ok][over.argmax()])
                        continue
                    close(g[k].cpu().numpy(), w[k].numpy(),
                          exact=k in STATS_EXACT)
            w = pk.minmax_window_plain(want_l, torch.from_numpy(sel),
                                       T0 + off, **kw)
            g = pk.minmax_window(got_l, sel_c, T0 + off, **kw)
            for k in ("min", "max"):
                close(g[k].cpu().numpy(), w[k].numpy(), exact=True)
    torch.cuda.synchronize()
    assert pk.window_stats.launches == calls
    assert pk.minmax_window.launches == calls // 4


def _with_specials(t, seed):
    """-0.0 beside +0.0 and ±inf among a table's live samples."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(t["mask"] & ~np.isnan(t["val"]))
    for v in (0.0, -0.0, np.inf, -np.inf):
        if live.size:
            t["val"][rng.choice(live, max(1, live.size // 40),
                                replace=False)] = v
    return t


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (-0.0 apart from +0.0, NaN payloads included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# windows of about 1, 3, 7, 15 and 31 samples (15 s scrapes), so that each
# register width (lmax 2 to 32) meets windows that fill it
REGISTER_GEOMETRY = [(600_000, 15_000, 6, 15_000 * r)
                     for r in (1, 3, 7, 15, 31)]
MATRIX_WIDTHS = (2, 4, 8, 16, 32, 64)


@pytest.mark.cuda
def test_cuda_window_matrix_matches_plain(cuda_device):
    """Every register width (lmax 2-32) and the warp route (lmax 64)
    against the plain version, and each sort bit for bit against the
    forced warp route; NaN keys (written into the sorted values, which no
    layout holds) against the warp route alone."""
    pk.reset_launch_counts()
    widths, register, warp = set(), 0, 0
    q_steps = np.array([-0.5, 0.0, 0.3, 0.5, 0.9, 1.0, 1.5, np.nan] * 8,
                       np.float32)
    for t in _cuda_tables():
        t = _with_specials(t, 14)
        args = [torch.from_numpy(t[k]) for k in ("ts", "val", "tsid",
                                                  "mask")]
        want_l = pk.sort_layout_plain(*args)
        got_l = pk.with_series_offsets(
            pk.sort_layout(*(a.to(cuda_device) for a in args)), t["series"])
        nan_l = list(got_l)
        nan_l[2] = torch.where(torch.arange(got_l[2].shape[0],
                                            device=cuda_device) % 7 == 3,
                               float("nan"), got_l[2])
        sel = selection(0, np.arange(0, t["series"], 3), 128)
        sel_c = torch.from_numpy(sel).to(cuda_device)
        for off, step, steps, rng in GEOMETRY + FEW + [
                (600_000, 15_000, 4, 600_000)] + REGISTER_GEOMETRY:
            kw = dict(step_ms=step, num_steps=steps, range_ms=rng)
            cm = pk.window_count_max_plain(want_l, torch.from_numpy(sel),
                                           T0 + off, **kw)
            assert pk.window_count_max(got_l, sel_c, T0 + off, **kw) == cm
            for lmax in MATRIX_WIDTHS:
                if lmax < cm:
                    continue
                for kind in ("quantile", "mad", "holt"):
                    a1, a2 = (torch.from_numpy(a) for a in
                              _matrix_params(kind, steps))
                    if kind == "quantile":
                        a1 = torch.from_numpy(q_steps[:steps])
                    w = pk.window_matrix_plain(
                        want_l, torch.from_numpy(sel), T0 + off, lmax=lmax,
                        kind=kind, a1=a1, a2=a2, **kw)
                    mkw = dict(lmax=lmax, kind=kind, a1=a1.to(cuda_device),
                               a2=a2.to(cuda_device), **kw)
                    g = pk.window_matrix(got_l, sel_c, T0 + off, **mkw)
                    close(g.cpu().numpy(), w.numpy())
                    if kind == "holt":
                        continue
                    reg = pk.matrix_route(lmax) == "register"
                    if reg:
                        widths.add(lmax)
                    gw = pk.window_matrix(got_l, sel_c, T0 + off,
                                          allow_register=False, **mkw)
                    assert same_bits(g, gw), (lmax, kind, off)
                    gn = pk.window_matrix(nan_l, sel_c, T0 + off, **mkw)
                    gnw = pk.window_matrix(nan_l, sel_c, T0 + off,
                                           allow_register=False, **mkw)
                    assert same_bits(gn, gnw), (lmax, kind, off, "nan")
                    # g and gn by matrix_route, gw and gnw forced warp
                    register += 2 * reg
                    warp += 4 - 2 * reg
    assert widths == {2, 4, 8, 16, 32}
    assert pk.window_matrix.register == register
    assert pk.window_matrix.warp == warp
    rng = np.random.default_rng(3)
    for K in (1, 5, 21, 40, 300):
        win = np.cumsum(rng.uniform(0, 50, (33, 7, K)), -1).astype(
            np.float32)
        win[rng.random(win.shape) < 0.1] = 1.0
        win[rng.random(win.shape) < 0.3] = np.nan
        q = torch.from_numpy(np.array([0.5, -1, 0, 1, 1.5, 0.9, 0.25],
                                      np.float32))
        for kind in ("quantile", "mad"):
            w = pk.window_matrix_dense_plain(torch.from_numpy(win), kind, q)
            g = pk.window_matrix_dense(torch.from_numpy(win).to(cuda_device),
                                       kind, q.to(cuda_device))
            close(g.cpu().numpy(), w.numpy())
    torch.cuda.synchronize()
    assert pk.window_matrix.launches > 0 and pk.window_count_max.launches > 0
    assert pk.window_matrix_dense.launches == 10


@pytest.mark.cuda
def test_cuda_window_matrix_pad_windows_wider_than_lmax(cuda_device):
    """A pad selection (-1) reads tsid 0's windows, which lmax (sized
    from the selected series) need not hold: three times as dense here.
    Both routes stay inside their buffers and leave those windows NaN."""
    pk.reset_launch_counts()
    t = make_table(21, series=8, scrapes=30, pad=0, nan_frac=0.0,
                   shuffle=False)
    zero = t["tsid"] == 0
    extra = {k: np.concatenate([t[k][zero]] * 2) for k in
             ("ts", "val", "tsid", "mask")}
    extra["ts"] = extra["ts"] + np.repeat([5_000, 10_000], zero.sum())
    cols = [torch.from_numpy(np.concatenate([t[k], extra[k]]))
            for k in ("ts", "val", "tsid", "mask")]
    want_l = pk.sort_layout_plain(*cols)
    got_l = pk.with_series_offsets(
        pk.sort_layout(*(c.to(cuda_device) for c in cols)), 8)
    sel = torch.from_numpy(selection(8, [3, 5], 64))
    kw = dict(step_ms=15_000, num_steps=8, range_ms=300_000)
    cm = pk.window_count_max_plain(want_l, sel, T0 + 300_000, **kw)
    lmax = 1 << (cm - 1).bit_length()
    assert lmax == 32
    for kind in ("quantile", "mad"):
        q = torch.full((8,), 0.5)
        w = pk.window_matrix_plain(want_l, sel, T0 + 300_000, lmax=lmax,
                                   kind=kind, a1=q, **kw)
        assert torch.isnan(w[2:]).all()
        for allow in (True, False):
            g = pk.window_matrix(got_l, sel.to(cuda_device), T0 + 300_000,
                                 lmax=lmax, kind=kind,
                                 a1=q.to(cuda_device), allow_register=allow,
                                 **kw)
            close(g.cpu().numpy(), w.numpy(), exact=True)
    torch.cuda.synchronize()
    assert pk.window_matrix.register == 2 and pk.window_matrix.warp == 2


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 5, 6, 8, 9, 16, 17, 32, 33])
def test_cuda_window_matrix_dense_routes_match_plain(cuda_device, K):
    """Every register width of the dense matrix (K 1-32) and the warp
    route (K 33): NaN entries, rows without a sample, -0.0 beside +0.0,
    ±inf, φ below 0, above 1 and NaN; against the plain version and bit
    for bit against the forced warp route."""
    pk.reset_launch_counts()
    rng = np.random.default_rng(K)
    win = np.cumsum(rng.uniform(-50, 50, (33, 8, K)), -1).astype(np.float32)
    for frac, v in ((0.1, 1.0), (0.05, 0.0), (0.05, -0.0), (0.03, np.inf),
                    (0.03, -np.inf), (0.3, np.nan)):
        win[rng.random(win.shape) < frac] = v
    win[3] = np.nan
    q = torch.from_numpy(np.array([0.5, -1, 0, 1, 1.5, 0.9, np.nan, 0.25],
                                  np.float32))
    win_c = torch.from_numpy(win).to(cuda_device)
    for kind in ("quantile", "mad"):
        w = pk.window_matrix_dense_plain(torch.from_numpy(win), kind, q)
        g = pk.window_matrix_dense(win_c, kind, q.to(cuda_device))
        close(g.cpu().numpy(), w.numpy())
        gw = pk.window_matrix_dense(win_c, kind, q.to(cuda_device),
                                    allow_register=False)
        assert same_bits(g, gw), kind
    torch.cuda.synchronize()
    reg = pk.matrix_route(1 << max(K - 1, 1).bit_length()) == "register"
    assert reg == (K <= 32)
    assert pk.window_matrix_dense.register == 2 * reg
    assert pk.window_matrix_dense.warp == 2 + 2 * (not reg)


@pytest.mark.cuda
def test_cuda_wide_windows_match_plain(cuda_device):
    """Windows past the 16,384-key shared buffer sort in global scratch."""
    pk.reset_launch_counts()
    t = make_table(77, series=3, scrapes=WIDE, pad=8, nan_frac=0.01)
    args = [torch.from_numpy(t[k]) for k in ("ts", "val", "tsid", "mask")]
    want_l = pk.sort_layout_plain(*args)
    got_l = pk.with_series_offsets(
        pk.sort_layout(*(a.to(cuda_device) for a in args)), 3)
    sel = torch.from_numpy(selection(3, [2, 0, 1], 4))
    kw = dict(step_ms=300_000, num_steps=3, range_ms=WIDE * 15_000)
    start = T0 + WIDE * 15_000 - 300_000
    cm = pk.window_count_max_plain(want_l, sel, start, **kw)
    lmax = 1 << (cm - 1).bit_length()
    assert lmax > pk.SMEM_WIDTH
    for kind in ("quantile", "mad", "holt"):
        a1 = torch.tensor([0.9, 0.5, 0.1])
        a2 = torch.tensor([0.3, 0.6, 0.2])
        w = pk.window_matrix_plain(want_l, sel, start, lmax=lmax, kind=kind,
                                   a1=a1, a2=a2, **kw)
        g = pk.window_matrix(got_l, sel.to(cuda_device), start, lmax=lmax,
                             kind=kind, a1=a1.to(cuda_device),
                             a2=a2.to(cuda_device), **kw)
        close(g.cpu().numpy(), w.numpy())
    win, m = _subquery_window_matrix(WIDE, S=5, T=2)
    win = torch.from_numpy(np.where(m, win, np.nan).astype(np.float32))
    q = torch.tensor([0.9, 0.5])
    for kind in ("quantile", "mad"):
        w = pk.window_matrix_dense_plain(win, kind, q)
        g = pk.window_matrix_dense(win.to(cuda_device), kind,
                                   q.to(cuda_device))
        close(g.cpu().numpy(), w.numpy())
    torch.cuda.synchronize()
    assert pk.window_matrix.launches == 3
    assert pk.window_matrix_dense.launches == 2


@pytest.mark.cuda
def test_cuda_subquery_counter_matches_plain(cuda_device):
    pk.reset_launch_counts()
    calls = 0
    for K in (1, 2, 6, 21, 300):
        win, m = _subquery_window_matrix(K, S=33, seed=K + 200)
        ts_tk, steps = _subquery_times(K, win.shape[1])
        win = np.where(m, win, np.nan).astype(np.float32)
        args = (torch.from_numpy(win), torch.from_numpy(ts_tk),
                torch.from_numpy(steps))
        w = pk.subquery_counter(*args, kind="pair")
        g = pk.subquery_counter(*(a.to(cuda_device) for a in args),
                                kind="pair")
        calls += 1
        for k in w:
            close(g[k].cpu().numpy(), w[k].numpy(), exact=True)
        for f in ("rate", "increase", "delta"):
            w = pk.subquery_counter(*args, kind="rate", func=f,
                                    range_s=K * 15.0)
            g = pk.subquery_counter(*(a.to(cuda_device) for a in args),
                                    kind="rate", func=f, range_s=K * 15.0)
            calls += 1
            close(g.cpu().numpy(), w.numpy())
    torch.cuda.synchronize()
    assert pk.subquery_counter.launches == calls


@pytest.mark.cuda
def test_cuda_segment_select_matches_plain(cuda_device):
    sk.reset_launch_counts()
    rng = np.random.default_rng(5)
    for S, T, ng in ((400, 6, 40), (5000, 3, 1), (70_000, 2, 3),
                     (3000, 4, 2999), (2048, 3, 2)):
        v = rng.normal(0, 100, (S, T)).astype(np.float32)
        v[rng.random((S, T)) < 0.1] = np.nan
        v[rng.random((S, T)) < 0.02] = np.inf
        v[rng.random((S, T)) < 0.02] = -np.inf
        v[rng.random((S, T)) < 0.02] = -0.0
        gid = rng.integers(0, ng, S).astype(np.int32)
        gid[:ng] = np.arange(ng)
        order = np.argsort(gid, kind="stable").astype(np.int32)
        offsets = np.append(np.searchsorted(gid[order], np.arange(ng)),
                            S).astype(np.int64)
        sizes = np.diff(offsets)
        ranks = np.stack([rng.integers(0, sizes[:, None], (ng, T)),
                          np.zeros((ng, T), np.int64)]).astype(np.int32)
        args = [torch.from_numpy(a) for a in (v, order, offsets, ranks)]
        want = sk.segment_select_plain(*args)
        got = sk.segment_select(*(a.to(cuda_device) for a in args))
        close(got.cpu().numpy(), want.numpy(), exact=True)
    torch.cuda.synchronize()
    assert sk.segment_select.launches == 5
