"""Port parity end to end: PromQL through ``GreptimeDB.sql("TQL EVAL …")``
and ``PromEvaluator.eval``.

The reference ``GreptimeDB()`` and the port ``GreptimeDB(device="cpu")``
take the same writes (counters with resets and NaN samples, scraped every
15 s, ``bench_promql.py``'s table at a few hundred series) and answer the
same TQL.  Rows must be equal under the golden comparer's rule (numeric
cells ``|a-b| <= 1e-5*max(1,|b|)``, tests/test_golden.py; label values
and timestamps exact).  The port's fused and unfused routes
(``GREPTIME_PLAN_FUSION``) and its cached and uncached evaluations
(``GREPTIME_PROMQL_CACHE``) must give equal rows; unknown metrics give an
empty vector and the one aggregation the reference refuses too
(``count_values``) is refused, not faked.
"""

import numpy as np
import pytest

from greptimedb_tpu.errors import Unsupported as RefUnsupported
from greptimedb_tpu.promql.engine import PromEvaluator as RefEvaluator
from greptimedb_tpu.promql.parser import parse_promql as ref_parse
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.compile.fused import FUSED_DISPATCHES
from greptimedb_tpu_torch.errors import Unsupported
from greptimedb_tpu_torch.promql.engine import PromEvaluator
from greptimedb_tpu_torch.promql.parser import parse_promql
from greptimedb_tpu_torch.standalone import GreptimeDB

T0 = 1_700_000_000_000
SCRAPE = 15_000
PODS, CONTAINERS, SCRAPES = 30, 4, 40
DDL = ("CREATE TABLE http_requests_total (pod STRING, container STRING, "
       "ts TIMESTAMP(3) TIME INDEX, val DOUBLE, PRIMARY KEY (pod, container))")
M = "http_requests_total"


def tql(expr, start=300_000, end=585_000, step=15):
    return f"TQL EVAL ({(T0 + start) / 1000}, {(T0 + end) / 1000}, {step}) {expr}"


def write_counters(db, seed=3, scrapes=SCRAPES, first=0, flush=False):
    """bench_promql.py's write path at test size: one region.write per
    scrape over every series; counters rise 100-200 per scrape, 3% of
    (series, scrape) reset to a small value, 2% of samples are NaN."""
    region = db._region_of(M)
    rng = np.random.default_rng(seed)
    n = PODS * CONTAINERS
    pods = np.array([f"pod-{i}" for i in range(PODS)], dtype=object)
    conts = np.array([f"c{i}" for i in range(CONTAINERS)], dtype=object)
    c = rng.uniform(0, 1000, n)
    for k in range(first, first + scrapes):
        c = c + rng.uniform(100, 200, n)
        c = np.where(rng.random(n) < 0.03, rng.uniform(0, 10, n), c)
        v = np.where(rng.random(n) < 0.02, np.nan, c)
        region.write({"pod": pods[np.arange(n) // CONTAINERS],
                      "container": conts[np.arange(n) % CONTAINERS],
                      "ts": np.full(n, T0 + k * SCRAPE, dtype=np.int64),
                      "val": v})
        if flush and k == first + scrapes // 2:
            region.flush()


def rows_match(got, want):
    assert got.column_names == want.column_names
    assert len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a != b:  # equal infinities pass
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(scope="module")
def dbs():
    # the reference on one device: its window sums are differences of
    # prefix sums, whose association on the test harness's 8-device mesh
    # is the sharded scan's; on one device it is the one the port repeats
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GREPTIME_MESH", "off")
        ref = RefDB()
    port = GreptimeDB(device="cpu")
    for db in (ref, port):
        db.sql(DDL)
        write_counters(db)
    yield ref, port
    ref.close()
    port.close()


QUERIES = [
    tql(f"sum by (pod) (rate({M}[5m]))"),
    tql(f"sum by (pod) (rate({M}[5m]))", 585_000, 585_000, 1),
    tql(f"avg by (container) (increase({M}[2m]))", 0, 700_000, 30),
    tql(f"max without (pod) (delta({M}[1m]))", -60_000, 650_000, 45),
    tql(f"min(rate({M}{{pod=~\"pod-1.*\"}}[3m]))", 100_000, 600_000, 20),
    tql(f"count by (pod) ({M}{{container!=\"c0\"}})"),
    tql(f"group by (container) ({M})"),
    tql(f"rate({M}{{pod=\"pod-7\"}}[5m])", 0, 900_000, 60),
    tql(f"{M}{{container=\"c2\", pod=~\"pod-2.\"}}", 0, 600_000, 15),
    tql(f"sum by (pod) (rate({M}[5m] offset 1m))"),
    tql(f"-sum(abs(rate({M}[5m])))"),
    tql(f"sum by (pod) (ln(increase({M}[5m])))"),
    tql("sum(3)"),
    tql("7"),
]


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_tql_matches_reference(i, dbs):
    ref, port = dbs
    want = ref.sql(QUERIES[i])
    got = port.sql(QUERIES[i])
    assert want.num_rows > 0
    rows_match(got, want)


def test_tql_result_shape(dbs):
    _ref, port = dbs
    res = port.sql(QUERIES[0])
    assert res.column_names == ["pod", "ts", "val"]
    assert res.num_rows == PODS * 20
    assert {r[1] for r in res.rows} == {T0 + 300_000 + 15_000 * j
                                        for j in range(20)}


@pytest.mark.parametrize("expr", [
    f"sum by (pod) (rate({M}[5m]))", f"avg (increase({M}[2m]))",
    f"count by (container) (delta({M}[1m]))", f"group by (pod) ({M})",
    f"min by (container) (rate({M}[1m]))", f"max (increase({M}[5m]))",
])
def test_evaluator_matches_reference(expr, dbs):
    ref, port = dbs
    end_s = (T0 + (SCRAPES - 1) * SCRAPE) / 1000
    want = RefEvaluator(ref, end_s, end_s, 1.0).eval(ref_parse(expr))
    got = PromEvaluator(port, end_s, end_s, 1.0).eval(parse_promql(expr))
    assert got.num_series == want.num_series
    assert list(got.labels) == list(want.labels)
    g = got.values.numpy()
    w = np.asarray(want.values)
    # values are f32 in the port; the reference's ``group`` comes out f64
    # (jnp.where of weak-typed 1.0 and NaN), the same 1.0 either way
    assert g.shape == w.shape and g.dtype == np.float32
    assert (np.isnan(g) == np.isnan(w)).all()
    ok = ~np.isnan(w)
    assert (np.abs(g[ok] - w[ok]) <= 1e-5 * np.maximum(1, np.abs(w[ok]))
            ).all()


@pytest.mark.parametrize("func", ["rate", "increase", "delta", None])
@pytest.mark.parametrize("agg", ["sum by (pod)", "avg", "count by (container)",
                                 "group", "min by (pod)", "max without (pod)"])
def test_fused_route_equals_unfused(func, agg, dbs, monkeypatch):
    _ref, port = dbs
    inner = f"{func}({M}[2m])" if func else M
    q = tql(f"{agg} ({inner})", 0, 700_000, 30)
    before = FUSED_DISPATCHES["count"]
    fused = port.sql(q)
    assert FUSED_DISPATCHES["count"] == before + 1, "fused route not taken"
    monkeypatch.setenv("GREPTIME_PLAN_FUSION", "off")
    plain = port.sql(q)
    assert FUSED_DISPATCHES["count"] == before + 1
    assert fused.num_rows > 0
    assert fused.column_names == plain.column_names
    assert fused.rows == plain.rows


@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
def test_bare_counter_function_takes_rate_mode(func, dbs, monkeypatch):
    """A bare rate/increase/delta (the unfused route) gets its values from
    ``counter_window``'s rate mode, the epilogue of the fused route, and
    matches the reference."""
    from greptimedb_tpu_torch.ops import promql_kernels as pk

    ref, port = dbs
    kinds = []
    window = pk.counter_window

    def spy(*args, **kw):
        kinds.append(kw["kind"])
        return window(*args, **kw)

    monkeypatch.setattr(pk, "counter_window", spy)
    q = tql(f"{func}({M}{{container=~\"c[01]\"}}[2m])", 0, 700_000, 30)
    got = port.sql(q)
    assert kinds == ["rate"]
    want = ref.sql(q)
    assert want.num_rows > 0
    rows_match(got, want)


def test_cache_off_equals_on(dbs, monkeypatch):
    _ref, port = dbs
    q = tql(f"sum by (pod) (rate({M}[5m]))")
    port.sql(q)
    hits = dict(port.promql_cache.hits)
    warm = port.sql(q)
    assert port.promql_cache.hits["sort"] == hits["sort"] + 1
    assert port.promql_cache.hits["group"] == hits["group"] + 1
    monkeypatch.setenv("GREPTIME_PROMQL_CACHE", "off")
    cold = port.sql(q)
    assert cold.rows == warm.rows


def test_unknown_metric_is_an_empty_vector(dbs):
    _ref, port = dbs
    for expr in ("nope_total", "rate(nope_total[5m])",
                 "sum by (pod) (rate(nope_total[5m]))"):
        res = port.sql(tql(expr))
        assert res.rows == []
        assert res.column_names == ["ts", "val"]


# PromQL the port refused before its fourth slice: each now answers as the
# reference does
FORMERLY_REFUSED = [
    f"irate({M}[5m])",
    f"quantile(0.9, rate({M}[5m]))",
    f"topk(3, rate({M}[5m]))",
    f"stddev(rate({M}[5m]))",
    f"rate({M}[5m]) / 2",
    f"sum_over_time({M}[5m])",
    f"max_over_time(rate({M}[1m])[5m:1m])",
    f"histogram_quantile(0.9, rate({M}[5m]))",
    f"rate({M}[5m] @ 1700000300)",
    f"round(rate({M}[5m]))",
]


@pytest.mark.parametrize("expr", FORMERLY_REFUSED)
def test_ported_promql_matches_reference(expr, dbs):
    ref, port = dbs
    q = tql(expr)
    rows_match(port.sql(q), ref.sql(q))


@pytest.mark.parametrize("expr", [
    f"count_values(\"v\", {M})",
])
def test_unported_promql_is_refused(expr, dbs):
    """count_values stays refused, as the reference refuses it."""
    ref, port = dbs
    with pytest.raises(RefUnsupported):
        ref.sql(tql(expr))
    with pytest.raises(Unsupported):
        port.sql(tql(expr))


P = f"{M}{{pod=~\"pod-(1|2).\"}}"  # 20 pods x 4 containers
AT = 1_700_000_400
PARITY = [
    # K10's other kinds, with offsets and @ (few samples per window too)
    tql(f"idelta({M}[1m])"), tql(f"irate({M}[30s] offset 45s)"),
    tql(f"resets({M}[5m])"), tql(f"changes({M}[2m] offset 1m)"),
    tql(f"avg_over_time({M}[5m])"), tql(f"count_over_time({M}[2m])"),
    tql(f"last_over_time({M}[1m] offset 30s)"),
    tql(f"first_over_time({M}[5m])"), tql(f"stddev_over_time({M}[5m])"),
    tql(f"stdvar_over_time({M}[3m] offset 2m)"),
    tql(f"present_over_time({M}[30s])"),
    tql(f"sum_over_time({M}[2m] @ {AT})"),
    tql(f"deriv({M}[5m])"), tql(f"deriv({M}[30s] offset 1m)"),
    tql(f"predict_linear({M}[2m] offset 30s, 120)"),
    tql(f"deriv({M}[2m] @ {AT} offset 30s)"),
    # K13
    tql(f"min_over_time({M}[5m])"), tql(f"max_over_time({M}[45s])"),
    tql(f"max_over_time({M}[2m] @ {AT})"),
    # K14
    tql(f"quantile_over_time(0.9, {M}[5m])"),
    tql(f"quantile_over_time(0, {M}[1m] offset 1m)"),
    tql(f"quantile_over_time(1, {M}[2m])"),
    tql(f"quantile_over_time(-0.5, {M}[2m])"),
    tql(f"quantile_over_time(1.5, {M}[2m])"),
    tql(f"quantile_over_time(0.25, {M}[3m] @ {AT})"),
    tql(f"mad_over_time({M}[5m])"), tql(f"mad_over_time({M}[30s])"),
    tql(f"double_exponential_smoothing({M}[5m], 0.5, 0.3)"),
    tql(f"double_exponential_smoothing({M}[1m], 0.9, 0.1)"),
    tql(f"double_exponential_smoothing({M}[5m], 1, 0.3)"),
    # K12: aggregations, grouped and ng == 1
    tql(f"stddev by (pod) (rate({M}[5m]))"),
    tql(f"stdvar without (pod) ({M})"),
    tql(f"quantile by (pod) (0.5, rate({M}[5m]))"),
    tql(f"quantile (0.99, {M})"), tql(f"quantile (0, rate({M}[2m]))"),
    tql(f"quantile by (container) (1, {M})"),
    tql(f"quantile (-1, rate({M}[5m]))"),
    tql(f"quantile by (pod) (2, rate({M}[5m]))"),
    tql(f"topk(5, {M})"), tql(f"topk by (pod) (2, rate({M}[5m]))"),
    tql(f"bottomk(3, rate({M}[2m]))"),
    tql(f"bottomk by (container) (1, {M})"),
    tql(f"topk(1000, {P})"), tql(f"topk(scalar(vector(2)), {P})"),
    # binary operators and vector matching
    tql(f"{P} - 100"), tql(f"3 * {P}"), tql(f"{P} % 7"),
    tql(f"{P} atan2 1000"), tql(f"{P} > 5000"), tql(f"5000 < {P}"),
    tql(f"{P} >= bool 5000"), tql(f"2 == bool 2"),
    tql(f"rate({M}[5m]) / on (pod, container) increase({M}[5m])"),
    tql(f"rate({M}{{container=\"c0\"}}[5m]) / ignoring (container) "
        f"rate({M}{{container=\"c1\"}}[5m])"),
    tql(f"sum by (pod) (rate({M}[5m])) / sum by (pod) "
        f"(avg_over_time({M}[5m]))"),
    tql(f"{P} and {M}{{container=\"c2\"}}"),
    tql(f"{P} unless {M}{{container=\"c2\"}}"),
    tql(f"{M}{{pod=\"pod-3\"}} or {M}{{pod=\"pod-4\"}}"),
    # subqueries
    tql(f"rate({M}[1m:15s])"), tql(f"increase({M}[2m:30s] offset 30s)"),
    tql(f"delta({M}[1m:15s])"), tql(f"irate({M}[2m:30s])"),
    tql(f"idelta({M}[1m:15s])"),
    tql(f"avg_over_time(rate({M}[1m])[5m:30s])"),
    tql(f"quantile_over_time(0.5, rate({M}[1m])[5m:1m])"),
    tql(f"quantile_over_time(1.5, {M}[2m:30s])"),
    tql(f"mad_over_time({M}[3m:30s])"),
    tql(f"stddev_over_time({M}[5m:1m])"),
    tql(f"stdvar_over_time({M}[5m:1m])"),
    tql(f"sum_over_time({M}[2m:30s])"),
    tql(f"count_over_time({M}[2m:45s])"),
    tql(f"present_over_time({M}[2m:45s])"),
    tql(f"min_over_time({M}[2m:20s])"),
    tql(f"last_over_time({M}[2m:30s] offset 1m)"),
    tql(f"first_over_time({M}[2m:30s])"),
    tql(f"max by (pod) (max_over_time(rate({M}[1m])[5m:1m]))"),
    # scalar, label and misc functions
    tql(f"timestamp({P})"), tql("time()"), tql("vector(1)"),
    tql(f"scalar(sum({M}))"), tql(f"absent(nope_total)"),
    tql(f"absent({M})"), tql(f"clamp({P}, 1000, 5000)"),
    tql(f"clamp_min({P}, 5000)"), tql(f"clamp_max({P}, 5000)"),
    tql(f"round({P}, 10)"), tql(f"sort_desc({P})"),
    tql(f"label_replace({P}, \"p\", \"$1\", \"pod\", \"pod-(.*)\")"),
    tql(f"label_join({P}, \"pc\", \"/\", \"pod\", \"container\")"),
]


@pytest.mark.parametrize("i", range(len(PARITY)))
def test_promql_surface_matches_reference(i, dbs):
    ref, port = dbs
    want = ref.sql(PARITY[i])
    rows_match(port.sql(PARITY[i]), want)


WINDOW_FUNCS = ["irate", "idelta", "resets", "changes", "avg_over_time",
                "sum_over_time", "count_over_time", "last_over_time",
                "first_over_time", "stddev_over_time", "stdvar_over_time",
                "present_over_time", "min_over_time", "max_over_time",
                "deriv"]


@pytest.mark.parametrize("func", WINDOW_FUNCS)
@pytest.mark.parametrize("agg", ["sum by (pod)", "max without (pod)",
                                 "count"])
def test_fused_window_kinds_equal_unfused(func, agg, dbs, monkeypatch):
    """Every window kind fuses under an aggregation, and the fused rows
    equal the unfused ones and the reference's."""
    ref, port = dbs
    q = tql(f"{agg} ({func}({M}[2m] offset 30s))", 0, 700_000, 30)
    before = FUSED_DISPATCHES["count"]
    fused = port.sql(q)
    assert FUSED_DISPATCHES["count"] == before + 1, "fused route not taken"
    monkeypatch.setenv("GREPTIME_PLAN_FUSION", "off")
    plain = port.sql(q)
    assert FUSED_DISPATCHES["count"] == before + 1
    assert fused.num_rows > 0
    assert fused.rows == plain.rows
    rows_match(fused, ref.sql(q))


@pytest.mark.parametrize("expr", [
    f"stddev(rate({M}[5m]))", f"stdvar by (pod) (avg_over_time({M}[5m]))",
    f"quantile(0.5, rate({M}[5m]))", f"topk(2, irate({M}[5m]))",
    f"sum(rate({M}[5m] @ 1700000300))",
])
def test_unfused_aggregations_stay_unfused(expr, dbs):
    """stddev/stdvar (whose v^2 - mean^2 cancels), the order statistics
    and pinned selectors take the multi-step path."""
    ref, port = dbs
    before = FUSED_DISPATCHES["count"]
    got = port.sql(tql(expr))
    assert FUSED_DISPATCHES["count"] == before
    rows_match(got, ref.sql(tql(expr)))


WIDE_SCRAPES = 17_500  # 1 s scrapes: a 5 h window holds 17,500 samples


def write_wide(db):
    """Two gauges scraped every second for WIDE_SCRAPES seconds: one window
    holds more samples than the window-matrix kernels' shared-memory
    buffers (16,384 keys)."""
    rng = np.random.default_rng(12)
    n = 2 * WIDE_SCRAPES
    k = np.tile(np.arange(WIDE_SCRAPES), 2)
    v = np.round(rng.normal(50, 20, n), 2)
    v[rng.random(n) < 0.01] = np.nan
    db._region_of(M).write({
        "pod": np.array(["pod-0", "pod-1"], dtype=object)[
            np.arange(n) // WIDE_SCRAPES],
        "container": np.full(n, "c0", dtype=object),
        "ts": T0 + 1000 * k.astype(np.int64), "val": v})


@pytest.fixture(scope="module")
def wide_dbs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GREPTIME_MESH", "off")
        ref = RefDB()
    port = GreptimeDB(device="cpu")
    for db in (ref, port):
        db.sql(DDL)
        write_wide(db)
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("expr", [
    f"quantile_over_time(0.9, {M}[5h])", f"mad_over_time({M}[5h])",
    f"double_exponential_smoothing({M}[5h], 0.5, 0.3)",
    f"quantile_over_time(0.5, {M}[5h:1s])",
])
def test_windows_wider_than_shared_memory_match_reference(expr, wide_dbs):
    """quantile/mad/Holt over windows of ~17,300 samples (lmax 32,768) and
    a subquery of 18,000 inner steps answer as the reference does."""
    ref, port = wide_dbs
    q = tql(expr, 1000 * WIDE_SCRAPES - 60_000, 1000 * WIDE_SCRAPES, 60)
    want = ref.sql(q)
    assert want.num_rows > 0
    rows_match(port.sql(q), want)


def test_new_writes_are_seen(tmp_path):
    """A write after a query moves the region's generation: the device
    table, sort layout and selection rebuild, as in the reference."""
    ref, port = RefDB(), GreptimeDB(device="cpu")
    try:
        q = tql(f"sum by (pod) (rate({M}[5m]))", 300_000, 900_000, 60)
        for db in (ref, port):
            db.sql(DDL)
            write_counters(db, scrapes=25)
        rows_match(port.sql(q), ref.sql(q))
        for db in (ref, port):
            write_counters(db, seed=4, scrapes=30, first=25)
        rows_match(port.sql(q), ref.sql(q))
    finally:
        ref.close()
        port.close()


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_path_matches_cpu(cuda_device, monkeypatch):
    """The card's route (the CUDA kernels) against the port on the CPU (the
    plain versions), fused and unfused, within the golden bound."""
    from greptimedb_tpu_torch.ops import promql_kernels as pk

    cpu, gpu = GreptimeDB(device="cpu"), GreptimeDB(device=cuda_device)
    try:
        for db in (cpu, gpu):
            db.sql(DDL)
            write_counters(db)
        pk.reset_launch_counts()
        for q in QUERIES:
            rows_match(gpu.sql(q), cpu.sql(q))
        assert pk.sort_layout.launches == 1
        assert pk.sort_layout.presorted == 1  # the resident table's order
        assert pk.counter_window.launches > 0 and pk.prefix_scan.launches > 0
        monkeypatch.setenv("GREPTIME_PLAN_FUSION", "off")
        bare = [tql(f"{f}({M}[2m])", 0, 700_000, 30)
                for f in ("rate", "increase", "delta")]
        for q in QUERIES[:8] + bare:
            rows_match(gpu.sql(q), cpu.sql(q))
        monkeypatch.delenv("GREPTIME_PLAN_FUSION")
        for q in PARITY:
            rows_match(gpu.sql(q), cpu.sql(q))
        assert pk.window_matrix_dense.launches > 0
        assert pk.subquery_counter.launches > 0
    finally:
        cpu.close()
        gpu.close()
