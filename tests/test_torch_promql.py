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
empty vector and unported PromQL is refused, not faked.
"""

import numpy as np
import pytest

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
            if isinstance(b, float):
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(scope="module")
def dbs():
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


@pytest.mark.parametrize("expr", [
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
])
def test_unported_promql_is_refused(expr, dbs):
    _ref, port = dbs
    with pytest.raises(Unsupported, match="not ported yet"):
        port.sql(tql(expr))


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
        assert pk.counter_window.launches > 0 and pk.prefix_scan.launches > 0
        monkeypatch.setenv("GREPTIME_PLAN_FUSION", "off")
        bare = [tql(f"{f}({M}[2m])", 0, 700_000, 30)
                for f in ("rate", "increase", "delta")]
        for q in QUERIES[:8] + bare:
            rows_match(gpu.sql(q), cpu.sql(q))
    finally:
        cpu.close()
        gpu.close()
