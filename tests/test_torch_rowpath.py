"""Port parity of the SQL row path: ``GreptimeDB.sql`` through
``Executor.execute`` (``_execute_agg`` / ``_execute_raw``) on the CPU.

The port (``device="cpu"``) and the JAX reference ingest the same
TSBS-shaped table at test size (16 hosts, 3 h @ 10 s, values from a seed,
clipped to [0, 100] so the top value ties) and answer the same queries
with ``GREPTIME_GRID=off`` and ``GREPTIME_SORTED_SEGMENTS`` pinned to
``force`` and then ``off`` on both sides.  Rows must match under the
golden comparer's rule: exact for keys, counts, ints and min/max/first/
last; ``|a-b| <= 1e-5*max(1,|b|)`` for float sums, means and spreads.
The port's grid rows are also held to its own row-path rows.
"""

import numpy as np
import pytest

from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.query import physical
from greptimedb_tpu_torch.standalone import GreptimeDB

T0 = 1_451_606_400_000
H = 3_600_000
HOSTS, HOURS, SPH = 16, 3, 360
METRICS = ("usage_user", "usage_system", "usage_idle")
DDL = (f"CREATE TABLE cpu (hostname STRING, ts TIMESTAMP(3) TIME INDEX, "
       f"{', '.join(f'{m} DOUBLE' for m in METRICS)}, cores BIGINT, "
       f"PRIMARY KEY (hostname))")
W0, W1 = T0 + H // 2, T0 + 5 * H // 2
LASTS = ", ".join(f"last_value({m})" for m in METRICS)
AVGS = ", ".join(f"avg({m})" for m in METRICS)
QUERIES = {
    "lastpoint": f"SELECT hostname, {LASTS} FROM cpu GROUP BY hostname",
    "high_cpu": (f"SELECT * FROM cpu WHERE usage_user > 90.0 AND ts >= {W0} "
                 f"AND ts < {W1}"),
    "decile": (f"SELECT floor(usage_user / 10) AS decile, count(*) FROM cpu "
               f"WHERE ts >= {W0} AND ts < {W1} GROUP BY decile "
               f"ORDER BY decile"),
    "distinct": ("SELECT count(DISTINCT hostname) FROM cpu "
                 "WHERE usage_user > 95"),
    "spread": ("SELECT hostname, stddev(usage_user), var_pop(usage_system), "
               "first_value(usage_idle), avg(cores), sum(cores), max(cores) "
               "FROM cpu GROUP BY hostname ORDER BY hostname"),
    "hourly": (f"SELECT hostname, date_trunc('hour', ts) AS hour, {AVGS}, "
               f"min(cores), count(*) FROM cpu WHERE ts >= {W0} AND "
               f"ts < {W1} GROUP BY hostname, hour"),
    "empty_global": ("SELECT sum(usage_user), count(*), max(cores), "
                     "sum(cores), avg(usage_idle) FROM cpu "
                     "WHERE usage_user > 1000"),
    "top5_ties": ("SELECT hostname, ts, usage_user FROM cpu "
                  "ORDER BY usage_user DESC LIMIT 5"),
    "raw_where": ("SELECT hostname, cores FROM cpu WHERE hostname != 'host_3'"
                  " AND (cores % 7 = 1 OR usage_idle IS NULL) "
                  "AND ts < 1451606460000"),
    "case_expr": ("SELECT cores % 3 AS m3, count(*), max(usage_user) "
                  "FROM cpu WHERE CASE WHEN cores > 4 THEN usage_user "
                  "ELSE 0.0 END > 50 GROUP BY m3 ORDER BY m3"),
}


def _ingest(db):
    db.sql(DDL)
    region = db._region_of("cpu")
    rng = np.random.default_rng(11)
    names = np.array([f"host_{i}" for i in range(HOSTS)], dtype=object)
    state = rng.uniform(60, 100, size=(HOSTS, len(METRICS)))
    for h in range(HOURS):
        ts = T0 + (h * SPH + np.repeat(np.arange(SPH), HOSTS)) * 10_000
        walk = rng.normal(0, 2, size=(SPH, HOSTS, len(METRICS)))
        series = np.clip(state[None] + np.cumsum(walk, axis=0), 0, 100)
        state = series[-1]
        data = {"hostname": np.tile(names, SPH), "ts": ts,
                "cores": rng.integers(1, 9, SPH * HOSTS).astype(np.int64)}
        for j, m in enumerate(METRICS):
            data[m] = series[:, :, j].reshape(-1)
        data["usage_idle"][rng.random(SPH * HOSTS) < 0.01] = np.nan
        region.write(data)
        if h == 1:
            region.flush()


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    ref = RefDB(str(tmp_path_factory.mktemp("ref")))
    port = GreptimeDB(str(tmp_path_factory.mktemp("port")), device="cpu")
    _ingest(ref)
    _ingest(port)
    yield ref, port
    ref.close()
    port.close()


def _rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float) and not isinstance(a, str):
                assert a is not None, (g, w)
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("segments", ["force", "off"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_row_path_matches_reference(name, segments, dbs, monkeypatch):
    ref, port = dbs
    monkeypatch.setenv("GREPTIME_GRID", "off")
    monkeypatch.setenv("GREPTIME_SORTED_SEGMENTS", segments)
    before = dict(physical.DISPATCH_STATS)
    want = ref.sql(QUERIES[name])
    got = port.sql(QUERIES[name])
    assert got.column_names == want.column_names
    assert got.column_types == want.column_types
    assert want.num_rows > 0
    _rows_match(got.rows, want.rows)
    moved = {k: physical.DISPATCH_STATS[k] - before[k] for k in before}
    if name in ("lastpoint", "spread", "hourly") and segments == "force":
        assert moved["sorted"] == 1 and moved["scatter"] == 0
    elif name not in ("high_cpu", "top5_ties", "raw_where"):
        assert moved["scatter"] == 1 and moved["sorted"] == 0


def test_deferred_topk_keeps_tied_rows_in_row_order(dbs, monkeypatch):
    """ORDER BY <numeric> LIMIT k runs as compact → host stable sort
    (the device top-k is not ported): ties keep row order, as jnp.lexsort
    breaks them in the reference."""
    ref, port = dbs
    monkeypatch.setenv("GREPTIME_GRID", "off")
    sql = ("SELECT hostname, ts, usage_user FROM cpu WHERE usage_user = 100.0"
           " ORDER BY usage_user DESC LIMIT 7")
    want = ref.sql(sql)
    got = port.sql(sql)
    assert want.num_rows == 7
    assert got.rows == want.rows
    # the clipped walk ties at 100.0: the rows are the first 7 in row
    # order of the resident table ((tsid, ts)-sorted)
    assert len({r[2] for r in got.rows}) == 1


GRID_QUERIES = [
    (f"SELECT hostname, date_trunc('hour', ts) AS hour, {AVGS} "
     f"FROM cpu WHERE ts >= {T0 + H} AND ts < {T0 + 3 * H} "
     f"GROUP BY hostname, hour"),
    (f"SELECT hostname, date_trunc('hour', ts) AS hour, {AVGS} "
     f"FROM cpu WHERE ts >= {T0 + H} AND ts < {T0 + 3 * H} "
     f"AND hostname IN ('host_2', 'host_7') GROUP BY hostname, hour"),
    (f"SELECT hostname, date_trunc('hour', ts) AS hour, min(usage_user), "
     f"max(usage_idle) FROM cpu WHERE ts >= {T0 + 300_000} AND "
     f"ts < {T0 + 2 * H} GROUP BY hostname, hour ORDER BY hostname, hour"),
]


@pytest.mark.parametrize("segments", ["force", "off"])
@pytest.mark.parametrize("i", range(len(GRID_QUERIES)))
def test_grid_rows_equal_row_path_rows(i, segments, dbs, monkeypatch):
    _ref, port = dbs
    metrics: dict = {}
    port.stage_sink = metrics
    try:
        grid = port.sql(GRID_QUERIES[i])
    finally:
        port.stage_sink = None
    assert metrics.get("grid") is True
    monkeypatch.setenv("GREPTIME_GRID", "off")
    monkeypatch.setenv("GREPTIME_SORTED_SEGMENTS", segments)
    rows = port.sql(GRID_QUERIES[i])
    assert rows.column_names == grid.column_names
    _rows_match(sorted(rows.rows, key=lambda r: (r[0], r[1])),
                sorted(grid.rows, key=lambda r: (r[0], r[1])))


def test_sorted_tags_detected(dbs):
    _ref, port = dbs
    table, _bounds = port.device_table("cpu", None)
    assert table.sorted_tags == ("hostname",)


def test_bad_sorted_segments_mode_raises(dbs, monkeypatch):
    from greptimedb_tpu_torch.errors import PlanError

    _ref, port = dbs
    monkeypatch.setenv("GREPTIME_GRID", "off")
    monkeypatch.setenv("GREPTIME_SORTED_SEGMENTS", "sometimes")
    with pytest.raises(PlanError, match="auto|force|off"):
        port.sql(QUERIES["lastpoint"])
