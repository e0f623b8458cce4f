"""Port parity: ``Executor.execute_grid`` on one resident state.

The reference builds its grid from region data; the port's grid is the
same arrays through ``grid_from_numpy``.  Each package parses, optimizes
and plans the same SQL against its own table context, then both
executors run; result envs must match (tag values, bucket timestamps,
counts exact; float sums/means ``|a-b| <= 1e-5*max(1,|b|)``) and both
must take the same route (``metrics["layout"]``).
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu.query.exprs import TableContext as RefCtx
from greptimedb_tpu.query.optimizer import optimize_select as ref_optimize
from greptimedb_tpu.query.parser import parse_sql as ref_parse
from greptimedb_tpu.query.physical import Executor as RefExecutor
from greptimedb_tpu.query.planner import plan_select as ref_plan
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.datatypes.batch import DictionaryEncoder
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.ops import grid_kernels as gk
from greptimedb_tpu_torch.query.exprs import TableContext
from greptimedb_tpu_torch.query.optimizer import optimize_select
from greptimedb_tpu_torch.query.parser import parse_sql
from greptimedb_tpu_torch.query.physical import Executor
from greptimedb_tpu_torch.query.planner import plan_select
from greptimedb_tpu_torch.storage.grid import grid_from_numpy

T0 = 1_451_606_400_000
H = 3_600_000
HOSTS, HOURS, SPH = 16, 3, 360
FIELDS = ("a", "b", "c", "d")


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """16 hosts × 3 h @ 10 s, 4 metrics (b carries NaN), flushed hourly."""
    home = tmp_path_factory.mktemp("ref")
    db = RefDB(str(home))
    cols = ", ".join(f"{f} DOUBLE" for f in FIELDS)
    db.sql(f"CREATE TABLE cpu (hostname STRING, region STRING, "
           f"ts TIMESTAMP(3) TIME INDEX, {cols}, "
           f"PRIMARY KEY (hostname, region))")
    region = db._region_of("cpu")
    rng = np.random.default_rng(7)
    names = np.array([f"host_{i}" for i in range(HOSTS)], dtype=object)
    regions = np.array([f"r{i % 4}" for i in range(HOSTS)], dtype=object)
    for h in range(HOURS):
        ts = T0 + (h * SPH + np.repeat(np.arange(SPH), HOSTS)) * 10_000
        data = {"hostname": np.tile(names, SPH),
                "region": np.tile(regions, SPH), "ts": ts}
        for f in FIELDS:
            data[f] = rng.uniform(0, 100, SPH * HOSTS)
        data["b"][rng.random(SPH * HOSTS) < 0.03] = np.nan
        region.write(data)
        region.flush()
    ref_grid = db.cache.get_grid(region)
    bounds = region.ts_bounds()
    ref_ctx = RefCtx(region.schema, region.encoders)
    port_grid = grid_from_numpy(
        np.asarray(ref_grid.values), np.asarray(ref_grid.valid),
        {k: np.asarray(v) for k, v in ref_grid.tag_codes.items()},
        ts0=ref_grid.ts0, step=ref_grid.step, nt=ref_grid.nt,
        num_series=ref_grid.num_series, field_names=ref_grid.field_names,
        dicts=ref_grid.dicts, no_nan=ref_grid.no_nan, device="cpu",
        region_id=ref_grid.region_id)
    port_ctx = TableContext(
        Schema.from_dict(region.schema.to_dict()),
        {k: DictionaryEncoder(enc.values())
         for k, enc in region.encoders.items()})
    yield ref_grid, port_grid, ref_ctx, port_ctx, bounds
    db.close()


def _plan(parse, optimize, plan, sql, ctx):
    sel, _rules = optimize(parse(sql)[0], ctx)
    return plan(sel, ctx)


def _compare_env(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        w = np.asarray(w)
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            assert g.dtype.kind == "f", k
            nan = np.isnan(w)
            assert (np.isnan(g) == nan).all(), k
            ok = ~nan
            assert (np.abs(g[ok] - w[ok])
                    <= 1e-5 * np.maximum(1.0, np.abs(w[ok]))).all(), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


AVG = ", ".join(f"avg({f})" for f in FIELDS if f != "b")  # b has NaN
W = f"ts >= {T0 + H} AND ts < {T0 + 3 * H}"
SHAPES = {
    # the five plan shapes of the TSBS slice
    "aligned_avg_count": (
        f"SELECT hostname, date_trunc('hour', ts) AS hour, {AVG}, count(*) "
        f"FROM cpu WHERE {W} GROUP BY hostname, hour", "bucket_major"),
    "tag_only_where": (
        f"SELECT hostname, date_trunc('hour', ts) AS hour, avg(a), sum(c) "
        f"FROM cpu WHERE {W} AND hostname IN ('host_1', 'host_5', 'nope') "
        f"GROUP BY hostname, hour", "bucket_major"),
    "unaligned_min_max": (
        f"SELECT hostname, date_trunc('hour', ts) AS hour, min(a), max(c), "
        f"min(d) FROM cpu WHERE ts >= {T0 + 300_000} AND "
        f"ts < {T0 + 2 * H + 300_000} GROUP BY hostname, hour",
        "dynamic_slice"),
    "nan_column": (
        f"SELECT hostname, date_trunc('hour', ts) AS hour, avg(b), "
        f"count(b), sum(b), max(b) FROM cpu WHERE {W} "
        f"GROUP BY hostname, hour", "dynamic_slice"),
    "global_no_time_key": (
        "SELECT count(*), sum(a), avg(b), min(c), max(d) FROM cpu",
        "dynamic_slice"),
    # further shapes the grid path takes
    "two_tags_date_bin": (
        f"SELECT region, hostname, date_bin(INTERVAL '30 minutes', ts) AS w, "
        f"avg(d) FROM cpu WHERE {W} GROUP BY region, hostname, w",
        "bucket_major"),
    "tag_like_unaligned": (
        f"SELECT region, date_trunc('hour', ts) AS hour, avg(c), max(a) "
        f"FROM cpu WHERE ts >= {T0 + 1000} AND ts < {T0 + 2 * H} AND "
        f"hostname LIKE 'host_1%' GROUP BY region, hour", "dynamic_slice"),
    "field_where_expr_arg": (
        f"SELECT hostname, sum(a * 2 + 1), avg(c - d) FROM cpu "
        f"WHERE a > 50 AND {W} GROUP BY hostname", "dynamic_slice"),
    "tag_group_no_time": (
        "SELECT region, count(*), avg(a), min(b) FROM cpu GROUP BY region",
        "dynamic_slice"),
    "empty_window": (
        f"SELECT hostname, date_trunc('hour', ts) AS hour, avg(a) FROM cpu "
        f"WHERE ts >= {T0 + 10 * H} AND ts < {T0 + 11 * H} "
        f"GROUP BY hostname, hour", "dynamic_slice"),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_execute_grid_matches_reference(shape, state):
    ref_grid, port_grid, ref_ctx, port_ctx, bounds = state
    sql, route = SHAPES[shape]
    ref_p = _plan(ref_parse, ref_optimize, ref_plan, sql, ref_ctx)
    port_p = _plan(parse_sql, optimize_select, plan_select, sql, port_ctx)
    rm, pm = {}, {}
    want = RefExecutor().execute_grid(ref_p, ref_grid, bounds, metrics=rm)
    gk.reset_launch_counts()
    got = Executor().execute_grid(port_p, port_grid, bounds, metrics=pm)
    assert want is not None and got is not None
    assert gk.bucket_reduce.launches == 0  # CPU tensors: plain versions
    assert got[1] == want[1]
    _compare_env(got[0], want[0])
    assert pm["layout"] == rm["layout"] == route
    assert pm.get("layout_cache") == rm.get("layout_cache")


def test_warm_bucket_major_hits_layout_cache(state):
    ref_grid, port_grid, _ref_ctx, port_ctx, bounds = state
    sql = SHAPES["aligned_avg_count"][0]
    ex = Executor()
    plan = _plan(parse_sql, optimize_select, plan_select, sql, port_ctx)
    first, warm = {}, {}
    a = ex.execute_grid(plan, port_grid, bounds, metrics=first)
    b = ex.execute_grid(plan, port_grid, bounds, metrics=warm)
    assert (first["layout_cache"], warm["layout_cache"]) == ("miss", "hit")
    assert (first["jit_cache"], warm["jit_cache"]) == ("miss", "hit")
    _compare_env(b[0], a[0])
    assert len(ex.layout_cache) == 1


def test_ineligible_plans_return_none_like_reference(state):
    ref_grid, port_grid, ref_ctx, port_ctx, bounds = state
    # a 7-second bucket is not a multiple of the 10 s grid step
    sql = ("SELECT hostname, date_bin(INTERVAL '7 seconds', ts) AS w, "
           "avg(a) FROM cpu GROUP BY hostname, w")
    ref_p = _plan(ref_parse, ref_optimize, ref_plan, sql, ref_ctx)
    port_p = _plan(parse_sql, optimize_select, plan_select, sql, port_ctx)
    assert RefExecutor().execute_grid(ref_p, ref_grid, bounds) is None
    assert Executor().execute_grid(port_p, port_grid, bounds) is None


def test_outputs_keep_reference_dtypes(state):
    _ref_grid, port_grid, _ref_ctx, port_ctx, bounds = state
    plan = _plan(parse_sql, optimize_select, plan_select,
                 SHAPES["aligned_avg_count"][0], port_ctx)
    env, n = Executor().execute_grid(plan, port_grid, bounds)
    assert env["count(*)"].dtype == np.int64
    assert env["avg(a)"].dtype == np.float32
    assert env["hour"].dtype == np.int64
    assert n == HOSTS * 2
    assert isinstance(port_grid.values, torch.Tensor)
