"""Port parity of the mesh row path (K20: the reference's
``greptimedb_tpu/parallel/dist.py``, its ``local`` partials under
``shard_map`` and the collectives that merge them).

The port's mesh is a tuple of torch devices; here 8 shards on the CPU,
as the reference's tests run 8 virtual CPU devices (``conftest.py``).

- ``shard_table`` / ``shard_region`` lay rows out as the reference does:
  the same values, order, padding and mask.
- ``DistAggExecutor.aggregate`` equals the reference's on the same host
  columns for every op: f32 / int64 sums, counts, f32 / int64 min and max,
  means, first/last with a timestamp tie across shards (the largest value
  among the shards at the extreme wins), HLL registers and UDDSketch rows;
  with empty and all-NULL groups, WHERE plus a time range and the
  zero-match global row.  Float sums and means within
  ``1e-5*max(1,|b|)`` (each shard sums in f32, then the shards: the order
  differs), everything else exact.
- ``mesh_merge_plain`` / ``mesh_pick_plain`` against numpy.
- The reference's own ``TestMeshRowSql`` and ``TestUnifiedSplitOnMesh``
  run on the port's db with a mesh of 8 CPU shards.
- ``GREPTIME_MESH=off`` (read at query time), ``GREPTIME_MESH_MIN_ROWS``,
  the mesh forming only when installed, the WHERE plan keyed by the
  dictionary version, the dense limit and OFFSET.

Tests marked ``cuda`` hold ``mesh_merge`` to its plain version per mode,
and the local phase on ``cuda:0`` shards, and on one shard per card of a
host with several, to the CPU mesh's.
"""

import numpy as np
import pytest
import test_parallel as tp
import torch

from greptimedb_tpu.ops.sketch import udd_gamma
from greptimedb_tpu.parallel import DistAggExecutor as RefExecutor
from greptimedb_tpu.parallel import create_mesh as ref_mesh
from greptimedb_tpu.parallel import shard_table as ref_shard_table
from greptimedb_tpu.parallel.dist import shard_region as ref_shard_region
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.ops import mesh_kernels as mk
from greptimedb_tpu_torch.parallel import DistAggExecutor, shard_table
from greptimedb_tpu_torch.parallel.dist import (
    create_mesh, execute_select_on_mesh, shard_region,
)
from greptimedb_tpu_torch.query.parser import parse_sql
from greptimedb_tpu_torch.standalone import GreptimeDB
from greptimedb_tpu_torch.storage.memtable import TSID

T0 = 1_700_000_000_000
HOUR = 3_600_000
REL = 1e-5
GAMMA = udd_gamma(0.01)
CPU8 = create_mesh(8, device="cpu")
# two device groups on the one CPU, shards interleaved: the exchange puts
# the partials back in mesh order
SPLIT8 = tuple(torch.device("cpu") if s % 2 == 0 else torch.device("cpu", 0)
               for s in range(8))


@pytest.fixture(scope="module")
def mesh8():
    return ref_mesh(8)


def make_columns(seed, n_series=64, steps=60):
    """Series on one 1-minute grid (so the last timestamps of a group tie
    across shards), host = tsid % 12: a group spans two shards.  f32 and
    f64 fields with NaN, host 11's f64 field all NaN, an int64 field."""
    rng = np.random.default_rng(seed)
    tsid = np.repeat(np.arange(n_series, dtype=np.int64), steps)
    ts = T0 + np.tile(np.arange(steps, dtype=np.int64) * 60_000 * 4,
                      n_series)
    d = rng.integers(0, 100, tsid.size).astype(np.float64)
    d[rng.random(tsid.size) < 0.05] = np.nan
    d[tsid % 12 == 11] = np.nan
    f = rng.normal(50, 20, tsid.size).astype(np.float32)
    f[rng.random(tsid.size) < 0.05] = np.nan
    k = rng.integers(-(1 << 40), 1 << 40, tsid.size).astype(np.int64)
    u = rng.lognormal(0, 0.5, tsid.size)
    return {TSID: tsid, "ts": ts, "d": d, "f": f, "k": k, "u": u,
            "host": (tsid % 12).astype(np.int32)}


def host(table, name=None) -> np.ndarray:
    """The global [D * R] layout of a ShardedTable's column (the row mask
    for None), shards in mesh order: the reference's global array."""
    parts = table.row_mask if name is None else table.columns[name]
    out = np.empty((table.num_shards, table.rows_per_shard),
                   dtype=parts[0].cpu().numpy().dtype)
    for (_dev, shards), t in zip(table.groups, parts):
        out[list(shards)] = t.cpu().numpy().reshape(len(shards), -1)
    return out.reshape(-1)


def assert_same(got, want, float_sum=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.dtype, want.dtype, got.shape, want.shape)
    if not float_sum:
        np.testing.assert_array_equal(got, want)
        return
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    ok = ~nan
    assert (np.abs(got[ok] - want[ok])
            <= REL * np.maximum(1.0, np.abs(want[ok]))).all()


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port_mesh", [CPU8, SPLIT8])
def test_shard_table_layout_matches_reference(mesh8, port_mesh):
    data = make_columns(1)
    ref = ref_shard_table(data, mesh8)
    got = shard_table(data, port_mesh)
    assert got.num_shards == 8 and got.rows_per_shard == ref.rows_per_shard
    assert got.num_series == ref.num_series
    np.testing.assert_array_equal(host(got), np.asarray(ref.row_mask))
    for name in data:
        want = np.asarray(ref.columns[name])
        have = host(got, name)
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want, err_msg=name)


def test_explicit_series_map_matches_reference(mesh8):
    data = make_columns(2, n_series=16, steps=10)
    shard_of = np.arange(16, dtype=np.int64) // 2
    ref = ref_shard_table(data, mesh8, shard_of_series=shard_of)
    got = shard_table(data, CPU8, shard_of_series=shard_of)
    for name in (TSID, "ts", "d"):
        np.testing.assert_array_equal(host(got, name),
                                      np.asarray(ref.columns[name]))


def test_shard_region_matches_reference(mesh8):
    rows = ",".join(f"('h{i % 11}','dc{i % 3}',{T0 + i * 137},{i % 97},"
                    f"{i % 5},'s{i}')" for i in range(3000))
    out = []
    for db, shard, mesh in ((RefDB(), ref_shard_region, mesh8),
                            (GreptimeDB(device="cpu"), shard_region, CPU8)):
        db.sql("CREATE TABLE t (host STRING, dc STRING, ts TIMESTAMP(3) "
               "TIME INDEX, v DOUBLE, k BIGINT, s STRING, "
               "PRIMARY KEY (host, dc))")
        db.sql("INSERT INTO t VALUES " + rows)
        db._region_of("t").flush()
        out.append(shard(db._table_view("t"), mesh))
        db.close()
    ref, got = out
    assert set(got.columns) == set(ref.columns) and "s" not in got.columns
    np.testing.assert_array_equal(host(got), np.asarray(ref.row_mask))
    for name in ref.columns:
        want = np.asarray(ref.columns[name])
        assert host(got, name).dtype == want.dtype, name
        np.testing.assert_array_equal(host(got, name), want, err_msg=name)
    assert got.columns["v"][0].dtype == torch.float64  # host dtype


# ---------------------------------------------------------------------------
# DistAggExecutor.aggregate against the reference's
# ---------------------------------------------------------------------------

ALL_OPS = [
    ("s_f", "sum", "f"), ("s_d", "sum", "d"), ("s_k", "sum", "k"),
    ("c_f", "count", "f"), ("c_k", "count", "k"), ("c_all", "count", None),
    ("mn_f", "min", "f"), ("mx_f", "max", "f"), ("mn_d", "min", "d"),
    ("mn_k", "min", "k"), ("mx_k", "max", "k"), ("avg_d", "mean", "d"),
    ("avg_k", "mean", "k"), ("fv_d", "first", "d"), ("lv_d", "last", "d"),
    ("lv_f", "last", "f"), ("fv_k", "first", "k"), ("lv_k", "last", "k"),
    ("h", "hll", "d"), ("ud", "udd", "u", (GAMMA, 128)),
]
FLOAT_SUMS = {"s_f", "s_d", "avg_d", "avg_k"}
KEYS = [("tag", "host", 14), ("time", "ts", HOUR, T0, 5)]


def _both(mesh8, data, keys, aggs, port_mesh=CPU8, **kw):
    ref = RefExecutor(mesh8).aggregate(ref_shard_table(data, mesh8), keys,
                                       aggs, **kw)
    got = DistAggExecutor(port_mesh).aggregate(
        shard_table(data, port_mesh), keys, aggs, **kw)
    assert set(got) == set(ref) == {a[0] for a in aggs} | {"__count__"}
    return got, ref


@pytest.mark.parametrize("port_mesh", [CPU8, SPLIT8])
def test_every_op_matches_reference(mesh8, port_mesh):
    data = make_columns(3)
    got, ref = _both(mesh8, data, KEYS, ALL_OPS, port_mesh, ts_column="ts")
    for name in ref:
        assert_same(got[name], ref[name], float_sum=name in FLOAT_SUMS)
    cnt = ref["__count__"].reshape(14, 5)
    # empty groups: hosts 12, 13 and the fifth hour
    assert (cnt[12:] == 0).all() and (cnt[:, 4] == 0).all()
    assert (cnt[:12, :4] > 0).all()
    # all-NULL groups (host 11's f64 field): NaN for float aggregates
    for name in ("s_d", "mn_d", "avg_d", "fv_d", "lv_d"):
        assert np.isnan(got[name].reshape(14, 5)[11]).all(), name
    # int min/max of empty groups: 0
    assert (got["mn_k"].reshape(14, 5)[12:] == 0).all()
    # the last timestamps tie across the two shards of every group: each
    # shard picks its first row at the tie (its lowest tsid), then the
    # larger of the shards' values wins, not the earlier row
    at = (data["host"] == 0) & (data["ts"] == data["ts"].max())
    tsids, ks = data[TSID][at], data["k"][at]
    per_shard = [ks[tsids % 8 == s][0] for s in sorted(set(tsids % 8))]
    assert len(per_shard) == 2
    assert got["lv_k"].reshape(14, 5)[0, 3] == max(per_shard)


def test_where_and_time_range_match_reference(mesh8):
    data = make_columns(4)
    kw = dict(ts_column="ts", where_fn=lambda env: env["d"] > 40,
              where_cols=("d",), where_key="d>40",
              time_range=(T0 + HOUR, T0 + 3 * HOUR))
    got, ref = _both(mesh8, data, KEYS, ALL_OPS[:14] + ALL_OPS[18:], **kw)
    for name in ref:
        assert_same(got[name], ref[name], float_sum=name in FLOAT_SUMS)
    cnt = ref["__count__"].reshape(14, 5)
    assert cnt[:, 0].sum() == 0 and cnt[:, 3:].sum() == 0
    assert cnt[:, 1:3].sum() > 0


def test_zero_match_global_aggregate_matches_reference(mesh8):
    data = make_columns(5)
    aggs = [("c", "count", None), ("s", "sum", "d"), ("m", "max", "k"),
            ("l", "last", "d")]
    got, ref = _both(mesh8, data, [], aggs, ts_column="ts",
                     where_fn=lambda env: env["d"] > 1e9, where_cols=("d",),
                     where_key="none")
    for name in ref:
        assert_same(got[name], ref[name])
    assert got["__count__"].tolist() == [0] and np.isnan(got["s"][0])


# ---------------------------------------------------------------------------
# mesh_merge's plain versions against numpy
# ---------------------------------------------------------------------------

def test_mesh_merge_plain_matches_numpy():
    rng = np.random.default_rng(7)
    D, G = 5, 300
    f = rng.normal(0, 1e4, (D, G)).astype(np.float32)
    f[2, 7] = np.nan
    want = f[0].copy()
    for d in range(1, D):
        want = want + f[d]  # f32 in shard order
    got = mk.mesh_merge_plain(torch.from_numpy(f), "sum").numpy()
    np.testing.assert_array_equal(got, want)
    big = rng.integers(-(1 << 60), 1 << 60, (D, G), dtype=np.int64)
    np.testing.assert_array_equal(
        mk.mesh_merge_plain(torch.from_numpy(big), "sum").numpy(),
        big.sum(0))
    for dt in (np.float32, np.float64, np.int32, np.int64):
        x = rng.integers(-1000, 1000, (D, G)).astype(dt)
        np.testing.assert_array_equal(
            mk.mesh_merge_plain(torch.from_numpy(x), "min").numpy(),
            x.min(0))
        np.testing.assert_array_equal(
            mk.mesh_merge_plain(torch.from_numpy(x), "max").numpy(),
            x.max(0))
    got = mk.mesh_merge_plain(torch.from_numpy(f), "max").numpy()
    assert np.isnan(got[7]) and not np.isnan(got[8])  # NaN propagates
    rows = rng.integers(0, 50, (D, G, 10)).astype(np.int64)
    got = mk.mesh_merge_plain(torch.from_numpy(rows), "udd").numpy()
    np.testing.assert_array_equal(got[:, :8], rows[:, :, :8].sum(0))
    np.testing.assert_array_equal(got[:, 8], rows[:, :, 8].min(0))
    np.testing.assert_array_equal(got[:, 9], rows[:, :, 9].max(0))


@pytest.mark.parametrize("last", [True, False])
def test_mesh_pick_plain_matches_numpy(last):
    rng = np.random.default_rng(8)
    D, G = 6, 400
    ts = rng.integers(0, 4, (D, G)).astype(np.int64)  # many ties
    has = rng.random((D, G)) < 0.7
    vals = rng.normal(0, 1, (D, G))
    g_ts, got = mk.mesh_pick_plain(torch.from_numpy(ts),
                                   torch.from_numpy(has),
                                   torch.from_numpy(vals), last)
    for g in range(G):
        h = np.nonzero(has[:, g])[0]
        if not len(h):
            assert got[g] == -np.inf
            continue
        ext = ts[h, g].max() if last else ts[h, g].min()
        assert g_ts[g] == ext
        assert got[g] == vals[h[ts[h, g] == ext], g].max()


# ---------------------------------------------------------------------------
# the reference's SQL-level mesh tests, on the port's db
# ---------------------------------------------------------------------------

class TestMeshRowSqlOnPort(tp.TestMeshRowSql):
    """tests/test_parallel.py::TestMeshRowSql on the port's db with a mesh
    of 8 CPU shards."""

    @pytest.fixture
    def irregular_db(self, tmp_path, monkeypatch):
        monkeypatch.setenv("GREPTIME_MESH_MIN_ROWS", "100")
        db = GreptimeDB(str(tmp_path / "ir"), device="cpu")
        db.mesh = CPU8
        db.sql("CREATE TABLE m (host STRING, ts TIMESTAMP(3) TIME INDEX, "
               "v DOUBLE, PRIMARY KEY (host))")
        t0 = 1700000000000
        jit = np.random.default_rng(7).integers(0, 91, 6000)
        rows = [f"('h{i % 11}',{t0 + i * 137 + int(jit[i])},{(i * 7) % 103})"
                for i in range(6000)]
        db.sql("INSERT INTO m VALUES " + ",".join(rows))
        db._region_of("m").flush()
        yield db
        db.close()

    def _mesh_vs_single(self, db, sql):
        import os

        sel = parse_sql(sql)[0]
        metrics = {}
        r_mesh = db.engine.execute_select(sel, metrics)
        assert "grid" not in metrics
        assert metrics.get("mesh_rows") is True, metrics
        os.environ["GREPTIME_MESH"] = "off"
        try:
            r_ref = db.engine.execute_select(sel)
        finally:
            os.environ.pop("GREPTIME_MESH", None)
        assert r_mesh.column_names == r_ref.column_names
        return r_mesh, r_ref

    def test_small_table_stays_single_device(self, tmp_path):
        db = GreptimeDB(str(tmp_path / "sm"), device="cpu")
        db.mesh = CPU8
        db.sql("CREATE TABLE s (host STRING, ts TIMESTAMP(3) TIME INDEX, "
               "v DOUBLE, PRIMARY KEY (host))")
        db.sql("INSERT INTO s VALUES ('a', 1001, 1.0), ('b', 2003, 2.0)")
        metrics = {}
        db.engine.execute_select(
            parse_sql("SELECT host, sum(v) FROM s GROUP BY host")[0],
            metrics)
        assert "mesh_rows" not in metrics  # below GREPTIME_MESH_MIN_ROWS
        db.close()


class TestUnifiedSplitOnMeshOnPort(tp.TestUnifiedSplitOnMesh):
    """tests/test_parallel.py::TestUnifiedSplitOnMesh on the port: the
    same split drives the port's executor over 8 CPU shards; the db itself
    has no mesh, so ``db.sql`` answers on one device."""

    @pytest.fixture
    def db8(self, tmp_path):
        db = GreptimeDB(str(tmp_path / "u"), device="cpu")
        db.sql("CREATE TABLE cpu (host STRING, dc STRING, ts TIMESTAMP(3) "
               "TIME INDEX, u DOUBLE, PRIMARY KEY (host, dc))")
        t0 = 1700000000000
        rows = [f"('h{i % 8}','dc{i % 3}',{t0 + (i // 24) * 5000},"
                f"{(i * 13) % 101})" for i in range(4800)]
        db.sql("INSERT INTO cpu VALUES " + ",".join(rows))
        db._region_of("cpu").flush()
        yield db
        db.close()

    def _run(self, db, sql):
        region = db._table_view("cpu")
        table = shard_region(region, CPU8)
        res = execute_select_on_mesh(
            DistAggExecutor(CPU8), table, parse_sql(sql)[0],
            db.table_context("cpu"), region.ts_bounds())
        assert res is not None, f"not mesh-decomposable: {sql}"
        return res


# ---------------------------------------------------------------------------
# routing, knobs and refusals
# ---------------------------------------------------------------------------

@pytest.fixture
def mdb(tmp_path, monkeypatch):
    monkeypatch.setenv("GREPTIME_MESH_MIN_ROWS", "100")
    db = GreptimeDB(str(tmp_path / "k"), device="cpu")
    db.mesh = CPU8
    db.sql("CREATE TABLE m (host STRING, ts TIMESTAMP(3) TIME INDEX, "
           "v DOUBLE, PRIMARY KEY (host))")
    # jittered cadence: the dense grid refuses the table
    rows = [f"('h{i % 7}',{T0 + i * 1_013 + i * i % 97},{i % 41})"
            for i in range(5000)]
    db.sql("INSERT INTO m VALUES " + ",".join(rows))
    yield db
    db.close()


def _route(db, sql):
    metrics = {}
    res = db.engine.execute_select(parse_sql(sql)[0], metrics)
    return res, metrics.get("mesh_rows", False)


def test_mesh_off_is_read_at_query_time(mdb, monkeypatch):
    sql = "SELECT host, sum(v), count(*) FROM m GROUP BY host ORDER BY host"
    on, routed = _route(mdb, sql)
    assert routed
    monkeypatch.setenv("GREPTIME_MESH", "off")
    off, routed = _route(mdb, sql)
    assert not routed and off.rows == on.rows


def test_mesh_min_rows(mdb, monkeypatch):
    sql = "SELECT max(v) FROM m"
    monkeypatch.setenv("GREPTIME_MESH_MIN_ROWS", "5001")
    assert not _route(mdb, sql)[1]
    monkeypatch.setenv("GREPTIME_MESH_MIN_ROWS", "5000")
    assert _route(mdb, sql)[1]


def test_mesh_forms_only_when_installed(monkeypatch):
    # several cards in view: still no mesh until one is assigned
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    db = GreptimeDB(device="cpu")
    try:
        assert db.mesh is None and db.cache.mesh is None
        db.mesh = CPU8
        assert db.mesh == CPU8 and db.cache.mesh == CPU8
        db.mesh = None
        assert db.cache.mesh is None
    finally:
        db.close()


def test_mesh_assignment_drops_the_sharded_tables(mdb):
    _route(mdb, "SELECT max(v) FROM m")
    assert any(k[1] == "sharded" for k in mdb.cache._lru)
    mdb.mesh = None
    assert not any(k[1] == "sharded" for k in mdb.cache._lru)
    assert not _route(mdb, "SELECT max(v) FROM m")[1]


def test_where_plan_keys_on_the_dictionary_version(mdb):
    sql = "SELECT count(*), sum(v) FROM m WHERE host = 'hz'"
    res, routed = _route(mdb, sql)
    assert routed and res.rows == [[0, None]]
    mdb.sql("INSERT INTO m VALUES " + ",".join(
        f"('hz',{T0 + 7 + i * 1_013},{i})" for i in range(10)))
    res, routed = _route(mdb, sql)
    assert routed and res.rows == [[10, 45.0]]


@pytest.mark.parametrize("sql", [
    # GROUP BY the raw time index: a bucket a millisecond, past DENSE_LIMIT
    "SELECT ts, count(*) FROM m GROUP BY ts",
    # OFFSET: split_partial refuses it
    "SELECT host, sum(v) FROM m GROUP BY host ORDER BY host LIMIT 3 OFFSET 2",
])
def test_refused_queries_take_the_row_path(mdb, sql, monkeypatch):
    res, routed = _route(mdb, sql)
    assert not routed
    monkeypatch.setenv("GREPTIME_MESH", "off")
    assert res.rows == _route(mdb, sql)[0].rows


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_mesh_merge_matches_plain(cuda_device):
    mk.reset_launch_counts()
    rng = np.random.default_rng(9)
    D, G = 4, 48_000
    cases = [
        (rng.normal(0, 1e4, (D, G, 10)).astype(np.float32), "sum"),
        (rng.integers(-(1 << 60), 1 << 60, (D, G)), "sum"),
        (rng.normal(0, 1, (D, G)).astype(np.float32), "min"),
        (rng.normal(0, 1, (D, G)).astype(np.float32), "max"),
        (rng.normal(0, 1, (D, G)), "max"),
        (rng.integers(-(1 << 62), 1 << 62, (D, G)), "min"),
        (rng.integers(-(1 << 62), 1 << 62, (D, G)), "max"),
        (rng.integers(0, 40, (D, 300, 4096)).astype(np.int32), "max"),
        (rng.integers(0, 1000, (D, 700, 130)), "udd"),
    ]
    for x, op in cases:
        x = x.copy()
        if x.dtype.kind == "f":
            x.reshape(-1)[::997] = np.nan
        t = torch.from_numpy(x)
        want = mk.mesh_merge_plain(t, op)
        got = mk.mesh_merge(t.to(cuda_device), op)
        assert torch.equal(got.cpu().nan_to_num(-7.0),
                           want.nan_to_num(-7.0)), (x.dtype, op)
    ts = torch.from_numpy(rng.integers(0, 4, (D, G)))
    has = torch.from_numpy(rng.random((D, G)) < 0.8)
    for vals in (rng.normal(0, 1, (D, G)), rng.normal(0, 1, (D, G)).astype(
            np.float32), rng.integers(-99, 99, (D, G))):
        v = torch.from_numpy(vals)
        for last in (True, False):
            w_ts, w = mk.mesh_pick_plain(ts, has, v, last)
            g_ts, g = mk.mesh_pick(ts.to(cuda_device), has.to(cuda_device),
                                   v.to(cuda_device), last)
            assert torch.equal(g_ts.cpu(), w_ts) and torch.equal(g.cpu(), w)
    torch.cuda.synchronize()
    assert mk.mesh_merge.launches == len(cases) + 6


@pytest.mark.cuda
def test_cuda_local_phase_matches_cpu_mesh(cuda_device):
    data = make_columns(6)
    gpu4 = create_mesh(4, device=cuda_device)
    cpu4 = create_mesh(4, device="cpu")
    kw = dict(ts_column="ts", where_fn=lambda env: env["d"] > 10,
              where_cols=("d",), where_key="d>10",
              time_range=(T0, T0 + 4 * HOUR))
    mk.reset_launch_counts()
    got = DistAggExecutor(gpu4).aggregate(shard_table(data, gpu4), KEYS,
                                          ALL_OPS, **kw)
    want = DistAggExecutor(cpu4).aggregate(shard_table(data, cpu4), KEYS,
                                           ALL_OPS, **kw)
    torch.cuda.synchronize()
    assert mk.mesh_merge.launches > 0
    for name in want:
        assert_same(got[name], want[name], float_sum=name in FLOAT_SUMS)


@pytest.mark.cuda
def test_cuda_local_phase_on_every_card(cuda_device):
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs a host with several CUDA cards")
    data = make_columns(7)
    # two shards on each card, interleaved, and the last card current: the
    # wrappers' launches must follow each shard group's card
    mesh = create_mesh(cards) * 2
    cpu = create_mesh(len(mesh), device="cpu")
    kw = dict(ts_column="ts", where_fn=lambda env: env["d"] > 10,
              where_cols=("d",), where_key="d>10",
              time_range=(T0, T0 + 4 * HOUR))
    mk.reset_launch_counts()
    with torch.cuda.device(cards - 1):
        got = DistAggExecutor(mesh).aggregate(shard_table(data, mesh), KEYS,
                                              ALL_OPS, **kw)
    want = DistAggExecutor(cpu).aggregate(shard_table(data, cpu), KEYS,
                                          ALL_OPS, **kw)
    for dev in range(cards):
        torch.cuda.synchronize(dev)
    assert mk.mesh_merge.launches > 0
    for name in want:
        assert_same(got[name], want[name], float_sum=name in FLOAT_SUMS)
