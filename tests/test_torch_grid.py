"""Port parity: the resident dense grid.

Each package writes its own data home from the same numpy rows (region
write, Parquet flush, memtable tail, NaN values, tombstones); the port's
``build_grid_table`` must give the reference's values, validity, tag
codes, ``no_nan`` flags and geometry exactly.  ``grid_from_numpy`` must
round-trip the reference's resident grid.
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu.storage.grid import build_grid_table as ref_build
from greptimedb_tpu_torch.standalone import GreptimeDB
from greptimedb_tpu_torch.storage.cache import RegionCacheManager
from greptimedb_tpu_torch.storage.grid import (
    _S_ALIGN, _T_ALIGN, _pad_to, build_grid_table, grid_from_numpy,
)

T0 = 1_451_606_400_000
STEP = 10_000
FIELDS = ("a", "b", "c")
DDL = ("CREATE TABLE cpu (hostname STRING, dc STRING, "
       "ts TIMESTAMP(3) TIME INDEX, a DOUBLE, b DOUBLE, c DOUBLE, "
       "PRIMARY KEY (hostname, dc))")


def _rows(seed, hosts=16, steps=360, t_off=0, nan=False, every=1):
    rng = np.random.default_rng(seed)
    ts = T0 + (t_off + np.repeat(np.arange(0, steps, every), hosts)) * STEP
    n = len(ts)
    data = {
        "hostname": np.tile(np.array([f"host_{i}" for i in range(hosts)],
                                     dtype=object), n // hosts),
        "dc": np.tile(np.array([f"dc_{i % 3}" for i in range(hosts)],
                               dtype=object), n // hosts),
        "ts": ts,
    }
    for f in FIELDS:
        data[f] = rng.uniform(0, 100, n)
    if nan:
        data["b"][rng.random(n) < 0.02] = np.nan
    return data


def _write(db, batches):
    db.sql(DDL)
    region = db._region_of("cpu")
    for kind, data in batches:
        if kind == "delete":
            region.delete(data)
        else:
            region.write(data)
        if kind == "flush":
            region.flush()
    return region


CASES = {
    "flushed": [("flush", _rows(1)), ("flush", _rows(2, t_off=360))],
    "memtable": [("write", _rows(3))],
    "flush_then_tail": [("flush", _rows(4)), ("write", _rows(5, t_off=360))],
    "nan_values": [("flush", _rows(6, nan=True)),
                   ("write", _rows(7, t_off=360, nan=True))],
    "sparse_hosts": [("flush", _rows(8, hosts=16)),
                     ("write", _rows(9, hosts=20, t_off=360, every=2))],
    "tombstones": [("flush", _rows(10)),
                   ("delete", {k: v[:40] for k, v in _rows(10).items()})],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_grid_table_matches_reference(case, tmp_path):
    ref_db = RefDB(str(tmp_path / "ref"))
    port_db = GreptimeDB(str(tmp_path / "port"), device="cpu")
    try:
        ref_region = _write(ref_db, CASES[case])
        port_region = _write(port_db, CASES[case])
        want = ref_build(ref_region)
        got = build_grid_table(port_region, device="cpu")
        assert want is not None and got is not None
        assert got.values.dtype == torch.float32
        assert got.valid.dtype == torch.bool
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        assert sorted(got.tag_codes) == sorted(want.tag_codes)
        for k, v in want.tag_codes.items():
            assert got.tag_codes[k].dtype == torch.int32
            np.testing.assert_array_equal(got.tag_codes[k].numpy(),
                                          np.asarray(v))
        for attr in ("ts0", "step", "nt", "num_series", "field_names",
                     "no_nan", "dicts", "spad", "tpad", "region_id"):
            assert getattr(got, attr) == getattr(want, attr), attr
    finally:
        ref_db.close()
        port_db.close()


def test_irregular_region_is_refused_like_reference(tmp_path):
    rows = _rows(11, steps=40)
    rows["ts"] = rows["ts"] + np.random.default_rng(0).integers(
        0, 997, len(rows["ts"])) * 7  # no common step: too sparse a grid
    ref_db = RefDB(str(tmp_path / "ref"))
    port_db = GreptimeDB(str(tmp_path / "port"), device="cpu")
    try:
        want = ref_build(_write(ref_db, [("write", rows)]))
        got = build_grid_table(_write(port_db, [("write", rows)]),
                               device="cpu")
        assert want is None and got is None
    finally:
        ref_db.close()
        port_db.close()


def test_grid_from_numpy_round_trips_reference_grid(tmp_path):
    ref_db = RefDB(str(tmp_path / "ref"))
    try:
        region = _write(ref_db, CASES["nan_values"])
        ref = ref_build(region)
        got = grid_from_numpy(
            np.asarray(ref.values), np.asarray(ref.valid),
            {k: np.asarray(v) for k, v in ref.tag_codes.items()},
            ts0=ref.ts0, step=ref.step, nt=ref.nt,
            num_series=ref.num_series, field_names=ref.field_names,
            dicts=ref.dicts, no_nan=ref.no_nan, device="cpu",
            region_id=ref.region_id)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(ref.values))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(ref.valid))
        for k, v in ref.tag_codes.items():
            np.testing.assert_array_equal(got.tag_codes[k].numpy(),
                                          np.asarray(v))
        assert (got.ts0, got.step, got.nt, got.num_series) == (
            ref.ts0, ref.step, ref.nt, ref.num_series)
        assert got.no_nan == ref.no_nan and got.dicts == ref.dicts
        assert got.nbytes() == ref.nbytes()
        with pytest.raises(ValueError):
            grid_from_numpy(np.zeros((2, 4, 8)), np.zeros((4, 9), bool), {},
                            ts0=0, step=1, nt=1, num_series=1,
                            field_names=("x", "y"), dicts={}, no_nan=(),
                            device="cpu")
    finally:
        ref_db.close()


@pytest.mark.parametrize("n,align", [(0, _S_ALIGN), (50, _S_ALIGN),
                                     (4000, _S_ALIGN), (8640, _T_ALIGN),
                                     (2048, _T_ALIGN)])
def test_padding_classes(n, align):
    from greptimedb_tpu.storage.grid import _pad_to as ref_pad

    assert _pad_to(n, align) == ref_pad(n, align)


def test_cache_rebuilds_after_write(tmp_path):
    """The port has no in-place grid extension: a write moves the
    region's append position and the next get_grid rebuilds."""
    port_db = GreptimeDB(str(tmp_path / "port"), device="cpu")
    try:
        region = _write(port_db, [("write", _rows(12))])
        cache = RegionCacheManager(device="cpu")
        g1 = cache.get_grid(region)
        assert cache.get_grid(region) is g1 and cache.hits == 1
        region.write(_rows(13, t_off=360))
        g2 = cache.get_grid(region)
        assert g2 is not g1 and g2.nt == 720 and cache.misses == 2
        assert g2.dicts_version > g1.dicts_version
    finally:
        port_db.close()


def test_installed_reference_grid_serves_port_queries(tmp_path):
    """State carried across: the reference's resident grid, taken with
    np.asarray and installed into the port's cache, answers the port's
    SQL exactly as the reference answers it."""
    ref_db = RefDB(str(tmp_path / "ref"))
    port_db = GreptimeDB(str(tmp_path / "port"), device="cpu")
    sql = (f"SELECT hostname, date_trunc('hour', ts) AS hour, avg(a), "
           f"max(c) FROM cpu WHERE ts >= {T0} AND ts < {T0 + 7_200_000} "
           f"GROUP BY hostname, hour")
    try:
        _write(ref_db, CASES["flushed"])
        port_region = _write(port_db, CASES["flushed"])
        ref = ref_db.cache.get_grid(ref_db._region_of("cpu"))
        installed = grid_from_numpy(
            np.asarray(ref.values), np.asarray(ref.valid),
            {k: np.asarray(v) for k, v in ref.tag_codes.items()},
            ts0=ref.ts0, step=ref.step, nt=ref.nt,
            num_series=ref.num_series, field_names=ref.field_names,
            dicts=ref.dicts, no_nan=ref.no_nan, device="cpu",
            region_id=port_region.region_id)
        port_db.cache.install_grid(port_region, installed)
        assert port_db.cache.get_grid(port_region) is installed
        want = ref_db.sql(sql).rows
        got = port_db.sql(sql).rows
        assert len(got) == len(want) == 32
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            for a, b in zip(g[2:], w[2:]):
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
    finally:
        ref_db.close()
        port_db.close()
