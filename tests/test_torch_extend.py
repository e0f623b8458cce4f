"""Port parity of the write-then-query path: resident tables extended in
place of a rebuild.

The JAX reference and the port run the same writes on the CPU, each into
its own data home, and their resident state is compared exactly:

- the reference's ``TestIncrementalDeviceCache`` and
  ``test_cache_hit_and_invalidation`` (``tests/test_storage.py``) on both
  packages side by side: order, bucket growth, a large delta rebuilds, a
  delete and a flush rebuild (a new lineage), within-batch duplicates, SQL
  and PromQL over an extended table, the grid and table entries side by
  side; first/last ties after an extend that adds series;
- the protocol's races on the port: a chunk landing mid-extend is applied
  once, a build raced by a write is served uncached, an entry evicted
  mid-extend is not resurrected and the byte accounting holds;
- after a chain of extends (one growing the padding bucket, one adding
  series) every DeviceTable column, the row mask, ``sorted_tags``,
  ``dicts`` and the ``dicts_root`` lineage equal the reference's;
- ``extend_merge_plain`` (and the merge arithmetic of the K23 kernel,
  emulated here with torch) equal ``jnp.lexsort`` plus a gather on random
  tables with pad rows, a 0-row delta, a delta of new series only and keys
  that need the two-pass sort;
- ``extend_grid_table``, ``catch_up_grid_table`` (deletes, several parts,
  time-axis growth) and ``extend_hot_tail`` equal the reference's
  GridTable: values, valid, tag codes, nt, tpad, no_nan;
- grid snapshots cross-load between the packages, and a changed region or
  dictionary refuses them; the manifest's rename fsyncs its directory;
- a LogQL query after a push extends the fingerprint matrix by the
  vocabulary tail only.

Cells, codes and masks compare exactly; SQL and PromQL rows within the
golden rule ``1e-5*max(1,|b|)``.  The kernels themselves run on the card
only (``tests/test_torch_storage_kernels.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import greptimedb_tpu.datatypes as RT
import greptimedb_tpu_torch.datatypes as PT
from greptimedb_tpu.servers.http import _ingest_columns as ref_ingest
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu.storage import RegionEngine as RefEngine
from greptimedb_tpu.storage import cache as rcache
from greptimedb_tpu.storage import grid as rgrid
from greptimedb_tpu.utils.telemetry import REGISTRY as RREG
from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.ops import storage_kernels as stk
from greptimedb_tpu_torch.servers.ingest import ingest_columns, loki_push
from greptimedb_tpu_torch.standalone import GreptimeDB
from greptimedb_tpu_torch.storage import RegionEngine as PortEngine
from greptimedb_tpu_torch.storage import cache as pcache
from greptimedb_tpu_torch.storage import grid as pgrid
from greptimedb_tpu_torch.storage.memtable import TSID
from greptimedb_tpu_torch.utils.telemetry import REGISTRY as PREG


def _schema(mod):
    T, S = mod.ConcreteDataType, mod.SemanticType
    return mod.Schema((
        mod.ColumnSchema("hostname", T.STRING, S.TAG),
        mod.ColumnSchema("region", T.STRING, S.TAG),
        mod.ColumnSchema("ts", T.TIMESTAMP_MILLISECOND, S.TIMESTAMP),
        mod.ColumnSchema("usage_user", T.FLOAT64, S.FIELD),
        mod.ColumnSchema("usage_system", T.FLOAT64, S.FIELD),
    ))


def write_rows(region, n=10, t0=0, host_prefix="h", hosts=3):
    """tests/test_storage.py's write_rows, with the host count a knob."""
    region.write({
        "hostname": [f"{host_prefix}{i % hosts}" for i in range(n)],
        "region": ["us-west" if i % 2 else "us-east" for i in range(n)],
        "ts": [t0 + i * 1000 for i in range(n)],
        "usage_user": [float(i) for i in range(n)],
        "usage_system": [float(i) * 2 for i in range(n)],
    })


class _Pair:
    """One region with the same writes in each package, each with its own
    cache manager."""

    def __init__(self, tmp_path):
        self.ref_eng = RefEngine(str(tmp_path / "ref"))
        self.port_eng = PortEngine(str(tmp_path / "port"))
        self.ref = self.ref_eng.create_region(1, _schema(RT))
        self.port = self.port_eng.create_region(1, _schema(PT))
        self.rmgr = rcache.RegionCacheManager()
        self.pmgr = pcache.RegionCacheManager(device="cpu")

    def both(self, fn, *args, **kw):
        return fn(self.ref, *args, **kw), fn(self.port, *args, **kw)

    def get(self):
        return self.rmgr.get(self.ref), self.pmgr.get(self.port)

    def counters(self):
        r, p = self.rmgr, self.pmgr
        assert (r.hits, r.misses, r.extends) == (p.hits, p.misses, p.extends)
        return p.hits, p.misses, p.extends

    def close(self):
        self.ref_eng.close()
        self.port_eng.close()


@pytest.fixture
def pair(tmp_path):
    p = _Pair(tmp_path)
    yield p
    p.close()


def assert_tables_equal(ref, port):
    """Every column and the row mask exactly, and the metadata."""
    assert sorted(ref.columns) == sorted(port.columns)
    for k in ref.columns:
        np.testing.assert_array_equal(port.columns[k].numpy(),
                                      np.asarray(ref.columns[k]), err_msg=k)
        assert port.columns[k].numpy().dtype == np.asarray(
            ref.columns[k]).dtype, k
    np.testing.assert_array_equal(port.row_mask.numpy(),
                                  np.asarray(ref.row_mask))
    assert port.num_series == ref.num_series
    assert tuple(port.sorted_tags) == tuple(ref.sorted_tags)
    assert {k: list(v) for k, v in port.dicts.items()} == {
        k: list(v) for k, v in ref.dicts.items()}


def _live(table, col):
    mask = np.asarray(table.row_mask) if not isinstance(
        table.row_mask, torch.Tensor) else table.row_mask.numpy()
    vals = table.columns[col]
    vals = vals.numpy() if isinstance(vals, torch.Tensor) else np.asarray(
        vals)
    return vals[mask]


# ---------------------------------------------------------------------------
# the reference's cache tests, on both packages
# ---------------------------------------------------------------------------

def test_cache_hit_and_invalidation(pair):
    pair.both(write_rows, 10)
    r1, p1 = pair.get()
    r2, p2 = pair.get()
    assert r1 is r2 and p1 is p2 and pair.counters() == (1, 1, 0)
    # a time-forward append EXTENDS the resident table (no rebuild)
    pair.both(write_rows, 1, t0=999_000)
    r3, p3 = pair.get()
    assert p3 is not p1 and pair.counters() == (1, 1, 1)
    assert int(p3.row_mask.sum()) == 11
    assert_tables_equal(r3, p3)
    # an upsert of an existing key is a structure change -> rebuild
    pair.both(write_rows, 1, t0=0)
    r4, p4 = pair.get()
    assert pair.counters() == (1, 2, 1)
    assert int(p4.row_mask.sum()) == 11  # deduped
    assert_tables_equal(r4, p4)


def test_extend_correctness_and_order(pair):
    pair.both(write_rows, 10)
    _r1, p1 = pair.get()
    base_padded = p1.padded_rows
    for i in range(5):
        pair.both(write_rows, 3, t0=1_000_000 * (i + 1))
    r2, p2 = pair.get()
    assert pair.counters() == (0, 1, 1)
    mask = p2.row_mask.numpy()
    key = (_live(p2, TSID).astype(np.int64) << 44) + _live(p2, "ts")
    assert (np.diff(key) >= 0).all() and mask.sum() == 25
    assert not mask[25:].any()  # pad rows last
    fresh = pcache.build_device_table(pair.port, device="cpu")
    for col in ("ts", "usage_user", TSID, "hostname"):
        np.testing.assert_array_equal(_live(p2, col), _live(fresh, col))
    assert base_padded <= p2.padded_rows
    assert_tables_equal(r2, p2)


def test_extend_grows_bucket(pair):
    pair.both(write_rows, 120)
    _r1, p1 = pair.get()
    assert p1.padded_rows == 128
    pair.both(write_rows, 20, t0=10_000_000)
    r2, p2 = pair.get()
    assert pair.counters() == (0, 1, 1)
    assert p2.padded_rows == 256 == int(np.asarray(r2.row_mask).shape[0])
    assert int(p2.row_mask.sum()) == 140
    assert_tables_equal(r2, p2)


def test_large_delta_triggers_rebuild(pair):
    pair.both(write_rows, 10)
    pair.rmgr.min_extend_rows = pair.pmgr.min_extend_rows = 0
    pair.get()
    pair.both(write_rows, 50, t0=10_000_000)  # 5x the resident rows
    r, p = pair.get()
    assert pair.counters() == (0, 2, 0)
    assert_tables_equal(r, p)


def test_delete_and_flush_force_rebuild(pair):
    pair.both(write_rows, 6)
    _r0, p0 = pair.get()
    pair.both(lambda r: r.delete({"hostname": ["h1"], "region": ["us-west"],
                                  "ts": [1000]}))
    r, p = pair.get()
    assert pair.counters() == (0, 2, 0)  # tombstone -> rebuild
    assert int(p.row_mask.sum()) == 5
    assert_tables_equal(r, p)
    # a rebuild starts a new fingerprint lineage
    assert p.dicts_root == p.dicts_version != p0.dicts_root
    pair.both(write_rows, 2, t0=5_000_000)
    pair.both(lambda r: r.flush())
    r, p = pair.get()
    assert pair.counters() == (0, 3, 0)  # a flush is a structure change
    assert_tables_equal(r, p)


def test_within_batch_duplicates_not_appendable(pair):
    pair.both(write_rows, 4)
    pair.get()
    pair.both(lambda r: r.write({
        "hostname": ["h0", "h0"], "region": ["us-east"] * 2,
        "ts": [900_000, 900_000], "usage_user": [5.0, 7.0],
        "usage_system": [0.0, 0.0]}))
    r, p = pair.get()
    assert pair.counters() == (0, 2, 0)
    assert int(p.row_mask.sum()) == 5  # deduped keep-last
    uu = _live(p, "usage_user")
    assert 7.0 in uu and 5.0 not in uu
    assert_tables_equal(r, p)


def test_delta_pos_counts_the_chunks_applied(pair, monkeypatch):
    """A chunk that lands between the cache's position read and its fetch
    of the chunks is applied once: the entry records the chunks it
    applied, so the next get is a hit and no row is doubled."""
    pair.both(write_rows, 10)
    pair.pmgr.get(pair.port)
    write_rows(pair.port, 3, t0=1_000_000)
    fetch = pair.port.append_chunks_since

    def racing_fetch(pos):
        monkeypatch.setattr(pair.port, "append_chunks_since", fetch)
        write_rows(pair.port, 3, t0=2_000_000)  # lands mid-extend
        return fetch(pos)

    monkeypatch.setattr(pair.port, "append_chunks_since", racing_fetch)
    t = pair.pmgr.get(pair.port)
    assert pair.pmgr.extends == 1 and int(t.row_mask.sum()) == 16
    assert pair.pmgr.get(pair.port) is t and pair.pmgr.hits == 1
    fresh = pcache.build_device_table(pair.port, device="cpu")
    for col in ("ts", TSID, "usage_user"):
        np.testing.assert_array_equal(_live(t, col), _live(fresh, col))


def test_build_raced_by_a_write_is_served_uncached(pair, monkeypatch):
    """A chunk that lands while the table builds may or may not be in it:
    the table is served, not cached at the old position."""
    pair.both(write_rows, 10)
    build = pcache.build_device_table

    def racing_build(region, device):
        table = build(region, device=device)
        write_rows(region, 3, t0=1_000_000)
        return table

    monkeypatch.setattr(pcache, "build_device_table", racing_build)
    t = pair.pmgr.get(pair.port)
    assert int(t.row_mask.sum()) == 10
    assert not any(k[1] == "table" for k in pair.pmgr._lru)
    assert pair.pmgr._bytes == 0
    monkeypatch.setattr(pcache, "build_device_table", build)
    t = pair.pmgr.get(pair.port)
    assert int(t.row_mask.sum()) == 13 and pair.pmgr.misses == 2


def test_swap_keeps_the_byte_accounting(pair, monkeypatch):
    """An entry evicted while its extend runs is not resurrected, and the
    bytes move only when a swap applies."""
    pair.both(write_rows, 10)
    pair.pmgr.get(pair.port)
    key = next(k for k in pair.pmgr._lru if k[1] == "table")
    write_rows(pair.port, 3, t0=1_000_000)
    extend = pcache.extend_device_table

    def evicting_extend(*args):
        pair.pmgr._evict(key)  # a concurrent eviction
        return extend(*args)

    monkeypatch.setattr(pcache, "extend_device_table", evicting_extend)
    t = pair.pmgr.get(pair.port)
    assert int(t.row_mask.sum()) == 13 and pair.pmgr.extends == 1
    assert key not in pair.pmgr._lru and pair.pmgr._bytes == 0
    assert pair.pmgr._bytes == sum(e.table.nbytes()
                                   for e in pair.pmgr._lru.values()
                                   if e.table is not None)


def test_first_last_ties_after_extend(tmp_path, monkeypatch):
    """tsid order shows through first/last tie-breaks on equal timestamps:
    after an extend that adds series, the row path answers as the
    reference does."""
    monkeypatch.setenv("GREPTIME_GRID", "off")
    ref = RefDB(str(tmp_path / "ref"))
    port = GreptimeDB(str(tmp_path / "port"), device="cpu")
    q = ("SELECT dc, first_value(v), last_value(v), count(*) FROM t "
         "GROUP BY dc ORDER BY dc")
    try:
        for db in (ref, port):
            db.sql("CREATE TABLE t (host STRING, dc STRING, ts TIMESTAMP(3) "
                   "TIME INDEX, v DOUBLE, PRIMARY KEY (host, dc))")
            db.sql("INSERT INTO t VALUES ('b', 'x', 1000, 1.0), "
                   "('a', 'x', 1000, 2.0), ('c', 'y', 1000, 3.0), "
                   "('a', 'x', 2000, 4.0), ('b', 'x', 2000, 5.0)")
            assert db.sql(q).rows
            db.sql("INSERT INTO t VALUES ('d', 'x', 3000, 6.0), "
                   "('a', 'x', 3000, 7.0), ('e', 'y', 3000, 8.0), "
                   "('c', 'y', 3000, 9.0)")
        assert port.sql(q).rows == ref.sql(q).rows
        assert port.cache.extends == ref.cache.extends == 1
    finally:
        ref.close()
        port.close()


def test_table_and_grid_entries_coexist(pair):
    """The port keys one full-table entry a region (no restricted scans):
    its grid entry must not evict it, and both extend after an append."""
    pair.both(write_rows, 12, hosts=3)
    pair.get()
    assert pair.pmgr.get_grid(pair.port) is not None
    assert pair.rmgr.get_grid(pair.ref) is not None
    pair.get()  # still a hit
    assert pair.counters() == (1, 2, 0)
    pair.both(write_rows, 3, t0=12_000, hosts=3)
    r, p = pair.get()
    assert pair.counters() == (1, 2, 1)
    assert_tables_equal(r, p)
    pair.pmgr.get_grid(pair.port)
    pair.rmgr.get_grid(pair.ref)
    assert pair.counters() == (1, 2, 2)


def _golden_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("grid", ["on", "off"])
def test_sql_query_over_extended_table(tmp_path, monkeypatch, grid):
    monkeypatch.setenv("GREPTIME_GRID", grid)
    ref = RefDB(str(tmp_path / "ref"))
    port = GreptimeDB(str(tmp_path / "port"), device="cpu")
    try:
        for db in (ref, port):
            db.sql("CREATE TABLE inc (host STRING, ts TIMESTAMP(3) TIME "
                   "INDEX, v DOUBLE, PRIMARY KEY (host))")
            db.sql("INSERT INTO inc VALUES ('a', 1000, 1.0), "
                   "('b', 2000, 2.0)")
            assert db.sql("SELECT sum(v) FROM inc").rows == [[3.0]]
            db.sql("INSERT INTO inc VALUES ('a', 3000, 10.0), "
                   "('c', 4000, 4.0)")
        for q in ("SELECT sum(v), count(*) FROM inc",
                  "SELECT host, sum(v) FROM inc GROUP BY host ORDER BY host"):
            _golden_rows(port.sql(q).rows, ref.sql(q).rows)
        assert port.sql("SELECT sum(v), count(*) FROM inc").rows == [
            [17.0, 4]]
        assert port.cache.extends >= 1
        assert port.cache.extends == ref.cache.extends
    finally:
        ref.close()
        port.close()


def test_promql_over_extended_table(tmp_path):
    """PromQL's windows rely on (tsid, ts) order: after the extend, the
    sort layout's presorted route must still apply."""
    from greptimedb_tpu.promql.engine import PromEvaluator as RefEval
    from greptimedb_tpu.promql.parser import parse_promql as ref_parse
    from greptimedb_tpu_torch.ops import promql_kernels as pk
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import parse_promql

    ref = RefDB(str(tmp_path / "ref"))
    port = GreptimeDB(str(tmp_path / "port"), device="cpu")
    try:
        regions = []
        for db in (ref, port):
            db.sql("CREATE TABLE pm (pod STRING, ts TIMESTAMP(3) TIME "
                   "INDEX, greptime_value DOUBLE, PRIMARY KEY (pod))")
            r = db._region_of("pm")
            r.write({"pod": ["x", "y"] * 4,
                     "ts": [i * 15000 for i in range(4) for _ in (0, 1)],
                     "greptime_value": [float(i) for i in range(8)]})
            regions.append(r)
        assert RefEval(ref, 45.0, 45.0, 1.0).eval(
            ref_parse("pm")).num_series == 2
        assert PromEvaluator(port, 45.0, 45.0, 1.0).eval(
            parse_promql("pm")).num_series == 2
        for r in regions:
            r.write({"pod": ["x", "y", "z"], "ts": [60000] * 3,
                     "greptime_value": [100.0, 200.0, 300.0]})
        for q in ("pm", "rate(pm[1m])", "sum(pm)"):
            want = RefEval(ref, 0.0, 60.0, 15.0).eval(ref_parse(q))
            got = PromEvaluator(port, 0.0, 60.0, 15.0).eval(parse_promql(q))
            wv = np.asarray(want.values)
            gv = got.values.numpy() if isinstance(
                got.values, torch.Tensor) else np.asarray(got.values)
            assert [dict(x) for x in got.labels] == [
                dict(x) for x in want.labels]
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5)
        got = PromEvaluator(port, 60.0, 60.0, 1.0).eval(parse_promql("pm"))
        vals = {dict(lab)["pod"]: float(v) for lab, v in zip(
            got.labels, np.asarray(got.values)[:, 0])}
        assert vals == {"x": 100.0, "y": 200.0, "z": 300.0}
        assert port.cache.extends >= 1
        table = port.cache.get(regions[1])
        assert pk.sort_layout_presorted_plain(
            table.columns["ts"], table.columns["greptime_value"],
            table.columns[TSID], table.row_mask)
        assert table.sorted_tags == ()  # series were added
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# a chain of extends, held to the reference's extend_device_table
# ---------------------------------------------------------------------------

CHAINS = {
    # 120 rows fill a 128-row bucket; +20 grows it to 256.  One host, so
    # the region tag is sorted (a code run a series) and stays so
    "grows_bucket": (1, [(20, 10_000_000, "h", 1)]),
    # the delta brings two new series: tsids past the old count
    "new_series": (3, [(6, 5_000_000, "n", 2)]),
    # three extends: growth, new series, then a plain append
    "chain3": (3, [(20, 10_000_000, "h", 3), (8, 20_000_000, "n", 4),
                   (5, 30_000_000, "h", 3)]),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_extend_chain_matches_reference(pair, chain):
    base_hosts, deltas = CHAINS[chain]
    pair.both(write_rows, 120, hosts=base_hosts)
    r0, p0 = pair.get()
    assert_tables_equal(r0, p0)
    for k, (n, t0, prefix, hosts) in enumerate(deltas):
        pair.both(write_rows, n, t0=t0, host_prefix=prefix, hosts=hosts)
        r, p = pair.get()
        assert pair.counters()[2] == k + 1
        assert_tables_equal(r, p)
        # the lineage: a new version, the first build's root
        assert p.dicts_version > p0.dicts_version
        assert p.dicts_root == p0.dicts_root == p0.dicts_version
        assert r.dicts_root == r0.dicts_root
    if chain == "grows_bucket":
        assert p.sorted_tags == p0.sorted_tags == ("region",)
        assert p.padded_rows == 256
    else:
        assert p.sorted_tags == ()


def test_extend_keeps_string_field_dictionaries(tmp_path):
    """String-field codes of the delta are seeded from the resident
    dictionary, so they only append."""
    ref = RefDB(str(tmp_path / "ref"))
    port = GreptimeDB(str(tmp_path / "port"), device="cpu")
    try:
        tables = []
        for db in (ref, port):
            db.sql("CREATE TABLE lg (app STRING, ts TIMESTAMP(3) TIME "
                   "INDEX, line STRING, PRIMARY KEY (app))")
            db.sql("INSERT INTO lg VALUES ('a', 1, 'x'), ('b', 2, 'y')")
            r = db._region_of("lg")
            t0 = db.cache.get(r)
            db.sql("INSERT INTO lg VALUES ('a', 3, 'z'), ('b', 4, 'x'), "
                   "('c', 5, NULL)")
            tables.append((t0, db.cache.get(r)))
            assert db.cache.extends == 1
        (_r0, r1), (p0, p1) = tables
        assert_tables_equal(r1, p1)
        assert p1.dicts["line"][:2] == p0.dicts["line"]
        assert p1.dicts_root == p0.dicts_root
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# K23: the plain version and the kernel's merge arithmetic against lexsort
# ---------------------------------------------------------------------------

PADS = {"ts": 0, TSID: 0, "v": np.nan, "code": -1, "op": 0}
DTYPES = {"ts": np.int64, TSID: np.int32, "v": np.float32,
          "code": np.int32, "op": np.int8}


def _random_table(rng, n_series, rows_per, n_old, padded):
    """A resident table: n_old live rows in (tsid, ts) order, pad rows."""
    tsid = np.sort(rng.integers(0, n_series, n_old)).astype(np.int32)
    ts = np.zeros(n_old, np.int64)
    for t in np.unique(tsid):
        sel = tsid == t
        ts[sel] = np.sort(rng.choice(rows_per * 10, sel.sum(),
                                     replace=False)) * 1000
    cols = {"ts": ts, TSID: tsid,
            "v": rng.normal(size=n_old).astype(np.float32),
            "code": (tsid * 7 % 11).astype(np.int32),
            "op": np.zeros(n_old, np.int8)}
    cols["v"][rng.random(n_old) < 0.1] = np.nan
    out = {}
    for k, v in cols.items():
        full = np.full(padded, PADS[k], dtype=DTYPES[k])
        full[:n_old] = v
        out[k] = full
    return out


def _random_delta(rng, n_series, dn, ts_min, series_lo=0, span=1000):
    """dn distinct (tsid, ts) keys, every ts at or after ts_min, in a
    shuffled row order."""
    keys = rng.choice((n_series - series_lo) * span, dn, replace=False)
    tsid = (series_lo + keys // span).astype(np.int32)
    ts = (ts_min + (keys % span) * 1000).astype(np.int64)
    v = rng.normal(size=dn).astype(np.float32)
    v[rng.random(dn) < 0.1] = np.inf
    return {"ts": ts, TSID: tsid, "v": v,
            "code": (tsid * 7 % 11).astype(np.int32),
            "op": np.zeros(dn, np.int8)}


def _reference_extend(old, n_old, delta, new_padded):
    """storage/cache.py:327-353 of the reference, on numpy inputs."""
    dn = len(delta[TSID])
    cols = {}
    for name, col in old.items():
        grown = np.full(new_padded, PADS[name], dtype=DTYPES[name])
        grown[:len(col)] = col
        cols[name] = jnp.asarray(grown).at[n_old:n_old + dn].set(
            jnp.asarray(delta[name]))
    mask = jnp.zeros(new_padded, dtype=bool).at[:n_old + dn].set(True)
    order = jnp.lexsort((cols["ts"], cols[TSID],
                         (~mask).astype(jnp.int32)))
    return ({k: np.asarray(v[order]) for k, v in cols.items()},
            np.asarray(mask[order]))


def _merge_emulation(old, n_old, delta, new_padded, n_series):
    """The K23 kernel's arithmetic with torch on the CPU: the delta's
    order (packed key, or two stable passes), the R / D tables by lower
    bound, then each source item to its destination."""
    dtsid = torch.from_numpy(delta[TSID])
    dts = torch.from_numpy(delta["ts"])
    key = stk.delta_order_key(dtsid, dts, n_series)
    if key is not None:
        order = sk.radix_argsort_plain(key).long()
    else:
        first = sk.radix_argsort_plain(dts).long()
        order = first[sk.radix_argsort_plain(
            dtsid[first].to(torch.int64)).long()]
    t = torch.arange(n_series + 1, dtype=torch.int32)
    otsid = torch.from_numpy(old[TSID][:n_old])
    R = torch.searchsorted(otsid, t, side="left")
    D = torch.searchsorted(dtsid[order].contiguous(), t, side="left")
    dest_old = torch.arange(n_old) + D[otsid.long()]
    dest_delta = R[dtsid[order].long() + 1] + torch.arange(len(order))
    n_new = n_old + len(order)
    out = {}
    for name, col in old.items():
        o = torch.full((new_padded,), PADS[name],
                       dtype=torch.from_numpy(col).dtype)
        o[dest_old] = torch.from_numpy(col[:n_old])
        o[dest_delta] = torch.from_numpy(delta[name])[order]
        out[name] = o.numpy()
    mask = np.zeros(new_padded, bool)
    mask[dest_old.numpy()] = True
    mask[dest_delta.numpy()] = True
    assert mask.sum() == n_new == len(set(dest_old.tolist())
                                      | set(dest_delta.tolist()))
    return out, mask


MERGE_CASES = {
    # name: (n_series, n_old, padded, dn, new_padded, series_lo, ts span)
    "pads": (40, 300, 512, 120, 512, 0, 1000),
    "grows": (40, 500, 512, 300, 1024, 0, 1000),
    "empty_delta": (40, 300, 512, 0, 512, 0, 1000),
    "new_series_only": (60, 300, 512, 100, 512, 40, 1000),
    "all_new": (10, 0, 64, 50, 64, 0, 1000),
    # a ts span near 2^52 ms beside 2^13 series: 65 bits, two passes
    "two_pass": (1 << 13, 200, 256, 50, 256, 0, 1 << 49),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_extend_merge_plain_matches_lexsort(case):
    n_series, n_old, padded, dn, new_padded, lo, span = MERGE_CASES[case]
    rng = np.random.default_rng(sorted(MERGE_CASES).index(case))
    old = _random_table(rng, min(n_series, 40) if lo else n_series, 30,
                        n_old, padded)
    ts_min = int(old["ts"][:n_old].max()) + 1000 if n_old else 0
    delta = _random_delta(rng, n_series, dn, ts_min, lo, span)
    key = stk.delta_order_key(torch.from_numpy(delta[TSID]),
                              torch.from_numpy(delta["ts"]), n_series)
    assert (key is None) == (case == "two_pass")
    want_cols, want_mask = _reference_extend(old, n_old, delta, new_padded)
    got_cols, got_mask = stk.extend_merge(
        {k: torch.from_numpy(v) for k, v in old.items()}, n_old,
        {k: torch.from_numpy(v) for k, v in delta.items()}, new_padded,
        PADS, n_series, tsid=TSID, ts="ts")
    emu_cols, emu_mask = _merge_emulation(old, n_old, delta, new_padded,
                                          n_series)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(emu_mask, want_mask)
    for k in old:
        np.testing.assert_array_equal(got_cols[k].numpy(), want_cols[k],
                                      err_msg=k)
        np.testing.assert_array_equal(emu_cols[k], want_cols[k], err_msg=k)
        # pad rows bit for bit (NaN payloads included)
        assert got_cols[k].numpy().tobytes() == want_cols[k].tobytes(), k


def test_pad_bits_match_torch_full():
    for dtype, pad in ((torch.float32, np.nan), (torch.int32, -1),
                       (torch.int64, 0), (torch.int8, 0),
                       (torch.float64, np.nan)):
        full = torch.full((1,), pad, dtype=dtype).numpy().tobytes()
        got = stk.pad_bits(pad, dtype).to_bytes(8, "little", signed=True)
        assert got[:len(full)] == full


def test_extend_merge_refuses_bad_inputs():
    cols = {"ts": torch.zeros(4, dtype=torch.int64),
            TSID: torch.zeros(4, dtype=torch.int32)}
    with pytest.raises(ValueError, match="columns"):
        stk.extend_merge(cols, 0, {"ts": cols["ts"]}, 4, PADS, 1, tsid=TSID,
                         ts="ts")
    with pytest.raises(ValueError, match="fit"):
        stk.extend_merge(cols, 2, cols, 4, PADS, 1, tsid=TSID, ts="ts")


# ---------------------------------------------------------------------------
# the grid: extend, hot tail, catch-up
# ---------------------------------------------------------------------------

T0 = 1_451_606_400_000
STEP = 10_000
GRID_DDL = ("CREATE TABLE cpu (hostname STRING, dc STRING, "
            "ts TIMESTAMP(3) TIME INDEX, a DOUBLE, b DOUBLE, c DOUBLE, "
            "PRIMARY KEY (hostname, dc))")


def _grid_rows(seed, hosts=16, steps=60, t_off=0, nan=False, inf=False):
    rng = np.random.default_rng(seed)
    ts = T0 + (t_off + np.repeat(np.arange(steps), hosts)) * STEP
    n = len(ts)
    names = np.array([f"host_{i}" for i in range(hosts)], dtype=object)
    data = {"hostname": np.tile(names, n // hosts),
            "dc": np.tile(np.array([f"dc_{i % 3}" for i in range(hosts)],
                                   dtype=object), n // hosts),
            "ts": ts}
    for f in ("a", "b", "c"):
        data[f] = rng.uniform(0, 100, n)
    if nan:
        data["b"][rng.random(n) < 0.05] = np.nan
    if inf:
        data["c"][rng.random(n) < 0.02] = np.inf
    return data


def assert_grids_equal(ref, port):
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    assert sorted(port.tag_codes) == sorted(ref.tag_codes)
    for k, v in ref.tag_codes.items():
        np.testing.assert_array_equal(port.tag_codes[k].numpy(),
                                      np.asarray(v))
    assert (port.ts0, port.step, port.nt, port.tpad, port.spad,
            port.num_series) == (ref.ts0, ref.step, ref.nt, ref.tpad,
                                 ref.spad, ref.num_series)
    assert port.no_nan == ref.no_nan and port.field_names == ref.field_names
    assert port.dicts == ref.dicts


@pytest.fixture
def dbs(tmp_path):
    ref = RefDB(str(tmp_path / "ref"))
    port = GreptimeDB(str(tmp_path / "port"), device="cpu")
    ref.sql(GRID_DDL)
    port.sql(GRID_DDL)
    yield ref, port
    ref.close()
    port.close()


def _regions(dbs):
    return [db._region_of("cpu") for db in dbs]


@pytest.mark.parametrize("case", ["append", "grows_time_axis",
                                  "new_series_nan_inf"])
def test_extend_grid_matches_reference(dbs, case):
    ref_db, port_db = dbs
    steps = 2000 if case == "grows_time_axis" else 60
    first = _grid_rows(1, steps=steps, nan=True)
    for r in _regions(dbs):
        r.write(first)
    g0 = [ref_db.cache.get_grid(_regions(dbs)[0]),
          port_db.cache.get_grid(_regions(dbs)[1])]
    assert_grids_equal(*g0)
    if case == "new_series_nan_inf":
        delta = _grid_rows(2, hosts=20, steps=10, t_off=steps, nan=True,
                           inf=True)
    else:
        delta = _grid_rows(2, steps=100, t_off=steps)
    for r in _regions(dbs):
        r.write(delta)
    g1 = [ref_db.cache.get_grid(_regions(dbs)[0]),
          port_db.cache.get_grid(_regions(dbs)[1])]
    assert port_db.cache.extends == ref_db.cache.extends == 1
    assert_grids_equal(*g1)
    assert g1[1].dicts_version > g0[1].dicts_version
    if case == "grows_time_axis":
        assert g0[1].tpad == 2048 and g1[1].tpad == 4096
    # the resident table the extend started from is left as it was
    np.testing.assert_array_equal(g0[1].values.numpy(),
                                  np.asarray(g0[0].values))
    # and the extended grid equals a fresh build of the region
    fresh = pgrid.build_grid_table(_regions(dbs)[1], device="cpu")
    np.testing.assert_array_equal(fresh.values.numpy()[:, :, :fresh.nt],
                                  g1[1].values.numpy()[:, :, :fresh.nt])
    np.testing.assert_array_equal(fresh.valid.numpy()[:, :fresh.nt],
                                  g1[1].valid.numpy()[:, :fresh.nt])


def test_grid_rebuilds_when_delta_is_off_grid(dbs):
    ref_db, port_db = dbs
    for r in _regions(dbs):
        r.write(_grid_rows(1))
    for db, r in zip(dbs, _regions(dbs)):
        db.cache.get_grid(r)
    off = _grid_rows(2, steps=5, t_off=60)
    off["ts"] = off["ts"] + 3  # not on the 10 s grid
    for r in _regions(dbs):
        r.write(off)
    got = [db.cache.get_grid(r) for db, r in zip(dbs, _regions(dbs))]
    assert port_db.cache.misses == ref_db.cache.misses == 2
    assert (got[0] is None) == (got[1] is None)


def test_hot_tail_matches_reference(dbs):
    ref_db, port_db = dbs
    for r in _regions(dbs):
        r.write(_grid_rows(1))
    for db, r in zip(dbs, _regions(dbs)):
        assert db.cache.get_grid(r) is not None
        db.cache.min_extend_rows = 1
    ev = ("region_device", "grid", "hot_tail")
    h0 = (RREG.value("greptime_cache_events_total", ev),
          PREG.value("greptime_cache_events_total", ev))
    delta = _grid_rows(3, steps=8, t_off=60)
    cols = {k: (v.tolist() if v.dtype == object else v)
            for k, v in delta.items()}
    for fn, db in ((ref_ingest, ref_db), (ingest_columns, port_db)):
        fn(db, "cpu", {**cols, "__tags__": ["hostname", "dc"],
                       "__fields__": ["a", "b", "c"]})
    assert RREG.value("greptime_cache_events_total", ev) == h0[0] + 1
    assert PREG.value("greptime_cache_events_total", ev) == h0[1] + 1
    hits = port_db.cache.hits
    got = [db.cache.get_grid(r) for db, r in zip(dbs, _regions(dbs))]
    assert port_db.cache.hits == hits + 1  # the grid is current
    assert_grids_equal(*got)
    q = "SELECT hostname, count(*), max(a) FROM cpu GROUP BY hostname"
    _golden_rows(sorted(port_db.sql(q).rows), sorted(ref_db.sql(q).rows))


def test_hot_tail_leaves_small_deltas(dbs):
    _ref_db, port_db = dbs
    region = _regions(dbs)[1]
    region.write(_grid_rows(1))
    g = port_db.cache.get_grid(region)
    region.write(_grid_rows(4, steps=1, t_off=60))  # 16 rows < 4096
    assert not port_db.cache.extend_hot_tail(region)
    assert port_db.cache.extends == 0
    assert port_db.cache.get_grid(region) is not g  # the query extends
    assert port_db.cache.extends == 1


def _catch_up_writes(regions, with_delete, grow):
    """After the resident build: several flushed parts past the resident
    end (one with new series), optionally a tombstone among them."""
    steps = 100 if grow else 1
    for k in range(3):
        data = _grid_rows(10 + k, hosts=16 if k < 2 else 18, steps=steps,
                          t_off=60 + k * steps, nan=k == 1)
        for r in regions:
            r.write(data)
            r.flush()
    if with_delete:
        kill = {"hostname": ["host_3", "host_5"], "dc": ["dc_0", "dc_2"],
                "ts": [T0 + 60 * STEP, T0 + (60 + steps) * STEP]}
        for r in regions:
            r.delete(kill)
            r.flush()


@pytest.mark.parametrize("with_delete", [False, True])
@pytest.mark.parametrize("grow", [False, True])
def test_catch_up_grid_matches_reference(dbs, with_delete, grow):
    ref_db, port_db = dbs
    regions = _regions(dbs)
    for r in regions:
        r.write(_grid_rows(1, steps=60))
        r.flush()
    base = [rgrid.build_grid_table(regions[0]),
            pgrid.build_grid_table(regions[1], device="cpu")]
    assert base[1].tpad == 64
    ids = [{m.file_id for m in r.sst_files} for r in regions]
    _catch_up_writes(regions, with_delete, grow)
    new = [[m for m in r.sst_files if m.file_id not in i]
           for r, i in zip(regions, ids)]
    assert len(new[1]) == 3 + with_delete
    got = [rgrid.catch_up_grid_table(base[0], regions[0], new[0]),
           pgrid.catch_up_grid_table(base[1], regions[1], new[1])]
    assert got[1] is not None and got[1] is not base[1]
    assert_grids_equal(*got)
    assert got[1].tpad == (512 if grow else 64)
    assert got[1].num_series == 18
    if with_delete:
        # the tombstones land as invalid cells holding +0.0
        r = regions[1]
        steps = 100 if grow else 1
        for host, dc, t in (("host_3", "dc_0", 60), ("host_5", "dc_2",
                                                      60 + steps)):
            tsid = r._series[(r.encoders["hostname"].get(host),
                              r.encoders["dc"].get(dc))]
            assert not got[1].valid[tsid, t]
            assert (got[1].values[:, tsid, t] == 0).all()
            assert base[1].nt <= t < got[1].nt


def test_grid_scatter_routes_of_append_and_catch_up(dbs, monkeypatch):
    """An append of every series each step (time-major, as TSBS hours and
    scrapes arrive) reaches grid_scatter_steps as whole steps; the
    flushed parts of a catch-up, read from SSTs in (tsid, ts) order, and a
    ragged last step reach grid_scatter as cells.  Every grid equals the
    reference's."""
    ref_db, port_db = dbs
    regions = _regions(dbs)
    routes = []  # True: grid_scatter_steps, False: grid_scatter

    def spy(name, whole_steps):
        real = getattr(stk, name)

        def wrapper(*args):
            routes.append(whole_steps)
            return real(*args)
        monkeypatch.setattr(stk, name, wrapper)

    spy("grid_scatter_steps", True)
    spy("grid_scatter", False)
    for r in regions:
        r.write(_grid_rows(1, steps=60))
        r.flush()
    for db, r in zip(dbs, regions):
        db.cache.get_grid(r)
    for r in regions:
        r.write(_grid_rows(2, hosts=18, steps=30, t_off=60))
    assert_grids_equal(*[db.cache.get_grid(r)
                         for db, r in zip(dbs, regions)])
    assert routes == [True]
    ragged = _grid_rows(3, steps=12, t_off=90)
    ragged = {k: v[:-5] for k, v in ragged.items()}
    for r in regions:
        r.write(ragged)
    assert_grids_equal(*[db.cache.get_grid(r)
                         for db, r in zip(dbs, regions)])
    assert routes == [True, False]
    for r in regions:
        r.flush()
        r.write(_grid_rows(4, steps=10, t_off=102))
        r.flush()
    caught = [db.cache.get_grid(r) for db, r in zip(dbs, regions)]
    assert caught[1].nt == 112
    assert_grids_equal(*caught)
    assert routes == [True, False, False]


def test_flush_catches_up_through_the_cache(dbs):
    ref_db, port_db = dbs
    regions = _regions(dbs)
    for r in regions:
        r.write(_grid_rows(1, steps=60))
        r.flush()
    for db, r in zip(dbs, regions):
        db.cache.get_grid(r)
    ev = ("region_device", "grid", "catch_up")
    c0 = PREG.value("greptime_cache_events_total", ev)
    for r in regions:
        r.write(_grid_rows(2, steps=30, t_off=60))
    # the hot tail / extend consumes the append, then the flush catches up
    got = [db.cache.get_grid(r) for db, r in zip(dbs, regions)]
    assert_grids_equal(*got)
    for r in regions:
        r.flush()
    caught = [db.cache.get_grid(r) for db, r in zip(dbs, regions)]
    assert PREG.value("greptime_cache_events_total", ev) == c0 + 1
    assert caught[1] is got[1]  # nothing past the resident coverage
    assert_grids_equal(*caught)
    # strictly newer rows flushed without a query between: catch up reads
    for r in regions:
        r.write(_grid_rows(3, steps=10, t_off=90))
        r.flush()
    caught = [db.cache.get_grid(r) for db, r in zip(dbs, regions)]
    assert PREG.value("greptime_cache_events_total", ev) == c0 + 2
    assert caught[1].nt == 100
    assert_grids_equal(*caught)
    # an upsert of an old key mutates content: no catch-up, a rebuild
    for r in regions:
        r.write({"hostname": ["host_0"], "dc": ["dc_0"], "ts": [T0],
                 "a": [999.0], "b": [1.0], "c": [1.0]})
        r.flush()
    rebuilt = [db.cache.get_grid(r) for db, r in zip(dbs, regions)]
    assert PREG.value("greptime_cache_events_total", ev) == c0 + 2
    assert_grids_equal(*rebuilt)
    assert 999.0 in rebuilt[1].values.numpy()


# ---------------------------------------------------------------------------
# grid snapshots
# ---------------------------------------------------------------------------

def _flushed_home(mod_db, home, tail=True):
    db = mod_db(home) if mod_db is RefDB else mod_db(home, device="cpu")
    db.sql(GRID_DDL)
    r = db._region_of("cpu")
    r.write(_grid_rows(1, steps=60, nan=True))
    r.flush()
    if tail:
        r.write(_grid_rows(2, steps=4, t_off=60))
    return db, r


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_grid_snapshot_cross_loads(tmp_path, saver):
    """A snapshot saved by either package loads in the other over the same
    data home, equal to the saver's grid."""
    home, snap = str(tmp_path / "home"), str(tmp_path / "snap")
    first, second = (RefDB, GreptimeDB) if saver == "reference" else (
        GreptimeDB, RefDB)
    db, r = _flushed_home(first, home)
    grid = db.cache.get_grid(r)
    save = rgrid.save_grid_snapshot if first is RefDB else \
        pgrid.save_grid_snapshot
    save(grid, r, snap)
    values, valid = np.asarray(grid.values) if first is RefDB else \
        grid.values.numpy(), np.asarray(grid.valid) if first is RefDB \
        else grid.valid.numpy()
    db.close(flush=False)
    db2 = second(home) if second is RefDB else second(home, device="cpu")
    try:
        r2 = db2._region_of("cpu")
        if second is RefDB:
            got = rgrid.load_grid_snapshot(snap, r2)
            gv, gm = np.asarray(got.values), np.asarray(got.valid)
        else:
            got = pgrid.load_grid_snapshot(snap, r2, device="cpu")
            gv, gm = got.values.numpy(), got.valid.numpy()
        assert got is not None
        np.testing.assert_array_equal(gv, values)
        np.testing.assert_array_equal(gm, valid)
        assert got.dicts == grid.dicts and got.no_nan == grid.no_nan
        assert (got.nt, got.ts0, got.step) == (grid.nt, grid.ts0, grid.step)
        db2.cache.install_grid(r2, got)
        assert db2.cache.get_grid(r2) is got
        q = "SELECT hostname, avg(a), count(*) FROM cpu GROUP BY hostname"
        assert len(db2.sql(q).rows) == 16
        # the region moves on: the fingerprint refuses the snapshot
        r2.write(_grid_rows(3, steps=1, t_off=64))
        r2.flush()
        if second is RefDB:
            assert rgrid.load_grid_snapshot(snap, r2) is None
        else:
            assert pgrid.load_grid_snapshot(snap, r2, device="cpu") is None
    finally:
        db2.close()


def test_grid_snapshot_refuses_mismatch(tmp_path):
    db, r = _flushed_home(GreptimeDB, str(tmp_path / "home"), tail=False)
    try:
        grid = db.cache.get_grid(r)
        snap = str(tmp_path / "snap")
        pgrid.save_grid_snapshot(grid, r, snap)
        assert pgrid.load_grid_snapshot(snap, r, device="cpu") is not None
        # another dictionary: the codes would decode to other labels
        meta_path = os.path.join(snap, "meta.json")
        import json

        with open(meta_path) as f:
            meta = json.load(f)
        meta["dicts"]["hostname"] = meta["dicts"]["hostname"][::-1]
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        assert pgrid.load_grid_snapshot(snap, r, device="cpu") is None
        assert rgrid.load_grid_snapshot(snap, r) is None
        # a truncated tensor file is no snapshot, not a crash
        pgrid.save_grid_snapshot(grid, r, snap)
        with open(os.path.join(snap, "tags.npz"), "wb") as f:
            f.write(b"PK\x03")
        assert pgrid.load_grid_snapshot(snap, r, device="cpu") is None
    finally:
        db.close()


def test_grid_snapshot_meta_fsyncs_parent_dir(tmp_path, monkeypatch):
    """tests/test_durability.py's rename-durability case on the port."""
    from types import SimpleNamespace

    table = pgrid.GridTable(
        values=torch.zeros((1, 2, 4)), valid=torch.zeros((2, 4), dtype=bool),
        tag_codes={}, ts0=0, step=1000, nt=4, num_series=2,
        field_names=("v",))
    region = SimpleNamespace(sst_files=[],
                             memtable=SimpleNamespace(num_rows=0),
                             num_series=2, schema=_schema(PT))
    calls = []
    monkeypatch.setattr(pgrid, "_fsync_dir", lambda p: calls.append(p))
    snap = str(tmp_path / "snap")
    pgrid.save_grid_snapshot(table, region, snap)
    assert calls == [snap]
    assert os.path.exists(os.path.join(snap, "meta.json"))


# ---------------------------------------------------------------------------
# logs: the fingerprint lineage survives a push
# ---------------------------------------------------------------------------

def _push(db, lines, t0_s):
    import json

    streams = [{"stream": {"app": a}, "values": [
        [str((t0_s + i) * 10**9), line] for i, line in enumerate(lines)
        if i % 2 == k]} for k, a in enumerate(("api", "web"))]
    return loki_push(db, json.dumps({"streams": streams}).encode(),
                     "application/json", "acme")


def test_logql_after_push_extends_fingerprints_by_tail():
    from greptimedb_tpu_torch.fulltext import loki as PL

    port = GreptimeDB(device="cpu")
    try:
        first = [f"request {i} failed" if i % 3 == 0 else f"ok {i}"
                 for i in range(60)]
        _push(port, first, 1_700_000_000)
        q = {"query": '{app=~".+"} |= "failed"', "start": "1700000000",
             "end": "1700001000", "limit": "1000"}
        got = PL.loki_query_range(port, q)
        assert sum(len(s["values"]) for s in got["data"]["result"]) == 20
        view = port._table_view("loki_logs")
        t0 = port.cache.peek_table(view)
        assert t0 is not None and t0.dicts_root == t0.dicts_version
        ft = port.engine.executor.fulltext_cache
        entry = next(ft._lru[k] for k in ft._lru if k[0] == "fp")
        assert entry.n == len(t0.dicts["line"]) == 60
        indexed = PREG.value("greptime_fulltext_indexed_values_total")
        extends = port.cache.extends
        second = [f"request {i} failed again" if i % 4 == 0 else f"ok {i}"
                  for i in range(60, 100)]
        _push(port, second, 1_700_000_100)
        got = PL.loki_query_range(port, q)
        assert sum(len(s["values"]) for s in got["data"]["result"]) == 30
        t1 = port.cache.peek_table(view)
        assert port.cache.extends == extends + 1
        assert t1.dicts_root == t0.dicts_root
        assert t1.dicts_version > t0.dicts_version
        assert t1.dicts["line"][:60] == t0.dicts["line"]
        entry = next(ft._lru[k] for k in ft._lru if k[0] == "fp")
        assert entry.root == t0.dicts_root and entry.n == 100
        # only the 40 new dictionary entries were fingerprinted
        assert PREG.value("greptime_fulltext_indexed_values_total") == \
            indexed + 40
    finally:
        port.close()


# ---------------------------------------------------------------------------
# PromQL: the derived state of an extended table under a tight budget
# ---------------------------------------------------------------------------

PROM_DDL = ("CREATE TABLE http_requests_total (pod STRING, container STRING, "
            "ts TIMESTAMP(3) TIME INDEX, val DOUBLE, "
            "PRIMARY KEY (pod, container))")
PROM_T0 = 1_700_000_000_000


def _scrape(rng, counters, k, pods=40, conts=3):
    n = pods * conts
    counters += rng.uniform(100, 200, n)
    reset = rng.random(n) < 0.02
    counters[reset] = rng.uniform(0, 10, int(reset.sum()))
    v = counters.copy()
    v[rng.random(n) < 0.01] = np.nan
    return {"pod": np.array([f"pod-{i // conts}" for i in range(n)],
                            dtype=object),
            "container": np.array([f"c{i % conts}" for i in range(n)],
                                  dtype=object),
            "ts": np.full(n, PROM_T0 + k * 15_000, dtype=np.int64),
            "val": v}


def test_promql_budget_holding_one_version(tmp_path):
    """A PromQL budget that holds exactly one table version's selection,
    sort layout and group layout: after an append, the old version's sort
    layout leaves the cache (the selection and group layout key on the
    series registry, which did not move, and stay), the new one is
    admitted without a reject, the warm query takes everything from the
    cache, and the rows equal the reference's."""
    from greptimedb_tpu.promql.engine import PromEvaluator as RefEval
    from greptimedb_tpu.promql.parser import parse_promql as ref_parse
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import parse_promql

    ref = RefDB(str(tmp_path / "ref"))
    port = GreptimeDB(str(tmp_path / "port"), device="cpu")
    query = "sum by (pod) (rate(http_requests_total[5m]))"
    try:
        regions = []
        for db in (ref, port):
            db.sql(PROM_DDL)
            regions.append(db._region_of("http_requests_total"))
        rng = np.random.default_rng(3)
        counters = rng.uniform(0, 1000, 120)
        for k in range(40):
            data = _scrape(rng, counters, k)
            for r in regions:
                r.write(data)

        def instant(k):
            t = (PROM_T0 + k * 15_000) / 1000
            ev = PromEvaluator(port, t, t, 1.0)
            res = ev.eval(parse_promql(query))
            want = RefEval(ref, t, t, 1.0).eval(ref_parse(query))
            got = {dict(lab)["pod"]: float(v) for lab, v in zip(
                res.labels, res.values.numpy()[:, 0])}
            exp = {dict(lab)["pod"]: float(v) for lab, v in zip(
                want.labels, np.asarray(want.values)[:, 0])}
            assert got.keys() == exp.keys()
            for p, b in exp.items():
                assert abs(got[p] - b) <= 1e-5 * max(1.0, abs(b)), p
            return ev

        instant(39)
        pc = port.promql_cache
        assert {k[1] for k in pc._lru} == {"selection", "sort", "group"}
        pc.capacity = pc.bytes  # exactly this version's entries
        table0 = port.cache.get(regions[1])
        data = _scrape(rng, counters, 40)
        for r in regions:
            r.write(data)
        ev = instant(40)
        table1 = port.cache.get(regions[1])
        assert port.cache.extends == 1
        assert table1.dicts_version != table0.dicts_version
        ce = ev.cache_events
        assert ce["sort_miss"] == 1 and not ce["sort_reject"]
        assert ce["selection_hit"] == ce["group_hit"] == 1
        sorts = [e.version for k, e in pc._lru.items() if k[1] == "sort"]
        assert sorts == [table1.dicts_version]
        assert pc.bytes <= pc.capacity and pc.rejects == 0
        ce = instant(40).cache_events
        assert all(ce[f"{k}_hit"] == 1 and not ce[f"{k}_miss"]
                   for k in ("selection", "sort", "group"))
    finally:
        ref.close()
        port.close()
