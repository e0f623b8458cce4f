"""Port parity: the concurrent serving path of ``greptimedb_tpu_torch``.

The serving scheduler (``serving/scheduler.py``) coalesces concurrent
shape-compatible SELECTs into ``db.sql_batch`` →
``QueryEngine.execute_select_batch`` → ``Executor.execute_grid_batch``:
one ``group_merge_stacked`` pair of launches (K2 stacked) over the
resident bucket-major partials, with each member's tag-only WHERE entering
as a row of the mask stack that ``series_mask`` (K21) gathers from the
member's lookup table.

Held against the JAX reference on its CPU, with inputs made from a seed
with numpy (the port runs on ``device="cpu"``, where the wrappers take the
plain versions):

- K2 stacked: ``group_merge_stacked_plain`` against the reference's own
  ``jax.jit(jax.vmap(_bm_kernel_fn(...)))`` on the same partials
  (counts, keys and masks exact; sums and means within the golden bound
  ``|a-b| <= 1e-5*max(1,|b|)``, tests/test_golden.py: the frameworks sum
  in different orders), and against the port's solo ``_bm_kernel_fn``
  with ``==``;
- K21: the port's lookup-table mask against the reference's
  ``_series_mask`` exactly, over NULL tags, ``!=``, ``IN``, ``LIKE``, an
  ``OR`` of two tags and a literal not in the dictionary;
- the batch entry points and the scheduler: every batched member equals
  its solo run with ``==`` within the port, and the reference within the
  golden bound; the reference's fall-back cases and the scheduler,
  admission, SLO and idle-economy cases of ``tests/test_scheduler.py``
  and ``tests/test_slo.py`` whose subsystems the port has.

The card-only cases of both kernels are in test_torch_grid_kernels.py.
"""

import math
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from greptimedb_tpu.query import optimizer as ref_opt
from greptimedb_tpu.query import parser as ref_parser
from greptimedb_tpu.query import planner as ref_planner
from greptimedb_tpu.query.exprs import compile_device as ref_compile
from greptimedb_tpu.query.physical import Executor as RefExecutor
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.errors import (
    Cancelled, DeadlineExceeded, RateLimited, ResourcesExhausted,
)
from greptimedb_tpu_torch.ops import grid_kernels as gk
from greptimedb_tpu_torch.query import optimizer as port_opt
from greptimedb_tpu_torch.query import parser as port_parser
from greptimedb_tpu_torch.query import physical as port_physical
from greptimedb_tpu_torch.query import planner as port_planner
from greptimedb_tpu_torch.query.physical import DISPATCH_STATS, Executor
from greptimedb_tpu_torch.serving.idle import IdleEconomy
from greptimedb_tpu_torch.serving.slo import (
    LatencySketch, SloEngine, _MIN_S, sketch_params,
)
from greptimedb_tpu_torch.standalone import GreptimeDB
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

pytestmark = pytest.mark.concurrency

REL = 1e-5
T0 = 1451606400000  # TSBS epoch
H = 3_600_000
HOSTS = 6
HOURS = 3
STEP_MS = 10_000


def _fill(db):
    """tests/test_scheduler.py's table: 6 hosts x 3 h at 10 s, two DOUBLE
    metrics from seed 7, inserted through SQL."""
    db.sql("CREATE TABLE cpu (hostname STRING, ts TIMESTAMP(3) TIME INDEX, "
           "usage_user DOUBLE, usage_system DOUBLE, PRIMARY KEY (hostname))")
    rows = []
    rng = np.random.default_rng(7)
    vals = rng.uniform(0, 100, size=(HOSTS, HOURS * 360, 2))
    for h in range(HOSTS):
        for i in range(HOURS * 360):
            rows.append(f"('host_{h}', {T0 + i * STEP_MS}, "
                        f"{vals[h, i, 0]:.3f}, {vals[h, i, 1]:.3f})")
    for c in range(0, len(rows), 1000):
        db.sql("INSERT INTO cpu VALUES " + ",".join(rows[c:c + 1000]))
    return db


def _window_sql(hour_lo: int, hours: int = 1, where: str = "") -> str:
    lo = T0 + hour_lo * H
    hi = lo + hours * H
    return ("SELECT hostname, date_trunc('hour', ts) AS hour, "
            "avg(usage_user), avg(usage_system) FROM cpu "
            f"WHERE {where}ts >= {lo} AND ts < {hi} GROUP BY hostname, hour")


def _host_sql(i: int, hour_lo: int = 0) -> str:
    return _window_sql(hour_lo, where=f"hostname = 'host_{i}' AND ")


@pytest.fixture(scope="module")
def db():
    d = _fill(GreptimeDB(device="cpu"))
    yield d
    d.close()


@pytest.fixture(scope="module")
def ref_db():
    d = _fill(RefDB())
    yield d
    d.close()


def close(got, want, exact=False):
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
    assert (np.abs(g[ok] - w[ok]) <= REL * np.maximum(1.0, np.abs(w[ok]))
            ).all(), np.abs(g[ok] - w[ok]).max()


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and values, NaN where the other has NaN."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, nan=0.0),
                            torch.nan_to_num(b, nan=0.0)))


def rows_close(got, want):
    """The golden comparer's rule: keys exact, floats within 1e-5."""
    assert len(got) == len(want)
    for gr, wr in zip(got, want):
        assert len(gr) == len(wr)
        for g, w in zip(gr, wr):
            if isinstance(w, float):
                assert abs(g - w) <= REL * max(1.0, abs(w)), (gr, wr)
            else:
                assert g == w, (gr, wr)


def _geom(d, parser, opt, planner, sql):
    """(plan, grid, geometry) of one query on either package's db."""
    sel = parser.parse_sql(sql)[0]
    ctx = d.table_context(sel.table)
    sel, _rules = opt.optimize_select(sel, ctx)
    plan = planner.plan_select(sel, ctx)
    grid, tsb = d.grid_table(sel.table, plan)
    return plan, grid, d.engine.executor._grid_prologue(plan, grid, tsb)


def port_geom(d, sql):
    return _geom(d, port_parser, port_opt, port_planner, sql)


def ref_geom(d, sql):
    return _geom(d, ref_parser, ref_opt, ref_planner, sql)


# ---------------------------------------------------------------------------
# K2 stacked: group_merge_stacked_plain vs the reference's jit(vmap(bm))
# ---------------------------------------------------------------------------

FIELDS = ("a", "b", "c")
SPECS = [("count(*)", "count", None), ("sum(a)", "sum", 0),
         ("avg(b)", "mean", 1), ("avg(a)", "mean", 0)]


def _partials(seed, spad=64, nb=8, nan=False):
    """Bucket-major partials as the grid lays them out: counts in [0, r],
    sums zero where a count is zero, -1 tag codes on pad series."""
    rng = np.random.default_rng(seed)
    cnts = rng.integers(0, 33, (spad, nb)).astype(np.float32)
    cnts[50:] = 0
    sums = (rng.random((len(FIELDS), spad, nb)) * 3000).astype(np.float32)
    sums *= cnts > 0
    if nan:
        sums[0, 3, 2] = np.nan
        sums[0, 7, 5] = np.inf
    host = np.full(spad, -1, np.int32)
    host[:50] = rng.integers(0, 23, 50)
    dc = np.full(spad, -1, np.int32)
    dc[:50] = rng.integers(0, 3, 50)
    return sums, cnts, {"dc": dc, "host": host}


def _ref_mask_fns():
    from greptimedb_tpu.datatypes.batch import DictionaryEncoder
    from greptimedb_tpu.datatypes.schema import ColumnSchema, Schema
    from greptimedb_tpu.datatypes.types import ConcreteDataType, SemanticType
    from greptimedb_tpu.query.ast import BinaryOp, Column, InList, Literal
    from greptimedb_tpu.query.exprs import TableContext

    schema = Schema((
        ColumnSchema("host", ConcreteDataType.STRING, SemanticType.TAG),
        ColumnSchema("dc", ConcreteDataType.STRING, SemanticType.TAG),
        ColumnSchema("ts", ConcreteDataType.TIMESTAMP_MILLISECOND,
                     SemanticType.TIMESTAMP),
        *(ColumnSchema(f, ConcreteDataType.FLOAT64) for f in FIELDS)))
    ctx = TableContext(schema, {
        "host": DictionaryEncoder([f"h{i}" for i in range(23)]),
        "dc": DictionaryEncoder(["d0", "d1", "d2"])})
    return [
        ref_compile(InList(Column("host"), (
            Literal("h1"), Literal("h4"), Literal("h9"))), ctx),
        ref_compile(BinaryOp("=", Column("dc"), Literal("d2")), ctx),
        ref_compile(BinaryOp("!=", Column("host"), Literal("h3")), ctx),
    ]


@pytest.mark.parametrize("tag_cols,b_los,nbw,filtered,nan", [
    (["host"], [2, 0, 3, 1], 4, False, False),
    (["host", "dc"], [0, 0], 8, False, False),
    ([], [1, 2, 0], 3, False, False),          # n = 3, padded to 4
    (["dc"], [3, -4, 30], 5, True, False),     # negative / past-NB starts
    (["host"], [1, 2, 3], 6, True, True),      # NaN and inf partials
])
def test_k2_stacked_plain_vs_reference(tag_cols, b_los, nbw, filtered, nan):
    sums, cnts, codes = _partials(5, nan=nan)
    spad, nb = cnts.shape
    n = len(b_los)
    npad = port_physical._pow2(n)
    full = b_los + [b_los[0]] * (npad - n)
    cards = [{"host": 32, "dc": 4}[t] for t in tag_cols]
    ngt = int(np.prod(cards)) if cards else 1
    tag_order = tuple(sorted(codes))
    step_q = 360 * STEP_MS
    bts0s = [T0 + b * step_q for b in full]
    masks = None
    if filtered:
        env = {t: codes[t] for t in tag_order}
        rows = [np.broadcast_to(np.asarray(f(env)), (spad,)).astype(
            np.float32) for f in _ref_mask_fns()[:n]]
        masks = np.stack(rows + [rows[0]] * (npad - n))
    # the reference: jit(vmap(bm kernel)) over (b_lo, bts0[, mask])
    in_axes = (None, None, None, 0, 0, 0) if filtered else (
        None, None, None, 0, 0)
    ref_k = jax.jit(jax.vmap(RefExecutor()._bm_kernel_fn(
        tag_order, tag_cols, cards, nbw, step_q, None, SPECS,
        take_smf=filtered), in_axes=in_axes))
    args = (sums, cnts, tuple(codes[t] for t in tag_order),
            np.asarray(full, np.int32), np.asarray(bts0s, np.int64))
    want = ref_k(*(args + ((masks,) if filtered else ())))
    # the port's plain stacked merge and the solo epilogue
    tc = {t: torch.from_numpy(codes[t]) for t in tag_order}
    ids = port_physical._series_group_ids(tc, tag_cols, cards, ngt, spad,
                                          torch.device("cpu"))
    lay = gk.group_layout(ids, ngt)
    planes = [0, 1]
    ps, pc = torch.from_numpy(sums), torch.from_numpy(cnts)
    pm = None if masks is None else torch.from_numpy(masks)
    cnt, sg = gk.group_merge_stacked_plain(
        ps, pc, torch.tensor(full, dtype=torch.int32), lay,
        torch.tensor(planes, dtype=torch.int32), nbw, pm)
    assert cnt.dtype == torch.int64 and sg.dtype == torch.float32
    assert cnt.shape == (npad, ngt, nbw) and sg.shape == (npad, 2, ngt, nbw)
    got = {
        "count(*)": cnt.reshape(npad, -1),
        "sum(a)": torch.where(cnt > 0, sg[:, 0], float("nan")),
        "avg(b)": torch.where(cnt > 0, sg[:, 1] / torch.clamp(
            cnt, min=1).to(torch.float32), float("nan")),
        "avg(a)": torch.where(cnt > 0, sg[:, 0] / torch.clamp(
            cnt, min=1).to(torch.float32), float("nan")),
    }
    for name, v in got.items():
        close(v.reshape(npad, -1).numpy(), np.asarray(want[name]),
              exact=name == "count(*)")
    close((cnt > 0).reshape(npad, -1).numpy(),
          np.asarray(want["__gmask__"]), exact=True)
    # every member (pad rows included) == the port's solo bm kernel
    masks_t = [None] * npad if pm is None else list(pm)
    for m in range(npad):
        where = None
        if masks_t[m] is not None:
            row = masks_t[m]
            where = (lambda env, row=row: row)  # noqa: E731
        solo = Executor()._bm_kernel_fn(tag_order, tag_cols, cards, nbw,
                                        step_q, where, SPECS)
        out = solo(ps, pc, tuple(tc[t] for t in tag_order), full[m],
                   bts0s[m])
        for name, v in got.items():
            assert same(v[m].reshape(-1), out[name]), (name, m)
    assert gk.group_merge_stacked.launches == 0


def test_k2_stacked_plain_validates_inputs():
    sums, cnts, codes = _partials(6)
    lay = gk.group_layout(torch.zeros(cnts.shape[0], dtype=torch.int32), 1)
    ps, pc = torch.from_numpy(sums), torch.from_numpy(cnts)
    planes = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError):
        gk.group_merge_stacked(ps, pc, torch.tensor([0, 1]), lay, planes, 4)
    with pytest.raises(ValueError):
        gk.group_merge_stacked(ps, pc, torch.tensor([0], dtype=torch.int32),
                               lay, planes, 99)
    with pytest.raises(ValueError):
        gk.group_merge_stacked(ps, pc, torch.tensor([0], dtype=torch.int32),
                               lay, planes, 4, mask=torch.ones(3, 64))


# ---------------------------------------------------------------------------
# K21: the lookup-table series mask vs the reference's _series_mask
# ---------------------------------------------------------------------------

PREDICATES = [
    "host = 'h1'",
    "host != 'h1'",
    "host IN ('h1', 'h3', 'nope')",
    "host NOT IN ('h1', 'h4')",
    "host LIKE 'h%'",
    "dc LIKE '%1'",
    "host = 'h2' OR dc = 'd0'",
    "host = 'zzz'",
    "host IS NULL",
    "dc IS NOT NULL AND host != 'h5'",
    "NOT (dc = 'd2')",
]


def _tag_table(d):
    """Two tags with NULLs: every (host, dc) pair of h0..h5 x d0..d2 plus
    NULL-host and NULL-dc series, 36 steps at 10 s."""
    d.sql("CREATE TABLE t (host STRING, dc STRING, ts TIMESTAMP(3) TIME "
          "INDEX, v DOUBLE, PRIMARY KEY (host, dc))")
    hosts = [f"'h{i}'" for i in range(6)] + ["NULL"]
    dcs = ["'d0'", "'d1'", "'d2'", "NULL"]
    rng = np.random.default_rng(3)
    rows = []
    for h in hosts:
        for c in dcs:
            for i in range(36):
                rows.append(f"({h}, {c}, {T0 + i * STEP_MS}, "
                            f"{rng.uniform(0, 10):.3f})")
    d.sql("INSERT INTO t VALUES " + ",".join(rows))
    return d


@pytest.fixture(scope="module")
def tag_dbs():
    port, ref = _tag_table(GreptimeDB(device="cpu")), _tag_table(RefDB())
    yield port, ref
    port.close()
    ref.close()


def _tag_sql(pred: str) -> str:
    return (f"SELECT host, date_trunc('hour', ts) AS hour, avg(v) FROM t "
            f"WHERE ({pred}) AND ts >= {T0} AND ts < {T0 + H} "
            f"GROUP BY host, hour")


def _port_masks(d, preds, npad):
    ex = d.engine.executor
    luts, grid = [], None
    for pred in preds:
        plan, grid, g = port_geom(d, _tag_sql(pred))
        assert g.where_series
        luts.append(ex._series_mask(plan, g, grid))
    union, offs, strides, extents, tables = port_physical.mask_tables(luts)
    codes = (torch.stack([grid.tag_codes[t] for t in union]) if union
             else torch.empty((0, grid.spad), dtype=torch.int32))
    return gk.series_mask(
        codes, torch.cat(tables), torch.tensor(offs, dtype=torch.int32),
        torch.from_numpy(strides), torch.from_numpy(extents), npad)


@pytest.mark.parametrize("pred", PREDICATES)
def test_k21_series_mask_equals_reference(tag_dbs, pred):
    port, ref = tag_dbs
    rplan, rgrid, rg = ref_geom(ref, _tag_sql(pred))
    assert rg.where_series
    want = np.asarray(ref.engine.executor._series_mask(
        rplan, rg, rgrid, tuple(rgrid.tag_codes[t] for t in rg.tag_order)))
    _plan, pgrid, _g = port_geom(port, _tag_sql(pred))
    for t in rg.tag_order:
        np.testing.assert_array_equal(pgrid.tag_codes[t].numpy(),
                                      np.asarray(rgrid.tag_codes[t]))
    got = _port_masks(port, [pred], 1)
    assert got.dtype == torch.float32 and got.shape == (1, pgrid.spad)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert gk.series_mask.launches == 0


def test_k21_stack_pads_with_the_leaders_twin(tag_dbs):
    port, _ref = tag_dbs
    preds = [PREDICATES[0], PREDICATES[6], PREDICATES[8]]
    stack = _port_masks(port, preds, 4)
    for i, pred in enumerate(preds):
        assert torch.equal(stack[i], _port_masks(port, [pred], 1)[0])
    assert torch.equal(stack[3], stack[0])


def test_k21_plain_clamps_indices_into_the_table():
    codes = torch.tensor([[-1, 0, 2, 9, -5]], dtype=torch.int32)
    lut = torch.tensor([1, 0, 0, 1], dtype=torch.uint8)
    got = gk.series_mask_plain(codes, lut, torch.tensor([0], dtype=torch.int32),
                               torch.tensor([[1]], dtype=torch.int32),
                               torch.tensor([4], dtype=torch.int32), 2)
    want = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


# ---------------------------------------------------------------------------
# Batch entry points: member == solo (port), port ~ reference
# ---------------------------------------------------------------------------

class TestBatchParity:
    def test_engine_batch_entry_bit_exact(self, db, ref_db):
        sels = [port_parser.parse_sql(_window_sql(w))[0]
                for w in (0, 1, 2, 1)]
        solo = [db.engine.execute_select(s) for s in sels]
        st0 = dict(DISPATCH_STATS)
        batched = db.engine.execute_select_batch(sels)
        assert batched is not None
        # counted per real member (pow2 padding adds none: 4 members)
        assert DISPATCH_STATS["grid_batch"] == st0["grid_batch"] + 1
        assert DISPATCH_STATS["grid"] == st0["grid"] + 4
        for b, s in zip(batched, solo):
            assert b.column_names == s.column_names
            assert b.rows == s.rows  # BIT-exact
        ref = [ref_db.engine.execute_select(ref_parser.parse_sql(
            _window_sql(w))[0]) for w in (0, 1, 2, 1)]
        for b, r in zip(batched, ref):
            assert b.column_names == r.column_names
            rows_close(b.rows, r.rows)

    def test_pad_rows_are_dropped_and_not_counted(self, db):
        sels = [port_parser.parse_sql(_host_sql(i))[0] for i in (1, 2, 4)]
        solo = [db.engine.execute_select(s) for s in sels]
        st0 = dict(DISPATCH_STATS)
        metrics: dict = {}
        batched = db.engine.execute_select_batch(sels, metrics=metrics)
        assert [b.rows for b in batched] == [s.rows for s in solo]
        assert metrics["batched"] == 3
        assert metrics["layout"] == "bucket_major_stacked"
        assert DISPATCH_STATS["grid"] == st0["grid"] + 3
        assert DISPATCH_STATS["grid_bm"] == st0["grid_bm"] + 3
        assert DISPATCH_STATS["grid_batch"] == st0["grid_batch"] + 1

    @pytest.mark.parametrize("wheres", [
        ("hostname = 'host_1' AND ", "hostname IN ('host_2', 'host_3') AND ",
         "hostname != 'host_4' AND ", "hostname LIKE 'host_%' AND "),
        ("hostname = 'host_0' AND ", "hostname = 'nope' AND "),
    ])
    def test_tag_filtered_batch_bit_exact(self, db, ref_db, wheres):
        sqls = [_window_sql(i % 2, where=w) for i, w in enumerate(wheres)]
        sels = [port_parser.parse_sql(q)[0] for q in sqls]
        solo = [db.engine.execute_select(s) for s in sels]
        batched = db.engine.execute_select_batch(sels)
        assert batched is not None
        for b, s, q in zip(batched, solo, sqls):
            assert b.rows == s.rows
            rows_close(b.rows, ref_db.sql(q).rows)

    def test_batch_falls_back_on_mixed_shapes(self, db):
        sels = [port_parser.parse_sql(_window_sql(0, 1))[0],
                port_parser.parse_sql(_window_sql(0, 2))[0]]
        assert db.engine.execute_select_batch(sels) is None

    def test_batch_refuses_sliding_windows(self, db):
        q = (f"SELECT ts, avg(usage_user) RANGE '2h' FROM cpu WHERE "
             f"ts >= {T0} AND ts < {T0 + 3 * H} ALIGN '1h'")
        sels = [port_parser.parse_sql(q)[0]] * 2
        assert db.engine.execute_select_batch(sels) is None

    def test_batch_refuses_non_tag_where(self, db):
        sels = [port_parser.parse_sql(_window_sql(
            0, where=f"usage_user > {v} AND "))[0] for v in (10, 20)]
        assert db.engine.execute_select_batch(sels) is None

    def test_batch_refuses_views_and_system_tables(self, db):
        s = port_parser.parse_sql(
            "SELECT table_name FROM information_schema.tables")[0]
        assert db.sql_batch([("q", s, None, None),
                             ("q", s, None, None)]) is None
        s = port_parser.parse_sql("SELECT count(*) FROM no_such_table")[0]
        assert db.sql_batch([("q", s, None, None),
                             ("q", s, None, None)]) is None


@pytest.fixture(scope="module")
def wide_db():
    """Three tags of 165 values each (one series per value): a predicate
    naming all three needs a 166^3 = 4,574,296-entry table, over the cap
    of 2^22."""
    d = GreptimeDB(device="cpu")
    d.sql("CREATE TABLE wide (a STRING, b STRING, c STRING, ts TIMESTAMP(3) "
          "TIME INDEX, v DOUBLE, PRIMARY KEY (a, b, c))")
    n, steps = 165, 360
    names = np.array([f"x{i}" for i in range(n)], dtype=object)
    rng = np.random.default_rng(9)
    d._region_of("wide").write({
        "a": np.tile(names, steps), "b": np.tile(names, steps),
        "c": np.tile(names, steps),
        "ts": T0 + np.repeat(np.arange(steps), n) * STEP_MS,
        "v": rng.uniform(0, 100, n * steps)})
    yield d
    d.close()


def _wide_sql(i: int) -> str:
    return (f"SELECT a, date_trunc('hour', ts) AS hour, avg(v) FROM wide "
            f"WHERE a = 'x{i}' AND b = 'x{i}' AND c = 'x{i}' AND ts >= {T0} "
            f"AND ts < {T0 + H} GROUP BY a, hour")


def test_lookup_table_over_the_cap_refuses_the_batch(wide_db):
    assert port_physical.SERIES_MASK_LUT_CAP == 1 << 22
    sels = [port_parser.parse_sql(_wide_sql(i))[0] for i in (1, 2)]
    r0 = DISPATCH_STATS["grid_batch_refused"]
    assert wide_db.engine.execute_select_batch(sels) is None
    assert DISPATCH_STATS["grid_batch_refused"] == r0 + 1
    # two of the three tags fit (166^2 entries): that batch stacks
    two = [port_parser.parse_sql(_wide_sql(i).replace(
        f" AND c = 'x{i}'", ""))[0] for i in (1, 2)]
    assert wide_db.engine.execute_select_batch(two) is not None
    # through the scheduler the refused group runs solo, rows intact
    want = {i: wide_db.sql(_wide_sql(i)).rows for i in range(4)}
    got: dict = {}
    errors: list = []

    def client(i):
        try:
            got[i] = wide_db.scheduler.submit(_wide_sql(i % 4))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    for i, res in got.items():
        assert res.rows == want[i % 4]
        assert len(res.rows) == 1


# ---------------------------------------------------------------------------
# Through the scheduler: coalesced batches, member == solo
# ---------------------------------------------------------------------------

def _rounds(sched, make_sql, want, clients=12, rounds=20, formed=None):
    """Closed-loop saturated rounds of ``clients`` threads until
    ``formed()`` says a stacked batch happened (or ``rounds`` pass)."""
    results: dict = {}
    errors: list = []

    def client(i):
        try:
            results[i] = sched.submit(make_sql(i))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    for _ in range(rounds):
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        for i, res in results.items():
            w = want(i)
            assert res.column_names == w.column_names
            assert res.rows == w.rows  # BIT-exact
        if formed():
            return True
    return formed()


class TestSchedulerBatching:
    def test_stacked_dispatch_bit_exact(self, db):
        sched = db.scheduler
        assert sched is not None
        solo = {w: db.sql(_window_sql(w)) for w in range(HOURS)}
        b0 = REGISTRY.value("greptime_scheduler_batched_queries_total")
        assert _rounds(
            sched, lambda i: _window_sql(i % HOURS),
            lambda i: solo[i % HOURS],
            formed=lambda: REGISTRY.value(
                "greptime_scheduler_batched_queries_total") > b0), (
            "no stacked dispatch formed across 20 saturated rounds")
        assert sched.largest_batch > 1

    def test_tag_filtered_stacked_dispatch_bit_exact(self, db, ref_db):
        sched = db.scheduler
        solo = {i: db.sql(_host_sql(i)) for i in range(HOSTS)}
        for i in range(HOSTS):
            rows_close(solo[i].rows, ref_db.sql(_host_sql(i)).rows)
        b0 = DISPATCH_STATS["grid_batch"]
        assert _rounds(
            sched, lambda i: _host_sql(i % HOSTS),
            lambda i: solo[i % HOSTS],
            formed=lambda: DISPATCH_STATS["grid_batch"] > b0), (
            "no tag-filtered stacked dispatch formed in 20 rounds")

    def test_batching_off_serves_solo(self, db):
        from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

        s = QueryScheduler(db, workers=1, batching=False)
        try:
            b0 = DISPATCH_STATS["grid_batch"]
            solo = {i: db.sql(_host_sql(i)) for i in range(HOSTS)}
            _rounds(s, lambda i: _host_sql(i % HOSTS),
                    lambda i: solo[i % HOSTS], rounds=2,
                    formed=lambda: False)
            assert DISPATCH_STATS["grid_batch"] == b0
            assert s.batches == 0
        finally:
            s.stop()


# ---------------------------------------------------------------------------
# Kernel library loading from concurrent workers
# ---------------------------------------------------------------------------

def test_first_use_from_two_workers_builds_once(monkeypatch):
    """Two scheduler workers reaching the kernels at once: the library is
    built and bound once, under the module lock (the build is stubbed: the
    CPU has no nvcc)."""
    built: list = []
    gate = threading.Event()

    def fake_build_many(specs, force=False):
        gate.wait(5)
        built.append(specs)
        time.sleep(0.05)
        return [lib for _src, lib, _flags in specs]

    class FakeFn:
        argtypes = None
        restype = None

    class FakeLib:
        def __getattr__(self, name):
            fn = FakeFn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(gk, "_lib", None)
    monkeypatch.setattr(gk.cuda_build, "build_many", fake_build_many)
    monkeypatch.setattr(gk.ctypes, "CDLL", lambda path: FakeLib())
    got: list = []
    threads = [threading.Thread(target=lambda: got.append(gk._load()))
               for _ in range(2)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].gt_group_merge_stacked_sum.argtypes is not None
    assert got[0].gt_series_mask.argtypes is not None


# ---------------------------------------------------------------------------
# The reference's scheduler cases whose subsystems the port has
# ---------------------------------------------------------------------------

def _occupied(s):
    """Occupy the scheduler's only worker with background fn work; returns
    (release event, its thread)."""
    release = threading.Event()
    started = threading.Event()

    def occupy():
        started.set()
        release.wait(5)

    t = threading.Thread(
        target=lambda: s.submit_fn(occupy, priority="background"))
    t.start()
    assert started.wait(5)
    return release, t


def _wait_queued(s, n):
    deadline = time.time() + 5
    while time.time() < deadline:
        with s._cond:
            if sum(len(q) for q in s._queues.values()) >= n:
                return True
        time.sleep(0.005)
    return False


class TestTenantAdmission:
    def test_rate_quota_rejects_then_refills(self, db):
        sched = db.scheduler
        sched.admission.set_quota("rate_t", qps=20.0, burst=2)
        assert sched.submit("SELECT 1", tenant="rate_t").rows == [[1]]
        with pytest.raises(RateLimited) as ei:
            for _ in range(8):
                sched.submit("SELECT 1", tenant="rate_t")
        assert "over rate quota" in str(ei.value)
        time.sleep(0.15)
        assert sched.submit("SELECT 1", tenant="rate_t").rows == [[1]]
        assert REGISTRY.value("greptime_scheduler_rejected_total",
                              ("rate_t", "rate")) >= 1

    def test_memory_quota_without_workload_manager(self, db):
        """The port has no workload memory manager yet: as in the
        reference with none, a memory quota is recorded but not
        enforced."""
        sched = db.scheduler
        assert sched.admission.memory is None
        sched.admission.set_quota("mem_t", mem_bytes=sched.query_est_bytes // 2)
        assert sched.submit("SELECT 1", tenant="mem_t").rows == [[1]]
        assert sched.admission.usage()["mem_t"]["mem_bytes"] == (
            sched.query_est_bytes // 2)

    def test_concurrency_quota_and_try_admit_fallback(self, db):
        sched = db.scheduler
        sched.admission.set_quota("cc_t", max_inflight=1)
        sched.admission.admit("cc_t")
        try:
            with pytest.raises(RateLimited):
                sched.admission.admit("cc_t")
            assert sched.admission.try_admit("cc_t") is False
        finally:
            sched.admission.release("cc_t")
        assert sched.admission.try_admit("cc_t") is True
        sched.admission.release("cc_t")

    def test_queue_full_backpressure(self, db):
        from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

        s = QueryScheduler(db, workers=1, max_queue=1, batching=False)
        release, t = _occupied(s)
        t2 = threading.Thread(
            target=lambda: s.submit_fn(lambda: None, priority="background"))
        t2.start()
        assert _wait_queued(s, 1)
        with pytest.raises(ResourcesExhausted) as ei:
            s.submit_fn(lambda: None, priority="background")
        assert "queue full" in str(ei.value)
        release.set()
        t.join(5)
        t2.join(5)
        s.stop()
        assert not t.is_alive() and not t2.is_alive()


class TestPriorities:
    def test_interactive_overtakes_background_queue(self, db):
        from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

        s = QueryScheduler(db, workers=1, batching=False)
        order: list[str] = []
        release, t0 = _occupied(s)
        threads = [t0]
        for prio in ("background", "background", "interactive"):
            threads.append(threading.Thread(
                target=lambda p=prio: s.submit_fn(
                    lambda: order.append(p), priority=p)))
            threads[-1].start()
        assert _wait_queued(s, 3)
        release.set()
        for t in threads:
            t.join(5)
        assert order[0] == "interactive", order
        s.stop()

    def test_scan_pool_yields_to_interactive(self):
        from greptimedb_tpu_torch.serving import scheduler as sched_mod
        from greptimedb_tpu_torch.storage import scan
        from greptimedb_tpu_torch.storage.scan import scan_threads

        assert scan.background_yield_hook is sched_mod.background_should_yield
        assert scan_threads(8) >= 1
        sched_mod._worker_local.priority = "background"
        try:
            with sched_mod._wait_lock:
                sched_mod._interactive_waiting += 1
            try:
                assert sched_mod.background_should_yield() is True
                assert scan_threads(8) == 1
            finally:
                with sched_mod._wait_lock:
                    sched_mod._interactive_waiting -= 1
            assert sched_mod.background_should_yield() is False
        finally:
            sched_mod._worker_local.priority = None

    def test_statement_classification(self, db):
        s = db.scheduler
        parse = port_parser.parse_sql
        assert s.classify(parse("SELECT 1")) == "interactive"
        assert s.classify(parse("INSERT INTO cpu VALUES "
                                "('x', 1, 1.0, 1.0)")) == "normal"
        assert s.classify(parse("COPY cpu TO '/tmp/x.parquet'")) == (
            "background")
        assert s.classify(parse("ADMIN flush_table('cpu')")) == "background"


class TestAdaptiveLinger:
    def test_effective_linger_scales_with_pressure(self, db):
        from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

        s = QueryScheduler(db, workers=1)
        s.linger_ms = 100.0
        s._sqlish_inflight["interactive"] = 1
        assert s._effective_linger_s("interactive", 1) == 0.0
        s._sqlish_inflight["interactive"] = 1 + s.max_batch // 2
        mid = s._effective_linger_s("interactive", 1)
        assert 0.0 < mid < 0.1
        s._sqlish_inflight["interactive"] = 1 + s.max_batch
        assert s._effective_linger_s("interactive", 1) == 0.1
        assert s._effective_linger_s("background", 1) == 0.0
        s._sqlish_inflight["interactive"] = 0
        s.stop()

    def test_idle_path_p50_pays_no_linger(self, db):
        from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

        s = QueryScheduler(db, workers=1)
        s.linger_ms = 250.0
        try:
            s.submit(_window_sql(0))
            lat_ms = []
            for _ in range(9):
                t0 = time.perf_counter()
                s.submit(_window_sql(0))
                lat_ms.append((time.perf_counter() - t0) * 1000)
            assert sorted(lat_ms)[len(lat_ms) // 2] < 250.0
        finally:
            s.stop()


class TestDeadlines:
    def test_queued_entry_sheds_at_deadline(self, db):
        from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

        s = QueryScheduler(db, workers=1, batching=False)
        release, t = _occupied(s)
        shed0 = REGISTRY.value("greptime_scheduler_shed_total",
                               ("interactive",))
        err: list = []

        def victim():
            try:
                s.submit("SELECT 1", timeout_s=0.05)
            except Exception as e:  # noqa: BLE001
                err.append(e)

        v = threading.Thread(target=victim)
        v.start()
        time.sleep(0.2)
        release.set()
        v.join(5)
        t.join(5)
        assert err and isinstance(err[0], DeadlineExceeded), err
        assert REGISTRY.value("greptime_scheduler_shed_total",
                              ("interactive",)) > shed0
        s.stop()

    def test_stop_cancels_queued(self, db):
        from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

        s = QueryScheduler(db, workers=1, batching=False)
        release, t = _occupied(s)
        errs: list = []

        def queued():
            try:
                s.submit("SELECT 1")
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        q = threading.Thread(target=queued)
        q.start()
        assert _wait_queued(s, 1)
        release.set()
        s.stop()
        q.join(5)
        t.join(5)
        assert errs and isinstance(errs[0], Cancelled)


class TestObservability:
    def test_queue_depth_gauge_and_wait_histogram(self, db):
        db.scheduler.submit("SELECT 1")
        text = REGISTRY.render()
        assert ('greptime_scheduler_queue_depth{priority="interactive"}'
                in text)
        assert REGISTRY.value("greptime_scheduler_wait_seconds",
                              ("interactive",)) > 0

    def test_scheduler_span_in_trace(self, db):
        from greptimedb_tpu_torch.utils.tracing import TRACER

        try:
            TRACER.configure()
            mark = TRACER.mark()
            db.scheduler.submit("SELECT 1")
            spans = TRACER.since(mark)
            sched_span = next(s for s in spans if s["name"] == "scheduler")
            assert "wait_ms" in sched_span.get("attributes", {})
        finally:
            TRACER.disable()

    def test_processlist_sees_queued_entries(self, db):
        from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

        s = QueryScheduler(db, workers=1, batching=False)
        release, t = _occupied(s)
        marker = "SELECT 424242"
        q = threading.Thread(target=lambda: s.submit(marker))
        q.start()
        deadline = time.time() + 5
        seen = False
        while time.time() < deadline and not seen:
            seen = any(marker in p.query for p in db.processes.list())
            time.sleep(0.005)
        release.set()
        q.join(5)
        t.join(5)
        s.stop()
        assert seen, "queued entry never appeared in the process list"
        assert not any(marker in p.query for p in db.processes.list())

    def test_closed_db_is_not_held_by_the_registry(self):
        """The process-wide registry's queue-depth gauges must not keep a
        closed db (and the device memory its caches hold) alive."""
        import gc
        import weakref

        d = GreptimeDB(device="cpu")
        d.sql("CREATE TABLE t (h STRING, ts TIMESTAMP(3) TIME INDEX, "
              "v DOUBLE, PRIMARY KEY (h))")
        d.sql("INSERT INTO t VALUES ('a', 1000, 1.0)")
        assert d.scheduler.submit("SELECT h, avg(v) FROM t GROUP BY h"
                                  ).rows == [["a", 1.0]]
        ref = weakref.ref(d)
        d.close()
        del d
        gc.collect()
        assert ref() is None
        assert ('greptime_scheduler_queue_depth{priority="interactive"} 0'
                in REGISTRY.render())

    def test_session_entry_swaps_db_and_timezone(self, db):
        res, sdb, tz = db.scheduler.submit_session(
            "SELECT 1", "public", "Asia/Shanghai")
        assert res.rows == [[1]] and sdb == "public"
        assert tz == "Asia/Shanghai" and db.timezone == "UTC"


# ---------------------------------------------------------------------------
# The off knobs: the serving package (or its SLO half) never imported
# ---------------------------------------------------------------------------

OFF_CODE = {
    "scheduler": """
import os, sys
os.environ["GREPTIME_SCHEDULER"] = "off"
from greptimedb_tpu_torch.standalone import GreptimeDB
d = GreptimeDB(device="cpu")
assert d.scheduler is None and d.slo is None
d.sql("CREATE TABLE t (h STRING, ts TIMESTAMP(3) TIME INDEX, v DOUBLE, "
      "PRIMARY KEY (h))")
d.sql("INSERT INTO t VALUES ('a', 1000, 1.0)")
assert d.sql("SELECT h, avg(v) FROM t GROUP BY h").rows == [["a", 1.0]]
assert not [m for m in sys.modules if m.startswith("greptimedb_tpu_torch.serving")]
assert "jax" not in sys.modules and "greptimedb_tpu" not in sys.modules
d.close()
print("OFF-PIN-OK")
""",
    "slo": """
import os, sys
os.environ["GREPTIME_SLO"] = "off"
from greptimedb_tpu_torch.standalone import GreptimeDB
d = GreptimeDB(device="cpu")
assert d.slo is None and d.idle_economy is None
d.sql("CREATE TABLE t (h STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, "
      "PRIMARY KEY(h))")
d.sql("INSERT INTO t VALUES ('a', 1000, 1.0)")
assert d.scheduler.slo is None and d.scheduler.idle_economy is None
assert d.scheduler.submit("SELECT count(v) FROM t").rows[0][0] == 1
d.scheduler.add_idle_hook(lambda: False, kick=False)
d.scheduler.add_idle_hook(lambda: False, kick=False)
assert getattr(d.scheduler.idle_hook, "_gl_hooks", None) is not None
assert "greptimedb_tpu_torch.serving.slo" not in sys.modules
assert "greptimedb_tpu_torch.serving.idle" not in sys.modules
d.close()
print("OFF-PIN-OK")
""",
}


@pytest.mark.parametrize("knob", sorted(OFF_CODE))
def test_off_knob_never_imports(knob):
    out = subprocess.run([sys.executable, "-c", OFF_CODE[knob]],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OFF-PIN-OK" in out.stdout


def test_off_knob_keeps_metrics_silent(monkeypatch):
    monkeypatch.setenv("GREPTIME_SCHEDULER", "off")
    d = GreptimeDB(device="cpu")
    try:
        before = REGISTRY.value("greptime_scheduler_executed_total",
                                ("interactive",))
        assert d.scheduler is None
        d.sql("SELECT 1")
        assert REGISTRY.value("greptime_scheduler_executed_total",
                              ("interactive",)) == before
    finally:
        d.close()


# ---------------------------------------------------------------------------
# tests/test_slo.py's cases against the port's serving/slo.py and idle.py
# ---------------------------------------------------------------------------

ALPHA = 0.01
PARAMS = sketch_params(ALPHA)


def _rank_quantile(vals, q):
    s = np.sort(vals)
    return float(s[max(1, math.ceil(q * len(s))) - 1])


class TestSketchAccuracy:
    DISTS = (
        ("lognormal", lambda r, n: r.lognormal(-3.0, 1.0, n)),
        ("uniform", lambda r, n: r.uniform(0.001, 2.0, n)),
        ("exponential", lambda r, n: r.exponential(0.05, n)),
    )

    @pytest.mark.parametrize("seed", [7, 21, 99])
    def test_quantiles_within_relative_error_fuzzed(self, seed):
        rng = np.random.default_rng(seed)
        for name, gen in self.DISTS:
            vals = np.clip(gen(rng, 5000), 2e-4, 5e3)
            sk = LatencySketch(PARAMS)
            for v in vals:
                sk.observe(float(v))
            assert sk.n == 5000
            for q in (0.50, 0.90, 0.99, 0.999):
                est = sk.quantile(q)
                true = _rank_quantile(vals, q)
                assert abs(est - true) / true <= 2 * ALPHA, (name, q)

    def test_same_quantiles_as_the_reference(self):
        from greptimedb_tpu.serving.slo import LatencySketch as RefSketch
        from greptimedb_tpu.serving.slo import sketch_params as ref_params

        vals = np.clip(np.random.default_rng(4).lognormal(-2, 1, 2000),
                       2e-4, 5e3)
        a, b = LatencySketch(PARAMS), RefSketch(ref_params(ALPHA))
        for v in vals:
            a.observe(float(v))
            b.observe(float(v))
        assert a.counts == b.counts
        for q in (0.5, 0.9, 0.99):
            assert a.quantile(q) == b.quantile(q)

    def test_merge_equals_observing_everything(self):
        rng = np.random.default_rng(13)
        vals = np.clip(rng.lognormal(-2.5, 1.2, 3000), 2e-4, 5e3)
        whole = LatencySketch(PARAMS)
        parts = [LatencySketch(PARAMS) for _ in range(3)]
        for i, v in enumerate(vals):
            whole.observe(float(v))
            parts[i % 3].observe(float(v))
        merged = LatencySketch(PARAMS)
        for p in parts:
            merged.merge(p)
        assert merged.counts == whole.counts
        assert merged.n == whole.n
        assert merged.sum == pytest.approx(whole.sum)
        for q in (0.5, 0.99):
            assert merged.quantile(q) == whole.quantile(q)

    def test_range_clamps_never_raise(self):
        sk = LatencySketch(PARAMS)
        sk.observe(0.0)
        sk.observe(1e-9)
        sk.observe(1e9)
        assert sk.n == 3
        assert sk.quantile(0.0) == _MIN_S
        assert sk.quantile(1.0) >= 1e3

    def test_empty_sketch_has_no_quantile(self):
        assert LatencySketch(PARAMS).quantile(0.5) is None


def _engine(monkeypatch, **env):
    defaults = {
        "GREPTIME_SLO_MIN_SAMPLES": "10",
        "GREPTIME_SLO_OBJECTIVE": "0.999",
        "GREPTIME_SLO_THRESHOLD_MS": "500",
    }
    defaults.update(env)
    for k, v in defaults.items():
        monkeypatch.setenv(k, str(v))
    t = [10_000.0]
    return SloEngine(clock=lambda: t[0]), t


class TestBurnWindows:
    KEY = ("default", "interactive", "http")

    def _record(self, eng, n, bad=0, seconds=0.01):
        for _ in range(n - bad):
            eng.record(*self.KEY, seconds)
        for _ in range(bad):
            eng.record(*self.KEY, 10.0)

    def test_goldens(self, monkeypatch):
        eng, _t = _engine(monkeypatch)
        assert eng.burn_rate(self.KEY, "5m") == 0.0
        assert eng.budget_remaining(self.KEY) == 1.0
        self._record(eng, 1000)
        assert eng.burn_rate(self.KEY, "5m") == 0.0
        self._record(eng, 5, bad=5)
        for w in ("5m", "30m", "1h", "6h"):
            assert eng.burn_rate(self.KEY, w) == pytest.approx(
                (5 / 1005) / 0.001, rel=1e-6), w
        assert eng.budget_remaining(self.KEY) == pytest.approx(
            max(0.0, 1.0 - (5 / 1005) / 0.001))

    def test_short_window_forgets_the_storm(self, monkeypatch):
        eng, t = _engine(monkeypatch)
        self._record(eng, 100, bad=50)
        assert eng.burn_rate(self.KEY, "5m") > 0
        t[0] += 6 * 60.0
        assert eng.burn_rate(self.KEY, "5m") == 0.0
        assert eng.burn_rate(self.KEY, "1h") > 0
        t[0] += 60 * 60.0
        assert eng.burn_rate(self.KEY, "1h") == 0.0
        assert eng.burn_rate(self.KEY, "6h") > 0

    def test_alert_fires_during_storm_and_clears(self, monkeypatch):
        eng, t = _engine(monkeypatch)
        self._record(eng, 600, bad=30)
        assert "fast" in {a["severity"] for a in eng.alerts()}
        assert eng.fast_burn_active()
        t[0] += 6 * 60.0
        self._record(eng, 600)
        t[0] += 2.0
        assert eng.burn_rate(self.KEY, "1h") > 14.4
        assert not eng.fast_burn_active()

    def test_min_samples_gates_thin_traffic(self, monkeypatch):
        eng, _t = _engine(monkeypatch)
        self._record(eng, 5, bad=5)
        assert eng.burn_rate(self.KEY, "5m") > 900
        assert eng.alerts() == []
        assert not eng.fast_burn_active()

    def test_tenant_overrides_and_class_factors(self, monkeypatch):
        eng, _t = _engine(
            monkeypatch, GREPTIME_SLO_OVERRIDES="acme=250:0.99, bad==,x")
        assert eng.objective_for("acme", "interactive") == (0.25, 0.99)
        assert eng.objective_for("acme", "background") == (
            pytest.approx(5.0), 0.99)
        assert eng.objective_for("other", "interactive") == (0.5, 0.999)
        eng.set_objective("other", 1.0)
        thr, obj = eng.objective_for("other", "interactive")
        assert thr == pytest.approx(0.001) and obj == 0.999

    def test_adaptive_timeout_needs_evidence(self, monkeypatch):
        eng, _t = _engine(monkeypatch)
        assert eng.adaptive_timeout_s("interactive") is None
        for _ in range(300):
            eng.record("default", "interactive", "http", 0.05)
        assert eng.adaptive_timeout_s("interactive") == 30.0
        for _ in range(300):
            eng.record("default", "normal", "http", 10.0)
        assert eng.adaptive_timeout_s("normal") == pytest.approx(
            80.0, rel=0.05)

    def test_admit_background_scales_with_budget(self, monkeypatch):
        eng, _t = _engine(monkeypatch, GREPTIME_SLO_ADMIT_MS="60000")
        ok, allowance = eng.admit_background(50_000)
        assert ok and allowance == 60_000
        self._record(eng, 100, bad=50)
        ok, allowance = eng.admit_background(50_000)
        assert not ok and allowance == 0.0
        assert eng.admit_background(0)[0]

    def test_status_rows_render_every_key(self, monkeypatch):
        eng, _t = _engine(monkeypatch)
        eng.record("a", "interactive", "http", 0.01)
        eng.record("b", "background", "sql", 2.0)
        rows = eng.status_rows()
        assert [(r["tenant"], r["class"]) for r in rows] == [
            ("a", "interactive"), ("b", "background")]
        assert rows[0]["total"] == 1 and rows[0]["breached"] == 0
        assert rows[1]["p50_ms"] == pytest.approx(2000.0, rel=2 * ALPHA)
        assert eng.total_recorded() == 2


class TestIdleEconomy:
    def _eco(self, monkeypatch, t, **env):
        defaults = {"GREPTIME_IDLE_QUANTUM_MS": "20",
                    "GREPTIME_IDLE_STARVE_TICKS": "64"}
        defaults.update(env)
        for k, v in defaults.items():
            monkeypatch.setenv(k, str(v))
        return IdleEconomy(clock=lambda: t[0])

    def test_weighted_time_split_deterministic(self, monkeypatch):
        t = [0.0]
        eco = self._eco(monkeypatch, t)
        ledger = {"a": 0.040, "b": 0.020}

        def consumer(name):
            def fn():
                t[0] += ledger[name]
                return True
            return fn

        eco.register(consumer("a"), name="a", weight=2.0)
        eco.register(consumer("b"), name="b", weight=1.0)
        for _ in range(60):
            assert eco.tick() is True
        by = {c["name"]: c for c in eco.consumers()}
        assert by["a"]["granted"] == 40 and by["b"]["granted"] == 20
        assert by["a"]["elapsed_ms"] == pytest.approx(
            4 * by["b"]["elapsed_ms"])
        assert by["a"]["starved"] == 0 and by["b"]["starved"] == 0

    def test_greedy_cannot_starve_the_meek(self, monkeypatch):
        t = [0.0]
        eco = self._eco(monkeypatch, t)

        def greedy():
            t[0] += 1.0
            return True

        def meek():
            t[0] += 0.001
            return True

        eco.register(greedy, name="greedy", weight=1.0)
        eco.register(meek, name="meek", weight=1.0)
        for _ in range(80):
            eco.tick()
        by = {c["name"]: c for c in eco.consumers()}
        assert by["meek"]["granted"] > 5 * by["greedy"]["granted"]
        assert by["meek"]["starved"] == 0

    def test_starvation_bound_guarantees_liveness(self, monkeypatch):
        t = [0.0]
        eco = self._eco(monkeypatch, t, GREPTIME_IDLE_STARVE_TICKS="5")
        eco.register(lambda: True, name="rich", weight=1.0)
        eco.register(lambda: True, name="zero", weight=0.0)
        for _ in range(20):
            eco.tick()
        by = {c["name"]: c for c in eco.consumers()}
        assert by["zero"]["granted"] >= 2
        assert by["zero"]["starved"] == by["zero"]["granted"]
        assert (REGISTRY.value("greptime_idle_starved_total",
                               ("zero",)) or 0) >= 2

    def test_drain_unhook_and_resurrect(self, monkeypatch):
        t = [0.0]
        eco = self._eco(monkeypatch, t)
        calls = []

        def once():
            calls.append(1)
            return False

        name = eco.register(once, name="once")
        assert eco.tick() is False
        assert len(calls) == 1
        assert eco.register(once) == name
        assert [c["name"] for c in eco.consumers()] == [name]
        assert eco.tick() is False
        assert len(calls) == 2

    def test_fast_burn_throttles_every_consumer(self, monkeypatch):
        t = [0.0]

        class FakeSlo:
            burning = True

            def fast_burn_active(self):
                return self.burning

        slo = FakeSlo()
        for k, v in (("GREPTIME_IDLE_QUANTUM_MS", "20"),
                     ("GREPTIME_IDLE_STARVE_TICKS", "64")):
            monkeypatch.setenv(k, v)
        eco = IdleEconomy(slo=slo, clock=lambda: t[0])
        granted = []
        eco.register(lambda: granted.append(1) or True, name="w")
        for _ in range(5):
            assert eco.tick() is True
        assert granted == [] and eco.throttled == 5
        slo.burning = False
        eco.tick()
        assert granted == [1]

    def test_exceptions_drain_not_kill(self, monkeypatch):
        t = [0.0]
        eco = self._eco(monkeypatch, t)

        def boom():
            raise RuntimeError("consumer bug")

        eco.register(boom, name="boom")
        eco.register(lambda: True, name="ok")
        assert eco.tick() in (True, False)
        assert eco.tick() is True
        by = {c["name"]: c for c in eco.consumers()}
        assert by["boom"]["drained"]


class TestSchedulerAccounting:
    """Exactly one sketch sample per scheduler entry — success, error and
    caller-held paths — on the port's db."""

    @pytest.fixture()
    def sdb(self):
        d = GreptimeDB(device="cpu")
        d.sql("CREATE TABLE cpu (h STRING, ts TIMESTAMP TIME INDEX, "
              "v DOUBLE, PRIMARY KEY(h))")
        d.sql("INSERT INTO cpu VALUES ('a', 1000, 1.0), ('a', 2000, 2.0)")
        yield d
        d.close()

    def test_every_submit_lands_in_exactly_one_sketch(self, sdb):
        assert sdb.scheduler is not None and sdb.slo is not None
        base = sdb.slo.total_recorded()
        for i in range(12):
            sdb.scheduler.submit(f"SELECT count(v) FROM cpu WHERE v > {i}")
        for _ in range(3):
            with pytest.raises(Exception):
                sdb.scheduler.submit("SELECT definitely_no_such_col "
                                     "FROM cpu")
        assert sdb.slo.total_recorded() == base + 15

    def test_held_sample_defers_to_the_caller(self, sdb):
        base = sdb.slo.total_recorded()
        hold = []
        sdb.scheduler.submit("SELECT count(v) FROM cpu", slo_hold=hold)
        assert sdb.slo.total_recorded() == base
        assert len(hold) == 1
        sdb.scheduler.record_held(hold)
        assert sdb.slo.total_recorded() == base + 1
        assert hold == []

    def test_error_with_hold_records_immediately(self, sdb):
        base = sdb.slo.total_recorded()
        hold = []
        with pytest.raises(Exception):
            sdb.scheduler.submit("SELECT nope FROM cpu", slo_hold=hold)
        assert sdb.slo.total_recorded() == base + 1
        sdb.scheduler.record_held(hold)
        assert sdb.slo.total_recorded() == base + 1

    def test_fast_burn_rejects_background_admission(self, sdb):
        sdb.slo.fast_burn_active = lambda: True
        try:
            with pytest.raises(ResourcesExhausted):
                sdb.scheduler.submit("SELECT count(v) FROM cpu",
                                     priority="background")
            assert (REGISTRY.value("greptime_scheduler_rejected_total",
                                   ("default", "slo_budget")) or 0) >= 1
        finally:
            del sdb.slo.fast_burn_active
