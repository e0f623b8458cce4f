"""Port parity: the plain versions of bucket_reduce and group_merge
against the JAX reference's jitted grid programs.

- K1: ``Executor._bucket_major_partials`` (per-(series, bucket) sums and
  validity counts, ``greptimedb_tpu/query/physical.py:1129``);
- K2: ``Executor._bm_kernel_fn`` (window slice + tag WHERE + series merge,
  ``:1176``);
- K3: ``Executor._build_grid_kernel`` (dynamic-slice window reduce,
  ``:1255``).

Inputs are made from a seed with numpy and handed to both packages.  On
the CPU the port's wrappers take the plain versions, so the launch
counters must stay at 0.  Tolerances: integers, counts, masks, keys, min
and max exact; float sums and means ``|a-b| <= 1e-5*max(1,|b|)`` (the
golden comparer's bound, tests/test_golden.py).  The last test runs the
CUDA kernels against the plain versions and needs the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.datatypes.batch import DictionaryEncoder as RefEncoder
from greptimedb_tpu.datatypes.schema import ColumnSchema as RefColumn
from greptimedb_tpu.datatypes.schema import Schema as RefSchema
from greptimedb_tpu.datatypes.types import ConcreteDataType as RefType
from greptimedb_tpu.datatypes.types import SemanticType as RefSem
from greptimedb_tpu.errors import PlanError as RefPlanError
from greptimedb_tpu.query.ast import Column, FuncCall, InList, Literal
from greptimedb_tpu.query.exprs import TableContext as RefCtx
from greptimedb_tpu.query.exprs import compile_device as ref_compile
from greptimedb_tpu.query.physical import Executor as RefExecutor
from greptimedb_tpu.storage.grid import GridTable as RefGrid
from greptimedb_tpu_torch.datatypes.batch import DictionaryEncoder
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType, SemanticType
from greptimedb_tpu_torch.errors import PlanError, Unsupported
from greptimedb_tpu_torch.ops import grid_kernels as gk
from greptimedb_tpu_torch.query import ast as port_ast
from greptimedb_tpu_torch.query.exprs import TableContext
from greptimedb_tpu_torch.query.exprs import compile_device
from greptimedb_tpu_torch.query.physical import Executor
from greptimedb_tpu_torch.storage.grid import grid_from_numpy

REL = 1e-5
FIELDS = ("a", "b", "c")
STEP = 10_000
TS0 = 1_451_606_400_000


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


def make_arrays(seed, spad=64, tpad=256, num_series=50, nan_field=None,
                hosts=23):
    """Grid arrays as storage/grid.py lays them out: zero-filled invalid
    cells, -1 tag codes on padding series, several series per host."""
    rng = np.random.default_rng(seed)
    c = len(FIELDS)
    valid = np.zeros((spad, tpad), bool)
    valid[:num_series, :200] = rng.random((num_series, 200)) > 0.1
    values = (rng.random((c, spad, tpad)) * 100).astype(np.float32)
    values *= valid
    if nan_field is not None:
        nanmask = valid & (rng.random((spad, tpad)) < 0.05)
        values[nan_field][nanmask] = np.nan
    host = np.full(spad, -1, np.int32)
    host[:num_series] = rng.integers(0, hosts, num_series)
    dc = np.full(spad, -1, np.int32)
    dc[:num_series] = rng.integers(0, 3, num_series)
    no_nan = tuple(bool(np.isfinite(values[i][valid]).all()) for i in range(c))
    return dict(values=values, valid=valid,
                tag_codes={"host": host, "dc": dc}, no_nan=no_nan,
                num_series=num_series, hosts=hosts)


def both_grids(arrs):
    dicts = {"host": [f"h{i}" for i in range(arrs["hosts"])],
             "dc": ["d0", "d1", "d2"]}
    ref = RefGrid(
        values=jnp.asarray(arrs["values"]), valid=jnp.asarray(arrs["valid"]),
        tag_codes={k: jnp.asarray(v) for k, v in arrs["tag_codes"].items()},
        ts0=TS0, step=STEP, nt=200, num_series=arrs["num_series"],
        field_names=FIELDS, dicts=dicts, no_nan=arrs["no_nan"],
        dicts_version=1, region_id=1)
    port = grid_from_numpy(
        arrs["values"], arrs["valid"], arrs["tag_codes"], ts0=TS0, step=STEP,
        nt=200, num_series=arrs["num_series"], field_names=FIELDS,
        dicts=dicts, no_nan=arrs["no_nan"], device="cpu", region_id=1)
    return ref, port, dicts


def contexts(dicts):
    ref_schema = RefSchema((
        RefColumn("host", RefType.STRING, RefSem.TAG),
        RefColumn("dc", RefType.STRING, RefSem.TAG),
        RefColumn("ts", RefType.TIMESTAMP_MILLISECOND, RefSem.TIMESTAMP),
        *(RefColumn(f, RefType.FLOAT64) for f in FIELDS)))
    schema = Schema.from_dict(ref_schema.to_dict())
    ref = RefCtx(ref_schema, {k: RefEncoder(v) for k, v in dicts.items()})
    port = TableContext(schema, {k: DictionaryEncoder(v)
                                 for k, v in dicts.items()})
    return ref, port


@pytest.fixture(autouse=True)
def _launches_stay_zero():
    gk.reset_launch_counts()
    yield
    assert gk.bucket_reduce.launches == 0
    assert gk.group_merge.launches == 0
    assert gk.group_merge_pair.launches == 0


# ---------------------------------------------------------------------------
# K1 — bucket-major partials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,pad_left", [(8, 0), (8, 3), (36, 0), (36, 35),
                                        (256, 0), (1, 0)])
def test_k1_bucket_major_partials(r, pad_left):
    arrs = make_arrays(1)
    ref_grid, port_grid, _ = both_grids(arrs)
    nb = -(-(pad_left + ref_grid.tpad) // r)
    rs, rc = RefExecutor()._bucket_major_partials(ref_grid, r, pad_left, nb)
    ps, pc = Executor()._bucket_major_partials(port_grid, r, pad_left, nb)
    assert ps.dtype == torch.float32 and pc.dtype == torch.float32
    close(ps.numpy(), np.asarray(rs))
    close(pc.numpy(), np.asarray(rc), exact=True)


# ---------------------------------------------------------------------------
# K2 — aligned-window kernel over the partials
# ---------------------------------------------------------------------------

def _bm_specs():
    return [("count(*)", "count", None), ("sum(a)", "sum", 0),
            ("avg(b)", "mean", 1), ("avg(a)", "mean", 0)]


@pytest.mark.parametrize("tag_cols,b_lo,nbw,where", [
    (["host"], 2, 4, None),
    (["host", "dc"], 0, 8, None),
    ([], 1, 3, None),
    (["dc"], 3, 5, "host_in"),
    (["host"], 30, 6, None),    # start past the end: clamps like JAX
    (["host"], -4, 5, "dc_eq"),  # negative start clamps to 0
])
def test_k2_bm_kernel(tag_cols, b_lo, nbw, where):
    arrs = make_arrays(2)
    ref_grid, port_grid, dicts = both_grids(arrs)
    r, nb = 32, 8
    rs, rc = RefExecutor()._bucket_major_partials(ref_grid, r, 0, nb)
    ps, pc = Executor()._bucket_major_partials(port_grid, r, 0, nb)
    rctx, pctx = contexts(dicts)
    ref_where = port_where = None
    if where == "host_in":
        ref_where = ref_compile(InList(Column("host"), (
            Literal("h1"), Literal("h4"), Literal("h9"))), rctx)
        port_where = compile_device(port_ast.InList(port_ast.Column("host"), (
            port_ast.Literal("h1"), port_ast.Literal("h4"),
            port_ast.Literal("h9"))), pctx)
    elif where == "dc_eq":
        from greptimedb_tpu.query.ast import BinaryOp

        ref_where = ref_compile(BinaryOp("=", Column("dc"), Literal("d2")),
                                rctx)
        port_where = compile_device(port_ast.BinaryOp(
            "=", port_ast.Column("dc"), port_ast.Literal("d2")), pctx)
    cards = [{"host": 32, "dc": 4}[t] for t in tag_cols]
    tag_order = tuple(sorted(arrs["tag_codes"]))
    step_q = r * STEP
    ref_k = jax.jit(RefExecutor()._bm_kernel_fn(
        tag_order, tag_cols, cards, nbw, step_q, ref_where, _bm_specs()))
    port_k = Executor()._bm_kernel_fn(
        tag_order, tag_cols, cards, nbw, step_q, port_where, _bm_specs())
    bts0 = TS0 + b_lo * step_q
    want = ref_k(rs, rc, tuple(ref_grid.tag_codes[t] for t in tag_order),
                 np.int32(b_lo), np.int64(bts0))
    got = port_k(ps, pc, tuple(port_grid.tag_codes[t] for t in tag_order),
                 b_lo, bts0)
    assert set(got) == set(want)
    for k in want:
        close(got[k].numpy(), np.asarray(want[k]),
              exact=k.startswith("__") or k == "count(*)")
    assert got["count(*)"].dtype == torch.int64


# ---------------------------------------------------------------------------
# K3 — dynamic-slice window kernel
# ---------------------------------------------------------------------------

def _specs(ctx, compile_fn, col, no_nan):
    """(name, op, arg_fn, no_nan_plain, plain_ci) like _grid_prologue."""
    out = [("count(*)", "count", None, True, None)]
    for i, f in enumerate(FIELDS):
        fn = compile_fn(col(f), ctx)
        out += [(f"avg({f})", "mean", fn, no_nan[i], i),
                (f"min({f})", "min", fn, no_nan[i], i),
                (f"max({f})", "max", fn, no_nan[i], i),
                (f"sum({f})", "sum", fn, no_nan[i], i),
                (f"count({f})", "count", fn, no_nan[i], i)]
    return out


@pytest.mark.parametrize("case", [
    # (s0, w_raw, pad_l, pad_r, r, nbw, aligned, ts window, nan field,
    #  tag cols, where, has_time)
    dict(s0=32, w_raw=96, pad_l=0, pad_r=0, r=32, nbw=3, aligned=True),
    dict(s0=40, w_raw=96, pad_l=5, pad_r=27, r=32, nbw=4, aligned=False),
    dict(s0=0, w_raw=256, pad_l=7, pad_r=25, r=36, nbw=8, aligned=False,
         nan_field=1),
    dict(s0=500, w_raw=64, pad_l=0, pad_r=0, r=16, nbw=4, aligned=False,
         nan_field=2),  # start beyond tpad - w_raw: clamped
    dict(s0=10, w_raw=120, pad_l=0, pad_r=0, r=120, nbw=1, aligned=False,
         tag_cols=[], has_time=False),  # global aggregate
    dict(s0=16, w_raw=128, pad_l=0, pad_r=0, r=32, nbw=4, aligned=True,
         where="host_like"),
    dict(s0=16, w_raw=128, pad_l=0, pad_r=0, r=32, nbw=4, aligned=True,
         where="field_gt", nan_field=0),
])
def test_k3_grid_kernel(case):
    arrs = make_arrays(3, nan_field=case.get("nan_field"))
    ref_grid, port_grid, dicts = both_grids(arrs)
    rctx, pctx = contexts(dicts)
    tag_cols = case.get("tag_cols", ["host"])
    has_time = case.get("has_time", True)
    cards = [{"host": 32, "dc": 4}[t] for t in tag_cols]
    r, nbw = case["r"], case["nbw"]
    step_q = r * STEP if has_time else 0
    where = case.get("where")
    ref_where = port_where = None
    where_series = False
    if where == "host_like":
        from greptimedb_tpu.query.ast import BinaryOp

        ref_where = ref_compile(BinaryOp("LIKE", Column("host"),
                                         Literal("h1%")), rctx)
        port_where = compile_device(port_ast.BinaryOp(
            "LIKE", port_ast.Column("host"), port_ast.Literal("h1%")), pctx)
        where_series = True
    elif where == "field_gt":
        from greptimedb_tpu.query.ast import BinaryOp

        ref_where = ref_compile(BinaryOp(">", Column("a"), Literal(40.0)),
                                rctx)
        port_where = compile_device(port_ast.BinaryOp(
            ">", port_ast.Column("a"), port_ast.Literal(40.0)), pctx)
    tag_order = tuple(sorted(arrs["tag_codes"]))
    args = (FIELDS, "ts", tag_order, tag_cols, cards, has_time, r, nbw,
            case["w_raw"], case["pad_l"], case["pad_r"], step_q)
    tail = (TS0, STEP, case["aligned"])
    ref_k = RefExecutor()._build_grid_kernel(
        *args, ref_where, where_series,
        _specs(rctx, ref_compile, Column, arrs["no_nan"]), *tail)
    port_k = Executor()._build_grid_kernel(
        *args, port_where, where_series,
        _specs(pctx, compile_device, port_ast.Column, arrs["no_nan"]), *tail)
    ts_lo = TS0 + (case["s0"] + 3) * STEP
    ts_hi = TS0 + (case["s0"] + case["w_raw"] - 2) * STEP
    if case["aligned"]:
        ts_lo = TS0 + case["s0"] * STEP
        ts_hi = ts_lo + case["w_raw"] * STEP
    bts0 = TS0 + case["s0"] * STEP
    want = ref_k(ref_grid.values, ref_grid.valid,
                 tuple(ref_grid.tag_codes[t] for t in tag_order),
                 np.int64(ts_lo), np.int64(ts_hi), np.int64(bts0),
                 np.int32(case["s0"]))
    got = port_k(port_grid.values, port_grid.valid,
                 tuple(port_grid.tag_codes[t] for t in tag_order),
                 ts_lo, ts_hi, bts0, case["s0"])
    assert set(got) == set(want)
    for k in want:
        exact = (k.startswith(("__", "count", "min", "max")))
        close(got[k].numpy(), np.asarray(want[k]), exact=exact)


# ---------------------------------------------------------------------------
# the wrappers' plain versions against jax directly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_group_merge_plain_vs_segment_ops(op):
    rng = np.random.default_rng(11)
    s, nb, ngt = 97, 6, 16
    x = (rng.random((2, s, nb)) * 10).astype(np.float32)
    ids = rng.integers(0, ngt + 1, s).astype(np.int32)  # ngt = overflow
    ids[:5] = ngt
    segf = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
            "max": jax.ops.segment_max}[op]
    want = np.stack([np.asarray(segf(jnp.asarray(x[p]), jnp.asarray(ids),
                                     num_segments=ngt + 1)[:ngt])
                     for p in range(2)])
    lay = gk.group_layout(torch.from_numpy(ids), ngt)
    got = gk.group_merge(torch.from_numpy(x), lay, op)
    close(got.numpy(), want, exact=op != "sum")
    # empty groups give the identity
    empty = np.setdiff1d(np.arange(ngt), ids)
    ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
    assert (got.numpy()[:, empty] == ident).all()


def test_group_merge_int64_counts_and_layout():
    ids = torch.tensor([3, 0, 4, 3, 1, 4, 0], dtype=torch.int32)
    lay = gk.group_layout(ids, 4)
    assert lay.order.tolist() == [1, 6, 4, 0, 3, 2, 5]  # stable by group
    assert lay.offsets.tolist() == [0, 2, 3, 3, 5]
    x = torch.arange(14, dtype=torch.int64).reshape(7, 2)
    got = gk.group_merge(x, lay, "sum")
    assert got.dtype == torch.int64
    assert got.tolist() == [[2 + 12, 3 + 13], [8, 9], [0, 0], [0 + 6, 1 + 7]]
    with pytest.raises(ValueError):
        gk.group_merge(x, lay, "min")


def test_bucket_reduce_plain_padding_weight_and_mask():
    x = torch.arange(1, 11, dtype=torch.float32).reshape(1, 10)
    mask = torch.tensor([[True] * 8 + [False] * 2])
    weight = torch.tensor([0, 1, 1, 1, 1, 1, 1, 1], dtype=torch.float32)
    # window x[1:9] → pad 2 left, 2 right → 3 buckets of 4
    got = gk.bucket_reduce(x, "sum", r=4, nb=3, s0=1, w_raw=8, pad_l=2,
                           pad_r=2, weight=weight)
    assert got.tolist() == [[3.0, 4 + 5 + 6 + 7, 8 + 9]]
    got = gk.bucket_reduce(x, "max", r=4, nb=3, s0=1, w_raw=8, pad_l=2,
                           pad_r=2, mask=mask, mask_s0=1)
    assert got.tolist() == [[3.0, 7.0, 8.0]]
    got = gk.bucket_reduce(x, "count", r=4, nb=3, s0=5, w_raw=8, pad_l=2,
                           pad_r=2)  # start 5 clamps to 2
    assert got.tolist() == [[2.0, 4.0, 2.0]]
    with pytest.raises(ValueError):
        gk.bucket_reduce(x, "sum", r=4, nb=3, w_raw=8, pad_l=1, pad_r=1)
    with pytest.raises(TypeError):
        gk.bucket_reduce(x.double(), "sum", r=5, nb=2)


# ---------------------------------------------------------------------------
# the kernels' geometry and the fused pair's plain version, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cells", [4, 16])
@pytest.mark.parametrize("mis", [0, 1, 2, 3, 15])
@pytest.mark.parametrize("lo,hi", [(0, 0), (0, 3), (5, 6), (1, 40),
                                   (330, 690), (0, 360), (7, 7 + 16 * 3)])
def test_bucket_split_covers_the_range(lo, hi, mis, cells):
    """The kernel's head/body/tail split of a bucket's live range: the
    three parts tile [lo, hi), the body is whole vectors that start on a
    16-byte boundary of the row, head and tail are shorter than a
    vector."""
    mis %= cells
    a, e = gk.bucket_split(lo, hi, mis, cells)
    assert lo <= a <= e <= hi
    assert (e - a) % cells == 0
    if e > a:
        assert (a + mis) % cells == 0
    assert a - lo < cells and hi - e < cells
    # every cell of [lo, hi) that starts a whole aligned vector inside the
    # range is in the body
    starts = [t for t in range(lo, hi - cells + 1) if (t + mis) % cells == 0]
    assert (e - a) // cells == len(starts)


def test_bucket_lanes():
    assert gk.bucket_lanes(360, 4) == 32   # TSBS f32: 90 vectors a bucket
    assert gk.bucket_lanes(360, 1) == 8    # the u8 valid plane: 22.5
    assert gk.bucket_lanes(36, 4) == 4
    assert gk.bucket_lanes(8, 4) == 1
    assert gk.bucket_lanes(1, 1) == 1
    assert gk.bucket_lanes(100_000, 4) == 32
    for r in range(1, 2000, 37):
        g = gk.bucket_lanes(r, 4)
        assert g & (g - 1) == 0 and 1 <= g <= 32


def _seq_fold(x, order, offsets, factor=None, count=False):
    """A sequential fold in ascending series order, one f32 (or int64)
    accumulator an output, each product rounded before its add: the
    summation order the group kernels document."""
    p, _s, nb = x.shape
    ngt = len(offsets) - 1
    out = np.zeros((p, ngt, nb), np.int64 if count else np.float32)
    for g in range(ngt):
        acc = np.zeros((p, nb), out.dtype)
        for k in range(offsets[g], offsets[g + 1]):
            s = order[k]
            v = x[:, s, :]
            if factor is not None:
                v = (v * np.float32(factor[s])).astype(np.float32)
            if count:
                acc = acc + v.astype(np.int64)   # truncation, as .to(int64)
            else:
                acc = (acc + v).astype(np.float32)
        out[:, g] = acc
    return out


@pytest.mark.parametrize("with_factor", [False, True])
@pytest.mark.parametrize("with_sums", [False, True])
def test_group_merge_pair_plain_is_the_two_merges(with_factor, with_sums):
    """The pair's plain version equals the two group_merge calls the grid
    path made before it (counts times the factor, truncated, then merged
    in int64; sums with the factor), and a sequential ascending fold, bit
    for bit, over window views of the partials."""
    rng = np.random.default_rng(21)
    s, nb, ngt = 90, 11, 13
    ids = rng.integers(0, ngt + 1, s).astype(np.int32)
    lay = gk.group_layout(torch.from_numpy(ids), ngt)
    cfull = rng.integers(0, 361, (s, nb + 4)).astype(np.float32)
    sfull = (rng.random((3, s, nb + 4)) * 1000).astype(np.float32)
    c = torch.from_numpy(cfull)[:, 3:3 + nb]
    sums = torch.from_numpy(sfull)[:, :, 1:1 + nb] if with_sums else None
    fac = (torch.from_numpy((rng.random(s) > 0.3).astype(np.float32))
           if with_factor else None)
    cnt, sg = gk.group_merge_pair(c, sums, lay, factor=fac)
    cw = c if fac is None else c * fac[:, None]
    assert torch.equal(cnt, gk.group_merge(cw.to(torch.int64), lay, "sum"))
    order, offs = lay.order.numpy(), lay.offsets.numpy()
    fnp = None if fac is None else fac.numpy()
    assert np.array_equal(cnt.numpy(), _seq_fold(
        c.numpy()[None], order, offs, fnp, count=True)[0])
    if with_sums:
        assert torch.equal(sg, gk.group_merge(sums, lay, "sum", factor=fac))
        assert np.array_equal(sg.numpy(), _seq_fold(sums.numpy(), order,
                                                     offs, fnp))
    else:
        assert sg is None


def test_bucket_reduce_out_and_layout_checks():
    x = torch.arange(1, 25, dtype=torch.float32).reshape(2, 12)
    buf = torch.full((3, 2, 3), -1.0)
    got = gk.bucket_reduce(x, "sum", r=4, nb=3, out=buf[1])
    assert got.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], gk.bucket_reduce_plain(x, "sum", r=4, nb=3))
    assert (buf[0] == -1).all() and (buf[2] == -1).all()
    with pytest.raises(ValueError):
        gk.bucket_reduce(x, "sum", r=4, nb=3, out=torch.empty(3, 2))
    ids = torch.tensor([0, 1, 1], dtype=torch.int32)
    lay = gk.group_layout(ids, 2)
    with pytest.raises(ValueError):
        gk.GroupLayout(ids, lay.order.long(), lay.offsets, 2)
    with pytest.raises(ValueError):
        gk.GroupLayout(ids, lay.order, lay.offsets[:2], 2)
    with pytest.raises(ValueError):
        gk.GroupLayout(ids, lay.order, lay.offsets.int(), 2)


def test_bucket_reduce_shape_labels():
    x = torch.zeros((2, 3, 40))
    v = torch.zeros((3, 40), dtype=torch.bool)
    geo = dict(r=8, nb=5, pad_l=0, pad_r=0)
    w = gk._window(x, mask=None, mask_s0=None, weight=None, s0=0, w_raw=40,
                   **geo)
    assert gk._shape_label(w, x, "sum") == "f32 sum grid"
    w = gk._window(v, r=8, nb=4, s0=3, w_raw=32, pad_l=0, pad_r=0,
                   mask=v, mask_s0=0, weight=torch.ones(32))
    assert gk._shape_label(w, v, "count") == "u8 count masked weighted window"


def test_unported_device_nodes_raise_unsupported():
    # IS NULL and the math functions came with the row path, full text and
    # vector search later; the string functions are still to port.  Full
    # text over a column with no dictionary is refused; vector search
    # over a column that is not a VECTOR is the reference's PlanError
    rctx, pctx = contexts({"host": ["h0"], "dc": ["d0"]})
    for name in ("matches", "upper"):
        with pytest.raises(Unsupported):
            compile_device(port_ast.FuncCall(
                name, (port_ast.Column("a"), port_ast.Literal("[1]"))), pctx)
    with pytest.raises(RefPlanError):
        ref_compile(FuncCall("vec_cos_distance", (Column("a"),
                                                   Literal("[1]"))), rctx)
    with pytest.raises(PlanError):
        compile_device(port_ast.FuncCall("vec_cos_distance", (
            port_ast.Column("a"), port_ast.Literal("[1]"))), pctx)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    arrs = make_arrays(4, nan_field=1)
    values = torch.from_numpy(arrs["values"]).to(cuda_device)
    valid = torch.from_numpy(arrs["valid"]).to(cuda_device)
    gk.reset_launch_counts()
    for kw in (dict(r=32, nb=8), dict(r=36, nb=8, pad_l=7, pad_r=25),
               dict(r=16, nb=4, s0=40, w_raw=60, pad_l=3, pad_r=1,
                    mask=valid, skip_nan=True)):
        for op in ("sum", "count", "min", "max"):
            got = gk.bucket_reduce(values, op, **kw)
            want = gk.bucket_reduce_plain(values, op, **kw)
            close(got.cpu().numpy(), want.cpu().numpy(), exact=op != "sum")
    ids = torch.from_numpy(arrs["tag_codes"]["host"]).to(cuda_device)
    ids = torch.where(ids < 0, 32, ids)
    lay = gk.group_layout(ids, 32)
    x = gk.bucket_reduce(values, "sum", r=32, nb=8)
    for op in ("sum", "min", "max"):
        close(gk.group_merge(x, lay, op).cpu().numpy(),
              gk.group_merge_plain(x, lay, op).cpu().numpy(),
              exact=op != "sum")
    assert gk.bucket_reduce.launches == 13
    assert gk.group_merge.launches == 3
    gk.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_stacked_kernels_match_plain(cuda_device, masked):
    """group_merge_stacked (K2 stacked) and series_mask (K21) against their
    plain versions, bit for bit: per-member starts that are negative or run
    past NB, a NaN and an inf partial under a zero mask entry, n = 3 members
    padded to 4, and the launch on a side stream (the caller's current
    stream)."""
    rng = np.random.default_rng(8)
    spad, nb, nbw = 64, 8, 5
    cnts = rng.integers(0, 33, (spad, nb)).astype(np.float32)
    sums = (rng.random((3, spad, nb)) * 3000).astype(np.float32) * (cnts > 0)
    sums[0, 3, 2], sums[1, 7, 4] = np.nan, np.inf
    host = np.full(spad, -1, np.int32)
    host[:50] = rng.integers(0, 23, 50)
    ids = np.where(host < 0, 32, host).astype(np.int32)
    codes = np.stack([host, np.where(host < 0, -1, host % 3)]).astype(
        np.int32)
    lut = (rng.random(24 * 4 + 24) > 0.5).astype(np.uint8)
    offsets = np.array([0, 24 * 4, 24 * 4], np.int32)
    strides = np.array([[4, 1], [1, 0], [1, 0]], np.int32)
    extents = np.array([24, 4], np.int32)
    b_lo = np.array([-4, 30, 2, -4], np.int32)
    planes = np.array([2, 0, 1], np.int32)
    dev = cuda_device
    side = torch.cuda.Stream()
    gk.reset_launch_counts()
    with torch.cuda.stream(side):
        t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
            cnts=cnts, sums=sums, ids=ids, codes=codes, lut=lut,
            offsets=offsets, strides=strides, extents=extents, b_lo=b_lo,
            planes=planes).items()}
        lay = gk.group_layout(t["ids"], 32)
        mask = gk.series_mask(t["codes"], t["lut"], t["offsets"],
                              t["strides"], t["extents"], 4)
        m = mask if masked else None
        cnt, sg = gk.group_merge_stacked(t["sums"], t["cnts"], t["b_lo"],
                                         lay, t["planes"], nbw, mask=m)
    side.synchronize()
    cpu = {k: v.cpu() for k, v in t.items()}
    lay_c = gk.group_layout(cpu["ids"], 32)
    want_mask = gk.series_mask_plain(cpu["codes"], cpu["lut"],
                                     cpu["offsets"], cpu["strides"],
                                     cpu["extents"], 4)
    assert torch.equal(mask.cpu(), want_mask)
    want_cnt, want_sg = gk.group_merge_stacked_plain(
        cpu["sums"], cpu["cnts"], cpu["b_lo"], lay_c, cpu["planes"], nbw,
        mask=want_mask if masked else None)
    assert torch.equal(cnt.cpu(), want_cnt)
    got_sg = sg.cpu()
    assert torch.equal(torch.isnan(got_sg), torch.isnan(want_sg))
    assert torch.equal(torch.nan_to_num(got_sg), torch.nan_to_num(want_sg))
    assert gk.series_mask.launches == 1
    assert gk.group_merge_stacked.launches == 2
    gk.reset_launch_counts()


def _same(got, want):
    """Bit for bit, NaN where NaN."""
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.is_floating_point():
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        got, want = torch.nan_to_num(got), torch.nan_to_num(want)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("r", [7, 36, 360])
@pytest.mark.parametrize("s0", [0, 1, 2, 3])
def test_cuda_bucket_reduce_edges(cuda_device, dtype, r, s0):
    """The streaming bucket_reduce against its plain version on the card:
    window starts 0-3 mod 4 (the x row's head), pad_l not a multiple of
    4 (vectors straddling a bucket edge), a mask whose rows sit at other
    alignments than x's, weights with zeros, NaN and +-inf under
    skip_nan, the u8 input, a window narrower than a vector; two calls
    equal bit for bit."""
    rng = np.random.default_rng(100 + r + s0)
    p, s, width = 3, 37, 3 * r + 21
    if dtype == "f32":
        xn = (rng.random((p, s, width)) * 100).astype(np.float32)
        xn[0, ::3, ::7] = np.nan
        xn[1, 2, 5::13] = np.inf
        xn[2, 4, 3::11] = -np.inf
        x = torch.from_numpy(xn).to(cuda_device)
    else:
        x = torch.from_numpy(rng.random((p, s, width)) > 0.4).to(cuda_device)
    cases = []
    for w_raw, pad_l in ((2 * r + 5, 3), (2 * r, 0), (3, 2), (r + 1, r - 1)):
        nb = -(-(pad_l + w_raw) // r)
        mfull = torch.from_numpy(rng.random((s, w_raw + 3)) > 0.25).to(
            cuda_device)
        mask = mfull[:, 1:1 + w_raw]           # rows at odd alignments
        wt = torch.from_numpy((rng.random(w_raw) > 0.3).astype(
            np.float32)).to(cuda_device)
        geo = dict(r=r, nb=nb, s0=s0, w_raw=w_raw, pad_l=pad_l)
        cases += [dict(geo), dict(geo, weight=wt),
                  dict(geo, mask=mask, mask_s0=0, skip_nan=True),
                  dict(geo, mask=mask, mask_s0=0, weight=wt, skip_nan=True),
                  dict(geo, skip_nan=True)]
    for kw in cases:
        for op in ("sum", "count", "min", "max"):
            got = gk.bucket_reduce(x, op, **kw)
            want = gk.bucket_reduce_plain(x, op, **kw)
            close(got.cpu().numpy(), want.cpu().numpy(), exact=op != "sum")
            _same(gk.bucket_reduce(x, op, **kw), got)
    assert gk.bucket_reduce.launches == 2 * 4 * len(cases)
    gk.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 10])
@pytest.mark.parametrize("nb", [1, 20, 24, 33, 64])
def test_cuda_group_merge_edges(cuda_device, p, nb):
    """group_merge (a thread an output, its series loop unrolled by 4) on
    the card: groups of 0, 1, 2, 31, 33 and 1,000 series and overflow ids,
    sums with and without a factor, min/max with a zero factor and NaN,
    int64 counts; each equal bit for bit to a sequential ascending-order
    fold (the CPU plain version is one), and the unmasked sums and counts
    to group_merge_stacked with B = 1."""
    rng = np.random.default_rng(7 * nb + p)
    sizes = [0, 1, 2, 31, 33, 1000, 0, 5]
    ngt = len(sizes)
    ids = np.concatenate([np.full(k, g) for g, k in enumerate(sizes)]
                         + [np.full(9, ngt)]).astype(np.int32)
    rng.shuffle(ids)
    s = len(ids)
    xn = (rng.random((p, s, nb)) * 1000).astype(np.float32)
    xn[0, np.flatnonzero(ids == 5)[7], 0] = np.nan  # in the group of 1,000
    fac = (rng.random(s) > 0.3).astype(np.float32)
    lay_c = gk.group_layout(torch.from_numpy(ids), ngt)
    lay = gk.group_layout(torch.from_numpy(ids).to(cuda_device), ngt)
    x = torch.from_numpy(xn).to(cuda_device)
    f = torch.from_numpy(fac).to(cuda_device)
    order, offs = lay_c.order.numpy(), lay_c.offsets.numpy()
    for op, use_f in (("sum", False), ("sum", True), ("min", True),
                      ("max", False), ("max", True)):
        got = gk.group_merge(x, lay, op, factor=f if use_f else None)
        want = gk.group_merge_plain(torch.from_numpy(xn), lay_c, op,
                                    torch.from_numpy(fac) if use_f else None)
        _same(got, want)
        _same(gk.group_merge(x, lay, op, factor=f if use_f else None), got)
        if op == "sum":
            _same(got, torch.from_numpy(_seq_fold(
                xn, order, offs, fac if use_f else None)))
    cn = rng.integers(0, 361, (p, s, nb))
    got = gk.group_merge(torch.from_numpy(cn).to(cuda_device), lay, "sum")
    _same(got, torch.from_numpy(_seq_fold(cn, order, offs, count=True)))
    # group_merge_stacked, B = 1, no mask: planes 0..p-1, counts from the
    # last plane's f32 partials
    cnts = torch.from_numpy(rng.integers(0, 361, (s, nb)).astype(
        np.float32)).to(cuda_device)
    b_lo = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    planes = torch.arange(p, dtype=torch.int32, device=cuda_device)
    st_cnt, st_sum = gk.group_merge_stacked(x, cnts, b_lo, lay, planes, nb)
    _same(st_sum[0], gk.group_merge(x, lay, "sum"))
    _same(st_cnt[0], gk.group_merge(cnts.to(torch.int64), lay, "sum"))
    gk.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("with_factor", [False, True])
def test_cuda_group_merge_pair_is_two_merges(cuda_device, with_factor):
    """group_merge_pair (one launch) against the two group_merge launches
    and elementwise kernels it replaces, bit for bit, on window views of
    the resident partials' shape, and against its plain version."""
    rng = np.random.default_rng(5)
    s, nb, ngt, p = 4096, 24, 4096, 10
    ids = rng.integers(0, ngt, s).astype(np.int32)
    ids[rng.random(s) < 0.05] = ngt
    lay = gk.group_layout(torch.from_numpy(ids).to(cuda_device), ngt)
    cfull = torch.from_numpy(rng.integers(0, 361, (s, 30)).astype(
        np.float32)).to(cuda_device)
    sfull = torch.from_numpy((rng.random((p, s, 30)) * 1000).astype(
        np.float32)).to(cuda_device)
    c, sums = cfull[:, 5:5 + nb], sfull[:, :, 5:5 + nb]
    fac = (torch.from_numpy((rng.random(s) > 0.3).astype(np.float32)).to(
        cuda_device) if with_factor else None)
    cnt, sg = gk.group_merge_pair(c, sums, lay, factor=fac)
    cw = c if fac is None else c * fac[:, None]
    _same(cnt, gk.group_merge(cw.to(torch.int64), lay, "sum"))
    _same(sg, gk.group_merge(sums, lay, "sum", factor=fac))
    cnt0, none = gk.group_merge_pair(c, None, lay, factor=fac)
    assert none is None
    _same(cnt0, cnt)
    lay_c = gk.group_layout(torch.from_numpy(ids), ngt)
    want_c, want_s = gk.group_merge_pair_plain(
        c.cpu(), sums.cpu(), lay_c, None if fac is None else fac.cpu())
    _same(cnt, want_c)
    _same(sg, want_s)
    assert gk.group_merge_pair.launches == 2
    gk.reset_launch_counts()
