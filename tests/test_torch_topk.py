"""Port parity of the raw scan's device top-k (``ORDER BY <numeric
columns> LIMIT k``): ``Executor._topk_spec`` and the ``topk_select``
kernel's plain version.

The JAX reference and the port (``device="cpu"``) ingest the same seeded
rows through ``region.write`` and answer the same queries; rows must be
equal (==).  Every query also asserts which route ran on both sides: the
port's ``DISPATCH_STATS["topk"]`` and a spy on the reference's
``Executor._topk_spec``, so eligibility matches the reference exactly.
The key columns carry NaN, -0.0 / +0.0, INT64_MIN / INT64_MAX, unsigned
zeros, int8 -128, bools and many ties, so DESC's in-dtype negation, the
null ranks and row-order tie breaks all decide rows at the LIMIT's edge.
The plain version is also held to ``np.lexsort`` directly, and the
reference's own ``TestDeviceTopK`` cases run against the port.  Tests
marked ``cuda`` hold the kernel to its plain version on the card.
"""

import zlib

import numpy as np
import pytest
import test_window as tw
import torch

from greptimedb_tpu.query.physical import Executor as RefExecutor
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.datatypes.batch import pad_rows
from greptimedb_tpu_torch.ops import topk_kernels as TK
from greptimedb_tpu_torch.query import physical
from greptimedb_tpu_torch.standalone import GreptimeDB

T0 = 1_700_000_000_000
HOSTS, STEPS = 2, 100
N = HOSTS * STEPS
I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max
DDL = ("CREATE TABLE t (h STRING, ts TIMESTAMP(3) TIME INDEX, v DOUBLE, "
       "f FLOAT, k BIGINT, u INT UNSIGNED, i8 TINYINT, i16 SMALLINT, "
       "u8 TINYINT UNSIGNED, b BOOLEAN, s STRING, PRIMARY KEY (h))")


def _rows(seed: int, hosts: int, steps: int) -> dict:
    rng = np.random.default_rng(seed)
    n = hosts * steps
    return {
        "h": np.repeat(np.array([f"h{i}" for i in range(hosts)],
                                dtype=object), steps),
        "ts": np.tile(T0 + np.arange(steps, dtype=np.int64) * 1000, hosts),
        "v": rng.choice([-1.5, -0.0, 0.0, 1.0, 2.5, np.nan], n),
        "f": rng.choice([-2.0, -0.0, 0.0, 3.0, np.nan], n).astype(
            np.float32),
        "k": rng.choice(np.array([I64_MIN, -3, 0, 7, I64_MAX],
                                 dtype=np.int64), n),
        "u": rng.choice(np.array([0, 1, 5, 2**32 - 1], dtype=np.uint32), n),
        "i8": rng.choice(np.array([-128, -1, 0, 1, 127], dtype=np.int8), n),
        "i16": rng.integers(-3, 3, n).astype(np.int16),
        "u8": rng.choice(np.array([0, 1, 255], dtype=np.uint8), n),
        "b": rng.random(n) < 0.5,
        "s": rng.choice(np.array(["x", "y", "z"], dtype=object), n),
    }


def _make(db, data):
    db.sql(DDL)
    db._region_of("t").write(data)
    return db


@pytest.fixture(scope="module")
def data():
    return _rows(5, HOSTS, STEPS)


@pytest.fixture(scope="module")
def pair(data):
    dbs = (_make(RefDB(), data), _make(GreptimeDB(device="cpu"), data))
    yield dbs
    for d in dbs:
        d.close()


def _routes(pair, sql, monkeypatch):
    """Run ``sql`` on both; rows must be equal.  Returns (port took the
    top-k, the reference's _topk_spec decisions)."""
    ref, port = pair
    seen = []
    orig = RefExecutor._topk_spec

    def spy(plan, ctx, table):
        spec = orig(plan, ctx, table)
        seen.append(spec is not None)
        return spec

    monkeypatch.setattr(RefExecutor, "_topk_spec", staticmethod(spy))
    want = ref.sql(sql)
    before = physical.DISPATCH_STATS["topk"]
    got = port.sql(sql)
    took = physical.DISPATCH_STATS["topk"] - before
    assert got.rows == want.rows, sql
    return took == 1, seen


def _check(pair, sql, topk, monkeypatch):
    took, seen = _routes(pair, sql, monkeypatch)
    assert took is topk
    assert seen == [topk]


TOPK_QUERIES = {
    # NaN: NULLS LAST under ASC, NULLS FIRST under DESC, and both forced
    "nan_asc": "SELECT h, ts, v FROM t ORDER BY v LIMIT 37",
    "nan_desc": "SELECT h, ts, v FROM t ORDER BY v DESC LIMIT 37",
    "nan_nulls_first": ("SELECT h, ts, v FROM t "
                        "ORDER BY v NULLS FIRST LIMIT 41"),
    "nan_desc_nulls_last": ("SELECT h, ts, v FROM t "
                            "ORDER BY v DESC NULLS LAST LIMIT 41"),
    "f32_key": "SELECT h, ts, f FROM t ORDER BY f DESC LIMIT 45",
    "int64_min_desc": "SELECT h, ts, k FROM t ORDER BY k DESC LIMIT 43",
    "int64_asc": "SELECT h, ts, k FROM t ORDER BY k LIMIT 43",
    "uint32_zeros_desc": "SELECT h, ts, u FROM t ORDER BY u DESC LIMIT 57",
    "uint8_desc": "SELECT h, ts, u8 FROM t ORDER BY u8 DESC LIMIT 71",
    "int8_desc": "SELECT h, ts, i8 FROM t ORDER BY i8 DESC LIMIT 45",
    "bool_key": "SELECT h, ts, b FROM t ORDER BY b DESC, i16 LIMIT 33",
    "multi_key_ties": ("SELECT h, ts, i8, v FROM t "
                       "ORDER BY i8, v DESC, i16 LIMIT 29"),
    "offset": "SELECT h, ts, v FROM t ORDER BY v, i16 LIMIT 7 OFFSET 19",
    "where_time_range": (f"SELECT h, ts, v FROM t WHERE v > 0 AND "
                         f"ts >= {T0 + 20_000} AND ts < {T0 + 70_000} "
                         f"ORDER BY ts DESC LIMIT 6"),
    "star": "SELECT * FROM t WHERE i16 = 0 ORDER BY u8, f LIMIT 9",
}


@pytest.mark.parametrize("name", sorted(TOPK_QUERIES))
def test_topk_route_matches_reference(name, pair, monkeypatch):
    _check(pair, TOPK_QUERIES[name], True, monkeypatch)


def test_signed_zero_ties_keep_row_order(pair, data, monkeypatch):
    """-0.0 and +0.0 tie: the LIMIT's edge falls among the zeros, so the
    rows kept are the first zeros in row order whatever their sign."""
    v = data["v"]
    zero = v == 0
    assert zero.sum() > 6 and np.signbit(v[zero]).any() and (
        ~np.signbit(v[zero])).any()
    below, above = int((v < 0).sum()), int((v > 0).sum())
    _check(pair, f"SELECT h, ts, v FROM t ORDER BY v LIMIT {below + 3}",
           True, monkeypatch)
    _check(pair, f"SELECT h, ts, v FROM t ORDER BY v DESC NULLS LAST "
           f"LIMIT {above + 3}", True, monkeypatch)


def test_padded_rows_edge(pair, monkeypatch):
    """k = padded_rows - 1 takes the top-k; k = padded_rows does not."""
    p = pad_rows(N)
    _check(pair, f"SELECT h, ts, v FROM t ORDER BY v, ts LIMIT {p - 1}",
           True, monkeypatch)
    _check(pair, f"SELECT h, ts, v FROM t ORDER BY v, ts LIMIT {p}",
           False, monkeypatch)


REFUSED = {
    "having": "SELECT ts, v FROM t HAVING v > 1 ORDER BY v, ts LIMIT 5",
    "distinct": "SELECT DISTINCT i8 FROM t ORDER BY i8 LIMIT 3",
    "window": ("SELECT ts, v, row_number() OVER (ORDER BY ts) AS r FROM t "
               "ORDER BY v, ts LIMIT 5"),
    "tag_key": "SELECT h, ts FROM t ORDER BY h DESC, ts LIMIT 3",
    "string_field_key": "SELECT s, ts FROM t ORDER BY s, ts LIMIT 3",
    "expression_key": "SELECT ts, v FROM t ORDER BY v + 1, ts LIMIT 3",
    "no_limit": "SELECT ts, v FROM t ORDER BY v, ts",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_shapes_take_the_full_scan(name, pair, monkeypatch):
    _check(pair, REFUSED[name], False, monkeypatch)


def test_k_bound_65536(monkeypatch):
    """k = limit + offset = 65,536 takes the top-k; 65,537 does not."""
    data = _rows(7, 1, 70_000)
    pair = (_make(RefDB(), data), _make(GreptimeDB(device="cpu"), data))
    try:
        base = "SELECT ts, i16 FROM t ORDER BY i16 DESC, u8"
        _check(pair, f"{base} LIMIT 36 OFFSET 65500", True, monkeypatch)
        _check(pair, f"{base} LIMIT 37 OFFSET 65500", False, monkeypatch)
        _check(pair, f"{base} LIMIT 65537", False, monkeypatch)
    finally:
        for d in pair:
            d.close()


# ---- the plain version against np.lexsort ------------------------------

def _np_lexsort_keys(cols, mask):
    """The reference's key list (physical.py:1966-1980) in numpy."""
    keys = []
    for v, asc, nulls_first in reversed(cols):
        if v.dtype.kind == "f":
            isnull = np.isnan(v)
            nf = (not asc) if nulls_first is None else nulls_first
            rank = np.where(isnull, 0 if nf else 2, 1)
            v = np.where(isnull, v.dtype.type(0), v)
        else:
            if v.dtype == np.bool_:
                v = v.astype(np.int32)
            rank = np.ones(v.shape, dtype=np.int32)
        with np.errstate(over="ignore"):
            keys.append(v if asc else -v)
        keys.append(rank)
    keys.append(~mask)
    return keys


_DTYPES = {
    "f32": np.float32, "f64": np.float64, "i64": np.int64, "i32": np.int32,
    "i16": np.int16, "i8": np.int8, "u8": np.uint8, "u16": np.uint16,
    "u32": np.uint32, "bool": np.bool_,
}


def _column(rng, dt, n):
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if np.dtype(dt).kind == "f":
        v = rng.choice([-2.5, -0.0, 0.0, 1.0, np.inf, -np.inf, np.nan], n)
        return v.astype(dt)
    info = np.iinfo(dt)
    v = rng.integers(max(info.min, -4), min(info.max, 4) + 1, n).astype(dt)
    pick = rng.random(n) < 0.2
    v[pick] = rng.choice(np.array([info.min, info.max, 0, 1], dtype=dt),
                         int(pick.sum()))
    return v


@pytest.mark.parametrize("dt", sorted(_DTYPES))
@pytest.mark.parametrize("asc,nulls_first", [(True, None), (False, None),
                                              (True, True), (False, False)])
def test_plain_equals_np_lexsort(dt, asc, nulls_first):
    rng = np.random.default_rng(zlib.crc32(f"{dt}{asc}{nulls_first}".encode()))
    n = 3000
    v = _column(rng, _DTYPES[dt], n)
    second = rng.integers(0, 3, n).astype(np.int64)
    mask = rng.random(n) < 0.9
    cols = [(v, asc, nulls_first), (second, True, None)]
    want = np.lexsort(_np_lexsort_keys(cols, mask))
    for k in (1, 50, n - 1, n):
        rows, got_n = TK.topk_select(
            [(torch.from_numpy(c), a, nf) for c, a, nf in cols],
            torch.from_numpy(mask), k)
        assert rows.tolist() == want[:k].tolist()
        assert got_n == min(int(mask.sum()), k)
    assert TK.topk_select.launches == 0  # CPU tensors: the plain version


def test_wrapper_checks_arguments():
    v = torch.zeros(4)
    with pytest.raises(ValueError):
        TK.topk_select([], torch.ones(4, dtype=torch.bool), 1)
    with pytest.raises(ValueError):
        TK.topk_select([(v, True, None)], torch.ones(3, dtype=torch.bool), 1)
    with pytest.raises(ValueError):
        TK.topk_select([(v.to(torch.complex64), True, None)],
                       torch.ones(4, dtype=torch.bool), 1)


# ---- the reference's own cases, against the port ----------------------

@pytest.fixture
def db():
    d = GreptimeDB(device="cpu")
    yield d
    d.close()


class TestDeviceTopKOnPort(tw.TestDeviceTopK):
    """tests/test_window.py::TestDeviceTopK with the port's db."""


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(_DTYPES))
def test_cuda_topk_select_matches_plain(dt, cuda_device):
    rng = np.random.default_rng(17)
    n = (1 << 20) + 123
    v = _column(rng, _DTYPES[dt], n)
    second = rng.integers(0, 1000, n).astype(np.int64)
    mask = rng.random(n) < 0.95
    for asc, nf in ((True, None), (False, None), (False, False)):
        cols = [(v, asc, nf), (second, False, None)]
        for k in (1, 100, 65_536):
            want, want_n = TK.topk_select_plain(
                [(torch.from_numpy(c), a, f) for c, a, f in cols],
                torch.from_numpy(mask), k)
            before = TK.topk_select.launches
            got, got_n = TK.topk_select(
                [(torch.from_numpy(c).to(cuda_device), a, f)
                 for c, a, f in cols], torch.from_numpy(mask).to(cuda_device),
                k)
            torch.cuda.synchronize()
            assert TK.topk_select.launches == before + 1
            assert got.cpu().tolist() == want.tolist()
            assert got_n == want_n


@pytest.mark.cuda
def test_cuda_topk_ties_keep_row_order(cuda_device):
    """A constant column: every row ties, so the first k rows in row order
    (the mask's unset rows last) come back."""
    n = (1 << 20) + 7
    v = torch.full((n,), 100.0, device=cuda_device)
    mask = torch.ones(n, dtype=torch.bool, device=cuda_device)
    mask[:5] = False
    got, got_n = TK.topk_select([(v, False, None)], mask, 1000)
    assert got.cpu().tolist() == list(range(5, 1005))
    assert got_n == 1000
    few = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    few[[3, 9]] = True
    got, got_n = TK.topk_select([(v, True, None)], few, 4)
    assert got.cpu().tolist() == [3, 9, 0, 1] and got_n == 2


@pytest.mark.cuda
def test_cuda_raw_topk_matches_cpu(cuda_device):
    data = _rows(9, 4, 5000)
    dbs = (_make(GreptimeDB(device="cuda"), data),
           _make(GreptimeDB(device="cpu"), data))
    try:
        for sql in TOPK_QUERIES.values():
            before = TK.topk_select.launches
            assert dbs[0].sql(sql).rows == dbs[1].sql(sql).rows, sql
            assert TK.topk_select.launches == before + 1
    finally:
        for d in dbs:
            d.close()
