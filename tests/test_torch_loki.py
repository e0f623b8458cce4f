"""Port parity of the LogQL path (K17 ``logs_layout``, ``line_vals``,
``row_match``; the Loki read API; the push; the log-query DSL).

Same inputs through the JAX reference and the port on the CPU, every
comparison exact:

- the LogQL parser goldens and errors against the reference's
  ``parse_logql``;
- the three K17 plain versions against the reference's jitted
  ``_logs_layout`` / ``_line_vals`` / ``_byte_vals`` / ``_row_match``, over
  pads, code -1, no valid row, and unsorted, -1-padded selections;
- one small corpus pushed into a reference ``GreptimeDB`` (through its own
  HTTP push route) and a port ``GreptimeDB(device="cpu")`` (through
  ``servers.ingest.loki_push``): every query of
  ``tests/test_fulltext.py::TestLokiReadApi`` and a few more give equal
  payloads through ``loki_query_range`` / ``_instant`` / ``_labels`` /
  ``_label_values`` / ``_series``, duplicate timestamps within a stream
  and the ``forward`` / ``limit`` order included, with the prefilter on
  and off;
- the ingest-side prewarm brings a resident fingerprint matrix current;
- the log-query DSL against the reference's ``execute_log_query``.

Tests marked ``cuda`` hold the kernels to their plain versions and the
card's payloads to the CPU's.
"""

import dataclasses
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.errors import InvalidArguments as RefInvalid
from greptimedb_tpu.fulltext import loki as RL
from greptimedb_tpu.fulltext import logql as RQ
from greptimedb_tpu.servers.logquery import execute_log_query as ref_dsl
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.errors import InvalidArguments
from greptimedb_tpu_torch.fulltext import loki as PL
from greptimedb_tpu_torch.fulltext import logql as PQ
from greptimedb_tpu_torch.ops import fulltext_kernels as FK
from greptimedb_tpu_torch.servers.ingest import loki_push
from greptimedb_tpu_torch.servers.logquery import execute_log_query
from greptimedb_tpu_torch.standalone import GreptimeDB
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

LOGQL = [
    '{app="web"}', '{app="web", env=~"prod|stage", region!~"eu-.*", x!="y"}',
    '{app="web"} |= "error" != "debug" |~ "conn.*reset" !~ "noise"',
    '{a="b"} | json | status >= 500', '{a="b"} | logfmt | level = "error"',
    '{a="b"} |= "x\\"quoted\\""', '{a="b"} |= `raw \\ text`',
    'count_over_time({app="web"} |= "err" [5m])', 'rate({a="b"} [1h30m])',
    'bytes_over_time({a="b"} [30s])', 'bytes_rate({a="b"} [90])',
    'sum by (app) (count_over_time({e=~".+"} [1m]))',
    'max without (pod, node) (rate({a="b"} [5m]))',
    'avg(count_over_time({a="b"} [1m])) by (app)',
    'count(rate({a="b"} | logfmt | dur > 1.5s [2m]))', '{}',
    '{a="b"} | json | status != 404 | user =~ "a.*"',
]
BAD_LOGQL = ["", "{app=web}", '{app="web"', '{app="web"} |= error',
             'frobnicate({a="b"} [5m])', '{a="b"} | unknown ~ 3',
             'sum(count_over_time({a="b"} [5m])) trailing',
             '{a="b"} | json | status =~ 500', "nope",
             'count_over_time({a="b"})', '{a="b"} | json | x > "s"']


def _norm(x):
    """A parse tree as nested (class name, fields) tuples, so the two
    packages' dataclasses compare."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return tuple(_norm(v) for v in x)
    return x


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# ---- the parser -------------------------------------------------------------

@pytest.mark.parametrize("text", LOGQL)
def test_logql_parses_as_reference(text):
    assert _norm(PQ.parse_logql(text)) == _norm(RQ.parse_logql(text))


def test_logql_errors_and_durations_match_reference():
    for bad in BAD_LOGQL:
        with pytest.raises(RefInvalid):
            RQ.parse_logql(bad)
        with pytest.raises(InvalidArguments):
            PQ.parse_logql(bad)
    for d in ("5m", "1h30m", "250ms", "1w", "1.5s", "10us"):
        assert PQ.parse_duration_ms(d) == RQ.parse_duration_ms(d)
    with pytest.raises(InvalidArguments):
        PQ.parse_duration_ms("5x")
    for v in (None, "1700000000", "1700000000.5", "1700000000000000000",
              "2023-11-14T22:13:20Z"):
        assert (PL.parse_loki_time_ns(v, 7)
                == RL.parse_loki_time_ns(v, 7)), v


# ---- the K17 plain versions ---------------------------------------------------

def _k17_case(seed, n=600, npad_rows=1024, nseries=40, vocab=50,
              valid=True):
    """A (tsid, ts)-sorted table padded to ``npad_rows`` (pads: code -1,
    mask False), duplicate timestamps, some code -1 live rows."""
    rng = np.random.default_rng(seed)
    tsid = np.sort(rng.integers(0, nseries, n)).astype(np.int32)
    ts = (1_700_000_000_000 + rng.integers(0, 50_000, n)).astype(np.int64)
    order = np.lexsort((ts, tsid))
    tsid, ts = tsid[order], ts[order]
    ts[5] = ts[4] if tsid[5] == tsid[4] else ts[5]
    codes = rng.integers(0, vocab, n).astype(np.int32)
    codes[rng.random(n) < 0.05] = -1
    mask = np.zeros(npad_rows, bool)
    mask[:n] = valid
    pad = lambda a, v: np.concatenate(  # noqa: E731
        [a, np.full(npad_rows - n, v, a.dtype)])
    vpad = 64
    verified = np.zeros(vpad, bool)
    verified[:vocab] = rng.random(vocab) < 0.5
    blen = np.zeros(vpad, np.float32)
    blen[:vocab] = rng.integers(1, 120, vocab)
    return (pad(ts, 0), pad(tsid, 0), pad(codes, -1), mask, verified, blen)


SELS = {
    "sorted_padded": np.array([1, 3, 5, 8, 13, 21, -1, -1], np.int32),
    "unsorted_padded": np.array([21, 3, -1, 8, 1, -1, 13, 5], np.int32),
    "all": np.arange(64, dtype=np.int32),
    "none": np.array([-1, -1], np.int32),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("valid", [True, False])
def test_logs_layout_plain_matches_reference(seed, valid):
    ts, tsid, _codes, mask, _v, _b = _k17_case(seed, valid=valid)
    want = RL._logs_layout(jnp.asarray(ts), jnp.asarray(tsid),
                           jnp.asarray(mask))
    got = FK.logs_layout(torch.from_numpy(ts), torch.from_numpy(tsid),
                         torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][0]) < FK.I64_MAX if valid else int(got[2]) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_line_vals_plain_matches_reference(seed):
    _ts, _tsid, codes, mask, verified, blen = _k17_case(seed)
    c, v, m, b = (torch.from_numpy(a) for a in (codes, verified, mask, blen))
    want_ind = np.asarray(RL._line_vals(codes, verified, mask))
    want_b = np.asarray(RL._byte_vals(codes, verified, blen, mask))
    vals, ind = FK.line_vals(c, v, m)
    assert vals is ind and ind.dtype == torch.float32
    np.testing.assert_array_equal(ind.numpy(), want_ind)
    vals, ind = FK.line_vals(c, v, m, b)
    np.testing.assert_array_equal(vals.numpy(), want_b)
    np.testing.assert_array_equal(ind.numpy(), want_ind)


@pytest.mark.parametrize("sel", list(SELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_row_match_plain_matches_reference(sel, seed):
    ts, tsid, codes, mask, verified, _blen = _k17_case(seed)
    lo, hi = 1_700_000_010_000, 1_700_000_040_000
    s = SELS[sel]
    want = np.asarray(RL._row_match(codes, verified, mask, ts, tsid,
                                    jnp.asarray(s), np.int64(lo),
                                    np.int64(hi)))
    got = FK.row_match(*(torch.from_numpy(a) for a in (
        codes, verified, mask, ts, tsid, s)), lo, hi, num_series=40)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the Loki read API ---------------------------------------------------------

T0 = 1700000000000000000
STREAMS = [
    {"stream": {"app": "web", "level": "error"},
     "values": [[str(T0), "boom conn reset"],
                [str(T0 + 1_500_000_000), "boom timeout"],
                [str(T0 + 3_000_000_000), "recovered fine"]]},
    {"stream": {"app": "api", "level": "info"},
     "values": [[str(T0 + 2_000_000_000),
                 '{"user": "alice", "status": 500, "msg": "boom"}'],
                [str(T0 + 4_000_000_000),
                 '{"user": "bob", "status": 200, "msg": "ok"}']]},
    {"stream": {"app": "api", "level": "warn"},
     "values": [[str(T0 + 5_000_000_000), "latency=2.5 path=/api ok"]]},
    # duplicate timestamps within one stream (append mode keeps all)
    {"stream": {"app": "db", "level": "error", "line": "reserved"},
     "values": [[str(T0 + 6_000_000_000), "dup b boom"],
                [str(T0 + 6_000_000_000), "dup a boom"],
                [str(T0 + 6_000_000_000), "dup c"],
                [str(T0 + 7_000_000_000), "İstanbul ıssız boom"]]},
]
RANGE = {"start": "1700000000", "end": "1700000100"}
QUERIES = [
    ('{app="web"} |= "boom"', {}),
    ('{app="web"}', {"direction": "forward", "limit": "2"}),
    ('{app="web"} != "boom"', {}),
    ('{app=~"web|api"} |~ "conn.*reset"', {}),
    ('{app="api"} | json | status >= 500', {}),
    ('{app="api"} | logfmt | path = "/api"', {}),
    ('{app=~".+"} |= "boom"', {}),
    ('{app=~".+"} |= "boom"', {"direction": "forward", "limit": "3"}),
    ('{app="db"}', {"limit": "2"}),
    ('{app="db"} |~ "(?i)İSTANBUL"', {}),
    ('{app=~".+"} |~ "o{2}m" != "reset"', {}),
    ('{level="error"} |= "nothing matches this"', {}),
    ('count_over_time({app="web"} |= "boom" [10s])',
     {"start": "1700000005", "end": "1700000015", "step": "5"}),
    ('sum by (app) (count_over_time({level=~".+"} [10s]))',
     {"start": "1700000005", "end": "1700000005", "step": "5"}),
    ('rate({app="web"} |= "boom" [10s])',
     {"start": "1700000005", "end": "1700000005", "step": "5"}),
    ('bytes_over_time({app="web"} |= "boom" [10s])',
     {"start": "1700000005", "end": "1700000005", "step": "5"}),
    ('sum by (app) (bytes_rate({app=~".+"} |= "boom" [4s]))',
     {"start": "1700000000", "end": "1700000010", "step": "1"}),
    ('count_over_time({app="db"} [2s])',
     {"start": "1700000005", "end": "1700000009", "step": "1"}),
    ('sum by (app) (rate({level=~".+"} [20s]))',
     {"start": "1700000002", "end": "1700000012", "step": "5"}),
    ('max without (level) (count_over_time({app=~".+"} |= "o" [5s]))',
     {"start": "1700000000", "end": "1700000010", "step": "2"}),
    ('avg(count_over_time({app=~".+"} [3s]))',
     {"start": "1700000000", "end": "1700000010", "step": "2"}),
    ('count(count_over_time({app="api"} | json | status >= 200 [10s]))',
     {"start": "1700000000", "end": "1700000010", "step": "5"}),
    ('min by (app) (bytes_over_time({app=~".+"} [1m]))',
     {"start": "1700000010", "end": "1700000010", "step": "1m"}),
]
INSTANT = [('count_over_time({app="web"} [10s])', "1700000005"),
           ('{app=~".+"} |= "boom"', "1700000010"),
           ('sum by (level) (rate({app=~".+"} [10s]))', "1700000008")]


def _ref_push(db, streams):
    """The reference's own push route (its HTTP server)."""
    from greptimedb_tpu.servers import HttpServer

    srv = HttpServer(db, port=0)
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/loki/api/v1/push",
            data=json.dumps({"streams": streams}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Scope-OrgID": "acme"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 204
    finally:
        srv.stop()


def _port_push(db, streams):
    return loki_push(db, json.dumps({"streams": streams}).encode(),
                     "application/json", "acme")


def _payloads(mod, db):
    out = []
    for q, extra in QUERIES:
        out.append(mod.loki_query_range(db, {"query": q, **RANGE, **extra}))
    for q, t in INSTANT:
        out.append(mod.loki_query_instant(db, {"query": q, "time": t}))
    out.append(mod.loki_labels(db, {}))
    for name in ("app", "level", "line_label", "absent"):
        out.append(mod.loki_label_values(db, name, {}))
    out.append(mod.loki_series(db, ['{app="api"}', '{level="error"}'], {}))
    out.append(mod.loki_query_range(db, {"query": '{app="web"}', **RANGE,
                                         "table": "absent_logs"}))
    return out


@pytest.fixture(scope="module")
def loki_pair():
    ref, port = RefDB(), GreptimeDB(device="cpu")
    _ref_push(ref, STREAMS)
    assert _port_push(port, STREAMS) == 10
    yield ref, port
    port.close()
    ref.close()


def test_read_api_matches_reference(loki_pair):
    ref, port = loki_pair
    want = _payloads(RL, ref)
    p0 = REGISTRY.value("greptime_fulltext_queries_total", ("prefilter",))
    got = _payloads(PL, port)
    for g, w, q in zip(got, want, QUERIES + INSTANT + [None] * 7):
        assert g == w, q
    assert want[0]["data"]["result"][0]["values"][0][1] == "boom timeout"
    assert REGISTRY.value("greptime_fulltext_queries_total",
                          ("prefilter",)) > p0
    assert port.sql("SELECT DISTINCT tenant FROM loki_logs").rows == [
        ["acme"]]


def test_read_api_on_off_parity(loki_pair, monkeypatch):
    ref, port = loki_pair
    on = _payloads(PL, port)
    monkeypatch.setenv("GREPTIME_FULLTEXT", "off")
    assert _payloads(PL, port) == on
    assert _payloads(RL, ref) == on


def test_bad_queries_raise(loki_pair):
    _ref, port = loki_pair
    for q in ("{app=", 'count_over_time({a="b"})', "nope"):
        with pytest.raises(InvalidArguments):
            PL.loki_query_range(port, {"query": q})
    with pytest.raises(InvalidArguments):
        PL.loki_query_range(port, {})
    with pytest.raises(InvalidArguments):
        PL.loki_query_range(port, {"query": '{app="web"} |~ "("', **RANGE})


def test_protobuf_push_matches_json():
    from greptimedb_tpu_torch.utils.proto import pb_len, pb_vint_field

    def entry(ts_ns, line):
        stamp = (pb_vint_field(1, ts_ns // 10**9)
                 + pb_vint_field(2, ts_ns % 10**9))
        return pb_len(2, pb_len(1, stamp) + pb_len(2, line.encode()))

    body = b""
    for s in STREAMS:
        labels = "{" + ", ".join(f'{k}="{v}"' for k, v in
                                 s["stream"].items()) + "}"
        body += pb_len(1, pb_len(1, labels.encode()) + b"".join(
            entry(int(t), line) for t, line in s["values"]))
    dbs = (GreptimeDB(device="cpu"), GreptimeDB(device="cpu"))
    try:
        assert loki_push(dbs[0], body, "application/x-protobuf",
                         "acme") == 10
        _port_push(dbs[1], STREAMS)
        q = "SELECT app, level, line_label, tenant, ts, line FROM loki_logs"
        assert dbs[0].sql(q).rows == dbs[1].sql(q).rows
    finally:
        for d in dbs:
            d.close()


def test_prewarm_refreshes_resident_fingerprints():
    """A push refingerprints a RESIDENT matrix at ingest (none is built
    before a query), and the warm query sees the new rows, as the
    reference's push does."""
    ref, port = RefDB(), GreptimeDB(device="cpu")
    try:
        first = [{"stream": {"app": "a"}, "values": [
            [str(T0), f"line number {i}"] for i in range(8)]}]
        second = [{"stream": {"app": "a"}, "values": [
            [str(T0 + (100 + i) * 10**9), f"fresh tail {i}"]
            for i in range(4)]}]
        _ref_push(ref, first)
        _port_push(port, first)
        ft = port.engine.executor.fulltext_cache
        assert not any(k[0] == "fp" for k in ft._lru)
        assert not PL.prewarm_ingest(port)
        q = {"query": '{app="a"} |= "number"', **RANGE}
        assert PL.loki_query_range(port, q) == RL.loki_query_range(ref, q)
        n0 = next(ft._lru[k] for k in ft._lru if k[0] == "fp").n
        assert n0 == 8
        _ref_push(ref, second)
        _port_push(port, second)
        entry = next(ft._lru[k] for k in ft._lru if k[0] == "fp")
        table = port.cache.peek_table(port._table_view("loki_logs"))
        assert table is not None and entry.root == table.dicts_root
        assert entry.n == n0 + 4 == len(table.dicts["line"])
        q = {"query": '{app="a"} |= "fresh"', "start": "1700000000",
             "end": "1700000200"}
        got = PL.loki_query_range(port, q)
        assert got == RL.loki_query_range(ref, q)
        assert sum(len(s["values"]) for s in got["data"]["result"]) == 4
    finally:
        port.close()
        ref.close()


# ---- the log-query DSL -----------------------------------------------------------

DSL_LINES = ["error conn reset", "GET /api ok", "warn slow",
             "error timeout", "", "İstanbul error"]
DSL_QUERIES = [
    {"filters": [{"column": "line", "filters": [{"contains": "error"}]}],
     "columns": ["ts", "line"]},
    {"filters": [{"column": "line", "filters": [{"matches": "conn reset"}]}],
     "columns": ["line"]},
    {"filters": [{"column": "line", "filters": [{"match": "conn reset"}]}],
     "columns": ["line"]},
    {"filters": [{"column": "line", "filters": [{"prefix": "GET"}]},
                 {"column": "app", "filters": [{"eq": "a"}]}]},
    {"filters": [{"column": "line", "filters": [{"regex": "err.r"},
                                                {"exists": True}]}],
     "limit": {"fetch": 2, "skip": 1}},
    {"filters": [{"column": "line", "filters": [{"exists": False}]}],
     "columns": ["ts"]},
    {"time_filter": {"start": 1700000000001, "end": 1700000000004},
     "columns": ["ts", "line"]},
]


def test_log_query_dsl_matches_reference():
    ref, port = RefDB(), GreptimeDB(device="cpu")
    try:
        for d in (ref, port):
            d.sql("CREATE TABLE dlogs (app STRING, ts TIMESTAMP TIME INDEX, "
                  "line STRING, PRIMARY KEY(app)) WITH (append_mode='true')")
            for i, line in enumerate(DSL_LINES):
                d.sql(f"INSERT INTO dlogs VALUES ('{'ab'[i % 2]}', "
                      f"{1700000000000 + i}, '{line}')")
        qs = [{"table": {"table": "dlogs"}, **q} for q in DSL_QUERIES]
        for q in qs:  # cold: the host route
            assert execute_log_query(port, q).rows == ref_dsl(ref, q).rows
        port.sql("SELECT count(*) FROM dlogs")  # the table goes resident
        ref.sql("SELECT count(*) FROM dlogs")
        p0 = REGISTRY.value("greptime_fulltext_queries_total",
                            ("prefilter",))
        for q in qs:  # warm: the fingerprint route
            got, want = execute_log_query(port, q), ref_dsl(ref, q)
            assert got.column_names == want.column_names
            assert got.rows == want.rows, q
        assert REGISTRY.value("greptime_fulltext_queries_total",
                              ("prefilter",)) > p0
        with pytest.raises(InvalidArguments):
            execute_log_query(port, {"table": {"table": "dlogs"},
                                     "filters": [{"column": "line",
                                                  "filters": [{"nope": 1}]}]})
    finally:
        port.close()
        ref.close()


# ---- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("valid", [True, False])
def test_cuda_k17_kernels_match_plain(cuda_device, valid):
    ts, tsid, codes, mask, verified, blen = _k17_case(5, n=70_000,
                                                      npad_rows=1 << 17,
                                                      nseries=3000,
                                                      valid=valid)
    cpu = [torch.from_numpy(a) for a in (ts, tsid, codes, mask, verified,
                                         blen)]
    dev = [t.to(cuda_device) for t in cpu]
    t_, s_, c_, m_, v_, b_ = cpu
    T, S, C, M, V, B = dev
    for g, w in zip(FK.logs_layout(T, S, M), FK.logs_layout(t_, s_, m_)):
        assert torch.equal(g.cpu(), w)
    for blen_cpu, blen_dev in ((None, None), (b_, B)):
        for g, w in zip(FK.line_vals(C, V, M, blen_dev),
                        FK.line_vals(c_, v_, m_, blen_cpu)):
            assert torch.equal(g.cpu(), w)
    lo, hi = 1_700_000_010_000, 1_700_000_040_000
    for sel in (*SELS.values(), np.array([2999, 5000, 7, -1], np.int32)):
        want = FK.row_match(c_, v_, m_, t_, s_, torch.from_numpy(sel), lo, hi)
        for nbits in (3000, 100, 0):
            got = FK.row_match(C, V, M, T, S,
                               torch.from_numpy(sel).to(cuda_device), lo, hi,
                               num_series=nbits)
            assert torch.equal(got.cpu(), want), (sel, nbits)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_read_api_matches_cpu(cuda_device):
    dbs = (GreptimeDB(device="cuda"), GreptimeDB(device="cpu"))
    try:
        for d in dbs:
            _port_push(d, STREAMS)
        FK.reset_launch_counts()
        got = _payloads(PL, dbs[0])
        launches = (FK.logs_layout.launches, FK.line_vals.launches,
                    FK.row_match.launches, FK.fp_candidates.launches)
        assert got == _payloads(PL, dbs[1])
        assert all(n > 0 for n in launches), launches
    finally:
        for d in dbs:
            d.close()
