"""Port parity end to end: ``greptimedb_tpu_torch.standalone.GreptimeDB``.

The port (``device="cpu"``) and the JAX reference run the same CREATE /
INSERT / bulk region write / flush and the TSBS double-groupby-all query;
rows must be equal under the golden comparer's rule (numeric cells
``|a-b| <= 1e-5*max(1,|b|)``, tests/test_golden.py).  The port also opens
a data home the reference wrote.  A subprocess checks that importing the
port loads neither JAX nor the reference package, and the device rule is
checked: the card unless the caller asks for the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.device import resolve_device
from greptimedb_tpu_torch.errors import InvalidArguments, Unsupported
from greptimedb_tpu_torch.standalone import GreptimeDB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_451_606_400_000
H = 3_600_000
HOSTS, HOURS, SPH = 16, 3, 360
METRICS = ("usage_user", "usage_system", "usage_idle")
DDL = (f"CREATE TABLE cpu (hostname STRING, ts TIMESTAMP(3) TIME INDEX, "
       f"{', '.join(f'{m} DOUBLE' for m in METRICS)}, "
       f"PRIMARY KEY (hostname))")
AVGS = ", ".join(f"avg({m})" for m in METRICS)
TSBS = (f"SELECT hostname, date_trunc('hour', ts) AS hour, {AVGS} "
        f"FROM cpu WHERE ts >= {T0 + H} AND ts < {T0 + 3 * H} "
        f"GROUP BY hostname, hour")
QUERIES = [
    TSBS,
    TSBS.replace("GROUP BY", "AND hostname IN ('host_2', 'host_7') GROUP BY"),
    (f"SELECT hostname, date_trunc('hour', ts) AS hour, min(usage_user), "
     f"max(usage_idle) FROM cpu WHERE ts >= {T0 + 300_000} AND "
     f"ts < {T0 + 2 * H} GROUP BY hostname, hour ORDER BY hostname, hour"),
    ("SELECT hostname, count(*), sum(usage_system) FROM cpu "
     "GROUP BY hostname HAVING count(*) > 10 ORDER BY hostname DESC LIMIT 5"),
    "SELECT count(*), avg(usage_user) FROM cpu",
]


def _ingest(db, flush=True):
    """bench.py's shape at test size: one bulk region.write per hour
    (+ flush), then a few SQL INSERT rows in the memtable."""
    db.sql(DDL)
    region = db._region_of("cpu")
    rng = np.random.default_rng(7)
    names = np.array([f"host_{i}" for i in range(HOSTS)], dtype=object)
    state = rng.uniform(0, 100, size=(HOSTS, len(METRICS)))
    for h in range(HOURS):
        ts = T0 + (h * SPH + np.repeat(np.arange(SPH), HOSTS)) * 10_000
        walk = rng.normal(0, 1, size=(SPH, HOSTS, len(METRICS)))
        series = np.clip(state[None] + np.cumsum(walk, axis=0), 0, 100)
        state = series[-1]
        data = {"hostname": np.tile(names, SPH), "ts": ts}
        for j, m in enumerate(METRICS):
            data[m] = series[:, :, j].reshape(-1)
        region.write(data)
        if flush:
            region.flush()
    t = T0 + HOURS * H
    db.sql(f"INSERT INTO cpu VALUES ('host_0', {t}, 1.5, 2.5, 3.5), "
           f"('host_1', {t}, 4.0, 5.0, 6.0)")


def _rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and not isinstance(a, str):
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    ref = RefDB(str(tmp_path_factory.mktemp("ref")))
    port = GreptimeDB(str(tmp_path_factory.mktemp("port")), device="cpu")
    _ingest(ref)
    _ingest(port)
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_port_answers_like_reference(i, dbs):
    ref, port = dbs
    want = ref.sql(QUERIES[i])
    got = port.sql(QUERIES[i])
    assert got.column_names == want.column_names
    assert got.column_types == want.column_types
    _rows_match(got.rows, want.rows)


def test_tsbs_query_shape(dbs):
    _ref, port = dbs
    res = port.sql(TSBS)
    assert res.num_rows == HOSTS * 2
    assert res.column_names[:2] == ["hostname", "hour"]


def test_describe_matches_reference(dbs):
    ref, port = dbs
    assert port.sql("DESCRIBE TABLE cpu").rows == \
        ref.sql("DESCRIBE TABLE cpu").rows


def test_row_path_is_refused_not_faked(dbs):
    """The row path is ported: a raw SELECT answers with the reference's
    rows.  What is not ported is refused, never run as something else."""
    ref, port = dbs
    sql = "SELECT * FROM cpu ORDER BY ts DESC, hostname LIMIT 3"
    got, want = port.sql(sql), ref.sql(sql)
    assert got.column_names == want.column_names
    _rows_match(got.rows, want.rows)
    with pytest.raises(Unsupported):
        port.sql("DROP TABLE cpu")
    with pytest.raises(Unsupported, match="joins"):
        port.sql("SELECT * FROM cpu a JOIN cpu b ON a.ts = b.ts")


@pytest.mark.parametrize("flush", [True, False])
def test_port_opens_reference_data_home(flush, tmp_path):
    home = str(tmp_path / "shared")
    ref = RefDB(home)
    _ingest(ref, flush=flush)
    want = [ref.sql(q) for q in QUERIES]
    ref.close(flush=True)
    port = GreptimeDB(home, device="cpu")
    try:
        for q, w in zip(QUERIES, want):
            _rows_match(port.sql(q).rows, w.rows)
    finally:
        port.close()


PROM_DDL = ("CREATE TABLE http_requests_total (pod STRING, container STRING, "
            "ts TIMESTAMP(3) TIME INDEX, val DOUBLE, "
            "PRIMARY KEY (pod, container))")
PROM_T0 = 1_700_000_000_000
PROM_TQL = [
    f"TQL EVAL ({(PROM_T0 + 300_000) / 1000}, {(PROM_T0 + 585_000) / 1000}, "
    f"15) sum by (pod) (rate(http_requests_total[5m]))",
    f"TQL EVAL ({PROM_T0 / 1000}, {(PROM_T0 + 600_000) / 1000}, 60) "
    f"increase(http_requests_total{{pod=\"pod-3\"}}[2m])",
]


@pytest.mark.parametrize("flush", [True, False])
def test_port_opens_reference_promql_home(flush, tmp_path):
    """Counters written and flushed by the reference are served by the
    port on the CPU with the reference's TQL rows."""
    home = str(tmp_path / "prom")
    ref = RefDB(home)
    ref.sql(PROM_DDL)
    region = ref._region_of("http_requests_total")
    rng = np.random.default_rng(5)
    n = 12 * 3
    pods = np.array([f"pod-{i}" for i in range(12)], dtype=object)
    conts = np.array(["a", "b", "c"], dtype=object)
    c = rng.uniform(0, 100, n)
    for k in range(40):
        c = c + rng.uniform(100, 200, n)
        c = np.where(rng.random(n) < 0.05, rng.uniform(0, 10, n), c)
        region.write({"pod": pods[np.arange(n) // 3],
                      "container": conts[np.arange(n) % 3],
                      "ts": np.full(n, PROM_T0 + k * 15_000, np.int64),
                      "val": np.where(rng.random(n) < 0.02, np.nan, c)})
        if flush and k == 20:
            region.flush()
    want = [ref.sql(q) for q in PROM_TQL]
    ref.close(flush=True)
    port = GreptimeDB(home, device="cpu")
    try:
        for q, w in zip(PROM_TQL, want):
            got = port.sql(q)
            assert w.num_rows > 0
            assert got.column_names == w.column_names
            _rows_match(got.rows, w.rows)
    finally:
        port.close()


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import greptimedb_tpu_torch.standalone\n"
        "import greptimedb_tpu_torch.query.physical\n"
        "import greptimedb_tpu_torch.ops.grid_kernels\n"
        "import greptimedb_tpu_torch.storage.grid\n"
        "import greptimedb_tpu_torch.meta.ddl\n"
        "import greptimedb_tpu_torch.ops.promql_kernels\n"
        "import greptimedb_tpu_torch.promql.engine\n"
        "import greptimedb_tpu_torch.compile.fused\n"
        "import greptimedb_tpu_torch.storage.inverted\n"
        "import greptimedb_tpu_torch.ops.segment\n"
        "import greptimedb_tpu_torch.ops.segment_kernels\n"
        "import greptimedb_tpu_torch.ops.masks\n"
        "import greptimedb_tpu_torch.ops.fulltext_kernels\n"
        "import greptimedb_tpu_torch.fulltext.resident\n"
        "import greptimedb_tpu_torch.fulltext.loki as loki\n"
        "import greptimedb_tpu_torch.servers.ingest as ingest\n"
        "import greptimedb_tpu_torch.servers.logquery\n"
        "db = greptimedb_tpu_torch.standalone.GreptimeDB(device='cpu')\n"
        "db.sql(\"CREATE TABLE t (h STRING, ts TIMESTAMP(3) TIME INDEX, "
        "v DOUBLE, PRIMARY KEY (h))\")\n"
        "db.sql(\"INSERT INTO t VALUES ('a', 0, 1.0), ('a', 10, 3.0)\")\n"
        "assert db.sql('SELECT h, avg(v) FROM t GROUP BY h').rows == "
        "[['a', 2.0]]\n"
        "assert db.sql('SELECT h, last_value(v) FROM t GROUP BY h').rows == "
        "[['a', 3.0]]\n"
        "assert db.sql('SELECT v FROM t WHERE v > 2').rows == [[3.0]]\n"
        "r = db.sql('TQL EVAL (0, 0.01, 0.01) sum by (h) (increase(t[1s]))')\n"
        "assert r.column_names == ['h', 'ts', 'val'] and r.num_rows == 1\n"
        "body = b'{\"streams\": [{\"stream\": {\"app\": \"a\"}, "
        "\"values\": [[\"1000000000\", \"conn refused\"], "
        "[\"2000000000\", \"ok\"]]}]}'\n"
        "assert ingest.loki_push(db, body) == 2\n"
        "r = loki.loki_query_range(db, {'query': "
        "'count_over_time({app=\"a\"} |= \"refused\" [5s])', "
        "'start': '2', 'end': '2', 'step': '1'})\n"
        "assert r['data']['result'][0]['values'] == [[2.0, '1']], r\n"
        "assert db.sql(\"SELECT count(*) FROM loki_logs WHERE "
        "matches_term(line, 'refused')\").rows == [[1]]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'greptimedb_tpu' or "
        "m.startswith('greptimedb_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(InvalidArguments):
        resolve_device("mps")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert GreptimeDB().device.type == "cuda"
    else:
        for dev in (None, "cuda", "cuda:0"):
            with pytest.raises(InvalidArguments, match="device='cpu'"):
                resolve_device(dev)
        with pytest.raises(InvalidArguments):
            GreptimeDB()
