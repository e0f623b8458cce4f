"""Port parity of continuous aggregation: flows on the CPU.

The port (``device="cpu"``: the ``flow_merge`` and ``segment_reduce``
kernels' plain versions) and the JAX reference run the same DDL, flows and
seeded ingest batches (integer-valued doubles, so every additive fold is
exact whatever its order) and must give equal sinks, row for row: the
device fold over time-forward and out-of-order batches, NULLs, multi-key
and int-tag keys, first/last picks, EXPIRE AFTER and an upsert that forces
a reseed; host-stream sketch flows; batching flows; SHOW FLOWS and DROP
FLOW.  Restarts: a clean restart restores from the GTF1 checkpoint with no
reseed, a crash resumes by WAL-tail replay, and a checkpoint written by
the reference restores into the port.  The ``cuda`` tests hold the
``flow_merge`` kernel (pad slots included) and a whole flow on the card to
the plain route.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch
from test_flow_device import FLOW_SQL, _mk_source, _seeded_batches, _sink_rows

from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.flow.engine import flow_mode
from greptimedb_tpu_torch.ops import flow_kernels as FK
from greptimedb_tpu_torch.standalone import GreptimeDB


def _port(home=None, device="cpu"):
    return GreptimeDB(home, device=device)


@pytest.fixture
def pair():
    dbs = (_port(), RefDB())
    yield dbs
    for d in dbs:
        d.close()


def _both(dbs, *stmts):
    for s in stmts:
        for d in dbs:
            d.sql(s)


def _rows_equal(dbs, q):
    got, want = (d.sql(q).rows for d in dbs)
    assert got == want
    return got


@pytest.mark.parametrize("seed,ordered", [(3, False), (11, False),
                                          (29, True), (43, True)])
def test_device_fold_matches_reference(pair, seed, ordered):
    """Every aggregate kind of FLOW_SQL over NULLs and a growing tag
    vocabulary: time-forward batches fold incrementally (one reseed, the
    seed itself), out-of-order ones reseed on both sides."""
    port, ref = pair
    for d in pair:
        _mk_source(d)
        d.sql(FLOW_SQL.format(name="f", sink="agg", src="src"))
    _both(pair, *_seeded_batches(seed, ordered=ordered))
    assert flow_mode(port.flow_engine.flows["f"]) == "streaming(device)"
    assert port.flow_runtime.reseeds == ref.flow_runtime.reseeds
    if ordered:
        assert port.flow_runtime.reseeds <= 1
    assert port.flow_runtime.fold_dispatches == ref.flow_runtime.fold_dispatches
    rows = _sink_rows(port)
    assert rows and rows == _sink_rows(ref)


def test_flow_sql_streams_on_the_device(pair):
    """The port has no metric engine: every source is plain and FLOW_SQL
    folds on the device, never silently on the host."""
    port, _ref = pair
    _mk_source(port)
    port.sql(FLOW_SQL.format(name="f", sink="agg", src="src"))
    port.sql("INSERT INTO src VALUES ('x', 1000, 1.0, 2), ('y', 70000, 2.0, 3)")
    task = port.flow_engine.flows["f"]
    assert flow_mode(task) == "streaming(device)"
    assert not task.device_failed and port.flow_runtime.fallbacks == 0
    assert port.flow_runtime.fold_dispatches >= 1


def test_multi_key_int_tag_and_upsert_match_reference(pair):
    _both(pair,
          "CREATE TABLE m (a STRING, b STRING, code BIGINT, "
          "ts TIMESTAMP(3) TIME INDEX, v DOUBLE, PRIMARY KEY (a, b, code))",
          "CREATE FLOW f SINK TO agg AS SELECT a, b, code, sum(v) AS s, "
          "count(*) AS c, min(v) AS mn, last_value(v) AS lv FROM m "
          "GROUP BY a, b, code")
    rng = np.random.default_rng(7)
    for _ in range(4):
        vals = ", ".join(
            f"('a{rng.integers(0, 4)}', 'b{rng.integers(0, 3)}', "
            f"{rng.integers(200, 205)}, {rng.integers(0, 10_000)}, "
            f"{float(rng.integers(1, 50))})" for _ in range(16))
        _both(pair, f"INSERT INTO m VALUES {vals}")
    # an upsert of an existing (series, ts) row: both sides reseed
    _both(pair, "INSERT INTO m VALUES ('a0', 'b0', 200, 0, 99.0)")
    assert pair[0].flow_engine.flows["f"].device_state is not None
    _rows_equal(pair, "SELECT a, b, code, s, c, mn, lv FROM agg "
                      "ORDER BY a, b, code")


def test_upsert_reseed_matches_reference(pair):
    for d in pair:
        _mk_source(d)
        d.sql("CREATE FLOW f SINK TO agg AS SELECT "
              "date_bin(INTERVAL '1 minute', ts) AS w, h, sum(v) AS s, "
              "first_value(v) AS fv FROM src GROUP BY w, h")
    _both(pair, "INSERT INTO src VALUES ('x', 1000, 1.0, 1)",
          "INSERT INTO src VALUES ('x', 1000, 5.0, 1)",
          "INSERT INTO src VALUES ('x', 2000, 2.0, 1)")
    assert _rows_equal(pair, "SELECT w, h, s, fv FROM agg") == [
        [0, "x", 7.0, 5.0]]
    assert pair[0].flow_runtime.reseeds == pair[1].flow_runtime.reseeds


def test_expire_after_matches_reference(pair):
    now = int(time.time() * 1000)
    for d in pair:
        _mk_source(d)
        d.sql("CREATE FLOW f SINK TO agg EXPIRE AFTER '1 hour' AS SELECT "
              "date_bin(INTERVAL '1 minute', ts) AS w, h, sum(v) AS s, "
              "max(v) AS mx FROM src GROUP BY w, h")
    _both(pair, f"INSERT INTO src VALUES ('x', {now}, 2.0, 1), "
                f"('y', {now - 120_000}, 4.0, 1)",
          "INSERT INTO src VALUES ('x', 1000, 5.0, 1)",  # expired window
          f"INSERT INTO src VALUES ('x', {now + 1}, 3.0, 1)")
    _rows_equal(pair, "SELECT w, h, s, mx FROM agg ORDER BY w, h")
    port, ref = pair
    assert port.flow_engine.state_keys("f") == ref.flow_engine.state_keys("f")


SKETCH_FLOWS = [
    "SELECT h, approx_distinct(v) AS m FROM src GROUP BY h",
    "SELECT date_bin(INTERVAL '1 minute', ts) AS w, h, hll(v) AS hs, "
    "uddsketch_state(64, 0.02, v) AS us FROM src GROUP BY w, h",
]


@pytest.mark.parametrize("query", SKETCH_FLOWS)
def test_host_stream_sketch_flows_match_reference(pair, query):
    for d in pair:
        _mk_source(d)
        if "hll(" in query:
            # sketch states are strings: a derived sink would be DOUBLE
            d.sql("CREATE TABLE agg (w TIMESTAMP(3) TIME INDEX, h STRING, "
                  "hs STRING, us STRING, PRIMARY KEY (h))")
        d.sql(f"CREATE FLOW f SINK TO agg AS {query}")
    _both(pair, *_seeded_batches(13, nbatches=4, ordered=True))
    assert flow_mode(pair[0].flow_engine.flows["f"]) == "streaming"
    cols = "h, m" if "approx" in query else "w, h, hs, us"
    rows = _rows_equal(pair, f"SELECT {cols} FROM agg ORDER BY {cols}")
    assert rows


def test_batching_flows_match_reference(pair):
    for d in pair:
        _mk_source(d)
        d.sql("CREATE FLOW fd SINK TO agg AS SELECT "
              "date_bin(INTERVAL '1 minute', ts) AS w, h, "
              "count(DISTINCT v) AS dv FROM src GROUP BY w, h")
        d.sql("CREATE FLOW fl SINK TO top AS SELECT "
              "date_bin(INTERVAL '1 minute', ts) AS w, h, sum(v) AS s "
              "FROM src GROUP BY w, h ORDER BY s DESC LIMIT 1")
    _both(pair, *_seeded_batches(17, nbatches=4))
    assert flow_mode(pair[0].flow_engine.flows["fd"]) == "batching"
    assert flow_mode(pair[0].flow_engine.flows["fl"]) == "batching"
    assert _rows_equal(pair, "SELECT w, h, dv FROM agg ORDER BY w, h")
    _rows_equal(pair, "SELECT w, h, s FROM top ORDER BY w, h")


def test_show_and_drop_flows_match_reference(pair):
    for d in pair:
        _mk_source(d)
        d.sql(FLOW_SQL.format(name="f", sink="agg", src="src"))
        d.sql("CREATE FLOW g SINK TO agg2 COMMENT 'host' AS SELECT h, "
              "sum(v) AS s FROM src WHERE v > 0 GROUP BY h")
    _both(pair, *_seeded_batches(5, nbatches=2, ordered=True))

    def show(d):
        res = d.sql("SHOW FLOWS")
        last = res.column_names.index("LastTick")
        return res.column_names, [r[:last] + r[last + 1:] for r in res.rows]

    got, want = (show(d) for d in pair)
    assert got == want
    assert [r[4] for r in got[1]] == ["streaming(device)", "streaming"]
    _both(pair, "DROP FLOW f", "DROP FLOW IF EXISTS nope")
    assert [show(d)[1] for d in pair][0] == [show(d)[1] for d in pair][1]
    assert list(pair[0].flow_engine.flows) == ["g"]
    assert "f" not in pair[0].flow_runtime.states


def test_clean_restart_restores_without_reseed(tmp_path):
    home = str(tmp_path / "d")
    d = _port(home)
    _mk_source(d)
    d.sql(FLOW_SQL.format(name="f", sink="agg", src="src"))
    for stmt in _seeded_batches(5, nbatches=3):
        d.sql(stmt)
    before = _sink_rows(d)
    d.close()  # graceful: checkpoints every dirty flow
    d2 = _port(home)
    try:
        task = d2.flow_engine.flows["f"]
        assert task.restored_from_checkpoint
        assert d2.flow_runtime.last_restore.get("f") == "checkpoint"
        assert d2.flow_runtime.reseeds == 0
        assert _sink_rows(d2) == before
        d2.sql("INSERT INTO src VALUES ('h0', 1000, 3.0, 1)")
        requeried = d2.sql(
            "SELECT date_bin(INTERVAL '1 minute', ts) AS w, h, sum(v), "
            "count(*), count(v), avg(v), min(v), max(v), first_value(v), "
            "last_value(v), sum(k) FROM src GROUP BY w, h ORDER BY w, h"
        ).rows
        assert _sink_rows(d2) == requeried
    finally:
        d2.close()


def test_crash_resumes_by_wal_tail_replay(tmp_path):
    from greptimedb_tpu_torch.utils.telemetry import REGISTRY

    d, twin = _port(str(tmp_path / "d")), _port(str(tmp_path / "twin"))
    for x in (d, twin):
        _mk_source(x)
        x.sql(FLOW_SQL.format(name="f", sink="agg", src="src"))
    batches = _seeded_batches(23, nbatches=6, ordered=True)
    for stmt in batches[:3]:
        d.sql(stmt)
        twin.sql(stmt)
    assert d.flow_engine.checkpoint_now("f") >= 1
    for stmt in batches[3:5]:
        d.sql(stmt)
        twin.sql(stmt)
    d.flow_checkpoints = None  # crash: no final checkpoint
    d.close()
    replays = REGISTRY.value("greptime_flow_checkpoint_total",
                             ("tail_replay",))
    d2 = _port(str(tmp_path / "d"))
    try:
        task = d2.flow_engine.flows["f"]
        assert task.restored_from_checkpoint
        assert d2.flow_runtime.reseeds == 0
        assert REGISTRY.value("greptime_flow_checkpoint_total",
                              ("tail_replay",)) > replays
        d2.sql(batches[5])
        twin.sql(batches[5])
        assert _sink_rows(d2) == _sink_rows(twin)
    finally:
        d2.close()
        twin.close()


def test_reference_checkpoint_restores_into_port(tmp_path):
    """Fold the same batches in both packages, crash the port, hand it the
    reference's GTF1 checkpoint (watermark at batch 3, a two-batch WAL
    tail behind it), fold the same further batches: equal sinks."""
    hp, hr = str(tmp_path / "port"), str(tmp_path / "ref")
    port, ref = _port(hp), RefDB(hr)
    for d in (port, ref):
        _mk_source(d)
        d.sql(FLOW_SQL.format(name="f", sink="agg", src="src"))
    batches = _seeded_batches(31, nbatches=8, ordered=True)
    for stmt in batches[:3]:
        port.sql(stmt)
        ref.sql(stmt)
    assert ref.flow_engine.checkpoint_now("f") >= 1
    for stmt in batches[3:5]:
        port.sql(stmt)
        ref.sql(stmt)
    port.flow_checkpoints = None  # crash: no checkpoint of its own
    port.close()
    os.makedirs(os.path.join(hp, "flow_ckpt"), exist_ok=True)
    shutil.copy(os.path.join(hr, "flow_ckpt", "f.ckpt"),
                os.path.join(hp, "flow_ckpt", "f.ckpt"))
    port = _port(hp)
    try:
        task = port.flow_engine.flows["f"]
        assert task.restored_from_checkpoint
        assert port.flow_runtime.last_restore.get("f") == "checkpoint"
        assert port.flow_runtime.reseeds == 0
        for stmt in batches[5:]:
            port.sql(stmt)
            ref.sql(stmt)
        rows = _sink_rows(port)
        assert rows and rows == _sink_rows(ref)
    finally:
        port.close()
        ref.close()


# ---- on the card ------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _merge_case(seed, gpad=64, wpad=8, n_aff=300, apad=512):
    """A random accumulator plan (every kind, a pick linked to each
    companion), state with empty and filled slots, unique affected slots
    and pad slots at aff_g = gpad."""
    rng = np.random.default_rng(seed)
    kinds = ["add_f64", "add_i64", "min_f64", "max_f64", "pick", "ts_min",
             "pick", "ts_max", "add_i64"]
    links = [-1, -1, -1, -1, 5, -1, 7, -1, -1]
    rows = rng.integers(0, 3, (gpad, wpad)).astype(np.int64)
    state = []
    for k in kinds:
        if k in ("add_i64", "ts_min", "ts_max"):
            state.append(rng.integers(-50, 50, (gpad, wpad)).astype(np.int64))
        else:
            state.append(rng.integers(-50, 50, (gpad, wpad)).astype(
                np.float64))
    state.append(rows)
    flat = rng.choice(gpad * wpad, n_aff, replace=False)
    aff_g = np.full(apad, gpad, np.int32)
    aff_w = np.zeros(apad, np.int32)
    aff_g[:n_aff], aff_w[:n_aff] = flat // wpad, flat % wpad
    chunk = [rng.integers(-50, 50, apad).astype(s.dtype) for s in state[:-1]]
    rows_any = rng.integers(0, 3, apad).astype(np.int64)
    return state, chunk, rows_any, aff_g, aff_w, kinds, links


def test_flow_merge_plain_skips_pad_slots():
    state, chunk, rows_any, aff_g, aff_w, kinds, links = _merge_case(1)
    t = [torch.from_numpy(s.copy()) for s in state]
    outs = FK.flow_merge(t, [torch.from_numpy(c) for c in chunk],
                         torch.from_numpy(rows_any), torch.from_numpy(aff_g),
                         torch.from_numpy(aff_w), kinds, links)
    pads = aff_g >= state[-1].shape[0]
    for o in outs:
        assert (o.numpy()[pads] == 0).all()
    untouched = np.ones(state[-1].shape, dtype=bool)
    live = ~pads
    untouched[aff_g[live], aff_w[live]] = False
    for s0, s1 in zip(state, t):
        np.testing.assert_array_equal(s1.numpy()[untouched], s0[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2])
def test_cuda_flow_merge_matches_plain(cuda_device, seed):
    state, chunk, rows_any, aff_g, aff_w, kinds, links = _merge_case(seed)
    plain = [torch.from_numpy(s.copy()) for s in state]
    want = FK.flow_merge(plain, [torch.from_numpy(c) for c in chunk],
                         torch.from_numpy(rows_any), torch.from_numpy(aff_g),
                         torch.from_numpy(aff_w), kinds, links)
    dev = [torch.from_numpy(s.copy()).to(cuda_device) for s in state]
    got = FK.flow_merge(dev, [torch.from_numpy(c).to(cuda_device)
                              for c in chunk],
                        torch.from_numpy(rows_any).to(cuda_device),
                        torch.from_numpy(aff_g).to(cuda_device),
                        torch.from_numpy(aff_w).to(cuda_device), kinds, links)
    torch.cuda.synchronize()
    for a, b in zip(got + dev, want + plain):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_flow_matches_cpu(cuda_device):
    dbs = (_port(device="cuda"), _port())
    try:
        for d in dbs:
            _mk_source(d)
            d.sql(FLOW_SQL.format(name="f", sink="agg", src="src"))
        for stmt in _seeded_batches(29, ordered=True):
            for d in dbs:
                d.sql(stmt)
        assert flow_mode(dbs[0].flow_engine.flows["f"]) == "streaming(device)"
        assert _sink_rows(dbs[0]) == _sink_rows(dbs[1])
    finally:
        for d in dbs:
            d.close()
