"""The write path's kernels on the card: ``extend_merge`` (K23) and
``grid_scatter`` / ``grid_scatter_steps`` (K24), bit for bit against
their plain versions.

extend_merge: resident tables whose live rows end on and around a block
edge (255, 256, 257 rows and a multi-block one), deltas of 1, 4,095 and
4,097 rows, a delta that grows the padding bucket, one of new series only,
NaN and +-inf values, the 0-row delta, and the two-pass delta sort (a key
span past 63 bits).  K24, both kernels (grid_scatter: any cells;
grid_scatter_steps: whole steps): NaN and +-inf values, tombstone flags,
series and step counts off the 32 x 32 tile, permuted series sequences,
steps with gaps, a grown time axis, a ragged last step (grid_scatter),
the launch counters, and a grid of more than 2^31 cells a plane, so both
the plane offsets and the in-plane offsets need 64 bits.

The tests of ``step_cells`` (the host-side detection of whole steps) and
of the plain versions run on the CPU; every other test here needs a CUDA card
and skips without one.  The file imports no JAX (the CPU parity with the
reference is ``tests/test_torch_extend.py``).
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.ops import storage_kernels as stk
from greptimedb_tpu_torch.storage import grid as pgrid

TSID = "__tsid__"
PADS = {"ts": 0, TSID: 0, "v": np.nan, "code": -1, "op": 0, "w": 0}
DTYPES = {"ts": np.int64, TSID: np.int32, "v": np.float32,
          "code": np.int32, "op": np.int8, "w": np.int16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _table(rng, n_series, n_old, padded, span_ms=1000):
    """n_old live rows of distinct (tsid, ts) keys in (tsid, ts) order,
    every ts below the delta's, then pad rows."""
    keys = np.sort(rng.choice(n_series * 50, n_old, replace=False))
    tsid = (keys // 50).astype(np.int32)
    ts = ((keys % 50) * span_ms).astype(np.int64)
    cols = {"ts": ts, TSID: tsid,
            "v": rng.normal(size=n_old).astype(np.float32),
            "code": (tsid * 7 % 11).astype(np.int32),
            "op": rng.integers(0, 2, n_old).astype(np.int8),
            "w": rng.integers(-300, 300, n_old).astype(np.int16)}
    cols["v"][rng.random(n_old) < 0.05] = np.nan
    out = {}
    for k, v in cols.items():
        full = np.full(padded, PADS[k], dtype=DTYPES[k])
        full[:n_old] = v
        out[k] = full
    return out


def _delta(rng, n_series, dn, ts_min, series_lo=0, span=4096, step=1000):
    keys = rng.choice((n_series - series_lo) * span, dn, replace=False)
    tsid = (series_lo + keys // span).astype(np.int32)
    ts = (ts_min + (keys % span) * step).astype(np.int64)
    v = rng.normal(size=dn).astype(np.float32)
    v[rng.random(dn) < 0.05] = np.inf
    v[rng.random(dn) < 0.05] = -np.inf
    v[rng.random(dn) < 0.05] = np.nan
    return {"ts": ts, TSID: tsid, "v": v,
            "code": (tsid * 7 % 11).astype(np.int32),
            "op": np.zeros(dn, np.int8),
            "w": rng.integers(-300, 300, dn).astype(np.int16)}


def _check_merge(dev, old, n_old, delta, new_padded, n_series):
    cpu_old = {k: torch.from_numpy(v) for k, v in old.items()}
    cpu_delta = {k: torch.from_numpy(v) for k, v in delta.items()}
    want, want_mask = stk.extend_merge_plain(cpu_old, n_old, cpu_delta,
                                             new_padded, PADS, tsid=TSID,
                                             ts="ts")
    n0 = stk.extend_merge.launches
    got, got_mask = stk.extend_merge(
        {k: v.to(dev) for k, v in cpu_old.items()}, n_old,
        {k: v.to(dev) for k, v in cpu_delta.items()}, new_padded, PADS,
        n_series, tsid=TSID, ts="ts")
    torch.cuda.synchronize()
    assert stk.extend_merge.launches == n0 + 1
    assert torch.equal(got_mask.cpu(), want_mask)
    for k in old:
        # bit for bit, NaN payloads and pad rows included
        assert got[k].cpu().numpy().tobytes() == want[k].numpy().tobytes(), k


@pytest.mark.cuda
@pytest.mark.parametrize("n_old", [0, 255, 256, 257, 9000])
@pytest.mark.parametrize("dn", [1, 4095, 4097])
def test_cuda_extend_merge_matches_plain(cuda_device, n_old, dn):
    rng = np.random.default_rng(n_old * 7 + dn)
    n_series = 300
    padded = max(256, 1 << (max(n_old, 1) - 1).bit_length())
    old = _table(rng, n_series, n_old, padded)
    ts_min = int(old["ts"][:n_old].max()) + 1000 if n_old else 0
    delta = _delta(rng, n_series, dn, ts_min)
    new_padded = max(padded, 1 << (n_old + dn - 1).bit_length())
    _check_merge(cuda_device, old, n_old, delta, new_padded, n_series)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grows", "new_series_only", "empty_delta",
                                  "all_new", "two_pass"])
def test_cuda_extend_merge_cases(cuda_device, case):
    rng = np.random.default_rng(len(case))
    n_series, n_old, padded, dn, new_padded, lo = {
        "grows": (200, 3000, 4096, 2000, 8192, 0),
        "new_series_only": (260, 3000, 4096, 900, 4096, 200),
        "empty_delta": (200, 3000, 4096, 0, 4096, 0),
        "all_new": (64, 0, 256, 200, 256, 0),
        "two_pass": (1 << 13, 3000, 4096, 700, 4096, 0),
    }[case]
    old = _table(rng, min(n_series, 200), n_old, padded)
    ts_min = int(old["ts"][:n_old].max()) + 1000 if n_old else 0
    step = 1 << 40 if case == "two_pass" else 1000
    delta = _delta(rng, n_series, dn, ts_min, lo, span=4096, step=step)
    key = stk.delta_order_key(torch.from_numpy(delta[TSID]),
                              torch.from_numpy(delta["ts"]), n_series)
    assert (key is None) == (case == "two_pass")
    r0 = sk.radix_argsort.launches
    _check_merge(cuda_device, old, n_old, delta, new_padded, n_series)
    # the delta's sort: one pass, two for the wide keys, none for no rows
    assert sk.radix_argsort.launches - r0 == {"two_pass": 2,
                                              "empty_delta": 0}.get(case, 1)


def _scatter_case(rng, c, spad, tpad, n, seed_cells=None):
    cells = rng.choice(spad * tpad, n, replace=False) if seed_cells is None \
        else seed_cells
    tsid = torch.from_numpy((cells // tpad).astype(np.int64))
    tidx = torch.from_numpy((cells % tpad).astype(np.int64))
    delta = rng.normal(size=(c, n)).astype(np.float32)
    delta[rng.random((c, n)) < 0.05] = np.nan
    delta[rng.random((c, n)) < 0.05] = np.inf
    delta[rng.random((c, n)) < 0.05] = -np.inf
    flags = torch.from_numpy(rng.random(n) < 0.9)
    return tsid, tidx, torch.from_numpy(delta), flags


@pytest.mark.cuda
@pytest.mark.parametrize("c,spad,tpad,n", [(1, 64, 64, 1), (3, 256, 2048, 4095),
                                           (10, 4096, 10240, 100_000)])
def test_cuda_grid_scatter_matches_plain(cuda_device, c, spad, tpad, n):
    rng = np.random.default_rng(c * 1000 + n)
    values = torch.from_numpy(rng.normal(size=(c, spad, tpad)).astype(
        np.float32))
    valid = torch.from_numpy(rng.random((spad, tpad)) < 0.5)
    tsid, tidx, delta, flags = _scatter_case(rng, c, spad, tpad, n)
    want_v, want_m = values.clone(), valid.clone()
    stk.grid_scatter_plain(want_v, want_m, tsid, tidx, delta, flags)
    got_v, got_m = values.to(cuda_device), valid.to(cuda_device)
    n0 = stk.grid_scatter.launches
    stk.grid_scatter(got_v, got_m, tsid.to(cuda_device),
                     tidx.to(cuda_device), delta.to(cuda_device),
                     flags.to(cuda_device))
    torch.cuda.synchronize()
    assert stk.grid_scatter.launches == n0 + 1
    assert got_v.cpu().numpy().tobytes() == want_v.numpy().tobytes()
    assert torch.equal(got_m.cpu(), want_m)


@pytest.mark.cuda
def test_cuda_grid_scatter_64bit_offsets(cuda_device):
    """Two planes of 40,960 x 57,344 cells (2.35e9 > 2^31 a plane): cells
    at the end of each plane land where index_put_ puts them."""
    c, spad, tpad = 2, 40_960, 57_344
    free, _total = torch.cuda.mem_get_info()
    need = c * spad * tpad * 4 + spad * tpad
    if free < need + (4 << 30):
        pytest.skip(f"needs {need} B of device memory")
    values = torch.zeros((c, spad, tpad), dtype=torch.float32,
                         device=cuda_device)
    valid = torch.zeros((spad, tpad), dtype=torch.bool, device=cuda_device)
    rng = np.random.default_rng(31)
    plane = spad * tpad
    cells = np.concatenate([
        np.arange(plane - 2000, plane),                  # the very end
        rng.choice(np.arange((1 << 31) - 1000, (1 << 31) + 1000), 500,
                   replace=False),                      # around 2^31
        rng.choice(1 << 20, 100, replace=False)])       # the start
    cells = np.unique(cells)
    tsid, tidx, delta, flags = _scatter_case(rng, c, spad, tpad, len(cells),
                                             seed_cells=cells)
    stk.grid_scatter(values, valid, tsid.to(cuda_device),
                     tidx.to(cuda_device), delta.to(cuda_device),
                     flags.to(cuda_device))
    torch.cuda.synchronize()
    ti, xi = tsid.to(cuda_device), tidx.to(cuda_device)
    got = values[:, ti, xi].cpu()
    assert got.numpy().tobytes() == delta.numpy().tobytes()
    assert torch.equal(valid[ti, xi].cpu(), flags)
    # nothing else was written
    assert int(valid.sum()) == int(flags.sum())
    assert int(torch.count_nonzero(values)) == int(torch.count_nonzero(
        delta))
    # grid_scatter_steps past 2^31 a plane: the last series around 2^31 /
    # tpad and at the end, the last steps of the row
    seq = np.concatenate([np.arange(37_440, 37_460),
                          np.arange(spad - 20, spad)])
    steps = np.arange(tpad - 45, tpad)
    s_tsid, s_tidx = _steps(seq, steps)
    values.zero_()
    valid.zero_()
    s_delta = torch.from_numpy(rng.normal(size=(c, len(s_tsid))).astype(
        np.float32))
    s_flags = torch.from_numpy(rng.random(len(s_tsid)) < 0.9)
    n0 = stk.grid_scatter_steps.launches
    stk.grid_scatter_steps(values, valid,
                           torch.from_numpy(seq).to(cuda_device),
                           torch.from_numpy(steps).to(cuda_device),
                           s_delta.to(cuda_device), s_flags.to(cuda_device))
    torch.cuda.synchronize()
    assert stk.grid_scatter_steps.launches == n0 + 1
    ti = torch.from_numpy(s_tsid).to(cuda_device)
    xi = torch.from_numpy(s_tidx).to(cuda_device)
    assert values[:, ti, xi].cpu().numpy().tobytes() == \
        s_delta.numpy().tobytes()
    assert torch.equal(valid[ti, xi].cpu(), s_flags)
    assert int(valid.sum()) == int(s_flags.sum())
    assert int(torch.count_nonzero(values)) == int(torch.count_nonzero(
        s_delta))


# ---------------------------------------------------------------------------
# grid_scatter_steps: the detection (host numpy) and the plain versions,
# on the CPU
# ---------------------------------------------------------------------------

def _steps(seq, steps):
    """The cells of whole steps in time-major order, as an append brings
    them: (tsid, tidx) int64 [k * S], cell r * S + p = (seq[p], steps[r])."""
    seq, steps = np.asarray(seq, np.int64), np.asarray(steps, np.int64)
    return np.tile(seq, len(steps)), np.repeat(steps, len(seq))


@pytest.mark.parametrize("case", ["tsbs", "one_series", "permuted", "gaps",
                                  "min_steps"])
def test_step_cells_finds_whole_steps(case):
    rng = np.random.default_rng(3)
    seq, steps = {
        "tsbs": (np.arange(4000), 8640 + np.arange(360)),
        "one_series": ([7], np.arange(100, 140)),
        "permuted": (rng.permutation(333), 5 + np.arange(37)),
        "gaps": (np.arange(50), np.cumsum(rng.integers(1, 4, 20))),
        "min_steps": (np.arange(9), np.arange(stk.STEPS_MIN)),
    }[case]
    got = stk.step_cells(*_steps(seq, steps))
    assert got is not None
    np.testing.assert_array_equal(got[0], seq)
    np.testing.assert_array_equal(got[1], steps)
    assert got[0].dtype == got[1].dtype == np.int64


@pytest.mark.parametrize("case", [
    "empty", "one_step", "few_steps", "ragged_last", "ragged_first",
    "duplicate_step", "decreasing", "permutation_changes", "series_major",
    "step_changes_inside_a_row", "lengths_differ", "last_row_permuted",
    "catch_up_part"])
def test_step_cells_refuses(case):
    """Everything but whole steps of one series sequence in strictly
    increasing step order goes to grid_scatter."""
    rng = np.random.default_rng(4)
    seq = np.arange(40)
    tsid, tidx = _steps(seq, np.arange(12))
    if case == "empty":
        tsid, tidx = tsid[:0], tidx[:0]
    elif case == "one_step":
        tsid, tidx = _steps(seq, [5])
    elif case == "few_steps":
        tsid, tidx = _steps(seq, np.arange(stk.STEPS_MIN - 1))
    elif case == "ragged_last":
        tsid, tidx = tsid[:-3], tidx[:-3]
    elif case == "ragged_first":
        tsid, tidx = tsid[3:], tidx[3:]
    elif case == "duplicate_step":
        tsid, tidx = _steps(seq, [0, 1, 2, 3, 3, 4, 5, 6, 7, 8])
    elif case == "decreasing":
        tsid, tidx = _steps(seq, np.arange(12)[::-1])
    elif case == "permutation_changes":
        tsid = tsid.copy()
        perm = rng.permutation(seq)
        assert not np.array_equal(perm, seq)
        tsid[5 * 40:6 * 40] = perm
    elif case == "series_major":
        order = np.lexsort((tidx, tsid))
        tsid, tidx = tsid[order], tidx[order]
    elif case == "step_changes_inside_a_row":
        tidx = tidx.copy()
        tidx[5 * 40 + 17] += 100
    elif case == "lengths_differ":
        tsid = tsid[:-40]
    elif case == "last_row_permuted":  # refused by the rows' ends
        tsid = tsid.copy()
        tsid[-40:] = np.roll(seq, 1)
    elif case == "catch_up_part":  # (tsid, ts) order, steps with gaps
        tsid = np.repeat(seq, 12)
        tidx = np.tile(np.cumsum(rng.integers(1, 3, 12)), 40)
    assert stk.step_cells(tsid, tidx) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_scatter_steps_plain_equals_cells(seed):
    rng = np.random.default_rng(seed)
    c, spad, tpad = 3, 64, 128
    seq = rng.permutation(spad)[:50]
    steps = np.sort(rng.choice(tpad, 20, replace=False))
    tsid, tidx = _steps(seq, steps)
    delta = torch.from_numpy(rng.normal(size=(c, len(tsid))).astype(
        np.float32))
    flags = torch.from_numpy(rng.random(len(tsid)) < 0.8)
    values = torch.from_numpy(rng.normal(size=(c, spad, tpad)).astype(
        np.float32))
    valid = torch.from_numpy(rng.random((spad, tpad)) < 0.5)
    want_v, want_m = values.clone(), valid.clone()
    stk.grid_scatter_plain(want_v, want_m, torch.from_numpy(tsid),
                           torch.from_numpy(tidx), delta, flags)
    got_v, got_m = values.clone(), valid.clone()
    n0 = stk.grid_scatter_steps.launches
    stk.grid_scatter_steps(got_v, got_m, torch.from_numpy(seq).long(),
                           torch.from_numpy(steps).long(), delta, flags)
    assert torch.equal(got_v, want_v) and torch.equal(got_m, want_m)
    assert stk.grid_scatter_steps.launches == n0  # the plain version
    with pytest.raises(ValueError):
        stk.grid_scatter_steps(got_v, got_m, torch.from_numpy(seq).long(),
                               torch.from_numpy(steps[:-1]).long(), delta,
                               flags)


# ---------------------------------------------------------------------------
# K24's two kernels on the card
# ---------------------------------------------------------------------------

def _grid(rng, c, spad, tpad):
    return (torch.from_numpy(rng.normal(size=(c, spad, tpad)).astype(
                np.float32)),
            torch.from_numpy(rng.random((spad, tpad)) < 0.5))


def _both_routes(dev, values, valid, seq, steps, seed):
    """The whole steps (seq x steps) scattered by grid_scatter_steps and
    by grid_scatter into copies of (values, valid) on the card, each bit
    for bit against the plain version on the CPU, with the launch counters
    asserted.  Returns the card's result of grid_scatter_steps."""
    rng = np.random.default_rng(seed)
    c = values.shape[0]
    tsid, tidx = _steps(seq, steps)
    delta = rng.normal(size=(c, len(tsid))).astype(np.float32)
    delta[rng.random(delta.shape) < 0.05] = np.nan
    delta[rng.random(delta.shape) < 0.05] = np.inf
    delta[rng.random(delta.shape) < 0.05] = -np.inf
    flags = torch.from_numpy(rng.random(len(tsid)) < 0.9)  # tombstones
    delta = torch.from_numpy(delta)
    want_v, want_m = values.clone(), valid.clone()
    stk.grid_scatter_plain(want_v, want_m, torch.from_numpy(tsid),
                           torch.from_numpy(tidx), delta, flags)
    args = {"steps": (torch.from_numpy(np.asarray(seq, np.int64)),
                      torch.from_numpy(np.asarray(steps, np.int64))),
            "cells": (torch.from_numpy(tsid), torch.from_numpy(tidx))}
    out = None
    for route, (a, b) in args.items():
        got_v, got_m = values.to(dev), valid.to(dev)
        n0 = stk.grid_scatter_steps.launches, stk.grid_scatter.launches
        wrapper = (stk.grid_scatter_steps if route == "steps"
                   else stk.grid_scatter)
        wrapper(got_v, got_m, a.to(dev), b.to(dev), delta.to(dev),
                flags.to(dev))
        torch.cuda.synchronize()
        assert (stk.grid_scatter_steps.launches - n0[0],
                stk.grid_scatter.launches - n0[1]) == (
            (1, 0) if route == "steps" else (0, 1))
        assert got_v.cpu().numpy().tobytes() == want_v.numpy().tobytes()
        assert torch.equal(got_m.cpu(), want_m)
        if route == "steps":
            out = got_v, got_m
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tsbs", "off_tile", "permuted", "gaps",
                                  "aligned_start", "one_series",
                                  "min_steps"])
def test_cuda_grid_scatter_routes_match_plain(cuda_device, case):
    rng = np.random.default_rng(len(case))
    c, spad, tpad, seq, steps = {
        # the hot tail's TSBS hour: 4,000 hosts x 360 steps after 24 h
        "tsbs": (10, 4096, 10240, np.arange(4000), 8640 + np.arange(360)),
        # S and k off the 32 x 32 tile, a start 8 past a tile edge
        "off_tile": (3, 256, 2048, np.arange(13, 213), 1000 + np.arange(45)),
        "permuted": (2, 512, 2048, rng.permutation(512)[:333],
                     77 + np.arange(70)),
        "gaps": (2, 128, 2048, np.arange(100),
                 np.cumsum(rng.integers(1, 5, 50))),
        "aligned_start": (1, 64, 128, np.arange(64), np.arange(128)),
        "one_series": (4, 64, 2048, [63], 2000 + np.arange(48)),
        "min_steps": (2, 64, 64, np.arange(0, 64, 3),
                      56 + np.arange(stk.STEPS_MIN)),
    }[case]
    values, valid = _grid(rng, c, spad, tpad)
    _both_routes(cuda_device, values, valid, seq, steps, seed=len(case))


@pytest.mark.cuda
def test_cuda_grid_scatter_steps_into_a_grown_time_axis(cuda_device):
    """An append past the padded time axis: _grow_time_axis doubles tpad
    on the card and the CPU alike, then the steps cross the old end."""
    rng = np.random.default_rng(9)
    c, spad, tpad = 3, 256, 2048
    values, valid = _grid(rng, c, spad, tpad)
    grown = pgrid._grow_time_axis(values, valid, tpad, tpad + 100, spad, c)
    assert grown[0].shape == (c, spad, 2 * tpad)
    _both_routes(cuda_device, *grown, np.arange(200), 2000 + np.arange(148),
                 seed=9)


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_scatter_part_picks_the_route(cuda_device, ragged):
    """_scatter_part (the hot tail's and the catch-up's scatter) takes
    grid_scatter_steps for whole steps and grid_scatter for a ragged last
    step, each equal to the plain version."""
    rng = np.random.default_rng(11)
    c, spad, tpad = 3, 128, 2048
    values, valid = _grid(rng, c, spad, tpad)
    tsid, tidx = _steps(rng.permutation(100), 300 + np.arange(40))
    if ragged:
        tsid, tidx = tsid[:-7], tidx[:-7]
    cols = [rng.normal(size=len(tsid)).astype(np.float32) for _ in range(c)]
    flags = rng.random(len(tsid)) < 0.9
    want_v, want_m = values.clone(), valid.clone()
    pgrid._scatter_part(want_v, want_m, tsid, tidx, cols, flags)
    got_v, got_m = values.to(cuda_device), valid.to(cuda_device)
    n0 = stk.grid_scatter_steps.launches, stk.grid_scatter.launches
    pgrid._scatter_part(got_v, got_m, tsid, tidx, cols, flags)
    torch.cuda.synchronize()
    assert (stk.grid_scatter_steps.launches - n0[0],
            stk.grid_scatter.launches - n0[1]) == ((0, 1) if ragged
                                                   else (1, 0))
    assert got_v.cpu().numpy().tobytes() == want_v.numpy().tobytes()
    assert torch.equal(got_m.cpu(), want_m)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["on", "off"])
def test_cuda_write_then_query_matches_cpu(cuda_device, tmp_path,
                                           monkeypatch, grid):
    """The same writes into a db on the card and one on the CPU: after each
    time-forward write the card's resident tables extend through the two
    kernels, and every answer equals the CPU's."""
    from greptimedb_tpu_torch.standalone import GreptimeDB

    monkeypatch.setenv("GREPTIME_GRID", grid)
    dbs = [GreptimeDB(str(tmp_path / "cuda"), device=cuda_device),
           GreptimeDB(str(tmp_path / "cpu"), device="cpu")]
    rng = np.random.default_rng(5)
    hosts = np.array([f"h{i}" for i in range(40)], dtype=object)
    q = ("SELECT host, count(*), sum(v), max(v) FROM m "
         "GROUP BY host ORDER BY host")
    try:
        for db in dbs:
            db.sql("CREATE TABLE m (host STRING, ts TIMESTAMP(3) TIME "
                   "INDEX, v DOUBLE, PRIMARY KEY (host))")
        m0, s0 = (stk.extend_merge.launches,
                  stk.grid_scatter_steps.launches + stk.grid_scatter.launches)
        for k in range(4):
            n_hosts = 30 if k == 0 else 40  # the second write adds series
            data = {"host": np.tile(hosts[:n_hosts], 100),
                    "ts": 1_000 * (k * 100 + np.repeat(np.arange(100),
                                                        n_hosts)),
                    "v": rng.normal(size=100 * n_hosts)}
            for db in dbs:
                db._region_of("m").write(data)
            got, want = (db.sql(q).rows for db in dbs)
            assert len(got) == len(want) == n_hosts
            for g, w in zip(got, want):
                assert g[:2] == w[:2]
                for a, b in zip(g[2:], w[2:]):
                    assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
        assert dbs[0].cache.extends == dbs[1].cache.extends == 3
        if grid == "on":
            # K24: each write is 100 whole steps, so grid_scatter_steps
            assert stk.grid_scatter_steps.launches + \
                stk.grid_scatter.launches - s0 == 3
        else:
            assert stk.extend_merge.launches - m0 == 3
    finally:
        for db in dbs:
            db.close()
