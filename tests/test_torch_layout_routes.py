"""The routes of K8's ``sort_layout`` and K12's ``segment_select``.

On the CPU (the plain versions):

- the precondition of ``sort_layout``'s presorted route: the port's
  resident ``DeviceTable`` of a PromQL table is in (tsid, ts) order with
  its pad rows last, so its valid keys are non-decreasing in row order
  and the stable sort is one stable partition.  Checked after one write
  and after writes whose scan takes ``storage/scan.py``'s ``merge_parts``
  ``concat``, ``merge`` and ``packed_sort`` paths;
- ``sort_layout_presorted_plain`` (the plain version of the route flag)
  on presorted tables, on one out-of-order pair across invalid rows and
  on tsids whose keys would not fit in int64;
- ``segment_select_plain`` at the route boundaries (group sizes 1, 2, 31,
  32, 33, 1,024 and 1,025, empty groups, all-NaN columns, +-0.0, +-inf,
  R = 32) against a numpy sort of each group.

On the card (``cuda``; the kernels have no CPU mode): both ``sort_layout``
routes against the plain version on presorted tables (interleaved NaN and
masked rows, no invalid row, every row invalid, duplicate (tsid, ts)
ties, N not a multiple of a segment, more segments than the scalar pass
has threads) with the route counters checked, and one out-of-order pair
at a segment, block and thread boundary, which must take the general
route; ``segment_select`` against its plain version at the route
boundaries.  Every comparison is exact (integer and gather work; the
value at a rank).
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.ops import promql_kernels as pk
from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.standalone import GreptimeDB
from greptimedb_tpu_torch.storage import scan as scanmod
from greptimedb_tpu_torch.storage.memtable import TSID

T0 = 1_700_000_000_000
SCRAPE = 15_000
DDL = ("CREATE TABLE m (pod STRING, container STRING, "
       "ts TIMESTAMP(3) TIME INDEX, val DOUBLE, PRIMARY KEY (pod, container))")
SEG = 1024  # rows a warp of sort_layout's passes walks (csrc kSegRows)


def _write(region, pods, scrapes, rng):
    """One region.write a scrape over ``pods`` x 2 containers, 10 % NaN."""
    n = 2 * len(pods)
    pod = np.array([f"pod-{p}" for p in pods for _ in range(2)], dtype=object)
    cont = np.array(["c0", "c1"] * len(pods), dtype=object)
    for k in scrapes:
        v = rng.uniform(0, 1000, n)
        v[rng.random(n) < 0.1] = np.nan
        region.write({"pod": pod, "container": cont,
                      "ts": np.full(n, T0 + k * SCRAPE, dtype=np.int64),
                      "val": v})


def _one_write(region, rng):
    """Every sample in a single region.write, rows in random order."""
    pods, scrapes = np.arange(6), np.arange(12)
    p, c, k = (a.reshape(-1) for a in np.meshgrid(pods, [0, 1], scrapes))
    perm = rng.permutation(p.size)
    v = rng.uniform(0, 1000, p.size)
    v[rng.random(p.size) < 0.1] = np.nan
    region.write({"pod": np.array([f"pod-{x}" for x in p[perm]], dtype=object),
                  "container": np.array([f"c{x}" for x in c[perm]],
                                        dtype=object),
                  "ts": (T0 + k[perm] * SCRAPE).astype(np.int64),
                  "val": v})


# (what the writes do, the merge path their scan takes)
WRITES = {
    "one_write": (lambda r, rng: _one_write(r, rng), None),
    # part 2 holds only new series (larger tsids): an ordered concat
    "concat": (lambda r, rng: (_write(r, range(6), range(10), rng), r.flush(),
                               _write(r, range(6, 12), range(10), rng),
                               r.flush()), "concat"),
    # every series in both parts, time ranges disjoint: the sorted-run merge
    "merge": (lambda r, rng: (_write(r, range(6), range(10), rng), r.flush(),
                              _write(r, range(6), range(10, 20), rng),
                              r.flush()), "merge"),
    # interleaved time ranges (even / odd scrapes) and a live memtable
    "packed_sort": (lambda r, rng: (_write(r, range(6), range(0, 20, 2), rng),
                                    r.flush(),
                                    _write(r, range(6), range(1, 20, 2), rng),
                                    r.flush(),
                                    _write(r, range(3), range(20, 22), rng)),
                    "packed_sort"),
}


def _resident(name, home):
    db = GreptimeDB(str(home), device="cpu")
    db.sql(DDL)
    region = db._region_of("m")
    write, path = WRITES[name]
    write(region, np.random.default_rng(len(name)))
    table = db.cache.get(region)
    return db, table, path


@pytest.mark.parametrize("name", sorted(WRITES))
def test_resident_table_is_presorted(name, tmp_path):
    """The presorted route's precondition on the port's resident tables."""
    db, table, path = _resident(name, tmp_path)
    try:
        if path is not None:
            assert scanmod.LAST_MERGE_PATH == path
        cols = table.columns
        ts, val, tsid, mask = (cols["ts"], cols["val"], cols[TSID],
                               table.row_mask)
        n = int(mask.sum())
        assert n > 0 and mask.shape[0] > n  # padded
        # pad rows last
        assert bool(mask[:n].all()) and not bool(mask[n:].any())
        # (tsid, ts) order over the live rows
        key = tsid[:n].to(torch.int64) * (1 << 42) + (ts[:n] - T0)
        assert bool((key[1:] >= key[:-1]).all())
        assert bool(torch.isnan(val[:n]).any())  # NaN rows interleave
        assert pk.sort_layout_presorted_plain(ts, val, tsid, mask)
        # the stable sort is then the stable partition
        key_s, ts_s, val_s, tsid_s, valid_s, _tmin, _kp = \
            pk.sort_layout_plain(ts, val, tsid, mask)
        valid = mask & ~torch.isnan(val)
        order = torch.cat([torch.nonzero(valid)[:, 0],
                           torch.nonzero(~valid)[:, 0]])
        assert torch.equal(ts_s, ts[order])
        assert torch.equal(tsid_s, tsid[order])
        assert torch.equal(valid_s, valid[order])
        assert torch.equal(val_s.nan_to_num(-1.0), val[order].nan_to_num(-1.0))
    finally:
        db.close()


def _presorted_table(rng, series=40, scrapes=30, pad=64, nan_frac=0.05,
                     masked_frac=0.05, dup=0):
    """Columns in (tsid, ts) order: NaN values and mask-False rows (with
    garbage tsid/ts) interleaved, ``dup`` (tsid, ts) rows repeated in
    place, ``pad`` pad rows last."""
    tsid = np.repeat(np.arange(series, dtype=np.int32), scrapes)
    ts = T0 + np.tile(np.arange(scrapes), series) * SCRAPE
    ts = ts + rng.integers(-500, 500, ts.size)
    if dup:
        rep = np.ones(ts.size, np.int64)
        rep[rng.choice(ts.size, dup, replace=False)] = 2
        tsid, ts = np.repeat(tsid, rep), np.repeat(ts, rep)
    n = ts.size
    val = rng.uniform(0, 1000, n).astype(np.float32)
    val[rng.random(n) < nan_frac] = np.nan
    mask = rng.random(n) >= masked_frac
    junk = ~mask
    tsid[junk] = rng.integers(0, series, junk.sum())
    ts[junk] = T0 + rng.integers(-10**6, 10**7, junk.sum())
    tsid = np.concatenate([tsid, np.zeros(pad, np.int32)])
    ts = np.concatenate([ts, np.zeros(pad, np.int64)]).astype(np.int64)
    val = np.concatenate([val, np.full(pad, np.nan, np.float32)])
    mask = np.concatenate([mask, np.zeros(pad, bool)])
    return dict(ts=ts, val=val, tsid=tsid, mask=mask)


def _args(t, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(t[k])).to(device)
            for k in ("ts", "val", "tsid", "mask")]


def test_presorted_flag_plain():
    """True on (tsid, ts)-ordered valid rows whatever the invalid rows
    hold; False on one descent across invalid rows, on a negative tsid
    and on keys past int64."""
    rng = np.random.default_rng(3)
    t = _presorted_table(rng, masked_frac=0.2, nan_frac=0.2)
    assert pk.sort_layout_presorted_plain(*_args(t))
    t["mask"][:] = False
    assert pk.sort_layout_presorted_plain(*_args(t))  # no valid row
    t = _presorted_table(rng, nan_frac=0.0, masked_frac=0.0, pad=0)
    # swap two valid rows with invalid rows between them
    t["mask"][101:104] = False
    t["ts"][100], t["ts"][104] = t["ts"][104], t["ts"][100]
    assert not pk.sort_layout_presorted_plain(*_args(t))
    t = _presorted_table(rng)
    t["tsid"][t["mask"]] -= 1  # tsid -1 on live rows
    assert not pk.sort_layout_presorted_plain(*_args(t))
    t = _presorted_table(rng, series=3, scrapes=4, pad=0, nan_frac=0.0,
                         masked_frac=0.0)
    t["ts"][-1] = np.int64(1) << 62  # kp ~ 2^62: (max tsid + 1) * kp > I64
    assert not pk.sort_layout_presorted_plain(*_args(t))


# group sizes at every route boundary: the thread (<= 32), the warp sort
# (33..1,024) and the radix select (> 1,024), with empty groups between
SIZES = [0, 1, 2, 31, 32, 0, 33, 1024, 1025, 3, 2100]


def _select_case(seed, sizes, T, R, all_nan_col=True):
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int64)
    S, ng = int(sizes.sum()), len(sizes)
    v = rng.normal(0, 100, (S, T)).astype(np.float32)
    v[rng.random((S, T)) < 0.1] = np.nan
    v[rng.random((S, T)) < 0.03] = np.inf
    v[rng.random((S, T)) < 0.03] = -np.inf
    v[rng.random((S, T)) < 0.03] = 0.0
    v[rng.random((S, T)) < 0.03] = -0.0
    v[rng.random((S, T)) < 0.05] = 7.0  # ties
    if all_nan_col:
        v[:, T - 1] = np.nan
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    order = rng.permutation(S).astype(np.int32)  # groups of shuffled rows
    ranks = np.stack([
        rng.integers(0, np.maximum(sizes, 1)[:, None], (ng, T))
        for _ in range(R)]).astype(np.int64)
    ranks[0] = 0
    if R > 1:
        ranks[1] = (sizes - 1)[:, None]
    if R > 2:
        ranks[2] = -3            # clamped to 0
        ranks[3] = sizes[:, None] + 5  # clamped to the last
    return v, order, offsets, ranks.astype(np.int32)


def _np_select(v, order, offsets, ranks):
    """Each group's column sorted ascending (NaN last), read at the
    clamped ranks; NaN for an empty group."""
    R, ng, T = ranks.shape
    out = np.full((R, ng, T), np.nan, np.float32)
    for g in range(ng):
        rows = order[offsets[g]:offsets[g + 1]]
        if rows.size == 0:
            continue
        srt = np.sort(v[rows], axis=0)  # NaN last
        r = np.clip(ranks[:, g, :], 0, rows.size - 1)
        out[:, g, :] = np.take_along_axis(srt, r, axis=0)
    return out


@pytest.mark.parametrize("R", [1, 2, 32])
def test_segment_select_plain_route_boundaries(R):
    sk.reset_launch_counts()
    v, order, offsets, ranks = _select_case(R, SIZES, 4, R)
    got = sk.segment_select(*(torch.from_numpy(a) for a in
                              (v, order, offsets, ranks))).numpy()
    np.testing.assert_array_equal(got, _np_select(v, order, offsets, ranks))
    assert sk.segment_select.launches == 0  # the plain version


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same_layout(got, want):
    for g, w in zip(got, want):
        g = g.cpu()
        if g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            assert torch.equal(g, w)


def _routes(t, cuda_device, want_route):
    """Both routes against the plain version; the automatic one must be
    ``want_route``."""
    args = _args(t)
    want = pk.sort_layout_plain(*args)
    dev = [a.to(cuda_device) for a in args]
    pk.reset_launch_counts()
    _same_layout(pk.sort_layout(*dev), want)
    assert getattr(pk.sort_layout, want_route) == 1
    assert pk.sort_layout.launches == 1
    _same_layout(pk.sort_layout_routed(*dev, allow_presorted=False), want)
    assert pk.sort_layout.general == (2 if want_route == "general" else 1)
    assert pk.prefix_scan.launches == 0
    torch.cuda.synchronize()


PRESORTED = {
    "nan_and_masked": dict(nan_frac=0.1, masked_frac=0.1),
    "no_invalid_row": dict(nan_frac=0.0, masked_frac=0.0, pad=0),
    "all_invalid": dict(nan_frac=1.0),
    "dup_ties": dict(dup=200),
    "ragged_n": dict(series=37, scrapes=29),            # 1,073 + 64 rows
    "many_segments": dict(series=1200, scrapes=1000),   # > 1,024 segments
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PRESORTED))
def test_cuda_sort_layout_presorted(cuda_device, name):
    t = _presorted_table(np.random.default_rng(7), **PRESORTED[name])
    _routes(t, cuda_device, "presorted")


@pytest.mark.cuda
@pytest.mark.parametrize("at", [SEG, 8 * SEG, 1000 * SEG])
def test_cuda_sort_layout_descent_takes_general(cuda_device, at):
    """One out-of-order valid pair straddling a segment / block / scalar
    thread boundary, invalid rows between them: the general route, exact."""
    t = _presorted_table(np.random.default_rng(at), series=1100,
                         scrapes=1000, nan_frac=0.0, masked_frac=0.0)
    t["mask"][at - 2:at + 3] = False
    i, j = at - 3, at + 3
    t["ts"][i], t["ts"][j] = t["ts"][j], t["ts"][i]
    t["tsid"][i], t["tsid"][j] = t["tsid"][j], t["tsid"][i]
    assert not pk.sort_layout_presorted_plain(*_args(t))
    _routes(t, cuda_device, "general")


SELECT_CASES = {
    "boundaries_r32": (SIZES, 5, 32),
    "boundaries_r2": (SIZES, 40, 2),   # two step slices in the radix passes
    "one_large": ([70_000], 3, 1),      # ng = 1 across 69 chunks
    "two_large_in_a_chunk": ([700, 1025, 1, 2047, 10, 1500], 6, 2),
    # R = 32: 2 steps a slice, 20 slices of the radix passes; groups of
    # ~100 chunks each elect their picking block per slice and pass
    "many_slices": ([100_000, 5, 80_000, 1025, 40, 118_930], 40, 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_cuda_segment_select_routes(cuda_device, name):
    sizes, T, R = SELECT_CASES[name]
    v, order, offsets, ranks = _select_case(len(name), sizes, T, R)
    args = [torch.from_numpy(a) for a in (v, order, offsets, ranks)]
    want = sk.segment_select_plain(*args)
    np.testing.assert_array_equal(want.numpy(),
                                  _np_select(v, order, offsets, ranks))
    sk.reset_launch_counts()
    for _ in range(2):  # scratch reused from the allocator
        got = sk.segment_select(*(a.to(cuda_device) for a in args))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    torch.cuda.synchronize()
    assert sk.segment_select.launches == 2
