#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (greptimedb_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--hours 24] [--scrapes 40] [--seed 11]

Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi), whether pyarrow
   is present, and the build of the CUDA kernels from csrc/ (one nvcc per
   source, started together; timed).
2. The grid kernels against their plain PyTorch versions, on the card,
   at the SQL path's shapes (TSBS double-groupby-all at scale 4000, 24 h
   @ 10 s): time (median of 20 CUDA-event-timed runs), the bound from the
   bytes moved, the plain version's time and one library call's time.
3. SQL main path: a port GreptimeDB ingests TSBS cpu data (scale 4000,
   10 DOUBLE metrics, random walk from seed 7, one region.write per hour
   plus a Parquet flush when pyarrow is present) and answers three SQL
   queries, each checked against a numpy computation on the generated
   arrays: (a) double-groupby-all over a 12 h aligned window, (b) the
   window shifted by 5 min with min/max, (c) (a) with a tag-only WHERE.
   Its db stays open for phases 6 and 7, which run next.
4. PromQL main path: a port GreptimeDB ingests bench_promql.py's table
   (http_requests_total, 100,000 pods x 10 containers = 1 M series, one
   region.write per 15 s scrape; counters rise 100-200 per scrape, 1 % of
   (series, scrape) reset to a small value, 0.1 % of samples NaN; data
   from --seed) and answers sum by (pod) (rate(http_requests_total[5m]))
   as an instant query at the last scrape through PromEvaluator and as a
   20-step TQL EVAL range query through db.sql, both checked against a
   numpy float64 computation of the extrapolated rate.
   Before each main path the kernel launch counts are zeroed; they are
   read just after it.
5. The PromQL kernels against their plain versions, timed as in phase 2,
   on phase 4's resident table (41.9 M padded rows; 2^20 selected series,
   1 and 20 steps): its real shapes and data.
6. SQL row path, on phase 3's table before its db closes (run between
   phases 3 and 4): (d) query (a) with GREPTIME_GRID=off, once under
   GREPTIME_SORTED_SEGMENTS=auto (the sorted path, sorted_segment_reduce)
   and once under =off (the scatter path, segment_reduce's wide mode),
   each equal to (a)'s grid rows and to numpy; (e) TSBS lastpoint
   (last_value of the 10 metrics by hostname), exactly the last step's
   values; (f) TSBS high-cpu-all (SELECT * WHERE usage_user > 90 over the
   12 h window, through compact), its row count exact and its sum of
   usage_user within the golden bound; (g) a decile expression key
   (compact_groups: radix_argsort + rank_scatter) and
   count(DISTINCT hostname) WHERE usage_user > 99.  Per query: first and warm-median latency, the
   stage split and the profiler's device-busy share.  The row kernels'
   launch counts are zeroed before the queries and read after them.
7. The row-path kernels against their plain versions and one library
   call, timed as in phase 2, on phase 3's resident table with the ids,
   masks and keys the row path gives them; and min/max of signed f32 and
   f64 values with -0.0, +0.0 and +-inf entries through both reductions,
   exactly equal to their plain versions.
8. One JSON line with every kernel's numbers, then the last line
   {"ok": true, "device": {...}}.

Cuts, printed when taken: --hours 12 (SQL path), --scrapes 20 (PromQL).

Exits non-zero, printing no result, when CUDA is absent, a kernel does
not build, launch or agree with its plain version, or a query is wrong.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SCALE = 4000
STEP_S = 10
STEPS_PER_HOUR = 3600 // STEP_S
T0 = 1451606400000  # 2016-01-01, the TSBS epoch
METRICS = [
    "usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
    "usage_irq", "usage_softirq", "usage_steal", "usage_guest",
    "usage_guest_nice",
]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM data sheet, float32 outside tensor cores
F64_FLOPS = 34e12           # H100 SXM data sheet, float64 outside tensor cores
REL_TOL = 1e-5              # golden comparer: |a-b| <= 1e-5 * max(1, |b|)
SOURCES = {
    "bucket_reduce": "greptimedb_tpu_torch/csrc/grid_kernels.cu",
    "group_merge": "greptimedb_tpu_torch/csrc/grid_kernels.cu",
    "prefix_scan": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "sort_layout": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "counter_window": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "segment_reduce": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "sorted_segment_reduce": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "compact": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "rank_scatter": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "radix_argsort": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
}
REPLACES = {
    "bucket_reduce": "greptimedb_tpu/query/physical.py:1129",
    "group_merge": "greptimedb_tpu/query/physical.py:1176",
    "prefix_scan": "greptimedb_tpu/promql/engine.py:410",
    "sort_layout": "greptimedb_tpu/promql/engine.py:257",
    "counter_window": "greptimedb_tpu/promql/engine.py:383",
    "segment_reduce": "greptimedb_tpu/ops/segment.py:79",
    "sorted_segment_reduce": "greptimedb_tpu/ops/segment.py:272",
    "compact": "greptimedb_tpu/ops/masks.py:37",
    "rank_scatter": "greptimedb_tpu/ops/segment.py:368",
    "radix_argsort": "greptimedb_tpu/ops/segment.py:353",
}
PROM_T0 = 1700000000000   # bench_promql.py's epoch
SCRAPE_MS = 15_000
PODS, CONTAINERS = 100_000, 10
PROM_SERIES = PODS * CONTAINERS
RANGE_MS = 300_000
PROM_QUERY = "sum by (pod) (rate(http_requests_total[5m]))"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event-timed runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(bytes_moved: int, flops: int,
             rate: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, exact: bool,
            rel_tol: float = REL_TOL) -> float:
    """Largest |got - want|; raises if it breaks the stated tolerance
    (exact, or ``rel_tol * max(1, |want|)``, by default the golden
    comparer's relative bound)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    both_nan = torch.isnan(g) & torch.isnan(w)
    same_inf = torch.isinf(w) & (g == w)
    diff = torch.where(both_nan | same_inf, 0.0, (g - w).abs())
    diff = torch.nan_to_num(diff, nan=float("inf"))
    err = float(diff.max()) if diff.numel() else 0.0
    bad = diff > 0 if exact else diff > rel_tol * torch.clamp(w.abs(), min=1.0)
    bad = bad & ~(both_nan | same_inf)
    if bool(bad.any()):
        raise AssertionError(f"mismatch: max |diff| {err}")
    return err


def device_busy(fn, top_n: int = 3, sessions: int = 3):
    """Warm runs of ``fn``, each under its own torch.profiler session: the
    summed self device time of every device op, the run's wall time and
    the ``top_n`` ops with the most device time, from the session that
    recorded the most device time.  On the card, some sessions recorded
    none of the kernels the ctypes-bound csrc/ libraries launched while
    others did; a session can only miss records, never invent them, so
    the largest sum is the closest to the truth.  A profiler that records
    no device time reports 0."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                rows.append((us, e.key))
        rows.sort(reverse=True)
        busy = sum(us for us, _k in rows) / 1e3
        if best is None or busy > best[0]:
            top = [f"{k[:40]}={us / 1e3:.3f}ms" for us, k in rows[:top_n]]
            best = (busy, wall_ms, top)
    return best


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(gk, pk, sk) -> tuple[str, bool]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    try:
        import pyarrow
        has_arrow = True
        log(f"pyarrow: present ({pyarrow.__version__})")
    except ImportError:
        has_arrow = False
        log("pyarrow: absent — rows stay in the memtable (wal_enabled=False, "
            "flush_threshold_bytes=1<<40), no Parquet flush")
    from greptimedb_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    mods = (gk, pk, sk)
    cuda_build.build_many([(m.SOURCE, m.LIBRARY, m.NVCC_FLAGS)
                           for m in mods], force=True)
    for m in mods:
        m._load()
    log(f"build: nvcc " + ", ".join(f"{m.SOURCE.name} -> {m.LIBRARY.name}"
                                    for m in mods)
        + f" (in parallel) in {time.perf_counter() - t0:.3f} s")
    return card, has_arrow


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_kernels(gk, card: str) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    c, s, t, r = 10, 4096, 10240, 360
    nb = -(-t // r)
    values = torch.rand((c, s, t), generator=gen, device=dev) * 100
    valid = torch.rand((s, t), generator=gen, device=dev) > 0.02
    values *= valid  # invalid cells are zero-filled, as in the grid
    results = {}

    def report(name, variant, ms, plain, bound, by, lib, err):
        lib_s = "null" if lib is None else f"{lib:.4f}"
        log(f"kernel {name}[{variant}]: {ms:.4f} ms (plain {plain:.4f} ms, "
            f"library {lib_s} ms, bound {bound:.4f} ms by {by}), "
            f"max_abs_err {err:.3g} — {card}")

    # -- bucket_reduce: K1 partial sums over the whole grid (headline) --
    geo = dict(r=r, nb=nb, pad_l=0, pad_r=nb * r - t)
    got = gk.bucket_reduce(values, "sum", **geo)
    want = gk.bucket_reduce_plain(values, "sum", **geo)
    err = max_err(got, want, exact=False)
    ms = time_ms(lambda: gk.bucket_reduce(values, "sum", **geo))
    plain = time_ms(lambda: gk.bucket_reduce_plain(values, "sum", **geo))
    lengths = torch.full((c, s, nb), r, dtype=torch.int64, device=dev)
    lengths[..., -1] = t - (nb - 1) * r
    lib_out = torch.segment_reduce(values, "sum", lengths=lengths, axis=2,
                                   unsafe=True)
    max_err(lib_out, want, exact=False)
    lib = time_ms(lambda: torch.segment_reduce(
        values, "sum", lengths=lengths, axis=2, unsafe=True))
    bnd, by = bound_ms(nbytes(values, got), values.numel())
    report("bucket_reduce", "sum [10,4096,10240] r=360", ms, plain, bnd, by,
           lib, err)
    results["bucket_reduce"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                    bound_by=by, library_ms=lib,
                                    max_abs_err=err)

    # -- bucket_reduce: K1 validity counts (exact) --
    got = gk.bucket_reduce(valid, "sum", **geo)
    err_c = max_err(got, gk.bucket_reduce_plain(valid, "sum", **geo), True)
    ms = time_ms(lambda: gk.bucket_reduce(valid, "sum", **geo))
    plain = time_ms(lambda: gk.bucket_reduce_plain(valid, "sum", **geo))
    bnd, by = bound_ms(nbytes(valid, got), valid.numel())
    report("bucket_reduce", "count [4096,10240] r=360", ms, plain, bnd, by,
           None, err_c)

    # -- bucket_reduce: K3 unaligned window, masked sum / min / max --
    w_raw, s0, pad_l = 12 * r, 6 * r + 30, 330
    wgeo = dict(r=r, nb=13, s0=s0, w_raw=w_raw, pad_l=pad_l,
                pad_r=13 * r - pad_l - w_raw)
    nan_vals = values.clone()
    nan_vals[0, ::7, ::11] = float("nan")
    tmask = torch.ones(w_raw, dtype=torch.bool, device=dev)
    tmask[:5] = False
    v2 = valid.narrow(1, s0, w_raw) & tmask[None, :]
    for op in ("sum", "min", "max", "count"):
        kw = dict(mask=v2, mask_s0=0, skip_nan=True, **wgeo)
        got = gk.bucket_reduce(nan_vals, op, **kw)
        want = gk.bucket_reduce_plain(nan_vals, op, **kw)
        err_w = max_err(got, want, exact=op != "sum")
        ms = time_ms(lambda: gk.bucket_reduce(nan_vals, op, **kw))
        plain = time_ms(lambda: gk.bucket_reduce_plain(nan_vals, op, **kw))
        window = c * s * w_raw
        bnd, by = bound_ms(window * 4 + s * w_raw + nbytes(got), window)
        report("bucket_reduce", f"masked {op} window 12 h +5 min", ms, plain,
               bnd, by, None, err_w)
        results["bucket_reduce"]["max_abs_err"] = max(
            results["bucket_reduce"]["max_abs_err"], err_w)

    # -- group_merge: series → group merge [10, 4096, 24] into 4096 --
    ngt, nbm = 4096, 24
    x = torch.rand((c, s, nbm), generator=gen, device=dev) * 1000
    ids = torch.randint(0, ngt, (s,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.rand(s, generator=gen, device=dev) < 0.05] = ngt  # overflow
    lay = gk.group_layout(ids, ngt)
    factor = (torch.rand(s, generator=gen, device=dev) > 0.1).float()
    got = gk.group_merge(x, lay, "sum")
    want = gk.group_merge_plain(x, lay, "sum")
    err = max_err(got, want, exact=False)
    ms = time_ms(lambda: gk.group_merge(x, lay, "sum"))
    plain = time_ms(lambda: gk.group_merge_plain(x, lay, "sum"))
    lib_buf = torch.zeros((c, ngt + 1, nbm), device=dev)
    ids64 = ids.long()
    lib = time_ms(lambda: lib_buf.index_add_(1, ids64, x))
    bnd, by = bound_ms(nbytes(x, lay.ids, lay.order, lay.offsets, got),
                       x.numel())
    report("group_merge", "sum [10,4096,24] -> 4096", ms, plain, bnd, by,
           lib, err)
    results["group_merge"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=lib,
                                  max_abs_err=err)
    for op, fac in (("sum", factor), ("min", factor), ("max", None)):
        got = gk.group_merge(x, lay, op, factor=fac)
        err_g = max_err(got, gk.group_merge_plain(x, lay, op, factor=fac),
                        exact=op != "sum")
        ms = time_ms(lambda: gk.group_merge(x, lay, op, factor=fac))
        plain = time_ms(lambda: gk.group_merge_plain(x, lay, op, factor=fac))
        bnd, by = bound_ms(nbytes(x, lay.ids, lay.order, lay.offsets, fac,
                                  got), x.numel())
        report("group_merge", f"{op}{' factor' if fac is not None else ''}",
               ms, plain, bnd, by, None, err_g)
        results["group_merge"]["max_abs_err"] = max(
            results["group_merge"]["max_abs_err"], err_g)
    cnt = torch.randint(0, 361, (c, s, nbm), generator=gen, device=dev)
    err_i = max_err(gk.group_merge(cnt, lay, "sum"),
                    gk.group_merge_plain(cnt, lay, "sum"), exact=True)
    log(f"kernel group_merge[int64 counts]: exact (max_abs_err {err_i})")
    del values, valid, nan_vals, x
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def ingest(db, hours: int, has_arrow: bool):
    """bench.py's TSBS generator: per-host random walk clipped to
    [0, 100], written one hour per region.write (+ flush).  Returns numpy
    per-(hour, host, metric) statistics of the float32 values the grid
    stores: sums, and min/max over the first 30 steps and the rest."""
    from greptimedb_tpu_torch.datatypes.batch import DictColumn

    try:
        import pandas  # noqa: F401 — the region's object-column factorizer
        tags_as_objects = True
    except ImportError:
        tags_as_objects = False
    log(f"ingest: scale {SCALE}, {hours} h @ {STEP_S} s, hostname as "
        f"{'object array' if tags_as_objects else 'DictColumn (no pandas)'}"
        f", {'Parquet flush per hour' if has_arrow else 'memtable only'}")
    region = db._region_of("cpu")
    hostnames = np.array([f"host_{i}" for i in range(SCALE)], dtype=object)
    rng = np.random.default_rng(7)
    state = rng.uniform(0, 100, size=(SCALE, len(METRICS)))
    k = 30  # 5 min of 10 s steps
    stats = {n: np.zeros((hours, SCALE, len(METRICS)))
             for n in ("sum", "min_a", "min_b", "max_a", "max_b")}
    # what the row-path checks need (phase 6), from the f32 values stored
    stats["hot_count"] = np.zeros(hours, np.int64)   # usage_user > 90
    stats["hot_sum"] = np.zeros(hours)
    stats["decile"] = np.zeros((hours, 11), np.int64)
    stats["over99"] = np.zeros(SCALE, bool)
    t_write = 0.0
    for hour in range(hours):
        ts = T0 + (hour * STEPS_PER_HOUR + np.repeat(
            np.arange(STEPS_PER_HOUR), SCALE)) * STEP_S * 1000
        if tags_as_objects:
            hosts = np.tile(hostnames, STEPS_PER_HOUR)
        else:
            hosts = DictColumn(hostnames, np.tile(
                np.arange(SCALE, dtype=np.int32), STEPS_PER_HOUR))
        data = {"hostname": hosts, "ts": ts}
        walk = rng.normal(0, 1, size=(STEPS_PER_HOUR, SCALE, len(METRICS)))
        series = np.clip(state[None, :, :] + np.cumsum(walk, axis=0), 0, 100)
        state = series[-1]
        for j, m in enumerate(METRICS):
            data[m] = series[:, :, j].reshape(-1)
        v32 = series.astype(np.float32)
        stats["sum"][hour] = v32.astype(np.float64).sum(0)
        stats["min_a"][hour] = v32[:k].min(0)
        stats["min_b"][hour] = v32[k:].min(0)
        stats["max_a"][hour] = v32[:k].max(0)
        stats["max_b"][hour] = v32[k:].max(0)
        user = v32[:, :, 0]
        hot = user > 90.0
        stats["hot_count"][hour] = int(hot.sum())
        stats["hot_sum"][hour] = user[hot].astype(np.float64).sum()
        stats["decile"][hour] = np.bincount(
            np.floor(user / np.float32(10)).astype(np.int64).reshape(-1),
            minlength=11)[:11]
        stats["over99"] |= (user > 99.0).any(0)
        stats["last"] = v32[-1]
        t0 = time.perf_counter()
        region.write(data)
        if has_arrow:
            region.flush()
        t_write += time.perf_counter() - t0
    rows = hours * SCALE * STEPS_PER_HOUR
    log(f"ingest: {rows:,} rows in {t_write:.3f} s of write/flush "
        f"({rows / t_write:,.0f} rows/s)")
    return stats


def check_rows(name, rows, expected_n, want_fn):
    if len(rows) != expected_n:
        raise AssertionError(f"query {name}: {len(rows)} rows, expected "
                             f"{expected_n}")
    worst = 0.0
    for row in rows:
        host = int(row[0].split("_")[1])
        hour = (int(row[1]) - T0) // 3_600_000
        for j, (got, (want, exact)) in enumerate(
                zip(row[2:], want_fn(host, hour))):
            if got is None or not np.isfinite(got):
                raise AssertionError(f"query {name}: non-finite {row}")
            diff = abs(got - want)
            if (diff > 0) if exact else (diff > REL_TOL * max(1.0, abs(want))):
                raise AssertionError(
                    f"query {name}: host {host} hour {hour} col {j}: "
                    f"{got} vs {want}")
            worst = max(worst, diff)
    return worst


def phase_main_path(gk, hours: int, has_arrow: bool, card: str) -> dict:
    from greptimedb_tpu_torch.query.parser import parse_sql
    from greptimedb_tpu_torch.standalone import GreptimeDB
    from greptimedb_tpu_torch.storage.region import RegionOptions

    if hours < 24:
        log(f"cut: {hours} h of data instead of 24 h (time limit)")
    home = tempfile.mkdtemp(prefix="chip_smoke_")
    db = None
    try:
        db = GreptimeDB(
            home,
            region_options=RegionOptions(
                wal_enabled=False, flush_threshold_bytes=1 << 40,
                compaction_window_ms=3600 * 1000,
                compaction_trigger_files=8))
        cols = ", ".join(f"{m} DOUBLE" for m in METRICS)
        db.sql(f"CREATE TABLE cpu (hostname STRING, "
               f"ts TIMESTAMP(3) TIME INDEX, {cols}, PRIMARY KEY (hostname))")
        gk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        stats = ingest(db, hours, has_arrow)

        window_h = min(12, hours)
        h0 = (hours - window_h) // 2
        q_start = T0 + h0 * 3_600_000
        q_end = q_start + window_h * 3_600_000
        avgs = ", ".join(f"avg({m})" for m in METRICS)
        minmax = ", ".join(f"min({m}), max({m})" for m in METRICS)
        some_hosts = [f"host_{i}" for i in range(0, SCALE, 200)]
        host_list = ", ".join(f"'{h}'" for h in some_hosts)
        shift = 5 * 60 * 1000
        queries = {
            "a": (f"SELECT hostname, date_trunc('hour', ts) AS hour, {avgs} "
                  f"FROM cpu WHERE ts >= {q_start} AND ts < {q_end} "
                  f"GROUP BY hostname, hour"),
            "b": (f"SELECT hostname, date_trunc('hour', ts) AS hour, "
                  f"{minmax} FROM cpu WHERE ts >= {q_start + shift} "
                  f"AND ts < {q_end + shift} GROUP BY hostname, hour"),
            "c": (f"SELECT hostname, date_trunc('hour', ts) AS hour, {avgs} "
                  f"FROM cpu WHERE ts >= {q_start} AND ts < {q_end} "
                  f"AND hostname IN ({host_list}) GROUP BY hostname, hour"),
        }

        def want_avg(host, hour):
            return [(stats["sum"][hour, host, j] / STEPS_PER_HOUR, False)
                    for j in range(len(METRICS))]

        last = h0 + window_h  # the shifted window's 5-minute tail bucket

        def want_minmax(host, hour):
            out = []
            for j in range(len(METRICS)):
                if hour == h0:
                    lo, hi = (stats["min_b"][hour, host, j],
                              stats["max_b"][hour, host, j])
                elif hour == last:
                    lo, hi = (stats["min_a"][hour, host, j],
                              stats["max_a"][hour, host, j])
                else:
                    lo = min(stats["min_a"][hour, host, j],
                             stats["min_b"][hour, host, j])
                    hi = max(stats["max_a"][hour, host, j],
                             stats["max_b"][hour, host, j])
                out += [(float(lo), True), (float(hi), True)]
            return out

        n_b = SCALE * (window_h + (1 if last < hours else 0))
        checks = {
            "a": (SCALE * window_h, want_avg),
            "b": (n_b, want_minmax),
            "c": (len(some_hosts) * window_h, want_avg),
        }
        report = {}
        a_rows = None
        for name, sql in queries.items():
            t0 = time.perf_counter()
            res = db.sql(sql)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            worst = check_rows(name, res.rows, *checks[name])
            if name == "a":
                a_rows = res.rows
            warm = []
            for _ in range(10):
                t0 = time.perf_counter()
                db.sql(sql)
                torch.cuda.synchronize()
                warm.append((time.perf_counter() - t0) * 1e3)
            metrics: dict = {}
            db.engine.execute_select(parse_sql(sql)[0], metrics=metrics)
            report[name] = dict(rows=len(res.rows), first_ms=first_ms,
                                warm_median_ms=float(np.median(warm)),
                                layout=metrics.get("layout"),
                                layout_cache=metrics.get("layout_cache"),
                                grid=metrics.get("grid"), max_diff=worst)
            log(f"query {name}: {len(res.rows)} rows correct (max |diff| "
                f"{worst:.3g}); first {first_ms:.3f} ms, warm median "
                f"{report[name]['warm_median_ms']:.3f} ms (10 runs); route "
                f"layout={report[name]['layout']} "
                f"layout_cache={report[name]['layout_cache']} — {card}")
            stages = {k: metrics[k] for k in (
                "plan_ms", "scan_cache_ms", "device_exec_ms",
                "device_wait_ms", "shape_ms") if k in metrics}
            busy_ms, wall_ms, top = device_busy(lambda: db.sql(sql))
            log(f"query {name} where the time goes: stages {stages}; "
                f"profiler: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
                f"wall; top device ops {top} — {card}")
        launches = {"bucket_reduce": gk.bucket_reduce.launches,
                    "group_merge": gk.group_merge.launches}
        peak = torch.cuda.max_memory_allocated()
        log(f"main path: launches {launches}, max_memory_allocated "
            f"{peak} B")
        for kname, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{kname} never launched on the main "
                                     f"path")
        if report["a"]["layout"] != "bucket_major" or (
                report["b"]["layout"] != "dynamic_slice"):
            raise AssertionError(f"unexpected routes {report}")
        return launches, db, home, dict(
            stats=stats, q_start=q_start, q_end=q_end, h0=h0,
            window_h=window_h, a_sql=queries["a"], a_rows=a_rows,
            want_avg=want_avg)
    except BaseException:
        if db is not None:
            db.close()
        shutil.rmtree(home, ignore_errors=True)
        raise


# ---------------------------------------------------------------------------
# phase 6: the SQL row path on phase 3's table
# ---------------------------------------------------------------------------

def timed_query(db, sql: str, card: str, label: str, check) -> dict:
    """First run (checked), warm runs (10, or 3 when one run takes over
    2 s), the stage split of one more run and the profiler's device-busy
    share; prints one line and returns the numbers."""
    from greptimedb_tpu_torch.query.parser import parse_sql

    t0 = time.perf_counter()
    res = db.sql(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    detail = check(res)
    warm = []
    reps = 10
    while len(warm) < reps:
        t0 = time.perf_counter()
        db.sql(sql)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        if warm[0] > 2000:
            reps = 3
    if reps == 3:
        log(f"query {label}: one run takes over 2 s, so 3 warm runs")
    metrics: dict = {}
    db.engine.execute_select(parse_sql(sql)[0], metrics=metrics)
    stages = {k: metrics[k] for k in (
        "plan_ms", "scan_cache_ms", "device_exec_ms", "device_wait_ms",
        "shape_ms") if k in metrics}
    busy_ms, wall_ms, top = device_busy(lambda: db.sql(sql), sessions=2)
    out = dict(rows=len(res.rows), first_ms=first_ms,
               warm_median_ms=float(np.median(warm)), stages=stages,
               segments=metrics.get("segments"), busy_ms=busy_ms,
               wall_ms=wall_ms)
    log(f"query {label}: {len(res.rows):,} rows correct ({detail}); first "
        f"{first_ms:.3f} ms, warm median {out['warm_median_ms']:.3f} ms "
        f"({len(warm)} runs); segments={out['segments']}; stages {stages}; "
        f"profiler: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"({100 * busy_ms / max(wall_ms, 1e-9):.2f} %); top device ops {top}"
        f" — {card}")
    return out


def phase_row_path(sk, db, ctx: dict, card: str) -> dict:
    """(d) query (a) with GREPTIME_GRID=off under GREPTIME_SORTED_SEGMENTS
    auto (sorted, K5) and off (scatter, K4 wide); (e) TSBS lastpoint;
    (f) TSBS high-cpu-all over the 12 h window; (g) a decile expression
    key (compact_groups) and count(DISTINCT hostname).  Every result is
    checked against numpy on the generated data.  Returns the kernels'
    launch counts over these queries."""
    from greptimedb_tpu_torch.query import physical

    stats, q_start, q_end = ctx["stats"], ctx["q_start"], ctx["q_end"]
    h0, window_h = ctx["h0"], ctx["window_h"]
    sk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    report = {}

    def by_key(rows):
        return {(r[0], int(r[1])): r[2:] for r in rows}

    grid_a = by_key(ctx["a_rows"])

    def check_d(res):
        worst = check_rows("d", res.rows, SCALE * window_h, ctx["want_avg"])
        got = by_key(res.rows)
        if got.keys() != grid_a.keys():
            raise AssertionError("d: groups differ from the grid's")
        for key, vals in got.items():
            for g, w in zip(vals, grid_a[key]):
                if abs(g - w) > REL_TOL * max(1.0, abs(w)):
                    raise AssertionError(f"d: {key} {g} vs grid {w}")
        return f"max |diff| to numpy {worst:.3g}; equal to (a)'s grid rows"

    os.environ["GREPTIME_GRID"] = "off"
    try:
        for mode, want_route in (("auto", "sorted"), ("off", "scatter")):
            os.environ["GREPTIME_SORTED_SEGMENTS"] = mode
            before = dict(physical.DISPATCH_STATS)
            report[f"d_{mode}"] = timed_query(
                db, ctx["a_sql"], card,
                f"d (a) GREPTIME_GRID=off, GREPTIME_SORTED_SEGMENTS={mode}",
                check_d)
            moved = {k: physical.DISPATCH_STATS[k] - before[k]
                     for k in before}
            if report[f"d_{mode}"]["segments"] != want_route or (
                    moved[want_route] == 0 or sum(moved.values())
                    != moved[want_route]):
                raise AssertionError(f"d under {mode}: route {moved}")
    finally:
        os.environ.pop("GREPTIME_GRID", None)
        os.environ.pop("GREPTIME_SORTED_SEGMENTS", None)

    lasts = ", ".join(f"last_value({m})" for m in METRICS)
    lastpoint = f"SELECT hostname, {lasts} FROM cpu GROUP BY hostname"

    def check_e(res):
        if len(res.rows) != SCALE:
            raise AssertionError(f"e: {len(res.rows)} rows")
        for row in res.rows:
            host = int(row[0].split("_")[1])
            for j, v in enumerate(row[1:]):
                if v != float(stats["last"][host, j]):
                    raise AssertionError(f"e: host {host} col {j}: {v}")
        return "exactly the f32 values of the last step"

    report["e"] = timed_query(db, lastpoint, card, "e lastpoint", check_e)

    hot = (f"SELECT * FROM cpu WHERE usage_user > 90.0 AND ts >= {q_start} "
           f"AND ts < {q_end}")
    hours = slice(h0, h0 + window_h)
    want_n = int(stats["hot_count"][hours].sum())
    want_sum = float(stats["hot_sum"][hours].sum())

    def check_f(res):
        if len(res.rows) != want_n:
            raise AssertionError(f"f: {len(res.rows)} rows, want {want_n}")
        col = res.column_names.index("usage_user")
        got = float(sum(r[col] for r in res.rows))
        diff = abs(got - want_sum)
        if diff > REL_TOL * max(1.0, abs(want_sum)):
            raise AssertionError(f"f: sum {got} vs {want_sum}")
        return f"row count exact, sum(usage_user) |diff| {diff:.3g}"

    report["f"] = timed_query(db, hot, card, "f high-cpu-all", check_f)

    decile = (f"SELECT floor(usage_user / 10) AS decile, count(*) FROM cpu "
              f"WHERE ts >= {q_start} AND ts < {q_end} GROUP BY decile")
    want_dec = stats["decile"][hours].sum(0)

    def check_g1(res):
        got = {int(d): int(c) for d, c in res.rows}
        want = {d: int(c) for d, c in enumerate(want_dec) if c}
        if got != want:
            raise AssertionError(f"g decile: {got} vs {want}")
        return "counts exact"

    report["g_decile"] = timed_query(db, decile, card, "g decile key",
                                     check_g1)
    distinct = "SELECT count(DISTINCT hostname) FROM cpu WHERE usage_user > 99"

    def check_g2(res):
        want = int(stats["over99"].sum())
        if res.rows != [[want]]:
            raise AssertionError(f"g distinct: {res.rows} vs {want}")
        return f"{want} hosts, exact"

    report["g_distinct"] = timed_query(db, distinct, card,
                                       "g count(DISTINCT)", check_g2)
    launches = {"segment_reduce": sk.segment_reduce.launches,
                "sorted_segment_reduce": sk.sorted_segment_reduce.launches,
                "compact": sk.compact.launches,
                "rank_scatter": sk.rank_scatter.launches,
                "radix_argsort": sk.radix_argsort.launches}
    log(f"row path: launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} never launched on the row path")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the row-path kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_row_kernels(sk, db, ctx: dict, card: str) -> dict:
    """Each row-path kernel on phase 3's resident DeviceTable (its real
    shapes and data), with the ids, masks and keys the row path gives it,
    against its plain version and one library call."""
    from greptimedb_tpu_torch.ops.segment import combine_keys
    from greptimedb_tpu_torch.ops.time import bucket_index

    table = db.cache.get(db._region_of("cpu"))
    cols, row_mask = table.columns, table.row_mask
    n = row_mask.shape[0]
    ts = cols["ts"]
    window = row_mask & (ts >= ctx["q_start"]) & (ts < ctx["q_end"])
    results = {}

    def report(name, variant, ms, plain, bound, by, lib, err):
        lib_s = "null" if lib is None else f"{lib:.4f}"
        log(f"kernel {name}[{variant}]: {ms:.4f} ms (plain {plain:.4f} ms, "
            f"library {lib_s} ms, bound {bound:.4f} ms by {by}), "
            f"max_abs_err {err:.3g} — {card}")

    def keep(name, **kw):
        if name in results:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               kw["max_abs_err"])
        else:
            results[name] = kw

    # -- segment_reduce: the wide [N, 10] pass of (d) under off; the
    #    group grid is (hostname card) x (window buckets), both pow2 --
    hcard = 1 << (SCALE - 1).bit_length()
    nbw = 1 << (ctx["window_h"] - 1).bit_length()
    V = [cols[m] for m in METRICS]  # the wide pass reads them in place
    hosts = cols["hostname"]
    bucket = bucket_index(ts, 3_600_000, ctx["q_start"])
    ns = hcard * nbw
    gid, _tot = combine_keys([hosts, bucket], [hcard, nbw])
    gid = gid.to(torch.int32)
    got = sk.segment_reduce(V, gid, ns, "sum", window)
    want = sk.segment_reduce_plain(V, gid, ns, "sum", window)
    err = max(max_err(got[0], want[0], exact=False),
              max_err(got[1], want[1], exact=True))
    ms = time_ms(lambda: sk.segment_reduce(V, gid, ns, "sum", window))
    plain = time_ms(lambda: sk.segment_reduce_plain(V, gid, ns, "sum",
                                                    window), reps=5)
    live = window & (gid >= 0) & (gid < ns)
    stacked = torch.stack(V, dim=1)
    vz = torch.where(live[:, None] & ~torch.isnan(stacked), stacked, 0.0)
    idx = torch.where(live, gid.long(), ns)
    buf = torch.zeros((ns + 1, len(METRICS)), device=ts.device)
    lib = time_ms(lambda: buf.index_add_(0, idx, vz))
    # the result needs every mask byte, and the id and values of the live
    # rows only
    n_live = int(live.sum())
    bnd, by = bound_ms(nbytes(window, *got) + n_live * (
        gid.element_size() + sum(v.element_size() for v in V)),
        n_live * len(V))
    report("segment_reduce", f"wide sum [{n:,},10] -> {ns:,}", ms, plain,
           bnd, by, lib, err)
    keep("segment_reduce", ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
         library_ms=lib, max_abs_err=err)
    # lastpoint's first pass: int64 max of ts per host
    hid = hosts.to(torch.int32)
    got = sk.segment_reduce(ts, hid, hcard, "max", row_mask)
    want = sk.segment_reduce_plain(ts, hid, hcard, "max", row_mask)
    err = max(max_err(got[0], want[0], exact=True),
              max_err(got[1], want[1], exact=True))
    ms = time_ms(lambda: sk.segment_reduce(ts, hid, hcard, "max", row_mask))
    plain = time_ms(lambda: sk.segment_reduce_plain(ts, hid, hcard, "max",
                                                    row_mask), reps=5)
    n_live = int(row_mask.sum())
    bnd, by = bound_ms(nbytes(row_mask, *got) + n_live * (
        ts.element_size() + hid.element_size()), n_live)
    report("segment_reduce", f"int64 max of ts -> {hcard:,} (lastpoint "
           "pass 1)",
           ms, plain, bnd, by, None, err)
    keep("segment_reduce", max_abs_err=err)
    del vz, idx, buf

    # -- sorted_segment_reduce: the wide pass of (d) under auto --
    sb = torch.where(row_mask, torch.clamp(bucket, 0, nbw - 1), nbw)
    sid, _tot = combine_keys([hosts, sb], [hcard, nbw])
    sid = torch.where((sid < 0) | (sid >= ns), ns, sid).to(torch.int32)
    got = sk.sorted_segment_reduce(V, sid, ns, "sum", window)
    want = sk.sorted_segment_reduce_plain(V, sid, ns, "sum", window)
    err = max(max_err(got[0], want[0], exact=False),
              max_err(got[1], want[1], exact=True))
    ms = time_ms(lambda: sk.sorted_segment_reduce(V, sid, ns, "sum", window))
    plain = time_ms(lambda: sk.sorted_segment_reduce_plain(
        V, sid, ns, "sum", window), reps=5)
    starts, ends = sk.segment_bounds_plain(sid, ns)
    lengths = torch.cat([ends - starts, (n - ends[-1:])])
    vz = torch.where(window[:, None] & ~torch.isnan(stacked), stacked, 0.0)
    lib = time_ms(lambda: torch.segment_reduce(vz, "sum", lengths=lengths,
                                               axis=0, unsafe=True))
    # the mask, the live rows' values, the segment bounds and the outputs:
    # the ids are only binary-searched
    n_live = int(window.sum())
    bnd, by = bound_ms(nbytes(window, starts, ends, *got) + n_live * sum(
        v.element_size() for v in V), n_live * len(V))
    report("sorted_segment_reduce", f"wide sum [{n:,},10] -> {ns:,}", ms,
           plain, bnd, by, lib, err)
    keep("sorted_segment_reduce", ms=ms, plain_ms=plain, bound_ms=bnd,
         bound_by=by, library_ms=lib, max_abs_err=err)
    del V, vz, stacked

    # -- min and max of signed values with -0.0, +0.0 and +-inf, in f32 and
    #    f64, through both reductions (exact): the sign-flip branches of the
    #    order-preserving atomic keys --
    gen = torch.Generator(device=ts.device).manual_seed(5)
    special = torch.tensor([-0.0, 0.0, float("inf"), float("-inf")],
                           device=ts.device)
    pick = torch.rand(n, generator=gen, device=ts.device) < 0.01
    which = torch.randint(0, 4, (n,), generator=gen, device=ts.device)
    signed = torch.where(pick, special[which], cols["usage_user"] - 50.0)
    for vals in (signed, signed.double()):
        for name, fn, plain_fn, ids in (
                ("segment_reduce", sk.segment_reduce,
                 sk.segment_reduce_plain, gid),
                ("sorted_segment_reduce", sk.sorted_segment_reduce,
                 sk.sorted_segment_reduce_plain, sid)):
            for op in ("min", "max"):
                got = fn(vals, ids, ns, op, window)
                want = plain_fn(vals, ids, ns, op, window)
                err = max(max_err(got[0], want[0], exact=True),
                          max_err(got[1], want[1], exact=True))
                keep(name, max_abs_err=err)
    log(f"kernel segment_reduce, sorted_segment_reduce: min and max of "
        f"signed {{f32, f64}} values with {int(pick.sum()):,} -0.0/+0.0/"
        f"+-inf entries -> {ns:,} equal to their plain versions — {card}")
    del signed, got, want

    # -- compact: (f)'s 12 columns under its mask --
    hot = window & (cols["usage_user"] > 90.0)
    ccols = {k: cols[k] for k in ["hostname", "ts", *METRICS]}
    got, kept = sk.compact(ccols, hot)
    want, wkept = sk.compact_plain(ccols, hot)
    if kept != wkept:
        raise AssertionError(f"compact keeps {kept} rows, plain {wkept}")
    err = max(max_err(got[k], want[k], exact=True) for k in ccols)
    ms = time_ms(lambda: sk.compact(ccols, hot))
    plain = time_ms(lambda: sk.compact_plain(ccols, hot), reps=5)

    def lib_compact():
        rows = torch.nonzero(hot).squeeze(1)
        return [c.index_select(0, rows) for c in ccols.values()]

    lib = time_ms(lib_compact)
    # the mask, and the kept rows of each column read and written
    bnd, by = bound_ms(nbytes(hot) + 2 * kept * sum(
        c.element_size() for c in ccols.values()), 0)
    report("compact", f"12 columns N={n:,}, {kept:,} kept", ms,
           plain, bnd, by, lib, err)
    keep("compact", ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
         library_ms=lib, max_abs_err=err)
    del got, want

    # -- radix_argsort: (g)'s decile keys, and its distinct sweep --
    keys = torch.floor(cols["usage_user"] / 10).to(torch.int64)
    got = sk.radix_argsort(keys, window)
    want = sk.radix_argsort_plain(keys, window)
    err = max_err(got, want, exact=True)
    ms = time_ms(lambda: sk.radix_argsort(keys, window))
    plain = time_ms(lambda: sk.radix_argsort_plain(keys, window), reps=5)
    masked = torch.where(window, keys, sk.I64_MAX)
    lib = time_ms(lambda: torch.sort(masked, stable=True))
    bnd, by = bound_ms(nbytes(keys, window) + n * 4, 0)
    report("radix_argsort", f"decile keys N={n:,} (4 bits)", ms, plain, bnd,
           by, lib, err)
    keep("radix_argsort", ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
         library_ms=lib, max_abs_err=err)

    # -- rank_scatter: (g)'s decile ranks, as compact_groups gives them --
    order = got
    got = sk.rank_scatter(masked, order, window, n)
    want = sk.rank_scatter_plain(masked, order, window, n)
    err = max(max_err(g, w, exact=True) for g, w in zip(got, want))
    ms = time_ms(lambda: sk.rank_scatter(masked, order, window, n))
    plain = time_ms(lambda: sk.rank_scatter_plain(masked, order, window, n),
                    reps=5)
    bnd, by = bound_ms(nbytes(masked, order, window, *got), 0)
    report("rank_scatter", f"decile keys N={n:,} -> {n:,} groups", ms, plain,
           bnd, by, None, err)
    keep("rank_scatter", ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
         library_ms=None, max_abs_err=err)
    del got, want, order
    over = row_mask & (cols["usage_user"] > 99.0)
    got = sk.radix_argsort(hosts, over)
    err = max_err(got, sk.radix_argsort_plain(hosts.to(torch.int64), over),
                  exact=True)
    ms = time_ms(lambda: sk.radix_argsort(hosts, over))
    plain = time_ms(lambda: sk.radix_argsort_plain(hosts.to(torch.int64),
                                                   over), reps=5)
    bnd, by = bound_ms(nbytes(hosts, over) + n * 4, 0)
    report("radix_argsort", f"hostname codes N={n:,} (distinct value sweep)",
           ms, plain, bnd, by, None, err)
    keep("radix_argsort", max_abs_err=err)
    return results


# ---------------------------------------------------------------------------
# phase 4: PromQL main path
# ---------------------------------------------------------------------------

def prom_ingest(db, scrapes: int, seed: int, has_arrow: bool):
    """bench_promql.py's write path: one region.write per scrape over all
    series.  Returns the float32 values the device holds, [scrapes, S]
    (NaN = absent), in write-row order (row i = pod i // 10, container
    i % 10)."""
    from greptimedb_tpu_torch.datatypes.batch import DictColumn

    try:
        import pandas  # noqa: F401 — the region's object-column factorizer
        tags_as_objects = True
    except ImportError:
        tags_as_objects = False
    region = db._region_of("http_requests_total")
    pods = np.array([f"pod-{i}" for i in range(PODS)], dtype=object)
    conts = np.array([f"c{i}" for i in range(CONTAINERS)], dtype=object)
    pod_codes = (np.arange(PROM_SERIES) // CONTAINERS).astype(np.int32)
    cont_codes = (np.arange(PROM_SERIES) % CONTAINERS).astype(np.int32)
    if tags_as_objects:
        pod_col, cont_col = pods[pod_codes], conts[cont_codes]
    else:
        pod_col = DictColumn(pods, pod_codes)
        cont_col = DictColumn(conts, cont_codes)
    rng = np.random.default_rng(seed)
    counters = rng.uniform(0, 1000, PROM_SERIES)
    held = np.empty((scrapes, PROM_SERIES), dtype=np.float32)
    t_write = 0.0
    for k in range(scrapes):
        counters = counters + rng.uniform(100, 200, PROM_SERIES)
        reset = rng.random(PROM_SERIES) < 0.01
        counters[reset] = rng.uniform(0, 10, int(reset.sum()))
        v = counters.copy()
        v[rng.random(PROM_SERIES) < 0.001] = np.nan
        held[k] = v
        t0 = time.perf_counter()
        region.write({"pod": pod_col, "container": cont_col,
                      "ts": np.full(PROM_SERIES, PROM_T0 + k * SCRAPE_MS,
                                    dtype=np.int64),
                      "val": v})
        t_write += time.perf_counter() - t0
    t0 = time.perf_counter()
    if has_arrow:
        region.flush()
    t_flush = time.perf_counter() - t0
    rows = scrapes * PROM_SERIES
    log(f"promql ingest: {rows:,} rows ({PROM_SERIES:,} series x {scrapes} "
        f"scrapes @ 15 s, seed {seed}) in {t_write:.3f} s of write "
        f"({rows / t_write:,.0f} rows/s), flush {t_flush:.3f} s; tags as "
        f"{'object arrays' if tags_as_objects else 'DictColumn (no pandas)'}")
    return held


def np_series_rates(held: np.ndarray, t_end: int) -> np.ndarray:
    """numpy float64 reference: Prometheus' extrapolated rate over
    (t_end - 5m, t_end] of every series (counter resets add the value
    before the drop; NaN samples are absent).  Returns [PROM_SERIES] (NaN
    for a series with fewer than two samples in the window)."""
    ts_k = PROM_T0 + SCRAPE_MS * np.arange(held.shape[0], dtype=np.int64)
    ks = np.flatnonzero((ts_k > t_end - RANGE_MS) & (ts_k <= t_end))
    w = held[ks].astype(np.float64)
    valid = ~np.isnan(w)
    nk, cols = len(ks), np.arange(w.shape[1])
    cnt = valid.sum(0)
    first = np.argmax(valid, axis=0)
    last = nk - 1 - np.argmax(valid[::-1], axis=0)
    fv, lv = w[first, cols], w[last, cols]
    ft = ts_k[ks][first].astype(np.float64)
    lt = ts_k[ks][last].astype(np.float64)
    # previous valid sample of each sample, for the reset drops
    upto = np.maximum.accumulate(
        np.where(valid, np.arange(nk)[:, None], -1), axis=0)
    prev = np.vstack([np.full((1, w.shape[1]), -1), upto[:-1]])
    pv = w[np.maximum(prev, 0), cols]
    drops = np.where(valid & (prev >= 0) & (pv > w), pv, 0.0).sum(0)
    delta = lv - fv + drops
    sampled = (lt - ft) / 1000.0
    avg_dur = sampled / np.maximum(cnt - 1, 1)
    dts = (ft - (t_end - RANGE_MS)) / 1000.0
    dte = (t_end - lt) / 1000.0
    thr = avg_dur * 1.1
    dts = np.where(dts >= thr, avg_dur / 2, dts)
    dte = np.where(dte >= thr, avg_dur / 2, dte)
    with np.errstate(divide="ignore", invalid="ignore"):
        dtz = np.where(delta > 0, sampled * (fv / np.maximum(delta, 1e-30)),
                       np.inf)
        dts = np.minimum(dts, dtz)
        factor = (sampled + dts + dte) / np.maximum(sampled, 1e-30)
    return np.where(cnt >= 2, delta * factor / (RANGE_MS / 1000), np.nan)


def np_pod_rates(held: np.ndarray, t_end: int) -> np.ndarray:
    """``np_series_rates`` summed per pod over its containers, rate-less
    series skipped.  Returns [PODS] (NaN for a pod without any rate)."""
    per_pod = np_series_rates(held, t_end).reshape(PODS, CONTAINERS)
    some = ~np.isnan(per_pod).all(1)
    return np.where(some, np.nansum(per_pod, axis=1), np.nan)


def check_pod_values(name: str, got: np.ndarray, want: np.ndarray) -> float:
    """Golden bound on [PODS] (or [steps, PODS]) values; NaN must match."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
    if (np.isnan(got) != np.isnan(want)).any():
        raise AssertionError(f"{name}: absent groups differ")
    ok = ~np.isnan(want)
    diff = np.abs(got[ok] - want[ok])
    if (diff > REL_TOL * np.maximum(1.0, np.abs(want[ok]))).any():
        i = int(np.argmax(diff / np.maximum(1.0, np.abs(want[ok]))))
        raise AssertionError(f"{name}: {got[ok][i]} vs {want[ok][i]}")
    return float(diff.max()) if diff.size else 0.0


def phase_promql(gk, pk, scrapes: int, seed: int, has_arrow: bool,
                 card: str):
    """Returns (launches, db, home): the db stays open for phase 5, which
    holds the kernels against their plain versions on its resident
    table."""
    from greptimedb_tpu_torch.standalone import GreptimeDB
    from greptimedb_tpu_torch.storage.region import RegionOptions

    if scrapes < 40:
        log(f"cut: {scrapes} scrapes per series instead of 40 (time limit)")
    home = tempfile.mkdtemp(prefix="chip_smoke_promql_")
    db = GreptimeDB(home, region_options=RegionOptions(
        wal_enabled=False, flush_threshold_bytes=1 << 40))
    try:
        return _promql_path(gk, pk, db, scrapes, seed, has_arrow, card), \
            db, home
    except BaseException:
        db.close()
        shutil.rmtree(home, ignore_errors=True)
        raise


def _promql_path(gk, pk, db, scrapes, seed, has_arrow, card) -> dict:
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import parse_promql

    db.sql("CREATE TABLE http_requests_total (pod STRING, container STRING, "
           "ts TIMESTAMP(3) TIME INDEX, val DOUBLE, "
           "PRIMARY KEY (pod, container))")
    held = prom_ingest(db, scrapes, seed, has_arrow)
    gk.reset_launch_counts()
    pk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    expr = parse_promql(PROM_QUERY)
    t_end = PROM_T0 + (scrapes - 1) * SCRAPE_MS
    end_s = t_end / 1000.0
    in_range = int(min(scrapes, RANGE_MS // SCRAPE_MS))

    def instant():
        ev = PromEvaluator(db, end_s, end_s, 1.0)
        res = ev.eval(expr)
        vals = res.values.cpu().numpy()  # materialize, as bench_promql
        return ev, res, vals

    db.stage_sink = {}
    t0 = time.perf_counter()
    ev, res, vals = instant()
    first_ms = (time.perf_counter() - t0) * 1e3
    db.stage_sink = None
    log(f"promql instant, first run: {first_ms:.3f} ms; stage_ms "
        f"{ev.stage_ms}")
    pods = np.array([int(res.labels[g]["pod"][4:])
                     for g in range(res.num_series)])
    if res.num_series != PODS or len(set(pods.tolist())) != PODS:
        raise AssertionError(f"instant: {res.num_series} groups, expected "
                             f"{PODS}")
    want = np_pod_rates(held, t_end)
    got = np.full(PODS, np.nan)
    got[pods] = vals[:, 0]
    worst = check_pod_values("instant", got, want)
    warm = []
    for _ in range(10):
        t0 = time.perf_counter()
        instant()
        warm.append((time.perf_counter() - t0) * 1e3)
    warm_ms = float(np.median(warm))
    db.stage_sink = {}
    ev, _res, _vals = instant()
    db.stage_sink = None
    busy, wall, top = device_busy(instant, top_n=8)
    span = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    span[0].record()
    instant()
    span[1].record()
    span[1].synchronize()
    span_ms = span[0].elapsed_time(span[1])
    log(f"promql instant {PROM_QUERY} @ last scrape: {PODS:,} groups "
        f"correct (max |diff| {worst:.3g}); first {first_ms:.3f} ms, warm "
        f"median {warm_ms:.3f} ms (10 runs); "
        f"{PROM_SERIES * in_range / (warm_ms / 1e3):,.0f} samples/s "
        f"({PROM_SERIES:,} series x {in_range} samples in range); stage_ms "
        f"{ev.stage_ms}; cache events {dict(ev.cache_events)}; profiler: "
        f"device busy {busy:.3f} ms of {wall:.3f} ms wall; top device ops "
        f"{top}; CUDA-event span of one warm run {span_ms:.3f} ms — {card}")

    # the 20-step range query through SQL (TQL EVAL)
    start = PROM_T0 + RANGE_MS
    steps = (t_end - start) // SCRAPE_MS + 1
    sql = (f"TQL EVAL ({start / 1000}, {end_s}, 15) {PROM_QUERY}")
    t0 = time.perf_counter()
    out = db.sql(sql)
    tql_first_ms = (time.perf_counter() - t0) * 1e3
    if out.column_names != ["pod", "ts", "val"]:
        raise AssertionError(f"range: columns {out.column_names}")
    step_of = {start + j * SCRAPE_MS: j for j in range(steps)}
    grid = np.full((steps, PODS), np.nan)
    for pod, ts, v in out.rows:
        grid[step_of[ts], int(pod[4:])] = v
    want_grid = np.stack([np_pod_rates(held, start + j * SCRAPE_MS)
                          for j in range(steps)])
    if len(out.rows) != int((~np.isnan(want_grid)).sum()):
        raise AssertionError(f"range: {len(out.rows)} rows, expected "
                             f"{int((~np.isnan(want_grid)).sum())}")
    worst_r = check_pod_values("range", grid, want_grid)
    groups = len({r[0] for r in out.rows})
    if groups != PODS:
        raise AssertionError(f"range: {groups} groups, expected {PODS}")
    warm = []
    for _ in range(10):
        t0 = time.perf_counter()
        db.sql(sql)
        warm.append((time.perf_counter() - t0) * 1e3)
    tql_warm_ms = float(np.median(warm))
    db.stage_sink = {}
    db.sql(sql)
    stages = dict(db.stage_sink)
    db.stage_sink = None
    busy_r, wall_r, top_r = device_busy(lambda: db.sql(sql), top_n=6)
    # the unfused route (GREPTIME_PLAN_FUSION=off): the same query must give
    # the same rows, and a bare rate (always unfused) must match numpy
    bare_pod = 7
    bare = (f"TQL EVAL ({start / 1000}, {end_s}, 15) "
            f'rate(http_requests_total{{pod="pod-{bare_pod}"}}[5m])')
    os.environ["GREPTIME_PLAN_FUSION"] = "off"
    try:
        t0 = time.perf_counter()
        unfused = db.sql(sql)
        unfused_ms = (time.perf_counter() - t0) * 1e3
        bare_out = db.sql(bare)
    finally:
        os.environ.pop("GREPTIME_PLAN_FUSION", None)
    if unfused.rows != out.rows:
        raise AssertionError("range: unfused rows differ from fused rows")
    bare_grid = np.full((steps, CONTAINERS), np.nan)
    for r in bare_out.rows:
        lab = dict(zip(bare_out.column_names, r))
        if lab["pod"] != f"pod-{bare_pod}":
            raise AssertionError(f"bare rate: row of {lab['pod']}")
        bare_grid[step_of[lab["ts"]], int(lab["container"][1:])] = lab["val"]
    cols = slice(bare_pod * CONTAINERS, (bare_pod + 1) * CONTAINERS)
    bare_want = np.stack([np_series_rates(held, start + j * SCRAPE_MS)[cols]
                          for j in range(steps)])
    if len(bare_out.rows) != int((~np.isnan(bare_want)).sum()):
        raise AssertionError(f"bare rate: {len(bare_out.rows)} rows")
    worst_b = check_pod_values("bare rate", bare_grid, bare_want)
    log(f"promql unfused route: range query rows equal to the fused rows "
        f"({unfused_ms:.3f} ms, first unfused run); bare rate of pod-"
        f"{bare_pod} ({len(bare_out.rows)} rows) matches numpy (max |diff| "
        f"{worst_b:.3g})")
    range_samples = PROM_SERIES * int(
        min(scrapes, (t_end - (start - RANGE_MS)) // SCRAPE_MS))
    log(f"promql range TQL EVAL ({steps} steps): {len(out.rows):,} rows, "
        f"{groups:,} groups correct (max |diff| {worst_r:.3g}); first "
        f"{tql_first_ms:.3f} ms, warm median {tql_warm_ms:.3f} ms (10 runs);"
        f" {range_samples / (tql_warm_ms / 1e3):,.0f} samples/s "
        f"({range_samples:,} samples in range); stages {stages}; profiler: "
        f"device busy {busy_r:.3f} ms of {wall_r:.3f} ms wall; top device "
        f"ops {top_r} — {card}")
    launches = {"prefix_scan": pk.prefix_scan.launches,
                "sort_layout": pk.sort_layout.launches,
                "counter_window": pk.counter_window.launches,
                "group_merge": gk.group_merge.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"promql path: launches {launches}, max_memory_allocated {peak} B, "
        f"promql cache {db.promql_cache.stats()}")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} never launched on the PromQL path")
    return launches


# ---------------------------------------------------------------------------
# phase 5: PromQL kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_promql_kernels(gk, pk, db, card: str) -> dict:
    """Each PromQL kernel on the PromQL path's resident table (its real
    shapes and data) against its plain version, and group_merge at the
    path's shape (the K12 group sum)."""
    from greptimedb_tpu_torch.storage.memtable import TSID

    table = db.cache.get(db._region_of("http_requests_total"))
    cols = table.columns
    ts, val, tsid, mask = (cols["ts"], cols["val"], cols[TSID],
                           table.row_mask)
    n = ts.shape[0]
    results = {}

    def report(name, variant, ms, plain, bound, by, lib, err):
        lib_s = "null" if lib is None else f"{lib:.4f}"
        log(f"kernel {name}[{variant}]: {ms:.4f} ms (plain {plain:.4f} ms, "
            f"library {lib_s} ms, bound {bound:.4f} ms by {by}), "
            f"max_abs_err {err:.3g} — {card}")

    # -- sort_layout (K8) --
    got = pk.sort_layout(ts, val, tsid, mask)
    want = pk.sort_layout_plain(ts, val, tsid, mask)
    err = max(max_err(g, w, exact=True) for g, w in zip(got, want))
    ms = time_ms(lambda: pk.sort_layout(ts, val, tsid, mask))
    plain = time_ms(lambda: pk.sort_layout_plain(ts, val, tsid, mask))
    valid = mask & ~torch.isnan(val)
    key = torch.where(valid, tsid.long() * want[6] + (ts - want[5]),
                      pk.I64_MAX)

    def lib_sort():
        _k, order = torch.sort(key, stable=True)
        return [c.index_select(0, order) for c in (ts, val, tsid, valid)]

    lib = time_ms(lib_sort)
    bnd, by = bound_ms(nbytes(ts, val, tsid, mask, *got[:5]), 0)
    passes = int((got[3][got[4]].max().long() + 1) * got[6]).bit_length()
    report("sort_layout", f"N={n:,} rows, {passes} radix passes", ms, plain,
           bnd, by, lib, err)
    results["sort_layout"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=lib,
                                  max_abs_err=err)
    del key, valid

    # -- prefix_scan (K10's f64 cumsum, with the drop prologue) --
    key_s, ts_s, val_s, tsid_s, valid_s, ts_min, kp = got
    gd = pk.prefix_scan(val_s, tsid_s, valid_s)
    gd_want = pk.prefix_scan_plain(val_s, tsid_s, valid_s)
    # f64 sums in two tree orders differ by ~1e-16 relative; 1e-9 keeps a
    # margin and stays below any one drop (a counter value >= ~100) even
    # where the running sum is ~1e9, so a lost or repeated drop fails here
    err = max_err(gd, gd_want, exact=False, rel_tol=1e-9)
    ms = time_ms(lambda: pk.prefix_scan(val_s, tsid_s, valid_s))
    plain = time_ms(lambda: pk.prefix_scan_plain(val_s, tsid_s, valid_s))
    drops = torch.diff(gd_want, prepend=gd_want.new_zeros(1))
    lib = time_ms(lambda: torch.cumsum(drops, 0))
    bnd, by = bound_ms(nbytes(val_s, tsid_s, valid_s, gd), n, F64_FLOPS)
    report("prefix_scan", f"f64 counter drops N={n:,}", ms, plain, bnd, by,
           lib, err)
    results["prefix_scan"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=lib,
                                  max_abs_err=err)
    del drops

    # -- counter_window (K9 geometry + K10 + the K11 epilogue) --
    s_pad = 1 << (PROM_SERIES - 1).bit_length()
    sel = torch.full((s_pad,), -1, dtype=torch.int32, device=ts.device)
    sel[:PROM_SERIES] = torch.arange(PROM_SERIES, dtype=torch.int32,
                                     device=ts.device)
    t_end = int(ts_s[valid_s].max())
    start = t_end - 19 * SCRAPE_MS
    for variant, steps, kind, func in (("rate", 20, "rate", "rate"),
                                       ("counter stats", 20, "counter", None),
                                       ("instant", 1, "instant", None)):
        t0_ms = t_end if steps == 1 else start
        kw = dict(step_ms=SCRAPE_MS, num_steps=steps, range_ms=RANGE_MS,
                  kind=kind, func=func,
                  range_s=RANGE_MS / 1000 if func else None)
        g = gd if kind != "instant" else None
        out = pk.counter_window(got, g, sel, t0_ms, **kw)
        ref = pk.counter_window_plain(want, gd_want, sel, t0_ms, **kw)
        if kind == "rate":
            err = max_err(out, ref, exact=False)
        else:
            err = max(max_err(out[k], ref[k], exact=k != "delta_adj")
                      for k in pk.KIND_KEYS[kind])
        ms = time_ms(lambda: pk.counter_window(got, g, sel, t0_ms, **kw))
        plain = time_ms(lambda: pk.counter_window_plain(want, gd_want, sel,
                                                        t0_ms, **kw))
        steps_t = t0_ms + SCRAPE_MS * torch.arange(steps, device=ts.device)
        skey = sel.clamp(min=0).long()[:, None] * kp
        lo_keys = (skey + (steps_t - RANGE_MS + 1 - ts_min).clamp(
            min=0)).reshape(-1)
        hi_keys = (skey + (steps_t - ts_min)).reshape(-1)
        lib = time_ms(lambda: (torch.searchsorted(key_s, lo_keys),
                               torch.searchsorted(key_s, hi_keys,
                                                  right=True)))
        cells = s_pad * steps
        per_cell = {"rate": 8 * 2 + 4 * 2 + 8 * 2 + 4,
                    "counter": 8 * 2 + 4 * 2 + 8 * 2 + 4 * 5 + 8 * 2,
                    "instant": 8 + 4 + 4 + 4 + 8}[kind]
        # two binary searches of log2(n) int64 compares per cell, plus the
        # f64 epilogue (~30 operations) in rate mode
        ops = cells * (2 * n.bit_length() + (30 if kind == "rate" else 0))
        bnd, by = bound_ms(nbytes(sel) + cells * per_cell, ops, F64_FLOPS)
        report("counter_window", f"{variant} S={s_pad:,} T={steps} "
               f"(library: searchsorted geometry only)", ms, plain, bnd, by,
               lib, err)
        if kind == "rate":
            results["counter_window"] = dict(
                ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=err)
        else:
            results["counter_window"]["max_abs_err"] = max(
                results["counter_window"]["max_abs_err"], err)

    # -- group_merge at the PromQL shape: the 20-step rates of 2^20
    #    selected series (padding routed to the overflow id) into 100,000
    #    pod groups; tsids follow write order, so pod = tsid // 10 --
    v = pk.counter_window(got, gd, sel, start, step_ms=SCRAPE_MS,
                          num_steps=20, range_ms=RANGE_MS, kind="rate",
                          func="rate", range_s=RANGE_MS / 1000)
    x = torch.where(torch.isnan(v), 0.0, v)
    ids = torch.where(sel >= 0, sel // CONTAINERS, PODS)
    lay = gk.group_layout(ids, PODS)
    out = gk.group_merge(x, lay, "sum")
    err = max_err(out, gk.group_merge_plain(x, lay, "sum"), exact=False)
    ms = time_ms(lambda: gk.group_merge(x, lay, "sum"))
    plain = time_ms(lambda: gk.group_merge_plain(x, lay, "sum"))
    lib_buf = torch.zeros((PODS + 1, 20), device=x.device)
    ids64 = ids.long()
    lib = time_ms(lambda: lib_buf.index_add_(0, ids64, x))
    bnd, by = bound_ms(nbytes(x, lay.ids, lay.order, lay.offsets, out),
                       x.numel())
    report("group_merge", f"sum [{s_pad:,},20] -> {PODS:,} (PromQL path)",
           ms, plain, bnd, by, lib, err)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hours", type=int, default=24,
                    help="hours of TSBS data to ingest (12 is the cut)")
    ap.add_argument("--scrapes", type=int, default=40,
                    help="15 s scrapes per PromQL series (20 is the cut)")
    ap.add_argument("--seed", type=int, default=11,
                    help="seed of the PromQL data")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from greptimedb_tpu_torch.ops import grid_kernels as gk
    from greptimedb_tpu_torch.ops import promql_kernels as pk
    from greptimedb_tpu_torch.ops import segment_kernels as sk

    t_start = time.perf_counter()
    card, has_arrow = phase_device(gk, pk, sk)
    kernels = phase_kernels(gk, card)
    launches, db, home, ctx = phase_main_path(gk, args.hours, has_arrow,
                                              card)
    log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
    try:
        row_launches = phase_row_path(sk, db, ctx, card)
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
        kernels.update(phase_row_kernels(sk, db, ctx, card))
    finally:
        db.close()
        shutil.rmtree(home, ignore_errors=True)
    del ctx
    torch.cuda.empty_cache()
    log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
    prom_launches, db, home = phase_promql(gk, pk, args.scrapes, args.seed,
                                           has_arrow, card)
    try:
        kernels.update(phase_promql_kernels(gk, pk, db, card))
    finally:
        db.close()
        shutil.rmtree(home, ignore_errors=True)
    log(f"launches: SQL grid path {launches}, SQL row path {row_launches}, "
        f"PromQL path {prom_launches}")
    launches.update(row_launches)
    for name, n in prom_launches.items():
        launches[name] = launches.get(name, 0) + n
    line = {"kernels": []}
    for name in ("bucket_reduce", "group_merge", "prefix_scan",
                 "sort_layout", "counter_window", "segment_reduce",
                 "sorted_segment_reduce", "compact", "rank_scatter",
                 "radix_argsort"):
        k = kernels[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
