#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (greptimedb_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--hours 24]

Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi), whether pyarrow
   is present, and the build of the CUDA kernels from csrc/ (timed).
2. Kernels against their plain PyTorch versions, on the card, at the main
   path's shapes (TSBS double-groupby-all at scale 4000, 24 h @ 10 s):
   time (median of 20 CUDA-event-timed runs), the bound from the bytes
   moved, the plain version's time and one library call's time.
3. Main path: a port GreptimeDB ingests TSBS cpu data (scale 4000,
   10 DOUBLE metrics, random walk from seed 7, one region.write per hour
   plus a Parquet flush when pyarrow is present) and answers three SQL
   queries, each checked against a numpy computation on the generated
   arrays: (a) double-groupby-all over a 12 h aligned window, (b) the
   window shifted by 5 min with min/max, (c) (a) with a tag-only WHERE.
   The kernel launch counts are zeroed just before and read just after.
4. One JSON line with every kernel's numbers, then the last line
   {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when CUDA is absent, a kernel does
not build, launch or agree with its plain version, or a query is wrong.
"""

from __future__ import annotations

import argparse
import json
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
REL_TOL = 1e-5              # golden comparer: |a-b| <= 1e-5 * max(1, |b|)
SOURCE = "greptimedb_tpu_torch/csrc/grid_kernels.cu"
REPLACES = {
    "bucket_reduce": "greptimedb_tpu/query/physical.py:1129",
    "group_merge": "greptimedb_tpu/query/physical.py:1176",
}


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


def bound_ms(bytes_moved: int, flops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, exact: bool) -> float:
    """Largest |got - want|; raises if it breaks the stated tolerance
    (exact, or the golden comparer's relative bound)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    both_nan = torch.isnan(g) & torch.isnan(w)
    same_inf = torch.isinf(w) & (g == w)
    diff = torch.where(both_nan | same_inf, 0.0, (g - w).abs())
    diff = torch.nan_to_num(diff, nan=float("inf"))
    err = float(diff.max()) if diff.numel() else 0.0
    bad = diff > 0 if exact else diff > REL_TOL * torch.clamp(w.abs(), min=1.0)
    bad = bad & ~(both_nan | same_inf)
    if bool(bad.any()):
        raise AssertionError(f"mismatch: max |diff| {err}")
    return err


def device_busy(fn):
    """One warm run under torch.profiler: summed self device time of every
    device op, the run's wall time, and the three ops with the most device
    time.  A profiler that records no device time reports 0."""
    from torch.profiler import ProfilerActivity, profile

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
    top = [f"{k[:40]}={us / 1e3:.3f}ms" for us, k in rows[:3]]
    return sum(us for us, _k in rows) / 1e3, wall_ms, top


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(gk) -> tuple[str, bool]:
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
    t0 = time.perf_counter()
    gk.build(force=True)
    gk._load()
    log(f"build: nvcc {gk.SOURCE.name} -> {gk.LIBRARY.name} in "
        f"{time.perf_counter() - t0:.3f} s")
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
        for name, sql in queries.items():
            t0 = time.perf_counter()
            res = db.sql(sql)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            worst = check_rows(name, res.rows, *checks[name])
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
        db.close()
        return launches
    finally:
        shutil.rmtree(home, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hours", type=int, default=24,
                    help="hours of TSBS data to ingest (12 is the cut)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from greptimedb_tpu_torch.ops import grid_kernels as gk

    t_start = time.perf_counter()
    card, has_arrow = phase_device(gk)
    kernels = phase_kernels(gk, card)
    launches = phase_main_path(gk, args.hours, has_arrow, card)
    line = {"kernels": []}
    for name in ("bucket_reduce", "group_merge"):
        k = kernels[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCE,
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
