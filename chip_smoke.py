#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (greptimedb_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--hours 24] [--scrapes 40] [--seed 11]
                          [--flow-series 1048576] [--log-lines 1000000]
                          [--vectors 131072]

Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi), whether pyarrow
   is present, and the build of the CUDA kernels from csrc/ (one nvcc per
   source, started together; timed).
2. The grid kernels against their plain PyTorch versions, on the card,
   at the SQL path's shapes (TSBS double-groupby-all at scale 4000, 24 h
   @ 10 s): time (median of 20 CUDA-event-timed runs), device time alone
   (graph_ms: 20 calls in one CUDA graph), the bound from the bytes
   moved, the plain version's time and one library call's time, each
   also as device time; bucket_reduce on the f32 partials, the u8 valid
   plane and the masked 12 h + 5 min window, two calls equal bit for bit;
   group_merge, and group_merge_pair against the two group_merge
   launches and elementwise kernels it replaces (bit for bit); the host
   path of a ctypes-bound kernel call beside index_add_'s.
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
   numpy float64 computation of the extrapolated rate.  Then K9's count
   geometry route by route: the instant query with
   GREPTIME_PLAN_FUSION=off (S*T*L = 2^26; equal to the fused rows and
   numpy) at the default 1 GiB PromQL budget, where the 512 MiB state
   does not fit beside the sort layout and is rejected (the range
   geometry), then at 4 GiB (the count geometry), then at 1 GiB again,
   each warm-timed with the cache's events and stats printed; max by
   (pod) (max_over_time) unfused at 20 steps (S*T*L over 2^27: refused
   before any build) and the one-pod changes / irate / deriv TQL queries
   (the count geometry, equal to GREPTIME_PROMQL_CACHE=off's rows).
   quantile_over_time(0.9, m[5m]) over every series (cold once, warm 5
   times) is checked on 4,096 seeded series against numpy; every
   window_matrix / window_matrix_dense launch of the path must take the
   register route (every window holds at most 32 keys); every launch of
   the five window kernels the range geometry (the sort layout's series
   offset table) or the count geometry, none the whole-layout search, and
   no query may launch prefix_scan; the warm instant query must take its
   selection, sort layout and group layout from the PromQL cache.
   Before each main path the kernel launch counts are zeroed; they are
   read just after it.
5. The PromQL kernels against their plain versions, timed as in phase 2,
   on phase 4's resident table (41.9 M padded rows; 2^20 selected series,
   1 and 20 steps) and on the engine's [S, T, K] subquery matrices of
   that table: their real shapes and data; series_offsets against
   torch.searchsorted (exact); counter_window, window_stats,
   minmax_window, window_count_max and window_matrix quantile in the range
   geometry, each timed by events and (but window_count_max) as
   CUDA-graph device time (the forced whole-layout search is timed beside
   them by time_scans.py windows);
   series_ranges and gather_ts_mat at S = 2^20 against torch.searchsorted
   of the same bounds, and counter_window at T = 1 in the range, count
   and search geometries.  sort_layout's general route prints its 8-bit
   digit passes and the device time a pass (torch.profiler); prefix_scan
   (off the query path) must repeat bit for bit over two calls.
   window_matrix (quantile, mad) and window_matrix_dense are timed on
   their register route and on the forced warp route (CUDA events and
   CUDA-graph device time), the two equal bit for bit.
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
   masks and keys the row path gives them (radix_argsort with its 8-bit
   digit passes and the device time a pass, by torch.profiler); and
   min/max of signed f32 and f64 values with -0.0, +0.0 and +-inf entries
   through both reductions, exactly equal to their plain versions.
   Then the sketch aggregates on the same table, while its db is open:
   hll(usage_user) and uddsketch_state(128, 0.01, usage_user) by hostname
   over all rows (registers and bucket counts exact against a numpy
   replica of the f32 values the device holds; hll_count within 3 x 1.6 %
   of the exact distinct count, uddsketch_calc within the sketch's
   relative error of the exact order statistic); the 4,000 states stored
   in a table and merged with hll_merge / uddsketch_merge by a tag,
   checked against numpy merges.  hll_fold (fold and merge modes) and
   udd_fold are then timed against their plain versions and one library
   call, as in phase 2, at those shapes.
8. Flows: a fresh db, src (h STRING, ts, v DOUBLE, k BIGINT) and
   the full-surface flow of tests/test_flow_device.py (date_bin 1 minute,
   sum, count(*), count(v), avg, min, max, first_value, last_value,
   sum(k): 12 state matrices), 2^20 series (--flow-series) reporting
   every 10 s, v integer-valued in 1..99 with NaN on every 1,000th row, k
   in 0..999, written as 6 time-forward batches of 30 s (3 rows a series)
   through region.write + flow_engine.on_write + run_all.  The flow must
   stay streaming(device) with no fallback and one reseed (the first
   batch); every sink row is checked exactly against numpy through a host
   scan of the sink region, and the device sink equals the host engine's
   (GREPTIME_FLOW_DEVICE=off) at bench_flow.py's parity size.  Prints the
   warm fold rows/s (median warm batch), the seed batch's time, the
   device-busy share of one warm fold and peak device memory; then times
   flow_merge on the fold's own inputs against its plain version.
9. Logs: a fresh db; bench_logs.py's corpus (1,000,000 mostly-
   unique lines over one hour, 16 apps x 4 levels = 64 streams, seed 12;
   --log-lines) pushed through servers.ingest.loki_push in JSON batches
   of 20,000 into loki_logs (push rate printed); then bench_logs.py's
   four LogQL queries (two |= line filters, one |~ alternation, sum by
   (app) (count_over_time(...[2m]))), a bytes_over_time by app, a rate
   with a != filter, and two SQL count(*) queries (matches_term, LIKE),
   each run cold once and warm five times (first and warm-median latency,
   the logql_window stage, the profiler's device-busy share).  Every
   answer equals a Python/numpy computation over the generated lines
   exactly and the GREPTIME_FULLTEXT=off host twin's answer; the
   fulltext counters, peak device memory and the launches are printed
   (fp_candidates, logs_layout, line_vals, row_match and window_stats
   must all have launched, and the prefilter must have run); then the
   four log kernels are timed on the phase's own resident state.
10. Concurrent serving, on phase 3's table while its db is open (run
   after phase 7's sketches): 16 client threads submit through
   db.scheduler, closed loop, (h) double-groupby-all over a 12 h aligned
   window starting at hour i % 12 and (i) the same with
   hostname = 'host_<k>', k varying per client and round.  Every answer
   equals its query's solo db.sql rows (==), and every solo answer equals
   phase 3's numpy sums; the launch counts are zeroed before the run and
   read after it: group_merge_stacked and series_mask must both have
   launched and at least one batch must have stacked.  Then queries/s and
   p50/p99 latency with batching on and off (GREPTIME_SCHEDULER_BATCH, a
   second scheduler with batching=False; runs on, off, off, on), the
   largest batch, the device-busy share of one batched run under
   torch.profiler beside the two kernels' own CUDA-event times x their
   launches, and the two kernels timed on the largest batches' captured
   arguments: group_merge_stacked at B = 16 against 16 solo
   group_merge_pair launches (each member equal to its pair, and to the
   two group_merge launches the pair replaced, bit for bit), its plain
   version
   and index_add_ over the stacked windows; series_mask against its plain
   version; each with its byte bound.
11. Top-k, on phase 3's table while its db is open (after phase 10):
   (j) SELECT * ... WHERE usage_user > 90 ORDER BY ts DESC LIMIT 10, (k)
   ORDER BY usage_user DESC, ts LIMIT 100 (over the walk's ties at
   100.0) and (l) ORDER BY usage_system, ts LIMIT 1000 OFFSET 64536 (k =
   65,536, the eligibility edge), each cold once and warm five times,
   equal row for row to a numpy stable lexsort of the f32 values the
   device holds, with topk_select launched and only k rows to the host;
   then topk_select timed at the three shapes against its plain version
   and torch.sort(stable=True) + index_select of one packed int64 key.
12. Vector search (last): a fresh db, items (cat, ts, id, emb
   VECTOR(128)), 64 categories, --vectors (131,072) distinct integer-
   valued vectors (SIFT's shape, components 0..127, from --seed), one
   row each; k-NN LIMIT 10 by vec_l2sq_distance, vec_cos_distance and
   vec_dot_product DESC, and a range count(*) WHERE vec_l2sq_distance <
   r (about 1 % of rows), each cold once (the first also warm once: every
   run re-parses the vectors' text on the host): L2^2 and dot
   distances and the count exact against numpy, cosine within 1e-6 with
   the same ids where the 10th and 11th differ by more; vec_distance
   must have launched; then it is timed on the table's own [D, 128]
   matrix against its plain version and torch.mv, beside the host parse
   time every query pays.
13. The mesh row path, on phase 3's table while its db is open (after
   phase 11): a mesh of 4 shards on the one card (db.mesh, which a db
   never forms by itself) with
   GREPTIME_GRID=off, so the engine's route order sends the aggregates to
   the mesh: (m) 12 h double-groupby-all (10 x avg by hostname and hour),
   (n) last_value / first_value / max / count(*) by hostname, (o) hll +
   uddsketch_state(128, 0.01) by hostname, (p) a global count / min / max
   WHERE usage_user > 90, each cold once and warm 5 times and checked:
   sums and means within the golden bound of the row path's
   (GREPTIME_MESH=off), counts and min/max equal to it, first/last equal
   to numpy over the f64 host values, the sketch states equal to the
   plain route on a CPU copy of one hour's shards and their estimates
   within 2 % of the row path's.  Prints the shard build's time and
   bytes, the collectives span, device busy, the row path's times on the
   same queries, and mesh_merge timed at (m)'s partials; the sharded
   table is dropped at the end, and phase 3's db closes after it.
14. Write then query, on the dbs that hold the data, once their other
   phases are done (K23 extend_merge, K24 grid_scatter_steps and
   grid_scatter).  (i) Phase 3's
   db, after phase 13: hour 24 of the walk (1.44 M rows) through
   servers.ingest.ingest_columns, whose hot tail extends the resident
   grid; query (a)'s shape over the last 12 h on the grid and with
   GREPTIME_GRID=off over the DeviceTable (which extends, keeping its
   sorted_tags), both against numpy; hour 25 likewise with the extend
   thresholds at 0 and the grid entry evicted (both rebuild), the
   first-query times printed side by side, with the hot tail's span
   split (grid_extend.* and grid_scatter.* spans); a flush, after which
   get_grid must catch up and keep the resident table; 30 more steps
   written and flushed with no hot tail, which get_grid must catch up
   from the new file through grid_scatter, equal to the written values;
   the hot tail's scatter must be grid_scatter_steps; then the kernels
   on the extend's own inputs against their plain versions (bit for
   bit), K23 beside the whole-table route (radix_argsort of the padded
   key + a gather) and torch.sort, grid_scatter_steps and grid_scatter on
   the same cells, grid_scatter on the catch-up shape ((tsid, ts)
   order), index_put_ and the hot tail's grid copy.  (ii) Phase 4's db, after phase 5: one more
   scrape; the instant query at the new end against numpy; the
   DeviceTable must extend, every sort_layout launch stay presorted, the
   old version's sort layout leave the PromQL cache under the default
   budget and the new one be admitted, the warm query take its entries
   from the cache.  (iii) Phase 9's db, after its kernel timings: one
   more push of 20,000 lines; a LogQL filter and the SQL matches_term
   count against numpy and GREPTIME_FULLTEXT=off; the DeviceTable must
   extend within its fingerprint lineage and the fingerprints grow by the
   vocabulary tail only.
15. One JSON line with every kernel's numbers, then the last line
   {"ok": true, "device": {...}}.

Each phase from 2 on starts by dropping what earlier phases left
(gc.collect, torch.cuda.empty_cache) and printing the device memory
still allocated.

Cuts, printed when taken: --hours 12 (SQL path), --scrapes 20 (PromQL),
--flow-series below 2^20 (flows), --log-lines below 1,000,000 (logs);
always: 3 warm runs of phase 4's TQL range query instead of 10, and
131,072 vectors instead of SIFT1M's 1,000,000 with one warm run of the
first vector query only (phase 12).

Exits non-zero, printing no result, when CUDA is absent, a kernel does
not build, launch or agree with its plain version, or a query is wrong.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
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
    "group_merge_pair": "greptimedb_tpu_torch/csrc/grid_kernels.cu",
    "prefix_scan": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "sort_layout": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "counter_window": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "segment_reduce": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "sorted_segment_reduce": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "compact": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "rank_scatter": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "radix_argsort": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "window_stats": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "minmax_window": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "window_count_max": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "window_matrix": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "window_matrix_dense": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "subquery_counter": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "segment_select": "greptimedb_tpu_torch/csrc/segment_kernels.cu",
    "flow_merge": "greptimedb_tpu_torch/csrc/flow_kernels.cu",
    "hll_fold": "greptimedb_tpu_torch/csrc/sketch_kernels.cu",
    "udd_fold": "greptimedb_tpu_torch/csrc/sketch_kernels.cu",
    "fp_candidates": "greptimedb_tpu_torch/csrc/fulltext_kernels.cu",
    "logs_layout": "greptimedb_tpu_torch/csrc/fulltext_kernels.cu",
    "line_vals": "greptimedb_tpu_torch/csrc/fulltext_kernels.cu",
    "row_match": "greptimedb_tpu_torch/csrc/fulltext_kernels.cu",
    "group_merge_stacked": "greptimedb_tpu_torch/csrc/grid_kernels.cu",
    "series_mask": "greptimedb_tpu_torch/csrc/grid_kernels.cu",
    "topk_select": "greptimedb_tpu_torch/csrc/topk_kernels.cu",
    "vec_distance": "greptimedb_tpu_torch/csrc/vector_kernels.cu",
    "series_ranges": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "gather_ts_mat": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "mesh_merge": "greptimedb_tpu_torch/csrc/mesh_kernels.cu",
    "series_offsets": "greptimedb_tpu_torch/csrc/promql_kernels.cu",
    "extend_merge": "greptimedb_tpu_torch/csrc/storage_kernels.cu",
    "grid_scatter": "greptimedb_tpu_torch/csrc/storage_kernels.cu",
    "grid_scatter_steps": "greptimedb_tpu_torch/csrc/storage_kernels.cu",
}
REPLACES = {
    "bucket_reduce": "greptimedb_tpu/query/physical.py:1129",
    "group_merge": "greptimedb_tpu/query/physical.py:1176",
    "group_merge_pair": "greptimedb_tpu/query/physical.py:1176",
    "prefix_scan": "greptimedb_tpu/promql/engine.py:410",
    "sort_layout": "greptimedb_tpu/promql/engine.py:257",
    "counter_window": "greptimedb_tpu/promql/engine.py:383",
    "segment_reduce": "greptimedb_tpu/ops/segment.py:79",
    "sorted_segment_reduce": "greptimedb_tpu/ops/segment.py:272",
    "compact": "greptimedb_tpu/ops/masks.py:37",
    "rank_scatter": "greptimedb_tpu/ops/segment.py:368",
    "radix_argsort": "greptimedb_tpu/ops/segment.py:353",
    "window_stats": "greptimedb_tpu/promql/engine.py:455",
    "minmax_window": "greptimedb_tpu/promql/engine.py:500",
    "window_count_max": "greptimedb_tpu/promql/engine.py:541",
    "window_matrix": "greptimedb_tpu/promql/engine.py:555",
    "window_matrix_dense": "greptimedb_tpu/promql/engine.py:1416",
    "subquery_counter": "greptimedb_tpu/promql/engine.py:1342",
    "segment_select": "greptimedb_tpu/promql/engine.py:1610",
    "flow_merge": "greptimedb_tpu/flow/device.py:452",
    "hll_fold": "greptimedb_tpu/ops/sketch.py:49",
    "udd_fold": "greptimedb_tpu/ops/sketch.py:136",
    "fp_candidates": "greptimedb_tpu/fulltext/resident.py:75",
    "logs_layout": "greptimedb_tpu/fulltext/loki.py:101",
    "line_vals": "greptimedb_tpu/fulltext/loki.py:115",
    "row_match": "greptimedb_tpu/fulltext/loki.py:131",
    "group_merge_stacked": "greptimedb_tpu/query/physical.py:979",
    "series_mask": "greptimedb_tpu/query/physical.py:1023",
    "topk_select": "greptimedb_tpu/query/physical.py:1961",
    "vec_distance": "greptimedb_tpu/query/exprs.py:853",
    "series_ranges": "greptimedb_tpu/promql/engine.py:348",
    "gather_ts_mat": "greptimedb_tpu/promql/engine.py:360",
    "mesh_merge": "greptimedb_tpu/parallel/dist.py:297",
    "series_offsets": "greptimedb_tpu/promql/engine.py:288",
    "extend_merge": "greptimedb_tpu/storage/cache.py:349",
    "grid_scatter": "greptimedb_tpu/storage/grid.py:612",
    "grid_scatter_steps": "greptimedb_tpu/storage/grid.py:491",
}
PROM_T0 = 1700000000000   # bench_promql.py's epoch
SCRAPE_MS = 15_000
PODS, CONTAINERS = 100_000, 10
PROM_SERIES = PODS * CONTAINERS
RANGE_MS = 300_000
PROM_QUERY = "sum by (pod) (rate(http_requests_total[5m]))"
TQL_WARM = 3  # warm runs of the 20-step TQL range query (a cut from 10)
CATCH_UP_STEPS = 30  # steps of step 14 (i)'s flushed catch-up (5 minutes)


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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed under CUDA events (median of 10 replays) and
    divided by ``reps``.  Unlike ``time_ms`` it leaves out the host's
    launch cost, which fills the event window of a launch that runs in
    tens of microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations and library handles outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


# launches by shape over every main path, for the kernels that count them
SHAPES: dict = {}
# launches by route over the PromQL main path (window_matrix and
# window_matrix_dense: register / warp)
ROUTES: dict = {}
# launches by window geometry over the PromQL main path (the five window
# kernels: range / search / count)
GEOMETRIES: dict = {}


def take_shapes(name: str, wrapper) -> None:
    """Adds ``wrapper.shapes`` (launches by shape since the last reset) to
    ``SHAPES[name]``; called where a path's launch counts are read."""
    into = SHAPES.setdefault(name, {})
    for label, n in wrapper.shapes.items():
        into[label] = into.get(label, 0) + n


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(bytes_moved: int, flops: int,
             rate: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, exact: bool,
            rel_tol: float = REL_TOL, abs_tol=0.0) -> float:
    """Largest |got - want|; raises if it breaks the stated tolerance
    (exact, or ``rel_tol * max(1, |want|) + abs_tol``, by default the
    golden comparer's relative bound)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    both_nan = torch.isnan(g) & torch.isnan(w)
    same_inf = torch.isinf(w) & (g == w)
    diff = torch.where(both_nan | same_inf, 0.0, (g - w).abs())
    diff = torch.nan_to_num(diff, nan=float("inf"))
    err = float(diff.max()) if diff.numel() else 0.0
    bad = diff > 0 if exact else diff > (
        rel_tol * torch.clamp(w.abs(), min=1.0) + abs_tol)
    bad = bad & ~(both_nan | same_inf)
    if bool(bad.any()):
        raise AssertionError(f"mismatch: max |diff| {err}")
    return err


def profile_ops(fn, sessions: int = 3) -> tuple[dict, float]:
    """Runs ``fn`` once under each of ``sessions`` torch.profiler sessions
    and returns, from the session that recorded the most device time,
    every device op's (self device ms, launches) by name and that run's
    wall time (ms).  On the card, some sessions recorded none of the
    kernels the ctypes-bound csrc/ libraries launched while others did; a
    session can only miss records, never invent them, so the largest sum
    is the closest to the truth.  A profiler that records no device time
    gives no ops."""
    from torch.profiler import ProfilerActivity, profile

    def busy(ops):
        return sum(ms for ms, _n in ops.values())

    best = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ops = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                ops[e.key] = (us / 1e3, e.count)
        if best is None or busy(ops) > busy(best[0]):
            best = (ops, wall_ms)
    return best


def device_busy(fn, top_n: int = 3, sessions: int = 3):
    """(summed self device ms of every device op, the run's wall ms, the
    ``top_n`` ops with the most device time) of warm runs of ``fn``, from
    ``profile_ops``; 0 device ms when the profiler records none."""
    ops, wall_ms = profile_ops(fn, sessions)
    rows = sorted(ops.items(), key=lambda kv: -kv[1][0])
    top = [f"{k[:40]}={ms:.3f}ms" for k, (ms, _n) in rows[:top_n]]
    return sum(ms for ms, _n in ops.values()), wall_ms, top


def pass_split(fn, kernel: str) -> tuple[int | None, float | None, str]:
    """(launches of ``kernel`` in one warm call of ``fn``, its device ms a
    launch, a printable split of the call by kernel), all read from one
    ``profile_ops`` session; the first two are None when the profiler
    recorded none of ``kernel``'s launches."""
    fn()
    torch.cuda.synchronize()
    ops, _wall = profile_ops(fn)
    hits = [v for k, v in ops.items() if kernel in k]
    launches = sum(n for _ms, n in hits) or None
    per = sum(ms for ms, _n in hits) / launches if launches else None

    def short(k):
        k = k.replace("void ", "").replace("(anonymous namespace)::", "")
        return k.split("<")[0].split("(")[0].strip()[:32]

    parts = sorted(ops.items(), key=lambda kv: -kv[1][0])
    text = ", ".join(f"{short(k)} {ms:.4f}"
                     for k, (ms, _n) in parts[:6]) or "not measured"
    return launches, per, text


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(*mods) -> tuple[str, bool]:
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

def host_us(fn, n: int = 1000) -> float:
    """Host microseconds a call of ``fn`` on inputs so small that the card
    keeps up: a wrapper's own cost (checks, allocation, the launch call)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def host_path(gk, card: str) -> dict:
    """The host path of the ctypes-bound grid kernels beside one PyTorch
    op's (``index_add_``), and the profiler's CPU split of 200 calls of
    ``group_merge``: what remains of a µs-scale kernel's event time."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x = torch.ones((1, 2, 4), device=dev)
    lay = gk.group_layout(torch.zeros(2, dtype=torch.int32, device=dev), 1)
    buf = torch.zeros((1, 2, 4), device=dev)
    ids = lay.ids.long()
    out = {
        "group_merge": host_us(lambda: gk.group_merge(x, lay, "sum")),
        "group_merge_pair": host_us(
            lambda: gk.group_merge_pair(x[0], x, lay)),
        "bucket_reduce": host_us(
            lambda: gk.bucket_reduce(x[0], "sum", r=2, nb=2)),
        "index_add_": host_us(lambda: buf.index_add_(1, ids, x)),
        "torch.empty": host_us(lambda: torch.empty((1, 1, 4), device=dev)),
    }
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(200):
            gk.group_merge(x, lay, "sum")
        torch.cuda.synchronize()
    rows = sorted(((e.self_cpu_time_total / 200, e.key)
                   for e in prof.key_averages()), reverse=True)[:4]
    split = ", ".join(f"{k} {us:.2f} us" for us, k in rows)
    log(f"host path, us a call: {json.dumps(out)}; profiler CPU split of "
        f"group_merge (self time a call): {split or 'not measured'} — "
        f"{card}")
    return out


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

    def report(name, variant, ms, plain, bound, by, lib, err, gms=None,
               lib_gms=None):
        lib_s = "null" if lib is None else f"{lib:.4f}"
        dev_s = "" if gms is None else f", device time {gms:.4f} ms"
        lib_d = "" if lib_gms is None else f" (device {lib_gms:.4f} ms)"
        log(f"kernel {name}[{variant}]: {ms:.4f} ms{dev_s} (plain "
            f"{plain:.4f} ms, library {lib_s} ms{lib_d}, bound {bound:.4f} "
            f"ms by {by}), max_abs_err {err:.3g} — {card}")

    # -- bucket_reduce: K1 partial sums over the whole grid (headline) --
    geo = dict(r=r, nb=nb, pad_l=0, pad_r=nb * r - t)
    got = gk.bucket_reduce(values, "sum", **geo)
    want = gk.bucket_reduce_plain(values, "sum", **geo)
    err = max_err(got, want, exact=False)
    again = gk.bucket_reduce(values, "sum", **geo)
    if not torch.equal(again, got):
        raise AssertionError("bucket_reduce: two calls differ")
    ms = time_ms(lambda: gk.bucket_reduce(values, "sum", **geo))
    gms = graph_ms(lambda: gk.bucket_reduce(values, "sum", **geo))
    plain = time_ms(lambda: gk.bucket_reduce_plain(values, "sum", **geo))
    lengths = torch.full((c, s, nb), r, dtype=torch.int64, device=dev)
    lengths[..., -1] = t - (nb - 1) * r
    lib_out = torch.segment_reduce(values, "sum", lengths=lengths, axis=2,
                                   unsafe=True)
    max_err(lib_out, want, exact=False)
    lib = time_ms(lambda: torch.segment_reduce(
        values, "sum", lengths=lengths, axis=2, unsafe=True))
    lib_g = graph_ms(lambda: torch.segment_reduce(
        values, "sum", lengths=lengths, axis=2, unsafe=True))
    bnd, by = bound_ms(nbytes(values, got), values.numel())
    report("bucket_reduce", "sum [10,4096,10240] r=360", ms, plain, bnd, by,
           lib, err, gms, lib_g)
    results["bucket_reduce"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                    bound_by=by, library_ms=lib,
                                    max_abs_err=err, graph_ms=gms,
                                    library_graph_ms=lib_g)
    del again, lib_out

    # -- bucket_reduce: K1 validity counts, the u8 plane (exact) --
    got = gk.bucket_reduce(valid, "sum", **geo)
    err_c = max_err(got, gk.bucket_reduce_plain(valid, "sum", **geo), True)
    ms = time_ms(lambda: gk.bucket_reduce(valid, "sum", **geo))
    gms = graph_ms(lambda: gk.bucket_reduce(valid, "sum", **geo))
    plain = time_ms(lambda: gk.bucket_reduce_plain(valid, "sum", **geo))
    bnd, by = bound_ms(nbytes(valid, got), valid.numel())
    report("bucket_reduce", "u8 counts [4096,10240] r=360", ms, plain, bnd,
           by, None, err_c, gms)
    results["bucket_reduce"].update(u8_ms=ms, u8_graph_ms=gms,
                                    u8_bound_ms=bnd, u8_plain_ms=plain)

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
        if not torch.equal(gk.bucket_reduce(nan_vals, op, **kw), got):
            raise AssertionError(f"bucket_reduce {op}: two calls differ")
        ms = time_ms(lambda: gk.bucket_reduce(nan_vals, op, **kw))
        gms = graph_ms(lambda: gk.bucket_reduce(nan_vals, op, **kw))
        plain = time_ms(lambda: gk.bucket_reduce_plain(nan_vals, op, **kw))
        window = c * s * w_raw
        bnd, by = bound_ms(window * 4 + s * w_raw + nbytes(got), window)
        lib = lib_g = None
        if op == "sum":
            # one matmul of the masked window (zeros where masked or NaN,
            # made beforehand) by the 0/1 bucket matrix: the reference's
            # bdot as one library call — not the same function, the
            # masking is left out of its time
            win = nan_vals.narrow(2, s0, w_raw)
            vz = torch.where(v2[None] & ~torch.isnan(win), win, 0.0).reshape(
                c * s, w_raw).contiguous()
            pos = torch.arange(w_raw, device=dev) + pad_l
            onehot = (pos[:, None] // r == torch.arange(
                13, device=dev)[None, :]).float()
            torch.backends.cuda.matmul.allow_tf32 = False  # full f32
            max_err(torch.matmul(vz, onehot).reshape(c, s, 13), want,
                    exact=False)
            lib = time_ms(lambda: torch.matmul(vz, onehot))
            lib_g = graph_ms(lambda: torch.matmul(vz, onehot))
            del win, vz
        report("bucket_reduce", f"masked {op} window 12 h +5 min", ms, plain,
               bnd, by, lib, err_w, gms, lib_g)
        results["bucket_reduce"].update({
            f"masked_{op}_ms": ms, f"masked_{op}_graph_ms": gms})
        results["bucket_reduce"]["max_abs_err"] = max(
            results["bucket_reduce"]["max_abs_err"], err_w)
    results["bucket_reduce"]["masked_bound_ms"] = bnd
    del values, valid, nan_vals, v2
    torch.cuda.empty_cache()

    # -- group_merge: series → group merge [10, 4096, 24] into 4096 --
    ngt, nbm = 4096, 24
    x = torch.rand((c, s, nbm), generator=gen, device=dev) * 1000
    ids = torch.randint(0, ngt, (s,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.rand(s, generator=gen, device=dev) < 0.05] = ngt  # overflow
    lay = gk.group_layout(ids, ngt)
    factor = (torch.rand(s, generator=gen, device=dev) > 0.1).float()
    got = gk.group_merge(x, lay, "sum")
    want = gk.group_merge_plain(x.cpu(), gk.group_layout(ids.cpu(), ngt),
                                "sum")
    # exact: the kernel and the CPU's index_add_ both add a group's series
    # in ascending order
    err = max_err(got.cpu(), want, exact=True)
    ms = time_ms(lambda: gk.group_merge(x, lay, "sum"))
    gms = graph_ms(lambda: gk.group_merge(x, lay, "sum"))
    plain = time_ms(lambda: gk.group_merge_plain(x, lay, "sum"))
    lib_buf = torch.zeros((c, ngt + 1, nbm), device=dev)
    ids64 = ids.long()
    lib = time_ms(lambda: lib_buf.index_add_(1, ids64, x))
    lib_g = graph_ms(lambda: lib_buf.index_add_(1, ids64, x))
    bnd, by = bound_ms(nbytes(x, lay.ids, lay.order, lay.offsets, got),
                       x.numel())
    report("group_merge", "sum [10,4096,24] -> 4096", ms, plain, bnd, by,
           lib, err, gms, lib_g)
    results["group_merge"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=lib,
                                  max_abs_err=err, graph_ms=gms,
                                  library_graph_ms=lib_g)
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

    # -- group_merge_pair: the grid path's count plane and 10 sum planes
    #    over one layout, windows of the resident partials, with a WHERE
    #    factor, against the two group_merge launches and the two
    #    elementwise kernels it replaces --
    full = 2 * nbm
    cfull = torch.randint(0, 361, (s, full), generator=gen,
                          device=dev).float()
    sfull = torch.rand((c, s, full), generator=gen, device=dev) * 1000
    cw, sw = cfull.narrow(1, 6, nbm), sfull.narrow(2, 6, nbm)

    def two_merges():
        return (gk.group_merge((cw * factor[:, None]).to(torch.int64), lay,
                               "sum"),
                gk.group_merge(sw, lay, "sum", factor=factor))

    pc, ps = gk.group_merge_pair(cw, sw, lay, factor=factor)
    tc, ts = two_merges()
    err_p = max(max_err(pc, tc, exact=True), max_err(ps, ts, exact=True))
    wc, ws = gk.group_merge_pair_plain(cw, sw, lay, factor=factor)
    err_p = max(err_p, max_err(pc, wc, exact=True),
                max_err(ps, ws, exact=False))
    ms = time_ms(lambda: gk.group_merge_pair(cw, sw, lay, factor=factor))
    gms = graph_ms(lambda: gk.group_merge_pair(cw, sw, lay, factor=factor))
    two_ms = time_ms(two_merges)
    two_g = graph_ms(two_merges)
    plain = time_ms(lambda: gk.group_merge_pair_plain(cw, sw, lay,
                                                      factor=factor))
    bnd, by = bound_ms(nbm * s * (c + 1) * 4 + nbytes(
        lay.ids, lay.order, lay.offsets, factor, pc, ps), (c + 1) * s * nbm)
    log(f"kernel group_merge_pair[counts + sum [10,4096,24] windows -> 4096, "
        f"factor]: {ms:.4f} ms, device time {gms:.4f} ms (the two "
        f"group_merge launches and two elementwise kernels it replaces: "
        f"{two_ms:.4f} ms, device {two_g:.4f} ms, equal bit for bit; plain "
        f"{plain:.4f} ms, library null — no one call, bound {bnd:.4f} ms by "
        f"{by}), max_abs_err {err_p:.3g} — {card}")
    results["group_merge_pair"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
        max_abs_err=err_p, graph_ms=gms, two_merges_ms=two_ms,
        two_merges_graph_ms=two_g)
    results["group_merge"]["host_us"] = host_path(gk, card)
    del x, cnt, cfull, sfull
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
    user_steps = []  # usage_user as stored (f32), for the sketch checks
    system_steps = []  # usage_system as stored, for the top-k checks
    t_write = 0.0

    def next_hour(hour):
        """One hour of the walk: (columns, the f64 values [steps, hosts,
        metrics]); the walk's state moves on."""
        nonlocal state
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
        return data, series

    for hour in range(hours):
        data, series = next_hour(hour)
        v32 = series.astype(np.float32)
        stats["sum"][hour] = v32.astype(np.float64).sum(0)
        stats["min_a"][hour] = v32[:k].min(0)
        stats["min_b"][hour] = v32[k:].min(0)
        stats["max_a"][hour] = v32[:k].max(0)
        stats["max_b"][hour] = v32[k:].max(0)
        user = v32[:, :, 0]
        system_steps.append(v32[:, :, 1].copy())
        hot = user > 90.0
        stats["hot_count"][hour] = int(hot.sum())
        stats["hot_sum"][hour] = user[hot].astype(np.float64).sum()
        stats["decile"][hour] = np.bincount(
            np.floor(user / np.float32(10)).astype(np.int64).reshape(-1),
            minlength=11)[:11]
        stats["over99"] |= (user > 99.0).any(0)
        stats["last"] = v32[-1]
        # the f64 host values of the first and last steps and of usage_user
        # over 90 (phase 13's first_value / last_value and its global
        # aggregate: the mesh keeps DOUBLE fields in f64)
        if hour == 0:
            stats["first64"] = series[0].copy()
            stats["hot64"] = [0, np.inf, -np.inf, 0]
        stats["last64"] = series[-1].copy()
        u64 = series[:, :, 0]
        over = u64[u64 > 90.0]
        h64 = stats["hot64"]
        h64[0] += len(over)
        if len(over):
            h64[1], h64[2] = min(h64[1], over.min()), max(h64[2], over.max())
        h64[3] += int((over.astype(np.float32) <= np.float32(90.0)).sum())
        user_steps.append(user.copy())
        t0 = time.perf_counter()
        region.write(data)
        if has_arrow:
            region.flush()
        t_write += time.perf_counter() - t0
    rows = hours * SCALE * STEPS_PER_HOUR
    log(f"ingest: {rows:,} rows in {t_write:.3f} s of write/flush "
        f"({rows / t_write:,.0f} rows/s)")
    stats["user"] = np.concatenate(user_steps)  # [steps, SCALE] f32
    stats["system"] = np.concatenate(system_steps)
    stats["next_hour"] = next_hour  # the same walk, hour by hour
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
                    "group_merge": gk.group_merge.launches,
                    "group_merge_pair": gk.group_merge_pair.launches}
        take_shapes("bucket_reduce", gk.bucket_reduce)
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

def timed_query(db, sql: str, card: str, label: str, check,
                reps: int = 10) -> dict:
    """First run (checked), warm runs (``reps``, or 3 when one run takes
    over 2 s), the stage split of one more run and the profiler's
    device-busy share; prints one line and returns the numbers."""
    from greptimedb_tpu_torch.query.parser import parse_sql

    t0 = time.perf_counter()
    res = db.sql(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    detail = check(res)
    warm = []
    while len(warm) < reps:
        t0 = time.perf_counter()
        db.sql(sql)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        if warm[0] > 2000 and reps > 3:
            reps = 3
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
               wall_ms=wall_ms, rows_to_host=metrics.get("rows_to_host"),
               mesh_rows=metrics.get("mesh_rows", False))
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
    take_shapes("segment_reduce", sk.segment_reduce)
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
        if name in results:  # a second shape: its error, and its own keys
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               kw.pop("max_abs_err"))
            for key, val in kw.items():
                results[name].setdefault(key, val)
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

    # -- compact: (f)'s 12 columns under its mask; three launches (the
    #    spans' counts, the order pass from the host's span offsets, one
    #    gather of every column) and one host sync --
    hot = window & (cols["usage_user"] > 90.0)
    ccols = {k: cols[k] for k in ["hostname", "ts", *METRICS]}
    k0 = (sk.compact.kernels, sk.compact.host_syncs)
    got, kept = sk.compact(ccols, hot)
    per_call = (sk.compact.kernels - k0[0], sk.compact.host_syncs - k0[1])
    if per_call != (3, 1):
        raise AssertionError(f"compact: {per_call} kernels / host syncs a "
                             f"call, want (3, 1)")
    want, wkept = sk.compact_plain(ccols, hot)
    if kept != wkept:
        raise AssertionError(f"compact keeps {kept} rows, plain {wkept}")
    err = max(max_err(got[k], want[k], exact=True) for k in ccols)
    ms = time_ms(lambda: sk.compact(ccols, hot))
    plain = time_ms(lambda: sk.compact_plain(ccols, hot), reps=5)
    ops, _wall = profile_ops(lambda: sk.compact(ccols, hot))
    device = sum(t for t, _n in ops.values()) or None
    split = ", ".join(f"{k.split('<')[0].split('(')[0][-28:]} {t:.4f}"
                      for k, (t, _n) in sorted(ops.items(),
                                               key=lambda kv: -kv[1][0]))
    tiny = {k: v[:4096] for k, v in ccols.items()}
    host = host_us(lambda: sk.compact(tiny, hot[:4096]), n=200)

    def lib_compact():
        rows = torch.nonzero(hot).squeeze(1)
        return [c.index_select(0, rows) for c in ccols.values()]

    lib = time_ms(lib_compact)
    # the mask, and the kept rows of each column read and written
    bnd, by = bound_ms(nbytes(hot) + 2 * kept * sum(
        c.element_size() for c in ccols.values()), 0)
    report("compact", f"12 columns N={n:,}, {kept:,} kept; {per_call[0]} "
           f"launches and {per_call[1]} host sync a call; device "
           f"{device if device is None else round(device, 4)} ms "
           f"({split or 'not measured'}); host {host:.1f} us a call at "
           f"4,096 rows", ms, plain, bnd, by, lib, err)
    keep("compact", ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
         library_ms=lib, max_abs_err=err, device_ms=device, host_us=host,
         per_call_kernels=per_call[0], per_call_host_syncs=per_call[1])
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
    passes, per, split = pass_split(lambda: sk.radix_argsort(keys, window),
                                    "radix_scatter")
    report("radix_argsort", f"decile keys N={n:,} ({passes} digit pass(es), "
           f"{per if per is None else round(per, 4)} ms a pass; one call by "
           f"kernel: {split})", ms, plain, bnd, by, lib, err)
    keep("radix_argsort", ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
         library_ms=lib, max_abs_err=err, passes=passes, pass_ms=per)

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
    masked = torch.where(over, hosts.to(torch.int64), sk.I64_MAX)
    lib = time_ms(lambda: torch.sort(masked, stable=True))
    del masked
    passes, per, split = pass_split(lambda: sk.radix_argsort(hosts, over),
                                    "radix_scatter")
    report("radix_argsort", f"hostname codes N={n:,} (distinct value sweep; "
           f"{passes} digit pass(es), "
           f"{per if per is None else round(per, 4)} ms a pass; one call by "
           f"kernel: {split}; library: torch.sort(stable=True) of the "
           f"masked codes)", ms, plain, bnd, by, lib, err)
    keep("radix_argsort", max_abs_err=err, hostname_ms=ms,
         hostname_plain_ms=plain, hostname_bound_ms=bnd,
         hostname_library_ms=lib, hostname_passes=passes,
         hostname_pass_ms=per)
    return results


# ---------------------------------------------------------------------------
# phase 4: PromQL main path
# ---------------------------------------------------------------------------

def prom_ingest(db, scrapes: int, seed: int, has_arrow: bool):
    """bench_promql.py's write path: one region.write per scrape over all
    series.  Returns the float32 values the device holds, [scrapes, S]
    (NaN = absent), in write-row order (row i = pod i // 10, container
    i % 10), and ``next_scrape(k)``, which writes scrape k of the same
    generator (unflushed) and returns its values [S]."""
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

    def next_scrape(k):
        nonlocal counters
        counters = counters + rng.uniform(100, 200, PROM_SERIES)
        reset = rng.random(PROM_SERIES) < 0.01
        counters[reset] = rng.uniform(0, 10, int(reset.sum()))
        v = counters.copy()
        v[rng.random(PROM_SERIES) < 0.001] = np.nan
        t0 = time.perf_counter()
        region.write({"pod": pod_col, "container": cont_col,
                      "ts": np.full(PROM_SERIES, PROM_T0 + k * SCRAPE_MS,
                                    dtype=np.int64),
                      "val": v})
        next_scrape.write_s = time.perf_counter() - t0
        return v.astype(np.float32)

    t_write = 0.0
    for k in range(scrapes):
        held[k] = next_scrape(k)
        t_write += next_scrape.write_s
    t0 = time.perf_counter()
    if has_arrow:
        region.flush()
    t_flush = time.perf_counter() - t0
    rows = scrapes * PROM_SERIES
    log(f"promql ingest: {rows:,} rows ({PROM_SERIES:,} series x {scrapes} "
        f"scrapes @ 15 s, seed {seed}) in {t_write:.3f} s of write "
        f"({rows / t_write:,.0f} rows/s), flush {t_flush:.3f} s; tags as "
        f"{'object arrays' if tags_as_objects else 'DictColumn (no pandas)'}")
    return held, next_scrape


def np_series_rates(held: np.ndarray, t_end: int,
                    range_ms: int = RANGE_MS) -> np.ndarray:
    """numpy float64 reference: Prometheus' extrapolated rate over
    (t_end - range, t_end] of every series (counter resets add the value
    before the drop; NaN samples are absent).  Returns [PROM_SERIES] (NaN
    for a series with fewer than two samples in the window)."""
    ts_k = PROM_T0 + SCRAPE_MS * np.arange(held.shape[0], dtype=np.int64)
    ks = np.flatnonzero((ts_k > t_end - range_ms) & (ts_k <= t_end))
    return np_rate_of(held[ks].astype(np.float64), ts_k[ks], t_end,
                      range_ms)


def np_rate_of(w: np.ndarray, ts: np.ndarray, t_end: int,
               range_ms: int) -> np.ndarray:
    """The extrapolated rate of samples ``w`` [k, S] (NaN = absent) taken
    at ``ts`` [k] ms, over the window (t_end - range, t_end]."""
    valid = ~np.isnan(w)
    nk, cols = w.shape[0], np.arange(w.shape[1])
    cnt = valid.sum(0)
    first = np.argmax(valid, axis=0)
    last = nk - 1 - np.argmax(valid[::-1], axis=0)
    fv, lv = w[first, cols], w[last, cols]
    ft = ts[first].astype(np.float64)
    lt = ts[last].astype(np.float64)
    # previous valid sample of each sample, for the reset drops
    upto = np.maximum.accumulate(
        np.where(valid, np.arange(nk)[:, None], -1), axis=0)
    prev = np.vstack([np.full((1, w.shape[1]), -1), upto[:-1]])
    pv = w[np.maximum(prev, 0), cols]
    drops = np.where(valid & (prev >= 0) & (pv > w), pv, 0.0).sum(0)
    delta = lv - fv + drops
    sampled = (lt - ft) / 1000.0
    avg_dur = sampled / np.maximum(cnt - 1, 1)
    dts = (ft - (t_end - range_ms)) / 1000.0
    dte = (t_end - lt) / 1000.0
    thr = avg_dur * 1.1
    dts = np.where(dts >= thr, avg_dur / 2, dts)
    dte = np.where(dte >= thr, avg_dur / 2, dte)
    with np.errstate(divide="ignore", invalid="ignore"):
        dtz = np.where(delta > 0, sampled * (fv / np.maximum(delta, 1e-30)),
                       np.inf)
        dts = np.minimum(dts, dtz)
        factor = (sampled + dts + dte) / np.maximum(sampled, 1e-30)
    return np.where(cnt >= 2, delta * factor / (range_ms / 1000), np.nan)


def np_instant(held: np.ndarray, t: int,
               lookback_ms: int = RANGE_MS) -> np.ndarray:
    """Every series' instant value at t: its last non-NaN sample in
    (t - lookback, t] (NaN where there is none).  Returns [PROM_SERIES]."""
    w, _ts = np_window(held, t, lookback_ms)
    valid = ~np.isnan(w)
    last = w.shape[0] - 1 - np.argmax(valid[::-1], axis=0)
    return np.where(valid.any(0), w[last, np.arange(w.shape[1])], np.nan)


def np_quantile(w: np.ndarray, q: float) -> np.ndarray:
    """Prometheus' quantile of samples ``w`` [k, S] along k (NaN = absent):
    linear interpolation between the order statistics at q * (n - 1)."""
    srt = np.sort(w, axis=0)  # NaN last
    n = (~np.isnan(w)).sum(0)
    rank = q * np.maximum(n - 1, 0)
    lo = np.floor(rank).astype(np.int64)[None]
    hi = np.ceil(rank).astype(np.int64)[None]
    vlo = np.take_along_axis(srt, lo, 0)[0]
    vhi = np.take_along_axis(srt, hi, 0)[0]
    return np.where(n > 0, vlo + (vhi - vlo) * (rank - lo[0]), np.nan)


def np_pod_rates(held: np.ndarray, t_end: int) -> np.ndarray:
    """``np_series_rates`` summed per pod over its containers, rate-less
    series skipped.  Returns [PODS] (NaN for a pod without any rate)."""
    per_pod = np_series_rates(held, t_end).reshape(PODS, CONTAINERS)
    some = ~np.isnan(per_pod).all(1)
    return np.where(some, np.nansum(per_pod, axis=1), np.nan)


def check_pod_values(name: str, got: np.ndarray, want: np.ndarray,
                     exact: bool = False) -> float:
    """Golden bound (or exact) on equal-shaped grids of values, e.g. [PODS]
    or [steps, PODS]; NaN must match."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
    if (np.isnan(got) != np.isnan(want)).any():
        raise AssertionError(f"{name}: absent cells differ")
    ok = ~np.isnan(want)
    diff = np.abs(got[ok] - want[ok])
    lim = 0.0 if exact else REL_TOL * np.maximum(1.0, np.abs(want[ok]))
    if (diff > lim).any():
        i = int(np.argmax(diff - lim))
        raise AssertionError(f"{name}: {got[ok][i]} vs {want[ok][i]}")
    return float(diff.max()) if diff.size else 0.0


# ---------------------------------------------------------------------------
# phase 4, continued: the rest of the PromQL surface at full width
# ---------------------------------------------------------------------------

def np_window(held: np.ndarray, t: int, range_ms: int = RANGE_MS):
    """The samples of (t - range, t] of every series: [k, S] f64 (NaN =
    absent) and their timestamps [k]."""
    ts_k = PROM_T0 + SCRAPE_MS * np.arange(held.shape[0], dtype=np.int64)
    ks = np.flatnonzero((ts_k > t - range_ms) & (ts_k <= t))
    return held[ks].astype(np.float64), ts_k[ks]


def np_per_pod(x: np.ndarray, how: str) -> np.ndarray:
    """[S] per-series values → [PODS] sum or max over each pod's
    containers, absent series skipped (NaN where all are absent)."""
    per = x.reshape(PODS, CONTAINERS)
    some = ~np.isnan(per).all(1)
    with np.errstate(all="ignore"):
        red = np.nansum(per, 1) if how == "sum" else np.nanmax(
            np.where(np.isnan(per), -np.inf, per), 1)
    return np.where(some, red, np.nan)


def np_series_fn(w: np.ndarray, ts: np.ndarray, fn: str, start: int):
    """One series' window function over its valid samples (Prometheus
    semantics, float64)."""
    ok = ~np.isnan(w)
    v, t = w[ok], ts[ok]
    if fn == "changes":
        return float((v[1:] != v[:-1]).sum()) if len(v) else np.nan
    if fn == "irate":
        if len(v) < 2:
            return np.nan
        dv = v[-1] - v[-2]
        dv = v[-1] if dv < 0 else dv
        return dv / ((t[-1] - t[-2]) / 1000.0)
    if fn == "deriv":
        if len(v) < 2:
            return np.nan
        x = (t - start) / 1000.0
        return float(np.polyfit(x, v, 1)[0])
    if fn == "quantile":
        if not len(v):
            return np.nan
        srt = np.sort(v)
        rank = 0.9 * (len(srt) - 1)
        lo, hi = int(np.floor(rank)), int(np.ceil(rank))
        return srt[lo] + (srt[hi] - srt[lo]) * (rank - lo)
    raise ValueError(fn)


def prom_timed(label: str, run, check, card: str, warm_n: int = 5) -> dict:
    """First run (checked), ``warm_n`` warm runs, the stage split of the
    last and the profiler's device-busy share of one more; prints one
    line.  ``run`` returns (result, stage_ms)."""
    t0 = time.perf_counter()
    out, _stages = run()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    detail = check(out)
    warm = []
    for _ in range(warm_n):
        t0 = time.perf_counter()
        _out, stages = run()
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    busy, wall, top = device_busy(run, top_n=4, sessions=2)
    warm_ms = float(np.median(warm))
    log(f"promql {label}: {detail}; first {first_ms:.3f} ms, warm median "
        f"{warm_ms:.3f} ms ({warm_n} runs); stages {stages}; profiler: "
        f"device busy {busy:.3f} ms of {wall:.3f} ms wall; top device ops "
        f"{top} — {card}")
    return dict(first_ms=first_ms, warm_ms=warm_ms, busy_ms=busy,
                wall_ms=wall)


def _promql_surface(db, held: np.ndarray, start: int, steps: int,
                    card: str) -> dict:
    """The rest of the PromQL surface on the full-width table, 20 steps of
    15 s and 5 m windows, each query checked against numpy on the
    generated data: gauge windows and min/max windows fused and unfused,
    changes/irate/deriv/quantile_over_time of one pod, topk over all 2^20
    series (ng == 1), quantile by pod, one binary expression and one
    subquery."""
    from greptimedb_tpu_torch.compile.fused import FUSED_DISPATCHES
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import parse_promql

    end = start + (steps - 1) * SCRAPE_MS
    step_ts = start + SCRAPE_MS * np.arange(steps, dtype=np.int64)
    metric = "http_requests_total"
    report = {}

    def evaluator(expr):
        def run():
            ev = PromEvaluator(db, start / 1000.0, end / 1000.0, 15.0)
            res = ev.eval(parse_promql(expr))
            torch.cuda.synchronize()
            return res, dict(ev.stage_ms)
        return run

    def tql(expr):
        sql = f"TQL EVAL ({start / 1000}, {end / 1000}, 15) {expr}"

        def run():
            db.stage_sink = {}
            try:
                res = db.sql(sql)
                return res, {k: v for k, v in db.stage_sink.items()
                             if k.endswith("_ms")}
            finally:
                db.stage_sink = None
        return run

    # numpy per step: [T, S] window statistics of every series
    series_rate = np.stack([np_series_rates(held, t) for t in step_ts])
    avg_w, max_w = [], []
    for t in step_ts:
        w, _ts = np_window(held, int(t))
        with np.errstate(all="ignore"):
            avg_w.append(np.nanmean(w, 0))
            max_w.append(np.where(np.isnan(w).all(0), np.nan,
                                  np.nanmax(np.where(np.isnan(w), -np.inf,
                                                     w), 0)))
    avg_w, max_w = np.stack(avg_w), np.stack(max_w)
    pod_avg = np.stack([np_per_pod(a, "sum") for a in avg_w])  # [T, PODS]

    def pod_grid(res) -> np.ndarray:
        if res.num_series != PODS:
            raise AssertionError(f"{res.num_series} groups, expected {PODS}")
        pods = np.array([int(res.labels[g]["pod"][4:])
                         for g in range(res.num_series)])
        grid = np.full((steps, PODS), np.nan)
        grid[:, pods] = res.values.cpu().numpy().T
        return grid

    # gauge and min/max windows under an aggregation, fused and unfused
    for name, expr, want, how in (
            ("avg_over_time", f"sum by (pod) (avg_over_time({metric}[5m]))",
             pod_avg, "sum"),
            ("max_over_time", f"max by (pod) (max_over_time({metric}[5m]))",
             np.stack([np_per_pod(m, "max") for m in max_w]), "max")):
        fused_before = FUSED_DISPATCHES["count"]
        fused_res = {}

        def check_fused(res, name=name, want=want, how=how):
            fused_res["res"] = res
            err = check_pod_values(name, pod_grid(res), want,
                                   exact=how == "max")
            return f"{PODS:,} groups x {steps} steps correct (max |diff| " \
                   f"{err:.3g})"

        report[f"{name} fused"] = prom_timed(
            f"{expr} (fused)", evaluator(expr), check_fused, card)
        if FUSED_DISPATCHES["count"] == fused_before:
            raise AssertionError(f"{name}: the fused route was not taken")
        os.environ["GREPTIME_PLAN_FUSION"] = "off"
        try:
            def check_unfused(res, name=name):
                f = fused_res["res"]
                if not torch.equal(torch.nan_to_num(res.values, nan=-1.0),
                                   torch.nan_to_num(f.values, nan=-1.0)):
                    raise AssertionError(f"{name}: unfused values differ "
                                         f"from the fused values")
                if list(res.labels) != list(f.labels):
                    raise AssertionError(f"{name}: unfused labels differ")
                return "rows equal to the fused route's"

            report[f"{name} unfused"] = prom_timed(
                f"{expr} (GREPTIME_PLAN_FUSION=off)", evaluator(expr),
                check_unfused, card)
        finally:
            os.environ.pop("GREPTIME_PLAN_FUSION", None)

    # window functions of one pod through TQL EVAL
    pod = 7
    cols = np.arange(pod * CONTAINERS, (pod + 1) * CONTAINERS)
    for fn, expr in (
            ("changes", f'changes({metric}{{pod="pod-{pod}"}}[5m])'),
            ("irate", f'irate({metric}{{pod="pod-{pod}"}}[5m])'),
            ("deriv", f'deriv({metric}{{pod="pod-{pod}"}}[5m])'),
            ("quantile", f'quantile_over_time(0.9, '
                         f'{metric}{{pod="pod-{pod}"}}[5m])')):
        want = np.full((steps, CONTAINERS), np.nan)
        for j, t in enumerate(step_ts):
            w, ts = np_window(held[:, cols], int(t))
            for c in range(CONTAINERS):
                want[j, c] = np_series_fn(w[:, c], ts, fn, start)

        def check_pod(res, fn=fn, want=want):
            got = np.full((steps, CONTAINERS), np.nan)
            step_of = {int(t): j for j, t in enumerate(step_ts)}
            for r in res.rows:
                lab = dict(zip(res.column_names, r))
                if lab["pod"] != f"pod-{pod}":
                    raise AssertionError(f"{fn}: row of {lab['pod']}")
                got[step_of[lab["ts"]], int(lab["container"][1:])] = \
                    lab["val"]
            err = check_pod_values(fn, got, want, exact=fn == "changes")
            return f"{len(res.rows)} rows correct (max |diff| {err:.3g})"

        report[fn] = prom_timed(expr, tql(expr), check_pod, card)

    # quantile_over_time over every series (window_matrix at lmax 32):
    # a seeded sample of 4,096 series against numpy, labels included
    pick = np.sort(np.random.default_rng(14).choice(PROM_SERIES, 4096,
                                                    replace=False))
    q_all = np.stack([np_quantile(np_window(held[:, pick], int(t))[0], 0.9)
                      for t in step_ts])

    def check_q_all(res):
        if res.num_series != PROM_SERIES:
            raise AssertionError(f"quantile_over_time: {res.num_series} "
                                 f"series")
        for i in pick[:64]:
            lab = res.labels[int(i)]
            if (lab["pod"], lab["container"]) != (
                    f"pod-{i // CONTAINERS}", f"c{i % CONTAINERS}"):
                raise AssertionError(f"quantile_over_time: series {i} is "
                                     f"{lab}")
        got = res.values[torch.as_tensor(pick, device=res.values.device)]
        err = check_pod_values("quantile_over_time", got.cpu().numpy().T,
                               q_all)
        return f"{len(pick):,} sampled of {PROM_SERIES:,} series x " \
               f"{steps} steps correct (max |diff| {err:.3g})"

    expr = f"quantile_over_time(0.9, {metric}[5m])"
    report["quantile_over_time"] = prom_timed(expr, evaluator(expr),
                                              check_q_all, card)

    # topk over every series (ng == 1): the kept cells are the top 5 rates
    def check_topk(res):
        v = res.values.cpu().numpy()  # [S, T]
        if res.num_series != PROM_SERIES:
            raise AssertionError(f"topk: {res.num_series} series")
        for j in range(steps):
            r = series_rate[j]
            kth = np.sort(r[~np.isnan(r)])[-5]
            kept = np.flatnonzero(~np.isnan(v[:, j]))
            must = np.flatnonzero(r > kth + REL_TOL * max(1.0, abs(kth)))
            if len(kept) < 5 or not np.isin(must, kept).all() or (
                    r[kept] < kth - REL_TOL * max(1.0, abs(kth))).any():
                raise AssertionError(f"topk: step {j} keeps {kept}")
            check_pod_values("topk", v[kept, j], r[kept])
        return f"top 5 of {PROM_SERIES:,} series x {steps} steps correct"

    expr = f"topk(5, rate({metric}[5m]))"
    report["topk"] = prom_timed(expr, evaluator(expr), check_topk, card)

    # quantile by pod over the 10 containers' rates
    per = series_rate.reshape(steps, PODS, CONTAINERS)
    with np.errstate(all="ignore"):
        srt = np.sort(per, axis=2)  # NaN last
        n = (~np.isnan(per)).sum(2)
        rank = 0.99 * np.maximum(n - 1, 0)
        lo = np.floor(rank).astype(np.int64)
        hi = np.ceil(rank).astype(np.int64)
        vlo = np.take_along_axis(srt, lo[..., None], 2)[..., 0]
        vhi = np.take_along_axis(srt, hi[..., None], 2)[..., 0]
        q_want = np.where(n > 0, vlo + (vhi - vlo) * (rank - lo), np.nan)
    expr = f"quantile by (pod) (0.99, rate({metric}[5m]))"
    report["quantile by pod"] = prom_timed(
        expr, evaluator(expr), lambda res: (
            f"{PODS:,} groups correct (max |diff| "
            f"{check_pod_values('quantile', pod_grid(res), q_want):.3g})"),
        card)

    # a binary expression: one-to-one matching of two aggregations
    pod_rate = np.stack([np_per_pod(r, "sum") for r in series_rate])
    with np.errstate(all="ignore"):
        ratio = pod_rate / pod_avg
    expr = (f"sum by (pod) (rate({metric}[5m])) / "
            f"sum by (pod) (avg_over_time({metric}[5m]))")
    report["binary"] = prom_timed(
        expr, evaluator(expr), lambda res: (
            f"{PODS:,} matched groups correct (max |diff| "
            f"{check_pod_values('binary', pod_grid(res), ratio):.3g})"),
        card)

    # subqueries over 1 m-aligned inner evaluations: max and quantile over
    # rate(m[1m]) (window_matrix_dense), and rate over the raw metric's
    # instant values (subquery_counter)
    sub_ms = 60_000
    t0 = ((start - RANGE_MS) // sub_ms + 1) * sub_ms
    inner = np.arange(t0, end + 1, sub_ms, dtype=np.int64)
    inner_rate = np.stack([np_series_rates(held, int(t), 60_000)
                           for t in inner])
    inner_val = np.stack([np_instant(held, int(t)) for t in inner])
    sub_max = np.full((steps, PROM_SERIES), np.nan)
    sub_q = np.full((steps, PROM_SERIES), np.nan)
    sub_rate = np.full((steps, PROM_SERIES), np.nan)
    for j, t in enumerate(step_ts):
        pick = (inner > t - RANGE_MS) & (inner <= t)
        w = inner_rate[pick]
        with np.errstate(all="ignore"):
            sub_max[j] = np.where(np.isnan(w).all(0), np.nan, np.nanmax(
                np.where(np.isnan(w), -np.inf, w), 0))
            sub_q[j] = np_quantile(w, 0.9)
        sub_rate[j] = np_rate_of(inner_val[pick], inner[pick], int(t),
                                 RANGE_MS)

    def check_sub(res, name, want):
        if res.num_series != PROM_SERIES:
            raise AssertionError(f"{name}: {res.num_series} series")
        err = check_pod_values(name, res.values.cpu().numpy().T, want)
        return f"{PROM_SERIES:,} series x {steps} steps correct (max " \
               f"|diff| {err:.3g})"

    for name, expr, want in (
            ("subquery", f"max_over_time(rate({metric}[1m])[5m:1m])",
             sub_max),
            ("subquery quantile",
             f"quantile_over_time(0.9, rate({metric}[1m])[5m:1m])", sub_q),
            ("subquery rate", f"rate({metric}[5m:1m])", sub_rate)):
        report[name] = prom_timed(
            expr, evaluator(expr),
            lambda res, name=name, want=want: check_sub(res, name, want),
            card)
    return report


def geometry_route(events) -> str:
    """The window geometry one evaluation took, from its bounds events: a
    state served (``bounds_hit``) or built (``bounds_miss`` with neither
    ``bounds_refused`` nor ``bounds_reject``) is the count geometry, any
    other the range geometry (the layout's series offset table)."""
    served = events.get("bounds_hit", 0) + events.get("bounds_miss", 0)
    refused = events.get("bounds_refused", 0) + events.get("bounds_reject", 0)
    return "count" if served > refused else "range"


def _count_geometry_checks(db, held: np.ndarray, t_end: int, start: int,
                           steps: int, card: str) -> None:
    """K9's count geometry on the full-width table, route by route, each
    answer equal to numpy and to the fused or range-geometry answer
    exactly:

    - the instant sum by (pod) (rate) with GREPTIME_PLAN_FUSION=off
      (S·T·L = 2^20 · 1 · 64 = 2^26): at the default 1 GiB PromQL budget
      its 512 MiB state does not fit beside the 1.06 GB sort layout (with
      its series offset table) and is rejected (the range geometry); with
      the budget raised to 4 GiB it is built and served (the count
      geometry).  Warm times of range, count, range;
    - max by (pod) (max_over_time) unfused at 20 steps (S·T·L = 1.3e9 >
      2^27): refused before any build, the range geometry;
    - the one-pod changes/irate/deriv TQL queries: the count geometry at
      the default budget, equal to GREPTIME_PROMQL_CACHE=off's rows.

    The PromQL cache's stats and sort/bounds events are printed."""
    from greptimedb_tpu_torch.ops import promql_kernels as pk
    from greptimedb_tpu_torch.promql.engine import BOUNDS_COMPARE_CAP
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import parse_promql

    cache = db.promql_cache
    rid = db._table_view("http_requests_total").region_id
    end_s = t_end / 1000.0
    expr = parse_promql(PROM_QUERY)

    def instant():
        ev = PromEvaluator(db, end_s, end_s, 1.0)
        res = ev.eval(expr)
        torch.cuda.synchronize()
        return ev, res

    def routed(ev, want_route: str):
        got = geometry_route(ev.cache_events)
        if got != want_route:
            raise AssertionError(f"geometry {got}, wanted {want_route}: "
                                 f"events {dict(ev.cache_events)}")

    def same(a, b) -> bool:
        return torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0))

    _fev, fused = instant()
    want = np_pod_rates(held, t_end)
    os.environ["GREPTIME_PLAN_FUSION"] = "off"
    cap0 = cache.capacity
    try:
        timings = {}
        for label, route, capacity in (
                ("range", "range", cap0),
                ("count", "count", 4 << 30),
                ("range again", "range", cap0)):
            # each budget starts from an empty PromQL state of the table,
            # so its first run builds what that budget admits
            cache.invalidate_region(rid)
            cache.capacity = capacity
            for run in ("first run", "second run"):
                t0 = time.perf_counter()
                ev, res = instant()
                ms = (time.perf_counter() - t0) * 1e3
                routed(ev, route)
                if not same(res.values, fused.values) or (
                        list(res.labels) != list(fused.labels)):
                    raise AssertionError(f"{route} geometry: instant rows "
                                         f"differ from the fused route's")
                pods = np.array([int(res.labels[g]["pod"][4:])
                                 for g in range(res.num_series)])
                got = np.full(PODS, np.nan)
                got[pods] = res.values.cpu().numpy()[:, 0]
                err = check_pod_values(f"instant ({route})", got, want)
                log(f"promql instant {PROM_QUERY} unfused, {route} geometry "
                    f"({run}, PromQL budget GREPTIME_PROMQL_CACHE_BYTES = "
                    f"{capacity:,} B): rows equal to the fused route's and "
                    f"numpy (max |diff| {err:.3g}); {ms:.3f} ms; events "
                    f"{dict(ev.cache_events)}; cache {cache.stats()}")
            warm, win = [], []
            for _ in range(5):
                db.stage_sink = {}
                t0 = time.perf_counter()
                ev, res = instant()
                warm.append((time.perf_counter() - t0) * 1e3)
                win.append(ev.stage_ms.get("window_kernel", 0.0))
                db.stage_sink = None
                routed(ev, route)
                if not same(res.values, fused.values):
                    raise AssertionError(f"{route}: instant rows differ")
            timings[label] = (float(np.median(warm)), float(np.median(win)))
            log(f"promql instant unfused, {label} geometry (budget "
                f"{capacity:,} B): warm median {timings[label][0]:.3f} ms, "
                f"window_kernel stage {timings[label][1]:.3f} ms (5 runs); "
                f"events {dict(ev.cache_events)} — {card}")
    finally:
        cache.capacity = cap0
        cache.invalidate_region(rid)
        os.environ.pop("GREPTIME_PLAN_FUSION", None)
    # max by (pod) (max_over_time) unfused at 20 steps: refused by the
    # S·T·L cap before any build, the range geometry
    mexpr = "max by (pod) (max_over_time(http_requests_total[5m]))"
    end = start + (steps - 1) * SCRAPE_MS

    def range_eval():
        ev = PromEvaluator(db, start / 1000.0, end / 1000.0, 15.0)
        res = ev.eval(parse_promql(mexpr))
        torch.cuda.synchronize()
        return ev, res

    s_pad = 1 << (PROM_SERIES - 1).bit_length()
    lw = 1 << (held.shape[0] - 1).bit_length()
    if s_pad * steps * lw <= BOUNDS_COMPARE_CAP:
        raise AssertionError(f"{steps} steps: under the S·T·L cap")
    os.environ["GREPTIME_PLAN_FUSION"] = "off"
    try:
        for run in ("first run", "second run"):
            built = pk.gather_ts_mat.launches
            ev, res = range_eval()
            routed(ev, "range")
            if ev.cache_events["bounds_refused"] != 1 or (
                    pk.gather_ts_mat.launches != built):
                raise AssertionError(f"max_over_time: state built past the "
                                     f"cap: {dict(ev.cache_events)}")
            log(f"promql {mexpr} unfused at {steps} steps ({run}): S·T·L = "
                f"{s_pad:,} x {steps} x {lw} = {s_pad * steps * lw:,} > "
                f"{BOUNDS_COMPARE_CAP:,}, refused, no state built; events "
                f"{dict(ev.cache_events)}")
    finally:
        os.environ.pop("GREPTIME_PLAN_FUSION")
    _fev, fres = range_eval()
    if not same(res.values, fres.values):
        raise AssertionError("max_over_time: unfused rows differ from "
                             "the fused route's")
    # one pod through TQL: the count geometry, equal to the range
    # geometry's rows (GREPTIME_PROMQL_CACHE=off keeps no state)
    pod = 7
    for fn in ("changes", "irate", "deriv"):
        sql = (f"TQL EVAL ({start / 1000}, {end / 1000}, 15) "
               f'{fn}(http_requests_total{{pod="pod-{pod}"}}[5m])')
        db.stage_sink = {}
        try:
            res = db.sql(sql)
            events = db.stage_sink.get("promql_cache_events") or {}
        finally:
            db.stage_sink = None
        if geometry_route(events) != "count":
            raise AssertionError(f"{fn}: not the count geometry: {events}")
        os.environ["GREPTIME_PROMQL_CACHE"] = "off"
        try:
            plain = db.sql(sql)
        finally:
            os.environ.pop("GREPTIME_PROMQL_CACHE")
        if res.rows != plain.rows or not res.rows:
            raise AssertionError(f"{fn}: count geometry rows differ from "
                                 f"the range geometry's")
        log(f"promql count geometry, {fn} of pod-{pod} ({len(res.rows)} "
            f"rows): equal to the range geometry's rows; events "
            f"{events}")


def phase_promql(gk, pk, sk, scrapes: int, seed: int, has_arrow: bool,
                 card: str):
    """Returns (launches, db, home, the data's context): the db stays open
    for phase 5, which holds the kernels against their plain versions on
    its resident table, and for the write-then-query step after it."""
    from greptimedb_tpu_torch.standalone import GreptimeDB
    from greptimedb_tpu_torch.storage.region import RegionOptions

    if scrapes < 40:
        log(f"cut: {scrapes} scrapes per series instead of 40 (time limit)")
    home = tempfile.mkdtemp(prefix="chip_smoke_promql_")
    db = GreptimeDB(home, region_options=RegionOptions(
        wal_enabled=False, flush_threshold_bytes=1 << 40))
    try:
        launches, pctx = _promql_path(gk, pk, sk, db, scrapes, seed,
                                      has_arrow, card)
        return launches, db, home, pctx
    except BaseException:
        db.close()
        shutil.rmtree(home, ignore_errors=True)
        raise


def _promql_path(gk, pk, sk, db, scrapes, seed, has_arrow, card) -> dict:
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import parse_promql

    db.sql("CREATE TABLE http_requests_total (pod STRING, container STRING, "
           "ts TIMESTAMP(3) TIME INDEX, val DOUBLE, "
           "PRIMARY KEY (pod, container))")
    held, next_scrape = prom_ingest(db, scrapes, seed, has_arrow)
    gk.reset_launch_counts()
    pk.reset_launch_counts()
    sk.reset_launch_counts()
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
    # a warm instant query takes its selection, sort layout (with its
    # series offset table) and group layout from the PromQL cache: an entry
    # that outgrows the budget rebuilds them on every query instead
    ce = ev.cache_events
    cold = [k for k in ("selection", "sort", "group")
            if ce[f"{k}_hit"] < 1 or ce[f"{k}_miss"] or ce[f"{k}_reject"]]
    if cold:
        raise AssertionError(f"warm instant query: {cold} not served from "
                             f"the PromQL cache; events {dict(ce)}")
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
    log(f"cut: {TQL_WARM} warm runs of the TQL range query instead of 10 "
        f"(~3.3 s each; the time limit)")
    warm = []
    for _ in range(TQL_WARM):
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
        f"{tql_first_ms:.3f} ms, warm median {tql_warm_ms:.3f} ms "
        f"({TQL_WARM} runs);"
        f" {range_samples / (tql_warm_ms / 1e3):,.0f} samples/s "
        f"({range_samples:,} samples in range); stages {stages}; profiler: "
        f"device busy {busy_r:.3f} ms of {wall_r:.3f} ms wall; top device "
        f"ops {top_r} — {card}")
    _promql_surface(db, held, start, steps, card)
    _count_geometry_checks(db, held, t_end, start, steps, card)
    if pk.prefix_scan.launches:
        raise AssertionError(f"prefix_scan launched {pk.prefix_scan.launches}"
                             f" times on the PromQL path")
    launches = {"series_offsets": pk.series_offsets.launches,
                "series_ranges": pk.series_ranges.launches,
                "gather_ts_mat": pk.gather_ts_mat.launches,
                "sort_layout": pk.sort_layout.launches,
                "counter_window": pk.counter_window.launches,
                "group_merge": gk.group_merge.launches,
                "window_stats": pk.window_stats.launches,
                "minmax_window": pk.minmax_window.launches,
                "window_count_max": pk.window_count_max.launches,
                "window_matrix": pk.window_matrix.launches,
                "window_matrix_dense": pk.window_matrix_dense.launches,
                "subquery_counter": pk.subquery_counter.launches,
                "segment_select": sk.segment_select.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"promql path: launches {launches}, max_memory_allocated {peak} B, "
        f"promql cache {db.promql_cache.stats()}")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} never launched on the PromQL path")
    # the resident table is in (tsid, ts) order: every layout build must
    # take sort_layout's presorted route (one partition pass)
    routes = {"presorted": pk.sort_layout.presorted,
              "general": pk.sort_layout.general}
    log(f"promql path: sort_layout routes {routes}")
    if routes["general"] or routes["presorted"] != launches["sort_layout"]:
        raise AssertionError(f"sort_layout left the presorted route on the "
                             f"PromQL path: {routes}")
    # every window of the path holds at most 21 samples (5 m at 15 s; lmax
    # 32) and every subquery matrix 6 (K), so every quantile / mad sort of
    # the path must take the register route (matrix_route(width <= 32))
    matrix = ("window_matrix", "window_matrix_dense")
    for kname, wrapper in zip(matrix, (pk.window_matrix,
                                       pk.window_matrix_dense)):
        ROUTES[kname] = {"register": wrapper.register, "warp": wrapper.warp}
    log(f"promql path: window_matrix routes "
        f"{ {k: ROUTES[k] for k in matrix} }")
    for kname in matrix:
        r = ROUTES[kname]
        if r["warp"] or r["register"] != launches[kname]:
            raise AssertionError(f"{kname} left the register route on the "
                                 f"PromQL path: {r}, {launches[kname]} "
                                 f"launches")
    # every window kernel of the path takes the range geometry (the sort
    # layout's series offset table) or, where its state is served, the
    # count geometry; none the whole-layout search, and no query runs the
    # whole-table prefix_scan
    for wrapper in pk.WINDOW_KERNELS:
        GEOMETRIES[wrapper.__name__] = {
            g: getattr(wrapper, g) for g in ("range", "search", "count")
            if hasattr(wrapper, g)}
    log(f"promql path: window geometries {GEOMETRIES}; prefix_scan "
        f"launches {pk.prefix_scan.launches}")
    for kname, g in GEOMETRIES.items():
        if g["search"] or sum(g.values()) != launches[kname]:
            raise AssertionError(f"{kname} left the range and count "
                                 f"geometries on the PromQL path: {g}, "
                                 f"{launches[kname]} launches")
    launches["prefix_scan"] = pk.prefix_scan.launches
    return launches, dict(held=held, next_scrape=next_scrape,
                          scrapes=scrapes)


# ---------------------------------------------------------------------------
# phase 5: PromQL kernels against their plain versions
# ---------------------------------------------------------------------------

def count_geometry_timing(pk, lay, want, sel, t_end: int, report) -> dict:
    """K9's geometries at the instant query's shapes (S = 2^20, T = 1):
    series_ranges and gather_ts_mat (the count geometry's state) against
    their plain versions and torch.searchsorted of the same series bounds,
    then counter_window at T = 1 in the range geometry (``lay`` carries
    the series offset table), the count geometry and the forced
    whole-layout search (rate and instant modes), the three outputs equal
    bit for bit."""
    key_s, ts_s, kp = lay[0], lay[1], lay[6]
    n = key_s.shape[0]
    S = sel.shape[0]
    out = {}
    g_start, g_cnt, g_max = pk.series_ranges(key_s, kp, sel)
    w_start, w_cnt, w_max = pk.series_ranges_plain(want[0], want[6], sel)
    if g_max != w_max or not (torch.equal(g_start, w_start)
                              and torch.equal(g_cnt, w_cnt)):
        raise AssertionError("series_ranges differs from its plain version")
    L = 1 << (max(g_max, 1) - 1).bit_length()
    ms = time_ms(lambda: pk.series_ranges(key_s, kp, sel))
    plain = time_ms(lambda: pk.series_ranges_plain(want[0], want[6], sel))
    skey = torch.where(sel >= 0, sel.long(), 0) * kp
    lib = time_ms(lambda: (torch.searchsorted(key_s, skey),
                           torch.searchsorted(key_s, skey + (kp - 1),
                                              right=True)))
    # two binary searches of log2(n) int64 compares a series
    bnd, by = bound_ms(nbytes(sel, g_start, g_cnt), S * 2 * n.bit_length())
    report("series_ranges", f"S={S:,}, N={n:,}, cnt_max {g_max}, L {L} "
           f"(library: torch.searchsorted of the same bounds; the wrapper's "
           f"one host sync inside)", ms, plain, bnd, by, lib, 0.0)
    out["series_ranges"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                bound_by=by, library_ms=lib, max_abs_err=0.0)
    g_mat = pk.gather_ts_mat(ts_s, g_start, g_cnt, L)
    w_mat = pk.gather_ts_mat_plain(want[1], w_start, w_cnt, L)
    if not torch.equal(g_mat, w_mat):
        raise AssertionError("gather_ts_mat differs from its plain version")
    ms = time_ms(lambda: pk.gather_ts_mat(ts_s, g_start, g_cnt, L))
    plain = time_ms(lambda: pk.gather_ts_mat_plain(want[1], w_start, w_cnt,
                                                   L))
    rows = int(g_cnt.long().sum())
    bnd, by = bound_ms(nbytes(g_start, g_cnt, g_mat) + rows * 8, 0)
    report("gather_ts_mat", f"[{S:,}, {L}] int64 of {rows:,} rows", ms,
           plain, bnd, by, None, 0.0)
    out["gather_ts_mat"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                bound_by=by, library_ms=None,
                                max_abs_err=0.0)
    bounds = (g_start, g_cnt, g_mat)
    w_bounds = (w_start, w_cnt, w_mat)
    t1 = {}
    for kind, func in (("rate", "rate"), ("instant", None)):
        kw = dict(step_ms=SCRAPE_MS, num_steps=1, range_ms=RANGE_MS,
                  kind=kind, func=func,
                  range_s=RANGE_MS / 1000 if func else None)
        runs = {
            "range": lambda kw=kw: pk.counter_window(lay, sel, t_end, **kw),
            "count": lambda kw=kw: pk.counter_window(lay, sel, t_end,
                                                     bounds=bounds, **kw),
            "searchsorted": lambda kw=kw: pk.counter_window(
                lay, sel, t_end, geometry="search", **kw)}
        a = runs["range"]()
        c = pk.counter_window_plain(want, sel, t_end, bounds=w_bounds, **kw)
        if kind == "rate":
            a, c = {"rate": a}, {"rate": c}
        for name in ("count", "searchsorted"):
            b = runs[name]()
            b = {"rate": b} if kind == "rate" else b
            if not same_output(a, b):
                raise AssertionError(f"counter_window {kind}: the {name} "
                                     f"geometry differs from the range "
                                     f"geometry")
        for k in a:
            max_err(a[k], c[k], exact=k not in ("rate", "delta_adj"))
        times = {}
        for name in ("range", "count", "searchsorted", "range"):
            times.setdefault(name, []).append(time_ms(runs[name]))
        ms_r = float(np.median(times["range"]))
        ms_c = times["count"][0]
        ms_s = times["searchsorted"][0]
        log(f"kernel counter_window[{kind} S={S:,} T=1 in three "
            f"geometries]: range {ms_r:.4f} ms, count geometry {ms_c:.4f} "
            f"ms, whole-layout search {ms_s:.4f} ms (the count state: "
            f"series_ranges {out['series_ranges']['ms']:.4f} + "
            f"gather_ts_mat {out['gather_ts_mat']['ms']:.4f} ms once per "
            f"resident selection), outputs equal bit for bit")
        t1[f"t1_{kind}_range_ms"] = ms_r
        t1[f"t1_{kind}_searchsorted_ms"] = ms_s
        t1[f"t1_{kind}_count_ms"] = ms_c
    out["t1"] = t1
    return out


def same_output(a, b) -> bool:
    """Equal bit for bit: tensors (f32 compared as int32), dicts of them,
    or plain values."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_output(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)
    return a == b


def range_timing(name: str, variant: str, run, card: str,
                 graph: bool = True) -> dict:
    """``run(geometry)`` in the range geometry (the main path's), timed by
    CUDA events and, with ``graph``, as device time (a kernel whose result
    the host reads cannot be captured).  The forced whole-layout search is
    timed beside it by ``time_scans.py windows`` and held equal to it bit
    for bit by ``tests/test_torch_promql_ranges_cuda.py``.  Prints one
    line; returns ``ms`` and, with ``graph``, ``graph_ms``."""
    t = {"ms": time_ms(lambda: run("range"))}
    if graph:
        t["graph_ms"] = graph_ms(lambda: run("range"))
    dev = f"; device time {t['graph_ms']:.4f} ms" if graph else ""
    log(f"kernel {name}[{variant}]: range geometry {t['ms']:.4f} ms{dev} — "
        f"{card}")
    return t


def sort_routes(name: str, kind: str, out: torch.Tensor, card: str,
                warp) -> dict:
    """The forced warp route of ``name`` (``warp()``, the pre-register
    design) held bit for bit to the default route's ``out`` and timed by
    CUDA events and as device time; prints one line and returns its
    ``warp_`` keys (``mad_warp_`` for mad)."""
    got = warp()
    if not torch.equal(got.view(torch.int32), out.view(torch.int32)):
        raise AssertionError(f"{name} {kind}: the warp route differs from "
                             f"the register route")
    ms = time_ms(warp)
    gms = graph_ms(warp)
    log(f"kernel {name}[{kind}, warp route]: {ms:.4f} ms, device time "
        f"{gms:.4f} ms, equal bit for bit — {card}")
    pre = "warp" if kind == "quantile" else f"{kind}_warp"
    return {f"{pre}_ms": ms, f"{pre}_graph_ms": gms}


def select_route_checks(sk, device) -> int:
    """segment_select against its plain version at its route boundaries:
    groups of 0, 1, 2, 31, 32 (a thread a group and step), 33 and 1,024 (a
    warp sort), 1,025 and more (the radix select; two large groups in one
    1,024-position chunk, 40 steps in two slices), rows shuffled within
    the groups, NaN, +-inf, +-0.0 and ties, an all-NaN step and R = 32
    rank sets with ranks clamped at both ends.  Exact."""
    cases = (([0, 1, 2, 31, 32, 0, 33, 1024, 1025, 3, 2100], 5, 32),
             ([700, 1025, 1, 2047, 10, 1500], 40, 2),
             ([70_000], 3, 1))
    for k, (sizes, T, R) in enumerate(cases):
        rng = np.random.default_rng(100 + k)
        sizes = np.asarray(sizes, np.int64)
        S, ng = int(sizes.sum()), len(sizes)
        v = rng.normal(0, 100, (S, T)).astype(np.float32)
        for frac, x in ((0.1, np.nan), (0.03, np.inf), (0.03, -np.inf),
                        (0.03, 0.0), (0.03, -0.0), (0.05, 7.0)):
            v[rng.random((S, T)) < frac] = x
        v[:, T - 1] = np.nan
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        order = rng.permutation(S).astype(np.int32)
        ranks = rng.integers(-2, np.maximum(sizes, 1)[:, None] + 2,
                             (R, ng, T)).astype(np.int32)
        args = [torch.from_numpy(a).to(device)
                for a in (v, order, offsets, ranks)]
        max_err(sk.segment_select(*args), sk.segment_select_plain(*args),
                exact=True)
    return len(cases)


def phase_promql_kernels(gk, pk, sk, db, card: str) -> dict:
    """Each PromQL kernel on the PromQL path's resident table (its real
    shapes and data) against its plain version, and group_merge at the
    path's shape (the K12 group sum)."""
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import parse_promql
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

    # -- sort_layout (K8): the resident table takes the presorted route;
    #    the general route on a seeded permutation of the same columns --
    pk.reset_launch_counts()
    got = pk.sort_layout(ts, val, tsid, mask)
    if pk.sort_layout.presorted != 1:
        raise AssertionError("sort_layout: the resident table did not take "
                             "the presorted route")
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
    report("sort_layout", f"N={n:,} rows, presorted route (one partition "
           f"pass after the scan)", ms, plain, bnd, by, lib, err)
    results["sort_layout"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=lib,
                                  max_abs_err=err)
    del key, valid
    gen = torch.Generator(device=ts.device)
    gen.manual_seed(11)
    perm = torch.randperm(n, device=ts.device, generator=gen)
    pcols = [c.index_select(0, perm) for c in (ts, val, tsid, mask)]
    del perm
    gen_out = pk.sort_layout(*pcols)
    if pk.sort_layout.general != 1:
        raise AssertionError("sort_layout: the permuted table did not take "
                             "the general route")
    gen_want = pk.sort_layout_plain(*pcols)
    gen_err = max(max_err(g, w, exact=True) for g, w in zip(gen_out, gen_want))
    del gen_out, gen_want
    gen_ms = time_ms(lambda: pk.sort_layout(*pcols), reps=5)
    passes, per, split = pass_split(lambda: pk.sort_layout(*pcols),
                                    "radix_scatter")
    log(f"kernel sort_layout[general route: N={n:,} rows permuted (seed "
        f"11), {passes} digit pass(es) profiled, "
        f"{per if per is None else round(per, 4)} ms a pass; one call by "
        f"kernel: {split}]: {gen_ms:.4f} ms, max_abs_err {gen_err:.3g} — "
        f"{card}")
    results["sort_layout"]["max_abs_err"] = max(err, gen_err)
    results["sort_layout"]["general_ms"] = gen_ms
    results["sort_layout"]["general_passes"] = passes
    results["sort_layout"]["general_pass_ms"] = per
    del pcols
    # -- prefix_scan (the reference's f64 cumsum of counter drops, with the
    #    drop prologue; off the query path since counter_window sums its
    #    windows' drops): two calls equal bit for bit --
    key_s, ts_s, val_s, tsid_s, valid_s, ts_min, kp = got
    gd = pk.prefix_scan(val_s, tsid_s, valid_s)
    if not torch.equal(gd.view(torch.int64),
                       pk.prefix_scan(val_s, tsid_s, valid_s).view(
                           torch.int64)):
        raise AssertionError("prefix_scan: two calls differ")
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
    report("prefix_scan", f"f64 counter drops N={n:,}, one single-pass "
           f"launch, two calls equal bit for bit, off the query path; "
           f"library: torch.cumsum of the f64 drops", ms, plain, bnd, by,
           lib, err)
    results["prefix_scan"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=lib,
                                  max_abs_err=err, on_path=False)
    del drops, gd, gd_want

    # -- series_offsets (K9's range geometry: each tsid's first sorted row,
    #    built once a layout) --
    n_series = table.num_series
    off = pk.series_offsets(key_s, kp, n_series)
    err = max_err(off, pk.series_offsets_plain(want[0], want[6], n_series),
                  exact=True)
    ms = time_ms(lambda: pk.series_offsets(key_s, kp, n_series))
    gms = graph_ms(lambda: pk.series_offsets(key_s, kp, n_series))
    plain = time_ms(lambda: pk.series_offsets_plain(want[0], want[6],
                                                    n_series))
    first_keys = torch.arange(n_series + 1, device=ts.device) * kp
    lib = time_ms(lambda: torch.searchsorted(key_s, first_keys))
    del first_keys
    # the table written once; a search of log2(n) int64 compares an entry
    bnd, by = bound_ms(nbytes(off), (n_series + 1) * n.bit_length())
    report("series_offsets", f"{n_series + 2:,} entries over N={n:,} keys, "
           f"once a layout, equal to torch.searchsorted (library: "
           f"torch.searchsorted of the tsids' first keys)", ms, plain, bnd,
           by, lib, err)
    log(f"kernel series_offsets: device time {gms:.4f} ms — {card}")
    results["series_offsets"] = dict(ms=ms, graph_ms=gms, plain_ms=plain,
                                     bound_ms=bnd, bound_by=by,
                                     library_ms=lib, max_abs_err=err)
    lay = (*got, off)

    # -- counter_window (K10 + the K11 epilogue) in the range geometry,
    #    beside the forced whole-layout search --
    s_pad = 1 << (PROM_SERIES - 1).bit_length()
    sel = torch.full((s_pad,), -1, dtype=torch.int32, device=ts.device)
    sel[:PROM_SERIES] = torch.arange(PROM_SERIES, dtype=torch.int32,
                                     device=ts.device)
    t_end = int(ts_s[valid_s].max())
    start = t_end - 19 * SCRAPE_MS
    # the selected series' two offset-table entries, and the selection
    sel_b = nbytes(sel) + PROM_SERIES * 8
    for variant, steps, kind, func in (("rate", 20, "rate", "rate"),
                                       ("counter stats", 20, "counter", None),
                                       ("instant", 1, "instant", None)):
        t0_ms = t_end if steps == 1 else start
        kw = dict(step_ms=SCRAPE_MS, num_steps=steps, range_ms=RANGE_MS,
                  kind=kind, func=func,
                  range_s=RANGE_MS / 1000 if func else None)

        def run(geometry, t0_ms=t0_ms, kw=kw):
            return pk.counter_window(lay, sel, t0_ms, geometry=geometry, **kw)

        out = run("range")
        ref = pk.counter_window_plain(want, sel, t0_ms, **kw)
        if kind == "rate":
            err = max_err(out, ref, exact=False)
        else:
            err = max(max_err(out[k], ref[k], exact=k != "delta_adj")
                      for k in pk.KIND_KEYS[kind])
        del ref
        geo_t = range_timing("counter_window", variant, run, card)
        plain = time_ms(lambda: pk.counter_window_plain(want, sel, t0_ms,
                                                        **kw), reps=5)
        steps_t = t0_ms + SCRAPE_MS * torch.arange(steps, device=ts.device)
        skey = sel.clamp(min=0).long()[:, None] * kp
        lo_keys = (skey + (steps_t - RANGE_MS + 1 - ts_min).clamp(
            min=0)).reshape(-1)
        hi_keys = (skey + (steps_t - ts_min)).reshape(-1)
        lib = time_ms(lambda: (torch.searchsorted(key_s, lo_keys),
                               torch.searchsorted(key_s, hi_keys,
                                                  right=True)))
        del skey, lo_keys, hi_keys
        cells = s_pad * steps
        # what the function needs, whatever computes it: the covered rows'
        # values once (rate and counter read every row for the drops,
        # instant only the last), the timestamps of the distinct first and
        # last rows, the selection and its offsets, the outputs once, and
        # the f64 work (~30 operations of the epilogue a window, 2 a
        # sample for the drops)
        lo, hi, wcnt, has, sel_ok = pk.window_bounds_plain(
            key_s, ts_min, kp, sel, t0_ms, SCRAPE_MS, steps, RANGE_MS)
        samples = int(wcnt[has].sum())
        union = int(torch.where(sel_ok, hi[:, -1] - lo[:, 0], 0).clamp(
            min=0).sum())
        last_rows = (hi - 1)[has]
        ends = last_rows if kind == "instant" else torch.cat([lo[has],
                                                              last_rows])
        ts_rows = int(torch.unique(ends).numel())
        val_rows = ts_rows if kind == "instant" else union
        del lo, hi, has, last_rows, ends
        out_b = {"rate": 4, "counter": 4 * 5 + 8 * 2, "instant": 4 + 4 + 8}
        ops = {"rate": cells * 30 + samples * 2, "counter": samples * 2,
               "instant": 0}[kind]
        bnd, by = bound_ms(sel_b + val_rows * 4 + ts_rows * 8
                           + cells * out_b[kind], ops, F64_FLOPS)
        # the search route's bound (PR 10-14): two binary searches of
        # log2(n) int64 compares a window counted as operations
        per_cell = {"rate": 8 * 2 + 4 * 2 + 8 * 2 + 4,
                    "counter": 8 * 2 + 4 * 2 + 8 * 2 + 4 * 5 + 8 * 2,
                    "instant": 8 + 4 + 4 + 4 + 8}[kind]
        old_bnd, _old_by = bound_ms(
            nbytes(sel) + cells * per_cell,
            cells * (2 * n.bit_length() + (30 if kind == "rate" else 0)),
            F64_FLOPS)
        report("counter_window", f"{variant} S={s_pad:,} T={steps}, range "
               f"geometry, {samples:,} window samples (device "
               f"{geo_t['graph_ms']:.4f} ms; search route's bound "
               f"{old_bnd:.4f} ms; library: searchsorted geometry only)",
               geo_t["ms"], plain, bnd, by, lib, err)
        if kind == "rate":
            results["counter_window"] = dict(
                ms=geo_t["ms"], graph_ms=geo_t["graph_ms"], plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib, max_abs_err=err,
                search_bound_ms=old_bnd)
        else:
            results["counter_window"]["max_abs_err"] = max(
                results["counter_window"]["max_abs_err"], err)
            results["counter_window"].update({
                f"{kind}_{k}": v for k, v in geo_t.items()})
            results["counter_window"].update({
                f"{kind}_plain_ms": plain, f"{kind}_bound_ms": bnd,
                f"{kind}_search_bound_ms": old_bnd})
        del out

    results.update(count_geometry_timing(pk, lay, want, sel, t_end, report))
    results["counter_window"].update(results.pop("t1"))

    # -- window_stats (K10's gauge_window, counter_rc, regression, irate)
    #    in the range geometry, beside the forced whole-layout search --
    geo = dict(step_ms=SCRAPE_MS, num_steps=20, range_ms=RANGE_MS)
    cells = s_pad * 20
    lo, hi, wcnt, _has, sel_ok = pk.window_bounds_plain(
        key_s, ts_min, kp, sel, start, SCRAPE_MS, 20, RANGE_MS)
    # the rows the 20 overlapping windows of a series cover, each once
    union = int(torch.where(sel_ok, hi[:, -1] - lo[:, 0], 0).sum())
    samples = int(wcnt[sel_ok].sum())
    del lo, hi
    exact_keys = ("count", "first_ts", "last_ts", "last", "first", "resets",
                  "changes", "prev_ts", "last_val", "prev_val")
    # bytes per covered row (val, and ts where read) and per window output
    row_b = {"gauge_window": 12, "counter_rc": 4, "regression": 12,
             "irate": 12}
    out_b = {"gauge_window": 4 * 6 + 8 * 2, "counter_rc": 12,
             "regression": 12 + 8, "irate": 8 * 2 + 4 * 2}
    # f64 operations per window sample
    per_sample = {"gauge_window": 3, "counter_rc": 2, "regression": 8,
                  "irate": 0}
    lib = time_ms(lambda: torch.cumsum(val_s.double(), 0))
    for kind in ("gauge_window", "counter_rc", "regression", "irate"):

        def run(geometry, kind=kind):
            return pk.window_stats(lay, sel, start, kind=kind,
                                   geometry=geometry, **geo)

        out = run("range")
        ref = pk.window_stats_plain(kind, want, sel, start, **geo)
        slack = pk.var_slack(val_s, valid_s, wcnt, ref["sum"]) \
            if kind == "gauge_window" else 0.0
        # the kernel sums each window directly, the plain version by
        # differences of table-wide f64 prefix sums: the golden bound, and
        # for var the prefix sums' own rounding on top (see var_slack)
        err = max(max_err(out[k], ref[k], exact=k in exact_keys,
                          abs_tol=slack if k == "var" else 0.0)
                  for k in pk.KIND_KEYS[kind])
        del ref, slack
        geo_t = range_timing("window_stats", kind, run, card)
        plain = time_ms(lambda: pk.window_stats_plain(kind, want, sel, start,
                                                      **geo), reps=5)
        bnd, by = bound_ms(sel_b + union * row_b[kind] + cells * out_b[kind],
                           samples * per_sample[kind], F64_FLOPS)
        old_bnd, _old_by = bound_ms(
            nbytes(sel) + union * row_b[kind] + cells * out_b[kind],
            cells * 2 * n.bit_length() + samples * per_sample[kind],
            F64_FLOPS)
        report("window_stats", f"{kind} S={s_pad:,} T=20, range geometry, "
               f"{samples:,} window samples (device "
               f"{geo_t['graph_ms']:.4f} ms; search route's bound "
               f"{old_bnd:.4f} ms; library: one f64 torch.cumsum of val_s)",
               geo_t["ms"], plain, bnd, by, lib, err)
        if kind == "gauge_window":
            results["window_stats"] = dict(
                ms=geo_t["ms"], graph_ms=geo_t["graph_ms"], plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib, max_abs_err=err,
                search_bound_ms=old_bnd)
        else:
            results["window_stats"]["max_abs_err"] = max(
                results["window_stats"]["max_abs_err"], err)
            results["window_stats"].update({
                f"{kind}_{k}": v for k, v in geo_t.items()})
            results["window_stats"].update({
                f"{kind}_plain_ms": plain, f"{kind}_bound_ms": bnd,
                f"{kind}_search_bound_ms": old_bnd})
        del out

    # -- minmax_window (K13), both geometries --
    def run_minmax(geometry):
        return pk.minmax_window(lay, sel, start, geometry=geometry, **geo)

    out = run_minmax("range")
    ref = pk.minmax_window_plain(want, sel, start, **geo)
    err = max(max_err(out[k], ref[k], exact=True) for k in ("min", "max"))
    del ref
    geo_t = range_timing("minmax_window", "min+max", run_minmax, card)
    plain = time_ms(lambda: pk.minmax_window_plain(want, sel, start, **geo),
                    reps=5)
    # library: one scatter_reduce of every window sample into its window
    lo, _hi, wcnt, has, _ok = pk.window_bounds_plain(
        key_s, ts_min, kp, sel, start, SCRAPE_MS, 20, RANGE_MS)
    width = int(wcnt.max())
    j = torch.arange(width, device=ts.device)
    take = (j < wcnt.reshape(-1, 1)) & has.reshape(-1, 1)
    win_id = torch.arange(cells, device=ts.device)[:, None].expand(
        cells, width)[take]
    win_val = val_s[(lo.reshape(-1, 1) + j)[take]]
    del lo, _hi, take
    lib_buf = torch.empty(cells, device=ts.device)

    def lib_minmax():
        lib_buf.fill_(float("inf"))
        return lib_buf.scatter_reduce_(0, win_id, win_val, "amin")

    lib = time_ms(lib_minmax)
    del win_id, win_val, lib_buf
    bnd, by = bound_ms(nbytes(sel) + union * 4 + cells * 8, samples * 2)
    report("minmax_window", f"min+max S={s_pad:,} T=20, range geometry "
           f"(library: scatter_reduce amin of the gathered window "
           f"samples)", geo_t["ms"], plain, bnd,
           by, lib, err)
    results["minmax_window"] = dict(
        ms=geo_t["ms"], graph_ms=geo_t["graph_ms"], plain_ms=plain,
        bound_ms=bnd, bound_by=by, library_ms=lib, max_abs_err=err)
    del out

    # -- window_count_max + window_matrix (K14), both geometries --
    def run_cm(geometry):
        return pk.window_count_max(lay, sel, start, geometry=geometry, **geo)

    cm = run_cm("range")
    cm_plain = pk.window_count_max_plain(want, sel, start, **geo)
    if cm != cm_plain:
        raise AssertionError(f"window_count_max: {cm} vs {cm_plain}")
    # its result is read on the host: events only
    geo_t = range_timing("window_count_max", f"-> {cm}", run_cm, card,
                         graph=False)
    plain = time_ms(lambda: pk.window_count_max_plain(want, sel, start,
                                                      **geo), reps=5)
    skey = sel.clamp(min=0).long()[:, None] * kp
    steps_t = start + SCRAPE_MS * torch.arange(20, device=ts.device)
    lo_keys = (skey + (steps_t - RANGE_MS + 1 - ts_min).clamp(
        min=0)).reshape(-1)
    hi_keys = (skey + (steps_t - ts_min)).reshape(-1)
    lib = time_ms(lambda: (torch.searchsorted(key_s, lo_keys),
                           torch.searchsorted(key_s, hi_keys, right=True)))
    del skey, lo_keys, hi_keys
    bnd, by = bound_ms(nbytes(sel) + 4, cells * 2 * n.bit_length(),
                       F64_FLOPS)
    report("window_count_max", f"S={s_pad:,} T=20 -> {cm}, range geometry "
           f"(library: searchsorted geometry)", geo_t["ms"], plain, bnd,
           by, lib, 0.0)
    results["window_count_max"] = dict(
        ms=geo_t["ms"], plain_ms=plain, bound_ms=bnd, bound_by=by,
        library_ms=lib, max_abs_err=0.0)
    lmax = max(2, 1 << (max(cm, 1) - 1).bit_length())
    lo, _hi, wcnt, _has, _ok = pk.window_bounds_plain(
        key_s, ts_min, kp, sel, start, SCRAPE_MS, 20, RANGE_MS)
    j = torch.arange(lmax, device=ts.device)
    mat = torch.where(j < wcnt.reshape(-1, 1),
                      val_s[(lo.reshape(-1, 1) + j).clamp(max=n - 1)],
                      float("inf"))
    del lo, _hi
    lib = time_ms(lambda: torch.sort(mat, dim=1), reps=5)
    del mat
    ones = torch.ones(20, device=ts.device)
    params = {"quantile": (ones * 0.9, ones), "mad": (ones, ones),
              "holt": (ones * 0.5, ones * 0.3)}
    sort_ops = cells * (lmax // 2) * (lmax.bit_length() - 1) * \
        lmax.bit_length() // 2
    route = pk.matrix_route(lmax)
    for kind, (a1, a2) in params.items():
        kw = dict(lmax=lmax, kind=kind, a1=a1, a2=a2, **geo)
        before = pk.window_matrix.register
        out = pk.window_matrix(lay, sel, start, **kw)
        if kind != "holt" and pk.window_matrix.register != before + (
                route == "register"):
            raise AssertionError(f"window_matrix {kind}: lmax {lmax} did "
                                 f"not take the {route} route")
        ref = pk.window_matrix_plain(want, sel, start, **kw)
        err = max_err(out, ref, exact=False)
        del ref
        torch.cuda.empty_cache()
        ms = time_ms(lambda: pk.window_matrix(lay, sel, start, **kw))
        gms = graph_ms(lambda: pk.window_matrix(lay, sel, start, **kw))
        plain = time_ms(lambda: pk.window_matrix_plain(want, sel, start,
                                                       **kw), reps=3)
        torch.cuda.empty_cache()
        ops = cells * 2 * n.bit_length() + (
            sort_ops * (2 if kind == "mad" else 1) if kind != "holt"
            else samples * 6)
        bnd, by = bound_ms(nbytes(sel, a1, a2, out) + union * 4, ops)
        report("window_matrix", f"{kind} S={s_pad:,} T=20 lmax={lmax}, "
               f"{route if kind != 'holt' else 'a thread a window'}, range "
               f"geometry (library: torch.sort of the gathered [S*T, lmax] "
               f"matrix)", ms, plain, bnd, by, lib, err)
        log(f"kernel window_matrix[{kind}]: device time {gms:.4f} ms — "
            f"{card}")
        if kind == "quantile":
            results["window_matrix"] = dict(
                ms=ms, graph_ms=gms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, max_abs_err=err)
        else:
            results["window_matrix"]["max_abs_err"] = max(
                results["window_matrix"]["max_abs_err"], err)
            results["window_matrix"].update({
                f"{kind}_ms": ms, f"{kind}_graph_ms": gms,
                f"{kind}_plain_ms": plain, f"{kind}_bound_ms": bnd})
        if kind != "holt":
            results["window_matrix"].update(sort_routes(
                "window_matrix", kind, out, card,
                lambda: pk.window_matrix(lay, sel, start,
                                         allow_register=False, **kw)))
        del out

    # -- window_matrix_dense + subquery_counter on the subquery path's
    #    [S, T, K] window matrices (the engine's own _subquery_matrix) --
    ev = PromEvaluator(db, start / 1000.0, (start + 19 * SCRAPE_MS) / 1000.0,
                       15.0)
    win, m, _ts_tk, _steps, _lab = ev._subquery_matrix(parse_promql(
        "rate(http_requests_total[1m])[5m:1m]"))
    wq = torch.where(m, win, float("nan")).to(torch.float32).contiguous()
    del win, m
    S_sub, T_sub, K_sub = wq.shape
    q = torch.full((T_sub,), 0.9, device=ts.device)
    width = 1 << max(K_sub - 1, 1).bit_length()
    sort_ops = S_sub * T_sub * (width // 2) * (width.bit_length() - 1) * \
        width.bit_length() // 2
    lib = time_ms(lambda: torch.sort(wq, dim=-1), reps=5)
    route = pk.matrix_route(width)
    for kind in ("quantile", "mad"):
        before = pk.window_matrix_dense.register
        out = pk.window_matrix_dense(wq, kind, q)
        if pk.window_matrix_dense.register != before + (route == "register"):
            raise AssertionError(f"window_matrix_dense {kind}: width {width} "
                                 f"did not take the {route} route")
        err = max_err(out, pk.window_matrix_dense_plain(wq, kind, q),
                      exact=False)
        ms = time_ms(lambda: pk.window_matrix_dense(wq, kind, q))
        gms = graph_ms(lambda: pk.window_matrix_dense(wq, kind, q))
        plain = time_ms(lambda: pk.window_matrix_dense_plain(wq, kind, q),
                        reps=5)
        bnd, by = bound_ms(nbytes(wq, q, out),
                           sort_ops * (2 if kind == "mad" else 1))
        report("window_matrix_dense", f"{kind} [S, T, K] = [{S_sub:,}, "
               f"{T_sub}, {K_sub}] of rate(m[1m])[5m:1m], {route} (library: "
               f"torch.sort along K)", ms, plain, bnd, by, lib, err)
        log(f"kernel window_matrix_dense[{kind}]: device time {gms:.4f} ms "
            f"— {card}")
        if kind == "quantile":
            results["window_matrix_dense"] = dict(
                ms=ms, graph_ms=gms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, max_abs_err=err)
        else:
            results["window_matrix_dense"]["max_abs_err"] = max(
                results["window_matrix_dense"]["max_abs_err"], err)
            results["window_matrix_dense"].update({
                f"{kind}_ms": ms, f"{kind}_graph_ms": gms,
                f"{kind}_plain_ms": plain, f"{kind}_bound_ms": bnd})
        results["window_matrix_dense"].update(sort_routes(
            "window_matrix_dense", kind, out, card,
            lambda: pk.window_matrix_dense(wq, kind, q,
                                           allow_register=False)))
        del out
    del wq
    win, m, ts_tk, steps_np, _lab = ev._subquery_matrix(parse_promql(
        "http_requests_total[5m:1m]"))
    wr = torch.where(m, win, float("nan")).to(torch.float32).contiguous()
    del win, m
    ts_tk = torch.as_tensor(ts_tk, device=ts.device)
    steps_t = torch.as_tensor(steps_np, device=ts.device)
    rkw = dict(kind="rate", func="rate", range_s=RANGE_MS / 1000)
    out = pk.subquery_counter(wr, ts_tk, steps_t, **rkw)
    err = max_err(out, pk.subquery_counter_plain(wr, ts_tk, steps_t, **rkw),
                  exact=False)
    pair = pk.subquery_counter(wr, ts_tk, steps_t, kind="pair")
    pair_want = pk.subquery_counter_plain(wr, ts_tk, steps_t, kind="pair")
    for k in pair:
        max_err(pair[k], pair_want[k], exact=True)
    del pair, pair_want
    ms = time_ms(lambda: pk.subquery_counter(wr, ts_tk, steps_t, **rkw))
    plain = time_ms(lambda: pk.subquery_counter_plain(wr, ts_tk, steps_t,
                                                      **rkw), reps=5)
    S_sub, T_sub, K_sub = wr.shape
    # one pass over K samples, then the f64 epilogue (~30 operations)
    bnd, by = bound_ms(nbytes(wr, ts_tk, steps_t, out),
                       S_sub * T_sub * (2 * K_sub + 30), F64_FLOPS)
    report("subquery_counter", f"rate [S, T, K] = [{S_sub:,}, {T_sub}, "
           f"{K_sub}] of m[5m:1m] (pair mode exact; library: none)", ms,
           plain, bnd, by, None, err)
    results["subquery_counter"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                       bound_by=by, library_ms=None,
                                       max_abs_err=err)
    del wr, out

    # -- segment_select (K12's sorts) on the 20-step rates --
    rate = pk.counter_window(lay, sel, start, step_ms=SCRAPE_MS,
                             num_steps=20, range_ms=RANGE_MS, kind="rate",
                             func="rate", range_s=RANGE_MS / 1000)
    rate = rate[:PROM_SERIES].contiguous()
    work = torch.where(torch.isnan(rate), float("-inf"), rate)
    order = torch.arange(PROM_SERIES, dtype=torch.int32, device=ts.device)
    one = torch.tensor([0, PROM_SERIES], dtype=torch.int64, device=ts.device)
    ranks = torch.full((1, 1, 20), PROM_SERIES - 5, dtype=torch.int32,
                       device=ts.device)
    out = sk.segment_select(work, order, one, ranks)
    err = max_err(out, sk.segment_select_plain(work, order, one, ranks),
                  exact=True)
    ms = time_ms(lambda: sk.segment_select(work, order, one, ranks))
    plain = time_ms(lambda: sk.segment_select_plain(work, order, one, ranks),
                    reps=5)
    lib = time_ms(lambda: torch.topk(work, 5, dim=0))
    bnd, by = bound_ms(nbytes(work, order, one, ranks, out), 0)
    report("segment_select", f"topk: 5th largest of {PROM_SERIES:,} rates "
           f"x 20 steps, ng = 1 (library: torch.topk)", ms, plain, bnd, by,
           lib, err)
    results["segment_select"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                     bound_by=by, library_ms=lib,
                                     max_abs_err=err)
    offs = torch.arange(0, PROM_SERIES + 1, CONTAINERS, dtype=torch.int64,
                        device=ts.device)
    cnt = (~torch.isnan(rate)).reshape(PODS, CONTAINERS, 20).sum(1)
    rank = 0.99 * torch.clamp(cnt.float() - 1, min=0)
    ranks = torch.stack([torch.floor(rank), torch.ceil(rank)]).to(
        torch.int32)
    out = sk.segment_select(rate, order, offs, ranks)
    err = max_err(out, sk.segment_select_plain(rate, order, offs, ranks),
                  exact=True)
    ms = time_ms(lambda: sk.segment_select(rate, order, offs, ranks))
    plain = time_ms(lambda: sk.segment_select_plain(rate, order, offs,
                                                    ranks), reps=5)
    lib = time_ms(lambda: torch.sort(rate.view(PODS, CONTAINERS, 20), 1))
    bnd, by = bound_ms(nbytes(rate, order, offs, ranks, out), 0)
    report("segment_select", f"quantile by pod: 2 ranks of {PODS:,} groups "
           f"of 10 x 20 steps (library: torch.sort)", ms, plain, bnd, by,
           lib, err)
    results["segment_select"].update(
        max_abs_err=max(results["segment_select"]["max_abs_err"], err),
        quantile_ms=ms, quantile_plain_ms=plain, quantile_bound_ms=bnd,
        quantile_library_ms=lib)
    log(f"segment_select route boundaries: "
        f"{select_route_checks(sk, ts.device)} cases exact")

    # -- group_merge at the PromQL shape: the 20-step rates of 2^20
    #    selected series (padding routed to the overflow id) into 100,000
    #    pod groups; tsids follow write order, so pod = tsid // 10 --
    v = pk.counter_window(lay, sel, start, step_ms=SCRAPE_MS,
                          num_steps=20, range_ms=RANGE_MS, kind="rate",
                          func="rate", range_s=RANGE_MS / 1000)
    x = torch.where(torch.isnan(v), 0.0, v)
    ids = torch.where(sel >= 0, sel // CONTAINERS, PODS)
    lay = gk.group_layout(ids, PODS)
    out = gk.group_merge(x, lay, "sum")
    err = max_err(out, gk.group_merge_plain(x, lay, "sum"), exact=False)
    ms = time_ms(lambda: gk.group_merge(x, lay, "sum"))
    gms = graph_ms(lambda: gk.group_merge(x, lay, "sum"))
    plain = time_ms(lambda: gk.group_merge_plain(x, lay, "sum"))
    lib_buf = torch.zeros((PODS + 1, 20), device=x.device)
    ids64 = ids.long()
    lib = time_ms(lambda: lib_buf.index_add_(0, ids64, x))
    lib_g = graph_ms(lambda: lib_buf.index_add_(0, ids64, x))
    bnd, by = bound_ms(nbytes(x, lay.ids, lay.order, lay.offsets, out),
                       x.numel())
    report("group_merge", f"sum [{s_pad:,},20] -> {PODS:,} (PromQL path)",
           ms, plain, bnd, by, lib, err)
    log(f"kernel group_merge[PromQL path]: device time {gms:.4f} ms "
        f"(index_add_ {lib_g:.4f} ms) — {card}")
    results["group_merge_prom"] = dict(
        prom_ms=ms, prom_graph_ms=gms, prom_plain_ms=plain,
        prom_library_ms=lib, prom_library_graph_ms=lib_g, prom_bound_ms=bnd)
    return results


# ---------------------------------------------------------------------------
# phase 7, continued: the sketch aggregates on phase 3's table
# ---------------------------------------------------------------------------

HLL_M = 4096
UDD_NB, UDD_ERR = 128, 0.01
HLL_SE = 1.04 / math.sqrt(HLL_M)  # HLL's standard error at 4,096 registers


def _np_mix32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _np_bit_length(w: np.ndarray) -> np.ndarray:
    _m, e = np.frexp(w.astype(np.float64))
    return np.where(w > 0, e, 0).astype(np.int64)


def np_hll_hash(v: np.ndarray):
    """The hll() hash of finite f64 values in numpy uint32 arithmetic:
    (register index, rank = exact leading-zero count of h2 >> 1)."""
    vi = np.floor(v)
    k = np.clip(vi, -9.2e18, 9.2e18).astype(np.int64)
    lo = (k & 0xFFFFFFFF).astype(np.uint32)
    hi = ((k >> 32) & 0xFFFFFFFF).astype(np.uint32)
    frac = ((v - vi) * float(1 << 30)).astype(np.int64).astype(np.uint32)
    h1 = _np_mix32(lo ^ _np_mix32(hi ^ _np_mix32(frac)))
    h2 = _np_mix32((frac + np.uint32(0x9E3779B9)) ^ h1)
    return (h1 >> np.uint32(20)).astype(np.int64), 32 - _np_bit_length(
        h2 >> np.uint32(1))


def np_udd(v: np.ndarray, gamma: float, nb: int):
    """uddsketch_state per column of ``v`` [rows, groups] (f64, values
    > 0 count) as its docstring defines it: (counts [groups, nb], k_min,
    collapse c, the per-row keys and validity)."""
    ok = v > 0
    k = np.ceil(np.log(np.where(ok, v, 1.0)) / math.log(gamma)).astype(
        np.int64)
    kmin = np.where(ok, k, 1 << 30).min(0)
    kmax = np.where(ok, k, -(1 << 30)).max(0)
    need = (np.maximum(kmax - kmin + 1, 1) + 2 + nb - 1) // nb
    c = np.left_shift(1, _np_bit_length(need - 1))
    base = (kmin // c) * c
    idx = np.clip((k - base + c - 1) // c, 0, nb - 1)
    groups = np.broadcast_to(np.arange(v.shape[1]), v.shape)
    counts = np.bincount((groups * nb + idx)[ok],
                         minlength=v.shape[1] * nb).reshape(v.shape[1], nb)
    return counts, kmin, c


def phase_sketches(shk, sk, db, ctx: dict, card: str):
    """hll / uddsketch_state by hostname over all of phase 3's rows, their
    estimators, and hll_merge / uddsketch_merge of the 4,000 stored states
    by a tag; every result against numpy.  Returns (launches, context for
    the kernel timings)."""
    from greptimedb_tpu_torch.ops import sketch as sko

    user = ctx["stats"]["user"]  # [steps, SCALE] f32, as the device holds
    gamma = sko.udd_gamma(UDD_ERR)
    t0 = time.perf_counter()
    v = user.astype(np.float64)
    idx, rho = np_hll_hash(v)
    hosts = np.broadcast_to(np.arange(SCALE), v.shape)
    regs = np.zeros(SCALE * HLL_M, np.int32)
    np.maximum.at(regs, (hosts * HLL_M + idx).ravel(),
                  rho.ravel().astype(np.int32))
    regs = regs.reshape(SCALE, HLL_M)
    counts, kmin, coll = np_udd(v, gamma, UDD_NB)
    srt = np.sort(user, axis=0)
    distinct = 1 + (srt[1:] != srt[:-1]).sum(0)
    all_distinct = len(np.unique(user))
    pos = np.where(user > 0, user, np.inf).astype(np.float64)
    pos.sort(axis=0)
    npos = (user > 0).sum(0)
    log(f"sketches: numpy replica of {v.size:,} values in "
        f"{time.perf_counter() - t0:.3f} s; collapse factors "
        f"{sorted(set(coll.tolist()))}")
    del v, idx, rho, hosts, srt
    sk.reset_launch_counts()
    shk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    def host_of(row):
        return int(row[0].split("_")[1])

    def want_udd(h):
        base = (kmin[h] // coll[h]) * coll[h]
        return {int(base // coll[h] + i): int(n)
                for i, n in enumerate(counts[h]) if n}

    states = {}

    def check_states(res):
        if len(res.rows) != SCALE:
            raise AssertionError(f"sketch states: {len(res.rows)} rows")
        for row in res.rows:
            h = host_of(row)
            got = sko.decode_hll(row[1])
            if got is None or not np.array_equal(got, regs[h]):
                raise AssertionError(f"hll registers of host {h} differ")
            dec = sko.decode_udd(row[2])
            if dec is None or dec[2] != int(coll[h]) or dec[3] != UDD_NB \
                    or dec[4] != want_udd(h):
                raise AssertionError(f"uddsketch state of host {h} differs")
            states[h] = (row[1], row[2])
        return (f"registers and bucket counts exact for {SCALE:,} hosts "
                f"(collapse {sorted(set(coll.tolist()))})")

    report = {}
    q_states = (f"SELECT hostname, hll(usage_user), uddsketch_state("
                f"{UDD_NB}, {UDD_ERR}, usage_user) FROM cpu GROUP BY hostname")
    report["states"] = timed_query(db, q_states, card,
                                   "sketch hll + uddsketch_state",
                                   check_states)
    q = 0.5

    def check_estimates(res):
        rel = np.zeros(SCALE)
        worst_q = 0.0
        for row in res.rows:
            h = host_of(row)
            rel[h] = abs(row[1] - distinct[h]) / distinct[h]
            g_eff = gamma ** int(coll[h])
            alpha = (g_eff - 1) / (g_eff + 1)
            x = pos[int(math.floor(q * (npos[h] - 1))), h]
            err = abs(row[2] - x) / x
            if err > alpha * (1 + 1e-9):
                raise AssertionError(f"uddsketch_calc host {h}: {row[2]} vs "
                                     f"{x} (alpha {alpha})")
            worst_q = max(worst_q, err)
        within = float((rel <= 3 * HLL_SE).mean())
        if len(res.rows) != SCALE or within < 0.99:
            raise AssertionError(f"hll_count: {within:.4f} of hosts within "
                                 f"3 x {HLL_SE:.4f}")
        return (f"hll_count within 3 x {HLL_SE:.4f} of the exact distinct "
                f"count for {100 * within:.2f} % of hosts (mean |rel err| "
                f"{rel.mean():.4f}, max {rel.max():.4f}); uddsketch_calc("
                f"{q}) within its relative error bound, worst {worst_q:.4f}")

    q_est = (f"SELECT hostname, hll_count(hll(usage_user)), uddsketch_calc("
             f"{q}, uddsketch_state({UDD_NB}, {UDD_ERR}, usage_user)) FROM "
             f"cpu GROUP BY hostname")
    report["estimates"] = timed_query(db, q_est, card,
                                      "sketch hll_count + uddsketch_calc",
                                      check_estimates)

    def check_global(res):
        got = res.rows[0][0]
        rel = abs(got - all_distinct) / all_distinct
        if rel > 3 * HLL_SE:
            raise AssertionError(f"global hll_count {got} vs {all_distinct}")
        return f"{got:,} vs {all_distinct:,} distinct (rel err {rel:.4f})"

    report["global"] = timed_query(
        db, "SELECT hll_count(hll(usage_user)) FROM cpu", card,
        "sketch global hll_count", check_global)

    # the 4,000 states stored in a table, merged by a tag: the first digit
    # of the host number
    db.sql("CREATE TABLE cpu_states (hostname STRING, grp STRING, "
           "ts TIMESTAMP(3) TIME INDEX, hs STRING, us STRING, "
           "PRIMARY KEY (hostname, grp))")
    names = [f"host_{h}" for h in range(SCALE)]
    grp = [n[:6] for n in names]
    db._region_of("cpu_states").write({
        "hostname": np.array(names, dtype=object),
        "grp": np.array(grp, dtype=object),
        "ts": np.full(SCALE, T0, np.int64),
        "hs": np.array([states[h][0] for h in range(SCALE)], dtype=object),
        "us": np.array([states[h][1] for h in range(SCALE)], dtype=object)})
    c_star = int(coll.max())
    lo_hi = [((min(want_udd(h)) - 1) * coll[h] + 1, max(want_udd(h))
              * coll[h]) for h in range(SCALE) if want_udd(h)]
    span = max(b for _a, b in lo_hi) - min(a for a, _b in lo_hi) + 1
    while span / c_star > 4096:
        c_star *= 2
    members: dict[str, list[int]] = {}
    for h, g in enumerate(grp):
        members.setdefault(g, []).append(h)

    def check_merges(res):
        if len(res.rows) != len(members):
            raise AssertionError(f"merges: {len(res.rows)} groups")
        for g, hs, us in res.rows:
            mine = members[g]
            if not np.array_equal(sko.decode_hll(hs), regs[mine].max(0)):
                raise AssertionError(f"hll_merge of {g} differs")
            want: dict[int, int] = {}
            for h in mine:
                for key, n in want_udd(h).items():
                    kk = -((-key * int(coll[h])) // c_star)
                    want[kk] = want.get(kk, 0) + n
            dec = sko.decode_udd(us)
            if dec is None or dec[2] != c_star or dec[4] != want:
                raise AssertionError(f"uddsketch_merge of {g} differs")
        return (f"{len(members)} groups: registers the max and counts the "
                f"re-keyed sums (collapse {c_star}) of their hosts' states")

    report["merges"] = timed_query(
        db, "SELECT grp, hll_merge(hs), uddsketch_merge(us) FROM cpu_states "
            "GROUP BY grp", card, "sketch hll_merge + uddsketch_merge",
        check_merges)
    take_shapes("segment_reduce", sk.segment_reduce)
    launches = {"hll_fold": shk.hll_fold.launches,
                "udd_fold": shk.udd_fold.launches,
                "segment_reduce": sk.segment_reduce.launches,
                "sorted_segment_reduce": sk.sorted_segment_reduce.launches,
                "compact": sk.compact.launches}
    log(f"sketches: launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    for kname in ("hll_fold", "udd_fold"):
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} never launched on the sketch path")
    groups = sorted(members)
    gid_of = {g: i for i, g in enumerate(groups)}
    return launches, dict(regs=regs, counts=counts,
                          grp=np.array([gid_of[g] for g in grp], np.int32),
                          ngrp=len(groups))


def phase_sketch_kernels(shk, db, sctx: dict, card: str) -> dict:
    """hll_fold (fold and merge modes) and udd_fold on phase 3's resident
    usage_user column with the row path's hostname ids and row mask, and
    the merge modes on the stored states, against their plain versions and
    one library call."""
    from greptimedb_tpu_torch.ops import sketch as sko

    table = db.cache.get(db._region_of("cpu"))
    vals = table.columns["usage_user"]
    gid = table.columns["hostname"].to(torch.int32)
    mask = table.row_mask
    n = mask.shape[0]
    ng = 1 << (SCALE - 1).bit_length()
    results = {}

    def report(name, variant, ms, plain, bound, by, lib, err):
        lib_s = "null" if lib is None else f"{lib:.4f}"
        log(f"kernel {name}[{variant}]: {ms:.4f} ms (plain {plain:.4f} ms, "
            f"library {lib_s} ms, bound {bound:.4f} ms by {by}), "
            f"max_abs_err {err:.3g} — {card}")

    # -- hll_fold, fold mode --
    got = shk.hll_fold(vals, gid, ng, mask)
    want = shk.hll_fold_plain(vals, gid, ng, mask)
    err = max_err(got, want, exact=True)
    ms = time_ms(lambda: shk.hll_fold(vals, gid, ng, mask))
    plain = time_ms(lambda: shk.hll_fold_plain(vals, gid, ng, mask), reps=5)
    idx, rho, ok = shk.hll_hash_plain(vals)
    live = ok & mask & (gid >= 0) & (gid < ng)
    cells = torch.where(live, gid.long() * HLL_M + idx, ng * HLL_M)
    rho32 = torch.where(live, rho, 0).to(torch.int32)
    buf = torch.zeros(ng * HLL_M + 1, dtype=torch.int32, device=vals.device)
    lib = time_ms(lambda: buf.scatter_reduce_(0, cells, rho32, "amax"))
    bnd, by = bound_ms(nbytes(vals, gid, mask, got), n * 30)
    report("hll_fold", f"fold [{n:,}] f32 -> [{ng:,},{HLL_M}]", ms, plain,
           bnd, by, lib, err)
    results["hll_fold"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                               bound_by=by, library_ms=lib, max_abs_err=err)
    del idx, rho, ok, live, cells, rho32, buf
    # -- hll_fold, merge mode: the stored states by group --
    vocab = torch.from_numpy(sctx["regs"]).cuda()
    codes = torch.arange(SCALE, dtype=torch.int32, device=vocab.device)
    g2 = torch.from_numpy(sctx["grp"]).cuda()
    m2 = torch.ones(SCALE, dtype=torch.bool, device=vocab.device)
    ng2 = sctx["ngrp"]
    got = shk.hll_merge(codes, vocab, g2, ng2, m2)
    want = shk.hll_merge_plain(codes, vocab, g2, ng2, m2)
    merr = max_err(got, want, exact=True)
    mms = time_ms(lambda: shk.hll_merge(codes, vocab, g2, ng2, m2))
    mplain = time_ms(lambda: shk.hll_merge_plain(codes, vocab, g2, ng2, m2),
                     reps=5)
    ids = g2.long()[:, None].expand(-1, HLL_M)
    buf2 = torch.zeros((ng2, HLL_M), dtype=torch.int32, device=vocab.device)
    mlib = time_ms(lambda: buf2.scatter_reduce_(0, ids, vocab, "amax"))
    mbnd, mby = bound_ms(nbytes(codes, g2, m2, vocab, got), vocab.numel())
    report("hll_fold", f"merge {SCALE:,} states -> {ng2}", mms, mplain,
           mbnd, mby, mlib, merr)
    results["hll_fold"].update(merge_ms=mms, merge_plain_ms=mplain,
                               merge_bound_ms=mbnd, merge_library_ms=mlib)
    results["hll_fold"]["max_abs_err"] = max(err, merr)
    # -- udd_fold, fold mode --
    gamma = sko.udd_gamma(UDD_ERR)
    got = shk.udd_fold(vals, gid, ng, mask, gamma, UDD_NB)
    want = shk.udd_fold_plain(vals, gid, ng, mask, gamma, UDD_NB)
    err = max_err(got, want, exact=True)
    ms = time_ms(lambda: shk.udd_fold(vals, gid, ng, mask, gamma, UDD_NB))
    plain = time_ms(lambda: shk.udd_fold_plain(vals, gid, ng, mask, gamma,
                                               UDD_NB), reps=5)
    k, okk = shk.udd_keys_plain(vals, mask, gamma)
    kmin, kmax = shk.udd_key_extremes_plain(k, okk, gid, ng)
    c = shk.udd_collapse_plain(kmin, kmax, UDD_NB)
    gidc = torch.clamp(gid.long(), 0, ng - 1)
    base = torch.div(kmin, c, rounding_mode="floor") * c
    bidx = torch.clamp(torch.div(k - base[gidc] + c[gidc] - 1, c[gidc],
                                 rounding_mode="floor"), 0, UDD_NB - 1)
    livek = okk & (gid >= 0) & (gid < ng)
    ucells = (gid.long() * UDD_NB + bidx)[livek]
    lib = time_ms(lambda: torch.bincount(ucells, minlength=ng * UDD_NB))
    bnd, by = bound_ms(nbytes(vals, gid, mask, got), n * 20, F64_FLOPS)
    report("udd_fold", f"fold [{n:,}] f32 -> [{ng:,},{UDD_NB + 2}]", ms,
           plain, bnd, by, lib, err)
    results["udd_fold"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                               bound_by=by, library_ms=lib, max_abs_err=err)
    del k, okk, gidc, base, bidx, livek, ucells
    # -- udd_fold, merge mode: the hosts' count rows by group --
    vc = torch.from_numpy(sctx["counts"]).cuda()
    cfg = torch.zeros(SCALE, dtype=torch.int32, device=vc.device)
    got = shk.udd_merge(codes, vc, cfg, g2, ng2, m2)
    want = shk.udd_merge_plain(codes, vc, cfg, g2, ng2, m2)
    merr = max_err(got, want, exact=True)
    mms = time_ms(lambda: shk.udd_merge(codes, vc, cfg, g2, ng2, m2))
    mplain = time_ms(lambda: shk.udd_merge_plain(codes, vc, cfg, g2, ng2,
                                                 m2), reps=5)
    report("udd_fold", f"merge {SCALE:,} count rows -> {ng2}", mms, mplain,
           bound_ms(nbytes(codes, g2, m2, vc, cfg, got), 0)[0], "bytes",
           None, merr)
    results["udd_fold"].update(merge_ms=mms, merge_plain_ms=mplain)
    results["udd_fold"]["max_abs_err"] = max(err, merr)
    return results


# ---------------------------------------------------------------------------
# phase 8: flows
# ---------------------------------------------------------------------------

FLOW_SERIES = 1 << 20
FLOW_BATCHES, FLOW_STEPS_PER_BATCH, FLOW_STEP_MS = 6, 3, 10_000
FLOW_T0 = 28_333_333 * 60_000  # a minute boundary (windows align to it)
# tests/test_flow_device.py FLOW_SQL: the device fold's full surface
FLOW_SQL = ("CREATE FLOW f SINK TO agg AS SELECT "
            "date_bin(INTERVAL '1 minute', ts) AS w, h, sum(v) AS s, "
            "count(*) AS c, count(v) AS cv, avg(v) AS a, min(v) AS mn, "
            "max(v) AS mx, first_value(v) AS fv, last_value(v) AS lv, "
            "sum(k) AS sk FROM src GROUP BY w, h")
FLOW_SRC = ("CREATE TABLE src (h STRING, ts TIMESTAMP(3) TIME INDEX, "
            "v DOUBLE, k BIGINT, PRIMARY KEY (h))")
SINK_COLS = ("s", "c", "cv", "a", "mn", "mx", "fv", "lv", "sk")


def np_flow_sink(v: np.ndarray, k: np.ndarray, steps_per_window: int,
                 steps_per_batch: int):
    """FLOW_SQL's aggregates per (window, series) from v / k [steps,
    series] (time-ordered; NaN = NULL) as the streaming decomposition
    defines them: first_value is the first non-NULL value of the window's
    first batch and last_value the last non-NULL value of its last batch
    (a batch's companion timestamp counts NULL rows too)."""
    S = v.shape[1]
    vw = v.reshape(-1, steps_per_window, S)
    kw = k.reshape(-1, steps_per_window, S)
    ok = ~np.isnan(vw)
    cv = ok.sum(1)
    s = np.where(ok, vw, 0.0).sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        a = np.where(cv > 0, s / np.maximum(cv, 1), np.nan)
    big = np.where(ok, vw, np.inf).min(1)
    small = np.where(ok, vw, -np.inf).max(1)
    head, tail = vw[:, :steps_per_batch], vw[:, -steps_per_batch:]
    hok, tok = ~np.isnan(head), ~np.isnan(tail)
    first = np.take_along_axis(head, np.argmax(hok, 1)[:, None], 1)[:, 0]
    last = np.take_along_axis(
        tail, (steps_per_batch - 1 - np.argmax(tok[:, ::-1], 1))[:, None],
        1)[:, 0]
    return {"s": np.where(cv > 0, s, np.nan),
            "c": np.full(cv.shape, steps_per_window, np.float64),
            "cv": cv.astype(np.float64), "a": a,
            "mn": np.where(cv > 0, big, np.nan),
            "mx": np.where(cv > 0, small, np.nan),
            "fv": np.where(hok.any(1), first, np.nan),
            "lv": np.where(tok.any(1), last, np.nan),
            "sk": kw.sum(1).astype(np.float64)}


def _flow_db(home: str, device_fold: bool):
    from greptimedb_tpu_torch.standalone import GreptimeDB
    from greptimedb_tpu_torch.storage.region import RegionOptions

    os.environ["GREPTIME_FLOW_DEVICE"] = "on" if device_fold else "off"
    try:
        db = GreptimeDB(home, region_options=RegionOptions(
            wal_enabled=False, flush_threshold_bytes=1 << 40))
    finally:
        os.environ.pop("GREPTIME_FLOW_DEVICE", None)
    db.sql(FLOW_SRC)
    db.sql(FLOW_SQL)
    return db


def _fold_batch(db, region, data):
    region.write(data)
    if not region.last_write_appendable:
        raise AssertionError("a flow batch was not an append")
    db.flow_engine.on_write("src", data["ts"], data, appendable=True)
    db.flow_engine.run_all()
    torch.cuda.synchronize()


def flow_parity(seed: int = 13, groups: int = 500, rows: int = 4000,
                nbatches: int = 3) -> int:
    """The device sink against the host engine's (GREPTIME_FLOW_DEVICE=
    off) at bench_flow.py's parity size and batch shape, on the card."""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"h{i}" for i in range(groups)], dtype=object)
    perm = rng.permutation(groups)
    batches, t = [], 0
    for b in range(nbatches):
        hidx = perm[(np.arange(rows, dtype=np.int64) + b * 7919) % groups]
        ts = t + 1 + np.arange(rows, dtype=np.int64) // 6
        t = int(ts[-1])
        batches.append({"h": vocab[hidx], "ts": ts,
                        "v": rng.integers(1, 100, rows).astype(np.float64),
                        "k": rng.integers(0, 1000, rows).astype(np.int64)})
    sinks = []
    for device_fold in (True, False):
        home = tempfile.mkdtemp(prefix="chip_smoke_flow_")
        db = _flow_db(home, device_fold)
        try:
            region = db._region_of("src")
            for b in batches:
                _fold_batch(db, region, b)
            from greptimedb_tpu_torch.flow.engine import flow_mode

            mode = flow_mode(db.flow_engine.flows["f"])
            if mode != ("streaming(device)" if device_fold else "streaming"):
                raise AssertionError(f"parity flow ran {mode}")
            sinks.append(db.sql("SELECT w, h, " + ", ".join(SINK_COLS)
                                + " FROM agg ORDER BY w, h").rows)
        finally:
            db.close()
            shutil.rmtree(home, ignore_errors=True)
    if not sinks[0] or sinks[0] != sinks[1]:
        raise AssertionError("device and host flow sinks differ")
    return len(sinks[0])


def phase_flows(fk, sk, series: int, card: str):
    """Returns (launches, the kernel numbers of flow_merge)."""
    from greptimedb_tpu_torch.datatypes.batch import DictColumn
    from greptimedb_tpu_torch.flow import device as flow_device
    from greptimedb_tpu_torch.flow.engine import flow_mode
    from greptimedb_tpu_torch.storage.memtable import tagcode_col

    if series < FLOW_SERIES:
        log(f"cut: {series:,} flow series instead of {FLOW_SERIES:,}")
    steps = FLOW_BATCHES * FLOW_STEPS_PER_BATCH
    spw = 60_000 // FLOW_STEP_MS  # steps per 1-minute window
    rng = np.random.default_rng(5)
    v = rng.integers(1, 100, (steps, series)).astype(np.float64)
    v.reshape(-1)[::1000] = np.nan
    k = rng.integers(0, 1000, (steps, series)).astype(np.int64)
    names = np.array([f"h{i}" for i in range(series)], dtype=object)
    codes = np.tile(np.arange(series, dtype=np.int32), FLOW_STEPS_PER_BATCH)
    home = tempfile.mkdtemp(prefix="chip_smoke_flow_")
    db = _flow_db(home, True)
    captured = {}
    real_merge = flow_device.flow_merge

    def capture(*args):
        captured["args"] = args
        return real_merge(*args)

    try:
        region = db._region_of("src")
        rt = db.flow_runtime
        sk.reset_launch_counts()
        fk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # left over from earlier phases
        times, busy = [], None
        for b in range(FLOW_BATCHES):
            js = np.arange(b * FLOW_STEPS_PER_BATCH,
                           (b + 1) * FLOW_STEPS_PER_BATCH)
            data = {"h": DictColumn(names, codes),
                    "ts": np.repeat(FLOW_T0 + js * FLOW_STEP_MS, series),
                    "v": v[js].reshape(-1), "k": k[js].reshape(-1)}
            if b == FLOW_BATCHES - 2:
                flow_device.flow_merge = capture
            try:
                if b == FLOW_BATCHES - 1:
                    region.write(data)
                    busy = device_busy(lambda: (
                        db.flow_engine.on_write("src", data["ts"], data,
                                                appendable=True),
                        db.flow_engine.run_all()), sessions=1)
                    continue
                t0 = time.perf_counter()
                _fold_batch(db, region, data)
                times.append(time.perf_counter() - t0)
            finally:
                flow_device.flow_merge = real_merge
        task = db.flow_engine.flows["f"]
        mode = flow_mode(task)
        take_shapes("segment_reduce", sk.segment_reduce)
        launches = {"flow_merge": fk.flow_merge.launches,
                    "segment_reduce": sk.segment_reduce.launches}
        peak = torch.cuda.max_memory_allocated()
        st = task.device_state
        if mode != "streaming(device)" or rt.fallbacks or rt.reseeds != 1:
            raise AssertionError(f"flow ran {mode}, {rt.fallbacks} "
                                 f"fallbacks, {rt.reseeds} reseeds")
        rows_b = series * FLOW_STEPS_PER_BATCH
        warm = float(np.median(times[1:]))
        log(f"flows: {series:,} series x {steps} steps in {FLOW_BATCHES} "
            f"batches of {rows_b:,} rows: {mode}, {rt.reseeds} reseed, "
            f"{rt.fallbacks} fallbacks, {rt.fold_dispatches} folds; state "
            f"{len(st.slots)} x [{st.Gpad:,}, {st.Wpad}] = {st.nbytes():,} B")
        log(f"flows: seed batch {times[0] * 1e3:.3f} ms; warm batches "
            f"{[round(t * 1e3, 3) for t in times[1:]]} ms; warm fold "
            f"{rows_b / warm:,.0f} rows/s (median); device busy "
            f"{busy[0]:.3f} ms of {busy[1]:.3f} ms wall for one warm fold "
            f"({100 * busy[0] / max(busy[1], 1e-9):.2f} %), top device ops "
            f"{busy[2]}; max_memory_allocated {peak} B, of which {held} B "
            f"were held before the phase; launches {launches} — {card}")
        for kname, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{kname} never launched on the flow "
                                     f"path")
        # every sink row against numpy, through a host scan of the sink
        t0 = time.perf_counter()
        want = np_flow_sink(v, k, spw, FLOW_STEPS_PER_BATCH)
        sink = db._region_of("agg").scan_host(with_tag_codes=True)
        vocab = db._region_of("agg").encoders["h"].values()
        ids = np.array([int(x[1:]) for x in vocab], np.int64)
        hcol = sink.get(tagcode_col("h"))
        series_of = (ids[np.asarray(hcol, np.int64)] if hcol is not None
                     else np.array([int(x[1:]) for x in sink["h"]]))
        win = (np.asarray(sink["w"], np.int64) - FLOW_T0) // 60_000
        nwin = steps // spw
        if len(win) != nwin * series or len(
                np.unique(win * series + series_of)) != len(win):
            raise AssertionError(f"sink has {len(win)} rows, want "
                                 f"{nwin * series}")
        for col in SINK_COLS:
            got = np.asarray(sink[col], np.float64)
            exp = want[col][win, series_of]
            same = (got == exp) | (np.isnan(got) & np.isnan(exp))
            if not same.all():
                i = int(np.argmin(same))
                raise AssertionError(f"sink {col}: series {series_of[i]} "
                                     f"window {win[i]}: {got[i]} vs {exp[i]}")
        log(f"flows: {len(win):,} sink rows ({nwin} windows x {series:,} "
            f"series) exactly equal to numpy ({time.perf_counter() - t0:.3f}"
            f" s host scan + check)")
        n_par = flow_parity()
        log(f"flows: device sink equal to GREPTIME_FLOW_DEVICE=off at "
            f"bench_flow.py's parity size ({n_par} rows)")
        results = {"flow_merge": flow_merge_timing(fk, captured["args"],
                                                   card)}
        return launches, results
    finally:
        db.close()
        shutil.rmtree(home, ignore_errors=True)


def flow_merge_timing(fk, args, card: str) -> dict:
    """flow_merge on a warm fold's own inputs (its chunk partials and
    affected slots) over copies of the state it merged into."""
    state, chunk, rows_any, aff_g, aff_w, kinds, links = args
    sa = [s.clone() for s in state]
    sb = [s.clone() for s in state]
    got = fk.flow_merge(sa, chunk, rows_any, aff_g, aff_w, kinds, links)
    want = fk.flow_merge_plain(sb, chunk, rows_any, aff_g, aff_w, kinds,
                               links)
    err = max(max_err(a, b, exact=True) for a, b in zip(got + sa, want + sb))
    ms = time_ms(lambda: fk.flow_merge(sa, chunk, rows_any, aff_g, aff_w,
                                       kinds, links))
    plain = time_ms(lambda: fk.flow_merge_plain(sb, chunk, rows_any, aff_g,
                                                aff_w, kinds, links), reps=5)
    gpad = state[-1].shape[0]
    n_aff = int((aff_g < gpad).sum())
    A = len(kinds)
    # per live slot: A chunk partials and the row count read, A + 1 state
    # elements read and written, A + 1 outputs written, the slot ids read
    bnd, by = bound_ms(n_aff * (8 * A + 8 + 24 * (A + 1) + 8), 0)
    log(f"kernel flow_merge[{A} accumulators + rows, {n_aff:,} of "
        f"{aff_g.shape[0]:,} slots into [{gpad:,}, {state[-1].shape[1]}]]: "
        f"{ms:.4f} ms (plain {plain:.4f} ms, library null ms — no one call, "
        f"bound {bnd:.4f} ms by {by}), max_abs_err {err:.3g} — {card}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None, max_abs_err=err)


# ---------------------------------------------------------------------------
# phase 9: logs
# ---------------------------------------------------------------------------

LOG_LINES = 1_000_000
LOG_BATCH = 20_000
LOG_T0_NS = 1_700_000_000_000_000_000
LOG_SPAN_S = 3600
LOG_TENANT = "bench"
# bench_logs.py's corpus: 16 apps x 4 levels = 64 streams, mostly-unique
# lines (a random 40-bit request id in each)
LOG_APPS = [f"svc-{i}" for i in range(16)]
LOG_LEVELS = ["info", "warn", "error", "debug"]
LOG_PATHS = ["/api/v1/items", "/api/v1/users", "/healthz", "/checkout",
             "/search", "/login"]
LOG_ERRORS = ["context deadline exceeded", "connection refused",
              "connection reset by peer", "upstream timeout",
              "tls handshake failure", "queue overflow"]
LOG_STEP_S = LOG_SPAN_S // 30
LOG_LIMIT = 100
# name -> (LogQL, kind, predicate of a matching line, range ms, levels)
LOG_QUERIES = {
    "substr_common": ('{app=~".+"} |= "context deadline"', "streams",
                      lambda s: "context deadline" in s, 0, None),
    "substr_rare": ('{app=~".+"} |= "tls handshake failure"', "streams",
                    lambda s: "tls handshake failure" in s, 0, None),
    "regex": ('{app=~".+"} |~ "deadline exceeded|connection refused"',
              "streams", lambda s: ("deadline exceeded" in s
                                    or "connection refused" in s), 0, None),
    "count_over_time": ('sum by (app) (count_over_time({level="error"} '
                        '|= "request failed" [2m]))', "count_by_app",
                        lambda s: "request failed" in s, 120_000,
                        ("error",)),
    "bytes_over_time": ('sum by (app) (bytes_over_time({app=~".+"} '
                        '|= "upstream timeout" [5m]))', "bytes_by_app",
                        lambda s: "upstream timeout" in s, 300_000, None),
    "rate": ('rate({level="warn"} != "status=200" [1m])', "rate",
             lambda s: "status=200" not in s, 60_000, ("warn",)),
}
LOG_SQL = {
    "sql_matches_term": ("SELECT count(*) FROM loki_logs WHERE "
                         "matches_term(line, 'refused')",
                         lambda s: "refused" in s),
    "sql_like": ("SELECT count(*) FROM loki_logs WHERE line LIKE "
                 "'%queue overflow%'", lambda s: "queue overflow" in s),
}


def gen_log_lines(rng, n: int, t0_ns: int = LOG_T0_NS,
                  span_s: float = LOG_SPAN_S):
    """bench_logs.py's gen_lines: (app, level, ts_ns, line), n lines
    spread evenly over ``span_s`` seconds from ``t0_ns``."""
    out = []
    for i in range(n):
        app = rng.choice(LOG_APPS)
        level = rng.choice(LOG_LEVELS)
        ts = t0_ns + int(i * (span_s * 1e9) / n)
        rid = rng.randrange(10**12)
        path = rng.choice(LOG_PATHS)
        if level == "error" and rng.random() < 0.6:
            line = (f"request failed method=GET path={path} "
                    f"req_id={rid:x} err={rng.choice(LOG_ERRORS)!r}")
        else:
            line = (f"handled method=GET path={path} status="
                    f"{rng.choice([200, 201, 204, 301, 404])} "
                    f"req_id={rid:x} dur={rng.random()*2:.3f}s")
        out.append((app, level, ts, line))
    return out


def log_push_bodies(rows) -> list[bytes]:
    """bench_logs.py's push batches: JSON, streams grouped by (app,
    level), LOG_BATCH lines a request."""
    bodies = []
    for lo in range(0, len(rows), LOG_BATCH):
        streams: dict = {}
        for app, level, ts, line in rows[lo:lo + LOG_BATCH]:
            streams.setdefault((app, level), []).append([str(ts), line])
        bodies.append(json.dumps({"streams": [
            {"stream": {"app": a, "level": lv}, "values": vals}
            for (a, lv), vals in streams.items()]}).encode())
    return bodies


def np_log_corpus(rows) -> dict:
    """Per-line arrays of the generated corpus (ts in ms, as pushed)."""
    return {"app": np.array([r[0] for r in rows], dtype=object),
            "level": np.array([r[1] for r in rows], dtype=object),
            "ts_ms": np.array([r[2] // 1_000_000 for r in rows], np.int64),
            "nbytes": np.array([len(r[3].encode("utf-8")) for r in rows],
                               np.int64),
            "lines": [r[3] for r in rows]}


def np_log_expected(corpus: dict, name: str):
    """The exact answer of one phase 9 query from the generated lines:
    the Loki payload's ``result`` for stream queries (newest LOG_LIMIT
    matching lines, grouped by stream), ``{series: {step seconds: value
    string}}`` for metric queries, the count for SQL."""
    lines = corpus["lines"]
    pred = (LOG_SQL[name][1] if name in LOG_SQL else LOG_QUERIES[name][2])
    hit = np.fromiter((pred(s) for s in lines), dtype=bool, count=len(lines))
    if name in LOG_SQL:
        return int(hit.sum())
    _q, kind, _pred, range_ms, levels = LOG_QUERIES[name]
    if kind == "streams":
        streams: dict = {}
        for i in np.nonzero(hit)[0][-LOG_LIMIT:][::-1].tolist():
            app, level = corpus["app"][i], corpus["level"][i]
            entry = streams.setdefault((app, level), {
                "stream": {"app": app, "level": level,
                           "tenant": LOG_TENANT}, "values": []})
            entry["values"].append(
                [str(int(corpus["ts_ms"][i]) * 1_000_000), lines[i]])
        return list(streams.values())
    if levels is not None:
        hit &= np.isin(corpus["level"], levels)
    start_ms = LOG_T0_NS // 1_000_000
    steps = start_ms + np.arange(LOG_SPAN_S // LOG_STEP_S + 1,
                                 dtype=np.int64) * LOG_STEP_S * 1000
    out: dict = {}
    keys = sorted(set(zip(corpus["app"][hit], corpus["level"][hit])))
    for app, level in keys:
        sel = hit & (corpus["app"] == app) & (corpus["level"] == level)
        ts = corpus["ts_ms"][sel]  # ascending: lines are in time order
        cb = np.concatenate([[0], np.cumsum(corpus["nbytes"][sel])])
        lo = np.searchsorted(ts, steps - range_ms, side="right")
        hi = np.searchsorted(ts, steps, side="right")
        per = out.setdefault(app if kind != "rate" else (app, level), {})
        for j, t in enumerate(steps.tolist()):
            cnt = int(hi[j] - lo[j])
            if cnt:
                # the payload's step time: unit_to_ns(t) / 1e9
                sec = t * 1_000_000 / 1e9
                per[sec] = per.get(sec, 0) + (
                    int(cb[hi[j]] - cb[lo[j]]) if kind == "bytes_by_app"
                    else cnt)
    if kind == "rate":  # count / 60 s, printed as the payload prints it
        return {k: {sec: repr(v / 60.0) if v % 60 else str(v // 60)
                    for sec, v in per.items()} for k, per in out.items()}
    return {k: {sec: str(v) for sec, v in per.items()}
            for k, per in out.items()}


def log_payload_view(name: str, payload: dict):
    """The part of a Loki payload np_log_expected describes."""
    kind = LOG_QUERIES[name][1]
    result = payload["data"]["result"]
    if kind == "streams":
        return result
    out = {}
    for r in result:
        m = r["metric"]
        key = m["app"] if kind != "rate" else (m["app"], m["level"])
        out[key] = {sec: v for sec, v in r["values"]}
    return out


def log_counters() -> dict:
    from greptimedb_tpu_torch.utils.telemetry import REGISTRY

    val = REGISTRY.value
    return {
        "candidates": int(val("greptime_fulltext_candidates_total")),
        "verified": int(val("greptime_fulltext_verified_total")),
        "matched": int(val("greptime_fulltext_matched_total")),
        "scanned_excluded": int(val("greptime_fulltext_scanned_total")),
        "queries_prefilter": int(val("greptime_fulltext_queries_total",
                                     ("prefilter",))),
        "queries_memo": int(val("greptime_fulltext_queries_total",
                                ("memo",))),
        "resident_bytes": int(val("greptime_fulltext_resident_bytes")),
    }


def phase_logs(lk, pk, stk, lines: int, card: str):
    """Returns (launches, the kernel numbers of the four log kernels, the
    launches of the write-then-query step (iii), run last)."""
    import random

    from greptimedb_tpu_torch.fulltext import loki
    from greptimedb_tpu_torch.servers.ingest import loki_push
    from greptimedb_tpu_torch.standalone import GreptimeDB
    from greptimedb_tpu_torch.utils.tracing import TRACER

    if lines < LOG_LINES:
        log(f"cut: {lines:,} log lines instead of {LOG_LINES:,}")
    t0 = time.perf_counter()
    rows = gen_log_lines(random.Random(12), lines)
    bodies = log_push_bodies(rows)
    log(f"logs: generated {lines:,} lines ({sum(len(r[3]) for r in rows):,}"
        f" bytes of text) in {len(bodies)} JSON bodies of up to "
        f"{LOG_BATCH:,} lines in {time.perf_counter() - t0:.3f} s")
    os.environ["GREPTIME_FULLTEXT"] = "on"
    db = GreptimeDB()
    try:
        lk.reset_launch_counts()
        pk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        n = sum(loki_push(db, b, "application/json", LOG_TENANT)
                for b in bodies)
        push_s = time.perf_counter() - t0
        if n != lines:
            raise AssertionError(f"pushed {n} rows, want {lines}")
        log(f"logs: pushed {n:,} lines through servers.ingest.loki_push in "
            f"{push_s:.3f} s ({n / push_s:,.0f} lines/s)")
        params = {"start": str(LOG_T0_NS // 10**9),
                  "end": str(LOG_T0_NS // 10**9 + LOG_SPAN_S),
                  "step": str(LOG_STEP_S), "limit": str(LOG_LIMIT)}
        runs = {name: (lambda q=q: loki.loki_query_range(
                           db, {"query": q, **params}))
                for name, (q, *_rest) in LOG_QUERIES.items()}
        runs.update({name: (lambda q=q: db.sql(q).rows[0][0])
                     for name, (q, _p) in LOG_SQL.items()})
        answers, results = {}, {}
        TRACER.configure(enabled=True)
        try:
            for name, run in runs.items():
                t0 = time.perf_counter()
                got = run()
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
                warm = []
                for _ in range(5):
                    mark = TRACER.mark()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    warm.append((time.perf_counter() - t0) * 1e3)
                window = [(s["end_ns"] - s["start_ns"]) / 1e6
                          for s in TRACER.since(mark)
                          if s["name"] == "logql_window"]
                busy, wall, top = device_busy(run, top_n=3, sessions=2)
                answers[name] = got
                results[name] = dict(first_ms=first_ms,
                                     warm_ms=float(np.median(warm)),
                                     busy_ms=busy, wall_ms=wall)
                log(f"logs {name}: first {first_ms:.3f} ms, warm median "
                    f"{results[name]['warm_ms']:.3f} ms (5 runs); "
                    f"logql_window {window[0] if window else 0.0:.3f} ms; "
                    f"device busy {busy:.3f} ms of {wall:.3f} ms wall "
                    f"({100 * busy / max(wall, 1e-9):.2f} %); top device "
                    f"ops {top} — {card}")
        finally:
            TRACER.configure(enabled=False)
        launches = {"fp_candidates": lk.fp_candidates.launches,
                    "logs_layout": lk.logs_layout.launches,
                    "line_vals": lk.line_vals.launches,
                    "row_match": lk.row_match.launches,
                    "window_stats": pk.window_stats.launches,
                    "series_offsets": pk.series_offsets.launches}
        counters = log_counters()
        peak = torch.cuda.max_memory_allocated()
        log(f"logs: fulltext counters {counters}; fulltext cache "
            f"{db.engine.executor.fulltext_cache.stats()}; "
            f"max_memory_allocated {peak} B, of which {held} B were held "
            f"before the phase; launches {launches} — {card}")
        for kname, cnt in launches.items():
            if cnt <= 0:
                raise AssertionError(f"{kname} never launched on the logs "
                                     "path")
        if counters["queries_prefilter"] <= 0:
            raise AssertionError("the fingerprint prefilter never ran")
        # every answer exactly against numpy over the generated lines
        t0 = time.perf_counter()
        corpus = np_log_corpus(rows)
        sizes = {}
        for name, got in answers.items():
            want = np_log_expected(corpus, name)
            view = got if name in LOG_SQL else log_payload_view(name, got)
            if view != want:
                raise AssertionError(f"logs {name}: {str(view)[:300]} vs "
                                     f"numpy {str(want)[:300]}")
            sizes[name] = (view if name in LOG_SQL else
                           sum(len(v["values"]) if "values" in v else len(v)
                               for v in (view if isinstance(view, list)
                                         else view.values())))
        log(f"logs: every answer exactly equal to numpy over the generated "
            f"lines (entries / samples / counts {sizes}; "
            f"{time.perf_counter() - t0:.3f} s)")
        # ... and to the GREPTIME_FULLTEXT=off host twin
        os.environ["GREPTIME_FULLTEXT"] = "off"
        try:
            off_ms = {}
            for name, run in runs.items():
                t0 = time.perf_counter()
                got = run()
                off_ms[name] = (time.perf_counter() - t0) * 1e3
                if got != answers[name]:
                    raise AssertionError(f"logs {name}: GREPTIME_FULLTEXT="
                                         "off differs")
        finally:
            os.environ["GREPTIME_FULLTEXT"] = "on"
        log(f"logs: every answer equal under GREPTIME_FULLTEXT=off (host "
            f"twin ms {({k: round(v, 3) for k, v in off_ms.items()})})")
        timing = log_kernel_timing(lk, db, card)
        return launches, timing, write_query_logs(stk, db, rows, params,
                                                  card)
    finally:
        os.environ.pop("GREPTIME_FULLTEXT", None)
        db.close()


def log_kernel_timing(lk, db, card: str) -> dict:
    """The four log kernels on the phase's own resident state: the line
    column's fingerprint matrix with the masks of "context deadline", the
    resident table's columns, the verified vector and byte lengths of the
    bytes query, and the 64-stream selection."""
    from greptimedb_tpu_torch.fulltext import fingerprint as fpm
    from greptimedb_tpu_torch.fulltext.loki import LokiEvaluator
    from greptimedb_tpu_torch.fulltext.logql import parse_logql
    from greptimedb_tpu_torch.storage.memtable import TSID

    ev = LokiEvaluator(db, "loki_logs")
    ft = ev.ft_cache
    table = ev.table
    vocab = table.dicts["line"]
    e = ft._fingerprints("loki_logs", table.dicts_root, "line", vocab,
                         table.row_mask.device)
    masks = fpm.compile_masks(fpm.spec_for("contains", "context deadline"),
                              e.words, e.mg)
    qm = torch.from_numpy(masks.view(np.int32)).to(e.dev.device)
    agg = parse_logql(LOG_QUERIES["bytes_over_time"][0]).inner
    verified, npad = ev._verified_vector(agg.query)
    blen = ev._byte_lengths(npad)
    sel_tsids, sel_dev, _labels = ev.data.select_series(
        ev._matchers(agg.query))
    cols = table.columns
    codes, ts, tsid, mask = (cols["line"], cols[ev.ts_name], cols[TSID],
                             table.row_mask)
    N = codes.shape[0]
    lo = LOG_T0_NS // 1_000_000
    hi = lo + LOG_SPAN_S * 1000 // 2
    out = {}

    def report(name, shape, ms, plain, bnd, by, lib, err):
        log(f"kernel {name}[{shape}]: {ms:.4f} ms (plain {plain:.4f} ms, "
            f"library {'null' if lib is None else f'{lib:.4f}'} ms, bound "
            f"{bnd:.4f} ms by {by}), max_abs_err {err:.3g} — {card}")
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=lib, max_abs_err=err)

    got = lk.fp_candidates(e.dev, qm)
    err = max_err(got, lk.fp_candidates_plain(e.dev, qm), exact=True)
    bnd, by = bound_ms(nbytes(e.dev, qm) + e.npad, 0)
    report("fp_candidates",
           f"{e.npad:,} x {e.words} words, {masks.shape[0]} mask, "
           f"{int(got.sum()):,} candidates",
           time_ms(lambda: lk.fp_candidates(e.dev, qm)),
           time_ms(lambda: lk.fp_candidates_plain(e.dev, qm), reps=5),
           bnd, by, None, err)

    got = lk.logs_layout(ts, tsid, mask)
    err = max(max_err(g, w, exact=True) for g, w in
              zip(got, lk.logs_layout_plain(ts, tsid, mask)))
    bnd, by = bound_ms(nbytes(ts, tsid, mask) + 8 * N + 16, 0)
    report("logs_layout", f"N = {N:,}",
           time_ms(lambda: lk.logs_layout(ts, tsid, mask)),
           time_ms(lambda: lk.logs_layout_plain(ts, tsid, mask), reps=5),
           bnd, by, time_ms(lambda: torch.aminmax(ts)), err)

    got = lk.line_vals(codes, verified, mask, blen)
    err = max(max_err(g, w, exact=True) for g, w in
              zip(got, lk.line_vals_plain(codes, verified, mask, blen)))
    bnd, by = bound_ms(nbytes(codes, verified, mask, blen) + 8 * N, 0)
    report("line_vals", f"N = {N:,}, npad {npad:,}, with byte lengths",
           time_ms(lambda: lk.line_vals(codes, verified, mask, blen)),
           time_ms(lambda: lk.line_vals_plain(codes, verified, mask, blen),
                   reps=5), bnd, by, None, err)

    ns = table.num_series
    got = lk.row_match(codes, verified, mask, ts, tsid, sel_dev, lo, hi, ns)
    err = max_err(got, lk.row_match_plain(codes, verified, mask, ts, tsid,
                                          sel_dev, lo, hi), exact=True)
    bnd, by = bound_ms(nbytes(codes, verified, mask, ts, tsid, sel_dev) + N,
                       0)
    report("row_match",
           f"N = {N:,}, {len(sel_tsids)} of {sel_dev.shape[0]} selected, "
           f"{int(got.sum()):,} rows kept",
           time_ms(lambda: lk.row_match(codes, verified, mask, ts, tsid,
                                        sel_dev, lo, hi, ns)),
           time_ms(lambda: lk.row_match_plain(codes, verified, mask, ts,
                                              tsid, sel_dev, lo, hi),
                   reps=5), bnd, by,
           time_ms(lambda: torch.isin(tsid, sel_dev)), err)
    return out


# ---------------------------------------------------------------------------
# phase 10: concurrent serving on phase 3's table
# ---------------------------------------------------------------------------

SERVE_CLIENTS = 16


def serve_query(hours: int, i: int, host: int | None):
    """(sql, window start hour, window hours, host) of client query i:
    double-groupby-all over a 12 h aligned window starting at hour
    i % 12 (h), or the same with hostname = 'host_<host>' (i)."""
    wh = min(12, hours)
    h0 = i % max(1, min(12, hours - wh + 1))
    lo = T0 + h0 * 3_600_000
    avgs = ", ".join(f"avg({m})" for m in METRICS)
    where = "" if host is None else f"hostname = 'host_{host}' AND "
    sql = (f"SELECT hostname, date_trunc('hour', ts) AS hour, {avgs} "
           f"FROM cpu WHERE {where}ts >= {lo} AND ts < "
           f"{lo + wh * 3_600_000} GROUP BY hostname, hour")
    return sql, h0, wh, host


def check_serving_rows(rows, stats, h0: int, wh: int, host) -> float:
    """Rows of one serving query against phase 3's numpy sums, vectorized:
    every (host, hour) of the window once, each avg within the golden
    bound."""
    n_want = (SCALE if host is None else 1) * wh
    if len(rows) != n_want:
        raise AssertionError(f"serving: {len(rows)} rows, expected {n_want}")
    hosts = np.array([int(r[0].split("_")[1]) for r in rows])
    hrs = (np.array([r[1] for r in rows], np.int64) - T0) // 3_600_000
    vals = np.array([r[2:] for r in rows], np.float64)
    keys = set(zip(hosts.tolist(), hrs.tolist()))
    want_hosts = range(SCALE) if host is None else [host]
    if keys != {(h, t) for h in want_hosts for t in range(h0, h0 + wh)}:
        raise AssertionError("serving: wrong (host, hour) keys")
    want = stats["sum"][hrs, hosts, :] / STEPS_PER_HOUR
    diff = np.abs(vals - want)
    if not np.isfinite(vals).all() or (
            diff > REL_TOL * np.maximum(1.0, np.abs(want))).any():
        raise AssertionError(f"serving: max |diff| {diff.max()}")
    return float(diff.max())


def drive_clients(submit, jobs, solo) -> tuple[list, float]:
    """SERVE_CLIENTS threads, closed loop: client c submits its queries
    jobs[c] in turn; every answer must equal the query's solo rows (==).
    Returns (latencies ms, wall s)."""
    import threading

    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(c):
        try:
            for sql in jobs[c]:
                t0 = time.perf_counter()
                res = submit(sql)
                dt = (time.perf_counter() - t0) * 1e3
                if res.rows != solo[sql]:
                    raise AssertionError(f"serving: member != solo for "
                                         f"{sql[-80:]}")
                with lock:
                    lat.append(dt)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(jobs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving: a client did not finish")
    return lat, wall


def phase_serving(gk, db, ctx: dict, hours: int, card: str):
    """The concurrent serving path on phase 3's open db: SERVE_CLIENTS
    threads submit (h) and (i) through db.scheduler; every answer equals
    its solo db.sql rows and numpy; both stacked-batch kernels must launch
    and at least one batch must stack.  Then queries/s and latency with
    batching on and off, the device-busy share against the kernels' own
    CUDA-event times, and the two kernels timed on the captured batch
    arguments.  Returns (launches, kernel results)."""
    from torch.profiler import ProfilerActivity, profile

    from greptimedb_tpu_torch.query import physical
    from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

    t_phase = time.perf_counter()
    sched = db.scheduler
    if sched is None:
        raise AssertionError("serving: db.scheduler is off")
    stats = ctx["stats"]
    rounds = 3

    def jobs_for(r0: int) -> list:
        # even clients (h), odd clients (i) with a host that varies per
        # client and round; windows vary with client and round
        return [[serve_query(hours, c + r, None if c % 2 == 0 else
                             (c * 251 + r * 17) % SCALE)
                 for r in range(r0, r0 + rounds)]
                for c in range(SERVE_CLIENTS)]

    all_jobs = jobs_for(0) + jobs_for(rounds)
    solo: dict = {}
    worst = 0.0
    t0 = time.perf_counter()
    for job in [j for cj in all_jobs for j in cj]:
        sql, h0, wh, host = job
        if sql not in solo:
            rows = db.sql(sql).rows
            worst = max(worst, check_serving_rows(rows, stats, h0, wh, host))
            solo[sql] = rows
    log(f"serving: {len(solo)} distinct queries run solo through db.sql, "
        f"each correct against numpy (max |diff| {worst:.3g}) in "
        f"{time.perf_counter() - t0:.3f} s")

    # the counted run: launch counts zeroed just before, read just after;
    # the largest batch's kernel arguments are captured for the timings
    captured: dict = {}
    real_gms, real_mask = physical.group_merge_stacked, physical.series_mask

    def cap_gms(*args, **kw):
        key = "gms_masked" if kw.get("mask") is not None else "gms"
        if args[2].shape[0] >= captured.get(key, ((), None, 0))[2]:
            captured[key] = (args, kw, args[2].shape[0])
        return real_gms(*args, **kw)

    def cap_mask(*args):
        if args[5] >= captured.get("mask", ((), None, 0))[2]:
            captured["mask"] = (args, None, args[5])
        return real_mask(*args)

    jobs = [[j[0] for j in cj] for cj in jobs_for(0)]
    stats0 = dict(physical.DISPATCH_STATS)
    largest0 = sched.largest_batch
    physical.group_merge_stacked, physical.series_mask = cap_gms, cap_mask
    try:
        gk.reset_launch_counts()
        for _ in range(10):
            drive_clients(sched.submit, jobs, solo)
            if (gk.group_merge_stacked.launches and gk.series_mask.launches
                    and "gms_masked" in captured and "gms" in captured):
                break
        launches = {"group_merge_stacked": gk.group_merge_stacked.launches,
                    "series_mask": gk.series_mask.launches}
    finally:
        physical.group_merge_stacked = real_gms
        physical.series_mask = real_mask
    batches = physical.DISPATCH_STATS["grid_batch"] - stats0["grid_batch"]
    log(f"serving: launches {launches}; stacked batches {batches}, "
        f"members {physical.DISPATCH_STATS['grid'] - stats0['grid']} "
        f"on the grid, refused "
        f"{physical.DISPATCH_STATS['grid_batch_refused'] - stats0['grid_batch_refused']}; "
        f"largest batch {sched.largest_batch} (scheduler stats "
        f"{ {k: v for k, v in sched.stats().items() if k != 'tenants'} })")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the serving "
                                 f"path")
    if batches <= 0 or sched.largest_batch < 2:
        raise AssertionError("serving: no stacked batch formed")

    # queries/s and latency, batching on and off, in turns
    timed_jobs = [[j[0] for j in cj] for cj in jobs_for(rounds)]
    nq = sum(len(j) for j in timed_jobs)
    off = QueryScheduler(db, batching=False)
    runs = {"on": [], "off": []}
    try:
        for mode in ("on", "off", "off", "on"):
            s = sched if mode == "on" else off
            lat, wall = drive_clients(s.submit, timed_jobs, solo)
            runs[mode].append((nq / wall, lat))
    finally:
        off.stop()
    for mode, rs in runs.items():
        lat = np.concatenate([np.array(r[1]) for r in rs])
        log(f"serving: GREPTIME_SCHEDULER_BATCH={mode}: "
            f"{' / '.join(f'{q:.2f}' for q, _l in rs)} queries/s "
            f"({SERVE_CLIENTS} clients, {nq} queries a run); latency p50 "
            f"{np.percentile(lat, 50):.3f} ms, p99 "
            f"{np.percentile(lat, 99):.3f} ms — {card}")
    log(f"serving: largest batch {sched.largest_batch} "
        f"(before the phase {largest0})")

    # device busy over one batched run, cross-checked against the two
    # kernels' own CUDA-event times x their launches in that run
    gk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive_clients(sched.submit, timed_jobs, solo)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_launches = (gk.group_merge_stacked.launches, gk.series_mask.launches)
    gk.reset_launch_counts()
    busy_ms, kern_prof = 0.0, {"stacked": 0.0, "series_mask": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        busy_ms += us / 1e3
        if "stacked_" in e.key:
            kern_prof["stacked"] += us / 1e3
        elif "series_mask_kernel" in e.key:
            kern_prof["series_mask"] += us / 1e3

    # the kernels at B = 16 on the serving path's own tensors: the
    # resident partials, group layout, plane list and lookup tables of
    # the largest tag-filtered batch; sixteen 12 h windows (starts i % 12)
    # and sixteen members' tables (the captured members', cycled)
    results = {}
    (sums, cnts, _b, lay, planes, nbw), _kw, _n = captured["gms_masked"]
    codes, lut, offsets, strides, extents, _mp = captured["mask"][0]
    B = SERVE_CLIENTS
    dev = cnts.device
    nb = cnts.shape[1]
    cyc = torch.arange(B, device=dev) % offsets.shape[0]
    margs = (codes, lut, offsets[cyc].contiguous(),
             strides[cyc].contiguous(), extents, B)
    got_m = gk.series_mask(*margs)
    err_m = max_err(got_m, gk.series_mask_plain(*margs), exact=True)
    b_lo = (torch.arange(B, device=dev) % 12).to(torch.int32)
    args = (sums, cnts, b_lo, lay, planes, nbw)
    kw = {"mask": got_m}
    mask = got_m
    got = gk.group_merge_stacked(*args, **kw)
    want = gk.group_merge_stacked_plain(*args, **kw)
    err = max(max_err(got[0], want[0], exact=True),
              max_err(got[1], want[1], exact=False))
    # member == solo, bit for bit: each member's window through the solo
    # path's one group_merge_pair launch, and through the two group_merge
    # launches that the pair replaced
    starts = [gk.clamp_start(b, nbw, nb) for b in b_lo.tolist()]
    x_all = sums.index_select(0, planes.long())

    def solo_pairs():
        return [gk.group_merge_pair(cnts.narrow(1, b0, nbw),
                                    x_all.narrow(2, b0, nbw), lay,
                                    factor=mask[m])
                for m, b0 in enumerate(starts)]

    for m, (c1, s1) in enumerate(solo_pairs()):
        max_err(got[0][m], c1, exact=True)
        max_err(got[1][m], s1, exact=True)
        b0 = starts[m]
        c_w = cnts.narrow(1, b0, nbw) * mask[m][:, None]
        max_err(c1, gk.group_merge(c_w.to(torch.int64), lay, "sum"),
                exact=True)
        max_err(s1, gk.group_merge(x_all.narrow(2, b0, nbw), lay, "sum",
                                   factor=mask[m]), exact=True)
    ms = time_ms(lambda: gk.group_merge_stacked(*args, **kw))
    solo_ms = time_ms(solo_pairs)
    plain = time_ms(lambda: gk.group_merge_stacked_plain(*args, **kw),
                    reps=5)
    ids64 = lay.ids.long()
    x_st = torch.stack([x_all.narrow(2, b0, nbw) for b0 in starts]) * (
        mask[:, None, :, None])
    lib_buf = torch.zeros((B, x_all.shape[0], lay.ngt + 1, nbw),
                          device=dev)
    lib = time_ms(lambda: lib_buf.index_add_(2, ids64, x_st))
    del x_st, lib_buf
    span = set()
    for b0 in starts:
        span.update(range(b0, b0 + nbw))
    p_n, s_n, ngt = planes.shape[0], cnts.shape[0], lay.ngt
    gms_bytes = ((p_n + 1) * s_n * len(span) * 4 + nbytes(
        mask, b_lo, planes, lay.order, lay.offsets, got[0], got[1]))
    bnd, by = bound_ms(gms_bytes, B * (p_n + 1) * s_n * nbw)
    log(f"kernel group_merge_stacked[B={B}, masked, [{p_n},{s_n},{nb}] "
        f"window {nbw} -> {ngt}]: {ms:.4f} ms (16 solo group_merge_pair "
        f"launches "
        f"{solo_ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms "
        f"index_add_ over the stacked windows, bound {bnd:.4f} ms by {by}), "
        f"max_abs_err {err:.3g}; every member == its solo pair bit for bit "
        f"— {card}")
    results["group_merge_stacked"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        max_abs_err=err, solo_pairs_ms=solo_ms)
    ms_u = time_ms(lambda: gk.group_merge_stacked(*args))
    err_u = max(max_err(a, b, exact=True) for a, b in zip(
        gk.group_merge_stacked(*args),
        gk.group_merge_stacked_plain(*args)[:1]))
    log(f"kernel group_merge_stacked[B={B}, unmasked]: {ms_u:.4f} ms, "
        f"counts max_abs_err {err_u:.3g} — {card}")
    ms_m = time_ms(lambda: gk.series_mask(*margs))
    plain_m = time_ms(lambda: gk.series_mask_plain(*margs), reps=5)
    bnd_m, by_m = bound_ms(nbytes(codes, lut, *margs[2:5], got_m), 0)
    log(f"kernel series_mask[B={B}, {codes.shape[0]} tag(s) x "
        f"{codes.shape[1]} series, {lut.shape[0]} table entries of "
        f"{offsets.shape[0]} members]: {ms_m:.4f} ms (plain {plain_m:.4f} "
        f"ms, library null ms — no one call, bound {bnd_m:.4f} ms by "
        f"{by_m}), max_abs_err {err_m:.3g} — {card}")
    results["series_mask"] = dict(ms=ms_m, plain_ms=plain_m, bound_ms=bnd_m,
                                  bound_by=by_m, library_ms=None,
                                  max_abs_err=err_m)
    # the profiled run's own batches: their kernels' CUDA-event times at
    # the captured batch sizes, times the launches of that run
    real = {k: time_ms(lambda a=captured[k]: (
        real_gms if k != "mask" else real_mask)(*a[0], **(a[1] or {})))
        for k in ("gms", "gms_masked", "mask")}
    est = {"stacked": prof_launches[0] / 2 * (
               real["gms"] + real["gms_masked"]) / 2,
           "series_mask": prof_launches[1] * real["mask"]}
    log(f"serving: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"({100 * busy_ms / wall_ms:.2f} %) over one batched run "
        f"({nq} queries); the two kernels per the profiler: stacked "
        f"{kern_prof['stacked']:.3f} ms, series_mask "
        f"{kern_prof['series_mask']:.3f} ms; per their CUDA-event times at "
        f"the captured batches (B = {captured['gms'][2]} / "
        f"{captured['gms_masked'][2]}: {real['gms']:.4f} / "
        f"{real['gms_masked']:.4f} ms; series_mask {real['mask']:.4f} ms) "
        f"x launches ({prof_launches[0]}, {prof_launches[1]}): stacked "
        f"~{est['stacked']:.3f} ms, series_mask ~{est['series_mask']:.3f} "
        f"ms — {card}")
    log(f"serving phase: {time.perf_counter() - t_phase:.3f} s")
    return launches, results


# ---------------------------------------------------------------------------
# phase 11: the raw scan's device top-k on phase 3's table
# ---------------------------------------------------------------------------

TOPK_WARM = 5


def composite_key(tk, keys, mask):
    """The top-k's sort key packed into one int64 (the invalid flag, then
    each key word's offset from its least valid value), or None when the
    words' spans need more than 63 bits: what one torch.sort can take."""
    words = [w for v, asc, nf in keys for w in tk.sort_words(v, asc, nf)]
    comp = torch.zeros(mask.shape[0], dtype=torch.int64, device=mask.device)
    shift = 0
    for w in reversed(words):
        valid = w[mask]
        lo = int(valid.min()) if valid.numel() else 0
        span = int(valid.max()) - lo if valid.numel() else 0
        comp |= torch.where(mask, w - lo, 0) << shift
        shift += span.bit_length()
    comp |= (~mask).to(torch.int64) << shift
    return comp if shift + 1 <= 63 else None


def phase_topk(tk, db, ctx: dict, card: str):
    """Three ORDER BY ... LIMIT queries through db.sql on phase 3's table
    (cold once, warm TOPK_WARM times), each equal row for row to a numpy
    stable lexsort of the f32 values the device holds, served by the device
    top-k with only k rows to the host; then topk_select timed at the three
    queries' shapes against its plain version and one torch.sort."""
    from greptimedb_tpu_torch.query import physical

    user, system = ctx["stats"]["user"], ctx["stats"]["system"]
    steps = user.shape[0]
    # the resident table's row order: (tsid, ts), tsid = host index
    user_flat = np.ascontiguousarray(user.T).reshape(-1)
    system_flat = np.ascontiguousarray(system.T).reshape(-1)

    def ts_of(r):
        return T0 + (r % steps) * STEP_S * 1000

    def row_of(r, value):
        return [f"host_{r // steps}", int(ts_of(r)), float(value)]

    want_j = []
    for s in range(steps - 1, -1, -1):
        for h in np.nonzero(user[s] > 90.0)[0][:10 - len(want_j)]:
            want_j.append(int(h) * steps + s)
        if len(want_j) == 10:
            break
    vk_ = np.partition(user_flat, -100)[-100]
    cand = np.nonzero(user_flat >= vk_)[0]
    want_k = cand[np.lexsort((ts_of(cand), -user_flat[cand]))][:100]
    vl = np.partition(system_flat, 65_535)[65_535]
    cand = np.nonzero(system_flat <= vl)[0]
    want_l = cand[np.lexsort((ts_of(cand), system_flat[cand]))][
        64_536:65_536]
    ties_k = int((user_flat == user_flat[want_k[-1]]).sum())
    queries = {
        "j": ("SELECT * FROM cpu WHERE usage_user > 90 ORDER BY ts DESC "
              "LIMIT 10", 10, [row_of(r, user_flat[r]) for r in want_j],
              ("hostname", "ts", "usage_user")),
        "k": ("SELECT hostname, ts, usage_user FROM cpu "
              "ORDER BY usage_user DESC, ts LIMIT 100", 100,
              [row_of(r, user_flat[r]) for r in want_k], None),
        "l": ("SELECT hostname, ts, usage_system FROM cpu "
              "ORDER BY usage_system, ts LIMIT 1000 OFFSET 64536", 65_536,
              [row_of(r, system_flat[r]) for r in want_l], None),
    }
    log(f"top-k: (k)'s 100th value {float(user_flat[want_k[-1]])} ties "
        f"{ties_k:,} rows; (l)'s rows all hold usage_system "
        f"{sorted({r[2] for r in queries['l'][2]})[:3]}")
    tk.reset_launch_counts()
    before = physical.DISPATCH_STATS["topk"]
    report = {}
    for name, (sql, k, want, pick) in queries.items():

        def check(res, want=want, pick=pick, name=name):
            rows = res.rows
            if pick is not None:
                idx = [res.column_names.index(c) for c in pick]
                rows = [[r[i] for i in idx] for r in rows]
            if rows != want:
                bad = next(i for i, (a, b) in enumerate(zip(rows, want))
                           if a != b) if len(rows) == len(want) else -1
                raise AssertionError(f"top-k ({name}): {len(rows)} rows, "
                                     f"first difference at {bad}")
            return "equal row for row to numpy's stable lexsort"

        report[name] = timed_query(db, sql, card, f"{name} top-k", check,
                                   reps=TOPK_WARM)
        if report[name]["rows_to_host"] != k:
            raise AssertionError(f"top-k ({name}): "
                                 f"{report[name]['rows_to_host']} rows to "
                                 f"the host, want {k}")
    runs = physical.DISPATCH_STATS["topk"] - before
    launches = {"topk_select": tk.topk_select.launches}
    log(f"top-k path: launches {launches}, {runs} raw scans took the top-k")
    if launches["topk_select"] <= 0 or runs <= 0:
        raise AssertionError("topk_select never launched on the top-k path")

    # the kernel at the three queries' shapes, on the resident table
    table = db.cache.get(db._region_of("cpu"))
    cols, rm = table.columns, table.row_mask
    shapes = {
        "j": ([(cols["ts"], False, None)], rm & (cols["usage_user"] > 90),
              10),
        "k": ([(cols["usage_user"], False, None), (cols["ts"], True, None)],
              rm, 100),
        "l": ([(cols["usage_system"], True, None), (cols["ts"], True, None)],
              rm, 65_536),
    }
    out = {}
    for name, (keys, mask, k) in shapes.items():
        got, gn = tk.topk_select(keys, mask, k)
        want, wn = tk.topk_select_plain(keys, mask, k)
        if gn != wn or not torch.equal(got, want):
            raise AssertionError(f"topk_select ({name}) differs from its "
                                 f"plain version")
        ms = time_ms(lambda: tk.topk_select(keys, mask, k))
        plain = time_ms(lambda: tk.topk_select_plain(keys, mask, k), reps=5)
        comp = composite_key(tk, keys, mask)
        lib, same = None, None
        if comp is not None:
            def lib_fn():
                return torch.index_select(
                    comp, 0, torch.sort(comp, stable=True).indices[:k])
            lib = time_ms(lib_fn)
            same = torch.equal(torch.sort(comp, stable=True).indices[:k],
                               want)
        bnd, by = bound_ms(nbytes(mask, *[v for v, _a, _n in keys])
                           + k * 8, 0)
        lib_s = "null" if lib is None else f"{lib:.4f}"
        log(f"kernel topk_select[({name}) {len(keys)} key(s), "
            f"{mask.shape[0]:,} rows, k = {k:,}]: {ms:.4f} ms (plain "
            f"{plain:.4f} ms, library {lib_s} ms: torch.sort(stable=True) + "
            f"index_select of one packed int64 key, same rows {same}; bound "
            f"{bnd:.4f} ms by {by}), max_abs_err 0 — {card}")
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=lib, max_abs_err=0.0)
        del comp
    main = dict(out["k"])
    for name in ("j", "l"):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            main[f"{name}_{key}"] = out[name][key]
    return launches, {"topk_select": main}


# ---------------------------------------------------------------------------
# phase 13: the mesh row path (K20) on phase 3's table
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_WARM = 5
MESH_CACHE_BYTES = 32 << 30  # the sharded copy beside the resident table
UDD_REL = 0.02   # tests/test_parallel.py test_sketch_states_on_mesh
HLL_REL = 0.02   # the mean over the hosts (see check_o)


def _sorted_rows(rows, nkeys: int):
    return sorted(rows, key=lambda r: tuple(r[:nkeys]))


def phase_mesh(mk, sk, shk, db, ctx: dict, hours: int, card: str):
    """The mesh row path on phase 3's open db: a mesh of MESH_SHARDS
    shards on the one card, GREPTIME_GRID=off so the engine's route order
    sends the aggregates to the mesh: (m) 12 h double-groupby-all (10 x
    avg by hostname and hour, 48,000 groups), (n) last_value / first_value
    / max / count(*) by hostname, (o) hll + uddsketch_state by hostname,
    (p) a global count/min/max WHERE usage_user > 90, each cold once and
    warm MESH_WARM times.  Sums and means within the golden bound of the
    row path's (GREPTIME_MESH=off), counts and min/max equal to it,
    first/last equal to numpy over the f64 host values, the sketch states
    equal to the plain route on a CPU copy of one hour's shards and their
    estimates within 2 % of the row path's; then mesh_merge timed at
    (m)'s partials."""
    from greptimedb_tpu_torch.ops import sketch as shost
    from greptimedb_tpu_torch.parallel import dist
    from greptimedb_tpu_torch.query.parser import parse_sql

    stats = ctx["stats"]
    region = db._region_of("cpu")
    view = db._table_view("cpu")
    cap0 = db.cache.capacity
    db.cache.capacity = max(cap0, MESH_CACHE_BYTES)
    log(f"mesh: {MESH_SHARDS} shards on cuda:0, GREPTIME_GRID=off; the "
        f"region cache's budget raised to {db.cache.capacity:,} B for the "
        f"phase (the sharded copy beside the resident table)")
    os.environ["GREPTIME_GRID"] = "off"
    db.mesh = dist.create_mesh(MESH_SHARDS, device=torch.device("cuda", 0))
    try:
        t0 = time.perf_counter()
        st = db.cache.get_sharded(view)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(f"mesh: shard build {build_s:.3f} s, {st.nbytes():,} B on the "
            f"card ({st.rows_per_shard:,} rows a shard, pow2-padded, f64 "
            f"fields in f64), torch.cuda.memory_allocated() "
            f"{torch.cuda.memory_allocated()} B")

        def row_path(sql):
            os.environ["GREPTIME_MESH"] = "off"
            try:
                return db.sql(sql)
            finally:
                os.environ.pop("GREPTIME_MESH")

        avgs = ", ".join(f"avg({m})" for m in METRICS)
        hot = stats["hot_count"].sum()
        sqls = {
            "m": ctx["a_sql"],
            "n": ("SELECT hostname, last_value(usage_user), "
                  "first_value(usage_idle), max(usage_system), count(*) "
                  "FROM cpu GROUP BY hostname"),
            "o": ("SELECT hostname, hll(usage_user) AS h, "
                  "uddsketch_state(128, 0.01, usage_user) AS u FROM cpu "
                  "GROUP BY hostname"),
            "p": ("SELECT count(*), min(usage_user), max(usage_user) FROM "
                  "cpu WHERE usage_user > 90"),
        }
        assert avgs in sqls["m"]
        want = {k: row_path(q) for k, q in sqls.items()}

        def check_m(res):
            got, ref = (_sorted_rows(r.rows, 2) for r in (res, want["m"]))
            if len(got) != SCALE * ctx["window_h"] or len(got) != len(ref):
                raise AssertionError(f"mesh (m): {len(got)} rows")
            worst = 0.0
            for a, b in zip(got, ref):
                if a[:2] != b[:2]:
                    raise AssertionError(f"mesh (m): keys {a[:2]} {b[:2]}")
                for x, y in zip(a[2:], b[2:]):
                    d = abs(x - y)
                    if d > REL_TOL * max(1.0, abs(y)):
                        raise AssertionError(f"mesh (m): {a} vs {b}")
                    worst = max(worst, d)
            return (f"means within the golden bound of the row path's (max "
                    f"|diff| {worst:.3g})")

        def check_n(res):
            got, ref = (_sorted_rows(r.rows, 1) for r in (res, want["n"]))
            if len(got) != SCALE or len(ref) != SCALE:
                raise AssertionError(f"mesh (n): {len(got)} rows")
            for a, b in zip(got, ref):
                h = int(a[0].split("_")[1])
                if a[1] != float(stats["last64"][h, 0]) or (
                        a[2] != float(stats["first64"][h, 2])):
                    raise AssertionError(f"mesh (n): first/last {a}")
                if a[3] != b[3] or a[4] != b[4] or a[4] != hours * 360:
                    raise AssertionError(f"mesh (n): {a} vs {b}")
            return ("first/last equal to numpy's f64 host values, max and "
                    "count equal to the row path's")

        est = {}

        def check_o(res):
            got, ref = (_sorted_rows(r.rows, 1) for r in (res, want["o"]))
            if len(got) != SCALE or [r[0] for r in got] != [
                    r[0] for r in ref]:
                raise AssertionError(f"mesh (o): {len(got)} rows")
            hll, udd = [], 0.0
            for a, b in zip(got, ref):
                ea = shost.hll_estimate(shost.decode_hll(a[1]))
                eb = shost.hll_estimate(shost.decode_hll(b[1]))
                hll.append(abs(ea - eb) / eb)
                for q in (0.5, 0.9, 0.99):
                    qa = shost.udd_quantile(a[2], q)
                    qb = shost.udd_quantile(b[2], q)
                    udd = max(udd, abs(qa - qb) / max(abs(qb), 1e-300))
            # the mesh hashes the f64 host values, the row path the f32
            # device values: two independent HLL estimates of nearly one
            # set, each off by ~1.6 % (1.04 / sqrt(4096)), so a host's two
            # estimates differ by ~2.3 % (one sigma) and the worst of
            # 4,000 by several sigma.  The mean over the hosts is held
            hll_mean, hll_max = float(np.mean(hll)), float(np.max(hll))
            if hll_mean > HLL_REL or udd > UDD_REL:
                raise AssertionError(f"mesh (o): estimates apart: HLL mean "
                                     f"{hll_mean:.4g}, UDD {udd:.4g}")
            est.update(hll_mean=hll_mean, hll_max=hll_max, udd_max=udd)
            return (f"HLL estimates {hll_mean:.3%} apart from the row "
                    f"path's on average (worst host {hll_max:.3%}), UDD "
                    f"quantiles (0.5, 0.9, 0.99) within {udd:.3%}")

        def check_p(res):
            # the mesh compares the f64 host values with 90, the row path
            # their f32 device copies: values just above 90 that round to
            # 90.0 in f32 count on the mesh only
            n64, lo64, hi64, edge = stats["hot64"]
            ref = want["p"].rows[0]
            got = res.rows[0]
            if got != [n64, float(np.float32(lo64)), float(np.float32(hi64))]:
                raise AssertionError(f"mesh (p): {got} vs numpy's f64 "
                                     f"{[n64, lo64, hi64]}")
            if ref[0] != hot or got[0] != hot + edge or got[2] != ref[2]:
                raise AssertionError(f"mesh (p): {got} vs the row path's "
                                     f"{ref} ({edge} values round to 90.0)")
            return (f"{n64:,} rows over 90 and their min/max (as f32) equal "
                    f"to numpy over the f64 host values; the row path's "
                    f"f32 copies count {hot:,}: {edge} values above 90 "
                    f"round to 90.0 in f32")

        mk.reset_launch_counts()
        sk.reset_launch_counts()
        shk.reset_launch_counts()
        coll = dist.M_MESH_COLLECTIVE.labels(str(MESH_SHARDS), "execute")
        c_sum0, c_n0 = coll.sum, coll.total
        report = {}
        for name, check in (("m", check_m), ("n", check_n), ("o", check_o),
                            ("p", check_p)):
            report[name] = timed_query(db, sqls[name], card,
                                       f"({name}) mesh", check,
                                       reps=MESH_WARM)
            if not report[name]["mesh_rows"]:
                raise AssertionError(f"mesh ({name}): not the mesh route")
        take_shapes("segment_reduce", sk.segment_reduce)
        launches = {"mesh_merge": mk.mesh_merge.launches,
                    "segment_reduce": sk.segment_reduce.launches,
                    "hll_fold": shk.hll_fold.launches,
                    "udd_fold": shk.udd_fold.launches}
        coll_ms = (coll.sum - c_sum0) * 1e3 / max(coll.total - c_n0, 1)
        log(f"mesh path: launches {launches}; collectives span (local "
            f"partials, copies, merges) {coll_ms:.3f} ms a query on average "
            f"over {coll.total - c_n0} warm queries")
        for kname, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{kname} never launched on the mesh "
                                     f"path")
        # the row path's times on the same queries, for comparison
        os.environ["GREPTIME_MESH"] = "off"
        try:
            row_report = {name: timed_query(
                db, sql, card, f"({name}) row path, GREPTIME_MESH=off",
                lambda res, name=name: (
                    "equal to its first run" if res.rows == want[name].rows
                    else "differs"), reps=MESH_WARM)
                for name, sql in sqls.items()}
        finally:
            os.environ.pop("GREPTIME_MESH")

        # the sketch states against the plain route: one hour's shards on
        # the CPU, the same shard assignment and rows as the card's
        h = hours // 2
        lo, hi = T0 + h * 3_600_000, T0 + (h + 1) * 3_600_000
        o_hour = (sqls["o"].replace(" GROUP BY", f" WHERE ts >= {lo} AND "
                                    f"ts < {hi} GROUP BY"))
        card_rows = db.sql(o_hour).rows
        cpu_mesh = dist.create_mesh(MESH_SHARDS, device="cpu")
        t0 = time.perf_counter()
        cpu_tab = dist.shard_region(view, cpu_mesh, ts_range=(lo, hi))
        names, cpu_rows = dist.execute_select_on_mesh(
            dist.DistAggExecutor(cpu_mesh), cpu_tab, parse_sql(o_hour)[0],
            db.table_context("cpu"), view.ts_bounds())
        cpu_s = time.perf_counter() - t0
        if _sorted_rows(cpu_rows, 1) != _sorted_rows(card_rows, 1):
            raise AssertionError("mesh (o): the card's sketch states differ "
                                 "from the plain route's")
        log(f"mesh (o) over hour {h} (a 1-hour range bounds the CPU time): "
            f"{len(card_rows):,} HLL and UDD states equal to the plain "
            f"route's on a CPU copy of the shards ({cpu_s:.1f} s on the "
            f"CPU)")

        # every merge of the four queries, captured from one more run of
        # each, against its plain version; then the kernel timed at (m)'s
        # partials
        captured = []
        merge, pick = mk.mesh_merge, mk.mesh_pick

        def capture(parts, op):
            captured.append(("merge", (parts.clone(), op)))
            return merge(parts, op)

        def capture_pick(ts, has, vals, last):
            captured.append(("pick", (ts.clone(), has.clone(), vals.clone(),
                                      last)))
            return pick(ts, has, vals, last)

        capture.launches = 0
        mk.mesh_merge, mk.mesh_pick = capture, capture_pick
        try:
            db.sql(sqls["m"])
            m_calls = len(captured)
            for name in ("n", "o", "p"):
                db.sql(sqls[name])
        finally:
            mk.mesh_merge, mk.mesh_pick = merge, pick
        err, modes = 0.0, set()
        for kind, args in captured:
            if kind == "pick":
                got, want = pick(*args), mk.mesh_pick_plain(*args)
                modes.add(f"pick {args[2].dtype}")
            else:
                got, want = (merge(*args),), (mk.mesh_merge_plain(*args),)
                modes.add(f"{args[1]} {args[0].dtype}")
            for g_, w_ in zip(got, want):
                err = max(err, max_err(g_, w_, exact=True))
        log(f"mesh_merge: {len(captured)} merges of (m), (n), (o), (p) equal "
            f"to their plain versions; modes {sorted(modes)}")
        parts, op = max((a for k, a in captured[:m_calls] if k == "merge"),
                        key=lambda a: a[0].numel())
        ms = time_ms(lambda: merge(parts, op))
        plain = time_ms(lambda: mk.mesh_merge_plain(parts, op))
        lib = time_ms(lambda: parts.sum(0) if op == "sum" else parts.amax(0))
        out = merge(parts, op)
        bnd, by = bound_ms(nbytes(parts, out), parts.numel())
        log(f"kernel mesh_merge[{op} of (m)'s {list(parts.shape)} "
            f"{parts.dtype} partials; {m_calls} merges in (m)]: "
            f"{ms:.4f} ms (plain {plain:.4f} ms, library {lib:.4f} ms: "
            f"torch {'sum' if op == 'sum' else 'amax'}(0) of the stacked "
            f"partials; bound {bnd:.4f} ms by {by}), max_abs_err {err:.3g} — "
            f"{card}")
        def summary(rep):
            return {k: (round(v["first_ms"], 3), round(v["warm_median_ms"], 3),
                        round(v["busy_ms"], 3), round(v["wall_ms"], 3))
                    for k, v in rep.items()}

        log(f"mesh queries (first ms, warm median ms, device busy ms, wall "
            f"ms): mesh {summary(report)}; row path {summary(row_report)}; "
            f"estimates apart {est}")
        return launches, {"mesh_merge": dict(
            ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
            library_ms=lib, max_abs_err=err)}
    finally:
        os.environ.pop("GREPTIME_GRID", None)
        db.mesh = None  # drops the sharded table
        db.cache.capacity = cap0


# ---------------------------------------------------------------------------
# phase 12: exact vector search (K22)
# ---------------------------------------------------------------------------

VECTORS = 131_072    # an eighth of SIFT1M's 1,000,000 base vectors
VEC_DIM = 128        # ann-benchmarks sift-128-euclidean
VEC_CATS = 64
COS_BOUND = 1e-6     # |cos distance - numpy f64|: sums exact, 5 roundings


def phase_vectors(vk, vectors: int, seed: int, card: str):
    """A fresh db: items (cat, ts, id, emb VECTOR(128)), one row per
    distinct integer-valued vector (0..127 components, SIFT's shape, from
    --seed); k-NN by L2^2, cosine and dot product (LIMIT 10, the host
    evaluator's path) and a range count (WHERE, the device compile path)
    through db.sql, each checked against numpy; then vec_distance timed on
    the table's own [D, 128] matrix."""
    from greptimedb_tpu_torch.query.exprs import _parse_vec
    from greptimedb_tpu_torch.standalone import GreptimeDB
    from greptimedb_tpu_torch.storage.region import RegionOptions

    log(f"cut: {vectors:,} distinct vectors instead of SIFT1M's 1,000,000 "
        f"(every query re-parses each distinct vector's text on the host, "
        f"as the reference does)")
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 128, (vectors, VEC_DIM), dtype=np.int64)
    qv = rng.integers(0, 128, VEC_DIM, dtype=np.int64)
    words = np.array([str(i) for i in range(128)], dtype=object)
    t0 = time.perf_counter()
    texts = np.array(["[" + ",".join(r) + "]" for r in words[M].tolist()],
                     dtype=object)
    q = "[" + ",".join(str(int(x)) for x in qv) + "]"
    l2 = ((M - qv) ** 2).sum(1)
    dot = M @ qv
    cos = 1.0 - dot / np.maximum(np.linalg.norm(M, axis=1)
                                 * np.linalg.norm(qv), 1e-30)
    radius = int(np.sort(l2)[vectors // 100])
    log(f"vectors: generated {vectors:,} x {VEC_DIM} in "
        f"{time.perf_counter() - t0:.3f} s; range radius {radius} "
        f"({int((l2 < radius).sum()):,} rows inside)")
    home = tempfile.mkdtemp(prefix="chip_smoke_vec_")
    db = None
    try:
        db = GreptimeDB(home, region_options=RegionOptions(
            wal_enabled=False, flush_threshold_bytes=1 << 40))
        db.sql(f"CREATE TABLE items (cat STRING, ts TIMESTAMP(3) TIME INDEX,"
               f" id BIGINT, emb VECTOR({VEC_DIM}), PRIMARY KEY (cat))")
        ids = np.arange(vectors, dtype=np.int64)
        cats = np.array([f"cat_{i}" for i in range(VEC_CATS)], dtype=object)
        t0 = time.perf_counter()
        db._region_of("items").write({
            "cat": cats[ids % VEC_CATS], "ts": T0 + ids, "id": ids,
            "emb": texts})
        log(f"vectors: {vectors:,} rows written in "
            f"{time.perf_counter() - t0:.3f} s")

        def knn(values, desc):
            order = np.argsort(-values if desc else values, kind="stable")
            return values[order[:10]], values[order[10]]

        def exact_check(values, desc):
            want, _next = knn(values, desc)

            def check(res):
                got = values[[r[0] for r in res.rows]]
                if len(res.rows) != 10 or not np.array_equal(got, want):
                    raise AssertionError(f"k-NN: {got} vs {want}")
                return "the 10 distances equal numpy's exactly"
            return check

        def cos_check(res):
            want, nxt = knn(cos, False)
            got_ids = [r[0] for r in res.rows]
            err = float(np.abs(cos[got_ids] - want).max())
            if len(res.rows) != 10 or err > COS_BOUND:
                raise AssertionError(f"cos k-NN: |diff| {err}")
            same = "not needed (a tie at the 10th)"
            if nxt - want[-1] > COS_BOUND:
                if set(got_ids) != set(np.argsort(cos, kind="stable")[:10]
                                       .tolist()):
                    raise AssertionError("cos k-NN: other ids")
                same = "the same ids"
            return (f"distances within {COS_BOUND} of numpy (max "
                    f"{err:.3g}), {same}")

        def count_check(res):
            want = int((l2 < radius).sum())
            if res.rows != [[want]]:
                raise AssertionError(f"range: {res.rows} vs {want}")
            return f"{want:,} rows, exact"

        queries = {
            "m": (f"SELECT id FROM items ORDER BY vec_l2sq_distance(emb, "
                  f"'{q}') LIMIT 10", exact_check(l2, False)),
            "n": (f"SELECT id FROM items ORDER BY vec_cos_distance(emb, "
                  f"'{q}') LIMIT 10", cos_check),
            "o": (f"SELECT id FROM items ORDER BY vec_dot_product(emb, "
                  f"'{q}') DESC LIMIT 10", exact_check(dot, True)),
            "p": (f"SELECT count(*) FROM items WHERE vec_l2sq_distance(emb,"
                  f" '{q}') < {radius}", count_check),
        }
        vk.reset_launch_counts()
        log("cut: one warm run of query m only (each run re-parses every "
            "distinct vector's text on the host, 4-7 s; the time limit)")
        for name, (sql, check) in queries.items():
            before = vk.vec_distance.launches
            runs = 2 if name == "m" else 1
            db.stage_sink = {} if runs == 1 else None
            t0 = time.perf_counter()
            res = db.sql(sql)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            detail = check(res)
            warm = ""
            if runs == 2:
                db.stage_sink = {}
                t0 = time.perf_counter()
                db.sql(sql)
                torch.cuda.synchronize()
                warm = (f", warm {(time.perf_counter() - t0) * 1e3:.3f} ms "
                        f"(1 run)")
            stages = {k: v for k, v in db.stage_sink.items()
                      if k.endswith("_ms")}
            db.stage_sink = None
            if vk.vec_distance.launches - before != runs:
                raise AssertionError(f"vector query {name}: "
                                     f"{vk.vec_distance.launches - before} "
                                     f"vec_distance launches in {runs} runs")
            log(f"query {name} vectors: {detail}; first {first_ms:.3f} ms"
                f"{warm}; stages {stages} — {card}")
        launches = {"vec_distance": vk.vec_distance.launches}
        log(f"vector path: launches {launches}")

        # the kernel on the table's own distinct vectors
        table = db.cache.get(db._region_of("items"))
        vocab = table.dicts["emb"]
        t0 = time.perf_counter()
        parsed = [_parse_vec(str(t)) for t in vocab]
        parse_s = time.perf_counter() - t0
        mat = torch.from_numpy(np.stack(parsed)).cuda()
        valid = torch.ones(mat.shape[0], dtype=torch.bool, device=mat.device)
        qd = torch.from_numpy(np.asarray(qv, dtype=np.float32)).cuda()
        out = {}
        for name in ("vec_l2sq_distance", "vec_dot_product",
                     "vec_cos_distance"):
            got = vk.vec_distance(mat, valid, qd, name)
            want = vk.vec_distance_plain(mat, valid, qd, name)
            cos_op = name == "vec_cos_distance"
            err = max_err(got, want, exact=not cos_op, rel_tol=0.0,
                          abs_tol=COS_BOUND if cos_op else 0.0)
            ms = time_ms(lambda: vk.vec_distance(mat, valid, qd, name))
            plain = time_ms(lambda: vk.vec_distance_plain(mat, valid, qd,
                                                          name))
            lib = time_ms(lambda: torch.mv(mat, qd))
            dev_ms = graph_ms(lambda: vk.vec_distance(mat, valid, qd, name))
            dev_lib = graph_ms(lambda: torch.mv(mat, qd))
            bnd, by = bound_ms(nbytes(mat, valid, qd, got),
                               3 * mat.shape[0] * mat.shape[1])
            log(f"kernel vec_distance[{name}, {tuple(mat.shape)}]: "
                f"{ms:.4f} ms (plain {plain:.4f} ms, library {lib:.4f} ms: "
                f"torch.mv; bound {bnd:.4f} ms by {by}), max_abs_err "
                f"{err:.3g}; device time alone (CUDA graph of 20 calls) "
                f"{dev_ms:.4f} ms, torch.mv's {dev_lib:.4f} ms; the host "
                f"parse of the {len(vocab):,} distinct vectors that every "
                f"query runs first: {parse_s:.3f} s — {card}")
            out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                             bound_by=by, library_ms=lib, max_abs_err=err,
                             graph_ms=dev_ms, library_graph_ms=dev_lib)
        main = dict(out["vec_l2sq_distance"])
        main["max_abs_err"] = max(o["max_abs_err"] for o in out.values())
        for name, tag in (("vec_dot_product", "dot"),
                          ("vec_cos_distance", "cos")):
            for key in ("ms", "plain_ms", "graph_ms"):
                main[f"{tag}_{key}"] = out[name][key]
        main["host_parse_ms"] = parse_s * 1e3
        if launches["vec_distance"] <= 0:
            raise AssertionError("vec_distance never launched on the "
                                 "vector path")
        return launches, {"vec_distance": main}
    finally:
        if db is not None:
            db.close()
        shutil.rmtree(home, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: write then query (K23 extend_merge, K24 grid_scatter), on the
# dbs of phases 3, 4 and 9 once their other phases are done
# ---------------------------------------------------------------------------

def cache_event(kind: str, event: str) -> int:
    """The region cache's event counter (``greptime_cache_events_total``)
    for one kind of resident table."""
    from greptimedb_tpu_torch.utils.telemetry import REGISTRY

    return int(REGISTRY.value("greptime_cache_events_total",
                              ("region_device", kind, event)))


def log_memory(label: str) -> None:
    torch.cuda.synchronize()
    log(f"{label}: torch.cuda.memory_allocated() "
        f"{torch.cuda.memory_allocated()} B")


def timed_first(fn):
    """(fn(), its ms on the host clock up to a synchronize)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def tsbs_window_sql(first_hour: int) -> str:
    """Query (a)'s shape over the 12 hours from ``first_hour``."""
    avgs = ", ".join(f"avg({m})" for m in METRICS)
    lo = T0 + first_hour * 3_600_000
    return (f"SELECT hostname, date_trunc('hour', ts) AS hour, {avgs} FROM "
            f"cpu WHERE ts >= {lo} AND ts < {lo + 12 * 3_600_000} GROUP BY "
            f"hostname, hour")


def write_query_tsbs(stk, db, ctx: dict, hours: int, has_arrow: bool,
                     card: str):
    """(i) on phase 3's db: hour ``hours`` of the walk (1.44 M rows)
    through servers.ingest.ingest_columns, whose hot tail extends the
    resident grid; query (a)'s shape over the last 12 h on the grid and
    (d)'s (GREPTIME_GRID=off) over the DeviceTable, which extends; both
    against numpy.  Then hour ``hours + 1`` with the extend thresholds at
    0 (the DeviceTable rebuilds) and the grid entry evicted (it rebuilds:
    the thresholds do not govern grid extends, as in the reference), the
    first-query times side by side.  Then a flush, after which the grid
    must catch up and stay the resident table; then ``CATCH_UP_STEPS``
    steps of hour ``hours + 2`` through region.write (no hot tail) and a
    flush, from which the grid must catch up through grid_scatter, the
    new cells equal to the values written (``catch_up_tsbs``).  Returns
    (launches, the inputs of the extend's kernels for timing)."""
    from greptimedb_tpu_torch.servers.ingest import ingest_columns
    from greptimedb_tpu_torch.utils.tracing import TRACER

    region = db._region_of("cpu")
    cache = db.cache
    stats = ctx["stats"]
    sums = stats["sum"]
    table0, t_ms = timed_first(lambda: cache.get(region))
    grid0 = cache.get_grid(region)
    tags0 = table0.sorted_tags
    log(f"write-then-query TSBS: resident DeviceTable {table0.padded_rows:,}"
        f" padded rows (get {t_ms:.3f} ms), sorted_tags {tags0}; grid nt "
        f"{grid0.nt:,}, tpad {grid0.tpad:,}")
    stk.reset_launch_counts()
    first = {}
    captured = None
    keep = cache.min_extend_rows, cache.rebuild_fraction
    try:
        for hour, route in ((hours, "extend"), (hours + 1, "rebuild")):
            data, series = stats["next_hour"](hour)
            sums = np.concatenate(
                [sums, series.astype(np.float32).astype(np.float64).sum(
                    0)[None]])
            if route == "rebuild":
                # the grid leaves before the write, so the write is a plain
                # one (no hot tail into a grid that a rebuild then drops)
                cache.min_extend_rows, cache.rebuild_fraction = 0, 0.0
                cache._evict((region.region_id, "grid", region.base_version))
            events0 = {k: cache_event(*k) for k in (
                ("grid", "hot_tail"), ("grid", "extend"), ("grid", "miss"),
                ("table", "extend"), ("table", "miss"))}
            launches0 = (stk.extend_merge.launches,
                         stk.grid_scatter_steps.launches,
                         stk.grid_scatter.launches)
            pos0 = region.append_pos
            log_memory(f"write-then-query TSBS hour {hour} ({route}), "
                       f"before the write")
            TRACER.configure(enabled=True)
            mark = TRACER.mark()
            try:
                _n, ingest_ms = timed_first(lambda: ingest_columns(
                    db, "cpu", {**data, "__tags__": ["hostname"],
                                "__fields__": list(METRICS)}))
                tail_ms, split = 0.0, {}
                for sp in TRACER.since(mark):
                    ms_ = (sp["end_ns"] - sp["start_ns"]) / 1e6
                    if sp["name"] == "ingest_grid_tail":
                        tail_ms += ms_
                    elif sp["name"].startswith(("grid_extend.",
                                                "grid_scatter.")):
                        split[sp["name"]] = round(
                            split.get(sp["name"], 0.0) + ms_, 3)
            finally:
                TRACER.configure(enabled=False)
            if route == "extend":
                captured = (table0, grid0, region.append_chunks_since(pos0))
            sql = tsbs_window_sql(hour - 11)

            def want(host, h, sums=sums):
                return [(sums[h, host, j] / STEPS_PER_HOUR, False)
                        for j in range(len(METRICS))]

            db.stage_sink = {}
            res, grid_ms = timed_first(lambda: db.sql(sql))
            grid_scan = db.stage_sink.get("scan_cache_ms")
            worst = check_rows(f"(a) after hour {hour}", res.rows,
                               SCALE * 12, want)
            os.environ["GREPTIME_GRID"] = "off"
            db.stage_sink = {}
            try:
                res_d, row_ms = timed_first(lambda: db.sql(sql))
            finally:
                os.environ.pop("GREPTIME_GRID", None)
                row_scan = db.stage_sink.get("scan_cache_ms")
                db.stage_sink = None
            worst_d = check_rows(f"(d) after hour {hour}", res_d.rows,
                                 SCALE * 12, want)
            events = {k: cache_event(*k) - v for k, v in events0.items()}
            launched = (stk.extend_merge.launches - launches0[0],
                        stk.grid_scatter_steps.launches - launches0[1],
                        stk.grid_scatter.launches - launches0[2])
            table = cache.get(region)
            first[route] = (ingest_ms, grid_ms, row_ms)
            log(f"write-then-query TSBS hour {hour} ({route}): "
                f"{len(data['ts']):,} rows through ingest_columns in "
                f"{ingest_ms:.3f} ms (its ingest_grid_tail span {tail_ms:.3f}"
                f" ms; inside it, host ms {split}, the rest "
                f"{tail_ms - sum(split.values()):.3f}); first (a) on the "
                f"grid {grid_ms:.3f} ms (scan_cache "
                f"{grid_scan} ms), first (d) on the row path {row_ms:.3f} ms "
                f"(scan_cache {row_scan} ms); rows equal to "
                f"numpy (max |diff| {worst:.3g}, {worst_d:.3g}); cache events"
                f" {events}; extend_merge / grid_scatter_steps / grid_scatter"
                f" launches {launched}; DeviceTable "
                f"{table.padded_rows:,} padded rows, "
                f"sorted_tags {table.sorted_tags} — {card}")
            if route == "extend":
                # get_grid counts its extend before it tries one, and a
                # failed extend falls back to a rebuild: so no grid miss
                if events[("grid", "hot_tail")] + events[("grid",
                                                          "extend")] < 1 \
                        or events[("grid", "miss")]:
                    raise AssertionError(f"the grid did not extend: {events}")
                if events[("table", "extend")] != 1 or events[
                        ("table", "miss")]:
                    raise AssertionError(f"the DeviceTable did not extend: "
                                         f"{events}")
                # the hour arrives time-major, every host each step: the
                # hot tail's scatter is grid_scatter_steps
                if launched[:2] != (1, 1) or launched[2]:
                    raise AssertionError(
                        f"extend_merge / grid_scatter_steps / grid_scatter "
                        f"launched {launched}, want (1, 1, 0)")
                if table.sorted_tags != tags0:
                    raise AssertionError(f"sorted_tags {table.sorted_tags} "
                                         f"after the extend, {tags0} before")
            elif events[("table", "miss")] != 1 or events[("grid",
                                                           "miss")] != 1:
                raise AssertionError(f"the forced rebuild did not rebuild: "
                                     f"{events}")
            log_memory(f"write-then-query TSBS hour {hour} ({route}), after "
                       f"its queries")
    finally:
        cache.min_extend_rows, cache.rebuild_fraction = keep
    (ing_e, grid_e, row_e), (ing_r, grid_r, row_r) = (first["extend"],
                                                      first["rebuild"])
    log(f"write-then-query TSBS, first query after a {len(data['ts']):,}-row"
        f" write: grid "
        f"{grid_e:.3f} ms extended (hot tail in the write: {ing_e:.3f} ms) "
        f"vs {grid_r:.3f} ms rebuilt (write {ing_r:.3f} ms); row path "
        f"{row_e:.3f} ms extended vs {row_r:.3f} ms rebuilt — {card}")
    if has_arrow:
        resident = cache.get_grid(region)
        c0 = cache_event("grid", "catch_up")
        _meta, flush_ms = timed_first(region.flush)
        caught, get_ms = timed_first(lambda: cache.get_grid(region))
        if cache_event("grid", "catch_up") != c0 + 1 or caught is not \
                resident:
            raise AssertionError("the grid did not catch up after the flush")
        log(f"write-then-query TSBS: flush {flush_ms:.3f} ms, then get_grid "
            f"caught up in {get_ms:.3f} ms and kept the resident table — "
            f"{card}")
        catch_up_tsbs(stk, db, stats, hours + 2, caught, card)
    else:
        log("write-then-query TSBS: no pyarrow, no flush: catch-up not run")
    launches = {"extend_merge": stk.extend_merge.launches,
                "grid_scatter_steps": stk.grid_scatter_steps.launches,
                "grid_scatter": stk.grid_scatter.launches}
    log(f"write-then-query TSBS: launches {launches}")
    return launches, captured


def catch_up_tsbs(stk, db, stats, hour: int, resident, card: str) -> None:
    """The first ``CATCH_UP_STEPS`` steps of ``hour`` through region.write
    (which runs no hot tail) and a flush: get_grid must catch up from the
    new file (its cells in (tsid, ts) order) through one grid_scatter, and
    the grid must hold the written f32 values, valid, where they fall."""
    cache = db.cache
    region = db._region_of("cpu")
    data, series = stats["next_hour"](hour)
    n = CATCH_UP_STEPS * SCALE
    region.write({k: v[:n] for k, v in data.items()})
    c0 = cache_event("grid", "catch_up")
    l0 = stk.grid_scatter_steps.launches, stk.grid_scatter.launches
    _meta, flush_ms = timed_first(region.flush)
    caught, get_ms = timed_first(lambda: cache.get_grid(region))
    launched = (stk.grid_scatter_steps.launches - l0[0],
                stk.grid_scatter.launches - l0[1])
    t0 = (T0 + hour * STEPS_PER_HOUR * STEP_S * 1000 - caught.ts0) \
        // caught.step
    if (cache_event("grid", "catch_up") != c0 + 1 or caught is resident
            or launched != (0, 1) or resident.nt != t0
            or caught.nt != t0 + CATCH_UP_STEPS):
        raise AssertionError(f"the grid did not catch up {CATCH_UP_STEPS} "
                             f"steps through grid_scatter: launches "
                             f"{launched}, nt {resident.nt} -> {caught.nt}, "
                             f"want {t0} -> {t0 + CATCH_UP_STEPS}")
    enc = region.encoders["hostname"]
    tsids = torch.tensor([region._series[(enc.get(f"host_{i}"),)]
                          for i in range(SCALE)], device=caught.device)
    planes = [caught.field_names.index(m) for m in METRICS]
    got = caught.values[:, tsids, t0:t0 + CATCH_UP_STEPS].cpu()[planes]
    want = np.ascontiguousarray(np.transpose(
        series[:CATCH_UP_STEPS].astype(np.float32), (2, 1, 0)))
    if got.numpy().tobytes() != want.tobytes() or not bool(
            caught.valid[tsids, t0:t0 + CATCH_UP_STEPS].all()):
        raise AssertionError("the caught-up grid differs from the values "
                             "written")
    log(f"write-then-query TSBS: {n:,} rows ({CATCH_UP_STEPS} steps) "
        f"written and flushed in {flush_ms:.3f} ms, then get_grid caught up"
        f" in {get_ms:.3f} ms through grid_scatter (launches {launched}), "
        f"the new cells equal to the values written — {card}")


def extend_merge_timing(stk, sk, db, table0, chunks, card: str) -> dict:
    """K23 on the extend's own inputs (the resident table before the
    write, the write's chunks): equal to its plain version bit for bit;
    timed beside the plain version, the whole-table route (radix_argsort
    of the padded (pad flag, tsid, ts) key, then a gather of every
    column) and one library sort (torch.sort of the same key + the
    gathers), both of which must give the same table."""
    from greptimedb_tpu_torch.datatypes.batch import pad_rows
    from greptimedb_tpu_torch.storage import cache as pcache
    from greptimedb_tpu_torch.storage.memtable import TSID

    region = db._region_of("cpu")
    ts_name = region.schema.time_index.name
    _dicts, delta, pads, dn = pcache.device_delta(table0, region, chunks)
    n_old = int(table0.row_mask.sum())
    new_padded = max(pad_rows(n_old + dn), table0.padded_rows)
    old = dict(table0.columns)
    kw = dict(tsid=TSID, ts=ts_name)

    def run():
        return stk.extend_merge(old, n_old, delta, new_padded, pads,
                                region.num_series, **kw)

    got, got_mask = run()
    want, want_mask = stk.extend_merge_plain(old, n_old, delta, new_padded,
                                             pads, **kw)
    if not same_output({**got, "mask": got_mask},
                       {**want, "mask": want_mask}):
        raise AssertionError("extend_merge differs from its plain version")
    del want, want_mask
    # the whole-table route and the library sort, on the grown table
    grown, mask = stk.grown_table(old, n_old, delta, new_padded, pads)
    ts = grown[ts_name]
    lo = int(ts[:n_old + dn].min())
    tb = (int(ts[:n_old + dn].max()) - lo).bit_length()
    sb = max(region.num_series - 1, 0).bit_length()
    key = (((~mask).to(torch.int64) << (tb + sb))
           | (grown[TSID].to(torch.int64) << tb)
           | torch.where(mask, ts - lo, 0))
    del ts

    def gather(order):
        return ({k: torch.index_select(v, 0, order) for k, v in
                 grown.items()}, torch.index_select(mask, 0, order))

    def whole():
        return gather(sk.radix_argsort(key).long())

    def library():
        return gather(torch.sort(key, stable=True).indices)

    for name, fn in (("whole-table route", whole), ("library", library)):
        cols, m = fn()
        if not same_output({**got, "mask": got_mask}, {**cols, "mask": m}):
            raise AssertionError(f"extend_merge: the {name} differs")
        del cols, m
    ms = time_ms(run, reps=10)
    whole_ms = time_ms(whole, reps=5)
    lib = time_ms(library, reps=5)
    plain = time_ms(lambda: stk.extend_merge_plain(
        old, n_old, delta, new_padded, pads, **kw), reps=3)
    # the kernel reads the resident live rows of each column (not the pad
    # rows, which it writes from constants, nor the old row mask)
    moved = (n_old * sum(v.element_size() for v in old.values())
             + nbytes(*delta.values()) + nbytes(*got.values(), got_mask))
    bnd, by = bound_ms(moved, 0)
    log(f"kernel extend_merge[{len(old)} columns, {n_old:,} resident rows of "
        f"{table0.padded_rows:,} + a {dn:,}-row delta -> {new_padded:,} "
        f"padded rows; whole-table route (radix_argsort of the padded key, "
        f"{tb + sb + 1} bits, + index_select) {whole_ms:.4f} ms; library: "
        f"torch.sort(stable) of the same key + index_select]: {ms:.4f} ms "
        f"(plain {plain:.4f} ms, library {lib:.4f} ms, bound {bnd:.4f} ms "
        f"by {by}), max_abs_err 0 — {card}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, max_abs_err=0.0, whole_ms=whole_ms)


def grid_scatter_timing(stk, db, grid0, chunks, card: str):
    """K24 on the hot tail's own inputs (the resident grid before the
    write, the write's cells), on copies of the grid: grid_scatter_steps
    (the cells as ``step_cells`` finds them; its host time is the
    detection the write pays), grid_scatter on the same time-major cells
    and on a catch-up-shaped input (the same cells in (tsid, ts) order,
    as an SST part holds them), each equal to the plain version
    (index_put_) bit for bit; timed beside the plain versions, index_put_
    on each plane, one index_put_ over all planes + one on valid, and the
    hot tail's grid copy (``_writable``: a clone of both tensors).
    Returns the kernels-line numbers of (grid_scatter_steps,
    grid_scatter); each bound counts the bytes its own inputs need: the
    series sequence and the steps for the first, two int64 indices a cell
    for the second."""
    from greptimedb_tpu_torch.storage import grid as pgrid

    region = db._region_of("cpu")
    tsid, tidx, cols, _nt = pgrid.append_cells(grid0, region, chunks)
    detect = []
    for _ in range(5):
        t0 = time.perf_counter()
        steps = stk.step_cells(tsid, tidx)
        detect.append((time.perf_counter() - t0) * 1e3)
    detect_ms = float(np.median(detect))
    if steps is None:
        raise AssertionError("the hour's cells are not whole steps")
    dev = grid0.device
    ti = torch.from_numpy(tsid).to(dev)
    xi = torch.from_numpy(tidx).to(dev)
    seq_d = torch.from_numpy(steps[0]).to(dev)
    steps_d = torch.from_numpy(steps[1]).to(dev)
    delta = torch.from_numpy(np.stack(cols)).to(dev)
    flags = torch.ones(len(tsid), dtype=torch.bool, device=dev)
    # the catch-up shape: the same cells in (tsid, ts) order
    order = torch.from_numpy(np.lexsort((tidx, tsid))).to(dev)
    ti_s, xi_s = ti[order], xi[order]
    delta_s, flags_s = delta[:, order].contiguous(), flags[order]
    want_v, want_m = grid0.values.clone(), grid0.valid.clone()
    stk.grid_scatter_plain(want_v, want_m, ti, xi, delta, flags)
    values, valid = torch.empty_like(want_v), torch.empty_like(want_m)

    def steps_kernel():
        stk.grid_scatter_steps(values, valid, seq_d, steps_d, delta, flags)

    def cells_kernel():
        stk.grid_scatter(values, valid, ti, xi, delta, flags)

    def catch_up():
        stk.grid_scatter(values, valid, ti_s, xi_s, delta_s, flags_s)

    for name, fn in (("grid_scatter_steps", steps_kernel),
                     ("grid_scatter", cells_kernel),
                     ("grid_scatter on the catch-up shape", catch_up)):
        values.copy_(grid0.values)
        valid.copy_(grid0.valid)
        fn()
        if not (same_output(values, want_v) and torch.equal(valid, want_m)):
            raise AssertionError(f"{name} differs from its plain version")

    # the library calls write the cells' own values again: want_v stays
    def library(a, b, d, f):
        for c in range(d.shape[0]):
            want_v[c].index_put_((a, b), d[c])
        want_m.index_put_((a, b), f)

    def library_single():
        want_v[:, ti, xi] = delta
        want_m[ti, xi] = flags

    def copy_clone():
        return grid0.values.clone(), grid0.valid.clone()

    def copy_into():
        values.copy_(grid0.values)
        valid.copy_(grid0.valid)

    ms, gms = time_ms(steps_kernel), graph_ms(steps_kernel)
    tm_ms, tm_gms = time_ms(cells_kernel), graph_ms(cells_kernel)
    catch_ms, catch_gms = time_ms(catch_up), graph_ms(catch_up)
    plain_steps = time_ms(lambda: stk.grid_scatter_steps_plain(
        want_v, want_m, seq_d, steps_d, delta, flags))
    plain_cells = time_ms(lambda: stk.grid_scatter_plain(
        want_v, want_m, ti_s, xi_s, delta_s, flags_s))
    lib = time_ms(lambda: library(ti, xi, delta, flags))
    lib_catch = time_ms(lambda: library(ti_s, xi_s, delta_s, flags_s))
    lib_single = time_ms(library_single)
    copy_ms = time_ms(copy_clone, reps=5)
    copy_gms = graph_ms(copy_into, reps=5)
    # the wrappers' host cost a call, on 8 steps of 64 series
    tv = torch.zeros((delta.shape[0], 64, 64), device=dev)
    tm = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    tseq = torch.arange(64, device=dev)
    tsteps = torch.arange(8, device=dev)
    tdelta = torch.ones((delta.shape[0], 512), device=dev)
    tflags = torch.ones(512, dtype=torch.bool, device=dev)
    host_steps = host_us(lambda: stk.grid_scatter_steps(
        tv, tm, tseq, tsteps, tdelta, tflags), n=500)
    ttsid, ttidx = tseq.repeat(8), tsteps.repeat_interleave(64)
    host_cells = host_us(lambda: stk.grid_scatter(tv, tm, ttsid, ttidx,
                                                  tdelta, tflags), n=500)
    c, n = delta.shape
    written = n * (4 * c + 1)
    bnd, by = bound_ms(nbytes(seq_d, steps_d, delta, flags) + written, 0)
    cbnd, cby = bound_ms(nbytes(ti_s, xi_s, delta_s, flags_s) + written, 0)
    copy_bnd, _ = bound_ms(2 * nbytes(grid0.values, grid0.valid), 0)
    log(f"kernel grid_scatter_steps[{n:,} cells x {c} planes into "
        f"{list(grid0.values.shape)}: {len(steps[1])} whole steps of "
        f"{len(steps[0]):,} series (step_cells on the host "
        f"{detect_ms:.3f} ms); library: index_put_ on each plane]: "
        f"{ms:.4f} ms, device {gms:.4f} ms (plain {plain_steps:.4f} ms, "
        f"library {lib:.4f} ms, one index_put_ over all planes + one on "
        f"valid {lib_single:.4f} ms, bound {bnd:.4f} ms by {by}: seq, "
        f"steps, delta and flags read, the cells written); host "
        f"{host_steps:.1f} us a call; max_abs_err 0 — {card}")
    log(f"kernel grid_scatter[the same cells in (tsid, ts) order, the "
        f"catch-up shape; library: index_put_ on each plane]: "
        f"{catch_ms:.4f} ms, device {catch_gms:.4f} (plain "
        f"{plain_cells:.4f} ms, library {lib_catch:.4f} ms, bound "
        f"{cbnd:.4f} ms by {cby}: two int64 indices a cell, delta and flags"
        f" read, the cells written); on the time-major cells "
        f"{tm_ms:.4f} ms, device {tm_gms:.4f}; host {host_cells:.1f} us a "
        f"call; max_abs_err 0 — {card}")
    log(f"the hot tail's grid copy (_writable: clone of "
        f"{nbytes(grid0.values, grid0.valid):,} B): {copy_ms:.4f} ms, "
        f"device (copy_ into a held buffer) {copy_gms:.4f} ms (bound "
        f"{copy_bnd:.4f} ms) — {card}")
    return (dict(ms=ms, graph_ms=gms, plain_ms=plain_steps, bound_ms=bnd,
                 bound_by=by, library_ms=lib, library_single_ms=lib_single,
                 max_abs_err=0.0, detect_ms=detect_ms, host_us=host_steps,
                 copy_ms=copy_ms, copy_graph_ms=copy_gms),
            dict(ms=catch_ms, graph_ms=catch_gms, plain_ms=plain_cells,
                 bound_ms=cbnd, bound_by=cby, library_ms=lib_catch,
                 max_abs_err=0.0, time_major_ms=tm_ms,
                 time_major_graph_ms=tm_gms, host_us=host_cells))


def write_query_promql(stk, pk, db, pctx: dict, card: str) -> dict:
    """(ii) on phase 4's db: one more scrape (1,000,000 rows, the 41st at
    the default 40) through region.write; the instant sum by (pod)
    (rate(m[5m])) at the new end against numpy over every scrape.  Fails
    unless the DeviceTable extended, every sort_layout launch took the
    presorted route, the old table version's sort layout left the PromQL
    cache and the new one was admitted under the default budget, and the
    warm query takes its selection, sort and group layouts from the
    cache."""
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.parser import parse_promql

    region = db._region_of("http_requests_total")
    cache, pc = db.cache, db.promql_cache
    held, next_scrape, k = (pctx["held"], pctx["next_scrape"],
                            pctx["scrapes"])
    table0 = cache.get(region)
    sort0 = [key for key, e in pc._lru.items()
             if key[1] == "sort" and e.version == table0.dicts_version]
    log_memory("write-then-query PromQL, before the write")
    stk.reset_launch_counts()
    pk.reset_launch_counts()
    ext0 = cache_event("table", "extend")
    v = next_scrape(k)
    held = np.vstack([held, v[None]])
    t_end = PROM_T0 + k * SCRAPE_MS
    expr = parse_promql(PROM_QUERY)

    def instant():
        ev = PromEvaluator(db, t_end / 1000, t_end / 1000, 1.0)
        res = ev.eval(expr)
        return ev, res, res.values.cpu().numpy()

    (ev, res, vals), first_ms = timed_first(instant)
    pods = np.array([int(res.labels[g]["pod"][4:])
                     for g in range(res.num_series)])
    got = np.full(PODS, np.nan)
    got[pods] = vals[:, 0]
    worst = check_pod_values("instant after the write", got,
                             np_pod_rates(held, t_end))
    cold_events = dict(ev.cache_events)
    warm = []
    for _ in range(5):
        _out, ms = timed_first(instant)
        warm.append(ms)
    ev, _res, _vals = instant()
    table = cache.get(region)
    extended = cache_event("table", "extend") - ext0
    routes = {"presorted": pk.sort_layout.presorted,
              "general": pk.sort_layout.general}
    sorts = {key: e.version for key, e in pc._lru.items()
             if key[1] == "sort"}
    log(f"write-then-query PromQL: scrape {k + 1} ({PROM_SERIES:,} rows) in "
        f"{next_scrape.write_s * 1e3:.3f} ms of region.write; instant "
        f"{PROM_QUERY} @ {t_end}: {PODS:,} groups correct (max |diff| "
        f"{worst:.3g}); first {first_ms:.3f} ms (events {cold_events}), "
        f"warm median {float(np.median(warm)):.3f} ms (5 runs); DeviceTable "
        f"extends {extended}, {table.padded_rows:,} padded rows; "
        f"sort_layout routes {routes}; PromQL cache {pc.stats()} at a "
        f"budget of {pc.capacity:,} B — {card}")
    if extended != 1 or table.dicts_root != table0.dicts_root:
        raise AssertionError("the PromQL DeviceTable did not extend")
    if routes["general"] or routes["presorted"] != pk.sort_layout.launches \
            or pk.sort_layout.launches < 1:
        raise AssertionError(f"sort_layout left the presorted route after "
                             f"the extend: {routes}")
    if table0.dicts_version in sorts.values() or table.dicts_version not \
            in sorts.values():
        raise AssertionError(f"the PromQL cache kept the old version's sort "
                             f"layout or did not admit the new one: {sorts} "
                             f"(before the write: {sort0})")
    ce = ev.cache_events
    cold = [kind for kind in ("selection", "sort", "group")
            if ce[f"{kind}_hit"] < 1 or ce[f"{kind}_miss"]
            or ce[f"{kind}_reject"]]
    if cold:
        raise AssertionError(f"warm instant query after the write: {cold} "
                             f"not served from the PromQL cache; events "
                             f"{dict(ce)}")
    log_memory("write-then-query PromQL, after its queries")
    launches = {"extend_merge": stk.extend_merge.launches}
    if launches["extend_merge"] < 1:
        raise AssertionError("extend_merge did not launch on the PromQL "
                             "write")
    return launches


def write_query_logs(stk, db, rows, params: dict, card: str) -> dict:
    """(iii) on phase 9's db: one more push of LOG_BATCH lines after the
    corpus; the substr_common LogQL filter and the SQL matches_term count
    again, against numpy over every line and GREPTIME_FULLTEXT=off.  Fails
    unless the DeviceTable extended (its fingerprint lineage kept) and the
    fingerprint matrix grew by the new vocabulary tail only."""
    import random

    from greptimedb_tpu_torch.fulltext import loki
    from greptimedb_tpu_torch.servers.ingest import LOKI_TABLE, loki_push
    from greptimedb_tpu_torch.utils.telemetry import REGISTRY

    new = gen_log_lines(random.Random(13), LOG_BATCH,
                        t0_ns=LOG_T0_NS + LOG_SPAN_S * 10**9,
                        span_s=LOG_BATCH * LOG_SPAN_S / LOG_LINES)
    view = db._table_view(LOKI_TABLE)
    table0 = db.cache.peek_table(view)
    vocab0 = len(table0.dicts["line"])
    indexed0 = REGISTRY.value("greptime_fulltext_indexed_values_total")
    ext0 = cache_event("table", "extend")
    stk.reset_launch_counts()
    log_memory("write-then-query logs, before the push")
    (body,) = log_push_bodies(new)
    n, push_ms = timed_first(lambda: loki_push(db, body, "application/json",
                                               LOG_TENANT))
    params = {**params, "end": str(int(params["end"]) + 100)}
    runs = {"substr_common": lambda: loki.loki_query_range(
                db, {"query": LOG_QUERIES["substr_common"][0], **params}),
            "sql_matches_term": lambda: db.sql(
                LOG_SQL["sql_matches_term"][0]).rows[0][0]}
    corpus = np_log_corpus(rows + new)
    times = {}
    for name, run in runs.items():
        got, times[name] = timed_first(run)
        view_got = got if name in LOG_SQL else log_payload_view(name, got)
        if view_got != np_log_expected(corpus, name):
            raise AssertionError(f"logs {name} after the push differs from "
                                 f"numpy")
        os.environ["GREPTIME_FULLTEXT"] = "off"
        try:
            if run() != got:
                raise AssertionError(f"logs {name} after the push: "
                                     f"GREPTIME_FULLTEXT=off differs")
        finally:
            os.environ["GREPTIME_FULLTEXT"] = "on"
    table = db.cache.peek_table(view)
    tail = len(table.dicts["line"]) - vocab0
    indexed = int(REGISTRY.value("greptime_fulltext_indexed_values_total")
                  - indexed0)
    extended = cache_event("table", "extend") - ext0
    log(f"write-then-query logs: {n:,} lines pushed in {push_ms:.3f} ms "
        f"(the prewarm extended the DeviceTable {extended} time(s) and "
        f"fingerprinted {indexed:,} new dictionary entries of a tail of "
        f"{tail:,}); first substr_common {times['substr_common']:.3f} ms, "
        f"sql_matches_term {times['sql_matches_term']:.3f} ms, both equal to"
        f" numpy and to GREPTIME_FULLTEXT=off — {card}")
    if extended != 1 or table.dicts_root != table0.dicts_root:
        raise AssertionError("the logs DeviceTable did not extend within its "
                             "lineage")
    if table.dicts["line"][:vocab0] != table0.dicts["line"] or \
            indexed != tail or tail < 1:
        raise AssertionError(f"the fingerprints did not grow by the tail: "
                             f"{indexed} indexed, tail {tail}")
    log_memory("write-then-query logs, after its queries")
    launches = {"extend_merge": stk.extend_merge.launches}
    if launches["extend_merge"] < 1:
        raise AssertionError("extend_merge did not launch on the logs push")
    return launches


def phase_start(name: str) -> int:
    """Drop what earlier phases left (their dbs are closed and unbound),
    then print and return the device memory still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    # cuBLAS keeps its workspace (32 MiB on Hopper) in the caching
    # allocator from the first matmul on; dropping it shows what is left
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    rest = torch.cuda.memory_allocated()
    log(f"phase {name}: torch.cuda.memory_allocated() {held} B at start, "
        f"{rest} B without cuBLAS's workspaces")
    return held


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hours", type=int, default=24,
                    help="hours of TSBS data to ingest (12 is the cut)")
    ap.add_argument("--scrapes", type=int, default=40,
                    help="15 s scrapes per PromQL series (20 is the cut)")
    ap.add_argument("--seed", type=int, default=11,
                    help="seed of the PromQL data")
    ap.add_argument("--flow-series", type=int, default=FLOW_SERIES,
                    help="series of the flow phase (2^20; fewer is a cut)")
    ap.add_argument("--log-lines", type=int, default=LOG_LINES,
                    help="lines of the logs phase (1,000,000; fewer is a "
                         "cut)")
    ap.add_argument("--vectors", type=int, default=VECTORS,
                    help="distinct vectors of the vector phase (131,072, "
                         "itself a cut of SIFT1M's 1,000,000)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from greptimedb_tpu_torch.ops import flow_kernels as fk
    from greptimedb_tpu_torch.ops import fulltext_kernels as lk
    from greptimedb_tpu_torch.ops import grid_kernels as gk
    from greptimedb_tpu_torch.ops import mesh_kernels as mk
    from greptimedb_tpu_torch.ops import promql_kernels as pk
    from greptimedb_tpu_torch.ops import segment_kernels as sk
    from greptimedb_tpu_torch.ops import sketch_kernels as shk
    from greptimedb_tpu_torch.ops import storage_kernels as stk
    from greptimedb_tpu_torch.ops import topk_kernels as tk
    from greptimedb_tpu_torch.ops import vector_kernels as vk

    t_start = time.perf_counter()
    card, has_arrow = phase_device(gk, pk, sk, shk, fk, lk, tk, vk, mk, stk)
    phase_start("2")
    kernels = phase_kernels(gk, card)
    phase_start("3")
    launches, db, home, ctx = phase_main_path(gk, args.hours, has_arrow,
                                              card)
    log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
    try:
        row_launches = phase_row_path(sk, db, ctx, card)
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
        kernels.update(phase_row_kernels(sk, db, ctx, card))
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
        sketch_launches, sctx = phase_sketches(shk, sk, db, ctx, card)
        kernels.update(phase_sketch_kernels(shk, db, sctx, card))
        del sctx
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
        phase_start("10")
        serve_launches, serve_k = phase_serving(gk, db, ctx, args.hours,
                                                card)
        kernels.update(serve_k)
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
        phase_start("11")
        topk_launches, topk_k = phase_topk(tk, db, ctx, card)
        kernels.update(topk_k)
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
        phase_start("13")
        mesh_launches, mesh_k = phase_mesh(mk, sk, shk, db, ctx, args.hours,
                                           card)
        kernels.update(mesh_k)
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
        phase_start("14 (i)")
        wtq_launches, (table0, grid0, chunks) = write_query_tsbs(
            stk, db, ctx, args.hours, has_arrow, card)
        kernels["extend_merge"] = extend_merge_timing(stk, sk, db, table0,
                                                      chunks, card)
        (kernels["grid_scatter_steps"],
         kernels["grid_scatter"]) = grid_scatter_timing(stk, db, grid0,
                                                        chunks, card)
        del table0, grid0, chunks
    finally:
        db.close()
        shutil.rmtree(home, ignore_errors=True)
    del ctx, db
    log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
    phase_start("4")
    prom_launches, db, home, pctx = phase_promql(gk, pk, sk, args.scrapes,
                                                 args.seed, has_arrow, card)
    try:
        kernels.update(phase_promql_kernels(gk, pk, sk, db, card))
        log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
        phase_start("14 (ii)")
        wtq_prom = write_query_promql(stk, pk, db, pctx, card)
        del pctx
    finally:
        db.close()
        shutil.rmtree(home, ignore_errors=True)
    del db
    log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
    phase_start("8")
    flow_launches, flow_k = phase_flows(fk, sk, args.flow_series, card)
    kernels.update(flow_k)
    log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
    phase_start("9")
    log_launches, log_k, wtq_logs = phase_logs(lk, pk, stk, args.log_lines,
                                               card)
    kernels.update(log_k)
    for path in (wtq_prom, wtq_logs):
        for name, n in path.items():
            wtq_launches[name] += n
    log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
    phase_start("12")
    vec_launches, vec_k = phase_vectors(vk, args.vectors, args.seed, card)
    kernels.update(vec_k)
    log(f"launches: SQL grid path {launches}, SQL row path {row_launches}, "
        f"sketches {sketch_launches}, PromQL path {prom_launches}, flows "
        f"{flow_launches}, logs {log_launches}, serving {serve_launches}, "
        f"top-k {topk_launches}, vectors {vec_launches}, mesh "
        f"{mesh_launches}, write then query {wtq_launches}")
    launches.update(row_launches)
    for path in (sketch_launches, prom_launches, flow_launches,
                 log_launches, serve_launches, topk_launches, vec_launches,
                 mesh_launches, wtq_launches):
        for name, n in path.items():
            launches[name] = launches.get(name, 0) + n
    kernels["group_merge"].update(kernels.pop("group_merge_prom", {}))
    line = {"kernels": []}
    for name in ("bucket_reduce", "group_merge", "group_merge_pair",
                 "prefix_scan",
                 "sort_layout", "counter_window", "segment_reduce",
                 "sorted_segment_reduce", "compact", "rank_scatter",
                 "radix_argsort", "window_stats", "minmax_window",
                 "window_count_max", "window_matrix", "window_matrix_dense",
                 "subquery_counter", "segment_select", "flow_merge",
                 "hll_fold", "udd_fold", "fp_candidates", "logs_layout",
                 "line_vals", "row_match", "group_merge_stacked",
                 "series_mask", "topk_select", "vec_distance",
                 "series_ranges", "gather_ts_mat", "mesh_merge",
                 "series_offsets", "extend_merge", "grid_scatter_steps",
                 "grid_scatter"):
        k = kernels[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        }
        # the merge modes of the sketch kernels, timed beside the fold;
        # the stacked merge's 16 solo group_merge_pair launches; the
        # top-k's other two queries and K22's other two distances and host
        # parse; bucket_reduce's u8 plane and masked windows; the pair's
        # two-merge yardstick; the grid kernels' host path
        entry.update({key: val for key, val in k.items()
                      if key.startswith(("merge_", "j_", "l_", "dot_",
                                         "cos_", "t1_", "quantile_",
                                         "hostname_", "u8_", "masked_",
                                         "two_merges_", "prom_", "mad_",
                                         "warp_", "holt_", "search_",
                                         "counter_", "instant_",
                                         "regression_", "irate_", "whole_",
                                         "per_call_", "time_major_",
                                         "copy_", "detect_"))
                      or key in ("solo_pairs_ms", "host_parse_ms", "on_path",
                                 "graph_ms", "library_graph_ms",
                                 "library_single_ms", "general_ms",
                                 "general_passes", "general_pass_ms",
                                 "passes", "pass_ms", "host_us",
                                 "device_ms")})
        if name in SHAPES:
            entry["launches_by_shape"] = SHAPES[name]
        if name in ROUTES:
            entry["routes"] = ROUTES[name]
        if name in GEOMETRIES:
            entry["geometries"] = GEOMETRIES[name]
        line["kernels"].append(entry)
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
