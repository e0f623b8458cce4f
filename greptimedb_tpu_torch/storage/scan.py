"""Streaming cold-scan pipeline: parallel SST decode + sorted-run merge +
overlapped host→device upload.

The resident caches (storage/cache.py, storage/grid.py) made warm queries
fast, but every cold query and cache (re)build still paid a strictly
sequential read → decode → global-lexsort → upload chain.  This module is
the shared machinery that turns that chain into a pipeline, the
tensor-runtime input-pipeline shape (prefetch + double buffering) of
Theseus (arXiv:2508.05029) applied to the scan path:

- ``read_parts``: fetch+decode SSTs concurrently on a bounded
  ThreadPoolExecutor.  pyarrow's Parquet decode releases the GIL, so
  decode threads scale on real cores; ``GREPTIME_SCAN_THREADS`` caps the
  pool (default ``min(8, files, cores)``).  Staging memory is admitted
  through
  the optional WorkloadMemoryManager (workload ``"scan"``) with
  reject-to-SEQUENTIAL fallback — an over-quota scan degrades to the old
  one-file-at-a-time loop instead of failing.
- ``merge_parts``: SSTs are written sorted by ``(tsid, ts, seq)``, so the
  global ``np.lexsort`` over the concatenated scan is redundant work.
  Single-source scans skip sorting entirely; pre-sorted runs whose key
  ranges don't interleave (TWCS windows of a single series, sequential
  flushes of growing series sets) reduce to an ordered concat;
  time-disjoint runs merge with one narrow tsid-key radix argsort; the
  general case takes one packed-key radix argsort — numpy's stable
  integer sort — instead of a 3-key comparison lexsort.  Output is
  bit-exact with the lexsort path (``GREPTIME_SCAN_FORCE_LEXSORT=1``
  forces the old path for A/B and parity tests).
- ``stream_to_device``: chunked host→device upload with DOUBLE BUFFERING —
  pinned host chunks copied ``non_blocking`` to the torch device, the next
  chunk staged while the previous one is still in flight (bounded at 2
  outstanding chunks), overlapping host staging with the PCIe transfer.

Telemetry: every phase lands in ``greptime_scan_*`` registry metrics and
(tracer on) ``scan``/``scan_decode``/``scan_merge`` spans nested under the
query's execute stage, so EXPLAIN ANALYZE and slow_queries show where cold
time goes.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from greptimedb_tpu_torch.utils.telemetry import REGISTRY

M_SCAN_FILES = REGISTRY.counter(
    "greptime_scan_files_total",
    "SST files seen by the scan pipeline, by outcome "
    "(read/pruned/prefetched)",
    labels=("event",),
)
M_SCAN_BYTES = REGISTRY.counter(
    "greptime_scan_bytes_total",
    "Compressed SST bytes decoded by the scan pipeline",
)
M_SCAN_ROWS = REGISTRY.counter(
    "greptime_scan_rows_total",
    "Rows produced by scan-pipeline merges",
)
M_SCAN_PHASE = REGISTRY.histogram(
    "greptime_scan_phase_seconds",
    "Cold-scan phase wall time (decode/merge/upload)",
    labels=("phase",),
)
M_SCAN_MERGE = REGISTRY.counter(
    "greptime_scan_merge_total",
    "Merge strategy taken by scan merges "
    "(presorted/concat/merge/packed_sort/lexsort/empty)",
    labels=("path",),
)
M_SCAN_FALLBACK = REGISTRY.counter(
    "greptime_scan_sequential_fallbacks_total",
    "Parallel scans degraded to sequential decode, by reason",
    labels=("reason",),
)

# last strategy merge_parts took (test/debug observability; the registry
# counter is the aggregate view, this is the "what did MY scan just do")
LAST_MERGE_PATH: str = ""
# last completed scan's phase summary, for the query engines' metrics
# sink (EXPLAIN ANALYZE cold row, slow_queries stages): "seq" bumps once
# per read_parts so a consumer can tell a FRESH cold scan from stale
# state.  THREAD-LOCAL: scans run concurrently from scheduler workers,
# the ingest pool (compaction) and flush paths — a process-global dict
# cross-attributed one thread's decode/merge phases to another thread's
# EXPLAIN ANALYZE/slow_queries row (and a compaction landing mid-query
# overwrote the query's numbers entirely).
_SCAN_STATS_TLS = threading.local()


def scan_stats() -> dict:
    """This thread's last scan phase summary (mutable — read_parts and
    merge_parts write into it)."""
    d = getattr(_SCAN_STATS_TLS, "stats", None)
    if d is None:
        d = _SCAN_STATS_TLS.stats = {"seq": 0}
    return d

# uploads stream in bounded pieces through pinned staging buffers of this
# size (pinned host memory is allocated per buffer, not per array)
_UPLOAD_CHUNK_BYTES = 64 << 20
# double buffer: chunks in flight before blocking on the oldest.  2 keeps
# host staging overlapped with the transfer while bounding the pinned
# staging memory at 2 chunks.
_UPLOAD_DEPTH = 2


# Scan-pool preemption hook (serving/scheduler.py installs it when the
# scheduler is enabled): returns True when the CALLING thread is running
# background-priority work while interactive queries wait — the decode
# pool then narrows to one thread so a cold scan/compaction pass stops
# monopolizing cores under interactive load.  None (scheduler off) costs
# the warm path nothing.
background_yield_hook = None


def scan_threads(num_files: int) -> int:
    """Decode-pool width: ``GREPTIME_SCAN_THREADS`` wins, else
    ``min(8, files, cores)`` narrowed to 1 while the serving scheduler
    reports this thread should yield — more threads than files is pure
    overhead, more than the core count just contends the GIL-held decode
    segments, and more than 8 saturates memory bandwidth before it
    saturates cores."""
    env = os.environ.get("GREPTIME_SCAN_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    hook = background_yield_hook
    if hook is not None:
        try:
            if hook():
                return 1
        except Exception:  # noqa: BLE001 — preemption is best-effort
            pass
    return max(1, min(8, num_files, os.cpu_count() or 1))


class _Staging:
    """Live bytes held by in-flight parallel decodes — the pull-based
    usage source for the ``"scan"`` memory workload (utils/memory.py)."""

    def __init__(self):
        self._bytes = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self._bytes += n

    @property
    def bytes(self) -> int:
        return self._bytes


STAGING = _Staging()


def staging_bytes() -> int:
    """Usage hook for WorkloadMemoryManager.register("scan", ...)."""
    return STAGING.bytes


def estimate_staging_bytes(metas, ncols: int,
                           ts_range=(None, None)) -> int:
    """Decoded-bytes estimate for quota admission: ~8 bytes/cell over the
    rows a ``ts_range``-restricted read can actually return.  Scaling each
    file by its time-overlap fraction matters on the catch-up path, where
    whole files prune down to a near-empty tail — a full-file estimate
    there would trip reject-to-sequential exactly when real staging is
    smallest."""
    lo, hi = ts_range
    rows = 0.0
    for m in metas:
        span = max(1, int(m.ts_max) - int(m.ts_min) + 1)
        eff_lo = int(m.ts_min) if lo is None else max(int(m.ts_min), int(lo))
        eff_hi = (int(m.ts_max) + 1 if hi is None
                  else min(int(m.ts_max) + 1, int(hi)))
        frac = min(1.0, max(0.0, (eff_hi - eff_lo) / span))
        rows += m.num_rows * frac
    return int(rows * 8 * max(1, ncols))


def read_parts(tasks, memory=None, est_bytes: int = 0):
    """Run decode ``tasks`` (zero-arg callables returning column dicts),
    order-preserving.  Decodes concurrently on a bounded pool unless the
    thread knob says 1, there is nothing to parallelize, or the staging
    estimate is rejected by the ``"scan"`` memory workload — in which
    case it falls back to the sequential loop (identical output)."""
    n = len(tasks)
    stats = scan_stats()
    seq = stats.get("seq", 0) + 1
    stats.clear()
    stats["seq"] = seq
    if n == 0:
        return []
    threads = min(scan_threads(n), n)
    admitted = 0
    if threads > 1 and memory is not None and est_bytes > 0:
        if memory.try_admit("scan", est_bytes):
            admitted = est_bytes
        else:
            M_SCAN_FALLBACK.labels("quota").inc()
            threads = 1
    t0 = time.perf_counter()
    try:
        if threads <= 1:
            out = [t() for t in tasks]
        else:
            STAGING.add(admitted)
            try:
                with ThreadPoolExecutor(
                    max_workers=threads, thread_name_prefix="scan-decode"
                ) as pool:
                    out = list(pool.map(lambda t: t(), tasks))
            finally:
                STAGING.add(-admitted)
    finally:
        dt = time.perf_counter() - t0
        M_SCAN_PHASE.labels("decode").observe(dt)
        stats["files"] = n
        stats["threads"] = threads
        stats["decode_ms"] = round(dt * 1000, 3)
    return out


# ---------------------------------------------------------------------------
# Sorted-run merge
# ---------------------------------------------------------------------------


def _pack_keys(parts, ts_name: str, tsid_name: str, seq_name: str):
    """Per-part 1-D int64 keys order-equivalent to lexicographic
    (tsid, ts, seq), or None when the combined bit width cannot fit 62
    bits (caller falls back to np.lexsort).  Values are biased to their
    global minima so pre-epoch timestamps and large sequences pack."""
    live = [p for p in parts if len(p[ts_name])]
    if not live:
        return []
    ts_min = min(int(p[ts_name].min()) for p in live)
    ts_max = max(int(p[ts_name].max()) for p in live)
    seq_min = min(int(p[seq_name].min()) for p in live)
    seq_max = max(int(p[seq_name].max()) for p in live)
    tsid_max = max(int(p[tsid_name].max()) for p in live)
    if min(int(p[tsid_name].min()) for p in live) < 0:
        return None  # poison codes: refuse, lexsort handles anything
    w_ts = max(1, int(ts_max - ts_min).bit_length())
    w_seq = max(1, int(seq_max - seq_min).bit_length())
    w_tsid = max(1, int(tsid_max).bit_length())
    if w_tsid + w_ts + w_seq > 62:
        return None
    keys = []
    for p in parts:
        tsid = p[tsid_name].astype(np.int64, copy=False)
        rel_ts = p[ts_name].astype(np.int64, copy=False) - ts_min
        rel_seq = p[seq_name].astype(np.int64, copy=False) - seq_min
        keys.append((tsid << np.int64(w_ts + w_seq))
                    | (rel_ts << np.int64(w_seq)) | rel_seq)
    return keys


def merge_parts(parts, ts_name: str, tsid_name: str, seq_name: str):
    """Merge scan parts into global (tsid, ts, seq) order; returns
    ``(merged_columns, path)``.

    Bit-exact with ``np.lexsort((seq, ts, tsid))`` over the concatenation
    on every path (stable reductions of stably-sorted runs ≡ a stable
    global sort).  Strategy tiers, cheapest first:

    - ``presorted``: one already-sorted source — no sort, no copy;
    - ``concat``: sorted runs whose key ranges don't interleave in part
      order — a plain concatenate;
    - ``merge``: sorted runs with pairwise-DISJOINT time ranges (the
      TWCS-common case): concat in time order, then one stable argsort
      on the tsid column alone — numpy's stable integer sort is a radix
      sort, and the narrow tsid key needs a fraction of the passes a
      3-key comparison lexsort burns; within a tsid, time order equals
      run order, so the result is exact;
    - ``packed_sort``: interleaving/unsorted sources — one stable radix
      argsort over the packed 1-D keys (still ~4x under lexsort);
    - ``lexsort``: key space too wide to pack, or forced via
      ``GREPTIME_SCAN_FORCE_LEXSORT=1`` (the A/B reference path).
    """
    global LAST_MERGE_PATH
    t0 = time.perf_counter()
    merged, path = _merge_parts(parts, ts_name, tsid_name, seq_name)
    dt = time.perf_counter() - t0
    M_SCAN_PHASE.labels("merge").observe(dt)
    M_SCAN_MERGE.labels(path).inc()
    M_SCAN_ROWS.inc(len(merged[ts_name]))
    LAST_MERGE_PATH = path
    stats = scan_stats()
    stats["path"] = path
    stats["rows"] = len(merged[ts_name])
    stats["merge_ms"] = round(dt * 1000, 3)
    return merged, path


def _concat(parts, names):
    return {k: np.concatenate([p[k] for p in parts]) for k in names}


def _merge_parts(parts, ts_name, tsid_name, seq_name):
    names = list(parts[0].keys())
    live = [p for p in parts if len(p[ts_name])]
    if not live:
        return _concat(parts, names), "empty"

    def lexsorted():
        merged = _concat(parts, names)
        order = np.lexsort(
            (merged[seq_name], merged[ts_name], merged[tsid_name]))
        return {k: v[order] for k, v in merged.items()}, "lexsort"

    if os.environ.get("GREPTIME_SCAN_FORCE_LEXSORT") == "1":
        return lexsorted()
    keys = _pack_keys(live, ts_name, tsid_name, seq_name)
    if keys is None:
        return lexsorted()
    # packed order == (tsid, ts, seq) order by construction, so run
    # sortedness is one vectorized diff per part
    sorted_flags = [
        len(k) <= 1 or not bool((np.diff(k) < 0).any()) for k in keys
    ]
    if len(live) == 1:
        if sorted_flags[0]:
            return dict(live[0]), "presorted"
        o = np.argsort(keys[0], kind="stable")
        return {k: v[o] for k, v in live[0].items()}, "packed_sort"
    if all(sorted_flags):
        # ordered concat: consecutive runs' key ranges don't interleave —
        # single-series TWCS windows, flushes of monotonically growing
        # series sets.  Non-strict boundaries are safe in part order:
        # equal keys keep concat order, exactly what a stable sort does.
        if all(int(keys[i][-1]) <= int(keys[i + 1][0])
               for i in range(len(keys) - 1)):
            return _concat(live, names), "concat"
        # sorted-run merge, disjoint-time tier: order runs by time; when
        # strictly disjoint, within any tsid the run order IS the time
        # order, so one stable radix argsort on the narrow tsid key
        # restores the full (tsid, ts, seq) order.  Strictness makes
        # cross-run key ties impossible — bit-exact with lexsort.
        bounds = [
            (int(p[ts_name].min()), int(p[ts_name].max())) for p in live
        ]
        time_order = sorted(range(len(live)), key=lambda i: bounds[i][0])
        if all(bounds[time_order[j]][1] < bounds[time_order[j + 1]][0]
               for j in range(len(time_order) - 1)):
            runs = [live[i] for i in time_order]
            cat_tsid = np.concatenate([p[tsid_name] for p in runs])
            o = np.argsort(cat_tsid, kind="stable")
            merged = _concat(runs, names)
            return {k: v[o] for k, v in merged.items()}, "merge"
    # interleaving or unsorted runs: one stable radix argsort over the
    # packed keys of the concatenation (original part order — stability
    # then matches the lexsort reference exactly)
    o = np.argsort(np.concatenate(keys), kind="stable")
    merged = _concat(live, names)
    return {k: v[o] for k, v in merged.items()}, "packed_sort"


# ---------------------------------------------------------------------------
# Overlapped host→device upload
# ---------------------------------------------------------------------------


def stream_to_device(arr: np.ndarray, device) -> "torch.Tensor":
    """Host→device upload: small arrays in one copy; large ones flattened
    and streamed in bounded chunks through two pinned host buffers, so
    staging chunk i+1 overlaps chunk i's ``non_blocking`` copy (at most
    ``_UPLOAD_DEPTH`` chunks in flight).  A CPU ``device`` gets a tensor
    over the array itself."""
    import torch

    dev = torch.device(device)
    t0 = time.perf_counter()
    try:
        host = np.ascontiguousarray(arr)
        if not host.flags.writeable:
            host = host.copy()  # torch tensors must own writable memory
        src = torch.from_numpy(host)
        if dev.type == "cpu":
            return src
        if arr.nbytes <= _UPLOAD_CHUNK_BYTES:
            return src.to(dev)
        out = torch.empty(src.shape, dtype=src.dtype, device=dev)
        flat_src, flat_out = src.reshape(-1), out.view(-1)
        per = max(1, _UPLOAD_CHUNK_BYTES // max(1, src.element_size()))
        stream = torch.cuda.current_stream(dev)
        pinned = [torch.empty(per, dtype=src.dtype, pin_memory=True)
                  for _ in range(_UPLOAD_DEPTH)]
        done: list = [None] * _UPLOAD_DEPTH
        for k, i in enumerate(range(0, flat_src.shape[0], per)):
            slot = k % _UPLOAD_DEPTH
            if done[slot] is not None:
                done[slot].synchronize()  # that buffer's copy has landed
            m = min(per, flat_src.shape[0] - i)
            pinned[slot][:m].copy_(flat_src[i:i + m])
            flat_out[i:i + m].copy_(pinned[slot][:m], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
            done[slot] = ev
        stream.synchronize()
        return out
    finally:
        M_SCAN_PHASE.labels("upload").observe(time.perf_counter() - t0)


def prefetch_store(store, metas) -> int:
    """Scan-driven readahead: ask the object store to start pulling the
    selected-but-not-yet-local SSTs before the decode pool reaches them.
    No-op for stores without a prefetcher (local fs, memory)."""
    fetch = getattr(store, "prefetch", None)
    if fetch is None or not metas:
        return 0
    queued = int(fetch([m.path for m in metas]))
    if queued:
        M_SCAN_FILES.labels("prefetched").inc(queued)
    return queued
