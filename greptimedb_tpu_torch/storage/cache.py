"""Device-resident region cache: the grid and device-table halves of the
reference's ``storage/cache.py``.

A region's dense grid (storage/grid.py) and its canonical row table
(``DeviceTable``, the PromQL path's input) are built once and reused
across queries; the derived bucket-major layouts of the aligned-window
path live in ``DerivedLayoutCache`` and the PromQL evaluation state
(selections, sort layouts, group ids) in ``PromLayoutCache``.
Invalidation is by region version: the port rebuilds a grid whenever the
region's base version or append position moved and a device table
whenever its generation moved (the reference extends both in place — not
ported yet; same results, higher cost).

Capacity: simple LRU by bytes; eviction drops device references and lets
the torch caching allocator reuse the memory.
"""

from __future__ import annotations

import collections
import threading
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from greptimedb_tpu_torch.datatypes.batch import pad_rows
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.storage.memtable import SEQ, TAGCODE_PREFIX, TSID
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

# Registry mirrors of the per-instance cache counters (reference: the
# per-crate lazy_static CACHE_HIT/CACHE_MISS vectors in src/mito2/src/
# metrics.rs).  The instance attributes (hits/misses/...) stay the
# per-cache source of truth for tests and /status; these registry
# counters make the same events SQL-queryable via runtime_metrics and
# scrapeable at /metrics, which is what bench.py/bench_promql.py read.
M_CACHE_EVENTS = REGISTRY.counter(
    "greptime_cache_events_total",
    "Resident-cache events (hit/miss/build/eviction/invalidation/"
    "quota_reject/extend)",
    labels=("cache", "kind", "event"),
)
M_CACHE_BYTES = REGISTRY.gauge(
    "greptime_cache_resident_bytes",
    "Bytes resident in each device cache (HBM for device tensors)",
    labels=("cache",),
)
M_CACHE_ENTRIES = REGISTRY.gauge(
    "greptime_cache_entries",
    "Entries resident in each device cache",
    labels=("cache",),
)


def _export_cache_gauges(name: str, cache) -> None:
    """Point the per-cache bytes/entries gauges at this instance via a
    weakref: scrape-time pulls read live state without keeping a dead
    cache (tests build hundreds of short-lived dbs) alive forever.  The
    newest instance wins the label — one standalone instance per process
    is the served configuration."""
    ref = weakref.ref(cache)
    M_CACHE_BYTES.labels(name).set_function(
        lambda: c._bytes if (c := ref()) is not None else 0.0)
    M_CACHE_ENTRIES.labels(name).set_function(
        lambda: len(c._lru) if (c := ref()) is not None else 0.0)


_DICTS_VERSION = 0  # process-wide monotonic dict-content version


def next_dicts_version() -> int:
    """Shared monotonic version for dictionary-derived compiled constants
    (used by both DeviceTable and GridTable builds)."""
    global _DICTS_VERSION
    _DICTS_VERSION += 1
    return _DICTS_VERSION


def _append_pos(region) -> "int | None":
    """The region's absolute append-log position (Region.append_pos);
    falls back to the raw list length for duck-typed region-likes that
    predate position trimming."""
    pos = getattr(region, "append_pos", None)
    if pos is not None:
        return pos
    log = getattr(region, "_append_log", None)
    return len(log) if log is not None else None


def _chunks_since(region, pos: int) -> "list | None":
    """Append-log chunks after absolute position ``pos``; None when the
    position predates the region's trimmed window (consumer must rebuild)."""
    f = getattr(region, "append_chunks_since", None)
    if f is not None:
        return f(pos)
    log = getattr(region, "_append_log", None)
    return log[pos:] if log is not None else None


@dataclass
class DeviceTable:
    """A region's query-ready resident tensors (a plain dataclass of
    tensors on the cache manager's device).

    columns: ts (int64), fields (f32/ints), per-tag code columns (int32),
    plus __tsid__ (int32). Sorted by (tsid, ts); rows padded to a
    shape-class bucket (``row_mask`` False on padding).
    """

    columns: dict[str, torch.Tensor]
    row_mask: torch.Tensor
    num_series: int
    dicts: dict[str, list] = field(default_factory=dict)
    # monotonic per-build version: derived state (the PromQL sort
    # layouts) keys its cache on it
    dicts_version: int = 0
    # tag columns whose codes are nondecreasing in row order and change
    # exactly where the series does: the sorted segment path's eligibility
    sorted_tags: tuple = ()

    @property
    def padded_rows(self) -> int:
        return int(self.row_mask.shape[0])

    def nbytes(self) -> int:
        total = self.row_mask.numel() * self.row_mask.element_size()
        for v in self.columns.values():
            total += v.numel() * v.element_size()
        return total


def _canonical_column(
    schema: Schema, encoders: dict, name: str, arr: np.ndarray,
    dicts: dict[str, list],
) -> np.ndarray:
    """One column of host scan output → device encoding (unpadded): tags →
    region dictionary codes (int32); string FIELDs → ad-hoc dictionary
    codes seeded from ``dicts`` (NULL becomes ""); numerics → device dtype
    (DOUBLE → float32); internal columns pass through.  ``dicts`` is
    updated in place."""
    if name == TSID:
        return arr.astype(np.int32)
    if schema.has_column(name):
        c = schema.column(name)
        if c.is_tag:
            enc = encoders[name]
            uniq, inv = np.unique(arr.astype(object), return_inverse=True)
            codes = np.fromiter(
                (enc.get(v) for v in uniq), dtype=np.int32, count=len(uniq)
            )
            dicts[name] = enc.values()
            return codes[inv]
        if c.dtype.is_string_like:
            from greptimedb_tpu_torch.datatypes.batch import DictionaryEncoder

            enc = DictionaryEncoder(dicts.get(name, []))
            # NULL string fields become "" (np.unique cannot order None)
            arr = np.array(["" if v is None else v for v in arr],
                           dtype=object)
            uniq, inv = np.unique(arr, return_inverse=True)
            codes = np.fromiter(
                (enc.get_or_insert(v) for v in uniq), dtype=np.int32,
                count=len(uniq),
            )
            dicts[name] = enc.values()
            return codes[inv]
        return arr.astype(c.dtype.to_device_dtype())
    return arr  # internal numeric column (e.g. __op__)


def _pad_value(schema: Schema, name: str, dtype: np.dtype):
    """Padding-row fill for a canonicalized column: poison code -1 for
    tag/string-dict columns, NaN for floats, 0 otherwise."""
    if name != TSID and schema.has_column(name):
        c = schema.column(name)
        if c.is_tag or c.dtype.is_string_like:
            return -1
    return np.nan if np.issubdtype(dtype, np.floating) else 0


def build_device_table(region, *, device) -> DeviceTable:
    """Scan, canonicalize, pad and upload one region's data.

    Regions that scan on the CODE path hand string tags over as
    ``__tagcode_<name>__`` int32 companions already in region code space,
    so canonicalization is a rename; others re-encode the raw values."""
    from greptimedb_tpu_torch.storage.scan import stream_to_device

    if getattr(region, "scan_supports_codes", False):
        host = region.scan_host(with_tag_codes=True)
    else:
        host = region.scan_host()
    schema = region.schema
    n = len(host[TSID])
    padded = pad_rows(n)
    dev_cols: dict[str, torch.Tensor] = {}
    host_canon: dict[str, np.ndarray] = {}
    dicts: dict[str, list] = {}
    for name, arr in host.items():
        if name == SEQ:
            continue  # sequences are a storage concern; queries never see them
        if name.startswith(TAGCODE_PREFIX):
            name = name[len(TAGCODE_PREFIX):-2]
            vals = arr.astype(np.int32, copy=False)
            dicts[name] = region.encoders[name].values()
        else:
            vals = _canonical_column(schema, region.encoders, name, arr,
                                     dicts)
        out = np.full(padded, _pad_value(schema, name, vals.dtype),
                      dtype=vals.dtype)
        out[:n] = vals
        host_canon[name] = vals
        dev_cols[name] = stream_to_device(out, device)
    mask = np.zeros(padded, dtype=bool)
    mask[:n] = True
    return DeviceTable(dev_cols, stream_to_device(mask, device),
                       region.num_series, dicts, next_dicts_version(),
                       detect_sorted_tags(schema, host_canon, n))


def detect_sorted_tags(schema: Schema, host_canon: dict, n: int) -> tuple:
    """Monotone tag detection on the host copies (reading the device
    columns back would cost a second transfer): rows are (tsid, ts)-sorted,
    and a tag qualifies for sorted segment reductions when its codes are
    nondecreasing AND bijective with series runs (each code run is exactly
    one tsid run, so ts — and any time bucket — ascends within it)."""
    if n == 0:
        return ()
    tsid_runs = 1 + int((np.diff(host_canon[TSID]) != 0).sum())
    out = []
    for c in schema.tag_columns:
        if c.name in host_canon:
            d = np.diff(host_canon[c.name])
            if bool((d >= 0).all()) and 1 + int((d != 0).sum()) == tsid_runs:
                out.append(c.name)
    return tuple(out)


@dataclass
class _Entry:
    # DeviceTable, GridTable, or None (negative grid-eligibility cache)
    table: object
    delta_pos: int | None = None  # consumed append-log position (absolute)
    live_rows: int = 0


class RegionCacheManager:
    """LRU of resident GridTables keyed by (region, base_version) and
    DeviceTables keyed by (region, generation)."""

    def __init__(self, capacity_bytes: int = 8 << 30, *, device):
        # delta volume beyond max(min_extend_rows, fraction * resident
        # rows) re-probes a region whose grid build was refused
        self.rebuild_fraction = 0.25
        self.min_extend_rows = 4096
        self.capacity = capacity_bytes
        self.device = device
        # optional DerivedLayoutCache chained into invalidate_region (set
        # by GreptimeDB): a region leaving residency drops its derived
        # bucket-major layouts too
        self.derived_layouts = None
        # optional PromLayoutCache chained the same way (set by
        # GreptimeDB): sort layouts key on a DeviceTable's dicts_version,
        # which the next build bumps — a device table leaving residency
        # strands them
        self.promql_derived = None
        self._lru: "collections.OrderedDict[tuple, _Entry]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        # guards _lru/_bytes; device builds run OUTSIDE it
        self._struct_lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        _export_cache_gauges("region_device", self)

    def get(self, region) -> DeviceTable:
        """The region's resident DeviceTable; any data mutation since the
        build (the region's ``generation`` moved) rebuilds it in full."""
        key = (region.region_id, "table", region.generation)
        entry = self._lru.get(key)
        if entry is not None:
            M_CACHE_EVENTS.labels("region_device", "table", "hit").inc()
            with self._struct_lock:
                self.hits += 1
                if key in self._lru:
                    self._lru.move_to_end(key)
            return entry.table
        with self._struct_lock:
            self.misses += 1
        M_CACHE_EVENTS.labels("region_device", "table", "miss").inc()
        gen = region.generation
        table = build_device_table(region, device=self.device)
        if region.generation != gen:
            return table  # raced a write mid-build: serve it uncached
        with self._struct_lock:
            for k in [k for k in self._lru
                      if k[0] == key[0] and k[1:2] == ("table",)
                      and k != key]:
                self._evict(k)
            self._lru[key] = _Entry(table)
            self._bytes += table.nbytes()
            self._shrink()
        return table

    def get_grid(self, region):
        """Dense-grid resident table for a region (storage/grid.py), or
        None when the region is ineligible (cached negatively per
        base_version so queries don't re-probe every time).  Any write or
        structure change since the build rebuilds it."""
        from greptimedb_tpu_torch.storage.grid import build_grid_table

        base_ver = getattr(region, "base_version", None)
        append_log = getattr(region, "_append_log", None)
        if base_ver is None or append_log is None:
            return None  # duck-typed views: not a grid region
        key = (region.region_id, "grid", base_ver)
        pos = _append_pos(region)
        entry = self._lru.get(key)
        if entry is not None:
            if entry.delta_pos == pos:
                M_CACHE_EVENTS.labels("region_device", "grid", "hit").inc()
                with self._struct_lock:
                    self.hits += 1
                    if key in self._lru:
                        self._lru.move_to_end(key)
                return entry.table
            chunks = _chunks_since(region, entry.delta_pos)
            if entry.table is None and chunks is not None:
                # negative entry: re-probe only after substantial growth —
                # an ineligible (irregular/sparse) region must not pay a
                # full eligibility scan per query
                appended = sum(len(c[TSID]) for c in chunks)
                if appended <= max(self.min_extend_rows,
                                   entry.live_rows * self.rebuild_fraction):
                    return None
            self._evict(key)  # appended since the build: rebuild

        with self._struct_lock:
            self.misses += 1
        M_CACHE_EVENTS.labels("region_device", "grid", "miss").inc()
        rows_now = region.memtable.num_rows + sum(
            m.num_rows for m in region.sst_files
        )
        table = build_grid_table(region, device=self.device)
        if table is not None and _append_pos(region) != pos:
            # raced an ingest append mid-build: serve uncached rather than
            # cache a table whose delta_pos cannot be trusted
            return table
        entry = _Entry(table, delta_pos=pos, live_rows=rows_now)
        with self._struct_lock:
            for k in [k for k in self._lru
                      if k[0] == key[0] and k[1:2] == ("grid",)
                      and k != key]:
                self._evict(k)
            old = self._lru.get(key)
            if old is not None and old.table is not None:
                self._bytes -= old.table.nbytes()  # concurrent double-build
            self._lru[key] = entry
            if table is not None:
                self._bytes += table.nbytes()
            self._shrink()
        return table

    def install_grid(self, region, table) -> None:
        """Adopt an externally built resident GridTable (e.g.
        storage/grid.py grid_from_numpy) as the region's current grid
        entry, exactly as if get_grid had built it."""
        key = (region.region_id, "grid", region.base_version)
        rows_now = region.memtable.num_rows + sum(
            m.num_rows for m in region.sst_files
        )
        with self._struct_lock:
            for k in [
                k for k in self._lru
                if k[0] == key[0] and k[1:2] == ("grid",)
            ]:
                self._evict(k)
            self._lru[key] = _Entry(
                table, delta_pos=_append_pos(region), live_rows=rows_now,
            )
            self._bytes += table.nbytes()
            self._shrink()

    def _shrink(self) -> None:
        with self._struct_lock:
            while self._bytes > self.capacity and len(self._lru) > 1:
                self._evict(next(iter(self._lru)))

    def _evict(self, key) -> None:
        with self._struct_lock:
            e = self._lru.pop(key, None)
            if e is not None and e.table is not None:
                self._bytes -= e.table.nbytes()
        if self.derived_layouts is not None and key[1:2] == ("grid",):
            # a grid leaving residency strands its derived layouts: the
            # next grid build bumps dicts_version, so they could never hit
            # again — drop them now instead of holding device bytes
            self.derived_layouts.invalidate_region(key[0])
        if self.promql_derived is not None and key[1:2] == ("table",):
            self.promql_derived.invalidate_region(key[0])

    def invalidate_region(self, region_id: int) -> None:
        with self._struct_lock:
            for k in [k for k in self._lru if k[0] == region_id]:
                self._evict(k)
        if self.derived_layouts is not None:
            self.derived_layouts.invalidate_region(region_id)
        if self.promql_derived is not None:
            self.promql_derived.invalidate_region(region_id)


@dataclass
class _LayoutEntry:
    version: int  # GridTable.dicts_version the layout was derived from
    arrays: tuple
    nbytes: int


class _ByteLRUCache:
    """Shared machinery for the derived resident caches (SQL bucket-major
    layouts, PromQL evaluation state): an LRU of version-tagged entries
    bounded by bytes, with reject-to-fallback admission through an
    optional WorkloadMemoryManager probe and region-scoped invalidation.
    Subclasses define the key shape and hit/miss bookkeeping; the
    eviction/admission/reclaim semantics exist exactly once here so the
    two caches cannot drift."""

    # registry label ("layout" / "promql"); subclasses override
    metric_cache = "derived"

    def __init__(self, capacity_bytes: int | None, env_var: str):
        import os

        if capacity_bytes is None:
            capacity_bytes = int(os.environ.get(env_var, str(1 << 30)))
        self.capacity = capacity_bytes
        # optional callable(nbytes) -> bool wired by the server to
        # WorkloadMemoryManager.try_admit(<workload>, ...)
        self.memory_probe = None
        self._lru: "collections.OrderedDict[tuple, _LayoutEntry]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        self.rejects = 0
        self.builds = 0
        self.evictions = 0
        _export_cache_gauges(self.metric_cache, self)

    def _kind_of(self, key: tuple) -> str:
        """Entry kind for registry labels (PromLayoutCache keys carry it)."""
        return "layout"

    @property
    def bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._lru)

    def _lookup_entry(self, key: tuple, version):
        """Arrays for ``key`` at ``version``, or None.  A stale entry
        (older derivation version) is evicted immediately — the version
        bump IS the invalidation."""
        entry = self._lru.get(key)
        if entry is not None and entry.version == version:
            self._lru.move_to_end(key)
            return entry.arrays
        if entry is not None:
            self._evict(key)
        return None

    def admit(self, nbytes: int) -> bool:
        """Reject-to-fallback admission: evict LRU entries to make room,
        then consult the workload memory probe.  False means the caller
        serves from its uncached fallback path."""
        if nbytes > self.capacity:
            self.rejects += 1
            M_CACHE_EVENTS.labels(
                self.metric_cache, "any", "quota_reject").inc()
            return False
        while self._bytes + nbytes > self.capacity and self._lru:
            self._evict(next(iter(self._lru)))
        if self.memory_probe is not None and not self.memory_probe(nbytes):
            self.rejects += 1
            M_CACHE_EVENTS.labels(
                self.metric_cache, "any", "quota_reject").inc()
            return False
        return True

    def _store_entry(self, key: tuple, version, arrays, nbytes: int) -> None:
        if key in self._lru:
            self._evict(key)
        self._lru[key] = _LayoutEntry(version, arrays, nbytes)
        self._bytes += nbytes
        self.builds += 1
        M_CACHE_EVENTS.labels(
            self.metric_cache, self._kind_of(key), "build").inc()

    def reclaim(self, nbytes: int) -> None:
        """WorkloadMemoryManager reclaim hook: free at least ``nbytes``
        by LRU eviction (admission pressure from other workloads)."""
        freed = 0
        while freed < nbytes and self._lru:
            k = next(iter(self._lru))
            freed += self._lru[k].nbytes
            self._evict(k)

    def invalidate_region(self, region_id: int) -> None:
        for k in [k for k in self._lru if k[0] == region_id]:
            M_CACHE_EVENTS.labels(
                self.metric_cache, self._kind_of(k), "invalidation").inc()
            self._evict(k)

    def _evict(self, key) -> None:
        e = self._lru.pop(key, None)
        if e is not None:
            self._bytes -= e.nbytes
            self.evictions += 1
            M_CACHE_EVENTS.labels(
                self.metric_cache, self._kind_of(key), "eviction").inc()


class DerivedLayoutCache(_ByteLRUCache):
    """Resident derived layouts for the aligned-window range-aggregation
    path: per (region, step class) the bucket-major reduction of the
    resident grid — the ``[S, nb, r]`` reshape contracted once on device
    into per-(series, bucket) partial sums ``[C, S, NB]`` and validity
    counts ``[S, NB]`` — reused across warm queries so the per-query
    aligned-window work drops to a bucket-axis slice plus the tiny
    series-axis merge (the "pay the transpose once" pattern of tensor-
    runtime query engines, arXiv:2203.01877).

    Invalidation is by GridTable.dicts_version (bumped on every grid
    build AND device-side append extension, which in turn follow the
    region's ingest/flush/compaction generation bumps): a version
    mismatch evicts the stale entry and rebuilds.  Capacity is LRU by
    bytes; ``admit`` additionally consults an optional
    WorkloadMemoryManager probe so the extra resident copy can never OOM
    the device — rejected builds fall back to the dynamic-slice kernel.
    """

    metric_cache = "layout"

    def __init__(self, capacity_bytes: int | None = None):
        super().__init__(capacity_bytes, "GREPTIME_LAYOUT_CACHE_BYTES")
        self.hits = 0
        self.misses = 0

    def lookup(self, region_id: int, step_class: tuple, version: int):
        """Arrays for (region, step class) at ``version``, or None."""
        arrays = self._lookup_entry((region_id, step_class), version)
        self.hits += arrays is not None
        self.misses += arrays is None
        M_CACHE_EVENTS.labels(
            "layout", "layout",
            "hit" if arrays is not None else "miss").inc()
        return arrays

    def store(self, region_id: int, step_class: tuple, version: int,
              arrays: tuple, nbytes: int) -> None:
        self._store_entry((region_id, step_class), version, arrays, nbytes)


class PromLayoutCache(_ByteLRUCache):
    """Resident derived state of the PromQL evaluation hot path, three
    kinds of entries:

    - ``selection``: per (region, matcher set) the matched tsid vector and
      its padded device copy, so repeated evaluations skip the inverted-
      index walk;
    - ``sort``: per (region, field column) the composite (tsid, ts)-key
      sort of the resident table (``ops/promql_kernels.sort_layout``);
    - ``group``: per (selection, by/without grouping) the device group-id
      vector and its CSR layout.

    Every entry stores the version it was derived from (the region's
    ``series_generation`` for selection/group, the DeviceTable's
    ``dicts_version`` for sort) and a mismatch at lookup evicts and
    rebuilds.  Capacity is LRU by bytes with reject-to-fallback: a
    rejected build serves its evaluation uncached from the same code, so
    results are equal either way.  (The reference's fourth kind,
    ``bounds``, feeds the count geometry, which is not ported.)
    """

    KINDS = ("selection", "sort", "group")
    metric_cache = "promql"

    def _kind_of(self, key: tuple) -> str:
        return key[1]

    def __init__(self, capacity_bytes: int | None = None):
        super().__init__(capacity_bytes, "GREPTIME_PROMQL_CACHE_BYTES")
        self.hits = dict.fromkeys(self.KINDS, 0)
        self.misses = dict.fromkeys(self.KINDS, 0)

    def lookup(self, kind: str, region_id: int, key: tuple, version):
        """Payload for (kind, region, key) at ``version``, or None."""
        payload = self._lookup_entry((region_id, kind, key), version)
        self.hits[kind] += payload is not None
        self.misses[kind] += payload is None
        M_CACHE_EVENTS.labels(
            "promql", kind, "hit" if payload is not None else "miss").inc()
        return payload

    def store(self, kind: str, region_id: int, key: tuple, version,
              payload, nbytes: int) -> None:
        self._store_entry((region_id, kind, key), version, payload, nbytes)

    def stats(self) -> dict:
        """Flat counters for status lines."""
        out = {"bytes": self._bytes, "entries": len(self._lru),
               "rejects": self.rejects, "builds": self.builds,
               "evictions": self.evictions}
        for kind in self.KINDS:
            out[f"{kind}_hits"] = self.hits[kind]
            out[f"{kind}_misses"] = self.misses[kind]
        return out
