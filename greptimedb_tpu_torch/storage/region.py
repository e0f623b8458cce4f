"""Region: the unit of storage, replication and parallelism.

Equivalent of a mito2 region (reference src/mito2/src/engine.rs + worker
handlers): one time-series shard owning a WAL, a memtable, SSTs and a
manifest. The reference routes regions to worker-loop threads; here writes
are synchronous per region (Python) with the GIL-free heavy lifting in
numpy/pyarrow, and the parallel axis moves to the TPU mesh (parallel/).

Write encoding: tag values → per-column dictionary codes → a packed series
key → region-wide __tsid__ (series registry); dictionaries live in the
manifest so codes are stable across restarts (the metric-engine __tsid
idea, reference src/metric-engine/src/row_modifier.rs).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

import numpy as np

from greptimedb_tpu_torch.datatypes.batch import DictColumn, DictionaryEncoder
from greptimedb_tpu_torch.datatypes.schema import Schema, default_fill_array
from greptimedb_tpu_torch.errors import InvalidArguments, RegionNotFound, StorageError
from greptimedb_tpu_torch.storage.durability import (
    M_QUARANTINED,
    M_REPAIRED,
    ManifestCorruption,
    RegionQuarantined,
    SstCorruption,
    WalHole,
    quarantine_object,
)
from greptimedb_tpu_torch.storage.manifest import Manifest
from greptimedb_tpu_torch.storage.memtable import (
    Memtable, OP, OP_DELETE, OP_PUT, SEQ, TAGCODE_PREFIX, TSID, tagcode_col,
)
from greptimedb_tpu_torch.storage.object_store import FsObjectStore, ObjectStore
from greptimedb_tpu_torch.storage.sst import SstMeta, read_sst, write_sst
from greptimedb_tpu_torch.storage.wal import (
    FileLogStore,
    NoopLogStore,
    decode_write_full,
    encode_write,
)



# append-log cap: beyond this many unconsumed delta chunks the cache does
# a full rebuild anyway, so stop buffering and force a structure change
MAX_APPEND_CHUNKS = 256


@dataclass
class RegionOptions:
    flush_threshold_bytes: int = 256 * 1024 * 1024
    compaction_window_ms: int = 24 * 3600 * 1000  # TWCS time window
    compaction_trigger_files: int = 8  # files per window before merge
    wal_enabled: bool = True
    wal_sync: bool = False
    # append mode (reference CREATE TABLE WITH (append_mode='true'),
    # mito2 MergeMode): rows with equal (series, ts) keys are ALL kept —
    # the log/trace data model, where many events share a millisecond
    append_mode: bool = False
    # retention (reference WITH (ttl='7d'), src/store-api/src/
    # mito_engine_options.rs): SSTs whose newest row is older than
    # now - ttl are dropped whole at flush/compaction time; None = keep
    # forever
    ttl_ms: int | None = None

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class Region:
    # capability flag for build_device_table: scan_host accepts
    # ``with_tag_codes`` (duck-typed views that wrap scan_host don't)
    scan_supports_codes = True

    def __init__(
        self,
        region_id: int,
        store: ObjectStore,
        schema: Schema,
        manifest: Manifest,
        wal_dir: str | None,
        options: RegionOptions,
        log_store: "LogStore | None" = None,
        memory=None,
    ):
        self.region_id = region_id
        self.store = store
        self.schema = schema
        self.options = options
        self.manifest = manifest
        # optional WorkloadMemoryManager: write() admits incoming batches
        # against the engine-wide ingest (write-buffer) quota
        self.memory = memory
        self._dir = f"region_{region_id}"
        if log_store is not None:
            # injected WAL (remote/shared log — storage/remote_wal.py)
            self.wal = log_store
        elif options.wal_enabled and wal_dir is not None:
            self.wal = FileLogStore(wal_dir, sync=options.wal_sync)
        else:
            self.wal = NoopLogStore()
        self.memtable = Memtable(schema)
        self.next_seq = manifest.state.flushed_seq + 1
        # incremental device-cache protocol: base_version changes only on
        # STRUCTURE changes (flush/compaction/truncate/catch-up/upsert...);
        # pure time-forward appends go to _append_log so the cache layer
        # can extend resident tensors instead of rebuilding (cache.py)
        self.base_version = 0
        self._append_log: list[dict] = []
        # count of chunks trimmed off the log's front: consumer positions
        # are ABSOLUTE (base + list index), so sustained ingest can trim
        # consumed chunks without invalidating up-to-date consumers
        self._append_base = 0
        self._max_ts_seen: int | None = None  # lazy; -2**63 = empty
        # serializes writers of THIS region only: concurrent ingest to
        # different regions proceeds in parallel (the parallel axis of
        # the sharded ingest pipeline) while each region keeps the
        # single-writer discipline its sequence/memtable code assumes
        self._write_lock = threading.RLock()
        # guards (_append_base, _append_log) as a pair: cache consumers
        # read them lock-free of _write_lock, so trim (del + base bump)
        # must be atomic w.r.t. append_chunks_since/append_pos — a torn
        # read would silently skip or duplicate chunks in the resident
        # device tail.  Never held across I/O: list ops only.
        self._append_log_lock = threading.Lock()
        # tag encoders hydrated from the manifest
        self.encoders: dict[str, DictionaryEncoder] = {
            c.name: DictionaryEncoder(manifest.state.dicts.get(c.name, []))
            for c in schema.tag_columns
        }
        self._series: dict[tuple, int] = {
            tuple(codes): i for i, codes in enumerate(manifest.state.series)
        }
        # repeated-writer fast paths (the device flow runtime's sink
        # upserts hit both every fold): per-tag-column DictColumn
        # vocabulary→region-code maps keyed on the vocabulary array's
        # identity (vocabularies are append-only — covered entries are
        # immutable), and the single-tag code→tsid mirror of _series.
        # Cleared wherever _series/encoders are rebuilt.
        self._dictcol_memo: dict[str, tuple] = {}
        self._series_map1: np.ndarray | None = None
        self.generation = 0  # bumped on any data mutation; cache key
        # bumped only on structure changes that can MUTATE row content
        # (upserts/deletes/compaction/ttl/truncate/alter/replay) — flush is
        # content-preserving (rows just move memtable → SST), so a resident
        # grid whose epoch still matches can CATCH UP from the flushed
        # files instead of rebuilding (storage/grid.py catch_up_grid_table)
        self.mutation_epoch = 0
        self._index_cache: dict[str, dict] = {}  # file_id -> column blooms
        # durability repair hooks.  ``repair_source``: fetch a
        # replica's copy of an object (path -> bytes | None), e.g.
        # durability.repair_sst_from_peer over the Flight object plane.
        # ``wal_resync``: fetch missing WAL records for a lost sequence
        # range ((lo, hi) -> [(seq, payload)]), e.g.
        # durability.resync_from_log_store / resync_from_peer_wal.
        self.repair_source = None
        self.wal_resync = None
        # leader epoch this region's shared-storage writes are fenced
        # under; None = unfenced (standalone / follower)
        self.fence_epoch: int | None = None

    # ------------------------------------------------------------------
    @property
    def tag_names(self) -> list[str]:
        return [c.name for c in self.schema.tag_columns]

    @property
    def ts_name(self) -> str:
        return self.schema.time_index.name

    @property
    def num_series(self) -> int:
        return len(self._series)

    @property
    def series_generation(self) -> tuple:
        """Version of the SERIES REGISTRY (tsid ↔ tag-code mapping) only,
        unlike ``generation`` which bumps on every data write.  The
        registry is append-only between structure changes (every rebuild
        site calls _mark_structure_change), so (base_version, len) is a
        sound invalidation key — PromQL matcher selections, group-id
        vectors and the inverted index depend only on this and survive
        pure data appends of existing series (the steady-scrape case)."""
        return (self.base_version, len(self._series))

    @property
    def sst_files(self) -> list[SstMeta]:
        return list(self.manifest.state.files.values())

    # ---- append-log positions (device-cache incremental protocol) -----
    @property
    def append_pos(self) -> int:
        """Absolute position past the newest append-log chunk.  Consumers
        (storage/cache.py) remember the position they consumed to; pure
        appends between two positions EXTEND resident tensors in place."""
        with self._append_log_lock:
            return self._append_base + len(self._append_log)

    def append_chunks_since(self, pos: int) -> "list[dict] | None":
        """Chunks appended after absolute position ``pos``, or None when
        ``pos`` predates the trimmed window (consumer too stale: rebuild)."""
        with self._append_log_lock:
            i = pos - self._append_base
            if i < 0:
                return None
            return self._append_log[i:]

    # ---- write path ---------------------------------------------------
    def _encode_tags(
        self, columns: dict[str, np.ndarray], n: int,
        out_codes: dict[str, np.ndarray] | None = None,
    ) -> np.ndarray:
        """tags → per-column codes (mutating region dicts) → __tsid__.

        ``out_codes`` (when given) receives the per-column int32 code
        arrays so downstream consumers (SST dictionary pages, bloom index,
        device canonicalization) never re-hash the raw strings."""
        tag_cols = self.tag_names
        if not tag_cols:
            return np.zeros(n, dtype=np.int64)

        code_arrays = []
        for name in tag_cols:
            enc = self.encoders[name]
            col = columns[name]
            if isinstance(col, DictColumn):
                # pre-factorized by the vectorized wire parser: the
                # (codes, vocabulary) pair IS the factorization — skip
                # the per-row hash entirely.
                # Repeated-writer memo: a caller reusing one append-only
                # vocabulary array across writes (the device flow
                # runtime's sink upserts, every fold) resolves through a
                # cached vocab-pos→region-code map — only NEVER-SEEN
                # referenced entries pay the python registration, once
                # ever (covered entries are immutable by the dictionary
                # append-only contract).
                vbase = col.values if col.values.base is None \
                    else col.values.base
                # lazy attrs: region-LIKES (CombinedRegionView, staged
                # providers) borrow this method without Region.__init__
                memo_map = getattr(self, "_dictcol_memo", None)
                if memo_map is None:
                    memo_map = self._dictcol_memo = {}
                memo = memo_map.get(name)
                if memo is not None and memo[0] is vbase:
                    cmap = memo[1]
                    if len(cmap) < len(col.values):
                        cmap = np.concatenate([
                            cmap, np.full(len(col.values) - len(cmap), -1,
                                          np.int64)])
                        memo_map[name] = (vbase, cmap)
                    col_codes = cmap[col.codes]
                    need = col_codes < 0
                    if need.any():
                        for rc in np.unique(col.codes[need]).tolist():
                            v = col.values[rc]
                            if v is None or (isinstance(v, float)
                                             and v != v):
                                v = ""  # NULL tags encode as ""
                            cmap[rc] = enc.get_or_insert(v)
                        col_codes = cmap[col.codes]
                    if out_codes is not None:
                        out_codes[name] = col_codes.astype(np.int32)
                    code_arrays.append(col_codes)
                    continue
                # Compact to REFERENCED vocabulary entries first: a
                # sliced column (DictColumn .take from partition routing /
                # per-measurement splits) keeps the whole-batch
                # vocabulary, and registering unreferenced values would
                # grow this region's dictionary with values that were
                # routed elsewhere, forever
                inv, uniq = col.codes, col.values
                orig_len = len(uniq)
                # referenced-code set via bincount (O(n + vocab)) instead
                # of a sort — codes are small non-negative ints
                used = (np.flatnonzero(np.bincount(inv, minlength=len(uniq)))
                        if inv.size > len(uniq) else np.unique(inv))
                if len(used) < len(uniq):
                    remap = np.full(len(uniq), -1, dtype=inv.dtype)
                    remap[used] = np.arange(len(used), dtype=inv.dtype)
                    inv = remap[inv]
                    uniq = uniq[used]
            else:
                vals = np.asarray(col, dtype=object)
                # hash-factorize (O(n), no object-array sort): tag columns
                # repeat heavily, so python cost is paid per UNIQUE value
                # only
                import pandas as pd

                inv, uniq = pd.factorize(vals, use_na_sentinel=False)
            if any(
                v is None or (isinstance(v, float) and v != v) for v in uniq
            ):
                # NULL tags (None/NaN from factorize) encode as "" — the
                # device dictionary space has no null representation (same
                # rule as add_tag_column backfill); a None in the vocab
                # would wedge every subsequent flush.  Integer-typed tags
                # pass through untouched.
                uniq = np.array(
                    ["" if v is None or (isinstance(v, float) and v != v)
                     else v for v in uniq], dtype=object)
            codes = np.fromiter(
                (enc.get_or_insert(v) for v in uniq), dtype=np.int64,
                count=len(uniq),
            )
            col_codes = codes[inv]
            if isinstance(col, DictColumn):
                # seed the repeated-writer memo (referenced entries only
                # — unreferenced positions stay -1 and register lazily)
                cmap = np.full(orig_len, -1, np.int64)
                cmap[used if len(used) < orig_len
                     else slice(None)] = codes
                vbase = col.values if col.values.base is None \
                    else col.values.base
                memo_map = getattr(self, "_dictcol_memo", None)
                if memo_map is None:
                    memo_map = self._dictcol_memo = {}
                memo_map[name] = (vbase, cmap)
            if out_codes is not None:
                out_codes[name] = col_codes.astype(np.int32)
            code_arrays.append(col_codes)
        # vectorized any-arity series resolution: pack per-column codes
        # into one int64 key when the combined bit width fits (exact,
        # injective), factorize the packed ints, then a python loop over
        # UNIQUE keys only (the metric-engine physical region routinely
        # has many tag columns, so no per-row python fallback is
        # acceptable on the ingest hot path)
        if len(code_arrays) == 1:
            # single-tag tables resolve through a dense code→tsid mirror
            # of _series: one gather per write, python only for codes
            # never seen before (the repeated-writer hot path — flow sink
            # upserts, single-tag metric tables)
            codes1 = code_arrays[0]
            mx = int(codes1.max()) if n else -1
            smap = getattr(self, "_series_map1", None)
            if smap is None or mx >= len(smap):
                grown = np.full(max(16, 2 * (mx + 1)), -1, np.int64)
                if smap is not None:
                    grown[: len(smap)] = smap
                else:
                    for key, tsid in self._series.items():
                        if key[0] < len(grown):
                            grown[key[0]] = tsid
                smap = self._series_map1 = grown
            tsids1 = smap[codes1]
            need = tsids1 < 0
            if need.any():
                # FIRST-OCCURRENCE registration order (pd.factorize's):
                # tsid assignment order is observable via first/last
                # tie-breaks on equal timestamps
                uniq_new, first_idx = np.unique(codes1[need],
                                                return_index=True)
                for c in uniq_new[np.argsort(first_idx,
                                             kind="stable")].tolist():
                    key = (int(c),)
                    tsid = self._series.get(key)
                    if tsid is None:
                        tsid = len(self._series)
                        self._series[key] = tsid
                    smap[c] = tsid
                tsids1 = smap[codes1]
            return tsids1
        widths = [
            max(int(a.max()) if n else 0, 1).bit_length()
            for a in code_arrays
        ]
        if sum(widths) <= 62:
            packed = code_arrays[0]
            for a, w in zip(code_arrays[1:], widths[1:]):
                packed = (packed << np.int64(w)) | a
        else:  # astronomically wide key space: exact structured unique
            packed = None
        if packed is not None:
            pmax = int(packed.max()) + 1 if n else 0
            if 0 < pmax <= max(1024, 4 * n):
                # dense key space (the common case: few live series):
                # bincount-factorize is O(n + keyspace) with no hash
                # table.  Uniques are then reordered to FIRST-OCCURRENCE
                # order — exactly pd.factorize's — because the order NEW
                # series ids are assigned in is observable downstream
                # (first/last picks on equal timestamps follow the
                # device layout's tsid order)
                uniq_sorted = np.flatnonzero(
                    np.bincount(packed, minlength=pmax))
                remap = np.zeros(pmax, dtype=np.int64)
                remap[uniq_sorted] = np.arange(len(uniq_sorted))
                inv_s = remap[packed]
                first = np.empty(len(uniq_sorted), dtype=np.int64)
                first[inv_s[::-1]] = np.arange(n - 1, -1, -1,
                                               dtype=np.int64)
                order = np.argsort(first, kind="stable")
                rank = np.empty(len(order), dtype=np.int64)
                rank[order] = np.arange(len(order), dtype=np.int64)
                uniq_packed = uniq_sorted[order]
                inv2 = rank[inv_s]
            else:
                import pandas as pd

                inv2, uniq_packed = pd.factorize(packed)
            # first-occurrence row per unique packed key (reversed write:
            # the earliest row wins), to recover the exact code tuple
            first_row = np.empty(len(uniq_packed), dtype=np.int64)
            rev = np.arange(n - 1, -1, -1)
            first_row[inv2[rev]] = rev
            tsids = np.empty(len(uniq_packed), dtype=np.int64)
            for j in range(len(uniq_packed)):
                r = int(first_row[j])
                key = tuple(int(a[r]) for a in code_arrays)
                tsid = self._series.get(key)
                if tsid is None:
                    tsid = len(self._series)
                    self._series[key] = tsid
                tsids[j] = tsid
            return tsids[inv2]
        code_mat = np.stack(code_arrays, axis=1)  # [n, k] int64
        uniq_rows, inv2 = np.unique(code_mat, axis=0, return_inverse=True)
        tsids = np.empty(len(uniq_rows), dtype=np.int64)
        for j in range(len(uniq_rows)):
            key = tuple(int(c) for c in uniq_rows[j])
            tsid = self._series.get(key)
            if tsid is None:
                tsid = len(self._series)
                self._series[key] = tsid
            tsids[j] = tsid
        return tsids[inv2.reshape(-1)]

    def write(self, data: dict[str, list | np.ndarray], op: int = OP_PUT,
              wire_payload: bytes | None = None) -> int:
        """Synchronous write of one row group; returns the sequence.

        Serialized per region by ``_write_lock`` — concurrent ingest to
        DIFFERENT regions runs in parallel (the sharded half of the
        vectorized ingest pipeline), while sequence assignment, tag
        encoding and memtable mutation for one region stay single-writer.
        Tag columns may arrive as ``DictColumn`` (vectorized wire parse):
        codes flow straight into the series registry and the WAL encodes
        them as Arrow dictionary arrays — no per-row string objects until
        the memtable materialization (a C-level vocabulary gather).

        ``wire_payload``: the batch's original wire bytes when they are
        already a valid slim WAL payload (an Arrow IPC stream of exactly
        the columns in ``data``, ts as int64 epoch ms, no nulls — the
        arrow bulk surface).  Logged verbatim instead of re-serializing
        the batch, PROVIDED every schema column arrived structurally
        (checked below); otherwise ignored."""
        with self._write_lock:
            return self._write_locked(data, op, wire_payload)

    def _write_locked(self, data, op: int,
                      wire_payload: bytes | None = None) -> int:
        from greptimedb_tpu_torch.utils.tracing import TRACER

        ts_name = self.ts_name
        n = len(data[ts_name])
        if self.memory is not None:
            # rough batch footprint: ~16B/cell covers the typical mix of
            # f64/int64 values plus object-array overhead for tags
            self.memory.admit("ingest", n * len(data) * 16)
        # wire_payload stays usable only while every schema column turns
        # out to have arrived structurally (typed ndarray / string-typed
        # DictColumn) — exactly the inputs replay_wal re-derives
        # identically from the raw wire stream
        wire_ok = wire_payload is not None and op == OP_PUT
        cols: dict[str, np.ndarray] = {}
        for c in self.schema:
            if c.name not in data:
                if not c.nullable and c.default is None:
                    raise InvalidArguments(f"missing column {c.name}")
                # default-filled here ≠ present in the wire bytes: replay
                # of the raw stream would KeyError on this column
                wire_ok = False
                cols[c.name] = default_fill_array(c, n)
            else:
                v = data[c.name]
                if wire_ok and not (
                    (isinstance(v, DictColumn) and c.dtype.is_string_like)
                    or (isinstance(v, np.ndarray) and v.dtype != object)
                ):
                    wire_ok = False
                if isinstance(v, DictColumn) and c.dtype.is_string_like:
                    cols[c.name] = v  # stays dictionary-coded end to end
                elif isinstance(v, DictColumn):
                    v = v.materialize()
                    cols[c.name] = v.astype(c.dtype.to_numpy())
                elif c.dtype.is_string_like:
                    cols[c.name] = np.asarray(v, dtype=object)
                elif c.dtype.is_timestamp:
                    # copy=False: parser output is never aliased by the
                    # caller afterwards, so an already-int64 ts passes
                    # through untouched
                    cols[c.name] = np.asarray(v).astype(np.int64,
                                                        copy=False)
                elif isinstance(v, np.ndarray) and v.dtype != object:
                    # typed arrays (arrow ingest, staging scans) can't hold
                    # None — keep the single-pass hot path; copy=False
                    # skips the memcpy when the wire dtype already matches
                    cols[c.name] = v.astype(c.dtype.to_numpy(), copy=False)
                else:
                    arr = np.asarray(v, dtype=object)
                    if any(x is None for x in arr):
                        if not c.nullable:
                            raise InvalidArguments(
                                f"column {c.name} is NOT NULL"
                            )
                        # NULL encoding (NOT the declared default — explicit
                        # NULL is not DEFAULT): NaN for floats, 0 for ints,
                        # matching default_fill_array's null branch and the
                        # arrow path's fill_null(0)
                        fill = np.nan if c.dtype.is_float else 0
                        arr = np.array(
                            [fill if x is None else x for x in arr],
                            dtype=object,
                        )
                    try:
                        cols[c.name] = arr.astype(c.dtype.to_numpy())
                    except (TypeError, ValueError) as e:
                        raise InvalidArguments(
                            f"column {c.name}: {e}"
                        ) from None
        seq = self.next_seq
        self.next_seq += 1
        chunk = dict(cols)
        tag_codes: dict[str, np.ndarray] = {}
        chunk[TSID] = self._encode_tags(cols, n, out_codes=tag_codes)
        for tname, tcodes in tag_codes.items():
            chunk[tagcode_col(tname)] = tcodes
        chunk[SEQ] = np.full(n, seq, dtype=np.int64)
        chunk[OP] = np.full(n, op, dtype=np.int8)

        # durability first (reference handle_write.rs: WAL before memtable);
        # non-durable stores (Noop) skip serialization entirely — encoding
        # 10 columns of a million-row batch for /dev/null is pure overhead
        if getattr(self.wal, "durable", True):
            with TRACER.stage("ingest_wal", region=self.region_id, rows=n):
                if wire_ok:
                    # the wire bytes already ARE the slim payload (arrow
                    # bulk: same columns, int64 ms ts, no nulls, op PUT
                    # implied by absent metadata) — log them verbatim,
                    # skipping a full re-serialization of the batch
                    self.wal.append(seq, wire_payload)
                else:
                    import pyarrow as pa

                    wal_cols = {}
                    for k, v in chunk.items():
                        if k.startswith(TAGCODE_PREFIX) or k in (
                                TSID, SEQ, OP):
                            # derivable at replay: codes/tsids recompute,
                            # the sequence rides the record header, op is
                            # one value per batch (schema metadata)
                            continue
                        if isinstance(v, DictColumn):
                            # dictionary-coded tags log as Arrow
                            # dictionary arrays: vocabulary once + int32
                            # codes per row
                            wal_cols[k] = pa.DictionaryArray.from_arrays(
                                pa.array(v.codes),
                                pa.array(v.values.tolist()))
                            continue
                        # object-dtype (string) columns: pa.array over the
                        # python list preserves None as arrow nulls
                        # (astype(str) would corrupt NULL into the literal
                        # 'None' across recovery)
                        wal_cols[k] = pa.array(
                            v.tolist() if v.dtype == object else v)
                    self.wal.append(seq, encode_write(wal_cols, op=op))
        # memtable stores ts as int64 under the schema's ts column name;
        # dictionary-coded tags materialize here — one vocabulary gather
        # per column (rows share the vocabulary's string objects)
        mt_chunk = {
            k: (v.materialize() if isinstance(v, DictColumn) else v)
            for k, v in chunk.items()
        }
        mt_chunk[self.ts_name] = np.asarray(
            mt_chunk[self.ts_name]).astype(np.int64, copy=False)

        # incremental-cache classification: a batch whose timestamps all lie
        # strictly AFTER everything seen is a pure append (no upsert/delete
        # can touch resident rows) — log it for device-side extension
        if self._max_ts_seen is None:
            b = self.ts_bounds()
            self._max_ts_seen = b[1] if b is not None else -(1 << 63)
        ts_i64 = mt_chunk[self.ts_name]
        ts_lo = int(ts_i64.min()) if n else 0
        ts_hi = int(ts_i64.max()) if n else 0
        appendable = op == OP_PUT and n > 0 and ts_lo > self._max_ts_seen
        if appendable and n > 1:
            # within-batch duplicate (series, ts) keys dedup keep-last in
            # the memtable but would append verbatim on the device — not
            # extendable.  Pack (tsid, rel_ts) into one int64 so the
            # uniqueness probe is a 1-D sort, not np.unique(axis=0)'s
            # structured row sort (~6x slower on 1M-row ingest batches);
            # falls back to the row-wise check if the key space overflows.
            tsid_i64 = chunk[TSID].astype(np.int64)
            rel = ts_i64 - ts_lo
            if int(tsid_i64.max()) < (1 << 30) and int(rel.max()) < (1 << 34):
                packed = (tsid_i64 << 34) | rel
                packed.sort()  # fresh array — safe to sort in place
                if bool((packed[1:] == packed[:-1]).any()):
                    appendable = False
            else:
                pairs = np.stack([tsid_i64, ts_i64], axis=1)
                if len(np.unique(pairs, axis=0)) != n:
                    appendable = False
        if n > 0:
            self._max_ts_seen = max(self._max_ts_seen, ts_hi)

        with TRACER.stage("ingest_memtable", region=self.region_id, rows=n):
            self.memtable.append(
                mt_chunk, ts_bounds=(ts_lo, ts_hi) if n else None, seq=seq)
        self.generation += 1
        # consumers like the streaming flow engine need to know whether
        # this batch could have OVERWRITTEN existing rows (upsert) — an
        # incremental aggregate may only fold in pure appends
        self.last_write_appendable = appendable or n == 0
        if appendable:
            with self._append_log_lock:
                self._append_log.append(mt_chunk)
                if len(self._append_log) > MAX_APPEND_CHUNKS:
                    # sustained ingest: trim the consumed front instead
                    # of forcing a structure change — up-to-date
                    # consumers (absolute positions) keep extending
                    # forever; a consumer behind the trimmed window
                    # rebuilds (it was stale anyway)
                    drop = len(self._append_log) - MAX_APPEND_CHUNKS
                    del self._append_log[:drop]
                    self._append_base += drop
        elif n > 0:
            self._mark_structure_change()
        # n == 0: nothing changed; keep resident tables valid
        if self.memtable.bytes >= self.options.flush_threshold_bytes:
            self.flush()
        return seq

    def _mark_structure_change(self, content_preserving: bool = False) -> None:
        """Resident device tables for this region can no longer be extended
        in place — bump the base version so the cache rebuilds.

        ``content_preserving=True`` (flush only: rows move memtable → SST
        byte-identically — dedup/tombstone interactions would have bumped
        the epoch at write time already) keeps ``mutation_epoch`` intact so
        the grid cache may catch up incrementally from the new files."""
        self.base_version += 1
        if not content_preserving:
            self.mutation_epoch += 1
        with self._append_log_lock:
            self._append_base += len(self._append_log)
            self._append_log.clear()
        self._max_ts_seen = None

    def delete(self, data: dict[str, list | np.ndarray]) -> int:
        """Delete by full key (tags + ts): writes tombstones."""
        return self.write(data, op=OP_DELETE)

    def add_tag_column(self, name: str) -> None:
        """Online tag addition (reference alter-on-demand for metric-engine
        labels, src/operator/src/insert.rs + metric engine row_modifier).

        Existing series extend their key with the empty-string code; tsids
        are preserved, so resident caches/devices stay consistent. Flushes
        first so every SST is backfillable by schema evolution.

        Takes the region write lock (reentrant — flush re-acquires) for
        the whole swap: concurrent ingest-pool writers must never observe
        a half-rebuilt series registry or a schema/encoder mismatch.
        """
        from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
        from greptimedb_tpu_torch.datatypes.types import ConcreteDataType, SemanticType

        with self._write_lock:
            self._add_tag_column_locked(name)

    def _add_tag_column_locked(self, name: str) -> None:
        from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
        from greptimedb_tpu_torch.datatypes.types import ConcreteDataType, SemanticType

        if self.schema.has_column(name):
            return
        self.flush()
        new_schema = Schema(
            self.schema.columns
            + (ColumnSchema(name, ConcreteDataType.STRING, SemanticType.TAG),),
            version=self.schema.version + 1,
        )
        enc = DictionaryEncoder()
        empty_code = enc.get_or_insert("")
        self.encoders[name] = enc
        # extend every registered series key in place (ids unchanged)
        self._series = {
            key + (empty_code,): tsid for key, tsid in self._series.items()
        }
        self._dictcol_memo.clear()
        self._series_map1 = None
        self.schema = new_schema
        self.memtable.schema = new_schema
        self.manifest.commit({"kind": "schema", "schema": new_schema.to_dict()})
        self.manifest.commit({
            "kind": "reset_dicts",
            "dicts": {k: e.values() for k, e in self.encoders.items()},
            "series": [list(k) for k in sorted(self._series,
                                               key=self._series.get)],
        })
        self.generation += 1
        self._mark_structure_change()

    # ---- flush / replay ------------------------------------------------
    def flush(self) -> SstMeta | None:
        with self._write_lock:
            return self._flush_locked()

    def _flush_locked(self) -> SstMeta | None:
        if self.memtable.is_empty:
            return None
        frozen = self.memtable.freeze(dedup=not self.options.append_mode)
        flushed_seq = self.memtable.max_seq
        # storage keeps ts as int64 epoch in schema unit
        meta = write_sst(
            self.store, f"{self._dir}/sst", self.schema, frozen,
            tag_dicts={k: enc.values() for k, enc in self.encoders.items()},
        )
        self._write_sst_index(meta, frozen)
        self.manifest.commit(
            {
                "kind": "dicts",
                "dicts": {k: enc.values() for k, enc in self.encoders.items()},
                "series": [list(k) for k in sorted(self._series, key=self._series.get)],
            }
        )
        self.manifest.commit(
            {"kind": "edit", "add": [meta.to_dict()], "flushed_seq": flushed_seq}
        )
        self.memtable = Memtable(self.schema)
        self.wal.truncate(flushed_seq + 1)
        self.generation += 1
        self._mark_structure_change(content_preserving=True)
        self._maybe_compact()
        return meta

    def replay_wal(self, repair: bool = True) -> int:
        """Replay entries past flushed_seq into the memtable (region open).

        Tag codes/tsids are RECOMPUTED (not trusted from the log): encoders
        are hydrated from the manifest's flush-time state, and replaying
        writes in original order regrows them deterministically — so the
        series registry stays consistent for post-replay writes.

        ``repair=False`` = read-only replay (followers sharing the leader's
        WAL dir must never truncate its active segment).

        Corruption triage: a torn tail is truncated by the log
        store (crash debris, correct); INTERIOR corruption — a lost acked
        sequence range in the middle of the log — is resynced from
        ``self.wal_resync`` (remote WAL / follower replica) and the
        damaged segment healed; without a covering resync source the open
        raises WalHole instead of silently dropping acked writes (the
        damaged bytes stay quarantined in sidecars either way).
        """
        from_seq = self.manifest.state.flushed_seq + 1
        count = 0
        for seq, payload in self.wal.replay(from_seq, repair=repair):
            self._apply_wal_record(seq, payload)
            count += 1
        if repair:
            count += self._resync_wal_holes(from_seq)
        if count:
            self.generation += 1
            self._mark_structure_change()
        return count

    def _decode_wal_chunk(self, seq: int, payload: bytes) -> dict:
        """One WAL record → memtable chunk (codes/tsids recomputed)."""
        cols, op = decode_write_full(payload)
        chunk: dict[str, np.ndarray] = {}
        for c in self.schema:
            arr = cols[c.name]
            if c.dtype.is_string_like:
                chunk[c.name] = np.asarray(arr.to_pylist(), dtype=object)
            else:
                chunk[c.name] = arr.to_numpy(zero_copy_only=False).astype(
                    np.int64 if c.dtype.is_timestamp else c.dtype.to_numpy()
                )
        n = len(chunk[self.ts_name])
        tag_codes: dict[str, np.ndarray] = {}
        chunk[TSID] = self._encode_tags(chunk, n, out_codes=tag_codes)
        for tname, tcodes in tag_codes.items():
            chunk[tagcode_col(tname)] = tcodes
        # slim payloads derive __seq__/__op__ (header sequence +
        # metadata op); pre-slimming records still carry the columns
        # and replay them verbatim
        chunk[SEQ] = (cols[SEQ].to_numpy(zero_copy_only=False)
                      if SEQ in cols else np.full(n, seq, dtype=np.int64))
        chunk[OP] = (cols[OP].to_numpy(zero_copy_only=False)
                     .astype(np.int8)
                     if OP in cols else np.full(n, op, dtype=np.int8))
        return chunk

    def _apply_wal_record(self, seq: int, payload: bytes) -> None:
        self.memtable.append(self._decode_wal_chunk(seq, payload))
        self.next_seq = max(self.next_seq, seq + 1)

    def _resync_wal_holes(self, from_seq: int) -> int:
        """Repair interior WAL corruption found by the last replay pass:
        fetch the lost sequence range from ``wal_resync``, re-log it
        durably, apply it, and heal the damaged segments.  Raises WalHole
        when acked sequences are lost and no source covers them."""
        triage = getattr(self.wal, "last_triage", None)
        if not triage:
            return 0
        holes: list[tuple[int, int | None]] = []
        for d in triage:
            if d.kind != "interior":
                continue
            r = d.lost_range()
            if r is None:
                continue  # pure garbage between consecutive sequences
            lo, hi = r
            lo = max(lo, from_seq)
            if hi is not None and hi < lo:
                continue  # entirely below flushed_seq: already in SSTs
            holes.append((lo, hi))
        if not holes:
            # nothing recoverable was lost; drop the damaged spans (the
            # sidecars keep the original bytes)
            self.wal.heal()
            return 0
        if self.wal_resync is None:
            raise WalHole(self.region_id, holes)
        count = 0
        for lo, hi in holes:
            fetched = sorted(self.wal_resync(
                lo, hi if hi is not None else (1 << 62)))
            # the source is the authority on what existed: sequences it
            # lacks may simply never have been written (failed appends
            # burn sequences) — but a source with NOTHING for the hole
            # is indistinguishable from loss, so declare it loudly
            if not fetched:
                raise WalHole(self.region_id, [(lo, hi)])
            for seq, payload in fetched:
                self.wal.append(seq, payload)  # re-log durably FIRST
                self._apply_wal_record(seq, payload)
                count += 1
            M_REPAIRED.labels("wal", "resync").inc(len(fetched))
        self.wal.heal()
        return count

    # ---- compaction (TWCS-lite) ---------------------------------------
    def _windows(self) -> dict[int, list[SstMeta]]:
        w = self.options.compaction_window_ms
        out: dict[int, list[SstMeta]] = {}
        for m in self.sst_files:
            out.setdefault(m.ts_min // w, []).append(m)
        return out

    def _maybe_compact(self) -> None:
        self.apply_ttl()
        for _win, files in self._windows().items():
            if len(files) >= self.options.compaction_trigger_files:
                try:
                    self.compact_files(files)
                except SstCorruption as e:
                    # corrupt input quarantined (or repaired): skip this
                    # window now; the next flush re-triggers it over the
                    # surviving/repaired file set
                    self._handle_sst_corruption(e)

    @staticmethod
    def _now_ms() -> int:
        import time as _time

        return int(_time.time() * 1000)

    def apply_ttl(self) -> int:
        """Drop SSTs fully past the retention window (reference TWCS
        picker expiration, src/mito2/src/compaction/twcs.rs + ttl in
        src/store-api/src/mito_engine_options.rs).  Whole-file drops
        only — a file with any live row stays until a later sweep.
        Returns the number of files dropped."""
        ttl = self.options.ttl_ms
        if not ttl:
            return 0
        from greptimedb_tpu_torch.datatypes.types import TimeUnit

        # SST ts_max is in the table's native time unit — convert the
        # ms cutoff (a TIMESTAMP(0) table must not compare seconds
        # against milliseconds: that expires everything instantly)
        unit = self.schema.time_index.dtype.time_unit
        cutoff = TimeUnit.MILLISECOND.convert(self._now_ms() - ttl, unit)
        expired = [m for m in self.sst_files if m.ts_max < cutoff]
        if not expired:
            return 0
        self.manifest.commit({
            "kind": "edit", "add": [],
            "remove": [m.file_id for m in expired],
        })
        for m in expired:
            self.store.delete(m.path)
            self.store.delete(self._index_path(m))
            self._index_cache.pop(m.file_id, None)
        self.generation += 1
        self._mark_structure_change()
        return len(expired)

    def compact_files(self, files: list[SstMeta]) -> SstMeta:
        """Merge SSTs: sort, dedup keep-last, drop tombstones fully covered.

        Reference: TWCS picker + merge (src/mito2/src/compaction/twcs.rs).
        Tombstones are dropped only when the merge covers the whole region
        history for that key range — conservatively, when the input includes
        every SST file (full compaction); otherwise they are carried over.
        """
        from greptimedb_tpu_torch.storage.scan import (
            estimate_staging_bytes, merge_parts, prefetch_store, read_parts,
        )

        # parallel decode through the scan pipeline, on the CODE path:
        # tags travel as region-code companions (read_sst maps each
        # file's dictionary once), so the rewrite never re-hashes a raw
        # string, and write_sst below rebuilds dictionary pages straight
        # from the codes.  Inputs are sorted SSTs — the sorted-run merge
        # replaces the global lexsort.
        prefetch_store(self.store, files)
        est = estimate_staging_bytes(files, len(self.schema) + 3)
        parts = read_parts(
            [
                (lambda m=m: read_sst(self.store, m, self.schema,
                                      tag_encoders=self.encoders,
                                      decode_tags=False))
                for m in files
            ],
            memory=self.memory, est_bytes=est,
        )
        merged, _path = merge_parts(parts, self.ts_name, TSID, SEQ)
        if not self.options.append_mode:
            tsid, ts = merged[TSID], merged[self.ts_name]
            keep = np.ones(len(tsid), dtype=bool)
            if len(tsid) > 1:
                same = (tsid[1:] == tsid[:-1]) & (ts[1:] == ts[:-1])
                keep[:-1] = ~same
            merged = {k: v[keep] for k, v in merged.items()}
        full = len(files) == len(self.sst_files) and self.memtable.is_empty
        if full:
            alive = merged[OP] != OP_DELETE
            merged = {k: v[alive] for k, v in merged.items()}
        new_meta = write_sst(
            self.store, f"{self._dir}/sst", self.schema, merged,
            level=max(m.level for m in files) + 1,
            tag_dicts={k: enc.values() for k, enc in self.encoders.items()},
        )
        self._write_sst_index(new_meta, merged)
        self.manifest.commit(
            {
                "kind": "edit",
                "add": [new_meta.to_dict()],
                "remove": [m.file_id for m in files],
            }
        )
        for m in files:
            self.store.delete(m.path)
            self.store.delete(self._index_path(m))
            self._index_cache.pop(m.file_id, None)
        self.generation += 1
        self._mark_structure_change()
        return new_meta

    def compact(self) -> None:
        """Full compaction of all SSTs (admin function, reference
        src/common/function/src/admin.rs compact_region)."""
        if self.memtable.num_rows:
            self.flush()
        self.apply_ttl()
        for _attempt in range(8):
            files = self.sst_files
            if not files:
                return
            try:
                self.compact_files(files)
                return
            except SstCorruption as e:
                # quarantine/repair the bad input, retry over the
                # refreshed live set
                self._handle_sst_corruption(e)

    def truncate(self) -> None:
        for m in self.sst_files:
            self.store.delete(m.path)
            self.store.delete(self._index_path(m))
        self._index_cache.clear()
        self.manifest.commit({"kind": "truncate", "truncated_seq": self.next_seq - 1})
        self.memtable = Memtable(self.schema)
        self.generation += 1
        self._mark_structure_change()

    def install_fence(self, epoch: int) -> None:
        """Arm leader-epoch fencing on every shared-storage
        write surface this region owns: manifest deltas/checkpoints go
        through conditional puts under the epoch claim, and remote-WAL
        appends/watermark advances carry the epoch to the broker.  The
        epoch is minted by Metasrv at open/failover/migration-upgrade;
        a delayed write from a fenced-out predecessor then fails loudly
        (FencedError) instead of forking history.  No-op when
        GREPTIME_S3_FENCING=off."""
        from greptimedb_tpu_torch.storage.manifest import fencing_enabled

        if not fencing_enabled():
            return
        self.manifest.set_fence(epoch)
        set_wal = getattr(self.wal, "set_fence", None)
        if set_wal is not None:
            set_wal(epoch)
        self.fence_epoch = int(epoch)

    # ---- proactive integrity (driven by storage/scrubber.py) -----------
    def scrub_wal(self) -> dict:
        """Verify every WAL segment NOW, while every acked row is still
        recoverable, instead of letting the next crash's replay find the
        rot.  Damage below the flushed floor just drops (rows live in
        SSTs; bytes preserved in sidecars).  A lost acked range above
        the floor resyncs from ``wal_resync`` (remote WAL / follower
        replica) and re-logs durably; with no covering source the region
        FLUSHES instead — the live memtable still holds every acked row,
        so advancing the durable floor past the hole repairs durability
        with zero loss (the option a crash-time replay no longer has)."""
        wal = self.wal
        if not isinstance(wal, FileLogStore):
            return {"damage": 0, "repaired": 0, "flushed": False}
        with self._write_lock:
            damages = wal.verify()
            if not damages:
                return {"damage": 0, "repaired": 0, "flushed": False}
            floor = self.manifest.state.flushed_seq + 1
            acked_hi = self.next_seq - 1
            holes: list[tuple[int, int]] = []
            for d in damages:
                if d.kind == "torn_tail":
                    # on a LIVE region the tail is acked data, never
                    # crash debris: everything up to next_seq-1 was acked
                    lo = (d.prev_seq + 1) if d.prev_seq is not None else 1
                    hi = acked_hi
                else:
                    r = d.lost_range()
                    if r is None:
                        continue  # garbage between consecutive sequences
                    lo, hi = r
                    hi = acked_hi if hi is None else hi
                lo = max(lo, floor)
                if hi < lo:
                    continue  # fully below the floor: already in SSTs
                holes.append((lo, hi))
            fetched: list[tuple[int, bytes]] = []
            covered = bool(holes) and self.wal_resync is not None
            if covered:
                for lo, hi in holes:
                    got = sorted(self.wal_resync(lo, hi))
                    if {s for s, _ in got} != set(range(lo, hi + 1)):
                        covered = False
                        break
                    fetched.extend(got)
            # SECURE the recovery durably FIRST, drop the damage LAST:
            # a crash anywhere in between must leave the corruption
            # loud (triaged at the next open), never a silently-clean
            # log missing acked rows (the _resync_wal_holes ordering)
            repaired = 0
            flushed = False
            if not holes:
                wal.drop_damage(damages)  # sub-floor debris only
            elif covered:
                if any(d.kind == "torn_tail" for d in damages):
                    # re-logging INTO a damaged tail would be destroyed
                    # by the tail truncation below (and truncating first
                    # would silently clean an unrecovered hole): roll to
                    # a fresh segment, so the re-logged records survive
                    # and interim crashes replay the damage as interior
                    # (valid records follow) — still loud, still triaged
                    wal._roll()
                for s, p in fetched:
                    wal.append(s, p)  # re-log durably
                wal.drop_damage(damages)
                repaired = len(fetched)
                M_REPAIRED.labels("wal", "scrub_resync").inc(repaired)
            else:
                # flush advances the durable floor past the hole (the
                # memtable holds every acked row); only then is the
                # damage mere sub-floor debris safe to drop
                self._flush_locked()
                wal.drop_damage(damages)
                flushed = True
                M_REPAIRED.labels("wal", "scrub_flush").inc()
            return {"damage": len(damages), "repaired": repaired,
                    "flushed": flushed}

    def scrub_manifest(self) -> dict:
        """Verify every on-disk manifest file against its CRC envelope.
        A corrupt file is quarantined, and — because the LIVE in-memory
        state supersedes the whole on-disk chain — repaired by forcing a
        fresh read-back-verified checkpoint, whose GC then collapses the
        damaged history.  The restart that would otherwise have tripped
        over the rot (possibly quarantining the region) now opens from
        the clean checkpoint."""
        from greptimedb_tpu_torch.storage.durability import M_CORRUPTION
        from greptimedb_tpu_torch.storage.manifest import (
            _decode_file, _encode_file,
        )

        checked = 0
        with self._write_lock:
            corrupt: list[str] = []
            epoch_bad = False
            for p in self.store.list(self.manifest.dir):
                if "/quarantine/" in p:
                    # moved-aside corpses: already flagged, preserved,
                    # never live — re-scrubbing them would re-quarantine
                    # (a self-rename that DELETES the bytes on rename-
                    # less remote stores) and alert forever
                    continue
                fn = p.rsplit("/", 1)[-1]
                is_epoch = fn == "EPOCH"
                if not (fn.startswith("checkpoint-")
                        or fn.startswith("delta-") or is_epoch):
                    continue
                try:
                    raw = self.store.read(p)
                except Exception:  # noqa: BLE001 — vanished under GC
                    continue
                checked += 1
                if _decode_file(raw) is None:
                    M_CORRUPTION.labels("manifest", "scrub").inc()
                    if is_epoch:
                        epoch_bad = True
                    else:
                        corrupt.append(p)
            if epoch_bad and self.manifest.fence_epoch is not None:
                # rewrite the epoch marker from the armed fence — a
                # rotted marker must not degrade fencing to "unknown"
                # forever.  CAS on the CORRUPT bytes' etag: if another
                # leader (re)claimed between our read and this write,
                # the replace loses instead of rolling its claim back.
                from greptimedb_tpu_torch.errors import FencedError
                from greptimedb_tpu_torch.storage.object_store import (
                    content_etag,
                )

                _ep, raw = self.manifest._read_epoch()
                if raw is not None and _decode_file(raw) is None:
                    try:
                        self.store.write_if(
                            self.manifest._epoch_path,
                            _encode_file(
                                {"epoch": self.manifest.fence_epoch}),
                            if_match=content_etag(raw))
                        M_REPAIRED.labels("manifest", "scrub_epoch").inc()
                    except FencedError:
                        pass  # someone else repaired/reclaimed: theirs wins
            if not corrupt:
                return {"checked": checked, "corrupt": 1 if epoch_bad
                        else 0}
            self.manifest.quarantine_files(corrupt)
            # the live state is the authority: a fresh verified
            # checkpoint re-establishes clean on-disk history and GCs
            # whatever the damaged versions still covered
            self.manifest.checkpoint()
            M_REPAIRED.labels("manifest", "scrub_checkpoint").inc()
            return {"checked": checked,
                    "corrupt": len(corrupt) + (1 if epoch_bad else 0)}

    def catch_up(self, take_ownership: bool = False) -> None:
        """Re-sync this region from shared storage (follower sync, leader
        upgrade after migration — reference handle_catchup.rs): reload the
        manifest, REHYDRATE tag dictionaries and the series registry from it
        (stale encoders would mint colliding tsids against newer SSTs),
        drop memtable state, sync the sequence counter, replay the WAL.

        ``take_ownership=True`` (leader upgrade) additionally repairs torn
        WAL tails; followers replay read-only — the leader may be mid-append
        on the shared segment."""
        from greptimedb_tpu_torch.storage.manifest import Manifest

        try:
            self.manifest = Manifest.open(self.store, f"{self._dir}/manifest")
        except ManifestCorruption as mc:
            # same recovery gate as engine open: proceed on the good
            # prefix only when OUR replayable WAL covers the lost
            # actions.  Only an ownership-taking catch-up (leader
            # upgrade) may move the suspect files aside — followers stay
            # read-only on shared storage.
            floor = None
            for seq, _p in self.wal.replay(0, repair=False):
                floor = seq
                break
            covered = (mc.tail_only and mc.manifest.exists
                       and floor is not None
                       and floor <= mc.manifest.state.flushed_seq + 1)
            if not covered:
                raise
            if take_ownership:
                mc.manifest.quarantine_files(mc.bad_files)
            M_REPAIRED.labels("manifest", "wal_replay").inc()
            self.manifest = mc.manifest
        if self.fence_epoch is not None:
            # the reopened Manifest object starts unfenced: re-arm the
            # claim this region already holds (idempotent re-claim).  A
            # SUPERSEDED claim (this node was demoted and is now being
            # re-promoted under a NEWER minted epoch) must not wedge the
            # promotion: drop the stale arm — the grant handler installs
            # the new epoch right after this catch-up.
            from greptimedb_tpu_torch.errors import FencedError

            try:
                self.manifest.set_fence(self.fence_epoch)
            except FencedError:
                self.fence_epoch = None
        state = self.manifest.state
        # adopt the manifest schema FIRST: the leader may have added tag
        # columns online (add_tag_column), and encoders built from the stale
        # schema would miss them, breaking the next replay/write
        if state.schema is not None:
            self.schema = state.schema
        self.encoders = {
            c.name: DictionaryEncoder(state.dicts.get(c.name, []))
            for c in self.schema.tag_columns
        }
        self._series = {
            tuple(codes): i for i, codes in enumerate(state.series)
        }
        self._dictcol_memo.clear()
        self._series_map1 = None
        self.memtable = Memtable(self.schema)
        self.next_seq = max(self.next_seq, state.flushed_seq + 1)
        if take_ownership:
            # shared-log stores must re-read the topic tail before this
            # promoted region appends (stale cached end-offsets collide)
            acquire = getattr(self.wal, "acquire_ownership", None)
            if acquire is not None:
                acquire()
        self.replay_wal(repair=take_ownership)
        self.generation += 1
        self._mark_structure_change()
        self._index_cache.clear()

    def storage_fingerprint(self) -> tuple:
        """Cheap change detector for no-op sync skipping: manifest file set
        + WAL segment names/sizes."""
        import os as _os

        manifest_files = tuple(self.store.list(f"{self._dir}/manifest"))
        wal_state: tuple = ()
        if hasattr(self.wal, "dir"):
            try:
                wal_state = tuple(
                    (fn, _os.path.getsize(_os.path.join(self.wal.dir, fn)))
                    for fn in sorted(_os.listdir(self.wal.dir))
                )
            except OSError:
                wal_state = ()
        return (manifest_files, wal_state)

    def ts_bounds(self) -> tuple[int, int] | None:
        """Data time bounds across memtable + SSTs; None when empty (an
        empty region must not drag a combined view's bounds to epoch 0)."""
        lo = self.memtable.ts_min
        hi = self.memtable.ts_max
        for m in self.sst_files:
            lo = m.ts_min if lo is None else min(lo, m.ts_min)
            hi = m.ts_max if hi is None else max(hi, m.ts_max)
        if lo is None:
            return None
        return (lo, hi)

    # ---- skipping index -------------------------------------------------
    def _index_path(self, meta) -> str:
        return f"{self._dir}/sst/{meta.file_id}.idx"

    def _write_sst_index(self, meta, columns: dict[str, np.ndarray]) -> None:
        from greptimedb_tpu_torch.storage.index import build_sst_index

        tag_names = self.tag_names
        from greptimedb_tpu_torch.datatypes.types import ConcreteDataType

        # full-text token sets for textual FIELD columns (log lines): the
        # bloom-based fulltext backend's file-pruning tier.  VECTOR/BINARY
        # are string-like in storage but tokenizing them is pure waste.
        ft_cols = [
            c.name for c in self.schema.field_columns
            if c.dtype in (ConcreteDataType.STRING, ConcreteDataType.JSON)
            and c.name in columns
        ]
        if not tag_names and not ft_cols:
            return
        has_tomb = bool((columns[OP] == OP_DELETE).any()) if OP in columns else False
        # distinct values per tag from the dictionary-code companion
        # columns when present: unique over int32 codes beats unique over
        # object strings by an order of magnitude on wide batches
        tag_uniques: dict[str, list] = {}
        for name in tag_names:
            codes = columns.get(tagcode_col(name))
            if codes is None:
                continue
            vocab = self.encoders[name].values()
            tag_uniques[name] = [vocab[int(c)] for c in np.unique(codes)]
        self.store.write(
            self._index_path(meta),
            build_sst_index(columns, tag_names, fulltext_columns=ft_cols,
                            has_tombstones=has_tomb,
                            tag_uniques=tag_uniques or None),
        )

    def _sst_index(self, meta) -> dict | None:
        from greptimedb_tpu_torch.storage.index import load_sst_index

        cached = self._index_cache.get(meta.file_id)
        if cached is not None:
            return cached
        if not self.store.exists(self._index_path(meta)):
            return None  # pre-index SSTs: no pruning
        idx = load_sst_index(self.store.read(self._index_path(meta)))
        self._index_cache[meta.file_id] = idx
        return idx

    # ---- SST corruption: quarantine + repair ---------------------------
    def _handle_sst_corruption(self, exc: SstCorruption) -> str:
        """A verified read failed: move the damaged file aside (bytes
        preserved), then repair from a replica (``repair_source``) or
        re-flush from the WAL when the file's sequence range survived
        truncation; otherwise pull it from the live set via a manifest
        quarantine action so the region keeps serving its remaining
        files.  Returns "repaired" or "quarantined" (both mean: retry the
        read)."""
        meta = exc.meta
        with self._write_lock:
            if meta.file_id not in self.manifest.state.files:
                return "quarantined"  # another thread already handled it
            try:
                quarantine_object(self.store, meta.path)
            except (KeyError, OSError):
                pass  # file vanished entirely: nothing left to preserve
            M_QUARANTINED.labels("sst").inc()
            self._index_cache.pop(meta.file_id, None)
            # 1) replica repair over the Flight object plane
            if self.repair_source is not None:
                from greptimedb_tpu_torch.storage.sst import verify_sst_bytes

                data = self.repair_source(meta.path)
                if data is not None and verify_sst_bytes(data):
                    self.store.write(meta.path, data)
                    M_REPAIRED.labels("sst", "replica").inc()
                    return "repaired"
            # 2) WAL re-flush: a flush-produced file whose sequence range
            # is still fully in the log (truncation crashed or lagged)
            if self._reflush_sst_from_wal(meta):
                M_REPAIRED.labels("sst", "wal").inc()
                self.generation += 1
                self._mark_structure_change()
                return "repaired"
            # 3) serve around it, loudly: the quarantine action pulls the
            # file from the live set and records it in manifest state
            self.manifest.commit(
                {"kind": "quarantine", "file_id": meta.file_id})
            self.generation += 1
            self._mark_structure_change()
            return "quarantined"

    def _reflush_sst_from_wal(self, meta) -> bool:
        """Rebuild a corrupt SST from WAL records covering exactly its
        sequence range (valid for flush-produced files: one freeze, one
        contiguous range).  Commits a replace edit on success."""
        recs = []
        for s, p in self.wal.replay(meta.seq_min, repair=False):
            if meta.seq_min <= s <= meta.seq_max:
                recs.append((s, p))
        got = {s for s, _ in recs}
        if got != set(range(meta.seq_min, meta.seq_max + 1)):
            return False  # not fully covered: never rebuild a partial file
        mt = Memtable(self.schema)
        for s, p in sorted(recs):
            mt.append(self._decode_wal_chunk(s, p))
        frozen = mt.freeze(dedup=not self.options.append_mode)
        new_meta = write_sst(
            self.store, f"{self._dir}/sst", self.schema, frozen,
            level=meta.level,
            tag_dicts={k: enc.values() for k, enc in self.encoders.items()},
        )
        self._write_sst_index(new_meta, frozen)
        self.manifest.commit({
            "kind": "edit",
            "add": [new_meta.to_dict()],
            "remove": [meta.file_id],
        })
        return True

    # ---- read path -----------------------------------------------------
    def scan_host(
        self,
        ts_range: tuple[int | None, int | None] = (None, None),
        columns: list[str] | None = None,
        tag_filters: dict[str, set] | None = None,
        tag_preds: dict[str, object] | None = None,
        ft_tokens: dict[str, list] | None = None,
        with_tag_codes: bool = False,
    ) -> dict[str, np.ndarray]:
        """Verified scan: on SST corruption the file is quarantined (and
        repaired from a replica / WAL re-flush when covered) and the scan
        retries — the region keeps serving from its remaining files; the
        corrupt bytes are never merged into results.  See
        ``_scan_host_impl`` for the scan machinery itself."""
        for _attempt in range(8):
            try:
                return self._scan_host_impl(ts_range, columns, tag_filters,
                                            tag_preds, ft_tokens,
                                            with_tag_codes)
            except SstCorruption as e:
                self._handle_sst_corruption(e)
        return self._scan_host_impl(ts_range, columns, tag_filters,
                                    tag_preds, ft_tokens, with_tag_codes)

    def _scan_host_impl(
        self,
        ts_range: tuple[int | None, int | None] = (None, None),
        columns: list[str] | None = None,
        tag_filters: dict[str, set] | None = None,
        tag_preds: dict[str, object] | None = None,
        ft_tokens: dict[str, list] | None = None,
        with_tag_codes: bool = False,
    ) -> dict[str, np.ndarray]:
        """Merged, deduped host columns for the requested time range.

        Sources: SSTs overlapping the range (file-level time pruning, bloom
        skipping-index pruning on ``tag_filters`` equality/IN sets, then
        Parquet row-group pruning) and the live memtable.  Selected SSTs
        decode CONCURRENTLY on the scan pipeline's bounded pool
        (storage/scan.py; ``GREPTIME_SCAN_THREADS``), with scan-driven
        readahead on prefetching object stores, and sources merge by
        sorted-run merge instead of a global lexsort.  Dedup keep-max-seq
        across sources; tombstones applied then dropped.

        ``tag_preds`` maps tag columns to term predicates (e.g. compiled
        regex matchers) used for FILE-LEVEL pruning only, via the sidecar's
        exact term dictionary (inverted-index analog) — the caller still
        applies the predicate row-wise to the returned columns.
        ``ft_tokens`` maps string-FIELD columns to full-text query tokens
        (AND semantics) pruned against the sidecar token sets.

        ``with_tag_codes=True`` is the code-path scan for device-cache
        builds: string tag columns come back as ``__tagcode_<name>__``
        int32 companions in region code space INSTEAD of raw object
        arrays — no per-row python object is ever materialized for a
        dictionary-encoded column on this path.
        """
        from greptimedb_tpu_torch.storage.index import (
            sst_may_match, sst_pred_may_match, sst_tokens_may_match,
        )
        from greptimedb_tpu_torch.storage.scan import (
            M_SCAN_FILES, estimate_staging_bytes, merge_parts,
            prefetch_store, read_parts,
        )
        from greptimedb_tpu_torch.utils.tracing import TRACER

        want = None
        if columns is not None:
            internal = [TSID, SEQ, OP, self.ts_name]
            want = list(dict.fromkeys(columns + internal))
        selected: list[SstMeta] = []
        total = 0
        for m in self.sst_files:
            total += 1
            if not m.overlaps(*ts_range):
                continue
            if tag_filters or tag_preds or ft_tokens:
                idx = self._sst_index(m)
                if idx is not None:
                    if tag_filters and not sst_may_match(idx, tag_filters):
                        continue
                    if tag_preds and not all(
                        sst_pred_may_match(idx, col, pred)
                        for col, pred in tag_preds.items()
                    ):
                        continue
                    if ft_tokens and not all(
                        sst_tokens_may_match(idx, col, toks)
                        for col, toks in ft_tokens.items()
                    ):
                        continue
            selected.append(m)
        if total:
            M_SCAN_FILES.labels("pruned").inc(total - len(selected))
        internal = (TSID, SEQ, OP)
        schema_cols = {c.name for c in self.schema}
        eff_want = (want if want is not None
                    else list(schema_cols) + list(internal))
        # code-path tags: string tags only (integer tags are not
        # dictionary-encoded in SSTs and stay raw on either path)
        code_tags = {
            c.name for c in self.schema.tag_columns
            if c.dtype.is_string_like and c.name in eff_want
        } if with_tag_codes else set()
        code_cols = {tagcode_col(t) for t in code_tags}
        tag_enc = self.encoders if with_tag_codes else None
        with TRACER.stage("scan", region=self.region_id,
                          files=len(selected)):
            prefetch_store(self.store, selected)
            est = estimate_staging_bytes(selected, len(eff_want), ts_range)
            with TRACER.stage("scan_decode", files=len(selected)):
                parts = read_parts(
                    [
                        (lambda m=m: read_sst(
                            self.store, m, self.schema, ts_range, want,
                            tag_filters, tag_encoders=tag_enc,
                            decode_tags=not with_tag_codes))
                        for m in selected
                    ],
                    memory=self.memory, est_bytes=est,
                )
            if not self.memtable.is_empty:
                lo, hi = ts_range
                for chunk in self.memtable.snapshot_chunks():
                    ts = chunk[self.ts_name]
                    sel = np.ones(len(ts), dtype=bool)
                    if lo is not None:
                        sel &= ts >= lo
                    if hi is not None:
                        sel &= ts < hi
                    if not sel.any():
                        continue
                    part = {
                        k: v[sel]
                        for k, v in chunk.items()
                        if (k in code_cols) or (
                            k in eff_want and k not in code_tags
                            and (k in schema_cols or k in internal))
                    }
                    n = int(sel.sum())
                    for c in self.schema:  # chunks predating ALTER ADD
                        if c.name not in eff_want or c.name in part:
                            continue
                        if c.name in code_tags:
                            if tagcode_col(c.name) not in part:
                                fill = default_fill_array(c, 1)[0]
                                code = self.encoders[c.name].get_or_insert(
                                    fill)
                                part[tagcode_col(c.name)] = np.full(
                                    n, code, dtype=np.int32)
                        else:
                            part[c.name] = default_fill_array(c, n)
                    parts.append(part)
            if not parts:
                empty: dict[str, np.ndarray] = {}
                for c in self.schema:
                    if want is None or c.name in want:
                        if c.name in code_tags:
                            empty[tagcode_col(c.name)] = np.empty(
                                0, dtype=np.int32)
                        else:
                            empty[c.name] = np.empty(
                                0, dtype=object if c.dtype.is_string_like
                                else np.int64 if c.dtype.is_timestamp
                                else c.dtype.to_numpy()
                            )
                empty[TSID] = np.empty(0, dtype=np.int64)
                empty[SEQ] = np.empty(0, dtype=np.int64)
                empty[OP] = np.empty(0, dtype=np.int8)
                return empty
            with TRACER.stage("scan_merge", parts=len(parts)):
                merged, _path = merge_parts(parts, self.ts_name, TSID, SEQ)
            keep = np.ones(len(merged[TSID]), dtype=bool)
            if not self.options.append_mode:
                tsid, ts = merged[TSID], merged[self.ts_name]
                if len(tsid) > 1:
                    same = (tsid[1:] == tsid[:-1]) & (ts[1:] == ts[:-1])
                    keep[:-1] = ~same
            alive = keep & (merged[OP] != OP_DELETE)
            return {k: v[alive] for k, v in merged.items()}


class RegionEngine:
    """Owns all regions under one data home (the datanode's storage engine,
    reference RegionServer + MitoEngine)."""

    def __init__(self, data_home: str,
                 default_options: RegionOptions | None = None,
                 log_store_factory=None,
                 store: "ObjectStore | None" = None,
                 memory=None):
        self.data_home = data_home
        # default: local disk; pass an S3ObjectStore (storage/s3.py) for
        # cloud storage — WAL stays local/remote-broker either way
        self.store = store if store is not None else FsObjectStore(data_home)
        self.default_options = default_options or RegionOptions()
        self.regions: dict[int, Region] = {}
        # region_id -> LogStore; None = node-local file WAL.  A remote
        # factory (e.g. RemoteLogStore over a SharedLogBroker) makes the
        # node (nearly) stateless: failover replays from shared infra
        self.log_store_factory = log_store_factory
        # optional WorkloadMemoryManager shared by all regions (ingest
        # write-buffer quota); settable post-init by the embedding app
        self.memory = memory
        # region_id -> {"repair_source": ..., "wal_resync": ...}: repair
        # hooks installed on a region BEFORE its open-time WAL replay, so
        # interior corruption found at open can resync instead of raising
        # (meta/cluster.py wire_repair_sources sets the live equivalents)
        self.repair_hooks: dict[int, dict] = {}

    def _log_store(self, region_id: int):
        if self.log_store_factory is None:
            return None
        return self.log_store_factory(region_id)

    def _wal_dir(self, region_id: int) -> str:
        return os.path.join(self.data_home, f"region_{region_id}", "wal")

    # ---- manifest corruption recovery ---------------------------------
    def _wal_floor(self, region_id: int) -> int | None:
        """Smallest sequence still replayable from the region's WAL, or
        None when the log is empty/absent — the cover probe for manifest
        recovery."""
        log = self._log_store(region_id)
        close = False
        if log is None:
            wal_dir = self._wal_dir(region_id)
            if not os.path.isdir(wal_dir):
                return None
            log = FileLogStore(wal_dir)
            close = True
        try:
            for seq, _payload in log.replay(0, repair=False):
                return seq
            return None
        finally:
            if close:
                log.close()

    def _open_manifest_verified(self, region_id: int) -> Manifest:
        """Manifest.open with corrupt-delta recovery: when verification
        fails past a good prefix, recover through WAL replay if the log
        covers everything since the prefix's flushed_seq (suspect files
        move to ``quarantine/``, open proceeds, replay restores the data
        actions); otherwise quarantine the REGION — files moved aside,
        marker written, open fails loudly until an operator intervenes.
        Never silently applies metadata over a hole."""
        try:
            return Manifest.open(self.store, f"region_{region_id}/manifest")
        except ManifestCorruption as mc:
            m = mc.manifest
            floor = self._wal_floor(region_id)
            # recoverable ONLY when (a) the damage is tail-shaped (the
            # lost action was the unacked commit a crash tore — an acked
            # mid-chain action could be a schema/dicts change WAL replay
            # cannot re-derive) and (b) the WAL actually replays from
            # the prefix's flushed_seq
            covered = (mc.tail_only and m.exists and floor is not None
                       and floor <= m.state.flushed_seq + 1)
            m.quarantine_files(mc.bad_files)
            if not covered:
                m.quarantine_region(mc.detail)
                raise RegionQuarantined(
                    f"region {region_id}: {mc.detail}; not recoverable "
                    f"(tail_only={mc.tail_only}, WAL floor={floor}, "
                    f"prefix flushed_seq={m.state.flushed_seq}) — region "
                    "quarantined, files preserved under manifest/"
                    "quarantine/") from mc
            M_REPAIRED.labels("manifest", "wal_replay").inc()
            return m

    def create_region(
        self, region_id: int, schema: Schema,
        options: RegionOptions | None = None,
    ) -> Region:
        if region_id in self.regions:
            raise StorageError(f"region {region_id} already open")
        opts = options or self.default_options
        manifest = Manifest.open(self.store, f"region_{region_id}/manifest")
        if manifest.exists:
            raise StorageError(f"region {region_id} already exists on disk")
        manifest.commit({"kind": "schema", "schema": schema.to_dict()})
        manifest.commit({"kind": "options", "options": opts.to_dict()})
        region = Region(region_id, self.store, schema, manifest,
                        self._wal_dir(region_id), opts,
                        log_store=self._log_store(region_id),
                        memory=self.memory)
        self.regions[region_id] = region
        return region

    def ensure_region(
        self, region_id: int, schema: Schema,
        options: RegionOptions | None = None,
    ) -> Region:
        """Idempotent create-or-open for resumable procedures: an open
        region or an on-disk manifest from a prior attempt is adopted;
        only a genuinely absent region is created. Real storage failures
        propagate untouched (never masked as already-exists). The manifest
        opened for the existence probe is handed to the create/open path —
        manifest open is checkpoint+delta reads, costly on object stores."""
        if region_id in self.regions:
            return self.regions[region_id]
        manifest = self._open_manifest_verified(region_id)
        if manifest.exists:
            return self.open_region(region_id, _manifest=manifest)
        # create path re-opens fresh: the immediately-pre-commit existence
        # re-check is what makes two nodes racing create on a shared object
        # store fail loudly instead of committing duplicate schema actions
        return self.create_region(region_id, schema, options)

    def open_region(self, region_id: int, take_ownership: bool = True,
                    _manifest: "Manifest | None" = None) -> Region:
        """Open an existing region.  ``take_ownership=False`` = follower open:
        replay the (possibly leader-shared) WAL read-only, never repairing
        torn tails the live leader may still be appending."""
        if region_id in self.regions:
            return self.regions[region_id]
        manifest = (_manifest if _manifest is not None
                    else self._open_manifest_verified(region_id))
        if not manifest.exists:
            raise RegionNotFound(f"region {region_id} not found in {self.data_home}")
        opts = RegionOptions(**manifest.state.options) if manifest.state.options else self.default_options
        region = Region(region_id, self.store, manifest.state.schema, manifest,
                        self._wal_dir(region_id), opts,
                        log_store=self._log_store(region_id),
                        memory=self.memory)
        hooks = self.repair_hooks.get(region_id) or {}
        region.repair_source = hooks.get("repair_source")
        region.wal_resync = hooks.get("wal_resync")
        region.replay_wal(repair=take_ownership)
        self.regions[region_id] = region
        return region

    def gc(self, grace_seconds: float = 3600.0) -> list[str]:
        """Global GC sweep (reference src/mito2/src/gc.rs + the global GC
        worker RFC 2025-07-23): delete SST/index objects under open
        regions' directories that no manifest references and that are
        older than the grace period (in-flight flushes commit their
        manifest edit AFTER the object write — grace covers the window).
        Returns deleted paths."""
        import re as _re
        import time as _time

        deleted: list[str] = []
        now = _time.time()
        # discover regions from STORAGE, not just open handles — the GC
        # worker typically runs against a data home with nothing open
        ids = set(self.regions)
        for path in self.store.list(""):
            m = _re.match(r"region_(\d+)/", path)
            if m:
                ids.add(int(m.group(1)))
        for rid in sorted(ids):
            region = self.regions.get(rid)
            if region is not None:
                files = region.sst_files
                quarantined = region.manifest.state.quarantined
            else:
                try:
                    manifest = Manifest.open(
                        self.store, f"region_{rid}/manifest")
                except (ManifestCorruption, RegionQuarantined):
                    continue  # unverifiable live set: GC must not guess
                if not manifest.exists:
                    continue  # not a region we can reason about: skip
                files = list(manifest.state.files.values())
                quarantined = manifest.state.quarantined
            live = {m.path for m in files}
            live |= {f"region_{rid}/sst/{m.file_id}.idx" for m in files}
            # quarantined SSTs stay repairable: never GC their objects
            live |= {d["path"] for d in quarantined.values()}
            live |= {f"region_{rid}/sst/{fid}.idx" for fid in quarantined}
            prefix = f"region_{rid}/sst"
            for path in self.store.list(prefix):
                if path in live:
                    continue
                if not _re.search(r"\.(parquet|idx)$", path):
                    continue
                mtime = self.store.last_modified(path)
                if mtime is None:
                    continue  # cannot prove age: never risk an in-flight flush
                if now - mtime < grace_seconds:
                    continue
                self.store.delete(path)
                deleted.append(path)
        return deleted

    def close_region(self, region_id: int) -> None:
        """Detach a region WITHOUT deleting its objects (recycle-bin drop:
        the data must survive until undrop or purge)."""
        region = self.regions.pop(region_id, None)
        if region is not None:
            region.wal.close()

    def drop_region(self, region_id: int) -> None:
        region = self.regions.pop(region_id, None)
        prefix = f"region_{region_id}"
        for p in self.store.list(prefix):
            self.store.delete(p)
        if region is not None:
            region.wal.close()

    def close(self, flush: bool = False) -> None:
        """Close WAL/segment handles; with ``flush=True`` (the graceful
        SIGTERM shutdown path — standalone CLI, datanode serve) dirty
        regions flush first, their WALs truncate to the hot tail, and a
        clean restart replays O(recent) instead of the full log.  The
        default stays cheap for embedders/tests — a dirty region simply
        replays on the next open (the crash path, which is exercised
        constantly).  Flush failures are surfaced on stderr but never
        block the close."""
        for r in self.regions.values():
            if flush:
                try:
                    r.flush()
                except Exception as e:  # noqa: BLE001 — shutdown must
                    import sys as _sys   # finish; replay covers the rest

                    print(f"flush-on-close failed for region "
                          f"{r.region_id}: {e}", file=_sys.stderr)
            r.wal.close()
        self.regions.clear()
