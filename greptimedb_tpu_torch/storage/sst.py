"""SST layer: sorted Parquet files with pruning stats.

Equivalent of the reference's flat SST format
(src/mito2/src/sst/parquet/flat_format.rs: raw key columns + __primary_key/
__sequence/__op_type internal columns): each SST stores the table's columns
(tags dictionary-encoded by Parquet itself) plus __tsid__/__seq__/__op__,
sorted by (tsid, ts, seq). File-level stats (time range, row count, seq
range) live in the manifest for pruning; row-group stats inside the Parquet
footer give a second pruning level (reference reader.rs row-group pruning).
"""

from __future__ import annotations

import io
import threading
import uuid
from dataclasses import dataclass, field

import numpy as np

from greptimedb_tpu_torch.datatypes.schema import Schema, default_fill_array
from greptimedb_tpu_torch.storage.durability import M_CORRUPTION, SstCorruption
from greptimedb_tpu_torch.storage.memtable import OP, SEQ, TSID, tagcode_col
from greptimedb_tpu_torch.storage.object_store import ObjectStore
from greptimedb_tpu_torch.utils.chaos import CHAOS
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

# per-row python-object materializations for dictionary-encoded string
# columns.  The code-path scan (``tag_encoders`` + ``decode_tags=False``)
# keeps dictionary indices as region codes instead; a tier-1 guard pins
# that the hot scan path (device-cache builds) never grows this counter.
M_OBJECT_DECODE_ROWS = REGISTRY.counter(
    "greptime_scan_object_decode_rows_total",
    "Rows decoded into per-row python objects from dictionary-encoded "
    "columns (0 on the code-path scan)",
)

# the rare legacy fallback in _dict_to_codes mutates a region encoder from
# a decode thread; serialize those inserts (scans may decode in parallel)
_ENCODER_FALLBACK_LOCK = threading.Lock()


@dataclass(frozen=True)
class SstMeta:
    file_id: str
    path: str
    num_rows: int
    ts_min: int
    ts_max: int
    seq_min: int
    seq_max: int
    size_bytes: int
    level: int = 0
    # column names present in the file (schema evolution: old SSTs may lack
    # later-added columns); None only for metas persisted before this field
    columns: tuple[str, ...] | None = None

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["columns"] = list(self.columns) if self.columns is not None else None
        return d

    @staticmethod
    def from_dict(d: dict) -> "SstMeta":
        cols = d.get("columns")
        d = dict(d)
        d["columns"] = tuple(cols) if cols is not None else None
        return SstMeta(**d)

    def overlaps(self, ts_start: int | None, ts_end: int | None) -> bool:
        """Half-open [ts_start, ts_end) vs this file's closed [min,max]."""
        if ts_start is not None and self.ts_max < ts_start:
            return False
        if ts_end is not None and self.ts_min >= ts_end:
            return False
        return True


def _arrow_schema(schema: Schema) -> pa.Schema:
    import pyarrow as pa

    fields = []
    for c in schema:
        f = c.to_arrow()
        if c.is_tag and pa.types.is_string(f.type):
            f = pa.field(f.name, pa.dictionary(pa.int32(), pa.utf8()), nullable=f.nullable)
        fields.append(f)
    fields.append(pa.field(TSID, pa.int64(), nullable=False))
    fields.append(pa.field(SEQ, pa.int64(), nullable=False))
    fields.append(pa.field(OP, pa.int8(), nullable=False))
    return pa.schema(fields)


def write_sst(
    store: ObjectStore,
    sst_dir: str,
    schema: Schema,
    columns: dict[str, np.ndarray],
    level: int = 0,
    row_group_size: int = 256 * 1024,
    tag_dicts: dict[str, list] | None = None,
) -> SstMeta:
    """Write one sorted SST; caller guarantees (tsid, ts, seq) order.

    ``tag_dicts`` + ``__tagcode_<name>__`` companion columns build the
    Parquet dictionary pages directly from region codes — no per-row
    string hashing.  Both flush and compaction supply codes (compaction
    reads its inputs on the code path); the hash-encode fallback only
    covers callers with raw values and no companions."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from greptimedb_tpu_torch.storage.memtable import tagcode_col

    ts_col = schema.time_index.name
    n = len(columns[SEQ])
    file_id = uuid.uuid4().hex
    path = f"{sst_dir}/{file_id}.parquet"

    target = _arrow_schema(schema)
    arrays = []
    for f in target:
        if pa.types.is_dictionary(f.type):
            # codes-first: a code-path scan (compaction over coded parts)
            # may carry ONLY ``__tagcode_*__`` companions, no raw values
            codes = columns.get(tagcode_col(f.name))
            vocab = (tag_dicts or {}).get(f.name)
            if codes is not None and vocab is not None:
                # SST-local dictionary: remap region codes to this file's
                # distinct values — embedding the region-lifetime vocab
                # would bloat every SST of a long-lived churning region
                uniq_codes = np.unique(codes)
                local = np.searchsorted(uniq_codes, codes).astype(np.int32)
                arrays.append(pa.DictionaryArray.from_arrays(
                    pa.array(local, type=pa.int32()),
                    pa.array([vocab[int(c)] for c in uniq_codes],
                             type=pa.utf8()),
                ))
            else:
                arrays.append(
                    pa.array(columns[f.name].astype(object), type=pa.utf8())
                    .dictionary_encode()
                )
        else:
            arrays.append(pa.array(columns[f.name], type=f.type))
    table = pa.Table.from_arrays(arrays, schema=target)

    sink = io.BytesIO()
    pq.write_table(
        table,
        sink,
        row_group_size=row_group_size,
        compression="zstd",
        compression_level=1,
        use_dictionary=True,
        write_statistics=True,
        # page-level CRCs: every scan/compaction read verifies
        # them, so silent bit rot is detected instead of served
        write_page_checksum=True,
    )
    data = sink.getvalue()
    after = None
    if CHAOS.enabled:  # durability-boundary crash point + data faults
        data, after = CHAOS.filter_io("sst.write", data)
    store.write(path, data)
    if after is not None:
        raise after
    ts = columns[ts_col]
    seq = columns[SEQ]
    return SstMeta(
        file_id=file_id,
        path=path,
        num_rows=n,
        ts_min=int(ts.min()),
        ts_max=int(ts.max()),
        seq_min=int(seq.min()),
        seq_max=int(seq.max()),
        size_bytes=len(data),
        level=level,
        columns=tuple(f.name for f in target),
    )


def _dict_to_codes(arr, enc) -> np.ndarray:
    """Dictionary array → region tag codes: map the file's (small)
    dictionary through the region encoder ONCE, vectorized over the
    int32 indices — the per-row cost is a single numpy gather, never a
    python-object materialization.  A null dictionary entry maps like
    the write path's NULL convention (empty string)."""
    dict_vals = ["" if v is None else v for v in arr.dictionary.to_pylist()]
    mapping = np.fromiter(
        (enc.get(v) for v in dict_vals), dtype=np.int32,
        count=len(dict_vals),
    )
    if bool((mapping < 0).any()):
        # legacy file carrying a value the region dicts never saw (e.g.
        # pre-manifest data): register it, serialized against concurrent
        # decode threads — codes are append-only so readers stay valid
        with _ENCODER_FALLBACK_LOCK:
            mapping = np.fromiter(
                (enc.get_or_insert(v) for v in dict_vals), dtype=np.int32,
                count=len(dict_vals),
            )
    indices = arr.indices.to_numpy(zero_copy_only=False)
    return mapping[indices.astype(np.int64, copy=False)]


def read_sst(
    store: ObjectStore,
    meta: SstMeta,
    schema: Schema,
    ts_range: tuple[int | None, int | None] = (None, None),
    columns: list[str] | None = None,
    tag_filters: dict[str, set] | None = None,
    tag_encoders: dict | None = None,
    decode_tags: bool = True,
) -> dict[str, np.ndarray]:
    """Read an SST back into numpy columns, pruning row groups by time and
    (when ``tag_filters`` equality/IN sets are given) by tag values via
    Parquet dictionary/statistics filtering — the row-group-level
    counterpart of the file-level bloom skipping index.

    Tag transfer is two-mode.  Default (``tag_encoders=None``): dictionary
    columns come back as raw values (object arrays) and re-encoding
    happens downstream.  Code path (``tag_encoders`` = the region's
    DictionaryEncoders): each dictionary column additionally yields a
    ``__tagcode_<name>__`` int32 companion in REGION code space — the
    file's dictionary is mapped once, vectorized — and with
    ``decode_tags=False`` the per-row object array is never materialized
    at all, so the cache layer consumes codes directly without re-hashing
    a single string.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    ts_idx = schema.time_index
    ts_col = ts_idx.name
    ts_type = pa.timestamp(ts_idx.dtype.time_unit.value)
    conj = []
    lo, hi = ts_range
    if lo is not None:
        conj.append((ts_col, ">=", pa.scalar(int(lo), type=ts_type)))
    if hi is not None:
        conj.append((ts_col, "<", pa.scalar(int(hi), type=ts_type)))
    tag_names = {c.name for c in schema.tag_columns}
    for col, values in (tag_filters or {}).items():
        if col in tag_names and values:
            conj.append((col, "in", [str(v) for v in values]))
    filters = conj or None

    from greptimedb_tpu_torch.storage.scan import M_SCAN_BYTES, M_SCAN_FILES

    M_SCAN_FILES.labels("read").inc()
    # bytes DECODED, not file size: scale by the ts overlap fraction so
    # row-group-pruned reads (grid catch-up tails) don't overstate the
    # metric by the whole file
    span = max(1, meta.ts_max - meta.ts_min + 1)
    eff_lo = meta.ts_min if lo is None else max(meta.ts_min, int(lo))
    eff_hi = meta.ts_max + 1 if hi is None else min(meta.ts_max + 1, int(hi))
    M_SCAN_BYTES.inc(
        meta.size_bytes * min(1.0, max(0.0, (eff_hi - eff_lo) / span)))
    local = store.local_path(meta.path)
    if CHAOS.enabled and local is not None:
        # disk fault injection on the SST read path: route the mmap-able
        # local file through a byte read so bitflip faults apply
        data, _ = CHAOS.filter_io("sst.read", store.read(meta.path))
        local, src = None, io.BytesIO(data)
    else:
        src = local if local else io.BytesIO(store.read(meta.path))
    internal = (TSID, SEQ, OP)
    schema_cols = {c.name for c in schema}
    try:
        if meta.columns is not None:
            present = set(meta.columns)
        else:  # legacy meta: one footer read to learn the file's columns
            present = set(pq.read_schema(src).names)
            if isinstance(src, io.BytesIO):
                src.seek(0)
        want = (columns if columns is not None
                else (list(schema_cols) + list(internal)))
        want = list(dict.fromkeys(want))
        read_cols = [c for c in want if c in present]
        # page_checksum_verification: decode fails loudly on bit rot —
        # the scan layer quarantines the file and repairs/serves around
        # it instead of returning corrupt rows
        table = pq.read_table(src, columns=read_cols, filters=filters,
                              page_checksum_verification=True)
    except (OSError, ValueError, KeyError, pa.ArrowException) as e:
        M_CORRUPTION.labels("sst", "read").inc()
        raise SstCorruption(meta, e) from e

    out: dict[str, np.ndarray] = {}
    for name in table.column_names:
        if name not in schema_cols and name not in internal:
            continue  # dropped by ALTER; dead weight in old SSTs
        arr = table.column(name).combine_chunks()
        if pa.types.is_dictionary(arr.type):
            enc = (tag_encoders or {}).get(name)
            if enc is not None:
                if arr.null_count == 0:
                    out[tagcode_col(name)] = _dict_to_codes(arr, enc)
                    if not decode_tags:
                        continue  # codes ARE the column; no object array
                else:
                    # anomalous row-level nulls (never written by this
                    # engine): decode and re-encode so the code companion
                    # invariant still holds for every part of a scan
                    vals = np.asarray(arr.to_pylist(), dtype=object)
                    M_OBJECT_DECODE_ROWS.inc(len(vals))
                    with _ENCODER_FALLBACK_LOCK:
                        out[tagcode_col(name)] = np.fromiter(
                            (enc.get_or_insert("" if v is None else v)
                             for v in vals),
                            dtype=np.int32, count=len(vals),
                        )
                    if decode_tags:
                        out[name] = vals
                    continue
            # decode via the (small) dictionary, not per-row to_pylist —
            # still a per-row object-pointer array, which the hot scan
            # path avoids entirely (tier-1 pins the counter at 0 there)
            dict_vals = np.asarray(arr.dictionary.to_pylist(), dtype=object)
            indices = arr.indices.to_numpy(zero_copy_only=False)
            M_OBJECT_DECODE_ROWS.inc(len(indices))
            out[name] = dict_vals[indices]
        elif pa.types.is_string(arr.type) or pa.types.is_binary(arr.type):
            out[name] = np.asarray(arr.to_pylist(), dtype=object)
        elif pa.types.is_timestamp(arr.type):
            out[name] = arr.to_numpy(zero_copy_only=False).astype("int64")
        else:
            out[name] = arr.to_numpy(zero_copy_only=False)
    # schema evolution: backfill columns added after this SST was written
    n = len(out[SEQ]) if SEQ in out else table.num_rows
    for c in schema:
        if c.name in want and c.name not in out:
            enc = ((tag_encoders or {}).get(c.name)
                   if c.is_tag and c.dtype.is_string_like else None)
            if enc is not None:
                if tagcode_col(c.name) not in out:
                    fill = default_fill_array(c, 1)[0]
                    code = enc.get(fill)
                    if code < 0:
                        with _ENCODER_FALLBACK_LOCK:
                            code = enc.get_or_insert(fill)
                    out[tagcode_col(c.name)] = np.full(n, code,
                                                       dtype=np.int32)
                if not decode_tags:
                    continue  # the code companion IS the column
            out[c.name] = default_fill_array(c, n)
    return out


def iter_verify_sst_bytes(data: bytes):
    """Row-group-granular checksummed verify: yields one bool per row
    group (True = the group decoded clean with page checksums, False =
    corrupt — iteration stops at the first False).  An unreadable
    footer/metadata yields a single False.  The background scrubber
    drains this generator between idle-preemption checks, so verifying
    a multi-group SST never pins an idle worker for the whole decode;
    ``verify_sst_bytes`` drains it in one go."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    try:
        pf = pq.ParquetFile(io.BytesIO(data),
                            page_checksum_verification=True)
        n = pf.metadata.num_row_groups
    except (OSError, ValueError, KeyError, pa.ArrowException):
        yield False
        return
    for i in range(n):
        try:
            pf.read_row_group(i)
        except (OSError, ValueError, KeyError, pa.ArrowException):
            yield False
            return
        yield True


def verify_sst_bytes(data: bytes) -> bool:
    """Full checksummed decode of candidate SST bytes — repair validation:
    a replica's copy must prove readable (page checksums included) before
    it replaces a quarantined file."""
    return all(iter_verify_sst_bytes(data))
