"""Memtable: the mutable in-memory head of a region.

The reference offers per-series BTree memtables and an Arrow-native bulk
memtable (src/mito2/src/memtable/{time_series.rs,bulk.rs}). On the TPU path
all queries consume dense columnar tensors, so the bulk shape is the only
one that makes sense: appended row groups stay as numpy column chunks
(zero re-organization at ingest — that's what keeps ingest fast in Python),
and sorting/dedup happen once at freeze (flush) time.
"""

from __future__ import annotations

import numpy as np

from greptimedb_tpu_torch.datatypes.schema import Schema

TSID = "__tsid__"
SEQ = "__seq__"
OP = "__op__"  # 0 = put, 1 = delete tombstone

OP_PUT = 0
OP_DELETE = 1

# per-tag dictionary-code companion columns carried through memtable
# chunks so flush/index/cache paths never re-hash raw tag strings
TAGCODE_PREFIX = "__tagcode_"


def tagcode_col(tag_name: str) -> str:
    return f"{TAGCODE_PREFIX}{tag_name}__"


class Memtable:
    def __init__(self, schema: Schema):
        self.schema = schema
        self._chunks: list[dict[str, np.ndarray]] = []
        self.num_rows = 0
        self.bytes = 0
        self.ts_min: int | None = None
        self.ts_max: int | None = None
        self.min_seq: int | None = None
        self.max_seq: int | None = None

    def append(self, chunk: dict[str, np.ndarray],
               ts_bounds: tuple[int, int] | None = None,
               seq: int | None = None) -> None:
        """Append a pre-encoded columnar slab: schema columns (tags
        already as raw values, ts as int64, fields numeric) +
        __tsid__/__seq__/__op__.  The slab is stored as-is — zero
        reorganization at ingest; sorting/dedup happen once at freeze.

        ``ts_bounds`` and ``seq``, when the caller already knows them
        (Region.write computes the ts extremes for its append
        classification and stamps one sequence per batch), skip the
        per-column min/max reductions on the hot path."""
        n = len(chunk[SEQ])
        if n == 0:
            return
        self._chunks.append(chunk)
        self.num_rows += n
        self.bytes += sum(
            a.nbytes if isinstance(a, np.ndarray) else 64 * n for a in chunk.values()
        )
        if ts_bounds is not None:
            lo, hi = int(ts_bounds[0]), int(ts_bounds[1])
        else:
            ts = chunk[self.schema.time_index.name]
            lo, hi = int(ts.min()), int(ts.max())
        self.ts_min = lo if self.ts_min is None else min(self.ts_min, lo)
        self.ts_max = hi if self.ts_max is None else max(self.ts_max, hi)
        if seq is not None:
            slo = shi = int(seq)
        else:
            sc = chunk[SEQ]
            slo, shi = int(sc.min()), int(sc.max())
        self.min_seq = slo if self.min_seq is None else min(self.min_seq, slo)
        self.max_seq = shi if self.max_seq is None else max(self.max_seq, shi)

    @property
    def is_empty(self) -> bool:
        return self.num_rows == 0

    def freeze(self, dedup: bool = True) -> dict[str, np.ndarray]:
        """Concatenate, sort by (tsid, ts, seq)[, dedup keep-last].

        Matches mito2 flush semantics (handle_write + flush.rs): the SST is
        sorted on the primary key and contains one row per (series, ts) with
        the highest sequence; delete tombstones survive dedup so they can
        shadow older SSTs until compaction drops them.  ``dedup=False`` is
        append mode: every row survives (the log/trace data model).
        """
        if not self._chunks:
            return {}
        names = list(self._chunks[0].keys())
        merged = {
            k: np.concatenate([c[k] for c in self._chunks]) for k in names
        }
        ts_col = self.schema.time_index.name
        order = np.lexsort((merged[SEQ], merged[ts_col], merged[TSID]))
        merged = {k: v[order] for k, v in merged.items()}
        if not dedup:
            return merged
        # keep-last within (tsid, ts): last in sorted order has max seq
        tsid, ts = merged[TSID], merged[ts_col]
        is_last = np.ones(len(tsid), dtype=bool)
        if len(tsid) > 1:
            same = (tsid[1:] == tsid[:-1]) & (ts[1:] == ts[:-1])
            is_last[:-1] = ~same
        return {k: v[is_last] for k, v in merged.items()}

    def snapshot_chunks(self) -> list[dict[str, np.ndarray]]:
        """Raw (unsorted, possibly duplicated) chunks for scan-time merge."""
        return list(self._chunks)
