"""Dense time-grid resident layout: [field, series, time] tensors.

Torch counterpart of the reference's ``storage/grid.py``.  Metric data is
(near-)regularly sampled, so the region materializes a dense
``values[field, series, timestep]`` tensor plus a ``valid[series,
timestep]`` mask; aggregation by (tags × time bucket) then lowers to the
bucket reduce and the series→group merge (``ops/grid_kernels.py``) — no
scatter over rows, no sort.

Eligibility is decided per region build: timestamps must share a coarse
enough GCD step (regular sampling), the dense grid must fit the byte
budget, and occupancy must clear a floor.

Not ported yet: the incremental protocol (``extend_grid_table``,
``catch_up_grid_table``), snapshots and mesh shardings.  The port's cache
(``storage/cache.py``) rebuilds the grid when the region moved instead —
same results, higher cost.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from greptimedb_tpu_torch.storage.durability import SstCorruption
from greptimedb_tpu_torch.storage.memtable import OP, OP_DELETE, SEQ, TSID

# padding granularity: each distinct (Spad, Tpad) is a shape class.
# T gets coarse alignment (appends grow it constantly); S changes rarely.
_T_ALIGN = 2048
_S_ALIGN = 256
_MIN_DENSITY = float(os.environ.get("GREPTIME_GRID_MIN_DENSITY", "0.1"))
_BUDGET = int(os.environ.get("GREPTIME_GRID_BUDGET_BYTES", str(6 << 30)))


def _pad_to(n: int, align: int) -> int:
    """Small sizes get pow2 buckets, larger ones align to ``align``."""
    if n <= 0:
        return align if align < 64 else 64
    if n < align:
        return 1 << max(6, (n - 1).bit_length())
    return -(-n // align) * align


def _to_device_rows(arr: np.ndarray, device) -> torch.Tensor:
    """Chunked, double-buffered host→device upload (storage/scan.py)."""
    from greptimedb_tpu_torch.storage.scan import stream_to_device

    return stream_to_device(arr, device)


@dataclass
class GridTable:
    """One region's dense-grid resident tensors.

    ts of grid point t = ``ts0 + t * step`` for t < ``nt``; padding points
    (t >= nt) and padding series (s >= num_series) have valid=False and
    zero values.
    """

    values: torch.Tensor             # [C, Spad, Tpad] float32 — field-major
    # planes keep the time axis contiguous, so per-bucket reductions walk
    # memory order
    valid: torch.Tensor              # [Spad, Tpad] bool
    tag_codes: dict[str, torch.Tensor]  # per-tag [Spad] int32 (pad = -1)
    ts0: int
    step: int
    nt: int                          # live timesteps
    num_series: int                  # live series
    field_names: tuple               # C order (float FIELD columns)
    dicts: dict[str, list] = field(default_factory=dict)
    # per-field "finite everywhere written" (no NaN *or* ±inf): count()
    # reuses the shared validity reduction, and sums may ride the
    # mask-free weighted reduce (inf would break its 0-weight products)
    no_nan: tuple = ()
    dicts_version: int = 0
    # owning region: derived-layout cache entries key on it so a rebuilt
    # grid (new dicts_version) REPLACES the region's stale layouts
    region_id: int = -1

    @property
    def spad(self) -> int:
        return int(self.valid.shape[0])

    @property
    def tpad(self) -> int:
        return int(self.valid.shape[1])

    @property
    def device(self) -> torch.device:
        return self.values.device

    def nbytes(self) -> int:
        total = (self.values.numel() * self.values.element_size()
                 + self.valid.numel() * self.valid.element_size())
        for v in self.tag_codes.values():
            total += v.numel() * v.element_size()
        return total


def grid_float_fields(schema) -> list[str]:
    return [c.name for c in schema.field_columns if c.dtype.is_float]


def _series_tag_matrix(region, spad: int) -> dict[str, np.ndarray]:
    """Per-tag code arrays indexed by tsid, padded with the poison code -1."""
    tags = region.tag_names
    s = region.num_series
    out = {name: np.full(spad, -1, dtype=np.int32) for name in tags}
    for key, tsid in region._series.items():
        for j, name in enumerate(tags):
            out[name][tsid] = key[j]
    return out


def _gather_parts(region, fields: list[str]):
    """Region parts (SSTs then memtable chunks) in last-write-wins order.

    SSTs sort by seq_max: flush emits monotonically increasing sequence
    ranges, and TWCS-compacted files never share (series, ts) keys with
    files of other time windows, so per-key ordering reduces to per-file
    ordering.  Memtable chunks follow in append order.

    Decodes run concurrently on the scan pipeline's bounded pool with
    scan-driven readahead.  (Catch-up builds read their own ts-restricted
    slice in catch_up_grid_table — this is the full-region gather.)
    """
    from greptimedb_tpu_torch.storage.scan import (
        estimate_staging_bytes, prefetch_store, read_parts,
    )
    from greptimedb_tpu_torch.storage.sst import read_sst

    ts_name = region.ts_name
    want = [ts_name, TSID, SEQ, OP] + fields
    attempts = 0
    while True:
        metas = sorted(region.sst_files, key=lambda m: m.seq_max)
        prefetch_store(region.store, metas)
        est = estimate_staging_bytes(metas, len(want))
        try:
            parts = read_parts(
                [
                    (lambda m=m: read_sst(region.store, m, region.schema,
                                          columns=want))
                    for m in metas
                ],
                memory=getattr(region, "memory", None), est_bytes=est,
            )
            break
        except SstCorruption as e:
            # verified read failed: quarantine/repair, retry over the
            # refreshed live set (the grid build must never ingest
            # corrupt pages, and must keep building around a lost file)
            attempts += 1
            if attempts > 16:
                raise
            region._handle_sst_corruption(e)
    for chunk in region.memtable.snapshot_chunks():
        # within-chunk duplicates resolve by scatter order (later row wins),
        # matching keep-max-seq: rows in a chunk share one sequence and
        # arrive in insert order
        parts.append(chunk)
    return parts


def infer_grid_step(parts, ts_name: str, ts0: int) -> int:
    """GCD of (ts - ts0) across all rows — one vectorized pass, no sort."""
    g = np.int64(0)
    for p in parts:
        ts = p[ts_name]
        if len(ts):
            g = np.gcd(g, np.gcd.reduce(ts.astype(np.int64) - ts0))
    return int(g)


def build_grid_table(region, budget_bytes: int | None = None, *, device):
    """Attempt the dense-grid build; returns None when ineligible
    (irregular sampling, too sparse, over budget, stringly fields only).
    The resident tensors land on ``device``."""
    fields = grid_float_fields(region.schema)
    if not fields or region.schema.time_index is None:
        return None
    if region.options.append_mode:
        # append mode preserves duplicate (series, ts) rows; the grid is
        # keyed by (series, timestep) and would silently dedup them
        return None
    bounds = region.ts_bounds()
    if bounds is None:
        return None  # empty region: nothing to accelerate
    ts0, ts_max = bounds
    s = region.num_series
    if s == 0:
        return None
    budget = budget_bytes if budget_bytes is not None else _BUDGET
    c = len(fields)
    ts_name = region.ts_name

    parts = _gather_parts(region, fields)
    total_rows = sum(len(p[TSID]) for p in parts)
    if total_rows == 0:
        return None
    step = infer_grid_step(parts, ts_name, ts0)
    if step <= 0:
        step = 1  # single distinct timestamp
    nt = (ts_max - ts0) // step + 1
    spad = _pad_to(s, _S_ALIGN)
    tpad = _pad_to(nt, _T_ALIGN)
    grid_bytes = spad * tpad * (4 * c + 1)
    if grid_bytes > budget:
        return None
    if total_rows / max(s * nt, 1) < _MIN_DENSITY:
        return None

    # zero-fill, not NaN: ``valid`` is the sole source of truth for cell
    # liveness, so never-written cells contribute +0 to sums and the hot
    # bucket reduce reads the values plane without a mask.  Cells
    # holding a *written* NaN (tombstone fields, real NaN data) keep the
    # NaN and clear ``no_nan``, which routes queries to the masked path.
    values = np.zeros((c, spad, tpad), dtype=np.float32)
    valid = np.zeros((spad, tpad), dtype=bool)
    no_nan = [True] * c
    for p in parts:
        tsid = p[TSID].astype(np.int64)
        if not len(tsid):
            continue
        tidx = (p[ts_name].astype(np.int64) - ts0) // step
        op = p[OP]
        dels = op == OP_DELETE
        any_dels = bool(dels.any())
        for ci, name in enumerate(fields):
            col = p[name]
            if col.dtype != np.float32:
                col = col.astype(np.float32)
            if any_dels:
                # tombstones must land as 0.0 whatever their field payload
                # (schema DEFAULTs fill deleted rows with non-zero values):
                # the mask-free sum fast path relies on invalid cells
                # contributing exactly +0
                col = np.where(dels, np.float32(0.0), col)
            # no_nan really means "finite everywhere written": written NaN
            # breaks count-by-validity, and written ±inf would turn the
            # fast path's inf*0 weight products into NaN — either routes
            # the column to the masked kernel path
            if no_nan[ci] and not bool(np.isfinite(col).all()):
                no_nan[ci] = False
            values[ci][tsid, tidx] = col
        valid[tsid, tidx] = ~dels
    tag_codes = _series_tag_matrix(region, spad)
    dicts = {name: region.encoders[name].values() for name in region.tag_names}
    from greptimedb_tpu_torch.storage.cache import next_dicts_version

    return GridTable(
        values=_to_device_rows(values, device),
        valid=_to_device_rows(valid, device),
        tag_codes={
            k: _to_device_rows(np.asarray(v), device)
            for k, v in tag_codes.items()
        },
        ts0=int(ts0),
        step=int(step),
        nt=int(nt),
        num_series=s,
        field_names=tuple(fields),
        dicts=dicts,
        no_nan=tuple(no_nan),
        dicts_version=next_dicts_version(),
        region_id=int(getattr(region, "region_id", -1)),
    )


def grid_from_numpy(values, valid, tag_codes, *, ts0, step, nt, num_series,
                    field_names, dicts, no_nan, device, region_id=-1
                    ) -> GridTable:
    """A GridTable from host arrays — e.g. the reference's resident grid
    taken with ``np.asarray`` — so both executors run on one resident
    state.  Dtypes are the grid's own: values float32, valid bool, tag
    codes int32."""
    from greptimedb_tpu_torch.storage.cache import next_dicts_version

    values = np.ascontiguousarray(np.asarray(values, dtype=np.float32))
    valid = np.ascontiguousarray(np.asarray(valid, dtype=bool))
    if values.ndim != 3 or valid.shape != values.shape[1:]:
        raise ValueError(f"grid_from_numpy: values {values.shape} and valid "
                         f"{valid.shape} do not form [C, S, T] / [S, T]")
    if len(field_names) != values.shape[0]:
        raise ValueError("grid_from_numpy: one field name per values plane")
    return GridTable(
        values=_to_device_rows(values, device),
        valid=_to_device_rows(valid, device),
        tag_codes={
            k: _to_device_rows(np.asarray(v, dtype=np.int32), device)
            for k, v in tag_codes.items()
        },
        ts0=int(ts0),
        step=int(step),
        nt=int(nt),
        num_series=int(num_series),
        field_names=tuple(field_names),
        dicts={k: list(v) for k, v in dicts.items()},
        no_nan=tuple(bool(x) for x in no_nan),
        dicts_version=next_dicts_version(),
        region_id=int(region_id),
    )
