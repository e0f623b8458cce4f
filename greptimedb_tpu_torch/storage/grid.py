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

Incremental protocol, as the DeviceTable's (storage/cache.py): pure
time-forward appends scatter into the resident tensors on the device
(``extend_grid_table``; the time axis grows when they pass it), a flush
catches the grid up from the new SSTs (``catch_up_grid_table``), and other
structure changes rebuild; both scatters run on ``grid_scatter`` (K24).
Snapshots (``save_grid_snapshot`` / ``load_grid_snapshot``) keep the
reference's on-disk format, so either package loads the other's.  The
reference's mesh shardings of the grid are not ported (the port's mesh
serves the row path).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from greptimedb_tpu_torch.storage.durability import SstCorruption
from greptimedb_tpu_torch.storage.memtable import OP, OP_DELETE, SEQ, TSID
from greptimedb_tpu_torch.storage.object_store import _fsync_dir

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


def _region_fingerprint(region) -> dict:
    """Cheap identity of a region's resident data: SST set + memtable
    volume.  A snapshot taken at the same fingerprint maps to identical
    grid tensors, so a reopened process can load the host tensors instead
    of scanning every SST again."""
    return {
        "ssts": sorted(
            (m.file_id, int(m.seq_max), int(m.num_rows))
            for m in region.sst_files
        ),
        "memtable_rows": int(region.memtable.num_rows),
        "num_series": int(region.num_series),
        "fields": grid_float_fields(region.schema),
    }


def save_grid_snapshot(table: GridTable, region, path: str) -> None:
    """Persist the dense tensors next to the region data (mito2's
    write-through file cache idea, src/mito2/src/cache/write_cache.rs,
    applied to the resident layout) in the reference's format:
    ``values.npy``, ``valid.npy``, ``tags.npz`` and ``meta.json``, the
    manifest renamed into place last and its directory fsynced."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "values.npy"), table.values.cpu().numpy())
    np.save(os.path.join(path, "valid.npy"), table.valid.cpu().numpy())
    np.savez(os.path.join(path, "tags.npz"),
             **{k: v.cpu().numpy() for k, v in table.tag_codes.items()})
    meta = {
        "ts0": table.ts0, "step": table.step, "nt": table.nt,
        "num_series": table.num_series,
        "field_names": list(table.field_names),
        "dicts": {k: list(v) for k, v in table.dicts.items()},
        "no_nan": list(table.no_nan),
        "fingerprint": _region_fingerprint(region),
    }
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "meta.json"))
    # rename durability: the directory entry must reach the disk too, or a
    # power loss can resurrect the old meta.json beside new tensors
    _fsync_dir(path)


def load_grid_snapshot(path: str, region, *, device):
    """A resident GridTable on ``device`` from a snapshot, or None when the
    region's fingerprint or tag dictionaries no longer match it, or on any
    corruption (the caller builds from the SSTs instead)."""
    from greptimedb_tpu_torch.storage.cache import next_dicts_version

    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        fp = _region_fingerprint(region)
        saved = meta["fingerprint"]
        saved["ssts"] = [tuple(s) for s in saved["ssts"]]
        if saved != {**fp, "ssts": list(fp["ssts"])}:
            return None
        # the restored tag codes decode against the region's CURRENT
        # encoders at query time: another code assignment (WAL replay
        # order, rebuilt dictionaries) must refuse the snapshot
        if {k: list(v) for k, v in meta["dicts"].items()} != {
            name: list(region.encoders[name].values())
            for name in region.tag_names
        }:
            return None
        values = np.load(os.path.join(path, "values.npy"), mmap_mode="r")
        valid = np.load(os.path.join(path, "valid.npy"), mmap_mode="r")
        with np.load(os.path.join(path, "tags.npz")) as tags:
            tag_codes = {k: np.asarray(tags[k]) for k in tags.files}
    except Exception:  # noqa: BLE001 — any corruption (a truncated .npz
        # included) means "no snapshot", never a crash
        return None
    return GridTable(
        values=_to_device_rows(values, device),
        valid=_to_device_rows(valid, device),
        tag_codes={k: _to_device_rows(v, device)
                   for k, v in tag_codes.items()},
        ts0=int(meta["ts0"]),
        step=int(meta["step"]),
        nt=int(meta["nt"]),
        num_series=int(meta["num_series"]),
        field_names=tuple(meta["field_names"]),
        dicts={k: list(v) for k, v in meta["dicts"].items()},
        no_nan=tuple(meta["no_nan"]),
        dicts_version=next_dicts_version(),
        region_id=int(getattr(region, "region_id", -1)),
    )


def _grow_time_axis(values, valid, tpad: int, new_nt: int, spad: int,
                    c: int):
    """The resident tensors with a longer padded time axis (new cells zero
    and invalid), so sustained time-forward ingest extends the grid in
    amortized O(1) a step instead of falling off a fixed ``tpad`` into a
    rebuild.  Doubles by default; an exact fit near the budget.  Returns
    ``(values, valid)``, or None when even the exact fit exceeds the grid
    budget."""
    tpad2 = _pad_to(max(new_nt, 2 * tpad), _T_ALIGN)
    if spad * tpad2 * (4 * c + 1) > _BUDGET:
        tpad2 = _pad_to(new_nt, _T_ALIGN)
        if spad * tpad2 * (4 * c + 1) > _BUDGET:
            return None
    values2 = torch.zeros((c, spad, tpad2), dtype=values.dtype,
                          device=values.device)
    valid2 = torch.zeros((spad, tpad2), dtype=valid.dtype,
                         device=valid.device)
    values2[:, :, :tpad].copy_(values)
    valid2[:, :tpad].copy_(valid)
    return values2, valid2


def _writable(table: GridTable, new_nt: int):
    """Fresh (values, valid) for a scatter: the grown tensors when
    ``new_nt`` passes the padded time axis, else copies — the resident
    table stays as it is for readers holding it.  None when growth would
    exceed the budget."""
    if new_nt > table.tpad:
        return _grow_time_axis(table.values, table.valid, table.tpad,
                               new_nt, table.spad, len(table.field_names))
    return table.values.clone(), table.valid.clone()


def _scatter_part(values, valid, tsid, tidx, cols, flags) -> None:
    """One part's cells into the grid (K24): ``grid_scatter_steps`` when
    the cells are whole steps of one series sequence (``step_cells``: an
    append, time-major), which uploads that sequence and the steps
    instead of a tsid and a tidx a cell; else ``grid_scatter``.  Spans
    (host time): ``grid_scatter.detect``, ``.upload`` and ``.launch``."""
    from greptimedb_tpu_torch.ops import storage_kernels as stk
    from greptimedb_tpu_torch.utils.tracing import TRACER

    dev = values.device
    with TRACER.stage("grid_scatter.detect", cells=len(tsid)):
        steps = stk.step_cells(tsid, tidx)
    with TRACER.stage("grid_scatter.upload"):
        if steps is not None:
            tsid, tidx = steps
        args = (_to_device_rows(np.ascontiguousarray(tsid), dev),
                _to_device_rows(np.ascontiguousarray(tidx), dev),
                _to_device_rows(np.stack(cols, axis=0), dev),
                _to_device_rows(np.ascontiguousarray(flags), dev))
    with TRACER.stage("grid_scatter.launch", steps=steps is not None):
        if steps is not None:
            stk.grid_scatter_steps(values, valid, *args)
        else:
            stk.grid_scatter(values, valid, *args)


def _extended(table: GridTable, region, values, valid, new_nt: int,
              no_nan) -> GridTable:
    """The GridTable after a scatter: the region's series and
    dictionaries now, a new dicts_version."""
    from greptimedb_tpu_torch.storage.cache import next_dicts_version

    tag_codes = table.tag_codes
    if region.num_series > table.num_series:
        tag_codes = {
            k: _to_device_rows(v, table.device)
            for k, v in _series_tag_matrix(region, table.spad).items()
        }
    return GridTable(
        values=values,
        valid=valid,
        tag_codes=tag_codes,
        ts0=table.ts0,
        step=table.step,
        nt=max(table.nt, new_nt),
        num_series=region.num_series,
        field_names=table.field_names,
        dicts={name: region.encoders[name].values()
               for name in region.tag_names},
        no_nan=tuple(no_nan),
        dicts_version=next_dicts_version(),
        region_id=table.region_id,
    )


def append_cells(table: GridTable, region, chunks):
    """The grid cells of pure-append chunks: ``(tsid, tidx, [C] f32
    columns, new_nt)`` in the chunks' row order, or None when a timestamp
    is off the grid's step (the sampling changed)."""
    ts_name = region.ts_name
    tsid = np.concatenate([c[TSID] for c in chunks]).astype(np.int64)
    ts = np.concatenate(
        [np.asarray(c[ts_name], dtype=np.int64) for c in chunks]
    )
    rel = ts - table.ts0
    step = table.step
    if step <= 0 or bool((rel % step != 0).any()):
        return None
    tidx = rel // step
    cols = [np.concatenate([np.asarray(c[name], dtype=np.float32)
                            for c in chunks])
            for name in table.field_names]
    return tsid, tidx, cols, int(tidx.max()) + 1 if len(tidx) else 0


def extend_grid_table(table: GridTable, region, chunks):
    """Scatter pure-append chunks into the resident grid on the device.

    Returns the extended GridTable (the resident one is left as it was),
    or None when the delta does not fit the resident shape or step (the
    caller rebuilds).  Precondition (the region's append log): chunks are
    PUT-only with strictly newer timestamps, so only new cells are set.
    Spans (host time): ``grid_extend.cells``, ``.copy``, ``.no_nan`` and
    ``.table``, and ``_scatter_part``'s."""
    from greptimedb_tpu_torch.utils.tracing import TRACER

    if region.num_series > table.spad:
        return None
    if not sum(len(c[TSID]) for c in chunks):
        return table
    with TRACER.stage("grid_extend.cells"):
        cells = append_cells(table, region, chunks)
    if cells is None:
        return None
    tsid, tidx, cols, new_nt = cells
    with TRACER.stage("grid_extend.copy"):
        grown = _writable(table, new_nt)
    if grown is None:
        return None
    values, valid = grown
    with TRACER.stage("grid_extend.no_nan"):
        no_nan = [ok and bool(np.isfinite(col).all())
                  for ok, col in zip(table.no_nan, cols)]
    _scatter_part(values, valid, tsid, tidx, cols,
                  np.ones(len(tsid), dtype=bool))
    with TRACER.stage("grid_extend.table"):
        return _extended(table, region, values, valid, new_nt, no_nan)


def catch_up_grid_table(table: GridTable, region, new_metas):
    """Extend a resident grid with freshly FLUSHED SSTs instead of reading
    the whole region again.

    Only rows strictly after the resident coverage are read: the resident
    end bounds a ``ts_range`` that read_sst turns into Parquet row-group
    pruning, so a flushed file whose rows are already resident (they came
    through the append log) costs a footer read.  The new cells scatter
    part by part in sequence order (keep-max-seq), tombstones as zero
    values and invalid cells.

    Returns the extended GridTable, the SAME table when the new files hold
    nothing past the resident coverage, or None when the delta does not
    fit the resident shape or step, or a file is corrupt (the caller
    rebuilds).  The preconditions — the same ``Region.mutation_epoch``,
    the old SSTs intact, memtable and append log empty — are the cache's
    (storage/cache.py get_grid)."""
    from greptimedb_tpu_torch.storage.scan import (
        estimate_staging_bytes, prefetch_store, read_parts,
    )
    from greptimedb_tpu_torch.storage.sst import read_sst

    fields = table.field_names
    if tuple(grid_float_fields(region.schema)) != tuple(fields):
        return None
    if region.num_series > table.spad:
        return None
    step = table.step
    if step <= 0:
        return None
    ts_name = region.ts_name
    lo = table.ts0 + (table.nt - 1) * step + 1  # strictly after resident
    want = [ts_name, TSID, SEQ, OP] + list(fields)
    metas = [
        m for m in sorted(new_metas, key=lambda m: m.seq_max)
        if m.ts_max >= lo
    ]
    prefetch_store(region.store, metas)
    est = estimate_staging_bytes(metas, len(want), (lo, None))
    try:
        parts = read_parts(
            [
                (lambda m=m: read_sst(region.store, m, region.schema,
                                      (lo, None), columns=want))
                for m in metas
            ],
            memory=getattr(region, "memory", None), est_bytes=est,
        )
    except SstCorruption as e:
        # quarantine/repair changes the SST set under this incremental
        # pass: None hands over to a full (verified, retrying) rebuild
        region._handle_sst_corruption(e)
        return None
    parts = [p for p in parts if len(p[TSID])]
    if not parts:
        return table  # fully resident already (a flush of consumed appends)
    all_ts = np.concatenate([p[ts_name].astype(np.int64) for p in parts])
    rel = all_ts - table.ts0
    if bool((rel % step != 0).any()):
        return None  # off-grid timestamps: the sampling changed
    new_nt = int(rel.max()) // step + 1
    grown = _writable(table, new_nt)
    if grown is None:
        return None
    values, valid = grown
    no_nan = list(table.no_nan)
    for p in parts:
        tsid = p[TSID].astype(np.int64)
        tidx = (p[ts_name].astype(np.int64) - table.ts0) // step
        dels = p[OP] == OP_DELETE
        any_dels = bool(dels.any())
        cols = []
        for ci, name in enumerate(fields):
            col = p[name]
            if col.dtype != np.float32:
                col = col.astype(np.float32)
            if any_dels:
                col = np.where(dels, np.float32(0.0), col)
            if no_nan[ci] and not bool(np.isfinite(col).all()):
                no_nan[ci] = False
            cols.append(col)
        _scatter_part(values, valid, tsid, tidx, cols, ~dels)
    return _extended(table, region, values, valid, new_nt, no_nan)
