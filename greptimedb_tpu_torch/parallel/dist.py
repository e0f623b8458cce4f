"""Mesh sharding and the collective aggregation: the mesh row path.

Torch counterpart of the reference's ``parallel/dist.py``: the series axis
of a table is split across the shards of a mesh, each shard computes the
pushed-down partial aggregate of its rows, and the partials merge (the
commutativity split, reference dist_plan/commutativity.rs: sum/count/
min/max commute, avg decomposes into sum + count).

The reference runs one process with ``shard_map`` over ``jax.devices()``;
so does the port.  A mesh is an ordered tuple of ``torch.device``s, one
per shard, and a device may repeat: D shards on one card, or on the CPU,
as the reference's tests run 8 virtual CPU devices.  Each shard's columns
live on its device, the shards one device holds back to back in one
tensor, so every local step is ONE launch over all of them, segment ids
offset by ``shard * (grid + 1)``.

- Local phase (the reference's ``local``, ``:297-459``): the pushed-down
  WHERE and time range and the group keys (``combine_keys``,
  ``bucket_index``: torch elementwise, as K7), then the row path's
  kernels: ``segment_reduce`` (its wide pass: the float columns of one op
  in one launch), ``segment_first_last``, ``hll_fold`` and ``udd_fold``.
- Exchange (its psum / pmin / pmax): each device's ``[Dk, grid(, M)]``
  partials are copied to the mesh's first device, stacked ``[D, grid(,
  M)]`` in mesh order and folded by ``ops/mesh_kernels.mesh_merge``.
  UDDSketch buckets against the GLOBAL key extremes, so its extremes are
  exchanged between ``udd_fold``'s two passes.
- The epilogues (NULL rules, the mean, ``__count__``) and the host fold
  through ``rpc/partial.py``'s ``merge_partials`` are the reference's.

The three GSPMD placements of the reference's module
(``bucket_major_shardings``, ``flow_state_shardings``,
``promql_row_shardings``) have no kernel of their own and are not ported.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from greptimedb_tpu_torch.errors import InvalidArguments, Unsupported
from greptimedb_tpu_torch.ops import mesh_kernels as mk
from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.ops import sketch_kernels as shk
from greptimedb_tpu_torch.ops.segment import combine_keys, segment_first_last
from greptimedb_tpu_torch.ops.time import bucket_index
from greptimedb_tpu_torch.storage.memtable import TAGCODE_PREFIX, TSID
from greptimedb_tpu_torch.utils.telemetry import REGISTRY
from greptimedb_tpu_torch.utils.tracing import TRACER

# Wall time of the collective phase (the local partials, the copies to the
# mesh's first device and the merge), labelled by mesh width and first-run
# vs steady state: the mesh twin of greptime_device_phase_seconds.
M_MESH_COLLECTIVE = REGISTRY.histogram(
    "greptime_mesh_collective_seconds",
    "Mesh collective-exchange wall time (local partials + merge)",
    labels=("devices", "phase"),
)


def _norm(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def create_mesh(num_devices: int | None = None, device=None) -> tuple:
    """A mesh: ``num_devices`` shards on ``device`` (one device may hold
    several shards), or without ``device`` one shard on each CUDA card
    (the first ``num_devices``)."""
    if device is not None:
        return (_norm(device),) * int(num_devices or 1)
    have = torch.cuda.device_count()
    if num_devices is not None:
        if num_devices > have:
            raise InvalidArguments(
                f"requested {num_devices} devices, have {have}")
        have = num_devices
    if have < 1:
        raise InvalidArguments("no CUDA device to form a mesh on")
    return tuple(torch.device("cuda", i) for i in range(have))


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for the ops wrappers' raw
    launches, which go to the current device's context on the tensor's
    stream: each shard group's kernels run with its own card current, the
    merge with the mesh's first.  Nothing to do on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def device_groups(mesh) -> list[tuple[torch.device, tuple[int, ...]]]:
    """``(device, shard indices)`` per distinct device of ``mesh``, in
    order of first appearance."""
    groups: dict = {}
    for s, dev in enumerate(mesh):
        groups.setdefault(_norm(dev), []).append(s)
    return [(d, tuple(s)) for d, s in groups.items()]


@dataclass
class ShardedTable:
    """Row-sharded columnar table: shard d owns rows [d*R, (d+1)*R) of a
    global [D * R] layout (R = ``rows_per_shard``).  ``columns[name]`` and
    ``row_mask`` hold one tensor per device group (``groups``): that
    device's shards back to back, in mesh order."""

    columns: dict[str, list[torch.Tensor]]
    row_mask: list[torch.Tensor]
    mesh: tuple
    rows_per_shard: int
    num_series: int
    groups: list

    @property
    def num_shards(self) -> int:
        return len(self.mesh)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for ts in [self.row_mask, *self.columns.values()]
                   for t in ts)


def shard_table(
    host_columns: dict[str, np.ndarray],
    mesh,
    *,
    shard_of_series: np.ndarray | None = None,
) -> ShardedTable:
    """Split rows across mesh shards by series (tsid % D by default, or an
    explicit series→shard map), rows of a shard ordered by (shard, tsid)
    and then as given, each shard padded to one power-of-two row count
    (floats NaN, the rest 0, ``row_mask`` False), and place each shard on
    its device."""
    mesh = tuple(_norm(d) for d in mesh)
    d = len(mesh)
    tsid = np.asarray(host_columns[TSID], dtype=np.int64)
    n = len(tsid)
    shard = (np.asarray(shard_of_series)[tsid] if shard_of_series is not None
             else tsid % d)
    order = np.lexsort((tsid, shard))
    counts = np.bincount(shard, minlength=d)
    per = int(counts.max()) if n else 1
    per = 1 << (per - 1).bit_length() if per > 1 else 1  # pow2 shape class
    offsets = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    groups = device_groups(mesh)

    def place(buf: np.ndarray) -> list[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(
            buf[list(shards)]).reshape(-1)).to(dev) for dev, shards in groups]

    cols_out: dict[str, list[torch.Tensor]] = {}
    for name, arr in host_columns.items():
        arr = np.asarray(arr)[order]
        if np.issubdtype(arr.dtype, np.floating):
            buf = np.full((d, per), np.nan, dtype=arr.dtype)
        else:
            buf = np.zeros((d, per), dtype=arr.dtype)
        for s in range(d):
            seg = arr[offsets[s]:offsets[s + 1]]
            buf[s, : len(seg)] = seg
        cols_out[name] = place(buf)
    mask = np.zeros((d, per), dtype=bool)
    for s in range(d):
        mask[s, : counts[s]] = True
    return ShardedTable(
        columns=cols_out,
        row_mask=place(mask),
        mesh=mesh,
        rows_per_shard=per,
        num_series=int(tsid.max()) + 1 if n else 0,
        groups=groups,
    )


def shard_region(region, mesh, ts_range: tuple = (None, None)
                 ) -> ShardedTable:
    """ShardedTable from a region's host scan: tags as their region
    dictionary codes (int32, the convention compile_device expects), string
    FIELD columns dropped (the mesh aggregates numerics; a query touching
    them is not mesh-decomposable), every other column in its HOST dtype
    (DOUBLE stays float64 here, unlike the DeviceTable's float32)."""
    codes = getattr(region, "scan_supports_codes", False)
    cols = region.scan_host(ts_range, with_tag_codes=True) if codes \
        else region.scan_host(ts_range)
    tagset = {c.name for c in region.schema.tag_columns}
    out: dict[str, np.ndarray] = {}
    for name, arr in cols.items():
        if name.startswith(TAGCODE_PREFIX):
            out[name[len(TAGCODE_PREFIX):-2]] = arr.astype(np.int32,
                                                           copy=False)
        elif name in tagset and arr.dtype.kind in ("O", "U", "S"):
            out[name] = region.encoders[name].encode(arr).astype(np.int32)
        elif arr.dtype.kind == "O":
            continue
        else:
            out[name] = arr
    return shard_table(out, mesh)


class DistAggExecutor:
    """Sharded dense-grid group-by: local partials on each shard's device
    through the row-path kernels, then ``mesh_merge`` on the mesh's first
    device.  The single-device twin is query/physical.py's row path."""

    def __init__(self, mesh):
        self.mesh = tuple(mesh)
        self._cache: dict[tuple, _MeshPlan] = {}

    def aggregate(
        self,
        table: ShardedTable,
        key_specs: list[tuple],
        agg_specs: list[tuple],
        *,
        ts_column: str | None = None,
        where_fn=None,
        where_cols: tuple = (),
        where_key=None,
        time_range: tuple = (None, None),
    ) -> dict[str, np.ndarray]:
        """``key_specs``: ("tag", column, card) | ("time", ts_column,
        step, start, nbuckets).  ``agg_specs``: (out, op, col) with op in
        sum/count/min/max/mean, first/last (value at the extreme
        ``ts_column``), hll, and (out, "udd", col, (gamma, nb)).
        ``where_fn`` (compiled over ``where_cols``) and ``time_range``
        filter rows inside each shard: the pushed-down WHERE of the
        partial plan.  Returns host arrays over the dense grid, plus
        ``__count__`` (the matching rows of each group)."""
        cards = []
        for spec in key_specs:
            if spec[0] == "tag":
                cards.append(int(spec[2]))
            elif spec[0] == "time":
                cards.append(int(spec[4]))
            else:
                raise Unsupported(f"dist key {spec[0]}")
        grid = 1
        for c in cards:
            grid *= c
        tr_flags = (time_range[0] is not None, time_range[1] is not None)
        # one plan per shape: the range bounds are arguments, so rolling
        # windows share it; the WHERE keys by its expression text (a fresh
        # compile_device closure per query must still hit)
        key = (tuple(key_specs), tuple(agg_specs), grid,
               table.rows_per_shard, ts_column, where_key, tr_flags)
        plan = self._cache.get(key)
        first = plan is None
        if first:
            plan = _MeshPlan(key_specs, agg_specs, cards, grid, ts_column,
                             where_fn, where_cols, tr_flags)
            self._cache[key] = plan
        lo = int(time_range[0]) if time_range[0] is not None else 0
        hi = int(time_range[1]) if time_range[1] is not None else 0
        phase = "compile" if first else "execute"
        t0 = time.perf_counter()
        with TRACER.stage("collectives", devices=len(self.mesh),
                          phase=phase):
            with on_device(table.mesh[0]):
                out = plan.run(table, lo, hi)
            out = {k: v.cpu().numpy() for k, v in out.items()}
        M_MESH_COLLECTIVE.labels(str(len(self.mesh)), phase).observe(
            time.perf_counter() - t0)
        return out

    @staticmethod
    def _col_names(key_specs, agg_specs, ts_column=None, where_cols=()):
        names = ({s[2] for s in agg_specs if s[2]}
                 | {s[1] for s in key_specs if s[0] == "tag"}
                 | {s[1] for s in key_specs if s[0] == "time"}
                 | set(where_cols))
        if ts_column:  # first/last picks and the time-range filter
            names.add(ts_column)
        return sorted(names)


class _MeshPlan:
    """One aggregate's specs, run over a ShardedTable: the local phase per
    device group, then the exchange and the epilogues (the reference's
    ``local`` under shard_map)."""

    def __init__(self, key_specs, agg_specs, cards, grid, ts_column,
                 where_fn, where_cols, tr_flags):
        self.key_specs = list(key_specs)
        self.agg_specs = list(agg_specs)
        self.cards = cards
        self.grid = grid
        self.ts_column = ts_column
        self.where_fn = where_fn
        self.tr_flags = tr_flags
        self.names = DistAggExecutor._col_names(key_specs, agg_specs,
                                                ts_column, where_cols)

    # ---- local phase ------------------------------------------------------
    def _ids(self, env, mask, lo, hi, shards: int, per: int):
        """(valid rows, int32 segment ids): a row's group id offset by its
        shard's ``shard * (grid + 1)``, dead rows in the shard's overflow
        segment ``grid``."""
        if self.where_fn is not None:
            w = torch.as_tensor(self.where_fn(env), device=mask.device)
            mask = mask & torch.broadcast_to(w, mask.shape)
        if self.ts_column is not None and any(self.tr_flags):
            ts = env[self.ts_column]
            if self.tr_flags[0]:
                mask = mask & (ts >= lo)
            if self.tr_flags[1]:
                mask = mask & (ts < hi)
        codes = []
        for spec in self.key_specs:
            if spec[0] == "tag":
                codes.append(env[spec[1]].to(torch.int64))
            else:
                _kind, ts_col, step, start, _nb = spec
                codes.append(bucket_index(env[ts_col], step, start))
        if codes:
            gid, _tot = combine_keys(codes, self.cards)
        else:  # global aggregate: every row in the one group
            gid = torch.zeros(mask.shape, dtype=torch.int64,
                              device=mask.device)
        valid = mask & (gid >= 0)
        off = torch.arange(shards, dtype=torch.int64, device=mask.device
                           ).repeat_interleave(per) * (self.grid + 1)
        ids = (torch.where(valid, gid, self.grid) + off).to(torch.int32)
        return valid, ids

    def run(self, table: ShardedTable, lo: int, hi: int) -> dict:
        G = self.grid
        per = table.rows_per_shard
        root = table.mesh[0]
        groups = table.groups
        order = [s for _dev, shards in groups for s in shards]
        inv = None
        if order != list(range(table.num_shards)):
            inv = torch.as_tensor(np.argsort(order), device=root)
        locs = []
        for gi, (_dev, shards) in enumerate(groups):
            env = {n: table.columns[n][gi] for n in self.names}
            valid, ids = self._ids(env, table.row_mask[gi], lo, hi,
                                   len(shards), per)
            locs.append((env, valid, ids, len(shards)))

        def each(fn) -> list:
            """``fn(loc)`` for every device group, its card current."""
            out = []
            for loc in locs:
                with on_device(loc[2].device):
                    out.append(fn(loc))
            return out

        def view(x, shards):  # [shards * (G + 1), ...] -> [shards, G, ...]
            return x.reshape(shards, G + 1, *x.shape[1:])[:, :G]

        def exchange(parts) -> torch.Tensor:
            """Per-group [Dk, G, ...] partials -> [D, G, ...] on the mesh's
            first device, shards in mesh order."""
            moved = [p.to(root) for p in parts]
            cat = torch.cat(moved) if len(moved) > 1 else moved[0]
            return (cat if inv is None else cat[inv]).contiguous()

        def is_float(col):
            return locs[0][0][col].is_floating_point()

        def m_of(loc, col):  # counted rows of col: valid and not NaN
            env, valid, _ids, _dk = loc
            v = env[col]
            return valid & ~torch.isnan(v) if v.is_floating_point() \
                else valid

        local_cnt: dict = {}   # count key -> per-group [Dk, G] int64
        merged_cnt: dict = {}  # count key -> [G] int64

        def cnt_key(col):
            # integer columns count the valid rows, as count(*) does
            return col if col and is_float(col) else "*"

        def count_of(col):
            k = cnt_key(col)
            c = merged_cnt.get(k)
            if c is None:
                parts = local_cnt.get(k)
                if parts is None:
                    parts = local_cnt[k] = each(lambda loc: view(
                        sk.segment_reduce(
                            None, loc[2], loc[3] * (G + 1), "sum",
                            loc[1] if k == "*" else m_of(loc, k))[1],
                        loc[3]))
                c = merged_cnt[k] = mk.mesh_merge(exchange(parts), "sum")
            return c

        # float-path reductions, one wide launch per op over its columns
        # (mean and the float sums add in f32; min/max of the f32 cast)
        fcols: dict[str, list] = {"sum": [], "min": [], "max": []}
        for spec_t in self.agg_specs:
            op, col = spec_t[1], spec_t[2]
            if col is None:
                continue
            if op == "mean" or (op == "sum" and is_float(col)):
                fop = "sum"
            elif op in ("min", "max") and is_float(col):
                fop = op
            else:
                continue
            if col not in fcols[fop]:
                fcols[fop].append(col)
        fres: dict[tuple, torch.Tensor] = {}
        for fop, cols in fcols.items():
            if not cols:
                continue
            red = each(lambda loc, cols=cols, fop=fop: sk.segment_reduce(
                [loc[0][c].to(torch.float32) for c in cols], loc[2],
                loc[3] * (G + 1), fop, loc[1]))
            vparts = [view(r[0], loc[3]) for r, loc in zip(red, locs)]
            cparts = [view(r[1], loc[3]) for r, loc in zip(red, locs)]
            merged = mk.mesh_merge(exchange(vparts), fop)
            mcnt = None
            for j, c in enumerate(cols):
                fres[(fop, c)] = merged[:, j]
                k = cnt_key(c)
                if k not in local_cnt:
                    local_cnt[k] = [p[..., j] for p in cparts]
                if k not in merged_cnt:
                    # the block's counts merge in one launch
                    if mcnt is None:
                        mcnt = mk.mesh_merge(exchange(cparts), "sum")
                    merged_cnt[k] = mcnt[:, j]

        out: dict[str, torch.Tensor] = {}
        spec_extra = {s[0]: s[3] for s in self.agg_specs if len(s) > 3}
        nan = float("nan")
        for spec_t in self.agg_specs:
            out_name, op, col = spec_t[0], spec_t[1], spec_t[2]
            if op == "count":
                out[out_name] = count_of(col)
                continue
            is_f = is_float(col)
            if op == "sum" and not is_f:
                # int64 totals stay exact; empty groups are NULLed on the
                # host through the count
                parts = each(lambda loc, col=col: view(sk.segment_reduce(
                    loc[0][col].to(torch.int64), loc[2], loc[3] * (G + 1),
                    "sum", loc[1])[0], loc[3]))
                out[out_name] = mk.mesh_merge(exchange(parts), "sum")
            elif op in ("sum", "mean"):
                total = fres[("sum", col)]
                cnt = count_of(col)
                if op == "sum":
                    # all-NULL groups: SUM is NULL, not 0
                    out[out_name] = torch.where(cnt > 0, total, nan)
                else:
                    out[out_name] = torch.where(
                        cnt > 0, total / torch.clamp(cnt, min=1).to(
                            torch.float32), nan)
            elif op in ("min", "max"):
                cnt = count_of(col)
                if is_f:
                    out[out_name] = torch.where(cnt > 0, fres[(op, col)],
                                                nan)
                else:
                    # int64 stays exact (pick-pair companion timestamps)
                    parts = each(lambda loc, col=col, op=op: view(
                        sk.segment_reduce(
                            loc[0][col].to(torch.int64), loc[2],
                            loc[3] * (G + 1), op, loc[1])[0], loc[3]))
                    merged = mk.mesh_merge(exchange(parts), op)
                    out[out_name] = torch.where(cnt > 0, merged, 0)
            elif op == "hll":
                # registers are a commutative max-fold: the sketch IS the
                # exchange format
                parts = each(lambda loc, col=col: view(shk.hll_fold(
                    loc[0][col], loc[2], loc[3] * (G + 1), m_of(loc, col)),
                    loc[3]))
                out[out_name] = mk.mesh_merge(exchange(parts), "max")
            elif op == "udd":
                out[out_name] = self._udd(each, col, spec_extra[out_name],
                                          view, exchange, m_of)
            elif op in ("first", "last"):
                last = op == "last"

                def pick(loc, col=col, is_f=is_f, last=last):
                    env, valid, ids, dk = loc
                    v = env[col]
                    vv = v if is_f else v.to(torch.int64)  # ints exact
                    ext_ts, val = segment_first_last(
                        env[self.ts_column], vv, ids, dk * (G + 1), valid,
                        last=last)
                    return view(ext_ts, dk), view(val, dk)

                ts_p, val_p = map(list, zip(*each(pick)))
                cnt = count_of(col)
                has_p = [p > 0 for p in local_cnt[cnt_key(col)]]
                _g_ts, merged = mk.mesh_pick(exchange(ts_p), exchange(has_p),
                                             exchange(val_p), last)
                out[out_name] = torch.where(cnt > 0, merged,
                                            nan if is_f else 0)
            else:
                raise Unsupported(f"dist agg {op}")
        out["__count__"] = count_of(None)
        return out

    def _udd(self, each, col, cfg, view, exchange, m_of):
        """UDDSketch rows [G, nb + 2]: the shards' key extremes merged to
        the global ones first (each shard must pick the same collapse),
        then each shard's bucket counts against them, summed."""
        gamma, nb = cfg
        G = self.grid
        ext = each(lambda loc: [view(x, loc[3]) for x in shk.udd_extremes(
            loc[0][col], loc[2], loc[3] * (G + 1), m_of(loc, col), gamma)])
        kmin_g = mk.mesh_merge(exchange([e[0] for e in ext]), "min")
        kmax_g = mk.mesh_merge(exchange([e[1] for e in ext]), "max")

        def fold(loc):
            env, _valid, ids, dk = loc

            def tiled(x, sentinel):  # [G] -> every shard's [G + 1] slots
                x = torch.cat([x, x.new_full((1,), sentinel)]).to(ids.device)
                return x.repeat(dk)

            rows = shk.udd_fold(env[col], ids, dk * (G + 1), m_of(loc, col),
                                gamma, nb, extremes=(
                                    tiled(kmin_g, shk.K_SENTINEL),
                                    tiled(kmax_g, -shk.K_SENTINEL)))
            return view(rows, dk)

        return mk.mesh_merge(exchange(each(fold)), "udd")


def execute_select_on_mesh(
    executor: DistAggExecutor,
    table: ShardedTable,
    sel,
    ctx,
    ts_bounds: tuple[int, int],
):
    """Run a partial-decomposable Select on the mesh executor, finished by
    the SHARED merge definition (rpc/partial.py merge_partials): one
    commutativity split for the cross-process exchange and the mesh.

    Returns (column_names, rows) unordered, or None when the query is not
    mesh-decomposable (the caller falls back to the single-device row
    path).  Expression group keys are supported when they reference tag
    columns only: the mesh aggregates at (tag combination x bucket)
    granularity and the host fold through merge_partials collapses the
    combinations that share one expression value.
    """
    from greptimedb_tpu_torch.query.ast import Column, Star
    from greptimedb_tpu_torch.query.exprs import compile_device, eval_host
    from greptimedb_tpu_torch.query.planner import (
        plan_select, referenced_columns,
    )
    from greptimedb_tpu_torch.rpc.partial import merge_partials, split_partial

    ts_name = (ctx.schema.time_index.name
               if ctx.schema.time_index is not None else None)
    if ts_bounds is None:  # empty region (ts_bounds() -> None)
        ts_bounds = (0, 0)
    pplan = split_partial(sel, ts_column=ts_name)
    if pplan is None:
        return None
    psel = pplan.partial_select
    try:
        plan = plan_select(sel, ctx)
    except Exception:  # noqa: BLE001 — planner rejection = not mesh-able
        return None
    gk_by_str = {str(k.expr): k for k in plan.group_keys}
    tag_names = {c.name for c in ctx.schema.tag_columns}

    ops_map = {"sum": "sum", "count": "count", "min": "min", "max": "max",
               "first_value": "first", "last_value": "last"}
    tag_cols: list[str] = []
    time_spec = None
    key_exprs: list[tuple] = []  # (alias, expr, kind, extra)
    agg_specs: list[tuple] = []
    for it in psel.items:
        alias = it.alias
        if alias in pplan.key_cols:
            gk = gk_by_str.get(str(it.expr))
            if gk is None:
                return None
            if gk.kind == "tag":
                if gk.column not in tag_cols:
                    tag_cols.append(gk.column)
                key_exprs.append((alias, it.expr, "tag", gk.column))
            elif gk.kind == "time":
                if time_spec is not None or ts_name is None:
                    return None  # one time key on the dense bucket axis
                lo, hi = plan.time_range
                data_lo, data_hi = ts_bounds
                lo = data_lo if lo is None else max(lo, data_lo)
                hi = data_hi + 1 if hi is None else min(hi, data_hi + 1)
                if hi <= lo:
                    hi = lo + 1
                step = gk.step or 1
                start = gk.origin + ((lo - gk.origin) // step) * step
                nb = max(1, -(-(hi - start) // step))
                time_spec = (ts_name, step, start, nb)
                key_exprs.append((alias, it.expr, "time", None))
            else:
                refs: set = set()
                referenced_columns(it.expr, ctx, refs)
                if not refs <= tag_names:
                    return None  # field-expression keys: no dense bound
                for c in sorted(refs):
                    if c not in tag_cols:
                        tag_cols.append(c)
                key_exprs.append((alias, it.expr, "expr",
                                  tuple(sorted(refs))))
        else:
            fc = it.expr
            fname = getattr(fc, "name", None)
            # sketch partials: the mesh folds HLL registers / UDD buckets
            # and the host fold serializes states for the shared merge
            if fname == "hll":
                if (len(fc.args) != 1
                        or not isinstance(fc.args[0], Column)):
                    return None
                col = ctx.resolve(fc.args[0].name)
                if col in tag_names:
                    return None
                agg_specs.append((alias, "hll", col))
                continue
            if fname == "uddsketch_state":
                from greptimedb_tpu_torch.ops.sketch import udd_gamma
                from greptimedb_tpu_torch.query.ast import Literal as _Lit

                if (len(fc.args) != 3
                        or not isinstance(fc.args[0], _Lit)
                        or not isinstance(fc.args[1], _Lit)
                        or not isinstance(fc.args[2], Column)):
                    return None
                try:
                    # the row path's clamp: mesh and single-device states
                    # carry identical (gamma, nb) configs
                    nb = max(8, min(int(fc.args[0].value), 4096))
                    gamma = udd_gamma(float(fc.args[1].value))
                except (ValueError, TypeError):
                    return None  # the single-device path raises the error
                col = ctx.resolve(fc.args[2].name)
                if col in tag_names:
                    return None
                agg_specs.append((alias, "udd", col, (gamma, nb)))
                continue
            op = ops_map.get(fname)
            if op is None:
                return None
            if not fc.args or isinstance(fc.args[0], Star):
                col = None
                if op != "count":
                    return None
            elif isinstance(fc.args[0], Column):
                col = ctx.resolve(fc.args[0].name)
                if col in tag_names:
                    # aggregating a dictionary-encoded tag would emit raw
                    # codes
                    return None
            else:
                return None  # computed aggregate arguments: row path
            agg_specs.append((alias, op, col))

    cards = [max(len(ctx.encoders[c]), 1) for c in tag_cols]
    key_specs: list[tuple] = [
        ("tag", c, card) for c, card in zip(tag_cols, cards)
    ]
    if time_spec is not None:
        key_specs.append(("time",) + time_spec)
        cards.append(time_spec[3])
    from greptimedb_tpu_torch.query.physical import DENSE_LIMIT

    total_groups = 1
    for c in cards:
        total_groups *= c
    if total_groups > DENSE_LIMIT:
        # the dense row path's cap: an unbounded bucket grid (GROUP BY raw
        # ts, step 1) would allocate [grid]-sized buffers per aggregate
        return None

    where_fn, where_cols = None, ()
    if plan.where is not None:
        refs = set()
        referenced_columns(plan.where, ctx, refs)
        try:
            where_fn = compile_device(plan.where, ctx)
        except Exception:  # noqa: BLE001
            return None
        where_cols = tuple(ctx.resolve(c) for c in sorted(refs))
    needs_ts = (
        ts_name is not None
        and (plan.time_range != (None, None)
             or any(s[1] in ("first", "last") for s in agg_specs))
    )
    needed = executor._col_names(
        key_specs, agg_specs, ts_name if needs_ts else None, where_cols)
    if not set(needed) <= set(table.columns):
        return None  # e.g. string FIELD columns dropped by shard_region
    # the WHERE closure bakes dictionary codes when it is compiled, so the
    # plan cache keys on (table, expression text, dictionary versions): a
    # new tag value builds a new plan instead of hitting a stale predicate
    dict_ver = tuple(
        len(ctx.encoders[c.name]) for c in ctx.schema.tag_columns)
    out = executor.aggregate(
        table, key_specs, agg_specs,
        ts_column=ts_name if needs_ts else None,
        where_fn=where_fn, where_cols=where_cols,
        where_key=(sel.table, str(plan.where), dict_ver)
        if plan.where is not None else (sel.table, None, dict_ver),
        time_range=plan.time_range,
    )

    # ---- host fold through the shared merge ---------------------------
    cnt = out["__count__"]
    keep = np.nonzero(cnt > 0)[0]
    if not key_exprs and len(keep) == 0:
        # SQL: a global aggregate returns exactly one row even when zero
        # rows matched (count()=0, other aggregates NULL)
        part0: dict[str, list] = {}
        for spec_t in agg_specs:
            part0[spec_t[0]] = [0 if spec_t[1] == "count" else None]
        return merge_partials(pplan, [part0])
    comps = (np.unravel_index(keep, tuple(cards)) if cards
             else (np.zeros(len(keep), dtype=np.int64),))
    env_host: dict[str, np.ndarray] = {}
    for i, c in enumerate(tag_cols):
        decoded = np.asarray(ctx.encoders[c].values(), dtype=object)
        env_host[c] = decoded[comps[i]]
    part: dict[str, list] = {}
    for alias, expr, kind, extra in key_exprs:
        if kind == "tag":
            part[alias] = env_host[extra].tolist()
        elif kind == "time":
            _tsn, step, start, _nb = time_spec
            part[alias] = (start + comps[-1].astype(np.int64) * step).tolist()
        else:
            v = eval_host(expr, dict(env_host), len(keep))
            arr = np.asarray(v, dtype=object)
            if arr.ndim == 0:
                arr = np.full(len(keep), arr.item(), dtype=object)
            part[alias] = arr.tolist()
    for spec_t in agg_specs:
        alias, aop = spec_t[0], spec_t[1]
        vals = np.asarray(out[alias])[keep]
        if aop == "hll":
            from greptimedb_tpu_torch.ops import sketch as sk_host

            part[alias] = [sk_host.encode_hll(r) for r in vals]
        elif aop == "udd":
            from greptimedb_tpu_torch.ops import sketch as sk_host

            gamma, nb = spec_t[3]
            part[alias] = [sk_host.encode_udd(r, gamma, nb) for r in vals]
        elif vals.dtype.kind == "f":
            part[alias] = [None if v != v else float(v) for v in vals]
        else:
            part[alias] = vals.tolist()
    return merge_partials(pplan, [part])
