"""QueryEngine: executes Select statements and shapes results.

Torch counterpart of the reference's ``query/engine.py``: planning and
result shaping on host, the middle on the device via ``query.physical``.
Routes, in the reference's order: the dense grid (the
``bucket_reduce``/``group_merge`` kernels) for the aggregates it can
serve, then the row path over the resident ``DeviceTable`` (the
``segment_reduce``/``sorted_segment_reduce``/``compact``/
``radix_argsort`` kernels) for every other aggregate and every raw
SELECT.  ``GREPTIME_GRID=off`` forces the row path.  Post-aggregation
shaping (HAVING → ORDER BY → LIMIT → projection) mirrors the standard SQL
operator order.

Not ported yet: joins, subqueries, the stacked batch dispatch, the mesh
route and the expression-key host fold (``_execute_expr_key_agg``; its
plans take the row path, as the reference's do when it declines).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from greptimedb_tpu_torch.errors import PlanError, Unsupported
from greptimedb_tpu_torch.query.ast import (
    Exists, InSubquery, ScalarSubquery, Select, SelectItem, Star,
)
from greptimedb_tpu_torch.query.exprs import TableContext, eval_host
from greptimedb_tpu_torch.query.physical import Executor, grid_plan_candidate
from greptimedb_tpu_torch.query.planner import SelectPlan, plan_select
from greptimedb_tpu_torch.query.window import collect_windows, compute_window
from greptimedb_tpu_torch.utils.tracing import TRACER


@dataclass
class QueryResult:
    column_names: list[str]
    rows: list[list]
    affected_rows: int = 0
    # greptime type names per column (e.g. "Float64", "TimestampMillisecond")
    column_types: list[str] | None = None

    @property
    def num_rows(self) -> int:
        return len(self.rows)

    def to_pydict(self) -> dict[str, list]:
        return {
            name: [r[i] for r in self.rows]
            for i, name in enumerate(self.column_names)
        }

    def __repr__(self) -> str:
        return f"QueryResult[{len(self.rows)} rows x {len(self.column_names)} cols]"


class TableProvider:
    """What the engine needs from the storage/catalog layers."""

    def table_context(self, table: str) -> TableContext:
        raise NotImplementedError

    def grid_table(self, table: str, plan: SelectPlan):
        """Returns (GridTable | None, ts_bounds)."""
        raise NotImplementedError

    def device_table(self, table: str, plan: SelectPlan):
        """Returns (DeviceTable, ts_bounds): the row path's input."""
        raise NotImplementedError


def _null_key(v, asc: bool, nulls_first: bool | None):
    # SQL default: NULLS LAST when ASC, NULLS FIRST when DESC
    is_null = v is None or (isinstance(v, float) and np.isnan(v))
    if nulls_first is None:
        nulls_first = not asc
    null_rank = 0 if (is_null and nulls_first) else (2 if is_null else 1)
    return null_rank, v if not is_null else 0


class QueryEngine:
    def __init__(self, provider: TableProvider):
        self.provider = provider
        self.executor = Executor()

    # ------------------------------------------------------------------
    def execute_select(self, sel: Select, metrics: dict | None = None) -> QueryResult:
        import time as _time

        from greptimedb_tpu_torch.query.ast import expr_contains

        if metrics is None:
            metrics = getattr(self.provider, "stage_sink", None)
        if any(
            e is not None and expr_contains(
                e, (ScalarSubquery, InSubquery, Exists))
            for e in [sel.where, sel.having] + [it.expr for it in sel.items]
        ):
            raise Unsupported("subqueries not ported yet")
        if sel.table is None:
            return self._execute_tableless(sel)
        if sel.joins:
            raise Unsupported("joins not ported yet")

        def mark(name, t0):
            if metrics is not None:
                metrics[name] = round((_time.perf_counter() - t0) * 1000, 3)
            return _time.perf_counter()

        t = _time.perf_counter()
        ctx = self.provider.table_context(sel.table)
        from greptimedb_tpu_torch.query.optimizer import optimize_select

        with TRACER.stage("optimize"):
            sel, opt_rules = optimize_select(sel, ctx)
        with TRACER.stage("plan"):
            plan = plan_select(sel, ctx)
        if metrics is not None and opt_rules:
            metrics["optimizer_rules"] = ",".join(opt_rules)
        t = mark("plan_ms", t)
        # dense time-grid path: regular-cadence metric tables lower
        # (tags × time bucket) aggregation to the bucket reduce and the
        # series→group merge; everything else takes the row path
        res = None
        scanned = 0
        if (os.environ.get("GREPTIME_GRID", "auto") != "off"
                and grid_plan_candidate(plan)):
            grid, ts_bounds = self.provider.grid_table(sel.table, plan)
            if grid is not None:
                t = mark("scan_cache_ms", t)
                with TRACER.stage("execute"):
                    res = self.executor.execute_grid(
                        plan, grid, ts_bounds, metrics=metrics)
                if res is not None:
                    scanned = grid.spad * grid.tpad
                    if metrics is not None:
                        metrics["grid"] = True
        if res is None:
            table, ts_bounds = self.provider.device_table(sel.table, plan)
            t = mark("scan_cache_ms", t)
            with TRACER.stage("execute"):
                res = self.executor.execute(plan, table, ts_bounds,
                                            metrics=metrics)
            scanned = table.padded_rows
        env, n = res
        t = mark("device_exec_ms", t)
        with TRACER.stage("materialize"):
            if plan.sliding is not None:
                env, n = _apply_sliding(plan, env, n)
            result = self._shape(plan, env, n)
        mark("shape_ms", t)
        if metrics is not None:
            metrics["output_rows"] = len(result.rows)
            metrics["scanned_rows_padded"] = scanned
        return result

    def _execute_tableless(self, sel: Select) -> QueryResult:
        env: dict[str, np.ndarray] = {}
        names: list[str] = []
        row: list[object] = []
        for item in sel.items:
            if isinstance(item.expr, Star):
                raise PlanError("SELECT * without FROM")
            from greptimedb_tpu_torch.query.ast import FuncCall, Literal

            e = item.expr
            if isinstance(e, FuncCall) and e.name == "version":
                v = "greptimedb-tpu-0.1.0"
            elif isinstance(e, FuncCall) and e.name in ("now", "current_timestamp"):
                import time as _time

                v = int(_time.time() * 1000)
            elif isinstance(e, FuncCall) and e.name in ("database", "current_schema"):
                v = "public"
            else:
                v = eval_host(e, env, 1)
                if isinstance(v, np.ndarray):
                    v = v.item() if v.size == 1 else v.tolist()
            names.append(item.output_name)
            row.append(v)
        return QueryResult(names, [row])

    def _shape(self, plan: SelectPlan, env: dict[str, np.ndarray], n: int) -> QueryResult:
        ctx = plan.ctx
        # host date functions (date_trunc/date_part/…) need the table's
        # timestamp unit; stash the native→ms factor in the eval env
        try:
            env.setdefault("__ts_factor__", ctx.ts_unit_ms_factor())
        except Exception:  # noqa: BLE001 — no time index
            pass
        # expand stars
        items: list[SelectItem] = []
        for item in plan.items:
            if isinstance(item.expr, Star):
                if plan.is_agg:
                    raise PlanError("SELECT * with GROUP BY")
                from greptimedb_tpu_torch.query.ast import Column

                for c in ctx.schema:
                    if c.name.startswith("__") and c.name.endswith("__"):
                        continue  # internal (join row ids, engine columns)
                    items.append(SelectItem(Column(c.name)))
            else:
                items.append(item)

        # window functions: compute each once into env (eval_host then
        # resolves WindowFunc nodes by name)
        wfs: list = []
        for item in items:
            if not isinstance(item.expr, Star):
                collect_windows(item.expr, wfs)
        for o in plan.order_by:
            collect_windows(o.expr, wfs)
        if wfs:
            if plan.is_agg:
                raise PlanError(
                    "window functions over GROUP BY results are not"
                    " supported; wrap the aggregate in a subquery")
            for wf in wfs:
                env[str(wf)] = compute_window(wf, env, n, eval_host)

        out_cols: dict[str, np.ndarray] = {}
        for item in items:
            key = item.output_name
            v = eval_host(item.expr, env, n)
            arr = np.asarray(v, dtype=object if isinstance(v, str) else None)
            if arr.ndim == 0:
                arr = np.full(n, arr.item() if arr.dtype != object else v)
            out_cols[key] = arr
            env.setdefault(key, arr)
            env.setdefault(str(item.expr), arr)

        keep = np.ones(n, dtype=bool)
        if plan.having is not None:
            keep &= np.asarray(eval_host(plan.having, env, n), dtype=bool)
        idx = np.nonzero(keep)[0]

        names = [i.output_name for i in items]
        if plan.distinct:
            seen: set = set()
            uniq = []
            for i in idx.tolist():
                k = tuple(_pyval(out_cols[name][i]) for name in names)
                if k not in seen:
                    seen.add(k)
                    uniq.append(i)
            idx = np.array(uniq, dtype=np.int64)

        if plan.order_by:
            sort_cols = []
            for o in plan.order_by:
                v = np.asarray(eval_host(o.expr, env, n), dtype=object)
                if v.ndim == 0:
                    v = np.full(n, v.item(), dtype=object)
                sort_cols.append((v, o.asc, o.nulls_first))

            def key_fn(i: int):
                parts = []
                for v, asc, nf in sort_cols:
                    nr, val = _null_key(v[i], asc, nf)
                    parts.append((nr, _Reversed(val) if not asc else val))
                return tuple(parts)

            idx = np.array(sorted(idx.tolist(), key=key_fn), dtype=np.int64)

        if plan.offset:
            idx = idx[plan.offset:]
        if plan.limit is not None:
            idx = idx[: plan.limit]

        # column-wise materialization: ndarray.tolist() converts to Python
        # scalars in C (no per-cell numpy scalar boxing), then one zip —
        # ~8x faster than per-cell indexing at 50k-row results
        cols_py: list[list] = []
        for name in names:
            col = out_cols[name][idx]
            lst = col.tolist()
            if col.dtype.kind == "f" and bool(np.isnan(col).any()):
                lst = [None if v != v else v for v in lst]
            elif col.dtype.kind == "O":
                lst = [_pyval(v) for v in lst]
            cols_py.append(lst)
        rows: list[list] = [list(t) for t in zip(*cols_py)] if names else []
        return QueryResult(names, rows, column_types=[
            _infer_type(item.expr, plan) for item in items
        ])


def _apply_sliding(plan: SelectPlan, env: dict, n: int) -> tuple[dict, int]:
    """Combine s-wide tumbling partials into sliding [t, t+w) windows
    (reference range_select semantics: RANGE w evaluated at each ALIGN step).
    Partial volumes are small (groups x buckets), so this runs on host."""
    import collections

    w, s = plan.sliding
    k = w // s
    time_key = next(g for g in plan.group_keys if g.kind == "time")
    tag_keys = [g for g in plan.group_keys if g is not time_key]
    partial_names = sorted({p for parts in plan.sliding_rewrites.values()
                            for p in parts})

    groups: dict = collections.defaultdict(dict)  # tag values -> {bucket: i}
    for i in range(n):
        tags = tuple(env[str(g.expr)][i] for g in tag_keys)
        groups[tags][int(env[str(time_key.expr)][i])] = i

    out_rows: list[tuple] = []  # (tags, t, {partial: combined})
    for tags, buckets in groups.items():
        window_starts = sorted({
            b - j * s for b in buckets for j in range(k)
        })
        for t0 in window_starts:
            window = [buckets[t0 + j * s] for j in range(k)
                      if (t0 + j * s) in buckets]
            combined = {}
            for p in partial_names:
                vals = [env[p][i] for i in window]
                vals = [v for v in vals if not (
                    isinstance(v, float) and np.isnan(v))]
                if not vals:
                    combined[p] = np.nan
                elif p.startswith(("sum(", "count(")):
                    combined[p] = sum(vals)
                elif p.startswith("min("):
                    combined[p] = min(vals)
                elif p.startswith("max("):
                    combined[p] = max(vals)
            out_rows.append((tags, t0, combined))

    m = len(out_rows)
    new_env: dict[str, np.ndarray] = {}
    for gi, g in enumerate(tag_keys):
        col = np.array([r[0][gi] for r in out_rows], dtype=object)
        new_env[g.name] = col
        new_env[str(g.expr)] = col
    tcol = np.array([r[1] for r in out_rows], dtype=np.int64)
    new_env[time_key.name] = tcol
    new_env[str(time_key.expr)] = tcol
    for p in partial_names:
        new_env[p] = np.array([r[2].get(p, np.nan) for r in out_rows])
    # reconstruct the original aggregates (avg = sum/count)
    for orig, parts in plan.sliding_rewrites.items():
        if orig in new_env:
            continue
        if orig.startswith(("avg(", "mean(")):
            s_arr = new_env[parts[0]].astype(float)
            c_arr = new_env[parts[1]].astype(float)
            new_env[orig] = np.where(c_arr > 0, s_arr / np.maximum(c_arr, 1),
                                     np.nan)
        else:
            new_env[orig] = new_env[parts[0]]
    return new_env, m


def _infer_type(expr, plan: SelectPlan) -> str:
    """Greptime type name for an output expression (best effort)."""
    from greptimedb_tpu_torch.query.ast import (
        BinaryOp, Case, Cast, Column, FuncCall, Literal,
    )

    ctx = plan.ctx
    for k in plan.group_keys:
        if str(k.expr) == str(expr):
            if k.kind == "tag":
                return "String"
            if k.kind == "time":
                return ctx.schema.time_index.dtype.value if ctx.schema.time_index else "Int64"
    if isinstance(expr, Column):
        try:
            return ctx.schema.column(ctx.resolve(expr.name)).dtype.value
        except Exception:  # noqa: BLE001
            return "String"
    if isinstance(expr, FuncCall):
        if expr.name == "count":
            return "Int64"
        if expr.name in ("sum", "min", "max", "first_value", "last_value"):
            if expr.args and isinstance(expr.args[0], Column):
                return _infer_type(expr.args[0], plan)
            return "Float64"
        if expr.name in ("date_bin", "date_trunc"):
            return ctx.schema.time_index.dtype.value if ctx.schema.time_index else "Int64"
        return "Float64"
    from greptimedb_tpu_torch.query.ast import WindowFunc as _WF
    if isinstance(expr, _WF):
        if expr.name in ("row_number", "rank", "dense_rank", "ntile",
                         "count"):
            return "Int64"
        if expr.name in ("lag", "lead", "first_value", "last_value", "sum",
                         "min", "max") and expr.args and isinstance(
                             expr.args[0], Column):
            return _infer_type(expr.args[0], plan)
        return "Float64"
    if isinstance(expr, Literal):
        v = expr.value
        if isinstance(v, bool):
            return "Boolean"
        if isinstance(v, int):
            return "Int64"
        if isinstance(v, float):
            return "Float64"
        return "String"
    if isinstance(expr, Cast):
        from greptimedb_tpu_torch.datatypes.types import ConcreteDataType

        try:
            return ConcreteDataType.parse(expr.type_name).value
        except ValueError:
            return "String"
    if isinstance(expr, Case):
        return "String"
    if isinstance(expr, BinaryOp):
        if expr.op.upper() in ("AND", "OR", "=", "!=", "<", "<=", ">", ">=",
                               "LIKE", "ILIKE"):
            return "Boolean"
        return "Float64"
    return "Float64"


class SortVal:
    """Total-orderable sort-key wrapper for host-side row ordering:
    None/NaN sort last, per-key direction."""

    __slots__ = ("v", "asc")

    def __init__(self, v, asc: bool):
        self.v = v
        self.asc = asc

    def _rank(self):
        missing = self.v is None or (
            isinstance(self.v, float) and self.v != self.v
        )
        return (1 if missing else 0, 0 if missing else self.v)

    def __lt__(self, other):
        a, b = self._rank(), other._rank()
        if a[0] != b[0]:
            return a[0] < b[0]
        if a[1] == b[1]:
            return False
        return (a[1] < b[1]) if self.asc else (a[1] > b[1])

    def __eq__(self, other):
        return self._rank() == other._rank()


class _Reversed:
    """Inverts comparison for DESC sort keys."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def _pyval(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        f = float(v)
        return None if np.isnan(f) else f
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.str_):
        return str(v)
    return v
