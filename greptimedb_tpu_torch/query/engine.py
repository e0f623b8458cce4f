"""QueryEngine: executes Select statements and shapes results.

Torch counterpart of the reference's ``query/engine.py``: planning and
result shaping on host, the middle on the device via ``query.physical``.
Routes, in the reference's order: the dense grid (the
``bucket_reduce``/``group_merge`` kernels) for the aggregates it can
serve; then, where the provider has a device mesh, the mesh row path
(``provider.mesh_select``, ``parallel/dist.py``: the table sharded on the
series axis, local partials through the row-path kernels, merged by
``mesh_merge``) for the aggregates that decompose at the commutativity
boundary, with ORDER BY / LIMIT finished here (``_finish_merged``); then
the row path over the resident ``DeviceTable`` (the
``segment_reduce``/``sorted_segment_reduce``/``compact``/
``radix_argsort`` kernels) for every other aggregate and every raw
SELECT.  ``GREPTIME_GRID=off`` skips the grid, ``GREPTIME_MESH=off`` the
mesh (both read at query time).  Post-aggregation shaping (HAVING →
ORDER BY → LIMIT → projection) mirrors the standard SQL operator order.

``execute_select_batch`` serves a group of Selects that the serving
scheduler coalesced through one stacked grid dispatch
(``Executor.execute_grid_batch``).  Not ported yet: joins, subqueries and
the expression-key host fold (``_execute_expr_key_agg``; its plans take
the mesh or the row path, as the reference's do when it declines).
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

    # the device the provider's tables live on; the host evaluator's
    # vector distances run there too
    device = None

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


class SingleTableProvider(TableProvider):
    """Provider over one Region (or region-duck view): any table name maps
    to it.  The streaming flow engine evaluates its partial query over each
    arriving chunk through one.  Its ``DeviceTable`` lives on ``device``
    (the owning db's); it serves no dense grid, so its plans take the row
    path, as the reference's provider (which has no grid) does."""

    def __init__(self, view, timezone: str = "UTC", *, device):
        self.view = view
        self.timezone = timezone
        self.device = device
        self._built: tuple | None = None

    def table_context(self, table: str) -> TableContext:
        return TableContext(self.view.schema, self.view.encoders,
                            self.timezone)

    def grid_table(self, table: str, plan):
        return None, self.view.ts_bounds() or (0, 0)

    def device_table(self, table: str, plan):
        from greptimedb_tpu_torch.storage.cache import build_device_table

        gen = self.view.generation
        if self._built is None or self._built[0] != gen:
            self._built = (gen, build_device_table(self.view,
                                                   device=self.device))
        return self._built[1], self.view.ts_bounds() or (0, 0)


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
        if res is None and os.environ.get("GREPTIME_MESH", "auto") != "off":
            # the mesh row path: tables the grid refuses still aggregate
            # across the mesh when the query decomposes at the
            # commutativity boundary (merged but unordered rows; the
            # ORDER BY / LIMIT suffix finishes here)
            mesh_fn = getattr(self.provider, "mesh_select", None)
            if mesh_fn is not None and self._mesh_shapeable(sel):
                with TRACER.stage("execute"):
                    mres = mesh_fn(sel)
                if mres is not None:
                    t = mark("device_exec_ms", t)
                    with TRACER.stage("materialize"):
                        result = self._finish_merged(sel, plan, *mres)
                    mark("shape_ms", t)
                    if metrics is not None:
                        metrics["mesh_rows"] = True
                        metrics["output_rows"] = len(result.rows)
                    return result
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

    @staticmethod
    def _mesh_shapeable(sel: Select) -> bool:
        """The mesh path returns merged rows keyed by OUTPUT names; every
        ORDER BY key must be one (by alias or expression text) or the
        suffix cannot be applied here: the row path serves it."""
        names = {it.output_name for it in sel.items
                 if not isinstance(it.expr, Star)}
        return all(str(o.expr) in names for o in sel.order_by)

    def _finish_merged(self, sel: Select, plan: SelectPlan,
                       names: list[str], rows: list[list]) -> QueryResult:
        """ORDER BY / LIMIT over the merged mesh partials (the frontend
        side of the split).  No OFFSET: split_partial refuses it, so no
        such query reaches the mesh."""
        if sel.order_by:
            idx = {n: i for i, n in enumerate(names)}

            def sort_key(row):
                return [SortVal(row[idx[str(ob.expr)]], ob.asc)
                        for ob in sel.order_by]

            rows = sorted(rows, key=sort_key)
        if sel.limit is not None:
            rows = rows[: sel.limit]
        return QueryResult(names, rows, column_types=[
            _infer_type(it.expr, plan) for it in plan.items
        ])

    # ---- cross-query stacked execution --------------------------------
    def execute_select_batch(
        self, sels: list[Select], metrics: dict | None = None,
    ) -> list[QueryResult] | None:
        """Execute N concurrent Selects over the same (table, shape
        class) through ONE stacked device dispatch
        (Executor.execute_grid_batch), shaping each member's result with
        the normal per-query host tail (_shape) so batched output is
        bit-exact vs solo execution.  Returns None whenever ANY member
        falls outside the tight warm-grid eligibility — the scheduler
        then executes the group solo, so this path can only ever be a
        fast path, never a semantic fork.  (The reference also clears its
        compile journal's replay context here; the port has no compile
        journal.)"""
        if len(sels) < 2 or os.environ.get("GREPTIME_GRID", "auto") == "off":
            return None
        table = sels[0].table
        if table is None or any(
            s.table != table or s.joins or s.from_subquery is not None
            for s in sels
        ):
            return None
        from greptimedb_tpu_torch.query.ast import expr_contains

        for s in sels:
            touched = [s.where, s.having] + [it.expr for it in s.items]
            if any(
                e is not None and expr_contains(
                    e, (ScalarSubquery, InSubquery, Exists))
                for e in touched
            ):
                return None
        from greptimedb_tpu_torch.errors import TableNotFound
        from greptimedb_tpu_torch.query.optimizer import optimize_select

        try:
            ctx = self.provider.table_context(table)
            plans = []
            for s in sels:
                s_opt, _rules = optimize_select(s, ctx)
                plan = plan_select(s_opt, ctx)
                if not grid_plan_candidate(plan) or plan.sliding is not None:
                    return None
                plans.append(plan)
        except (PlanError, Unsupported, TableNotFound):
            return None
        grid, ts_bounds = self.provider.grid_table(table, plans[0])
        if grid is None:
            return None
        with TRACER.stage("execute", batch=len(plans)):
            outs = self.executor.execute_grid_batch(
                plans, grid, ts_bounds, metrics=metrics)
        if outs is None:
            return None
        results = []
        with TRACER.stage("materialize", batch=len(plans)):
            for plan, (env, n) in zip(plans, outs):
                results.append(self._shape(plan, env, n))
        return results

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
        # and host vector distances the device to run their kernel on
        env.setdefault("__device__", self.provider.device)
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
