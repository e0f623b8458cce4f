"""Logical planning: resolve a parsed Select against a table context.

Performs what the reference splits across DataFusion's sql-to-rel +
optimizer rules that matter here (SURVEY.md §2.3): alias/ordinal
resolution, aggregate extraction, time-range pushdown extraction
(scan_hint/type_conversion equivalents), and group-key classification for
the TPU group-by strategy choice (dense grid vs sort-ranked sparse).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from greptimedb_tpu_torch.errors import PlanError, Unsupported
from greptimedb_tpu_torch.query.ast import (
    Between, BinaryOp, Case, Cast, Column, Expr, FuncCall, InList, IntervalLit,
    IsNull, Literal, OrderByItem, Select, SelectItem, Star, UnaryOp,
)
from greptimedb_tpu_torch.query.exprs import (
    AGG_FUNCS, TableContext, collect_aggs, is_aggregate,
)


@dataclass
class GroupKey:
    expr: Expr
    kind: str  # "tag" | "time" | "expr"
    name: str  # output column name
    column: str | None = None  # tag column
    step: int | None = None  # time bucket step (ts units)
    origin: int = 0


@dataclass
class SelectPlan:
    select: Select
    ctx: TableContext
    table: str
    items: list[SelectItem]
    where: Expr | None
    time_range: tuple[int | None, int | None]
    is_agg: bool
    group_keys: list[GroupKey] = field(default_factory=list)
    aggs: list[FuncCall] = field(default_factory=list)
    having: Expr | None = None
    order_by: list[OrderByItem] = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    distinct: bool = False
    # sliding range-select: (window_ms, step_ms) in ts units when
    # `agg() RANGE w ... ALIGN s` with w != s; device computes s-wide
    # tumbling partials, the engine combines them into sliding windows
    sliding: tuple[int, int] | None = None
    # original agg -> partial aggs it decomposes into (avg -> sum+count)
    sliding_rewrites: dict = field(default_factory=dict)

    def fingerprint(self) -> str:
        gk = ";".join(f"{k.kind}:{k.expr}" for k in self.group_keys)
        return (
            f"t={self.table}|w={self.where}|g=[{gk}]|a=[{','.join(map(str, self.aggs))}]"
        )


def _substitute_aliases(e: Expr, aliases: dict[str, Expr]) -> Expr:
    """Replace bare columns that are actually select aliases."""
    if isinstance(e, Column) and e.table is None:
        target = aliases.get(e.name) or aliases.get(e.name.lower())
        if target is not None:
            return target
        return e
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, _substitute_aliases(e.left, aliases),
                        _substitute_aliases(e.right, aliases))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, _substitute_aliases(e.operand, aliases))
    if isinstance(e, FuncCall):
        return FuncCall(e.name, tuple(_substitute_aliases(a, aliases) for a in e.args),
                        e.distinct)
    if isinstance(e, Between):
        return Between(_substitute_aliases(e.expr, aliases),
                       _substitute_aliases(e.low, aliases),
                       _substitute_aliases(e.high, aliases), e.negated)
    if isinstance(e, InList):
        return InList(_substitute_aliases(e.expr, aliases),
                      tuple(_substitute_aliases(i, aliases) for i in e.items),
                      e.negated)
    if isinstance(e, IsNull):
        return IsNull(_substitute_aliases(e.expr, aliases), e.negated)
    if isinstance(e, Cast):
        return Cast(_substitute_aliases(e.expr, aliases), e.type_name)
    if isinstance(e, Case):
        return Case(
            _substitute_aliases(e.operand, aliases) if e.operand else None,
            tuple((_substitute_aliases(c, aliases), _substitute_aliases(v, aliases))
                  for c, v in e.whens),
            _substitute_aliases(e.else_, aliases) if e.else_ else None,
        )
    return e


def split_time_range(
    where: Expr | None, ctx: TableContext
) -> tuple[int | None, int | None, Expr | None]:
    """Conjunctive time bounds on the time index for scan pruning, PLUS
    the residual WHERE with the consumed conjuncts removed.

    Only top-level AND conjuncts are considered (reference: scan-hint
    optimizer extracts the same). Returns half-open [lo, hi) and the
    residual expression (None when everything was consumed). Removing
    the consumed conjuncts matters beyond avoiding double evaluation:
    the physical layer passes lo/hi as TRACED kernel arguments, so a
    rolling time window reuses one compiled kernel — but only if the
    timestamps are also gone from the plan fingerprint's WHERE text."""
    lo: int | None = None
    hi: int | None = None

    def consume(e: Expr) -> bool:
        """True if this conjunct is fully captured by (lo, hi)."""
        nonlocal lo, hi
        if isinstance(e, Between) and not e.negated:
            if isinstance(e.expr, Column) and ctx.is_ts(e.expr.name):
                if isinstance(e.low, Literal) and isinstance(e.high, Literal):
                    l = ctx.ts_literal(e.low.value)
                    h = ctx.ts_literal(e.high.value) + 1  # BETWEEN inclusive
                    lo = l if lo is None else max(lo, l)
                    hi = h if hi is None else min(hi, h)
                    return True
            return False
        if isinstance(e, BinaryOp) and e.op in ("<", "<=", ">", ">=", "="):
            col, lit, op = None, None, e.op
            if isinstance(e.left, Column) and isinstance(e.right, Literal):
                col, lit = e.left, e.right
            elif isinstance(e.right, Column) and isinstance(e.left, Literal):
                col, lit = e.right, e.left
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
            if col is None or not ctx.is_ts(col.name):
                return False
            v = ctx.ts_literal(lit.value)
            if op == ">=":
                lo = v if lo is None else max(lo, v)
            elif op == ">":
                lo = v + 1 if lo is None else max(lo, v + 1)
            elif op == "<":
                hi = v if hi is None else min(hi, v)
            elif op == "<=":
                hi = v + 1 if hi is None else min(hi, v + 1)
            else:  # "="
                lo = v if lo is None else max(lo, v)
                hi = v + 1 if hi is None else min(hi, v + 1)
            return True
        return False

    def walk(e: Expr) -> Expr | None:
        """Residual of the AND-tree after removing consumed conjuncts."""
        if isinstance(e, BinaryOp) and e.op == "AND":
            left = walk(e.left)
            right = walk(e.right)
            if left is None:
                return right
            if right is None:
                return left
            if left is e.left and right is e.right:
                return e
            return BinaryOp("AND", left, right)
        return None if consume(e) else e

    if where is None:
        return None, None, None
    residual = walk(where)
    return lo, hi, residual


def extract_time_range(
    where: Expr | None, ctx: TableContext
) -> tuple[int | None, int | None]:
    """Bounds-only view of split_time_range (distributed planner, joins)."""
    lo, hi, _ = split_time_range(where, ctx)
    return lo, hi


def plan_select(sel: Select, ctx: TableContext) -> SelectPlan:
    aliases: dict[str, Expr] = {}
    for item in sel.items:
        if item.alias and not isinstance(item.expr, Star):
            aliases[item.alias] = item.expr

    where = _substitute_aliases(sel.where, {}) if sel.where else None

    # range-select sugar: `agg(x) RANGE 'r' ... ALIGN 'a' BY (k)` becomes
    # group by (time_bucket(align), keys) with windowed aggs; round 1 maps
    # RANGE == ALIGN (tumbling windows); sliding windows arrive with promql.
    items = list(sel.items)
    group_by = list(sel.group_by)
    if sel.align is not None:
        ts_col = Column(ctx.schema.time_index.name)
        bucket = FuncCall("date_bin", (sel.align, ts_col))
        new_items: list[SelectItem] = []
        for item in items:
            if isinstance(item.expr, Column) and ctx.is_ts(item.expr.name):
                new_items.append(SelectItem(bucket, item.alias or str(item.expr)))
            else:
                new_items.append(item)
        items = new_items
        group_by = [bucket] + list(sel.align_by)

    resolved_group: list[Expr] = []
    for g in group_by:
        if isinstance(g, Literal) and isinstance(g.value, int):
            idx = g.value - 1
            if idx < 0 or idx >= len(items):
                raise PlanError(f"GROUP BY ordinal {g.value} out of range")
            resolved_group.append(items[idx].expr)
        else:
            resolved_group.append(_substitute_aliases(g, aliases))

    aggs: list[FuncCall] = []
    for item in items:
        if not isinstance(item.expr, Star):
            collect_aggs(item.expr, aggs)
    if sel.having is not None:
        collect_aggs(_substitute_aliases(sel.having, aliases), aggs)
    order_by = [
        OrderByItem(_substitute_aliases(o.expr, aliases), o.asc, o.nulls_first)
        for o in sel.order_by
    ]
    for o in order_by:
        collect_aggs(o.expr, aggs)

    is_agg = bool(aggs) or bool(resolved_group)

    group_keys: list[GroupKey] = []
    for g in resolved_group:
        name = None
        for item in items:
            if str(item.expr) == str(g):
                name = item.output_name
                break
        name = name or str(g)
        if isinstance(g, Column) and ctx.is_tag(g.name):
            group_keys.append(GroupKey(g, "tag", name, column=ctx.resolve(g.name)))
        elif (
            isinstance(g, FuncCall)
            and g.name in ("date_bin", "date_trunc")
        ):
            if g.name == "date_bin" and isinstance(g.args[0], IntervalLit):
                step = int(g.args[0].ms * ctx.ts_unit_ms_factor())
                origin = 0
                if len(g.args) > 2 and isinstance(g.args[2], Literal):
                    origin = ctx.ts_literal(g.args[2].value)
                group_keys.append(GroupKey(g, "time", name, step=step, origin=origin))
            elif g.name == "date_trunc" and isinstance(g.args[0], Literal):
                unit = str(g.args[0].value).lower()
                fixed = {
                    "second": 1000, "minute": 60_000, "hour": 3_600_000,
                    "day": 86_400_000, "week": 604_800_000,
                }
                if unit in fixed:
                    step = int(fixed[unit] * ctx.ts_unit_ms_factor())
                    origin = (
                        int(-3 * 86_400_000 * ctx.ts_unit_ms_factor())
                        if unit == "week" else 0
                    )
                    group_keys.append(
                        GroupKey(g, "time", name, step=step, origin=origin)
                    )
                else:
                    group_keys.append(GroupKey(g, "expr", name))
            else:
                group_keys.append(GroupKey(g, "expr", name))
        elif isinstance(g, Column) and ctx.is_ts(g.name):
            group_keys.append(GroupKey(g, "time", name, step=1, origin=0))
        else:
            group_keys.append(GroupKey(g, "expr", name))

    having = _substitute_aliases(sel.having, aliases) if sel.having else None

    # sliding range-select: RANGE wider than ALIGN
    sliding = None
    sliding_rewrites: dict = {}
    if sel.align is not None:
        ranges = {i.range_.ms for i in sel.items if i.range_ is not None}
        if ranges:
            w_ms = max(ranges)
            s_ms = sel.align.ms
            if len(ranges) > 1:
                raise Unsupported("mixed RANGE widths in one query")
            if w_ms != s_ms:
                if w_ms % s_ms != 0:
                    raise Unsupported(
                        f"RANGE ({w_ms}ms) must be a multiple of ALIGN ({s_ms}ms)"
                    )
                # every aggregate must carry a RANGE (the reference errors
                # likewise): a range-less agg would otherwise be silently
                # widened to the sliding window
                ranged_aggs: set[str] = set()
                for item in items:
                    if isinstance(item.expr, Star):
                        continue
                    item_aggs: list[FuncCall] = []
                    collect_aggs(item.expr, item_aggs)
                    if item_aggs and item.range_ is None:
                        raise Unsupported(
                            f"aggregate {item_aggs[0]} needs a RANGE clause "
                            "in a range query"
                        )
                    ranged_aggs.update(str(a) for a in item_aggs)
                for agg in aggs:
                    if str(agg) not in ranged_aggs:
                        raise Unsupported(
                            f"aggregate {agg} (HAVING/ORDER BY) must match a "
                            "RANGE select item"
                        )
                factor = ctx.ts_unit_ms_factor()
                sliding = (int(w_ms * factor), int(s_ms * factor))
                # decompose non-combinable aggregates into partials
                new_aggs: list[FuncCall] = []
                for agg in aggs:
                    if agg.distinct:
                        raise Unsupported(
                            "DISTINCT aggregates with sliding RANGE windows"
                        )
                    if agg.name in ("avg", "mean"):
                        parts = [FuncCall("sum", agg.args),
                                 FuncCall("count", agg.args)]
                    elif agg.name in ("sum", "min", "max", "count"):
                        parts = [agg]
                    else:
                        raise Unsupported(
                            f"{agg.name}() with sliding RANGE windows"
                        )
                    sliding_rewrites[str(agg)] = [str(p) for p in parts]
                    for p in parts:
                        if str(p) not in {str(x) for x in new_aggs}:
                            new_aggs.append(p)
                aggs = new_aggs

    ts_lo, ts_hi, residual_where = split_time_range(where, ctx)
    return SelectPlan(
        select=sel,
        ctx=ctx,
        table=sel.table or "",
        items=items,
        where=residual_where,
        time_range=(ts_lo, ts_hi),
        is_agg=is_agg,
        group_keys=group_keys,
        aggs=aggs,
        having=having,
        order_by=order_by,
        limit=sel.limit,
        offset=sel.offset,
        distinct=sel.distinct,
        sliding=sliding,
        sliding_rewrites=sliding_rewrites,
    )


def referenced_columns(e: Expr, ctx: TableContext, out: set[str]) -> None:
    """Resolved column names referenced anywhere in the tree — built on
    the shared map_expr walker so NEW node types can never be silently
    missed (a hand-rolled per-node recursion here once dropped TupleIn's
    columns and misclassified its WHERE as tag-only)."""
    from greptimedb_tpu_torch.query.ast import walk_columns

    for c in walk_columns(e):
        try:
            out.add(ctx.resolve(c.name))
        except Exception:  # noqa: BLE001 — unknown names resolve later
            pass
