"""Partial-aggregation split for distributed queries.

The reference splits plans at the commutativity boundary
(src/query/src/dist_plan/analyzer.rs:109, commutativity.rs:116): the
commutative prefix (scan/filter/partial agg) executes on each datanode,
the frontend merges partial states and finishes the plan.  Here the
"sub-plan codec" is the parsed Select AST rewritten to its partial form
and shipped as SQL text — both sides share this module so the partial
schema and the merge spec are derived identically.

Decomposable aggregates: sum/count/min/max/avg (mean), plus
first_value/last_value when the caller supplies the time-index column —
they ship as (value-at-extreme-ts, extreme-ts) pick pairs.  Anything
else — DISTINCT, sliding RANGE windows, HAVING, OFFSET — falls back to
raw-scan shipping (the frontend pulls filtered rows and finishes
locally).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from greptimedb_tpu_torch.query.ast import FuncCall, Select, SelectItem

# merge op applied on the frontend over the per-datanode partial columns.
# Merge ops are either scalar ("sum"/"min"/"max") or a pick pair
# ("pick_min"/"pick_max", companion) — the value column adopts the
# incoming value exactly when the companion (timestamp) column improves,
# which is how first_value/last_value decompose: each shard ships its
# local (value-at-extreme-ts, extreme-ts) and the merge keeps the pair
# with the globally extreme ts (commutativity.rs:116 step aggregation).
_PARTIALS: dict[str, list[tuple[str, str]]] = {
    # agg -> [(partial agg fn, merge op)]
    "sum": [("sum", "sum")],
    "count": [("count", "sum")],
    "min": [("min", "min")],
    "max": [("max", "max")],
    "avg": [("sum", "sum"), ("count", "sum")],
    "mean": [("sum", "sum"), ("count", "sum")],
}
# aggs whose partials need the time index as a companion column
_PICK_PARTIALS = {"first_value": "min", "last_value": "max"}

# sketch-state aggregates: the partial is a serialized sketch state per
# group (hll/uddsketch fold on each shard), merged host-side by the state
# mergers in ops/sketch.py (reference hll.rs/uddsketch.rs merge_batch —
# sketches are the textbook commutative aggregate).  approx_distinct
# decomposes into an HLL partial whose merged state is estimated at the
# end (commutativity.rs:116 step aggregation).
#   agg -> (partial fn name, merge op)
_SKETCH_PARTIALS = {
    "approx_distinct": ("hll", "hll_state"),
    "hll": ("hll", "hll_state"),
    "hll_merge": ("hll_merge", "hll_state"),
    "uddsketch_state": ("uddsketch_state", "udd_state"),
    "uddsketch_merge": ("uddsketch_merge", "udd_state"),
}


@dataclass(frozen=True)
class MergeItem:
    """How one output column of the original query is produced from the
    merged partial columns."""

    output_name: str
    kind: str  # "key" | "agg"
    # key: index into the key columns; agg: the original agg name plus the
    # partial column names feeding it
    key_index: int = -1
    agg: str = ""
    partial_cols: tuple[str, ...] = ()


@dataclass(frozen=True)
class PartialPlan:
    partial_select: Select  # execute on each datanode
    key_cols: tuple[str, ...]  # partial-result column names of group keys
    # partial col -> merge op: "sum"/"min"/"max", or ("pick_min"|"pick_max",
    # companion_col) for first/last value-at-extreme-timestamp pairs
    merge_cols: dict[str, object]
    items: tuple[MergeItem, ...]  # original output columns in order


def split_partial(sel: Select, ts_column: str | None = None) -> PartialPlan | None:
    """Return the partial split, or None when the query must ship raw rows.

    Mirrors Commutativity::Commutative vs ::Unsupported in the reference
    commutativity table: group keys and decomposable aggregates push down;
    anything order- or distinct-sensitive does not.
    """
    if (
        sel.table is None
        or sel.distinct
        or sel.having is not None
        or sel.offset is not None
        or sel.range_ is not None
        or sel.align is not None
        or any(it.range_ is not None for it in sel.items)
    ):
        return None

    group_strs = [str(g) for g in sel.group_by]
    partial_items: list[SelectItem] = []
    key_cols: list[str] = []
    merge_cols: dict[str, object] = {}
    merge_items: list[MergeItem] = []
    matched_groups: set[str] = set()

    for i, it in enumerate(sel.items):
        expr_s = str(it.expr)
        if expr_s in group_strs or (it.alias and it.alias in group_strs):
            matched_groups.add(expr_s if expr_s in group_strs else it.alias)
            kname = f"__k{len(key_cols)}"
            partial_items.append(SelectItem(it.expr, alias=kname))
            merge_items.append(
                MergeItem(it.output_name, "key", key_index=len(key_cols))
            )
            key_cols.append(kname)
            continue
        if isinstance(it.expr, FuncCall) and not it.expr.distinct:
            if it.expr.name in _PICK_PARTIALS and ts_column:
                from greptimedb_tpu_torch.query.ast import Column

                ext = _PICK_PARTIALS[it.expr.name]
                vcol, tcol = f"__a{i}_0", f"__a{i}_1"
                partial_items.append(SelectItem(
                    FuncCall(it.expr.name, it.expr.args, distinct=False),
                    alias=vcol,
                ))
                partial_items.append(SelectItem(
                    FuncCall(ext, (Column(ts_column),), distinct=False),
                    alias=tcol,
                ))
                merge_cols[vcol] = (f"pick_{ext}", tcol)
                merge_cols[tcol] = ext
                merge_items.append(MergeItem(
                    it.output_name, "agg", agg=it.expr.name,
                    partial_cols=(vcol, tcol),
                ))
                continue
            sketch = _SKETCH_PARTIALS.get(it.expr.name)
            if sketch is not None:
                pfn, mop = sketch
                pname = f"__a{i}_0"
                partial_items.append(SelectItem(
                    FuncCall(pfn, it.expr.args, distinct=False), alias=pname))
                merge_cols[pname] = mop
                merge_items.append(MergeItem(
                    it.output_name, "agg", agg=it.expr.name,
                    partial_cols=(pname,)))
                continue
            specs = _PARTIALS.get(it.expr.name)
            if specs is None:
                return None
            pcols = []
            for j, (pfn, mop) in enumerate(specs):
                pname = f"__a{i}_{j}"
                partial_items.append(
                    SelectItem(
                        FuncCall(pfn, it.expr.args, distinct=False),
                        alias=pname,
                    )
                )
                merge_cols[pname] = mop
                pcols.append(pname)
            merge_items.append(
                MergeItem(it.output_name, "agg", agg=it.expr.name,
                          partial_cols=tuple(pcols))
            )
            continue
        return None  # bare column not in GROUP BY, expression of aggs, ...

    if not any(m.kind == "agg" for m in merge_items):
        return None  # plain projection: raw path is simpler and correct
    if set(group_strs) - matched_groups:
        # a GROUP BY key is not among the projected items: the merge would
        # collapse its groups into one row — ship raw instead
        return None

    from greptimedb_tpu_torch.query.ast import Column

    partial = replace(
        sel,
        items=partial_items,
        # every group key corresponds to a projected key item (enforced
        # above); reference them by their partial aliases so original
        # alias-based GROUP BY entries (GROUP BY minute) still resolve
        group_by=[Column(k) for k in key_cols],
        order_by=[],
        limit=None,
        offset=None,
    )
    return PartialPlan(
        partial_select=partial,
        key_cols=tuple(key_cols),
        merge_cols=dict(merge_cols),
        items=tuple(merge_items),
    )


def merge_into(slot: dict, values: dict, merge_cols: dict) -> None:
    """Fold one partial row into an accumulator slot — the ONE definition
    of partial-merge semantics (None-tolerant sum/min/max + first/last
    pick pairs), shared by the distributed frontend merge, the mesh
    executor's host fold, and the streaming flow engine."""
    # pick pairs first: they must compare against the companion's value
    # BEFORE this row's scalar merge updates it
    for c, op in merge_cols.items():
        if not isinstance(op, tuple):
            continue
        mode, companion = op
        v_ts = values.get(companion)
        cur_ts = slot.get(companion)
        if v_ts is None:
            continue
        better = (
            cur_ts is None
            or (v_ts < cur_ts if mode == "pick_min" else v_ts > cur_ts)
        )
        if better:
            slot[c] = values[c]
    for c, op in merge_cols.items():
        if isinstance(op, tuple):
            continue
        v = values[c]
        cur = slot[c]
        if v is None:
            continue
        if cur is None:
            slot[c] = v
        elif op == "sum":
            slot[c] = cur + v
        elif op == "min":
            slot[c] = min(cur, v)
        elif op == "max":
            slot[c] = max(cur, v)
        elif op == "hll_state":
            from greptimedb_tpu_torch.ops.sketch import merge_hll_states

            slot[c] = merge_hll_states(cur, v)
        elif op == "udd_state":
            from greptimedb_tpu_torch.ops.sketch import merge_udd_states

            slot[c] = merge_udd_states(cur, v)


def merge_partials(
    plan: PartialPlan, parts: list[dict[str, list]]
) -> tuple[list[str], list[list]]:
    """Merge per-datanode partial result columns into final output rows.

    ``parts``: one dict per datanode mapping partial column name -> values.
    Returns (column_names, rows) in the original item order (unordered;
    the caller applies ORDER BY / LIMIT).
    """
    acc: dict[tuple, dict[str, object]] = {}
    for part in parts:
        if not part:
            continue
        n = len(next(iter(part.values())))
        for r in range(n):
            key = tuple(part[k][r] for k in plan.key_cols)
            slot = acc.get(key)
            if slot is None:
                acc[key] = {c: part[c][r] for c in plan.merge_cols}
                continue
            merge_into(slot, {c: part[c][r] for c in plan.merge_cols},
                       plan.merge_cols)

    names = [m.output_name for m in plan.items]
    rows: list[list] = []
    for key, slot in acc.items():
        row = []
        for m in plan.items:
            if m.kind == "key":
                row.append(key[m.key_index])
            elif m.agg in ("avg", "mean"):
                s, c = (slot[p] for p in m.partial_cols)
                row.append(None if not c else (s if s is None else s / c))
            elif m.agg == "approx_distinct":
                from greptimedb_tpu_torch.ops.sketch import (
                    decode_hll, hll_estimate,
                )

                regs = decode_hll(slot[m.partial_cols[0]])
                row.append(0 if regs is None else int(round(
                    hll_estimate(regs))))
            else:
                row.append(slot[m.partial_cols[0]])
        rows.append(row)
    return names, rows
