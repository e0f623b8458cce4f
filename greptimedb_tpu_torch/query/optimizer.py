"""Logical optimizer rules over the Select AST.

Counterpart of the reference's custom DataFusion rule suite
(src/query/src/optimizer/: constant_term.rs, type_conversion.rs,
string_normalization.rs, scan_hint/ …) — here rules are pure
AST→AST rewrites that run BEFORE planning, and every applied rule is
recorded so EXPLAIN can show the pass list (the reference exposes the
same through DataFusion's optimizer trace).

Rules (applied in order, to fixpoint for the boolean simplifier):

- ``constant_fold``       — literal-only subtrees collapse to literals
  (1 + 2*3 → 7, 'a' = 'a' → TRUE, pure math fns of literals)
  [constant_term.rs]
- ``coerce_time_literals``— string literals compared against the time
  index parse to native timestamps at plan time, making them eligible
  for time-range pushdown [type_conversion.rs]
- ``simplify_predicates`` — boolean algebra over folded constants:
  TRUE AND x → x, FALSE OR x → x, NOT NOT x → x, FALSE AND x → FALSE,
  WHERE TRUE → no filter
- ``fold_not_comparisons``— NOT (a op b) → (a inv-op b), keeping
  predicates in the index-prunable comparison form

The planner's own time-range extraction then reports as
``time_range_pushdown`` in EXPLAIN (query/planner.py), completing the
visible pass list.
"""

from __future__ import annotations

import dataclasses
import math

from greptimedb_tpu_torch.query.ast import (
    BinaryOp, Cast, Column, Expr, FuncCall, Literal, Select, UnaryOp,
    map_expr,
)

# pure scalar fns safe to evaluate at plan time (no row context, no
# randomness, no session state like now()/database())
_PURE_FNS = {
    "abs": abs,
    "ceil": math.ceil,
    "floor": math.floor,
    "round": round,
    "sqrt": math.sqrt,
    "exp": math.exp,
    "ln": math.log,
    "log10": math.log10,
    "power": pow,
    "pow": pow,
    "upper": lambda s: str(s).upper(),
    "lower": lambda s: str(s).lower(),
    "length": lambda s: len(str(s)),
}

_CMP = {"=", "!=", "<>", "<", "<=", ">", ">="}
_NUM_OPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b if b != 0 else None,
    "%": lambda a, b: a % b if b != 0 else None,
}
_INV_CMP = {"=": "!=", "!=": "=", "<>": "=", "<": ">=", "<=": ">",
            ">": "<=", ">=": "<"}


def _is_true(e: Expr) -> bool:
    return isinstance(e, Literal) and e.value is True


def _is_false(e: Expr) -> bool:
    return isinstance(e, Literal) and e.value is False


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _cmp_literals(op: str, a, b):
    if a is None or b is None:
        return None  # NULL comparisons stay NULL — don't fold
    if op in ("=", "!=", "<>") and not (
        (_num(a) and _num(b))
        or (isinstance(a, str) and isinstance(b, str))
        or (isinstance(a, bool) and isinstance(b, bool))
    ):
        # mixed-type equality ('1' = 1): Python equality would fold it to
        # FALSE, but type-coercing SQL runtimes may disagree — leave the
        # comparison for the runtime to decide
        return None
    try:
        if op == "=":
            return bool(a == b)
        if op in ("!=", "<>"):
            return bool(a != b)
        if op == "<":
            return bool(a < b)
        if op == "<=":
            return bool(a <= b)
        if op == ">":
            return bool(a > b)
        if op == ">=":
            return bool(a >= b)
    except TypeError:
        return None
    return None


def constant_fold(e: Expr) -> Expr:
    """Collapse literal-only subtrees bottom-up (map_expr is bottom-up,
    so children are already folded when a node is visited)."""

    def fold(node):
        if isinstance(node, UnaryOp) and isinstance(node.operand, Literal):
            v = node.operand.value
            if node.op == "-" and isinstance(v, (int, float)):
                return Literal(-v)
            if node.op.upper() == "NOT" and isinstance(v, bool):
                return Literal(not v)
            return node
        if isinstance(node, BinaryOp):
            l, r = node.left, node.right
            if isinstance(l, Literal) and isinstance(r, Literal):
                op = node.op.upper() if node.op.isalpha() else node.op
                if node.op in _NUM_OPS and isinstance(
                        l.value, (int, float)) and isinstance(
                        r.value, (int, float)) and not isinstance(
                        l.value, bool) and not isinstance(r.value, bool):
                    v = _NUM_OPS[node.op](l.value, r.value)
                    if v is not None:
                        return Literal(v)
                elif node.op in _CMP:
                    v = _cmp_literals(node.op, l.value, r.value)
                    if v is not None:
                        return Literal(v)
                elif op in ("AND", "OR") and isinstance(
                        l.value, bool) and isinstance(r.value, bool):
                    return Literal(
                        (l.value and r.value) if op == "AND"
                        else (l.value or r.value))
            return node
        if isinstance(node, FuncCall) and not node.distinct:
            fn = _PURE_FNS.get(node.name)
            if fn is not None and node.args and all(
                    isinstance(a, Literal) and a.value is not None
                    for a in node.args):
                try:
                    return Literal(fn(*(a.value for a in node.args)))
                except Exception:  # noqa: BLE001 — runtime errors stay
                    return node
            return node
        return node

    return map_expr(e, fold)


def simplify_predicates(e: Expr) -> Expr:
    """Boolean algebra over folded constants (one bottom-up pass is a
    fixpoint because map_expr visits children first)."""

    def simp(node):
        if isinstance(node, BinaryOp):
            op = node.op.upper()
            if op == "AND":
                if _is_true(node.left):
                    return node.right
                if _is_true(node.right):
                    return node.left
                if _is_false(node.left) or _is_false(node.right):
                    return Literal(False)
            elif op == "OR":
                if _is_false(node.left):
                    return node.right
                if _is_false(node.right):
                    return node.left
                if _is_true(node.left) or _is_true(node.right):
                    return Literal(True)
            return node
        if isinstance(node, UnaryOp) and node.op.upper() == "NOT":
            inner = node.operand
            if (isinstance(inner, UnaryOp)
                    and inner.op.upper() == "NOT"):
                return inner.operand
            if isinstance(inner, Literal) and isinstance(inner.value, bool):
                return Literal(not inner.value)
        return node

    return map_expr(e, simp)


def fold_not_comparisons(e: Expr) -> Expr:
    """NOT (a op b) → (a inv-op b): comparisons stay in the prunable
    form the time-range extractor and index pruning understand.  Sound
    under SQL three-valued logic: both sides map NULL→NULL."""

    def fold(node):
        if (isinstance(node, UnaryOp) and node.op.upper() == "NOT"
                and isinstance(node.operand, BinaryOp)
                and node.operand.op in _INV_CMP):
            inner = node.operand
            return BinaryOp(_INV_CMP[inner.op], inner.left, inner.right)
        return node

    return map_expr(e, fold)


def coerce_time_literals(e: Expr, ctx) -> Expr:
    """String literals compared against the TIME INDEX become native
    timestamp literals at plan time (reference type_conversion.rs) — the
    planner's range extractor then sees a plain int bound."""
    from greptimedb_tpu_torch.query.parser import parse_timestamp_str

    schema = getattr(ctx, "schema", None)
    if schema is None or schema.time_index is None:
        return e
    ts_name = schema.time_index.name
    unit_ms = {
        "TimestampSecond": 0.001,
        "TimestampMillisecond": 1.0,
        "TimestampMicrosecond": 1000.0,
        "TimestampNanosecond": 1e6,
    }.get(schema.time_index.dtype.value, 1.0)

    def is_ts_col(x) -> bool:
        if not isinstance(x, Column):
            return False
        try:
            return ctx.resolve(x.name) == ts_name
        except Exception:  # noqa: BLE001
            return False

    def coerce(node):
        if not (isinstance(node, BinaryOp) and node.op in _CMP):
            return node
        for a, b, flip in ((node.left, node.right, False),
                           (node.right, node.left, True)):
            if (is_ts_col(a) and isinstance(b, Literal)
                    and isinstance(b.value, str)):
                try:
                    ms = parse_timestamp_str(
                        b.value, getattr(ctx, "timezone", "UTC"))
                except Exception:  # noqa: BLE001 — not a timestamp
                    return node
                # truncate exactly like TableContext.ts_literal (int(), not
                # round()): sub-unit literals must coerce bit-identically
                # between the plan-time and runtime paths
                native = Literal(int(ms * unit_ms))
                return (BinaryOp(node.op, native, a) if flip
                        else BinaryOp(node.op, a, native))
        return node

    return map_expr(e, coerce)


def optimize_select(sel: Select, ctx) -> tuple[Select, list[str]]:
    """Run the rule suite over WHERE/HAVING/items; returns the rewritten
    Select plus the names of rules that actually changed something (the
    EXPLAIN pass list)."""
    applied: list[str] = []

    def run(name, fn, expr):
        if expr is None:
            return None
        out = fn(expr)
        if out is not expr and str(out) != str(expr):
            if name not in applied:
                applied.append(name)
            return out
        return expr

    where = sel.where
    having = sel.having
    items = sel.items
    where = run("coerce_time_literals",
                lambda x: coerce_time_literals(x, ctx), where)
    where = run("constant_fold", constant_fold, where)
    where = run("fold_not_comparisons", fold_not_comparisons, where)
    where = run("simplify_predicates", simplify_predicates, where)
    if where is not None and _is_true(where):
        where = None
        if "simplify_predicates" not in applied:
            applied.append("simplify_predicates")
    having = run("constant_fold", constant_fold, having)
    having = run("simplify_predicates", simplify_predicates, having)
    new_items = []
    changed_items = False
    group_strs = {str(g) for g in sel.group_by}
    for it in items:
        if (str(it.expr) in group_strs
                or (it.alias and it.alias in group_strs)):
            # group-key items keep their expression form: the planner
            # matches keys by text, and a folded-to-literal key would
            # reach the device group-id path as a bare scalar
            new_items.append(it)
            continue
        ne = constant_fold(it.expr)
        if ne is not it.expr and str(ne) != str(it.expr):
            changed_items = True
            # keep the ORIGINAL text as the output name: folding must
            # not rename "1+2" to "3" in result headers
            alias = it.alias or str(it.expr)
            new_items.append(dataclasses.replace(it, expr=ne, alias=alias))
        else:
            new_items.append(it)
    if changed_items and "constant_fold" not in applied:
        applied.append("constant_fold")

    if (where is sel.where and having is sel.having
            and not changed_items):
        return sel, applied
    return dataclasses.replace(
        sel, where=where, having=having, items=new_items), applied
