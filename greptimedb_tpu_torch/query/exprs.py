"""Expression compilation: SQL AST → device (torch) and host (numpy) evaluators.

Device compilation rules (SURVEY.md §7.1/7.3): the device sees only numeric
tensors, so string semantics are resolved at COMPILE time against the tag
dictionaries — `host = 'web-1'` becomes `codes == 17`, `host LIKE 'us-%'`
becomes membership in a host-computed code set. Unseen values compile to
code -1, which matches nothing.

The host evaluator covers post-aggregation shaping (HAVING, ORDER BY
expressions, final projections incl. strings) over small numpy columns.
"""

from __future__ import annotations

import fnmatch
import json
import re

import numpy as np
import torch

from greptimedb_tpu_torch.datatypes.batch import DictionaryEncoder
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType
from greptimedb_tpu_torch.errors import (
    ColumnNotFound, ExecutionError, PlanError, ResourcesExhausted, Unsupported,
)
from greptimedb_tpu_torch.ops.time import (
    date_part_of, date_trunc_bucket, time_bucket,
)
from greptimedb_tpu_torch.query.ast import (
    Between, BinaryOp, Case, Cast, Column, Expr, FuncCall, InList, IntervalLit,
    IsNull, Literal, Star, TupleIn, UnaryOp, WindowFunc,
)
from greptimedb_tpu_torch.query.parser import parse_timestamp_str

AGG_FUNCS = {
    "count", "sum", "min", "max", "avg", "mean", "first_value", "last_value",
    "stddev", "stddev_pop", "var", "var_pop", "count_distinct",
    # approximate sketches (reference aggrs/approximate/)
    "hll", "hll_merge", "uddsketch_state", "uddsketch_merge",
    "approx_distinct",
}


def is_aggregate(e: Expr) -> bool:
    if isinstance(e, FuncCall):
        if e.name in AGG_FUNCS:
            return True
        return any(is_aggregate(a) for a in e.args)
    if isinstance(e, BinaryOp):
        return is_aggregate(e.left) or is_aggregate(e.right)
    if isinstance(e, UnaryOp):
        return is_aggregate(e.operand)
    if isinstance(e, (Between,)):
        return is_aggregate(e.expr)
    if isinstance(e, Cast):
        return is_aggregate(e.expr)
    return False


def collect_aggs(e: Expr, out: list[FuncCall]) -> None:
    """All aggregate FuncCall nodes inside e (dedup by str)."""
    if isinstance(e, FuncCall):
        if e.name in AGG_FUNCS:
            if str(e) not in {str(x) for x in out}:
                out.append(e)
            return
        for a in e.args:
            collect_aggs(a, out)
    elif isinstance(e, BinaryOp):
        collect_aggs(e.left, out)
        collect_aggs(e.right, out)
    elif isinstance(e, UnaryOp):
        collect_aggs(e.operand, out)
    elif isinstance(e, Between):
        collect_aggs(e.expr, out)
    elif isinstance(e, Cast):
        collect_aggs(e.expr, out)
    elif isinstance(e, Case):
        for c, v in e.whens:
            collect_aggs(c, out)
            collect_aggs(v, out)
        if e.else_ is not None:
            collect_aggs(e.else_, out)


# ---------------------------------------------------------------------------
# Host scalar function families (reference src/common/function: json, ip,
# string helpers). These evaluate over result columns (projections, HAVING),
# keeping string work off the device by design.
# ---------------------------------------------------------------------------

def _json_path_get(doc: str, path: str, default=None):
    """Walk a $.a.b[0] path; returns ``default`` when the path is ABSENT
    (a present JSON null returns None, which callers may treat distinctly)."""
    import json as _json

    try:
        cur = _json.loads(doc) if isinstance(doc, str) else doc
    except (TypeError, _json.JSONDecodeError):
        return default
    for part in str(path).lstrip("$").strip(".").split("."):
        if not part:
            continue
        name, _, idx = part.partition("[")
        if name:
            if not isinstance(cur, dict) or name not in cur:
                return default
            cur = cur[name]
        while idx:
            i, _, idx = idx.partition("]")
            idx = idx.lstrip("[")
            if not isinstance(cur, list):
                return default
            try:
                cur = cur[int(i)]
            except (ValueError, IndexError):
                return default
    return cur


def _per_row(args, n, fn):
    a0 = args[0]
    rows = a0 if isinstance(a0, np.ndarray) else np.full(n, a0, dtype=object)

    def arg_at(j, i):
        a = args[1 + j]
        return a[i] if isinstance(a, np.ndarray) else a

    return np.array(
        [fn(rows[i], *[arg_at(j, i) for j in range(len(args) - 1)])
         for i in range(len(rows))],
        dtype=object,
    )


_JSON_MISSING = object()  # distinguishes "path absent" from JSON null


def _json_get(cast):
    def fn(args, n):
        def one(doc, path="$"):
            v = _json_path_get(doc, path, default=_JSON_MISSING)
            if v is _JSON_MISSING or v is None:
                return None
            try:
                return cast(v)
            except (TypeError, ValueError):
                return None
        return _per_row(args, n, one)
    return fn


def _json_as_text(v):
    """JSON-serialize nested values (not Python repr)."""
    import json as _json

    if isinstance(v, (dict, list)):
        return _json.dumps(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _ipv4_num_to_string(args, n):
    def one(v):
        try:
            x = int(v)
        except (TypeError, ValueError):
            return None
        return ".".join(str((x >> s) & 0xFF) for s in (24, 16, 8, 0))
    return _per_row(args, n, one)


def _ipv4_string_to_num(args, n):
    def one(v):
        try:
            parts = [int(p) for p in str(v).split(".")]
            if len(parts) != 4 or any(p < 0 or p > 255 for p in parts):
                return None
            return (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
        except (TypeError, ValueError):
            return None
    return _per_row(args, n, one)


def _strict_bool(v):
    if isinstance(v, bool):
        return v
    raise TypeError("not a json boolean")


_HOST_FUNCS = {
    "json_get_string": _json_get(_json_as_text),
    "json_get_int": _json_get(int),
    "json_get_float": _json_get(float),
    "json_get_bool": _json_get(_strict_bool),
    "json_path_exists": lambda args, n: _per_row(
        args, n,
        lambda doc, path="$": _json_path_get(doc, path, _JSON_MISSING)
        is not _JSON_MISSING,
    ),
    "json_is_object": lambda args, n: _per_row(
        args, n, lambda doc: isinstance(_json_path_get(doc, "$"), dict)
    ),
    "ipv4_num_to_string": _ipv4_num_to_string,
    "ipv4_string_to_num": _ipv4_string_to_num,
    "length": lambda args, n: _per_row(
        args, n, lambda v: len(str(v)) if v is not None else None
    ),
    "lower": lambda args, n: _per_row(
        args, n, lambda v: str(v).lower() if v is not None else None
    ),
    "upper": lambda args, n: _per_row(
        args, n, lambda v: str(v).upper() if v is not None else None
    ),
    "trim": lambda args, n: _per_row(
        args, n, lambda v: str(v).strip() if v is not None else None
    ),
    "concat": lambda args, n: _per_row(
        args, n, lambda *vs: "".join("" if v is None else str(v) for v in vs)
    ),
    "substr": lambda args, n: _per_row(args, n, _substr),
    # string tail (reference src/common/function/src/scalars/string/):
    # NULL in ANY argument → NULL out, same convention as _geo_fn — a
    # NULL pattern/length must never stringify to 'None' or raise
    "replace": lambda args, n: _per_row(
        args, n,
        lambda s, a, b: None if _any_null(s, a, b)
        else str(s).replace(str(a), str(b)),
    ),
    "reverse": lambda args, n: _per_row(
        args, n, lambda s: None if s is None else str(s)[::-1]
    ),
    "left": lambda args, n: _per_row(
        args, n,
        lambda s, k: None if _any_null(s, k) else str(s)[: int(k)],
    ),
    # right(s, -k) drops the FIRST k characters (PostgreSQL semantics);
    # str(s)[-int(k):] covers both signs, k=0 is the empty string
    "right": lambda args, n: _per_row(
        args, n,
        lambda s, k: None if _any_null(s, k) else (
            str(s)[-int(k):] if int(k) != 0 else ""),
    ),
    "split_part": lambda args, n: _per_row(args, n, _split_part),
    "strpos": lambda args, n: _per_row(
        args, n,
        lambda s, sub: None if _any_null(s, sub)
        else str(s).find(str(sub)) + 1,
    ),
    "position": lambda args, n: _per_row(
        args, n,
        lambda sub, s: None if _any_null(s, sub)
        else str(s).find(str(sub)) + 1,
    ),
    "lpad": lambda args, n: _per_row(
        args, n, lambda s, k, p=" ": _pad(s, k, p, left=True)
    ),
    "rpad": lambda args, n: _per_row(
        args, n, lambda s, k, p=" ": _pad(s, k, p, left=False)
    ),
    "repeat": lambda args, n: _per_row(
        args, n,
        lambda s, k: None if _any_null(s, k) else str(s) * int(k),
    ),
    "starts_with": lambda args, n: _per_row(
        args, n,
        lambda s, p: None if s is None else str(s).startswith(str(p)),
    ),
    "ends_with": lambda args, n: _per_row(
        args, n,
        lambda s, p: None if s is None else str(s).endswith(str(p)),
    ),
    # NULL handling (reference DataFusion built-ins)
    "coalesce": lambda args, n: _per_row(
        args, n,
        lambda *vs: next((v for v in vs if not _is_null_val(v)), None),
    ),
    "ifnull": lambda args, n: _per_row(
        args, n, lambda v, alt: alt if _is_null_val(v) else v
    ),
    "nvl": lambda args, n: _per_row(
        args, n, lambda v, alt: alt if _is_null_val(v) else v
    ),
    "nullif": lambda args, n: _per_row(
        args, n, lambda a, b: None if a == b else a
    ),
    "greatest": lambda args, n: _per_row(
        args, n,
        lambda *vs: max((v for v in vs if not _is_null_val(v)),
                        default=None),
    ),
    "least": lambda args, n: _per_row(
        args, n,
        lambda *vs: min((v for v in vs if not _is_null_val(v)),
                        default=None),
    ),
}


def _is_null_val(v) -> bool:
    if v is None:
        return True
    try:
        # NaN of ANY float width (np.float32 is not a python float —
        # isinstance(float) checks miss device-f32 NaNs)
        return bool(v != v)
    except Exception:  # noqa: BLE001 — non-comparable: not null
        return False


def _any_null(*vs) -> bool:
    """NULL-in/NULL-out guard for multi-argument string scalars: numeric
    arguments may arrive as float NaN (device columns), string ones as
    None — both are SQL NULL."""
    return any(_is_null_val(v) for v in vs)


def _pad(s, k, p, *, left: bool):
    """lpad/rpad with the full multi-character fill pattern cycled
    (PostgreSQL semantics), truncating to length k."""
    if _any_null(s, k, p):
        return None
    s = str(s)
    k = int(k)
    p = str(p) or " "
    if len(s) >= k:
        return s[:k]
    fill = (p * (k // len(p) + 1))[: k - len(s)]
    return fill + s if left else s + fill


def _split_part(s, delim, idx):
    """split_part(str, delimiter, n) — 1-based; out of range → ''."""
    if s is None:
        return None
    parts = str(s).split(str(delim))
    i = int(idx)
    return parts[i - 1] if 1 <= i <= len(parts) else ""


def _geo_fn(name: str, fn, arity: int):
    """Wrap a geo primitive: wrong arity is a planning error; per-row
    NULL in → NULL out and bad VALUES → NULL (the reference geo
    functions are null-propagating, helpers.rs)."""
    def run(args, n):
        if len(args) != arity:
            raise PlanError(f"{name}() takes {arity} arguments,"
                            f" got {len(args)}")

        def one(*vals):
            if any(v is None for v in vals):
                return None
            try:
                return fn(*vals)
            except (ValueError, IndexError):
                return None
        return _per_row(args, n, one)
    return run


def _hll_count(args, n):
    """hll_count(state) → approximate distinct count (reference
    scalars/hll_count.rs)."""
    from greptimedb_tpu_torch.ops import sketch as sk

    def one(state):
        regs = sk.decode_hll(state)
        return None if regs is None else int(round(sk.hll_estimate(regs)))
    return _per_row(args, n, one)


def _uddsketch_calc(args, n):
    """uddsketch_calc(quantile, state) (reference uddsketch.rs docs)."""
    from greptimedb_tpu_torch.ops import sketch as sk

    if len(args) != 2:
        raise Unsupported("uddsketch_calc(quantile, state)")
    # args may arrive (q, states) with q scalar — normalize to per-row
    q, states = args
    swapped = [states, q]

    def one(state, quantile):
        try:
            return sk.udd_quantile(state, float(quantile))
        except (TypeError, ValueError):
            return None
    return _per_row(swapped, n, one)


_HOST_FUNCS["hll_count"] = _hll_count
_HOST_FUNCS["uddsketch_calc"] = _uddsketch_calc


def _register_geo():
    from greptimedb_tpu_torch.ops import geo as g

    _HOST_FUNCS.update({
        # reference src/common/function/src/scalars/geo/geohash.rs
        "geohash": _geo_fn(
            "geohash", lambda lat, lng, p: g.geohash_encode(
                float(lat), float(lng), int(p)), 3),
        "geohash_neighbours": _geo_fn(
            "geohash_neighbours",
            lambda lat, lng, p: json.dumps(g.geohash_neighbours(
                g.geohash_encode(float(lat), float(lng), int(p)))), 3),
        # wkt.rs + measure.rs
        "wkt_point_from_latlng": _geo_fn(
            "wkt_point_from_latlng",
            lambda lat, lng: f"POINT({float(lng)} {float(lat)})", 2),
        "st_distance": _geo_fn(
            "st_distance",
            lambda a, b: g.euclidean_distance_deg(str(a), str(b)), 2),
        "st_distance_sphere_m": _geo_fn(
            "st_distance_sphere_m",
            lambda a, b: g.haversine_distance_m(str(a), str(b)), 2),
        "st_area": _geo_fn(
            "st_area", lambda a: g.polygon_area_deg2(str(a)), 1),
    })


_register_geo()


def _substr(v, start, ln=None):
    """PostgreSQL substr semantics: 1-based; start <= 0 shifts the window
    (substr('alphabet', 0, 3) = 'al'), never Python negative indexing."""
    if v is None:
        return None
    s = str(v)
    start = int(start)
    begin = start - 1
    if ln is None:
        return s[max(begin, 0):]
    end = begin + int(ln)
    return s[max(begin, 0):max(end, 0)]


class TableContext:
    """Static planning context for one table: schema + tag dictionaries +
    session timezone (naive timestamp literals localize to it)."""

    def __init__(self, schema: Schema, encoders: dict[str, DictionaryEncoder],
                 timezone: str = "UTC"):
        self.schema = schema
        self.encoders = encoders
        self.timezone = timezone
        self._lower = {c.name.lower(): c.name for c in schema}

    def resolve(self, name: str) -> str:
        real = self._lower.get(name.lower())
        if real is None:
            raise ColumnNotFound(name)
        return real

    def is_tag(self, name: str) -> bool:
        return self.schema.column(self.resolve(name)).is_tag

    def is_ts(self, name: str) -> bool:
        return self.schema.column(self.resolve(name)).is_time_index

    def ts_unit_ms_factor(self) -> float:
        unit = self.schema.time_index.dtype.time_unit
        return unit.per_second / 1000.0

    def ts_literal(self, v: object) -> int:
        """Literal compared against the time index → epoch int in ts unit."""
        if isinstance(v, str):
            ms = parse_timestamp_str(v, self.timezone)
            return int(ms * self.ts_unit_ms_factor())
        if isinstance(v, (int, float)):
            return int(v)
        raise PlanError(f"bad timestamp literal {v!r}")


# ---------------------------------------------------------------------------
# Device compiler
# ---------------------------------------------------------------------------

def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _code_set(values, pred) -> np.ndarray:
    """Codes whose dictionary value satisfies pred — over a
    DictionaryEncoder or any plain vocabulary sequence."""
    if isinstance(values, DictionaryEncoder):
        values = values.values()
    return np.array(
        [i for i, v in enumerate(values) if pred(v)], dtype=np.int32
    )


def _code_set_ft(ctx, real: str, values, pred, kind: str,
                 text: str) -> np.ndarray:
    """Fingerprint-prefiltered twin of ``_code_set`` for text predicates:
    when the executor attached a fulltext provider (ctx.fulltext, set
    from the resident FulltextIndexCache) the predicate evaluates only
    on prefilter candidates — and repeats hit the verified-vocabulary
    memo — instead of walking the whole dictionary.  Candidate sets have
    no false negatives and verification runs the SAME ``pred``, so the
    result is the identical int32 code array; any fallback (knob off,
    a table without lineage, the grid path) IS ``_code_set``."""
    if isinstance(values, DictionaryEncoder):
        values = values.values()
    ft = getattr(ctx, "fulltext", None)
    if ft is not None:
        codes = ft.codes_matching(real, values, pred, kind, text)
        if codes is not None:
            return codes
    return _code_set(values, pred)


def _codes_isin_fn(codes: np.ndarray, real: str, negate: bool):
    """The ONE code-set membership closure shared by tag and string-FIELD
    comparisons (negation excludes padding/poison codes < 0)."""

    def fn(env, codes=codes, real=real, negate=negate):
        col = env[real]
        hit = (
            torch.zeros(col.shape, dtype=torch.bool, device=col.device)
            if codes.size == 0
            else torch.isin(col, torch.as_tensor(codes, device=col.device))
        )
        return (~hit & (col >= 0)) if negate else hit

    return fn


def _as_tensor(v, like=None):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=None if like is None else like.device)


_CMP = {
    "=": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
}


def compile_device(e: Expr, ctx: TableContext):
    """Compile to fn(env) -> torch tensor (or Python scalar); env maps
    column name → device tensor.

    Column refs and literals, arithmetic, comparisons, AND/OR/NOT,
    BETWEEN, IS NULL, CASE, IN lists and tuple IN, tag and string-FIELD
    predicates lowered to dictionary code sets (=, !=, IN, LIKE/ILIKE,
    regex; string fields through the resident table's dictionaries,
    ``ctx.table_dicts``, so on the row path only), tag = tag through a
    code translation, time-index comparisons with timestamp literals, and
    the functions of ``compile_device_func`` (full-text ``matches`` /
    ``matches_term`` / ``matches_score`` included).  Vector-search
    functions raise ``Unsupported``.  Tag columns evaluate to their code
    arrays (comparisons are rewritten to code space).
    """
    if isinstance(e, Literal):
        v = e.value
        if v is None:
            return lambda env: float("nan")
        if isinstance(v, bool):
            return lambda env: torch.tensor(v)
        if isinstance(v, str):
            raise PlanError(f"string literal {v!r} outside tag comparison")
        return lambda env: v

    if isinstance(e, IntervalLit):
        ms = e.ms
        factor = ctx.ts_unit_ms_factor()
        return lambda env: int(ms * factor)

    if isinstance(e, Column):
        real = ctx.resolve(e.name)
        return lambda env: env[real]

    if isinstance(e, Cast):
        inner = compile_device(e.expr, ctx)
        tn = e.type_name.upper()
        if "INT" in tn:
            return lambda env: _as_tensor(inner(env)).to(torch.int64)
        return lambda env: _as_tensor(inner(env)).to(torch.float32)

    if isinstance(e, UnaryOp):
        inner = compile_device(e.operand, ctx)
        if e.op == "NOT":
            return lambda env: ~_as_tensor(inner(env))
        if e.op == "-":
            return lambda env: -inner(env)
        raise Unsupported(f"unary {e.op}")

    if isinstance(e, IsNull):
        if isinstance(e.expr, Column):
            real = ctx.resolve(e.expr.name)
            col = ctx.schema.column(real)
            if col.is_tag:
                fn = lambda env: env[real] < 0  # noqa: E731
            elif col.dtype.is_float:
                fn = lambda env: torch.isnan(env[real])  # noqa: E731
            else:
                fn = lambda env: torch.zeros(  # noqa: E731
                    env[real].shape, dtype=torch.bool,
                    device=env[real].device)
        else:
            inner = compile_device(e.expr, ctx)
            fn = lambda env: torch.isnan(  # noqa: E731
                _as_tensor(inner(env)).to(torch.float32))
        if e.negated:
            pos = fn
            return lambda env: ~pos(env)
        return fn

    if isinstance(e, Between):
        lo = BinaryOp(">=", e.expr, e.low)
        hi = BinaryOp("<=", e.expr, e.high)
        node = BinaryOp("AND", lo, hi)
        if e.negated:
            node = UnaryOp("NOT", node)
        return compile_device(node, ctx)

    if isinstance(e, InList):
        if isinstance(e.expr, Column) and ctx.is_tag(e.expr.name):
            real = ctx.resolve(e.expr.name)
            enc = ctx.encoders[real]
            values = []
            for item in e.items:
                if not isinstance(item, Literal):
                    raise Unsupported("non-literal IN item on tag")
                values.append(item.value)
            codes = np.array(
                sorted(c for c in (enc.get(v) for v in values) if c >= 0),
                dtype=np.int32,
            )
            neg = e.negated

            def fn(env, codes=codes, real=real, neg=neg):
                col = env[real]
                hit = (
                    torch.zeros(col.shape, dtype=torch.bool,
                                device=col.device)
                    if codes.size == 0
                    else torch.isin(col, torch.as_tensor(codes,
                                                         device=col.device))
                )
                return ~hit if neg else hit

            return fn
        # numeric IN list
        inner = compile_device(e.expr, ctx)
        lits = []
        for item in e.items:
            if not isinstance(item, Literal):
                raise Unsupported("non-literal IN item")
            lits.append(item.value)
        arr = np.asarray(lits)
        neg = e.negated

        def fn(env, inner=inner, arr=arr, neg=neg):
            v = _as_tensor(inner(env))
            hit = torch.isin(v, torch.as_tensor(arr, device=v.device))
            return ~hit if neg else hit

        return fn

    if isinstance(e, TupleIn):
        return _compile_tuple_in(e, ctx)

    if isinstance(e, Case):
        if e.operand is not None:
            whens = tuple(
                (BinaryOp("=", e.operand, c), v) for c, v in e.whens
            )
        else:
            whens = e.whens
        conds = [compile_device(c, ctx) for c, _ in whens]
        vals = [compile_device(v, ctx) for _, v in whens]
        els = compile_device(e.else_, ctx) if e.else_ is not None else None

        def case_fn(env):
            out = els(env) if els is not None else float("nan")
            for c, v in zip(reversed(conds), reversed(vals)):
                out = torch.where(_as_tensor(c(env)), v(env), out)
            return out

        return case_fn

    if isinstance(e, BinaryOp):
        op = e.op.upper()
        # --- tag-column string semantics resolved at compile time ---
        tag_side = None
        if isinstance(e.left, Column) and ctx.is_tag(e.left.name):
            tag_side, other = e.left, e.right
        elif (isinstance(e.right, Column) and ctx.is_tag(e.right.name)
              and op in ("=", "!=", "<>")):
            # only COMMUTATIVE comparisons may take the tag from the
            # right side: 'x%' LIKE tag means each tag value is the
            # PATTERN — silently compiling it as tag LIKE 'x%' would
            # swap subject and pattern
            tag_side, other = e.right, e.left
        if tag_side is not None and op in ("=", "!=", "LIKE", "ILIKE", "~", "!~"):
            real = ctx.resolve(tag_side.name)
            enc = ctx.encoders[real]
            if isinstance(other, Literal) and isinstance(other.value, str):
                if op in ("=", "!="):
                    code = enc.get(other.value)
                    if op == "=":
                        return lambda env: env[real] == code
                    return lambda env: (env[real] != code) & (env[real] >= 0)
                if op in ("LIKE", "ILIKE"):
                    rx = re.compile(
                        _like_to_regex(other.value),
                        re.IGNORECASE if op == "ILIKE" else 0,
                    )
                    codes = _code_set_ft(
                        ctx, real, enc,
                        lambda v: rx.match(str(v)) is not None,
                        "ilike" if op == "ILIKE" else "like", other.value)
                else:  # ~ / !~ regex
                    rx = re.compile(other.value)
                    codes = _code_set_ft(
                        ctx, real, enc,
                        lambda v: rx.search(str(v)) is not None,
                        "regex", other.value)
                return _codes_isin_fn(codes, real, op == "!~")
            if isinstance(other, Column) and ctx.is_tag(other.name):
                # tag = tag is sound only through one dictionary: translate
                # the left codes into the right column's code space
                r1 = ctx.resolve(tag_side.name)
                r2 = ctx.resolve(other.name)
                e1, e2 = ctx.encoders[r1], ctx.encoders[r2]
                trans = np.array([e2.get(v) for v in e1.values()],
                                 dtype=np.int32)

                def tag_eq(env, trans=trans, r1=r1, r2=r2, eq=(op == "=")):
                    c1 = env[r1]
                    if trans.shape[0]:
                        t = torch.as_tensor(trans, device=c1.device)
                        mapped = torch.where(
                            (c1 >= 0) & (c1 < t.shape[0]),
                            t[torch.clamp(c1, 0, t.shape[0] - 1)], -2)
                    else:
                        mapped = torch.full(c1.shape, -2, dtype=torch.int32,
                                            device=c1.device)
                    res = mapped == env[r2]
                    return res if eq else ~res

                return tag_eq
        # --- dictionary-encoded string FIELD comparisons -------------
        # string fields ride the DeviceTable's ad-hoc dictionaries
        # (table_dicts, set by the row-path executor); =/!=/LIKE/regex
        # lower to code-set membership exactly like tags
        if tag_side is None and op in ("=", "!=", "LIKE", "ILIKE",
                                       "~", "!~"):
            # LIKE/regex are not commutative: only col OP literal; =/!=
            # match either side
            if op in ("=", "!="):
                pairs = ((e.left, e.right), (e.right, e.left))
            else:
                pairs = ((e.left, e.right),)
            field_side = other_f = None
            for side, oth in pairs:
                if (isinstance(side, Column)
                        and isinstance(oth, Literal)
                        and isinstance(oth.value, str)
                        and not ctx.is_tag(side.name)):
                    try:
                        cs = ctx.schema.column(ctx.resolve(side.name))
                    except Exception:  # noqa: BLE001
                        cs = None
                    if cs is not None and cs.dtype.is_string_like:
                        field_side, other_f = side, oth
                        break
            if field_side is not None:
                real = ctx.resolve(field_side.name)
                vocab = getattr(ctx, "table_dicts", {}).get(real)
                if vocab is None:
                    raise Unsupported(
                        f"string field {real}: comparison needs the "
                        "resident dictionary (row path only)")
                if op in ("=", "!="):
                    pred = lambda v, w=other_f.value: str(v) == w  # noqa: E731
                    kind = "eq"
                elif op in ("LIKE", "ILIKE"):
                    rx = re.compile(
                        _like_to_regex(other_f.value),
                        re.IGNORECASE if op == "ILIKE" else 0)
                    pred = lambda v, rx=rx: rx.match(str(v)) is not None  # noqa: E731
                    kind = "ilike" if op == "ILIKE" else "like"
                else:
                    rx = re.compile(other_f.value)
                    pred = lambda v, rx=rx: rx.search(str(v)) is not None  # noqa: E731
                    kind = "regex"
                return _codes_isin_fn(
                    _code_set_ft(ctx, real, vocab, pred, kind,
                                 other_f.value),
                    real, op in ("!=", "!~"))
        # --- time-index comparisons with string timestamps ---
        ts_side = None
        if isinstance(e.left, Column) and ctx.is_ts(e.left.name):
            ts_side, other, flipped = e.left, e.right, False
        elif isinstance(e.right, Column) and ctx.is_ts(e.right.name):
            ts_side, other, flipped = e.right, e.left, True
        if (
            ts_side is not None
            and isinstance(other, Literal)
            and op in _CMP
        ):
            real = ctx.resolve(ts_side.name)
            lit = ctx.ts_literal(other.value)
            cmp = _CMP[op]
            if flipped:
                return lambda env: cmp(lit, env[real])
            return lambda env: cmp(env[real], lit)

        if op in ("AND", "OR"):
            l = compile_device(e.left, ctx)
            r = compile_device(e.right, ctx)
            if op == "AND":
                return lambda env: _as_tensor(l(env)) & _as_tensor(r(env))
            return lambda env: _as_tensor(l(env)) | _as_tensor(r(env))

        l = compile_device(e.left, ctx)
        r = compile_device(e.right, ctx)
        table = {
            "+": lambda a, b: a + b,
            "-": lambda a, b: a - b,
            "*": lambda a, b: a * b,
            "/": lambda a, b: a / b,
            "%": lambda a, b: a % b,  # floor modulo, as jnp's
            **_CMP,
        }
        if op not in table:
            raise Unsupported(f"operator {op} on device")
        f = table[op]
        return lambda env: f(l(env), r(env))

    if isinstance(e, FuncCall):
        return compile_device_func(e, ctx)

    raise Unsupported(f"cannot compile {type(e).__name__} for device")


def _compile_tuple_in(e: TupleIn, ctx: TableContext):
    """Row-tuple membership on device, O((n + T)·log T): factorize each key
    column against the tuples' per-column distinct values with
    searchsorted (tag literals become dictionary codes — absent literals
    can never match), combine the positions into one int64 code, and probe
    the sorted tuple-code table."""
    k = len(e.exprs)
    if k == 0 or not e.rows:
        neg = e.negated
        return lambda env: torch.full(
            next(iter(env.values())).shape, bool(neg),
            device=next(iter(env.values())).device)

    col_fns = []
    col_vals: list[np.ndarray] = []
    for i, x in enumerate(e.exprs):
        vals = [r[i] for r in e.rows]
        if isinstance(x, Column) and ctx.is_tag(x.name):
            real = ctx.resolve(x.name)
            enc = ctx.encoders[real]
            arr = np.array([enc.get(v) for v in vals], dtype=np.int64)
            col_fns.append(
                lambda env, real=real: env[real].to(torch.int64))
        else:
            # native-dtype comparison: int-typed columns (incl. timestamps)
            # compare in exact int64, never through a float downcast
            int_col = False
            if isinstance(x, Column):
                try:
                    cs = ctx.schema.column(ctx.resolve(x.name))
                    int_col = not (cs.is_tag or cs.dtype.is_float
                                   or cs.dtype.is_string_like)
                except Exception:  # noqa: BLE001 — unknown: float compare
                    pass
            f = compile_device(x, ctx)
            try:
                if int_col and all(
                        float(v).is_integer() if isinstance(v, float)
                        else True for v in vals):
                    arr = np.array([int(v) for v in vals], dtype=np.int64)
                    col_fns.append(
                        lambda env, f=f: _as_tensor(f(env)).to(torch.int64))
                else:
                    arr = np.array([float(v) for v in vals],
                                   dtype=np.float64)
                    col_fns.append(
                        lambda env, f=f: _as_tensor(f(env)).to(
                            torch.float64))
            except (TypeError, ValueError):
                raise Unsupported(
                    "tuple IN: non-numeric values on a non-tag column")
        col_vals.append(arr)

    uniqs, invs = [], []
    prod = 1
    for arr in col_vals:
        u, inv = np.unique(arr, return_inverse=True)
        uniqs.append(u)
        invs.append(inv.astype(np.int64))
        prod *= max(len(u), 1)
    if prod >= (1 << 62):
        raise Unsupported("tuple IN: combined key space too large")
    comb = np.zeros(len(e.rows), dtype=np.int64)
    for u, inv in zip(uniqs, invs):
        comb = comb * len(u) + inv
    tcodes = np.unique(comb)
    neg = e.negated

    def fn(env):
        ok = None
        code = None
        for u, f in zip(uniqs, col_fns):
            v = f(env)
            ua = torch.as_tensor(u, device=v.device)
            posc = torch.clamp(torch.searchsorted(ua, v), 0, len(u) - 1)
            found = ua[posc] == v
            ok = found if ok is None else (ok & found)
            code = posc if code is None else code * len(u) + posc
        tc = torch.as_tensor(tcodes, device=code.device)
        p = torch.clamp(torch.searchsorted(tc, code), 0, len(tcodes) - 1)
        hit = ok & (tc[p] == code)
        return ~hit if neg else hit

    return fn


VEC_FUNCS = ("vec_cos_distance", "vec_l2sq_distance", "vec_dot_product")


def _parse_vec(text: str) -> "np.ndarray | None":
    import numpy as _np

    t = text.strip()
    if not (t.startswith("[") and t.endswith("]")):
        return None
    try:
        return _np.asarray(
            [float(x) for x in t[1:-1].split(",") if x.strip()],
            dtype=_np.float32,
        )
    except ValueError:
        return None


def _vocab_distances_device(name: str, terms: list, q: "np.ndarray",
                            device) -> torch.Tensor:
    """Distances from q to every DISTINCT vector term, as f32 on
    ``device`` (NaN for terms that do not parse to q's width): a host
    parse into a ``[D, dim]`` matrix, then the ``vec_distance`` kernel
    (K22).

    Scale guard: exact brute force is the right call up to ~1M DISTINCT
    vectors; past that the distance matrix and per-query latency grow
    without bound, so it fails loudly instead of degrading silently.
    Guarded HERE so every path (device compile, host projection, raw-scan
    ORDER BY) shares the bound."""
    import os as _os

    from greptimedb_tpu_torch.ops.vector_kernels import vec_distance

    if device is None:
        raise ExecutionError(f"{name}: no device to compute distances on")
    limit = int(_os.environ.get("GREPTIME_VECTOR_MAX_DISTINCT", 1 << 20))
    if len(terms) > limit:
        raise ResourcesExhausted(
            f"{name}: {len(terms)} distinct vectors exceeds the exact-"
            f"search bound {limit} (raise GREPTIME_VECTOR_MAX_DISTINCT, "
            "or pre-filter with WHERE to shrink the candidate set)")
    mat = np.zeros((max(len(terms), 1), q.shape[0]), dtype=np.float32)
    valid = np.zeros(max(len(terms), 1), dtype=bool)
    for i, term in enumerate(terms):
        v = _parse_vec(str(term)) if term is not None else None
        if v is not None and v.shape == q.shape:
            mat[i] = v
            valid[i] = True
    dev = torch.device(device)
    return vec_distance(torch.from_numpy(mat).to(dev),
                        torch.from_numpy(valid).to(dev),
                        torch.from_numpy(q).to(dev), name)


def _vocab_distances(name: str, terms: list, q: "np.ndarray",
                     device) -> "np.ndarray":
    """``_vocab_distances_device`` as f64 numpy: the host evaluator's
    per-term distances, NaN for invalid terms."""
    d = _vocab_distances_device(name, terms, q, device)
    return d.cpu().numpy().astype(np.float64)


def _compile_vec_distance(e: FuncCall, ctx: TableContext):
    """Exact vector search with NO index structure: the distance from the
    query to every DISTINCT vector of the table's dictionary, computed
    once per call on the table's device (the ``vec_distance`` kernel),
    then gathered to rows by code; code -1 (padding, a NULL) gives NaN."""
    args = list(e.args)
    if len(args) != 2:
        raise PlanError(f"{e.name}(column, '[...]') takes two arguments")
    col = next((a for a in args if isinstance(a, Column)), None)
    lit = next((a for a in args if isinstance(a, Literal)), None)
    if col is None or lit is None or not isinstance(lit.value, str):
        raise Unsupported(f"{e.name} needs a vector column and a literal")
    real = ctx.resolve(col.name)
    if ctx.schema.column(real).dtype is not ConcreteDataType.VECTOR:
        raise PlanError(f"{e.name}: {col.name} is not a VECTOR column")
    vocab = getattr(ctx, "table_dicts", {}).get(real)
    if vocab is None:
        raise Unsupported(f"{e.name}: vector column not resident")
    q = _parse_vec(lit.value)
    if q is None:
        raise PlanError(f"{e.name}: bad vector literal {lit.value!r}")

    def fn(env, col_name=real):
        codes = env[col_name]
        # on the table's device: where its codes lie
        dist = _vocab_distances_device(e.name, vocab, q, codes.device)
        safe = torch.clamp(codes, 0, dist.shape[0] - 1).to(torch.int64)
        return torch.where(codes >= 0, dist[safe], float("nan"))

    return fn


FT_FUNCS = ("matches", "matches_term", "matches_score")


def _ft_pred(name: str, query: str):
    from greptimedb_tpu_torch.storage.index import ft_predicate

    return ft_predicate(name, query)


def _compile_ft_match(e: FuncCall, ctx: TableContext):
    """Full-text match over a string column: the predicate evaluates once
    per DISTINCT term (dictionary vocabulary; prefiltered by the resident
    fingerprint index when ctx.fulltext is set), then gathers to rows by
    code on the device — same shape as the inverted-index matcher path."""
    args = list(e.args)
    if len(args) != 2:
        raise PlanError(f"{e.name}(column, 'query') takes two arguments")
    col = next((a for a in args if isinstance(a, Column)), None)
    lit = next((a for a in args if isinstance(a, Literal)), None)
    if col is None or lit is None or not isinstance(lit.value, str):
        raise Unsupported(f"{e.name} needs a string column and a literal")
    real = ctx.resolve(col.name)
    vocab = getattr(ctx, "table_dicts", {}).get(real)
    if vocab is None:
        enc = ctx.encoders.get(real)  # tag column: region dictionary
        if enc is None:
            raise Unsupported(f"{e.name}: column {col.name} has no dictionary")
        vocab = enc.values()
    if e.name == "matches_score":
        # TF-IDF relevance: the shared corpus scorer over the dictionary
        # vocabulary, gathered to rows by code
        from greptimedb_tpu_torch.storage.index import ft_score_corpus

        sc = ft_score_corpus(lit.value, list(vocab))

        def score_fn(env, col_name=real, sc=sc):
            codes = env[col_name]
            s = torch.as_tensor(sc, device=codes.device)
            if s.numel() == 0:  # no rows: every code is padding
                return torch.zeros(codes.shape, dtype=s.dtype,
                                   device=codes.device)
            safe = torch.clamp(codes, 0, s.shape[0] - 1).to(torch.int64)
            return torch.where(codes >= 0, s[safe], 0.0)

        return score_fn

    pred = _ft_pred(e.name, lit.value)
    if isinstance(vocab, DictionaryEncoder):
        vocab = vocab.values()
    if not isinstance(vocab, list):
        vocab = list(vocab)  # a resident dictionary is a list already
    ft = getattr(ctx, "fulltext", None)
    bools = None
    if ft is not None:
        # fingerprint prefilter: the token predicate runs only on
        # candidate terms (memoized per lineage) instead of every
        # distinct value
        bools = ft.cache.verified_bools(
            ft.tkey, ft.table, real, vocab,
            lambda t, p=pred: bool(p(str(t))), e.name, lit.value)
    if bools is None:
        bools = np.asarray([bool(pred(str(t))) for t in vocab], dtype=bool)

    def fn(env, col_name=real, bools=bools):
        codes = env[col_name]
        h = torch.as_tensor(bools, device=codes.device)
        if h.numel() == 0:  # no rows: every code is padding
            return torch.zeros(codes.shape, dtype=torch.bool,
                               device=codes.device)
        safe = torch.clamp(codes, 0, h.shape[0] - 1).to(torch.int64)
        return torch.where(codes >= 0, h[safe], False)

    return fn


def _to_ms(ts, factor: float):
    """Native-unit timestamps → ms (float64 then truncate, as the
    reference's x64 arithmetic)."""
    if factor == 1.0:
        return ts
    return (ts.to(torch.float64) / factor).to(torch.int64)


def _from_ms(ms, factor: float):
    if factor == 1.0:
        return ms
    return (ms.to(torch.float64) * factor).to(torch.int64)


def compile_device_func(e: FuncCall, ctx: TableContext):
    name = e.name
    if name in AGG_FUNCS:
        raise PlanError(f"aggregate {name} in scalar context")
    if name == "date_bin":
        if len(e.args) < 2:
            raise PlanError("date_bin(interval, ts)")
        iv = e.args[0]
        if isinstance(iv, Literal) and isinstance(iv.value, str):
            # date_bin('1 minute', ts): string spelling of the interval
            from greptimedb_tpu_torch.query.parser import parse_interval_str

            iv = IntervalLit(parse_interval_str(iv.value), iv.value)
        if not isinstance(iv, IntervalLit):
            raise Unsupported("date_bin needs interval literal")
        step = int(iv.ms * ctx.ts_unit_ms_factor())
        inner = compile_device(e.args[1], ctx)
        origin = 0
        if len(e.args) > 2 and isinstance(e.args[2], Literal):
            origin = ctx.ts_literal(e.args[2].value)
        return lambda env: time_bucket(inner(env), step, origin)
    if name == "date_trunc":
        unit = e.args[0]
        if not isinstance(unit, Literal):
            raise Unsupported("date_trunc needs unit literal")
        inner = compile_device(e.args[1], ctx)
        factor = ctx.ts_unit_ms_factor()
        u = str(unit.value)

        def fn(env):
            return _from_ms(date_trunc_bucket(_to_ms(inner(env), factor), u),
                            factor)

        return fn
    if name in VEC_FUNCS:
        return _compile_vec_distance(e, ctx)
    if name in FT_FUNCS:
        return _compile_ft_match(e, ctx)
    if name == "abs":
        inner = compile_device(e.args[0], ctx)
        return lambda env: torch.abs(_as_tensor(inner(env)))
    if name in _MATH:
        inner = compile_device(e.args[0], ctx)
        f = _MATH[name]
        return lambda env: f(_as_tensor(inner(env)))
    if name == "clamp":
        a = compile_device(e.args[0], ctx)
        lo = compile_device(e.args[1], ctx)
        hi = compile_device(e.args[2], ctx)
        return lambda env: torch.clamp(_as_tensor(a(env)), lo(env), hi(env))
    if name in ("power", "pow"):
        a = compile_device(e.args[0], ctx)
        b = compile_device(e.args[1], ctx)
        return lambda env: torch.pow(
            _as_tensor(a(env)).to(torch.float64), b(env))
    if name == "coalesce":
        parts = [compile_device(a, ctx) for a in e.args]

        def coalesce(env):
            out = parts[-1](env)
            for p in reversed(parts[:-1]):
                v = _as_tensor(p(env))
                out = torch.where(torch.isnan(v), out, v)
            return out

        return coalesce
    if name == "to_unixtime":
        inner = compile_device(e.args[0], ctx)
        factor = ctx.ts_unit_ms_factor() * 1000.0
        # in float64: torch computes int64 / float in float32, which on
        # epoch timestamps loses whole minutes
        return lambda env: (_as_tensor(inner(env)).to(torch.float64)
                            / factor).to(torch.int64)
    if name in ("date_part", "datepart"):
        if len(e.args) != 2 or not isinstance(e.args[0], Literal):
            raise PlanError("date_part(unit, ts)")
        part = str(e.args[0].value).lower()
        inner = compile_device(e.args[1], ctx)
        factor = ctx.ts_unit_ms_factor()
        try:
            date_part_of(torch.zeros(1, dtype=torch.int64), part)
        except ValueError as exc:
            raise Unsupported(str(exc))
        return lambda env: date_part_of(_to_ms(inner(env), factor), part)
    if name == "now":
        import time as _time

        v = int(_time.time() * 1000 * ctx.ts_unit_ms_factor())
        return lambda env: v
    raise Unsupported(f"device function {name}")


_MATH = {
    "ln": torch.log, "log": torch.log10, "log2": torch.log2,
    "log10": torch.log10, "sqrt": torch.sqrt, "exp": torch.exp,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
}


# ---------------------------------------------------------------------------
# Host evaluator (post-aggregation shaping; numpy over small columns)
# ---------------------------------------------------------------------------

def eval_host(e: Expr, env: dict[str, np.ndarray], n: int):
    """Evaluate over host columns; env keys are output column names."""
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, IntervalLit):
        return e.ms
    if isinstance(e, Column):
        for k in (str(e), e.name):
            if k in env:
                return env[k]
        lower = {k.lower(): k for k in env}
        if e.name.lower() in lower:
            return env[lower[e.name.lower()]]
        raise ColumnNotFound(e.name)
    if isinstance(e, WindowFunc):
        key = str(e)
        if key in env:
            return env[key]
        raise PlanError(f"window function outside SELECT items: {key}")
    if isinstance(e, FuncCall):
        key = str(e)
        if key in env:
            return env[key]
        if e.name in AGG_FUNCS:
            raise ColumnNotFound(key)
        args = [eval_host(a, env, n) for a in e.args]
        table = {
            "abs": np.abs, "sqrt": np.sqrt, "ln": np.log, "log10": np.log10,
            "log2": np.log2, "exp": np.exp, "floor": np.floor,
            "ceil": np.ceil, "round": np.round,
        }
        if e.name in table:
            return table[e.name](np.asarray(args[0], dtype=float))
        if e.name in ("power", "pow"):
            return np.power(np.asarray(args[0], dtype=float),
                            np.asarray(args[1], dtype=float))
        if e.name == "clamp":
            return np.clip(np.asarray(args[0], dtype=float),
                           np.asarray(args[1], dtype=float),
                           np.asarray(args[2], dtype=float))
        if e.name in _HOST_FUNCS:
            return _HOST_FUNCS[e.name](args, n)
        if e.name in FT_FUNCS:
            col = next((a for a in e.args if isinstance(a, Column)), None)
            lit = next((a for a in e.args if isinstance(a, Literal)), None)
            if col is None or lit is None or not isinstance(lit.value, str):
                raise Unsupported(f"{e.name} needs a column and a literal")
            vals = np.asarray(eval_host(col, env, n), dtype=object)
            uniq, inv = np.unique(
                np.array(["" if v is None else str(v) for v in vals],
                         dtype=object),
                return_inverse=True,
            )
            if e.name == "matches_score":
                from greptimedb_tpu_torch.storage.index import ft_score_corpus

                return ft_score_corpus(lit.value, list(uniq))[inv]
            pred = _ft_pred(e.name, lit.value)
            hits = np.asarray([pred(str(u)) for u in uniq], dtype=bool)
            return hits[inv]
        if e.name in VEC_FUNCS:
            # raw-scan projection: distances over DISTINCT vectors on the
            # executor's device (the engine passes it as __device__);
            # per-row values gather host-side
            col = next((a for a in e.args if isinstance(a, Column)), None)
            lit = next((a for a in e.args if isinstance(a, Literal)), None)
            if col is None or lit is None or not isinstance(lit.value, str):
                raise Unsupported(f"{e.name} needs a column and a literal")
            q = _parse_vec(lit.value)
            if q is None:
                raise PlanError(f"{e.name}: bad vector literal")
            vals = np.asarray(eval_host(col, env, n), dtype=object)
            uniq, inv = np.unique(
                np.array(["" if v is None else str(v) for v in vals],
                         dtype=object),
                return_inverse=True,
            )
            dists = _vocab_distances(e.name, list(uniq), q,
                                     env.get("__device__"))
            return dists[inv]
        if e.name in ("date_trunc", "date_part", "datepart", "to_unixtime",
                      "date_format"):
            # the engine stashes the table's ts-unit factor in env so
            # host date functions see epoch values in a known unit
            from greptimedb_tpu_torch.ops.time import (
                date_part_of, date_trunc_bucket,
            )

            factor = float(env.get("__ts_factor__", 1.0))
            tsarg = args[1] if e.name in ("date_trunc", "date_part",
                                          "datepart") else args[0]
            ts = np.asarray(tsarg, dtype=np.int64)
            ms = (ts / factor).astype(np.int64) if factor != 1.0 else ts
            if e.name == "to_unixtime":
                return ms // 1000
            if e.name == "date_trunc":
                try:
                    out = date_trunc_bucket(ms, str(args[0]))
                except ValueError as exc:
                    raise Unsupported(str(exc))
                out = np.asarray(out, dtype=np.int64)
                return ((out * factor).astype(np.int64)
                        if factor != 1.0 else out)
            if e.name in ("date_part", "datepart"):
                try:
                    return np.asarray(date_part_of(ms, str(args[0])))
                except ValueError as exc:
                    raise Unsupported(str(exc))
            # date_format(ts, fmt): chrono-style strftime per row
            import datetime as _dt

            fmt = str(args[1])
            return np.array([
                _dt.datetime.fromtimestamp(
                    v / 1000.0, _dt.timezone.utc).strftime(fmt)
                for v in ms.tolist()
            ], dtype=object)
        raise Unsupported(f"host function {e.name}")
    if isinstance(e, UnaryOp):
        v = eval_host(e.operand, env, n)
        if e.op == "NOT":
            return ~np.asarray(v, dtype=bool)
        return -np.asarray(v)
    if isinstance(e, BinaryOp):
        key = str(e)
        if key in env:
            return env[key]
        l = eval_host(e.left, env, n)
        r = eval_host(e.right, env, n)
        op = e.op.upper()
        if op in ("AND", "OR"):
            l = np.asarray(l, dtype=bool)
            r = np.asarray(r, dtype=bool)
            return (l & r) if op == "AND" else (l | r)
        if op in ("LIKE", "ILIKE"):
            rx = re.compile(
                _like_to_regex(str(r)), re.IGNORECASE if op == "ILIKE" else 0
            )
            return np.array([rx.match(str(x)) is not None for x in np.atleast_1d(l)])
        table = {
            "+": np.add, "-": np.subtract, "*": np.multiply,
            "/": np.divide, "%": np.mod,
            "=": np.equal, "!=": np.not_equal, "<": np.less,
            "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
        }
        if op not in table:
            raise Unsupported(f"host operator {op}")
        return table[op](l, r)
    if isinstance(e, Between):
        v = eval_host(e.expr, env, n)
        lo = eval_host(e.low, env, n)
        hi = eval_host(e.high, env, n)
        res = (np.asarray(v) >= lo) & (np.asarray(v) <= hi)
        return ~res if e.negated else res
    if isinstance(e, InList):
        v = np.asarray(eval_host(e.expr, env, n))
        items = [eval_host(i, env, n) for i in e.items]
        res = np.isin(v, np.asarray(items, dtype=v.dtype if v.dtype != object else object))
        return ~res if e.negated else res
    from greptimedb_tpu_torch.query.ast import TupleIn as _TupleIn

    if isinstance(e, _TupleIn):
        arrs = []
        for x in e.exprs:
            a = np.asarray(eval_host(x, env, n), dtype=object)
            if a.ndim == 0:
                a = np.full(n, a.item(), dtype=object)
            arrs.append(a)
        want = set(e.rows)
        res = np.fromiter(
            (t in want for t in zip(*arrs)), dtype=bool, count=n)
        return ~res if e.negated else res
    if isinstance(e, IsNull):
        v = eval_host(e.expr, env, n)
        arr = np.asarray(v)
        if arr.dtype == object:
            res = np.array([x is None for x in arr])
        elif np.issubdtype(arr.dtype, np.floating):
            res = np.isnan(arr)
        else:
            res = np.zeros(arr.shape, bool)
        return ~res if e.negated else res
    if isinstance(e, Case):
        if e.operand is not None:
            whens = tuple((BinaryOp("=", e.operand, c), v) for c, v in e.whens)
        else:
            whens = e.whens
        out = np.full(n, None, dtype=object) if e.else_ is None else np.broadcast_to(
            np.asarray(eval_host(e.else_, env, n), dtype=object), (n,)
        ).copy()
        done = np.zeros(n, dtype=bool)
        for c, v in whens:
            cond = np.asarray(eval_host(c, env, n), dtype=bool)
            cond = np.broadcast_to(cond, (n,))
            val = eval_host(v, env, n)
            val = np.broadcast_to(np.asarray(val, dtype=object), (n,))
            pick = cond & ~done
            out[pick] = val[pick]
            done |= cond
        return out
    if isinstance(e, Cast):
        from greptimedb_tpu_torch.errors import ExecutionError

        v = eval_host(e.expr, env, n)
        tn = e.type_name.upper()
        try:
            if "INT" in tn:
                arr = np.asarray(v)
                if arr.dtype.kind in ("i", "u"):
                    return arr.astype(np.int64)  # exact, no f64 detour
                # strings/floats: float parse then truncate ('1.9' → 1);
                # big int64s never take this path (review regression:
                # f64 corrupts ints above 2^53)
                return arr.astype(np.float64).astype(np.int64)
            if "DOUBLE" in tn or "FLOAT" in tn or "REAL" in tn:
                return np.asarray(v).astype(np.float64)
        except ValueError as exc:
            # bad literal → coded error, not a bare python ValueError
            raise ExecutionError(f"cast to {e.type_name}: {exc}")
        if "STRING" in tn or "VARCHAR" in tn or "TEXT" in tn:
            return np.asarray([str(x) for x in np.atleast_1d(np.asarray(v, dtype=object))], dtype=object)
        raise Unsupported(f"host cast to {e.type_name}")
    raise Unsupported(f"host eval {type(e).__name__}")
