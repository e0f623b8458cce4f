"""Recursive-descent SQL parser (reference: sqlparser-rs + src/sql crate).

Expression parsing is precedence-climbing; statements dispatch on the
leading keyword. TQL statements capture the trailing PromQL text verbatim
for the promql front-end (reference src/sql/src/statements/tql.rs).
"""

from __future__ import annotations

import datetime

from greptimedb_tpu_torch.errors import SyntaxError_, Unsupported
from greptimedb_tpu_torch.query.ast import (
    AlterTable, CreateView, DropView, Between, Exists, BinaryOp, Case, Cast, Column, ColumnDef, CreateDatabase,
    CreateFlow, CreateTable, Delete, DescribeTable, DropDatabase, DropFlow,
    DropTable, Explain, Expr, FuncCall, InList, InSubquery, Insert,
    IntervalLit, IsNull, JoinClause, ScalarSubquery,
    Literal, OrderByItem, Select, SelectItem, ShowCreateTable, ShowDatabases,
    ShowFlows, ShowTables, Star, Statement, Tql, TruncateTable, UnaryOp, Union,
    Use,
)
from greptimedb_tpu_torch.query.lexer import Tok, Token, tokenize

_INTERVAL_MS = {
    "nanosecond": 1e-6, "nanoseconds": 1e-6, "ns": 1e-6,
    "microsecond": 1e-3, "microseconds": 1e-3, "us": 1e-3,
    "millisecond": 1, "milliseconds": 1, "ms": 1,
    "second": 1000, "seconds": 1000, "s": 1000, "sec": 1000, "secs": 1000,
    "minute": 60_000, "minutes": 60_000, "m": 60_000, "min": 60_000, "mins": 60_000,
    "hour": 3_600_000, "hours": 3_600_000, "h": 3_600_000,
    "day": 86_400_000, "days": 86_400_000, "d": 86_400_000,
    "week": 604_800_000, "weeks": 604_800_000, "w": 604_800_000,
    # calendar-approximate (used by RANGE/ALIGN; exact calendar handled in planner)
    "month": 2_592_000_000, "months": 2_592_000_000,
    "year": 31_536_000_000, "years": 31_536_000_000, "y": 31_536_000_000,
}


import re as _re

_INTERVAL_PART = _re.compile(r"\s*(-?\d+(?:\.\d+)?)\s*([a-z]*)\s*")


def parse_interval_str(raw: str) -> int:
    """'1 hour 30 minutes' | '5m' | '90s' | '60' (seconds) → milliseconds."""
    s = raw.strip().lower()
    if not s:
        raise SyntaxError_("empty interval")
    total = 0.0
    pos = 0
    while pos < len(s):
        m = _INTERVAL_PART.match(s, pos)
        if m is None or m.end() == pos:
            raise SyntaxError_(f"cannot parse interval {raw!r} at {pos}")
        num_s, unit_s = m.group(1), m.group(2)
        if not unit_s:
            # bare number: promql-style seconds
            total += float(num_s) * 1000
        elif unit_s in _INTERVAL_MS:
            total += float(num_s) * _INTERVAL_MS[unit_s]
        else:
            raise SyntaxError_(f"unknown interval unit {unit_s!r} in {raw!r}")
        pos = m.end()
    return int(total)


def resolve_timezone(tz: str):
    """'UTC' | 'Asia/Shanghai' | '+08:00' | '-05:30' → tzinfo."""
    tz = (tz or "UTC").strip()
    if tz.upper() == "UTC" or tz.upper() == "SYSTEM":
        return datetime.timezone.utc
    if tz and tz[0] in "+-":
        sign = -1 if tz[0] == "-" else 1
        hh, _, mm = tz[1:].partition(":")
        try:
            return datetime.timezone(
                sign * datetime.timedelta(hours=int(hh), minutes=int(mm or 0))
            )
        except ValueError:
            raise SyntaxError_(f"bad timezone offset {tz!r}") from None
    import zoneinfo

    try:
        return zoneinfo.ZoneInfo(tz)
    except (KeyError, zoneinfo.ZoneInfoNotFoundError):
        raise SyntaxError_(f"unknown timezone {tz!r}") from None


def parse_timestamp_str(raw: str, tz: str = "UTC") -> int:
    """ISO-ish timestamp string → epoch ms (naive inputs localized to tz)."""
    s = raw.strip().replace("T", " ")
    fmts = [
        "%Y-%m-%d %H:%M:%S.%f%z", "%Y-%m-%d %H:%M:%S%z",
        "%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
        "%Y-%m-%d %H:%M", "%Y-%m-%d",
    ]
    if s.endswith("Z"):
        s = s[:-1] + "+0000"
    for f in fmts:
        try:
            dt = datetime.datetime.strptime(s, f)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=resolve_timezone(tz))
            return int(dt.timestamp() * 1000)
        except ValueError:
            continue
    raise SyntaxError_(f"cannot parse timestamp {raw!r}")


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # ---- token helpers --------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind is not Tok.EOF:
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind is Tok.IDENT and t.upper in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise SyntaxError_(f"expected {kw} at {self.peek().pos}: got {self.peek().text!r}")

    def at(self, kind: Tok, text: str | None = None) -> bool:
        t = self.peek()
        return t.kind is kind and (text is None or t.text == text)

    def eat(self, kind: Tok, text: str | None = None) -> bool:
        if self.at(kind, text):
            self.next()
            return True
        return False

    def expect(self, kind: Tok, text: str | None = None) -> Token:
        if not self.at(kind, text):
            t = self.peek()
            raise SyntaxError_(f"expected {text or kind.value} at {t.pos}, got {t.text!r}")
        return self.next()

    def ident(self) -> str:
        t = self.peek()
        if t.kind in (Tok.IDENT, Tok.QUOTED_IDENT):
            self.next()
            return t.text
        raise SyntaxError_(f"expected identifier at {t.pos}, got {t.text!r}")

    def qualified_name(self) -> str:
        parts = [self.ident()]
        while self.eat(Tok.PUNCT, "."):
            parts.append(self.ident())
        return ".".join(parts)

    # ---- entry ----------------------------------------------------------
    @staticmethod
    def parse_sql(sql: str) -> list[Statement]:
        p = Parser(sql)
        stmts = []
        while not p.at(Tok.EOF):
            stmts.append(p.statement())
            while p.eat(Tok.PUNCT, ";"):
                pass
        return stmts

    def statement(self) -> Statement:
        t = self.peek()
        if t.kind is not Tok.IDENT:
            raise SyntaxError_(f"expected statement at {t.pos}, got {t.text!r}")
        kw = t.upper
        if kw == "SELECT":
            return self.select_or_union()
        if kw == "WITH":
            return self.with_statement()
        if kw == "TQL":
            return self.tql()
        if kw == "CREATE":
            return self.create()
        if kw == "INSERT":
            return self.insert()
        if kw == "DELETE":
            return self.delete()
        if kw == "DROP":
            return self.drop()
        if kw == "ALTER":
            return self.alter()
        if kw == "SHOW":
            return self.show()
        if kw in ("DESC", "DESCRIBE"):
            self.next()
            self.eat_kw("TABLE")
            return DescribeTable(self.qualified_name())
        if kw == "USE":
            self.next()
            return Use(self.ident())
        if kw == "EXPLAIN":
            self.next()
            analyze = self.eat_kw("ANALYZE")
            return Explain(self.statement(), analyze=analyze)
        if kw == "TRUNCATE":
            self.next()
            self.eat_kw("TABLE")
            return TruncateTable(self.qualified_name())
        if kw == "COPY":
            return self.copy()
        if kw == "SET":
            return self.set_var()
        if kw == "ADMIN":
            return self.admin()
        if kw == "KILL":
            from greptimedb_tpu_torch.query.ast import Kill

            self.next()
            self.eat_kw("QUERY", "CONNECTION")
            tok = self.peek()
            if tok.kind in (Tok.NUMBER, Tok.STRING):
                self.next()
                return Kill(tok.text)
            return Kill(self.ident())
        raise SyntaxError_(f"unrecognized statement keyword: {t.text!r} at {t.pos}")

    def admin(self) -> Statement:
        """ADMIN fn('arg', ...) — reference statements/admin.rs."""
        from greptimedb_tpu_torch.query.ast import Admin

        self.expect_kw("ADMIN")
        name = self.ident().lower()
        args: list = []
        if self.eat(Tok.PUNCT, "("):
            while not self.at(Tok.PUNCT, ")"):
                e = self.expr()
                if not isinstance(e, Literal):
                    raise SyntaxError_(
                        f"ADMIN {name}: arguments must be literals")
                args.append(e.value)
                if not self.eat(Tok.PUNCT, ","):
                    break
            self.expect(Tok.PUNCT, ")")
        return Admin(name, tuple(args))

    # ---- SELECT ---------------------------------------------------------
    def select_or_union(self) -> Statement:
        """SELECT ... [UNION|INTERSECT|EXCEPT [ALL] SELECT ...]*; a
        trailing ORDER BY/LIMIT (parsed into the last member) applies to
        the whole statement.  INTERSECT binds tighter than UNION/EXCEPT
        (standard SQL precedence); same-level operators associate left.
        INTERSECT/EXCEPT must be real set operations here — before they
        were parsed, ``SELECT 1 INTERSECT SELECT 1`` silently split into
        TWO statements (INTERSECT swallowed as a column alias) and
        returned only the second SELECT's result."""
        first = self.select()
        if not self.at_kw("UNION", "INTERSECT", "EXCEPT"):
            return first
        members: list = [first]
        ops: list[tuple[str, bool]] = []  # (op, all) joining i and i+1
        while self.at_kw("UNION", "INTERSECT", "EXCEPT"):
            op = self.next().upper.lower()
            all_ = bool(self.eat_kw("ALL"))
            self.eat_kw("DISTINCT")  # explicit DISTINCT = the default
            ops.append((op, all_))
            members.append(self.select())
        for m in members[:-1]:
            if m.order_by or m.limit is not None or m.offset is not None:
                raise SyntaxError_(
                    "ORDER BY/LIMIT inside a set-operation member needs "
                    "parentheses"
                )
        last = members[-1]
        order_by, limit, offset = last.order_by, last.limit, last.offset
        last.order_by, last.limit, last.offset = [], None, None

        if all(op == "union" for op, _ in ops):
            # flat UNION chain (the historical shape execute_union
            # optimizes for); mixed ALL-ness stays refused
            all_flags = {a for _, a in ops}
            if len(all_flags) > 1:
                raise SyntaxError_(
                    "mixed UNION and UNION ALL is not supported")
            return Union(
                selects=members, all=ops[0][1],
                order_by=order_by, limit=limit, offset=offset,
            )

        # precedence pass 1: fold INTERSECT runs into nested Unions
        folded: list = [members[0]]
        level_ops: list[tuple[str, bool]] = []
        for (op, all_), m in zip(ops, members[1:]):
            if op == "intersect":
                folded[-1] = Union(selects=[folded[-1], m], all=all_,
                                   op="intersect")
            else:
                level_ops.append((op, all_))
                folded.append(m)
        # pass 2: UNION/EXCEPT left-associative
        result = folded[0]
        for (op, all_), m in zip(level_ops, folded[1:]):
            result = Union(selects=[result, m], all=all_, op=op)
        result.order_by, result.limit, result.offset = (
            order_by, limit, offset)
        return result

    # ---- WITH ... AS (non-recursive CTEs) -------------------------------
    def with_statement(self) -> Statement:
        """``WITH name AS (SELECT ...) [, name2 AS (...)] SELECT ...``:
        non-recursive common table expressions, desugared at parse time —
        every FROM reference to a CTE name becomes a derived table
        (``from_subquery``), so planning/execution reuse the staged
        subquery machinery unchanged (the reference plans CTEs through
        DataFusion, tests/cases/.../common/cte/).  Each CTE body sees the
        CTEs defined before it; forward and self references stay plain
        table names (and surface TableNotFound), which is exactly
        non-recursive scoping."""
        self.expect_kw("WITH")
        if self.at_kw("RECURSIVE"):
            raise Unsupported("WITH RECURSIVE (recursive CTEs)")
        ctes: dict[str, Statement] = {}
        while True:
            name = self.ident()
            if self.at(Tok.PUNCT, "("):
                raise Unsupported("CTE column alias lists")
            self.expect_kw("AS")
            self.expect(Tok.PUNCT, "(")
            body = self.select_or_union()
            self.expect(Tok.PUNCT, ")")
            if name in ctes:
                raise SyntaxError_(f"duplicate CTE name {name!r}")
            ctes[name] = _substitute_ctes(body, ctes)
            if not self.eat(Tok.PUNCT, ","):
                break
        if not self.at_kw("SELECT"):
            t = self.peek()
            raise SyntaxError_(
                f"WITH must be followed by SELECT at {t.pos}, "
                f"got {t.text!r}")
        return _substitute_ctes(self.select_or_union(), ctes)

    def select(self) -> Select:
        self.expect_kw("SELECT")
        distinct = self.eat_kw("DISTINCT")
        items = [self.select_item()]
        while self.eat(Tok.PUNCT, ","):
            items.append(self.select_item())
        table = alias = None
        from_subquery = None
        joins: list[JoinClause] = []
        if self.eat_kw("FROM"):
            if self.at(Tok.PUNCT, "("):
                # derived table: FROM (SELECT …) [AS] alias — the alias
                # becomes the staged table name (qualified refs resolve);
                # set operations stage like any other inner statement
                self.next()
                from_subquery = self.select_or_union()
                self.expect(Tok.PUNCT, ")")
                table = "__subquery__"
            else:
                table = self.qualified_name()
            if self.peek().kind is Tok.IDENT and not self.at_kw(
                "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "ALIGN",
                "UNION", "INTERSECT", "EXCEPT",
                "JOIN", "LEFT", "RIGHT", "FULL", "INNER", "ON", "AS",
            ):
                alias = self.ident()
            elif self.eat_kw("AS"):
                alias = self.ident()
            if from_subquery is not None and alias is not None:
                table, alias = alias, None
            while self.at_kw("JOIN", "INNER", "LEFT", "RIGHT", "FULL"):
                kind = "inner"
                if self.eat_kw("LEFT"):
                    self.eat_kw("OUTER")
                    kind = "left"
                elif self.eat_kw("RIGHT"):
                    self.eat_kw("OUTER")
                    kind = "right"
                elif self.eat_kw("FULL"):
                    self.eat_kw("OUTER")
                    kind = "full"
                else:
                    self.eat_kw("INNER")
                self.expect_kw("JOIN")
                jt = self.qualified_name()
                ja = None
                if self.eat_kw("AS"):
                    ja = self.ident()
                elif self.peek().kind is Tok.IDENT and not self.at_kw("ON"):
                    ja = self.ident()
                self.expect_kw("ON")
                on = self.expr()
                joins.append(JoinClause(jt, ja, on, kind))
        where = self.expr() if self.eat_kw("WHERE") else None
        group_by: list[Expr] = []
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.expr())
            while self.eat(Tok.PUNCT, ","):
                group_by.append(self.expr())
        having = self.expr() if self.eat_kw("HAVING") else None
        align = None
        align_by: list[Expr] = []
        fill = None
        range_ = None
        if self.eat_kw("ALIGN"):
            align = self.interval()
            if self.eat_kw("BY"):
                self.expect(Tok.PUNCT, "(")
                if not self.at(Tok.PUNCT, ")"):
                    align_by.append(self.expr())
                    while self.eat(Tok.PUNCT, ","):
                        align_by.append(self.expr())
                self.expect(Tok.PUNCT, ")")
            if self.eat_kw("FILL"):
                fill = self.next().text
        order_by: list[OrderByItem] = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self.order_item())
            while self.eat(Tok.PUNCT, ","):
                order_by.append(self.order_item())
        limit = offset = None
        if self.eat_kw("LIMIT"):
            limit = int(self.expect(Tok.NUMBER).text)
        if self.eat_kw("OFFSET"):
            offset = int(self.expect(Tok.NUMBER).text)
        return Select(
            items=items, table=table, table_alias=alias, joins=joins,
            where=where,
            group_by=group_by, having=having, order_by=order_by, limit=limit,
            offset=offset, distinct=distinct, align=align, align_by=align_by,
            fill=fill, range_=range_, from_subquery=from_subquery,
        )

    def select_item(self) -> SelectItem:
        if self.at(Tok.OP, "*"):
            self.next()
            return SelectItem(Star())
        e = self.expr()
        rng = None
        fill = None
        if self.at_kw("RANGE"):
            self.next()
            rng = self.interval()
            if self.eat_kw("FILL"):
                fill = self.next().text
        alias = None
        if self.eat_kw("AS"):
            alias = self.ident()
        elif self.peek().kind in (Tok.IDENT, Tok.QUOTED_IDENT) and not self.at_kw(
            "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET",
            "ALIGN", "RANGE", "FILL", "BY", "AND", "OR", "NOT", "BETWEEN",
            "IN", "IS", "LIKE", "UNION", "INTERSECT", "EXCEPT",
        ):
            alias = self.ident()
        if rng is None and self.at_kw("RANGE"):
            self.next()
            rng = self.interval()
            if self.eat_kw("FILL"):
                fill = self.next().text
        return SelectItem(e, alias, rng, fill)

    def _maybe_window(self, name: str, args: tuple) -> Expr:
        """After `fn(args)`: consume OVER (...) into a WindowFunc, or
        return the plain FuncCall."""
        if not self.eat_kw("OVER"):
            return FuncCall(name, args)
        from greptimedb_tpu_torch.query.ast import WindowFunc, WindowSpec

        self.expect(Tok.PUNCT, "(")
        partition: list[Expr] = []
        order: list[OrderByItem] = []
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            partition.append(self.expr())
            while self.eat(Tok.PUNCT, ","):
                partition.append(self.expr())
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order.append(self.order_item())
            while self.eat(Tok.PUNCT, ","):
                order.append(self.order_item())
        self.expect(Tok.PUNCT, ")")
        return WindowFunc(name, args,
                          WindowSpec(tuple(partition), tuple(order)))

    def order_item(self) -> OrderByItem:
        e = self.expr()
        asc = True
        if self.eat_kw("ASC"):
            asc = True
        elif self.eat_kw("DESC"):
            asc = False
        nulls_first = None
        if self.eat_kw("NULLS"):
            if self.eat_kw("FIRST"):
                nulls_first = True
            else:
                self.expect_kw("LAST")
                nulls_first = False
        return OrderByItem(e, asc, nulls_first)

    def interval(self) -> IntervalLit:
        t = self.peek()
        if t.kind is Tok.STRING:
            self.next()
            return IntervalLit(parse_interval_str(t.text), t.text)
        if t.kind is Tok.IDENT and t.upper == "INTERVAL":
            self.next()
            s = self.expect(Tok.STRING).text
            return IntervalLit(parse_interval_str(s), s)
        raise SyntaxError_(f"expected interval at {t.pos}")

    # ---- expressions (precedence climbing) ------------------------------
    def expr(self) -> Expr:
        return self.or_expr()

    def or_expr(self) -> Expr:
        left = self.and_expr()
        while self.at_kw("OR"):
            self.next()
            left = BinaryOp("OR", left, self.and_expr())
        return left

    def and_expr(self) -> Expr:
        left = self.not_expr()
        while self.at_kw("AND"):
            self.next()
            left = BinaryOp("AND", left, self.not_expr())
        return left

    def not_expr(self) -> Expr:
        if self.at_kw("NOT"):
            self.next()
            return UnaryOp("NOT", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self) -> Expr:
        left = self.add_expr()
        t = self.peek()
        if t.kind is Tok.OP and t.text in ("=", "!=", "<>", "<", "<=", ">", ">=", "~", "!~", "=~"):
            self.next()
            op = {"<>": "!=", "=~": "~"}.get(t.text, t.text)
            return BinaryOp(op, left, self.add_expr())
        negated = False
        if self.at_kw("NOT") and self.peek(1).upper in ("LIKE", "IN", "BETWEEN", "ILIKE"):
            self.next()
            negated = True
        if self.at_kw("LIKE", "ILIKE"):
            op = self.next().upper
            node = BinaryOp(op, left, self.add_expr())
            return UnaryOp("NOT", node) if negated else node
        if self.at_kw("BETWEEN"):
            self.next()
            low = self.add_expr()
            self.expect_kw("AND")
            high = self.add_expr()
            return Between(left, low, high, negated)
        if self.at_kw("IN"):
            self.next()
            self.expect(Tok.PUNCT, "(")
            if self.at_kw("SELECT"):
                sub = self.select()
                self.expect(Tok.PUNCT, ")")
                return InSubquery(left, sub, negated)
            items = [self.expr()]
            while self.eat(Tok.PUNCT, ","):
                items.append(self.expr())
            self.expect(Tok.PUNCT, ")")
            return InList(left, tuple(items), negated)
        if self.at_kw("IS"):
            self.next()
            neg = self.eat_kw("NOT")
            self.expect_kw("NULL")
            return IsNull(left, neg)
        return left

    def add_expr(self) -> Expr:
        left = self.mul_expr()
        while self.at(Tok.OP, "+") or self.at(Tok.OP, "-") or self.at(Tok.OP, "||"):
            op = self.next().text
            left = BinaryOp(op, left, self.mul_expr())
        return left

    def mul_expr(self) -> Expr:
        left = self.unary_expr()
        while self.at(Tok.OP, "*") or self.at(Tok.OP, "/") or self.at(Tok.OP, "%"):
            op = self.next().text
            left = BinaryOp(op, left, self.unary_expr())
        return left

    def unary_expr(self) -> Expr:
        if self.at(Tok.OP, "-"):
            self.next()
            return UnaryOp("-", self.unary_expr())
        if self.at(Tok.OP, "+"):
            self.next()
            return self.unary_expr()
        e = self.primary()
        # postgres-style postfix cast: expr::TYPE (two ':' PUNCT tokens)
        while (self.at(Tok.PUNCT, ":")
               and self.peek(1).kind is Tok.PUNCT
               and self.peek(1).text == ":"):
            self.next()
            self.next()
            e = Cast(e, self.type_name())
        return e

    def primary(self) -> Expr:
        t = self.peek()
        if t.kind is Tok.NUMBER:
            self.next()
            txt = t.text
            if "." in txt or "e" in txt or "E" in txt:
                return Literal(float(txt))
            return Literal(int(txt))
        if t.kind is Tok.STRING:
            self.next()
            return Literal(t.text)
        if self.at_kw("EXISTS") and self.peek(1).kind is Tok.PUNCT and (
                self.peek(1).text == "("):
            self.next()
            self.expect(Tok.PUNCT, "(")
            sub = self.select()
            self.expect(Tok.PUNCT, ")")
            return Exists(sub)
        if self.eat(Tok.PUNCT, "("):
            if self.at_kw("SELECT"):
                sub = self.select()
                self.expect(Tok.PUNCT, ")")
                return ScalarSubquery(sub)
            e = self.expr()
            self.expect(Tok.PUNCT, ")")
            return e
        if t.kind in (Tok.IDENT, Tok.QUOTED_IDENT):
            kw = t.upper if t.kind is Tok.IDENT else ""
            if kw == "NULL":
                self.next()
                return Literal(None)
            if kw == "TRUE":
                self.next()
                return Literal(True)
            if kw == "FALSE":
                self.next()
                return Literal(False)
            if kw == "INTERVAL":
                return self.interval()
            if kw == "CASE":
                return self.case_expr()
            if kw == "CAST":
                self.next()
                self.expect(Tok.PUNCT, "(")
                e = self.expr()
                self.expect_kw("AS")
                type_name = self.type_name()
                self.expect(Tok.PUNCT, ")")
                return Cast(e, type_name)
            # identifier / function call / qualified column
            name = self.ident()
            if (name.lower() == "position" and self.at(Tok.PUNCT, "(")
                    and self._position_in_form()):
                # POSITION(substr IN str) → position(substr, str)
                self.next()
                sub = self.unary_expr()
                self.expect_kw("IN")
                s = self.expr()
                self.expect(Tok.PUNCT, ")")
                return FuncCall("position", (sub, s))
            if name.lower() == "extract" and self.at(Tok.PUNCT, "("):
                # EXTRACT(unit FROM expr) → date_part('unit', expr)
                self.next()
                unit = self.ident()
                self.expect_kw("FROM")
                inner = self.expr()
                self.expect(Tok.PUNCT, ")")
                return FuncCall("date_part",
                                (Literal(unit.lower()), inner))
            if self.at(Tok.PUNCT, "("):
                self.next()
                if self.at(Tok.OP, "*"):
                    self.next()
                    self.expect(Tok.PUNCT, ")")
                    return self._maybe_window(name.lower(), (Star(),))
                distinct = self.eat_kw("DISTINCT")
                args: list[Expr] = []
                if not self.at(Tok.PUNCT, ")"):
                    args.append(self.expr())
                    while self.eat(Tok.PUNCT, ","):
                        args.append(self.expr())
                self.expect(Tok.PUNCT, ")")
                if not distinct and self.at_kw("OVER"):
                    return self._maybe_window(name.lower(), tuple(args))
                return FuncCall(name.lower(), tuple(args), distinct)
            if self.at(Tok.PUNCT, "."):
                self.next()
                if self.at(Tok.OP, "*"):
                    self.next()
                    return Star(table=name)
                col = self.ident()
                return Column(col, table=name)
            return Column(name)
        raise SyntaxError_(f"unexpected token {t.text!r} at {t.pos}")

    def _position_in_form(self) -> bool:
        """Lookahead: POSITION(expr IN expr) vs plain position(a, b)."""
        depth = 0
        i = 0
        while True:
            t = self.peek(i)
            if t.kind is Tok.EOF:
                return False
            if t.kind is Tok.PUNCT and t.text == "(":
                depth += 1
            elif t.kind is Tok.PUNCT and t.text == ")":
                depth -= 1
                if depth <= 0:
                    return False
            elif depth == 1 and t.kind is Tok.PUNCT and t.text == ",":
                return False
            elif depth == 1 and t.kind is Tok.IDENT and t.upper == "IN":
                return True
            i += 1

    def case_expr(self) -> Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.expr()
        whens = []
        while self.eat_kw("WHEN"):
            cond = self.expr()
            self.expect_kw("THEN")
            whens.append((cond, self.expr()))
        else_ = self.expr() if self.eat_kw("ELSE") else None
        self.expect_kw("END")
        return Case(operand, tuple(whens), else_)

    def type_name(self) -> str:
        base = self.ident()
        if self.eat(Tok.PUNCT, "("):
            args = [self.expect(Tok.NUMBER).text]
            while self.eat(Tok.PUNCT, ","):
                args.append(self.expect(Tok.NUMBER).text)
            self.expect(Tok.PUNCT, ")")
            base += f"({','.join(args)})"
        if self.at_kw("UNSIGNED"):
            self.next()
            base += " UNSIGNED"
        return base

    # ---- TQL ------------------------------------------------------------
    def tql(self) -> Tql:
        self.expect_kw("TQL")
        cmd = self.next().upper
        if cmd not in ("EVAL", "EVALUATE", "ANALYZE", "EXPLAIN"):
            raise SyntaxError_(f"unknown TQL command {cmd}")
        self.expect(Tok.PUNCT, "(")
        params = []
        depth = 1

        def num_or_ts() -> float:
            t = self.next()
            if t.kind is Tok.NUMBER:
                return float(t.text)
            if t.kind is Tok.STRING:
                try:
                    return parse_timestamp_str(t.text) / 1000.0
                except SyntaxError_:
                    return float(parse_interval_str(t.text)) / 1000.0
            if t.kind is Tok.IDENT and t.upper == "NOW":
                if self.eat(Tok.PUNCT, "("):
                    self.expect(Tok.PUNCT, ")")
                import time as _time

                return _time.time()
            raise SyntaxError_(f"bad TQL parameter at {t.pos}")

        start = num_or_ts()
        self.expect(Tok.PUNCT, ",")
        end = num_or_ts()
        self.expect(Tok.PUNCT, ",")
        t = self.peek()
        if t.kind is Tok.STRING:
            self.next()
            step = parse_interval_str(t.text) / 1000.0
        else:
            step = num_or_ts()
        lookback = None
        if self.eat(Tok.PUNCT, ","):
            t = self.peek()
            if t.kind is Tok.STRING:
                self.next()
                lookback = parse_interval_str(t.text) / 1000.0
            else:
                lookback = num_or_ts()
        self.expect(Tok.PUNCT, ")")
        # rest of statement (until ; or EOF) is raw PromQL
        start_pos = self.peek().pos
        end_pos = len(self.sql)
        while not self.at(Tok.EOF) and not self.at(Tok.PUNCT, ";"):
            self.next()
        if self.at(Tok.PUNCT, ";"):
            end_pos = self.peek().pos
        query = self.sql[start_pos:end_pos].strip()
        return Tql(cmd if cmd != "EVALUATE" else "EVAL", start, end, step, query,
                   lookback)

    # ---- DDL / DML ------------------------------------------------------
    def create(self) -> Statement:
        self.expect_kw("CREATE")
        if self.eat_kw("DATABASE", "SCHEMA"):
            ine = self._if_not_exists()
            return CreateDatabase(self.ident(), ine)
        if self.eat_kw("FLOW"):
            ine = self._if_not_exists()
            name = self.qualified_name()
            self.expect_kw("SINK")
            self.expect_kw("TO")
            sink = self.qualified_name()
            expire = None
            if self.eat_kw("EXPIRE"):
                self.expect_kw("AFTER")
                expire = self.interval()
            comment = None
            if self.eat_kw("COMMENT"):
                comment = self.expect(Tok.STRING).text
            self.expect_kw("AS")
            q = self.select()
            return CreateFlow(name, sink, q, expire, comment, ine)
        or_replace = False
        if self.at_kw("OR"):
            self.next()
            self.expect_kw("REPLACE")
            or_replace = True
        if self.eat_kw("VIEW"):
            ine = self._if_not_exists()
            name = self.qualified_name()
            self.expect_kw("AS")
            start = self.peek().pos
            self.select_or_union()  # validate eagerly; text is the store
            end = (self.peek().pos if not self.at(Tok.EOF)
                   else len(self.sql))
            return CreateView(name, self.sql[start:end].strip(),
                              or_replace=or_replace, if_not_exists=ine)
        if or_replace:
            raise Unsupported("CREATE OR REPLACE is only for VIEW")
        external = self.eat_kw("EXTERNAL")
        if self.eat_kw("TABLE"):
            ine = self._if_not_exists()
            name = self.qualified_name()
            self.expect(Tok.PUNCT, "(")
            cols: list[ColumnDef] = []
            time_index: str | None = None
            pks: list[str] = []
            while True:
                if self.at_kw("PRIMARY"):
                    self.next()
                    self.expect_kw("KEY")
                    self.expect(Tok.PUNCT, "(")
                    pks.append(self.ident())
                    while self.eat(Tok.PUNCT, ","):
                        pks.append(self.ident())
                    self.expect(Tok.PUNCT, ")")
                elif self.at_kw("TIME") and self.peek(1).upper == "INDEX":
                    self.next(); self.next()
                    self.expect(Tok.PUNCT, "(")
                    time_index = self.ident()
                    self.expect(Tok.PUNCT, ")")
                else:
                    cname = self.ident()
                    tname = self.type_name()
                    cd = ColumnDef(cname, tname)
                    # column constraints
                    while True:
                        if self.eat_kw("NOT"):
                            self.expect_kw("NULL")
                            cd.nullable = False
                        elif self.eat_kw("NULL"):
                            cd.nullable = True
                        elif self.at_kw("TIME") and self.peek(1).upper == "INDEX":
                            self.next(); self.next()
                            time_index = cname
                        elif self.eat_kw("PRIMARY"):
                            self.expect_kw("KEY")
                            pks.append(cname)
                        elif self.eat_kw("DEFAULT"):
                            t = self.next()
                            if t.kind is Tok.NUMBER:
                                cd.default = float(t.text) if "." in t.text else int(t.text)
                            elif t.kind is Tok.STRING:
                                cd.default = t.text
                            elif t.upper == "NULL":
                                cd.default = None
                            else:
                                # e.g. current_timestamp()
                                if self.eat(Tok.PUNCT, "("):
                                    self.expect(Tok.PUNCT, ")")
                                cd.default = f"{t.text}()"
                        elif self.eat_kw("COMMENT"):
                            cd.comment = self.expect(Tok.STRING).text
                        else:
                            break
                    cols.append(cd)
                if not self.eat(Tok.PUNCT, ","):
                    break
            self.expect(Tok.PUNCT, ")")
            engine = "file" if external else "mito"
            options: dict = {}
            partitions: list[str] = []
            partition_columns: list[str] = []
            while True:
                if self.eat_kw("ENGINE"):
                    self.eat(Tok.OP, "=")
                    engine = self.ident()
                elif self.at_kw("WITH"):
                    options.update(self._with_options())
                elif self.at_kw("PARTITION"):
                    # PARTITION ON COLUMNS (...) ( expr, ... )
                    self.next()
                    self.expect_kw("ON")
                    self.expect_kw("COLUMNS")
                    self.expect(Tok.PUNCT, "(")
                    on_cols = [self.ident()]
                    while self.eat(Tok.PUNCT, ","):
                        on_cols.append(self.ident())
                    self.expect(Tok.PUNCT, ")")
                    self.expect(Tok.PUNCT, "(")
                    depth = 1
                    start_pos = self.peek().pos
                    exprs: list[str] = []
                    seg_start = start_pos
                    while depth > 0 and not self.at(Tok.EOF):
                        if self.at(Tok.PUNCT, "("):
                            depth += 1
                        elif self.at(Tok.PUNCT, ")"):
                            depth -= 1
                            if depth == 0:
                                exprs.append(self.sql[seg_start:self.peek().pos].strip())
                                self.next()
                                break
                        elif self.at(Tok.PUNCT, ",") and depth == 1:
                            exprs.append(self.sql[seg_start:self.peek().pos].strip())
                            seg_start = self.peek().pos + 1
                        self.next()
                    partitions = [e for e in exprs if e]
                    partition_columns = on_cols
                else:
                    break
            return CreateTable(name, cols, time_index, pks, ine, options,
                               partitions, partition_columns, engine)
        raise Unsupported(f"unsupported CREATE at {self.peek().pos}")

    def copy(self):
        from greptimedb_tpu_torch.query.ast import Copy

        self.expect_kw("COPY")
        table = self.qualified_name()
        if self.eat_kw("TO"):
            direction = "to"
        elif self.eat_kw("FROM"):
            direction = "from"
        else:
            raise SyntaxError_(f"expected TO or FROM at {self.peek().pos}")
        path = self.expect(Tok.STRING).text
        options = self._with_options(lowercase_keys=True)
        return Copy(table, path, direction, options)

    def set_var(self):
        from greptimedb_tpu_torch.query.ast import SetVar

        self.expect_kw("SET")
        self.eat_kw("SESSION", "GLOBAL", "LOCAL")
        while self.eat(Tok.PUNCT, "@"):  # @@session.var / @var forms
            pass
        self.eat_kw("SESSION")
        self.eat(Tok.PUNCT, ".")
        # NAMES charset [COLLATE ...] is special-cased
        if self.eat_kw("NAMES"):
            charset = self.next().text
            self._consume_rest_of_statement()
            return SetVar("names", charset)
        # postgres form: SET TIME ZONE 'x'
        if self.at_kw("TIME") and self.peek(1).upper == "ZONE":
            self.next(); self.next()
            value = self.next().text
            self._consume_rest_of_statement()
            return SetVar("time_zone", value)
        name_parts = [self.ident()]
        while self.eat(Tok.PUNCT, "."):
            name_parts.append(self.ident())
        name = name_parts[-1]  # session.time_zone → time_zone
        self.eat(Tok.OP, "=")
        self.eat_kw("TO")
        t = self.next()
        value = t.text
        # remaining tokens (COLLATE ..., multiple assignments) are a
        # compat no-op, like the statement itself for unknown variables
        self._consume_rest_of_statement()
        return SetVar(name.lower(), value)

    def _consume_rest_of_statement(self) -> None:
        while not self.at(Tok.EOF) and not self.at(Tok.PUNCT, ";"):
            self.next()

    def _with_options(self, lowercase_keys: bool = False) -> dict:
        """Shared `WITH (k = v, ...)` parsing (CREATE TABLE, COPY)."""
        options: dict = {}
        if self.eat_kw("WITH"):
            self.expect(Tok.PUNCT, "(")
            while not self.at(Tok.PUNCT, ")"):
                k = self.ident() if not self.at(Tok.STRING) else self.next().text
                self.eat(Tok.OP, "=")
                options[k.lower() if lowercase_keys else k] = self.next().text
                self.eat(Tok.PUNCT, ",")
            self.expect(Tok.PUNCT, ")")
        return options

    def _if_not_exists(self) -> bool:
        if self.at_kw("IF"):
            self.next()
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def insert(self) -> Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.qualified_name()
        columns: list[str] = []
        if self.eat(Tok.PUNCT, "("):
            columns.append(self.ident())
            while self.eat(Tok.PUNCT, ","):
                columns.append(self.ident())
            self.expect(Tok.PUNCT, ")")
        if self.at_kw("SELECT"):
            # INSERT INTO t [(cols)] SELECT … (reference insert-select)
            return Insert(table, columns, [], select=self.select())
        self.expect_kw("VALUES")
        rows: list[list[object]] = []
        while True:
            self.expect(Tok.PUNCT, "(")
            row: list[object] = []
            while True:
                e = self.expr()
                row.append(self._literal_value(e))
                if not self.eat(Tok.PUNCT, ","):
                    break
            self.expect(Tok.PUNCT, ")")
            rows.append(row)
            if not self.eat(Tok.PUNCT, ","):
                break
        return Insert(table, columns, rows)

    def _literal_value(self, e: Expr) -> object:
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, UnaryOp) and e.op == "-" and isinstance(e.operand, Literal):
            return -e.operand.value  # type: ignore[operator]
        if isinstance(e, FuncCall) and e.name in ("now", "current_timestamp"):
            import time as _time

            return int(_time.time() * 1000)
        raise Unsupported(f"non-literal INSERT value: {e}")

    def delete(self) -> Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self.qualified_name()
        where = self.expr() if self.eat_kw("WHERE") else None
        return Delete(table, where)

    def drop(self) -> Statement:
        self.expect_kw("DROP")
        if self.eat_kw("DATABASE", "SCHEMA"):
            ie = self._if_exists()
            return DropDatabase(self.ident(), ie)
        if self.eat_kw("FLOW"):
            ie = self._if_exists()
            return DropFlow(self.qualified_name(), ie)
        if self.eat_kw("VIEW"):
            ie = self._if_exists()
            return DropView(self.qualified_name(), ie)
        self.expect_kw("TABLE")
        ie = self._if_exists()
        names = [self.qualified_name()]
        while self.eat(Tok.PUNCT, ","):
            names.append(self.qualified_name())
        return DropTable(names, ie)

    def _if_exists(self) -> bool:
        if self.at_kw("IF"):
            self.next()
            self.expect_kw("EXISTS")
            return True
        return False

    def alter(self) -> AlterTable:
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        table = self.qualified_name()
        if self.eat_kw("ADD"):
            self.eat_kw("COLUMN")
            cname = self.ident()
            tname = self.type_name()
            cd = ColumnDef(cname, tname)
            if self.eat_kw("NOT"):
                self.expect_kw("NULL")
                cd.nullable = False
            return AlterTable(table, "add_column", column=cd)
        if self.eat_kw("DROP"):
            self.eat_kw("COLUMN")
            return AlterTable(table, "drop_column", name=self.ident())
        if self.eat_kw("RENAME"):
            self.eat_kw("TO")
            return AlterTable(table, "rename", name=self.ident())
        if self.eat_kw("SET"):
            # ALTER TABLE t SET 'ttl'='1d' / SET ttl='1d', ... (reference
            # mito_engine_options: change table options online)
            opts: dict = {}
            while True:
                k = self.ident() if not self.at(Tok.STRING) else self.next().text
                self.expect(Tok.OP, "=")
                opts[k.lower()] = self.next().text
                if not self.eat(Tok.PUNCT, ","):
                    break
            return AlterTable(table, "set_options", options=opts)
        if self.eat_kw("UNSET"):
            k = self.ident() if not self.at(Tok.STRING) else self.next().text
            return AlterTable(table, "unset_option", name=k.lower())
        raise Unsupported(f"unsupported ALTER at {self.peek().pos}")

    def show(self) -> Statement:
        self.expect_kw("SHOW")
        if self.eat_kw("DATABASES", "SCHEMAS"):
            like = None
            if self.eat_kw("LIKE"):
                like = self.expect(Tok.STRING).text
            return ShowDatabases(like)
        full = False
        nxt1 = self.peek(1)
        if (self.at_kw("FULL") and nxt1.kind is Tok.IDENT
                and nxt1.upper == "TABLES"):
            self.next()
            full = True
        if self.eat_kw("TABLES"):
            db = None
            like = None
            if self.eat_kw("FROM", "IN"):
                db = self.ident()
            if self.eat_kw("LIKE"):
                like = self.expect(Tok.STRING).text
            return ShowTables(db, like, full)
        if self.eat_kw("COLUMNS", "FIELDS"):
            from greptimedb_tpu_torch.query.ast import ShowColumns

            self.expect_kw("FROM")
            return ShowColumns(self.qualified_name())
        if self.eat_kw("INDEX", "INDEXES", "KEYS"):
            from greptimedb_tpu_torch.query.ast import ShowIndex

            self.expect_kw("FROM")
            return ShowIndex(self.qualified_name())
        if self.eat_kw("FLOWS"):
            return ShowFlows()
        if self.eat_kw("CREATE"):
            if not self.eat_kw("TABLE"):
                self.expect_kw("VIEW")
                return ShowCreateTable(self.qualified_name(), view=True)
            return ShowCreateTable(self.qualified_name())
        nxt = self.peek(1)
        if self.at_kw("PROCESSLIST") or (
            self.at_kw("FULL")
            and nxt.kind is Tok.IDENT and nxt.upper == "PROCESSLIST"
        ):
            from greptimedb_tpu_torch.query.ast import ShowProcesslist

            full = self.eat_kw("FULL")
            self.expect_kw("PROCESSLIST")
            return ShowProcesslist(full=full)
        raise Unsupported(f"unsupported SHOW at {self.peek().pos}")


def parse_sql(sql: str) -> list[Statement]:
    return Parser.parse_sql(sql)


def _substitute_ctes(stmt: Statement, ctes: dict) -> Statement:
    """Rewrite FROM references to CTE names into derived tables, and
    recurse into set-operation members, derived tables and expression
    subqueries (IN/EXISTS/scalar) so a CTE is visible anywhere a SELECT
    can appear.  JOIN operands cannot stage a subquery yet — a CTE name
    there is refused rather than silently bound to a real table."""
    import dataclasses

    from greptimedb_tpu_torch.query.ast import map_expr

    if not ctes:
        return stmt
    if isinstance(stmt, Union):
        return dataclasses.replace(stmt, selects=[
            _substitute_ctes(s, ctes) for s in stmt.selects
        ])
    if not isinstance(stmt, Select):
        return stmt

    def sub_expr(e):
        if e is None:
            return None

        def resolve(node):
            if isinstance(node, (ScalarSubquery, InSubquery, Exists)):
                inner = _substitute_ctes(node.select, ctes)
                if inner is not node.select:
                    return dataclasses.replace(node, select=inner)
            return node

        return map_expr(e, resolve)

    changes: dict = {}
    for j in stmt.joins:
        if j.table in ctes:
            raise Unsupported(f"CTE {j.table!r} in JOIN")
    if stmt.from_subquery is not None:
        inner = _substitute_ctes(stmt.from_subquery, ctes)
        if inner is not stmt.from_subquery:
            changes["from_subquery"] = inner
    elif stmt.table in ctes:
        # the CTE name doubles as the staged table alias, exactly like
        # FROM (SELECT ...) name
        changes["from_subquery"] = ctes[stmt.table]
    new_items = [
        dataclasses.replace(it, expr=sub_expr(it.expr))
        if not isinstance(it.expr, Star) else it
        for it in stmt.items
    ]
    if any(a.expr is not b.expr for a, b in zip(new_items, stmt.items)):
        changes["items"] = new_items
    for f in ("where", "having"):
        v = getattr(stmt, f)
        nv = sub_expr(v)
        if nv is not v:
            changes[f] = nv
    if stmt.group_by:
        ng = [sub_expr(g) for g in stmt.group_by]
        if any(a is not b for a, b in zip(ng, stmt.group_by)):
            changes["group_by"] = ng
    if stmt.order_by:
        no = [dataclasses.replace(o, expr=sub_expr(o.expr))
              for o in stmt.order_by]
        if any(a.expr is not b.expr for a, b in zip(no, stmt.order_by)):
            changes["order_by"] = no
    return dataclasses.replace(stmt, **changes) if changes else stmt
