"""PromQL parser (reference uses the promql-parser crate, Cargo.toml:201).

Grammar per the Prometheus spec: vector selectors with label matchers,
range/offset/@ modifiers, functions, aggregation operators with
by/without, binary operators with precedence, vector matching modifiers
(on/ignoring, group_left/group_right), number/string literals.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from greptimedb_tpu_torch.errors import SyntaxError_
from greptimedb_tpu_torch.query.parser import parse_interval_str


# ---- AST -------------------------------------------------------------------

class PromExpr:
    pass


@dataclass(frozen=True)
class LabelMatcher:
    name: str
    op: str  # = != =~ !~
    value: str


@dataclass
class VectorSelector(PromExpr):
    metric: str
    matchers: list[LabelMatcher] = field(default_factory=list)
    range_s: float | None = None  # range vector [5m]
    offset_s: float = 0.0
    at_ts: float | None = None  # @ modifier

    def __str__(self):
        m = ",".join(f"{x.name}{x.op}\"{x.value}\"" for x in self.matchers)
        s = self.metric + (f"{{{m}}}" if m else "")
        if self.range_s is not None:
            s += f"[{self.range_s}s]"
        if self.offset_s:
            s += f" offset {self.offset_s}s"
        return s


@dataclass
class NumberLit(PromExpr):
    value: float

    def __str__(self):
        return str(self.value)


@dataclass
class StringLit(PromExpr):
    value: str

    def __str__(self):
        return repr(self.value)


@dataclass
class FunctionCall(PromExpr):
    func: str
    args: list[PromExpr]

    def __str__(self):
        return f"{self.func}({', '.join(map(str, self.args))})"


@dataclass
class Aggregation(PromExpr):
    op: str  # sum avg min max count topk bottomk quantile stddev stdvar group count_values
    expr: PromExpr
    param: PromExpr | None = None  # k for topk, q for quantile
    grouping: list[str] = field(default_factory=list)
    without: bool = False

    def __str__(self):
        by = (" without" if self.without else " by") + f" ({', '.join(self.grouping)})" if self.grouping or self.without else ""
        p = f"{self.param}, " if self.param is not None else ""
        return f"{self.op}{by}({p}{self.expr})"


@dataclass
class BinaryExpr(PromExpr):
    op: str
    lhs: PromExpr
    rhs: PromExpr
    bool_modifier: bool = False
    on: list[str] | None = None  # vector matching labels (on) or None
    ignoring: list[str] | None = None
    group_left: list[str] | None = None  # include labels; None = no group_left
    group_right: list[str] | None = None

    def __str__(self):
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclass
class UnaryExpr(PromExpr):
    op: str
    expr: PromExpr

    def __str__(self):
        return f"{self.op}{self.expr}"


@dataclass
class SubqueryExpr(PromExpr):
    expr: PromExpr
    range_s: float
    step_s: float | None
    offset_s: float = 0.0

    def __str__(self):
        return f"{self.expr}[{self.range_s}s:{self.step_s or ''}s]"


AGG_OPS = {
    "sum", "avg", "min", "max", "count", "topk", "bottomk", "quantile",
    "stddev", "stdvar", "group", "count_values",
}
PARAM_AGGS = {"topk", "bottomk", "quantile", "count_values"}

# precedence: ^ > * / % atan2 > + - > == != <= < >= > > and unless > or
_PREC = {
    "or": 1,
    "and": 2, "unless": 2,
    "==": 3, "!=": 3, "<=": 3, "<": 3, ">=": 3, ">": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5, "atan2": 5,
    "^": 6,
}


class PromParser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    # ---- lexing helpers -------------------------------------------------
    def _ws(self) -> None:
        while self.i < len(self.s):
            c = self.s[self.i]
            if c.isspace():
                self.i += 1
            elif c == "#":
                nl = self.s.find("\n", self.i)
                self.i = len(self.s) if nl < 0 else nl + 1
            else:
                break

    def peek_char(self) -> str:
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def eat(self, text: str) -> bool:
        self._ws()
        if self.s.startswith(text, self.i):
            self.i += len(text)
            return True
        return False

    def expect(self, text: str) -> None:
        if not self.eat(text):
            raise SyntaxError_(f"expected {text!r} at {self.i} in promql: {self.s[self.i:self.i+30]!r}")

    def ident(self) -> str:
        self._ws()
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] in "_:"):
            j += 1
        if j == self.i:
            raise SyntaxError_(f"expected identifier at {self.i}")
        out = self.s[self.i:j]
        self.i = j
        return out

    def peek_ident(self) -> str:
        save = self.i
        self._ws()
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] in "_:"):
            j += 1
        out = self.s[self.i:j]
        self.i = save
        return out

    def string(self) -> str:
        self._ws()
        if self.i >= len(self.s):
            raise SyntaxError_("unexpected end of promql (expected string)")
        q = self.s[self.i]
        if q not in "'\"`":
            raise SyntaxError_(f"expected string at {self.i}")
        j = self.i + 1
        buf = []
        while j < len(self.s):
            c = self.s[j]
            if c == "\\" and j + 1 < len(self.s):
                nxt = self.s[j + 1]
                buf.append({"n": "\n", "t": "\t", "\\": "\\", q: q}.get(nxt, "\\" + nxt))
                j += 2
                continue
            if c == q:
                self.i = j + 1
                return "".join(buf)
            buf.append(c)
            j += 1
        raise SyntaxError_(f"unterminated string at {self.i}")

    def duration(self) -> float:
        """duration like 5m, 1h30m, or bare number (seconds) → seconds."""
        self._ws()
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] == "."):
            j += 1
        raw = self.s[self.i:j]
        if not raw:
            raise SyntaxError_(f"expected duration at {self.i}")
        self.i = j
        return parse_interval_str(raw) / 1000.0

    def number(self) -> float:
        self._ws()
        j = self.i
        if j < len(self.s) and self.s[j] in "+-":
            j += 1
        if self.s.startswith(("0x", "0X"), j):
            k = j + 2
            while k < len(self.s) and self.s[k] in "0123456789abcdefABCDEF":
                k += 1
            v = float(int(self.s[j:k], 16))
            self.i = k
            return v
        k = j
        while k < len(self.s) and (self.s[k].isdigit() or self.s[k] in ".eE+-"):
            if self.s[k] in "+-" and k > j and self.s[k - 1] not in "eE":
                break
            k += 1
        raw = self.s[j:k]
        try:
            v = float(raw)
        except ValueError:
            # Inf / NaN keywords
            word = self.peek_ident().lower()
            if word == "inf":
                self.ident()
                return float("inf")
            if word == "nan":
                self.ident()
                return float("nan")
            raise SyntaxError_(f"bad number {raw!r} at {self.i}")
        self.i = k
        return v

    # ---- grammar ---------------------------------------------------------
    def parse(self) -> PromExpr:
        e = self.expr(1)
        self._ws()
        if self.i < len(self.s):
            raise SyntaxError_(f"trailing input at {self.i}: {self.s[self.i:self.i+20]!r}")
        return e

    def expr(self, min_prec: int) -> PromExpr:
        lhs = self.unary()
        while True:
            op = self._peek_binop()
            if op is None or _PREC[op] < min_prec:
                return lhs
            self._eat_binop(op)
            bool_mod = False
            if self.peek_ident() == "bool":
                self.ident()
                bool_mod = True
            on = ignoring = None
            if self.peek_ident() in ("on", "ignoring"):
                kw = self.ident()
                labels = self._label_list()
                if kw == "on":
                    on = labels
                else:
                    ignoring = labels
            gl = gr = None
            if self.peek_ident() in ("group_left", "group_right"):
                kw = self.ident()
                labels = []
                if self.peek_char() == "(":
                    labels = self._label_list()
                if kw == "group_left":
                    gl = labels
                else:
                    gr = labels
            # right-assoc for ^, left otherwise
            nxt = _PREC[op] + (0 if op == "^" else 1)
            rhs = self.expr(nxt)
            lhs = BinaryExpr(op, lhs, rhs, bool_mod, on, ignoring, gl, gr)

    def _peek_binop(self) -> str | None:
        self._ws()
        for op in ("==", "!=", "<=", ">=", "<", ">", "+", "-", "*", "/", "%", "^"):
            if self.s.startswith(op, self.i):
                return op
        w = self.peek_ident()
        if w in ("and", "or", "unless", "atan2"):
            return w
        return None

    def _eat_binop(self, op: str) -> None:
        self._ws()
        if op in ("and", "or", "unless", "atan2"):
            self.ident()
        else:
            self.i += len(op)

    def _label_list(self) -> list[str]:
        self.expect("(")
        out = []
        if not self.eat(")"):
            out.append(self.ident())
            while self.eat(","):
                out.append(self.ident())
            self.expect(")")
        return out

    def unary(self) -> PromExpr:
        if self.eat("-"):
            return UnaryExpr("-", self.unary())
        if self.eat("+"):
            return self.unary()
        return self.postfix(self.atom())

    def postfix(self, e: PromExpr) -> PromExpr:
        while True:
            self._ws()
            if self.peek_char() == "[":
                self.expect("[")
                rng = self.duration()
                if self.eat(":"):
                    step = None
                    self._ws()
                    if self.peek_char() != "]":
                        step = self.duration()
                    self.expect("]")
                    e = SubqueryExpr(e, rng, step)
                else:
                    self.expect("]")
                    if isinstance(e, VectorSelector):
                        e.range_s = rng
                    else:
                        raise SyntaxError_("range on non-selector")
                continue
            w = self.peek_ident()
            if w == "offset":
                self.ident()
                neg = self.eat("-")
                off = self.duration()
                off = -off if neg else off
                if isinstance(e, VectorSelector):
                    e.offset_s = off
                elif isinstance(e, SubqueryExpr):
                    e.offset_s = off
                else:
                    raise SyntaxError_("offset on non-selector")
                continue
            if self.peek_char() == "@":
                self.expect("@")
                at = self.number()
                if isinstance(e, VectorSelector):
                    e.at_ts = at
                else:
                    raise SyntaxError_("@ on non-selector")
                continue
            return e

    def atom(self) -> PromExpr:
        self._ws()
        c = self.peek_char()
        if c == "(":
            self.expect("(")
            e = self.expr(1)
            self.expect(")")
            return e
        if c in "'\"":
            return StringLit(self.string())
        if c.isdigit() or (c == "." and self.i + 1 < len(self.s)):
            return NumberLit(self.number())
        if c == "{":
            # metric-less selector {__name__=...}
            matchers = self._matchers()
            metric = ""
            for m in matchers:
                if m.name == "__name__" and m.op == "=":
                    metric = m.value
            matchers = [m for m in matchers if m.name != "__name__"]
            return self.postfix(VectorSelector(metric, matchers))
        name = self.ident()
        low = name.lower()
        if low in ("inf", "nan"):
            return NumberLit(float(low))
        self._ws()
        if low in AGG_OPS and self.peek_char() in "(bw":
            # aggregation: op [by/without (...)] (expr) | op(...) [by/without]
            grouping: list[str] = []
            without = False
            if self.peek_ident() in ("by", "without"):
                kw = self.ident()
                without = kw == "without"
                grouping = self._label_list()
            self.expect("(")
            param = None
            first = self.expr(1)
            if low in PARAM_AGGS:
                param = first
                self.expect(",")
                inner = self.expr(1)
            else:
                inner = first
            self.expect(")")
            if not grouping and not without and self.peek_ident() in ("by", "without"):
                kw = self.ident()
                without = kw == "without"
                grouping = self._label_list()
            return Aggregation(low, inner, param, grouping, without)
        if self.peek_char() == "(" and low not in AGG_OPS:
            self.expect("(")
            args: list[PromExpr] = []
            self._ws()
            if self.peek_char() != ")":
                args.append(self.expr(1))
                while self.eat(","):
                    args.append(self.expr(1))
            self.expect(")")
            return FunctionCall(low, args)
        matchers = []
        if self.peek_char() == "{":
            matchers = self._matchers()
        return VectorSelector(name, matchers)

    def _matchers(self) -> list[LabelMatcher]:
        self.expect("{")
        out: list[LabelMatcher] = []
        self._ws()
        if self.peek_char() == "}":
            self.expect("}")
            return out
        while True:
            name = self.ident()
            self._ws()
            op = None
            for cand in ("=~", "!~", "!=", "="):
                if self.s.startswith(cand, self.i):
                    op = cand
                    self.i += len(cand)
                    break
            if op is None:
                raise SyntaxError_(f"expected matcher op at {self.i}")
            if op == "=" and self.s.startswith("=", self.i):  # ==
                raise SyntaxError_(f"bad matcher at {self.i}")
            value = self.string()
            out.append(LabelMatcher(name, op, value))
            if not self.eat(","):
                break
            self._ws()
            if self.peek_char() == "}":
                break
        self.expect("}")
        return out


def parse_promql(s: str) -> PromExpr:
    return PromParser(s).parse()
