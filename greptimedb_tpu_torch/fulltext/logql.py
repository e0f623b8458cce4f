"""LogQL subset parser (reference: src/log-query/ + Grafana Loki's
query language, the dialect src/servers/src/http/loki.rs serves).

Supported grammar:

    expr        := vector_agg | range_agg | log_query
    vector_agg  := AGG grouping? '(' range_agg ')'
                 | AGG '(' range_agg ')' grouping
    grouping    := ('by' | 'without') '(' label (',' label)* ')'
    range_agg   := RANGE_FN '(' log_query '[' DURATION ']' ')'
    log_query   := selector stage*
    selector    := '{' matcher (',' matcher)* '}'
    matcher     := LABEL ('=' | '!=' | '=~' | '!~') STRING
    stage       := line_filter | parser_stage | label_filter
    line_filter := ('|=' | '!=' | '|~' | '!~') STRING
    parser_stage:= '|' ('json' | 'logfmt')
    label_filter:= '|' LABEL cmp (STRING | NUMBER | DURATION)
    cmp         := '=' | '==' | '!=' | '=~' | '!~' | '>' | '>=' | '<' | '<='

    AGG      := sum | min | max | avg | count
    RANGE_FN := count_over_time | rate | bytes_over_time | bytes_rate

Semantics notes (pinned by the parser goldens): line filters always
apply to the ORIGINAL log line wherever they appear in the pipeline
(Loki semantics); label filters after a parser stage see extracted
fields, before one they see stream labels; metric range windows are
left-exclusive ``(t - range, t]`` — the same definition the PromQL
window kernels implement."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from greptimedb_tpu_torch.errors import InvalidArguments

RANGE_FNS = ("count_over_time", "rate", "bytes_over_time", "bytes_rate")
VECTOR_AGGS = ("sum", "min", "max", "avg", "count")
LINE_FILTER_OPS = ("|=", "!=", "|~", "!~")
MATCHER_OPS = ("=", "!=", "=~", "!~")
CMP_OPS = ("=", "==", "!=", "=~", "!~", ">", ">=", "<", "<=")


@dataclass(frozen=True)
class Matcher:
    name: str
    op: str  # = != =~ !~
    value: str


@dataclass(frozen=True)
class LineFilter:
    op: str  # |= != |~ !~
    text: str


@dataclass(frozen=True)
class ParserStage:
    kind: str  # json | logfmt


@dataclass(frozen=True)
class LabelFilter:
    name: str
    op: str
    value: str
    numeric: bool = False


@dataclass(frozen=True)
class LogQuery:
    matchers: tuple[Matcher, ...]
    stages: tuple = ()

    @property
    def line_filters(self) -> tuple[LineFilter, ...]:
        return tuple(s for s in self.stages if isinstance(s, LineFilter))

    @property
    def needs_rows(self) -> bool:
        """True when any stage needs per-row host work (parser stages /
        label filters) — the evaluator's host tier."""
        return any(isinstance(s, (ParserStage, LabelFilter))
                   for s in self.stages)


@dataclass(frozen=True)
class RangeAgg:
    fn: str
    query: LogQuery
    range_ms: int


@dataclass(frozen=True)
class VectorAgg:
    fn: str
    inner: RangeAgg
    grouping: tuple[str, ...] = ()
    without: bool = False
    grouped: bool = False  # bare sum(...) vs sum by (...) (...)


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<string>"(?:\\.|[^"\\])*"|`[^`]*`)
  | (?P<duration>\d+(?:\.\d+)?(?:ns|us|µs|ms|s|m|h|d|w)
        (?:\d+(?:\.\d+)?(?:ns|us|µs|ms|s|m|h|d|w))*)
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<op>\|=|\|~|!=|!~|=~|==|>=|<=|[{}(),\[\]=><|])
  | (?P<ident>[a-zA-Z_][a-zA-Z0-9_]*)
""", re.VERBOSE)

_DUR_MS = {"ns": 1e-6, "us": 1e-3, "µs": 1e-3, "ms": 1.0, "s": 1000.0,
           "m": 60_000.0, "h": 3_600_000.0, "d": 86_400_000.0,
           "w": 604_800_000.0}
_DUR_PART = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h|d|w)")


def parse_duration_ms(text: str) -> int:
    ms = 0.0
    pos = 0
    for m in _DUR_PART.finditer(text):
        if m.start() != pos:
            raise InvalidArguments(f"bad duration {text!r}")
        ms += float(m.group(1)) * _DUR_MS[m.group(2)]
        pos = m.end()
    if pos != len(text) or ms <= 0:
        raise InvalidArguments(f"bad duration {text!r}")
    return int(ms)


def _unquote(tok: str) -> str:
    if tok.startswith("`"):
        return tok[1:-1]
    out = []
    i = 1
    while i < len(tok) - 1:
        c = tok[i]
        if c == "\\" and i + 1 < len(tok) - 1:
            n = tok[i + 1]
            out.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                        "\\": "\\"}.get(n, "\\" + n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


@dataclass
class _Lexer:
    tokens: list[tuple[str, str]] = field(default_factory=list)
    pos: int = 0

    def peek(self) -> tuple[str, str] | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> tuple[str, str]:
        t = self.peek()
        if t is None:
            raise InvalidArguments("unexpected end of LogQL query")
        self.pos += 1
        return t

    def expect(self, value: str) -> None:
        kind, v = self.next()
        if v != value:
            raise InvalidArguments(f"expected {value!r}, got {v!r}")


def _lex(q: str) -> _Lexer:
    toks: list[tuple[str, str]] = []
    pos = 0
    while pos < len(q):
        m = _TOKEN_RE.match(q, pos)
        if m is None:
            raise InvalidArguments(f"bad LogQL at {q[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append((kind, m.group()))
    return _Lexer(toks)


def _parse_selector(lx: _Lexer) -> tuple[Matcher, ...]:
    lx.expect("{")
    matchers = []
    t = lx.peek()
    if t is not None and t[1] == "}":
        lx.next()
        return ()
    while True:
        kind, name = lx.next()
        if kind != "ident":
            raise InvalidArguments(f"expected label name, got {name!r}")
        _k, op = lx.next()
        if op not in MATCHER_OPS:
            raise InvalidArguments(f"bad matcher op {op!r}")
        vkind, vtok = lx.next()
        if vkind != "string":
            raise InvalidArguments(f"matcher value must be quoted: {vtok!r}")
        matchers.append(Matcher(name, op, _unquote(vtok)))
        _k, sep = lx.next()
        if sep == "}":
            return tuple(matchers)
        if sep != ",":
            raise InvalidArguments(f"expected , or }} in selector, got {sep!r}")


def _parse_stages(lx: _Lexer) -> tuple:
    stages: list = []
    while True:
        t = lx.peek()
        if t is None:
            break
        kind, v = t
        if v in ("|=", "|~", "!=", "!~"):
            lx.next()
            skind, stok = lx.next()
            if skind != "string":
                raise InvalidArguments(
                    f"line filter needs a quoted string, got {stok!r}")
            stages.append(LineFilter(v, _unquote(stok)))
        elif v == "|":
            lx.next()
            ikind, ident = lx.next()
            if ikind != "ident":
                raise InvalidArguments(f"bad pipeline stage {ident!r}")
            if ident in ("json", "logfmt"):
                stages.append(ParserStage(ident))
                continue
            _k, op = lx.next()
            if op not in CMP_OPS:
                raise InvalidArguments(f"bad label-filter op {op!r}")
            vkind, vtok = lx.next()
            if vkind == "string":
                if op in (">", ">=", "<", "<="):
                    raise InvalidArguments(
                        f"ordered comparison {op} needs a number")
                stages.append(LabelFilter(ident, op, _unquote(vtok)))
            elif vkind in ("number", "duration"):
                if op in ("=~", "!~"):
                    raise InvalidArguments(
                        f"regex label filter needs a quoted string")
                val = (str(parse_duration_ms(vtok) / 1000.0)
                       if vkind == "duration" else vtok)
                stages.append(LabelFilter(ident, "==" if op == "=" else op,
                                          val, numeric=True))
            else:
                raise InvalidArguments(f"bad label-filter value {vtok!r}")
        else:
            break
    return tuple(stages)


def _parse_log_query(lx: _Lexer) -> LogQuery:
    return LogQuery(_parse_selector(lx), _parse_stages(lx))


def _parse_range_agg(lx: _Lexer, fn: str) -> RangeAgg:
    lx.expect("(")
    inner = _parse_log_query(lx)
    lx.expect("[")
    dkind, dtok = lx.next()
    if dkind not in ("duration", "number"):
        raise InvalidArguments(f"bad range duration {dtok!r}")
    range_ms = (parse_duration_ms(dtok) if dkind == "duration"
                else int(float(dtok) * 1000))
    lx.expect("]")
    lx.expect(")")
    return RangeAgg(fn, inner, range_ms)


def _parse_grouping(lx: _Lexer) -> tuple[tuple[str, ...], bool]:
    _k, kw = lx.next()
    without = kw == "without"
    lx.expect("(")
    labels = []
    t = lx.peek()
    if t is not None and t[1] == ")":
        lx.next()
        return (), without
    while True:
        kind, name = lx.next()
        if kind != "ident":
            raise InvalidArguments(f"bad grouping label {name!r}")
        labels.append(name)
        _k, sep = lx.next()
        if sep == ")":
            return tuple(labels), without
        if sep != ",":
            raise InvalidArguments(f"expected , or ) in grouping")


def parse_logql(q: str):
    """Parse one LogQL expression → LogQuery | RangeAgg | VectorAgg."""
    lx = _lex(q)
    t = lx.peek()
    if t is None:
        raise InvalidArguments("empty LogQL query")
    kind, v = t
    if v == "{":
        out = _parse_log_query(lx)
    elif kind == "ident" and v in RANGE_FNS:
        lx.next()
        out = _parse_range_agg(lx, v)
    elif kind == "ident" and v in VECTOR_AGGS:
        lx.next()
        grouping, without, grouped = (), False, False
        nt = lx.peek()
        if nt is not None and nt[1] in ("by", "without"):
            grouping, without = _parse_grouping(lx)
            grouped = True
        lx.expect("(")
        fkind, fv = lx.next()
        if fkind != "ident" or fv not in RANGE_FNS:
            raise InvalidArguments(
                f"vector aggregation needs a range function, got {fv!r}")
        inner = _parse_range_agg(lx, fv)
        lx.expect(")")
        if not grouped:
            nt = lx.peek()
            if nt is not None and nt[1] in ("by", "without"):
                grouping, without = _parse_grouping(lx)
                grouped = True
        out = VectorAgg(v, inner, grouping, without, grouped)
    else:
        raise InvalidArguments(f"bad LogQL expression start {v!r}")
    if lx.peek() is not None:
        raise InvalidArguments(
            f"trailing tokens in LogQL query: {lx.peek()[1]!r}")
    return out
