"""SQL AST: expressions and statements.

Statement coverage mirrors the reference's sql crate surface that matters
for round-trip compatibility (src/sql/src/statements/): query, DML, DDL
(tables/databases/flows), SHOW/DESCRIBE introspection, TQL (PromQL-in-SQL,
src/sql/src/statements/tql.rs), EXPLAIN, COPY, and admin function calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field


# ---- expressions -----------------------------------------------------------

class Expr:
    pass


@dataclass(frozen=True)
class Column(Expr):
    name: str
    table: str | None = None

    def __str__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass(frozen=True)
class Literal(Expr):
    value: object  # int | float | str | bool | None

    def __str__(self):
        if isinstance(self.value, str):
            return "'" + self.value.replace("'", "''") + "'"
        if self.value is None:
            return "NULL"
        return str(self.value)


@dataclass(frozen=True)
class IntervalLit(Expr):
    """Interval normalized to milliseconds (fixed-width units only)."""

    ms: int
    raw: str = ""

    def __str__(self):
        return f"INTERVAL '{self.raw}'"


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # + - * / % = != < <= > >= AND OR LIKE IN ...
    left: Expr
    right: Expr

    def __str__(self):
        return f"{self.left} {self.op} {self.right}"


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # NOT, -
    operand: Expr

    def __str__(self):
        return f"{self.op} {self.operand}"


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str  # lowercase
    args: tuple[Expr, ...] = ()
    distinct: bool = False

    def __str__(self):
        inner = ", ".join(str(a) for a in self.args)
        if self.distinct:
            inner = "DISTINCT " + inner
        return f"{self.name}({inner})"


@dataclass(frozen=True)
class Star(Expr):
    table: str | None = None

    def __str__(self):
        return "*"


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def __str__(self):
        n = " NOT" if self.negated else ""
        return f"{self.expr}{n} BETWEEN {self.low} AND {self.high}"


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: tuple[Expr, ...]
    negated: bool = False

    def __str__(self):
        n = " NOT" if self.negated else ""
        return f"{self.expr}{n} IN ({', '.join(map(str, self.items))})"


@dataclass(frozen=True)
class TupleIn(Expr):
    """Row-tuple membership: (e1, …, ek) IN {(v11, …, v1k), …}.

    Not parseable SQL — produced by multi-key correlated EXISTS/IN
    decorrelation (the reference reaches the same semantics through
    DataFusion's semi-join rewrite, src/query/src/planner.rs).  ``rows``
    are plain python value tuples (NULL-free: a NULL never equals)."""

    exprs: tuple[Expr, ...]
    rows: tuple[tuple, ...]
    negated: bool = False

    def __str__(self):
        n = " NOT" if self.negated else ""
        es = ", ".join(map(str, self.exprs))
        return f"({es}){n} IN <{len(self.rows)} tuples>"


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False

    def __str__(self):
        return f"{self.expr} IS {'NOT ' if self.negated else ''}NULL"


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    type_name: str

    def __str__(self):
        return f"CAST({self.expr} AS {self.type_name})"


@dataclass(frozen=True)
class Case(Expr):
    operand: Expr | None
    whens: tuple[tuple[Expr, Expr], ...]
    else_: Expr | None

    def __str__(self):
        return "CASE ... END"


# ---- statements ------------------------------------------------------------

class Statement:
    pass


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: str | None = None
    # range-select extension: `agg(x) RANGE '5m' [FILL ...]` per item
    # (reference src/query/src/range_select/plan.rs)
    range_: "IntervalLit | None" = None
    fill: str | None = None

    @property
    def output_name(self) -> str:
        return self.alias if self.alias else str(self.expr)


@dataclass(frozen=True)
class OrderByItem:
    expr: Expr
    asc: bool = True
    nulls_first: bool | None = None


@dataclass(frozen=True)
class WindowSpec:
    """OVER (PARTITION BY ... ORDER BY ...) — unbounded frames only
    (reference gets frames from DataFusion's WindowExpr; the TPU engine
    computes windows as vectorized partition-sorted passes)."""

    partition_by: tuple[Expr, ...] = ()
    order_by: tuple[OrderByItem, ...] = ()

    def __str__(self):
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY "
                         + ", ".join(str(p) for p in self.partition_by))
        if self.order_by:
            parts.append("ORDER BY " + ", ".join(
                f"{o.expr}{'' if o.asc else ' DESC'}" for o in self.order_by))
        return " ".join(parts)


@dataclass(frozen=True)
class WindowFunc(Expr):
    """`fn(args) OVER (spec)` — row_number/rank/dense_rank/lag/lead/
    first_value/last_value and windowed sum/avg/count/min/max."""

    name: str  # lowercase
    args: tuple[Expr, ...] = ()
    spec: WindowSpec = WindowSpec()

    def __str__(self):
        inner = ", ".join(str(a) for a in self.args)
        return f"{self.name}({inner}) OVER ({self.spec})"


@dataclass
class JoinClause:
    """INNER / LEFT [OUTER] equi-join (reference: DataFusion joins via
    src/query/src/datafusion.rs; promql_tsid_narrow_join optimizer)."""

    table: str
    alias: str | None
    on: "Expr"
    kind: str = "inner"  # "inner" | "left"


@dataclass
class Select(Statement):
    items: list[SelectItem]
    table: str | None = None  # None for SELECT 1 / SELECT now()
    table_alias: str | None = None
    joins: list[JoinClause] = field(default_factory=list)
    where: Expr | None = None
    group_by: list[Expr] = field(default_factory=list)
    having: Expr | None = None
    order_by: list[OrderByItem] = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    distinct: bool = False
    # range-select extension (reference RANGE queries, range_select/plan.rs)
    align: IntervalLit | None = None
    align_by: list[Expr] = field(default_factory=list)
    range_: IntervalLit | None = None
    fill: str | None = None
    # FROM (SELECT …) [alias] — derived table; table carries the alias
    from_subquery: "Select | None" = None


def _map_child(v, fn):
    if isinstance(v, Expr):
        return map_expr(v, fn)
    if isinstance(v, (WindowSpec, OrderByItem)):
        # expression carriers that aren't Exprs themselves: rebuild with
        # mapped children so OVER(PARTITION BY ... ORDER BY ...) is
        # reachable by every map_expr pass (join rewrites, subqueries)
        import dataclasses as _dc

        changes = {}
        for f in _dc.fields(v):
            cv = getattr(v, f.name)
            nv = _map_child(cv, fn)
            if nv is not cv:
                changes[f.name] = nv
        return _dc.replace(v, **changes) if changes else v
    if isinstance(v, tuple):
        nv = tuple(_map_child(x, fn) for x in v)
        return nv if any(a is not b for a, b in zip(nv, v)) else v
    if isinstance(v, list):
        nv = [_map_child(x, fn) for x in v]
        return nv if any(a is not b for a, b in zip(nv, v)) else v
    return v


def map_expr(e, fn):
    """Bottom-up structural transform over an Expr tree.

    Descends every dataclass field, including nested tuples/lists (e.g.
    ``Case.whens`` is a tuple of (cond, result) tuples), then applies
    ``fn`` to the (child-transformed) node.  Nodes are rebuilt only when a
    child changed.  The ONE tree walker — subquery resolution, join column
    rewriting and any future pass share it, so shape handling can never
    diverge.
    """
    import dataclasses as _dc

    if not (_dc.is_dataclass(e) and isinstance(e, Expr)):
        return e
    changes = {}
    for f in _dc.fields(e):
        v = getattr(e, f.name)
        nv = _map_child(v, fn)
        if nv is not v:
            changes[f.name] = nv
    e2 = _dc.replace(e, **changes) if changes else e
    return fn(e2)


def walk_columns(e) -> list:
    """All Column nodes in an expression tree (shared walker client)."""
    out: list = []

    def visit(node):
        if isinstance(node, Column):
            out.append(node)
        return node

    map_expr(e, visit)
    return out


def split_conjuncts(e) -> list:
    """Flatten a WHERE tree into its AND-ed conjuncts (empty for None)."""
    if e is None:
        return []
    if isinstance(e, BinaryOp) and e.op.upper() == "AND":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def expr_contains(e, types) -> bool:
    """True when any node in the tree is an instance of ``types``."""
    found = False

    def probe(x):
        nonlocal found
        if isinstance(x, types):
            found = True
        return x

    map_expr(e, probe)
    return found


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    """(SELECT single_value ...) used as an expression; resolved to a
    Literal before planning (the reference evaluates these via DataFusion
    subquery decorrelation — ours requires them to be uncorrelated)."""

    select: object  # Select (untyped: ast must not import itself)

    def __str__(self):
        return "(<subquery>)"


@dataclass(frozen=True)
class Exists(Expr):
    """[NOT] EXISTS (SELECT ...). Uncorrelated forms resolve to a
    boolean Literal; equality-correlated forms decorrelate to an InList
    membership test (the reference relies on DataFusion's subquery
    decorrelation, src/query/src/datafusion.rs)."""

    select: object

    def __str__(self):
        return "EXISTS (...)"


@dataclass(frozen=True)
class InSubquery(Expr):
    """expr [NOT] IN (SELECT one_column ...); resolved to InList before
    planning."""

    expr: Expr
    select: object
    negated: bool = False

    def __str__(self):
        n = " NOT" if self.negated else ""
        return f"{self.expr}{n} IN (<subquery>)"


@dataclass
class Union(Statement):
    """Set operation chain; trailing ORDER BY/LIMIT apply to the whole
    statement (reference: DataFusion set operations via
    src/query/src/datafusion.rs).  ``op`` is "union" | "intersect" |
    "except"; UNION chains stay flat (selects may hold >2 members),
    INTERSECT/EXCEPT and mixed chains nest left-associatively with
    INTERSECT binding tighter, so ``selects`` members may themselves be
    Union statements."""

    selects: list  # list[Select | Union]
    all: bool = False
    order_by: list[OrderByItem] = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None
    op: str = "union"  # "union" | "intersect" | "except"


@dataclass
class ColumnDef:
    name: str
    type_name: str
    nullable: bool = True
    default: object = None
    comment: str | None = None


@dataclass
class CreateTable(Statement):
    name: str
    columns: list[ColumnDef]
    time_index: str | None
    primary_keys: list[str]
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)
    partitions: list[str] = field(default_factory=list)
    partition_columns: list[str] = field(default_factory=list)
    engine: str = "mito"


@dataclass
class CreateDatabase(Statement):
    name: str
    if_not_exists: bool = False


@dataclass
class Insert(Statement):
    table: str
    columns: list[str]
    rows: list[list[object]]
    select: "Select | None" = None  # INSERT INTO … SELECT …


@dataclass
class Delete(Statement):
    table: str
    where: Expr | None


@dataclass
class DropTable(Statement):
    names: list[str]
    if_exists: bool = False


@dataclass
class DropDatabase(Statement):
    name: str
    if_exists: bool = False


@dataclass
class AlterTable(Statement):
    table: str
    action: str  # add_column | drop_column | rename | set_options | unset_option
    column: ColumnDef | None = None
    name: str | None = None  # drop column name / rename target / option key
    options: dict | None = None  # set_options payload (e.g. {'ttl': '1d'})


@dataclass
class CreateView(Statement):
    """CREATE [OR REPLACE] VIEW name AS <select> (reference
    src/common/meta/src/ddl/create_view.rs). ``definition`` keeps the
    SELECT's verbatim SQL text — the kv-stored form, re-parsed and
    expanded at query time."""

    name: str
    definition: str
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class DropView(Statement):
    name: str
    if_exists: bool = False


@dataclass
class ShowTables(Statement):
    database: str | None = None
    like: str | None = None
    full: bool = False  # SHOW FULL TABLES: adds Table_type


@dataclass
class ShowColumns(Statement):
    table: str = ""


@dataclass
class ShowIndex(Statement):
    table: str = ""


@dataclass
class ShowDatabases(Statement):
    like: str | None = None


@dataclass
class ShowCreateTable(Statement):
    table: str
    view: bool = False  # SHOW CREATE VIEW


@dataclass
class DescribeTable(Statement):
    table: str


@dataclass
class Use(Statement):
    database: str


@dataclass
class Admin(Statement):
    """ADMIN fn(args...) — management functions run as statements
    (reference src/common/function/src/admin/: flush/compact/reconcile,
    statements/admin.rs)."""

    func: str  # lowercase
    args: tuple = ()  # literal values


@dataclass
class Tql(Statement):
    """TQL EVAL (start, end, step) <promql> — reference statements/tql.rs."""

    command: str  # EVAL | ANALYZE | EXPLAIN
    start: float
    end: float
    step: float
    query: str
    lookback: float | None = None


@dataclass
class Explain(Statement):
    inner: Statement
    analyze: bool = False


@dataclass
class TruncateTable(Statement):
    table: str


@dataclass
class CreateFlow(Statement):
    name: str
    sink_table: str
    query: Select
    expire_after: IntervalLit | None = None
    comment: str | None = None
    if_not_exists: bool = False


@dataclass
class DropFlow(Statement):
    name: str
    if_exists: bool = False


@dataclass
class ShowFlows(Statement):
    pass


@dataclass
class ShowProcesslist(Statement):
    """SHOW [FULL] PROCESSLIST (reference show_processlist, backed by the
    ProcessManager registry)."""

    full: bool = False


@dataclass
class Kill(Statement):
    """KILL [QUERY] <id> — cooperative query cancellation (reference
    src/catalog/src/process_manager.rs + statements/kill.rs)."""

    process_id: str


@dataclass
class SetVar(Statement):
    """SET [SESSION|GLOBAL] name = value (time_zone handled; others no-op
    for client compatibility, like the reference)."""

    name: str
    value: str


@dataclass
class Copy(Statement):
    """COPY <table> TO|FROM '<path>' [WITH (format='parquet'|'csv'|'json')]
    (reference src/operator/src/statement/copy_table_{to,from}.rs)."""

    table: str
    path: str
    direction: str  # "to" | "from"
    options: dict = field(default_factory=dict)
