"""Standalone database: the port's components wired in one process.

Trimmed counterpart of the reference's ``standalone.py``: ``GreptimeDB``
with ``sql()`` for CREATE TABLE, INSERT, SELECT (dense grid and row path),
TQL EVAL (PromQL, ``promql/engine.py``) and DESCRIBE over single-region
tables, on the storage, metadata and
query modules of this package.  Method and attribute names are the
reference's, so code written against it runs here unchanged apart from
the import.  The device comes from ``device.resolve_device``: the card
unless the caller passes ``device="cpu"``.

Not ported yet (the reference's ``__init__`` wires them up): flows, the
serving scheduler, SLO observatory, scrubber, metric and file engines,
partitioned tables, views, the mesh, the compile cache and the servers.
"""

from __future__ import annotations

import os
import threading

from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType, SemanticType
from greptimedb_tpu_torch.device import resolve_device
from greptimedb_tpu_torch.errors import (
    InvalidArguments, Unsupported,
)
from greptimedb_tpu_torch.meta.catalog import DEFAULT_DB, CatalogManager
from greptimedb_tpu_torch.meta.kv import FileKv, KvBackend, MemoryKv
from greptimedb_tpu_torch.query.ast import (
    CreateDatabase, CreateTable, DescribeTable, Insert, Select, Statement,
    Tql,
)
from greptimedb_tpu_torch.query.engine import QueryEngine, QueryResult, TableProvider
from greptimedb_tpu_torch.query.exprs import TableContext
from greptimedb_tpu_torch.query.parser import parse_sql
from greptimedb_tpu_torch.query.planner import SelectPlan
from greptimedb_tpu_torch.storage.cache import (
    PromLayoutCache, RegionCacheManager,
)
from greptimedb_tpu_torch.storage.region import RegionEngine, RegionOptions


def schema_from_create(stmt: "CreateTable") -> Schema:
    """CREATE TABLE statement → Schema (time index + tags + fields);
    shared by the standalone executor and the distributed frontend."""
    time_index = stmt.time_index
    cols: list[ColumnSchema] = []
    for cd in stmt.columns:
        dtype = ConcreteDataType.parse(cd.type_name)
        if cd.name == time_index:
            semantic = SemanticType.TIMESTAMP
            if not dtype.is_timestamp:
                raise InvalidArguments(
                    f"time index {cd.name} must be a timestamp, got {cd.type_name}"
                )
        elif cd.name in stmt.primary_keys:
            semantic = SemanticType.TAG
        else:
            semantic = SemanticType.FIELD
        cols.append(
            ColumnSchema(
                cd.name, dtype, semantic,
                nullable=cd.nullable and semantic is not SemanticType.TIMESTAMP,
                default=cd.default,
            )
        )
    schema = Schema(tuple(cols))
    if schema.time_index is None:
        raise InvalidArguments("missing TIME INDEX")
    return schema


def insert_rows_to_columns(
    stmt: "Insert", schema: Schema, timezone: str = "UTC"
) -> tuple[list[str], dict[str, list]]:
    """INSERT statement → validated column lists (timestamp strings
    localized to epoch ints); shared by the standalone executor and the
    distributed frontend."""
    columns = stmt.columns or [c.name for c in schema]
    if any(not schema.has_column(c) for c in columns):
        bad = [c for c in columns if not schema.has_column(c)]
        raise InvalidArguments(f"unknown insert columns {bad}")
    data: dict[str, list] = {c: [] for c in columns}
    for row in stmt.rows:
        if len(row) != len(columns):
            raise InvalidArguments(
                f"row has {len(row)} values, expected {len(columns)}"
            )
        for c, v in zip(columns, row):
            data[c].append(v)
    ts_name = schema.time_index.name
    if ts_name in data:
        ctx = TableContext(schema, {}, timezone)
        data[ts_name] = [ctx.ts_literal(v) for v in data[ts_name]]
    return columns, data


class GreptimeDB(TableProvider):
    """The standalone instance: SQL in, results out."""

    def __init__(
        self,
        data_home: str | None = None,
        *,
        region_options: RegionOptions | None = None,
        cache_capacity_bytes: int = 8 << 30,
        device=None,
    ):
        """``device``: None or "cuda" → the CUDA card (raises when there is
        none); "cpu" → the CPU (the plain versions of the kernels)."""
        self.device = resolve_device(device)
        self.memory_mode = data_home is None
        if data_home is None:
            import tempfile

            self._tmp = tempfile.TemporaryDirectory(
                prefix="greptimedb_tpu_torch_")
            data_home = self._tmp.name
        self.data_home = data_home
        os.makedirs(data_home, exist_ok=True)
        self.kv: KvBackend = (
            MemoryKv()
            if self.memory_mode
            else FileKv(os.path.join(data_home, "metadata", "kv.json"))
        )
        self.catalog = CatalogManager(self.kv)
        self.regions = RegionEngine(
            os.path.join(data_home, "data"), region_options
        )
        self.cache = RegionCacheManager(cache_capacity_bytes,
                                        device=self.device)
        self.engine = QueryEngine(self)
        # a region leaving residency drops its derived bucket-major layouts
        self.cache.derived_layouts = self.engine.executor.layout_cache
        # resident PromQL evaluation state (selections, sort layouts,
        # group ids); a region leaving residency drops it too
        self.promql_cache = PromLayoutCache()
        self.cache.promql_derived = self.promql_cache
        self.current_db = DEFAULT_DB
        # the storage engine is single-writer (region sequence assignment
        # and memtable mutation are unsynchronized); statements serialize
        # on this lock
        self._lock = threading.RLock()
        self.timezone = "UTC"
        # journaled DDL (reference ddl_manager.rs:99): CREATE TABLE runs as
        # a resumable procedure; RUNNING journals from a crashed process
        # resume here at startup
        from greptimedb_tpu_torch.meta.ddl import CreateTableProcedure
        from greptimedb_tpu_torch.meta.procedure import ProcedureManager

        self.procedures = ProcedureManager(self.kv, services={"db": self})
        self.procedures.register(CreateTableProcedure)
        try:
            resumed = self.procedures.recover()
            if resumed:
                import sys as _sys

                print(f"resumed {len(resumed)} interrupted procedure(s)",
                      file=_sys.stderr)
        except Exception as e:  # noqa: BLE001 (startup must not die on a
            # poisoned procedure; it stays journaled for inspection)
            import sys as _sys

            print(f"procedure recovery failed: {e}", file=_sys.stderr)

    def close(self, flush: bool = False) -> None:
        """Close region WAL handles (``flush=True`` flushes dirty regions
        first) and the kv store."""
        self.regions.close(flush=flush)
        if hasattr(self.kv, "close"):
            self.kv.close()

    # ---- TableProvider -------------------------------------------------
    def _split_name(self, table: str) -> tuple[str, str]:
        if "." in table:
            db, name = table.rsplit(".", 1)
            return db, name
        return self.current_db, table

    def _open_or_create(self, region_id: int, schema):
        try:
            return self.regions.open_region(region_id)
        except Exception:
            return self.regions.create_region(region_id, schema)

    def _regions_of(self, table: str) -> list:
        db, name = self._split_name(table)
        info = self.catalog.get_table(db, name)
        return [self._open_or_create(rid, info.schema) for rid in info.region_ids]

    def _region_of(self, table: str):
        return self._regions_of(table)[0]

    def _table_view(self, table: str):
        """The table's single region (partitioned, metric-engine and file
        tables are not ported yet)."""
        db, name = self._split_name(table)
        info = self.catalog.get_table(db, name)
        if info.engine != "mito":
            raise Unsupported(f"{info.engine} engine tables not ported yet")
        regions = self._regions_of(table)
        if len(regions) != 1:
            raise Unsupported("partitioned tables not ported yet")
        return regions[0]

    def table_context(self, table: str) -> TableContext:
        view = self._table_view(table)
        return TableContext(view.schema, view.encoders, self.timezone)

    def device_table(self, table: str, plan: SelectPlan):
        """The row path's resident DeviceTable (storage/cache.py) and the
        region's ts bounds."""
        view = self._table_view(table)
        return self.cache.get(view), view.ts_bounds() or (0, 0)

    def grid_table(self, table: str, plan: SelectPlan):
        """Dense time-grid resident table (storage/grid.py) for eligible
        single-region tables; (None, bounds) otherwise — the engine then
        takes the row path."""
        view = self._table_view(table)
        gt = self.cache.get_grid(view)
        return gt, view.ts_bounds() or (0, 0)

    # ---- SQL entry -----------------------------------------------------
    def sql(self, query: str) -> QueryResult:
        """Execute one or more statements; returns the LAST result."""
        from greptimedb_tpu_torch.utils.tracing import TRACER

        with TRACER.stage("parse"):
            stmts = parse_sql(query)
        with self._lock:
            result = QueryResult([], [])
            for stmt in stmts:
                with TRACER.stage("execute_statement",
                                  kind=type(stmt).__name__):
                    result = self.execute_statement(stmt)
            return result

    def execute_statement(self, stmt: Statement) -> QueryResult:
        if isinstance(stmt, Select):
            if stmt.from_subquery is not None:
                raise Unsupported("derived tables not ported yet")
            if stmt.table is not None:
                db, _name = self._split_name(stmt.table)
                if db.lower() in ("information_schema", "pg_catalog"):
                    raise Unsupported("system tables not ported yet")
            return self.engine.execute_select(stmt)
        if isinstance(stmt, Tql):
            return self._execute_tql(stmt)
        if isinstance(stmt, CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, CreateDatabase):
            self.catalog.create_database(stmt.name, stmt.if_not_exists)
            return QueryResult([], [], affected_rows=1)
        if isinstance(stmt, Insert):
            return self._insert(stmt)
        if isinstance(stmt, DescribeTable):
            return self._describe(stmt)
        raise Unsupported(f"statement {type(stmt).__name__} not ported yet")

    def _execute_tql(self, stmt: Tql) -> QueryResult:
        from greptimedb_tpu_torch.promql.engine import execute_tql

        return execute_tql(self, stmt)

    # ---- DDL (journaled procedures, reference ddl_manager.rs:99) -------
    def _create_table(self, stmt: CreateTable) -> QueryResult:
        from greptimedb_tpu_torch.errors import DatabaseNotFound, TableAlreadyExists
        from greptimedb_tpu_torch.meta.ddl import CreateTableProcedure

        db, name = self._split_name(stmt.name)
        schema = schema_from_create(stmt)
        if stmt.engine != "mito":
            raise Unsupported(f"{stmt.engine} engine tables not ported yet")
        if len(stmt.partitions) > 1:
            raise Unsupported("partitioned tables not ported yet")
        # argument errors surface here, before anything is journaled.
        # This exists-precheck + submit sequence is atomic in-process:
        # every DDL statement executes under self._lock (_sql_locked), so
        # two CREATE IF NOT EXISTS cannot interleave between the check
        # and the procedure's catalog commit.
        if not self.catalog.database_exists(db):
            raise DatabaseNotFound(db)
        if self.catalog.table_exists(db, name):
            if stmt.if_not_exists:
                return QueryResult([], [], affected_rows=0)
            raise TableAlreadyExists(f"{db}.{name}")
        # append-mode table (reference WITH (append_mode='true'), the
        # log/trace model): every row kept, no (series, ts) dedup
        append = str(stmt.options.get("append_mode", "")).lower() in (
            "true", "1")
        # retention (reference WITH (ttl='7d')): validated here so a bad
        # duration fails the statement, enforced at flush/compaction
        ttl_ms = None
        if stmt.options.get("ttl"):
            from greptimedb_tpu_torch.utils.config import parse_duration_ms

            try:
                ttl_ms = parse_duration_ms(stmt.options["ttl"])
            except ValueError as e:
                raise InvalidArguments(str(e)) from None
        self.procedures.submit(CreateTableProcedure(state={
            "db": db, "name": name, "schema": schema.to_dict(),
            "engine": stmt.engine, "options": stmt.options,
            "partition_exprs": stmt.partitions,
            "partition_columns": stmt.partition_columns,
            "num_regions": max(len(stmt.partitions), 1),
            "append_mode": append,
            "ttl_ms": ttl_ms,
        }))
        return QueryResult([], [], affected_rows=0)

    def _insert(self, stmt: Insert) -> QueryResult:
        if stmt.select is not None:
            raise Unsupported("INSERT … SELECT not ported yet")
        region = self._table_view(stmt.table)
        _columns, data = insert_rows_to_columns(stmt, region.schema,
                                                self.timezone)
        region.write(data)
        return QueryResult([], [], affected_rows=len(stmt.rows))

    def _describe(self, stmt: DescribeTable) -> QueryResult:
        db, name = self._split_name(stmt.table)
        info = self.catalog.get_table(db, name)
        rows = []
        for c in info.schema:
            semantic = {
                SemanticType.TAG: "TAG",
                SemanticType.FIELD: "FIELD",
                SemanticType.TIMESTAMP: "TIMESTAMP",
            }[c.semantic]
            rows.append([
                c.name, c.dtype.value,
                "PRI" if c.semantic in (SemanticType.TAG, SemanticType.TIMESTAMP) else "",
                "YES" if c.nullable else "NO",
                c.default, semantic,
            ])
        return QueryResult(
            ["Column", "Type", "Key", "Null", "Default", "Semantic Type"], rows
        )
