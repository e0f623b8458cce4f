"""Standalone database: the port's components wired in one process.

Trimmed counterpart of the reference's ``standalone.py``: ``GreptimeDB``
with ``sql()`` for CREATE TABLE, INSERT, SELECT (dense grid and row path),
TQL EVAL (PromQL, ``promql/engine.py``) and DESCRIBE over single-region
tables, on the storage, metadata and
query modules of this package.  Method and attribute names are the
reference's, so code written against it runs here unchanged apart from
the import.  The device comes from ``device.resolve_device``: the card
unless the caller passes ``device="cpu"``.

Flows (``flow/``: CREATE FLOW, DROP FLOW, SHOW FLOWS, the device fold
and GTF1 checkpoints under ``<data_home>/flow_ckpt``) are wired as in the
reference; ``GREPTIME_FLOW_DEVICE=off`` keeps every flow on the host
engine.  Logs: ``servers.ingest.loki_push`` writes ``loki_logs``,
``fulltext.loki`` answers the Loki read API's queries, and
``db.engine.executor.fulltext_cache`` holds the fingerprint index that
SQL text predicates and LogQL line filters share.

Serving: ``db.scheduler`` (``serving/scheduler.py``, on unless
``GREPTIME_SCHEDULER=off``; its workers start on the first submit) takes
queries from client threads, admits them per tenant, orders them by
priority and coalesces concurrent shape-compatible SELECTs into one
``sql_batch`` → ``QueryEngine.execute_select_batch`` →
``Executor.execute_grid_batch`` stacked dispatch.  ``db.slo`` /
``db.idle_economy`` (``serving/slo.py``, ``serving/idle.py``) are armed
under ``GREPTIME_SLO`` (default on); the only idle consumer the port has
is the flow checkpoint drain.  ``db.processes`` lists queued and running
statements.  Not ported yet (the reference's ``__init__`` wires them
up): the AOT warmup and scrubber idle consumers, the slow-query table,
EXPLAIN ANALYZE, metric and file engines, partitioned tables, views, the
mesh's GSPMD placements (grids, PromQL rows, flow state), the compile
cache, the memory quotas and the servers.

The mesh row path (``mesh_select``, ``parallel/dist.py``): with a mesh
installed (``db.mesh = parallel.dist.create_mesh(...)``; a db never forms
one by itself), aggregates the dense grid refuses are sharded on the
series axis and merged by the ``mesh_merge`` kernel before the
single-device row path is tried.
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
    CreateDatabase, CreateFlow, CreateTable, DescribeTable, DropFlow, Insert,
    Select, ShowFlows, Statement, Tql,
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
        # the series-axis mesh (parallel/dist.py) of the mesh row path,
        # mesh_select: installed by assigning db.mesh (e.g.
        # parallel.dist.create_mesh() for one shard on each card, or
        # create_mesh(8, "cpu")), never formed by itself: on one card its
        # host fold made every measured aggregate slower than the row path.
        # GREPTIME_MESH=off forces single-device execution at query time.
        self._mesh = None
        self._dist_exec = None
        self.engine = QueryEngine(self)
        # a region leaving residency drops its derived bucket-major layouts
        self.cache.derived_layouts = self.engine.executor.layout_cache
        # resident PromQL evaluation state (selections, sort layouts,
        # group ids); a region leaving residency drops it too
        self.promql_cache = PromLayoutCache()
        self.cache.promql_derived = self.promql_cache
        # the resident fulltext fingerprint index is
        # self.engine.executor.fulltext_cache (fulltext/resident.py): SQL
        # text predicates and LogQL line filters prefilter through it, on
        # each table's device.  The workload quota the reference admits
        # it under is not ported (its memory_probe stays None)
        self.current_db = DEFAULT_DB
        # the storage engine is single-writer (region sequence assignment
        # and memtable mutation are unsynchronized); statements serialize
        # on this lock
        self._lock = threading.RLock()
        # before the flow engine: restoring a flow at registration plans
        # its query (table_context reads the session timezone)
        self.timezone = "UTC"
        # live query registry (reference process_manager.rs): the
        # scheduler registers queued entries, sql() running statements
        from greptimedb_tpu_torch.meta.process import ProcessManager

        self.processes = ProcessManager()
        self._proc_local = threading.local()
        # concurrent serving layer (serving/): clients submit queries
        # through the scheduler — per-tenant admission, priority classes,
        # deadline shedding, cross-query stacked dispatch.
        # GREPTIME_SCHEDULER=off keeps the inline path: the package is
        # never imported.  Worker threads start lazily on the first
        # submit.  Built before the flow engine, whose checkpoint drain
        # registers as an idle hook.
        self.scheduler = None
        if os.environ.get("GREPTIME_SCHEDULER", "on").lower() not in (
                "off", "0", "false"):
            from greptimedb_tpu_torch.serving import QueryScheduler

            self.scheduler = QueryScheduler(self)
        # closed-loop SLO observatory (serving/slo.py + serving/idle.py):
        # per-(tenant, class, protocol) latency sketches, error budgets
        # and burn-rate alerts, plus the budgeted idle economy that
        # arbitrates the scheduler's idle capacity.  GREPTIME_SLO=off
        # leaves both modules unimported and the scheduler's legacy
        # chained idle hook in place.
        self.slo = None
        self.idle_economy = None
        if (self.scheduler is not None
                and os.environ.get("GREPTIME_SLO", "on").lower() not in (
                    "off", "0", "false")):
            from greptimedb_tpu_torch.serving.idle import IdleEconomy
            from greptimedb_tpu_torch.serving.slo import SloEngine

            self.slo = SloEngine()
            self.idle_economy = IdleEconomy(slo=self.slo)
            self.scheduler.slo = self.slo
            self.scheduler.idle_economy = self.idle_economy
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
        # device flow runtime (flow/device.py): resident [G, W] partial
        # state on self.device, one fold per ingest chunk, GTF1 checkpoints
        # with exact WAL watermarks (flow/checkpoint.py).
        # GREPTIME_FLOW_DEVICE=off keeps the host dict-of-partials engine —
        # the modules are then never imported.  The flow memory quota is
        # not ported (the runtime's memory_probe stays None).
        self.flow_runtime = None
        self.flow_checkpoints = None
        if os.environ.get("GREPTIME_FLOW_DEVICE", "on").lower() not in (
                "off", "0", "false"):
            from greptimedb_tpu_torch.flow.checkpoint import FlowCheckpointStore
            from greptimedb_tpu_torch.flow.device import FlowDeviceRuntime

            self.flow_runtime = FlowDeviceRuntime(self)
            try:
                self.flow_checkpoints = FlowCheckpointStore(
                    os.path.join(data_home, "flow_ckpt"))
            except OSError:
                self.flow_checkpoints = None  # unwritable home
        from greptimedb_tpu_torch.flow.engine import FlowEngine

        self.flow_engine = FlowEngine(self)

    def close(self, flush: bool = False) -> None:
        """Stop the scheduler, write the flows' final checkpoints, close
        region WAL handles (``flush=True`` flushes dirty regions first)
        and the kv store."""
        if self.scheduler is not None:
            # unhook idle work first: a tick claimed after this point
            # would run against a closing instance
            self.scheduler.idle_hook = None
            self.scheduler.stop()
        if self.flow_checkpoints is not None:
            # final checkpoints: a clean restart resumes every flow from
            # its exact watermark with zero tail to replay
            try:
                self.flow_engine.checkpoint_now()
            except Exception:  # noqa: BLE001 — shutdown must not die on
                pass  # a checkpoint failure; restart reseeds instead
        self.regions.close(flush=flush)
        if hasattr(self.kv, "close"):
            self.kv.close()

    @property
    def mesh(self):
        """The device mesh of the mesh row path (a tuple of
        ``torch.device``s, one per shard), or None."""
        return self._mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        """Install a mesh (or None): the sharded tables of the old one
        leave the cache and the executor is rebuilt on the next query."""
        self._mesh = tuple(mesh) if mesh is not None else None
        self.cache.drop_sharded()
        self.cache.mesh = self._mesh
        self._dist_exec = None

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

    def mesh_select(self, sel):
        """The mesh row path for tables the dense grid refuses (irregular or
        sparse cadence): the table's rows sharded on the series axis across
        the mesh and aggregated through the commutativity split
        (parallel/dist.py).  Returns (names, rows) unordered, or None when
        there is no mesh, the table is below ``GREPTIME_MESH_MIN_ROWS``
        live rows (default 65,536: below it one device wins) or the query
        does not decompose: the engine then takes the row path."""
        if self.mesh is None:
            return None
        view = self._table_view(sel.table)
        min_rows = int(os.environ.get("GREPTIME_MESH_MIN_ROWS", "65536"))
        live = view.memtable.num_rows + sum(m.num_rows
                                            for m in view.sst_files)
        if live < min_rows:
            return None
        from greptimedb_tpu_torch.rpc.partial import split_partial

        ts_name = (view.schema.time_index.name
                   if view.schema.time_index is not None else None)
        if split_partial(sel, ts_column=ts_name) is None:
            return None  # cheap pre-check before building the shard table
        from greptimedb_tpu_torch.parallel.dist import (
            DistAggExecutor, execute_select_on_mesh,
        )

        if self._dist_exec is None:
            self._dist_exec = DistAggExecutor(self.mesh)
        return execute_select_on_mesh(
            self._dist_exec, self.cache.get_sharded(view), sel,
            self.table_context(sel.table), view.ts_bounds())

    # ---- SQL entry -----------------------------------------------------
    def sql(self, query: str, client: str = "",
            _stmts: list | None = None) -> QueryResult:
        """Execute one or more statements; returns the LAST result.
        ``_stmts`` carries statements the scheduler already parsed."""
        from greptimedb_tpu_torch.utils.tracing import TRACER

        # register BEFORE taking the executor lock so statements queued
        # behind a long query are listed; nested sql() calls (INSERT …
        # SELECT, sql_in_db) reuse the outer ticket
        ticket = None
        if getattr(self._proc_local, "ticket", None) is None:
            ticket = self.processes.register(query, self.current_db, client)
            self._proc_local.ticket = ticket
        try:
            if _stmts is not None:
                stmts = _stmts
            else:
                with TRACER.stage("parse"):
                    stmts = parse_sql(query)
            with self._lock:
                result = QueryResult([], [])
                for stmt in stmts:
                    with TRACER.stage("execute_statement",
                                      kind=type(stmt).__name__):
                        result = self.execute_statement(stmt)
                return result
        finally:
            if ticket is not None:
                self._proc_local.ticket = None
                self.processes.deregister(ticket)

    def sql_in_db(
        self, query: str, dbname: str, timezone: str | None = None,
        _stmts: list | None = None,
    ) -> tuple[QueryResult, str, str]:
        """Session-scoped execution: run with the connection's database
        and timezone without leaking either to other sessions (both are
        swapped under the db lock).  Returns (result, session db, session
        tz).  ``_stmts`` hands over an already parsed statement list."""
        ticket = None
        if getattr(self._proc_local, "ticket", None) is None:
            ticket = self.processes.register(query, dbname)
            self._proc_local.ticket = ticket
        try:
            with self._lock:
                prev_db = self.current_db
                prev_tz = self.timezone
                self.current_db = dbname
                if timezone is not None:
                    self.timezone = timezone
                try:
                    result = self.sql(query, _stmts=_stmts)
                    return result, self.current_db, self.timezone
                finally:
                    self.current_db = prev_db
                    self.timezone = prev_tz
        finally:
            if ticket is not None:
                self._proc_local.ticket = None
                self.processes.deregister(ticket)

    def sql_batch(self, entries) -> list[QueryResult] | None:
        """Scheduler entry for one stacked dispatch over N coalesced
        Selects: ``entries`` is [(query_text, Select, dbname|None,
        timezone|None)].  Returns per-entry results (order preserved,
        bit-exact vs solo) or None when any member falls outside the
        batchable surface — the scheduler then executes each solo.
        Refuses what the solo Select branch does not serve on the grid:
        derived tables, joins, views and system tables."""
        for _q, s, _d, _tz in entries:
            if s.table is None or s.from_subquery is not None or s.joins:
                return None
            try:
                vdb, vname = self._split_name(s.table)
                if vdb.lower() in ("information_schema", "pg_catalog"):
                    return None
                if self.catalog.get_engine(vdb, vname) != "mito":
                    return None
            except Exception:  # noqa: BLE001 — the solo path owns the error
                return None
        with self._lock:
            # session entries were classified against current_db and the
            # instance timezone OUTSIDE the lock; a concurrent session
            # swap could have moved either — re-verify under the lock or
            # fall back to solo session execution
            for _q, _s, dbname, tz in entries:
                if dbname is not None and dbname != self.current_db:
                    return None
                if tz is not None and tz != self.timezone:
                    return None
            sink: dict = {}
            sched = getattr(self._proc_local, "sched_info", None)
            if sched:
                sink.update(sched)
            return self.engine.execute_select_batch(
                [s for _q, s, _d, _tz in entries], metrics=sink)

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
        if isinstance(stmt, (CreateFlow, DropFlow, ShowFlows)):
            from greptimedb_tpu_torch.flow.engine import handle_flow_statement

            return handle_flow_statement(self, stmt)
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
            # INSERT INTO … SELECT: evaluate the query, then insert its
            # rows positionally
            import dataclasses as _dc

            res = self.execute_statement(stmt.select)
            if not res.rows:
                return QueryResult([], [], affected_rows=0)
            return self._insert(_dc.replace(
                stmt, rows=[list(r) for r in res.rows], select=None))
        region = self._table_view(stmt.table)
        _columns, data = insert_rows_to_columns(stmt, region.schema,
                                                self.timezone)
        region.write(data)
        if self.flow_engine.flows:
            # flows: streaming ones fold the arriving batch, batching ones
            # mark dirty windows; both re-evaluate synchronously
            ts_name = region.schema.time_index.name
            self.flow_engine.on_write(
                stmt.table, data[ts_name], data=data,
                appendable=getattr(region, "last_write_appendable", True))
            self.flow_engine.run_all()
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
