"""Catalog: databases and tables over a KvBackend.

Equivalent of the reference's KvBackendCatalogManager
(src/catalog/src/kvbackend/manager.rs:71) + the typed key space of
src/common/meta/src/key/: table info records live at
``__catalog/<db>/<table>`` with table-id allocation at ``__meta/next_ids``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.errors import (
    DatabaseNotFound, GreptimeError, StatusCode, TableAlreadyExists,
    TableNotFound,
)
from greptimedb_tpu_torch.meta.kv import KvBackend

DEFAULT_CATALOG = "greptime"
DEFAULT_DB = "public"


@dataclass
class TableInfo:
    table_id: int
    name: str
    database: str
    schema: Schema
    region_ids: list[int]
    engine: str = "mito"
    options: dict = field(default_factory=dict)
    partition_exprs: list[str] = field(default_factory=list)
    partition_columns: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "table_id": self.table_id,
            "name": self.name,
            "database": self.database,
            "schema": self.schema.to_dict(),
            "region_ids": self.region_ids,
            "engine": self.engine,
            "options": self.options,
            "partition_exprs": self.partition_exprs,
            "partition_columns": self.partition_columns,
        }

    @staticmethod
    def from_dict(d: dict) -> "TableInfo":
        return TableInfo(
            table_id=d["table_id"],
            name=d["name"],
            database=d["database"],
            schema=Schema.from_dict(d["schema"]),
            region_ids=d["region_ids"],
            engine=d.get("engine", "mito"),
            options=d.get("options", {}),
            partition_exprs=d.get("partition_exprs", []),
            partition_columns=d.get("partition_columns", []),
        )


class CatalogManager:
    def __init__(self, kv: KvBackend):
        self.kv = kv
        if self.kv.get(self._db_key(DEFAULT_DB)) is None:
            self.create_database(DEFAULT_DB, if_not_exists=True)

    # ---- keys ---------------------------------------------------------
    @staticmethod
    def _db_key(db: str) -> str:
        return f"__catalog/db/{db}"

    @staticmethod
    def _table_key(db: str, table: str) -> str:
        return f"__catalog/table/{db}/{table}"

    # ---- id allocation -------------------------------------------------
    def _next_id(self, kind: str) -> int:
        key = f"__meta/next_id/{kind}"
        while True:
            cur = self.kv.get(key)
            nxt = (int(cur) if cur else 1024) + 1
            if self.kv.compare_and_put(key, cur, str(nxt).encode()):
                return nxt

    # ---- databases -----------------------------------------------------
    def create_database(self, db: str, if_not_exists: bool = False) -> None:
        key = self._db_key(db)
        if self.kv.get(key) is not None:
            if if_not_exists:
                return
            raise GreptimeError(
                f"Database already exists: {db}",
                code=StatusCode.DATABASE_ALREADY_EXISTS,
            )
        self.kv.put_json(key, {"name": db})

    def drop_database(self, db: str, if_exists: bool = False) -> list[TableInfo]:
        if self.kv.get(self._db_key(db)) is None:
            if if_exists:
                return []
            raise DatabaseNotFound(db)
        tables = self.list_tables(db)
        for t in tables:
            self.kv.delete(self._table_key(db, t.name))
        self.kv.delete(self._db_key(db))
        return tables

    def list_databases(self) -> list[str]:
        return [
            json.loads(v)["name"] for _k, v in self.kv.range("__catalog/db/")
        ]

    def database_exists(self, db: str) -> bool:
        return self.kv.get(self._db_key(db)) is not None

    # ---- tables --------------------------------------------------------
    def create_table(
        self,
        db: str,
        name: str,
        schema: Schema,
        *,
        engine: str = "mito",
        options: dict | None = None,
        partition_exprs: list[str] | None = None,
        partition_columns: list[str] | None = None,
        num_regions: int = 1,
        if_not_exists: bool = False,
    ) -> TableInfo | None:
        if not self.database_exists(db):
            raise DatabaseNotFound(db)
        key = self._table_key(db, name)
        if self.kv.get(key) is not None:
            if if_not_exists:
                return None
            raise TableAlreadyExists(f"{db}.{name}")
        table_id = self._next_id("table")
        region_ids = [table_id * 1024 + i for i in range(num_regions)]
        info = TableInfo(
            table_id=table_id,
            name=name,
            database=db,
            schema=schema,
            region_ids=region_ids,
            engine=engine,
            options=options or {},
            partition_exprs=partition_exprs or [],
            partition_columns=partition_columns or [],
        )
        self.kv.put_json(key, info.to_dict())
        return info

    def get_engine(self, db: str, name: str) -> str | None:
        """Engine name only, without rebuilding the Schema — the per-query
        view check on the hot SELECT path."""
        raw = self.kv.get_json(self._table_key(db, name))
        return None if raw is None else raw.get("engine", "mito")

    def get_table(self, db: str, name: str) -> TableInfo:
        raw = self.kv.get_json(self._table_key(db, name))
        if raw is None:
            raise TableNotFound(f"{db}.{name}")
        return TableInfo.from_dict(raw)

    def table_exists(self, db: str, name: str) -> bool:
        return self.kv.get(self._table_key(db, name)) is not None

    def update_table(self, info: TableInfo) -> None:
        self.kv.put_json(self._table_key(info.database, info.name), info.to_dict())

    def restore_table(self, info: TableInfo) -> None:
        """Re-register a previously dropped table verbatim (undrop —
        reference src/common/meta/src/ddl/drop_table.rs recycle bin):
        table_id and region_ids are preserved so the on-disk region data
        lines up."""
        key = self._table_key(info.database, info.name)
        if self.kv.get(key) is not None:
            raise TableAlreadyExists(f"{info.database}.{info.name}")
        self.kv.put_json(key, info.to_dict())

    # ---- recycle bin (reference purge_dropped_table.rs) ----------------
    @staticmethod
    def _recycle_key(db: str, name: str, table_id: int,
                     dropped_at_ms: int) -> str:
        # table_id disambiguates same-name drops landing in one ms
        return f"__recycle__/{db}.{name}/{table_id}/{dropped_at_ms}"

    def recycle_put(self, info: TableInfo, dropped_at_ms: int) -> None:
        self.kv.put_json(
            self._recycle_key(info.database, info.name, info.table_id,
                              dropped_at_ms),
            {"info": info.to_dict(), "dropped_at_ms": dropped_at_ms},
        )

    def recycle_list(self, db: str | None = None) -> list[dict]:
        """Entries newest-first: [{info, dropped_at_ms, key}]."""
        import json as _json

        out = []
        for key, raw_bytes in self.kv.range("__recycle__/"):
            raw = _json.loads(raw_bytes)
            if db is not None and raw["info"].get("database") != db:
                continue
            raw["key"] = key
            out.append(raw)
        out.sort(key=lambda e: -e["dropped_at_ms"])
        return out

    def recycle_take(self, db: str, name: str) -> dict | None:
        """Pop the NEWEST recycle entry for db.name (undrop restores the
        most recent drop)."""
        matches = [e for e in self.recycle_list(db)
                   if e["info"].get("name") == name]
        if not matches:
            return None
        entry = matches[0]
        self.kv.delete(entry["key"])
        return entry

    def recycle_remove(self, key: str) -> None:
        self.kv.delete(key)

    def drop_table(self, db: str, name: str, if_exists: bool = False) -> TableInfo | None:
        key = self._table_key(db, name)
        raw = self.kv.get_json(key)
        if raw is None:
            if if_exists:
                return None
            raise TableNotFound(f"{db}.{name}")
        self.kv.delete(key)
        return TableInfo.from_dict(raw)

    def rename_table(self, db: str, name: str, new_name: str) -> None:
        info = self.get_table(db, name)
        if self.table_exists(db, new_name):
            raise TableAlreadyExists(f"{db}.{new_name}")
        self.kv.delete(self._table_key(db, name))
        info.name = new_name
        self.kv.put_json(self._table_key(db, new_name), info.to_dict())

    def list_tables(self, db: str) -> list[TableInfo]:
        if not self.database_exists(db):
            raise DatabaseNotFound(db)
        out = []
        for _k, v in self.kv.range(f"__catalog/table/{db}/"):
            out.append(TableInfo.from_dict(json.loads(v)))
        return sorted(out, key=lambda t: t.name)
