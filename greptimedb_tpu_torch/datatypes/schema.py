"""Column/table schema with semantic types (tag / field / time index).

Equivalent of the reference's schema + column metadata
(src/datatypes/src/schema/ and store-api RegionMetadata): a table schema is
an ordered list of columns where TAG columns form the primary key (series
identity), exactly one TIMESTAMP column is the time index, and FIELD columns
carry values. That split is load-bearing for the TPU design: (tags) →
dictionary-encoded series ids, (time index, fields) → dense device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from greptimedb_tpu_torch.errors import ColumnNotFound, InvalidArguments
from greptimedb_tpu_torch.datatypes.types import ConcreteDataType, SemanticType


def _arrow_types() -> dict:
    """ConcreteDataType → pyarrow type; pyarrow is imported only by the
    Parquet/Arrow paths, so a memtable-resident region runs without it."""
    import pyarrow as pa

    return {
        ConcreteDataType.BOOL: pa.bool_(),
        ConcreteDataType.INT8: pa.int8(),
        ConcreteDataType.INT16: pa.int16(),
        ConcreteDataType.INT32: pa.int32(),
        ConcreteDataType.INT64: pa.int64(),
        ConcreteDataType.UINT8: pa.uint8(),
        ConcreteDataType.UINT16: pa.uint16(),
        ConcreteDataType.UINT32: pa.uint32(),
        ConcreteDataType.UINT64: pa.uint64(),
        ConcreteDataType.FLOAT32: pa.float32(),
        ConcreteDataType.FLOAT64: pa.float64(),
        ConcreteDataType.STRING: pa.utf8(),
        ConcreteDataType.BINARY: pa.binary(),
        ConcreteDataType.JSON: pa.utf8(),
        ConcreteDataType.VECTOR: pa.utf8(),
        ConcreteDataType.DATE: pa.date32(),
        ConcreteDataType.TIMESTAMP_SECOND: pa.timestamp("s"),
        ConcreteDataType.TIMESTAMP_MILLISECOND: pa.timestamp("ms"),
        ConcreteDataType.TIMESTAMP_MICROSECOND: pa.timestamp("us"),
        ConcreteDataType.TIMESTAMP_NANOSECOND: pa.timestamp("ns"),
    }


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: ConcreteDataType
    semantic: SemanticType = SemanticType.FIELD
    nullable: bool = True
    default: object = None

    @property
    def is_tag(self) -> bool:
        return self.semantic is SemanticType.TAG

    @property
    def is_time_index(self) -> bool:
        return self.semantic is SemanticType.TIMESTAMP

    def to_arrow(self) -> "pa.Field":
        import pyarrow as pa

        return pa.field(self.name, _arrow_types()[self.dtype],
                        nullable=self.nullable)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dtype": self.dtype.value,
            "semantic": self.semantic.value,
            "nullable": self.nullable,
            "default": self.default,
        }

    @staticmethod
    def from_dict(d: dict) -> "ColumnSchema":
        return ColumnSchema(
            name=d["name"],
            dtype=ConcreteDataType(d["dtype"]),
            semantic=SemanticType(d["semantic"]),
            nullable=d.get("nullable", True),
            default=d.get("default"),
        )


@dataclass(frozen=True)
class Schema:
    """Ordered table schema. Exactly one TIMESTAMP column for time-series tables."""

    columns: tuple[ColumnSchema, ...]
    version: int = 0

    def __post_init__(self):
        ts = [c for c in self.columns if c.is_time_index]
        if len(ts) > 1:
            raise InvalidArguments(
                f"schema has {len(ts)} time index columns: {[c.name for c in ts]}"
            )
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise InvalidArguments(f"duplicate column names in schema: {names}")

    # ---- accessors ------------------------------------------------------
    @property
    def names(self) -> list[str]:
        return [c.name for c in self.columns]

    @property
    def tag_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.is_tag]

    @property
    def field_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.semantic is SemanticType.FIELD]

    @property
    def time_index(self) -> ColumnSchema | None:
        for c in self.columns:
            if c.is_time_index:
                return c
        return None

    def column(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise ColumnNotFound(name)

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise ColumnNotFound(name)

    def __len__(self) -> int:
        return len(self.columns)

    def __iter__(self):
        return iter(self.columns)

    # ---- evolution (ALTER TABLE ADD/DROP COLUMN) ------------------------
    def with_added_column(self, col: ColumnSchema) -> "Schema":
        if self.has_column(col.name):
            raise InvalidArguments(f"column exists: {col.name}")
        return Schema(self.columns + (col,), version=self.version + 1)

    def with_dropped_column(self, name: str) -> "Schema":
        col = self.column(name)
        if col.is_time_index or col.is_tag:
            raise InvalidArguments(f"cannot drop key column {name}")
        return Schema(
            tuple(c for c in self.columns if c.name != name), version=self.version + 1
        )

    # ---- conversions ----------------------------------------------------
    def to_arrow(self) -> "pa.Schema":
        import pyarrow as pa

        return pa.schema([c.to_arrow() for c in self.columns])

    def to_dict(self) -> dict:
        return {"version": self.version, "columns": [c.to_dict() for c in self.columns]}

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        return Schema(
            tuple(ColumnSchema.from_dict(c) for c in d["columns"]),
            version=d.get("version", 0),
        )

    def empty_columns(self) -> dict[str, np.ndarray]:
        return {c.name: np.empty(0, dtype=c.dtype.to_numpy()) for c in self.columns}


def default_fill_array(col: ColumnSchema, n: int) -> np.ndarray:
    """n rows of a column's fill value: declared default, else null encoding
    (NaN for floats, ""/0 otherwise). Single source for every path that
    materializes rows predating a column (write fill, SST backfill)."""
    if col.dtype.is_string_like:
        fill = col.default if col.default is not None else ""
        return np.full(n, fill, dtype=object)
    if col.default is not None:
        dt = np.int64 if col.dtype.is_timestamp else col.dtype.to_numpy()
        return np.full(n, col.default, dtype=dt)
    if col.dtype.is_float:
        return np.full(n, np.nan, dtype=col.dtype.to_numpy())
    if col.dtype.is_timestamp:
        return np.zeros(n, dtype=np.int64)
    return np.zeros(n, dtype=col.dtype.to_numpy())
