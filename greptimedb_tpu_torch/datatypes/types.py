"""Concrete data types and their host (numpy/arrow) / device (jnp) mappings.

Mirrors the type lattice of the reference's ``ConcreteDataType``
(src/datatypes/src/data_type.rs): ints at 4 widths signed/unsigned, floats,
bool, string, binary, date, timestamps at 4 precisions, interval, decimal,
json, vector. TPU stance: only numeric types ever reach the device; string
tags become dictionary ids (int32), timestamps are int64 in their native
unit, booleans are int8 masks.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TimeUnit(enum.Enum):
    SECOND = "s"
    MILLISECOND = "ms"
    MICROSECOND = "us"
    NANOSECOND = "ns"

    @property
    def per_second(self) -> int:
        return {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[self.value]

    def convert(self, ts: int, to: "TimeUnit") -> int:
        """Lossy-floor conversion between units (matches arrow cast semantics)."""
        if self is to:
            return ts
        if to.per_second > self.per_second:
            return ts * (to.per_second // self.per_second)
        return ts // (self.per_second // to.per_second)


class SemanticType(enum.Enum):
    """Role of a column in a time-series table (reference: api::v1::SemanticType)."""

    TAG = "TAG"
    FIELD = "FIELD"
    TIMESTAMP = "TIMESTAMP"


class ConcreteDataType(enum.Enum):
    BOOL = "Boolean"
    INT8 = "Int8"
    INT16 = "Int16"
    INT32 = "Int32"
    INT64 = "Int64"
    UINT8 = "UInt8"
    UINT16 = "UInt16"
    UINT32 = "UInt32"
    UINT64 = "UInt64"
    FLOAT32 = "Float32"
    FLOAT64 = "Float64"
    STRING = "String"
    BINARY = "Binary"
    DATE = "Date"
    TIMESTAMP_SECOND = "TimestampSecond"
    TIMESTAMP_MILLISECOND = "TimestampMillisecond"
    TIMESTAMP_MICROSECOND = "TimestampMicrosecond"
    TIMESTAMP_NANOSECOND = "TimestampNanosecond"
    INTERVAL = "IntervalMonthDayNano"
    JSON = "Json"
    VECTOR = "Vector"  # fixed-dim float vector (for ANN search)

    # ---- classification -------------------------------------------------
    @property
    def is_timestamp(self) -> bool:
        return self in _TS_UNITS

    @property
    def time_unit(self) -> TimeUnit:
        return _TS_UNITS[self]

    @property
    def is_numeric(self) -> bool:
        return self in _NUMPY_DTYPES and self not in (
            ConcreteDataType.STRING,
            ConcreteDataType.BINARY,
        )

    @property
    def is_float(self) -> bool:
        return self in (ConcreteDataType.FLOAT32, ConcreteDataType.FLOAT64)

    @property
    def is_integer(self) -> bool:
        return self.is_numeric and not self.is_float and self is not ConcreteDataType.BOOL

    @property
    def is_string_like(self) -> bool:
        # VECTOR stores its textual form ('[1.0,2.0]') host-side; the device
        # path decodes the dictionary to an [V, dim] f32 tensor for search
        return self in (ConcreteDataType.STRING, ConcreteDataType.BINARY,
                        ConcreteDataType.JSON, ConcreteDataType.VECTOR)

    # ---- host/device dtype mapping --------------------------------------
    def to_numpy(self) -> np.dtype:
        """Host representation. String-likes are object arrays on host."""
        return _NUMPY_DTYPES[self]

    def to_device_dtype(self) -> np.dtype:
        """Device representation: what lands in HBM.

        Strings/json → int32 dictionary ids; timestamps/date → int64;
        bool → int8 (TPU has no packed bool vectors worth addressing here);
        uint64 → int64 (XLA TPU support for u64 is weak). float64 → float32:
        TPU has no native f64 ALU, so doubles compute in f32 with
        tree/compensated reductions where precision matters (Prometheus
        semantics, SURVEY.md §7.3 item 7); final scalar touch-up happens on
        host in f64.
        """
        if self.is_string_like:
            return np.dtype(np.int32)
        if self.is_timestamp or self in (ConcreteDataType.DATE, ConcreteDataType.INTERVAL):
            return np.dtype(np.int64)
        if self is ConcreteDataType.BOOL:
            return np.dtype(np.int8)
        if self is ConcreteDataType.UINT64:
            return np.dtype(np.int64)
        if self is ConcreteDataType.FLOAT64:
            return np.dtype(np.float32)
        return _NUMPY_DTYPES[self]

    @staticmethod
    def from_numpy(dt: np.dtype) -> "ConcreteDataType":
        dt = np.dtype(dt)
        if dt.kind in ("U", "S", "O"):
            return ConcreteDataType.STRING
        if dt.kind == "M":
            unit = np.datetime_data(dt)[0]
            return {
                "s": ConcreteDataType.TIMESTAMP_SECOND,
                "ms": ConcreteDataType.TIMESTAMP_MILLISECOND,
                "us": ConcreteDataType.TIMESTAMP_MICROSECOND,
                "ns": ConcreteDataType.TIMESTAMP_NANOSECOND,
            }[unit]
        return _FROM_NUMPY[dt]

    @staticmethod
    def parse(name: str) -> "ConcreteDataType":
        """Parse a SQL type name (both greptime and common SQL aliases)."""
        key = name.strip().upper().replace(" ", "")
        if key in _SQL_ALIASES:
            return _SQL_ALIASES[key]
        base = key.split("(")[0]
        if base == "VECTOR":  # VECTOR(dim) — dim is advisory host-side
            return ConcreteDataType.VECTOR
        raise ValueError(f"Unknown data type: {name!r}")

    def default_value(self):
        if self.is_string_like:
            return ""
        if self is ConcreteDataType.BOOL:
            return False
        if self.is_float:
            return 0.0
        return 0


_TS_UNITS = {
    ConcreteDataType.TIMESTAMP_SECOND: TimeUnit.SECOND,
    ConcreteDataType.TIMESTAMP_MILLISECOND: TimeUnit.MILLISECOND,
    ConcreteDataType.TIMESTAMP_MICROSECOND: TimeUnit.MICROSECOND,
    ConcreteDataType.TIMESTAMP_NANOSECOND: TimeUnit.NANOSECOND,
}

_NUMPY_DTYPES = {
    ConcreteDataType.BOOL: np.dtype(np.bool_),
    ConcreteDataType.INT8: np.dtype(np.int8),
    ConcreteDataType.INT16: np.dtype(np.int16),
    ConcreteDataType.INT32: np.dtype(np.int32),
    ConcreteDataType.INT64: np.dtype(np.int64),
    ConcreteDataType.UINT8: np.dtype(np.uint8),
    ConcreteDataType.UINT16: np.dtype(np.uint16),
    ConcreteDataType.UINT32: np.dtype(np.uint32),
    ConcreteDataType.UINT64: np.dtype(np.uint64),
    ConcreteDataType.FLOAT32: np.dtype(np.float32),
    ConcreteDataType.FLOAT64: np.dtype(np.float64),
    ConcreteDataType.STRING: np.dtype(object),
    ConcreteDataType.BINARY: np.dtype(object),
    ConcreteDataType.JSON: np.dtype(object),
    ConcreteDataType.DATE: np.dtype(np.int32),
    ConcreteDataType.TIMESTAMP_SECOND: np.dtype("datetime64[s]"),
    ConcreteDataType.TIMESTAMP_MILLISECOND: np.dtype("datetime64[ms]"),
    ConcreteDataType.TIMESTAMP_MICROSECOND: np.dtype("datetime64[us]"),
    ConcreteDataType.TIMESTAMP_NANOSECOND: np.dtype("datetime64[ns]"),
    ConcreteDataType.INTERVAL: np.dtype(np.int64),
    ConcreteDataType.VECTOR: np.dtype(object),
}

_FROM_NUMPY = {
    np.dtype(np.bool_): ConcreteDataType.BOOL,
    np.dtype(np.int8): ConcreteDataType.INT8,
    np.dtype(np.int16): ConcreteDataType.INT16,
    np.dtype(np.int32): ConcreteDataType.INT32,
    np.dtype(np.int64): ConcreteDataType.INT64,
    np.dtype(np.uint8): ConcreteDataType.UINT8,
    np.dtype(np.uint16): ConcreteDataType.UINT16,
    np.dtype(np.uint32): ConcreteDataType.UINT32,
    np.dtype(np.uint64): ConcreteDataType.UINT64,
    np.dtype(np.float32): ConcreteDataType.FLOAT32,
    np.dtype(np.float64): ConcreteDataType.FLOAT64,
}

_SQL_ALIASES: dict[str, ConcreteDataType] = {
    "BOOLEAN": ConcreteDataType.BOOL,
    "BOOL": ConcreteDataType.BOOL,
    "TINYINT": ConcreteDataType.INT8,
    "INT8": ConcreteDataType.INT8,
    "SMALLINT": ConcreteDataType.INT16,
    "INT16": ConcreteDataType.INT16,
    "INT": ConcreteDataType.INT32,
    "INT32": ConcreteDataType.INT32,
    "INTEGER": ConcreteDataType.INT32,
    "BIGINT": ConcreteDataType.INT64,
    "INT64": ConcreteDataType.INT64,
    "TINYINTUNSIGNED": ConcreteDataType.UINT8,
    "UINT8": ConcreteDataType.UINT8,
    "SMALLINTUNSIGNED": ConcreteDataType.UINT16,
    "UINT16": ConcreteDataType.UINT16,
    "INTUNSIGNED": ConcreteDataType.UINT32,
    "UINT32": ConcreteDataType.UINT32,
    "BIGINTUNSIGNED": ConcreteDataType.UINT64,
    "UINT64": ConcreteDataType.UINT64,
    "FLOAT": ConcreteDataType.FLOAT32,
    "FLOAT32": ConcreteDataType.FLOAT32,
    "REAL": ConcreteDataType.FLOAT32,
    "DOUBLE": ConcreteDataType.FLOAT64,
    "FLOAT64": ConcreteDataType.FLOAT64,
    "DOUBLEPRECISION": ConcreteDataType.FLOAT64,
    "STRING": ConcreteDataType.STRING,
    "TEXT": ConcreteDataType.STRING,
    "VARCHAR": ConcreteDataType.STRING,
    "CHAR": ConcreteDataType.STRING,
    "BINARY": ConcreteDataType.BINARY,
    "VARBINARY": ConcreteDataType.BINARY,
    "BLOB": ConcreteDataType.BINARY,
    "DATE": ConcreteDataType.DATE,
    "TIMESTAMP": ConcreteDataType.TIMESTAMP_MILLISECOND,
    "TIMESTAMP_S": ConcreteDataType.TIMESTAMP_SECOND,
    "TIMESTAMP(0)": ConcreteDataType.TIMESTAMP_SECOND,
    "TIMESTAMP_MS": ConcreteDataType.TIMESTAMP_MILLISECOND,
    "TIMESTAMP(3)": ConcreteDataType.TIMESTAMP_MILLISECOND,
    "TIMESTAMP_US": ConcreteDataType.TIMESTAMP_MICROSECOND,
    "TIMESTAMP(6)": ConcreteDataType.TIMESTAMP_MICROSECOND,
    "TIMESTAMP_NS": ConcreteDataType.TIMESTAMP_NANOSECOND,
    "TIMESTAMP(9)": ConcreteDataType.TIMESTAMP_NANOSECOND,
    "TIMESTAMPSECOND": ConcreteDataType.TIMESTAMP_SECOND,
    "TIMESTAMPMILLISECOND": ConcreteDataType.TIMESTAMP_MILLISECOND,
    "TIMESTAMPMICROSECOND": ConcreteDataType.TIMESTAMP_MICROSECOND,
    "TIMESTAMPNANOSECOND": ConcreteDataType.TIMESTAMP_NANOSECOND,
    "JSON": ConcreteDataType.JSON,
    "VECTOR": ConcreteDataType.VECTOR,
}


@dataclass(frozen=True)
class Value:
    """A single typed scalar (reference: datatypes::value::Value)."""

    dtype: ConcreteDataType
    inner: object

    def __repr__(self) -> str:
        return f"{self.inner!r}::{self.dtype.value}"
