"""Typed columns and schemas (host side).

``types``/``schema`` are the reference's; ``batch`` keeps the host parts
the region and grid builds use (``DictionaryEncoder``, ``DictColumn``,
``pad_rows``).
"""

from greptimedb_tpu_torch.datatypes.types import (
    ConcreteDataType,
    SemanticType,
    TimeUnit,
)
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.batch import pad_rows

__all__ = [
    "ConcreteDataType",
    "SemanticType",
    "TimeUnit",
    "ColumnSchema",
    "Schema",
    "pad_rows",
]
