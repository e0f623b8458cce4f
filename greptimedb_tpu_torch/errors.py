"""Error model: status-coded exceptions shared across all layers.

Equivalent of the reference's ``common_error`` crate (``ErrorExt`` + status
codes, reference src/common/error/src/status_code.rs): every user-visible
failure carries a stable status code so protocol servers can map errors to
HTTP/gRPC responses uniformly.
"""

from __future__ import annotations

import enum


class StatusCode(enum.IntEnum):
    # Success is 0 in responses; errors below.
    UNKNOWN = 1000
    UNSUPPORTED = 1001
    UNEXPECTED = 1002
    INTERNAL = 1003
    INVALID_ARGUMENTS = 1004
    CANCELLED = 1005
    DEADLINE_EXCEEDED = 1006

    INVALID_SYNTAX = 2000
    PLAN_QUERY = 3000
    ENGINE_EXECUTE_QUERY = 3001

    TABLE_ALREADY_EXISTS = 4000
    TABLE_NOT_FOUND = 4001
    TABLE_COLUMN_NOT_FOUND = 4002
    TABLE_COLUMN_EXISTS = 4003
    DATABASE_NOT_FOUND = 4004
    REGION_NOT_FOUND = 4005
    REGION_ALREADY_EXISTS = 4006
    REGION_READONLY = 4007
    FLOW_ALREADY_EXISTS = 4008
    FLOW_NOT_FOUND = 4009
    DATABASE_ALREADY_EXISTS = 4010

    STORAGE_UNAVAILABLE = 5000
    REQUEST_OUTDATED = 5001

    RUNTIME_RESOURCES_EXHAUSTED = 6000
    RATE_LIMITED = 6001

    USER_NOT_FOUND = 7000
    UNSUPPORTED_PASSWORD_TYPE = 7001
    USER_PASSWORD_MISMATCH = 7002
    AUTH_HEADER_NOT_FOUND = 7003
    INVALID_AUTH_HEADER = 7004
    ACCESS_DENIED = 7005
    PERMISSION_DENIED = 7006


class GreptimeError(Exception):
    """Base error; subclasses pin a default status code."""

    status_code: StatusCode = StatusCode.INTERNAL

    def __init__(self, msg: str, *, code: StatusCode | None = None):
        super().__init__(msg)
        if code is not None:
            self.status_code = code

    @property
    def msg(self) -> str:
        return str(self.args[0]) if self.args else self.__class__.__name__


class InvalidArguments(GreptimeError):
    status_code = StatusCode.INVALID_ARGUMENTS


class SyntaxError_(GreptimeError):
    status_code = StatusCode.INVALID_SYNTAX


class PlanError(GreptimeError):
    status_code = StatusCode.PLAN_QUERY


class ExecutionError(GreptimeError):
    status_code = StatusCode.ENGINE_EXECUTE_QUERY


class TableNotFound(GreptimeError):
    status_code = StatusCode.TABLE_NOT_FOUND

    def __init__(self, table: str):
        super().__init__(f"Table not found: {table}")
        self.table = table


class TableAlreadyExists(GreptimeError):
    status_code = StatusCode.TABLE_ALREADY_EXISTS

    def __init__(self, table: str):
        super().__init__(f"Table already exists: {table}")
        self.table = table


class ColumnNotFound(GreptimeError):
    status_code = StatusCode.TABLE_COLUMN_NOT_FOUND

    def __init__(self, column: str, table: str = ""):
        where = f" in table {table}" if table else ""
        super().__init__(f"Column not found: {column}{where}")
        self.column = column


class DatabaseNotFound(GreptimeError):
    status_code = StatusCode.DATABASE_NOT_FOUND

    def __init__(self, db: str):
        super().__init__(f"Database not found: {db}")
        self.database = db


class RegionNotFound(GreptimeError):
    status_code = StatusCode.REGION_NOT_FOUND


class FlowNotFound(GreptimeError):
    status_code = StatusCode.FLOW_NOT_FOUND


class FlowAlreadyExists(GreptimeError):
    status_code = StatusCode.FLOW_ALREADY_EXISTS


class Unsupported(GreptimeError):
    status_code = StatusCode.UNSUPPORTED


class StorageError(GreptimeError):
    status_code = StatusCode.STORAGE_UNAVAILABLE


class FencedError(StorageError):
    """A conditional (epoch-fenced) object-store write lost its CAS: a
    newer leader epoch owns the target, or the object already exists.
    The fenced-out writer must STOP — retrying or falling back to a
    plain write would interleave two leaders' histories on shared
    storage (split brain)."""


class ResourcesExhausted(GreptimeError):
    status_code = StatusCode.RUNTIME_RESOURCES_EXHAUSTED


class RateLimited(GreptimeError):
    """Per-tenant rate quota exceeded (serving/admission.py) — the
    deliberate flow-control rejection, distinct from memory pressure."""

    status_code = StatusCode.RATE_LIMITED


class DeadlineExceeded(GreptimeError):
    """Query shed by the scheduler before/while running because its
    deadline passed (serving/scheduler.py deadline-based shedding)."""

    status_code = StatusCode.DEADLINE_EXCEEDED


class Cancelled(GreptimeError):
    status_code = StatusCode.CANCELLED


class AccessDenied(GreptimeError):
    status_code = StatusCode.ACCESS_DENIED
