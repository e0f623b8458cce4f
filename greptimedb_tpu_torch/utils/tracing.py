"""Tracing: spans + OTLP/HTTP export.

Reference: common-telemetry's tracing layer exporting OTLP spans to a
collector (src/common/telemetry/src/tracing_*.rs, config
[logging].otlp_endpoint).  Spans record into a bounded in-process
buffer; the exporter encodes ExportTraceServiceRequest protobuf (the
same wire format servers/trace.py parses — a greptimedb-tpu instance
can export its own spans to another instance, or to any OTLP
collector) and POSTs it over HTTP.

Disabled tracers cost one attribute check per span.
"""

from __future__ import annotations

import contextlib
import os
import re
import struct
import threading
import time
import urllib.request

from greptimedb_tpu_torch.utils.proto import (  # the ONE wire encoder
    pb_fixed64 as _fixed64_field, pb_len as _field, pb_varint as _varint,
    pb_vint_field as _vint_field,
)


_NULL_CTX = contextlib.nullcontext()

# ---------------------------------------------------------------------------
# Trace-context propagation (W3C Trace Context + the reference's
# x-greptime-trace-id header, src/servers/src/http/header.rs).  Malformed
# values are IGNORED — a bad header falls back to a fresh trace, never an
# error (per the W3C spec's "restart the trace" rule).
# ---------------------------------------------------------------------------

_HEX = frozenset("0123456789abcdef")


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s.lower())


def parse_traceparent(value: str | None) -> tuple[str, str] | None:
    """W3C ``traceparent`` (``version-traceid-parentid-flags``) →
    (trace_id, parent_span_id), lowercased, or None when absent or
    malformed (wrong field length, non-hex, all-zero ids, version
    ``ff``, or a version-00 header with trailing members)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or not _is_hex(version) or version.lower() == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id):
        return None
    if len(span_id) != 16 or not _is_hex(span_id):
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    trace_id = trace_id.lower()
    span_id = span_id.lower()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def parse_trace_id(value: str | None) -> tuple[str, str] | None:
    """``x-greptime-trace-id``: a bare 32-hex trace id (no parent span).
    Returns (trace_id, "") or None when absent/malformed."""
    if not value:
        return None
    tid = value.strip().lower()
    if len(tid) != 32 or not _is_hex(tid) or tid == "0" * 32:
        return None
    return tid, ""


# sqlcommenter-style propagation for header-less wire protocols
# (MySQL/PostgreSQL): a SQL comment near the statement head carrying
# traceparent='00-…-…-01'.
_SQL_TRACEPARENT = re.compile(r"traceparent\s*=\s*'([0-9a-fA-F-]{10,80})'")


def extract_sql_trace_context(sql: str) -> tuple[str, str] | None:
    """Trace context from a LEADING SQL comment (sqlcommenter
    convention) — the MySQL/PostgreSQL twin of the HTTP ``traceparent``
    header.  Only comments before the first real token are scanned: a
    traceparent-looking substring inside a string literal must never
    seed the trace context.  A cheap substring gate keeps the
    per-statement cost at one ``in`` check when no context rides along."""
    head = sql[:512]
    if "traceparent" not in head:
        return None
    pos, n = 0, len(head)
    while pos < n:
        while pos < n and head[pos].isspace():
            pos += 1
        if head.startswith("--", pos):
            nl = head.find("\n", pos)
            seg, pos = (head[pos:], n) if nl < 0 else (head[pos:nl], nl + 1)
        elif head.startswith("/*", pos):
            end = head.find("*/", pos)
            seg, pos = (head[pos:], n) if end < 0 else (head[pos:end],
                                                        end + 2)
        else:
            return None  # first real token: stop before any literal
        m = _SQL_TRACEPARENT.search(seg)
        if m is not None:
            return parse_traceparent(m.group(1))
    return None


def _kv(key: str, value: str) -> bytes:
    any_value = _field(1, value.encode())  # AnyValue.string_value
    return _field(1, key.encode()) + _field(2, any_value)


def encode_spans(service_name: str, spans: list[dict]) -> bytes:
    """[span dicts] → ExportTraceServiceRequest bytes."""
    span_msgs = []
    for s in spans:
        msg = _field(1, bytes.fromhex(s["trace_id"]))
        msg += _field(2, bytes.fromhex(s["span_id"]))
        if s.get("parent_span_id"):
            msg += _field(4, bytes.fromhex(s["parent_span_id"]))
        msg += _field(5, s["name"].encode())
        msg += _vint_field(6, s.get("kind", 1))  # SPAN_KIND_INTERNAL
        msg += _fixed64_field(7, s["start_ns"])
        msg += _fixed64_field(8, s["end_ns"])
        for k, v in (s.get("attributes") or {}).items():
            msg += _field(9, _kv(str(k), str(v)))
        msg += _field(15, _vint_field(2, s.get("status_code", 0)))
        span_msgs.append(msg)
    scope_spans = b"".join(_field(2, m) for m in span_msgs)
    resource = _field(1, _kv("service.name", service_name))
    resource_spans = _field(1, resource) + _field(2, scope_spans)
    return _field(1, resource_spans)


class Tracer:
    """Span recorder + OTLP exporter.  One process-wide instance
    (``TRACER``); enable via configure()."""

    def __init__(self):
        self.enabled = False
        self.endpoint: str | None = None
        self.service_name = "greptimedb-tpu"
        self.max_buffer = 2048
        self._spans: list[dict] = []
        self._dropped = 0  # spans trimmed off the buffer head (mark/since)
        self._lock = threading.Lock()
        self._tls = threading.local()  # current span id (parenting)
        self._trace_id_base = os.urandom(12).hex()
        self._counter = 0

    def configure(self, endpoint: str | None = None,
                  service_name: str | None = None,
                  enabled: bool = True) -> None:
        self.endpoint = endpoint
        if service_name:
            self.service_name = service_name
        self.enabled = enabled

    def disable(self) -> None:
        self.enabled = False
        self.endpoint = None
        with self._lock:
            self._dropped += len(self._spans)
            self._spans.clear()

    def _next_ids(self) -> tuple[str, str]:
        with self._lock:
            self._counter += 1
            c = self._counter
        return (self._trace_id_base + struct.pack(">I", c & 0xFFFFFFFF).hex(),
                os.urandom(8).hex())

    def stage(self, name: str, **attributes):
        """Hot-path span entry: ``span()`` when enabled, a SHARED null
        context when disabled — one attribute check, no generator or
        span-record allocation, so per-stage instrumentation inside the
        query engines is free when tracing is off.  The suppress check
        sits AFTER the enabled short-circuit: the disabled path still
        costs exactly one attribute read."""
        if not self.enabled or getattr(self._tls, "suppress", False):
            return _NULL_CTX
        return self.span(name, **attributes)

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        if not self.enabled or getattr(self._tls, "suppress", False):
            yield None
            return
        parent = getattr(self._tls, "current", None)
        if parent is not None:
            trace_id = parent[0]
            parent_id = parent[1]
        else:
            trace_id, _ = self._next_ids()
            parent_id = ""
        span_id = os.urandom(8).hex()
        self._tls.current = (trace_id, span_id)
        start_ns = time.time_ns()
        status = 0
        try:
            yield span_id
        except BaseException:
            status = 2  # STATUS_CODE_ERROR
            raise
        finally:
            self._tls.current = parent
            rec = {
                "trace_id": trace_id,
                "span_id": span_id,
                "parent_span_id": parent_id,
                "name": name,
                "start_ns": start_ns,
                "end_ns": time.time_ns(),
                "attributes": {k: v for k, v in attributes.items()},
                "status_code": status,
            }
            with self._lock:
                self._spans.append(rec)
                if len(self._spans) > self.max_buffer:
                    trim = len(self._spans) - self.max_buffer
                    del self._spans[:trim]
                    self._dropped += trim

    # ---- trace-context propagation ------------------------------------
    def new_trace_id(self) -> str:
        """A fresh 32-hex trace id (random base + counter suffix)."""
        trace_id, _ = self._next_ids()
        return trace_id

    def current_trace_id(self) -> str:
        """The trace id active on THIS thread ("" when none) — read by
        the slow-query recorder and EXPLAIN ANALYZE so both surfaces
        report the same id the protocol layer returned to the client."""
        cur = getattr(self._tls, "current", None)
        return cur[0] if cur else ""

    @contextlib.contextmanager
    def trace_context(self, ctx: tuple[str, str] | None):
        """Seed this thread's span tree with an external (trace_id,
        parent_span_id) — the protocol servers wrap each statement's
        executor closure in this so a client's W3C ``traceparent``
        parents the whole parse→…→materialize tree.  Installs the
        context even when the tracer is disabled so slow_queries still
        carries the client's trace id.  ``ctx=None`` is a no-op."""
        if ctx is None:
            yield
            return
        prev = getattr(self._tls, "current", None)
        self._tls.current = (ctx[0], ctx[1] or "")
        try:
            yield
        finally:
            self._tls.current = prev

    @contextlib.contextmanager
    def suppressed(self):
        """Recursion guard for the self-monitoring loop: while active on
        this thread, stage()/span() record nothing — loopback span/metric
        exports must not observe themselves into the very buffers they
        export (reference export_metrics self_import filters its own
        write path the same way)."""
        prev = getattr(self._tls, "suppress", False)
        self._tls.suppress = True
        try:
            yield
        finally:
            self._tls.suppress = prev

    def drain(self) -> list[dict]:
        with self._lock:
            out = self._spans
            self._spans = []
            self._dropped += len(out)
        return out

    def requeue(self, spans: list[dict]) -> None:
        """Put drained-but-unexported spans back at the buffer head (a
        self-export write failed; they retry next tick).  Reverses
        drain()'s dropped-count bump so mark()/since() offsets stay
        valid; the normal head-trim reclaims any overflow."""
        if not spans:
            return
        with self._lock:
            self._spans[:0] = spans
            self._dropped -= len(spans)
            if len(self._spans) > self.max_buffer:
                trim = len(self._spans) - self.max_buffer
                del self._spans[:trim]
                self._dropped += trim

    # ---- in-process span-tree readback --------------------------------
    # EXPLAIN ANALYZE (and tests) read the spans of ONE query back out of
    # the buffer without draining it away from the OTLP exporter: mark()
    # before, since() after.  Buffer trimming between the two calls can
    # only drop spans older than the mark, so ``mark - dropped`` stays a
    # valid offset.
    def mark(self) -> int:
        with self._lock:
            return self._dropped + len(self._spans)

    def since(self, mark: int) -> list[dict]:
        with self._lock:
            off = max(0, mark - self._dropped)
            return list(self._spans[off:])

    def flush(self, timeout: float = 10.0) -> int:
        """Export buffered spans to the OTLP endpoint; returns count."""
        spans = self.drain()
        if not spans or not self.endpoint:
            return 0
        body = encode_spans(self.service_name, spans)
        req = urllib.request.Request(
            self.endpoint, data=body, method="POST",
            headers={"Content-Type": "application/x-protobuf"})
        urllib.request.urlopen(req, timeout=timeout).read()
        return len(spans)


def render_span_tree(spans: list[dict]) -> str:
    """Indented per-stage text tree from a span list (parent links), with
    wall-ms per span and its recorded attributes — the EXPLAIN ANALYZE
    surface of the query span tree.  Spans arrive in completion order
    (children before parents); siblings render in start order."""
    by_parent: dict[str, list[dict]] = {}
    ids = {s["span_id"] for s in spans}
    for s in spans:
        parent = s.get("parent_span_id") or ""
        if parent not in ids:
            parent = ""  # orphan (parent outside the capture): root it
        by_parent.setdefault(parent, []).append(s)

    lines: list[str] = []

    def emit(parent: str, depth: int) -> None:
        for s in sorted(by_parent.get(parent, ()),
                        key=lambda x: x["start_ns"]):
            ms = (s["end_ns"] - s["start_ns"]) / 1e6
            attrs = s.get("attributes") or {}
            suffix = "".join(
                f" {k}={v}" for k, v in attrs.items()
                if k not in ("statement",)
            )
            lines.append(f"{'  ' * depth}{s['name']}: {ms:.3f} ms{suffix}")
            emit(s["span_id"], depth + 1)

    emit("", 0)
    return "\n".join(lines)


TRACER = Tracer()
