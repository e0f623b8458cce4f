"""Push entry points as plain functions: auto-creating column ingest and
the Loki push.

The bodies of the JAX package's HTTP handlers without the HTTP server
(which waits for the servers to be ported): ``ingest_columns`` is
``_ingest_columns`` (reference ``greptimedb_tpu/servers/http.py:1831``)
and ``loki_push`` the body of ``h_loki_push`` (``servers/http.py:967-
1045``).  Tenant admission, snappy decompression and the ingest
counters stay with the server.
"""

from __future__ import annotations

import json
import threading

import numpy as np

from greptimedb_tpu_torch.errors import InvalidArguments, Unsupported

LOKI_TABLE = "loki_logs"

# serializes table creation / tag addition across concurrent pushes; the
# write itself runs under the db's statement lock (the storage engine is
# single-writer)
_INGEST_DDL_LOCK = threading.RLock()


def _field_type(values):
    """Field column → ConcreteDataType; dtype-dispatch for ndarray /
    DictColumn columns, first-non-null scan for lists."""
    from greptimedb_tpu_torch.datatypes.batch import DictColumn
    from greptimedb_tpu_torch.datatypes.types import ConcreteDataType

    if isinstance(values, DictColumn):
        return ConcreteDataType.STRING
    if isinstance(values, np.ndarray) and values.dtype != object:
        if values.dtype == np.bool_:
            return ConcreteDataType.BOOL
        if np.issubdtype(values.dtype, np.integer):
            return ConcreteDataType.INT64
        if np.issubdtype(values.dtype, np.floating):
            return ConcreteDataType.FLOAT64
    for v in values:
        if isinstance(v, (bool, np.bool_)):
            return ConcreteDataType.BOOL
        if isinstance(v, str):
            return ConcreteDataType.STRING
        if isinstance(v, (float, np.floating)):
            return ConcreteDataType.FLOAT64
        if isinstance(v, (int, np.integer)):
            return ConcreteDataType.INT64
    return ConcreteDataType.FLOAT64


def ingest_columns(db, table: str, cols: dict,
                   append_mode: bool = False) -> int:
    """Auto-creating ingest (reference Inserter auto table creation):
    create the table from the first batch's shape (tags ``__tags__``,
    fields ``__fields__``, time index ``ts`` in milliseconds), add tag
    columns on demand, then write.  ``append_mode`` creates log-style
    tables that keep EVERY row (no (series, ts) dedup).  A batch that
    needs a new FIELD column raises ``Unsupported`` (ALTER TABLE is not
    ported yet), as does a partitioned table."""
    from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
    from greptimedb_tpu_torch.datatypes.types import (
        ConcreteDataType, SemanticType,
    )

    tag_names = cols.pop("__tags__", [])
    field_names = cols.pop("__fields__", [])
    n = len(cols["ts"])
    dbname, name = db._split_name(table)
    with _INGEST_DDL_LOCK:
        if not db.catalog.table_exists(dbname, name):
            defs = [ColumnSchema(t, ConcreteDataType.STRING, SemanticType.TAG)
                    for t in tag_names]
            defs.append(ColumnSchema(
                "ts", ConcreteDataType.TIMESTAMP_MILLISECOND,
                SemanticType.TIMESTAMP, nullable=False))
            defs += [ColumnSchema(f, _field_type(cols[f]), SemanticType.FIELD)
                     for f in field_names]
            info = db.catalog.create_table(
                dbname, name, Schema(tuple(defs)),
                options={"append_mode": "true"} if append_mode else None,
                if_not_exists=True)
            if info is not None:
                opts = None
                if append_mode:
                    import dataclasses as _dc

                    opts = _dc.replace(db.regions.default_options,
                                       append_mode=True)
                db.regions.create_region(info.region_ids[0], info.schema,
                                         options=opts)
        else:
            info = db.catalog.get_table(dbname, name)
            missing_fields = [f for f in field_names
                              if not info.schema.has_column(f)]
            if missing_fields:
                raise Unsupported(f"adding field columns {missing_fields} "
                                  "(ALTER TABLE) not ported yet")
            missing_tags = [t for t in tag_names
                            if not info.schema.has_column(t)]
            if missing_tags:
                # online tag addition: existing series extend their key
                # with the empty-string label
                tag_regions = db._regions_of(f"{dbname}.{name}")
                for region in tag_regions:
                    for t in missing_tags:
                        region.add_tag_column(t)
                info.schema = tag_regions[0].schema
                db.catalog.update_table(info)
        regions = db._regions_of(f"{dbname}.{name}")
    if len(regions) != 1:
        raise Unsupported("partitioned tables not ported yet")
    with db._lock:
        regions[0].write(cols)
        # hot-tail grid catch-up: freshly acked rows scatter into the
        # resident grid now (when one is resident and the delta is worth
        # a launch), so the next query sees them without a rebuild.  Under
        # the statement lock, so no writer adds series while the grid's
        # tag codes are read
        db.cache.extend_hot_tail(regions[0])
        if db.flow_engine.flows:
            db.flow_engine.on_write(
                name, cols["ts"], data=cols,
                appendable=getattr(regions[0], "last_write_appendable", True))
            db.flow_engine.run_all()
    return n


def loki_push(db, body: bytes, content_type: str = "application/json",
              tenant: str = "default") -> int:
    """One Loki push request into ``loki_logs``: stream labels become
    tags, the line the ``line`` string field, and ``tenant`` (the
    server's admitted ``X-Scope-OrgID``) a ``tenant`` tag.  A JSON body
    when ``content_type`` names json, else an unsnappied
    logproto.PushRequest.  Labels named like reserved columns (``ts``,
    ``line``, ``tenant``) gain a ``_label`` suffix.  Ends with the
    ingest-side fingerprint prewarm, as the reference's handler does.
    Returns the rows written."""
    rows: list[tuple[dict, str, int]] = []
    if "json" in content_type:
        try:
            payload = json.loads(body)
        except json.JSONDecodeError as e:
            raise InvalidArguments(f"bad json: {e}")
        for stream in payload.get("streams", []):
            labels = (stream.get("stream") or {}).items()
            labels = {str(k): str(v) for k, v in labels}
            for entry in stream.get("values", []):
                try:
                    ts_ns = int(entry[0])
                    line = str(entry[1])
                except (ValueError, TypeError, IndexError) as e:
                    raise InvalidArguments(f"bad loki entry {entry!r}: {e}")
                rows.append((labels, line, ts_ns // 1_000_000))
    else:
        from greptimedb_tpu_torch.servers.protocols import parse_loki_push

        try:
            rows = parse_loki_push(body)
        except Exception as e:  # noqa: BLE001
            raise InvalidArguments(f"bad protobuf push: {e}")
    rows = [
        ({(k + "_label" if k in ("ts", "line", "tenant") else k): v
          for k, v in labels.items()}, line, ts)
        for labels, line, ts in rows
    ]
    if not rows:
        return 0
    tag_names = sorted({k for lab, _l, _t in rows for k in lab} | {"tenant"})
    cols: dict[str, list] = {k: [] for k in tag_names}
    cols["ts"] = []
    cols["line"] = []
    for lab, line, ts in rows:
        for k in tag_names:
            cols[k].append(tenant if k == "tenant" else lab.get(k, ""))
        cols["ts"].append(ts)
        cols["line"].append(line)
    cols["__tags__"] = tag_names
    cols["__fields__"] = ["line"]
    n = ingest_columns(db, LOKI_TABLE, cols, append_mode=True)
    from greptimedb_tpu_torch.fulltext.loki import prewarm_ingest

    prewarm_ingest(db, LOKI_TABLE)
    return n
