"""Log query API: structured log search DSL over log tables.

The port of the JAX package's ``servers/logquery.py`` (reference:
src/log-query + src/servers/src/http/logs.rs) — a JSON DSL (table,
time_filter, column filters, limit).  It evaluates host-side over the
region scan; where the table's DeviceTable is already resident, the
filter kinds the fingerprint index serves probe its verified map
(``_fingerprint_maps``) instead of running the predicate per row.
The HTTP route waits for the servers; call ``execute_log_query(db,
query)`` directly.

Request shape (subset of the reference's LogQuery):
{
  "table": {"schema": "public", "table": "loki_logs"},
  "time_filter": {"start": "2026-01-01T00:00:00Z", "end": "..."},
  "filters": [{"column": "line", "filters": [
      {"contains": "error"} | {"prefix": "GET"} | {"regex": "..."} |
      {"exists": true} | {"eq": "value"}
  ]}],
  "columns": ["ts", "line", "app"],   # optional projection
  "limit": {"fetch": 100, "skip": 0}
}
"""

from __future__ import annotations

import re

import numpy as np

from greptimedb_tpu_torch.errors import InvalidArguments
from greptimedb_tpu_torch.query.engine import QueryResult
from greptimedb_tpu_torch.query.parser import parse_timestamp_str


def _parse_time(v) -> int | None:
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return int(v)
    return parse_timestamp_str(str(v))


def _term_pred(cond: dict):
    """cond → single-term predicate for index pruning; None when the cond
    cannot prune (its semantics aren't term-local, e.g. exists:true)."""
    if "contains" in cond:
        needle = str(cond["contains"])
        return lambda t: needle in t
    if "prefix" in cond:
        p = str(cond["prefix"])
        return lambda t: t.startswith(p)
    if "regex" in cond:
        try:
            rx = re.compile(str(cond["regex"]))
        except re.error:
            return None  # row-level _match raises the proper error
        return lambda t: rx.search(t) is not None
    if "eq" in cond:
        v = str(cond["eq"])
        return lambda t: t == v
    return None


def _cond_pred(cond: dict):
    """cond → (kind, text, predicate-over-coerced-strings) for the
    fingerprint-prefilterable filter kinds, None for the rest
    (exists: not value-local).  The predicate is THE definition of the
    filter's truth — the host row loop and the fingerprint-verified map
    both evaluate exactly it, so the two routes cannot diverge."""
    if "contains" in cond:
        needle = str(cond["contains"])
        return ("contains", needle, lambda s, t=needle: t in s)
    if "prefix" in cond:
        p = str(cond["prefix"])
        return ("prefix", p, lambda s, p=p: s.startswith(p))
    if "regex" in cond:
        try:
            rx = re.compile(str(cond["regex"]))
        except re.error as e:
            raise InvalidArguments(f"bad regex {cond['regex']!r}: {e}") from None
        return ("regex", str(cond["regex"]),
                lambda s, rx=rx: rx.search(s) is not None)
    if "match" in cond or "matches" in cond:
        # full-text match (shared semantics with SQL matches(); empty-token
        # queries match nothing); "matches" is the documented spelling,
        # "match" the original one — same filter
        from greptimedb_tpu_torch.storage.index import ft_predicate

        q = str(cond.get("matches", cond.get("match")))
        return ("matches", q, ft_predicate("matches", q))
    if "eq" in cond:
        v = str(cond["eq"])
        return ("eq", v, lambda s, v=v: s == v)
    return None


def _match(cond: dict, values: np.ndarray, vmap: dict | None = None
           ) -> np.ndarray:
    strs = np.asarray([("" if v is None else str(v)) for v in values],
                      dtype=object)
    n = len(strs)
    got = _cond_pred(cond)
    if got is not None:
        _kind, _text, pred = got
        if vmap is not None:
            # fingerprint route: per-DISTINCT-value truth precomputed
            # (fulltext/resident.py verified_bools over the resident
            # dictionary); rows reduce to a dict probe.  Values the
            # resident vocabulary has not seen yet (hot appends) fall
            # back to the same predicate — bit-exact either way.
            return np.array(
                [vmap[s] if s in vmap else pred(s) for s in strs],
                dtype=bool)
        return np.array([pred(s) for s in strs], dtype=bool)
    if "exists" in cond:
        has = np.array([s != "" for s in strs], dtype=bool)
        return has if cond["exists"] else ~has
    raise InvalidArguments(f"unknown log filter {cond!r}")


def _fingerprint_maps(db, table_name: str, view, query: dict) -> dict:
    """Per-(filter, cond) value→bool maps from the resident fingerprint
    index, for the DSL filter kinds it can serve (contains/prefix/regex/
    eq/matches).  Only consults state that is ALREADY resident
    (RegionCacheManager.peek_table — a cold table stays fully on the
    host path); with `GREPTIME_FULLTEXT=off` or on any miss the caller's
    per-row predicate loop runs unchanged, and rows whose value the
    resident vocabulary has not seen fall back per value — the host path
    is the fallback twin at every granularity."""
    from greptimedb_tpu_torch.fulltext import enabled

    if not enabled():
        return {}
    cache_mgr = getattr(db, "cache", None)
    ex = getattr(getattr(db, "engine", None), "executor", None)
    ft = getattr(ex, "fulltext_cache", None)
    if cache_mgr is None or ft is None:
        return {}
    dt = cache_mgr.peek_table(view)
    if dt is None or getattr(dt, "dicts_root", 0) == 0:
        return {}
    out: dict = {}
    for fi, f in enumerate(query.get("filters") or []):
        col = f.get("column")
        vocab = dt.dicts.get(col)
        if not vocab:
            continue
        for ci, cond in enumerate(f.get("filters") or []):
            got = _cond_pred(cond)
            if got is None:
                continue
            kind, text, pred = got
            # the verified memo sees raw vocabulary items; truth is
            # defined over the DSL's coerced strings — one wrapper, and
            # variant="dsl" namespaces the memo so the SQL path (whose
            # subject for NULL is str(None)) can never serve this
            # coercion's truth or vice versa
            coerced = lambda v, p=pred: p("" if v is None else str(v))
            vmap = ft.verified_map(table_name, dt, col, vocab, coerced,
                                   kind, text, variant="dsl")
            if vmap is not None:
                out[(fi, ci)] = vmap
    return out


def execute_log_query(db, query: dict) -> QueryResult:
    if not isinstance(query, dict):
        raise InvalidArguments("log query body must be a JSON object")
    tbl = query.get("table") or {}
    name = tbl.get("table")
    if not name:
        raise InvalidArguments("log query needs table.table")
    schema_name = tbl.get("schema", "public")
    full = f"{schema_name}.{name}" if schema_name != db.current_db else name

    view = db._table_view(full)
    ts_name = view.schema.time_index.name
    tf = query.get("time_filter") or {}
    lo = _parse_time(tf.get("start"))
    hi = _parse_time(tf.get("end"))
    # scan only what the filters + projection touch
    needed: set[str] = set()
    for f in query.get("filters") or []:
        if f.get("column"):
            needed.add(str(f["column"]))
    if query.get("columns"):
        needed.update(str(c) for c in query["columns"])
    # without an explicit projection the response returns every column, so
    # only restrict the scan when the caller named its columns
    want = sorted(needed | {ts_name}) if query.get("columns") else None
    # tag-column filters become file-level pruning predicates evaluated
    # against each SST's exact term dictionary (inverted-index sidecar);
    # the row-level filter below still applies in full
    tag_cols = {c.name for c in view.schema.tag_columns}
    per_col: dict[str, list] = {}
    for f in query.get("filters") or []:
        col = f.get("column")
        if col in tag_cols:
            per_col.setdefault(col, []).extend(
                p for p in (_term_pred(c) for c in f.get("filters") or [])
                if p is not None
            )
    tag_preds = {
        c: (lambda t, ps=tuple(ps): all(p(t) for p in ps))
        for c, ps in per_col.items() if ps
    }
    # full-text "match" filters on string FIELD columns prune SST files
    # via the sidecar token sets
    from greptimedb_tpu_torch.datatypes.types import ConcreteDataType as _CDT
    from greptimedb_tpu_torch.storage.index import tokenize

    ft_tokens: dict[str, list] = {}
    field_cols = {c.name for c in view.schema.field_columns
                  if c.dtype in (_CDT.STRING, _CDT.JSON)}
    for f in query.get("filters") or []:
        col = f.get("column")
        if col in field_cols:
            for cond in f.get("filters") or []:
                if "match" in cond:
                    ft_tokens.setdefault(col, []).extend(
                        tokenize(str(cond["match"]))
                    )
    host = view.scan_host((lo, hi), columns=want,
                          tag_preds=tag_preds or None,
                          ft_tokens=ft_tokens or None)
    n = len(host[ts_name])
    vmaps = _fingerprint_maps(db, full, view, query)
    keep = np.ones(n, dtype=bool)
    for fi, f in enumerate(query.get("filters") or []):
        col = f.get("column")
        if col not in host:
            raise InvalidArguments(f"unknown filter column {col!r}")
        for ci, cond in enumerate(f.get("filters") or []):
            keep &= _match(cond, host[col], vmaps.get((fi, ci)))
    idx = np.nonzero(keep)[0]
    # newest first, like the reference's default ordering for log search
    order = np.argsort(host[ts_name][idx].astype(np.int64))[::-1]
    idx = idx[order]
    lim = query.get("limit") or {}
    skip = int(lim.get("skip", 0))
    fetch = lim.get("fetch")
    idx = idx[skip: skip + int(fetch)] if fetch is not None else idx[skip:]

    columns = query.get("columns")
    if columns:
        bad = [c for c in columns if c not in host]
        if bad:
            raise InvalidArguments(f"unknown columns {bad}")
        names = list(columns)
    else:
        names = [c.name for c in view.schema]
    rows = []
    for i in idx.tolist():
        row = []
        for c in names:
            v = host[c][i]
            row.append(int(v) if isinstance(v, np.integer) else
                       float(v) if isinstance(v, np.floating) else v)
        rows.append(row)
    return QueryResult(names, rows)
