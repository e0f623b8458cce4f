"""Loki read API evaluator: LogQL over the resident log table.

The port of the JAX package's ``fulltext/loki.py``.  The evaluation
strategy is the scan pipeline's code-not-object discipline end to end:

- stream selection reuses the PromQL machinery (``SelectorData`` → the
  inverted index over the tag dictionaries, resident matched-tsid
  selections);
- line filters evaluate per DISTINCT line (``fulltext/resident.py``: the
  ``fp_candidates`` prefilter + exact verification, memoized per
  lineage) and reach rows as ONE device gather ``verified[codes]``;
- metric range aggregations (``count_over_time``/``rate``/``bytes_*``)
  lower onto the PromQL ``window_stats`` kernel, kind ``gauge_window``:
  ``logs_layout`` builds the composite key in the resident table's own
  (tsid, ts) order (the identity permutation, so no per-eval sort),
  ``series_offsets`` each stream's first row (the window kernels' range
  geometry) and ``line_vals`` the indicator (or byte-length) value
  vector, whose window sum IS the count;
- log (stream) queries select rows with the fused ``row_match`` kernel;
  only ``| json`` / ``| logfmt`` / label filters drop to per-row host
  work, and only over rows that already passed the device mask.

The four kernels live in ``ops/fulltext_kernels.py``.
``GREPTIME_FULLTEXT=off`` keeps the same composition but rebuilds the
per-distinct-line truth with the host predicate loop on every
evaluation; results are bit-exact either way.

The HTTP routes (``/loki/api/v1/...``) wait for the servers; the entry
points below take the route's parameters as a dict.
"""

from __future__ import annotations

import json as _json
import re

import numpy as np
import torch

from greptimedb_tpu_torch.errors import InvalidArguments, TableNotFound
from greptimedb_tpu_torch.fulltext import fingerprint as fpm
from greptimedb_tpu_torch.fulltext.logql import (
    LineFilter, LogQuery, RangeAgg, VectorAgg, parse_logql,
)
from greptimedb_tpu_torch.fulltext.resident import _host_verified, _pow2
from greptimedb_tpu_torch.ops import fulltext_kernels as fk
from greptimedb_tpu_torch.ops import promql_kernels as pk
from greptimedb_tpu_torch.query.parser import parse_timestamp_str
from greptimedb_tpu_torch.storage.memtable import TSID
from greptimedb_tpu_torch.utils.tracing import TRACER

DEFAULT_TABLE = "loki_logs"
DEFAULT_LIMIT = 100


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def parse_loki_time_ns(v, default_ns: int | None = None) -> int:
    """Loki time params: integer nanoseconds, float unix seconds, or
    RFC3339.  Magnitude disambiguates the numeric forms (< 1e12 =
    seconds — nanosecond timestamps of that size would be 1970)."""
    if v is None:
        if default_ns is None:
            raise InvalidArguments("missing time parameter")
        return default_ns
    s = str(v)
    try:
        f = float(s)
    except ValueError:
        return int(parse_timestamp_str(s) * 1_000_000)
    if abs(f) < 1e12:
        return int(f * 1e9)
    return int(f)


# ---------------------------------------------------------------------------
# line filters
# ---------------------------------------------------------------------------


def _filter_pred(f: LineFilter):
    """LineFilter → (kind, text, positive predicate, negate) — the ONE
    definition of line-filter truth (prefilter spec + host verification
    + the =off twin all consume exactly this predicate)."""
    if f.op in ("|=", "!="):
        return ("contains", f.text,
                (lambda v, t=f.text: t in str(v)), f.op == "!=")
    try:
        rx = re.compile(f.text)
    except re.error as e:
        raise InvalidArguments(f"bad line-filter regex {f.text!r}: {e}")
    return ("regex", f.text,
            (lambda v, rx=rx: rx.search(str(v)) is not None), f.op == "!~")


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------


class LokiEvaluator:
    def __init__(self, db, table: str = DEFAULT_TABLE):
        self.db = db
        self.table_name = table
        from greptimedb_tpu_torch.promql.engine import SelectorData

        self.data = SelectorData(db, table)
        self.view = self.data.region
        self.table = self.data.table  # resident DeviceTable
        schema = self.view.schema
        self.ts_name = schema.time_index.name
        unit = schema.time_index.dtype.time_unit
        self.unit_per_ms = unit.per_second / 1000.0
        fields = [c.name for c in schema.field_columns
                  if c.dtype.is_string_like]
        if not fields:
            raise InvalidArguments(
                f"table {table!r} has no string field column to serve as "
                "the log line")
        self.line_col = "line" if "line" in fields else fields[0]
        ex = getattr(getattr(db, "engine", None), "executor", None)
        self.ft_cache = getattr(ex, "fulltext_cache", None)
        self.device = self.table.row_mask.device

    # ---- unit conversions ---------------------------------------------
    def ns_to_unit(self, ns: int) -> int:
        return int(ns // 1_000_000 * self.unit_per_ms)

    def unit_to_ns(self, u: int) -> int:
        return int(u / self.unit_per_ms) * 1_000_000

    # ---- shared pieces ------------------------------------------------
    def _matchers(self, q: LogQuery):
        from greptimedb_tpu_torch.promql.parser import LabelMatcher

        return [LabelMatcher(m.name, m.op, m.value) for m in q.matchers]

    def _verified_vector(self, q: LogQuery):
        """Combined line-filter truth per distinct line, as a padded
        bool vector on the table's device + its padded length.  The
        fulltext cache path (prefilter + memo) and the =off host twin
        produce bit-identical vectors — only the cost differs."""
        vocab = self.table.dicts.get(self.line_col, [])
        n = len(vocab)
        npad = _pow2(n)  # the ONE padding rule (resident.py)
        filters = [_filter_pred(f) for f in q.line_filters]
        if not filters:
            ones = np.ones(npad, dtype=bool)
            ones[n:] = False
            return torch.from_numpy(ones).to(self.device), npad
        if self.ft_cache is not None and fpm.enabled():
            got = self.ft_cache.line_filter_vector(
                self.table_name, self.table, self.line_col, vocab, filters)
            if got is not None:
                return got
        combined = np.ones(n, dtype=bool)
        for _kind, _text, pred, neg in filters:
            v = _host_verified(vocab, pred)
            combined &= ~v if neg else v
        padded = np.zeros(npad, dtype=bool)
        padded[:n] = combined
        return torch.from_numpy(padded).to(self.device), npad

    def _byte_lengths(self, npad: int) -> torch.Tensor:
        """Per-distinct-line UTF-8 byte lengths, lineage-memoized in the
        fulltext cache (warm bytes_* evals skip the O(vocab) loop); the
        transient loop below is the =off twin — same "" coercion for
        NULL as the row-level paths, so the two can never diverge."""
        vocab = self.table.dicts.get(self.line_col, [])
        if self.ft_cache is not None:
            dev = self.ft_cache.byte_lengths(
                self.table_name, self.table, self.line_col, vocab, npad)
            if dev is not None:
                return dev
        out = np.zeros(npad, dtype=np.float32)
        for i, v in enumerate(vocab):
            out[i] = len(("" if v is None else str(v)).encode("utf-8"))
        return torch.from_numpy(out).to(self.device)

    # ---- metric queries -----------------------------------------------
    def eval_metric(self, agg: RangeAgg, start_ns: int, end_ns: int,
                    step_ns: int):
        """[S, T] window values + per-series labels + step timestamps.
        Windows are PromQL's left-exclusive (t - range, t]."""
        q = agg.query
        start_u = self.ns_to_unit(start_ns)
        end_u = self.ns_to_unit(end_ns)
        step_u = max(self.ns_to_unit(step_ns), 1)
        range_u = max(int(agg.range_ms * self.unit_per_ms), 1)
        T = max(int((end_u - start_u) // step_u) + 1, 1)
        if T > 11000:
            raise InvalidArguments(
                f"query would produce {T} steps (max 11000)")
        sel_tsids, sel_dev, labels = self.data.select_series(
            self._matchers(q))
        verified, npad = self._verified_vector(q)
        cols = self.table.columns
        codes = cols[self.line_col]
        ts = cols[self.ts_name]
        tsid = cols[TSID]
        mask = self.table.row_mask

        if q.needs_rows:
            return self._eval_metric_rows(
                agg, q, sel_tsids, labels, start_u, step_u, range_u, T,
                verified)

        with TRACER.stage("logql_window", fn=agg.fn):
            key, ts_min, kp = fk.logs_layout(ts, tsid, mask)
            off = pk.series_offsets(key, kp, self.table.num_series)
            blen = (self._byte_lengths(npad)
                    if agg.fn in ("bytes_over_time", "bytes_rate") else None)
            vals, ind = fk.line_vals(codes, verified, mask, blen)

            def window_sums(v):
                out = pk.window_stats(
                    (key, ts, v, tsid, mask, ts_min, kp, off), sel_dev,
                    start_u, step_ms=step_u, num_steps=T, range_ms=range_u,
                    kind="gauge_window")
                # THE one [S, T] result readback per metric eval
                return out["sum"][: len(sel_tsids)].cpu().numpy()

            sums = window_sums(vals)
            # a bytes query counts matched lines by a second window sum
            # over the indicator: window_stats' own count counts every
            # live row, matched or not
            counts = sums if ind is vals else window_sums(ind)
        values = self._finish_range_fn(agg, sums, range_u)
        return values, counts, labels, [start_u + i * step_u
                                        for i in range(T)]

    def _finish_range_fn(self, agg: RangeAgg, sums, range_u):
        # window sums are exact integers carried in f32; widen BEFORE any
        # arithmetic so rates print as clean decimals, not f32 artifacts
        sums = np.asarray(sums, dtype=np.float64)
        if agg.fn in ("rate", "bytes_rate"):
            range_s = range_u / self.unit_per_ms / 1000.0
            return sums / max(range_s, 1e-12)
        return sums

    def _eval_metric_rows(self, agg, q, sel_tsids, labels, start_u,
                          step_u, range_u, T, verified):
        """Host tier for pipelines with parser stages / label filters:
        the device mask narrows to matching rows first, extraction and
        window counting run host-side over only those."""
        lo = start_u - range_u  # earliest unit any window can touch
        hi = start_u + (T - 1) * step_u + 1
        rows = self._gather_rows(q, sel_tsids, lo, hi, verified,
                                 apply_stages=True)
        S = len(sel_tsids)
        pos_of = {int(t): i for i, t in enumerate(sel_tsids)}
        steps = np.asarray([start_u + i * step_u for i in range(T)],
                           dtype=np.int64)
        sums = np.zeros((S, T), dtype=np.float64)
        counts = np.zeros((S, T), dtype=np.float64)
        by_series: dict[int, list[tuple[int, float]]] = {}
        for r in rows:
            by_series.setdefault(r["tsid"], []).append(
                (r["ts"], float(len(str(r["line"]).encode("utf-8")))))
        for t, ent in by_series.items():
            i = pos_of.get(t)
            if i is None:
                continue
            ent.sort()
            tss = np.asarray([e[0] for e in ent], dtype=np.int64)
            blen = np.asarray([e[1] for e in ent], dtype=np.float64)
            cb = np.concatenate([[0.0], np.cumsum(blen)])
            # (t - range, t]: left-exclusive, like the device kernel
            lo_i = np.searchsorted(tss, steps - range_u, side="right")
            hi_i = np.searchsorted(tss, steps, side="right")
            counts[i] = hi_i - lo_i
            sums[i] = (cb[hi_i] - cb[lo_i]
                       if agg.fn in ("bytes_over_time", "bytes_rate")
                       else counts[i])
        values = self._finish_range_fn(agg, sums, range_u)
        return values, counts, labels, [int(s) for s in steps]

    # ---- log (stream) queries -----------------------------------------
    def _gather_rows(self, q: LogQuery, sel_tsids, lo_u, hi_u, verified,
                     apply_stages: bool):
        """Matching rows as host dicts {ts, tsid, line, extracted}: the
        fused device mask picks candidates, host work runs only on them.
        """
        cols = self.table.columns
        S = max(len(sel_tsids), 1)
        sel = np.full(S, -1, dtype=np.int32)
        sel[: len(sel_tsids)] = sel_tsids
        ok = fk.row_match(cols[self.line_col], verified, self.table.row_mask,
                          cols[self.ts_name], cols[TSID],
                          torch.from_numpy(sel).to(self.device), lo_u, hi_u,
                          num_series=self.table.num_series)
        # the one row-mask readback per log query, as matching row ids
        idx = torch.nonzero(ok).flatten()
        vocab = self.table.dicts.get(self.line_col, [])
        ts_h = cols[self.ts_name][idx].cpu().numpy()
        tsid_h = cols[TSID][idx].cpu().numpy()
        code_h = cols[self.line_col][idx].cpu().numpy()
        out = []
        for ts_v, tsid_v, c in zip(ts_h.tolist(), tsid_h.tolist(),
                                   code_h.tolist()):
            line = vocab[c] if 0 <= c < len(vocab) else ""
            row = {"ts": int(ts_v), "tsid": int(tsid_v),
                   "line": "" if line is None else str(line),
                   "extracted": None}
            out.append(row)
        if apply_stages and q.needs_rows:
            out = [r for r in out if self._apply_stages(q, r)]
        return out

    def _apply_stages(self, q: LogQuery, row) -> bool:
        """Parser stages + label filters over one row (line filters were
        already device-applied).  Extracted fields accumulate into
        row['extracted']."""
        from greptimedb_tpu_torch.fulltext.logql import LabelFilter, ParserStage

        extracted: dict[str, str] = {}
        for stage in q.stages:
            if isinstance(stage, ParserStage):
                if stage.kind == "json":
                    try:
                        obj = _json.loads(row["line"])
                    except (ValueError, TypeError):
                        return False  # Loki: unparseable rows drop
                    if isinstance(obj, dict):
                        for k, v in obj.items():
                            if isinstance(v, (str, int, float, bool)):
                                extracted[_safe_label(str(k))] = (
                                    _json_scalar(v))
                else:  # logfmt
                    extracted.update(_parse_logfmt(row["line"]))
            elif isinstance(stage, LabelFilter):
                val = extracted.get(stage.name)
                if val is None:
                    val = self._stream_label(row["tsid"], stage.name)
                if not _label_filter_ok(stage, val):
                    return False
        row["extracted"] = extracted or None
        return True

    def _stream_label(self, tsid: int, name: str) -> str:
        from greptimedb_tpu_torch.storage.inverted import get_series_index

        idx = get_series_index(self.view)
        vals = idx.raw_values.get(name)
        if vals is None:
            return ""
        code = int(idx.codes_for(name, np.asarray([tsid]))[0])
        return str(vals[code]) if 0 <= code < len(vals) else ""

    def eval_streams(self, q: LogQuery, start_ns: int, end_ns: int,
                     limit: int, forward: bool):
        """Log-selector query → Loki streams: newest (or oldest) ``limit``
        matching entries in [start, end), grouped by stream label set."""
        sel_tsids, _sel_dev, labels = self.data.select_series(
            self._matchers(q))
        verified, _npad = self._verified_vector(q)
        rows = self._gather_rows(
            q, sel_tsids, self.ns_to_unit(start_ns),
            max(self.ns_to_unit(end_ns), self.ns_to_unit(start_ns) + 1),
            verified, apply_stages=True)
        rows.sort(key=lambda r: r["ts"], reverse=not forward)
        rows = rows[: max(limit, 0)]
        pos_of = {int(t): i for i, t in enumerate(sel_tsids)}
        streams: dict = {}
        for r in rows:
            i = pos_of.get(r["tsid"])
            lab = {k: str(v) for k, v in (labels[i] if i is not None
                                          else {}).items() if str(v) != ""}
            if r["extracted"]:
                lab.update(r["extracted"])
            skey = tuple(sorted(lab.items()))
            entry = streams.setdefault(skey, {"stream": dict(skey),
                                              "values": []})
            entry["values"].append(
                [str(self.unit_to_ns(r["ts"])), r["line"]])
        return list(streams.values())

    # ---- vector aggregation -------------------------------------------
    def apply_vector_agg(self, va: VectorAgg, values, counts, labels):
        """sum/min/max/avg/count by/without over the [S, T] matrix —
        host-side over output groups (S is streams, not rows)."""
        S = values.shape[0]
        groups: dict[tuple, list[int]] = {}
        for i in range(S):
            lab = {k: str(v) for k, v in labels[i].items() if str(v) != ""}
            if va.grouped:
                if va.without:
                    key = tuple(sorted((k, v) for k, v in lab.items()
                                       if k not in va.grouping))
                else:
                    key = tuple((k, lab.get(k, "")) for k in va.grouping)
            else:
                key = ()
            groups.setdefault(key, []).append(i)
        out_vals, out_counts, out_labels = [], [], []
        for key, idxs in groups.items():
            sub = values[idxs]
            subc = counts[idxs]
            present = subc > 0
            cnt = present.sum(axis=0)
            masked = np.where(present, sub, 0.0)
            if va.fn == "sum":
                v = masked.sum(axis=0)
            elif va.fn == "min":
                v = np.where(present, sub, np.inf).min(axis=0)
            elif va.fn == "max":
                v = np.where(present, sub, -np.inf).max(axis=0)
            elif va.fn == "avg":
                v = masked.sum(axis=0) / np.maximum(cnt, 1)
            else:  # count (of contributing streams)
                v = cnt.astype(np.float64)
            out_vals.append(v)
            out_counts.append(cnt)
            out_labels.append({k: v2 for k, v2 in key})
        return (np.asarray(out_vals).reshape(len(groups), -1),
                np.asarray(out_counts).reshape(len(groups), -1),
                out_labels)


def _safe_label(k: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", k)


def _json_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


_LOGFMT_RE = re.compile(
    r'([A-Za-z_][A-Za-z0-9_]*)=("(?:\\.|[^"\\])*"|[^\s"]*)')


def _parse_logfmt(line: str) -> dict[str, str]:
    out = {}
    for k, v in _LOGFMT_RE.findall(line):
        if v.startswith('"'):
            try:
                v = _json.loads(v)
            except ValueError:
                v = v[1:-1]
        out[_safe_label(k)] = str(v)
    return out


def _label_filter_ok(f, val: str) -> bool:
    if f.numeric:
        try:
            x = float(val)
        except (TypeError, ValueError):
            return False
        y = float(f.value)
        return {"==": x == y, "!=": x != y, ">": x > y, ">=": x >= y,
                "<": x < y, "<=": x <= y}[f.op]
    if f.op in ("=", "=="):
        return val == f.value
    if f.op == "!=":
        return val != f.value
    rx = re.compile(f.value)
    hit = rx.fullmatch(val) is not None
    return hit if f.op == "=~" else not hit


# ---------------------------------------------------------------------------
# entry points: the Loki read API's routes, each taking the route's
# parameters as a dict (the reference's servers/http.py calls them through
# its query scheduler)
# ---------------------------------------------------------------------------


def _success(data: dict) -> dict:
    return {"status": "success", "data": data}


def _metric_result(values, counts, labels, steps_u, ev: LokiEvaluator,
                   matrix: bool):
    """[G, T] values → Loki matrix/vector payload; a sample exists only
    where the window actually contained entries (count > 0)."""
    result = []
    for i in range(values.shape[0]):
        pts = []
        for j, su in enumerate(steps_u):
            if counts[i, j] > 0:
                sec = ev.unit_to_ns(int(su)) / 1e9
                pts.append([sec, _fmt_float(values[i, j])])
        if not pts:
            continue
        metric = {k: str(v) for k, v in labels[i].items() if str(v) != ""}
        if matrix:
            result.append({"metric": metric, "values": pts})
        else:
            result.append({"metric": metric, "value": pts[-1]})
    return result


def _fmt_float(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _eval(db, query: str, table: str, start_ns: int, end_ns: int,
          step_ns: int, limit: int, forward: bool, instant: bool) -> dict:
    expr = parse_logql(query)
    try:
        ev = LokiEvaluator(db, table)
    except TableNotFound:
        kind = ("streams" if isinstance(expr, LogQuery)
                else "vector" if instant else "matrix")
        return _success({"resultType": kind, "result": []})
    if isinstance(expr, LogQuery):
        streams = ev.eval_streams(expr, start_ns, end_ns, limit, forward)
        return _success({"resultType": "streams", "result": streams})
    va = expr if isinstance(expr, VectorAgg) else None
    agg = va.inner if va is not None else expr
    if instant:
        # metric instant query: one step, evaluated exactly at ``end``
        start_ns = end_ns
    values, counts, labels, steps_u = ev.eval_metric(
        agg, start_ns, end_ns, step_ns if not instant else 1_000_000_000)
    if va is not None:
        values, counts, labels = ev.apply_vector_agg(
            va, np.asarray(values), np.asarray(counts), labels)
    result = _metric_result(np.asarray(values), np.asarray(counts), labels,
                            steps_u, ev, matrix=not instant)
    return _success({"resultType": "matrix" if not instant else "vector",
                     "result": result})


def loki_query_range(db, params: dict) -> dict:
    query = params.get("query")
    if not query:
        raise InvalidArguments("missing query parameter")
    import time as _time

    now_ns = int(_time.time() * 1e9)
    end_ns = parse_loki_time_ns(params.get("end"), now_ns)
    start_ns = parse_loki_time_ns(params.get("start"),
                                  end_ns - 3_600_000_000_000)
    step = params.get("step")
    if step is None:
        step_ns = max((end_ns - start_ns) // 100, 1_000_000_000)
    else:
        try:
            step_ns = int(float(step) * 1e9)
        except ValueError:
            from greptimedb_tpu_torch.fulltext.logql import parse_duration_ms

            step_ns = parse_duration_ms(str(step)) * 1_000_000
    limit = int(params.get("limit", DEFAULT_LIMIT))
    forward = str(params.get("direction", "backward")) == "forward"
    return _eval(db, query, params.get("table", DEFAULT_TABLE), start_ns,
                 end_ns, max(step_ns, 1), limit, forward, instant=False)


def loki_query_instant(db, params: dict) -> dict:
    query = params.get("query")
    if not query:
        raise InvalidArguments("missing query parameter")
    import time as _time

    t_ns = parse_loki_time_ns(params.get("time"), int(_time.time() * 1e9))
    limit = int(params.get("limit", DEFAULT_LIMIT))
    forward = str(params.get("direction", "backward")) == "forward"
    # log-selector instant queries return the most recent entries up to
    # ``time`` (a 1h window, Loki's instant-query convention for logs)
    return _eval(db, query, params.get("table", DEFAULT_TABLE),
                 t_ns - 3_600_000_000_000, t_ns + 1, 1, limit, forward,
                 instant=True)


def loki_labels(db, params: dict) -> dict:
    table = params.get("table", DEFAULT_TABLE)
    try:
        view = db._table_view(table)
    except TableNotFound:
        return _success([])
    return _success(sorted(c.name for c in view.schema.tag_columns))


def loki_label_values(db, name: str, params: dict) -> dict:
    table = params.get("table", DEFAULT_TABLE)
    try:
        view = db._table_view(table)
    except TableNotFound:
        return _success([])
    enc = view.encoders.get(name)
    if enc is None:
        return _success([])
    vals = sorted({str(v) for v in enc.values() if str(v) != ""})
    return _success(vals)


def loki_series(db, matches: list, params: dict) -> dict:
    table = params.get("table", DEFAULT_TABLE)
    out = []
    try:
        ev = LokiEvaluator(db, table)
    except (TableNotFound, InvalidArguments):
        return _success([])
    seen = set()
    for m in matches or []:
        expr = parse_logql(m)
        q = expr if isinstance(expr, LogQuery) else None
        if q is None:
            continue
        _tsids, _dev, labels = ev.data.select_series(ev._matchers(q))
        for i in range(len(_tsids)):
            lab = {k: str(v) for k, v in labels[i].items()
                   if str(v) != ""}
            key = tuple(sorted(lab.items()))
            if key not in seen:
                seen.add(key)
                out.append(lab)
    return _success(out)


# ---------------------------------------------------------------------------
# ingest-side prewarm (called from servers/ingest.py loki_push)
# ---------------------------------------------------------------------------

import threading as _threading

_PREWARM_LOCK = _threading.Lock()


def prewarm_ingest(db, table: str = DEFAULT_TABLE) -> bool:
    """Opportunistic ingest-side fingerprint extension: when the table's
    fingerprint matrix is already resident (someone queried), extend the
    resident DeviceTable by the pushed rows (``RegionCacheManager.get``:
    an append keeps the table's ``dicts_root``) and fingerprint only the
    new dictionary entries — the vocabulary tail — NOW, so the next query
    finds both current.  Non-blocking (contending ingest workers skip —
    the query path stays responsible) and inert until first query / with
    fulltext off."""
    if not fpm.enabled():
        return False
    ex = getattr(getattr(db, "engine", None), "executor", None)
    cache = getattr(ex, "fulltext_cache", None)
    if cache is None:
        return False
    with cache._struct_lock:
        resident = any(k[0] == "fp" and k[1] == table for k in cache._lru)
    if not resident:
        return False
    if not _PREWARM_LOCK.acquire(blocking=False):
        return False
    try:
        view = db._table_view(table)
        dt = db.cache.get(view)
        fields = [c.name for c in view.schema.field_columns
                  if c.dtype.is_string_like]
        line_col = "line" if "line" in fields else (
            fields[0] if fields else None)
        if line_col is None:
            return False
        vocab = dt.dicts.get(line_col)
        root = getattr(dt, "dicts_root", None)
        if not vocab or root is None:
            return False
        with TRACER.stage("fulltext_prewarm", table=table):
            cache._fingerprints(table, root, line_col, vocab,
                                dt.row_mask.device)
        return True
    except Exception:  # noqa: BLE001 — best-effort: queries rebuild
        return False
    finally:
        _PREWARM_LOCK.release()
