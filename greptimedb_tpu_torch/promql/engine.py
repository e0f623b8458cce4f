"""PromQL evaluation: range queries as dense [series, steps] tensor work.

Counterpart of the reference's ``greptimedb_tpu/promql/engine.py``.
Pipeline per selector:

1. host: match series against label matchers over the region's inverted
   index (dictionary codes, no string work per series);
2. device: the resident table's composite (tsid, ts)-key sort
   (``ops/promql_kernels.sort_layout``, cached per region generation and
   field column), then per-(series, step) window statistics by binary
   search over the sorted keys and a counter-reset-adjusted f64 prefix
   scan (``prefix_scan``/``counter_window``; Prometheus extrapolation,
   reference src/promql/src/functions/extrapolate_rate.rs:56);
3. device: cross-series aggregation = series→group merge
   (``ops/grid_kernels.group_merge``).

NaN encodes "absent" throughout (Prometheus staleness semantics).

Ported: number literals, instant and range selectors under
rate/increase/delta, unary minus, the elementwise math functions, and
sum/avg/count/group/min/max aggregations (by/without).  Every other node
or function raises ``Unsupported("… not ported yet")``.  There is no
per-shape compile stage: the kernels take their shapes as arguments.
"""

from __future__ import annotations

import collections
import collections.abc
import os
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from greptimedb_tpu_torch.errors import PlanError, TableNotFound, Unsupported
from greptimedb_tpu_torch.ops import grid_kernels as gk
from greptimedb_tpu_torch.ops import promql_kernels as pk
from greptimedb_tpu_torch.promql.parser import (
    Aggregation, FunctionCall, LabelMatcher, NumberLit, PromExpr,
    UnaryExpr, VectorSelector, parse_promql,
)
from greptimedb_tpu_torch.storage.memtable import TSID
from greptimedb_tpu_torch.utils.telemetry import REGISTRY
from greptimedb_tpu_torch.utils.tracing import TRACER

DEFAULT_LOOKBACK_S = 300.0

# Per-stage wall time of the PromQL hot loop (device_table → selection →
# sort_layout → window_kernel/fused_kernel → group_agg → label_decode).
M_PROMQL_STAGE = REGISTRY.histogram(
    "greptime_promql_stage_seconds",
    "PromQL evaluation stage wall time",
    labels=("stage",),
)

# the elementwise math table (reference engine.py:1078-1086)
_SIMPLE = {
    "abs": torch.abs, "ceil": torch.ceil, "floor": torch.floor,
    "exp": torch.exp, "ln": torch.log, "log2": torch.log2,
    "log10": torch.log10, "sqrt": torch.sqrt, "sgn": torch.sign,
    "acos": torch.acos, "asin": torch.asin, "atan": torch.atan,
    "cos": torch.cos, "sin": torch.sin, "tan": torch.tan,
    "cosh": torch.cosh, "sinh": torch.sinh, "tanh": torch.tanh,
    "deg": torch.rad2deg, "rad": torch.deg2rad,
}
_COUNTER_FUNCS = ("rate", "increase", "delta")
_AGG_OPS = ("sum", "avg", "count", "group", "min", "max")


class LazySeriesLabels(collections.abc.Sequence):
    """Label dicts for a matched series set, decoded ON DEMAND: only the
    tsid vector plus references into the region's dictionary state, so an
    aggregation decodes exactly its output groups.  Also carries the
    selection's provenance (region id, generation, matcher key) so the
    aggregation can key its resident group-id cache."""

    materializations = 0

    def __init__(self, idx, tag_names, values, tsids, region_id: int,
                 generation, matcher_key: tuple, cache):
        self.idx = idx  # SeriesInvertedIndex (codes + vocabs)
        self.tag_names = tag_names
        self.values = values  # column -> raw encoder values (code-indexed)
        self.tsids = tsids  # np.int32 [S]
        self.region_id = region_id
        self.generation = generation
        self.matcher_key = matcher_key
        self.cache = cache  # PromLayoutCache or None

    def _label_at(self, i: int) -> dict:
        LazySeriesLabels.materializations += 1
        tsid = int(self.tsids[i])
        codes = self.idx.codes
        values = self.values
        return {
            name: values[name][int(codes[name][tsid])]
            for name in self.tag_names
            if 0 <= codes[name][tsid] < len(values[name])
        }

    def __len__(self) -> int:
        return len(self.tsids)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._label_at(j) for j in range(*i.indices(len(self)))]
        return self._label_at(i)

    def __eq__(self, other):
        if not isinstance(other, (list, tuple, collections.abc.Sequence)):
            return NotImplemented
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other))

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"<LazySeriesLabels n={len(self)}>"


class LazyGroupLabels(collections.abc.Sequence):
    """Aggregation output labels, decoded per GROUP on demand from each
    group's representative (first-appearance) input series."""

    def __init__(self, source, rep_rows, key_fn):
        self.source = source  # input labels (usually LazySeriesLabels)
        self.rep_rows = rep_rows  # np [ng] row index of each group's rep
        self.key_fn = key_fn  # lab dict -> ((k, str v), ...) group key

    def __len__(self) -> int:
        return len(self.rep_rows)

    def _label_at(self, g: int) -> dict:
        return dict(self.key_fn(self.source[int(self.rep_rows[g])]))

    def __getitem__(self, g):
        if isinstance(g, slice):
            return [self._label_at(j) for j in range(*g.indices(len(self)))]
        return self._label_at(g)

    def __eq__(self, other):
        if not isinstance(other, (list, tuple, collections.abc.Sequence)):
            return NotImplemented
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other))

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"<LazyGroupLabels n={len(self)}>"


@dataclass
class EvalResult:
    """A (possibly scalar) instant-vector time series matrix."""

    values: torch.Tensor  # [S, T] f32; NaN = absent
    labels: "list[dict] | LazySeriesLabels | LazyGroupLabels"  # len S
    is_scalar: bool = False

    @property
    def num_series(self) -> int:
        return len(self.labels)


def matcher_pred(matcher: LabelMatcher):
    """Matcher → (term predicate, negate): PromQL matcher semantics,
    evaluated per DISTINCT term by the inverted index (=~ is fully
    anchored, as in Prometheus)."""
    if matcher.op == "=":
        return (lambda t, mv=matcher.value: t == mv), False
    if matcher.op == "!=":
        return (lambda t, mv=matcher.value: t == mv), True
    if matcher.op in ("=~", "!~"):
        rx = re.compile(matcher.value)
        return (lambda t, rx=rx: rx.fullmatch(t) is not None), (
            matcher.op == "!~"
        )
    raise PlanError(f"bad matcher {matcher.op}")


def _group_payload(gids: np.ndarray, ng: int, rep_rows, device) -> tuple:
    """Group ids → (gid_dev [S] i32, ng, rep_rows, row_order_dev [S] i32,
    seg_start np [ng], offsets_dev [ng+1] i64): the CSR routing
    ``group_merge`` walks (stable order, ascending series in a group)."""
    row_order = np.argsort(gids, kind="stable")
    seg_start = np.searchsorted(gids[row_order], np.arange(ng))
    offsets = np.append(seg_start, len(gids)).astype(np.int64)
    return (torch.as_tensor(gids.astype(np.int32), device=device), ng,
            rep_rows,
            torch.as_tensor(row_order.astype(np.int32), device=device),
            seg_start, torch.as_tensor(offsets, device=device))


def _series_group_ids(idx, tsids: np.ndarray, grouping, without: bool,
                      device):
    """Vectorized by/without group assignment from dictionary-encoded tag
    codes — no per-series Python.  Per relevant column, codes remap to
    canonical str-level term ids (missing merges with "" for ``by``,
    stays distinct for ``without``); columns combine mixed-radix with
    dense re-encoding before any possible int64 overflow; final ids
    renumber by first appearance so group order matches the host
    enumeration.  Returns ``_group_payload``'s tuple."""
    if without:
        use = sorted(n for n in idx.tag_names if n not in grouping)
    else:
        use = sorted(n for n in grouping if n in idx.codes)
    S = len(tsids)
    tsids64 = tsids.astype(np.int64)
    combined = np.zeros(S, dtype=np.int64)
    ncomb = 1
    for name in use:
        codes = idx.codes_for(name, tsids64)
        V = len(idx.vocabs.get(name, []))
        remap, ncanon = idx.canonical_codes(name,
                                            merge_missing_empty=not without)
        pres = (codes >= 0) & (codes < V)
        comp = remap[np.where(pres, codes, V)]
        if ncanon > 1 and ncomb > (1 << 62) // ncanon:
            _u, combined = np.unique(combined, return_inverse=True)
            ncomb = len(_u)
        combined = combined * ncanon + comp
        ncomb *= max(ncanon, 1)
    _uniq, first_idx, inv = np.unique(
        combined, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(_uniq), dtype=np.int64)
    rank[order] = np.arange(len(_uniq))
    gids = rank[inv.reshape(-1)].astype(np.int32)
    return _group_payload(gids, len(_uniq), first_idx[order], device)


def group_reduce(v: torch.Tensor, layout: gk.GroupLayout,
                 op: str) -> torch.Tensor:
    """The aggregation math of the reference's ``eval_aggregation``
    (engine.py:1567-1600) for sum/avg/count/group/min/max over ``v``
    ``[S, T]``: absent (NaN) cells are skipped, an empty group is NaN.
    Counts sum in int64, values through ``group_merge``."""
    present = ~torch.isnan(v)
    cnt = gk.group_merge(present.to(torch.int64), layout, "sum")
    has = cnt > 0
    if op in ("count", "group"):
        return torch.where(has, cnt.to(torch.float32) if op == "count"
                           else 1.0, float("nan"))
    if op in ("sum", "avg"):
        s = gk.group_merge(torch.where(present, v, 0.0), layout, "sum")
        if op == "avg":
            s = s / torch.clamp(cnt.to(torch.float32), min=1)
        return torch.where(has, s, float("nan"))
    fill = float("inf") if op == "min" else float("-inf")
    red = gk.group_merge(torch.where(present, v, fill), layout, op)
    return torch.where(has, red, float("nan"))


# ---------------------------------------------------------------------------
# Window geometry parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WindowParams:
    """Shape of one window evaluation: step, steps, window width (the
    lookback for instant selectors), padded selected series, and which
    statistics (``kind``: instant/counter) it computes."""

    step_ms: int
    num_steps: int
    range_ms: int
    num_sel: int
    kind: str


class SelectorData:
    """Host-side prepared state for one table used by selectors."""

    def __init__(self, db, table: str, events=None):
        region = db._table_view(table)
        self.db = db
        self.region = region
        self.table = db.cache.get(region)
        self.schema = region.schema
        self.ts_name = region.schema.time_index.name
        self.tag_names = region.tag_names
        self.encoders = region.encoders
        self.events = events if events is not None else collections.Counter()

    def promql_cache(self):
        """The db's resident PromLayoutCache, or None when caching is off
        (``GREPTIME_PROMQL_CACHE=off``) or the db has none.  Both states
        serve evaluations from the same code."""
        if os.environ.get("GREPTIME_PROMQL_CACHE", "on") == "off":
            return None
        return getattr(self.db, "promql_cache", None)

    def field_column(self, matchers: list[LabelMatcher]) -> str:
        fields = [c.name for c in self.schema.field_columns]
        for m in matchers:
            if m.name == "__field__":
                if m.value not in fields:
                    raise PlanError(f"field {m.value} not in {self.table!r}")
                return m.value
        for cand in ("greptime_value", "val", "value"):
            if cand in fields:
                return cand
        if len(fields) == 1:
            return fields[0]
        raise PlanError(
            f"table has {len(fields)} fields; use __field__ matcher: {fields}"
        )

    def select_series(self, matchers: list[LabelMatcher]):
        """Returns (tsids np, padded device tsids, lazy labels) matching
        the label matchers: inverted-index evaluation, one predicate per
        DISTINCT term; the selection is padded to a power of two with -1
        ids and held resident per (registry version, matcher set)."""
        from greptimedb_tpu_torch.storage.inverted import get_series_index

        tag_matchers = [m for m in matchers if m.name != "__field__"]
        mkey = tuple(sorted((m.name, m.op, m.value) for m in tag_matchers))
        gen = self.region.series_generation
        idx = get_series_index(self.region)
        cache = self.promql_cache()
        rid = self.region.region_id
        sel = None
        if cache is not None:
            sel = cache.lookup("selection", rid, mkey, gen)
            self.events["selection_hit" if sel is not None
                        else "selection_miss"] += 1
        if sel is None:
            sel_tsids = idx.all_tsids
            for m in tag_matchers:
                if sel_tsids.size == 0:
                    break
                pred, neg = matcher_pred(m)
                matched = idx.select(m.name, pred, negate=neg)
                sel_tsids = np.intersect1d(sel_tsids, matched,
                                           assume_unique=True)
            sel_tsids = sel_tsids.astype(np.int32)
            S = max(1, 1 << (max(len(sel_tsids), 1) - 1).bit_length())
            padded = np.full(S, -1, dtype=np.int32)
            padded[: len(sel_tsids)] = sel_tsids
            sel = (sel_tsids, torch.as_tensor(padded, device=self.db.device))
            if cache is not None:
                nbytes = sel_tsids.nbytes + padded.nbytes
                if cache.admit(nbytes):
                    cache.store("selection", rid, mkey, gen, sel, nbytes)
                else:
                    self.events["selection_reject"] += 1
        sel_tsids, sel_dev = sel
        labels = LazySeriesLabels(
            idx, self.tag_names, idx.raw_values, sel_tsids, rid, gen, mkey,
            cache)
        return sel_tsids, sel_dev, labels

    def sort_layout(self, fieldcol: str) -> tuple:
        """The resident composite-key sort of this table for ``fieldcol``
        (``ops/promql_kernels.sort_layout``), served from PromLayoutCache
        per (DeviceTable dicts_version, field column)."""
        cache = self.promql_cache()
        rid = self.region.region_id
        version = self.table.dicts_version
        if cache is not None:
            payload = cache.lookup("sort", rid, (fieldcol,), version)
            if payload is not None:
                self.events["sort_hit"] += 1
                return payload
            self.events["sort_miss"] += 1
        cols = self.table.columns
        arrays = pk.sort_layout(cols[self.ts_name], cols[fieldcol],
                                cols[TSID], self.table.row_mask)
        if cache is not None:
            nbytes = sum(a.numel() * a.element_size() for a in arrays)
            if cache.admit(nbytes):
                cache.store("sort", rid, (fieldcol,), version, arrays,
                            nbytes)
            else:
                self.events["sort_reject"] += 1
        return arrays


class PromEvaluator:
    def __init__(self, db, start_s: float, end_s: float, step_s: float,
                 lookback_s: float = DEFAULT_LOOKBACK_S):
        self.db = db
        if end_s < start_s:
            raise PlanError(f"invalid time range: end {end_s} < start {start_s}")
        if step_s <= 0:
            raise PlanError(f"invalid step: {step_s}")
        self.start_ms = int(round(start_s * 1000))
        self.step_ms = max(int(round(step_s * 1000)), 1)
        # integer-ms math: float division can drop the final (inclusive) step
        end_ms = int(round(end_s * 1000))
        self.num_steps = (end_ms - self.start_ms) // self.step_ms + 1
        self.lookback_ms = int(lookback_s * 1000)
        self.device = db.device
        self._data: dict[str, SelectorData] = {}
        # resident-cache events of this evaluation (selection / sort /
        # group × hit / miss / reject)
        self.cache_events: collections.Counter = collections.Counter()
        # per-stage wall ms (device_table → selection → sort_layout →
        # window_kernel/fused_kernel → group_agg → label_decode)
        self.stage_ms: dict[str, float] = {}

    def _stage_mark(self, name: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        M_PROMQL_STAGE.labels(name).observe(dt)
        self.stage_ms[name] = round(
            self.stage_ms.get(name, 0.0) + dt * 1000, 3)

    def _sync_for_stages(self) -> None:
        """Device work is asynchronous; wait for it only when someone reads
        the stage split (tracing on, or a stage sink attached)."""
        if self.device.type == "cuda" and (
                TRACER.enabled
                or getattr(self.db, "stage_sink", None) is not None):
            torch.cuda.synchronize(self.device)

    # ---- plumbing -------------------------------------------------------
    def data_for(self, metric: str) -> SelectorData:
        if metric not in self._data:
            self._data[metric] = SelectorData(self.db, metric,
                                              self.cache_events)
        return self._data[metric]

    def steps_ms(self) -> np.ndarray:
        return self.start_ms + self.step_ms * np.arange(self.num_steps,
                                                        dtype=np.int64)

    def _prep_window(self, sel: VectorSelector, kind: str):
        """Selector → window inputs: (layout, sel_dev, p, tsids, labels,
        start).  Raises TableNotFound for unknown metrics (callers
        map it to an empty vector, Prometheus semantics) and Unsupported
        for the ``@`` modifier."""
        if sel.at_ts is not None:
            raise Unsupported("the @ modifier is not ported yet")
        t0 = time.perf_counter()
        with TRACER.stage("device_table"):
            d = self.data_for(sel.metric)
        self._stage_mark("device_table", t0)
        fieldcol = d.field_column(sel.matchers)
        t0 = time.perf_counter()
        with TRACER.stage("selection"):
            tsids, sel_dev, labels = d.select_series(sel.matchers)
        self._stage_mark("selection", t0)
        rng = int(sel.range_s * 1000) if sel.range_s else self.lookback_ms
        start = self.start_ms - int(sel.offset_s * 1000)
        t0 = time.perf_counter()
        with TRACER.stage("sort_layout"):
            layout = d.sort_layout(fieldcol)
            self._sync_for_stages()
        self._stage_mark("sort_layout", t0)
        p = WindowParams(step_ms=self.step_ms, num_steps=self.num_steps,
                         range_ms=rng, num_sel=int(sel_dev.shape[0]),
                         kind=kind)
        return layout, sel_dev, p, tsids, labels, start

    def _window(self, layout, sel_dev, p: WindowParams, start: int,
                func=None, range_s=None):
        """The window statistics (``kind`` of ``p``; rate mode when
        ``func`` is given) over the padded selection: K10's counter-drop
        prefix scan, then ``counter_window``."""
        gdrop = None
        if p.kind == "counter":
            _key, _ts, val_s, tsid_s, valid_s, _tmin, _kp = layout
            gdrop = pk.prefix_scan(val_s, tsid_s, valid_s)
        return pk.counter_window(
            layout, gdrop, sel_dev, start, step_ms=p.step_ms,
            num_steps=p.num_steps, range_ms=p.range_ms,
            kind="rate" if func is not None else p.kind, func=func,
            range_s=range_s)

    def _run_window(self, sel: VectorSelector, kind: str, func=None):
        """The window statistics of ``kind`` over the selected series (a
        dict of ``[n, T]`` tensors), or with ``func`` (rate/increase/delta)
        its ``[n, T]`` values from ``counter_window``'s rate mode; and the
        series labels."""
        try:
            prep = self._prep_window(sel, kind)
        except TableNotFound:
            # unknown metric = empty vector (Prometheus semantics)
            empty = torch.zeros((0, self.num_steps), dtype=torch.float32,
                                device=self.device)
            if func is not None:
                return empty, []
            return {k: empty for k in pk.KIND_KEYS[kind]}, []
        layout, sel_dev, p, tsids, labels, start = prep
        t0 = time.perf_counter()
        with TRACER.stage("window_kernel", kind=kind):
            out = self._window(layout, sel_dev, p, start, func=func,
                               range_s=sel.range_s)
            self._sync_for_stages()
        self._stage_mark("window_kernel", t0)
        n = len(tsids)
        if func is not None:
            return out[:n], labels
        return {k: v[:n] for k, v in out.items()}, labels

    # ---- eval -----------------------------------------------------------
    def eval(self, e: PromExpr) -> EvalResult:
        if isinstance(e, NumberLit):
            v = torch.full((1, self.num_steps), e.value, dtype=torch.float32,
                           device=self.device)
            return EvalResult(v, [{}], is_scalar=True)
        if isinstance(e, VectorSelector):
            if e.range_s is not None:
                raise PlanError(f"range vector {e} needs a function")
            out, labels = self._run_window(e, "instant")
            # staleness: the last sample within (t - lookback, t]
            vals = out["last"] if labels else torch.zeros(
                (0, self.num_steps), dtype=torch.float32, device=self.device)
            return EvalResult(vals, labels)
        if isinstance(e, UnaryExpr):
            r = self.eval(e.expr)
            return EvalResult(-r.values if e.op == "-" else r.values, r.labels,
                              r.is_scalar)
        if isinstance(e, FunctionCall):
            return self.eval_function(e)
        if isinstance(e, Aggregation):
            return self.eval_aggregation(e)
        raise Unsupported(f"promql node {type(e).__name__} not ported yet")

    # ---- functions --------------------------------------------------------
    def eval_function(self, e: FunctionCall) -> EvalResult:
        f = e.func
        if f in _SIMPLE:
            r = self.eval(e.args[0])
            return EvalResult(_SIMPLE[f](r.values), r.labels, r.is_scalar)
        if f in _COUNTER_FUNCS:
            sel = self._selector_arg(e, 0)
            vals, labels = self._run_window(sel, "counter", func=f)
            return EvalResult(vals, labels)
        raise Unsupported(f"promql function {f} not ported yet")

    def _selector_arg(self, e: FunctionCall, i: int) -> VectorSelector:
        a = e.args[i]
        if not isinstance(a, VectorSelector):
            raise Unsupported(
                f"{e.func} over {type(a).__name__} not ported yet")
        if a.range_s is None:
            raise PlanError(f"{e.func} needs a range vector (e.g. {a}[5m])")
        return a

    # ---- aggregation ------------------------------------------------------
    def _group_series_of(self, e: Aggregation, labels, n: int):
        """Group-id assignment — the ONE definition of PromQL grouping
        semantics, two providers: the selection's LazySeriesLabels
        (vectorized from dictionary codes, resident per (selection,
        grouping) in PromLayoutCache) or the dict loop over materialized
        labels.  Returns (group payload, out_labels)."""

        def group_key(lab: dict) -> tuple:
            if e.without:
                keys = sorted(k for k in lab if k not in e.grouping)
            elif e.grouping:
                keys = sorted(e.grouping)
            else:
                keys = []
            return tuple((k, str(lab.get(k, ""))) for k in keys)

        gspec = ("without" if e.without else "by",
                 tuple(sorted(e.grouping or ())))
        if isinstance(labels, LazySeriesLabels) and n == len(labels.tsids):
            cache = labels.cache
            ckey = (labels.matcher_key, gspec)
            payload = None
            if cache is not None:
                payload = cache.lookup("group", labels.region_id, ckey,
                                       labels.generation)
                self.cache_events["group_hit" if payload is not None
                                  else "group_miss"] += 1
            if payload is None:
                payload = _series_group_ids(labels.idx, labels.tsids,
                                            e.grouping or [], e.without,
                                            self.device)
                if cache is not None:
                    nbytes = sum(
                        a.numel() * a.element_size() if torch.is_tensor(a)
                        else a.nbytes for a in payload
                        if hasattr(a, "nbytes") or torch.is_tensor(a))
                    if cache.admit(nbytes):
                        cache.store("group", labels.region_id, ckey,
                                    labels.generation, payload, nbytes)
                    else:
                        self.cache_events["group_reject"] += 1
            return payload, LazyGroupLabels(labels, payload[2], group_key)

        groups: dict[tuple, int] = {}
        gids = np.zeros(n, dtype=np.int32)
        out_labels: list[dict] = []
        for i, lab in enumerate(labels):
            k = group_key(lab)
            if k not in groups:
                groups[k] = len(groups)
                out_labels.append(dict(k))
            gids[i] = groups[k]
        rep = np.zeros(len(groups), dtype=np.int64)
        return _group_payload(gids, len(groups), rep, self.device), out_labels

    def eval_aggregation(self, e: Aggregation) -> EvalResult:
        from greptimedb_tpu_torch.compile import fusion_enabled

        if e.op not in _AGG_OPS:
            raise Unsupported(f"aggregation {e.op} not ported yet")
        if fusion_enabled():
            # selection → window → epilogue → group reduce in one chain
            # (compile/fused.py); None falls through to the multi-step
            # path below, which GREPTIME_PLAN_FUSION=off also restores
            from greptimedb_tpu_torch.compile.fused import (
                try_fused_aggregation,
            )

            fused = try_fused_aggregation(self, e)
            if fused is not None:
                return fused
        r = self.eval(e.expr)
        if r.num_series == 0:
            return r
        t0 = time.perf_counter()
        with TRACER.stage("group_agg", op=e.op):
            payload, out_labels = self._group_series_of(e, r.labels,
                                                        r.num_series)
            gid_dev, ng, _rep, row_order, _seg, offsets = payload
            out = group_reduce(r.values, gk.GroupLayout(
                gid_dev, row_order, offsets, ng), e.op)
            self._sync_for_stages()
        self._stage_mark("group_agg", t0)
        return EvalResult(out, out_labels)


# ---------------------------------------------------------------------------
# TQL entry (called from standalone)
# ---------------------------------------------------------------------------

def execute_tql(db, stmt):
    from greptimedb_tpu_torch.query.engine import QueryResult

    with TRACER.stage("parse"):
        expr = parse_promql(stmt.query)
    if stmt.command == "EXPLAIN":
        return QueryResult(["plan"], [[f"PromQL: {expr}"]])
    ev = PromEvaluator(
        db, stmt.start, stmt.end, stmt.step,
        stmt.lookback or DEFAULT_LOOKBACK_S,
    )
    res = ev.eval(expr)
    vals = res.values.cpu().numpy()
    steps = ev.steps_ms().tolist()
    t0 = time.perf_counter()
    with TRACER.stage("label_decode"):
        labels = [res.labels[s] for s in range(len(res.labels))]
        label_keys = sorted({k for lab in labels for k in lab})
        names = label_keys + ["ts", "val"]
        present = ~np.isnan(vals)
        rows = []
        for s, lab in enumerate(labels):
            keys = [str(lab.get(k, "")) for k in label_keys]
            col = vals[s]
            for t in np.flatnonzero(present[s]).tolist():
                rows.append(keys + [steps[t], float(col[t])])
    ev._stage_mark("label_decode", t0)
    sink = getattr(db, "stage_sink", None)
    if sink is not None:
        sink.update({f"promql_{k}_ms": v for k, v in ev.stage_ms.items()})
        sink["output_rows"] = len(rows)
        if ev.cache_events:
            sink["promql_cache_events"] = dict(ev.cache_events)
    return QueryResult(names, rows)
