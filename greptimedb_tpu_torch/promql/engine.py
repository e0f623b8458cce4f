"""PromQL evaluation: range queries as dense [series, steps] tensor work.

Counterpart of the reference's ``greptimedb_tpu/promql/engine.py``.
Pipeline per selector:

1. host: match series against label matchers over the region's inverted
   index (dictionary codes, no string work per series);
2. device: the resident table's composite (tsid, ts)-key sort
   (``ops/promql_kernels.sort_layout``) and its series offset table (the
   first sorted row of every tsid, ``series_offsets``), cached together
   per region generation and field column; then per-(series, step)
   window statistics by binary search over each series' sorted keys,
   with the counter-reset drops summed over each window's rows
   (``counter_window``; Prometheus extrapolation, reference
   src/promql/src/functions/extrapolate_rate.rs:56);
   The other window kinds go through ``window_stats`` (gauge_window,
   counter_rc, regression, irate), ``minmax_window`` and, for the
   functions that need a window's samples as a whole (quantile, mad,
   Holt), ``window_count_max`` + ``window_matrix``;
3. device: cross-series aggregation = series→group merge
   (``ops/grid_kernels.group_merge``), or order statistics of
   group-contiguous columns (``ops/segment_kernels.segment_select``) for
   quantile/topk/bottomk; binary operators match series on the host and
   compute on the gathered rows; subqueries evaluate the inner expression
   on the sub-step grid and reduce its ``[S, T, K]`` window matrix
   (``window_matrix_dense`` for quantile/mad, ``subquery_counter`` for
   the counter functions).

NaN encodes "absent" throughout (Prometheus staleness semantics).  The
whole PromQL surface of the reference is ported but ``count_values``,
which the reference refuses too.  There is no per-shape compile stage:
the kernels take their shapes as arguments.
"""

from __future__ import annotations

import collections
import collections.abc
import math
import os
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from greptimedb_tpu_torch.errors import PlanError, TableNotFound, Unsupported
from greptimedb_tpu_torch.ops import grid_kernels as gk
from greptimedb_tpu_torch.ops import promql_kernels as pk
from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.promql.parser import (
    Aggregation, BinaryExpr, FunctionCall, LabelMatcher, NumberLit,
    PromExpr, StringLit, SubqueryExpr, UnaryExpr, VectorSelector,
    parse_promql,
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
# function → window kind of its statistics (eval_function, the fused chain)
_GAUGE_FUNCS = ("avg_over_time", "sum_over_time", "count_over_time",
                "last_over_time", "first_over_time", "stddev_over_time",
                "stdvar_over_time", "present_over_time")
WINDOW_FUNC_KIND = {
    "irate": "irate", "idelta": "irate",
    "resets": "counter_rc", "changes": "counter_rc",
    **{f: "gauge_window" for f in _GAUGE_FUNCS},
    "min_over_time": "minmax", "max_over_time": "minmax",
    "deriv": "regression",
}
# *_over_time reducers applicable to a subquery window matrix
_SUBQ_REDUCERS = {*_GAUGE_FUNCS, "min_over_time", "max_over_time",
                  "quantile_over_time", "mad_over_time"}
_AGG_OPS = ("sum", "avg", "count", "group", "min", "max", "stddev",
            "stdvar", "quantile", "topk", "bottomk")
_ARITH = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "%": torch.remainder, "^": torch.pow, "atan2": torch.atan2,
}
_CMP = {
    "==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
    ">": torch.gt, ">=": torch.ge,
}


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
    (engine.py:1567-1600) for sum/avg/count/group/min/max/stddev/stdvar
    over ``v`` ``[S, T]``: absent (NaN) cells are skipped, an empty group
    is NaN.  Counts sum in int64, values through ``group_merge``."""
    present = ~torch.isnan(v)
    cnt = gk.group_merge(present.to(torch.int64), layout, "sum")
    has = cnt > 0
    if op in ("stddev", "stdvar"):
        s, s2 = gk.group_merge(torch.stack([
            torch.where(present, v, 0.0), torch.where(present, v * v, 0.0)]),
            layout, "sum")
        fcnt = torch.clamp(cnt.to(torch.float32), min=1)
        mean = s / fcnt
        var = torch.clamp(s2 / fcnt - mean * mean, min=0)
        return torch.where(has, var if op == "stdvar" else torch.sqrt(var),
                           float("nan"))
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

# the count geometry serves evaluations of at most this many steps whose
# S·T·L compare sweep stays within the cap (the reference's
# ``_prep_window``): beyond them the binary searches are cheaper
BOUNDS_MAX_STEPS = 64
BOUNDS_COMPARE_CAP = 1 << 27

@dataclass(frozen=True)
class WindowParams:
    """Shape of one window evaluation: step, steps, window width (the
    lookback for instant selectors), padded selected series, and which
    statistics (``kind``, a key of ``ops/promql_kernels.KIND_KEYS``) it
    computes."""

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
        (``ops/promql_kernels.sort_layout``) with its series offset table
        appended (``with_series_offsets``: the window kernels' range
        geometry), served from PromLayoutCache per (DeviceTable
        dicts_version, field column).  The table lives in the layout's
        entry: built once with it, evicted with it."""
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
        arrays = pk.with_series_offsets(
            pk.sort_layout(cols[self.ts_name], cols[fieldcol], cols[TSID],
                           self.table.row_mask), self.table.num_series)
        if cache is not None:
            # 25 B a row plus 4 B a series: at 1 M series x 40 scrapes
            # (41.9 M padded rows) 1.048 GB + 4 MB, inside the default
            # 1 GiB (1.074 GB) GREPTIME_PROMQL_CACHE_BYTES with the
            # query's selection and group layout beside it
            nbytes = sum(a.numel() * a.element_size() for a in arrays)
            if cache.admit(nbytes):
                cache.store("sort", rid, (fieldcol,), version, arrays,
                            nbytes)
            else:
                self.events["sort_reject"] += 1
        return arrays

    def window_bounds(self, fieldcol: str, layout: tuple, sel_dev,
                      matcher_key: tuple, num_steps: int):
        """The resident count-geometry state of one (selection, field):
        each selected series' row range in the sorted layout and its
        ``[S, L]`` timestamp matrix (``L`` the next power of two of the
        most samples a series holds; finding it is one host sync).
        Window bounds then cost ``O(T·L)`` sequential compares per series
        instead of ``O(T·log N)`` binary searches, with the same integer
        bounds.  Returns ``(series_start, cnt, ts_mat)``, or None, and the
        caller takes the searchsorted geometry: when the cache is off,
        past ``BOUNDS_MAX_STEPS`` steps, when the ``S·T·L`` compare sweep
        passes ``BOUNDS_COMPARE_CAP`` (``bounds_refused``), and when the
        state would not fit the cache beside the sort layout it derives
        from (``bounds_reject``).  Refusals build nothing; the width ``L``
        is kept as a zero-byte ``width`` entry, so a repeat runs no
        search."""
        cache = self.promql_cache()
        rid = getattr(self.region, "region_id", None)
        if cache is None or rid is None or num_steps > BOUNDS_MAX_STEPS:
            return None  # a transient build would cost more than it saves
        version = self.table.dicts_version
        ckey = (matcher_key, fieldcol)
        S = int(sel_dev.shape[0])
        payload = cache.lookup("bounds", rid, ckey, version)
        if payload is not None:
            if S * num_steps * payload[2].shape[1] > BOUNDS_COMPARE_CAP:
                self.events["bounds_refused"] += 1
                return None
            self.events["bounds_hit"] += 1
            return payload
        self.events["bounds_miss"] += 1
        key_s, ts_s, kp = layout[0], layout[1], layout[6]
        ranges = None
        L = cache.lookup("width", rid, ckey, version)
        if L is None:
            ranges = pk.series_ranges(key_s, kp, sel_dev)
            L = max(1, 1 << (max(ranges[2], 1) - 1).bit_length())
            cache.store("width", rid, ckey, version, L, 0)
        if S * num_steps * L > BOUNDS_COMPARE_CAP:
            self.events["bounds_refused"] += 1
            return None
        nbytes = S * (8 + 4) + S * L * 8  # start, cnt, ts_mat
        if not cache.admit(nbytes, keep=(rid, "sort", (fieldcol,))):
            self.events["bounds_reject"] += 1
            return None
        start, cnt, _lmax = ranges or pk.series_ranges(key_s, kp, sel_dev)
        payload = (start, cnt, pk.gather_ts_mat(ts_s, start, cnt, L))
        cache.store("bounds", rid, ckey, version, payload, nbytes)
        return payload


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

    def _empty(self) -> torch.Tensor:
        return torch.zeros((0, self.num_steps), dtype=torch.float32,
                           device=self.device)

    def _prep_window(self, sel: VectorSelector, kind: str,
                     range_ms: int | None = None, allow_bounds: bool = True):
        """Selector → window inputs: (layout, sel_dev, p, tsids, labels,
        start, pinned, bounds).  The ``@`` modifier pins evaluation to one
        step at ``at_ts - offset`` (``pinned``; callers broadcast it over
        the grid).  ``bounds`` is the resident count-geometry state
        (``SelectorData.window_bounds``) where ``allow_bounds`` holds and
        the state serves this evaluation (else None: the searchsorted
        geometry).  Raises TableNotFound for unknown metrics (callers map
        it to an empty vector, Prometheus semantics)."""
        t0 = time.perf_counter()
        with TRACER.stage("device_table"):
            d = self.data_for(sel.metric)
        self._stage_mark("device_table", t0)
        fieldcol = d.field_column(sel.matchers)
        t0 = time.perf_counter()
        with TRACER.stage("selection"):
            tsids, sel_dev, labels = d.select_series(sel.matchers)
        self._stage_mark("selection", t0)
        rng = range_ms
        if rng is None:
            rng = int(sel.range_s * 1000) if sel.range_s else self.lookback_ms
        offset_ms = int(sel.offset_s * 1000)
        pinned = sel.at_ts is not None
        if pinned:
            start, num_steps = int(sel.at_ts * 1000) - offset_ms, 1
        else:
            start, num_steps = self.start_ms - offset_ms, self.num_steps
        t0 = time.perf_counter()
        with TRACER.stage("sort_layout"):
            layout = d.sort_layout(fieldcol)
            # the count geometry: a resident-only accelerator for few-step
            # windows (the S·T·L compare sweep must stay cheaper than the
            # S·T·log N binary searches it replaces)
            bounds = (d.window_bounds(fieldcol, layout, sel_dev,
                                      labels.matcher_key, num_steps)
                      if allow_bounds else None)
            self._sync_for_stages()
        self._stage_mark("sort_layout", t0)
        p = WindowParams(step_ms=self.step_ms, num_steps=num_steps,
                         range_ms=int(rng), num_sel=int(sel_dev.shape[0]),
                         kind=kind)
        return layout, sel_dev, p, tsids, labels, start, pinned, bounds

    def _window(self, layout, sel_dev, p: WindowParams, start: int,
                func=None, range_s=None, bounds=None):
        """The window statistics of ``p.kind`` over the padded selection:
        ``counter_window`` for counter/instant (rate mode when ``func`` is
        given; it sums each window's counter drops itself),
        ``window_stats`` for the gauge_window/counter_rc/regression/irate
        kinds, ``minmax_window`` for minmax; each in the count geometry
        when ``bounds`` is given, else the range geometry."""
        geo = dict(step_ms=p.step_ms, num_steps=p.num_steps,
                   range_ms=p.range_ms, bounds=bounds)
        if p.kind in ("counter", "instant"):
            return pk.counter_window(
                layout, sel_dev, start,
                kind="rate" if func is not None else p.kind, func=func,
                range_s=range_s, **geo)
        if p.kind == "minmax":
            return pk.minmax_window(layout, sel_dev, start, **geo)
        return pk.window_stats(layout, sel_dev, start, kind=p.kind, **geo)

    def _broadcast(self, v: torch.Tensor, pinned: bool) -> torch.Tensor:
        return v.expand(v.shape[0], self.num_steps) if pinned else v

    def _run_window(self, sel: VectorSelector, kind: str, func=None):
        """The window statistics of ``kind`` over the selected series (a
        dict of ``[n, T]`` tensors), or with ``func`` (rate/increase/delta)
        its ``[n, T]`` values from ``counter_window``'s rate mode; and the
        series labels.  A pinned (``@``) window is computed at one step
        and broadcast."""
        try:
            prep = self._prep_window(sel, kind)
        except TableNotFound:
            # unknown metric = empty vector (Prometheus semantics)
            if func is not None:
                return self._empty(), []
            return {k: self._empty() for k in pk.KIND_KEYS[kind]}, []
        layout, sel_dev, p, tsids, labels, start, pinned, bounds = prep
        t0 = time.perf_counter()
        with TRACER.stage("window_kernel", kind=kind):
            out = self._window(layout, sel_dev, p, start, func=func,
                               range_s=sel.range_s, bounds=bounds)
            self._sync_for_stages()
        self._stage_mark("window_kernel", t0)
        n = len(tsids)
        if func is not None:
            return self._broadcast(out[:n], pinned), labels
        return {k: self._broadcast(v[:n], pinned)
                for k, v in out.items()}, labels

    def _run_matrix(self, sel: VectorSelector, kind: str,
                    extras: tuple = ()):
        """The window-matrix twin of ``_run_window`` for the functions
        that need each window's samples as a whole (quantile_over_time,
        mad_over_time, double_exponential_smoothing): the largest window
        count sizes the padded width ``lmax`` (a power of two >= 2), then
        ``window_matrix``.  ``extras`` are ``[num_steps]`` f32 parameter
        vectors (φ / sf, tf)."""
        try:
            prep = self._prep_window(sel, kind, allow_bounds=False)
        except TableNotFound:
            return self._empty(), []
        layout, sel_dev, p, tsids, labels, start, pinned, _bounds = prep
        geo = dict(step_ms=p.step_ms, num_steps=p.num_steps,
                   range_ms=p.range_ms)
        t0 = time.perf_counter()
        with TRACER.stage("window_kernel", kind=kind):
            cnt_max = pk.window_count_max(layout, sel_dev, start, **geo)
            lmax = max(2, 1 << (max(cnt_max, 1) - 1).bit_length())

            def param(i):
                if len(extras) <= i:
                    return None
                a = torch.as_tensor(extras[i], dtype=torch.float32,
                                    device=self.device)
                return a.expand(self.num_steps)[:p.num_steps]

            vals = pk.window_matrix(layout, sel_dev, start, lmax=lmax,
                                    kind=kind, a1=param(0), a2=param(1),
                                    **geo)[:len(tsids)]
            self._sync_for_stages()
        self._stage_mark("window_kernel", t0)
        return self._broadcast(vals, pinned), labels

    # ---- eval -----------------------------------------------------------
    def eval(self, e: PromExpr) -> EvalResult:
        if isinstance(e, NumberLit):
            v = torch.full((1, self.num_steps), e.value, dtype=torch.float32,
                           device=self.device)
            return EvalResult(v, [{}], is_scalar=True)
        if isinstance(e, StringLit):
            raise Unsupported("bare string expression")
        if isinstance(e, VectorSelector):
            if e.range_s is not None:
                raise PlanError(f"range vector {e} needs a function")
            out, labels = self._run_window(e, "instant")
            # staleness: the last sample within (t - lookback, t]
            vals = out["last"] if labels else self._empty()
            return EvalResult(vals, labels)
        if isinstance(e, UnaryExpr):
            r = self.eval(e.expr)
            return EvalResult(-r.values if e.op == "-" else r.values, r.labels,
                              r.is_scalar)
        if isinstance(e, FunctionCall):
            return self.eval_function(e)
        if isinstance(e, Aggregation):
            return self.eval_aggregation(e)
        if isinstance(e, BinaryExpr):
            return self.eval_binary(e)
        if isinstance(e, SubqueryExpr):
            raise Unsupported("bare subquery needs an *_over_time function")
        raise Unsupported(f"promql node {type(e).__name__}")

    # ---- functions --------------------------------------------------------
    def eval_function(self, e: FunctionCall) -> EvalResult:
        """The reference's function table (engine.py:1076-1263)."""
        f = e.func
        if f in _SIMPLE:
            r = self.eval(e.args[0])
            return EvalResult(_SIMPLE[f](r.values), r.labels, r.is_scalar)
        if f == "round":
            r = self.eval(e.args[0])
            to = 1.0
            if len(e.args) > 1 and isinstance(e.args[1], NumberLit):
                to = e.args[1].value
            return EvalResult(torch.round(r.values / to) * to, r.labels,
                              r.is_scalar)
        if f in ("clamp", "clamp_min", "clamp_max"):
            r = self.eval(e.args[0])
            if f == "clamp":
                v = torch.clamp(r.values, e.args[1].value, e.args[2].value)
            elif f == "clamp_min":
                v = torch.clamp(r.values, min=e.args[1].value)
            else:
                v = torch.clamp(r.values, max=e.args[1].value)
            return EvalResult(v, r.labels)
        if f == "scalar":
            r = self.eval(e.args[0])
            if r.num_series == 1:
                return EvalResult(r.values, [{}], is_scalar=True)
            v = torch.full((1, self.num_steps), float("nan"),
                           dtype=torch.float32, device=self.device)
            return EvalResult(v, [{}], is_scalar=True)
        if f == "vector":
            r = self.eval(e.args[0])
            return EvalResult(r.values, [{}])
        if f == "time":
            t = torch.as_tensor(self.steps_ms() / 1000.0,
                                device=self.device).to(torch.float32)
            return EvalResult(t[None, :], [{}], is_scalar=True)
        if f == "timestamp":
            sel = self._selector_arg(e, 0, want_range=False)
            out, labels = self._run_window(sel, "instant")
            # float64: float32 quantizes epoch seconds to ~minutes
            ts = out["last_ts"].to(torch.float64) / 1000.0
            return EvalResult(torch.where(torch.isnan(out["last"]),
                                          float("nan"), ts), labels)
        if f == "absent":
            r = self.eval(e.args[0])
            present = (~torch.isnan(r.values)).any(0) if r.num_series else \
                torch.zeros(self.num_steps, dtype=torch.bool,
                            device=self.device)
            v = torch.where(present, float("nan"), 1.0).to(torch.float32)
            lab = {}
            if isinstance(e.args[0], VectorSelector):
                lab = {m.name: m.value for m in e.args[0].matchers
                       if m.op == "=" and m.name != "__field__"}
            return EvalResult(v[None, :], [lab])
        if f in _SUBQ_REDUCERS:
            sel_i = 1 if f == "quantile_over_time" else 0
            arg = e.args[sel_i] if len(e.args) > sel_i else None
            if isinstance(arg, SubqueryExpr):
                q = (self.eval(e.args[0]).values[0]
                     if f == "quantile_over_time" else None)
                return self._eval_subquery_window(f, arg, q)
        if (f in ("rate", "increase", "delta", "irate", "idelta")
                and e.args and isinstance(e.args[0], SubqueryExpr)):
            return self._eval_subquery_counter(f, e.args[0])
        if f in _COUNTER_FUNCS:
            sel = self._selector_arg(e, 0)
            vals, labels = self._run_window(sel, "counter", func=f)
            return EvalResult(vals, labels)
        if f in WINDOW_FUNC_KIND:
            sel = self._selector_arg(e, 0)
            out, labels = self._run_window(sel, WINDOW_FUNC_KIND[f])
            return EvalResult(window_function(f, out), labels)
        if f == "predict_linear":
            sel = self._selector_arg(e, 0)
            horizon = self.eval(e.args[1]).values[0]  # scalar [T]
            out, labels = self._run_window(sel, "regression")
            # the regression's t is seconds from the grid's start (before
            # the offset); predict at the step's t plus the horizon
            t_at = torch.as_tensor(self.steps_ms() - self.start_ms,
                                   device=self.device).to(torch.float32)
            t_at = t_at / 1000.0
            vals = out["intercept"] + out["slope"] * (
                t_at[None, :] + horizon[None, :])
            return EvalResult(vals, labels)
        if f == "histogram_quantile":
            return self._histogram_quantile(e)
        if f == "label_replace":
            r = self.eval(e.args[0])
            dst, repl, src, regex = (a.value for a in e.args[1:5])
            rx = re.compile(str(regex))
            # Prometheus $1 / ${1} group refs → python \1 / \g<1>
            template = re.sub(r"\$\{(\w+)\}", r"\\g<\1>", str(repl))
            template = re.sub(r"\$(\d+)", r"\\\1", template)
            labels = []
            for lab in r.labels:
                m = rx.fullmatch(str(lab.get(src, "")))
                lab = dict(lab)
                if m is not None:
                    lab[dst] = m.expand(template)
                    if lab[dst] == "":
                        lab.pop(dst, None)
                labels.append(lab)
            return EvalResult(r.values, labels)
        if f == "label_join":
            r = self.eval(e.args[0])
            dst, sep = e.args[1].value, e.args[2].value
            srcs = [a.value for a in e.args[3:]]
            labels = []
            for lab in r.labels:
                lab = dict(lab)
                lab[dst] = str(sep).join(str(lab.get(s, "")) for s in srcs)
                labels.append(lab)
            return EvalResult(r.values, labels)
        if f in ("sort", "sort_desc"):
            return self.eval(e.args[0])  # ordering is a presentation concern
        if f == "quantile_over_time":
            if len(e.args) != 2:
                raise PlanError("quantile_over_time(φ, series[range])")
            q = self.eval(e.args[0]).values[0]
            sel = self._selector_arg(e, 1)
            vals, labels = self._run_matrix(sel, "quantile", (q,))
            return EvalResult(vals, labels)
        if f == "mad_over_time":
            sel = self._selector_arg(e, 0)
            vals, labels = self._run_matrix(sel, "mad")
            return EvalResult(vals, labels)
        if f == "double_exponential_smoothing":
            if len(e.args) != 3:
                raise PlanError(
                    "double_exponential_smoothing(series[range], sf, tf)")
            sel = self._selector_arg(e, 0)
            sf = self.eval(e.args[1]).values[0]
            tf = self.eval(e.args[2]).values[0]
            vals, labels = self._run_matrix(sel, "holt", (sf, tf))
            return EvalResult(vals, labels)
        raise Unsupported(f"promql function {f}")

    def _selector_arg(self, e: FunctionCall, i: int,
                      want_range: bool = True) -> VectorSelector:
        a = e.args[i]
        if not isinstance(a, VectorSelector):
            raise Unsupported(f"{e.func} needs a selector argument, got {a}")
        if want_range and a.range_s is None:
            raise PlanError(f"{e.func} needs a range vector (e.g. {a}[5m])")
        return a

    # ---- subqueries -------------------------------------------------------
    def _subquery_matrix(self, sq: SubqueryExpr):
        """The inner expression evaluated on the sub-step grid covering
        (start - range, end] (absolute multiples of the sub-step, as
        Prometheus aligns them) and gathered into ``[S, T, K]`` windows.
        Returns (win, mask, ts_tk [T, K] ms, steps [T] ms, labels) or None
        for an empty inner vector."""
        range_ms = int(sq.range_s * 1000)
        sub_ms = max(int((sq.step_s or self.step_ms / 1000.0) * 1000), 1)
        offset_ms = int(sq.offset_s * 1000)
        end_ms = (self.start_ms - offset_ms
                  + self.step_ms * (self.num_steps - 1))
        lo_ms = self.start_ms - offset_ms - range_ms
        t0 = (lo_ms // sub_ms + 1) * sub_ms
        if t0 > end_ms:
            t0 = end_ms
        inner = PromEvaluator(self.db, t0 / 1000.0, end_ms / 1000.0,
                              sub_ms / 1000.0, self.lookback_ms / 1000.0)
        res = inner.eval(sq.expr)
        for k, v in inner.stage_ms.items():
            self.stage_ms[k] = round(self.stage_ms.get(k, 0.0) + v, 3)
        vals = res.values  # [S, TI]
        if vals.shape[0] == 0:
            return None
        ti = vals.shape[1]
        K = range_ms // sub_ms + 1
        steps = (self.start_ms - offset_ms
                 + self.step_ms * np.arange(self.num_steps, dtype=np.int64))
        j_lo = (steps - range_ms - t0) // sub_ms + 1  # first j inside
        idx = j_lo[:, None] + np.arange(K, dtype=np.int64)[None, :]
        ts_tk = t0 + idx * sub_ms
        in_win = (idx >= 0) & (idx < ti) & (ts_tk <= steps[:, None])
        idxc = torch.as_tensor(np.clip(idx, 0, max(ti - 1, 0)),
                               device=self.device)
        win = vals[:, idxc]  # [S, T, K]
        m = torch.as_tensor(in_win, device=self.device)[None] & \
            ~torch.isnan(win)
        return win, m, ts_tk, steps, res.labels

    def _eval_subquery_counter(self, f: str, sq: SubqueryExpr) -> EvalResult:
        """rate/increase/delta/irate/idelta over a subquery matrix: the
        inner evaluations are the samples; ``subquery_counter`` gathers the
        first/last samples, sums the counter resets of each window and
        finishes rate/increase/delta as the selector path does (irate and
        idelta take its last two samples)."""
        mat = self._subquery_matrix(sq)
        if mat is None:
            return EvalResult(self._empty(), [])
        win, m, ts_tk, steps, labels = mat
        args = (torch.where(m, win, float("nan")).to(torch.float32),
                torch.as_tensor(ts_tk, device=self.device),
                torch.as_tensor(steps, device=self.device))
        if f in ("irate", "idelta"):
            out = pk.subquery_counter(*args, kind="pair")
            vals = instant_pair(f, out["last_ts"], out["prev_ts"],
                                out["last_val"], out["prev_val"],
                                guard=out["count"] >= 2)
            return EvalResult(vals.to(torch.float32), labels)
        vals = pk.subquery_counter(*args, kind="rate", func=f,
                                   range_s=sq.range_s)
        return EvalResult(vals, labels)

    def _eval_subquery_window(self, f: str, sq: SubqueryExpr,
                              q=None) -> EvalResult:
        """fn_over_time(expr[range:step]): each outer step's window of
        inner evaluations reduced by ``f`` (the reference's
        ``_eval_subquery_window``); quantile and mad through
        ``window_matrix_dense``."""
        mat = self._subquery_matrix(sq)
        if mat is None:
            return EvalResult(self._empty(), [])
        win, m, _ts_tk, _steps, labels = mat
        K = win.shape[2]
        cnt = m.sum(-1)
        has = cnt > 0
        nan, inf = float("nan"), float("inf")
        z = torch.where(m, win, 0.0)
        c1 = torch.clamp(cnt, min=1)
        if f == "sum_over_time":
            out = torch.where(has, z.sum(-1), nan)
        elif f == "count_over_time":
            out = torch.where(has, cnt.to(torch.float32), nan)
        elif f == "present_over_time":
            out = torch.where(has, 1.0, nan)
        elif f == "avg_over_time":
            out = torch.where(has, z.sum(-1) / c1, nan)
        elif f in ("stddev_over_time", "stdvar_over_time"):
            mean = z.sum(-1) / c1
            var = torch.where(m, (win - mean[..., None]) ** 2,
                              0.0).sum(-1) / c1
            out = torch.where(has, torch.sqrt(var)
                              if f == "stddev_over_time" else var, nan)
        elif f == "min_over_time":
            out = torch.where(has, torch.where(m, win, inf).amin(-1), nan)
        elif f == "max_over_time":
            out = torch.where(has, torch.where(m, win, -inf).amax(-1), nan)
        elif f in ("last_over_time", "first_over_time"):
            ks = torch.arange(K, device=self.device)
            pick = (torch.where(m, ks, -1).amax(-1) if f == "last_over_time"
                    else torch.where(m, ks, K).amin(-1))
            val = torch.gather(win, -1, torch.clamp(pick, 0, K - 1)[..., None]
                               )[..., 0]
            out = torch.where(has, val, nan)
        else:  # quantile_over_time, mad_over_time
            kind = "quantile" if f == "quantile_over_time" else "mad"
            out = pk.window_matrix_dense(
                torch.where(m, win, nan).to(torch.float32), kind,
                q.to(torch.float32) if q is not None else None)
        return EvalResult(out.to(torch.float32), labels)

    # ---- aggregation ------------------------------------------------------
    def _scalar_param(self, param: PromExpr | None, who: str) -> float:
        """Aggregation parameter (k, q): literal or constant scalar expr."""
        if param is None:
            raise PlanError(f"{who} needs a parameter")
        if isinstance(param, NumberLit):
            return float(param.value)
        r = self.eval(param)
        if not r.is_scalar:
            raise Unsupported(f"{who} parameter must be a scalar")
        vals = r.values[0].cpu().numpy()
        if len(vals) > 1 and not np.allclose(vals, vals[0], equal_nan=True):
            raise Unsupported(f"{who} parameter varying per step")
        v = float(vals[0])
        if np.isnan(v):
            raise PlanError(f"{who} parameter evaluates to NaN")
        return v

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
        """The reference's ``eval_aggregation`` (engine.py:1545-1652):
        sum…max and stddev/stdvar through ``group_merge``; quantile,
        topk and bottomk through ``segment_select``'s order statistics."""
        from greptimedb_tpu_torch.compile import fusion_enabled

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
        if e.op not in _AGG_OPS:
            raise Unsupported(f"aggregation {e.op}")
        t0 = time.perf_counter()
        with TRACER.stage("group_agg", op=e.op):
            payload, out_labels = self._group_series_of(e, r.labels,
                                                        r.num_series)
            gid_dev, ng, _rep, row_order, _seg, offsets = payload
            layout = gk.GroupLayout(gid_dev, row_order, offsets, ng)
            # the group kernels take f32 (only timestamp() yields f64)
            v = r.values.to(torch.float32)
            if e.op in ("quantile", "topk", "bottomk"):
                res = self._order_statistic(e, v, layout, r.labels,
                                            out_labels)
            else:
                res = EvalResult(group_reduce(v, layout, e.op), out_labels)
            self._sync_for_stages()
        self._stage_mark("group_agg", t0)
        return res

    def _order_statistic(self, e: Aggregation, v: torch.Tensor,
                         layout: gk.GroupLayout, labels,
                         out_labels) -> EvalResult:
        """quantile (the two straddling order statistics of each group and
        step, NaN members last, linearly interpolated) and topk/bottomk
        (each group's k-th largest value per step, ties kept), the ranks
        read by ``segment_select``."""
        present = ~torch.isnan(v)
        sizes = torch.diff(layout.offsets)
        if e.op == "quantile":
            q = self._scalar_param(e.param, "quantile")
            cnt = gk.group_merge(present.to(torch.int64), layout, "sum")
            # the rank in f32, from q rounded to f32 as the reference
            rank = float(np.float32(q)) * torch.clamp(
                cnt.to(torch.float32) - 1, min=0)
            if q < 0 or q > 1:
                out = torch.full_like(rank, -math.inf if q < 0 else math.inf)
            else:
                lo_r = torch.floor(rank).to(torch.int32)
                hi_r = torch.ceil(rank).to(torch.int32)
                vlo, vhi = sk.segment_select(v, layout.order, layout.offsets,
                                             torch.stack([lo_r, hi_r]))
                out = vlo + (vhi - vlo) * (rank - lo_r.to(torch.float32))
            out = torch.where(cnt > 0, out, float("nan"))
            return EvalResult(out, out_labels)
        k = int(self._scalar_param(e.param, e.op))
        if k <= 0:
            return EvalResult(self._empty(), [])
        sign = 1.0 if e.op == "topk" else -1.0
        work = torch.where(present, sign * v, -math.inf)
        # the min(k, size)-th largest of each group: ascending rank
        # size - min(k, size)
        asc = (sizes - torch.clamp(sizes, max=k)).to(torch.int32)
        kth = sk.segment_select(
            work, layout.order, layout.offsets,
            asc[None, :, None].expand(1, layout.ngt, v.shape[1]))[0]
        keep = work >= kth[layout.ids.long()]
        return EvalResult(torch.where(keep & present, v, float("nan")),
                          labels)

    # ---- binary ops -------------------------------------------------------
    def eval_binary(self, e: BinaryExpr) -> EvalResult:
        """The reference's ``eval_binary`` (engine.py:1655-1700): scalar
        broadcast, one-to-one vector matching (on/ignoring) on the host,
        the arithmetic on the gathered ``[n, T]`` rows."""
        lhs = self.eval(e.lhs)
        rhs = self.eval(e.rhs)
        op = e.op
        # a filter comparison keeps the vector side's value (the left one
        # between two vectors)
        keep_rhs_value = lhs.is_scalar and not rhs.is_scalar

        def apply(a, b):
            if op in _ARITH:
                return _ARITH[op](a, b)
            cmp = _CMP[op](a, b)
            if e.bool_modifier:
                return torch.where(torch.isnan(a) | torch.isnan(b),
                                   float("nan"), cmp.to(torch.float32))
            return torch.where(cmp, b if keep_rhs_value else a, float("nan"))

        if op in ("and", "or", "unless"):
            return self._set_op(e, lhs, rhs)
        if lhs.is_scalar and rhs.is_scalar:
            return EvalResult(apply(lhs.values, rhs.values), [{}],
                              is_scalar=True)
        if lhs.is_scalar:
            return EvalResult(apply(lhs.values[0][None, :], rhs.values),
                              rhs.labels)
        if rhs.is_scalar:
            return EvalResult(apply(lhs.values, rhs.values[0][None, :]),
                              lhs.labels)
        li, ri, labels = self._match_series(e, lhs, rhs)
        if not labels:
            return EvalResult(self._empty(), [])
        dev = self.device
        out = apply(lhs.values[torch.as_tensor(li, device=dev)],
                    rhs.values[torch.as_tensor(ri, device=dev)])
        return EvalResult(out, labels)

    def _match_key(self, e: BinaryExpr, lab: dict) -> tuple:
        if e.on is not None:
            keys = sorted(e.on)
        else:
            drop = set(e.ignoring or [])
            drop.add("__name__")
            keys = sorted(k for k in lab if k not in drop)
        return tuple((k, str(lab.get(k, ""))) for k in keys)

    def _match_series(self, e: BinaryExpr, lhs: EvalResult,
                      rhs: EvalResult):
        rmap: dict[tuple, int] = {}
        for j, lab in enumerate(rhs.labels):
            k = self._match_key(e, lab)
            if k in rmap:
                raise PlanError(f"many-to-many vector match on {k}")
            rmap[k] = j
        li, ri, labels = [], [], []
        for i, lab in enumerate(lhs.labels):
            k = self._match_key(e, lab)
            j = rmap.get(k)
            if j is None:
                continue
            li.append(i)
            ri.append(j)
            if e.on is not None:
                labels.append(dict(k))
            else:
                labels.append({kk: vv for kk, vv in lab.items()
                               if kk not in (e.ignoring or [])})
        return li, ri, labels

    def _set_op(self, e: BinaryExpr, lhs: EvalResult,
                rhs: EvalResult) -> EvalResult:
        dev = self.device
        lkeys = [self._match_key(e, lab) for lab in lhs.labels]
        rrows = {self._match_key(e, lab): j
                 for j, lab in enumerate(rhs.labels)}
        nan = float("nan")
        if e.op == "and":
            keep = [i for i, k in enumerate(lkeys) if k in rrows]
            if not keep:
                return EvalResult(self._empty(), [])
            rsel = torch.as_tensor([rrows[lkeys[i]] for i in keep],
                                   device=dev)
            vals = torch.where(~torch.isnan(rhs.values[rsel]),
                               lhs.values[torch.as_tensor(keep, device=dev)],
                               nan)
            return EvalResult(vals, [lhs.labels[i] for i in keep])
        if e.op == "unless":
            if not lkeys:
                return EvalResult(self._empty(), [])
            rows = [lhs.values[i] if rrows.get(k) is None else torch.where(
                torch.isnan(rhs.values[rrows[k]]), lhs.values[i], nan)
                for i, k in enumerate(lkeys)]
            return EvalResult(torch.stack(rows), list(lhs.labels))
        # or: left rows plus right rows whose key is absent on the left
        left = set(lkeys)
        extra = [j for j, lab in enumerate(rhs.labels)
                 if self._match_key(e, lab) not in left]
        vals, labels = lhs.values, list(lhs.labels)
        if extra:
            vals = torch.cat([vals, rhs.values[torch.as_tensor(
                extra, device=dev)]], 0)
            labels += [rhs.labels[j] for j in extra]
        return EvalResult(vals, labels)

    # ---- histogram_quantile ---------------------------------------------
    def _histogram_quantile(self, e: FunctionCall) -> EvalResult:
        """Prometheus histogram_quantile over cumulative ``le`` buckets
        (the reference's ``_histogram_quantile``, engine.py:1775)."""
        q = e.args[0].value if isinstance(e.args[0], NumberLit) else 0.5
        r = self.eval(e.args[1])
        groups: dict[tuple, list[tuple[float, int]]] = {}
        glabels: dict[tuple, dict] = {}
        for i, lab in enumerate(r.labels):
            le_raw = str(lab.get("le", ""))
            try:
                le = float(le_raw.replace("+Inf", "inf"))
            except ValueError:
                continue
            key = tuple(sorted((k, str(v)) for k, v in lab.items()
                               if k != "le"))
            groups.setdefault(key, []).append((le, i))
            glabels[key] = {k: v for k, v in lab.items() if k != "le"}
        dev, T = self.device, self.num_steps
        cols = torch.arange(T, device=dev)
        out_vals, out_labels = [], []
        for key, buckets in groups.items():
            buckets.sort()
            les = np.array([b[0] for b in buckets], dtype=np.float64)
            if not math.isinf(les[-1]):
                continue  # spec: needs the +Inf bucket
            counts = r.values[torch.as_tensor([b[1] for b in buckets],
                                              device=dev)]  # [B, T]
            total = counts[-1]
            rank = q * total
            idx = torch.argmax((counts >= rank[None, :]).to(torch.int8), 0)
            lo_le = torch.as_tensor(np.concatenate([[0.0], les[:-1]]),
                                    dtype=torch.float32, device=dev)[idx]
            hi_le = torch.as_tensor(les, dtype=torch.float32,
                                    device=dev)[idx]
            lo_cnt = torch.cat([torch.zeros((1, T), dtype=counts.dtype,
                                            device=dev), counts[:-1]])[
                idx, cols]
            hi_cnt = counts[idx, cols]
            frac = torch.where(hi_cnt > lo_cnt,
                               (rank - lo_cnt) / (hi_cnt - lo_cnt), 1.0)
            val = lo_le + (hi_le - lo_le) * torch.clamp(frac, 0, 1)
            val = torch.where(torch.isinf(hi_le), lo_le, val)
            out_vals.append(torch.where(total > 0, val, float("nan")).to(
                torch.float32))
            out_labels.append(glabels[key])
        if not out_vals:
            return EvalResult(self._empty(), [])
        return EvalResult(torch.stack(out_vals), out_labels)


def instant_pair(f: str, last_ts, prev_ts, last_val, prev_val,
                 guard=None) -> torch.Tensor:
    """irate/idelta from the last two samples (the reference's
    ``_instant_pair``, engine.py:1824): shared by the selector path and
    the subquery path (Prometheus instantValue)."""
    dt = (last_ts - prev_ts).to(torch.float32) / 1000.0
    dv = last_val - prev_val
    if f == "irate":
        dv = torch.where(dv < 0, last_val, dv)  # counter reset
    ok = dt > 0
    if guard is not None:
        ok = ok & guard
    return torch.where(ok, dv / dt if f == "irate" else dv, float("nan"))


def window_function(func: str | None, out: dict) -> torch.Tensor:
    """The function epilogue over raw window statistics of its kind
    (``WINDOW_FUNC_KIND``; ``None`` is a bare instant selector): the
    reference's eval_function table, shared by the unfused evaluator and
    the fused chain so their rows are equal by construction."""
    if func is None:
        return out["last"]
    if func in ("irate", "idelta"):
        return instant_pair(func, out["last_ts"], out["prev_ts"],
                            out["last_val"], out["prev_val"])
    if func in ("resets", "changes"):
        return out[func]
    if func in ("min_over_time", "max_over_time"):
        return out["min" if func == "min_over_time" else "max"]
    if func == "deriv":
        return out["slope"]
    present = ~torch.isnan(out["last"])
    nan = float("nan")
    if func == "avg_over_time":
        return out["avg"]
    if func == "sum_over_time":
        return out["sum"]
    if func == "count_over_time":
        return torch.where(present, out["count"], nan)
    if func == "last_over_time":
        return out["last"]
    if func == "first_over_time":
        return out["first"]
    if func == "stddev_over_time":
        return torch.sqrt(out["var"])
    if func == "stdvar_over_time":
        return out["var"]
    if func == "present_over_time":
        return torch.where(present, 1.0, nan).to(torch.float32)
    raise Unsupported(f"promql function {func}")


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
