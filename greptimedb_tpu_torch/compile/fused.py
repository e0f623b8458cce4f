"""The fused PromQL selection→window→group chain.

Counterpart of the reference's ``compile/fused.py`` (K11, one jitted XLA
program per shape class).  Here the chain is the window statistics of the
function's kind over the padded selection — for rate/increase/delta the
counter-drop ``prefix_scan`` and one ``counter_window`` launch in rate
mode (window geometry, first/last gathers, the counter-reset adjusted
delta and the ``_extrapolated`` epilogue in one kernel), for the other
kinds ``window_stats`` or ``minmax_window`` and the evaluator's own
epilogue (``engine.window_function``) — then the group reduce
(``group_merge``), with the padding rows routed to the dead overflow
group ``ng`` that the merge never visits.  A bare instant selector runs
``counter_window``'s instant mode.

Equality contract: the window statistics, epilogue and group arithmetic
are the evaluator's own (``ops/promql_kernels`` plain versions on the
CPU), so fused and unfused rows are equal; padding rows carry NaN and
contribute nothing.  Anything outside the fused surface (pinned ``@``
selectors, the window-matrix functions, stddev/stdvar/quantile/topk/
bottomk, subqueries, nested expressions) returns None and the evaluator
takes the multi-step path, which ``GREPTIME_PLAN_FUSION=off`` restores
wholesale.
"""

from __future__ import annotations

import time

import torch

from greptimedb_tpu_torch.errors import TableNotFound
from greptimedb_tpu_torch.ops import grid_kernels as gk
from greptimedb_tpu_torch.promql.engine import (
    WINDOW_FUNC_KIND, window_function,
)
from greptimedb_tpu_torch.utils.tracing import TRACER

# diagnostics: fused dispatches this process (tests read it)
FUSED_DISPATCHES = {"count": 0}

# function → window kind, mirroring eval_function's routing; None = a bare
# instant selector under the aggregation
_FUNC_KIND = {None: "instant", "rate": "counter", "increase": "counter",
              "delta": "counter", **WINDOW_FUNC_KIND}
# stddev/stdvar stay off the fused surface: their v²−mean² form cancels
# catastrophically, so any change in the order of the sums would show in
# the floats; quantile/topk/bottomk need the rows, not a merge
_FUSED_AGGS = {"sum", "avg", "count", "group", "min", "max"}


def _apply_func(ev, func, layout, sel_dev, p, start, range_s):
    """The window statistics and function epilogue over the padded
    selection: rate mode of ``counter_window`` for rate/increase/delta,
    else the statistics of the function's kind and the evaluator's own
    epilogue (the staleness-windowed last sample for an instant
    selector)."""
    if func in ("rate", "increase", "delta"):
        return ev._window(layout, sel_dev, p, start, func=func,
                          range_s=range_s)
    return window_function(func, ev._window(layout, sel_dev, p, start))


def try_fused_aggregation(ev, e):
    """Fused evaluation of one Aggregation node, or None (the evaluator
    falls back to the multi-step path).  ``ev`` is the PromEvaluator."""
    from greptimedb_tpu_torch.promql import engine as pe
    from greptimedb_tpu_torch.promql.parser import FunctionCall, VectorSelector

    inner = e.expr
    func = None
    if type(inner) is VectorSelector:
        if inner.range_s is not None:
            return None  # bare range vector: unfused raises the error
        sel = inner
    elif isinstance(inner, FunctionCall):
        func = inner.func
        if func not in _FUNC_KIND or len(inner.args) != 1:
            return None
        sel = inner.args[0]
        if type(sel) is not VectorSelector:
            return None  # subqueries and nested exprs: multi-step path
        if sel.range_s is None:
            return None  # unfused raises the canonical PlanError
    else:
        return None
    if e.op not in _FUSED_AGGS or e.param is not None:
        return None
    if sel.at_ts is not None:
        return None  # pinned @: the unfused path says what it supports
    try:
        # allow_bounds=False: the count geometry's state is an unfused-
        # route accelerator, as in the reference's fused programs
        prep = ev._prep_window(sel, _FUNC_KIND[func], allow_bounds=False)
    except TableNotFound:
        return None  # unknown metric: unfused produces the empty vector
    layout, sel_dev, p, tsids, labels, start, _pinned, _bounds = prep
    if len(tsids) == 0:
        return None
    t0 = time.perf_counter()
    with TRACER.stage("group_agg", op=e.op):
        payload, out_labels = ev._group_series_of(e, labels, len(tsids))
    ev._stage_mark("group_agg", t0)
    gid_dev, ng, _rep, row_order, _seg, offsets = payload
    pad = p.num_sel - len(tsids)
    gid_full = torch.cat([gid_dev, torch.full(
        (pad,), ng, dtype=gid_dev.dtype, device=gid_dev.device)]) \
        if pad else gid_dev
    layout_g = gk.GroupLayout(gid_full, row_order, offsets, ng)
    t0 = time.perf_counter()
    with TRACER.stage("fused_kernel", op=e.op, func=func or "instant"):
        v = _apply_func(ev, func, layout, sel_dev, p, start,
                        sel.range_s if func is not None else None)
        vals = pe.group_reduce(v, layout_g, e.op)
        ev._sync_for_stages()
    ev._stage_mark("fused_kernel", t0)
    FUSED_DISPATCHES["count"] += 1
    return pe.EvalResult(vals, out_labels)
