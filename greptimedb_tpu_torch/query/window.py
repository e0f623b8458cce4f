"""Window function execution: vectorized partition-sorted passes.

The reference gets window functions from DataFusion's WindowAggExec
(`src/query/src/datafusion.rs:141` upstream); the TPU engine
computes them as one lexsort over (partition, order) keys followed by
vectorized segment passes — no per-row Python, no hash tables.

Frames: ranking/navigation functions use their standard semantics;
windowed aggregates (sum/avg/count/min/max) use
- whole-partition totals when the spec has no ORDER BY, and
- running (cumulative, peers-inclusive — i.e. RANGE UNBOUNDED
  PRECEDING .. CURRENT ROW, matching the PostgreSQL default frame)
  when it does.
`first_value` is frame-start; `last_value` is computed over the whole
partition (the common intent; DataFusion's default-frame `last_value`
— current row — is widely considered a footgun).
"""

from __future__ import annotations

import numpy as np

from greptimedb_tpu_torch.errors import PlanError, Unsupported
from greptimedb_tpu_torch.query.ast import (
    Expr, Literal, Star, UnaryOp, WindowFunc, map_expr,
)


def _const(e: Expr):
    """Literal constant (allowing unary minus) or None."""
    if isinstance(e, Literal):
        return e.value
    if (isinstance(e, UnaryOp) and e.op == "-"
            and isinstance(e.operand, Literal)
            and isinstance(e.operand.value, (int, float))):
        return -e.operand.value
    return None


def _denullify(out: np.ndarray) -> np.ndarray:
    """Object array → float64 (None → NaN) when every non-null value is
    numeric; NaN is the engine's numeric null (engine._pyval)."""
    nulls = np.array([v is None for v in out], dtype=bool)
    vals = out[~nulls]
    if len(vals) and all(
            isinstance(v, (int, float, np.integer, np.floating))
            and not isinstance(v, bool) for v in vals):
        f = np.full(len(out), np.nan)
        f[~nulls] = vals.astype(np.float64)
        return f
    return out

WINDOW_FUNCS = {
    "row_number", "rank", "dense_rank", "ntile", "lag", "lead",
    "first_value", "last_value", "sum", "avg", "count", "min", "max",
    # anomaly scoring (reference src/common/function/src/scalars/anomaly/)
    "anomaly_score_zscore", "anomaly_score_mad", "anomaly_score_iqr",
}


def collect_windows(e: Expr, out: list[WindowFunc]) -> None:
    """All WindowFunc nodes inside ``e`` (dedup by str)."""
    def visit(node):
        if isinstance(node, WindowFunc):
            if str(node) not in {str(x) for x in out}:
                out.append(node)
        return node

    map_expr(e, visit)


def _factorize(arr: np.ndarray, n: int):
    """→ (codes int64[n], null_mask bool[n]); codes are ordered by value
    (np.unique sorts), nulls get code -1."""
    arr = np.asarray(arr)
    if arr.ndim == 0:
        arr = np.full(n, arr.item() if arr.dtype != object else arr[()])
    if arr.dtype == object:
        nulls = np.array([v is None for v in arr], dtype=bool)
        safe = arr[~nulls]
        uniq, inv = np.unique(safe.astype(str) if len(safe) else safe,
                              return_inverse=True)
        codes = np.full(len(arr), -1, dtype=np.int64)
        codes[~nulls] = inv
        return codes, nulls
    if np.issubdtype(arr.dtype, np.floating):
        nulls = np.isnan(arr)
    else:
        nulls = np.zeros(len(arr), dtype=bool)
    safe = np.where(nulls, 0, arr)
    uniq, inv = np.unique(safe, return_inverse=True)
    codes = inv.astype(np.int64)
    codes[nulls] = -1
    return codes, nulls


def _null_rank(nulls: np.ndarray, asc: bool, nulls_first) -> np.ndarray:
    # matches engine._null_key: NULLS LAST when ASC, FIRST when DESC
    if nulls_first is None:
        nulls_first = not asc
    return np.where(nulls, 0 if nulls_first else 2, 1).astype(np.int64)


class _SortedPartitions:
    """Rows lexsorted by (partition, order keys); segment geometry."""

    def __init__(self, spec, env, n: int, eval_host):
        part_codes = np.zeros(n, dtype=np.int64)
        for p in spec.partition_by:
            c, _nulls = _factorize(eval_host(p, env, n), n)
            # mixed-radix combine (nulls fold into code -1 → shift to 0)
            c = c + 1
            part_codes = part_codes * (int(c.max()) + 1 if n else 1) + c
        # factorize each ORDER BY key ONCE; reused for both the lexsort
        # keys and peer-boundary detection
        factored = [(o, *_factorize(eval_host(o.expr, env, n), n))
                    for o in spec.order_by]
        keys: list[np.ndarray] = []  # minor → major for np.lexsort
        for o, c, nulls in reversed(factored):
            keys.append(c if o.asc else -c)
            keys.append(_null_rank(nulls, o.asc, o.nulls_first))
        order_codes = [c for _o, c, _nulls in factored]
        keys.append(part_codes)
        self.idx = (np.lexsort(tuple(keys)) if keys
                    else np.arange(n, dtype=np.int64))
        pc = part_codes[self.idx]
        self.part_start = np.empty(n, dtype=bool)
        if n:
            self.part_start[0] = True
            self.part_start[1:] = pc[1:] != pc[:-1]
        # peer boundary: new partition OR any order key changed
        self.peer_start = self.part_start.copy()
        for c in order_codes:
            cs = c[self.idx]
            if n:
                self.peer_start[1:] |= cs[1:] != cs[:-1]
        self.n = n
        # segment id per sorted row + index of its partition's first row
        self.seg = np.cumsum(self.part_start) - 1 if n else np.zeros(0, int)
        starts = np.nonzero(self.part_start)[0]
        self.start_of = starts[self.seg] if n else np.zeros(0, int)
        self.pos = np.arange(n) - self.start_of  # 0-based pos in partition

    def unsort(self, sorted_vals: np.ndarray) -> np.ndarray:
        out = np.empty_like(sorted_vals)
        out[self.idx] = sorted_vals
        return out


def _seg_totals(seg: np.ndarray, vals: np.ndarray, nseg: int, op: str):
    if op == "sum":
        return np.bincount(seg, weights=vals, minlength=nseg)
    if op == "min":
        out = np.full(nseg, np.inf)
        np.minimum.at(out, seg, vals)
        return out
    if op == "max":
        out = np.full(nseg, -np.inf)
        np.maximum.at(out, seg, vals)
        return out
    raise Unsupported(op)


def _running(sp: _SortedPartitions, vals: np.ndarray, op: str) -> np.ndarray:
    """Cumulative-within-partition, peers share the frame-end value."""
    n = sp.n
    if op in ("sum", "count", "avg"):
        cum = np.cumsum(vals)
        # subtract the prefix before each row's partition (indexed via
        # start_of, NOT maximum.accumulate — sums may decrease)
        run = cum - (cum - vals)[sp.start_of]
    else:  # min / max: segmented scan via log-doubling
        run = vals.copy()
        shift = 1
        while shift < n:
            prev = np.empty(n)
            prev[:shift] = run[:shift]
            prev[shift:] = run[:-shift]
            # run[i-shift] never covers rows before its own partition
            # start, so combining is safe iff i-shift is in i's partition
            ok = np.arange(n) - shift >= sp.start_of
            run = np.where(ok, np.minimum(run, prev) if op == "min"
                           else np.maximum(run, prev), run)
            shift *= 2
    # peers-inclusive: every row in a peer group gets the group-end value
    peer_id = np.cumsum(sp.peer_start) - 1
    last_of_peer = np.zeros(peer_id[-1] + 1 if n else 0, dtype=np.int64)
    last_of_peer[peer_id] = np.arange(n)  # last write wins
    return run[last_of_peer[peer_id]]


def compute_window(wf: WindowFunc, env: dict, n: int, eval_host) -> np.ndarray:
    """Evaluate one window function over the current row set."""
    if wf.name not in WINDOW_FUNCS:
        raise Unsupported(f"window function {wf.name}()")
    if (wf.name not in ("row_number", "rank", "dense_rank") and not wf.args):
        raise PlanError(f"{wf.name}() requires an argument")
    if n == 0:
        return np.zeros(0, dtype=object)
    sp = _SortedPartitions(wf.spec, env, n, eval_host)
    name = wf.name

    if name == "row_number":
        return sp.unsort(sp.pos + 1)
    if name == "rank":
        # rank = position of peer-group start + 1
        peer_first = np.where(sp.peer_start, np.arange(n), 0)
        peer_first = np.maximum.accumulate(peer_first)
        return sp.unsort(peer_first - sp.start_of + 1)
    if name == "dense_rank":
        # count of peer starts within the partition
        peer_cum = np.cumsum(sp.peer_start)
        base = np.where(sp.part_start, peer_cum - 1, 0)
        base = np.maximum.accumulate(base)
        return sp.unsort(peer_cum - base)
    if name == "ntile":
        if not (wf.args and isinstance(wf.args[0], Literal)):
            raise PlanError("ntile(n) requires an integer literal")
        buckets = int(wf.args[0].value)
        if buckets <= 0:
            raise PlanError("ntile(n): n must be positive")
        sizes = np.bincount(sp.seg)  # rows per partition
        size_of = sizes[sp.seg]
        # SQL: the first (size % buckets) buckets get one extra row
        base = size_of // buckets
        rem = size_of % buckets
        big_span = (base + 1) * rem  # rows covered by the larger buckets
        in_big = sp.pos < big_span
        tile = np.where(
            in_big,
            sp.pos // np.maximum(base + 1, 1) + 1,
            rem + (sp.pos - big_span) // np.maximum(base, 1) + 1,
        )
        return sp.unsort(tile)

    if name in ("lag", "lead"):
        vals = np.asarray(eval_host(wf.args[0], env, n), dtype=object)
        if vals.ndim == 0:
            vals = np.full(n, vals[()])
        offset = 1
        default = None
        if len(wf.args) > 1:
            c = _const(wf.args[1])
            if c is None:
                raise PlanError(f"{name} offset must be a literal")
            offset = int(c)
        if len(wf.args) > 2:
            default = _const(wf.args[2])
            if default is None:
                raise PlanError(f"{name} default must be a literal")
        if offset < 0:  # postgres: lag(v, -k) == lead(v, k)
            name = "lead" if name == "lag" else "lag"
            offset = -offset
        sv = vals[sp.idx]
        out = np.full(n, default, dtype=object)
        if offset == 0:
            out = sv.copy()
        elif offset < n:
            if name == "lag":
                ok = sp.pos >= offset  # source row in same partition
                out[offset:][ok[offset:]] = sv[:-offset][ok[offset:]]
            else:
                sizes = np.bincount(sp.seg)
                size_of = sizes[sp.seg]
                ok = sp.pos + offset < size_of
                out[:-offset][ok[:-offset]] = sv[offset:][ok[:-offset]]
        return sp.unsort(_denullify(out))

    if name == "first_value":
        vals = np.asarray(eval_host(wf.args[0], env, n), dtype=object)
        if vals.ndim == 0:
            vals = np.full(n, vals[()])
        sv = vals[sp.idx]
        return sp.unsort(_denullify(sv[sp.start_of]))
    if name == "last_value":
        vals = np.asarray(eval_host(wf.args[0], env, n), dtype=object)
        if vals.ndim == 0:
            vals = np.full(n, vals[()])
        sv = vals[sp.idx]
        nseg = int(sp.seg[-1]) + 1 if n else 0
        last = np.zeros(nseg, dtype=np.int64)
        last[sp.seg] = np.arange(n)  # last write wins
        return sp.unsort(_denullify(sv[last[sp.seg]]))

    if name.startswith("anomaly_score_"):
        raw = np.asarray(eval_host(wf.args[0], env, n), dtype=np.float64)
        if raw.ndim == 0:
            raw = np.full(n, float(raw))
        sv = raw[sp.idx]
        out = np.zeros(n)
        nseg = int(sp.seg[-1]) + 1
        if name == "anomaly_score_zscore":
            # vectorized TWO-pass variance (one-pass s2-cnt*mean² loses
            # all precision for large means and goes negative for
            # constant partitions)
            ok = ~np.isnan(sv)
            v = np.where(ok, sv, 0.0)
            cnt = np.bincount(sp.seg, weights=ok.astype(float),
                              minlength=nseg)
            mean = np.bincount(sp.seg, weights=v,
                               minlength=nseg) / np.maximum(cnt, 1)
            centered = np.where(ok, (sv - mean[sp.seg]) ** 2, 0.0)
            ss = np.bincount(sp.seg, weights=centered, minlength=nseg)
            std = np.sqrt(ss / np.maximum(cnt - 1, 1))
            m_r, s_r, c_r = mean[sp.seg], std[sp.seg], cnt[sp.seg]
            # float-noise floor: a "constant" partition's two-pass std is
            # ~eps*|mean|, which must score 0, not astronomically
            tiny = np.finfo(np.float64).eps * np.maximum(np.abs(m_r), 1.0) * 8
            dev = np.abs(sv - m_r)
            with np.errstate(invalid="ignore", divide="ignore"):
                score = np.where(
                    s_r > tiny, dev / s_r,
                    np.where(dev <= tiny, 0.0, np.inf))
            score = np.where((c_r < 2) | ~ok, np.nan, score)
            return sp.unsort(score)
        for s in range(nseg):  # mad/iqr need per-partition quantile sorts
            m = sp.seg == s
            vals = sv[m]
            ok = ~np.isnan(vals)
            v = vals[ok]
            score = np.full(len(vals), np.nan)
            if len(v) >= 2:
                if name == "anomaly_score_mad":
                    med = np.median(v)
                    mad = np.median(np.abs(v - med)) * 1.4826
                    score[ok] = (np.abs(v - med) / mad if mad > 0
                                 else np.where(v == med, 0.0, np.inf))
                else:  # iqr, k=1.5
                    q1, q3 = np.percentile(v, [25, 75])
                    iqr = q3 - q1
                    lo_f, hi_f = q1 - 1.5 * iqr, q3 + 1.5 * iqr
                    dist = np.maximum(lo_f - v, v - hi_f)
                    if iqr > 0:
                        score[ok] = np.where(dist > 0, dist / iqr, 0.0)
                    else:
                        score[ok] = np.where(dist > 0, np.inf, 0.0)
            out[m] = score
        return sp.unsort(out)

    # windowed aggregates ------------------------------------------------
    decode = None  # for string min/max: code → value
    if name == "count" and wf.args and isinstance(wf.args[0], Star):
        vals = np.ones(n)
        nulls = np.zeros(n, dtype=bool)
    else:
        raw = np.asarray(eval_host(wf.args[0], env, n))
        if raw.ndim == 0:
            raw = np.full(n, raw[()])
        if raw.dtype == object:
            nulls = np.array([v is None for v in raw], dtype=bool)
            numeric = all(
                isinstance(v, (int, float, np.integer, np.floating))
                for v in raw[~nulls])
            if numeric:
                vals = np.where(nulls, 0, raw).astype(np.float64)
            elif name == "count":
                vals = np.zeros(n)  # only the null mask matters
            elif name in ("min", "max"):
                # factorized codes are ordered by value, so min/max of
                # codes IS min/max of values; decode at the end
                codes, nulls = _factorize(raw, n)
                uniq = np.unique(raw[~nulls].astype(str))
                decode = np.array(list(uniq) + [None], dtype=object)
                vals = codes.astype(np.float64)
            else:
                raise PlanError(
                    f"{name}() over a non-numeric column")
        else:
            vals = raw.astype(np.float64)
            nulls = np.isnan(vals)
            vals = np.where(nulls, 0, vals)
    sv = vals[sp.idx]
    snull = nulls[sp.idx]
    nseg = int(sp.seg[-1]) + 1 if n else 0

    # empty frames (no non-null value yet / all-null partition) → NULL
    # for sum/avg/min/max, 0 for count — SQL semantics, matching the
    # grouped path's cnt>0 guard (ops/segment.py)
    def finish(out, cnt):
        res = np.where(cnt > 0, out, np.nan)
        if decode is not None:  # string min/max: codes → values
            codes = np.where(np.isnan(res), len(decode) - 1,
                             res).astype(np.int64)
            res = decode[codes]
        return sp.unsort(res)

    if not wf.spec.order_by:  # whole-partition totals
        cnt = np.bincount(sp.seg, weights=(~snull).astype(float),
                          minlength=nseg)[sp.seg]
        if name == "count":
            return sp.unsort(cnt.astype(np.int64))
        if name in ("sum", "avg"):
            s = np.bincount(sp.seg, weights=np.where(snull, 0, sv),
                            minlength=nseg)[sp.seg]
            out = s if name == "sum" else s / np.maximum(cnt, 1)
        else:
            masked = np.where(snull, np.inf if name == "min" else -np.inf, sv)
            out = _seg_totals(sp.seg, masked, nseg, name)[sp.seg]
        return finish(out, cnt)

    # running with ORDER BY
    rc = _running(sp, (~snull).astype(float), "count")
    if name == "count":
        return sp.unsort(rc.astype(np.int64))
    if name in ("sum", "avg"):
        s = _running(sp, np.where(snull, 0, sv), "sum")
        out = s if name == "sum" else s / np.maximum(rc, 1)
    else:
        masked = np.where(snull, np.inf if name == "min" else -np.inf, sv)
        out = _running(sp, masked, name)
    return finish(out, rc)
