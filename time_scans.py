"""Times the users of csrc/scan.cuh's single-pass scan, K24's grid
scatter, the two dense-grid kernels and K14's two window sorts on the
card, each checked against its plain version first.

- ``scan``: compact (12 columns, N = 35,651,584, ~8 % kept scattered
  and in runs of 97 rows, beside nonzero + index_select; its host
  microseconds a call at 4,096 rows), topk_select
  (one int64 key DESC under a ~10 % mask, k = 10, as chip_smoke.py's
  query (j); two keys, k = 65,536), rank_scatter and prefix_scan
  (N = 41,943,040), with the kernels' device times of one call of compact
  and of (j) by torch.profiler.
- ``scatter``: K24 at the hot tail's TSBS hour (see ``scatter``),
  grid_scatter_steps and grid_scatter, beside index_put_ and the grid
  copy.
- ``grid``: bucket_reduce at the SQL grid path's shapes (the f32 partial
  sums [10, 4096, 10240] and the u8 valid plane at r = 360; the masked
  12 h + 5 min window, sum and min) and group_merge ([10, 4096, 24] into
  4,096 groups; PromQL's [2^20, 20] into 100,000), each by CUDA events
  around the call (``_ms``) and as device time alone (``_graph_ms``: 20
  calls captured in one CUDA graph).  Only functions the port has had
  since its first grid slice are called, so one copy of this script
  times any checkout.
- ``matrix``: K14's two sorting kernels at PromQL's main-path shapes: a
  sort layout (``sort_layout``) of 2^20 series x 40 scrapes at 15 s,
  ``window_matrix`` quantile (φ 0.9) and mad over its ``[2^20, 20]``
  windows of 5 m (lmax 32), and ``window_matrix_dense`` quantile and mad
  over a seeded ``[2^20, 20, 6]`` matrix (~5 % NaN), each held equal to
  its plain version bit for bit, then by events and as device time.
  Every call takes the wrapper's default route, so the parent's
  checkout times the warp sort and a later one the register route.  Then
  ``segment_select``, the register network's other user, at
  ``chip_smoke.py`` phase 5's shapes: 2 ranks of 100,000 groups of 10 x
  20 steps (its register route) and the 5th largest of 1,000,000.
- ``windows``: the PromQL window kernels on chip_smoke.py's PromQL table
  (1,000,000 series x 40 scrapes at 15 s, seed 11, ingested through
  ``prom_ingest`` with no flush): the warm instant ``sum by (pod)
  (rate(m[5m]))``, the fused 20-step ``sum by (pod) (avg_over_time(m[5m]))``
  and ``quantile_over_time(0.9, m[5m])`` through ``PromEvaluator``
  (median of 10 warm runs, host clock after a synchronize), then on the
  engine's own sort layout and a selection of every series padded to
  2^20: ``counter_window`` (rate at [2^20, 20], rate and instant at
  T = 1), ``window_stats`` (gauge_window, counter_rc, regression, irate),
  ``minmax_window``, ``window_count_max`` and ``window_matrix`` quantile at
  [2^20, 20], each by events and, but ``window_count_max`` (its result
  is read on the host), as device time.  Where ``counter_window`` takes
  a ``gdrop`` argument (a checkout before the range geometry) the layout's
  ``prefix_scan`` is timed too and passed in; where the wrappers take
  ``geometry`` the forced whole-layout search is timed beside the
  default, held equal bit for bit, and so is ``series_offsets``.

Prints one line, ``PROBE {json}``.

Run from the root of a checkout, which it imports the port from:
``python3 time_scans.py TAG [scan|scatter|grid|matrix|windows|all]``
(default all; ``windows`` runs only when named).  To compare two commits on one
card, run it from each checkout's root one after another: parent, change,
change, parent."""
import inspect
import json
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, ".")
from greptimedb_tpu_torch.ops import grid_kernels as gk  # noqa: E402
from greptimedb_tpu_torch.ops import promql_kernels as pk  # noqa: E402
from greptimedb_tpu_torch.ops import segment_kernels as sk  # noqa: E402
from greptimedb_tpu_torch.ops import topk_kernels as tk  # noqa: E402

dev = torch.device("cuda")
res = {}


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    out.sort()
    return out[len(out) // 2]


def split(fn):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            k = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            rows.append((round(us / 1e3, 4), k.split("<")[0].split("(")[0][:30], e.count))
    return sorted(rows, reverse=True)[:5]


def graph_ms(fn, reps=20):
    """Device time of one call: ``reps`` calls in one CUDA graph, the
    median of 10 replays over ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(10):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    out.sort()
    return out[len(out) // 2]


def both(key, fn):
    res[key + "_ms"] = time_ms(fn)
    res[key + "_graph_ms"] = graph_ms(fn)


def rel_err(got, want):
    g, w = got.double(), want.double()
    ok = torch.isfinite(w)
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert torch.equal(g[torch.isinf(w)], w[torch.isinf(w)])
    return float(((g - w).abs()[ok] / w.abs()[ok].clamp(min=1)).max())


def grid():
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    c, s, t, r = 10, 4096, 10240, 360
    nb = -(-t // r)
    values = torch.rand((c, s, t), generator=gen, device=dev) * 100
    valid = torch.rand((s, t), generator=gen, device=dev) > 0.02
    values *= valid
    geo = dict(r=r, nb=nb, pad_l=0, pad_r=nb * r - t)
    err = rel_err(gk.bucket_reduce(values, "sum", **geo),
                  gk.bucket_reduce_plain(values, "sum", **geo))
    assert err <= 1e-5, err
    both("br_sum", lambda: gk.bucket_reduce(values, "sum", **geo))
    assert torch.equal(gk.bucket_reduce(valid, "sum", **geo),
                       gk.bucket_reduce_plain(valid, "sum", **geo))
    both("br_u8", lambda: gk.bucket_reduce(valid, "sum", **geo))
    w_raw, s0, pad_l = 12 * r, 6 * r + 30, 330
    nan_vals = values.clone()
    nan_vals[0, ::7, ::11] = float("nan")
    tmask = torch.ones(w_raw, dtype=torch.bool, device=dev)
    tmask[:5] = False
    v2 = valid.narrow(1, s0, w_raw) & tmask[None, :]
    kw = dict(r=r, nb=13, s0=s0, w_raw=w_raw, pad_l=pad_l,
              pad_r=13 * r - pad_l - w_raw, mask=v2, mask_s0=0,
              skip_nan=True)
    for op in ("sum", "min"):
        err = rel_err(gk.bucket_reduce(nan_vals, op, **kw),
                      gk.bucket_reduce_plain(nan_vals, op, **kw))
        assert err <= (1e-5 if op == "sum" else 0.0), err
        both(f"br_masked_{op}",
             lambda op=op: gk.bucket_reduce(nan_vals, op, **kw))
    del values, valid, nan_vals, v2
    ngt, nbm = 4096, 24
    x = torch.rand((c, s, nbm), generator=gen, device=dev) * 1000
    ids = torch.randint(0, ngt, (s,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.rand(s, generator=gen, device=dev) < 0.05] = ngt
    lay = gk.group_layout(ids, ngt)
    got = gk.group_merge(x, lay, "sum")
    want = gk.group_merge_plain(x.cpu(), gk.group_layout(ids.cpu(), ngt),
                                "sum")
    assert torch.equal(got.cpu(), want)
    both("gm", lambda: gk.group_merge(x, lay, "sum"))
    cnt = torch.randint(0, 361, (s, nbm), generator=gen, device=dev)
    both("gm_i64", lambda: gk.group_merge(cnt, lay, "sum"))
    pods, sp = 100_000, 1 << 20
    xp = torch.rand((sp, 20), generator=gen, device=dev) * 10
    idp = torch.arange(sp, device=dev, dtype=torch.int32) // 10
    idp = torch.where(idp < pods, idp, pods).to(torch.int32)
    layp = gk.group_layout(idp, pods)
    err = rel_err(gk.group_merge(xp, layp, "sum"),
                  gk.group_merge_plain(xp, layp, "sum"))
    assert err <= 1e-5, err
    both("gm_prom", lambda: gk.group_merge(xp, layp, "sum"))
    host_costs()


def host_us(fn, n=2000):
    """Host microseconds a call, from a loop of ``n`` calls on inputs so
    small that the device keeps up: the wrapper's own cost."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def host_costs():
    """The host path of a ctypes-bound kernel call beside one PyTorch op's,
    and the pieces the wrappers spend it on."""
    x = torch.ones((1, 2, 4), device=dev)
    lay = gk.group_layout(torch.zeros(2, dtype=torch.int32, device=dev), 1)
    buf = torch.zeros((1, 2, 4), device=dev)
    ids = lay.ids.long()
    xs = x[0]
    idx = dev.index or 0
    out = {
        "group_merge": host_us(lambda: gk.group_merge(x, lay, "sum")),
        "bucket_reduce": host_us(lambda: gk.bucket_reduce(xs, "sum", r=2,
                                                          nb=2)),
        "index_add_": host_us(lambda: buf.index_add_(1, ids, x)),
        "torch.empty": host_us(lambda: torch.empty((1, 1, 4), device=dev)),
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        out["raw_stream"] = host_us(lambda: raw(idx))
    res["host_us"] = out


def same_bits(a, b):
    """Equal bit for bit, any NaN equal to any NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def matrix_inputs():
    """PromQL's main-path inputs of K14's two sorting kernels: (the sort
    layout of 2^20 series x 40 scrapes, with its series offset table
    where the checkout has one, the selection, the grid start, the window
    geometry, lmax, the seeded [2^20, 20, 6] subquery matrix, φ 0.9 a
    step)."""
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    series, scrapes, t0 = 1 << 20, 40, 1_700_000_000_000
    i = torch.arange(series * scrapes, device=dev)
    ts = t0 + (i % scrapes) * 15_000 + torch.randint(
        -500, 500, i.shape, generator=g, device=dev)
    val = torch.rand(i.shape, generator=g, device=dev) * 1000
    tsid = (i // scrapes).to(torch.int32)
    layout = pk.sort_layout(ts, val, tsid, torch.ones_like(tsid,
                                                           dtype=torch.bool))
    if hasattr(pk, "with_series_offsets"):
        layout = pk.with_series_offsets(layout, series)
    del i, ts, val, tsid
    sel = torch.arange(series, dtype=torch.int32, device=dev)
    geo = dict(step_ms=15_000, num_steps=20, range_ms=300_000)
    start = t0 + 300_000
    cm = pk.window_count_max(layout, sel, start, **geo)
    lmax = max(2, 1 << (cm - 1).bit_length())
    win = torch.rand((series, 20, 6), generator=g, device=dev) * 100
    win[torch.rand(win.shape, generator=g, device=dev) < 0.05] = float("nan")
    q = torch.full((20,), 0.9, device=dev)
    return layout, sel, start, geo, lmax, win, q


def matrix():
    layout, sel, start, geo, lmax, win, q = matrix_inputs()
    res["matrix_lmax"] = lmax
    for kind in ("quantile", "mad"):
        kw = dict(lmax=lmax, kind=kind, a1=q, **geo)
        got = pk.window_matrix(layout, sel, start, **kw)
        want = pk.window_matrix_plain(layout, sel, start, **kw)
        assert same_bits(got, want)
        del got, want
        both(f"wm_{kind}",
             lambda kw=kw: pk.window_matrix(layout, sel, start, **kw))
    del layout
    for kind in ("quantile", "mad"):
        got = pk.window_matrix_dense(win, kind, q)
        want = pk.window_matrix_dense_plain(win, kind, q)
        assert same_bits(got, want)
        del got, want
        both(f"wmd_{kind}",
             lambda kind=kind: pk.window_matrix_dense(win, kind, q))
    del win
    # segment_select, the register network's other user, at phase 5's
    # shapes: quantile by pod (100,000 groups of 10: the tiny route) and
    # the 5th largest of 1,000,000 (ng = 1)
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    pods, series = 100_000, 1_000_000
    rate = torch.rand((series, 20), generator=g, device=dev) * 50
    rate[torch.rand(rate.shape, generator=g, device=dev) < 0.01] = float(
        "nan")
    order = torch.arange(series, dtype=torch.int32, device=dev)
    offs = torch.arange(0, series + 1, 10, dtype=torch.int64, device=dev)
    cnt = (~torch.isnan(rate)).reshape(pods, 10, 20).sum(1)
    r = 0.99 * torch.clamp(cnt.float() - 1, min=0)
    ranks = torch.stack([torch.floor(r), torch.ceil(r)]).to(torch.int32)
    work = torch.where(torch.isnan(rate), float("-inf"), rate)
    one = torch.tensor([0, series], dtype=torch.int64, device=dev)
    top = torch.full((1, 1, 20), series - 5, dtype=torch.int32, device=dev)
    for key, args in (("sel_quantile", (rate, order, offs, ranks)),
                      ("sel_topk", (work, order, one, top))):
        assert torch.equal(sk.segment_select(*args),
                           sk.segment_select_plain(*args))
        both(key, lambda args=args: sk.segment_select(*args))


def windows():
    import chip_smoke as cs
    from greptimedb_tpu_torch.promql.engine import PromEvaluator
    from greptimedb_tpu_torch.promql.engine import SelectorData
    from greptimedb_tpu_torch.promql.parser import parse_promql
    from greptimedb_tpu_torch.standalone import GreptimeDB
    from greptimedb_tpu_torch.storage.region import RegionOptions

    home = tempfile.mkdtemp(prefix="time_scans_windows_")
    db = GreptimeDB(home, region_options=RegionOptions(
        wal_enabled=False, flush_threshold_bytes=1 << 40))
    db.sql("CREATE TABLE http_requests_total (pod STRING, container STRING, "
           "ts TIMESTAMP(3) TIME INDEX, val DOUBLE, "
           "PRIMARY KEY (pod, container))")
    cs.prom_ingest(db, 40, 11, False)
    t_end = cs.PROM_T0 + 39 * cs.SCRAPE_MS
    start = t_end - 19 * cs.SCRAPE_MS
    m = "http_requests_total"
    queries = {
        "q_instant_rate": (f"sum by (pod) (rate({m}[5m]))", t_end, t_end),
        "q_fused_avg": (f"sum by (pod) (avg_over_time({m}[5m]))", start,
                        t_end),
        "q_quantile": (f"quantile_over_time(0.9, {m}[5m])", start, t_end),
    }
    for key, (expr, a, b) in queries.items():
        e = parse_promql(expr)

        def run(e=e, a=a, b=b):
            res = PromEvaluator(db, a / 1000, b / 1000, 15.0).eval(e)
            torch.cuda.synchronize()
            return res

        run()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        res[key + "_ms"] = walls[len(walls) // 2]
    layout = SelectorData(db, m).sort_layout("val")
    s_pad = 1 << 20
    sel = torch.full((s_pad,), -1, dtype=torch.int32, device=dev)
    sel[:cs.PROM_SERIES] = torch.arange(cs.PROM_SERIES, dtype=torch.int32,
                                        device=dev)
    takes_gdrop = "gdrop" in inspect.signature(pk.counter_window).parameters
    geometry = "geometry" in inspect.signature(pk.counter_window).parameters
    res["layout_entries"] = len(layout)
    if takes_gdrop:
        gd = pk.prefix_scan(*layout[2:5])
        both("prefix_scan", lambda: pk.prefix_scan(*layout[2:5]))
    if hasattr(pk, "series_offsets"):
        n_series = int(layout[7].shape[0]) - 2
        assert torch.equal(pk.series_offsets(layout[0], layout[6], n_series),
                           layout[7])
        both("series_offsets",
             lambda: pk.series_offsets(layout[0], layout[6], n_series))
    geo20 = dict(step_ms=cs.SCRAPE_MS, num_steps=20, range_ms=cs.RANGE_MS)
    geo1 = dict(step_ms=cs.SCRAPE_MS, num_steps=1, range_ms=cs.RANGE_MS)
    rate = dict(kind="rate", func="rate", range_s=cs.RANGE_MS / 1000)

    def cw(t0, kw, **extra):
        if takes_gdrop:
            g = gd if kw["kind"] != "instant" else None
            return pk.counter_window(layout, g, sel, t0, **kw, **extra)
        return pk.counter_window(layout, sel, t0, **kw, **extra)

    def on_layout(wrapper):
        return lambda t0, kw, **extra: wrapper(layout, sel, t0, **kw,
                                               **extra)

    kernels = {
        "cw_rate20": (cw, start, dict(**rate, **geo20)),
        "cw_rate1": (cw, t_end, dict(**rate, **geo1)),
        "cw_instant1": (cw, t_end, dict(kind="instant", **geo1)),
        "minmax": (on_layout(pk.minmax_window), start, geo20),
    }
    for kind in ("gauge_window", "counter_rc", "regression", "irate"):
        kernels[f"ws_{kind}"] = (on_layout(pk.window_stats), start,
                                 dict(kind=kind, **geo20))
    cm = pk.window_count_max(layout, sel, start, **geo20)
    lmax = max(2, 1 << (cm - 1).bit_length())
    q = torch.full((20,), 0.9, device=dev)
    kernels["wm_quantile"] = (on_layout(pk.window_matrix), start,
                              dict(lmax=lmax, kind="quantile", a1=q,
                                   **geo20))
    for key, (fn, t0, kw) in kernels.items():
        both(key, lambda fn=fn, t0=t0, kw=kw: fn(t0, kw))
        if geometry:
            a, b = fn(t0, kw), fn(t0, kw, geometry="search")
            a = a if isinstance(a, dict) else {"v": a}
            b = b if isinstance(b, dict) else {"v": b}
            assert all(same_bits(a[k], b[k]) if a[k].dtype == torch.float32
                       else torch.equal(a[k], b[k]) for k in a), key
            both(key + "_search",
                 lambda fn=fn, t0=t0, kw=kw: fn(t0, kw, geometry="search"))
    res["wcm_ms"] = time_ms(lambda: pk.window_count_max(layout, sel, start,
                                                        **geo20))
    if geometry:
        assert cm == pk.window_count_max(layout, sel, start,
                                         geometry="search", **geo20)
        res["wcm_search_ms"] = time_ms(lambda: pk.window_count_max(
            layout, sel, start, geometry="search", **geo20))
    db.close()
    shutil.rmtree(home, ignore_errors=True)


def scan():
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    N = 35_651_584
    usage = torch.rand(N, device=dev, generator=g) * 100
    hot = usage > 91.6
    cols = {"hostname": torch.arange(N, device=dev, dtype=torch.int32) // 8912,
            "ts": 1_700_000_000_000 + (torch.arange(N, device=dev) % 8912) * 10_000}
    for m in range(10):
        cols[f"m{m}"] = torch.rand(N, device=dev, generator=g)
    got, kept = sk.compact(cols, hot)
    want, wk = sk.compact_plain(cols, hot)
    assert kept == wk and all(torch.equal(got[k], want[k]) for k in cols)
    res["compact_ms"] = time_ms(lambda: sk.compact(cols, hot))
    res["compact_split"] = split(lambda: sk.compact(cols, hot))
    # kept rows in runs of 97, as (f)'s hot hours of one host
    runs = (torch.rand(-(-N // 97), device=dev, generator=g) < 0.084
            ).repeat_interleave(97)[:N]
    got, kept = sk.compact(cols, runs)
    want, wk = sk.compact_plain(cols, runs)
    assert kept == wk and all(torch.equal(got[k], want[k]) for k in cols)
    res["compact_runs_ms"] = time_ms(lambda: sk.compact(cols, runs))
    res["compact_runs_split"] = split(lambda: sk.compact(cols, runs))

    def library():
        rows = torch.nonzero(hot).squeeze(1)
        return [col.index_select(0, rows) for col in cols.values()]

    res["compact_library_ms"] = time_ms(library)
    tiny = {k: v[:4096] for k, v in cols.items()}
    res["compact_host_us"] = host_us(lambda: sk.compact(tiny, hot[:4096]),
                                     n=200)
    del got, want, runs
    keys = [(cols["ts"], False, None)]
    mask = usage > 90
    got, gn = tk.topk_select(keys, mask, 10)
    want, wn = tk.topk_select_plain(keys, mask, 10)
    assert gn == wn and torch.equal(got, want)
    res["topk_j_ms"] = time_ms(lambda: tk.topk_select(keys, mask, 10))
    res["topk_j_split"] = split(lambda: tk.topk_select(keys, mask, 10))
    keys = [(usage, False, None), (cols["ts"], True, None)]
    got, gn = tk.topk_select(keys, torch.ones_like(mask), 65_536)
    want, wn = tk.topk_select_plain(keys, torch.ones_like(mask), 65_536)
    assert gn == wn and torch.equal(got, want)
    res["topk_l_ms"] = time_ms(lambda: tk.topk_select(keys, torch.ones_like(mask), 65_536))
    key = torch.where(hot, torch.floor(usage / 10).long(), sk.I64_MAX)
    order = sk.radix_argsort(key, hot)
    got = sk.rank_scatter(key, order, hot, N)
    want = sk.rank_scatter_plain(key, order, hot, N)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    res["rank_scatter_ms"] = time_ms(lambda: sk.rank_scatter(key, order, hot, N))
    del cols, got, want, key, order
    NP = 41_943_040
    val = torch.rand(NP, device=dev, generator=g) * 100
    tsid = (torch.arange(NP, device=dev) // 40).to(torch.int32)
    valid = torch.rand(NP, device=dev, generator=g) > 0.001
    a = pk.prefix_scan(val, tsid, valid)
    b = pk.prefix_scan(val, tsid, valid)
    w = pk.prefix_scan_plain(val, tsid, valid)
    assert torch.equal(a, b)
    res["prefix_scan_rel"] = float(((a - w).abs() / w.abs().clamp(min=1)).max())
    res["prefix_scan_ms"] = time_ms(lambda: pk.prefix_scan(val, tsid, valid))


def scatter():
    """K24 at the hot tail's TSBS hour: 4,000 series x 360 whole steps
    (time-major, as the write brings them) after 24 h into a seeded
    [10, 4096, 10240] grid: grid_scatter_steps where the checkout has it
    (with the host time of ``step_cells`` on the cells), grid_scatter on
    the same cells and on them in (tsid, ts) order (the catch-up shape),
    each equal to index_put_ first; then one
    index_put_ over the planes + one on valid, and the hot tail's grid
    copy (a clone of both tensors; device time: copy_ into held
    buffers)."""
    from greptimedb_tpu_torch.ops import storage_kernels as stk

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    c, spad, tpad, S, k, t0 = 10, 4096, 10240, 4000, 360, 8640
    base_v = torch.rand((c, spad, tpad), generator=g, device=dev)
    base_m = torch.rand((spad, tpad), generator=g, device=dev) > 0.5
    seq = torch.arange(S, device=dev)
    steps = torch.arange(t0, t0 + k, device=dev)
    tsid, tidx = seq.repeat(k), steps.repeat_interleave(S)
    delta = torch.rand((c, S * k), generator=g, device=dev)
    flags = torch.ones(S * k, dtype=torch.bool, device=dev)
    order = torch.argsort(tsid * tpad + tidx)
    ts_s, tx_s = tsid[order], tidx[order]
    delta_s, flags_s = delta[:, order].contiguous(), flags[order]
    want_v, want_m = base_v.clone(), base_m.clone()
    want_v[:, tsid, tidx] = delta
    want_m[tsid, tidx] = flags
    values, valid = torch.empty_like(base_v), torch.empty_like(base_m)
    routes = {
        "cells": lambda: stk.grid_scatter(values, valid, tsid, tidx, delta,
                                          flags),
        "catch_up": lambda: stk.grid_scatter(values, valid, ts_s, tx_s,
                                             delta_s, flags_s),
    }
    if hasattr(stk, "grid_scatter_steps"):
        routes["steps"] = lambda: stk.grid_scatter_steps(
            values, valid, seq, steps, delta, flags)
        ht, hx = tsid.cpu().numpy(), tidx.cpu().numpy()
        got = stk.step_cells(ht, hx)
        assert got is not None
        t1 = time.perf_counter()
        for _ in range(5):
            stk.step_cells(ht, hx)
        res["scatter_detect_ms"] = (time.perf_counter() - t1) / 5 * 1e3
    for name, fn in routes.items():
        values.copy_(base_v)
        valid.copy_(base_m)
        fn()
        assert torch.equal(values, want_v) and torch.equal(valid, want_m)
        both(f"scatter_{name}", fn)

    def index_put():
        want_v[:, tsid, tidx] = delta
        want_m[tsid, tidx] = flags

    def copy_into():
        values.copy_(base_v)
        valid.copy_(base_m)

    both("scatter_index_put", index_put)
    res["scatter_copy_ms"] = time_ms(lambda: (base_v.clone(),
                                              base_m.clone()), reps=5)
    res["scatter_copy_graph_ms"] = graph_ms(copy_into, reps=5)


def main():
    tag = sys.argv[1]
    what = sys.argv[2] if len(sys.argv) > 2 else "all"
    res["tree"] = tag
    if what == "windows":
        windows()
        torch.cuda.empty_cache()
    if what in ("matrix", "all"):
        matrix()
        torch.cuda.empty_cache()
    if what in ("grid", "all"):
        grid()
        torch.cuda.empty_cache()
    if what in ("scatter", "all"):
        scatter()
        torch.cuda.empty_cache()
    if what in ("scan", "all"):
        scan()
    print("PROBE " + json.dumps(res))


if __name__ == "__main__":
    main()
