"""Times the users of csrc/scan.cuh's single-pass scan and the two
dense-grid kernels on the card, each checked against its plain version
first.

- ``scan``: compact (12 columns, N = 35,651,584, ~8 % kept), topk_select
  (one int64 key DESC under a ~10 % mask, k = 10, as chip_smoke.py's
  query (j); two keys, k = 65,536), rank_scatter and prefix_scan
  (N = 41,943,040), with the kernels' device times of one call of compact
  and of (j) by torch.profiler.
- ``grid``: bucket_reduce at the SQL grid path's shapes (the f32 partial
  sums [10, 4096, 10240] and the u8 valid plane at r = 360; the masked
  12 h + 5 min window, sum and min) and group_merge ([10, 4096, 24] into
  4,096 groups; PromQL's [2^20, 20] into 100,000), each by CUDA events
  around the call (``_ms``) and as device time alone (``_graph_ms``: 20
  calls captured in one CUDA graph).  Only functions the port has had
  since its first grid slice are called, so one copy of this script
  times any checkout.

Prints one line, ``PROBE {json}``.

Run from the root of a checkout, which it imports the port from:
``python3 time_scans.py TAG [scan|grid|all]`` (default all).  To compare
two commits on one card, run it from each checkout's root in one
session: parent, change, change, parent."""
import json
import sys
import time

import torch

sys.path.insert(0, ".")
from greptimedb_tpu_torch.ops import grid_kernels as gk  # noqa: E402
from greptimedb_tpu_torch.ops import promql_kernels as pk  # noqa: E402
from greptimedb_tpu_torch.ops import segment_kernels as sk  # noqa: E402
from greptimedb_tpu_torch.ops import topk_kernels as tk  # noqa: E402

dev = torch.device("cuda")
tag = sys.argv[1]
what = sys.argv[2] if len(sys.argv) > 2 else "all"


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


res = {"tree": tag}
if what in ("grid", "all"):
    grid()
    torch.cuda.empty_cache()
if what in ("scan", "all"):
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
    del got, want
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
print("PROBE " + json.dumps(res))
