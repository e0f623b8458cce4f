"""Times the users of csrc/scan.cuh's single-pass scan on the card:
compact (12 columns, N = 35,651,584, ~8 % kept), topk_select (one int64
key DESC under a ~10 % mask, k = 10, as chip_smoke.py's query (j); two
keys, k = 65,536), rank_scatter and prefix_scan (N = 41,943,040), each
checked against its plain version first, with the kernels' device times
of one call of compact and of (j) by torch.profiler.  Prints one line,
``PROBE {json}``.

Run from the root of a checkout, which it imports the port from:
``python3 time_scans.py TAG``.  To compare two commits on one card, run
it from each checkout's root in one session: parent, change, change,
parent."""
import json
import sys

import torch

sys.path.insert(0, ".")
from greptimedb_tpu_torch.ops import promql_kernels as pk  # noqa: E402
from greptimedb_tpu_torch.ops import segment_kernels as sk  # noqa: E402
from greptimedb_tpu_torch.ops import topk_kernels as tk  # noqa: E402

dev = torch.device("cuda")
tag = sys.argv[1]


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


g = torch.Generator(device=dev)
g.manual_seed(3)
N = 35_651_584
res = {"tree": tag}
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
