"""Where ``counter_window``'s rate mode and ``window_stats``' gauge kind
spend their time in the range geometry, and variants of their bodies
(``probes/window_bodies.cu``): each variant's registers a thread, spill
bytes and resident blocks an SM (``cudaFuncGetAttributes``,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and its device time
beside the port's own kernel (``pk.counter_window`` / ``pk.window_stats``
in the range and the forced search geometry).

Variants, in ``CW`` and ``GAUGE`` order: ``port`` (the port's body, rate
mode or gauge alone), ``nodrop`` / ``nobody`` (the loop over the window's
rows left out: timing only, its outputs are wrong), ``warpscan`` (a
warp's f64 drop prefix in shared memory, a window's sum the difference of
two prefixes), ``pair`` (the two searches in one loop), ``loop32`` (the
port's row-order sum on 32-bit offsets, unrolled by 4), ``ldg`` (the
same through ``__ldg``), ``two_pass`` (a compare-only pass first, the sum
only where a window has a drop) and ``__launch_bounds__`` minimum blocks
of 4 / 6 / 8 (``minb4``, ``minb6``, ``minb8``).  Then the port's
``counter_window_kernel`` (rate, instant, and counter where T > 1) and
``window_stats_kernel`` (its four kinds) instantiations under minimum
blocks of 1, 4, 5, 6 and 8 (``MINB <m>``), one thread a window, and
under minimum 1 on a grid of at most 2, 4 or 6 blocks an SM whose
threads stride over the windows (``cap <c>``), on the counters at T = 1,
2, 4, 8 and 20 steps, each held to the wrapper bit for bit.

Inputs: ``time_scans.py``'s ``matrix_inputs`` (a sort layout of 2^20
series x 40 scrapes at 15 s with its series offset table, every series
selected), with two value columns: its uniform values (a drop at half the
rows) and counters (a reset at 2 % of the rows), at [2^20, 20] windows of
5 m and at T = 1.  Every variant but the timing-only ones is first held
to the port's kernel: bit for bit, ``warpscan`` within the rate
tolerance of the tests (``1e-5 * max(1, |b|)``).  Then each one's device
time (``graph_ms``: 20 calls in one CUDA graph), forward and back; the
port's kernel also by CUDA events (``time_ms``).

Prints one line, ``PROBE_BODIES {json}`` (ms a call).

Run from the root of a checkout: ``python3 probes/window_bodies.py``.  It
builds ``probes/window_bodies.cu`` (which compiles in
``greptimedb_tpu_torch/csrc/promql_kernels.cu``) with nvcc into
``probes/build/``."""
import ctypes
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")
from greptimedb_tpu_torch.ops import cuda_build  # noqa: E402
from greptimedb_tpu_torch.ops import promql_kernels as pk  # noqa: E402
from time_scans import graph_ms, matrix_inputs, time_ms  # noqa: E402

HERE = Path(__file__).resolve().parent
CW = ("port", "nodrop", "warpscan", "pair", "pair_warpscan", "minb4",
      "minb6", "pair_warpscan_minb6", "nodrop_minb6", "loop32",
      "loop32_minb6", "ldg_minb6", "two_pass_minb6", "loop32_minb8",
      "nodrop_minb8")
GAUGE = ("port", "nobody", "pair", "minb4", "minb6", "pair_minb6")
TIMING_ONLY = ("nodrop", "nobody")
GAUGE_KEYS = ("count", "sum", "avg", "var", "last", "first", "first_ts",
              "last_ts")


def counters(layout, scrapes=40, seed=15):
    """A counter column for the layout's rows (``scrapes`` a series, in
    order): rising by ~10 a scrape, back near 0 at 2 % of the rows."""
    g = torch.Generator(device=layout[2].device)
    g.manual_seed(seed)
    n = layout[2].shape[0]
    j = torch.arange(n, device=layout[2].device) % scrapes
    u = torch.rand(n, generator=g, device=layout[2].device)
    reset = torch.rand(n, generator=g, device=layout[2].device) < 0.02
    return torch.where(reset, u * 5, j * 10 + u * 5).float()


CW_KEYS = ("count", "first_ts", "last_ts", "first_val", "last_val",
           "delta_adj", "delta_raw", "last", "rate")
STATS_KEYS = ("count", "sum", "avg", "var", "last", "first", "first_ts",
              "last_ts", "resets", "changes", "slope", "intercept", "prev_ts",
              "last_val", "prev_val")


def port_minb(lib, minbs, lay, sel, t0, kw, args):
    """The port's two kernels under each minimum-blocks count: held to
    the wrappers bit for bit, then timed forward and back."""
    S, T, rng = sel.shape[0], kw["num_steps"], kw["range_ms"]
    # (index into minbs, blocks an SM at most: 0 = a thread a window)
    configs = [(v, 0) for v in range(len(minbs))]
    configs += [(0, cap) for cap in (2, 4, 6)]

    def outs(keys):
        return {k: torch.empty((S, T), device=sel.device,
                               dtype=torch.int64 if k.endswith("_ts")
                               else torch.float32) for k in keys}

    cases = [("cw_rate", "rate"), ("cw_instant", "instant")]
    if T > 1:
        cases.append(("cw_counter", "counter"))
    cases += [(f"stats_{k}", k) for k in pk._STATS_KINDS]
    calls = []
    for name, kind in cases:
        if name.startswith("cw"):
            o = outs(CW_KEYS)
            want = pk.counter_window(lay, sel, t0, kind=kind, func="rate",
                                     range_s=rng / 1000, **kw)
            want = {"rate": want} if kind == "rate" else want

            def call(v, cap, kind=kind, o=o):
                cuda_build.check(lib.probe_cw_mode(
                    v, cap, *args, pk._MODES[kind], 1, 1, rng / 1000,
                    *[o[k].data_ptr() for k in CW_KEYS],
                    cuda_build.stream_ptr(sel)), "cw_mode")
        else:
            o = outs(STATS_KEYS)
            want = pk.window_stats(lay, sel, t0, kind=kind, **kw)

            def call(v, cap, kind=kind, o=o):
                cuda_build.check(lib.probe_stats(
                    v, cap, *args, pk._STATS_KINDS[kind],
                    *[o[k].data_ptr() for k in STATS_KEYS],
                    cuda_build.stream_ptr(sel)), "stats")
        for v, cap in configs:
            call(v, cap)
            for k, w in want.items():
                assert torch.equal(o[k].nan_to_num(-7.0),
                                   w.nan_to_num(-7.0)), (name, v, cap, k)
        del want
        calls += [(f"MINB {minbs[v]}{f' cap {cap}' if cap else ''}:{name}",
                   lambda v=v, cap=cap, call=call: call(v, cap))
                  for v, cap in configs]
    times = {name: [] for name, _fn in calls}
    for name, fn in calls + calls[::-1]:
        times[name].append(graph_ms(fn))
    return times


def main():
    lib_path = cuda_build.build_many([(
        HERE / "window_bodies.cu",
        HERE / "build" / "libprobe_window_bodies.so",
        pk.NVCC_FLAGS)], force=True)[0]
    lib = ctypes.CDLL(str(lib_path))
    vp, ll, i32, f64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_double)
    geo_t = [vp, vp, vp, ll, vp, vp, vp, ll, ll, ll, ll, ll, vp, ll]
    lib.probe_cw.argtypes = [i32, *geo_t, i32, f64, vp, vp]
    lib.probe_gauge.argtypes = [i32, *geo_t, *[vp] * 9]
    lib.probe_attrs.argtypes = [i32, i32, i32, vp]
    lib.probe_cw_mode.argtypes = [i32, i32, *geo_t, i32, i32, i32, f64,
                                  *[vp] * 10]
    lib.probe_stats.argtypes = [i32, i32, *geo_t, i32, *[vp] * 16]
    for f in (lib.probe_cw, lib.probe_gauge, lib.probe_attrs,
              lib.probe_cw_mode, lib.probe_stats):
        f.restype = i32
    minbs = [lib.probe_minb(v) for v in range(lib.probe_minb_count())]
    assert lib.probe_cw_count() == len(CW)
    assert lib.probe_gauge_count() == len(GAUGE)
    res = {"attrs": {}}
    buf = (ctypes.c_int * 3)()
    mb = [f"minb{b}" for b in minbs]
    subs = [(0, "cw", 0, CW), (1, "gauge", 0, GAUGE)]
    subs += [(2, f"cw_{m}", i, mb) for m, i in pk._MODES.items()]
    subs += [(3, f"stats_{k}", i, mb) for k, i in pk._STATS_KINDS.items()]
    for which, label, sub, names in subs:
        for v, name in enumerate(names):
            cuda_build.check(lib.probe_attrs(which, sub, v, buf), name)
            res["attrs"][f"{label}:{name}"] = dict(regs=buf[0], spill=buf[1],
                                                   blocks=buf[2])
    layout, sel, start, geo, _lmax, _win, _q = matrix_inputs()
    key_s, ts_s, _val, _tsid, _valid, ts_min, kp, off = layout
    S = sel.shape[0]
    rng = geo["range_ms"]
    t_last = start + geo["step_ms"] * (geo["num_steps"] - 1)
    for vname, val in (("uniform", layout[2]), ("counter", counters(layout))):
        lay = (*layout[:2], val, *layout[3:])
        for label, t0, T in (("T20", start, geo["num_steps"]),
                             ("T1", t_last, 1)):
            kw = dict(step_ms=geo["step_ms"], num_steps=T, range_ms=rng)
            args = (key_s.data_ptr(), ts_s.data_ptr(), val.data_ptr(),
                    key_s.shape[0], ts_min.data_ptr(), kp.data_ptr(),
                    sel.data_ptr(), S, T, t0, geo["step_ms"], rng,
                    off.data_ptr(), off.shape[0])
            rate = torch.empty((S, T), device=sel.device)
            gout = {k: torch.empty((S, T), device=sel.device,
                                   dtype=torch.int64 if k.endswith("_ts")
                                   else torch.float32) for k in GAUGE_KEYS}

            def cw(v, args=args, rate=rate):
                cuda_build.check(lib.probe_cw(
                    v, *args, 1, rng / 1000, rate.data_ptr(),
                    cuda_build.stream_ptr(sel)), CW[v])

            def gauge(v, args=args, gout=gout):
                cuda_build.check(lib.probe_gauge(
                    v, *args, *[gout[k].data_ptr() for k in GAUGE_KEYS],
                    cuda_build.stream_ptr(sel)), GAUGE[v])

            def port_cw(geometry, lay=lay, t0=t0, kw=kw):
                return pk.counter_window(lay, sel, t0, kind="rate",
                                         func="rate", range_s=rng / 1000,
                                         geometry=geometry, **kw)

            def port_gauge(geometry, lay=lay, t0=t0, kw=kw):
                return pk.window_stats(lay, sel, t0, kind="gauge_window",
                                       geometry=geometry, **kw)

            want = port_cw("range")
            errs = {}
            for v, name in enumerate(CW):
                if name.split("_")[0] in TIMING_ONLY:
                    continue
                cw(v)
                if "warpscan" in name:
                    d = (rate - want).abs() / want.abs().clamp(min=1)
                    err = float(torch.nan_to_num(d, 0.0).max())
                    assert err <= 1e-5 and torch.equal(
                        rate.isnan(), want.isnan()), (vname, label, name)
                    errs[name] = err
                else:
                    assert torch.equal(rate.nan_to_num(-7.0),
                                       want.nan_to_num(-7.0)), (
                        vname, label, name)
            gwant = port_gauge("range")
            for v, name in enumerate(GAUGE):
                if name.split("_")[0] in TIMING_ONLY:
                    continue
                gauge(v)
                for k in GAUGE_KEYS:
                    assert torch.equal(gout[k].nan_to_num(-7.0),
                                       gwant[k].nan_to_num(-7.0)), (
                        vname, label, name, k)
            del want, gwant
            times = {f"cw:{n}": [] for n in CW}
            times.update({f"gauge:{n}": [] for n in GAUGE})
            order = ([(f"cw:{n}", lambda v=v: cw(v)) for v, n in enumerate(CW)]
                     + [(f"gauge:{n}", lambda v=v: gauge(v))
                        for v, n in enumerate(GAUGE)])
            for name, fn in order + order[::-1]:
                times[name].append(graph_ms(fn))
            for g_ in ("range", "search"):
                times[f"kernel:cw_{g_}"] = [
                    graph_ms(lambda g_=g_: port_cw(g_)),
                    time_ms(lambda g_=g_: port_cw(g_))]
                times[f"kernel:gauge_{g_}"] = [
                    graph_ms(lambda g_=g_: port_gauge(g_)),
                    time_ms(lambda g_=g_: port_gauge(g_))]
            res[f"{vname}:{label}"] = dict(times=times, warpscan_err=errs)
        if vname == "counter":
            for T in (1, 2, 4, 8, 20):
                kw = dict(step_ms=geo["step_ms"], num_steps=T, range_ms=rng)
                args = (key_s.data_ptr(), ts_s.data_ptr(), val.data_ptr(),
                        key_s.shape[0], ts_min.data_ptr(), kp.data_ptr(),
                        sel.data_ptr(), S, T, start, geo["step_ms"], rng,
                        off.data_ptr(), off.shape[0])
                res[f"minb:T{T}"] = port_minb(lib, minbs, lay, sel, start,
                                              kw, args)
        del lay, val
    print("PROBE_BODIES " + json.dumps(res))


if __name__ == "__main__":
    main()
