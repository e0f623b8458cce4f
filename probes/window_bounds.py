"""Times variants of the window kernels' range geometry on the card,
each one thread a window writing its window's count (the bounds and one
coalesced 4-byte store; ``window_count_max``'s one atomicMax a warp on a
single word would time the atomics): ``port`` (``window_bounds`` itself:
its searches over its series' rows in device memory, through L1),
``warp`` (each warp stages the span of keys its 32 windows' series cover
in shared memory, 12 KB a warp, then searches there), ``block1k`` /
``block12k`` (one span a block of 256 windows, at most 1,024 / 12,288
keys staged), ``i32`` (the port's searches in 32-bit index arithmetic)
and ``search`` (``window_bounds`` without the table: the whole-layout
search).  ``probes/window_bounds.cu`` holds the variants.

Inputs: ``time_scans.py``'s ``matrix_inputs`` (a sort layout of 2^20
series x 40 scrapes at 15 s with its series offset table, every series
selected), at [2^20, 20] windows of 5 m and at T = 1.  Each variant's
bounds and counts are first held equal to ``window_bounds_plain``
exactly; then each one's device time (``graph_ms``: 20 calls in one CUDA
graph), in turns forward and back.

Prints one line, ``PROBE_BOUNDS {json}`` (ms a call).

Run from the root of a checkout: ``python3 probes/window_bounds.py``.  It
builds ``probes/window_bounds.cu`` (which compiles in
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
from time_scans import graph_ms, matrix_inputs  # noqa: E402

HERE = Path(__file__).resolve().parent


def main():
    lib_path = cuda_build.build_many([(
        HERE / "window_bounds.cu",
        HERE / "build" / "libprobe_window_bounds.so",
        pk.NVCC_FLAGS)], force=True)[0]
    lib = ctypes.CDLL(str(lib_path))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_bounds_staged.argtypes = [vp, ll, vp, vp, vp, ll, ll, ll, ll,
                                        ll, vp, ll, i32, vp, vp, vp, vp]
    lib.probe_bounds_variant.argtypes = [i32, vp, ll, vp, vp, vp, ll, ll,
                                         ll, ll, ll, vp, ll, i32, ll, vp, vp,
                                         vp, vp]
    lib.probe_bounds_staged.restype = i32
    lib.probe_bounds_variant.restype = i32
    layout, sel, start, geo, _lmax, _win, _q = matrix_inputs()
    key_s, ts_min, kp, off = layout[0], layout[5], layout[6], layout[7]
    S = sel.shape[0]
    res = {}
    t_last = start + geo["step_ms"] * (geo["num_steps"] - 1)
    for label, t0, T in (("T20", start, geo["num_steps"]), ("T1", t_last, 1)):
        args = (key_s.data_ptr(), key_s.shape[0], ts_min.data_ptr(),
                kp.data_ptr(), sel.data_ptr(), S, T, t0, geo["step_ms"],
                geo["range_ms"])
        table = (off.data_ptr(), off.shape[0])
        cnt = torch.empty((S, T), dtype=torch.int32, device=sel.device)

        def variant(name, mode, lo=None, hi=None, args=args, cnt=cnt):
            # the current stream at call time: a graph capture's own
            out = (lo, hi, cnt.data_ptr(), cuda_build.stream_ptr(sel))
            if name == "warp":
                rc = lib.probe_bounds_staged(*args, *table, mode, *out)
            else:
                v, cap = {"port": (0, 0), "search": (0, 0),
                          "block1k": (1, 1024), "block12k": (1, 12288),
                          "i32": (2, 0)}[name]
                geo_t = (None, 0) if name == "search" else table
                rc = lib.probe_bounds_variant(v, *args, *geo_t, mode, cap,
                                              *out)
            cuda_build.check(rc, name)

        want = pk.window_bounds_plain(key_s, ts_min, kp, sel, t0,
                                      geo["step_ms"], T, geo["range_ms"])
        want_cnt = torch.where(want[4][:, None], want[2], 0)
        names = ("port", "warp", "block1k", "block12k", "i32", "search")
        for name in names:
            lo = torch.empty((S, T), dtype=torch.int64, device=sel.device)
            hi = torch.empty_like(lo)
            variant(name, 0, lo.data_ptr(), hi.data_ptr())
            assert torch.equal(lo, want[0]) and torch.equal(hi, want[1]), (
                label, name)
            variant(name, 1)
            assert torch.equal(cnt, want_cnt), (label, name)
        del want, want_cnt, lo, hi
        times = {name: [] for name in names}
        for name in names[:-1] + names[::-1]:
            times[name].append(graph_ms(lambda name=name: variant(name, 1)))
        res[label] = times
    print("PROBE_BOUNDS " + json.dumps(res))


if __name__ == "__main__":
    main()
