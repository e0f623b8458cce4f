"""Times K14's register routes against their staged variants on the card
(``probes/window_matrix.cu``: the warp's span of the sort layout, or the
block's rows of the dense matrix, copied into shared memory first) at
PromQL's main-path shapes, as ``time_scans.py matrix`` makes them:
``window_matrix`` quantile and mad over the ``[2^20, 20]`` 5 m windows of
2^20 series x 40 scrapes (lmax 32), ``window_matrix_dense`` quantile and
mad over a seeded ``[2^20, 20, 6]`` matrix.  Each variant is first held
equal to the port's route bit for bit, then timed as device time alone
(20 calls captured in one CUDA graph, the median of 10 replays): port,
staged, staged, port.

Prints one line, ``PROBE_MATRIX {json}`` (ms a call).

Run from the root of a checkout: ``python3 probes/window_matrix.py``.  It
builds ``probes/window_matrix.cu`` (which compiles in
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
        HERE / "window_matrix.cu",
        HERE / "build" / "libprobe_window_matrix.so",
        pk.NVCC_FLAGS)], force=True)[0]
    lib = ctypes.CDLL(str(lib_path))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_matrix_staged.argtypes = [vp, vp, ll, vp, vp, vp, ll, ll, ll,
                                        ll, ll, vp, ll, i32, i32, vp, vp, vp]
    lib.probe_dense_staged.argtypes = [vp, ll, ll, ll, i32, i32, vp, vp, vp]
    lib.probe_matrix_staged.restype = lib.probe_dense_staged.restype = i32
    layout, sel, start, geo, lmax, win, q = matrix_inputs()
    key_s, _ts_s, val_s, _tsid, _valid, ts_min, kp, off = layout
    S, T = sel.shape[0], geo["num_steps"]
    res = {"lmax": lmax}
    for kind in ("quantile", "mad"):
        out = torch.empty((S, T), device=q.device)
        mode = pk._MATRIX_MODES[kind]
        port_m = (lambda kind=kind: pk.window_matrix(
            layout, sel, start, lmax=lmax, kind=kind, a1=q, **geo))

        def staged_m(out=out, mode=mode):
            cuda_build.check(lib.probe_matrix_staged(
                key_s.data_ptr(), val_s.data_ptr(), key_s.shape[0],
                ts_min.data_ptr(), kp.data_ptr(), sel.data_ptr(), S, T,
                start, geo["step_ms"], geo["range_ms"], off.data_ptr(),
                off.shape[0], lmax, mode,
                q.data_ptr(), out.data_ptr(), cuda_build.stream_ptr(q)),
                "matrix_staged")
            return out

        W, K = win.shape[0] * win.shape[1], win.shape[2]
        L = 1 << max(K - 1, 1).bit_length()
        out_d = torch.empty(win.shape[:2], device=q.device)
        port_d = (lambda kind=kind: pk.window_matrix_dense(win, kind, q))

        def staged_d(out=out_d, mode=mode):
            cuda_build.check(lib.probe_dense_staged(
                win.data_ptr(), W, K, T, L, mode, q.data_ptr(),
                out.data_ptr(), cuda_build.stream_ptr(q)), "dense_staged")
            return out

        for name, port, staged in (("matrix", port_m, staged_m),
                                   ("dense", port_d, staged_d)):
            want = port()
            got = staged()
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (name, kind)
            times = {"port": [], "staged": []}
            for v in ("port", "staged", "staged", "port"):
                times[v].append(graph_ms(port if v == "port" else staged))
            res[f"{name} {kind}"] = times
    print("PROBE_MATRIX " + json.dumps(res))


if __name__ == "__main__":
    main()
