"""Times layouts of the series->group merge on the card: the variants of
``probe_group_merge.cu`` (the parent's thread an output, the port's loop
unrolled by 4 with 64-bit and with 32-bit indices and with a launch
bound of 8 blocks a multiprocessor, 8 series loaded at once, a warp a
group) and the port's own ``group_merge``, at the SQL grid
path's shape ([10, 4096, 24] into 4,096 groups, ~5 % overflow ids) and
PromQL's ([2^20, 20] into 100,000 groups of 10), as ``time_scans.py
grid`` makes them.  Each variant is first held equal bit for bit to
``group_merge``, then timed as device time alone: 20 calls captured in
one CUDA graph, the median of 10 replays.  The variants run in the order
given, then again in reverse, and both times are kept.

Prints one line, ``PROBE_MERGE {json}`` (ms a call).

Run from the root of a checkout: ``python3 probe_group_merge.py``.  It
builds ``probe_group_merge.cu`` with nvcc into ``build/probe/``."""
import ctypes
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")
from greptimedb_tpu_torch.ops import cuda_build  # noqa: E402
from greptimedb_tpu_torch.ops import grid_kernels as gk  # noqa: E402

VARIANTS = ["parent", "unroll4", "unroll4_i32", "batch8", "warp_group",
            "unroll4_occ8"]
HERE = Path(__file__).resolve().parent


def graph_ms(fn, reps=20):
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


def main():
    dev = torch.device("cuda")
    lib_path = cuda_build.build_many([(
        HERE / "probe_group_merge.cu",
        HERE / "build" / "probe" / "libprobe_group_merge.so",
        cuda_build.BASE_FLAGS)])[0]
    lib = ctypes.CDLL(str(lib_path))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_merge.argtypes = [i32, vp, ll, ll, vp, vp, vp, i32, i32, i32,
                                vp]
    lib.probe_merge.restype = i32
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    res = {}
    s, ngt, nb = 4096, 4096, 24
    x = torch.rand((10, s, nb), generator=gen, device=dev) * 1000
    ids = torch.randint(0, ngt, (s,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.rand(s, generator=gen, device=dev) < 0.05] = ngt
    sp, pods = 1 << 20, 100_000
    xp = torch.rand((1, sp, 20), generator=gen, device=dev) * 10
    idp = torch.arange(sp, device=dev, dtype=torch.int32) // 10
    idp = torch.where(idp < pods, idp, pods).to(torch.int32)
    for shape, xs, idv, n in (("tsbs", x, ids, ngt), ("prom", xp, idp, pods)):
        lay = gk.group_layout(idv, n)
        want = gk.group_merge(xs, lay, "sum")
        out = torch.empty_like(want)
        p, _, w = xs.shape

        def call(v, xs=xs, lay=lay, out=out, p=p, w=w, n=n):
            cuda_build.check(lib.probe_merge(
                v, xs.data_ptr(), xs.stride(0), xs.stride(1),
                lay.order.data_ptr(), lay.offsets.data_ptr(), out.data_ptr(),
                p, n, w, cuda_build.stream_ptr(xs)), VARIANTS[v])

        for v, name in enumerate(VARIANTS):
            out.fill_(float("nan"))
            call(v)
            torch.cuda.synchronize()
            assert torch.equal(out, want), (shape, name)
        order = list(enumerate(VARIANTS))
        for v, name in order + order[::-1]:
            res.setdefault(f"{shape} {name}", []).append(
                graph_ms(lambda v=v: call(v)))
        res[f"{shape} port"] = graph_ms(
            lambda xs=xs, lay=lay: gk.group_merge(xs, lay, "sum"))
    print("PROBE_MERGE " + json.dumps(res))


if __name__ == "__main__":
    main()
