"""Port parity: ops/segment.py and ops/masks.py against the JAX reference.

The same inputs, made with numpy from a seed, go through the reference
(``greptimedb_tpu.ops.segment`` / ``.masks``) and the port on the CPU,
where every function runs the plain versions of the row-path kernels
(``ops/segment_kernels.py``).  Inputs are fuzzed: poisoned ``-1`` and
out-of-range segment ids, NaNs, empty segments, all-invalid input, one
segment, int64 values near +-2^62, tied extreme timestamps, -0.0 beside
0.0.  Integers, counts, keys, masks, min/max and first/last must be equal
exactly; float sums and means within the golden comparer's bound
``|a-b| <= 1e-5*max(1,|b|)`` (tests/test_golden.py).  The ``cuda``-marked
cases hold each kernel against its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import masks as ref_masks
from greptimedb_tpu.ops import segment as ref_seg
from greptimedb_tpu_torch.ops import masks as port_masks
from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops import segment as port_seg
from greptimedb_tpu_torch.ops import segment_kernels as sk

N = 257
SEEDS = range(4)
REL = 1e-5


def _data(seed, ns, dtype="f32", n=N, poison=True, nan=True,
          all_invalid=False):
    """(values, ids, mask) as numpy: ids sometimes -1 or >= ns, a random
    mask, NaNs in float values, segment ns - 1 often empty."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(ns - 1, 1), n).astype(np.int32)
    if poison:
        ids[rng.random(n) < 0.1] = -1
        ids[rng.random(n) < 0.05] = ns + rng.integers(0, 3)
    if dtype == "f32":
        v = (rng.normal(0, 50, n)).astype(np.float32)
        if nan:
            v[rng.random(n) < 0.1] = np.nan
    elif dtype == "i64":
        v = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        v[:3] = [(1 << 62) - 1, -(1 << 62), 0]
    else:
        v = rng.integers(-1000, 1000, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    if all_invalid:
        mask[:] = False
    return v, ids, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _same(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
        return
    assert (np.isnan(got) == np.isnan(want)).all()
    ok = ~np.isnan(want)
    diff = np.abs(got[ok].astype(np.float64) - want[ok])
    assert (diff <= REL * np.maximum(1.0, np.abs(want[ok]))).all(), diff.max()


def _cases():
    out = []
    for seed in SEEDS:
        for ns in (1, 7, 40):
            for dtype in ("f32", "i64", "i32"):
                out.append((seed, ns, dtype))
    return out


@pytest.mark.parametrize("op", ["count", "sum", "mean", "min", "max"])
@pytest.mark.parametrize("seed,ns,dtype", _cases())
def test_segment_reduce_matches_reference(seed, ns, dtype, op):
    v, ids, mask = _data(seed, ns, dtype)
    use_mask = seed % 2 == 0
    want = ref_seg.segment_reduce(_j(v), _j(ids), ns, op,
                                  _j(mask) if use_mask else None)
    got = port_seg.segment_reduce(_t(v), _t(ids), ns, op,
                                  _t(mask) if use_mask else None)
    assert got.numpy().dtype == np.asarray(want).dtype
    _same(got, want, exact=op in ("count", "min", "max") or dtype != "f32")


@pytest.mark.parametrize("op", ["count", "sum", "mean", "min", "max"])
@pytest.mark.parametrize("dtype", ["f32", "i64"])
def test_segment_reduce_all_invalid_and_int64_ids(op, dtype):
    v, ids, mask = _data(5, 9, dtype, all_invalid=True)
    want = ref_seg.segment_reduce(_j(v), _j(ids), 9, op, _j(mask))
    got = port_seg.segment_reduce(_t(v), _t(ids), 9, op, _t(mask))
    _same(got, want, exact=True)
    # int64 ids beyond int32 must not wrap into range
    ids64 = ids.astype(np.int64)
    ids64[::5] = (1 << 32) + 2
    want = ref_seg.segment_reduce(_j(v), _j(ids64), 9, op)
    got = port_seg.segment_reduce(_t(v), _t(ids64), 9, op)
    _same(got, want, exact=op != "mean" and dtype != "f32" or op in (
        "count", "min", "max"))


@pytest.mark.parametrize("seed", SEEDS)
def test_segment_mean_and_count(seed):
    v, ids, mask = _data(seed, 11, "i32")
    _same(port_seg.segment_mean(_t(v), _t(ids), 11, _t(mask)),
          ref_seg.segment_mean(_j(v), _j(ids), 11, _j(mask)), exact=False)
    _same(port_seg.segment_count(_t(v), _t(ids), 11),
          ref_seg.segment_count(_j(v), _j(ids), 11), exact=True)


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("seed,ns,dtype", [c for c in _cases()
                                           if c[2] != "i32"])
def test_segment_first_last_ties(seed, ns, dtype, last):
    v, ids, mask = _data(seed, ns, dtype)
    rng = np.random.default_rng(seed + 100)
    # few distinct timestamps: the extreme ts ties inside most segments
    ts = (1_451_606_400_000 + rng.integers(0, 4, N) * 10_000).astype(
        np.int64)
    want = ref_seg.segment_first_last(_j(ts), _j(v), _j(ids), ns, _j(mask),
                                      last=last)
    got = port_seg.segment_first_last(_t(ts), _t(v), _t(ids), ns, _t(mask),
                                      last=last)
    _same(got[0], want[0], exact=True)
    _same(got[1], want[1], exact=True)
    assert got[1].dtype == _t(v).dtype


@pytest.mark.parametrize("seed,ns,dtype", _cases())
def test_segment_distinct_count(seed, ns, dtype):
    v, ids, mask = _data(seed, ns, dtype)
    rng = np.random.default_rng(seed + 7)
    if dtype == "f32":
        # few distinct values, -0.0 beside 0.0 (one value to SQL)
        v = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.nan, 7.0],
                                dtype=np.float32), N)
    else:
        v = (v % 13).astype(v.dtype)
    want = ref_seg.segment_distinct_count(_j(v), _j(ids), ns, _j(mask))
    got = port_seg.segment_distinct_count(_t(v), _t(ids), ns, _t(mask))
    _same(got, want, exact=True)


def _sorted_data(seed, ns, dtype, wide=0):
    """Nondecreasing ids (empty segments included) with trailing padding
    rows poisoned to -1, as the resident table's sorted-path ids are."""
    rng = np.random.default_rng(seed)
    live = N - 20
    ids = np.sort(rng.integers(0, ns, live)).astype(np.int32)
    ids = np.concatenate([ids, np.full(N - live, -1, np.int32)])
    if dtype == "f32":
        shape = (N, wide) if wide else (N,)
        v = rng.normal(0, 100, shape).astype(np.float32)
        v[rng.random(shape) < 0.1] = np.nan
    else:
        v = rng.integers(-(1 << 62), 1 << 62, N, dtype=np.int64)
    mask = rng.random(N) < 0.85
    mask[live:] = False
    return v, ids, mask


@pytest.mark.parametrize("op", ["count", "sum", "mean", "min", "max"])
@pytest.mark.parametrize("seed,ns,dtype", [(s, ns, d) for s in SEEDS
                                           for ns in (1, 5, 64)
                                           for d in ("f32", "i64")])
def test_sorted_segment_reduce_matches_reference(seed, ns, dtype, op):
    v, ids, mask = _sorted_data(seed, ns, dtype)
    want = ref_seg.sorted_segment_reduce(_j(v), _j(ids), ns, op, _j(mask))
    got = port_seg.sorted_segment_reduce(_t(v), _t(ids), ns, op, _t(mask))
    _same(got, want, exact=op in ("count", "min", "max") or dtype == "i64")
    # the scatter path agrees on the same data
    got_scatter = port_seg.segment_reduce(_t(v), _t(ids), ns, op, _t(mask))
    _same(got, got_scatter.numpy(), exact=op != "sum" and op != "mean"
          or dtype == "i64")


@pytest.mark.parametrize("wide", [0, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_segmented_sum_scan(seed, wide):
    ns = 9
    v, ids, mask = _sorted_data(seed, ns, "f32", wide)
    m = mask[:, None] & ~np.isnan(v) if wide else mask & ~np.isnan(v)
    vz = np.where(m, v, 0).astype(np.float32)
    ids_r = np.where(ids < 0, ns, ids).astype(np.int32)
    grid = np.arange(ns, dtype=np.int32)
    starts = np.searchsorted(ids_r, grid, "left")
    ends = np.searchsorted(ids_r, grid, "right")
    want = ref_seg.segmented_sum_scan(_j(vz), _j(ids_r), _j(starts),
                                      _j(ends))
    # the port's sorted kernel computes the reference's range sums itself
    got, _cnt = sk.sorted_segment_reduce(_t(vz), _t(ids_r), ns, "sum")
    _same(got, want, exact=False)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num_groups", [N, 5])
def test_compact_groups(seed, num_groups):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 12, N).astype(np.int64) * 1000 - 3
    keys[rng.random(N) < 0.1] = -1
    mask = rng.random(N) < 0.8
    want = ref_seg.compact_groups(_j(keys), _j(mask), num_groups)
    got = port_seg.compact_groups(_t(keys), _t(mask), num_groups)
    for g, w in zip(got, want):
        _same(g, w, exact=True)
    assert got[0].dtype == torch.int32


def test_compact_groups_all_invalid():
    keys = np.arange(N, dtype=np.int64)
    mask = np.zeros(N, bool)
    want = ref_seg.compact_groups(_j(keys), _j(mask), N)
    got = port_seg.compact_groups(_t(keys), _t(mask), N)
    for g, w in zip(got, want):
        _same(g, w, exact=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_masks(seed):
    v, _ids, mask = _data(seed, 3, "f32")
    _same(port_masks.valid_mask(_t(v), _t(mask)),
          ref_masks.valid_mask(_j(v), _j(mask)), exact=True)
    for op in ("count", "sum", "min", "max", "mean"):
        _same(port_masks.masked_reduce(_t(v), _t(mask), op),
              ref_masks.masked_reduce(_j(v), _j(mask), op),
              exact=op not in ("sum", "mean"))
    cols = {"v": v, "i": np.arange(N, dtype=np.int64),
            "c": (np.arange(N) % 7).astype(np.int32)}
    want, wmask = ref_masks.compact_rows({k: _j(a) for k, a in cols.items()},
                                         _j(mask))
    got, n = port_masks.compact_rows({k: _t(a) for k, a in cols.items()},
                                     _t(mask))
    # the reference keeps the shape: its first n rows are the kept ones
    assert n == int(mask.sum())
    _same(np.asarray(wmask)[:n], np.ones(n, bool), exact=True)
    assert not np.asarray(wmask)[n:].any()
    for k in cols:
        _same(got[k], np.asarray(want[k])[:n], exact=True)


def _compact_columns(rng, n, ncols=7):
    """Columns of every element width compact takes: 1 (uint8, bool), 2
    (int16, float16), 4 (float32, int32) and 8 bytes (int64, float64),
    cycled to ``ncols`` columns, NaN and -0.0 among the floats."""
    kinds = [np.uint8, np.int16, np.float32, np.int64, bool, np.float16,
             np.int32, np.float64]
    cols = {}
    for j in range(ncols):
        kind = kinds[j % len(kinds)]
        if kind is bool:
            a = rng.random(n) < 0.5
        elif np.issubdtype(kind, np.floating):
            a = rng.normal(size=n).astype(kind)
            a[rng.random(n) < 0.05] = np.nan
            a[rng.random(n) < 0.05] = -0.0
        else:
            info = np.iinfo(kind)
            a = rng.integers(info.min, info.max, n, dtype=kind,
                             endpoint=True)
        cols[f"c{j}"] = a
    return cols


def test_compact_layout_aligns_every_column():
    rng = np.random.default_rng(0)
    cols = [_t(a) for a in _compact_columns(rng, 5, 16).values()]
    widths = [c.element_size() for c in cols]
    placed, offsets = sk.compact_layout(widths)
    assert sorted(placed) == list(range(len(widths)))
    assert [widths[j] for j in placed] == sorted(widths, reverse=True)
    at = 0
    for j in placed:
        assert offsets[j] == at
        assert at % widths[j] == 0  # so kept * at is too, for any kept
        at += widths[j]
    assert sk.compact_layout([]) == ([], [])


@pytest.mark.parametrize("n,blocks", [
    (0, 1), (1, 1), (16_384, 1), (16_385, 2), (3_000_017, 184),
    (35_651_584, sk.COMPACT_BLOCKS)])
def test_compact_spans_cover_the_rows(n, blocks):
    """Every row lies in exactly one span, spans start on 16-byte mask
    loads, and no block has less than a step of rows where there are rows
    enough."""
    got, span = sk.compact_spans(n)
    assert got == blocks
    assert span % 16 == 0 and span >= 16
    assert (blocks - 1) * span < max(n, 1) <= blocks * span
    if n >= blocks * sk.COMPACT_STEP:
        assert span >= sk.COMPACT_STEP
    assert sk.compact_scratch_bytes(blocks, 12) == 8 * (blocks + 36)


def test_radix_argsort_plain_orders_floats_and_invalid_rows():
    v = np.array([3.0, -0.0, np.nan, 0.0, -1.5, 3.0, -np.inf, 2.0],
                 dtype=np.float32)
    valid = ~np.isnan(v)
    valid[7] = False
    order = sk.radix_argsort(_t(v), _t(valid)).numpy()
    # stable: -0.0 and 0.0 tie, as do the two 3.0s; invalid rows last
    assert order.tolist() == [6, 4, 1, 3, 0, 5, 2, 7]
    assert order.dtype == np.int32


# radix_argsort's plan: the key width and the 8-bit digit passes
@pytest.mark.parametrize("bits,wide,shifts", [
    (0, False, [0]), (1, False, [0]), (8, False, [0]), (9, False, [0, 8]),
    (13, False, [0, 8]), (32, False, [0, 8, 16, 24]),
    (33, True, [0, 8, 16, 24, 32]), (40, True, [0, 8, 16, 24, 32]),
    (64, True, [0, 8, 16, 24, 32, 40, 48, 56])])
def test_radix_digit_plan(bits, wide, shifts):
    assert cuda_build.radix_digits(bits) == (wide, shifts)


@pytest.mark.parametrize("bits", [-1, 65])
def test_radix_digit_plan_rejects_widths(bits):
    with pytest.raises(ValueError, match="radix_digits"):
        cuda_build.radix_digits(bits)


@pytest.mark.parametrize("lo,hi,any_valid,want", [
    (0, 9, True, (10, False, 4)),                  # decile keys
    (0, 4095, True, (4096, False, 13)),            # hostname codes
    (7, 7, True, (1, False, 1)),                   # one key value
    (sk.I64_MAX, sk.I64_MIN, False, (1, False, 1)),  # no valid row
    (-5, (1 << 32) - 7, True, ((1 << 32) - 1, False, 32)),
    (-5, (1 << 32) - 6, True, (1 << 32, False, 33)),
    (sk.I64_MIN, sk.I64_MAX - 1, True, ((1 << 64) - 1, False, 64)),
    (sk.I64_MIN, sk.I64_MAX, True, (0, True, 64)),  # all 2^64 values
])
def test_argsort_bits(lo, hi, any_valid, want):
    assert sk.argsort_bits(lo, hi, any_valid) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_argsort_bits_hold_every_relative_key(seed):
    """Every valid relative key lies below the invalid rows' key, and that
    key below 2^bits, so the digit passes see every bit that differs."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        width = int(rng.integers(1, 63))
        lo = int(rng.integers(-(1 << 62), 1 << 62))
        keys = lo + rng.integers(0, 1 << width, 64, dtype=np.int64)
        inv, full, bits = sk.argsort_bits(int(keys.min()), int(keys.max()),
                                          True)
        rel = [k - int(keys.min()) for k in keys.tolist()]
        assert not full and max(rel) < inv < 1 << bits
        assert bits == 1 or inv >= 1 << (bits - 1)


@pytest.mark.parametrize("n", [0, 1, 4096, 4097])
def test_scan_and_radix_scratch_sizes(n):
    tiles = max(1, -(-n // 4096))
    assert cuda_build.scan_scratch(n, torch.float64, "cpu").numel() == (
        tiles * 20 + 4)
    assert cuda_build.scan_scratch(n, torch.float32, "cpu").numel() == (
        tiles * 12 + 4)
    for dtype in (torch.int32, torch.int64):
        assert cuda_build.scan_scratch(n, dtype, "cpu").numel() == (
            tiles * 8 + 4)
    assert cuda_build.radix_status(n, "cpu").numel() == 1 + tiles * 256


# ---------------------------------------------------------------------------
# segment_reduce's mask-first loads, emulated
# ---------------------------------------------------------------------------
#
# On the card a warp reads its chunk's 1,024 mask bytes first (lane l: the
# 32 bytes of rows w0 + 32 l .. + 31 as a 32-bit word, the nonzero bytes
# found by shifts within each 32-bit word), then loads the id and values
# of a row only where its bit is set, and skips a step of 32 rows whose
# word is 0.  The emulation below follows that on torch tensors, with the
# ids and values of every unset row poisoned, and must give the plain
# reduction.

WARP_ROWS = 1024  # csrc kWarpRows: 32 steps of 32 rows


def _nonzero_bits(words):
    """The kernel's nonzero_bits16 on int64-held uint32 words: bit b of
    each word's 4-bit result set when byte b is nonzero."""
    t = words | (words >> 4)
    t = t | (t >> 2)
    t = t | (t >> 1)
    t = t & 0x01010101
    return (t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xF


def _chunk_words(mask, w0, b1):
    """chunk_mask_word for lanes 0..31 of the warp chunk at row w0 (rows
    at or past b1 unset; every row below it set without a mask)."""
    rows = w0 + torch.arange(WARP_ROWS).reshape(32, 32)
    inside = rows < b1
    if mask is None:
        live = inside
    else:
        padded = torch.zeros(b1 + WARP_ROWS, dtype=torch.uint8)
        padded[:b1] = mask[:b1].view(torch.uint8)
        by = padded[rows.clamp(max=b1 + WARP_ROWS - 1)].to(torch.int64)
        # four bytes a 32-bit word, as the uint4 loads see them
        words = (by.reshape(32, 8, 4) << torch.tensor([0, 8, 16, 24])).sum(-1)
        nib = _nonzero_bits(words)  # [32 lanes, 8 words]
        live = ((nib[:, :, None] >> torch.arange(4)) & 1).reshape(32, 32)
        live = live.bool() & inside
    return (live.to(torch.int64) << torch.arange(32)).sum(1)


def _warp_chunks(b0, b1, warps):
    """(first row, end) of each warp chunk of a block's rows [b0, b1): in
    turn, 1,024 rows each (``warps`` None: a privatised block), or over
    one contiguous span a warp, whole steps of 32 rows (a block flushing
    to device memory, ``warps`` warps)."""
    if warps is None:
        return [(w0, b1) for w0 in range(b0, b1, WARP_ROWS)]
    per = -(-(b1 - b0) // warps)
    per = -(-per // 32) * 32
    out = []
    for w in range(warps):
        first, end = b0 + w * per, min(b0 + (w + 1) * per, b1)
        out += [(w0, end) for w0 in range(first, end, WARP_ROWS)]
    return out


def _emulated_loads(mask, n, blocks, warps=None):
    """Rows whose id and values the kernel loads, the steps skipped and
    the steps in all, over ``blocks`` spans as launch_reduce_mode cuts
    them and the warp chunks of each (``_warp_chunks``)."""
    span = -(-n // blocks)
    span = -(-span // WARP_ROWS) * WARP_ROWS
    loaded = torch.zeros(n, dtype=torch.bool)
    skipped = steps = 0
    for b0 in range(0, n, span):
        b1 = min(b0 + span, n)
        for w0, end in _warp_chunks(b0, b1, warps):
            words = _chunk_words(mask, w0, end)
            steps += 32
            for j in range(32):  # step j: lane l takes row w0 + 32 j + l
                sw = int(words[j])
                if sw == 0:
                    skipped += 1
                    continue
                for lane in range(32):
                    if (sw >> lane) & 1:
                        loaded[w0 + 32 * j + lane] = True
    return loaded, skipped, steps


def test_nonzero_bits_of_any_bytes():
    rng = np.random.default_rng(3)
    by = rng.integers(0, 256, (500, 4))
    by[rng.random((500, 4)) < 0.5] = 0
    words = torch.from_numpy((by << np.array([0, 8, 16, 24])).sum(1))
    want = ((by != 0) << np.arange(4)).sum(1)
    assert _nonzero_bits(words).tolist() == want.tolist()


@pytest.mark.parametrize("warps", [None, 8])
@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("kind", ["runs", "scattered", "all_dead", "none",
                                  "bytes"])
def test_segment_reduce_mask_first_emulation(kind, blocks, warps):
    """Rows loaded = rows with the mask set; whole dead steps skipped; the
    reduction over the loaded rows alone equals the plain one, for runs
    of live rows, scattered rows, no live row, no mask, and mask bytes
    other than 0 and 1 (the kernel tests bytes for nonzero); with the
    chunks of a privatised block and the warp spans of a block that
    flushes to device memory."""
    rng = np.random.default_rng(blocks)
    n, ns = 5 * WARP_ROWS + 333, 37  # a ragged last chunk
    if kind == "runs":
        mask = torch.from_numpy((rng.random(-(-n // 97)) < 0.3)
                                .repeat(97)[:n])
    elif kind in ("scattered", "bytes"):
        mask = torch.from_numpy(rng.random(n) < 0.1)
    elif kind == "all_dead":
        mask = torch.zeros(n, dtype=torch.bool)
    else:
        mask = None
    kmask = mask
    if kind == "bytes":  # a bool tensor's bytes as another writer left them
        kmask = torch.from_numpy(mask.numpy().astype(np.uint8)
                                 * rng.integers(1, 256, n).astype(np.uint8)
                                 ).view(torch.bool)
    loaded, skipped, steps = _emulated_loads(kmask, n, blocks, warps)
    live = torch.ones(n, dtype=torch.bool) if mask is None else mask
    assert torch.equal(loaded, live)
    # a step is skipped exactly when none of its 32 rows is live (a warp
    # span is whole steps, so steps stay the table's 32-row groups)
    assert skipped >= steps - -(-n // 32)
    if kind == "all_dead":
        assert skipped == steps
    if kind == "none":
        assert skipped == steps - -(-n // 32)
    ids = torch.from_numpy(np.sort(rng.integers(-1, ns + 1, n))
                           .astype(np.int32))
    vals = torch.from_numpy(rng.normal(0, 50, (n, 3)).astype(np.float32))
    want = sk.segment_reduce_plain(vals, ids, ns, "sum", mask)
    # what the kernel reads: poison every row it does not load
    pids = torch.where(loaded, ids, 0)
    pvals = torch.where(loaded[:, None], vals, float("inf"))
    got = sk.segment_reduce_plain(pvals[loaded], pids[loaded], ns, "sum")
    assert torch.equal(got[1], want[1])
    assert torch.allclose(got[0], want[0], rtol=1e-6, atol=1e-4)


def test_segment_reduce_shape_labels():
    """Launches by shape name the value type, op, columns, segments and a
    row-count bucket."""
    assert [sk.rows_bucket(n) for n in (1, 65_535, 65_536, 1 << 20)] == [
        "N<64K", "N<64K", "N<1M", "N>=1M"]


# ---------------------------------------------------------------------------
# the kernels against their plain versions, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, exact):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact or not got.is_floating_point():
        assert torch.equal(got, want)
    else:
        g, w = got.double(), want.double()
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(g), fin)
        assert torch.equal(g[~fin], w[~fin])
        assert bool(((g[fin] - w[fin]).abs()
                     <= REL * w[fin].abs().clamp(min=1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,ns", [(1, 1), (5000, 1), (100_003, 37),
                                  (300_000, 70_000)])
def test_cuda_segment_kernels_match_plain(cuda_device, n, ns):
    rng = np.random.default_rng(n)
    ids_sorted = np.sort(rng.integers(-1, ns + 1, n)).astype(np.int32)
    ids_rand = rng.integers(-2, ns + 2, n).astype(np.int32)
    mask = _t(rng.random(n) < 0.9)
    # non-negative, like the metrics the row path sums: a relative bound on
    # an f32 sum of mean-zero values would measure cancellation, which both
    # summation orders suffer alike
    f32 = rng.uniform(0, 100, (n, 10)).astype(np.float32)
    f32[rng.random((n, 10)) < 0.05] = np.nan
    i64 = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    wide = np.concatenate([f32, f32[:, ::-1] * 2], axis=1)  # 20 columns

    def on_card(a):
        if isinstance(a, list):
            return [c.to(cuda_device) for c in a]
        return a.to(cuda_device) if isinstance(a, torch.Tensor) else a

    # signed values with -0.0, +0.0 and +-inf for min and max (exact
    # checks): they take the sign-flip branches of the ordered atomic keys
    signed = rng.normal(0, 50, n).astype(np.float32)
    special = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan], np.float32)
    pick = rng.random(n) < 0.2
    signed[pick] = rng.choice(special, int(pick.sum()))
    cases = ((_t(f32[:, 0]), False), (_t(f32), False), (_t(wide), False),
             ([_t(f32[:, c].copy()) for c in range(10)], False),
             (_t(i64), True), (_t(f32[:, 0].astype(np.float64)), False),
             (None, True))
    minmax = (_t(signed), _t(signed.astype(np.float64)),
              _t(np.stack([signed, -signed], axis=1)))
    for ids in (ids_sorted, ids_rand):
        for v in minmax:
            for op in ("min", "max"):
                args = [v, _t(ids), ns, op, mask]
                want = sk.segment_reduce(*args)
                got = sk.segment_reduce(*(on_card(a) for a in args))
                _close(got[1], want[1], exact=True)
                _close(got[0], want[0], exact=True)
        for v, exact_sum in cases:
            for op in ("sum", "min", "max"):
                args = [v, _t(ids), ns, op, mask]
                want = sk.segment_reduce(*args)
                got = sk.segment_reduce(*(on_card(a) for a in args))
                _close(got[1], want[1], exact=True)
                if v is not None:
                    _close(got[0], want[0], exact=op != "sum" or exact_sum)
    # sorted: ids routed as the callers route them (padding past the end)
    ids_s = np.where((ids_sorted < 0) | (ids_sorted >= ns), ns,
                     ids_sorted).astype(np.int32)
    ids_s = np.sort(ids_s)
    for v in minmax:
        for op in ("min", "max"):
            args = [v, _t(ids_s), ns, op, mask]
            want = sk.sorted_segment_reduce(*args)
            got = sk.sorted_segment_reduce(*(on_card(a) for a in args))
            _close(got[1], want[1], exact=True)
            _close(got[0], want[0], exact=True)
    for v, exact_sum in cases:
        for op in ("sum", "min", "max"):
            args = [v, _t(ids_s), ns, op, mask]
            want = sk.sorted_segment_reduce(*args)
            got = sk.sorted_segment_reduce(*(on_card(a) for a in args))
            _close(got[1], want[1], exact=True)
            if v is not None:
                _close(got[0], want[0], exact=op != "sum" or exact_sum)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 250_000])
def test_cuda_compact_and_argsort_match_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.3
    cols = {"f": rng.normal(size=n).astype(np.float32),
            "i": rng.integers(-5, 5, n).astype(np.int64),
            "c": rng.integers(0, 9, n).astype(np.int32),
            "b": rng.random(n) < 0.5}
    want, wn = sk.compact({k: _t(a) for k, a in cols.items()}, _t(mask))
    got, gn = sk.compact({k: _t(a).to(cuda_device) for k, a in cols.items()},
                         _t(mask).to(cuda_device))
    assert gn == wn == int(mask.sum())
    for k in cols:
        _close(got[k], want[k], exact=True)
    keys = [rng.integers(0, 11, n).astype(np.int64),
            rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64),
            np.array([-(1 << 63), (1 << 63) - 1] * (n // 2) + [0] * (n % 2),
                     dtype=np.int64),
            rng.choice(np.array([0.0, -0.0, 1.0, -3.5, np.inf],
                                dtype=np.float32), n)]
    for k in keys:
        for valid in (None, _t(rng.random(n) < 0.7)):
            want = sk.radix_argsort(_t(k), valid)
            got = sk.radix_argsort(_t(k).to(cuda_device),
                                   valid.to(cuda_device)
                                   if valid is not None else None)
            _close(got, want, exact=True)
    key = _t(np.where(mask, rng.integers(0, 50, n), sk.I64_MAX))
    order = sk.radix_argsort(key, _t(mask))
    for ng in (n, 7):
        want = sk.rank_scatter(key, order, _t(mask), ng)
        got = sk.rank_scatter(key.to(cuda_device), order.to(cuda_device),
                              _t(mask).to(cuda_device), ng)
        for g, w in zip(got, want):
            _close(g, w, exact=True)
    torch.cuda.synchronize()


def _compact_mask(rng, n, kept):
    if kept == "none":
        return np.zeros(n, bool)
    if kept == "one":
        m = np.zeros(n, bool)
        m[n // 2 + 1] = True
        return m
    if kept == "all":
        return np.ones(n, bool)
    if kept == "runs":  # clustered, as (f)'s high-cpu rows are
        return np.repeat(rng.random(-(-n // 97)) < 0.1, 97)[:n]
    return rng.random(n) < 0.08


def _compact_on_card(dev, cols, mask, card_mask=None):
    """compact on the card (under ``card_mask``, the numpy ``mask`` on the
    card by default), bit for bit against compact_plain, with its
    launches, kernels and host syncs counted; returns (columns, kept)."""
    want = sk.compact_plain({k: _t(a) for k, a in cols.items()}, _t(mask))
    card = {k: _t(a).to(dev) for k, a in cols.items()}
    m = _t(mask).to(dev) if card_mask is None else card_mask
    n0 = (sk.compact.launches, sk.compact.kernels, sk.compact.host_syncs)
    got, kept = sk.compact(card, m)
    torch.cuda.synchronize()
    assert kept == want[1]
    assert (sk.compact.launches - n0[0], sk.compact.kernels - n0[1],
            sk.compact.host_syncs - n0[2]) == (
        1, 3 if kept and cols else 1, 1)
    assert list(got) == list(cols)
    for k in cols:
        g, w = got[k].cpu(), want[0][k]
        assert g.dtype == w.dtype and g.shape == w.shape == (kept,)
        assert g.numpy().tobytes() == w.numpy().tobytes(), k
    return got, kept


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4095, 4096, 4097, 3_000_017])
@pytest.mark.parametrize("kept", ["none", "one", "all", "some", "runs"])
def test_cuda_compact_matches_plain(cuda_device, n, kept):
    """Tile and block edges, 0, 1 and all rows kept, scattered and
    clustered masks, every element width."""
    rng = np.random.default_rng(n)
    cols = _compact_columns(rng, n, 8)
    mask = _compact_mask(rng, n, kept)
    _compact_on_card(cuda_device, cols, mask)


@pytest.mark.cuda
def test_cuda_compact_many_columns_and_unaligned(cuda_device):
    """70 columns in one call; a mask and columns that start off a 16-byte
    boundary (views one element in: the byte-wise mask path); two calls
    equal bit for bit."""
    rng = np.random.default_rng(70)
    n = 100_003
    cols = _compact_columns(rng, n, 70)
    mask = _compact_mask(rng, n, "some")
    first, kept = _compact_on_card(cuda_device, cols, mask)
    again, _ = _compact_on_card(cuda_device, cols, mask)
    for k in cols:  # bit for bit, NaN payloads included
        assert first[k].cpu().numpy().tobytes() == \
            again[k].cpu().numpy().tobytes()
    big = torch.from_numpy(np.concatenate([[True], mask])).to(cuda_device)
    off = big[1:]
    assert off.data_ptr() % 16 != 0
    _compact_on_card(cuda_device, cols, mask, card_mask=off)
    wide = {k: np.concatenate([a[:1], a]) for k, a in cols.items()}
    card = {k: _t(a).to(cuda_device)[1:] for k, a in wide.items()}
    want = sk.compact_plain({k: _t(a) for k, a in cols.items()}, _t(mask))
    got, k2 = sk.compact(card, _t(mask).to(cuda_device))
    assert k2 == kept
    for k in cols:
        assert got[k].cpu().numpy().tobytes() == want[0][k].numpy().tobytes()


@pytest.mark.cuda
def test_cuda_compact_one_host_sync_and_no_row_sized_scratch(cuda_device):
    """One host sync a compact: the count's read, inside the count's C
    call (``compact.host_syncs``), and no synchronizing torch op besides
    (torch's sync debug mode sees none); three launches; the call's peak
    memory is its output, its [kept] order and its scratch: no [N] int32
    array (n * 4 bytes) on the way."""
    import warnings

    rng = np.random.default_rng(12)
    n = 3_000_017
    mask = torch.from_numpy(rng.random(n) < 0.01).to(cuda_device)
    col = torch.from_numpy(rng.integers(0, 255, n, dtype=np.uint8)).to(
        cuda_device)
    sk.compact({"c": col}, mask)  # built and warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n0 = sk.compact.kernels, sk.compact.host_syncs
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out, kept = sk.compact({"c": col}, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    syncs = [w for w in seen if "synchroniz" in str(w.message).lower()]
    assert not syncs, [str(w.message) for w in syncs]
    assert (sk.compact.kernels - n0[0], sk.compact.host_syncs - n0[1]) == (
        3, 1)
    assert kept == int(mask.sum())
    assert peak < n * 4, peak
    assert peak <= 5 * kept + 2 * (n // 4096 + 1) * 8 + 16 * 1024, peak
    del out


# ---------------------------------------------------------------------------
# radix_argsort's 8-bit digit passes and the single-pass scan, on the card,
# at sizes that chain many 4,096-row tiles
# ---------------------------------------------------------------------------

BIG = 3_000_017  # 733 tiles of the scan and of each digit pass


def _keys_of_bits(rng, n, bits):
    """int64 keys whose range needs exactly ``bits`` bits in radix_argsort
    (the largest relative key, max - min + 1, has that bit length; 64: the
    whole int64 range); rows 0 and 1 hold the extremes."""
    if bits == 64:
        k = rng.integers(sk.I64_MIN, sk.I64_MAX, n, dtype=np.int64,
                         endpoint=True)
        k[:2] = [sk.I64_MIN, sk.I64_MAX]
        return k
    span = (1 << bits) - 2
    base = int(rng.integers(-(1 << 40), 1 << 40))
    k = base + rng.integers(0, span, n, dtype=np.int64, endpoint=True)
    k[:2] = [base, base + span]
    return k


def _argsort_case(cuda_device, k, valid):
    want = sk.radix_argsort(_t(k), None if valid is None else _t(valid))
    got = sk.radix_argsort(
        _t(k).to(cuda_device),
        None if valid is None else _t(valid).to(cuda_device))
    _close(got, want, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits", [1, 8, 9, 13, 32, 33, 40, 64])
def test_cuda_radix_argsort_key_widths(cuda_device, bits, masked):
    rng = np.random.default_rng(bits)
    k = _keys_of_bits(rng, BIG, bits)
    valid = None
    if masked:
        valid = rng.random(BIG) < 0.7
        valid[:2] = True  # the extremes stay valid: the range is exact
    assert sk.argsort_bits(int(k[valid if masked else slice(None)].min()),
                           int(k[valid if masked else slice(None)].max()),
                           True)[2] == bits
    _argsort_case(cuda_device, k, valid)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 8191, 8193])
def test_cuda_radix_argsort_tile_edges(cuda_device, n):
    rng = np.random.default_rng(n)
    k = rng.integers(0, 5000, n).astype(np.int64)  # 13 bits: two digits
    _argsort_case(cuda_device, k, None)
    _argsort_case(cuda_device, k, rng.random(n) < 0.5)
    torch.cuda.synchronize()


def _tie_case(name, rng, n):
    """(values, valid) with many equal keys across tiles and warps."""
    if name == "one_bin":
        # every key has the low digit 7: one bin of the first pass holds all
        # n rows; the second pass sorts by the high digit
        return (rng.integers(0, 32, n) << 8 | 7).astype(np.int64), None
    if name == "one_key":
        return np.full(n, -12345, dtype=np.int64), rng.random(n) < 0.5
    if name == "long_runs":
        # runs of 10,000 equal keys crossing tile boundaries
        return ((np.arange(n) // 10_000) % 7).astype(np.int64), None
    if name == "few_keys":
        # three values spread over every tile and warp: a tile ranking its
        # keys in striped rather than row order, or a look-back mixing two
        # digits, reorders equal keys
        return rng.integers(0, 3, n).astype(np.int64), rng.random(n) < 0.9
    if name == "signed_zeros":
        v = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, np.inf],
                                dtype=np.float32), n)
        return v, rng.random(n) < 0.8
    if name == "full_range_invalid":
        k = _keys_of_bits(rng, n, 64)
        valid = rng.random(n) < 0.6
        valid[:2] = True
        return k, valid
    raise ValueError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one_bin", "one_key", "long_runs",
                                  "few_keys", "signed_zeros",
                                  "full_range_invalid"])
def test_cuda_radix_argsort_is_stable(cuda_device, name):
    rng = np.random.default_rng(len(name))
    v, valid = _tie_case(name, rng, BIG)
    _argsort_case(cuda_device, v, valid)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4095, 4096, 4097, BIG])
def test_cuda_compact_and_rank_scatter_chain_tiles(cuda_device, n):
    """compact's mask scan and rank_scatter's rank scan on the single-pass
    scan, exact against the plain versions."""
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.4
    mask[-1] = True
    cols = {"i": np.arange(n, dtype=np.int64),
            "f": rng.normal(size=n).astype(np.float32)}
    want, wn = sk.compact({k: _t(a) for k, a in cols.items()}, _t(mask))
    got, gn = sk.compact({k: _t(a).to(cuda_device) for k, a in cols.items()},
                         _t(mask).to(cuda_device))
    assert gn == wn == int(mask.sum())
    for k in cols:
        _close(got[k], want[k], exact=True)
    key = _t(np.where(mask, rng.integers(0, 5000, n), sk.I64_MAX))
    order = sk.radix_argsort(key, _t(mask))
    for ng in (n, 4000):
        want = sk.rank_scatter(key, order, _t(mask), ng)
        got = sk.rank_scatter(key.to(cuda_device), order.to(cuda_device),
                              _t(mask).to(cuda_device), ng)
        for g, w in zip(got, want):
            _close(g, w, exact=True)
    torch.cuda.synchronize()


def _edge_columns(dev):
    """A numpy array on the card, as itself and as a view at offset 1 of a
    buffer one element longer (unaligned pointers)."""
    def both(a):
        full = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        off = torch.empty((a.shape[0] + 1,) + a.shape[1:], dtype=full.dtype,
                          device=dev)
        off[1:] = full
        return full, off[1:]
    return both


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000_003, 4_194_305])
@pytest.mark.parametrize("unaligned", [False, True])
def test_cuda_segment_reduce_loads_and_edges(cuda_device, n, unaligned):
    """The mask-first batched loads at their edges, bit for bit (counts,
    ints, min/max) or within the atomics-order bound (float sums) against
    the plain version: N off every vector and chunk width, views at
    offset 1, masks of runs / scattered rows / no row / none, int64 min /
    max at the privatisation edge (4,096 and 4,097 segments), and 1, 4,
    10 and 16 f32 columns as a row-major [N, C] (ld = C) and as columns."""
    rng = np.random.default_rng(n)
    both = _edge_columns(cuda_device)
    pick = 1 if unaligned else 0
    masks = {
        "runs": (rng.random(-(-n // 97)) < 0.4).repeat(97)[:n],
        "scattered": rng.random(n) < 0.1,
        "dead": np.zeros(n, bool),
        "none": None,
    }
    for ns in (4096, 4097):
        ids = np.sort(rng.integers(-1, ns + 1, n)).astype(np.int32)
        ts = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        ids_d, ts_d = both(ids)[pick], both(ts)[pick]
        for name, m in masks.items():
            m_d = None if m is None else both(m)[pick]
            m_t = None if m is None else torch.from_numpy(m)
            for op in ("max", "min"):
                got = sk.segment_reduce(ts_d, ids_d, ns, op, m_d)
                want = sk.segment_reduce_plain(_t(ts), _t(ids), ns, op, m_t)
                _close(got[1], want[1], exact=True)
                _close(got[0], want[0], exact=True)
    ns = 65_536
    ids = rng.integers(-2, ns + 2, n).astype(np.int32)
    ids.sort()
    f32 = rng.uniform(0, 100, (n, 16)).astype(np.float32)
    f32[rng.random((n, 16)) < 0.05] = np.nan
    ids_d = both(ids)[pick]
    for C in (1, 4, 10, 16):
        mat = np.ascontiguousarray(f32[:, :C])
        for name in ("runs", "none"):
            m = masks[name]
            m_d = None if m is None else both(m)[pick]
            m_t = None if m is None else torch.from_numpy(m)
            for vals in (both(mat)[pick] if C > 1 else both(mat[:, 0])[pick],
                         [both(np.ascontiguousarray(mat[:, c]))[pick]
                          for c in range(C)]):
                for op in ("sum", "max"):
                    got = sk.segment_reduce(vals, ids_d, ns, op, m_d)
                    want = sk.segment_reduce_plain(
                        _t(mat if C > 1 else mat[:, 0]), _t(ids), ns, op,
                        m_t)
                    _close(got[1], want[1].reshape(got[1].shape), exact=True)
                    _close(got[0], want[0].reshape(got[0].shape),
                           exact=op != "sum")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_segment_reduce_registers(cuda_device):
    """Every instance the row path launches reports its registers and
    spills (cudaFuncGetAttributes)."""
    for dtype, op, cols in ((torch.int64, "max", 1), (torch.int64, "min", 1),
                            (torch.float32, "sum", 1),
                            (torch.float32, "sum", 4),
                            (torch.float32, "sum", 10),
                            (torch.float32, "sum", 16),
                            (torch.float64, "sum", 1)):
        for priv in (True, False):
            regs, local = sk.reduce_registers(dtype, op, cols, priv)
            assert 0 < regs <= 255 and local >= 0
