"""Port parity of the raw scan's device top-k (``ORDER BY <numeric
columns> LIMIT k``): ``Executor._topk_spec`` and the ``topk_select``
kernel's plain version.

The JAX reference and the port (``device="cpu"``) ingest the same seeded
rows through ``region.write`` and answer the same queries; rows must be
equal (==).  Every query also asserts which route ran on both sides: the
port's ``DISPATCH_STATS["topk"]`` and a spy on the reference's
``Executor._topk_spec``, so eligibility matches the reference exactly.
The key columns carry NaN, -0.0 / +0.0, INT64_MIN / INT64_MAX, unsigned
zeros, int8 -128, bools and many ties, so DESC's in-dtype negation, the
null ranks and row-order tie breaks all decide rows at the LIMIT's edge.
The plain version is also held to ``np.lexsort`` directly, and the
reference's own ``TestDeviceTopK`` cases run against the port.  Tests
marked ``cuda`` hold the kernel to its plain version on the card.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import test_window as tw
import torch

from greptimedb_tpu.query.physical import Executor as RefExecutor
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.datatypes.batch import pad_rows
from greptimedb_tpu_torch.ops import topk_kernels as TK
from greptimedb_tpu_torch.query import physical
from greptimedb_tpu_torch.standalone import GreptimeDB

T0 = 1_700_000_000_000
HOSTS, STEPS = 2, 100
N = HOSTS * STEPS
I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max
DDL = ("CREATE TABLE t (h STRING, ts TIMESTAMP(3) TIME INDEX, v DOUBLE, "
       "f FLOAT, k BIGINT, u INT UNSIGNED, i8 TINYINT, i16 SMALLINT, "
       "u8 TINYINT UNSIGNED, b BOOLEAN, s STRING, PRIMARY KEY (h))")


def _rows(seed: int, hosts: int, steps: int) -> dict:
    rng = np.random.default_rng(seed)
    n = hosts * steps
    return {
        "h": np.repeat(np.array([f"h{i}" for i in range(hosts)],
                                dtype=object), steps),
        "ts": np.tile(T0 + np.arange(steps, dtype=np.int64) * 1000, hosts),
        "v": rng.choice([-1.5, -0.0, 0.0, 1.0, 2.5, np.nan], n),
        "f": rng.choice([-2.0, -0.0, 0.0, 3.0, np.nan], n).astype(
            np.float32),
        "k": rng.choice(np.array([I64_MIN, -3, 0, 7, I64_MAX],
                                 dtype=np.int64), n),
        "u": rng.choice(np.array([0, 1, 5, 2**32 - 1], dtype=np.uint32), n),
        "i8": rng.choice(np.array([-128, -1, 0, 1, 127], dtype=np.int8), n),
        "i16": rng.integers(-3, 3, n).astype(np.int16),
        "u8": rng.choice(np.array([0, 1, 255], dtype=np.uint8), n),
        "b": rng.random(n) < 0.5,
        "s": rng.choice(np.array(["x", "y", "z"], dtype=object), n),
    }


def _make(db, data):
    db.sql(DDL)
    db._region_of("t").write(data)
    return db


@pytest.fixture(scope="module")
def data():
    return _rows(5, HOSTS, STEPS)


@pytest.fixture(scope="module")
def pair(data):
    dbs = (_make(RefDB(), data), _make(GreptimeDB(device="cpu"), data))
    yield dbs
    for d in dbs:
        d.close()


def _routes(pair, sql, monkeypatch):
    """Run ``sql`` on both; rows must be equal.  Returns (port took the
    top-k, the reference's _topk_spec decisions)."""
    ref, port = pair
    seen = []
    orig = RefExecutor._topk_spec

    def spy(plan, ctx, table):
        spec = orig(plan, ctx, table)
        seen.append(spec is not None)
        return spec

    monkeypatch.setattr(RefExecutor, "_topk_spec", staticmethod(spy))
    want = ref.sql(sql)
    before = physical.DISPATCH_STATS["topk"]
    got = port.sql(sql)
    took = physical.DISPATCH_STATS["topk"] - before
    assert got.rows == want.rows, sql
    return took == 1, seen


def _check(pair, sql, topk, monkeypatch):
    took, seen = _routes(pair, sql, monkeypatch)
    assert took is topk
    assert seen == [topk]


TOPK_QUERIES = {
    # NaN: NULLS LAST under ASC, NULLS FIRST under DESC, and both forced
    "nan_asc": "SELECT h, ts, v FROM t ORDER BY v LIMIT 37",
    "nan_desc": "SELECT h, ts, v FROM t ORDER BY v DESC LIMIT 37",
    "nan_nulls_first": ("SELECT h, ts, v FROM t "
                        "ORDER BY v NULLS FIRST LIMIT 41"),
    "nan_desc_nulls_last": ("SELECT h, ts, v FROM t "
                            "ORDER BY v DESC NULLS LAST LIMIT 41"),
    "f32_key": "SELECT h, ts, f FROM t ORDER BY f DESC LIMIT 45",
    "int64_min_desc": "SELECT h, ts, k FROM t ORDER BY k DESC LIMIT 43",
    "int64_asc": "SELECT h, ts, k FROM t ORDER BY k LIMIT 43",
    "uint32_zeros_desc": "SELECT h, ts, u FROM t ORDER BY u DESC LIMIT 57",
    "uint8_desc": "SELECT h, ts, u8 FROM t ORDER BY u8 DESC LIMIT 71",
    "int8_desc": "SELECT h, ts, i8 FROM t ORDER BY i8 DESC LIMIT 45",
    "bool_key": "SELECT h, ts, b FROM t ORDER BY b DESC, i16 LIMIT 33",
    "multi_key_ties": ("SELECT h, ts, i8, v FROM t "
                       "ORDER BY i8, v DESC, i16 LIMIT 29"),
    "offset": "SELECT h, ts, v FROM t ORDER BY v, i16 LIMIT 7 OFFSET 19",
    "where_time_range": (f"SELECT h, ts, v FROM t WHERE v > 0 AND "
                         f"ts >= {T0 + 20_000} AND ts < {T0 + 70_000} "
                         f"ORDER BY ts DESC LIMIT 6"),
    "star": "SELECT * FROM t WHERE i16 = 0 ORDER BY u8, f LIMIT 9",
}


@pytest.mark.parametrize("name", sorted(TOPK_QUERIES))
def test_topk_route_matches_reference(name, pair, monkeypatch):
    _check(pair, TOPK_QUERIES[name], True, monkeypatch)


def test_signed_zero_ties_keep_row_order(pair, data, monkeypatch):
    """-0.0 and +0.0 tie: the LIMIT's edge falls among the zeros, so the
    rows kept are the first zeros in row order whatever their sign."""
    v = data["v"]
    zero = v == 0
    assert zero.sum() > 6 and np.signbit(v[zero]).any() and (
        ~np.signbit(v[zero])).any()
    below, above = int((v < 0).sum()), int((v > 0).sum())
    _check(pair, f"SELECT h, ts, v FROM t ORDER BY v LIMIT {below + 3}",
           True, monkeypatch)
    _check(pair, f"SELECT h, ts, v FROM t ORDER BY v DESC NULLS LAST "
           f"LIMIT {above + 3}", True, monkeypatch)


def test_padded_rows_edge(pair, monkeypatch):
    """k = padded_rows - 1 takes the top-k; k = padded_rows does not."""
    p = pad_rows(N)
    _check(pair, f"SELECT h, ts, v FROM t ORDER BY v, ts LIMIT {p - 1}",
           True, monkeypatch)
    _check(pair, f"SELECT h, ts, v FROM t ORDER BY v, ts LIMIT {p}",
           False, monkeypatch)


REFUSED = {
    "having": "SELECT ts, v FROM t HAVING v > 1 ORDER BY v, ts LIMIT 5",
    "distinct": "SELECT DISTINCT i8 FROM t ORDER BY i8 LIMIT 3",
    "window": ("SELECT ts, v, row_number() OVER (ORDER BY ts) AS r FROM t "
               "ORDER BY v, ts LIMIT 5"),
    "tag_key": "SELECT h, ts FROM t ORDER BY h DESC, ts LIMIT 3",
    "string_field_key": "SELECT s, ts FROM t ORDER BY s, ts LIMIT 3",
    "expression_key": "SELECT ts, v FROM t ORDER BY v + 1, ts LIMIT 3",
    "no_limit": "SELECT ts, v FROM t ORDER BY v, ts",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_shapes_take_the_full_scan(name, pair, monkeypatch):
    _check(pair, REFUSED[name], False, monkeypatch)


def test_k_bound_65536(monkeypatch):
    """k = limit + offset = 65,536 takes the top-k; 65,537 does not."""
    data = _rows(7, 1, 70_000)
    pair = (_make(RefDB(), data), _make(GreptimeDB(device="cpu"), data))
    try:
        base = "SELECT ts, i16 FROM t ORDER BY i16 DESC, u8"
        _check(pair, f"{base} LIMIT 36 OFFSET 65500", True, monkeypatch)
        _check(pair, f"{base} LIMIT 37 OFFSET 65500", False, monkeypatch)
        _check(pair, f"{base} LIMIT 65537", False, monkeypatch)
    finally:
        for d in pair:
            d.close()


# ---- the plain version against np.lexsort ------------------------------

def _np_lexsort_keys(cols, mask):
    """The reference's key list (physical.py:1966-1980) in numpy."""
    keys = []
    for v, asc, nulls_first in reversed(cols):
        if v.dtype.kind == "f":
            isnull = np.isnan(v)
            nf = (not asc) if nulls_first is None else nulls_first
            rank = np.where(isnull, 0 if nf else 2, 1)
            v = np.where(isnull, v.dtype.type(0), v)
        else:
            if v.dtype == np.bool_:
                v = v.astype(np.int32)
            rank = np.ones(v.shape, dtype=np.int32)
        with np.errstate(over="ignore"):
            keys.append(v if asc else -v)
        keys.append(rank)
    keys.append(~mask)
    return keys


_DTYPES = {
    "f32": np.float32, "f64": np.float64, "i64": np.int64, "i32": np.int32,
    "i16": np.int16, "i8": np.int8, "u8": np.uint8, "u16": np.uint16,
    "u32": np.uint32, "bool": np.bool_,
}


def _column(rng, dt, n):
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if np.dtype(dt).kind == "f":
        v = rng.choice([-2.5, -0.0, 0.0, 1.0, np.inf, -np.inf, np.nan], n)
        return v.astype(dt)
    info = np.iinfo(dt)
    v = rng.integers(max(info.min, -4), min(info.max, 4) + 1, n).astype(dt)
    pick = rng.random(n) < 0.2
    v[pick] = rng.choice(np.array([info.min, info.max, 0, 1], dtype=dt),
                         int(pick.sum()))
    return v


@pytest.mark.parametrize("dt", sorted(_DTYPES))
@pytest.mark.parametrize("asc,nulls_first", [(True, None), (False, None),
                                              (True, True), (False, False)])
def test_plain_equals_np_lexsort(dt, asc, nulls_first):
    rng = np.random.default_rng(zlib.crc32(f"{dt}{asc}{nulls_first}".encode()))
    n = 3000
    v = _column(rng, _DTYPES[dt], n)
    second = rng.integers(0, 3, n).astype(np.int64)
    mask = rng.random(n) < 0.9
    cols = [(v, asc, nulls_first), (second, True, None)]
    want = np.lexsort(_np_lexsort_keys(cols, mask))
    for k in (1, 50, n - 1, n):
        rows, got_n = TK.topk_select(
            [(torch.from_numpy(c), a, nf) for c, a, nf in cols],
            torch.from_numpy(mask), k)
        assert rows.tolist() == want[:k].tolist()
        assert got_n == min(int(mask.sum()), k)
    assert TK.topk_select.launches == 0  # CPU tensors: the plain version


def test_wrapper_checks_arguments():
    v = torch.zeros(4)
    with pytest.raises(ValueError):
        TK.topk_select([], torch.ones(4, dtype=torch.bool), 1)
    with pytest.raises(ValueError):
        TK.topk_select([(v, True, None)], torch.ones(3, dtype=torch.bool), 1)
    with pytest.raises(ValueError):
        TK.topk_select([(v.to(torch.complex64), True, None)],
                       torch.ones(4, dtype=torch.bool), 1)


# ---- the candidate route's plan, emulated in torch ---------------------
#
# The card's topk_select (csrc/topk_kernels.cu) turns each key into one
# unsigned order key, takes the AND / OR of the first key over the set,
# cuts 11-bit digits below the bits every row of the set shares, sends the
# rows strictly better than the picked digit to the output and the picked
# bin to a candidate buffer (or, when the bin overflows it, runs the rows
# route), then refines the candidates key by key (the row index last) and
# sorts the output and the candidates by (class, keys..., row).  This
# emulation follows the same plan on int64 bit patterns and must give the
# rows of topk_select_plain and of the reference's lexsort.

_U64 = (1 << 64) - 1
_BITS = {torch.float32: 32, torch.float64: 64, torch.int64: 64,
         torch.int32: 32, torch.int16: 16, torch.int8: 8, torch.uint8: 8,
         torch.uint16: 16, torch.uint32: 32}


def _order_keys(v, asc, nulls_first):
    """The kernel's order_key: int64 bit patterns of the unsigned keys."""
    if v.dtype == torch.bool:
        v = v.view(torch.int8)
    bits = _BITS[v.dtype]
    ones = -1 if bits == 64 else (1 << bits) - 1
    nf = (not asc) if nulls_first is None else nulls_first
    if v.is_floating_point():
        nan = torch.isnan(v)
        x = torch.where(nan, 0.0, v)
        x = x if asc else -x
        x = torch.where(x == 0, 0.0, x)  # -0.0 == +0.0
        if bits == 32:
            b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            top = 1 << 31
        else:
            b = x.view(torch.int64)
            top = TK.sk.I64_MIN
        neg = (b & top) != 0
        ordk = torch.where(neg, ~b & ones, b | top)
        return torch.where(nan, 0 if nf else ones, ordk)
    x = v.to(torch.int64)
    x = x if asc else -x  # int64: wraps as the dtype does
    if v.dtype in (torch.uint8, torch.uint16, torch.uint32):
        return x & ones
    if bits == 64:
        return x ^ TK.sk.I64_MIN
    return (x + (1 << (bits - 1))) & ones


def _digit_of(a, o):
    x = (a ^ o) & _U64
    if x == 0:
        return 0, 0
    hi, lo = x.bit_length() - 1, (x & -x).bit_length() - 1
    shift = max(lo, hi - (TK.DIGIT_BITS - 1))
    return shift, hi - shift + 1


def _digits(ordk, shift, width):
    return (ordk >> shift) & ((1 << width) - 1) if width else ordk * 0


def _and_or(x):
    a, o = -1, 0
    for w in x.tolist():
        a, o = a & w, o | w
    return a, o


def _pick(d, want):
    hist = torch.bincount(d, minlength=TK.BINS)
    cum = torch.cumsum(hist, 0)
    p = int(torch.nonzero(cum >= want)[0])
    below = int(cum[p] - hist[p])
    return p, int(hist[p]), below


def _sample_rows(n, kind):
    """The rows the sample reads: the kernel's warp tiles of 512 rows, up
    to 1,024 of them spread evenly ("tiles"), or only the first 64 rows
    ("thin": a sample that misses the range's extremes)."""
    if kind == "thin":
        return torch.arange(min(n, 64))
    total = -(-n // 512)
    tiles = min(total, 1024)
    starts = [t * total // tiles * 512 for t in range(tiles)]
    return torch.cat([torch.arange(b, min(b + 512, n)) for b in starts])


def _top_bit(a, o):
    return ((a ^ o) & _U64).bit_length() - 1


def _emulate(keys, mask, k, capacity, sort_cap, sample="tiles"):
    """(rows, route, full passes) of the candidate route's plan."""
    n = mask.shape[0]
    k = min(k, n)
    ords = [_order_keys(v, a, f) for v, a, f in keys]
    ords.append(torch.arange(n))  # the row index: the last key
    live = int(mask.sum())
    target = live >= k
    want = k if target else k - live
    s = torch.nonzero(mask == target).flatten()
    out = [] if target else torch.nonzero(mask).flatten().tolist()
    seen = _sample_rows(n, sample)
    seen = seen[mask[seen]]
    exact = _and_or(ords[0][torch.nonzero(mask).flatten()])
    passes = 2  # pass 1 and the split, when the sample's digit stands
    if target and len(seen) and _top_bit(*_and_or(ords[0][seen])) == \
            _top_bit(*exact):
        shift, width = _digit_of(*_and_or(ords[0][seen]))
    elif target:  # pass 2: the histogram by the exact range
        passes = 3
        shift, width = _digit_of(*exact)
    else:  # no range of the unset rows: the key's top bits
        passes = 3
        bits = _BITS[TK._key_column(keys[0][0]).dtype]
        shift, width = max(bits - TK.DIGIT_BITS, 0), min(bits, TK.DIGIT_BITS)
    d = _digits(ords[0][s], shift, width)
    p, cnt, below = _pick(d, want)
    final = cnt == want - below
    if not final and cnt > capacity:
        return TK.topk_select_plain(keys, mask, k)[0], "rows", None
    out += s[d < p].tolist() + (s[d == p].tolist() if final else [])
    s, rem, key = s[d == p], want - below, 0
    small = k <= sort_cap
    stop = TK.sort_stop(k, sort_cap)
    while not final and not (small and len(out) + len(s) <= stop):
        a, o = _and_or(ords[key][s])
        if a == o:  # every candidate shares the key: the next key's range
            key += 1
            continue
        shift, width = _digit_of(a, o)
        d = _digits(ords[key][s], shift, width)
        p, cnt, below = _pick(d, rem)
        final = cnt == rem - below
        out += s[d < p].tolist() + (s[d == p].tolist() if final else [])
        s, rem = s[d == p], rem - below
    rows = torch.tensor(out + ([] if final else s.tolist()),
                        dtype=torch.int64)
    cls = (~mask[rows]).to(torch.int64)
    order = torch.argsort(rows, stable=True)
    for w in [o[rows] ^ TK.sk.I64_MIN for o in reversed(ords[:-1])] + [cls]:
        order = order[torch.argsort(w[order], stable=True)]
    return rows[order][:k], "candidates", passes


def _emulation_case(name, rng, n):
    """(keys as numpy (column, asc, nulls_first), mask) of a named case."""
    base = rng.integers(0, 5, n).astype(np.int64)
    if name == "nan_ranks":
        v = rng.choice([np.nan, -1.5, 0.0, 2.5], n).astype(np.float32)
        return [(v, False, None), (v, True, False), (base, True, None)], \
            rng.random(n) < 0.9
    if name == "int64_min_desc":
        v = rng.choice(np.array([I64_MIN, -7, 0, 3, I64_MAX]), n)
        return [(v.astype(np.int64), False, None)], rng.random(n) < 0.8
    if name == "unsigned_desc":
        v = rng.choice(np.array([0, 1, 200, 255], dtype=np.uint8), n)
        w = rng.choice(np.array([0, 1, 2**32 - 1], dtype=np.uint32), n)
        return [(v, False, None), (w, False, None)], rng.random(n) < 0.9
    if name == "signed_zeros":
        v = rng.choice([-0.0, 0.0, -1.0, 1.0], n)
        return [(v, True, None), (base, False, None)], rng.random(n) < 0.9
    if name == "bool_keys":
        return [(rng.random(n) < 0.5, False, None),
                (rng.random(n) < 0.3, True, None)], rng.random(n) < 0.9
    if name == "all_false":
        return [(rng.normal(size=n), True, None)], np.zeros(n, bool)
    if name == "constant":
        return [(np.full(n, 100.0, np.float32), False, None)], \
            rng.random(n) < 0.95
    if name == "huge_tie":  # a clipped walk: most rows at 100.0
        v = np.clip(rng.normal(99, 3, n), 0, 100).astype(np.float32)
        ts = T0 + rng.permutation(n).astype(np.int64) * 10_000
        return [(v, False, None), (ts, True, None)], np.ones(n, bool)
    if name == "sorted_ts":  # (j): ts DESC under a ~10 % mask
        ts = T0 + np.arange(n, dtype=np.int64) * 10_000
        return [(ts, False, None)], rng.random(n) < 0.1
    v = rng.normal(size=n).astype(np.float64)  # "spread"
    return [(v, True, None), (base, False, None)], rng.random(n) < 0.5


_EMULATION_CASES = ["nan_ranks", "int64_min_desc", "unsigned_desc",
                    "signed_zeros", "bool_keys", "all_false", "constant",
                    "huge_tie", "sorted_ts", "spread"]


@pytest.mark.parametrize("sample", ["tiles", "thin"])
@pytest.mark.parametrize("k", [1, 37, 700, 2000])
@pytest.mark.parametrize("name", _EMULATION_CASES)
def test_candidate_plan_emulation(name, k, sample):
    """The plan on 2,000 rows (k = 2,000 is k = n) with a 600-row
    candidate buffer and a 256-row sort: the constant key and the huge tie
    overflow to the rows route, the rest refine their candidates; every
    route gives the plain rows and the reference's lexsort.  The sample of
    the kernel's tiles (here every row) lets pass 1's histogram stand when
    at least k rows are set: two passes over N; a thin sample may not, and
    pass 2 then counts by the exact range: three."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 2000
    cols, mask = _emulation_case(name, rng, n)
    keys = [(torch.from_numpy(np.ascontiguousarray(c)), a, f)
            for c, a, f in cols]
    tmask = torch.from_numpy(mask)
    got, route, passes = _emulate(keys, tmask, k, capacity=600,
                                  sort_cap=256, sample=sample)
    want, want_n = TK.topk_select_plain(keys, tmask, k)
    ref = np.asarray(jnp.lexsort(_np_lexsort_keys(cols, mask)))[:k]
    assert got.tolist() == want.tolist() == ref.tolist()
    assert want_n == min(int(mask.sum()), k)
    if name in ("constant", "huge_tie") and k < n:
        assert route == "rows"
    if name in ("spread", "nan_ranks"):
        assert route == "candidates"
    if route == "candidates":
        full = sample == "tiles" and int(mask.sum()) >= k
        assert passes == 2 if full else passes in (2, 3)
    if name == "sorted_ts" and sample == "thin" and k < 100:
        assert passes == 3  # the first 64 rows miss the later timestamps


def test_plan_sizes():
    """The wrapper's sizes: the candidate buffer, the finish block's sort
    (a power of two within its shared memory) and the phase launches."""
    assert TK.candidate_capacity(1000) == 1000
    assert TK.candidate_capacity(35_651_584) == 35_651_584 // 4
    for nk in range(1, 12):
        cap = TK.sort_capacity(nk)
        assert cap & (cap - 1) == 0 and cap <= TK.SORT_CAP
        assert cap * (8 * nk + 7) <= TK.SORT_SMEM
    assert TK.sort_capacity(1) == TK.SORT_CAP
    assert [TK.sort_stop(k, 4096) for k in (1, 300, 4000)] == [
        TK.SORT_MIN, 600, 4096]
    assert TK.step_plan(1 << 20, [64], 16, TK.FINISH_MAX) == (0, 1)
    steps, grid = TK.step_plan(35_651_584, [32, 64], 20, 4_200_000)
    assert steps == TK.MAX_STEPS and grid == TK.STEP_GRID_MAX
    steps, grid = TK.step_plan(1 << 20, [8], 0, 20_000)
    assert steps == 1 + 2 * 2 and grid == 20  # the row index's range, 2 digits


def _pack(words, k):
    """topk_pack_kernel's composite keys (Python ints): each sort word's
    varying bits [lo, lo + width) over the k rows, packed from bit 0 up,
    the last word lowest; and the composite's width."""
    comp, at = [0] * k, 0
    for word in reversed(words):
        a = o = int(word[0])
        for x in word:
            a &= int(x)
            o |= int(x)
        x = a ^ o
        if not x:
            continue
        lo = (x & -x).bit_length() - 1
        width = x.bit_length() - lo
        for s in range(k):
            comp[s] |= ((int(word[s]) >> lo) & ((1 << width) - 1)) << at
        at += width
    return comp, at


def test_pack_layout_orders_rows_as_their_words():
    """The large-k tail's composite key: the varying bits of (class,
    keys..., row) packed from the row up order random rows as the words
    do; the composite never exceeds ``order_bits``, and LSD passes over its
    64-bit words, the least significant first (as ``gt_topk_order`` runs
    them), give the same order."""
    rng = np.random.default_rng(8)
    k, n = 500, 1 << 20
    cols = [torch.zeros(1, dtype=torch.float32),
            torch.zeros(1, dtype=torch.int64)]
    f32 = rng.integers(0, 1 << 32, k, dtype=np.uint64)
    i64 = rng.integers(0, 1 << 63, k, dtype=np.uint64) << np.uint64(1)
    rows = rng.choice(n, k, replace=False).astype(np.uint64)
    words = [rng.integers(0, 2, k).astype(np.uint64), f32, i64, rows]
    comp, bits = _pack(words, k)
    span = int(np.bitwise_and.reduce(rows) ^ np.bitwise_or.reduce(rows))
    row_bits = span.bit_length() - ((span & -span).bit_length() - 1)
    # every bit of the f32 word varies; i64's bit 0 never does
    assert bits == 1 + 32 + 63 + row_bits
    assert bits <= TK.order_bits(cols, n) == 1 + 32 + 64 + 20
    want = np.lexsort([w for w in reversed(words)]).tolist()
    assert sorted(range(k), key=lambda s: comp[s]) == want
    order = list(range(k))
    for q in range(-(-TK.order_bits(cols, n) // 64)):
        order = sorted(order,
                       key=lambda s: (comp[s] >> (64 * q)) & (2**64 - 1))
    assert order == want
    # a word every row shares adds nothing: the class of all-set rows
    comp, bits = _pack([np.zeros(k, np.uint64), f32, rows], k)
    assert bits == 32 + row_bits
    assert sorted(range(k), key=lambda s: comp[s]) == np.lexsort(
        [rows, f32]).tolist()


# ---- the reference's own cases, against the port ----------------------

@pytest.fixture
def db():
    d = GreptimeDB(device="cpu")
    yield d
    d.close()


class TestDeviceTopKOnPort(tw.TestDeviceTopK):
    """tests/test_window.py::TestDeviceTopK with the port's db."""


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(_DTYPES))
def test_cuda_topk_select_matches_plain(dt, cuda_device):
    rng = np.random.default_rng(17)
    n = (1 << 20) + 123
    v = _column(rng, _DTYPES[dt], n)
    second = rng.integers(0, 1000, n).astype(np.int64)
    mask = rng.random(n) < 0.95
    for asc, nf in ((True, None), (False, None), (False, False)):
        cols = [(v, asc, nf), (second, False, None)]
        for k in (1, 100, 65_536):
            want, want_n = TK.topk_select_plain(
                [(torch.from_numpy(c), a, f) for c, a, f in cols],
                torch.from_numpy(mask), k)
            before = TK.topk_select.launches
            got, got_n = TK.topk_select(
                [(torch.from_numpy(c).to(cuda_device), a, f)
                 for c, a, f in cols], torch.from_numpy(mask).to(cuda_device),
                k)
            torch.cuda.synchronize()
            assert TK.topk_select.launches == before + 1
            assert got.cpu().tolist() == want.tolist()
            assert got_n == want_n


@pytest.mark.cuda
def test_cuda_topk_ties_keep_row_order(cuda_device):
    """A constant column: every row ties, so the first k rows in row order
    (the mask's unset rows last) come back."""
    n = (1 << 20) + 7
    v = torch.full((n,), 100.0, device=cuda_device)
    mask = torch.ones(n, dtype=torch.bool, device=cuda_device)
    mask[:5] = False
    got, got_n = TK.topk_select([(v, False, None)], mask, 1000)
    assert got.cpu().tolist() == list(range(5, 1005))
    assert got_n == 1000
    few = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    few[[3, 9]] = True
    got, got_n = TK.topk_select([(v, True, None)], few, 4)
    assert got.cpu().tolist() == [3, 9, 0, 1] and got_n == 2


@pytest.mark.cuda
def test_cuda_raw_topk_matches_cpu(cuda_device):
    data = _rows(9, 4, 5000)
    dbs = (_make(GreptimeDB(device="cuda"), data),
           _make(GreptimeDB(device="cpu"), data))
    try:
        for sql in TOPK_QUERIES.values():
            before = TK.topk_select.launches
            assert dbs[0].sql(sql).rows == dbs[1].sql(sql).rows, sql
            assert TK.topk_select.launches == before + 1
    finally:
        for d in dbs:
            d.close()


def _on_card_pair(cols, mask, k, dev):
    """(kernel rows, kernel n, plain rows, plain n) of numpy keys."""
    want, want_n = TK.topk_select_plain(
        [(torch.from_numpy(c), a, f) for c, a, f in cols],
        torch.from_numpy(mask), k)
    got, got_n = TK.topk_select(
        [(torch.from_numpy(c).to(dev), a, f) for c, a, f in cols],
        torch.from_numpy(mask).to(dev), k)
    torch.cuda.synchronize()
    return got.cpu().tolist(), got_n, want.tolist(), want_n


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spread", "huge_tie", "constant",
                                  "sample_miss"])
@pytest.mark.parametrize("k", [10, 100, 65_536])
def test_cuda_topk_routes(case, k, cuda_device):
    """The candidate route (k <= the sort capacity: the finish block's
    sort; k = 65,536: the radix_argsort tail), with its phase launches
    over a tie set far above the finish block's share (huge_tie: ~16 %
    of the rows at 100.0, then ts), the rows route forced by a constant
    key, and pass 2 forced by a row outside the sampled tiles that widens
    the range by one bit (sample_miss: row 600, in the second tile, at
    70.0 over values near 50); each equal to the plain rows, the route and
    the passes over N counted."""
    rng = np.random.default_rng(k)
    n = (1 << 21) + 77
    ts = T0 + rng.permutation(n).astype(np.int64) * 10_000
    if case == "spread":
        v = rng.normal(50, 20, n).astype(np.float32)
    elif case == "huge_tie":
        v = np.clip(rng.normal(95, 5, n), 0, 100).astype(np.float32)
    elif case == "sample_miss":
        v = rng.normal(50, 1, n).astype(np.float32)
        v[600] = 70.0
    else:
        v = np.full(n, 7.0, np.float32)
    mask = rng.random(n) < 0.97
    mask[600] = True
    before = (TK.topk_select.candidates, TK.topk_select.rows,
              TK.full_passes())
    got, got_n, want, want_n = _on_card_pair(
        [(v, False, None), (ts, True, None)], mask, k, cuda_device)
    assert got == want and got_n == want_n
    cand = TK.topk_select.candidates - before[0]
    rows = TK.topk_select.rows - before[1]
    passes = TK.full_passes() - before[2]
    if case == "constant":
        assert (cand, rows) == (0, 1) and passes > 3
    else:
        assert (cand, rows, passes) == (1, 0,
                                        3 if case == "sample_miss" else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("overflow", [False, True])
def test_cuda_topk_unset_rows_in_key_order(overflow, cuda_device,
                                           monkeypatch):
    """k above the rows with the mask set: the unset rows that fill the
    answer come in full key order, NaN ranks included, on both routes.
    (The route before the candidate one sorted them by the value word
    alone, so unset NaN rows fell among the unset 0.0 rows.)"""
    if overflow:
        monkeypatch.setattr(TK, "candidate_capacity", lambda n: 0)
    rng = np.random.default_rng(4)
    n = 100_003
    v = rng.choice([np.nan, 1.0, 2.0, -0.0, 0.0], n).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, 50, replace=False)] = True
    for k in (40, 5000, n):
        got, got_n, want, want_n = _on_card_pair([(v, True, None)], mask, k,
                                                 cuda_device)
        assert got == want and got_n == want_n == min(50, k)
