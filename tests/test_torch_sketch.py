"""Port parity of the sketch aggregates (K18 ``hll_fold``, K19 ``udd_fold``).

The plain versions of ``ops/sketch_kernels.py`` are held to the JAX
reference's ``ops/sketch.py`` on the CPU, on the same inputs made from
numpy seeds: HLL registers, UDD keys, key extremes and bucket counts and
both merge folds exactly, over NaN, +-inf, negative and huge values.  Two
places where the reference's CPU arithmetic leaves its own docstrings are
shown and bounded (the port keeps the docstrings):

- the HLL rank: ``31 - floor(log2(float32(w)))`` differs from the exact
  leading-zero rank only for ``w`` within ``2^(k-8)`` of some ``2^k``;
- the UDDSketch collapse factor: ``exp2(ceil(log2(need)))`` is not a power
  of two for most ``need >= 5``; the port's is, and agrees wherever the
  reference's collapse is at most 4.

SQL parity (``hll``, ``uddsketch_state``, ``hll_count``, ``uddsketch_calc``
and the merges) runs both packages over one small table.  Tests marked
``cuda`` hold each kernel to its plain version on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import sketch as R
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.ops import sketch as P
from greptimedb_tpu_torch.ops import sketch_kernels as K
from greptimedb_tpu_torch.standalone import GreptimeDB

EDGE = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0 ** 31, -(2.0 ** 31),
                 2.0 ** 32 + 0.25, 9.2e18, -9.2e18, 9.3e18, -9.3e18, 1e300,
                 -1e300, 5e-324, np.nan, np.inf, -np.inf, 123456789.123456])


# XLA's CPU flushes subnormal doubles to zero, so the reference does not
# count 5e-324 as positive in udd_keys; the port does (its docstring's
# "positive finite values"): UDD parity runs without it
UDD_EDGE = EDGE[EDGE != 5e-324]


def _values(seed, n):
    rng = np.random.default_rng(seed)
    v = np.concatenate([
        rng.normal(0, 1e3, n // 4),
        rng.integers(-10 ** 6, 10 ** 6, n // 4).astype(np.float64),
        rng.lognormal(0, 4, n // 4),
        rng.uniform(-1e18, 1e18, n - 3 * (n // 4)),
    ])
    v[rng.integers(0, n, n // 50)] = np.nan
    v[: len(EDGE)] = EDGE
    return v


def _rows(seed, n, ng):
    rng = np.random.default_rng(seed + 1)
    return (rng.integers(0, ng, n).astype(np.int32), rng.random(n) < 0.9)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 7])
def test_hll_fold_registers_match_reference(seed, dtype):
    n, ng = 60_000, 13
    with np.errstate(over="ignore"):
        vals = _values(seed, n).astype(dtype)
    gid, mask = _rows(seed, n, ng)
    want = np.asarray(R.hll_fold(jnp.asarray(vals), jnp.asarray(gid), ng,
                                 jnp.asarray(mask)))
    got = P.hll_fold(_t(vals), _t(gid), ng, _t(mask)).numpy()
    assert got.dtype == np.int32 and got.shape == (ng, P.HLL_M)
    np.testing.assert_array_equal(got, want)


def test_hll_merge_fold_matches_reference():
    rng = np.random.default_rng(3)
    nv, n, ng = 9, 500, 6
    vocab = rng.integers(0, 30, (nv, P.HLL_M)).astype(np.int32)
    codes = rng.integers(-2, nv + 2, n).astype(np.int32)
    gid, mask = _rows(3, n, ng)
    want = np.asarray(R.hll_merge_fold(
        jnp.asarray(codes), jnp.asarray(vocab), jnp.asarray(gid), ng,
        jnp.asarray(mask)))
    got = P.hll_merge_fold(_t(codes), _t(vocab), _t(gid), ng,
                           _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def _reference_rank(w):
    top = jnp.floor(jnp.log2(jnp.maximum(jnp.asarray(w, jnp.int32), 1)
                             .astype(jnp.float32)))
    return np.asarray(jnp.where(jnp.asarray(w) > 0, 31 - top, 32)).astype(
        np.int64)


def test_hll_rank_differs_from_reference_only_near_powers_of_two():
    """The port's rank is the exact leading-zero count of the 31-bit
    word; the reference's f32 log2 rank leaves it only in the bands
    [2^k - 2^(k-8), 2^k + 2^(k-8)] (the top band is [2^31 - 2^23,
    2^31 - 1])."""
    rng = np.random.default_rng(5)
    bands = []
    inside = []
    for k in range(1, 32):
        r = 1 << max(k - 8, 0)
        lo, hi = (1 << k) - r, min((1 << k) + r, (1 << 31) - 1)
        bands.append((lo, hi))
        dense = np.arange(max(lo, 1), min(hi, lo + 4096) + 1)
        tail = rng.integers(lo, hi + 1, 4096) if hi - lo > 4096 else []
        near = np.arange(max((1 << k) - 300, 1), min((1 << k) + 300, hi + 1))
        inside.append(np.concatenate([dense, tail, near, [hi]]))
    inside = np.unique(np.concatenate(inside)).astype(np.int64)
    outside = rng.integers(1, 1 << 31, 400_000).astype(np.int64)
    in_band = np.zeros(len(outside), dtype=bool)
    for lo, hi in bands:
        in_band |= (outside >= lo) & (outside <= hi)
    outside = np.concatenate([[0], outside[~in_band]])
    exact = lambda w: 32 - np.array([int(x).bit_length() for x in w])  # noqa: E731
    for w in (inside, outside):
        port = (32 - K.bit_length(_t(w))).numpy()
        np.testing.assert_array_equal(port, exact(w))
    np.testing.assert_array_equal(_reference_rank(outside), exact(outside))
    differs = inside[_reference_rank(inside) != exact(inside)]
    for w in differs:
        assert any(lo <= w <= hi for lo, hi in bands), int(w)


@pytest.mark.parametrize("gamma_err", [0.01, 0.05])
def test_udd_keys_and_extremes_match_reference(gamma_err):
    n, ng = 50_000, 11
    rng = np.random.default_rng(8)
    vals = np.concatenate([rng.lognormal(0, 3, n - len(UDD_EDGE)),
                           UDD_EDGE])
    gid, mask = _rows(8, n, ng)
    gamma = R.udd_gamma(gamma_err)
    k_r, ok_r = R.udd_keys(jnp.asarray(vals), jnp.asarray(mask), gamma)
    k_p, ok_p = P.udd_keys(_t(vals), _t(mask), gamma)
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_r))
    ok = np.asarray(ok_r)
    np.testing.assert_array_equal(k_p.numpy()[ok], np.asarray(k_r)[ok])
    ext_r = R.udd_key_extremes(k_r, ok_r, jnp.asarray(gid), ng)
    ext_p = P.udd_key_extremes(k_p, ok_p, _t(gid), ng)
    for a, b in zip(ext_p, ext_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_udd_keys_count_subnormal_values():
    gamma = R.udd_gamma(0.01)
    vals = torch.tensor([5e-324, 2.2250738585072014e-308, 1e-310],
                        dtype=torch.float64)
    k, ok = P.udd_keys(vals, torch.ones(3, dtype=torch.bool), gamma)
    assert ok.all()
    want = [math.ceil(math.log(max(v, 1e-300)) / math.log(gamma))
            for v in vals.tolist()]
    assert k.tolist() == want


def test_udd_keys_at_gamma_powers_match_reference():
    gamma = R.udd_gamma(0.01)
    ks = np.arange(-300, 301)
    base = gamma ** ks.astype(np.float64)
    vals = np.concatenate([base, np.nextafter(base, 0), np.nextafter(
        base, np.inf)])
    mask = np.ones(len(vals), dtype=bool)
    k_r, _ = R.udd_keys(jnp.asarray(vals), jnp.asarray(mask), gamma)
    k_p, _ = P.udd_keys(_t(vals), _t(mask), gamma)
    np.testing.assert_array_equal(k_p.numpy(), np.asarray(k_r))


def test_udd_collapse_factor_is_a_power_of_two():
    """need in [1, 65535]: the port's c is the next power of two; the
    reference's exp2 agrees wherever need <= 4 (c <= 4)."""
    nb = 8
    need = np.arange(1, 65_536, dtype=np.int64)
    span = need * nb - 2
    kmin = np.zeros(len(need), dtype=np.int64)
    kmax = kmin + span - 1
    ng = len(need)
    one = np.zeros(1, dtype=np.int64)
    _counts, c_ref = R.udd_bucket_counts(
        jnp.asarray(one), jnp.asarray(one == 0), jnp.asarray(one.astype(
            np.int32)), ng, nb, jnp.asarray(kmin), jnp.asarray(kmax))
    c_ref = np.asarray(c_ref)
    c_port = K.udd_collapse_plain(_t(kmin), _t(kmax), nb).numpy()
    pow2 = 1 << np.array([int(x - 1).bit_length() for x in need])
    np.testing.assert_array_equal(c_port, pow2)
    small = need <= 4
    np.testing.assert_array_equal(c_ref[small], c_port[small])
    assert (c_ref[~small] != c_port[~small]).sum() > 0  # the reference's exp2


def _numpy_udd(vals, gid, mask, ng, gamma, nb):
    """The UDDSketch fold as its docstring states it, in numpy."""
    out = np.zeros((ng, nb + 2), dtype=np.int64)
    v = vals.astype(np.float64)
    ok = mask & (v > 0) & np.isfinite(v)
    k = np.ceil(np.log(np.where(ok, v, 1.0)) / math.log(gamma)).astype(
        np.int64)
    for g in range(ng):
        kg = k[ok & (gid == g)]
        if not len(kg):
            out[g, nb], out[g, nb + 1] = R._K_SENTINEL, 1
            continue
        lo, hi = int(kg.min()), int(kg.max())
        need = -(-(max(hi - lo + 1, 1) + 2) // nb)
        c = 1 << (need - 1).bit_length()
        base = (lo // c) * c
        idx = np.clip(-(-(kg - base) // c), 0, nb - 1)
        np.add.at(out[g], idx, 1)
        out[g, nb], out[g, nb + 1] = lo, c
    return out


@pytest.mark.parametrize("nb,spread", [(64, 0.5), (128, 1.0), (16, 3.0),
                                       (8, 6.0)])
def test_udd_fold_matches_reference_where_collapse_at_most_4(nb, spread):
    n, ng = 40_000, 9
    rng = np.random.default_rng(nb)
    vals = rng.lognormal(0, spread, n)
    vals[rng.integers(0, n, 300)] = np.nan
    vals[:len(UDD_EDGE)] = UDD_EDGE
    gid, mask = _rows(nb, n, ng)
    gamma = R.udd_gamma(0.01)
    want = np.asarray(R.udd_fold(jnp.asarray(vals), jnp.asarray(gid), ng,
                                 jnp.asarray(mask), gamma, nb))
    got = P.udd_fold(_t(vals), _t(gid), ng, _t(mask), gamma, nb).numpy()
    np.testing.assert_array_equal(got, _numpy_udd(vals, gid, mask, ng,
                                                  gamma, nb))
    np.testing.assert_array_equal(got[:, nb], want[:, nb])  # k_min
    small = got[:, nb + 1] <= 4
    np.testing.assert_array_equal(got[small], want[small])


def test_udd_merge_fold_matches_reference():
    rng = np.random.default_rng(4)
    nv, width, n, ng = 7, 40, 400, 5
    vocab = rng.integers(0, 50, (nv, width)).astype(np.int64)
    cfg = np.array([0, 1, 0, -1, 1, 0, 2], dtype=np.int32)
    codes = rng.integers(-1, nv + 1, n).astype(np.int32)
    gid, mask = _rows(4, n, ng)
    want = np.asarray(R.udd_merge_fold(
        jnp.asarray(codes), jnp.asarray(vocab), jnp.asarray(cfg),
        jnp.asarray(gid), ng, jnp.asarray(mask)))
    got = P.udd_merge_fold(_t(codes), _t(vocab), _t(cfg), _t(gid), ng,
                           _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_reference_states_decode_merge_and_estimate_alike():
    rng = np.random.default_rng(2)
    regs = [rng.integers(0, 20, R.HLL_M).astype(np.int32) for _ in range(3)]
    hs = [R.encode_hll(r) for r in regs]
    assert P.merge_hll_states(hs[0], hs[1]) == R.merge_hll_states(hs[0],
                                                                  hs[1])
    assert P.hll_estimate(P.decode_hll(hs[2])) == R.hll_estimate(regs[2])
    g = R.udd_gamma(0.02)
    rows = [np.concatenate([rng.integers(0, 9, 32), [k, c]])
            for k, c in ((-40, 1), (100, 2), (-3, 4))]
    us = [R.encode_udd(r, g, 32) for r in rows]
    assert us == [P.encode_udd(r, g, 32) for r in rows]
    for a in us:
        assert P.decode_udd(a) == R.decode_udd(a)
        for b in us:
            assert P.merge_udd_states(a, b) == R.merge_udd_states(a, b)
        for q in (0.0, 0.25, 0.5, 0.99, 1.0):
            assert P.udd_quantile(a, q) == R.udd_quantile(a, q)


SKETCH_SQL = [
    "SELECT h, hll(v), uddsketch_state(128, 0.01, v) FROM t GROUP BY h "
    "ORDER BY h",
    "SELECT h, hll_count(hll(v)), uddsketch_calc(0.9, uddsketch_state(64, "
    "0.02, v)) FROM t GROUP BY h ORDER BY h",
    "SELECT hll(v), uddsketch_state(32, 0.05, v) FROM t",
    "SELECT d, hll_count(hll_merge(hs)), uddsketch_calc(0.5, "
    "uddsketch_merge(us)) FROM st GROUP BY d ORDER BY d",
    "SELECT hll_merge(hs), uddsketch_merge(us) FROM st",
]


@pytest.mark.parametrize("sorted_mode", ["force", "off"])
def test_sketch_queries_match_reference(sorted_mode, monkeypatch):
    monkeypatch.setenv("GREPTIME_GRID", "off")
    monkeypatch.setenv("GREPTIME_SORTED_SEGMENTS", sorted_mode)
    rng = np.random.default_rng(17)
    rows = []
    for i in range(600):
        h = f"h{rng.integers(0, 12)}"
        v = "NULL" if i % 37 == 0 else f"{rng.integers(1, 100) / 4}"
        rows.append(f"('{h}', {1000 * i}, {v})")
    dbs = (GreptimeDB(device="cpu"), RefDB())
    try:
        results = []
        for d in dbs:
            d.sql("CREATE TABLE t (h STRING, ts TIMESTAMP(3) TIME INDEX, "
                  "v DOUBLE, PRIMARY KEY (h))")
            d.sql("INSERT INTO t VALUES " + ", ".join(rows))
            d.sql("CREATE TABLE st (h STRING, d STRING, ts TIMESTAMP(3) "
                  "TIME INDEX, hs STRING, us STRING, PRIMARY KEY (h, d))")
            d.sql("INSERT INTO st SELECT h, substr(h, 1, 2), 1000, hll(v), "
                  "uddsketch_state(64, 0.02, v) FROM t GROUP BY h")
            results.append([d.sql(q).rows for q in SKETCH_SQL])
        assert results[0] == results[1]
    finally:
        for d in dbs:
            d.close()


# ---- on the card ------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_hll_fold_matches_plain(cuda_device, dtype):
    n, ng = 300_000, 37
    vals = _t(_values(1, n)).to(dtype)
    gid, mask = (_t(a) for a in _rows(1, n, ng))
    want = K.hll_fold_plain(vals, gid, ng, mask)
    got = K.hll_fold(vals.to(cuda_device), gid.to(cuda_device), ng,
                     mask.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    vocab = want[torch.randperm(ng, generator=torch.Generator().manual_seed(
        0))]
    codes = torch.randint(-1, ng + 1, (5000,), dtype=torch.int32)
    g2, m2 = (_t(a) for a in _rows(2, 5000, 11))
    want = K.hll_merge_plain(codes, vocab, g2, 11, m2)
    got = K.hll_merge(codes.to(cuda_device), vocab.to(cuda_device),
                      g2.to(cuda_device), 11, m2.to(cuda_device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,spread", [(128, 1.0), (8, 6.0)])
def test_cuda_udd_fold_matches_plain(cuda_device, nb, spread):
    n, ng = 300_000, 37
    rng = np.random.default_rng(nb)
    vals = rng.lognormal(0, spread, n)
    vals[:len(EDGE)] = EDGE
    gid, mask = _rows(3, n, ng)
    gamma = P.udd_gamma(0.01)
    want = K.udd_fold_plain(_t(vals), _t(gid), ng, _t(mask), gamma, nb)
    for dt in (torch.float64, torch.float32):
        v = _t(vals).to(dt)
        want = K.udd_fold_plain(v, _t(gid), ng, _t(mask), gamma, nb)
        got = K.udd_fold(v.to(cuda_device), _t(gid).to(cuda_device), ng,
                         _t(mask).to(cuda_device), gamma, nb)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    vocab = torch.randint(0, 99, (9, 70), dtype=torch.int64)
    cfg = torch.tensor([0, 1, 0, -1, 1, 0, 2, 0, 0], dtype=torch.int32)
    codes = torch.randint(-1, 10, (4000,), dtype=torch.int32)
    g2, m2 = (_t(a) for a in _rows(5, 4000, 13))
    want = K.udd_merge_plain(codes, vocab, cfg, g2, 13, m2)
    got = K.udd_merge(codes.to(cuda_device), vocab.to(cuda_device),
                      cfg.to(cuda_device), g2.to(cuda_device), 13,
                      m2.to(cuda_device))
    assert torch.equal(got.cpu(), want)
