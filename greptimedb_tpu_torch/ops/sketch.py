"""Approximate sketch aggregates: HyperLogLog and UDDSketch.

Torch counterpart of the reference's ``ops/sketch.py`` (reference:
src/common/function/src/aggrs/approximate/{hll,uddsketch}.rs +
scalars/hll_count.rs).  The sketches are segment reductions:

- ``hll(x)``: hash rows elementwise, scatter-MAX the leading-zero ranks
  into a [groups, 4096] register grid;
- ``uddsketch_state(limit, err, x)``: log-gamma bucket index elementwise,
  scatter-ADD into a [groups, buckets] grid.

The device folds run through ``ops/sketch_kernels.py`` (the hand-written
``hll_fold`` and ``udd_fold`` kernels and their merge modes).  States
serialize as small base64 strings so they can be stored in tables and
re-aggregated later: ``hll_merge``/``uddsketch_merge`` decode every
DISTINCT stored state into a dense matrix and merge on the device with
the same kernels.  The host codecs below are copies of the reference's,
so states written by either package decode, merge and estimate alike.
"""

from __future__ import annotations

import base64
import json
import math
import zlib

import numpy as np

from greptimedb_tpu_torch.ops import sketch_kernels as _k
from greptimedb_tpu_torch.ops.cuda_build import on_cpu as _on_cpu

HLL_PRECISION = _k.HLL_PRECISION
HLL_M = _k.HLL_M  # 4096 registers, ~1.6% standard error
_K_SENTINEL = _k.K_SENTINEL


def hll_fold(vals, gid, ng: int, mask):
    """[ng, HLL_M] int32 register grid (max leading-zero rank + 1) — the
    ``hll_fold`` kernel."""
    return _k.hll_fold(vals, gid, ng, mask)


def hll_merge_fold(codes, vocab_regs, gid, ng: int, mask):
    """Merge stored states: each row's register vector by its dictionary
    code, max-merged per group → [ng, HLL_M] (``hll_fold``'s merge
    mode)."""
    return _k.hll_merge(codes, vocab_regs, gid, ng, mask)


def _host_step(what: str, *tensors) -> None:
    if not _on_cpu(what, *tensors):
        raise ValueError(f"{what}: runs inside the udd_fold kernel on the "
                         "card; call udd_fold")


def udd_keys(vals, mask, gamma: float):
    """(base-gamma bucket key per row, validity).  Key k covers
    (gamma^(k-1), gamma^k]; only positive finite values count.  CPU only:
    on the card the keys live inside ``udd_fold``."""
    _host_step("udd_keys", vals, mask)
    return _k.udd_keys_plain(vals, mask, gamma)


def udd_key_extremes(k, ok, gid, ng: int):
    """Per-group (k_min, k_max) with empty-group sentinels (CPU only)."""
    _host_step("udd_key_extremes", k, ok, gid)
    return _k.udd_key_extremes_plain(k, ok, gid, ng)


def udd_bucket_counts(k, ok, gid, ng: int, nb: int, kmin, kmax):
    """([ng, nb] counts, [ng] collapse c) from per-group key extremes (CPU
    only).  A group whose key span exceeds nb COLLAPSES, buckets widening
    to c = 2^j base keys (gamma_eff = gamma^c), c the least power of two
    >= ceil((span + 2) / nb); the grid starts at base = floor(k_min / c) *
    c, so collapsed buckets align to absolute multiples of c and states
    remain mergeable in base-gamma key space; base key k belongs to
    bucket ceil(k / c)."""
    _host_step("udd_bucket_counts", k, ok, gid, kmin, kmax)
    return _k.udd_bucket_counts_plain(k, ok, gid, ng, nb, kmin, kmax)


def udd_fold(vals, gid, ng: int, mask, gamma: float, nb: int):
    """[ng, nb+2] int64: bucket counts + (k_min, collapse c) — the
    ``udd_fold`` kernel."""
    return _k.udd_fold(vals, gid, ng, mask, gamma, nb)


def udd_merge_fold(codes, vocab_counts, cfg_ids, gid, ng: int, mask):
    """[ng, nb+2]: merged bucket counts plus per-group (min, max) of the
    selected rows' sketch-config ids (``udd_fold``'s merge mode).  Mixing
    configs is only an error when the rows a query ACTUALLY selects mix
    them — the host codec checks min==max per group."""
    return _k.udd_merge(codes, vocab_counts, cfg_ids, gid, ng, mask)


def hll_estimate(regs: np.ndarray) -> float:
    """Standard HLL estimator with linear-counting small-range bias fix."""
    m = float(HLL_M)
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / float(np.sum(np.power(2.0, -regs.astype(float))))
    zeros = int(np.sum(regs == 0))
    if est <= 2.5 * m and zeros > 0:
        est = m * math.log(m / zeros)
    return est


def encode_hll(regs: np.ndarray) -> str:
    raw = zlib.compress(regs.astype(np.uint8).tobytes(), 1)
    return "HLL1:" + base64.b64encode(raw).decode()


def decode_hll(state: str) -> np.ndarray | None:
    if not isinstance(state, str) or not state.startswith("HLL1:"):
        return None
    try:
        raw = zlib.decompress(base64.b64decode(state[5:]))
        regs = np.frombuffer(raw, dtype=np.uint8)
        if len(regs) != HLL_M:
            return None
        return regs.astype(np.int32)
    except Exception:  # noqa: BLE001 — malformed state → NULL
        return None



# ---- UDDSketch host codecs -------------------------------------------

def udd_gamma(error_rate: float) -> float:
    if not 0.0 < error_rate < 1.0:
        raise ValueError(f"error_rate {error_rate} out of (0, 1)")
    return (1.0 + error_rate) / (1.0 - error_rate)


def encode_udd_doc(sparse: dict[int, int], gamma_base: float, c: int,
                   nb: int) -> str:
    """State doc: keys are ABSOLUTE γ_eff-unit bucket indices where
    γ_eff = γ_base^c (c = collapse factor, a power of two)."""
    doc = json.dumps({
        "g": round(gamma_base ** c, 12), "gb": round(gamma_base, 12),
        "x": int(c), "n": int(nb),
        "c": {int(k): int(v) for k, v in sparse.items()},
    }, separators=(",", ":"))
    return "UDD1:" + base64.b64encode(doc.encode()).decode()


def encode_udd(row: np.ndarray, gamma_base: float, nb: int) -> str:
    """[counts..., k_min, c] fold row → state string."""
    counts, kmin, c = row[:nb], int(row[nb]), max(int(row[nb + 1]), 1)
    if kmin >= _K_SENTINEL:  # no valid values in the group
        return encode_udd_doc({}, gamma_base, 1, nb)
    base = (kmin // c) * c
    sparse = {base // c + int(i): int(v)
              for i, v in enumerate(counts) if v}
    return encode_udd_doc(sparse, gamma_base, c, nb)


def decode_udd(state: str):
    """→ (gamma_eff, gamma_base, c, nb, {key: count}) or None."""
    if not isinstance(state, str) or not state.startswith("UDD1:"):
        return None
    try:
        doc = json.loads(base64.b64decode(state[5:]))
        g = float(doc["g"])
        return (g, float(doc.get("gb", g)), int(doc.get("x", 1)),
                int(doc["n"]),
                {int(k): int(v) for k, v in doc["c"].items()})
    except Exception:  # noqa: BLE001
        return None


def merge_hll_states(a: str | None, b: str | None) -> str | None:
    """Merge two encoded HLL states (register-wise max) — the host side of
    the distributed exchange (reference hll.rs merge_batch); None-tolerant
    so empty shards pass through."""
    ra = decode_hll(a) if a is not None else None
    rb = decode_hll(b) if b is not None else None
    if ra is None:
        return b if rb is not None else None
    if rb is None:
        return a
    return encode_hll(np.maximum(ra, rb))


def merge_udd_states(a: str | None, b: str | None) -> str | None:
    """Merge two encoded UDDSketch states.  Both must share (γ_base, nb);
    the coarser collapse factor wins and the finer state re-keys into it
    (bucket k at factor c1 maps wholly into ceil(k·c1/c2) at c2 ≥ c1
    because c2 is a multiple of c1 — see udd_fold's alignment invariant).
    If the union still exceeds nb distinct keys, collapse doubles until
    it fits, exactly like reference uddsketch compaction."""
    da = decode_udd(a) if a is not None else None
    db = decode_udd(b) if b is not None else None
    if da is None:
        return b if db is not None else None
    if db is None:
        return a
    _ga, gba, ca, nba, ka = da
    _gb, gbb, cb, nbb, kb = db
    if round(gba, 9) != round(gbb, 9) or nba != nbb:
        raise ValueError(
            "uddsketch merge: states built with different (error_rate, "
            "bucket_limit) configs")
    if not ka:
        return b
    if not kb:
        return a

    def rekey(counts: dict[int, int], c_from: int, c_to: int) -> dict:
        if c_from == c_to:
            return dict(counts)
        m = c_to // c_from
        out: dict[int, int] = {}
        for k, v in counts.items():
            out[-((-k) // m)] = out.get(-((-k) // m), 0) + v
        return out

    c = max(ca, cb)
    merged = rekey(ka, ca, c)
    for k, v in rekey(kb, cb, c).items():
        merged[k] = merged.get(k, 0) + v
    while len(merged) > nba:
        c *= 2
        merged = rekey(merged, c // 2, c)
    return encode_udd_doc(merged, gba, c, nba)


def udd_quantile(state: str, q: float) -> float | None:
    """uddsketch_calc: value estimate at quantile q ∈ [0, 1]."""
    dec = decode_udd(state)
    if dec is None or not 0.0 <= q <= 1.0:
        return None
    gamma, _gb, _c, _nb, counts = dec
    total = sum(counts.values())
    if total == 0:
        return None
    target = q * (total - 1)
    seen = 0
    for k in sorted(counts):
        seen += counts[k]
        if seen > target:
            # bucket k covers (γ^(k-1), γ^k]; midpoint estimator
            return 2.0 * gamma ** k / (gamma + 1.0)
    k = max(counts)
    return 2.0 * gamma ** k / (gamma + 1.0)
