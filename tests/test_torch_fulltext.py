"""Port parity of the fingerprint index (K16 ``fp_candidates``).

The port's host copies (``fulltext/fingerprint.py``) and its resident
cache (``fulltext/resident.py``, on the ``fp_candidates`` kernel's plain
version here) are held to the JAX reference on the CPU, on the same inputs
made from numpy seeds, and every comparison is exact: the canonical text
over the unicode case-fold edges (İ/ı/ß/ſ/K/Σ), fingerprint rows, literal
extraction and query masks, the candidate flags against the reference's
jitted ``_candidate_kernel`` for W in {2, 16, 64} and k in {1, 3, 16}, and
the cache's verified memos, code sets, line-filter vectors and byte
lengths across a vocabulary tail extension, with the knob off and the
null-coercion variants.  SQL text predicates (LIKE / ILIKE / regex / =
/ matches / matches_term / matches_score) give the reference's rows, with
the prefilter on and off.  Tests marked ``cuda`` hold the kernel to its
plain version on the card.
"""

import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.fulltext import fingerprint as RF
from greptimedb_tpu.fulltext import resident as RR
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu.storage.index import ft_predicate as ref_ft_predicate
from greptimedb_tpu_torch.fulltext import fingerprint as PF
from greptimedb_tpu_torch.fulltext import resident as PR
from greptimedb_tpu_torch.ops import fulltext_kernels as FK
from greptimedb_tpu_torch.standalone import GreptimeDB
from greptimedb_tpu_torch.storage.index import ft_predicate
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

# case-fold edges, CJK, emoji and separators (tests/test_fulltext.py's)
ALPHABET = (list("abcdefgXYZ0123456789 _-./=:%[]()?*+|")
            + ["İ", "ı", "ß", "ſ", "K", "é", "Σ", "σ", "ς", "日", "誌",
               "テ", "🎉"])
UNICODE = ["İstanbul", "dotless ı", "straße", "ſoft", "K elvin", "ΣΑΣ ς",
           "i̇", "İı", "STRASSE", "", "error: conn reset", "日誌 テスト 🎉"]


def _texts(seed: int, n: int, maxlen: int = 40) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(ALPHABET[i] for i in rng.integers(0, len(ALPHABET),
                                                      rng.integers(0, maxlen)))
            for _ in range(n)]


def _vocab(seed: int, n: int) -> list[str]:
    return list(dict.fromkeys(_texts(seed, n) + UNICODE))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# ---- host math -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_canonical_text_matches_reference(seed):
    for s in UNICODE + _texts(seed, 200):
        assert PF.canonical_text(s) == RF.canonical_text(s), s


@pytest.mark.parametrize("words,mg", [(2, 2), (16, 2), (16, 3), (64, 2)])
def test_build_fingerprints_matches_reference(words, mg):
    vals = _vocab(words + mg, 300) + [None, 12, 3.5]
    got = PF.build_fingerprints(vals, words, mg)
    want = RF.build_fingerprints(vals, words, mg)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


SPECS = [("eq", "abc"), ("eq", ""), ("contains", "x"), ("prefix", "GET"),
         ("like", "%err%or_"), ("like", "%%"), ("ilike", "%İstan%"),
         ("regex", "conn reset"), ("regex", "a(bc)d"),
         ("regex", "err(or|ed) hard"), ("regex", "(abc)+x"),
         ("regex", "a*b?c[de]f"), ("regex", "^anchored$"),
         ("regex", "deadline exceeded|connection refused"),
         ("regex", "(a|b|c|d|e)(f|g|h|i)x"), ("regex", "[unclosed"),
         ("iregex", "ıssız"), ("matches", "hello v1.0"), ("matches", "..."),
         ("matches_term", "refused"), ("other", "x")]


@pytest.mark.parametrize("words,mg", [(8, 2), (16, 3)])
def test_spec_and_masks_match_reference(words, mg):
    for kind, text in SPECS:
        spec = PF.spec_for(kind, text)
        assert spec == RF.spec_for(kind, text), (kind, text)
        got = PF.compile_masks(spec, words, mg)
        want = RF.compile_masks(spec, words, mg)
        if want is None:
            assert got is None, (kind, text)
        else:
            np.testing.assert_array_equal(got, want)
    for lit in UNICODE:
        np.testing.assert_array_equal(PF.literal_mask(lit, words, mg),
                                      RF.literal_mask(lit, words, mg))


def _candidate_case(seed: int, npad: int, words: int, k: int):
    """A fingerprint matrix of dense random rows and k masks, each the
    bits of a few random rows' words (so some rows hold every bit)."""
    rng = np.random.default_rng(seed)
    fp = (rng.integers(0, 1 << 32, (npad, words), dtype=np.uint64)
          | rng.integers(0, 1 << 32, (npad, words), dtype=np.uint64)
          ).astype(np.uint32)
    masks = np.zeros((k, words), np.uint32)
    for a in range(k):
        src = fp[rng.integers(0, npad)]
        keep = rng.integers(0, 1 << 32, words, dtype=np.uint64).astype(
            np.uint32) & rng.integers(0, 1 << 32, words,
                                      dtype=np.uint64).astype(np.uint32)
        masks[a] = src & keep
    return fp, masks


@pytest.mark.parametrize("words", [2, 16, 64])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_fp_candidates_plain_matches_reference(words, k):
    fp, masks = _candidate_case(words * 100 + k, 512, words, k)
    want = np.asarray(RR._candidate_kernel(jnp.asarray(fp),
                                           jnp.asarray(masks)))
    got = FK.fp_candidates(torch.from_numpy(fp.view(np.int32)),
                           torch.from_numpy(masks.view(np.int32)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_fp_candidates_without_masks_is_all_true():
    fp = torch.zeros((8, 4), dtype=torch.int32)
    assert FK.fp_candidates(fp, None).all()
    with pytest.raises(ValueError):
        FK.fp_candidates(fp.to(torch.int64), None)
    with pytest.raises(ValueError):
        FK.fp_candidates(fp, torch.zeros((1, 3), dtype=torch.int32))


# ---- the resident cache ------------------------------------------------------

def _preds(seed: int, corpus):
    """Predicates of every routed kind with their host truth, as
    query/exprs.py, servers/logquery.py and fulltext/loki.py define it:
    (kind, text, reference predicate, port predicate)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        src = corpus[int(rng.integers(len(corpus)))]
        i = int(rng.integers(max(len(src), 1)))
        frag = src[i:i + int(rng.integers(1, 8))] or "a"
        out.append(("contains", frag, lambda v, t=frag: t in str(v)))
        pat = f"%{frag}%"
        body = "".join(".*" if c == "%" else re.escape(c) for c in pat)
        rx = re.compile("^" + body + "$")
        out.append(("like", pat, lambda v, rx=rx: rx.match(str(v)) is not None))
        rxi = re.compile("^" + body + "$", re.IGNORECASE)
        out.append(("ilike", pat,
                    lambda v, rx=rxi: rx.match(str(v)) is not None))
        frag2 = _texts(seed + 1, 1, 6)[0]
        for rtext in (re.escape(frag) + ".*" + re.escape(frag2),
                      f"({re.escape(frag)}|{re.escape(frag2)})x?"):
            rr = re.compile(rtext)
            out.append(("regex", rtext,
                        lambda v, rr=rr: rr.search(str(v)) is not None))
        out.append(("eq", src, lambda v, s=src: str(v) == s))
        q = " ".join(frag.split()[:2]) or frag
        out.append(("matches", q, q))
    return [(kind, text,
             (lambda v, p=ref_ft_predicate("matches", pred): p(str(v)))
             if kind == "matches" else pred,
             (lambda v, p=ft_predicate("matches", pred): p(str(v)))
             if kind == "matches" else pred)
            for kind, text, pred in out]


@pytest.mark.parametrize("seed", [3, 4])
def test_cache_matches_reference_across_vocab_extension(seed):
    """verified_bools / codes_matching / line_filter_vector /
    byte_lengths of the port's cache equal the reference cache's, on the
    first vocabulary and after it grows by a tail within one lineage (the
    matrix extends in place and the memos verify only the tail)."""
    ref, port = RR.FulltextIndexCache(), PR.FulltextIndexCache()
    table = types.SimpleNamespace(dicts_root=seed + 1)
    vocab = _vocab(seed, 60)
    preds = _preds(seed, vocab)
    for step in range(2):
        if step:
            vocab = vocab + _vocab(seed + 50, 40) + ["errör ☠", None]
        for kind, text, rpred, ppred in preds:
            want = ref.verified_bools("t", table, "line", vocab, rpred,
                                      kind, text)
            got = port.verified_bools("t", table, "line", vocab, ppred,
                                      kind, text)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, RR._host_verified(vocab, rpred))
            np.testing.assert_array_equal(
                port.codes_matching("t", table, "line", vocab, ppred, kind,
                                    text),
                ref.codes_matching("t", table, "line", vocab, rpred, kind,
                                   text))
        filters = [(k, t, p, i % 2 == 1)
                   for i, (k, t, _r, p) in enumerate(preds[:4])]
        rfilters = [(k, t, r, i % 2 == 1)
                    for i, (k, t, r, _p) in enumerate(preds[:4])]
        gv, gn = port.line_filter_vector("t", table, "line", vocab, filters)
        wv, wn = ref.line_filter_vector("t", table, "line", vocab, rfilters)
        assert gn == wn and gv.dtype == torch.bool
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        npad = PR._pow2(len(vocab))
        np.testing.assert_array_equal(
            port.byte_lengths("t", table, "line", vocab, npad).numpy(),
            np.asarray(ref.byte_lengths("t", table, "line", vocab, npad)))
    # the resident matrix covers the grown vocabulary, bit for bit
    e = port._lru[("fp", "t", "line")]
    assert e.n == len(vocab)
    np.testing.assert_array_equal(
        e.dev[:e.n].numpy().view(np.uint32),
        RF.build_fingerprints(vocab, e.words, e.mg))
    assert port.stats()["builds"] > 0


def test_fingerprint_tail_extends_in_place():
    cache = PR.FulltextIndexCache()
    vocab = list(dict.fromkeys(_texts(9, 20)))
    e0 = cache._fingerprints("t", 7, "line", vocab)
    grown = vocab + ["fresh tail 1", "fresh tail 2"]
    assert len(grown) <= e0.npad
    e1 = cache._fingerprints("t", 7, "line", grown)
    assert e1.dev is e0.dev and e1.n == len(grown)
    np.testing.assert_array_equal(
        e1.dev[:e1.n].numpy().view(np.uint32),
        PF.build_fingerprints(grown, e1.words, e1.mg))
    # a new lineage root rebuilds
    e2 = cache._fingerprints("t", 8, "line", grown)
    assert e2.dev is not e0.dev and e2.root == 8


def test_knob_off_returns_none(monkeypatch):
    monkeypatch.setenv("GREPTIME_FULLTEXT", "off")
    cache = PR.FulltextIndexCache()
    table = types.SimpleNamespace(dicts_root=1)
    assert cache.verified_bools("t", table, "c", ["a"], lambda v: True,
                                "eq", "a") is None
    assert cache.codes_matching("t", table, "c", ["a"], lambda v: True,
                                "eq", "a") is None
    assert cache.line_filter_vector("t", table, "c", ["a"], []) is None
    assert cache.byte_lengths("t", table, "c", ["a"], 1) is None
    assert len(cache) == 0


@pytest.mark.parametrize("first", ["sql", "dsl"])
def test_null_coercion_variants_do_not_share_memos(first):
    """The SQL subject of a None entry is str(None) while the log-query
    DSL coerces it to "": the ``variant`` key keeps their memos apart in
    both warm orders, as in the reference."""
    results = []
    for mod in (PR, RR):
        cache = mod.FulltextIndexCache()
        vocab = [None, "has None inside", "other"]
        table = types.SimpleNamespace(dicts_root=4)
        rx = re.compile("None")
        sql_pred = lambda v: rx.search(str(v)) is not None  # noqa: E731
        dsl_pred = lambda v: rx.search(  # noqa: E731
            "" if v is None else str(v)) is not None

        def run_sql():
            return cache.verified_bools("t", table, "c", vocab, sql_pred,
                                        "regex", "None")

        def run_dsl():
            return cache.verified_map("t", table, "c", vocab, dsl_pred,
                                      "regex", "None", variant="dsl")

        (run_sql if first == "sql" else run_dsl)()
        results.append((run_sql().tolist(), run_dsl()))
    assert results[0] == results[1]
    assert results[0] == ([True, True, False],
                          {"": False, "has None inside": True,
                           "other": False})


def test_quota_reject_falls_back_without_wrong_results():
    cache = PR.FulltextIndexCache(capacity_bytes=1)  # nothing admits
    vocab = ["alpha error", "beta", "gamma error"]
    table = types.SimpleNamespace(dicts_root=3)
    got = cache.verified_bools("t", table, "line", vocab,
                               lambda v: "error" in str(v), "contains",
                               "error")
    assert got.tolist() == [True, False, True]
    assert cache.bytes == 0 and cache.stats()["rejects"] > 0


# ---- SQL text predicates -----------------------------------------------------

def _sql_corpus(seed: int):
    lines = _texts(seed, 120) + ["", "error: conn reset by peer",
                                  "İstanbul ıssız ſtraße", "日誌 テスト 🎉",
                                  "connection refused", "queue overflow"]
    stmts = ["CREATE TABLE fuzz_logs (app STRING, ts TIMESTAMP TIME INDEX, "
             "line STRING, PRIMARY KEY(app)) WITH (append_mode='true')"]
    for i, line in enumerate(lines):
        line = line.replace("'", "").replace("\\", "")
        lit = "NULL" if i % 17 == 13 else f"'{line}'"
        stmts.append(f"INSERT INTO fuzz_logs VALUES ('a{i % 3}', "
                     f"{1700000000000 + i}, {lit})")
    rng = np.random.default_rng(seed)
    frags = []
    for line in lines:
        if len(line) > 4:
            i = int(rng.integers(max(len(line) - 3, 1)))
            frags.append(line[i:][:4].replace("'", "").replace("\\", ""))
    frags = frags[:8] + ["err", "テ", "ıs", "refused"]
    queries = []
    for f in frags:
        queries += [
            f"SELECT ts FROM fuzz_logs WHERE line LIKE '%{f}%' ORDER BY ts",
            f"SELECT ts FROM fuzz_logs WHERE line ILIKE '%{f.upper()}%' "
            "ORDER BY ts",
            f"SELECT count(*) FROM fuzz_logs WHERE matches(line, '{f}')",
            f"SELECT ts FROM fuzz_logs WHERE line ~ '{re.escape(f)}' "
            "ORDER BY ts",
        ]
    queries += [
        "SELECT count(*) FROM fuzz_logs WHERE matches_term(line, 'refused')",
        "SELECT ts FROM fuzz_logs WHERE line = 'queue overflow'",
        "SELECT count(*) FROM fuzz_logs WHERE line != 'queue overflow'",
        "SELECT ts FROM fuzz_logs WHERE app LIKE 'a%' AND line LIKE "
        "'%conn%' ORDER BY ts",
        "SELECT ts, matches_score(line, 'conn reset') FROM fuzz_logs "
        "WHERE matches(line, 'conn') ORDER BY ts",
        "SELECT count(*) FROM fuzz_logs WHERE matches(line, '...')",
    ]
    return stmts, queries


@pytest.mark.parametrize("seed", [42, 4242])
def test_sql_text_predicates_match_reference(monkeypatch, seed):
    stmts, queries = _sql_corpus(seed)
    port, ref = GreptimeDB(device="cpu"), RefDB()
    try:
        for s in stmts:
            port.sql(s)
            ref.sql(s)
        want = {q: ref.sql(q).rows for q in queries}
        p0 = REGISTRY.value("greptime_fulltext_queries_total",
                            ("prefilter",))
        for q in queries:
            assert port.sql(q).rows == want[q], q
        assert REGISTRY.value("greptime_fulltext_queries_total",
                              ("prefilter",)) > p0
        assert any(k[0] == "fp" for k in
                   port.engine.executor.fulltext_cache._lru)
        monkeypatch.setenv("GREPTIME_FULLTEXT", "off")
        for q in queries:
            assert port.sql(q).rows == want[q], q
    finally:
        port.close()
        ref.close()


# ---- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("words", [2, 16, 64])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_cuda_fp_candidates_matches_plain(cuda_device, words, k):
    fp, masks = _candidate_case(words * 100 + k, 5000, words, k)
    fpt = torch.from_numpy(fp.view(np.int32))
    mt = torch.from_numpy(masks.view(np.int32))
    want = FK.fp_candidates_plain(fpt, mt)
    n0 = FK.fp_candidates.launches
    got = FK.fp_candidates(fpt.to(cuda_device), mt.to(cuda_device))
    torch.cuda.synchronize()
    assert FK.fp_candidates.launches == n0 + 1
    assert torch.equal(got.cpu(), want)
    # an unaligned view takes the scalar loads
    got = FK.fp_candidates(fpt.to(cuda_device)[1:], mt.to(cuda_device))
    assert torch.equal(got.cpu(), want[1:])


@pytest.mark.cuda
def test_cuda_sql_text_predicates_match_cpu(cuda_device):
    stmts, queries = _sql_corpus(7)
    dbs = (GreptimeDB(device="cuda"), GreptimeDB(device="cpu"))
    try:
        for s in stmts:
            for d in dbs:
                d.sql(s)
        n0 = FK.fp_candidates.launches
        for q in queries:
            assert dbs[0].sql(q).rows == dbs[1].sql(q).rows, q
        assert FK.fp_candidates.launches > n0
    finally:
        for d in dbs:
            d.close()
