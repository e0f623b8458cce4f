"""Fingerprint math: vectorized n-gram bloom rows + required-literal
extraction.

The fingerprint of a string is a W-word (uint32) bloom over the byte
n-grams (lengths ``min_gram..3``) of its CANONICAL form (casefold + the
dotless-i normalization below).  A query predicate that REQUIRES some
literal substrings compiles to one mask per OR-alternative: a row can
match only if every bit of some alternative's mask is set — that test is
the one bitwise device kernel the prefilter runs.

Soundness (the property the parity fuzz pins): a mask bit is derived
only from substrings that every matching string must contain, so the
candidate set is always a superset of the true matches.  Extraction that
cannot prove a requirement returns no constraint (weaker pruning), never
a wrong one.

Hashing follows the storage/index.py discipline (cheap integer mixes
over UTF-8 bytes, per-gram-length salts) but uses a vectorizable FNV-1a
instead of crc32 so a million rows build in one numpy pass — the matrix
is rebuilt from the resident dictionaries, never persisted, so the hash
needs no cross-version stability.
"""

from __future__ import annotations

import os
import re

import numpy as np

# --- configuration knobs ---------------------------------------------------

MAX_GRAM = 3
_FNV = np.uint32(16777619)
_FNV_BASIS = np.uint32(2166136261)


def enabled() -> bool:
    """`GREPTIME_FULLTEXT=off` disables every fingerprint/prefilter path
    (callers fall back to the host predicate loops byte-for-byte)."""
    return os.environ.get("GREPTIME_FULLTEXT", "on").lower() not in (
        "off", "0", "false")


def words_per_row() -> int:
    """`GREPTIME_FULLTEXT_WORDS`: uint32 words per fingerprint row
    (W*32 bloom bits; more words = fewer false positives, more HBM)."""
    try:
        w = int(os.environ.get("GREPTIME_FULLTEXT_WORDS", "16"))
    except ValueError:
        w = 16
    return max(2, min(w, 64))


def min_gram() -> int:
    """`GREPTIME_FULLTEXT_MIN_GRAM`: shortest indexed gram (2 or 3).
    2 doubles build work but lets two-character literals prune."""
    try:
        g = int(os.environ.get("GREPTIME_FULLTEXT_MIN_GRAM", "2"))
    except ValueError:
        g = 2
    return max(2, min(g, MAX_GRAM))


# --- canonical text form ---------------------------------------------------
#
# casefold() is applied per code point, so exact containment survives it
# (s ⊆ t ⇒ fold(s) ⊆ fold(t)); case-insensitive regex matching collapses
# onto it too EXCEPT the i/ı sre equivalence pair, whose casefolds
# diverge ('ı'.casefold() == 'ı') — both members (and İ's fold "i̇")
# normalize to plain 'i', trading a false positive for the false negative
# that would break bit-exactness.


def canonical_text(s: str) -> str:
    s = s.casefold()
    if "ı" in s:
        s = s.replace("ı", "i")
    if "i̇" in s:
        s = s.replace("i̇", "i")
    return s


# --- vectorized gram hashing ----------------------------------------------


def _gram_hashes(buf: np.ndarray, row: np.ndarray, g: int):
    """Rolling FNV-1a of every length-``g`` byte window that stays inside
    one row of the concatenated buffer; returns (rows, hashes uint32)."""
    m = len(buf) - g + 1
    if m <= 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint32))
    h = np.full(m, _FNV_BASIS + np.uint32(977 * g), dtype=np.uint32)
    for k in range(g):
        h = (h ^ buf[k:m + k]) * _FNV
    ok = row[:m] == row[g - 1:g - 1 + m]
    return row[:m][ok], h[ok]


_BUILD_CHUNK = 16384  # rows per bincount pass (bounds the count buffer)


def build_fingerprints(values, words: int, mg: int) -> np.ndarray:
    """``[len(values), words]`` uint32 fingerprint rows, one chunked
    vectorized pass: concatenate the canonical UTF-8 bytes, roll the gram
    hashes for every active length, bincount the per-chunk bit domain and
    pack the nonzero counts back into words.  Non-str values hash their
    ``str()`` form (the exact subject the host predicates see)."""
    n = len(values)
    nbits = words * 32
    out = np.empty((n, words), dtype=np.uint32)
    for lo in range(0, n, _BUILD_CHUNK):
        hi = min(lo + _BUILD_CHUNK, n)
        bs = [canonical_text(v if isinstance(v, str) else str(v))
              .encode("utf-8") for v in values[lo:hi]]
        lens = np.fromiter((len(b) for b in bs), dtype=np.int64,
                           count=hi - lo)
        buf = np.frombuffer(b"".join(bs), dtype=np.uint8)
        rowid = np.repeat(np.arange(hi - lo, dtype=np.int64), lens)
        parts = [_gram_hashes(buf, rowid, g) for g in range(mg, MAX_GRAM + 1)]
        rows = np.concatenate([p[0] for p in parts])
        hashes = np.concatenate([p[1] for p in parts])
        idx = rows * nbits + (hashes % np.uint32(nbits))
        cnt = np.bincount(idx, minlength=(hi - lo) * nbits)
        out[lo:hi] = np.packbits(
            cnt > 0, bitorder="little").view(np.uint32).reshape(-1, words)
    return out


def literal_mask(lit: str, words: int, mg: int) -> np.ndarray:
    """``[words]`` uint32 mask of every indexed gram of one required
    literal (same canonicalization + hashing as the build side — the one
    definition both sides share).  All-zero when the literal is shorter
    than ``mg`` (no constraint)."""
    b = np.frombuffer(canonical_text(lit).encode("utf-8"), dtype=np.uint8)
    rowid = np.zeros(len(b), dtype=np.int64)
    nbits = words * 32
    qm = np.zeros(words, dtype=np.uint32)
    for g in range(mg, MAX_GRAM + 1):
        _rows, hashes = _gram_hashes(b, rowid, g)
        bit = hashes % np.uint32(nbits)
        np.bitwise_or.at(qm, bit >> np.uint32(5),
                         np.uint32(1) << (bit & np.uint32(31)))
    return qm


# --- required-literal extraction ------------------------------------------
#
# A spec is OR-of-AND: a list of alternatives, each a tuple of literal
# substrings every match via that alternative must contain.  None = no
# constraint information (prefilter passes everything through);
# MATCH_NOTHING = the predicate is provably empty (e.g. `matches` with no
# tokens) — the caller may skip verification entirely.

MATCH_NOTHING: list = []

_ALT_CAP = 16  # alternation fan-out cap before giving up on a branch


def _like_literals(pattern: str) -> list[str]:
    runs, cur = [], []
    for ch in pattern:
        if ch in ("%", "_"):
            if cur:
                runs.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        runs.append("".join(cur))
    return runs


def _regex_alternatives(pattern: str) -> list[tuple[str, ...]] | None:
    """Required-substring extraction from a regex via its sre parse tree.
    Only claims it can prove: literal runs in a concatenation, both-ways
    across groups, min>=1 repeats once, branches as OR.  Everything else
    contributes no constraint."""
    try:
        try:
            import sre_parse
        except ImportError:  # Python 3.12+: moved under re
            from re import _parser as sre_parse  # type: ignore
        tree = sre_parse.parse(pattern)
    except Exception:  # noqa: BLE001 — unparseable: no pruning info
        return None

    def seq_req(seq) -> list[tuple[str, ...]]:
        # alternatives-of-required-sets for one concatenation sequence
        alts: list[tuple[str, ...]] = [()]
        cur: list[str] = []  # current contiguous literal run

        def flush():
            nonlocal alts, cur
            if cur:
                lit = "".join(cur)
                alts = [a + (lit,) for a in alts]
                cur = []

        def combine(sub: list[tuple[str, ...]]):
            # AND this subtree's OR-alternatives into the accumulated
            # ones (cross product); past the fan-out cap the subtree's
            # requirements are dropped entirely — weaker pruning, still
            # sound (a discarded requirement only widens candidates)
            nonlocal alts
            merged = [a + s for a in alts for s in sub]
            if 0 < len(merged) <= _ALT_CAP:
                alts = merged

        for op, av in seq:
            opname = str(op)
            if opname == "LITERAL":
                cur.append(chr(av))
                continue
            flush()
            if opname == "SUBPATTERN":
                # (group, add_flags, del_flags, subseq)
                combine(seq_req(av[3]))
            elif opname == "BRANCH":
                sub: list[tuple[str, ...]] = []
                for branch in av[1]:
                    sub.extend(seq_req(branch))
                if 0 < len(sub) <= _ALT_CAP:
                    combine(sub)
                # else: unbounded fan-out — no constraint from the branch
            elif opname in ("MAX_REPEAT", "MIN_REPEAT",
                            "POSSESSIVE_REPEAT"):
                lo_rep = av[0]
                if lo_rep >= 1:
                    combine(seq_req(av[2]))
            elif opname == "ATOMIC_GROUP":
                combine(seq_req(av))
            # ANY/IN/NOT_LITERAL/CATEGORY/AT/ASSERT*/GROUPREF...: no
            # provable requirement — the run break above is all they do
        flush()
        return alts[:_ALT_CAP]

    alts = seq_req(tree)
    alts = [a for a in alts]
    return alts if alts else None


def spec_for(kind: str, text: str) -> list[tuple[str, ...]] | None:
    """Required-literal alternatives for one predicate kind:

    - ``eq`` / ``contains`` / ``prefix``: the literal itself;
    - ``like`` / ``ilike``: the runs between ``%``/``_`` wildcards;
    - ``regex`` / ``iregex``: sre-tree extraction (case handled by the
      canonical form — see canonical_text);
    - ``matches`` / ``matches_term``: the query's analyzer tokens (AND),
      MATCH_NOTHING when tokenization is empty (the shared ft_predicate
      semantics: empty queries match nothing)."""
    if kind in ("eq", "contains", "prefix"):
        return [(text,)] if text else None
    if kind in ("like", "ilike"):
        lits = _like_literals(text)
        return [tuple(lits)] if lits else None
    if kind in ("regex", "iregex"):
        return _regex_alternatives(text)
    if kind in ("matches", "matches_term"):
        from greptimedb_tpu_torch.storage.index import tokenize

        toks = tokenize(text)
        if not toks:
            return MATCH_NOTHING
        return [tuple(dict.fromkeys(toks))]
    return None


def compile_masks(spec, words: int, mg: int) -> np.ndarray | None:
    """Spec → ``[k, words]`` uint32 query masks (candidate = every bit of
    SOME row present).  None when any alternative carries no usable gram
    (that alternative would admit everything, so nothing can be pruned).
    """
    if spec is None or spec == MATCH_NOTHING:
        return None
    rows = []
    for alt in spec:
        qm = np.zeros(words, dtype=np.uint32)
        for lit in alt:
            qm |= literal_mask(lit, words, mg)
        if not qm.any():
            return None
        rows.append(qm)
    return np.stack(rows)
