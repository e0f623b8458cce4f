"""Skipping indexes: per-SST bloom filters over tag columns.

Reference: src/index/src/bloom_filter/ + the puffin blob container
(SURVEY.md §2.5) — indexes are built at flush/compaction time and prune
SSTs (and eventually row groups) before any Parquet IO. Here each SST gets
one sidecar blob (``<file_id>.idx``) holding a bloom filter per tag
column; ``Region.scan_host`` consults them for equality/IN predicates.

Read-path consumers: cold scans that bypass the HBM-resident cache
(exports, range-restricted scans over beyond-HBM tables). The resident
query path deliberately loads whole regions once and filters on device, so
it does not pass tag_filters; wiring planner-extracted filters into
range-restricted scans lands with the beyond-HBM work.

Bloom layout: double hashing with two crc32-derived hashes (Kirsch-
Mitzenmacher), bit array in numpy uint64 words, target ~1% false positives
(10 bits/key, 7 hashes).
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

BITS_PER_KEY = 10
NUM_HASHES = 7
_MAGIC = b"GTIX1\n"


class BloomFilter:
    def __init__(self, num_bits: int, bits: np.ndarray | None = None):
        self.num_bits = max(int(num_bits), 64)
        words = (self.num_bits + 63) // 64
        self.bits = (
            bits if bits is not None else np.zeros(words, dtype=np.uint64)
        )

    @staticmethod
    def for_keys(n: int) -> "BloomFilter":
        return BloomFilter(max(n, 1) * BITS_PER_KEY)

    def _hashes(self, value: str) -> tuple[int, int]:
        data = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        h1 = zlib.crc32(data)
        h2 = zlib.crc32(data, 0x9E3779B9) | 1  # odd => full period
        return h1, h2

    def add(self, value) -> None:
        h1, h2 = self._hashes(str(value))
        for i in range(NUM_HASHES):
            bit = (h1 + i * h2) % self.num_bits
            self.bits[bit >> 6] |= np.uint64(1 << (bit & 63))

    def might_contain(self, value) -> bool:
        h1, h2 = self._hashes(str(value))
        for i in range(NUM_HASHES):
            bit = (h1 + i * h2) % self.num_bits
            if not (int(self.bits[bit >> 6]) >> (bit & 63)) & 1:
                return False
        return True

    def to_bytes(self) -> bytes:
        return struct.pack("<I", self.num_bits) + self.bits.tobytes()

    @staticmethod
    def from_bytes(raw: bytes) -> "BloomFilter":
        (num_bits,) = struct.unpack_from("<I", raw, 0)
        bits = np.frombuffer(raw[4:], dtype=np.uint64).copy()
        return BloomFilter(num_bits, bits)


# Term dictionaries above this cardinality are dropped from the sidecar
# (the bloom still covers equality); bounds sidecar size on high-churn tags.
VOCAB_LIMIT = 4096
# distinct TOKENS per string-FIELD column kept for full-text pruning
TOKEN_LIMIT = 65536
_MAGIC2 = b"GTIX2\n"
# bump when tokenize() changes: stale token sets in old sidecars must be
# IGNORED (no pruning), never consulted — they would over-prune queries
# whose tokens the old analyzer never produced (e.g. CJK bigrams)
_TOKENIZER_VERSION = 2

_TOKEN_RE = None


def tokenize(text: str) -> list[str]:
    """Lowercase word tokens + CJK bigrams.

    Latin/digit runs split on non-alnum and lowercase (the reference's
    fulltext default analyzer — tantivy's simple tokenizer).  CJK runs
    emit character BIGRAMS (single char when the run is length 1): the
    dictionary-free analog of the reference's tantivy-jieba Chinese
    tokenizer (src/index/Cargo.toml:43-44) — bigram indexing is the
    standard CJK fallback when no segmentation dictionary ships."""
    global _TOKEN_RE
    if _TOKEN_RE is None:
        import re

        _TOKEN_RE = re.compile(
            r"[A-Za-z0-9_]+|[\u3040-\u30ff\u3400-\u4dbf\u4e00-\u9fff"
            r"\uf900-\ufaff\uac00-\ud7af]+"
        )
    out: list[str] = []
    for run in _TOKEN_RE.findall(text):
        if run[0].isascii():
            out.append(run.lower())
        elif len(run) == 1:
            out.append(run)
        else:
            out.extend(run[i:i + 2] for i in range(len(run) - 1))
    return out


class ColumnIndex:
    """Per-column SST index: bloom (always) + exact term dictionary (when
    the column's distinct count fits VOCAB_LIMIT).  The term dictionary is
    the file-level analog of the reference's FST term dict
    (src/index/src/inverted_index/): it makes equality pruning exact and
    lets ARBITRARY predicates (regex matchers) prune whole files."""

    def __init__(self, bloom: BloomFilter, vocab: list[str] | None = None):
        self.bloom = bloom
        self.vocab = vocab
        self._vset = set(vocab) if vocab is not None else None
        self.tokens: set[str] | None = None  # fulltext token set
        self.has_tombstones = False  # file holds delete rows

    def may_contain(self, value) -> bool:
        if self._vset is not None:
            return str(value) in self._vset
        return self.bloom.might_contain(value)

    def any_term_matches(self, pred) -> bool:
        """False only when the exact vocabulary proves no term satisfies
        pred; True when unknown (no vocabulary stored)."""
        if self.vocab is None:
            return True
        return any(pred(t) for t in self.vocab)


def build_sst_index(columns: dict[str, np.ndarray], tag_names: list[str],
                    fulltext_columns: list[str] | None = None,
                    has_tombstones: bool = False,
                    tag_uniques: dict[str, list] | None = None) -> bytes:
    """Serialize per-tag-column blooms + term dicts, plus per-fulltext-
    column token sets, for one SST (the puffin blob, reference
    src/puffin/; fulltext backend = the reference's bloom-based variant,
    src/index/src/fulltext_index/).  ``tag_uniques`` (precomputed distinct
    values, e.g. from dictionary codes) skips the per-row unique pass."""
    blobs: dict[str, bytes] = {}
    vocabs: dict[str, list[str]] = {}
    tokens: dict[str, list[str]] = {}
    for name in tag_names:
        pre = (tag_uniques or {}).get(name)
        if pre is not None:
            uniq = np.asarray(sorted(str(v) for v in pre), dtype=object)
        elif name in columns:
            uniq = np.unique(columns[name].astype(object))
        else:
            continue
        bf = BloomFilter.for_keys(len(uniq))
        for v in uniq:
            bf.add(v)
        blobs[name] = bf.to_bytes()
        if len(uniq) <= VOCAB_LIMIT:
            vocabs[name] = [str(v) for v in uniq]
    for name in fulltext_columns or ():
        if name not in columns:
            continue
        toks: set[str] = set()
        for v in columns[name]:
            if v is None:
                continue
            toks.update(tokenize(str(v)))
            if len(toks) > TOKEN_LIMIT:
                break
        if len(toks) <= TOKEN_LIMIT:
            tokens[name] = sorted(toks)
    header = json.dumps({
        "blooms": {name: len(b) for name, b in blobs.items()},
        "vocabs": vocabs,
        "tokens": tokens,
        "tokv": _TOKENIZER_VERSION,
        "tombstones": bool(has_tombstones),
    }).encode("utf-8")
    out = _MAGIC2 + struct.pack("<I", len(header)) + header
    for name in sorted(blobs):
        out += blobs[name]
    return out


def load_sst_index(raw: bytes) -> dict[str, ColumnIndex]:
    if raw.startswith(_MAGIC2):
        (hlen,) = struct.unpack_from("<I", raw, len(_MAGIC2))
        off = len(_MAGIC2) + 4
        header = json.loads(raw[off:off + hlen])
        off += hlen
        out = {}
        for name in sorted(header["blooms"]):
            ln = header["blooms"][name]
            out[name] = ColumnIndex(
                BloomFilter.from_bytes(raw[off:off + ln]),
                header["vocabs"].get(name),
            )
            off += ln
        if header.get("tokv") == _TOKENIZER_VERSION:
            # token sets from a different analyzer version are DROPPED:
            # pruning against them would hide rows whose tokens the old
            # analyzer never produced (no tokens = no pruning = correct)
            for name, toks in header.get("tokens", {}).items():
                ci = out.get(name)
                if ci is None:
                    ci = out[name] = ColumnIndex(BloomFilter(64))
                ci.tokens = set(toks)
        if header.get("tombstones"):
            for ci in out.values():
                ci.has_tombstones = True
        return out
    if not raw.startswith(_MAGIC):
        raise ValueError("bad index blob magic")
    # v1 (bloom-only) sidecars written by earlier builds
    (hlen,) = struct.unpack_from("<I", raw, len(_MAGIC))
    off = len(_MAGIC) + 4
    header = json.loads(raw[off:off + hlen])
    off += hlen
    out = {}
    for name in sorted(header):
        ln = header[name]
        out[name] = ColumnIndex(BloomFilter.from_bytes(raw[off:off + ln]))
        off += ln
    return out


def sst_may_match(
    index: dict[str, ColumnIndex], tag_filters: dict[str, set]
) -> bool:
    """False only when some filtered column's index excludes EVERY value
    (exact when the term dictionary is present, probabilistic via bloom
    otherwise)."""
    for col, values in tag_filters.items():
        ci = index.get(col)
        if ci is None or not values:
            continue
        if not any(ci.may_contain(v) for v in values):
            return False
    return True


def sst_pred_may_match(
    index: dict[str, ColumnIndex], column: str, pred
) -> bool:
    """File-level pruning for arbitrary term predicates (regex matchers):
    False only when the stored vocabulary proves no term matches."""
    ci = index.get(column)
    if ci is None:
        return True
    return ci.any_term_matches(pred)


def ft_predicate(name: str, query: str):
    """matches = AND of query tokens; matches_term = the query's token
    SEQUENCE appears consecutively (exact-term semantics for terms with
    non-alnum separators like 'v1.0').  Empty-token queries match NOTHING
    — a filter must never silently select everything.  The ONE definition
    of full-text semantics (SQL functions, log-query DSL, pruning)."""
    qtokens = tokenize(query)
    if not qtokens:
        return lambda text: False
    if name == "matches_term":
        k = len(qtokens)

        def term_pred(text: str) -> bool:
            toks = tokenize(text)
            return any(
                toks[i:i + k] == qtokens for i in range(len(toks) - k + 1)
            )

        return term_pred

    qset = set(qtokens)

    def pred(text: str) -> bool:
        return qset.issubset(tokenize(text))

    return pred


def ft_score(query: str):
    """TF-IDF-shaped relevance scoring: returns (query_tokens, tf_vector)
    where tf_vector(text) gives per-query-token saturated term
    frequencies; the caller applies IDF over whatever corpus it scans
    (the table dictionary on the device path, the batch's distinct
    values on the host path — scores are a per-query ranking heuristic,
    not comparable across paths).  The reference's ranking comes from
    tantivy's BM25 (src/index/src/fulltext_index/); this is the same
    shape without per-SST global statistics: tf saturation (BM25 k1=1.2)
    x corpus IDF.  Score 0.0 = no overlap (use `matches` to filter)."""
    qtokens = list(dict.fromkeys(tokenize(query)))  # uniq, stable order

    def tf_vector(text: str) -> list[float]:
        toks = tokenize(text)
        out = []
        for q in qtokens:
            tf = toks.count(q)
            out.append((tf * 2.2) / (tf + 1.2) if tf else 0.0)
        return out

    return qtokens, tf_vector


def ft_score_corpus(query: str, corpus) -> "np.ndarray":
    """Score every text in ``corpus`` against ``query`` — the ONE
    TF-IDF computation, shared by the device (dictionary vocabulary) and
    host (batch distinct values) paths so the BM25 constants can never
    diverge between them."""
    import math

    import numpy as np

    qtokens, tf_vector = ft_score(query)
    tfs = [tf_vector(str(t)) for t in corpus]
    n_docs = max(len(tfs), 1)
    dfs = [sum(1 for v in tfs if v[j]) for j in range(len(qtokens))]
    idf = [math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)) for df in dfs]
    if not tfs:
        return np.zeros(1, dtype=np.float64)
    return np.asarray(
        [sum(w * i for w, i in zip(v, idf)) for v in tfs],
        dtype=np.float64,
    )


def sst_tokens_may_match(
    index: dict[str, ColumnIndex], column: str, query_tokens: list[str]
) -> bool:
    """Full-text file pruning: False only when the token set proves some
    query token appears NOWHERE in the column (AND semantics).  Files
    containing tombstones are NEVER pruned: a delete row's fields are
    null, so its tokens are absent, yet the merge must see it or deleted
    rows resurrect."""
    ci = index.get(column)
    if ci is None or ci.tokens is None or ci.has_tombstones:
        return True
    return all(t in ci.tokens for t in query_tokens)
