"""Inverted index: tag term dictionaries + posting lists.

Reference: src/index/src/inverted_index/ (FST term dictionary + roaring
bitmaps per SST, RFC docs/rfcs/2023-11-03-inverted-index.md).  This
build keeps all indexing host-side (pruning is control logic; the device
only ever sees the post-prune numeric tensors) and exploits a structural
advantage the reference lacks: every region already dictionary-encodes
tags into dense codes with a series registry (tsid -> code tuple), so

- the TERM DICTIONARY is the region's per-column encoder vocabulary, and
- POSTING LISTS are "code -> sorted tsid array", derivable in one argsort.

Matcher evaluation (equality, regex, negations) then costs O(vocabulary)
string work instead of O(series): a regex runs once per DISTINCT term and
the matching posting lists concatenate into the selected tsid set.  This
is what makes 1M–10M-series PromQL label matching feasible (a Python
re.fullmatch per series would not be).

Host numpy only: a copy of the reference's ``storage/inverted.py``.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np


class SeriesInvertedIndex:
    """Per-region (or combined-view) inverted index over the series
    registry.  Build cost: one argsort per tag column; cached on the
    region object keyed by generation (see ``get_series_index``)."""

    def __init__(self, tag_names: list[str], series_codes: list[tuple],
                 vocabs: dict[str, list[str]],
                 raw_values: dict[str, list] | None = None):
        self.tag_names = list(tag_names)
        self.vocabs = vocabs  # column -> term list (code == list index)
        # column -> RAW encoder values (labels decode to these, not the
        # str-coerced matcher terms); ONE copy per region registry
        # version, shared by every selection built against it
        self.raw_values = raw_values if raw_values is not None else vocabs
        n = len(series_codes)
        self.num_series = n
        # tsid t has codes self.codes[c][t]
        self.codes: dict[str, np.ndarray] = {}
        # posting lists: for column c, tsids sorted by code with offsets
        # per code: tsids_of(c, code) = postings[c][starts[code]:starts[code+1]]
        self.postings: dict[str, np.ndarray] = {}
        self.offsets: dict[str, np.ndarray] = {}
        key_arr = np.asarray([k for k, _t in series_codes], dtype=np.int64)
        tsid_arr = np.asarray([t for _k, t in series_codes], dtype=np.int64)
        for j, name in enumerate(self.tag_names):
            col = key_arr[:, j] if n else np.zeros(0, dtype=np.int64)
            self.codes[name] = np.zeros(
                int(tsid_arr.max()) + 1 if n else 0, dtype=np.int64
            )
            if n:
                self.codes[name][tsid_arr] = col
            order = np.argsort(col, kind="stable")
            self.postings[name] = tsid_arr[order]
            v = len(vocabs.get(name, []))
            # offsets[i] = first posting position of code i
            self.offsets[name] = np.searchsorted(
                col[order], np.arange(v + 1)
            )
        self.all_tsids = np.sort(tsid_arr)

    # ---- term-level ----------------------------------------------------
    def matching_codes(self, column: str,
                       pred: Callable[[str], bool]) -> np.ndarray:
        """Codes whose TERM satisfies pred — O(vocabulary) string work."""
        vocab = self.vocabs.get(column, [])
        return np.asarray(
            [i for i, term in enumerate(vocab) if pred(term)],
            dtype=np.int64,
        )

    def postings_for_codes(self, column: str,
                           codes: Iterable[int]) -> np.ndarray:
        """Union of posting lists for the given codes (sorted tsids)."""
        post = self.postings[column]
        offs = self.offsets[column]
        parts = [
            post[offs[c]:offs[c + 1]]
            for c in codes
            if 0 <= c < len(offs) - 1
        ]
        if not parts:
            return np.zeros(0, dtype=np.int64)
        return np.sort(np.concatenate(parts))

    # ---- vectorized code access (PromQL grouping) ----------------------
    def codes_for(self, column: str, tsids: np.ndarray) -> np.ndarray:
        """Dictionary codes of ``column`` for a tsid vector — one fancy-
        index gather, no per-series Python work.  Unknown columns yield
        all -1 (the "missing label" sentinel the callers already treat as
        out-of-vocabulary)."""
        col = self.codes.get(column)
        if col is None:
            return np.full(len(tsids), -1, dtype=np.int64)
        return col[tsids]

    def canonical_codes(self, column: str,
                        merge_missing_empty: bool) -> tuple[np.ndarray, int]:
        """code → canonical-term id remap for grouping: terms with equal
        ``str()`` collapse to one id (PromQL group keys are string-level),
        and the MISSING sentinel (index = vocabulary size) either merges
        with the empty-string term (``by`` semantics: absent label prints
        as "") or stays distinct (``without`` semantics: an absent label
        is omitted from the key, distinguishable from a present "").
        Returns (remap array of length vocab+1, number of canonical ids).
        """
        vocab = self.vocabs.get(column, [])
        terms = list(vocab)
        if merge_missing_empty:
            terms.append("")
        uniq, inv = (np.unique(np.asarray(terms, dtype=object),
                               return_inverse=True)
                     if terms else (np.zeros(0, object),
                                    np.zeros(0, np.int64)))
        n = len(uniq)
        remap = np.empty(len(vocab) + 1, dtype=np.int64)
        remap[:len(vocab)] = inv[:len(vocab)]
        if merge_missing_empty:
            remap[len(vocab)] = inv[len(vocab)]
        else:
            remap[len(vocab)] = n
            n += 1
        return remap, n

    # ---- matcher-level -------------------------------------------------
    def select(self, column: str, pred: Callable[[str], bool],
               negate: bool = False) -> np.ndarray:
        """Sorted tsids whose term for ``column`` satisfies pred."""
        if column not in self.postings:
            # label absent from the schema: every series has the empty
            # value; the predicate decides all-or-nothing
            keep = pred("")
            if negate:
                keep = not keep
            return self.all_tsids if keep else np.zeros(0, dtype=np.int64)
        codes = self.matching_codes(column, pred)
        tsids = self.postings_for_codes(column, codes)
        if negate:
            return np.setdiff1d(self.all_tsids, tsids, assume_unique=True)
        return tsids


def get_series_index(region) -> SeriesInvertedIndex:
    """Series-registry-cached index for a Region / CombinedRegionView
    duck: keyed on ``series_generation`` (registry version) when the
    region exposes it, so pure data appends of existing series don't pay
    an O(series) index rebuild per write — only registry growth or
    structure changes do."""
    _ = region.num_series  # CombinedRegionView: force a registry refresh
    gen = getattr(region, "series_generation", None)
    if gen is None:
        gen = region.generation
    cached = getattr(region, "_series_inv_cache", None)
    if cached is not None and cached[0] == gen:
        return cached[1]
    series_codes = sorted(region._series.items(), key=lambda kv: kv[1])
    # str-coerce: non-string tag columns store raw values in the encoder,
    # but matcher predicates (regex) are defined over strings; the raw
    # lists ride along for label decoding (one copy per registry version)
    raw_values = {
        name: region.encoders[name].values() for name in region.tag_names
    }
    vocabs = {
        name: [str(v) for v in raw_values[name]]
        for name in region.tag_names
    }
    idx = SeriesInvertedIndex(region.tag_names, series_codes, vocabs,
                              raw_values)
    try:
        region._series_inv_cache = (gen, idx)
    except AttributeError:
        pass  # slots/immutable duck: skip caching
    return idx
