"""Resident fingerprint index: the device cache and its provider.

The port of the JAX package's ``fulltext/resident.py``.  Three entry
kinds live in one byte-bounded LRU:

- ``fp``     — the fingerprint matrix of one (table, string column):
  ``[npad, W]`` 32-bit words (int32 tensors holding the uint32 bits) on
  the db's device, one row per DISTINCT value of the column's resident
  dictionary.  Built vectorized from the dictionary and EXTENDED by
  vocabulary tail while the lineage key ``DeviceTable.dicts_root`` stays
  the same (dictionaries only append within a lineage; the port rebuilds
  its device tables in full, so every build starts a lineage);
- ``verify`` — the verified-vocabulary memo of one compiled predicate:
  a bool per dictionary entry, exact (prefilter + host verification of
  candidates).  Warm repeats of the same LIKE/MATCHES/LogQL filter cost
  an O(1) lookup; a grown vocabulary verifies only its tail;
- ``mask``   — combined line-filter vectors for the LogQL evaluator:
  the AND/NOT composition of verify memos, padded + uploaded once so
  the metric kernels gather ``verified[codes]`` without per-eval
  transfers.

The prefilter is the hand-written ``fp_candidates`` kernel
(``ops/fulltext_kernels.py``; K16).  Admission: LRU-evict to capacity;
``memory_probe`` (the reference's workload quota) stays None until the
memory manager is ported.  All structure mutations hold
``_struct_lock``; fingerprint builds and host verification run outside
it.
"""

from __future__ import annotations

import collections
import threading
import weakref

import numpy as np
import torch

from greptimedb_tpu_torch.fulltext import fingerprint as fpm
from greptimedb_tpu_torch.ops import fulltext_kernels as fk
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

M_FT_CANDIDATES = REGISTRY.counter(
    "greptime_fulltext_candidates_total",
    "Dictionary entries surviving the fingerprint prefilter (candidates "
    "handed to exact host verification)")
M_FT_VERIFIED = REGISTRY.counter(
    "greptime_fulltext_verified_total",
    "Exact host-predicate evaluations on prefilter candidates")
M_FT_MATCHED = REGISTRY.counter(
    "greptime_fulltext_matched_total",
    "Candidates the exact predicate confirmed (verified - matched = "
    "prefilter false positives)")
M_FT_SCANNED = REGISTRY.counter(
    "greptime_fulltext_scanned_total",
    "Dictionary entries the prefilter EXCLUDED (host predicate skipped); "
    "candidates/(candidates+scanned) is the selectivity")
M_FT_QUERIES = REGISTRY.counter(
    "greptime_fulltext_queries_total",
    "Text predicates by evaluation path", ("path",))
M_FT_INDEXED = REGISTRY.counter(
    "greptime_fulltext_indexed_values_total",
    "Dictionary entries fingerprinted (build + tail extends)")
M_FT_BYTES = REGISTRY.gauge(
    "greptime_fulltext_resident_bytes",
    "Bytes resident in the fulltext fingerprint cache (matrices, "
    "verify memos, combined filter vectors)")


def _host_verified(vocab, pred) -> np.ndarray:
    """The host fallback twin: the exact predicate over EVERY dictionary
    entry — the one definition of truth the prefilter path must equal."""
    return np.fromiter((bool(pred(v)) for v in vocab), dtype=bool,
                       count=len(vocab))


def _device_of(table) -> torch.device:
    """Where a table's derived state lives: its row mask's device (the
    CPU for a table that holds no tensors)."""
    mask = getattr(table, "row_mask", None)
    return mask.device if isinstance(mask, torch.Tensor) else torch.device(
        "cpu")


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


class _Entry:
    __slots__ = ("root", "n", "npad", "words", "mg", "dev", "bools",
                 "nbytes")

    def __init__(self, root, n, nbytes, npad=0, words=0, mg=0, dev=None,
                 bools=None):
        self.root = root      # DeviceTable.dicts_root lineage
        self.n = n            # vocabulary entries covered
        self.npad = npad
        self.words = words
        self.mg = mg
        self.dev = dev        # device payload (fp matrix / mask vector)
        self.bools = bools    # verify memo (np.bool_, immutable)
        self.nbytes = nbytes


class FulltextIndexCache:
    """LRU of fingerprint matrices + verify memos + filter vectors."""

    def __init__(self, capacity_bytes: int | None = None):
        import os

        if capacity_bytes is None:
            capacity_bytes = int(os.environ.get(
                "GREPTIME_FULLTEXT_CACHE_BYTES", str(1 << 30)))
        self.capacity = capacity_bytes
        # callable(nbytes) -> bool; the reference wires it to the memory
        # manager's try_admit("fulltext", ...), which is not ported yet
        self.memory_probe = None
        self._lru: "collections.OrderedDict[tuple, _Entry]" = (
            collections.OrderedDict())
        self._bytes = 0
        # guards _lru/_bytes and the counters below: scheduler workers,
        # the ingest-side prewarm hook and the LogQL evaluator mutate
        # them concurrently.  Fingerprint builds, device uploads and host
        # verification all run OUTSIDE it (only dict/counter ops held).
        self._struct_lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.rejects = 0
        self.evictions = 0
        ref = weakref.ref(self)
        M_FT_BYTES.set_function(
            lambda: c._bytes if (c := ref()) is not None else 0.0)

    # ---- structure ----------------------------------------------------
    @property
    def bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._lru)

    def _get(self, key, root):
        """Current entry for ``key`` under lineage ``root`` (stale
        lineages evict immediately — the root bump IS the invalidation).
        """
        with self._struct_lock:
            e = self._lru.get(key)
            if e is not None and e.root == root:
                self._lru.move_to_end(key)
                self.hits += 1
                return e
            if e is not None:
                self._evict(key)
            self.misses += 1
            return None

    def _admit(self, nbytes: int) -> bool:
        if nbytes > self.capacity:
            with self._struct_lock:
                self.rejects += 1
            return False
        with self._struct_lock:
            while self._bytes + nbytes > self.capacity and self._lru:
                self._evict(next(iter(self._lru)))
        # the workload probe takes the memory manager's lock — called
        # outside _struct_lock so no fulltext→memory lock edge exists
        if self.memory_probe is not None and not self.memory_probe(nbytes):
            with self._struct_lock:
                self.rejects += 1
            return False
        return True

    def _store(self, key, entry: _Entry) -> None:
        with self._struct_lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._lru[key] = entry
            self._bytes += entry.nbytes
            self.builds += 1

    def _evict(self, key) -> None:
        with self._struct_lock:
            e = self._lru.pop(key, None)
            if e is not None:
                self._bytes -= e.nbytes
                self.evictions += 1

    def reclaim(self, nbytes: int) -> None:
        """Memory-manager reclaim hook: free ≥ nbytes by LRU eviction."""
        with self._struct_lock:
            freed = 0
            while freed < nbytes and self._lru:
                k = next(iter(self._lru))
                freed += self._lru[k].nbytes
                self._evict(k)

    def invalidate_table(self, table_key: str) -> None:
        """Drop every entry of one table (DROP/TRUNCATE chain — lineage
        checks catch staleness, only this frees the bytes eagerly)."""
        with self._struct_lock:
            for k in [k for k in self._lru if k[1] == table_key]:
                self._evict(k)

    def stats(self) -> dict:
        with self._struct_lock:
            return {"bytes": self._bytes, "entries": len(self._lru),
                    "hits": self.hits, "misses": self.misses,
                    "builds": self.builds, "rejects": self.rejects,
                    "evictions": self.evictions}

    # ---- fingerprint matrices -----------------------------------------
    def _fingerprints(self, tkey: str, root: int, column: str, vocab,
                      device=torch.device("cpu")) -> _Entry | None:
        """Resident fp matrix covering (a prefix of) ``vocab`` on
        ``device`` (the table's); builds or tail-extends under admission.
        None = nothing resident and the build was rejected (callers
        verify without pruning)."""
        key = ("fp", tkey, column)
        words, mg = fpm.words_per_row(), fpm.min_gram()
        n = len(vocab)
        e = self._get(key, root)
        if e is not None and (e.words != words or e.mg != mg):
            self._evict(key)  # knob changed mid-process: stale geometry
            e = None
        if e is not None and e.n >= n:
            return e
        covered = e.n if e is not None else 0
        tail = fpm.build_fingerprints(vocab[covered:n], words, mg)
        M_FT_INDEXED.inc(n - covered)
        tail = torch.from_numpy(tail.view(np.int32)).to(device)
        if e is not None and n <= e.npad:
            # in place: the matrix belongs to this entry alone
            e.dev[covered:n] = tail
            new = _Entry(root, n, e.nbytes, e.npad, words, mg, e.dev)
            self._store(key, new)
            return new
        npad = _pow2(n)
        nbytes = npad * words * 4
        delta = nbytes - (e.nbytes if e is not None else 0)
        if delta > 0 and not self._admit(delta):
            return e  # keep the (possibly partial) resident prefix
        full = torch.zeros((npad, words), dtype=torch.int32, device=device)
        if e is not None:
            full[:covered] = e.dev[:covered]
        full[covered:n] = tail
        new = _Entry(root, n, nbytes, npad, words, mg, full)
        self._store(key, new)
        return new

    # ---- verified predicate memos -------------------------------------
    def _candidates(self, fp_entry: _Entry | None, masks,  # gl: warm-path
                    lo: int, hi: int) -> np.ndarray:
        """Candidate flags for vocabulary slice [lo, hi): the prefilter
        kernel over the resident matrix where covered, all-True beyond
        coverage or without masks.  ONE host materialization per
        predicate compile — the prefilter's whole sync budget."""
        out = np.ones(hi - lo, dtype=bool)
        if fp_entry is None or masks is None:
            return out
        cov = min(fp_entry.n, hi)
        if cov <= lo:
            return out
        qm = torch.from_numpy(masks.view(np.int32)).to(fp_entry.dev.device)
        cand = fk.fp_candidates(fp_entry.dev, qm).cpu().numpy()
        out[: cov - lo] = cand[lo:cov]
        return out

    def verified_bools(self, tkey: str, table, column: str, vocab, pred,
                       kind: str, text: str,
                       variant: str = "") -> np.ndarray | None:
        """Exact per-dictionary-entry truth of ``pred``, memoized and
        prefilter-accelerated; None when the subsystem is off (callers
        run their host loop unchanged).  Bit-exact vs _host_verified by
        construction: non-candidates are proven false by the required-
        literal soundness, candidates are decided by ``pred`` itself.

        ``variant`` namespaces callers whose predicate SUBJECT differs
        for the same (kind, text) — the log-query DSL coerces None to ""
        while the SQL path sees str(None) — so they can never read each
        other's memoized truth.  (The prefilter stays sound across
        subjects: a required literal is non-empty, so a predicate that
        is true of the coerced subject still implies the literal's grams
        appear in the hashed str() form or verification decides.)"""
        if not fpm.enabled():
            return None
        root = getattr(table, "dicts_root", None)
        if root is None:
            return None
        n = len(vocab)
        qkey = ("verify", tkey, column, kind, text, variant)
        memo = self._get(qkey, root)
        if memo is not None and memo.n == n:
            M_FT_QUERIES.labels("memo").inc()
            return memo.bools
        start = memo.n if memo is not None and memo.n < n else 0
        prev = memo.bools if start else None
        spec = fpm.spec_for(kind, text)
        if spec is not None and len(spec) == 0:
            # provably-empty predicate (matches with no tokens): the
            # shared ft_predicate semantics say "match nothing"
            bools = np.zeros(n, dtype=bool)
            M_FT_QUERIES.labels("empty").inc()
        else:
            fp_entry = self._fingerprints(tkey, root, column, vocab,
                                          _device_of(table))
            masks = None
            if fp_entry is not None and spec is not None:
                masks = fpm.compile_masks(spec, fp_entry.words, fp_entry.mg)
            cand = self._candidates(fp_entry, masks, start, n)
            tail = np.zeros(n - start, dtype=bool)
            idx = np.nonzero(cand)[0]
            for i in idx.tolist():
                if pred(vocab[start + i]):
                    tail[i] = True
            M_FT_CANDIDATES.inc(len(idx))
            M_FT_VERIFIED.inc(len(idx))
            M_FT_MATCHED.inc(int(tail.sum()))
            M_FT_SCANNED.inc((n - start) - len(idx))
            M_FT_QUERIES.labels(
                "prefilter" if masks is not None else "verify_all").inc()
            bools = np.concatenate([prev, tail]) if prev is not None else tail
        if self._admit(max(bools.nbytes - (memo.nbytes if memo else 0), 0)):
            self._store(qkey, _Entry(root, n, bools.nbytes, bools=bools))
        return bools

    def verified_map(self, tkey: str, table, column: str, vocab, pred,
                     kind: str, text: str,
                     variant: str = "") -> dict | None:
        """``{coerced value: truth}`` over the dictionary — the probe
        structure the log-query DSL row loop wants — memoized per
        lineage alongside the bool memo so warm DSL requests skip both
        the predicate walk AND the O(vocab) dict rebuild.  The map keys
        use the DSL's coercion (None → "")."""
        root = getattr(table, "dicts_root", None)
        n = len(vocab)
        mkey = ("vmap", tkey, column, kind, text, variant)
        memo = self._get(mkey, root) if root is not None else None
        if memo is not None and memo.n == n:
            return memo.dev
        bools = self.verified_bools(tkey, table, column, vocab, pred,
                                    kind, text, variant)
        if bools is None:
            return None
        prev = memo.dev if memo is not None and memo.n < n else None
        start = memo.n if prev is not None else 0
        vmap = dict(prev) if prev is not None else {}
        for i in range(start, n):
            v = vocab[i]
            vmap["" if v is None else str(v)] = bool(bools[i])
        # rough dict footprint: per-entry overhead + key text
        nbytes = sum(64 + len(k) for k in vmap)
        if root is not None and self._admit(
                max(nbytes - (memo.nbytes if memo else 0), 0)):
            self._store(mkey, _Entry(root, n, nbytes, dev=vmap))
        return vmap

    def codes_matching(self, tkey: str, table, column: str, vocab, pred,
                       kind: str, text: str) -> np.ndarray | None:
        """Dictionary codes whose value satisfies ``pred`` — the drop-in
        accelerated twin of query/exprs.py _code_set (same dtype, same
        ascending order); None = caller falls back to the host loop."""
        bools = self.verified_bools(tkey, table, column, vocab, pred,
                                    kind, text)
        if bools is None:
            return None
        return np.nonzero(bools)[0].astype(np.int32)

    # ---- per-value byte lengths (bytes_over_time/bytes_rate) ----------
    def byte_lengths(self, tkey: str, table, column: str, vocab,
                     npad: int) -> torch.Tensor | None:
        """UTF-8 byte length per dictionary entry as a padded device f32
        vector, lineage-keyed and extended by tail like every other
        derived state — a dashboard's bytes_rate refresh must not pay an
        O(vocab) host loop per evaluation.  None when fulltext is off
        (the evaluator computes a transient vector)."""
        if not fpm.enabled():
            return None
        root = getattr(table, "dicts_root", None)
        if root is None:
            return None
        n = len(vocab)
        key = ("blen", tkey, column)
        memo = self._get(key, root)
        if memo is not None and memo.n == n and memo.npad >= npad:
            return memo.dev
        start = memo.n if memo is not None and memo.n < n else 0
        out = np.zeros(npad, dtype=np.float32)
        if start:
            out[:start] = memo.dev[:start].cpu().numpy()
        for i in range(start, n):
            v = vocab[i]
            out[i] = len(("" if v is None else str(v)).encode("utf-8"))
        dev = torch.from_numpy(out).to(_device_of(table))
        if self._admit(max(npad * 4 - (memo.nbytes if memo else 0), 0)):
            self._store(key, _Entry(root, n, npad * 4, npad=npad, dev=dev))
        return dev

    # ---- combined line-filter vectors (LogQL) -------------------------
    def line_filter_vector(self, tkey: str, table, column: str, vocab,
                           filters) -> tuple[torch.Tensor, int] | None:
        """AND/NOT composition of line filters as ONE padded device bool
        vector (gathered by code inside the metric kernels).  ``filters``
        is [(kind, text, pred, negate), ...]; None when fulltext is off
        (the evaluator's host twin composes _host_verified instead)."""
        if not fpm.enabled():
            return None
        root = getattr(table, "dicts_root", None)
        if root is None:
            return None
        n = len(vocab)
        npad = _pow2(n)
        mkey = ("mask", tkey, column,
                tuple((k, t, neg) for k, t, _p, neg in filters))
        memo = self._get(mkey, root)
        if memo is not None and memo.n == n:
            return memo.dev, memo.npad
        combined = np.ones(n, dtype=bool)
        for kind, text, pred, neg in filters:
            v = self.verified_bools(tkey, table, column, vocab, pred,
                                    kind, text)
            if v is None:
                return None
            combined &= ~v if neg else v
        padded = np.zeros(npad, dtype=bool)
        padded[:n] = combined
        dev = torch.from_numpy(padded).to(_device_of(table))
        if self._admit(npad):
            self._store(mkey, _Entry(root, n, npad, npad=npad, dev=dev))
        return dev, npad


class FulltextProvider:
    """Per-execution binding of (cache, table identity, resident table):
    what query/exprs.py sees as ``ctx.fulltext``."""

    __slots__ = ("cache", "tkey", "table")

    def __init__(self, cache: FulltextIndexCache, tkey: str, table):
        self.cache = cache
        self.tkey = tkey
        self.table = table

    def codes_matching(self, column: str, vocab, pred, kind: str,
                       text: str) -> np.ndarray | None:
        return self.cache.codes_matching(self.tkey, self.table, column,
                                         vocab, pred, kind, text)
