"""Device-resident full-text search and the LogQL read surface.

The port of the JAX package's ``fulltext/``.  Per (table, string column)
every DISTINCT value of the resident dictionary gets a W-word packed
n-gram bloom fingerprint (``[npad, W]`` 32-bit words, held on the db's
device).  A text predicate compiles to a few required-gram query masks;
the hand-written ``fp_candidates`` kernel (``ops/fulltext_kernels.py``,
``csrc/fulltext_kernels.cu``) tests ``(row_fp & qmask) == qmask`` over the
whole matrix, and the exact host predicate runs only on the surviving
candidates, so results are bit-exact against the host path (the prefilter
has false positives, never false negatives).

Modules:

- ``fingerprint`` — the host math (a copy): canonical text form,
  vectorized gram hashing, fingerprint build, required-literal
  extraction, query-mask compilation;
- ``resident``    — the device cache (fingerprint matrices, verified-
  vocabulary memos, combined line-filter vectors) and the per-query
  provider the SQL compiler and the LogQL evaluator share;
- ``logql``       — the LogQL subset parser (a copy);
- ``loki``        — the Loki read-API evaluator; metric queries lower onto
  the PromQL ``window_stats`` kernel through the ``logs_layout`` /
  ``line_vals`` kernels, log queries select rows with ``row_match``.

``GREPTIME_FULLTEXT=off`` restores the host-side predicate paths
byte-for-byte (this package's caches are never consulted).
"""

from greptimedb_tpu_torch.fulltext.fingerprint import enabled  # noqa: F401
