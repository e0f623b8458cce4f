"""Host batch helpers shared by the region write path and the grid build.

The port keeps the reference's host parts (``DictionaryEncoder``,
``DictColumn``, ``pad_rows``); the reference's ``RecordBatch`` and the
device-side ``DeviceBatch`` wait for the row-path slice.
"""

from __future__ import annotations

import numpy as np

_MIN_BUCKET = 128


def pad_rows(n: int, min_bucket: int = _MIN_BUCKET) -> int:
    """Shape-class bucket for n rows.

    Powers of two up to 4M rows (few classes, cheap recompiles); above that,
    multiples of 2M — pure pow2 would waste up to 2x memory bandwidth on
    padding (e.g. 34.5M rows -> 64M), which dominates large scans.
    """
    if n <= min_bucket:
        return min_bucket
    if n <= (1 << 22):
        return 1 << (n - 1).bit_length()
    step = 1 << 21
    return -(-n // step) * step


class DictColumn:
    """Dictionary-compressed string column on the ingest wire→device path:
    a tiny unique-value vocabulary plus per-row int32 codes — the
    ``__tagcode_*__`` trick in reverse, applied at wire-parse time.

    The vectorized protocol parsers (servers/protocols.py) emit tag columns
    in this form so no per-row Python string object is materialized between
    the wire bytes and the region write; ``Region._encode_tags`` consumes
    the (codes, values) pair directly as a pre-factorized column.  Supports
    just enough of the ndarray surface (len/getitem/take) for routing and
    schema probing; ``materialize()`` produces the object array (a C-level
    fancy-index over the shared vocabulary objects) for consumers that
    need raw values."""

    __slots__ = ("values", "codes")

    def __init__(self, values: np.ndarray, codes: np.ndarray):
        # values: object array of unique strings; codes: int32 per row
        self.values = np.asarray(values, dtype=object)
        self.codes = np.asarray(codes, dtype=np.int32)

    def __len__(self) -> int:
        return len(self.codes)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self.values[self.codes[i]]
        return DictColumn(self.values, self.codes[i])

    def __iter__(self):
        return iter(self.materialize())

    def __eq__(self, other):
        if isinstance(other, str):
            # vectorized filter: one vocabulary probe, codes compare at C
            # speed (no per-row string comparison)
            hit = np.nonzero(self.values == other)[0]
            if len(hit) == 0:
                return np.zeros(len(self.codes), dtype=bool)
            return self.codes == hit[0]
        if isinstance(other, (list, tuple)):
            return self.materialize().tolist() == list(other)
        if isinstance(other, DictColumn):
            other = other.materialize()
        if isinstance(other, np.ndarray):
            return self.materialize() == other
        return NotImplemented

    __hash__ = None  # mutable-ish container semantics, like ndarray

    @staticmethod
    def from_arrow(col) -> "DictColumn | None":
        """Arrow string/dictionary Array → DictColumn, or None when the
        column needs the object path instead: nulls among the rows, OR a
        null vocabulary entry (which hides from ``col.null_count`` but
        would smuggle None through the coded path).  The one conversion
        every columnar ingest surface (arrow bulk, Flight do_put) shares.
        """
        import pyarrow as pa

        if col.null_count:
            return None
        if pa.types.is_dictionary(col.type):
            if col.dictionary.null_count:
                return None
            return DictColumn(
                np.asarray(col.dictionary.to_pylist(), dtype=object),
                col.indices.to_numpy(zero_copy_only=False),
            )
        # C-level dictionary encode: the vocabulary is the only object
        # array (tag columns repeat heavily)
        d = col.dictionary_encode()
        return DictColumn(
            np.asarray(d.dictionary.to_pylist(), dtype=object),
            d.indices.to_numpy(zero_copy_only=False),
        )

    def take(self, indices: np.ndarray) -> "DictColumn":
        return DictColumn(self.values, self.codes[indices])

    def materialize(self) -> np.ndarray:
        """Per-row object array; rows share the vocabulary's string
        objects (refcount bumps at C speed, no new PyObjects)."""
        return self.values[self.codes]


class DictionaryEncoder:
    """Stable string→int32 dictionary (the metric-engine ``__tsid`` idea,
    reference src/metric-engine/src/row_modifier.rs: label values become
    dense ids early so the device only sees ints)."""

    def __init__(self, initial: list | None = None):
        self._map: dict = {}
        self._values: list = []
        if initial:
            for v in initial:
                self.get_or_insert(v)

    def get_or_insert(self, v) -> int:
        code = self._map.get(v)
        if code is None:
            code = len(self._values)
            self._map[v] = code
            self._values.append(v)
        return code

    def get(self, v) -> int:
        """Code for v, or -1 if unseen (encodes to 'no match' on device)."""
        return self._map.get(v, -1)

    def encode(self, arr: np.ndarray) -> np.ndarray:
        return np.fromiter(
            (self.get_or_insert(v) for v in arr), dtype=np.int32, count=len(arr)
        )

    def values(self) -> list:
        return list(self._values)

    def __len__(self) -> int:
        return len(self._values)
