"""The ONE exact-watermark append-log consumer.

Both streaming-flow engines — the host dict-of-partials fold
(flow/engine.py ``_pump_host_stream``) and the device partial-matrix
fold (flow/device.py ``_pump_device``) — consume source regions' append
logs in WAL-sequence order with the same discipline: remember an
absolute log position per region, fold strictly consecutive sequences,
and bail to a reseed on anything that breaks the invariant.  Two copies
of that discipline drifted once already, so
it now lives here and both pumps call it with their fold callback.

Invariants the consumer enforces:

- **Exact watermarks.**  A chunk folds only when its sequence is
  ``watermark + 1``; the watermark advances chunk-by-chunk, so a crash
  between folds restores to a watermark that exactly bounds the folded
  prefix (flow/checkpoint.py persists it).
- **Gap = reseed.**  A sequence hole means an UNLOGGED write holds it
  (upsert/delete never enters the append log) — incremental state can
  no longer be trusted and the caller reseeds from a scan.
- **Trim = reseed.**  A consumer behind the trimmed window was stale
  anyway; ``append_chunks_since`` returning None sends it back through
  the seed scan.
"""

from __future__ import annotations

from greptimedb_tpu_torch.storage.memtable import SEQ


def drain_append_log(regions, positions: dict, watermarks: dict,
                     fold_chunk) -> str | None:
    """Drain new append-log chunks of every region into ``fold_chunk``
    (called as ``fold_chunk(region, chunk)``), advancing ``positions``
    (absolute append-log positions) and ``watermarks`` (last folded WAL
    sequence) per region — both mutated in place.

    Returns None when every region drained clean, else the reseed
    reason (``"new_region"`` | ``"trimmed"`` | ``"gap"``) with the maps
    left exactly as consumed so far — the caller reseeds from a scan.
    """
    for region in regions:
        rid = region.region_id
        pos = positions.get(rid)
        if pos is None:
            # a region that appeared after the seed (repartition): its
            # rows were never folded
            return "new_region"
        chunks = region.append_chunks_since(pos)
        if chunks is None:
            return "trimmed"
        wm = watermarks.get(rid, -1)
        for chunk in chunks:
            seq = int(chunk[SEQ][0])
            pos += 1
            if seq <= wm:
                continue  # covered by the seed scan
            if seq != wm + 1:
                # an unlogged write (upsert/delete) holds this sequence:
                # incremental state can no longer be trusted
                return "gap"
            fold_chunk(region, chunk)
            wm = seq
            # advance chunk-by-chunk (not once after the loop): a crash
            # between folds must restore to a watermark that exactly
            # bounds the folded prefix
            watermarks[rid] = wm
        positions[rid] = pos
    return None
