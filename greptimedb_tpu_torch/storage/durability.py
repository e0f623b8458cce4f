"""Crash-consistent storage: corruption detection, quarantine, repair.

Reference analogs: raft-engine's recovery modes (TolerateTailCorruption
vs AbsoluteConsistency — a torn tail is expected crash debris, interior
corruption is data loss that must be surfaced), mito2's checksummed
manifest (src/mito2/src/manifest/) and Taurus-style repair-from-replica
(arXiv 2506.20010: log/page durability with explicit corruption
detection + repair is what makes a disaggregated store production
grade).  The shared contract for every store (WAL, manifest, SST):

- **detected**: every byte rehydrated from disk is verified (CRC'd
  manifest files, header+payload-checksummed WAL records, Parquet page
  checksums);
- **quarantined**: damaged bytes are moved aside (``.quarantine``
  sidecars / ``manifest/quarantine/``), never deleted — an operator or
  a later tool can still inspect them;
- **surfaced**: ``greptime_durability_corruption_total{store,kind}``
  counts every detection, quarantines and repairs have their own
  counters;
- **repaired or refused**: a covered loss is resynced (remote WAL,
  follower replica over the Flight object plane, WAL re-flush); an
  uncovered loss fails OPEN loudly — corruption is never silently
  served and acked writes are never silently dropped.
"""

from __future__ import annotations

from greptimedb_tpu_torch.errors import StorageError
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

M_CORRUPTION = REGISTRY.counter(
    "greptime_durability_corruption_total",
    "Corruptions detected while reading local durability stores",
    labels=("store", "kind"),
)
M_QUARANTINED = REGISTRY.counter(
    "greptime_durability_quarantined_total",
    "Damaged files/spans moved aside (never deleted) after detection",
    labels=("store",),
)
M_REPAIRED = REGISTRY.counter(
    "greptime_durability_repaired_total",
    "Corruptions repaired, by store and repair source",
    labels=("store", "source"),
)
# Epoch fencing on shared object storage: claims are the
# leadership handoffs minted by Metasrv; rejections are fenced-out
# leaders stopped BEFORE they could fork history.
M_FENCE_CLAIMS = REGISTRY.counter(
    "greptime_fence_claims_total",
    "Leader-epoch fence claims on shared storage",
    labels=("outcome",),
)
M_FENCE_REJECTED = REGISTRY.counter(
    "greptime_fence_rejected_total",
    "Writes refused by epoch fencing, by write surface",
    labels=("surface",),
)


class CorruptionError(StorageError):
    """Verified-read failure: on-disk bytes do not match their checksums."""


class SstCorruption(CorruptionError):
    """A Parquet SST failed page-checksum/decode verification on read."""

    def __init__(self, meta, cause: Exception):
        super().__init__(
            f"corrupt SST {meta.path} ({meta.num_rows} rows, "
            f"seq [{meta.seq_min},{meta.seq_max}]): {cause}")
        self.meta = meta
        self.cause = cause


class ManifestCorruption(CorruptionError):
    """Manifest open found corrupt/missing files past a good prefix.

    Carries the best recoverable prefix (``manifest``) plus the suspect
    file list; the region open path decides between recovery (WAL covers
    the lost actions) and region quarantine (it does not).
    """

    def __init__(self, manifest, bad_files: list[str], detail: str,
                 tail_only: bool = False):
        super().__init__(
            f"manifest corruption in {manifest.dir}: {detail} "
            f"(good prefix at version {manifest.version}, "
            f"suspect files: {bad_files})")
        self.manifest = manifest
        self.bad_files = bad_files
        self.detail = detail
        # True = the damage sits at the TAIL of the delta chain (the
        # crash-debris shape: the lost action was the unacked one being
        # written).  Only this shape is eligible for WAL-covered
        # recovery — mid-chain rot may have destroyed schema/dicts
        # actions that replay cannot re-derive, so it must quarantine.
        self.tail_only = tail_only


class RegionQuarantined(StorageError):
    """The region's manifest is quarantined: open refuses until an
    operator clears the marker (corruption must never be served)."""


class WalHole(StorageError):
    """Interior WAL corruption lost an acked sequence range and no
    resync source covered it — surfaced instead of silently dropping."""

    def __init__(self, region_id: int, ranges: list[tuple[int, int]]):
        super().__init__(
            f"region {region_id}: WAL interior corruption lost acked "
            f"sequence range(s) {ranges} and no resync source covers "
            "them; damaged bytes preserved in .quarantine sidecars")
        self.ranges = ranges


def quarantine_object(store, path: str) -> str:
    """Move ``path`` aside to ``path + '.quarantine'`` (bytes preserved,
    original name freed for a repaired copy).  Returns the new path."""
    qpath = path + ".quarantine"
    store.rename(path, qpath)
    return qpath


# ---- resync / repair source plumbing ---------------------------------------


def resync_from_log_store(log):
    """WAL resync callable from any LogStore (a follower's local WAL, a
    SharedLogBroker topic via RemoteLogStore): returns
    ``fetch(from_seq, to_seq) -> list[(seq, payload)]`` over the
    inclusive range, replaying read-only (never repairs a store it does
    not own)."""

    def fetch(from_seq: int, to_seq: int):
        out = []
        for seq, payload in log.replay(from_seq, repair=False):
            if from_seq <= seq <= to_seq:
                out.append((seq, payload))
        return out

    return fetch


def resync_from_peer_wal(client, region_id: int):
    """WAL resync over the Flight object plane: fetch the peer
    replica's WAL segment objects (visible under its data home as
    ``region_<id>/wal/*.wal``) and scan them locally for the missing
    range.  ``client`` needs ``list_region_objects``/``fetch_object``
    (DatanodeClient or an in-process Datanode)."""
    import os
    import tempfile

    from greptimedb_tpu_torch.storage.wal import FileLogStore

    def fetch(from_seq: int, to_seq: int):
        with tempfile.TemporaryDirectory() as tmp:
            names = [p for p in client.list_region_objects(region_id)
                     if "/wal/" in p and p.endswith(".wal")]
            if not names:
                return []
            for p in names:
                data = client.fetch_object(p)
                # gl: allow[GL-D001] -- scratch copy of a PEER's WAL in a TemporaryDirectory, read-only-scanned then deleted; no durability surface
                with open(os.path.join(tmp, p.rsplit("/", 1)[-1]),
                          "wb") as f:
                    f.write(data)
            # read-only scan of OUR copies: repair here never touches
            # the peer, and a torn tail in the copy just ends the scan
            log = FileLogStore(tmp)
            try:
                return resync_from_log_store(log)(from_seq, to_seq)
            finally:
                log.close()

    return fetch


def repair_sst_from_peer(client):
    """SST repair source over the Flight object plane: returns
    ``fetch(path) -> bytes | None`` pulling the replica's copy of the
    object; None when the peer does not have it."""

    def fetch(path: str):
        try:
            data = client.fetch_object(path)
        except Exception:  # noqa: BLE001 — a missing/unreachable peer
            return None    # is "not covered", not a new failure mode
        return data or None

    return fetch
