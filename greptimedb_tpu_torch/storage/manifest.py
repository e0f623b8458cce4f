"""Region manifest: versioned action log + checkpoints, CRC-verified.

Equivalent of the reference's manifest (src/mito2/src/manifest/{action.rs,
checkpointer.rs,manager.rs}, SURVEY.md §5.4 mechanism 2): every metadata
mutation (SST add/remove, schema change, flushed-sequence advance, dict
growth) is an appended JSON action file; a checkpoint collapses the prefix
so region open replays O(recent) actions, not history.

Layout under <region>/manifest/:
    checkpoint-<version>.json   full state at version
    delta-<version>.json        one action, applied in version order
    quarantine/<name>           corrupt files moved aside (never deleted)
    QUARANTINED                 marker: open refuses until cleared

Durability hardening (mirroring the reference's checksummed
manifest storage):

- every file is wrapped in a ``GTM1 <crc32>`` envelope and verified on
  open — a bit flip is detected, not parsed into wrong metadata;
- ``commit`` persists the delta BEFORE mutating in-memory state, so a
  failed write can never leave memory a version ahead of disk (the next
  commit would write version+1 over a hole);
- open REFUSES version gaps: deltas must be consecutive from the
  checkpoint base.  A corrupt/missing delta raises ManifestCorruption
  carrying the last good prefix — the region open path recovers through
  WAL replay when the log covers the lost actions, and quarantines the
  region (files moved aside + marker, open fails loudly) when it does
  not;
- ``checkpoint`` read-back-verifies the new checkpoint file before GC
  deletes the deltas it supersedes — GC can never destroy the only
  readable history behind an unreadable checkpoint.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field

from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.errors import FencedError, StorageError
from greptimedb_tpu_torch.storage.durability import (
    M_CORRUPTION,
    M_FENCE_CLAIMS,
    M_FENCE_REJECTED,
    M_QUARANTINED,
    ManifestCorruption,
    RegionQuarantined,
)
from greptimedb_tpu_torch.storage.object_store import ObjectStore, content_etag
from greptimedb_tpu_torch.storage.sst import SstMeta
from greptimedb_tpu_torch.utils.chaos import CHAOS

CHECKPOINT_EVERY = 16

_MAGIC = b"GTM1 "
_QUARANTINE_MARKER = "QUARANTINED"
_EPOCH_MARKER = "EPOCH"


def fencing_enabled() -> bool:
    """GREPTIME_S3_FENCING (default on): epoch-fenced conditional puts
    for manifest/watermark writes on shared object storage.  Off = the
    pre-fencing plain-write behavior everywhere (A/B twin); standalone
    regions never arm a fence either way, so the single-node hot path is
    untouched by the knob."""
    return os.environ.get("GREPTIME_S3_FENCING", "on").lower() not in (
        "off", "0", "false")

_KNOWN_KINDS = frozenset(
    {"edit", "schema", "dicts", "reset_dicts", "truncate", "options",
     "quarantine"})


def _encode_file(obj: dict) -> bytes:
    body = json.dumps(obj).encode()
    return _MAGIC + b"%08x\n" % (zlib.crc32(body) & 0xFFFFFFFF) + body


def _decode_file(data: bytes) -> dict | None:
    """Parse a manifest file; None = corrupt (CRC mismatch / unparsable).
    Files written before the envelope (legacy plain JSON) still load —
    their integrity is best-effort, exactly as before."""
    try:
        if data.startswith(_MAGIC):
            nl = data.index(b"\n", len(_MAGIC))
            want = int(data[len(_MAGIC):nl], 16)
            body = data[nl + 1:]
            if (zlib.crc32(body) & 0xFFFFFFFF) != want:
                return None
            return json.loads(body)
        return json.loads(data)
    except (ValueError, IndexError):
        return None


@dataclass
class ManifestState:
    schema: Schema | None = None
    files: dict[str, SstMeta] = field(default_factory=dict)
    flushed_seq: int = 0
    truncated_seq: int = 0
    # tag dictionaries: column -> list of values (code = index); series
    # registry: list of tuples of tag codes (tsid = index)
    dicts: dict[str, list] = field(default_factory=dict)
    series: list[list[int]] = field(default_factory=list)
    options: dict = field(default_factory=dict)
    # SSTs pulled from the live set after failing read verification:
    # file_id -> meta dict.  Kept in state (not just moved aside on disk)
    # so every node agrees the file is out of service until repaired.
    quarantined: dict[str, dict] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "schema": self.schema.to_dict() if self.schema else None,
            "files": {k: v.to_dict() for k, v in self.files.items()},
            "flushed_seq": self.flushed_seq,
            "truncated_seq": self.truncated_seq,
            "dicts": self.dicts,
            "series": self.series,
            "options": self.options,
            "quarantined": self.quarantined,
        }

    @staticmethod
    def from_dict(d: dict) -> "ManifestState":
        return ManifestState(
            schema=Schema.from_dict(d["schema"]) if d.get("schema") else None,
            files={k: SstMeta.from_dict(v) for k, v in d.get("files", {}).items()},
            flushed_seq=d.get("flushed_seq", 0),
            truncated_seq=d.get("truncated_seq", 0),
            dicts=d.get("dicts", {}),
            series=d.get("series", []),
            options=d.get("options", {}),
            quarantined=d.get("quarantined", {}),
        )

    def apply(self, action: dict) -> None:
        kind = action["kind"]
        if kind == "edit":
            for f in action.get("add", []):
                m = SstMeta.from_dict(f)
                self.files[m.file_id] = m
            for fid in action.get("remove", []):
                self.files.pop(fid, None)
            if "flushed_seq" in action:
                self.flushed_seq = max(self.flushed_seq, action["flushed_seq"])
        elif kind == "schema":
            self.schema = Schema.from_dict(action["schema"])
        elif kind == "dicts":
            # append-only growth of tag dictionaries / series registry
            for col, vals in action.get("dicts", {}).items():
                cur = self.dicts.setdefault(col, [])
                cur.extend(vals[len(cur):])
            self.series.extend(action.get("series", [])[len(self.series):])
        elif kind == "reset_dicts":
            # wholesale replacement: series keys change ARITY when a tag
            # column is added online, which append-only growth cannot express
            self.dicts = dict(action.get("dicts", {}))
            self.series = list(action.get("series", []))
        elif kind == "truncate":
            self.files.clear()
            self.truncated_seq = action["truncated_seq"]
            self.flushed_seq = max(self.flushed_seq, action["truncated_seq"])
        elif kind == "options":
            self.options.update(action["options"])
        elif kind == "quarantine":
            # pull a corrupt SST from the live set (detection) or restore
            # a repaired one (repair) — the scan layer keeps serving the
            # remaining files either way
            fid = action["file_id"]
            if action.get("restore"):
                meta = self.quarantined.pop(fid, None)
                if meta is not None:
                    self.files[fid] = SstMeta.from_dict(meta)
            else:
                meta = self.files.pop(fid, None)
                if meta is not None:
                    self.quarantined[fid] = meta.to_dict()
        else:
            raise ValueError(f"unknown manifest action kind: {kind}")


class Manifest:
    def __init__(self, store: ObjectStore, manifest_dir: str):
        self.store = store
        self.dir = manifest_dir
        self.version = 0
        self.state = ManifestState()
        self._actions_since_checkpoint = 0
        # leader epoch this manifest writes under (None = unfenced, the
        # standalone/local default).  Armed by set_fence at cluster
        # open/failover/migration-upgrade; every subsequent write routes
        # through _write's conditional-put discipline.
        self.fence_epoch: int | None = None

    # ---- epoch fencing ------------------------------------------------
    @property
    def _epoch_path(self) -> str:
        return f"{self.dir}/{_EPOCH_MARKER}"

    def _read_epoch(self) -> tuple[int | None, bytes | None]:
        """(epoch, raw bytes) of the shared EPOCH marker; (None, None)
        when absent, (-1, raw) when unreadably corrupt (scrub repairs;
        fencing decisions treat it as 'unknown', never as newer)."""
        if not self.store.exists(self._epoch_path):
            return None, None
        try:
            raw = self.store.read(self._epoch_path)
        except StorageError:
            return None, None  # deleted between exists and read
        rec = _decode_file(raw)
        if rec is None or "epoch" not in rec:
            M_CORRUPTION.labels("manifest", "epoch").inc()
            return -1, raw
        return int(rec["epoch"]), raw

    def set_fence(self, epoch: int) -> None:
        """Claim the shared EPOCH marker for ``epoch`` and arm fencing:
        every later commit/checkpoint verifies the marker and writes
        deltas create-only, so a fenced-out leader's delayed write fails
        loudly (FencedError) instead of forking history.  Claiming is
        itself a CAS — two racing claimants resolve to the higher epoch,
        and the loser raises here, before it ever writes a delta."""
        epoch = int(epoch)
        data = _encode_file({"epoch": epoch})
        for _ in range(8):
            cur, raw = self._read_epoch()
            if cur is not None and cur > epoch:
                M_FENCE_CLAIMS.labels("lost").inc()
                raise FencedError(
                    f"manifest {self.dir}: epoch {epoch} superseded by "
                    f"{cur}; this leader is fenced out")
            if cur == epoch:  # our own claim (crash-resume re-open)
                self.fence_epoch = epoch
                return
            try:
                if raw is None:
                    self.store.write_if(self._epoch_path, data,
                                        if_none_match=True)
                else:
                    self.store.write_if(self._epoch_path, data,
                                        if_match=content_etag(raw))
            except FencedError:
                continue  # marker moved under us: re-read and re-decide
            M_FENCE_CLAIMS.labels("won").inc()
            self.fence_epoch = epoch
            return
        M_FENCE_CLAIMS.labels("lost").inc()
        raise FencedError(
            f"manifest {self.dir}: could not claim epoch {epoch} "
            "(marker kept moving)")

    def _verify_fence(self, surface: str) -> None:
        """Raise FencedError when the shared EPOCH marker shows a newer
        leader (called before every fenced write).  Covers the window
        conditional-put alone cannot: after checkpoint GC deleted the
        deltas, a zombie's create-only write would otherwise succeed
        against the emptied version space (the ABA shape)."""
        cur, _raw = self._read_epoch()
        if cur is not None and self.fence_epoch is not None \
                and cur > self.fence_epoch:
            M_FENCE_REJECTED.labels(surface).inc()
            raise FencedError(
                f"manifest {self.dir}: write fenced out — epoch "
                f"{self.fence_epoch} superseded by {cur} ({surface})")

    def _write(self, path: str, data: bytes, *, create: bool = False,
               surface: str = "manifest") -> None:
        """THE manifest write path (lint GL-D003 owner: no manifest or
        marker bytes reach the store except through here).  Unfenced
        manifests write plainly — byte-for-byte the pre-fencing
        behavior.  Fenced manifests verify the epoch marker first, and
        version-keyed files (``create=True``: deltas) are create-only
        CAS puts, so two leaders racing on one version resolve to one
        winner."""
        if self.fence_epoch is None:
            # epoch-less writer backstop: if ANYONE has claimed an epoch
            # on this manifest, an unfenced write is a pre-fencing
            # zombie (its region opened before epochs were minted) and
            # must refuse — epoch-less writes bypassing the fence would
            # re-open the interleave.  Standalone manifests never have
            # the marker: one existence probe per commit.
            if fencing_enabled() and self.store.exists(self._epoch_path):
                M_FENCE_REJECTED.labels(surface).inc()
                raise FencedError(
                    f"manifest {self.dir}: epoch-less write refused — "
                    f"a leader epoch is claimed on this manifest "
                    f"({surface}); this writer predates fencing")
            self.store.write(path, data)
            return
        self._verify_fence(surface)
        if not create:
            self.store.write(path, data)
            return
        try:
            self.store.write_if(path, data, if_none_match=True)
            return
        except FencedError:
            pass
        # conflict under OUR verified epoch: nobody else may write here,
        # so the existing object is this leader's own orphaned earlier
        # attempt (the s3.cas crash window — the CAS landed remotely but
        # the ack never came back).  Identical bytes: the commit already
        # landed.  Different bytes: clobber the orphan exactly like the
        # plain-write path always has (it was never applied or acked) —
        # via a conditional REPLACE keyed on the orphan's etag, so a new
        # leader claiming the epoch and touching this version between
        # our verify and the write still loses us the CAS (FencedError)
        # instead of us silently overwriting its history.
        self._verify_fence(surface)  # a REAL fence still raises here
        try:
            existing = self.store.read(path)
        except StorageError:
            existing = None
        if existing is None:
            # the orphan vanished between the conflict and the read —
            # only another writer deletes manifest files; stay loud
            M_FENCE_REJECTED.labels(surface).inc()
            raise FencedError(
                f"manifest {self.dir}: {path} changed under epoch "
                f"{self.fence_epoch} ({surface})")
        if _decode_file(existing) is not None \
                and _decode_file(existing) == _decode_file(data):
            return
        self.store.write_if(path, data, if_match=content_etag(existing))

    # ---- open/replay ----------------------------------------------------
    @staticmethod
    def open(store: ObjectStore, manifest_dir: str) -> "Manifest":
        """Open and verify.  Raises RegionQuarantined when a prior
        uncovered corruption marked the region, and ManifestCorruption
        (carrying the recoverable prefix) when verification fails past a
        good prefix — callers with a WAL decide recovery vs quarantine."""
        m = Manifest(store, manifest_dir)
        entries = store.list(manifest_dir)
        ckpt_versions = []
        delta_versions = []
        for p in entries:
            if f"/{_QUARANTINE_MARKER}" in p or p.endswith(
                    _QUARANTINE_MARKER):
                raise RegionQuarantined(
                    f"manifest {manifest_dir} is quarantined "
                    f"({p}): clear the marker after repair to reopen")
            if "/quarantine/" in p:
                continue  # moved-aside corpses: never re-read as live
            fn = p.rsplit("/", 1)[-1]
            if fn.startswith("checkpoint-"):
                ckpt_versions.append(int(fn[len("checkpoint-"):-len(".json")]))
            elif fn.startswith("delta-"):
                delta_versions.append(int(fn[len("delta-"):-len(".json")]))
        bad_files: list[str] = []
        bad_ckpt_max = None
        base = 0
        # newest checkpoint that verifies wins; corrupt ones are suspects
        for v in sorted(ckpt_versions, reverse=True):
            path = f"{manifest_dir}/checkpoint-{v:020d}.json"
            raw = _decode_file(store.read(path))
            if raw is None:
                M_CORRUPTION.labels("manifest", "checkpoint").inc()
                bad_files.append(path)
                bad_ckpt_max = max(bad_ckpt_max or 0, v)
                continue
            m.state = ManifestState.from_dict(raw)
            m.version = base = v
            break
        detail = None
        tail_only = False
        expected = base + 1
        for v in sorted(x for x in delta_versions if x > base):
            if v != expected:
                # version gap: a delta is MISSING — refuse to silently
                # apply later deltas over the hole.  Deltas exist beyond
                # the hole, so this is mid-chain loss, never tail debris.
                M_CORRUPTION.labels("manifest", "gap").inc()
                detail = f"delta version gap: expected {expected}, found {v}"
                bad_files.extend(
                    f"{manifest_dir}/delta-{w:020d}.json"
                    for w in sorted(x for x in delta_versions if x >= v))
                break
            path = f"{manifest_dir}/delta-{v:020d}.json"
            action = _decode_file(store.read(path))
            if action is None:
                M_CORRUPTION.labels("manifest", "delta").inc()
                detail = f"corrupt delta at version {v}"
                bad_files.extend(
                    f"{manifest_dir}/delta-{w:020d}.json"
                    for w in sorted(x for x in delta_versions if x >= v))
                # crash-debris shape only if NOTHING follows the corpse:
                # the lost action was the last (unacked) commit
                tail_only = max(delta_versions) == v
                break
            m.state.apply(action)
            m.version = v
            expected = v + 1
        if detail is None and bad_files:
            if bad_ckpt_max is not None and m.version >= bad_ckpt_max:
                # a corrupt checkpoint fully superseded by an intact
                # delta chain: nothing is lost — move the corpse aside
                # and open normally (detected + quarantined, not fatal)
                m.quarantine_files(bad_files)
                return m
            detail = "corrupt checkpoint(s) newer than the loaded state"
        if detail is not None:
            raise ManifestCorruption(m, bad_files, detail,
                                     tail_only=tail_only)
        return m

    # ---- corruption handling (driven by the region open path) ----------
    def quarantine_files(self, paths: list[str]) -> None:
        """Move suspect files aside (``quarantine/`` subdir, preserved,
        never deleted) so the recovered prefix can move forward without
        colliding with their version numbers."""
        for p in paths:
            if not self.store.exists(p):
                continue
            fn = p.rsplit("/", 1)[-1]
            self.store.rename(p, f"{self.dir}/quarantine/{fn}")
            M_QUARANTINED.labels("manifest").inc()

    def quarantine_region(self, reason: str) -> None:
        """Uncovered loss: move suspects aside AND mark the region so
        every future open fails loudly until an operator intervenes.
        Fence-checked like any manifest write — a fenced-out zombie must
        not poison the new leader's region with a stale marker."""
        self._write(
            f"{self.dir}/{_QUARANTINE_MARKER}",
            _encode_file({"reason": reason, "version": self.version}),
            surface="quarantine")

    @property
    def exists(self) -> bool:
        return self.state.schema is not None

    # ---- mutation -------------------------------------------------------
    def commit(self, action: dict) -> int:
        if action.get("kind") not in _KNOWN_KINDS:
            raise ValueError(
                f"unknown manifest action kind: {action.get('kind')}")
        data = _encode_file(action)
        after = None
        if CHAOS.enabled:  # durability-boundary crash point + data faults
            data, after = CHAOS.filter_io("manifest.delta", data)
        # persist FIRST, apply on success: a failed write must leave the
        # in-memory state at the on-disk version, or the next commit
        # would write version+2 over a hole (the open-time gap check
        # above would then refuse the whole manifest).  Fenced manifests
        # write create-only: two split-brain leaders racing on this
        # version resolve to ONE winner, the loser raises FencedError
        self._write(f"{self.dir}/delta-{self.version + 1:020d}.json",
                    data, create=True, surface="delta")
        if after is not None:
            raise after
        self.state.apply(action)
        self.version += 1
        self._actions_since_checkpoint += 1
        if self._actions_since_checkpoint >= CHECKPOINT_EVERY:
            self.checkpoint()
        return self.version

    def checkpoint(self) -> None:
        path = f"{self.dir}/checkpoint-{self.version:020d}.json"
        data = _encode_file(self.state.to_dict())
        after = None
        if CHAOS.enabled:  # durability-boundary crash point + data faults
            data, after = CHAOS.filter_io("manifest.checkpoint", data)
        # fence-verified overwrite (not create-only: a crash between a
        # landed checkpoint write and its read-back verification retries
        # the SAME version — and a loser's same-version checkpoint is
        # byte-deterministic from the delta chain both leaders loaded)
        self._write(path, data, surface="checkpoint")
        if after is not None:
            raise after
        # read-back verify BEFORE GC: the deltas this checkpoint
        # supersedes are the only other copy of region metadata — they
        # may only die once the replacement provably reads back clean
        if _decode_file(self.store.read(path)) is None:
            M_CORRUPTION.labels("manifest", "checkpoint").inc()
            raise StorageError(
                f"checkpoint {path} failed read-back verification; "
                "superseded deltas retained")
        self._actions_since_checkpoint = 0
        self._gc_superseded()

    def _gc_superseded(self) -> None:
        """GC deltas/checkpoints the current checkpoint supersedes (never
        the quarantine corner).  Unfenced manifests delete plainly —
        byte-for-byte the pre-fencing behavior.  Fenced manifests verify
        the epoch marker first and then delete conditionally
        (``delete_if`` keyed on each file's observed etag), so a
        fenced-out zombie replaying a stale GC plan loses the CAS
        instead of destroying files a newer leader re-minted under the
        same version numbers (the ABA shape conditional PUT alone does
        not cover on the delete side).  A lost CAS SKIPS the file —
        never falls back to a plain delete."""
        CHAOS.inject("manifest.gc")
        fenced = self.fence_epoch is not None
        if fenced:
            self._verify_fence("gc")
        for p in self.store.list(self.dir):
            if "/quarantine/" in p or p.endswith(_QUARANTINE_MARKER):
                continue
            fn = p.rsplit("/", 1)[-1]
            if fn.startswith("delta-") and int(fn[6:-5]) <= self.version:
                pass
            elif fn.startswith("checkpoint-") and \
                    int(fn[11:-5]) < self.version:
                pass
            else:
                continue
            if not fenced:
                self.store.delete(p)
                continue
            meta = self.store.head(p)
            if meta is None:
                continue  # raced with another GC: already gone
            try:
                self.store.delete_if(p, if_match=meta["etag"])
            except FencedError:
                # file changed between head and delete — a newer leader
                # owns this version space now; leave its bytes alone
                M_FENCE_REJECTED.labels("gc").inc()
