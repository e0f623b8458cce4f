"""Crash-consistent flow state: GTF1 checkpoints + WAL-offset watermarks.

Reference analog: the flownode's batching-mode checkpoint
(src/flow/src/batching_mode/) and the common-meta flow key space; the
envelope/fsync discipline matches the manifest (GTM1) and AOT-store
(GTC1) formats.

A checkpoint is one file per flow holding the flow's durable identity
(SQL hash + engine mode), its standing aggregate state (device matrices
+ dictionaries, host dict-of-partials, or a batching flow's pending
dirty windows), and the WATERMARK: the last WAL sequence folded per
source region, exact by construction because folds consume the region
append log in sequence order (flow/device.py pump).

Restart / flownode reassignment then resume by replaying only the WAL
tail PAST the watermark — the tail lives in the source region's
memtable (the region's own WAL replay put it there at open), so resume
is a seq-filtered memtable fold with zero SST reads and no source
re-scan.  A tail the memtable no longer covers (flush advanced past the
watermark) or that contains non-append writes degrades to a seq-bounded
scan reseed — never silently wrong.

Envelope: ``GTF1 | crc32(payload) | pickle(payload)``; corrupt or
truncated files quarantine to ``<name>.quarantine`` and restore reports
a miss (the flow reseeds).  Writes are tmp + fsync + rename + dir-fsync
(storage/object_store.py discipline).  Checkpoints ship between
flownodes over the Flight object plane when their data homes
differ (``ship``), so reassignment restores instead of re-backfilling.

Torch counterpart of the reference's ``flow/checkpoint.py``.  The format
is the same GTF1 envelope and payload (numpy arrays and dicts; device
state crosses as host arrays), so either package restores the other's
checkpoints.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
import time
import zlib

import numpy as np

from greptimedb_tpu_torch.compile.store import atomic_write
from greptimedb_tpu_torch.errors import FencedError
from greptimedb_tpu_torch.storage.memtable import OP, SEQ
from greptimedb_tpu_torch.storage.object_store import _fsync_dir
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

MAGIC = b"GTF1"

M_CKPT = REGISTRY.counter(
    "greptime_flow_checkpoint_total",
    "Flow checkpoint events (save/restore/tail_replay/corrupt/miss/"
    "reseed_fallback)",
    labels=("event",),
)


def flow_sql_hash(task) -> str:
    from greptimedb_tpu_torch.flow.engine import select_to_sql

    ident = f"{task.name}|{task.sink_table}|{select_to_sql(task.query)}"
    return hashlib.sha256(ident.encode()).hexdigest()[:16]


_EPOCH_FILE = "EPOCH"


class FlowCheckpointStore:
    """One checkpoint file per flow under ``<data_home>/flow_ckpt``.

    Epoch fencing (the manifest EPOCH discipline applied to
    flow checkpoints): when flownodes share a checkpoint root, the
    failover winner claims a monotonically increasing epoch in the
    shared ``EPOCH`` marker.  Destructive operations (``delete``) from
    a holder of an OLDER epoch — a fenced-out zombie replaying a stale
    drop/reassign plan — refuse with FencedError instead of destroying
    the new owner's checkpoint.  Epoch-less deletes stay unconditional,
    byte-for-byte the pre-fencing behavior (standalone engines never
    mint the marker)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.saves = 0
        self.loads = 0
        self.corrupt = 0
        self.epoch: int | None = None  # this holder's claimed epoch

    def path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.ckpt")

    # ---- epoch fencing -------------------------------------------------
    def current_epoch(self) -> int | None:
        """The shared marker's epoch, or None when never claimed (or
        unreadable — fencing treats 'unknown' as 'not newer', matching
        the manifest's corrupt-marker stance)."""
        try:
            with open(os.path.join(self.root, _EPOCH_FILE), "rb") as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def claim(self, epoch: int) -> None:
        """Claim the marker for ``epoch`` and arm fencing on this store.
        A claim below the marker's current value loses — the claimant is
        already fenced out and must not touch checkpoints here."""
        epoch = int(epoch)
        cur = self.current_epoch()
        if cur is not None and cur > epoch:
            M_CKPT.labels("fenced_claim").inc()
            raise FencedError(
                f"flow checkpoints {self.root}: epoch {epoch} superseded "
                f"by {cur}; this claimant is fenced out")
        if cur != epoch:
            atomic_write(os.path.join(self.root, _EPOCH_FILE),
                         str(epoch).encode())
        self.epoch = epoch

    def save(self, name: str, payload: dict) -> bool:
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        body = MAGIC + struct.pack("<I", zlib.crc32(blob) & 0xFFFFFFFF) + blob
        try:
            # atomic_write (compile/store.py): unique pid+thread tmp +
            # fsync + replace + dir-fsync — saves are reachable
            # concurrently from scheduler idle workers and the executor,
            # and each writer must be atomic on its own
            atomic_write(self.path(name), body)
        except OSError:
            return False
        self.saves += 1
        M_CKPT.labels("save").inc()
        return True

    def load_bytes(self, name: str) -> bytes | None:
        try:
            with open(self.path(name), "rb") as f:
                return f.read()
        except OSError:
            return None

    def put_bytes(self, name: str, body: bytes) -> None:
        """Install shipped checkpoint bytes verbatim (object plane)."""
        atomic_write(self.path(name), body)

    def load(self, name: str) -> dict | None:
        body = self.load_bytes(name)
        if body is None:
            M_CKPT.labels("miss").inc()
            return None
        if len(body) < 8 or body[:4] != MAGIC:
            self._quarantine(name)
            return None
        (crc,) = struct.unpack("<I", body[4:8])
        blob = body[8:]
        if zlib.crc32(blob) & 0xFFFFFFFF != crc:
            self._quarantine(name)
            return None
        try:
            payload = pickle.loads(blob)
        except Exception:  # noqa: BLE001 — crc passed but unpicklable
            self._quarantine(name)
            return None
        self.loads += 1
        M_CKPT.labels("restore").inc()
        return payload

    def _quarantine(self, name: str) -> None:
        """Never serve corrupt state; preserve the bytes for forensics
        (the manifest's quarantine discipline)."""
        self.corrupt += 1
        M_CKPT.labels("corrupt").inc()
        path = self.path(name)
        try:
            os.replace(path, path + ".quarantine")
            _fsync_dir(self.root)
        except OSError:
            pass

    def delete(self, name: str, *, epoch: int | None = None) -> None:
        """Remove one flow's checkpoint.  With ``epoch`` (or a claimed
        ``self.epoch``) the delete is FENCED: it refuses when the shared
        marker shows a newer claimant — a zombie's stale drop plan must
        not destroy the checkpoint the new owner restores from."""
        if epoch is None:
            epoch = self.epoch
        if epoch is not None:
            cur = self.current_epoch()
            if cur is not None and cur > epoch:
                M_CKPT.labels("fenced_delete").inc()
                raise FencedError(
                    f"flow checkpoints {self.root}: delete of {name!r} "
                    f"fenced out — epoch {epoch} superseded by {cur}")
        try:
            os.unlink(self.path(name))
            _fsync_dir(self.root)
        except OSError:
            pass

    def flows(self) -> list[str]:
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in names:
            if n.endswith(".ckpt"):
                out.append(n[: -len(".ckpt")])
        return sorted(out)


def ship(src: "FlowCheckpointStore", dst: "FlowCheckpointStore",
         name: str, object_client=None) -> bool:
    """Copy one flow's checkpoint between stores.  ``object_client``
    (rpc/client.py Flight object plane) carries the bytes when the
    stores live on different nodes; same-home stores copy directly."""
    if src.root == dst.root:
        return True  # shared data home: nothing to move
    if object_client is not None:
        try:
            body = object_client.fetch_object(src.path(name))
        except Exception:  # noqa: BLE001 — remote miss: fall through
            body = src.load_bytes(name)
    else:
        body = src.load_bytes(name)
    if body is None:
        return False
    dst.put_bytes(name, body)
    return True


# ---------------------------------------------------------------------------
# Payload build / apply (engine-mode aware)
# ---------------------------------------------------------------------------


def build_payload(engine, task) -> dict | None:
    """Snapshot one flow's resumable state.  Must run under the engine's
    fold lock so the state and its watermark are mutually consistent."""
    base = {
        "flow": task.name,
        "sql_hash": flow_sql_hash(task),
        "saved_ms": int(time.time() * 1000),
    }
    runtime = engine.runtime
    st = getattr(task, "device_state", None)
    if st is not None and runtime is not None:
        base["mode"] = "device"
        base["state"] = st.to_payload()
        return base
    if task.mode == "streaming":
        wm = getattr(task, "watermark", None)
        if wm is None:
            return None  # never pumped: nothing resumable to record
        base["mode"] = "host_stream"
        base["state"] = {
            # DEEP copy: the inner slot dicts mutate in place under later
            # folds (merge_into), and the pickle runs OUTSIDE the fold
            # lock — a shared slot would leak post-watermark contributions
            # into the snapshot and double-count on tail replay
            "stream_state": {k: dict(v)
                             for k, v in task.stream_state.items()},
            "folded": dict(wm),
            "max_ts": dict(getattr(task, "max_ts_folded", {})),
        }
        return base
    base["mode"] = "batching"
    base["state"] = {
        "dirty": sorted(task.dirty),
        "folded": dict(getattr(task, "watermark", {}) or {}),
    }
    return base


def _tail_chunks(db, task, folded: dict, max_ts: dict):
    """Memtable chunks past the watermark, per region, in sequence order;
    None when the tail is not cleanly replayable (flush truncated past
    the watermark, a non-append write in the tail, an unknown region) —
    the caller reseeds instead."""
    try:
        regions = db._regions_of(task.source_table)
    except Exception:  # noqa: BLE001 — source missing
        return []
    out = []
    for region in regions:
        rid = region.region_id
        wm = folded.get(rid)
        if wm is None:
            return None
        if region.manifest.state.flushed_seq > wm:
            return None  # tail flushed out of the memtable: reseed
        # position BEFORE the snapshot: a chunk landing in between shows
        # up in both, and the pump's seq<=watermark skip dedups it
        pos0 = region.append_pos
        chunks = [c for c in region.memtable.snapshot_chunks()
                  if len(c[SEQ]) and int(c[SEQ][0]) > wm]
        chunks.sort(key=lambda c: int(c[SEQ][0]))
        expected = wm
        mt = max_ts.get(rid)
        if mt is None and chunks:
            return None  # no folded-ts high-water mark: can't vet the tail
        for c in chunks:
            seq = int(c[SEQ][0])
            if seq != expected + 1:
                return None
            expected = seq
            if int(c[OP][0]) != 0:
                return None  # delete tombstones in the tail
            ts = np.asarray(c[region.ts_name])
            # replicate the APPENDABLE classification over the tail
            # itself, with the checkpointed max as the floor: a chunk
            # overlapping anything folded before it — the checkpointed
            # prefix OR an EARLIER TAIL CHUNK — may be an upsert, and
            # folding both the original and the overwriting row would
            # double-count (repro: append then upsert of the same
            # tail row, crash, restore showed 7.0 for a true 6.0)
            if int(ts.min()) <= mt:
                return None
            if len(ts) > 1:
                # within-chunk duplicate (series, ts) keys dedup
                # keep-last in the memtable but would fold twice here
                from greptimedb_tpu_torch.storage.memtable import TSID

                tsid = np.asarray(c[TSID]).astype(np.int64)
                rel = ts.astype(np.int64) - int(ts.min())
                if int(tsid.max()) < (1 << 30) and int(rel.max()) < (1 << 34):
                    packed = (tsid << 34) | rel
                    if len(np.unique(packed)) != len(packed):
                        return None
                else:
                    pairs = np.stack([tsid, ts.astype(np.int64)], axis=1)
                    if len(np.unique(pairs, axis=0)) != len(pairs):
                        return None
            mt = max(mt, int(ts.max()))
        out.append((region, chunks, pos0))
    return out


def apply_payload(engine, task, payload: dict) -> bool:
    """Restore one flow from its checkpoint + WAL-tail replay.  Returns
    False when the checkpoint does not apply (stale SQL, wrong mode,
    unreplayable tail) — the caller falls back to reseed/backfill."""
    if payload.get("sql_hash") != flow_sql_hash(task):
        return False
    mode = payload.get("mode")
    db = engine.db
    runtime = engine.runtime
    if mode == "device" and runtime is not None \
            and task.mode == "streaming" \
            and not getattr(task, "device_failed", False):
        from greptimedb_tpu_torch.flow.device import DeviceFlowState, build_spec

        spec = build_spec(db, task)
        if spec is None:
            return False
        st = DeviceFlowState.from_payload(
            spec, payload["state"], device=runtime.device)
        if st is None:
            return False
        if runtime.memory_probe is not None and not runtime.memory_probe(
                st.nbytes()):
            return False
        tails = _tail_chunks(db, task, st.folded, st.max_ts)
        if tails is None:
            M_CKPT.labels("reseed_fallback").inc()
            return False
        runtime.states[task.name] = st
        task.device_state = st
        now = int(time.time() * 1000)
        for region, chunks, pos0 in tails:
            for chunk in chunks:
                runtime.fold_chunk(task, st, region, chunk, upsert=False,
                                   now_ms=now)
                st.folded[region.region_id] = int(chunk[SEQ][0])
            st.positions[region.region_id] = pos0
        task.needs_backfill = False
        runtime.upsert_all(task, st, now_ms=now)
        if any(chunks for _r, chunks, _p in tails):
            M_CKPT.labels("tail_replay").inc()
        runtime.last_restore[task.name] = "checkpoint"
        task.restored_from_checkpoint = True
        return True
    if mode == "host_stream" and task.mode == "streaming":
        state = payload["state"]
        folded = dict(state["folded"])
        tails = _tail_chunks(db, task, folded, dict(state.get("max_ts", {})))
        if tails is None:
            M_CKPT.labels("reseed_fallback").inc()
            return False
        task.stream_state = dict(state["stream_state"])
        task.watermark = folded
        task.max_ts_folded = dict(state.get("max_ts", {}))
        task.needs_backfill = False
        replayed = False
        for region, chunks, pos0 in tails:
            task.positions = getattr(task, "positions", {})
            task.positions[region.region_id] = pos0
            for chunk in chunks:
                engine._host_fold_chunk(task, region, chunk)
                replayed = True
        if replayed:
            M_CKPT.labels("tail_replay").inc()
        # refresh the sink from the full restored state: a pre-crash
        # upsert may not have been durable while the checkpoint was
        if task.stream_state:
            engine._upsert_finalized(task, list(task.stream_state))
        task.restored_from_checkpoint = True
        return True
    if mode == "batching" and task.mode == "batching":
        state = payload["state"]
        folded = dict(state.get("folded", {}))
        try:
            regions = db._regions_of(task.source_table)
        except Exception:  # noqa: BLE001
            regions = []
        # VALIDATE before mutating: a flush past the watermark means the
        # tail windows are unrecoverable here — the caller falls back to
        # full-range marking, and the task must keep a CLEAN slate (a
        # half-applied watermark would block _advance_batching's
        # first-contact re-seed and wedge every later restore)
        for region in regions:
            if region.manifest.state.flushed_seq > folded.get(
                    region.region_id, -1):
                return False
        task.watermark = folded
        task.dirty.update(state.get("dirty", ()))
        # windows of every row past the watermark re-mark dirty
        for region in regions:
            wm = folded.get(region.region_id, -1)
            for c in region.memtable.snapshot_chunks():
                if len(c[SEQ]) and int(c[SEQ][0]) > wm:
                    task.mark_dirty(np.asarray(c[region.ts_name]))
        task.restored_from_checkpoint = True
        return True
    return False
