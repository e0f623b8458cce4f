"""Write-ahead log: segmented, CRC-checked, per-region append log.

Equivalent of the reference's raft-engine local WAL
(src/log-store/src/raft_engine/) behind the LogStore trait
(src/store-api/src/logstore.rs:51): entries are (region, sequence, payload)
appended durably before memtable writes; region open replays entries past
the flushed sequence (SURVEY.md §5.4 mechanism 1). A Kafka-style remote WAL
can implement the same LogStore interface later.

Record format (little-endian): [u32 len][u32 crc32(payload)][u64 sequence]
[u32 crc32(header)][payload]. The header CRC covers the 16-byte
(len, payload-crc, sequence) prefix so a bit flip ANYWHERE in a record —
including the sequence field — is detected; a payload-only checksum
would let a flipped sequence replay as a wrong-but-valid record.
Payloads are columnar row groups serialized with Arrow IPC — portable
and fast, no pickle.

Corruption triage (the raft-engine recovery-modes analog):
replay distinguishes a **torn tail** (crash debris at the end of the
active segment — truncated, today's behavior, correct) from **interior
corruption** (bit rot inside acked records): on a bad record it scans
forward for the next valid record boundary, counts the event in
``greptime_durability_corruption_total{store="wal",kind=...}``, copies
the damaged bytes to a ``.quarantine`` sidecar (originals preserved,
never deleted), keeps replaying past the hole, and reports the lost
sequence range in ``last_triage`` so the region can resync it from the
remote WAL or a follower replica before declaring data loss
(``heal()`` then compacts the damaged span out of the segment).

Group commit (``GREPTIME_WAL_GROUP_COMMIT``, default on): concurrent
appenders hand their encoded records to a per-log committer; one of them
becomes the flush leader and writes EVERY buffered record with a single
buffered write + flush (+ one fsync when ``sync``), while followers block
until their record is durable — the classic leader/follower group commit
(InnoDB redo, Kafka producer batching).  A lone writer never waits: the
leader flushes immediately and arrivals during its write accumulate for
the NEXT leader.  ``GREPTIME_WAL_LINGER_MS`` optionally makes a leader
hold the batch open for that long when the PREVIOUS flush was contended
(batch > 1) — deeper batches per fsync on slow devices, no added latency
when traffic is serial.  Each writer is acked only after the flush (and
fsync, when enabled) covering its record returns.
"""

from __future__ import annotations

import os
import io
import struct
import threading
import time
import zlib
from dataclasses import dataclass

from greptimedb_tpu_torch.storage.durability import M_CORRUPTION, M_QUARANTINED
from greptimedb_tpu_torch.storage.object_store import _fsync_dir
from greptimedb_tpu_torch.utils import telemetry
from greptimedb_tpu_torch.utils.chaos import CHAOS

# record header: [u32 len][u32 crc32(payload)][u64 seq] + [u32 crc32(hdr)]
_HDR = struct.Struct("<IIQ")
_HCRC = struct.Struct("<I")
_REC_HDR = _HDR.size + _HCRC.size  # 20 bytes
_SEGMENT_TARGET = 64 * 1024 * 1024

# CRC of record payloads: the C++ helper (same polynomial, sliced table)
# is ~2x zlib on the MB-sized payloads group commit produces and runs
# GIL-free through ctypes, letting concurrent appenders' checksums
# overlap; zlib is the always-present fallback and reads identically on
# replay (identical CRC-32)
try:
    from greptimedb_tpu_torch import native as _native

    _crc32 = _native.crc32 if _native.lib() is not None else None
except Exception:  # pragma: no cover — native build is best-effort
    _crc32 = None


def _payload_crc(payload: bytes) -> int:
    if _crc32 is not None and len(payload) >= 1 << 16:
        return _crc32(payload)
    return zlib.crc32(payload)


def _pack_record(sequence: int, payload: bytes) -> bytes:
    hdr = _HDR.pack(len(payload), _payload_crc(payload), sequence)
    return hdr + _HCRC.pack(zlib.crc32(hdr)) + payload


def _native():
    try:
        from greptimedb_tpu_torch import native
    except ImportError:
        return None
    return native


def _scan(data: bytes, off: int, native_mod):
    """Scan valid records from ``off``; returns ``(spans, end)`` where
    spans are (seq, payload_off, payload_len) and ``end`` is the offset
    after the last valid record (== len(data) on a clean scan)."""
    if native_mod is not None:
        view = data if off == 0 else data[off:]
        scanned = native_mod.wal_scan(view, 0)
        if scanned is not None:
            spans, end = scanned
            if off:
                spans = [(s, o + off, ln) for s, o, ln in spans]
                end += off
            return spans, end
    spans = []
    n = len(data)
    while off + _REC_HDR <= n:
        ln, crc, seq = _HDR.unpack_from(data, off)
        (hcrc,) = _HCRC.unpack_from(data, off + _HDR.size)
        if zlib.crc32(data[off:off + _HDR.size]) != hcrc:
            break
        end = off + _REC_HDR + ln
        if end > n:
            break
        if zlib.crc32(data[off + _REC_HDR:end]) != crc:
            break
        spans.append((seq, off + _REC_HDR, ln))
        off = end
    return spans, off


def _parse_v1(data: bytes, off: int):
    """Legacy 16-byte-header record ([len][crc(payload)][seq], no header
    CRC) at ``off`` — read compatibility for data homes written before
    the v2 format (tests/compat fixtures).  Returns (seq, payload_off,
    payload_len) or None.  Only consulted where a v2 parse failed, so a
    v2 record never misreads as v1."""
    if off + _HDR.size > len(data):
        return None
    ln, crc, seq = _HDR.unpack_from(data, off)
    end = off + _HDR.size + ln
    if end > len(data):
        return None
    if zlib.crc32(data[off + _HDR.size:end]) != crc:
        return None
    return seq, off + _HDR.size, ln


def _walk(data: bytes, native_mod):
    """Classify a segment byte-exactly into record and damage spans:
    yields ``("rec", seq, payload_off, payload_len, rec_start, rec_end)``
    for every valid record (v2, or legacy v1 where v2 fails) and
    ``("gap", start, end)`` for invalid spans (``end == len(data)``:
    damage reaches EOF).  Shared by replay, heal and truncate so all
    three agree on what a segment contains."""
    off = 0
    n = len(data)
    while off < n:
        spans, end = _scan(data, off, native_mod)
        for seq, poff, ln in spans:
            yield ("rec", seq, poff, ln, poff - _REC_HDR, poff + ln)
        if end >= n:
            return
        v1 = _parse_v1(data, end)
        if v1 is not None:
            # consume the whole legacy run inline: re-entering the v2
            # scanner (which slices data[off:] for the native library)
            # per record would make a long v1 segment O(n^2) in copies
            off = end
            while v1 is not None:
                seq, poff, ln = v1
                yield ("rec", seq, poff, ln, off, poff + ln)
                off = poff + ln
                v1 = _parse_v1(data, off)
            continue
        nxt = _next_boundary(data, end + 1, native_mod)
        yield ("gap", end, nxt if nxt is not None else n)
        if nxt is None:
            return
        off = nxt


def _next_boundary(data: bytes, start: int,
                   native_mod=None) -> int | None:
    """Byte-scan forward for the next offset holding a fully valid record
    (header CRC + bounds + payload CRC) — the interior-corruption resync
    point.  None = no valid record follows (damage reaches EOF)."""
    if native_mod is not None:
        l = native_mod.lib()
        if l is not None and not getattr(l, "_gt_no_wal", False):
            return native_mod.wal_find_boundary(data, start)
    n = len(data)
    for off in range(max(0, start), n - _REC_HDR + 1):
        ln, crc, _seq = _HDR.unpack_from(data, off)
        (hcrc,) = _HCRC.unpack_from(data, off + _HDR.size)
        if zlib.crc32(data[off:off + _HDR.size]) != hcrc:
            continue
        end = off + _REC_HDR + ln
        if end > n:
            continue
        if zlib.crc32(data[off + _REC_HDR:end]) != crc:
            continue
        return off
    return None


@dataclass
class WalDamage:
    """One triaged corruption event from a replay pass."""

    path: str          # segment file
    kind: str          # "torn_tail" | "interior"
    start: int         # damaged byte span [start, end) within the segment
    end: int
    prev_seq: int | None  # last valid sequence before the damage
    next_seq: int | None  # first valid sequence after (None: none found)

    def lost_range(self) -> tuple[int, int | None] | None:
        """Inclusive sequence range the damage may have destroyed, or
        None when nothing can be missing (pure garbage between two
        consecutive sequences).  ``(lo, None)`` = open-ended."""
        lo = (self.prev_seq + 1) if self.prev_seq is not None else 1
        if self.next_seq is None:
            return None if self.kind == "torn_tail" else (lo, None)
        hi = self.next_seq - 1
        return None if hi < lo else (lo, hi)

M_WAL_BATCH = telemetry.REGISTRY.histogram(
    "greptime_ingest_wal_batch_size",
    "records per WAL group-commit flush",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
M_WAL_FSYNCS = telemetry.REGISTRY.counter(
    "greptime_ingest_wal_fsyncs_total", "WAL fsync calls")


def group_commit_enabled() -> bool:
    return os.environ.get("GREPTIME_WAL_GROUP_COMMIT", "on").lower() not in (
        "off", "0", "false")


def _linger_s() -> float:
    try:
        return float(os.environ.get("GREPTIME_WAL_LINGER_MS", "0")) / 1000.0
    except ValueError:
        return 0.0


class _GroupCommitter:
    """Leader/follower flush protocol for one log's appenders.

    ``enqueue`` assigns a monotonically increasing ticket under the lock
    (so record order in the file equals enqueue order); ``wait`` blocks
    until a flush covering the ticket has completed, electing the caller
    leader when no flush is in flight.  The leader swaps the buffer out,
    writes it OUTSIDE the lock (followers keep enqueueing into the fresh
    buffer meanwhile), then publishes progress and wakes everyone."""

    def __init__(self, store: "FileLogStore"):
        self._store = store
        self._cond = threading.Condition()
        self._buf: list[bytes] = []
        self._enqueued = 0
        self._flushed = 0
        self._flushing = False
        self._last_batch = 1
        self._error: BaseException | None = None
        self._error_upto = 0

    def enqueue(self, rec: bytes) -> int:
        with self._cond:
            self._buf.append(rec)
            self._enqueued += 1
            ticket = self._enqueued
            self._cond.notify_all()  # wake a lingering leader
            return ticket

    def wait(self, ticket: int) -> None:
        with self._cond:
            while self._flushed < ticket:
                if self._flushing:
                    self._cond.wait()
                    continue
                self._lead()
            if self._error is not None and ticket <= self._error_upto:
                raise self._error

    def _lead(self) -> None:
        """Called under the lock with no flush in flight: flush the
        current buffer as its leader."""
        self._flushing = True
        linger = _linger_s()
        if linger > 0 and self._last_batch > 1:
            # saturation signal: the previous flush was contended — hold
            # the batch open briefly so concurrent appenders join it
            deadline = time.monotonic() + linger
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or len(self._buf) >= 128:
                    break
                self._cond.wait(timeout=remaining)
        take = self._buf
        self._buf = []
        upto = self._enqueued
        self._cond.release()
        err: BaseException | None = None
        try:
            self._store._flush_records(b"".join(take), len(take))
        except BaseException as e:  # noqa: BLE001 — delivered to waiters
            err = e
        finally:
            self._cond.acquire()
            self._flushed = upto
            self._last_batch = max(1, len(take))
            self._flushing = False
            if err is not None:
                self._error = err
                self._error_upto = upto
            self._cond.notify_all()


class LogStore:
    """Interface (reference store-api logstore.rs:51)."""

    # False = appends are dropped (Noop): writers may skip payload
    # serialization entirely — the encode cost is pure waste
    durable = True

    def append(self, sequence: int, payload: bytes) -> None:
        raise NotImplementedError

    def replay(self, from_sequence: int, repair: bool = True):
        raise NotImplementedError

    def truncate(self, up_to_sequence: int) -> None:
        raise NotImplementedError


class FileLogStore(LogStore):
    """One directory of numbered segment files per region."""

    def __init__(self, wal_dir: str, sync: bool = False,
                 group_commit: bool | None = None):
        self.dir = wal_dir
        self.sync = sync
        os.makedirs(wal_dir, exist_ok=True)
        segs = self._segments()
        self._current_id = segs[-1] if segs else 0
        self._fh = open(self._seg_path(self._current_id), "ab")
        if group_commit is None:
            group_commit = group_commit_enabled()
        self._gc = _GroupCommitter(self) if group_commit else None
        # corruption triage report of the most recent replay() pass
        self.last_triage: list[WalDamage] = []

    def _seg_path(self, seg_id: int) -> str:
        return os.path.join(self.dir, f"{seg_id:020d}.wal")

    def _segments(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            if fn.endswith(".wal"):
                out.append(int(fn[:-4]))
        return sorted(out)

    def _flush_records(self, data: bytes, count: int) -> None:
        """One buffered write + flush (+ fsync) for ``count`` records —
        the single IO round-trip a whole commit group shares.

        A failed/torn flush rolls the file back to the pre-flush offset:
        a survivable write error is surfaced to the appenders (nothing
        acked) and must not leave half-records that later appends would
        bury as interior corruption — only a real crash leaves a torn
        tail, and replay truncates that."""
        after = None
        if CHAOS.enabled:  # disk fault injection: torn/bitflip/error/kill
            data, after = CHAOS.filter_io("wal.flush", data)
        pos = self._fh.tell()
        try:
            self._fh.write(data)
            self._fh.flush()
            if after is not None:
                raise after  # torn write: prefix persisted, then fail
            if self.sync:
                os.fsync(self._fh.fileno())
                M_WAL_FSYNCS.inc()
        except BaseException:
            try:
                self._fh.truncate(pos)
            except OSError:
                pass  # rollback is best-effort; replay triage covers it
            raise
        M_WAL_BATCH.observe(count)
        if self._fh.tell() >= _SEGMENT_TARGET:
            self._roll()

    def append(self, sequence: int, payload: bytes) -> None:
        rec = _pack_record(sequence, payload)
        if self._gc is not None:
            self._gc.wait(self._gc.enqueue(rec))
            return
        # single durability path — group-commit off writes a batch of one
        # through the same helper, so metrics (fsyncs, batch sizes) and
        # any future durability change stay consistent across modes
        self._flush_records(rec, 1)

    def append_async(self, sequence: int, payload: bytes):
        """Enqueue a record for the next commit group and return a
        ``wait()`` callable that blocks until it is durable.  Lets callers
        that serialize sequence assignment under their own lock (the
        shared-log broker) enqueue inside it and wait OUTSIDE it — the
        group commit then merges appends from many topics/regions into
        one fsync."""
        rec = _pack_record(sequence, payload)
        if self._gc is None:
            # synchronous path: write now, nothing to wait for
            self._flush_records(rec, 1)
            return lambda: None
        ticket = self._gc.enqueue(rec)
        return lambda: self._gc.wait(ticket)

    def _roll(self) -> None:
        self._fh.close()
        self._current_id += 1
        self._fh = open(self._seg_path(self._current_id), "ab")

    def replay(self, from_sequence: int = 0, repair: bool = True):
        """Yield (sequence, payload) for entries with sequence >= from_sequence.

        Corruption triage instead of stop-at-first-error: a **torn tail**
        (damage reaching EOF of the final segment) is truncated under
        ``repair`` — crash debris, today's behavior, correct; **interior**
        damage (a valid record boundary exists beyond it) is counted,
        copied to a ``.quarantine`` sidecar (repair mode), and replay
        CONTINUES from the next boundary — acked records after bit rot
        are never silently discarded.  Every event lands in
        ``self.last_triage`` with the lost sequence range, so the region
        can resync the hole (remote WAL / follower replica) and then
        ``heal()`` the segment.  Followers replaying a WAL directory
        shared with a live leader MUST pass repair=False: a partially
        flushed leader append would otherwise be destroyed mid-write."""
        native = _native()
        self.last_triage = []
        pending: WalDamage | None = None
        # carried ACROSS segments: damage at the head of segment k+1 must
        # bound its lost range from segment k's last record, not from 1
        last_seq: int | None = None
        segs = self._segments()
        for idx, seg in enumerate(segs):
            path = self._seg_path(seg)
            with open(path, "rb") as f:
                data = f.read()
            for ev in _walk(data, native):
                if ev[0] == "rec":
                    _, seq, poff, ln, _rs, _re = ev
                    if pending is not None:
                        # first valid record after a hole
                        pending.next_seq = seq
                        pending = None
                    last_seq = seq
                    if seq >= from_sequence:
                        yield seq, data[poff:poff + ln]
                    continue
                _, start, dmg_end = ev
                if dmg_end >= len(data) and idx == len(segs) - 1:
                    # torn tail of the active segment: expected crash
                    # debris — truncate (write ownership only)
                    M_CORRUPTION.labels("wal", "torn_tail").inc()
                    self.last_triage.append(WalDamage(
                        path, "torn_tail", start, len(data), last_seq,
                        None))
                    if repair:
                        with open(path, "r+b") as f:
                            f.truncate(start)
                        if seg == self._current_id:
                            self._fh.close()
                            self._fh = open(path, "ab")
                    break
                # interior damage: valid records follow (in this segment
                # or a later one) — the next "rec" event patches next_seq
                dmg = WalDamage(path, "interior", start, dmg_end,
                                last_seq, None)
                M_CORRUPTION.labels("wal", "interior").inc()
                self.last_triage.append(dmg)
                pending = dmg
                if repair:
                    self._write_sidecar(path, start, data[start:dmg_end])

    def verify(self) -> list[WalDamage]:
        """Read-only integrity sweep over every segment (the scrubber's
        entry point): classify damage byte-exactly like
        replay() — including cross-segment lost-range bounding — and
        preserve the damaged bytes in ``.quarantine`` sidecars, but
        mutate NOTHING else.  Unlike replay, tail damage is *reported*
        (kind "torn_tail"), never truncated: on a LIVE region the tail
        is acked data hit by bit rot, not crash debris, and the caller
        (Region.scrub_wal) decides between resync and flush-cover."""
        native = _native()
        damages: list[WalDamage] = []
        pending: WalDamage | None = None
        last_seq: int | None = None
        segs = self._segments()
        for idx, seg in enumerate(segs):
            path = self._seg_path(seg)
            with open(path, "rb") as f:
                data = f.read()
            for ev in _walk(data, native):
                if ev[0] == "rec":
                    _, seq, _poff, _ln, _rs, _re = ev
                    if pending is not None:
                        pending.next_seq = seq
                        pending = None
                    last_seq = seq
                    continue
                _, start, dmg_end = ev
                tail = dmg_end >= len(data) and idx == len(segs) - 1
                dmg = WalDamage(path, "torn_tail" if tail else "interior",
                                start, dmg_end, last_seq, None)
                M_CORRUPTION.labels(
                    "wal", "scrub_tail" if tail else "scrub_interior").inc()
                damages.append(dmg)
                pending = dmg
                self._write_sidecar(path, start, data[start:dmg_end])
        return damages

    def drop_damage(self, damages: "list[WalDamage]") -> int:
        """Remove verified damage from the segments AFTER its bytes are
        sidecar-preserved and its lost range recovered (resynced or
        flush-covered): interior spans compact out via heal(); tail
        damage truncates the segment to its valid prefix (re-opening the
        active handle).  Returns bytes dropped."""
        interior_paths = {d.path for d in damages if d.kind == "interior"}
        dropped = self.heal(damages)
        for d in damages:
            if d.kind != "torn_tail" or d.path in interior_paths:
                # heal's compaction keeps only valid records, so it
                # already dropped this file's tail span too
                continue
            try:
                size = os.path.getsize(d.path)
            except OSError:
                continue
            if size <= d.start:
                continue  # already compacted/truncated
            dropped += size - d.start
            with open(d.path, "r+b") as f:
                f.truncate(d.start)
            if d.path == self._seg_path(self._current_id):
                self._fh.close()
                self._fh = open(d.path, "ab")
        return dropped

    def _write_sidecar(self, path: str, start: int, blob: bytes) -> None:
        """Preserve damaged bytes beside the segment (never deleted);
        idempotent per (segment, offset) so repeated failed opens don't
        stack duplicates."""
        side = f"{path}.{start}.quarantine"
        if os.path.exists(side):
            return
        tmp = side + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, side)
        # rename durability: the sidecar is the only surviving copy of
        # the damaged bytes once heal() compacts the segment — a power
        # loss must not be able to forget its directory entry
        _fsync_dir(os.path.dirname(side))
        M_QUARANTINED.labels("wal").inc()

    def heal(self, damages: "list[WalDamage] | None" = None) -> int:
        """Compact interior-damaged segments down to their valid records
        (call AFTER the lost range was resynced and re-appended durably —
        healing first would turn a repairable hole into silent loss).
        Damaged bytes already live in the ``.quarantine`` sidecars.
        Returns the number of bytes dropped."""
        damages = self.last_triage if damages is None else damages
        native = _native()
        dropped = 0
        for path in sorted({d.path for d in damages
                            if d.kind == "interior"}):
            with open(path, "rb") as f:
                data = f.read()
            keep = bytearray()
            for ev in _walk(data, native):
                if ev[0] == "rec":
                    keep += data[ev[4]:ev[5]]
            if len(keep) == len(data):
                continue
            dropped += len(data) - len(keep)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(bytes(keep))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            # rename durability: a healed segment that reverts to its
            # damaged pre-compaction bytes at power loss would re-open
            # with interior corruption the triage believes is repaired
            _fsync_dir(os.path.dirname(path))
            if path == self._seg_path(self._current_id):
                self._fh.close()
                self._fh = open(path, "ab")
        return dropped

    def truncate(self, up_to_sequence: int) -> None:
        """Drop whole segments whose every entry is below up_to_sequence.
        Unverifiable bytes (damage) conservatively KEEP the segment — a
        quarantine/resync may still need them.

        Walks headers only (v2 header CRC validates len/seq without
        touching the payload): truncation runs on every flush, and
        payload checksums belong to replay/heal, not this hot path."""
        for seg in self._segments()[:-1]:  # never drop the active segment
            path = self._seg_path(seg)
            keep = False
            with open(path, "rb") as f:
                data = f.read()
            off, n = 0, len(data)
            while off < n:
                if off + _REC_HDR <= n:
                    ln, _crc, seq = _HDR.unpack_from(data, off)
                    (hcrc,) = _HCRC.unpack_from(data, off + _HDR.size)
                    if (zlib.crc32(data[off:off + _HDR.size]) == hcrc
                            and off + _REC_HDR + ln <= n):
                        if seq >= up_to_sequence:
                            keep = True
                            break
                        off += _REC_HDR + ln
                        continue
                v1 = _parse_v1(data, off)  # legacy record (payload CRC)
                if v1 is not None:
                    seq, poff, ln = v1
                    if seq >= up_to_sequence:
                        keep = True
                        break
                    off = poff + ln
                    continue
                keep = True  # damage: never drop unverified bytes
                break
            if not keep:
                os.unlink(path)

    def close(self) -> None:
        self._fh.close()


class NoopLogStore(LogStore):
    """WAL-less mode for benchmarks (reference src/log-store/src/noop/)."""

    durable = False

    def append(self, sequence: int, payload: bytes) -> None:
        pass

    def replay(self, from_sequence: int = 0, repair: bool = True):
        return iter(())

    def truncate(self, up_to_sequence: int) -> None:
        pass

    def close(self) -> None:
        pass


# ---- payload codec: Arrow IPC over the write columns -----------------------

_OP_META = b"greptime.op"


def encode_write(columns: dict, op: int = 0) -> bytes:
    """Serialize one write batch.  Only the schema columns belong in the
    payload: per-row ``__tsid__``/``__seq__``/``__op__`` are derivable at
    replay (tsids recompute deterministically, the sequence rides the
    record header, and a batch has ONE op) — logging them would grow
    every record ~15% for bytes replay throws away.  ``op`` lands in the
    stream's schema metadata instead."""
    import pyarrow as pa
    import pyarrow.ipc  # noqa: F401

    table = pa.table(columns)
    if op:
        table = table.replace_schema_metadata({_OP_META: str(op)})
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue()


def decode_write(payload: bytes) -> dict:
    return decode_write_full(payload)[0]


def decode_write_full(payload: bytes) -> tuple[dict, int]:
    """(columns, op) — accepts both the slim format and older payloads
    that carried __seq__/__op__ columns (replay prefers the columns when
    present, so logs written before the slimming replay identically)."""
    import pyarrow as pa
    import pyarrow.ipc  # noqa: F401

    with pa.ipc.open_stream(io.BytesIO(payload)) as r:
        table = r.read_all()
    meta = table.schema.metadata or {}
    op = int(meta.get(_OP_META, b"0"))
    cols = {name: table.column(name).combine_chunks()
            for name in table.column_names}
    return cols, op
