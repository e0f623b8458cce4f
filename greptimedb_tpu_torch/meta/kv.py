"""KvBackend: the metadata substrate (reference src/common/meta/src/kv_backend.rs:53).

Range scans over sorted keys, atomic compare-and-put for the txn uses the
reference makes (metadata transactions RFC), and four implementations:

- MemoryKv — tests / ephemeral standalone.
- FileKv — write-through JSON file (standalone embedded metadata; the
  reference embeds raft-engine kv the same way,
  src/standalone/src/metadata.rs).
- SqliteKv — SQL-database-backed, the analog of the reference's RDS
  backends (src/common/meta/src/kv_backend/rds/{mysql,postgres}.rs):
  one `kv(k PRIMARY KEY, v)` table, CAS as a single UPDATE..WHERE
  transaction, range scans as indexed BETWEEN queries.
- RemoteKv (rpc/kvservice.py) — network client for a shared KvServer,
  the etcd analog (src/common/meta/src/kv_backend/etcd.rs): multiple
  metasrv/frontend processes share one metadata key-space.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading


class KvBackend:
    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def bulk_replace(self, entries: dict[str, bytes]) -> None:
        """Replace the ENTIRE key-space with ``entries`` (snapshot
        restore).  Default: delete-all + put-all; backends override with
        one-shot persistence."""
        for k, _v in list(self.range("")):
            self.delete(k)
        for k, v in entries.items():
            self.put(k, v)

    def range(self, prefix: str) -> list[tuple[str, bytes]]:
        raise NotImplementedError

    def compare_and_put(
        self, key: str, expect: bytes | None, value: bytes
    ) -> bool:
        raise NotImplementedError

    def compare_and_delete(self, key: str, expect: bytes) -> bool:
        raise NotImplementedError

    # convenience json codecs
    def get_json(self, key: str):
        raw = self.get(key)
        return None if raw is None else json.loads(raw)

    def put_json(self, key: str, value) -> None:
        self.put(key, json.dumps(value).encode())


class MemoryKv(KvBackend):
    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> bytes | None:
        return self._data.get(key)

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(value)

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._data.pop(key, None) is not None

    def range(self, prefix: str) -> list[tuple[str, bytes]]:
        return sorted(
            (k, v) for k, v in self._data.items() if k.startswith(prefix)
        )

    def compare_and_put(self, key: str, expect: bytes | None, value: bytes) -> bool:
        with self._lock:
            cur = self._data.get(key)
            if cur != expect:
                return False
            self._data[key] = bytes(value)
            return True

    def compare_and_delete(self, key: str, expect: bytes) -> bool:
        with self._lock:
            if self._data.get(key) != expect:
                return False
            del self._data[key]
            return True


class SqliteKv(KvBackend):
    """SQL-database metadata backend (reference RDS kv_backend,
    src/common/meta/src/kv_backend/rds/): every operation is one SQL
    transaction against a `kv` table, so atomicity comes from the
    database, not process-local locks — the shape that ports directly
    to MySQL/PostgreSQL."""

    def __init__(self, path: str):
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False,
                                   isolation_level=None)  # autocommit
        self._lock = threading.Lock()  # sqlite conns aren't thread-safe
        with self._lock:
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v BLOB)")

    def close(self) -> None:
        with self._lock:
            self._db.close()

    def get(self, key: str) -> bytes | None:
        with self._lock:
            row = self._db.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return None if row is None else bytes(row[0])

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?)"
                " ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, bytes(value)))

    def delete(self, key: str) -> bool:
        with self._lock:
            cur = self._db.execute("DELETE FROM kv WHERE k = ?", (key,))
        return cur.rowcount > 0

    @staticmethod
    def _prefix_end(prefix: str) -> str | None:
        """Smallest string greater than every string with ``prefix``:
        increment the last non-maximal char, dropping trailing U+10FFFF
        (etcd's get_prefix_range_end, in unicode code points)."""
        for i in range(len(prefix) - 1, -1, -1):
            if ord(prefix[i]) < 0x10FFFF:
                nxt = ord(prefix[i]) + 1
                if 0xD800 <= nxt <= 0xDFFF:  # unencodable surrogates
                    nxt = 0xE000
                return prefix[:i] + chr(nxt)
        return None  # all-maximal prefix: no upper bound

    def range(self, prefix: str) -> list[tuple[str, bytes]]:
        end = self._prefix_end(prefix) if prefix else None
        with self._lock:
            if prefix and end is not None:
                # indexed [prefix, end) range: no LIKE escape pitfalls
                # with % / _ in keys
                rows = self._db.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                    (prefix, end)).fetchall()
            elif prefix:
                rows = self._db.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k",
                    (prefix,)).fetchall()
            else:
                rows = self._db.execute(
                    "SELECT k, v FROM kv ORDER BY k").fetchall()
        return [(k, bytes(v)) for k, v in rows
                if k.startswith(prefix)]

    def bulk_replace(self, entries: dict[str, bytes]) -> None:
        with self._lock:
            self._db.execute("BEGIN IMMEDIATE")
            try:
                self._db.execute("DELETE FROM kv")
                self._db.executemany(
                    "INSERT INTO kv (k, v) VALUES (?, ?)",
                    [(k, bytes(v)) for k, v in entries.items()])
                self._db.execute("COMMIT")
            except BaseException:
                self._db.execute("ROLLBACK")
                raise

    def compare_and_put(
        self, key: str, expect: bytes | None, value: bytes
    ) -> bool:
        with self._lock:
            self._db.execute("BEGIN IMMEDIATE")
            try:
                row = self._db.execute(
                    "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
                cur = None if row is None else bytes(row[0])
                if cur != expect:
                    self._db.execute("ROLLBACK")
                    return False
                self._db.execute(
                    "INSERT INTO kv (k, v) VALUES (?, ?)"
                    " ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                    (key, bytes(value)))
                self._db.execute("COMMIT")
                return True
            except BaseException:
                self._db.execute("ROLLBACK")
                raise

    def compare_and_delete(self, key: str, expect: bytes) -> bool:
        with self._lock:
            self._db.execute("BEGIN IMMEDIATE")
            try:
                row = self._db.execute(
                    "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
                if row is None or bytes(row[0]) != expect:
                    self._db.execute("ROLLBACK")
                    return False
                self._db.execute("DELETE FROM kv WHERE k = ?", (key,))
                self._db.execute("COMMIT")
                return True
            except BaseException:
                self._db.execute("ROLLBACK")
                raise


class FileKv(MemoryKv):
    """Write-through JSON file persistence (standalone embedded metadata).

    Values round-trip as UTF-8 with surrogateescape, so arbitrary bytes
    survive persistence (and files written by older versions still load).
    """

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._plock = threading.Lock()  # serializes tmp-file writes
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)
            self._data = {
                k: v.encode("utf-8", "surrogateescape")
                for k, v in raw.items()
            }

    def _persist(self) -> None:
        # snapshot INSIDE the persist lock so a later writer can't be
        # overwritten by an earlier writer holding a stale snapshot;
        # the data lock guards against mutation during serialization
        with self._plock:
            with self._lock:
                snap = dict(self._data)
            tmp = self.path + ".tmp"
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(
                    {k: v.decode("utf-8", "surrogateescape")
                     for k, v in snap.items()}, f)
            os.replace(tmp, self.path)

    def put(self, key: str, value: bytes) -> None:
        super().put(key, value)
        self._persist()

    def bulk_replace(self, entries: dict[str, bytes]) -> None:
        self._data = dict(entries)
        self._persist()

    def delete(self, key: str) -> bool:
        ok = super().delete(key)
        if ok:
            self._persist()
        return ok

    def compare_and_put(self, key: str, expect: bytes | None, value: bytes) -> bool:
        ok = super().compare_and_put(key, expect, value)
        if ok:
            self._persist()
        return ok

    def compare_and_delete(self, key: str, expect: bytes) -> bool:
        ok = super().compare_and_delete(key, expect)
        if ok:
            self._persist()
        return ok
