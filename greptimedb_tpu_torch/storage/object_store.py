"""Object store abstraction (reference: src/object-store over OpenDAL).

Only the operations the engine needs: atomic write, read, list, delete,
rename.  ``FsObjectStore`` is the local-disk backend; the interface is
narrow enough that an S3/GCS backend is a drop-in (multipart +
rename-free atomic write via temp object + copy).

Durability discipline: every FsObjectStore write is temp file
→ write → fsync → rename → parent-directory fsync, so a power loss
after ``write`` returns can lose neither the bytes nor the rename.  The
local-disk chaos points (``fs.write`` torn/bitflip, ``fs.fsync``) hook
this path with the zero-overhead-disabled ``CHAOS.enabled`` guard.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading

from greptimedb_tpu_torch.errors import FencedError
from greptimedb_tpu_torch.utils.chaos import CHAOS


def content_etag(data: bytes) -> str:
    """ETag of an object's content — md5 hex, matching what S3 returns
    for single-part PUTs, so the same token compares across backends."""
    return hashlib.md5(data).hexdigest()


class ObjectStore:
    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    # ---- conditional put (epoch fencing) ------------------------------
    # ``write_if`` is the fenced write surface: exactly one of
    # ``if_none_match`` (create-only: fail if the object exists — how two
    # split-brain leaders racing on one delta version resolve to ONE
    # winner) or ``if_match=<etag>`` (replace-only-if-unchanged: how an
    # epoch marker advances without clobbering a newer claim).  A lost
    # CAS raises FencedError; the caller must treat it as a fencing
    # event, never retry into a plain write.
    def write_if(self, path: str, data: bytes, *,
                 if_match: str | None = None,
                 if_none_match: bool = False) -> None:
        raise NotImplementedError

    def head(self, path: str) -> dict | None:
        """Object metadata without the body: ``{"etag", "length"}`` or
        None when the object does not exist.  The scrubber's cache
        revalidation and the CAS surface both key off the etag."""
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    # ---- conditional delete (checkpoint GC fencing) ------------------
    # ``delete_if`` is the fenced HALF of garbage collection: delete the
    # object only while its content is still the version the caller
    # decided to GC (``if_match=<etag>``).  A fenced-out zombie leader
    # replaying a stale GC plan loses the CAS (FencedError) instead of
    # destroying a newer leader's checkpoint; the caller must treat the
    # loss as a fencing event, never retry into a plain delete.
    def delete_if(self, path: str, *, if_match: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Move an object (quarantine uses this: bytes must be PRESERVED
        under the new name, never deleted).  Default is copy+delete —
        fine for remote backends; disk backends override with a real
        rename."""
        self.write(dst, self.read(src))
        self.delete(src)

    def local_path(self, path: str) -> str | None:
        """Filesystem path if this store is disk-backed (lets pyarrow mmap),
        else None and callers fall back to read()."""
        return None

    def last_modified(self, path: str) -> float | None:
        """Store-level modification time (epoch seconds), or None when the
        backend cannot tell.  GC grace periods rely on this — never on
        cache-file mtimes."""
        return None

    def prefetch(self, paths: list[str]) -> int:
        """Scan-driven readahead hint: start pulling these objects toward
        local storage in the background so the decode pool finds them
        warm (storage/scan.py prefetch_store).  Returns the number of
        fetches actually queued; disk/memory backends have nothing to
        warm and return 0."""
        return 0


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it survives power loss (the
    half of atomic-replace durability os.replace alone does not give)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platforms without directory fds: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# CAS serialization for disk-backed stores: one lock per REAL root path,
# shared by every FsObjectStore instance over that root in this process
# (two engines sharing a data home — the split-brain test shape — must
# contend on one lock, not two instance locks).
_FS_CAS_LOCKS: dict[str, threading.Lock] = {}
_FS_CAS_LOCKS_GUARD = threading.Lock()


def _cas_lock_for(root: str) -> threading.Lock:
    key = os.path.realpath(root)
    with _FS_CAS_LOCKS_GUARD:
        lock = _FS_CAS_LOCKS.get(key)
        if lock is None:
            lock = _FS_CAS_LOCKS[key] = threading.Lock()
        return lock


class FsObjectStore(ObjectStore):
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._cas_lock = _cas_lock_for(self.root)

    def _abs(self, path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, path.lstrip("/")))
        # commonpath, not startswith: '../rootB' must not pass for root
        # '/x/root' just because the string prefix matches
        if os.path.commonpath([p, self.root]) != self.root:
            raise ValueError(f"path escapes store root: {path}")
        return p

    def write(self, path: str, data: bytes) -> None:
        p = self._abs(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        after = None
        if CHAOS.enabled:  # disk fault injection (zero-overhead disabled)
            data, after = CHAOS.filter_io("fs.write", data)
        # atomic: temp file + fsync + rename + parent dir fsync
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                if after is not None:
                    raise after  # torn write: prefix persisted, then die
                if CHAOS.enabled:
                    CHAOS.inject("fs.fsync")
                os.fsync(f.fileno())
            os.replace(tmp, p)
            # the rename itself must be durable: fsync the parent dir,
            # or a power loss can roll the directory entry back to the
            # old (or no) file even though write() returned success
            if CHAOS.enabled:
                CHAOS.inject("fs.fsync")
            _fsync_dir(os.path.dirname(p))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def write_if(self, path: str, data: bytes, *,
                 if_match: str | None = None,
                 if_none_match: bool = False) -> None:
        if if_none_match == (if_match is not None):
            raise ValueError("write_if needs exactly one of "
                             "if_match / if_none_match")
        p = self._abs(path)
        with self._cas_lock:
            exists = os.path.exists(p)
            if if_none_match:
                if exists:
                    raise FencedError(
                        f"conditional put lost: {path} already exists")
            else:
                if not exists:
                    raise FencedError(
                        f"conditional put lost: {path} is gone "
                        f"(expected etag {if_match})")
                with open(p, "rb") as f:
                    cur = content_etag(f.read())
                if cur != if_match:
                    raise FencedError(
                        f"conditional put lost: {path} etag {cur} != "
                        f"expected {if_match}")
            self.write(path, data)

    def head(self, path: str) -> dict | None:
        p = self._abs(path)
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError:
            return None
        return {"etag": content_etag(data), "length": len(data)}

    def read(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def list(self, prefix: str) -> list[str]:
        base = self._abs(prefix)
        if not os.path.isdir(base):
            return []
        out = []
        for dirpath, _dirs, files in os.walk(base):
            for fn in files:
                full = os.path.join(dirpath, fn)
                out.append(os.path.relpath(full, self.root))
        return sorted(out)

    def delete(self, path: str) -> None:
        p = self._abs(path)
        if os.path.exists(p):
            os.unlink(p)

    def delete_if(self, path: str, *, if_match: str) -> None:
        p = self._abs(path)
        with self._cas_lock:  # CAS check + unlink are atomic per root
            try:
                with open(p, "rb") as f:
                    cur = content_etag(f.read())
            except OSError:
                raise FencedError(
                    f"conditional delete lost: {path} is gone "
                    f"(expected etag {if_match})") from None
            if cur != if_match:
                raise FencedError(
                    f"conditional delete lost: {path} etag {cur} != "
                    f"expected {if_match}")
            os.unlink(p)

    def rename(self, src: str, dst: str) -> None:
        s, d = self._abs(src), self._abs(dst)
        os.makedirs(os.path.dirname(d), exist_ok=True)
        os.replace(s, d)
        _fsync_dir(os.path.dirname(d))
        if os.path.dirname(s) != os.path.dirname(d):
            _fsync_dir(os.path.dirname(s))

    def last_modified(self, path: str) -> float | None:
        try:
            return os.path.getmtime(self._abs(path))
        except OSError:
            return None

    def local_path(self, path: str) -> str | None:
        return self._abs(path)


class MemoryObjectStore(ObjectStore):
    """In-memory backend for tests (reference uses OpenDAL's memory service
    the same way, src/object-store/Cargo.toml:12)."""

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._cas_lock = threading.Lock()

    def write(self, path: str, data: bytes) -> None:
        self._data[path.lstrip("/")] = bytes(data)

    def write_if(self, path: str, data: bytes, *,
                 if_match: str | None = None,
                 if_none_match: bool = False) -> None:
        if if_none_match == (if_match is not None):
            raise ValueError("write_if needs exactly one of "
                             "if_match / if_none_match")
        key = path.lstrip("/")
        with self._cas_lock:
            cur = self._data.get(key)
            if if_none_match:
                if cur is not None:
                    raise FencedError(
                        f"conditional put lost: {path} already exists")
            else:
                if cur is None:
                    raise FencedError(
                        f"conditional put lost: {path} is gone "
                        f"(expected etag {if_match})")
                got = content_etag(cur)
                if got != if_match:
                    raise FencedError(
                        f"conditional put lost: {path} etag {got} != "
                        f"expected {if_match}")
            self._data[key] = bytes(data)

    def head(self, path: str) -> dict | None:
        data = self._data.get(path.lstrip("/"))
        if data is None:
            return None
        return {"etag": content_etag(data), "length": len(data)}

    def read(self, path: str) -> bytes:
        return self._data[path.lstrip("/")]

    def exists(self, path: str) -> bool:
        return path.lstrip("/") in self._data

    def list(self, prefix: str) -> list[str]:
        # directory semantics, matching FsObjectStore: prefix "r1" must
        # not match "r10/..." — a bare prefix only matches itself or
        # paths under "r1/" (manifest/GC listings must not bleed across
        # regions whose ids share a decimal prefix)
        p = prefix.lstrip("/")
        if not p or p.endswith("/"):
            return sorted(k for k in self._data if k.startswith(p))
        return sorted(k for k in self._data
                      if k == p or k.startswith(p + "/"))

    def delete(self, path: str) -> None:
        self._data.pop(path.lstrip("/"), None)

    def delete_if(self, path: str, *, if_match: str) -> None:
        key = path.lstrip("/")
        with self._cas_lock:
            cur = self._data.get(key)
            if cur is None:
                raise FencedError(
                    f"conditional delete lost: {path} is gone "
                    f"(expected etag {if_match})")
            if content_etag(cur) != if_match:
                raise FencedError(
                    f"conditional delete lost: {path} etag "
                    f"{content_etag(cur)} != expected {if_match}")
            del self._data[key]

    def rename(self, src: str, dst: str) -> None:
        self._data[dst.lstrip("/")] = self._data.pop(src.lstrip("/"))
