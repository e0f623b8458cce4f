"""The one piece of the reference's AOT artifact store the port needs:
``atomic_write`` (the flow checkpoint store writes through it).  The rest
of ``compile/store.py`` (the on-disk executable store) waits for the port's
own compiled-kernel artifact.
"""

from __future__ import annotations

import os
import threading

from greptimedb_tpu_torch.storage.object_store import _fsync_dir


def atomic_write(path: str, data: bytes) -> None:
    """Unique-tmp + fsync + replace + parent fsync: concurrent writers of
    the same path are each atomic; readers only ever see whole files."""
    d = os.path.dirname(path)
    tmp = os.path.join(
        d, f".tmp.{os.getpid()}.{threading.get_ident()}."
           f"{os.path.basename(path)}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)
