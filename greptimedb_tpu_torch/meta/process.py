"""Process manager: live query tracking + cooperative KILL.

Equivalent of the reference's ProcessManager
(src/catalog/src/process_manager.rs): every statement entering the
frontend registers a ticket (id, catalog, query, client, start time);
``information_schema.process_list`` / ``SHOW PROCESSLIST`` read the live
registry, and ``KILL <id>`` flips the ticket's cancellation flag, which
the engine checks at stage boundaries (statement starts, region scans).
Cancellation is cooperative — a query inside one device dispatch
finishes that dispatch first, exactly like one DataFusion operator batch.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field

from greptimedb_tpu_torch.errors import Cancelled


@dataclass
class ProcessTicket:
    id: int
    query: str
    database: str
    client: str
    start_ts: float = field(default_factory=time.time)
    cancelled: threading.Event = field(default_factory=threading.Event)

    def check(self) -> None:
        """Raise if this process was killed (called at stage boundaries)."""
        if self.cancelled.is_set():
            raise Cancelled(f"query {self.id} was killed")

    @property
    def elapsed_ms(self) -> float:
        return (time.time() - self.start_ts) * 1000


class ProcessManager:
    """Thread-safe registry of in-flight statements.

    Registration happens BEFORE the executor's serialization lock is
    taken, so queued statements are visible to (and killable from) other
    connections while they wait.
    """

    def __init__(self, server_addr: str = "standalone"):
        self.server_addr = server_addr
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._procs: dict[int, ProcessTicket] = {}

    def register(self, query: str, database: str, client: str = "") -> ProcessTicket:
        t = ProcessTicket(next(self._ids), query[:4096], database, client)
        with self._lock:
            self._procs[t.id] = t
        return t

    def deregister(self, ticket: ProcessTicket) -> None:
        with self._lock:
            self._procs.pop(ticket.id, None)

    def kill(self, process_id: int) -> bool:
        """Flip the cancel flag; returns False for unknown/finished ids."""
        with self._lock:
            t = self._procs.get(process_id)
        if t is None:
            return False
        t.cancelled.set()
        return True

    def list(self) -> list[ProcessTicket]:
        with self._lock:
            return sorted(self._procs.values(), key=lambda t: t.id)

    @staticmethod
    def parse_id(raw) -> int:
        """Accept 7, '7', and the reference's 'addr/7' display form."""
        s = str(raw)
        if "/" in s:
            s = s.rsplit("/", 1)[1]
        return int(s)
